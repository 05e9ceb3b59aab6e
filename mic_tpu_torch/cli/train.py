"""Training CLI of the port: the flags of ``python -m mic_tpu.cli.train``
(``build_configs`` is the port's own copy of mic_tpu/cli/train.py's, plus
``--device``), run by mic_tpu_torch's Trainer: on one device, the CUDA card
unless ``--device cpu`` asks for the CPU (with no card and no ``--device``
it raises; it never falls back to the CPU by itself), or data-parallel in
one process a card where the environment opts in, as mic_tpu's does
(parallel/distributed.py::initialize_from_env, called first):

    torchrun --nproc_per_node 8 -m mic_tpu_torch.cli.train ...   # with MIC_TPU_DISTRIBUTED=1
    MIC_TPU_COORDINATOR=host0:1234 MIC_TPU_NUM_PROCESSES=8 MIC_TPU_PROCESS_ID=<rank> \
        python -m mic_tpu_torch.cli.train ... --dp -1 [--fsdp true]

(NCCL, each rank on cuda:LOCAL_RANK; MIC_TPU_DIST_BACKEND=gloo with
``--device cpu`` for processes on the CPU).

Example (a synthetic TSV of image names, captions, urls and language codes):
    python -m mic_tpu_torch.cli.train \
        --train_file data/train.tsv --images_dir images/ --output_dir runs/smoke \
        --num_epochs 1 --per_device_batch_size 8 --warmup_steps 10 --save_steps 50 \
        --set model.dtype=bfloat16
It ends with train-state checkpoints under runs/smoke/checkpoints/<step>
(``--resume_from runs/smoke`` continues from the newest) and a model
directory, runs/smoke/model, for ``mic_tpu_torch.cli.caption`` and
``mic_tpu_torch.cli.evaluate``.
"""

from __future__ import annotations

import argparse
import dataclasses

from mic_tpu_torch.core.config import (
    CaptionerConfig,
    DataConfig,
    TrainConfig,
    apply_dotted_overrides,
)


def add_dataclass_args(parser: argparse.ArgumentParser, cls, skip=()) -> None:
    for f in dataclasses.fields(cls):
        if f.name in skip or not isinstance(
            f.default, (int, float, str, bool, type(None))
        ):
            continue
        kw = {}
        if isinstance(f.default, bool):
            kw = {"type": lambda s: s.lower() in ("1", "true", "yes")}
        elif f.default is None:
            kw = {"type": str}
        else:
            kw = {"type": type(f.default)}
        parser.add_argument(f"--{f.name}", default=f.default, **kw)


def collect(cls, args) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in vars(args).items() if k in names and v is not None}


def build_configs(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_dataclass_args(parser, DataConfig)
    add_dataclass_args(parser, TrainConfig)
    parser.add_argument("--tokenizer", type=str, default=None,
                        help="local HF tokenizer dir or SimpleTokenizer json")
    parser.add_argument("--model_config", type=str, default=None,
                        help="path to a CaptionerConfig json (default: flagship)")
    parser.add_argument("--set", action="append", default=[],
                        metavar="model.KEY=VALUE",
                        help="dotted model-config override, repeatable")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to train on (default: the CUDA card; "
                             "'cpu' to train on the CPU)")
    args = parser.parse_args(argv)

    if args.model_config:
        model_config = CaptionerConfig.from_json(args.model_config)
    else:
        model_config = CaptionerConfig.clip_vit_b32_mbart50()
    overrides = {}
    for item in args.set:
        key, _, value = item.partition("=")
        overrides[key.removeprefix("model.")] = value
    if overrides:
        model_config = apply_dotted_overrides(model_config, overrides)

    data_config = DataConfig(**collect(DataConfig, args))
    train_config = TrainConfig(**collect(TrainConfig, args))
    return model_config, data_config, train_config, args


def main(argv=None):
    model_config, data_config, train_config, args = build_configs(argv)
    # several processes: the group first, before the Trainer builds its mesh
    # (a no-op unless the environment opts in: parallel/distributed.py)
    from mic_tpu_torch.parallel.distributed import initialize_from_env

    initialize_from_env()
    from mic_tpu_torch.train.trainer import Trainer

    Trainer(model_config, data_config, train_config, tokenizer_path=args.tokenizer,
            device=args.device).train()


if __name__ == "__main__":
    main()

"""Training CLI of the port: the flags of ``python -m mic_tpu.cli.train``
(shared ``build_configs``), run by mic_tpu_torch's Trainer on one device
(CUDA when available).

Example (a synthetic TSV of image names, captions, urls and language codes):
    python -m mic_tpu_torch.cli.train \
        --train_file data/train.tsv --images_dir images/ --output_dir runs/smoke \
        --num_epochs 1 --per_device_batch_size 8 --warmup_steps 10 \
        --set model.dtype=bfloat16
"""

from __future__ import annotations

from mic_tpu.cli.train import build_configs


def main(argv=None):
    model_config, data_config, train_config, args = build_configs(argv)
    from mic_tpu_torch.train.trainer import Trainer

    Trainer(model_config, data_config, train_config, tokenizer_path=args.tokenizer).train()


if __name__ == "__main__":
    main()

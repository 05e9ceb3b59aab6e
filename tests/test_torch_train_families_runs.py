"""The second captioner family through the port's train CLI (train,
resume, export, serve) and in two data-parallel processes, on the CPU (the
helpers are test_torch_train_families.py's).  No JAX run here: the CLI
run is held to itself across a resume, the two processes to one process
(tests/test_torch_parallel.py holds the flagship's ranks to mic_tpu).
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from mic_tpu.core.config import DataConfig
from mic_tpu_torch.core.params import tree_leaves
from mic_tpu_torch.io.checkpoint import TrainCheckpointManager
from mic_tpu_torch.io.from_jax import from_jax
from mic_tpu_torch.models.captioner import Captioner
from mic_tpu_torch.ops.image_prep import maybe_preprocess
from test_torch_train_families import (
    LR, _batch, _config, _numpy_params, _train_config, _trainer,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from torch_rank_worker import loss_gaps, param_gaps, spawn  # noqa: E402


def _synthetic_tsv(tmp_path, n=32, size=40):
    from PIL import Image

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    langs = ["en_XX", "fr_XX", "es_XX", "de_DE"]
    words = ["cat", "dog", "red", "blue", "house", "tree", "runs", "sleeps"]
    rows = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
            img_dir / f"img_{i}.png")
        rows.append(f"img_{i}.png\t{' '.join(rng.choice(words, 4))}\thttp://x\t{langs[i % 4]}")
    (tmp_path / "train.tsv").write_text("\n".join(rows[:24]) + "\n")
    (tmp_path / "val.tsv").write_text("\n".join(rows[24:]) + "\n")
    return str(tmp_path / "train.tsv"), str(tmp_path / "val.tsv"), str(img_dir)


def _state_files_equal(a, b) -> bool:
    ta = torch.load(os.path.join(a, "state.pt"), weights_only=True)
    tb = torch.load(os.path.join(b, "state.pt"), weights_only=True)
    la, lb = list(tree_leaves(ta)), list(tree_leaves(tb))
    return len(la) == len(lb) and all(
        pa == pb and (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
        for (pa, x), (pb, y) in zip(la, lb))


@pytest.mark.parametrize("kind", ["vit_b16_bart_large", "family_untied"])
def test_cli_trains_resumes_and_exports_the_family(kind, tmp_path):
    """``mic_tpu_torch.cli.train``'s main on a synthetic TSV with the tiny
    family's JSON (bf16, every dropout on, the untied head set through
    ``--set``): finite train losses, eval loss and beam-4 BLEU per
    language, a run resumed from step 6 whose step-12 checkpoint and model
    are bit-equal to the uninterrupted run's (``lm_head``'s moments and the
    patch bias among them), and a model directory that from_pretrained
    serves (beam 4 through Captioner.generate)."""
    from mic_tpu_torch.cli.train import main

    train_tsv, val_tsv, img_dir = _synthetic_tsv(tmp_path)
    cfg_path = tmp_path / "model.json"
    _config("vit_b16_bart_large", dtype="bfloat16", dropout=0.1, vocab=64).to_json(str(cfg_path))
    sets = ["--set", "model.tie_word_embeddings=false"] if kind == "family_untied" else []
    common = ["--train_file", train_tsv, "--images_dir", img_dir, "--model_config",
              str(cfg_path), "--num_epochs", "2", "--per_device_batch_size", "4",
              "--learning_rate", "3e-3", "--warmup_steps", "2", "--logging_steps", "1",
              "--eval_steps", "1000", "--save_steps", "6", "--max_seq_length", "12",
              "--decode_size", "40", "--num_workers", "0", "--seed", "0", "--device", "cpu",
              *sets]
    out_a, out_b = tmp_path / "run_a", tmp_path / "run_b"
    main(common + ["--output_dir", str(out_a), "--validation_file", val_tsv])
    lines = [json.loads(line) for line in (out_a / "metrics.jsonl").read_text().splitlines()]
    losses = [line["train/loss"] for line in lines if "train/loss" in line]
    assert len(losses) == 12 and all(math.isfinite(x) for x in losses)
    for lang in ("en_XX", "fr_XX", "es_XX", "de_DE"):
        assert math.isfinite(lines[-1][f"eval/{lang}/loss"])
        assert f"eval/{lang}/bleu-4" in lines[-1]
    assert sorted(os.listdir(out_a / "checkpoints")) == ["12", "6"]

    main(common + ["--output_dir", str(out_b),
                   "--resume_from", str(out_a / "checkpoints" / "6")])
    assert _state_files_equal(out_a / "checkpoints" / "12", out_b / "checkpoints" / "12")
    manager, _ = TrainCheckpointManager.open(str(out_a))
    tree, _ = manager.restore(12)
    keys = {path for path, _ in tree_leaves(tree["opt_state"]["mu"])}
    assert ("vision", "patch_embed", "bias") in keys
    assert (("lm_head", "kernel") in keys) == (kind == "family_untied")

    model, params = Captioner.from_pretrained(str(out_a / "model"), device="cpu")
    assert model.config.tie_word_embeddings == (kind != "family_untied")
    assert model.config.decoder.post_norm and not model.config.vision.use_pre_ln
    _, params_b = Captioner.from_pretrained(str(out_b / "model"), device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_leaves(params),
                                                           tree_leaves(params_b)))
    pixels = maybe_preprocess(torch.from_numpy(_batch(model.config, b=2)["pixel_values"]),
                              model.config.vision.image_size, model.dtype)
    seqs = model.generate(params, pixels, max_length=10, num_beams=4,
                          decoder_start_token_id=1, forced_bos_token_id=5).sequences
    assert seqs.shape == (2, 10) and bool((seqs[:, 1] == 5).all())


# -- data parallel -------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dp", "fsdp"])
def test_two_processes_train_the_untied_model_as_one(layout, tmp_path):
    """dp=2, with and without fsdp, in two gloo processes
    (tools/torch_rank_worker.py), three steps of the untied family (the ViT
    tower, the post-norm decoder, ``lm_head``) in float32 with no dropout
    and in bf16 with the shadow and every dropout at 0.1, against the port's
    one process on the same global batches: losses within 1e-6 relative
    (float32) and 1e-4 (bf16), params all but one entry in a hundred of the
    tree within 1e-5 (float32) or 1e-4 (bf16), every entry within 2 *
    steps * lr (as tests/test_torch_parallel.py holds the flagship, there
    leaf by leaf).  Under fsdp the
    ``lm_head`` kernel is split over the ranks, gathered for the step and
    its gradient reduce-scattered."""
    fsdp = layout == "fsdp"
    cases, refs = [], {}
    for name, dtype, dropout in (("f32", "float32", 0.0), ("bf16_dropout", "bfloat16", 0.1)):
        config = _config("family_untied", dtype=dtype, dropout=dropout)
        nparams = _numpy_params(config, seed=11)
        batches = [_batch(config, b=8, seed=30 + i) for i in range(3)]
        for batch in batches:  # ragged: rank 0's rows hold fewer tokens
            batch["decoder_attention_mask"][:4, 5:] = 0
        out = tmp_path / name
        out.mkdir()
        torch.save(from_jax(nparams), out / "params.pt")
        np.savez(out / "batches.npz", **{f"{k}_{i}": v for i, batch in enumerate(batches)
                                        for k, v in batch.items()})
        tc = _train_config(per_device_batch_size=4, output_dir=str(out / "run"), fsdp=fsdp,
                           max_grad_norm=1.0, weight_decay=0.01)
        cases.append({"model": config.to_dict(),
                      "data": DataConfig(max_seq_length=8, decode_size=40).to_dict(),
                      "train": tc.to_dict(), "params": str(out / "params.pt"),
                      "batches": str(out / "batches.npz"), "out": str(out)})
        refs[name] = (config, nparams, batches)
    spawn({"init_method": f"file://{tmp_path / 'rendezvous'}", "backend": "gloo", "world": 2,
           "device": "cpu", "cases": cases}, str(tmp_path), 240,
          env={"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2", "XLA_FLAGS": ""})

    for name, (config, nparams, batches) in refs.items():
        out = tmp_path / name
        ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
        final = torch.load(out / "final.pt", weights_only=True)
        one = _trainer(config, per_device_batch_size=8, max_grad_norm=1.0, weight_decay=0.01,
                       output_dir=str(tmp_path / f"one_{name}"))
        state = one.init_state(from_jax(nparams))
        losses = []
        for batch in batches:
            state, metrics = one.train_step(state, one.put_batch(batch))
            losses.append(metrics["loss"].item())
        for r in ranks:
            assert r["ranks"] == 2
            assert max(loss_gaps(r["losses"], losses)) <= (1e-6 if name == "f32" else 1e-4)
        whole = {path: leaf.detach() for path, leaf in tree_leaves(state.params)}
        got = dict(tree_leaves(final["params"]))
        assert ("lm_head", "kernel") in got
        close = 1e-5 if name == "f32" else 1e-4
        worst, _ = param_gaps(got, whole, close)
        # the share beyond ``close`` over the whole tree (key biases left
        # out, as param_gaps leaves them): at this width a leaf may hold 64
        # entries, where one bf16-noise entry is more than 1% of it
        far = [int(((got[p].double() - whole[p].double()).abs() > close).sum())
               for p in whole if tuple(p[-2:]) != ("k", "bias")]
        total = sum(whole[p].numel() for p in whole if tuple(p[-2:]) != ("k", "bias"))
        assert worst <= 2 * 3 * LR and sum(far) <= 0.01 * total, (name, worst, sum(far), total)

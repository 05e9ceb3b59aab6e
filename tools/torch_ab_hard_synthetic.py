"""Train the port's flagship decoder on the hard synthetic task, then two
behavioural A/Bs on the trained model (the counterpart of
tools/ab_hard_synthetic.py, with its flags and defaults; on the CUDA card
unless ``--device cpu``).

The task (tools/data/make_synthetic.py --hard): 12-20-token captions of a
square's colour and size on a coloured background in four languages, with
two synonym slots drawn uniformly when the data is made, so a trained
model meets genuine near-tie continuations where an approximate candidate
select could change the argmax.

A/B 1, shadow params: the same model trained twice, ``TrainConfig.
shadow_params`` on and off, from one seed over one data order: the loss
curves at every logging step, the final eval loss and the beam-4 BLEU of
each language.

A/B 2, candidate selection: with the shadow-on model, beam 4 under each
mode of ``DECODE_MODES`` (the exact top-k over the dense logits; the fused
head's bucket and window selects; approx_max_k, which the port runs as the
exact select): BLEU per language, full-sequence agreement with the exact
mode on one val batch a language, and the per-step recall@9 of each select
over the teacher-forced positions of the exact mode's sequences.

The model: the flagship mBART-50 decoder (V = 250054, d_model 1024) with
the tied head and a tiny vision tower, bfloat16.  ``--save_model`` writes
the shadow-on model to ``<out>/model`` (about 2.2 GB; the input of
tools/torch_bench_trained.py and of mic_tpu_torch.cli.evaluate).

  python tools/data/make_synthetic.py --out build/hard --n 4096 --hard
  python tools/torch_ab_hard_synthetic.py --data build/hard --out build/abrun --save_model
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _here)                        # torch_validate_approx_decode
sys.path.insert(0, os.path.dirname(_here))       # mic_tpu_torch

import numpy as np
import torch


def build_trainer(args, shadow: bool, model_config=None):
    """The port's Trainer with the JAX tool's data and train settings;
    ``model_config`` replaces the flagship decoder + tiny vision tower."""
    from mic_tpu_torch.core.config import (
        CaptionerConfig, DataConfig, TrainConfig, VisionConfig,
    )
    from mic_tpu_torch.train.trainer import Trainer

    mc = model_config
    if mc is None:
        flagship = CaptionerConfig.clip_vit_b32_mbart50(dtype="bfloat16")
        mc = CaptionerConfig(vision=VisionConfig.tiny(), decoder=flagship.decoder,
                             tie_word_embeddings=True, dtype="bfloat16")
    dc = DataConfig(
        train_file=os.path.join(args.data, "train.tsv"),
        validation_file=os.path.join(args.data, "val.tsv"),
        images_dir=os.path.join(args.data, "images"),
        max_seq_length=24,              # hard captions run 12-20 tokens
        num_workers=args.num_workers,
        decode_size=mc.vision.image_size,
    )
    tc = TrainConfig(
        output_dir=os.path.join(args.out, "shadow_on" if shadow else "shadow_off"),
        num_epochs=args.epochs,
        per_device_batch_size=args.batch, learning_rate=args.lr,
        warmup_steps=100, logging_steps=args.log_every, eval_steps=10**9,
        save_steps=10**9, seed=0, gen_eval=False,
        shadow_params=shadow,
    )
    return Trainer(mc, dc, tc, device=args.device)


def train_arm(args, shadow: bool, model_config=None, params=None):
    """Train one arm -> (trainer, state, eval loaders, [[step, loss]] at
    every logging step, eval metrics).  ``params`` (float32, e.g. carried
    from mic_tpu by io/from_jax.py) replaces the seeded init."""
    tag = f"[shadow={'on' if shadow else 'off'}]"
    trainer = build_trainer(args, shadow, model_config)
    train_loader, eval_loaders = trainer.make_loaders()
    trainer.build(len(train_loader))
    state = (trainer.init_or_resume(train_loader) if params is None
             else trainer.init_state(params))
    losses = []
    step = 0
    t_start = t_log = time.perf_counter()
    try:
        while train_loader.epoch < trainer.tc.num_epochs:
            for batch in train_loader.epoch_iterator():
                state, metrics = trainer.train_step(state, trainer.put_batch(batch))
                step += 1
                if step % args.log_every == 0:
                    # the one host read of the loss, which waits for the step
                    loss = float(metrics["loss"])
                    now = time.perf_counter()
                    losses.append([step, round(loss, 4)])
                    print(f"{tag} step {step} loss {loss:.4f} "
                          f"({(now - t_log) * 1e3 / args.log_every:.1f} ms/step)", flush=True)
                    t_log = now
    finally:
        train_loader.close()
    print(f"{tag} {step} steps in {time.perf_counter() - t_start:.1f} s", flush=True)
    trainer.tc = trainer.tc.replace(gen_eval=True)
    t0 = time.perf_counter()
    metrics = trainer.evaluate(state.params, eval_loaders)
    metrics = {k: round(float(v), 4) for k, v in metrics.items()
               if "bleu" in k or k.endswith("loss")}
    print(f"{tag} eval {json.dumps(metrics)} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return trainer, state, eval_loaders, losses, metrics


DECODE_MODES = {
    # exact reference semantics: the dense logits, the exact top-k
    "exact": {
        "MIC_TPU_EXACT_TOPK": "1", "MIC_TPU_FUSED_HEAD": "0",
        "MIC_TPU_FUSED_SELECT": "",
    },
    # the fused head, bucket select (row 4; the card's serving default)
    "fused-bucket": {
        "MIC_TPU_EXACT_TOPK": "0", "MIC_TPU_FUSED_HEAD": "1",
        "MIC_TPU_FUSED_SELECT": "bucket",
    },
    # the fused head, window select (row 5)
    "fused-window": {
        "MIC_TPU_EXACT_TOPK": "0", "MIC_TPU_FUSED_HEAD": "1",
        "MIC_TPU_FUSED_SELECT": "window",
    },
    # the dense logits under mic_tpu's approx_max_k settings: the port has
    # no counterpart of that TPU operation and selects exactly
    "approx_max_k": {
        "MIC_TPU_EXACT_TOPK": "0", "MIC_TPU_FUSED_HEAD": "0",
        "MIC_TPU_FUSED_SELECT": "",
    },
}


def _first_batch(trainer, loader):
    """The loader's first batch padded to the eval batch -> (device batch,
    real rows)."""
    loader.next_batch = 0
    batch = next(loader.epoch_iterator(epoch=0))
    batch, n_real = trainer._pad_to_multiple(dict(batch), trainer.eval_batch)
    return trainer.put_batch(batch), n_real


def decode_ab(trainer, state, eval_loaders, args):
    """BLEU, sequence agreement with the exact mode and the trained model's
    per-step recall@9, per mode.  The port reads MIC_TPU_FUSED_HEAD and
    MIC_TPU_FUSED_SELECT at each generate call, so setting them is enough."""
    from torch_validate_approx_decode import K_SLATE, per_step_recall

    from mic_tpu_torch.ops.image_prep import maybe_preprocess

    results = {}
    sequences = {}
    try:
        for name, env in DECODE_MODES.items():
            for k, v in env.items():
                if v:
                    os.environ[k] = v
                else:
                    os.environ.pop(k, None)
            t0 = time.perf_counter()
            metrics = trainer.evaluate(state.params, eval_loaders)
            results[name] = {k: round(float(v), 4) for k, v in metrics.items() if "bleu" in k}
            # full beam-4 sequences on the first val batch of each language
            seq_rows = []
            for lang, loader in sorted(eval_loaders.items()):
                dev, n_real = _first_batch(trainer, loader)
                out = trainer.generate_step(state.params, dev["pixel_values"],
                                            trainer.tokenizer.lang_code_to_id[lang])
                seq_rows.append(out.cpu().numpy()[:n_real])
            sequences[name] = np.concatenate(seq_rows, axis=0)
            print(f"[decode-ab] {name} bleu {json.dumps(results[name])} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        for k in DECODE_MODES["exact"]:
            os.environ.pop(k, None)

    e_seq = sequences["exact"]
    for name, seq in sequences.items():
        if name == "exact":
            continue
        width = min(seq.shape[1], e_seq.shape[1])
        agree = (seq[:, :width] == e_seq[:, :width]).all(axis=1)
        results[name]["seq_agreement_vs_exact"] = round(float(agree.mean()), 4)
        results[name]["n_diverging"] = int((~agree).sum())
        print(f"[decode-ab] {name} agreement {agree.mean():.4f} "
              f"({int((~agree).sum())} diverging)", flush=True)

    # per-step candidate recall@9 on the teacher-forced positions of the
    # trained model (near ties by construction at the synonym slots)
    model = trainer.model
    lang, loader = sorted(eval_loaders.items())[0]
    dev, _ = _first_batch(trainer, loader)
    with torch.no_grad():
        px = maybe_preprocess(dev["pixel_values"], trainer.mc.vision.image_size, model.dtype)
        enc = model.encode(state.params, px)
        seqs = torch.from_numpy(e_seq[: px.shape[0]]).to(px.device)
        logits = model.decode_train(state.params, enc, seqs, torch.ones_like(seqs))
        flat = logits.reshape(-1, logits.shape[-1])
        rows = [per_step_recall(flat[i: i + 128].float()) for i in range(0, flat.shape[0], 128)]
    recall = {k: round(float(np.mean([r[k] for r in rows])), 4) for k in rows[0]}
    print(f"[decode-ab] trained-model per-step recall@{K_SLATE}: {json.dumps(recall)}",
          flush=True)
    return results, recall


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", required=True, help="make_synthetic --hard dir")
    ap.add_argument("--out", required=True)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log_every", type=int, default=20)
    ap.add_argument("--skip_shadow_off", action="store_true",
                    help="only train the shadow-on arm (decode A/B only)")
    ap.add_argument("--skip_decode_ab", action="store_true",
                    help="train + eval only (e.g. an optimizer-numerics A/B "
                         "arm driven via MIC_TPU_MOMENT_DTYPE)")
    ap.add_argument("--save_model", action="store_true",
                    help="save the primary arm to <out>/model "
                         "(tools/torch_bench_trained.py input)")
    ap.add_argument("--num_workers", type=int, default=-1,
                    help="train-image decode workers (DataConfig.num_workers; -1: cores - 2; "
                         "0: in the training process, as the JAX tool decodes)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    report = {}
    trainer, state, eval_loaders, losses_on, eval_on = train_arm(args, True)
    if args.save_model:
        model_dir = os.path.join(args.out, "model")
        t0 = time.perf_counter()
        trainer.model.save_pretrained(model_dir, state.params)
        trainer.tokenizer.save(os.path.join(model_dir, "tokenizer.json"))
        print(f"saved the primary arm to {model_dir} in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
    report["shadow_on"] = {"losses": losses_on, "eval": eval_on}
    if not args.skip_shadow_off:
        # the primary arm's state stays for the decode A/B; the other arm's
        # goes when its numbers are in
        _, _, _, losses_off, eval_off = train_arm(args, False)
        report["shadow_off"] = {"losses": losses_off, "eval": eval_off}

    if not args.skip_decode_ab:
        decode, recall = decode_ab(trainer, state, eval_loaders, args)
        report["decode_ab"] = decode
        report["trained_per_step_recall"] = recall

    path = os.path.join(args.out, "report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {path}")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

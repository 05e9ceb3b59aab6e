"""Serving with trained weights: beam search that ends where the model ends
its captions (the counterpart of tools/bench_trained.py, with its flags; on
the CUDA card unless ``--device cpu``).

Random weights never emit EOS, so every random-weights generate runs all
max_length - 1 steps.  A trained model ends its captions after 12-20
tokens and the beam loop stops early (every beam finished and no running
beam able to beat them, generate/search.py).  This script loads a saved
model (tools/torch_ab_hard_synthetic.py --save_model), captions val images
of the data it was trained on and reports captions/s at ``--batch`` and
the p50 latency of one image.  ``--min_length`` equal to ``--max_length``
blocks EOS, so the same weights run every step: the full-length figure.

  python tools/torch_bench_trained.py --model build/abrun/model --data build/hard
  python tools/torch_bench_trained.py ... --quant int8   # int8 weights (+ MIC_TPU_KV_QUANT)

Timing: the host clock around each generate, ended by a host read of its
sequences; the first call apart, then the median of the repeats.  The
decode steps each timed batch ran are printed on a line before the JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def load_pool(data: str, n: int = 256) -> np.ndarray:
    """The first ``n`` val images of a make_synthetic directory, (n, 256,
    256, 3) uint8: real images, since noise never leads to an early EOS."""
    from mic_tpu_torch.data.images import load_image_safe

    with open(os.path.join(data, "val.tsv")) as f:
        rows = [line.split("\t") for line in f if line.strip()]
    img_dir = os.path.join(data, "images")
    return np.stack([load_image_safe(os.path.join(img_dir, r[0]), 256) for r in rows[:n]])


def make_caption(model, params, start: int, args):
    """images (B, H, W, 3) uint8 on the model's device -> GenerateOutput:
    the training-consistent start (PAD, then the language forced at
    position 1), beam search as the flags say."""
    from mic_tpu_torch.ops.image_prep import maybe_preprocess

    def caption(images_u8):
        pixels = maybe_preprocess(images_u8, model.config.vision.image_size, model.dtype)
        return model.generate(
            params, pixels, max_length=args.max_length, num_beams=args.num_beams,
            min_length=args.min_length,
            decoder_start_token_id=model.config.decoder.pad_token_id,
            forced_bos_token_id=start,
            early_stopping=not args.no_early_stopping, quantize=args.quant,
        )

    return caption


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True, help="trained model dir")
    ap.add_argument("--data", required=True, help="make_synthetic.py output dir")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--max_length", type=int, default=64)
    ap.add_argument("--num_beams", type=int, default=4)
    ap.add_argument(
        "--no_early_stopping", action="store_true",
        help="beam search's early_stopping=False: the loop still ends once no "
             "running beam can beat the finished ones",
    )
    ap.add_argument("--min_length", type=int, default=0,
                    help="block EOS below this length (= --max_length: every step runs)")
    ap.add_argument("--quant", default=None, choices=[None, "int8"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    from mic_tpu_torch.core.params import make_serving_params, resolve_device
    from mic_tpu_torch.data.tokenizer import load_tokenizer
    from mic_tpu_torch.models.captioner import Captioner

    device = resolve_device(args.device)
    model, params = Captioner.from_pretrained(args.model, device=device)
    params = make_serving_params(params, model.dtype)  # cast once, as the CLIs do
    tok = load_tokenizer(os.path.join(args.model, "tokenizer.json"))
    pool = load_pool(args.data)
    rng = np.random.default_rng(0)
    caption = make_caption(model, params, tok.lang_code_to_id["en_XX"], args)

    def sample(batch):
        idx = rng.integers(0, len(pool), size=batch)
        return torch.from_numpy(pool[idx]).to(device)

    def measure(batch, reps):
        batches = [sample(batch) for _ in range(reps + 1)]
        t0 = time.perf_counter()
        caption(batches[0]).sequences.cpu()
        print(f"first call: {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        times, steps = [], []
        for b in batches[1:]:
            t0 = time.perf_counter()
            out = caption(b)
            out.sequences.cpu()
            times.append(time.perf_counter() - t0)
            steps.append(out.steps)
        print(f"batch={batch} decode steps per timed batch: {steps} (mean "
              f"{np.mean(steps):.2f} of {args.max_length - 1}); seconds {times}", flush=True)
        return float(np.median(times))

    dt = measure(args.batch, 3)
    tput = args.batch / dt
    print(f"trained batch={args.batch}: {dt * 1e3:.1f}ms -> {tput:.1f} captions/s/chip",
          file=sys.stderr)
    p50 = measure(1, 5)
    print(f"trained p50 batch=1: {p50 * 1e3:.1f}ms", file=sys.stderr)

    # the model really captions (not degenerate)
    seqs = caption(sample(args.batch)).sequences.cpu().numpy()
    texts = tok.batch_decode(seqs[:4])
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    result = {
        "trained_captions_per_sec_per_chip": round(tput, 2),
        "trained_p50_latency_ms_batch1": round(p50 * 1e3, 1),
        "quant": args.quant,
        "batch": args.batch,
        "sample_captions": texts,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

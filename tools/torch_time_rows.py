#!/usr/bin/env python3
"""Time the port's decode attention (row 18), tied-head kernels (rows 4, 5
and 6) and flash-CE kernels (rows 7 and 8, row 9's forward, and the save
and split backwards of rows 9 and 10) on one CUDA card, beside
scaled_dot_product_attention for row 18.

Run from the root of a checkout of the port (it imports that checkout's
mic_tpu_torch and chip_smoke.py, and builds its kernels there):

    python3 tools/torch_time_rows.py [--turns 2] [--cases decode,heads,ce] [--label NAME]
                                     [--out FILE]

Shapes: row 18 at L=12 T=64 H=16 Dh=64 index 63 with N in {4, 256}; the
heads at D=1024 V=250054 k=9 with N in {4, 1024}, each select; the
flash-CE forward, its saving form and the dl kernel at the flagship train
step's N=4096 rows, D=1024, V=250054 (chip_smoke's CE table and rows),
with cuBLAS's bare f32-output h @ W^T beside them for scale (the product
alone, not the same function), then the split route's backward, the save
route's (from the save forward's logits) and each of their four
contractions alone (``flash_ce_contraction``).  Each time
is printed twice: the device time of CUDA-graph replays (``graph_ms``) and
the per-call time with the wrapper's host work (``median_ms``).  With
--generate, each turn also times the flagship's B=256 beam-4 length-64
bf16 generate (random weights, chip_smoke.flagship; every caption's EOS
pinned at position 63, so 63 decode steps) on the host clock around the
synchronised call, as captions/s (a smoke figure, not a benchmark).
Every measurement is repeated ``--turns`` times in one process, so two
checkouts can be compared in turns (parent, change, change, parent) on one
card: run this script with each checkout as the working directory.  One
JSON line per measurement goes to stdout and, with --out, to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402
from chip_smoke import graph_ms, median_ms  # noqa: E402

HEAD_D, HEAD_V = 1024, 250054


def decode_cases(dev):
    import torch.nn.functional as F

    from mic_tpu_torch.ops.decode_attention import decode_attention

    layers, t, heads, dh, layer, index = 12, 64, 16, 64, 5, 63
    g = torch.Generator(device=dev).manual_seed(31)
    for n in (4, 256):
        q, ks, vs = ((torch.randn((n, 1, heads, dh), generator=g, device=dev) * s).bfloat16()
                     for s in (0.3, 0.5, 0.5))
        ck, cv = ((torch.randn((layers, n, t, heads, dh), generator=g, device=dev) * 0.5)
                  .bfloat16() for _ in range(2))
        qh = q.transpose(1, 2)
        kh, vh = (c[layer, :, :index + 1].transpose(1, 2) for c in (ck, cv))
        yield (f"decode_attention N={n}",
               lambda a=(q, ks, vs, ck, cv): decode_attention(*a, layer, index),
               lambda a=(qh, kh, vh): F.scaled_dot_product_attention(*a, scale=1.0))


def head_cases(dev):
    from mic_tpu_torch.ops.fused_head import fused_head_topk, fused_head_topk_q8
    from mic_tpu_torch.ops.quant import quantize_array

    g = torch.Generator(device=dev).manual_seed(6)
    weight = (torch.randn((HEAD_V, HEAD_D), generator=g, device=dev) * 0.02).bfloat16()
    bias = (torch.randn((HEAD_V,), generator=g, device=dev) * 0.1).bfloat16()
    wq, ws = quantize_array(weight, axis=1)
    for n in (4, 1024):
        hidden = torch.randn((n, HEAD_D), generator=g, device=dev).bfloat16()
        for select in ("bucket", "exact", "window"):
            yield (f"int8 {select} N={n}",
                   lambda s=select, h=hidden: fused_head_topk_q8(h, wq, ws, bias, 9, s), None)
            yield (f"bf16 {select} N={n}",
                   lambda s=select, h=hidden: fused_head_topk(h, weight, bias, 9, s), None)


def ce_cases(dev):
    from mic_tpu_torch.ops import flash_ce as fce

    n = 4096
    weight, bias = chip_smoke._ce_table(dev)
    hidden, labels = chip_smoke._ce_rows(dev, n, 11)
    lse = fce.flash_ce_forward_plain(hidden, weight, bias, labels)[0]
    rs = torch.full((n,), 1.0 / n, device=dev)
    yield (f"flash_ce_forward N={n}", lambda: fce.flash_ce_forward(hidden, weight, bias, labels),
           None)
    yield (f"flash_ce_forward save N={n}",
           lambda: fce.flash_ce_forward(hidden, weight, bias, labels, save=True), None)
    yield (f"flash_ce_dl N={n}",
           lambda: fce.flash_ce_dl(hidden, weight, bias, labels, lse, rs, 0.1), None)
    yield (f"cuBLAS h @ W^T f32 out N={n} (for scale)",
           lambda: torch.mm(hidden, weight.T, out_dtype=torch.float32), None)
    # rows 9 and 10: the save and split backwards and each contraction alone
    lg, tail = fce.flash_ce_forward(hidden, weight, bias, labels, save=True)[3:]
    args = (hidden, weight, bias, labels, lse, rs, 0.1, None)
    yield (f"flash_ce_backward split N={n}", lambda: fce.flash_ce_backward(*args), None)
    yield (f"flash_ce_backward_save N={n}",
           lambda: fce.flash_ce_backward_save(*args, lg, tail), None)
    for route, logits in (("split", None), ("save", lg)):
        for part in ("grad_w", "grad_h"):
            yield (f"flash_ce_contraction {route} {part} N={n}",
                   lambda p=part, lo=logits: fce.flash_ce_contraction(p, *args, logits_main=lo),
                   None)


def generate_case(dev, batch: int = 256):
    """-> a function running the flagship's beam-4 bf16 generate of
    ``batch`` images, returning its captions/s."""
    _, params, model, kw, pixels = chip_smoke.flagship(dev)
    px = pixels(batch, 1)
    kw = dict(kw, eos_positions=torch.full((batch,), 63, device=dev, dtype=torch.int32))
    model.generate(params, px, **kw)  # warm-up

    def run() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(params, px, **kw)
        torch.cuda.synchronize()
        if out.steps != 63:
            raise SystemExit(f"generate took {out.steps} steps, not 63")
        return batch / (time.perf_counter() - t0)

    return run


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--cases", default="decode,heads,ce")
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    parser.add_argument("--out", default=None)
    parser.add_argument("--generate", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_time_rows.py needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    lines = []
    groups = {"decode": decode_cases, "heads": head_cases, "ce": ce_cases}
    cases = [case for name in args.cases.split(",") for case in groups[name](dev)]
    generate = generate_case(dev) if args.generate else None
    for turn in range(args.turns):
        if generate is not None:
            rates = [generate(), generate()]
            row = {"label": args.label, "turn": turn, "case": "generate B=256 beam 4 bf16",
                   "card": card, "captions_per_s": rates}
            lines.append(row)
            print(json.dumps(row), flush=True)
        for name, fn, library in cases:
            row = {"label": args.label, "turn": turn, "case": name, "card": card,
                   "graph_ms": graph_ms(fn), "median_ms": median_ms(fn)}
            if library is not None:
                row["library_graph_ms"] = graph_ms(library)
            lines.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for row in lines:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()

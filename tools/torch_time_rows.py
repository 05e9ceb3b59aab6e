#!/usr/bin/env python3
"""Time the port's decode attention (row 18), mode "2"'s lazy attention
(rows 1 and 2), tied-head kernels (rows 4, 5 and 6), flash-CE kernels
(rows 7 and 8, row 9's forward, and the save and split backwards of rows
9 and 10), the fused beam step's kernels
(rows 3, 13, 14, 15, 16), the teacher-forced attention (rows 11 and 12),
the top-k + logsumexp (row 17) and the dequantising GEMM (row 20) on one
CUDA card, beside scaled_dot_product_attention for rows 18, 11 and 12.

Run from the root of a checkout of the port (it imports that checkout's
mic_tpu_torch and chip_smoke.py, and builds its kernels there):

    python3 tools/torch_time_rows.py [--turns 2]
                                     [--cases decode,heads,ce,fused,lazy,attn,topk,mm,f32few]
                                     [--label NAME] [--out FILE]

Shapes: row 18 at L=12 T=64 H=16 Dh=64 index 63 with N in {4, 256}; the
heads at D=1024 V=250054 k=9 with N in {4, 1024}, each select, in bf16,
int8 and float32; the
flash-CE forward, its saving form and the dl kernel at the flagship train
step's N=4096 rows, D=1024, V=250054 (chip_smoke's CE table and rows),
with cuBLAS's bare f32-output h @ W^T beside them for scale (the product
alone, not the same function), the float32 forward and dl (a float32
model's rows 7 and 8, on chip_smoke's f32 table) beside cuBLAS's full-f32
h @ W^T (TF32 off), then the split route's backward, the save
route's (from the save forward's logits) and each of their four
contractions alone (``flash_ce_contraction``); --cases fused: the blocked
lazy attention (row 3, bf16 and int8 per-head, index 63 and 17), the
cross-attentions (rows 13, 14, 14's int8 form), LN -> GEMM and the MLP
(rows 15, 16, N in {1024, 32}) beside the chains of calls that compute
the same (F.layer_norm + F.linear; F.linear -> F.gelu -> F.linear), as
``fused_cases`` says; --cases lazy:
rows 1 and 2 (bf16 and int8 cache) at B=256 K=4 T=64 H=16, index 63 and
17, as ``lazy_cases`` says; --cases attn: row 12's forward and backward
and row 11 at chip_smoke.ATTN_SHAPES (bf16, the decoder's causal mask,
vision's none), as ``attn_cases`` says; --cases topk: row 17 at (N, k) in
{(4, 2), (256, 2), (256, 9), (1024, 2), (1024, 9)}, V=250054, bf16, beside
torch.topk + torch.logsumexp; --cases mm: row 20 at K=1024 and (M, N) in
{(1024, 3072), (4, 3072), (4, 250054), (1024, 250054)} beside torch.mm on
the dequantised bf16 weight (for scale: it reads twice the weight bytes),
as ``mm_cases`` says; --cases f32few: row 4 f32 at N in {1, 2, 4} on the
route it takes, on the 3xTF32 tile and in its plain version, as
``f32few_cases`` says.  Each time
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
    # a float32 model's heads (rows 4 and 5 in f32) on the same values
    w32, b32 = weight.float(), bias.float()
    for n in (4, 1024):
        hidden = torch.randn((n, HEAD_D), generator=g, device=dev)
        for select in ("bucket", "exact", "window"):
            yield (f"f32 {select} N={n}",
                   lambda s=select, h=hidden: fused_head_topk(h, w32, b32, 9, s), None)


def f32few_cases(dev):
    """Row 4 f32 (the bucket select) at a few rows, N in {1, 2, 4}: the
    route ``bucket_f32_route`` takes, the 3xTF32 tile, and the plain
    version, in turns within each N."""
    from mic_tpu_torch.ops.fused_head import _bucket_f32, fused_head_topk, fused_head_topk_plain

    g = torch.Generator(device=dev).manual_seed(7)
    weight = torch.randn((HEAD_V, HEAD_D), generator=g, device=dev) * 0.02
    bias = torch.randn((HEAD_V,), generator=g, device=dev) * 0.1
    for n in (1, 2, 4):
        hidden = torch.randn((n, HEAD_D), generator=g, device=dev)
        yield (f"f32 bucket N={n} route taken",
               lambda h=hidden: fused_head_topk(h, weight, bias, 9), None)
        yield (f"f32 bucket N={n} tile", lambda h=hidden: _bucket_f32(h, weight, bias, 9, 0), None)
        yield (f"f32 bucket N={n} plain",
               lambda h=hidden: fused_head_topk_plain(h, weight, bias, 9, "bucket"), None)


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
    # a float32 model's rows 7 and 8 (chip_smoke's f32 table), beside
    # cuBLAS's full-f32 product (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    w32, b32 = chip_smoke._f32_table(dev, chip_smoke.CE_V, chip_smoke.CE_D, 54)
    h32 = hidden.float()
    lse32 = fce.flash_ce_forward_plain(h32, w32, b32, labels)[0]
    yield (f"flash_ce_forward f32 N={n}", lambda: fce.flash_ce_forward(h32, w32, b32, labels),
           None)
    yield (f"flash_ce_dl f32 N={n}",
           lambda: fce.flash_ce_dl(h32, w32, b32, labels, lse32, rs, 0.1), None)
    yield (f"cuBLAS h @ W^T f32 N={n} (for scale)", lambda: torch.mm(h32, w32.T), None)
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


def fused_cases(dev):
    """The fused beam step's kernels at chip_smoke's shapes (rows 3, 13, 14
    and its int8 form, 15, 16), with the chains of calls for scale: row 3
    on the bf16 and the per-head int8 cache at B=256 K=4 T=64 H=16, index
    63 and 17 (ancestry masks); rows 13 and 14 at S=50 (13 padded to 64);
    rows 15 and 16 at N in {1024, 32}, D=1024 (O=3072, F=4096)."""
    import torch.nn.functional as F

    from mic_tpu_torch.ops.cross_attention import (
        fused_cross_attention, fused_cross_attention_dma, fused_cross_attention_q8,
    )
    from mic_tpu_torch.ops.fused_mlp import fused_mlp
    from mic_tpu_torch.ops.lazy_attention import build_ancestry_mask, fused_lazy_attention
    from mic_tpu_torch.ops.ln_gemm import ln_gemm
    from mic_tpu_torch.ops.quant import quantize_rows_dynamic

    b, beams, t, heads, dh, s = 256, 4, 64, 16, 64, 50
    hd = heads * dh
    g = torch.Generator(device=dev).manual_seed(31)

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    for q8 in (False, True):
        q, ks, vs = rand(b, beams, hd, scale=0.3), rand(b, beams, hd), rand(b, beams, hd)
        if q8:
            ck, cv = ({"q": v.reshape(b * beams, t, hd), "s": sc[..., 0].contiguous()}
                      for v, sc in (quantize_rows_dynamic(rand(b * beams, t, heads, dh))
                                    for _ in range(2)))
        else:
            ck, cv = rand(b * beams, t, hd), rand(b * beams, t, hd)
        anc = torch.randint(0, beams, (b, beams, t), generator=g, device=dev, dtype=torch.int32)
        for index in (63, 17):
            amask = build_ancestry_mask(anc, index)
            yield (f"fused_lazy_attention {'int8 per-head' if q8 else 'bf16'} index={index}",
                   lambda a=(q, ck, cv, ks, vs, amask), i=index: fused_lazy_attention(
                       *a, beams, heads, positions=i), None)
    q = rand(b, beams, hd, scale=0.3)
    ek, ev = rand(b, s, heads, dh), rand(b, s, heads, dh)
    yield ("fused_cross_attention S=50", lambda: fused_cross_attention(q, ek, ev, beams, heads),
           None)
    cq8 = [{"q": v, "s": sc[..., 0].contiguous()}
           for v, sc in (quantize_rows_dynamic(c) for c in (ek, ev))]
    yield ("fused_cross_attention_q8 S=50",
           lambda: fused_cross_attention_q8(q, *cq8, beams, heads), None)
    pad = torch.zeros((b, 64 - s, hd), dtype=torch.bfloat16, device=dev)
    mk, mv = (torch.cat([c.reshape(b, s, hd), pad], 1).contiguous() for c in (ek, ev))
    yield ("fused_cross_attention_dma S=50 of 64",
           lambda: fused_cross_attention_dma(q, mk, mv, s, beams, heads), None)
    d = 1024
    scale = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).bfloat16()
    shift, w, bias = rand(d, scale=0.1), rand(d, 3 * d, scale=0.03), rand(3 * d, scale=0.1)
    w1, b1, w2, b2 = rand(d, 4 * d, scale=0.03), rand(4 * d, scale=0.1), \
        rand(4 * d, d, scale=0.02), rand(d, scale=0.1)
    wt, w1t, w2t = w.t(), w1.t(), w2.t()
    for n in (1024, 32):
        x = rand(n, d, scale=1.0)
        yield (f"ln_gemm N={n}", lambda x=x: ln_gemm(x, scale, shift, w, bias), None)
        yield (f"chain F.layer_norm + F.linear N={n} (for scale)",
               lambda x=x: F.linear(F.layer_norm(x, (d,), scale, shift, 1e-5), wt, bias), None)
        yield (f"fused_mlp N={n}", lambda x=x: fused_mlp(x, w1, b1, w2, b2), None)
        yield (f"chain F.linear -> F.gelu -> F.linear N={n} (for scale)",
               lambda x=x: F.linear(F.gelu(F.linear(x, w1t, b1)), w2t, b2), None)


def mm_cases(dev):
    """Row 20 at K=1024: M=1024 and M=4 at N=3072 (the QKV width) and at
    N=250054 (the head's), x random bf16, w_q uniform int8, scales in
    [0.01, 0.1), beside torch.mm on the dequantised bf16 weight."""
    from mic_tpu_torch.ops.int8_matmul import int8_matmul

    g = torch.Generator(device=dev).manual_seed(37)
    k = HEAD_D
    for n in (3 * HEAD_D, HEAD_V):
        wq = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        wscale = torch.rand((n,), generator=g, device=dev) * 0.09 + 0.01
        w = wq.to(torch.bfloat16) * wscale.to(torch.bfloat16)
        for m in (1024, 4):
            x = (torch.randn((m, k), generator=g, device=dev) * 0.3).bfloat16()
            yield (f"int8_matmul M={m} K={k} N={n}",
                   lambda x=x, wq=wq, s=wscale: int8_matmul(x, wq, s),
                   lambda x=x, w=w: torch.mm(x, w))


def lazy_cases(dev):
    """Mode "2"'s column-writing lazy attention (rows 1 and 2) at B=256 K=4
    T=64 H=16, index 63 and 17, on the bf16 cache and the merged int8 cache
    (one scale a merged row), as chip_smoke's phases 1 and 14 draw them.
    Each call writes column ``index`` in place: the same values on every
    replay."""
    from mic_tpu_torch.ops.lazy_attention import lazy_attention, lazy_attention_q8
    from mic_tpu_torch.ops.quant import quantize_rows_dynamic

    b, beams, t, heads, dh = 256, 4, 64, 16, 64
    hd = heads * dh
    g = torch.Generator(device=dev).manual_seed(37)

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    for q8 in (False, True):
        q, ks, vs = rand(b, beams, hd, scale=0.3), rand(b, beams, hd), rand(b, beams, hd)
        if q8:
            ck, cv = ({"q": v, "s": sc[..., 0].contiguous()}
                      for v, sc in (quantize_rows_dynamic(rand(b * beams, t, hd))
                                    for _ in range(2)))
        else:
            ck, cv = rand(b * beams, t, hd), rand(b * beams, t, hd)
        anc = torch.randint(0, beams, (b, beams, t), generator=g, device=dev, dtype=torch.int32)
        fn = lazy_attention_q8 if q8 else lazy_attention
        for index in (63, 17):
            yield (f"lazy_attention {'int8' if q8 else 'bf16'} index={index}",
                   lambda a=(q, ck, cv, ks, vs, anc), i=index, f=fn: f(*a, i, heads), None)


def attn_cases(dev):
    """Rows 12 (forward, backward) and 11 at the decoder's and vision's
    shapes (chip_smoke.ATTN_SHAPES, _attention_case), beside
    scaled_dot_product_attention with the same boolean mask: its forward in
    graph replays, its backward (torch.autograd.grad) by the device time of
    its kernels in a profiler trace (``library_profiled_ms``; where the
    checkout's chip_smoke has ``profiled_ms``, since autograd runs on the
    forward's stream and a graph capture cannot hold it), taken after every
    other time of the run, so that no graph-replay time follows a trace."""
    import torch.nn.functional as F

    from mic_tpu_torch.ops import flash_attention as fa
    from mic_tpu_torch.ops import small_attention as sa

    profiled = getattr(chip_smoke, "profiled_ms", None)
    for shape, kind in (("decoder", "causal"), ("vision", None)):
        b, n, heads = chip_smoke.ATTN_SHAPES[shape]
        q, k, v, mask = chip_smoke._attention_case(dev, b, n, heads, kind, 440)
        bias, fbias = sa.mask_bias(mask, b, n), fa.mask_bias(mask, b, n, n)
        do = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(441),
                         device=dev).bfloat16()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=1.0)
        dot = do.transpose(1, 2)
        sdpa = lambda a=(qt, kt, vt), m=mask: F.scaled_dot_product_attention(  # noqa: E731
            *a, attn_mask=m, scale=1.0)
        sdpa_bwd = lambda o=out, lv=leaves, g=dot: torch.autograd.grad(  # noqa: E731
            o, lv, g, retain_graph=True)
        yield (f"small_attention_forward {shape}",
               lambda a=(q, k, v, bias): sa.small_attention_forward(*a), sdpa)
        yield (f"small_attention_backward {shape}",
               lambda a=(q, k, v, bias, do): sa.small_attention_backward(*a),
               None if profiled is None else (profiled, sdpa_bwd))
        yield (f"flash_attention {shape}",
               lambda a=(q, k, v, fbias): fa.flash_attention_forward(*a), sdpa)


def topk_cases(dev):
    """Row 17 at the greedy and beam shapes, V=250054, bf16, beside
    torch.topk + torch.logsumexp (two calls, the lse in bf16)."""
    from mic_tpu_torch.ops.topk_lse import topk_log_probs

    g = torch.Generator(device=dev).manual_seed(23)
    for n, k in ((4, 2), (256, 2), (256, 9), (1024, 2), (1024, 9)):
        x = (torch.randn((n, HEAD_V), generator=g, device=dev) * 2).bfloat16()
        yield (f"topk_log_probs N={n} k={k}", lambda x=x, k=k: topk_log_probs(x, k),
               lambda x=x, k=k: (torch.topk(x, k), torch.logsumexp(x, dim=-1)))


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
    groups = {"decode": decode_cases, "heads": head_cases, "ce": ce_cases, "fused": fused_cases,
              "lazy": lazy_cases, "attn": attn_cases, "topk": topk_cases, "mm": mm_cases,
              "f32few": f32few_cases}
    cases = [case for name in args.cases.split(",") for case in groups[name](dev)]
    generate = generate_case(dev) if args.generate else None
    profiled = []  # (row, timer, fn): timed after everything else
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
            if isinstance(library, tuple):  # (timer, fn): a call a graph cannot hold
                profiled.append((row, *library))
            elif library is not None:
                row["library_graph_ms"] = graph_ms(library)
            lines.append(row)
            if not isinstance(library, tuple):
                print(json.dumps(row), flush=True)
    for row, timer, fn in profiled:
        row["library_profiled_ms"] = timer(fn)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for row in lines:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()

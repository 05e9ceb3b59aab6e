#!/usr/bin/env python3
"""Where the cross-attention kernel's time goes, and its block shape: row
14 (bf16) and its int8 form timed with variants of csrc/attend_rows.cuh,
each a patched copy of mic_tpu_torch/csrc built under build/variants/ into
its own library, on one CUDA card, at B=256 K=4 S=50 H=16 in CUDA-graph
replays.

Run from the root of a checkout of the port:

    python3 tools/torch_cross_variants.py [--turns 2] [--out FILE] [NAME ...]

with NAME a key of ``VARIANTS`` (all of them by default).  The variants:
``base``, the source as it is (one head a block, four warps); ``zero``,
every K and V copy zero-filled from no address (no DRAM traffic: the
block's own work alone); ``zero_issue_only``, ``zero`` and each block
stops once its copies have landed (launch and copy issue);
``zero_no_scores``, ``zero_no_softmax``, ``zero_no_v``: ``zero`` less one
phase; ``regs48`` and ``regs40``, launch bounds for 10 and 12 blocks an SM
instead of 8; ``heads<G>_warps<W>``, the other block shapes: G heads of one
image a block (1, 2, 4) and W warps (2, 4, 8), from ``shape``.  A variant
whose patch no longer applies to the source is reported and skipped.  The
outputs of the ``zero`` variants are wrong by design; each variant's
largest error against the plain version is printed beside its times.  One
JSON line per variant and turn goes to stdout and, with --out, to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

from chip_smoke import graph_ms  # noqa: E402

SOURCE = "mic_tpu_torch/csrc"
ZERO = [("      cp_async16(dst + r * kPitch, live ? src + r * row_bytes : src, live ? 16 : 0);",
         "      cp_async16(dst + r * kPitch, live ? src + r * row_bytes : src, 0);")]
GROUPS8 = "    const int groups8 = (min(nc, positions - c0) + 7) / 8;\n"
BOUNDS = "__launch_bounds__(kThreads, 8)"


def shape(heads: int, warps: int):
    """The patches that give a block ``heads`` heads of one image (1, 2 or
    4; they must divide the heads) and ``warps`` warps: each phase's items
    run over the block's heads, head g's tiles, scales, scores and sums at
    g times their one-head size.  The launch bound keeps 64 registers."""
    patches = [("constexpr int kWarps = 4;",
                f"constexpr int kWarps = {warps};\nconstexpr int kGroup = {heads};"),
               (BOUNDS, f"__launch_bounds__(kThreads, {32 // warps})")]
    if heads == 1:
        return patches
    return patches + [
        # the layout: each region kGroup times as large
        ("static_cast<size_t>(l.beams16) * kPitch",
         "kGroup * static_cast<size_t>(l.beams16) * kPitch"),
        ("static_cast<size_t>(stage) * kPitch", "kGroup * static_cast<size_t>(stage) * kPitch"),
        ("2 * 4 * static_cast<size_t>(l.rows16)", "2 * 4 * kGroup * static_cast<size_t>(l.rows16)"),
        ("4 * static_cast<size_t>(beams) *", "4 * kGroup * static_cast<size_t>(beams) *"),
        ("4 * static_cast<size_t>(l.beams16) * kHeadDim",
         "4 * kGroup * static_cast<size_t>(l.beams16) * kHeadDim"),
        ("dim3(a.heads, a.batch)", "dim3(a.heads / kGroup, a.batch)"),
        # the block's first head, and head g's scales
        ("  const int h = blockIdx.x;", "  const int h = blockIdx.x * kGroup;"),
        ("  float* v_sc = k_sc + rows16;", "  float* v_sc = k_sc + kGroup * rows16;"),
        # copies: [row][head][piece] over the block's threads
        ("  const int piece = tid % kPieces;\n",
         "  const int piece = tid % kPieces;\n  const int tg = (tid / kPieces) % kGroup;\n"),
        ("h * kHeadDim) * sizeof(T) + 16 * piece;",
         "(h + tg) * kHeadDim) * sizeof(T) + 16 * piece;"),
        ("smem_addr(tile + (kQ8 ? 64 : 0) + 16 * piece)",
         "smem_addr(tile + tg * stage * kPitch + (kQ8 ? 64 : 0) + 16 * piece)"),
        ("for (int r = tid / kPieces; r < nc; r += kThreads / kPieces)",
         "for (int r = tid / kPieces / kGroup; r < nc; r += kThreads / kPieces / kGroup)"),
        ("    for (int i = tid; i < nc; i += kThreads) {\n"
         "      unsigned char* row = tile + i * kPitch;",
         "    for (int i = tid; i < kGroup * nc; i += kThreads) {\n"
         "      unsigned char* row = tile + ((i % kGroup) * stage + i / kGroup) * kPitch;"),
        ("beams * hd + h * kHeadDim + 8 * (tid & 7);",
         "beams * hd + (h + (tid >> 3) % kGroup) * kHeadDim + 8 * (tid & 7);"),
        ("smem_addr(q_tile + 16 * (tid & 7));",
         "smem_addr(q_tile + (tid >> 3) % kGroup * beams16 * kPitch + 16 * (tid & 7));"),
        ("for (int k = tid >> 3; k < beams16; k += kThreads / 8)",
         "for (int k = (tid >> 3) / kGroup; k < beams16; k += kThreads / 8 / kGroup)"),
        ("    for (int t = tid; t < rows16; t += kThreads) {\n",
         "    for (int i = tid; i < kGroup * rows16; i += kThreads) {\n"
         "      const int g = i % kGroup;\n      const int t = i / kGroup;\n"),
        ("* a.heads + h;", "* a.heads + h + g;"),
        ("smem_addr(k_sc + t)", "smem_addr(k_sc + g * rows16 + t)"),
        ("smem_addr(v_sc + t)", "smem_addr(v_sc + g * rows16 + t)"),
        # the scores: (head, 8 rows) items
        ("    for (int it = warp; it < groups8; it += kWarps) {\n      const int r0 = 8 * it;",
         "    for (int it = warp; it < kGroup * groups8; it += kWarps) {\n"
         "      const int g = it / groups8;\n      const int r0 = 8 * (it - g * groups8);"),
        ("smem_addr(k_tile + (r0 + (lane & 7)) * kPitch",
         "smem_addr(k_tile + (g * stage + r0 + (lane & 7)) * kPitch"),
        ("smem_addr(q_tile + (m0 + (lane & 15)) * kPitch",
         "smem_addr(q_tile + (g * beams16 + m0 + (lane & 15)) * kPitch"),
        ("scores[k * ss + t] = kQ8 ? __fmul_rn(s, k_sc[t]) : s;",
         "scores[(g * beams + k) * ss + t] = kQ8 ? __fmul_rn(s, k_sc[g * rows16 + t]) : s;"),
        # the softmax: a warp a (head, beam)
        ("  for (int row = warp; row < beams; row += kWarps) {\n",
         "  for (int row = warp; row < kGroup * beams; row += kWarps) {\n"
         "    const int g = row / beams;\n"),
        ("w = __fmul_rn(w, v_sc[t]);", "w = __fmul_rn(w, v_sc[g * rows16 + t]);"),
        # the V product: (head, 16 beams, 16 dims) items
        ("    for (int it = warp; it < mtiles * 4; it += kWarps) {",
         "    for (int it = warp; it < kGroup * mtiles * 4; it += kWarps) {"),
        ("      const int m0 = 16 * (it >> 2);\n",
         "      const int m0 = 16 * ((it >> 2) % mtiles);\n"
         "      const int g = (it >> 2) / mtiles;\n"),
        ("partial + (m0 + g8) * kHeadDim", "partial + (g * beams16 + m0 + g8) * kHeadDim"),
        ("scores + min(m0 + g8, beams - 1) * ss",
         "scores + (g * beams + min(m0 + g8, beams - 1)) * ss"),
        ("smem_addr(v_tile + (8 * ((lane >> 3) & 1)",
         "smem_addr(v_tile + (g * stage + 8 * ((lane >> 3) & 1)"),
        ("                               h * kHeadDim + 16 * qd + 2 * c;",
         "                               (h + g) * kHeadDim + 16 * qd + 2 * c;"),
    ]


VARIANTS = {
    "base": [],
    "zero": ZERO,
    "zero_issue_only": ZERO + [(GROUPS8, "    if (a.heads > 0) return;\n" + GROUPS8)],
    "zero_no_scores": ZERO + [(GROUPS8, GROUPS8.replace("= (", "= 0 * ("))],
    "zero_no_softmax": ZERO + [("  for (int row = warp; row < beams; row += kWarps) {",
                                "  for (int row = warp; row < 0; row += kWarps) {")],
    "zero_no_v": ZERO + [("    for (int it = warp; it < mtiles * 4; it += kWarps) {",
                          "    for (int it = warp; it < 0; it += kWarps) {")],
    "regs48": [(BOUNDS, "__launch_bounds__(kThreads, 10)")],
    "regs40": [(BOUNDS, "__launch_bounds__(kThreads, 12)")],
    **{f"heads{heads}_warps{warps}": shape(heads, warps)
       for heads in (1, 2, 4) for warps in (2, 4, 8) if (heads, warps) != (1, 4)},
}


def build(variants: dict) -> dict:
    """Patched copies of the sources, built all at once -> each variant's
    library path, or None where a patch does not apply or the build fails."""
    from mic_tpu_torch import _build

    procs = {}
    for name, patches in variants.items():
        folder = os.path.join("build", "variants", name)
        shutil.rmtree(folder, ignore_errors=True)
        shutil.copytree(SOURCE, folder)
        path = os.path.join(folder, "attend_rows.cuh")
        with open(path) as f:
            text = f.read()
        missing = [old for old, _ in patches if old not in text]
        if missing:
            print(f"{name}: its patch does not apply to attend_rows.cuh; skipped", flush=True)
            continue
        for old, new in patches:
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(folder, "lib.so")
        cmd = [_build._nvcc(), *_build._FLAGS, "-shared", "-o", lib,
               os.path.join(folder, "cross_attention.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            print(f"{name}: the build failed; skipped\n{err[-2000:]}", flush=True)
        libs[name] = None if proc.returncode else lib
    return libs


def load(lib: str) -> None:
    """Make ``lib`` the library the wrappers call (its cross entries only)."""
    from mic_tpu_torch import _build

    loaded = ctypes.CDLL(lib)
    for name, argtypes in _build._SIGNATURES.items():
        if name.startswith("mic_cross_attention"):
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    _build._lib = loaded


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--out", default=None)
    parser.add_argument("names", nargs="*", default=list(VARIANTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_cross_variants.py needs a CUDA device")
    from mic_tpu_torch.ops.cross_attention import (
        fused_cross_attention, fused_cross_attention_plain, fused_cross_attention_q8,
    )
    from mic_tpu_torch.ops.quant import quantize_rows_dynamic

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    b, beams, heads, dh, s = 256, 4, 16, 64, 50
    g = torch.Generator(device=dev).manual_seed(16)
    q = (torch.randn((b, beams, heads * dh), generator=g, device=dev) * 0.3).bfloat16()
    ek, ev = ((torch.randn((b, s, heads, dh), generator=g, device=dev) * 0.5).bfloat16()
              for _ in range(2))
    cq8 = [{"q": v, "s": sc[..., 0].contiguous()}
           for v, sc in (quantize_rows_dynamic(c) for c in (ek, ev))]
    ref = fused_cross_attention_plain(q, ek, ev, beams, heads)
    libs = build({name: VARIANTS[name] for name in args.names})
    rows = []
    for turn in range(args.turns):
        for name, lib in libs.items():
            if lib is None:
                continue
            load(lib)
            out = fused_cross_attention(q, ek, ev, beams, heads)
            torch.cuda.synchronize()
            row = {"turn": turn, "variant": name, "card": card,
                   "bf16_graph_ms": graph_ms(lambda: fused_cross_attention(q, ek, ev, beams,
                                                                           heads)),
                   "int8_graph_ms": graph_ms(lambda: fused_cross_attention_q8(q, *cq8, beams,
                                                                              heads)),
                   "max_abs_err": (out.float() - ref.float()).abs().max().item()}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()

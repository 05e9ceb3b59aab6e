#!/usr/bin/env python3
"""The float32 kernels of rows 4, 7 and 8 (csrc/fused_head_f32.cu and
csrc/flash_ce_f32.cu, both on the 3xTF32 tile of csrc/tf32x3_wgmma.cuh)
under variants of their tiles, each a patched copy of those sources built
under build/variants/ into its own library, on one CUDA card, timed in
CUDA-graph replays at the main path's shapes: the bucket head at N=1024
(the tile) and N=4 (the stream), D=1024, V=250054, k=9; the CE forward and
dl at N=4096.

Run from the root of a checkout of the port:

    python3 tools/torch_f32_variants.py [--turns 2] [--out FILE] [NAME ...]

with NAME a key of ``VARIANTS`` (all by default): ``base``, the sources as
they are (the head's TF32 hi and lo truncated; the CE forward's ring of
four 48 KB slots); ``head_round``, the head's TF32 hi and lo rounded to
nearest (``cvt.rna``) instead: the time and error of each choice;
``ce_stages3``, the CE forward's ring cut to three slots (as dl's);
``ce_table_only``, the CE walks loading the hidden rows' hi and lo only
into the ring's first slots and reusing them after (wrong results: the
time without two thirds of the bytes each slot brings, a bound and not a
cost);
``ce_lo_once``, the same for the hidden rows' lo boxes alone (a third of
the bytes each slot brings); ``ce_fold_off``, the CE forward with each
tile's statistics replaced by a sum of its accumulators (wrong results:
the fold's cost).  A
patch that no longer applies, or a variant that does not build, is
reported and skipped.  Each variant's largest error against the
plain versions is printed beside its times; one JSON line per variant and
turn goes to stdout and, with --out, to FILE.  TF32 is off throughout.
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
FILES = ("fused_head_f32.cu", "flash_ce_f32.cu", "ce_reduce.cuh", "tf32x3_wgmma.cuh",
         "head_wgmma.cuh")
CE_STAGES = "constexpr int kFwdStages = 4;"
CE_LOADS = """        mbar_expect_tx(&full[slot], kSlot);
        tma_load_2d(dst, &wmap, &full[slot], kk, tile * kCols);
        tma_load_2d(dst + kBox, &himap, &full[slot], kk, row0);
        tma_load_2d(dst + 2 * kBox, &lomap, &full[slot], kk, row0);"""
CE_LO_ONCE = """        mbar_expect_tx(&full[slot], s < kStages ? kSlot : 2 * kBox);
        tma_load_2d(dst, &wmap, &full[slot], kk, tile * kCols);
        tma_load_2d(dst + kBox, &himap, &full[slot], kk, row0);
        if (s < kStages) tma_load_2d(dst + 2 * kBox, &lomap, &full[slot], kk, row0);"""
CE_FOLD = """    } else if (full_tile) {
      fold_tile<true>(acc, b, ok, lane, rm, rs, rz);
    } else {
      fold_tile<false>(acc, b, ok, lane, rm, rs, rz);
    }"""
CE_FOLD_OFF = """    } else {
#pragma unroll
      for (int x = 0; x < 64; ++x) rz[x & 3] += acc[x];
    }"""
CE_TABLE_ONLY = """        mbar_expect_tx(&full[slot], s < kStages ? kSlot : kBox);
        tma_load_2d(dst, &wmap, &full[slot], kk, tile * kCols);
        if (s < kStages) {
          tma_load_2d(dst + kBox, &himap, &full[slot], kk, row0);
          tma_load_2d(dst + 2 * kBox, &lomap, &full[slot], kk, row0);
        }"""
HEAD_SPLIT = """  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));"""
HEAD_ROUND = """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));"""

VARIANTS = {
    "base": [],
    "head_round": [("tf32x3_wgmma.cuh", HEAD_SPLIT, HEAD_ROUND)],
    "ce_stages3": [("flash_ce_f32.cu", CE_STAGES, "constexpr int kFwdStages = 3;")],
    "ce_table_only": [("flash_ce_f32.cu", CE_LOADS, CE_TABLE_ONLY)],
    "ce_fold_off": [("flash_ce_f32.cu", CE_FOLD, CE_FOLD_OFF)],
    "ce_lo_once": [("flash_ce_f32.cu", CE_LOADS, CE_LO_ONCE)],
}
ENTRIES = ("mic_fused_head_bucket_f32", "mic_flash_ce_fwd_f32", "mic_flash_ce_dl_f32")


def build(name, patches):
    """Start the variant's build -> (library path, nvcc process), or None
    where a patch does not apply."""
    from mic_tpu_torch import _build

    out = os.path.join("build", "variants", f"f32_{name}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for f in FILES:
        shutil.copy(os.path.join(SOURCE, f), out)
    for f, old, new in patches:
        path = os.path.join(out, f)
        with open(path) as fh:
            text = fh.read()
        if old not in text:
            print(f"variant {name}: patch no longer applies to {f}: {old!r}", flush=True)
            return None
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    lib = os.path.join(out, "lib.so")
    cmd = [_build._nvcc(), *_build._FLAGS, "-Xptxas", "-v", "-shared", "-o", lib,
           os.path.join(out, "fused_head_f32.cu"), os.path.join(out, "flash_ce_f32.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(name, started):
    """Wait for a build started by ``build`` -> the library path or None."""
    if started is None:
        return None
    lib, proc = started
    _, stderr = proc.communicate()
    if proc.returncode:
        print(f"variant {name}: nvcc failed, skipped\n{stderr[-2000:]}", flush=True)
        return None
    regs = [line.split("info    :")[-1].strip() for line in stderr.splitlines()
            if "registers" in line]
    print(f"variant {name}: ptxas {regs}", flush=True)
    return lib


def load(lib_path):
    from mic_tpu_torch import _build

    lib = ctypes.CDLL(lib_path)
    for entry in ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return lib


def inputs(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    v, d = 250054, 1024
    weight = torch.randn((v, d), generator=g, device=dev) * 0.02
    bias = torch.randn((v,), generator=g, device=dev) * 0.1
    hidden = {n: torch.randn((n, d), generator=g, device=dev) for n in (4, 1024, 4096)}
    labels = torch.randint(0, v, (4096,), generator=g, device=dev, dtype=torch.int32)
    return weight, bias, hidden, labels


def run(dev, data, plain):
    from mic_tpu_torch.ops.flash_ce import flash_ce_dl, flash_ce_forward
    from mic_tpu_torch.ops.fused_head import fused_head_topk

    weight, bias, hidden, labels = data
    h = hidden[4096]
    lse = plain["lse"]
    rs = torch.full((4096,), 1 / 4096, device=dev)
    lp = fused_head_topk(hidden[1024], weight, bias, 9)[0]
    fwd = flash_ce_forward(h, weight, bias, labels)[0]
    dl = flash_ce_dl(h, weight, bias, labels, lse, rs, 0.1)[0]
    err = {"head_lp": (lp - plain["lp"]).abs().max().item(),
           "ce_lse": (fwd - lse).abs().max().item(),
           "dl": (dl - plain["dl"]).abs().max().item()}
    del dl
    torch.cuda.empty_cache()
    ms = {"head_n1024": graph_ms(lambda: fused_head_topk(hidden[1024], weight, bias, 9), 3, 5),
          "head_n4": graph_ms(lambda: fused_head_topk(hidden[4], weight, bias, 9), 3, 5),
          "ce_fwd": graph_ms(lambda: flash_ce_forward(h, weight, bias, labels), 2, 3),
          "ce_dl": graph_ms(lambda: flash_ce_dl(h, weight, bias, labels, lse, rs, 0.1), 2, 3)}
    torch.cuda.empty_cache()
    return ms, err


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*")
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_f32_variants.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mic_tpu_torch import _build
    from mic_tpu_torch.ops.flash_ce import flash_ce_dl_plain, flash_ce_forward_plain
    from mic_tpu_torch.ops.fused_head import fused_head_topk_plain

    dev = torch.device("cuda")
    names = args.names or list(VARIANTS)
    started = {name: build(name, VARIANTS[name]) for name in names}
    libs = {name: finish(name, started[name]) for name in names}
    data = inputs(dev)
    weight, bias, hidden, labels = data
    plain = {"lp": fused_head_topk_plain(hidden[1024], weight, bias, 9, "bucket")[0],
             "lse": flash_ce_forward_plain(hidden[4096], weight, bias, labels)[0]}
    plain["dl"] = flash_ce_dl_plain(hidden[4096], weight, bias, labels, plain["lse"],
                                    torch.full((4096,), 1 / 4096, device=dev), 0.1)[0]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out = open(args.out, "a") if args.out else None
    for turn in range(1, args.turns + 1):
        for name in names:
            if libs[name] is None:
                continue
            _build._lib = load(libs[name])
            ms, err = run(dev, data, plain)
            line = json.dumps({"variant": name, "turn": turn, "ms": ms, "max_abs_err": err,
                               "card": card})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
    _build._lib = None
    if out:
        out.close()


if __name__ == "__main__":
    main()

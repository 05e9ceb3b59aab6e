#!/usr/bin/env python3
"""Design variants of the top-k + logsumexp kernel (row 17): each a patched
copy of mic_tpu_torch/csrc/topk_lse.cu built under build/variants/ into its
own library, timed on one CUDA card at the greedy and beam shapes (N in
{4, 256, 1024}, k in {2, 9}, V=250054, bf16) in CUDA-graph replays.

Run from the root of a checkout of the port:

    python3 tools/torch_topk_variants.py [--turns 2] [--out FILE] [NAME ...]

with NAME a key of ``VARIANTS`` (all of them by default): ``base``, the
source as it is; ``vecs2`` and ``vecs8``, 2 or 8 16-byte loads a lane a
batch instead of 4 (1 or 4 KB a warp a batch); ``bounds3``, a launch bound
of 3 blocks an SM instead of 2 (at most 80 registers); ``merge_launch``,
the runs folded by a second launch, a warp a row, instead of by the last
run of each row to finish; ``no_cut``, no cut at the k-th largest of the
lanes' maxima while the list fills (every candidate offered);
``run_cols1024`` and ``run_cols2048``, the source as it is with the
wrapper's fewest columns a run (``ops/topk_lse.py::_RUN_COLS``) set that
low for the variant's turns (more runs where the rows are few, as at
N=4).  Each variant's ids are held equal to the plain version's and its
largest log-prob error is printed beside its times.  A variant whose patch
no longer applies is reported and skipped.  One JSON line per variant and
turn goes to stdout and, with --out, to FILE.
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

from chip_smoke import HEAD_V, graph_ms  # noqa: E402

SOURCE = "mic_tpu_torch/csrc"
ARRIVAL = """  __threadfence();  // this run's partials are visible before it counts itself in
  __syncwarp();
  unsigned prior = 0;
  if (lane == 0) prior = atomicAdd(arrivals + row, 1u);
  prior = __shfl_sync(kFull, prior, 0);
  if (prior != static_cast<unsigned>(runs - 1)) return;
  __threadfence();  // the last run in: every run's partials are visible
  fold_row(part_m, part_l, part_v, part_i, lp, ids, row, n, k, runs, lane);
  if (lane == 0) arrivals[row] = 0;
}
"""
FOLD_KERNEL = """}

__global__ void __launch_bounds__(kWarps * 32)
fold_kernel(const float* part_m, const float* part_l, const float* part_v,
            const int32_t* part_i, float* lp, int32_t* ids, int n, int k, int runs) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row < n) fold_row(part_m, part_l, part_v, part_i, lp, ids, row, n, k, runs, threadIdx.x & 31);
}
"""
LAUNCH_END = """      vocab, k, runs, run_cols);
  return static_cast<int>(cudaGetLastError());
"""
SECOND_LAUNCH = """      vocab, k, runs, run_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_kernel<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_v), static_cast<const int32_t*>(part_i),
      static_cast<float*>(lp), static_cast<int32_t*>(ids), n, k, runs);
  return static_cast<int>(cudaGetLastError());
"""
BOUNDS = "__launch_bounds__(kWarps * 32, 2)\ntopk_lse_kernel"
VECS = "constexpr int kVecs = 4;"

VARIANTS = {
    "base": [],
    "vecs2": [(VECS, "constexpr int kVecs = 2;")],
    "vecs8": [(VECS, "constexpr int kVecs = 8;")],
    "bounds3": [(BOUNDS, BOUNDS.replace("32, 2)", "32, 3)"))],
    "merge_launch": [(ARRIVAL, FOLD_KERNEL), (LAUNCH_END, SECOND_LAUNCH)],
    "no_cut": [("  float cut = __popc(voters) > k ? warp_kth(best, k, lane) : -INFINITY;",
                "  float cut = -INFINITY;"),
               ("    const float cut = __popc(voters) > k ? warp_kth(v, k, lane) : -INFINITY;",
                "    const float cut = -INFINITY;")],
    "run_cols1024": [],
    "run_cols2048": [],
}
RUN_COLS = {"run_cols1024": 1024, "run_cols2048": 2048}  # the wrapper's _RUN_COLS, set
CASES = ((4, 2), (256, 2), (256, 9), (1024, 2), (1024, 9))


def build(variants: dict) -> dict:
    """Patched copies of the sources, built all at once -> each variant's
    library path, or None where a patch does not apply or the build fails."""
    from mic_tpu_torch import _build

    procs = {}
    for name, patches in variants.items():
        folder = os.path.join("build", "variants", f"topk_{name}")
        shutil.rmtree(folder, ignore_errors=True)
        shutil.copytree(SOURCE, folder)
        path = os.path.join(folder, "topk_lse.cu")
        with open(path) as f:
            text = f.read()
        if any(old not in text for old, _ in patches):
            print(f"{name}: its patch does not apply to topk_lse.cu; skipped", flush=True)
            continue
        for old, new in patches:
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(folder, "lib.so")
        cmd = [_build._nvcc(), *_build._FLAGS, "-shared", "-o", lib, path]
        procs[name] = (lib, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            print(f"{name}: the build failed; skipped\n{err[-2000:]}", flush=True)
        libs[name] = None if proc.returncode else lib
    return libs


def load(lib: str) -> None:
    """Make ``lib`` the library the wrappers call (its top-k entries only)."""
    from mic_tpu_torch import _build

    loaded = ctypes.CDLL(lib)
    for name, argtypes in _build._SIGNATURES.items():
        if name.startswith("mic_topk_lse"):
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
        raise SystemExit("torch_topk_variants.py needs a CUDA device")
    from mic_tpu_torch.ops import topk_lse
    from mic_tpu_torch.ops.topk_lse import topk_log_probs, topk_log_probs_plain

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(23)
    inputs = {n: (torch.randn((n, HEAD_V), generator=g, device=dev) * 2).bfloat16()
              for n in sorted({n for n, _ in CASES})}
    refs = {(n, k): topk_log_probs_plain(inputs[n], k) for n, k in CASES}
    libs = build({name: VARIANTS[name] for name in args.names})
    run_cols = topk_lse._RUN_COLS
    rows = []
    for turn in range(args.turns):
        for name, lib in libs.items():
            if lib is None:
                continue
            load(lib)
            topk_lse._RUN_COLS = RUN_COLS.get(name, run_cols)
            row = {"turn": turn, "variant": name, "card": card}
            for n, k in CASES:
                x = inputs[n]
                lp, ids = topk_log_probs(x, k)
                torch.cuda.synchronize()
                rlp, rids = refs[n, k]
                row[f"N={n} k={k} graph_ms"] = graph_ms(lambda: topk_log_probs(x, k))
                row[f"N={n} k={k} ids_equal"] = bool(torch.equal(ids, rids))
                row[f"N={n} k={k} max_abs_err"] = (lp - rlp).abs().max().item()
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Design variants of the dequantising GEMM (row 20): each a patched copy of
mic_tpu_torch/csrc/int8_matmul.cu built under build/variants/ into its own
library, timed on one CUDA card at K=1024 and (M, N) in {(1024, 3072),
(4, 3072), (4, 250054), (1024, 250054)} in CUDA-graph replays.

Run from the root of a checkout of the port:

    python3 tools/torch_int8_matmul_variants.py [--turns 2] [--out FILE] [NAME ...]

with NAME a key of ``VARIANTS`` (all of them by default).  ``base`` is the
source as it is.  Other designs: ``own_rows``, each loader copies its own
rows' words, in place of a warp's copies spanning four rows' spans;
``sleep``, the producers wait for a free slot by a test, then a sleep of
128 ns, in place of try_wait in a loop (as the consumers wait);
``exact_widen``, every weight widened by the longer form (an f32 add a
byte, then mul.rn.bf16x2) in place of widen_scaled in the 8- and 64-row
instances.  Phases taken out, to bound what each costs (their outputs are
wrong, and not checked): ``no_loads``, no weight word is loaded (the
producer realigns and stores stale words); ``no_x``, no x box is brought;
``bare``, neither; ``bare_no_realign``, bare and the loaders store zeros
without reading their raw rows; ``bare_arrive_only``, bare and the loaders
only arrive; ``no_widen``, the loaded bytes go to the products as they are
(no widening, no scales); ``skeleton``, bare, the loaders only arriving
and no widening (the consumers' ldmatrix, products, barriers and stores
alone); ``no_stores``, no output is written (the products stay: a store is
kept behind a test of the sums).  The producer's phases are those of the
cp.async path (N % 16 != 0, as the head's N = 250054): at N = 3072 (TMA)
only ``no_widen``, ``no_stores`` and ``exact_widen`` change anything.  A
phase taken out can leave stale bits in shared memory, and products on
such bits measured slower (likely their power): read those variants as
bounds, not as costs.  Each variant's largest error against the plain
version is printed beside its times (``CHECKED``: the variants that
compute the function).  A variant whose patch no longer applies is
reported and skipped.  One JSON line per variant and turn goes to stdout
and, with --out, to FILE.
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

from chip_smoke import HEAD_D, HEAD_V, graph_ms  # noqa: E402

SOURCE = "mic_tpu_torch/csrc"
NO_LOADS = [("    cp_async16(dst, reinterpret_cast<const void*>(src < end ? src : first), "
             "src < end ? 16u : 0u);", "    if (dst == nullptr) cp_async16(dst, &end, 0u);")]
NO_REALIGN = [("      for (int i = 0; i < 33; ++i) v[i] = words[i];",
               "      for (int i = 0; i < 33; ++i) v[i] = 0u;"),
              ("      const bool live = x.s * kDepth + row < k;", "      const bool live = false;")]
ARRIVE_ONLY = [("""    for (int j = 0; j < kDepth / kLoaders; ++j) {
      const int row = r + kLoaders * j;""", """    for (int j = 0; j < 0; ++j) {
      const int row = r + kLoaders * j;""")]
NO_WIDEN = [("""        if (sc.fast) {
          widen_scaled(raw[2 * kk + h], sc, p0, p1);""", """        if (sc.fast) {
          p0 = p1 = raw[2 * kk + h];""")]
NO_X = [("""      mbar_expect_tx(&full[stage], x_bytes<kRows, false>());
#pragma unroll
      for (int b = 0; b < kDepth / 64; ++b) {
        tma_load_2d(slot + b * kRows * 128, xmap, &full[stage], x.s * kDepth + 64 * b, x.at.m0);
      }
""", "      mbar_arrive(&full[stage]);\n")]
# each loader copying its own rows whole (9 words a row, a warp's copy
# spanning 32 rows), in place of a warp's copy spanning four rows' spans
OWN_ROWS = [("""      for (int q = 0; q < 8; ++q) {
        const int row = 32 * wl + 4 * q + (lane >> 3);
        if (x.item < items && k0 + row < k) {
          copy(slab + row * kRaw + 16 * (lane & 7), base + off0 + q * step, lane & 7);
        }
      }
      if (x.item < items && k0 + r < k) copy(slab + r * kRaw + 128, base + off8, 8);""",
             """      for (int q = 0; q < 9; ++q) {
        if (x.item < items && k0 + r < k) copy(slab + r * kRaw + 16 * q, base + off8, q);
      }""")]
# a producer's wait for a free slot: a test, then a sleep of 128 ns
SLEEP = """// A producer's wait for a slot to be freed: one test at a time, asleep in
// between, so that a producer far ahead takes no issue slots from the
// consumers sharing its SM sub-partition.
__device__ __forceinline__ void wait_free(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\\n"
        ".reg .pred p;\\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
        "selp.u32 %0, 1, 0, p;\\n"
        "}\\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    __nanosleep(128);
  }
}

"""
VARIANTS = {
    "base": [],
    "own_rows": OWN_ROWS,
    "sleep": [("__device__ __forceinline__ void cp_async16(", SLEEP + "__device__ __forceinline__ void cp_async16("),
              ("mbar_wait(&empty[stage]", "wait_free(&empty[stage]")],
    "exact_widen": [("    scale_forms.fast = kRows < 256 &&", "    scale_forms.fast = false &&")],
    "no_loads": NO_LOADS,
    "no_x": NO_X,
    "bare": NO_LOADS + NO_X,
    "bare_no_realign": NO_LOADS + NO_X + NO_REALIGN,
    "bare_arrive_only": NO_LOADS + NO_X + ARRIVE_ONLY,
    "no_widen": NO_WIDEN,
    "skeleton": NO_LOADS + NO_X + ARRIVE_ONLY + NO_WIDEN,
    "no_stores": [("        if (row < m) store_pair(",
                   "        if (row < m && acc[4 * i + e] == 1234.5f) store_pair(")],
}
CHECKED = ("base", "own_rows", "sleep", "exact_widen")
SHAPES = ((1024, 3 * HEAD_D), (4, 3 * HEAD_D), (4, HEAD_V), (1024, HEAD_V))


def build(variants: dict) -> dict:
    """Patched copies of the sources, built all at once -> each variant's
    library path, or None where a patch does not apply or the build fails."""
    from mic_tpu_torch import _build

    procs = {}
    for name, patches in variants.items():
        folder = os.path.join("build", "variants", f"int8_matmul_{name}")
        shutil.rmtree(folder, ignore_errors=True)
        shutil.copytree(SOURCE, folder)
        path = os.path.join(folder, "int8_matmul.cu")
        with open(path) as f:
            text = f.read()
        if any(old not in text for old, _ in patches):
            print(f"{name}: its patch does not apply to int8_matmul.cu; skipped", flush=True)
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
    """Make ``lib`` the library the wrapper calls (its int8_matmul entry only)."""
    from mic_tpu_torch import _build

    loaded = ctypes.CDLL(lib)
    fn = loaded.mic_int8_matmul_bf16
    fn.argtypes = _build._SIGNATURES["mic_int8_matmul_bf16"]
    fn.restype = ctypes.c_int
    _build._lib = loaded


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--out", default=None)
    parser.add_argument("names", nargs="*", default=list(VARIANTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_int8_matmul_variants.py needs a CUDA device")
    from mic_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(37)
    weights = {}
    for n in sorted({n for _, n in SHAPES}):
        w_q = torch.randint(-127, 128, (HEAD_D, n), generator=g, device=dev, dtype=torch.int8)
        weights[n] = (w_q, torch.rand((n,), generator=g, device=dev) * 0.09 + 0.01)
    inputs = {(m, n): ((torch.randn((m, HEAD_D), generator=g, device=dev) * 0.3).bfloat16(),
                       *weights[n]) for m, n in SHAPES}
    refs = {key: int8_matmul_plain(*args) for key, args in inputs.items()}
    libs = build({name: VARIANTS[name] for name in args.names})
    rows = []
    for turn in range(args.turns):
        for name, lib in libs.items():
            if lib is None:
                continue
            load(lib)
            row = {"turn": turn, "variant": name, "card": card}
            for (m, n), operands in inputs.items():
                out = int8_matmul(*operands)
                torch.cuda.synchronize()
                row[f"M={m} N={n} graph_ms"] = graph_ms(lambda: int8_matmul(*operands))
                if name in CHECKED:
                    err = (out.float() - refs[m, n].float()).abs().max().item()
                    row[f"M={m} N={n} max_abs_err"] = err
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()

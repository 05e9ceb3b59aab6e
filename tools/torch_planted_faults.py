#!/usr/bin/env python3
"""Planted faults: show that the checks of the cross-attention kernel
(rows 13 and 14), of the bf16 bucket head's ring (row 4), of the small-T
bf16 backward (row 12), of the top-k + logsumexp (row 17) and of the
dequantising GEMM (row 20) can fail.  Each
fault is a copy of the checkout under build/planted/ with one source edit,
built on the card; the checks meant to catch it run in that copy, and each
prints CAUGHT (it failed) or "not caught" (it passed).

Run from the root of a checkout of the port, on a machine with a CUDA card:

    python3 tools/torch_planted_faults.py [NAME ...]

with NAME a key of ``FAULTS`` (all of them by default).  The checks:
chip_smoke.py's phases 24, 39 and 40 and the CUDA tests ``-k cross`` for
the cross-attention faults; phase 48 (its SASS check, and its reruns alone),
phase 3 and the CUDA tests ``-k fused_head_bucket`` for the ring's; phase
35 and the CUDA tests ``-k small_attention`` for the backward's; phase 19
and the CUDA tests ``-k topk`` for the top-k's; phase 42 and the CUDA tests
``-k int8_matmul`` for the GEMM's.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

CROSS = "mic_tpu_torch/csrc/attend_rows.cuh"
HEAD = "mic_tpu_torch/csrc/fused_head.cu"
SMALL = "mic_tpu_torch/csrc/small_attention.cu"
TOPK = "mic_tpu_torch/csrc/topk_lse.cu"
MATMUL = "mic_tpu_torch/csrc/int8_matmul.cu"
MUL_RN = '  asm("mul.rn.bf16x2 %0, %1, %2;\\n" : "=r"(d) : "r"(a), "r"(b));'
EXACT_FORM = "    scale_forms.fast = kRows < 256 &&"
STORE = "        if (row < m) store_pair(out, n, row, col, acc[4 * i + e], acc[4 * i + 2 + e]);"
DS_HI_LO = "    mm::p_fragments(dp, dsa);  // dS as bf16 hi + lo\n"
P_LOADS = ("      uint32_t ap[4], hi[4], lo[4];\n"
           "      mm::load_transposed(ap, sv, warp * 16, 16 * kk);\n")
DV_MMA = "        mm::mma_bf16(gv[2 * pair + 1], ap, bd[2], bd[3]);\n"
RELEASED_AFTER = ("        wgmma_commit();\n        wgmma_wait<0>();\n#pragma unroll\n"
                  "        for (int x = 0; x < 32; ++x) fence_operand(acc[x]);\n"
                  "        release(empty, slot);\n      }\n      advance();")
RELEASED_BEFORE = ("        wgmma_commit();\n        release(empty, slot);\n"
                   "        wgmma_wait<0>();\n#pragma unroll\n"
                   "        for (int x = 0; x < 32; ++x) fence_operand(acc[x]);\n"
                   "      }\n      advance();")
W_ROW = ("      const float* w = scores + min(m0 + g8, beams - 1) * ss + c0 + 2 * c;\n"
         "      const int w8 = (min(m0 + g8 + 8, beams - 1) - min(m0 + g8, beams - 1)) * ss;")
FAULTS = {
    "last live row dropped from the V product": (CROSS, [(
        "      if (t < positions) {\n        w = __fdiv_rn(s[t], l);",
        "      if (t < positions - 1) {\n        w = __fdiv_rn(s[t], l);")]),
    "the row at real_s read": (CROSS, [(
        "      const bool live = c0 + r < positions;",
        "      const bool live = c0 + r <= positions;")]),
    "a 16-beam tile's weights taken from the first tile's": (CROSS, [(
        W_ROW, W_ROW.replace("m0 + g8", "g8"))]),
    "a tile's beams 8-15 given beams 0-7's weights": (CROSS, [(
        "      const int w8 = (", "      const int w8 = 0 * (")]),
    "bf16 bucket slot freed before its products retire": (HEAD, [
        (RELEASED_AFTER, RELEASED_BEFORE)]),
    "dS rounded once to bf16": (SMALL, [(
        DS_HI_LO, DS_HI_LO + "    for (int kk = 0; kk < 4; ++kk) {\n"
        "      for (int i = 0; i < 4; ++i) dsa[1][kk][i] = 0u;\n    }\n")]),
    # p's hi + lo into dv: a sixth tile (dynamic shared memory) holds p's lo
    "dv from the f32 p instead of round(p)": (SMALL, [
        ("uint32_t pa[1][4][4] = {}, dsa", "uint32_t pa[2][4][4] = {}, dsa"),
        ("__shared__ __align__(128) unsigned char smem[5 * kTile];",
         "extern __shared__ __align__(128) unsigned char smem_dyn[];\n"
         "  unsigned char* smem = smem_dyn;"),
        ("  small_attention_bwd_bf16_kernel<<<batch * heads, attn_mma::kThreads, 0,",
         "  cudaFuncSetAttribute(small_attention_bwd_bf16_kernel,\n"
         "                       cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         "                       6 * attn_mma::kTileBytes);\n"
         "  small_attention_bwd_bf16_kernel<<<batch * heads, attn_mma::kThreads,\n"
         "                                    6 * attn_mma::kTileBytes,"),
        ("  mm::put_fragments(smem + 4 * kTile, dsa[1]);\n",
         "  mm::put_fragments(smem + 4 * kTile, dsa[1]);\n"
         "  mm::put_fragments(smem + 5 * kTile, pa[1]);\n"),
        (P_LOADS, P_LOADS + "      uint32_t ap2[4];\n"
         "      mm::load_transposed(ap2, sx + kTile, warp * 16, 16 * kk);\n"),
        (DV_MMA, DV_MMA + "        mm::mma_bf16(gv[2 * pair], ap2, bd[0], bd[1]);\n"
         "        mm::mma_bf16(gv[2 * pair + 1], ap2, bd[2], bd[3]);\n")]),
    "a misaligned row's peeled head skipped": (TOPK, [(
        "    const bool valid = lane < head + tail;",
        "    const bool valid = lane >= head && lane < head + tail;")]),
    "a candidate equal to the threshold with a lower id dropped": (TOPK, [
        ("    any |= top[u] >= list.thr_v;", "    any |= top[u] > list.thr_v;"),
        ("    if (__any_sync(kFull, top[u] >= cut)) {", "    if (__any_sync(kFull, top[u] > cut)) {")]),
    # the weights widened unscaled, each output scaled after its sum (the
    # cheaper function the reference is not)
    "the scale applied after the sum": (MATMUL, [
        ("          widen_scaled(raw[2 * kk + h], sc, p0, p1);",
         "          widen(raw[2 * kk + h], p0, p1);"),
        ("          p0 = mul_bf16x2(p0, sc.s[0]);\n          p1 = mul_bf16x2(p1, sc.s[1]);\n", ""),
        (STORE, STORE.replace("acc[4 * i + e], acc[4 * i + 2 + e]",
                              "acc[4 * i + e] * __uint_as_float(scale_forms.s[0] << 16),\n"
                              "                               acc[4 * i + 2 + e] * "
                              "__uint_as_float(scale_forms.s[1] << 16)"))]),
    # every weight by the longer form, its product with the scale truncated
    "the weight truncated instead of rounded": (MATMUL, [
        (EXACT_FORM, "    scale_forms.fast = false &&"),
        (MUL_RN, "  d = __byte_perm(__float_as_uint(__uint_as_float(a << 16) * "
                 "__uint_as_float(b << 16)),\n"
                 "                  __float_as_uint(__uint_as_float(a & 0xffff0000u) * "
                 "__uint_as_float(b & 0xffff0000u)), 0x7632);")]),
    "one depth split left out of the sum": (MATMUL, [(
        "            if (z0 + q < splits) {\n              v = z0 + q == 0",
        "            if (z0 + q < splits - 1) {\n              v = z0 + q == 0")]),
    "a realign off by one byte on an unaligned row": (MATMUL, [(
        "      const uint32_t sh = 8u * (o & 3);",
        "      const uint32_t sh = 8u * ((o + (o != 0)) & 3);")]),
    "one run's partial left out of the fold": (TOPK, [
        ("  for (int z = lane; z < runs; z += 32) {", "  for (int z = lane; z < runs - 1; z += 32) {"),
        ("  const int entries = runs * k;", "  const int entries = (runs - 1) * k;")]),
}


def phase(call: str) -> str:
    return f"import chip_smoke as c, torch; {call}"


CROSS_CHECKS = [
    ("phase 24", phase("c.check_cross_attention(torch.device('cuda'))")),
    ("phase 39", phase("c.check_cross_attention_dma(torch.device('cuda'))")),
    ("phase 40", phase("c.check_cross_attention_q8(torch.device('cuda'))")),
    ("CUDA tests -k cross", None),
]
SLOT = ("from mic_tpu_torch import _build; "
        "c.check_bucket_slot_release(torch.device('cuda'), _build.build())")
HEAD_CHECKS = [
    ("phase 48", phase(SLOT)),
    ("phase 48's reruns alone", phase("c.sass_release_faults = lambda *a: ([], 1); " + SLOT)),
    ("phase 3", phase("c.check_fused_head(torch.device('cuda'))")),
    ("CUDA tests -k fused_head_bucket", None),
]
CHECKS = {
    CROSS: CROSS_CHECKS,
    HEAD: HEAD_CHECKS,
    SMALL: [("phase 35", phase("c.check_attention_kernels(torch.device('cuda'))")),
            ("CUDA tests -k small_attention", None)],
    TOPK: [("phase 19", phase("c.check_topk_lse(torch.device('cuda'))")),
           ("CUDA tests -k topk", None)],
    MATMUL: [("phase 42", phase("c.check_int8_matmul(torch.device('cuda'))")),
             ("CUDA tests -k int8_matmul", None)],
}


def main() -> None:
    root = os.getcwd()
    names = sys.argv[1:] or list(FAULTS)
    for name in names:
        path, patches = FAULTS[name]
        copy = os.path.join(root, "build", "planted", str(list(FAULTS).index(name)))
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(root, copy, ignore=shutil.ignore_patterns("build", ".git"))
        with open(os.path.join(copy, path)) as f:
            text = f.read()
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"{name}: the edit does not apply to {path}")
            text = text.replace(old, new)
        with open(os.path.join(copy, path), "w") as f:
            f.write(text)
        env = dict(os.environ, PYTHONPATH=copy)
        built = subprocess.run([sys.executable, "-c",
                                "from mic_tpu_torch import _build; _build.lib()"],
                               cwd=copy, env=env, capture_output=True, text=True)
        if built.returncode != 0:
            print(f"[{name}] the build failed; no check ran\n{built.stderr[-1500:]}", flush=True)
            shutil.rmtree(copy, ignore_errors=True)
            continue
        for label, code in CHECKS[path]:
            if code is None:
                cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                       "-q", "tests/test_torch_cuda_kernels.py", "-k", label.split("-k ")[1]]
            else:
                cmd = [sys.executable, "-c", code]
            done = subprocess.run(cmd, cwd=copy, env=env, capture_output=True, text=True,
                                  timeout=900)
            last = ((done.stdout + done.stderr).strip().splitlines() or [""])[-1]
            verdict = "CAUGHT" if done.returncode != 0 else "not caught"
            print(f"[{name}] {label}: {verdict}; {last[:200]}", flush=True)
        shutil.rmtree(copy, ignore_errors=True)


if __name__ == "__main__":
    main()

"""Build and load the port's CUDA kernels (``csrc/*.cu``, with the shared
headers ``csrc/*.cuh`` they include).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library under ``build/mic_tpu_torch/`` at the repository root, at
first use, and loaded with ``ctypes``: each kernel has a plain C entry point
that takes raw pointers, sizes and the CUDA stream, launches on that stream
and returns ``cudaGetLastError()``.  The library name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_BUILD_DIR = _PKG.parent / "build" / "mic_tpu_torch"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes; every entry point returns a cudaError_t as int
_SIGNATURES = {
    # q, cache_k, cache_v, k_step, v_step, ancestry, out,
    # batch, beams, t_max, heads, head_dim, index, stream
    "mic_lazy_attention_bf16": [_P] * 7 + [_I] * 6 + [_P],
    "mic_lazy_attention_f32": [_P] * 7 + [_I] * 6 + [_P],
    # q, cache_k, k_scale, cache_v, v_scale, k_step, v_step, ancestry, out,
    # batch, beams, t_max, heads, head_dim, index, group, groups, stream
    "mic_lazy_attention_q8": [_P] * 9 + [_I] * 8 + [_P],
    "mic_lazy_attention_q8_f32": [_P] * 9 + [_I] * 8 + [_P],
    # hidden, weight, bias, l_out, rmax_out, rid_out, l_part, rmax_part,
    # rid_part, n, d, vocab, buckets, splits, stream
    "mic_fused_head_bucket_bf16": [_P] * 9 + [_I] * 5 + [_P],
    # hidden, weight, bias, hsplit, l_out, rmax_out, rid_out (each (splits, n,
    # buckets)), n, d, vocab, buckets, splits, route, stream
    "mic_fused_head_bucket_f32": [_P] * 7 + [_I] * 6 + [_P],
    # hidden, weight_q, wscale, bias, l_out, rmax_out, rid_out, l_part,
    # rmax_part, rid_part, n, d, vocab, buckets, splits, stream
    "mic_fused_head_bucket_q8": [_P] * 10 + [_I] * 5 + [_P],
    # hidden, weight, bias, row_floor, part_m, part_l, part_v, part_i, lp,
    # ids, lse, n, d, vocab, k, runs, window, stream
    "mic_fused_head_select_bf16": [_P] * 11 + [_I] * 6 + [_P],
    # hidden, weight, bias, xsplit, row_floor, part_m, part_l, part_v, part_i,
    # lp, ids, lse, n, d, vocab, k, runs, window, stream
    "mic_fused_head_select_f32": [_P] * 12 + [_I] * 6 + [_P],
    # xq, xs, weight_q, wscale, bias, row_floor, part_m, part_l, part_v,
    # part_i, lp, ids, lse, n, d, vocab, k, runs, window, stream
    "mic_fused_head_select_q8": [_P] * 13 + [_I] * 6 + [_P],
    # hidden, weight, bias, part_m, part_s, part_z, lse_out, zsum_out,
    # n, d, vocab, runs, stream
    "mic_flash_ce_fwd_bf16": [_P] * 8 + [_I] * 4 + [_P],
    # the same, then logits_main, tail, n, d, vocab, v_main, runs, stream
    "mic_flash_ce_fwd_save_bf16": [_P] * 10 + [_I] * 5 + [_P],
    # hidden, weight, bias, hsplit, part_m, part_s, part_z, lse_out,
    # zsum_out, n, d, vocab, runs, stream
    "mic_flash_ce_fwd_f32": [_P] * 9 + [_I] * 4 + [_P],
    # the same, then logits_main, tail, n, d, vocab, v_main, runs, stream
    "mic_flash_ce_fwd_save_f32": [_P] * 11 + [_I] * 5 + [_P],
    # hidden, weight, bias, labels, lse, rowscale, dl_out, band_part,
    # dbias_out, low, conf - low, n, d, vocab, runs, stream
    "mic_flash_ce_dl_bf16": [_P] * 9 + [_F] * 2 + [_I] * 4 + [_P],
    # the same with hsplit after bias
    "mic_flash_ce_dl_f32": [_P] * 10 + [_F] * 2 + [_I] * 4 + [_P],
    # hidden (or NULL), weight, bias, hsplit, labels, lse, rowscale, dl,
    # band_part, dbias, low, conf - low, n, d, vocab, ld, label_base, runs, stream
    "mic_flash_ce_dl_chunk_f32": [_P] * 10 + [_F] * 2 + [_I] * 6 + [_P],
    # src, saved, ld, b, lse, rowscale, labels, out, part, dbias, low,
    # conf - low, n, d, vext, grad_w, accumulate, splits, stream
    "mic_flash_ce_contract_f32": [_P, _I, _I] + [_P] * 7 + [_F] * 2 + [_I] * 6 + [_P],
    # hidden, weight, bias, logits, labels, lse, rowscale, demb_out,
    # dbias_out, low, conf - low, n, d, vext, saved, stream
    "mic_flash_ce_gw_bf16": [_P] * 9 + [_F] * 2 + [_I] * 4 + [_P],
    # hidden, weight, bias, logits, labels, lse, rowscale, dh_out, part,
    # low, conf - low, n, d, vext, saved, parts, stream
    "mic_flash_ce_gh_bf16": [_P] * 9 + [_F] * 2 + [_I] * 5 + [_P],
    # a, b, out, trans, stream
    "mic_flash_ce_operand_probe": [_P] * 3 + [_I, _P],
    # q, k_step, v_step, cache_k, cache_v, out,
    # layers, rows, t_max, heads, head_dim, layer, index, splits, stream
    "mic_decode_attention_bf16": [_P] * 6 + [_I] * 8 + [_P],
    "mic_decode_attention_f32": [_P] * 6 + [_I] * 8 + [_P],
    # logits, part_m, part_l, part_v, part_i, arrivals, lp, ids, n, vocab, k, max_runs,
    # stream
    "mic_topk_lse_bf16": [_P] * 8 + [_I] * 4 + [_P],
    "mic_topk_lse_f32": [_P] * 8 + [_I] * 4 + [_P],
    # q, cache_k, cache_v, k_step, v_step, amask, out,
    # batch, beams, t_max, positions, heads, head_dim, compact, stage, shared, stream
    "mic_lazy_attention_blocked_bf16": [_P] * 7 + [_I] * 9 + [_P],
    "mic_lazy_attention_blocked_f32": [_P] * 7 + [_I] * 9 + [_P],
    # q, cache_k, k_scale, cache_v, v_scale, k_step, v_step, amask, out,
    # batch, beams, t_max, positions, heads, head_dim, compact, stage, shared, stream
    "mic_lazy_attention_blocked_q8": [_P] * 9 + [_I] * 9 + [_P],
    "mic_lazy_attention_blocked_q8_f32": [_P] * 9 + [_I] * 9 + [_P],
    # q, enc_k, enc_v, out, batch, beams, enc_len, heads, head_dim, stream
    "mic_cross_attention_bf16": [_P] * 4 + [_I] * 5 + [_P],
    "mic_cross_attention_f32": [_P] * 4 + [_I] * 5 + [_P],
    # q, enc_k, k_scale, enc_v, v_scale, out, batch, beams, enc_len, heads, head_dim, stream
    "mic_cross_attention_q8": [_P] * 6 + [_I] * 5 + [_P],
    "mic_cross_attention_q8_f32": [_P] * 6 + [_I] * 5 + [_P],
    # q, enc_k, enc_v, out, batch, beams, s_pad, real_s, heads, head_dim, stream
    "mic_cross_attention_dma_bf16": [_P] * 4 + [_I] * 6 + [_P],
    "mic_cross_attention_dma_f32": [_P] * 4 + [_I] * 6 + [_P],
    # kv, idx, out, layers, rows, beams, row_elems, elem_bytes, stream
    "mic_beam_permute": [_P] * 3 + [_I] * 3 + [ctypes.c_longlong, _I, _P],
    # x, w_q, scale, out, part, arrivals, m, kx, k, n, rows, splits, blocks, stream
    "mic_int8_matmul_bf16": [_P] * 6 + [_I] * 7 + [_P],
    # rows, tma -> the instance's dynamic shared memory in bytes
    "mic_int8_matmul_shared_bytes": [_I, _I],
    # x, scale, shift, w, bias, part, out, n, d, o, eps, splits, stream
    "mic_ln_gemm_bf16": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
    # x, scale, shift, w, bias, stats, part, out, n, d, o, eps, splits, stream
    "mic_ln_gemm_f32": [_P] * 8 + [_I] * 3 + [_F, _I, _P],
    # x, w1, b1, w2, b2, h, part, out, n, d, f, act, splits1, splits2, stream
    "mic_fused_mlp_bf16": [_P] * 8 + [_I] * 6 + [_P],
    "mic_fused_mlp_f32": [_P] * 8 + [_I] * 6 + [_P],
    # q, k, v, bias (or NULL), out, batch, t, heads, head_dim, stream
    "mic_small_attention_fwd_bf16": [_P] * 5 + [_I] * 4 + [_P],
    "mic_small_attention_fwd_f32": [_P] * 5 + [_I] * 4 + [_P],
    # q, k, v, bias (or NULL), dout, dq, dk, dv, batch, t, heads, head_dim, stream
    "mic_small_attention_bwd_bf16": [_P] * 8 + [_I] * 4 + [_P],
    "mic_small_attention_bwd_f32": [_P] * 8 + [_I] * 4 + [_P],
    # q, k, v, bias (or NULL), out, batch, tq, tk, heads, head_dim, stream
    "mic_flash_attention_fwd_bf16": [_P] * 5 + [_I] * 5 + [_P],
    "mic_flash_attention_fwd_f32": [_P] * 5 + [_I] * 5 + [_P],
}

_lib = None
_ARRIVALS: dict = {}  # (device index, stream) -> int32 counters, zero between launches


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def build() -> Path:
    """Compile csrc/*.cu into the build directory unless an up-to-date
    library is there already; returns the library path."""
    sources = sorted((_PKG / "csrc").glob("*.cu"))
    headers = sorted((_PKG / "csrc").glob("*.cuh"))
    digest = hashlib.sha256()
    for src in sources + headers:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    lib_path = _BUILD_DIR / f"libmic_tpu_torch_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    # one nvcc per source, all at once, then one link
    nvcc = _nvcc()
    objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    compiles = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in ([nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objects))
    ]
    steps = [(cmd, proc.communicate()[1], proc.returncode) for cmd, proc in compiles]
    if all(rc == 0 for _, _, rc in steps):
        link = [nvcc, *_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
        done = subprocess.run(link, capture_output=True, text=True)
        steps.append((link, done.stderr, done.returncode))
    for obj in objects:
        obj.unlink(missing_ok=True)
    for cmd, stderr, rc in steps:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = loaded
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")


def check_operands(name: str, tensors) -> None:
    """Raise unless every tensor is contiguous, 16-byte aligned and on the
    first one's device: what the C entry points take."""
    device = tensors[0].device
    for x in tensors:
        if x.device != device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous, 16-byte aligned and on one "
                             "device")


def arrivals(device, stream: int, n: int):
    """At least ``n`` arrival counters for a kernel launched on ``stream``
    that counts its blocks in and leaves every counter 0 again (the top-k
    + logsumexp's rows, the dequant GEMM's tiles): one set a stream, kept
    from launch to launch, so that launches on two streams never share one.
    The first launch at a size allocates them, so that launch must not be
    captured in a CUDA graph (a warm-up call before the capture makes
    them)."""
    import torch

    key = (device.index, stream)
    counters = _ARRIVALS.get(key)
    if counters is None or counters.numel() < n:
        counters = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _ARRIVALS[key] = counters
    return counters

"""Decode-step self-attention on the physical cache: the CUDA kernel and its
plain version.

Counterpart of mic_tpu/ops/decode_attention.py::decode_attention
(MIC_TPU_EXPERIMENTAL=fused_decode).  The stacked (L, N, T, H, Dh) self K/V
of nn/cache.py::DecoderCache gain the step's K/V at [layer, :, index] IN
PLACE, and the step attends over positions 0..index with an f32 softmax.
The layer and the index are host ints (launch arguments on CUDA).

The wrapper takes the plain version for tensors on the CPU and its kernel
(csrc/decode_attention.cu) for tensors on a CUDA device; it never falls
back from one to the other.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build

# masked scores (mic_tpu/ops/decode_attention.py NEG_INF)
NEG_INF = -1e30
_ENTRIES = {torch.bfloat16: "mic_decode_attention_bf16", torch.float32: "mic_decode_attention_f32"}


def decode_attention_plain(q, k_step, v_step, cache_k, cache_v, layer: int,
                           index: int) -> torch.Tensor:
    """mic_tpu's off-TPU branch: write the column, then f32 scores from the
    f32-cast q and K over all T positions, -1e30 beyond ``index``, softmax,
    the f32 weighted V sum, cast to q's dtype.

    q, k_step, v_step (N, 1, H, Dh), q already scaled by Dh**-0.5; caches
    (L, N, T, H, Dh) -> (N, 1, H, Dh); the caches gain column ``index`` of
    layer ``layer``."""
    cache_k[layer, :, index] = k_step[:, 0]
    cache_v[layer, :, index] = v_step[:, 0]
    kl, vl = cache_k[layer], cache_v[layer]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kl.float())
    valid = torch.arange(kl.shape[1], device=q.device) <= index
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vl.float())
    return out.to(q.dtype)


def decode_attention(q, k_step, v_step, cache_k, cache_v, layer: int,
                     index: int) -> torch.Tensor:
    """One layer's decode attention at write position ``index``:
    -> (N, 1, H, Dh); the caches gain column ``index`` of layer ``layer``."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_step, v_step, cache_k, cache_v, layer, index)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    layers, n, t, heads, dh = cache_k.shape
    entry = _ENTRIES.get(q.dtype)
    tensors = (q, k_step, v_step, cache_k, cache_v)
    if entry is None or any(x.dtype != q.dtype for x in tensors):
        raise TypeError("decode_attention kernel: q, step rows and caches must all be "
                        "bfloat16 or all float32")
    if dh != 64:
        raise ValueError(f"decode_attention kernel: head_dim must be 64, got {dh}")
    if not (0 <= layer < layers and 0 <= index < t):
        raise ValueError(f"decode_attention kernel: layer={layer}, index={index}, "
                         f"cache {tuple(cache_k.shape)}")
    if (q.shape != (n, 1, heads, dh) or k_step.shape != q.shape or v_step.shape != q.shape
            or cache_v.shape != cache_k.shape):
        raise ValueError("decode_attention kernel: inconsistent shapes")
    for x in tensors:
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("decode_attention kernel: tensors must be contiguous, "
                             "16-byte aligned and on one device")
    out = torch.empty_like(q)
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), k_step.data_ptr(), v_step.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), out.data_ptr(), layers, n, t, heads, dh, layer, index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, entry)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

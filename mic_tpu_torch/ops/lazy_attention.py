"""Lazy-beam decode self-attention: the CUDA kernel and its plain version.

Counterpart of mic_tpu/ops/lazy_attention.py::fused_lazy_attention_dma.  The
beam cache (nn/cache.py LazyDecoderCache) is never reordered; attention
scores every source row a query beam's ancestry names and the step's own
K/V row.  Both versions write the step K/V into column ``index`` of the
merged (B*K, T, H*Dh) caches IN PLACE and return only the attention output.

``lazy_attention`` takes the plain version for tensors on the CPU and the
kernel (csrc/lazy_attention.cu) for tensors on a CUDA device; it never
falls back from one to the other.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build

# mic_tpu/nn/attention.py masks scores with finfo(float32).min, never -inf
_MASK_VALUE = torch.finfo(torch.float32).min


def lazy_attention_plain(q, cache_k, cache_v, k_step, v_step, ancestry,
                         index: int, num_heads: int) -> torch.Tensor:
    """The ``attend`` of mic_tpu/nn/attention.py::mha_decode_step_lazy on the
    merged layout: write the step column, then attend over t <= index.

    q, k_step, v_step (B, K, H*Dh), q already scaled by Dh**-0.5; caches
    (B*K, T, H*Dh); ancestry (B, K, T) int32 -> (B, K, H*Dh) in q.dtype."""
    b, beams, hd = q.shape
    dh = hd // num_heads
    cache_k[:, index] = k_step.reshape(b * beams, hd)
    cache_v[:, index] = v_step.reshape(b * beams, hd)
    tb = index + 1
    kg = cache_k[:, :tb].reshape(b, beams, tb, num_heads, dh)
    vg = cache_v[:, :tb].reshape(b, beams, tb, num_heads, dh)
    q4 = q.reshape(b, beams, num_heads, dh)
    scores = torch.einsum("bkhd,bjthd->bhkjt", q4.float(), kg.float())
    src = torch.arange(beams, device=q.device, dtype=ancestry.dtype)
    sel = ancestry[:, :, :tb, None] == src                  # (B, K, tb, J)
    mask = sel.permute(0, 1, 3, 2)                          # (B, K, J, tb)
    scores = torch.where(mask[:, None], scores, _MASK_VALUE)
    w = torch.softmax(scores.reshape(b, num_heads, beams, beams * tb), dim=-1)
    w = w.reshape(b, num_heads, beams, beams, tb).to(q.dtype)
    out = torch.einsum("bhkjt,bjthd->bkhd", w, vg.to(q.dtype))
    return out.reshape(b, beams, hd)


def lazy_attention(q, cache_k, cache_v, k_step, v_step, ancestry,
                   index: int, num_heads: int) -> torch.Tensor:
    """One layer's lazy-beam decode attention at write position ``index``
    (a host int): -> (B, K, H*Dh); the caches gain column ``index``."""
    if q.device.type == "cpu":
        return lazy_attention_plain(
            q, cache_k, cache_v, k_step, v_step, ancestry, index, num_heads
        )
    if q.device.type != "cuda":
        raise ValueError(f"lazy_attention: unsupported device {q.device}")
    b, beams, hd = q.shape
    t = cache_k.shape[1]
    dh = hd // num_heads
    tensors = (q, cache_k, cache_v, k_step, v_step)
    if any(x.dtype != torch.bfloat16 for x in tensors):
        raise TypeError("lazy_attention kernel: q, caches and step rows must be bfloat16")
    if ancestry.dtype != torch.int32:
        raise TypeError("lazy_attention kernel: ancestry must be int32")
    if dh != 64 or hd != num_heads * dh:
        raise ValueError(f"lazy_attention kernel: head_dim must be 64, got {hd}/{num_heads}")
    if not 1 <= beams <= 32 or not 0 <= index < t:
        raise ValueError(f"lazy_attention kernel: beams={beams}, index={index}, T={t}")
    if (cache_k.shape != (b * beams, t, hd) or cache_v.shape != cache_k.shape
            or k_step.shape != q.shape or v_step.shape != q.shape
            or ancestry.shape != (b, beams, t)):
        raise ValueError("lazy_attention kernel: inconsistent shapes")
    for x in (*tensors, ancestry):
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("lazy_attention kernel: tensors must be contiguous, "
                             "16-byte aligned and on one device")
    out = torch.empty_like(q)
    lib = _build.lib()
    err = lib.mic_lazy_attention_bf16(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        k_step.data_ptr(), v_step.data_ptr(), ancestry.data_ptr(),
        out.data_ptr(), b, beams, t, num_heads, dh, index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "mic_lazy_attention_bf16")
    lazy_attention.launches += 1
    return out


lazy_attention.launches = 0

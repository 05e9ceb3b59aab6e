"""Lazy-beam decode self-attention: the CUDA kernel and its plain version.

Counterpart of mic_tpu/ops/lazy_attention.py::fused_lazy_attention_dma.  The
beam cache (nn/cache.py LazyDecoderCache) is never reordered; attention
scores every source row a query beam's ancestry names and the step's own
K/V row.  Both versions write the step K/V into column ``index`` of the
merged (B*K, T, H*Dh) caches IN PLACE and return only the attention output.

``lazy_attention_q8`` is the same on the int8 cache ({"q": int8 values,
"s": (B*K, T) f32 per-row scales}), following the TPU's _kernel_dma_q8:
the cached rows are read as int8 with their row scales on the scores and
the weights, and the step's own K/V row enters UNQUANTIZED (scale 1); the
step rows are quantized per merged row (ops/quant.py::quantize_rows_dynamic;
the kernel computes the same bits itself) only to be written into column
``index``.

Each wrapper takes the plain version for tensors on the CPU and its kernel
(csrc/lazy_attention.cu) for tensors on a CUDA device; it never falls back
from one to the other.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build
from mic_tpu_torch.ops.quant import quantize_rows_dynamic

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


def lazy_attention_q8_plain(q, cache_k, cache_v, k_step, v_step, ancestry,
                            index: int, num_heads: int) -> torch.Tensor:
    """mic_tpu's _kernel_dma_q8 math in q's dtype (at bfloat16, the TPU
    kernel's): scores over the pre-update int8 rows t < index the ancestry
    names, times their K row scales, plus each beam's unquantized step row;
    f32 softmax; the cached weights times their V row scales, then both
    weights rounded to q's dtype before the V product; f32 sums.  Then the
    quantized step rows and their scales go into column ``index``.

    q, k_step, v_step (B, K, H*Dh); cache_k/v {"q": (B*K, T, H*Dh) int8,
    "s": (B*K, T) f32}; ancestry (B, K, T) int32 -> (B, K, H*Dh) in q.dtype."""
    b, beams, hd = q.shape
    dh = hd // num_heads
    dt = q.dtype

    def rows(cache):  # the live prefix as (B, J, t, H, Dh) f32 and scales (B, J, t)
        vals = cache["q"][:, :index].to(dt).float()
        return (vals.reshape(b, beams, index, num_heads, dh),
                cache["s"][:, :index].reshape(b, beams, index))

    kg, ks = rows(cache_k)
    vg, vs = rows(cache_v)
    q4 = q.reshape(b, beams, num_heads, dh).float()
    ks4 = k_step.to(dt).reshape(b, beams, num_heads, dh).float()
    vs4 = v_step.to(dt).reshape(b, beams, num_heads, dh).float()
    scores = torch.einsum("bkhd,bjthd->bhkjt", q4, kg) * ks[:, None, None]
    src = torch.arange(beams, device=q.device, dtype=ancestry.dtype)
    mask = (ancestry[:, :, :index, None] == src).permute(0, 1, 3, 2)   # (B, K, J, t)
    scores = torch.where(mask[:, None], scores, _MASK_VALUE)
    s_step = torch.einsum("bkhd,bkhd->bhk", q4, ks4)
    w = torch.softmax(
        torch.cat([scores.reshape(b, num_heads, beams, beams * index), s_step[..., None]], -1),
        dim=-1,
    )
    w_cache = w[..., :-1].reshape(b, num_heads, beams, beams, index) * vs[:, None, None]
    w_cache = w_cache.to(dt).float()
    w_step = w[..., -1].to(dt).float()                                 # (B, H, K)
    out = torch.einsum("bhkjt,bjthd->bkhd", w_cache, vg)
    out = out + w_step.permute(0, 2, 1)[..., None] * vs4
    out = out.reshape(b, beams, hd).to(dt)

    bk = b * beams
    k8, ksc = quantize_rows_dynamic(k_step.reshape(bk, hd))
    v8, vsc = quantize_rows_dynamic(v_step.reshape(bk, hd))
    cache_k["q"][:, index] = k8
    cache_k["s"][:, index] = ksc[:, 0]
    cache_v["q"][:, index] = v8
    cache_v["s"][:, index] = vsc[:, 0]
    return out


def lazy_attention_q8(q, cache_k, cache_v, k_step, v_step, ancestry,
                      index: int, num_heads: int) -> torch.Tensor:
    """One layer's lazy-beam decode attention on the int8 cache at write
    position ``index``: -> (B, K, H*Dh); the caches gain column ``index``
    (int8 values and scale) in place."""
    if q.device.type == "cpu":
        return lazy_attention_q8_plain(
            q, cache_k, cache_v, k_step, v_step, ancestry, index, num_heads
        )
    if q.device.type != "cuda":
        raise ValueError(f"lazy_attention_q8: unsupported device {q.device}")
    b, beams, hd = q.shape
    t = cache_k["q"].shape[1]
    dh = hd // num_heads
    if any(x.dtype != torch.bfloat16 for x in (q, k_step, v_step)):
        raise TypeError("lazy_attention_q8 kernel: q and step rows must be bfloat16")
    if any(c["q"].dtype != torch.int8 or c["s"].dtype != torch.float32
           for c in (cache_k, cache_v)):
        raise TypeError("lazy_attention_q8 kernel: caches must be int8 values, f32 scales")
    if ancestry.dtype != torch.int32:
        raise TypeError("lazy_attention_q8 kernel: ancestry must be int32")
    if dh != 64 or hd != num_heads * dh:
        raise ValueError(f"lazy_attention_q8 kernel: head_dim must be 64, got {hd}/{num_heads}")
    if not 1 <= beams <= 32 or not 0 <= index < t:
        raise ValueError(f"lazy_attention_q8 kernel: beams={beams}, index={index}, T={t}")
    if (any(c["q"].shape != (b * beams, t, hd) or c["s"].shape != (b * beams, t)
            for c in (cache_k, cache_v))
            or k_step.shape != q.shape or v_step.shape != q.shape
            or ancestry.shape != (b, beams, t)):
        raise ValueError("lazy_attention_q8 kernel: inconsistent shapes")
    tensors = (q, cache_k["q"], cache_k["s"], cache_v["q"], cache_v["s"], k_step, v_step,
               ancestry)
    for x in tensors:
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("lazy_attention_q8 kernel: tensors must be contiguous, "
                             "16-byte aligned and on one device")
    out = torch.empty_like(q)
    err = _build.lib().mic_lazy_attention_q8(
        *(x.data_ptr() for x in tensors), out.data_ptr(),
        b, beams, t, num_heads, dh, index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "mic_lazy_attention_q8")
    lazy_attention_q8.launches += 1
    return out


lazy_attention_q8.launches = 0

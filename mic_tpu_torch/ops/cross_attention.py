"""Beam-grouped decode cross-attention: the CUDA kernels and their plain versions.

Counterparts of mic_tpu/ops/cross_attention.py:
  - ``fused_cross_attention`` (MIC_TPU_EXPERIMENTAL=fused_cross_attn): the
    bf16 _kernel_bf16 over the canonical (B, S, H, Dh) or merged
    (B, S, H*Dh) encoder K/V, and the int8 _kernel_q8 over a quantized
    cross cache {"q": int8 (B, S, H, Dh) or (B, S, H*Dh), "s": f32
    (B, S, H)}, a scale per (image, position, head) as
    ops/quant.py::quantize_rows_dynamic makes it.  Nothing in mic_tpu
    builds that int8 cache, and no path of the port reaches it either.
  - ``fused_cross_attention_dma`` (MIC_TPU_EXPERIMENTAL=merged_cross): the
    merged (B, S_pad, H*Dh) bf16 cache, S padded with zero rows to a
    multiple of 16, rows at or past ``real_s`` dead.

An image's beams share its encoder K/V, read-only; the beams ride the
query axis.  The arithmetic is mic_tpu's _attend_tiles with no step rows
(ops/lazy_attention.py::attend_rows_plain): f32 scores (times the K scale
on the int8 cache), an f32 softmax, weights (times the V scale) rounded to
bfloat16, f32 sums and one bfloat16 rounding of the output.  mic_tpu masks
the padded rows to finfo(float32).min, so they weigh exp(...) == 0 exactly:
the kernel does not read them at all, which gives the same result.

A float32 model's q, K and V are float32: the same arithmetic on f32 K and
V rows (q rounded to bfloat16, K and V not), the output returned in
float32; its instances are the kernel's float32 ones.  The int8 form takes
float32 q likewise.  ``fused_cross_attention`` hands an int8 cache to
``fused_cross_attention_q8``, whose kernel it is.  Each wrapper takes the plain version for tensors on the
CPU and its kernel (csrc/cross_attention.cu) for tensors on a CUDA device;
it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build
from mic_tpu_torch.ops.lazy_attention import attend_rows_plain


def supports(num_heads: int, head_dim: int) -> bool:
    """mic_tpu's guard: the merged head width a multiple of 128."""
    return (num_heads * head_dim) % 128 == 0


def _split(cache, b: int, num_heads: int, head_dim: int):
    """A bf16 cache or an int8 dict -> (B, S, H, Dh) rows and (B, S, H)
    scales or None."""
    if isinstance(cache, dict):
        return (cache["q"].reshape(b, -1, num_heads, head_dim),
                cache["s"].reshape(b, -1, num_heads))
    return cache.reshape(b, cache.shape[1], num_heads, head_dim), None


def fused_cross_attention_plain(q, enc_k, enc_v, beams: int, num_heads: int) -> torch.Tensor:
    """q (B, K, H*Dh), pre-scaled; enc_k / enc_v (B, S, H, Dh) or
    (B, S, H*Dh), or int8 dicts -> (B, K, H*Dh) in q's dtype:
    ``attend_rows_plain`` with every row live, the int8 cache's scales and
    no step rows."""
    b, _, hd = q.shape
    k_rows, k_scale = _split(enc_k, b, num_heads, hd // num_heads)
    v_rows, v_scale = _split(enc_v, b, num_heads, hd // num_heads)
    return attend_rows_plain(q, k_rows, v_rows, num_heads, k_scale=k_scale, v_scale=v_scale)


def _check(name: str, q, beams: int, num_heads: int) -> tuple[int, int, int, int]:
    b, k, hd = q.shape
    dh = hd // num_heads
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel: q must be bfloat16 or float32")
    if dh != 64 or hd != num_heads * dh or beams != k:
        raise ValueError(f"{name} kernel: head_dim 64, got {hd}/{num_heads}, beams={beams}")
    return b, k, hd, dh


def fused_cross_attention(q, enc_k, enc_v, beams: int, num_heads: int) -> torch.Tensor:
    """One layer's cross-attention of every beam: -> (B, K, H*Dh).  An int8
    cross cache goes to ``fused_cross_attention_q8``."""
    if isinstance(enc_k, dict) or isinstance(enc_v, dict):
        return fused_cross_attention_q8(q, enc_k, enc_v, beams, num_heads)
    if q.device.type == "cpu":
        return fused_cross_attention_plain(q, enc_k, enc_v, beams, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_cross_attention: unsupported device {q.device}")
    name = "fused_cross_attention"
    b, k, hd, dh = _check(name, q, beams, num_heads)
    s = enc_k.shape[1]
    if any(x.dtype != q.dtype for x in (enc_k, enc_v)):
        raise TypeError(f"{name} kernel: the encoder K/V must be in q's dtype")
    if enc_k.shape not in ((b, s, num_heads, dh), (b, s, hd)) or enc_v.shape != enc_k.shape \
            or s < 1:
        raise ValueError(f"{name} kernel: inconsistent shapes")
    _build.check_operands(name, (q, enc_k, enc_v))
    out = torch.empty_like(q)
    entry = "mic_cross_attention_f32" if q.dtype == torch.float32 else "mic_cross_attention_bf16"
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), enc_k.data_ptr(), enc_v.data_ptr(), out.data_ptr(), b, k, s, num_heads,
        dh, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, entry)
    fused_cross_attention.launches += 1
    return out


fused_cross_attention.launches = 0  # both dtypes' launches


def fused_cross_attention_q8(q, enc_k, enc_v, beams: int, num_heads: int) -> torch.Tensor:
    """The int8 cross cache's cross-attention (mic_tpu's _kernel_q8): enc_k /
    enc_v {"q": int8 (B, S, H, Dh) or (B, S, H*Dh), "s": f32 (B, S, H)}
    -> (B, K, H*Dh)."""
    if q.device.type == "cpu":
        return fused_cross_attention_plain(q, enc_k, enc_v, beams, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_cross_attention_q8: unsupported device {q.device}")
    name = "fused_cross_attention_q8"
    b, k, hd, dh = _check(name, q, beams, num_heads)
    if not (isinstance(enc_k, dict) and isinstance(enc_v, dict)):
        raise TypeError(f"{name} kernel: K and V must both be int8 dicts")
    kq, vq = enc_k["q"], enc_v["q"]
    s = kq.shape[1]
    if any(x.dtype != torch.int8 for x in (kq, vq)) or any(
            c["s"].dtype != torch.float32 for c in (enc_k, enc_v)):
        raise TypeError(f"{name} kernel: int8 values and float32 scales")
    if (kq.shape not in ((b, s, num_heads, dh), (b, s, hd)) or vq.shape != kq.shape or s < 1
            or any(c["s"].shape != (b, s, num_heads) for c in (enc_k, enc_v))):
        raise ValueError(f"{name} kernel: inconsistent shapes")
    tensors = (q, kq, enc_k["s"], vq, enc_v["s"])
    _build.check_operands(name, tensors)
    out = torch.empty_like(q)
    entry = ("mic_cross_attention_q8_f32" if q.dtype == torch.float32
             else "mic_cross_attention_q8")
    err = getattr(_build.lib(), entry)(
        *(x.data_ptr() for x in tensors), out.data_ptr(), b, k, s, num_heads, dh,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, entry)
    fused_cross_attention_q8.launches += 1
    return out


fused_cross_attention_q8.launches = 0  # both dtypes of q


def _check_pad(enc_k, real_s: int) -> int:
    """mic_tpu's guard on the padded encoder axis -> S_pad."""
    s_pad = enc_k.shape[1]
    if s_pad % 16 != 0:
        raise ValueError(f"S_pad must be 16-aligned (bf16 tile), got {s_pad}")
    if not 1 <= real_s <= s_pad:
        raise ValueError(f"real_s={real_s} must lie in 1..S_pad={s_pad}")
    return s_pad


def fused_cross_attention_dma_plain(q, enc_k, enc_v, real_s: int, beams: int,
                                    num_heads: int) -> torch.Tensor:
    """q (B, K, H*Dh), pre-scaled; merged enc_k / enc_v (B, S_pad, H*Dh),
    zeros past ``real_s`` -> (B, K, H*Dh) in q's dtype: ``attend_rows_plain``
    with rows < ``real_s`` live for every beam, as mic_tpu's liveness mask."""
    s_pad = _check_pad(enc_k, real_s)
    b, k, hd = q.shape
    dh = hd // num_heads
    live = (torch.arange(s_pad, device=q.device) < real_s).to(torch.int8)
    return attend_rows_plain(q, enc_k.reshape(b, s_pad, num_heads, dh),
                             enc_v.reshape(b, s_pad, num_heads, dh), num_heads,
                             live=live[None, :, None].expand(b, s_pad, k))


def fused_cross_attention_dma(q, enc_k, enc_v, real_s: int, beams: int,
                              num_heads: int) -> torch.Tensor:
    """One layer's cross-attention of every beam over the merged padded
    cache: -> (B, K, H*Dh).  The kernel reads rows < ``real_s`` only."""
    s_pad = _check_pad(enc_k, real_s)
    if q.device.type == "cpu":
        return fused_cross_attention_dma_plain(q, enc_k, enc_v, real_s, beams, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_cross_attention_dma: unsupported device {q.device}")
    name = "fused_cross_attention_dma"
    b, k, hd, dh = _check(name, q, beams, num_heads)
    if any(x.dtype != q.dtype for x in (enc_k, enc_v)):
        raise TypeError(f"{name} kernel: the merged encoder K/V must be in q's dtype")
    if enc_k.shape != (b, s_pad, hd) or enc_v.shape != enc_k.shape:
        raise ValueError(f"{name} kernel: inconsistent shapes")
    _build.check_operands(name, (q, enc_k, enc_v))
    out = torch.empty_like(q)
    entry = ("mic_cross_attention_dma_f32" if q.dtype == torch.float32
             else "mic_cross_attention_dma_bf16")
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), enc_k.data_ptr(), enc_v.data_ptr(), out.data_ptr(), b, k, s_pad, real_s,
        num_heads, dh, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, entry)
    fused_cross_attention_dma.launches += 1
    return out


fused_cross_attention_dma.launches = 0  # both dtypes' launches

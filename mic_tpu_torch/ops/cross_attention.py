"""Beam-grouped decode cross-attention: the CUDA kernel and its plain version.

Counterpart of mic_tpu/ops/cross_attention.py::fused_cross_attention (bf16,
MIC_TPU_EXPERIMENTAL=fused_cross_attn).  An image's beams share its encoder
K/V, (B, S, H, Dh), read-only and live at every position; the beams ride
the query axis.  The arithmetic is mic_tpu's _attend_tiles with no mask and
no step rows (ops/lazy_attention.py::attend_rows_plain): f32 scores, an
f32 softmax, weights rounded to bfloat16, f32 sums and one bfloat16
rounding of the output.  mic_tpu's int8 variant
(_kernel_q8) takes a quantized cross cache that nothing in mic_tpu builds
and is not ported.

``fused_cross_attention`` takes the plain version for tensors on the CPU and
its kernel (csrc/cross_attention.cu) for tensors on a CUDA device; it never
falls back from one to the other.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build
from mic_tpu_torch.ops.lazy_attention import attend_rows_plain


def supports(num_heads: int, head_dim: int) -> bool:
    """mic_tpu's guard: the merged head width a multiple of 128."""
    return (num_heads * head_dim) % 128 == 0


def fused_cross_attention_plain(q, enc_k, enc_v, beams: int, num_heads: int) -> torch.Tensor:
    """q (B, K, H*Dh), pre-scaled; enc_k / enc_v (B, S, H, Dh) -> (B, K, H*Dh)
    in q's dtype: ``attend_rows_plain`` with every row live, no scales and
    no step rows."""
    return attend_rows_plain(q, enc_k, enc_v, num_heads)


def fused_cross_attention(q, enc_k, enc_v, beams: int, num_heads: int) -> torch.Tensor:
    """One layer's cross-attention of every beam: -> (B, K, H*Dh)."""
    if q.device.type == "cpu":
        return fused_cross_attention_plain(q, enc_k, enc_v, beams, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"fused_cross_attention: unsupported device {q.device}")
    name = "fused_cross_attention"
    b, k, hd = q.shape
    dh = hd // num_heads
    s = enc_k.shape[1]
    if any(x.dtype != torch.bfloat16 for x in (q, enc_k, enc_v)):
        raise TypeError(f"{name} kernel: q and the encoder K/V must be bfloat16")
    if dh != 64 or hd != num_heads * dh or beams != k or not 1 <= k <= 8:
        raise ValueError(f"{name} kernel: head_dim 64 and 1-8 beams, got {hd}/{num_heads}, "
                         f"beams={beams}")
    if enc_k.shape != (b, s, num_heads, dh) or enc_v.shape != enc_k.shape or s < 1:
        raise ValueError(f"{name} kernel: inconsistent shapes")
    _build.check_operands(name, (q, enc_k, enc_v))
    out = torch.empty_like(q)
    err = _build.lib().mic_cross_attention_bf16(
        q.data_ptr(), enc_k.data_ptr(), enc_v.data_ptr(), out.data_ptr(), b, k, s, num_heads,
        dh, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "mic_cross_attention_bf16")
    fused_cross_attention.launches += 1
    return out


fused_cross_attention.launches = 0

"""Scaled dot-product attention, the math of mic_tpu/ops/attention.py's XLA
path: q, k, v (B, T, H, Dh) with q pre-scaled, optional boolean mask
(B, 1, Tq, Tk) where True means attend, scores and softmax in float32,
output in q's dtype; optional inverted dropout on the post-softmax weights.
Written as matmul + softmax, not SDPA, so that it is the same math as the
reference."""

from __future__ import annotations

import torch

from mic_tpu_torch.core.knobs import experimental
from mic_tpu_torch.nn.layers import keep_mask

# masked scores take finfo(float32).min, never -inf: a fully masked row stays finite
_MASK_VALUE = torch.finfo(torch.float32).min


def xla_attention(q, k, v, mask=None, dropout_rate: float = 0.0, dropout_rng=None) -> torch.Tensor:
    dtype = q.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask is not None:
        scores = torch.where(mask, scores, _MASK_VALUE)
    weights = torch.softmax(scores, dim=-1).to(dtype)
    if dropout_rate > 0.0 and dropout_rng is not None:
        keep = keep_mask(dropout_rng, weights.shape, 1.0 - dropout_rate, weights.device)
        weights = torch.where(keep, weights / (1.0 - dropout_rate),
                              torch.zeros((), dtype=dtype, device=weights.device))
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.to(dtype))


def refuse_small_attn() -> None:
    """MIC_TPU_EXPERIMENTAL=small_attn sends mic_tpu's full-sequence
    attention to its small-T kernel (mic_tpu/ops/small_attention.py).  The
    port has not ported that kernel, so its entry points refuse the switch
    rather than run another path."""
    if experimental("small_attn", "0") == "1":
        raise NotImplementedError("MIC_TPU_EXPERIMENTAL=small_attn: the small-T attention "
                                  "kernel is not ported (ROADMAP B12)")

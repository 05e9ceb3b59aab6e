"""Scaled dot-product attention, the math of mic_tpu/ops/attention.py's XLA
path: q, k, v (B, T, H, Dh) with q pre-scaled, optional boolean mask
(B, 1, Tq, Tk) where True means attend, scores and softmax in float32,
output in q's dtype.  Written as matmul + softmax, not SDPA, so that it is
the same math as the reference."""

from __future__ import annotations

import torch

# masked scores take finfo(float32).min, never -inf: a fully masked row stays finite
_MASK_VALUE = torch.finfo(torch.float32).min


def xla_attention(q, k, v, mask=None) -> torch.Tensor:
    dtype = q.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask is not None:
        scores = torch.where(mask, scores, _MASK_VALUE)
    weights = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.to(dtype))

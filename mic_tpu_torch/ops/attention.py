"""Scaled dot-product attention with mic_tpu's implementations
(mic_tpu/ops/attention.py): q, k, v (B, T, H, Dh) with q pre-scaled,
optional boolean mask (B, 1, Tq, Tk) where True means attend, output in
q's dtype.

``dot_product_attention`` picks the implementation in mic_tpu's order:
  1. ``impl="pallas"`` with no active dropout and no weights asked for:
     ops/flash_attention.py, on every device (mic_tpu runs its Pallas
     kernel in interpret mode off the TPU);
  2. MIC_TPU_EXPERIMENTAL=small_attn, likewise, on CUDA tensors where
     ops/small_attention.py::supports takes the shape (mic_tpu: on the TPU),
     whatever the call site: a cross-attention with Tq == Tk <= 64 too;
  3. else ``xla_attention``, scores and softmax in float32, optional
     inverted dropout on the post-softmax weights, and the weights returned
     on request.  Written as matmul + softmax, not SDPA, so that it is the
     same math as the reference.
The three treat a row with no valid key differently: XLA attends uniformly
(every score finfo.min), small-T attends key 0, flash outputs 0.
"""

from __future__ import annotations

import torch

from mic_tpu_torch.core.knobs import experimental
from mic_tpu_torch.nn.layers import keep_mask
from mic_tpu_torch.ops import small_attention
from mic_tpu_torch.ops.flash_attention import flash_attention

# masked scores take finfo(float32).min, never -inf: a fully masked row stays finite
_MASK_VALUE = torch.finfo(torch.float32).min


def attention_branch(q, k, v, mask, impl: str, dropout_rate: float, dropout_rng,
                     return_weights: bool, on_card: bool) -> str:
    """"flash", "small" or "xla": mic_tpu's gate (mic_tpu/ops/attention.py:44-70)
    with ``on_card`` (CUDA tensors) in the place of its TPU backend."""
    active_dropout = dropout_rate > 0.0 and dropout_rng is not None
    if impl == "pallas" and not active_dropout and not return_weights:
        return "flash"
    if (not active_dropout and not return_weights and experimental("small_attn", "0") == "1"
            and on_card and small_attention.supports(q, k, v, mask, 0.0, False)):
        return "small"
    return "xla"


def dot_product_attention(q, k, v, mask=None, impl: str = "xla", dropout_rate: float = 0.0,
                          dropout_rng=None, return_weights: bool = False):
    """-> out (B, Tq, H, Dh), or (out, weights (B, H, Tq, Tk)) with
    ``return_weights``."""
    branch = attention_branch(q, k, v, mask, impl, dropout_rate, dropout_rng, return_weights,
                              q.device.type == "cuda")
    if branch == "flash":
        return flash_attention(q, k, v, mask)
    if branch == "small":
        return small_attention.small_t_attention(q, k, v, mask)
    return xla_attention(q, k, v, mask, dropout_rate, dropout_rng, return_weights)


def xla_attention(q, k, v, mask=None, dropout_rate: float = 0.0, dropout_rng=None,
                  return_weights: bool = False):
    dtype = q.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if mask is not None:
        scores = torch.where(mask, scores, _MASK_VALUE)
    weights = torch.softmax(scores, dim=-1).to(dtype)
    if dropout_rate > 0.0 and dropout_rng is not None:
        keep = keep_mask(dropout_rng, weights.shape, 1.0 - dropout_rate, weights.device)
        weights = torch.where(keep, weights / (1.0 - dropout_rate),
                              torch.zeros((), dtype=dtype, device=weights.device))
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.to(dtype))
    return (out, weights) if return_weights else out

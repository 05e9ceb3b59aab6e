"""Label-smoothed cross-entropy on materialized logits
(mic_tpu/train/loss.py): the ``fused_ce=False`` route and the oracle of the
tests.  Computed from logsumexp and two reductions, never a (B, T, V)
smoothed one-hot:

  CE(smoothed) = lse - [c * z_y + l * (sum_z - z_y)]   (c = 1 - ls, l = ls / (V - 1))
  loss         = CE - normalizing constant, masked mean

Gradients come from autograd: mic_tpu's hand-written backward only forces
the logits-sized cotangent into the logits dtype, which autograd's cast
backward does here anyway.
"""

from __future__ import annotations

import torch

from mic_tpu_torch.ops.fused_ce import expected_logit, normalizing


def label_smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: torch.Tensor,
                                 label_smoothing: float = 0.0) -> torch.Tensor:
    """logits (B, T, V) any float dtype, labels (B, T) int, mask (B, T) with
    1 where the token counts -> float32 scalar."""
    logits32 = logits.float()
    vocab = logits.shape[-1]
    lse = torch.logsumexp(logits32, dim=-1)
    label_logit = logits32.gather(-1, labels[..., None].long())[..., 0]
    sum_logits = logits32.sum(dim=-1) if label_smoothing > 0.0 else None
    loss = lse - expected_logit(label_logit, sum_logits, label_smoothing, vocab)
    loss = loss - normalizing(label_smoothing, vocab)
    mask = mask.float()
    return (loss * mask).sum() / mask.sum()

"""Top-k with ``jax.lax.top_k``'s tie order, and the head's mask constant.

Counterpart of the constants and selection semantics of
mic_tpu/ops/topk_lse.py.  ``jax.lax.top_k`` returns equal values lower
index first; ``torch.topk`` promises no order among ties on CUDA, and the
search's NEG_INF (-1e7) and the head's -1e30 make ties real.  Every top-k
of the port goes through ``top_k`` below.
"""

from __future__ import annotations

import torch

# masked vocab columns of the LM head (mic_tpu/ops/topk_lse.py NEG_INF)
NEG_INF = -1e30


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, descending, ties lower index first.
    Returns (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]

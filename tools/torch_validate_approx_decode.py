"""Per-step candidate recall of the port's approximate candidate selects
(the counterpart of tools/validate_approx_decode.py's ``K_SLATE`` and
``per_step_recall``).

Each approximate select of the tied head is held against the exact top-k
on the same (N, V) logits: the share of the exact top-k ids that the
select's k ids contain, averaged over the rows.  Beam 4 draws its
candidates from a slate of 2K+1 = 9, so recall@9 is what decides whether
an approximate select can change a beam.

  - bucket(512): ``ops/fused_head.py::bucket_topk_dense`` at width 512
    (the per-column-position max over the 512-wide chunks of the vocab);
  - window(128): ``ops/fused_head.py::window_topk_dense`` (the top-1 of
    every 128-wide window);
  - approx_max_k: the TPU's ``jax.lax.approx_max_k`` is an XLA operation
    with no CUDA counterpart; the port's search resolves "approx" to the
    exact select (generate/search.py::_topk_mode), so this key is computed
    with the exact select and reads 1.0.

tools/torch_ab_hard_synthetic.py runs it on the teacher-forced positions
of a trained model.  The random-weights study of the JAX tool's ``main``
is not ported yet.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

K_SLATE = 9  # beam-4's 2K+1 candidate slate


def per_step_recall(logits: torch.Tensor, k: int = K_SLATE) -> dict:
    """(N, V) float32 logits -> {mode: mean recall of the exact top-k}."""
    from mic_tpu_torch.ops.fused_head import bucket_topk_dense, window_topk_dense
    from mic_tpu_torch.ops.topk_lse import top_k

    _, exact = top_k(logits, k)  # ties to the lower id, as jax.lax.top_k
    _, bucket = bucket_topk_dense(logits, k, 512)
    _, window = window_topk_dense(logits, k)
    _, approx = top_k(logits, k)  # approx_max_k: the exact select here

    def recall(ids):
        hit = (ids[:, :, None].long() == exact[:, None, :]).any(dim=-1)
        return float((hit.sum(dim=-1).float() / k).mean())

    return {
        "bucket(512)": recall(bucket),
        "window(128)": recall(window),
        "approx_max_k": recall(approx),
    }

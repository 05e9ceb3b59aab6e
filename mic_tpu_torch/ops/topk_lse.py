"""Top-k with ``jax.lax.top_k``'s tie order, and the fused top-k +
logsumexp candidate select.

Counterpart of mic_tpu/ops/topk_lse.py.  ``jax.lax.top_k`` returns equal
values lower index first; ``torch.topk`` promises no order among ties on
CUDA, and the search's NEG_INF (-1e7) and the head's -1e30 make ties real.
Every top-k of the port goes through ``top_k`` below.

``topk_log_probs`` (MIC_TPU_EXPERIMENTAL=pallas_topk in the dense-logits
candidate select) returns the top-k entries of log_softmax(logits) without
a vocab-wide log-softmax, for k up to ``TOPK_MAX``.  Its wrapper takes
the plain version for tensors on the CPU and its kernel (csrc/topk_lse.cu)
for tensors on a CUDA device; it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build

# masked vocab columns of the LM head (mic_tpu/ops/topk_lse.py NEG_INF)
NEG_INF = -1e30
# the largest k the kernel keeps: beam search asks for 2K + 1 candidates a
# row, 2K + 5 under no_repeat_ngram_size, so 37 at 16 beams (ROADMAP B45;
# more is B41b)
TOPK_MAX = 40
_RUN_COLS = 4096  # the fewest vocab columns a run of the kernel walks
_ENTRIES = {torch.bfloat16: "mic_topk_lse_bf16", torch.float32: "mic_topk_lse_f32"}


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last axis, descending, ties lower index first.
    Returns (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_log_probs_plain(logits: torch.Tensor, k: int):
    """mic_tpu's off-TPU branch: the stable top-k of the f32-cast logits
    minus the row logsumexp -> (log_probs (N, k) f32, ids (N, k) int32)."""
    l32 = logits.float()
    vals, ids = top_k(l32, k)
    return vals - torch.logsumexp(l32, dim=-1, keepdim=True), ids.to(torch.int32)


def topk_log_probs(logits: torch.Tensor, k: int):
    """(N, V) raw logits, bf16 or f32 -> (log_probs (N, k) f32, ids (N, k)
    int32): the top-k of log_softmax(logits), ties to the lower id."""
    if logits.device.type == "cpu":
        return topk_log_probs_plain(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"topk_log_probs: unsupported device {logits.device}")
    entry = _ENTRIES.get(logits.dtype)
    if entry is None:
        raise TypeError(f"topk_log_probs kernel: logits must be bfloat16 or float32, "
                        f"got {logits.dtype}")
    n, v = logits.shape
    if not 1 <= k <= min(TOPK_MAX, v):
        raise ValueError(f"topk_log_probs kernel: k={k} outside 1..{min(TOPK_MAX, v)} "
                         "(ROADMAP B41b)")
    if not logits.is_contiguous():
        raise ValueError("topk_log_probs kernel: logits must be contiguous")
    # partials for up to one run a _RUN_COLS columns, in one buffer: (max,
    # sum) (runs, n) each, then values and int32 ids (runs, n, k) each; the
    # launch uses as many runs as fill one wave of the card's resident warps,
    # and the last run of a row to finish folds them
    runs = -(-v // _RUN_COLS)
    f32 = dict(dtype=torch.float32, device=logits.device)
    part = torch.empty(runs * n * (2 + 2 * k), **f32)
    plane = runs * n * part.element_size()
    part_m = part.data_ptr()
    part_l, part_v, part_i = part_m + plane, part_m + 2 * plane, part_m + (2 + k) * plane
    lp = torch.empty((n, k), **f32)
    ids = torch.empty((n, k), dtype=torch.int32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    arrivals = _build.arrivals(logits.device, stream, n)
    err = getattr(_build.lib(), entry)(
        logits.data_ptr(), part_m, part_l, part_v, part_i, arrivals.data_ptr(), lp.data_ptr(),
        ids.data_ptr(), n, v, k, runs, stream,
    )
    _build.check(err, entry)
    topk_log_probs.launches += 1
    return lp, ids


topk_log_probs.launches = 0

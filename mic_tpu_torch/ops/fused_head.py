"""Fused tied LM head + candidate top-k + row logsumexp.

Counterpart of mic_tpu/ops/fused_head.py::fused_head_topk.  Per hidden row
it returns the top-k candidate log-probs and ids of
log_softmax(hidden @ weight^T + bias) and the row lse.

- ``select="bucket"``: candidates are the top-k of 512 bucket winners, each
  the running max of one column position over the vocab's 512-wide chunks
  (earliest chunk wins ties).  The TPU serving default.
- ``select="exact"``: the exact top-k (the CPU default).

``fused_head_topk`` takes the plain versions for tensors on the CPU.  On a
CUDA device it runs the bucket kernel (csrc/fused_head.cu), which never
stores logits, and finishes lse and top-k in torch as the TPU's n > 512
path finishes in XLA; the exact select has no CUDA kernel yet and raises.
The weight is the tied embedding as stored, (V, D): no transposed copy.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build
from mic_tpu_torch.ops.topk_lse import NEG_INF, top_k

BUCKETS = 512  # bv of mic_tpu/ops/fused_head.py::_bucket_tiles at every N
_ROW_TILE = 64  # hidden rows per block of csrc/fused_head.cu (kBM)
_COL_TILE = 64  # bucket columns per block of csrc/fused_head.cu (kBC)


def _logits(hidden, weight, bias) -> torch.Tensor:
    return hidden.float() @ weight.float().T + bias.float()


def bucket_topk_dense(logits: torch.Tensor, k: int):
    """mic_tpu/ops/fused_head.py::_bucket_topk_dense at bv = BUCKETS: the
    per-column-position max over ceil(V/512) chunks (earliest chunk on ties),
    then the top-k of the 512 winners -> (values (N, k), int32 ids (N, k))."""
    n, v = logits.shape
    pad = (-v) % BUCKETS
    if pad:
        fill = torch.full((n, pad), NEG_INF, dtype=logits.dtype, device=logits.device)
        logits = torch.cat([logits, fill], dim=1)
    s3 = logits.reshape(n, -1, BUCKETS)
    vals = s3.amax(dim=1)
    chunk = torch.argmax(s3, dim=1)                          # first max
    ids = chunk * BUCKETS + torch.arange(BUCKETS, device=logits.device)
    tv, pick = top_k(vals, k)
    return tv, ids.gather(1, pick).to(torch.int32)


def fused_head_topk_plain(hidden, weight, bias, k: int, select: str = "bucket"):
    """Materialized-logits version: -> (lp (N, k) f32, ids (N, k) int32,
    lse (N, 1) f32)."""
    logits = _logits(hidden, weight, bias)
    if select == "bucket":
        vals, ids = bucket_topk_dense(logits, k)
    elif select == "exact":
        vals, idx = top_k(logits, k)
        ids = idx.to(torch.int32)
    else:
        raise ValueError(f"unknown select {select!r}")
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    return vals - lse, ids, lse


def bucket_finish(k: int, l, rmax, rid):
    """mic_tpu/ops/fused_head.py::_bucket_finish_host: exact row lse from the
    per-column sums of exps, top-k over the bucket winners."""
    lt = l.sum(dim=-1, keepdim=True)
    m = rmax.amax(dim=-1, keepdim=True)
    lse = torch.maximum(torch.log(torch.clamp(lt, min=torch.finfo(torch.float32).tiny)), m)
    tv, pick = top_k(rmax, k)
    return tv - lse, rid.gather(1, pick), lse


def _chunk_splits(n: int, v: int, device: torch.device) -> int:
    """How many consecutive runs the kernel cuts the chunk walk into: as many
    as fill the SMs left idle by the (row tile x column group) blocks, one
    block per SM, and never more than there are chunks."""
    blocks = -(-n // _ROW_TILE) * (BUCKETS // _COL_TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-v // BUCKETS), sms // blocks))


def fused_head_topk(hidden, weight, bias, k: int, select: str = "bucket"):
    """hidden (N, D), weight (V, D) tied embedding, bias (V,) ->
    (lp (N, k) f32, ids (N, k) int32, lse (N, 1) f32)."""
    if hidden.device.type == "cpu":
        return fused_head_topk_plain(hidden, weight, bias, k, select)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_head_topk: unsupported device {hidden.device}")
    if select != "bucket":
        raise NotImplementedError(f"fused_head_topk: no CUDA kernel for select={select!r}")
    n, d = hidden.shape
    v = weight.shape[0]
    if hidden.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise TypeError("fused_head_topk kernel: hidden and weight must be bfloat16")
    if weight.shape != (v, d) or bias.shape != (v,) or d % 64 or not 1 <= k <= BUCKETS:
        raise ValueError(f"fused_head_topk kernel: hidden {tuple(hidden.shape)}, "
                         f"weight {tuple(weight.shape)}, bias {tuple(bias.shape)}, k={k}")
    bias32 = bias.float().contiguous()
    for x in (hidden, weight, bias32):
        if x.device != hidden.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("fused_head_topk kernel: tensors must be contiguous, "
                             "16-byte aligned and on one device")
    splits = _chunk_splits(n, v, hidden.device)
    f32 = dict(dtype=torch.float32, device=hidden.device)
    i32 = dict(dtype=torch.int32, device=hidden.device)
    l, rmax = torch.empty((2, n, BUCKETS), **f32)
    rid = torch.empty((n, BUCKETS), **i32)
    parts = (0, 0, 0)
    if splits > 1:  # one set of planes per run of chunks, merged by the kernel
        l_part, rmax_part = torch.empty((2, splits, n, BUCKETS), **f32)
        rid_part = torch.empty((splits, n, BUCKETS), **i32)
        parts = (l_part.data_ptr(), rmax_part.data_ptr(), rid_part.data_ptr())
    lib = _build.lib()
    err = lib.mic_fused_head_bucket_bf16(
        hidden.data_ptr(), weight.data_ptr(), bias32.data_ptr(),
        l.data_ptr(), rmax.data_ptr(), rid.data_ptr(), *parts,
        n, d, v, splits, torch.cuda.current_stream(hidden.device).cuda_stream,
    )
    _build.check(err, "mic_fused_head_bucket_bf16")
    fused_head_topk.launches += 1
    return bucket_finish(k, l, rmax, rid)


fused_head_topk.launches = 0

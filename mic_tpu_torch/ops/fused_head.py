"""Fused tied LM head + candidate top-k + row logsumexp.

Counterpart of mic_tpu/ops/fused_head.py::fused_head_topk and
::fused_head_topk_q8.  Per hidden row they return the top-k candidate
log-probs and ids of log_softmax(hidden @ weight^T + bias) and the row lse.

- ``select="bucket"``: candidates are the top-k of BV bucket winners, each
  the running max of one column position over the vocab's BV-wide chunks
  (earliest chunk wins ties).  The TPU serving default.  BV is 512, or the
  width ``MIC_TPU_EXPERIMENTAL=bucket_bv=<w>`` names, at every N, as
  mic_tpu's ``_bucket_tiles`` reads it (``bucket_width``).
- ``select="exact"``: the exact top-k, lower id first on equal values (the
  CPU default).
- ``select="window"``: the top-1 of every 128-wide window (the highest
  lane on equal values), then the top-k of those (the lower window first).

``fused_head_topk_q8`` takes the int8 tied embedding (V, D) with one f32
scale per vocab row.  Its bucket select multiplies the hidden state rounded
to bfloat16 by the int8 weight converted to bfloat16 (no activation
quantization); its exact and window selects quantize the hidden state per
row (ops/quant.py) and multiply int8 by int8 into int32, so that
logits = acc * xs * ws + b.

Each function takes the plain versions for tensors on the CPU.  On a CUDA
device the bucket selects run the bucket kernels of csrc/fused_head.cu,
which never store logits and leave lse and the top-k of the BV winners to
torch, as the TPU's n > 512 path leaves them to XLA; they take any BV.  The
exact and window selects run its select kernels.  Every kernel runs on
wgmma fed by TMA (csrc/head_wgmma.cuh); the host-side arithmetic of their
launches (runs, splits, ring stages, shared memory) is the pure functions
below, and a shape a kernel does not take raises.  The weight is the tied
embedding as stored, (V, D): no transposed copy.

A float32 model (hidden rows and table both float32) takes the float32
kernels: its bucket select csrc/fused_head_f32.cu (the 3xTF32 tile of
csrc/tf32x3_wgmma.cuh at many rows, a stream of the table on FFMAs at a
few, ``bucket_f32_route``), its exact and window selects
csrc/fused_head.cu's f32::select_kernel on the same tile.  They compute
the logits to float32 accuracy (the tile with three TF32 products a term,
the stream with f32 FMAs); D is any multiple of 4.

The exact and window kernels take k up to 40 (beam search asks for 2K + 5
candidates a row under an n-gram ban: 37 at 16 beams): up to 16 on their
narrow candidate lists, 17-40 on wide ones (``select_candidates``) beside
fewer ring slots; more raise, naming ROADMAP B41b.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build
from mic_tpu_torch.core.knobs import experimental
from mic_tpu_torch.ops.quant import int8_matmul, quantize_rows_dynamic
from mic_tpu_torch.ops.topk_lse import NEG_INF, top_k

BUCKETS = 512  # bv of mic_tpu/ops/fused_head.py::_bucket_tiles unless bucket_bv is set
WINDOW = 128   # _WINDOW of mic_tpu/ops/fused_head.py
_ROW_TILE = 64  # hidden rows per block of csrc/fused_head.cu (kBRows, kSRows)
_COL_TILE = 64  # bucket columns per block of the bucket kernels (kBCols)
_Q8_SELECT_ROWS = 128  # hidden rows per block of the int8 select kernel (q8::kSRows)
_TOPK_NARROW = 16  # the largest k of the select kernels' narrow lists (kTopK)
_TOPK_MAX = 40  # the largest k of the wide lists (kTopKWide; ROADMAP B45, more is B41b)
_MAX_STAGES = 8  # ring stages of the kernels (kMaxStages)
_CANDIDATES = 24  # candidate entries a row of the select kernels (kCap)
_CANDIDATES_WIDE = 44  # the same past k = 16 (kCapWide)
_MERGE_RUNS = 32 * 9  # runs the wide merge takes (32 kMergeHeads)
SMEM_LIMIT = 232448  # shared memory a block can have on the H100
SELECTS = ("bucket", "exact", "window")
_F32_BOX = 64 * 128  # a 64-row, 32-deep f32 box of the 3xTF32 tile (tf32x3::kBox)
STREAM_ROWS = 4  # the float32 bucket select streams the table up to this many rows (kHeld)
_STREAM_WARPS = 8  # bucket columns a block of the stream (kStreamWarps)
_STREAM_RUN = 8  # chunks a warp of the stream walks, at most


def _logits(hidden, weight, bias) -> torch.Tensor:
    return hidden.float() @ weight.float().T + bias.float()


def _logits_q8_bucket(hidden, weight_q, weight_scale, bias) -> torch.Tensor:
    """bf16 hidden x int8 weight as bf16, f32 sums; then * ws + b."""
    acc = hidden.to(torch.bfloat16).float() @ weight_q.float().T
    return acc * weight_scale.float() + bias.float()


def _logits_q8(xq, xs, weight_q, weight_scale, bias) -> torch.Tensor:
    """int8 x int8 into int32 (exact); then acc * xs * ws + b in f32."""
    acc = int8_matmul(xq, weight_q.T)
    return acc.float() * xs * weight_scale.float() + bias.float()


def bucket_width() -> int:
    """The bucket select's chunk width BV: ``bucket_bv`` of
    MIC_TPU_EXPERIMENTAL when set, else 512, at every N
    (mic_tpu/ops/fused_head.py::_bucket_tiles)."""
    return int(experimental("bucket_bv") or BUCKETS)


def bucket_topk_dense(logits: torch.Tensor, k: int, bv: int | None = None):
    """mic_tpu/ops/fused_head.py::_bucket_topk_dense at ``bv`` (default
    ``bucket_width()``): the per-column-position max over ceil(V/bv) chunks
    (earliest chunk on ties), then the top-k of the bv winners -> (values
    (N, k), int32 ids (N, k))."""
    bv = bv or bucket_width()
    n, v = logits.shape
    pad = (-v) % bv
    if pad:
        fill = torch.full((n, pad), NEG_INF, dtype=logits.dtype, device=logits.device)
        logits = torch.cat([logits, fill], dim=1)
    s3 = logits.reshape(n, -1, bv)
    vals = s3.amax(dim=1)
    chunk = torch.argmax(s3, dim=1)                          # first max
    ids = chunk * bv + torch.arange(bv, device=logits.device)
    tv, pick = top_k(vals, k)
    return tv, ids.gather(1, pick).to(torch.int32)


def window_topk_dense(logits: torch.Tensor, k: int):
    """mic_tpu/ops/fused_head.py::_window_topk_dense: the top-1 of every
    128-wide window (highest lane on ties), then the top-k of the window
    winners (lower window on ties) -> (values (N, k), int32 ids (N, k))."""
    n, v = logits.shape
    pad = (-v) % WINDOW
    if pad:
        fill = torch.full((n, pad), NEG_INF, dtype=logits.dtype, device=logits.device)
        logits = torch.cat([logits, fill], dim=1)
    s3 = logits.reshape(n, -1, WINDOW)
    if k > s3.shape[1]:
        raise ValueError(f"window select: k={k} exceeds the {s3.shape[1]} windows of V={v}")
    wmax = s3.amax(dim=-1)
    lane = torch.arange(WINDOW, device=logits.device)
    widx = torch.where(s3 == wmax[..., None], lane, -1).amax(dim=-1)
    wids = torch.arange(s3.shape[1], device=logits.device) * WINDOW + widx
    vals, pick = top_k(wmax, k)
    return vals, wids.gather(1, pick).to(torch.int32)


def _select_dense(logits: torch.Tensor, k: int, select: str):
    """-> (lp (N, k) f32, ids (N, k) int32, lse (N, 1) f32) of f32 logits."""
    if select == "bucket":
        vals, ids = bucket_topk_dense(logits, k)
    elif select == "window":
        vals, ids = window_topk_dense(logits, k)
    elif select == "exact":
        vals, idx = top_k(logits, k)
        ids = idx.to(torch.int32)
    else:
        raise ValueError(f"unknown select {select!r}")
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    return vals - lse, ids, lse


def fused_head_topk_plain(hidden, weight, bias, k: int, select: str = "bucket"):
    """Materialized-logits version: -> (lp (N, k) f32, ids (N, k) int32,
    lse (N, 1) f32)."""
    return _select_dense(_logits(hidden, weight, bias), k, select)


def fused_head_topk_q8_plain(hidden, weight_q, weight_scale, bias, k: int,
                             select: str = "bucket"):
    """Materialized-logits version of the int8 head (mic_tpu's non-TPU
    path of fused_head_topk_q8)."""
    if select == "bucket":
        logits = _logits_q8_bucket(hidden, weight_q, weight_scale, bias)
    else:
        logits = _logits_q8(*quantize_rows_dynamic(hidden), weight_q, weight_scale, bias)
    return _select_dense(logits, k, select)


def bucket_finish(k: int, l, rmax, rid):
    """mic_tpu/ops/fused_head.py::_bucket_finish_host: exact row lse from the
    per-column sums of exps, top-k over the bucket winners."""
    lt = l.sum(dim=-1, keepdim=True)
    m = rmax.amax(dim=-1, keepdim=True)
    lse = torch.maximum(torch.log(torch.clamp(lt, min=torch.finfo(torch.float32).tiny)), m)
    tv, pick = top_k(rmax, k)
    return tv - lse, rid.gather(1, pick), lse


def bucket_finish_runs(k: int, l, rmax, rid):
    """The float32 bucket kernels' finish: their runs' (splits, N, bv)
    planes merged in run order (sums of exps added in run order, the higher
    value kept and on a tie the earlier run's: torch.argmax takes the first
    maximum), then ``bucket_finish`` -> (lp, ids, lse)."""
    win = torch.argmax(rmax, dim=0, keepdim=True)
    return bucket_finish(k, l.sum(dim=0), rmax.gather(0, win)[0], rid.gather(0, win)[0])


def bucket_f32_stream_smem_bytes(held: int, d: int) -> int:
    """Shared memory of the float32 stream holding ``held`` hidden rows."""
    return held * d * 4


def bucket_f32_route(n: int, d: int) -> int:
    """The float32 bucket select's kernel at N rows, depth D: the stream
    (route ``STREAM_ROWS``, the rows it holds) up to ``STREAM_ROWS`` rows
    where they fit in shared memory, else 0, the 3xTF32 tile; both take
    every D that is a multiple of 4.  The crossover is measured: on an H100
    the stream beat the tile by 19% at N=1 and by 1-2% at N=2 and 4, and
    lost at 5 and 8 holding 8 rows (PERF.md)."""
    if n <= STREAM_ROWS and bucket_f32_stream_smem_bytes(STREAM_ROWS, d) <= SMEM_LIMIT:
        return STREAM_ROWS
    return 0


def bucket_f32_splits(n: int, v: int, bv: int, sms: int, route: int) -> int:
    """How many runs of chunks the float32 bucket kernel cuts its walk into:
    the tile's as ``chunk_splits`` (64-row x 64-column blocks, one an SM);
    the stream's runs of at most ``_STREAM_RUN`` chunks a warp (many small
    blocks of eight bucket columns, so that the last wave leaves few SMs
    idle), never fewer than give 8 blocks an SM; never more runs than
    chunks."""
    if not route:
        return chunk_splits(n, v, bv, sms)
    nchunks = -(-v // bv)
    return max(1, min(nchunks, max(-(-nchunks // _STREAM_RUN),
                                   -(-8 * sms // -(-bv // _STREAM_WARPS)))))


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def chunk_splits(n: int, v: int, bv: int, sms: int) -> int:
    """How many consecutive runs the bucket kernels cut the chunk walk into:
    as many as fill the SMs left idle by the (row tile x column group)
    blocks, ceil(bv / 64) column groups, one block per SM, and never more
    than there are chunks."""
    blocks = -(-n // _ROW_TILE) * -(-bv // _COL_TILE)
    return max(1, min(-(-v // bv), sms // blocks))


def chunk_runs(nchunks: int, splits: int):
    """The bucket kernels' runs: split z walks chunks [z * C // splits,
    (z + 1) * C // splits) of the C chunks -> [(begin, end)] in z order."""
    return [(z * nchunks // splits, (z + 1) * nchunks // splits) for z in range(splits)]


def select_runs(n: int, v: int, sms: int, rows: int = _ROW_TILE) -> int:
    """How many runs of 128-wide vocab tiles a select kernel cuts the vocab
    into: one block per SM over the tiles of ``rows`` hidden rows, at most
    one run a tile."""
    return max(1, min(-(-v // WINDOW), sms // -(-n // rows)))


def bucket_q8_smem_bytes(d: int) -> int:
    """Shared memory of the int8 bucket kernel (bucket_smem_bytes<true>):
    1024 bytes of alignment slack, the 64 resident bf16 hidden rows, eight
    ring stages of two 64 x 64-byte slices, seventeen mbarriers."""
    return 1024 + 64 * d * 2 + _MAX_STAGES * 2 * 64 * 64 + (2 * _MAX_STAGES + 1) * 8


def bucket_bf16_smem_bytes(d: int, stages: int) -> int:
    """Shared memory of the bf16 bucket kernel (bucket_smem_bytes<false>):
    alignment slack, the 64 resident hidden rows, ``stages`` ring stages of
    two 64-row x 64-deep bf16 slices (8 KB each), the barriers."""
    return 1024 + 64 * d * 2 + stages * 2 * 64 * 64 * 2 + (2 * stages + 1) * 8


def bucket_bf16_stages(d: int) -> int:
    """The bf16 bucket kernel's ring stages at depth D (bucket_stages): as
    many as fit, up to eight; it takes D when there are three or more (the
    warpgroups' final merge of 48 KB goes through the ring), D <= 1408."""
    stages = _MAX_STAGES
    while stages > 0 and bucket_bf16_smem_bytes(d, stages) > SMEM_LIMIT:
        stages -= 1
    return stages


def select_candidates(k: int) -> int:
    """The candidate entries a row of the exact/window kernels at k: 24 up
    to k = 16 (kCap), 44 past it (kCapWide; a list cut back to its top k
    when full, which stays rare at 7 or more spare entries)."""
    return _CANDIDATES if k <= _TOPK_NARROW else _CANDIDATES_WIDE


def select_q8_stages(k: int = 1) -> int:
    """The int8 exact/window kernel's ring stages: four with the narrow
    lists (kSStages), three with the wide ones (kSStagesWide)."""
    return 4 if k <= _TOPK_NARROW else 3


def select_q8_smem_bytes(d: int, k: int = 1) -> int:
    """Shared memory of the int8 exact/window kernel (q8::select_smem_bytes):
    alignment slack, the 128 resident int8 rows in 128-deep blocks, the ring
    stages (``select_q8_stages``) of 128 x 128 bytes with a tile's 128
    scales and biases beside each, ``select_candidates(k)`` candidates
    (value, id) for each of the 128 rows, the mbarriers."""
    stages = select_q8_stages(k)
    return (1024 + -(-d // 128) * 128 * 128 + stages * (128 * 128 + 128 * 8)
            + 128 * select_candidates(k) * 8 + (2 * stages + 1) * 8)


def select_bf16_smem_bytes(d: int, stages: int, k: int = 1) -> int:
    """Shared memory of the bf16 exact/window kernel (select_smem_bytes):
    alignment slack, the 64 resident hidden rows in 64-deep blocks of 128
    bytes a row, ``stages`` slots of a 128-column x 64-deep bf16 slice with
    a tile's 128 biases beside each, ``select_candidates(k)`` candidates
    (value, id) for each of the two warpgroups' 64 rows, the barriers (a
    full barrier a slot for each warpgroup, an empty one a slot, the
    rows')."""
    return (1024 + -(-d // 64) * 64 * 128 + stages * (128 * 64 * 2 + 128 * 4)
            + 2 * 64 * select_candidates(k) * 8 + (3 * stages + 1) * 8)


def select_bf16_stages(d: int, k: int = 1) -> int:
    """The bf16 select kernel's slots at depth D (select_stages): as many as
    fit, up to eight, an even number (half of them each warpgroup's); it
    takes D when there are two or more, D <= 1344 (four or more, two a
    warpgroup, load a warpgroup's next slice while it multiplies one).  Past
    k = 16 any number: the slots then serve the warpgroups in turn, three at
    D = 1024."""
    step = 2 if k <= _TOPK_NARROW else 1
    stages = _MAX_STAGES
    while stages > 0 and select_bf16_smem_bytes(d, stages, k) > SMEM_LIMIT:
        stages -= step
    return stages


def select_f32_smem_bytes(stages: int, k: int = 1) -> int:
    """Shared memory of the float32 exact/window kernel
    (f32::select_smem_bytes): alignment slack, ``stages`` slots of a tile's
    128 table rows and the 64 hidden rows' hi and lo (32-deep f32 boxes, 32
    KB) with a tile's 128 biases beside each, the candidate lists of both
    warpgroups' 64 rows, the barriers; the same at every D."""
    return (1024 + stages * (4 * _F32_BOX + 128 * 4) + 2 * 64 * select_candidates(k) * 8
            + 2 * stages * 8)


def select_f32_stages(k: int = 1) -> int:
    """The float32 select kernel's slots (f32::select_stages): as many as
    fit, up to eight, an even number (six; four past k = 16)."""
    stages = _MAX_STAGES
    while stages > 0 and select_f32_smem_bytes(stages, k) > SMEM_LIMIT:
        stages -= 2
    return stages


def _check_operands(name: str, *tensors) -> None:
    device = tensors[0].device
    for x in tensors:
        if x.device != device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} kernel: tensors must be contiguous, 16-byte aligned "
                             "and on one device")


def _bucket_kernel(entry: str, hidden, weight, wscale, bias, k: int):
    """Launch a bucket accumulator kernel (bf16 weight when ``wscale`` is
    None, else int8) and finish in torch -> (lp, ids, lse)."""
    n, d = hidden.shape
    v = weight.shape[0]
    bv = bucket_width()
    fits = (bucket_q8_smem_bytes(d) <= SMEM_LIMIT if wscale is not None
            else bucket_bf16_stages(d) >= 3)
    if (weight.shape != (v, d) or bias.shape != (v,) or d % 64 or not fits
            or not 1 <= k <= bv):
        raise ValueError(f"{entry}: hidden {tuple(hidden.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}, k={k}, bv={bv}")
    bias32 = bias.float().contiguous()
    scale = () if wscale is None else (wscale.float().contiguous(),)
    _check_operands(entry, hidden, weight, bias32, *scale)
    splits = chunk_splits(n, v, bv, _sms(hidden.device))
    f32 = dict(dtype=torch.float32, device=hidden.device)
    i32 = dict(dtype=torch.int32, device=hidden.device)
    l, rmax = torch.empty((2, n, bv), **f32)
    rid = torch.empty((n, bv), **i32)
    parts = (0, 0, 0)
    if splits > 1:  # one set of planes per run of chunks, merged by the kernel
        l_part, rmax_part = torch.empty((2, splits, n, bv), **f32)
        rid_part = torch.empty((splits, n, bv), **i32)
        parts = (l_part.data_ptr(), rmax_part.data_ptr(), rid_part.data_ptr())
    err = getattr(_build.lib(), entry)(
        hidden.data_ptr(), weight.data_ptr(), *(x.data_ptr() for x in scale), bias32.data_ptr(),
        l.data_ptr(), rmax.data_ptr(), rid.data_ptr(), *parts,
        n, d, v, bv, splits, torch.cuda.current_stream(hidden.device).cuda_stream,
    )
    _build.check(err, entry)
    return bucket_finish(k, l, rmax, rid)


def check_bucket_f32(n: int, d: int, v: int, k: int, bv: int) -> None:
    """Raise on a shape the float32 bucket kernels do not take: they take
    any N, V and bucket width, D a multiple of 4 and 1 <= k <= bv."""
    if n < 1 or v < 1 or d < 4 or d % 4 or not 1 <= k <= bv:
        raise ValueError(f"mic_fused_head_bucket_f32: N={n}, D={d}, V={v}, k={k}, bv={bv}")


def _bucket_f32(hidden, weight, bias, k: int, route: int | None = None):
    """The float32 bucket select (csrc/fused_head_f32.cu) on the route
    ``bucket_f32_route`` picks (or ``route``): each run's planes, merged and
    finished in torch -> (lp, ids, lse)."""
    n, d = hidden.shape
    v = weight.shape[0]
    bv = bucket_width()
    if weight.shape != (v, d) or bias.shape != (v,):
        raise ValueError(f"mic_fused_head_bucket_f32: hidden {tuple(hidden.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}")
    check_bucket_f32(n, d, v, k, bv)
    bias32 = bias.float().contiguous()
    _check_operands("mic_fused_head_bucket_f32", hidden, weight, bias32)
    route = bucket_f32_route(n, d) if route is None else route
    splits = bucket_f32_splits(n, v, bv, _sms(hidden.device), route)
    f32 = dict(dtype=torch.float32, device=hidden.device)
    l, rmax = torch.empty((2, splits, n, bv), **f32)
    rid = torch.empty((splits, n, bv), dtype=torch.int32, device=hidden.device)
    # the tile's scratch for the hidden rows' TF32 hi and lo
    hsplit = torch.empty((2, n, d) if not route else (1,), **f32)
    err = _build.lib().mic_fused_head_bucket_f32(
        hidden.data_ptr(), weight.data_ptr(), bias32.data_ptr(), hsplit.data_ptr(),
        l.data_ptr(), rmax.data_ptr(), rid.data_ptr(), n, d, v, bv, splits, route,
        torch.cuda.current_stream(hidden.device).cuda_stream,
    )
    _build.check(err, "mic_fused_head_bucket_f32")
    return bucket_finish_runs(k, l, rmax, rid)


def fused_head_select(x, xscale, weight, wscale, bias, k: int, window: bool):
    """The exact/window select kernel on CUDA tensors: x (N, D) bf16 or
    float32 hidden with weight (V, D) of the same dtype (``xscale``,
    ``wscale`` None), or x int8 rows with xscale (N,) and weight int8 with
    wscale (V,) -> (lp (N, k) f32, ids (N, k) int32, lse (N, 1) f32)."""
    n, d = x.shape
    v = weight.shape[0]
    q8 = xscale is not None
    f32 = not q8 and x.dtype == torch.float32
    kind = "q8" if q8 else "f32" if f32 else "bf16"
    entry = f"mic_fused_head_select_{kind}"
    candidates = -(-v // WINDOW) if window else v
    if not 1 <= k <= _TOPK_MAX:
        raise ValueError(f"{entry}: k={k} outside 1..{_TOPK_MAX} (ROADMAP B41b)")
    fits = {"q8": d % 64 == 0 and select_q8_smem_bytes(d, k) <= SMEM_LIMIT,
            "f32": d % 4 == 0 and d >= 4 and select_f32_stages(k) >= 2,
            "bf16": d % 32 == 0 and select_bf16_stages(d, k) >= 2}[kind]
    if (weight.shape != (v, d) or bias.shape != (v,) or not fits or k > candidates):
        raise ValueError(f"{entry}: x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"bias {tuple(bias.shape)}, k={k}")
    want = {"q8": torch.int8, "f32": torch.float32, "bf16": torch.bfloat16}[kind]
    if x.dtype != want or weight.dtype != want:
        raise TypeError(f"{entry}: x and weight must be {want}")
    bias32 = bias.float().contiguous()
    scales = (xscale.float().contiguous(), wscale.float().contiguous()) if q8 else ()
    _check_operands(entry, x, weight, bias32, *scales)
    runs = select_runs(n, v, _sms(x.device), _Q8_SELECT_ROWS if q8 else _ROW_TILE)
    # the bf16 and f32 kernels' two warpgroups each write their state as a run
    entries = runs if q8 else 2 * runs
    if k > _TOPK_NARROW and entries > _MERGE_RUNS:
        raise ValueError(f"{entry}: {entries} runs exceed the wide merge's {_MERGE_RUNS}")
    fl = dict(dtype=torch.float32, device=x.device)
    part_m, part_l = torch.empty((2, entries, n), **fl)
    part_v = torch.empty((entries, n, k), **fl)
    part_i = torch.empty((entries, n, k), dtype=torch.int32, device=x.device)
    lp = torch.empty((n, k), **fl)
    ids = torch.empty((n, k), dtype=torch.int32, device=x.device)
    lse = torch.empty((n, 1), **fl)
    # a floor a row for the exact select's runs to share (csrc/fused_head.cu)
    row_floor = torch.empty((n,), dtype=torch.int32, device=x.device)
    if q8:
        operands = (x, scales[0], weight, scales[1], bias32)
    elif f32:  # with the kernel's scratch for the hidden rows' TF32 hi and lo
        operands = (x, weight, bias32, torch.empty((2, n, d), **fl))
    else:
        operands = (x, weight, bias32)
    err = getattr(_build.lib(), entry)(
        *(t.data_ptr() for t in operands),
        *(t.data_ptr() for t in (row_floor, part_m, part_l, part_v, part_i, lp, ids, lse)),
        n, d, v, k, runs, int(window), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, entry)
    fused_head_select.launches += 1
    return lp, ids, lse


fused_head_select.launches = 0


def _check_select(select: str) -> None:
    if select not in SELECTS:
        raise ValueError(f"unknown select {select!r}")


def fused_head_topk(hidden, weight, bias, k: int, select: str = "bucket"):
    """hidden (N, D), weight (V, D) tied embedding, bias (V,) ->
    (lp (N, k) f32, ids (N, k) int32, lse (N, 1) f32).  ``launches`` counts
    the bucket kernels (bf16, or float32 where hidden and weight are both
    float32); the exact/window kernels (bf16 or float32) count in
    ``fused_head_select.launches``."""
    _check_select(select)
    if hidden.device.type == "cpu":
        return fused_head_topk_plain(hidden, weight, bias, k, select)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_head_topk: unsupported device {hidden.device}")
    f32 = hidden.dtype == torch.float32 and weight.dtype == torch.float32
    if not f32 and (hidden.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16):
        raise TypeError("fused_head_topk kernel: hidden and weight must be both bfloat16 or "
                        "both float32")
    if select != "bucket":
        return fused_head_select(hidden, None, weight, None, bias, k, select == "window")
    out = (_bucket_f32(hidden, weight, bias, k) if f32 else
           _bucket_kernel("mic_fused_head_bucket_bf16", hidden, weight, None, bias, k))
    fused_head_topk.launches += 1
    return out


fused_head_topk.launches = 0  # both bucket kernels' launches


def fused_head_topk_q8(hidden, weight_q, weight_scale, bias, k: int, select: str = "bucket"):
    """hidden (N, D), weight_q (V, D) int8 tied embedding, weight_scale (V,)
    f32, bias (V,) -> (lp (N, k) f32, ids (N, k) int32, lse (N, 1) f32).
    ``launches`` counts the int8 bucket kernel; the exact/window kernel
    counts in ``fused_head_select.launches``."""
    _check_select(select)
    if hidden.device.type == "cpu":
        return fused_head_topk_q8_plain(hidden, weight_q, weight_scale, bias, k, select)
    if hidden.device.type != "cuda":
        raise ValueError(f"fused_head_topk_q8: unsupported device {hidden.device}")
    if weight_q.dtype != torch.int8:
        raise TypeError("fused_head_topk_q8 kernel: weight_q must be int8")
    if select != "bucket":
        xq, xs = quantize_rows_dynamic(hidden)
        return fused_head_select(xq, xs[:, 0], weight_q, weight_scale, bias, k,
                                 select == "window")
    out = _bucket_kernel("mic_fused_head_bucket_q8", hidden.to(torch.bfloat16).contiguous(),
                         weight_q, weight_scale, bias, k)
    fused_head_topk_q8.launches += 1
    return out


fused_head_topk_q8.launches = 0

"""Flash cross-entropy over the LM head's (V, D) table (training): the tied
shared embedding, or an untied ``lm_head`` kernel transposed.

Counterpart of mic_tpu/ops/flash_ce.py:

- ``flash_ce_forward``: per row of h @ emb^T + bias, (lse, label_logit,
  sum_logits), each (N,) f32.  The label logit is a gather of the label's
  table row and an f32 row dot, outside the kernel, as mic_tpu computes it.
  With ``save=True`` it also returns the logits: the first ``v_main``
  columns rounded to bf16 (N, v_main) and the ragged tail in f32, where
  ``v_main`` is mic_tpu's (``main_columns``); the statistics stay those of
  the non-saving call, bit for bit.
- ``flash_ce_backward_dl`` (routes "dl"): dl = (softmax - smoothed target)
  * rowscale as bf16 (N, V) plus exact f32 dbias, then dh = dl @ W and
  demb = dl^T @ h as GEMMs with f32 output over the bf16 dl, as mic_tpu
  runs them in XLA.
- ``flash_ce_backward`` (route "1"/"split"): two contractions, each
  recomputing the logits: grad-W writes each block of demb (V, D) f32 and
  dbias once, grad-h each block of dh once.  dl is rounded to the compute
  dtype before both, as in the dl route.
- ``flash_ce_backward_save`` (route "save"): the same two contractions from
  the saved bf16 logits, with no recompute; the ragged tail from the saved
  f32 tail logits in exact f32, as two GEMMs (plain products in mic_tpu too).
- ``flash_ce_contraction``: one of those contractions alone, on the card,
  for timing and tests.

Each reads the table in the compute dtype: ``emb_cast`` (the training
shadow, train/shadow.py, or an untied head's contiguous copy) when given,
else ``emb`` cast once, contiguous (a transposed view is copied).  Each takes its
plain version for tensors on the CPU.  On a CUDA device it launches the
kernels of csrc/flash_ce.cu, which never store f32 logits of the main
vocab span, or raises: they take bfloat16 with D a multiple of 64, at most
``_BWD_MAX_D`` for the split route's contractions (ROADMAP B36b).  A
float32 ``h`` (``CaptionerConfig.dtype`` "float32") takes D a multiple of 4
on every route: the forward, its saving form and dl run csrc/flash_ce_f32.cu
(the same walk on 3xTF32 ``wgmma``, float32-accurate logits; dl in float32,
its dh and demb products in full float32); the save and split routes'
contractions run csrc/flash_ce_bwd_f32.cu (3xTF32 ``mma.sync``), the save
route's from the saved bf16 logits, the split route's from the dl walk's
output a vocab chunk at a time (``_split_chunk`` columns, never the N x V).
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build
from mic_tpu_torch.ops.ln_gemm import ln_splits_f32

_ROW_TILE = 128   # hidden rows a block of csrc/flash_ce.cu's walk (walk::kRows)
_VOCAB_TILE = 256  # vocab columns a tile of the walk (walk::kCols)
_BWD_MAX_D = 1024  # the widest D the split contractions take (contract::kMaxGroups x 256)
_BOX = 64          # rows a sweep step, and own rows a split block (contract::kBox)
_CHUNK = 256       # D columns a consumer warpgroup owns (contract::kChunk)
_SAVE_ROWS = 128   # output rows a save block owns (contract::kSaveRows)
_PLAIN_ROWS = 1024  # rows per f32 logits chunk of the plain versions
_F32_TILE = 128   # vocab columns a tile of the float32 walk (kCols; 128 rows a block, too)
_SPLIT_DL_BYTES = 1 << 27  # the float32 split route's dl chunk: at most 128 MiB of f32


def _table(h, emb, emb_cast):
    return emb_cast if emb_cast is not None else emb.to(h.dtype).contiguous()


def _targets(label_smoothing: float, vocab: int):
    """(low, conf - low) as f32, the smoothed target being
    low + (conf - low) * onehot (mic_tpu/ops/flash_ce.py:712-713)."""
    conf = 1.0 - label_smoothing
    low = label_smoothing / (vocab - 1)
    return low, conf - low


def main_columns(vocab: int) -> int:
    """v_main of mic_tpu/ops/flash_ce.py::flash_ce_forward: the columns its
    save forward keeps as bf16, (V // vc) * vc with vc of ``_fwd_tiles``
    (2048, halved while it exceeds V, down to 128).  The rest is the f32 tail."""
    vc = 2048
    while vc > 128 and vocab < vc:
        vc //= 2
    return (vocab // vc) * vc


def _label_logit(h, w, bias_f, labels):
    rows = w[labels.long()]
    return (h.float() * rows.float()).sum(-1) + bias_f[labels.long()]


def flash_ce_forward_plain(h, emb, bias, labels, emb_cast=None, save=False):
    """f32 logits in row chunks, then the reductions; with ``save`` also
    (logits_main (N, v_main) bf16, tail (N, V - v_main) f32)."""
    w = _table(h, emb, emb_cast).float()
    bias_f = bias.float()
    v_main = main_columns(w.shape[0])
    lse, zsum, main, tail = [], [], [], []
    for i in range(0, h.shape[0], _PLAIN_ROWS):
        logits = h[i:i + _PLAIN_ROWS].float() @ w.T + bias_f
        lse.append(torch.logsumexp(logits, dim=-1))
        zsum.append(logits.sum(dim=-1))
        if save:
            main.append(logits[:, :v_main].bfloat16())
            tail.append(logits[:, v_main:])
    out = (torch.cat(lse), _label_logit(h, w, bias_f, labels), torch.cat(zsum))
    return out + (torch.cat(main), torch.cat(tail)) if save else out


def _runs(n: int, v: int, sms: int, cols: int = _VOCAB_TILE) -> int:
    """How many runs of consecutive ``cols``-wide vocab tiles a walk is cut
    into (the bf16 walk's 256, the float32 walk's 128): the (row tiles,
    runs) blocks, one an SM, in a single wave where the row tiles leave SMs
    over (at least one run, never more runs than tiles).  The blocks of a
    run are scheduled together (row tiles vary fastest) and walk the same
    vocab slices in step, so the table is read from device memory about
    once."""
    return max(1, min(-(-v // cols), sms // -(-n // _ROW_TILE)))


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_kernel_args(name, h, w, bias):
    """The kernels' arguments: bfloat16 with D a multiple of 64 (ROADMAP
    B36b), or float32 with D a multiple of 4."""
    n, d = h.shape
    v = w.shape[0]
    if h.dtype not in (torch.bfloat16, torch.float32) or w.dtype != h.dtype:
        raise TypeError(f"{name} kernel: hidden and table must be both bfloat16 or both float32")
    step = 4 if h.dtype == torch.float32 else 64
    if w.shape != (v, d) or bias.shape != (v,) or d % step:
        gate = " (bfloat16: ROADMAP B36b)" if step == 64 else ""
        raise ValueError(f"{name} kernel: hidden {tuple(h.shape)}, table {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)}; D must be a multiple of {step}{gate}")


def _f32_split(h):
    """Scratch for the float32 walk's hidden rows split into TF32 hi and lo:
    (2, N, D) f32, written by the kernel's entry before the walk."""
    return torch.empty((2, *h.shape), dtype=torch.float32, device=h.device)


def _check_pointers(name, device, *tensors):
    for x in tensors:
        if x.device != device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} kernel: tensors must be contiguous, "
                             "16-byte aligned and on one device")


def flash_ce_forward(h, emb, bias, labels, emb_cast=None, save=False):
    """h (N, D), emb (V, D), bias (V,), labels (N,) ->
    (lse, label_logit, sum_logits), each (N,) f32; with ``save`` also
    (logits_main (N, v_main) bf16, tail (N, V - v_main) f32).  Launches
    count in ``launches`` (statistics only) and ``save_launches``."""
    if h.device.type == "cpu":
        return flash_ce_forward_plain(h, emb, bias, labels, emb_cast, save)
    if h.device.type != "cuda":
        raise ValueError(f"flash_ce_forward: unsupported device {h.device}")
    w = _table(h, emb, emb_cast)
    _check_kernel_args("flash_ce_forward", h, w, bias)
    n, d = h.shape
    v = w.shape[0]
    bias_f = bias.float().contiguous()
    _check_pointers("flash_ce_forward", h.device, h, w, bias_f)
    f32 = h.dtype == torch.float32
    runs = _runs(n, v, _sms(h.device), _F32_TILE if f32 else _VOCAB_TILE)
    part = torch.empty((3, runs, n), dtype=torch.float32, device=h.device)
    lse, zsum = torch.empty((2, n), dtype=torch.float32, device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    hsplit = _f32_split(h) if f32 else None
    args = (h.data_ptr(), w.data_ptr(), bias_f.data_ptr(),
            *((hsplit.data_ptr(),) if f32 else ()),
            part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
            lse.data_ptr(), zsum.data_ptr())
    if not save:
        entry = "mic_flash_ce_fwd_f32" if f32 else "mic_flash_ce_fwd_bf16"
        err = getattr(_build.lib(), entry)(*args, n, d, v, runs, stream)
        _build.check(err, entry)
        flash_ce_forward.launches += 1
        return lse, _label_logit(h, w, bias_f, labels), zsum
    v_main = main_columns(v)
    logits_main = torch.empty((n, v_main), dtype=torch.bfloat16, device=h.device)
    tail = torch.empty((n, v - v_main), dtype=torch.float32, device=h.device)
    entry = "mic_flash_ce_fwd_save_f32" if f32 else "mic_flash_ce_fwd_save_bf16"
    err = getattr(_build.lib(), entry)(
        *args, logits_main.data_ptr(), tail.data_ptr(), n, d, v, v_main, runs, stream)
    _build.check(err, entry)
    flash_ce_forward.save_launches += 1
    return lse, _label_logit(h, w, bias_f, labels), zsum, logits_main, tail


flash_ce_forward.launches = 0  # both dtypes' statistics kernels
flash_ce_forward.save_launches = 0


def dlogits(p, labels, rowscale, label_smoothing, vocab=None, col0=0):
    """(p - smoothed target) * rowscale from the f32 softmax p (C, W) of a
    chunk of rows over columns col0..col0+W of a V-wide vocab (``vocab``,
    by default W), in mic_tpu's order of rounding, with no (C, W) one-hot."""
    low, conf_low = _targets(label_smoothing, p.shape[1] if vocab is None else vocab)
    t_label = torch.tensor(low, dtype=torch.float32) + torch.tensor(conf_low, dtype=torch.float32)
    y = labels.long()[:, None] - col0
    hit = (y >= 0) & (y < p.shape[1])
    y = y.clamp(0, p.shape[1] - 1)
    d = p - low
    d.scatter_(1, y, torch.where(hit, p.gather(1, y) - t_label, d.gather(1, y)))
    return d * rowscale[:, None]


def _dl_plain(h, w, bias, labels, lse, rowscale, label_smoothing):
    """dl in f32 from the plain f32 logits, row chunk by row chunk."""
    wf, bias_f = w.float(), bias.float()
    out = []
    for i in range(0, h.shape[0], _PLAIN_ROWS):
        rows = slice(i, i + _PLAIN_ROWS)
        p = torch.exp(h[rows].float() @ wf.T + bias_f - lse[rows, None])
        out.append(dlogits(p, labels[rows], rowscale[rows], label_smoothing))
    return torch.cat(out)


def _dl_gemms(dl, w, h):
    """dh = dl @ W and demb = dl^T @ h with f32 output from dl: bf16
    operands with f32 output, or float32 ones in full float32 (TF32 off for
    the two products, whatever the process has set)."""
    if dl.device.type != "cuda":
        return dl.float() @ w.float(), dl.float().T @ h.float()
    if dl.dtype != torch.float32:
        return (torch.mm(dl, w, out_dtype=torch.float32),
                torch.mm(dl.T, h, out_dtype=torch.float32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.mm(dl, w), torch.mm(dl.T, h)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def flash_ce_dl_plain(h, emb, bias, labels, lse, rowscale, label_smoothing, emb_cast=None):
    """-> (dl (N, V) in h.dtype, dbias (V,) f32), dl rounded from f32."""
    dl32 = _dl_plain(h, _table(h, emb, emb_cast), bias, labels, lse, rowscale, label_smoothing)
    return dl32.to(h.dtype), dl32.sum(dim=0)


def flash_ce_dl(h, emb, bias, labels, lse, rowscale, label_smoothing, emb_cast=None, out=None):
    """The dl kernel alone: -> (dl (N, V) bf16, dbias (V,) f32).  ``out``, a
    contiguous (N, V) bf16 tensor, receives dl when given."""
    if h.device.type == "cpu":
        return flash_ce_dl_plain(h, emb, bias, labels, lse, rowscale, label_smoothing, emb_cast)
    if h.device.type != "cuda":
        raise ValueError(f"flash_ce_dl: unsupported device {h.device}")
    w = _table(h, emb, emb_cast)
    _check_kernel_args("flash_ce_dl", h, w, bias)
    n, d = h.shape
    v = w.shape[0]
    bias_f = bias.float().contiguous()
    labels32 = labels.to(torch.int32).contiguous()
    lse32 = lse.float().contiguous()
    rs32 = rowscale.float().contiguous()
    dl = torch.empty((n, v), dtype=h.dtype, device=h.device) if out is None else out
    if dl.shape != (n, v) or dl.dtype != h.dtype:
        raise ValueError(f"flash_ce_dl: out must be ({n}, {v}) {h.dtype}")
    _check_pointers("flash_ce_dl", h.device, h, w, bias_f, labels32, lse32, rs32, dl)
    f32 = h.dtype == torch.float32
    runs = _runs(n, v, _sms(h.device), _F32_TILE if f32 else _VOCAB_TILE)
    # both walks take 128 rows a block: one band of dbias partials each
    bands = torch.empty((-(-n // _ROW_TILE), v), dtype=torch.float32, device=h.device)
    dbias = torch.empty((v,), dtype=torch.float32, device=h.device)
    low, conf_low = _targets(label_smoothing, v)
    entry = "mic_flash_ce_dl_f32" if f32 else "mic_flash_ce_dl_bf16"
    hsplit = _f32_split(h) if f32 else None
    err = getattr(_build.lib(), entry)(
        h.data_ptr(), w.data_ptr(), bias_f.data_ptr(),
        *((hsplit.data_ptr(),) if f32 else ()), labels32.data_ptr(),
        lse32.data_ptr(), rs32.data_ptr(), dl.data_ptr(), bands.data_ptr(),
        dbias.data_ptr(), low, conf_low, n, d, v, runs,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(err, entry)
    flash_ce_backward_dl.launches += 1
    return dl, dbias


def flash_ce_backward_dl_plain(h, emb, bias, labels, lse, rowscale, label_smoothing,
                               emb_cast=None):
    w = _table(h, emb, emb_cast)
    dl, dbias = flash_ce_dl_plain(h, w, bias, labels, lse, rowscale, label_smoothing)
    dh, demb = _dl_gemms(dl, w, h)
    return dh.to(h.dtype), demb, dbias


def flash_ce_backward_dl(h, emb, bias, labels, lse, rowscale, label_smoothing,
                         emb_cast=None):
    """-> (dh (N, D) in h.dtype, demb (V, D) f32, dbias (V,) f32).  rowscale
    (N,) f32 = mask * g / denom folds the loss scale into each row.  The
    kernel's launches are counted on this function."""
    if h.device.type == "cpu":
        return flash_ce_backward_dl_plain(h, emb, bias, labels, lse, rowscale,
                                          label_smoothing, emb_cast)
    w = _table(h, emb, emb_cast)
    dl, dbias = flash_ce_dl(h, w, bias, labels, lse, rowscale, label_smoothing)
    dh, demb = _dl_gemms(dl, w, h)
    return dh.to(h.dtype), demb, dbias


flash_ce_backward_dl.launches = 0


def _check_backward_args(name, h, w, bias, split=True):
    """The contractions' arguments, as ``_check_kernel_args``; the bfloat16
    split contractions keep 64 rows over the whole D in shared memory, so
    they also need D <= _BWD_MAX_D (ROADMAP B36b).  The float32 ones stream
    D and take any multiple of 4."""
    _check_kernel_args(name, h, w, bias)
    if split and h.dtype == torch.bfloat16 and h.shape[1] > _BWD_MAX_D:
        raise ValueError(f"{name} kernel: D={h.shape[1]} exceeds {_BWD_MAX_D} (bfloat16: "
                         "ROADMAP B36b)")


def _contraction_grid(part, saved, n, vext, d, sms):
    """The blocks of one contraction kernel of csrc/flash_ce.cu, as
    (D blocks, output-row tiles, sweep parts), D blocks fastest.  A consumer
    warpgroup owns a 256-wide D chunk: a save block one chunk and 128 output
    rows, a split block two chunks (the second repeats the first past D) and
    64 output rows.  The output rows are hidden rows for "grad_h", the vocab
    columns [0, vext) for "grad_w"; each block sweeps the other axis in
    64-row steps, part z of `parts` taking steps [z S / parts, (z + 1) S /
    parts).  grad-h at small N fills the SMs its row tiles leave idle with
    parts of the vocab sweep (at most one a step), summed in part order
    afterwards; grad-W has vext / 64 or more blocks and one part."""
    chunks = -(-d // _CHUNK)
    dblocks, rows = (chunks, _SAVE_ROWS) if saved else (-(-chunks // 2), _BOX)
    m, k = (n, vext) if part == "grad_h" else (vext, n)
    tiles, steps = -(-m // rows), -(-k // _BOX)
    parts = max(1, min(steps, sms // (dblocks * tiles))) if part == "grad_h" else 1
    return dblocks, tiles, parts


_CONTRACTIONS = {"grad_w": "mic_flash_ce_gw_bf16", "grad_h": "mic_flash_ce_gh_bf16"}


def _contract(part, h, w, bias_f, labels32, lse32, rs32, label_smoothing, logits, out,
              dbias=None):
    """One backward contraction of csrc/flash_ce.cu over the logits of
    columns 0..vext: recomputed over V = vext columns (``logits`` None) or
    read from the saved (N, vext) bf16.  "grad_w" writes demb into out
    (vext, D) f32 and dbias (vext,) f32; "grad_h" writes dh into out (N, D)
    f32, through (parts, N, D) f32 partials where _contraction_grid cuts
    its vocab sweep."""
    n, d = h.shape
    saved = logits is not None
    vext = logits.shape[1] if saved else w.shape[0]
    f32 = h.dtype == torch.float32
    entry = "mic_flash_ce_contract_f32" if f32 else _CONTRACTIONS[part]
    _check_pointers(entry, h.device, h, w, bias_f, labels32, lse32, rs32, out,
                    *(x for x in (logits, dbias) if x is not None))
    if f32:  # the save route's main span (the split route's run in _split_f32)
        _contract_f32(part, logits, vext, h if part == "grad_w" else w, lse32, rs32, labels32,
                      out, dbias, label_smoothing, w.shape[0], n)
        return
    low, conf_low = _targets(label_smoothing, w.shape[0])
    operands = (h.data_ptr(), w.data_ptr(), bias_f.data_ptr(), logits.data_ptr() if saved else 0,
                labels32.data_ptr(), lse32.data_ptr(), rs32.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if part == "grad_w":
        err = _build.lib().mic_flash_ce_gw_bf16(*operands, dbias.data_ptr(), low, conf_low, n, d,
                                                vext, int(saved), stream)
    else:
        parts = _contraction_grid(part, saved, n, vext, d, _sms(h.device))[2]
        scratch = (torch.empty((parts, n, d), dtype=torch.float32, device=h.device)
                   if parts > 1 else None)
        err = _build.lib().mic_flash_ce_gh_bf16(
            *operands, scratch.data_ptr() if parts > 1 else 0, low, conf_low, n, d, vext,
            int(saved), parts, stream)
    _build.check(err, entry)


def _contract_f32(part, src, vext, b, lse32, rs32, labels32, out, dbias, label_smoothing, vocab,
                  n, accumulate=False):
    """One float32 contraction of csrc/flash_ce_bwd_f32.cu over a span of
    ``vext`` vocab columns of ``src``: the saved (N, >= vext) bf16 logits,
    or an (N, >= vext) f32 dl chunk (then lse, rowscale and labels are not
    read).  "grad_w": demb (vext, D) into ``out`` from b = h, and dbias
    (vext,) where given; "grad_h": dh (N, D) into ``out`` (added to it where
    ``accumulate``) from b = the table's rows of the span, its depth cut by
    ln_splits_f32 where its 128 x 96 tiles leave SMs idle."""
    d = b.shape[1]
    grad_w = part == "grad_w"
    splits = 1 if grad_w else ln_splits_f32(n, vext, d, _sms(b.device))
    scratch = (torch.empty((splits, n, d), dtype=torch.float32, device=b.device)
               if splits > 1 else None)
    saved = src.dtype == torch.bfloat16
    low, conf_low = _targets(label_smoothing, vocab)
    err = _build.lib().mic_flash_ce_contract_f32(
        src.data_ptr(), int(saved), src.stride(0), b.data_ptr(), lse32.data_ptr(),
        rs32.data_ptr(), labels32.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else 0,
        dbias.data_ptr() if dbias is not None else 0, low, conf_low, n, d, vext, int(grad_w),
        int(accumulate), splits, torch.cuda.current_stream(b.device).cuda_stream)
    _build.check(err, "mic_flash_ce_contract_f32")


def _split_chunk(n: int, v: int) -> int:
    """The float32 split route's vocab chunk: as many columns (a multiple
    of 128) as an (N, chunk) f32 dl of _SPLIT_DL_BYTES holds, at least 128,
    at most V rounded up to 128.  8192 at the flagship step's N = 4096."""
    cols = max(_F32_TILE, _SPLIT_DL_BYTES // (4 * n) // _F32_TILE * _F32_TILE)
    return min(cols, -(-v // _F32_TILE) * _F32_TILE)


def _split_f32(h, w, bias_f, labels32, lse32, rs32, label_smoothing, chunk=None):
    """The float32 split route on the card: -> (dh, demb, dbias) f32.  A
    vocab chunk at a time, the dl walk of csrc/flash_ce_f32.cu recomputes
    the chunk's logits on the 3xTF32 tile and writes its f32 dl and dbias,
    then grad-W writes its demb rows and grad-h adds its part of dh."""
    n, d = h.shape
    v = w.shape[0]
    chunk = chunk or _split_chunk(n, v)
    f32 = dict(dtype=torch.float32, device=h.device)
    dh, demb, dbias = torch.empty((n, d), **f32), torch.empty((v, d), **f32), torch.empty(v, **f32)
    _check_pointers("flash_ce_backward", h.device, h, w, bias_f, labels32, lse32, rs32, dh, demb,
                    dbias)
    dl = torch.empty((n, chunk), **f32)
    bands = torch.empty((-(-n // _ROW_TILE), chunk), **f32)
    hsplit = _f32_split(h)
    low, conf_low = _targets(label_smoothing, v)
    sms, stream = _sms(h.device), torch.cuda.current_stream(h.device).cuda_stream
    lib = _build.lib()
    for c0 in range(0, v, chunk):
        vc = min(chunk, v - c0)
        err = lib.mic_flash_ce_dl_chunk_f32(
            h.data_ptr() if c0 == 0 else 0, w[c0].data_ptr(), bias_f[c0:].data_ptr(),
            hsplit.data_ptr(), labels32.data_ptr(), lse32.data_ptr(), rs32.data_ptr(),
            dl.data_ptr(), bands.data_ptr(), dbias[c0:].data_ptr(), low, conf_low, n, d, vc,
            chunk, c0, _runs(n, vc, sms, _F32_TILE), stream)
        _build.check(err, "mic_flash_ce_dl_chunk_f32")
        _contract_f32("grad_w", dl, vc, h, lse32, rs32, labels32, demb[c0:c0 + vc], None,
                      label_smoothing, v, n)
        _contract_f32("grad_h", dl, vc, w[c0:c0 + vc], lse32, rs32, labels32, dh, None,
                      label_smoothing, v, n, accumulate=c0 > 0)
    return dh, demb, dbias


def _backward_operands(name, h, emb, bias, labels, lse, rowscale, emb_cast, logits_main=None):
    """-> (table, bias f32, labels int32, lse f32, rowscale f32), checked."""
    if h.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {h.device}")
    w = _table(h, emb, emb_cast)
    _check_backward_args(name, h, w, bias, split=logits_main is None)
    if logits_main is not None and (logits_main.dtype != torch.bfloat16
                                    or logits_main.shape[0] != h.shape[0]
                                    or not 0 <= logits_main.shape[1] <= w.shape[0]
                                    or logits_main.shape[1] % 128):
        raise ValueError(f"{name}: logits_main {tuple(logits_main.shape)} {logits_main.dtype} "
                         f"for N={h.shape[0]}, V={w.shape[0]}")
    return (w, bias.float().contiguous(), labels.to(torch.int32).contiguous(),
            lse.float().contiguous(), rowscale.float().contiguous())


def flash_ce_contraction(part, h, emb, bias, labels, lse, rowscale, label_smoothing,
                         emb_cast=None, logits_main=None):
    """One contraction kernel of the split route (``logits_main`` None) or
    of the save route's main span, alone, on the card: "grad_w" -> (demb,
    dbias) over those columns, "grad_h" -> dh (N, D) f32.  For timing and
    tests; it counts no launch (the route functions below count theirs)."""
    ops = _backward_operands(f"flash_ce_contraction {part}", h, emb, bias, labels, lse,
                             rowscale, emb_cast, logits_main)
    if h.dtype == torch.float32 and logits_main is None:
        raise ValueError("flash_ce_contraction: the float32 split route's contractions read "
                         "the dl walk's chunks and do not run alone")
    if logits_main is not None:
        logits_main = logits_main.contiguous()
    vext = ops[0].shape[0] if logits_main is None else logits_main.shape[1]
    f32 = dict(dtype=torch.float32, device=h.device)
    if part == "grad_h":
        dh = torch.empty(h.shape, **f32)
        _contract(part, h, *ops, label_smoothing, logits_main, dh)
        return dh
    demb, dbias = torch.empty((vext, h.shape[1]), **f32), torch.empty(vext, **f32)
    _contract(part, h, *ops, label_smoothing, logits_main, demb, dbias)
    return demb, dbias


def flash_ce_backward(h, emb, bias, labels, lse, rowscale, label_smoothing, emb_cast=None):
    """The split route's backward (mic_tpu ::flash_ce_backward): -> (dh (N, D)
    in h.dtype, demb (V, D) f32, dbias (V,) f32), grad-W and grad-h each
    recomputing the logits.  One call, two kernels, counted once in
    ``launches``.  Its plain version is the dl route's,
    ``flash_ce_backward_dl_plain``: the same function (dl from the f32
    logits, rounded to h.dtype before both contractions; mic_tpu :349-353,
    :386)."""
    if h.device.type == "cpu":
        return flash_ce_backward_dl_plain(h, emb, bias, labels, lse, rowscale, label_smoothing,
                                          emb_cast)
    ops = _backward_operands("flash_ce_backward", h, emb, bias, labels, lse, rowscale, emb_cast)
    if h.dtype == torch.float32:
        dh, demb, dbias = _split_f32(h, *ops[:5], label_smoothing)
        flash_ce_backward.launches += 1
        return dh, demb, dbias
    n, d = h.shape
    v = ops[0].shape[0]
    f32 = dict(dtype=torch.float32, device=h.device)
    dh, demb, dbias = torch.empty((n, d), **f32), torch.empty((v, d), **f32), torch.empty(v, **f32)
    _contract("grad_w", h, *ops, label_smoothing, None, demb, dbias)
    _contract("grad_h", h, *ops, label_smoothing, None, dh)
    flash_ce_backward.launches += 1
    return dh.to(h.dtype), demb, dbias


flash_ce_backward.launches = 0


def _add_saved_block(dh, demb, dbias, block, col0, h, w, labels, lse, rowscale,
                     label_smoothing):
    """The plain contractions of the saved logits of columns col0.. (bf16
    main or f32 tail): dl in f32 as mic_tpu's save backward forms it
    (:511-516, :681-684), row chunk by row chunk, rounded to h.dtype before
    both GEMMs; adds to dh (N, D) f32 and writes those columns' demb rows
    and dbias entries."""
    cols = slice(col0, col0 + block.shape[1])
    dl32 = torch.cat([
        dlogits(torch.exp(block[i:i + _PLAIN_ROWS].float() - lse[i:i + _PLAIN_ROWS, None]),
                labels[i:i + _PLAIN_ROWS], rowscale[i:i + _PLAIN_ROWS], label_smoothing,
                w.shape[0], col0)
        for i in range(0, h.shape[0], _PLAIN_ROWS)])
    dh_b, demb[cols] = _dl_gemms(dl32.to(h.dtype), w[cols], h)
    dh += dh_b
    dbias[cols] = dl32.sum(dim=0)


def flash_ce_backward_save_plain(h, emb, bias, labels, lse, rowscale, label_smoothing,
                                 emb_cast=None, logits_main=None, tail=None):
    """dl from the saved logits, rounded to h.dtype; the contractions of the
    main span and of the tail added in f32."""
    w = _table(h, emb, emb_cast)
    n, d = h.shape
    v = w.shape[0]
    dh = torch.zeros((n, d), dtype=torch.float32, device=h.device)
    demb = torch.empty((v, d), dtype=torch.float32, device=h.device)
    dbias = torch.empty((v,), dtype=torch.float32, device=h.device)
    for block, col0 in ((logits_main, 0), (tail, logits_main.shape[1])):
        if block.shape[1]:
            _add_saved_block(dh, demb, dbias, block, col0, h, w, labels, lse, rowscale,
                             label_smoothing)
    return dh.to(h.dtype), demb, dbias


def flash_ce_backward_save(h, emb, bias, labels, lse, rowscale, label_smoothing, emb_cast=None,
                           logits_main=None, tail=None):
    """The save route's backward (mic_tpu ::flash_ce_backward_save), from the
    forward's saved (logits_main (N, v_main) bf16, tail (N, V - v_main) f32):
    -> (dh (N, D) in h.dtype, demb (V, D) f32, dbias (V,) f32).  The main
    span's two kernels count once in ``launches`` (none when v_main is 0);
    the tail is the plain version's step, two f32-output GEMMs over its
    bf16 dl."""
    if h.device.type == "cpu":
        return flash_ce_backward_save_plain(h, emb, bias, labels, lse, rowscale,
                                            label_smoothing, emb_cast, logits_main, tail)
    w, bias_f, labels32, lse32, rs32 = _backward_operands(
        "flash_ce_backward_save", h, emb, bias, labels, lse, rowscale, emb_cast, logits_main)
    n, d = h.shape
    v, v_main = w.shape[0], logits_main.shape[1]
    if tail.shape != (n, v - v_main):
        raise ValueError(f"flash_ce_backward_save: tail {tuple(tail.shape)} for N={n}, V={v}, "
                         f"v_main={v_main}")
    f32 = dict(dtype=torch.float32, device=h.device)
    dh = torch.zeros((n, d), **f32)
    demb, dbias = torch.empty((v, d), **f32), torch.empty(v, **f32)
    if v_main:
        ops = (h, w, bias_f, labels32, lse32, rs32, label_smoothing, logits_main.contiguous())
        _contract("grad_w", *ops, demb[:v_main], dbias[:v_main])
        _contract("grad_h", *ops, dh)
        flash_ce_backward_save.launches += 1
    if v_main < v:
        _add_saved_block(dh, demb, dbias, tail, v_main, h, w, labels32, lse32, rs32,
                         label_smoothing)
    return dh.to(h.dtype), demb, dbias


flash_ce_backward_save.launches = 0

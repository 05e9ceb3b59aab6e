"""Flash cross-entropy over the tied LM head (training).

Counterpart of mic_tpu/ops/flash_ce.py's default pair:

- ``flash_ce_forward``: per row of h @ emb^T + bias, (lse, label_logit,
  sum_logits), each (N,) f32.  The label logit is a gather of the label's
  table row and an f32 row dot, outside the kernel, as mic_tpu computes it.
- ``flash_ce_backward_dl``: dl = (softmax - smoothed target) * rowscale as
  bf16 (N, V) plus exact f32 dbias, then dh = dl @ W and demb = dl^T @ h as
  GEMMs with f32 output over the bf16 dl, as mic_tpu runs them in XLA.

Both read the table in the compute dtype: ``emb_cast`` (the training
shadow, train/shadow.py) when given, else ``emb`` cast once.  Each takes its
plain version for tensors on the CPU.  On a CUDA device it launches the
kernel of csrc/flash_ce.cu, which never stores f32 logits, or raises: the
kernels take bfloat16 only, so a float32 ``h`` (``CaptionerConfig.dtype``
"float32") raises NotImplementedError.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build

_ROW_TILE = 64   # hidden rows per block of csrc/flash_ce.cu (kBM)
_VOCAB_TILE = 64  # vocab columns per tile (kBN)
_PLAIN_ROWS = 1024  # rows per f32 logits chunk of the plain versions


def _table(h, emb, emb_cast):
    return emb_cast if emb_cast is not None else emb.to(h.dtype)


def _targets(label_smoothing: float, vocab: int):
    """(low, conf - low) as f32, the smoothed target being
    low + (conf - low) * onehot (mic_tpu/ops/flash_ce.py:712-713)."""
    conf = 1.0 - label_smoothing
    low = label_smoothing / (vocab - 1)
    return low, conf - low


def _label_logit(h, w, bias_f, labels):
    rows = w[labels.long()]
    return (h.float() * rows.float()).sum(-1) + bias_f[labels.long()]


def flash_ce_forward_plain(h, emb, bias, labels, emb_cast=None):
    """f32 logits in row chunks, then the reductions."""
    w = _table(h, emb, emb_cast).float()
    bias_f = bias.float()
    lse, zsum = [], []
    for i in range(0, h.shape[0], _PLAIN_ROWS):
        logits = h[i:i + _PLAIN_ROWS].float() @ w.T + bias_f
        lse.append(torch.logsumexp(logits, dim=-1))
        zsum.append(logits.sum(dim=-1))
    return torch.cat(lse), _label_logit(h, w, bias_f, labels), torch.cat(zsum)


def _runs(n: int, v: int, device: torch.device) -> int:
    """How many consecutive runs the vocab walk is cut into: enough blocks
    for two waves at three blocks an SM, never more runs than tiles."""
    row_tiles = -(-n // _ROW_TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-v // _VOCAB_TILE), -(-6 * sms // row_tiles)))


def _check_kernel_args(name, h, w, bias):
    n, d = h.shape
    v = w.shape[0]
    if h.dtype == torch.float32:
        raise NotImplementedError(
            f"{name}: no float32 kernel yet; train with CaptionerConfig.dtype='bfloat16'"
        )
    if h.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel: hidden and table must be bfloat16")
    if w.shape != (v, d) or bias.shape != (v,) or d % 64:
        raise ValueError(f"{name} kernel: hidden {tuple(h.shape)}, table {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)}; D must be a multiple of 64")


def _check_pointers(name, device, *tensors):
    for x in tensors:
        if x.device != device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} kernel: tensors must be contiguous, "
                             "16-byte aligned and on one device")


def flash_ce_forward(h, emb, bias, labels, emb_cast=None):
    """h (N, D), emb (V, D), bias (V,), labels (N,) ->
    (lse, label_logit, sum_logits), each (N,) f32."""
    if h.device.type == "cpu":
        return flash_ce_forward_plain(h, emb, bias, labels, emb_cast)
    if h.device.type != "cuda":
        raise ValueError(f"flash_ce_forward: unsupported device {h.device}")
    w = _table(h, emb, emb_cast)
    _check_kernel_args("flash_ce_forward", h, w, bias)
    n, d = h.shape
    v = w.shape[0]
    bias_f = bias.float().contiguous()
    _check_pointers("flash_ce_forward", h.device, h, w, bias_f)
    runs = _runs(n, v, h.device)
    part = torch.empty((3, runs, n), dtype=torch.float32, device=h.device)
    lse, zsum = torch.empty((2, n), dtype=torch.float32, device=h.device)
    err = _build.lib().mic_flash_ce_fwd_bf16(
        h.data_ptr(), w.data_ptr(), bias_f.data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
        lse.data_ptr(), zsum.data_ptr(), n, d, v, runs,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(err, "mic_flash_ce_fwd_bf16")
    flash_ce_forward.launches += 1
    return lse, _label_logit(h, w, bias_f, labels), zsum


flash_ce_forward.launches = 0


def dlogits(p, labels, rowscale, label_smoothing):
    """(p - smoothed target) * rowscale from the f32 softmax p (C, V) of a
    chunk of rows, in mic_tpu's order of rounding, with no (C, V) one-hot."""
    low, conf_low = _targets(label_smoothing, p.shape[1])
    t_label = torch.tensor(low, dtype=torch.float32) + torch.tensor(conf_low, dtype=torch.float32)
    y = labels[:, None].long()
    d = p - low
    d.scatter_(1, y, p.gather(1, y) - t_label)
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
    """dh = dl @ W and demb = dl^T @ h with f32 output from the bf16 dl."""
    if dl.device.type == "cuda":
        return (torch.mm(dl, w, out_dtype=torch.float32),
                torch.mm(dl.T, h, out_dtype=torch.float32))
    return dl.float() @ w.float(), dl.float().T @ h.float()


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
    runs = _runs(n, v, h.device)
    bands = torch.empty((-(-n // _ROW_TILE), v), dtype=torch.float32, device=h.device)
    dbias = torch.empty((v,), dtype=torch.float32, device=h.device)
    low, conf_low = _targets(label_smoothing, v)
    err = _build.lib().mic_flash_ce_dl_bf16(
        h.data_ptr(), w.data_ptr(), bias_f.data_ptr(), labels32.data_ptr(),
        lse32.data_ptr(), rs32.data_ptr(), dl.data_ptr(), bands.data_ptr(),
        dbias.data_ptr(), low, conf_low, n, d, v, runs,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(err, "mic_flash_ce_dl_bf16")
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

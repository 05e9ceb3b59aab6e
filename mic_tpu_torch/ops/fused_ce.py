"""Label-smoothed cross-entropy fused with the LM head
(mic_tpu/ops/fused_ce.py::fused_lm_loss): the loss of lm_logits +
train/loss.py without a (B, T, V) logits tensor, as a
``torch.autograd.Function`` whose backward recomputes what it needs.  The
head is any (V, D) table: the tied shared embedding, or an untied
``lm_head`` kernel transposed (train/shadow.py::ce_table).

Routes (``mode``, TrainConfig.flash_ce; the environment variable
MIC_TPU_FLASH_CE wins when set, through core/knobs.py::override), each as
mic_tpu's ``_fwd_impl`` and ``_fused_bwd`` route it:

- "" ("0", "off"; what "auto" resolves to on the CPU): the chunked path.
  Each chunk of rows gets its f32 logits from the f32 table, reduced and
  dropped; the backward recomputes them chunk by chunk.
- "fwd": ops/flash_ce.py's forward kernel, then the chunked backward (the
  forward's lse is not kept).
- "1" ("split"): the forward kernel, then ``flash_ce_backward``'s two
  contractions, each recomputing the logits, at any row count.
- "dl" (what "auto" resolves to on CUDA): the forward kernel, which saves
  lse; the backward's dl kernel with rowscale = mask * g / denom.  Above
  ``dl_max_rows`` rows the backward takes the chunked path instead, as
  mic_tpu routes it (its bf16 (N, V) dl would not fit); the dl kernel's
  launch counter then stays where it was.
- "save": the forward kernel also stores the logits (bf16 main span, f32
  tail), and ``flash_ce_backward_save`` contracts them with no recompute.
  Above ``dl_max_rows`` rows the forward saves nothing and the backward
  takes the chunked path, as mic_tpu's does.

The flash routes read ``emb_cast`` (the table in the compute dtype, e.g.
the bf16 training shadow) when given; ``embedding`` always receives the
f32 demb, cast to its dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from mic_tpu_torch.core.knobs import override
from mic_tpu_torch.ops.flash_ce import (
    dlogits,
    flash_ce_backward,
    flash_ce_backward_dl,
    flash_ce_backward_save,
    flash_ce_forward,
)


def _resolve_mode(mode: str, device: torch.device) -> str:
    raw = override("MIC_TPU_FLASH_CE")
    if raw is not None:
        mode = raw
    if mode in ("", "0", "off"):
        return ""
    if mode == "auto":
        return "dl" if device.type == "cuda" else ""
    if mode == "split":
        return "1"
    if mode in ("fwd", "1", "dl", "save"):
        return mode
    raise ValueError(f"unknown flash-CE mode {mode!r}")


def normalizing(label_smoothing: float, vocab: int) -> float:
    """The smoothed target's entropy, in float32 as mic_tpu computes it."""
    if label_smoothing <= 0.0:
        return 0.0
    f32 = np.float32
    conf = 1.0 - label_smoothing
    low = label_smoothing / (vocab - 1)
    return float(-(f32(conf) * np.log(f32(conf))
                   + f32((vocab - 1) * low) * np.log(f32(low + 1e-20))))


def expected_logit(label_logit, sum_logits, label_smoothing: float, vocab: int):
    """The smoothed target's expected logit, c * z_y + l * (sum_z - z_y)."""
    if label_smoothing <= 0.0:
        return label_logit
    conf = 1.0 - label_smoothing
    low = label_smoothing / (vocab - 1)
    return conf * label_logit + low * (sum_logits - label_logit)


def _chunked_forward(h2, embedding, bias, labels, m2, label_smoothing, chunk):
    vocab = embedding.shape[0]
    emb, bias_f = embedding.float(), bias.float()
    loss_sum = torch.zeros((), dtype=torch.float32, device=h2.device)
    for i in range(0, h2.shape[0], chunk):
        logits = h2[i:i + chunk].float() @ emb.T + bias_f
        mx = logits.amax(dim=-1)
        lse = mx + torch.log(torch.exp(logits - mx[:, None]).sum(dim=-1))
        label_logit = logits.gather(1, labels[i:i + chunk, None].long())[:, 0]
        sum_logits = logits.sum(dim=-1) if label_smoothing > 0.0 else None
        expected = expected_logit(label_logit, sum_logits, label_smoothing, vocab)
        loss_sum = loss_sum + ((lse - expected) * m2[i:i + chunk]).sum()
    return loss_sum


def _chunked_backward(h2, embedding, bias, labels, rowscale, label_smoothing, chunk):
    """(dh in h2.dtype, demb f32, dbias f32), as mic_tpu's chunked backward:
    dl rounded to the compute dtype before both contractions, dh against
    the f32 table."""
    emb, bias_f = embedding.float(), bias.float()
    demb = torch.zeros_like(emb)
    dbias = torch.zeros_like(bias_f)
    dh = []
    for i in range(0, h2.shape[0], chunk):
        h_c = h2[i:i + chunk]
        p = torch.softmax(h_c.float() @ emb.T + bias_f, dim=-1)
        d32 = dlogits(p, labels[i:i + chunk], rowscale[i:i + chunk], label_smoothing)
        dl = d32.to(h2.dtype).float()
        dh.append((dl @ emb).to(h2.dtype))
        demb += dl.T @ h_c.float()
        dbias += d32.sum(dim=0)
    return torch.cat(dh), demb, dbias


def _forward(h2, embedding, bias, y, m2, label_smoothing, chunk, emb_cast, flash, max_rows):
    """mic_tpu's _fwd_impl on (N, D) rows -> (loss_sum, lse, saved): lse kept
    for the routes whose backward reads it, saved = (logits_main, tail) only
    from the save forward, which runs at N <= max_rows alone."""
    n = h2.shape[0]
    vocab = embedding.shape[0]
    if not flash:
        loss_sum = _chunked_forward(h2, embedding, bias, y, m2, label_smoothing, min(chunk, n))
        return loss_sum, None, None
    saved = None
    if flash == "save" and n <= max_rows:
        lse, label_logit, sum_logits, *saved = flash_ce_forward(h2, embedding, bias, y, emb_cast,
                                                               save=True)
    else:
        lse, label_logit, sum_logits = flash_ce_forward(h2, embedding, bias, y, emb_cast)
    expected = expected_logit(label_logit, sum_logits, label_smoothing, vocab)
    loss_sum = ((lse - expected) * m2).sum()
    return loss_sum, (None if flash == "fwd" else lse), saved


class _FusedLMLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, embedding, bias, labels, mask, label_smoothing, chunk, emb_cast,
                flash, max_rows):
        b, t, d = hidden.shape
        n = b * t
        h2 = hidden.reshape(n, d)
        y = labels.reshape(n)
        m2 = mask.reshape(n).float()
        loss_sum, lse, saved = _forward(h2, embedding, bias, y, m2, label_smoothing, chunk,
                                        emb_cast, flash, max_rows)
        denom = m2.sum()
        ctx.save_for_backward(h2, embedding, bias, y, m2, denom, lse, emb_cast,
                              *(saved or (None, None)))
        ctx.shape = hidden.shape
        ctx.label_smoothing, ctx.chunk, ctx.flash, ctx.max_rows = (label_smoothing, chunk, flash,
                                                                    max_rows)
        return loss_sum / denom - normalizing(label_smoothing, embedding.shape[0])

    @staticmethod
    def backward(ctx, g):
        h2, embedding, bias, y, m2, denom, lse, emb_cast, logits_main, tail = ctx.saved_tensors
        n = h2.shape[0]
        rowscale = m2 * (g / denom)
        args = (h2, embedding, bias, y, lse, rowscale, ctx.label_smoothing, emb_cast)
        if logits_main is not None:
            dh, demb, dbias = flash_ce_backward_save(*args, logits_main, tail)
        elif ctx.flash == "1":
            dh, demb, dbias = flash_ce_backward(*args)
        elif ctx.flash == "dl" and n <= ctx.max_rows:
            dh, demb, dbias = flash_ce_backward_dl(*args)
        else:
            dh, demb, dbias = _chunked_backward(h2, embedding, bias, y, rowscale,
                                                ctx.label_smoothing, min(ctx.chunk, n))
        return (dh.reshape(ctx.shape), demb.to(embedding.dtype), dbias.to(bias.dtype),
                None, None, None, None, None, None, None)


def fused_lm_loss(hidden, embedding, bias, labels, mask, label_smoothing: float = 0.0,
                  chunk: int = 512, emb_cast=None, mode: str = "auto",
                  dl_max_rows: int = 8192) -> torch.Tensor:
    """hidden (B, T, D) in the compute dtype, embedding (V, D) the head's
    table (any layout; a transposed view passes its gradient to the tensor
    it views), bias (V,) final_logits_bias, labels and mask (B, T) -> the
    masked mean label-smoothed CE, a float32 scalar.  ``emb_cast``, where
    given, is the same table contiguous in the compute dtype, which the
    flash routes read.  Gradients reach hidden, embedding and bias."""
    flash = _resolve_mode(mode, hidden.device)
    max_rows = int(override("MIC_TPU_DL_MAX_ROWS", str(dl_max_rows)))
    return _FusedLMLoss.apply(hidden, embedding, bias, labels, mask, label_smoothing, chunk,
                              emb_cast, flash, max_rows)

"""Flash attention (Captioner(attn_impl="pallas")): the CUDA forward kernel,
its plain version, and the recomputing backward.

Counterpart of mic_tpu/ops/flash_attention.py::flash_attention: q (B, Tq,
H, Dh), k and v (B, Tk, H, Dh), q pre-scaled; an optional bool (B, 1, Tq,
Tk) mask becomes a float32 (B, Tq, Tk) additive bias of 0 / -1e30 shared by
an image's heads.  The forward's arithmetic is mic_tpu's _kernel: f32
scores, p = exp(s - max) zeroed where s <= -5e29, f32 p times f32 v, and a
row with no valid key outputs exactly 0.  The online softmax's blocking
(mic_tpu's 256 x 512 VMEM tiles, the kernel's 64-key tiles) changes only
the rounding, so the plain version takes the whole row at once.

The backward is mic_tpu's _flash_bwd in plain PyTorch on every device (it
is XLA einsums in mic_tpu, not a Pallas kernel): recompute in f32, p
zeroed on masked entries, so a fully masked row gets zero gradients, grads
cast to the input dtype.

``flash_attention_forward`` takes the plain version for tensors on the CPU
(any Dh) and the kernel (csrc/flash_attention.cu, Dh = 64) for tensors on a
CUDA device; it never falls back from one to the other.
``flash_attention_forward.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build

NEG_INF = -1e30
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def mask_bias(mask, b: int, tq: int, tk: int):
    """bool mask (broadcastable to (B, 1, Tq, Tk)), True = attend -> float32
    (B, Tq, Tk) bias of 0 / -1e30 (None for no mask)."""
    if mask is None:
        return None
    m = mask[:, 0].expand(b, tq, tk)
    return torch.where(m, 0.0, NEG_INF).to(torch.float32).contiguous()


def _scores(q, k, bias):
    """f32 (B, H, Tq, Tk) scores with the bias, and where they are masked."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is not None:
        s = s + bias[:, None]
    return s, s <= NEG_INF / 2


def flash_attention_plain(q, k, v, bias=None) -> torch.Tensor:
    """mic_tpu's _kernel over the whole row: (B, Tq, H, Dh) in q's dtype."""
    s, masked = _scores(q, k, bias)
    m = torch.clamp(s.amax(-1, keepdim=True), min=NEG_INF)
    p = torch.where(masked, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.float()) / torch.where(l == 0.0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, bias, dout):
    """mic_tpu's _flash_bwd: (dq, dk, dv) in q's, k's and v's dtypes."""
    s, masked = _scores(q, k, bias)
    p = torch.where(masked, 0.0, torch.softmax(s, dim=-1))
    do = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_forward(q, k, v, bias=None) -> torch.Tensor:
    """The forward: (B, Tq, H, Dh) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_forward: unsupported device {q.device}")
    name = "flash_attention_forward"
    b, tq, heads, dh = q.shape
    tk = k.shape[1]
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(f"{name} kernel: q, k, v must all be bfloat16 or all float32, "
                                  f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh != 64:
        raise NotImplementedError(f"{name} kernel: head_dim 64, got {dh}")
    if k.shape != (b, tk, heads, dh) or v.shape != k.shape or tq < 1 or tk < 1:
        raise ValueError(f"{name} kernel: inconsistent shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (b, tq, tk)):
        raise ValueError(f"{name} kernel: the bias must be float32 (B, Tq, Tk)")
    _build.check_operands(name, (q, k, v) + (() if bias is None else (bias,)))
    out = torch.empty_like(q)
    entry = f"mic_flash_attention_fwd_{_SUFFIX[q.dtype]}"
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), b, tq, tk, heads, dh, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, entry)
    flash_attention_forward.launches += 1
    return out


flash_attention_forward.launches = 0


class _Flash(torch.autograd.Function):
    """mic_tpu's custom_vjp: the forward kernel, the plain recomputing
    backward (q, k, v and the bias saved)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return flash_attention_forward(q, k, v, bias)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, bias, dout)
        return dq, dk, dv, None


def flash_attention(q, k, v, mask=None, block_q: int = 256, block_k: int = 512) -> torch.Tensor:
    """softmax(q k^T + mask bias) v with flash attention's fully-masked-row
    rule (output 0, zero grads).  ``block_q`` and ``block_k`` are mic_tpu's
    VMEM tiling, kept in the signature; the result does not depend on them,
    and the kernel picks its own tiles."""
    del block_q, block_k
    b, tq = q.shape[:2]
    return _Flash.apply(q, k, v, mask_bias(mask, b, tq, k.shape[1]))

"""Full-softmax attention for short sequences, forward and backward: the
CUDA kernels and their plain versions.

Counterpart of mic_tpu/ops/small_attention.py (MIC_TPU_EXPERIMENTAL=
small_attn): softmax(q k^T + bias) v for q, k, v (B, T, H, 64) with
Tq == Tk <= 64, q pre-scaled.  The mask becomes mic_tpu's float32 (B, T, T)
bias of 0 / finfo(float32).min, shared by an image's heads, and a row with
no valid key attends key 0 (its output is key 0's value; the loss masks
those positions, so their upstream gradient is zero).

Numerics are mic_tpu's kernels': f32 scores and softmax; the forward
rounds p to the input dtype before p @ v (summed in f32, cast); the
backward recomputes p from q, k, v and takes dv from the rounded p and ds
from the f32 p.  mic_tpu pads T to a multiple of 8 (Mosaic's sublanes) and
B to two images (one 128-lane MXU tile); neither changes a valid output,
and neither is done here: the kernel masks keys at or past T itself.

The wrappers take the plain versions for tensors on the CPU and the kernels
(csrc/small_attention.cu) for tensors on a CUDA device; they never fall
back from one to the other.  ``small_attention_forward.launches`` and
``small_attention_backward.launches`` count the kernels' launches.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build

NEG = torch.finfo(torch.float32).min
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def supports(q, k, v, mask, dropout_rate, return_weights) -> bool:
    """mic_tpu's shape and feature gate (ops/small_attention.py::supports)."""
    b, tq, nh, dh = q.shape
    tk = k.shape[1]
    return (
        not return_weights
        and dropout_rate == 0.0
        and tq == tk
        and tq <= 64
        and dh == 64
        and (mask is None or (mask.ndim == 4 and mask.shape[1] == 1))
        and q.dtype == k.dtype == v.dtype
    )


def mask_bias(mask, b: int, t: int):
    """bool (B or 1, 1, T or 1, T) mask, True = attend -> float32 (B, T, T)
    additive bias, 0 / finfo.min, with a fully masked row's key 0 set to 0
    (None for no mask)."""
    if mask is None:
        return None
    m = mask[:, 0].expand(b, t, t)
    bias = torch.where(m, 0.0, NEG).to(torch.float32)
    bias[:, :, 0] = torch.where(m.any(-1), bias[:, :, 0], 0.0)
    return bias.contiguous()


def _scores(q, k, bias):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return s if bias is None else s + bias[:, None]


def small_t_attention_plain(q, k, v, bias=None) -> torch.Tensor:
    """mic_tpu's _fwd_kernel: (B, T, H, Dh) in q's dtype."""
    p = torch.softmax(_scores(q, k, bias), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def small_t_attention_bwd_plain(q, k, v, bias, dout):
    """mic_tpu's _bwd_kernel: (dq, dk, dv) in q's dtype."""
    p = torch.softmax(_scores(q, k, bias), dim=-1)
    do = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check_kernel_args(name, tensors, bias):
    q = tensors[0]
    b, t, heads, dh = q.shape
    if q.dtype not in _SUFFIX or any(x.dtype != q.dtype for x in tensors):
        raise NotImplementedError(f"{name} kernel: q, k, v (and dout) must all be bfloat16 or "
                                  f"all float32, got {[x.dtype for x in tensors]}")
    if dh != 64 or not 1 <= t <= 64:
        raise NotImplementedError(f"{name} kernel: head_dim 64 and 1 <= T <= 64, got "
                                  f"{tuple(q.shape)}")
    if any(x.shape != q.shape for x in tensors):
        raise ValueError(f"{name} kernel: q, k, v (and dout) must have one shape")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (b, t, t)):
        raise ValueError(f"{name} kernel: the bias must be float32 (B, T, T)")
    _build.check_operands(name, tensors + (() if bias is None else (bias,)))
    return b, t, heads, dh


def small_attention_forward(q, k, v, bias=None) -> torch.Tensor:
    """The forward: (B, T, H, 64) in q's dtype."""
    if q.device.type == "cpu":
        return small_t_attention_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"small_attention_forward: unsupported device {q.device}")
    b, t, heads, dh = _check_kernel_args("small_attention_forward", (q, k, v), bias)
    out = torch.empty_like(q)
    entry = f"mic_small_attention_fwd_{_SUFFIX[q.dtype]}"
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), b, t, heads, dh, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, entry)
    small_attention_forward.launches += 1
    return out


def small_attention_backward(q, k, v, bias, dout):
    """The backward: (dq, dk, dv), each (B, T, H, 64) in q's dtype."""
    if q.device.type == "cpu":
        return small_t_attention_bwd_plain(q, k, v, bias, dout)
    if q.device.type != "cuda":
        raise ValueError(f"small_attention_backward: unsupported device {q.device}")
    b, t, heads, dh = _check_kernel_args("small_attention_backward", (q, k, v, dout), bias)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    entry = f"mic_small_attention_bwd_{_SUFFIX[q.dtype]}"
    err = getattr(_build.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, heads, dh,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, entry)
    small_attention_backward.launches += 1
    return dq, dk, dv


small_attention_forward.launches = 0
small_attention_backward.launches = 0


class _SmallT(torch.autograd.Function):
    """mic_tpu's custom_vjp: the forward kernel, and the backward kernel
    recomputing from q, k, v (saved with the bias)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return small_attention_forward(q, k, v, bias)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = small_attention_backward(q, k, v, bias, dout.contiguous())
        return dq, dk, dv, None


def small_t_attention(q, k, v, mask=None) -> torch.Tensor:
    """softmax(q k^T + mask bias) v for (B, T, H, 64) with Tq == Tk <= 64;
    q pre-scaled; mask optional bool (B, 1, T, T), True = attend."""
    b, t = q.shape[:2]
    return _SmallT.apply(q, k, v, mask_bias(mask, b, t))

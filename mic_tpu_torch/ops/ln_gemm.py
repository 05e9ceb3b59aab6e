"""LayerNorm folded into a dense: the CUDA kernel and its plain version.

Counterpart of mic_tpu/ops/ln_gemm.py (MIC_TPU_EXPERIMENTAL=ln_qkv): the
decode step's ln_self and fused q/k/v projection as one pass, so the
normalised activations never reach device memory.  Rounding points are the
TPU kernel's: f32 statistics, the normalised row rounded to the weight's
dtype, an f32 product, the sum cast to x's dtype, then the bias added in
x's dtype.

``ln_gemm`` takes the plain version for tensors on the CPU and its kernel
(csrc/ln_gemm.cu) for tensors on a CUDA device; it never falls back from one
to the other.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build


def supports(x: torch.Tensor, kernel: torch.Tensor) -> bool:
    """mic_tpu's guard: x (N, D) with N a multiple of 8, D and the output
    width multiples of 128, and the (D, O) weight at most 32 MB in bf16."""
    n, d = x.shape
    o = kernel.shape[1]
    return (kernel.ndim == 2 and n % 8 == 0 and d % 128 == 0 and o % 128 == 0
            and 2 * d * o <= 32 * 1024 * 1024)


def ln_gemm_plain(x, ln_scale, ln_bias, kernel, bias, eps: float = 1e-5) -> torch.Tensor:
    """(N, D) x -> layer_norm(x) @ kernel + bias, (N, O) in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    acc = xn.to(kernel.dtype).float() @ kernel.float()
    return acc.to(x.dtype) + bias.to(x.dtype)


def ln_gemm(x, ln_scale, ln_bias, kernel, bias, eps: float = 1e-5) -> torch.Tensor:
    """layer_norm(x) @ kernel + bias for x (N, D), kernel (D, O): -> (N, O)."""
    if x.device.type == "cpu":
        return ln_gemm_plain(x, ln_scale, ln_bias, kernel, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_gemm: unsupported device {x.device}")
    n, d = x.shape
    o = kernel.shape[1]
    tensors = (x, ln_scale, ln_bias, kernel, bias)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError("ln_gemm kernel: every operand must be bfloat16")
    if (ln_scale.shape != (d,) or ln_bias.shape != (d,) or kernel.shape != (d, o)
            or bias.shape != (o,)):
        raise ValueError("ln_gemm kernel: inconsistent shapes")
    if d % 32 or o % 64 or n < 1:
        raise ValueError(f"ln_gemm kernel: D a multiple of 32 and O of 64, got {d}, {o}")
    _build.check_operands("ln_gemm", tensors)
    out = torch.empty((n, o), dtype=x.dtype, device=x.device)
    err = _build.lib().mic_ln_gemm_bf16(
        *(t.data_ptr() for t in tensors), out.data_ptr(), n, d, o, eps,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "mic_ln_gemm_bf16")
    ln_gemm.launches += 1
    return out


ln_gemm.launches = 0

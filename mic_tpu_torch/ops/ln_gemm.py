"""LayerNorm folded into a dense: the CUDA kernel and its plain version.

Counterpart of mic_tpu/ops/ln_gemm.py (MIC_TPU_EXPERIMENTAL=ln_qkv): the
decode step's ln_self and fused q/k/v projection as one pass, so the
normalised activations never reach device memory.  Rounding points are the
TPU kernel's: f32 statistics, the normalised row rounded to the weight's
dtype, an f32 product, the sum cast to x's dtype, then the bias added in
x's dtype.

``ln_gemm`` takes the plain version for tensors on the CPU and its kernel
(csrc/ln_gemm.cu) for tensors on a CUDA device; it never falls back from one
to the other.  The kernel runs a 128-row x 192-column wgmma tile with the
LayerNorm applied to the A operand in shared memory; ``ln_splits`` cuts
the depth into splits where the output tiles alone leave SMs idle.  A
float32 model's operands (every one float32) take csrc/ln_gemm_f32.cu:
the rows' statistics, then 128 x 96 tiles of float32-accurate products on
the tensor cores (three TF32 products a term, mma.sync) with x normalised
on its way to shared memory, cut in depth by ``ln_splits_f32``; nothing
is rounded to bfloat16 there.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build

# csrc/ln_gemm.cu: a block's output rows and columns, and the depth of a slice
_TILE_ROWS, _TILE_COLS, _SLICE = 128, 192, 64
# csrc/ln_gemm_f32.cu's output rows and columns a block, and the depth of a slice
_F32_ROWS, _F32_COLS, _F32_SLICE = 128, 96, 16


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


def ln_splits(n: int, d: int, o: int, sms: int) -> int:
    """The kernel's depth splits at (N, D) x (D, O): as many as the SMs its
    128 x 192 output tiles leave idle allow (sms // tiles), at least 1 and
    at most one a 64-deep slice of the ceil(D / 64) (the last one partial
    where D % 64 != 0, its columns past D zero).  Split z of Z sums slices
    [z S / Z, (z + 1) S / Z)."""
    tiles = -(-n // _TILE_ROWS) * -(-o // _TILE_COLS)
    return max(1, min(-(-d // _SLICE), sms // tiles))


def ln_splits_f32(n: int, d: int, o: int, sms: int) -> int:
    """The float32 kernel's depth splits: as many as the SMs its 128 x 96
    tiles leave idle allow, at least 1 and at most one a 64 of the depth
    (each split at least four 16-deep slices).  Split z of Z sums slices
    [z S / Z, (z + 1) S / Z) of the S = D / 16."""
    tiles = -(-n // _F32_ROWS) * -(-o // _F32_COLS)
    return max(1, min(d // (4 * _F32_SLICE), sms // tiles))


def ln_gemm(x, ln_scale, ln_bias, kernel, bias, eps: float = 1e-5, out=None) -> torch.Tensor:
    """layer_norm(x) @ kernel + bias for x (N, D), kernel (D, O): -> (N, O);
    written into ``out`` (N, O) where given (the kernel only)."""
    if x.device.type == "cpu":
        return ln_gemm_plain(x, ln_scale, ln_bias, kernel, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_gemm: unsupported device {x.device}")
    n, d = x.shape
    o = kernel.shape[1]
    tensors = (x, ln_scale, ln_bias, kernel, bias)
    if x.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("ln_gemm kernel: every operand must be bfloat16, or every one float32")
    if (ln_scale.shape != (d,) or ln_bias.shape != (d,) or kernel.shape != (d, o)
            or bias.shape != (o,)):
        raise ValueError("ln_gemm kernel: inconsistent shapes")
    if d % 32 or o % 64 or n < 1:
        raise ValueError(f"ln_gemm kernel: D a multiple of 32 and O of 64, got {d}, {o}")
    if out is None:
        out = torch.empty((n, o), dtype=x.dtype, device=x.device)
    elif out.shape != (n, o) or out.dtype != x.dtype:
        raise ValueError(f"ln_gemm kernel: out must be {(n, o)} {x.dtype}")
    _build.check_operands("ln_gemm", (*tensors, out))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.float32:
        splits = ln_splits_f32(n, d, o, sms)
        stats = torch.empty((2 * n,), dtype=torch.float32, device=x.device)
        part = (torch.empty((splits * n * o,), dtype=torch.float32, device=x.device)
                if splits > 1 else None)
        err = _build.lib().mic_ln_gemm_f32(
            *(t.data_ptr() for t in tensors), stats.data_ptr(),
            part.data_ptr() if part is not None else 0, out.data_ptr(), n, d, o, eps, splits,
            stream,
        )
        _build.check(err, "mic_ln_gemm_f32")
        ln_gemm.launches += 1
        return out
    splits = ln_splits(n, d, o, sms)
    part = (torch.empty((splits * n * o,), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    err = _build.lib().mic_ln_gemm_bf16(
        *(t.data_ptr() for t in tensors), part.data_ptr() if part is not None else 0,
        out.data_ptr(), n, d, o, eps, splits, stream,
    )
    _build.check(err, "mic_ln_gemm_bf16")
    ln_gemm.launches += 1
    return out


ln_gemm.launches = 0  # both dtypes' launches

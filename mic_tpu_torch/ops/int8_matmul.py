"""bf16 x int8 GEMM with per-output-channel scales: the CUDA kernel and its
plain version.

Counterpart of mic_tpu/ops/int8_matmul.py::int8_matmul, which mic_tpu keeps
as a reference with no caller on its serving path; no path of the port
calls this one either.  x (M, K), w_q (K, N) int8, scale (N,) f32 ->
(M, N) in x's dtype, with mic_tpu's arithmetic: each weight dequantised as
bf16(bf16(w_q) * bf16(scale)), products summed in f32, one rounding of the
output (bf16 in the kernel).  It is not ops/quant.py::int8_matmul, the
int8 x int8 product of the port's int8 serving.

``int8_matmul`` takes the plain version for tensors on the CPU and its
kernel (csrc/int8_matmul.cu) for tensors on a CUDA device; it never falls
back from one to the other.  The kernel takes any M, K and N.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (M, K), w_q (K, N) int8, scale (N,) -> (M, N) in x's dtype: the
    weight dequantised in x's dtype (one rounding of each product), f32
    sums."""
    w = w_q.to(x.dtype) * scale.to(x.dtype)[None, :]
    return (x.float() @ w.float()).to(x.dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The dequantising GEMM: -> (M, N) in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    name = "int8_matmul"
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name} kernel: x bfloat16, w_q int8 and scale float32, got "
                        f"{x.dtype}, {w_q.dtype}, {scale.dtype}")
    if x.ndim != 2 or w_q.ndim != 2 or w_q.shape[0] != x.shape[1] or scale.shape != w_q.shape[1:]:
        raise ValueError(f"{name} kernel: shapes {tuple(x.shape)} x {tuple(w_q.shape)}, "
                         f"scale {tuple(scale.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    _build.check_operands(name, (x, w_q, scale))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _build.lib().mic_int8_matmul_bf16(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "mic_int8_matmul_bf16")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0

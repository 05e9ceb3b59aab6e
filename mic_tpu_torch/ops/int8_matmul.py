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
back from one to the other.  The kernel takes any M, K and N, and w_q at
any byte alignment; ``int8_matmul_plan`` picks its instance, depth splits
and grid.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build

# csrc/int8_matmul.cu: weight columns of a tile, and each instance's x rows
# a tile and depth of a slice (one block an SM)
_TILE_COLS = 128
_INSTANCES = ((8, 128), (64, 128), (256, 64))


def int8_matmul_plan(m: int, k: int, n: int, sms: int) -> tuple[int, int, int]:
    """The kernel's launch for x (m, k) @ w_q (k, n) on ``sms`` SMs ->
    (rows, splits, blocks): the instance (x rows a tile: the fewest of 8,
    64 and 256 that hold m, else 256), the depth splits (as many as the
    SMs leave room for beside the tiles in one wave, at least 1 and at
    most one a slice; split z of Z sums slices [z S / Z, (z + 1) S / Z) of
    the S = ceil(k / depth)) and the persistent grid (the work items, at
    most one an SM)."""
    rows, depth = next((i for i in _INSTANCES if m <= i[0]), _INSTANCES[-1])
    tiles = -(-m // rows) * -(-n // _TILE_COLS)
    splits = max(1, min(-(-k // depth), sms // tiles))
    return rows, splits, min(tiles * splits, sms)


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
    if w_q.device != x.device or scale.device != x.device or not (
            w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: w_q and scale must be contiguous and on x's device")
    # x's rows through TMA: 16-byte aligned, a multiple of 8 columns
    kx = -(-k // 8) * 8
    if kx != k or not x.is_contiguous() or x.data_ptr() % 16:
        padded = x.new_zeros((m, kx))
        padded[:, :k] = x
        x = padded
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows, splits, blocks = int8_matmul_plan(m, k, n, sms)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = arrivals = None
    if splits > 1:
        tiles = -(-m // rows) * -(-n // _TILE_COLS)
        part = torch.empty(splits * tiles * _TILE_COLS * rows, dtype=torch.float32,
                           device=x.device)
        arrivals = _build.arrivals(x.device, stream, tiles)
    err = _build.lib().mic_int8_matmul_bf16(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(), m, kx, k, n, rows, splits, blocks,
        stream,
    )
    _build.check(err, "mic_int8_matmul_bf16")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0

"""The decode step's MLP, fc1 -> gelu -> fc2: the CUDA kernel and its plain
version.

Counterpart of mic_tpu/ops/fused_mlp.py (MIC_TPU_EXPERIMENTAL=fused_mlp).
Rounding points are the TPU kernel's: fc1 sums in f32 and is cast to x's
dtype, b1 added in x's dtype, then the activation ("gelu": the erf gelu in
f32 with erf from Abramowitz & Stegun 7.1.26, the TPU kernel's own
polynomial, cast back to x's dtype); fc2 sums in f32, adds b2 (cast to x's
dtype) in f32, and is cast once at the end.  The other activations of
nn/layers.py::ACTIVATIONS run as there, on the bf16 intermediate, as
mic_tpu's kernel runs them.

``fused_mlp`` takes the plain version for tensors on the CPU and its kernel
(csrc/fused_mlp.cu, every activation) for tensors on a CUDA device; it
never falls back from one to the other.  The kernel runs both products on
a 128-row x 256-column wgmma tile; ``mlp_splits`` cuts a product's depth
into splits where its output tiles alone leave SMs idle.  A float32 model's
operands (every one float32) take csrc/fused_mlp_f32.cu: both products on
row 15 f32's 128 x 96 tile of float32-accurate tensor-core products (three
TF32 products a term, mma.sync), fc1's bias and activation in f32 on its
accumulators, cut in depth by ``ln_gemm.ln_splits_f32``; nothing is
rounded to bfloat16 there.
"""

from __future__ import annotations

import torch

from mic_tpu_torch import _build
from mic_tpu_torch.nn.layers import ACTIVATIONS
from mic_tpu_torch.ops.ln_gemm import ln_splits_f32

# the kernel's activation ids (csrc/fused_mlp.cu, enum Act)
_ACTIVATION_IDS = {"gelu": 0, "gelu_tanh": 1, "quick_gelu": 2, "relu": 3, "silu": 4}
# csrc/gemm_wgmma.cuh: a block's output rows and columns, and the depth of a slice
_TILE_ROWS, _TILE_COLS, _SLICE = 128, 256, 64


def mlp_splits(rows: int, cols: int, depth: int, sms: int) -> int:
    """The depth splits of one product, (rows, depth) @ (depth, cols), on
    the kernel's tiles: as many as the SMs the output tiles leave idle
    allow (sms // tiles), at least 1 and at most one a 64-deep slice.  Split
    z of Z sums slices [z S / Z, (z + 1) S / Z) of the S = depth / 64."""
    tiles = -(-rows // _TILE_ROWS) * -(-cols // _TILE_COLS)
    return max(1, min(depth // _SLICE, sms // tiles))



def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """0.5 x (1 + erf(x / sqrt 2)) in f32, erf by Abramowitz & Stegun
    7.1.26 (|error| <= 1.5e-7), cast back to x's dtype."""
    x32 = x.float()
    z = x32 * 0.7071067811865476
    a = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    e = 1.0 - poly * torch.exp(-a * a)
    erf = torch.where(z < 0, -e, e)
    return (0.5 * x32 * (1.0 + erf)).to(x.dtype)


def fused_mlp_plain(x, w1, b1, w2, b2, activation: str = "gelu") -> torch.Tensor:
    """(N, D) x -> act(x @ w1 + b1) @ w2 + b2, (N, D) in x's dtype."""
    dt = x.dtype
    act = gelu_erf if activation == "gelu" else ACTIVATIONS[activation]
    h = act((x.float() @ w1.to(dt).float()).to(dt) + b1.to(dt))
    return (h.float() @ w2.to(dt).float() + b2.to(dt).float()).to(dt)


def fused_mlp(x, w1, b1, w2, b2, activation: str = "gelu", out=None) -> torch.Tensor:
    """The MLP of x (N, D) with w1 (D, F), b1 (F,), w2 (F, D), b2 (D,);
    written into ``out`` (N, D) where given (the kernel only)."""
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    if activation not in _ACTIVATION_IDS:
        raise ValueError(f"fused_mlp kernel: unknown activation {activation!r}")
    n, d = x.shape
    f = w1.shape[1]
    tensors = (x, w1, b1, w2, b2)
    if x.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("fused_mlp kernel: every operand must be bfloat16, or every one float32")
    if w1.shape != (d, f) or b1.shape != (f,) or w2.shape != (f, d) or b2.shape != (d,):
        raise ValueError("fused_mlp kernel: inconsistent shapes")
    if d < 64 or f < 64 or d % 64 or f % 64 or n < 1:
        raise ValueError(f"fused_mlp kernel: D and F multiples of 64, got {d}, {f}")
    if out is None:
        out = torch.empty_like(x)
    elif out.shape != x.shape or out.dtype != x.dtype:
        raise ValueError(f"fused_mlp kernel: out must be {tuple(x.shape)} {x.dtype}")
    _build.check_operands("fused_mlp", (*tensors, out))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    f32 = x.dtype == torch.float32
    if f32:  # (rows, depth, cols)
        splits1, splits2 = ln_splits_f32(n, d, f, sms), ln_splits_f32(n, f, d, sms)
    else:    # (rows, cols, depth)
        splits1, splits2 = mlp_splits(n, f, d, sms), mlp_splits(n, d, f, sms)
    h = torch.empty((n, f), dtype=x.dtype, device=x.device)
    scratch = max(splits1 * f if splits1 > 1 else 0, splits2 * d if splits2 > 1 else 0) * n
    part = torch.empty((scratch,), dtype=torch.float32, device=x.device) if scratch else None
    entry = "mic_fused_mlp_f32" if f32 else "mic_fused_mlp_bf16"
    err = getattr(_build.lib(), entry)(
        *(t.data_ptr() for t in tensors), h.data_ptr(), part.data_ptr() if scratch else 0,
        out.data_ptr(), n, d, f, _ACTIVATION_IDS[activation], splits1, splits2,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, entry)
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0  # both dtypes' launches

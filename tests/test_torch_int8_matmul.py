"""The bf16 x int8 dequantising GEMM (ops/int8_matmul.py) against mic_tpu's
Pallas _kernel in interpret mode (its pallas_call reproduced here, with
mic_tpu's blocks) and against mic_tpu's entry point, which off the TPU
takes its XLA dequant-then-dot.

Both sides dequantise each weight to bf16(bf16(w_q) * bf16(scale)) bit for
bit and sum exact products in float32, so the outputs differ only by the
order of the f32 sums before the one bf16 rounding: each within one
bfloat16 ulp of mic_tpu's (bit-equal on most entries).  The kernel's launch
plan (``int8_matmul_plan``) is checked in pure Python against the source's
tile constants.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mic_tpu.ops.int8_matmul import _kernel
from mic_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul
from mic_tpu_torch.ops import int8_matmul as mm
from mic_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain, int8_matmul_plan

KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "mic_tpu_torch", "csrc", "int8_matmul.cu")


def _kernel_call(x, w_q, scale, bm, bn):
    """mic_tpu's pallas_call of _kernel, in interpret mode, x's rows padded
    with zeros to whole bm-row blocks (as the TPU's sublane tiles hold
    them)."""
    m, k = x.shape
    n = w_q.shape[1]
    rows = -(-m // bm) * bm
    x = jnp.pad(x, ((0, rows - m), (0, 0)))
    return pl.pallas_call(
        _kernel,
        grid=(rows // bm, pl.cdiv(n, bn)),
        in_specs=[
            pl.BlockSpec((bm, k), lambda i, j: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((k, bn), lambda i, j: (0, j), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, bn), lambda i, j: (0, j), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j: (i, j), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rows, n), x.dtype),
        interpret=True,
    )(x, w_q, scale.reshape(1, n))[:m]


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.normal(size=(m, k)).astype(np.float32) * 0.3, jnp.bfloat16)
                   .astype(jnp.float32))
    w_q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, size=(n,)).astype(np.float32)
    return x, w_q, scale


def _torch(x, w_q, scale):
    return torch.tensor(x).to(torch.bfloat16), torch.tensor(w_q), torch.tensor(scale)


def _assert_within_one_bf16_ulp(got, ref):
    _, e = np.frexp(np.abs(ref))
    assert (np.abs(got - ref) <= np.ldexp(1.0, e - 8)).all()


@pytest.mark.parametrize("m,k,n,bm,bn", [(16, 128, 256, 8, 128), (8, 256, 128, 8, 128),
                                         (8, 128, 100, 8, 100), (4, 128, 128, 4, 128),
                                         (1, 128, 128, 8, 128), (4, 100, 249, 4, 249),
                                         (2, 72, 77, 8, 77)])
def test_plain_matches_mic_tpu_kernel(m, k, n, bm, bn):
    x, w_q, scale = _inputs(m, k, n, m + n)
    ref = np.asarray(_kernel_call(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w_q),
                                  jnp.asarray(scale), bm, bn), np.float32)
    got = int8_matmul(*_torch(x, w_q, scale))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _assert_within_one_bf16_ulp(got.float().numpy(), ref)


@pytest.mark.parametrize("m,k,n", [(16, 128, 256), (4, 96, 100), (3, 200, 70), (1, 64, 249),
                                   (5, 1001, 33)])
def test_plain_matches_mic_tpu_entry_point(m, k, n):
    """mic_tpu's entry point off the TPU (its XLA fallback, the same
    dequantisation), including shapes its TPU kernel would pad or refuse."""
    x, w_q, scale = _inputs(m, k, n, 2 * m + k)
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w_q),
                                     jnp.asarray(scale)), np.float32)
    got = int8_matmul(*_torch(x, w_q, scale)).float().numpy()
    _assert_within_one_bf16_ulp(got, ref)


def test_dequantised_weight_is_mic_tpu_s():
    """The plain version's weight is mic_tpu's bf16(bf16(w_q) * bf16(scale)),
    bit for bit: an identity x reads it back."""
    _, w_q, scale = _inputs(1, 64, 48, 9)
    eye = torch.eye(64).to(torch.bfloat16)
    got = int8_matmul_plain(eye, torch.tensor(w_q), torch.tensor(scale))
    ref = jnp.asarray(w_q).astype(jnp.bfloat16) * jnp.asarray(scale).astype(jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_plan_constants_are_the_kernels():
    """The plan's tile width and instances (x rows a tile, depth of a
    slice) are csrc/int8_matmul.cu's, and its entry dispatches those."""
    with open(KERNEL_SOURCE) as f:
        src = f.read()
    assert re.search(r"constexpr int kCols = (\d+);", src).group(1) == str(mm._TILE_COLS)
    for path in ("true", "false"):
        shapes = re.findall(rf"struct Shape<(\d+), {path}> \{{ static constexpr int kDepth = "
                            r"(\d+),", src)
        assert tuple((int(r), int(d)) for r, d in shapes) == mm._INSTANCES
    assert re.findall(r"return dq::launch<(\d+)>\(", src) == [str(r) for r, _ in mm._INSTANCES]


@pytest.mark.parametrize("m,k,n", [(1, 1024, 3072), (4, 1024, 3072), (4, 1024, 250054),
                                   (8, 1000, 3074), (64, 1024, 3072), (65, 1001, 249),
                                   (1024, 1024, 3072), (1024, 1024, 250054), (4, 64, 128),
                                   (3, 100, 70)])
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_splits_cover_the_depth_and_fill_the_sms(m, k, n, sms):
    """The instance is the narrowest that holds M; every split is non-empty
    and the splits cover the depth in order; the grid is no larger than
    the work or the SMs (one block each), and at decode M (<= 64) the work
    items fill the SMs as far as one wave allows: one more split would not
    fit, or every slice is a split already."""
    rows, splits, blocks = int8_matmul_plan(m, k, n, sms)
    widths = [r for r, _ in mm._INSTANCES]
    assert rows == min([r for r in widths if r >= m] or [widths[-1]])
    slices = math.ceil(k / dict(mm._INSTANCES)[rows])
    bounds = [z * slices // splits for z in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == slices
    assert all(b < c for b, c in zip(bounds, bounds[1:]))
    tiles = math.ceil(m / rows) * math.ceil(n / mm._TILE_COLS)
    assert 1 <= blocks == min(tiles * splits, sms)
    if m <= 64:
        assert tiles * (splits + 1) > sms or splits == slices

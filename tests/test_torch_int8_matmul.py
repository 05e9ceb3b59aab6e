"""The bf16 x int8 dequantising GEMM (ops/int8_matmul.py) against mic_tpu's
Pallas _kernel in interpret mode (its pallas_call reproduced here, with
mic_tpu's blocks) and against mic_tpu's entry point, which off the TPU
takes its XLA dequant-then-dot.

Both sides dequantise each weight to bf16(bf16(w_q) * bf16(scale)) bit for
bit and sum exact products in float32, so the outputs differ only by the
order of the f32 sums before the one bf16 rounding: each within one
bfloat16 ulp of mic_tpu's (bit-equal on most entries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mic_tpu.ops.int8_matmul import _kernel
from mic_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul
from mic_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain


def _kernel_call(x, w_q, scale, bm, bn):
    """mic_tpu's pallas_call of _kernel, in interpret mode."""
    m, k = x.shape
    n = w_q.shape[1]
    return pl.pallas_call(
        _kernel,
        grid=(pl.cdiv(m, bm), pl.cdiv(n, bn)),
        in_specs=[
            pl.BlockSpec((bm, k), lambda i, j: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((k, bn), lambda i, j: (0, j), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, bn), lambda i, j: (0, j), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j: (i, j), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((m, n), x.dtype),
        interpret=True,
    )(x, w_q, scale.reshape(1, n))


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
                                         (8, 128, 100, 8, 100), (4, 128, 128, 4, 128)])
def test_plain_matches_mic_tpu_kernel(m, k, n, bm, bn):
    x, w_q, scale = _inputs(m, k, n, m + n)
    ref = np.asarray(_kernel_call(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w_q),
                                  jnp.asarray(scale), bm, bn), np.float32)
    got = int8_matmul(*_torch(x, w_q, scale))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _assert_within_one_bf16_ulp(got.float().numpy(), ref)


@pytest.mark.parametrize("m,k,n", [(16, 128, 256), (4, 96, 100), (3, 200, 70)])
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

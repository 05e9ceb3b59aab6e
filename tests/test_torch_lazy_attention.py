"""The port's lazy-beam decode attention (mic_tpu_torch/ops/lazy_attention.py,
nn/attention.py::mha_decode_step_lazy) against mic_tpu.

On the CPU the wrapper runs the plain version.  It is held against
  - mic_tpu's XLA path (nn/attention.py::mha_decode_step_lazy) at float32:
    outputs within 1e-5; cache columns other than `index` untouched
    (exact), column `index` within 1e-6 (each side projects it with its own
    matmul);
  - the Pallas kernel fused_lazy_attention_dma in interpret mode on the
    merged layout, as tests/test_lazy_attention.py runs it, in bfloat16 with
    the same step rows: caches exactly equal (both only copy the step rows
    in), outputs within 2e-2 (the two round their bfloat16 weights and
    partial products at different points).
The CUDA kernel itself is held to the plain version in
tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.nn.attention import mha_decode_step_lazy as jax_mha_decode_step_lazy
from mic_tpu.ops.lazy_attention import build_ancestry_mask, fused_lazy_attention_dma
from mic_tpu_torch.nn.attention import mha_decode_step_lazy
from mic_tpu_torch.ops.lazy_attention import lazy_attention


def _ancestry(rng, b, beams, t, index):
    anc = rng.integers(0, beams, (b, beams, t)).astype(np.int32)
    anc[:, :, index:] = np.arange(beams)[None, :, None]  # unwritten: identity
    return anc


def _cache(rng, rows, t, hd, index, scale=0.5):
    """A merged cache with a random written prefix and zeros from `index`
    on (the cache contract: dead columns are zero)."""
    c = (rng.normal(size=(rows, t, hd)) * scale).astype(np.float32)
    c[:, index:] = 0.0
    return c


@pytest.mark.parametrize("index,seed", [(0, 0), (1, 1), (6, 2), (11, 3)])
def test_mha_decode_step_lazy_matches_jax_xla_path(index, seed):
    b, beams, heads, dh, t = 2, 4, 4, 8, 12
    d = heads * dh
    rng = np.random.default_rng(seed)
    params = {
        "qkv": {"kernel": rng.normal(size=(d, 3 * d)).astype(np.float32) * 0.2,
                "bias": rng.normal(size=(3 * d,)).astype(np.float32) * 0.2},
        "o": {"kernel": rng.normal(size=(d, d)).astype(np.float32) * 0.2,
              "bias": rng.normal(size=(d,)).astype(np.float32) * 0.2},
    }
    x = rng.normal(size=(b * beams, 1, d)).astype(np.float32)
    ck = _cache(rng, b * beams, t, d, index)
    cv = _cache(rng, b * beams, t, d, index)
    anc = _ancestry(rng, b, beams, t, index)

    ref, rk, rv = jax_mha_decode_step_lazy(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(anc), jnp.asarray(index, jnp.int32), heads, beams,
    )
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = mha_decode_step_lazy(
        {k: {n: torch.from_numpy(a) for n, a in p.items()} for k, p in params.items()},
        torch.from_numpy(x), tk, tv, torch.from_numpy(anc), index, heads, beams,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    others = np.arange(t) != index
    for mine, theirs in ((tk, rk), (tv, rv)):
        mine, theirs = mine.numpy(), np.asarray(theirs)
        np.testing.assert_array_equal(mine[:, others], theirs[:, others])
        np.testing.assert_allclose(mine[:, index], theirs[:, index], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("index,seed", [(0, 4), (7, 5), (9, 6), (15, 7)])
def test_plain_matches_pallas_dma_kernel(index, seed):
    b, beams, heads, dh, t = 2, 4, 2, 64, 16
    hd = heads * dh
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    q = bf16((rng.normal(size=(b, beams, hd)) * 0.3).astype(np.float32))
    ks = bf16((rng.normal(size=(b, beams, hd)) * 0.5).astype(np.float32))
    vs = bf16((rng.normal(size=(b, beams, hd)) * 0.5).astype(np.float32))
    ck = bf16(_cache(rng, b * beams, t, hd, index))
    cv = bf16(_cache(rng, b * beams, t, hd, index))
    anc = _ancestry(rng, b, beams, t, index)

    def to_jax(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    idx = jnp.asarray(index, jnp.int32)
    ref, rk, rv = fused_lazy_attention_dma(
        to_jax(q), to_jax(ck), to_jax(cv), to_jax(ks), to_jax(vs),
        build_ancestry_mask(jnp.asarray(anc), idx), idx, beams, heads, interpret=True,
    )
    launches = lazy_attention.launches
    got = lazy_attention(q, ck, cv, ks, vs, torch.from_numpy(anc), index, heads)
    assert lazy_attention.launches == launches  # CPU tensors: the plain version
    np.testing.assert_array_equal(ck.float().numpy(), np.asarray(rk, np.float32))
    np.testing.assert_array_equal(cv.float().numpy(), np.asarray(rv, np.float32))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)

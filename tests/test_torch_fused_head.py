"""The port's fused LM head (mic_tpu_torch/ops/fused_head.py) against
mic_tpu/ops/fused_head.py::fused_head_topk on the CPU.

On the CPU both run materialized-logits versions at float32: ids must be
equal and log-probs and lse within 1e-5 (float32 sums in another order).
V = 1300 spans three 512-wide bucket chunks with a padded tail.  The CUDA
kernel is held to the plain version in tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.ops.fused_head import fused_head_topk as jax_fused_head_topk
from mic_tpu_torch.ops.fused_head import bucket_finish, fused_head_topk
from mic_tpu_torch.ops.topk_lse import NEG_INF, top_k

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n=6, d=32, v=1300, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(n, d)).astype(np.float32)
    weight = (rng.normal(size=(v, d)) * 0.5).astype(np.float32)
    bias = rng.normal(size=(v,)).astype(np.float32)
    return hidden, weight, bias


def _compare(hidden, weight, bias, k, select):
    ref = jax_fused_head_topk(jnp.asarray(hidden), jnp.asarray(weight).T,
                              jnp.asarray(bias), k, select)
    launches = fused_head_topk.launches
    got = fused_head_topk(torch.from_numpy(hidden), torch.from_numpy(weight),
                          torch.from_numpy(bias), k, select)
    assert fused_head_topk.launches == launches  # CPU tensors: the plain version
    lp, ids, lse = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(got[1].numpy(), ids)
    assert got[1].dtype == torch.int32
    np.testing.assert_allclose(got[0].numpy(), lp, **TOL)
    np.testing.assert_allclose(got[2].numpy(), lse, **TOL)


@pytest.mark.parametrize("select", ["bucket", "exact"])
@pytest.mark.parametrize("k", [1, 9])
def test_plain_matches_jax(select, k):
    _compare(*_inputs(seed=k), k, select)


def test_bucket_ties_take_the_earliest_chunk():
    """With zero hidden states the logits are the bias; equal values in
    every chunk of a bucket column must resolve to the earliest chunk, and
    equal bucket winners to the lower column, as on the TPU."""
    hidden, weight, _ = _inputs(n=3)
    hidden[:] = 0.0
    bias = np.zeros(1300, np.float32)
    bias[[5, 517, 1029]] = 2.0        # one bucket column, three chunks
    bias[[7, 519]] = 2.0              # a second column with the same winner value
    bias[[300, 812]] = 1.0
    _compare(hidden, weight, bias, 4, "bucket")
    _, ids, _ = fused_head_topk(torch.from_numpy(hidden), torch.from_numpy(weight),
                                torch.from_numpy(bias), 4, "bucket")
    assert ids[0, :3].tolist() == [5, 7, 300]


def test_top_k_breaks_ties_toward_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, NEG_INF, 3.0, 2.0, NEG_INF, 2.0],
                  [-1e7, -1e7, -1e7, -1e7, 0.0, -1e7, -1e7, -1e7]], np.float32)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x), 6)
    vals, idx = top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
    assert idx[0].tolist() == [1, 2, 4, 5, 7, 0]


def test_bucket_finish_matches_the_dense_bucket_select():
    """The kernel's host-side finish, fed accumulator planes built from the
    logits as the kernel builds them, gives the plain bucket result."""
    hidden, weight, bias = _inputs(n=4, v=1100, seed=3)
    logits = hidden @ weight.T + bias
    pad = np.full((4, 1536 - 1100), NEG_INF, np.float32)
    s3 = np.concatenate([logits, pad], axis=1).reshape(4, 3, 512)
    l = np.exp(np.minimum(s3, 60.0)).sum(axis=1)
    rmax = s3.max(axis=1)
    rid = (s3.argmax(axis=1) * 512 + np.arange(512)).astype(np.int32)
    lp, ids, lse = bucket_finish(5, torch.from_numpy(l), torch.from_numpy(rmax),
                                 torch.from_numpy(rid))
    ref = fused_head_topk(torch.from_numpy(hidden), torch.from_numpy(weight),
                          torch.from_numpy(bias), 5, "bucket")
    np.testing.assert_array_equal(ids.numpy(), ref[1].numpy())
    np.testing.assert_allclose(lp.numpy(), ref[0].numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), ref[2].numpy(), **TOL)

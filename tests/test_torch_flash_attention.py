"""The port's flash attention (ops/flash_attention.py) against mic_tpu's.

On the CPU the port's forward runs its plain version (the whole row at
once) and its backward the plain recompute on every device; mic_tpu's
flash_attention runs its Pallas kernel in interpret mode off the TPU, here
with small blocks (block_q 8, block_k 16) so that its online softmax walks
several key blocks and a ragged last one.  Tolerances: float32 within 1e-5
(values; the online rescaling rounds in another order) and 1e-5 of a
gradient's largest entry; bfloat16 outputs within 1e-2 absolute (one bf16
rounding of outputs of size up to 1, each side from f32 sums) and
gradients within 2e-2 of their largest entry.  A fully masked row is exactly
0, with exactly zero gradients, on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from mic_tpu_torch.ops import flash_attention as flash

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

CASES = {  # name -> (B, Tq, Tk, H, Dh, mask)
    "no_mask_tail": (2, 24, 40, 4, 16, "none"),        # Tk = 2.5 key blocks
    "causal_pad": (2, 16, 16, 4, 16, "causal_pad"),
    "fully_masked_rows": (3, 16, 16, 2, 8, "left_pad"),
    "random_mask_tail": (3, 21, 37, 2, 64, "random"),  # a ragged query and key block
    "odd_batch_decoder": (3, 64, 64, 2, 64, "causal_pad"),
    "one_key_past_a_tile": (2, 64, 65, 2, 64, "none"),  # the 65th key alone in a 64-key tile
    "one_query_long_keys": (2, 1, 130, 2, 64, "random"),  # three 64-key tiles, a dead row
}


def _mask(kind, b, tq, tk, rng):
    pos = np.arange(tk)
    lengths = rng.integers(1, tk + 1, b)
    lengths[0] = tk
    causal = np.tril(np.ones((tq, tk), bool))
    if kind == "none":
        return None
    if kind == "causal_pad":
        return causal[None, None] & (pos[None] < lengths[:, None])[:, None, None, :]
    if kind == "left_pad":
        lengths[1] = tk // 2
        return causal[None, None] & (pos[None] >= tk - lengths[:, None])[:, None, None, :]
    assert kind == "random"
    mask = rng.random((b, 1, tq, tk)) < 0.6
    mask[0, 0, :2] = False  # two fully masked rows
    return mask


def _both(case, dtype, seed=0):
    b, tq, tk, h, dh, kind = CASES[case]
    rng = np.random.default_rng(seed)
    arrays = [(rng.normal(size=(b, t, h, dh)) * s).astype(np.float32)
              for t, s in ((tq, 0.5), (tk, 0.5), (tk, 1.0))]
    mask = _mask(kind, b, tq, tk, rng)
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            None if mask is None else jnp.asarray(mask),
            [torch.from_numpy(a).to(tdt) for a in arrays],
            None if mask is None else torch.from_numpy(mask))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if isinstance(x, jax.Array) \
        else x.detach().float().numpy()


def _dead_rows(mask):
    """(B, Tq) True where a query row has no valid key."""
    return None if mask is None else ~mask[:, 0].any(-1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_mic_tpu_kernel(case, dtype):
    (jq, jk, jv), jmask, (q, k, v), mask = _both(case, dtype)
    ref = jax_flash_attention(jq, jk, jv, jmask, block_q=8, block_k=16)
    got = flash.flash_attention(q, k, v, mask)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=0, atol=1e-2)
    np.testing.assert_allclose(_f32(got), _f32(ref), **tol)
    dead = _dead_rows(mask)
    if dead is not None and dead.any():
        assert not got[dead].any() and not np.asarray(ref)[dead.numpy()].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_mic_tpu(case, dtype):
    """d/d(q, k, v) of sum(out * w), w from numpy: mic_tpu's _flash_bwd
    against the port's plain backward through autograd; a fully masked
    row's dq exactly 0 on both sides."""
    (jq, jk, jv), jmask, (q, k, v), mask = _both(case, dtype, seed=3)
    w = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)

    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, jmask, block_q=8, block_k=16)
        return jnp.sum(out.astype(jnp.float32) * w)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash.flash_attention(*leaves, mask)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), leaves)
    frac = 1e-5 if dtype == "float32" else 2e-2
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == q.dtype, name
        a, b = _f32(a), _f32(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=frac * np.abs(b).max(), err_msg=name)
    dead = _dead_rows(mask)
    if dead is not None and dead.any():
        assert not got[0][dead].any() and not _f32(ref[0])[dead.numpy()].any()


def test_result_does_not_depend_on_mic_tpu_blocks():
    """mic_tpu's VMEM tiling changes only the rounding: its default blocks
    (one block here) and small ones agree, and the port ignores them."""
    (jq, jk, jv), jmask, (q, k, v), mask = _both("random_mask_tail", "float32", seed=6)
    one = jax_flash_attention(jq, jk, jv, jmask)
    many = jax_flash_attention(jq, jk, jv, jmask, block_q=8, block_k=8)
    np.testing.assert_allclose(np.asarray(one), np.asarray(many), rtol=1e-5, atol=1e-6)
    got = flash.flash_attention(q, k, v, mask, block_q=8, block_k=8)
    assert torch.equal(got, flash.flash_attention(q, k, v, mask))


def test_mask_bias_is_shared_by_heads_and_broadcasts():
    """(B, 1, 1, Tk) padding masks broadcast over the query rows; the bias
    is 0 / -1e30 in float32."""
    mask = torch.tensor([[True, True, False], [True, False, False]])[:, None, None, :]
    bias = flash.mask_bias(mask, 2, 4, 3)
    assert bias.shape == (2, 4, 3) and bias.dtype == torch.float32
    assert torch.equal(bias[1, 2], torch.tensor([0.0, -1e30, -1e30]))
    assert flash.mask_bias(None, 2, 4, 3) is None

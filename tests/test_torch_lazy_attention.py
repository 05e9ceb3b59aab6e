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
On the int8 cache ({"q": int8 values, "s": per-row scales}) the plain
lazy_attention_q8 is held against fused_lazy_attention_dma in interpret mode
(the TPU's _kernel_dma_q8) in bfloat16: the cache's int8 values and scales
at columns <= index bit-equal (both quantize the step rows with the same
ops/quant.py math), columns past index untouched, outputs within 2e-2 (the
bfloat16 rounding of weights and outputs at different points).  Against
mic_tpu's XLA int8 path it can only be close: that path attends to the
step row after quantizing it, the TPU kernel (and the port) to the
unquantized row.  The bound there is stated where it is tested.
The CUDA kernels themselves are held to the plain versions in
tests/test_torch_cuda_kernels.py.  The int8 kernel's host-side planners are
held here: ``q8_layout`` (the heads a pass takes, the position groups and
the block's shared memory) takes every shape the earlier kernel took, and
``q8_walk`` gives each position to one position group, in order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.nn.attention import mha_decode_step_lazy as jax_mha_decode_step_lazy
from mic_tpu.ops.lazy_attention import build_ancestry_mask, fused_lazy_attention_dma
from mic_tpu.ops.quant import quantize_array, quantize_rows_dynamic
from mic_tpu_torch.nn.attention import mha_decode_step_lazy
from mic_tpu_torch.ops.lazy_attention import lazy_attention, lazy_attention_q8, q8_layout, q8_walk


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


@pytest.mark.parametrize("index,seed", [(0, 40), (7, 41), (15, 42)])
def test_plain_f32_matches_pallas_dma_kernel(index, seed):
    """A float32 model's row 1 against fused_lazy_attention_dma in
    interpret mode on float32 caches, q and step rows.  mic_tpu's kernel
    has no dtype gate but casts q, the step rows and the cache tiles to
    bfloat16 (mic_tpu/ops/lazy_attention.py:735-738, :524), while its
    XLA chain and the port keep float32 (ROADMAP C, known faults of the
    reference; test_mha_decode_step_lazy_matches_jax_xla_path holds the f32
    math within 1e-5).  So the inputs here are bfloat16 values held in
    float32, which both sides take exactly: caches exactly equal, float32
    outputs within 2e-2 (mic_tpu rounds its weights to bfloat16)."""
    b, beams, heads, dh, t = 2, 4, 2, 64, 16
    hd = heads * dh
    rng = np.random.default_rng(seed)

    def bf16_valued(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()

    q = bf16_valued(rng.normal(size=(b, beams, hd)) * 0.3)
    ks = bf16_valued(rng.normal(size=(b, beams, hd)) * 0.5)
    vs = bf16_valued(rng.normal(size=(b, beams, hd)) * 0.5)
    ck = bf16_valued(_cache(rng, b * beams, t, hd, index))
    cv = bf16_valued(_cache(rng, b * beams, t, hd, index))
    anc = _ancestry(rng, b, beams, t, index)
    idx = jnp.asarray(index, jnp.int32)
    ref, rk, rv = fused_lazy_attention_dma(
        *(jnp.asarray(x) for x in (q, ck, cv, ks, vs)),
        build_ancestry_mask(jnp.asarray(anc), idx), idx, beams, heads, interpret=True,
    )
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = lazy_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(ks), torch.from_numpy(vs),
                         torch.from_numpy(anc), index, heads)
    assert got.dtype == torch.float32 and np.asarray(rk).dtype == np.float32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-2, atol=2e-2)


def _int8_cache(rng, rows, t, hd, index):
    """A merged int8 cache quantized per row from a random prefix (zero rows
    from `index` on), with mic_tpu's quantizer: {"q", "s"} numpy arrays."""
    q, s = quantize_rows_dynamic(jnp.asarray(_cache(rng, rows, t, hd, index)))
    return {"q": np.array(q), "s": np.array(s[..., 0])}


@pytest.mark.parametrize("index,seed", [(0, 8), (5, 9), (17, 10), (31, 11)])
def test_q8_plain_matches_pallas_dma_kernel(index, seed):
    b, beams, heads, dh, t = 2, 4, 2, 64, 32
    hd = heads * dh
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    q = bf16((rng.normal(size=(b, beams, hd)) * 0.3).astype(np.float32))
    ks = bf16((rng.normal(size=(b, beams, hd)) * 0.5).astype(np.float32))
    vs = bf16((rng.normal(size=(b, beams, hd)) * 0.5).astype(np.float32))
    ck, cv = (_int8_cache(rng, b * beams, t, hd, index) for _ in range(2))
    anc = _ancestry(rng, b, beams, t, index)

    def to_jax(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    idx = jnp.asarray(index, jnp.int32)
    ref, rk, rv = fused_lazy_attention_dma(
        to_jax(q), jax.tree.map(jnp.asarray, ck), jax.tree.map(jnp.asarray, cv),
        to_jax(ks), to_jax(vs), build_ancestry_mask(jnp.asarray(anc), idx), idx, beams, heads,
        interpret=True,
    )
    tk = {n: torch.from_numpy(a.copy()) for n, a in ck.items()}
    tv = {n: torch.from_numpy(a.copy()) for n, a in cv.items()}
    launches = lazy_attention_q8.launches
    got = lazy_attention_q8(q, tk, tv, ks, vs, torch.from_numpy(anc), index, heads)
    assert lazy_attention_q8.launches == launches  # CPU tensors: the plain version
    for mine, theirs, before in ((tk, rk, ck), (tv, rv, cv)):
        for name in ("q", "s"):
            np.testing.assert_array_equal(mine[name].numpy()[:, :index + 1],
                                          np.asarray(theirs[name])[:, :index + 1])
            np.testing.assert_array_equal(mine[name].numpy()[:, index + 1:],
                                          before[name][:, index + 1:])
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("index,seed", [(0, 12), (6, 13), (11, 14)])
def test_q8_mha_decode_step_lazy_near_jax_xla_path(index, seed):
    """int8 weights and an int8 cache at float32 against mic_tpu's XLA path
    (merged int8 layout): the step column's int8 values and scales bit-equal
    (the int8 qkv product and the quantizer are exact on both sides), every
    other column untouched; outputs within 2e-2 of the output's largest
    magnitude: the order of one int8 step of the step row, which only the
    XLA path quantizes before attending to it (1.2e-2 at most over five
    draws; 0 at index 0, where the o projection's own row quantization
    maps both sides' single attended row to the same int8 row)."""
    b, beams, heads, dh, t = 2, 4, 4, 8, 12
    d = heads * dh
    rng = np.random.default_rng(seed)

    def q8(shape_in, shape_out):
        kq, s = quantize_array(jnp.asarray(rng.normal(size=(shape_in, shape_out)) * 0.2,
                                           jnp.float32), axis=0)
        return {"kernel_q": np.array(kq), "kernel_scale": np.array(s),
                "bias": (rng.normal(size=(shape_out,)) * 0.2).astype(np.float32)}

    params = {"qkv": q8(d, 3 * d), "o": q8(d, d)}
    x = rng.normal(size=(b * beams, 1, d)).astype(np.float32)
    ck, cv = (_int8_cache(rng, b * beams, t, d, index) for _ in range(2))
    anc = _ancestry(rng, b, beams, t, index)
    ref, rk, rv = jax_mha_decode_step_lazy(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jax.tree.map(jnp.asarray, ck),
        jax.tree.map(jnp.asarray, cv), jnp.asarray(anc), jnp.asarray(index, jnp.int32),
        heads, beams,
    )
    tk = {n: torch.from_numpy(a.copy()) for n, a in ck.items()}
    tv = {n: torch.from_numpy(a.copy()) for n, a in cv.items()}
    got = mha_decode_step_lazy(
        {k: {n: torch.from_numpy(a) for n, a in p.items()} for k, p in params.items()},
        torch.from_numpy(x), tk, tv, torch.from_numpy(anc), index, heads, beams,
    )
    for mine, theirs in ((tk, rk), (tv, rv)):
        for name in ("q", "s"):
            np.testing.assert_array_equal(mine[name].numpy(), np.asarray(theirs[name]))
    ref = np.asarray(ref)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err < 2e-2, err


def _align16(x):
    return (x + 15) // 16 * 16


# (beams, T) of the int8 kernel's cases: 1, 4 and 8 beams, the flagship's
# T = 64, and the earlier kernel's largest (a block of 32 K threads and 8 K T
# bytes of shared memory within the default 48 KB: K T <= 6144)
_Q8_SHAPES = [(1, 32), (4, 32), (8, 32), (4, 64), (32, 192), (1, 6144)]


@pytest.mark.parametrize("heads", [1, 2, 12, 16, 17, 32])
@pytest.mark.parametrize("beams,t", _Q8_SHAPES)
def test_q8_layout_takes_every_shape_the_earlier_kernel_took(beams, t, heads):
    """At indices 0, 1, 17 and T - 1: a pass takes a divisor of the heads,
    at most 32; 4 * group * groups threads, at most 128 and whole warps; and
    the block's shared memory (the sources, K and V row scales and scores of
    the live positions, sixteen f32 partial sums a thread, the step scores
    and weights, the warps' amaxes) fits 232,448 bytes, as counted here."""
    for index in sorted({0, 1, min(17, t - 1), t - 1}):
        group, groups, nbytes = q8_layout(heads, index)
        threads = 4 * group * groups
        assert heads % group == 0 and 1 <= group <= 32
        assert 32 <= threads <= 128 and threads % 32 == 0
        regions = [_align16(4 * index)] * 3 + [_align16(4 * group * index),
                                                threads * 16 * 4, _align16(2 * 4 * group), 256]
        assert nbytes == sum(regions) <= 232448


def test_q8_layout_at_the_flagship():
    """16 heads of 64: the whole merged row in one pass, 2 position groups of
    64 threads (128 a block), 13,376 bytes at index 63."""
    assert q8_layout(16, 63) == (16, 2, 13376)
    assert q8_layout(16, 17)[:2] == (16, 2)
    with pytest.raises(ValueError, match="shared memory"):
        q8_layout(16, 20000)


@pytest.mark.parametrize("groups", [1, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("index", [0, 1, 17, 31, 63, 191, 6143])
def test_q8_walk_covers_every_position_once_in_order(index, groups):
    """Each position group walks its positions t = g (mod groups) in
    increasing order (the order its f32 sums are taken in), and together the
    groups take every live position once and nothing at or past index."""
    walk = q8_walk(index, groups)
    assert len(walk) == groups
    assert sorted(t for ts in walk for t in ts) == list(range(index))
    for g, ts in enumerate(walk):
        assert ts == sorted(ts) and all(t % groups == g for t in ts)

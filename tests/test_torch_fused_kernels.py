"""The plain versions of the beam step's opt-in kernels against mic_tpu's
Pallas kernels, run in interpret mode on the CPU (as mic_tpu's own tests run
them), from the same numpy inputs:

  - ops/lazy_attention.py::fused_lazy_attention (mode "1", the blocked
    kernel) on a bfloat16 cache and on the canonical int8 cache with one
    scale per (row, position, head), at several write indices;
  - ops/cross_attention.py::fused_cross_attention (bfloat16) at S = 50 and
    a ragged S;
  - ops/ln_gemm.py::ln_gemm and ops/fused_mlp.py::fused_mlp in bfloat16
    and float32 at N = 8 and 32 rows, and fused_mlp with each of the other
    activations of nn/layers.py.

The port's wrappers run their plain version on CPU tensors (no launch is
counted).  Tolerances: the attention outputs within one bfloat16 ulp (both
round the same weights and outputs to bfloat16 after f32 sums in another
order; equal in these draws), the ancestry masks exactly; ln_gemm within
one bfloat16 ulp of the output in bfloat16 (the sum rounded at the same
point) and 1e-5 in float32; fused_mlp within 1e-2 of the largest output in
bfloat16 (an f32 difference in fc1 can move a bfloat16 rounding of the
intermediate by one ulp before the 1024-term fc2 sum; 3.2e-3 measured) and
1e-5 in float32.  The CUDA kernels are held to these plain versions in
tests/test_torch_cuda_kernels.py and chip_smoke.py.

The kernels' host-side planners are held here too: ``mlp_splits`` (the
fused MLP's depth splits), ``ln_splits`` (LN -> GEMM's) and
``blocked_layout`` (the blocked attention's shared memory: its list of
admitted rows, or none, and its chunk of staged rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.ops import cross_attention as jax_cross
from mic_tpu.ops import fused_mlp as jax_mlp
from mic_tpu.ops import lazy_attention as jax_lazy
from mic_tpu.ops import ln_gemm as jax_ln_gemm
from mic_tpu.ops.quant import quantize_rows_dynamic as jax_quantize_rows
from mic_tpu_torch.ops import cross_attention, fused_mlp, lazy_attention, ln_gemm


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _to_jax(t):
    """A torch tensor as a JAX array of the same dtype and values."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _bf16_ulp(x):
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(1.0, e - 8)


def _within_one_ulp(got, ref):
    ref = np.asarray(ref, np.float32)
    assert (np.abs(got.float().numpy() - ref) <= _bf16_ulp(ref)).all()


def _ancestry(rng, b, beams, t, index):
    anc = rng.integers(0, beams, (b, beams, t)).astype(np.int32)
    anc[:, :, index:] = np.arange(beams)[None, :, None]
    return anc


@pytest.mark.parametrize("index,seed", [(0, 0), (1, 1), (9, 2), (15, 3)])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_fused_lazy_attention_plain_matches_pallas_kernel(kv, index, seed):
    """Mode "1" on the pre-update cache: the port's plain version against
    _kernel_bf16 / _kernel_q8 in interpret mode, on the mask each package
    builds from the same ancestry (equal)."""
    b, beams, heads, dh, t = 2, 4, 2, 64, 16
    hd = heads * dh
    rng = np.random.default_rng(seed)
    q, ks, vs = (_bf16(rng.normal(size=(b, beams, hd)) * s) for s in (0.3, 0.5, 0.5))
    prefix = [rng.normal(size=(b * beams, t, hd)).astype(np.float32) * 0.5 for _ in range(2)]
    for p in prefix:
        p[:, index:] = 0.0
    anc = _ancestry(rng, b, beams, t, index)
    amask = lazy_attention.build_ancestry_mask(torch.from_numpy(anc), index)
    jmask = jax_lazy.build_ancestry_mask(jnp.asarray(anc), jnp.asarray(index, jnp.int32))
    np.testing.assert_array_equal(amask.numpy(), np.asarray(jmask))

    if kv == "int8":
        caches, jcaches = [], []
        for p in prefix:  # the canonical layout: a scale per (row, position, head)
            values, scales = jax_quantize_rows(jnp.asarray(p.reshape(b * beams, t, heads, dh)))
            jcaches.append({"q": values, "s": scales[..., 0]})
            caches.append({"q": torch.from_numpy(np.array(values).reshape(b * beams, t, hd)),
                           "s": torch.from_numpy(np.array(scales[..., 0]))})
    else:
        caches = [_bf16(p) for p in prefix]
        jcaches = [_to_jax(c) for c in caches]
    ref = jax_lazy.fused_lazy_attention(
        _to_jax(q), *jcaches, _to_jax(ks), _to_jax(vs), jmask, beams, heads, interpret=True,
    )
    before = [c["q"].clone() if kv == "int8" else c.clone() for c in caches]
    launches = lazy_attention.fused_lazy_attention.launches
    got = lazy_attention.fused_lazy_attention(q, *caches, ks, vs, amask, beams, heads,
                                              positions=index)
    assert lazy_attention.fused_lazy_attention.launches == launches  # CPU: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (b, beams, hd)
    _within_one_ulp(got, ref)
    for c, old in zip(caches, before):  # read, never written
        assert torch.equal(c["q"] if kv == "int8" else c, old)


@pytest.mark.parametrize("s", [50, 37])
def test_fused_cross_attention_plain_matches_pallas_kernel(s):
    """bf16 cross-attention over (B, S, H, Dh) encoder K/V, every position
    live, at the flagship's S = 50 and a ragged S = 37."""
    b, beams, heads, dh = 4, 4, 2, 64
    hd = heads * dh
    rng = np.random.default_rng(s)
    q = _bf16(rng.normal(size=(b, beams, hd)) * 0.3)
    ek, ev = (_bf16(rng.normal(size=(b, s, heads, dh)) * 0.5) for _ in range(2))
    ref = jax_cross.fused_cross_attention(_to_jax(q), _to_jax(ek), _to_jax(ev), beams, heads,
                                          interpret=True)
    launches = cross_attention.fused_cross_attention.launches
    got = cross_attention.fused_cross_attention(q, ek, ev, beams, heads)
    assert cross_attention.fused_cross_attention.launches == launches
    _within_one_ulp(got, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [8, 32])
def test_ln_gemm_plain_matches_pallas_kernel(n, dtype):
    d, o = 128, 384
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) * 2 + 0.5).to(dtype)
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=(d,)).astype(np.float32)).to(dtype)
    shift = torch.from_numpy(0.1 * rng.normal(size=(d,)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(0.05 * rng.normal(size=(d, o)).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(0.1 * rng.normal(size=(o,)).astype(np.float32)).to(dtype)
    assert ln_gemm.supports(x, w)
    ref = np.asarray(jax_ln_gemm.ln_gemm(*map(_to_jax, (x, scale, shift, w, bias)), 1e-5, True),
                     np.float32)
    got = ln_gemm.ln_gemm(x, scale, shift, w, bias, 1e-5)
    assert got.dtype == dtype and got.shape == (n, o)
    if dtype == torch.bfloat16:
        _within_one_ulp(got, ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [8, 32])
def test_fused_mlp_plain_matches_pallas_kernel(n, dtype):
    """F = 1024 runs the TPU kernel as two 512-wide chunks."""
    d, f = 128, 1024
    rng = np.random.default_rng(n + 1)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dtype)
    w1 = torch.from_numpy(0.1 * rng.normal(size=(d, f)).astype(np.float32)).to(dtype)
    b1 = torch.from_numpy(0.1 * rng.normal(size=(f,)).astype(np.float32)).to(dtype)
    w2 = torch.from_numpy(0.05 * rng.normal(size=(f, d)).astype(np.float32)).to(dtype)
    b2 = torch.from_numpy(0.1 * rng.normal(size=(d,)).astype(np.float32)).to(dtype)
    ref = np.asarray(jax_mlp.fused_mlp(*map(_to_jax, (x, w1, b1, w2, b2)), "gelu", True),
                     np.float32)
    launches = fused_mlp.fused_mlp.launches
    got = fused_mlp.fused_mlp(x, w1, b1, w2, b2, "gelu")
    assert fused_mlp.fused_mlp.launches == launches
    assert got.dtype == dtype and got.shape == (n, d)
    got = got.float().numpy()
    if dtype == torch.bfloat16:
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the gelu alone: the same polynomial as mic_tpu's kernel
    z = torch.linspace(-6, 6, 4001)
    np.testing.assert_allclose(fused_mlp.gelu_erf(z).numpy(),
                               np.asarray(jax_mlp._gelu_erf(jnp.asarray(z.numpy()))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("activation", ["gelu_tanh", "quick_gelu", "relu", "silu"])
def test_fused_mlp_plain_other_activations_match_pallas_kernel(activation, dtype):
    """mic_tpu's kernel takes every activation of nn/layers.py; so does the
    port's (same tolerances as the gelu)."""
    n, d, f = 8, 128, 512
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dtype)
    w1 = torch.from_numpy(0.1 * rng.normal(size=(d, f)).astype(np.float32)).to(dtype)
    b1 = torch.from_numpy(0.1 * rng.normal(size=(f,)).astype(np.float32)).to(dtype)
    w2 = torch.from_numpy(0.05 * rng.normal(size=(f, d)).astype(np.float32)).to(dtype)
    b2 = torch.from_numpy(0.1 * rng.normal(size=(d,)).astype(np.float32)).to(dtype)
    ref = np.asarray(jax_mlp.fused_mlp(*map(_to_jax, (x, w1, b1, w2, b2)), activation, True),
                     np.float32)
    got = fused_mlp.fused_mlp(x, w1, b1, w2, b2, activation).float().numpy()
    if dtype == torch.bfloat16:
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sms", [1, 114, 132])
@pytest.mark.parametrize("cols,depth", [(4096, 1024), (1024, 4096), (1024, 256), (256, 1024)])
@pytest.mark.parametrize("rows", [1, 8, 32, 70, 128, 1024, 4096])
def test_mlp_splits_cover_every_slice_once(rows, cols, depth, sms):
    """Each split of a product (the kernel's blockIdx.z of gridDim.z) sums
    slices [z S / Z, (z + 1) S / Z): together every 64-deep slice once,
    each split at least one, and the blocks no more than the SMs unless the
    output tiles alone exceed them."""
    splits = fused_mlp.mlp_splits(rows, cols, depth, sms)
    slices = depth // 64
    tiles = -(-rows // 128) * -(-cols // 256)
    assert 1 <= splits <= slices
    assert tiles * splits <= max(sms, tiles)
    spans = [range(z * slices // splits, (z + 1) * slices // splits) for z in range(splits)]
    assert all(len(span) for span in spans)
    assert [s for span in spans for s in span] == list(range(slices))


@pytest.mark.parametrize("d,o", [(256, 384), (160, 192), (1024, 3072)])
@pytest.mark.parametrize("n", [1, 8, 32, 70, 129, 1024])
def test_ln_splits_cover_every_slice_once(n, d, o):
    """LN -> GEMM's depth splits over the ceil(D / 64) slices (D = 160: the
    last slice half past D) on its 128 x 192 tiles: every slice once, each
    split at least one, and the blocks no more than the SMs unless the
    output tiles alone exceed them."""
    sms = 132
    splits = ln_gemm.ln_splits(n, d, o, sms)
    slices = -(-d // 64)
    tiles = -(-n // 128) * -(-o // 192)
    assert 1 <= splits <= slices
    assert tiles * splits <= max(sms, tiles)
    spans = [range(z * slices // splits, (z + 1) * slices // splits) for z in range(splits)]
    assert all(len(span) for span in spans)
    assert [s for span in spans for s in span] == list(range(slices))


def test_ln_splits_at_the_flagship():
    """D=1024, O=3072 on 132 SMs: N=1024 is 8 x 16 tiles of 128 x 192, one
    wave, unsplit; N=32 (one row tile of 16 column tiles) takes 8 splits."""
    assert ln_gemm.ln_splits(1024, 1024, 3072, 132) == 1
    assert ln_gemm.ln_splits(32, 1024, 3072, 132) == 8


def test_mlp_splits_at_the_flagship():
    """D=1024, F=4096 on 132 SMs: fc1 at N=1024 is 8 x 16 tiles, one wave,
    unsplit; fc2's 8 x 4 tiles take four splits; at N=32 (one row tile)
    fc1 takes 8 and fc2 33."""
    assert fused_mlp.mlp_splits(1024, 4096, 1024, 132) == 1
    assert fused_mlp.mlp_splits(1024, 1024, 4096, 132) == 4
    assert fused_mlp.mlp_splits(32, 4096, 1024, 132) == 8
    assert fused_mlp.mlp_splits(32, 1024, 4096, 132) == 33


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("beams", range(1, 9))
def test_blocked_layout_takes_every_shape_the_earlier_walk_took(beams, q8):
    """The earlier kernel (one thread a row, csrc/attend_rows.cuh) held q
    and every (beam, row) score in shared memory, 4 K (64 + K P) bytes of a
    block's 232448: every such P still fits, with at least one staged row
    (two chunks, or one that K and V take in turn); listed where the list
    fits beside two chunks of min(rows, 32) rows (the flagship's index 63
    always, its rows in one chunk); and a P whose scores alone exceed the
    block is refused."""
    limit = 232448
    longest = (limit // (4 * beams) - 64) // beams
    row_bytes = 148 if q8 else 144
    for positions in (0, 1, 63, 64, longest // 2, longest):
        compact, stage, shared, nbytes = lazy_attention.blocked_layout(beams, positions, q8)
        rows = beams * positions
        assert 1 <= stage <= max(1, min(lazy_attention._STAGE_ROWS, rows))
        assert nbytes <= limit
        assert nbytes >= (4 * max(beams * rows, 8 * beams * 64) + (4 * rows if compact else 0)
                          + (1 if shared else 2) * stage * row_bytes)
        if compact:
            assert stage >= min(32, rows) and not shared
    compact, stage, shared, _ = lazy_attention.blocked_layout(beams, 63, q8)
    assert compact and not shared and stage == min(lazy_attention._STAGE_ROWS, beams * 63)
    with pytest.raises(ValueError, match="shared memory"):
        lazy_attention.blocked_layout(beams, limit // (4 * beams * beams) + 1, q8)

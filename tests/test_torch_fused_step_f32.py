"""A float32 model's instances of rows 2, 3, 13, 14, 15 and 16 against mic_tpu.

mic_tpu's kernels have no dtype gate: on the default float32 model its
int8-cache lazy attention (row 2, fused_lazy_attention_dma), its blocked
lazy attention (row 3, fused_lazy_attention, float and per-head int8
caches), its cross-attention kernels (rows 14 and 13,
fused_cross_attention and fused_cross_attention_dma) and LN -> GEMM (row
15) take float32 caches, q and weights.  The port's plain versions define
those float32 functions, and the CUDA kernels are held to them on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).  Here, on the CPU, from
the same numpy inputs, each plain version is held to mic_tpu's Pallas
kernel run in interpret mode:

  - rows 3, 13 and 14 bit-equal but where a softmax weight rounds to the
    neighbouring bfloat16: both round q (and the step rows) and every weight
    to bfloat16 and keep the float32 K and V rows, with one bfloat16
    rounding of the output, but their exp and sums differ in the last f32
    bit, which can move a weight's rounding (``_near_bit_equal``: at most 5%
    of the outputs not bit-equal, each within one bfloat16 ulp of itself
    plus 2**-8 of the largest |V| value; 2.4% and 0.8% the most measured,
    and 0 in most draws);
  - row 15 within 1e-5: f32 statistics and an f32 product, summed in
    another order;
  - row 16 (fused_mlp) within 1e-5 under each activation of its kernel:
    two f32 products and the activation in f32, summed in another order;
  - row 2 on bfloat16-valued float32 q and step rows, which both sides take
    exactly: the written int8 column and its scale bit-equal, the outputs
    within 2e-2, because mic_tpu rounds its weights to bfloat16 and the
    port at float32 does not.

The layouts the float32 kernels share with their wrappers are pinned
against a hand count of the kernels' shared bytes, and a small-width
float32 beam generate under each path that no other test drives at float32
(the whole fused step, fused_mlp included, and the step without it, with
either cache, and with merged_cross) against mic_tpu's generate, with each
wrapper's calls counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.ops import cross_attention as jax_cross
from mic_tpu.ops import fused_mlp as jax_mlp
from mic_tpu.ops import lazy_attention as jax_lazy
from mic_tpu.ops import ln_gemm as jax_ln_gemm
from mic_tpu.ops.image_prep import preprocess_images as jax_preprocess
from mic_tpu.ops.quant import quantize_rows_dynamic as jax_quantize_rows
from mic_tpu_torch.models import mbart_decoder
from mic_tpu_torch.nn import attention
from mic_tpu_torch.ops import cross_attention, fused_mlp, lazy_attention, ln_gemm
from mic_tpu_torch.ops.image_prep import preprocess_images
from test_torch_captioner import _images, _models
from test_torch_fused_step import _config, _set

B, BEAMS, HEADS, DH, T = 2, 4, 2, 64, 16
HD = HEADS * DH


def _f32(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _ancestry(rng, b, beams, t, index):
    anc = rng.integers(0, beams, (b, beams, t)).astype(np.int32)
    anc[:, :, index:] = np.arange(beams)[None, :, None]
    return anc


def _jnp(t):
    return jnp.asarray(t.numpy())


def _near_bit_equal(got, ref, vmax):
    """Outputs bit-equal to mic_tpu's but where a bfloat16 weight rounded
    the other way: at most 5% differ, each by at most one bfloat16 ulp of
    the output plus one of a weight (2**-8 relative) times the largest |V|."""
    got, ref = got.numpy(), np.asarray(ref)
    _, e = np.frexp(np.abs(ref))
    differ = got != ref
    assert differ.mean() <= 0.05, differ.mean()
    assert (np.abs(got - ref) <= np.ldexp(1.0, e - 8) + 2.0**-8 * vmax).all()


@pytest.mark.parametrize("index,seed", [(0, 60), (1, 61), (9, 62), (15, 63)])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_fused_lazy_attention_f32_plain_equals_pallas_kernel(kv, index, seed):
    """Row 3 at float32 (mode "1"): float32 q and step rows over a float32
    cache, or over the canonical int8 cache (a scale per row, position and
    head), against _kernel_bf16 / _kernel_q8 in interpret mode: bit-equal
    but where a weight rounds the other way (the int8 cache at index 15: 25
    of 1,024 outputs, the same 25 as with bfloat16 q and step rows), the
    caches read and never written."""
    rng = np.random.default_rng(seed)
    q, ks, vs = (_f32(rng, B, BEAMS, HD, scale=s) for s in (0.3, 0.5, 0.5))
    prefix = [rng.normal(size=(B * BEAMS, T, HD)).astype(np.float32) * 0.5 for _ in range(2)]
    for p in prefix:
        p[:, index:] = 0.0
    anc = _ancestry(rng, B, BEAMS, T, index)
    amask = lazy_attention.build_ancestry_mask(torch.from_numpy(anc), index)
    jmask = jax_lazy.build_ancestry_mask(jnp.asarray(anc), jnp.asarray(index, jnp.int32))
    if kv == "int8":
        caches, jcaches = [], []
        for p in prefix:
            values, scales = jax_quantize_rows(jnp.asarray(p.reshape(B * BEAMS, T, HEADS, DH)))
            jcaches.append({"q": values, "s": scales[..., 0]})
            caches.append({"q": torch.from_numpy(np.array(values).reshape(B * BEAMS, T, HD)),
                           "s": torch.from_numpy(np.array(scales[..., 0]))})
    else:
        caches = [torch.from_numpy(p.copy()) for p in prefix]
        jcaches = [jnp.asarray(p) for p in prefix]
    ref = jax_lazy.fused_lazy_attention(_jnp(q), *jcaches, _jnp(ks), _jnp(vs), jmask, BEAMS,
                                        HEADS, interpret=True)
    before = [c["q"].clone() if kv == "int8" else c.clone() for c in caches]
    launches = lazy_attention.fused_lazy_attention.launches
    got = lazy_attention.fused_lazy_attention(q, *caches, ks, vs, amask, BEAMS, HEADS,
                                              positions=index)
    assert lazy_attention.fused_lazy_attention.launches == launches  # CPU: the plain version
    assert got.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    vmax = max(np.abs(prefix[1]).max(), vs.abs().max().item())
    _near_bit_equal(got, ref, vmax)
    for c, old in zip(caches, before):
        assert torch.equal(c["q"] if kv == "int8" else c, old)


@pytest.mark.parametrize("s", [50, 37])
@pytest.mark.parametrize("layout", ["canonical", "merged"])
def test_fused_cross_attention_f32_plain_equals_pallas_kernel(layout, s):
    """Row 14 at float32: float32 q over (B, S, H, Dh) or merged (B, S,
    H*Dh) float32 encoder K/V, every position live, against _kernel_bf16 in
    interpret mode: bit-equal but where a weight rounds the other way."""
    b = 4
    rng = np.random.default_rng(s + (100 if layout == "merged" else 0))
    q = _f32(rng, b, BEAMS, HD, scale=0.3)
    shape = (b, s, HEADS, DH) if layout == "canonical" else (b, s, HD)
    ek, ev = (_f32(rng, *shape, scale=0.5) for _ in range(2))
    ref = jax_cross.fused_cross_attention(_jnp(q), _jnp(ek), _jnp(ev), BEAMS, HEADS,
                                          interpret=True)
    launches = cross_attention.fused_cross_attention.launches
    got = cross_attention.fused_cross_attention(q, ek, ev, BEAMS, HEADS)
    assert cross_attention.fused_cross_attention.launches == launches
    assert got.dtype == torch.float32
    _near_bit_equal(got, ref, ev.abs().max().item())


@pytest.mark.parametrize("s,s_pad", [(50, 64), (37, 48), (64, 64), (1, 16)])
def test_fused_cross_attention_dma_f32_plain_equals_pallas_kernel(s, s_pad):
    """Row 13 at float32: the merged (B, S_pad, H*Dh) float32 cache, zero
    rows past S, against _kernel_cross_dma in interpret mode: bit-equal but
    where a weight rounds the other way (S=50 in 64: 17 of 2,048 outputs);
    the pad rows weigh exactly 0 on both sides."""
    b = 4
    rng = np.random.default_rng(s_pad + s)
    q = _f32(rng, b, BEAMS, HD, scale=0.3)
    ek, ev = (torch.zeros((b, s_pad, HD)) for _ in range(2))
    ek[:, :s], ev[:, :s] = _f32(rng, b, s, HD, scale=0.5), _f32(rng, b, s, HD, scale=0.5)
    ref = jax_cross.fused_cross_attention_dma(_jnp(q), _jnp(ek), _jnp(ev), s, BEAMS, HEADS,
                                              interpret=True)
    launches = cross_attention.fused_cross_attention_dma.launches
    got = cross_attention.fused_cross_attention_dma(q, ek, ev, s, BEAMS, HEADS)
    assert cross_attention.fused_cross_attention_dma.launches == launches
    assert got.dtype == torch.float32
    _near_bit_equal(got, ref, ev.abs().max().item())


@pytest.mark.parametrize("n,d,o", [(8, 128, 384), (40, 256, 768), (16, 128, 128)])
def test_ln_gemm_f32_plain_matches_pallas_kernel(n, d, o):
    """Row 15 at float32: f32 statistics, the normalised row kept in f32, an
    f32 product and the bias, against _ln_gemm_kernel in interpret mode
    within 1e-5 (sums in another order; 9.5e-7 at most measured)."""
    rng = np.random.default_rng(n + d)
    x = _f32(rng, n, d, scale=2.0) + 0.5
    scale = 1 + _f32(rng, d, scale=0.1)
    shift = _f32(rng, d, scale=0.1)
    w = _f32(rng, d, o, scale=0.05)
    bias = _f32(rng, o, scale=0.1)
    assert ln_gemm.supports(x, w)
    ref = jax_ln_gemm.ln_gemm(*(_jnp(t) for t in (x, scale, shift, w, bias)), interpret=True)
    launches = ln_gemm.ln_gemm.launches
    got = ln_gemm.ln_gemm(x, scale, shift, w, bias)
    assert ln_gemm.ln_gemm.launches == launches
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _int8_cache(rng, rows, t, hd, index):
    """A merged int8 cache quantized per row by mic_tpu's quantizer, zero
    rows from `index` on: {"q", "s"} numpy arrays."""
    prefix = rng.normal(size=(rows, t, hd)).astype(np.float32) * 0.5
    prefix[:, index:] = 0.0
    q, s = jax_quantize_rows(jnp.asarray(prefix))
    return {"q": np.array(q), "s": np.array(s[..., 0])}


@pytest.mark.parametrize("index,seed", [(0, 70), (5, 71), (17, 72), (31, 73)])
def test_lazy_attention_q8_f32_plain_matches_pallas_dma_kernel(index, seed):
    """Row 2 at float32 (mode "2" on the int8 cache) against
    fused_lazy_attention_dma in interpret mode: q and the step rows float32
    holding bfloat16 values (mic_tpu's kernel casts them to bfloat16, which
    keeps them exact); the written int8 column and its scale bit-equal, the
    other columns untouched; the float32 outputs within 2e-2 (mic_tpu
    rounds its weights to bfloat16, the port at float32 does not)."""
    b, t = 2, 32
    rng = np.random.default_rng(seed)

    def bf16_valued(scale):
        return _f32(rng, b, BEAMS, HD, scale=scale).bfloat16().float()

    q, ks, vs = bf16_valued(0.3), bf16_valued(0.5), bf16_valued(0.5)
    ck, cv = (_int8_cache(rng, b * BEAMS, t, HD, index) for _ in range(2))
    anc = _ancestry(rng, b, BEAMS, t, index)
    idx = jnp.asarray(index, jnp.int32)
    ref, rk, rv = jax_lazy.fused_lazy_attention_dma(
        _jnp(q), jax.tree.map(jnp.asarray, ck), jax.tree.map(jnp.asarray, cv), _jnp(ks),
        _jnp(vs), jax_lazy.build_ancestry_mask(jnp.asarray(anc), idx), idx, BEAMS, HEADS,
        interpret=True,
    )
    tk = {n: torch.from_numpy(a.copy()) for n, a in ck.items()}
    tv = {n: torch.from_numpy(a.copy()) for n, a in cv.items()}
    launches = lazy_attention.lazy_attention_q8.launches
    got = lazy_attention.lazy_attention_q8(q, tk, tv, ks, vs, torch.from_numpy(anc), index, HEADS)
    assert lazy_attention.lazy_attention_q8.launches == launches  # CPU: the plain version
    assert got.dtype == torch.float32
    for mine, theirs, before in ((tk, rk, ck), (tv, rv, cv)):
        for name in ("q", "s"):
            np.testing.assert_array_equal(mine[name].numpy()[:, :index + 1],
                                          np.asarray(theirs[name])[:, :index + 1])
            np.testing.assert_array_equal(mine[name].numpy()[:, index + 1:],
                                          before[name][:, index + 1:])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2)


def _align16(x):
    return (x + 15) // 16 * 16


@pytest.mark.parametrize("beams,positions", [(4, 63), (2, 17), (3, 40), (8, 63), (8, 850),
                                             (1, 57950)])
def test_blocked_layout_f32_counts_the_kernels_bytes(beams, positions):
    """blocked_layout(..., f32=True), the float32 cache's block, against a
    hand count of csrc/lazy_attention.cu's regions: the scores of every
    (beam, row) (at least the eight warps' partial sums); the list of
    admitted rows and the warps' counts where compact; the beams' q rows in
    f32; two chunks (one where shared) of 272-byte staged rows, up to 96.
    (The per-head int8 cache under float32 q lays out as under bfloat16 q:
    its rows are widened to bf16 as they are staged.)"""
    compact, stage, shared, nbytes = lazy_attention.blocked_layout(beams, positions, False, True)
    rows = beams * positions
    regions = [_align16(4 * max(beams * rows, 8 * beams * 64)),
               _align16(4 * (rows + 8)) if compact else 0,
               _align16(4 * beams * 64),
               (1 if shared else 2) * stage * 272]
    assert nbytes == sum(regions) <= 232448
    assert 1 <= stage <= min(96, rows)
    assert compact == (positions < 850) and shared == (positions == 57950)


def test_blocked_layout_f32_at_the_flagship():
    """K=4 at index 63: the list of admitted rows, two chunks of 96 staged
    rows, 62,480 bytes (three blocks an SM); where not even one 272-byte
    row fits beside the scores, the layout raises."""
    assert lazy_attention.blocked_layout(4, 63, False, True) == (True, 96, False, 62480)
    with pytest.raises(ValueError, match="shared memory"):
        lazy_attention.blocked_layout(1, 58048, False, True)


@pytest.mark.parametrize("heads,index", [(16, 63), (16, 17), (2, 31), (12, 0)])
def test_q8_layout_is_the_same_at_float32(heads, index):
    """Row 2's block stages no row of q or of the step rows (they are read
    from device memory), so its shared memory is the same whatever their
    dtype: the sources, K and V row scales and scores, the position groups'
    sums, the step scores and weights, the warps' amaxes, counted here; at
    the flagship 13,376 bytes."""
    group, groups, nbytes = lazy_attention.q8_layout(heads, index)
    regions = [_align16(4 * index)] * 3 + [_align16(4 * group * index),
                                            4 * group * groups * 16 * 4, _align16(8 * group), 256]
    assert nbytes == sum(regions)
    if (heads, index) == (16, 63):
        assert nbytes == 13376


FUSED_NO_MLP = {"MIC_TPU_FUSED_LAZY_ATTN": "1",
                "MIC_TPU_EXPERIMENTAL": "fused_cross_attn,ln_qkv"}
FUSED_STEP = {"MIC_TPU_FUSED_LAZY_ATTN": "1",
              "MIC_TPU_EXPERIMENTAL": "fused_cross_attn,fused_mlp,ln_qkv"}
F32_PATHS = {
    "fused_step_float": (FUSED_STEP, None, ("fused_lazy_attention", "fused_cross_attention",
                                            "ln_gemm", "fused_mlp")),
    "fused_step_int8": (FUSED_STEP, "int8", ("fused_lazy_attention", "fused_cross_attention",
                                             "ln_gemm", "fused_mlp")),
    # case: (switches, kv_quant, wrappers called once a layer a step)
    "fused_float": (FUSED_NO_MLP, None, ("fused_lazy_attention", "fused_cross_attention",
                                         "ln_gemm")),
    "fused_int8": (FUSED_NO_MLP, "int8", ("fused_lazy_attention", "fused_cross_attention",
                                          "ln_gemm")),
    "fused_merged": ({"MIC_TPU_FUSED_LAZY_ATTN": "1",
                      "MIC_TPU_EXPERIMENTAL": "merged_cross,ln_qkv"}, None,
                     ("fused_lazy_attention", "fused_cross_attention_dma", "ln_gemm")),
}


@pytest.mark.parametrize("case", sorted(F32_PATHS))
def test_f32_fused_path_generate_near_jax(case, monkeypatch):
    """A small-width float32 beam-4 generate under the whole fused step
    (fused_mlp included) and the step without fused_mlp, with the float and
    the per-head int8 cache, and with merged_cross, against mic_tpu's
    generate under the same switches (its XLA path on the CPU): each
    wrapper's plain version once a layer a step; best scores within 1e-2
    (the port rounds the attention's weights and outputs to bfloat16 where
    mic_tpu's float32 XLA path does not, as
    test_torch_fused_step.py::test_fused_beam_generate_near_jax bounds);
    sequences equal with the float cache, and with the int8 one equal but
    for at most one image, whose near-tie between two captions can flip
    (the kernel attends to each step row unquantized, the XLA path to it
    quantized)."""
    env, kv_quant, called = F32_PATHS[case]
    _set(monkeypatch, env)
    config = _config()
    assert config.dtype == "float32"
    jax_model, jparams, model, tparams = _models(config, seed=2, scale=0.5)
    calls = {name: 0 for name in called}
    modules = {"ln_gemm": ln_gemm, "fused_mlp": mbart_decoder}
    for name in called:
        module = modules.get(name, attention)
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)
    u8 = _images(n=2, seed=3)
    kw = dict(num_beams=4, max_length=12, forced_bos_token_id=7, kv_quant=kv_quant)
    ref = jax.jit(lambda p, x: jax_model.generate(p, x, **kw))(
        jparams, jax_preprocess(jnp.asarray(u8), 32))
    out = model.generate(tparams, preprocess_images(torch.from_numpy(u8), 32), **kw)
    layers = config.decoder.num_layers
    assert calls == {name: layers * out.steps for name in called}
    differ = (out.sequences.numpy() != np.asarray(ref.sequences)).any(axis=1)
    assert differ.sum() <= (1 if kv_quant else 0), differ
    assert (out.sequences[:, 1] == 7).all()
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), rtol=0, atol=1e-2)


@pytest.mark.parametrize("n,splits", [(1024, 1), (256, 2), (32, 4), (8, 4), (4096, 1)])
def test_ln_splits_f32_fill_the_card(n, splits):
    """Row 15 f32's depth splits at D=1024, O=3072 on 132 SMs: its 128 x 96
    tiles (ceil(N / 128) x 32 of them) cut in depth as far as the SMs they
    leave idle allow, at most 16 splits of four 16-deep slices."""
    assert ln_gemm.ln_splits_f32(n, 1024, 3072, 132) == splits
    assert ln_gemm.ln_splits_f32(n, 128, 384, 132) <= 128 // 64


@pytest.mark.parametrize("activation", ["gelu", "gelu_tanh", "quick_gelu", "relu", "silu"])
@pytest.mark.parametrize("n,d,f", [(8, 128, 512), (32, 256, 1024)])
def test_fused_mlp_f32_plain_matches_pallas_kernel(n, d, f, activation):
    """Row 16 on a float32 model, every activation its CUDA kernel takes
    (``fused_mlp._ACTIVATION_IDS``): the plain version (what the float32
    kernel is held to on the card) against mic_tpu's kernel in interpret
    mode on the same float32 inputs, within 1e-5 (two f32 products and the
    activation in f32, summed in another order; the gelu's erf the same
    Abramowitz & Stegun polynomial on both sides)."""
    assert activation in fused_mlp._ACTIVATION_IDS
    rng = np.random.default_rng(n + d + len(activation))
    x = _f32(rng, n, d)
    w1, b1 = _f32(rng, d, f, scale=0.1), _f32(rng, f, scale=0.1)
    w2, b2 = _f32(rng, f, d, scale=0.05), _f32(rng, d, scale=0.1)
    ref = np.asarray(jax_mlp.fused_mlp(*(jnp.asarray(t.numpy()) for t in (x, w1, b1, w2, b2)),
                                       activation, True))
    launches = fused_mlp.fused_mlp.launches
    got = fused_mlp.fused_mlp(x, w1, b1, w2, b2, activation)
    assert fused_mlp.fused_mlp.launches == launches  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)

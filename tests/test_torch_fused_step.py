"""The fully fused lazy beam step (MIC_TPU_FUSED_LAZY_ATTN=1 with
MIC_TPU_EXPERIMENTAL=fused_cross_attn,fused_mlp,ln_qkv) against mic_tpu,
its gates, and the switches the port refused until mode "0" was ported.

On the CPU the port runs each kernel's plain version, and mic_tpu, whose
gates want its accelerator, runs its XLA path: the lazy-attention chain,
the einsum cross-attention and the unfused LayerNorm and MLP.  The port's
attention kernels round q, the softmax weights and the output to bfloat16
as the TPU kernels do; mic_tpu's XLA path at float32 does not round, so
module outputs are held within 2e-2 of their largest magnitude (about one
bfloat16 rounding of attention outputs near 1, passed through the o
projection; 5.1e-3 measured) and written cache columns within 1e-6 (each
side projects them with its own matmul).  Where mic_tpu's own kernel runs
on the CPU (its cross-attention and LN -> GEMM kernels in interpret mode),
the port's plain version is held within 1e-5.  The int8 cache bounds and
generate's tolerances are stated where they are tested.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.core.config import CaptionerConfig, DecodeConfig, DecoderConfig, VisionConfig
from mic_tpu.nn.attention import mha_cross_grouped as jax_mha_cross_grouped
from mic_tpu.nn.attention import mha_decode_step_lazy as jax_mha_decode_step_lazy
from mic_tpu.ops import cross_attention as jax_cross
from mic_tpu.ops import lazy_attention as jax_lazy
from mic_tpu.ops import ln_gemm as jax_ln_gemm
from mic_tpu.ops.image_prep import preprocess_images as jax_preprocess
from mic_tpu.ops.quant import quantize_rows_dynamic as jax_quantize_rows
from mic_tpu_torch.core import config as port_config
from mic_tpu_torch.models import mbart_decoder
from mic_tpu_torch.models.captioner import Captioner, init_params
from mic_tpu_torch.nn import attention
from mic_tpu_torch.nn.cache import init_lazy_cache
from mic_tpu_torch.ops import cross_attention, lazy_attention, ln_gemm
from mic_tpu_torch.ops.image_prep import preprocess_images
from mic_tpu_torch.ops.quant import quantize_params_for_decode
from test_torch_captioner import _images, _models, _port

FUSED = {"MIC_TPU_FUSED_LAZY_ATTN": "1",
         "MIC_TPU_EXPERIMENTAL": "fused_cross_attn,fused_mlp,ln_qkv"}


def _config(vocab=600, **kw):
    """A width the beam step's kernels take: H*Dh = 128 with Dh = 64,
    d_model a multiple of 128, ffn_dim of 512."""
    return CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=vocab, d_model=128, num_heads=2, ffn_dim=512,
                                   max_position_embeddings=64),
        **kw,
    )


def _set(monkeypatch, env):
    for key in ("MIC_TPU_FUSED_LAZY_ATTN", "MIC_TPU_EXPERIMENTAL"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)


def _tree(rng, d):
    return {
        "qkv": {"kernel": rng.normal(size=(d, 3 * d)).astype(np.float32) * 0.1,
                "bias": rng.normal(size=(3 * d,)).astype(np.float32) * 0.1},
        "o": {"kernel": rng.normal(size=(d, d)).astype(np.float32) * 0.1,
              "bias": rng.normal(size=(d,)).astype(np.float32) * 0.1},
    }


def _torch_tree(tree):
    return {k: {n: torch.from_numpy(a) for n, a in p.items()} for k, p in tree.items()}


@pytest.mark.parametrize("index,seed", [(0, 0), (7, 1), (15, 2)])
@pytest.mark.parametrize("ln", [False, True])
def test_mha_decode_step_lazy_mode_1_near_jax_xla_path(ln, index, seed):
    """Mode "1" (the blocked kernel's plain version on the step's ancestry
    mask, then the column store), with and without the LayerNorm folded into
    the qkv GEMM, against mic_tpu's XLA path on the same float32 inputs (its
    ln branch runs its LN -> GEMM kernel in interpret mode)."""
    b, beams, heads, dh, t = 2, 4, 2, 64, 16
    d = heads * dh
    rng = np.random.default_rng(seed)
    params = _tree(rng, d)
    lnp = {"scale": (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32),
           "bias": (0.1 * rng.normal(size=(d,))).astype(np.float32)}
    x = rng.normal(size=(b * beams, 1, d)).astype(np.float32)
    ck, cv = (rng.normal(size=(b * beams, t, d)).astype(np.float32) * 0.5 for _ in range(2))
    ck[:, index:] = cv[:, index:] = 0.0
    anc = rng.integers(0, beams, (b, beams, t)).astype(np.int32)
    anc[:, :, index:] = np.arange(beams)[None, :, None]

    ref, rk, rv = jax_mha_decode_step_lazy(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(anc), jnp.asarray(index, jnp.int32), heads, beams,
        ln=(jax.tree.map(jnp.asarray, lnp), 1e-5) if ln else None,
    )
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tanc = torch.from_numpy(anc)
    got = attention.mha_decode_step_lazy(
        _torch_tree(params), torch.from_numpy(x), tk, tv, tanc, index, heads, beams,
        amask=lazy_attention.build_ancestry_mask(tanc, index),
        ln=({n: torch.from_numpy(a) for n, a in lnp.items()}, 1e-5) if ln else None,
    )
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() < 2e-2 * np.abs(ref).max()
    others = np.arange(t) != index
    for mine, theirs in ((tk, rk), (tv, rv)):
        mine, theirs = mine.numpy(), np.asarray(theirs)
        np.testing.assert_array_equal(mine[:, others], theirs[:, others])
        np.testing.assert_allclose(mine[:, index], theirs[:, index], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("index,seed", [(0, 3), (9, 4)])
def test_mha_decode_step_lazy_mode_1_int8_near_jax_xla_path(index, seed):
    """The canonical int8 cache (a scale per row, position and head) in mode
    "1" against mic_tpu's XLA path on its canonical (B*K, T, H, Dh) int8
    cache: the step column's int8 values within one step and its scales
    within 1e-6 (both quantize the same row per head), every other column
    untouched; outputs within 3e-2 of their largest magnitude: the kernel
    attends to the step row unquantized, the XLA path to it quantized
    (1.1e-2 measured)."""
    b, beams, heads, dh, t = 2, 4, 2, 64, 16
    d = heads * dh
    rng = np.random.default_rng(seed)
    params = _tree(rng, d)
    x = rng.normal(size=(b * beams, 1, d)).astype(np.float32)
    caches, jcaches = [], []
    for _ in range(2):
        p = rng.normal(size=(b * beams, t, heads, dh)).astype(np.float32) * 0.5
        p[:, index:] = 0.0
        values, scales = jax_quantize_rows(jnp.asarray(p))
        jcaches.append({"q": values, "s": scales[..., 0]})
        caches.append({"q": torch.from_numpy(np.array(values).reshape(b * beams, t, d)),
                       "s": torch.from_numpy(np.array(scales[..., 0]))})
    anc = rng.integers(0, beams, (b, beams, t)).astype(np.int32)
    anc[:, :, index:] = np.arange(beams)[None, :, None]
    ref, rk, rv = jax_mha_decode_step_lazy(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), *jcaches, jnp.asarray(anc),
        jnp.asarray(index, jnp.int32), heads, beams,
    )
    tanc = torch.from_numpy(anc)
    assert lazy_attention.supports(caches[0], beams, heads, dh)
    got = attention.mha_decode_step_lazy(
        _torch_tree(params), torch.from_numpy(x), *caches, tanc, index, heads, beams,
        amask=lazy_attention.build_ancestry_mask(tanc, index),
    )
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() < 3e-2 * np.abs(ref).max()
    others = np.arange(t) != index
    for mine, theirs in zip(caches, (rk, rv)):
        q_mine = mine["q"].numpy().reshape(b * beams, t, heads, dh)
        q_ref = np.asarray(theirs["q"])
        np.testing.assert_array_equal(q_mine[:, others], q_ref[:, others])
        np.testing.assert_array_equal(mine["s"].numpy()[:, others], np.asarray(theirs["s"])[:, others])
        assert np.abs(q_mine[:, index].astype(np.int32) - q_ref[:, index]).max() <= 1
        np.testing.assert_allclose(mine["s"].numpy()[:, index], np.asarray(theirs["s"])[:, index],
                                   rtol=1e-6)


@pytest.mark.parametrize("ref_path", ["xla", "kernel"])
def test_mha_cross_grouped_kernel_matches_jax(ref_path):
    """kernel=True (the cross-attention kernel's plain version) against
    mic_tpu's XLA path (within 2e-2 of the largest output: the bfloat16
    rounding of q, the weights and the attention output; 2.7e-3 measured),
    and against
    mic_tpu's own kernel=True, which runs its Pallas kernel in interpret mode
    on the CPU (within 1e-5: the same roundings, the o projection in another
    summation order)."""
    b, beams, heads, dh, s = 2, 4, 2, 64, 50
    d = heads * dh
    rng = np.random.default_rng(5)
    params = _tree(rng, d)
    params["q"] = params.pop("qkv")
    params["q"]["kernel"] = params["q"]["kernel"][:, :d].copy()
    params["q"]["bias"] = params["q"]["bias"][:d].copy()
    x = rng.normal(size=(b * beams, 1, d)).astype(np.float32)
    ek, ev = (rng.normal(size=(b, s, heads, dh)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax_mha_cross_grouped(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(ek), jnp.asarray(ev),
        None, heads, beams, kernel=ref_path == "kernel",
    ))
    got = attention.mha_cross_grouped(_torch_tree(params), torch.from_numpy(x),
                                      torch.from_numpy(ek), torch.from_numpy(ev), heads,
                                      kernel=True).numpy()
    if ref_path == "kernel":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - ref).max() < 2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_fused_beam_generate_near_jax(kv_quant, monkeypatch):
    """Beam-4 generate under the four switches against mic_tpu's generate
    under the same switches (its XLA path on the CPU; with kv_quant="int8"
    on its canonical per-head cache).  Every image's best-beam score within
    1e-2: the port rounds the attention's weights and outputs to bfloat16
    where mic_tpu's float32 XLA path does not (2.7e-3 measured with the
    float cache, 1.9e-3 with the int8 one).  Sequences equal with the float
    cache; with the int8 one, where the kernel attends to each step row
    unquantized and the XLA path to it quantized, equal but for at most one
    image, whose near-tie between two captions can flip (one flips here)."""
    _set(monkeypatch, FUSED)
    config = _config()
    jax_model, jparams, model, tparams = _models(config, seed=2, scale=0.5)
    u8 = _images(n=2, seed=3)
    kw = dict(num_beams=4, max_length=12, forced_bos_token_id=7, kv_quant=kv_quant)
    ref = jax.jit(lambda p, x: jax_model.generate(p, x, **kw))(
        jparams, jax_preprocess(jnp.asarray(u8), 32)
    )
    out = model.generate(tparams, preprocess_images(torch.from_numpy(u8), 32), **kw)
    differ = (out.sequences.numpy() != np.asarray(ref.sequences)).any(axis=1)
    assert differ.sum() <= (1 if kv_quant else 0), differ
    assert (out.sequences[:, 1] == 7).all()
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), rtol=0, atol=1e-2)


ROUTES = {
    # case: (switches, images, int8 weights, kv_quant) -> wrapper calls a step
    "default": ({}, 2, False, None, {"lazy_attention": 1}),
    "all": (FUSED, 2, False, None, {"fused_lazy_attention": 1, "fused_cross_attention": 1,
                                    "ln_gemm": 1, "fused_mlp": 1}),
    "all_int8_kv": (FUSED, 2, False, "int8", {"fused_lazy_attention": 1,
                                              "fused_cross_attention": 1, "ln_gemm": 1,
                                              "fused_mlp": 1}),
    # one image: N = 4 rows, and mic_tpu's N % 8 gates turn LN -> GEMM and the MLP off
    "all_one_image": (FUSED, 1, False, None, {"fused_lazy_attention": 1,
                                              "fused_cross_attention": 1}),
    # an int8 weight tree ("kernel_q") turns them off too
    "all_int8_weights": (FUSED, 2, True, None, {"fused_lazy_attention": 1,
                                                "fused_cross_attention": 1}),
    "cross_only": ({"MIC_TPU_EXPERIMENTAL": "fused_cross_attn"}, 2, False, None,
                   {"lazy_attention": 1, "fused_cross_attention": 1}),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_fused_step_routes_as_mic_tpu(case, monkeypatch):
    """One decode step counts each wrapper's calls per layer: mic_tpu's gates,
    mirrored."""
    env, images, int8, kv_quant, want = ROUTES[case]
    _set(monkeypatch, env)
    cfg = _port(_config().decoder)
    config = port_config.CaptionerConfig(vision=port_config.VisionConfig.tiny(), decoder=cfg)
    params = init_params(config, torch.Generator().manual_seed(0))
    decoder = mbart_decoder.fuse_qkv_params(params["decoder"])
    tree = {"decoder": decoder, "shared": params["shared"]}
    if int8:
        tree = quantize_params_for_decode(tree)
    calls = {}

    def spy(module, name):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)

    spy(attention, "lazy_attention")
    spy(attention, "lazy_attention_q8")
    spy(attention, "fused_lazy_attention")
    spy(attention, "fused_cross_attention")
    spy(ln_gemm, "ln_gemm")
    spy(mbart_decoder, "fused_mlp")
    beams, t = 4, 8
    enc = torch.randn((images, 5, cfg.d_model), generator=torch.Generator().manual_seed(1))
    cross = mbart_decoder.init_cross_cache(tree["decoder"], enc, cfg, torch.float32)
    merged = not (kv_quant and env.get("MIC_TPU_FUSED_LAZY_ATTN") == "1")
    cache = init_lazy_cache(*cross, beams, t, kv_quant, merged)
    tokens = torch.full((images * beams, 1), 5, dtype=torch.int64)
    hidden, cache = mbart_decoder.decoder_step(tree["decoder"], tree["shared"], tokens, cache,
                                               cfg, torch.float32, beams)
    assert hidden.shape == (images * beams, 1, cfg.d_model) and cache.index == 1
    assert bool(torch.isfinite(hidden).all())
    want = {name: n * cfg.num_layers for name, n in want.items()}
    if kv_quant and "lazy_attention" in want:
        want["lazy_attention_q8"] = want.pop("lazy_attention")
    assert calls == want


def test_mode_resolution_and_guards_match_mic_tpu(monkeypatch):
    """resolve_mode under each override as mic_tpu's (unset: "2", mic_tpu's
    accelerator choice; mic_tpu says "0" off the TPU, where the port runs
    mode "2"'s plain version); supports, and the cross and LN -> GEMM
    guards, on the same shapes as mic_tpu's."""
    for raw in ("0", "1", "2"):
        monkeypatch.setenv("MIC_TPU_FUSED_LAZY_ATTN", raw)
        assert lazy_attention.resolve_mode(64) == jax_lazy.resolve_mode(64) == raw
    monkeypatch.delenv("MIC_TPU_FUSED_LAZY_ATTN")
    assert lazy_attention.resolve_mode(64) == "2"
    assert lazy_attention.resolve_mode(64, "1") == jax_lazy.resolve_mode(64, "1") == "1"
    for beams, t, heads, dh, scales in [(4, 16, 2, 64, 3), (4, 10, 2, 64, 3), (1, 16, 2, 64, 3),
                                        (4, 16, 4, 8, 3), (4, 16, 2, 64, 2), (4, 16, 2, 64, 0)]:
        vals = np.zeros((2 * beams, t, heads * dh), np.int8)
        if scales:
            cache = {"q": torch.from_numpy(vals),
                     "s": torch.zeros((2 * beams, t, heads)[:scales])}
            jcache = {"q": vals, "s": np.zeros((2 * beams, t, heads)[:scales], np.float32)}
        else:
            cache, jcache = torch.zeros(vals.shape), vals.astype(np.float32)
        assert (lazy_attention.supports(cache, beams, heads, dh)
                == jax_lazy.supports(jcache, beams, heads, dh))
        assert cross_attention.supports(heads, dh) == jax_cross.supports(heads, dh)
    for n, d, o in [(8, 128, 384), (4, 128, 384), (8, 96, 384), (8, 128, 200), (8, 2048, 8192)]:
        assert (ln_gemm.supports(torch.zeros(n, d), torch.zeros(d, o))
                == jax_ln_gemm.supports(np.zeros((n, d)), np.zeros((d, o))))


def test_decode_config_lazy_attn_is_not_read(monkeypatch):
    """mic_tpu never reads DecodeConfig.lazy_attn (a fault of the reference):
    the port does not either.  "0" there would raise if it were read."""
    _set(monkeypatch, {})
    config = _port(_config(decode=DecodeConfig(lazy_attn="0")))
    params = init_params(config, torch.Generator().manual_seed(0))
    px = preprocess_images(torch.from_numpy(_images(n=1)), 32)
    out = Captioner(config).generate(params, px, num_beams=4, max_length=6,
                                     forced_bos_token_id=7)
    assert out.sequences.shape == (1, 6)


REFUSED = {
    # the switches the port refused until mic_tpu's XLA lazy-attention chain
    # was ported (ROADMAP A9): mode "0" ...
    "lazy_attn_0": ({"MIC_TPU_FUSED_LAZY_ATTN": "0"}, "generate", {}),
    # ... and shapes mode "1" does not take, where mic_tpu runs that chain too
    "lazy_attn_1_beams_t": ({"MIC_TPU_FUSED_LAZY_ATTN": "1"}, "generate",
                            dict(max_length=10)),
    "lazy_attn_1_width": ({"MIC_TPU_FUSED_LAZY_ATTN": "1"}, "generate_narrow", {}),
    "lazy_attn_1_per_row_int8": ({"MIC_TPU_FUSED_LAZY_ATTN": "1",
                                  "MIC_TPU_EXPERIMENTAL": "merged_kv"}, "generate",
                                 dict(kv_quant="int8")),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_switches_raise(case, monkeypatch):
    """The switches that raised while mic_tpu's chain was not ported now run
    it where mic_tpu reads them, and raise nothing: beam-4 sequences equal
    to mic_tpu's CPU generate (which runs the same chain) and scores within
    1e-5, as test_torch_captioner.py's beam cases."""
    env, entry, kw = REFUSED[case]
    _set(monkeypatch, env)
    config = CaptionerConfig.tiny() if entry == "generate_narrow" else _config()  # H*Dh 32
    jax_model, jparams, model, tparams = _models(config, seed=2, scale=0.5)
    u8 = _images(n=2, seed=3)
    kw = dict(num_beams=4, forced_bos_token_id=7, **{"max_length": 8, **kw})
    ref = jax.jit(lambda p, x: jax_model.generate(p, x, **kw))(
        jparams, jax_preprocess(jnp.asarray(u8), 32))
    out = model.generate(tparams, preprocess_images(torch.from_numpy(u8), 32), **kw)
    np.testing.assert_array_equal(out.sequences.numpy(), np.asarray(ref.sequences))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), rtol=1e-5,
                               atol=1e-5)

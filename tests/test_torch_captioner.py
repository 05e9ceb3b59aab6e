"""The PyTorch port's captioning path (mic_tpu_torch) against mic_tpu.

The same weights (a JAX init converted with io/from_jax.py) and the same
numpy inputs go through both packages on the CPU at float32; JAX runs at
"highest" matmul precision (tests/conftest.py).  On the CPU the port's
kernels run their plain versions.  Tolerances: 1e-5 where both sides are
float32 math in a different summation order; exact where a value is only
copied (cache contents, ids, sequences).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.core.config import CaptionerConfig, DecodeConfig, DecoderConfig, VisionConfig
from mic_tpu.models import mbart_decoder as jax_dec
from mic_tpu.models.captioner import Captioner as JaxCaptioner
from mic_tpu.nn.cache import init_lazy_cache as jax_init_lazy_cache
from mic_tpu.ops.image_prep import preprocess_images as jax_preprocess
from mic_tpu.ops.quant import quantize_params_for_decode as jax_quantize_params
from mic_tpu.ops.quant import quantize_rows_dynamic as jax_quantize_rows
from mic_tpu_torch.core import config as port_config
from mic_tpu_torch.core.params import make_serving_params
from mic_tpu_torch.io.from_jax import from_jax
from mic_tpu_torch.models import captioner as captioner_mod
from mic_tpu_torch.models import mbart_decoder
from mic_tpu_torch.models.captioner import Captioner, init_params
from mic_tpu_torch.nn.cache import LazyDecoderCache
from mic_tpu_torch.ops.image_prep import preprocess_images
from mic_tpu_torch.ops.quant import quantize_params_for_decode

TOL = dict(rtol=1e-5, atol=1e-5)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(cfg):
    """The port's config class of the same name, from the same values."""
    return getattr(port_config, type(cfg).__name__).from_dict(cfg.to_dict())


def _config(vocab=600, **kw):
    return CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=vocab, max_position_embeddings=64),
        **kw,
    )


def _numpy_params(jax_model, seed, scale):
    """A param tree of mic_tpu's layout filled from numpy (nonzero biases,
    LN scales near 1): no JAX init to compile."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_model.init_params, jax.random.PRNGKey(0))

    def fill(path, leaf):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + scale * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _models(config, seed=0, scale=0.05, eos_bias=0.0):
    jax_model = JaxCaptioner(config)
    nparams = _numpy_params(jax_model, seed, scale)
    nparams["final_logits_bias"][config.decoder.eos_token_id] += eos_bias
    jparams = jax.tree.map(jnp.asarray, nparams)
    return jax_model, jparams, Captioner(_port(config)), from_jax(nparams)


def _images(n=2, size=48, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, prefix + (key,))
    else:
        yield prefix, tree


def test_encode_matches_jax():
    config = _config()
    jax_model, jparams, model, tparams = _models(config)
    u8 = _images()
    jpx = jax_preprocess(jnp.asarray(u8), 32)
    tpx = preprocess_images(torch.from_numpy(u8), 32)
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), **TOL)
    ref = np.asarray(jax_model.encode(jparams, jpx))
    got = model.encode(tparams, tpx).numpy()
    assert got.shape == ref.shape == (2, config.vision.seq_len, config.decoder.d_model)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("index", [0, 5])
def test_decoder_step_matches_jax(index):
    """One lazy decode step (all layers) on a cache with a random written
    prefix and random ancestry: hidden states within 1e-5; every cache
    column but `index` untouched (exact); column `index` within 1e-6, since
    each side computes it with its own qkv matmul."""
    config = _config()
    cfg = config.decoder
    jax_model, jparams, model, tparams = _models(config, seed=1)
    b, beams, t = 2, 4, 8
    rng = np.random.default_rng(index)
    enc = rng.normal(size=(b, config.vision.seq_len, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b * beams, 1)).astype(np.int32)
    anc = rng.integers(0, beams, (b, beams, t)).astype(np.int32)
    anc[:, :, index:] = np.arange(beams)[None, :, None]
    prefix = [
        rng.normal(size=(b * beams, t, cfg.d_model)).astype(np.float32)
        for _ in range(2 * cfg.num_layers)
    ]
    for p in prefix:
        p[:, index:] = 0.0

    jfused = jax_dec.fuse_qkv_params(jparams["decoder"])
    tfused = mbart_decoder.fuse_qkv_params(tparams["decoder"])
    for path, leaf in _leaves(jax.device_get(jfused)):
        node = tfused
        for key in path:
            node = node[key]
        np.testing.assert_array_equal(node.numpy(), leaf)

    ck, cv = jax_dec.init_cross_cache(jparams["decoder"], jnp.asarray(enc), cfg)
    jcache = jax_init_lazy_cache(
        cfg.num_layers, b, beams, t, enc.shape[1], cfg.num_heads, cfg.head_dim, merged=True
    )._replace(
        self_k=tuple(jnp.asarray(p) for p in prefix[: cfg.num_layers]),
        self_v=tuple(jnp.asarray(p) for p in prefix[cfg.num_layers:]),
        cross_k=ck, cross_v=cv, ancestry=jnp.asarray(anc),
        index=jnp.asarray(index, jnp.int32),
    )
    step = jax.jit(jax_dec._decoder_step_lazy, static_argnums=(4, 5, 6, 7))
    jh, jnew = step(
        jfused, jparams["shared"], jnp.asarray(tokens), jcache, cfg, jnp.float32, None, beams
    )

    tck, tcv = mbart_decoder.init_cross_cache(
        tparams["decoder"], torch.from_numpy(enc), _port(cfg), torch.float32
    )
    np.testing.assert_allclose(tck.numpy(), np.asarray(ck), **TOL)
    tcache = LazyDecoderCache(
        self_k=[torch.from_numpy(p.copy()) for p in prefix[: cfg.num_layers]],
        self_v=[torch.from_numpy(p.copy()) for p in prefix[cfg.num_layers:]],
        cross_k=tck, cross_v=tcv, ancestry=torch.from_numpy(anc), index=index,
    )
    th, tnew = mbart_decoder.decoder_step(
        tfused, tparams["shared"], torch.from_numpy(tokens), tcache, _port(cfg), torch.float32,
        beams
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert tnew.index == int(jnew.index) == index + 1
    others = np.arange(t) != index
    for got, ref in zip(tnew.self_k + tnew.self_v, jnew.self_k + jnew.self_v):
        got, ref = got.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(got[:, others], ref[:, others])
        np.testing.assert_allclose(got[:, index], ref[:, index], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_decoder_step_on_a_quantized_tree_matches_jax(kv_quant):
    """One lazy decode step on int8 weights (quantized by each package from
    the same fused tree), with a float or an int8 cache, against mic_tpu's
    _decoder_step_lazy (its XLA path, merged layout).  The cross caches and,
    with the float cache, the hidden states within 1e-5 (the int8 products
    are exact on both sides); columns other than `index` untouched.  With
    the int8 cache the XLA path attends to each layer's step row quantized,
    the port (as the TPU kernel) to it unquantized: hidden states within
    1e-2 of their largest magnitude (1.1e-3 measured), layer 0's step column
    within one int8 step and its scale within 1e-6 (the same row, up to the
    LayerNorm's summation order), the later layers' dequantized columns
    within 3e-2 of their largest magnitude (8.0e-3 measured)."""
    config = _config()
    cfg = config.decoder
    jax_model, jparams, model, tparams = _models(config, seed=4)
    b, beams, t, index = 2, 4, 8, 5
    rng = np.random.default_rng(5)
    enc = rng.normal(size=(b, config.vision.seq_len, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b * beams, 1)).astype(np.int32)
    anc = rng.integers(0, beams, (b, beams, t)).astype(np.int32)
    anc[:, :, index:] = np.arange(beams)[None, :, None]
    prefix = []
    for _ in range(2 * cfg.num_layers):
        p = rng.normal(size=(b * beams, t, cfg.d_model)).astype(np.float32)
        p[:, index:] = 0.0
        if kv_quant:
            q, sc = jax_quantize_rows(jnp.asarray(p))
            p = {"q": np.array(q), "s": np.array(sc[..., 0])}
        prefix.append(p)

    jtree = jax_quantize_params(dict(jparams, decoder=jax_dec.fuse_qkv_params(jparams["decoder"])))
    ttree = quantize_params_for_decode(
        dict(tparams, decoder=mbart_decoder.fuse_qkv_params(tparams["decoder"]))
    )
    ck, cv = jax_dec.init_cross_cache(jtree["decoder"], jnp.asarray(enc), cfg)
    jcache = jax_init_lazy_cache(
        cfg.num_layers, b, beams, t, enc.shape[1], cfg.num_heads, cfg.head_dim,
        kv_quant=kv_quant, merged=True,
    )._replace(
        self_k=tuple(jax.tree.map(jnp.asarray, p) for p in prefix[: cfg.num_layers]),
        self_v=tuple(jax.tree.map(jnp.asarray, p) for p in prefix[cfg.num_layers:]),
        cross_k=ck, cross_v=cv, ancestry=jnp.asarray(anc), index=jnp.asarray(index, jnp.int32),
    )
    step = jax.jit(jax_dec._decoder_step_lazy, static_argnums=(4, 5, 6, 7))
    jh, jnew = step(jtree["decoder"], jtree["shared"], jnp.asarray(tokens), jcache, cfg,
                    jnp.float32, None, beams)

    def to_torch(p):
        return {n: torch.from_numpy(a.copy()) for n, a in p.items()} if kv_quant else \
            torch.from_numpy(p.copy())

    tck, tcv = mbart_decoder.init_cross_cache(ttree["decoder"], torch.from_numpy(enc), _port(cfg),
                                              torch.float32)
    np.testing.assert_allclose(tck.numpy(), np.asarray(ck), **TOL)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(cv), **TOL)
    tcache = LazyDecoderCache(
        self_k=[to_torch(p) for p in prefix[: cfg.num_layers]],
        self_v=[to_torch(p) for p in prefix[cfg.num_layers:]],
        cross_k=tck, cross_v=tcv, ancestry=torch.from_numpy(anc), index=index,
    )
    th, tnew = mbart_decoder.decoder_step(ttree["decoder"], ttree["shared"],
                                          torch.from_numpy(tokens), tcache, _port(cfg), torch.float32,
                                          beams)
    others = np.arange(t) != index
    pairs = list(zip(tnew.self_k + tnew.self_v, jnew.self_k + jnew.self_v))
    if not kv_quant:
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        for got, ref in pairs:
            got, ref = got.numpy(), np.asarray(ref)
            np.testing.assert_array_equal(got[:, others], ref[:, others])
            np.testing.assert_allclose(got[:, index], ref[:, index], rtol=1e-6, atol=1e-6)
        return
    ref_h = np.asarray(jh)
    assert np.abs(th.numpy() - ref_h).max() < 1e-2 * np.abs(ref_h).max()
    for layer, (got, ref) in enumerate(pairs):
        got = {n: a.numpy() for n, a in got.items()}
        ref = {n: np.asarray(a) for n, a in ref.items()}
        for name in ("q", "s"):
            np.testing.assert_array_equal(got[name][:, others], ref[name][:, others])
        if layer % cfg.num_layers == 0:
            step = got["q"][:, index].astype(np.int32) - ref["q"][:, index]
            assert np.abs(step).max() <= 1
            np.testing.assert_allclose(got["s"][:, index], ref["s"][:, index], rtol=1e-6)
        deq = [c["q"][:, index] * c["s"][:, index, None] for c in (got, ref)]
        assert np.abs(deq[0] - deq[1]).max() < 3e-2 * np.abs(deq[1]).max()


GENERATE_CASES = {
    # the CPU default: the dense logits on both sides
    "dense": dict(vocab=600, env={}, decode={},
                  kw=dict(max_length=12, forced_bos_token_id=7, min_length=3)),
    # the fused head's exact select (its CPU "auto") on both sides
    "exact": dict(vocab=600, env={"MIC_TPU_FUSED_HEAD": "1"}, decode={},
                  kw=dict(max_length=12, forced_bos_token_id=7, min_length=3)),
    # the TPU/CUDA default select in its plain version; V spans 3 chunks of 512
    "bucket": dict(vocab=1100,
                   env={"MIC_TPU_FUSED_HEAD": "1", "MIC_TPU_FUSED_SELECT": "bucket"},
                   decode={"fused_select": "bucket"},
                   kw=dict(max_length=10, forced_bos_token_id=7)),
    # a small vocab and an EOS bias make beams finish early: the finished
    # set, the length penalty and the early-stopping exit all run
    "finishing": dict(vocab=40, env={}, decode={}, eos_bias=6.0,
                      kw=dict(max_length=16, forced_bos_token_id=5, length_penalty=0.8,
                              early_stopping=True)),
    # int8 weights and head (per-call quantize) with the exact-q8 head on
    # both sides; the int8 products are exact
    "int8": dict(vocab=600, env={"MIC_TPU_FUSED_HEAD": "1"}, decode={},
                 kw=dict(max_length=12, forced_bos_token_id=7, quantize="int8")),
    # the same with the dense int8 logits of lm_logits (the CPU default)
    "int8_dense": dict(vocab=600, env={}, decode={},
                       kw=dict(max_length=12, forced_bos_token_id=7, quantize="int8")),
    # int8 weights with the bucket-q8 head in both packages' plain versions
    "int8_bucket": dict(vocab=1100,
                        env={"MIC_TPU_FUSED_HEAD": "1", "MIC_TPU_FUSED_SELECT": "bucket",
                             "MIC_TPU_DECODE_QUANT": "int8"},
                        decode={}, kw=dict(max_length=10, forced_bos_token_id=7)),
    # twelve beams with an n-gram ban: the search asks the head for 2 x 12 +
    # 5 = 29 candidates a row, past the narrow selects' 16 (ROADMAP B45);
    # the exact and window selects' plain versions on both sides (V = 4000:
    # 32 windows of 128 for the window's 29)
    "exact_k12_ngram3": dict(vocab=4000,
                             env={"MIC_TPU_FUSED_HEAD": "1", "MIC_TPU_FUSED_SELECT": "exact"},
                             decode={}, kw=dict(num_beams=12, max_length=8,
                                                forced_bos_token_id=7, no_repeat_ngram_size=3)),
    "window_k12_ngram3": dict(vocab=4000,
                              env={"MIC_TPU_FUSED_HEAD": "1", "MIC_TPU_FUSED_SELECT": "window"},
                              decode={}, kw=dict(num_beams=12, max_length=8,
                                                 forced_bos_token_id=7, no_repeat_ngram_size=3)),
}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_beam_generate_matches_jax(case, monkeypatch):
    """Beam-4 generate (a case's ``num_beams`` where it sets one) from uint8
    images with a forced BOS: sequences equal to JAX's CPU generate, scores
    within 1e-5."""
    spec = GENERATE_CASES[case]
    for key, value in spec["env"].items():
        monkeypatch.setenv(key, value)
    config = _config(spec["vocab"], decode=DecodeConfig(**spec["decode"]))
    # weights at 0.5 keep random-weight captions varied across images
    jax_model, jparams, model, tparams = _models(config, seed=2, scale=0.5,
                                                 eos_bias=spec.get("eos_bias", 0.0))
    u8 = _images(n=3, seed=3)
    kw = {"num_beams": 4, **spec["kw"]}
    ref = jax.jit(lambda p, x: jax_model.generate(p, x, **kw))(
        jparams, jax_preprocess(jnp.asarray(u8), 32)
    )
    out = model.generate(tparams, preprocess_images(torch.from_numpy(u8), 32), **kw)
    np.testing.assert_array_equal(out.sequences.numpy(), np.asarray(ref.sequences))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), **TOL)
    assert (out.sequences[:, 1] == kw["forced_bos_token_id"]).all()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_int8_kv_generate_near_jax_merged_kv(quantize, monkeypatch):
    """kv_quant="int8" against mic_tpu's generate on its merged int8 cache
    (MIC_TPU_EXPERIMENTAL=merged_kv, the XLA path): the port attends to each
    step row unquantized, as the TPU kernel does, mic_tpu's XLA path to it
    quantized.  Bound: every image's best-beam score within 3e-2 (the
    per-token log-probs move by about one int8 step of the attention output;
    measured 1.8e-2 with int8 weights, 1.2e-2 without, over two seeds), and
    sequences equal but for at most one image, where such a shift can flip a
    near-tie between two captions (one token of one image flipped with int8
    weights, at a score difference of 1.8e-2)."""
    monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", "merged_kv")
    config = _config(600)
    jax_model, jparams, model, tparams = _models(config, seed=2, scale=0.5)
    u8 = _images(n=3, seed=3)
    kw = dict(num_beams=4, max_length=12, forced_bos_token_id=7, kv_quant="int8",
              quantize=quantize)
    ref = jax.jit(lambda p, x: jax_model.generate(p, x, **kw))(
        jparams, jax_preprocess(jnp.asarray(u8), 32)
    )
    out = model.generate(tparams, preprocess_images(torch.from_numpy(u8), 32), **kw)
    differ = (out.sequences.numpy() != np.asarray(ref.sequences)).any(axis=1)
    assert differ.sum() <= 1, differ
    assert (out.sequences[:, 1] == 7).all()
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), rtol=0, atol=3e-2)


RESOLVE_CASES = {
    # (per-call kwargs, env, DecodeConfig fields) -> (quantize, kv_quant, select)
    "config": ({}, {}, dict(quantize="int8", kv_quant="int8", fused_select="window"),
               ("int8", "int8", "window")),
    "env": ({}, {"MIC_TPU_DECODE_QUANT": "int8", "MIC_TPU_KV_QUANT": "int8",
                 "MIC_TPU_FUSED_SELECT": "bucket"}, dict(fused_select="window"),
            ("int8", "int8", "bucket")),
    "per_call": (dict(quantize="int8", kv_quant="int8"), {"MIC_TPU_DECODE_QUANT": ""}, {},
                 ("int8", "int8", "exact")),
    "none": ({}, {}, {}, (None, None, "exact")),
}


@pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
def test_generate_resolves_int8_options_as_mic_tpu(case, monkeypatch):
    """Per-call quantize= and kv_quant= are accepted (mic_tpu's bench passes
    them); each option resolves as mic_tpu's generate does: the per-call
    value, then MIC_TPU_DECODE_QUANT / MIC_TPU_KV_QUANT /
    MIC_TPU_FUSED_SELECT through core/knobs.py::override, then the
    DecodeConfig field ("auto" select: exact on the CPU).  The head is
    forced on (MIC_TPU_FUSED_HEAD=1): on the CPU "auto" takes the dense
    logits and no select runs."""
    kw, env, fields, want = RESOLVE_CASES[case]
    for key in ("MIC_TPU_DECODE_QUANT", "MIC_TPU_KV_QUANT", "MIC_TPU_FUSED_SELECT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("MIC_TPU_FUSED_HEAD", "1")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    seen = {}
    quantize = captioner_mod.quantize_params_for_decode
    init_cache = Captioner.init_decode_cache
    head = Captioner._candidate_head
    monkeypatch.setattr(captioner_mod, "quantize_params_for_decode",
                        lambda p: seen.setdefault("quantize", "int8") and quantize(p))

    def spy_cache(self, *args, **kwargs):
        seen["kv_quant"] = args[-1]
        return init_cache(self, *args, **kwargs)

    def spy_head(self, params, sel):
        seen["select"] = sel
        return head(self, params, sel)

    monkeypatch.setattr(Captioner, "init_decode_cache", spy_cache)
    monkeypatch.setattr(Captioner, "_candidate_head", spy_head)
    config = _port(_config(1300, decode=DecodeConfig(**fields)))  # 11 windows for k = 9
    params = init_params(config, torch.Generator().manual_seed(0))
    px = preprocess_images(torch.from_numpy(_images(n=1)), 32)
    out = Captioner(config).generate(params, px, num_beams=4, max_length=4,
                                     forced_bos_token_id=7, **kw)
    assert out.sequences.shape == (1, 4)
    assert (seen.get("quantize"), seen["kv_quant"], seen["select"]) == want


def test_from_jax_keeps_every_leaf_and_init_matches_layout():
    """from_jax moves every leaf across untransposed, and back again
    unchanged; the port's own init_params has mic_tpu's key paths, shapes
    and dtypes; make_serving_params casts only floating leaves.  The beam
    step's opt-in kernels (blocked lazy attention, cross-attention, LN ->
    QKV, fused MLP) read these same leaves and add none."""
    config = _config()
    jtree = _numpy_params(JaxCaptioner(config), 0, 0.05)
    jtree["decoder"]["ln_embed"]["bias"] = jtree["decoder"]["ln_embed"]["bias"].astype(
        jnp.bfloat16
    )  # a bfloat16 leaf crosses too
    ttree = from_jax(jtree)
    jleaves = dict(_leaves(jtree))
    tleaves = dict(_leaves(ttree))
    assert jleaves.keys() == tleaves.keys()
    for path, ref in jleaves.items():
        back = tleaves[path].float().numpy().astype(ref.dtype)
        assert back.shape == ref.shape, path
        np.testing.assert_array_equal(back, ref)

    own = dict(_leaves(init_params(_port(config), torch.Generator().manual_seed(0))))
    assert own.keys() == jleaves.keys()
    for path, ref in jleaves.items():
        assert tuple(own[path].shape) == ref.shape, path
        assert own[path].dtype == torch.float32 and str(ref.dtype) in ("float32", "bfloat16")
    emb = own[("shared", "embedding")]
    assert abs(emb.std().item() - config.decoder.init_std) < 0.1 * config.decoder.init_std

    served = make_serving_params({"w": torch.ones(2), "ids": torch.arange(3)})
    assert served["w"].dtype == torch.bfloat16 and served["ids"].dtype == torch.int64


def test_port_never_imports_jax():
    """A process that imports the port and runs a tiny CPU generate, in
    bf16-free float32 and with int8 weights and an int8 cache, has no JAX
    module loaded."""
    code = (
        "import sys, torch\n"
        "from mic_tpu_torch.core.config import CaptionerConfig, DecoderConfig, VisionConfig\n"
        "from mic_tpu_torch.models.captioner import Captioner, init_params\n"
        "from mic_tpu_torch.ops.image_prep import preprocess_images\n"
        "cfg = CaptionerConfig(vision=VisionConfig.tiny(), decoder=DecoderConfig.tiny())\n"
        "params = init_params(cfg, torch.Generator().manual_seed(0))\n"
        "px = preprocess_images(torch.zeros((1, 40, 40, 3), dtype=torch.uint8), 32)\n"
        "for kw in ({}, {'quantize': 'int8', 'kv_quant': 'int8'}):\n"
        "    out = Captioner(cfg).generate(params, px, num_beams=4, max_length=6,\n"
        "                                  forced_bos_token_id=7, **kw)\n"
        "    assert out.sequences.shape == (1, 6), out.sequences.shape\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _call_inputs(config, seed=0):
    """Pixels and a teacher-forced batch of three captions: one full, one
    right-padded, one left-padded (its first query rows see no key)."""
    rng = np.random.default_rng(seed)
    b, t = 3, 8
    pixels = rng.normal(size=(b, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(4, config.decoder.vocab_size, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    mask[1, 5:] = 0
    mask[2, :3] = 0
    return pixels, ids, mask


def _grad_tree(nparams):
    params = from_jax(nparams)
    for _, leaf in _leaves(params):
        leaf.requires_grad_(True)
    return params


def test_call_with_pallas_attention_matches_jax():
    """Captioner(attn_impl="pallas").__call__ (flash attention in both
    towers' self-attention, mic_tpu's in interpret mode) at float32: logits
    within 1e-5, every parameter gradient of sum(logits * w) within 1e-4 of
    its leaf's largest entry (floored).  A left-padded caption's first query rows see
    no key: flash gives them 0 where the XLA math attends uniformly, so the
    logits differ from attn_impl="xla"'s there."""
    config = _config(vocab=97)
    jax_model = JaxCaptioner(config, attn_impl="pallas")
    nparams = _numpy_params(jax_model, 3, 0.05)
    pixels, ids, mask = _call_inputs(config)
    w = np.random.default_rng(4).normal(size=(3, 8, 97)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (pixels, ids, mask)]

    def loss(p):
        logits = jax_model(p, *jargs)
        return jnp.sum(logits * w), logits

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, nparams))
    params = _grad_tree(nparams)
    model = Captioner(_port(config), attn_impl="pallas")
    targs = [torch.from_numpy(a) for a in (pixels, ids, mask)]
    logits = model(params, *targs)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), **TOL)
    paths, leaves = zip(*_leaves(params))
    grads = torch.autograd.grad((logits * torch.from_numpy(w)).sum(), leaves, allow_unused=True,
                                materialize_grads=True)  # the vision post_ln is unused
    wants = [np.asarray(x) for x in jax.tree.leaves(jgrads)]
    # a leaf whose exact gradient is 0 (a key bias under softmax) holds only
    # rounding noise: each leaf's scale is floored at 1e-4 of the largest
    floor = 1e-4 * max(np.abs(x).max() for x in wants)
    for path, got, want in zip(paths, grads, wants):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), floor), err_msg=str(path))
    xla = Captioner(_port(config))(params, *targs).detach()
    assert not torch.allclose(xla[2, :3], logits[2, :3].detach(), atol=1e-3)
    np.testing.assert_allclose(xla[:2].numpy(), logits[:2].detach().numpy(), **TOL)


INTROSPECTION = {"hidden": (True, False), "attentions": (False, True), "both": (True, True)}


@pytest.mark.parametrize("what", sorted(INTROSPECTION))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_introspection_outputs_match_jax(impl, what):
    """encode and __call__ with output_hidden_states / output_attentions
    against mic_tpu's EncodeOutput and CaptionerOutput, field by field,
    float32 within 1e-5.  Under "pallas" a weights request sends every
    attention to the XLA math; hidden states alone keep flash."""
    hidden, attentions = INTROSPECTION[what]
    config = _config(vocab=97)
    jax_model = JaxCaptioner(config, attn_impl=impl)
    nparams = _numpy_params(jax_model, 5, 0.05)
    jparams = jax.tree.map(jnp.asarray, nparams)
    pixels, ids, mask = _call_inputs(config, seed=6)
    kw = dict(output_hidden_states=hidden, output_attentions=attentions)
    ref_call = jax.jit(lambda p, *a: jax_model(p, *a, **kw))(
        jparams, *[jnp.asarray(a) for a in (pixels, ids, mask)])
    ref_enc = jax.jit(lambda p, x: jax_model.encode(p, x, **kw))(jparams, jnp.asarray(pixels))
    model = Captioner(_port(config), attn_impl=impl)
    tparams = from_jax(nparams)
    got_call = model(tparams, *[torch.from_numpy(a) for a in (pixels, ids, mask)], **kw)
    got_enc = model.encode(tparams, torch.from_numpy(pixels), **kw)
    assert type(got_call).__name__ == "CaptionerOutput"
    assert type(got_enc).__name__ == "EncodeOutput"
    for got, ref in ((got_call, ref_call), (got_enc, ref_enc)):
        assert got._fields == ref._fields
        for field, a, b in zip(got._fields, got, ref):
            assert (a is None) == (b is None), field
            if a is not None:
                assert tuple(a.shape) == b.shape, field
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=field)
    v, d = config.vision, config.decoder
    if hidden:
        assert got_call.encoder_hidden_states.shape == (v.num_layers + 1, 3, v.seq_len,
                                                        v.hidden_size)
        # the last entry is after the final LN: the state the head reads
        assert torch.equal(model.lm_logits(tparams, got_call.decoder_hidden_states[-1]),
                           got_call.logits)
    if attentions:
        assert got_call.cross_attentions.shape == (d.num_layers, 3, d.num_heads, 8, v.seq_len)

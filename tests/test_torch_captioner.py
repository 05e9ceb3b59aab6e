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
from mic_tpu_torch.core.params import make_serving_params
from mic_tpu_torch.io.from_jax import from_jax
from mic_tpu_torch.models import mbart_decoder
from mic_tpu_torch.models.captioner import Captioner, init_params
from mic_tpu_torch.nn.cache import LazyDecoderCache
from mic_tpu_torch.ops.image_prep import preprocess_images

TOL = dict(rtol=1e-5, atol=1e-5)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    return jax_model, jparams, Captioner(config), from_jax(nparams)


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
        tparams["decoder"], torch.from_numpy(enc), cfg, torch.float32
    )
    np.testing.assert_allclose(tck.numpy(), np.asarray(ck), **TOL)
    tcache = LazyDecoderCache(
        self_k=[torch.from_numpy(p.copy()) for p in prefix[: cfg.num_layers]],
        self_v=[torch.from_numpy(p.copy()) for p in prefix[cfg.num_layers:]],
        cross_k=tck, cross_v=tcv, ancestry=torch.from_numpy(anc), index=index,
    )
    th, tnew = mbart_decoder.decoder_step(
        tfused, tparams["shared"], torch.from_numpy(tokens), tcache, cfg, torch.float32, beams
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert tnew.index == int(jnew.index) == index + 1
    others = np.arange(t) != index
    for got, ref in zip(tnew.self_k + tnew.self_v, jnew.self_k + jnew.self_v):
        got, ref = got.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(got[:, others], ref[:, others])
        np.testing.assert_allclose(got[:, index], ref[:, index], rtol=1e-6, atol=1e-6)


GENERATE_CASES = {
    # the CPU default: exact candidate select on both sides
    "exact": dict(vocab=600, env={}, decode={},
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
}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_beam_generate_matches_jax(case, monkeypatch):
    """Beam-4 generate from uint8 images with a forced BOS: sequences equal
    to JAX's CPU generate, scores within 1e-5."""
    spec = GENERATE_CASES[case]
    for key, value in spec["env"].items():
        monkeypatch.setenv(key, value)
    config = _config(spec["vocab"], decode=DecodeConfig(**spec["decode"]))
    # weights at 0.5 keep random-weight captions varied across images
    jax_model, jparams, model, tparams = _models(config, seed=2, scale=0.5,
                                                 eos_bias=spec.get("eos_bias", 0.0))
    u8 = _images(n=3, seed=3)
    kw = dict(num_beams=4, **spec["kw"])
    ref = jax.jit(lambda p, x: jax_model.generate(p, x, **kw))(
        jparams, jax_preprocess(jnp.asarray(u8), 32)
    )
    out = model.generate(tparams, preprocess_images(torch.from_numpy(u8), 32), **kw)
    np.testing.assert_array_equal(out.sequences.numpy(), np.asarray(ref.sequences))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), **TOL)
    assert (out.sequences[:, 1] == kw["forced_bos_token_id"]).all()


def test_from_jax_keeps_every_leaf_and_init_matches_layout():
    """from_jax moves every leaf across untransposed, and back again
    unchanged; the port's own init_params has mic_tpu's key paths, shapes
    and dtypes; make_serving_params casts only floating leaves."""
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

    own = dict(_leaves(init_params(config, torch.Generator().manual_seed(0))))
    assert own.keys() == jleaves.keys()
    for path, ref in jleaves.items():
        assert tuple(own[path].shape) == ref.shape, path
        assert own[path].dtype == torch.float32 and str(ref.dtype) in ("float32", "bfloat16")
    emb = own[("shared", "embedding")]
    assert abs(emb.std().item() - config.decoder.init_std) < 0.1 * config.decoder.init_std

    served = make_serving_params({"w": torch.ones(2), "ids": torch.arange(3)})
    assert served["w"].dtype == torch.bfloat16 and served["ids"].dtype == torch.int64


def test_port_never_imports_jax():
    """A process that imports the port and runs a tiny CPU generate has
    no JAX module loaded."""
    code = (
        "import sys, torch\n"
        "from mic_tpu.core.config import CaptionerConfig, DecoderConfig, VisionConfig\n"
        "from mic_tpu_torch.models.captioner import Captioner, init_params\n"
        "from mic_tpu_torch.ops.image_prep import preprocess_images\n"
        "cfg = CaptionerConfig(vision=VisionConfig.tiny(), decoder=DecoderConfig.tiny())\n"
        "params = init_params(cfg, torch.Generator().manual_seed(0))\n"
        "px = preprocess_images(torch.zeros((1, 40, 40, 3), dtype=torch.uint8), 32)\n"
        "out = Captioner(cfg).generate(params, px, num_beams=4, max_length=6,\n"
        "                              forced_bos_token_id=7)\n"
        "assert out.sequences.shape == (1, 6), out.sequences.shape\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"

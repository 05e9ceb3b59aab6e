"""The port's mBART-50 translator (models/mbart_text.py, models/
mbart_seq2seq.py) and the decoder's source mask against mic_tpu.

The same numpy weights go through both packages (io/from_jax.py) on the
CPU at float32, JAX at "highest" precision (tests/conftest.py), the port in
its plain versions.  Tolerances: 3e-5 for logits (mic_tpu's bound for the
family, tests/test_seq2seq.py), 1e-5 for encoder and decoder states, 1e-5
relative for beam scores (sums of float32 log-probs), token for token for
sequences; cache columns other than the step's are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.core.config import DecoderConfig, GenerationConfig
from mic_tpu.models import mbart_decoder as jax_dec
from mic_tpu.models import mbart_text as jax_text
from mic_tpu.models.mbart_seq2seq import MBartSeq2Seq as JaxSeq2Seq
from mic_tpu.nn.cache import DecoderCache as JaxDecoderCache
from mic_tpu.nn.cache import init_lazy_cache as jax_init_lazy_cache
from mic_tpu_torch.core import config as port_config
from mic_tpu_torch.io.from_jax import from_jax
from mic_tpu_torch.models import mbart_decoder, mbart_text
from mic_tpu_torch.models.mbart_seq2seq import MBartSeq2Seq
from mic_tpu_torch.nn.cache import DecoderCache, LazyDecoderCache, init_cache

TOL = dict(rtol=1e-5, atol=1e-5)
ATOL = 3e-5


def _port(cfg):
    return getattr(port_config, type(cfg).__name__).from_dict(cfg.to_dict())


def _config(vocab=99, post_norm=False):
    if post_norm:  # a BART decoder: post-norm, no final LN, unscaled embeddings
        return DecoderConfig.tiny(vocab_size=vocab, post_norm=True, use_final_ln=False,
                                  scale_embedding=False)
    return DecoderConfig.tiny(vocab_size=vocab)


def _models(cfg, seed=0, scale=0.1, attn_impl="xla"):
    jax_model = JaxSeq2Seq(cfg, attn_impl=attn_impl)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_model.init_params, jax.random.PRNGKey(0))

    def fill(path, leaf):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + scale * rng.normal(size=leaf.shape)).astype(np.float32)

    nparams = jax.tree_util.tree_map_with_path(fill, shapes)
    return (jax_model, jax.tree.map(jnp.asarray, nparams),
            MBartSeq2Seq(_port(cfg), attn_impl=attn_impl), from_jax(nparams))


def _sources(b, s, vocab, seed, lengths):
    """Right-padded source rows (pad id 1) of the given lengths and masks."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, size=(b, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return np.where(mask == 1, ids, 1).astype(np.int32), mask


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, prefix + (key,))
    else:
        yield prefix, tree


def test_init_params_has_mic_tpu_layout():
    cfg = _config()
    jax_model, _, model, _ = _models(cfg)
    ref = dict(_leaves(jax.eval_shape(jax_model.init_params, jax.random.PRNGKey(0))))
    own = dict(_leaves(model.init_params(torch.Generator().manual_seed(0))))
    assert own.keys() == ref.keys()
    for path, leaf in ref.items():
        assert tuple(own[path].shape) == leaf.shape, path


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_text_encoder_matches_jax(impl):
    """The text encoder with padded sources, also under attn_impl="pallas"
    (flash attention with the key-padding bias; the last source is all
    padding, so every key of its rows is masked)."""
    cfg = _config()
    jax_model, jparams, model, tparams = _models(cfg, attn_impl=impl)
    ids, mask = _sources(3, 9, cfg.vocab_size, 0, [9, 5, 0])
    ref = np.asarray(jax_text.apply_text_encoder(
        jparams["encoder"], jparams["shared"], jnp.asarray(ids), jnp.asarray(mask), cfg,
        attn_impl=impl))
    got = mbart_text.apply_text_encoder(tparams["encoder"], tparams["shared"],
                                        torch.from_numpy(ids), torch.from_numpy(mask),
                                        _port(cfg), attn_impl=impl).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("post_norm", [False, True])
def test_forward_matches_jax(post_norm):
    """Teacher-forced logits with a padded source within 3e-5."""
    cfg = _config(post_norm=post_norm)
    jax_model, jparams, model, tparams = _models(cfg, seed=1)
    ids, mask = _sources(2, 9, cfg.vocab_size, 2, [9, 6])
    dec = np.random.default_rng(3).integers(4, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    dmask = np.ones((2, 7), np.int32)
    ref = np.asarray(jax_model(jparams, *map(jnp.asarray, (ids, mask, dec, dmask))))
    got = model(tparams, *map(torch.from_numpy, (ids, mask, dec, dmask))).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


GENERATE_CASES = {
    "beam4": dict(env={}, kw=dict(num_beams=4)),
    "greedy": dict(env={}, kw=dict(num_beams=1)),
    # the decode-attention step and the top-k + logsumexp select
    "beam4_fused_decode_pallas_topk": dict(
        env={"MIC_TPU_EXPERIMENTAL": "fused_decode,pallas_topk"}, kw=dict(num_beams=4)),
    "greedy_fused_decode_pallas_topk": dict(
        env={"MIC_TPU_EXPERIMENTAL": "fused_decode,pallas_topk"}, kw=dict(num_beams=1)),
    # forced EOS at max_length - 1, min_length and the length penalty
    "beam4_forced_eos": dict(env={}, kw=dict(num_beams=4, forced_eos_token_id=2,
                                             min_length=4, length_penalty=0.8)),
}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_matches_jax(case, monkeypatch):
    """Beam-4 and greedy translations of padded sources with a forced
    target BOS: sequences equal to mic_tpu's token for token."""
    spec = GENERATE_CASES[case]
    for key, value in spec["env"].items():
        monkeypatch.setenv(key, value)
    cfg = _config(vocab=200)
    jax_model, jparams, model, tparams = _models(cfg, seed=4, scale=0.5)
    ids, mask = _sources(3, 10, cfg.vocab_size, 5, [10, 7, 4])
    kw = dict(max_length=10, forced_bos_token_id=7, **spec["kw"])
    ref = jax.jit(lambda p, i, m: jax_model.generate(p, i, m, **kw))(
        jparams, jnp.asarray(ids), jnp.asarray(mask))
    out = model.generate(tparams, torch.from_numpy(ids), torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(out.sequences.numpy(), np.asarray(ref.sequences))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), **TOL)
    assert (out.sequences[:, 1] == 7).all()
    if "forced_eos_token_id" in kw:  # every translation ends, by max_length - 1 at the latest
        assert (out.sequences == 2).any(1).all()


@pytest.mark.parametrize("num_beams", [1, 4])
def test_source_padding_changes_nothing(num_beams):
    """More padding after a source leaves its translation as it was."""
    cfg = _config(vocab=200)
    _, _, model, tparams = _models(cfg, seed=6, scale=0.5)
    ids, mask = _sources(2, 6, cfg.vocab_size, 7, [6, 4])
    padded = np.concatenate([ids, np.ones((2, 5), np.int32)], axis=1)
    pmask = np.concatenate([mask, np.zeros((2, 5), np.int32)], axis=1)
    kw = dict(max_length=9, num_beams=num_beams, forced_bos_token_id=7)
    a = model.generate(tparams, torch.from_numpy(ids), torch.from_numpy(mask), **kw)
    b = model.generate(tparams, torch.from_numpy(padded), torch.from_numpy(pmask), **kw)
    np.testing.assert_array_equal(a.sequences.numpy(), b.sequences.numpy())
    np.testing.assert_allclose(a.scores.numpy(), b.scores.numpy(), **TOL)


def test_lazy_api_and_generation_config():
    """mic_tpu_torch.MBartSeq2Seq is this class; GenerationConfig defaults
    are read, and per-call arguments override them."""
    import mic_tpu_torch

    assert mic_tpu_torch.MBartSeq2Seq is MBartSeq2Seq
    cfg = _config()
    model = MBartSeq2Seq(_port(cfg), port_config.GenerationConfig(max_length=5),
                         dtype="float32")
    params = model.init_params(torch.Generator().manual_seed(0))
    ids, mask = _sources(1, 4, cfg.vocab_size, 8, [4])
    assert model.generate(params, torch.from_numpy(ids),
                          torch.from_numpy(mask)).sequences.shape == (1, 5)
    assert model.generate(params, torch.from_numpy(ids), torch.from_numpy(mask),
                          max_length=7).sequences.shape == (1, 7)
    assert JaxSeq2Seq(cfg, GenerationConfig(max_length=5)).generation.max_length == 5


@pytest.mark.parametrize("post_norm", [False, True])
@pytest.mark.parametrize("cache_kind", ["lazy", "physical", "fused_decode"])
def test_decoder_step_with_source_mask_matches_jax(cache_kind, post_norm, monkeypatch):
    """One decode step (all layers, 2 beams a source) with a padded source
    mask, on the lazy cache, the physical cache and the fused_decode step:
    hidden states within 1e-5 of mic_tpu's, cache columns other than the
    step's untouched."""
    if cache_kind == "fused_decode":
        monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", "fused_decode")
    cfg = _config(post_norm=post_norm)
    _, jparams, _, tparams = _models(cfg, seed=9)
    b, beams, t, s, index = 3, 2, 8, 7, 4
    rng = np.random.default_rng(10)
    enc = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    enc_mask = (np.arange(s)[None, :] < np.array([7, 3, 5])[:, None]).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (b * beams, 1)).astype(np.int32)
    ck, cv = jax_dec.init_cross_cache(jparams["decoder"], jnp.asarray(enc), cfg)
    tck, tcv = mbart_decoder.init_cross_cache(tparams["decoder"], torch.from_numpy(enc),
                                              _port(cfg), torch.float32)
    if cache_kind == "lazy":
        prefix = [rng.normal(size=(b * beams, t, cfg.d_model)).astype(np.float32)
                  for _ in range(2 * cfg.num_layers)]
        for p in prefix:
            p[:, index:] = 0.0
        anc = rng.integers(0, beams, (b, beams, t)).astype(np.int32)
        anc[:, :, index:] = np.arange(beams)[None, :, None]
        jdec, tdec = (jax_dec.fuse_qkv_params(jparams["decoder"]),
                      mbart_decoder.fuse_qkv_params(tparams["decoder"]))
        jcache = jax_init_lazy_cache(cfg.num_layers, b, beams, t, s, cfg.num_heads,
                                     cfg.head_dim, merged=True)._replace(
            self_k=tuple(map(jnp.asarray, prefix[:cfg.num_layers])),
            self_v=tuple(map(jnp.asarray, prefix[cfg.num_layers:])),
            cross_k=ck, cross_v=cv, ancestry=jnp.asarray(anc),
            index=jnp.asarray(index, jnp.int32))
        tcache = LazyDecoderCache(
            self_k=[torch.from_numpy(p.copy()) for p in prefix[:cfg.num_layers]],
            self_v=[torch.from_numpy(p.copy()) for p in prefix[cfg.num_layers:]],
            cross_k=tck, cross_v=tcv, ancestry=torch.from_numpy(anc), index=index)
    else:
        shape = (cfg.num_layers, b * beams, t, cfg.num_heads, cfg.head_dim)
        prefix = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
        for p in prefix:
            p[:, :, index:] = 0.0
        jdec, tdec = jparams["decoder"], tparams["decoder"]
        jcache = JaxDecoderCache(self_k=jnp.asarray(prefix[0]), self_v=jnp.asarray(prefix[1]),
                                 cross_k=ck, cross_v=cv, index=jnp.asarray(index, jnp.int32))
        tcache = init_cache(tck, tcv, b * beams, t)
        tcache.self_k.copy_(torch.from_numpy(prefix[0]))
        tcache.self_v.copy_(torch.from_numpy(prefix[1]))
        tcache = DecoderCache(tcache.self_k, tcache.self_v, tck, tcv, index)
    jh, jnew = jax_dec.decoder_step(jdec, jparams["shared"], jnp.asarray(tokens), jcache, cfg,
                                    jnp.float32, enc_mask=jnp.asarray(enc_mask), beams=beams)
    th, tnew = mbart_decoder.decoder_step(tdec, tparams["shared"], torch.from_numpy(tokens),
                                          tcache, _port(cfg), torch.float32, beams,
                                          enc_mask=torch.from_numpy(enc_mask))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    assert tnew.index == int(jnew.index) == index + 1
    pairs = (zip(tnew.self_k + tnew.self_v, jnew.self_k + jnew.self_v) if cache_kind == "lazy"
             else ((tnew.self_k, jnew.self_k), (tnew.self_v, jnew.self_v)))
    for got, ref in pairs:
        got, ref = got.numpy(), np.asarray(ref)
        axis = 1 if cache_kind == "lazy" else 2
        others = [i for i in range(t) if i != index]
        np.testing.assert_array_equal(np.take(got, others, axis), np.take(ref, others, axis))
        np.testing.assert_allclose(np.take(got, index, axis), np.take(ref, index, axis),
                                   rtol=1e-6, atol=1e-6)

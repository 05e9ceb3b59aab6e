"""The port's greedy, sampling and beam serving (models/captioner.generate,
generate/search.py, generate/processors.py) against mic_tpu.

A tiny captioner gets the same numpy weights on both sides (io/from_jax).
Each case runs mic_tpu's jitted CPU generate and the port's generate from
the same uint8 images; on the CPU the port's kernels run their plain
versions.  Sequences must be equal and scores within 1e-5 (rtol and atol,
float32 sums in another order; the weights' scale keeps the activations
small enough for that).  Sampling is held to mic_tpu step for step: JAX's
own per-step Gumbel noise (its key schedule rebuilt, the first check being
that argmax(warped + noise) is ``jax.random.categorical``) replaces the
port's noise draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.core.config import CaptionerConfig, DecoderConfig, VisionConfig
from mic_tpu.generate import processors as jax_processors
from mic_tpu.generate import search as jax_search
from mic_tpu.ops.image_prep import preprocess_images as jax_preprocess
from mic_tpu_torch.core.config import DecodeConfig
from mic_tpu_torch.generate import processors, search
from mic_tpu_torch.models import mbart_decoder
from mic_tpu_torch.nn import attention
from mic_tpu_torch.nn import cache as cache_mod
from mic_tpu_torch.ops.image_prep import preprocess_images
from test_torch_captioner import TOL, _config, _images, _models

N_IMAGES = 3

GREEDY_CASES = {
    # the fused head's exact select (plain version) and the dense logits
    "fused_head_exact": dict(env={"MIC_TPU_FUSED_HEAD": "1"},
                             kw=dict(forced_bos_token_id=7, min_length=3)),
    "dense": dict(env={"MIC_TPU_FUSED_HEAD": "0"},
                  kw=dict(forced_bos_token_id=7, min_length=3)),
    # the CUDA default select in its plain version; V spans 3 chunks of 512
    "fused_head_bucket": dict(vocab=1100, env={"MIC_TPU_FUSED_HEAD": "1",
                                               "MIC_TPU_FUSED_SELECT": "bucket"},
                              kw=dict(forced_bos_token_id=7)),
    # the decode-attention step and the top-k + logsumexp select
    "fused_decode_pallas_topk": dict(env={"MIC_TPU_FUSED_HEAD": "0",
                                          "MIC_TPU_EXPERIMENTAL": "fused_decode,pallas_topk"},
                                     kw=dict(forced_bos_token_id=7, min_length=3)),
    # an EOS bias: min_length holds EOS back, then the forced EOS
    "forced_bos_eos_min_length": dict(eos_bias=6.0, kw=dict(max_length=8, min_length=6,
                                                            forced_bos_token_id=7)),
    # a small vocab and an EOS bias: rows finish early, the loop exits
    "finishing": dict(vocab=40, eos_bias=3.0, kw=dict(forced_eos_token_id=None)),
    "no_repeat_ngram_dense": dict(kw=dict(no_repeat_ngram_size=2, forced_eos_token_id=None)),
    "no_repeat_ngram_head": dict(env={"MIC_TPU_FUSED_HEAD": "1"},
                                 kw=dict(no_repeat_ngram_size=3, forced_eos_token_id=None)),
    "eos_positions": dict(kw=dict(forced_bos_token_id=5, forced_eos_token_id=None),
                          eos_positions=[3, 7, 5]),
    # mic_tpu's two-stage select (a ragged last segment); the port's exact one
    "segmented_topk": dict(env={"MIC_TPU_FUSED_HEAD": "0",
                                "MIC_TPU_EXPERIMENTAL": "segmented_topk=128"},
                           kw=dict(forced_bos_token_id=7, no_repeat_ngram_size=2)),
}
BEAM_CASES = {
    "no_repeat_ngram": dict(kw=dict(no_repeat_ngram_size=2, forced_eos_token_id=None)),
    "eos_positions": dict(kw=dict(forced_bos_token_id=5, forced_eos_token_id=None,
                                  early_stopping=True), eos_positions=[3, 7, 5]),
    # MIC_TPU_LAZY_CACHE=0: the physical cache, its rows moved each step
    "physical_cache": dict(env={"MIC_TPU_LAZY_CACHE": "0"},
                           kw=dict(forced_bos_token_id=7, min_length=3)),
    "physical_cache_fused_decode": dict(
        env={"MIC_TPU_LAZY_CACHE": "0", "MIC_TPU_FUSED_HEAD": "0",
             "MIC_TPU_EXPERIMENTAL": "fused_decode,pallas_topk"},
        kw=dict(forced_bos_token_id=7, no_repeat_ngram_size=2)),
}


def _setup(spec, monkeypatch):
    for key in ("MIC_TPU_FUSED_HEAD", "MIC_TPU_FUSED_SELECT", "MIC_TPU_EXPERIMENTAL",
                "MIC_TPU_LAZY_CACHE", "MIC_TPU_FUSED_QKV"):
        monkeypatch.delenv(key, raising=False)
    for key, value in spec.get("env", {}).items():
        monkeypatch.setenv(key, value)
    config = _config(spec.get("vocab", 600))
    models = _models(config, seed=2, scale=spec.get("scale", 0.2),
                     eos_bias=spec.get("eos_bias", 0.0))
    return config, models, _images(n=N_IMAGES, seed=3)


def _generate(models, u8, kw, eos_positions=None, rng=None):
    """mic_tpu's jitted generate and the port's on the same images."""
    jax_model, jparams, model, tparams = models
    jeos = None if eos_positions is None else jnp.asarray(eos_positions, jnp.int32)
    ref = jax.jit(lambda p, x, e, r: jax_model.generate(p, x, rng=r, eos_positions=e, **kw))(
        jparams, jax_preprocess(jnp.asarray(u8), 32), jeos, rng)
    teos = None if eos_positions is None else torch.tensor(eos_positions)
    out = model.generate(tparams, preprocess_images(torch.from_numpy(u8), 32),
                         eos_positions=teos, **kw)
    return ref, out


def _assert_same(ref, out):
    np.testing.assert_array_equal(out.sequences.numpy(), np.asarray(ref.sequences))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), **TOL)


def _check_pinned(seqs, eos_positions, eos, pad):
    for row, pos in zip(seqs, eos_positions):
        assert row[pos] == eos and (row[1:pos] != eos).all() and (row[pos + 1:] == pad).all()


@pytest.mark.parametrize("case", sorted(GREEDY_CASES))
def test_greedy_generate_matches_jax(case, monkeypatch):
    spec = GREEDY_CASES[case]
    config, models, u8 = _setup(spec, monkeypatch)
    kw = dict(dict(num_beams=1, max_length=12), **spec["kw"])
    calls = {"decode_attention": 0, "topk_log_probs": 0}
    for mod, name in ((mbart_decoder, "decode_attention"), (search, "topk_log_probs")):
        fn = getattr(mod, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(mod, name, counted)
    ref, out = _generate(models, u8, kw, spec.get("eos_positions"))
    _assert_same(ref, out)
    seqs = out.sequences.numpy()
    assert out.steps == max(1, int((seqs != config.decoder.pad_token_id)[:, 1:].sum(1).max()))
    if "forced_bos_token_id" in kw:
        assert (seqs[:, 1] == kw["forced_bos_token_id"]).all()
    if "eos_positions" in spec:
        _check_pinned(seqs, spec["eos_positions"], config.decoder.eos_token_id,
                      config.decoder.pad_token_id)
    if case == "fused_decode_pallas_topk":
        forced = sum(1 for pos in (1, kw["max_length"] - 1) if pos <= out.steps)
        assert calls == {"decode_attention": config.decoder.num_layers * out.steps,
                         "topk_log_probs": out.steps - forced}
    else:
        assert calls == {"decode_attention": 0, "topk_log_probs": 0}


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_generate_matches_jax(case, monkeypatch):
    spec = BEAM_CASES[case]
    config, models, u8 = _setup(spec, monkeypatch)
    kw = dict(dict(num_beams=4, max_length=10), **spec["kw"])
    ref, out = _generate(models, u8, kw, spec.get("eos_positions"))
    _assert_same(ref, out)
    if "eos_positions" in spec:
        _check_pinned(out.sequences.numpy(), spec["eos_positions"],
                      config.decoder.eos_token_id, config.decoder.pad_token_id)
    if kw.get("no_repeat_ngram_size") == 2:
        for row in out.sequences.numpy().tolist():
            bigrams = list(zip(row, row[1:]))[:row.index(1) - 1 if 1 in row else None]
            assert len(bigrams) == len(set(bigrams)), row


@pytest.mark.parametrize("env,cfg", [({"MIC_TPU_FUSED_QKV": "0"}, {}),
                                     ({}, {"fused_qkv": False})])
def test_lazy_beam_refuses_unfused_qkv(env, cfg, monkeypatch):
    """The lazy step always fuses q/k/v (mic_tpu's unfused step gives
    bit-identical columns): turning the fusion off raises, by env or config;
    the physical cache, which never fuses, takes either setting."""
    config, models, u8 = _setup({"env": env}, monkeypatch)
    _, _, model, tparams = models
    px = preprocess_images(torch.from_numpy(u8), 32)
    model.config = config.replace(decode=DecodeConfig(**cfg))
    with pytest.raises(ValueError, match="MIC_TPU_FUSED_QKV"):
        model.generate(tparams, px, num_beams=4, max_length=6)
    model.config = config.replace(decode=DecodeConfig(lazy_cache=False, **cfg))
    assert model.generate(tparams, px, num_beams=4, max_length=6).sequences.shape == (N_IMAGES, 6)


MERGED_CROSS_CASES = {
    # case: (env, kv_quant, fused-step width, atol of the scores or None)
    # the bf16 lazy cache: both sides run the same kernel arithmetic
    "bf16": ({"MIC_TPU_EXPERIMENTAL": "merged_cross"}, None, False, None),
    # the int8 lazy cache (mic_tpu on its merged int8 cache): mic_tpu's XLA
    # self-attention attends to each step row quantized, the port to it
    # unquantized; the bound of test_torch_captioner.py's
    # test_int8_kv_generate_near_jax_merged_kv (2.5e-4 measured)
    "int8_kv": ({"MIC_TPU_EXPERIMENTAL": "merged_cross,merged_kv"}, "int8", False, 3e-2),
    # the fused step: the blocked self-attention's plain version rounds to
    # bf16 where mic_tpu's XLA chain does not; the bound of
    # test_torch_fused_step.py's test_fused_beam_generate_near_jax (2.8e-4
    # measured)
    "fused_step": ({"MIC_TPU_FUSED_LAZY_ATTN": "1", "MIC_TPU_EXPERIMENTAL":
                    "merged_cross,fused_cross_attn,fused_mlp,ln_qkv"}, None, True, 1e-2),
    # the physical cache ignores the switch, as in mic_tpu
    "physical": ({"MIC_TPU_EXPERIMENTAL": "merged_cross", "MIC_TPU_LAZY_CACHE": "0"}, None,
                 False, None),
}


@pytest.mark.parametrize("case", sorted(MERGED_CROSS_CASES))
def test_merged_cross_beam_generate_matches_jax(case, monkeypatch):
    """Beam 4 under MIC_TPU_EXPERIMENTAL=merged_cross against mic_tpu's
    generate under the same switches (its merged cross kernel in interpret
    mode on the CPU): sequences equal, and scores within rtol 1e-4, as
    mic_tpu holds its merged path to its canonical one, where both sides
    attend alike (2.1e-5 measured), else within the stated bound.  The
    merged kernel runs once a layer a step on the lazy cache; on the
    physical cache never, and every reorder moves both self planes through
    ops/beam_permute.py."""
    env, kv_quant, fused_width, atol = MERGED_CROSS_CASES[case]
    for key in ("MIC_TPU_FUSED_HEAD", "MIC_TPU_FUSED_SELECT", "MIC_TPU_EXPERIMENTAL",
                "MIC_TPU_LAZY_CACHE", "MIC_TPU_FUSED_QKV", "MIC_TPU_FUSED_LAZY_ATTN"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if fused_width:
        config = CaptionerConfig(
            vision=VisionConfig.tiny(),
            decoder=DecoderConfig.tiny(vocab_size=600, d_model=128, num_heads=2, ffn_dim=512,
                                       max_position_embeddings=64))
    else:
        config = _config(600)
    models = _models(config, seed=2, scale=0.5 if fused_width else 0.2)
    calls = {"fused_cross_attention_dma": 0, "beam_permute": 0}
    for mod, name in ((attention, "fused_cross_attention_dma"), (cache_mod, "beam_permute")):
        def counted(*args, _fn=getattr(mod, name), _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(mod, name, counted)
    kw = dict(num_beams=4, max_length=8, forced_bos_token_id=7, kv_quant=kv_quant)
    ref, out = _generate(models, _images(n=2 if fused_width else N_IMAGES, seed=3), kw)
    np.testing.assert_array_equal(out.sequences.numpy(), np.asarray(ref.sequences))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               rtol=1e-4 if atol is None else 0, atol=atol or 0)
    assert (out.sequences[:, 1] == 7).all()
    layers = config.decoder.num_layers
    if case == "physical":
        assert calls == {"fused_cross_attention_dma": 0, "beam_permute": 2 * out.steps}
    else:
        assert calls == {"fused_cross_attention_dma": layers * out.steps, "beam_permute": 0}


def test_gumbel_max_reproduces_jax_categorical():
    """argmax(warped + jax.random.gumbel(key)) is jax.random.categorical(key,
    warped), masked (NEG_INF) entries included: the port's draw with JAX's
    noise is JAX's draw."""
    rng = np.random.default_rng(0)
    warped = (rng.normal(size=(5, 300)) * 2).astype(np.float32)
    warped[:, ::3] = -1e7
    key = jax.random.PRNGKey(7)
    for _ in range(6):
        key, sub = jax.random.split(key)
        noise = np.array(jax.random.gumbel(sub, warped.shape, jnp.float32))
        want = np.asarray(jax.random.categorical(sub, jnp.asarray(warped), axis=-1))
        got = (torch.from_numpy(warped) + torch.from_numpy(noise)).argmax(dim=-1)
        np.testing.assert_array_equal(got.numpy(), want)


SAMPLE_CASES = {
    "warped": dict(kw=dict(temperature=0.7, top_k=50, top_p=0.9, forced_bos_token_id=7)),
    "no_repeat_ngram": dict(kw=dict(temperature=3.0, no_repeat_ngram_size=2,
                                    forced_eos_token_id=None)),
    "eos_positions": dict(kw=dict(temperature=0.7, top_k=50, forced_bos_token_id=5,
                                  forced_eos_token_id=None), eos_positions=[3, 7, 5]),
    "min_length": dict(eos_bias=3.0, kw=dict(min_length=5, temperature=1.5)),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sampling_matches_jax_under_jax_noise(case, monkeypatch):
    """do_sample=True with mic_tpu's rng: each step the port draws JAX's
    noise for that step (rng, key = split(rng); gumbel(key, (B, V)))."""
    spec = SAMPLE_CASES[case]
    config, models, u8 = _setup(spec, monkeypatch)
    kw = dict(dict(num_beams=1, max_length=12, do_sample=True), **spec["kw"])
    seed = jax.random.PRNGKey(11)
    noise, key = [], seed
    for _ in range(kw["max_length"] - 1):
        key, sub = jax.random.split(key)
        noise.append(np.array(jax.random.gumbel(
            sub, (N_IMAGES, config.decoder.vocab_size), jnp.float32)))

    def jax_noise(shape, generator, device):
        assert tuple(shape) == noise[0].shape and generator is not None
        return torch.from_numpy(noise.pop(0))

    monkeypatch.setattr(search, "gumbel_noise", jax_noise)
    ref, out = _generate(models, u8, kw, spec.get("eos_positions"), rng=seed)
    _assert_same(ref, out)
    assert len(noise) == kw["max_length"] - 1 - out.steps
    if "eos_positions" in spec:
        _check_pinned(out.sequences.numpy(), spec["eos_positions"],
                      config.decoder.eos_token_id, config.decoder.pad_token_id)


def test_sampling_topk1_equals_greedy_and_repeats_from_a_generator(monkeypatch):
    """top_k=1 sampling is greedy; a sampling run repeats from one seed and
    the default generator is seeded at 0."""
    _, models, u8 = _setup({}, monkeypatch)
    _, _, model, tparams = models
    px = preprocess_images(torch.from_numpy(u8), 32)
    greedy = model.generate(tparams, px, num_beams=1, max_length=12)
    top1 = model.generate(tparams, px, torch.Generator().manual_seed(3), num_beams=1,
                          max_length=12, do_sample=True, top_k=1)
    np.testing.assert_array_equal(top1.sequences.numpy(), greedy.sequences.numpy())
    kw = dict(num_beams=1, max_length=12, do_sample=True, temperature=2.0)
    runs = [model.generate(tparams, px, torch.Generator().manual_seed(s), **kw)
            for s in (5, 5, 0)]
    default = model.generate(tparams, px, **kw)
    assert torch.equal(runs[0].sequences, runs[1].sequences)
    assert torch.equal(runs[2].sequences, default.sequences)
    assert not torch.equal(runs[0].sequences, greedy.sequences)


WARPERS = {
    "temperature": dict(temperature=0.7),
    "top_k": dict(top_k=5),
    "top_k_beyond_vocab": dict(top_k=400),
    "top_p": dict(top_p=0.9),
    "top_p_narrow": dict(top_p=0.3),
    "chain": dict(temperature=0.7, top_k=50, top_p=0.9),
    "identity": dict(),
}


@pytest.mark.parametrize("case", sorted(WARPERS))
def test_warpers_match_jax(case):
    """build_warpers on the same log-probs (some entries already NEG_INF):
    equal outputs (each entry is the input, scaled, or NEG_INF)."""
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(6, 300)) * 3).astype(np.float32)
    lp = torch.log_softmax(torch.from_numpy(logits), dim=-1).numpy()
    lp[:, :10] = processors.NEG_INF
    ref = jax_processors.build_warpers(**WARPERS[case])(jnp.asarray(lp), 4)
    got = processors.build_warpers(**WARPERS[case])(torch.from_numpy(lp), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_ngram_windows_and_bans_match_jax(n):
    rng = np.random.default_rng(n)
    seqs = rng.integers(0, 5, size=(6, 12)).astype(np.int32)
    lp = rng.normal(size=(6, 5)).astype(np.float32)
    ids = np.tile(np.arange(5, dtype=np.int32), (6, 1))
    for cur_len in (1, 2, n - 1, n, 6, 11):
        match, nxt = search._ngram_windows(torch.from_numpy(seqs), cur_len, n)
        jmatch, jnxt = jax_search._ngram_windows(jnp.asarray(seqs), jnp.asarray(cur_len), n)
        np.testing.assert_array_equal(match.numpy(), np.asarray(jmatch))
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        dense = search._ngram_ban_dense(torch.from_numpy(lp), torch.from_numpy(seqs), cur_len, n)
        jdense = jax_search._ngram_ban_dense(jnp.asarray(lp), jnp.asarray(seqs),
                                             jnp.asarray(cur_len), n)
        np.testing.assert_array_equal(dense.numpy(), np.asarray(jdense))
        cand = search._ngram_ban_candidates(torch.from_numpy(lp), torch.from_numpy(ids),
                                            torch.from_numpy(seqs), cur_len, n)
        np.testing.assert_array_equal(cand.numpy(), dense.numpy())

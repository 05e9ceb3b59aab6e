"""The port's second captioner family and its untied head against mic_tpu.

The ViT+BART style (a ViT tower: patch bias, no pre-LN, the whole output
through post_ln; a post-norm BART decoder with no final LN and unscaled
embeddings, as ``CaptionerConfig.vit_b16_bart_large`` at a tiny width) and
the untied LM head (``tie_word_embeddings=False``, on either family).  The
same numpy weights go through both packages (io/from_jax.py) on the CPU at
float32, JAX at "highest" precision (tests/conftest.py), the port in its
plain versions.  Tolerances: 3e-5 for logits (mic_tpu's own bound for the
family, tests/test_vit_bart.py), token for token for sequences, 1e-5
relative for beam scores (sums of float32 log-probs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.core.config import CaptionerConfig, DecoderConfig, VisionConfig
from mic_tpu.models import clip_vit as jax_clip_vit
from mic_tpu.models.captioner import Captioner as JaxCaptioner
from mic_tpu.ops.image_prep import preprocess_images as jax_preprocess
from mic_tpu_torch.core import config as port_config
from mic_tpu_torch.io.from_jax import from_jax
from mic_tpu_torch.models import captioner as captioner_mod
from mic_tpu_torch.models import clip_vit
from mic_tpu_torch.models.captioner import Captioner, init_params
from mic_tpu_torch.ops.image_prep import preprocess_images

ATOL = 3e-5


def _port(cfg):
    return getattr(port_config, type(cfg).__name__).from_dict(cfg.to_dict())


def _config(kind: str, vocab: int = 600) -> CaptionerConfig:
    """"vit_bart": the ViT+BART style, tied; "vit_bart_untied": the same
    with an untied head; "untied": the CLIP+mBART style with an untied
    head."""
    vit = kind.startswith("vit_bart")
    vision = (VisionConfig.tiny(hidden_act="gelu", use_pre_ln=False, final_ln_output=True,
                                patch_bias=True, layer_norm_eps=1e-12)
              if vit else VisionConfig.tiny())
    decoder = (DecoderConfig.tiny(vocab_size=vocab, scale_embedding=False, post_norm=True,
                                  use_final_ln=False)
               if vit else DecoderConfig.tiny(vocab_size=vocab))
    return CaptionerConfig(vision=vision, decoder=decoder,
                           tie_word_embeddings=not kind.endswith("untied"))


def _numpy_params(jax_model, seed, scale):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_model.init_params, jax.random.PRNGKey(0))

    def fill(path, leaf):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + scale * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _models(config, seed=0, scale=0.05):
    jax_model = JaxCaptioner(config)
    nparams = _numpy_params(jax_model, seed, scale)
    return (jax_model, jax.tree.map(jnp.asarray, nparams), Captioner(_port(config)),
            from_jax(nparams))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, prefix + (key,))
    else:
        yield prefix, tree


def _images(n=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 48, 48, 3), dtype=np.uint8)


@pytest.mark.parametrize("kind", ["vit_bart", "vit_bart_untied", "untied"])
def test_init_params_has_mic_tpu_layout(kind):
    """The port's init_params gives mic_tpu's key paths and shapes: the ViT
    style's patch bias and no pre_ln, the untied head's lm_head kernel."""
    config = _config(kind)
    ref = dict(_leaves(_numpy_params(JaxCaptioner(config), 0, 0.05)))
    own = dict(_leaves(init_params(_port(config), torch.Generator().manual_seed(0))))
    assert own.keys() == ref.keys()
    for path, leaf in ref.items():
        assert tuple(own[path].shape) == leaf.shape, path
    assert (("lm_head", "kernel") in own) == kind.endswith("untied")
    assert (("vision", "patch_embed", "bias") in own) == kind.startswith("vit_bart")
    assert (("vision", "pre_ln", "scale") in own) != kind.startswith("vit_bart")


def test_vit_tower_matches_jax():
    """The ViT-style tower: patch bias, no pre-LN, post_ln over the whole
    output."""
    cfg = _config("vit_bart").vision
    jax_model, jparams, _, tparams = _models(_config("vit_bart"))
    px = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax_clip_vit.apply_vision(jparams["vision"], jnp.asarray(px), cfg))
    got = clip_vit.apply_vision(tparams["vision"], torch.from_numpy(px), _port(cfg)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("kind", ["vit_bart", "vit_bart_untied", "untied"])
def test_forward_matches_jax(kind):
    """Teacher-forced logits within 3e-5 of mic_tpu's."""
    config = _config(kind)
    jax_model, jparams, model, tparams = _models(config, seed=1, scale=0.1)
    rng = np.random.default_rng(2)
    px = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, config.decoder.vocab_size, size=(2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0
    ref = np.asarray(jax_model(jparams, jnp.asarray(px), jnp.asarray(ids), jnp.asarray(mask)))
    got = model(tparams, torch.from_numpy(px), torch.from_numpy(ids).long(),
                torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape == (2, 6, config.decoder.vocab_size)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_post_norm_cached_decode_matches_forward():
    """The post-norm decoder's cached steps equal its teacher-forced
    forward, as mic_tpu's tests/test_vit_bart.py holds mic_tpu's."""
    config = _config("vit_bart")
    _, _, model, tparams = _models(config, seed=3, scale=0.1)
    rng = np.random.default_rng(4)
    px = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 600, size=(2, 5))).long()
    enc = model.encode(tparams, px)
    full = model.decode_train(tparams, enc, ids, torch.ones((2, 5), dtype=torch.int64))
    cache = model.init_decode_cache(tparams, enc, 5, 1, lazy=False)
    steps = []
    for t in range(5):
        logits, cache = model.decode_step(tparams, ids[:, t:t + 1], cache)
        steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=ATOL)


GENERATE_CASES = {
    # beam 4 on the lazy cache (the default), dense logits on the CPU
    "beam4": dict(env={}, kw=dict(num_beams=4)),
    # beam 4 on the physical cache, reordered through ops/beam_permute.py
    "beam4_physical": dict(env={"MIC_TPU_LAZY_CACHE": "0"}, kw=dict(num_beams=4)),
    # greedy on the physical cache
    "greedy": dict(env={}, kw=dict(num_beams=1)),
    # the fused head where it is asked for: on the tied table only
    "beam4_fused_head": dict(env={"MIC_TPU_FUSED_HEAD": "1"}, kw=dict(num_beams=4)),
    # the dense logits' top-k + logsumexp select (row 17's plain version)
    "beam4_pallas_topk": dict(env={"MIC_TPU_EXPERIMENTAL": "pallas_topk"},
                              kw=dict(num_beams=4)),
}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
@pytest.mark.parametrize("kind", ["vit_bart", "vit_bart_untied", "untied"])
def test_generate_matches_jax(kind, case, monkeypatch):
    """Beam-4 and greedy sequences equal to mic_tpu's token for token."""
    spec = GENERATE_CASES[case]
    for key, value in spec["env"].items():
        monkeypatch.setenv(key, value)
    config = _config(kind)
    jax_model, jparams, model, tparams = _models(config, seed=5, scale=0.5)
    u8 = _images(n=3, seed=6)
    kw = dict(max_length=10, forced_bos_token_id=7, **spec["kw"])
    ref = jax.jit(lambda p, x: jax_model.generate(p, x, **kw))(
        jparams, jax_preprocess(jnp.asarray(u8), 32))
    out = model.generate(tparams, preprocess_images(torch.from_numpy(u8), 32), **kw)
    np.testing.assert_array_equal(out.sequences.numpy(), np.asarray(ref.sequences))
    # scores: sums of float32 log-probs, as tests/test_torch_captioner.py holds them
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), rtol=1e-5, atol=1e-5)
    assert (out.sequences[:, 1] == 7).all()


@pytest.mark.parametrize("tied", [True, False])
def test_fused_head_runs_on_the_tied_table_only(tied, monkeypatch):
    """mic_tpu's gate: MIC_TPU_FUSED_HEAD=1 selects through the fused head
    on a tied table; an untied head takes the dense logits."""
    monkeypatch.setenv("MIC_TPU_FUSED_HEAD", "1")
    config = _config("vit_bart" if tied else "vit_bart_untied")
    _, _, model, tparams = _models(config)
    calls = []
    real = captioner_mod.Captioner._candidate_head

    def spy(self, params, sel):
        calls.append(sel)
        return real(self, params, sel)

    monkeypatch.setattr(captioner_mod.Captioner, "_candidate_head", spy)
    model.generate(tparams, preprocess_images(torch.from_numpy(_images()), 32),
                   max_length=6, num_beams=2)
    assert calls == (["exact"] if tied else [])

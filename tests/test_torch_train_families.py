"""Training the second captioner family and the untied LM head in the port
(mic_tpu_torch) against mic_tpu on the CPU: the trainer's loss and
gradients on every route, the untied head's fused loss, remat.  Three
Trainer steps with dropout are in test_torch_train_families_steps.py, the
CLI and two-process runs in test_torch_train_families_runs.py; both take
this file's helpers.

The styles: the ViT tower (patch bias, no pre-LN, the whole output through
post_ln), the post-norm BART decoder (no final LN, unscaled embeddings),
the untied head (``tie_word_embeddings=False``: a (D, V) ``lm_head``
kernel, no bias), and all of the family's switches at once as
``CaptionerConfig.vit_b16_bart_large`` sets them, each at a tiny width.
The same numpy weights go through both packages (io/from_jax.py); JAX runs
at "highest" matmul precision (tests/conftest.py) and its flash-CE kernels
in interpret mode, the port in its plain versions.

An untied model's fused loss is held to mic_tpu's dense ("logits") route:
with ``fused_ce`` on, mic_tpu takes an untied model's loss from the shared
embedding, which is not the head whose logits it serves (ROADMAP §C), so
its fused route trains a head nobody reads.  The port takes the loss from
``lm_head``; the dense route is the function both packages serve.

Tolerances as test_torch_train.py states them: float32 losses within 1e-5,
each gradient leaf within 1e-4 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.core.config import (
    CaptionerConfig, DataConfig, DecoderConfig, TrainConfig, VisionConfig,
)
from mic_tpu.models.captioner import Captioner as JaxCaptioner
from mic_tpu.ops.fused_ce import fused_lm_loss as jax_fused_lm_loss
from mic_tpu.ops.image_prep import maybe_preprocess as jax_maybe_preprocess
from mic_tpu.train.loss import label_smoothed_cross_entropy as jax_lsce
from mic_tpu.train.shadow import ce_embedding as jax_ce_embedding
from mic_tpu.train.shadow import shadowed_params as jax_shadowed_params
from mic_tpu_torch.core import config as port_config
from mic_tpu_torch.core.params import tree_leaves
from mic_tpu_torch.io.from_jax import from_jax
from mic_tpu_torch.models.captioner import Captioner
from mic_tpu_torch.ops.image_prep import maybe_preprocess
from mic_tpu_torch.train.trainer import Trainer

LR = 1e-3
_VIT = dict(hidden_act="gelu", use_pre_ln=False, final_ln_output=True, patch_bias=True,
            layer_norm_eps=1e-12)
_BART = dict(scale_embedding=False, post_norm=True, use_final_ln=False, decoder_start_token_id=2)
KINDS = ("vit_tower", "post_norm", "untied_head", "vit_b16_bart_large")


def _port(cfg):
    """The port's config class of the same name, from the same values."""
    return getattr(port_config, type(cfg).__name__).from_dict(cfg.to_dict())


def _config(kind, dtype="float32", dropout=0.0, vocab=97):
    """One style at a tiny width: "vit_tower", "post_norm", "untied_head",
    "vit_b16_bart_large" (the preset's switches, tied) or "family_untied"
    (the same with an untied head)."""
    vit = kind in ("vit_tower", "vit_b16_bart_large", "family_untied")
    bart = kind in ("post_norm", "vit_b16_bart_large", "family_untied")
    vision = VisionConfig.tiny(attention_dropout=dropout, **(_VIT if vit else {}))
    decoder = DecoderConfig.tiny(vocab_size=vocab, dropout=dropout, attention_dropout=dropout,
                                 activation_dropout=dropout, **(_BART if bart else {}))
    return CaptionerConfig(vision=vision, decoder=decoder, dtype=dtype,
                           tie_word_embeddings=kind not in ("untied_head", "family_untied"))


def _numpy_params(config, seed=0, scale=0.05):
    """mic_tpu's param layout filled from numpy (nonzero biases, LN scales
    near 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JaxCaptioner(config).init_params, jax.random.PRNGKey(0))

    def fill(path, leaf):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + scale * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(config, b=4, t=8, seed=0, size=40):
    rng = np.random.default_rng(seed)
    v = config.decoder.vocab_size
    mask = np.ones((b, t), np.int32)
    mask[1, t - 3:] = 0  # a padded caption
    return {
        "pixel_values": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
        "labels": rng.integers(4, v, (b, t)).astype(np.int32),
        "decoder_input_ids": rng.integers(4, v, (b, t)).astype(np.int32),
        "decoder_attention_mask": mask,
    }


def _train_config(**tc):
    base = dict(per_device_batch_size=4, learning_rate=LR, warmup_steps=1, num_epochs=1,
                seed=0, label_smoothing=0.1, output_dir="unused")
    base.update(tc)
    return TrainConfig(**base)


def _trainer(config, **tc):
    trainer = Trainer(_port(config), _port(DataConfig(max_seq_length=8, decode_size=40)),
                      _port(_train_config(**tc)), device="cpu")
    trainer.build(10)
    return trainer


def _grad_params(nparams):
    params = from_jax(nparams)
    for _, leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def _jax_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _torch_leaves(tree):
    return [leaf.detach().float().numpy() for _, leaf in tree_leaves(tree)]


def _jax_value_and_grad(config, tc, remat=False):
    """jit of value_and_grad of mic_tpu/train/trainer.py's compute_loss,
    built from its parts: fn(params, shadow, batch, key) -> (loss, grads),
    dropout drawn where ``key`` is not None.  An untied model takes the
    dense route whatever ``tc.fused_ce`` says (see the module docstring)."""
    model = JaxCaptioner(config, remat=remat)
    dtype = config.compute_dtype
    fused = tc.fused_ce and config.tie_word_embeddings

    def loss_fn(params, shadow, batch, key):
        pixels = jax_maybe_preprocess(batch["pixel_values"], config.vision.image_size, dtype)
        labels, ids = batch["labels"], batch["decoder_input_ids"]
        mask = batch["decoder_attention_mask"]
        cp = jax_shadowed_params(params, shadow)
        if fused:
            vision_key = None if key is None else jax.random.fold_in(key, 0x5649)
            hidden = model.decode_hidden(cp, model.encode(cp, pixels, rng=vision_key), ids, mask,
                                         key)
            return jax_fused_lm_loss(hidden, params["shared"]["embedding"],
                                     params["final_logits_bias"], labels, mask,
                                     tc.label_smoothing, tc.ce_chunk,
                                     jax_ce_embedding(shadow), mode=tc.flash_ce)
        return jax_lsce(model(cp, pixels, ids, mask, rng=key), labels, mask, tc.label_smoothing)

    return jax.jit(jax.value_and_grad(loss_fn))


def _port_value_and_grad(trainer, nparams, batch, rng=None):
    params = _grad_params(nparams)
    dev = trainer.put_batch(batch)
    pixels = maybe_preprocess(dev["pixel_values"], trainer.mc.vision.image_size, trainer.dtype)
    loss = trainer.compute_loss(params, pixels, dev, rng)
    leaves = [leaf for _, leaf in tree_leaves(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return loss, params, grads


def _assert_loss_and_grads(loss, params, grads, jl, jg):
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-5)
    refs = _jax_leaves(jg)
    # a leaf whose exact gradient is 0 (a key bias) holds rounding noise:
    # each leaf's scale is floored at 1e-4 of the largest
    floor = 1e-4 * max(np.abs(r).max() for r in refs)
    for (path, _), got, ref in zip(tree_leaves(params), grads, refs):
        assert got.shape == ref.shape, path
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), floor), err_msg=str(path))


_ROUTES = [(kind, route) for kind in KINDS for route in ("chunked", "dl", "logits")]
_ROUTES += [("untied_head", route) for route in ("fwd", "split", "save")]


@pytest.mark.parametrize("kind,route", _ROUTES)
def test_family_loss_and_grads_match_jax(kind, route):
    """The trainer's compute_loss on each style and flash-CE route, float32:
    the loss within 1e-5 of mic_tpu's, each gradient leaf within 1e-4 of its
    largest entry.  An untied model's fused routes are held to mic_tpu's
    dense route, whose logits and gradients come from ``lm_head`` (mic_tpu's
    own fused route reads the shared embedding there: ROADMAP §C)."""
    config = _config(kind)
    trainer = _trainer(config, fused_ce=route != "logits",
                       flash_ce={"chunked": "0", "logits": "0"}.get(route, route))
    nparams = _numpy_params(config, seed=2)
    batch = _batch(config, seed=3)
    jl, jg = _jax_value_and_grad(config, trainer.tc)(
        jax.tree.map(jnp.asarray, nparams), None, jax.tree.map(jnp.asarray, batch), None)
    _assert_loss_and_grads(*_port_value_and_grad(trainer, nparams, batch), jl, jg)


def test_untied_fused_loss_trains_the_head_it_serves():
    """On an untied model with fused_ce on (the dl route), the port's loss
    is the loss of the logits it serves, and ``lm_head`` receives its
    gradient: the loss equals mic_tpu's dense route's and the cross-entropy
    of the port's own ``Captioner.__call__`` logits, while mic_tpu's fused
    route gives another loss and no gradient to ``lm_head`` (the fault
    ROADMAP §C records).  The shared embedding's gradient is its lookup's
    alone, equal to the dense route's."""
    config = _config("untied_head")
    trainer = _trainer(config, fused_ce=True, flash_ce="dl")
    nparams = _numpy_params(config, seed=5)
    batch = _batch(config, seed=6)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jparams = jax.tree.map(jnp.asarray, nparams)
    dense_l, dense_g = _jax_value_and_grad(config, trainer.tc)(jparams, None, jbatch, None)
    tied_config = config.replace(tie_word_embeddings=True)
    fault_l, fault_g = _jax_value_and_grad(tied_config, trainer.tc)(
        {k: v for k, v in jparams.items() if k != "lm_head"}, None, jbatch, None)
    loss, params, grads = _port_value_and_grad(trainer, nparams, batch)
    by_path = {path: g for (path, _), g in zip(tree_leaves(params), grads)}

    np.testing.assert_allclose(loss.item(), float(dense_l), rtol=1e-5, atol=1e-5)
    assert abs(float(fault_l) - float(dense_l)) > 1e-2, (float(fault_l), float(dense_l))
    head = by_path[("lm_head", "kernel")].numpy()
    want = np.asarray(dense_g["lm_head"]["kernel"])
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(head, want, rtol=0, atol=1e-4 * np.abs(want).max())
    emb = by_path[("shared", "embedding")].numpy()
    want = np.asarray(dense_g["shared"]["embedding"])
    np.testing.assert_allclose(emb, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # mic_tpu's fused route differentiates the shared table as the head
    assert not np.allclose(np.asarray(fault_g["shared"]["embedding"]), want, atol=1e-3)

    model = Captioner(_port(config))
    tparams = from_jax(nparams)
    dev = trainer.put_batch(batch)
    logits = model(tparams, maybe_preprocess(dev["pixel_values"], 32, torch.float32),
                   dev["decoder_input_ids"], dev["decoder_attention_mask"])
    from mic_tpu_torch.train.loss import label_smoothed_cross_entropy

    served = label_smoothed_cross_entropy(logits, dev["labels"], dev["decoder_attention_mask"],
                                          0.1)
    np.testing.assert_allclose(loss.item(), served.item(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat", ["full", "masks", "dots"])
def test_remat_reproduces_no_remat_on_the_new_styles(remat):
    """The ViT tower and the post-norm decoder with an untied head, every
    dropout site on, one torch generator: each remat policy gives a loss,
    gradients and a generator state after the step bit-equal to no
    remat's, on the fused (dl) route and the dense one."""
    config = _config("family_untied", dropout=0.1)
    nparams = _numpy_params(config, seed=7)
    batch = _batch(config, seed=8)
    for fused in (True, False):
        out = {}
        for policy in ("none", remat):
            trainer = _trainer(config, remat=policy, fused_ce=fused, flash_ce="dl")
            gen = torch.Generator().manual_seed(9)
            loss, _, grads = _port_value_and_grad(trainer, nparams, batch, gen)
            out[policy] = (loss.detach(), grads, torch.rand(4, generator=gen))
        assert torch.equal(out[remat][0], out["none"][0]), fused
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1])), fused
        assert torch.equal(out[remat][2], out["none"][2]), fused

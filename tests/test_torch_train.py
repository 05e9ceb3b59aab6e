"""The port's training slice (mic_tpu_torch: apply_decoder, Captioner.__call__,
the trainer's loss and gradients, fused AdamW, shadow params, schedule,
remat, Trainer.train) against mic_tpu on the CPU.

Parity runs at dropout 0 or with no dropout generator on either side:
torch's Philox stream cannot reproduce jax.random's masks, so dropout is
held to its own contract (keep rate, inverted scale, remat equality, run to
run bit equality).  JAX runs at "highest" matmul precision
(tests/conftest.py); flash-CE kernels in interpret mode, the port in its
plain versions.  Tolerances are stated at each comparison: float32 paths
within 1e-5 (values) or 1e-4 of a leaf's largest entry (gradients, sums in
another order); bf16 paths within a few bf16 ulps.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.core.config import (
    CaptionerConfig, DataConfig, DecoderConfig, TrainConfig, VisionConfig,
)
from mic_tpu.models import mbart_decoder as jax_dec
from mic_tpu.models.captioner import Captioner as JaxCaptioner
from mic_tpu.ops.fused_ce import fused_lm_loss as jax_fused_lm_loss
from mic_tpu.ops.image_prep import maybe_preprocess as jax_maybe_preprocess
from mic_tpu.train.fused_adamw import apply_gradients as jax_apply_gradients
from mic_tpu.train.loss import label_smoothed_cross_entropy as jax_lsce
from mic_tpu.train.schedule import linear_warmup_linear_decay as jax_schedule
from mic_tpu.train.shadow import ce_embedding as jax_ce_embedding
from mic_tpu.train.shadow import shadow_spec as jax_shadow_spec
from mic_tpu.train.shadow import shadowed_params as jax_shadowed_params
from mic_tpu.train.state import TrainState as JaxTrainState
from mic_tpu.train.state import make_optimizer as jax_make_optimizer
from mic_tpu_torch.core import config as port_config
from mic_tpu_torch.core.params import tree_leaves
from mic_tpu_torch.io.from_jax import from_jax, opt_state_from_jax
from mic_tpu_torch.models import mbart_decoder
from mic_tpu_torch.models.captioner import Captioner
from mic_tpu_torch.nn.layers import dropout
from mic_tpu_torch.ops.image_prep import maybe_preprocess
from mic_tpu_torch.train.schedule import linear_warmup_linear_decay
from mic_tpu_torch.train.shadow import shadow_spec
from mic_tpu_torch.train.state import make_optimizer
from mic_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(cfg):
    """The port's config class of the same name, from the same values."""
    return getattr(port_config, type(cfg).__name__).from_dict(cfg.to_dict())


def _config(dtype="float32", vocab=97, **dec):
    return CaptionerConfig(vision=VisionConfig.tiny(),
                           decoder=DecoderConfig.tiny(vocab_size=vocab, **dec), dtype=dtype)


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


def _trainer(config, device="cpu", **tc):
    base = dict(per_device_batch_size=4, learning_rate=1e-3, warmup_steps=1, num_epochs=1,
                seed=0, label_smoothing=0.1, output_dir="unused")
    base.update(tc)
    trainer = Trainer(_port(config), _port(DataConfig(max_seq_length=8, decode_size=40)),
                      _port(TrainConfig(**base)), device=device)
    trainer.build(10)
    return trainer


def _grad_params(nparams):
    params = from_jax(nparams)
    for _, leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def _close_scaled(got, ref, frac, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    # the floor covers leaves whose true gradient is 0 (a key bias under
    # softmax), where both sides hold rounding noise of ~1e-12
    np.testing.assert_allclose(got, ref, rtol=0, atol=frac * max(np.abs(ref).max(), 1e-6),
                               err_msg=str(name))


def _jax_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _torch_leaves(tree):
    return [leaf.detach().float().numpy() for _, leaf in tree_leaves(tree)]


def test_apply_decoder_and_call_match_jax():
    """Teacher-forced decoder hidden states (padding and encoder masks on)
    and the captioner's logits, float32 at dropout 0: within 1e-5."""
    config = _config()
    cfg = config.decoder
    nparams = _numpy_params(config)
    jparams, tparams = jax.tree.map(jnp.asarray, nparams), from_jax(nparams)
    batch = _batch(config)
    rng = np.random.default_rng(1)
    enc = rng.normal(size=(4, 5, cfg.d_model)).astype(np.float32)
    enc_mask = np.ones((4, 5), np.int32)
    enc_mask[2, 3:] = 0
    ids, mask = batch["decoder_input_ids"], batch["decoder_attention_mask"]
    ref = jax_dec.apply_decoder(jparams["decoder"], jparams["shared"], jnp.asarray(ids),
                                jnp.asarray(mask), jnp.asarray(enc), jnp.asarray(enc_mask), cfg)
    got = mbart_decoder.apply_decoder(tparams["decoder"], tparams["shared"],
                                      torch.from_numpy(ids), torch.from_numpy(mask),
                                      torch.from_numpy(enc), torch.from_numpy(enc_mask), _port(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    pixels = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    ref = JaxCaptioner(config)(jparams, jnp.asarray(pixels), jnp.asarray(ids), jnp.asarray(mask))
    got = Captioner(_port(config))(tparams, torch.from_numpy(pixels), torch.from_numpy(ids),
                            torch.from_numpy(mask))
    assert got.shape == (4, 8, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _jax_value_and_grad(config, tc):
    """jit of value_and_grad of mic_tpu/train/trainer.py:164-198
    (compute_loss), built from its parts, with no dropout key:
    fn(params, shadow, batch) -> (loss, grads)."""
    model = JaxCaptioner(config)
    dtype = config.compute_dtype

    def loss_fn(params, shadow, batch):
        pixels = jax_maybe_preprocess(batch["pixel_values"], config.vision.image_size, dtype)
        labels, ids = batch["labels"], batch["decoder_input_ids"]
        mask = batch["decoder_attention_mask"]
        cp = jax_shadowed_params(params, shadow)
        if tc.fused_ce:
            hidden = model.decode_hidden(cp, model.encode(cp, pixels), ids, mask, None)
            return jax_fused_lm_loss(hidden, params["shared"]["embedding"],
                                     params["final_logits_bias"], labels, mask,
                                     tc.label_smoothing, tc.ce_chunk,
                                     jax_ce_embedding(shadow), mode=tc.flash_ce)
        return jax_lsce(model(cp, pixels, ids, mask), labels, mask, tc.label_smoothing)

    return jax.jit(jax.value_and_grad(loss_fn))


@pytest.mark.parametrize("route", ["chunked", "dl", "logits", "fwd", "split", "save"])
def test_compute_loss_and_grads_match_jax(route):
    """Loss and every gradient of the trainer's compute_loss, float32: the
    loss within 1e-5, each gradient leaf within 1e-4 of its largest entry.
    At V = 97 the save route's logits are all f32 tail (v_main = 0)."""
    config = _config()
    tc = dict(fused_ce=route != "logits",
              flash_ce={"chunked": "0", "logits": "0"}.get(route, route))
    trainer = _trainer(config, **tc)
    nparams = _numpy_params(config, seed=2)
    batch = _batch(config, seed=3)
    jl, jg = _jax_value_and_grad(config, trainer.tc)(jax.tree.map(jnp.asarray, nparams), None,
                                                     jax.tree.map(jnp.asarray, batch))

    params = _grad_params(nparams)
    dev = trainer.put_batch(batch)
    pixels = maybe_preprocess(dev["pixel_values"], 32, torch.float32)
    loss = trainer.compute_loss(params, pixels, dev)
    leaves = [leaf for _, leaf in tree_leaves(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-5)
    paths = [path for path, _ in tree_leaves(params)]
    for path, got, ref in zip(paths, grads, _jax_leaves(jg)):
        assert got.shape == ref.shape, path
        _close_scaled(got.numpy(), ref, 1e-4, path)


def _head_dim_64_config():
    """Head dim 64 in both towers, so small_attn's shape gate takes every
    self-attention (vision T = 5, decoder T = 8)."""
    return CaptionerConfig(vision=VisionConfig.tiny(hidden_size=128, num_heads=2),
                           decoder=DecoderConfig.tiny(vocab_size=97, d_model=128, num_heads=2,
                                                      ffn_dim=256))


@pytest.mark.parametrize("route", ["dl", "logits"])
def test_compute_loss_and_grads_match_jax_under_small_attn(route, monkeypatch):
    """MIC_TPU_EXPERIMENTAL=small_attn reaches training through the
    environment, as in mic_tpu: the Trainer builds, and on the CPU both
    packages take the XLA math (mic_tpu's kernel only on the TPU, the port's
    only on CUDA tensors).  Loss within 1e-5, gradients within 1e-4 of each
    leaf's largest entry (floored)."""
    monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", "small_attn")
    config = _head_dim_64_config()
    trainer = _trainer(config, fused_ce=route != "logits", flash_ce="dl" if route == "dl" else "0")
    nparams = _numpy_params(config, seed=21)
    batch = _batch(config, seed=22)
    jl, jg = _jax_value_and_grad(config, trainer.tc)(jax.tree.map(jnp.asarray, nparams), None,
                                                     jax.tree.map(jnp.asarray, batch))
    params = _grad_params(nparams)
    dev = trainer.put_batch(batch)
    loss = trainer.compute_loss(params, maybe_preprocess(dev["pixel_values"], 32, torch.float32),
                                dev)
    leaves = [leaf for _, leaf in tree_leaves(params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-5)
    refs = _jax_leaves(jg)
    # a leaf whose exact gradient is 0 (a key bias) holds rounding noise of
    # ~1e-9 of the largest gradient at this width: each leaf's scale is
    # floored at 1e-4 of the largest
    floor = 1e-4 * max(np.abs(r).max() for r in refs)
    for (path, _), got, ref in zip(tree_leaves(params), grads, refs):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), floor), err_msg=str(path))


def test_apply_decoder_position_ids_match_jax():
    """Non-default position_ids (per caption, not 0..T-1) with the
    introspection outputs: every field within 1e-5 of mic_tpu's, and the
    hidden state differs from the default positions'."""
    config = _config()
    cfg = config.decoder
    nparams = _numpy_params(config, seed=23)
    jparams, tparams = jax.tree.map(jnp.asarray, nparams), from_jax(nparams)
    batch = _batch(config, seed=24)
    rng = np.random.default_rng(25)
    enc = rng.normal(size=(4, 5, cfg.d_model)).astype(np.float32)
    positions = (np.arange(8)[None] + rng.integers(0, 40, (4, 1))).astype(np.int32)
    ids, mask = batch["decoder_input_ids"], batch["decoder_attention_mask"]
    ref = jax_dec.apply_decoder(jparams["decoder"], jparams["shared"], jnp.asarray(ids),
                                jnp.asarray(mask), jnp.asarray(enc), None, cfg,
                                position_ids=jnp.asarray(positions), output_hidden_states=True,
                                output_attentions=True)
    args = (tparams["decoder"], tparams["shared"], torch.from_numpy(ids), torch.from_numpy(mask),
            torch.from_numpy(enc), None, _port(cfg))
    got = mbart_decoder.apply_decoder(*args, position_ids=torch.from_numpy(positions),
                                      output_hidden_states=True, output_attentions=True)
    for field, a, b in zip(got._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5, err_msg=field)
    default = mbart_decoder.apply_decoder(*args)
    assert not torch.allclose(default, got.last_hidden_state, atol=1e-3)


@pytest.mark.parametrize("remat", ["full", "masks", "dots"])
def test_introspection_outputs_under_remat(remat):
    """A checkpointed layer returns its per-layer outputs too: with every
    dropout site on and one generator, __call__'s introspection outputs and
    the gradients of a loss over all of them are bit-equal to no remat's."""
    config = _dropout_config()
    nparams = _numpy_params(config, seed=26)
    batch = _batch(config, seed=27)
    pixels = torch.from_numpy(np.random.default_rng(28).normal(size=(4, 32, 32, 3))
                              .astype(np.float32))
    out = {}
    for policy in ("none", remat):
        params = _grad_params(nparams)
        model = Captioner(_port(config), remat=policy)
        res = model(params, pixels, torch.from_numpy(batch["decoder_input_ids"]),
                    torch.from_numpy(batch["decoder_attention_mask"]),
                    torch.Generator().manual_seed(29), output_hidden_states=True,
                    output_attentions=True)
        total = sum((x.float() * (i + 1)).sum() for i, x in enumerate(res))
        leaves = [leaf for _, leaf in tree_leaves(params)]
        grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
        out[policy] = ([x.detach() for x in res], grads)
    for a, b in zip(out[remat][0], out["none"][0]):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1]))


def test_fused_adamw_three_steps_match_jax():
    """Clipping, weight decay with its mask, bf16 moments, warmup: one JAX
    step, the state carried across (io/from_jax.py), then three steps on
    each side.  Params within 1e-5 absolute (1% of an lr-1e-3 update: a bf16
    moment may round one ulp the other way), moments within 1/128 relative
    (plus 1e-3 of the leaf's largest entry),
    counts equal."""
    config = _config()
    nparams = _numpy_params(config, seed=4)
    lr = 1e-3
    kw = dict(weight_decay=0.01, max_grad_norm=1.0, mu_dtype="bfloat16", nu_dtype="bfloat16")
    jopt = jax_make_optimizer(jax_schedule(lr, 10, 2), **kw)
    topt = make_optimizer(linear_warmup_linear_decay(lr, 10, 2), **kw)
    rng = np.random.default_rng(5)

    def grads():  # the global norm lands on both sides of max_grad_norm
        scale = rng.choice([0.01, 1.0])
        return jax.tree.map(lambda p: (scale * rng.normal(size=p.shape)).astype(np.float32),
                            nparams)

    jstep = jax.jit(lambda p, g, s: jax_apply_gradients(jopt, p, g, s))
    jparams = jax.tree.map(jnp.asarray, nparams)
    jstate = jopt.init(jparams)
    jparams, jstate = jstep(jparams, jax.tree.map(jnp.asarray, grads()), jstate)
    tparams = from_jax(jax.device_get(jparams))
    tstate = opt_state_from_jax(jax.device_get(jstate))
    assert tstate.count == 1
    assert all(leaf.dtype == torch.bfloat16 for _, leaf in tree_leaves(tstate.mu))
    for _ in range(3):
        g = grads()
        jparams, jstate = jstep(jparams, jax.tree.map(jnp.asarray, g), jstate)
        tparams, tstate = topt.step(tparams, from_jax(g), tstate)
    assert tstate.count == int(jstate.count) == 4
    for got, ref in zip(_torch_leaves(tparams), _jax_leaves(jparams)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    for tree, jtree in ((tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
        for got, ref in zip(_torch_leaves(tree), _jax_leaves(jtree)):
            # a moment near a cancellation (b1 * mu against (1 - b1) * g) keeps
            # the f32 rounding of the operands: the floor is relative to the leaf
            np.testing.assert_allclose(got, ref, rtol=1 / 128, atol=1e-3 * np.abs(ref).max())


def test_shadow_step_matches_jax():
    """Three trainer steps at a bf16 tiny config with shadow params and the
    dl route, against mic_tpu's shadow step (tests/test_shadow.py:163-213)
    from the same weights: losses within 2e-3 relative (bf16 activations
    round at other places), params within 2 * steps * lr (Adam can flip a
    near-zero-gradient leaf's whole update; a mis-wired shadow would show
    at weight magnitude), and the port's shadow exactly astype(params)."""
    config = _config("bfloat16")
    trainer = _trainer(config, flash_ce="dl", adam_mu_dtype="bfloat16")
    nparams = _numpy_params(config, seed=6)
    jmodel_dtype = config.compute_dtype
    jparams = jax.tree.map(jnp.asarray, nparams)
    jopt = jax_make_optimizer(jax_schedule(1e-3, 10, 1), mu_dtype="bfloat16",
                              nu_dtype="bfloat16")
    spec = jax_shadow_spec(jparams, jmodel_dtype)
    jstate = JaxTrainState.create(jparams, jopt, 0, shadow_dtype=jmodel_dtype)
    state = trainer.init_state(from_jax(nparams))
    jstep = jax.jit(lambda p, g, s: jax_apply_gradients(jopt, p, g, s, shadow_spec=spec,
                                                        shadow_dtype=jmodel_dtype))
    jloss = _jax_value_and_grad(config, trainer.tc)
    for i in range(3):
        batch = _batch(config, seed=10 + i)
        jl, jg = jloss(jstate.params, jstate.shadow, jax.tree.map(jnp.asarray, batch))
        p, o, sh = jstep(jstate.params, jg, jstate.opt_state)
        jstate = JaxTrainState(p, o, jstate.step + 1, jstate.dropout_rng, sh)
        state, metrics = trainer.train_step(state, trainer.put_batch(batch))
        np.testing.assert_allclose(metrics["loss"].item(), float(jl), rtol=2e-3)
    for got, ref in zip(_torch_leaves(state.params), _jax_leaves(jstate.params)):
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2 * 3 * 1e-3)
    tspec = shadow_spec(state.params, torch.bfloat16)
    for (_, p), (_, s), (_, sh) in zip(tree_leaves(state.params), tree_leaves(state.shadow),
                                       tree_leaves(tspec)):
        assert torch.equal(s, p.detach().bfloat16()) if sh else s is p


@pytest.mark.parametrize("warmup", [0, 1, 10])
def test_schedule_matches_jax(warmup):
    """Every step of warmup and decay, and past the end: equal in float32."""
    ours = linear_warmup_linear_decay(3e-4, 100, warmup)
    ref = jax_schedule(3e-4, 100, warmup)
    for step in [0, 1, 5, 9, 10, 11, 55, 99, 100, 150]:
        assert np.float32(ours(step)) == np.float32(ref(step)), step
    assert ours(0) == (0.0 if warmup else np.float32(3e-4))
    assert np.float32(ours(warmup)) == np.float32(3e-4)
    assert ours(100) == 0.0


def test_dropout_keep_rate_and_scale():
    """About rate of the entries dropped, the rest scaled by 1/(1 - rate);
    identity without a generator or at rate 0."""
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.1, gen)
    dropped = (y == 0).float().mean().item()
    assert abs(dropped - 0.1) < 0.005, dropped
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert dropout(x, 0.1, None) is x and dropout(x, 0.0, gen) is x


def _dropout_config():
    return CaptionerConfig(
        vision=VisionConfig.tiny(attention_dropout=0.1),
        decoder=DecoderConfig.tiny(vocab_size=97, dropout=0.1, attention_dropout=0.1,
                                   activation_dropout=0.1),
    )


def test_remat_grads_equal_no_remat_with_dropout():
    """"masks", "full" and "dots" give bit-equal loss and gradients to no
    remat with every dropout site on and the same generator, and leave the
    generator where no remat leaves it."""
    config = _dropout_config()
    nparams = _numpy_params(config, seed=7)
    batch = _batch(config, seed=8)
    out = {}
    for remat in ("none", "full", "masks", "dots"):
        trainer = _trainer(config, remat=remat, flash_ce="dl")
        params = _grad_params(nparams)
        dev = trainer.put_batch(batch)
        gen = torch.Generator().manual_seed(9)
        loss = trainer.compute_loss(params, maybe_preprocess(dev["pixel_values"], 32,
                                                             torch.float32), dev, gen)
        leaves = [leaf for _, leaf in tree_leaves(params)]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        out[remat] = (loss.detach(), grads, torch.rand(4, generator=gen))
    for remat in ("full", "masks", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1], out["none"][1])), remat
        assert torch.equal(out[remat][2], out["none"][2]), remat


def test_dots_remat_and_unported_options_raise(tmp_path):
    """remat "dots", profile_steps, fused_adamw=False (with a float32 nu)
    and fsdp (at one process, the single-device layout) are ported and take
    a finite step (tests/test_torch_train_options.py and
    tests/test_torch_parallel.py hold them to mic_tpu); tp > 1 raises,
    naming A7b, and dp=2 in a one-process world raises mic_tpu's mesh
    error."""
    config = _config()
    for ported in (dict(remat="dots"), dict(profile_steps="1:2"),
                   dict(fused_adamw=False, adam_nu_dtype="float32"), dict(fsdp=True)):
        trainer = _trainer(config, **ported)
        state, metrics = trainer.train_step(trainer.init_state(),
                                            trainer.put_batch(_batch(config)))
        assert math.isfinite(metrics["loss"].item()), ported
    with pytest.raises(NotImplementedError, match="A7b"):
        _trainer(config, tp=2)
    with pytest.raises(ValueError, match=r"dp\*tp = 2\*1 != 1 devices"):
        _trainer(config, dp=2)
    # resume_from is ported: a path with no checkpoints is file-not-found
    trainer = _trainer(config, resume_from=str(tmp_path / "x"),
                       output_dir=str(tmp_path / "run"))
    with pytest.raises(FileNotFoundError):
        trainer.init_or_resume(None)


def test_train_steps_are_bit_equal_run_to_run():
    """Two trainers from one seed, dropout on, remat "masks", bf16 with
    shadow params: bit-equal losses and params after three steps."""
    config = _dropout_config().replace(dtype="bfloat16")
    runs = []
    for _ in range(2):
        trainer = _trainer(config, flash_ce="dl")
        state = trainer.init_state()
        batch = trainer.put_batch(_batch(config, seed=11))
        losses = []
        for _ in range(3):
            state, m = trainer.train_step(state, batch)
            losses.append(m["loss"].item())
        runs.append((losses, _torch_leaves(state.params)))
    assert runs[0][0] == runs[1][0]
    assert all(np.array_equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert all(math.isfinite(x) for x in runs[0][0])


def _synthetic_tsv(tmp_path, n=32, size=40):
    from PIL import Image

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    langs = ["en_XX", "fr_XX", "es_XX", "de_DE"]
    words = ["cat", "dog", "red", "blue", "house", "tree", "runs", "sleeps"]
    rows = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
            img_dir / f"img_{i}.png")
        rows.append(f"img_{i}.png\t{' '.join(rng.choice(words, 4))}\thttp://x\t{langs[i % 4]}")
    (tmp_path / "train.tsv").write_text("\n".join(rows[:24]) + "\n")
    (tmp_path / "val.tsv").write_text("\n".join(rows[24:]) + "\n")
    return str(tmp_path / "train.tsv"), str(tmp_path / "val.tsv"), str(img_dir)


def test_cli_train_end_to_end(tmp_path):
    """``python -m mic_tpu_torch.cli.train``'s main on a synthetic TSV through
    the shared CaptionLoader: finite, falling train losses in metrics.jsonl,
    eval loss and BLEU per language, the final train checkpoint, and a model
    directory (config.json, tokenizer.json) that from_pretrained reloads."""
    from mic_tpu_torch.cli.train import main

    train_tsv, val_tsv, img_dir = _synthetic_tsv(tmp_path)
    cfg_path = tmp_path / "model.json"
    CaptionerConfig.tiny(decoder=DecoderConfig.tiny(vocab_size=64, dropout=0.1)).to_json(
        str(cfg_path))
    out = tmp_path / "run"
    main(["--train_file", train_tsv, "--validation_file", val_tsv, "--images_dir", img_dir,
          "--output_dir", str(out), "--model_config", str(cfg_path), "--num_epochs", "5",
          "--per_device_batch_size", "4", "--learning_rate", "3e-3", "--warmup_steps", "2",
          "--logging_steps", "1", "--eval_steps", "1000", "--max_seq_length", "12",
          "--decode_size", "40", "--num_workers", "0", "--seed", "0", "--device", "cpu"])
    lines = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    losses = [line["train/loss"] for line in lines if "train/loss" in line]
    assert len(losses) == 30 and all(math.isfinite(x) for x in losses)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    evals = lines[-1]
    for lang in ("en_XX", "fr_XX", "es_XX", "de_DE"):
        assert math.isfinite(evals[f"eval/{lang}/loss"])
        assert f"eval/{lang}/bleu-1" in evals
    # 6 steps an epoch, save_steps 9000: the final save alone
    assert os.listdir(out / "checkpoints") == ["30"]
    assert (out / "model" / "config.json").exists() and (out / "model" / "tokenizer.json").exists()
    model, params = Captioner.from_pretrained(str(out / "model"), device="cpu")
    assert model.config.decoder.vocab_size == 64
    assert all(leaf.dtype == torch.float32 and bool(torch.isfinite(leaf).all())
               for _, leaf in tree_leaves(params))


def test_trainer_and_cli_default_to_the_card(monkeypatch):
    """With no device named, the Trainer and the CLI take the CUDA card;
    without one they raise (never a silent CPU run), and device="cpu" /
    ``--device cpu`` is the one way to the CPU."""
    from mic_tpu_torch.cli.train import main
    from mic_tpu_torch.train.trainer import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    config = _port(_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(config, _port(DataConfig()), _port(TrainConfig(output_dir="unused")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--train_file", "unused.tsv", "--output_dir", "unused"])


def test_training_never_imports_jax():
    """A process that imports the training modules and the CLI and runs a
    tiny bf16 train step on the dl route has no JAX module loaded."""
    code = (
        "import sys, numpy as np, torch\n"
        "from mic_tpu_torch.core.config import *\n"
        "import mic_tpu_torch.cli.train\n"
        "from mic_tpu_torch.train.trainer import Trainer\n"
        "cfg = CaptionerConfig(vision=VisionConfig.tiny(),\n"
        "    decoder=DecoderConfig.tiny(dropout=0.1), dtype='bfloat16')\n"
        "tr = Trainer(cfg, DataConfig(), TrainConfig(per_device_batch_size=2, flash_ce='dl',\n"
        "    output_dir='unused'), device='cpu')\n"
        "tr.build(4)\n"
        "b = {'pixel_values': np.zeros((2, 40, 40, 3), np.uint8),\n"
        "     'labels': np.full((2, 6), 5, np.int32),\n"
        "     'decoder_input_ids': np.full((2, 6), 5, np.int32),\n"
        "     'decoder_attention_mask': np.ones((2, 6), np.int32)}\n"
        "state, m = tr.train_step(tr.init_state(), tr.put_batch(b))\n"
        "assert torch.isfinite(m['loss'])\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"

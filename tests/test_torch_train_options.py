"""The rest of single-card training in the port (ROADMAP A6) against
mic_tpu on the CPU: the optax chain (``TrainConfig.fused_adamw=False``,
mic_tpu_torch/train/adamw_chain.py), remat "dots" (nn/stacked.py) and
``profile_steps`` (train/trainer.py's StepProfiler), through the Trainer
and the training CLI.

JAX runs at "highest" matmul precision (tests/conftest.py), the port in
its plain versions.  Tolerances, stated at each comparison: the chain's
params within 1e-6 absolute over five steps (an lr-1e-3 update computed in
f32 by both; the global norm and the powers b^c sum or round in another
order), f32 moments within 1e-6 relative plus 1e-7 of the leaf's largest
entry, bf16 mu within one bf16 ulp (1/128 relative, plus 1e-3 of the
leaf's largest entry where b1 mu and (1-b1) g cancel); losses of the Trainer
against mic_tpu's within a relative 1e-4 (tests/test_torch_trained_tools.py's
bound); "dots" gradients bit-equal to no remat's and within 1e-4 of each
leaf's largest entry of mic_tpu's remat="dots" (the float32 bound of
tests/test_torch_train.py); profiled and resumed runs bit-equal.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mic_tpu.core.config import (
    CaptionerConfig, DataConfig, DecoderConfig, TrainConfig, VisionConfig,
)
from mic_tpu.models.captioner import Captioner as JaxCaptioner
from mic_tpu.ops.fused_ce import fused_lm_loss as jax_fused_lm_loss
from mic_tpu.ops.image_prep import maybe_preprocess as jax_maybe_preprocess
from mic_tpu.train.fused_adamw import apply_gradients as jax_apply_gradients
from mic_tpu.train.schedule import linear_warmup_linear_decay as jax_schedule
from mic_tpu.train.state import TrainState as JaxTrainState
from mic_tpu.train.state import make_optimizer as jax_make_optimizer
from mic_tpu.train.trainer import Trainer as JaxTrainer
from mic_tpu_torch.core import config as port_config
from mic_tpu_torch.core.params import tree_leaves
from mic_tpu_torch.io.from_jax import from_jax, opt_state_from_jax
from mic_tpu_torch.ops.image_prep import maybe_preprocess
from mic_tpu_torch.train.adamw_chain import AdamWChain, AdamWChainState
from mic_tpu_torch.train.fused_adamw import apply_gradients
from mic_tpu_torch.train.schedule import linear_warmup_linear_decay
from mic_tpu_torch.train.state import make_optimizer, moment_dtypes
from mic_tpu_torch.train.trainer import Trainer, profile_range

LANGS = ["en_XX", "fr_XX", "es_XX", "de_DE"]


def _port(cfg):
    """The port's config class of the same name, from the same values."""
    return getattr(port_config, type(cfg).__name__).from_dict(cfg.to_dict())


def _config(dtype="float32"):
    return CaptionerConfig(vision=VisionConfig.tiny(), decoder=DecoderConfig.tiny(vocab_size=97),
                           dtype=dtype)


def _numpy_params(config, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JaxCaptioner(config).init_params, jax.random.PRNGKey(0))

    def fill(path, leaf):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + scale * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(config, b=8, t=8, seed=0, size=40):
    rng = np.random.default_rng(seed)
    v = config.decoder.vocab_size
    mask = np.ones((b, t), np.int32)
    mask[1, t - 3:] = 0
    return {
        "pixel_values": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
        "labels": rng.integers(4, v, (b, t)).astype(np.int32),
        "decoder_input_ids": rng.integers(4, v, (b, t)).astype(np.int32),
        "decoder_attention_mask": mask,
    }


def _trainer(config, device="cpu", **tc):
    base = dict(per_device_batch_size=8, learning_rate=1e-3, warmup_steps=1, num_epochs=1,
                seed=0, label_smoothing=0.1, output_dir="unused")
    base.update(tc)
    trainer = Trainer(_port(config), _port(DataConfig(max_seq_length=8, decode_size=40)),
                      _port(TrainConfig(**base)), device=device)
    trainer.build(10)
    return trainer


def _jax_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _torch_leaves(tree):
    return [leaf.detach().float().numpy() for _, leaf in tree_leaves(tree)]


# -- the optax chain ----------------------------------------------------------

@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("decay", [0.0, 0.01])
@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adamw_chain_matches_optax_chain(mu_dtype, decay, clip):
    """mic_tpu's make_optimizer(fused=False) and the port's, five steps
    from the same params with warmup, the chain's state carried across
    after the first (io/from_jax.py): counts equal, params within 1e-6,
    moments as the module docstring says.  The gradients' global norm lands
    on both sides of max_grad_norm."""
    config = _config()
    nparams = _numpy_params(config, seed=1)
    kw = dict(weight_decay=decay, max_grad_norm=clip, mu_dtype=mu_dtype, nu_dtype="float32",
              fused=False)
    jopt = jax_make_optimizer(jax_schedule(1e-3, 10, 2), **kw)
    topt = make_optimizer(linear_warmup_linear_decay(1e-3, 10, 2), **kw)
    assert isinstance(topt, AdamWChain)
    rng = np.random.default_rng(2)

    def grads():
        scale = rng.choice([0.01, 1.0])
        return jax.tree.map(lambda p: (scale * rng.normal(size=p.shape)).astype(np.float32),
                            nparams)

    jstep = jax.jit(lambda p, g, s: jax_apply_gradients(jopt, p, g, s))
    jparams = jax.tree.map(jnp.asarray, nparams)
    jstate = jopt.init(jparams)
    jparams, jstate = jstep(jparams, jax.tree.map(jnp.asarray, grads()), jstate)
    tparams = from_jax(jax.device_get(jparams))
    tstate = opt_state_from_jax(jax.device_get(jstate))
    assert isinstance(tstate, AdamWChainState) and tstate.count == 1
    want_mu = torch.bfloat16 if mu_dtype == "bfloat16" else torch.float32
    assert all(leaf.dtype == want_mu for _, leaf in tree_leaves(tstate.mu))
    assert all(leaf.dtype == torch.float32 for _, leaf in tree_leaves(tstate.nu))
    for _ in range(4):
        g = grads()
        jparams, jstate = jstep(jparams, jax.tree.map(jnp.asarray, g), jstate)
        tparams, tstate = apply_gradients(topt, tparams, from_jax(g), tstate)
    jadam = jstate[-1][0] if clip is not None else jstate[0]
    assert tstate.count == int(jadam.count) == 5
    for got, ref in zip(_torch_leaves(tparams), _jax_leaves(jparams)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    for tree, jtree, bf16 in ((tstate.mu, jadam.mu, mu_dtype == "bfloat16"),
                              (tstate.nu, jadam.nu, False)):
        for got, ref in zip(_torch_leaves(tree), _jax_leaves(jtree)):
            if bf16:
                np.testing.assert_allclose(got, ref, rtol=1 / 128, atol=1e-3 * np.abs(ref).max())
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7 * np.abs(ref).max())


def test_chain_refuses_a_narrow_nu_naming_both_settings(monkeypatch):
    """The optax chain keeps nu in float32: a bf16 nu raises a ValueError
    that names adam_nu_dtype and fused_adamw (mic_tpu's names neither), also
    through MIC_TPU_MOMENT_DTYPE; the fused optimizer takes it."""
    lr = linear_warmup_linear_decay(1e-3, 10, 2)
    with pytest.raises(ValueError, match="adam_nu_dtype.*fused_adamw"):
        make_optimizer(lr, nu_dtype="bfloat16", fused=False)
    monkeypatch.setenv("MIC_TPU_MOMENT_DTYPE", "bfloat16")
    with pytest.raises(ValueError, match="adam_nu_dtype.*fused_adamw"):
        make_optimizer(lr, fused=False)
    assert not isinstance(make_optimizer(lr, fused=True), AdamWChain)
    with pytest.raises(ValueError, match="adam_nu_dtype.*fused_adamw"):
        _trainer(_config(), fused_adamw=False)  # TrainConfig's default nu is bfloat16


@pytest.mark.parametrize("spelling", ["torch", "name", "short", "numpy_type", "numpy_dtype",
                                      "none"])
def test_moment_dtypes_take_every_float32_spelling(spelling):
    """float32 as a torch dtype, a name, "f32", a numpy scalar type or dtype,
    or None: each is the params' own dtype (None); bfloat16 likewise as a
    torch dtype, a name or ml_dtypes' numpy dtype."""
    f32 = {"torch": torch.float32, "name": "float32", "short": "f32",
           "numpy_type": np.float32, "numpy_dtype": np.dtype("float32"), "none": None}[spelling]
    assert moment_dtypes(f32, f32) == (None, None)
    for bf16 in (torch.bfloat16, "bfloat16", np.dtype(ml_dtypes.bfloat16)):
        assert moment_dtypes(bf16, f32) == (torch.bfloat16, None)


def _jax_trainer_state(trainer, nparams):
    """mic_tpu's Trainer state from numpy params, on its 8-device mesh."""
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, nparams), trainer.optimizer,
                                 trainer.tc.seed, shadow_dtype=trainer._shadow_dtype)
    return jax.device_put(state, trainer.shardings)


def test_chain_trainer_matches_mic_tpu_trainer(tmp_path):
    """A tiny float32 model, fused_adamw=False (bf16 mu, f32 nu), clipping
    and weight decay on: eight Trainer.train_step calls in the port against
    eight of mic_tpu's Trainer.p_train_step (per-device batch 1 on its 8
    CPU devices, the same global batch of 8, repeated) from the same params:
    losses within a relative 1e-4, and falling."""
    config = _config()
    tc = dict(learning_rate=3e-3, warmup_steps=2, num_epochs=1, seed=0, label_smoothing=0.1,
              output_dir=str(tmp_path), fused_adamw=False, adam_nu_dtype="float32",
              weight_decay=0.01, max_grad_norm=1.0)
    jt = JaxTrainer(config, DataConfig(max_seq_length=8, decode_size=40),
                    TrainConfig(per_device_batch_size=8 // jax.device_count(), **tc))
    jt.build(steps_per_epoch=10)
    pt = _trainer(config, per_device_batch_size=8, **tc)
    nparams = _numpy_params(config, seed=3)
    jstate = _jax_trainer_state(jt, nparams)
    state = pt.init_state(from_jax(nparams))
    assert isinstance(state.opt_state, AdamWChainState)
    jlosses, losses = [], []
    batch = _batch(config, seed=20)  # one batch: the loss must fall
    for _ in range(8):
        jstate, jm = jt.p_train_step(jstate, jax.device_put(batch, jt.batch_shard))
        state, m = pt.train_step(state, pt.put_batch(batch))
        jlosses.append(float(jm["loss"]))
        losses.append(m["loss"].item())
    jt.ckpt.close()
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=0)
    assert losses[-1] < losses[0]


# -- remat "dots" -------------------------------------------------------------

def test_dots_grads_match_mic_tpu_dots():
    """remat="dots" (selective checkpointing that keeps the matrix
    products) against mic_tpu's Captioner(remat="dots") on the fused loss:
    loss within 1e-5, every gradient leaf within 1e-4 of its largest entry;
    and bit-equal to the port's own no-remat gradients."""
    config = _config()
    nparams = _numpy_params(config, seed=4)
    batch = _batch(config, b=4, seed=5)
    jmodel = JaxCaptioner(config, remat="dots")

    def jloss(params, batch):
        pixels = jax_maybe_preprocess(batch["pixel_values"], config.vision.image_size,
                                      jnp.float32)
        hidden = jmodel.decode_hidden(params, jmodel.encode(params, pixels),
                                      batch["decoder_input_ids"],
                                      batch["decoder_attention_mask"], None)
        return jax_fused_lm_loss(hidden, params["shared"]["embedding"],
                                 params["final_logits_bias"], batch["labels"],
                                 batch["decoder_attention_mask"], 0.1, 64)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, nparams),
                                                jax.tree.map(jnp.asarray, batch))
    out = {}
    for remat in ("none", "dots"):
        trainer = _trainer(config, remat=remat, flash_ce="0", ce_chunk=64)
        params = from_jax(nparams)
        for _, leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        dev = trainer.put_batch(batch)
        loss = trainer.compute_loss(params, maybe_preprocess(dev["pixel_values"], 32,
                                                             torch.float32), dev)
        leaves = [leaf for _, leaf in tree_leaves(params)]
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True,
                                                         materialize_grads=True))
    assert torch.equal(out["dots"][0], out["none"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["dots"][1], out["none"][1]))
    np.testing.assert_allclose(out["dots"][0].item(), float(jl), rtol=1e-5, atol=1e-5)
    for got, ref in zip(out["dots"][1], _jax_leaves(jg)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-6))


# -- profile_steps, the CLI, resume -------------------------------------------

@pytest.mark.parametrize("spec,want", [("2:4", (2, 4)), ("5", (5, 8)), ("0:1", (0, 1)),
                                       ("", None), (None, None)])
def test_profile_range_reads_mic_tpu_spec(spec, want):
    """"a:b" traces from before the step taken when a steps are done to
    after step b; a missing b is a + 3 (mic_tpu/train/trainer.py)."""
    assert profile_range(spec) == want


def _synthetic_tsv(tmp_path, n=24, size=40):
    from PIL import Image

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    words = ["cat", "dog", "red", "blue", "house", "tree", "runs", "sleeps"]
    rows = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
            img_dir / f"img_{i}.png")
        rows.append(f"img_{i}.png\t{' '.join(rng.choice(words, 4))}\thttp://x\t{LANGS[i % 4]}")
    (tmp_path / "train.tsv").write_text("\n".join(rows) + "\n")
    return str(tmp_path / "train.tsv"), str(img_dir)


def _losses(output_dir) -> dict:
    with open(os.path.join(output_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return {line["step"]: line["train/loss"] for line in lines if "train/loss" in line}


def test_cli_runs_the_three_options_and_profiling_changes_no_loss(tmp_path):
    """``python -m mic_tpu_torch.cli.train`` with --fused_adamw false (and
    --adam_nu_dtype float32), --remat dots and --profile_steps 2:4 on a
    synthetic TSV (a tiny bf16 model with dropout, 6 steps): a Chrome trace
    of steps 3 and 4 under <output_dir>/profile, and every logged loss
    equal to the same run's without --profile_steps."""
    from mic_tpu_torch.cli.train import main

    train_tsv, img_dir = _synthetic_tsv(tmp_path)
    cfg_path = tmp_path / "model.json"
    port_config.CaptionerConfig.tiny(
        decoder=port_config.DecoderConfig.tiny(vocab_size=64, dropout=0.1),
        dtype="bfloat16").to_json(str(cfg_path))
    runs = {}
    for name, extra in (("profiled", ["--profile_steps", "2:4"]), ("plain", [])):
        out = tmp_path / name
        main(["--train_file", train_tsv, "--images_dir", img_dir, "--output_dir", str(out),
              "--model_config", str(cfg_path), "--num_epochs", "1",
              "--per_device_batch_size", "4", "--learning_rate", "3e-3", "--warmup_steps", "2",
              "--logging_steps", "1", "--eval_steps", "1000", "--max_seq_length", "12",
              "--decode_size", "40", "--num_workers", "0", "--seed", "0", "--device", "cpu",
              "--fused_adamw", "false", "--adam_nu_dtype", "float32", "--remat", "dots",
              "--flash_ce", "dl", *extra])
        runs[name] = (out, _losses(out))
    profiled, plain = runs["profiled"][1], runs["plain"][1]
    assert sorted(profiled) == list(range(1, 7)) and all(math.isfinite(x) for x in plain.values())
    assert profiled == plain
    traces = os.listdir(runs["profiled"][0] / "profile")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(runs["profiled"][0] / "profile" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert not os.path.exists(runs["plain"][0] / "profile")


def _run_configs(data, output_dir, **tc):
    """A tiny bf16 model with dropout, fused_adamw=False, 6 steps of batch
    4, a save every 2 steps."""
    train_tsv, img_dir = data
    mc = CaptionerConfig(vision=VisionConfig.tiny(attention_dropout=0.1),
                         decoder=DecoderConfig.tiny(vocab_size=64, dropout=0.1), dtype="bfloat16")
    dc = DataConfig(train_file=train_tsv, images_dir=img_dir, max_seq_length=12,
                    decode_size=40, num_workers=0)
    base = dict(output_dir=str(output_dir), per_device_batch_size=4, num_epochs=1,
                learning_rate=3e-3, warmup_steps=2, logging_steps=1, eval_steps=1000,
                save_steps=2, seed=0, flash_ce="dl", fused_adamw=False,
                adam_nu_dtype="float32", max_grad_norm=1.0, weight_decay=0.01)
    base.update(tc)
    return _port(mc), _port(dc), _port(TrainConfig(**base))


def test_chain_resume_is_bit_equal(tmp_path):
    """Under the optax chain (bf16 mu, f32 nu), a run resumed from another
    run's step-4 checkpoint ends bit-equal to that uninterrupted run:
    params, both moments (as the chain's state), count, step, the
    generator and the losses of steps 5 and 6."""
    data = _synthetic_tsv(tmp_path)
    full = Trainer(*_run_configs(data, tmp_path / "a"), device="cpu").train()
    resumed = Trainer(*_run_configs(data, tmp_path / "b",
                                    resume_from=str(tmp_path / "a" / "checkpoints" / "4")),
                      device="cpu").train()
    assert isinstance(resumed.opt_state, AdamWChainState)
    assert resumed.step == full.step == 6 and resumed.opt_state.count == full.opt_state.count
    assert torch.equal(resumed.generator.get_state(), full.generator.get_state())
    for tree in ("params", "mu", "nu"):
        get = (lambda s: s.params) if tree == "params" else (lambda s: getattr(s.opt_state, tree))
        for (pa, a), (pb, b) in zip(tree_leaves(get(resumed)), tree_leaves(get(full))):
            assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), (tree, pa)
    la, lb = _losses(tmp_path / "a"), _losses(tmp_path / "b")
    assert sorted(lb) == [5, 6] and all(lb[s] == la[s] for s in (5, 6))

"""The port's checkpoints (mic_tpu_torch/io/checkpoint.py, train/state.py,
the Trainer's save and resume) against mic_tpu's on the CPU.

Save and load are bit-equal, dtypes included; a resumed run is bit-equal
to an uninterrupted one with dropout on (torch's generator state is part
of the checkpoint).  A mic_tpu train state written by mic_tpu's Orbax
manager and carried across through io/from_jax.py resumes in the port, and
its next step matches mic_tpu's next step within test_torch_train.py's
shadow-step tolerances.  JAX at "highest" precision (tests/conftest.py),
flash-CE in interpret mode, the port in its plain versions.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from mic_tpu.core.config import (
    CaptionerConfig, DataConfig, DecoderConfig, TrainConfig, VisionConfig,
)
from mic_tpu.io import checkpoint as jax_checkpoint
from mic_tpu.models.captioner import Captioner as JaxCaptioner
from mic_tpu.ops.fused_ce import fused_lm_loss as jax_fused_lm_loss
from mic_tpu.ops.image_prep import maybe_preprocess as jax_maybe_preprocess
from mic_tpu.train.fused_adamw import apply_gradients as jax_apply_gradients
from mic_tpu.train.schedule import linear_warmup_linear_decay as jax_schedule
from mic_tpu.train.shadow import ce_embedding as jax_ce_embedding
from mic_tpu.train.shadow import shadow_spec as jax_shadow_spec
from mic_tpu.train.shadow import shadowed_params as jax_shadowed_params
from mic_tpu.train.state import TrainState as JaxTrainState
from mic_tpu.train.state import make_optimizer as jax_make_optimizer
from mic_tpu_torch.core import config as port_config
from mic_tpu_torch.core.params import tree_leaves
from mic_tpu_torch.io.checkpoint import TrainCheckpointManager, load_params, save_params
from mic_tpu_torch.io.from_jax import from_jax, opt_state_from_jax
from mic_tpu_torch.models.captioner import Captioner
from mic_tpu_torch.train.fused_adamw import FusedAdamWState
from mic_tpu_torch.train.shadow import shadow_spec
from mic_tpu_torch.train.state import TrainState, checkpoint_tree, restore_state
from mic_tpu_torch.train.trainer import Trainer

LANGS = ["en_XX", "fr_XX", "es_XX", "de_DE"]


def _port(cfg):
    """The port's config class of the same name, from the same values."""
    return getattr(port_config, type(cfg).__name__).from_dict(cfg.to_dict())


def _bits(x) -> np.ndarray:
    """A leaf's bytes as unsigned integers of its width (torch or numpy)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]).numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.int16, 4: np.int32}[x.itemsize])


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _state_equal(a: TrainState, b: TrainState) -> bool:
    pairs = [(a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
             (a.opt_state.nu, b.opt_state.nu)]
    return (a.step == b.step and a.opt_state.count == b.opt_state.count
            and torch.equal(a.generator.get_state(), b.generator.get_state())
            and all(pa == pb and _same_bits(x, y)
                    for ta, tb in pairs
                    for (pa, x), (pb, y) in zip(tree_leaves(ta), tree_leaves(tb))))


# -- save_params / load_params ---------------------------------------------------


def test_params_round_trip_bit_equal_and_equal_to_orbax(tmp_path):
    """Every leaf (f32, bf16, int32, nested) comes back bit-equal with its
    dtype, and equal to mic_tpu's own Orbax round trip of the same tree."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(ml_dtypes.bfloat16),
                  "d": rng.integers(-5, 5, (2, 2)).astype(np.int32)},
            "e": {"f": {"g": rng.normal(size=(2, 3, 4)).astype(np.float32)}}}
    jax_checkpoint.save_params(str(tmp_path / "jax"), jax.tree.map(jnp.asarray, tree))
    orbax = jax_checkpoint.load_params(str(tmp_path / "jax"))
    save_params(str(tmp_path / "port"), from_jax(tree))
    got = load_params(str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == ["params.pt"]
    leaves = tree_leaves(got)
    assert [p for p, _ in leaves] == [tuple(k.key for k in p)
                                      for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
    for (path, leaf), ref, orb in zip(leaves, jax.tree.leaves(tree), jax.tree.leaves(orbax)):
        ref, orb = np.asarray(ref), np.asarray(orb)
        assert str(leaf.dtype).removeprefix("torch.") == ref.dtype.name == orb.dtype.name, path
        assert tuple(leaf.shape) == ref.shape == orb.shape, path
        assert np.array_equal(_bits(leaf), _bits(ref)), path
        assert np.array_equal(_bits(leaf), _bits(orb)), path


def test_orbax_directories_raise_a_named_value_error(tmp_path):
    """mic_tpu's Orbax trees (a model directory's params/, a train step)
    raise a ValueError that points at io/from_jax.py, not a bare
    file-not-found; an empty directory is file-not-found."""
    params = {"w": jnp.ones((2, 3)), "b": {"c": jnp.zeros((3,))}}
    jax_checkpoint.save_params(str(tmp_path / "m"), params)
    with pytest.raises(ValueError, match="from_jax"):
        load_params(str(tmp_path / "m"))
    config = CaptionerConfig.tiny()
    jmodel = JaxCaptioner(config)
    jmodel.save_pretrained(str(tmp_path / "model"), jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))))
    with pytest.raises(ValueError, match="Orbax.*from_jax"):
        Captioner.from_pretrained(str(tmp_path / "model"), device="cpu")
    manager = jax_checkpoint.TrainCheckpointManager(str(tmp_path / "run"))
    manager.save(3, JaxTrainState.create(params, optax.sgd(0.1), 0))
    manager.wait()
    manager.close()
    with pytest.raises(ValueError, match="from_jax"):
        TrainCheckpointManager(str(tmp_path / "run")).restore()
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path / "empty"))


# -- the manager -----------------------------------------------------------------


def _tree(step):
    gen = torch.Generator().manual_seed(step)
    w = torch.randn(4, 4, generator=gen)
    return {"params": {"w": w}, "opt_state": {"count": step, "mu": {"w": w.bfloat16()},
                                              "nu": {"w": (w * w).bfloat16()}},
            "step": step, "generator": gen.get_state()}


def test_rotation_keeps_save_total_limit(tmp_path):
    """max_to_keep=2 keeps steps 3 and 4 of four (tests/test_checkpoint.py
    for mic_tpu), restores the latest with its data position, writes a
    step once, creates nothing before the first save and leaves no
    temporary directory; a tree opened for restore is never rotated."""
    manager = TrainCheckpointManager(str(tmp_path), max_to_keep=2)
    assert manager.latest_step() is None and manager.restore() == (None, None)
    assert not (tmp_path / "checkpoints").exists()
    for step in (1, 2, 3, 4):
        assert manager.save(step, _tree(step), data_meta={"epoch": 0, "next_batch": step})
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["3", "4"]
    assert manager.latest_step() == 4
    tree, meta = manager.restore()
    assert meta == {"epoch": 0, "next_batch": 4}
    ref = _tree(4)
    assert tree["step"] == 4 and tree["opt_state"]["count"] == 4
    for got, want in ((tree["params"]["w"], ref["params"]["w"]),
                      (tree["opt_state"]["mu"]["w"], ref["opt_state"]["mu"]["w"]),
                      (tree["generator"], ref["generator"])):
        assert _same_bits(got, want)
    assert not manager.save(4, _tree(9))
    assert torch.equal(manager.restore(4)[0]["params"]["w"], ref["params"]["w"])
    opened, step = TrainCheckpointManager.open(str(tmp_path))
    assert step is None
    for step in (5, 6, 7):
        opened.save(step, _tree(step))
    assert opened.all_steps() == [3, 4, 5, 6, 7]
    assert opened.restore(7)[1] is None
    opened.wait()
    opened.close()


def test_save_without_data_meta_writes_in_the_background(tmp_path, monkeypatch):
    """A save without data_meta returns while its write is held (no step
    directory yet, the caller's tensors free to change in place), ``wait``
    returns once the directory is complete, and the restore is bit-equal to
    the state as it was at the save, and to mic_tpu's Orbax manager's
    background save of the same tree waited on alike.  A save with
    data_meta is complete when it returns."""
    from mic_tpu_torch.io import checkpoint

    release = threading.Event()
    real_write = checkpoint._write

    def held_write(obj, path):
        assert release.wait(timeout=60)
        real_write(obj, path)

    monkeypatch.setattr(checkpoint, "_write", held_write)
    manager = TrainCheckpointManager(str(tmp_path / "port"), max_to_keep=2)
    tree = _tree(5)
    want = {"w": tree["params"]["w"].clone(), "mu": tree["opt_state"]["mu"]["w"].clone()}
    assert manager.save(5, tree) is True
    assert not (tmp_path / "port" / "checkpoints" / "5").exists()
    tree["params"]["w"].add_(1.0)           # the optimizer's in-place update
    tree["opt_state"]["mu"]["w"].mul_(2.0)
    release.set()
    manager.wait()
    assert sorted(os.listdir(tmp_path / "port" / "checkpoints")) == ["5"]
    assert sorted(os.listdir(tmp_path / "port" / "checkpoints" / "5")) == ["state.pt"]
    got, meta = manager.restore(5)
    assert meta is None and got["step"] == 5
    assert _same_bits(got["params"]["w"], want["w"])
    assert _same_bits(got["opt_state"]["mu"]["w"], want["mu"])

    jax_manager = jax_checkpoint.TrainCheckpointManager(str(tmp_path / "jax"))
    jax_manager.save(5, {"w": jnp.asarray(want["w"].numpy())})
    jax_manager.wait()
    jax_got, _ = jax_manager.restore({"w": jnp.zeros((4, 4), jnp.float32)}, step=5)
    jax_manager.close()
    assert np.array_equal(_bits(got["params"]["w"]), _bits(np.asarray(jax_got["w"])))

    # a second save waits for the first; rotation runs after each write
    for step in (6, 7):
        manager.save(step, _tree(step))
    manager.close()
    assert manager.all_steps() == [6, 7]
    assert not [n for n in os.listdir(tmp_path / "port" / "checkpoints") if n.startswith(".")]
    assert manager.save(8, _tree(8), data_meta={"epoch": 1, "next_batch": 0})
    assert sorted(os.listdir(tmp_path / "port" / "checkpoints")) == ["7", "8"]


def test_a_failed_background_write_raises_at_the_next_call(tmp_path, monkeypatch):
    """A writer that fails leaves no directory and re-raises its error at
    the next ``wait``, ``save`` or ``close``, once each time it fails."""
    from mic_tpu_torch.io import checkpoint

    def failing_write(obj, path):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(checkpoint, "_write", failing_write)
    manager = TrainCheckpointManager(str(tmp_path))
    for call in (manager.wait, lambda: manager.save(4, _tree(4)), manager.close):
        assert manager.save(3, _tree(3)) is True
        with pytest.raises(OSError, match="No space left"):
            call()
        manager.wait()  # raised once
        assert manager.all_steps() == []
    assert os.listdir(tmp_path / "checkpoints") == []


# -- the trainer -----------------------------------------------------------------


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


def _run_configs(data, output_dir, **tc):
    """A tiny bf16 model with every dropout on, 6 steps of batch 4, a save
    every 2 steps, a loss logged every step."""
    train_tsv, img_dir = data
    mc = CaptionerConfig(vision=VisionConfig.tiny(attention_dropout=0.1),
                         decoder=DecoderConfig.tiny(vocab_size=64, dropout=0.1,
                                                    attention_dropout=0.1,
                                                    activation_dropout=0.1),
                         dtype="bfloat16")
    dc = DataConfig(train_file=train_tsv, images_dir=img_dir, max_seq_length=12,
                    decode_size=40, num_workers=0)
    base = dict(output_dir=str(output_dir), per_device_batch_size=4, num_epochs=1,
                learning_rate=3e-3, warmup_steps=2, logging_steps=1, eval_steps=1000,
                save_steps=2, seed=0, flash_ce="dl")
    base.update(tc)
    return _port(mc), _port(dc), _port(TrainConfig(**base))


def _losses(output_dir) -> dict:
    """{step: train loss} from metrics.jsonl (a later line of a step wins)."""
    with open(os.path.join(output_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return {line["step"]: line["train/loss"] for line in lines if "train/loss" in line}


@pytest.fixture(scope="module")
def run_a(tmp_path_factory):
    """One uninterrupted run: checkpoints 2, 4 and 6 and a model directory."""
    tmp = tmp_path_factory.mktemp("ckpt")
    data = _synthetic_tsv(tmp)
    out = tmp / "run_a"
    state = Trainer(*_run_configs(data, out), device="cpu").train()
    return {"data": data, "tmp": tmp, "out": str(out), "state": state, "losses": _losses(out)}


def _resumed(run_a, resume_from, name):
    trainer = Trainer(*_run_configs(run_a["data"], run_a["tmp"] / name, resume_from=resume_from),
                      device="cpu")
    loader, _ = trainer.make_loaders()
    trainer.build(len(loader))
    state = trainer.init_or_resume(loader)
    return state, loader.state()


def test_train_writes_checkpoints_and_a_model_directory(run_a):
    """Every save_steps a step directory with the position of the batch
    just trained on ({"epoch": 0, "next_batch": 2} after the second batch,
    as tests/test_train.py pins for mic_tpu), and model/ with config.json,
    params.pt and tokenizer.json that from_pretrained reloads bit-equal."""
    out = run_a["out"]
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["2", "4", "6"]
    for step in (2, 4, 6):
        with open(os.path.join(out, "checkpoints", str(step), "meta.json")) as f:
            assert json.load(f) == {"epoch": 0, "next_batch": step}
    assert sorted(os.listdir(os.path.join(out, "model"))) == [
        "config.json", "params.pt", "tokenizer.json"]
    model, params = Captioner.from_pretrained(os.path.join(out, "model"), device="cpu")
    assert model.config == _run_configs(run_a["data"], out)[0]
    assert all(pa == pb and _same_bits(x, y) for (pa, x), (pb, y) in
               zip(tree_leaves(params), tree_leaves(run_a["state"].params)))
    assert len(run_a["losses"]) == 6


@pytest.mark.parametrize("form", ["output_dir", "checkpoints", "step"])
def test_resume_from_accepts_each_path_form(run_a, form):
    """resume_from another run's output_dir, its checkpoints dir or a step
    dir restores that run's newest (or the named) step bit-equal."""
    path = {"output_dir": run_a["out"], "checkpoints": os.path.join(run_a["out"], "checkpoints"),
            "step": os.path.join(run_a["out"], "checkpoints", "6")}[form]
    state, position = _resumed(run_a, path, f"resume_{form}")
    assert state.step == 6 and position == {"epoch": 0, "next_batch": 6}
    assert _state_equal(state, run_a["state"])


def test_resume_from_a_bogus_path_raises(run_a):
    with pytest.raises(FileNotFoundError):
        _resumed(run_a, str(run_a["tmp"] / "nowhere"), "resume_bogus")
    with pytest.raises(FileNotFoundError):
        _resumed(run_a, os.path.join(run_a["out"], "checkpoints", "5"), "resume_bogus_step")


class _Stop(Exception):
    pass


def test_interrupted_run_resumes_bit_equal(run_a):
    """With dropout on: a run stopped after step 3 and started again in its
    own directory (it resumes from its step 2), and a new run resumed from
    run A's step 4, both end bit-equal to the uninterrupted run A: params,
    moments, count, step, the generator, and every loss logged after the
    resume."""
    out_b = run_a["tmp"] / "run_b"
    trainer = Trainer(*_run_configs(run_a["data"], out_b), device="cpu")
    step_fn = trainer.train_step

    def stop_at_4(state, batch):
        if state.step == 3:
            raise _Stop
        return step_fn(state, batch)

    trainer.train_step = stop_at_4
    with pytest.raises(_Stop):
        trainer.train()
    assert os.listdir(out_b / "checkpoints") == ["2"]
    state_b = Trainer(*_run_configs(run_a["data"], out_b), device="cpu").train()
    assert _state_equal(state_b, run_a["state"])
    assert _losses(out_b) == run_a["losses"]

    out_c = run_a["tmp"] / "run_c"
    state_c = Trainer(*_run_configs(run_a["data"], out_c,
                                    resume_from=os.path.join(run_a["out"], "checkpoints", "4")),
                      device="cpu").train()
    assert _state_equal(state_c, run_a["state"])
    losses_c = _losses(out_c)
    assert sorted(losses_c) == [5, 6]
    assert all(losses_c[s] == run_a["losses"][s] for s in (5, 6))
    assert sorted(os.listdir(out_c / "checkpoints")) == ["6"]


def test_moment_dtype_mismatch_warns_and_casts(run_a):
    """Run A stored bf16 moments; a trainer configured for float32 moments
    casts them (as mic_tpu does) and warns, naming a leaf, both dtypes and
    the settings."""
    mc, dc, tc = _run_configs(run_a["data"], run_a["tmp"] / "run_f32",
                              adam_mu_dtype="float32", adam_nu_dtype="float32")
    trainer = Trainer(mc, dc, tc, device="cpu")
    trainer.build(6)
    manager, _ = TrainCheckpointManager.open(run_a["out"])
    with pytest.warns(UserWarning) as record:
        state, _ = trainer.restore(manager, 2)
    messages = [str(w.message) for w in record]
    for name, setting in (("mu", "train.adam_mu_dtype"), ("nu", "train.adam_nu_dtype")):
        found = [m for m in messages if m.startswith(f"checkpoint {name} ")]
        assert len(found) == 1 and setting in found[0], messages
        assert "torch.bfloat16" in found[0] and "torch.float32" in found[0]
        assert "decoder/layers/fc1/kernel" in found[0]
    stored, _ = manager.restore(2)
    for (path, got), (_, want) in zip(tree_leaves(state.opt_state.mu),
                                      tree_leaves(stored["opt_state"]["mu"])):
        assert got.dtype == torch.float32 and torch.equal(got, want.float()), path


def test_a_generator_state_that_does_not_fit_raises(run_a):
    """A dropout generator state of another device's generator (a CUDA
    Philox state is 16 bytes, the CPU's 5056) is refused, not reseeded."""
    manager, _ = TrainCheckpointManager.open(run_a["out"])
    tree, _ = manager.restore(2)
    tree["generator"] = torch.zeros(16, dtype=torch.uint8)
    mc, dc, tc = _run_configs(run_a["data"], run_a["tmp"] / "unused")
    trainer = Trainer(mc, dc, tc, device="cpu")
    trainer.build(6)
    from mic_tpu_torch.models.captioner import init_params

    with pytest.raises(ValueError, match="generator"):
        restore_state(tree, init_params(mc, None, "meta"), trainer.generator)


# -- a mic_tpu train state, resumed in the port ---------------------------------------


def _numpy_params(config, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JaxCaptioner(config).init_params, jax.random.PRNGKey(0))

    def fill(path, leaf):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + scale * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(config, seed, b=4, t=8, size=40):
    rng = np.random.default_rng(seed)
    v = config.decoder.vocab_size
    mask = np.ones((b, t), np.int32)
    mask[1, t - 3:] = 0
    return {"pixel_values": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
            "labels": rng.integers(4, v, (b, t)).astype(np.int32),
            "decoder_input_ids": rng.integers(4, v, (b, t)).astype(np.int32),
            "decoder_attention_mask": mask}


def _jax_value_and_grad(config, tc):
    """value_and_grad of mic_tpu's compute_loss (trainer.py:164-198) on the
    fused route, no dropout key: fn(params, shadow, batch)."""
    model = JaxCaptioner(config)
    dtype = config.compute_dtype

    def loss_fn(params, shadow, batch):
        pixels = jax_maybe_preprocess(batch["pixel_values"], config.vision.image_size, dtype)
        mask = batch["decoder_attention_mask"]
        cp = jax_shadowed_params(params, shadow)
        hidden = model.decode_hidden(cp, model.encode(cp, pixels), batch["decoder_input_ids"],
                                     mask, None)
        return jax_fused_lm_loss(hidden, params["shared"]["embedding"],
                                 params["final_logits_bias"], batch["labels"], mask,
                                 tc.label_smoothing, tc.ce_chunk, jax_ce_embedding(shadow),
                                 mode=tc.flash_ce)

    return jax.jit(jax.value_and_grad(loss_fn))


class _Loader:
    """Takes the data position as CaptionLoader.set_state does."""
    position = None

    def set_state(self, meta):
        self.position = meta


def test_resume_of_a_mic_tpu_shadow_state_matches_mic_tpu(tmp_path):
    """mic_tpu's shadow train state after two steps (bf16, dl route, bf16
    moments, as test_torch_train.py::test_shadow_step_matches_jax builds
    it), written and restored by mic_tpu's Orbax manager, carried across by
    io/from_jax.py, saved by the port's manager and resumed by a port
    Trainer(resume_from=...): bit-equal to the carried state, the shadow a
    cast of the params, the data position handed to the loader; the next
    step's loss within 2e-3 relative of mic_tpu's next step, the params
    within 2e-2 relative and 2 x steps x lr absolute."""
    config = CaptionerConfig(vision=VisionConfig.tiny(),
                             decoder=DecoderConfig.tiny(vocab_size=97), dtype="bfloat16")
    dtype = config.compute_dtype
    nparams = _numpy_params(config, seed=6)
    jopt = jax_make_optimizer(jax_schedule(1e-3, 10, 1), mu_dtype="bfloat16",
                              nu_dtype="bfloat16")
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, nparams), jopt, 0,
                                  shadow_dtype=dtype)
    spec = jax_shadow_spec(jstate.params, dtype)
    jstep = jax.jit(lambda p, g, s: jax_apply_gradients(jopt, p, g, s, shadow_spec=spec,
                                                        shadow_dtype=dtype))
    tc = _port(TrainConfig(per_device_batch_size=4, learning_rate=1e-3, warmup_steps=1,
                           num_epochs=1, seed=0, label_smoothing=0.1, flash_ce="dl",
                           output_dir=str(tmp_path / "out"),
                           resume_from=str(tmp_path / "port" / "checkpoints" / "2")))
    jloss = _jax_value_and_grad(config, tc)

    def jax_step(state, seed):
        loss, grads = jloss(state.params, state.shadow, jax.tree.map(jnp.asarray,
                                                                     _batch(config, seed)))
        p, o, sh = jstep(state.params, grads, state.opt_state)
        return JaxTrainState(p, o, state.step + 1, state.dropout_rng, sh), loss

    for seed in (10, 11):
        jstate, _ = jax_step(jstate, seed)
    meta = {"epoch": 0, "next_batch": 2}
    jmanager = jax_checkpoint.TrainCheckpointManager(str(tmp_path / "jax"))
    jmanager.save(2, jstate._replace(shadow=None), data_meta=meta)
    jmanager.wait()
    restored, jmeta = jmanager.restore(jax.eval_shape(lambda: jstate._replace(shadow=None)),
                                       step=2)
    jmanager.close()
    host = jax.device_get(restored)
    carried = TrainState(from_jax(host.params), opt_state_from_jax(host.opt_state),
                         int(host.step), torch.Generator().manual_seed(0))
    assert TrainCheckpointManager(str(tmp_path / "port")).save(2, checkpoint_tree(carried), jmeta)

    trainer = Trainer(_port(config), _port(DataConfig(max_seq_length=8, decode_size=40)), tc,
                      device="cpu")
    trainer.build(10)
    loader = _Loader()
    state = trainer.init_or_resume(loader)
    assert loader.position == meta
    assert isinstance(state.opt_state, FusedAdamWState) and state.opt_state.count == 2
    assert _state_equal(state, carried)
    tspec = shadow_spec(state.params, torch.bfloat16)
    for (_, p), (_, s), (_, sh) in zip(tree_leaves(state.params), tree_leaves(state.shadow),
                                       tree_leaves(tspec)):
        assert torch.equal(s, p.detach().bfloat16()) if sh else s is p

    jstate, jl = jax_step(jstate, 12)
    state, metrics = trainer.train_step(state, trainer.put_batch(_batch(config, 12)))
    np.testing.assert_allclose(metrics["loss"].item(), float(jl), rtol=2e-3)
    assert state.step == int(jstate.step) == 3
    for (path, got), ref in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=2e-2,
                                   atol=2 * 3 * 1e-3, err_msg="/".join(path))

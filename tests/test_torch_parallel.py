"""The port's data-parallel and FSDP training (mic_tpu_torch/parallel/,
train/trainer.py under dp > 1) against mic_tpu on the CPU.

The sharding rules and the mesh arithmetic are mic_tpu's, held case by
case.  Multi-process runs start two gloo processes
(tools/torch_rank_worker.py, which imports no JAX; chip_smoke.py's phase
60 runs the same ranks on the card) on a ``file://`` rendezvous in
``tmp_path``, each with its own ``communicate`` timeout, and compare them
with the port's single process on the same global batch (ragged captions:
the two ranks hold different token counts) and with mic_tpu's Trainer on
its 8-device CPU mesh (tests/conftest.py).

Tolerances: the dp run sums the same gradients in another order, so its
losses are within 1e-6 relative of the single process's in float32 and
1e-4 in bf16 (the shadow rounds params a rounding apart to other bf16
values); against mic_tpu
within 1e-5 (test_torch_train.py's float32 tolerance).  Params after three
steps at lr 1e-3 are held by ``_near``: all but one entry in a hundred
within 1e-5 (3.4e-6 measured), every entry within 2 * steps * lr (Adam
scales the update of a leaf whose gradient is rounding noise to about lr
a step).  A checkpoint round trip is bit-equal.
"""

import json
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
from mic_tpu.models.captioner import Captioner as JaxCaptioner
from mic_tpu.parallel import distributed as jax_distributed
from mic_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mic_tpu.parallel.sharding import param_specs as jax_param_specs
from mic_tpu.train.state import TrainState as JaxTrainState
from mic_tpu.train.trainer import Trainer as JaxTrainer
from mic_tpu_torch.core import config as port_config
from mic_tpu_torch.core.params import tree_leaves
from mic_tpu_torch.io.checkpoint import TrainCheckpointManager
from mic_tpu_torch.io.from_jax import from_jax
from mic_tpu_torch.models.captioner import init_params
from mic_tpu_torch.nn.layers import keep_mask
from mic_tpu_torch.parallel import distributed
from mic_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from mic_tpu_torch.parallel.sharding import param_specs, tree_bytes
from mic_tpu_torch.train.trainer import GlobalBatchMasks, Trainer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
from torch_rank_worker import loss_gaps, param_gaps, spawn  # noqa: E402

LR = 1e-3


def _port(cfg):
    """The port's config class of the same name, from the same values."""
    return getattr(port_config, type(cfg).__name__).from_dict(cfg.to_dict())


# -- the rules -----------------------------------------------------------------


def _trees():
    return {"flagship": CaptionerConfig.clip_vit_b32_mbart50(), "tiny": CaptionerConfig.tiny()}


_JAX_SHAPES = {}


def _jax_shapes(name):
    if name not in _JAX_SHAPES:
        config = _trees()[name]
        _JAX_SHAPES[name] = jax.eval_shape(JaxCaptioner(config).init_params,
                                           jax.random.PRNGKey(0))
    return _JAX_SHAPES[name]


@pytest.mark.parametrize("fsdp", [1, 2, 4, 8])
@pytest.mark.parametrize("model_axis", [1, 2, 4])
@pytest.mark.parametrize("tree", ["flagship", "tiny"])
def test_param_specs_match_mic_tpu(tree, model_axis, fsdp):
    """mic_tpu's tests/test_sharding.py cases (:23 the rules, :36 the
    divisibility guard, :83 the FSDP axis) as one table: every leaf's spec
    equals mic_tpu's, on the same key paths, for model-axis sizes 1, 2 and 4
    and FSDP sizes 1, 2, 4 and 8."""
    ref = jax.tree_util.tree_leaves_with_path(
        jax_param_specs(_jax_shapes(tree), model_axis, fsdp_axis_size=fsdp),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = tree_leaves(param_specs(init_params(_port(_trees()[tree]), None, "meta"),
                                  model_axis, fsdp_axis_size=fsdp))
    assert [p for p, _ in got] == [tuple(k.key for k in p) for p, _ in ref]
    for (path, spec), (_, want) in zip(got, ref):
        assert spec == tuple(want), (path, spec, want)
    if tree == "flagship" and model_axis > 1:
        # V = 250054 splits over 2 model ranks, not over 4 (the guard)
        emb = dict(got)[("shared", "embedding")]
        assert (emb[:1] == (MODEL_AXIS,)) == (model_axis == 2), emb


# -- the bootstrap and the mesh --------------------------------------------------


def test_initialize_from_env_maps_mic_tpus_contract(monkeypatch):
    """Opt-in as mic_tpu's (False with neither variable, and no group made);
    MIC_TPU_COORDINATOR / NUM_PROCESSES / PROCESS_ID and torchrun's
    variables under MIC_TPU_DISTRIBUTED=1 become init_process_group's TCP
    address, world size and rank; NCCL unless gloo is asked for, each rank on
    cuda:LOCAL_RANK; a missing variable raises."""
    calls, jax_calls, devices = [], [], []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(distributed.torch.cuda, "set_device", devices.append)
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: jax_calls.append(kw))
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    monkeypatch.setattr(jax, "process_count", lambda: 1)
    for env in ({}, {"MIC_TPU_DISTRIBUTED": "0"}, {"MIC_TPU_NUM_PROCESSES": "2"}):
        assert distributed.initialize_from_env(env) is False
        assert jax_distributed.initialize_from_env(env) is False
    assert calls == [] and jax_calls == []

    env = {"MIC_TPU_COORDINATOR": "10.1.2.3:4567", "MIC_TPU_NUM_PROCESSES": "4",
           "MIC_TPU_PROCESS_ID": "2"}
    assert distributed.initialize_from_env(env, backend="gloo") is True
    assert jax_distributed.initialize_from_env(env) is True
    assert calls[-1] == ("gloo", {"init_method": "tcp://10.1.2.3:4567", "world_size": 4,
                                  "rank": 2})
    assert jax_calls[-1] == {"coordinator_address": "10.1.2.3:4567", "num_processes": 4,
                             "process_id": 2}
    assert devices == []

    assert distributed.initialize_from_env({**env, "LOCAL_RANK": "1"}) is True
    assert calls[-1][0] == "nccl" and devices == [torch.device("cuda", 1)]
    assert distributed.initialize_from_env({**env, "MIC_TPU_DIST_BACKEND": "gloo"}) is True
    assert calls[-1][0] == "gloo"

    torchrun = {"MIC_TPU_DISTRIBUTED": "1", "RANK": "3", "WORLD_SIZE": "8",
                "MASTER_ADDR": "host7", "MASTER_PORT": "29500", "LOCAL_RANK": "3"}
    assert distributed.initialize_from_env(torchrun) is True
    assert calls[-1] == ("nccl", {"init_method": "tcp://host7:29500", "world_size": 8,
                                  "rank": 3})
    assert devices[-1] == torch.device("cuda", 3)
    assert distributed.local_device(torchrun) == torch.device("cuda", 3)

    for bad in ({"MIC_TPU_COORDINATOR": "h:1", "MIC_TPU_NUM_PROCESSES": "2"},
                {"MIC_TPU_DISTRIBUTED": "1", "RANK": "0"}):
        with pytest.raises(ValueError):
            distributed.initialize_from_env(bad, backend="gloo")


@pytest.mark.parametrize("n,dp,tp", [(8, -1, 1), (8, -1, 2), (8, 4, 2), (8, 8, 1), (8, -1, 3),
                                     (8, 3, 2), (4, 2, 1), (1, -1, 1), (1, 2, 1), (2, -1, 1)])
def test_make_mesh_matches_mic_tpu(n, dp, tp):
    """The mesh's shape, or mic_tpu's error word for word, over n ranks."""
    devices = jax.devices()[:n]
    try:
        want = jax_make_mesh(dp, tp, devices=devices)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            make_mesh(dp, tp, world_size=n)
        assert str(got.value) == str(err)
        return
    mesh = make_mesh(dp, tp, world_size=n)
    assert mesh.shape == {DATA_AXIS: want.shape["data"], MODEL_AXIS: want.shape["model"]}
    assert mesh.size == want.size == n


def test_batch_shard_draws_the_global_batchs_masks():
    """A rank's GlobalBatchMasks(generator, rank, 2) gives its rows of the
    mask one process draws for the whole batch from the same generator, and
    so does the copy nn/stacked.py's recompute makes from its state."""
    full = keep_mask(torch.Generator().manual_seed(3), (8, 5, 7), 0.9, "cpu")
    for rank in range(2):
        rng = GlobalBatchMasks(torch.Generator().manual_seed(3), rank, 2)
        state = rng.get_state()
        assert torch.equal(keep_mask(rng, (4, 5, 7), 0.9, "cpu"), full[4 * rank:4 * rank + 4])
        again = rng.with_state(state)
        assert torch.equal(keep_mask(again, (4, 5, 7), 0.9, "cpu"), full[4 * rank:4 * rank + 4])
    assert torch.equal(keep_mask(torch.Generator().manual_seed(3), (8, 5, 7), 0.9, "cpu"), full)


def test_bucketed_all_reduce_keeps_order_shapes_and_dtypes(monkeypatch):
    """all_reduce_sum over a one-rank stand-in (the sum doubles each value)
    returns every tensor in order, shape and dtype, across bucket edges."""
    monkeypatch.setattr(distributed.dist, "all_reduce", lambda t, group=None: t.mul_(2))
    ts = [torch.arange(n, dtype=dt).reshape(shape) for n, dt, shape in
          ((6, torch.float32, (2, 3)), (4, torch.float32, (4,)), (5, torch.bfloat16, (5,)),
           (8, torch.float32, (2, 2, 2)))]
    out = distributed.all_reduce_sum(ts, bucket_bytes=30)
    for t, o in zip(ts, out):
        assert o.dtype == t.dtype and o.shape == t.shape and torch.equal(o, t * 2)


# -- two processes -----------------------------------------------------------------


def _model(dtype, dropout):
    return CaptionerConfig(
        vision=VisionConfig.tiny(attention_dropout=dropout),
        decoder=DecoderConfig.tiny(vocab_size=97, dropout=dropout, attention_dropout=dropout,
                                   activation_dropout=dropout),
        dtype=dtype)


def _numpy_params(config, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JaxCaptioner(config).init_params, jax.random.PRNGKey(0))

    def fill(path, leaf):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.05 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batches(config, n=3, b=8, t=8, seed=0):
    """Global batches of b rows with ragged captions: rank 0's rows (the
    first half) hold fewer tokens than rank 1's."""
    rng = np.random.default_rng(seed)
    v = config.decoder.vocab_size
    out = []
    for _ in range(n):
        mask = np.ones((b, t), np.int32)
        for row, keep in enumerate(rng.integers(2, t + 1, b // 2)):
            mask[row, keep:] = 0
        out.append({
            "pixel_values": rng.integers(0, 256, (b, 40, 40, 3), dtype=np.uint8),
            "labels": rng.integers(4, v, (b, t)).astype(np.int32),
            "decoder_input_ids": rng.integers(4, v, (b, t)).astype(np.int32),
            "decoder_attention_mask": mask,
        })
    return out


def _train_config(per_device, output_dir, **kw):
    base = dict(per_device_batch_size=per_device, learning_rate=LR, warmup_steps=1,
                num_epochs=1, seed=0, label_smoothing=0.1, max_grad_norm=1.0,
                weight_decay=0.01, output_dir=str(output_dir))
    base.update(kw)
    return TrainConfig(**base)


CASES = {
    # (dtype, dropout): float32 without dropout is held to mic_tpu too
    "f32": ("float32", 0.0),
    "bf16_dropout": ("bfloat16", 0.1),
}


def _spawn(tmp_path, cases, world=2, timeout=240):
    spawn({"init_method": f"file://{tmp_path / 'rendezvous'}", "backend": "gloo",
           "world": world, "device": "cpu", "cases": cases}, str(tmp_path), timeout,
          env={"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2", "XLA_FLAGS": ""})


def _single(config, tc, nparams, batches):
    """The port's one process on the whole global batches."""
    trainer = Trainer(_port(config), _port(DataConfig(max_seq_length=8, decode_size=40)),
                      _port(tc), device="cpu")
    trainer.build(10)
    state = trainer.init_state(from_jax(nparams))
    losses = []
    for batch in batches:
        state, metrics = trainer.train_step(state, trainer.put_batch(batch))
        losses.append(metrics["loss"].item())
    return losses, state


def _mic_tpu(config, tc, nparams, batches):
    """mic_tpu's Trainer on its 8-device mesh, one row a device."""
    trainer = JaxTrainer(config, DataConfig(max_seq_length=8, decode_size=40), tc)
    trainer.build(10)
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, nparams), trainer.optimizer, tc.seed,
                                 shadow_dtype=trainer._shadow_dtype)
    state = jax.device_put(state, trainer.shardings)
    losses = []
    for batch in batches:
        state, metrics = trainer.p_train_step(state, trainer._put_batch(batch))
        losses.append(float(metrics["loss"]))
    return losses, [np.asarray(x) for x in jax.tree.leaves(jax.device_get(state.params))]


def _near(got: dict, ref: dict, what, steps=3, close=1e-5):
    """tools/torch_rank_worker.py's comparison: every entry within 2 *
    steps * lr (Adam moves a param whose gradient is rounding noise by up
    to about lr a step whatever the noise's size), and but for the key
    biases all but one in a hundred of each leaf's entries within
    ``close``."""
    worst, far = param_gaps(got, ref, close)
    assert worst <= 2 * steps * LR, (what, worst)
    assert far <= 0.01, (what, far)


@pytest.mark.parametrize("layout", ["dp", "fsdp"])
def test_two_processes_match_one_process_and_mic_tpu(layout, tmp_path):
    """dp=2 (and dp=2 with fsdp) in two gloo processes, three steps on a tiny
    model with ragged captions, in float32 (dropout 0) and in bf16 with the
    shadow and every dropout at 0.1: the losses are the global batch's and
    the params equal the port's one process on the whole batch; in float32
    both also match mic_tpu's 8-device mesh run.  Under fsdp each rank holds
    about half the master and moment bytes, and a checkpoint written by the
    two ranks resumes bit-equal in two ranks and in one."""
    fsdp = layout == "fsdp"
    cases, refs = [], {}
    for name, (dtype, dropout) in CASES.items():
        config = _model(dtype, dropout)
        nparams = _numpy_params(config, seed=7)
        batches = _batches(config, seed=11)
        out = tmp_path / name
        out.mkdir()
        torch.save(from_jax(nparams), out / "params.pt")
        np.savez(out / "batches.npz", **{f"{k}_{i}": v for i, batch in enumerate(batches)
                                        for k, v in batch.items()})
        tc = _train_config(4, out / "run", fsdp=fsdp)
        cases.append({"model": config.to_dict(),
                      "data": DataConfig(max_seq_length=8, decode_size=40).to_dict(),
                      "train": tc.to_dict(), "params": str(out / "params.pt"),
                      "batches": str(out / "batches.npz"), "out": str(out),
                      "checkpoint": True})
        refs[name] = (config, nparams, batches)
    _spawn(tmp_path, cases)

    for name, (config, nparams, batches) in refs.items():
        out = tmp_path / name
        ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
        final = torch.load(out / "final.pt", weights_only=True)
        losses, state = _single(config, _train_config(8, tmp_path / f"one_{name}"), nparams,
                                batches)
        for r in ranks:
            assert r["ranks"] == 2
            # bf16: a shadow leaf one master rounding apart moves activations
            # by bf16 ulps from the second step on (1.4e-5 measured)
            assert max(loss_gaps(r["losses"], losses)) <= (1e-6 if name == "f32" else 1e-4)
            assert r["resumed_bit_equal"]
        for key, tree in (("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
            for (path, got), (_, want) in zip(tree_leaves(final[key]), tree_leaves(tree)):
                assert got.dtype == want.dtype and got.shape == want.shape, path
        # bf16 gradients differ by bf16 roundings (2^-8 relative), which Adam
        # passes on to the update: 1e-4 over 3 steps
        _near(dict(tree_leaves(final["params"])),
              {path: leaf.detach() for path, leaf in tree_leaves(state.params)}, name,
              close=1e-5 if name == "f32" else 1e-4)
        whole = tree_bytes({"params": state.params, "mu": state.opt_state.mu,
                            "nu": state.opt_state.nu})
        for r in ranks:
            share = r["state_bytes"] / whole
            assert (0.45 <= share <= 0.55) if fsdp else share == 1.0, share

        # the checkpoint the ranks wrote, resumed by one process: bit-equal
        # to the whole state rank 0 gathered
        one = Trainer(_port(config), _port(DataConfig(max_seq_length=8, decode_size=40)),
                      _port(_train_config(8, out / "run")), device="cpu")
        one.build(10)
        resumed, meta = one.restore(TrainCheckpointManager(str(out / "run")))
        assert meta == {"epoch": 0, "next_batch": 3} and resumed.step == 3
        for key, tree in (("params", resumed.params), ("mu", resumed.opt_state.mu),
                          ("nu", resumed.opt_state.nu)):
            for (path, got), (_, want) in zip(tree_leaves(tree), tree_leaves(final[key])):
                assert torch.equal(got.detach(), want), (key, path)

        if name == "f32":
            jlosses, jparams = _mic_tpu(config, _train_config(1, tmp_path / "jax", fsdp=fsdp),
                                        nparams, batches)
            assert max(loss_gaps(ranks[0]["losses"], jlosses)) <= 1e-5
            _near(dict(tree_leaves(final["params"])),
                  {path: torch.from_numpy(want)
                   for (path, _), want in zip(tree_leaves(final["params"]), jparams)},
                  "mic_tpu")


def _tsv(tmp_path, n=16, size=40):
    from PIL import Image

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    words = ["cat", "dog", "red", "blue", "house", "tree", "runs", "sleeps"]
    langs = ["en_XX", "fr_XX", "es_XX", "de_DE"]
    rows = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
            img_dir / f"img_{i}.png")
        rows.append(f"img_{i}.png\t{' '.join(rng.choice(words, rng.integers(2, 7)))}"
                    f"\thttp://x\t{langs[i % 2]}")
    (tmp_path / "train.tsv").write_text("\n".join(rows) + "\n")
    (tmp_path / "val.tsv").write_text("\n".join(rows[:5]) + "\n")
    return str(tmp_path / "train.tsv"), str(tmp_path / "val.tsv"), str(img_dir)


def _logged(output_dir):
    with open(os.path.join(output_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_process_train_loop_matches_one_process(tmp_path):
    """Trainer.train() under dp=2 with fsdp, through the loader (each rank its
    rows of every global batch), eval (5 rows a language padded to the
    global eval batch: a rank with padding only) and saves, against one
    process's train(): one metrics.jsonl (rank 0's) with the same train and
    eval losses (1e-5 relative), BLEU for each language, the same
    checkpoint steps and a model directory."""
    train_tsv, val_tsv, img_dir = _tsv(tmp_path)
    config = _model("bfloat16", 0.1)
    dc = DataConfig(train_file=train_tsv, validation_file=val_tsv, images_dir=img_dir,
                    max_seq_length=10, decode_size=40, num_workers=0)
    common = dict(num_epochs=1, logging_steps=1, eval_steps=2, save_steps=2, gen_eval=True)
    tc = _train_config(2, tmp_path / "dp", fsdp=True, eval_batch_size=4, **common)
    _spawn(tmp_path, [{"model": config.to_dict(), "data": dc.to_dict(), "train": tc.to_dict(),
                       "out": str(tmp_path), "loop": True}])
    one = _train_config(4, tmp_path / "one", eval_batch_size=8, **common)
    Trainer(_port(config), _port(dc), _port(one), device="cpu").train()
    got, want = _logged(tmp_path / "dp"), _logged(tmp_path / "one")
    assert [sorted(line) for line in got] == [sorted(line) for line in want]
    for a, b in zip(got, want):
        assert a["step"] == b["step"]
        for key in a:
            if key.endswith("loss") or key == "param_count_m":
                np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)
    assert any("eval/en_XX/bleu-4" in line and "eval/fr_XX/bleu-4" in line for line in got)
    assert (sorted(os.listdir(tmp_path / "dp" / "checkpoints"))
            == sorted(os.listdir(tmp_path / "one" / "checkpoints")) == ["2", "4"])
    assert os.path.exists(tmp_path / "dp" / "model" / "params.pt")


def test_train_batches_survive_an_eval_loader_between_them(tmp_path):
    """In-process decoding (num_workers=0): an eval loader iterated between
    two train batches (the trainer's mid-epoch eval) leaves the train
    loader's next batches as they are alone.  mic_tpu's loader reads the
    eval split's rows there (its per-process context is set once an epoch;
    ROADMAP §C); the loop test above runs into it."""
    from mic_tpu_torch.data.dataset import CaptionDataset
    from mic_tpu_torch.data.loader import CaptionLoader
    from mic_tpu_torch.data.tokenizer import load_tokenizer

    train_tsv, val_tsv, img_dir = _tsv(tmp_path)
    tok = load_tokenizer(None)
    train = CaptionLoader(CaptionDataset(train_tsv, img_dir), tok, 4, image_size=40,
                          max_length=10, seed=3)
    val = CaptionLoader(CaptionDataset(val_tsv, img_dir), tok, 2, image_size=40,
                        max_length=10, shuffle=False, drop_last=False)
    alone = list(train.epoch_iterator(epoch=0))
    train.next_batch = 0
    it = train.epoch_iterator(epoch=0)
    mixed = [next(it)]
    assert len(list(val.epoch_iterator(epoch=0))) == 3
    mixed += list(it)
    assert len(mixed) == len(alone) == 4
    for a, b in zip(mixed, alone):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_caption_batch_split_over_two_devices_matches_mic_tpu():
    """cli/caption.py's split (the CLIs' path with several cards) over two
    CPU devices: 3 images padded to 4, two parts generated in turn, put
    back in order: sequences equal to mic_tpu's one generate of the 3
    images, scores aside (the split returns sequences only)."""
    from mic_tpu.ops.image_prep import preprocess_images as jax_preprocess
    from mic_tpu_torch.cli.caption import generate_over_devices
    from mic_tpu_torch.ops.image_prep import preprocess_images
    from test_torch_captioner import _config, _images, _models

    jax_model, jparams, model, tparams = _models(_config(600), seed=2, scale=0.5)
    u8 = _images(n=3, seed=3)
    kw = dict(num_beams=4, max_length=10, forced_bos_token_id=7)
    ref = jax.jit(lambda p, x: jax_model.generate(p, x, **kw))(
        jparams, jax_preprocess(jnp.asarray(u8), 32))
    cpu = torch.device("cpu")
    got = generate_over_devices(model, [tparams, tparams], [cpu, cpu], u8,
                                lambda x: preprocess_images(x, 32), **kw)
    np.testing.assert_array_equal(got, np.asarray(ref.sequences))

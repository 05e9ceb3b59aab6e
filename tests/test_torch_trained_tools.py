"""The port's trained-model tools (tools/torch_validate_approx_decode.py,
tools/torch_ab_hard_synthetic.py, tools/torch_bench_trained.py) against
mic_tpu's own (tools/validate_approx_decode.py, tools/ab_hard_synthetic.py,
tools/bench_trained.py) on the CPU.

Both sides train a tiny float32 captioner with dropout 0 on
``make_synthetic.py --hard --n 64 --size 32`` data from the same init
(mic_tpu's, carried by io/from_jax.py); mic_tpu's Trainer is driven by the
JAX tool's own ``train_arm`` with its ``build_trainer`` swapped for one
that keeps the tool's data and train settings and takes the tiny model
(its per-device batch split over the 8 CPU devices of tests/conftest.py,
so that both sides take the same global batch).
JAX runs at "highest" matmul precision (tests/conftest.py).  Tolerances:
the logged losses within a relative 1e-4 (both sides round them to 4
decimals); recall and ids exact; captions token for token.
"""

import argparse
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.core.config import CaptionerConfig, DecoderConfig, VisionConfig
from mic_tpu.models.captioner import Captioner as JaxCaptioner
from mic_tpu.ops.fused_head import _bucket_topk_dense, _window_topk_dense
from mic_tpu.ops.image_prep import maybe_preprocess as jax_maybe_preprocess
from mic_tpu.train.trainer import Trainer as JaxTrainer
from mic_tpu_torch.core import config as port_config
from mic_tpu_torch.core.params import tree_leaves
from mic_tpu_torch.io.from_jax import from_jax
from mic_tpu_torch.models.captioner import Captioner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import ab_hard_synthetic as jax_ab  # noqa: E402
import torch_ab_hard_synthetic as port_ab  # noqa: E402
import torch_bench_trained as port_bench  # noqa: E402
import torch_validate_approx_decode as port_recall  # noqa: E402
import validate_approx_decode as jax_recall  # noqa: E402

LANGS = ("de_DE", "en_XX", "es_XX", "fr_XX")
STEPS = 8      # compared steps; an epoch is 7 (56 train rows in batches of 8)
EPOCHS = 20    # enough for the tiny model to end its captions


def _tiny(dtype="float32"):
    # V = 1280: the window select needs at least k = 9 windows of 128
    return CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1280, dropout=0.0),
        dtype=dtype,
    )


def _port(cfg):
    return port_config.CaptionerConfig.from_dict(cfg.to_dict())


def _args(data, out, **kw):
    base = dict(data=data, out=out, epochs=EPOCHS, batch=8, lr=0.02, log_every=1,
                num_workers=0, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def hard_data(tmp_path_factory):
    out = tmp_path_factory.mktemp("hard")
    subprocess.run([sys.executable, os.path.join(TOOLS, "data", "make_synthetic.py"),
                    "--out", str(out), "--n", "64", "--hard", "--size", "32"],
                   check=True, capture_output=True, timeout=120)
    return str(out)


@pytest.fixture(scope="module")
def trained(hard_data, tmp_path_factory):
    """Both tools' shadow-on arms on the tiny model from mic_tpu's init:
    {"jax": (trainer, state, losses, eval), "port": (...), "init": numpy
    params}."""
    root = tmp_path_factory.mktemp("arms")
    captured = {}
    tool_build = jax_ab.build_trainer

    def tiny_build(args, shadow):
        flagship = tool_build(args, shadow)  # the tool's own data and train settings
        # mic_tpu's batch is per device of its mesh (the 8 CPU devices here)
        tc = flagship.tc.replace(
            per_device_batch_size=args.batch // jax.device_count())
        trainer = JaxTrainer(_tiny(), flagship.dc, tc)
        resume = trainer.init_or_resume

        def init_or_resume(loader):
            state = resume(loader)
            # a copy: the train step donates the state's buffers
            captured["init"] = jax.tree.map(lambda x: np.array(x, copy=True), state.params)
            return state

        trainer.init_or_resume = init_or_resume
        return trainer

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_ab, "build_trainer", tiny_build)
    try:
        jt, js, _, jlosses, jeval = jax_ab.train_arm(_args(hard_data, str(root / "jax")), True)
    finally:
        mp.undo()
    jt.ckpt.close()
    pt, ps, p_eval_loaders, plosses, peval = port_ab.train_arm(
        _args(hard_data, str(root / "port")), True, model_config=_port(_tiny()),
        params=from_jax(captured["init"]))
    return {"jax": (jt, js, jlosses, jeval), "port": (pt, ps, plosses, peval),
            "port_eval_loaders": p_eval_loaders, "init": captured["init"], "root": root}


# -- per_step_recall ----------------------------------------------------------

def _near_tie_logits(n=48, v=4133, seed=0):
    """Seeded rows with planted ties and near-ties: pairs 512 apart (one
    bucket), 128-lane windows holding two of a row's leaders, values equal
    across buckets and windows, and gaps of one float32 ulp."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, v)).astype(np.float32)
    for i in range(n):
        top = np.float32(6.0 + rng.normal())
        ids = rng.choice(v - 1100, 5, replace=False)
        x[i, ids[0]] = top
        x[i, ids[0] + 512] = top                       # same bucket, equal
        x[i, ids[1]] = np.nextafter(top, np.float32(0))  # one ulp below
        x[i, ids[1] + 1] = x[i, ids[1]]                # same window, equal
        x[i, ids[2]] = top - np.float32(1e-6)
        x[i, ids[2] + 1024] = top - np.float32(1e-6)   # same bucket, near-tie
        x[i, ids[3]:ids[3] + 3] = top - np.float32(0.5)
    return x


def test_per_step_recall_matches_mic_tpu():
    logits = _near_tie_logits()
    got = port_recall.per_step_recall(torch.from_numpy(logits))
    want = jax_recall.per_step_recall(jnp.asarray(logits))
    assert port_recall.K_SLATE == jax_recall.K_SLATE == 9
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    assert got["approx_max_k"] == 1.0
    assert got["bucket(512)"] < 1.0 and got["window(128)"] < 1.0  # the planted collisions show


@pytest.mark.parametrize("k", [1, 9, 16])
def test_recall_selects_give_mic_tpu_ids(k):
    """The three selects per_step_recall compares give mic_tpu's ids,
    ties included."""
    from mic_tpu_torch.ops.fused_head import bucket_topk_dense, window_topk_dense
    from mic_tpu_torch.ops.topk_lse import top_k

    logits = _near_tie_logits(seed=k)
    t, j = torch.from_numpy(logits), jnp.asarray(logits)
    np.testing.assert_array_equal(top_k(t, k)[1].numpy(), np.asarray(jax.lax.top_k(j, k)[1]))
    np.testing.assert_array_equal(bucket_topk_dense(t, k, 512)[1].numpy(),
                                  np.asarray(_bucket_topk_dense(j, k, 512)[1]))
    np.testing.assert_array_equal(window_topk_dense(t, k)[1].numpy(),
                                  np.asarray(_window_topk_dense(j, k)[1]))


# -- training ---------------------------------------------------------------

def test_build_trainer_matches_the_jax_tool(tmp_path):
    """The flagship trainer of each tool: the same model, data and train
    configs (the port builds no params here)."""
    args = _args("data", str(tmp_path), epochs=15, batch=32, lr=3e-4, log_every=20)
    for shadow in (True, False):
        jt = jax_ab.build_trainer(args, shadow)
        pt = port_ab.build_trainer(args, shadow)
        for name in ("mc", "dc", "tc"):
            assert (json.loads(json.dumps(getattr(pt, name).to_dict()))
                    == json.loads(json.dumps(getattr(jt, name).to_dict()))), name
        assert pt.device == torch.device("cpu")
        jt.ckpt.close()


def test_train_arm_losses_match_mic_tpu(trained):
    _, _, jlosses, jeval = trained["jax"]
    _, _, plosses, peval = trained["port"]
    assert [s for s, _ in plosses] == [s for s, _ in jlosses] == list(range(1, EPOCHS * 7 + 1))
    got = np.array([loss for _, loss in plosses[:STEPS]])
    want = np.array([loss for _, loss in jlosses[:STEPS]])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert want[-1] < want[0]
    # both evals report mic_tpu's keys: loss and BLEU-1..4 per language
    assert sorted(peval) == sorted(jeval) == sorted(
        [f"{lang}/loss" for lang in LANGS]
        + [f"{lang}/bleu-{n}" for lang in LANGS for n in range(1, 5)])
    assert all(np.isfinite(v) for v in peval.values())


def test_train_arm_carries_the_init_and_trains_every_leaf(trained):
    """The port's arm started from mic_tpu's init and moved every leaf that
    a step's gradient reaches."""
    _, ps, _, _ = trained["port"]
    init = from_jax(trained["init"])
    moved = [not torch.equal(a.detach(), b) for (_, a), (_, b) in
             zip(tree_leaves(ps.params), tree_leaves(init))]
    assert sum(moved) >= len(moved) - 2  # the key biases' gradient is 0 under softmax


# -- decode A/B -------------------------------------------------------------

def test_decode_ab_reports_mic_tpu_keys_and_runs_each_select(trained, monkeypatch):
    from mic_tpu_torch.generate import search
    from mic_tpu_torch.ops import fused_head

    calls = []

    def spy(name, fn, width=None):
        def wrapped(x, *a, **kw):
            if width is None or x.shape[-1] == width:
                calls.append((name, os.environ.get("MIC_TPU_FUSED_HEAD"),
                              os.environ.get("MIC_TPU_FUSED_SELECT")))
            return fn(x, *a, **kw)
        return wrapped

    monkeypatch.setattr(fused_head, "bucket_topk_dense",
                        spy("bucket", fused_head.bucket_topk_dense))
    monkeypatch.setattr(fused_head, "window_topk_dense",
                        spy("window", fused_head.window_topk_dense))
    # the dense path's exact select: search's top_k over a whole vocab row
    # (its other calls rank the beams' few candidates)
    monkeypatch.setattr(search, "top_k", spy("dense", search.top_k, width=1280))
    pt, ps, _, _ = trained["port"]
    args = _args("unused", "unused")
    results, recall = port_ab.decode_ab(pt, ps, trained["port_eval_loaders"], args)

    assert sorted(results) == sorted(jax_ab.DECODE_MODES) == sorted(port_ab.DECODE_MODES)
    bleu = {f"{lang}/bleu-{n}" for lang in LANGS for n in range(1, 5)}
    assert set(results["exact"]) == bleu
    for mode in ("fused-bucket", "fused-window", "approx_max_k"):
        assert set(results[mode]) == bleu | {"seq_agreement_vs_exact", "n_diverging"}
    assert results["approx_max_k"]["seq_agreement_vs_exact"] == 1.0
    assert results["approx_max_k"]["n_diverging"] == 0
    assert sorted(recall) == ["approx_max_k", "bucket(512)", "window(128)"]
    assert recall["approx_max_k"] == 1.0
    # each mode's generates ran its own select, and only that one
    during = {(name, head, sel) for name, head, sel in calls if head is not None}
    assert during == {("dense", "0", None), ("bucket", "1", "bucket"), ("window", "1", "window")}
    # the environment is restored; the recall ran the bucket and window selects after it
    assert os.environ.get("MIC_TPU_FUSED_HEAD") is None
    assert {name for name, head, _ in calls if head is None} == {"bucket", "window"}


# -- serving with the trained weights -----------------------------------------

@pytest.fixture(scope="module")
def saved_model(trained):
    """mic_tpu's trained params carried to the port and saved as a model
    directory with the tokenizer -> (directory, mic_tpu model, its params)."""
    jt, js, _, _ = trained["jax"]
    directory = str(trained["root"] / "model")
    params = jax.device_get(js.params)
    Captioner(_port(_tiny())).save_pretrained(directory, from_jax(params))
    trained["port"][0].tokenizer.save(os.path.join(directory, "tokenizer.json"))
    return directory, jt.model, params


@pytest.mark.parametrize("early_stopping", [True, False])
def test_bench_captions_match_mic_tpu(saved_model, hard_data, early_stopping):
    """torch_bench_trained's generate on the saved model equals mic_tpu's
    bench_trained generate on the same params, token for token; the trained
    model ends its captions, so the port's search stops before
    max_length - 1 steps and mic_tpu's ends every caption as early."""
    from mic_tpu_torch.core.params import make_serving_params
    from mic_tpu_torch.data.tokenizer import load_tokenizer

    directory, jmodel, jparams = saved_model
    max_length = 32
    args = argparse.Namespace(max_length=max_length, num_beams=4, min_length=0,
                              no_early_stopping=not early_stopping, quant=None)
    model, params = Captioner.from_pretrained(directory, device="cpu")
    tok = load_tokenizer(os.path.join(directory, "tokenizer.json"))
    start = tok.lang_code_to_id["en_XX"]
    caption = port_bench.make_caption(model, make_serving_params(params, model.dtype), start,
                                      args)
    images = port_bench.load_pool(hard_data)[:6]
    out = caption(torch.from_numpy(images))

    @jax.jit
    def jax_caption(params, images_u8):
        pixels = jax_maybe_preprocess(images_u8, jmodel.config.vision.image_size, jmodel.dtype)
        return jmodel.generate(
            params, pixels, max_length=max_length, num_beams=4,
            decoder_start_token_id=jmodel.config.decoder.pad_token_id,
            forced_bos_token_id=start, early_stopping=early_stopping, quantize=None,
        ).sequences

    want = np.asarray(jax_caption(jparams, jnp.asarray(images)))
    got = out.sequences.numpy()
    np.testing.assert_array_equal(got, want)
    assert tok.batch_decode(got) == tok.batch_decode(want)
    eos = jmodel.config.decoder.eos_token_id
    ends = [int(np.flatnonzero(row == eos)[0]) for row in want]  # every caption ends
    assert max(ends) < max_length - 1
    assert out.steps < max_length - 1


def test_bench_main_prints_mic_tpu_keys(saved_model, hard_data, capsys):
    directory, _, _ = saved_model
    result = port_bench.main(["--model", directory, "--data", hard_data, "--batch", "4",
                              "--max_length", "24", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == result
    assert sorted(result) == ["batch", "quant", "sample_captions",
                              "trained_captions_per_sec_per_chip",
                              "trained_p50_latency_ms_batch1"]
    assert result["batch"] == 4 and result["quant"] is None
    assert len(result["sample_captions"]) == 4
    assert any(line.startswith("batch=4 decode steps per timed batch:") for line in lines)
    assert any(line.startswith("batch=1 decode steps per timed batch:") for line in lines)


def test_tools_default_to_the_card(hard_data, tmp_path, monkeypatch):
    """With no --device, both tools take the CUDA card; without one they
    raise, never falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ab.main(["--data", hard_data, "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_bench.main(["--model", str(tmp_path), "--data", hard_data])

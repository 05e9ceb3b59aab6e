"""The port's model directories and CLIs (Captioner.save_pretrained /
from_pretrained, mic_tpu_torch.cli.caption, mic_tpu_torch.cli.evaluate)
and its lazy top-level API against mic_tpu's on the CPU.

One tiny numpy param tree is saved by mic_tpu's save_pretrained (Orbax)
and, through io/from_jax.py, by the port's, each directory with the same
SimpleTokenizer; the fixture pattern of tests/test_cli.py.  Tokens, caption
lines and BLEU JSON must be equal.  JAX at "highest" precision
(tests/conftest.py), the port in its plain versions.
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

from mic_tpu.core.config import CaptionerConfig
from mic_tpu.data.tokenizer import SimpleTokenizer
from mic_tpu.models.captioner import Captioner as JaxCaptioner
from mic_tpu_torch.core.params import tree_leaves
from mic_tpu_torch.io.from_jax import from_jax
from mic_tpu_torch.models.captioner import Captioner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANGS = ["en_XX", "fr_XX", "es_XX", "de_DE"]
CAPS = ["a red cat", "a blue dog", "green tree house", "dog runs fast", "cat sleeps",
        "red house"]


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    """The same tiny model saved by both packages, a tokenizer beside each,
    and a 6-row TSV (language splits of 2, 2, 1, 1)."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("cli")
    config = CaptionerConfig.tiny()
    jmodel = JaxCaptioner(config)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map_with_path(
        lambda path, leaf: ((1.0 if path[-1].key == "scale" else 0.0)
                            + 0.2 * rng.normal(size=leaf.shape)).astype(np.float32), shapes)
    tok = SimpleTokenizer(vocab_size=64)
    tok.fit(CAPS)
    dirs = {"jax": str(tmp / "jax_model"), "port": str(tmp / "port_model")}
    jmodel.save_pretrained(dirs["jax"], jax.tree.map(jnp.asarray, tree))
    Captioner(_port_config(config)).save_pretrained(dirs["port"], from_jax(tree))
    for d in dirs.values():
        tok.save(f"{d}/tokenizer.json")
    img_dir = tmp / "imgs"
    img_dir.mkdir()
    rows = []
    for i, cap in enumerate(CAPS):
        Image.fromarray(rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)).save(
            img_dir / f"i{i}.png")
        rows.append(f"i{i}.png\t{cap}\thttp://x\t{LANGS[i % 4]}")
    (tmp / "val.tsv").write_text("\n".join(rows) + "\n")
    return {"tree": tree, "dirs": dirs, "tsv": str(tmp / "val.tsv"), "img_dir": str(img_dir),
            "tmp": tmp}


def _port_config(config):
    from mic_tpu_torch.core.config import CaptionerConfig as PortConfig

    return PortConfig.from_dict(config.to_dict())


def test_from_pretrained_beam_generate_matches_jax(cli_env):
    """The port's from_pretrained gives the saved params bit-equal and the
    config equal; its beam-4 generate the tokens of mic_tpu's
    from_pretrained + generate."""
    from mic_tpu.ops.image_prep import preprocess_images as jax_preprocess
    from mic_tpu_torch.ops.image_prep import preprocess_images

    model, params = Captioner.from_pretrained(cli_env["dirs"]["port"], device="cpu")
    jmodel, jparams = JaxCaptioner.from_pretrained(cli_env["dirs"]["jax"])
    assert model.config.to_dict() == jmodel.config.to_dict()
    for (path, got), ref in zip(tree_leaves(params), jax.tree.leaves(cli_env["tree"])):
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), ref), path
    u8 = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    kw = dict(max_length=8, num_beams=4, forced_bos_token_id=5)
    size = model.config.vision.image_size
    ref = jax.jit(lambda p, x: jmodel.generate(p, jax_preprocess(x, size, jmodel.dtype), **kw))(
        jparams, jnp.asarray(u8))
    out = model.generate(params, preprocess_images(torch.from_numpy(u8), size, model.dtype), **kw)
    np.testing.assert_array_equal(out.sequences.numpy(), np.asarray(ref.sequences))


def _lines(capsys):
    return [line for line in capsys.readouterr().out.splitlines() if line.strip()]


def test_caption_cli_matches_jax(cli_env, capsys):
    """The same ``path<TAB>caption`` lines as mic_tpu.cli.caption, one an
    image, the tokenizer taken from the model directory."""
    from mic_tpu.cli import caption as jax_caption
    from mic_tpu_torch.cli import caption

    imgs = [f"{cli_env['img_dir']}/i{i}.png" for i in range(3)]
    flags = ["--lang", "fr_XX", "--num_beams", "4", "--max_length", "8"]
    jax_caption.main(imgs + ["--model_dir", cli_env["dirs"]["jax"]] + flags)
    want = _lines(capsys)
    caption.main(imgs + ["--model_dir", cli_env["dirs"]["port"], "--device", "cpu"] + flags)
    got = _lines(capsys)
    assert len(got) == 3 and got == want
    assert all(line.startswith(path + "\t") for path, line in zip(imgs, got))


@pytest.mark.parametrize("convention", ["pad", "eos", "lang"])
def test_evaluate_cli_matches_jax(cli_env, convention):
    """The same per-language BLEU-1..4, returned and in --output_json, as
    mic_tpu.cli.evaluate under each --start_convention (batch 8: every
    language's batch is a ragged tail)."""
    from mic_tpu.cli import evaluate as jax_evaluate
    from mic_tpu_torch.cli import evaluate

    results = {}
    for name, main, extra in (("jax", jax_evaluate.main, []),
                              ("port", evaluate.main, ["--device", "cpu"])):
        out_json = str(cli_env["tmp"] / f"{name}_{convention}.json")
        returned = main([
            "--model_dir", cli_env["dirs"][name], "--tsv_path", cli_env["tsv"],
            "--images_dir", cli_env["img_dir"], "--batch_size", "8", "--num_beams", "4",
            "--max_length", "8", "--decode_size", "32", "--start_convention", convention,
            "--output_json", out_json] + extra)
        with open(out_json) as f:
            assert json.load(f) == returned
        results[name] = returned
    assert set(results["port"]) == set(LANGS)
    assert all(set(r) == {"bleu-1", "bleu-2", "bleu-3", "bleu-4"}
               for r in results["port"].values())
    assert results["port"] == results["jax"]


def test_clis_and_from_pretrained_default_to_the_card(cli_env, monkeypatch):
    """With no --device the CLIs (and with no device= from_pretrained) take
    the card; without one they raise, never a silent CPU run."""
    from mic_tpu_torch.cli import caption, evaluate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Captioner.from_pretrained(cli_env["dirs"]["port"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        caption.main([f"{cli_env['img_dir']}/i0.png", "--model_dir", cli_env["dirs"]["port"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--model_dir", cli_env["dirs"]["port"], "--tsv_path", cli_env["tsv"]])


def test_from_pretrained_refuses_what_is_not_ported(cli_env, tmp_path, monkeypatch):
    """What was refused before the HF formats were ported now loads: a
    directory holding the reference's fused HF checkpoint (mic_tpu's
    export_hf_fused of the fixture's tree) gives mic_tpu's params bit-equal,
    and a hub id resolves through huggingface_hub's snapshot_download
    (stubbed: no network) to the same.  What stays refused: a hub id that
    cannot be resolved raises mic_tpu's actionable FileNotFoundError, and a
    directory with an empty msgpack file a ValueError."""
    import types

    from mic_tpu.io.hf_export import export_hf_fused

    hf_dir = str(tmp_path / "hf")
    jmodel, jparams = JaxCaptioner.from_pretrained(cli_env["dirs"]["jax"])
    export_hf_fused(jparams, jmodel.config, hf_dir)
    model, params = Captioner.from_pretrained(hf_dir, device="cpu")
    assert model.config.decoder.vocab_size == jmodel.config.decoder.vocab_size
    for (path, got), ref in zip(tree_leaves(params), jax.tree.leaves(cli_env["tree"])):
        assert np.array_equal(got.numpy(), ref), path

    calls = []

    def snapshot_download(repo_id, revision=None, cache_dir=None, allow_patterns=None):
        calls.append((repo_id, revision))
        if repo_id != "someone/some-captioner":
            raise ConnectionError("offline")
        return hf_dir

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(snapshot_download=snapshot_download))
    _, hub_params = Captioner.from_pretrained("someone/some-captioner", device="cpu",
                                              revision="main")
    assert calls == [("someone/some-captioner", "main")]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(hub_params),
                                                           tree_leaves(params)))
    with pytest.raises(FileNotFoundError, match="offline"):
        Captioner.from_pretrained("someone/not-there", device="cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "flax_model.msgpack").write_bytes(b"")
    (empty / "config.json").write_text("{}")
    with pytest.raises(ValueError):
        Captioner.from_pretrained(str(empty), device="cpu")


def test_lazy_top_level_api():
    """mic_tpu_torch's _API names resolve to the port's classes (MBartSeq2Seq
    to the translator), an unknown name is an AttributeError, and
    ``import mic_tpu_torch`` imports no torch."""
    import mic_tpu_torch
    from mic_tpu_torch.core import config

    for name in ("CaptionerConfig", "DecoderConfig", "VisionConfig", "GenerationConfig"):
        assert getattr(mic_tpu_torch, name) is getattr(config, name)
    assert mic_tpu_torch.Captioner is Captioner
    assert set(mic_tpu_torch._API) <= set(dir(mic_tpu_torch))
    assert mic_tpu_torch.__version__
    from mic_tpu_torch.models.mbart_seq2seq import MBartSeq2Seq

    assert mic_tpu_torch.MBartSeq2Seq is MBartSeq2Seq
    with pytest.raises(AttributeError):
        mic_tpu_torch.NoSuchThing
    code = ("import sys, mic_tpu_torch\n"
            "assert 'torch' not in sys.modules\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr

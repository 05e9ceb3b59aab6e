"""The port's copies of mic_tpu's host modules against the originals.

mic_tpu_torch keeps its own copies of core/config.py, core/knobs.py,
data/{dataset,images,tokenizer,loader,native}.py, evals/bleu.py and
cli/train.py::build_configs, so that it imports nothing of mic_tpu.  Each
copy must give what the original gives on the same input: equal config
dicts, the same experimental registry and knob resolution, equal tokens,
equal loader batches (bit for bit) and equal BLEU.
"""

import numpy as np
import pytest

from mic_tpu.cli.train import build_configs as jax_build_configs
from mic_tpu.core import config as jax_config
from mic_tpu.core import knobs as jax_knobs
from mic_tpu.data.dataset import CaptionDataset as JaxCaptionDataset
from mic_tpu.data.loader import CaptionLoader as JaxCaptionLoader
from mic_tpu.data.loader import shift_tokens_right as jax_shift
from mic_tpu.data.tokenizer import SimpleTokenizer as JaxSimpleTokenizer
from mic_tpu.evals.bleu import bleu_1_to_4 as jax_bleu
from mic_tpu_torch.cli.train import build_configs
from mic_tpu_torch.core import config, knobs
from mic_tpu_torch.data.dataset import CaptionDataset
from mic_tpu_torch.data.loader import CaptionLoader, shift_tokens_right
from mic_tpu_torch.data.tokenizer import SimpleTokenizer
from mic_tpu_torch.evals.bleu import bleu_1_to_4

PRESETS = {
    "CaptionerConfig": ("clip_vit_b32_mbart50", "vit_b16_bart_large", "tiny", None),
    "VisionConfig": ("tiny", None),
    "DecoderConfig": ("tiny", None),
    "GenerationConfig": (None,),
    "DecodeConfig": (None,),
    "DataConfig": (None,),
    "TrainConfig": (None,),
}
CASES = [(cls, preset) for cls, presets in PRESETS.items() for preset in presets]


@pytest.mark.parametrize("cls,preset", CASES)
def test_config_preset_equals_mic_tpu(cls, preset):
    """Every preset (None: the class defaults) has mic_tpu's to_dict, and
    round-trips through from_dict into either package."""
    ours, theirs = getattr(config, cls), getattr(jax_config, cls)
    mine = ours() if preset is None else getattr(ours, preset)()
    ref = theirs() if preset is None else getattr(theirs, preset)()
    assert mine.to_dict() == ref.to_dict()
    assert ours.from_dict(ref.to_dict()).to_dict() == ref.to_dict()
    assert theirs.from_dict(mine.to_dict()).to_dict() == mine.to_dict()


def test_config_hf_import_and_overrides_equal_mic_tpu():
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "fixtures", "clip_vit_b32_mbart50_config.json")
    with open(path) as f:
        hf = json.load(f)
    assert (config.CaptionerConfig.from_hf_dict(hf).to_dict()
            == jax_config.CaptionerConfig.from_hf_dict(hf).to_dict())
    overrides = {"decoder.num_layers": "2", "dtype": "bfloat16", "generation.num_beams": "4",
                 "decode.fused_head": "0", "vision.layer_norm_eps": "1e-6"}
    mine = config.apply_dotted_overrides(config.CaptionerConfig.tiny(), overrides)
    ref = jax_config.apply_dotted_overrides(jax_config.CaptionerConfig.tiny(), overrides)
    assert mine.to_dict() == ref.to_dict()
    assert not hasattr(config.CaptionerConfig, "compute_dtype")


def test_cli_build_configs_equal_mic_tpu():
    argv = ["--train_file", "t.tsv", "--per_device_batch_size", "8", "--flash_ce", "dl",
            "--set", "model.decoder.num_layers=3", "--set", "model.dtype=bfloat16"]
    mine, ref = build_configs(argv), jax_build_configs(argv)
    for a, b in zip(mine[:3], ref[:3]):
        assert a.to_dict() == b.to_dict()
    assert mine[3].device is None


@pytest.mark.parametrize("env", ["", "fused_decode,pallas_topk", "segmented_topk=8192",
                                 "fused_decode,nonsense"])
def test_knobs_equal_mic_tpu(env, monkeypatch):
    """The same registry keys, and every name resolves (or raises) alike."""
    assert knobs.EXPERIMENTAL.keys() == jax_knobs.EXPERIMENTAL.keys()
    monkeypatch.setenv("MIC_TPU_EXPERIMENTAL", env)
    monkeypatch.setenv("MIC_TPU_FUSED_HEAD", "0")
    assert knobs.override("MIC_TPU_FUSED_HEAD", "auto") == jax_knobs.override(
        "MIC_TPU_FUSED_HEAD", "auto") == "0"
    assert knobs.override("MIC_TPU_UNSET_KNOB", "x") == "x"
    for name in sorted(jax_knobs.EXPERIMENTAL):
        if "nonsense" in env:
            with pytest.raises(KeyError):
                knobs.experimental(name)
            with pytest.raises(KeyError):
                jax_knobs.experimental(name)
        else:
            assert knobs.experimental(name) == jax_knobs.experimental(name)
    with pytest.raises(KeyError):
        knobs.experimental("not_registered")


CAPTIONS = ["a cat sleeps on a red chair", "Un chien court dans le parc.",
            "zwei Hunde spielen im Schnee", "un gato duerme, en la casa!", "a cat runs",
            "the blue house by the tree", "", "a a a a a a a a a a a a a a a a a a"]
LANGS = ["en_XX", "fr_XX", "de_DE", "es_XX", "en_XX", "en_XX", "fr_XX", "en_XX"]


def test_tokenizer_equals_mic_tpu():
    mine, ref = SimpleTokenizer(vocab_size=64), JaxSimpleTokenizer(vocab_size=64)
    mine.fit(CAPTIONS)
    ref.fit(CAPTIONS)
    ids, ref_ids = (t.encode_targets(CAPTIONS, LANGS, 12) for t in (mine, ref))
    assert ids.keys() == ref_ids.keys()
    for key in ids:
        np.testing.assert_array_equal(ids[key], ref_ids[key])
    tokens = ids["input_ids"]
    assert mine.batch_decode(tokens) == ref.batch_decode(tokens)
    np.testing.assert_array_equal(shift_tokens_right(tokens, 1), jax_shift(tokens, 1))


def _tsv(tmp_path, n=10, size=48):
    from PIL import Image

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        ext = "jpg" if i % 2 else "png"  # both host decode paths
        Image.fromarray(rng.integers(0, 255, (size + 7 * i, size, 3), dtype=np.uint8)).save(
            img_dir / f"img_{i}.{ext}")
        rows.append(f"img_{i}.{ext}\t{CAPTIONS[i % len(CAPTIONS)]}\thttp://x\t"
                    f"{LANGS[i % len(LANGS)]}")
    (tmp_path / "data.tsv").write_text("\n".join(rows) + "\n")
    return str(tmp_path / "data.tsv"), str(img_dir)


def test_loader_batches_equal_mic_tpu(tmp_path):
    tsv, img_dir = _tsv(tmp_path)
    batches = []
    for dataset_cls, loader_cls, tok_cls in ((CaptionDataset, CaptionLoader, SimpleTokenizer),
                                             (JaxCaptionDataset, JaxCaptionLoader,
                                              JaxSimpleTokenizer)):
        dataset = dataset_cls(tsv, img_dir)
        assert dataset.languages() == sorted(set(LANGS[:10] + LANGS[:2]))
        loader = loader_cls(dataset, tok_cls(vocab_size=64), 4, image_size=32, max_length=10,
                            shuffle=True, seed=3, num_workers=0)
        batches.append([dict(b) for b in loader.epoch_iterator(epoch=1)])
    mine, ref = batches
    assert len(mine) == len(ref) == 2
    for a, b in zip(mine, ref):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_bleu_equals_mic_tpu():
    preds = ["a cat sleeps on the chair", "un chien court", "the house", "a a a"]
    refs = ["a cat sleeps on a red chair", "Un chien court dans le parc.", "the blue house",
            "a cat"]
    for lang in ("en", "fr", "de", "es"):
        assert bleu_1_to_4(preds, refs, lang) == jax_bleu(preds, refs, lang)

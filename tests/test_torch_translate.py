"""tools/torch_translate.py (the port's dataset translator) against
tools/data/translate.py (mic_tpu's) on the CPU.

Both tools' ``main`` run on one download report and one weights directory
(``pytorch_model.bin``: an MBartForConditionalGeneration state dict of a
tiny seq2seq, written by tools/torch_hf_towers.py from numpy weights), in
float32, each with a stand-in tokenizer of HFTokenizer's surface and the
tiny DecoderConfig swapped in by monkeypatch for its ``HFTokenizer`` and
``DecoderConfig`` names (nothing in mic_tpu/ or tools/data/ is edited).
Their TSVs must be equal row for row: the same filter, shuffle, split,
language round-robin and, for every translated chunk, the same beam-4
sequences decoded the same way.
"""

import csv
import os
import sys

import jax
import numpy as np
import torch

import mic_tpu.core.config as jax_config_module
import mic_tpu.data.tokenizer as jax_tokenizer_module
import mic_tpu_torch.core.config as port_config_module
import mic_tpu_torch.data.tokenizer as port_tokenizer_module
from mic_tpu.core.config import DecoderConfig
from mic_tpu.models.mbart_seq2seq import MBartSeq2Seq as JaxSeq2Seq
from mic_tpu_torch.io.from_jax import from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, os.path.join(REPO, "tools", "data"))
import torch_hf_towers  # noqa: E402
import torch_translate  # noqa: E402
import translate as jax_translate  # noqa: E402

LANG_CODES = ("en_XX", "fr_XX", "es_XX", "de_DE")
WORDS = ("a", "cat", "dog", "red", "blue", "house", "tree", "runs", "sleeps", "on", "the",
         "grass", "under", "small", "big", "car", "street", "man", "woman", "child")
FIRST_WORD = 4 + len(LANG_CODES)  # ids: <s> 0, <pad> 1, </s> 2, <unk> 3, the codes, words


class _Encoder:
    """The callable ``tk`` of HFTokenizer: [source code] words... [</s>],
    cut and padded (id 1) to ``max_length``."""

    def __init__(self, codes):
        self.codes = codes
        self.src_lang = "en_XX"

    def __call__(self, texts, max_length, truncation, padding, return_tensors):
        assert truncation and padding == "max_length" and return_tensors == "np"
        ids = np.full((len(texts), max_length), 1, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for row, text in enumerate(texts):
            tokens = [FIRST_WORD + WORDS.index(w) for w in text.split()]
            tokens = ([self.codes[self.src_lang]] + tokens)[:max_length - 1] + [2]
            ids[row, :len(tokens)] = tokens
            mask[row, :len(tokens)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class _StandInTokenizer:
    """HFTokenizer's surface (``tk``, ``lang_code_to_id``,
    ``batch_decode``) over a word vocabulary; ``path`` is ignored."""

    def __init__(self, path=None):
        self.lang_code_to_id = {code: 4 + i for i, code in enumerate(LANG_CODES)}
        self.tk = _Encoder(self.lang_code_to_id)

    def batch_decode(self, seqs):
        names = {i: f"<{code}>" for code, i in self.lang_code_to_id.items()}
        names.update({FIRST_WORD + i: w for i, w in enumerate(WORDS)})
        return [" ".join(names.get(int(t), f"w{int(t)}") for t in row if int(t) > 3)
                for row in np.asarray(seqs)]


def _report(path, n=46, seed=0):
    """A download report: row_id, file, caption, url, status; a few rows
    failed (404) or have no file."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        status = "404" if i % 9 == 4 else "200"
        file = "" if i % 13 == 7 else f"img_{i}.jpg"
        caption = " ".join(rng.choice(WORDS, rng.integers(3, 9)))
        rows.append([str(i), file, caption, f"http://x/{i}", status])
    with open(path, "w", newline="") as f:
        csv.writer(f, delimiter="\t").writerows(rows)


def _weights_dir(path, config, seed=0, scale=0.3):
    """pytorch_model.bin of a seq2seq drawn from numpy (mic_tpu's layout),
    at a scale where captions differ (at 0.1 a random model repeats one
    token)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JaxSeq2Seq(config).init_params, jax.random.PRNGKey(0))

    def fill(keys, leaf):
        base = 1.0 if keys[-1].key == "scale" else 0.0
        return (base + scale * rng.normal(size=leaf.shape)).astype(np.float32)

    params = from_jax(jax.tree_util.tree_map_with_path(fill, shapes))
    os.makedirs(path)
    torch.save(torch_hf_towers.to_torch_mbart_seq2seq_state_dict(params),
               os.path.join(path, "pytorch_model.bin"))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


def test_translate_tsvs_equal_the_jax_tools(tmp_path, monkeypatch):
    config = DecoderConfig.tiny(vocab_size=64, max_position_embeddings=72)
    port_config = port_config_module.DecoderConfig.from_dict(config.to_dict())
    report, weights = str(tmp_path / "report.tsv"), str(tmp_path / "weights")
    _report(report)
    _weights_dir(weights, config)
    args = ["--report", report, "--weights", weights, "--tokenizer", "unused", "--chunk", "8",
            "--dtype", "float32"]

    monkeypatch.setattr(jax_config_module, "DecoderConfig", lambda: config)
    monkeypatch.setattr(jax_tokenizer_module, "HFTokenizer", _StandInTokenizer)
    jax_translate.main(args + ["--out", str(tmp_path / "jax")])
    monkeypatch.setattr(port_config_module, "DecoderConfig", lambda: port_config)
    monkeypatch.setattr(port_tokenizer_module, "HFTokenizer", _StandInTokenizer)
    torch_translate.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])

    # 38 rows of 46 have status 200 and a file: 3 in val, 35 in train
    for split, n in (("val", 3), ("train", 35)):
        ours = _rows(tmp_path / "port" / f"{split}_file.tsv")
        ref = _rows(tmp_path / "jax" / f"{split}_file.tsv")
        assert len(ours) == len(ref) == n
        for got, want in zip(ours, ref):
            assert got == want
    train = _rows(tmp_path / "port" / "train_file.tsv")
    assert [row[3] for row in train] == [LANG_CODES[(i // 8) % 4] for i in range(35)]
    # the translated chunks come from the model: each caption starts with
    # the language code forced at position 1
    translated = [row for row in train if row[3] != "en_XX"]
    assert len(translated) == 24
    assert all(row[1].split()[0] == f"<{row[3]}>" for row in translated)
    assert len({row[1] for row in translated}) > 12, [row[1] for row in translated]

#!/usr/bin/env python3
"""Build the 4-language caption TSVs by machine-translating English captions
with the port's mBART-50 seq2seq (models/mbart_seq2seq.py), on the CUDA
card unless ``--device cpu`` asks for the CPU: the counterpart of
tools/data/translate.py, step for step.

Rows of the download report with status 200 (up to ``--limit``) are
shuffled from ``--seed`` and split, ``--val_fraction`` of them into val.
Each split is cut into ``--chunk``-sized chunks; chunk c gets language
LANGS[c % 4].  English chunks pass through untranslated; the others are
padded to the chunk, encoded from en_XX at 64 tokens and translated by beam
4 (max_length 64) with their language code forced as BOS.  The beam search
decodes on the physical cache, so the self K/V are reordered through
ops/beam_permute.py's kernel twice a step.  Output TSVs have the training
pipeline's columns: image_file \\t caption \\t url \\t lang_id.

Requires a local mbart-50-one-to-many-mmt checkpoint directory (flax
msgpack, safetensors or a torch bin, read by the port's own readers) and
its tokenizer (``HFTokenizer``, which needs transformers).

  python tools/torch_translate.py --report images/downloaded_train_report.tsv \\
      --weights /path/to/mbart-50-one-to-many-mmt \\
      --tokenizer /path/to/tokenizer --out data/ --chunk 512 [--device cpu]

From Python, ``load_model`` takes the DecoderConfig (default the
published width) and ``translate_split`` any tokenizer object with
HFTokenizer's surface: ``tk`` (callable, with ``src_lang``),
``lang_code_to_id`` and ``batch_decode``.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LANGS = ("en_XX", "fr_XX", "es_XX", "de_DE")
SOURCE_LENGTH = 64  # tokens a source caption is padded or cut to


def load_model(weights_dir: str, dtype: str, device=None, config=None):
    """(MBartSeq2Seq at ``config``, default DecoderConfig(), beam 4 to
    length 64 in ``dtype``; its float32 params on ``device``, default the
    card) from an HF mBART directory."""
    from mic_tpu_torch.core.config import DecoderConfig, GenerationConfig
    from mic_tpu_torch.io.hf_import import (
        _fix_embeddings, _load_hf_weights_file, _unflatten_torch, from_hf_mbart_seq2seq_flax,
    )
    from mic_tpu_torch.models.mbart_seq2seq import MBartSeq2Seq

    blob = _load_hf_weights_file(weights_dir)
    tree = blob["tree"]
    if blob["format"] != "flax":
        tree = _fix_embeddings(_unflatten_torch(tree))
    params = from_hf_mbart_seq2seq_flax(tree, device)
    model = MBartSeq2Seq(config or DecoderConfig(), GenerationConfig(max_length=64, num_beams=4),
                         dtype=dtype)
    return model, params


def read_report(path: str, limit=None) -> list:
    """(file, caption, url) of the report's rows with status 200."""
    rows = []
    with open(path, newline="") as f:
        for row in csv.reader(f, delimiter="\t"):
            if len(row) >= 5 and row[1] and row[4] == "200":
                rows.append((row[1], row[2], row[3]))
            if limit is not None and len(rows) >= limit:
                break
    return rows


def split_rows(rows: list, seed: int, val_fraction: float) -> dict:
    """{"val": ..., "train": ...} of ``rows`` shuffled from ``seed``."""
    rows = list(rows)
    np.random.default_rng(seed).shuffle(rows)
    n_val = int(len(rows) * val_fraction)
    return {"val": rows[:n_val], "train": rows[n_val:]}


def translate_split(model, params, tokenizer, data: list, chunk: int, device,
                    log=print, split: str = ""):
    """Yield (file, caption, url, lang) of one split, chunk by chunk: each
    chunk in its language of the round-robin, English ones as they are."""
    for c in range(0, len(data), chunk):
        part = data[c:c + chunk]
        lang = LANGS[(c // chunk) % len(LANGS)]
        if lang == "en_XX":
            yield from ((file, cap, url, lang) for file, cap, url in part)
            continue
        tokenizer.tk.src_lang = "en_XX"
        caps = [cap for _, cap, _ in part]
        enc = tokenizer.tk(caps + [""] * (chunk - len(caps)), max_length=SOURCE_LENGTH,
                           truncation=True, padding="max_length", return_tensors="np")
        ids = torch.from_numpy(np.asarray(enc["input_ids"], np.int64)).to(device)
        mask = torch.from_numpy(np.asarray(enc["attention_mask"], np.int64)).to(device)
        seqs = model.generate(params, ids, mask,
                              forced_bos_token_id=tokenizer.lang_code_to_id[lang]).sequences
        texts = tokenizer.batch_decode(seqs.cpu().numpy()[:len(caps)])
        yield from ((file, text, url, lang) for (file, _, url), text in zip(part, texts))
        log(f"{split}: {c + len(part)}/{len(data)} ({lang})")


def write_tsv(path: str, rows) -> None:
    """``rows`` written as they come."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t")
        for row in rows:
            writer.writerow(row)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--report", required=True,
                        help="download report TSV: row_id\\tfile\\tcaption\\turl\\tstatus")
    parser.add_argument("--weights", required=True)
    parser.add_argument("--tokenizer", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--chunk", type=int, default=512)
    parser.add_argument("--val_fraction", type=float, default=0.1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    from mic_tpu_torch.core.params import resolve_device
    from mic_tpu_torch.data.tokenizer import HFTokenizer

    device = resolve_device(args.device)
    tokenizer = HFTokenizer(args.tokenizer)
    model, params = load_model(args.weights, args.dtype, device)
    splits = split_rows(read_report(args.report, args.limit), args.seed, args.val_fraction)
    os.makedirs(args.out, exist_ok=True)
    for split, data in splits.items():
        out_path = os.path.join(args.out, f"{split}_file.tsv")
        write_tsv(out_path, translate_split(model, params, tokenizer, data, args.chunk, device,
                                            split=split))
        print(f"wrote {out_path}")


if __name__ == "__main__":
    main()

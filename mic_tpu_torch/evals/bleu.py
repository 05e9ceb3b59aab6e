"""BLEU-1..4 in pure numpy/python, plus per-language word tokenization.

Reimplements the metric protocol of the reference (HF `datasets` BLEU — the
standard Papineni-2002 corpus BLEU with modified n-gram precision and brevity
penalty — at max_order 1..4, with per-language nltk word tokenization;
reference main.py:574-603, evaluation.py:142-164).  BLEU is plain n-gram
counting, so no dependency is needed; `word_tokenize` is a self-contained
regex tokenizer covering the 4 languages (nltk's punkt data is unavailable
offline).

The port's own copy of mic_tpu/evals/bleu.py.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Sequence


def word_tokenize(text: str, lang: str = "en") -> list[str]:
    """Language-robust word tokenizer: unicode words (incl. accents/umlauts)
    and punctuation as separate tokens."""
    del lang  # same rule works for en/fr/es/de
    return re.findall(r"\w+|[^\w\s]", text.lower(), flags=re.UNICODE)


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    predictions: Sequence[Sequence[str]],
    references: Sequence[Sequence[Sequence[str]]],
    max_order: int = 4,
    smooth: bool = False,
) -> dict:
    """predictions: list of token lists; references: list of lists of token
    lists. Returns {"bleu", "precisions", "brevity_penalty", ...}."""
    matches = [0] * max_order
    possible = [0] * max_order
    pred_len, ref_len = 0, 0
    for pred, refs in zip(predictions, references):
        pred_len += len(pred)
        ref_len += min((len(r) for r in refs), key=lambda l: (abs(l - len(pred)), l))
        for n in range(1, max_order + 1):
            pred_ngrams = _ngrams(pred, n)
            max_ref = Counter()
            for ref in refs:
                for ng, c in _ngrams(ref, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            overlap = {ng: min(c, max_ref[ng]) for ng, c in pred_ngrams.items()}
            matches[n - 1] += sum(overlap.values())
            possible[n - 1] += max(len(pred) - n + 1, 0)

    precisions = []
    for n in range(max_order):
        if smooth:
            precisions.append((matches[n] + 1.0) / (possible[n] + 1.0))
        else:
            precisions.append(matches[n] / possible[n] if possible[n] > 0 else 0.0)

    if min(precisions) > 0:
        geo_mean = math.exp(sum(math.log(p) for p in precisions) / max_order)
    else:
        geo_mean = 0.0
    ratio = pred_len / ref_len if ref_len > 0 else 0.0
    bp = 1.0 if ratio > 1.0 else (math.exp(1 - 1 / ratio) if ratio > 0 else 0.0)
    return {
        "bleu": geo_mean * bp,
        "precisions": precisions,
        "brevity_penalty": bp,
        "length_ratio": ratio,
        "translation_length": pred_len,
        "reference_length": ref_len,
    }


def bleu_1_to_4(
    pred_texts: Sequence[str], ref_texts: Sequence[str], lang: str = "en"
) -> dict[str, float]:
    """The reference's eval table: BLEU at max_order 1..4 over single-reference
    corpora (main.py:589-603)."""
    preds = [word_tokenize(t, lang) for t in pred_texts]
    refs = [[word_tokenize(t, lang)] for t in ref_texts]
    return {
        f"bleu-{n}": corpus_bleu(preds, refs, max_order=n)["bleu"]
        for n in range(1, 5)
    }

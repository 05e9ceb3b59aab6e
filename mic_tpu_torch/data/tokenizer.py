"""Tokenizer wrappers owning the mBART-50 language-code protocol.

Target encoding format (what the reference produces through
`tokenizer.as_target_tokenizer()` with `tgt_lang` set, main.py:501-511):

    [lang_code_id] token_ids... [eos] [pad]...

so generation started from `decoder_start_token_id = lang_code` (or forced-BOS
lang code after EOS start) reproduces the label distribution.  The framework
API owns `lang_code_to_id` (reference main.py:820, evaluation.py:81-93).

Two implementations:
- `HFTokenizer`: wraps a *local* HF MBart50 tokenizer directory (sentencepiece
  is not importable in this image and there is no network; pass a downloaded
  tokenizer dir).
- `SimpleTokenizer`: self-contained whitespace/word-hash tokenizer with the
  same special-token layout — used by tests, synthetic training and anywhere
  a real sentencepiece model is unavailable.

The port's own copy of mic_tpu/data/tokenizer.py.
"""

from __future__ import annotations

import json
import os
import re
from typing import Sequence

import numpy as np

DEFAULT_LANG_CODES = ("en_XX", "fr_XX", "es_XX", "de_DE")


class TokenizerBase:
    pad_token_id: int
    eos_token_id: int
    lang_code_to_id: dict

    def encode_targets(
        self, texts: Sequence[str], langs: Sequence[str], max_length: int
    ) -> dict:
        raise NotImplementedError

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        raise NotImplementedError

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch_ids]


class HFTokenizer(TokenizerBase):
    """MBart50TokenizerFast from a local directory."""

    def __init__(self, path: str):
        from transformers import MBart50TokenizerFast

        self.tk = MBart50TokenizerFast.from_pretrained(path)
        self.pad_token_id = self.tk.pad_token_id
        self.eos_token_id = self.tk.eos_token_id
        self.lang_code_to_id = {
            code: self.tk.convert_tokens_to_ids(code)
            for code in self.tk.lang_code_to_id
        } if hasattr(self.tk, "lang_code_to_id") else {
            code: self.tk.convert_tokens_to_ids(code) for code in DEFAULT_LANG_CODES
        }

    def encode_targets(self, texts, langs, max_length):
        ids = np.full((len(texts), max_length), self.pad_token_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, (text, lang) in enumerate(zip(texts, langs)):
            self.tk.tgt_lang = lang
            enc = self.tk(
                text_target=str(text), max_length=max_length,
                truncation=True, padding="max_length", return_tensors="np",
            )
            ids[i] = enc["input_ids"][0]
            mask[i] = enc["attention_mask"][0]
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids, skip_special_tokens=True):
        return self.tk.decode(list(map(int, ids)), skip_special_tokens=skip_special_tokens)


class SimpleTokenizer(TokenizerBase):
    """Word-level tokenizer with mBART-style specials; vocab grows on demand
    (or is frozen after `freeze()` / load). Round-trips text for BLEU tests."""

    SPECIALS = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}

    def __init__(self, vocab_size: int = 8192, lang_codes=DEFAULT_LANG_CODES):
        self.vocab_size = vocab_size
        self.pad_token_id = 1
        self.eos_token_id = 2
        self.unk_token_id = 3
        self.lang_code_to_id = {
            code: 4 + i for i, code in enumerate(lang_codes)
        }
        self._word_to_id: dict[str, int] = {}
        self._id_to_word: dict[int, str] = {}
        self._next_id = 4 + len(lang_codes)
        self._frozen = False
        self._special_ids = set(self.SPECIALS.values()) | set(
            self.lang_code_to_id.values()
        )

    def _words(self, text: str) -> list[str]:
        return re.findall(r"\w+|[^\w\s]", str(text).lower())

    def _word_id(self, w: str) -> int:
        if w in self._word_to_id:
            return self._word_to_id[w]
        if self._frozen or self._next_id >= self.vocab_size:
            return self.unk_token_id
        wid = self._next_id
        self._next_id += 1
        self._word_to_id[w] = wid
        self._id_to_word[wid] = w
        return wid

    def freeze(self):
        self._frozen = True

    @property
    def needs_fit(self) -> bool:
        """True until the vocab is frozen. An UNFROZEN SimpleTokenizer must
        never be handed to multiprocessing workers: each worker would grow
        its own pickled copy in batch-arrival order, silently assigning
        DIFFERENT ids to the same word across workers (and vs the main
        process that later decodes) — the model then trains on scrambled
        targets. CaptionLoader fits+freezes it deterministically up front."""
        return not self._frozen

    def fit(self, texts) -> None:
        """Populate the vocab from an iterable of texts in order, then
        freeze. Unseen words at encode time map to <unk> afterwards."""
        for t in texts:
            for w in self._words(t):
                self._word_id(w)
        self.freeze()

    def encode_targets(self, texts, langs, max_length):
        ids = np.full((len(texts), max_length), self.pad_token_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, (text, lang) in enumerate(zip(texts, langs)):
            toks = [self.lang_code_to_id[lang]]
            toks += [self._word_id(w) for w in self._words(text)]
            toks = toks[: max_length - 1] + [self.eos_token_id]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids, skip_special_tokens=True):
        words = []
        for t in map(int, ids):
            if skip_special_tokens and (t in self._special_ids or t == self.unk_token_id):
                continue
            words.append(self._id_to_word.get(t, "<unk>"))
        return " ".join(words)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "vocab_size": self.vocab_size,
                    "lang_codes": list(self.lang_code_to_id),
                    "words": self._word_to_id,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "SimpleTokenizer":
        with open(path) as f:
            blob = json.load(f)
        tk = cls(blob["vocab_size"], tuple(blob["lang_codes"]))
        for w, wid in blob["words"].items():
            tk._word_to_id[w] = int(wid)
            tk._id_to_word[int(wid)] = w
        tk._next_id = max(tk._id_to_word, default=tk._next_id - 1) + 1
        tk.freeze()
        return tk


def load_tokenizer(path_or_none: str | None, **kw) -> TokenizerBase:
    """Factory: an HF tokenizer dir, a SimpleTokenizer json, or a fresh
    SimpleTokenizer when nothing is given."""
    if path_or_none is None:
        return SimpleTokenizer(**kw)
    if os.path.isdir(path_or_none):
        return HFTokenizer(path_or_none)
    return SimpleTokenizer.load(path_or_none)

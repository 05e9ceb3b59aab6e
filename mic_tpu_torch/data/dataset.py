"""TSV caption datasets (reference surface: ImageTextDataset, main.py:182-245).

Row format (produced by tools/data/translate.py, same columns as the
reference's CC12M pipeline, data/CC12M_translate_MBart50.py:121-133):

    image_file \t caption \t url \t lang_id

Rows whose image file is missing are dropped at construction (reference
main.py:208-212).  `split_by_language` builds the per-language eval sets the
reference creates at main.py:457-465.

The port's own copy of mic_tpu/data/dataset.py.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class Example:
    image_path: str
    caption: str
    lang: str


class CaptionDataset:
    def __init__(
        self,
        tsv_path: str,
        images_dir: str = "",
        lang_codes: Optional[Sequence[str]] = None,
        check_exists: bool = True,
        max_examples: Optional[int] = None,
    ):
        self.examples: list[Example] = []
        with open(tsv_path, newline="") as f:
            reader = csv.reader(f, delimiter="\t")
            for row in reader:
                if len(row) < 2:
                    continue
                image_file, caption = row[0], row[1]
                lang = row[3] if len(row) > 3 else "en_XX"
                if lang_codes is not None and lang not in lang_codes:
                    continue
                path = os.path.join(images_dir, image_file)
                if check_exists and not os.path.exists(path):
                    continue
                self.examples.append(Example(path, caption, lang))
                if max_examples is not None and len(self.examples) >= max_examples:
                    break

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, idx: int) -> Example:
        return self.examples[idx]

    def split_by_language(self) -> dict[str, "CaptionDataset"]:
        out: dict[str, CaptionDataset] = {}
        for ex in self.examples:
            if ex.lang not in out:
                sub = CaptionDataset.__new__(CaptionDataset)
                sub.examples = []
                out[ex.lang] = sub
            out[ex.lang].examples.append(ex)
        return out

    def languages(self) -> list[str]:
        return sorted({ex.lang for ex in self.examples})

"""Torch-free input pipeline: multiprocess decode + tokenized numpy batches.

Replaces the reference's `torch.utils.data.DataLoader(num_workers=64,
collate_fn=...)` (main.py:493-571) — its documented throughput/RAM bottleneck
(README.md:103) — with a spawn-based worker pool (spawn, not fork: the parent
holds live JAX/TPU threads — see _get_pool) that:

- materializes each batch fully inside a worker (image decode to fixed-size
  uint8 crops + per-example target tokenization), so the parent process only
  concatenates ready arrays;
- keeps images uint8 end-to-end on the host; normalization/resize runs
  on-device inside the jitted step (mic_tpu/ops/image_prep.py);
- shuffles deterministically per epoch (seed + epoch) and is RESUMABLE:
  `state()` / `set_state()` capture (epoch, next_batch) so checkpoint restore
  continues mid-epoch (the reference could not resume its data position,
  SURVEY.md §3.4).

Batch layout (keys per reference main.py:526-543, with the pad-prepend
decoder shift applied here, not in the step):
  pixel_values (B,S,S,3) uint8 | labels (B,T) | decoder_attention_mask (B,T)
  | decoder_input_ids (B,T) | lang (B,) int32 language index

The port's own copy of mic_tpu/data/loader.py.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from mic_tpu_torch.data.dataset import CaptionDataset
from mic_tpu_torch.data.images import load_image_safe
from mic_tpu_torch.data.tokenizer import TokenizerBase


def shift_tokens_right(input_ids: np.ndarray, pad_token_id: int) -> np.ndarray:
    """Pad-prepend decoder shift (reference main.py:362-369). Defined here in
    pure numpy so spawn workers never import the JAX-heavy training stack
    (worker boot drops from seconds to milliseconds)."""
    shifted = np.zeros_like(input_ids)
    shifted[:, 1:] = input_ids[:, :-1]
    shifted[:, 0] = pad_token_id
    return shifted

_WORKER = {}


def _auto_workers() -> int:
    """Decode-pool autosizing (num_workers=-1): one spawn worker per core
    beyond two reserved for the trainer's host thread (device dispatch) and
    IO, capped at 32 (CC12M sizing, PERFORMANCE.md loader section).  On
    <=2-core hosts the pool is skipped entirely — in-process decode measured
    FASTER than a 1-worker spawn pool there (399 vs lower, bench_loader)."""
    cores = os.cpu_count() or 1
    return 0 if cores <= 2 else min(32, cores - 2)


def _init_worker(dataset, tokenizer, image_size, max_length, lang_codes):
    _WORKER.update(
        dataset=dataset, tokenizer=tokenizer, image_size=image_size,
        max_length=max_length, lang_codes=list(lang_codes),
    )


def _make_batch(indices: Sequence[int]) -> dict:
    ds: CaptionDataset = _WORKER["dataset"]
    tk: TokenizerBase = _WORKER["tokenizer"]
    size, max_len = _WORKER["image_size"], _WORKER["max_length"]
    lang_codes = _WORKER["lang_codes"]

    images, texts, langs = [], [], []
    for i in indices:
        ex = ds[i]
        img = load_image_safe(ex.image_path, size)
        if img is None:  # unreadable file: substitute zeros, keep batch static
            img = np.zeros((size, size, 3), np.uint8)
        images.append(img)
        texts.append(ex.caption)
        langs.append(ex.lang)

    enc = tk.encode_targets(texts, langs, max_len)
    return {
        "pixel_values": np.stack(images),
        "labels": enc["input_ids"],
        "decoder_attention_mask": enc["attention_mask"],
        "decoder_input_ids": shift_tokens_right(enc["input_ids"], tk.pad_token_id),
        "lang": np.asarray(
            [lang_codes.index(l) if l in lang_codes else -1 for l in langs], np.int32
        ),
    }


class CaptionLoader:
    def __init__(
        self,
        dataset: CaptionDataset,
        tokenizer: TokenizerBase,
        batch_size: int,
        *,
        image_size: int = 256,
        max_length: int = 64,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 42,
        num_workers: int = 0,
        prefetch: int = 2,
        lang_codes: Sequence[str] = ("en_XX", "fr_XX", "es_XX", "de_DE"),
        process_shard: tuple = (0, 1),
    ):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.image_size = image_size
        self.max_length = max_length
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = _auto_workers() if num_workers < 0 else num_workers
        self.prefetch = prefetch
        self.lang_codes = tuple(lang_codes)
        # multi-host: every process builds the SAME global batch order (same
        # seed) and takes its contiguous slice of each batch; the trainer
        # reassembles global arrays with make_array_from_process_local_data
        self.process_shard = tuple(process_shard)
        self.epoch = 0
        self.next_batch = 0
        self._pool = None
        if getattr(tokenizer, "needs_fit", False):
            # Freeze an on-demand vocab DETERMINISTICALLY (dataset order)
            # before anything is tokenized. Without this, each spawn worker
            # grows its own pickled tokenizer copy in batch-arrival order and
            # the same word gets different ids across workers (and vs the
            # main process that decodes) — scrambled training targets.
            tokenizer.fit(
                dataset[i].caption for i in range(len(dataset))
            )

    # -- resumable position --------------------------------------------------

    def state(self) -> dict:
        return {"epoch": self.epoch, "next_batch": self.next_batch}

    def set_state(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        self.next_batch = int(state["next_batch"])

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _epoch_batches(self, epoch: int) -> list[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        rank, count = self.process_shard
        if count > 1:
            per = self.batch_size // count
            batches = [b[rank * per : (rank + 1) * per] for b in batches]
        return batches

    def _get_pool(self):
        if self._pool is None and self.num_workers > 0:
            # spawn, not fork: the parent holds live JAX/TPU threads by the
            # time the first batch is requested, and forking a multithreaded
            # process can deadlock. Workers only need PIL/numpy/the tokenizer.
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(
                self.num_workers,
                initializer=_init_worker,
                initargs=(self.dataset, self.tokenizer, self.image_size,
                          self.max_length, self.lang_codes),
            )
        return self._pool

    def epoch_iterator(self, epoch: Optional[int] = None) -> Iterator[dict]:
        """Iterate one epoch's batches, honoring a resumed mid-epoch position."""
        if epoch is not None:
            self.epoch = epoch
        batches = self._epoch_batches(self.epoch)[self.next_batch :]

        # NOTE: next_batch is incremented BEFORE the yield: a yielded batch
        # counts as consumed (checkpoints are written after the step finishes),
        # and code after a yield only runs on the *next* next() call.
        if self.num_workers == 0:
            for b in batches:
                self.next_batch += 1
                # set before every batch: another loader iterated in this
                # process between two of this one's batches (the trainer's
                # eval, mid-epoch) left its own dataset there.  mic_tpu sets
                # it once an epoch and then reads the eval split's rows.
                _init_worker(self.dataset, self.tokenizer, self.image_size,
                             self.max_length, self.lang_codes)
                yield _make_batch(b)
        else:
            # bounded decode-ahead: keep (num_workers + prefetch) batches in
            # flight so every worker stays busy AND up to `prefetch` finished
            # batches sit ready while the device step runs, without imap's
            # unbounded task queue growing an epoch of decoded images in RAM
            pool = self._get_pool()
            from collections import deque

            window = self.num_workers + max(1, self.prefetch)
            pending: deque = deque()
            for b in batches:
                pending.append(pool.apply_async(_make_batch, (b,)))
                if len(pending) >= window:
                    out = pending.popleft().get()
                    self.next_batch += 1
                    yield out
            while pending:
                out = pending.popleft().get()
                self.next_batch += 1
                yield out
        self.epoch += 1
        self.next_batch = 0

    def __iter__(self) -> Iterator[dict]:
        return self.epoch_iterator()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None

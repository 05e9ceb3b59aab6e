"""Logits processors: the search's mask constant and the sampling warpers
(mic_tpu/generate/processors.py).

Forced tokens, min-length EOS blocking and n-gram bans act in
generate/search.py.  The warpers (temperature, top-k, top-p) are functions
``(log_probs, cur_len) -> log_probs`` on float32 (N, V) rows, as in
mic_tpu; ``cur_len`` is the host int step position, which no warper reads.
NEG_INF is finite so that masked scores stay ordered and a NEG_INF sum never
turns into NaN.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

NEG_INF = -1e7

Processor = Callable[[torch.Tensor, int], torch.Tensor]  # (log_probs, cur_len)


def chain(processors: Sequence[Processor]) -> Processor:
    def fn(log_probs, cur_len):
        for p in processors:
            log_probs = p(log_probs, cur_len)
        return log_probs

    return fn


def temperature_warper(temperature: float) -> Processor:
    def fn(logits, cur_len):
        del cur_len
        return logits / torch.tensor(temperature, dtype=logits.dtype, device=logits.device)

    return fn


def top_k_warper(k: int) -> Processor:
    def fn(logits, cur_len):
        del cur_len
        kk = min(k, logits.shape[-1])
        threshold = torch.sort(logits, dim=-1).values[..., -kk][..., None]
        return torch.where(logits < threshold, NEG_INF, logits)

    return fn


def top_p_warper(p: float) -> Processor:
    def fn(logits, cur_len):
        del cur_len
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.exp(sorted_logits - sorted_logits.amax(dim=-1, keepdim=True))
        probs = probs / probs.sum(dim=-1, keepdim=True)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative probability passes p (always the best)
        keep_sorted = torch.cat(
            [torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < p], dim=-1
        )
        cutoff = torch.where(keep_sorted, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        return torch.where(logits < cutoff, NEG_INF, logits)

    return fn


def build_warpers(*, temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0) -> Processor:
    warps = []
    if temperature != 1.0:
        warps.append(temperature_warper(temperature))
    if top_k > 0:
        warps.append(top_k_warper(top_k))
    if top_p < 1.0:
        warps.append(top_p_warper(top_p))
    return chain(warps)

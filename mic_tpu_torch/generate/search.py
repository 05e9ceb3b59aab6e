"""Beam search over a fixed-shape decode step (mic_tpu/generate/search.py).

The JAX search is one ``lax.while_loop``; here the loop runs on the host
around a step whose tensors keep fixed shapes.  The step position is a host
int, so forced tokens and min-length blocking are decided on the host and
the position reaches the kernels as a launch argument.  The loop condition
is one device flag read back per step.  The first step runs before the
condition is first tested, as the JAX search unrolls it.

Candidates always come from a ``CandidateHead`` (the fused LM head): the
step returns hidden states, and per-beam top-k candidate log-probs and ids
are selected without a vocab-wide log-softmax.  Every top-k here breaks
ties toward the lower index, as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mic_tpu_torch.generate.processors import NEG_INF
from mic_tpu_torch.nn.cache import LazyDecoderCache
from mic_tpu_torch.ops.topk_lse import top_k


class CandidateHead(NamedTuple):
    """topk(hidden, k) -> (log_probs (N, k) f32, ids (N, k) int32);
    token_lp(hidden, tok) -> (N,) log-prob of one forced token id."""

    topk: Callable
    token_lp: Callable
    vocab_size: int


class ProcessorSpec(NamedTuple):
    """The supported logits constraints."""

    forced: tuple[tuple[int, int], ...] = ()  # (position, token_id)
    min_length: int = 0
    eos_token_id: int = 2

    def forced_token_at(self, cur_len: int) -> int:
        """-1 when no token is forced at this position."""
        tok = -1
        for pos, tid in self.forced:
            if cur_len == pos:
                tok = tid
        return tok


class GenerateOutput(NamedTuple):
    sequences: torch.Tensor  # (B, max_length) int32, pad-filled after EOS
    scores: torch.Tensor     # (B,) float32, length-penalized sequence log-prob
    steps: int               # decode steps the host loop ran


def _candidates(hidden, k: int, cur_len: int, spec: ProcessorSpec, head: CandidateHead):
    """Top-k candidates per row, honoring forced tokens (no top-k on those
    steps) and min-length EOS blocking."""
    forced_tok = spec.forced_token_at(cur_len)
    if forced_tok >= 0:
        n = hidden.shape[0]
        val = head.token_lp(hidden, forced_tok).float()
        cand_ids = torch.full((n, k), forced_tok, dtype=torch.int32, device=hidden.device)
        rest = torch.full((n, k - 1), NEG_INF, dtype=torch.float32, device=hidden.device)
        cand_lp = torch.cat([val[:, None], rest], dim=-1)
    else:
        cand_lp, cand_ids = head.topk(hidden, k)
        cand_ids = cand_ids.to(torch.int32)
    if cur_len < spec.min_length:
        cand_lp = torch.where(cand_ids == spec.eos_token_id, NEG_INF, cand_lp)
    return cand_lp, cand_ids


class _BeamState(NamedTuple):
    cur_len: int
    running_sequences: torch.Tensor  # (B, K, T)
    running_scores: torch.Tensor     # (B, K)
    sequences: torch.Tensor          # (B, K, T) finished
    scores: torch.Tensor             # (B, K) penalized finished scores
    is_finished: torch.Tensor        # (B, K)
    cache: LazyDecoderCache


def _gather_beams(x: torch.Tensor, beam_indices: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...), beam_indices (B, J) -> (B, J, ...)."""
    idx = beam_indices.reshape(beam_indices.shape + (1,) * (x.ndim - 2))
    return x.gather(1, idx.expand(beam_indices.shape + x.shape[2:]))


def _beam_search(step_fn, cache: LazyDecoderCache, batch: int, num_beams: int, *,
                 max_length: int, start_token_id: int, eos_token_id: int,
                 pad_token_id: int, spec: ProcessorSpec, length_penalty: float,
                 early_stopping: bool, head: CandidateHead) -> GenerateOutput:
    K, B = num_beams, batch
    device = cache.ancestry.device
    f32 = dict(dtype=torch.float32, device=device)

    def penalty(length: int) -> torch.Tensor:
        return torch.tensor(float(length), **f32) ** length_penalty

    running_sequences = torch.full((B, K, max_length), pad_token_id, dtype=torch.int32,
                                   device=device)
    running_sequences[:, :, 0] = start_token_id
    # only beam 0 is live at the start; clones would waste the candidate pool
    running_scores = torch.tensor([0.0] + [NEG_INF] * (K - 1), **f32).repeat(B, 1)
    init = _BeamState(
        cur_len=1,
        running_sequences=running_sequences,
        running_scores=running_scores,
        sequences=torch.full((B, K, max_length), pad_token_id, dtype=torch.int32,
                             device=device),
        scores=torch.full((B, K), NEG_INF, **f32),
        is_finished=torch.zeros((B, K), dtype=torch.bool, device=device),
        cache=cache,
    )

    def cond(s: _BeamState) -> bool:
        if s.cur_len >= max_length:
            return False
        if early_stopping:
            best_running = s.running_scores[:, :1] / penalty(max_length)
        else:
            best_running = s.running_scores[:, :1] / penalty(s.cur_len)
        worst_finished = torch.where(s.is_finished, s.scores, NEG_INF).amin(dim=1, keepdim=True)
        go = (worst_finished < best_running).any()
        if early_stopping:
            go = go & ~s.is_finished.all()
        return bool(go)  # the step's one device -> host read

    def body(s: _BeamState) -> _BeamState:
        prev = s.running_sequences[:, :, s.cur_len - 1].reshape(B * K, 1)
        hidden, cache = step_fn(prev, s.cache)
        # per-beam candidates; 2K+1 so that min-length EOS filtering still
        # leaves 2K viable ones
        kc = min(2 * K + 1, head.vocab_size)
        cand_lp, cand_ids = _candidates(hidden, kc, s.cur_len, spec, head)
        cand_total = cand_lp + s.running_scores.reshape(B * K, 1)

        # global 2K candidates per image from the K*kc pool
        topk_scores, topk_flat = top_k(cand_total.reshape(B, K * kc), 2 * K)
        topk_beam = topk_flat // kc                                  # (B, 2K)
        topk_token = cand_ids.reshape(B, K * kc).gather(1, topk_flat)
        topk_sequences = _gather_beams(s.running_sequences, topk_beam)
        topk_sequences[:, :, s.cur_len] = topk_token
        just_finished = topk_token == eos_token_id

        # next running beams: best K candidates that did not just emit EOS
        running_cand_scores = topk_scores + just_finished.float() * NEG_INF
        next_running_scores, running_pick = top_k(running_cand_scores, K)
        next_running_sequences = _gather_beams(topk_sequences, running_pick)

        # fold just-finished candidates into the finished set
        if early_stopping:
            beams_full = s.is_finished.all(dim=1, keepdim=True)
        else:
            beams_full = torch.zeros((B, 1), dtype=torch.bool, device=device)
        finished_cand_scores = topk_scores / penalty(s.cur_len + 1)
        finished_cand_scores = finished_cand_scores + (~just_finished | beams_full).float() * NEG_INF
        merged_scores = torch.cat([s.scores, finished_cand_scores], dim=1)
        merged_sequences = torch.cat([s.sequences, topk_sequences], dim=1)
        merged_finished = torch.cat([s.is_finished, just_finished & ~beams_full], dim=1)
        next_scores, keep = top_k(merged_scores, K)
        next_sequences = _gather_beams(merged_sequences, keep)
        next_is_finished = merged_finished.gather(1, keep)

        # the lazy cache follows the chosen running beams by composing its
        # ancestry; no cache row moves
        src_beam = topk_beam.gather(1, running_pick)
        cache = cache.beam_reorder(src_beam, K)
        return _BeamState(
            cur_len=s.cur_len + 1,
            running_sequences=next_running_sequences,
            running_scores=next_running_scores,
            sequences=next_sequences,
            scores=next_scores,
            is_finished=next_is_finished,
            cache=cache,
        )

    state = body(init)
    steps = 1
    while cond(state):
        state = body(state)
        steps += 1

    # images with no finished beam fall back to the best running beam
    none_finished = ~state.is_finished.any(dim=1)
    running_penalized = state.running_scores / penalty(state.cur_len)
    sequences = torch.where(none_finished[:, None, None], state.running_sequences,
                            state.sequences)
    scores = torch.where(none_finished[:, None], running_penalized, state.scores)
    best = scores.argmax(dim=1)
    return GenerateOutput(
        sequences=_gather_beams(sequences, best[:, None])[:, 0],
        scores=scores.gather(1, best[:, None])[:, 0],
        steps=steps,
    )


def generate(step_fn, cache: LazyDecoderCache, batch: int, *, max_length: int,
             start_token_id: int, eos_token_id: int, pad_token_id: int,
             num_beams: int, spec: ProcessorSpec, head: CandidateHead,
             length_penalty: float = 1.0, early_stopping: bool = False) -> GenerateOutput:
    """Beam search: ``step_fn(token_ids (B*K, 1), cache) -> (hidden (B*K, D),
    cache)``.  Greedy and sampling are not ported yet."""
    if num_beams < 2:
        raise NotImplementedError("only beam search (num_beams > 1) is ported")
    return _beam_search(
        step_fn, cache, batch, num_beams,
        max_length=max_length, start_token_id=start_token_id,
        eos_token_id=eos_token_id, pad_token_id=pad_token_id, spec=spec,
        length_penalty=length_penalty, early_stopping=early_stopping, head=head,
    )

"""Greedy, sampling and beam search over a fixed-shape decode step
(mic_tpu/generate/search.py).

The JAX search is one ``lax.while_loop``; here the loop runs on the host
around a step whose tensors keep fixed shapes.  The step position is a host
int, so forced tokens, min-length blocking and the n-gram windows are
decided on the host and the position reaches the kernels as a launch
argument.  The loop condition is one device flag read back per step.  The
first step runs before the condition is first tested, as the JAX search
unrolls it.

``step_fn(token_ids, cache) -> (x, cache)`` returns hidden states when a
``CandidateHead`` (the fused LM head) selects the candidates, else dense
(N, V) logits.  Candidates are per-row top-k log-probs and ids, selected
without a vocab-wide log-softmax; every top-k here breaks ties toward the
lower index, as ``jax.lax.top_k`` does.  Sampling takes the dense logits:
log-softmax, the spec, the warpers, then the Gumbel-max draw
``argmax(warped + gumbel)`` (the form of ``jax.random.categorical``) with
noise from ``gumbel_noise`` and an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from mic_tpu_torch.core.knobs import experimental, override
from mic_tpu_torch.generate.processors import NEG_INF, Processor, build_warpers
from mic_tpu_torch.ops.topk_lse import top_k, topk_log_probs


def _topk_mode() -> str:
    """The dense-logits candidate select, resolved per call as in mic_tpu:
    MIC_TPU_EXPERIMENTAL=pallas_topk gives "pallas" (ops/topk_lse.py's
    kernel), and everything else the exact select.  mic_tpu's other choices
    all run the exact select here: "auto" resolves to it off the TPU,
    MIC_TPU_EXACT_TOPK=1 and DecodeConfig.topk_mode="exact" name it,
    "approx" (approx_topk) is the TPU's ``jax.lax.approx_max_k``, an XLA op
    whose off-TPU lowering is the exact top-k and which has no CUDA
    counterpart, and segmented_topk=<seg> is a two-stage form of the same
    exact top-k that only helps XLA on the TPU."""
    return "pallas" if experimental("pallas_topk") else "exact"


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
    no_repeat_ngram: int = 0  # 0 disables

    def forced_token_at(self, cur_len: int) -> int:
        """-1 when no token is forced at this position."""
        tok = -1
        for pos, tid in self.forced:
            if cur_len == pos:
                tok = tid
        return tok


class GenerateOutput(NamedTuple):
    sequences: torch.Tensor  # (B, max_length) int32, pad-filled after EOS
    scores: torch.Tensor     # (B,) float32; beam: length-penalized sequence log-prob
    steps: int               # decode steps the host loop ran


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in (0, 1), float32:
    the noise of one sampling step."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def _ngram_windows(seqs: torch.Tensor, cur_len: int, n: int):
    """All complete n-gram windows of each row's generated prefix: seqs
    (N, T) (position 0 the start token, positions >= cur_len pad), n >= 2
    -> (match (N, W), next_tok (N, W)), W = T - n + 1.  match[i, t] holds
    when the window starting at t lies inside the prefix and its first n-1
    tokens equal the row's last n-1 generated tokens; next_tok[i, t]
    completed that window (HF NoRepeatNGram semantics)."""
    t = seqs.shape[1]
    w = t - n + 1
    start = min(max(cur_len - (n - 1), 0), t - (n - 1))  # dynamic_slice clamps
    pref = seqs[:, start:start + n - 1]
    match = torch.ones((seqs.shape[0], w), dtype=torch.bool, device=seqs.device)
    for j in range(n - 1):
        match &= seqs[:, j:j + w] == pref[:, j:j + 1]
    match &= (torch.arange(w, device=seqs.device) + n - 1 <= cur_len - 1)[None, :]
    return match, seqs[:, n - 1:n - 1 + w]


def _ngram_ban_candidates(cand_lp, cand_ids, seqs, cur_len: int, n: int) -> torch.Tensor:
    """Candidate-space no-repeat-ngram: NEG_INF any candidate that would
    complete an already generated n-gram (callers widen k while it is on)."""
    match, nxt = _ngram_windows(seqs, cur_len, n)
    banned = (match[:, None, :] & (nxt[:, None, :] == cand_ids[:, :, None])).any(dim=-1)
    return torch.where(banned, NEG_INF, cand_lp)


def _ngram_ban_dense(log_probs, seqs, cur_len: int, n: int) -> torch.Tensor:
    """Dense-vocab no-repeat-ngram (sampling): a scatter-min of NEG_INF at
    every banned completion token."""
    match, nxt = _ngram_windows(seqs, cur_len, n)
    vals = torch.where(match, NEG_INF, torch.inf).to(log_probs.dtype)
    return log_probs.scatter_reduce(1, nxt.long(), vals, reduce="amin", include_self=True)


def _force_eos_candidates(cand_lp, cand_ids, cur_len: int, eos_rows: torch.Tensor,
                          eos_token_id: int):
    """Pinned-length decoding: EOS candidates are banned before a row's
    pinned position, and at or after it the slate becomes EOS at slot 0
    (log-prob 0, the rest NEG_INF), so the row finishes exactly there.
    Applied after candidate selection: the per-step work is unchanged."""
    early = (cur_len < eos_rows)[:, None] & (cand_ids == eos_token_id)
    cand_lp = torch.where(early, NEG_INF, cand_lp)
    force = (cur_len >= eos_rows)[:, None]
    slot0 = (torch.arange(cand_lp.shape[-1], device=cand_lp.device) == 0)[None, :]
    lp = torch.where(force, torch.where(slot0, 0.0, NEG_INF), cand_lp)
    ids = torch.where(force, eos_token_id, cand_ids)
    return lp, ids


def _logsumexp(logits32: torch.Tensor) -> torch.Tensor:
    m = logits32.amax(dim=-1)
    return m + torch.log(torch.exp(logits32 - m[..., None]).sum(dim=-1))


def _candidates(x, k: int, cur_len: int, spec: ProcessorSpec,
                head: Optional[CandidateHead] = None, seqs: Optional[torch.Tensor] = None):
    """Top-k candidate (log_probs (N, k) f32, ids (N, k) int32) per row of
    ``x`` (hidden states with a head, else raw (N, V) logits), honoring
    forced tokens (no top-k on those steps), min-length EOS blocking and
    candidate-space n-gram bans."""
    n = x.shape[0]
    forced_tok = spec.forced_token_at(cur_len)
    i32 = dict(dtype=torch.int32, device=x.device)
    if forced_tok >= 0:
        if head is not None:
            val = head.token_lp(x, forced_tok).float()
        else:
            val = x[:, forced_tok].float() - _logsumexp(x.float())
        cand_ids = torch.full((n, k), forced_tok, **i32)
        rest = torch.full((n, k - 1), NEG_INF, dtype=torch.float32, device=x.device)
        cand_lp = torch.cat([val[:, None], rest], dim=-1)
    elif head is not None:
        cand_lp, cand_ids = head.topk(x, k)
    else:
        if _topk_mode() == "pallas":
            cand_lp, cand_ids = topk_log_probs(x, k)
        else:
            vals, cand_ids = top_k(x, k)
            cand_lp = vals.float() - _logsumexp(x.float())[:, None]
    cand_ids = cand_ids.to(torch.int32)
    if cur_len < spec.min_length:
        cand_lp = torch.where(cand_ids == spec.eos_token_id, NEG_INF, cand_lp)
    if spec.no_repeat_ngram > 0 and seqs is not None:
        cand_lp = _ngram_ban_candidates(cand_lp, cand_ids, seqs, cur_len, spec.no_repeat_ngram)
    return cand_lp, cand_ids


def _apply_spec_dense(log_probs, cur_len: int, spec: ProcessorSpec, seqs=None):
    """Dense-vocab application of the spec (sampling only)."""
    if spec.no_repeat_ngram > 0 and seqs is not None:
        log_probs = _ngram_ban_dense(log_probs, seqs, cur_len, spec.no_repeat_ngram)
    forced_tok = spec.forced_token_at(cur_len)
    if forced_tok >= 0:
        log_probs = torch.full_like(log_probs, NEG_INF)
        log_probs[:, forced_tok] = 0.0
    if cur_len < spec.min_length:
        log_probs = log_probs.clone()
        log_probs[..., spec.eos_token_id] = NEG_INF
    return log_probs


def _sequential_search(step_fn, cache, batch: int, *, max_length: int, start_token_id: int,
                       eos_token_id: int, pad_token_id: int, spec: ProcessorSpec,
                       do_sample: bool, warpers: Processor,
                       generator: Optional[torch.Generator], device: torch.device,
                       head: Optional[CandidateHead] = None,
                       eos_positions: Optional[torch.Tensor] = None) -> GenerateOutput:
    """Greedy (top-2 candidates, 8 under an n-gram ban) or sampling, one
    row per image."""
    if do_sample and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    sequences = torch.full((batch, max_length), pad_token_id, dtype=torch.int32, device=device)
    sequences[:, 0] = start_token_id
    scores = torch.zeros((batch,), dtype=torch.float32, device=device)
    is_finished = torch.zeros((batch,), dtype=torch.bool, device=device)

    cur_len, steps = 1, 0
    while True:
        x, cache = step_fn(sequences[:, cur_len - 1:cur_len], cache)
        if do_sample:
            log_probs = torch.log_softmax(x.float(), dim=-1)
            lp = _apply_spec_dense(log_probs, cur_len, spec, sequences)
            if eos_positions is not None:
                # pinned lengths: EOS banned before the row's position
                lp = lp.clone()
                lp[:, eos_token_id] = torch.where(cur_len < eos_positions, NEG_INF,
                                                  lp[:, eos_token_id])
            warped = warpers(lp, cur_len)
            token = (warped + gumbel_noise(warped.shape, generator, device)).argmax(dim=-1)
            token_score = lp.gather(1, token[:, None])[:, 0]
            if eos_positions is not None:  # ... and forced at it
                force = cur_len >= eos_positions
                token = torch.where(force, eos_token_id, token)
                token_score = torch.where(force, 0.0, token_score)
        else:
            vocab = head.vocab_size if head is not None else x.shape[-1]
            kg = 2 if spec.no_repeat_ngram == 0 else min(8, vocab)
            cand_lp, cand_ids = _candidates(x, kg, cur_len, spec, head, seqs=sequences)
            if eos_positions is not None:
                cand_lp, cand_ids = _force_eos_candidates(cand_lp, cand_ids, cur_len,
                                                          eos_positions, eos_token_id)
            # candidates arrive best-first and bans set NEG_INF: the first
            # maximum is the best surviving candidate
            pick = cand_lp.argmax(dim=-1, keepdim=True)
            token = cand_ids.gather(1, pick)[:, 0]
            token_score = cand_lp.gather(1, pick)[:, 0]
        token = torch.where(is_finished, pad_token_id, token).to(torch.int32)
        scores = scores + torch.where(is_finished, 0.0, token_score)
        sequences[:, cur_len] = token
        is_finished = is_finished | (token == eos_token_id)
        cur_len += 1
        steps += 1
        if cur_len >= max_length or bool(is_finished.all()):  # the step's one read
            break
    return GenerateOutput(sequences=sequences, scores=scores, steps=steps)


class _BeamState(NamedTuple):
    cur_len: int
    running_sequences: torch.Tensor  # (B, K, T)
    running_scores: torch.Tensor     # (B, K)
    sequences: torch.Tensor          # (B, K, T) finished
    scores: torch.Tensor             # (B, K) penalized finished scores
    is_finished: torch.Tensor        # (B, K)
    cache: object                    # LazyDecoderCache or DecoderCache


def _gather_beams(x: torch.Tensor, beam_indices: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...), beam_indices (B, J) -> (B, J, ...)."""
    idx = beam_indices.reshape(beam_indices.shape + (1,) * (x.ndim - 2))
    return x.gather(1, idx.expand(beam_indices.shape + x.shape[2:]))


def _beam_search(step_fn, cache, batch: int, num_beams: int, *,
                 max_length: int, start_token_id: int, eos_token_id: int,
                 pad_token_id: int, spec: ProcessorSpec, length_penalty: float,
                 early_stopping: bool, device: torch.device,
                 head: Optional[CandidateHead] = None,
                 eos_positions: Optional[torch.Tensor] = None) -> GenerateOutput:
    K, B = num_beams, batch
    f32 = dict(dtype=torch.float32, device=device)
    eos_rows = (eos_positions.to(torch.int32).repeat_interleave(K)
                if eos_positions is not None else None)

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
        x, cache = step_fn(prev, s.cache)
        vocab = head.vocab_size if head is not None else x.shape[-1]
        # per-beam candidates; 2K+1 so that min-length EOS filtering still
        # leaves 2K viable ones (4 more while n-gram bans can remove some)
        kc = min(2 * K + 1 + (4 if spec.no_repeat_ngram else 0), vocab)
        cand_lp, cand_ids = _candidates(x, kc, s.cur_len, spec, head,
                                        seqs=s.running_sequences.reshape(B * K, -1))
        if eos_rows is not None:
            cand_lp, cand_ids = _force_eos_candidates(cand_lp, cand_ids, s.cur_len, eos_rows,
                                                      eos_token_id)
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

        # the cache follows the chosen running beams: the lazy cache composes
        # its ancestry (no row moves), the physical cache moves its rows
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


def generate(step_fn, cache, batch: int, *, max_length: int, start_token_id: int,
             eos_token_id: int, pad_token_id: int, num_beams: int = 1,
             do_sample: bool = False, spec: Optional[ProcessorSpec] = None,
             warpers: Optional[Processor] = None, length_penalty: float = 1.0,
             early_stopping: bool = False, generator: Optional[torch.Generator] = None,
             head: Optional[CandidateHead] = None,
             eos_positions: Optional[torch.Tensor] = None) -> GenerateOutput:
    """Greedy, sampling or beam search.  ``step_fn(token_ids (N, 1), cache)
    -> (x, cache)`` with N = batch for greedy and sampling, batch *
    num_beams for beam search.  ``eos_positions``: optional (batch,) int32
    pinned per-image EOS positions (>= 2 when a BOS token is forced at
    position 1); image b's sequence ends with EOS exactly at its position.
    ``generator`` draws the sampling noise (None: a generator seeded at 0,
    as mic_tpu's ``PRNGKey(0)``); sampling never uses ``head``."""
    spec = spec or ProcessorSpec(eos_token_id=eos_token_id)
    warpers = warpers or build_warpers()
    device = cache.cross_k.device
    if eos_positions is not None:
        eos_positions = torch.as_tensor(eos_positions, dtype=torch.int32, device=device)
    if num_beams > 1:
        if do_sample:
            raise NotImplementedError("beam sampling is not supported")
        return _beam_search(
            step_fn, cache, batch, num_beams,
            max_length=max_length, start_token_id=start_token_id,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id, spec=spec,
            length_penalty=length_penalty, early_stopping=early_stopping, device=device,
            head=head, eos_positions=eos_positions,
        )
    return _sequential_search(
        step_fn, cache, batch,
        max_length=max_length, start_token_id=start_token_id,
        eos_token_id=eos_token_id, pad_token_id=pad_token_id, spec=spec,
        do_sample=do_sample, warpers=warpers, generator=generator, device=device,
        head=None if do_sample else head, eos_positions=eos_positions,
    )

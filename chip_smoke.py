#!/usr/bin/env python3
"""Drive the PyTorch port (mic_tpu_torch) once on one CUDA card.

Run from the repository root with no arguments:  python3 chip_smoke.py
With ``--cards N`` (N >= 2 cards) it runs only the multi-card paths
instead (``run_cards``): the caption CLI's split over N cards, and
data-parallel and FSDP training in N NCCL processes, a card each.

Phases, each of which raises on failure (none catches its own):
  1. build the CUDA kernels from mic_tpu_torch/csrc/;
  2. the lazy-attention kernel (row 1) against its plain version at the
     flagship decode shape (B=256, K=4, T=64, H=16, Dh=64, bf16);
  3. the bf16 bucket head kernel (row 4, wgmma fed by TMA) against its
     plain version (N in {1, 4, 65, 1024}, D in {64, 1024, 1408}, V in
     {997, 250054}, k in {1, 9, 16}), ties across chunks, exact sums on
     integer hidden values (ids equal, winners bit-equal), bucket_bv widths
     32, 96 and 200, and its time at N in {4, 1024};
  4. each kernel's time beside its plain version's (CUDA events, median);
  5. the whole path: flagship-width random weights (CLIP ViT-B/32 ->
     12-layer mBART-50 -> tied 250054-token head), 8 images through
     preprocess_images -> Captioner.generate (beam 4, max_length 64), with
     launch counts that prove the kernels carried it; then a batch of 1
     and a batch of 256 timed for captions/s smoke figures (not a benchmark);
  6. the same path at a small width on the card against the CPU (plain
     versions) on the same weights;
  7. the flash-CE forward kernel (row 7, wgmma fed by TMA, 128-row x
     256-column tiles) against its plain version (N in {1, 129, 4096}: one
     row, a row past a tile, the flagship step, at D=1024 V=250054, whose
     last vocab tile holds 198 columns; and N=129 over the table's first
     257 rows, one column past a tile; bf16, labels in the last vocab
     tile);
  8. the flash-CE dl kernel (row 8, the same walk) against its plain version
     (the same shapes, label smoothing 0 and 0.1, rows with rowscale 0, a
     guard past dl);
  9. both CE kernels' times beside their plain versions' at N=4096, each
     kernel's share of its bound, cuBLAS's bare f32-output h @ W^T product
     for scale (not the same function), and the dh / demb GEMMs over dl;
 10. training at flagship width: the port's Trainer takes 6 steps of batch
     64 x 64 with the TrainConfig defaults (fused CE on the dl route, remat
     "masks", bf16 moments and shadow) from one seed in four turns: the
     default knobs, MIC_TPU_EXPERIMENTAL=small_attn twice, the default knobs
     again, with launch counts that prove both CE kernels ran once a step
     and the small-T kernels 48 (forward) and 24 (backward) times a
     small_attn step, the default turns bit-equal, the small_attn first
     loss beside the default's, and step-time smoke figures (not a
     benchmark);
 11. three train steps at a small width on the card against the CPU (the
     first step's gradients, the losses, the params);
 12. the int8 bucket head kernel (wgmma fed by TMA) against its plain
     version (N in {4, 65, 1024}, D=1024, V=250054, k in {1, 9}), and on
     integer hidden values (exact sums) ids equal and winners bit-equal;
 13. the exact/window select kernels (wgmma fed by TMA) against the plain
     versions: bf16 (row 5) at N in {1, 4, 65, 1024}, D in {64, 96, 1024,
     1344}, V in {997, 250054}, k in {1, 9, 16}; int8 (row 6) at D=1024,
     N in {1, 4, 65, 1024}, k in {1, 9, 16} and a ragged V=997 (ids equal,
     and every lp exactly the plain logit minus the kernel's lse); both on
     tied logits (the order of ties);
 14. the int8-cache lazy-attention kernel (row 2, a split two-pass walk)
     against its plain version with 1, 4 and 8 beams at index 0, 1, 17 and
     T - 1, the flagship decode shape, and the largest (K, T) the earlier
     kernel launched (32 beams at T=192, one at T=6144): int8 values and
     scales bit-equal, other columns untouched, reruns bit-equal; and
     bit-equal to plain where every sum is exact (q = 0, V row scales
     powers of two, index 63);
 15. each new kernel's time beside its plain version's (the heads per call
     and, for the int8 head, in CUDA-graph replays, N in {4, 1024}); rows
     1 and 2 at the flagship decode shape, index 63 and 17, in CUDA-graph
     replays and per call, with their shares of their bounds;
 16. the flagship int8 path (int8 weights and KV): 8 images with launch
     counts and a second run, then the exact and window selects (and a bf16
     exact-select run), so that every head kernel carries a whole generate;
     B=1 and B=256 smoke figures;
 17. at a small width, the trees quantized on the card and on the CPU
     bit-equal, and int8 generate (bucket and exact) card against CPU;
 18. the decode-attention kernel against its plain version at the flagship
     greedy shape (L=12, B=256, T=64, H=16, Dh=64, bf16, index in {0, 1,
     17, 63}) and at B=4 (the walk split 4 ways; index in {0, 1, 15, 63}):
     outputs, the written cache bit-equal, other cells untouched;
 19. the top-k + logsumexp kernel against its plain version (N in {4, 256,
     1024}, V=250054, and V=997 with ties; k in {1, 2, 9, 13}; bf16, f32),
     and on rows of every 16-byte alignment (V in {997, 20011, 250054},
     the logits starting 0-7 elements past an aligned address) with values
     planted in each row's first and last 8 columns, on both sides of its
     run boundaries, and tied between a peeled last column and a column
     before it, some rows a third -inf, k in {1, 9, 16}, reruns bit-equal;
 20. both kernels' times beside their plain versions' and a library
     yardstick (scaled_dot_product_attention at N in {4, 256}; torch.topk +
     logsumexp);
 21. the flagship greedy path, 8 images: by default (the bucket head, k=2),
     under MIC_TPU_EXPERIMENTAL=fused_decode,pallas_topk with
     MIC_TPU_FUSED_HEAD=0 (both new kernels, with launch counts), and
     sampling with pinned EOS positions (twice from one seed); B=1 and
     B=256 greedy smoke figures;
 22. greedy at a small width on the card against the CPU in both knob sets;
 23. the blocked lazy-attention kernel (MIC_TPU_FUSED_LAZY_ATTN=1, a split
     row walk) against its plain version at the flagship decode shape, bf16
     and the int8 cache with per-head scales, index in {0, 1, 17, 63}, and
     with 8 beams at index 17 and 63: reruns bit-equal, the caches it reads
     byte-identical before and after; and bit-equal to plain where every
     sum is exact (q = 0, integer V);
 24. the cross-attention kernel against its plain version at B=256, H=16,
     beams {4, 1, 9, 16, 33} and S {50, 37, 1, 64}, reruns bit-equal, and
     bit-equal to plain where every sum is exact (q = 0, integer V);
 25. the LN -> GEMM kernel (row 15, wgmma fed by TMA, the LayerNorm
     applied to the A operand in shared memory) against its plain version
     at N in {1, 8, 32, 70, 129, 1024}, (D, O) in {(256, 384), (160, 192),
     (1024, 3072)}: reruns bit-equal, no row past N written;
 26. the fused MLP kernel (wgmma fed by TMA) against its plain version at
     N in {1024, 70, 8, 32}, D=1024, F=4096, reruns bit-equal, no row past
     N written (N=70, 8, 32), and at N=32 with every activation;
 27. the four kernels' times (CUDA-graph replays, and per call with the
     wrapper) beside their plain versions', a library yardstick (SDPA with
     the beams on the query axis; F.layer_norm + F.linear; F.linear ->
     F.gelu -> F.linear), and the blocked attention's, LN -> GEMM's and the
     MLP's shares of their bounds;
 28. the flagship beam-4 path under MIC_TPU_FUSED_LAZY_ATTN=1 and
     MIC_TPU_EXPERIMENTAL=fused_cross_attn,fused_mlp,ln_qkv, 8 images, with
     the bf16 and the int8 KV cache: each of the four kernels 12 times a
     step, reruns identical, the share of tokens equal to the default
     knobs'; B=1 and B=256 smoke figures in turns with the default knobs
     (at B=1, N=4 rows, mic_tpu's N % 8 gates turn LN -> GEMM and the MLP
     kernel off);
 29. that path at a small width on the card against the CPU, both caches;
 30. the flash-CE save forward (row 9) at phase 7's shapes: statistics
     bit-equal to the non-saving kernel's, reruns bit-equal, the bf16
     logits within one ulp of the plain rounding, the f32 tail;
 31. the split (row 10) and save (row 9) backwards against their plain
     versions at the same shapes, smoothing 0 and 0.1, demb entry by entry,
     reruns bit-equal;
 32. their times beside their plain versions' at N=4096, and each
     contraction kernel alone;
 33. the flagship Trainer under flash_ce "fwd", "split" and "save", and
     "save" with MIC_TPU_DL_MAX_ROWS=2048, six steps each, with launch
     counts that prove each route's kernels ran once a step, and its peak
     memory;
 34. three train steps at a small width on the card against the CPU under
     each of those routes: the first step's gradient leaves, the losses and
     the params (phase 11 does the same on the dl route);
 35. the small-T attention kernels (row 12, forward and backward) and the
     flash forward (row 11) against their plain versions at the decoder's
     B=64 T=64 H=16 (causal with right padding, and left padding: rows with
     no valid key) and vision's B=64 T=50 H=12, small-T also at T=1 and
     T=63, flash also at Tq=64 Tk=65 and Tq=Tk=600; every bf16 forward
     also within one bf16 ulp of the size of its terms of the plain
     output, with the share of outputs not bit-equal to it printed and
     held under a limit, and each bf16 gradient within one bf16 ulp of
     the size of its terms, its share not bit-equal held likewise; and
     flash's recomputing backward on the card against the CPU;
 36. their times (CUDA-graph replays, and per call) beside their plain
     versions', their bounds and scaled_dot_product_attention's (its
     backward's device time from the profiler, taken after phase 48, so
     that no graph-replay time follows a profiler trace), flash also at
     B=8 Tq=Tk=600;
 37. flagship Captioner(attn_impl="pallas"): a teacher-forced forward and
     backward of the fused loss at B=64 (flash once per self-attention
     layer), then beam 4 under attn_impl="pallas" and under small_attn
     (12 encoder launches each);
 38. at a small width with head dim 64, the card against the CPU: small_attn
     training's first-step gradients, attn_impl="pallas" logits and grads;
 39. the merged-cache cross-attention kernel (row 13) against its plain
     version at B=256, H=16, beams {4, 1, 9, 16, 33} over S=50 live rows padded
     to 64, a ragged 37 of 48, 64 unpadded and 1 of 16, reruns bit-equal,
     bit-equal with NaN in every pad row, and bit-equal to plain on exact
     sums;
 40. the int8 cross-attention kernel (row 14's int8 form) against its plain
     version at B=256, H=16, beams {4, 1, 9, 16, 33} and S {50, 37, 1, 64},
     reruns bit-equal, and bit-equal to plain on exact sums (power-of-two V
     scales);
 41. the beam permute (row 19) bit-equal to its plain version on one
     flagship self plane (L=12, B*K=1024, T=64, H=16, Dh=64 bf16) and on
     planes whose T*H*Dh is not a multiple of 8;
 42. the int8 dequant GEMM (row 20) against its plain version at M in {4,
     1024} and (K, N) in {(1024, 3072), (1024, 4096), (4096, 1024),
     (1024, 250054)}, reruns bit-equal;
 43. the four kernels' times beside their plain versions', their bounds
     and a library call where one computes the same function (SDPA on row
     13's live rows; index_select for row 19);
 44. path A, beam 4 under MIC_TPU_EXPERIMENTAL=merged_cross at flagship
     width, 8 images, bf16 and int8 KV: row 13 twelve times a step, reruns
     identical, the share of tokens equal to the default knobs'; B=1 and
     B=256 smoke figures in turns with the default knobs;
 45. path B, beam 4 on the physical cache (MIC_TPU_LAZY_CACHE=0), 8 images:
     row 19 twice a step, reruns identical, merged_cross beside it ignored;
     B=1 and B=256 smoke figures in turns with the default knobs;
 46. both paths at a small width on the card against the CPU;
 47. beam 12 at a small width under merged_cross and under fused_cross_attn
     alone, card against CPU;
 48. the bf16 bucket head's ring: in its kernel's SASS no slot released
     before the products reading it retire, and twenty reruns bit-equal;
 49. checkpoints and model directories at flagship width (2 of 12
     layers, as in phases 58-60): Trainer.train()
     over a synthetic TSV of 256 PNGs for 4 steps saving every 2 (2 kept),
     the model directory reloaded by from_pretrained bit-equal and its
     beam-4 generate equal to the in-memory params' (rows 1 and 4), the
     caption and evaluate CLIs on the card, one save, restore and
     model-directory save timed, a run resumed from step 2 bit-equal to
     the uninterrupted one (params, moments, step, losses); and at a small
     width a checkpoint carried card -> CPU and CPU -> card bit-equal.
 50. the trained-model tools at flagship decoder width (tiny vision
     tower): tools/torch_ab_hard_synthetic.py on 256 hard synthetic images
     (112 steps, eval, the saved model, the decode A/B: rows 7, 8, 1, 4, 5
     launched, losses finite and falling, BLEU for the four languages),
     then tools/torch_bench_trained.py's caption on the saved model at
     B=256 in bf16 (rows 1, 4) and int8 weights and KV (rows 2, 6), each
     search ending where the model ends its captions, and bf16 with
     min_length 64 (all 63 steps);
 51. the float32 instances of rows 1, 4, 5, 7 and 8 (a float32 model's
     kernels: csrc/lazy_attention.cu's float instance, csrc/fused_head_f32.cu
     (row 4: the 3xTF32 tile and the stream, on each side of the route
     crossover), csrc/fused_head.cu's float32 exact and window selects,
     csrc/flash_ce_f32.cu) against their plain versions, TF32 off, at the
     flagship shapes and at ragged ones, each head kernel's second launch
     bit-equal, and their times (CUDA-graph replays) beside their plain
     versions' and cuBLAS's bare f32 h @ W^T;
 52. the default float32 flagship (CaptionerConfig.clip_vit_b32_mbart50()
     at its own dtype) serving: beam 4 of B=256, length 64, EOS pinned at
     63, through rows 1 and 4 in f32 (launch counts), then under the exact
     and the window selects through rows 1 and 5 in f32, and under each
     select at B=2 equal to the same generate on the plain versions on the
     card;
 53. that model training: the Trainer at the TrainConfig defaults, three
     steps through rows 7 and 8 in f32 (launch counts), the losses beside
     the plain "dl" route's on the card;
 54. the rest of single-card training at flagship width in bf16: one step
     under fused_adamw=False (the optax chain), one under each remat
     policy ("none", "masks", "dots": equal losses, peak memory each), and
     Trainer.train() with profile_steps (a trace with device kernels under
     <output_dir>/profile);
 55. the ViT-B/16 + BART-large captioner (CaptionerConfig.vit_b16_bart_large,
     full width and depth, bf16): B=64 images, beam 4, length 64, EOS
     pinned at 63, rows 1 and 4 (756 and 63 launches); every launch of a
     second run held against its plain version on the same inputs and the
     rerun identical to the first, a whole
     run on the plain versions beside it; in float32 at B=8 the sequences
     equal to the plain versions'; row 4 timed at N=256 V=50265; a narrow
     2-layer config of the style and an untied-head one card against CPU;
 56. the mBART-50 translator (MBartSeq2Seq(DecoderConfig()), bf16): B=64
     padded sources of 8-48 tokens, beam 4, max_length 64, on the physical
     cache (row 19 twice a step, equal to its plain version's run); under
     fused_decode,pallas_topk rows 18 and 17 too, every launch held against
     its plain version and the rerun identical; in float32 16 more pad tokens change no beam; row
     19 timed on its (12, 256, 64, 16, 64) plane; a small config card
     against CPU;
 57. the reference's checkpoint formats at flagship width: the port's
     export_hf_fused read back by from_pretrained (every leaf bit-equal, a
     B=8 beam 4 equal), the towers as model.safetensors and
     pytorch_model.bin (written by tools/torch_hf_towers.py's state dicts)
     read by load_pretrained_towers (every leaf but proj
     bit-equal), each write and read timed;
 58. the checkpoint manager's background save (no data_meta) of a
     flagship-width train checkpoint: the time save takes to return (before
     the write is complete), a train step taken during the write, the
     time wait blocks, the restore bit-equal to the state at the save, and
     the synchronous save's time;
 59. lazy-attention mode "0" (mic_tpu's XLA chain, plain tensor code) at
     flagship width, B=8, beam 4, length 64, bf16 with the bf16 and the
     int8 KV cache: no lazy-attention kernel launched, row 4 once a step,
     every chain call held against row 1 (bf16) or row 3's int8 form (the
     same per-head cache) on the same inputs; against mode "2"'s run the
     best scores within 0.1, and both runs' captions rescored by the
     float32 model within 0.1 of each other (near-ties: the float32
     log-prob margin where they first part is printed); the float32
     flagship's sequences equal to mode "2"'s, and its scores equal to
     the rescoring's; a beam step's time beside mode "2"'s in turns;
 60. data-parallel and FSDP training in two gloo processes on the one card
     (tools/torch_rank_worker.py's ranks): the default float32 flagship at
     full width, 2 vision and 2 decoder layers, three steps under dp=2 and
     under dp=2
     with fsdp against one process on the same global batch (losses,
     params), rows 7 f32 and 8 f32 three times in each rank, each rank's
     state about half the whole's under fsdp, and the fsdp checkpoint
     resumed bit-equal in two ranks and in one;
 61. the ViT-B/16 + BART-large preset trains (CaptionerConfig.
     vit_b16_bart_large, full width and depth): rows 7 and 8 against plain
     at its step (N=4096, V=50265, bf16 and float32) and timed beside
     their bounds; the Trainer's three steps of 64 x 64 in bf16 and in
     float32 through rows 7 and 8 once a step, beside the plain dl route's
     losses; in bf16 a save after step 2 restored by a new Trainer and its
     step 3 bit-equal; Trainer.generate_step (beam 4, B=8) through rows 1
     and 4 at V=50265;
 62. the untied flagship (tie_word_embeddings=False, bf16, full width and
     depth) trains: rows 7 and 8 on lm_head's table once a step, against
     the same steps on the dense logits (losses, lm_head's and the shared
     table's first gradients), the table's (V, D) copy timed;
 63. tools/torch_translate.py at mBART-50's width (random weights written
     as pytorch_model.bin, bf16): 256 report rows, chunk 64, the four
     languages, row 19 twice a step in each translated chunk; a small
     config's rows on the card equal to the CPU's;
 64. the float32 instances of rows 2, 3 (float32 cache, and the per-head
     int8 cache under float32 q), 14 (and its int8 form under float32 q),
     13 and 15 against their plain versions at the flagship shapes (B=256
     K=4 T=64 H=16 index 17 and 63; S=50, the merged cache padded to 64
     with NaN pad rows; N=1024 and 32, D=1024, O=3072), reruns bit-equal,
     row 2's written column and scales bit-equal, and their times (graph
     replays) beside their plain versions', bounds and SDPA in float32;
 65. the default float32 flagship (CaptionerConfig.clip_vit_b32_mbart50(),
     full width and depth) at B=64, beam 4, length 64, EOS pinned at 63,
     under kv_quant="int8" (mode "2", row 2 f32), the fused step's
     switches without fused_mlp with the float32 and the per-head int8
     cache (rows 3, 14 and 15 f32) and merged_cross (row 13 f32): each
     kernel 12 times a step, a second run with every launch held against
     its plain version and identical to the first, the whole generate on
     the plain versions (sequences equal but where beams part at a
     near-tie), and a beam step's time in turns with the bf16 flagship
     under the same switches;
 66. the float32 instances of rows 16 (N=1024 and 32, D=1024, F=4096),
     9 (the save forward and backward) and 10 (the split backward) at the
     flagship step (N=4096, V=250054) against their plain versions, reruns
     bit-equal, and their times beside their plain versions' and bounds
     (rows 11 and 12 in float32 are checked and timed in phase 35);
 67. phase 65's machinery on the whole fused step (fused_mlp included) of
     the float32 flagship, float32 and per-head int8 cache: rows 3, 14, 15
     and 16 f32 each 12 times a step, held launch by launch and as a whole
     path against the plain versions;
 68. the float32 flagship's Trainer on flash_ce "split" and "save" (rows 7
     f32 and 10 f32; row 9 f32's forward and backward), three steps each,
     counted, held launch by launch against the plain versions and run on
     them;
 69. past eight beams (ROADMAP B41, B45): row 3's 9-16-beam instance in
     every form (bf16, per-head int8 under bf16 and float32 q, float32) at
     B=64 K in {9, 12, 16} T=64 index in {1, 17, 63}, and where its walk
     takes every row or one buffer, exact sums bit-equal; the selects' and
     row 17's 17-40-candidate instances at N=1024 (and 4, 65) k in {17,
     37, 40} against plain, with ties and planted rows; each timed in
     CUDA-graph replays beside its plain version, its bound (row 17 beside
     torch.topk + torch.logsumexp) and the narrow instances;
 70. the flagship (bf16 and float32) at B=64, beam 16 (and 12), length 64,
     under the default path, the exact select with an n-gram ban (k=37),
     int8 weights and KV with the window select, the fused step with the
     exact select (either cache), pallas_topk with an n-gram ban: every
     launch held against its plain version on the path's inputs, launch
     counts, and the same generate on the plain versions parting only at
     near-ties (on the float32 cache at least 60 of 64 captions equal).
It then prints the card's name and power limit, one JSON line describing
the kernels (each with its time, its plain version's, its bound and a
library call's where one computes the same function), and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FLAGSHIP_BOS = 250004  # mBART-50's en_XX language code

# One H100 SXM, NVIDIA's data sheet: HBM3 bytes/s, and dense peaks without
# sparsity (f32 outside the tensor cores, for the attention kernels' FMAs).
# "tf32x3": float32-accurate products on the tensor cores, three TF32
# products a term (csrc/tf32x3_wgmma.cuh) at 495 TFLOP/s, 495e12 / 3.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32x3": 495e12 / 3}


def bound(nbytes: float, ops: float, kind: str):
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``ops``
    operations of type ``kind`` -> (ms, "bytes" or "operations")."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def attention_bound(rows, index, hd, cache_bytes, scale_bytes=0, ancestry=False, io_bytes=2):
    """Decode attention at write position ``index``: the live prefix of the
    cache read (positions < index), the step column written, q and the step
    K/V read and the output written (bf16, or ``io_bytes`` each), the
    ancestry's live prefix; 4 f32 operations per cached element (q.k and
    p.v)."""
    per_row = hd * cache_bytes + scale_bytes
    nbytes = (2 * rows * index * per_row + 2 * rows * per_row + 4 * rows * hd * io_bytes
              + (rows * (index + 1) * 4 if ancestry else 0))
    return bound(nbytes, 4 * rows * (index + 1) * hd, "f32")


def head_bound(n, d, v, k, weight_bytes, kind, scales=False):
    """A tied-head select: the (V, D) table, its bias (and scales), the
    hidden rows read once, k candidates and the lse written; 2 N D V
    products."""
    nbytes = v * d * weight_bytes + v * 2 + (v * 4 if scales else 0) + n * d * 2 + n * (8 * k + 4)
    return bound(nbytes, 2 * n * d * v, kind)


def topk_bound(n, v, k, elem_bytes):
    """Top-k + logsumexp of (N, V) logits: the logits read once, k log-probs
    and ids written; a compare, an exp and an add per logit in f32."""
    return bound(n * v * elem_bytes + n * k * 8, 3 * n * v, "f32")


def blocked_attention_bound(live_rows, b, beams, index, hd, heads, cache_bytes, scale_bytes=0,
                            io_bytes=2):
    """Mode-"1" attention at write index ``index``: of both caches, the
    ``live_rows`` (image, source row, position) rows that some beam of this
    run's mask admits (the kernel reads no other), with per-head scales on
    the int8 cache, read and never written; q, the step K/V and the mask's
    live rows read, the output written (bf16, or ``io_bytes`` each); 4 f32
    operations per element of the row each beam admits at each position
    and of its step row."""
    rows = b * beams
    nbytes = (2 * live_rows * (hd * cache_bytes + heads * scale_bytes) + 4 * rows * hd * io_bytes
              + b * beams * index * beams)
    return bound(nbytes, 4 * rows * (index + 1) * hd, "f32")


def cross_bound(b, beams, s, hd, elem_bytes=2):
    """Cross-attention: each image's (S, H*Dh) K and V read once, q read and
    the output written, in bf16 (or ``elem_bytes`` each); 4 f32 operations
    per (beam, position, element)."""
    return bound(2 * b * s * hd * elem_bytes + 2 * b * beams * hd * elem_bytes,
                 4 * b * beams * s * hd, "f32")


def ln_gemm_bound(n, d, o, elem_bytes=2, kind="bf16"):
    """LN -> GEMM: x, the LN scale and shift, W and the bias read, the output
    written, bf16 (or ``elem_bytes`` each); 2 N D O products at ``kind``'s
    rate (a float32 model's at "tf32x3", the float32-accurate rate of the
    tensor cores, as the float32 heads')."""
    return bound(elem_bytes * (n * d + 2 * d + d * o + o + n * o), 2 * n * d * o, kind)


def mlp_bound(n, d, f):
    """The MLP: x, W1, b1, W2, b2 read and the output written once, bf16 (the
    (N, F) intermediate kept on chip); 4 N D F products."""
    return bound(2 * (n * d + d * f + f + f * d + d + n * d), 4 * n * d * f, "bf16")


def flash_ce_bounds(n, d=1024, v=250054):
    """Rows 7 and 8 at N rows: h (bf16), the table (bf16) and the bias read
    once; the forward also reads the labels and writes (lse, label logit,
    sum of logits); dl reads labels, lse and rowscale and writes the bf16
    (N, V) dl and dbias.  Each is one 2 N D V logits product."""
    inputs = v * d * 2 + v * 4 + n * d * 2
    return {
        "flash_ce_forward": bound(inputs + n * 4 * 4, 2 * n * d * v, "bf16"),
        "flash_ce_backward_dl": bound(inputs + n * 4 * 3 + n * v * 2 + v * 4, 2 * n * d * v,
                                      "bf16"),
    }


def f32_bounds(n_beam, n_head, n_ce, d=1024, v=250054):
    """The float32 instances of rows 1, 4, 5, 7 and 8 at the main path's
    shapes: row 1 as ``attention_bound`` with f32 caches, q, step rows and
    output (twice the bf16 bytes); the heads (the bucket and the exact and
    window selects: the same bound) and the CE walks one 2 N D V product
    each at the rate of float32-accurate products on the tensor cores
    ("tf32x3"), reading the (V, D) f32 table, the bias and the hidden rows
    once (the heads also writing k candidates and lse; the forward 4 values
    a row; dl also reading labels, lse and rowscale and writing the f32
    (N, V) dl and dbias)."""
    table = v * d * 4 + v * 4
    head = bound(table + n_head * d * 4 + n_head * (8 * 9 + 4), 2 * n_head * d * v, "tf32x3")
    return {
        "lazy_attention_f32": attention_bound(n_beam, 63, d, 4, ancestry=True, io_bytes=4),
        "fused_head_bucket_f32": head,
        "fused_head_select_f32": head,
        "flash_ce_forward_f32": bound(table + n_ce * d * 4 + n_ce * 4 * 4, 2 * n_ce * d * v,
                                      "tf32x3"),
        "flash_ce_backward_dl_f32": bound(table + n_ce * d * 4 + n_ce * 4 * 3 + n_ce * v * 4
                                          + v * 4, 2 * n_ce * d * v, "tf32x3"),
    }


def flash_ce_route_bounds(n, d=1024, v=250054):
    """Rows 9 and 10 at N rows: h (bf16), the table (bf16), the bias, labels,
    lse and rowscale read once, outputs written once.  The save forward
    writes the bf16 main logits and the f32 tail beside (lse, label logit,
    sum of logits); the save backward reads them back and writes dh (bf16),
    demb and dbias (f32); the split backward reads what the dl kernel reads
    and writes what the save backward writes.  Operations: 2 N D V products
    a logits GEMM or a contraction: the function needs one logits product
    and two contractions, 6 N D V, for the split route (its second
    recompute is the design's cost, not the function's), and the two
    contractions, 4 N D V, for the save route."""
    from mic_tpu_torch.ops.flash_ce import main_columns

    v_main = main_columns(v)
    inputs = v * d * 2 + v * 4 + n * d * 2 + n * 4
    grads = n * d * 2 + v * d * 4 + v * 4
    saved = n * v_main * 2 + n * (v - v_main) * 4
    return {
        "flash_ce_forward_save": bound(inputs + n * 4 * 3 + saved, 2 * n * d * v, "bf16"),
        "flash_ce_backward_save": bound(saved + v * d * 2 + n * d * 2 + n * 4 * 3 + grads,
                                        4 * n * d * v, "bf16"),
        "flash_ce_backward": bound(inputs + n * 4 * 2 + grads, 6 * n * d * v, "bf16"),
    }


def flash_ce_contraction_bounds(n, d=1024, v=250054):
    """Each backward contraction alone: grad-W reads h and (split) the table
    and bias or (save) the saved main logits, writes demb and dbias; grad-h
    reads the table and (split) h or (save) the logits, writes dh (f32).  A
    split contraction alone needs its own logits product: 4 N D V."""
    from mic_tpu_torch.ops.flash_ce import main_columns

    v_main = main_columns(v)
    rows = n * 4 * 3
    return {
        "split grad-W": bound(v * d * 2 + v * 4 + n * d * 2 + rows + v * d * 4 + v * 4,
                              4 * n * d * v, "bf16"),
        "split grad-h": bound(v * d * 2 + v * 4 + n * d * 2 + rows + n * d * 4,
                              4 * n * d * v, "bf16"),
        "save grad-W": bound(n * v_main * 2 + n * d * 2 + rows + v_main * d * 4 + v_main * 4,
                             2 * n * d * v_main, "bf16"),
        "save grad-h": bound(n * v_main * 2 + v_main * d * 2 + rows + n * d * 4,
                             2 * n * d * v_main, "bf16"),
    }


def contraction_tma_bytes(part, saved, n, vext, d, grid):
    """The bytes one backward contraction kernel loads by TMA (each block's
    64 x 64 bf16 boxes, zero fill included) on the grid
    ``ops/flash_ce.py::_contraction_grid`` gives: the save kernel six boxes
    a 64-deep step of its sweep, the split kernel its own 64 rows over
    4 ceil(D / 256) boxes once (a part) and that many boxes a swept 64-row
    tile."""
    dblocks, tiles, parts = grid
    box = 64 * 64 * 2
    steps = -(-(vext if part == "grad_h" else n) // 64)
    if saved:
        return dblocks * tiles * steps * 6 * box
    depth_boxes = 4 * -(-d // 256)
    return dblocks * tiles * (steps + parts) * depth_boxes * box


@contextlib.contextmanager
def knobs(**env):
    """Set MIC_TPU_* variables for one phase and restore them after it."""
    old = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for key, value in old.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def require(ok, what: str) -> None:
    """Fail the run (asserts vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def median_ms(fn, runs: int = 25) -> float:
    """Median device time of ``fn`` over ``runs`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(fn, reps: int = 10, runs: int = 10) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the median CUDA-event time of ``runs`` replays over ``reps``.  The
    wrapper's host work (argument checks, allocation, the launch) is not in
    it, as it is in ``median_ms``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = median_ms(graph.replay, runs) / reps
    del graph
    return ms


def profiled_ms(fn, runs: int = 20) -> float:
    """Device time of one call of ``fn`` where a CUDA graph cannot hold it
    (autograd's backward runs on its forward's stream): the sum of the
    device kernels' durations in a torch.profiler trace of ``runs`` calls,
    after a warm-up, over ``runs``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    total_us = sum(float(e.get("dur", 0.0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel")
    if total_us <= 0:
        raise RuntimeError("profiled_ms: the trace holds no device kernel")
    return total_us / 1e3 / runs


def _lazy_inputs(dev, g, b, beams, t, heads, index, q8):
    """q, the caches (bf16, or int8 dicts with per-row scales), the step rows
    and an ancestry whose unwritten positions name each beam's own row."""
    hd = heads * FLAG_DH

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    def cache():
        if not q8:
            return rand(b * beams, t, hd)
        from mic_tpu_torch.ops.quant import quantize_rows_dynamic
        q, s = quantize_rows_dynamic(rand(b * beams, t, hd))
        return {"q": q, "s": s[..., 0].contiguous()}

    q, ks, vs = rand(b, beams, hd, scale=0.3), rand(b, beams, hd), rand(b, beams, hd)
    ck, cv = cache(), cache()
    anc = torch.randint(0, beams, (b, beams, t), generator=g, device=dev, dtype=torch.int32)
    anc[:, :, index:] = torch.arange(beams, device=dev, dtype=torch.int32)[None, :, None]
    return q, ck, cv, ks, vs, anc


def check_lazy_attention(dev):
    """Phase 2: row 1 against its plain version at the flagship decode shape:
    outputs within 2e-2, the written cache bit-equal, columns past index
    zero."""
    from mic_tpu_torch.ops.lazy_attention import lazy_attention, lazy_attention_plain

    b, beams, t, heads = FLAG_B, FLAG_K, FLAG_T, FLAG_H
    g = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for index in (0, 1, 17, 63):
        q, ck, cv, ks, vs, anc = _lazy_inputs(dev, g, b, beams, t, heads, index, False)
        ck[:, index:] = 0
        cv[:, index:] = 0
        pk, pv = ck.clone(), cv.clone()
        out = lazy_attention(q, ck, cv, ks, vs, anc, index, heads)
        ref = lazy_attention_plain(q, pk, pv, ks, vs, anc, index, heads)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
        require(torch.equal(ck, pk) and torch.equal(cv, pv), "cache differs from plain")
        require(not ck[:, index + 1:].any() and not cv[:, index + 1:].any(), "dead column written")
        print(f"lazy_attention index={index}: max_abs_err={err:.6g}, cache bit-equal, "
              "columns > index zero", flush=True)
    return worst


def _bf16_head_cases(dev, cases, seed):
    """(d, v) -> a bf16 tied table and bias of that shape, made once each,
    for the cases' shapes."""
    tables = {}
    for d, v in sorted({(d, v) for _, d, v, _ in cases}):
        g = torch.Generator(device=dev).manual_seed(seed + d + v)
        tables[d, v] = ((torch.randn((v, d), generator=g, device=dev) * 0.02).bfloat16(),
                        (torch.randn((v,), generator=g, device=dev) * 0.1).bfloat16())
    return tables


def _bf16_head_case(got, ref, logits, what, every_lp):
    """The bf16 heads' tolerances against their plain version: lse
    within 1e-3 relative, ids equal but at near-ties (two logits within
    1e-2), lp within 2e-3: every entry (``every_lp``, the bucket's check)
    or where the ids agree (the exact/window select's) -> (lp error, near
    ties)."""
    (lp, ids, lse), (rlp, rids, rlse) = got, ref
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)
    ties = _near_tie_ids(ids, rids, logits, what)
    if not every_lp:
        same = ids == rids
        lp, rlp = lp[same], rlp[same]
    torch.testing.assert_close(lp, rlp, rtol=0, atol=2e-3)
    return (lp - rlp).abs().max().item(), ties


def check_fused_head(dev):
    """Phase 3: the bf16 bucket kernel (row 4: wgmma on both operands in
    shared memory, fed by TMA) against its plain version at N in {1, 4, 65,
    1024}, D in {64, 1024, 1408 (the largest it takes)}, V in {997, 250054},
    k = 9, and k in {1, 16} at the flagship shape (``_bf16_head_case``'s
    tolerances, lp over every entry); ties across chunks (every chunk a copy of the
    first: the earliest chunk's id however the walk is split); integer
    hidden values on a weight of multiples of 2^-6, whose sums are exact on
    both sides (ids equal, the winners' logits bit-equal); bucket_bv widths
    that are not multiples of 64 (32, 96, 200); then its time beside its
    plain version's at N in {4, 1024}."""
    from mic_tpu_torch.ops.fused_head import _logits, fused_head_topk, fused_head_topk_plain

    cases = [(n, d, v, 9) for n in (1, 4, 65, 1024) for d in (64, HEAD_D, 1408)
             for v in (997, HEAD_V)]
    cases += [(n, HEAD_D, HEAD_V, k) for n in (1, 4, 65, 1024) for k in (1, 16)]
    tables = _bf16_head_cases(dev, cases, 2)
    worst = 0.0
    for n, d, v, k in cases:
        weight, bias = tables[d, v]
        hidden = _hidden(dev, n, d, 70 + n + k)
        got = fused_head_topk(hidden, weight, bias, k)
        ref = fused_head_topk_plain(hidden, weight, bias, k, "bucket")
        torch.cuda.synchronize()
        what = f"fused_head N={n} D={d} V={v} k={k}"
        err, ties = _bf16_head_case(got, ref, _logits(hidden, weight, bias), what, True)
        worst = max(worst, err)
        print(f"{what}: lp max_abs_err={err:.6g}, near-tie id differences={ties}", flush=True)
    del tables
    # ties: every chunk a copy of the first, so each bucket column ties
    # across all chunks, at N that split the walk into runs (4) or not
    d, v = 128, 512 * 7 + 100
    g = torch.Generator(device=dev).manual_seed(3)
    first = (torch.randn((512, d), generator=g, device=dev) * 0.2).bfloat16()
    weight = first.repeat(8, 1)[:v].contiguous()
    bias = torch.zeros((v,), device=dev, dtype=torch.bfloat16)
    for n in (4, 70, 1088):
        hidden = _hidden(dev, n, d, 80 + n)
        ids = fused_head_topk(hidden, weight, bias, 9)[1]
        rids = fused_head_topk_plain(hidden, weight, bias, 9, "bucket")[1]
        torch.cuda.synchronize()
        require(torch.equal(ids, rids % 512), f"fused_head ties N={n}: a later chunk's id won")
    print("fused_head ties: the earliest chunk's id at N in {4, 70, 1088}", flush=True)
    # exact sums: integer hidden values times multiples of 2^-6, partial sums
    # far below 2^24 ulps: the kernel's f32 sums equal the plain version's,
    # so its winners are the plain logits (acc + b, the bias in full f32)
    for v in (997, HEAD_V):
        g = torch.Generator(device=dev).manual_seed(4 + v)
        weight = (torch.randint(-8, 9, (v, HEAD_D), generator=g, device=dev) * 2.0 ** -6).bfloat16()
        hidden = torch.randint(-4, 5, (65, HEAD_D), generator=g, device=dev).bfloat16()
        b32 = torch.randn((v,), generator=g, device=dev) * 0.1
        lp, ids, lse = fused_head_topk(hidden, weight, b32, 9)
        rlp, rids, rlse = fused_head_topk_plain(hidden, weight, b32, 9, "bucket")
        torch.cuda.synchronize()
        logits = _logits(hidden, weight, b32)
        require(torch.equal(ids, rids), f"fused_head exact sums V={v}: ids differ from plain")
        require(torch.equal(lp, logits.gather(1, ids.long()) - lse),
                f"fused_head exact sums V={v}: a winner's logit differs from plain")
        torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)
    print("fused_head N=65 integer hidden: ids equal, winners' logits bit-equal", flush=True)
    # bucket widths that are not multiples of the 64-wide column group
    weight, bias = _bf16_head_cases(dev, [(0, 128, 1300, 9)], 9)[128, 1300]
    hidden = _hidden(dev, 70, 128, 90)
    for bv in (32, 96, 200):
        with knobs(MIC_TPU_EXPERIMENTAL=f"bucket_bv={bv}"):
            got = fused_head_topk(hidden, weight, bias, 9)
            ref = fused_head_topk_plain(hidden, weight, bias, 9, "bucket")
        torch.cuda.synchronize()
        require(torch.equal(got[1], ref[1]), f"fused_head bucket_bv={bv}: ids differ from plain")
        _bf16_head_case(got, ref, _logits(hidden, weight, bias), f"fused_head bucket_bv={bv}",
                        True)
    print("fused_head bucket_bv in {32, 96, 200}: ids equal to plain", flush=True)
    weight, bias = _bf16_head_cases(dev, [(0, HEAD_D, HEAD_V, 9)], 2)[HEAD_D, HEAD_V]
    times = {}
    for n in (4, 1024):
        hidden = _hidden(dev, n, HEAD_D, 70 + n + 9)
        times[n] = (median_ms(lambda: fused_head_topk(hidden, weight, bias, 9)),
                    median_ms(lambda: fused_head_topk_plain(hidden, weight, bias, 9, "bucket")))
        print(f"fused_head time at N={n} D={HEAD_D} V={HEAD_V} k=9: kernel {times[n][0]:.4f} ms, "
              f"plain {times[n][1]:.4f} ms", flush=True)
    return worst, *times[1024]


def flagship(dev, layers=None):
    """Flagship-width random bf16 serving params (CLIP ViT-B/32 -> 12-layer
    mBART-50 -> tied 250054-token head; ``layers`` vision and decoder
    layers where given), the model, the generate arguments and a maker of
    preprocessed random images."""
    from mic_tpu_torch.core.config import CaptionerConfig
    from mic_tpu_torch.core.params import make_serving_params
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.image_prep import preprocess_images

    config = (CaptionerConfig.clip_vit_b32_mbart50() if layers is None
              else _flagship_depth(layers)).replace(dtype="bfloat16")
    t0 = time.perf_counter()
    params = make_serving_params(
        init_params(config, torch.Generator(device=dev).manual_seed(0), dev)
    )
    torch.cuda.synchronize()
    print(f"flagship params made on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    kw = dict(num_beams=4, max_length=64, forced_bos_token_id=FLAGSHIP_BOS)

    def pixels(n, seed):
        u8 = np.random.default_rng(seed).integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)
        return preprocess_images(torch.from_numpy(u8).to(dev), config.vision.image_size,
                                 torch.bfloat16)

    return config, params, Captioner(config), kw, pixels


def _counters():
    """Every kernel wrapper's launch counter on the serving path, by name."""
    from mic_tpu_torch.ops.beam_permute import beam_permute
    from mic_tpu_torch.ops.cross_attention import (
        fused_cross_attention, fused_cross_attention_dma, fused_cross_attention_q8,
    )
    from mic_tpu_torch.ops.decode_attention import decode_attention
    from mic_tpu_torch.ops.fused_head import fused_head_select, fused_head_topk, fused_head_topk_q8
    from mic_tpu_torch.ops.fused_mlp import fused_mlp
    from mic_tpu_torch.ops.lazy_attention import (
        fused_lazy_attention, lazy_attention, lazy_attention_q8,
    )
    from mic_tpu_torch.ops.int8_matmul import int8_matmul
    from mic_tpu_torch.ops.ln_gemm import ln_gemm
    from mic_tpu_torch.ops.topk_lse import topk_log_probs

    return {"lazy_attention": lazy_attention, "fused_head": fused_head_topk,
            "lazy_attention_q8": lazy_attention_q8, "fused_head_bucket_q8": fused_head_topk_q8,
            "fused_head_select": fused_head_select, "decode_attention": decode_attention,
            "topk_log_probs": topk_log_probs, "fused_lazy_attention": fused_lazy_attention,
            "fused_cross_attention": fused_cross_attention, "ln_gemm": ln_gemm,
            "fused_mlp": fused_mlp, "fused_cross_attention_dma": fused_cross_attention_dma,
            "fused_cross_attention_q8": fused_cross_attention_q8, "beam_permute": beam_permute,
            "int8_matmul": int8_matmul}


def generate_counted(caption, images):
    """One generate through ``caption`` with every serving launch counter
    set to 0 just before it and read just after -> (output, launches by
    name, host seconds around the synchronised call)."""
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = caption(images)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, {name: fn.launches for name, fn in counters.items()}, seconds


def drive(model, params, px, **kw):
    """One generate with every launch counter set to 0 just before it and
    read just after -> (output, launches by name)."""
    out, launches, _ = generate_counted(lambda x: model.generate(params, x, **kw), px)
    return out, launches


def check_path_output(out, n, max_length, what):
    seqs = out.sequences.cpu()
    require(seqs.shape == (n, max_length), f"{what}: sequences of shape {tuple(seqs.shape)}")
    require(bool((seqs[:, 1] == FLAGSHIP_BOS).all()), f"{what}: forced BOS missing")
    require(bool(torch.isfinite(out.scores).all()), f"{what}: non-finite scores")
    return seqs


def smoke_figures(model, params, pixels, kw, label):
    """B=1 and B=256 generates, two runs each, timed on the host clock
    around a synchronised generate: smoke figures, not a benchmark."""
    for b in (1, 256):
        px = pixels(b, 1)
        for attempt in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.generate(params, px, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            require(bool(torch.isfinite(out.scores).all()), f"{label}: non-finite scores at B={b}")
            print(f"smoke figure (not a benchmark), {label}, run {attempt}: B={b} num_beams "
                  f"{kw['num_beams']} max_length 64, {out.steps} steps in {seconds:.3f} s = "
                  f"{b / seconds:.1f} captions/s", flush=True)


def run_whole_path(dev, flag):
    """Phase 5: the bf16 flagship path with the default (bucket) select."""
    config, params, model, kw, pixels = flag
    px = pixels(8, 0)
    out, counts = drive(model, params, px, **kw)
    launches = {"lazy_attention": counts["lazy_attention"], "fused_head": counts["fused_head"]}
    seqs = check_path_output(out, 8, 64, "whole path")
    print(f"whole path, 8 images: {out.steps} decode steps, launches {launches}, "
          f"sequences {tuple(seqs.shape)}", flush=True)
    require(launches["lazy_attention"] == config.decoder.num_layers * out.steps,
            "lazy_attention launches != layers x decode steps")
    require(launches["fused_head"] >= out.steps, "fused_head launched less than once a step")
    again = model.generate(params, px, **kw)
    require(torch.equal(again.sequences.cpu(), seqs), "a second run gave other sequences")
    print("whole path: second run gave identical sequences", flush=True)
    smoke_figures(model, params, pixels, kw, "bf16")
    return launches


def check_small_against_cpu(dev):
    """The card's path (both kernels) against the CPU path (plain versions)
    on the same bfloat16 weights at a small width with head_dim 64."""
    from mic_tpu_torch.core.config import CaptionerConfig, DecodeConfig, DecoderConfig, VisionConfig
    from mic_tpu_torch.core.params import make_serving_params, tree_map
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.image_prep import preprocess_images

    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                                   max_position_embeddings=64),
        decode=DecodeConfig(fused_head="1", fused_select="bucket"),
        dtype="bfloat16",
    )
    params = make_serving_params(init_params(config, torch.Generator(device=dev).manual_seed(3),
                                             dev))
    u8 = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (4, 40, 40, 3), dtype=np.uint8)
    )
    kw = dict(num_beams=4, max_length=16, forced_bos_token_id=7)
    model = Captioner(config)
    gpu = model.generate(params, preprocess_images(u8.to(dev), 32, torch.bfloat16), **kw)
    cpu = model.generate(tree_map(lambda x: x.cpu(), params),
                         preprocess_images(u8, 32, torch.bfloat16), **kw)
    score_err = (gpu.scores.cpu() - cpu.scores).abs().max().item()
    same = torch.equal(gpu.sequences.cpu(), cpu.sequences)
    print(f"small width, card vs CPU: sequences equal={same}, "
          f"max score difference={score_err:.3g}", flush=True)
    require(same, "card and CPU sequences differ")
    require(score_err < 2e-2, "card and CPU scores differ")


CE_D, CE_V = 1024, 250054  # the flagship decoder width and vocab
# (N, V) of the CE checks: one row, a row past a 128-row tile of the walk
# and the flagship step's rows over the flagship vocab (its last 256-wide
# tile holds 198 columns), and a vocab one column past a tile (the first
# 257 rows of the table: 255 masked columns in the last tile)
CE_CASES = ((1, CE_V), (129, CE_V), (4096, CE_V), (129, 257))


def _ce_table(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    weight = (torch.randn((CE_V, CE_D), generator=g, device=dev) * 0.02).bfloat16()
    bias = torch.randn((CE_V,), generator=g, device=dev) * 0.1
    return weight, bias


def _ce_rows(dev, n, seed, v=CE_V):
    g = torch.Generator(device=dev).manual_seed(seed)
    hidden = torch.randn((n, CE_D), generator=g, device=dev).bfloat16()
    labels = torch.randint(0, v, (n,), generator=g, device=dev, dtype=torch.int32)
    k = min(n, 8)
    labels[:k] = v - 1 - torch.arange(k, device=dev, dtype=torch.int32)  # in the last tile
    return hidden, labels


def check_flash_ce_forward(dev, weight, bias, cases=CE_CASES):
    """Kernel 3 against its plain version at each (N, V) of ``cases`` (the
    table's first V rows): lse and label logit within 1e-3 relative, sum of
    logits within 1e-3 of the row's sum of |logits|; the smoothed loss
    built from each within 1e-3 relative."""
    from mic_tpu_torch.ops.fused_ce import expected_logit, normalizing
    from mic_tpu_torch.ops.flash_ce import flash_ce_forward, flash_ce_forward_plain

    worst = 0.0
    wf = weight.float()
    for n, v in cases:
        tw, tb = weight[:v], bias[:v]
        hidden, labels = _ce_rows(dev, n, n, v)
        out = flash_ce_forward(hidden, tw, tb, labels)
        ref = flash_ce_forward_plain(hidden, tw, tb, labels)
        torch.cuda.synchronize()
        l1 = torch.cat([(hidden[i:i + 512].float() @ wf[:v].T + tb).abs().sum(-1)
                        for i in range(0, n, 512)])
        lse_rel = ((out[0] - ref[0]).abs() / ref[0].abs()).max().item()
        lbl_rel = ((out[1] - ref[1]).abs() / ref[1].abs().clamp(min=1.0)).max().item()
        z_rel = ((out[2] - ref[2]).abs() / l1).max().item()
        require(lse_rel < 1e-3 and lbl_rel < 1e-3, f"flash_ce_forward N={n} V={v}: lse/label logit")
        require(z_rel < 1e-3, f"flash_ce_forward N={n} V={v}: sum of logits")
        for ls in (0.0, 0.1):
            loss, loss_ref = ((s[0] - expected_logit(s[1], s[2], ls, v)).mean()
                              - normalizing(ls, v) for s in (out, ref))
            require(abs(loss.item() - loss_ref.item()) < 1e-3 * abs(loss_ref.item()),
                    f"flash_ce_forward N={n} V={v} smoothing {ls}: loss")
        worst = max(worst, (out[0] - ref[0]).abs().max().item())
        print(f"flash_ce_forward N={n} D={CE_D} V={v}: lse max_rel_err={lse_rel:.3g}, "
              f"label logit max_rel_err={lbl_rel:.3g}, sum_logits max err / row L1="
              f"{z_rel:.3g}, lse max_abs_err={worst:.3g}", flush=True)
    del wf
    return worst


def _bf16_ulp(x):
    """One bf16 unit in the last place of each entry of a bf16 tensor."""
    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).clamp(min=-133))
    return torch.where(x == 0, 2.0**-133, ulp)


def check_flash_ce_dl(dev, weight, bias, cases=CE_CASES):
    """Kernel 4 against its plain version at each (N, V) of ``cases``: dl
    within one bf16 ulp of the plain bf16 dl (plus one of its terms where
    they cancel), rows with rowscale 0 zero, nothing written past dl's last
    row; dbias within 1e-4 of its largest entry."""
    from mic_tpu_torch.ops.flash_ce import (
        _targets, flash_ce_dl, flash_ce_dl_plain, flash_ce_forward_plain,
    )

    worst = 0.0
    for n, v in cases:
        tw, tb = weight[:v], bias[:v]
        hidden, labels = _ce_rows(dev, n, n + 1, v)
        lse = flash_ce_forward_plain(hidden, tw, tb, labels)[0]
        rs = torch.rand((n,), generator=torch.Generator(device=dev).manual_seed(n), device=dev)
        rs = rs / n
        if n > 1:  # a lone row keeps its rowscale
            rs[::7] = 0.0
        for ls in (0.0, 0.1):
            buf = torch.full((n * v + 256,), 3.0, dtype=torch.bfloat16, device=dev)
            dl, dbias = flash_ce_dl(hidden, tw, tb, labels, lse, rs, ls,
                                    out=buf[: n * v].view(n, v))
            ref, dbias_ref = flash_ce_dl_plain(hidden, tw, tb, labels, lse, rs, ls)
            torch.cuda.synchronize()
            require(bool(buf[n * v:].eq(3.0).all()), "flash_ce_dl wrote past dl's end")
            require(not dl[rs == 0].any(), "flash_ce_dl: a rowscale-0 row is not zero")
            # where p nears the smoothed target, p - target cancels and one
            # ulp of the result is finer than the f32 logits' summation
            # order can promise: dl must be within one bf16 ulp of itself
            # plus one of the terms it is the difference of, |p| + |target|
            low, conf_low = _targets(ls, v)
            differ, beyond, err = 0, 0, 0.0
            for i in range(0, n, 256):
                r = ref[i:i + 256].float()
                target = torch.full_like(r, low)
                target.scatter_(1, labels[i:i + 256, None].long(), low + conf_low)
                terms = (r.abs() + 2 * target * rs[i:i + 256, None]).bfloat16()
                d = (dl[i:i + 256].float() - r).abs()
                require(bool((d <= _bf16_ulp(ref[i:i + 256]) + _bf16_ulp(terms)).all()),
                        f"flash_ce_dl N={n} V={v}: dl beyond one bf16 ulp of dl and of its terms")
                differ += int((d > 0).sum())
                beyond += int((d > _bf16_ulp(ref[i:i + 256])).sum())
                err = max(err, d.max().item())
            db = (dbias - dbias_ref).abs().max().item() / dbias_ref.abs().max().item()
            require(db < 1e-4, f"flash_ce_dl N={n} V={v}: dbias")
            worst = max(worst, err)
            print(f"flash_ce_dl N={n} V={v} smoothing={ls}: dl entries differing from plain "
                  f"{differ} of {n * v}, {beyond} of them by more than one ulp of dl "
                  f"(all within one of dl plus one of its terms), dl max_abs_err="
                  f"{err:.3g}, dbias max err / max |dbias|={db:.3g}, guard intact", flush=True)
            del buf, dl, ref
    return worst


def time_flash_ce(dev, weight, bias):
    """Both kernels and their plain versions at N=4096, each kernel's share
    of its bound, cuBLAS's bare h @ W^T with f32 output for scale (the
    2.1 TFLOP product alone, without the statistics or dl: not the same
    function), and the dh / demb GEMMs over a bf16 dl: medians of 25
    CUDA-event runs."""
    from mic_tpu_torch.ops.flash_ce import (
        _dl_gemms, flash_ce_dl, flash_ce_dl_plain, flash_ce_forward, flash_ce_forward_plain,
    )

    n = 4096
    hidden, labels = _ce_rows(dev, n, 11)
    lse = flash_ce_forward_plain(hidden, weight, bias, labels)[0]
    rs = torch.full((n,), 1.0 / n, device=dev)
    t = {
        "fwd": median_ms(lambda: flash_ce_forward(hidden, weight, bias, labels)),
        "fwd_plain": median_ms(lambda: flash_ce_forward_plain(hidden, weight, bias, labels)),
        "dl": median_ms(lambda: flash_ce_dl(hidden, weight, bias, labels, lse, rs, 0.1)),
        "dl_plain": median_ms(lambda: flash_ce_dl_plain(hidden, weight, bias, labels, lse, rs,
                                                        0.1)),
    }
    product_ms = median_ms(lambda: torch.mm(hidden, weight.T, out_dtype=torch.float32))
    torch.cuda.empty_cache()
    dl, _ = flash_ce_dl(hidden, weight, bias, labels, lse, rs, 0.1)
    dh_ms = median_ms(lambda: torch.mm(dl, weight, out_dtype=torch.float32))
    demb_ms = median_ms(lambda: torch.mm(dl.T, hidden, out_dtype=torch.float32))
    both_ms = median_ms(lambda: _dl_gemms(dl, weight, hidden))
    bounds = flash_ce_bounds(n, CE_D, CE_V)
    for name, key, what in (("flash_ce_forward", "fwd", "flash_ce_forward"),
                            ("flash_ce_dl", "dl", "flash_ce_backward_dl")):
        b_ms, by = bounds[what]
        print(f"{name} time at N={n} D={CE_D} V={CE_V}: kernel {t[key]:.4f} ms, plain "
              f"{t[key + '_plain']:.4f} ms; bound {b_ms:.4f} ms ({by}), the kernel at "
              f"{b_ms / t[key]:.1%} of it", flush=True)
    print(f"for scale only (not the same function): cuBLAS torch.mm(h, W.T, out_dtype=f32) at "
          f"N={n}: {product_ms:.4f} ms, {bounds['flash_ce_forward'][0] / product_ms:.1%} of the "
          f"2 N D V bound", flush=True)
    print(f"dl GEMMs (torch.mm bf16 -> f32 output, cuBLAS) at N={n}: dh {dh_ms:.4f} ms, "
          f"demb {demb_ms:.4f} ms, both {both_ms:.4f} ms", flush=True)
    return t


def _train_batches(config, n_batches, batch, seq, seed):
    """Batches in CaptionLoader's output format from seeded numpy: uint8
    crops at the decode size, captions of random length over a Zipf-like
    token set, the pad-prepend decoder shift."""
    rng = np.random.default_rng(seed)
    dec = config.decoder
    vocab = np.arange(4, 4 + 2000)
    p = 1.0 / np.arange(1, vocab.size + 1)
    out = []
    for _ in range(n_batches):
        labels = np.full((batch, seq), dec.pad_token_id, np.int32)
        mask = np.zeros((batch, seq), np.int32)
        for i, length in enumerate(rng.integers(8, seq + 1, batch)):
            labels[i, :length - 1] = rng.choice(vocab, length - 1, p=p / p.sum())
            labels[i, length - 1] = dec.eos_token_id
            mask[i, :length] = 1
        shifted = np.full_like(labels, dec.pad_token_id)
        shifted[:, 1:] = labels[:, :-1]
        out.append({
            "pixel_values": rng.integers(0, 256, (batch, 256, 256, 3), dtype=np.uint8),
            "labels": labels, "decoder_attention_mask": mask, "decoder_input_ids": shifted,
            "lang": np.zeros((batch,), np.int32),
        })
    return out


def _train_counts(reset=False):
    """The training path's launch counters by kernel name (flash-CE and the
    full-sequence attention kernels); set to 0 with ``reset``."""
    from mic_tpu_torch.ops import flash_attention, flash_ce, small_attention

    fields = {"flash_ce_forward": (flash_ce.flash_ce_forward, "launches"),
              "flash_ce_forward_save": (flash_ce.flash_ce_forward, "save_launches"),
              "flash_ce_backward_dl": (flash_ce.flash_ce_backward_dl, "launches"),
              "flash_ce_backward": (flash_ce.flash_ce_backward, "launches"),
              "flash_ce_backward_save": (flash_ce.flash_ce_backward_save, "launches"),
              "small_attention_forward": (small_attention.small_attention_forward, "launches"),
              "small_attention_backward": (small_attention.small_attention_backward, "launches"),
              "flash_attention": (flash_attention.flash_attention_forward, "launches")}
    if reset:
        for fn, attr in fields.values():
            setattr(fn, attr, 0)
    return {name: getattr(fn, attr) for name, (fn, attr) in fields.items()}


def _f32_attention_counts():
    """Rows 11 and 12's launches since ``_train_counts(reset=True)`` under
    the kernels line's float32 names: on a float32 model every launch is a
    float32 instance."""
    counts = _train_counts()
    return {f"{name}_f32": counts[name] for name in ("flash_attention", "small_attention_forward",
                                                     "small_attention_backward")}


def _flagship_train_run(dev, tc, host):
    """One Trainer at flagship width from TrainConfig ``tc``: init, a probe
    loss, six timed steps with the training counters set to 0 just before
    them and read just after, the probe loss again."""
    from mic_tpu_torch.core.config import CaptionerConfig, DataConfig
    from mic_tpu_torch.train.trainer import Trainer

    trainer = Trainer(CaptionerConfig.clip_vit_b32_mbart50(dtype="bfloat16"), DataConfig(), tc,
                      device=dev)
    trainer.build(steps_per_epoch=len(host))
    state = trainer.init_state()
    batches = [trainer.put_batch(b) for b in host]
    probe = trainer.put_batch(dict(host[0], loss_weight=np.ones(64, np.float32)))
    before = trainer.eval_step(state.params, probe)["loss"].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _train_counts(reset=True)
    losses, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss"].item())  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v for k, v in _train_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = trainer.eval_step(state.params, probe)["loss"].item()
    return losses, ms, launches, peak, (before, after), state


def run_training(dev):
    """The port's Trainer at flagship width, TrainConfig defaults (batch 64 x
    64 tokens, dropout 0.1, remat "masks", fused CE on the dl route, bf16
    moments and shadow) with warmup_steps=2: six steps from one seed in four
    turns, the default knobs, MIC_TPU_EXPERIMENTAL=small_attn twice, the
    default knobs again.  Every turn launches both CE kernels once a step;
    the small_attn turns the small-T forward 48 times a step (12 vision + 12
    decoder self-attention layers, each run again by remat "masks" in the
    backward) and its backward 24 times.  The two default turns are
    bit-equal (losses and every param); the small_attn turns' first loss is
    the default's within 1e-2 relative (the attention rounds p to bf16 at
    the XLA math's place; sums in another order).  ms/step, the median of
    steps 2-6, are smoke figures."""
    from mic_tpu_torch.core.config import CaptionerConfig, DataConfig, TrainConfig
    from mic_tpu_torch.core.params import tree_leaves

    config = CaptionerConfig.clip_vit_b32_mbart50(dtype="bfloat16")
    tc = TrainConfig(warmup_steps=2)
    host = _train_batches(config, 6, tc.per_device_batch_size, DataConfig().max_seq_length, 12)
    ce = {"flash_ce_forward": 6, "flash_ce_backward_dl": 6}
    small = dict(ce, small_attention_forward=6 * 48, small_attention_backward=6 * 24)
    runs, launches = [], {}
    for turn, label in enumerate(("default", "small_attn", "small_attn", "default"), 1):
        t0 = time.perf_counter()
        with knobs(**({"MIC_TPU_EXPERIMENTAL": "small_attn"} if label == "small_attn" else {})):
            losses, ms, got, peak, probe, state = _flagship_train_run(dev, tc, host)
        print(f"training, flagship width, {label} knobs, turn {turn}, 6 steps of 64 x 64: losses "
              f"{losses}, launches {got}, peak allocated {peak:.2f} GiB, probe-batch loss "
              f"{probe[0]:.6f} -> {probe[1]:.6f} ({time.perf_counter() - t0:.1f} s with init); "
              f"smoke figure (not a benchmark): median of steps 2-6 {float(np.median(ms[1:])):.1f} "
              f"ms = {64 / float(np.median(ms[1:])) * 1e3:.1f} samples/s (step times "
              f"{[round(x, 1) for x in ms]} ms)", flush=True)
        require(all(np.isfinite(losses)), f"{label}: a non-finite training loss")
        want = small if label == "small_attn" else ce
        require(got == want, f"{label}: launches {got}, expected {want}")
        require(probe[1] < probe[0], f"{label}: the loss on the repeated batch did not fall")
        params = ([leaf.detach().clone() for _, leaf in tree_leaves(state.params)]
                  if label == "default" else None)
        runs.append((label, losses, params))
        launches.update(got)
        del state
        torch.cuda.empty_cache()
    (_, first, params1), (_, small1, _), _, (_, last, params4) = runs
    require(last == first, "a second default run from the same seed gave other losses")
    require(all(torch.equal(a, b) for a, b in zip(params1, params4)),
            "a second default run from the same seed gave other params")
    print("training: the two default turns bit-equal (losses and every param)", flush=True)
    rel = abs(small1[0] - first[0]) / abs(first[0])
    print(f"first-step loss, small_attn {small1[0]:.6f} vs default {first[0]:.6f} (same seed and "
          f"batch): relative difference {rel:.3g} (limit 1e-2)", flush=True)
    require(rel <= 1e-2, "small_attn's first loss is not the default's")
    return launches


def _first_grads(trainer, state, batch):
    """The gradient leaves of the trainer's loss on one device batch, from
    the state's params and shadow, as f32 on the host."""
    from mic_tpu_torch.core.params import tree_leaves
    from mic_tpu_torch.ops.image_prep import maybe_preprocess

    pixels = maybe_preprocess(batch["pixel_values"], trainer.mc.vision.image_size, trainer.dtype)
    leaves = [leaf for _, leaf in tree_leaves(state.params)]
    with torch.enable_grad():
        loss = trainer.compute_loss(state.params, pixels, batch, shadow=state.shadow)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return [g.detach().float().cpu() for g in grads]


def check_training_small_against_cpu(dev, routes=("dl",)):
    """Three train steps at a small bf16 width, dropout 0, on each flash-CE
    route of ``routes``: the card (the route's CE kernels) against the CPU
    (plain versions) from the same weights.  The first batch's gradients,
    each leaf within 5e-2 of its largest entry: bf16 activations rounded in
    other orders move the worst leaf by about 1.6% (bf16 against f32 on the
    CPU at this width), and a leaf whose gradient is zero in exact
    arithmetic (a key bias under softmax) holds only rounding noise, so each
    leaf's largest entry is floored at 1e-4 of the largest of all leaves.
    This catches a wrong or missing CE backward; the kernel phases hold the
    kernels entry by entry.  Losses within 5e-3 relative; params within
    2 x steps x lr absolute, the bound that Adam's normalized update allows
    a near-zero gradient.  V = 1100: the save route keeps 1024 columns as
    bf16 and a 76-column f32 tail."""
    from mic_tpu_torch.core.config import (
        CaptionerConfig, DataConfig, DecoderConfig, TrainConfig, VisionConfig,
    )
    from mic_tpu_torch.core.params import tree_leaves, tree_map
    from mic_tpu_torch.models.captioner import init_params
    from mic_tpu_torch.train.trainer import Trainer

    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                                   max_position_embeddings=64, dropout=0.0),
        dtype="bfloat16",
    )
    dc = DataConfig(max_seq_length=16, decode_size=40)
    params = init_params(config, torch.Generator().manual_seed(13))
    paths = [path for path, _ in tree_leaves(params)]
    rng = np.random.default_rng(14)
    host = [{"pixel_values": rng.integers(0, 256, (4, 40, 40, 3), dtype=np.uint8),
             "labels": rng.integers(4, 1100, (4, 16)).astype(np.int32),
             "decoder_input_ids": rng.integers(4, 1100, (4, 16)).astype(np.int32),
             "decoder_attention_mask": np.ones((4, 16), np.int32)} for _ in range(3)]
    for route in routes:
        tc = TrainConfig(per_device_batch_size=4, learning_rate=1e-3, warmup_steps=1,
                         label_smoothing=0.1, flash_ce=route)
        runs = {}
        for device in (dev, torch.device("cpu")):
            trainer = Trainer(config, dc, tc, device=device)
            trainer.build(10)
            state = trainer.init_state(tree_map(lambda x, d=device: x.clone().to(d), params))
            grads = _first_grads(trainer, state, trainer.put_batch(host[0]))
            _train_counts(reset=True)
            losses = []
            for batch in host:
                state, m = trainer.train_step(state, trainer.put_batch(batch))
                losses.append(m["loss"].item())
            runs[device.type] = (losses, [leaf.detach().cpu() for _, leaf in
                                          tree_leaves(state.params)], _train_counts(), grads)
        (lc, pc, launches, gc), (lh, ph, cpu_launches, gh) = runs["cuda"], runs["cpu"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
        param_err = max((a - b).abs().max().item() for a, b in zip(pc, ph))
        floor = 1e-4 * max(g.abs().max().item() for g in gh)
        grad_rel = sorted(((a - b).abs().max().item() / max(b.abs().max().item(), floor), path)
                          for path, a, b in zip(paths, gc, gh))
        print(f"training at a small width, route {route!r}, card vs CPU: losses {lc} vs {lh}, "
              f"max relative difference {loss_rel:.3g}; first-step gradients, worst leaf "
              f"{'/'.join(grad_rel[-1][1])} at {grad_rel[-1][0]:.3g} of its largest entry "
              f"(limit 5e-2); params max abs difference {param_err:.3g}; card launches "
              f"{({k: v for k, v in launches.items() if v})}", flush=True)
        require(loss_rel < 5e-3, f"route {route!r}: card and CPU training losses differ")
        require(grad_rel[-1][0] <= 5e-2,
                f"route {route!r}: card and CPU gradients differ ({'/'.join(grad_rel[-1][1])})")
        require(param_err < 2 * 3 * 1e-3, f"route {route!r}: card and CPU params differ")
        require(not any(cpu_launches.values()), "a kernel counted a launch on the CPU")
        require(launches["flash_ce_forward"] + launches["flash_ce_forward_save"] == 3,
                f"route {route!r}: the forward kernel did not run once a step")


def check_flash_ce_save_forward(dev, weight, bias):
    """Row 9's forward against the non-saving kernel and the plain version
    (the (N, V) of CE_CASES): lse and sum of logits bit-equal to the non-saving
    kernel's, a rerun bit-equal, the f32 tail within 1e-5 of the plain
    version's, and the bf16 logits within one bf16 ulp of the plain f32
    logits plus 1e-5 (the two f32 sums of 1024 products, in another order,
    differ by less than that, as the tail shows; where a logit cancels to
    near zero that is more than its own ulp)."""
    from mic_tpu_torch.ops.flash_ce import flash_ce_forward, flash_ce_forward_plain, main_columns

    worst = 0.0
    wf = weight[:main_columns(CE_V)].float()
    for n, v in CE_CASES:
        v_main = main_columns(v)
        tw, tb = weight[:v], bias[:v]
        hidden, labels = _ce_rows(dev, n, n + 2, v)
        out = flash_ce_forward(hidden, tw, tb, labels, save=True)
        again = flash_ce_forward(hidden, tw, tb, labels, save=True)
        stats = flash_ce_forward(hidden, tw, tb, labels)
        ref = flash_ce_forward_plain(hidden, tw, tb, labels, save=True)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(out, again)),
                f"flash_ce_forward save N={n} V={v}: a rerun differs")
        require(all(torch.equal(a, b) for a, b in zip(out[:3], stats)),
                f"flash_ce_forward save N={n} V={v}: statistics differ from the non-saving "
                "kernel's")
        require(out[3].shape == (n, v_main) and out[4].shape == (n, v - v_main),
                f"flash_ce_forward save N={n} V={v}: saved shapes")
        tail_err = (out[4] - ref[4]).abs().max().item()
        require(tail_err < 1e-5, f"flash_ce_forward save N={n} V={v}: tail logits")
        differ, err = 0, 0.0
        for i in range(0, n, 512):
            exact = hidden[i:i + 512].float() @ wf[:v_main].T + bias[:v_main]
            d = (out[3][i:i + 512].float() - exact).abs()
            require(bool((d <= _bf16_ulp(exact) + 1e-5).all()),
                    f"flash_ce_forward save N={n} V={v}: bf16 logits beyond one ulp of the f32 "
                    "logits")
            differ += int((out[3][i:i + 512] != ref[3][i:i + 512]).sum())
            err = max(err, (out[3][i:i + 512].float() - ref[3][i:i + 512].float()).abs().max().item())
            del exact, d
        worst = max(worst, err)
        print(f"flash_ce_forward save N={n} D={CE_D} V={v} v_main={v_main}: statistics "
              f"bit-equal to the non-saving kernel, rerun bit-equal; bf16 logits differing "
              f"from the plain rounding {differ} of {n * v_main} (max abs {err:.3g}), all within "
              f"one ulp of the f32 logits plus 1e-5; tail max_abs_err {tail_err:.3g}", flush=True)
        del out, again, ref
    del wf
    return worst


def _demb_scale(hidden, weight, bias, labels, lse, rs, ls):
    """|dl|^T |h| (V, D) in f32, dl the plain version's bf16 dl from the f32
    logits: what one bf16 rounding of each dl entry can move each demb entry
    by, at most 2^-7 of it."""
    from mic_tpu_torch.ops.flash_ce import flash_ce_dl_plain

    dl = flash_ce_dl_plain(hidden, weight, bias, labels, lse, rs, ls)[0]
    return torch.mm(dl.abs().T, hidden.abs(), out_dtype=torch.float32)


def check_flash_ce_backward_routes(dev, weight, bias):
    """Rows 9 (the save backward, from the kernel's saved logits) and 10 (the
    split backward, whose plain version is the dl route's) against their
    plain versions on the same inputs, N in {64, 4096}, smoothing 0 and
    0.1, rows with rowscale 0.  demb entry by entry within 2^-7 of
    |dl|^T |h| (``_demb_scale``): the two sides round dl to bf16 from f32
    sums in another order, each entry at most one bf16 ulp apart, and the
    f32 accumulation differs far less.  So a label-free vocab row, whose
    demb is small, is held to its own size, not to the label rows'.  dbias
    within 1e-4 of its largest entry, dh within one bf16 ulp of its
    largest; a rerun bit-equal."""
    from mic_tpu_torch.ops.flash_ce import (
        flash_ce_backward, flash_ce_backward_dl_plain, flash_ce_backward_save,
        flash_ce_backward_save_plain, flash_ce_forward,
    )

    worst = {"flash_ce_backward": 0.0, "flash_ce_backward_save": 0.0}
    for n in (64, 4096):
        hidden, labels = _ce_rows(dev, n, n + 3)
        lse, _, _, lg, tail = flash_ce_forward(hidden, weight, bias, labels, save=True)
        rs = torch.rand((n,), generator=torch.Generator(device=dev).manual_seed(n + 4), device=dev)
        rs = rs / n
        rs[::7] = 0.0
        for ls in (0.0, 0.1):
            scale = _demb_scale(hidden, weight, bias, labels, lse, rs, ls)
            for name, fn, plain, extra in (
                    ("flash_ce_backward", flash_ce_backward, flash_ce_backward_dl_plain, ()),
                    ("flash_ce_backward_save", flash_ce_backward_save,
                     flash_ce_backward_save_plain, (lg, tail))):
                out = fn(hidden, weight, bias, labels, lse, rs, ls, None, *extra)
                again = fn(hidden, weight, bias, labels, lse, rs, ls, None, *extra)
                ref = plain(hidden, weight, bias, labels, lse, rs, ls, None, *extra)
                torch.cuda.synchronize()
                require(all(torch.equal(a, b) for a, b in zip(out, again)),
                        f"{name} N={n}: a rerun differs")
                del again
                demb_err = (out[1] - ref[1]).abs()
                demb_ratio = (demb_err / scale).max().item()
                require(bool((demb_err <= 2**-7 * scale).all()),
                        f"{name} N={n} smoothing {ls}: demb beyond 2^-7 |dl|^T |h|")
                errs = []
                for what, got, want, frac in (("dh", out[0], ref[0], 2**-7),
                                              ("dbias", out[2], ref[2], 1e-4)):
                    top = want.float().abs().max().item()
                    err = (got.float() - want.float()).abs().max().item()
                    require(err <= frac * top, f"{name} N={n} smoothing {ls}: {what}")
                    errs.append(err / top)
                worst[name] = max(worst[name], demb_err.max().item())
                print(f"{name} N={n} smoothing={ls}: demb max err / (|dl|^T |h|) "
                      f"{demb_ratio:.3g} (limit 2^-7); max err / max |ref| dh {errs[0]:.3g}, "
                      f"dbias {errs[1]:.3g}; rerun bit-equal", flush=True)
                del out, ref, demb_err
            del scale
        del lg, tail
        torch.cuda.empty_cache()
    return worst


def time_flash_ce_routes(dev, weight, bias):
    """Rows 9 and 10 and their plain versions at N=4096 (medians of 25
    CUDA-event runs), and each contraction kernel alone."""
    from mic_tpu_torch.ops import flash_ce as fce

    n = 4096
    hidden, labels = _ce_rows(dev, n, 11)
    lse, _, _, lg, tail = fce.flash_ce_forward(hidden, weight, bias, labels, save=True)
    rs = torch.full((n,), 1.0 / n, device=dev)
    args = (hidden, weight, bias, labels, lse, rs, 0.1, None)
    t = {
        "fwd_save": median_ms(lambda: fce.flash_ce_forward(hidden, weight, bias, labels,
                                                           save=True)),
        "fwd_save_plain": median_ms(lambda: fce.flash_ce_forward_plain(hidden, weight, bias,
                                                                       labels, save=True)),
        "split": median_ms(lambda: fce.flash_ce_backward(*args)),
        "split_plain": median_ms(lambda: fce.flash_ce_backward_dl_plain(*args)),
        "save": median_ms(lambda: fce.flash_ce_backward_save(*args, lg, tail)),
        "save_plain": median_ms(lambda: fce.flash_ce_backward_save_plain(*args, lg, tail)),
    }
    for route, logits in (("split", None), ("save", lg)):
        for part in ("grad_w", "grad_h"):
            t[f"{part}_{route}"] = median_ms(lambda p=part, lo=logits: fce.flash_ce_contraction(
                p, *args, logits_main=lo))
    for name, key in (("flash_ce_forward save", "fwd_save"), ("flash_ce_backward (split)", "split"),
                      ("flash_ce_backward_save", "save")):
        print(f"{name} time at N={n} D={CE_D} V={CE_V}: kernel {t[key]:.4f} ms, plain "
              f"{t[key + '_plain']:.4f} ms", flush=True)
    bounds = flash_ce_contraction_bounds(n, CE_D, CE_V)
    v_main = fce.main_columns(CE_V)
    for route, vext in (("split", CE_V), ("save", v_main)):
        for part, label in (("grad_w", "grad-W"), ("grad_h", "grad-h")):
            ms = t[f"{part}_{route}"]
            bound_ms = bounds[f"{route} {label}"][0]
            grid = fce._contraction_grid(part, route == "save", n, vext, CE_D, fce._sms(dev))
            loaded = contraction_tma_bytes(part, route == "save", n, vext, CE_D, grid)
            # a split block's two warpgroups each recompute the logits over the full D
            recompute = 2 * grid[0] if route == "split" else 0
            print(f"contraction alone at N={n}: {route} {label} {ms:.4f} ms, bound {bound_ms:.4f} "
                  f"ms ({bound_ms / ms:.1%} of it); grid {grid} (D blocks, row tiles, parts); "
                  f"logits recomputed {recompute}x ({recompute + 1} x 2 N D vext operations); "
                  f"TMA loads {loaded / 1e9:.2f} GB at {loaded / ms / 1e9:.2f} TB/s, mostly "
                  "from L2", flush=True)
    return t


def run_training_routes(dev):
    """The flagship Trainer, TrainConfig defaults with warmup_steps=2, under
    flash_ce "fwd", "split" and "save", and "save" with MIC_TPU_DL_MAX_ROWS=2048
    (below the 4096 rows: the forward saves nothing, the backward is the
    chunked one): six steps each, finite losses, each route's kernels
    launched once a step and no other flash-CE kernel."""
    from mic_tpu_torch.core.config import CaptionerConfig, DataConfig, TrainConfig

    config = CaptionerConfig.clip_vit_b32_mbart50(dtype="bfloat16")
    host = _train_batches(config, 6, 64, DataConfig().max_seq_length, 12)
    expect = {
        "fwd": {"flash_ce_forward": 6},
        "split": {"flash_ce_forward": 6, "flash_ce_backward": 6},
        "save": {"flash_ce_forward_save": 6, "flash_ce_backward_save": 6},
        "save above the row cap": {"flash_ce_forward": 6},
    }
    launches = {}
    for label, want in expect.items():
        env = {"MIC_TPU_DL_MAX_ROWS": "2048"} if "cap" in label else {}
        with knobs(**env):
            t0 = time.perf_counter()
            losses, ms, got, peak, probe, state = _flagship_train_run(
                dev, TrainConfig(warmup_steps=2, flash_ce=label.split()[0]), host)
        print(f"training, flagship width, route {label!r}, 6 steps of 64 x 64: losses {losses}, "
              f"launches {got}, peak allocated {peak:.2f} GiB, probe-batch loss {probe[0]:.6f} "
              f"-> {probe[1]:.6f}; smoke figure (not a benchmark): median of steps 2-6 "
              f"{float(np.median(ms[1:])):.1f} ms (step times {[round(x, 1) for x in ms]} ms; "
              f"{time.perf_counter() - t0:.1f} s with init)", flush=True)
        require(all(np.isfinite(losses)), f"route {label!r}: a non-finite training loss")
        require(got == want, f"route {label!r}: flash-CE launches {got}, expected {want}")
        require(probe[1] < probe[0], f"route {label!r}: the loss on the repeated batch did not "
                                     "fall")
        if label in ("split", "save"):
            launches.update(got)
        del state
        torch.cuda.empty_cache()
    return launches


HEAD_D, HEAD_V = 1024, 250054  # the flagship tied head


def _head_table(dev):
    """A flagship-size bf16 tied embedding and bias, and its int8 form
    (per vocab row scales, ops/quant.py)."""
    from mic_tpu_torch.ops.quant import quantize_array

    g = torch.Generator(device=dev).manual_seed(6)
    weight = (torch.randn((HEAD_V, HEAD_D), generator=g, device=dev) * 0.02).bfloat16()
    bias = (torch.randn((HEAD_V,), generator=g, device=dev) * 0.1).bfloat16()
    wq, ws = quantize_array(weight, axis=1)
    return weight, bias, wq, ws


def _hidden(dev, n, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, d), generator=g, device=dev).bfloat16()


def _near_tie_ids(ids, rids, logits, what):
    """PR 1's rule: an id may differ from the plain version's only where the
    two logits are within 1e-2 (a near tie in bf16 products) -> count."""
    differ = ids != rids
    gap = (logits.gather(1, ids.long()) - logits.gather(1, rids.long())).abs()
    require(bool((gap[differ] < 1e-2).all()), f"{what}: an id differs beyond a near-tie")
    return int(differ.sum())


def check_fused_head_q8_bucket(dev, table):
    """Phase 12: the int8 bucket kernel against its plain version (the same
    bf16 x int8-as-bf16 logits in f32): lse within 1e-3 relative, lp within
    2e-3, ids equal but at near-ties."""
    from mic_tpu_torch.ops.fused_head import _logits_q8_bucket, fused_head_topk_q8, \
        fused_head_topk_q8_plain

    _, bias, wq, ws = table
    worst = 0.0
    for n in (4, 65, 1024):
        hidden = _hidden(dev, n, HEAD_D, 40 + n)
        logits = _logits_q8_bucket(hidden, wq, ws, bias)
        for k in (1, 9):
            lp, ids, lse = fused_head_topk_q8(hidden, wq, ws, bias, k, "bucket")
            rlp, rids, rlse = fused_head_topk_q8_plain(hidden, wq, ws, bias, k, "bucket")
            torch.cuda.synchronize()
            torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)
            torch.testing.assert_close(lp, rlp, rtol=0, atol=2e-3)
            ties = _near_tie_ids(ids, rids, logits, f"fused_head_bucket_q8 N={n} k={k}")
            err = (lp - rlp).abs().max().item()
            worst = max(worst, err)
            print(f"fused_head_bucket_q8 N={n} k={k}: lp max_abs_err={err:.6g}, lse "
                  f"max_rel_err={((lse - rlse).abs() / rlse.abs()).max().item():.3g}, "
                  f"near-tie id differences={ties}", flush=True)
        del logits
    # small integer hidden values: every product and sum is exact on both
    # sides, so the kernel's winners are the plain logits bit for bit
    # (s = acc * ws + b, unfused) and its ids the plain version's; the bias
    # in full f32 (a bf16 bias would make an FMA's rounding the same)
    g = torch.Generator(device=dev).manual_seed(45)
    hidden = torch.randint(-4, 5, (65, HEAD_D), generator=g, device=dev).bfloat16()
    b32 = torch.randn((HEAD_V,), generator=g, device=dev) * 0.1
    logits = _logits_q8_bucket(hidden, wq, ws, b32)
    lp, ids, lse = fused_head_topk_q8(hidden, wq, ws, b32, 9, "bucket")
    rlp, rids, rlse = fused_head_topk_q8_plain(hidden, wq, ws, b32, 9, "bucket")
    torch.cuda.synchronize()
    require(torch.equal(ids, rids), "fused_head_bucket_q8 exact sums: ids differ from plain")
    require(torch.equal(lp, logits.gather(1, ids.long()) - lse),
            "fused_head_bucket_q8 exact sums: a winner's logit differs from plain")
    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=0)
    print("fused_head_bucket_q8 N=65 integer hidden: ids equal, winners' logits bit-equal",
          flush=True)
    return worst


def check_fused_head_select(dev, table):
    """Phase 13: the exact/window select kernels against the plain versions.
    bf16 (row 5: wgmma on both operands in shared memory, fed by TMA) at N
    in {1, 4, 65, 1024}, D in {64, 96 (D % 64 == 32: its last slice half
    TMA zero fill), 1024, 1344 (the largest it takes)}, V in {997, 250054},
    k = 9, and k in {1, 16} at the flagship shape (window: at most the
    vocab's windows), with ``_bf16_head_case``'s tolerances (lp where the
    ids agree).  int8
    (row 6) at D = 1024, N in {1, 4, 65, 1024}, k in {1, 9, 16} and a ragged
    V = 997: the kernel's logits are the plain version's bit for bit, so ids
    are equal, every lp is exactly the plain logit at its id minus the
    kernel's lse (the merge's subtraction), lp within 1e-4 and lse within
    1e-5 relative (sums of 250054 exps in another order).  Then tied logits
    (zero hidden rows: the bias) in both: the lower id first (exact), the
    highest lane in a window (window).  -> the worst lp error, bf16 and int8."""
    from mic_tpu_torch.ops.fused_head import _logits, _logits_q8, fused_head_topk, \
        fused_head_topk_plain, fused_head_topk_q8, fused_head_topk_q8_plain
    from mic_tpu_torch.ops.quant import quantize_rows_dynamic

    weight, bias, wq, ws = table
    cases = [(n, d, v, 9) for n in (1, 4, 65, 1024) for d in (64, 96, HEAD_D, 1344)
             for v in (997, HEAD_V)]
    cases += [(n, HEAD_D, HEAD_V, k) for n in (1, 4, 65, 1024) for k in (1, 16)]
    tables = _bf16_head_cases(dev, [c for c in cases if c[1:3] != (HEAD_D, HEAD_V)], 5)
    tables[HEAD_D, HEAD_V] = weight, bias
    worst_bf16 = worst_q8 = 0.0
    for n, d, v, k in cases:
        w, b = tables[d, v]
        hidden = _hidden(dev, n, d, 50 + n + k)
        logits = _logits(hidden, w, b)
        for select in ("exact", "window"):
            kk = min(k, -(-v // 128)) if select == "window" else k
            got = fused_head_topk(hidden, w, b, kk, select)
            ref = fused_head_topk_plain(hidden, w, b, kk, select)
            torch.cuda.synchronize()
            what = f"fused_head_select bf16 {select} N={n} D={d} V={v} k={kk}"
            err, ties = _bf16_head_case(got, ref, logits, what, False)
            worst_bf16 = max(worst_bf16, err)
            print(f"{what}: lp max_abs_err={err:.6g}, near-tie id differences={ties}",
                  flush=True)
        del logits
    del tables
    q8_cases = [(n, HEAD_V, k) for n in (1, 4, 65, 1024) for k in (1, 9, 16)]
    q8_cases += [(70, 997, 1), (70, 997, 7)]
    for n, v, k in q8_cases:
        hidden = _hidden(dev, n, HEAD_D, 50 + n + k)
        b, q, s = bias[:v], wq[:v], ws[:v]
        logits = _logits_q8(*quantize_rows_dynamic(hidden), q, s, b)
        for select in ("exact", "window"):
            lp, ids, lse = fused_head_topk_q8(hidden, q, s, b, k, select)
            rlp, rids, rlse = fused_head_topk_q8_plain(hidden, q, s, b, k, select)
            torch.cuda.synchronize()
            what = f"fused_head_select int8 {select} N={n} V={v} k={k}"
            require(torch.equal(ids, rids), f"{what}: ids differ from plain")
            require(torch.equal(lp, logits.gather(1, ids.long()) - lse),
                    f"{what}: a candidate's logit differs from plain")
            torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=0)
            torch.testing.assert_close(lp, rlp, rtol=0, atol=1e-4)
            err = (lp - rlp).abs().max().item()
            worst_q8 = max(worst_q8, err)
            print(f"{what}: lp max_abs_err={err:.6g}, lse max_rel_err="
                  f"{((lse - rlse).abs() / rlse.abs()).max().item():.3g}", flush=True)
        del logits
    # ties: zero hidden rows make the logits the bias (int8 rows of zeros too)
    hidden = torch.zeros((4, HEAD_D), device=dev, dtype=torch.bfloat16)
    b = torch.zeros((5000,), device=dev, dtype=torch.bfloat16)
    b[[4900, 40, 300, 2600]] = 3.0
    b[[131, 250, 4999]] = 2.0
    for select, k, want in (("exact", 7, [40, 300, 2600, 4900, 131, 250, 4999]),
                            ("window", 6, [40, 300, 2600, 4900, 250, 4999])):
        for q8 in (False, True):
            ids = (fused_head_topk_q8(hidden, wq[:5000], ws[:5000], b, k, select) if q8
                   else fused_head_topk(hidden, weight[:5000], b, k, select))[1]
            torch.cuda.synchronize()
            require(ids.tolist() == [want] * 4, f"fused_head_select {'int8' if q8 else 'bf16'} "
                    f"{select} ties: ids {ids[0].tolist()}, want {want}")
    print("fused_head_select ties: lower id first (exact), highest lane in a window (window), "
          "bf16 and int8", flush=True)
    return worst_bf16, worst_q8


def check_lazy_attention_q8(dev):
    """Phase 14: the int8-cache attention kernel against its plain version:
    outputs within 2e-2 (bf16 weights, f32 sums in another order), the
    cache's int8 values and scales bit-equal, every column but ``index``
    untouched, a rerun (on the cache the first call wrote) bit-equal; with 1,
    4 and 8 beams at index 0, 1, 17 and T - 1, at the flagship decode shape,
    and at the largest (K, T) the earlier kernel launched; then q = 0 at
    index 63 with V row scales that are powers of two, where every weight
    (1/64 of a scale) and every sum is exact: bit-equal to plain."""
    from mic_tpu_torch.ops.lazy_attention import lazy_attention_q8, lazy_attention_q8_plain

    heads = FLAG_H
    cases = [(FLAG_B, FLAG_K, FLAG_T, index) for index in (0, 1, 17, 63)]
    cases += [(64, beams, FLAG_T, index) for beams in (1, 8) for index in (0, 1, 17, 63)]
    cases += [(2, 32, 192, 191), (1, 1, 6144, 6143)]
    g = torch.Generator(device=dev).manual_seed(8)
    worst = 0.0
    for b, beams, t, index in cases:
        q, ck, cv, ks, vs, anc = _lazy_inputs(dev, g, b, beams, t, heads, index, True)
        before = [{n: a.clone() for n, a in c.items()} for c in (ck, cv)]
        pk, pv = ({n: a.clone() for n, a in c.items()} for c in (ck, cv))
        out = lazy_attention_q8(q, ck, cv, ks, vs, anc, index, heads)
        written = [{n: a.clone() for n, a in c.items()} for c in (ck, cv)]
        again = lazy_attention_q8(q, ck, cv, ks, vs, anc, index, heads)
        ref = lazy_attention_q8_plain(q, pk, pv, ks, vs, anc, index, heads)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
        require(torch.equal(out, again), f"lazy_attention_q8 K={beams} index={index}: a rerun "
                "differs")
        others = torch.arange(t, device=dev) != index
        for mine, plain, old, first in zip((ck, cv), (pk, pv), before, written):
            for name in ("q", "s"):
                require(torch.equal(mine[name], plain[name]), "int8 cache differs from plain")
                require(torch.equal(mine[name], first[name]), "a rerun wrote another column")
                require(torch.equal(mine[name][:, others], old[name][:, others]),
                        "a column other than index was written")
        print(f"lazy_attention_q8 B={b} K={beams} T={t} index={index}: max_abs_err={err:.6g}, "
              "int8 values and scales bit-equal, other columns untouched, rerun bit-equal",
              flush=True)
    b, beams, t, index = 64, FLAG_K, FLAG_T, 63
    q, ck, cv, ks, vs, anc = _lazy_inputs(dev, g, b, beams, t, heads, index, True)
    q = torch.zeros_like(q)
    cv["s"] = torch.exp2(torch.randint(-8, 1, cv["s"].shape, generator=g, device=dev)
                         .float()).contiguous()
    pk, pv = ({n: a.clone() for n, a in c.items()} for c in (ck, cv))
    out = lazy_attention_q8(q, ck, cv, ks, vs, anc, index, heads)
    ref = lazy_attention_q8_plain(q, pk, pv, ks, vs, anc, index, heads)
    torch.cuda.synchronize()
    require(torch.equal(out, ref), "lazy_attention_q8: exact sums differ from plain")
    print(f"lazy_attention_q8 B={b} K={beams} index={index}, q = 0, V scales powers of two: "
          "bit-equal to plain", flush=True)
    return worst


def time_int8_kernels(dev, table):
    """Phase 15: each new kernel and its plain version, medians of 25
    CUDA-event runs: the heads at N in {4, 1024}, k=9, the int8 head also
    in CUDA-graph replays (``t["graph", key]``); then rows 1 and 2 (the
    bf16 and int8 cache) at B=256 K=4 T=64 H=16, index 63 and 17: the
    kernel and the plain version in CUDA-graph replays, the kernel also per
    call with its wrapper (``t["lazy", q8, index]`` = (kernel, plain, per
    call)), and each kernel's share of its bound."""
    from mic_tpu_torch.ops.fused_head import fused_head_topk, fused_head_topk_plain, \
        fused_head_topk_q8, fused_head_topk_q8_plain
    from mic_tpu_torch.ops.lazy_attention import lazy_attention, lazy_attention_plain, \
        lazy_attention_q8, lazy_attention_q8_plain

    weight, bias, wq, ws = table
    t = {}
    for n in (4, 1024):
        hidden = _hidden(dev, n, HEAD_D, 60 + n)
        runs = {
            ("bucket_q8", n): (lambda: fused_head_topk_q8(hidden, wq, ws, bias, 9, "bucket"),
                               lambda: fused_head_topk_q8_plain(hidden, wq, ws, bias, 9, "bucket")),
        }
        for select in ("exact", "window"):
            runs[(f"{select}_q8", n)] = (
                lambda s=select: fused_head_topk_q8(hidden, wq, ws, bias, 9, s),
                lambda s=select: fused_head_topk_q8_plain(hidden, wq, ws, bias, 9, s))
            runs[(f"{select}_bf16", n)] = (
                lambda s=select: fused_head_topk(hidden, weight, bias, 9, s),
                lambda s=select: fused_head_topk_plain(hidden, weight, bias, 9, s))
        for key, (kernel, plain) in runs.items():
            t[key] = (median_ms(kernel), median_ms(plain))
            graph = ""
            if key[0].endswith("_q8"):
                t["graph", key] = graph_ms(kernel)
                graph = f", kernel in graph replays {t['graph', key]:.4f} ms"
            print(f"fused_head {key[0]} time at N={n} D={HEAD_D} V={HEAD_V} k=9: kernel "
                  f"{t[key][0]:.4f} ms, plain {t[key][1]:.4f} ms (per call){graph}", flush=True)
    g = torch.Generator(device=dev).manual_seed(15)
    b, beams, heads, rows = FLAG_B, FLAG_K, FLAG_H, FLAG_B * FLAG_K
    for q8 in (False, True):
        q, ck, cv, ks, vs, anc = _lazy_inputs(dev, g, b, beams, FLAG_T, heads, FLAG_T, q8)
        kernel, plain = ((lazy_attention_q8, lazy_attention_q8_plain) if q8
                         else (lazy_attention, lazy_attention_plain))
        for index in (63, 17):
            args = (q, ck, cv, ks, vs, anc, index, heads)
            t["lazy", q8, index] = (graph_ms(lambda: kernel(*args)), graph_ms(lambda: plain(*args)),
                                    median_ms(lambda: kernel(*args)))
            ms, by = (attention_bound(rows, index, HEAD_D, 1, scale_bytes=4, ancestry=True) if q8
                      else attention_bound(rows, index, HEAD_D, 2, ancestry=True))
            k_ms, p_ms, call_ms = t["lazy", q8, index]
            print(f"lazy_attention{'_q8' if q8 else ''} time at B={b} K={beams} T={FLAG_T} "
                  f"H={heads} index={index}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (graph "
                  f"replays); kernel per call with its wrapper {call_ms:.4f} ms; "
                  f"{100 * ms / k_ms:.1f}% of its bound {ms:.4f} ms ({by})", flush=True)
    return t


def run_int8_path(dev, flag):
    """Phase 16: the flagship int8 path (int8 decoder and head, int8 KV
    cache), 8 images: the default select with launch counts and a second
    run; then the exact and window selects, and a bf16 exact-select run, so
    that every head kernel carries a whole generate; smoke figures."""
    from mic_tpu_torch.models.captioner import Captioner

    config, params, model, kw, pixels = flag
    layers = config.decoder.num_layers
    px = pixels(8, 0)
    q8 = dict(kw, quantize="int8", kv_quant="int8")
    out, counts = drive(model, params, px, **q8)
    seqs = check_path_output(out, 8, 64, "int8 path")
    print(f"int8 path, 8 images, default select: {out.steps} decode steps, launches {counts}",
          flush=True)
    require(counts["lazy_attention_q8"] == layers * out.steps,
            "lazy_attention_q8 launches != layers x decode steps")
    require(counts["fused_head_bucket_q8"] >= out.steps,
            "the int8 bucket head launched less than once a step")
    require(counts["lazy_attention"] == 0 and counts["fused_head"] == 0,
            "a bf16 kernel ran on the int8 path")
    again = model.generate(params, px, **q8)
    require(torch.equal(again.sequences.cpu(), seqs), "int8 path: a second run gave other sequences")
    print("int8 path: second run gave identical sequences", flush=True)
    launches = {"lazy_attention_q8": counts["lazy_attention_q8"],
                "fused_head_bucket_q8": counts["fused_head_bucket_q8"], "fused_head_select": 0,
                "fused_head_select_bf16": 0}
    for select, extra in (("exact", q8), ("window", q8), ("exact", kw)):
        chosen = Captioner(config.replace(decode=config.decode.replace(fused_select=select)))
        out, counts = drive(chosen, params, px, **extra)
        int8 = "quantize" in extra
        label = f"{'int8' if int8 else 'bf16'} path, select {select}"
        check_path_output(out, 8, 64, label)
        print(f"{label}: {out.steps} decode steps, launches {counts}", flush=True)
        require(counts["fused_head_select"] >= out.steps,
                f"{label}: the select kernel launched less than once a step")
        require(counts["fused_head"] == counts["fused_head_bucket_q8"] == 0,
                f"{label}: a bucket kernel ran")
        launches["fused_head_select" if int8 else "fused_head_select_bf16"] += \
            counts["fused_head_select"]
    smoke_figures(model, params, pixels, q8, "int8 weights + int8 KV")
    return launches


def check_int8_small_against_cpu(dev):
    """Phase 17: at a small width (d_model 128, head_dim 64) the int8 trees
    quantized on the card and on the CPU are bit-equal, and int8 generate
    (int8 weights and KV) with the bucket and the exact select gives the
    same sequences on the card (kernels) as on the CPU (plain versions),
    scores within 5e-2 (bf16 activations summed in other orders can move a
    row's int8 rounding by one step)."""
    from mic_tpu_torch.core.config import CaptionerConfig, DecodeConfig, DecoderConfig, VisionConfig
    from mic_tpu_torch.core.params import make_serving_params, tree_leaves, tree_map
    from mic_tpu_torch.models import mbart_decoder
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.image_prep import preprocess_images
    from mic_tpu_torch.ops.quant import quantize_params_for_decode

    def config(select):
        return CaptionerConfig(
            vision=VisionConfig.tiny(),
            decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                                       max_position_embeddings=64),
            decode=DecodeConfig(fused_head="1", fused_select=select), dtype="bfloat16",
        )

    params = make_serving_params(init_params(config("bucket"),
                                             torch.Generator(device=dev).manual_seed(7), dev))
    host = tree_map(lambda x: x.cpu(), params)

    def quantized(p):  # generate's order: compute dtype, fused QKV, int8
        return tree_leaves(quantize_params_for_decode(
            {**p, "decoder": mbart_decoder.fuse_qkv_params(p["decoder"])}))

    card, cpu = quantized(params), quantized(host)
    require([p for p, _ in card] == [p for p, _ in cpu], "quantized trees differ in layout")
    require(all(a.dtype == b.dtype and torch.equal(a.cpu(), b) for (_, a), (_, b) in zip(card, cpu)),
            "the int8 trees quantized on the card and on the CPU differ")
    n_int8 = sum(a.dtype == torch.int8 for _, a in card)
    print(f"small width: the quantized trees on the card and the CPU are bit-equal "
          f"({len(card)} leaves, {n_int8} of them int8)", flush=True)
    u8 = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (4, 40, 40, 3),
                                                            dtype=np.uint8))
    kw = dict(num_beams=4, max_length=16, forced_bos_token_id=7, quantize="int8",
              kv_quant="int8")
    for select in ("bucket", "exact"):
        model = Captioner(config(select))
        gpu = model.generate(params, preprocess_images(u8.to(dev), 32, torch.bfloat16), **kw)
        ref = model.generate(host, preprocess_images(u8, 32, torch.bfloat16), **kw)
        score_err = (gpu.scores.cpu() - ref.scores).abs().max().item()
        same = torch.equal(gpu.sequences.cpu(), ref.sequences)
        print(f"small width, int8 {select} select, card vs CPU: sequences equal={same}, "
              f"max score difference={score_err:.3g}", flush=True)
        require(same, f"int8 {select}: card and CPU sequences differ")
        require(score_err < 5e-2, f"int8 {select}: card and CPU scores differ")


def check_decode_attention(dev):
    """Phase 18: the decode-attention kernel against its plain version at
    the flagship greedy shape (12 layers, B=256 rows, T=64, H=16, Dh=64,
    bf16), layer 5, index in {0, 1, 17, 63}, and at B=4 rows (one image of
    beam 4: the walk split in four, index 15 the first split's last
    position at 63): outputs within 2e-2 (the bf16 output rounded once
    after f32 sums in another order), the written caches bit-equal to the
    plain version's, every other cell untouched."""
    from mic_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain

    layers, t, heads, dh, layer = 12, 64, 16, 64, 5
    g = torch.Generator(device=dev).manual_seed(21)

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    worst = 0.0
    for b, index in [(4, i) for i in (0, 1, 15, 63)] + [(256, i) for i in (0, 1, 17, 63)]:
        q, ks, vs = (rand(b, 1, heads, dh, scale=s) for s in (0.3, 0.5, 0.5))
        ck, cv = rand(layers, b, t, heads, dh), rand(layers, b, t, heads, dh)
        before = (ck.clone(), cv.clone())
        pk, pv = ck.clone(), cv.clone()
        out = decode_attention(q, ks, vs, ck, cv, layer, index)
        ref = decode_attention_plain(q, ks, vs, pk, pv, layer, index)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
        require(torch.equal(ck, pk) and torch.equal(cv, pv), "decode_attention: cache differs "
                "from plain")
        keep = torch.ones((layers, b, t), dtype=torch.bool, device=dev)
        keep[layer, :, index] = False
        require(all(torch.equal(c[keep], o[keep]) for c, o in zip((ck, cv), before)),
                "decode_attention: a cell other than [layer, :, index] was written")
        print(f"decode_attention B={b} index={index}: max_abs_err={err:.6g}, cache bit-equal, "
              "other layers and columns untouched", flush=True)
        del before
    return worst, (q, ks, vs, ck, cv, pk, pv, layer)


def planted_logits(g, n, v, offset, dtype):
    """(n, v) logits starting ``offset`` elements past an aligned address
    (rows of every 16-byte alignment as the rows go), each row with 16
    values from 60, 59, ..., 45 planted above the N(0, 4) rest (exact in
    bf16): rows r % 4 == 0 in their first 8 and last 8 columns (the largest
    in a column that moves with r), rows r % 4 == 1 on both sides of up to 8
    of their run boundaries (columns j c - 1 and j c, c the columns of a
    run where one wave holds every row's most runs, as it does at N=24) and
    the rest inside, rows r % 4 == 2 inside, rows r % 4 == 3 with their
    largest value twice, in the last column and 40 columns before it (the
    last run peels the one and walks the other: the lower id must win at
    k=1); rows r % 8 in {1, 2} a third -inf.  -> (logits, the planted
    columns (n, 16) in rank order)."""
    from mic_tpu_torch.ops.topk_lse import _RUN_COLS

    x = torch.randn((n * v + offset,), generator=g, device=g.device)[offset:].view(n, v) * 2
    c = -(-v // -(-v // _RUN_COLS))
    bounds = [j * c for j in range(1, -(-v // c))] or [v // 2]
    cols = torch.empty((n, 16), dtype=torch.int64)
    values = torch.arange(60.0, 44.0, -1.0)
    for r in range(n):
        kind, vals = r % 4, values
        if kind == 0:
            edge = list(range(8)) + list(range(v - 8, v))
            turn = r // 4 * 3 % 16
            picked = edge[turn:] + edge[:turn]
        elif kind == 1:
            at = [bounds[(r + i) % len(bounds)] for i in range(min(8, len(bounds)))]
            picked = [col for b in at for col in (b - 1, b)]
            picked += [v // 3 + 7 * i for i in range(16 - len(picked))]
        elif kind == 2:
            picked = [v // 5 + r + 13 * i for i in range(16)]
        else:
            picked = [v - 41, v - 1] + [v // 4 + 5 * i for i in range(14)]
            vals = torch.cat([values[:1], values[:15]])
        if r % 8 in (1, 2):
            x[r, ::3] = -torch.inf
        cols[r] = torch.tensor(picked)
        x[r, cols[r].to(x.device)] = vals.to(x.device)
    out = torch.empty((n * v + offset,), dtype=dtype, device=x.device)[offset:].view(n, v)
    out.copy_(x)
    return out, cols


def check_topk_lse(dev):
    """Phase 19: the top-k + logsumexp kernel against its plain version at N
    in {4, 256, 1024}, V=250054, and at V=997 with ties (a constant row, a
    repeated maximum, integer logits), k in {1, 2, 9, 13}, bf16 and f32; and
    on ``planted_logits`` rows (V in {997, 20011, 250054}, N=24, offsets
    0-7 elements, k in {1, 9, 16}): ids equal, log-probs within 1e-5 (the
    same f32 values; the logsumexp of up to 250054 exps summed in another
    order, about 1e-6 an ulp at 12), the planted columns found, reruns
    bit-equal."""
    from mic_tpu_torch.ops.topk_lse import topk_log_probs, topk_log_probs_plain

    g = torch.Generator(device=dev).manual_seed(22)
    worst = 0.0
    for n, v in [(n, HEAD_V) for n in (4, 256, 1024)] + [(70, 997)]:
        logits = torch.randn((n, v), generator=g, device=dev) * 2
        if v == 997:
            logits[0] = 0.0
            logits[1, [900, 5, 300]] = 9.0
            logits[2] = torch.round(logits[2] * 2)
        for dtype in (torch.bfloat16, torch.float32):
            x = logits.to(dtype)
            errs = []
            for k in (1, 2, 9, 13):
                lp, ids = topk_log_probs(x, k)
                rlp, rids = topk_log_probs_plain(x, k)
                torch.cuda.synchronize()
                what = f"topk_log_probs N={n} V={v} k={k} {dtype}"
                require(torch.equal(ids, rids), f"{what}: ids differ from plain")
                errs.append((lp - rlp).abs().max().item())
                require(errs[-1] <= 1e-5, f"{what}: log-probs differ from plain")
            worst = max(worst, *errs)
            print(f"topk_log_probs N={n} V={v} {dtype}: k in (1, 2, 9, 13) ids equal, lp "
                  f"max_abs_err {errs}", flush=True)
        del logits, x
    for v in (997, 20011, HEAD_V):
        for dtype in (torch.bfloat16, torch.float32):
            errs = []
            for offset in range(8):
                x, cols = planted_logits(g, 24, v, offset, dtype)
                for k in (1, 9, 16):
                    lp, ids = topk_log_probs(x, k)
                    lp2, ids2 = topk_log_probs(x, k)
                    rlp, rids = topk_log_probs_plain(x, k)
                    torch.cuda.synchronize()
                    what = f"topk_log_probs planted V={v} offset={offset} k={k} {dtype}"
                    require(torch.equal(ids, rids), f"{what}: ids differ from plain")
                    require(torch.equal(ids.cpu().long(), cols[:, :k]),
                            f"{what}: a planted column was missed")
                    require(torch.equal(lp, lp2) and torch.equal(ids, ids2),
                            f"{what}: a rerun differs")
                    errs.append((lp - rlp).abs().max().item())
                    require(errs[-1] <= 1e-5, f"{what}: log-probs differ from plain")
            worst = max(worst, *errs)
            print(f"topk_log_probs planted rows N=24 V={v} {dtype}, offsets 0-7, k in "
                  f"(1, 9, 16): ids equal and the planted columns, reruns bit-equal, lp "
                  f"max_abs_err {max(errs):.3g}", flush=True)
    return worst


def time_greedy_kernels(dev, attn_inputs):
    """Phase 20: both kernels and their plain versions beside a library
    yardstick: scaled_dot_product_attention over the same live prefix (it
    writes no column), and torch.topk + torch.logsumexp as two calls (no
    single call computes both).  Device times from CUDA-graph replays
    (``graph_ms``), and each kernel's time per call with its wrapper's host
    work (``median_ms``, as phases 4, 9 and 15 time)."""
    import torch.nn.functional as F

    from mic_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from mic_tpu_torch.ops.topk_lse import topk_log_probs, topk_log_probs_plain

    q, ks, vs, ck, cv, pk, pv, layer = attn_inputs
    index = 63
    qh = q.transpose(1, 2)                                 # (B, H, 1, Dh)
    kh, vh = (c[layer, :, :index + 1].transpose(1, 2) for c in (ck, cv))
    lib = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0).transpose(1, 2)
    ref = decode_attention_plain(q, ks, vs, pk, pv, layer, index)
    torch.testing.assert_close(lib.float(), ref.float(), rtol=2e-2, atol=2e-2)
    t = {"decode": (graph_ms(lambda: decode_attention(q, ks, vs, ck, cv, layer, index)),
                    graph_ms(lambda: decode_attention_plain(q, ks, vs, pk, pv, layer, index)),
                    graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)),
                    median_ms(lambda: decode_attention(q, ks, vs, ck, cv, layer, index)))}
    print(f"decode_attention time at L=12 B=256 T=64 H=16 index={index}: kernel "
          f"{t['decode'][0]:.4f} ms, plain {t['decode'][1]:.4f} ms, "
          f"scaled_dot_product_attention over the live prefix {t['decode'][2]:.4f} ms "
          f"(graph replays); kernel per call with its wrapper {t['decode'][3]:.4f} ms",
          flush=True)
    # one image of beam 4: N=4 rows, the walk split in four
    few = [x[:4].clone() for x in (q, ks, vs)] + [c[:, :4].clone() for c in (ck, cv)]
    q4, ks4, vs4, ck4, cv4 = few
    pk4, pv4 = ck4.clone(), cv4.clone()
    qh4 = q4.transpose(1, 2)
    kh4, vh4 = (c[layer, :, :index + 1].transpose(1, 2) for c in (ck4, cv4))
    t["decode4"] = (graph_ms(lambda: decode_attention(q4, ks4, vs4, ck4, cv4, layer, index)),
                    graph_ms(lambda: decode_attention_plain(q4, ks4, vs4, pk4, pv4, layer, index)),
                    graph_ms(lambda: F.scaled_dot_product_attention(qh4, kh4, vh4, scale=1.0)),
                    median_ms(lambda: decode_attention(q4, ks4, vs4, ck4, cv4, layer, index)))
    print(f"decode_attention time at L=12 B=4 T=64 H=16 index={index}: kernel "
          f"{t['decode4'][0]:.4f} ms, plain {t['decode4'][1]:.4f} ms, "
          f"scaled_dot_product_attention over the live prefix {t['decode4'][2]:.4f} ms "
          f"(graph replays); kernel per call with its wrapper {t['decode4'][3]:.4f} ms",
          flush=True)
    g = torch.Generator(device=dev).manual_seed(23)
    for n, k in ((4, 2), (256, 2), (256, 9), (1024, 2), (1024, 9)):
        x = (torch.randn((n, HEAD_V), generator=g, device=dev) * 2).bfloat16()
        t[("topk", n, k)] = (graph_ms(lambda: topk_log_probs(x, k)),
                             graph_ms(lambda: topk_log_probs_plain(x, k)),
                             graph_ms(lambda: (torch.topk(x, k), torch.logsumexp(x, dim=-1))),
                             median_ms(lambda: topk_log_probs(x, k)))
        kernel, plain, two, per_call = t[("topk", n, k)]
        print(f"topk_log_probs time at N={n} V={HEAD_V} k={k} bf16: kernel {kernel:.4f} ms, "
              f"plain {plain:.4f} ms, torch.topk + torch.logsumexp (two calls, bf16 lse) "
              f"{two:.4f} ms (graph replays); kernel per call with its wrapper {per_call:.4f} ms",
              flush=True)
    return t


def check_pinned(seqs, eos_positions, eos, pad, what):
    for row, pos in zip(seqs.tolist(), eos_positions.tolist()):
        require(row[pos] == eos and eos not in row[1:pos] and set(row[pos + 1:]) <= {pad},
                f"{what}: a row does not end in EOS exactly at its pinned position")


def run_greedy_path(dev, flag):
    """Phase 21: greedy and sampling through Captioner.generate at flagship
    width, 8 images: the default (the bucket head, k=2); the dense logits
    under fused_decode,pallas_topk (decode_attention 12 times a step,
    topk_log_probs once a step but on the forced BOS and EOS steps);
    sampling with pinned EOS positions under fused_decode (twice from one
    seed) and with the default knobs; then B=1 and B=256 greedy smoke
    figures."""
    config, params, model, kw, pixels = flag
    layers, dec, gen = config.decoder.num_layers, config.decoder, config.generation
    px = pixels(8, 0)
    greedy = dict(kw, num_beams=1)
    out, counts = drive(model, params, px, **greedy)
    seqs = check_path_output(out, 8, 64, "greedy path")
    print(f"greedy path, 8 images, default knobs: {out.steps} decode steps, launches {counts}",
          flush=True)
    require(counts["fused_head"] == out.steps, "greedy: the bucket head not once a step")
    require(counts["decode_attention"] == counts["topk_log_probs"] == counts["lazy_attention"] == 0,
            "greedy, default knobs: another kernel ran")

    with knobs(MIC_TPU_EXPERIMENTAL="fused_decode,pallas_topk", MIC_TPU_FUSED_HEAD="0"):
        out, counts = drive(model, params, px, **greedy)
        again = model.generate(params, px, **greedy)
    dense = check_path_output(out, 8, 64, "greedy, fused_decode,pallas_topk")
    forced_at = [1] + ([gen.max_length - 1] if gen.forced_eos_token_id is not None else [])
    forced = sum(1 for pos in forced_at if pos <= out.steps)
    print(f"greedy path, 8 images, fused_decode,pallas_topk, dense logits: {out.steps} decode "
          f"steps ({forced} forced), launches {counts}; tokens equal to the default knobs' "
          f"{float((dense == seqs).float().mean()):.4f}", flush=True)
    require(counts["decode_attention"] == layers * out.steps,
            "decode_attention launches != layers x decode steps")
    require(counts["topk_log_probs"] == out.steps - forced,
            "topk_log_probs launches != non-forced decode steps")
    require(counts["fused_head"] == 0, "the fused head ran with MIC_TPU_FUSED_HEAD=0")
    require(torch.equal(again.sequences.cpu(), dense), "greedy: a second run gave other sequences")
    launches = {"decode_attention": counts["decode_attention"],
                "topk_log_probs": counts["topk_log_probs"]}

    eos_positions = torch.tensor([2, 5, 9, 14, 20, 27, 33, 40], device=dev)
    sample = dict(kw, num_beams=1, do_sample=True, temperature=0.7, top_k=50, top_p=0.9,
                  eos_positions=eos_positions)
    with knobs(MIC_TPU_EXPERIMENTAL="fused_decode"):
        runs = [drive(model, params, px, generator=torch.Generator(device=dev).manual_seed(5),
                      **sample) for _ in range(2)]
    for (out, counts), what in zip(runs, ("sampling run 1", "sampling run 2")):
        check_pinned(check_path_output(out, 8, 64, what), eos_positions.cpu(), dec.eos_token_id,
                     dec.pad_token_id, what)
        require(out.steps == 40 and counts["decode_attention"] == layers * out.steps,
                f"{what}: {out.steps} steps, {counts['decode_attention']} decode_attention "
                "launches")
    require(torch.equal(runs[0][0].sequences, runs[1][0].sequences),
            "sampling: two runs from one seed differ")
    out = model.generate(params, px, torch.Generator(device=dev).manual_seed(6), **sample)
    check_pinned(check_path_output(out, 8, 64, "sampling, default knobs"), eos_positions.cpu(),
                 dec.eos_token_id, dec.pad_token_id, "sampling, default knobs")
    print(f"sampling (temperature 0.7, top_k 50, top_p 0.9), 8 images, EOS pinned at "
          f"{eos_positions.tolist()}: {runs[0][0].steps} steps, every row ends there, "
          f"decode_attention launches {runs[0][1]['decode_attention']}, two runs from one seed "
          "equal; the default knobs' run ends there too", flush=True)
    smoke_figures(model, params, pixels, greedy, "bf16 greedy")
    return launches


def check_greedy_small_against_cpu(dev):
    """Phase 22: greedy at a small width (d_model 128, head_dim 64) on the
    card against the CPU on the same bf16 weights, with the bucket head and
    with the dense logits under fused_decode,pallas_topk: equal sequences,
    scores within 2e-2 (bf16 activations rounded in other orders)."""
    from mic_tpu_torch.core.config import CaptionerConfig, DecodeConfig, DecoderConfig, VisionConfig
    from mic_tpu_torch.core.params import make_serving_params, tree_map
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.image_prep import preprocess_images

    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                                   max_position_embeddings=64),
        decode=DecodeConfig(fused_head="1", fused_select="bucket"),
        dtype="bfloat16",
    )
    params = make_serving_params(init_params(config, torch.Generator(device=dev).manual_seed(24),
                                             dev))
    host = tree_map(lambda x: x.cpu(), params)
    u8 = torch.from_numpy(np.random.default_rng(25).integers(0, 256, (4, 40, 40, 3),
                                                             dtype=np.uint8))
    kw = dict(num_beams=1, max_length=16, forced_bos_token_id=7)
    model = Captioner(config)
    for label, env, kernels in (
            ("bucket head", {}, ("fused_head",)),
            ("fused_decode,pallas_topk", {"MIC_TPU_EXPERIMENTAL": "fused_decode,pallas_topk",
                                          "MIC_TPU_FUSED_HEAD": "0"},
             ("decode_attention", "topk_log_probs"))):
        with knobs(**env):
            gpu, counts = drive(model, params, preprocess_images(u8.to(dev), 32, torch.bfloat16),
                                **kw)
            cpu = model.generate(host, preprocess_images(u8, 32, torch.bfloat16), **kw)
        score_err = (gpu.scores.cpu() - cpu.scores).abs().max().item()
        same = torch.equal(gpu.sequences.cpu(), cpu.sequences)
        print(f"small width, greedy, {label}, card vs CPU: sequences equal={same}, max score "
              f"difference={score_err:.3g}, card launches {counts}", flush=True)
        require(all(counts[name] > 0 for name in kernels), f"greedy {label}: a kernel never ran")
        require(same, f"greedy {label}: card and CPU sequences differ")
        require(score_err < 2e-2, f"greedy {label}: card and CPU scores differ")


FLAG_B, FLAG_K, FLAG_T, FLAG_H, FLAG_DH, FLAG_S = 256, 4, 64, 16, 64, 50  # the flagship step
FUSED_STEP = dict(MIC_TPU_FUSED_LAZY_ATTN="1",
                  MIC_TPU_EXPERIMENTAL="fused_cross_attn,fused_mlp,ln_qkv")


def check_blocked_attention(dev):
    """Phase 23: the blocked lazy-attention kernel against its plain version
    at the flagship decode shape, on the bf16 cache and on the int8 cache
    with a scale per (row, position, head), index in {0, 1, 17, 63}, and
    with eight beams (B=128, N=1024 rows) at index 17 and 63: outputs
    within 2e-2 (bf16 weights and outputs after f32 sums in another order),
    a rerun bit-equal, the caches byte-identical before and after the
    launch; then on a mask of random bits with q = 0 and integer V values
    (every admitted weight 1 / (live rows + 1), the same f32 quotient in
    both versions, and every sum exact) bit-equal to the plain version."""
    from mic_tpu_torch.ops.lazy_attention import (
        build_ancestry_mask, fused_lazy_attention, fused_lazy_attention_plain,
    )
    from mic_tpu_torch.ops.quant import quantize_rows_dynamic

    t, heads, dh = FLAG_T, FLAG_H, FLAG_DH
    hd = heads * dh
    g = torch.Generator(device=dev).manual_seed(31)

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    def cache(b, beams, q8):
        if not q8:
            return rand(b * beams, t, hd)
        values, scales = quantize_rows_dynamic(rand(b * beams, t, heads, dh))
        return {"q": values.reshape(b * beams, t, hd), "s": scales[..., 0].contiguous()}

    worst = 0.0
    inputs = {}
    cases = [(FLAG_B, FLAG_K, index) for index in (0, 1, 17, 63)]
    cases += [(FLAG_B // 2, 8, index) for index in (17, 63)]
    for q8 in (False, True):
        for b, beams, index in cases:
            q, ks, vs = rand(b, beams, hd, scale=0.3), rand(b, beams, hd), rand(b, beams, hd)
            ck, cv = cache(b, beams, q8), cache(b, beams, q8)
            anc = torch.randint(0, beams, (b, beams, t), generator=g, device=dev,
                                dtype=torch.int32)
            amask = build_ancestry_mask(anc, index)
            planes = [a for c in (ck, cv) for a in (c.values() if q8 else (c,))]
            before = [a.clone() for a in planes]
            out = fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads, positions=index)
            again = fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads, positions=index)
            ref = fused_lazy_attention_plain(q, ck, cv, ks, vs, amask, beams, heads)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            worst = max(worst, err)
            torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
            require(torch.equal(out, again), f"fused_lazy_attention K={beams} index={index}: a "
                    "rerun differs")
            require(all(torch.equal(a, o) for a, o in zip(planes, before)),
                    "fused_lazy_attention wrote a cache it only reads")
            print(f"fused_lazy_attention {'int8 per-head' if q8 else 'bf16'} B={b} K={beams} "
                  f"index={index}: max_abs_err={err:.6g}, rerun bit-equal, caches byte-identical "
                  "before and after", flush=True)
            del before
            if beams == FLAG_K and index == 63:
                inputs[q8] = (q, ck, cv, ks, vs, amask)
        # q = 0 and integer V: every sum exact, so bit-equal to plain
        b, beams, index = FLAG_B, FLAG_K, 63
        q = torch.zeros((b, beams, hd), dtype=torch.bfloat16, device=dev)
        ks = rand(b, beams, hd)
        vs = torch.randint(-3, 4, (b, beams, hd), generator=g, device=dev).bfloat16()
        values = torch.randint(-3, 4, (b * beams, t, hd), generator=g, device=dev)
        ck = cache(b, beams, q8)
        cv = ({"q": values.to(torch.int8),
               "s": torch.randint(1, 3, (b * beams, t, heads), generator=g, device=dev).float()}
              if q8 else values.bfloat16())
        # random bits (several source rows live for one beam at one
        # position): every beam a different count of live rows
        live = (torch.arange(t, device=dev) < index).repeat(beams)[None, :, None]
        amask = (torch.randint(0, 2, (b, beams * t, beams), generator=g, device=dev)
                 * live).to(torch.int8)
        out = fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads, positions=index)
        ref = fused_lazy_attention_plain(q, ck, cv, ks, vs, amask, beams, heads)
        torch.cuda.synchronize()
        require(torch.equal(out, ref), f"fused_lazy_attention {'int8' if q8 else 'bf16'}: exact "
                "sums not bit-equal to plain")
        print(f"fused_lazy_attention {'int8 per-head' if q8 else 'bf16'} index=63, random-bit "
              "mask, q = 0 and integer V (exact sums): bit-equal to plain", flush=True)
    return worst, inputs


CROSS_BEAMS = (FLAG_K, 1, 9, 16, 33)  # the flagship's first; 33: three tiles of 16
CROSS_S = (FLAG_S, 37, 1, 64)


def _cross_case(dev, g, beams, s, exact=False):
    """q (B, K, H*Dh) and (B, S, H, Dh) K/V at B=256 H=16; with ``exact`` q
    = 0 (every weight 1/S) and integer V, so every sum of the V product is
    exact."""
    q = (torch.randn((FLAG_B, beams, FLAG_H * FLAG_DH), generator=g, device=dev) * 0.3
         ).bfloat16()
    ek, ev = ((torch.randn((FLAG_B, s, FLAG_H, FLAG_DH), generator=g, device=dev) * 0.5
               ).bfloat16() for _ in range(2))
    if exact:
        q.zero_()
        ev = torch.randint(-8, 9, ev.shape, generator=g, device=dev).bfloat16()
    return q, ek, ev


def _held(name, out, again, ref):
    """Within 2e-2 of plain and a rerun bit-equal -> the largest error."""
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2, msg=name)
    require(torch.equal(out, again), f"{name}: a rerun differs")
    return (out.float() - ref.float()).abs().max().item()


def check_cross_attention(dev):
    """Phase 24: the cross-attention kernel against its plain version at
    B=256, H=16, beams {4, 1, 9, 16, 33} and S {50, 37, 1, 64}: outputs within
    2e-2, reruns bit-equal; bit-equal to plain where every sum is exact (q =
    0, integer V) at 4 and 16 beams."""
    from mic_tpu_torch.ops.cross_attention import (
        fused_cross_attention, fused_cross_attention_plain,
    )

    heads = FLAG_H
    g = torch.Generator(device=dev).manual_seed(32)
    worst = 0.0
    for beams in CROSS_BEAMS:
        for s in CROSS_S:
            q, ek, ev = _cross_case(dev, g, beams, s)
            err = _held(f"fused_cross_attention K={beams} S={s}",
                        fused_cross_attention(q, ek, ev, beams, heads),
                        fused_cross_attention(q, ek, ev, beams, heads),
                        fused_cross_attention_plain(q, ek, ev, beams, heads))
            worst = max(worst, err)
            if (beams, s) == (FLAG_K, FLAG_S):
                inputs = (q, ek, ev)
        print(f"fused_cross_attention B={FLAG_B} K={beams} S in {CROSS_S}: max_abs_err="
              f"{worst:.6g} (so far), reruns bit-equal", flush=True)
    for beams in (FLAG_K, 16):
        q, ek, ev = _cross_case(dev, g, beams, FLAG_S, exact=True)
        out = fused_cross_attention(q, ek, ev, beams, heads)
        torch.cuda.synchronize()
        require(torch.equal(out, fused_cross_attention_plain(q, ek, ev, beams, heads)),
                f"fused_cross_attention K={beams}: not bit-equal to plain on exact sums")
    print("fused_cross_attention exact sums (q = 0, integer V), K in (4, 16): bit-equal to "
          "plain", flush=True)
    return worst, inputs


def check_ln_gemm(dev):
    """Phase 25: the LN -> GEMM kernel against its plain version at N in {1,
    8, 32, 70, 129, 1024} and (D, O) in {(256, 384), (160, 192), (1024,
    3072)} (160: a slice half past D): every output within two bf16 ulps of
    the size of its terms (|product| + |bias|: the product and the bias add
    each rounded once to bf16) plus 2**-8 of sum |xn| |w| (the LayerNorm's
    f32 statistics, summed in another order, can round any bf16 xn the
    other way); a rerun bit-equal; the output a view of the first N rows of
    a larger buffer whose rows past N keep their sentinel."""
    import torch.nn.functional as F

    from mic_tpu_torch.ops.ln_gemm import ln_gemm, ln_gemm_plain

    g = torch.Generator(device=dev).manual_seed(33)

    def rand(*shape, scale):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    worst = 0.0
    for d, o in ((256, 384), (160, 192), (HEAD_D, 3 * HEAD_D)):
        scale = (1 + 0.1 * torch.randn((d,), generator=g, device=dev)).bfloat16()
        shift, w, bias = rand(d, scale=0.1), rand(d, o, scale=0.03), rand(o, scale=0.1)
        for n in (1, 8, 32, 70, 129, 1024):
            x = rand(n, d, scale=1.0) + 0.5
            buf = torch.full((n + 128, o), 7.0, dtype=torch.bfloat16, device=dev)
            out = ln_gemm(x, scale, shift, w, bias, out=buf[:n])
            again = ln_gemm(x, scale, shift, w, bias)
            ref = ln_gemm_plain(x, scale, shift, w, bias)
            torch.cuda.synchronize()
            terms = (ref.float() - bias.float()).abs() + bias.float().abs()
            l1 = F.layer_norm(x.float(), (d,), scale.float(), shift.float()).abs() @ w.float().abs()
            diff = (out.float() - ref.float()).abs()
            beyond = diff > 2 * _bf16_ulp(terms.bfloat16())
            require(bool((diff <= 2 * _bf16_ulp(terms.bfloat16()) + 2.0**-8 * l1).all()),
                    f"ln_gemm N={n} D={d} O={o}: an output beyond its bound")
            require(torch.equal(out, again), f"ln_gemm N={n} D={d} O={o}: a rerun differs")
            require(bool((buf[n:] == 7.0).all()), f"ln_gemm N={n} D={d} O={o}: a row past N "
                    "was written")
            if d == HEAD_D:
                worst = max(worst, diff.max().item())
            print(f"ln_gemm N={n} D={d} O={o}: max_abs_err={diff.max().item():.6g} (largest "
                  f"|out| {ref.float().abs().max().item():.4g}), {int(beyond.sum())} of "
                  f"{diff.numel()} outputs beyond two ulps of their terms (all within the xn "
                  "rounding bound), rerun bit-equal, no row past N written", flush=True)
    return worst, (scale, shift, w, bias)


def check_fused_mlp(dev):
    """Phase 26: the fused MLP kernel against its plain version at N in
    {1024, 70, 8, 32}, D=1024, F=4096: outputs within 1e-2 of the largest
    (fc1's bf16 intermediate can round the other way before the 4096-term
    fc2 sum); a rerun bit-equal; where N is not a multiple of the 128-row
    tile the output also written into the first rows of a larger buffer
    whose rows past N keep their sentinel; at N=32 the other activations
    too."""
    from mic_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain

    d, f = HEAD_D, 4 * HEAD_D
    g = torch.Generator(device=dev).manual_seed(34)

    def rand(*shape, scale):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    w1, b1, w2, b2 = rand(d, f, scale=0.03), rand(f, scale=0.1), rand(f, d, scale=0.02), \
        rand(d, scale=0.1)
    worst = 0.0
    for n in (1024, 70, 8, 32):
        x = rand(n, d, scale=1.0)
        out = fused_mlp(x, w1, b1, w2, b2)
        again = fused_mlp(x, w1, b1, w2, b2)
        ref = fused_mlp_plain(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        require(err <= 1e-2 * top, f"fused_mlp N={n}: {err} beyond 1e-2 of {top}")
        require(torch.equal(out, again), f"fused_mlp N={n}: a rerun differs")
        worst = max(worst, err)
        print(f"fused_mlp N={n} D={d} F={f}: max_abs_err={err:.6g} (largest |out| {top:.4g}), "
              "rerun bit-equal", flush=True)
        if n % 128:
            buf = torch.full((n + 128, d), 7.0, dtype=torch.bfloat16, device=dev)
            fused_mlp(x, w1, b1, w2, b2, out=buf[:n])
            torch.cuda.synchronize()
            require(torch.equal(buf[:n], out) and bool((buf[n:] == 7.0).all()),
                    f"fused_mlp N={n}: a row past N written, or the rows not the kernel's")
            print(f"fused_mlp N={n}: into the first rows of a ({n + 128}, {d}) buffer, the rows "
                  "past N untouched", flush=True)
    for act in ("gelu_tanh", "quick_gelu", "relu", "silu"):  # the epilogue's other activations
        out = fused_mlp(x, w1, b1, w2, b2, act)
        ref = fused_mlp_plain(x, w1, b1, w2, b2, act)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        require(err <= 1e-2 * top, f"fused_mlp {act} N={n}: {err} beyond 1e-2 of {top}")
        print(f"fused_mlp {act} N={n}: max_abs_err={err:.6g} (largest |out| {top:.4g})",
              flush=True)
    return worst, (w1, b1, w2, b2)


def time_fused_step_kernels(dev, attn_inputs, cross_inputs, ln_inputs, mlp_inputs):
    """Phase 27: each kernel of the fused beam step in CUDA-graph replays
    (``graph_ms``) and per call with its wrapper (``median_ms``), beside its
    plain version's replays and a library yardstick where one PyTorch call
    computes the same function (or, for LN -> GEMM and the MLP, the chain
    of calls), and the blocked attention's, LN -> GEMM's and the MLP's
    replays as a share of their bounds."""
    import torch.nn.functional as F

    from mic_tpu_torch.ops.cross_attention import (
        fused_cross_attention, fused_cross_attention_plain,
    )
    from mic_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain
    from mic_tpu_torch.ops.lazy_attention import fused_lazy_attention, fused_lazy_attention_plain
    from mic_tpu_torch.ops.ln_gemm import ln_gemm, ln_gemm_plain

    beams, heads = FLAG_K, FLAG_H
    t = {}
    for q8, (q, ck, cv, ks, vs, amask) in attn_inputs.items():
        t[("attn", q8)] = (
            graph_ms(lambda: fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads,
                                                  positions=63)),
            graph_ms(lambda: fused_lazy_attention_plain(q, ck, cv, ks, vs, amask, beams, heads)),
            None,
            median_ms(lambda: fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads,
                                                   positions=63)))
    q, ek, ev = cross_inputs
    qh = q.reshape(FLAG_B, beams, heads, FLAG_DH).transpose(1, 2)
    kh, vh = (c.transpose(1, 2) for c in (ek, ev))
    lib = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0).transpose(1, 2)
    torch.testing.assert_close(lib.reshape(q.shape).float(),
                               fused_cross_attention_plain(q, ek, ev, beams, heads).float(),
                               rtol=2e-2, atol=2e-2)
    t["cross"] = (graph_ms(lambda: fused_cross_attention(q, ek, ev, beams, heads)),
                  graph_ms(lambda: fused_cross_attention_plain(q, ek, ev, beams, heads)),
                  graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)),
                  median_ms(lambda: fused_cross_attention(q, ek, ev, beams, heads)))
    scale, shift, w, bias = ln_inputs
    w1, b1, w2, b2 = mlp_inputs
    wt, w1t, w2t = w.t(), w1.t(), w2.t()
    g = torch.Generator(device=dev).manual_seed(35)
    for n in (1024, 32):
        x = torch.randn((n, HEAD_D), generator=g, device=dev).bfloat16()
        t[("ln", n)] = (
            graph_ms(lambda: ln_gemm(x, scale, shift, w, bias)),
            graph_ms(lambda: ln_gemm_plain(x, scale, shift, w, bias)),
            graph_ms(lambda: F.linear(F.layer_norm(x, (HEAD_D,), scale, shift, 1e-5), wt, bias)),
            median_ms(lambda: ln_gemm(x, scale, shift, w, bias)))
        t[("mlp", n)] = (
            graph_ms(lambda: fused_mlp(x, w1, b1, w2, b2)),
            graph_ms(lambda: fused_mlp_plain(x, w1, b1, w2, b2)),
            graph_ms(lambda: F.linear(F.gelu(F.linear(x, w1t, b1)), w2t, b2)),
            median_ms(lambda: fused_mlp(x, w1, b1, w2, b2)))
    labels = {("attn", False): "fused_lazy_attention bf16 B=256 K=4 T=64 H=16 index=63",
              ("attn", True): "fused_lazy_attention int8 per-head B=256 K=4 T=64 H=16 index=63",
              "cross": "fused_cross_attention B=256 K=4 S=50 H=16",
              ("ln", 1024): "ln_gemm N=1024 D=1024 O=3072", ("ln", 32): "ln_gemm N=32",
              ("mlp", 1024): "fused_mlp N=1024 D=1024 F=4096", ("mlp", 32): "fused_mlp N=32"}
    library = {"cross": "scaled_dot_product_attention", "ln": "F.layer_norm + F.linear",
               "mlp": "F.linear -> F.gelu -> F.linear"}
    # the (image, source row, position) rows some beam admits in the timed masks
    live_rows = {q8: int((inputs[-1] != 0).any(-1).sum()) for q8, inputs in attn_inputs.items()}
    bounds = {("attn", False): blocked_attention_bound(live_rows[False], FLAG_B, beams, 63,
                                                       HEAD_D, heads, 2),
              ("attn", True): blocked_attention_bound(live_rows[True], FLAG_B, beams, 63, HEAD_D,
                                                      heads, 1, scale_bytes=4),
              ("ln", 1024): ln_gemm_bound(1024, HEAD_D, 3 * HEAD_D),
              ("ln", 32): ln_gemm_bound(32, HEAD_D, 3 * HEAD_D),
              ("mlp", 1024): mlp_bound(1024, HEAD_D, 4 * HEAD_D),
              ("mlp", 32): mlp_bound(32, HEAD_D, 4 * HEAD_D)}
    for key, label in labels.items():
        kernel, plain, lib_ms, per_call = t[key]
        name = key[0] if isinstance(key, tuple) else key
        lib_text = f", {library[name]} {lib_ms:.4f} ms" if lib_ms is not None else ""
        share = ""
        if key in bounds:
            ms, by = bounds[key]
            share = f"; {100 * ms / kernel:.1f}% of its bound {ms:.4f} ms ({by})"
        print(f"{label} time: kernel {kernel:.4f} ms, plain {plain:.4f} ms{lib_text} (graph "
              f"replays); kernel per call with its wrapper {per_call:.4f} ms{share}", flush=True)
    return t, live_rows


def run_fused_step_path(dev, flag):
    """Phase 28: the flagship beam-4 path under the four switches, 8 images,
    with the bf16 KV cache and the int8 one (per-head scales): each of the
    four kernels 12 times a step, the kernels of mode "2" never, a rerun
    identical, and the share of tokens equal to the default knobs' run on
    the same cache dtype; then B=1 and B=256 smoke figures, in turns with
    the default knobs."""
    config, params, model, kw, pixels = flag
    layers = config.decoder.num_layers
    px = pixels(8, 0)
    new = ("fused_lazy_attention", "fused_cross_attention", "ln_gemm", "fused_mlp")
    launches = None
    for kv in (None, "int8"):
        extra = dict(kw, kv_quant=kv)
        default = model.generate(params, px, **extra).sequences.cpu()
        with knobs(**FUSED_STEP):
            out, counts = drive(model, params, px, **extra)
            again = model.generate(params, px, **extra)
        label = f"fused beam step, {'int8' if kv else 'bf16'} KV"
        seqs = check_path_output(out, 8, 64, label)
        share = float((seqs == default).float().mean())
        print(f"{label}, 8 images: {out.steps} decode steps, launches "
              f"{ {n: counts[n] for n in new} }, tokens equal to the default knobs' {share:.4f}",
              flush=True)
        require(all(counts[n] == layers * out.steps for n in new),
                f"{label}: a kernel not launched once a layer a step")
        require(counts["lazy_attention"] == counts["lazy_attention_q8"] == 0,
                f"{label}: a mode-2 attention kernel ran")
        require(torch.equal(again.sequences.cpu(), seqs), f"{label}: a second run differs")
        print(f"{label}: second run gave identical sequences", flush=True)
        launches = launches or {n: counts[n] for n in new}
    for kv in (None, "int8"):
        alternate_figures(model, params, pixels, dict(kw, kv_quant=kv),
                          f"{'int8' if kv else 'bf16'} KV")
    return launches


def alternate_figures(model, params, pixels, kw, label, switches=FUSED_STEP,
                      switch_name="fused"):
    """B=1 and B=256 generates under the default knobs and under
    ``switches`` (by default the fused step's four) in turns (default,
    switched, switched, default), timed on the host clock around a
    synchronised generate: smoke figures, not a benchmark.  At B=1 (N=4
    rows) mic_tpu's N % 8 gates leave LN -> GEMM and the MLP kernel off."""
    turns = (("default", {}), (switch_name, switches), (switch_name, switches),
             ("default", {}))
    for b in (1, 256):
        px = pixels(b, 1)
        for turn, (name, env) in enumerate(turns, 1):
            with knobs(**env):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = model.generate(params, px, **kw)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            require(bool(torch.isfinite(out.scores).all()), f"{label}: non-finite scores")
            gated = (" (N=4: LN -> GEMM and the MLP kernel off)"
                     if b == 1 and env is FUSED_STEP else "")
            print(f"smoke figure (not a benchmark), {label}, {name} knobs{gated}, turn {turn}: "
                  f"B={b} num_beams {kw['num_beams']} max_length 64, {out.steps} steps in "
                  f"{seconds:.3f} s = {b / seconds:.1f} captions/s", flush=True)


def check_fused_step_small_against_cpu(dev):
    """Phase 29: the fused beam step at a small width (d_model 128, head_dim
    64, ffn_dim 512, 4 images: N = 16 rows) on the card (the four kernels)
    against the CPU (plain versions) on the same bf16 weights, with the bf16
    and the int8 cache: equal sequences, scores within 2e-2 (5e-2 with the
    int8 cache, where a row's int8 rounding can move by one step)."""
    from mic_tpu_torch.core.config import CaptionerConfig, DecodeConfig, DecoderConfig, VisionConfig
    from mic_tpu_torch.core.params import make_serving_params, tree_map
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.image_prep import preprocess_images

    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=512,
                                   max_position_embeddings=64),
        decode=DecodeConfig(fused_head="1", fused_select="bucket"),
        dtype="bfloat16",
    )
    params = make_serving_params(init_params(config, torch.Generator(device=dev).manual_seed(36),
                                             dev))
    host = tree_map(lambda x: x.cpu(), params)
    u8 = torch.from_numpy(np.random.default_rng(37).integers(0, 256, (4, 40, 40, 3),
                                                             dtype=np.uint8))
    model = Captioner(config)
    for kv, bound_ in ((None, 2e-2), ("int8", 5e-2)):
        kw = dict(num_beams=4, max_length=16, forced_bos_token_id=7, kv_quant=kv)
        with knobs(**FUSED_STEP):
            gpu, counts = drive(model, params, preprocess_images(u8.to(dev), 32, torch.bfloat16),
                                **kw)
            cpu = model.generate(host, preprocess_images(u8, 32, torch.bfloat16), **kw)
        score_err = (gpu.scores.cpu() - cpu.scores).abs().max().item()
        same = torch.equal(gpu.sequences.cpu(), cpu.sequences)
        new = ("fused_lazy_attention", "fused_cross_attention", "ln_gemm", "fused_mlp")
        print(f"small width, fused beam step, {'int8' if kv else 'bf16'} KV, card vs CPU: "
              f"sequences equal={same}, max score difference={score_err:.3g}, card launches "
              f"{ {n: counts[n] for n in new} }", flush=True)
        require(all(counts[n] > 0 for n in new), "fused beam step: a kernel never ran")
        require(same, f"fused beam step {kv}: card and CPU sequences differ")
        require(score_err < bound_, f"fused beam step {kv}: card and CPU scores differ")


# the teacher-forced attention of the flagship train step: (B, T, H) of the
# decoder's causal self-attention and of the vision tower's
ATTN_SHAPES = {"decoder": (64, 64, 16), "vision": (64, 50, 12)}
FLASH_LONG = (8, 600, 16)  # (B, T, H) of a long teacher-forced sequence for flash


def attention_bounds(b, tq, tk, heads, dh=64):
    """Rows 11 and 12 at (B, Tq, Tk, H): bf16 q, k, v (and dout) read and the
    output (dq, dk, dv) written once, the f32 (B, Tq, Tk) bias read once.
    Operations at their operands' peak: products of bf16 operands (q k^T,
    the rounded p times v, dv, dp) at the bf16 rate, of f32 ones (flash's
    f32 p times v, the backward's dq and dk from the f32 ds) at the f32
    rate; each product 2 B H Tq Tk Dh.  The bound is the larger of the bytes'
    time and the operations' time."""
    x = b * tq * heads * dh * 2
    bias = b * tq * tk * 4
    mm = 2 * b * heads * tq * tk * dh

    def bound_of(nbytes, bf16_mm, f32_mm):
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = (bf16_mm * mm / PEAK_OPS_PER_S["bf16"] + f32_mm * mm / PEAK_OPS_PER_S["f32"]) * 1e3
        return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")

    return {"flash_attention": bound_of(4 * x + bias, 1, 1),
            "small_attention_forward": bound_of(4 * x + bias, 2, 0),
            "small_attention_backward": bound_of(7 * x + bias, 3, 2)}


def _attention_case(dev, b, t, heads, kind, seed, tk=None):
    """bf16 q, k, v (B, T, H, 64) and a bool (B, 1, T, Tk) mask: "causal"
    with right padding (the decoder: lengths 8-64 as the train batches),
    "left" padding (a row's first queries see no key), "random" with two
    fully masked rows, or None (vision)."""
    tk = tk or t
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = ((torch.randn((b, n, heads, 64), generator=g, device=dev) * s).bfloat16()
               for n, s in ((t, 0.3), (tk, 0.3), (tk, 1.0)))
    if kind is None:
        return q, k, v, None
    if kind == "random":
        mask = torch.rand((b, 1, t, tk), generator=g, device=dev) < 0.6
        mask[0, 0, :2] = False
        return q, k, v, mask
    lengths = torch.randint(8, tk + 1, (b,), generator=g, device=dev)
    pos = torch.arange(tk, device=dev)
    pad = pos[None] >= tk - lengths[:, None] if kind == "left" else pos[None] < lengths[:, None]
    causal = torch.tril(torch.ones((t, tk), dtype=torch.bool, device=dev))
    return q, k, v, causal[None, None] & pad[:, None, None, :]


def _scaled_err(got, want):
    """max |got - want| over max |want|, in f32."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# The most a bf16 forward's outputs may differ from the plain version's bits,
# as a share of all outputs (check_forward_bits): the kernels' f32 values
# differ from plain's only by the order of their sums (and flash's p by the
# 2^-17 of it that hi + lo leave, and its online rescaling), a few 2^-24 to
# 2^-17 of the terms' size, so an output's bits differ only where it lies
# that close to a bf16 rounding boundary.  Measured on the card (phase 35
# of chip_smoke.py): 4e-5 to 1.5e-4 of small-T's outputs, 1.0e-3 to 2.5e-3
# of flash's (its p carries more rounding); flash's p rounded once to bf16
# moves 0.35 of them, small-T's p left unrounded 0.40.  The limits are
# about 13x and 4x the largest measured share.
FORWARD_SHARE_LIMIT = {"small_attention_forward": 2e-3, "flash_attention": 1e-2}


def _attention_scores(q, k, bias):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return s if bias is None else s + bias[:, None]


def attention_terms(name, q, k, v, bias):
    """The size of each forward output's terms, sum_k |p_k| |v_k| / l in f32
    from the plain version's values: small-T's softmax rounded to bf16 (l =
    1); flash's exp(s - m), zeroed where masked, over its l (1 where l = 0)."""
    s = _attention_scores(q, k, bias)
    if name == "small_attention_forward":
        p = torch.softmax(s, dim=-1).bfloat16().float()
    else:
        p = torch.where(s <= -5e29, 0.0, torch.exp(s - torch.clamp(s.amax(-1, keepdim=True),
                                                                   min=-1e30)))
        l = p.sum(-1, keepdim=True)
        p = p / torch.where(l == 0.0, 1.0, l)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float().abs())


def check_forward_bits(name, what, got, ref, terms):
    """The sharper check of a bf16 forward beside the 2e-2 one: every output
    within one bf16 ulp of the size of its terms of the plain output (the
    two round f32 values that differ only by the order of their sums, so
    they are equal or neighbouring bf16 values), and the share of outputs
    not bit-equal to the plain version's at most FORWARD_SHARE_LIMIT.
    Returns the share."""
    err = (got.float() - ref.float()).abs()
    over = int((err > _bf16_ulp(terms)).sum())
    share = (got != ref).float().mean().item()
    print(f"  {name} {what}: {over} outputs beyond one bf16 ulp of their terms' size, "
          f"{share:.3e} of {got.numel()} not bit-equal to plain (limit "
          f"{FORWARD_SHARE_LIMIT[name]:.0e})", flush=True)
    require(over == 0, f"{name} {what}: {over} outputs beyond one bf16 ulp of their terms")
    require(share <= FORWARD_SHARE_LIMIT[name],
            f"{name} {what}: {share:.3e} of the outputs not bit-equal to plain")
    return share


# The most a bf16 backward's gradients may differ from the plain version's
# bits, as a share of all entries (check_backward_bits): dq and dk carry dS
# as bf16 hi + lo (about 2^-17 of it left) and every product's f32 sum
# runs in another order, so an entry's bits differ only where it lies that
# close to a bf16 rounding boundary.  Measured on the card (this phase):
# 1.1e-3 to 2.3e-3 of dq's and dk's entries, 4e-5 to 1.6e-4 of dv's; dS
# rounded once to bf16 instead moves 0.24 to 0.41 of dq's (a torch
# emulation against mic_tpu's kernel), which the one-ulp check alone does
# not catch (2^-9 of each term stays under an ulp of their sum).  The
# limit is about 4x the largest measured share.
BACKWARD_SHARE_LIMIT = 1e-2


def backward_terms(q, k, v, bias, do):
    """The size of each small-T gradient's terms, in f32 from the plain
    version's values: dq's sum_k |dS| |k|, dk's sum_q |dS| |q| and dv's
    sum_q |round(p)| |do|."""
    p = torch.softmax(_attention_scores(q, k, bias), dim=-1)
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).abs()
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", ds, q.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof.abs()))


def check_backward_bits(what, grads, ref_grads, terms):
    """The sharper check of the bf16 backward beside the 2e-2 one: each of
    dq, dk and dv within one bf16 ulp of the size of its terms of the plain
    version's (the two round f32 values that differ by the order of their
    sums and dS's 2^-17), and the share of its entries not bit-equal to the
    plain version's at most BACKWARD_SHARE_LIMIT.  Returns the largest
    share."""
    shares = []
    for name, got, ref, size in zip(("dq", "dk", "dv"), grads, ref_grads, terms):
        over = int(((got.float() - ref.float()).abs() > _bf16_ulp(size)).sum())
        shares.append((got != ref).float().mean().item())
        print(f"  small_attention_backward {what} {name}: {over} entries beyond one bf16 ulp "
              f"of their terms' size, {shares[-1]:.3e} of {got.numel()} not bit-equal to plain "
              f"(limit {BACKWARD_SHARE_LIMIT:.0e})", flush=True)
        require(over == 0, f"small_attention_backward {what} {name}: {over} entries beyond "
                "one bf16 ulp of their terms")
        require(shares[-1] <= BACKWARD_SHARE_LIMIT,
                f"small_attention_backward {what} {name}: {shares[-1]:.3e} of the entries not "
                "bit-equal to plain")
    return max(shares)


def check_attention_kernels(dev):
    """Phase 35: rows 12 (forward and backward) and 11 (forward) against
    their plain versions at the flagship shapes in bf16: the decoder's
    causal mask with right padding, a left-padded mask (rows with no valid
    key: small-T attends key 0, flash outputs 0), vision's T = 50 with no
    mask; the small-T forward also at T = 1 and T = 63 (the tile's edges),
    and flash at Tq = 64 Tk = 65 (one key in a second tile) and Tq = Tk =
    600 (ten key tiles, a ragged last one), both with a random mask.
    Outputs within 2e-2 absolute (inputs of size 0.3-1: a softmax weight
    rounded to bf16 the other way, and the output's own bf16 rounding, move
    an output by about 4e-3), and every bf16 forward also through
    ``check_forward_bits``; the small-T gradients within 2e-2 of their
    largest entry (each rounds once to bf16 from f32 sums in another
    order) and through ``check_backward_bits``; flash's recomputing
    backward on the card within 2e-2 of the CPU's (the same plain code; f32
    sums in another order, one bf16 rounding); reruns bit-equal."""
    from mic_tpu_torch.ops import flash_attention as fa
    from mic_tpu_torch.ops import small_attention as sa

    worst = {"small_attention_forward": 0.0, "small_attention_backward": 0.0,
             "flash_attention": 0.0}
    shares = {"small_attention_forward": 0.0, "flash_attention": 0.0,
              "small_attention_backward": 0.0}

    def bits(name, what, got, ref, q, k, v, bias):
        share = check_forward_bits(name, what, got, ref, attention_terms(name, q, k, v, bias))
        shares[name] = max(shares[name], share)

    cases = [("decoder", "causal"), ("decoder", "left"), ("vision", None)]
    for i, (shape, kind) in enumerate(cases):
        b, t, heads = ATTN_SHAPES[shape]
        q, k, v, mask = _attention_case(dev, b, t, heads, kind, 400 + i)
        bias = sa.mask_bias(mask, b, t)
        do = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(410 + i),
                         device=dev).bfloat16()
        out, again = sa.small_attention_forward(q, k, v, bias), sa.small_attention_forward(q, k, v, bias)
        grads = sa.small_attention_backward(q, k, v, bias, do)
        grads2 = sa.small_attention_backward(q, k, v, bias, do)
        ref = sa.small_t_attention_plain(q, k, v, bias)
        ref_grads = sa.small_t_attention_bwd_plain(q, k, v, bias, do)
        fbias = fa.mask_bias(mask, b, t, t)
        fout, fagain = fa.flash_attention_forward(q, k, v, fbias), fa.flash_attention_forward(q, k, v, fbias)
        fref = fa.flash_attention_plain(q, k, v, fbias)
        torch.cuda.synchronize()
        require(torch.equal(out, again) and all(torch.equal(a, b_) for a, b_ in zip(grads, grads2))
                and torch.equal(fout, fagain), f"attention {shape} {kind}: a rerun differs")
        err = (out.float() - ref.float()).abs().max().item()
        gerr = max(_scaled_err(a, b_) for a, b_ in zip(grads, ref_grads))
        ferr = (fout.float() - fref.float()).abs().max().item()
        require(err <= 2e-2, f"small_attention_forward {shape} {kind}: {err}")
        require(gerr <= 2e-2, f"small_attention_backward {shape} {kind}: {gerr}")
        require(ferr <= 2e-2, f"flash_attention {shape} {kind}: {ferr}")
        dead = None if mask is None else ~mask[:, 0].any(-1)
        if dead is not None:
            require(not fout[dead].any(), f"flash_attention {shape} {kind}: a dead row is not 0")
            require(torch.equal(out[dead], v[:, :1].expand_as(v)[dead]),
                    f"small_attention_forward {shape} {kind}: a dead row is not key 0's value")
        worst["small_attention_forward"] = max(worst["small_attention_forward"], err)
        worst["small_attention_backward"] = max(worst["small_attention_backward"],
                                                max((a.float() - b_.float()).abs().max().item()
                                                    for a, b_ in zip(grads, ref_grads)))
        worst["flash_attention"] = max(worst["flash_attention"], ferr)
        print(f"attention {shape} B={b} T={t} H={heads} mask {kind} "
              f"({0 if dead is None else int(dead.sum())} rows with no valid key): small-T "
              f"forward max_abs_err={err:.4g}, backward max err / max |ref| {gerr:.4g}; flash "
              f"max_abs_err={ferr:.4g}; reruns bit-equal", flush=True)
        bits("small_attention_forward", f"{shape} {kind}", out, ref, q, k, v, bias)
        bits("flash_attention", f"{shape} {kind}", fout, fref, q, k, v, fbias)
        shares["small_attention_backward"] = max(
            shares["small_attention_backward"],
            check_backward_bits(f"{shape} {kind}", grads, ref_grads,
                                backward_terms(q, k, v, bias, do)))
    # the tile edges: small-T with one row and key, and one short of a tile
    b, _, heads = ATTN_SHAPES["decoder"]
    for t, kind in ((1, None), (63, "causal")):
        q, k, v, mask = _attention_case(dev, b, t, heads, kind, 425 + t)
        bias = sa.mask_bias(mask, b, t)
        out = sa.small_attention_forward(q, k, v, bias)
        again = sa.small_attention_forward(q, k, v, bias)
        ref = sa.small_t_attention_plain(q, k, v, bias)
        err = (out.float() - ref.float()).abs().max().item()
        require(torch.equal(out, again) and err <= 2e-2, f"small_attention_forward T={t}: {err}")
        worst["small_attention_forward"] = max(worst["small_attention_forward"], err)
        print(f"small_attention_forward B={b} T={t} H={heads} mask {kind}: max_abs_err={err:.4g}, "
              "reruns bit-equal", flush=True)
        bits("small_attention_forward", f"T={t}", out, ref, q, k, v, bias)
    # flash with one key in a second tile, and ten key tiles with a ragged last one
    for b, tq, tk, heads, seed in ((b, 64, 65, heads, 422), (2, 600, 600, 16, 420)):
        q, k, v, mask = _attention_case(dev, b, tq, heads, "random", seed, tk=tk)
        fbias = fa.mask_bias(mask, b, tq, tk)
        fout = fa.flash_attention_forward(q, k, v, fbias)
        fagain = fa.flash_attention_forward(q, k, v, fbias)
        fref = fa.flash_attention_plain(q, k, v, fbias)
        ferr = (fout.float() - fref.float()).abs().max().item()
        require(ferr <= 2e-2 and not fout[0, :2].any() and torch.equal(fout, fagain),
                f"flash_attention Tq={tq} Tk={tk}: {ferr}")
        worst["flash_attention"] = max(worst["flash_attention"], ferr)
        print(f"flash_attention B={b} Tq={tq} Tk={tk} H={heads} random mask: max_abs_err="
              f"{ferr:.4g}, the two masked rows 0, reruns bit-equal", flush=True)
        bits("flash_attention", f"Tq={tq} Tk={tk}", fout, fref, q, k, v, fbias)
    print(f"bf16 forwards, the largest share of outputs not bit-equal to plain: small-T "
          f"{shares['small_attention_forward']:.3e}, flash {shares['flash_attention']:.3e}; "
          f"the small-T backward's largest share of gradient entries "
          f"{shares['small_attention_backward']:.3e}", flush=True)
    b, t, heads = ATTN_SHAPES["decoder"]
    q, k, v, mask = _attention_case(dev, b, t, heads, "left", 430)
    w = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(431), device=dev)
    grads = []
    for where in (dev, torch.device("cpu")):
        leaves = [x.to(where).requires_grad_(True) for x in (q, k, v)]
        out = fa.flash_attention(*leaves, mask.to(where))
        grads.append(torch.autograd.grad((out.float() * w.to(where)).sum(), leaves))
    gerr = max(_scaled_err(a.cpu(), b_) for a, b_ in zip(*grads))
    require(gerr <= 2e-2, f"flash backward card vs CPU: {gerr}")
    print(f"flash backward (plain, recomputing) on the card vs the CPU, decoder left-padded: "
          f"max err / max |CPU| {gerr:.4g}", flush=True)
    return worst


def time_attention_kernels(dev):
    """Phase 36: rows 11 and 12 at the decoder's and vision's shapes, and
    flash at FLASH_LONG (causal with right padding), in CUDA-graph replays
    (``graph_ms``) and per call with the wrapper (``median_ms``), beside
    their plain versions' replays and scaled_dot_product_attention with the
    same boolean mask (its forward in replays; its backward, one call of
    torch.autograd.grad, is returned as a function for
    ``time_sdpa_backward``, which runs after every other phase)."""
    import torch.nn.functional as F

    from mic_tpu_torch.ops import flash_attention as fa
    from mic_tpu_torch.ops import small_attention as sa

    t = {}
    for shape, kind in (("decoder", "causal"), ("vision", None)):
        b, n, heads = ATTN_SHAPES[shape]
        q, k, v, mask = _attention_case(dev, b, n, heads, kind, 440)
        bias, fbias = sa.mask_bias(mask, b, n), fa.mask_bias(mask, b, n, n)
        do = torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(441),
                         device=dev).bfloat16()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        qh, kh, vh = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=1.0)
        torch.testing.assert_close(lib_out.transpose(1, 2).float(),
                                   sa.small_t_attention_plain(q, k, v, bias).float(),
                                   rtol=2e-2, atol=2e-2)
        dht = do.transpose(1, 2)
        t[("small_fwd", shape)] = (
            graph_ms(lambda: sa.small_attention_forward(q, k, v, bias)),
            graph_ms(lambda: sa.small_t_attention_plain(q, k, v, bias)),
            graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=1.0)),
            median_ms(lambda: sa.small_attention_forward(q, k, v, bias)))
        t[("small_bwd", shape)] = (
            graph_ms(lambda: sa.small_attention_backward(q, k, v, bias, do)),
            graph_ms(lambda: sa.small_t_attention_bwd_plain(q, k, v, bias, do)),
            lambda a=(lib_out, (qh, kh, vh), dht): torch.autograd.grad(*a, retain_graph=True),
            median_ms(lambda: sa.small_attention_backward(q, k, v, bias, do)))
        t[("flash", shape)] = (
            graph_ms(lambda: fa.flash_attention_forward(q, k, v, fbias)),
            graph_ms(lambda: fa.flash_attention_plain(q, k, v, fbias)),
            t[("small_fwd", shape)][2],
            median_ms(lambda: fa.flash_attention_forward(q, k, v, fbias)))
    b, n, heads = FLASH_LONG
    q, k, v, mask = _attention_case(dev, b, n, heads, "causal", 442)
    fbias = fa.mask_bias(mask, b, n, n)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t[("flash", "long")] = (
        graph_ms(lambda: fa.flash_attention_forward(q, k, v, fbias)),
        graph_ms(lambda: fa.flash_attention_plain(q, k, v, fbias)),
        graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=1.0)),
        median_ms(lambda: fa.flash_attention_forward(q, k, v, fbias)))
    for key, (kernel, plain, lib, per_call) in t.items():
        name, shape = key
        b, n, heads = {**ATTN_SHAPES, "long": FLASH_LONG}[shape]
        lib_text = ("its backward timed last" if callable(lib)
                    else f"its forward {lib:.4f} ms in graph replays")
        print(f"{name} {shape} B={b} T={n} H={heads}: kernel {kernel:.4f} ms (graph replays), "
              f"{per_call:.4f} ms per call with its wrapper; plain {plain:.4f} ms; "
              f"scaled_dot_product_attention: {lib_text}", flush=True)
    return t


def time_sdpa_backward(tf_ms):
    """The end of phase 36, after every other phase: scaled_dot_product_
    attention's backward (one torch.autograd.grad with phase 36's boolean
    mask) at the decoder's and vision's shapes, by the device time of its
    kernels in a profiler trace (``profiled_ms``: autograd runs it on its
    forward's stream, which a graph capture cannot hold).  Last, so that no
    graph-replay time follows a profiler trace.  Puts each time in place of
    its function in ``tf_ms``."""
    for key in [k for k in tf_ms if k[0] in ("small_bwd", "small_bwd_f32")]:
        kernel, plain, backward, per_call = tf_ms[key]
        ms = profiled_ms(backward)
        tf_ms[key] = (kernel, plain, ms, per_call)
        dtype = "float32" if key[0].endswith("f32") else "bf16"
        print(f"scaled_dot_product_attention backward {key[1]} {dtype}: {ms:.4f} ms (its "
              f"kernels' device time); the small-T backward kernel {kernel:.4f} ms", flush=True)


ATTN_COUNTERS = ("small_attention_forward", "small_attention_backward", "flash_attention")


def run_pallas_path(dev, flag):
    """Phase 37: flagship Captioner(attn_impl="pallas"): a teacher-forced
    forward and backward of the fused loss at B=64 x 64 (flash in the 12
    vision and 12 decoder self-attention layers, none on cross-attention:
    24 launches; the backward is plain), finite loss and gradients; then
    beam-4 generates of 8 images under attn_impl="pallas" and under
    small_attn, 12 launches each in the encoder, and the share of tokens
    equal to the default knobs'."""
    from mic_tpu_torch.core.config import DataConfig
    from mic_tpu_torch.core.params import tree_leaves
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops import flash_attention as fa
    from mic_tpu_torch.ops import small_attention as sa
    from mic_tpu_torch.ops.fused_ce import fused_lm_loss
    from mic_tpu_torch.ops.image_prep import maybe_preprocess

    config, params, model, kw, pixels = flag
    host = _train_batches(config, 1, 64, DataConfig().max_seq_length, 13)[0]
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in host.items()}
    master = init_params(config, torch.Generator(device=dev).manual_seed(14), dev)
    leaves = [leaf.requires_grad_(True) for _, leaf in tree_leaves(master)]
    pallas = Captioner(config, attn_impl="pallas", remat="masks")
    px = maybe_preprocess(batch["pixel_values"], config.vision.image_size, torch.bfloat16)
    fa.flash_attention_forward.launches = 0
    with torch.enable_grad():
        enc = pallas.encode(master, px)
        hidden = pallas.decode_hidden(master, enc, batch["decoder_input_ids"],
                                      batch["decoder_attention_mask"])
        forward_launches = fa.flash_attention_forward.launches
        emb = master["shared"]["embedding"]
        loss = fused_lm_loss(hidden, emb, master["final_logits_bias"], batch["labels"],
                             batch["decoder_attention_mask"], 0.1, 4096,
                             emb.detach().bfloat16(), mode="dl")
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    torch.cuda.synchronize()
    total = fa.flash_attention_forward.launches
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    print(f"attn_impl='pallas', flagship teacher-forced forward+backward at B=64 x 64: loss "
          f"{loss.item():.6f}, flash launches {forward_launches} in the forward, {total} with the "
          f"backward (remat 'masks' reruns each layer's forward), gradients finite={finite}",
          flush=True)
    layers = config.vision.num_layers + config.decoder.num_layers
    require(forward_launches == layers and total == 2 * layers,
            "attn_impl='pallas': flash not launched once per self-attention layer")
    require(np.isfinite(loss.item()) and finite, "attn_impl='pallas': a non-finite loss or grad")
    del master, leaves, grads, enc, hidden, loss
    torch.cuda.empty_cache()

    px = pixels(8, 0)
    default = model.generate(params, px, **kw).sequences.cpu()
    counters = (fa.flash_attention_forward, sa.small_attention_forward)
    for label, chosen, env in (("attn_impl='pallas'", Captioner(config, attn_impl="pallas"), {}),
                               ("small_attn", model, {"MIC_TPU_EXPERIMENTAL": "small_attn"})):
        with knobs(**env):
            for fn in counters:
                fn.launches = 0
            out = chosen.generate(params, px, **kw)
            torch.cuda.synchronize()
        counts = [fn.launches for fn in counters]
        seqs = check_path_output(out, 8, 64, label)
        share = float((seqs == default).float().mean())
        print(f"beam 4 under {label}, 8 images: {out.steps} decode steps, flash / small-T "
              f"launches {counts}, tokens equal to the default knobs' {share:.4f}", flush=True)
        want = [12, 0] if "pallas" in label else [0, 12]
        require(counts == want, f"{label}: encoder launches {counts}, expected {want}")
    return {"flash_attention": total}


def check_attention_small_against_cpu(dev):
    """Phase 38: at a small bf16 width with head dim 64 in both towers
    (vision 128 wide, decoder d_model 128, 2 heads each), the card against
    the CPU on the same weights.  small_attn training: the first step's
    gradient leaves (the card's small-T kernels, the CPU's XLA math) each
    within 5e-2 of its largest entry (floored at 1e-4 of the largest of all
    leaves: bf16 activations rounded in other orders, as phase 11), the
    kernels launched.  attn_impl="pallas": the logits within 5e-2 of their
    largest entry and the gradients of sum(logits * w) likewise."""
    from mic_tpu_torch.core.config import (
        CaptionerConfig, DataConfig, DecoderConfig, TrainConfig, VisionConfig,
    )
    from mic_tpu_torch.core.params import tree_leaves, tree_map
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops import flash_attention as fa
    from mic_tpu_torch.ops import small_attention as sa
    from mic_tpu_torch.train.trainer import Trainer

    config = CaptionerConfig(
        vision=VisionConfig.tiny(hidden_size=128, num_heads=2),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                                   max_position_embeddings=64, dropout=0.0),
        dtype="bfloat16",
    )
    params = init_params(config, torch.Generator().manual_seed(15))
    paths = [path for path, _ in tree_leaves(params)]
    rng = np.random.default_rng(16)
    mask = np.ones((4, 16), np.int32)
    mask[1, 10:] = 0
    host = {"pixel_values": rng.integers(0, 256, (4, 40, 40, 3), dtype=np.uint8),
            "labels": rng.integers(4, 1100, (4, 16)).astype(np.int32),
            "decoder_input_ids": rng.integers(4, 1100, (4, 16)).astype(np.int32),
            "decoder_attention_mask": mask}

    def worst_leaf(got, want):
        floor = 1e-4 * max(g.abs().max().item() for g in want)
        return max(((a - b).abs().max().item() / max(b.abs().max().item(), floor), path)
                   for path, a, b in zip(paths, got, want))

    tc = TrainConfig(per_device_batch_size=4, learning_rate=1e-3, warmup_steps=1,
                     label_smoothing=0.1)
    grads = {}
    with knobs(MIC_TPU_EXPERIMENTAL="small_attn"):
        for device in (dev, torch.device("cpu")):
            trainer = Trainer(config, DataConfig(max_seq_length=16, decode_size=40), tc,
                              device=device)
            trainer.build(10)
            state = trainer.init_state(tree_map(lambda x, d=device: x.clone().to(d), params))
            _train_counts(reset=True)
            grads[device.type] = _first_grads(trainer, state, trainer.put_batch(host))
            counts = _train_counts()
            if device.type == "cuda":
                card_counts = {k: counts[k] for k in ATTN_COUNTERS}
    err, path = worst_leaf(grads["cuda"], grads["cpu"])
    print(f"small_attn training at a small width, card vs CPU: first-step gradients, worst leaf "
          f"{'/'.join(path)} at {err:.3g} of its largest entry (limit 5e-2); card launches "
          f"{card_counts}", flush=True)
    require(err <= 5e-2, f"small_attn: card and CPU gradients differ ({'/'.join(path)})")
    layers = config.vision.num_layers + config.decoder.num_layers
    require(card_counts == {"small_attention_forward": 2 * layers,
                            "small_attention_backward": layers, "flash_attention": 0},
            "small_attn at a small width: launches")

    ids, dmask = (torch.from_numpy(host[k]) for k in ("decoder_input_ids", "decoder_attention_mask"))
    px = torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 16, 1100)).astype(np.float32))
    model = Captioner(config, attn_impl="pallas")
    outs = {}
    for device in (dev, torch.device("cpu")):
        tree = tree_map(lambda x, d=device: x.clone().to(d).requires_grad_(True), params)
        leaves = [leaf for _, leaf in tree_leaves(tree)]
        fa.flash_attention_forward.launches = 0
        logits = model(tree, px.to(device), ids.to(device), dmask.to(device))
        g = torch.autograd.grad((logits.float() * w.to(device)).sum(), leaves, allow_unused=True,
                                materialize_grads=True)
        outs[device.type] = (logits.detach().float().cpu(), [x.float().cpu() for x in g],
                             fa.flash_attention_forward.launches)
    lerr = _scaled_err(outs["cuda"][0], outs["cpu"][0])
    gerr, path = worst_leaf(outs["cuda"][1], outs["cpu"][1])
    print(f"attn_impl='pallas' at a small width, card vs CPU: logits max err / max |CPU| "
          f"{lerr:.3g}, gradients worst leaf {'/'.join(path)} at {gerr:.3g} (limits 5e-2); "
          f"card flash launches {outs['cuda'][2]}", flush=True)
    require(lerr <= 5e-2 and gerr <= 5e-2, "attn_impl='pallas': card and CPU differ")
    require(outs["cuda"][2] == layers and outs["cpu"][2] == 0, "attn_impl='pallas': launches")


# the merged cross cache's (live, padded) encoder rows: the flagship's 50 of
# 64, a ragged 37 of 48, and 64 with no pad
MERGED_S = ((FLAG_S, 64), (37, 48), (64, 64), (1, 16))
MERGED_CROSS = dict(MIC_TPU_EXPERIMENTAL="merged_cross")
PHYSICAL = dict(MIC_TPU_LAZY_CACHE="0")
PERMUTE_SHAPE = (12, FLAG_B * FLAG_K, FLAG_T, FLAG_H, FLAG_DH)  # one flagship self plane
MM_SHAPES = ((1024, 3072), (1024, 4096), (4096, 1024), (1024, HEAD_V))  # (K, N)
# phase 42's cases, (K, N) -> M: MM_SHAPES at M in {4, 1024} (every instance
# at the first and last), then ragged shapes
MM_CASES = {(1024, 3072): (1, 4, 8, 64, 65, 1024), (1024, 4096): (4, 1024),
            (4096, 1024): (4, 1024), (1024, HEAD_V): (1, 4, 8, 64, 65, 1024),
            (1024, 249): (4,), (1024, 250055): (65,), (1024, 3078): (4, 1024),
            (1001, 3074): (65,), (1000, 3074): (1,)}


def q8_cross_bound(b, beams, s, hd, heads, io_bytes=2):
    """Row 14's int8 form: each image's int8 K and V rows and their f32
    scales (one per row and head) read once, q read and the output written
    in bf16 (or ``io_bytes`` each); 4 f32 operations per (beam, position,
    element)."""
    return bound(2 * b * s * (hd + heads * 4) + 2 * b * beams * hd * io_bytes,
                 4 * b * beams * s * hd, "f32")


def int8_matmul_bound(m, k, n):
    """Row 20: x (bf16), w_q (int8) and the f32 scales read once, the bf16
    output written; 2 M K N products of bf16 operands."""
    return bound(m * k * 2 + k * n + n * 4 + m * n * 2, 2 * m * k * n, "bf16")


def _merged_cross_inputs(dev, g, s, s_pad, beams=FLAG_K, exact=False):
    """q (B, K, H*Dh) and merged (B, S_pad, H*Dh) K/V, zero past S."""
    q, ek, ev = _cross_case(dev, g, beams, s, exact)
    kv = []
    for c in (ek, ev):
        m = torch.zeros((FLAG_B, s_pad, FLAG_H * FLAG_DH), dtype=torch.bfloat16, device=dev)
        m[:, :s] = c.reshape(FLAG_B, s, -1)
        kv.append(m)
    return q, kv[0], kv[1]


def check_cross_attention_dma(dev):
    """Phase 39: row 13's kernel against its plain version at B=256, H=16,
    beams {4, 1, 9, 16, 33}, over S=50 live rows padded to 64, a ragged 37 padded
    to 48, 64 unpadded and 1 padded to 16: outputs within 2e-2 (phase 24's
    bound), reruns bit-equal; with every pad row NaN the output bit-equal to
    the zero-pad one, so no pad row is read; bit-equal to plain where every
    sum is exact (q = 0, integer V) at 4 and 16 beams."""
    from mic_tpu_torch.ops.cross_attention import (
        fused_cross_attention_dma, fused_cross_attention_dma_plain,
    )

    heads = FLAG_H
    g = torch.Generator(device=dev).manual_seed(39)
    worst = 0.0
    for beams in CROSS_BEAMS:
        for s, s_pad in MERGED_S:
            q, ek, ev = _merged_cross_inputs(dev, g, s, s_pad, beams)
            name = f"fused_cross_attention_dma K={beams} S={s} of {s_pad}"
            out = fused_cross_attention_dma(q, ek, ev, s, beams, heads)
            worst = max(worst, _held(name, out, fused_cross_attention_dma(q, ek, ev, s, beams,
                                                                         heads),
                                     fused_cross_attention_dma_plain(q, ek, ev, s, beams,
                                                                     heads)))
            if s < s_pad:
                nk, nv = ek.clone(), ev.clone()
                nk[:, s:] = float("nan")
                nv[:, s:] = float("nan")
                again = fused_cross_attention_dma(q, nk, nv, s, beams, heads)
                torch.cuda.synchronize()
                require(torch.equal(out, again), f"{name}: NaN pad rows changed the output")
                del nk, nv
            if (beams, s) == (FLAG_K, FLAG_S):
                inputs = (q, ek, ev)
        print(f"fused_cross_attention_dma B={FLAG_B} K={beams} (S, S_pad) in {MERGED_S}: "
              f"max_abs_err={worst:.6g} (so far), reruns bit-equal, NaN pad rows: output "
              "bit-equal", flush=True)
    for beams in (FLAG_K, 16):
        q, ek, ev = _merged_cross_inputs(dev, g, FLAG_S, 64, beams, exact=True)
        out = fused_cross_attention_dma(q, ek, ev, FLAG_S, beams, heads)
        torch.cuda.synchronize()
        require(torch.equal(out, fused_cross_attention_dma_plain(q, ek, ev, FLAG_S, beams,
                                                                 heads)),
                f"fused_cross_attention_dma K={beams}: not bit-equal to plain on exact sums")
    print("fused_cross_attention_dma exact sums (q = 0, integer V), K in (4, 16): bit-equal to "
          "plain", flush=True)
    return worst, inputs


def check_cross_attention_q8(dev):
    """Phase 40: row 14's int8 kernel against its plain version at B=256,
    H=16, beams {4, 1, 9, 16, 33} and S {50, 37, 1, 64}: the cross K/V quantized
    per (image, position, head) by ops/quant.py::quantize_rows_dynamic;
    outputs within 2e-2, reruns bit-equal; bit-equal to plain where every
    sum is exact (q = 0, integer V values, V scales powers of two) at 4 and
    16 beams."""
    from mic_tpu_torch.ops.cross_attention import (
        fused_cross_attention_plain, fused_cross_attention_q8,
    )
    from mic_tpu_torch.ops.quant import quantize_rows_dynamic

    heads = FLAG_H
    g = torch.Generator(device=dev).manual_seed(40)
    worst = 0.0
    for beams in CROSS_BEAMS:
        for s in CROSS_S:
            q, ek, ev = _cross_case(dev, g, beams, s)
            caches, dequant = [], []
            for c in (ek, ev):
                values, scales = quantize_rows_dynamic(c)
                caches.append({"q": values, "s": scales[..., 0].contiguous()})
                dequant.append((values.float() * scales).bfloat16())
            worst = max(worst, _held(f"fused_cross_attention_q8 K={beams} S={s}",
                                     fused_cross_attention_q8(q, *caches, beams, heads),
                                     fused_cross_attention_q8(q, *caches, beams, heads),
                                     fused_cross_attention_plain(q, *caches, beams, heads)))
            if (beams, s) == (FLAG_K, FLAG_S):
                inputs = (q, *caches, *dequant)
        print(f"fused_cross_attention_q8 B={FLAG_B} K={beams} S in {CROSS_S}: max_abs_err="
              f"{worst:.6g} (so far), reruns bit-equal", flush=True)
    for beams in (FLAG_K, 16):
        q, ek, _ = _cross_case(dev, g, beams, FLAG_S, exact=True)
        values, scales = quantize_rows_dynamic(ek)
        ck = {"q": values, "s": scales[..., 0].contiguous()}
        cv = {"q": torch.randint(-127, 128, ek.shape, generator=g, device=dev, dtype=torch.int8),
              "s": torch.exp2(torch.randint(-9, -3, (FLAG_B, FLAG_S, heads), generator=g,
                                            device=dev).float())}
        out = fused_cross_attention_q8(q, ck, cv, beams, heads)
        torch.cuda.synchronize()
        require(torch.equal(out, fused_cross_attention_plain(q, ck, cv, beams, heads)),
                f"fused_cross_attention_q8 K={beams}: not bit-equal to plain on exact sums")
    print("fused_cross_attention_q8 exact sums (q = 0, integer V, power-of-two V scales), K in "
          "(4, 16): bit-equal to plain", flush=True)
    return worst, inputs


def check_beam_permute(dev):
    """Phase 41: row 19's kernel against its plain version, bit-equal, on one
    flagship self plane (L=12, B*K=1024, T=64, H=16, Dh=64 bf16: 1.61 GB,
    random within-group sources, the input left as it was) and on small
    planes whose T*H*Dh = 105 is not a multiple of 8 (bf16 and f32)."""
    from mic_tpu_torch.ops.beam_permute import beam_permute, beam_permute_plain

    g = torch.Generator(device=dev).manual_seed(41)
    kv = torch.randn(PERMUTE_SHAPE, generator=g, device=dev, dtype=torch.bfloat16)
    idx = torch.randint(0, FLAG_K, (FLAG_B, FLAG_K), generator=g, device=dev)
    before = kv.clone()
    out = beam_permute(kv, idx, FLAG_K)
    ref = beam_permute_plain(kv, idx, FLAG_K)
    torch.cuda.synchronize()
    require(torch.equal(out, ref), "beam_permute: the flagship plane differs from plain")
    require(torch.equal(kv, before), "beam_permute: the input changed")
    del out, ref, before
    for dtype in (torch.bfloat16, torch.float32):
        small = torch.randn((3, 6, 5, 3, 7), generator=g, device=dev).to(dtype)
        sidx = torch.randint(0, 3, (2, 3), generator=g, device=dev)
        require(torch.equal(beam_permute(small, sidx, 3), beam_permute_plain(small, sidx, 3)),
                f"beam_permute: the (3, 6, 5, 3, 7) {dtype} plane differs from plain")
    torch.cuda.synchronize()
    print(f"beam_permute {PERMUTE_SHAPE} bf16 ({kv.numel() * 2 / 1e9:.3f} GB): bit-equal to "
          "plain, input unchanged; (3, 6, 5, 3, 7) bf16 and f32 (rows of 105 elements): "
          "bit-equal", flush=True)
    return 0.0, (kv, idx)


def check_int8_matmul(dev):
    """Phase 42: row 20's kernel against its plain version: M in {4, 1024} at
    (K, N) in {(1024, 3072), (1024, 4096), (4096, 1024), (1024, 250054)}, M
    in {1, 8, 64, 65} too at the first and last (every instance, depth
    splits at decode M), and the ragged shapes: odd N (249, 250055), N % 16
    in {2, 6} (3074, 3078: the weights by cp.async and a realign), K % 8 !=
    0, a last slice cut short and a ragged last split (K = 1000, M = 1), w_q
    one byte into its storage.  Each output within one bf16 ulp of the
    plain output plus the worst-case error of f32 sums in another order, K
    * 2**-24 * sum |x| |w|; a rerun bit-equal.  Then exact sums (small-
    integer x, K <= 128, scales of 8 significant bits whose products with
    w_q round: every sum exact in any order) bit-equal to plain, and scales
    of any size (negative, zero, 2^15 and more) within the bound."""
    from mic_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain, int8_matmul_plan

    g = torch.Generator(device=dev).manual_seed(42)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    inputs = {}

    def held(x, w_q, scale, what):
        m, k = x.shape
        n = w_q.shape[1]
        out = int8_matmul(x, w_q, scale)
        again = int8_matmul(x, w_q, scale)
        ref = int8_matmul_plain(x, w_q, scale)
        torch.cuda.synchronize()
        w_abs = (w_q.to(torch.bfloat16) * scale.to(torch.bfloat16)).float().abs()
        diff = (out.float() - ref.float()).abs()
        limit = _bf16_ulp(ref.float().abs()) + k * 2.0**-24 * (x.float().abs() @ w_abs)
        name = f"int8_matmul {what}M={m} K={k} N={n}"
        require(bool((diff <= limit).all()), f"{name}: an output beyond its bound")
        require(torch.equal(out, again), f"{name}: a rerun differs")
        print(f"{name} (instance, splits, blocks {int8_matmul_plan(m, k, n, sms)}): "
              f"max_abs_err={diff.max().item():.6g} (largest |out| "
              f"{ref.float().abs().max().item():.4g}), {int((diff > 0).sum())} of "
              f"{diff.numel()} outputs differ from plain, rerun bit-equal", flush=True)
        return diff.max().item()

    def weight(k, n, offset=0):
        flat = torch.randint(-128, 128, (k * n + offset,), generator=g, device=dev,
                             dtype=torch.int8)
        return flat[offset:].view(k, n), torch.rand((n,), generator=g, device=dev) * 0.09 + 0.01

    for (k, n), ms in MM_CASES.items():
        w_q, scale = weight(k, n)
        for m in ms:
            x = (torch.randn((m, k), generator=g, device=dev) * 0.3).bfloat16()
            err = held(x, w_q, scale, "")
            if m in (4, 1024) and (k, n) in MM_SHAPES:
                worst = max(worst, err)
            if m in (4, 1024) and (k, n) in ((1024, 3072), (1024, HEAD_V)):
                inputs[(m, k, n)] = (x, w_q, scale)
        del w_q, scale
    w_q, scale = weight(1024, 3072, offset=1)
    held((torch.randn((8, 1024), generator=g, device=dev) * 0.3).bfloat16(), w_q, scale,
         "w_q one byte in, ")
    for m, k, n in ((4, 128, 3072), (65, 120, 249), (1024, 128, HEAD_V)):
        x = torch.randint(-3, 4, (m, k), generator=g, device=dev).bfloat16()
        w_q = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        scale = torch.randint(128, 256, (n,), generator=g, device=dev).float() * 2.0**-10
        out = int8_matmul(x, w_q, scale)
        torch.cuda.synchronize()
        require(torch.equal(out, int8_matmul_plain(x, w_q, scale)),
                f"int8_matmul exact sums M={m} K={k} N={n}: not bit-equal to plain")
        print(f"int8_matmul exact sums M={m} K={k} N={n}: bit-equal to plain", flush=True)
    for m, k, n in ((4, 1024, 3074), (1024, 256, 3072)):
        w_q, scale = weight(k, n)
        scale = scale - 0.055
        scale[::7] = 0.0
        scale[3::97] = 40000.0
        scale[5::211] = -3.0e5
        held((torch.randn((m, k), generator=g, device=dev) * 0.3).bfloat16(), w_q, scale,
             "scales of any size, ")
    return worst, inputs


def time_last_kernels(dev, cross_inputs, q8_inputs, permute_inputs, mm_inputs):
    """Phase 43: rows 13, 14-int8 and 20 in CUDA-graph replays (``graph_ms``)
    and per call with the wrapper (``median_ms``), row 19 per call (a 1.6 GB
    output a call: a graph of ten would hold ten), each beside its plain
    version and, where one PyTorch call computes the same function, that
    call: SDPA on row 13's live rows with the beams on the query axis,
    ``index_select`` for row 19.  Rows 14-int8 and 20 have none; SDPA on the
    dequantised K/V and ``torch.mm`` on the dequantised weight are timed
    for scale only."""
    import torch.nn.functional as F

    from mic_tpu_torch.ops.beam_permute import beam_permute, beam_permute_plain
    from mic_tpu_torch.ops.cross_attention import (
        fused_cross_attention_dma, fused_cross_attention_dma_plain, fused_cross_attention_plain,
        fused_cross_attention_q8,
    )
    from mic_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain

    b, beams, heads, dh, s = FLAG_B, FLAG_K, FLAG_H, FLAG_DH, FLAG_S
    t = {}

    def sdpa_operands(q, k, v):
        return (q.reshape(b, beams, heads, dh).transpose(1, 2),
                k.reshape(b, s, heads, dh).transpose(1, 2),
                v.reshape(b, s, heads, dh).transpose(1, 2))

    q, ek, ev = cross_inputs
    qh, kh, vh = sdpa_operands(q, ek[:, :s], ev[:, :s])
    lib = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0).transpose(1, 2)
    torch.testing.assert_close(lib.reshape(q.shape).float(),
                               fused_cross_attention_dma_plain(q, ek, ev, s, beams, heads).float(),
                               rtol=2e-2, atol=2e-2)
    t["dma"] = (graph_ms(lambda: fused_cross_attention_dma(q, ek, ev, s, beams, heads)),
                graph_ms(lambda: fused_cross_attention_dma_plain(q, ek, ev, s, beams, heads)),
                graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)),
                median_ms(lambda: fused_cross_attention_dma(q, ek, ev, s, beams, heads)))
    q, ck, cv, dk, dv = q8_inputs
    qh, kh, vh = sdpa_operands(q, dk, dv)
    t["q8"] = (graph_ms(lambda: fused_cross_attention_q8(q, ck, cv, beams, heads)),
               graph_ms(lambda: fused_cross_attention_plain(q, ck, cv, beams, heads)),
               graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)),
               median_ms(lambda: fused_cross_attention_q8(q, ck, cv, beams, heads)))
    kv, idx = permute_inputs
    rows = (torch.arange(b, device=dev)[:, None] * beams + idx).reshape(-1)
    t["permute"] = (median_ms(lambda: beam_permute(kv, idx, beams), runs=10),
                    median_ms(lambda: beam_permute_plain(kv, idx, beams), runs=10),
                    median_ms(lambda: kv.index_select(1, rows), runs=10), None)
    for (m, k, n), (x, w_q, scale) in mm_inputs.items():
        w = w_q.to(torch.bfloat16) * scale.to(torch.bfloat16)
        t[("mm", m, n)] = (graph_ms(lambda: int8_matmul(x, w_q, scale)),
                           graph_ms(lambda: int8_matmul_plain(x, w_q, scale)),
                           graph_ms(lambda: torch.mm(x, w)),
                           median_ms(lambda: int8_matmul(x, w_q, scale)))
        del w
    labels = {"dma": (f"fused_cross_attention_dma B={b} K={beams} S={s} of 64 H={heads}",
                      "scaled_dot_product_attention on the live rows"),
              "q8": (f"fused_cross_attention_q8 B={b} K={beams} S={s} H={heads}",
                     "for scale only, scaled_dot_product_attention on the dequantised K/V"),
              "permute": (f"beam_permute {PERMUTE_SHAPE} bf16", "index_select")}
    labels.update({key: (f"int8_matmul M={key[1]} K=1024 N={key[2]}",
                         "for scale only, torch.mm on the dequantised bf16 weight")
                   for key in t if isinstance(key, tuple)})
    for key, (label, lib_name) in labels.items():
        kernel, plain, lib_ms, per_call = t[key]
        how = "per call" if per_call is None else "graph replays"
        extra = "" if per_call is None else f"; kernel per call with its wrapper {per_call:.4f} ms"
        print(f"{label} time: kernel {kernel:.4f} ms, plain {plain:.4f} ms, {lib_name} "
              f"{lib_ms:.4f} ms ({how}){extra}", flush=True)
    return t


def _path_turn(model, params, px, kw, env, label, kernel, want):
    """One 8-image generate under ``env`` with launch counts and a rerun:
    ``kernel`` launched exactly ``want(steps)`` times, the rerun identical."""
    with knobs(**env):
        out, counts = drive(model, params, px, **kw)
        again = model.generate(params, px, **kw)
    seqs = check_path_output(out, 8, 64, label)
    require(counts[kernel] == want(out.steps), f"{label}: {counts[kernel]} {kernel} launches "
            f"in {out.steps} steps")
    require(torch.equal(again.sequences.cpu(), seqs), f"{label}: a second run differs")
    return seqs, counts, out.steps


def run_merged_cross_path(dev, flag):
    """Phase 44: path A, beam 4 with MIC_TPU_EXPERIMENTAL=merged_cross at
    flagship width, 8 images, with the bf16 and the int8 KV cache: row 13
    exactly 12 times a step, row 14's canonical kernel never, a rerun
    identical, the share of tokens equal to the default knobs'; then B=1
    and B=256 smoke figures in turns with the default knobs."""
    config, params, model, kw, pixels = flag
    layers = config.decoder.num_layers
    px = pixels(8, 0)
    launches = {"fused_cross_attention_dma": 0, "fused_cross_attention_q8": 0, "int8_matmul": 0}
    for kv in (None, "int8"):
        extra = dict(kw, kv_quant=kv)
        default = model.generate(params, px, **extra).sequences.cpu()
        label = f"merged_cross path, {'int8' if kv else 'bf16'} KV"
        seqs, counts, steps = _path_turn(model, params, px, extra, MERGED_CROSS, label,
                                         "fused_cross_attention_dma", lambda n: layers * n)
        attention = "lazy_attention_q8" if kv else "lazy_attention"
        require(counts[attention] == layers * steps and counts["fused_cross_attention"] == 0,
                f"{label}: the self-attention or row 14's kernel launched otherwise")
        share = float((seqs == default).float().mean())
        print(f"{label}, 8 images: {steps} decode steps, launches fused_cross_attention_dma "
              f"{counts['fused_cross_attention_dma']}, {attention} {counts[attention]}, "
              f"fused_cross_attention {counts['fused_cross_attention']}; rerun identical; tokens "
              f"equal to the default knobs' {share:.4f}", flush=True)
        if kv is None:
            launches["fused_cross_attention_dma"] = counts["fused_cross_attention_dma"]
        for name in ("fused_cross_attention_q8", "int8_matmul"):
            launches[name] += counts[name]
    alternate_figures(model, params, pixels, kw, "merged_cross path", MERGED_CROSS,
                      "merged_cross")
    return launches


def run_physical_path(dev, flag):
    """Phase 45: path B, beam 4 with MIC_TPU_LAZY_CACHE=0 at flagship width,
    8 images: row 19 exactly twice a step (self K and self V), the lazy
    kernels never, a rerun identical, the share of tokens equal to the lazy
    default's; merged_cross beside it ignored (row 13 never); then B=1 and
    B=256 smoke figures in turns with the default knobs."""
    config, params, model, kw, pixels = flag
    px = pixels(8, 0)
    default = model.generate(params, px, **kw).sequences.cpu()
    label = "physical path"
    seqs, counts, steps = _path_turn(model, params, px, kw, PHYSICAL, label, "beam_permute",
                                     lambda n: 2 * n)
    require(counts["lazy_attention"] == 0 and counts["fused_head"] >= steps,
            f"{label}: a lazy kernel ran, or the head did not")
    share = float((seqs == default).float().mean())
    print(f"{label}, 8 images: {steps} decode steps, launches beam_permute "
          f"{counts['beam_permute']}, fused_head {counts['fused_head']}, lazy_attention 0; rerun "
          f"identical; tokens equal to the lazy default's {share:.4f}", flush=True)
    both = dict(PHYSICAL, **MERGED_CROSS)
    same, counts_mc, _ = _path_turn(model, params, px, kw, both, "physical path + merged_cross",
                                    "beam_permute", lambda n: 2 * n)
    require(counts_mc["fused_cross_attention_dma"] == 0 and torch.equal(same, seqs),
            "merged_cross changed the physical path")
    print("physical path with merged_cross: ignored (no merged-cross launch, the same "
          "sequences)", flush=True)
    launches = {"beam_permute": counts["beam_permute"]}
    alternate_figures(model, params, pixels, kw, "physical path", PHYSICAL, "physical")
    return launches


def check_last_paths_small_against_cpu(dev):
    """Phase 46: at a small width (d_model 128, head_dim 64, 4 images) paths
    A (bf16 and int8 KV) and B on the card (rows 13 and 19) against the CPU
    (plain versions) on the same bf16 weights: equal sequences, scores
    within 2e-2 (5e-2 with the int8 cache, where a row's int8 rounding can
    move by one step)."""
    from mic_tpu_torch.core.config import CaptionerConfig, DecodeConfig, DecoderConfig, VisionConfig
    from mic_tpu_torch.core.params import make_serving_params, tree_map
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.image_prep import preprocess_images

    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=512,
                                   max_position_embeddings=64),
        decode=DecodeConfig(fused_head="1", fused_select="bucket"),
        dtype="bfloat16",
    )
    params = make_serving_params(init_params(config, torch.Generator(device=dev).manual_seed(46),
                                             dev))
    host = tree_map(lambda x: x.cpu(), params)
    u8 = torch.from_numpy(np.random.default_rng(47).integers(0, 256, (4, 40, 40, 3),
                                                             dtype=np.uint8))
    model = Captioner(config)
    cases = (("merged_cross, bf16 KV", MERGED_CROSS, None, 2e-2, "fused_cross_attention_dma"),
             ("merged_cross, int8 KV", MERGED_CROSS, "int8", 5e-2, "fused_cross_attention_dma"),
             ("physical cache", PHYSICAL, None, 2e-2, "beam_permute"))
    for label, env, kv, limit, kernel in cases:
        kw = dict(num_beams=4, max_length=16, forced_bos_token_id=7, kv_quant=kv)
        with knobs(**env):
            gpu, counts = drive(model, params, preprocess_images(u8.to(dev), 32, torch.bfloat16),
                                **kw)
            cpu = model.generate(host, preprocess_images(u8, 32, torch.bfloat16), **kw)
        score_err = (gpu.scores.cpu() - cpu.scores).abs().max().item()
        same = torch.equal(gpu.sequences.cpu(), cpu.sequences)
        print(f"small width, {label}, card vs CPU: sequences equal={same}, max score "
              f"difference={score_err:.3g}, card {kernel} launches {counts[kernel]}", flush=True)
        require(counts[kernel] > 0, f"{label}: {kernel} never ran")
        require(same, f"{label}: card and CPU sequences differ")
        require(score_err < limit, f"{label}: card and CPU scores differ")


def check_twelve_beams_small_against_cpu(dev):
    """Phase 47: beam 12 (past the earlier cross kernel's eight beams) at a
    small width (d_model 128, head_dim 64, 4 images), under
    MIC_TPU_EXPERIMENTAL=merged_cross (row 13) and under fused_cross_attn
    alone (row 14; mode "2"'s self-attention, whose kernel takes up to 32
    beams), on the card against the CPU (plain versions) on the same bf16
    weights: equal sequences, scores within 2e-2."""
    from mic_tpu_torch.core.config import CaptionerConfig, DecodeConfig, DecoderConfig, VisionConfig
    from mic_tpu_torch.core.params import make_serving_params, tree_map
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.image_prep import preprocess_images

    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=512,
                                   max_position_embeddings=64),
        decode=DecodeConfig(fused_head="1", fused_select="bucket"),
        dtype="bfloat16",
    )
    params = make_serving_params(init_params(config, torch.Generator(device=dev).manual_seed(48),
                                             dev))
    host = tree_map(lambda x: x.cpu(), params)
    u8 = torch.from_numpy(np.random.default_rng(49).integers(0, 256, (4, 40, 40, 3),
                                                             dtype=np.uint8))
    model = Captioner(config)
    kw = dict(num_beams=12, max_length=16, forced_bos_token_id=7)
    cases = (("merged_cross", MERGED_CROSS, "fused_cross_attention_dma"),
             ("fused_cross_attn", dict(MIC_TPU_EXPERIMENTAL="fused_cross_attn"),
              "fused_cross_attention"))
    for label, env, kernel in cases:
        with knobs(**env):
            gpu, counts = drive(model, params, preprocess_images(u8.to(dev), 32, torch.bfloat16),
                                **kw)
            cpu = model.generate(host, preprocess_images(u8, 32, torch.bfloat16), **kw)
        score_err = (gpu.scores.cpu() - cpu.scores).abs().max().item()
        same = torch.equal(gpu.sequences.cpu(), cpu.sequences)
        print(f"small width, beam 12, {label}, card vs CPU: sequences equal={same}, max score "
              f"difference={score_err:.3g}, card {kernel} launches {counts[kernel]}", flush=True)
        require(counts[kernel] == config.decoder.num_layers * gpu.steps,
                f"beam 12 {label}: {kernel} not launched once a layer a step")
        require(same, f"beam 12 {label}: card and CPU sequences differ")
        require(score_err < 2e-2, f"beam 12 {label}: card and CPU scores differ")


def sass_release_faults(lib_path, function: str):
    """The consumers' ring-slot releases in ``function``'s SASS (the first
    kernel of the library whose mangled name holds it) that can free a slot
    while a product reads it: an arrival (``SYNCS.ARRIVE...A1T0``) between a
    slot's full wait (``SYNCS.PHASECHK``) and a ``wgmma`` of that wait
    (``HGMMA``), or between that ``wgmma`` and the wait that retires it
    (``WARPGROUP.DEPBAR``).  In instruction order, which the loops of these
    kernels keep.  It assumes their order: each slot is released only after
    a ``wgmma_wait<0>()`` retires every product in flight.  A pipelined ring
    that keeps a group in flight (``wgmma_wait<1>()``, then the previous
    slot's release) would be flagged though right, and so would an arrival
    that ptxas moves across the retiring wait; such a design needs each
    arrival matched to its own slot's barrier instead.
    -> (faults, products seen)."""
    import re
    from pathlib import Path

    from mic_tpu_torch import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = function in line
        elif inside:
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                body.append((m.group(1), m.group(2)))
    require(bool(body), f"no SASS for a function named like {function}")
    faults, products = [], 0
    window = None  # since the last full wait: [an arrival seen, a product seen]
    for at, ins in body:
        op = ins.split()[1] if ins.startswith("@") else ins.split()[0]
        if op.startswith("SYNCS.PHASECHK"):
            window = [False, False]
        elif op.startswith("HGMMA"):
            products += 1
            if window is not None:
                if window[0]:
                    faults.append(at)
                window[1] = True
        elif op.startswith("WARPGROUP.DEPBAR"):
            window = None
        elif op.startswith("SYNCS.ARRIVE") and "A1T0" in op and window is not None:
            if window[1]:
                faults.append(at)
            window[0] = True
    return faults, products


def check_bucket_slot_release(dev, lib_path):
    """Phase 48: the bf16 bucket head (row 4) frees each ring slot only
    after the products reading it retire.  In the built library's SASS of
    its kernel (bucket_kernel<false>) no slot is released between its full
    wait and the wait that retires its products (``sass_release_faults``);
    and at N in {1024, 65}, D=1024, V=250054, where the producer has the
    whole ring loaded ahead of the consumers at each chunk pair's start,
    twenty reruns give every lp, id and lse bit-equal to the first run."""
    from mic_tpu_torch.ops.fused_head import fused_head_topk

    faults, products = sass_release_faults(lib_path, "bucket_kernelILb0E")
    print(f"fused_head bucket_kernel<false> SASS: {products} HGMMA, slot releases before their "
          f"products retire: {faults or 'none'}", flush=True)
    require(products > 0, "the bf16 bucket kernel's SASS holds no HGMMA")
    require(not faults, f"the bf16 bucket kernel frees a ring slot before its products retire "
            f"(SASS at {faults})")
    weight, bias, _, _ = _head_table(dev)
    for n in (1024, 65):
        hidden = _hidden(dev, n, HEAD_D, 480 + n)
        first = fused_head_topk(hidden, weight, bias, 9, "bucket")
        for _ in range(20):
            again = fused_head_topk(hidden, weight, bias, 9, "bucket")
            torch.cuda.synchronize()
            require(all(torch.equal(x, y) for x, y in zip(first, again)),
                    f"fused_head bucket N={n}: a rerun differs")
        print(f"fused_head bucket N={n}: twenty reruns bit-equal (every lp, id and lse)",
              flush=True)


CKPT_LANGS = ("en_XX", "fr_XX", "es_XX", "de_DE")


def card_name_and_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _caption_tsv(root, n=256, size=256, seed=49):
    """``n`` PNGs of random pixels (size x size) under ``root``/images and a
    TSV of them (image, caption, url, language), languages in turn ->
    (tsv path, images dir, captions)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)]
    images = os.path.join(root, "images")
    os.makedirs(images)
    rows, captions = [], []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(images, f"img_{i}.png"))
        captions.append(" ".join(rng.choice(words, int(rng.integers(6, 20)))))
        rows.append(f"img_{i}.png\t{captions[-1]}\thttp://x\t{CKPT_LANGS[i % 4]}")
    tsv = os.path.join(root, "train.tsv")
    with open(tsv, "w") as f:
        f.write("\n".join(rows) + "\n")
    return tsv, images, captions


def _logged(output_dir) -> dict:
    """{step: (train loss, learning rate)} from a run's metrics.jsonl."""
    with open(os.path.join(output_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return {line["step"]: (line["train/loss"], line["train/learning_rate"])
            for line in lines if "train/loss" in line}


def _checkpoint_leaves(tree) -> list:
    """Params, then mu, then nu: every tensor of a train checkpoint's tree
    (train/state.py::checkpoint_tree)."""
    from mic_tpu_torch.core.params import tree_leaves

    return [leaf.detach() for part in (tree["params"], tree["opt_state"]["mu"],
                                       tree["opt_state"]["nu"])
            for _, leaf in tree_leaves(part)]


def _state_leaves(state) -> list:
    from mic_tpu_torch.train.state import checkpoint_tree

    return _checkpoint_leaves(checkpoint_tree(state))


def _bytes_under(path) -> int:
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def run_checkpoint_path(dev, root):
    """Phase 49: the port keeps what it trains and serves it from a saved
    directory, at flagship width (CaptionerConfig.clip_vit_b32_mbart50 in
    bf16, depth cut to CUT_LAYERS vision and decoder layers, TrainConfig
    defaults: batch 64 x 64, dropout 0.1, bf16 moments and
    shadow, the dl route; warmup_steps=2).  Run A: Trainer.train() over a
    synthetic TSV of 256 PNGs (256 x 256, 4 languages, a SimpleTokenizer fit
    on its captions) for one epoch of 4 steps, save_steps=2,
    save_total_limit=2: checkpoints 2 and 4 and nothing else, the model
    directory, both CE kernels once a step.  Reload: from_pretrained's
    params bit-equal to A's, and a beam-4 generate of 8 images from them
    equal to one from A's params in memory (min_length 64: all 63 steps),
    through rows 1 and 4.  The
    caption CLI on 4 PNGs (4 lines) and the evaluate CLI on the TSV's first
    64 rows (finite BLEU-1..4 for the four languages), with no --device:
    both on the card, through rows 1 and 4.  One train-checkpoint save, its
    restore and one model-directory save timed on the host clock.  Run B:
    resume_from A's checkpoint 2 into a new directory; steps 3 and 4 give
    the params, moments, step and logged losses of A bit-equal."""
    from mic_tpu_torch.cli import caption, evaluate
    from mic_tpu_torch.core.config import DataConfig, TrainConfig
    from mic_tpu_torch.core.params import tree_leaves
    from mic_tpu_torch.data.tokenizer import SimpleTokenizer
    from mic_tpu_torch.io.checkpoint import TrainCheckpointManager
    from mic_tpu_torch.models.captioner import Captioner
    from mic_tpu_torch.ops.image_prep import preprocess_images
    from mic_tpu_torch.train.state import checkpoint_tree
    from mic_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    tsv, images, captions = _caption_tsv(root)
    tok = SimpleTokenizer()
    tok.fit(captions)
    tok_path = os.path.join(root, "tokenizer.json")
    tok.save(tok_path)
    print(f"checkpoints: 256 PNGs and a TSV written in {time.perf_counter() - t0:.2f} s",
          flush=True)
    config = _flagship_depth(CUT_LAYERS).replace(dtype="bfloat16")
    dc = DataConfig(train_file=tsv, images_dir=images)
    run_a, run_b = os.path.join(root, "run_a"), os.path.join(root, "run_b")
    tc = TrainConfig(output_dir=run_a, num_epochs=1, warmup_steps=2, save_steps=2,
                     save_total_limit=2, logging_steps=1, eval_steps=10**9)

    def train(tc):
        trainer = Trainer(config, dc, tc, tokenizer_path=tok_path, device=dev)
        _train_counts(reset=True)
        t0 = time.perf_counter()
        state = trainer.train()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        return state, {k: v for k, v in _train_counts().items() if v}, seconds

    state_a, launches, seconds = train(tc)
    logged_a = _logged(run_a)
    kept = sorted(os.listdir(os.path.join(run_a, "checkpoints")))
    model_dir = os.path.join(run_a, "model")
    print(f"checkpoints, run A: {state_a.step} steps in {seconds:.1f} s (saves and the model "
          f"directory included), losses {logged_a}, launches {launches}, checkpoints {kept}, "
          f"model directory {sorted(os.listdir(model_dir))}", flush=True)
    require(state_a.step == 4, f"run A took {state_a.step} steps, not 4")
    require(launches == {"flash_ce_forward": 4, "flash_ce_backward_dl": 4},
            f"run A: launches {launches}, expected both CE kernels once a step")
    require(kept == ["2", "4"], f"run A kept checkpoints {kept}, not 2 and 4")
    require(sorted(os.listdir(model_dir)) == ["config.json", "params.pt", "tokenizer.json"],
            "run A's model directory is not config.json, params.pt and tokenizer.json")
    require(sorted(logged_a) == [1, 2, 3, 4] and all(np.isfinite(v[0]) for v in logged_a.values()),
            "run A did not log four finite losses")
    with open(os.path.join(run_a, "checkpoints", "2", "meta.json")) as f:
        meta = json.load(f)
    require(meta == {"epoch": 0, "next_batch": 2}, f"checkpoint 2 holds the position {meta}")

    model, params = Captioner.from_pretrained(model_dir)
    reloaded = [leaf for _, leaf in tree_leaves(params)]
    require(all(a.device.type == "cuda" for a in reloaded), "from_pretrained left the card")
    require(all(torch.equal(a, b.detach()) for a, (_, b) in
                zip(reloaded, tree_leaves(state_a.params))),
            "from_pretrained's params are not run A's bit for bit")
    u8 = np.random.default_rng(50).integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    px = preprocess_images(torch.from_numpy(u8).to(dev), config.vision.image_size, torch.bfloat16)
    # four steps teach the model to end at once: min_length keeps all 63
    # steps of the decode in the comparison
    kw = dict(num_beams=4, max_length=64, min_length=64, forced_bos_token_id=FLAGSHIP_BOS)
    from_memory, _ = drive(model, state_a.params, px, **kw)
    from_disk, counts = drive(model, params, px, **kw)
    seqs = check_path_output(from_disk, 8, 64, "reloaded model")
    require(from_disk.steps == 63, f"reloaded generate took {from_disk.steps} steps, not 63")
    print(f"checkpoints, reload: params bit-equal; beam 4 of 8 images from the reloaded params: "
          f"{from_disk.steps} steps, launches lazy_attention {counts['lazy_attention']}, "
          f"fused_head {counts['fused_head']}", flush=True)
    require(torch.equal(seqs, from_memory.sequences.cpu()),
            "the reloaded params give other sequences than the params in memory")
    require(counts["lazy_attention"] == config.decoder.num_layers * from_disk.steps,
            "reloaded generate: lazy_attention not launched once a layer a step")
    require(counts["fused_head"] >= from_disk.steps, "reloaded generate: fused_head missing")
    del model, params, reloaded
    torch.cuda.empty_cache()

    counters = _counters()
    for name in ("lazy_attention", "fused_head"):
        counters[name].launches = 0
    out = io.StringIO()
    paths = [os.path.join(images, f"img_{i}.png") for i in range(4)]
    with contextlib.redirect_stdout(out):
        caption.main(paths + ["--model_dir", model_dir])
    lines = out.getvalue().splitlines()
    cli_counts = {name: counters[name].launches for name in ("lazy_attention", "fused_head")}
    print(f"checkpoints, caption CLI on 4 PNGs (launches {cli_counts}): "
          f"{[line[:100] for line in lines]}", flush=True)
    require(len(lines) == 4 and all(line.startswith(p + "\t") for p, line in zip(paths, lines)),
            "the caption CLI did not print one path<TAB>caption line an image")
    require(all(cli_counts.values()), "the caption CLI did not run rows 1 and 4 on the card")
    head = os.path.join(root, "head64.tsv")
    with open(tsv) as f, open(head, "w") as g:
        g.writelines(f.readlines()[:64])
    out_json = os.path.join(root, "bleu.json")
    for name in ("lazy_attention", "fused_head"):
        counters[name].launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        evaluate.main(["--model_dir", model_dir, "--tsv_path", head, "--images_dir", images,
                       "--output_json", out_json])
    with open(out_json) as f:
        bleu = json.load(f)
    cli_counts = {name: counters[name].launches for name in ("lazy_attention", "fused_head")}
    print(f"checkpoints, evaluate CLI on 64 rows (launches {cli_counts}): {bleu}", flush=True)
    require(sorted(bleu) == sorted(CKPT_LANGS), f"evaluate scored {sorted(bleu)}")
    require(all(sorted(r) == ["bleu-1", "bleu-2", "bleu-3", "bleu-4"]
                and all(np.isfinite(v) for v in r.values()) for r in bleu.values()),
            "evaluate wrote a missing or non-finite BLEU")
    require(all(cli_counts.values()), "the evaluate CLI did not run rows 1 and 4 on the card")

    timed = os.path.join(root, "timed")
    manager = TrainCheckpointManager(timed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manager.save(4, checkpoint_tree(state_a), meta)
    save_s = time.perf_counter() - t0
    ckpt_bytes = _bytes_under(os.path.join(timed, "checkpoints", "4"))
    t0 = time.perf_counter()
    tree, _ = manager.restore(4, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require(all(torch.equal(a, b) for a, b in zip(_checkpoint_leaves(tree),
                                                  _state_leaves(state_a))),
            "the timed restore is not the saved state bit for bit")
    del tree
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    Captioner(config).save_pretrained(os.path.join(timed, "model"), state_a.params)
    model_s = time.perf_counter() - t0
    model_bytes = _bytes_under(os.path.join(timed, "model"))
    print(f"checkpoint figures ({card_name_and_limit()}; host clock, fsync'd writes, warm page "
          f"cache for the restore): train-checkpoint save {ckpt_bytes} B in {save_s:.3f} s "
          f"({ckpt_bytes / save_s / 1e9:.2f} GB/s), its restore onto the card in "
          f"{restore_s:.3f} s ({ckpt_bytes / restore_s / 1e9:.2f} GB/s), model-directory save "
          f"{model_bytes} B in {model_s:.3f} s ({model_bytes / model_s / 1e9:.2f} GB/s)",
          flush=True)
    shutil.rmtree(timed)
    shutil.rmtree(model_dir)

    final_a = [leaf.cpu() for leaf in _state_leaves(state_a)]
    count_a = state_a.opt_state.count
    del state_a
    torch.cuda.empty_cache()
    state_b, launches, seconds = train(tc.replace(
        output_dir=run_b, resume_from=os.path.join(run_a, "checkpoints", "2")))
    logged_b = _logged(run_b)
    kept = sorted(os.listdir(os.path.join(run_b, "checkpoints")))
    print(f"checkpoints, run B (resumed from A's step 2): steps 3-4 in {seconds:.1f} s, losses "
          f"{logged_b}, launches {launches}, checkpoints {kept}", flush=True)
    require(launches == {"flash_ce_forward": 2, "flash_ce_backward_dl": 2},
            f"run B: launches {launches}, expected both CE kernels once a step")
    require(logged_b == {s: logged_a[s] for s in (3, 4)},
            "run B's logged losses are not run A's steps 3 and 4 bit for bit")
    require(state_b.step == 4 and state_b.opt_state.count == count_a,
            "run B did not end at run A's step")
    require(all(torch.equal(a.cpu(), b) for a, b in zip(_state_leaves(state_b), final_a)),
            "run B's params or moments are not run A's bit for bit")
    require(kept == ["4"], f"run B kept checkpoints {kept}, not 4")
    print("checkpoints: the resumed run is bit-equal to the uninterrupted one (params, mu, nu, "
          "step, losses)", flush=True)
    del state_b, final_a
    shutil.rmtree(run_a)
    shutil.rmtree(run_b)
    torch.cuda.empty_cache()


def check_checkpoint_across_devices(dev, root):
    """Phase 49, at a small width (dropout 0.1): a train checkpoint saved
    from the card restores on the CPU bit-equal (params, moments, step,
    count, the generator's bytes), and one saved from the CPU on the card;
    a trainer on the other device refuses the generator state, which fits
    only its own device's generator."""
    from mic_tpu_torch.core.config import (
        CaptionerConfig, DataConfig, DecoderConfig, TrainConfig, VisionConfig,
    )
    from mic_tpu_torch.train.state import checkpoint_tree
    from mic_tpu_torch.train.trainer import Trainer

    config = CaptionerConfig(
        vision=VisionConfig.tiny(),
        decoder=DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                                   max_position_embeddings=64, dropout=0.1),
        dtype="bfloat16",
    )
    dc = DataConfig(max_seq_length=16, decode_size=40)
    rng = np.random.default_rng(51)
    batch = {"pixel_values": rng.integers(0, 256, (4, 40, 40, 3), dtype=np.uint8),
             "labels": rng.integers(4, 1100, (4, 16)).astype(np.int32),
             "decoder_input_ids": rng.integers(4, 1100, (4, 16)).astype(np.int32),
             "decoder_attention_mask": np.ones((4, 16), np.int32)}
    cpu = torch.device("cpu")
    for src, dst in ((dev, cpu), (cpu, dev)):
        out = os.path.join(root, f"from_{src.type}")
        tc = TrainConfig(output_dir=out, per_device_batch_size=4, warmup_steps=1)
        trainer = Trainer(config, dc, tc, device=src)
        trainer.build(10)
        state, _ = trainer.train_step(trainer.init_state(), trainer.put_batch(batch))
        trainer.ckpt.save(1, checkpoint_tree(state), {"epoch": 0, "next_batch": 1})
        tree, _ = trainer.ckpt.restore(device=dst)
        saved = checkpoint_tree(state)
        leaves = list(zip(_checkpoint_leaves(tree), _checkpoint_leaves(saved)))
        require(all(a.device.type == dst.type for a, _ in leaves),
                f"a {src.type} checkpoint restored off the {dst.type}")
        same = all(torch.equal(a.cpu(), b.cpu()) for a, b in leaves)
        same = same and tree["step"] == 1 and tree["opt_state"]["count"] == 1
        same = same and torch.equal(tree["generator"].cpu(), saved["generator"])
        other = Trainer(config, dc, tc.replace(output_dir=out + "_other"), device=dst)
        other.build(10)
        refused = _raises(ValueError, other.restore, trainer.ckpt)
        print(f"checkpoint saved on the {src.type}, restored on the {dst.type}: {len(leaves)} "
              f"leaves bit-equal={same}; a {dst.type} trainer refuses its {src.type} generator "
              f"state={refused}", flush=True)
        require(same, f"a {src.type} checkpoint restored on the {dst.type} is not bit-equal")
        require(refused, f"a {dst.type} trainer took a {src.type} generator state")
        shutil.rmtree(out)


def run_trained_model_path(dev, root):
    """Phase 50: the trained-model tools at flagship decoder width (the
    mBART-50 decoder, V = 250054, with the tiny vision tower, bf16).
    tools/data/make_synthetic.py --hard makes 256 images (224 train, 32
    val); tools/torch_ab_hard_synthetic.py's ``main`` trains its primary
    arm 16 epochs (112 steps of batch 32, its defaults otherwise, the images
    decoded in the training process; at two epochs, 14 steps into the
    recipe's 100-step warmup, the model does not yet caption: eval loss
    5.4-6.4, BLEU-4 0), evaluates, saves the model directory and runs the
    decode A/B (the exact, bucket, window and approx_max_k modes).  Checks:
    the losses finite and falling (the last below the first), loss and
    BLEU-1..4 keys for the four languages, the CE kernels (rows 7, 8) once a
    training step (row 7 also for each eval batch's loss), rows 1, 4 and 5
    launched by the evals and the A/B.  Then tools/torch_bench_trained.py's
    caption on the saved directory, B=256 val images, beam 4, length 64:
    bf16 (rows 1 and 4) and int8 weights with the int8 KV cache (rows 2 and
    6), each search ending where the model ends its captions (every
    caption's EOS at or before the last step, fewer than 63 steps), and
    bf16 with min_length 64 on the same weights (all 63 steps); host-clock
    times of the three are smoke figures."""
    here = os.path.dirname(os.path.abspath(__file__))
    tools = os.path.join(here, "tools")
    sys.path.insert(0, tools)
    import torch_ab_hard_synthetic as ab
    import torch_bench_trained as bench

    from mic_tpu_torch.core.params import make_serving_params
    from mic_tpu_torch.data.tokenizer import load_tokenizer
    from mic_tpu_torch.models.captioner import Captioner

    data, out = os.path.join(root, "hard"), os.path.join(root, "abrun")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.join(tools, "data", "make_synthetic.py"),
                    "--out", data, "--n", "256", "--hard"], check=True, capture_output=True,
                   timeout=600)
    print(f"trained model: 256 hard-synthetic images made in {time.perf_counter() - t0:.2f} s",
          flush=True)

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    _train_counts(reset=True)
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        report = ab.main(["--data", data, "--out", out, "--epochs", "16", "--log_every", "1",
                          "--num_workers", "0", "--skip_shadow_off", "--save_model"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_launches = {k: v for k, v in _train_counts().items() if v}
    serve_launches = {name: fn.launches for name, fn in counters.items() if fn.launches}
    for line in log.getvalue().splitlines():
        if line.startswith("[decode-ab]") or "steps in" in line or " eval " in line:
            print(f"trained model, {line}", flush=True)
    losses = [loss for _, loss in report["shadow_on"]["losses"]]
    print(f"trained model: the tool's main in {seconds:.1f} s (training, eval, save, decode "
          f"A/B), {len(losses)} losses {losses[:3]} ... {losses[-3:]}, training launches "
          f"{train_launches}, serving launches {serve_launches}", flush=True)
    steps = 112  # 16 epochs of 224 train images in batches of 32
    require(len(losses) == steps and all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"the trained-model losses are not {steps} finite falling values: {losses}")
    langs = ("de_DE", "en_XX", "es_XX", "fr_XX")
    want = sorted([f"{lang}/loss" for lang in langs]
                  + [f"{lang}/bleu-{n}" for lang in langs for n in range(1, 5)])
    require(sorted(report["shadow_on"]["eval"]) == want,
            f"the eval reported {sorted(report['shadow_on']['eval'])}")
    bleu = {k for k in want if "bleu" in k}
    require(all(bleu <= set(report["decode_ab"][mode]) for mode in ab.DECODE_MODES),
            "a decode mode lacks a language's BLEU")
    # the forward kernel also gives each eval batch its loss
    require(train_launches.get("flash_ce_backward_dl") == steps
            and train_launches.get("flash_ce_forward", 0) > steps
            and set(train_launches) == {"flash_ce_forward", "flash_ce_backward_dl"},
            f"launches {train_launches}, expected both CE kernels once a training step")
    for name in ("lazy_attention", "fused_head", "fused_head_select"):
        require(serve_launches.get(name, 0) > 0,
                f"the evals and the decode A/B did not launch {name}")

    model_dir = os.path.join(out, "model")
    model, params = Captioner.from_pretrained(model_dir, device=dev)
    params = make_serving_params(params, model.dtype)
    tok = load_tokenizer(os.path.join(model_dir, "tokenizer.json"))
    images = torch.from_numpy(bench.load_pool(data)).to(dev)
    images = images[torch.arange(256, device=dev) % images.shape[0]]
    eos = model.config.decoder.eos_token_id
    for label, quant, kv, min_length in (("bf16", None, "", 0), ("int8", "int8", "int8", 0),
                                         ("bf16 all steps", None, "", 64)):
        args = argparse.Namespace(max_length=64, num_beams=4, min_length=min_length,
                                  no_early_stopping=False, quant=quant)
        caption = bench.make_caption(model, params, tok.lang_code_to_id["en_XX"], args)
        with knobs(MIC_TPU_KV_QUANT=kv):
            caption(images[:8])  # the first call apart
            gen, launches, seconds = generate_counted(caption, images)
            launches = {name: n for name, n in launches.items() if n}
        seqs = gen.sequences.cpu().numpy()
        ends = [int(np.flatnonzero(row == eos)[0]) if (row == eos).any() else 64 for row in seqs]
        print(f"trained model, bench caption {label}: B=256 beam 4 length 64, {gen.steps} steps "
              f"in {seconds:.3f} s = {256 / seconds:.1f} captions/s (smoke figure, not a "
              f"benchmark), EOS positions {min(ends)}-{max(ends)}, launches {launches}, "
              f"{tok.batch_decode(seqs[:2])}", flush=True)
        if min_length:
            require(gen.steps == 63, f"{label}: {gen.steps} steps, not 63")
            continue
        require(max(ends) <= gen.steps < 63,
                f"{label}: the search ran {gen.steps} steps with captions ending at "
                f"{min(ends)}-{max(ends)}")
        row_attn, row_head = (("lazy_attention_q8", "fused_head_bucket_q8") if quant
                              else ("lazy_attention", "fused_head"))
        require(launches.get(row_attn) == model.config.decoder.num_layers * gen.steps,
                f"{label}: {row_attn} not launched once a layer a step: {launches}")
        require(launches.get(row_head, 0) >= gen.steps,
                f"{label}: {row_head} launched less than once a step: {launches}")
    del model, params, images
    shutil.rmtree(out)
    shutil.rmtree(data)
    torch.cuda.empty_cache()


def _f32_table(dev, v, d, seed):
    """A float32 tied table and bias: the flagship init's scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((v, d), generator=g, device=dev) * 0.02,
            torch.randn((v,), generator=g, device=dev) * 0.1)


def _f32_head_case(got, ref, logits, what):
    """A float32 head kernel against its plain version: lse within 1e-5
    relative; ids equal but at near-ties (two plain logits within 2e-4);
    every lp within 2e-4.  Both sum D products to float32 accuracy in other
    orders (the kernels three TF32 products a term on the tensor cores or
    f32 FMAs in the stream, cuBLAS f32 in its own): about 2^-24 sqrt(D) sum
    |h| |w|, 3e-5 at the flagship's unit hidden rows and 0.02 table, with
    room for the tail."""
    (lp, ids, lse), (rlp, rids, rlse) = got, ref
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=0)
    differ = ids != rids
    gap = (logits.gather(1, ids.long()) - logits.gather(1, rids.long())).abs()
    require(bool((gap[differ] < 2e-4).all()), f"{what}: an id differs beyond a near-tie")
    torch.testing.assert_close(lp, rlp, rtol=0, atol=2e-4)
    return (lp - rlp).abs().max().item(), int(differ.sum())


def check_f32_kernels(dev):
    """Phase 51: the float32 instances of rows 1, 4, 5, 7 and 8 against
    their plain versions on the card, TF32 off (main() turns it off for
    matmuls and cuDNN): row 1 at the flagship decode shape (B=256 K=4 T=64
    H=16, index 0, 1, 17, 63) and a ragged one (B=3 K=3 T=37 H=2, index
    36), outputs within 1e-5 (f32 sums in another order), the written cache
    bit-equal, columns past index zero; row 4 (the bucket select, on the
    route its N takes and, where that is the stream, on the tile too) and
    row 5 (the exact and window selects) at N in {1024, 4} D=1024 V=250054
    k in {9, 1}, at N=1, at N at and either side of the routes' crossover
    (``STREAM_ROWS``), at N=65 and 5 D=100 V=997 (a depth off the 32-deep
    slice, a ragged vocab) and row 4 under bucket_bv 96 and 200
    (``_f32_head_case``; each call made twice, the second bit-equal, the
    launches counted); rows 7 and 8 at N=4096 D=1024 V=250054 and at
    N=129 D=100 V=997: lse and the label logit within 1e-5 relative, the
    sum of logits within 1e-5 of the row's sum of |logits|, dl within 1e-4
    of |dl| + 2 target rowscale (one relative error of p from the logits'
    summation order), rows with rowscale 0 zero, nothing written past dl,
    dbias within 1e-5 of its largest entry.  Then each kernel's time in
    CUDA-graph replays beside its plain version's (the heads at N=1024 and
    4, each bucket route at N=1 and at the crossover's N), and cuBLAS's bare f32
    h @ W^T (TF32 off) for scale -> (errors, times)."""
    from mic_tpu_torch.ops.flash_ce import (
        _dl_gemms, _targets, flash_ce_dl, flash_ce_dl_plain, flash_ce_forward,
        flash_ce_forward_plain,
    )
    from mic_tpu_torch.ops.fused_head import _logits, fused_head_topk, fused_head_topk_plain
    from mic_tpu_torch.ops.lazy_attention import lazy_attention, lazy_attention_plain

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for matmuls")
    errs, times = {}, {}
    g = torch.Generator(device=dev).manual_seed(51)
    worst = 0.0
    for b, beams, t, heads, index in ([(FLAG_B, FLAG_K, FLAG_T, FLAG_H, i) for i in (0, 1, 17, 63)]
                                      + [(3, 3, 37, 2, 36)]):
        q, ck, cv, ks, vs, anc = (x.float() if x.dtype == torch.bfloat16 else x
                                  for x in _lazy_inputs(dev, g, b, beams, t, heads, index, False))
        ck[:, index:] = 0
        cv[:, index:] = 0
        pk, pv = ck.clone(), cv.clone()
        out = lazy_attention(q, ck, cv, ks, vs, anc, index, heads)
        ref = lazy_attention_plain(q, pk, pv, ks, vs, anc, index, heads)
        torch.cuda.synchronize()
        require(out.dtype == torch.float32, "lazy_attention f32: output dtype")
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        require(torch.equal(ck, pk) and torch.equal(cv, pv), "lazy_attention f32: cache differs")
        require(not ck[:, index + 1:].any() and not cv[:, index + 1:].any(),
                "lazy_attention f32: a dead column written")
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        print(f"lazy_attention f32 B={b} K={beams} T={t} H={heads} index={index}: "
              f"max_abs_err={err:.3g}, cache bit-equal, columns > index zero", flush=True)
    errs["lazy_attention_f32"] = worst
    q, ck, cv, ks, vs, anc = (x.float() if x.dtype == torch.bfloat16 else x for x in
                              _lazy_inputs(dev, g, FLAG_B, FLAG_K, FLAG_T, FLAG_H, FLAG_T, False))
    args = (q, ck, cv, ks, vs, anc, 63, FLAG_H)
    times["lazy_attention_f32"] = (graph_ms(lambda: lazy_attention(*args)),
                                   graph_ms(lambda: lazy_attention_plain(*args)), None)
    del q, ck, cv, ks, vs, anc, args

    from mic_tpu_torch.ops.fused_head import (
        STREAM_ROWS, _bucket_f32, bucket_f32_route, fused_head_select,
    )

    weight, bias = _f32_table(dev, HEAD_V, HEAD_D, 52)
    small = _f32_table(dev, 997, 100, 53)
    worst = {"fused_head_bucket_f32": 0.0, "fused_head_select_f32": 0.0}
    # the flagship shapes, N at and either side of the bucket routes'
    # crossover, a depth off the 32-deep slice with a ragged vocab, other
    # bucket widths
    cross = (STREAM_ROWS - 1, STREAM_ROWS, STREAM_ROWS + 1)
    for n, d, v, k, bv in dict.fromkeys((
            (1024, HEAD_D, HEAD_V, 9, None), (1024, HEAD_D, HEAD_V, 1, None),
            (4, HEAD_D, HEAD_V, 9, None), (1, HEAD_D, HEAD_V, 9, None),
            *((c, HEAD_D, HEAD_V, 9, None) for c in cross),
            (65, 100, 997, 9, None), (65, 100, 997, 9, 96), (70, 100, 997, 16, 200),
            (5, 100, 997, 7, None))):
        tw, tb = (weight, bias) if v == HEAD_V else small
        hidden = _hidden(dev, n, d, 520 + n + k).float()
        logits = _logits(hidden, tw, tb)
        route = bucket_f32_route(n, d)
        # (select, label, call, counter): the wrappers as the path calls
        # them, and the tile where N takes the stream
        runs = [("bucket", "", lambda: fused_head_topk(hidden, tw, tb, k), fused_head_topk)]
        if route:
            runs.append(("bucket", " on the tile", lambda: _bucket_f32(hidden, tw, tb, k, 0),
                         None))
        for sel in ("exact", "window"):
            if bv is None and (sel == "exact" or k <= -(-v // 128)):
                runs.append((sel, "", lambda sel=sel: fused_head_topk(hidden, tw, tb, k, sel),
                             fused_head_select))
        for select, label, call, counter in runs:
            name = "fused_head_bucket_f32" if select == "bucket" else "fused_head_select_f32"
            what = f"{name} {select} N={n} D={d} V={v} k={k} bucket_bv={bv or 512}{label}"
            with knobs(**({"MIC_TPU_EXPERIMENTAL": f"bucket_bv={bv}"} if bv else {})):
                before = counter.launches if counter else 0
                got, again = call(), call()
                counted = counter.launches - before if counter else 2
                ref = fused_head_topk_plain(hidden, tw, tb, k, select)
            torch.cuda.synchronize()
            require(counted == 2, f"{what}: {counted} launches counted for two calls")
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"{what}: a second launch is not bit-equal")
            err, ties = _f32_head_case(got, ref, logits, what)
            worst[name] = max(worst[name], err)
            print(f"{what}: lp max_abs_err={err:.3g}, near-tie id differences={ties}, second "
                  f"launch bit-equal", flush=True)
        del logits
    errs.update(worst)
    for n in dict.fromkeys((1024, 4, 1, *cross)):
        hidden = _hidden(dev, n, HEAD_D, 530 + n).float()
        kernel = graph_ms(lambda: fused_head_topk(hidden, weight, bias, 9), reps=3, runs=5)
        times["fused_head_bucket_f32 at", n] = kernel
        if n in (1024, 4):
            times["fused_head_bucket_f32", n] = (kernel, graph_ms(
                lambda: fused_head_topk_plain(hidden, weight, bias, 9, "bucket"), reps=2,
                runs=3), None)
            for sel in ("exact", "window"):
                times["fused_head_select_f32", sel, n] = (
                    graph_ms(lambda: fused_head_topk(hidden, weight, bias, 9, sel), reps=3,
                             runs=5),
                    graph_ms(lambda: fused_head_topk_plain(hidden, weight, bias, 9, sel),
                             reps=2, runs=3), None)
        # the tile where N takes the stream, for the crossover
        if bucket_f32_route(n, HEAD_D):
            times["fused_head_bucket_f32 tile", n] = graph_ms(
                lambda: _bucket_f32(hidden, weight, bias, 9, 0), reps=3, runs=5)
    times["fused_head_bucket_f32"] = times["fused_head_bucket_f32", 1024]
    times["fused_head_select_f32"] = times["fused_head_select_f32", "exact", 1024]
    del weight, bias
    torch.cuda.empty_cache()

    weight, bias = _f32_table(dev, CE_V, CE_D, 54)
    small = _f32_table(dev, 997, 100, 53)
    worst_fwd, worst_dl = 0.0, 0.0
    for n, d, v in ((4096, CE_D, CE_V), (129, 100, 997)):
        tw, tb = (weight, bias) if v == CE_V else small
        hidden, labels = _ce_rows(dev, n, 540 + n, v)
        hidden = hidden.float()[:, :d].contiguous()
        out = flash_ce_forward(hidden, tw, tb, labels)
        ref = flash_ce_forward_plain(hidden, tw, tb, labels)
        torch.cuda.synchronize()
        l1 = torch.cat([(hidden[i:i + 512] @ tw.T + tb).abs().sum(-1) for i in range(0, n, 512)])
        torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=0)
        torch.testing.assert_close(out[1], ref[1], rtol=1e-5, atol=1e-5)
        z_rel = ((out[2] - ref[2]).abs() / l1).max().item()
        require(z_rel < 1e-5, f"flash_ce_forward f32 N={n} V={v}: sum of logits")
        worst_fwd = max(worst_fwd, (out[0] - ref[0]).abs().max().item())
        print(f"flash_ce_forward f32 N={n} D={d} V={v}: lse max_abs_err="
              f"{(out[0] - ref[0]).abs().max().item():.3g}, sum_logits max err / row L1="
              f"{z_rel:.3g}", flush=True)
        lse = ref[0]
        rs = torch.rand((n,), generator=torch.Generator(device=dev).manual_seed(n), device=dev) / n
        rs[::7] = 0.0
        for ls in (0.0, 0.1):
            buf = torch.full((n * v + 64,), 3.0, device=dev)
            dl, dbias = flash_ce_dl(hidden, tw, tb, labels, lse, rs, ls,
                                    out=buf[: n * v].view(n, v))
            rdl, rdbias = flash_ce_dl_plain(hidden, tw, tb, labels, lse, rs, ls)
            torch.cuda.synchronize()
            require(bool(buf[n * v:].eq(3.0).all()), "flash_ce_dl f32 wrote past dl's end")
            require(not dl[rs == 0].any(), "flash_ce_dl f32: a rowscale-0 row is not zero")
            low, conf_low = _targets(ls, v)
            err = 0.0
            for i in range(0, n, 256):
                r = rdl[i:i + 256]
                target = torch.full_like(r, low)
                target.scatter_(1, labels[i:i + 256, None].long(), low + conf_low)
                d_ = (dl[i:i + 256] - r).abs()
                limit = 1e-4 * (r.abs() + 2 * target * rs[i:i + 256, None])
                require(bool((d_ <= limit).all()), f"flash_ce_dl f32 N={n} V={v}: dl beyond 1e-4")
                err = max(err, d_.max().item())
            db = (dbias - rdbias).abs().max().item() / rdbias.abs().max().item()
            require(db < 1e-5, f"flash_ce_dl f32 N={n} V={v}: dbias")
            worst_dl = max(worst_dl, err)
            print(f"flash_ce_dl f32 N={n} V={v} smoothing={ls}: dl max_abs_err={err:.3g}, "
                  f"dbias max err / max |dbias|={db:.3g}, guard intact", flush=True)
            del buf, dl, rdl
    errs["flash_ce_forward_f32"], errs["flash_ce_backward_dl_f32"] = worst_fwd, worst_dl
    n = 4096
    hidden, labels = _ce_rows(dev, n, 550)
    hidden = hidden.float()
    lse = flash_ce_forward_plain(hidden, weight, bias, labels)[0]
    rs = torch.full((n,), 1.0 / n, device=dev)
    product = graph_ms(lambda: torch.mm(hidden, weight.T), reps=2, runs=3)
    times["flash_ce_forward_f32"] = (
        graph_ms(lambda: flash_ce_forward(hidden, weight, bias, labels), reps=2, runs=3),
        graph_ms(lambda: flash_ce_forward_plain(hidden, weight, bias, labels), reps=1, runs=3),
        None)
    times["flash_ce_backward_dl_f32"] = (
        graph_ms(lambda: flash_ce_dl(hidden, weight, bias, labels, lse, rs, 0.1), reps=2, runs=3),
        graph_ms(lambda: flash_ce_dl_plain(hidden, weight, bias, labels, lse, rs, 0.1), reps=1,
                 runs=3), None)
    torch.cuda.empty_cache()
    dl, _ = flash_ce_dl(hidden, weight, bias, labels, lse, rs, 0.1)
    gemms = median_ms(lambda: _dl_gemms(dl, weight, hidden), runs=3)
    del dl
    torch.cuda.empty_cache()
    bounds = f32_bounds(FLAG_B * FLAG_K, 1024, n)
    for name in ("lazy_attention_f32", "fused_head_bucket_f32", "fused_head_select_f32",
                 "flash_ce_forward_f32", "flash_ce_backward_dl_f32"):
        k_ms, p_ms, _ = times[name]
        b_ms, by = bounds[name]
        print(f"{name} time (graph replays): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; bound "
              f"{b_ms:.4f} ms ({by}), the kernel at {b_ms / k_ms:.1%} of it", flush=True)
    for key in (("fused_head_bucket_f32", 4), ("fused_head_select_f32", "exact", 4),
                ("fused_head_select_f32", "window", 1024), ("fused_head_select_f32", "window", 4)):
        k_ms, p_ms, _ = times[key]
        b_ms, by = f32_bounds(FLAG_B * FLAG_K, key[-1], n)[key[0]]
        print(f"{' '.join(map(str, key[:-1]))} at N={key[-1]} (graph replays): kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms; bound {b_ms:.4f} ms ({by}), the kernel at "
              f"{b_ms / k_ms:.1%} of it", flush=True)
    for m in dict.fromkeys((1, 4, *cross)):
        taken = times["fused_head_bucket_f32 at", m]
        if bucket_f32_route(m, HEAD_D):
            print(f"fused_head_bucket_f32 routes at N={m} (graph replays): the stream, the route "
                  f"taken, {taken:.4f} ms; the tile {times['fused_head_bucket_f32 tile', m]:.4f} "
                  f"ms", flush=True)
        else:
            print(f"fused_head_bucket_f32 routes at N={m} (graph replays): the tile, the route "
                  f"taken, {taken:.4f} ms", flush=True)
    print(f"for scale only (not the same function): cuBLAS f32 torch.mm(h, W.T), TF32 off, at "
          f"N={n}: {product:.4f} ms, {bounds['flash_ce_forward_f32'][0] / product:.1%} of the "
          f"2 N D V f32 bound; the f32 dl route's dh and demb products (torch.mm, TF32 off) "
          f"{gemms:.4f} ms", flush=True)
    times["cublas_f32_product"] = product
    return errs, times


@contextlib.contextmanager
def plain_versions(*swaps):
    """Swap kernel wrappers for their plain versions where the path looks
    them up ((module, name, plain) each), so a run on the card takes the
    plain PyTorch versions; restored after."""
    old = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for module, name, fn in old:
            setattr(module, name, fn)


def run_f32_generate(dev):
    """Phase 52: the default float32 flagship serves on the card.
    CaptionerConfig.clip_vit_b32_mbart50() at its own dtype (float32),
    random weights from phase 5's seed, serving params in float32: a beam-4
    generate of B=256 images, length 64, every caption's EOS pinned at
    position 63 (all 63 steps), under each select (the bucket, the card's
    default, then MIC_TPU_FUSED_SELECT=exact and =window), the counters set
    to 0 just before it and read just after: row 1 (f32) 12 times a step,
    the select's head kernel (row 4 f32 for the bucket, row 5 f32 for
    exact and window) at least once a step, no other serving kernel.  Then
    under each select at B=2 the same generate with rows 1 and 4/5 swapped
    for their plain versions on the card (TF32 off): sequences equal,
    scores within 1e-4 (f32 sums in another order) -> launches (the bucket
    run's rows 1 and 4, the exact run's row 5; rows 11 and 12 f32 read
    from the counted generates, summed)."""
    import mic_tpu_torch.models.captioner as captioner_mod
    import mic_tpu_torch.nn.attention as attention_mod
    from mic_tpu_torch.core.config import CaptionerConfig
    from mic_tpu_torch.core.params import make_serving_params
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.fused_head import fused_head_topk_plain
    from mic_tpu_torch.ops.image_prep import preprocess_images
    from mic_tpu_torch.ops.lazy_attention import lazy_attention_plain

    config = CaptionerConfig.clip_vit_b32_mbart50()
    require(config.dtype == "float32", f"the flagship's default dtype is {config.dtype}")
    params = make_serving_params(
        init_params(config, torch.Generator(device=dev).manual_seed(0), dev), torch.float32)
    model = Captioner(config)
    kw = dict(num_beams=4, max_length=64, forced_bos_token_id=FLAGSHIP_BOS)
    u8 = np.random.default_rng(52).integers(0, 256, (256, 256, 256, 3), dtype=np.uint8)
    px = preprocess_images(torch.from_numpy(u8).to(dev), config.vision.image_size, torch.float32)
    eos = torch.full((256,), 63, device=dev)
    launches, attention = {}, {}
    for select, head, row in (("bucket", "fused_head", "fused_head_bucket_f32"),
                              ("exact", "fused_head_select", "fused_head_select_f32"),
                              ("window", "fused_head_select", "fused_head_select_f32")):
        with knobs(MIC_TPU_FUSED_SELECT=select):
            model.generate(params, px[:4], eos_positions=eos[:4], **kw)  # warm-up
            _train_counts(reset=True)
            out, counts, seconds = generate_counted(
                lambda x: model.generate(params, x, eos_positions=eos, **kw), px)
            for name, count in _f32_attention_counts().items():
                attention[name] = attention.get(name, 0) + count
            seqs = check_path_output(out, 256, 64, f"float32 flagship, {select}")
            check_pinned(seqs, eos.cpu(), config.decoder.eos_token_id,
                         config.decoder.pad_token_id, f"float32 flagship, {select}")
            found = {"lazy_attention_f32": counts.pop("lazy_attention"), row: counts.pop(head)}
            print(f"float32 flagship (CaptionerConfig.clip_vit_b32_mbart50(), dtype float32), "
                  f"select {select}: B=256 beam 4 length 64, {out.steps} steps in "
                  f"{seconds:.3f} s = {256 / seconds:.1f} captions/s (smoke figure, not a "
                  f"benchmark), launches {found}", flush=True)
            require(found["lazy_attention_f32"] == config.decoder.num_layers * out.steps,
                    f"float32 {select}: row 1 launches != layers x decode steps")
            require(found[row] >= out.steps, f"float32 {select}: {row} under once a step")
            require(not any(counts.values()),
                    f"float32 {select}: other serving kernels launched: {counts}")
            if select != "window":
                launches.update(found)
            small = (px[:2], eos[:2])
            got = model.generate(params, small[0], eos_positions=small[1], **kw)
            with plain_versions((attention_mod, "lazy_attention", lazy_attention_plain),
                                (captioner_mod, "fused_head_topk", fused_head_topk_plain)):
                ref = model.generate(params, small[0], eos_positions=small[1], **kw)
        torch.cuda.synchronize()
        score_err = (got.scores - ref.scores).abs().max().item()
        same = torch.equal(got.sequences, ref.sequences)
        print(f"float32 flagship at B=2, select {select}, kernels vs plain versions on the "
              f"card: sequences equal={same}, max score difference={score_err:.3g}", flush=True)
        require(same, f"float32 {select}: the kernels' sequences differ from the plain versions'")
        require(score_err < 1e-4,
                f"float32 {select}: the kernels' scores differ from the plain versions'")
    print(f"float32 flagship, the three selects' generates: rows 11 and 12 f32 launched "
          f"{attention}", flush=True)
    return {**launches, **attention}


def run_f32_training(dev):
    """Phase 53: the default float32 flagship trains on the card: the port's
    Trainer at the TrainConfig defaults (batch 64 x 64, dropout 0.1, remat
    "masks", fused CE on "auto", which is the dl route on CUDA, bf16
    moments, no shadow at float32) with warmup_steps=2, three steps from
    one seed, the training counters set to 0 just before them and read
    just after: rows 7 and 8 (f32) once a step.  Then the same three steps
    with rows 7 and 8 swapped for their plain versions on the card (the
    plain "dl" route; TF32 off): the first loss (the forward alone) within
    1e-5 relative of the plain route's, the next two within 1e-4 (the
    gradients' sums in another order move the params by f32 rounding)
    -> launches (with rows 11 and 12 f32's, read from the counted steps)."""
    import mic_tpu_torch.ops.fused_ce as fused_ce_mod
    from mic_tpu_torch.core.config import CaptionerConfig, DataConfig, TrainConfig
    from mic_tpu_torch.ops.flash_ce import flash_ce_backward_dl_plain, flash_ce_forward_plain
    from mic_tpu_torch.train.trainer import Trainer

    config = CaptionerConfig.clip_vit_b32_mbart50()
    tc = TrainConfig(warmup_steps=2)
    host = _train_batches(config, 3, tc.per_device_batch_size, DataConfig().max_seq_length, 53)
    runs = {}
    for label in ("kernels", "plain"):
        swaps = (() if label == "kernels" else (
            (fused_ce_mod, "flash_ce_forward", flash_ce_forward_plain),
            (fused_ce_mod, "flash_ce_backward_dl", flash_ce_backward_dl_plain)))
        t0 = time.perf_counter()
        trainer = Trainer(config, DataConfig(), tc, device=dev)
        trainer.build(steps_per_epoch=len(host))
        state = trainer.init_state()
        require(state.shadow is None, "float32: a shadow was made")
        batches = [trainer.put_batch(b) for b in host]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _train_counts(reset=True)
        losses, ms = [], []
        with plain_versions(*swaps):
            for batch in batches:
                t1 = time.perf_counter()
                state, metrics = trainer.train_step(state, batch)
                losses.append(metrics["loss"].item())
                ms.append((time.perf_counter() - t1) * 1e3)
        attention = _f32_attention_counts()
        got = {k: v for k, v in _train_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"float32 flagship training, {label}: losses {losses}, launches {got}, peak "
              f"allocated {peak:.2f} GiB, step times {[round(x, 1) for x in ms]} ms (smoke "
              f"figures), {time.perf_counter() - t0:.1f} s with init", flush=True)
        require(all(np.isfinite(losses)), f"float32 training ({label}): a non-finite loss")
        runs[label] = (losses, got, attention)
        del trainer, state, batches
        torch.cuda.empty_cache()
    (losses, got, attention), (plain, plain_got, _) = runs["kernels"], runs["plain"]
    require(got == {"flash_ce_forward": 3, "flash_ce_backward_dl": 3},
            f"float32 training: launches {got}")
    require(not plain_got, f"float32 training: the plain route launched {plain_got}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    print(f"float32 training: kernels' losses against the plain dl route's, relative "
          f"differences {[f'{r:.3g}' for r in rel]} (limits 1e-5, 1e-4, 1e-4)", flush=True)
    require(rel[0] <= 1e-5 and max(rel[1:]) <= 1e-4,
            "float32 training: the losses differ from the plain dl route's")
    return {"flash_ce_forward_f32": got["flash_ce_forward"],
            "flash_ce_backward_dl_f32": got["flash_ce_backward_dl"], **attention}


def run_training_options(dev, root):
    """Phase 54: the rest of single-card training at flagship width in bf16
    (TrainConfig defaults, warmup_steps=2, one batch of 64 x 64): one step
    under fused_adamw=False (the optax chain, with adam_nu_dtype float32:
    the moments' dtypes checked), and one step under each of remat "none",
    "masks" and "dots" from the same seed, bit-equal losses, with the peak
    memory each step allocates and what its forward holds for the backward;
    then Trainer.train() over a TSV of 16 PNGs
    in batches of 8 with profile_steps "0:2": a Chrome trace with CUDA
    kernel events under <output_dir>/profile."""
    from mic_tpu_torch.core.config import CaptionerConfig, DataConfig, TrainConfig
    from mic_tpu_torch.core.params import tree_leaves
    from mic_tpu_torch.data.tokenizer import SimpleTokenizer
    from mic_tpu_torch.train.adamw_chain import AdamWChainState
    from mic_tpu_torch.train.trainer import Trainer

    config = CaptionerConfig.clip_vit_b32_mbart50(dtype="bfloat16")
    host = _train_batches(config, 1, 64, DataConfig().max_seq_length, 54)[0]

    def one_step(**kw):
        t0 = time.perf_counter()
        trainer = Trainer(config, DataConfig(), TrainConfig(warmup_steps=2, **kw), device=dev)
        trainer.build(steps_per_epoch=1)
        state = trainer.init_state()
        batch = trainer.put_batch(host)
        forward = trainer.compute_loss
        held = []

        def compute_loss(*args, **kwargs):  # what the forward leaves for the backward
            loss = forward(*args, **kwargs)
            torch.cuda.synchronize()
            held.append(torch.cuda.memory_allocated())
            return loss

        trainer.compute_loss = compute_loss
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, metrics = trainer.train_step(state, batch)
        loss = metrics["loss"].item()
        peak = torch.cuda.max_memory_allocated()
        require(np.isfinite(loss), f"training options {kw}: a non-finite loss")
        print(f"training option {kw}: loss {loss:.6f}, peak allocated {peak / 2**30:.2f} GiB "
              f"({(peak - base) / 2**30:.2f} GiB above the state before the step; "
              f"{(held[0] - base) / 2**30:.2f} GiB held from the forward for the backward), "
              f"{time.perf_counter() - t0:.1f} s with init", flush=True)
        return trainer, state, loss

    trainer, state, _ = one_step(fused_adamw=False, adam_nu_dtype="float32")
    require(isinstance(state.opt_state, AdamWChainState), "fused_adamw=False: not the chain")
    require(all(leaf.dtype == torch.bfloat16 for _, leaf in tree_leaves(state.opt_state.mu))
            and all(leaf.dtype == torch.float32 for _, leaf in tree_leaves(state.opt_state.nu)),
            "fused_adamw=False: moment dtypes")
    del trainer, state
    torch.cuda.empty_cache()
    losses = {}
    for remat in ("none", "masks", "dots"):
        trainer, state, losses[remat] = one_step(remat=remat)
        del trainer, state
        torch.cuda.empty_cache()
    require(losses["dots"] == losses["masks"] == losses["none"],
            f"remat policies gave other losses: {losses}")
    tsv, images, captions = _caption_tsv(root, n=16, seed=54)
    tok = SimpleTokenizer()
    tok.fit(captions)
    out = os.path.join(root, "profiled")
    trainer = Trainer(config, DataConfig(train_file=tsv, images_dir=images, num_workers=0),
                      TrainConfig(output_dir=out, per_device_batch_size=8, num_epochs=1,
                                  warmup_steps=1, profile_steps="0:2", save_steps=1000),
                      tokenizer=tok, device=dev)
    t0 = time.perf_counter()
    trainer.train()
    traces = sorted(os.listdir(os.path.join(out, "profile")))
    require(len(traces) == 1 and traces[0].endswith(".json"), f"profile/ holds {traces}")
    with open(os.path.join(out, "profile", traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"profile_steps 0:2 through Trainer.train (2 steps of 8, {time.perf_counter() - t0:.1f}"
          f" s with its saves): profile/{traces[0]}, {len(events)} events, {kernels} device "
          "kernel events", flush=True)
    require(kernels > 0, "the profiler trace holds no device kernel")
    del trainer
    torch.cuda.empty_cache()


# -- phases 55-57: the second captioner family, the translator, the HF format

VB_B = 64  # images of phase 55's ViT-B/16 + BART-large batch
TR_B, TR_S = 64, 48  # source rows of phase 56's translator batch, padded to 48 tokens
TR_BOS = 250004  # the target language code forced at position 1 (en_XX)
BART_BOS = 0  # BART's <s>, forced at position 1 as bart-large generates


@contextlib.contextmanager
def shadowed(*swaps):
    """Each kernel wrapper runs as the path calls it, then its plain version
    on the same positional inputs (the wrapper's keyword arguments, such as
    row 3's ``positions``, bound only the kernel's walk), and
    ``check(args, out, ref) -> (error, near-tie
    id differences)`` holds the two ((module, name, plain, written, check)
    each).  ``written(args)``, where not None, copies the cache cells the
    wrapper writes in place: they must be bit-equal after the plain version
    writes them again.  -> {name: [calls, largest error, near-tie id
    differences]}.  These launches count in the wrappers' counters: no
    counted run is made under it."""
    stats = {name: [0, 0.0, 0] for _, name, _, _, _ in swaps}
    old = [(module, name, getattr(module, name)) for module, name, _, _, _ in swaps]

    def make(name, kernel, plain, written, check):
        def run(*args, **kwargs):
            out = kernel(*args, **kwargs)
            cells = None if written is None else written(args)
            ref = plain(*args)
            require(cells is None or torch.equal(cells, written(args)),
                    f"{name}: the cells it wrote differ from its plain version's")
            err, ties = check(args, out, ref)
            entry = stats[name]
            entry[0] += 1
            entry[1] = max(entry[1], err)
            entry[2] += ties
            return out
        # a wrapper that counts through its own module's name (ops/ln_gemm.py
        # looks up ``ln_gemm.launches``) finds this stand-in there
        run.launches = 0
        return run

    for (module, name, plain, written, check), (_, _, kernel) in zip(swaps, old):
        setattr(module, name, make(name, kernel, plain, written, check))
    try:
        yield stats
    finally:
        for module, name, fn in old:
            setattr(module, name, fn)


def _check_attention(args, out, ref):
    """Rows 1 and 18 on the path: within phases 2's and 18's 2e-2."""
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    return (out.float() - ref.float()).abs().max().item(), 0


def _lazy_column(args):
    """Row 1's written cells: column ``index`` of both lazy caches."""
    cache_k, cache_v, index = args[1], args[2], args[6]
    return torch.stack([cache_k[:, index], cache_v[:, index]])


def _decode_column(args):
    """Row 18's written cells: column ``index`` of layer ``layer``."""
    self_k, self_v, layer, index = args[3], args[4], args[5], args[6]
    return torch.stack([self_k[layer, :, index], self_v[layer, :, index]])


def _check_head(args, out, ref):
    """Row 4 on the path: phase 3's tolerances (ids equal but at near
    ties)."""
    from mic_tpu_torch.ops.fused_head import _logits

    hidden, weight, bias, k = args[:4]
    return _bf16_head_case(out, ref, _logits(hidden, weight, bias), f"fused_head k={k} on the "
                           "path", True)


def _check_topk(args, out, ref):
    """Row 17 on the path: ids equal, log-probs within phase 19's 1e-5."""
    require(torch.equal(out[1], ref[1]), "topk_log_probs: ids differ from plain on the path")
    err = (out[0] - ref[0]).abs().max().item()
    require(err <= 1e-5, "topk_log_probs: log-probs differ from plain on the path")
    return err, 0


def _check_permute(args, out, ref):
    require(torch.equal(out, ref), "beam_permute: a plane differs from plain on the path")
    return 0.0, 0


def _print_shadow(label, stats):
    print(f"{label}, every launch beside its plain version on the same inputs: " + ", ".join(
        f"{name} {calls} calls, max_abs_err {err:.3g}, near-tie id differences {ties}"
        for name, (calls, err, ties) in stats.items()), flush=True)
    require(all(calls > 0 for calls, _, _ in stats.values()), f"{label}: a kernel never ran")


def _require_rerun_identical(label, first, second):
    """The shadowed rerun returns the kernels' own outputs: its sequences and
    scores must equal the counted run's bit for bit."""
    same = torch.equal(first.sequences, second.sequences) and torch.equal(first.scores,
                                                                           second.scores)
    print(f"{label}: second run gave identical sequences and scores={same}", flush=True)
    require(same, f"{label}: a second run of the kernels gave other sequences or scores")


def _token_share(got, ref):
    """(images with equal sequences, share of tokens equal)."""
    got, ref = got.cpu(), ref.cpu()
    return int((got == ref).all(1).sum()), float((got == ref).float().mean())


def _vit_bart_pixels(dev, config, n, seed, dtype):
    from mic_tpu_torch.ops.image_prep import preprocess_images

    u8 = np.random.default_rng(seed).integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)
    return preprocess_images(torch.from_numpy(u8).to(dev), config.vision.image_size, dtype)


def _small_against_cpu(label, run, params, inputs_card, inputs_cpu, limit, kernels):
    """``run(params, *inputs)`` on the card and on the CPU (plain versions)
    from the same weights: equal sequences, scores within ``limit``, each
    of ``kernels`` launched on the card."""
    from mic_tpu_torch.core.params import tree_map

    gpu, counts, _ = generate_counted(lambda _: run(params, *inputs_card), None)
    cpu = run(tree_map(lambda x: x.cpu(), params), *inputs_cpu)
    score_err = (gpu.scores.cpu() - cpu.scores).abs().max().item()
    same = torch.equal(gpu.sequences.cpu(), cpu.sequences)
    print(f"small width, {label}, card vs CPU: sequences equal={same}, max score difference="
          f"{score_err:.3g}, card launches " + ", ".join(f"{k} {counts[k]}" for k in kernels),
          flush=True)
    require(all(counts[k] > 0 for k in kernels), f"{label}: a kernel never ran on the card")
    require(same, f"{label}: card and CPU sequences differ")
    require(score_err < limit, f"{label}: card and CPU scores differ")


def run_vit_bart_path(dev):
    """Phase 55: the ViT-B/16 + BART-large captioner
    (CaptionerConfig.vit_b16_bart_large: a ViT tower of 12 x 768, patch 16,
    197 rows; a post-norm 12-layer BART-large decoder, d_model 1024, 16
    heads of 64, tied head of V = 50265) at full width and depth in bf16,
    random weights from seed 55: B=64 uint8 images of 256 x 256 through
    preprocess_images and a beam-4 generate of length 64, EOS pinned at 63
    (all 63 steps), the counters set to 0 just before it and read just
    after: row 1 twelve times a step, row 4 once a step, no other kernel;
    then the same generate with every row-1 and row-4 launch held against
    its plain version on the same inputs, its sequences and scores
    identical to the first run's, and beside a whole run on the
    plain versions (bf16 paths part at near-ties: the share of tokens equal
    is printed); in float32 (rows 1 and 4 in f32) at B=8 the sequences equal
    to the plain versions' on the card; row 4 timed at N=256, V=50265; a
    2-layer narrow ViT+BART config (row 4 at V=1100, post-norm) and an
    untied-head one (dense logits) on the card against the CPU."""
    import mic_tpu_torch.models.captioner as captioner_mod
    import mic_tpu_torch.nn.attention as attention_mod
    from mic_tpu_torch.core.config import CaptionerConfig, DecodeConfig, DecoderConfig, VisionConfig
    from mic_tpu_torch.core.params import make_serving_params
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.fused_head import fused_head_topk, fused_head_topk_plain
    from mic_tpu_torch.ops.image_prep import preprocess_images
    from mic_tpu_torch.ops.lazy_attention import lazy_attention_plain

    t_phase = time.perf_counter()
    config = CaptionerConfig.vit_b16_bart_large(dtype="bfloat16")
    dec = config.decoder
    require(config.vision.seq_len == 197 and dec.vocab_size == 50265 and dec.post_norm
            and not dec.use_final_ln and not config.vision.use_pre_ln,
            "vit_b16_bart_large is not the ViT-B/16 + BART-large preset")
    full = init_params(config, torch.Generator(device=dev).manual_seed(55), dev)
    params = make_serving_params(full)
    model = Captioner(config)
    kw = dict(num_beams=4, max_length=64, forced_bos_token_id=BART_BOS)
    px = _vit_bart_pixels(dev, config, VB_B, 55, torch.bfloat16)
    eos = torch.full((VB_B,), 63, device=dev)
    model.generate(params, px[:4], eos_positions=eos[:4], **kw)  # warm-up
    out, counts, seconds = generate_counted(
        lambda x: model.generate(params, x, eos_positions=eos, **kw), px)
    seqs = out.sequences.cpu()
    require(seqs.shape == (VB_B, 64) and bool((seqs[:, 1] == BART_BOS).all())
            and bool(torch.isfinite(out.scores).all()), "ViT+BART: malformed output")
    check_pinned(seqs, eos.cpu(), dec.eos_token_id, dec.pad_token_id, "ViT+BART")
    launches = {"lazy_attention": counts.pop("lazy_attention"),
                "fused_head": counts.pop("fused_head")}
    print(f"ViT-B/16 + BART-large (bf16): B={VB_B} beam 4 length 64, {out.steps} steps in "
          f"{seconds:.3f} s = {VB_B / seconds:.1f} captions/s (smoke figure, not a benchmark), "
          f"launches {launches}", flush=True)
    require(out.steps == 63, "ViT+BART: the pinned EOS did not run all 63 steps")
    require(launches["lazy_attention"] == dec.num_layers * out.steps,
            "ViT+BART: row 1 launches != layers x steps")
    require(launches["fused_head"] == out.steps, "ViT+BART: row 4 launches != steps")
    require(not any(counts.values()), f"ViT+BART: other serving kernels launched: {counts}")

    with shadowed((attention_mod, "lazy_attention", lazy_attention_plain, _lazy_column,
                   _check_attention),
                  (captioner_mod, "fused_head_topk", fused_head_topk_plain, None,
                   _check_head)) as stats:
        again = model.generate(params, px, eos_positions=eos, **kw)
    torch.cuda.synchronize()
    _print_shadow(f"ViT+BART B={VB_B}", stats)
    _require_rerun_identical("ViT+BART", out, again)
    with plain_versions((attention_mod, "lazy_attention", lazy_attention_plain),
                        (captioner_mod, "fused_head_topk", fused_head_topk_plain)):
        ref = model.generate(params, px, eos_positions=eos, **kw)
    images, share = _token_share(out.sequences, ref.sequences)
    print(f"ViT+BART bf16, a whole run on the plain versions on the card: {images} of {VB_B} "
          f"captions equal, tokens equal {share:.4f} (bf16 paths part at near-ties)", flush=True)

    f32_model = Captioner(config.replace(dtype="float32"))
    px32 = _vit_bart_pixels(dev, config, 8, 56, torch.float32)
    kw32 = dict(kw, eos_positions=eos[:8])
    got = f32_model.generate(full, px32, **kw32)
    with plain_versions((attention_mod, "lazy_attention", lazy_attention_plain),
                        (captioner_mod, "fused_head_topk", fused_head_topk_plain)):
        ref = f32_model.generate(full, px32, **kw32)
    torch.cuda.synchronize()
    score_err = (got.scores - ref.scores).abs().max().item()
    same = torch.equal(got.sequences, ref.sequences)
    print(f"ViT+BART float32 at B=8, rows 1 and 4 (f32) vs the plain versions on the card: "
          f"sequences equal={same}, max score difference={score_err:.3g}", flush=True)
    require(same, "ViT+BART float32: the kernels' sequences differ from the plain versions'")
    require(score_err < 1e-4, "ViT+BART float32: the scores differ from the plain versions'")
    del full, px32, got, ref

    hidden = _hidden(dev, 256, dec.d_model, 55)
    weight, bias = params["shared"]["embedding"], params["final_logits_bias"]
    ms = (graph_ms(lambda: fused_head_topk(hidden, weight, bias, 9)),
          graph_ms(lambda: fused_head_topk_plain(hidden, weight, bias, 9, "bucket")),
          median_ms(lambda: fused_head_topk(hidden, weight, bias, 9)))
    head_b = head_bound(256, dec.d_model, dec.vocab_size, 9, 2, "bf16")
    print(f"fused_head_bucket N=256 D=1024 V=50265 k=9 time: kernel {ms[0]:.4f} ms (graph "
          f"replays; {ms[2]:.4f} per call with its wrapper), plain {ms[1]:.4f} ms, bound "
          f"{head_b[0]:.4f} ms ({head_b[1]}), {100 * head_b[0] / ms[0]:.0f}% of the bound",
          flush=True)
    del params, model, px, out

    vit = dict(hidden_act="gelu", use_pre_ln=False, final_ln_output=True, patch_bias=True,
               layer_norm_eps=1e-12)
    bart = dict(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                max_position_embeddings=64, scale_embedding=False, post_norm=True,
                use_final_ln=False)
    u8 = torch.from_numpy(np.random.default_rng(57).integers(0, 256, (4, 40, 40, 3),
                                                             dtype=np.uint8))
    small_kw = dict(num_beams=4, max_length=16, forced_bos_token_id=7)
    for label, tie, kernels in (("ViT+BART style, tied (bucket head)", True,
                                 ("lazy_attention", "fused_head")),
                                ("ViT+BART style, untied head (dense logits)", False,
                                 ("lazy_attention",))):
        small = CaptionerConfig(vision=VisionConfig.tiny(**vit), decoder=DecoderConfig.tiny(**bart),
                                decode=DecodeConfig(fused_head="1", fused_select="bucket"),
                                tie_word_embeddings=tie, dtype="bfloat16")
        sp = make_serving_params(init_params(small, torch.Generator(device=dev).manual_seed(58),
                                             dev))
        smodel = Captioner(small)
        _small_against_cpu(label, lambda p, x: smodel.generate(p, x, **small_kw), sp,
                           (preprocess_images(u8.to(dev), 32, torch.bfloat16),),
                           (preprocess_images(u8, 32, torch.bfloat16),), 2e-2, kernels)
    print(f"phase 55 took {time.perf_counter() - t_phase:.1f} s", flush=True)


def _translator_sources(dev, n, s, seed, vocab, extra_pad=0):
    """Source rows of 8-48 random tokens right-padded to ``s`` (pad id 1),
    then ``extra_pad`` more pad columns, and their masks (1 = token)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(8, 49, n)
    mask = np.arange(s)[None, :] < lengths[:, None]
    ids = np.where(mask, rng.integers(4, vocab, (n, s)), 1)
    ids = np.pad(ids, ((0, 0), (0, extra_pad)), constant_values=1)
    mask = np.pad(mask, ((0, 0), (0, extra_pad)))
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(mask.astype(np.int64)).to(dev))


def run_translator_path(dev):
    """Phase 56: the mBART-50 translator, MBartSeq2Seq(DecoderConfig()) (12
    encoder + 12 decoder layers, d_model 1024, V = 250054) at full width in
    bf16, random weights from seed 56: B=64 source rows of 8-48 tokens,
    right-padded with their masks, target BOS forced, beam 4, max_length 64,
    on the physical cache: row 19 twice a step, no other kernel, and the
    sequences equal to a run on row 19's plain version (a copy: bit-equal);
    under MIC_TPU_EXPERIMENTAL=fused_decode,pallas_topk rows 18 twelve
    times a step and 17 once a non-forced step besides, every launch of
    rows 17, 18 and 19 held against its plain version on the same inputs
    in a rerun identical to the counted run, and a whole run on the plain versions beside it (the share of tokens
    equal printed); in float32 the same sources padded by 16 more tokens
    give the same beams; row 19 timed on the translator's plane (12, 256,
    64, 16, 64); a small config on the card against the CPU under both
    knob sets."""
    import mic_tpu_torch.generate.search as search_mod
    import mic_tpu_torch.models.mbart_decoder as decoder_mod
    import mic_tpu_torch.nn.cache as cache_mod
    from mic_tpu_torch.core.config import DecoderConfig
    from mic_tpu_torch.core.params import make_serving_params
    from mic_tpu_torch.models.mbart_seq2seq import MBartSeq2Seq
    from mic_tpu_torch.ops.beam_permute import beam_permute, beam_permute_plain
    from mic_tpu_torch.ops.decode_attention import decode_attention_plain
    from mic_tpu_torch.ops.topk_lse import topk_log_probs_plain

    t_phase = time.perf_counter()
    cfg = DecoderConfig()
    layers = cfg.num_layers
    full = MBartSeq2Seq(cfg).init_params(torch.Generator(device=dev).manual_seed(56), dev)
    params = make_serving_params(full)
    model = MBartSeq2Seq(cfg, dtype=torch.bfloat16)
    kw = dict(num_beams=4, max_length=64, forced_bos_token_id=TR_BOS)
    ids, mask = _translator_sources(dev, TR_B, TR_S, 56, cfg.vocab_size)
    model.generate(params, ids[:4], mask[:4], **kw)  # warm-up

    def translate(m, p, i, k):
        return m.generate(p, i, k, **kw)

    out, counts, seconds = generate_counted(lambda x: translate(model, params, x, mask), ids)
    steps = out.steps
    require(out.sequences.shape == (TR_B, 64) and bool((out.sequences[:, 1] == TR_BOS).all())
            and bool(torch.isfinite(out.scores).all()), "translator: malformed output")
    permutes = counts.pop("beam_permute")
    print(f"mBART-50 translator (bf16): B={TR_B} sources of 8-48 tokens, beam 4 max_length 64, "
          f"{steps} steps in {seconds:.3f} s = {TR_B / seconds:.1f} translations/s (smoke "
          f"figure, not a benchmark), launches beam_permute {permutes}", flush=True)
    require(permutes == 2 * steps, "translator: row 19 launches != 2 x steps")
    require(not any(counts.values()), f"translator: other serving kernels launched: {counts}")
    with plain_versions((cache_mod, "beam_permute", beam_permute_plain)):
        ref = translate(model, params, ids, mask)
    require(torch.equal(out.sequences, ref.sequences) and torch.equal(out.scores, ref.scores),
            "translator: row 19's path differs from its plain version's")
    print("translator: a whole run on row 19's plain version gave the same sequences and "
          "scores", flush=True)

    switches = dict(MIC_TPU_EXPERIMENTAL="fused_decode,pallas_topk")
    with knobs(**switches):
        fused, counts, seconds = generate_counted(
            lambda x: translate(model, params, x, mask), ids)
        forced = 1 + (fused.steps == kw["max_length"] - 1)  # BOS, and EOS at max_length - 1
        want = {"decode_attention": layers * fused.steps, "topk_log_probs": fused.steps - forced,
                "beam_permute": 2 * fused.steps}
        got = {name: counts.pop(name) for name in want}
        print(f"translator under fused_decode,pallas_topk: {fused.steps} steps ({forced} forced) "
              f"in {seconds:.3f} s = {TR_B / seconds:.1f} translations/s (smoke figure), "
              f"launches {got}", flush=True)
        require(got == want, f"translator under fused_decode,pallas_topk: launches {got}, "
                f"want {want}")
        require(not any(counts.values()), f"translator: other kernels launched: {counts}")
        with shadowed((decoder_mod, "decode_attention", decode_attention_plain, _decode_column,
                       _check_attention),
                      (search_mod, "topk_log_probs", topk_log_probs_plain, None, _check_topk),
                      (cache_mod, "beam_permute", beam_permute_plain, None,
                       _check_permute)) as stats:
            again = translate(model, params, ids, mask)
        torch.cuda.synchronize()
        _print_shadow(f"translator B={TR_B} under fused_decode,pallas_topk", stats)
        _require_rerun_identical("translator under fused_decode,pallas_topk", fused, again)
        with plain_versions((decoder_mod, "decode_attention", decode_attention_plain),
                            (search_mod, "topk_log_probs", topk_log_probs_plain),
                            (cache_mod, "beam_permute", beam_permute_plain)):
            ref = translate(model, params, ids, mask)
    images, share = _token_share(fused.sequences, ref.sequences)
    print(f"translator under fused_decode,pallas_topk, a whole run on the plain versions: "
          f"{images} of {TR_B} translations equal, tokens equal {share:.4f}", flush=True)

    pids, pmask = _translator_sources(dev, TR_B, TR_S, 56, cfg.vocab_size, extra_pad=16)
    require(torch.equal(pids[:, :TR_S], ids), "the padded sources are not the same sources")
    padded = translate(model, params, pids, pmask)
    images, share = _token_share(padded.sequences, out.sequences)
    print(f"translator bf16, sources padded by 16 more tokens: {images} of {TR_B} equal, "
          f"tokens equal {share:.4f}", flush=True)
    f32 = MBartSeq2Seq(cfg)
    a = translate(f32, full, ids, mask)
    b = translate(f32, full, pids, pmask)
    score_err = (a.scores - b.scores).abs().max().item()
    print(f"translator float32, sources padded by 16 more tokens: sequences equal="
          f"{torch.equal(a.sequences, b.sequences)}, max score difference {score_err:.3g}",
          flush=True)
    require(torch.equal(a.sequences, b.sequences), "translator: padding changed the beams")
    require(score_err < 1e-4, "translator: padding changed the scores")
    del full, params, a, b, out, fused, ref, padded

    plane = (layers, TR_B * 4, 64, cfg.num_heads, cfg.head_dim)
    g = torch.Generator(device=dev).manual_seed(59)
    kv = torch.randn(plane, generator=g, device=dev, dtype=torch.bfloat16)
    idx = torch.randint(0, 4, (TR_B, 4), generator=g, device=dev)
    require(torch.equal(beam_permute(kv, idx, 4), beam_permute_plain(kv, idx, 4)),
            "beam_permute: the translator's plane differs from plain")
    rows = (torch.arange(TR_B, device=dev)[:, None] * 4 + idx).reshape(-1)
    ms = (median_ms(lambda: beam_permute(kv, idx, 4), runs=25),
          median_ms(lambda: beam_permute_plain(kv, idx, 4), runs=25),
          median_ms(lambda: kv.index_select(1, rows), runs=25))
    permute_b = bound(2 * 2 * kv.numel(), 0, "bf16")
    print(f"beam_permute {plane} bf16 time (per call): kernel {ms[0]:.4f} ms, plain "
          f"{ms[1]:.4f} ms, index_select {ms[2]:.4f} ms, bound {permute_b[0]:.4f} ms "
          f"({permute_b[1]}), {100 * permute_b[0] / ms[0]:.0f}% of the bound", flush=True)
    del kv

    small_cfg = DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                                   max_position_embeddings=64)
    small = MBartSeq2Seq(small_cfg, dtype=torch.bfloat16)
    sp = make_serving_params(small.init_params(torch.Generator(device=dev).manual_seed(60), dev))
    sids, smask = _translator_sources(dev, 4, TR_S, 61, small_cfg.vocab_size)
    small_kw = dict(num_beams=4, max_length=16, forced_bos_token_id=7)
    for label, env, kernels in (("translator", {}, ("beam_permute",)),
                                ("translator under fused_decode,pallas_topk", switches,
                                 ("beam_permute", "decode_attention", "topk_log_probs"))):
        with knobs(**env):
            _small_against_cpu(label, lambda p, i, m: small.generate(p, i, m, **small_kw), sp,
                               (sids, smask), (sids.cpu(), smask.cpu()), 2e-2, kernels)
    print(f"phase 56 took {time.perf_counter() - t_phase:.1f} s", flush=True)


def _timed_fsync(write, path):
    """write(path), flushed to disk -> (bytes, seconds) (for writers that do
    not fsync themselves)."""
    t0 = time.perf_counter()
    write(path)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    return os.path.getsize(path), time.perf_counter() - t0


def run_hf_format_path(dev, root):
    """Phase 57: the reference's checkpoint formats at flagship width.  The
    flagship's random float32 params (seed 57) through the port's
    export_hf_fused (config.json + flax_model.msgpack), then
    Captioner.from_pretrained on that directory: every leaf bit-equal, and
    a B=8 beam-4 bf16 generate equal to the one from the original params;
    the towers as HF PyTorch state dicts (tools/torch_hf_towers.py), CLIP
    written as model.safetensors and mBART as pytorch_model.bin, read by
    load_pretrained_towers: every leaf but the fresh proj bit-equal.  Bytes and seconds of each write
    (fsync'd) and read (warm page cache); the directories deleted."""
    from mic_tpu_torch.core.config import CaptionerConfig
    from mic_tpu_torch.core.params import tree_leaves
    from mic_tpu_torch.io import safetensors_np
    from mic_tpu_torch.io.hf_export import export_hf_fused
    from mic_tpu_torch.io.hf_import import load_pretrained_towers

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    from torch_hf_towers import to_torch_clip_state_dict, to_torch_mbart_state_dict
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.image_prep import preprocess_images

    t_phase = time.perf_counter()
    config = CaptionerConfig.clip_vit_b32_mbart50()
    params = init_params(config, torch.Generator(device=dev).manual_seed(57), dev)
    torch.cuda.synchronize()

    def same_leaves(got, skip=()):
        want, have = dict(tree_leaves(params)), dict(tree_leaves(got))
        require(want.keys() == have.keys(), "HF format: the key paths differ")
        return all(torch.equal(have[path], leaf) for path, leaf in want.items()
                   if path[0] not in skip)

    fused_dir = os.path.join(root, "fused")
    t0 = time.perf_counter()
    nbytes = export_hf_fused(params, config, fused_dir)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, loaded = Captioner.from_pretrained(fused_dir, device=dev)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    equal = same_leaves(loaded)
    print(f"HF fused checkpoint (flax_model.msgpack): {nbytes} B written in {write_s:.3f} s "
          f"(fsync'd), read by from_pretrained onto the card in {read_s:.3f} s (warm page "
          f"cache); every leaf bit-equal={equal}", flush=True)
    require(equal, "HF format: a leaf read back differs")
    served = Captioner(model.config.replace(dtype="bfloat16"))
    kw = dict(num_beams=4, max_length=64, forced_bos_token_id=FLAGSHIP_BOS)
    u8 = np.random.default_rng(57).integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
    px = preprocess_images(torch.from_numpy(u8).to(dev), 224, torch.bfloat16)
    a = served.generate(params, px, **kw)
    b = served.generate(loaded, px, **kw)
    require(torch.equal(a.sequences, b.sequences) and torch.equal(a.scores, b.scores),
            "HF format: the reloaded params generate otherwise")
    print(f"HF fused checkpoint: B=8 beam 4 from the reloaded params equal to the original's "
          f"({a.steps} steps)", flush=True)
    del loaded, model
    shutil.rmtree(fused_dir)

    clip_dir, mbart_dir = os.path.join(root, "clip"), os.path.join(root, "mbart")
    os.makedirs(clip_dir)
    os.makedirs(mbart_dir)
    clip_sd = to_torch_clip_state_dict(params["vision"], config.vision.patch_size)
    mbart_sd = to_torch_mbart_state_dict(params["shared"], params["decoder"],
                                         params["final_logits_bias"])
    t0 = time.perf_counter()
    clip_bytes = safetensors_np.save_file(clip_sd, os.path.join(clip_dir, "model.safetensors"))
    clip_s = time.perf_counter() - t0
    mbart_bytes, mbart_s = _timed_fsync(lambda p: torch.save(mbart_sd, p),
                                        os.path.join(mbart_dir, "pytorch_model.bin"))
    del clip_sd, mbart_sd
    t0 = time.perf_counter()
    towers = load_pretrained_towers(clip_dir, mbart_dir, device=dev)
    torch.cuda.synchronize()
    towers_s = time.perf_counter() - t0
    equal = same_leaves(towers, skip=("proj",))
    print(f"HF towers: CLIP model.safetensors {clip_bytes} B written in {clip_s:.3f} s, mBART "
          f"pytorch_model.bin {mbart_bytes} B in {mbart_s:.3f} s (fsync'd); "
          f"load_pretrained_towers onto the card in {towers_s:.3f} s; every leaf but proj "
          f"bit-equal={equal}", flush=True)
    require(equal, "HF towers: a leaf read back differs")
    require(towers["proj"]["kernel"].shape == params["proj"]["kernel"].shape,
            "HF towers: proj of another shape")
    shutil.rmtree(clip_dir)
    shutil.rmtree(mbart_dir)
    print(f"phase 57 took {time.perf_counter() - t_phase:.1f} s", flush=True)


def _raises(exc, fn, *args) -> bool:
    """Whether ``fn(*args)`` raises ``exc`` (a refusal this run checks for)."""
    try:
        fn(*args)
    except exc:
        return True
    return False


def run_async_save(dev, root):
    """Phase 58: the checkpoint manager's save without data_meta (mic_tpu's
    background write) on a flagship-width train checkpoint (the bf16
    flagship, depth cut to CUT_LAYERS vision and decoder layers, at the
    TrainConfig defaults: float32 params, bf16 moments):
    the time ``save`` takes to return (the host copy), a train step taken
    while the write runs (params changed in place), the time ``wait`` then
    blocks, and the restore bit-equal to the state as it was at the save;
    then the trainer's synchronous save (with data_meta) of the same tree
    timed.  Host clock, fsync'd writes."""
    from mic_tpu_torch.core.config import DataConfig, TrainConfig
    from mic_tpu_torch.io.checkpoint import TrainCheckpointManager
    from mic_tpu_torch.train.state import checkpoint_tree
    from mic_tpu_torch.train.trainer import Trainer

    config = _flagship_depth(CUT_LAYERS).replace(dtype="bfloat16")
    tc = TrainConfig(warmup_steps=2, output_dir=os.path.join(root, "unused"))
    trainer = Trainer(config, DataConfig(), tc, device=dev)
    trainer.build(steps_per_epoch=2)
    state = trainer.init_state()
    batch = trainer.put_batch(_train_batches(config, 1, 64, 64, 58)[0])
    state, _ = trainer.train_step(state, batch)   # moments no longer zero
    at_save = [leaf.clone() for leaf in _state_leaves(state)]
    manager = TrainCheckpointManager(os.path.join(root, "async"), max_to_keep=None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manager.save(1, checkpoint_tree(state))
    returned = time.perf_counter() - t0
    complete = os.path.isdir(os.path.join(manager.directory, "1"))
    t1 = time.perf_counter()
    state, metrics = trainer.train_step(state, batch)
    loss = metrics["loss"].item()
    step_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    manager.wait()
    waited = time.perf_counter() - t2
    nbytes = _bytes_under(os.path.join(manager.directory, "1"))
    tree, meta = manager.restore(1, device=dev)
    same = all(torch.equal(a, b) for a, b in zip(_checkpoint_leaves(tree), at_save))
    del tree, at_save
    sync = TrainCheckpointManager(os.path.join(root, "sync"), max_to_keep=None)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    sync.save(1, checkpoint_tree(state), data_meta={"epoch": 0, "next_batch": 1})
    sync_s = time.perf_counter() - t3
    print(f"async save, flagship-width train checkpoint of {nbytes} B: save returned in "
          f"{returned:.3f} s (directory complete then: {complete}), a train step during the "
          f"write {step_s:.3f} s (loss {loss:.4f}), wait blocked {waited:.3f} s more; the "
          f"synchronous save with data_meta {sync_s:.3f} s; restore bit-equal to the state at "
          f"the save: {same}", flush=True)
    require(not complete, "async save: the directory was complete when save returned")
    require(meta is None and same, "async save: the restore differs from the state at the save")
    require(returned < sync_s, "async save: save did not return before the write was done")
    require(bool(np.isfinite(loss)), "async save: a non-finite loss during the write")
    del trainer, state, batch


# the largest difference phase 59 allows between mode "0"'s and mode "2"'s
# best scores (mean log-probs a token), and between their captions rescored
# by the float32 model: bf16 paths part at near-ties (0.056 the largest
# best-score gap seen), where a broken chain drifts toward the untrained
# model's typical token at -ln(250054) = -12.4
NEAR_TIE = 0.1
# and between the 4th and 5th running candidates' total log-probs where the
# two runs' running beams first part: a swap at a near-tie
BEAM_TIE = 0.1


def _rescored(model32, params32, px32, seqs, eos_id: int, length_penalty: float):
    """The float32 model's teacher-forced beam scores of ``seqs`` (B, L),
    as beam search scores them: the log-probs of tokens 1 to the first EOS
    after them (a forced token counts its model log-prob) over (last + 1)
    ** length_penalty -> (B,)."""
    seqs = seqs.to(px32.device).long()
    length = seqs.shape[1]
    with torch.no_grad():
        logits = model32(params32, px32, seqs[:, :-1], torch.ones_like(seqs[:, :-1]))
        lp = torch.log_softmax(logits.float(), -1).gather(-1, seqs[:, 1:, None])[..., 0]
    del logits
    lp = torch.nn.functional.pad(lp, (1, 0))
    pos = torch.arange(length, device=seqs.device)
    eos = (seqs == eos_id) & (pos >= 2)
    last = torch.where(eos.any(1), eos.int().argmax(1), length - 1)
    total = (lp * (pos[None] <= last[:, None])).sum(1)
    return total / (last + 1).float() ** length_penalty


@contextlib.contextmanager
def _beam_trace(beams: int):
    """Record every beam step of the generates run inside: the running beams
    it keeps (B, K, L) and the best K + 1 scores (total log-probs) of its
    running candidates, sorted (B, K + 1)."""
    from mic_tpu_torch.generate import search

    top_k, gather = search.top_k, search._gather_beams
    trace = {"beams": [], "scores": []}

    def top_k_traced(x, k):
        if k == beams and x.shape[-1] == 2 * beams:  # the running candidates
            trace["scores"].append(x.sort(dim=-1, descending=True).values[:, :beams + 1])
        return top_k(x, k)

    def gather_traced(x, pick):
        out = gather(x, pick)
        if pick.shape[-1] == beams and x.shape[1] == 2 * beams:  # the running beams
            trace["beams"].append(out.clone())
        return out

    search.top_k, search._gather_beams = top_k_traced, gather_traced
    try:
        yield trace
    finally:
        search.top_k, search._gather_beams = top_k, gather


def _first_partings(ref, got, images: int, beams: int) -> list:
    """Where two traced beam searches first keep different running beams:
    for each image whose beams part, (image, step, the reference's K-th
    less its (K + 1)-th running candidate's score there, the same in
    ``got``, the largest difference between the two runs' kept scores a
    step before, when their beams were the same)."""
    out = []
    for i in range(images):
        for n, (a, b) in enumerate(zip(ref["beams"], got["beams"])):
            if {tuple(r) for r in a[i].tolist()} != {tuple(r) for r in b[i].tolist()}:
                ra, rb = ref["scores"][n][i], got["scores"][n][i]
                drift = 0.0 if n == 0 else float(
                    (ref["scores"][n - 1][i, :beams] - got["scores"][n - 1][i, :beams])
                    .abs().max())
                out.append((i, n, float(ra[beams - 1] - ra[beams]),
                            float(rb[beams - 1] - rb[beams]), drift))
                break
    return out


def run_lazy_chain_path(dev):
    """Phase 59: lazy-attention mode "0" (mic_tpu's XLA chain, plain tensor
    code on the card, nn/attention.py::lazy_attention_chain) at flagship
    width, depth cut to CUT_LAYERS, B=8 images, beam 4, max_length 64.  In
    bf16 with the bf16 KV
    cache and the int8 one (per-head scales under mode "0", per-row under
    mode "2"): rows 1, 2 and 3 never launched, row 4 once a step, a rerun
    identical; every chain call held against a kernel on the same inputs
    at the flagship shapes: the bf16 cache against row 1 (mode "2"'s
    kernel: outputs within 2e-2 of their largest magnitude, the written
    column bit-equal), the int8 cache against row 3's int8 form (mode "1",
    the same per-head layout; it attends to the step row unquantized, the
    chain to it quantized: 3e-2, tests/test_torch_fused_step.py's bounds);
    against mode "2"'s run (whole bf16 paths part at near-ties, as phase 55
    found): the best scores within NEAR_TIE, and both runs' captions
    rescored by the float32 model on the same weights (``_rescored``)
    within NEAR_TIE of each other; printed beside them, the shares of
    tokens and sequences equal, each run's scores against its rescoring,
    and where two captions first part the float32 log-prob of mode "2"'s
    token less mode "0"'s.  Then the float32 flagship under mode "0"
    against mode "2" (row 1 f32): sequences equal, scores within 1e-4
    (phase 52's bound) and within 1e-3 of their rescoring (which checks
    ``_rescored``).  Then a beam step's time (host clock around a
    synchronised generate, over its steps) under each mode in turns (2, 0,
    0, 2), both caches."""
    import mic_tpu_torch.nn.attention as attention_mod
    from mic_tpu_torch.core.params import tree_map
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops import lazy_attention as la

    config, params, model, kw, pixels = flagship(dev, CUT_LAYERS)
    layers = config.decoder.num_layers
    px = pixels(8, 0)
    model32 = Captioner(config.replace(dtype="float32"))
    params32 = tree_map(lambda x: x.float(), params)
    eos_id, penalty = config.decoder.eos_token_id, config.generation.length_penalty
    chain = attention_mod.lazy_attention_chain
    for kv in (None, "int8"):
        extra = dict(kw, kv_quant=kv)
        label = f"mode 0, {'int8' if kv else 'bf16'} KV"
        with knobs(MIC_TPU_FUSED_LAZY_ATTN="2"), _beam_trace(4) as ref_trace:
            ref, ref_counts = drive(model, params, px, **extra)
        with knobs(MIC_TPU_FUSED_LAZY_ATTN="0"), _beam_trace(4) as trace:
            out, counts = drive(model, params, px, **extra)
        seqs = check_path_output(out, 8, 64, label)
        partings = _first_partings(ref_trace, trace, 8, 4)
        del ref_trace, trace
        row = "lazy_attention_q8" if kv else "lazy_attention"
        require(ref_counts[row] == layers * ref.steps, f"{label}: mode 2 missed {row}")
        require(counts["lazy_attention"] == counts["lazy_attention_q8"] == 0
                and counts["fused_lazy_attention"] == 0, f"{label}: a lazy-attention kernel ran")
        require(counts["fused_head"] >= out.steps, f"{label}: row 4 not once a step")
        stats = {"calls": 0, "err": 0.0}

        def held(q, ck, cv, ks, vs, anc, index, heads, buckets=(), kv=kv):
            pre = [{k: v.clone() for k, v in c.items()} if kv else c.clone() for c in (ck, cv)]
            got = chain(q, ck, cv, ks, vs, anc, index, heads, buckets)
            beams = q.shape[1]
            if kv:
                want = la.fused_lazy_attention(q, pre[0], pre[1], ks, vs,
                                               la.build_ancestry_mask(anc, index), beams, heads,
                                               positions=index)
                bound_ = 3e-2
            else:
                want = la.lazy_attention(q, pre[0], pre[1], ks, vs, anc, index, heads)
                require(torch.equal(pre[0][:, index], ck[:, index])
                        and torch.equal(pre[1][:, index], cv[:, index]),
                        f"{label}: the chain's written column differs from row 1's")
                bound_ = 2e-2
            err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
            require(err <= bound_, f"{label}: a chain call {err:.3g} from the kernel's")
            stats["calls"] += 1
            stats["err"] = max(stats["err"], err)
            return got

        attention_mod.lazy_attention_chain = held
        try:
            with knobs(MIC_TPU_FUSED_LAZY_ATTN="0"):
                again = model.generate(params, px, **extra)
        finally:
            attention_mod.lazy_attention_chain = chain
        require(torch.equal(again.sequences.cpu(), seqs), f"{label}: a second run differs")
        require(stats["calls"] == layers * out.steps, f"{label}: {stats['calls']} chain calls")
        images, share = _token_share(seqs, ref.sequences)
        gap = (out.scores.cpu() - ref.scores.cpu()).abs()
        f0 = _rescored(model32, params32, px.float(), seqs, eos_id, penalty)
        f2 = _rescored(model32, params32, px.float(), ref.sequences, eos_id, penalty)
        f_gap = (f0 - f2).abs().cpu()
        print(f"{label}, 8 images: {out.steps} steps, launches row 4 {counts['fused_head']}, rows "
              f"1-3 0; the rerun identical, its {stats['calls']} chain calls each held against "
              f"{'row 3 int8 (per-head cache)' if kv else 'row 1'} on the same inputs: largest "
              f"error {stats['err']:.3g} of the output's magnitude; against mode 2's run ({row} "
              f"{ref_counts[row]}): {images} of 8 sequences equal, tokens equal {share:.4f}, "
              f"best-score differences {[round(float(g), 5) for g in gap]} (limit {NEAR_TIE}); "
              f"rescored by the float32 model: differences {[round(float(g), 5) for g in f_gap]} "
              f"(limit {NEAR_TIE}), mode 0's scores less their rescoring "
              f"{[round(float(g), 5) for g in out.scores - f0]}, mode 2's "
              f"{[round(float(g), 5) for g in ref.scores - f2]}; where the runs' running "
              f"beams first part (image, step, mode 2's 4th less 5th running candidate's "
              f"total log-prob, mode 0's, the runs' largest kept-score difference a step "
              f"before): {[(i, n, round(a, 5), round(b, 5), round(d, 5)) for i, n, a, b, d in partings]} "
              f"(limit {BEAM_TIE} on both margins)", flush=True)
        require(float(gap.max()) <= NEAR_TIE, f"{label}: a best score beyond a near-tie of mode 2's")
        require(float(f_gap.max()) <= NEAR_TIE,
                f"{label}: a caption's float32 rescoring beyond a near-tie of mode 2's")
        require(all(a <= BEAM_TIE and b <= BEAM_TIE for _, _, a, b, _ in partings),
                f"{label}: the runs' beams part where no near-tie is: {partings}")
    del params, params32, model32

    f32 = _flagship_depth(CUT_LAYERS)
    params32 = init_params(f32, torch.Generator(device=dev).manual_seed(59), dev)
    model32 = Captioner(f32)
    px32 = pixels(8, 0).float()
    with knobs(MIC_TPU_FUSED_LAZY_ATTN="2"):
        ref, ref_counts = drive(model32, params32, px32, **kw)
    with knobs(MIC_TPU_FUSED_LAZY_ATTN="0"):
        out, counts = drive(model32, params32, px32, **kw)
    seqs = check_path_output(out, 8, 64, "mode 0, float32")
    gap = (out.scores.cpu() - ref.scores.cpu()).abs().max().item()
    same = torch.equal(seqs, ref.sequences.cpu())
    rescored = _rescored(model32, params32, px32, seqs, eos_id, penalty)
    f_err = (out.scores - rescored).abs().max().item()
    print(f"mode 0, float32 flagship, 8 images: {out.steps} steps, lazy-attention launches "
          f"{counts['lazy_attention']} (mode 2: {ref_counts['lazy_attention']}); sequences equal "
          f"to mode 2's: {same}, largest score difference {gap:.3g} (limit 1e-4); scores less "
          f"their float32 rescoring at most {f_err:.3g} (limit 1e-3)", flush=True)
    require(counts["lazy_attention"] == 0 and ref_counts["lazy_attention"] == layers * ref.steps,
            "mode 0, float32: launches")
    require(same and gap <= 1e-4, "mode 0, float32: the path differs from mode 2's")
    require(f_err <= 1e-3, "mode 0, float32: the rescoring differs from the search's scores")
    del params32, model32

    config, params, model, kw, pixels = flagship(dev, CUT_LAYERS)
    for kv in (None, "int8"):
        extra = dict(kw, kv_quant=kv)
        for turn, mode in enumerate(("2", "0", "0", "2"), 1):
            with knobs(MIC_TPU_FUSED_LAZY_ATTN=mode):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = model.generate(params, px, **extra)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            print(f"smoke figure (not a benchmark), {'int8' if kv else 'bf16'} KV, mode {mode}, "
                  f"turn {turn}: B=8 beam 4, {out.steps} steps in {seconds:.3f} s = "
                  f"{seconds / out.steps * 1e3:.2f} ms a beam step", flush=True)
    del params, model


# the depth of the phases that cut it (49 and 58-60: the checkpoints, the
# lazy chain, two ranks): the flagship at full width with 2 vision and 2
# decoder layers (its embedding table, 250054 x 1024, is most of the state
# either way)
CUT_LAYERS = 2


def _rank_tools():
    """tools/torch_rank_worker.py: the ranks, their launcher and the
    comparison the CPU tests use too."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import torch_rank_worker

    return torch_rank_worker


def _flagship_depth(layers: int):
    from mic_tpu_torch.core.config import CaptionerConfig

    base = CaptionerConfig.clip_vit_b32_mbart50()
    return CaptionerConfig.from_dict({**base.to_dict(),
                                      "vision": {**base.vision.to_dict(), "num_layers": layers},
                                      "decoder": {**base.decoder.to_dict(),
                                                  "num_layers": layers}})


def run_ranks(dev, root, config, world: int, per_device: int, steps: int, spec: dict,
              checkpoint: bool, backend: str, timeout: float):
    """The float32 ``config`` trained ``steps`` steps (TrainConfig defaults:
    dropout 0.1, remat "masks", the dl route, bf16 moments; lr 1e-4 after
    one warmup step; captions of 8-64 tokens) by ``world`` ranks of
    tools/torch_rank_worker.py (``spec`` gives how they meet and their
    device) under dp and under dp with fsdp, each held against one process
    on the same global batches on ``dev``: losses within 1e-5 relative at
    the first step, 1e-4 after (phase 53's limits: sums in another order),
    every param within 2 * steps * lr, all but one in a hundred of each
    leaf's entries within 1e-5 (the key biases, whose gradient the softmax
    cancels, aside); rows 7 f32 and 8 f32 once a step in each rank; under
    fsdp each rank's params and moments about 1 / world of the whole's;
    with ``checkpoint`` the fsdp checkpoint the ranks wrote restored
    bit-equal under fsdp and, here in one process, bit-equal to the state
    rank 0 gathered."""
    from mic_tpu_torch.core.config import DataConfig, TrainConfig
    from mic_tpu_torch.core.params import tree_leaves
    from mic_tpu_torch.io.checkpoint import TrainCheckpointManager
    from mic_tpu_torch.parallel.sharding import tree_bytes
    from mic_tpu_torch.train.trainer import Trainer

    ranks_tool = _rank_tools()
    lr = 1e-4
    host = _train_batches(config, steps, world * per_device, 64, 60)
    batches = os.path.join(root, "batches.npz")
    np.savez(batches, **{f"{k}_{i}": v for i, b in enumerate(host) for k, v in b.items()
                         if k != "lang"})
    cases = []
    for layout in ("dp", "fsdp"):
        out = os.path.join(root, layout)
        os.makedirs(out)
        tc = TrainConfig(per_device_batch_size=per_device, learning_rate=lr, warmup_steps=1,
                         fsdp=layout == "fsdp", output_dir=os.path.join(out, "run"))
        cases.append({"model": config.to_dict(), "data": DataConfig().to_dict(),
                      "train": tc.to_dict(), "out": out, "batches": batches,
                      "steps_per_epoch": steps, "checkpoint": checkpoint and layout == "fsdp"})
    t0 = time.perf_counter()
    ranks_tool.spawn({**spec, "world": world, "cases": cases}, root, timeout, backend=backend)
    print(f"{world} ranks: both layouts in {time.perf_counter() - t0:.1f} s with process "
          f"start", flush=True)

    tc = TrainConfig(per_device_batch_size=world * per_device, learning_rate=lr,
                     warmup_steps=1, output_dir=os.path.join(root, "one"))
    trainer = Trainer(config, DataConfig(), tc, device=dev)
    trainer.build(steps_per_epoch=steps)
    state = trainer.init_state()
    losses, ms = [], []
    for b in host:
        t1 = time.perf_counter()
        state, metrics = trainer.train_step(state, trainer.put_batch(b))
        losses.append(metrics["loss"].item())
        ms.append((time.perf_counter() - t1) * 1e3)
    one = {path: leaf.detach() for path, leaf in tree_leaves(state.params)}
    whole_bytes = tree_bytes({"p": state.params, "m": state.opt_state.mu,
                              "v": state.opt_state.nu})
    print(f"{world} ranks: one process on the global batch of {world * per_device}: losses "
          f"{losses}, step times {[round(x, 1) for x in ms]} ms (smoke figures)", flush=True)
    del trainer, state
    for case, layout in zip(cases, ("dp", "fsdp")):
        out = case["out"]
        ranks = [json.load(open(os.path.join(out, f"rank{r}.json"))) for r in range(world)]
        final = torch.load(os.path.join(out, "final.pt"), weights_only=True)
        worst, far = ranks_tool.param_gaps(dict(tree_leaves(final["params"])), one, 1e-5)
        rel = ranks_tool.loss_gaps(ranks[0]["losses"], losses)
        shares = [r["state_bytes"] / whole_bytes for r in ranks]
        print(f"{world} ranks, {layout}: backend {ranks[0]['backend']}, devices "
              f"{sorted({r['device'] for r in ranks})}; losses {ranks[0]['losses']}, relative "
              f"to one process {[f'{x:.3g}' for x in rel]}; params: largest difference "
              f"{worst:.3g} (limit {2 * steps * lr:g}), largest share of a leaf beyond 1e-5 "
              f"{far:.4f} (limit 0.01); launches rank 0 {ranks[0]['launches']}, rank "
              f"{world - 1} {ranks[-1]['launches']}; state bytes a rank "
              f"{[r['state_bytes'] for r in ranks]} of {whole_bytes} "
              f"({[round(x, 3) for x in shares]}); peak allocated "
              f"{[r['peak_gib'] and round(r['peak_gib'], 2) for r in ranks]} GiB; step times "
              f"rank 0 "
              f"{[round(x, 1) for x in ranks[0]['ms']]} ms (smoke figures)", flush=True)
        for r in ranks:
            require(r["ranks"] == world and r["fsdp"] == (layout == "fsdp"), f"{layout}: layout")
            require(r["losses"] == ranks[0]["losses"], f"{layout}: the ranks' losses differ")
            require(r["launches"] == {"flash_ce_forward": steps, "flash_ce_backward_dl": steps},
                    f"{layout}: rows 7 f32 and 8 f32 not once a step in a rank: {r['launches']}")
        require(rel[0] <= 1e-5 and max(rel[1:]) <= 1e-4, f"{layout}: losses differ")
        require(worst <= 2 * steps * lr and far <= 0.01, f"{layout}: params differ")
        if layout == "fsdp":
            require(all(abs(x * world - 1) <= 0.1 for x in shares),
                    f"fsdp: state shares {shares}")
        if case["checkpoint"]:
            require(all(r["resumed_bit_equal"] for r in ranks),
                    "fsdp: a rank's restored parts differ")
            resumer = Trainer(config, DataConfig(),
                              TrainConfig.from_dict(case["train"]).replace(fsdp=False), device=dev)
            resumer.build(steps_per_epoch=steps)
            restored, meta = resumer.restore(TrainCheckpointManager(os.path.join(out, "run")))
            same = restored.step == steps and all(
                torch.equal(a.detach().cpu(), b)
                for key, tree in (("params", restored.params), ("mu", restored.opt_state.mu),
                                  ("nu", restored.opt_state.nu))
                for (_, a), (_, b) in zip(tree_leaves(tree), tree_leaves(final[key])))
            print(f"{world} ranks, fsdp: checkpoint of step {restored.step} resumed in one "
                  f"process, bit-equal to the gathered state: {same}; under fsdp each rank's "
                  f"parts bit-equal: True", flush=True)
            require(same and meta == {"epoch": 0, "next_batch": steps},
                    "fsdp checkpoint: the dp=1 resume differs from the gathered state")
            del resumer, restored
        del final
    del one
    torch.cuda.empty_cache()


def run_two_ranks(dev, root):
    """Phase 60: data-parallel and FSDP training in two processes on the
    one card (gloo: NCCL refuses two ranks on one device; the gather and
    scatter collectives go through host memory), on the default float32
    flagship at full width with depth cut to ``CUT_LAYERS`` vision and
    decoder layers, a per-device batch of 8 x 64 tokens, three steps,
    held as ``run_ranks`` holds them, the fsdp checkpoint resumed."""
    print(f"two ranks on one card: backend gloo, world size 2, float32 flagship width, "
          f"{CUT_LAYERS} vision and {CUT_LAYERS} decoder layers, per-device batch 8", flush=True)
    spec = {"init_method": f"file://{os.path.join(root, 'rendezvous')}", "backend": "gloo",
            "device": "cuda:0"}
    run_ranks(dev, root, _flagship_depth(CUT_LAYERS), 2, 8, 3, spec, True, "gloo", 900)


def run_caption_over_cards(devices: list, root, config=None):
    """The caption CLI's split over the cards ``devices`` (cli/caption.py:
    load_model's replicas, generate_over_devices' parts): ``config``
    (default the bf16 flagship at full width and depth) from a saved model
    directory, 8 x cards - 1 random images (one of padding), beam 4,
    max_length 64.  The split's sequences equal the same parts generated
    one after another on the first card (the same shapes, so the same
    kernels' sums), rows 1 and 4 launched, a whole batch on one card beside
    it (a share of tokens: other shapes part at near-ties), and ``main``
    run once over the cards, one caption line an image."""
    from PIL import Image

    from mic_tpu_torch.cli import caption
    from mic_tpu_torch.core.config import CaptionerConfig
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.image_prep import preprocess_images

    config = config or CaptionerConfig.clip_vit_b32_mbart50(dtype="bfloat16")
    cards = len(devices)
    model_dir = os.path.join(root, "model")
    Captioner(config).save_pretrained(
        model_dir, init_params(config, torch.Generator(device=devices[0]).manual_seed(0),
                               devices[0]))
    args = argparse.Namespace(model_dir=model_dir, tokenizer=None, device=None)
    model, replicas, tokenizer, loaded = caption.load_model(args)
    require(loaded == devices, f"caption split: devices {loaded}")
    n = 8 * cards - 1
    u8 = np.random.default_rng(61).integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)
    kw = dict(max_length=64, num_beams=4, decoder_start_token_id=tokenizer.lang_code_to_id["en_XX"])

    def prep(x):
        return preprocess_images(x, config.vision.image_size, model.dtype)

    def timed(reps, devs):
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        t0 = time.perf_counter()
        seqs = caption.generate_over_devices(model, reps, devs, u8, prep, **kw)
        return seqs, time.perf_counter() - t0

    caption.generate_over_devices(model, replicas, devices, u8[:cards], prep, **kw)  # warm-up
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    split, split_s = timed(replicas, devices)
    launches = {name: fn.launches for name, fn in counters.items() if fn.launches}
    serial, serial_s = timed([replicas[0]] * cards, [devices[0]] * cards)
    whole, whole_s = timed(replicas[:1], devices[:1])
    images, share = _token_share(torch.from_numpy(split), torch.from_numpy(whole))
    print(f"caption split over {cards} cards: {n} images (+1 of padding) in {split_s:.3f} s, "
          f"launches {launches}; the same parts one after another on {devices[0]} in "
          f"{serial_s:.3f} "
          f"s, sequences equal: {bool(np.array_equal(split, serial))}; the whole batch on one "
          f"card in {whole_s:.3f} s, {images} of {n} captions equal, tokens equal {share:.4f} "
          f"(smoke figures)", flush=True)
    require(np.array_equal(split, serial),
            "caption split: the cards' parts differ from the first card's")
    require(launches.get("lazy_attention", 0) > 0 and launches.get("fused_head", 0) > 0,
            f"caption split: rows 1 and 4 did not carry it: {launches}")
    paths = [os.path.join(root, f"img_{i}.png") for i in range(3)]
    for path, image in zip(paths, u8):
        Image.fromarray(image).save(path)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        caption.main(["--model_dir", model_dir, "--max_length", "16", *paths])
    lines = printed.getvalue().strip().splitlines()
    print(f"caption CLI over {cards} cards, 3 images: {len(lines)} lines", flush=True)
    require(len(lines) == 3 and all(line.startswith(p + "\t") for line, p in zip(lines, paths)),
            "caption CLI: not one line an image")
    del model, replicas


def run_cards(cards: int) -> None:
    """``chip_smoke.py --cards N``: the paths that need several cards, on N
    cards: the caption CLI's split (``run_caption_over_cards``), then
    data-parallel and FSDP training in N processes, one card a rank, NCCL,
    started through mic_tpu's environment contract, on the default float32
    flagship at full width and depth (12 + 12 layers), a per-device batch
    of 16 x 64 tokens, four steps, held as ``run_ranks`` holds them."""
    from mic_tpu_torch import _build

    require(torch.cuda.device_count() >= cards, f"--cards {cards}: "
            f"{torch.cuda.device_count()} cards visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    print(card_name_and_limit(), flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as root:
        run_caption_over_cards([torch.device("cuda", i) for i in range(cards)], root)
    torch.cuda.empty_cache()
    print(f"{cards} ranks: backend nccl, world size {cards}, one card a rank, float32 flagship "
          f"at full width and depth, per-device batch 16", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as root:
        run_ranks(torch.device("cuda", 0), root, _flagship_depth(12), cards, 16, 4,
                  {"contract": True, "device": None}, False, "nccl", 1200)
    print(json.dumps({"ok": True, "cards": cards}), flush=True)


FAMILY_V = 50265  # BART-large's vocab: the family's head, at D=1024
FAMILY_N = 4096   # rows of the family's train step, 64 x 64


def check_family_kernels(dev):
    """Phase 61's kernel checks: rows 7 and 8 at the family's step, N=4096
    rows over BART-large's V=50265 (its last 256-wide tile holds 89
    columns, a 128-wide f32 tile 89), D=1024.  bf16 against the plain
    versions with phases 7 and 8's tolerances; float32 (the 3xTF32 walks)
    with phase 51's: lse within 1e-5 relative, the label logit within
    1e-5, the sum of logits within 1e-5 of the row's L1, dl within 1e-4 of
    |dl| plus its terms, dbias within 1e-5 of its largest entry.  Row 4 at
    the family's eval (B=8 x beam 4: N=32, k=9, V=50265), bf16 and float32
    (the 3xTF32 tile), with phases 3's and 51's tolerances.  Then each
    timed (graph replays) beside its plain version and its bound ->
    {name: (max_abs_err, kernel ms, plain ms, (bound ms, by))}."""
    from mic_tpu_torch.ops.flash_ce import (
        _targets, flash_ce_dl, flash_ce_dl_plain, flash_ce_forward, flash_ce_forward_plain,
    )

    weight, bias = _ce_table(dev)
    weight, bias = weight[:FAMILY_V].contiguous(), bias[:FAMILY_V].contiguous()
    fwd_err = check_flash_ce_forward(dev, weight, bias, cases=((FAMILY_N, FAMILY_V),))
    dl_err = check_flash_ce_dl(dev, weight, bias, cases=((FAMILY_N, FAMILY_V),))
    out = {}
    n, v = FAMILY_N, FAMILY_V
    for kind, w, b in (("", weight, bias), ("_f32", *_f32_table(dev, v, CE_D, 61))):
        hidden, labels = _ce_rows(dev, n, 610, v)
        if kind:
            hidden = hidden.float()
            got = flash_ce_forward(hidden, w, b, labels)
            ref = flash_ce_forward_plain(hidden, w, b, labels)
            l1 = torch.cat([(hidden[i:i + 512] @ w.T + b).abs().sum(-1)
                            for i in range(0, n, 512)])
            torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=0)
            torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-5)
            require(((got[2] - ref[2]).abs() / l1).max().item() < 1e-5,
                    f"flash_ce_forward f32 N={n} V={v}: sum of logits")
            fwd = (got[0] - ref[0]).abs().max().item()
            rs = torch.rand((n,), generator=torch.Generator(device=dev).manual_seed(61),
                            device=dev) / n
            dl, dbias = flash_ce_dl(hidden, w, b, labels, ref[0], rs, 0.1)
            rdl, rdbias = flash_ce_dl_plain(hidden, w, b, labels, ref[0], rs, 0.1)
            low, conf_low = _targets(0.1, v)
            target = torch.full_like(rdl, low)
            target.scatter_(1, labels[:, None].long(), low + conf_low)
            d_ = (dl - rdl).abs()
            require(bool((d_ <= 1e-4 * (rdl.abs() + 2 * target * rs[:, None])).all()),
                    f"flash_ce_dl f32 N={n} V={v}: dl beyond 1e-4")
            require((dbias - rdbias).abs().max().item() < 1e-5 * rdbias.abs().max().item(),
                    f"flash_ce_dl f32 N={n} V={v}: dbias")
            dl_err_f32 = d_.max().item()
            print(f"flash_ce_forward f32 N={n} D={CE_D} V={v}: lse max_abs_err={fwd:.3g}; "
                  f"flash_ce_dl f32: dl max_abs_err={dl_err_f32:.3g}", flush=True)
            del dl, rdl, target, d_
            errs = {"fwd": fwd, "dl": dl_err_f32}
        else:
            errs = {"fwd": fwd_err, "dl": dl_err}
        lse = flash_ce_forward_plain(hidden, w, b, labels)[0]
        rs = torch.full((n,), 1.0 / n, device=dev)
        bounds = (f32_bounds(1, 1, n, CE_D, v) if kind else flash_ce_bounds(n, CE_D, v))
        for row, name, kernel, plain in (
                ("fwd", "flash_ce_forward", lambda: flash_ce_forward(hidden, w, b, labels),
                 lambda: flash_ce_forward_plain(hidden, w, b, labels)),
                ("dl", "flash_ce_backward_dl",
                 lambda: flash_ce_dl(hidden, w, b, labels, lse, rs, 0.1),
                 lambda: flash_ce_dl_plain(hidden, w, b, labels, lse, rs, 0.1))):
            k_ms = graph_ms(kernel, reps=3, runs=5)
            p_ms = graph_ms(plain, reps=1, runs=3)
            key = name + kind
            b_ms, by = bounds[key]
            out[key] = (errs[row], k_ms, p_ms, (b_ms, by))
            print(f"{key} at the family's step N={n} D={CE_D} V={v} (graph replays): kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms; bound {b_ms:.4f} ms ({by}), the kernel "
                  f"at {b_ms / k_ms:.1%} of it", flush=True)
        del hidden, labels, lse, w, b
        torch.cuda.empty_cache()
    from mic_tpu_torch.ops.fused_head import _logits, fused_head_topk, fused_head_topk_plain

    n, k = 32, 9
    for kind in ("", "_f32"):
        if kind:
            w, b = _f32_table(dev, v, CE_D, 62)
            hidden = _hidden(dev, n, CE_D, 620).float()
            b_ms, by = f32_bounds(1, n, 1, CE_D, v)["fused_head_bucket_f32"]
        else:
            w, b = _bf16_head_cases(dev, [(n, CE_D, v, k)], 62)[CE_D, v]
            hidden = _hidden(dev, n, CE_D, 620)
            b_ms, by = head_bound(n, CE_D, v, k, 2, "bf16")
        got = fused_head_topk(hidden, w, b, k)
        ref = fused_head_topk_plain(hidden, w, b, k, "bucket")
        torch.cuda.synchronize()
        what = f"fused_head_bucket{kind} N={n} D={CE_D} V={v} k={k}"
        logits = _logits(hidden, w, b)
        err, ties = (_f32_head_case(got, ref, logits, what) if kind
                     else _bf16_head_case(got, ref, logits, what, True))
        k_ms = graph_ms(lambda: fused_head_topk(hidden, w, b, k))
        p_ms = graph_ms(lambda: fused_head_topk_plain(hidden, w, b, k, "bucket"), reps=2, runs=5)
        out[f"fused_head_bucket{kind}"] = (err, k_ms, p_ms, (b_ms, by))
        print(f"{what}: lp max_abs_err={err:.3g}, near-tie id differences={ties}; (graph "
              f"replays) kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; bound {b_ms:.4f} ms ({by}), "
              f"the kernel at {b_ms / k_ms:.1%} of it", flush=True)
        del w, b, hidden, logits
    return out


def run_family_training(dev, root):
    """Phase 61: the ViT-B/16 + BART-large preset trains
    (CaptionerConfig.vit_b16_bart_large: the ViT tower of 12 x 768, patch
    16, 197 rows; the post-norm 12-layer BART-large decoder; the tied head
    of V = 50265) at full width and depth, in bf16 and in float32 (its
    default dtype): the port's Trainer at the TrainConfig defaults (batch
    64 x 64 tokens, dropout 0.1, remat "masks", fused CE on the dl route,
    bf16 moments; the bf16 shadow in bf16) with warmup_steps=2, three steps
    from seed 0, the training counters set to 0 just before them and read
    just after: rows 7 and 8 (their float32 forms in float32) once a step,
    no other training kernel.  The same three steps on rows 7 and 8's plain
    versions (the plain "dl" route on the card): the first loss within 1e-5
    relative, the next two within 1e-4 (phase 53's limits).  In bf16 the
    state saved after step 2 (synchronously) and restored by a new Trainer
    takes step 3 bit-equal to the uninterrupted run (its loss and every
    param, moment and shadow leaf).  Eval: ``Trainer.generate_step`` (beam
    4, max_length 64) of B=8 images, the serving counters set to 0 just
    before it: row 1 twelve times a decode step and row 4 (bf16 or f32) at
    least once a step at V = 50265 -> launches by instance name."""
    import mic_tpu_torch.ops.fused_ce as fused_ce_mod
    from mic_tpu_torch.core.config import CaptionerConfig, DataConfig, TrainConfig
    from mic_tpu_torch.core.params import tree_leaves
    from mic_tpu_torch.ops.flash_ce import flash_ce_backward_dl_plain, flash_ce_forward_plain
    from mic_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    launches = {}
    for dtype in ("bfloat16", "float32"):
        config = CaptionerConfig.vit_b16_bart_large(dtype=dtype)
        require(config.decoder.vocab_size == FAMILY_V and config.decoder.post_norm
                and not config.vision.use_pre_ln, "vit_b16_bart_large: unexpected preset")
        tc = TrainConfig(warmup_steps=2, output_dir=os.path.join(root, dtype))
        host = _train_batches(config, 3, tc.per_device_batch_size, DataConfig().max_seq_length,
                              61)
        runs = {}
        for label in ("kernels", "plain"):
            swaps = (() if label == "kernels" else (
                (fused_ce_mod, "flash_ce_forward", flash_ce_forward_plain),
                (fused_ce_mod, "flash_ce_backward_dl", flash_ce_backward_dl_plain)))
            t0 = time.perf_counter()
            trainer = Trainer(config, DataConfig(), tc, device=dev)
            trainer.build(steps_per_epoch=len(host))
            state = trainer.init_state()
            batches = [trainer.put_batch(b) for b in host]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _train_counts(reset=True)
            losses, ms = [], []
            with plain_versions(*swaps):
                for step, batch in enumerate(batches):
                    if label == "kernels" and dtype == "bfloat16" and step == 2:
                        t_save = time.perf_counter()
                        trainer.save(2, state, {"epoch": 0, "next_batch": 2})
                        save_s = time.perf_counter() - t_save
                    t1 = time.perf_counter()
                    state, metrics = trainer.train_step(state, batch)
                    losses.append(metrics["loss"].item())
                    ms.append((time.perf_counter() - t1) * 1e3)
            got = {k: v for k, v in _train_counts().items() if v}
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"ViT-B/16 + BART-large training ({dtype}), {label}: losses {losses}, launches "
                  f"{got}, peak allocated {peak:.2f} GiB, step times "
                  f"{[round(x, 1) for x in ms]} ms (smoke figures, not a benchmark), "
                  f"{time.perf_counter() - t0:.1f} s with init", flush=True)
            require(all(np.isfinite(losses)), f"family training {dtype} ({label}): a non-finite "
                    "loss")
            runs[label] = (losses, got)
            if label == "kernels" and dtype == "bfloat16":
                again = Trainer(config, DataConfig(), tc, device=dev)
                again.build(steps_per_epoch=len(host))
                t_restore = time.perf_counter()
                resumed, meta = again.restore(again.ckpt, 2)
                restore_s = time.perf_counter() - t_restore
                require(meta == {"epoch": 0, "next_batch": 2} and resumed.step == 2,
                        f"family resume: meta {meta}, step {resumed.step}")
                resumed, m = again.train_step(resumed, batches[2])
                same = m["loss"].item() == losses[2] and all(
                    torch.equal(a.detach(), b.detach()) for tree_a, tree_b in (
                        (resumed.params, state.params), (resumed.opt_state.mu, state.opt_state.mu),
                        (resumed.opt_state.nu, state.opt_state.nu), (resumed.shadow, state.shadow))
                    for (_, a), (_, b) in zip(tree_leaves(tree_a), tree_leaves(tree_b)))
                print(f"family (bf16): the checkpoint of step 2 saved in {save_s:.3f} s, restored "
                      f"in {restore_s:.3f} s by a new Trainer; its step 3 bit-equal to the "
                      f"uninterrupted run's (loss, params, moments, shadow)={same}", flush=True)
                require(same, "family: the resumed step 3 differs from the uninterrupted one")
                del again, resumed
            if label == "kernels":
                px = batches[0]["pixel_values"][:8]
                with torch.no_grad():
                    seqs, counts, seconds = generate_counted(
                        lambda x: trainer.generate_step(state.params, x, 0), px)
                rows = {"lazy_attention": counts.pop("lazy_attention"),
                        "fused_head": counts.pop("fused_head")}
                steps = rows["lazy_attention"] // config.decoder.num_layers
                print(f"family eval ({dtype}): Trainer.generate_step B=8 beam 4 max_length 64, "
                      f"{steps} decode steps in {seconds:.3f} s, launches {rows}", flush=True)
                require(seqs.shape[0] == 8 and bool((seqs[:, 1] == 0).all()),
                        f"family eval ({dtype}): malformed sequences")
                require(steps > 0 and rows["lazy_attention"] == config.decoder.num_layers * steps
                        and rows["fused_head"] >= steps,
                        f"family eval ({dtype}): launches {rows}")
                require(not any(counts.values()), f"family eval: other kernels launched {counts}")
                suffix = "" if dtype == "bfloat16" else "_f32"
                launches[f"fused_head_bucket{suffix} V={FAMILY_V}"] = rows["fused_head"]
            del trainer, state, batches
            torch.cuda.empty_cache()
        (losses, got), (plain, plain_got) = runs["kernels"], runs["plain"]
        require(got == {"flash_ce_forward": 3, "flash_ce_backward_dl": 3},
                f"family training {dtype}: launches {got}")
        require(not plain_got, f"family training {dtype}: the plain route launched {plain_got}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
        print(f"family training ({dtype}): kernels' losses against the plain dl route's, relative "
              f"differences {[f'{r:.3g}' for r in rel]} (limits 1e-5, 1e-4, 1e-4)", flush=True)
        require(rel[0] <= 1e-5 and max(rel[1:]) <= 1e-4,
                f"family training {dtype}: the losses differ from the plain dl route's")
        suffix = "" if dtype == "bfloat16" else "_f32"
        launches[f"flash_ce_forward{suffix} V={FAMILY_V}"] = got["flash_ce_forward"]
        launches[f"flash_ce_backward_dl{suffix} V={FAMILY_V}"] = got["flash_ce_backward_dl"]
    print(f"phase 61 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def _head_grads(trainer, state, batch):
    """The gradients of the trainer's loss (no dropout) on one device batch
    with respect to ``lm_head``'s kernel and the shared embedding, float32
    on the card."""
    from mic_tpu_torch.ops.image_prep import maybe_preprocess

    pixels = maybe_preprocess(batch["pixel_values"], trainer.mc.vision.image_size, trainer.dtype)
    leaves = [state.params["lm_head"]["kernel"], state.params["shared"]["embedding"]]
    with torch.enable_grad():
        loss = trainer.compute_loss(state.params, pixels, batch, shadow=state.shadow)
        grads = torch.autograd.grad(loss, leaves)
    return [g.detach().float() for g in grads]


def run_untied_training(dev):
    """Phase 62: the untied flagship trains: CaptionerConfig.clip_vit_b32_
    mbart50(dtype="bfloat16", tie_word_embeddings=False), full width and
    depth (no cut: CLIP ViT-B/32, the 12-layer mBART-50 decoder, a (1024,
    250054) ``lm_head`` beside the shared table), the TrainConfig defaults
    with warmup_steps=2, three steps from seed 0, once with fused_ce on
    (the dl route: rows 7 and 8 read the (V, D) bf16 copy of ``lm_head``'s
    shadow and write its gradient, once a step each, the counters set to 0
    just before the steps and read just after) and once with fused_ce off
    (the dense logits of ``lm_head``, no CE kernel): the losses within
    phase 53's limits (1e-5 relative, then 1e-4); before the steps, the
    first batch's gradient (no dropout) of ``lm_head``'s kernel within 1%
    of its norm and every entry within 2% of its largest (the dense route
    rounds its logits and their gradient to bf16), and the shared
    embedding's (its lookup's alone) likewise.  The (V, D) copy of the
    shadow (train/shadow.py::ce_table) timed beside its bound -> launches,
    the copy's (ms, bound)."""
    from mic_tpu_torch.core.config import CaptionerConfig, DataConfig, TrainConfig
    from mic_tpu_torch.train.shadow import ce_table
    from mic_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    config = CaptionerConfig.clip_vit_b32_mbart50(dtype="bfloat16", tie_word_embeddings=False)
    host = _train_batches(config, 3, 64, 64, 62)
    runs = {}
    for label, fused in (("fused", True), ("dense", False)):
        t0 = time.perf_counter()
        trainer = Trainer(config, DataConfig(), TrainConfig(warmup_steps=2, fused_ce=fused),
                          device=dev)
        trainer.build(steps_per_epoch=len(host))
        state = trainer.init_state()
        require("lm_head" in state.params and state.shadow["lm_head"]["kernel"].dtype
                == torch.bfloat16, "untied: no bf16 shadow of lm_head")
        batches = [trainer.put_batch(b) for b in host]
        grads = _head_grads(trainer, state, batches[0])
        if fused:
            _, cast = ce_table(state.params, state.shadow, torch.bfloat16)
            require(cast.shape == (config.decoder.vocab_size, config.decoder.d_model)
                    and cast.is_contiguous()
                    and torch.equal(cast, state.shadow["lm_head"]["kernel"].t()),
                    "ce_table: the copy is not lm_head's shadow transposed")
            del cast
            copy_ms = median_ms(lambda: ce_table(state.params, state.shadow, torch.bfloat16),
                                runs=25)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _train_counts(reset=True)
        losses, ms = [], []
        for batch in batches:
            t1 = time.perf_counter()
            state, metrics = trainer.train_step(state, batch)
            losses.append(metrics["loss"].item())
            ms.append((time.perf_counter() - t1) * 1e3)
        got = {k: v for k, v in _train_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"untied flagship training (bf16), fused_ce={fused}: losses {losses}, launches "
              f"{got}, peak allocated {peak:.2f} GiB, step times {[round(x, 1) for x in ms]} ms "
              f"(smoke figures), {time.perf_counter() - t0:.1f} s with init", flush=True)
        require(all(np.isfinite(losses)), f"untied training ({label}): a non-finite loss")
        runs[label] = (losses, got, grads)
        del trainer, state, batches
        torch.cuda.empty_cache()
    (losses, got, grads), (dense, dense_got, dense_grads) = runs["fused"], runs["dense"]
    require(got == {"flash_ce_forward": 3, "flash_ce_backward_dl": 3},
            f"untied training: launches {got}")
    require(not dense_got, f"untied training: the dense route launched {dense_got}")
    for name, a, b in (("lm_head", grads[0], dense_grads[0]),
                       ("shared embedding", grads[1], dense_grads[1])):
        norm = ((a - b).norm() / b.norm()).item()
        top = ((a - b).abs().max() / b.abs().max()).item()
        print(f"untied, first-batch gradient of {name}: fused (rows 7 and 8) against the dense "
              f"logits, |difference| / |dense| {norm:.3g} (limit 1e-2), largest entry "
              f"difference / largest entry {top:.3g} (limit 2e-2)", flush=True)
        require(b.abs().max().item() > 0 and norm <= 1e-2 and top <= 2e-2,
                f"untied: the fused route's {name} gradient differs from the dense route's")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, dense)]
    print(f"untied training: fused losses against the dense route's, relative differences "
          f"{[f'{r:.3g}' for r in rel]} (limits 1e-5, 1e-4, 1e-4)", flush=True)
    require(rel[0] <= 1e-5 and max(rel[1:]) <= 1e-4,
            "untied training: the fused losses differ from the dense route's")
    v, d = config.decoder.vocab_size, config.decoder.d_model
    copy_bound = bound(2 * v * d * 2, 0, "bf16")
    print(f"untied: lm_head's (V, D) bf16 copy (ce_table, once a step) {copy_ms:.4f} ms per call, "
          f"bound {copy_bound[0]:.4f} ms ({copy_bound[1]}), {copy_bound[0] / copy_ms:.1%} of it",
          flush=True)
    print(f"phase 62 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ({"flash_ce_forward lm_head": got["flash_ce_forward"],
             "flash_ce_backward_dl lm_head": got["flash_ce_backward_dl"]},
            (copy_ms, copy_bound))


TRANSLATE_LANGS = ("en_XX", "fr_XX", "es_XX", "de_DE")
TRANSLATE_WORDS = ("a", "cat", "dog", "red", "blue", "house", "tree", "runs", "sleeps", "on",
                   "the", "grass", "under", "small", "big", "car", "street", "man", "woman")
# mBART-50's language codes as its published vocab numbers them
MBART50_CODES = {"en_XX": 250004, "fr_XX": 250008, "es_XX": 250005, "de_DE": 250003}


class _WordEncoder:
    """HFTokenizer's ``tk``: [source code] words... [</s>], cut and padded
    (id 1) to ``max_length``, the words numbered from ``first_word``."""

    def __init__(self, codes, first_word):
        self.codes, self.first_word, self.src_lang = codes, first_word, "en_XX"

    def __call__(self, texts, max_length, truncation, padding, return_tensors):
        ids = np.full((len(texts), max_length), 1, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for row, text in enumerate(texts):
            words = [self.first_word + TRANSLATE_WORDS.index(w) for w in text.split()]
            words = ([self.codes[self.src_lang]] + words)[:max_length - 1] + [2]
            ids[row, :len(words)] = words
            mask[row, :len(words)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class _StandInTokenizer:
    """HFTokenizer's surface for tools/torch_translate.py (the card's
    machine has no transformers): ``tk``, ``lang_code_to_id`` and
    ``batch_decode`` (every id past the specials as "w<id>")."""

    def __init__(self, codes, first_word):
        self.lang_code_to_id = codes
        self.tk = _WordEncoder(codes, first_word)

    def batch_decode(self, seqs):
        return [" ".join(f"w{int(t)}" for t in row if int(t) > 3) for row in np.asarray(seqs)]


def _translate_report(path, n, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            words = " ".join(rng.choice(TRANSLATE_WORDS, rng.integers(3, 12)))
            f.write(f"{i}\timg_{i}.jpg\t{words}\thttp://x/{i}\t200\n")


def _write_translator(directory, params):
    """pytorch_model.bin of ``params`` (tools/torch_hf_towers.py's state
    dict; the shared table stored once)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import torch_hf_towers

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "pytorch_model.bin")
    t0 = time.perf_counter()
    torch.save(torch_hf_towers.to_torch_mbart_seq2seq_state_dict(params), path)
    return os.path.getsize(path), time.perf_counter() - t0


def run_translate_tool(dev, root):
    """Phase 63: tools/torch_translate.py runs on the card.  The mBART-50
    translator at its published width (DecoderConfig(): 12 + 12 layers,
    d_model 1024, V = 250054), random weights from seed 63 written as
    pytorch_model.bin and read back by the tool's ``load_model`` in bf16; a
    synthetic report of 256 rows (status 200) split 25 / 231 from seed 42,
    chunk 64, through ``translate_split`` with a stand-in tokenizer: every
    row out, the four languages in train (en, fr, es and a ragged de chunk
    of 39), and in each translated chunk row 19 launched twice a decode
    step and no other serving kernel (the counters read around each
    generate).  Then a small config (d_model 128, 2 layers, V = 1100;
    weights at scale 0.3) in float32: the tool's rows on the card equal
    its rows on the CPU (a 40-row report, chunk 8)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import torch_translate
    from mic_tpu_torch.core.config import DecoderConfig
    from mic_tpu_torch.core.params import tree_leaves
    from mic_tpu_torch.models.mbart_seq2seq import MBartSeq2Seq
    from mic_tpu_torch.ops.beam_permute import beam_permute

    t_phase = time.perf_counter()
    weights = os.path.join(root, "mbart50")
    params = MBartSeq2Seq(DecoderConfig()).init_params(
        torch.Generator(device=dev).manual_seed(63), dev)
    nbytes, write_s = _write_translator(weights, params)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, params = torch_translate.load_model(weights, "bfloat16", dev)
    load_s = time.perf_counter() - t0
    print(f"translate tool: {nbytes} B of weights written in {write_s:.3f} s, loaded onto the "
          f"card by load_model in {load_s:.3f} s", flush=True)
    report = os.path.join(root, "report.tsv")
    _translate_report(report, 256, 63)
    splits = torch_translate.split_rows(torch_translate.read_report(report), 42, 0.1)
    require([len(splits["val"]), len(splits["train"])] == [25, 231], "translate: the split")
    counters = _counters()
    per_chunk = []
    generate = model.generate

    def counted(*args, **kw):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = generate(*args, **kw)
        torch.cuda.synchronize()
        per_chunk.append((out.steps, {k: fn.launches for k, fn in counters.items()
                                      if fn.launches}, time.perf_counter() - t1))
        return out

    model.generate = counted
    tok = _StandInTokenizer(MBART50_CODES, 1000)
    t0 = time.perf_counter()
    rows = {split: list(torch_translate.translate_split(model, params, tok, data, 64, dev,
                                                        log=lambda _: None))
            for split, data in splits.items()}
    seconds = time.perf_counter() - t0
    for path, split in ((os.path.join(root, f"{s}_file.tsv"), s) for s in rows):
        torch_translate.write_tsv(path, rows[split])
    langs = [row[3] for row in rows["train"]]
    print(f"translate tool (bf16, 256 rows, chunk 64): {len(per_chunk)} translated chunks in "
          f"{seconds:.3f} s (with the English chunks; smoke figure), per chunk (steps, "
          f"launches, s) {[(s, c, round(t, 3)) for s, c, t in per_chunk]}", flush=True)
    require([len(rows["val"]), len(rows["train"])] == [25, 231], "translate: rows lost")
    require(langs == [TRANSLATE_LANGS[(i // 64) % 4] for i in range(231)]
            and set(langs) == set(TRANSLATE_LANGS), "translate: the language round-robin")
    require(len(per_chunk) == 3 and all(c == {"beam_permute": 2 * s} for s, c, _ in per_chunk),
            "translate: row 19 not twice a step in every translated chunk, or another kernel")
    translated = [row for row in rows["train"] if row[3] != "en_XX"]
    require(all(row[1].split()[0] == f"w{tok.lang_code_to_id[row[3]]}" for row in translated),
            "translate: a translation without its forced language code")
    launches = sum(c["beam_permute"] for _, c, _ in per_chunk)
    del model, params
    torch.cuda.empty_cache()

    small_cfg = DecoderConfig.tiny(vocab_size=1100, d_model=128, num_heads=2, ffn_dim=256,
                                   max_position_embeddings=72)
    g = torch.Generator().manual_seed(64)
    small = MBartSeq2Seq(small_cfg).init_params(g)
    for path, leaf in tree_leaves(small):  # scale 0.3: at 0.02 a random model repeats one token
        leaf.copy_(torch.randn(leaf.shape, generator=g) * 0.3 + (path[-1] == "scale"))
    _write_translator(os.path.join(root, "small"), small)
    report = os.path.join(root, "small.tsv")
    _translate_report(report, 40, 64)
    data = torch_translate.split_rows(torch_translate.read_report(report), 42, 0.1)
    out = {}
    for where in (dev, torch.device("cpu")):
        m, p = torch_translate.load_model(os.path.join(root, "small"), "float32", where,
                                          small_cfg)
        tok = _StandInTokenizer({"en_XX": 4, "fr_XX": 5, "es_XX": 6, "de_DE": 7}, 8)
        beam_permute.launches = 0
        out[where.type] = [list(torch_translate.translate_split(m, p, tok, rows, 8, where,
                                                                log=lambda _: None))
                           for rows in data.values()]
        if where.type == "cuda":
            require(beam_permute.launches > 0, "translate, small: row 19 never ran on the card")
    same = out["cuda"] == out["cpu"]
    print(f"translate tool, small config in float32: the card's rows equal the CPU's={same} "
          f"({sum(map(len, out['cpu']))} rows, "
          f"{len({row[1] for part in out['cpu'] for row in part})} distinct captions)", flush=True)
    require(same, "translate: the card's TSV rows differ from the CPU's")
    print(f"phase 63 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# The float32 instances of rows 2, 3 (both caches), 13, 14 (and its int8
# form) and 15: phase 64 holds each against its plain version at the
# flagship shapes and times it; phase 65 serves the default float32
# flagship through them.  Names as in the kernels line.
F32_STEP_ROWS = {
    "lazy_attention_q8_f32": ("lazy_attention.cu", "mic_tpu/ops/lazy_attention.py:560"),
    "fused_lazy_attention_f32": ("lazy_attention.cu", "mic_tpu/ops/lazy_attention.py:257"),
    "fused_lazy_attention_q8_f32": ("lazy_attention.cu", "mic_tpu/ops/lazy_attention.py:257"),
    "fused_cross_attention_f32": ("cross_attention.cu", "mic_tpu/ops/cross_attention.py:237"),
    "fused_cross_attention_dma_f32": ("cross_attention.cu",
                                      "mic_tpu/ops/cross_attention.py:183"),
    "fused_cross_attention_q8_f32": ("cross_attention.cu", "mic_tpu/ops/cross_attention.py:79"),
    "ln_gemm_f32": ("ln_gemm_f32.cu", "mic_tpu/ops/ln_gemm.py:49"),
}


def _f32_lazy_inputs(dev, g, q8, index):
    """Row 2's or row 3's float32 inputs at the flagship decode shape: q
    and the step rows float32; the int8 cache with per-row scales (row 2),
    the per-head int8 cache or the float32 cache (row 3), each zero from
    ``index`` on; an ancestry whose unwritten positions name each beam's
    own row."""
    from mic_tpu_torch.ops.quant import quantize_rows_dynamic

    b, beams, t, heads = FLAG_B, FLAG_K, FLAG_T, FLAG_H
    hd = heads * FLAG_DH

    def rand(*shape, scale=0.5):
        return torch.randn(shape, generator=g, device=dev) * scale

    def cache():
        prefix = rand(b * beams, t, hd)
        prefix[:, index:] = 0
        if q8 == "row":
            values, scales = quantize_rows_dynamic(prefix)
            return {"q": values, "s": scales[..., 0].contiguous()}
        if q8 == "head":
            values, scales = quantize_rows_dynamic(prefix.reshape(b * beams, t, heads, FLAG_DH))
            return {"q": values.reshape(b * beams, t, hd), "s": scales[..., 0].contiguous()}
        return prefix

    q, ks, vs = rand(b, beams, hd, scale=0.3), rand(b, beams, hd), rand(b, beams, hd)
    ck, cv = cache(), cache()
    anc = torch.randint(0, beams, (b, beams, t), generator=g, device=dev, dtype=torch.int32)
    anc[:, :, index:] = torch.arange(beams, device=dev, dtype=torch.int32)[None, :, None]
    return q, ck, cv, ks, vs, anc


def _clone_cache(c):
    return {n: a.clone() for n, a in c.items()} if isinstance(c, dict) else c.clone()


def _same_cache(a, b):
    return (all(torch.equal(a[n], b[n]) for n in a) if isinstance(a, dict)
            else torch.equal(a, b))


def check_f32_step_kernels(dev):
    """Phase 64: a float32 model's instances of rows 2, 3 (float32 cache and
    per-head int8 cache), 14 (and its int8 form under float32 q), 13 and 15
    against their plain versions on the card at the flagship shapes, TF32
    off: row 2 at B=256 K=4 T=64 H=16, index 17 and 63, outputs within 1e-5
    (f32 throughout, sums in another order), the written int8 column and
    its scales bit-equal, a rerun bit-equal; row 3 at index 17 and 63 on the
    ancestry mask, within 2e-2 (bf16 weights and output after f32 sums in
    another order), the caches untouched, a rerun bit-equal; rows 14 and
    13 at B=256 K=4 S=50 (the merged cache padded to 64, NaN in its pad
    rows) and row 14's int8 form, within 2e-2, reruns bit-equal; row 15 at
    N=1024 and 32, D=1024, O=3072, within (D 2**-24 + 2**-20) of sum |xn|
    |w| + |bias|, a rerun bit-equal.  Then each in CUDA-graph replays beside
    its plain version's replays, its bound and, where one PyTorch call
    computes the same function, that call (SDPA in float32 on the live rows
    for rows 13 and 14); F.layer_norm + F.linear in float32 for scale ->
    (errors, times, the rows row 3's timed masks admit)."""
    import torch.nn.functional as F

    import mic_tpu_torch.ops.cross_attention as ca
    import mic_tpu_torch.ops.lazy_attention as la
    from mic_tpu_torch.ops.ln_gemm import ln_gemm, ln_gemm_plain

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for matmuls")
    g = torch.Generator(device=dev).manual_seed(64)
    b, beams, heads, hd, s = FLAG_B, FLAG_K, FLAG_H, HEAD_D, FLAG_S
    errs, times = {}, {}

    worst = 0.0
    for index in (17, 63):
        q, ck, cv, ks, vs, anc = _f32_lazy_inputs(dev, g, "row", index)
        pk, pv, ak, av = (_clone_cache(c) for c in (ck, cv, ck, cv))
        out = la.lazy_attention_q8(q, ck, cv, ks, vs, anc, index, heads)
        again = la.lazy_attention_q8(q, ak, av, ks, vs, anc, index, heads)
        ref = la.lazy_attention_q8_plain(q, pk, pv, ks, vs, anc, index, heads)
        torch.cuda.synchronize()
        require(out.dtype == torch.float32, "lazy_attention_q8 f32: output dtype")
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        require(torch.equal(out, again), "lazy_attention_q8 f32: a rerun differs")
        require(all(_same_cache(x, y) for x, y in ((ck, pk), (cv, pv), (ck, ak), (cv, av))),
                "lazy_attention_q8 f32: the written column or scales differ from plain")
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        print(f"lazy_attention_q8 f32 B={b} K={beams} T={FLAG_T} H={heads} index={index}: "
              f"max_abs_err={err:.3g}, column and scales bit-equal, rerun bit-equal", flush=True)
    errs["lazy_attention_q8_f32"] = worst
    args = (q, ck, cv, ks, vs, anc, 63, heads)
    times["lazy_attention_q8_f32"] = (graph_ms(lambda: la.lazy_attention_q8(*args)),
                                      graph_ms(lambda: la.lazy_attention_q8_plain(*args)), None)

    live_rows = {}
    for q8, name in ((None, "fused_lazy_attention_f32"), ("head", "fused_lazy_attention_q8_f32")):
        worst = 0.0
        for index in (17, 63):
            q, ck, cv, ks, vs, anc = _f32_lazy_inputs(dev, g, q8, index)
            amask = la.build_ancestry_mask(anc, index)
            before = [_clone_cache(c) for c in (ck, cv)]
            fargs = (q, ck, cv, ks, vs, amask, beams, heads)
            out = la.fused_lazy_attention(*fargs, positions=index)
            again = la.fused_lazy_attention(*fargs, positions=index)
            ref = la.fused_lazy_attention_plain(*fargs)
            torch.cuda.synchronize()
            require(out.dtype == torch.float32, f"{name}: output dtype")
            torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
            require(torch.equal(out, again), f"{name}: a rerun differs")
            require(all(_same_cache(c, o) for c, o in zip((ck, cv), before)),
                    f"{name}: a cache it reads changed")
            err = (out - ref).abs().max().item()
            worst = max(worst, err)
            print(f"{name} B={b} K={beams} T={FLAG_T} H={heads} index={index}: "
                  f"max_abs_err={err:.3g}, rerun bit-equal, caches untouched", flush=True)
        errs[name] = worst
        live_rows[name] = int((amask != 0).any(-1).sum())
        times[name] = (graph_ms(lambda: la.fused_lazy_attention(*fargs, positions=63)),
                       graph_ms(lambda: la.fused_lazy_attention_plain(*fargs)), None)

    q = torch.randn((b, beams, hd), generator=g, device=dev) * 0.3
    ek, ev = (torch.randn((b, s, heads, FLAG_DH), generator=g, device=dev) * 0.5
              for _ in range(2))
    mk, mv = (torch.full((b, 64, hd), float("nan"), device=dev) for _ in range(2))
    mk[:, :s], mv[:, :s] = ek.reshape(b, s, hd), ev.reshape(b, s, hd)
    zk, zv = (torch.where(torch.isnan(m), 0.0, m) for m in (mk, mv))
    from mic_tpu_torch.ops.quant import quantize_rows_dynamic
    qk, qv = ({"q": v, "s": sc[..., 0].contiguous()}
              for v, sc in (quantize_rows_dynamic(c) for c in (ek, ev)))
    qh = q.reshape(b, beams, heads, FLAG_DH).transpose(1, 2)
    kh, vh = (c.transpose(1, 2) for c in (ek, ev))
    runs = {
        "fused_cross_attention_f32": (lambda: ca.fused_cross_attention(q, ek, ev, beams, heads),
                                      lambda: ca.fused_cross_attention_plain(q, ek, ev, beams,
                                                                             heads)),
        "fused_cross_attention_dma_f32": (
            lambda: ca.fused_cross_attention_dma(q, mk, mv, s, beams, heads),
            lambda: ca.fused_cross_attention_dma_plain(q, zk, zv, s, beams, heads)),
        "fused_cross_attention_q8_f32": (
            lambda: ca.fused_cross_attention_q8(q, qk, qv, beams, heads),
            lambda: ca.fused_cross_attention_plain(q, qk, qv, beams, heads)),
    }
    lib = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0).transpose(1, 2)
    torch.testing.assert_close(lib.reshape(q.shape), runs["fused_cross_attention_f32"][1](),
                               rtol=2e-2, atol=2e-2)
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0))
    for name, (kernel, plain) in runs.items():
        out, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        require(out.dtype == torch.float32, f"{name}: output dtype")
        torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
        require(torch.equal(out, again), f"{name}: a rerun differs")
        errs[name] = (out - ref).abs().max().item()
        print(f"{name} B={b} K={beams} S={s} H={heads}: max_abs_err={errs[name]:.3g}, rerun "
              f"bit-equal", flush=True)
        # SDPA computes rows 13's and 14's float32 function on the live rows;
        # none computes the int8 form's
        times[name] = (graph_ms(kernel), graph_ms(plain),
                       None if name == "fused_cross_attention_q8_f32" else lib_ms)

    scale = 1 + 0.1 * torch.randn((hd,), generator=g, device=dev)
    shift = 0.1 * torch.randn((hd,), generator=g, device=dev)
    w = 0.05 * torch.randn((hd, 3 * hd), generator=g, device=dev)
    bias = 0.1 * torch.randn((3 * hd,), generator=g, device=dev)
    worst = 0.0
    for n in (1024, 32):
        x = torch.randn((n, hd), generator=g, device=dev) * 2 + 0.5
        out, again = ln_gemm(x, scale, shift, w, bias), ln_gemm(x, scale, shift, w, bias)
        ref = ln_gemm_plain(x, scale, shift, w, bias)
        torch.cuda.synchronize()
        l1 = F.layer_norm(x, (hd,), scale, shift).abs() @ w.abs() + bias.abs()
        require(out.dtype == torch.float32, "ln_gemm f32: output dtype")
        require(bool(((out - ref).abs() <= (hd * 2.0**-24 + 2.0**-20) * l1).all()),
                f"ln_gemm f32 N={n}: beyond the f32 summation bound")
        require(torch.equal(out, again), f"ln_gemm f32 N={n}: a rerun differs")
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        wt = w.t()
        times["ln_gemm_f32", n] = (
            graph_ms(lambda: ln_gemm(x, scale, shift, w, bias)),
            graph_ms(lambda: ln_gemm_plain(x, scale, shift, w, bias)), None,
            graph_ms(lambda: F.linear(F.layer_norm(x, (hd,), scale, shift, 1e-5), wt, bias)))
        print(f"ln_gemm f32 N={n} D={hd} O={3 * hd}: max_abs_err={err:.3g}, rerun bit-equal",
              flush=True)
    errs["ln_gemm_f32"] = worst
    times["ln_gemm_f32"] = times["ln_gemm_f32", 1024][:3]

    bounds = f32_step_bounds(live_rows)
    for name in F32_STEP_ROWS:
        k_ms, p_ms, l_ms = times[name]
        b_ms, by = bounds[name]
        lib_text = "" if l_ms is None else f", scaled_dot_product_attention f32 {l_ms:.4f} ms"
        print(f"{name} time (graph replays): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms"
              f"{lib_text}; bound {b_ms:.4f} ms ({by}), the kernel at {b_ms / k_ms:.1%} of it",
              flush=True)
    k_ms, p_ms, _, chain = times["ln_gemm_f32", 32]
    b_ms, by = ln_gemm_bound(32, hd, 3 * hd, 4, "tf32x3")
    print(f"ln_gemm_f32 at N=32 (graph replays): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
          f"bound {b_ms:.4f} ms ({by}), the kernel at {b_ms / k_ms:.1%} of it; for scale only "
          f"F.layer_norm + F.linear f32 {chain:.4f} ms (N=1024: "
          f"{times['ln_gemm_f32', 1024][3]:.4f} ms); at the f32 FMA rate the N=1024 bound is "
          f"{ln_gemm_bound(1024, hd, 3 * hd, 4, 'f32')[0]:.4f} ms", flush=True)
    print(f"phase 64 timed masks admit {live_rows} of {b * beams * 63} cached rows", flush=True)
    return errs, times, live_rows


def f32_step_bounds(live_rows):
    """Phase 64's rows at the flagship shapes: row 2 f32 as row 2 with f32
    q, step rows and output; row 3 f32 as row 3 over the rows this run's
    masks admit, f32 (or int8 with per-head scales) cache rows and f32 q,
    step rows and output; rows 13 and 14 f32 as row 14 in f32 (row 13 on
    its live rows); the int8 form under f32 q; row 15 f32 reading and
    writing f32 at the float32-accurate rate of the tensor cores ("tf32x3",
    as the float32 heads)."""
    rows = FLAG_B * FLAG_K
    return {
        "lazy_attention_q8_f32": attention_bound(rows, 63, HEAD_D, 1, scale_bytes=4,
                                                 ancestry=True, io_bytes=4),
        "fused_lazy_attention_f32": blocked_attention_bound(
            live_rows["fused_lazy_attention_f32"], FLAG_B, FLAG_K, 63, HEAD_D, FLAG_H, 4,
            io_bytes=4),
        "fused_lazy_attention_q8_f32": blocked_attention_bound(
            live_rows["fused_lazy_attention_q8_f32"], FLAG_B, FLAG_K, 63, HEAD_D, FLAG_H, 1,
            scale_bytes=4, io_bytes=4),
        "fused_cross_attention_f32": cross_bound(FLAG_B, FLAG_K, FLAG_S, HEAD_D, 4),
        "fused_cross_attention_dma_f32": cross_bound(FLAG_B, FLAG_K, FLAG_S, HEAD_D, 4),
        "fused_cross_attention_q8_f32": q8_cross_bound(FLAG_B, FLAG_K, FLAG_S, HEAD_D, FLAG_H,
                                                       io_bytes=4),
        "ln_gemm_f32": ln_gemm_bound(1024, HEAD_D, 3 * HEAD_D, 4, "tf32x3"),
    }


# phase 65's paths of the float32 flagship: (switches, kv_quant, the
# counters that must read 12 a step, the kernels line's name of each)
F32_PATHS = {
    "int8 KV, mode 2": ({}, "int8", {"lazy_attention_q8": "lazy_attention_q8_f32"}),
    "fused step, float32 cache": (
        {"MIC_TPU_FUSED_LAZY_ATTN": "1", "MIC_TPU_EXPERIMENTAL": "fused_cross_attn,ln_qkv"},
        None, {"fused_lazy_attention": "fused_lazy_attention_f32",
               "fused_cross_attention": "fused_cross_attention_f32", "ln_gemm": "ln_gemm_f32"}),
    "fused step, int8 cache": (
        {"MIC_TPU_FUSED_LAZY_ATTN": "1", "MIC_TPU_EXPERIMENTAL": "fused_cross_attn,ln_qkv"},
        "int8", {"fused_lazy_attention": "fused_lazy_attention_q8_f32",
                 "fused_cross_attention": "fused_cross_attention_f32", "ln_gemm": "ln_gemm_f32"}),
    "merged_cross": ({"MIC_TPU_EXPERIMENTAL": "merged_cross"}, None,
                     {"fused_cross_attention_dma": "fused_cross_attention_dma_f32",
                      "lazy_attention": "lazy_attention_f32"}),
}
# best scores of images whose sequences equal the plain versions': every
# path's kernels sum in f32 in another order than the plain versions (row 2
# f32 throughout: 9.44e-5 at B=64, above phase 52's 1e-4 at B=2), and the
# paths through rows 3, 13-15 also round weights and outputs to bf16
F32_PATH_SCORE = 1e-3


def _f32_step_swaps(la, ca, lg, attention_mod):
    """(module, name, plain, written, check) of each wrapper the paths look
    up, for ``plain_versions`` and ``shadowed``."""
    import mic_tpu_torch.models.mbart_decoder as decoder_mod
    from mic_tpu_torch.ops.fused_mlp import fused_mlp_plain
    def close(tol):
        def check(args, out, ref):
            torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
            return (out - ref).abs().max().item(), 0
        return check

    def q8_column(args):
        cache_k, cache_v, index = args[1], args[2], args[6]
        return torch.cat([c[n][:, index].reshape(-1).float() for c in (cache_k, cache_v)
                          for n in ("q", "s")])

    def ln_check(args, out, ref):
        x, scale, shift, w, bias = args[:5]
        l1 = (torch.nn.functional.layer_norm(x, (x.shape[1],), scale, shift).abs() @ w.abs()
              + bias.abs())
        require(bool(((out - ref).abs() <= (x.shape[1] * 2.0**-24 + 2.0**-20) * l1).all()),
                "ln_gemm f32 on the path: beyond the f32 summation bound")
        return (out - ref).abs().max().item(), 0

    def mlp_check(args, out, ref):
        limit = mlp_f32_limit(*args[:6])
        require(bool(((out - ref).abs() <= limit).all()),
                "fused_mlp f32 on the path: beyond its tolerance")
        return (out - ref).abs().max().item(), 0

    return {
        "lazy_attention_q8": (attention_mod, "lazy_attention_q8", la.lazy_attention_q8_plain,
                              q8_column, close(1e-5)),
        "lazy_attention": (attention_mod, "lazy_attention", la.lazy_attention_plain,
                           _lazy_column, close(1e-5)),
        "fused_lazy_attention": (attention_mod, "fused_lazy_attention",
                                 la.fused_lazy_attention_plain, None, close(2e-2)),
        "fused_cross_attention": (attention_mod, "fused_cross_attention",
                                  ca.fused_cross_attention_plain, None, close(2e-2)),
        "fused_cross_attention_dma": (attention_mod, "fused_cross_attention_dma",
                                      ca.fused_cross_attention_dma_plain, None, close(2e-2)),
        "ln_gemm": (lg, "ln_gemm", lg.ln_gemm_plain, None, ln_check),
        "fused_mlp": (decoder_mod, "fused_mlp", fused_mlp_plain, None, mlp_check),
    }


def run_f32_fused_paths(dev, paths=F32_PATHS):
    """Phase 65 (and 67, with ``paths`` F32_WHOLE_STEP: the whole fused
    step, row 16 f32 held within ``mlp_f32_limit``): the default float32
    flagship (CaptionerConfig.clip_vit_b32_mbart50() at its own dtype, full
    width and depth, random weights from a seed) serving B=64 images, beam
    4, length 64, every caption's EOS pinned at 63 (all 63 steps), under
    each path of ``paths``; in phase 65 kv_quant="int8" in mode "2" (row 2
    f32); the fused step's switches without fused_mlp with the float32
    cache (rows 3, 14 and 15 f32) and the per-head int8 cache (row 3's int8
    form under f32 q, 14 and 15 f32); merged_cross (row 13 f32, with row 1
    f32).  For each: the counters set to 0 just before a generate and read
    just after, each of the path's kernels 12 times a step, no other
    serving kernel but the head (so row 14's int8 form 0 times) and rows 11
    and 12 read too; a second run with every launch of those kernels held
    against its plain version on the same inputs (row 2 and row 1 within
    1e-5 and their written cells bit-equal, rows 3, 13, 14 within 2e-2, row
    15 within the f32 summation bound) and its sequences and scores
    identical to the first; and the same generate with the kernels swapped
    for their plain versions on the card: sequences equal but for images
    whose running beams first part at a near-tie (both runs' 4th less 5th
    candidate within BEAM_TIE, ``_first_partings``), the best scores of
    equal images within ``F32_PATH_SCORE`` (those of parted images are
    printed: after a parting at an early step the two searches score
    different captions of a random model, and the partings are what is
    held).  Then a beam step's time (host clock around a synchronised
    generate, over its steps) in turns with the bf16 flagship under the
    same switches (f32, bf16, bf16, f32) -> launches of each kernels-line
    name (rows 11 and 12 f32 and row 14's int8 form summed over the
    paths)."""
    import mic_tpu_torch.nn.attention as attention_mod
    import mic_tpu_torch.ops.cross_attention as ca
    import mic_tpu_torch.ops.lazy_attention as la
    import mic_tpu_torch.ops.ln_gemm as lg
    from mic_tpu_torch.core.config import CaptionerConfig
    from mic_tpu_torch.core.params import make_serving_params
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.image_prep import preprocess_images

    config = CaptionerConfig.clip_vit_b32_mbart50()
    require(config.dtype == "float32", f"the flagship's default dtype is {config.dtype}")
    params = make_serving_params(
        init_params(config, torch.Generator(device=dev).manual_seed(65), dev), torch.float32)
    model = Captioner(config)
    layers = config.decoder.num_layers
    n = 64
    kw = dict(num_beams=4, max_length=64, forced_bos_token_id=FLAGSHIP_BOS)
    u8 = np.random.default_rng(65).integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)
    px = preprocess_images(torch.from_numpy(u8).to(dev), config.vision.image_size, torch.float32)
    eos = torch.full((n,), 63, device=dev)
    swaps = _f32_step_swaps(la, ca, lg, attention_mod)
    launches = {}
    for label, (env, kv, rows) in paths.items():
        extra = dict(kw, kv_quant=kv, eos_positions=eos)
        with knobs(**env):
            model.generate(params, px[:8], **dict(extra, eos_positions=eos[:8]))  # warm-up
            with _beam_trace(4) as trace:
                _train_counts(reset=True)
                out, counts, seconds = generate_counted(
                    lambda x: model.generate(params, x, **extra), px)
                attention = _f32_attention_counts()
            seqs = check_path_output(out, n, 64, f"float32 flagship, {label}")
            check_pinned(seqs, eos.cpu(), config.decoder.eos_token_id,
                         config.decoder.pad_token_id, f"float32 flagship, {label}")
            found = {rows[c]: counts.pop(c) for c in rows}
            require(all(v == layers * out.steps for v in found.values()),
                    f"float32 {label}: a kernel not launched 12 times a step: {found}")
            require(counts["fused_head"] >= out.steps, f"float32 {label}: row 4 under once a step")
            others = {k: v for k, v in counts.items() if v and k != "fused_head"}
            require(not others, f"float32 {label}: other serving kernels launched: {others}")
            for name, count in found.items():
                launches.setdefault(name, count)
            unused = {**attention, "fused_cross_attention_q8_f32": counts[
                "fused_cross_attention_q8"]}
            for name, count in unused.items():
                launches[name] = launches.get(name, 0) + count
            with shadowed(*(swaps[c] for c in rows)) as stats:
                again = model.generate(params, px, **extra)
            _print_shadow(f"float32 flagship, {label}", stats)
            _require_rerun_identical(f"float32 flagship, {label}", out, again)
            # the plain versions take the wrappers' positional arguments
            # (row 3's ``positions`` bounds only the kernel's walk)
            plain = [(m, nm, lambda *a, _p=p, **_: _p(*a))
                     for m, nm, p, _, _ in (swaps[c] for c in rows)]
            with plain_versions(*plain), _beam_trace(4) as plain_trace:
                ref = model.generate(params, px, **extra)
        torch.cuda.synchronize()
        equal = (seqs == ref.sequences.cpu()).all(1)
        gap = (out.scores - ref.scores).abs().cpu()
        partings = _first_partings(plain_trace, trace, n, 4)
        del trace, plain_trace
        equal_gap = float(gap[equal].max()) if bool(equal.any()) else 0.0
        print(f"float32 flagship, {label}: B={n} beam 4, {out.steps} steps in {seconds:.3f} s "
              f"(smoke figure, not a benchmark), launches {found}, of rows 11 and 12 f32 and row "
              f"14's int8 form {unused}; against the same generate on the plain versions: "
              f"{int(equal.sum())} of {n} sequences equal, best-score differences of equal "
              f"images at most {equal_gap:.3g} (limit {F32_PATH_SCORE}), of all "
              f"{float(gap.max()):.3g} (not held: parted images); "
              f"where running beams first part (image, step, plain's 4th less 5th, the "
              f"kernels', kept-score difference a step before): "
              f"{[(i, st, round(a, 5), round(b, 5), round(d, 5)) for i, st, a, b, d in partings]}"
              f" (limit {BEAM_TIE})", flush=True)
        require(equal_gap <= F32_PATH_SCORE,
                f"float32 {label}: scores of equal sequences differ from the plain versions'")
        require(all(a <= BEAM_TIE and b <= BEAM_TIE for _, _, a, b, _ in partings),
                f"float32 {label}: beams part from the plain versions' where no near-tie is")

    del params
    torch.cuda.empty_cache()
    bf16_config = CaptionerConfig.clip_vit_b32_mbart50(dtype="bfloat16")
    params16 = make_serving_params(
        init_params(bf16_config, torch.Generator(device=dev).manual_seed(65), dev))
    params32 = make_serving_params(
        init_params(config, torch.Generator(device=dev).manual_seed(65), dev), torch.float32)
    model16 = Captioner(bf16_config)
    px16 = px.to(torch.bfloat16)
    for label, (env, kv, _) in paths.items():
        extra = dict(kw, kv_quant=kv, eos_positions=eos)
        with knobs(**env):
            for turn, dtype in enumerate(("float32", "bfloat16", "bfloat16", "float32"), 1):
                m, p, x = ((model, params32, px) if dtype == "float32"
                           else (model16, params16, px16))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = m.generate(p, x, **extra)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                print(f"smoke figure (not a benchmark), {label}, {dtype} flagship, turn {turn}: "
                      f"B={n} beam 4, {out.steps} steps in {seconds:.3f} s = "
                      f"{seconds / out.steps * 1e3:.2f} ms a beam step", flush=True)
    del params16, params32
    torch.cuda.empty_cache()
    return launches


# The float32 instances of rows 9, 10 and 16 (phases 66-68) and of rows 11
# and 12 (the attention phase, 35): names as in the kernels line.
F32_LAST_ROWS = {
    "fused_mlp_f32": ("fused_mlp_f32.cu", "mic_tpu/ops/fused_mlp.py:89"),
    "flash_ce_forward_save_f32": ("flash_ce_f32.cu", "mic_tpu/ops/flash_ce.py:157"),
    "flash_ce_backward_save_f32": ("flash_ce_bwd_f32.cu", "mic_tpu/ops/flash_ce.py:579"),
    "flash_ce_backward_f32": ("flash_ce_bwd_f32.cu", "mic_tpu/ops/flash_ce.py:407"),
}
F32_ATTENTION_ROWS = {
    "flash_attention_f32": ("flash_attention.cu", "mic_tpu/ops/flash_attention.py:167",
                            "flash_f32"),
    "small_attention_forward_f32": ("small_attention.cu", "mic_tpu/ops/small_attention.py:96",
                                    "small_fwd_f32"),
    "small_attention_backward_f32": ("small_attention.cu",
                                     "mic_tpu/ops/small_attention.py:111", "small_bwd_f32"),
}


def attention_bounds_f32(b, tq, tk, heads, dh=64):
    """Rows 11 f32 and 12 f32 at (B, Tq, Tk, H): float32 q, k, v (and dout)
    read and the output (dq, dk, dv) written once, the f32 (B, Tq, Tk) bias
    read once; every product of float32 operands at the f32 FMA rate, each
    2 B H Tq Tk Dh: two for a forward, five for the small-T backward."""
    x = b * tq * heads * dh * 4
    bias = b * tq * tk * 4
    mm = 2 * b * heads * tq * tk * dh
    return {"flash_attention_f32": bound(4 * x + bias, 2 * mm, "f32"),
            "small_attention_forward_f32": bound(4 * x + bias, 2 * mm, "f32"),
            "small_attention_backward_f32": bound(7 * x + bias, 5 * mm, "f32")}


def check_f32_attention_kernels(dev):
    """Phase 35's float32 half: rows 12 (forward and backward) and 11
    (forward) on float32 q, k, v at the decoder's (causal, right padding)
    and vision's shapes against their plain versions, TF32 off: outputs
    within 1e-5, the small-T gradients within 1e-5 of their largest entry
    (the card tests' float32 limits: f32 sums in another order), reruns
    bit-equal.  Then each in CUDA-graph replays beside its plain version
    and scaled_dot_product_attention in float32 with the same boolean mask
    (its backward timed last, as bf16's, by ``time_sdpa_backward``)
    -> (errors, times keyed as phase 36's)."""
    import torch.nn.functional as F

    from mic_tpu_torch.ops import flash_attention as fa
    from mic_tpu_torch.ops import small_attention as sa

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for matmuls")
    errs = dict.fromkeys(F32_ATTENTION_ROWS, 0.0)
    times = {}
    for shape, kind in (("decoder", "causal"), ("vision", None)):
        b, t, heads = ATTN_SHAPES[shape]
        mask = _attention_case(dev, b, t, heads, kind, 450)[3]
        g = torch.Generator(device=dev).manual_seed(451)
        q, k, v, do = (torch.randn((b, t, heads, 64), generator=g, device=dev) * s
                       for s in (0.3, 0.3, 1.0, 1.0))
        bias, fbias = sa.mask_bias(mask, b, t), fa.mask_bias(mask, b, t, t)
        out, again = sa.small_attention_forward(q, k, v, bias), sa.small_attention_forward(q, k, v,
                                                                                          bias)
        grads = sa.small_attention_backward(q, k, v, bias, do)
        grads2 = sa.small_attention_backward(q, k, v, bias, do)
        fout, fagain = fa.flash_attention_forward(q, k, v, fbias), fa.flash_attention_forward(
            q, k, v, fbias)
        ref = sa.small_t_attention_plain(q, k, v, bias)
        ref_grads = sa.small_t_attention_bwd_plain(q, k, v, bias, do)
        fref = fa.flash_attention_plain(q, k, v, fbias)
        torch.cuda.synchronize()
        require(torch.equal(out, again) and torch.equal(fout, fagain)
                and all(torch.equal(a, c) for a, c in zip(grads, grads2)),
                f"float32 attention {shape}: a rerun differs")
        require(all(x.dtype == torch.float32 for x in (out, fout, *grads)),
                f"float32 attention {shape}: output dtype")
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(fout, fref, rtol=1e-5, atol=1e-5)
        gerr = max(_scaled_err(a, c) for a, c in zip(grads, ref_grads))
        require(gerr <= 1e-5, f"small_attention_backward f32 {shape}: {gerr}")
        errs["small_attention_forward_f32"] = max(errs["small_attention_forward_f32"],
                                                  (out - ref).abs().max().item())
        errs["small_attention_backward_f32"] = max(
            errs["small_attention_backward_f32"],
            max((a - c).abs().max().item() for a, c in zip(grads, ref_grads)))
        errs["flash_attention_f32"] = max(errs["flash_attention_f32"],
                                          (fout - fref).abs().max().item())
        print(f"float32 attention {shape} B={b} T={t} H={heads} mask {kind}: small-T forward "
              f"max_abs_err={(out - ref).abs().max().item():.3g}, backward max err / max |ref| "
              f"{gerr:.3g}; flash max_abs_err={(fout - fref).abs().max().item():.3g} (limits "
              f"1e-5); reruns bit-equal", flush=True)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        qh, kh, vh = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=1.0)
        torch.testing.assert_close(lib_out.detach().transpose(1, 2), ref, rtol=1e-4, atol=1e-4)
        times[("small_fwd_f32", shape)] = (
            graph_ms(lambda: sa.small_attention_forward(q, k, v, bias)),
            graph_ms(lambda: sa.small_t_attention_plain(q, k, v, bias)),
            graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                            scale=1.0)),
            median_ms(lambda: sa.small_attention_forward(q, k, v, bias)))
        times[("small_bwd_f32", shape)] = (
            graph_ms(lambda: sa.small_attention_backward(q, k, v, bias, do)),
            graph_ms(lambda: sa.small_t_attention_bwd_plain(q, k, v, bias, do)),
            lambda a=(lib_out, (qh, kh, vh), do.transpose(1, 2)): torch.autograd.grad(
                *a, retain_graph=True),
            median_ms(lambda: sa.small_attention_backward(q, k, v, bias, do)))
        times[("flash_f32", shape)] = (
            graph_ms(lambda: fa.flash_attention_forward(q, k, v, fbias)),
            graph_ms(lambda: fa.flash_attention_plain(q, k, v, fbias)),
            times[("small_fwd_f32", shape)][2],
            median_ms(lambda: fa.flash_attention_forward(q, k, v, fbias)))
    for (name, shape), (kernel, plain, lib, per_call) in times.items():
        b, t, heads = ATTN_SHAPES[shape]
        lib_text = ("its backward timed last" if callable(lib)
                    else f"its forward {lib:.4f} ms in graph replays")
        print(f"{name} {shape} B={b} T={t} H={heads}: kernel {kernel:.4f} ms (graph replays), "
              f"{per_call:.4f} ms per call with its wrapper; plain {plain:.4f} ms; "
              f"scaled_dot_product_attention in float32: {lib_text}", flush=True)
    return errs, times


# Row 16 f32's tolerance, a share of each output's sum |act(x w1 + b1)|
# |w2| + |b2|: fitted between what sound f32 sums of the two products in
# two orders differ by and what the nearest faulty kernels differ by
# (phase 66 prints both, PERF.md §6), not a worst-case bound, which grows
# with the depth and lets those faults through
MLP_F32_TOL = 2.0**-18


def mlp_f32_limit(x, w1, b1, w2, b2, activation="gelu"):
    """MLP_F32_TOL of sum |act(x w1 + b1)| |w2| + |b2|, entry by entry
    (tests/test_torch_cuda_kernels.py::_mlp_f32_limit)."""
    from mic_tpu_torch.nn.layers import ACTIVATIONS
    from mic_tpu_torch.ops.fused_mlp import gelu_erf

    act = gelu_erf if activation == "gelu" else ACTIVATIONS[activation]
    return MLP_F32_TOL * (act(x @ w1 + b1).abs() @ w2.abs() + b2.abs())


def tf32_rounded(t):
    """t's float32 values rounded to TF32's 10 mantissa bits (to nearest)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mlp_f32_controls(x, w1, b1, w2, b2):
    """What the nearest faulty kernels of the gelu MLP compute, in plain
    PyTorch on the same inputs: the tanh gelu for the erf one, every
    product in TF32 alone, the intermediate rounded to bf16, b2 dropped."""
    import torch.nn.functional as F

    from mic_tpu_torch.ops.fused_mlp import gelu_erf

    h = x @ w1 + b1
    act = gelu_erf(h)
    t1 = gelu_erf(tf32_rounded(x) @ tf32_rounded(w1) + b1)
    return {"gelu_tanh for gelu": F.gelu(h, approximate="tanh") @ w2 + b2,
            "TF32 products": tf32_rounded(t1) @ tf32_rounded(w2) + b2,
            "bf16 intermediate": act.bfloat16().float() @ w2 + b2,
            "b2 dropped": act @ w2}


def mlp_f32_bound(n, d, f):
    """Row 16 f32: x, W1, b1, W2, b2 read and the output written once in
    float32 (the (N, F) intermediate counted as kept on chip); 4 N D F
    products at the float32-accurate rate of the tensor cores."""
    return bound(4 * (n * d + d * f + f + f * d + d + n * d), 4 * n * d * f, "tf32x3")


def f32_ce_route_bounds(n, d=1024, v=250054):
    """Rows 9 f32 and 10 f32 at N rows, everything float32 but the saved main
    logits (bf16, as mic_tpu saves them): the save forward reads h, the
    table and bias, writes the statistics and the saved logits, one 2 N D V
    product; the save backward reads the saved logits, the table, h and the
    row terms and writes dh, demb and dbias, two contractions; the split
    backward reads what dl reads and writes what the save backward writes,
    one logits product and two contractions (6 N D V, as row 10's bf16
    bound counts it).  At the float32-accurate rate of the tensor cores."""
    from mic_tpu_torch.ops.flash_ce import main_columns

    v_main = main_columns(v)
    table = v * d * 4 + v * 4
    saved = n * v_main * 2 + n * (v - v_main) * 4
    grads = n * d * 4 + v * d * 4 + v * 4
    return {
        "flash_ce_forward_save_f32": bound(table + n * d * 4 + n * 4 * 4 + saved,
                                           2 * n * d * v, "tf32x3"),
        "flash_ce_backward_save_f32": bound(saved + v * d * 4 + n * d * 4 + n * 4 * 3 + grads,
                                            4 * n * d * v, "tf32x3"),
        "flash_ce_backward_f32": bound(table + n * d * 4 + n * 4 * 3 + grads, 6 * n * d * v,
                                       "tf32x3"),
    }


def f32_bwd_scales(hidden, weight, bias, labels, lse, rs, ls):
    """(|dl| + 2 target rowscale)^T |h| and (|dl| + 2 target rowscale) |W|
    (tests/test_torch_cuda_kernels.py::_f32_bwd_scales): what an error of
    1e-4 of each dl entry's own size moves each demb and dh entry by; dl
    the plain f32 one, 512 rows at a time."""
    from mic_tpu_torch.ops.flash_ce import _targets, dlogits

    low, conf_low = _targets(ls, weight.shape[0])
    demb = torch.zeros(weight.shape, device=hidden.device)
    dh = torch.empty(hidden.shape, device=hidden.device)
    for i in range(0, hidden.shape[0], 512):
        rows = slice(i, i + 512)
        p = torch.exp(hidden[rows] @ weight.T + bias - lse[rows, None])
        dl = dlogits(p, labels[rows], rs[rows], ls).abs()
        del p
        target = torch.full_like(dl, low)
        target.scatter_(1, labels[rows, None].long(), low + conf_low)
        dl += 2 * target * rs[rows, None]
        del target
        demb += dl.T @ hidden[rows].abs()
        dh[rows] = dl @ weight.abs()
    return demb, dh


def check_f32_mlp(dev):
    """Phase 66, row 16 f32 at the flagship's D=1024, F=4096, N=1024 (B=256
    beam 4) and N=32 (both products split in depth) against its plain
    version, TF32 off: every output within ``mlp_f32_limit``, a rerun
    bit-equal; and each of ``mlp_f32_controls`` beyond that limit, held
    against the same plain version (the limit tells them apart).  Then in
    CUDA-graph replays beside the plain version and, for scale only, the
    chain F.linear -> F.gelu -> F.linear in float32 (three calls, none of
    them the function) -> (error, times by N)."""
    import torch.nn.functional as F

    from mic_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for matmuls")
    d, f = HEAD_D, 4 * HEAD_D
    g = torch.Generator(device=dev).manual_seed(66)
    w1 = torch.randn((d, f), generator=g, device=dev) * (1.6 / d**0.5)
    b1 = 0.1 * torch.randn((f,), generator=g, device=dev)
    w2 = torch.randn((f, d), generator=g, device=dev) * (1.6 / f**0.5)
    b2 = 0.1 * torch.randn((d,), generator=g, device=dev)
    w1t, w2t = w1.t(), w2.t()
    worst, times = 0.0, {}
    for n in (FLAG_B * FLAG_K, 32):
        x = torch.randn((n, d), generator=g, device=dev)
        out, again = fused_mlp(x, w1, b1, w2, b2), fused_mlp(x, w1, b1, w2, b2)
        ref = fused_mlp_plain(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        require(out.dtype == torch.float32, "fused_mlp f32: output dtype")
        require(torch.equal(out, again), f"fused_mlp f32 N={n}: a rerun differs")
        limit = mlp_f32_limit(x, w1, b1, w2, b2)
        ratio = ((out - ref).abs() / limit).max().item()
        require(ratio <= 1.0, f"fused_mlp f32 N={n}: beyond its tolerance")
        caught = {name: ((c - ref).abs() / limit).max().item()
                  for name, c in mlp_f32_controls(x, w1, b1, w2, b2).items()}
        print(f"fused_mlp f32 N={n}: largest |kernel - plain| / (sum |act(h)| |w2| + |b2|) "
              f"{ratio * MLP_F32_TOL:.3g} (tolerance {MLP_F32_TOL:.3g}); the faulty controls' "
              + ", ".join(f"{name} {r * MLP_F32_TOL:.3g}" for name, r in caught.items()),
              flush=True)
        require(all(r > 1.0 for r in caught.values()),
                f"fused_mlp f32 N={n}: the tolerance passes a faulty control: {caught}")
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        times[n] = (graph_ms(lambda: fused_mlp(x, w1, b1, w2, b2)),
                    graph_ms(lambda: fused_mlp_plain(x, w1, b1, w2, b2)),
                    graph_ms(lambda: F.linear(F.gelu(F.linear(x, w1t, b1)), w2t, b2)))
        b_ms, by = mlp_f32_bound(n, d, f)
        print(f"fused_mlp f32 N={n} D={d} F={f}: max_abs_err={err:.3g} ({ratio:.3g} of its "
              f"tolerance), rerun bit-equal; kernel {times[n][0]:.4f} ms, plain "
              f"{times[n][1]:.4f} ms (graph replays), bound {b_ms:.4f} ms ({by}), the kernel at "
              f"{b_ms / times[n][0]:.1%} of it; for scale only F.linear -> F.gelu -> F.linear "
              f"f32 {times[n][2]:.4f} ms", flush=True)
    return worst, times


def check_f32_ce_routes(dev):
    """Phase 66, rows 9 f32 and 10 f32 at the flagship step (N=4096, D=1024,
    V=250054; float32 table at the init's scale, unit hidden rows), TF32
    off.  The save forward: its statistics bit-equal to the non-saving
    kernel's (row 7 f32), a rerun bit-equal, its bf16 main span within one
    bf16 ulp of the f32 logits plus 1e-5, its f32 tail within 1e-5 of the
    row's |h| |w| + |b|.  The save backward (from the kernel's saved
    logits) and the split backward (the dl walk a vocab chunk at a time,
    then both contractions) against their plain versions on the same
    inputs, smoothing 0 and 0.1, every seventh row's rowscale 0: demb and
    dh entry by entry within 1e-4 of ``f32_bwd_scales`` (dl formed in f32
    on both sides, its exp and the logits' sums in other orders), dbias
    within 1e-5 of its largest entry, a rerun bit-equal.  Then each in
    CUDA-graph replays (one call a graph) beside its plain version ->
    (errors, times)."""
    from mic_tpu_torch.ops import flash_ce as fce

    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for matmuls")
    weight, bias = _f32_table(dev, CE_V, CE_D, 66)
    n = 4096
    hidden, labels = _ce_rows(dev, n, 660)
    hidden = hidden.float()
    v_main = fce.main_columns(CE_V)
    errs, times = {}, {}
    out = fce.flash_ce_forward(hidden, weight, bias, labels, save=True)
    again = fce.flash_ce_forward(hidden, weight, bias, labels, save=True)
    stats = fce.flash_ce_forward(hidden, weight, bias, labels)
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) for a, c in zip(out, again)),
            "flash_ce_forward save f32: a rerun differs")
    require(all(torch.equal(a, c) for a, c in zip(out[:3], stats)),
            "flash_ce_forward save f32: statistics differ from the non-saving kernel's")
    require(out[3].dtype == torch.bfloat16 and out[3].shape == (n, v_main)
            and out[4].shape == (n, CE_V - v_main), "flash_ce_forward save f32: saved shapes")
    del again
    main_err, tail_err = 0.0, 0.0
    for i in range(0, n, 512):
        exact = hidden[i:i + 512] @ weight.T + bias
        main = exact[:, :v_main]
        d_ = (out[3][i:i + 512].float() - main).abs()
        require(bool((d_ <= _bf16_ulp(main) + 1e-5).all()),
                "flash_ce_forward save f32: bf16 logits beyond one ulp of the f32 logits")
        main_err = max(main_err, d_.max().item())
        scale = hidden[i:i + 512].abs() @ weight[v_main:].abs().T + bias[v_main:].abs()
        t_ = (out[4][i:i + 512] - exact[:, v_main:]).abs()
        require(bool((t_ <= 1e-5 * scale).all()), "flash_ce_forward save f32: tail logits")
        tail_err = max(tail_err, t_.max().item())
        del exact, main, d_, scale, t_
    errs["flash_ce_forward_save_f32"] = main_err
    print(f"flash_ce_forward save f32 N={n} D={CE_D} V={CE_V} v_main={v_main}: statistics "
          f"bit-equal to the non-saving kernel, rerun bit-equal; bf16 logits max_abs_err "
          f"{main_err:.3g} (within one bf16 ulp + 1e-5), tail max_abs_err {tail_err:.3g}",
          flush=True)
    lse, lg, tail = out[0], out[3], out[4]
    del out, stats
    rs = torch.rand((n,), generator=torch.Generator(device=dev).manual_seed(661), device=dev) / n
    rs[::7] = 0.0
    routes = (("flash_ce_backward_f32", fce.flash_ce_backward, fce.flash_ce_backward_dl_plain,
               ()),
              ("flash_ce_backward_save_f32", fce.flash_ce_backward_save,
               fce.flash_ce_backward_save_plain, (lg, tail)))
    for ls in (0.0, 0.1):
        demb_scale, dh_scale = f32_bwd_scales(hidden, weight, bias, labels, lse, rs, ls)
        for name, fn, plain, extra in routes:
            got = fn(hidden, weight, bias, labels, lse, rs, ls, None, *extra)
            again = fn(hidden, weight, bias, labels, lse, rs, ls, None, *extra)
            torch.cuda.synchronize()
            require(all(torch.equal(a, c) for a, c in zip(got, again)), f"{name}: a rerun differs")
            del again
            ref = plain(hidden, weight, bias, labels, lse, rs, ls, None, *extra)
            require(all(x.dtype == torch.float32 for x in got), f"{name}: gradient dtypes")
            # a row of rowscale 0 has dl 0: its dh and scale are both 0
            demb_ratio = ((got[1] - ref[1]).abs() / demb_scale.clamp_min(1e-30)).max().item()
            dh_ratio = ((got[0] - ref[0]).abs() / dh_scale.clamp_min(1e-30)).max().item()
            top = ref[2].abs().max().item()
            db = (got[2] - ref[2]).abs().max().item() / top
            require(demb_ratio <= 1e-4 and dh_ratio <= 1e-4 and db <= 1e-5,
                    f"{name} smoothing {ls}: demb {demb_ratio:.3g}, dh {dh_ratio:.3g} (limits "
                    f"1e-4 of the scales), dbias {db:.3g} (1e-5)")
            errs[name] = max(errs.get(name, 0.0), (got[1] - ref[1]).abs().max().item())
            print(f"{name} N={n} smoothing={ls}: max err / scale demb {demb_ratio:.3g}, dh "
                  f"{dh_ratio:.3g} (limits 1e-4); dbias max err / max |ref| {db:.3g} (1e-5); "
                  "rerun bit-equal", flush=True)
            del got, ref
        del demb_scale, dh_scale
        torch.cuda.empty_cache()
    rs = torch.full((n,), 1.0 / n, device=dev)
    args = (hidden, weight, bias, labels, lse, rs, 0.1, None)
    runs = {
        "flash_ce_forward_save_f32": (
            lambda: fce.flash_ce_forward(hidden, weight, bias, labels, save=True),
            lambda: fce.flash_ce_forward_plain(hidden, weight, bias, labels, save=True)),
        "flash_ce_backward_save_f32": (lambda: fce.flash_ce_backward_save(*args, lg, tail),
                                       lambda: fce.flash_ce_backward_save_plain(*args, lg, tail)),
        "flash_ce_backward_f32": (lambda: fce.flash_ce_backward(*args),
                                  lambda: fce.flash_ce_backward_dl_plain(*args)),
    }
    bounds = f32_ce_route_bounds(n, CE_D, CE_V)
    for name, (kernel, plain) in runs.items():
        times[name] = (graph_ms(kernel, reps=1, runs=3), graph_ms(plain, reps=1, runs=3), None)
        torch.cuda.empty_cache()
        b_ms, by = bounds[name]
        print(f"{name} time at N={n} (graph replays): kernel {times[name][0]:.4f} ms, plain "
              f"{times[name][1]:.4f} ms; bound {b_ms:.4f} ms ({by}), the kernel at "
              f"{b_ms / times[name][0]:.1%} of it", flush=True)
    del weight, bias, lg, tail
    torch.cuda.empty_cache()
    return errs, times


# phase 67's paths: the whole fused beam step on a float32 model
F32_WHOLE_STEP = {
    "whole fused step, float32 cache": (
        {"MIC_TPU_FUSED_LAZY_ATTN": "1",
         "MIC_TPU_EXPERIMENTAL": "fused_cross_attn,fused_mlp,ln_qkv"},
        None, {"fused_lazy_attention": "fused_lazy_attention_f32",
               "fused_cross_attention": "fused_cross_attention_f32", "ln_gemm": "ln_gemm_f32",
               "fused_mlp": "fused_mlp_f32"}),
    "whole fused step, int8 cache": (
        {"MIC_TPU_FUSED_LAZY_ATTN": "1",
         "MIC_TPU_EXPERIMENTAL": "fused_cross_attn,fused_mlp,ln_qkv"},
        "int8", {"fused_lazy_attention": "fused_lazy_attention_q8_f32",
                 "fused_cross_attention": "fused_cross_attention_f32", "ln_gemm": "ln_gemm_f32",
                 "fused_mlp": "fused_mlp_f32"}),
}


def _train_shadow(checks):
    """Each training wrapper runs as the loss calls it, then its plain
    version on the same arguments, and ``check(name, args, kwargs, out,
    ref)`` holds the two ((module, name, plain, check) each) -> {name:
    calls}."""
    calls = {name: 0 for _, name, _, _ in checks}
    old = [(module, name, getattr(module, name)) for module, name, _, _ in checks]

    def make(name, kernel, plain, check):
        def run(*args, **kwargs):
            out = kernel(*args, **kwargs)
            check(name, args, kwargs, out, plain(*args, **kwargs))
            calls[name] += 1
            return out
        return run

    for (module, name, plain, check), (_, _, kernel) in zip(checks, old):
        setattr(module, name, make(name, kernel, plain, check))
    return calls, old


def run_f32_training_routes(dev):
    """Phase 68: the default float32 flagship's Trainer at the TrainConfig
    defaults (64 x 64, dropout 0.1, remat "masks", no shadow at float32)
    with warmup_steps=2 on flash_ce "split" and on "save", three steps each
    from one seed, the training counters set to 0 just before them and read
    just after: "split" rows 7 f32 and 10 f32, "save" row 9 f32's forward
    and backward, once a step.  The same three steps again with every
    launch of those kernels held against its plain version on the same
    arguments (the save forward's statistics within 1e-5, its bf16 logits
    within one bf16 ulp of the plain's plus 1e-5, its tail within 1e-5 of
    the largest; the backwards' demb and dh entry by entry within 1e-4 of
    ``f32_bwd_scales``, dbias within 1e-5 of its largest entry), its first
    loss bit-equal to the first run's and the next within 1e-5 relative.
    Then the same steps with the
    kernels swapped for their plain versions: the first loss within 1e-5
    relative, the next two within 1e-4 (phase 53's limits) -> launches
    (rows 11 and 12 f32's read from the first runs, summed)."""
    import mic_tpu_torch.ops.fused_ce as fused_ce_mod
    from mic_tpu_torch.core.config import CaptionerConfig, DataConfig, TrainConfig
    from mic_tpu_torch.ops import flash_ce as fce
    from mic_tpu_torch.train.trainer import Trainer

    def check_forward(name, args, kwargs, out, ref):
        for got, want in zip(out[:2], ref[:2]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        if kwargs.get("save"):
            ulp = torch.maximum(_bf16_ulp(out[3].float()), _bf16_ulp(ref[3].float()))
            require(bool(((out[3].float() - ref[3].float()).abs() <= ulp + 1e-5).all()),
                    f"{name}: saved logits beyond a bf16 ulp of the plain version's")
            top = ref[4].abs().max().item()
            require((out[4] - ref[4]).abs().max().item() <= 1e-5 * top, f"{name}: tail")

    def check_backward(name, args, kwargs, out, ref):
        h, emb, bias, labels, lse, rs, ls = args[:7]
        demb_scale, dh_scale = f32_bwd_scales(h, emb, bias, labels, lse, rs, ls)
        require(bool(((out[1] - ref[1]).abs() <= 1e-4 * demb_scale).all()), f"{name}: demb")
        require(bool(((out[0] - ref[0]).abs() <= 1e-4 * dh_scale).all()), f"{name}: dh")
        top = ref[2].abs().max().item()
        require((out[2] - ref[2]).abs().max().item() <= 1e-5 * top, f"{name}: dbias")

    config = CaptionerConfig.clip_vit_b32_mbart50()
    host = _train_batches(config, 3, TrainConfig().per_device_batch_size,
                          DataConfig().max_seq_length, 68)
    expect = {"split": {"flash_ce_forward": 3, "flash_ce_backward": 3},
              "save": {"flash_ce_forward_save": 3, "flash_ce_backward_save": 3}}
    backward = {"split": ("flash_ce_backward", fce.flash_ce_backward_dl_plain),
                "save": ("flash_ce_backward_save", fce.flash_ce_backward_save_plain)}
    launches = {}
    for route, want in expect.items():
        tc = TrainConfig(warmup_steps=2, flash_ce=route)
        runs = {}
        for label in ("kernels", "shadowed", "plain"):
            t0 = time.perf_counter()
            trainer = Trainer(config, DataConfig(), tc, device=dev)
            trainer.build(steps_per_epoch=len(host))
            state = trainer.init_state()
            require(state.shadow is None, "float32: a shadow was made")
            batches = [trainer.put_batch(b) for b in host]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            bname, bplain = backward[route]
            checks = [(fused_ce_mod, bname, bplain, check_backward)]
            if route == "save":
                checks.append((fused_ce_mod, "flash_ce_forward", fce.flash_ce_forward_plain,
                               check_forward))
            calls, old = _train_shadow(checks) if label == "shadowed" else ({}, [])
            plain_fns = {"flash_ce_forward": fce.flash_ce_forward_plain, bname: bplain}
            swaps = ([(fused_ce_mod, name, fn) for name, fn in plain_fns.items()]
                     if label == "plain" else [])
            _train_counts(reset=True)
            losses, ms = [], []
            try:
                with plain_versions(*swaps):
                    for batch in batches:
                        t1 = time.perf_counter()
                        state, metrics = trainer.train_step(state, batch)
                        losses.append(metrics["loss"].item())
                        ms.append((time.perf_counter() - t1) * 1e3)
            finally:
                for module, name, fn in old:
                    setattr(module, name, fn)
            attention = _f32_attention_counts()
            got = {k: v for k, v in _train_counts().items() if v}
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"float32 flagship training, route {route!r}, {label}: losses {losses}, "
                  f"launches {got}, {'' if not calls else f'held against plain {calls}, '}"
                  f"peak allocated {peak:.2f} GiB, step times {[round(x, 1) for x in ms]} ms "
                  f"(smoke figures), {time.perf_counter() - t0:.1f} s with init", flush=True)
            require(all(np.isfinite(losses)), f"float32 {route} ({label}): a non-finite loss")
            runs[label] = (losses, got, calls, attention)
            del trainer, state, batches
            torch.cuda.empty_cache()
        (losses, got, _, attention), (shadow, shadow_got, calls, _), (plain, plain_got, _, _) = (
            runs["kernels"], runs["shadowed"], runs["plain"])
        require(got == want, f"float32 {route}: launches {got}, expected {want}")
        require(shadow_got == want and all(c == 3 for c in calls.values()),
                f"float32 {route}: the shadowed run launched {shadow_got}, checked {calls}")
        require(shadow[0] == losses[0] and all(abs(a - b) <= 1e-5 * abs(b) for a, b in
                                               zip(shadow[1:], losses[1:])),
                f"float32 {route}: the shadowed run's losses differ from the first run's")
        require(not plain_got, f"float32 {route}: the plain run launched {plain_got}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
        print(f"float32 training, route {route!r}: kernels' losses against the plain versions', "
              f"relative differences {[f'{r:.3g}' for r in rel]} (limits 1e-5, 1e-4, 1e-4)",
              flush=True)
        require(rel[0] <= 1e-5 and max(rel[1:]) <= 1e-4,
                f"float32 {route}: the losses differ from the plain versions'")
        for name, count in got.items():
            launches[f"{name}_f32"] = count
        for name, count in attention.items():
            launches[name] = launches.get(name, 0) + count
    return launches


# Phases 69-70 (ROADMAP B41, B45): wide beam search.  Row 3 at 9-16 beams
# (one kernel instance, K read at run time), the exact and window selects
# (rows 5, 5 f32, 6) and row 17 at 17-40 candidates (16 beams with an
# n-gram ban ask for 2 x 16 + 5 = 37 a row).
WIDE_B = 64  # images: at 16 beams the same 1024 beam rows as B=256 beam 4
WIDE_BEAMS = (9, 12, 16)
WIDE_KS = (17, 37, 40)
WIDE_INDICES = (1, 17, 63)
# row 3's cache forms: (q's dtype, the cache's: None the q dtype, "int8"
# the per-head int8 cache)
WIDE_FORMS = {"bf16": (torch.bfloat16, None), "int8": (torch.bfloat16, "int8"),
              "f32": (torch.float32, None), "int8 f32 q": (torch.float32, "int8")}
# (beams, T, index) where row 3's walk takes every row in order (two chunk
# buffers), and where K's and V's chunks share one buffer (blocked_layout)
WIDE_WALKS = {"bf16": ((16, 240, 210), (15, 264, 258)),
              "int8": ((16, 240, 210), (15, 264, 258)),
              "f32": ((16, 240, 210), (9, 712, 709)),
              "int8 f32 q": ((16, 240, 210), (15, 264, 258))}


def _wide_blocked_inputs(dev, g, form, b, beams, t, index):
    """Row 3's inputs in ``form`` (WIDE_FORMS): q, the step rows, both
    caches and the ancestry mask of a random ancestry at write ``index``."""
    from mic_tpu_torch.ops.lazy_attention import build_ancestry_mask
    from mic_tpu_torch.ops.quant import quantize_rows_dynamic

    dtype, cache_kind = WIDE_FORMS[form]
    heads, hd = FLAG_H, FLAG_H * FLAG_DH

    def rand(*shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def cache():
        prefix = rand(b * beams, t, hd)
        if cache_kind is None:
            return prefix
        values, scales = quantize_rows_dynamic(prefix.reshape(b * beams, t, heads, FLAG_DH))
        return {"q": values.reshape(b * beams, t, hd), "s": scales[..., 0].contiguous()}

    q, ks, vs = rand(b, beams, hd, scale=0.3), rand(b, beams, hd), rand(b, beams, hd)
    ck, cv = cache(), cache()
    anc = torch.randint(0, beams, (b, beams, t), generator=g, device=dev, dtype=torch.int32)
    return q, ck, cv, ks, vs, build_ancestry_mask(anc, index)


def _wide_layout(form, beams, index):
    from mic_tpu_torch.ops.lazy_attention import blocked_layout

    _, cache_kind = WIDE_FORMS[form]
    compact, stage, shared, nbytes = blocked_layout(beams, index, cache_kind == "int8",
                                                    form == "f32")
    return ("list" if compact else "every row") + (", one shared buffer" if shared else "") + \
        f", {stage} rows a chunk, {nbytes} B"


def check_wide_attention(dev):
    """Phase 69, row 3: the kernel's 9-16-beam instance against its plain
    version in every form (WIDE_FORMS) at B=64, T=64, H=16, K in {9, 12,
    16} (12 and 9: mask rows not 4-byte aligned), index in {1, 17, 63}, the
    walk over the list; then at the shapes of WIDE_WALKS (every row in
    order; one buffer for K's and V's chunks): within 2e-2 (bf16 weights and
    output after f32 sums in another order), a rerun bit-equal, the caches
    untouched.  Then on a mask of random bits with q = 0 and integer V
    values (every admitted weight 1 / (live rows + 1), every sum exact) at
    K in {12, 16}, bf16 and int8: bit-equal to plain, which routes each
    beam's bits, weights and output rows.  Eight beams and fewer, in each
    form, still run their own instances (K=8, index 63).  -> worst error a
    form."""
    from mic_tpu_torch.ops.lazy_attention import fused_lazy_attention, fused_lazy_attention_plain

    heads, hd = FLAG_H, FLAG_H * FLAG_DH
    g = torch.Generator(device=dev).manual_seed(69)
    worst = {}
    for form in WIDE_FORMS:
        cases = [(WIDE_B, beams, FLAG_T, index) for beams in WIDE_BEAMS for index in WIDE_INDICES]
        cases += [(WIDE_B, beams, t, index) for beams, t, index in WIDE_WALKS[form]]
        cases += [(WIDE_B * 2, 8, FLAG_T, 63)]
        worst[form] = 0.0
        for b, beams, t, index in cases:
            q, ck, cv, ks, vs, amask = _wide_blocked_inputs(dev, g, form, b, beams, t, index)
            planes = [a for c in (ck, cv) for a in (c.values() if isinstance(c, dict) else (c,))]
            before = [a.clone() for a in planes]
            args = (q, ck, cv, ks, vs, amask, beams, heads)
            out = fused_lazy_attention(*args, positions=index)
            again = fused_lazy_attention(*args, positions=index)
            ref = fused_lazy_attention_plain(*args)
            torch.cuda.synchronize()
            what = f"fused_lazy_attention {form} B={b} K={beams} T={t} index={index}"
            require(out.dtype == q.dtype, f"{what}: output dtype")
            torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
            require(torch.equal(out, again), f"{what}: a rerun differs")
            require(all(torch.equal(a, o) for a, o in zip(planes, before)),
                    f"{what}: a cache it only reads changed")
            err = (out.float() - ref.float()).abs().max().item()
            worst[form] = max(worst[form], err)
            print(f"{what} ({_wide_layout(form, beams, index)}): max_abs_err={err:.6g}, rerun "
                  "bit-equal, caches untouched", flush=True)
            del q, ck, cv, ks, vs, amask, planes, before, out, again, ref
        torch.cuda.empty_cache()
    for form in ("bf16", "int8"):
        for beams in (12, 16):
            b, t, index = WIDE_B, FLAG_T, 63
            q8 = form == "int8"
            q = torch.zeros((b, beams, hd), dtype=torch.bfloat16, device=dev)
            ks = (torch.randn((b, beams, hd), generator=g, device=dev) * 0.5).bfloat16()
            vs = torch.randint(-3, 4, (b, beams, hd), generator=g, device=dev).bfloat16()
            ck = _wide_blocked_inputs(dev, g, form, b, beams, t, index)[1]
            values = torch.randint(-3, 4, (b * beams, t, hd), generator=g, device=dev)
            cv = ({"q": values.to(torch.int8),
                   "s": torch.randint(1, 3, (b * beams, t, heads), generator=g,
                                      device=dev).float()}
                  if q8 else values.bfloat16())
            live = (torch.arange(t, device=dev) < index).repeat(beams)[None, :, None]
            amask = (torch.randint(0, 2, (b, beams * t, beams), generator=g, device=dev)
                     * live).to(torch.int8)
            out = fused_lazy_attention(q, ck, cv, ks, vs, amask, beams, heads, positions=index)
            ref = fused_lazy_attention_plain(q, ck, cv, ks, vs, amask, beams, heads)
            torch.cuda.synchronize()
            require(torch.equal(out, ref), f"fused_lazy_attention {form} K={beams}: exact sums "
                    "not bit-equal to plain")
            print(f"fused_lazy_attention {form} K={beams} index=63, random-bit mask, q = 0 and "
                  "integer V (exact sums): bit-equal to plain", flush=True)
    return worst


def _tied_bias(dev, v):
    """A bias of many ties for the selects' order: 20 columns at 3, 20 at
    2, the rest 0."""
    g = torch.Generator(device="cpu").manual_seed(70)
    b = torch.zeros((v,), dtype=torch.bfloat16)
    cols = torch.randperm(v, generator=g)[:40]
    b[cols[:20]], b[cols[20:]] = 3.0, 2.0
    return b.to(dev)


def check_wide_heads(dev, table):
    """Phase 69, rows 5, 5 f32, 6 and 17: the wide instances (17 <= k <=
    40) against their plain versions at N=1024 (and N=4 and 65), D=1024,
    V=250054, k in {17, 37, 40}.  bf16 select (row 5): phase 13's
    tolerances (``_bf16_head_case``); int8 select (row 6): ids equal, each
    lp exactly the plain logit minus the kernel's lse; float32 select (row
    5 f32): ``_f32_head_case``'s; each exact and window.  Ties (zero hidden
    rows: the logits are a bias of ties) in all three at k = 37: ids equal
    to plain (the lower id first; in a window the highest lane).  Row 17:
    bf16 and f32 logits, ids equal and lp within 1e-5 of plain, at N=1024
    and on ``planted_logits`` rows (the 16 planted columns first, reruns
    bit-equal).  k = 16 beside k = 17 on the same rows: the narrow and the
    wide instance agree on their first 16 candidates.  -> worst errors by
    name."""
    from mic_tpu_torch.ops.fused_head import (
        _logits, _logits_q8, fused_head_topk, fused_head_topk_plain, fused_head_topk_q8,
        fused_head_topk_q8_plain,
    )
    from mic_tpu_torch.ops.quant import quantize_rows_dynamic
    from mic_tpu_torch.ops.topk_lse import topk_log_probs, topk_log_probs_plain

    weight, bias, wq, ws = table
    w32, b32 = weight.float(), bias.float()
    worst = {"fused_head_select_bf16": 0.0, "fused_head_select": 0.0,
             "fused_head_select_f32": 0.0, "topk_log_probs": 0.0}
    narrow = {}  # select -> the k = 16 candidates at N=1024
    for n in (4, 65, 1024):
        hidden = _hidden(dev, n, HEAD_D, 690 + n)
        logits = _logits(hidden, weight, bias)
        logits_q8 = _logits_q8(*quantize_rows_dynamic(hidden), wq, ws, bias)
        h32 = hidden.float()
        logits32 = _logits(h32, w32, b32)
        for k in ((16,) + WIDE_KS if n == 1024 else (37,)):
            for select in ("exact", "window"):
                what = f"N={n} k={k} {select}"
                got = fused_head_topk(hidden, weight, bias, k, select)
                ref = fused_head_topk_plain(hidden, weight, bias, k, select)
                torch.cuda.synchronize()
                err, ties = _bf16_head_case(got, ref, logits, f"select bf16 {what}", False)
                worst["fused_head_select_bf16"] = max(worst["fused_head_select_bf16"], err)
                lp, ids, lse = fused_head_topk_q8(hidden, wq, ws, bias, k, select)
                rlp, rids, rlse = fused_head_topk_q8_plain(hidden, wq, ws, bias, k, select)
                torch.cuda.synchronize()
                require(torch.equal(ids, rids), f"select int8 {what}: ids differ from plain")
                require(torch.equal(lp, logits_q8.gather(1, ids.long()) - lse),
                        f"select int8 {what}: a candidate's logit differs from plain")
                torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=0)
                q8_err = (lp - rlp).abs().max().item()
                worst["fused_head_select"] = max(worst["fused_head_select"], q8_err)
                got32 = fused_head_topk(h32, w32, b32, k, select)
                ref32 = fused_head_topk_plain(h32, w32, b32, k, select)
                torch.cuda.synchronize()
                err32, ties32 = _f32_head_case(got32, ref32, logits32, f"select f32 {what}")
                worst["fused_head_select_f32"] = max(worst["fused_head_select_f32"], err32)
                print(f"fused_head_select {what}: bf16 lp max_abs_err={err:.3g} (near-tie id "
                      f"differences {ties}), int8 {q8_err:.3g} (ids equal, logits bit-equal), "
                      f"f32 {err32:.3g} (near-tie id differences {ties32})", flush=True)
                if k == 16:
                    narrow[select] = (got[1], lp, got32[1])
                elif k == 17:
                    ids16, lp16, ids16_f32 = narrow[select]
                    require(torch.equal(ids16, got[1][:, :16]) and
                            torch.equal(ids16_f32, got32[1][:, :16]),
                            f"select {what}: k=17's first 16 ids differ from k=16's")
                    require(torch.equal(lp16, lp[:, :16]),
                            f"select int8 {what}: k=17's first 16 lp differ from k=16's")
        del logits, logits_q8, logits32
    # ties: zero hidden rows, a bias of ties
    tb = _tied_bias(dev, 5000)
    zero = torch.zeros((4, HEAD_D), device=dev, dtype=torch.bfloat16)
    for select in ("exact", "window"):
        outs = {"bf16": fused_head_topk(zero, weight[:5000], tb, 37, select),
                "int8": fused_head_topk_q8(zero, wq[:5000], ws[:5000], tb, 37, select),
                "f32": fused_head_topk(zero.float(), w32[:5000], tb.float(), 37, select)}
        ref = fused_head_topk_plain(zero, weight[:5000], tb, 37, select)
        torch.cuda.synchronize()
        for name, out in outs.items():
            require(torch.equal(out[1], ref[1]), f"fused_head_select {name} {select} ties at "
                    f"k=37: ids {out[1][0].tolist()}, want {ref[1][0].tolist()}")
    print("fused_head_select ties at k=37: bf16, int8 and f32 ids equal to plain (lower id "
          "first; the highest lane in a window)", flush=True)

    g = torch.Generator(device=dev).manual_seed(691)
    for n, v in ((1024, HEAD_V), (70, 997)):
        x = torch.randn((n, v), generator=g, device=dev) * 2
        if v == 997:
            x[0] = 0.0
            x[1, [900, 5, 300]] = 9.0
            x[2] = torch.round(x[2] * 2)
        for dtype in (torch.bfloat16, torch.float32):
            for k in WIDE_KS:
                lp, ids = topk_log_probs(x.to(dtype), k)
                rlp, rids = topk_log_probs_plain(x.to(dtype), k)
                torch.cuda.synchronize()
                what = f"topk_log_probs N={n} V={v} k={k} {dtype}"
                require(torch.equal(ids, rids), f"{what}: ids differ from plain")
                err = (lp - rlp).abs().max().item()
                require(err <= 1e-5, f"{what}: log-probs differ from plain")
                worst["topk_log_probs"] = max(worst["topk_log_probs"], err)
            print(f"topk_log_probs N={n} V={v} {dtype}: k in {WIDE_KS} ids equal, lp within "
                  f"1e-5 (worst so far {worst['topk_log_probs']:.3g})", flush=True)
    for v in (997, HEAD_V):
        for dtype in (torch.bfloat16, torch.float32):
            for offset in (0, 3, 7):
                x, cols = planted_logits(g, 24, v, offset, dtype)
                for k in WIDE_KS:
                    lp, ids = topk_log_probs(x, k)
                    lp2, ids2 = topk_log_probs(x, k)
                    rlp, rids = topk_log_probs_plain(x, k)
                    torch.cuda.synchronize()
                    what = f"topk_log_probs planted V={v} offset={offset} k={k} {dtype}"
                    require(torch.equal(ids, rids), f"{what}: ids differ from plain")
                    require(torch.equal(ids[:, :16].cpu().long(), cols),
                            f"{what}: a planted column was missed")
                    require(torch.equal(lp, lp2) and torch.equal(ids, ids2),
                            f"{what}: a rerun differs")
                    require((lp - rlp).abs().max().item() <= 1e-5,
                            f"{what}: log-probs differ from plain")
        print(f"topk_log_probs planted rows N=24 V={v}, offsets 0, 3, 7, k in {WIDE_KS}, bf16 "
              "and f32: ids equal, the planted columns first, reruns bit-equal", flush=True)
    return worst


def time_wide_instances(dev, table):
    """Phase 69's times: each wide instance in CUDA-graph replays
    (``graph_ms``) beside its plain version's (heads: two calls a replay)
    and its bound; row 3 at B=64 K=16 T=64 H=16, index 63 and 17, each
    form; the selects at N=1024, k=37, exact and window; row 17 at N=1024
    k=37 in bf16 beside torch.topk + torch.logsumexp.  The narrow instances
    beside them on the same card: row 3 at B=256 K=4 index 63, the selects
    and row 17 at k=9.  -> {kernels-line name: (ms, plain ms, library ms)},
    {name: bound}, and every time by case."""
    from mic_tpu_torch.ops.fused_head import (
        fused_head_topk, fused_head_topk_plain, fused_head_topk_q8, fused_head_topk_q8_plain,
    )
    from mic_tpu_torch.ops.lazy_attention import fused_lazy_attention, fused_lazy_attention_plain
    from mic_tpu_torch.ops.topk_lse import topk_log_probs, topk_log_probs_plain

    g = torch.Generator(device=dev).manual_seed(692)
    heads = FLAG_H
    times, bounds, cases = {}, {}, {}
    names = {"bf16": "fused_lazy_attention_wide", "int8": "fused_lazy_attention_q8_wide",
             "f32": "fused_lazy_attention_f32_wide",
             "int8 f32 q": "fused_lazy_attention_q8_f32_wide"}
    for form, name in names.items():
        for b, beams, index in ((WIDE_B, 16, 63), (WIDE_B, 16, 17), (FLAG_B, FLAG_K, 63)):
            args = _wide_blocked_inputs(dev, g, form, b, beams, FLAG_T, index) + (beams, heads)
            ms = graph_ms(lambda: fused_lazy_attention(*args, positions=index))
            cases[f"fused_lazy_attention {form} B={b} K={beams} index={index}"] = ms
            if beams == 16 and index == 63:
                plain_ms = graph_ms(lambda: fused_lazy_attention_plain(*args))
                times[name] = (ms, plain_ms, None)
                live = int((args[5] != 0).any(-1).sum())
                q8 = WIDE_FORMS[form][1] == "int8"
                f32q = WIDE_FORMS[form][0] == torch.float32
                bounds[name] = blocked_attention_bound(
                    live, b, beams, index, HEAD_D, heads, 1 if q8 else 4 if f32q else 2,
                    scale_bytes=4 if q8 else 0, io_bytes=4 if f32q else 2)
                cases[f"fused_lazy_attention {form} K=16 plain"] = plain_ms
                print(f"fused_lazy_attention {form} B={b} K=16 index 63: masks admit {live} of "
                      f"{b * beams * 63} cached rows", flush=True)
            del args
        torch.cuda.empty_cache()
    weight, bias, wq, ws = table
    w32, b32 = weight.float(), bias.float()
    hidden = _hidden(dev, 1024, HEAD_D, 693)
    h32 = hidden.float()
    runs = {
        "fused_head_select_bf16_wide": (lambda k, s: fused_head_topk(hidden, weight, bias, k, s),
                                        lambda k, s: fused_head_topk_plain(hidden, weight, bias,
                                                                           k, s)),
        "fused_head_select_wide": (lambda k, s: fused_head_topk_q8(hidden, wq, ws, bias, k, s),
                                   lambda k, s: fused_head_topk_q8_plain(hidden, wq, ws, bias,
                                                                         k, s)),
        "fused_head_select_f32_wide": (lambda k, s: fused_head_topk(h32, w32, b32, k, s),
                                       lambda k, s: fused_head_topk_plain(h32, w32, b32, k, s)),
    }
    for name, (kernel, plain) in runs.items():
        for select in ("exact", "window"):
            for k in (37, 9):
                cases[f"{name} {select} k={k}"] = graph_ms(lambda: kernel(k, select))
            cases[f"{name} {select} k=37 plain"] = graph_ms(lambda: plain(37, select), reps=2,
                                                            runs=3)
            torch.cuda.empty_cache()
        times[name] = (cases[f"{name} exact k=37"], cases[f"{name} exact k=37 plain"], None)
    bounds["fused_head_select_bf16_wide"] = head_bound(1024, HEAD_D, HEAD_V, 37, 2, "bf16")
    bounds["fused_head_select_wide"] = head_bound(1024, HEAD_D, HEAD_V, 37, 1, "int8",
                                                  scales=True)
    table32 = HEAD_V * HEAD_D * 4 + HEAD_V * 4
    bounds["fused_head_select_f32_wide"] = bound(table32 + 1024 * HEAD_D * 4 + 1024 * (8 * 37 + 4),
                                                 2 * 1024 * HEAD_D * HEAD_V, "tf32x3")
    x = (torch.randn((1024, HEAD_V), generator=g, device=dev) * 2).bfloat16()
    for k in (37, 9):
        cases[f"topk_log_probs k={k}"] = graph_ms(lambda: topk_log_probs(x, k))
    cases["topk_log_probs k=37 plain"] = graph_ms(lambda: topk_log_probs_plain(x, 37), reps=2,
                                                  runs=3)
    cases["torch.topk + torch.logsumexp k=37"] = graph_ms(
        lambda: (torch.topk(x, 37), torch.logsumexp(x, dim=-1)))
    times["topk_log_probs_wide"] = (cases["topk_log_probs k=37"],
                                    cases["topk_log_probs k=37 plain"],
                                    cases["torch.topk + torch.logsumexp k=37"])
    bounds["topk_log_probs_wide"] = topk_bound(1024, HEAD_V, 37, 2)
    del x
    torch.cuda.empty_cache()
    print("phase 69, CUDA-graph replay ms (the narrow instances beside): " + ", ".join(
        f"{case} {ms:.4f}" for case, ms in cases.items()), flush=True)
    print("phase 69, the wide instances (ms, plain ms, library ms; bound ms): " + ", ".join(
        f"{name} {t[0]:.4f}, {t[1]:.4f}, {t[2] if t[2] is None else round(t[2], 4)}; "
        f"{bounds[name][0]:.4f} ({bounds[name][1]})" for name, t in times.items()), flush=True)
    return times, bounds


# Phase 70's paths: (model dtype, switches, generate's extra arguments,
# beams, {counter: kernels-line name}); each counter reads 12 a step for
# the attention rows and one a step for the heads (but at forced tokens).
WIDE_FUSED = dict(FUSED_STEP, MIC_TPU_FUSED_SELECT="exact")
WIDE_PATHS = {
    "(a) default": ("bfloat16", {}, {}, 16,
                    {"lazy_attention": "lazy_attention", "fused_head": "fused_head_bucket"}),
    "(b) exact, n-gram 3": ("bfloat16", {"MIC_TPU_FUSED_SELECT": "exact"},
                            {"no_repeat_ngram_size": 3}, 16,
                            {"lazy_attention": "lazy_attention",
                             "fused_head_select": "fused_head_select_bf16_wide"}),
    "(c) int8 weights and KV, window": ("bfloat16", {"MIC_TPU_FUSED_SELECT": "window"},
                                        {"quantize": "int8", "kv_quant": "int8"}, 16,
                                        {"lazy_attention_q8": "lazy_attention_q8",
                                         "fused_head_select": "fused_head_select_wide"}),
    "(d) fused step, exact": ("bfloat16", WIDE_FUSED, {}, 16,
                              {"fused_lazy_attention": "fused_lazy_attention_wide",
                               "fused_cross_attention": "fused_cross_attention",
                               "ln_gemm": "ln_gemm", "fused_mlp": "fused_mlp",
                               "fused_head_select": "fused_head_select_bf16_wide"}),
    "(d) at 12 beams, int8 cache": ("bfloat16", WIDE_FUSED, {"kv_quant": "int8"}, 12,
                                    {"fused_lazy_attention": "fused_lazy_attention_q8_wide",
                                     "fused_cross_attention": "fused_cross_attention",
                                     "ln_gemm": "ln_gemm", "fused_mlp": "fused_mlp",
                                     "fused_head_select": "fused_head_select_bf16_wide"}),
    "(e) pallas_topk, n-gram 3": ("bfloat16", {"MIC_TPU_FUSED_HEAD": "0",
                                               "MIC_TPU_EXPERIMENTAL": "pallas_topk"},
                                  {"no_repeat_ngram_size": 3}, 16,
                                  {"lazy_attention": "lazy_attention",
                                   "topk_log_probs": "topk_log_probs_wide"}),
    "(f) float32 model, fused step, exact": (
        "float32", WIDE_FUSED, {}, 16,
        {"fused_lazy_attention": "fused_lazy_attention_f32_wide",
         "fused_cross_attention": "fused_cross_attention_f32", "ln_gemm": "ln_gemm_f32",
         "fused_mlp": "fused_mlp_f32", "fused_head_select": "fused_head_select_f32_wide"}),
    "(f) at 12 beams, int8 cache": (
        "float32", WIDE_FUSED, {"kv_quant": "int8"}, 12,
        {"fused_lazy_attention": "fused_lazy_attention_q8_f32_wide",
         "fused_cross_attention": "fused_cross_attention_f32", "ln_gemm": "ln_gemm_f32",
         "fused_mlp": "fused_mlp_f32", "fused_head_select": "fused_head_select_f32_wide"}),
}
# of 64 captions equal to the plain versions' run, on the float32 model's
# float32 cache (61 measured).
# In bf16 at 16 beams the two runs part on most images (41 of 64 equal on
# path (a), which runs no kernel of the wide instances): the K-th and
# (K+1)-th of 2K candidates sit within a bf16 rounding of an attention
# output, which the plain versions place elsewhere; the float32 model's
# int8 cache, whose kernel rounds q and the weights to bf16, kept 59 at 12
# beams.  There every launch is held against its plain version on the
# path's own inputs, every parting to BEAM_TIE plus the drift before it,
# and the count printed.
WIDE_EQUAL = 60
# the largest difference between the two runs' kept scores a step before
# a parting that phase 70 takes as drift: bf16 rounding moves them apart
# over the steps (0.196 the largest measured, path (e); 0.174 on path (d)
# at 12 beams, where the plain run's margin was 0.169)
WIDE_DRIFT = 0.25
# phase 70's paths run once more with their head alone on its plain
# version, the captions equal to the kernels' run printed: how many of the
# whole plain run's partings the head makes
WIDE_HEAD_ALONE = ("(e) pallas_topk, n-gram 3",)
# the wide instances in the kernels line: (source, the TPU kernel)
WIDE_ROWS = {
    "fused_lazy_attention_wide": ("lazy_attention.cu", "mic_tpu/ops/lazy_attention.py:257"),
    "fused_lazy_attention_q8_wide": ("lazy_attention.cu", "mic_tpu/ops/lazy_attention.py:257"),
    "fused_lazy_attention_f32_wide": ("lazy_attention.cu", "mic_tpu/ops/lazy_attention.py:257"),
    "fused_lazy_attention_q8_f32_wide": ("lazy_attention.cu",
                                         "mic_tpu/ops/lazy_attention.py:257"),
    "fused_head_select_bf16_wide": ("fused_head.cu", "mic_tpu/ops/fused_head.py:290"),
    "fused_head_select_wide": ("fused_head.cu", "mic_tpu/ops/fused_head.py:461"),
    "fused_head_select_f32_wide": ("fused_head.cu", "mic_tpu/ops/fused_head.py:290"),
    "topk_log_probs_wide": ("topk_lse.cu", "mic_tpu/ops/topk_lse.py:94"),
}
ATTENTION_ROWS = ("lazy_attention", "lazy_attention_q8", "fused_lazy_attention",
                  "fused_cross_attention", "ln_gemm", "fused_mlp")


def _check_path_head(args, out, ref):
    """Rows 4, 5 and 5 f32 on phase 70's paths: phase 69's tolerances
    (``_bf16_head_case``, lp over every entry for the bucket and where the
    ids agree for a select; ``_f32_head_case``)."""
    from mic_tpu_torch.ops.fused_head import _logits

    hidden, weight, bias, k, select = args[:5]
    logits = _logits(hidden, weight, bias)
    what = f"fused_head_topk {select} k={k} on the path"
    if hidden.dtype == torch.float32:
        return _f32_head_case(out, ref, logits, what)
    return _bf16_head_case(out, ref, logits, what, select == "bucket")


def _check_path_head_q8(args, out, ref):
    """Row 6 on phase 70's paths, as phase 69 holds it: ids equal, each lp
    exactly the plain logit less the kernel's lse, lse within 1e-5."""
    from mic_tpu_torch.ops.fused_head import _logits_q8
    from mic_tpu_torch.ops.quant import quantize_rows_dynamic

    hidden, wq, ws, bias = args[:4]
    (lp, ids, lse), (rlp, rids, rlse) = out, ref
    require(torch.equal(ids, rids), "fused_head_topk_q8: ids differ from plain on the path")
    logits = _logits_q8(*quantize_rows_dynamic(hidden), wq, ws, bias)
    require(torch.equal(lp, logits.gather(1, ids.long()) - lse),
            "fused_head_topk_q8: a candidate's logit differs from plain on the path")
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=0)
    return (lp - rlp).abs().max().item(), 0


def _wide_swaps(dtype, la, ca, lg, attention_mod):
    """``_f32_step_swaps`` with the bf16 tolerances on a bf16 model: rows 1
    and 2 within 2e-2 (``_check_attention``, the written cells bit-equal),
    row 15 within phase 25's bound, row 16 within 1e-2 of its largest
    output (phase 26's)."""
    swaps = _f32_step_swaps(la, ca, lg, attention_mod)
    if dtype == "float32":
        return swaps

    def ln_check(args, out, ref):
        x, scale, shift, w, bias = args[:5]
        terms = (ref.float() - bias.float()).abs() + bias.float().abs()
        l1 = torch.nn.functional.layer_norm(x.float(), (x.shape[1],), scale.float(),
                                            shift.float()).abs() @ w.float().abs()
        diff = (out.float() - ref.float()).abs()
        require(bool((diff <= 2 * _bf16_ulp(terms.bfloat16()) + 2.0**-8 * l1).all()),
                "ln_gemm on the path: an output beyond phase 25's bound")
        return diff.max().item(), 0

    def mlp_check(args, out, ref):
        err = (out.float() - ref.float()).abs().max().item()
        require(err <= 1e-2 * ref.float().abs().max().item(),
                "fused_mlp on the path: beyond 1e-2 of its largest output")
        return err, 0

    for name, check in (("lazy_attention", _check_attention),
                        ("lazy_attention_q8", _check_attention), ("ln_gemm", ln_check),
                        ("fused_mlp", mlp_check)):
        module, attr, plain, written, _ = swaps[name]
        swaps[name] = (module, attr, plain, written, check)
    return swaps


def run_wide_beam_paths(dev):
    """Phase 70: wide beam search at full width.  The flagship
    (CaptionerConfig.clip_vit_b32_mbart50(): D=1024, 12 layers, V=250054)
    in bf16 and in float32, random weights from a seed, B=64 images,
    max_length 64, every caption's EOS pinned at 63 (all 63 steps), under
    each path of WIDE_PATHS at 16 beams (and the fused step at 12).  For
    each: a first run with every launch of the path's kernels held against
    its plain version on the same inputs (``shadowed``: attention rows
    within 2e-2, rows 1 and 2 f32 within 1e-5, rows 15 and 16 within their
    phases' bounds, the heads within phase 69's tolerances, row 17 with ids
    equal and lp within 1e-5); the counters set to 0 just before a second
    generate and read just after, each attention row 12 times a step and
    each head once a step but at forced tokens, no other serving kernel,
    its sequences and scores bit-equal to the first run's; then the same
    generate with every one of the path's kernels swapped for its plain
    version on the card: every image whose running beams part from the
    plain run's parts at a near-tie (each run's K-th less (K+1)-th
    candidate at most BEAM_TIE plus how far the two runs' kept scores were
    apart a step before, that drift at most WIDE_DRIFT;
    ``_first_partings``, margins printed), and on the float32 model's
    float32 cache at least WIDE_EQUAL of 64 captions equal (else the count
    printed).  The paths of WIDE_HEAD_ALONE run once more with their head
    alone on its plain version, the captions equal to the kernels' run
    printed ->
    launches by kernels-line name (a name's largest count over the paths)."""
    import mic_tpu_torch.generate.search as search_mod
    import mic_tpu_torch.models.captioner as captioner_mod
    import mic_tpu_torch.nn.attention as attention_mod
    import mic_tpu_torch.ops.cross_attention as ca
    import mic_tpu_torch.ops.lazy_attention as la
    import mic_tpu_torch.ops.ln_gemm as lg
    from mic_tpu_torch.core.config import CaptionerConfig
    from mic_tpu_torch.core.params import make_serving_params
    from mic_tpu_torch.models.captioner import Captioner, init_params
    from mic_tpu_torch.ops.fused_head import fused_head_topk_plain, fused_head_topk_q8_plain
    from mic_tpu_torch.ops.image_prep import preprocess_images
    from mic_tpu_torch.ops.topk_lse import topk_log_probs_plain

    n, length = WIDE_B, 64
    u8 = np.random.default_rng(70).integers(0, 256, (n, 256, 256, 3), dtype=np.uint8)
    eos = torch.full((n,), length - 1, device=dev)
    heads = {"topk_log_probs": (search_mod, "topk_log_probs", topk_log_probs_plain, None,
                                _check_topk),
             "q8": (captioner_mod, "fused_head_topk_q8", fused_head_topk_q8_plain, None,
                    _check_path_head_q8),
             "bf16": (captioner_mod, "fused_head_topk", fused_head_topk_plain, None,
                      _check_path_head)}
    launches = {}
    for dtype in ("bfloat16", "float32"):
        config = CaptionerConfig.clip_vit_b32_mbart50(dtype=dtype)
        torch_dtype = getattr(torch, dtype)
        params = make_serving_params(
            init_params(config, torch.Generator(device=dev).manual_seed(70), dev), torch_dtype)
        model = Captioner(config)
        layers = config.decoder.num_layers
        px = preprocess_images(torch.from_numpy(u8).to(dev), config.vision.image_size,
                               torch_dtype)
        swaps = _wide_swaps(dtype, la, ca, lg, attention_mod)
        for label, (path_dtype, env, extra, beams, rows) in WIDE_PATHS.items():
            if path_dtype != dtype:
                continue
            kw = dict(extra, num_beams=beams, max_length=length,
                      forced_bos_token_id=FLAGSHIP_BOS, eos_positions=eos)
            head = heads["topk_log_probs" if "topk_log_probs" in rows else
                         "q8" if extra.get("quantize") else "bf16"]
            held = [swaps[c] for c in rows if c in swaps] + [head]
            # the plain versions take the wrappers' positional arguments
            plain = [(m, a, lambda *args, _p=p, **_: _p(*args)) for m, a, p, _, _ in held]
            with knobs(**env):
                with shadowed(*held) as stats:  # also the warm-up
                    first = model.generate(params, px, **kw)
                _print_shadow(f"phase 70, {label}", stats)
                with _beam_trace(beams) as trace:
                    out, counts, seconds = generate_counted(
                        lambda x: model.generate(params, x, **kw), px)
                _require_rerun_identical(f"phase 70, {label}", first, out)
                del first
                seqs = check_path_output(out, n, length, f"{label}, {beams} beams")
                check_pinned(seqs, eos.cpu(), config.decoder.eos_token_id,
                             config.decoder.pad_token_id, f"{label}, {beams} beams")
                found = {c: counts.pop(c) for c in rows}
                for c, count in found.items():
                    # the heads: every step but the forced ones (BOS, and
                    # mBART's forced EOS at the last position)
                    ok = (count == layers * out.steps if c in ATTENTION_ROWS
                          else out.steps - 2 <= count <= out.steps)
                    require(ok, f"{label}: {c} launched {count} times in {out.steps} steps")
                others = {k: v for k, v in counts.items() if v}
                require(not others, f"{label}: other serving kernels launched: {others}")
                for c, count in found.items():
                    launches[rows[c]] = max(launches.get(rows[c], 0), count)
                with plain_versions(*plain), _beam_trace(beams) as plain_trace:
                    ref = model.generate(params, px, **kw)
                if label in WIDE_HEAD_ALONE:
                    with plain_versions(plain[-1]):
                        alone = model.generate(params, px, **kw).sequences.cpu()
            torch.cuda.synchronize()
            equal = (seqs == ref.sequences.cpu()).all(1)
            partings = _first_partings(plain_trace, trace, n, beams)
            del trace, plain_trace
            print(f"phase 70, {label}: {dtype} flagship, B={n} beam {beams}, {out.steps} steps "
                  f"in {seconds:.3f} s (smoke figure, not a benchmark), launches "
                  f"{ {rows[c]: v for c, v in found.items()} }; against the same generate on "
                  f"the plain versions: {int(equal.sum())} of {n} captions equal; where "
                  f"running beams first part (image, step, plain's K-th less (K+1)-th, the "
                  f"kernels', kept-score difference a step before): "
                  f"{[(i, st, round(a, 5), round(b, 5), round(d, 5)) for i, st, a, b, d in partings]}"
                  f" (limit {BEAM_TIE} plus that difference, itself at most {WIDE_DRIFT})",
                  flush=True)
            require(dtype == "bfloat16" or kw.get("kv_quant") or int(equal.sum()) >= WIDE_EQUAL,
                    f"{label}: fewer than {WIDE_EQUAL} captions equal to the plain versions'")
            require(all(d <= WIDE_DRIFT and a <= BEAM_TIE + d and b <= BEAM_TIE + d
                        for _, _, a, b, d in partings),
                    f"{label}: beams part from the plain versions' where no near-tie is")
            if label in WIDE_HEAD_ALONE:
                kept = int((seqs == alone).all(1).sum())
                print(f"phase 70, {label}, its head alone on its plain version: {kept} of {n} "
                      "captions equal to the kernels' run", flush=True)
        del params, model, px
        torch.cuda.empty_cache()
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from mic_tpu_torch import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: {lib_path}",
          flush=True)
    marks = [t0]

    def took(phases: str) -> None:
        """The host seconds a group of phases took, and the run's so far."""
        now = time.perf_counter()
        print(f"phases {phases} took {now - marks[-1]:.1f} s ({now - t0:.1f} s since the "
              f"start)", flush=True)
        marks.append(now)

    took("1 (the build)")

    attn_err = check_lazy_attention(dev)
    head_err, head_ms, head_plain_ms = check_fused_head(dev)
    torch.cuda.empty_cache()
    flag = flagship(dev)
    launches = run_whole_path(dev, flag)
    torch.cuda.empty_cache()
    check_small_against_cpu(dev)
    weight, bias = _ce_table(dev)
    fwd_err = check_flash_ce_forward(dev, weight, bias)
    dl_err = check_flash_ce_dl(dev, weight, bias)
    ce_ms = time_flash_ce(dev, weight, bias)
    del weight, bias
    torch.cuda.empty_cache()
    launches.update(run_training(dev))
    torch.cuda.empty_cache()
    check_training_small_against_cpu(dev)
    took("2-11")

    table = _head_table(dev)
    q8_bucket_err = check_fused_head_q8_bucket(dev, table)
    select_bf16_err, select_q8_err = check_fused_head_select(dev, table)
    torch.cuda.empty_cache()
    attn_q8_err = check_lazy_attention_q8(dev)
    q8_ms = time_int8_kernels(dev, table)
    del table
    torch.cuda.empty_cache()
    launches.update(run_int8_path(dev, flag))
    torch.cuda.empty_cache()
    check_int8_small_against_cpu(dev)
    took("12-17")

    decode_err, decode_inputs = check_decode_attention(dev)
    topk_err = check_topk_lse(dev)
    greedy_ms = time_greedy_kernels(dev, decode_inputs)
    del decode_inputs
    torch.cuda.empty_cache()
    launches.update(run_greedy_path(dev, flag))
    torch.cuda.empty_cache()
    check_greedy_small_against_cpu(dev)
    took("18-22")

    blocked_err, blocked_inputs = check_blocked_attention(dev)
    cross_err, cross_inputs = check_cross_attention(dev)
    ln_err, ln_inputs = check_ln_gemm(dev)
    mlp_err, mlp_inputs = check_fused_mlp(dev)
    step_ms, live_rows = time_fused_step_kernels(dev, blocked_inputs, cross_inputs, ln_inputs,
                                                 mlp_inputs)
    print(f"fused_lazy_attention timed inputs: {live_rows[False]} (bf16) and {live_rows[True]} "
          f"(int8) of {FLAG_B * FLAG_K * 63} cached rows admitted by some beam", flush=True)
    del blocked_inputs, cross_inputs, ln_inputs, mlp_inputs
    torch.cuda.empty_cache()
    launches.update(run_fused_step_path(dev, flag))
    torch.cuda.empty_cache()
    check_fused_step_small_against_cpu(dev)
    took("23-29")

    weight, bias = _ce_table(dev)
    save_fwd_err = check_flash_ce_save_forward(dev, weight, bias)
    bwd_err = check_flash_ce_backward_routes(dev, weight, bias)
    route_ms = time_flash_ce_routes(dev, weight, bias)
    del weight, bias
    torch.cuda.empty_cache()
    launches.update(run_training_routes(dev))
    check_training_small_against_cpu(dev, ("fwd", "split", "save"))
    took("30-34")

    tf_err = check_attention_kernels(dev)
    tf_ms = time_attention_kernels(dev)
    torch.cuda.empty_cache()
    tf32_err, tf32_ms = check_f32_attention_kernels(dev)
    tf_ms.update(tf32_ms)
    torch.cuda.empty_cache()
    launches.update(run_pallas_path(dev, flag))
    torch.cuda.empty_cache()
    check_attention_small_against_cpu(dev)
    took("35-38")

    dma_err, dma_inputs = check_cross_attention_dma(dev)
    cross_q8_err, cross_q8_inputs = check_cross_attention_q8(dev)
    permute_err, permute_inputs = check_beam_permute(dev)
    mm_err, mm_inputs = check_int8_matmul(dev)
    torch.cuda.empty_cache()
    last_ms = time_last_kernels(dev, dma_inputs, cross_q8_inputs, permute_inputs, mm_inputs)
    del dma_inputs, cross_q8_inputs, permute_inputs, mm_inputs
    torch.cuda.empty_cache()
    launches.update(run_merged_cross_path(dev, flag))
    torch.cuda.empty_cache()
    launches.update(run_physical_path(dev, flag))
    del flag
    torch.cuda.empty_cache()
    check_last_paths_small_against_cpu(dev)
    check_twelve_beams_small_against_cpu(dev)
    check_bucket_slot_release(dev, lib_path)
    time_sdpa_backward(tf_ms)
    torch.cuda.empty_cache()
    took("39-48")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_checkpoints_") as root:
        run_checkpoint_path(dev, root)
        check_checkpoint_across_devices(dev, root)
    torch.cuda.empty_cache()
    took("49")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trained_") as root:
        run_trained_model_path(dev, root)
    torch.cuda.empty_cache()
    took("50")
    f32_err, f32_ms = check_f32_kernels(dev)
    torch.cuda.empty_cache()
    f32_runs = [run_f32_generate(dev)]  # the float32 main paths' launches
    torch.cuda.empty_cache()
    f32_runs.append(run_f32_training(dev))
    torch.cuda.empty_cache()
    for run in f32_runs:
        launches.update(run)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_options_") as root:
        run_training_options(dev, root)
    torch.cuda.empty_cache()
    took("51-54")
    run_vit_bart_path(dev)
    torch.cuda.empty_cache()
    run_translator_path(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hf_") as root:
        run_hf_format_path(dev, root)
    torch.cuda.empty_cache()
    took("55-57")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_async_") as root:
        run_async_save(dev, root)
    torch.cuda.empty_cache()
    run_lazy_chain_path(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as root:
        run_two_ranks(dev, root)
    torch.cuda.empty_cache()
    took("58-60")
    family_ce = check_family_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_family_") as root:
        family_launches = run_family_training(dev, root)
    torch.cuda.empty_cache()
    untied_launches, (copy_ms, copy_bound) = run_untied_training(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_translate_") as root:
        translate_launches = run_translate_tool(dev, root)
    torch.cuda.empty_cache()
    took("61-63")
    f32_step_err, f32_step_ms, f32_live = check_f32_step_kernels(dev)
    torch.cuda.empty_cache()
    f32_step_launches = run_f32_fused_paths(dev)
    f32_runs.append(f32_step_launches)
    torch.cuda.empty_cache()
    took("64-65")
    mlp32_err, mlp32_ms = check_f32_mlp(dev)
    ce32_err, ce32_ms = check_f32_ce_routes(dev)
    torch.cuda.empty_cache()
    whole_step_launches = run_f32_fused_paths(dev, F32_WHOLE_STEP)
    torch.cuda.empty_cache()
    ce32_launches = run_f32_training_routes(dev)
    f32_runs += [whole_step_launches, ce32_launches]
    torch.cuda.empty_cache()
    took("66-68")
    wide_attn_err = check_wide_attention(dev)
    table = _head_table(dev)
    wide_head_err = check_wide_heads(dev, table)
    wide_ms, wide_bounds = time_wide_instances(dev, table)
    del table
    torch.cuda.empty_cache()
    took("69")
    wide_launches = run_wide_beam_paths(dev)
    torch.cuda.empty_cache()
    took("70")

    print(card_name_and_limit(), flush=True)
    # each bound at the shape its time was taken at (flagship widths)
    n_beam, n_ce = 256 * 4, 4096
    dec_b, dec_t, dec_h = ATTN_SHAPES["decoder"]
    bounds = {
        "lazy_attention": attention_bound(n_beam, 63, HEAD_D, 2, ancestry=True),
        "fused_head_bucket": head_bound(1024, HEAD_D, HEAD_V, 9, 2, "bf16"),
        **flash_ce_bounds(n_ce),
        "fused_head_bucket_q8": head_bound(1024, HEAD_D, HEAD_V, 9, 1, "bf16", scales=True),
        "fused_head_select": head_bound(1024, HEAD_D, HEAD_V, 9, 1, "int8", scales=True),
        "fused_head_select_bf16": head_bound(1024, HEAD_D, HEAD_V, 9, 2, "bf16"),
        "lazy_attention_q8": attention_bound(n_beam, 63, HEAD_D, 1, scale_bytes=4, ancestry=True),
        "decode_attention": attention_bound(256, 63, HEAD_D, 2),
        "topk_log_probs": topk_bound(1024, HEAD_V, 9, 2),
        "fused_lazy_attention": blocked_attention_bound(live_rows[False], FLAG_B, FLAG_K, 63,
                                                        HEAD_D, FLAG_H, 2),
        "fused_cross_attention": cross_bound(FLAG_B, FLAG_K, FLAG_S, HEAD_D),
        "ln_gemm": ln_gemm_bound(1024, HEAD_D, 3 * HEAD_D),
        "fused_mlp": mlp_bound(1024, HEAD_D, 4 * HEAD_D),
        **flash_ce_route_bounds(n_ce),
        **attention_bounds(dec_b, dec_t, dec_t, dec_h),
        # row 13 on the live rows: the kernel reads no pad row
        "fused_cross_attention_dma": cross_bound(FLAG_B, FLAG_K, FLAG_S, HEAD_D),
        "fused_cross_attention_q8": q8_cross_bound(FLAG_B, FLAG_K, FLAG_S, HEAD_D, FLAG_H),
        "beam_permute": bound(2 * 2 * int(np.prod(PERMUTE_SHAPE)), 0, "bf16"),
        "int8_matmul": int8_matmul_bound(1024, 1024, 3072),
        **f32_bounds(n_beam, 1024, n_ce),
        **f32_step_bounds(f32_live),
        "fused_mlp_f32": mlp_f32_bound(FLAG_B * FLAG_K, HEAD_D, 4 * HEAD_D),
        **f32_ce_route_bounds(n_ce),
        **attention_bounds_f32(dec_b, dec_t, dec_t, dec_h),
    }
    others = {"fused_head N=4": head_bound(4, HEAD_D, HEAD_V, 9, 2, "bf16"),
              "decode_attention N=4": attention_bound(4, 63, HEAD_D, 2),
              "fused_head_bucket_q8 N=4": head_bound(4, HEAD_D, HEAD_V, 9, 1, "bf16", scales=True),
              "fused_head_select int8 N=4": head_bound(4, HEAD_D, HEAD_V, 9, 1, "int8",
                                                      scales=True),
              "fused_head_select bf16 N=4": head_bound(4, HEAD_D, HEAD_V, 9, 2, "bf16"),
              **{f"topk_log_probs N={n} k={k}": topk_bound(n, HEAD_V, k, 2)
                 for n, k in ((4, 2), (256, 2), (256, 9), (1024, 2))},
              "fused_lazy_attention int8 per-head": blocked_attention_bound(
                  live_rows[True], FLAG_B, FLAG_K, 63, HEAD_D, FLAG_H, 1, scale_bytes=4),
              "ln_gemm N=32": ln_gemm_bound(32, HEAD_D, 3 * HEAD_D),
              **{f"int8_matmul M={m} N={n}": int8_matmul_bound(m, 1024, n)
                 for m, n in ((4, 3072), (4, HEAD_V), (1024, HEAD_V))},
              "fused_mlp N=32": mlp_bound(32, HEAD_D, 4 * HEAD_D),
              "fused_mlp_f32 N=32": mlp_f32_bound(32, HEAD_D, 4 * HEAD_D),
              "fused_head_bucket_f32 N=4": f32_bounds(n_beam, 4, n_ce)["fused_head_bucket_f32"],
              "fused_head_select_f32 N=4": f32_bounds(n_beam, 4, n_ce)["fused_head_select_f32"],
              # phases 55 and 56: BART-large's head, the translator's self plane
              "fused_head_bucket N=256 V=50265": head_bound(256, HEAD_D, 50265, 9, 2, "bf16"),
              "beam_permute (12, 256, 64, 16, 64)": bound(2 * 2 * 12 * TR_B * 4 * 64 * 16 * 64,
                                                          0, "bf16")}
    others.update(flash_ce_contraction_bounds(n_ce))
    vis_b, vis_t, vis_h = ATTN_SHAPES["vision"]
    others.update({f"{name} vision": value for name, value in
                   attention_bounds(vis_b, vis_t, vis_t, vis_h).items()})
    others.update({f"{name} vision": value for name, value in
                   attention_bounds_f32(vis_b, vis_t, vis_t, vis_h).items()})
    long_b, long_t, long_h = FLASH_LONG
    others["flash_attention T=600"] = attention_bounds(long_b, long_t, long_t,
                                                       long_h)["flash_attention"]
    # phases 61-63: the instances of rows 4, 7 and 8 this slice trains on
    # and the translator tool's row 19, by instance
    print("phases 61-63, the instances (errors against plain, kernel ms, plain ms, bound ms): "
          + ", ".join(f"{name} V={FAMILY_V} max_abs_err {err:.3g}, {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({by})"
                      for name, (err, k_ms, p_ms, (b_ms, by)) in family_ce.items())
          + f"; lm_head's (V, D) copy {copy_ms:.4f} ms, bound {copy_bound[0]:.4f} ms "
          f"({copy_bound[1]}); launches on the main paths {family_launches}, "
          f"{untied_launches}, beam_permute in the translate tool {translate_launches}",
          flush=True)
    print("bounds at the other timed shapes: " + ", ".join(
        f"{name} {ms:.4f} ms ({by})" for name, (ms, by) in others.items()), flush=True)
    kernels = [
        dict(name="lazy_attention", source="mic_tpu_torch/csrc/lazy_attention.cu",
             replaces="mic_tpu/ops/lazy_attention.py:668", max_abs_err=attn_err,
             ms=q8_ms["lazy", False, 63][0], plain_ms=q8_ms["lazy", False, 63][1]),
        dict(name="fused_head_bucket", source="mic_tpu_torch/csrc/fused_head.cu",
             replaces="mic_tpu/ops/fused_head.py:608", max_abs_err=head_err,
             ms=head_ms, plain_ms=head_plain_ms, launches=launches["fused_head"]),
        dict(name="flash_ce_forward", source="mic_tpu_torch/csrc/flash_ce.cu",
             replaces="mic_tpu/ops/flash_ce.py:259", max_abs_err=fwd_err,
             ms=ce_ms["fwd"], plain_ms=ce_ms["fwd_plain"]),
        dict(name="flash_ce_backward_dl", source="mic_tpu_torch/csrc/flash_ce.cu",
             replaces="mic_tpu/ops/flash_ce.py:725", max_abs_err=dl_err,
             ms=ce_ms["dl"], plain_ms=ce_ms["dl_plain"]),
        dict(name="fused_head_bucket_q8", source="mic_tpu_torch/csrc/fused_head.cu",
             replaces="mic_tpu/ops/fused_head.py:461", max_abs_err=q8_bucket_err,
             ms=q8_ms[("bucket_q8", 1024)][0], plain_ms=q8_ms[("bucket_q8", 1024)][1]),
        dict(name="fused_head_select", source="mic_tpu_torch/csrc/fused_head.cu",
             replaces="mic_tpu/ops/fused_head.py:346", max_abs_err=select_q8_err,
             ms=q8_ms[("exact_q8", 1024)][0], plain_ms=q8_ms[("exact_q8", 1024)][1]),
        dict(name="fused_head_select_bf16", source="mic_tpu_torch/csrc/fused_head.cu",
             replaces="mic_tpu/ops/fused_head.py:290", max_abs_err=select_bf16_err,
             ms=q8_ms[("exact_bf16", 1024)][0], plain_ms=q8_ms[("exact_bf16", 1024)][1]),
        dict(name="lazy_attention_q8", source="mic_tpu_torch/csrc/lazy_attention.cu",
             replaces="mic_tpu/ops/lazy_attention.py:560", max_abs_err=attn_q8_err,
             ms=q8_ms["lazy", True, 63][0], plain_ms=q8_ms["lazy", True, 63][1]),
        dict(name="decode_attention", source="mic_tpu_torch/csrc/decode_attention.cu",
             replaces="mic_tpu/ops/decode_attention.py:157", max_abs_err=decode_err,
             ms=greedy_ms["decode"][0], plain_ms=greedy_ms["decode"][1],
             library_ms=greedy_ms["decode"][2]),
        dict(name="topk_log_probs", source="mic_tpu_torch/csrc/topk_lse.cu",
             replaces="mic_tpu/ops/topk_lse.py:94", max_abs_err=topk_err,
             ms=greedy_ms[("topk", 1024, 9)][0], plain_ms=greedy_ms[("topk", 1024, 9)][1]),
        dict(name="fused_lazy_attention", source="mic_tpu_torch/csrc/lazy_attention.cu",
             replaces="mic_tpu/ops/lazy_attention.py:257", max_abs_err=blocked_err,
             ms=step_ms[("attn", False)][0], plain_ms=step_ms[("attn", False)][1]),
        dict(name="fused_cross_attention", source="mic_tpu_torch/csrc/cross_attention.cu",
             replaces="mic_tpu/ops/cross_attention.py:237", max_abs_err=cross_err,
             ms=step_ms["cross"][0], plain_ms=step_ms["cross"][1],
             library_ms=step_ms["cross"][2]),
        # no one PyTorch call computes LN -> GEMM or the MLP: their chains
        # of calls are printed in phase 27 for scale, not as library_ms
        dict(name="ln_gemm", source="mic_tpu_torch/csrc/ln_gemm.cu",
             replaces="mic_tpu/ops/ln_gemm.py:49", max_abs_err=ln_err,
             ms=step_ms[("ln", 1024)][0], plain_ms=step_ms[("ln", 1024)][1]),
        dict(name="fused_mlp", source="mic_tpu_torch/csrc/fused_mlp.cu",
             replaces="mic_tpu/ops/fused_mlp.py:89", max_abs_err=mlp_err,
             ms=step_ms[("mlp", 1024)][0], plain_ms=step_ms[("mlp", 1024)][1]),
        dict(name="flash_ce_forward_save", source="mic_tpu_torch/csrc/flash_ce.cu",
             replaces="mic_tpu/ops/flash_ce.py:157", max_abs_err=save_fwd_err,
             ms=route_ms["fwd_save"], plain_ms=route_ms["fwd_save_plain"]),
        dict(name="flash_ce_backward_save", source="mic_tpu_torch/csrc/flash_ce.cu",
             replaces="mic_tpu/ops/flash_ce.py:579", max_abs_err=bwd_err["flash_ce_backward_save"],
             ms=route_ms["save"], plain_ms=route_ms["save_plain"]),
        dict(name="flash_ce_backward", source="mic_tpu_torch/csrc/flash_ce.cu",
             replaces="mic_tpu/ops/flash_ce.py:407", max_abs_err=bwd_err["flash_ce_backward"],
             ms=route_ms["split"], plain_ms=route_ms["split_plain"]),
        dict(name="flash_attention", source="mic_tpu_torch/csrc/flash_attention.cu",
             replaces="mic_tpu/ops/flash_attention.py:167", max_abs_err=tf_err["flash_attention"],
             ms=tf_ms[("flash", "decoder")][0], plain_ms=tf_ms[("flash", "decoder")][1],
             library_ms=tf_ms[("flash", "decoder")][2]),
        dict(name="small_attention_forward", source="mic_tpu_torch/csrc/small_attention.cu",
             replaces="mic_tpu/ops/small_attention.py:96",
             max_abs_err=tf_err["small_attention_forward"],
             ms=tf_ms[("small_fwd", "decoder")][0], plain_ms=tf_ms[("small_fwd", "decoder")][1],
             library_ms=tf_ms[("small_fwd", "decoder")][2]),
        dict(name="small_attention_backward", source="mic_tpu_torch/csrc/small_attention.cu",
             replaces="mic_tpu/ops/small_attention.py:111",
             max_abs_err=tf_err["small_attention_backward"],
             ms=tf_ms[("small_bwd", "decoder")][0], plain_ms=tf_ms[("small_bwd", "decoder")][1],
             library_ms=tf_ms[("small_bwd", "decoder")][2]),
        dict(name="fused_cross_attention_dma", source="mic_tpu_torch/csrc/cross_attention.cu",
             replaces="mic_tpu/ops/cross_attention.py:183", max_abs_err=dma_err,
             ms=last_ms["dma"][0], plain_ms=last_ms["dma"][1], library_ms=last_ms["dma"][2]),
        # no path of mic_tpu or of the port builds an int8 cross cache: its
        # launch count on the main paths is 0, and no one PyTorch call
        # computes the function
        dict(name="fused_cross_attention_q8", source="mic_tpu_torch/csrc/cross_attention.cu",
             replaces="mic_tpu/ops/cross_attention.py:79", max_abs_err=cross_q8_err,
             ms=last_ms["q8"][0], plain_ms=last_ms["q8"][1]),
        dict(name="beam_permute", source="mic_tpu_torch/csrc/beam_permute.cu",
             replaces="mic_tpu/ops/beam_permute.py:97", max_abs_err=permute_err,
             ms=last_ms["permute"][0], plain_ms=last_ms["permute"][1],
             library_ms=last_ms["permute"][2]),
        # mic_tpu keeps it as a reference with no caller; nor has the port
        dict(name="int8_matmul", source="mic_tpu_torch/csrc/int8_matmul.cu",
             replaces="mic_tpu/ops/int8_matmul.py:31", max_abs_err=mm_err,
             ms=last_ms[("mm", 1024, 3072)][0], plain_ms=last_ms[("mm", 1024, 3072)][1]),
    ]
    # the float32 instances of rows 1, 4, 5, 7 and 8 (phases 51-53; row 5's
    # exact select's time and launches); no one PyTorch call computes these
    # functions (cuBLAS's bare f32 product is printed in phase 51 for scale,
    # not as library_ms)
    kernels += [
        dict(name=name, source=f"mic_tpu_torch/csrc/{source}", replaces=replaces,
             max_abs_err=f32_err[name], ms=f32_ms[name][0], plain_ms=f32_ms[name][1])
        for name, source, replaces in (
            ("lazy_attention_f32", "lazy_attention.cu", "mic_tpu/ops/lazy_attention.py:668"),
            ("fused_head_bucket_f32", "fused_head_f32.cu", "mic_tpu/ops/fused_head.py:608"),
            ("fused_head_select_f32", "fused_head.cu", "mic_tpu/ops/fused_head.py:290"),
            ("flash_ce_forward_f32", "flash_ce_f32.cu", "mic_tpu/ops/flash_ce.py:259"),
            ("flash_ce_backward_dl_f32", "flash_ce_f32.cu", "mic_tpu/ops/flash_ce.py:725"))
    ]
    # the float32 instances of rows 2, 3, 13, 14 and 15 (phases 64-65): SDPA
    # in float32 computes rows 13's and 14's function; row 14's int8 form
    # has no caller (its count read over phase 65's paths)
    kernels += [
        dict(name=name, source=f"mic_tpu_torch/csrc/{source}", replaces=replaces,
             max_abs_err=f32_step_err[name], ms=f32_step_ms[name][0],
             plain_ms=f32_step_ms[name][1], library_ms=f32_step_ms[name][2],
             launches=f32_step_launches[name])
        for name, (source, replaces) in F32_STEP_ROWS.items()
    ]
    # rows 16, 9 and 10 in float32 (phases 66-68); no one PyTorch call
    # computes these functions (row 16's F.linear -> F.gelu -> F.linear
    # chain is printed in phase 66 for scale, not as library_ms)
    f32_last = {**ce32_launches, **whole_step_launches}
    kernels += [
        dict(name=name, source=f"mic_tpu_torch/csrc/{source}", replaces=replaces,
             max_abs_err=mlp32_err if name == "fused_mlp_f32" else ce32_err[name],
             ms=(mlp32_ms[FLAG_B * FLAG_K] if name == "fused_mlp_f32" else ce32_ms[name])[0],
             plain_ms=(mlp32_ms[FLAG_B * FLAG_K] if name == "fused_mlp_f32"
                       else ce32_ms[name])[1],
             launches=f32_last[name])
        for name, (source, replaces) in F32_LAST_ROWS.items()
    ]
    # rows 11 and 12 in float32 (phase 35, at the decoder's shape), their
    # launches read over the float32 main paths (phases 52, 53, 65, 67,
    # 68), none of which sets small_attn or attn_impl="pallas"; SDPA in
    # float32 computes their functions
    kernels += [
        dict(name=name, source=f"mic_tpu_torch/csrc/{source}", replaces=replaces,
             max_abs_err=tf32_err[name], ms=tf_ms[(key, "decoder")][0],
             plain_ms=tf_ms[(key, "decoder")][1], library_ms=tf_ms[(key, "decoder")][2],
             launches=sum(run[name] for run in f32_runs))
        for name, (source, replaces, key) in F32_ATTENTION_ROWS.items()
    ]
    # the wide instances of rows 3, 3 f32, 5, 5 f32, 6 and 17 (phases
    # 69-70): times at 16 beams and k=37, launches over phase 70's paths
    wide_err = {**{name: wide_attn_err[form] for form, name in (
        ("bf16", "fused_lazy_attention_wide"), ("int8", "fused_lazy_attention_q8_wide"),
        ("f32", "fused_lazy_attention_f32_wide"),
        ("int8 f32 q", "fused_lazy_attention_q8_f32_wide"))},
        "fused_head_select_bf16_wide": wide_head_err["fused_head_select_bf16"],
        "fused_head_select_wide": wide_head_err["fused_head_select"],
        "fused_head_select_f32_wide": wide_head_err["fused_head_select_f32"],
        "topk_log_probs_wide": wide_head_err["topk_log_probs"]}
    bounds.update(wide_bounds)
    kernels += [
        dict(name=name, source=f"mic_tpu_torch/csrc/{source}", replaces=replaces,
             max_abs_err=wide_err[name], ms=wide_ms[name][0], plain_ms=wide_ms[name][1],
             library_ms=wide_ms[name][2], launches=wide_launches[name])
        for name, (source, replaces) in WIDE_ROWS.items()
    ]
    for k in kernels:
        k["route"] = "cuda"
        if "launches" not in k:
            k["launches"] = launches[k["name"]]
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        # the one PyTorch call computing the same function, where there is one
        k.setdefault("library_ms", None)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1,  # the cards this run uses
    }}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--cards":
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke.py needs CUDA devices; torch.cuda.is_available() is "
                             "false")
        run_cards(int(sys.argv[2]))
    else:
        main()

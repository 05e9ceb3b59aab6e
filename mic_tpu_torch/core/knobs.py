"""Central resolution point for every runtime tuning knob.

SURVEY §5 prescribes ONE typed config tree as the framework's flag surface
(the reference scattered its flags over three dataclasses plus HF
``TrainingArguments``, main.py:61-163).  Tuning knobs therefore live in the
config — ``DecodeConfig`` for the serving path, ``TrainConfig`` for the
training path — and environment variables are explicit per-knob OVERRIDES
for deployment A/Bs, resolved HERE and nowhere else: ``override()`` is the
package's single ``os.environ`` read for supported knobs, and every
config field that accepts an override names its variable in its docstring.

Measured-dead-end code paths (kept in-tree as documented reference
implementations — the numbers live in PERFORMANCE.md "measured dead ends")
are NOT part of the supported surface: they all hang off the single
``MIC_TPU_EXPERIMENTAL`` registry below, with typo detection, so the
combination space of defaults is exactly what the config expresses.

    MIC_TPU_EXPERIMENTAL="fused_mlp,segmented_topk=8192" python bench.py

The port's own copy of mic_tpu/core/knobs.py: the same ``override`` and the same
``MIC_TPU_EXPERIMENTAL`` registry, so every variable keeps its name and
meaning in both packages.

Where the port reads a switch: the lazy beam step (models/mbart_decoder.py)
reads MIC_TPU_FUSED_LAZY_ATTN ("0", mic_tpu's XLA chain; "1"; "2"),
fused_cross_attn, fused_mlp and ln_qkv, and in the chain attn_buckets; the greedy step fused_decode; the dense candidate select pallas_topk
(generate/search.py::_topk_mode says why approx_topk and segmented_topk take
the exact select); ``Captioner.generate`` merged_kv and merged_cross
(ported: the lazy path's merged, padded cross cache and
ops/cross_attention.py::fused_cross_attention_dma; the physical cache
ignores it, as in mic_tpu); the bucket select of ops/fused_head.py bucket_bv
(the bucket width, which changes the candidates; its kernel takes multiples
of 64 and raises NotImplementedError for other widths); the full-sequence
attention of both towers (ops/attention.py::dot_product_attention)
small_attn, on CUDA tensors, as mic_tpu reads it on the TPU. Switches
that only tune TPU tiling, bucketing or the shape of the layer loop leave
every result the same and are accepted and ignored: cross_g (images per grid
cell of mic_tpu's two cross-attention kernels: it changes the TPU grid only
and gives the same bits), attn_buckets outside the chain (static read-prefix
buckets, bit-identical by construction), MIC_TPU_CACHE_SEGMENTS (phased cache growth,
bit-identical), MIC_TPU_DMA_G (images per DMA grid cell), and attn_bhtd,
custom_scan_vjp, unroll_layers and scan_split_transpose (the training
attention's operand layout and the layer scan's backward, which mic_tpu's
tests/test_stacked.py holds to the same results).
"""

from __future__ import annotations

import os


def override(env_var: str, default: "str | None" = None) -> "str | None":
    """The env override for a SUPPORTED knob.  The config field owns the
    default; a set variable wins (deployment-level A/B without editing
    configs).  Returns ``default`` when the variable is unset."""
    return os.environ.get(env_var, default)


# Registered experimental paths: measured dead ends and test levers.
# name -> one-line what/verdict; PERFORMANCE.md has the measurements.
EXPERIMENTAL: dict[str, str] = {
    "pallas_topk": "fused Pallas top-k+logsumexp candidate select "
                   "(ops/topk_lse.py); 12% slower than XLA's TopK",
    "segmented_topk": "=<seg> two-stage exact top-k over <seg>-wide "
                      "segments; 59.1 vs 88.5 captions/s/chip",
    "approx_topk": "force approx_max_k candidate select off-TPU (the CPU "
                   "lowering is exact top-k; test lever)",
    "fused_decode": "chunked-DMA decode-attention kernel "
                    "(ops/decode_attention.py); 14.1 vs 88.5",
    "attn_buckets": "=auto|<list> static cache-read prefix buckets in the "
                    "lazy decode attention; 166.8 vs 169.2",
    "fused_cross_attn": "Pallas cross-attention kernel "
                        "(ops/cross_attention.py); MXU-pipeline-bound at "
                        "enc_len 50",
    "merged_cross": "head-dims-merged, 16-padded cross cache + its cross "
                    "kernel (ops/cross_attention.py fused_cross_attention_dma)",
    "cross_g": "=<G> images per cross-attention grid cell (TPU grid only; "
               "accepted and ignored)",
    "fused_mlp": "Pallas fc1->gelu->fc2 decode kernel (ops/fused_mlp.py); "
                 "260.3 vs 268.9",
    "merged_kv": "force the merged (B*K, T, H*Dh) self-KV cache layout "
                 "(CPU equivalence-test lever; auto on the TPU kernel path)",
    "small_attn": "small-T training attention kernel "
                  "(ops/small_attention.py); 382 vs 398-400 samples/s/chip",
    "attn_bhtd": "pre-transposed (B, H, T, D) training attention operands; "
                 "exact wash (302.9 vs 303.3 ms/step)",
    "custom_scan_vjp": "hand-written backward-as-reverse-scan for the "
                       "layer stack (nn/stacked.py); profile-identical wash",
    "unroll_layers": "python-unrolled layer stack instead of lax.scan; "
                     "OOMs at the flagship batch (kept for small models)",
    "scan_split_transpose": "lax.scan _split_transpose backward; wash "
                            "(390.6 vs 389.2)",
    "bucket_bv": "=<BV> vocab-chunk width override inside the fused-head "
                 "bucket kernel (ops/fused_head.py)",
    "ln_qkv": "fold ln_self into the decode qkv GEMM's prologue "
              "(ops/ln_gemm.py) — VERDICT r5 measured shot",
}


def experimental(name: str, default: "str | None" = None) -> "str | None":
    """Value of an experimental-path toggle from ``MIC_TPU_EXPERIMENTAL``
    (comma list of ``name`` or ``name=value`` entries): the entry's value
    ("1" for bare names), or ``default`` when not listed.

    Unknown entries in the variable raise (typo detection — a silently
    ignored experiment name would invalidate an A/B); asking for an
    unregistered ``name`` is a programming error and also raises."""
    if name not in EXPERIMENTAL:
        raise KeyError(f"not a registered experimental path: {name!r}")
    raw = os.environ.get("MIC_TPU_EXPERIMENTAL", "")
    out = default
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        key, _, val = entry.partition("=")
        if key not in EXPERIMENTAL:
            raise KeyError(
                f"unknown MIC_TPU_EXPERIMENTAL entry {key!r}; known: "
                + ", ".join(sorted(EXPERIMENTAL))
            )
        if key == name:
            out = val or "1"
    return out

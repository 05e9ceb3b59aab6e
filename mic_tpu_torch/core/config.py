"""Typed configuration tree for the whole framework.

One dataclass tree covers model / generation / data / training, is JSON
(de)serializable, and can be overridden from the CLI with dotted flags
(``--model.decoder.num_layers=2``).  This replaces the reference's nested HF
``CLIPVisionMBartConfig`` + ``HfArgumentParser``-of-three-dataclasses setup
(reference: models/flax_clip_vision_mbart/configuration_clip_vision_mbart.py:10-51,
main.py:61-163) with a single self-contained config system.

``CaptionerConfig.from_hf_dict`` understands the published fused checkpoint's
``config.json`` layout (``clip_vision_config`` + ``mbart_config`` keys) so HF
checkpoints import cleanly.

The port's own copy of mic_tpu/core/config.py: the same classes, fields,
presets and JSON, without ``CaptionerConfig.compute_dtype`` (the port maps
``dtype`` with core/params.py::torch_dtype).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

# ---------------------------------------------------------------------------
# helpers


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(x) for x in obj]
    return obj


class _JsonMixin:
    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_dict(cls, d: dict):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d or d[f.name] is None:
                continue
            v = d[f.name]
            sub = _NESTED.get((cls.__name__, f.name))
            if sub is not None and isinstance(v, dict):
                v = sub.from_dict(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    @classmethod
    def from_json(cls, path: str):
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# model configs


@dataclasses.dataclass(frozen=True)
class VisionConfig(_JsonMixin):
    """CLIP-style pre-LN ViT vision tower (defaults = CLIP ViT-B/32)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    attention_dropout: float = 0.0
    # tower style knobs: CLIP defaults; a google/vit tower is
    # (use_pre_ln=False, final_ln_output=True, patch_bias=True, hidden_act="gelu")
    use_pre_ln: bool = True
    final_ln_output: bool = False
    patch_bias: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        # CLS token + patches; the encoder output the decoder cross-attends to.
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "VisionConfig":
        base = dict(
            hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
            image_size=32, patch_size=16,
        )
        base.update(kw)
        return cls(**base)


@dataclasses.dataclass(frozen=True)
class DecoderConfig(_JsonMixin):
    """mBART-style pre-norm decoder (defaults = mBART-large-50)."""

    vocab_size: int = 250054
    d_model: int = 1024
    ffn_dim: int = 4096
    num_layers: int = 12
    num_heads: int = 16
    max_position_embeddings: int = 1024
    scale_embedding: bool = True
    layer_norm_eps: float = 1e-5
    activation: str = "gelu"
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    init_std: float = 0.02
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    # mBART position embeddings are offset by 2 (positions 0,1 reserved).
    pos_offset: int = 2
    # norm style knobs: mBART defaults (pre-norm + final LN); a BART decoder
    # is (post_norm=True, use_final_ln=False)
    post_norm: bool = False
    use_final_ln: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "DecoderConfig":
        base = dict(
            vocab_size=99, d_model=32, ffn_dim=64, num_layers=2, num_heads=4,
            max_position_embeddings=64, dropout=0.0,
        )
        base.update(kw)
        return cls(**base)


@dataclasses.dataclass(frozen=True)
class GenerationConfig(_JsonMixin):
    """Defaults for `generate`; per-call kwargs override any field."""

    max_length: int = 64
    min_length: int = 0
    num_beams: int = 1
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    length_penalty: float = 1.0
    early_stopping: bool = False
    decoder_start_token_id: int | None = None  # falls back to DecoderConfig
    forced_bos_token_id: int | None = None
    forced_eos_token_id: int | None = 2
    # ban tokens that would repeat an n-gram already generated (reference
    # surface: generation_clip_vision_utils.py:369-388); 0 disables
    no_repeat_ngram_size: int = 0


@dataclasses.dataclass(frozen=True)
class DecodeConfig(_JsonMixin):
    """Serving/decode-path tuning knobs (the generate hot loop).

    Defaults are the measured-fastest TPU serving path (PERFORMANCE.md
    optimization history); "auto" fields resolve backend-dependently — the
    TPU kernel/approximation named per field on TPU, the exact portable
    path elsewhere (so CPU tests see deterministic reference math).  Every
    field has an environment override of the listed name, resolved in ONE
    place (core/knobs.py::override — env wins when set) so deployments can
    A/B without editing configs.  Measured-dead-end paths are NOT here:
    they live behind the MIC_TPU_EXPERIMENTAL registry (core/knobs.py).
    """

    # weight-only int8 decode (ops/quant.py), BLEU-validated: None | "int8".
    # Env: MIC_TPU_DECODE_QUANT
    quantize: str | None = None
    # int8 self-attention KV cache (lazy path only; halves cache memory,
    # measured slower at len 64): None | "int8".  Env: MIC_TPU_KV_QUANT
    kv_quant: str | None = None
    # ancestry-tracked beam cache — no physical per-step cache permute
    # (PERFORMANCE.md round-2 row).  Env: MIC_TPU_LAZY_CACHE (0 disables)
    lazy_cache: bool = True
    # one (D, 3D) self-attn QKV GEMM per layer per decode step instead of
    # three (bit-identical columns).  Env: MIC_TPU_FUSED_QKV (0 disables)
    fused_qkv: bool = True
    # fused LM-head candidate selection (ops/fused_head.py — logits never
    # reach HBM): "auto" (on for TPU), "1", "0".  Env: MIC_TPU_FUSED_HEAD
    fused_head: str = "auto"
    # in-kernel candidate select: "auto" (bucket on TPU, exact elsewhere),
    # "bucket", "exact", "window".  Env: MIC_TPU_FUSED_SELECT
    fused_select: str = "auto"
    # dense-path candidate top-k: "auto" (approx_max_k on TPU — the
    # hardware-native partial reduction, recall study in PERFORMANCE.md —
    # exact elsewhere), "exact", "approx".  Env: MIC_TPU_EXACT_TOPK=1
    # (legacy spelling for topk_mode="exact")
    topk_mode: str = "auto"
    # phased decode-cache growth (search._run_segmented): "auto" (4 linear
    # phases on the TPU XLA-chain path; off when the DMA kernel streams
    # the live prefix itself, and off-TPU), "off", or a comma list of
    # cache lengths.  Env: MIC_TPU_CACHE_SEGMENTS
    cache_segments: str = "auto"
    # lazy decode-attention impl: "auto" (the v3 DMA pass-through Pallas
    # kernel on TPU at every max_length), "0" XLA chain, "1" blocked
    # kernel, "2" DMA kernel.  Env: MIC_TPU_FUSED_LAZY_ATTN
    lazy_attn: str = "auto"
    # images per DMA grid cell in the v3 kernel; 0 = measured auto ladder
    # (G=8 at the flagship shape).  Env: MIC_TPU_DMA_G
    dma_group: int = 0


@dataclasses.dataclass(frozen=True)
class CaptionerConfig(_JsonMixin):
    """Composite vision-encoder + text-decoder captioner config.

    Mirrors the capability of the reference's ``CLIPVisionMBartConfig``
    (configuration_clip_vision_mbart.py:10-51) — one serializable object
    nesting the two tower configs — without inheriting any HF machinery.
    """

    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    generation: GenerationConfig = dataclasses.field(default_factory=GenerationConfig)
    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    tie_word_embeddings: bool = True
    # compute dtype for activations; params are always float32
    dtype: str = "float32"

    @classmethod
    def clip_vit_b32_mbart50(cls, **kw) -> "CaptionerConfig":
        """The flagship config: CLIP ViT-B/32 encoder + mBART-large-50 decoder."""
        return cls(**kw)

    @classmethod
    def vit_b16_bart_large(cls, **kw) -> "CaptionerConfig":
        """The reference's secondary family (models/flax_vit_bart): a google/vit
        tower fused into a (post-norm, English) BART-large decoder."""
        base = dict(
            vision=VisionConfig(
                patch_size=16, hidden_act="gelu", use_pre_ln=False,
                final_ln_output=True, patch_bias=True, layer_norm_eps=1e-12,
            ),
            decoder=DecoderConfig(
                vocab_size=50265, scale_embedding=False, post_norm=True,
                use_final_ln=False, decoder_start_token_id=2,
            ),
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def tiny(cls, **kw) -> "CaptionerConfig":
        base = dict(vision=VisionConfig.tiny(), decoder=DecoderConfig.tiny())
        base.update(kw)
        return cls(**base)

    # -- HF interop ---------------------------------------------------------

    @classmethod
    def from_hf_dict(cls, d: dict) -> "CaptionerConfig":
        """Build from the fused HF checkpoint's config.json
        (keys per reference configuration_clip_vision_mbart.py:33-51)."""
        cv = d.get("clip_vision_config", {})
        mb = d.get("mbart_config", {})
        vision = VisionConfig(
            hidden_size=cv.get("hidden_size", 768),
            intermediate_size=cv.get("intermediate_size", 3072),
            num_layers=cv.get("num_hidden_layers", 12),
            num_heads=cv.get("num_attention_heads", 12),
            image_size=cv.get("image_size", 224),
            patch_size=cv.get("patch_size", 32),
            layer_norm_eps=cv.get("layer_norm_eps", 1e-5),
            hidden_act=cv.get("hidden_act", "quick_gelu"),
            attention_dropout=cv.get("attention_dropout", 0.0),
        )
        decoder = DecoderConfig(
            vocab_size=mb.get("vocab_size", 250054),
            d_model=mb.get("d_model", 1024),
            ffn_dim=mb.get("decoder_ffn_dim", 4096),
            num_layers=mb.get("decoder_layers", 12),
            num_heads=mb.get("decoder_attention_heads", 16),
            max_position_embeddings=mb.get("max_position_embeddings", 1024),
            scale_embedding=mb.get("scale_embedding", True),
            activation=mb.get("activation_function", "gelu"),
            dropout=mb.get("dropout", 0.1),
            attention_dropout=mb.get("attention_dropout", 0.0),
            activation_dropout=mb.get("activation_dropout", 0.0),
            init_std=mb.get("init_std", 0.02),
            pad_token_id=mb.get("pad_token_id", 1),
            bos_token_id=mb.get("bos_token_id", 0),
            eos_token_id=mb.get("eos_token_id", 2),
            decoder_start_token_id=mb.get("decoder_start_token_id", 2),
        )
        # The reference pulls every generate default from the *checkpoint's*
        # nested mbart_config (generation_clip_vision_utils.py:205-229), so an
        # imported checkpoint must decode with its own published settings.
        # Absent keys fall back to the HF PretrainedConfig defaults the
        # reference would have seen (max_length=20, top_k=50, ...).
        generation = GenerationConfig(
            max_length=mb.get("max_length", 20),
            min_length=mb.get("min_length", 0),
            num_beams=mb.get("num_beams", 1),
            do_sample=mb.get("do_sample", False),
            temperature=mb.get("temperature", 1.0),
            top_k=mb.get("top_k", 50),
            top_p=mb.get("top_p", 1.0),
            length_penalty=mb.get("length_penalty", 1.0),
            early_stopping=mb.get("early_stopping", False),
            decoder_start_token_id=mb.get("decoder_start_token_id"),
            forced_bos_token_id=mb.get("forced_bos_token_id"),
            forced_eos_token_id=mb.get("forced_eos_token_id", 2),
            no_repeat_ngram_size=mb.get("no_repeat_ngram_size", 0),
        )
        return cls(
            vision=vision,
            decoder=decoder,
            generation=generation,
            tie_word_embeddings=d.get("tie_word_embeddings", True),
        )

    @classmethod
    def from_hf_json(cls, path: str) -> "CaptionerConfig":
        with open(path) as f:
            return cls.from_hf_dict(json.load(f))


# ---------------------------------------------------------------------------
# data / training configs


@dataclasses.dataclass(frozen=True)
class DataConfig(_JsonMixin):
    """TSV dataset + input pipeline settings (reference: main.py:104-163)."""

    train_file: str | None = None
    validation_file: str | None = None
    images_dir: str = ""
    max_seq_length: int = 64
    # decode workers: -1 = autosize to the machine (cores - 2, capped at 32;
    # 0 on <=2-core hosts, where in-process decode measured faster than a
    # 1-worker spawn pool — tools/bench_loader.py)
    num_workers: int = -1
    prefetch: int = 2
    # languages and their mBART-50 language codes
    lang_codes: tuple = ("en_XX", "fr_XX", "es_XX", "de_DE")
    # host-side decode size; device kernels resize/crop to vision.image_size
    decode_size: int = 256
    shuffle_seed: int = 42


@dataclasses.dataclass(frozen=True)
class TrainConfig(_JsonMixin):
    output_dir: str = "runs/default"
    num_epochs: int = 7
    per_device_batch_size: int = 64
    eval_batch_size: int | None = None
    learning_rate: float = 5e-5
    warmup_steps: int = 1000
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    label_smoothing: float = 0.0
    max_grad_norm: float | None = None
    # single-pass FusedAdamW (train/fused_adamw.py): optax.adamw's math, one
    # HBM traversal per step instead of updates-tree-then-apply (~16 ms/step
    # at the flagship shape).  False = plain optax chain.
    fused_adamw: bool = True
    # compute-dtype shadow params (train/shadow.py): the optimizer emits a
    # bf16 copy of each bf16-consumed weight inside its update fusion, so
    # the loss never re-casts the f32 master tree (~5 ms/step at the
    # flagship shape).  Bit-identical math; no-op when compute dtype is f32.
    shadow_params: bool = True
    seed: int = 42
    logging_steps: int = 100
    eval_steps: int = 3000
    save_steps: int = 9000
    save_total_limit: int = 6
    resume_from: str | None = None
    # mesh shape: data-parallel x model-parallel
    dp: int = -1  # -1 = all remaining devices
    tp: int = 1
    # ZeRO-3-style fully-sharded data parallel: params + adam moments shard
    # their largest divisible dim over the "data" axis (GSPMD all-gathers
    # weights just-in-time, reduce-scatters grads).  Step math is unchanged;
    # per-device state memory drops ~1/dp.  Off by default: at the flagship
    # scale (~600 M params) replicated state fits one v5e chip, so fsdp only
    # pays when dp>=2 is memory-bound (larger models / fatter optimizers).
    fsdp: bool = False
    # remat for the decoder/vision blocks:
    #   "none"  — save all per-layer activations (OOMs at batch >= 64 on a
    #             16 GB chip with the flagship model)
    #   "full"  — jax.checkpoint per layer, recompute everything in backward
    #   "masks" — full remat EXCEPT dropout masks (save_only_these_names):
    #             the backward reuses the forward's bool masks instead of
    #             re-deriving every rng stream + compare (~300 MB saved
    #             activations at per-device batch 128)
    #   "dots"  — save matmul outputs (dots_saveable): backward skips the
    #             GEMM recompute (OOMs at the flagship batch-128 shape:
    #             17.8 G > 15.75 G hbm, measured)
    # Default "masks": "none" OOMs at the production batch on a 16 GB chip,
    # and masks+dl-CE measured 389.2 samples/s/chip vs 360.2 for full+fwd-CE
    # (each alone is a wash — together they close both device time and
    # dispatch gaps; tools/profile_train.py, v5e).
    remat: str = "masks"
    gen_eval: bool = True  # run BLEU generation eval at eval_steps
    # chunked LM-head cross-entropy (ops/fused_ce.py): caps logits residency
    # at O(ce_chunk * vocab).  Keep the chunk LARGE: every chunk iteration
    # re-reads the 512 MB embedding and read-modify-writes the 1 GB f32
    # embedding grad (~4.5 GB HBM traffic per chunk — chunk 256 measured
    # 221 vs 327 samples/s/chip at chunk>=rows on v5e); the op clamps the
    # chunk to the row count, so 4096 means "single pass unless the batch
    # is huge".  Shrink only if the (ce_chunk, vocab) f32 transient
    # (~1 GB per 1024 rows at mBART's vocab) doesn't fit.
    # Default True: the dense-logit CE OOMs at the production batch (the
    # (B, T, 250054) logits tensor alone is ~4 GB bf16 at batch 64); False
    # keeps the oracle path for tiny configs/tests.
    fused_ce: bool = True
    ce_chunk: int = 4096
    # flash-CE kernel routing (ops/fused_ce.py): "auto" (dl-backward Pallas
    # kernels on TPU, XLA chunked elsewhere), "off" XLA chunked, "fwd"
    # flash forward + XLA backward, "dl" flash forward + dl-materializing
    # backward, "split" the measured-slower two-kernel backward.
    # Env override: MIC_TPU_FLASH_CE (resolved in core/knobs.py)
    flash_ce: str = "auto"
    # row ceiling for the dl-materializing CE backward (its bf16 (N, V)
    # gradient transient is ~4 GB at 8192 rows x mBART's vocab); larger
    # batches fall back to the XLA chunked backward.  Env: MIC_TPU_DL_MAX_ROWS
    dl_max_rows: int = 8192
    # adam moment dtypes; bf16 (the default) halves the optimizer's ~8 GB
    # m/v HBM round-trip per step (update math stays f32 — moments upcast
    # on read, rounded on write, optax's mu_dtype contract extended to nu;
    # +9.5 samples/s/chip at the flagship shape).  Default-on evidence:
    # hard-synthetic convergence A/B in PERFORMANCE.md — 84-point loss
    # curves track f32 moments to mean |d| 0.0008, BLEU-4 within +-0.01
    # mixed-sign.  Set both to "float32" for bit-exact resume of pre-
    # round-5 checkpoints.  adam_nu_dtype != float32 requires fused_adamw.
    # Env: MIC_TPU_MOMENT_DTYPE sets both (resolved in state.make_optimizer)
    adam_mu_dtype: str = "bfloat16"
    adam_nu_dtype: str = "bfloat16"
    # PRNG implementation for the training process ("" = leave JAX default).
    # "rbg" drives dropout masks from the TPU hardware RNG instead of
    # threefry2x32 VPU math: +5% measured step throughput at per-device
    # batch 128 (333 -> 350 samples/s/chip, v5e).  Different impls draw
    # different streams; resume is exact under the same impl.
    prng_impl: str = "rbg"
    # "start:stop" step range traced with jax.profiler into <output_dir>/profile
    profile_steps: str | None = None


_NESTED = {
    ("CaptionerConfig", "vision"): VisionConfig,
    ("CaptionerConfig", "decoder"): DecoderConfig,
    ("CaptionerConfig", "generation"): GenerationConfig,
    ("CaptionerConfig", "decode"): DecodeConfig,
}


def apply_dotted_overrides(cfg, overrides: dict[str, str]):
    """Apply {"decoder.num_layers": "2"} style overrides to a config tree."""
    for key, raw in overrides.items():
        parts = key.split(".")
        objs = [cfg]
        for p in parts[:-1]:
            objs.append(getattr(objs[-1], p))
        leaf_name = parts[-1]
        cur = getattr(objs[-1], leaf_name)
        val = _coerce(raw, cur)
        new = dataclasses.replace(objs[-1], **{leaf_name: val})
        for obj, name in zip(reversed(objs[:-1]), reversed(parts[:-1])):
            new = dataclasses.replace(obj, **{name: new})
        cfg = new
    return cfg


def _coerce(raw: str, like: Any):
    if isinstance(like, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(like, int):
        return int(raw)
    if isinstance(like, float):
        return float(raw)
    if isinstance(like, tuple):
        return tuple(raw.split(","))
    if like is None:
        for cast in (int, float):
            try:
                return cast(raw)
            except ValueError:
                pass
        return None if raw.lower() == "none" else raw
    return raw

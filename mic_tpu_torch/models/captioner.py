"""The captioner: a ViT encoder (CLIP's or ViT's tower style) + an mBART
or BART decoder with a tied LM head, or an untied ``lm_head``
(mic_tpu/models/captioner.py): the teacher-forced training forward
(``encode``, ``decode_hidden``, ``__call__``, ``lm_logits``) and serving
(``generate``): greedy, sampling and beam search.

``generate`` resolves its options as mic_tpu's does: a per-call argument,
then the environment override (core/knobs.py), then the DecodeConfig field.
Beam search decodes with the lazy beam cache (``MIC_TPU_LAZY_CACHE=0``: the
physical cache, whose rows move on every reorder); greedy and sampling with
the physical cache.  Candidates come from the fused LM head
(ops/fused_head.py) when ``fused_head`` resolves on ("auto": on for CUDA
tensors, off on the CPU, as mic_tpu is on and off the TPU; sampling and an
untied head never use it), else from the dense logits of ``lm_logits``.  The head's select
"auto" is "bucket" on CUDA and "exact" on the CPU.  Int8 serving
(``quantize="int8"``: int8 decoder and tied head, ops/quant.py;
``kv_quant="int8"``: an int8 lazy self-attention cache) resolves alike.

The beam step's kernels follow mic_tpu's switches
(models/mbart_decoder.py::_decoder_step_lazy): MIC_TPU_FUSED_LAZY_ATTN
("auto" and "2": the attention kernel that writes the cache column; "1":
the blocked kernel, whose int8 cache has a scale per (row, position,
head)), and MIC_TPU_EXPERIMENTAL's fused_cross_attn, fused_mlp and ln_qkv.
MIC_TPU_EXPERIMENTAL=merged_cross stores the lazy path's cross K/V merged
and padded, (L, B, S_pad, H*Dh), and runs the merged cross-attention kernel
(ops/cross_attention.py::fused_cross_attention_dma) in every layer; the
physical cache ignores it, as mic_tpu does.  MIC_TPU_FUSED_LAZY_ATTN=0
runs mic_tpu's XLA chain (nn/attention.py::lazy_attention_chain, plain
tensor code; its int8 cache has a scale per head, as mode "1"'s).

The full-sequence attention of both towers (the encoder, and the
teacher-forced decoder's self-attention) follows mic_tpu's
ops/attention.py gate: ``Captioner(config, attn_impl="pallas")`` takes flash
attention, MIC_TPU_EXPERIMENTAL=small_attn the small-T kernel on CUDA
tensors, else the XLA math.  ``encode`` and ``__call__`` return mic_tpu's
introspection outputs (``output_hidden_states``, ``output_attentions``) as
EncodeOutput and CaptionerOutput, layer axes stacked.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from mic_tpu_torch.core.config import CaptionerConfig
from mic_tpu_torch.core.knobs import experimental, override
from mic_tpu_torch.core.params import Params, resolve_device, torch_dtype, tree_map
from mic_tpu_torch.generate import search
from mic_tpu_torch.generate.processors import build_warpers
from mic_tpu_torch.models import clip_vit, mbart_decoder
from mic_tpu_torch.nn.cache import DecoderCache, LazyDecoderCache, init_cache, init_lazy_cache
from mic_tpu_torch.nn.layers import dense, init_dense, init_embed
from mic_tpu_torch.nn.stacked import remat_policy
from mic_tpu_torch.ops import lazy_attention
from mic_tpu_torch.ops.fused_head import fused_head_topk, fused_head_topk_q8
from mic_tpu_torch.ops.quant import int8_matmul, quantize_params_for_decode, quantize_rows_dynamic


def init_params(config: CaptionerConfig, generator: torch.Generator, device=None) -> Params:
    """Float32 params with mic_tpu's key paths, shapes and normal(0, std)
    scheme (random streams differ from JAX's); an untied head adds
    ``lm_head`` (a (d_model, vocab) kernel, no bias)."""
    dec = config.decoder
    params = {
        "shared": init_embed(generator, dec.vocab_size, dec.d_model, dec.init_std, device),
        "vision": clip_vit.init_vision(generator, config.vision, device),
        "proj": init_dense(generator, config.vision.hidden_size, dec.d_model, dec.init_std,
                           device=device),
        "decoder": mbart_decoder.init_decoder(generator, dec, device),
        "final_logits_bias": torch.zeros((dec.vocab_size,), device=device),
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = init_dense(generator, dec.d_model, dec.vocab_size, dec.init_std,
                                       use_bias=False, device=device)
    return params


class EncodeOutput(NamedTuple):
    """``encode`` with introspection: last_hidden_state is the PROJECTED
    (B, 1+N, d_model) states the decoder cross-attends to; hidden_states and
    attentions are the vision tower's stacked per-layer tensors."""

    last_hidden_state: torch.Tensor
    hidden_states: Optional[torch.Tensor] = None
    attentions: Optional[torch.Tensor] = None


class CaptionerOutput(NamedTuple):
    """``__call__`` with introspection (mic_tpu's CaptionerOutput); every
    layer axis is stacked."""

    logits: torch.Tensor
    encoder_last_hidden_state: Optional[torch.Tensor] = None
    encoder_hidden_states: Optional[torch.Tensor] = None
    encoder_attentions: Optional[torch.Tensor] = None
    decoder_hidden_states: Optional[torch.Tensor] = None
    decoder_attentions: Optional[torch.Tensor] = None
    cross_attentions: Optional[torch.Tensor] = None


class Captioner:
    def __init__(self, config: CaptionerConfig, attn_impl: str = "xla", remat=False):
        self.config = config
        self.dtype = torch_dtype(config.dtype)
        # as in mic_tpu, any value but "pallas" is the XLA math
        self.attn_impl = attn_impl
        remat_policy(remat)
        self.remat = remat

    def encode(self, params: Params, pixel_values: torch.Tensor,
               generator: torch.Generator | None = None, output_hidden_states: bool = False,
               output_attentions: bool = False):
        """pixel_values (B, H, W, 3) float -> projected encoder states
        (B, 1 + num_patches, d_model), or an EncodeOutput with the vision
        tower's introspection tensors; ``generator`` drives dropout."""
        out = clip_vit.apply_vision(
            params["vision"], pixel_values, self.config.vision, self.dtype, generator,
            attn_impl=self.attn_impl, remat=self.remat,
            output_hidden_states=output_hidden_states, output_attentions=output_attentions,
        )
        if not (output_hidden_states or output_attentions):
            return dense(params["proj"], out, self.dtype)
        return EncodeOutput(
            last_hidden_state=dense(params["proj"], out.last_hidden_state, self.dtype),
            hidden_states=out.hidden_states, attentions=out.attentions,
        )

    def decode_hidden(self, params: Params, enc_states: torch.Tensor,
                      decoder_input_ids: torch.Tensor, decoder_attention_mask: torch.Tensor,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        """Teacher-forced decoder hidden states (B, T, d_model) before the LM
        head: what ops/fused_ce.py takes, so training never stores logits."""
        return mbart_decoder.apply_decoder(
            params["decoder"], params["shared"], decoder_input_ids, decoder_attention_mask,
            enc_states, None, self.config.decoder, self.dtype, generator,
            attn_impl=self.attn_impl, remat=self.remat,
        )

    def decode_train(self, params: Params, enc_states: torch.Tensor,
                     decoder_input_ids: torch.Tensor, decoder_attention_mask: torch.Tensor,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        hidden = self.decode_hidden(params, enc_states, decoder_input_ids,
                                    decoder_attention_mask, generator)
        return self.lm_logits(params, hidden)

    def __call__(self, params: Params, pixel_values: torch.Tensor,
                 decoder_input_ids: torch.Tensor, decoder_attention_mask: torch.Tensor,
                 generator: torch.Generator | None = None, output_hidden_states: bool = False,
                 output_attentions: bool = False):
        """Teacher-forced forward -> logits (B, T, vocab) in the compute dtype,
        or a CaptionerOutput when introspection outputs are requested.  The
        encoder and then the decoder draw their dropout masks from the one
        ``generator``."""
        if not (output_hidden_states or output_attentions):
            enc_states = self.encode(params, pixel_values, generator)
            return self.decode_train(params, enc_states, decoder_input_ids,
                                     decoder_attention_mask, generator)
        enc = self.encode(params, pixel_values, generator, output_hidden_states,
                          output_attentions)
        dec = mbart_decoder.apply_decoder(
            params["decoder"], params["shared"], decoder_input_ids, decoder_attention_mask,
            enc.last_hidden_state, None, self.config.decoder, self.dtype, generator,
            attn_impl=self.attn_impl, remat=self.remat,
            output_hidden_states=output_hidden_states, output_attentions=output_attentions,
        )
        return CaptionerOutput(
            logits=self.lm_logits(params, dec.last_hidden_state),
            encoder_last_hidden_state=enc.last_hidden_state,
            encoder_hidden_states=enc.hidden_states,
            encoder_attentions=enc.attentions,
            decoder_hidden_states=dec.hidden_states,
            decoder_attentions=dec.attentions,
            cross_attentions=dec.cross_attentions,
        )

    def lm_logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        """Tied head: hidden @ embedding^T + final_logits_bias, all in the
        compute dtype.  An int8 table multiplies the row-quantized hidden
        state int8 x int8, then acc * hs * scale in f32, cast, + bias.  An
        untied head: hidden @ lm_head.kernel + final_logits_bias."""
        if not self.config.tie_word_embeddings:
            logits = hidden.to(self.dtype) @ params["lm_head"]["kernel"].to(self.dtype)
            return logits + params["final_logits_bias"].to(self.dtype)
        shared = params["shared"]
        if "embedding_q" in shared:
            hq, hs = quantize_rows_dynamic(hidden)
            acc = int8_matmul(hq.reshape(-1, hq.shape[-1]), shared["embedding_q"].T)
            acc = acc.reshape(*hidden.shape[:-1], acc.shape[-1])
            logits = (acc.float() * hs * shared["embedding_scale"]).to(self.dtype)
            return logits + params["final_logits_bias"].to(self.dtype)
        weight = shared["embedding"].to(self.dtype)
        logits = hidden.to(self.dtype) @ weight.T
        return logits + params["final_logits_bias"].to(self.dtype)

    def init_decode_cache(self, params: Params, enc_states: torch.Tensor, max_length: int,
                          beams: int, lazy: bool = True, kv_quant: str | None = None,
                          merged: bool = True,
                          merged_cross: bool = False) -> LazyDecoderCache | DecoderCache:
        """enc_states is true-batch (B, S, D): cross K/V are kept once per
        image, merged and padded to (L, B, S_pad, H*Dh) with
        ``merged_cross``; only the self cache is per beam: the lazy cache
        (int8 with kv_quant="int8", with per-row scales when ``merged``, else
        per-head ones), or the physical (L, B*beams, T, H, Dh) one."""
        cross_k, cross_v = mbart_decoder.init_cross_cache(
            params["decoder"], enc_states, self.config.decoder, self.dtype, merged=merged_cross
        )
        if lazy:
            return init_lazy_cache(cross_k, cross_v, beams, max_length, kv_quant, merged,
                                   num_heads=self.config.decoder.num_heads)
        return init_cache(cross_k, cross_v, enc_states.shape[0] * beams, max_length)

    def decode_step(self, params: Params, token_ids: torch.Tensor, cache, beams: int = 1,
                    enc_len: int | None = None):
        """(B*beams, 1) tokens + cache -> ((B*beams, vocab) logits in the
        compute dtype, cache); ``enc_len`` is the live length of a merged
        cross cache."""
        hidden, cache = mbart_decoder.decoder_step(
            params["decoder"], params["shared"], token_ids, cache, self.config.decoder,
            self.dtype, beams, enc_len,
        )
        return self.lm_logits(params, hidden)[:, 0, :], cache

    def _candidate_head(self, params: Params, sel: str) -> search.CandidateHead:
        """The fused head over the tied table, int8 or not, with the forced
        token's numerator in the same arithmetic as the head's logits."""
        shared = params["shared"]
        bias = params["final_logits_bias"]
        if "embedding_q" in shared:
            weight_q, scale = shared["embedding_q"], shared["embedding_scale"]

            def head(hidden, k):
                return fused_head_topk_q8(hidden, weight_q, scale, bias, k, sel)

            def tok_logit(hidden, tok):
                if sel == "bucket":  # bf16 x int8-as-bf16, no activation quantization
                    row = weight_q[tok].to(torch.bfloat16).float()
                    acc = hidden.to(torch.bfloat16).float() @ row
                    return acc * scale[tok].float() + bias[tok].float()
                xq, xs = quantize_rows_dynamic(hidden)
                acc = (xq.int() * weight_q[tok].int()).sum(-1)   # exact int32 dot
                return acc.float() * xs[:, 0] * scale[tok].float() + bias[tok].float()
        else:
            weight = shared["embedding"]

            def head(hidden, k):
                return fused_head_topk(hidden, weight, bias, k, sel)

            def tok_logit(hidden, tok):
                return hidden.float() @ weight[tok].float() + bias[tok].float()

        def topk(hidden, k):
            lp, ids, _ = head(hidden, k)
            return lp, ids

        def token_lp(hidden, tok):
            # one weight row for the numerator, the row lse from a k=1 pass
            _, _, lse = head(hidden, 1)
            return tok_logit(hidden, tok) - lse[:, 0]

        return search.CandidateHead(topk=topk, token_lp=token_lp,
                                    vocab_size=self.config.decoder.vocab_size)

    @torch.no_grad()
    def generate(self, params: Params, pixel_values: torch.Tensor,
                 generator: torch.Generator | None = None,
                 **overrides) -> search.GenerateOutput:
        """Caption a batch of images; defaults come from config.generation,
        overridable per call (max_length, num_beams, do_sample, temperature,
        top_k, top_p, min_length, no_repeat_ngram_size, forced_bos_token_id,
        length_penalty, ...), as are ``quantize`` and ``kv_quant`` (None or
        "int8") and ``eos_positions`` ((B,) pinned per-image EOS positions).
        ``generator`` (a torch.Generator on the images' device, mic_tpu's
        ``rng``) draws the sampling noise."""
        dcfg = self.config.decode
        quantize = overrides.pop("quantize", None) or override(
            "MIC_TPU_DECODE_QUANT", dcfg.quantize
        )
        kv_quant = overrides.pop("kv_quant", None) or override(
            "MIC_TPU_KV_QUANT", dcfg.kv_quant
        ) or None
        if quantize not in (None, "", "int8"):
            raise ValueError(f"unsupported quantize: {quantize!r}")
        eos_positions = overrides.pop("eos_positions", None)
        gen = self.config.generation.replace(**overrides)
        dec = self.config.decoder
        start = (gen.decoder_start_token_id if gen.decoder_start_token_id is not None
                 else dec.decoder_start_token_id)
        batch = pixel_values.shape[0]
        on_cuda = pixel_values.device.type == "cuda"
        lazy = gen.num_beams > 1 and override(
            "MIC_TPU_LAZY_CACHE", "1" if dcfg.lazy_cache else "0") == "1"
        fh = override("MIC_TPU_FUSED_HEAD", dcfg.fused_head)
        if fh == "auto":
            fh = "1" if on_cuda else "0"
        # the fused head runs on the tied table only
        fused_head = not gen.do_sample and self.config.tie_word_embeddings and fh == "1"

        # weights in the compute dtype once, outside the decode loop (a
        # no-op on make_serving_params output), then the fused QKV view of
        # the lazy step, then int8 (so the fused kernel is scaled per
        # channel, and the f32 scales are never rounded to the compute dtype)
        params = tree_map(
            lambda x: x.to(self.dtype) if x.is_floating_point() else x, params
        )
        if lazy:
            # mic_tpu's unfused alternative gives bit-identical columns; the
            # port keeps the fused step alone and refuses the switch
            if override("MIC_TPU_FUSED_QKV", "1" if dcfg.fused_qkv else "0") != "1":
                raise ValueError("the lazy decode step always fuses q/k/v: "
                                 "MIC_TPU_FUSED_QKV=0 / DecodeConfig.fused_qkv=False "
                                 "is not supported")
            params = {**params, "decoder": mbart_decoder.fuse_qkv_params(params["decoder"])}
        if quantize == "int8":
            params = quantize_params_for_decode(params)

        # the lazy-attention mode, resolved once as mic_tpu resolves it (from
        # the environment; DecodeConfig.lazy_attn is never read), picks the
        # int8 cache's layout: per-row scales for mode "2", per-head ones for
        # modes "1" and "0" (MIC_TPU_EXPERIMENTAL=merged_kv forces per-row)
        mode = lazy_attention.resolve_mode(gen.max_length)
        merged = not (kv_quant == "int8" and mode in ("0", "1")
                      and experimental("merged_kv") != "1")
        # the merged, padded cross cache and its kernel: lazy path only
        merged_cross = lazy and experimental("merged_cross") == "1"

        enc_states = self.encode(params, pixel_values)
        enc_len = enc_states.shape[1]  # before the merged cross cache's pad
        # the quantized KV cache is lazy-path only
        cache = self.init_decode_cache(params, enc_states, gen.max_length, gen.num_beams,
                                       lazy, kv_quant if lazy else None, merged=merged,
                                       merged_cross=merged_cross)
        if fused_head:
            sel = override("MIC_TPU_FUSED_SELECT", dcfg.fused_select)
            if sel == "auto":
                sel = "bucket" if on_cuda else "exact"
            head = self._candidate_head(params, sel)

            def step_fn(token_ids, cache):
                hidden, cache = mbart_decoder.decoder_step(
                    params["decoder"], params["shared"], token_ids, cache, dec, self.dtype,
                    gen.num_beams, enc_len,
                )
                return hidden[:, 0, :], cache
        else:
            head = None

            def step_fn(token_ids, cache):
                return self.decode_step(params, token_ids, cache, gen.num_beams, enc_len)

        forced = []
        if gen.forced_bos_token_id is not None:
            forced.append((1, gen.forced_bos_token_id))
        if gen.forced_eos_token_id is not None:
            forced.append((gen.max_length - 1, gen.forced_eos_token_id))
        spec = search.ProcessorSpec(
            forced=tuple(forced), min_length=gen.min_length, eos_token_id=dec.eos_token_id,
            no_repeat_ngram=gen.no_repeat_ngram_size,
        )
        warpers = build_warpers(temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p)
        return search.generate(
            step_fn, cache, batch,
            max_length=gen.max_length, start_token_id=start,
            eos_token_id=dec.eos_token_id, pad_token_id=dec.pad_token_id,
            num_beams=gen.num_beams, do_sample=gen.do_sample, spec=spec, warpers=warpers,
            length_penalty=gen.length_penalty, early_stopping=gen.early_stopping,
            generator=generator, head=head, eos_positions=eos_positions,
        )

    # -- persistence (the formats live in io/checkpoint.py) -------------------

    def save_pretrained(self, directory: str, params: Params) -> None:
        """A model directory: config.json and params.pt."""
        from mic_tpu_torch.io import checkpoint

        os.makedirs(directory, exist_ok=True)
        self.config.to_json(os.path.join(directory, "config.json"))
        checkpoint.save_params(directory, params)

    def push_to_hub(self, directory: str, repo_id: str, **kw) -> str:
        """Upload a save_pretrained (or exported) directory to the HF Hub
        (io/hub.py; needs the network and credentials)."""
        from mic_tpu_torch.io.hub import push_to_hub

        return push_to_hub(directory, repo_id, **kw)

    @classmethod
    def from_pretrained(cls, directory: str, device=None, revision: Optional[str] = None,
                        **kw) -> tuple["Captioner", Params]:
        """(model, params), the params on ``device`` (default: the card);
        ``kw`` goes to the constructor.  ``directory`` is a local directory
        in the port's own format (config.json + params.pt) or the
        reference's fused HF checkpoint (config.json with
        clip_vision_config / mbart_config + flax_model.msgpack), told apart
        by the msgpack file, or a hub repo id resolved to a cached snapshot
        (io/hub.py).  mic_tpu's Orbax directories raise a ValueError
        (io/checkpoint.py)."""
        from mic_tpu_torch.io import checkpoint
        from mic_tpu_torch.io.hf_import import FLAX_WEIGHTS, load_fused_checkpoint
        from mic_tpu_torch.io.hub import resolve_model_dir

        directory = resolve_model_dir(directory, revision=revision)
        device = resolve_device(device)
        if os.path.exists(os.path.join(directory, FLAX_WEIGHTS)):
            config = CaptionerConfig.from_hf_json(os.path.join(directory, "config.json"))
            return cls(config, **kw), load_fused_checkpoint(directory, device)
        config = CaptionerConfig.from_json(os.path.join(directory, "config.json"))
        model = cls(config, **kw)
        return model, checkpoint.load_params(directory, device)

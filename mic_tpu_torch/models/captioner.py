"""The captioner: CLIP-ViT encoder + mBART decoder with a tied LM head
(mic_tpu/models/captioner.py), for beam-search serving.

``generate`` decodes with the lazy beam cache and always selects candidates
through the fused LM head (ops/fused_head.py).  DecodeConfig's "auto"
fields resolve by the device of the tensors: on CUDA the candidate select
is "bucket" (the kernel, as on the TPU), on the CPU "exact" in the plain
version, which equals mic_tpu's dense CPU path at float32.
"""

from __future__ import annotations

import torch

from mic_tpu.core.config import CaptionerConfig
from mic_tpu_torch.core.params import Params, torch_dtype, tree_map
from mic_tpu_torch.generate import search
from mic_tpu_torch.models import clip_vit, mbart_decoder
from mic_tpu_torch.nn.cache import LazyDecoderCache, init_lazy_cache
from mic_tpu_torch.nn.layers import dense, init_dense, init_embed
from mic_tpu_torch.ops.fused_head import fused_head_topk


def init_params(config: CaptionerConfig, generator: torch.Generator, device=None) -> Params:
    """Float32 params with mic_tpu's key paths, shapes and normal(0, std)
    scheme (random streams differ from JAX's)."""
    if not config.tie_word_embeddings:
        raise NotImplementedError("only the tied LM head is ported")
    dec = config.decoder
    return {
        "shared": init_embed(generator, dec.vocab_size, dec.d_model, dec.init_std, device),
        "vision": clip_vit.init_vision(generator, config.vision, device),
        "proj": init_dense(generator, config.vision.hidden_size, dec.d_model, dec.init_std,
                           device=device),
        "decoder": mbart_decoder.init_decoder(generator, dec, device),
        "final_logits_bias": torch.zeros((dec.vocab_size,), device=device),
    }


class Captioner:
    def __init__(self, config: CaptionerConfig):
        if not config.tie_word_embeddings:
            raise NotImplementedError("only the tied LM head is ported")
        clip_vit.check_clip_style(config.vision)
        mbart_decoder.check_pre_norm(config.decoder)
        self.config = config
        self.dtype = torch_dtype(config.dtype)

    def encode(self, params: Params, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values (B, H, W, 3) float -> projected encoder states
        (B, 1 + num_patches, d_model)."""
        out = clip_vit.apply_vision(params["vision"], pixel_values, self.config.vision,
                                    self.dtype)
        return dense(params["proj"], out, self.dtype)

    def init_decode_cache(self, params: Params, enc_states: torch.Tensor, max_length: int,
                          beams: int) -> LazyDecoderCache:
        """enc_states is true-batch (B, S, D): cross K/V are kept once per
        image; only the self cache is per beam."""
        cross_k, cross_v = mbart_decoder.init_cross_cache(
            params["decoder"], enc_states, self.config.decoder, self.dtype
        )
        return init_lazy_cache(cross_k, cross_v, beams, max_length)

    def _candidate_head(self, params: Params, device: torch.device) -> search.CandidateHead:
        sel = self.config.decode.fused_select
        if sel == "auto":
            sel = "bucket" if device.type == "cuda" else "exact"
        weight = params["shared"]["embedding"]
        bias = params["final_logits_bias"]

        def topk(hidden, k):
            lp, ids, _ = fused_head_topk(hidden, weight, bias, k, sel)
            return lp, ids

        def token_lp(hidden, tok):
            # one weight row for the numerator, the row lse from a k=1 pass
            _, _, lse = fused_head_topk(hidden, weight, bias, 1, sel)
            logit = hidden.float() @ weight[tok].float() + bias[tok].float()
            return logit - lse[:, 0]

        return search.CandidateHead(topk=topk, token_lp=token_lp,
                                    vocab_size=self.config.decoder.vocab_size)

    @torch.no_grad()
    def generate(self, params: Params, pixel_values: torch.Tensor,
                 **overrides) -> search.GenerateOutput:
        """Beam-search captions for a batch of images; defaults come from
        config.generation, overridable per call (max_length, num_beams,
        min_length, forced_bos_token_id, length_penalty, ...)."""
        dcfg = self.config.decode
        if dcfg.quantize or dcfg.kv_quant:
            raise NotImplementedError("int8 weights and int8 KV are not ported yet")
        gen = self.config.generation.replace(**overrides)
        if gen.do_sample or gen.num_beams < 2:
            raise NotImplementedError("only beam search (num_beams > 1) is ported")
        if gen.no_repeat_ngram_size:
            raise NotImplementedError("no_repeat_ngram_size is not ported yet")
        dec = self.config.decoder
        start = (gen.decoder_start_token_id if gen.decoder_start_token_id is not None
                 else dec.decoder_start_token_id)
        batch = pixel_values.shape[0]

        # weights in the compute dtype once, outside the decode loop (a
        # no-op on make_serving_params output), and the fused QKV view
        params = tree_map(
            lambda x: x.to(self.dtype) if x.is_floating_point() else x, params
        )
        params = {**params, "decoder": mbart_decoder.fuse_qkv_params(params["decoder"])}

        enc_states = self.encode(params, pixel_values)
        cache = self.init_decode_cache(params, enc_states, gen.max_length, gen.num_beams)
        head = self._candidate_head(params, pixel_values.device)

        def step_fn(token_ids, cache):
            hidden, cache = mbart_decoder.decoder_step(
                params["decoder"], params["shared"], token_ids, cache, dec, self.dtype,
                gen.num_beams,
            )
            return hidden[:, 0, :], cache

        forced = []
        if gen.forced_bos_token_id is not None:
            forced.append((1, gen.forced_bos_token_id))
        if gen.forced_eos_token_id is not None:
            forced.append((gen.max_length - 1, gen.forced_eos_token_id))
        spec = search.ProcessorSpec(
            forced=tuple(forced), min_length=gen.min_length, eos_token_id=dec.eos_token_id,
        )
        return search.generate(
            step_fn, cache, batch,
            max_length=gen.max_length, start_token_id=start,
            eos_token_id=dec.eos_token_id, pad_token_id=dec.pad_token_id,
            num_beams=gen.num_beams, spec=spec, head=head,
            length_penalty=gen.length_penalty, early_stopping=gen.early_stopping,
        )

"""The mBART-50 translator (mic_tpu/models/mbart_seq2seq.py): the text
encoder (models/mbart_text.py), the decoder and a tied LM head.  The
reference used it to build its four-language caption set.

``generate`` decodes on the physical ``DecoderCache`` (nn/cache.py), so a
beam search reorders the self K/V through ops/beam_permute.py (row 19)
every step; MIC_TPU_EXPERIMENTAL=fused_decode runs the decode-attention
kernel (row 18) in each layer's self-attention and pallas_topk the top-k +
logsumexp select (row 17) on the dense logits.  The cross K/V are projected
once per source sentence and shared by its beams; the source's padding
mask masks their keys (which keeps the cross-attention kernels off, as in
mic_tpu).  Forced tokens follow mic_tpu: ``forced_bos_token_id`` at
position 1, ``forced_eos_token_id`` at ``max_length - 1``, then
``min_length``.
"""

from __future__ import annotations


import torch

from mic_tpu_torch.core.config import DecoderConfig, GenerationConfig
from mic_tpu_torch.core.params import Params, torch_dtype, tree_map
from mic_tpu_torch.generate import search
from mic_tpu_torch.generate.processors import build_warpers
from mic_tpu_torch.models import mbart_decoder, mbart_text
from mic_tpu_torch.nn.cache import init_cache
from mic_tpu_torch.nn.layers import init_embed


class MBartSeq2Seq:
    """Config holder over pure functions, as Captioner is.  ``dtype`` is
    the compute dtype (a torch dtype or its name); params stay float32."""

    def __init__(self, config: DecoderConfig, generation: GenerationConfig | None = None,
                 dtype=torch.float32, attn_impl: str = "xla", remat=False):
        self.config = config
        self.generation = generation or GenerationConfig()
        self.dtype = torch_dtype(dtype) if isinstance(dtype, str) else dtype
        self.attn_impl = attn_impl
        self.remat = remat

    def init_params(self, generator: torch.Generator, device=None) -> Params:
        """Float32 params with mic_tpu's key paths and shapes (random streams
        differ from JAX's)."""
        cfg = self.config
        return {
            "shared": init_embed(generator, cfg.vocab_size, cfg.d_model, cfg.init_std, device),
            "encoder": mbart_text.init_text_encoder(generator, cfg, device),
            "decoder": mbart_decoder.init_decoder(generator, cfg, device),
            "final_logits_bias": torch.zeros((cfg.vocab_size,), device=device),
        }

    def encode(self, params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               generator: torch.Generator | None = None) -> torch.Tensor:
        return mbart_text.apply_text_encoder(
            params["encoder"], params["shared"], input_ids, attention_mask, self.config,
            self.dtype, generator, self.attn_impl, self.remat,
        )

    def lm_logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        """hidden @ embedding^T + final_logits_bias, in the compute dtype."""
        logits = hidden.to(self.dtype) @ params["shared"]["embedding"].to(self.dtype).T
        return logits + params["final_logits_bias"].to(self.dtype)

    def __call__(self, params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 decoder_input_ids: torch.Tensor, decoder_attention_mask: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """Teacher-forced forward -> logits (B, T, vocab) in the compute
        dtype; the encoder, then the decoder, draw dropout from
        ``generator``."""
        enc = self.encode(params, input_ids, attention_mask, generator)
        hidden = mbart_decoder.apply_decoder(
            params["decoder"], params["shared"], decoder_input_ids, decoder_attention_mask,
            enc, attention_mask, self.config, self.dtype, generator, self.attn_impl,
            self.remat,
        )
        return self.lm_logits(params, hidden)

    @torch.no_grad()
    def generate(self, params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 generator: torch.Generator | None = None,
                 **overrides) -> search.GenerateOutput:
        """Translate a batch of source rows (right-padded, ``attention_mask``
        1 on real tokens); defaults come from ``self.generation``,
        overridable per call.  ``generator`` draws the sampling noise."""
        gen = self.generation.replace(**overrides)
        cfg = self.config
        params = tree_map(lambda x: x.to(self.dtype) if x.is_floating_point() else x, params)
        batch = input_ids.shape[0]
        start = (gen.decoder_start_token_id if gen.decoder_start_token_id is not None
                 else cfg.decoder_start_token_id)

        enc = self.encode(params, input_ids, attention_mask)
        cross_k, cross_v = mbart_decoder.init_cross_cache(params["decoder"], enc, cfg,
                                                          self.dtype)
        cache = init_cache(cross_k, cross_v, batch * gen.num_beams, gen.max_length)

        def step_fn(token_ids, cache):
            hidden, cache = mbart_decoder.decoder_step(
                params["decoder"], params["shared"], token_ids, cache, cfg, self.dtype,
                gen.num_beams, enc_mask=attention_mask,
            )
            return self.lm_logits(params, hidden)[:, 0, :], cache

        forced = []
        if gen.forced_bos_token_id is not None:
            forced.append((1, gen.forced_bos_token_id))
        if gen.forced_eos_token_id is not None:
            forced.append((gen.max_length - 1, gen.forced_eos_token_id))
        spec = search.ProcessorSpec(forced=tuple(forced), min_length=gen.min_length,
                                    eos_token_id=cfg.eos_token_id)
        return search.generate(
            step_fn, cache, batch,
            max_length=gen.max_length, start_token_id=start,
            eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
            num_beams=gen.num_beams, do_sample=gen.do_sample, spec=spec,
            warpers=build_warpers(temperature=gen.temperature, top_k=gen.top_k,
                                  top_p=gen.top_p),
            length_penalty=gen.length_penalty, early_stopping=gen.early_stopping,
            generator=generator,
        )

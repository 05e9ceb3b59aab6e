"""Export a captioner to the reference's HF checkpoint format
(mic_tpu/io/hf_export.py).

Writes ``config.json`` with the nested ``clip_vision_config`` /
``mbart_config`` keys and ``flax_model.msgpack`` (io/flax_msgpack.py) with
the published checkpoint's tree: model/shared, model/encoder/vision_model,
model/decoder, model/visual_projection, lm_head (the tied head stored as
the transposed shared table) and final_logits_bias (1, V).  Every leaf is
written in float32.  The inverse of io/hf_import.py::from_hf_fused_flax.

The format holds the CLIP+mBART style with a tied head only: its config
keys carry no ViT-style or post-norm switch and its ``lm_head`` is the
shared table, so any other model raises a ValueError rather than write a
file that would read back as another model (ROADMAP §C).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mic_tpu_torch.core.config import CaptionerConfig
from mic_tpu_torch.core.params import Params, tree_map
from mic_tpu_torch.io import flax_msgpack
from mic_tpu_torch.io.hf_import import FLAX_WEIGHTS
from mic_tpu_torch.nn.stacked import layer_slice, num_layers_of


def _np32(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).contiguous().numpy()


def _unstack(stacked: Params) -> list[Params]:
    host = tree_map(_np32, stacked)
    return [layer_slice(host, i) for i in range(num_layers_of(stacked))]


def _ln(p) -> dict:
    return {"scale": p["scale"], "bias": p["bias"]}


def _dense(p) -> dict:
    return {name: p[name] for name in ("kernel", "bias") if name in p}


def _mha(p) -> dict:
    return {"q_proj": _dense(p["q"]), "k_proj": _dense(p["k"]), "v_proj": _dense(p["v"]),
            "out_proj": _dense(p["o"])}


def _vision_to_hf(vision: Params, patch_size: int) -> dict:
    kernel = _np32(vision["patch_embed"]["kernel"])
    layers = {
        str(i): {
            "layer_norm1": _ln(li["ln1"]),
            "self_attn": _mha(li["attn"]),
            "layer_norm2": _ln(li["ln2"]),
            "mlp": {"fc1": _dense(li["fc1"]), "fc2": _dense(li["fc2"])},
        }
        for i, li in enumerate(_unstack(vision["layers"]))
    }
    return {
        "vision_model": {
            "embeddings": {
                "class_embedding": _np32(vision["class_embed"]),
                "patch_embedding": {
                    "kernel": kernel.reshape(patch_size, patch_size, 3, kernel.shape[-1])},
                "position_embedding": {"embedding": _np32(vision["pos_embed"]["embedding"])},
            },
            "pre_layrnorm": tree_map(_np32, _ln(vision["pre_ln"])),
            "post_layernorm": tree_map(_np32, _ln(vision["post_ln"])),
            "encoder": {"layers": layers},
        }
    }


def _decoder_to_hf(decoder: Params) -> dict:
    layers = {
        str(i): {
            "self_attn_layer_norm": _ln(li["ln_self"]),
            "self_attn": _mha(li["self_attn"]),
            "encoder_attn_layer_norm": _ln(li["ln_cross"]),
            "encoder_attn": _mha(li["cross_attn"]),
            "final_layer_norm": _ln(li["ln_mlp"]),
            "fc1": _dense(li["fc1"]),
            "fc2": _dense(li["fc2"]),
        }
        for i, li in enumerate(_unstack(decoder["layers"]))
    }
    return {
        "embed_positions": {"embedding": _np32(decoder["pos_embed"]["embedding"])},
        "layernorm_embedding": tree_map(_np32, _ln(decoder["ln_embed"])),
        "layer_norm": tree_map(_np32, _ln(decoder["final_ln"])),
        "layers": layers,
    }


def export_hf_fused(params: Params, config: CaptionerConfig, directory: str) -> int:
    """Write <directory>/{config.json, flax_model.msgpack} in the reference's
    published-checkpoint format -> the msgpack file's bytes.  Only the
    tied CLIP+mBART style: another raises a ValueError (ROADMAP §C)."""
    v, d = config.vision, config.decoder
    if not config.tie_word_embeddings:
        raise ValueError("the HF fused format stores the shared table as lm_head: an untied "
                         "head would be lost (ROADMAP §C)")
    if not v.use_pre_ln or v.final_ln_output or v.patch_bias or d.post_norm \
            or not d.use_final_ln:
        raise ValueError("the HF fused format holds the CLIP tower and the pre-norm mBART "
                         "decoder only; its config cannot say ViT style or post-norm "
                         "(ROADMAP §C)")
    os.makedirs(directory, exist_ok=True)
    shared = _np32(params["shared"]["embedding"])
    tree = {
        "model": {
            "shared": {"embedding": shared},
            "encoder": _vision_to_hf(params["vision"], config.vision.patch_size),
            "decoder": _decoder_to_hf(params["decoder"]),
            "visual_projection": tree_map(_np32, _dense(params["proj"])),
        },
        # the tied lm_head: the reference stores the transposed shared table
        "lm_head": {"kernel": shared.T},
        "final_logits_bias": _np32(params["final_logits_bias"]).reshape(1, -1),
    }
    nbytes = flax_msgpack.write_file(os.path.join(directory, FLAX_WEIGHTS), tree)

    # the generate defaults too: the reference reads them from the
    # checkpoint's mbart_config
    g = config.generation
    hf_config = {
        "model_type": "clip-vision-mbart",
        "is_encoder_decoder": True,
        "tie_word_embeddings": config.tie_word_embeddings,
        "clip_vision_config": {
            "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_layers,
            "num_attention_heads": v.num_heads,
            "image_size": v.image_size,
            "patch_size": v.patch_size,
            "layer_norm_eps": v.layer_norm_eps,
            "hidden_act": v.hidden_act,
        },
        "mbart_config": {
            "vocab_size": d.vocab_size,
            "d_model": d.d_model,
            "decoder_ffn_dim": d.ffn_dim,
            "decoder_layers": d.num_layers,
            "decoder_attention_heads": d.num_heads,
            "max_position_embeddings": d.max_position_embeddings,
            "scale_embedding": d.scale_embedding,
            "activation_function": d.activation,
            "dropout": d.dropout,
            "pad_token_id": d.pad_token_id,
            "bos_token_id": d.bos_token_id,
            "eos_token_id": d.eos_token_id,
            "decoder_start_token_id": d.decoder_start_token_id,
            "max_length": g.max_length,
            "min_length": g.min_length,
            "num_beams": g.num_beams,
            "do_sample": g.do_sample,
            "temperature": g.temperature,
            "top_k": g.top_k,
            "top_p": g.top_p,
            "length_penalty": g.length_penalty,
            "early_stopping": g.early_stopping,
            "forced_bos_token_id": g.forced_bos_token_id,
            "forced_eos_token_id": g.forced_eos_token_id,
        },
    }
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    return nbytes

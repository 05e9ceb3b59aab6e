"""HF PyTorch state dicts of the captioner's towers, for writing the tower
directories that io/hf_import.py::load_pretrained_towers reads
(``model.safetensors`` for CLIP, ``pytorch_model.bin`` for mBART), and of
the mBART-50 translator, for the weights directory that
tools/torch_translate.py::load_model reads.

``to_torch_clip_state_dict`` gives CLIPVisionModel's names and layouts,
``to_torch_mbart_state_dict`` the decoder side of
MBartForConditionalGeneration's: the inverses of
io/hf_import.py::from_torch_clip_state_dict and
::from_torch_mbart_state_dict.  ``to_torch_mbart_seq2seq_state_dict``
gives the whole of it (both sides), the inverse of the torch branch of
tools/torch_translate.py::load_model.  chip_smoke.py writes its flagship-width
tower directories with them; the reference has no such writer.
"""

from __future__ import annotations

import torch

from mic_tpu_torch.core.params import Params
from mic_tpu_torch.nn.stacked import layer_slice, num_layers_of

def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", torch.float32).contiguous()


def _torch_dense(p, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _host(p["kernel"].T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _host(p["bias"])


def _torch_ln(p, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _host(p["scale"])
    out[f"{prefix}.bias"] = _host(p["bias"])


def _torch_mha(p, prefix: str, out: dict) -> None:
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
        _torch_dense(p[ours], f"{prefix}.{theirs}", out)


def to_torch_clip_state_dict(vision: Params, patch_size: int) -> dict:
    """A CLIP-style vision tree -> CLIPVisionModel's state dict (CPU float32
    tensors): the (P*P*3, D) patch kernel as the (D, 3, P, P) convolution
    weight, dense kernels transposed to (out, in)."""
    out: dict = {}
    emb = "vision_model.embeddings"
    kernel = vision["patch_embed"]["kernel"]
    conv = kernel.reshape(patch_size, patch_size, 3, kernel.shape[-1]).permute(3, 2, 0, 1)
    out[f"{emb}.class_embedding"] = _host(vision["class_embed"])
    out[f"{emb}.patch_embedding.weight"] = _host(conv)
    out[f"{emb}.position_embedding.weight"] = _host(vision["pos_embed"]["embedding"])
    _torch_ln(vision["pre_ln"], "vision_model.pre_layrnorm", out)
    for i in range(num_layers_of(vision["layers"])):
        li, prefix = layer_slice(vision["layers"], i), f"vision_model.encoder.layers.{i}"
        _torch_ln(li["ln1"], f"{prefix}.layer_norm1", out)
        _torch_mha(li["attn"], f"{prefix}.self_attn", out)
        _torch_ln(li["ln2"], f"{prefix}.layer_norm2", out)
        _torch_dense(li["fc1"], f"{prefix}.mlp.fc1", out)
        _torch_dense(li["fc2"], f"{prefix}.mlp.fc2", out)
    _torch_ln(vision["post_ln"], "vision_model.post_layernorm", out)
    return out


def to_torch_mbart_state_dict(shared: Params, decoder: Params,
                              final_logits_bias: torch.Tensor) -> dict:
    """The shared table, an mBART decoder tree and the logits bias -> the
    decoder side of MBartForConditionalGeneration's state dict (CPU float32
    tensors): ``model.shared``, ``model.decoder.*``, the tied ``lm_head``
    and ``model.decoder.embed_tokens`` as the same tensor as the shared
    table, and ``final_logits_bias`` (1, V)."""
    table = _host(shared["embedding"])
    out = {"model.shared.weight": table, "model.decoder.embed_tokens.weight": table,
           "lm_head.weight": table,
           "final_logits_bias": _host(final_logits_bias).reshape(1, -1)}
    dec = "model.decoder"
    out[f"{dec}.embed_positions.weight"] = _host(decoder["pos_embed"]["embedding"])
    _torch_ln(decoder["ln_embed"], f"{dec}.layernorm_embedding", out)
    if "final_ln" in decoder:
        _torch_ln(decoder["final_ln"], f"{dec}.layer_norm", out)
    for i in range(num_layers_of(decoder["layers"])):
        li, prefix = layer_slice(decoder["layers"], i), f"{dec}.layers.{i}"
        _torch_ln(li["ln_self"], f"{prefix}.self_attn_layer_norm", out)
        _torch_mha(li["self_attn"], f"{prefix}.self_attn", out)
        _torch_ln(li["ln_cross"], f"{prefix}.encoder_attn_layer_norm", out)
        _torch_mha(li["cross_attn"], f"{prefix}.encoder_attn", out)
        _torch_ln(li["ln_mlp"], f"{prefix}.final_layer_norm", out)
        _torch_dense(li["fc1"], f"{prefix}.fc1", out)
        _torch_dense(li["fc2"], f"{prefix}.fc2", out)
    return out


def to_torch_mbart_seq2seq_state_dict(params: Params) -> dict:
    """An MBartSeq2Seq tree (models/mbart_seq2seq.py) -> the whole of
    MBartForConditionalGeneration's state dict (CPU float32 tensors): the
    decoder side as ``to_torch_mbart_state_dict`` writes it, and the text
    encoder, ``model.encoder.embed_tokens`` the shared table."""
    out = to_torch_mbart_state_dict(params["shared"], params["decoder"],
                                    params["final_logits_bias"])
    enc, encoder = "model.encoder", params["encoder"]
    out[f"{enc}.embed_tokens.weight"] = out["model.shared.weight"]
    out[f"{enc}.embed_positions.weight"] = _host(encoder["pos_embed"]["embedding"])
    _torch_ln(encoder["ln_embed"], f"{enc}.layernorm_embedding", out)
    _torch_ln(encoder["final_ln"], f"{enc}.layer_norm", out)
    for i in range(num_layers_of(encoder["layers"])):
        li, prefix = layer_slice(encoder["layers"], i), f"{enc}.layers.{i}"
        _torch_ln(li["ln_self"], f"{prefix}.self_attn_layer_norm", out)
        _torch_mha(li["self_attn"], f"{prefix}.self_attn", out)
        _torch_ln(li["ln_mlp"], f"{prefix}.final_layer_norm", out)
        _torch_dense(li["fc1"], f"{prefix}.fc1", out)
        _torch_dense(li["fc2"], f"{prefix}.fc2", out)
    return out

"""Import HuggingFace checkpoints (CLIP, ViT, BART, mBART and the fused
captioner) into the port's param tree (mic_tpu/io/hf_import.py).

Three sources are understood:
1. HF *Flax* param trees (``FlaxCLIPVisionModel(...).params`` and the
   like, any array leaves) and ``flax_model.msgpack`` files, read by
   io/flax_msgpack.py;
2. HF *PyTorch* state dicts (``pytorch_model.bin`` through
   ``torch.load(..., weights_only=True)``, ``model.safetensors`` through
   io/safetensors_np.py): dense weights are transposed (out, in) -> (in,
   out), the patch convolution's (D, 3, P, P) weight is permuted to the
   Flax (P, P, 3, D) layout and then flattened like a Flax one;
3. on-disk checkpoint directories of both towers or of the fused model.

Every importer returns mic_tpu's key paths (models/*: ``patch_embed``,
``class_embed``, ``pos_embed``, ``pre_ln``/``post_ln`` and stacked
``layers`` for the vision tower; ``pos_embed``, ``ln_embed``, ``final_ln``
and stacked ``layers`` for the decoder; ``shared``, ``proj`` and
``final_logits_bias`` at the top) as float32 tensors on ``device`` (the
card unless the caller names another).  No leaf is rounded: a float32
source gives bit-equal leaves, a bfloat16 one its exact float32 values.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

from mic_tpu_torch.core.params import Params, resolve_device
from mic_tpu_torch.io import flax_msgpack, safetensors_np
from mic_tpu_torch.nn.layers import init_dense
from mic_tpu_torch.nn.stacked import init_stacked


def _t(x, device: torch.device) -> torch.Tensor:
    """Any array leaf -> a contiguous float32 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype != np.float32:
            a = a.astype(np.float32)
        if not a.flags.writeable:
            a = a.copy()
        x = torch.from_numpy(a)
    return x.detach().to(device=device, dtype=torch.float32).contiguous()


def _stack(per_layer: list) -> Params:
    """Per-layer trees -> one tree of stacked (L, ...) leaves."""
    return init_stacked(len(per_layer), iter(per_layer).__next__)


def _ln(p: Mapping, device) -> Params:
    return {"scale": _t(p["scale"], device), "bias": _t(p["bias"], device)}


def _dense(p: Mapping, device) -> Params:
    out = {"kernel": _t(p["kernel"], device)}
    if "bias" in p:
        out["bias"] = _t(p["bias"], device)
    return out


def _mha(p: Mapping, device) -> Params:
    return {"q": _dense(p["q_proj"], device), "k": _dense(p["k_proj"], device),
            "v": _dense(p["v_proj"], device), "o": _dense(p["out_proj"], device)}


def _patch_kernel(patch, device) -> torch.Tensor:
    """(P, P, C, H) conv kernel -> the (P*P*C, H) matmul layout."""
    kernel = _t(patch, device)
    p, _, c, h = kernel.shape
    return kernel.reshape(p * p * c, h)


# ---------------------------------------------------------------------------
# 1. HF Flax trees -> ours


def from_hf_clip_flax(clip_params: Mapping, device=None) -> Params:
    """FlaxCLIPVisionModel.params -> the vision tree."""
    device = resolve_device(device)
    vm = clip_params["vision_model"]
    emb = vm["embeddings"]
    layers = vm["encoder"]["layers"]
    per_layer = [
        {
            "ln1": _ln(li["layer_norm1"], device),
            "attn": _mha(li["self_attn"], device),
            "ln2": _ln(li["layer_norm2"], device),
            "fc1": _dense(li["mlp"]["fc1"], device),
            "fc2": _dense(li["mlp"]["fc2"], device),
        }
        for li in (layers[str(i)] for i in range(len(layers)))
    ]
    return {
        "patch_embed": {"kernel": _patch_kernel(emb["patch_embedding"]["kernel"], device)},
        "class_embed": _t(emb["class_embedding"], device),
        "pos_embed": {"embedding": _t(emb["position_embedding"]["embedding"], device)},
        "pre_ln": _ln(vm["pre_layrnorm"], device),
        "post_ln": _ln(vm["post_layernorm"], device),
        "layers": _stack(per_layer),
    }


def _decoder_layers_from_hf(layers: Mapping, device) -> Params:
    return _stack([
        {
            "ln_self": _ln(li["self_attn_layer_norm"], device),
            "self_attn": _mha(li["self_attn"], device),
            "ln_cross": _ln(li["encoder_attn_layer_norm"], device),
            "cross_attn": _mha(li["encoder_attn"], device),
            "ln_mlp": _ln(li["final_layer_norm"], device),
            "fc1": _dense(li["fc1"], device),
            "fc2": _dense(li["fc2"], device),
        }
        for li in (layers[str(i)] for i in range(len(layers)))
    ])


def from_hf_mbart_decoder_flax(decoder: Mapping, device=None) -> Params:
    device = resolve_device(device)
    return {
        "pos_embed": {"embedding": _t(decoder["embed_positions"]["embedding"], device)},
        "ln_embed": _ln(decoder["layernorm_embedding"], device),
        "final_ln": _ln(decoder["layer_norm"], device),
        "layers": _decoder_layers_from_hf(decoder["layers"], device),
    }


def from_hf_vit_flax(vit_params: Mapping, device=None) -> Params:
    """FlaxViTModel.params -> the vision tree of the ViT style
    (use_pre_ln=False, final_ln_output=True, patch_bias=True, gelu)."""
    device = resolve_device(device)
    emb = vit_params["embeddings"]
    projection = emb["patch_embeddings"]["projection"]
    kernel = _patch_kernel(projection["kernel"], device)
    hidden = kernel.shape[-1]
    layers = vit_params["encoder"]["layer"]
    per_layer = []
    for li in (layers[str(i)] for i in range(len(layers))):
        att = li["attention"]["attention"]
        per_layer.append({
            "ln1": _ln(li["layernorm_before"], device),
            "attn": {"q": _dense(att["query"], device), "k": _dense(att["key"], device),
                     "v": _dense(att["value"], device),
                     "o": _dense(li["attention"]["output"]["dense"], device)},
            "ln2": _ln(li["layernorm_after"], device),
            "fc1": _dense(li["intermediate"]["dense"], device),
            "fc2": _dense(li["output"]["dense"], device),
        })
    return {
        "patch_embed": {"kernel": kernel, "bias": _t(projection["bias"], device)},
        "class_embed": _t(emb["cls_token"], device).reshape(-1),
        "pos_embed": {"embedding": _t(emb["position_embeddings"], device).reshape(-1, hidden)},
        "post_ln": _ln(vit_params["layernorm"], device),
        "layers": _stack(per_layer),
    }


def _bias_or_zeros(params: Mapping, vocab: int, device) -> torch.Tensor:
    bias = params.get("final_logits_bias")
    if bias is None:
        return torch.zeros((vocab,), device=device)
    return _t(bias, device).reshape(-1)


def from_hf_bart_flax(bart_params: Mapping, device=None):
    """FlaxBartForConditionalGeneration.params -> (shared, decoder, bias).
    BART decoders are post-norm with no final layer_norm."""
    device = resolve_device(device)
    model = bart_params["model"] if "model" in bart_params else bart_params
    shared = {"embedding": _t(model["shared"]["embedding"], device)}
    dec = model["decoder"]
    decoder = {
        "pos_embed": {"embedding": _t(dec["embed_positions"]["embedding"], device)},
        "ln_embed": _ln(dec["layernorm_embedding"], device),
        "layers": _decoder_layers_from_hf(dec["layers"], device),
    }
    return shared, decoder, _bias_or_zeros(bart_params, shared["embedding"].shape[0], device)


def from_hf_mbart_encoder_flax(encoder: Mapping, device=None) -> Params:
    """An HF FlaxMBart text encoder tree -> the mbart_text tree."""
    device = resolve_device(device)
    layers = encoder["layers"]
    per_layer = [
        {
            "ln_self": _ln(li["self_attn_layer_norm"], device),
            "self_attn": _mha(li["self_attn"], device),
            "ln_mlp": _ln(li["final_layer_norm"], device),
            "fc1": _dense(li["fc1"], device),
            "fc2": _dense(li["fc2"], device),
        }
        for li in (layers[str(i)] for i in range(len(layers)))
    ]
    return {
        "pos_embed": {"embedding": _t(encoder["embed_positions"]["embedding"], device)},
        "ln_embed": _ln(encoder["layernorm_embedding"], device),
        "final_ln": _ln(encoder["layer_norm"], device),
        "layers": _stack(per_layer),
    }


def from_hf_mbart_seq2seq_flax(mbart_params: Mapping, device=None) -> Params:
    """FlaxMBartForConditionalGeneration.params -> the MBartSeq2Seq tree."""
    device = resolve_device(device)
    model = mbart_params["model"] if "model" in mbart_params else mbart_params
    shared, decoder, bias = from_hf_mbart_flax(mbart_params, device)
    return {
        "shared": shared,
        "encoder": from_hf_mbart_encoder_flax(model["encoder"], device),
        "decoder": decoder,
        "final_logits_bias": bias,
    }


def from_hf_mbart_flax(mbart_params: Mapping, device=None):
    """FlaxMBartForConditionalGeneration.params -> (shared, decoder,
    final_logits_bias)."""
    device = resolve_device(device)
    model = mbart_params["model"] if "model" in mbart_params else mbart_params
    shared = {"embedding": _t(model["shared"]["embedding"], device)}
    decoder = from_hf_mbart_decoder_flax(model["decoder"], device)
    return shared, decoder, _bias_or_zeros(mbart_params, shared["embedding"].shape[0], device)


def from_hf_fused_flax(fused_params: Mapping, device=None) -> Params:
    """The published fused checkpoint's Flax tree (model.shared,
    model.encoder.vision_model, model.decoder, model.visual_projection,
    lm_head, final_logits_bias) -> the captioner tree.  The tied lm_head is
    not read: the shared table is the head."""
    device = resolve_device(device)
    m = fused_params["model"]
    return {
        "shared": {"embedding": _t(m["shared"]["embedding"], device)},
        "vision": from_hf_clip_flax(m["encoder"], device),
        "proj": _dense(m["visual_projection"], device),
        "decoder": from_hf_mbart_decoder_flax(m["decoder"], device),
        "final_logits_bias": _t(fused_params["final_logits_bias"], device).reshape(-1),
    }


def _fresh_proj(d_in: int, d_out: int, generator: torch.Generator | None, device) -> Params:
    """A new visual projection, normal(0, 0.02) kernel and zero bias, drawn
    from ``generator`` (default: a CPU generator seeded 0) on the
    generator's device and moved to ``device``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    proj = init_dense(generator, d_in, d_out, 0.02, device=generator.device)
    return {name: leaf.to(device) for name, leaf in proj.items()}


def build_fused_params(clip_flax_params: Mapping, mbart_flax_params: Mapping,
                       proj: Params | None = None, generator: torch.Generator | None = None,
                       device=None) -> Params:
    """Graft two tower checkpoints into one captioner tree (the reference's
    ``from_clip_vision_mbart_pretrained`` fusion).  ``proj`` stays as given,
    or is drawn fresh from ``generator``: it is trained from scratch.
    mic_tpu draws its fresh ``proj`` from ``jax.random.PRNGKey(0)``, a
    stream torch cannot reproduce: with the same shape and std it is the
    one leaf that differs from mic_tpu's tree."""
    device = resolve_device(device)
    shared, decoder, bias = from_hf_mbart_flax(mbart_flax_params, device)
    vision = from_hf_clip_flax(clip_flax_params, device)
    if proj is None:
        proj = _fresh_proj(vision["patch_embed"]["kernel"].shape[-1],
                           shared["embedding"].shape[1], generator, device)
    return {"shared": shared, "vision": vision, "proj": proj, "decoder": decoder,
            "final_logits_bias": bias}


# ---------------------------------------------------------------------------
# 2. torch state dicts -> HF-Flax-shaped trees (then the maps above)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _unflatten_torch(state_dict: Mapping[str, Any]) -> dict:
    """'a.b.c' -> nested dict; Linear weights transposed to the (in, out)
    Flax kernel, conv weights (D, C, P, P) to (P, P, C, D), LayerNorm
    weights renamed scale.  Leaves stay torch views of the state dict."""
    tree: dict = {}
    for name, value in state_dict.items():
        arr = _tensor(value)
        *parents, leaf = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        if leaf == "weight":
            if arr.ndim == 2:
                node["kernel"] = arr.T
            elif arr.ndim == 4:
                node["kernel"] = arr.permute(2, 3, 1, 0)
            elif arr.ndim == 1:
                node["scale"] = arr
            else:
                node["kernel"] = arr
        elif leaf == "bias":
            node["bias"] = arr
        else:
            node[leaf] = arr
    return tree


def _fix_embeddings(tree: dict) -> dict:
    """Embedding tables came through as transposed 2-D kernels: undo that
    for the known embedding leaves."""
    def fix(node, name):
        if name in node and "kernel" in node[name]:
            node[name] = {"embedding": node[name]["kernel"].T}

    vm = tree.get("vision_model", {})
    if "embeddings" in vm:
        emb = vm["embeddings"]
        fix(emb, "position_embedding")
        if isinstance(emb.get("class_embedding"), dict):
            emb["class_embedding"] = emb["class_embedding"].get("kernel")
        if "scale" in emb.get("patch_embedding", {}):
            emb["patch_embedding"] = {"kernel": emb["patch_embedding"]["scale"]}
    model = tree.get("model", tree)
    if "shared" in model:
        fix(model, "shared")
    for side in ("encoder", "decoder"):
        sub = model.get(side)
        if isinstance(sub, dict):
            fix(sub, "embed_positions")
            fix(sub, "embed_tokens")
    return tree


def from_torch_clip_state_dict(state_dict: Mapping, device=None) -> Params:
    return from_hf_clip_flax(_fix_embeddings(_unflatten_torch(state_dict)), device)


def from_torch_mbart_state_dict(state_dict: Mapping, device=None):
    """An HF MBart(ForConditionalGeneration) state dict -> (shared, decoder,
    final_logits_bias)."""
    tree = _fix_embeddings(_unflatten_torch(state_dict))
    if "model" not in tree:
        tree = {"model": tree, "final_logits_bias": tree.pop("final_logits_bias", None)}
    tree["model"]["shared"] = (tree["model"].get("shared")
                               or tree["model"]["decoder"].get("embed_tokens"))
    return from_hf_mbart_flax(tree, device)


# ---------------------------------------------------------------------------
# 3. on-disk checkpoint directories

FLAX_WEIGHTS = "flax_model.msgpack"
SAFETENSORS_WEIGHTS = "model.safetensors"
TORCH_WEIGHTS = "pytorch_model.bin"


def _load_hf_weights_file(directory: str) -> dict:
    """The weights of an HF model directory: flax msgpack, safetensors or a
    torch bin, in that order -> {"format": "flax" | "torch", "tree": ...}."""
    path = os.path.join(directory, FLAX_WEIGHTS)
    if os.path.exists(path):
        return {"format": "flax", "tree": flax_msgpack.read_file(path)}
    path = os.path.join(directory, SAFETENSORS_WEIGHTS)
    if os.path.exists(path):
        return {"format": "torch", "tree": safetensors_np.load_file(path)}
    path = os.path.join(directory, TORCH_WEIGHTS)
    if os.path.exists(path):
        return {"format": "torch",
                "tree": torch.load(path, map_location="cpu", weights_only=True)}
    raise FileNotFoundError(f"no weights file found under {directory}")


def load_pretrained_towers(clip_dir: str, mbart_dir: str,
                           generator: torch.Generator | None = None, device=None) -> Params:
    """Fuse on-disk CLIP and mBART checkpoints into a captioner tree (the
    reference's ``from_clip_vision_mbart_pretrained``).  ``proj`` is drawn
    fresh from ``generator`` as in ``build_fused_params``: the one leaf that
    differs from mic_tpu's."""
    device = resolve_device(device)
    clip = _load_hf_weights_file(clip_dir)
    mbart = _load_hf_weights_file(mbart_dir)
    clip_tree = (clip["tree"] if clip["format"] == "flax"
                 else _fix_embeddings(_unflatten_torch(clip["tree"])))
    if mbart["format"] == "flax":
        shared, decoder, bias = from_hf_mbart_flax(mbart["tree"], device)
    else:
        shared, decoder, bias = from_torch_mbart_state_dict(mbart["tree"], device)
    vision = from_hf_clip_flax(clip_tree, device)
    return {
        "shared": shared,
        "vision": vision,
        "proj": _fresh_proj(vision["patch_embed"]["kernel"].shape[-1],
                            shared["embedding"].shape[1], generator, device),
        "decoder": decoder,
        "final_logits_bias": bias,
    }


def load_fused_checkpoint(directory: str, device=None) -> Params:
    """The published fused checkpoint directory (config.json +
    flax_model.msgpack) -> the captioner tree."""
    blob = _load_hf_weights_file(directory)
    if blob["format"] != "flax":
        raise ValueError("fused checkpoints are expected in flax msgpack format")
    return from_hf_fused_flax(blob["tree"], device)

"""The port's HF formats against mic_tpu's and the libraries mic_tpu calls.

- the flax msgpack codec (io/flax_msgpack.py) against
  ``flax.serialization``: each reads the other's bytes to equal arrays, and
  the port writes the same bytes;
- the safetensors codec (io/safetensors_np.py) against ``safetensors``;
- every importer of io/hf_import.py against mic_tpu's on tiny HF Flax
  models and torch state dicts built offline from configs: leaves
  bit-equal (a fresh ``proj``, drawn from torch's stream, matches in shape
  and scale only);
- the export (io/hf_export.py) both ways through the other package's
  import, ``from_pretrained`` and ``from_hf_json``.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mic_tpu.core.config import CaptionerConfig
from mic_tpu.io import hf_export as jax_export
from mic_tpu.io import hf_import as jax_import
from mic_tpu.models.captioner import Captioner as JaxCaptioner
from mic_tpu_torch.core import config as port_config
from mic_tpu_torch.core.params import tree_leaves
from mic_tpu_torch.io import flax_msgpack, hf_export, hf_import, safetensors_np
from mic_tpu_torch.io.from_jax import from_jax
from mic_tpu_torch.models.captioner import Captioner

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "clip_vit_b32_mbart50_config.json")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import torch_hf_towers  # noqa: E402


def _port(cfg):
    return getattr(port_config, type(cfg).__name__).from_dict(cfg.to_dict())


def _assert_trees_equal(got, ref, skip=()):
    """Every leaf of the port's tree bit-equal to mic_tpu's, same key paths."""
    ref = {path: leaf for path, leaf in tree_leaves(jax.device_get(ref))}
    got = dict(tree_leaves(got))
    assert got.keys() == ref.keys()
    for path, leaf in ref.items():
        if path[0] in skip:
            continue
        value = got[path]
        assert value.dtype == torch.float32 and value.device.type == "cpu", path
        np.testing.assert_array_equal(value.numpy(), np.asarray(leaf, np.float32),
                                      err_msg=str(path))


# ---------------------------------------------------------------------------
# tiny HF models, built offline from configs


def _clip_config():
    from transformers import CLIPVisionConfig

    return CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, image_size=32, patch_size=16)


def _mbart_config():
    from transformers import MBartConfig

    return MBartConfig(vocab_size=99, d_model=32, encoder_layers=2, decoder_layers=2,
                       encoder_attention_heads=4, decoder_attention_heads=4,
                       encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=64,
                       scale_embedding=True, dropout=0.0, attention_dropout=0.0,
                       activation_dropout=0.0)


@pytest.fixture(scope="module")
def hf():
    from transformers import (BartConfig, CLIPVisionModel, FlaxBartForConditionalGeneration,
                              FlaxCLIPVisionModel, FlaxMBartForConditionalGeneration,
                              FlaxViTModel, MBartForConditionalGeneration, ViTConfig)

    torch.manual_seed(0)
    bart = BartConfig(vocab_size=99, d_model=32, encoder_layers=2, decoder_layers=2,
                      encoder_attention_heads=4, decoder_attention_heads=4,
                      encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=64,
                      scale_embedding=False)
    vit = ViTConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                    num_attention_heads=4, image_size=32, patch_size=16)
    return {
        "clip": FlaxCLIPVisionModel(_clip_config(), seed=0).params,
        "vit": FlaxViTModel(vit, seed=0).params,
        "bart": FlaxBartForConditionalGeneration(bart, seed=0).params,
        "mbart": FlaxMBartForConditionalGeneration(_mbart_config(), seed=0).params,
        "clip_torch": CLIPVisionModel(_clip_config()).state_dict(),
        "mbart_torch": MBartForConditionalGeneration(_mbart_config()).state_dict(),
    }


# ---------------------------------------------------------------------------
# codecs


def _codec_tree():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "bf16": np.asarray(jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16)),
        "nested": {"i32": np.arange(7, dtype=np.int32), "empty": np.zeros((0, 2), np.float32),
                   "t": rng.normal(size=(6, 4)).astype(np.float32).T},
        "scalar": np.float32(2.5),
        "count": np.int64(-7),
        "long": rng.normal(size=(700,)).astype(np.float32),
    }


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32) if np.asarray(x).dtype.name == "bfloat16" else x


def _assert_codec_equal(got, ref):
    assert isinstance(got, dict) and got.keys() == ref.keys()
    for key, value in ref.items():
        if isinstance(value, dict):
            _assert_codec_equal(got[key], value)
        elif isinstance(value, np.generic):
            assert type(got[key]) is type(value) and got[key] == value, key
        else:
            np.testing.assert_array_equal(_as_np(got[key]), _as_np(value), err_msg=key)
            assert tuple(got[key].shape) == value.shape, key


@pytest.mark.parametrize("chunked", [False, True])
def test_msgpack_codec_matches_flax(chunked, monkeypatch):
    """float32, bfloat16, integer, empty and transposed arrays, numpy
    scalars, and (with MAX_CHUNK_SIZE patched small in both packages) leaves
    split under __msgpack_chunked_array__: flax reads the port's bytes, the
    port reads flax's, and the bytes are the same."""
    import flax.serialization as fs

    if chunked:
        monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 256)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 256)
    tree = _codec_tree()
    ours, theirs = flax_msgpack.serialize(tree), fs.msgpack_serialize(tree)
    if chunked:
        assert b"__msgpack_chunked_array__" in ours
    assert ours == theirs
    _assert_codec_equal(fs.msgpack_restore(ours), tree)
    _assert_codec_equal(flax_msgpack.restore(theirs), tree)
    # a torch bfloat16 tensor is written as flax writes bfloat16
    bf = torch.randn(4, 3, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    back = fs.msgpack_restore(flax_msgpack.serialize({"w": bf}))["w"]
    assert back.dtype.name == "bfloat16"
    np.testing.assert_array_equal(back.astype(np.float32), bf.float().numpy())


def test_msgpack_file_is_read_into_one_buffer(tmp_path):
    """read_file's arrays are views of one buffer, not copies."""
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4), "b": {"c": np.ones(5, np.int8)}}
    path = str(tmp_path / "t.msgpack")
    assert flax_msgpack.write_file(path, tree) == os.path.getsize(path)
    back = flax_msgpack.read_file(path)
    _assert_codec_equal(back, tree)
    a, c = back["a"], back["b"]["c"]
    assert not a.flags.owndata and not c.flags.owndata
    assert 0 < c.ctypes.data - a.ctypes.data < os.path.getsize(path)


def test_safetensors_codec_matches_safetensors(tmp_path):
    """The port reads safetensors' files as safetensors.numpy.load_file
    does (BF16 as torch bfloat16), and safetensors reads the port's."""
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as torch_load_file
    from safetensors.torch import save_file as torch_save_file

    rng = np.random.default_rng(1)
    arrays = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "h": rng.normal(size=(5,)).astype(np.float16),
              "ids": np.arange(6, dtype=np.int64).reshape(2, 3), "s": np.zeros((), np.float32)}
    save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got = safetensors_np.load_file(str(tmp_path / "a.safetensors"))
    ref = load_file(str(tmp_path / "a.safetensors"))
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape
        np.testing.assert_array_equal(got[key], ref[key])

    safetensors_np.save_file(arrays, str(tmp_path / "b.safetensors"))
    back = load_file(str(tmp_path / "b.safetensors"))
    for key in arrays:
        np.testing.assert_array_equal(back[key], arrays[key])

    bf = {"x": torch.randn(3, 2).to(torch.bfloat16)}
    torch_save_file(bf, str(tmp_path / "c.safetensors"))
    assert torch.equal(safetensors_np.load_file(str(tmp_path / "c.safetensors"))["x"], bf["x"])
    safetensors_np.save_file(bf, str(tmp_path / "d.safetensors"))
    assert torch.equal(torch_load_file(str(tmp_path / "d.safetensors"))["x"], bf["x"])


# ---------------------------------------------------------------------------
# importers


def test_flax_tower_importers_match_mic_tpu(hf):
    """from_hf_clip_flax, from_hf_vit_flax, from_hf_bart_flax,
    from_hf_mbart_flax (and its decoder map), from_hf_mbart_encoder_flax
    and from_hf_mbart_seq2seq_flax: every leaf bit-equal."""
    _assert_trees_equal(hf_import.from_hf_clip_flax(hf["clip"], "cpu"),
                        jax_import.from_hf_clip_flax(hf["clip"]))
    _assert_trees_equal(hf_import.from_hf_vit_flax(hf["vit"], "cpu"),
                        jax_import.from_hf_vit_flax(hf["vit"]))
    for name, port_fn, jax_fn in (
            ("bart", hf_import.from_hf_bart_flax, jax_import.from_hf_bart_flax),
            ("mbart", hf_import.from_hf_mbart_flax, jax_import.from_hf_mbart_flax)):
        got, ref = port_fn(hf[name], "cpu"), jax_fn(hf[name])
        _assert_trees_equal(dict(zip(("shared", "decoder", "bias"), got)),
                            dict(zip(("shared", "decoder", "bias"), ref)))
    model = hf["mbart"]["model"]
    _assert_trees_equal(hf_import.from_hf_mbart_decoder_flax(model["decoder"], "cpu"),
                        jax_import.from_hf_mbart_decoder_flax(model["decoder"]))
    _assert_trees_equal(hf_import.from_hf_mbart_encoder_flax(model["encoder"], "cpu"),
                        jax_import.from_hf_mbart_encoder_flax(model["encoder"]))
    _assert_trees_equal(hf_import.from_hf_mbart_seq2seq_flax(hf["mbart"], "cpu"),
                        jax_import.from_hf_mbart_seq2seq_flax(hf["mbart"]))


def test_fused_importers_match_mic_tpu(hf):
    """from_hf_fused_flax on a fused tree; build_fused_params: every leaf
    but the fresh proj bit-equal, proj of mic_tpu's shape and std 0.02, and
    a given proj kept."""
    fused = {
        "model": {"shared": hf["mbart"]["model"]["shared"], "encoder": hf["clip"],
                  "decoder": hf["mbart"]["model"]["decoder"],
                  "visual_projection": {"kernel": np.full((32, 32), 0.5, np.float32),
                                        "bias": np.arange(32, dtype=np.float32)}},
        "final_logits_bias": hf["mbart"]["final_logits_bias"],
    }
    _assert_trees_equal(hf_import.from_hf_fused_flax(fused, "cpu"),
                        jax_import.from_hf_fused_flax(fused))
    got = hf_import.build_fused_params(hf["clip"], hf["mbart"], device="cpu",
                                       generator=torch.Generator().manual_seed(3))
    ref = jax_import.build_fused_params(hf["clip"], hf["mbart"])
    _assert_trees_equal(got, ref, skip=("proj",))
    assert got["proj"]["kernel"].shape == ref["proj"]["kernel"].shape
    assert abs(got["proj"]["kernel"].std().item() - 0.02) < 0.005
    assert not got["proj"]["bias"].any()
    given = {"kernel": torch.ones(32, 32), "bias": torch.zeros(32)}
    assert hf_import.build_fused_params(hf["clip"], hf["mbart"], proj=given,
                                        device="cpu")["proj"] is given


def test_torch_state_dict_importers_match_mic_tpu(hf):
    """from_torch_clip_state_dict and from_torch_mbart_state_dict (through
    _unflatten_torch and _fix_embeddings): every leaf bit-equal."""
    _assert_trees_equal(hf_import.from_torch_clip_state_dict(hf["clip_torch"], "cpu"),
                        jax_import.from_torch_clip_state_dict(hf["clip_torch"]))
    got = hf_import.from_torch_mbart_state_dict(hf["mbart_torch"], "cpu")
    ref = jax_import.from_torch_mbart_state_dict(hf["mbart_torch"])
    _assert_trees_equal(dict(zip(("shared", "decoder", "bias"), got)),
                        dict(zip(("shared", "decoder", "bias"), ref)))


@pytest.mark.parametrize("formats", [("flax", "flax"), ("safetensors", "bin"),
                                     ("bin", "safetensors")])
def test_load_pretrained_towers_matches_mic_tpu(hf, tmp_path, formats):
    """Tower directories in each weights format (flax msgpack written by
    flax; model.safetensors by safetensors; pytorch_model.bin by torch):
    every leaf but proj bit-equal to mic_tpu's load_pretrained_towers."""
    import flax.serialization as fs
    from safetensors.torch import save_file

    def write(directory, fmt, flax_tree, state_dict):
        os.makedirs(directory)
        if fmt == "flax":
            with open(os.path.join(directory, "flax_model.msgpack"), "wb") as f:
                f.write(fs.msgpack_serialize(jax.device_get(flax_tree)))
        elif fmt == "safetensors":
            save_file({k: v.contiguous() for k, v in state_dict.items()
                       if "embed_tokens" not in k and k != "lm_head.weight"},
                      os.path.join(directory, "model.safetensors"))
        else:
            torch.save(state_dict, os.path.join(directory, "pytorch_model.bin"))

    clip_dir, mbart_dir = str(tmp_path / "clip"), str(tmp_path / "mbart")
    write(clip_dir, formats[0], hf["clip"], hf["clip_torch"])
    write(mbart_dir, formats[1], hf["mbart"], hf["mbart_torch"])
    got = hf_import.load_pretrained_towers(clip_dir, mbart_dir, device="cpu")
    ref = jax_import.load_pretrained_towers(clip_dir, mbart_dir)
    _assert_trees_equal(got, ref, skip=("proj",))
    assert got["proj"]["kernel"].shape == ref["proj"]["kernel"].shape
    with pytest.raises(FileNotFoundError):
        hf_import.load_pretrained_towers(str(tmp_path), mbart_dir, device="cpu")


# ---------------------------------------------------------------------------
# export


def _numpy_params(config, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JaxCaptioner(config).init_params, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: ((1.0 if path[-1].key == "scale" else 0.0)
                            + 0.3 * rng.normal(size=leaf.shape)).astype(np.float32), shapes)


def test_export_round_trips_both_ways(tmp_path):
    """The port's export read by mic_tpu's load_fused_checkpoint and
    from_hf_json, mic_tpu's export by the port's from_pretrained: params
    bit-equal and configs equal both ways; the two msgpack files are the
    same bytes and the two config.json files the same JSON."""
    config = CaptionerConfig.tiny(generation=CaptionerConfig.tiny().generation.replace(
        max_length=33, num_beams=5, length_penalty=0.8))
    tree = _numpy_params(config)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    nbytes = hf_export.export_hf_fused(from_jax(tree), _port(config), port_dir)
    jax_export.export_hf_fused(jax.tree.map(jnp.asarray, tree), config, jax_dir)
    assert nbytes == os.path.getsize(os.path.join(port_dir, "flax_model.msgpack"))

    _assert_trees_equal(from_jax(tree), jax_import.load_fused_checkpoint(port_dir))
    model, params = Captioner.from_pretrained(jax_dir, device="cpu")
    _assert_trees_equal(params, tree)
    assert (model.config.to_dict()
            == _port(CaptionerConfig.from_hf_json(os.path.join(port_dir, "config.json")))
            .to_dict())
    with open(os.path.join(port_dir, "flax_model.msgpack"), "rb") as a, \
            open(os.path.join(jax_dir, "flax_model.msgpack"), "rb") as b:
        assert a.read() == b.read()
    with open(os.path.join(port_dir, "config.json")) as a, \
            open(os.path.join(jax_dir, "config.json")) as b:
        assert json.load(a) == json.load(b)
    g = model.config.generation
    assert (g.max_length, g.num_beams, g.length_penalty) == (33, 5, 0.8)


_NOT_EXPORTABLE = {
    "untied_head": dict(tie_word_embeddings=False),
    "vit_tower": dict(vision=dict(use_pre_ln=False, final_ln_output=True, patch_bias=True)),
    "post_norm": dict(decoder=dict(post_norm=True, use_final_ln=False)),
    "no_final_ln": dict(decoder=dict(use_final_ln=False)),
}


@pytest.mark.parametrize("kind", sorted(_NOT_EXPORTABLE))
def test_export_refuses_what_the_format_cannot_hold(kind, tmp_path):
    """An untied head, the ViT tower style and a decoder without its final
    LN raise a ValueError naming ROADMAP §C and write nothing, where
    mic_tpu's export would write a file that reads back as another model;
    the tied CLIP+mBART style still exports."""
    from mic_tpu_torch.models.captioner import init_params

    base = port_config.CaptionerConfig.tiny()
    change = dict(_NOT_EXPORTABLE[kind])
    if "vision" in change:
        change["vision"] = base.vision.replace(**change["vision"])
    if "decoder" in change:
        change["decoder"] = base.decoder.replace(**change["decoder"])
    config = base.replace(**change)
    params = init_params(config, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="ROADMAP §C"):
        hf_export.export_hf_fused(params, config, str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out")
    tied = init_params(base, torch.Generator().manual_seed(0), "cpu")
    assert hf_export.export_hf_fused(tied, base, str(tmp_path / "tied")) > 0


def test_from_pretrained_of_an_export_generates_as_mic_tpu(tmp_path):
    """A beam-4 generate of the port's from_pretrained on mic_tpu's export
    equals mic_tpu's from_pretrained + generate token for token."""
    from mic_tpu.ops.image_prep import preprocess_images as jax_preprocess
    from mic_tpu_torch.ops.image_prep import preprocess_images

    config = CaptionerConfig.tiny()
    jax_export.export_hf_fused(jax.tree.map(jnp.asarray, _numpy_params(config, 1)), config,
                               str(tmp_path))
    jmodel, jparams = JaxCaptioner.from_pretrained(str(tmp_path))
    model, params = Captioner.from_pretrained(str(tmp_path), device="cpu")
    u8 = np.random.default_rng(2).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    kw = dict(max_length=8, num_beams=4, forced_bos_token_id=5)
    ref = jax.jit(lambda p, x: jmodel.generate(p, jax_preprocess(x, 32), **kw))(
        jparams, jnp.asarray(u8))
    out = model.generate(params, preprocess_images(torch.from_numpy(u8), 32), **kw)
    np.testing.assert_array_equal(out.sequences.numpy(), np.asarray(ref.sequences))


def test_published_config_fixture_parses_alike():
    """The reconstructed published config.json parses to the same
    CaptionerConfig in both packages."""
    ref = CaptionerConfig.from_hf_json(FIXTURE)
    got = port_config.CaptionerConfig.from_hf_json(FIXTURE)
    assert got.to_dict() == ref.to_dict()
    assert got.decoder.vocab_size == 250054 and got.vision.patch_size == 32


def test_tower_state_dicts_load_back_and_into_hf(hf):
    """tools/torch_hf_towers.py's to_torch_clip_state_dict and
    to_torch_mbart_state_dict (chip_smoke.py's tower writers): read back by
    both packages' state-dict importers to the trees they came from, and
    taken by HF's CLIPVisionModel and MBartForConditionalGeneration (every
    CLIP key; every decoder-side mBART key) with their names and shapes."""
    from transformers import CLIPVisionModel, MBartForConditionalGeneration

    vision = hf_import.from_hf_clip_flax(hf["clip"], "cpu")
    shared, decoder, bias = hf_import.from_hf_mbart_flax(hf["mbart"], "cpu")
    clip_sd = torch_hf_towers.to_torch_clip_state_dict(vision, 16)
    mbart_sd = torch_hf_towers.to_torch_mbart_state_dict(shared, decoder, bias)
    _assert_trees_equal(hf_import.from_torch_clip_state_dict(clip_sd, "cpu"),
                        jax_import.from_hf_clip_flax(hf["clip"]))
    _assert_trees_equal(hf_import.from_torch_clip_state_dict(clip_sd, "cpu"),
                        jax_import.from_torch_clip_state_dict(clip_sd))
    got = hf_import.from_torch_mbart_state_dict(mbart_sd, "cpu")
    ref = jax_import.from_hf_mbart_flax(hf["mbart"])
    _assert_trees_equal(dict(zip(("shared", "decoder", "bias"), got)),
                        dict(zip(("shared", "decoder", "bias"), ref)))

    missing, unexpected = CLIPVisionModel(_clip_config()).load_state_dict(clip_sd, strict=False)
    assert not unexpected and all("position_ids" in key for key in missing)
    hf_mbart = MBartForConditionalGeneration(_mbart_config())
    missing, unexpected = hf_mbart.load_state_dict(mbart_sd, strict=False)
    assert not unexpected and all(key.startswith("model.encoder.") for key in missing)
    assert torch.equal(hf_mbart.model.decoder.layers[1].fc2.weight,
                       decoder["layers"]["fc2"]["kernel"][1].T)

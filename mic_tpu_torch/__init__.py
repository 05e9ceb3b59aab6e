"""mic_tpu_torch: the PyTorch + CUDA port of mic_tpu for NVIDIA Hopper.

Package map (mic_tpu's, module for module):
  core/      config tree (a copy of mic_tpu's), dtype map, knobs, devices
  ops/       the CUDA kernels' wrappers (csrc/) beside their plain versions
  nn/        transformer building blocks + KV caches
  models/    ViT encoder (CLIP and ViT styles), mBART/BART decoder, the
             captioner, the mBART text encoder and the mBART-50 translator
  io/        torch.save checkpoints and model directories, from_jax, the HF
             formats (flax msgpack, safetensors; import, export), the hub
  data/      TSV datasets, loader, tokenizers, image decoding
  generate/  logits processors + greedy/sample/beam search
  train/     loss, schedule, fused AdamW, shadow params, train state, trainer
  evals/     BLEU
  cli/       train / evaluate / caption / push entry points
"""

__version__ = "0.1.0"

# Lazy top-level API (PEP 562): `import mic_tpu_torch` imports no torch, so
# the loader's spawn workers do not pay for it on boot.
_API = {
    "CaptionerConfig": "mic_tpu_torch.core.config",
    "DecoderConfig": "mic_tpu_torch.core.config",
    "VisionConfig": "mic_tpu_torch.core.config",
    "GenerationConfig": "mic_tpu_torch.core.config",
    "Captioner": "mic_tpu_torch.models.captioner",
    "MBartSeq2Seq": "mic_tpu_torch.models.mbart_seq2seq",
}


def __getattr__(name):
    if name in _API:
        import importlib

        return getattr(importlib.import_module(_API[name]), name)
    raise AttributeError(f"module 'mic_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_API))

"""Hugging Face Hub interop: hub ids for ``from_pretrained`` and
``push_to_hub`` (mic_tpu/io/hub.py).

Model I/O is local-directory based; this module maps a hub repo id onto a
local snapshot directory with ``huggingface_hub`` where it is installed and
the hub (or its local cache, under HF_HUB_OFFLINE=1) can serve it, and
fails with an actionable message where not.  ``huggingface_hub`` is
imported inside the functions only: nothing else of the port needs it.
"""

from __future__ import annotations

import os
from typing import Optional

# weight and asset files a fused checkpoint snapshot may need
_ALLOW_PATTERNS = [
    "*.json",
    "*.msgpack",
    "*.safetensors",
    "*.bin",
    "*.model",
    "*.txt",
    "tokenizer*",
    "sentencepiece*",
]


def is_local_dir(name_or_path: str) -> bool:
    return os.path.isdir(name_or_path)


def resolve_model_dir(name_or_path: str, revision: Optional[str] = None,
                      cache_dir: Optional[str] = None) -> str:
    """A local directory for ``name_or_path``: a local directory passes
    through untouched; anything else is a hub repo id, resolved to a
    snapshot directory (served from the local hub cache when offline)."""
    if is_local_dir(name_or_path):
        return name_or_path
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise FileNotFoundError(
            f"{name_or_path!r} is not a local directory and huggingface_hub "
            "is unavailable; pass a local model directory instead"
        ) from e
    try:
        return snapshot_download(repo_id=name_or_path, revision=revision,
                                 cache_dir=cache_dir, allow_patterns=_ALLOW_PATTERNS)
    except Exception as e:
        raise FileNotFoundError(
            f"could not resolve {name_or_path!r}: not a local directory, and "
            f"the hub lookup failed ({type(e).__name__}: {e}). If you are "
            "offline, download the checkpoint elsewhere and pass its path, "
            "or pre-populate the HF cache and set HF_HUB_OFFLINE=1."
        ) from e


def push_to_hub(directory: str, repo_id: str, private: bool = False,
                commit_message: str = "Upload mic_tpu model",
                token: Optional[str] = None) -> str:
    """Upload a saved model directory to the Hub -> the repo URL.  An
    explicit step after training (``Captioner.push_to_hub``, ``python -m
    mic_tpu_torch.cli.push``): it needs the network and credentials."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"model directory not found: {directory}")
    from huggingface_hub import HfApi

    api = HfApi(token=token)
    repo = api.create_repo(repo_id=repo_id, private=private, exist_ok=True)
    api.upload_folder(folder_path=directory, repo_id=repo_id, commit_message=commit_message)
    return str(repo)

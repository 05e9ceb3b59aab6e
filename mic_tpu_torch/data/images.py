"""Host-side image decode: JPEG/PNG file -> fixed-size uint8 square crop.

The host does the minimum irregular work (decode + shortest-side resize +
center crop to a fixed square); everything dtype/shape-regular (bicubic
resize to the model's input size, normalization, dtype cast) happens on device
(mic_tpu/ops/image_prep.py).  Replaces torchvision's C++ read_image +
jit-scripted Transform (reference main.py:22, 165-179, 225).

The port's own copy of mic_tpu/data/images.py.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageFile

# tolerate truncated files like the reference (main.py:38-39)
ImageFile.LOAD_TRUNCATED_IMAGES = True


def load_image(path: str, size: int = 256) -> np.ndarray:
    """Decode -> RGB -> shortest side to `size` -> center crop.
    Returns (size, size, 3) uint8.

    JPEGs go through the native libjpeg path when built (scale-on-decode +
    resize + crop in one C++ pass, tools/build_native.sh); everything else
    (and any native failure) uses PIL."""
    if path.lower().endswith((".jpg", ".jpeg")):
        from mic_tpu_torch.data import native

        if native.available():
            with open(path, "rb") as f:
                out = native.decode_jpeg(f.read(), size)
            if out is not None:
                return out
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = size / min(w, h)
        nw, nh = max(size, round(w * scale)), max(size, round(h * scale))
        # draft() lets PIL use libjpeg's fast scaled decode for big JPEGs
        im.draft("RGB", (nw, nh))
        w, h = im.size
        scale = size / min(w, h)
        nw, nh = max(size, round(w * scale)), max(size, round(h * scale))
        im = im.resize((nw, nh), Image.BICUBIC)
        left, top = (nw - size) // 2, (nh - size) // 2
        im = im.crop((left, top, left + size, top + size))
        return np.asarray(im, np.uint8)


def load_image_safe(path: str, size: int = 256) -> np.ndarray | None:
    try:
        return load_image(path, size)
    except Exception:
        return None

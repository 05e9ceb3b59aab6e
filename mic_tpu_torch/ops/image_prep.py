"""Image preprocessing on the device: antialiased bicubic resize as two
matmuls, then the CLIP normalize (mic_tpu/ops/image_prep.py).

uint8 square crops cross to the device as bytes; the resize is
(S_out x S_in) @ img @ (S_in x S_out) with Keys-cubic (a = -0.5) weights,
widened when downscaling (PIL / torchvision / jax.image.resize semantics).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# CLIP pixel statistics
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
        np.where(ax < 2.0, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a, 0.0),
    )


@functools.lru_cache(maxsize=32)
def resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) row-normalized antialiased bicubic interpolation matrix."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    scale = src / dst
    support = 2.0 * max(scale, 1.0)
    centers = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    cols = np.arange(src, dtype=np.float64)
    dist = (centers[:, None] - cols[None, :]) / max(scale, 1.0)
    weights = _cubic(dist) * (np.abs(centers[:, None] - cols[None, :]) <= support)
    weights /= weights.sum(axis=1, keepdims=True)
    return weights.astype(np.float32)


def preprocess_images(images_u8: torch.Tensor, out_size: int = 224,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, S, S, 3) uint8 square crops -> normalized (B, out, out, 3) in dtype."""
    device = images_u8.device
    src = images_u8.shape[1]
    x = images_u8.float() / 255.0
    if src != out_size:
        w = torch.from_numpy(resize_matrix(src, out_size)).to(device)
        x = torch.einsum("os,bshc->bohc", w, x)
        x = torch.einsum("os,bhsc->bhoc", w, x)
    mean = torch.from_numpy(CLIP_MEAN).to(device)
    std = torch.from_numpy(CLIP_STD).to(device)
    return ((x - mean) / std).to(dtype)


def maybe_preprocess(pixel_values: torch.Tensor, image_size: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """Train/eval steps take either raw uint8 crops (resized and normalized
    here) or ready float images (cast to ``dtype``)."""
    if pixel_values.dtype == torch.uint8:
        return preprocess_images(pixel_values, image_size, dtype)
    return pixel_values.to(dtype)

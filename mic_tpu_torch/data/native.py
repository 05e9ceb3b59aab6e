"""ctypes binding for the native host-decode library (native/fast_decode.cc).

Loads mic_tpu_torch/data/_fast_decode.so when present and exposes
`decode_jpeg(path_or_bytes, size)`; the loader prefers it for JPEG files and
decodes everything else (PNG, grayscale, failures) with PIL on the host.
Build it from the repository root with

    g++ -O3 -shared -fPIC -o mic_tpu_torch/data/_fast_decode.so native/fast_decode.cc -ljpeg

The port's own copy of mic_tpu/data/native.py, with a library path of its own.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        path = os.path.join(os.path.dirname(__file__), "_fast_decode.so")
        if os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
                lib.mic_decode_jpeg.restype = ctypes.c_int
                lib.mic_decode_jpeg.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8),
                ]
                try:
                    lib.mic_validate_jpeg.restype = ctypes.c_int
                    lib.mic_validate_jpeg.argtypes = [
                        ctypes.c_char_p, ctypes.c_size_t,
                    ]
                except AttributeError:  # older .so without the validator
                    pass
                _LIB = lib
            except OSError:
                _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def validate_jpeg(data: bytes) -> Optional[bool]:
    """Full-stream JPEG validity check at 1/8 DCT scale in C, off-GIL
    (the downloader's content check — a corrupt/truncated stream fails the
    entropy decode).  None when the native library (or the symbol, in an
    older build) is unavailable; callers fall back to a PIL decode."""
    lib = _load()
    if lib is None or not hasattr(lib, "mic_validate_jpeg"):
        return None
    return lib.mic_validate_jpeg(data, len(data)) == 0


def decode_jpeg(data: bytes, size: int) -> Optional[np.ndarray]:
    """JPEG bytes -> (size, size, 3) uint8 center crop, or None on failure."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.mic_decode_jpeg(
        data, len(data), size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out if rc == 0 else None

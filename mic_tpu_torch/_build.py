"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library under ``build/mic_tpu_torch/`` at the repository root, at
first use, and loaded with ``ctypes``: each kernel has a plain C entry point
that takes raw pointers, sizes and the CUDA stream, launches on that stream
and returns ``cudaGetLastError()``.  The library name carries a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_BUILD_DIR = _PKG.parent / "build" / "mic_tpu_torch"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes; every entry point returns a cudaError_t as int
_SIGNATURES = {
    # q, cache_k, cache_v, k_step, v_step, ancestry, out,
    # batch, beams, t_max, heads, head_dim, index, stream
    "mic_lazy_attention_bf16": [_P] * 7 + [_I] * 6 + [_P],
    # hidden, weight, bias, l_out, rmax_out, rid_out, l_part, rmax_part,
    # rid_part, n, d, vocab, splits, stream
    "mic_fused_head_bucket_bf16": [_P] * 9 + [_I] * 4 + [_P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def build() -> Path:
    """Compile csrc/*.cu into the build directory unless an up-to-date
    library is there already; returns the library path."""
    sources = sorted((_PKG / "csrc").glob("*.cu"))
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    lib_path = _BUILD_DIR / f"libmic_tpu_torch_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = loaded
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")

"""The safetensors format, read and written in plain Python and numpy (what
mic_tpu/io/hf_import.py reads with ``safetensors.numpy.load_file``).

A file is an 8-byte little-endian header length, a JSON header mapping each
tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets
into the data after the header; an optional ``"__metadata__"`` map of
strings), then the raw little-endian bytes.  ``load_file`` reads the file
into one buffer and returns each tensor as a numpy view into it; numpy has
no bfloat16, so BF16 tensors come back as torch bfloat16 tensors over the
same bytes.  ``save_file`` writes numpy arrays or torch tensors.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
           "I32": np.int32, "I16": np.int16, "I8": np.int8, "U64": np.uint64,
           "U32": np.uint32, "U16": np.uint16, "U8": np.uint8, "BOOL": np.bool_}
_NAMES = {np.dtype(v).name: k for k, v in _DTYPES.items()}


def load_file(path: str) -> dict:
    """-> {name: array}, each a view into one buffer holding the file."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"short read of {path}")
    mv = memoryview(buf)
    (n,) = struct.unpack("<Q", mv[:8])
    header = json.loads(str(mv[8:8 + n], "utf-8"))
    header.pop("__metadata__", None)
    data = mv[8 + n:]
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        piece, shape = data[begin:end], info["shape"]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(piece, dtype=np.int16).reshape(shape)
            out[name] = torch.from_numpy(bits).view(torch.bfloat16)
        else:
            out[name] = np.frombuffer(piece, dtype=_DTYPES[info["dtype"]]).reshape(shape)
    return out


def _as_numpy(x) -> tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "BF16"
        x = x.numpy()
    x = np.asarray(x)
    if not x.flags.c_contiguous:
        x = np.ascontiguousarray(x)
    return x, _NAMES[x.dtype.name]


def save_file(tensors: dict, path: str) -> int:
    """Write {name: array or tensor} to ``path``, flushed to disk -> bytes."""
    arrays = {name: _as_numpy(tensors[name]) for name in sorted(tensors)}
    header, offset = {}, 0
    for name, (arr, dtype) in arrays.items():
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * ((-len(raw)) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for arr, _ in arrays.values():
            f.write(memoryview(arr.reshape(-1).view(np.uint8)))
        f.flush()
        os.fsync(f.fileno())
        return f.tell()

"""flax's msgpack checkpoint format, read and written in plain Python and
numpy (the format of ``flax.serialization.msgpack_serialize`` and
``msgpack_restore``, which mic_tpu/io/hf_import.py and hf_export.py call).

The format: a msgpack map of string-keyed maps whose leaves are
  - an ndarray: msgpack ExtType 1 holding the packed array
    ``[shape, dtype name, C-order bytes]`` (the name is numpy's, with
    ``"bfloat16"`` for bfloat16);
  - a numpy scalar: ExtType 3, the same payload with shape ``[]``;
  - a leaf of more than ``MAX_CHUNK_SIZE`` bytes: the map
    ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
    "chunks": {"0": flat piece, ...}}`` of flat pieces of at most
    ``MAX_CHUNK_SIZE`` bytes;
  - python scalars, strings and None as msgpack's own.

``restore`` decodes from one buffer: each array is a view into it (a
chunked leaf is joined once), so a file is held once in memory.  numpy has
no bfloat16: bfloat16 leaves come back as torch bfloat16 tensors over the
same bytes.  ``serialize`` writes maps with their keys sorted, as flax's
tree_map copy leaves them, and streams each array's bytes to the file.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# ---------------------------------------------------------------------------
# reading


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("truncated msgpack data")
        return self.buf[start:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        end = self.pos + n
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, name, data = self.value()
        if self.pos != end:
            raise ValueError("malformed ndarray ext payload")
        arr = _array(data, str(name, "utf-8") if isinstance(name, memoryview) else name, shape)
        return arr[()] if code == _EXT_NPSCALAR and isinstance(arr, np.ndarray) else arr


def _array(data: memoryview, name: str, shape):
    """A view of ``data`` as an array of dtype ``name``."""
    if name == "bfloat16":
        bits = np.frombuffer(data, dtype=np.int16).reshape(shape)
        if not bits.flags.writeable:  # a read-only source (bytes): torch takes a copy
            bits = bits.copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def restore(buf) -> Any:
    """Decode msgpack bytes (any buffer) -> the nested tree, arrays as views
    into ``buf``."""
    reader = _Reader(buf)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack tree")
    return _unchunk(tree)


def read_file(path: str) -> Any:
    """Read a flax msgpack file into one buffer and decode it."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        buf = bytearray(f.tell())
        f.seek(0)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"short read of {path}")
    return restore(buf)


# ---------------------------------------------------------------------------
# writing


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"),
                              (0, 0xFFFFFFFF, 0xCE, ">I"), (0, 2**64 - 1, 0xCF, ">Q"),
                              (-2**7, 2**7 - 1, 0xD0, ">b"), (-2**15, 2**15 - 1, 0xD1, ">h"),
                              (-2**31, 2**31 - 1, 0xD2, ">i"), (-2**63, 2**63 - 1, 0xD3, ">q")):
        if lo <= v <= hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer out of msgpack range: {v}")


def _header(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """A length header: the fix form where n fits it, else 8/16/32-bit."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, limit in codes:
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object too large: {n}")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _header(len(raw), 0xA0, 31, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF),
                                        (0xDB, ">I", 0xFFFFFFFF))) + raw


def _bin_header(n: int) -> bytes:
    return _header(n, None, 0, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF),
                                (0xC6, ">I", 0xFFFFFFFF)))


def _array_header(n: int) -> bytes:
    return _header(n, 0x90, 15, ((None, "", 0), (0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)))


def _map_header(n: int) -> bytes:
    return _header(n, 0x80, 15, ((None, "", 0), (0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)))


def _ext_header(n: int, code: int) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        head = bytes([fixext[n]])
    else:
        head = _header(n, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                    (0xC9, ">I", 0xFFFFFFFF)))
    return head + struct.pack(">b", code)


def _as_numpy(x) -> tuple[np.ndarray, str]:
    """(C-contiguous array whose bytes are stored, dtype name)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    if not x.flags.c_contiguous:
        x = np.ascontiguousarray(x)
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not stored")
    return x, x.dtype.name


def _write_array(out: BinaryIO, x, code: int) -> None:
    arr, name = _as_numpy(x)
    head = _array_header(3) + _array_header(arr.ndim) + b"".join(_int(int(d)) for d in arr.shape)
    head += _str(name) + _bin_header(arr.nbytes)
    out.write(_ext_header(len(head) + arr.nbytes, code))
    out.write(head)
    out.write(memoryview(arr.reshape(-1).view(np.uint8)))


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(x) -> dict:
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _write(out: BinaryIO, x, sort: bool = True) -> None:
    """A chunked leaf's map keeps flax's insertion order; every other map is
    written with its keys sorted."""
    if isinstance(x, dict):
        out.write(_map_header(len(x)))
        for key in (sorted(x) if sort else x):
            if not isinstance(key, str):
                raise TypeError(f"map keys must be strings, got {key!r}")
            out.write(_str(key))
            value = x[key]
            if _is_array(value) and _nbytes(value) > MAX_CHUNK_SIZE:
                _write(out, _chunk(value), sort=False)
            else:
                _write(out, value, sort)
    elif _is_array(x):
        _write_array(out, x, _EXT_NDARRAY)
    elif isinstance(x, np.generic):
        _write_array(out, np.asarray(x), _EXT_NPSCALAR)
    elif x is None:
        out.write(b"\xc0")
    elif isinstance(x, bool):
        out.write(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        out.write(_int(x))
    elif isinstance(x, float):
        out.write(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        out.write(_str(x))
    else:
        raise TypeError(f"cannot store {type(x).__name__} in a flax msgpack tree")


def serialize_to(out: BinaryIO, tree: dict) -> None:
    """Write ``tree`` (nested string-keyed dicts of numpy arrays, torch
    tensors, numpy scalars and python scalars) to a binary file object."""
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        _write(out, _chunk(tree), sort=False)
    else:
        _write(out, tree)


def serialize(tree: dict) -> bytes:
    """``tree`` -> msgpack bytes (``msgpack_serialize``'s format)."""
    import io

    out = io.BytesIO()
    serialize_to(out, tree)
    return out.getvalue()


def write_file(path: str, tree: dict) -> int:
    """Write ``tree`` to ``path``, flushed to disk -> bytes written."""
    import os

    with open(path, "wb") as f:
        serialize_to(f, tree)
        f.flush()
        os.fsync(f.fileno())
        return f.tell()

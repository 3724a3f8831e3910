"""Reader of the msgpack files that `flax.serialization.msgpack_serialize`
writes: the JAX package's checkpoints (`train/checkpoint.py`).  A decoder
of its own, so that the port needs neither flax nor the `msgpack` package.

It decodes the subset flax writes: maps, arrays (as lists), str, bin,
integers, floats, nil and bool; ext code 1, an ndarray packed as the
msgpack array (shape, dtype name, C-order buffer), and ext code 3, a numpy
scalar packed the same way; and flax's chunked form of an array over
2^30 bytes (`{"__msgpack_chunked_array__": True, "shape": {...},
"chunks": {...}}`), joined back into one array.  Arrays come back as
numpy arrays over the file's bytes (read-only); bfloat16 ones, which
numpy lacks, widen exactly to float32.  No writer: the port saves its own
checkpoints with `torch.save`.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def is_flax_msgpack(head: bytes) -> bool:
    """Whether a file that starts with `head` holds a msgpack map (a flax
    checkpoint); a `torch.save` file starts with the zip magic `PK`."""
    return bool(head) and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "text"), 0xDA: (">H", "text"),
                 0xDB: (">I", "text"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self.ext(self.unpack(ext[b]))
        raise ValueError(f"msgpack type byte {b:#x} is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext code {code} is not supported")
        arr = _ndarray(payload)
        return arr if code == _EXT_NDARRAY else arr[()]


def _ndarray(payload: memoryview) -> np.ndarray:
    shape, dtype_name, buf = _Reader(payload).value()
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _indexed(d: dict) -> Tuple:
    """flax's dict form of a tuple ({"0": a, "1": b, ...}) -> (a, b, ...)."""
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        flat = np.concatenate(_indexed(tree["chunks"]))
        return flat.reshape(_indexed(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree that `flax.serialization.msgpack_serialize` encoded into
    `data` (flax's `msgpack_restore`): dicts, lists, Python scalars, and
    numpy arrays and scalars at the leaves."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes "
                         "after the msgpack object")
    return _unchunk(tree)

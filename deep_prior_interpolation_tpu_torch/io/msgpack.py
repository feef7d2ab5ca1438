"""A decoder of the msgpack that flax writes: the JAX package's ``.msgpack``
weights, read without the ``msgpack`` or ``flax`` packages.

``flax.serialization.to_bytes`` packs a tree of dicts whose leaves are
arrays. What this module reads:

* nil, bool, every int and float width, str, bin, array and map;
* ext 1, an ndarray: a msgpack ``(shape, dtype name, C-order bytes)``;
  ext 3, a numpy scalar, the same with shape ``()``;
* flax's chunked form of a large array, ``{'__msgpack_chunked_array__':
  True, 'shape': {'0': ...}, 'chunks': {'0': ..., '1': ...}}``, put back
  into one array.

Arrays come back as numpy arrays, except ``bfloat16``, which numpy lacks: a
``torch.bfloat16`` tensor (the bytes through a 16-bit integer view). Anything
else (ext 2, flax's complex scalar; an unknown ext code; a byte that is no
msgpack type; a truncated buffer; bytes after the value) raises
``ValueError`` naming the offset.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

__all__ = ["read_msgpack", "unpackb"]

_NDARRAY, _NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """Reads one value at a time from ``data``; ``base`` is the offset of
    ``data`` in the file, for the error messages."""

    def __init__(self, data: bytes, base: int = 0):
        self.data, self.pos, self.base = memoryview(data), 0, base

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at offset {self.base + self.pos}: "
                             f"{n} bytes wanted, {len(self.data) - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def value(self) -> Any:
        start = self.base + self.pos
        b = self.uint(1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self.map(b & 0x0f)
        if b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if b <= 0xbf:
            return self.text(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if 0xc4 <= b <= 0xc6:                       # bin 8 / 16 / 32
            return bytes(self.take(self.uint(1 << (b - 0xc4))))
        if 0xc7 <= b <= 0xc9:                       # ext 8 / 16 / 32
            n = self.uint(1 << (b - 0xc7))
            return self.ext(self.sint(1), n, start)
        if b == 0xca:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xcb:
            return struct.unpack(">d", self.take(8))[0]
        if 0xcc <= b <= 0xcf:                       # uint 8 / 16 / 32 / 64
            return self.uint(1 << (b - 0xcc))
        if 0xd0 <= b <= 0xd3:                       # int 8 / 16 / 32 / 64
            return self.sint(1 << (b - 0xd0))
        if 0xd4 <= b <= 0xd8:                       # fixext 1 / 2 / 4 / 8 / 16
            return self.ext(self.sint(1), 1 << (b - 0xd4), start)
        if 0xd9 <= b <= 0xdb:                       # str 8 / 16 / 32
            return self.text(self.uint(1 << (b - 0xd9)))
        if b in (0xdc, 0xdd):                       # array 16 / 32
            return [self.value() for _ in range(self.uint(2 if b == 0xdc else 4))]
        if b in (0xde, 0xdf):                       # map 16 / 32
            return self.map(self.uint(2 if b == 0xde else 4))
        raise ValueError(f"msgpack: byte 0x{b:02x} at offset {start} is no msgpack type")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int, start: int) -> Any:
        base = self.base + self.pos
        payload = self.take(n)
        if code not in (_NDARRAY, _NPSCALAR):
            raise ValueError(f"msgpack: ext type {code} at offset {start} is not read here "
                             f"(flax writes 1 for arrays, 2 for complex scalars, 3 for "
                             f"numpy scalars)")
        arr = _ndarray(payload, base)
        return arr if code == _NDARRAY else arr.reshape(())


def _ndarray(payload: memoryview, base: int):
    r = _Reader(payload, base)
    tpl = r.value()
    if r.pos != len(payload):
        raise ValueError(f"msgpack: {len(payload) - r.pos} bytes after the array at "
                         f"offset {base + r.pos}")
    if not (isinstance(tpl, list) and len(tpl) == 3):
        raise ValueError(f"msgpack: the array at offset {base} is not (shape, dtype, bytes)")
    shape, name, buf = tpl
    name = name.decode() if isinstance(name, bytes) else name
    dtype = np.dtype(np.int16 if name == "bfloat16" else name)
    if len(buf) != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
        raise ValueError(f"msgpack: the array at offset {base} holds {len(buf)} bytes, "
                         f"not {shape} of {name}")
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
    return torch.from_numpy(arr).view(torch.bfloat16) if name == "bfloat16" else arr


def _unchunk(tree: Any) -> Any:
    """flax's chunked arrays back into arrays, anywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if torch.is_tensor(chunks[0]):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes) -> Any:
    """The tree that ``flax.serialization.to_bytes`` wrote into ``data``."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - r.pos} bytes after the value, at "
                         f"offset {r.pos}")
    return _unchunk(tree)


def read_msgpack(path: str) -> Any:
    """The tree of a ``.msgpack`` file written by flax."""
    with open(path, "rb") as fh:
        return unpackb(fh.read())

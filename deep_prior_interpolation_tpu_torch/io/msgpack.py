"""The msgpack that flax writes, read and written without the ``msgpack`` or
``flax`` packages: the JAX package's ``.msgpack`` weights.

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

What this module writes (``packb``, ``write_msgpack``) is the subset flax
writes for a parameter tree, byte for byte as ``flax.serialization.to_bytes``
packs it: maps with str keys in their order, and numpy arrays as ext 1 of
a msgpack ``(shape, dtype name, C-order bytes)``; the ints, strs, bins and
arrays inside it in msgpack's shortest forms. Any other leaf, a key that is
not a str, or an array past flax's 1 GiB chunk size (which flax would write
chunked) raises ``TypeError`` or ``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["packb", "read_msgpack", "unpackb", "write_msgpack"]

_NDARRAY, _NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
_MAX_CHUNK = 2 ** 30   # flax's MAX_CHUNK_SIZE: a larger array is written in chunks


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


def _head(n: int, fix: int, fix_max: int, codes: Tuple[Optional[int], ...]) -> bytes:
    """The header of a str, bin, array or map of ``n``: the fix form below
    ``fix_max`` (``fix`` | n), else the 8 / 16 / 32-bit length form."""
    if n < fix_max:
        return bytes([fix | n])
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"msgpack: a length of {n} does not fit 32 bits")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80 or -32 <= v < 0:
        return v.to_bytes(1, "big", signed=True)
    widths = (1, 2, 4, 8)
    if v >= 0:
        for i, w in enumerate(widths):
            if v < 1 << (8 * w):
                return bytes([0xcc + i]) + v.to_bytes(w, "big")
    else:
        for i, w in enumerate(widths):
            if v >= -(1 << (8 * w - 1)):
                return bytes([0xd0 + i]) + v.to_bytes(w, "big", signed=True)
    raise ValueError(f"msgpack: the int {v} does not fit 64 bits")


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    head = bytes([fixed[n]]) if n in fixed else _head(n, 0, 0, (0xc7, 0xc8, 0xc9))
    return head + code.to_bytes(1, "big", signed=True) + data


def _pack(v: Any, out: List[bytes]) -> None:
    if isinstance(v, dict):
        out.append(_head(len(v), 0x80, 16, (None, 0xde, 0xdf)))
        for k, x in v.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: a map key {k!r} is not a str (flax writes str keys)")
            _pack(k, out)
            _pack(x, out)
    elif isinstance(v, np.ndarray):
        if v.dtype.hasobject or v.dtype.isalignedstruct:
            raise TypeError(f"msgpack: an array of dtype {v.dtype} is not written")
        if v.nbytes > _MAX_CHUNK:
            raise ValueError(f"msgpack: an array of {v.nbytes} bytes is past flax's chunk "
                             f"size ({_MAX_CHUNK}), which it writes in chunks")
        out.append(_ext(_NDARRAY, packb((v.shape, v.dtype.name, v.tobytes("C")))))
    elif isinstance(v, (list, tuple)):
        out.append(_head(len(v), 0x90, 16, (None, 0xdc, 0xdd)))
        for x in v:
            _pack(x, out)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out.append(_head(len(b), 0xa0, 32, (0xd9, 0xda, 0xdb)) + b)
    elif isinstance(v, (bytes, bytearray)):
        out.append(_head(len(v), 0, 0, (0xc4, 0xc5, 0xc6)) + bytes(v))
    elif isinstance(v, int) and not isinstance(v, bool):
        out.append(_int(v))
    else:
        raise TypeError(f"msgpack: a {type(v).__name__} is not written here (maps with str "
                        f"keys, numpy arrays, lists, strs, bytes and ints are)")


def packb(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for ``tree``, a
    nested dict of numpy arrays (``io.bridge.state_dict_to_jax_params``)."""
    out: List[bytes] = []
    _pack(tree, out)
    return b"".join(out)


def write_msgpack(path: str, tree: Any) -> None:
    """Write ``tree`` (see :func:`packb`) to ``path`` as flax would."""
    data = packb(tree)
    with open(path, "wb") as fh:
        fh.write(data)

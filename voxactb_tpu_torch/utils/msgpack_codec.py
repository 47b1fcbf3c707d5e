"""flax's msgpack checkpoint format in pure Python: reader and writer.

The JAX package writes its checkpoints with ``flax.serialization.
msgpack_serialize`` and reads them with ``msgpack_restore``. This module does
both without ``msgpack``, ``flax`` or ``jax``, and makes flax's packing
choices, so that its bytes equal flax's for the same tree:

- maps with ``str`` keys, in the order ``jax.tree_util`` gives them (sorted
  at every level); lists as msgpack arrays; ``None``, bools, ints in their
  smallest format (unsigned formats for positive values), Python floats as
  float64, ``str`` as str and ``bytes`` as bin;
- an array (numpy, or a CPU-movable torch tensor) as ext type 1, a numpy
  scalar as ext type 3, each holding the packed ``(shape, dtype name, C-order
  bytes)``; ``bfloat16`` travels as its 16-bit pattern (numpy has no
  bfloat16 without ``ml_dtypes``) and is read back as a ``torch.bfloat16``
  tensor;
- an array of more than ``MAX_CHUNK_SIZE`` bytes under a dict as
  ``{'__msgpack_chunked_array__': True, 'shape': {'0': ...}, 'chunks':
  {'0': ...}}`` of flat chunks (flax splits below msgpack's 2^31 - 1 limit).

``to_state_dict`` is flax's ``serialization.to_state_dict`` for the trees a
checkpoint holds: lists, tuples and named tuples become dicts (``'0'``,
``'1'``, ... or the field names), dict keys become strings.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


# -- the tree ------------------------------------------------------------------------


def to_state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` of nested dicts, lists, tuples and named
    tuples with array or scalar leaves."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: to_state_dict(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def _sorted_tree(tree: Any) -> Any:
    """The tree with every dict's keys sorted, as ``jax.tree_util.tree_map``
    rebuilds it inside ``msgpack_serialize``."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted_tree(v) for v in tree]
    if isinstance(tree, tuple):
        raise TypeError("can not serialize 'tuple' object: apply to_state_dict first")
    return tree


def _nbytes(leaf) -> int:
    if isinstance(leaf, np.ndarray):
        return leaf.nbytes
    return leaf.numel() * leaf.element_size()


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _chunk(arr) -> dict:
    itemsize = arr.dtype.itemsize if isinstance(arr, np.ndarray) else arr.element_size()
    chunksize = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    size = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(n) for i, n in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + chunksize]
                       for j, i in enumerate(range(0, size, chunksize))}}


def _chunk_leaves(tree: Any) -> Any:
    """flax's ``_chunk_array_leaves_in_place``: oversized arrays directly
    under a dict (or the tree itself) become chunked dicts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if _is_array(v):
                if _nbytes(v) > MAX_CHUNK_SIZE:
                    tree[k] = _chunk(v)
            elif isinstance(v, dict):
                _chunk_leaves(v)
    elif _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if any(not isinstance(c, np.ndarray) for c in chunks):
        flat = torch.cat([torch.as_tensor(c) for c in chunks])
    else:
        flat = np.concatenate(chunks)
    if flat.shape[0] != int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"chunked array of shape {shape} holds {flat.shape[0]} elements")
    return flat.reshape(shape)


def _unchunk_leaves(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = _unchunk_leaves(v)
    return tree


# -- the wire format ---------------------------------------------------------------


def _array_payload(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: the packed (shape, dtype name, bytes)."""
    if isinstance(arr, np.ndarray):
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not serialisable")
        shape, name, data = arr.shape, arr.dtype.name, arr.tobytes("C")
    else:
        t = arr.detach().cpu().contiguous()
        shape = tuple(t.shape)
        if t.dtype == torch.bfloat16:
            name, data = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            name, data = a.dtype.name, a.tobytes("C")
    out: list = []
    _pack([list(shape), name, data], out)
    return b"".join(out)


def _array_from_payload(data):
    shape, name, buf = unpackb(data, raw=True)
    shape = tuple(shape)
    if name == b"bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape).copy()


def _pack_int(n: int, out: list) -> None:
    if 0 <= n:
        if n < 0x80:
            out.append(struct.pack("B", n))
        elif n <= 0xFF:
            out.append(b"\xcc" + struct.pack("B", n))
        elif n <= 0xFFFF:
            out.append(b"\xcd" + struct.pack(">H", n))
        elif n <= 0xFFFFFFFF:
            out.append(b"\xce" + struct.pack(">I", n))
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + struct.pack(">Q", n))
        else:
            raise OverflowError(f"int {n} too large for msgpack")
    elif n >= -32:
        out.append(struct.pack("b", n))
    elif n >= -0x80:
        out.append(b"\xd0" + struct.pack("b", n))
    elif n >= -0x8000:
        out.append(b"\xd1" + struct.pack(">h", n))
    elif n >= -0x80000000:
        out.append(b"\xd2" + struct.pack(">i", n))
    elif n >= -0x8000000000000000:
        out.append(b"\xd3" + struct.pack(">q", n))
    else:
        raise OverflowError(f"int {n} too small for msgpack")


def _pack_len(n: int, fix: int, fixmax: int, formats, out: list) -> None:
    """A length header: ``fix | n`` below ``fixmax``, else the first of
    ``formats`` ((limit, code, struct format)) whose limit holds ``n``."""
    if fix is not None and n < fixmax:
        out.append(struct.pack("B", fix | n))
        return
    for limit, code, fmt in formats:
        if n <= limit:
            out.append(code + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of length {n} is too large")


_STR = ((0xFF, b"\xd9", ">B"), (0xFFFF, b"\xda", ">H"), (0xFFFFFFFF, b"\xdb", ">I"))
_BIN = ((0xFF, b"\xc4", ">B"), (0xFFFF, b"\xc5", ">H"), (0xFFFFFFFF, b"\xc6", ">I"))
_ARRAY = ((0xFFFF, b"\xdc", ">H"), (0xFFFFFFFF, b"\xdd", ">I"))
_MAP = ((0xFFFF, b"\xde", ">H"), (0xFFFFFFFF, b"\xdf", ">I"))
_FIXEXT = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}
_EXT = ((0xFF, b"\xc7", ">B"), (0xFFFF, b"\xc8", ">H"), (0xFFFFFFFF, b"\xc9", ">I"))


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _pack_len(n, None, 0, _EXT, out)
    out.append(struct.pack("b", code))
    out.append(data)


def _pack(obj: Any, out: list) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, _STR, out)
        out.append(data)
    elif t is bytes:
        _pack_len(len(obj), None, 0, _BIN, out)
        out.append(obj)
    elif t is list:
        _pack_len(len(obj), 0x90, 16, _ARRAY, out)
        for v in obj:
            _pack(v, out)
    elif t is dict:
        _pack_len(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif _is_array(obj):
        _pack_ext(EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` with flax's ext types, as ``msgpack.packb(obj,
    default=flax's ext packer, strict_types=True)`` gives them."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.view = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.view):
            raise ValueError("msgpack data ends inside an object")
        chunk = self.view[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            arr = _array_from_payload(data)
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        raise ValueError(f"msgpack ext type {code} is not one flax writes for arrays")

    def read(self):
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b & 0xF0 == 0x80:
            return {self.read(): self.read() for _ in range(b & 0x0F)}
        if b & 0xF0 == 0x90:
            return [self.read() for _ in range(b & 0x0F)]
        if b & 0xE0 == 0xA0:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(1 << (b - 0xD4))
        if b not in lengths:
            raise ValueError(f"msgpack byte 0x{b:02x} is not a known format")
        n = self.unpack(lengths[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self.string(n)
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(n))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return {self.read(): self.read() for _ in range(n)}
        return self.ext(n)


def unpackb(data: bytes, raw: bool = False) -> Any:
    """The object in msgpack ``data`` (flax's ext types decoded); with
    ``raw`` strings come back as bytes."""
    reader = _Reader(data, raw)
    obj = reader.read()
    if reader.pos != len(reader.view):
        raise ValueError(f"{len(reader.view) - reader.pos} bytes after the msgpack object")
    return obj


# -- flax's entry points -------------------------------------------------------------


def serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``: dicts of lists, arrays
    and scalars (apply ``to_state_dict`` to tuples first)."""
    return packb(_chunk_leaves(_sorted_tree(tree)))


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)``: numpy leaves (bfloat16
    ones as ``torch.bfloat16`` tensors), numpy scalars, Python scalars."""
    return _unchunk_leaves(unpackb(data))


def save(path: str, tree: Any) -> None:
    with open(path, "wb") as f:
        f.write(serialize(tree))


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return restore(f.read())

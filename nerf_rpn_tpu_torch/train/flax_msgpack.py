"""The msgpack files of ``flax.serialization``, in plain Python and numpy.

``msgpack_serialize`` / ``msgpack_restore`` (``flax/serialization.py``)
write a tree of dicts, lists and array leaves as msgpack with two extension
types, each a packed ``(shape, dtype name, C-order bytes)`` triple:

- ext 1, an ndarray; ext 3, a numpy scalar (read back as one);
- a leaf above ``MAX_CHUNK_SIZE`` bytes becomes ``{"__msgpack_chunked_array__":
  True, "shape": {"0": d0, ...}, "chunks": {"0": flat0, ...}}``.

This module reads and writes that subset of msgpack (nil, bool, int, float,
str, bin, array, map and ext) without the ``msgpack`` or ``flax`` packages,
which the GPU machine lacks.  ``bfloat16`` leaves read as ``torch.bfloat16``
tensors (numpy has no such dtype); every other leaf is a numpy array.
:func:`packb` sorts each map's keys, as flax's ``tree_map`` copy of the tree
does (the chunked form's maps keep flax's insertion order), and picks the
shortest encoding of each value, as the ``msgpack`` package does, so a tree
of numpy leaves packs to flax's bytes.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"
# flax's limit a leaf, below msgpack's 2**31 - 1 bytes an object
MAX_CHUNK_SIZE = 2**30


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data, raw_str: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw_str else b.decode("utf-8")

    def value(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F)
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        fixed = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if t in fixed:
            return self.unpack(fixed[t])
        sizes = {0: "B", 1: "H", 2: "I"}
        if 0xC4 <= t <= 0xC6:  # bin 8/16/32
            return bytes(self.take(self.unpack(sizes[t - 0xC4])))
        if 0xC7 <= t <= 0xC9:  # ext 8/16/32
            n = self.unpack(sizes[t - 0xC7])
            return self.ext(self.unpack("b"), n)
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack("b"), 1 << (t - 0xD4))
        if 0xD9 <= t <= 0xDB:  # str 8/16/32
            return self.str(self.unpack(sizes[t - 0xD9]))
        if t in (0xDC, 0xDD):  # array 16/32
            return [self.value() for _ in range(self.unpack(sizes[t - 0xDB]))]
        if t in (0xDE, 0xDF):  # map 16/32
            return self.map(self.unpack(sizes[t - 0xDD]))
        raise ValueError(f"msgpack type byte 0x{t:02x} is not in flax's subset")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not a flax array")
        arr = _array_from_bytes(payload)
        if code == EXT_NDARRAY:
            return arr
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]


def _array_from_bytes(payload) -> np.ndarray | torch.Tensor:
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``."""
    shape, name, buf = _Reader(payload, raw_str=True).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        cat = torch.cat if isinstance(chunks[0], torch.Tensor) else np.concatenate
        return cat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data) -> object:
    """flax's ``msgpack_restore``: the tree of ``data``, chunked leaves
    joined."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(out)


def read_msgpack(path: str) -> object:
    """The tree of a flax ``.msgpack`` file (``msgpack_serialize``'s)."""
    with open(path, "rb") as f:
        return unpackb(f.read())


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _length(out: bytearray, n: int, small: tuple[int, int] | None, codes: tuple[int, ...]):
    """A length header: ``small`` = (fix code, fix limit), then 8/16/32-bit
    forms in ``codes`` (None where a form does not exist)."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
        return
    for code, fmt, limit in zip(codes, "BHI", (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(">" + fmt, n)
            return
    raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _int(out: bytearray, v: int):
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16),
                                 (0xCE, "I", 1 << 32), (0xCF, "Q", 1 << 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(">" + fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, limit in ((0xD0, "b", 1 << 7), (0xD1, "h", 1 << 15),
                                 (0xD2, "i", 1 << 31), (0xD3, "q", 1 << 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(">" + fmt, v)
                return
        raise OverflowError(v)


def _array_to_bytes(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, buf = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, buf = a.shape, a.dtype.name, a.tobytes("C")
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not serialised")
        shape, name, buf = arr.shape, arr.dtype.name, arr.tobytes("C")
    out = bytearray()
    _pack(out, [list(shape), name, buf])
    return bytes(out)


def _pack(out: bytearray, v):
    # numpy scalars first: np.float64 is a float, and flax packs it as ext 3
    if isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
        scalar = isinstance(v, np.generic)
        payload = _array_to_bytes(np.asarray(v) if scalar else v)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _length(out, n, None, (0xC7, 0xC8, 0xC9))
        out.append(EXT_NPSCALAR if scalar else EXT_NDARRAY)
        out += payload
    elif v is None:
        out.append(0xC0)
    elif isinstance(v, bool):
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(0xCB)
        out += struct.pack(">d", v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _length(out, len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(v, (bytes, bytearray, memoryview)):
        _length(out, len(v), None, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, dict):
        _length(out, len(v), (0x80, 16), (None, 0xDE, 0xDF))
        for k in v:
            _pack(out, k)
            _pack(out, v[k])
    elif isinstance(v, (list, tuple)):
        _length(out, len(v), (0x90, 16), (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    else:
        raise TypeError(f"cannot serialise {type(v).__name__} to msgpack")


def _sorted(tree):
    """The copy of flax's ``tree_map``: every map's keys sorted."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_sorted(v) for v in tree]
    return tree


def _chunk(tree):
    """flax's ``_chunk_array_leaves_in_place``, on the copy."""
    if isinstance(tree, dict):
        return {k: _chunk(v) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        torch_leaf = isinstance(tree, torch.Tensor)
        itemsize = tree.element_size() if torch_leaf else tree.itemsize
        if (tree.numel() if torch_leaf else tree.size) * itemsize > MAX_CHUNK_SIZE:
            step = max(1, MAX_CHUNK_SIZE // itemsize)
            flat = tree.reshape(-1)
            return {CHUNKED: True,
                    "shape": {str(i): int(d) for i, d in enumerate(tree.shape)},
                    "chunks": {str(j): flat[i:i + step]
                               for j, i in enumerate(range(0, flat.shape[0], step))}}
    return tree


def packb(tree) -> bytes:
    """flax's ``msgpack_serialize`` of ``tree`` (dicts, lists, numpy or
    torch leaves)."""
    out = bytearray()
    _pack(out, _chunk(_sorted(tree)))
    return bytes(out)


def write_msgpack(path: str, tree) -> None:
    with open(path, "wb") as f:
        f.write(packb(tree))

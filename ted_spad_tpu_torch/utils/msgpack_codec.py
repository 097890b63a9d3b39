"""The msgpack subset that flax checkpoints use, in pure Python and numpy (no
``msgpack`` package: the card's host has none).

``serialize(tree)`` gives the bytes ``flax.serialization.msgpack_serialize`` gives for
the same tree of dicts, lists, Python scalars and numpy arrays; ``restore(data)``
reads what it writes, as ``flax.serialization.msgpack_restore`` does. The flax
conventions (flax 0.12 ``serialization.py``):

- maps are packed with their keys sorted, as flax's tree copy re-creates every dict;
- ``strict_types``: a Python float goes out as float64, an int in the smallest of the
  msgpack int encodings, str as str and bytes as bin;
- an array is ext 1 and a numpy scalar ext 3, each holding the msgpack array
  ``(shape, dtype name, C-order bytes)``; the dtype name is packed as str and read
  back as bytes, as flax reads it. ``bfloat16`` has no numpy dtype here: such leaves
  are read as ``torch.bfloat16`` tensors (through a 16-bit integer view) and written
  from them;
- an array over ``MAX_CHUNK_SIZE`` bytes is split into a
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0": ..}}``
  map of flat chunks.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
# flax: msgpack holds at most 2**31 - 1 bytes per object; flax splits leaves above this.
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# Primitive encoder
# ---------------------------------------------------------------------------


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80 or -0x20 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
    elif 0 < n:
        for limit, code, fmt in ((0x100, 0xCC, ">B"), (0x10000, 0xCD, ">H"),
                                 (0x100000000, 0xCE, ">I"), (0x10000000000000000, 0xCF, ">Q")):
            if n < limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit msgpack's uint64")
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                 (-0x80000000, 0xD2, ">i"), (-0x8000000000000000, 0xD3, ">q")):
            if n >= limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit msgpack's int64")


def _pack_header(n: int, fix_base: int | None, fix_max: int, codes: tuple[int, int, int],
                 out: bytearray) -> None:
    """Length header: a fix form up to ``fix_max``, then 8/16/32-bit lengths
    (``codes``; a 0 code means the type has no 8-bit form)."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
    elif codes[0] and n < 0x100:
        out += bytes((codes[0], n))
    elif n < 0x10000:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 0x100000000:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"object of {n} entries or bytes exceeds msgpack's 32-bit lengths")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(fixext[len(data)])
    else:
        _pack_header(len(data), None, 0, (0xC7, 0xC8, 0xC9), out)
    out += struct.pack(">b", code)
    out += data


def _array_payload(arr) -> bytes:
    """msgpack ``(shape, dtype name, C bytes)`` of a numpy array or a torch tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().tobytes("C")
            return packb([list(t.shape), "bfloat16", raw])
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj: Any, out: bytearray, single_float: bool) -> None:
    kind = type(obj)
    if obj is None:
        out.append(0xC0)
    elif kind is bool:
        out.append(0xC3 if obj else 0xC2)
    elif kind is int:
        _pack_int(obj, out)
    elif kind is float:
        if single_float:  # rounded as C rounds a double to float (overflow -> inf)
            out.append(0xCA)
            with np.errstate(over="ignore"):
                out += np.array(obj, ">f4").tobytes()
        else:
            out += struct.pack(">Bd", 0xCB, obj)
    elif kind is str:
        data = obj.encode("utf-8")
        _pack_header(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif kind in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_header(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += data
    elif kind in (list, tuple):
        _pack_header(len(obj), 0x90, 15, (0, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out, single_float)
    elif kind is dict:
        _pack_header(len(obj), 0x80, 15, (0, 0xDE, 0xDF), out)
        for key, value in obj.items():
            _pack(key, out, single_float)
            _pack(value, out, single_float)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialize {kind.__name__}")


def packb(obj: Any, *, use_single_float: bool = False) -> bytes:
    """msgpack bytes of ``obj``, as ``msgpack.packb(obj, strict_types=True,
    default=flax's ext hook)`` gives them (lists and tuples both as arrays)."""
    out = bytearray()
    _pack(obj, out, use_single_float)
    return bytes(out)


# ---------------------------------------------------------------------------
# Primitive decoder
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.read_str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        lengths = {0: ">B", 1: ">H", 2: ">I"}
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(lengths[b - 0xC4])))
        if b in (0xD9, 0xDA, 0xDB):
            return self.read_str(self.unpack(lengths[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(lengths[b - 0xDB]))]
        if b in (0xDE, 0xDF):
            return self.read_map(self.unpack(lengths[b - 0xDD]))
        if 0xD4 <= b <= 0xD8:
            return self.read_ext(1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):
            return self.read_ext(self.unpack(lengths[b - 0xC7]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def read_str(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read_ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            arr = _array_from_payload(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def _array_from_payload(data: bytes):
    shape, name, buf = unpackb(data, raw=True)
    if name == b"bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape, order="C")


def unpackb(data: bytes, *, raw: bool = False) -> Any:
    """Decode one msgpack object filling ``data``; ``raw`` keeps str as bytes."""
    reader = _Reader(data, raw)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the msgpack object")
    return obj


# ---------------------------------------------------------------------------
# flax's tree layer
# ---------------------------------------------------------------------------


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(arr) -> dict:
    flat = arr.reshape(-1)
    itemsize = flat.element_size() if isinstance(flat, torch.Tensor) else flat.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _canonical(tree: Any, chunk: bool = True) -> Any:
    """flax's tree copy: dicts re-created with sorted keys; arrays over
    MAX_CHUNK_SIZE bytes chunked where flax chunks them (at the top and as dict
    values, not inside lists)."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k], chunk) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_canonical(x, False) for x in tree)
    if chunk and isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes."""
    return packb(_canonical(tree))


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)``: numpy leaves (read-only, as
    flax's), bfloat16 leaves as torch tensors, chunked leaves joined."""
    return _unchunk(unpackb(data))

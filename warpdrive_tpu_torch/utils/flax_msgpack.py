"""
flax's on-disk format, read and written without the ``msgpack`` package.

``flax.serialization.to_bytes`` writes a msgpack map of nested string-keyed
maps (the JAX package's checkpoints, ``*.state_dict``, and its serving
bundles' ``params.msgpack``).  A leaf array is msgpack ext type 1 whose
payload is itself a msgpack array ``[shape, dtype name, raw C-order
bytes]``; ext type 3 is a numpy scalar in the same payload; ext type 2 a
Python complex.  An array over ``MAX_CHUNK_SIZE`` (2^30) bytes is written
as a ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks":
{...}}`` map of flat chunks, tuples as ``{"0": ..., "1": ...}``.

:func:`decode` gives nested dicts of numpy arrays; :func:`encode` writes a
tree of dicts, lists, Python scalars, numpy arrays and scalars and torch
tensors byte for byte as ``flax.serialization.to_bytes`` writes the same
tree: msgpack's smallest form of every int and length, doubles for floats,
str8 for strings, bin for bytes, and dict keys in insertion order.  The
dtype is read from its name, never guessed.  numpy has no bfloat16, so a
bfloat16 leaf decodes to a CPU ``torch.bfloat16`` tensor, and such a tensor
encodes under the name ``bfloat16``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# ------------------------------------------------------------------ decode
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixext forms (0xd4-0xd8): payload sizes 1, 2, 4, 8, 16
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_SIZED = {  # format byte -> (kind, length struct)
    0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
    0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
    0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
    0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
    0xde: ("map", ">H"), 0xdf: ("map", ">I"),
}
_NUMBERS = {
    0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
    0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
}


def _read(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_read(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return bytes(r.take(b & 0x1f)).decode("utf-8")
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _NUMBERS:
        value = r.unpack(_NUMBERS[b])
        return float(value) if b in (0xca, 0xcb) else int(value)
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(_FIXEXT[b])))
    if b not in _SIZED:
        raise ValueError(f"unknown msgpack format byte 0x{b:02x}")
    kind, fmt = _SIZED[b]
    n = r.unpack(fmt)
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "str":
        return bytes(r.take(n)).decode("utf-8")
    if kind == "array":
        return [_read(r) for _ in range(n)]
    if kind == "map":
        return _read_map(r, n)
    code = r.unpack(">b")
    return _ext(code, bytes(r.take(n)))


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    return out


def _loads(data: bytes):
    r = _Reader(data)
    value = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack "
                         "object")
    return value


def _array_from_payload(payload: bytes):
    shape, name, raw = _loads(payload)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        value = _array_from_payload(data)
        return value[()] if isinstance(value, np.ndarray) else value
    if code == EXT_COMPLEX:
        real, imag = _loads(data)
        return complex(real, imag)
    raise ValueError(f"msgpack ext type {code} is not one of flax's")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def decode(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` reads from ``data``:
    nested dicts with numpy arrays (bfloat16 ones as torch tensors),
    chunked arrays joined."""
    return _unchunk(_loads(bytes(data)))


def read_file(path: str):
    with open(path, "rb") as f:
        return decode(f.read())


def is_msgpack_map(head: bytes) -> bool:
    """Whether ``head``, a file's first byte(s), opens a msgpack map (a
    flax file) rather than, e.g., a torch zip (``PK``)."""
    return len(head) > 0 and (0x80 <= head[0] <= 0x8f or head[0] in
                              (0xde, 0xdf))


# ------------------------------------------------------------------ encode
def _pack_len(out: bytearray, n: int, small: int, small_max: int,
              forms: tuple):
    """A length header: ``small | n`` up to ``small_max`` (when given),
    else the first of ``forms`` ((byte, struct, max), ...) that holds n."""
    if small is not None and n <= small_max:
        out.append(small | n)
        return
    for byte, fmt, top in forms:
        if n <= top:
            out.append(byte)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack_int(out: bytearray, v: int):
    if v >= 0:
        if v < 0x80:
            out.append(v)
            return
        for byte, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                out.append(byte)
                out += struct.pack(fmt, v)
                return
    else:
        if v >= -0x20:
            out += struct.pack(">b", v)
            return
        for byte, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if v >= low:
                out.append(byte)
                out += struct.pack(fmt, v)
                return
    raise OverflowError(f"int {v} too large for msgpack")


_U = ((">B", 0xff), (">H", 0xffff), (">I", 0xffffffff))


def _pack_ext(out: bytearray, code: int, data: bytes):
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0,
                  tuple((b, f, t) for b, (f, t) in zip((0xc7, 0xc8, 0xc9),
                                                      _U)))
    out += struct.pack(">b", code)
    out += data


def _array_payload(arr) -> bytes:
    """``[shape, dtype name, C-order bytes]`` as flax's
    ``_ndarray_to_bytes`` packs it."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            shape, name = tuple(arr.shape), "bfloat16"
            raw = arr.contiguous().view(torch.int16).numpy().tobytes()
            return _dumps([list(shape), name, raw])
        arr = arr.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return _dumps([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj):
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, complex):
        _pack_ext(out, EXT_COMPLEX, _dumps([obj.real, obj.imag]))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xa0, 31,
                  tuple((b, f, t) for b, (f, t) in zip((0xd9, 0xda, 0xdb),
                                                      _U)))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(out, len(raw), None, 0,
                  tuple((b, f, t) for b, (f, t) in zip((0xc4, 0xc5, 0xc6),
                                                      _U)))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15,
                  ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff)))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15,
                  ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff)))
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__}")


def _dumps(obj) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _chunk(arr: np.ndarray, max_chunk_size: int) -> dict:
    size = max(1, int(max_chunk_size / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i: i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(n) for i, n in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_leaves(tree, max_chunk_size: int):
    """flax's ``_chunk_array_leaves_in_place`` on a copy: numpy arrays over
    ``max_chunk_size`` bytes that are dict values (or the whole tree)."""
    if isinstance(tree, np.ndarray):
        return (_chunk(tree, max_chunk_size) if tree.nbytes > max_chunk_size
                else tree)
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v, max_chunk_size) for k, v in tree.items()}
    return tree


def encode(tree, max_chunk_size: int = MAX_CHUNK_SIZE) -> bytes:
    """``tree`` in flax's format, byte for byte as
    ``flax.serialization.to_bytes`` writes the same tree (keys as they
    stand: a flax state dict's keys are strings)."""
    return _dumps(_chunk_leaves(tree, max_chunk_size))


def write_file(path: str, tree):
    with open(path, "wb") as f:
        f.write(encode(tree))

"""Read and write flax's msgpack checkpoint layout without flax or msgpack.

``flax.serialization.to_bytes`` writes a state dict as msgpack: maps with
str keys; an array as ext type 1, whose payload is itself msgpack, the
array ``(shape, dtype name, row-major bytes)``; a numpy scalar as ext type
3 with the same payload; an array over ``MAX_CHUNK_SIZE`` bytes as the map
``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0":
flat piece, ...}}``.  :func:`load` / :func:`from_bytes` read that into
nested dicts of CPU torch tensors (bfloat16 payloads stay bfloat16, no
``ml_dtypes`` needed), and :func:`save` / :func:`to_bytes` write nested
dicts of tensors the same way, so the JAX package loads them.

Array payloads are sliced out of one buffer (``torch.frombuffer``) and
written from the tensors' own memory: nothing walks an array byte by byte
in Python.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Union

import torch

#: flax's limit: bytes per array piece in the file
MAX_CHUNK_SIZE = 2**30

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
_DTYPES = {
    "bool": torch.bool, "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64,
}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}

# --------------------------------------------------------------------- read

_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SIZED = {  # type byte -> (struct of its length or value, what follows)
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xCA: (">f", "value"), 0xCB: (">d", "value"),
    0xCC: (">B", "value"), 0xCD: (">H", "value"), 0xCE: (">I", "value"),
    0xCF: (">Q", "value"), 0xD0: (">b", "value"), 0xD1: (">h", "value"),
    0xD2: (">i", "value"), 0xD3: (">q", "value"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b in _FIXED:
            return _FIXED[b]
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            code = self._unpack(">b")
            return self._ext(code, self._take(1 << (b - 0xD4)))
        if b not in _SIZED:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        fmt, kind = _SIZED[b]
        n = self._unpack(fmt)
        if kind == "value":
            return n
        if kind == "bin":
            return self._take(n)
        if kind == "str":
            return str(self._take(n), "utf-8")
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            return self._map(n)
        code = self._unpack(">b")
        return self._ext(code, self._take(n))

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, code: int, data: memoryview):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, payload = _Reader(data).read()
        if isinstance(dtype_name, memoryview):
            dtype_name = str(dtype_name, "utf-8")
        if dtype_name not in _DTYPES:
            raise ValueError(f"unsupported array dtype {dtype_name!r}")
        dtype = _DTYPES[dtype_name]
        if len(payload) == 0:
            t = torch.empty(0, dtype=dtype)
        else:
            t = torch.frombuffer(payload, dtype=dtype)
            if t.data_ptr() % t.element_size():
                t = t.clone()  # an aligned copy for the kernels that read it
        return t.reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {key: _unchunk(value) for key, value in tree.items()}


def from_bytes(data: Union[bytes, bytearray, memoryview]):
    """The tree flax's ``msgpack_restore`` would give, with torch tensors
    for arrays.  The tensors share the memory of a writable ``data``; read-only
    data is copied once."""
    if isinstance(data, bytes):
        data = bytearray(data)
    reader = _Reader(memoryview(data))
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def load(path: Union[str, Path]):
    """:func:`from_bytes` of a file, read once into one buffer."""
    path = Path(path)
    buf = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise ValueError(f"short read of {path}")
    return from_bytes(buf)


# -------------------------------------------------------------------- write


def _header(small: int, codes: tuple, n: int, limit: int) -> bytes:
    """A length header: ``small | n`` below ``limit``, else the 8/16/32-bit forms."""
    if n < limit:
        return bytes([small | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too large")


def _encode_int(n: int) -> bytes:
    if 0 <= n < 128 or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    for code, fmt, lo, hi in ((0xCC, ">B", 0, 1 << 8), (0xCD, ">H", 0, 1 << 16),
                              (0xCE, ">I", 0, 1 << 32), (0xCF, ">Q", 0, 1 << 64),
                              (0xD0, ">b", -(1 << 7), 1 << 7), (0xD1, ">h", -(1 << 15), 1 << 15),
                              (0xD2, ">i", -(1 << 31), 1 << 31),
                              (0xD3, ">q", -(1 << 63), 1 << 63)):
        if lo <= n < hi:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _encode_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _header(0xA0, (0xD9, 0xDA, 0xDB), len(raw), 32) + raw


def _array_parts(t: torch.Tensor) -> list:
    """ext type 1 of one array: the header, then the tensor's own bytes."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype not in _NAMES:
        raise ValueError(f"unsupported tensor dtype {t.dtype}")
    data = memoryview(t.reshape(-1).view(torch.uint8).numpy())
    inner = bytearray(b"\x93")  # (shape, dtype name, bytes)
    inner += _header(0x90, (None, 0xDC, 0xDD), t.ndim, 16)
    for d in t.shape:
        inner += _encode_int(d)
    inner += _encode_str(_NAMES[t.dtype])
    inner += _header(0, (0xC4, 0xC5, 0xC6), len(data), 0)
    size = len(inner) + len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if size in fixext:
        head = bytes([fixext[size], _EXT_NDARRAY])
    else:
        head = _header(0, (0xC7, 0xC8, 0xC9), size, 0) + bytes([_EXT_NDARRAY])
    return [head + bytes(inner), data]


def _chunked(t: torch.Tensor) -> dict:
    """flax's chunked form of an array over ``MAX_CHUNK_SIZE`` bytes."""
    per = max(1, int(MAX_CHUNK_SIZE / t.element_size()))
    flat = t.detach().reshape(-1)
    pieces = [flat[i:i + per] for i in range(0, flat.numel(), per)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(t.shape)},
            "chunks": {str(i): p for i, p in enumerate(pieces)}}


def _encode(obj, out: list) -> None:
    """A state dict's values: maps with str keys, tensors, and the ints and
    bools of flax's chunked form."""
    if isinstance(obj, dict):
        out.append(_header(0x80, (None, 0xDE, 0xDF), len(obj), 16))
        for key, value in obj.items():
            out.append(_encode_str(str(key)))
            _encode(value, out)
    elif isinstance(obj, torch.Tensor):
        if obj.numel() * obj.element_size() > MAX_CHUNK_SIZE:
            _encode(_chunked(obj), out)
        else:
            out.extend(_array_parts(obj))
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_encode_int(obj))
    else:
        raise TypeError(f"cannot write {type(obj).__name__} to a flax state dict")


def to_bytes(tree) -> bytes:
    """The bytes flax's ``to_bytes`` writes for a tree of dicts of tensors."""
    out: list = []
    _encode(tree, out)
    return b"".join(out)


def save(path: Union[str, Path], tree) -> None:
    """:func:`to_bytes` into a file, each array written from its own memory."""
    out: list = []
    _encode(tree, out)
    with open(path, "wb") as f:
        for part in out:
            f.write(part)

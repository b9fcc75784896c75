"""The safetensors format without the ``safetensors`` package.

The port's own reader and writer of the files HF checkpoints ship
(``model.safetensors``), the counterpart of :mod:`.msgpack_io` for the JAX
package's checkpoints: the card has no ``safetensors`` package, and the
converters must read real checkpoints there.

The format: an 8-byte little-endian unsigned header length N, then N bytes
of JSON (padded with spaces to a multiple of 8), then the data.  The JSON
maps each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets into the data, little-endian, C order) and may carry
``"__metadata__"``, a map of strings to strings.  The tensors' byte ranges
tile the data exactly: no gap, no overlap, nothing past its end.  Offsets
are Python ints, so files past 4 GiB need nothing special.

Tensors load as torch tensors (numpy has no bfloat16); the writer takes
torch tensors or numpy arrays (ml_dtypes' bfloat16 included).
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Mapping, Optional, Union

import numpy as np
import torch

#: format dtype -> (torch dtype, bytes an element)
DTYPES = {
    "F64": (torch.float64, 8),
    "F32": (torch.float32, 4),
    "F16": (torch.float16, 2),
    "BF16": (torch.bfloat16, 2),
    "I64": (torch.int64, 8),
    "I32": (torch.int32, 4),
    "I16": (torch.int16, 2),
    "I8": (torch.int8, 1),
    "U8": (torch.uint8, 1),
    "BOOL": (torch.bool, 1),
}
_BY_TORCH = {dtype: name for name, (dtype, _) in DTYPES.items()}
_BY_NUMPY = {"float64": "F64", "float32": "F32", "float16": "F16", "bfloat16": "BF16",
             "int64": "I64", "int32": "I32", "int16": "I16", "int8": "I8", "uint8": "U8",
             "bool": "BOOL"}
_METADATA = "__metadata__"
#: the reference implementation refuses headers over 100 MB
MAX_HEADER_BYTES = 100_000_000


def _dtype_name(value) -> str:
    if isinstance(value, torch.Tensor):
        if value.dtype not in _BY_TORCH:
            raise ValueError(f"no safetensors dtype for {value.dtype}")
        return _BY_TORCH[value.dtype]
    name = np.asarray(value).dtype.name
    if name not in _BY_NUMPY:
        raise ValueError(f"no safetensors dtype for numpy {name}")
    return _BY_NUMPY[name]


def _raw_bytes(value) -> memoryview:
    """The little-endian bytes of a tensor or array in C order."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.numel() == 0:
            return memoryview(b"")
        return memoryview(t.reshape(-1).view(torch.uint8).numpy())
    a = np.ascontiguousarray(value)
    return memoryview(a.reshape(-1).view(np.uint8))


def plan_header(specs: Mapping[str, tuple], metadata: Optional[Mapping[str, str]] = None
                ) -> dict:
    """The header for tensors ``{name: (dtype name, shape)}``, laid out in
    name order."""
    header: dict = {}
    if metadata:
        header[_METADATA] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in sorted(specs):
        dtype, shape = specs[name]
        nbytes = math.prod(shape) * DTYPES[dtype][1]
        header[name] = {"dtype": dtype, "shape": [int(d) for d in shape],
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    return header


def encode_header(header: dict) -> bytes:
    """The 8-byte length and the JSON, padded with spaces to 8 bytes."""
    body = json.dumps(header, separators=(",", ":")).encode()
    body += b" " * (-len(body) % 8)
    return struct.pack("<Q", len(body)) + body


def check_header(header: dict, data_len: int) -> list[tuple]:
    """Validate a parsed header against ``data_len`` bytes of data.  Returns
    ``[(name, dtype name, shape, begin, end)]`` in file order; raises on an
    unknown dtype, a size that disagrees with the shape, a gap, an overlap
    or a range past the data."""
    entries = []
    for name, info in header.items():
        if name == _METADATA:
            if not isinstance(info, dict) or not all(
                    isinstance(k, str) and isinstance(v, str) for k, v in info.items()):
                raise ValueError("__metadata__ must map strings to strings")
            continue
        dtype = info.get("dtype")
        if dtype not in DTYPES:
            raise ValueError(f"{name}: unknown dtype {dtype!r}")
        shape = [int(d) for d in info["shape"]]
        if any(d < 0 for d in shape):
            raise ValueError(f"{name}: negative dimension in {shape}")
        begin, end = (int(x) for x in info["data_offsets"])
        if end - begin != math.prod(shape) * DTYPES[dtype][1]:
            raise ValueError(f"{name}: {end - begin} bytes for shape {shape} of {dtype}")
        entries.append((name, dtype, shape, begin, end))
    entries.sort(key=lambda e: (e[3], e[4]))
    expected = 0
    for name, _, _, begin, end in entries:
        if begin < expected:
            raise ValueError(f"{name}: data_offsets overlap the previous tensor")
        if begin > expected:
            raise ValueError(f"{name}: a gap of {begin - expected} bytes before it")
        expected = end
    if expected > data_len:
        raise ValueError(f"tensors run to byte {expected} past the data's {data_len}")
    if expected < data_len:
        raise ValueError(f"{data_len - expected} bytes of data belong to no tensor")
    return entries


def _parse(prefix: bytes, total_len: int) -> tuple[dict, int]:
    """(header, data start) from the file's first bytes."""
    if len(prefix) < 8:
        raise ValueError("not a safetensors file: shorter than its header length")
    (n,) = struct.unpack("<Q", prefix[:8])
    if n > MAX_HEADER_BYTES or 8 + n > total_len:
        raise ValueError(f"header length {n} does not fit the file ({total_len} bytes)")
    header = json.loads(bytes(prefix[8:8 + n]).decode("utf-8"))
    if not isinstance(header, dict):
        raise ValueError("the header is not a JSON object")
    return header, 8 + n


def _tensors(buf: bytearray, start: int, header: dict) -> dict[str, torch.Tensor]:
    out = {}
    for name, dtype, shape, begin, end in check_header(header, len(buf) - start):
        torch_dtype, size = DTYPES[dtype]
        if end == begin:
            out[name] = torch.empty(shape, dtype=torch_dtype)
            continue
        offset = start + begin
        if offset % size:  # misaligned: copy the bytes out
            out[name] = torch.frombuffer(bytearray(buf[offset:start + end]),
                                         dtype=torch_dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=torch_dtype, count=(end - begin) // size,
                                         offset=offset).reshape(shape)
    return out


def load_file(path: Union[str, Path]) -> dict[str, torch.Tensor]:
    """Tensors of a safetensors file (CPU tensors sharing one buffer)."""
    path = Path(path)
    size = path.stat().st_size
    buf = bytearray(size)
    view = memoryview(buf)
    with open(path, "rb") as f:
        got = 0
        while got < size:  # one read() returns at most ~2 GiB
            n = f.readinto(view[got:])
            if not n:
                raise ValueError(f"{path}: short read ({got} of {size} bytes)")
            got += n
    header, start = _parse(view, size)
    return _tensors(buf, start, header)


def _plan(tensors: Mapping, metadata) -> dict:
    return plan_header({name: (_dtype_name(v), tuple(v.shape)) for name, v in tensors.items()},
                       metadata)


def save_file(tensors: Mapping, path: Union[str, Path],
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays) to ``path``."""
    header = _plan(tensors, metadata)
    with open(path, "wb") as f:
        f.write(encode_header(header))
        for name in header:
            if name != _METADATA:
                f.write(_raw_bytes(tensors[name]))

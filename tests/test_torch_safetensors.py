"""The port's safetensors reader and writer against the ``safetensors`` package.

``tiny_audio_tpu_torch.utils.safetensors_io`` must read what
``safetensors.torch`` / ``safetensors.numpy`` write and write what they read,
for every dtype the converters meet (bf16 included), zero-size and 0-d
tensors and ``__metadata__``; refuse a header whose byte ranges overlap,
leave a gap or run past the data; and keep 64-bit offsets exact past 4 GiB
(checked on the header arithmetic, without writing such a file).
"""

import json
import struct

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as pt_load_file
from safetensors.torch import save_file as pt_save_file

from tiny_audio_tpu_torch.utils import safetensors_io as st

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
          "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def _tensor(dtype: torch.dtype, shape, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=gen) * 100).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=gen, dtype=torch.int64).to(dtype)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return a.contiguous().reshape(-1).view(torch.uint8).tolist() == \
        b.contiguous().reshape(-1).view(torch.uint8).tolist()


def _zoo(dtype: torch.dtype) -> dict:
    return {"matrix": _tensor(dtype, (3, 5), 0), "vector": _tensor(dtype, (7,), 1),
            "scalar": _tensor(dtype, (), 2), "empty": _tensor(dtype, (0, 4), 3),
            "cube": _tensor(dtype, (2, 3, 4), 4)}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_port_writes_what_safetensors_torch_reads(tmp_path, name):
    tensors = _zoo(DTYPES[name])
    st.save_file(tensors, tmp_path / "x.safetensors", metadata={"format": "pt", "n": "1"})
    back = pt_load_file(str(tmp_path / "x.safetensors"))
    with safe_open(str(tmp_path / "x.safetensors"), "pt") as f:
        assert f.metadata() == {"format": "pt", "n": "1"}
    assert back.keys() == tensors.keys()
    for key in tensors:
        assert _same(back[key], tensors[key]), key


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_port_reads_what_safetensors_torch_writes(tmp_path, name):
    tensors = _zoo(DTYPES[name])
    pt_save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    back = st.load_file(tmp_path / "x.safetensors")
    assert back.keys() == tensors.keys()
    for key in tensors:
        assert _same(back[key], tensors[key]), key


_NUMPY = ["float64", "float32", "float16", "int64", "int32", "int16", "int8", "uint8", "bool"]


def _np_zoo(dtype: str) -> dict:
    rng = np.random.default_rng(0)
    if dtype == "bool":
        make = lambda shape: rng.random(shape) > 0.5  # noqa: E731
    elif dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        make = lambda shape: rng.integers(info.min, info.max, shape, dtype=dtype)  # noqa: E731
    else:
        make = lambda shape: (rng.standard_normal(shape) * 100).astype(dtype)  # noqa: E731
    return {key: np.asarray(make(shape), dtype) for key, shape in
            (("m", (4, 3)), ("s", ()), ("e", (0,)))}


@pytest.mark.parametrize("dtype", _NUMPY)
def test_numpy_arrays_both_directions(tmp_path, dtype):
    arrays = _np_zoo(dtype)
    st.save_file(arrays, tmp_path / "ours.safetensors")
    theirs = np_load_file(str(tmp_path / "ours.safetensors"))
    np_save_file(arrays, str(tmp_path / "theirs.safetensors"))
    ours = st.load_file(tmp_path / "theirs.safetensors")
    for key, a in arrays.items():
        assert theirs[key].dtype == a.dtype and np.array_equal(theirs[key], a), key
        assert ours[key].shape == a.shape and np.array_equal(ours[key].numpy(), a), key


def test_ml_dtypes_bfloat16_array_is_bf16(tmp_path):
    a = (np.arange(12, dtype=np.float32) / 7).astype(ml_dtypes.bfloat16).reshape(3, 4)
    st.save_file({"w": a}, tmp_path / "x.safetensors")
    back = pt_load_file(str(tmp_path / "x.safetensors"))["w"]
    assert back.dtype == torch.bfloat16
    assert back.view(torch.int16).numpy().tobytes() == a.tobytes()


def test_misaligned_offsets(tmp_path):
    """Three bytes before a float32 tensor leave it off its alignment: the
    reader copies it out, and the package reads the file too."""
    tensors = {"a": torch.tensor([1, 2, 3], dtype=torch.uint8),
               "b": torch.arange(5, dtype=torch.float32) / 3}
    st.save_file(tensors, tmp_path / "x.safetensors", metadata={"k": "v"})
    for back in (st.load_file(tmp_path / "x.safetensors"),
                 pt_load_file(str(tmp_path / "x.safetensors"))):
        for key in tensors:
            assert _same(back[key], tensors[key]), key


def _load(tmp_path, blob: bytes) -> dict:
    (tmp_path / "x.safetensors").write_bytes(blob)
    return st.load_file(tmp_path / "x.safetensors")


def _file(header: dict, data: bytes) -> bytes:
    return st.encode_header(header) + data


def _good() -> tuple[dict, bytes]:
    header = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
              "b": {"dtype": "I8", "shape": [4], "data_offsets": [8, 12]}}
    return header, bytes(range(12))


def test_good_handmade_header_reads(tmp_path):
    header, data = _good()
    back = _load(tmp_path, _file(header, data))
    assert back["b"].tolist() == [8, 9, 10, 11]


@pytest.mark.parametrize("case", ["overlap", "past_end", "gap", "size", "dtype", "tail",
                                  "header_length", "metadata"])
def test_bad_headers_are_refused(tmp_path, case):
    header, data = _good()
    if case == "overlap":
        header["b"]["data_offsets"] = [4, 8]
        header["a"]["shape"] = [2]
        header["b"]["shape"] = [4]
        data = data[:8]
    elif case == "past_end":
        data = data[:10]
    elif case == "gap":
        header["b"]["data_offsets"] = [9, 13]
        data = data + b"\0"
    elif case == "size":
        header["b"]["shape"] = [5]
    elif case == "dtype":
        header["a"]["dtype"] = "F8"
    elif case == "tail":
        data = data + b"\0\0\0\0"
    elif case == "metadata":
        header["__metadata__"] = {"k": 1}
    blob = _file(header, data)
    if case == "header_length":
        blob = struct.pack("<Q", len(blob) + 1) + blob[8:]
    with pytest.raises(ValueError):
        _load(tmp_path, blob)


def test_offsets_past_4_gib_stay_exact():
    """The header of a file past 4 GiB, planned and checked without writing
    the data: the offsets are exact Python ints through JSON."""
    five_gib = 5 * 2**30
    specs = {"big": ("BF16", (five_gib // 2,)), "small": ("F32", (3,)),
             "tail": ("I64", (2**29 + 1,))}
    header = st.plan_header(specs, {"format": "pt"})
    assert header["big"]["data_offsets"] == [0, five_gib]
    assert header["small"]["data_offsets"] == [five_gib, five_gib + 12]
    end = five_gib + 12 + 8 * (2**29 + 1)
    assert header["tail"]["data_offsets"] == [five_gib + 12, end]
    blob = st.encode_header(header)
    assert len(blob) % 8 == 0
    (n,) = struct.unpack("<Q", blob[:8])
    parsed = json.loads(blob[8:8 + n])
    entries = st.check_header(parsed, end)
    assert [(e[0], e[3], e[4]) for e in entries] == [
        ("big", 0, five_gib), ("small", five_gib, five_gib + 12), ("tail", five_gib + 12, end)]
    with pytest.raises(ValueError):
        st.check_header(parsed, end - 1)

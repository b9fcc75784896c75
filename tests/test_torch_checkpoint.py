"""Checkpoints across the two packages, on the CPU.

The port reads the JAX package's ``save_pretrained`` output with its own
msgpack reader of flax's layout (``utils/msgpack_io.py``) and writes the
same layout back; each package must load the other's checkpoint with equal
parameters (bf16 bytes included) and, for the port, equal tokens.  A
subprocess in ``tests/test_torch_slice.py`` does the port's round trip with
jax, flax and msgpack blocked.
"""

import json

import msgpack
import numpy as np
import pytest
import jax
import torch
from flax import serialization

from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.processing import ASRProcessor as JaxASRProcessor
from tiny_audio_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.processing import ASRProcessor
from tiny_audio_tpu_torch.utils import msgpack_io

torch.set_num_threads(1)


def _leaves(tree):
    return {"/".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _bits(x) -> tuple[str, bytes]:
    """The leaf's dtype name and raw bytes, for a torch tensor or an array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        return name, x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    x = np.asarray(x)
    return x.dtype.name, np.ascontiguousarray(x).tobytes()


def _assert_same_params(got: dict, want: dict) -> None:
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for key in want:
        assert np.shape(got[key]) == np.shape(want[key]), key
        assert _bits(got[key]) == _bits(want[key]), key


@pytest.mark.parametrize("model_dtype", ["bfloat16", "float32"])
def test_jax_checkpoint_loads_in_port_and_back(tmp_path, model_dtype):
    cfg = tiny_test_config(model_dtype=model_dtype, kv_cache_dtype="int8")
    jm = JaxASRModel(cfg, seed=0)
    jm.save_pretrained(tmp_path / "jax")
    tm = ASRModel.from_pretrained(tmp_path / "jax", device="cpu")
    assert tm.config.to_dict() == cfg.to_dict()
    _assert_same_params(state_dict_to_jax(tm), jm.params)

    tm.save_pretrained(tmp_path / "port")
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert json.loads((tmp_path / "port" / "tpu_metadata.json").read_text()) == \
        json.loads((tmp_path / "jax" / "tpu_metadata.json").read_text())
    jm2 = JaxASRModel.from_pretrained(tmp_path / "port")
    _assert_same_params(jm2.params, jm.params)


def test_jax_checkpoint_gives_jax_tokens(tmp_path):
    cfg = tiny_test_config(model_dtype="float32")
    cfg.max_new_tokens = 12
    jm = JaxASRModel(cfg, seed=3)
    jm.save_pretrained(tmp_path)
    tm = ASRModel.from_pretrained(tmp_path, device="cpu")
    rng = np.random.default_rng(0)
    audio = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (16000, 9000)]
    jf = JaxASRProcessor(jm.tokenizer, jm.projector, num_mel_bins=80).extract_features(audio)
    tproc = ASRProcessor(tm.tokenizer, tm.projector, num_mel_bins=80, device="cpu")
    tf = tproc.extract_features(audio)
    want = jm.generate(jf["input_features"], jf["audio_attention_mask"], min_new_tokens=6)
    got = tm.generate(tf["input_features"], tf["audio_attention_mask"], min_new_tokens=6)
    np.testing.assert_array_equal(got, want)


def test_projector_only_checkpoint_keeps_seeded_towers(tmp_path):
    """Without towers.msgpack (and a frozen language model) only the
    projector loads; the towers keep the port's seeded random weights, as
    the JAX package keeps its own."""
    cfg = tiny_test_config(model_dtype="float32")
    assert cfg.freeze_language_model
    jm = JaxASRModel(cfg, seed=0)
    jm.save_pretrained(tmp_path, save_towers=False)
    assert not (tmp_path / "towers.msgpack").exists()
    tm = ASRModel.from_pretrained(tmp_path, device="cpu")
    fresh = ASRModel(tm.config, device="cpu")
    got = state_dict_to_jax(tm)
    _assert_same_params(got["projector"], jm.params["projector"])
    _assert_same_params(got["encoder"], state_dict_to_jax(fresh)["encoder"])


def test_adapter_checkpoint_raises(tmp_path):
    """``adapter.msgpack`` no longer raises now that LoRA is ported: a
    JAX stage-2 checkpoint (LoRA leaves in the adapter file, the base in
    the towers) loads with equal parameters, and an adapter file beside a
    config without ``use_lora`` is ignored, as the JAX package ignores it."""
    cfg = tiny_test_config(model_dtype="float32", use_lora=True)
    jm = JaxASRModel(cfg, seed=0)
    layers = jm.params["decoder"]["layers"]
    layers["q_proj_lora_b"] = layers["q_proj_lora_b"] + 0.5
    jm.save_pretrained(tmp_path / "lora")
    assert (tmp_path / "lora" / "adapter.msgpack").exists()
    tm = ASRModel.from_pretrained(tmp_path / "lora", device="cpu")
    _assert_same_params(state_dict_to_jax(tm), jm.params)

    plain = tiny_test_config(model_dtype="float32")
    JaxASRModel(plain, seed=0).save_pretrained(tmp_path / "plain")
    (tmp_path / "plain" / "adapter.msgpack").write_bytes((tmp_path / "lora" / "adapter.msgpack")
                                                         .read_bytes())
    tm = ASRModel.from_pretrained(tmp_path / "plain", device="cpu")
    assert not any("lora" in name for name, _ in tm.named_parameters())


def test_chunked_arrays_read_and_write(monkeypatch):
    """flax splits an array over MAX_CHUNK_SIZE bytes into flat pieces; both
    directions must handle it (a small limit stands in for the 1 GiB one)."""
    rng = np.random.default_rng(0)
    tree = {"big": rng.standard_normal((5, 7)).astype(np.float32),
            "small": np.arange(3, dtype=np.int32),
            "nested": {"bf16": jax.numpy.asarray(rng.standard_normal((4, 6)),
                                                 jax.numpy.bfloat16)}}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 40)
    encoded = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in encoded
    _assert_same_params(msgpack_io.from_bytes(encoded), tree)

    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 40)
    ported = msgpack_io.from_bytes(encoded)
    written = msgpack_io.to_bytes(ported)
    assert b"__msgpack_chunked_array__" in written
    _assert_same_params(serialization.msgpack_restore(written), tree)


def test_msgpack_values_match_the_msgpack_package():
    """Scalars, strings, containers and arrays of every dtype (0-d, empty)
    read as msgpack reads them; the ints, bools, keys and maps the port
    writes read back there."""
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129,
            -32768, -32769, -2**31 - 1, -2**40]
    values = {
        "ints": ints, "floats": [0.5, -1e300], "flags": [True, False, None],
        "text": ["", "a" * 31, "b" * 32, "é" * 200, "c" * 70000],
        "blob": b"\x00\x01",
        "many": {str(i): i for i in range(20)},
    }
    got = msgpack_io.from_bytes(msgpack.packb(values, use_bin_type=True))
    got["blob"] = bytes(got["blob"])
    assert got == values
    written = {"k" * 40: {str(i): n for i, n in enumerate(ints)}, "flags": {"t": True, "f": False},
               **{str(i): i for i in range(20)}}
    assert msgpack.unpackb(msgpack_io.to_bytes(written), raw=False) == written
    with pytest.raises(TypeError):
        msgpack_io.to_bytes({"x": 0.5})

    arrays = {name: np.arange(6).astype(name).reshape(2, 3) for name in
              ("bool", "int8", "uint8", "int16", "int32", "int64", "float16", "float32",
               "float64")}
    arrays["scalar"] = np.float32(2.5)  # ext 3: a numpy scalar
    arrays["zero_d"] = np.array(7, np.int32)
    arrays["empty"] = np.zeros((0, 4), np.float32)
    encoded = serialization.msgpack_serialize(arrays)
    ported = msgpack_io.from_bytes(encoded)
    assert ported["scalar"].ndim == 0 and float(ported["scalar"]) == 2.5
    _assert_same_params({k: v for k, v in ported.items() if k != "scalar"},
                        {k: v for k, v in arrays.items() if k != "scalar"})
    back = serialization.msgpack_restore(msgpack_io.to_bytes(ported))
    _assert_same_params({k: v for k, v in back.items() if k != "scalar"},
                        {k: v for k, v in arrays.items() if k != "scalar"})


def test_bridge_takes_numpy_and_torch_leaves():
    cfg = tiny_test_config()  # bf16
    jm = JaxASRModel(cfg, seed=0)
    from_numpy = jax_to_state_dict(jax.tree.map(np.asarray, jm.params))
    from_torch = jax_to_state_dict(msgpack_io.from_bytes(serialization.to_bytes(jm.params)))
    assert from_numpy.keys() == from_torch.keys()
    for name, value in from_numpy.items():
        assert value.dtype == from_torch[name].dtype, name
        assert torch.equal(value, from_torch[name]), name
    assert from_numpy["decoder.embed_tokens.weight"].dtype == torch.bfloat16

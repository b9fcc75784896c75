"""Multi-GPU serving in the port on the CPU: the ``(dp, tp)`` rules and the grid.

The port's sharding rules against the JAX package's ``parallel/mesh.py``
(every leaf of the tiny trees, mapped to the port's layout), the grid's
guards, and serving over grids of CPU rank processes (gloo), each world
started once for a group of tests: tp- and dp-sharded ``generate`` must give
the port's single-device tokens and the JAX package's, in fp32, exactly
(``tests/test_sharded_inference.py`` holds JAX's own mesh to that), over
both KV caches and both decode steps, beams, sampling and streaming; the
handler, the batcher and the continuous engine return the solo transcripts;
a sharded ``save_pretrained`` writes the single-device files; a rank that
raises fails the call within its deadline.
"""

import contextlib
import dataclasses
import functools
import io
import time
import types

import numpy as np
import pytest
import jax
import torch

from tiny_audio_tpu.config import tiny_test_config
from tiny_audio_tpu.models.asr import ASRModel as JaxASRModel
from tiny_audio_tpu.parallel import mesh as jax_mesh
from tiny_audio_tpu_torch.batching import DynamicBatcher
from tiny_audio_tpu_torch.bridge import jax_leaf, load_jax_params
from tiny_audio_tpu_torch.config import ASRConfig as PortASRConfig
from tiny_audio_tpu_torch.continuous import ContinuousEngine
from tiny_audio_tpu_torch.handler import EndpointHandler
from tiny_audio_tpu_torch.models.asr import ASRModel
from tiny_audio_tpu_torch.parallel import mesh as port_mesh
from tiny_audio_tpu_torch.parallel.faults import FaultProbe
from tiny_audio_tpu_torch.parallel.launch import Probe, RankError
from tiny_audio_tpu_torch.pipeline import ASRPipeline
from tiny_audio_tpu_torch.utils import msgpack_io

torch.set_num_threads(1)

#: seconds a test's world may take to answer one collective or call
TIMEOUT = 60
FAMILIES = {
    "mlp": {},
    "moe": {"projector_type": "moe"},
    "llama": {"decoder": {"qk_norm": False}},
    "gemma": {"decoder": {"qk_norm": False, "rms_norm_offset": True,
                          "hidden_activation": "gelu_tanh", "embedding_normalizer": True}},
}


def _jax_config(family: str, kv_cache_dtype: str = "bfloat16"):
    knobs = dict(FAMILIES[family])
    dec = knobs.pop("decoder", {})
    cfg = tiny_test_config(model_dtype="float32", kv_cache_dtype=kv_cache_dtype, **knobs)
    cfg.decoder = dataclasses.replace(cfg.decoder, kv_cache_dtype=kv_cache_dtype, **dec)
    cfg.max_new_tokens = 8
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_model(family: str, kv_cache_dtype: str) -> JaxASRModel:
    return JaxASRModel(_jax_config(family, kv_cache_dtype), seed=0)


def _port(family: str, kv_cache_dtype: str = "bfloat16") -> ASRModel:
    """A port model with the JAX model's params (a fresh one each call)."""
    jm = _jax_model(family, kv_cache_dtype)
    tm = ASRModel(PortASRConfig.from_dict(jm.config.to_dict()), seed=1, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.params))
    return tm


@functools.lru_cache(maxsize=None)
def _jax_tokens(family: str, kv_cache_dtype: str, b: int, seed: int, **kw) -> np.ndarray:
    return np.asarray(_jax_model(family, kv_cache_dtype).generate(*_feats(b, seed), **kw))


def _feats(b: int, seed: int, t: int = 50):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 80, t)).astype(np.float32), np.ones((b, t), np.int32))


def _clip(seed: int, n: int = 8000) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(np.float32)


def _cpu_mesh(dp: int, tp: int):
    return port_mesh.make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp), timeout=TIMEOUT)


# ------------------------------------------------------------------ rules


@functools.lru_cache(maxsize=None)
def _jax_leaves(family: str):
    cfg = _jax_config(family)
    params = JaxASRModel(cfg, seed=0).params
    leaves = jax.tree_util.tree_leaves_with_path(params)
    return cfg, params, [(jax_mesh._path_str(p), np.asarray(v)) for p, v in leaves]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_rules_split_the_dimension_jax_splits(family):
    """For every leaf of the JAX tree, the port's spec is JAX's, and the port
    tensor's split dimension is JAX's split axis in the port's layout."""
    cfg, _, leaves = _jax_leaves(family)
    tm = ASRModel(PortASRConfig.from_dict(cfg.to_dict()), seed=0, device="cpu")
    modules = dict(tm.named_modules())
    by_path = {}
    for name, param in tm.named_parameters():
        path, index, layout = jax_leaf(modules, name)
        by_path.setdefault("/".join(path), []).append((name, param, index, layout))
    n_split = 0
    for path, value in leaves:
        want = jax_mesh.param_pspec(path)
        assert tuple(port_mesh.param_pspec(path)) == tuple(want), path
        jax_axis = next((i for i, a in enumerate(want) if a == "tp"), None)
        for name, param, index, layout in by_path[path]:
            spec = port_mesh.port_spec(port_mesh.param_pspec(path), index is not None, layout)
            dim = port_mesh.split_dim(spec)
            if jax_axis is None:
                assert dim is None, name
                continue
            n_split += 1
            # the port tensor's dim holds the JAX leaf's split axis
            jax_shape = value.shape[1:] if index is not None else value.shape
            axis = jax_axis - (index is not None)
            if layout == "dense":
                axis = 1 - axis
            assert dim == axis, (name, dim, axis)
            assert param.shape[dim] == jax_shape[jax_axis - (index is not None)], name
    assert n_split > 0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_shards_concatenate_to_the_full_leaf(family):
    """``shard_params`` of the JAX tree at tp = 2: each rank's split leaves
    are contiguous slices that concatenate back to the full leaf bitwise;
    at tp = 4 the two KV heads are held by two ranks each."""
    cfg, params, leaves = _jax_leaves(family)
    tree = jax.tree.map(lambda v: torch.from_numpy(np.array(v)), params)
    pcfg = PortASRConfig.from_dict(cfg.to_dict())
    shards = [port_mesh.shard_params(tree, types.SimpleNamespace(tp=2, tp_rank=r), pcfg)
              for r in range(2)]
    flat = [dict(port_mesh_leaves(s)) for s in shards]
    for path, value in leaves:
        axis = port_mesh.split_dim(port_mesh.param_pspec(path))
        parts = [f[path] for f in flat]
        if axis is None:
            assert all(p is flat[0][path] for p in parts)
            continue
        assert all(p.is_contiguous() for p in parts)
        torch.testing.assert_close(torch.cat(parts, dim=axis), torch.from_numpy(np.array(value)),
                                   rtol=0, atol=0)
    four = [dict(port_mesh_leaves(port_mesh.shard_params(
        tree, types.SimpleNamespace(tp=4, tp_rank=r), pcfg))) for r in range(4)]
    k = "decoder/layers/k_proj/kernel"
    hd = cfg.decoder.head_dim
    full = torch.from_numpy(np.array(dict(leaves)[k]))
    for r in range(4):
        head = r // 2  # 2 KV heads over 4 ranks
        assert torch.equal(four[r][k], full[..., head * hd:(head + 1) * hd])


def port_mesh_leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from port_mesh_leaves(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), value


def test_grid_guards():
    """tp must divide the heads, FFN units, vocabulary and experts (and
    divide or be a multiple of the KV heads), naming both counts; too few
    cards, two NCCL ranks on one card and NCCL on the CPU raise before any
    rank starts."""
    cfg = PortASRConfig.from_dict(_jax_config("moe").to_dict())
    with pytest.raises(ValueError, match=r"tp=3 does not divide the decoder query heads \(4\)"):
        port_mesh.check_grid(cfg, 3)
    cfg.num_experts = 6
    with pytest.raises(ValueError, match=r"MoE experts \(6\)"):
        port_mesh.check_grid(cfg, 4)
    cfg = PortASRConfig.from_dict(_jax_config("mlp").to_dict())
    cfg.decoder = dataclasses.replace(cfg.decoder, num_kv_heads=4, num_heads=8)
    cfg.encoder = dataclasses.replace(cfg.encoder, num_heads=8)
    port_mesh.check_grid(cfg, 2)
    port_mesh.check_grid(cfg, 8)  # 4 KV heads, each held by two ranks
    cfg.decoder = dataclasses.replace(cfg.decoder, num_kv_heads=3)
    with pytest.raises(ValueError, match=r"KV heads \(3\)"):
        port_mesh.check_grid(cfg, 2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 CUDA cards"):
            port_mesh.make_mesh(tp=2)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one device"):
        port_mesh.make_mesh(dp=1, tp=2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="NCCL needs one card a rank"):
        port_mesh.make_mesh(tp=2, devices=["cpu", "cpu"], backend="nccl")
    with pytest.raises(ValueError, match="dp\\*tp=3 != device count 2"):
        port_mesh.make_mesh(dp=3, tp=1, devices=["cpu", "cpu"])


def test_a_raising_rank_fails_the_call_and_stops_the_ranks():
    """Rank 1 raises while rank 0 waits in an all-reduce with it: the call
    raises RankError with rank 1's traceback within the deadline, every rank
    is stopped, and the mesh refuses later calls.  Rank 0 raising does the
    same.  The started rank imports neither jax nor the JAX package."""
    for bad in (1, 0):
        mesh = _cpu_mesh(1, 2)
        try:
            probe = Probe.place(mesh)
            if bad == 1:
                modules = mesh.dispatch(probe, "loaded_modules", (), {}, gather=True)[1]
                tops = {m.split(".")[0] for m in modules}
                assert not tops & {"jax", "jaxlib", "flax", "tiny_audio_tpu"}, tops
                assert "tiny_audio_tpu_torch" in tops
            faults = FaultProbe.place(mesh)
            procs = list(mesh.world.procs.values())
            t0 = time.monotonic()
            with pytest.raises(RankError if bad else RuntimeError,
                               match=f"failure injected on rank {bad}"):
                faults.fail_on(bad)
            assert time.monotonic() - t0 < TIMEOUT
            assert mesh.failed is not None and mesh.closed
            assert all(p.poll() is not None for p in procs)
            with pytest.raises(RuntimeError, match="mesh failed earlier"):
                probe.loaded_modules()
        finally:
            mesh.close()
    assert port_mesh._ACTIVE is None


# ------------------------------------------------------------ tp = 2 world


@pytest.fixture(scope="class")
def world_tp2():
    mesh = _cpu_mesh(1, 2)
    yield mesh
    mesh.close()


def _check_tokens(family, kv, single, sharded, b, seed, fused=(None,), **kw):
    """The grid's tokens equal one device's (on each decode step in
    ``fused``) and the JAX package's."""
    feats, mask = _feats(b, seed)
    want = single.generate(feats, mask, **kw)
    np.testing.assert_array_equal(_jax_tokens(family, kv, b, seed, **kw), want)
    for f in fused:
        np.testing.assert_array_equal(sharded.generate(feats, mask, fused_decode=f, **kw),
                                      single.generate(feats, mask, fused_decode=f, **kw))


class TestTensorParallel:
    """One (dp=1, tp=2) world of two CPU ranks for every test here."""

    @pytest.fixture(scope="class")
    def mlp(self, world_tp2):
        """Per KV cache: (JAX model, port single-device model, port model on
        the grid)."""
        return {kv: (_port("mlp", kv), _port("mlp", kv).place_on(world_tp2))
                for kv in ("bfloat16", "int8")}

    @pytest.mark.parametrize("fused", [False, True])
    @pytest.mark.parametrize("kv", ["bfloat16", "int8"])
    def test_generate_matches_one_device_and_jax(self, mlp, kv, fused):
        single, sharded = mlp[kv]
        _check_tokens("mlp", kv, single, sharded, 2, 0, fused=(fused,), max_new_tokens=6)

    @pytest.mark.parametrize("kv", ["bfloat16", "int8"])
    @pytest.mark.parametrize("family", ["moe", "llama", "gemma"])
    def test_families(self, world_tp2, family, kv):
        single, sharded = _port(family, kv), _port(family, kv).place_on(world_tp2)
        assert sharded.decoder.layers[0].num_heads == 2
        if family == "moe":
            assert sharded.projector.experts_fc1_kernel.shape[0] == 2
        _check_tokens(family, kv, single, sharded, 2, 3, fused=(False, True),
                      max_new_tokens=6)

    def test_every_rank_decodes_the_same_tokens(self, world_tp2, mlp):
        single, sharded = mlp["int8"]
        feats, mask = _feats(3, 5)
        per_rank = world_tp2.dispatch(sharded, "generate", (feats, mask),
                                      {"max_new_tokens": 6}, gather=True)
        assert len(per_rank) == 2
        for tokens in per_rank:
            np.testing.assert_array_equal(tokens, single.generate(feats, mask, max_new_tokens=6))

    def test_beams_and_sampling(self, mlp):
        """Beam search (both steps) equals one device's and JAX's; seeded
        sampling (every rank draws from the same generator over the same
        full logits) equals one device's draws."""
        single, sharded = mlp["bfloat16"]
        _check_tokens("mlp", "bfloat16", single, sharded, 2, 7, fused=(False, True),
                      max_new_tokens=6, num_beams=3)
        feats, mask = _feats(2, 7)
        kw = dict(max_new_tokens=8, do_sample=True, temperature=1.5, top_k=50, top_p=0.95)
        for seed in (0, 5):
            gen = torch.Generator().manual_seed(seed)
            got = sharded.generate(feats, mask, generator=gen, **kw)
            want = single.generate(feats, mask, generator=torch.Generator().manual_seed(seed),
                                   **kw)
            np.testing.assert_array_equal(got, want)
            # the caller's generator advanced as on one device
            ref = torch.Generator().manual_seed(seed)
            single.generate(feats, mask, generator=ref, **kw)
            assert torch.equal(gen.get_state(), ref.get_state())

    def test_streaming(self, mlp):
        single, sharded = mlp["bfloat16"]
        feats, mask = _feats(1, 9)
        want = list(single.generate_streaming(feats, mask))
        assert list(sharded.generate_streaming(feats, mask)) == want
        # a consumer that stops early leaves the ranks in step
        stream = sharded.generate_streaming(feats, mask)
        next(stream, None)
        stream.close()
        assert list(sharded.generate_streaming(feats, mask)) == want

    def test_handler_on_a_given_mesh(self, world_tp2):
        """EndpointHandler(pipeline, tp=2) on a pipeline whose model the
        caller placed on a grid serves on that grid; its transcripts are the
        single-device ones."""
        single, sharded = _port("mlp"), _port("mlp").place_on(world_tp2)
        clips = [_clip(s) for s in range(2)]
        handler = EndpointHandler(pipeline=ASRPipeline(sharded), tp=2)
        assert handler.mesh is world_tp2 and sharded.mesh is world_tp2
        assert [handler({"inputs": c})["text"] for c in clips] == \
            [ASRPipeline(single)(c)["text"] for c in clips]
        handler.close()  # not its mesh: the grid stays up
        assert not world_tp2.closed

    def test_save_pretrained_writes_the_single_device_files(self, mlp, tmp_path):
        single, sharded = mlp["bfloat16"]
        single.save_pretrained(tmp_path / "one")
        sharded.save_pretrained(tmp_path / "grid")
        names = sorted(p.name for p in (tmp_path / "one").iterdir())
        assert names == sorted(p.name for p in (tmp_path / "grid").iterdir())
        assert "towers.msgpack" in names
        for name in names:
            want = (tmp_path / "one" / name).read_bytes()
            assert (tmp_path / "grid" / name).read_bytes() == want, name
        tree = msgpack_io.load(tmp_path / "grid" / "towers.msgpack")
        assert tuple(tree["decoder"]["embed_tokens"]["embedding"].shape) == (512, 64)


# --------------------------------------------------------- other grids


def test_dp2_tp2_matches_single_device():
    """The counterpart of JAX's test_tp2_matches_single_device: a (2, 2)
    grid, batch 2 split over dp, tokens equal to one device's (both caches,
    both steps) and JAX's; an odd batch (3 rows over dp = 2) too."""
    with _cpu_mesh(2, 2) as mesh:
        for kv in ("bfloat16", "int8"):
            single, sharded = _port("mlp", kv), _port("mlp", kv).place_on(mesh)
            _check_tokens("mlp", kv, single, sharded, 2, 0, fused=(False, True),
                          max_new_tokens=6)
        feats, mask = _feats(3, 1)
        np.testing.assert_array_equal(sharded.generate(feats, mask, max_new_tokens=6),
                                      single.generate(feats, mask, max_new_tokens=6))


def test_tp4_replicates_the_kv_heads():
    """tp = 4 over the tiny decoder's 2 KV heads: each rank holds the KV
    head its one query head reads; the tokens stay exact on both steps and
    both caches."""
    with _cpu_mesh(1, 4) as mesh:
        for kv in ("bfloat16", "int8"):
            single, sharded = _port("mlp", kv), _port("mlp", kv).place_on(mesh)
            block = sharded.decoder.layers[0]
            assert (block.num_heads, block.num_kv_heads) == (1, 1)
            _check_tokens("mlp", kv, single, sharded, 2, 0, fused=(False, True),
                          max_new_tokens=6)


@pytest.mark.parametrize("grid", [{"tp": 2}, {"dp": 2}])
def test_handler_makes_its_own_grid(grid, tmp_path, capsys):
    """EndpointHandler(path, tp=2) and (path, dp=2) as in the JAX package:
    a grid of exactly dp * tp devices (CPU ranks for a CPU model), every
    rank loading the checkpoint, the int8 flags ignored with the JAX
    package's messages; the handler, the dynamic batcher and the continuous
    engine give the single-device transcripts; close() stops the ranks."""
    single = _port("mlp")
    single.save_pretrained(tmp_path / "ckpt")
    clips = [_clip(s) for s in range(3)]
    want = [ASRPipeline(single)(c)["text"] for c in clips]
    single_engine = ContinuousEngine(ASRPipeline(single), n_slots=4, start=False)
    handler = EndpointHandler(str(tmp_path / "ckpt"), device="cpu", wq_decode=True,
                              w8a8_head=True, w8a8_decode=True, **grid)
    try:
        out = capsys.readouterr().out
        for flag in ("--wq-decode", "--w8a8-head", "--w8a8-decode"):
            assert f"[handler] {flag} ignored under --tp/--dp" in out
        assert handler.mesh.shape == {"dp": grid.get("dp", 1), "tp": grid.get("tp", 1)}
        assert handler.pipe.model.wq is None
        assert [handler({"inputs": c})["text"] for c in clips] == want
        batcher = DynamicBatcher(handler.pipe, max_batch=4, max_wait_ms=200.0)
        try:
            futures = [batcher.submit(c) for c in clips]
            assert [f.result(timeout=TIMEOUT) for f in futures] == want
        finally:
            batcher.close()
        engine = ContinuousEngine(handler.pipe, n_slots=4, start=False)
        texts = []
        for eng in (engine, single_engine):
            futures = [eng.submit(c) for c in clips]
            eng._prefill_and_insert(eng._admit())
            while any(slot is not None for slot in eng._slots):
                eng._decode_one_chunk()
            texts.append([f.result(timeout=1) for f in futures])
        assert texts[0] == texts[1]
    finally:
        handler.close()
    assert handler.mesh.closed


def test_serve_prints_the_mesh(monkeypatch, tmp_path):
    """serve(tp=2) prints the JAX package's "towers sharded over mesh" line
    and closes the grid when the server stops."""
    from tiny_audio_tpu_torch import serving

    _port("mlp").save_pretrained(tmp_path / "ckpt")

    def interrupted():
        raise KeyboardInterrupt

    monkeypatch.setattr(serving, "make_server", lambda handler, *a, **k: types.SimpleNamespace(
        serve_forever=interrupted, shutdown=lambda: None,
        metrics=types.SimpleNamespace(gauge_fns={})))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serving.serve(str(tmp_path / "ckpt"), port=0, warmup=False, engine="none", tp=2,
                      device="cpu")
    assert "[serve] towers sharded over mesh {'dp': 1, 'tp': 2}" in out.getvalue()
    assert port_mesh._ACTIVE is None

"""The ``(dp, tp)`` grid of rank processes, and the sharding rules.

Port of :mod:`tiny_audio_tpu.parallel.mesh`.  The JAX package runs its mesh
from one process and GSPMD inserts the collectives; here every point of the
grid is a process of its own (:mod:`torch.distributed`), rank
``dp_index * tp + tp_index`` (the JAX mesh's ``reshape(dp, tp)``), and the
modules call the collectives themselves (:mod:`tiny_audio_tpu_torch.models.
layers`).  Rank 0 is the caller's process; :func:`make_mesh` starts the
other ranks (:mod:`.launch`).

Sharding layout: the JAX package's regex table (same patterns, same specs,
in the JAX params tree's layout: decoder and encoder leaves stacked
``[L, ...]``, Dense kernels ``[in, out]``), read through
:func:`tiny_audio_tpu_torch.bridge.jax_leaf`, which names every port
parameter's JAX path and layout:

- attention/FFN in-projections split their output (heads, FFN units),
  out-projections their input, so a block needs one all-reduce per
  sublayer; the encoder's q/v/fc1 biases split with their outputs, the
  out-projections' biases stay whole and are added once after the reduce;
- the embedding and the LM head split the vocabulary;
- the MoE projector's stacked experts split over tp (expert parallelism);
- everything else (norms, convs, the other projectors) is replicated.

The port adds rules for LoRA (the JAX package replicates its leaves and lets
GSPMD reshard): ``lora_b`` of a column-parallel projection splits with its
output, ``lora_a`` of a row-parallel one with its input.  When tp exceeds the
decoder's KV heads, each rank holds the KV head its query heads read (the
JAX package splits a head and reshards); tp must then be a multiple of the
KV heads.
"""

from __future__ import annotations

import atexit
import datetime
import os
import re
import tempfile
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist


class P(tuple):
    """A partition spec: one entry per tensor dimension, ``"tp"``/``"dp"``
    or None (jax.sharding.PartitionSpec's meaning)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# (regex on 'tower/flattened/param/path', PartitionSpec) — first match wins.
# Decoder kernels are stacked [L, in, out] (scan-over-layers), so the sharded
# matmul dim is axis 1 or 2.
_PARAM_RULES: list[tuple[str, P]] = [
    # Decoder attention & MLP in-projections: shard output dim
    (r"decoder/.*(q_proj|k_proj|v_proj|gate_proj|up_proj)/kernel", P(None, None, "tp")),
    # Decoder out-projections: shard input dim
    (r"decoder/.*(o_proj|down_proj)/kernel", P(None, "tp", None)),
    # Decoder embeddings: vocab over tp
    (r"decoder/embed_tokens/embedding", P("tp", None)),
    (r"decoder/lm_head/kernel", P(None, "tp")),
    # Encoder attention & MLP (stacked [L, in, out])
    (r"encoder/.*(q_proj|k_proj|v_proj|fc1)/kernel", P(None, None, "tp")),
    (r"encoder/.*(out_proj|fc2)/kernel", P(None, "tp", None)),
    (r"encoder/.*(q_proj|v_proj|fc1)/bias", P(None, "tp")),
    # MoE projector: stacked experts [E, ...] sharded over tp (expert
    # parallelism — each chip holds E/tp experts; the dense-dispatch einsum
    # partitions on the expert axis with one reduce at the gate sum)
    (r"projector/experts_fc\d_kernel", P("tp", None, None)),
    (r"projector/experts_fc\d_bias", P("tp", None)),
    # Everything else replicated
    (r".*", P()),
]

# The port's own rules, read before the table: LoRA leaves [L, K, r] / [L, r, N]
# split with the projection they belong to.
_LORA_RULES: list[tuple[str, P]] = [
    (r"decoder/.*(q_proj|k_proj|v_proj|gate_proj|up_proj)_lora_b", P(None, None, "tp")),
    (r"decoder/.*(o_proj|down_proj)_lora_a", P(None, "tp", None)),
]

# leaves whose split axis holds KV heads (replicated per rank when tp > heads)
_KV_HEADS = r"decoder/.*(k_proj/kernel|v_proj/kernel|k_proj_lora_b|v_proj_lora_b)"


def param_pspec(path: str) -> P:
    """The JAX package's spec for the params-tree leaf ``path`` (its
    layout), the port's LoRA rules first."""
    for pattern, spec in _LORA_RULES + _PARAM_RULES:
        if re.fullmatch(pattern, path):
            return spec
    return P()


def port_spec(spec: P, stacked: bool, layout: Optional[str]) -> P:
    """``spec`` of a JAX leaf in the layout of the port's tensor:
    ``stacked`` drops the leading layer axis (the port holds one module per
    layer), ``layout`` ``"dense"`` turns a kernel ``[in, out]`` into a
    Linear weight ``[out, in]`` and ``"conv"`` a kernel ``[k, in, out]``
    into a Conv1d weight ``[out, in, k]`` (:func:`bridge.jax_leaf`)."""
    axes = list(spec)
    if stacked and axes:
        axes = axes[1:]
    if layout == "dense" and axes:
        axes = (axes + [None] * (2 - len(axes)))[::-1]
    elif layout == "conv" and axes:
        axes = (axes + [None] * (3 - len(axes)))[::-1]
    while axes and axes[-1] is None:
        axes.pop()
    return P(*axes)


def split_dim(spec: P) -> Optional[int]:
    """The dimension ``spec`` splits over tp, or None (replicated)."""
    return next((i for i, axis in enumerate(spec) if axis == "tp"), None)


def check_grid(config, tp: int) -> None:
    """Raise ``ValueError`` (naming both counts) when ``tp`` does not divide
    what it splits: the decoder's query heads, FFN units and vocabulary, its
    KV heads (or tp is not a multiple of them), the encoder's heads and FFN
    units, the MoE projector's experts."""
    if tp < 1:
        raise ValueError(f"tp={tp}: the grid needs tp >= 1")
    dec, enc = config.decoder, config.encoder
    counts = [("decoder query heads", dec.num_heads),
              ("decoder intermediate_size", dec.intermediate_size),
              ("decoder vocab_size", dec.vocab_size),
              ("encoder heads", enc.num_heads),
              ("encoder ffn_dim", enc.ffn_dim)]
    if config.projector_type == "moe":
        counts.append(("MoE experts", config.num_experts))
    for what, n in counts:
        if n % tp:
            raise ValueError(f"tp={tp} does not divide the {what} ({n})")
    kv = dec.num_kv_heads
    if kv % tp and tp % kv:
        raise ValueError(f"tp={tp} neither divides the decoder KV heads ({kv}) "
                         "nor is a multiple of them")


def shard_range(path: str, full: int, tp: int, tp_rank: int,
                kv_heads: Optional[int] = None, head_dim: Optional[int] = None
                ) -> tuple[int, int]:
    """(start, length) of tp rank ``tp_rank``'s slice of a split axis of
    ``full`` entries.  KV-head axes (``kv_heads``, ``head_dim`` given) hold
    ``kv_heads / tp`` heads a rank, or, for tp > ``kv_heads``, the one head
    the rank's query heads read."""
    if kv_heads is not None and re.fullmatch(_KV_HEADS, path) and tp > kv_heads:
        return (tp_rank * kv_heads // tp) * head_dim, head_dim
    if full % tp:
        raise ValueError(f"{path}: tp={tp} does not divide its split axis ({full})")
    n = full // tp
    return tp_rank * n, n


class Axis:
    """One axis of the grid seen from a rank: its process group, its size,
    the rank's index on it, and the collectives the modules call.  With
    ``gloo`` a CUDA tensor goes through the host and low-precision floats
    are summed in fp32 and rounded once; NCCL reduces in the tensor's own
    dtype, on the card."""

    def __init__(self, group, ranks: Sequence[int], index: int, backend: str):
        self.group = group
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.index = index
        self.backend = backend

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self.backend == "gloo" and x.is_cuda else x

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: the sum (or ``"max"``/``"min"``) of ``x`` over the axis."""
        low = x.is_floating_point() and x.element_size() < 4
        work = torch.float32 if low and self.backend == "gloo" else x.dtype
        buf = self._staged(x.to(dtype=work, copy=True))
        reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                     "min": dist.ReduceOp.MIN}[op]
        dist.all_reduce(buf, op=reduce_op, group=self.group)
        return buf.to(device=x.device, dtype=x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) concatenated along ``dim``, in
        axis order."""
        buf = self._staged(x.contiguous())
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts, dim=dim).to(x.device)


@dataclass
class MeshSpec:
    """What every rank needs to join the grid (sent to the started ranks)."""

    dp: int
    tp: int
    devices: tuple[str, ...]
    backend: str
    init_method: str
    timeout: float
    threads: int
    tmpdir: str


_ACTIVE: Optional["Mesh"] = None


class Mesh:
    """A rank's view of the ``(dp, tp)`` grid: its coordinates, its device,
    and the tp axis (the ranks of its dp row), the dp axis (the ranks of its
    tp column) and the whole world.  On rank 0 it also owns the other ranks
    (:class:`.launch.World`): :meth:`place` puts an object on every rank,
    :meth:`dispatch` runs a method on every rank, :meth:`close` stops them.
    """

    axis_names = ("dp", "tp")

    def __init__(self, spec: MeshSpec, rank: int):
        self.spec = spec
        self.dp, self.tp = spec.dp, spec.tp
        self.rank = rank
        self.dp_rank, self.tp_rank = divmod(rank, spec.tp)
        self.device = torch.device(spec.devices[rank])
        self.backend = spec.backend
        self.world = None  # rank 0: the launch.World of the other ranks
        self.failed: Optional[BaseException] = None
        self.closed = False
        self._lock = threading.RLock()
        self._local = threading.local()
        self._handles = 0
        self._streaming = False
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            spec.backend, init_method=spec.init_method, rank=rank,
            world_size=spec.dp * spec.tp,
            timeout=datetime.timedelta(seconds=spec.timeout))
        # every rank creates every group, in the same order
        tp_axes = [dist.new_group([d * spec.tp + t for t in range(spec.tp)])
                   for d in range(spec.dp)]
        dp_axes = [dist.new_group([d * spec.tp + t for d in range(spec.dp)])
                   for t in range(spec.tp)]
        self.tp_axis = Axis(tp_axes[self.dp_rank],
                            [self.dp_rank * spec.tp + t for t in range(spec.tp)],
                            self.tp_rank, spec.backend)
        self.dp_axis = Axis(dp_axes[self.tp_rank],
                            [d * spec.tp + self.tp_rank for d in range(spec.dp)],
                            self.dp_rank, spec.backend)
        self.world_axis = Axis(dist.group.WORLD, range(spec.dp * spec.tp), rank,
                               spec.backend)

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self) -> int:
        return self.dp * self.tp

    # ------------------------------------------------------------- dispatch

    def inside(self) -> bool:
        """Whether this thread runs a call that every rank runs (always on
        the other ranks; on rank 0 inside :meth:`dispatch`)."""
        return self.rank != 0 or getattr(self._local, "depth", 0) > 0

    def enter(self) -> None:
        self._local.depth = getattr(self._local, "depth", 0) + 1

    def leave(self) -> None:
        self._local.depth -= 1

    def place(self, obj, build, local=None) -> None:
        """Register ``obj`` (rank 0's object) and have every other rank build
        its own with ``build(mesh, objects)`` (sent as a message: its class
        registered with ``launch.message_class``; ``objects`` maps the
        handles placed so far to that rank's objects) while rank 0 runs
        ``local()``."""
        from tiny_audio_tpu_torch.parallel import launch

        with self._lock:
            self._handles += 1
            handle = self._handles
            launch.run_on_ranks(self, ("place", handle, build), local or (lambda: None))
            obj._mesh_handle = handle

    def dispatch(self, obj, name: str, args: tuple, kwargs: dict, gather: bool = False):
        """``obj.<name>(*args, **kwargs)`` on every rank (each on its own
        object); returns rank 0's result, or with ``gather`` every rank's
        results in rank order.  A rank that raises fails the call: the other
        ranks are stopped and the mesh is closed."""
        from tiny_audio_tpu_torch.parallel import launch

        return launch.dispatch(self, obj, name, args, kwargs, gather)

    def check_usable(self) -> None:
        if self.failed is not None:
            raise RuntimeError(f"the mesh failed earlier and was stopped: {self.failed}")
        if self.closed:
            raise RuntimeError("the mesh is closed")

    # ---------------------------------------------------------------- close

    def close(self) -> None:
        """Stop the other ranks (rank 0), leave the process group and remove
        the rendezvous directory.  Idempotent."""
        global _ACTIVE
        if self.closed:
            return
        self.closed = True
        if self.world is not None:
            self.world.stop()
        try:
            if dist.is_initialized():
                dist.destroy_process_group()
        finally:
            if _ACTIVE is self:
                _ACTIVE = None
            if self.rank == 0:
                import shutil

                shutil.rmtree(self.spec.tmpdir, ignore_errors=True)

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")


def _resolve_devices(dp: Optional[int], tp: int, devices) -> list[torch.device]:
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        if dp is None:
            dp = n // tp
        if dp * tp != n:
            raise ValueError(f"mesh dp*tp={dp * tp} != device count {n}")
        return devices
    n_cards = torch.cuda.device_count()
    need = tp * (dp if dp is not None else max(n_cards // tp, 1))
    if need > n_cards:
        raise ValueError(f"a (dp={dp}, tp={tp}) grid needs {need} CUDA cards; this host has "
                         f"{n_cards} (the grid is never shrunk)")
    dp = need // tp
    return [torch.device("cuda", i) for i in range(dp * tp)]


def make_mesh(dp: Optional[int] = None, tp: int = 1, devices: Optional[Sequence] = None,
              backend: Optional[str] = None, timeout: float = 300.0) -> Mesh:
    """Start a ``(dp, tp)`` grid: this process is rank 0, the other
    ``dp * tp - 1`` ranks are processes it starts.  Returns rank 0's
    :class:`Mesh`.

    ``devices``: one per rank (default: the first ``dp * tp`` cards; fewer
    cards raise, the grid is never shrunk); ``dp=None`` is the device count
    over tp.  ``backend``: ``"nccl"`` by default on cards, ``"gloo"`` on the
    CPU; several ranks on one card need ``backend="gloo"`` given explicitly
    (NCCL refuses two ranks on one device).  ``timeout``: seconds for the
    ranks to come up and for any one collective.  Rendezvous is through a
    file in a fresh temporary directory (no TCP port).  One mesh at a time
    in a process; close it with :meth:`Mesh.close` (also at exit)."""
    global _ACTIVE
    from tiny_audio_tpu_torch.parallel import launch

    if tp < 1 or (dp is not None and dp < 1):
        raise ValueError(f"dp={dp} tp={tp}: the grid needs positive sizes")
    if _ACTIVE is not None and not _ACTIVE.closed:
        raise RuntimeError(f"a mesh is already open in this process ({_ACTIVE}); close it first")
    devs = _resolve_devices(dp, tp, devices)
    dp = len(devs) // tp
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"mesh devices must be all CPU or all CUDA, got {devs}")
    if "cuda" in kinds:
        devs = [torch.device("cuda", d.index if d.index is not None else 0) for d in devs]
    shared = len(set(devs)) < len(devs)
    if backend is None:
        if "cuda" in kinds and shared:
            raise ValueError(
                f"devices {[str(d) for d in devs]} put several ranks on one card: NCCL "
                "refuses two ranks on one device; pass backend='gloo'")
        backend = "nccl" if "cuda" in kinds else "gloo"
    if backend == "nccl" and ("cpu" in kinds or shared):
        raise ValueError(
            f"backend='nccl' with devices {[str(d) for d in devs]}: NCCL needs one card "
            "a rank (several ranks on one card need backend='gloo')")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: 'nccl' or 'gloo'")
    if "cuda" in kinds:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass CPU devices to run the mesh on the CPU")
        for d in devs:
            if d.index >= torch.cuda.device_count():
                raise ValueError(f"{d}: this host has {torch.cuda.device_count()} CUDA cards")
    if "cuda" in kinds:
        # every rank loads the kernels this process builds (one build, before
        # any rank starts, into the shared build directory)
        from tiny_audio_tpu_torch import kernels

        kernels.build()
    tmpdir = tempfile.mkdtemp(prefix="ta-mesh-")
    spec = MeshSpec(dp=dp, tp=tp, devices=tuple(str(d) for d in devs), backend=backend,
                    init_method="file://" + os.path.join(tmpdir, "rendezvous"),
                    timeout=float(timeout), threads=torch.get_num_threads(), tmpdir=tmpdir)
    mesh = launch.start(spec)
    _ACTIVE = mesh
    atexit.register(mesh.close)
    return mesh


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _split(modules: dict, name: str) -> tuple[str, Optional[int]]:
    """(JAX path, split dimension of the port's tensor or None) of the port
    parameter ``name``; ``modules`` is ``dict(model.named_modules())``."""
    from tiny_audio_tpu_torch.bridge import jax_leaf

    path, index, layout = jax_leaf(modules, name)
    jax_path = "/".join(path)
    return jax_path, split_dim(port_spec(param_pspec(jax_path), index is not None, layout))


def param_shardings(model, mesh: Mesh) -> dict[str, Optional[tuple[int, int, int]]]:
    """For every parameter of a port ``ASRModel`` (unsharded names and
    shapes): ``(dim, start, length)`` of this rank's slice, or None when it
    is replicated."""
    modules = dict(model.named_modules())
    dec = model.config.decoder
    out = {}
    for name, param in model.named_parameters():
        jax_path, dim = _split(modules, name)
        if dim is None:
            out[name] = None
            continue
        start, length = shard_range(jax_path, param.shape[dim], mesh.tp, mesh.tp_rank,
                                    dec.num_kv_heads, dec.head_dim)
        out[name] = (dim, start, length)
    return out


def shard_params(params: dict, mesh: Mesh, config) -> dict:
    """This rank's shard of a JAX-layout params tree (nested dicts of
    tensors, layers stacked): each split leaf replaced by its own contiguous
    slice, the rest as they are.  ``config``: the model's ``ASRConfig``
    (KV heads)."""
    dec = config.decoder

    def walk(tree, prefix):
        out = {}
        for key, value in tree.items():
            path = prefix + (str(key),)
            if isinstance(value, dict):
                out[key] = walk(value, path)
                continue
            jax_path = "/".join(path)
            dim = split_dim(param_pspec(jax_path))
            if dim is None:
                out[key] = value
                continue
            t = torch.as_tensor(value)
            start, length = shard_range(jax_path, t.shape[dim], mesh.tp, mesh.tp_rank,
                                        dec.num_kv_heads, dec.head_dim)
            out[key] = t.narrow(dim, start, length).contiguous().clone()
        return out

    return walk(params, ())


@torch.no_grad()
def shard_model(model, mesh: Mesh) -> None:
    """Turn a full port ``ASRModel`` on this rank's device into this rank's
    shard, in place: every split parameter becomes its own contiguous
    parameter of the slice (the kernels need their operands contiguous and
    aligned), and the blocks, the decoder and the MoE projector take the
    rank's head counts, vocabulary slice and experts with the tp axis.
    Raises ``ValueError`` when tp does not divide what it splits."""
    check_grid(model.config, mesh.tp)
    modules = dict(model.named_modules())
    model.full_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for name, plan in param_shardings(model, mesh).items():
        if plan is None:
            continue
        dim, start, length = plan
        owner_name, leaf = name.rsplit(".", 1)
        owner = modules[owner_name]
        old = getattr(owner, leaf)
        new = torch.nn.Parameter(old.detach().narrow(dim, start, length).contiguous().clone(),
                                 requires_grad=old.requires_grad)
        setattr(owner, leaf, new)
        if isinstance(owner, torch.nn.Linear) and leaf == "weight":
            owner.out_features, owner.in_features = new.shape
        elif isinstance(owner, torch.nn.Embedding):
            owner.num_embeddings = new.shape[0]
    for module in model.modules():
        if hasattr(module, "shard_axes"):
            module.shard_axes(mesh)
    model.mesh = mesh


def split_plans(model) -> dict[str, tuple[str, Optional[int]]]:
    """(JAX path, split dimension) of every parameter of a sharded model."""
    modules = dict(model.named_modules())
    return {name: _split(modules, name) for name, _ in model.named_parameters()}


@torch.no_grad()
def gather_named(model, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Full host tensors from this rank's slices ``tensors`` of a sharded
    model's parameters (the parameters themselves, or optimizer moments of
    their shapes), by name: a collective over the tp axis (every rank of the
    dp row calls it with the same names)."""
    mesh = model.mesh
    dec = model.config.decoder
    plans = split_plans(model)
    out = {}
    for name, value in tensors.items():
        jax_path, dim = plans[name]
        value = value.detach()
        if dim is None:
            out[name] = value.cpu()
            continue
        parts = mesh.tp_axis.all_gather(value.unsqueeze(0), 0).cpu()
        full = torch.empty(model.full_shapes[name], dtype=value.dtype)
        for t in range(mesh.tp):
            start, length = shard_range(jax_path, full.shape[dim], mesh.tp, t,
                                        dec.num_kv_heads, dec.head_dim)
            full.narrow(dim, start, length).copy_(parts[t])
        out[name] = full
    return out


def slice_named(model, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """This rank's slices of full tensors of a sharded model's parameter
    shapes, by name (the inverse of :func:`gather_named`)."""
    mesh = model.mesh
    dec = model.config.decoder
    plans = split_plans(model)
    out = {}
    for name, value in tensors.items():
        jax_path, dim = plans[name]
        if dim is not None:
            start, length = shard_range(jax_path, value.shape[dim], mesh.tp, mesh.tp_rank,
                                        dec.num_kv_heads, dec.head_dim)
            value = value.narrow(dim, start, length)
        out[name] = value
    return out


def gather_params(model) -> dict[str, torch.Tensor]:
    """The full parameters of a sharded model by name, on the host (see
    :func:`gather_named`)."""
    return gather_named(model, dict(model.named_parameters()))


def grad_reduction(model, name: str) -> Optional[str]:
    """How a gradient of a sharded model's parameter ``name`` is completed
    over tp before its dp all-reduce: None (complete on each rank: split
    leaves, and replicated leaves whose every use is replicated), ``"sum"``
    (a replicated leaf used on this rank's slice only: ``q_norm`` and
    ``k_norm`` on the rank's heads, a row-parallel ``lora_b`` fed this
    rank's partial sums), ``"kv"`` (a KV-head leaf held by several ranks when
    tp exceeds the KV heads: summed over the ranks that hold the head)."""
    mesh = model.mesh
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("q_norm", "k_norm", "o_proj_lora_b", "down_proj_lora_b"):
        return "sum"
    dec = model.config.decoder
    kv = leaf in ("k_proj_lora_b", "v_proj_lora_b") or name.endswith(
        ("k_proj.weight", "v_proj.weight"))
    if name.startswith("decoder.") and kv and mesh.tp > dec.num_kv_heads:
        return "kv"
    return None


def kv_replicas(model) -> int:
    """How many tp ranks hold each decoder KV head (1 unless tp exceeds
    the KV heads)."""
    return max(model.mesh.tp // model.config.decoder.num_kv_heads, 1)


def batch_sharding(mesh: Mesh) -> P:
    """Leading-axis data parallelism for batches: ``P("dp")``."""
    return P("dp")


def dp_rows(n: int, mesh: Optional[Mesh]) -> tuple[int, int, int]:
    """(start, stop, padded) of this rank's rows of an ``n``-row batch: the
    batch padded to a multiple of dp (``padded`` rows), dp row ``i`` taking
    rows ``[i * padded / dp, (i + 1) * padded / dp)``."""
    if mesh is None or mesh.dp == 1:
        return 0, n, n
    padded = -(-n // mesh.dp) * mesh.dp
    per = padded // mesh.dp
    return mesh.dp_rank * per, (mesh.dp_rank + 1) * per, padded


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a batch (every value's leading axis), the batch
    first padded to a multiple of dp by repeating its first rows."""
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value)
        n = t.shape[0]
        start, stop, padded = dp_rows(n, mesh)
        if padded != n:
            t = torch.cat([t, t[torch.arange(padded - n) % n]])
        out[key] = t[start:stop]
    return out

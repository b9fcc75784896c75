"""The rank processes of a mesh, and the calls rank 0 sends them.

:func:`start` (through :func:`.mesh.make_mesh`) starts ranks ``1 ..
dp*tp - 1`` as ``python -m tiny_audio_tpu_torch.parallel.launch`` processes
(a rank imports only the port, never the caller's main script), each with a
socket pair to rank 0, waits for each with a deadline and joins the process
group with them.  Each started rank then serves commands from rank 0 over
its socket, one at a time:

- ``place``: build this rank's object (``build(mesh, objects)``: a model's
  shard, a training state) and keep it under a handle;
- ``call``: run a method of a placed object, as rank 0 runs it on its own
  (SPMD: the modules' collectives meet), and reply;
- ``stop``: leave the process group and exit.

A model method decorated with :func:`mesh_call` (or :func:`mesh_stream` for
a generator) is sent to every rank when rank 0 calls it on a placed object;
inside that call, nested decorated methods run locally.  Messages go both
ways as ``torch.save`` bytes read back with ``torch.load(weights_only=True)``
under an allowlist of the port's message classes (the core ones of
:func:`_message_classes`, and those a module registers with
:func:`message_class`, which a rank imports before it reads a message that
names them): no rank unpickles anything else.  Tensors go through the host,
numpy arrays as tensors.

Failure: a rank whose command raises sends its traceback and exits at once,
so that peers blocked in a collective with it fail instead of waiting; rank
0 then raises :class:`RankError` with the first traceback, stops every rank
(terminate, then kill after a deadline) and marks the mesh failed.  When
rank 0 itself raises inside a call, it does the same.  No one waits
forever: the ranks' start and every reply have the mesh's timeout, and a
started rank exits when rank 0's process is gone (its socket closes).
"""

from __future__ import annotations

import functools
import importlib
import io
import os
import socket
import subprocess
import sys
import time
import traceback
from multiprocessing.connection import Connection, wait
from pathlib import Path
from typing import Optional

import numpy as np
import torch


class RankError(RuntimeError):
    """A rank of the mesh failed; the message carries its traceback."""


_REGISTERED: list = []


def message_class(cls):
    """Class decorator: let ``cls`` travel in the messages between ranks."""
    _REGISTERED.append(cls)
    return cls


def _message_classes() -> list:
    """The classes a message may hold besides tensors and Python's
    containers and scalars: the serving path's, and the registered ones."""
    from tiny_audio_tpu_torch.config import ASRConfig, DecoderConfig, EncoderConfig
    from tiny_audio_tpu_torch.generation import GenerationConfig
    from tiny_audio_tpu_torch.models.asr import Pretrained, SavedWeights, Seeded, _ShardBuilder
    from tiny_audio_tpu_torch.parallel.mesh import MeshSpec

    return [ASRConfig, DecoderConfig, EncoderConfig, GenerationConfig, MeshSpec, Pretrained,
            SavedWeights, Seeded, _ShardBuilder, _ProbeBuilder, _GeneratorState, _Array,
            *_REGISTERED]


def _encode(message) -> bytes:
    buf = io.BytesIO()
    torch.save(message, buf)
    return buf.getvalue()


def _decode(blob: bytes):
    # the port's modules a message names register their classes on import
    for name in torch.serialization.get_unsafe_globals_in_checkpoint(io.BytesIO(blob)):
        module = name.rpartition(".")[0]
        if module.startswith("tiny_audio_tpu_torch."):
            importlib.import_module(module)
    with torch.serialization.safe_globals(_message_classes()):
        return torch.load(io.BytesIO(blob), weights_only=True)


class _Array:
    """A numpy array on its way to another rank (as a tensor)."""

    def __init__(self, array):
        self.tensor = torch.from_numpy(np.ascontiguousarray(array))


class _GeneratorState:
    """A ``torch.Generator`` on its way to another rank: rebuilt there on
    that rank's device with the same state."""

    def __init__(self, gen: torch.Generator):
        self.state = gen.get_state()

    def rebuild(self, device: torch.device) -> torch.Generator:
        gen = torch.Generator(device=device)
        gen.set_state(self.state)
        return gen


def _to_host(value):
    """Arguments as the other ranks receive them: tensors on the host,
    numpy arrays as tensors, paths as strings, generators as their state."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, np.ndarray):
        return _Array(value)
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, os.PathLike):
        return os.fspath(value)
    if isinstance(value, torch.Generator):
        return _GeneratorState(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    return value


def _on_rank(value, device: torch.device):
    if isinstance(value, _GeneratorState):
        return value.rebuild(device)
    if isinstance(value, _Array):
        return value.tensor.numpy()
    if isinstance(value, (list, tuple)):
        return type(value)(_on_rank(v, device) for v in value)
    if isinstance(value, dict):
        return {k: _on_rank(v, device) for k, v in value.items()}
    return value


# ---------------------------------------------------------------------------
# Rank 0's side
# ---------------------------------------------------------------------------


def _join(proc: subprocess.Popen, timeout: float) -> None:
    try:
        proc.wait(max(timeout, 0.0))
    except subprocess.TimeoutExpired:
        pass


class World:
    """Ranks ``1 .. n-1`` seen from rank 0: their processes and sockets."""

    def __init__(self, spec):
        self.spec = spec
        self.timeout = spec.timeout
        self.procs: dict[int, subprocess.Popen] = {}
        self.conns: dict[int, Connection] = {}
        root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        try:
            for rank in range(1, spec.dp * spec.tp):
                ours, theirs = socket.socketpair()
                conn = Connection(ours.detach())
                try:
                    proc = subprocess.Popen(
                        [sys.executable, "-m", "tiny_audio_tpu_torch.parallel.launch",
                         str(theirs.fileno()), str(rank)],
                        pass_fds=(theirs.fileno(),), env=env, stdin=subprocess.DEVNULL)
                finally:
                    theirs.close()
                self.procs[rank], self.conns[rank] = proc, conn
                conn.send_bytes(_encode(spec))
        except BaseException:
            self.kill()
            raise

    def send(self, message) -> None:
        blob = _encode(message)
        for conn in self.conns.values():
            conn.send_bytes(blob)

    def replies(self, timeout: Optional[float] = None) -> list:
        """Every rank's reply to the last command, in rank order; raises
        :class:`RankError` on an error, a rank that exited, or the deadline."""
        deadline = time.monotonic() + (self.timeout if timeout is None else timeout)
        got: dict[int, object] = {}
        while len(got) < len(self.conns):
            waiting = {r: c for r, c in self.conns.items() if r not in got}
            left = deadline - time.monotonic()
            if left <= 0:
                raise RankError(f"ranks {sorted(waiting)} did not reply within "
                                f"{self.timeout:g} s")
            # a rank that exits closes its socket, which wakes the wait too;
            # the short period also catches one that dies holding it open
            ready = wait(list(waiting.values()), timeout=min(left, 0.5))
            for rank, conn in waiting.items():
                if conn in ready:
                    try:
                        kind, payload = _decode(conn.recv_bytes())
                    except (EOFError, OSError):
                        raise RankError(f"rank {rank} exited (code "
                                        f"{self.procs[rank].poll()})") from None
                    if kind == "error":
                        raise RankError(payload)
                    got[rank] = _on_rank(payload, torch.device("cpu"))
                elif self.procs[rank].poll() is not None:
                    raise RankError(f"rank {rank} exited (code {self.procs[rank].poll()}) "
                                    "without replying")
        return [got[r] for r in sorted(got)]

    def first_error(self, timeout: float = 1.0) -> Optional[str]:
        """The first error a rank sent, waiting up to ``timeout`` for one
        (None if every rank is alive and silent)."""
        deadline = time.monotonic() + timeout
        while True:
            for rank, conn in self.conns.items():
                try:
                    if conn.poll():
                        kind, payload = _decode(conn.recv_bytes())
                        if kind == "error":
                            return payload
                except (EOFError, OSError):
                    return f"rank {rank} exited (code {self.procs[rank].poll()})"
            if time.monotonic() > deadline:
                dead = [r for r, p in self.procs.items() if p.poll() is not None]
                return f"ranks {dead} exited" if dead else None
            time.sleep(0.05)

    def kill(self) -> None:
        """Stop every rank now: terminate, then kill what is left after 5 s."""
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + 5.0
        for proc in self.procs.values():
            _join(proc, deadline - time.monotonic())
            if proc.poll() is None:
                proc.kill()
                _join(proc, 5.0)
        for conn in self.conns.values():
            conn.close()
        self.conns = {}

    def stop(self) -> None:
        """Ask every rank to leave the group and exit; join each with the
        deadline, then kill the rest."""
        if self.conns:
            try:
                self.send(("stop",))
                self.replies(timeout=min(self.timeout, 60.0))
            except (RankError, OSError):
                pass
            deadline = time.monotonic() + 30.0
            for proc in self.procs.values():
                _join(proc, deadline - time.monotonic())
        self.kill()


def start(spec):
    """Start the ranks of ``spec``, wait for each to come up, and join the
    process group as rank 0; returns rank 0's mesh."""
    from tiny_audio_tpu_torch.parallel.mesh import Mesh

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    world = World(spec)
    try:
        world.replies()  # each rank says it is up before it joins the group
        mesh = Mesh(spec, 0)
    except BaseException:
        world.kill()
        import shutil

        shutil.rmtree(spec.tmpdir, ignore_errors=True)
        raise
    mesh.world = world
    try:
        world.replies()  # and once it has joined
    except BaseException:
        _fail(mesh, None)
        raise
    return mesh


def _fail(mesh, error) -> None:
    """Stop every rank and mark the mesh failed."""
    mesh.failed = error if error is not None else RuntimeError("a rank failed")
    if mesh.world is not None:
        mesh.world.kill()
    mesh.close()


def run_on_ranks(mesh, message, local):
    """Send ``message`` to the other ranks, run ``local()`` here, collect
    the replies; returns (local result, the other ranks' replies)."""
    mesh.check_usable()
    world = mesh.world
    try:
        if world is not None:
            world.send(message)
        mesh.enter()
        try:
            out = local()
        finally:
            mesh.leave()
    except BaseException as e:
        error = world.first_error() if world is not None else None
        _fail(mesh, RankError(error) if error else e)
        if error:
            raise RankError(error) from e
        raise
    try:
        others = world.replies() if world is not None else []
    except BaseException as e:
        _fail(mesh, e)
        raise
    return out, others


def dispatch(mesh, obj, name: str, args: tuple, kwargs: dict, gather: bool = False):
    """Run ``obj.<name>`` on every rank (see :meth:`.mesh.Mesh.dispatch`)."""
    with mesh._lock:
        if mesh._streaming:
            raise RuntimeError("a streamed call is still open on the mesh")
        message = ("call", obj._mesh_handle, name, _to_host(args), _to_host(kwargs), gather)
        out, others = run_on_ranks(mesh, message, lambda: getattr(obj, name)(*args, **kwargs))
        return [out, *others] if gather else out


def dispatch_stream(mesh, obj, name: str, args: tuple, kwargs: dict):
    """A generator method on every rank: the other ranks run it to its end,
    rank 0 yields its items; when the consumer stops early rank 0 still
    runs it to the end, so that every rank meets every collective."""
    mesh._lock.acquire()
    try:
        if mesh._streaming:
            raise RuntimeError("a streamed call is still open on the mesh")
        mesh.check_usable()
        mesh._streaming = True
        world = mesh.world
        message = ("call", obj._mesh_handle, name, _to_host(args), _to_host(kwargs), False)
        try:
            if world is not None:
                world.send(message)
            mesh.enter()
            try:
                gen = getattr(obj, name)(*args, **kwargs)
            finally:
                mesh.leave()
            consumer_open = True
            while True:
                mesh.enter()
                try:
                    item = next(gen)
                except StopIteration:
                    break
                finally:
                    mesh.leave()
                if consumer_open:
                    try:
                        yield item
                    except GeneratorExit:
                        consumer_open = False
        except BaseException as e:
            if isinstance(e, GeneratorExit):
                raise
            error = world.first_error() if world is not None else None
            _fail(mesh, RankError(error) if error else e)
            if error:
                raise RankError(error) from e
            raise
        if world is not None:
            try:
                world.replies()
            except BaseException as e:
                _fail(mesh, e)
                raise
    finally:
        mesh._streaming = False
        mesh._lock.release()


def mesh_call(fn):
    """Decorate a method of an object with a ``mesh`` attribute: on a
    placed object, rank 0's call runs on every rank (:func:`dispatch`);
    without a mesh, or inside a call every rank runs, it runs here."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        mesh = getattr(self, "mesh", None)
        if mesh is None or mesh.inside() or not hasattr(self, "_mesh_handle"):
            return fn(self, *args, **kwargs)
        return dispatch(mesh, self, fn.__name__, args, kwargs)

    return wrapper


def mesh_stream(fn):
    """:func:`mesh_call` for a generator method (:func:`dispatch_stream`)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        mesh = getattr(self, "mesh", None)
        if mesh is None or mesh.inside() or not hasattr(self, "_mesh_handle"):
            return fn(self, *args, **kwargs)
        return dispatch_stream(mesh, self, fn.__name__, args, kwargs)

    return wrapper


class Probe:
    """Diagnostics of a mesh, placed on every rank (:meth:`place`):
    :meth:`loaded_modules` (what each rank imported) and :meth:`launches`
    (each rank's kernel launch counts)."""

    def __init__(self, mesh):
        self.mesh = mesh

    @classmethod
    def place(cls, mesh) -> "Probe":
        probe = cls(mesh)
        mesh.place(probe, _ProbeBuilder())
        return probe

    @mesh_call
    def loaded_modules(self) -> list[str]:
        return sorted(sys.modules)

    @mesh_call
    def launches(self, wrappers: list[str], reset: bool = False) -> dict:
        """This rank's ``launches`` count of each kernel wrapper, named
        ``"module:function"`` in the port (set to 0 with ``reset``)."""
        import importlib

        counts = {}
        for path in wrappers:
            module, name = path.split(":")
            if not module.startswith("tiny_audio_tpu_torch."):
                raise ValueError(f"{path}: not a wrapper of the port")
            fn = getattr(importlib.import_module(module), name)
            counts[name] = fn.launches
            if reset:
                fn.launches = 0
        return counts


class _ProbeBuilder:
    def __call__(self, mesh, objects) -> Probe:
        return Probe(mesh)


# ---------------------------------------------------------------------------
# A started rank's side
# ---------------------------------------------------------------------------


def _recv(conn):
    """The next command; None when rank 0's process is gone (its end of
    the socket closed)."""
    try:
        return _decode(conn.recv_bytes())
    except (EOFError, OSError):
        return None


def _rank_main(spec, rank: int, conn) -> None:
    """A started rank: join the grid, then serve rank 0's commands."""
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        torch.set_num_threads(spec.threads)
        from tiny_audio_tpu_torch.parallel.mesh import Mesh

        conn.send_bytes(_encode(("done", None)))
        mesh = Mesh(spec, rank)
        conn.send_bytes(_encode(("done", None)))
        objects: dict = {}
        while True:
            message = _recv(conn)
            if message is None or message[0] == "stop":
                break
            result = None
            mesh.enter()
            try:
                if message[0] == "place":
                    _, handle, build = message
                    obj = build(mesh, objects)
                    obj._mesh_handle = handle
                    objects[handle] = obj
                elif message[0] == "call":
                    _, handle, name, args, kwargs, gather = message
                    args, kwargs = _on_rank(args, mesh.device), _on_rank(kwargs, mesh.device)
                    out = getattr(objects[handle], name)(*args, **kwargs)
                    if hasattr(out, "__next__"):
                        out = list(out)
                    result = _to_host(out) if gather else None
                else:
                    raise ValueError(f"unknown command {message[0]!r}")
            finally:
                mesh.leave()
            conn.send_bytes(_encode(("done", result)))
        if message is not None:
            conn.send_bytes(_encode(("done", None)))
        mesh.closed = True
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:
        try:
            conn.send_bytes(_encode(("error", f"rank {rank} failed:\n{traceback.format_exc()}")))
            conn.close()
        finally:
            os._exit(1)


def _main(argv: list[str]) -> None:
    """``python -m tiny_audio_tpu_torch.parallel.launch <fd> <rank>``: a rank
    started by :class:`World`, its socket on descriptor ``fd``."""
    conn = Connection(int(argv[0]))
    _rank_main(_decode(conn.recv_bytes()), int(argv[1]), conn)


if __name__ == "__main__":
    # run the imported module's code, not this __main__ copy: the messages
    # from rank 0 name tiny_audio_tpu_torch.parallel.launch's classes
    from tiny_audio_tpu_torch.parallel import launch

    launch._main(sys.argv[1:])

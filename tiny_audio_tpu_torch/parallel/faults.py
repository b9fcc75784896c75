"""A failure on one rank of a mesh, to check the failure path.

No entry point imports this module: the tests place a :class:`FaultProbe`
on a mesh, and a started rank imports it when a message names its builder.
"""

from __future__ import annotations

import torch

from tiny_audio_tpu_torch.parallel.launch import mesh_call, message_class


class FaultProbe:
    """Placed on every rank (:meth:`place`); :meth:`fail_on` raises on one
    rank while the others wait in an all-reduce with it."""

    def __init__(self, mesh):
        self.mesh = mesh

    @classmethod
    def place(cls, mesh) -> "FaultProbe":
        probe = cls(mesh)
        mesh.place(probe, _FaultProbeBuilder())
        return probe

    @mesh_call
    def fail_on(self, rank: int) -> None:
        if self.mesh.rank == rank:
            raise RuntimeError(f"failure injected on rank {rank}")
        self.mesh.world_axis.all_reduce(torch.ones(1, device=self.mesh.device))


@message_class
class _FaultProbeBuilder:
    def __call__(self, mesh, objects) -> FaultProbe:
        return FaultProbe(mesh)

"""Device session: the port's view of the data-parallel world.

Port of `kungfu_tpu/parallel/mesh.py`. The JAX package builds a
`jax.sharding.Mesh`; here the world is the `torch.distributed` process
group, one process per card, over a single "dp" axis.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from kungfu_tpu_torch import resolve_device
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.ops import collective


class DeviceSession:
    """An epoch over the data-parallel world: rank/size metadata, a
    barrier, and host-callable collectives."""

    axis_names = ("dp",)

    def __init__(self, device: torch.device, group=None):
        self.device = device
        self.group = group

    @property
    def size(self) -> int:
        return collective.world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.size > 1 else 0

    def barrier(self) -> None:
        """Wait for every rank, and for this rank's queued device work."""
        if self.size > 1:
            dist.barrier(group=self.group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def all_reduce(self, tensors: Sequence[torch.Tensor],
                   op: ReduceOp = ReduceOp.SUM) -> List[torch.Tensor]:
        return collective.group_all_reduce(tensors, op, self.group)

    def describe(self) -> str:
        backend = dist.get_backend(self.group) if self.size > 1 else "none"
        return (f"DeviceSession({self.size} devices, "
                f"mesh={{'dp': {self.size}}}, rank {self.rank}, "
                f"device {self.device}, backend {backend})")


def make_mesh(device=None, group=None) -> DeviceSession:
    """The 1-D "dp" session over the current world (None = the CUDA card)."""
    return DeviceSession(resolve_device(device), group)

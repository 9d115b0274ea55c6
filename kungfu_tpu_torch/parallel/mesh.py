"""Device session: the port's view of the device world as a mesh of named
axes.

Port of `kungfu_tpu/parallel/mesh.py`. The JAX package builds a
`jax.sharding.Mesh` over devices; here the world is the `torch.distributed`
process group, one process per rank, and a mesh lays its ranks out
row-major over named axes, as `devices.reshape(sizes)` lays devices out
there: in `{"dp": 2, "sp": 2}` ranks 0 and 1 form dp row 0's sp ring. Each
axis gets a process group per line of the mesh along it, so a collective
over "sp" runs inside this rank's sp ring. The default is one "dp" axis
over the whole world.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kungfu_tpu_torch import resolve_device
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.ops import collective


def _mesh_sizes(shape: Mapping[str, int], n: int) -> Dict[str, int]:
    """Axis name -> size for `n` ranks; one size may be -1 (inferred)."""
    names, sizes = list(shape), list(shape.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"cannot infer axis: {n} devices over {dict(shape)}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} "
                         f"devices, have {n}")
    return dict(zip(names, sizes))


def _axis_lines(sizes: Mapping[str, int], axes: Sequence[str]) -> List[List[int]]:
    """The mesh's sub-meshes over `axes`: for each setting of the other
    axes, the ranks that differ only in `axes`, row-major over `axes`."""
    grid = np.arange(math.prod(sizes.values())).reshape(tuple(sizes.values()))
    dims = [list(sizes).index(a) for a in axes]
    moved = np.moveaxis(grid, dims, range(grid.ndim - len(dims), grid.ndim))
    return moved.reshape(-1, math.prod(sizes[a] for a in axes)).tolist()


class DeviceSession:
    """An epoch over the device world: rank/size metadata, the mesh's axes
    and their process groups, a barrier, and host-callable collectives.
    `group` is the whole world the session spans; a mesh of several axes
    spans the default world."""

    def __init__(self, device: torch.device, group=None,
                 shape: Optional[Mapping[str, int]] = None):
        self.device = device
        self.group = group
        self.shape = _mesh_sizes(shape or {"dp": -1}, self.size)
        self._coords = np.unravel_index(self.rank, tuple(self.shape.values()))
        if len(self.shape) == 1 or self.size == 1:
            self._groups = {name: group for name in self.shape}
            return
        self._groups = {}
        for name in self.shape:
            self._groups[name] = self._new_group((name,))

    def _new_group(self, axes: Sequence[str]):
        # new_group is collective over the default world: every rank
        # creates every sub-mesh's group, in the same order, and keeps its own
        if self.group is not None:
            raise ValueError("only a session over the default world makes groups")
        mine = None
        for line in _axis_lines(self.shape, axes):
            g = dist.new_group(line)
            if self.rank in line:
                mine = g
        return mine

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def axis_size(self, name: str) -> int:
        return self.shape[name]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along axis `name`."""
        return int(self._coords[self.axis_names.index(name)])

    def axis_group(self, name: str):
        """The process group of this rank's line along axis `name` (None
        for the default world)."""
        return self._groups[name]

    def axes_group(self, names: Sequence[str]):
        """The process group of the ranks that share this rank's
        coordinates on every axis not in `names` (axes of one rank left
        out: `axis_group` for one name, the session's group for every
        axis, a group of this rank alone for none). A new set of axes makes
        its group here, a collective call: every rank asks for it, in the
        same order."""
        names = tuple(a for a in self.axis_names if a in names and self.shape[a] > 1)
        if len(names) == 1:
            return self.axis_group(names[0])
        if math.prod(self.shape[a] for a in names) == self.size:
            return self.group
        if names not in self._groups:
            self._groups[names] = self._new_group(names)
        return self._groups[names]

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
        return (f"DeviceSession({self.size} devices, mesh={self.shape}, rank {self.rank}, "
                f"device {self.device}, backend {backend})")


def make_mesh(device=None, group=None, shape: Optional[Mapping[str, int]] = None
              ) -> DeviceSession:
    """A session over the current world (None = the CUDA card). `shape`
    maps axis name -> size, one size may be -1; default: all ranks on one
    "dp" axis. A mesh of several axes spans the whole world (`group`
    None): every rank must call this, since it creates process groups."""
    device = resolve_device(device)
    if shape is not None and len(shape) > 1 and group is not None:
        raise ValueError("a mesh of several axes spans the whole world: pass group=None")
    return DeviceSession(device, group, shape)

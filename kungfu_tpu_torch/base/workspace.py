"""Workspace: a named (send, recv, op) triple for one host collective.

Port of `kungfu_tpu/base/workspace.py` (parity:
srcs/go/kungfu/base/workspace.go:10-50, Workspace with ``Split`` by
partition function). One-dimensional torch tensors give zero-copy typed
slicing, so there is no separate Vector class.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import torch

from kungfu_tpu_torch.base.ops import ReduceOp

# (begin, end) element intervals; mirrors plan.EvenPartition over Interval
# (srcs/go/plan/interval.go).
PartitionFunc = Callable[[int, int], Sequence[Tuple[int, int]]]


def even_partition(count: int, k: int) -> List[Tuple[int, int]]:
    """Split [0, count) into k contiguous intervals of near-equal size."""
    q, r = divmod(count, k)
    out = []
    begin = 0
    for i in range(k):
        end = begin + q + (1 if i < r else 0)
        out.append((begin, end))
        begin = end
    return out


@dataclasses.dataclass
class Workspace:
    send: torch.Tensor  # 1-D
    recv: torch.Tensor  # 1-D, same dtype/length as send
    op: ReduceOp
    name: str
    # an event (a `torch.cuda.Event`) the engine synchronizes before it
    # reads `send`: a card's tensor staged into pinned memory by a copy
    # that may still be running (the async scheduler's hook path)
    ready: Any = None

    @property
    def is_empty(self) -> bool:
        return self.send.numel() == 0

    @property
    def is_inplace(self) -> bool:
        return self.send is self.recv or (
            self.send.data_ptr() == self.recv.data_ptr()
            and self.send.numel() == self.recv.numel()
        )

    def forward(self) -> None:
        """Copy send into recv (used when this rank only forwards data)."""
        if not self.is_inplace:
            self.recv.copy_(self.send)

    def split(self, partition: PartitionFunc, k: int) -> List["Workspace"]:
        """Split into k sub-workspaces named ``<name>[i/k]``."""
        out = []
        for i, (begin, end) in enumerate(partition(self.send.numel(), k)):
            out.append(
                Workspace(
                    send=self.send[begin:end],
                    recv=self.recv[begin:end],
                    op=self.op,
                    name=f"{self.name}[{i}/{k}]",
                )
            )
        return out

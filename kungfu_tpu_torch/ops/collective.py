"""Device collectives over `torch.distributed` (NCCL on the card, gloo on
the CPU). Port of `kungfu_tpu/ops/collective.py`.

Every function reduces over the default process group unless given a
`group`, and returns new tensors (like the JAX functions). Without an
initialized process group the world is one process and each collective is
the identity. Torch has no XLA all-reduce combiner, so the group variants
flatten their inputs into one buffer per dtype and issue one collective
per buffer.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from kungfu_tpu_torch.base.ops import ReduceOp

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
}


def world_size(group=None) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def _dist_op(op: ReduceOp):
    try:
        return _DIST_OPS[op]
    except KeyError:
        raise ValueError(f"unsupported device reduce op: {op!r}") from None


def all_reduce(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM, group=None) -> torch.Tensor:
    """Reduce one tensor over the group (SUM/MIN/MAX, like the JAX package;
    PROD is refused)."""
    dop = _dist_op(op)
    y = x.clone()
    if world_size(group) > 1:
        dist.all_reduce(y, op=dop, group=group)
    return y


def all_average(x: torch.Tensor, group=None) -> torch.Tensor:
    return all_reduce(x, ReduceOp.SUM, group) / world_size(group)


def fuse(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate flattened tensors into one buffer."""
    return torch.cat([x.reshape(-1) for x in xs])


def defuse(fused: torch.Tensor, shapes: Sequence[Tuple[int, ...]]) -> List[torch.Tensor]:
    """Split a fused buffer back into tensors of the given shapes (views)."""
    out, off = [], 0
    for shape in shapes:
        size = 1
        for d in shape:
            size *= d
        out.append(fused[off:off + size].view(shape))
        off += size
    return out


def _buckets(xs: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    return by_dtype


def group_all_reduce(xs: Sequence[torch.Tensor], op: ReduceOp = ReduceOp.SUM,
                     group=None) -> List[torch.Tensor]:
    """Reduce a list of tensors: one flattened collective per dtype."""
    dop = _dist_op(op)
    if world_size(group) == 1:
        return [x.clone() for x in xs]
    out: List[torch.Tensor] = [None] * len(xs)
    for idx in _buckets(xs).values():
        flat = fuse([xs[i] for i in idx])
        dist.all_reduce(flat, op=dop, group=group)
        for i, part in zip(idx, defuse(flat, [xs[i].shape for i in idx])):
            out[i] = part
    return out


def group_all_average(xs: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    n = world_size(group)
    return [y / n for y in group_all_reduce(xs, ReduceOp.SUM, group)]


def all_gather(x: torch.Tensor, axis: int = 0, tiled: bool = False,
               group=None) -> torch.Tensor:
    """Every rank's `x`, stacked on a new `axis` (or concatenated along it
    when `tiled`), in rank order."""
    n = world_size(group)
    if n == 1:
        parts = [x.clone()]
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def broadcast(x: torch.Tensor, root: int = 0, group=None) -> torch.Tensor:
    """`root`'s value on every rank (a real broadcast, not a masked sum)."""
    y = x.clone()
    if world_size(group) > 1:
        dist.broadcast(y, src=root, group=group)
    return y

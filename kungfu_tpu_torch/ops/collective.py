"""Device collectives over `torch.distributed` (NCCL on the card, gloo on
the CPU). Port of `kungfu_tpu/ops/collective.py`.

Every function reduces over the default process group unless given a
`group`, and returns new tensors (like the JAX functions). Without an
initialized process group the world is one process and each collective is
the identity. Torch has no XLA all-reduce combiner, so the group variants
flatten their inputs into one buffer per dtype and issue one collective
per buffer.

`ring_shift` is the port of `lax.ppermute` around a ring: point-to-point
sends and receives. gloo's send and receive take host memory only, so on a
gloo group a CUDA tensor travels through pinned host buffers; this is the
only place the port stages through the host, and it is chosen by the
group's backend.
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


# pinned host buffers of the gloo ring, reused from shift to shift: one
# per (role, dtype), grown to the largest tensor seen and viewed into, so
# varying shapes cost no more pinned memory than the largest. A shift waits
# for its transfers before it returns, so the next shift may overwrite them.
_PINNED: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}


def _pinned(role: str, like: torch.Tensor) -> torch.Tensor:
    key = (role, like.dtype)
    buf = _PINNED.get(key)
    if buf is None or buf.numel() < like.numel():
        buf = _PINNED[key] = torch.empty(like.numel(), dtype=like.dtype, pin_memory=True)
    return buf[:like.numel()].view(like.shape)


def rotate(xs: Sequence[torch.Tensor], group=None, shift: int = 1) -> List[torch.Tensor]:
    """Send each of `xs` to rank (i + shift) % n of the group and return
    what rank (i - shift) % n sent, in one batch of point-to-point
    operations (every send and receive is posted before any is waited on,
    so no order of ranks can deadlock). Not differentiable: see
    `ring_shift`."""
    n = world_size(group)
    if n == 1 or shift % n == 0:
        return [x.clone() for x in xs]
    if group is None:
        group = dist.group.WORLD
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    staged = dist.get_backend(group) == "gloo"
    recvs, ops = [], []
    for i, x in enumerate(xs):
        x = x.contiguous()
        if staged and x.is_cuda:
            send, recv = _pinned(f"send{i}", x), _pinned(f"recv{i}", x)
            send.copy_(x)
        else:
            send, recv = x, torch.empty_like(x)
        recvs.append(recv)
        ops += [dist.P2POp(dist.isend, send, dst, group),
                dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(x.device) if r.device != x.device else r for r, x in zip(recvs, xs)]


class RingShift(torch.autograd.Function):
    """`rotate` with a gradient: the backward shifts the cotangent the
    other way, as JAX transposes `lax.ppermute`."""

    @staticmethod
    def forward(ctx, x, group, k: int):
        ctx.group, ctx.k = group, k
        return rotate([x], group, k)[0]

    @staticmethod
    def backward(ctx, g):
        return rotate([g], ctx.group, -ctx.k)[0], None, None


def ring_shift(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Differentiable ring rotation: rank i's `x` lands on rank
    (i + shift) % n of the group; the result is what rank (i - shift) % n
    held."""
    return RingShift.apply(x, group, shift)

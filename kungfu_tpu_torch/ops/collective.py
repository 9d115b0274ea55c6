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
group's backend. gloo's all-reduce, broadcast, reduce-scatter, tiled
all-gather and all-to-all take CUDA tensors themselves (the last three
checked on an H100 with torch 2.11).

The differentiable collectives follow the port's rule that each rank
backpropagates its own loss: `ring_shift`, `all_to_all` and `pmean` take
JAX's transposes under `shard_map`; `copy_to_group` and
`reduce_from_group` are Megatron's pair for a group whose ranks compute
one replicated loss.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple

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


def world_rank(group=None) -> int:
    """This process's rank in `group` (0 in a world of one)."""
    return dist.get_rank(group) if world_size(group) > 1 else 0


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


def subset_all_reduce(x: torch.Tensor, mask, group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of the group whose entry in `mask`
    (indexed by rank in the group) is nonzero, on every rank: a rank
    outside the subset contributes zero and still receives the sum
    (`kungfu_tpu/ops/collective.py::subset_all_reduce`)."""
    m = torch.as_tensor(mask)[world_rank(group)].to(x.dtype)
    return all_reduce(x * m, ReduceOp.SUM, group)


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


def _leaves(tree: Mapping, prefix=()) -> List[Tuple[tuple, torch.Tensor]]:
    """(path, leaf) of a nested dict of tensors, keys sorted at every level:
    the order `jax.tree.flatten` gives a dict pytree."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        out += _leaves(v, prefix + (key,)) if isinstance(v, Mapping) else [(prefix + (key,), v)]
    return out


def fuse_pytree(tree: Mapping) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Dict]]:
    """Pack a nested dict of tensors into (flat vector, unflatten): the
    leaves in sorted-key order, concatenated in their promoted dtype;
    `unflatten(vec)` rebuilds the nested dict, each leaf in its own shape
    and dtype (`kungfu_tpu/ops/collective.py::fuse_pytree`)."""
    paths, leaves = zip(*_leaves(tree)) if tree else ((), ())
    shapes = [x.shape for x in leaves]
    dtypes = [x.dtype for x in leaves]

    def unflatten(vec: torch.Tensor) -> Dict:
        out: Dict = {}
        for path, part, dt in zip(paths, defuse(vec, shapes), dtypes):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = part.to(dt)
        return out

    return fuse(leaves), unflatten


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


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class AllToAll(torch.autograd.Function):
    """`lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=False)`: slice
    i of this rank's (n, ...) `x` goes to rank i of the group, and slice j
    of the result is what rank j sent this rank. The exchange is its own
    transpose, so the backward is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.group), None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable all-to-all over dimension 0 of `x`, whose length is
    the group's size. gloo exchanges CUDA tensors itself, so no route
    stages through the host."""
    n = world_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all splits dimension 0 of {tuple(x.shape)} over {n} ranks")
    if n == 1:
        return x.clone()
    return AllToAll.apply(x, group)


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_average(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_average(g, ctx.group), None


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable all-average (`lax.pmean`): each rank backpropagates
    its own loss, and the objective is the sum of them, so the backward is
    the all-average of the cotangents, as JAX transposes `pmean`."""
    return x.clone() if world_size(group) == 1 else _Mean.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ReduceOp.SUM, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's entry to a tensor-parallel region: the identity forward,
    the sum over the group of the cotangents backward (every rank's shard
    of the next product contributes to the gradient of a replicated x)."""
    return x if world_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's exit from a tensor-parallel region: the sum of the
    ranks' partial results forward, the identity backward (every rank of
    the group computes the same replicated loss from here on, counted
    once)."""
    return x if world_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def broadcast(x: torch.Tensor, root: int = 0, group=None) -> torch.Tensor:
    """`root`'s value on every rank (a real broadcast, not a masked sum)."""
    return group_broadcast([x], root, group)[0]


def group_broadcast(xs: Sequence[torch.Tensor], root: int = 0,
                    group=None) -> List[torch.Tensor]:
    """`root`'s (a rank of the group) value of each of `xs` on every rank:
    one flattened broadcast per dtype."""
    if world_size(group) == 1:
        return [x.clone() for x in xs]
    src = root if group is None else dist.get_global_rank(group, root)
    out: List[torch.Tensor] = [None] * len(xs)
    for idx in _buckets(xs).values():
        flat = fuse([xs[i] for i in idx])
        dist.broadcast(flat, src=src, group=group)
        for i, part in zip(idx, defuse(flat, [xs[i].shape for i in idx])):
            out[i] = part
    return out


def reduce_scatter(x: torch.Tensor, group=None, tiled: bool = True) -> torch.Tensor:
    """The sum over the group of a flat `x` whose length is a multiple of
    the group's size n, cut into n contiguous shards; rank i keeps shard i
    (`lax.psum_scatter(x, scatter_dimension=0, tiled=True)`)."""
    if not tiled or x.dim() != 1:
        raise ValueError("reduce_scatter takes a flat tensor and tiled=True only")
    n = world_size(group)
    if x.numel() % n:
        raise ValueError(f"length {x.numel()} does not split into {n} shards")
    if n == 1:
        return x.clone()
    out = x.new_empty(x.numel() // n)
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's flat `x`, concatenated in rank order, written into the
    preallocated flat `out` of n times x's length (`lax.all_gather(...,
    tiled=True)`); returns `out`."""
    n = world_size(group)
    if out.numel() != n * x.numel() or out.dtype != x.dtype:
        raise ValueError(f"out holds {out.numel()} {out.dtype}, want {n} x {x.numel()} "
                         f"{x.dtype}")
    x = x.reshape(-1)
    if n == 1:
        out.copy_(x)
    else:
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


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
        # kfcheck: disable=KF301 — a torch.distributed request is bounded
        # by its process group's own timeout: wait() raises at it
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

"""Hierarchical allreduce: a device all-reduce within a world x a
host-plane allreduce across worlds, the multi-slice data path.

Port of `kungfu_tpu/ops/hierarchical.py` (parity: the reference's bridged
hierarchical collective, srcs/cpp/src/tensorflow/ops/gpu/collective.cpp:
108-162: local NCCL reduce, CPU cross-host allreduce, local NCCL bcast;
cross strategies srcs/go/kungfu/session/strategy.go:188-210).

A world differs from JAX's. There, one kfrun worker owns one jax world
of many devices. Here one process drives one card, so a **world is a
block of `world_size` consecutive kfrun ranks** with a `torch.distributed`
subgroup of its own (NCCL on cards, gloo where ranks share a card); the
world's leader is its first rank. One hierarchical step:

  1. the in-world mean over the world's group (JAX's ``lax.pmean``),
  2. the leaders' host-plane allreduce across worlds (`CrossSliceReducer`),
  3. a broadcast of the result from the leader within each world.

`world_size=1` is the reference's layout: every rank is a world of one,
steps 1 and 3 do nothing (no group is read, so a device plane that is up
is left alone), and `CrossSliceReducer` runs `group_all_reduce` over the
whole session, as the reference does, so a world of port and reference
peers holds the same bits. With `world_size > 1` it runs the same
workspaces (fused per dtype) as a forest in which the leaders form a
star and each other rank is a tree of its own
(`HostSession.subset_all_reduce`).

Semantics: hierarchical mean, the mean over worlds of the in-world mean.
With equal-sized worlds this equals the global mean over all ranks
(exactly, when the addends are exactly representable; to rounding
otherwise, like any reassociated float sum).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from kungfu_tpu_torch import resolve_device
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.ops import collective


class CrossSliceReducer:
    """Host-side cross-world gradient averaging of CPU tensors.

    Keeps a per-instance step counter so every collective round gets fresh
    wire names (all worlds advance in lockstep: the host collective
    itself is the synchronizer). Leaves are reduced concurrently via the
    session group op, and a single division by the world count lands
    after the wire SUM (the reference's reduce-then-scale order)."""

    def __init__(self, peer=None, name: str = "hier", compress: str = "",
                 world_size: int = 1):
        """compress="bf16": f32/f64 leaves cross the wire as bfloat16
        (half/quarter the bytes; the in-world mean stays full precision,
        so only the CROSS-world term is rounded). Integer and already
        half-precision leaves pass through. `world_size`: ranks a world
        (the session's size must be a multiple of it)."""
        self._peer = peer
        self.name = name
        self.step = 0
        if compress not in ("", "bf16"):
            raise ValueError(f"unknown compression {compress!r}")
        self.compress = compress
        if world_size < 1:
            raise ValueError(f"world_size {world_size} < 1")
        self.world_size = world_size

    def _session(self):
        if self._peer is None:
            from kungfu_tpu_torch.peer import get_default_peer

            self._peer = get_default_peer()
        return self._peer.current_session()

    def leads(self) -> bool:
        """Whether this rank leads its world (walks across worlds)."""
        return self._session().rank % self.world_size == 0

    def _fathers(self, k: int) -> List[int]:
        """The forest: the leaders' star at rank 0, every other rank alone."""
        return [0 if r % self.world_size == 0 else r for r in range(k)]

    def __call__(self, *leaves: torch.Tensor) -> List[torch.Tensor]:
        sess = self._session()
        step = self.step
        self.step += 1
        k = sess.size
        if k % self.world_size:
            raise ValueError(f"{k} ranks do not form worlds of {self.world_size}")
        n = k // self.world_size
        if n <= 1 or not leaves or sess.rank % self.world_size:
            # one world, or not its leader: the in-world broadcast brings
            # the result
            return list(leaves)
        arrs = [l.contiguous() for l in leaves]
        orig_dtypes = [a.dtype for a in arrs]
        if self.compress == "bf16":
            arrs = [a.to(torch.bfloat16) if a.is_floating_point() and a.element_size() > 2
                    else a for a in arrs]
        if self.world_size == 1:
            outs = [torch.empty_like(a) for a in arrs]
            ws = [
                Workspace(
                    send=a.reshape(-1),
                    recv=o.reshape(-1),
                    op=ReduceOp.SUM,
                    name=f"kungfu::hier:{self.name}:{step}:{i}",
                )
                for i, (a, o) in enumerate(zip(arrs, outs))
            ]
            sess.group_all_reduce(ws)
        else:
            outs = self._forest(sess, arrs, step)
        return [self._mean(o, n, dt) for o, dt in zip(outs, orig_dtypes)]

    def _forest(self, sess, arrs, step) -> List[torch.Tensor]:
        """The leaders' walk: one workspace a dtype, over the forest."""
        by_dtype = {}
        for i, a in enumerate(arrs):
            by_dtype.setdefault(a.dtype, []).append(i)
        fathers = self._fathers(sess.size)
        outs: List[torch.Tensor] = [None] * len(arrs)
        for j, idx in enumerate(by_dtype.values()):
            send = torch.cat([arrs[i].reshape(-1) for i in idx])
            recv = torch.empty_like(send)
            sess.subset_all_reduce(fathers, Workspace(
                send=send, recv=recv, op=ReduceOp.SUM,
                name=f"kungfu::hier:{self.name}:{step}:{j}"))
            for i, part in zip(idx, collective.defuse(recv, [arrs[i].shape for i in idx])):
                outs[i] = part
        return outs

    @staticmethod
    def _mean(o: torch.Tensor, n: int, out_dtype=None) -> torch.Tensor:
        """sum/n, cast ONCE to out_dtype (default: o's dtype): the
        compressed path divides the bf16 wire sum at f32 precision and
        lands directly in the original f32/f64 without an intermediate
        bf16 rounding. NOTE the branch check is "not a floating point
        dtype", never a test for integers by kind: in numpy, ml_dtypes'
        bfloat16 has kind 'V', so the reference must test for integers,
        else bf16 would take the floor division and zero out sub-1.0
        gradient sums."""
        if out_dtype is None:
            out_dtype = o.dtype
        if not o.is_floating_point():
            return torch.div(o, n, rounding_mode="floor").to(out_dtype)
        if o.element_size() < 4:
            # bf16/f16/f8 wire sums: divide at f32 precision
            return (o.float() / torch.tensor(n, dtype=torch.float32)).to(out_dtype)
        return (o / torch.tensor(n, dtype=o.dtype)).to(out_dtype)


def world_group(world_size: int, backend: Optional[str] = None):
    """This rank's world: the process group of its block of `world_size`
    consecutive ranks of the default world (None for worlds of one).
    `dist.new_group` is collective: every rank creates every world's
    group, in the same order."""
    if world_size == 1:
        return None
    n, rank = dist.get_world_size(), dist.get_rank()
    if n % world_size:
        raise ValueError(f"{n} ranks do not form worlds of {world_size}")
    groups = [dist.new_group(list(range(i, i + world_size)), backend=backend)
              for i in range(0, n, world_size)]
    return groups[rank // world_size]


def _sync(xs: Sequence[torch.Tensor]) -> None:
    if any(x.device.type == "cuda" for x in xs):
        torch.cuda.synchronize()


def cross_slice_mean(tree: Sequence[torch.Tensor], reducer: CrossSliceReducer, group=None,
                     times: Optional[dict] = None) -> List[torch.Tensor]:
    """Average a list of tensors (each world's in-world mean) across
    worlds: the leaders stage them to the host (a card's through the
    api's pinned buffers), run `reducer`, and broadcast the result within
    their world (`group`, from `world_group`; unused for worlds of one).
    Returns new tensors on the inputs' devices. `times` receives the
    walk's and the broadcast's ms."""
    from kungfu_tpu_torch import api

    if reducer.world_size > 1 and group is None:
        # None would name torch's default group: every rank, not the world
        raise ValueError(f"worlds of {reducer.world_size} ranks need their group "
                         "(world_group)")
    t0 = time.perf_counter()
    if not reducer.leads():
        reducer()  # no walk; keeps the round counter in step
        outs = [x.detach().clone() for x in tree]  # the broadcast's buffers
    else:
        staged = api._stage([x.detach() for x in tree])
        try:
            got = reducer(*[s[0] for s in staged])
            # copied off the staging buffers before they go back
            outs = [g.reshape(x.shape).to(x.device, copy=True) for x, g in zip(tree, got)]
        finally:
            api._release(staged)
    t1 = time.perf_counter()
    if reducer.world_size > 1:
        leader = dist.get_global_rank(group, 0)
        for idx in collective._buckets(outs).values():
            flat = collective.fuse([outs[i] for i in idx])
            dist.broadcast(flat, src=leader, group=group)
            for i, part in zip(idx, collective.defuse(flat, [outs[i].shape for i in idx])):
                outs[i] = part
        _sync(outs)
    if times is not None:
        times.update(walk_ms=(t1 - t0) * 1e3, bcast_ms=(time.perf_counter() - t1) * 1e3)
    return outs


class HierarchicalSGD:
    """S-SGD whose gradient averaging is hierarchical (in-world mean +
    cross-world host allreduce + in-world broadcast) around a torch
    optimizer, as `optimizers/core.py`'s wrappers: `step`, `zero_grad`,
    `param_groups`. `last` holds the latest average's split in ms:
    the in-world mean, the leaders' walk, the broadcast."""

    def __init__(self, base: torch.optim.Optimizer, world_size: int = 1, group=None,
                 peer=None, name: str = "hier-ssgd", compress: str = "", device=None):
        self.device = resolve_device(device)
        self.base = base
        self.reducer = CrossSliceReducer(peer=peer, name=name, compress=compress,
                                         world_size=world_size)
        # a world of one has no group: None would name torch's default
        # group, which holds every rank of a device plane that is up
        if world_size == 1:
            self.group = None
        else:
            self.group = world_group(world_size) if group is None else group
            if collective.world_size(self.group) != world_size:
                raise ValueError(f"a group of {collective.world_size(self.group)} ranks "
                                 f"for worlds of {world_size}")
        self.last: dict = {}

    @property
    def param_groups(self):
        return self.base.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def average_gradients(self) -> None:
        params = [p for g in self.base.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        t0 = time.perf_counter()
        if self.group is None:
            means = grads  # a world of one: its mean is its own gradient
        else:
            means = collective.group_all_average(grads, self.group)
            _sync(means)
        self.last = {"mean_ms": (time.perf_counter() - t0) * 1e3}
        for g, avg in zip(grads, cross_slice_mean(means, self.reducer, self.group, self.last)):
            g.copy_(avg)

    def step(self, closure=None):
        self.average_gradients()
        return self.base.step(closure)


def synchronous_sgd_hierarchical(base: torch.optim.Optimizer, world_size: int = 1, group=None,
                                 peer=None, name: str = "hier-ssgd", compress: str = "",
                                 device=None) -> HierarchicalSGD:
    return HierarchicalSGD(base, world_size, group, peer, name, compress, device)


def make_hier_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                         world_size: int = 1, group=None, peer=None, name: str = "hier",
                         compress: str = "", device=None):
    """One S-SGD step with hierarchical gradient sync: ``step(batch)``
    zeroes the gradients, backpropagates ``loss_fn(batch)`` (a scalar on
    this rank's shard of the batch), averages the gradients within the
    world, across worlds on the host plane, and back within the world,
    then applies the optimizer identically in every world. Returns the
    loss's in-world mean; `step.opt` is the HierarchicalSGD."""
    opt = HierarchicalSGD(optimizer, world_size, group, peer, name, compress, device)

    def step(batch):
        opt.zero_grad()
        loss = loss_fn(batch)
        loss.backward()
        opt.step()
        if opt.group is None:
            return loss.detach()
        return collective.all_average(loss.detach(), opt.group)

    step.opt = opt
    return step

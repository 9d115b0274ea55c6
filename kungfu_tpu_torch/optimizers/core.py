"""Distributed optimizer wrappers. Port of `kungfu_tpu/optimizers/core.py`.

The JAX wrappers are optax transformations traced into one SPMD step;
here each wraps a torch optimizer and runs its collectives eagerly around
the base optimizer's step, one flattened collective per dtype. Every
wrapper has `step`, `zero_grad`, `param_groups` and `session`.

`SynchronousSGD` and `SynchronousAveraging` wrap a built optimizer.
`AdaptiveSGD` and `ZeroSharded` need optimizer state of their own (two
independent states; state over this rank's shards only), so they take a
factory, ``base(params) -> torch.optim.Optimizer``.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch

from kungfu_tpu_torch.ops import collective

OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def _params(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for g in opt.param_groups for p in g["params"]]


def state_bytes(opt: torch.optim.Optimizer) -> int:
    """Bytes of a torch optimizer's tensor state on this rank (a wrapper's
    is its `base`'s)."""
    return sum(t.numel() * t.element_size() for s in opt.state.values()
               for t in s.values() if torch.is_tensor(t))


class SynchronousSGD:
    """S-SGD around a torch optimizer: average gradients over the session's
    world, then take the base optimizer's step."""

    def __init__(self, base: torch.optim.Optimizer, session):
        self.base = base
        self.session = session

    @property
    def param_groups(self):
        return self.base.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def average_gradients(self) -> None:
        if self.session.size == 1:
            return
        grads = [p.grad for p in _params(self.base) if p.grad is not None]
        for g, avg in zip(grads, collective.group_all_average(grads, self.session.group)):
            g.copy_(avg)

    def step(self, closure=None):
        self.average_gradients()
        return self.base.step(closure)


def synchronous_sgd(base: torch.optim.Optimizer, session) -> SynchronousSGD:
    return SynchronousSGD(base, session)


class SynchronousAveraging(SynchronousSGD):
    """SMA (`synchronous_averaging`, `core.py:122-146`): the base step on
    the LOCAL gradients, blended toward the world's average of the
    parameters as they were before the step:
    ``p <- p + u(p, g) + alpha * (mean(p) - p)``."""

    def __init__(self, base: torch.optim.Optimizer, session, alpha: float = 0.1):
        super().__init__(base, session)
        self.alpha = alpha

    @torch.no_grad()
    def step(self, closure=None):
        params = _params(self.base)
        # alpha * (mean(p) - p) at the parameters before the base step
        pulls = collective.group_all_average(params, self.session.group)
        for pull, p in zip(pulls, params):
            pull.sub_(p).mul_(self.alpha)
        loss = self.base.step(closure)
        for pull, p in zip(pulls, params):
            p.add_(pull)
        return loss


def synchronous_averaging(base: torch.optim.Optimizer, session,
                          alpha: float = 0.1) -> SynchronousAveraging:
    return SynchronousAveraging(base, session, alpha)


class AdaptiveSGD:
    """AdaptiveSGD (`adaptive_sgd`, `core.py:155-200`): SMA before
    `change_step`, S-SGD from it on. The two phases keep independent base
    states, each built by the factory, so S-SGD starts at `change_step`
    from fresh state (zero momentum, Adam step 0).

    At the switch step every rank first takes rank 0's parameters (the
    re-broadcast that ends SMA's divergence) and then the S-SGD step, so
    the ranks leave it bitwise equal. JAX folds the broadcast into the
    update as ``bcast(p) + u(p)`` with u at the local p; the two agree
    exactly for bases whose update does not read p (SGD, momentum, Adam),
    and differ by ``lr * wd * (p - bcast(p))`` under decoupled weight decay,
    a difference that leaves JAX's ranks apart by as much."""

    def __init__(self, base: OptimizerFactory, params: Iterable[torch.Tensor], session,
                 change_step: int, alpha: float = 0.1):
        params = list(params)
        self.sma = SynchronousAveraging(base(params), session, alpha)
        self.ssgd = SynchronousSGD(base(params), session)
        self.session = session
        self.change_step = change_step
        self.steps = 0

    @property
    def phase(self) -> SynchronousSGD:
        return self.sma if self.steps < self.change_step else self.ssgd

    @property
    def param_groups(self):
        return self.phase.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.phase.zero_grad(set_to_none)

    def step(self, closure=None):
        if self.steps == self.change_step and self.session.size > 1:
            with torch.no_grad():
                params = _params(self.ssgd.base)
                for p, b in zip(params, collective.group_broadcast(
                        params, 0, self.session.group)):
                    p.copy_(b)
        loss = self.phase.step(closure)
        self.steps += 1
        return loss


def adaptive_sgd(base: OptimizerFactory, params: Iterable[torch.Tensor], session,
                 change_step: int, alpha: float = 0.1) -> AdaptiveSGD:
    return AdaptiveSGD(base, params, session, change_step, alpha)


class ZeroSharded:
    """ZeRO-1 (`zero_sharded`, `core.py:45-115`): each leaf is flattened and
    zero-padded to a multiple of the world size k, and rank i owns elements
    ``[i*m, (i+1)*m)`` of it (m = ceil(n / k)). The base optimizer runs over
    this rank's shards only, so its state is 1/k of the model's. A step
    reduce-scatters the gradients (divided by k), takes the base step on
    the shards, and all-gathers the updated shards into the parameters.

    The collectives are bucketed by dtype: a bucket is laid out as k rows,
    row i holding every leaf's shard i, so the one reduce-scatter of the
    bucket hands each rank exactly the elements JAX's layout gives it."""

    def __init__(self, base: OptimizerFactory, params: Iterable[torch.Tensor], session):
        self.params = list(params)
        self.session = session
        self.k = k = session.size
        self.rank = session.rank
        self.shard_len = [-(-p.numel() // k) for p in self.params]
        self.buckets = {}  # dtype -> leaf indices, in order
        for i, p in enumerate(self.params):
            self.buckets.setdefault(p.dtype, []).append(i)
        self.shards: List[torch.Tensor] = [None] * len(self.params)
        with torch.no_grad():
            for i, p in enumerate(self.params):
                self.shards[i] = self._rows(p.detach(), i)[self.rank].clone()
        self.base = base(self.shards)

    def _rows(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i's flat, zero-padded (k, m) view: row r is rank r's shard."""
        m = self.shard_len[i]
        flat = t.reshape(-1)
        pad = m * self.k - flat.numel()
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.view(self.k, m)

    @property
    def param_groups(self):
        return self.base.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self, closure=None):
        group = self.session.group
        for idx in self.buckets.values():
            grads = [self.params[i].grad if self.params[i].grad is not None
                     else torch.zeros_like(self.params[i]) for i in idx]
            rows = torch.cat([self._rows(g, i) for g, i in zip(grads, idx)], dim=1)
            mine = collective.reduce_scatter(rows.reshape(-1), group).div_(self.k)
            for i, g in zip(idx, mine.split([self.shard_len[i] for i in idx])):
                self.shards[i].grad = g
        loss = self.base.step(closure)
        for idx in self.buckets.values():
            send = torch.cat([self.shards[i].detach() for i in idx])
            out = send.new_empty(self.k * send.numel())
            collective.all_gather_into(out, send, group)
            full = out.view(self.k, -1).split([self.shard_len[i] for i in idx], dim=1)
            for i, rows in zip(idx, full):
                p = self.params[i]
                p.copy_(rows.reshape(-1)[:p.numel()].view_as(p))
        return loss


def zero_sharded(base: OptimizerFactory, params: Iterable[torch.Tensor],
                 session) -> ZeroSharded:
    return ZeroSharded(base, params, session)

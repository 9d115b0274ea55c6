"""Distributed optimizer wrappers. Port of
`kungfu_tpu/optimizers/core.py::synchronous_sgd`.

The JAX wrapper traces one `pmean` per leaf into the step and lets XLA
combine them; here the gradients are averaged in place, before the base
optimizer's step, with one flattened all-reduce per dtype.
"""

from __future__ import annotations

import torch

from kungfu_tpu_torch.ops import collective


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
        grads = [p.grad for g in self.base.param_groups for p in g["params"]
                 if p.grad is not None]
        for g, avg in zip(grads, collective.group_all_average(grads, self.session.group)):
            g.copy_(avg)

    def step(self, closure=None):
        self.average_gradients()
        return self.base.step(closure)


def synchronous_sgd(base: torch.optim.Optimizer, session) -> SynchronousSGD:
    return SynchronousSGD(base, session)

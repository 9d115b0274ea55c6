"""Data-parallel training step. Port of `kungfu_tpu/parallel/dp.py`.

The JAX package builds one jitted SPMD program; PyTorch runs eagerly, so
the step is a plain function: local loss and gradients, the optimizer's
step (which synchronizes, see `optimizers/core.py`), and the loss averaged
over the data-parallel world.
"""

from __future__ import annotations

from typing import Callable

import torch

from kungfu_tpu_torch.ops import collective


def make_train_step(loss_fn: Callable, optimizer, session) -> Callable:
    """loss_fn(model, batch) -> scalar loss on this rank's shard. Returns
    step(model, batch) -> loss averaged over the session's world."""

    def step(model, batch) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return collective.all_average(loss.detach(), session.group)

    return step


def shard_batch(batch, session, axes=("dp",)):
    """This rank's block of a global batch, moved to the session's device:
    dimension d split evenly over mesh axis `axes[d]`, at this rank's index
    on it (axes=("dp", "sp"): rows over dp, columns over sp, JAX's
    `P("dp", "sp")`). `batch` is a tensor or a tuple/list of tensors."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, session, axes) for b in batch)
    for dim, name in enumerate(axes):
        n, size = batch.shape[dim], session.axis_size(name)
        if n % size:
            raise ValueError(f"dimension {dim} of {n} does not split over {size} "
                             f"ranks of axis {name!r}")
        per = n // size
        batch = batch.narrow(dim, session.axis_index(name) * per, per)
    return batch.to(session.device)

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


def shard_batch(batch, session):
    """This rank's slice of a global batch (leading dim split evenly over
    the world), moved to the session's device. `batch` is a tensor or a
    tuple/list of tensors."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, session) for b in batch)
    n, size = batch.shape[0], session.size
    if n % size:
        raise ValueError(f"batch of {n} does not split over {size} ranks")
    per = n // size
    return batch[session.rank * per:(session.rank + 1) * per].to(session.device)

"""Faults planted under the timed path, for the tests that see `correct`
come out false and for the calibration that reads each fault's numbers:

- `unchanged`: the base optimizer's step returns the state unchanged;
- `half_batch`: the loss is the mean over the first half of the batch,
  the rest left out;
- `no_exchange`: the collectives average nothing between the ranks
  (each rank keeps its own gradients and running statistics).
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "no_exchange")


@contextlib.contextmanager
def _patched(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def unchanged():
    def no_step(self, closure=None):
        return None

    with _patched(torch.optim.SGD, "step", no_step), _patched(torch.optim.AdamW, "step", no_step):
        yield


@contextlib.contextmanager
def half_batch():
    from kfbench.jobs import bert, resnet

    resnet_loss, mlm_loss = resnet.resnet_loss, bert.mlm_loss

    def half_resnet(model, batch):
        images, labels = batch
        h = images.shape[0] // 2
        return resnet_loss(model, (images[:h], labels[:h]))

    def half_mlm(params, inputs, targets, mask, cfg, core=None):
        h = inputs.shape[0] // 2
        return mlm_loss(params, inputs[:h], targets[:h], mask[:h], cfg, core=core)

    with _patched(resnet, "resnet_loss", half_resnet), _patched(bert, "mlm_loss", half_mlm):
        yield


@contextlib.contextmanager
def no_exchange():
    from kungfu_tpu_torch.ops import collective

    def local(xs, *args, **kwargs):
        return [x.clone() for x in xs]

    with _patched(collective, "group_all_reduce", local), \
            _patched(collective, "group_all_average", local):
        yield


def planted(name):
    """The context manager of fault `name` (None: no fault)."""
    if name is None:
        return contextlib.nullcontext()
    return {"unchanged": unchanged, "half_batch": half_batch, "no_exchange": no_exchange}[name]()

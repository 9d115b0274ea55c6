"""Sharded train steps: DP x TP (x SP) over a mesh. Port of
`kungfu_tpu/parallel/sharded.py`.

In the JAX package the parameters carry PartitionSpecs and XLA's SPMD
partitioner derives every collective from them. The port has no
partitioner: a rank holds its shard of each leaf (`shard_params`, by the
specs of `models.transformer.param_pspecs`), the loss function writes the
tensor-parallel collectives out (`models.transformer.tp_transformer_loss`),
and S-SGD averages the gradients over the mesh axes that no spec splits
a leaf over (the data axes: dp, and sp where the sequence is sharded),
as one collective over their joint group.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import torch

from kungfu_tpu_torch.models.convert import map_tree, shard_tree
from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.optimizers.core import SynchronousSGD
from kungfu_tpu_torch.parallel.dp import make_train_step, shard_batch


def _spec_axes(specs: Mapping) -> set:
    out = set()
    for v in specs.values():
        out |= _spec_axes(v) if isinstance(v, Mapping) else {a for a in v if a is not None}
    return out


def shard_params(params: Mapping, session, param_specs: Mapping) -> Dict:
    """This rank's shard of each leaf of a nested dict (`shard_tree` at the
    rank's mesh coordinates). A transformer tree goes through
    `models.convert.tp_layout` first, so that wqkv's blocks are head
    shards."""
    return shard_tree(params, param_specs, session.shape,
                      {a: session.axis_index(a) for a in session.axis_names})


def gather_params(params: Mapping, session, param_specs: Mapping) -> Dict:
    """The inverse of `shard_params`: every leaf whole on every rank,
    all-gathered along each sharded dimension over its axis."""
    def gather(t, spec):
        t = t.detach()
        for dim, name in enumerate(spec):
            if name is not None:
                t = collective.all_gather(t, axis=dim, tiled=True,
                                          group=session.axis_group(name))
        return t

    return map_tree(gather, params, param_specs)


def make_sharded_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer, session,
                            param_specs: Mapping, batch_spec: Sequence = ("dp",)) -> Callable:
    """loss_fn(model, batch) -> this rank's scalar loss on its block of the
    batch; `optimizer` a plain torch optimizer over this rank's shards.
    Returns step(model, batch): `batch` (a tensor or tuple of tensors) is
    the global batch, cut by `batch_spec` (the mesh axis of each leading
    dimension, as `parallel.dp.shard_batch` takes it) before loss_fn sees
    it; S-SGD averages the gradients over the data axes (the mesh axes
    that `param_specs` splits nothing over), as one collective over their
    group, a zero gradient for a leaf the loss left out; the step returns
    the loss averaged over the world. Every rank calls this: it may make
    the data axes' group."""
    data_axes = [a for a in session.axis_names if a not in _spec_axes(param_specs)]
    step = make_train_step(loss_fn, SynchronousSGD(optimizer, session,
                                                   session.axes_group(data_axes)), session)
    return lambda model, batch: step(model, shard_batch(batch, session, tuple(batch_spec)))

"""ElasticState: the progress-based elastic training loop.

Port of `kungfu_tpu/elastic/state.py` (parity:
srcs/python/kungfu/python/elastic_state.py:4-79 + KungFuElasticTrainHook's
state re-sync, hooks/elastic.py:46-57):

  es = ElasticState(max_progress)
  es.register_state(get_state, set_state)   # joiner weight re-sync
  while not es.stopped():
      with es.scope():          # begin(): sync progress + state after resize
          train_one_batch()
          es.end(batch_size)    # progress += n, maybe resize
                                # (es.advance is an alias for es.end)
Stop reasons: 'finished' | 'detached' | 'reload'.

After every membership change begin() (a) adopts the cluster-max progress
via an int-max allreduce and (b) if state callbacks are registered,
broadcasts a surviving peer's training state over the host plane so
joining workers inherit live weights instead of fresh-initialized ones.

The state is a tree of dicts, lists and tuples (namedtuples too) whose
leaves are tensors, numpy arrays and Python numbers; None is an empty
subtree. It flattens in jax's leaf order (`jax.tree.flatten`): a dict's
keys sorted, an OrderedDict's in insertion order, sequences in order. So
the blob a reference root broadcasts unpacks into the right leaves here,
and the other way round. `set_state` gets each leaf back with the old
leaf's dtype, shape and device; a card's leaves travel through the
api's pinned buffers both ways.
"""

from __future__ import annotations

import collections
import contextlib
import numbers
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from kungfu_tpu_torch import api
from kungfu_tpu_torch.base.serialize import pack_leaves as _pack_leaves
from kungfu_tpu_torch.base.serialize import unpack_leaves as _unpack_leaves


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves in jax's order, unflatten) of a tree of dicts, lists and
    tuples; `unflatten(new_leaves)` rebuilds the same containers, keys in
    their original order."""
    leaves: List[Any] = []

    def build(x):
        if x is None:
            return lambda it: None
        if isinstance(x, dict):
            keys = list(x) if isinstance(x, collections.OrderedDict) else sorted(x)
            subs = [(k, build(x[k])) for k in keys]

            def make_dict(it, x=x, subs=subs):
                got = {k: sub(it) for k, sub in subs}
                return type(x)((k, got[k]) for k in x) if isinstance(x, collections.OrderedDict) \
                    else {k: got[k] for k in x}
            return make_dict
        if isinstance(x, (list, tuple)):
            subs = [build(v) for v in x]
            if _is_namedtuple(x):
                return lambda it, t=type(x): t(*[sub(it) for sub in subs])
            return lambda it, t=type(x): t([sub(it) for sub in subs])
        if not isinstance(x, (torch.Tensor, np.ndarray, np.generic, numbers.Number)):
            raise TypeError(f"elastic state leaf of type {type(x).__name__}: "
                            "expected a tensor, a numpy array or a number")
        leaves.append(x)
        return lambda it: next(it)

    rebuild = build(tree)
    return leaves, lambda new: rebuild(iter(new))


def _host_leaves(leaves) -> Tuple[List[torch.Tensor], list]:
    """Each leaf as a host tensor of its shape and dtype (a card's leaves
    staged through pinned buffers), and the staged pairs to release."""
    cards = [x for x in leaves if isinstance(x, torch.Tensor) and x.device.type != "cpu"]
    staged = api._stage([x.detach() for x in cards])
    it = iter(staged)
    out = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            out.append(next(it)[0].reshape(x.shape) if x.device.type != "cpu" else x.detach())
        else:
            # numpy's dtype for numbers too (a Python float is float64)
            out.append(torch.from_numpy(np.array(x)))
    return out, staged


def pack_state(leaves) -> bytes:
    """`pack_leaves` of the leaves, a card's staged through the api's
    pinned buffers (numbers as numpy arrays of numpy's dtype)."""
    host, staged = _host_leaves(leaves)
    try:
        return _pack_leaves(host)
    finally:
        api._release(staged)


def _like(new: torch.Tensor, old):
    """`new` with the old leaf's dtype, shape and device (a numpy array
    for a numpy or Python-number leaf, as the reference gives back)."""
    if isinstance(old, torch.Tensor):
        if old.device.type == "cpu":
            return new.to(old.dtype).reshape(old.shape)
        host, buf = api._host(old, copy=False)
        host.copy_(new.reshape(-1).to(old.dtype))
        return api._back(old, host, buf)
    want = np.asarray(old).dtype
    return new.numpy().astype(want).reshape(np.shape(old))


class ElasticState:
    def __init__(self, max_progress: Optional[int] = None, reload_mode: bool = False):
        from kungfu_tpu_torch.peer import get_default_peer

        self.max_progress = max_progress
        self.reload_mode = reload_mode
        self._peer = get_default_peer()
        self.progress = self._peer.config.init_progress
        self._synced = False
        self._stop_reason: Optional[str] = None
        self._get_state: Optional[Callable] = None
        self._set_state: Optional[Callable] = None
        # the latest state sync's seconds, blob bytes and root
        # (bytes 0: nothing to send, a world of one or a pure shrink)
        self.last_sync: dict = {}
        # last checkpoint version this loop saved/restored; None until
        # note_checkpoint() (the reference stamps it onto resize audit
        # records, which wait for ROADMAP item 1e)
        self._checkpoint_version: Optional[int] = None

    def note_checkpoint(self, version: int) -> None:
        """Tell the elastic loop which checkpoint version now covers
        `progress`."""
        self._checkpoint_version = int(version)

    def register_state(self, get_state: Callable, set_state: Callable) -> None:
        """Register training-state callbacks for joiner re-sync.

        get_state() -> tree of tensors/arrays (params + optimizer state);
        set_state(tree) installs the received values. Called only after
        membership changes, never in the steady-state step path.
        """
        self._get_state = get_state
        self._set_state = set_state

    def _sync_state(self) -> None:
        if self._get_state is None:
            return
        from kungfu_tpu_torch.utils import trace

        t0 = time.perf_counter()
        with trace.span("elastic.sync_state"):
            self._sync_state_traced()
        self.last_sync["seconds"] = time.perf_counter() - t0

    def _sync_state_traced(self) -> None:
        from kungfu_tpu_torch.base.ops import ReduceOp
        from kungfu_tpu_torch.base.workspace import Workspace

        self.last_sync = {"bytes": 0, "root": None}
        sess = self._peer.current_session()
        if sess.size == 1:
            return
        # Pick a provably SURVIVING broadcast root: the new cluster's order
        # comes verbatim from the user's config PUT, so rank 0 may be a
        # fresh joiner whose state must never overwrite the survivors'.
        # Each peer votes (its rank if it lived through a previous epoch);
        # the min survivor rank becomes the root. The joiner count rides a
        # second vote: a pure shrink has none and skips the broadcast.
        big = 1 << 30
        survivor = self._peer.epoch_count > 1
        v = f"v{self._peer.cluster_version}"
        root_in = torch.tensor([sess.rank if survivor else big], dtype=torch.int64)
        root_out = torch.zeros(1, dtype=torch.int64)
        sess.all_reduce(Workspace(root_in, root_out, ReduceOp.MIN, f"kungfu::syncroot:{v}"))
        fresh_in = torch.tensor([0 if survivor else 1], dtype=torch.int64)
        fresh_out = torch.zeros(1, dtype=torch.int64)
        sess.all_reduce(Workspace(fresh_in, fresh_out, ReduceOp.SUM, f"kungfu::syncfresh:{v}"))
        if int(fresh_out[0]) == 0:
            return  # pure shrink: survivors are already in sync
        # fresh world (startup / reload): root 0 = initializer broadcast
        root = int(root_out[0]) if int(root_out[0]) < big else 0
        leaves, unflatten = tree_flatten(self._get_state())
        blob = pack_state(leaves) if sess.rank == root else b""
        got = sess.broadcast_bytes(blob, f"kungfu::statesync:{v}", root=root)
        self.last_sync.update(bytes=len(got), root=root)
        if sess.rank != root and self._set_state is not None:
            new_leaves = _unpack_leaves(got, len(leaves))
            self._set_state(unflatten([_like(nl, ol) for nl, ol in zip(new_leaves, leaves)]))

    def begin(self) -> None:
        if not self._synced:
            # after a membership change, everyone adopts the max progress
            # and a survivor's live training state
            self.progress = api.all_reduce_int_max(self.progress)
            self._sync_state()
            self._synced = True

    def end(self, delta: int = 1) -> None:
        self.progress += delta
        if self.max_progress is not None and self.progress >= self.max_progress:
            self._stop_reason = "finished"
            return
        if self.reload_mode:
            changed, _ = api.change_cluster(self.progress)
            if changed:
                self._stop_reason = "reload"
            return
        changed, detached = api.resize()
        if detached:
            self._stop_reason = "detached"
        elif changed:
            self._synced = False

    advance = end  # documented alias

    @contextlib.contextmanager
    def scope(self):
        self.begin()
        yield

    def stopped(self) -> bool:
        return self._stop_reason is not None

    @property
    def stop_reason(self) -> Optional[str]:
        return self._stop_reason

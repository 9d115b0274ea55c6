"""Checkpoint/resume for elastic and failure-recovered training.

Port of `kungfu_tpu/elastic/checkpoint.py`. The reference has no general
checkpoint subsystem (SURVEY §5.4): resume relies on live state broadcast
across survivors plus user-managed Keras checkpoints reloaded on
``--restart 1``. This build keeps the live-broadcast path
(elastic/state.py) for in-flight membership changes and adds a real
checkpointer for the cases live state cannot cover: a full-cluster
restart (kfrun -auto-recover relaunch, preemption of every host).

The JAX package writes through orbax; the port cannot, and writes its own
format instead. A step is a directory named by the step number holding
one file, ``state.kf``: the state's leaves as one `base/serialize`
`pack_leaves` blob, in jax's leaf order (`elastic/state.tree_flatten`).
A save writes the directory under a temporary name, fsyncs the file and
the directory, then `os.replace`s it into place, so a worker killed
mid-save leaves no step that `latest_step` would pick. An orbax
directory is not readable here, nor this format by orbax.

Also provides ``dump_final_variables`` (parity: hooks/elastic.py:80-87,
the ad-hoc ``variables-final.npz`` dump), byte-equal to the reference's
for the same tree, and its inverse, which reads the reference's file.

Usage with the auto-recover contract::

    ckpt = Checkpointer(logdir)            # every rank; saves on rank 0
    state, start = ckpt.restore_or({"params": params, "opt": opt_state})
    for epoch in range(start, n_epochs):
        ...
        ckpt.save(epoch + 1, state)        # after the epoch completes
        cmd.monitor_epoch_end()

On relaunch, KF_RECOVER_EPOCH (set by the monitored runner from the
heartbeat min-epoch) caps the restore step: a checkpoint AHEAD of the
cluster-wide safe epoch is skipped so every worker resumes from the same
step.
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from kungfu_tpu_torch import knobs, resolve_device
from kungfu_tpu_torch.base.serialize import unpack_leaves
from kungfu_tpu_torch.elastic.state import _like, pack_state, tree_flatten
from kungfu_tpu_torch.runner.monitored import RECOVER_EPOCH_ENV

STATE_FILE = "state.kf"
_TMP = ".tmp-"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_durably(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _remove(directory: str, name: str) -> None:
    """Rename the step away first, so a half-deleted step is never seen."""
    gone = os.path.join(directory, f"{_TMP}gone-{name}-{uuid.uuid4().hex}")
    os.replace(os.path.join(directory, name), gone)
    shutil.rmtree(gone, ignore_errors=True)


class Checkpointer:
    """(step, tree) checkpoints with a bounded window.

    Saving is rank-0-only by default (synchronous data parallelism keeps
    state replicated); every rank restores from the same directory:
    colocated workers share the local file system, workers on several
    hosts need a shared path.

    `device` is where the training state lives: None means the CUDA card
    (and raises without one), "cpu" host state. A card's leaves go
    through the api's pinned buffers both ways, and a restored leaf keeps
    the dtype, shape and device of the matching leaf of the tree it is
    restored onto."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_rank: Optional[int] = 0,
                 device=None):
        self.device = resolve_device(device)
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_rank = save_rank
        os.makedirs(self.directory, exist_ok=True)

    def _my_rank(self) -> int:
        """This worker's rank when a peer runs (or kfrun started this
        process), else rank 0: checkpointing is usable without a cluster."""
        from kungfu_tpu_torch import api
        from kungfu_tpu_torch.peer import running_default_peer

        if running_default_peer() is None and not knobs.raw("KF_SELF_SPEC"):
            return 0
        return api.current_rank()

    def all_steps(self) -> List[int]:
        """Every complete step in the directory, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Save `state` at `step`; returns True if written (rank-gated).
        A step already saved is replaced. `force` is accepted for the
        reference's signature: every call saves."""
        if self.save_rank is not None and self._my_rank() != self.save_rank:
            return False
        leaves, _ = tree_flatten(state)
        blob = pack_state(leaves)
        tmp = os.path.join(self.directory, f"{_TMP}{step}-{uuid.uuid4().hex}")
        os.mkdir(tmp)
        try:
            _write_durably(os.path.join(tmp, STATE_FILE), blob)
            _fsync_dir(tmp)
            final = os.path.join(self.directory, str(int(step)))
            if os.path.exists(final):
                _remove(self.directory, str(int(step)))
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _fsync_dir(self.directory)
        steps = self.all_steps()
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            _remove(self.directory, str(old))
        return True

    def latest_step(self) -> Optional[int]:
        """Newest step not beyond the cluster-wide safe resume epoch
        (KF_RECOVER_EPOCH, when the monitored runner provides one)."""
        steps = self.all_steps()
        cap = knobs.raw(RECOVER_EPOCH_ENV)
        if cap:
            steps = [s for s in steps if s <= int(cap)]
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """The state saved at `step` (default: `latest_step()`), rebuilt
        onto `like`'s tree."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        with open(os.path.join(self.directory, str(int(step)), STATE_FILE), "rb") as f:
            blob = f.read()
        return _onto(like, blob)

    def restore_or(self, default_state: Any) -> Tuple[Any, int]:
        """(state, start_step): the newest safe checkpoint, or the given
        initial state at step 0."""
        step = self.latest_step()
        if step is None:
            return default_state, 0
        return self.restore(default_state, step), step

    def close(self) -> None:
        """Nothing is left in flight: every save has ended on return."""


def _onto(like: Any, blob: bytes) -> Any:
    leaves, unflatten = tree_flatten(like)
    got = unpack_leaves(blob, len(leaves))
    out = []
    for new, old in zip(got, leaves):
        want = tuple(old.shape) if isinstance(old, torch.Tensor) else np.shape(old)
        if tuple(new.shape) != want:
            raise ValueError(f"checkpoint leaf of shape {tuple(new.shape)} where the tree "
                             f"holds {want}")
        out.append(_like(new, old))
    return unflatten(out)


def dump_final_variables(path: str, tree: Any) -> None:
    """Dump a tree's leaves to one file at end of training (parity:
    variables-final.npz, hooks/elastic.py:80-87): the dtype-faithful pack
    format, leaves in jax's order, byte-equal to the reference's file."""
    leaves, _ = tree_flatten(tree)
    with open(path, "wb") as f:
        f.write(pack_state(leaves))


def load_final_variables(path: str, like: Any) -> Any:
    """Inverse of dump_final_variables (the reference's file too),
    rebuilt onto `like`'s tree."""
    with open(path, "rb") as f:
        return _onto(like, f.read())

"""Elastic dataset adaptor: shard/offset-aware batches across resizes.

Port of `kungfu_tpu/elastic/dataset.py`, in numpy as the reference: the
same per-epoch permutation (`np.random.default_rng(seed + epoch)`), so
both packages give every (progress, rank, size) the same indices.
Capability parity: srcs/python/kungfu/tensorflow/v1/datasets/adaptor.py —
the dataset must (a) shard batches across the CURRENT cluster and (b)
resume from the global progress offset after a resize, so no sample is
double-trained or skipped when workers join/leave (modulo the in-flight
batch).

Design: a deterministic global sample order (seeded per-epoch
permutation) indexed by the cluster-max progress that ElasticState already
syncs. Any worker at (progress, rank, size) can compute its batch without
coordination — the progress IS the dataset iterator state, which is what
makes elastic restart (and reload mode) trivially correct.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class ElasticDataset:
    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int, seed: int = 0):
        if not arrays:
            raise ValueError("need at least one array")
        n = len(arrays[0])
        for a in arrays:
            if len(a) != n:
                raise ValueError("all arrays must share the leading dimension")
        self.arrays = [np.asarray(a) for a in arrays]
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self._perm_epoch = -1
        self._perm: np.ndarray = np.empty(0, np.int64)

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if epoch != self._perm_epoch:
            rng = np.random.default_rng(self.seed + epoch)
            self._perm = rng.permutation(self.n)
            self._perm_epoch = epoch
        return self._perm

    def indices_at(self, progress: int, rank: int, size: int) -> np.ndarray:
        """The sample indices worker `rank` of `size` trains at global
        progress `progress` (measured in SAMPLES, like ElasticState). The
        global order is a per-epoch permutation; batches wrap across
        epochs."""
        start = progress + rank * self.batch_size
        idx = np.arange(start, start + self.batch_size)
        epoch = idx // self.n
        pos = idx % self.n
        if (epoch == epoch[0]).all():
            return self._epoch_perm(int(epoch[0]))[pos]
        # batch straddles an epoch boundary
        return np.array([self._epoch_perm(int(e))[p] for e, p in zip(epoch, pos)])

    def batch_at(self, progress: int, rank: int, size: int) -> Tuple[np.ndarray, ...]:
        """The batch of `indices_at(progress, rank, size)`."""
        sel = self.indices_at(progress, rank, size)
        return tuple(a[sel] for a in self.arrays)

    def cluster_delta(self, size: int) -> int:
        """Progress consumed by one cluster-wide step (for es.end)."""
        return self.batch_size * size

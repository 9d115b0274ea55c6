"""Minimum spanning tree over a peer latency matrix.

Port of `kungfu_tpu/plan/mst.py` (parity: the reference's MST topology
optimization, srcs/cpp/include/kungfu/mst.hpp:9-59). The control plane
probes per-peer RTTs, allgathers them into a dense matrix, and the MST
over that matrix becomes the reduce/broadcast forest for host-plane
collectives. Prim's runs in the port's host C++ (`csrc/host/mst.cpp`,
`kf_mst`); `_mst_numpy` is its plain twin, the tests' oracle.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from kungfu_tpu_torch.base import _native


def _mst_numpy(w: np.ndarray) -> np.ndarray:
    """Prim's, O(n^2); father[0] == 0 (root)."""
    n = w.shape[0]
    father = np.zeros(n, np.int32)
    done = np.zeros(n, bool)
    done[0] = True
    best_cost = w[0].copy()
    best_from = np.zeros(n, np.int64)
    best_cost[0] = np.inf
    for _ in range(n - 1):
        masked = np.where(done, np.inf, best_cost)
        pick = int(np.argmin(masked))
        if not np.isfinite(masked[pick]):
            raise ValueError("disconnected latency graph")
        done[pick] = True
        father[pick] = best_from[pick]
        better = (~done) & (w[pick] < best_cost)
        best_cost[better] = w[pick][better]
        best_from[better] = pick
    return father


def minimum_spanning_tree(weights: Sequence[Sequence[float]]) -> List[int]:
    """Father array of the MST of a dense symmetric cost matrix."""
    w = np.ascontiguousarray(weights, np.float64)
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"weights must be square, got {w.shape}")
    n = w.shape[0]
    if n == 0:
        return []
    if n == 1:
        return [0]
    father = torch.zeros(n, dtype=torch.int32)
    rc = _native.mst(torch.from_numpy(w).reshape(-1), father)
    if rc == 2:
        raise ValueError("disconnected latency graph")
    if rc != 0:
        raise ValueError(f"kf_mst failed with code {rc}")
    return father.tolist()


def uses_native() -> bool:
    """Whether the MST runs in the host C++: always, since the port has no
    numpy fallback (`base/_native.py` builds and loads the library, or
    raises)."""
    return _native.lib() is not None

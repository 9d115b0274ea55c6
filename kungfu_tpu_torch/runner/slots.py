"""Per-worker device-slot allocation.

Port of `kungfu_tpu/runner/slots.py` (parity:
srcs/go/kungfu/job/gpu_resource.go, the per-host GPU slot pool): N
workers sharing a host must each see a DISJOINT set of cards instead of
all opening the same ones.

The runner partitions the host's card ids among its local workers and
exports them as ``KF_DEVICE_SLOTS`` alone (`runner/env.py::worker_env`);
the device plane opens ``cuda:<slot>`` itself, so no visibility variable
renumbers the cards. The elastic watcher draws and returns slots from one
pool across resizes, so a joiner never doubles up on a surviving
worker's card.
"""

from __future__ import annotations

import threading
from typing import List, Sequence


class SlotPool:
    """Host-local pool of device ids (parity: GPUPool.Get/Put)."""

    def __init__(self, ids: Sequence[int]):
        self._lock = threading.Lock()
        self._free = sorted(set(int(i) for i in ids))
        self._cap = len(self._free)

    @classmethod
    def of_size(cls, n: int) -> "SlotPool":
        return cls(range(n))

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def available(self) -> int:
        with self._lock:
            return len(self._free)

    def get(self, n: int) -> List[int]:
        """Take n ids (lowest first); raises when the pool is short."""
        with self._lock:
            if n > len(self._free):
                raise RuntimeError(
                    f"device slot pool exhausted: want {n}, have {len(self._free)}"
                )
            taken, self._free = self._free[:n], self._free[n:]
            return taken

    def put(self, ids: Sequence[int]) -> None:
        with self._lock:
            back = set(int(i) for i in ids)
            dup = back & set(self._free)
            if dup:
                raise ValueError(f"double free of device slots {sorted(dup)}")
            self._free = sorted(set(self._free) | back)


def partition(n_devices: int, n_workers: int) -> List[List[int]]:
    """Even rank-major partition of device ids over local workers (worker
    i of k gets a contiguous stripe; remainders go to the first workers)."""
    if n_workers <= 0:
        return []
    base, rem = divmod(n_devices, n_workers)
    out, off = [], 0
    for i in range(n_workers):
        take = base + (1 if i < rem else 0)
        out.append(list(range(off, off + take)))
        off += take
    return out

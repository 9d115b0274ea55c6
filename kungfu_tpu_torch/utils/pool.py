"""Cached-thread executor and reusable byte-buffer pool.

Port of `kungfu_tpu/utils/pool.py`. Capability parity: the reference
engine runs every graph-walk send/recv in a goroutine and recycles
payload buffers through a pool
(srcs/go/rchannel/connection/byte_slice_pool.go). Python threads are far
more expensive to create than goroutines, so the collective hot path must
not spawn a fresh thread per peer x chunk (at small message sizes that
cost dominates).

`CachedThreadPool.submit` never blocks waiting for a free worker — an idle
parked thread is reused, otherwise a new one spawns (goroutine semantics;
a bounded pool would deadlock on nested _par fan-outs). Idle workers park
for `idle_ttl` seconds, then exit, so a big elastic cluster epoch doesn't
pin threads forever.
"""

from __future__ import annotations

import itertools
import threading
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, List, Optional

import torch

from kungfu_tpu_torch.telemetry import memory as tmemory

# lock order: the executor takes the pool lock first, then a parked
# worker's condition to hand the task over


class _Worker:
    __slots__ = ("task", "cond", "dead")

    def __init__(self):
        self.cond = threading.Condition()
        self.task: Optional[Callable[[], None]] = None
        self.dead = False


class CachedThreadPool:
    def __init__(self, idle_ttl: float = 30.0):
        self._idle: Deque[_Worker] = deque()
        self._lock = threading.Lock()
        self._ttl = idle_ttl
        # named kf-pool-<n>: the resource plane attributes these
        # threads' CPU to the walk engine by the prefix
        self._names = itertools.count()

    def submit(self, fn: Callable[[], None]) -> None:
        """Run fn on a cached (or new) daemon thread; never blocks."""
        with self._lock:
            while self._idle:
                w = self._idle.pop()
                with w.cond:
                    if w.dead:
                        continue
                    w.task = fn
                    w.cond.notify()
                return
        w = _Worker()
        w.task = fn
        threading.Thread(
            target=self._loop, args=(w,),
            name=f"kf-pool-{next(self._names)}", daemon=True,
        ).start()

    def _loop(self, w: _Worker) -> None:
        while True:
            task = w.task
            w.task = None
            try:
                task()
            except BaseException as e:  # noqa: BLE001 - must not kill the worker
                # submitted fns wrap their own errors; one escaping to
                # here is a caller bug worth a trace, not silence
                from kungfu_tpu_torch.telemetry import log

                log.error("pool: submitted task raised: %r", e)
            with self._lock:
                self._idle.append(w)
            with w.cond:
                if not w.cond.wait_for(lambda: w.task is not None, self._ttl):
                    w.dead = True
                    return


_POOL = CachedThreadPool()


def get_pool() -> CachedThreadPool:
    return _POOL


class BufferPool:
    """Reusable pool of byte tensors keyed by exact size (parity:
    byte_slice_pool.go). Collectives re-receive the same chunk sizes every
    step, so exact-size bins hit ~always; unreturned buffers (timed-out
    receives whose writer may still be mid-fill) are simply leaked.

    `pin_memory` is the pool's explicit choice: pinned buffers stage CUDA
    tensors (a card's copy into or out of one can run asynchronously),
    and exist only where a CUDA device does. A buffer is a one-dimensional
    `torch.uint8` tensor on the CPU; view it as the dtype it stages."""

    def __init__(self, max_per_size: int = 16, pin_memory: bool = False):
        if pin_memory and not torch.cuda.is_available():
            raise RuntimeError("a pinned buffer pool needs a CUDA device, and none is available")
        self._bins: Dict[int, List[torch.Tensor]] = defaultdict(list)
        self._lock = threading.Lock()
        self._max = max_per_size
        self.pin_memory = pin_memory

    def cached_bytes(self) -> int:
        """Bytes currently parked in the bins (buffers checked out to
        callers are the caller's, not the pool's)."""
        with self._lock:
            return sum(
                buf.numel() for bin_ in self._bins.values() for buf in bin_
            )

    def get(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            b = self._bins.get(nbytes)
            if b:
                return b.pop()
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin_memory)

    def put(self, buf: torch.Tensor) -> None:
        if buf.dtype != torch.uint8 or buf.dim() != 1 or buf.is_pinned() != self.pin_memory:
            raise ValueError("put takes back the pool's own byte buffers")
        with self._lock:
            b = self._bins[buf.numel()]
            if len(b) < self._max:
                b.append(buf)


_BUFFERS = BufferPool()


def get_buffer_pool() -> BufferPool:
    """The process's pool of unpinned host buffers."""
    return _BUFFERS


# memory plane: the process's buffer pool is a long-lived buffer owner
tmemory.register_accountant("buffer_pool", "pool", _BUFFERS.cached_bytes)

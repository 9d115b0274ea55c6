"""Abort-aware thread handoff primitives for the collective engine.

Port of `kungfu_tpu/utils/handoff.py`: the two shapes every engine stage
hands work between threads with:

- :class:`HandoffQueue` — a bounded queue whose every blocking operation
  polls a shared abort :class:`threading.Event`. A producer that died
  without enqueueing its sentinel can never strand a consumer (``get``
  turns into the ``None`` sentinel on abort), and a consumer that died
  can never wedge a producer (``put`` gives up and reports the drop).
- :func:`parallel_run` — goroutine-style fan-out over the shared cached
  thread pool: run all callables, wait under ONE deadline, re-raise the
  first error; on timeout the shared ``cancel`` event is set BEFORE
  raising so abandoned workers that later complete a receive observe it
  and must not mutate caller buffers (the late-write hazard).

Both primitives poll rather than wait unbounded — a lost notify or a
lost sentinel degrades to one poll interval of latency, never a hang.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

# how often a blocked put/get re-checks the abort flag; latency of an
# abort delivery, not of the data path (a ready item never waits)
_POLL_S = 0.2


class HandoffQueue:
    """Bounded handoff queue with abort-aware blocking put/get.

    All queues wired to the same ``abort`` event abort together — the
    engine passes one event per pipeline so any stage's failure (or the
    caller's timeout) unblocks every other stage at once.
    """

    def __init__(self, maxsize: int = 1,
                 abort: Optional[threading.Event] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, maxsize))
        self.abort = abort if abort is not None else threading.Event()

    def put(self, item) -> bool:
        """Blocking put; returns False (item dropped) once aborted."""
        while True:
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                if self.abort.is_set():
                    return False

    def get(self):
        """Blocking get; returns the ``None`` sentinel once aborted, so
        a consumer can never be stranded by a lost sentinel."""
        while True:
            try:
                return self._q.get(timeout=_POLL_S)
            except queue.Empty:
                if self.abort.is_set():
                    return None

    def try_get(self, timeout: float):
        """Bounded get: the item, or None after ``timeout`` seconds or
        on abort (same sentinel contract as :meth:`get`)."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                return self._q.get(timeout=min(_POLL_S, remaining))
            except queue.Empty:
                if self.abort.is_set():
                    return None

    def close(self) -> None:
        """Abort the queue: wakes every blocked producer and consumer."""
        self.abort.set()

    def __len__(self) -> int:
        return self._q.qsize()


def parallel_run(
    fns: List[Callable[[], None]],
    timeout: float,
    cancel: Optional[threading.Event] = None,
) -> None:
    """Run callables on the shared cached-thread pool, wait for all,
    re-raise the first error (goroutine-style fan-out; an unbounded
    cached pool avoids both thread-spawn cost per call and
    pool-exhaustion deadlocks on nested parallelism).

    All waits share ONE deadline (worst case = timeout, not
    len(fns)*timeout). On timeout ``cancel`` is set before raising so
    abandoned workers that later complete a recv can observe it and must
    NOT mutate the caller's workspace (a reused recv buffer would be
    corrupted by a late write)."""
    if not fns:
        return
    if len(fns) == 1:
        fns[0]()
        return
    cond = threading.Condition()
    state = {"done": 0}
    errs: List[BaseException] = []

    def run(fn):
        err: Optional[BaseException] = None
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - propagated below
            err = e
        with cond:
            state["done"] += 1
            if err is not None:
                errs.append(err)
            cond.notify_all()

    from kungfu_tpu_torch.utils.pool import get_pool

    pool = get_pool()
    for fn in fns:
        pool.submit(lambda f=fn: run(f))
    with cond:
        if not cond.wait_for(lambda: state["done"] >= len(fns), timeout):
            if cancel is not None:
                cancel.set()
            raise TimeoutError("collective thread timed out")
        if errs:
            raise errs[0]

"""Runtime lock-order detector (``KF_DEBUG_LOCKS=1``).

Port of `kungfu_tpu/devtools/lockwatch.py`. Static lints see the locks a
``with`` statement *names*; this layer sees every lock the process
actually takes. When installed (from ``kungfu_tpu_torch/__init__`` under
the knob, before torch and every module of the port) it replaces
``threading.Lock``/``RLock`` with instrumented proxies that maintain:

- a per-thread stack of held locks;
- a process-wide acquisition graph keyed by lock *instance* (a real
  ABBA deadlock is between two specific lock objects; instances carry
  their creation site ``file.py:lineno`` for reporting, and findings
  dedupe at site level so a pool of per-peer locks reports once);
- per-acquisition hold timers.

Before an acquire blocks, the would-be edges ``held -> wanted`` are
added and the graph is searched for a cycle — an ABBA deadlock is
reported at the moment the second thread *tries* the reversed order,
not after the hang. On release, holds longer than
``KF_DEBUG_LOCKS_HELD_MS`` are reported. Reports flow through the
telemetry plane: ``lock_order_violation`` / ``lock_long_held`` audit
events (journaled by the flight recorder, surfaced by ``info
postmortem``) and ``kungfu_debug_lock_*`` metrics.

Known blind spots, stated:

- locks created BEFORE install (only module-level locks of modules
  imported before ``kungfu_tpu_torch``) are not wrapped;
- the edge graph grows with distinct nested lock *pairs* and is never
  pruned (debug mode; nodes only exist for locks that ever nest);
- long-held reporting covers locks CREATED in project code only —
  stdlib-internal locks (subprocess's waitpid lock, Condition
  internals) are order-tracked but not hold-timed, because their hold
  semantics are not ours to fix;
- ``threading.Condition``'s internal waiter locks come from the raw
  allocator and are deliberately invisible.

``KF_DEBUG_LOCKS`` unset means :func:`install` is never called and this
module is never imported — zero overhead.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

# graph mutex uses the REAL lock type: the detector must not watch
# itself
_graph_lock = _REAL_LOCK()
# lock seq -> {lock seq: (thread label, acquire site)} first-seen edges
_edges: Dict[int, Dict[int, Tuple[str, str]]] = {}
_sites: Dict[int, str] = {}  # lock seq -> creation site (reporting)
_reported_cycles: set = set()
_reported_held: set = set()
_tls = threading.local()
_seq_counter = itertools.count(1)

_installed = False
_VIOLATIONS = "kungfu_debug_lock_order_violations_total"
_LONG_HELD = "kungfu_debug_lock_long_held_total"
_SITES = "kungfu_debug_lock_sites"


_held_ms_cache: Optional[float] = None


def _held_ms() -> float:
    global _held_ms_cache
    if _held_ms_cache is None:
        from kungfu_tpu_torch import knobs

        _held_ms_cache = float(knobs.get("KF_DEBUG_LOCKS_HELD_MS"))
    return _held_ms_cache


def _caller_frame(depth: int):
    """First frame outside this module, or None."""
    f = sys._getframe(depth)
    while f is not None and f.f_globals.get("__name__") == __name__:
        f = f.f_back
    return f


def _caller_site(depth: int) -> str:
    """file.py:lineno of the first frame outside this module."""
    f = _caller_frame(depth + 1)
    if f is None:
        return "?"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _ours(path: str) -> bool:
    """Project code (kungfu_tpu_torch/, tests/, interactive snippets) vs
    stdlib/third-party. Long-held reporting is scoped to project-created
    locks: a Popen.wait() legitimately holds subprocess's waitpid lock
    for the child's whole lifetime, and flagging stdlib semantics we
    cannot change is noise. Ordering detection stays global — an ABBA
    cycle through a stdlib lock is still a deadlock."""
    return (
        "kungfu_tpu" in path
        or f"{os.sep}tests{os.sep}" in path
        or path.startswith("<")  # <stdin>, <string>: the REPL and inline scripts
    )


# tid -> that thread's held stack. threading.Lock legally supports
# acquire-on-A / release-on-B (handoff patterns in wrapped user code);
# the registry lets a cross-thread release find and clear the holder's
# entry instead of stranding it (a stale entry would emit false
# `held -> wanted` edges from A forever after). All stack MUTATIONS
# happen under _graph_lock so the cross-thread path cannot race the
# owner; reads of a thread's own stack stay lock-free (GIL-safe).
_stacks: Dict[int, List[Tuple[int, str, float]]] = {}


def _stack() -> List[Tuple[int, str, float]]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
        tid = threading.get_ident()
        with _graph_lock:
            alive = {t.ident for t in threading.enumerate()}
            for dead in [t for t in _stacks if t not in alive and t != tid]:
                del _stacks[dead]
            _stacks[tid] = s
    return s


def _reporting() -> bool:
    return getattr(_tls, "reporting", False)


# Reports are NEVER emitted from the detecting thread: that thread may
# hold arbitrary instrumented locks (a long-held report fires while the
# outer locks of a nest are still held), and log/audit/metrics take
# locks of their own — emitting inline would let the detector introduce
# the very deadlocks it hunts. Findings go through a raw-primitive queue
# (deque + real-lock Condition; a queue.Queue would allocate instrumented
# locks) to a daemon reporter thread that holds nothing.
_report_q: "list" = []
_report_cond = threading.Condition(_REAL_LOCK())
_reporter_started = False
_report_busy = False  # a batch is mid-emission (flush correctness)


def _report(kind: str, counter: str, **detail) -> None:
    detail.setdefault("thread", f"tid:{threading.get_ident()}")
    with _report_cond:
        _report_q.append((kind, counter, detail))
        _report_cond.notify()


def _emit(kind: str, counter: str, detail: dict) -> None:
    _tls.reporting = True
    try:
        from kungfu_tpu_torch.telemetry import audit, log, metrics

        log.warn("lockwatch %s: %s", kind,
                 " ".join(f"{k}={v}" for k, v in detail.items()))
        audit.record_event(kind, **detail)
        metrics.counter(
            counter,
            "Findings of the KF_DEBUG_LOCKS runtime lock detector",
        ).inc()
    except Exception as e:  # noqa: BLE001 - the detector must never kill training
        sys.stderr.write(f"lockwatch: report failed: {e}\n")
    finally:
        _tls.reporting = False


def _reporter_loop() -> None:
    global _report_busy
    while True:
        with _report_cond:
            # the daemon reporter parks on its work queue; a timeout
            # would only add wakeups, process exit reaps it
            _report_cond.wait_for(lambda: _report_q)
            batch, _report_q[:] = list(_report_q), []
            _report_busy = True
        for kind, counter, detail in batch:
            _emit(kind, counter, detail)
        with _report_cond:
            _report_busy = False
            _report_cond.notify_all()


def _ensure_reporter() -> None:
    global _reporter_started
    if not _reporter_started:
        threading.Thread(
            target=_reporter_loop, name="kf-lockwatch-report", daemon=True,
        ).start()
        _reporter_started = True


def flush(timeout: float = 5.0) -> bool:
    """Block until queued findings have been emitted (tests, atexit).
    True when the queue drained in time."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with _report_cond:
            if not _report_q and not _report_busy:
                return True
        time.sleep(0.01)
    return False


def _find_cycle(start: int, target: int) -> Optional[List[int]]:
    """Path target -> ... -> start in the edge graph (call with the
    would-be edge start->target already conceptually added); a hit means
    start->target closes a cycle."""
    seen = set()
    path: List[int] = []

    def dfs(node: int) -> bool:
        if node == start:
            path.append(node)
            return True
        if node in seen:
            return False
        seen.add(node)
        for nxt in _edges.get(node, ()):
            if dfs(nxt):
                path.append(node)
                return True
        return False

    return list(reversed(path)) if dfs(target) else None


class _DebugLockBase:
    """Proxy around a real lock; subclasses pick the inner type."""

    _reentrant = False

    def __init__(self):
        self._inner = self._make_inner()
        f = _caller_frame(2)
        path = f.f_code.co_filename if f is not None else "?"
        self.site = (
            f"{os.path.basename(path)}:{f.f_lineno}" if f is not None else "?"
        )
        self._held_watch = _ours(path)
        self._seq = next(_seq_counter)

    def _make_inner(self):
        raise NotImplementedError

    # -- instrumentation

    def _before_acquire(self) -> None:
        stack = _stack()
        if any(seq == self._seq for seq, _, _ in stack):
            return  # reentrant re-acquire: no new ordering information
        acquire_site = _caller_site(3)
        # NOT current_thread(): during thread bootstrap that mints a
        # _DummyThread whose Event would recurse into this very path
        me = f"tid:{threading.get_ident()}"
        cycle_msg = None
        with _graph_lock:
            _sites.setdefault(self._seq, self.site)
            for held_seq, held_site, _ in stack:
                _sites.setdefault(held_seq, held_site)
                first = _edges.setdefault(held_seq, {})
                if self._seq not in first:
                    first[self._seq] = (me, acquire_site)
                cycle = _find_cycle(held_seq, self._seq)
                if cycle is not None:
                    names = [
                        f"{_sites.get(s, '?')}#{s}" for s in cycle
                    ]
                    # dedupe at SITE level so a pool of per-peer locks
                    # reports its ordering bug once, not once per pair
                    sig = "->".join(sorted({_sites.get(s, "?")
                                            for s in cycle}))
                    if sig not in _reported_cycles:
                        _reported_cycles.add(sig)
                        other = _edges.get(self._seq, {}).get(held_seq)
                        cycle_msg = {
                            "cycle": "->".join(names + [names[0]]),
                            "acquirer": me,
                            "at": acquire_site,
                            "holding": held_site,
                            "wants": self.site,
                            "reverse_seen": (
                                f"{other[0]} at {other[1]}" if other else "?"
                            ),
                        }
        if cycle_msg is not None:
            _report("lock_order_violation", _VIOLATIONS, **cycle_msg)

    def _on_acquired(self) -> None:
        stack = _stack()
        with _graph_lock:
            stack.append((self._seq, self.site, time.monotonic()))

    def _on_release(self) -> None:
        stack = _stack()
        popped = None
        with _graph_lock:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == self._seq:
                    popped = stack.pop(i)
                    break
            else:
                # released on a different thread than acquired it:
                # clear the holder's entry or it emits false ordering
                # edges forever after (hold timing still meaningful —
                # the entry carries its acquire timestamp). Match the
                # OLDEST entry for this lock: the real release ran
                # before this bookkeeping, so a racing re-acquire may
                # already have pushed a fresh entry on the new holder's
                # stack — the handoff's stale entry is strictly older
                oldest = None  # (t0, stack, index)
                for other in _stacks.values():
                    for i in range(len(other) - 1, -1, -1):
                        if other[i][0] == self._seq and (
                            oldest is None or other[i][2] < oldest[0]
                        ):
                            oldest = (other[i][2], other, i)
                if oldest is not None:
                    popped = oldest[1].pop(oldest[2])
        if popped is None:
            return
        _, site, t0 = popped
        held = (time.monotonic() - t0) * 1e3
        if self._held_watch and held >= _held_ms():
            # counterless dedup by site: one audit event per
            # site per process, or a pathological lock floods
            # the (bounded) audit ring every release
            if site not in _reported_held:
                _reported_held.add(site)
                _report(
                    "lock_long_held", _LONG_HELD,
                    lock=site, held_ms=round(held, 1),
                    released_at=_caller_site(2),
                )

    # -- lock API

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _reporting():
            return self._inner.acquire(blocking, timeout)
        if blocking:
            self._before_acquire()
        got = self._inner.acquire(blocking, timeout)
        if got and not _reporting():
            self._on_acquired()
        return got

    def release(self) -> None:
        # real release FIRST: bookkeeping only queues onto the reporter,
        # but keeping zero work between caller and unlock is free safety
        self._inner.release()
        if not _reporting():
            self._on_release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, name):
        # Condition needs _is_owned/_release_save/_acquire_restore on
        # RLocks; forward anything we don't instrument
        return getattr(self._inner, name)

    def __repr__(self) -> str:
        return f"<lockwatch {type(self).__name__} {self.site} {self._inner!r}>"


class _DebugLock(_DebugLockBase):
    def _make_inner(self):
        return _REAL_LOCK()


class _DebugRLock(_DebugLockBase):
    _reentrant = True

    def _make_inner(self):
        return _REAL_RLOCK()

    # Condition prefers these over release()/acquire() on RLocks; without
    # explicit wrappers __getattr__ would hand back the INNER methods and
    # a cond.wait() would leave a stale held-entry ticking toward a false
    # long-held report
    def _release_save(self):
        state = self._inner._release_save()
        if not _reporting():
            self._on_release()
        return state

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        if not _reporting():
            self._on_acquired()

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def install() -> bool:
    """Swap threading.Lock/RLock for the instrumented proxies.
    Idempotent; returns True when (already) installed."""
    global _installed
    if _installed:
        return True
    _ensure_reporter()
    threading.Lock = _DebugLock
    threading.RLock = _DebugRLock
    import atexit

    atexit.register(flush, 2.0)  # don't lose findings queued at exit
    _installed = True
    return True


def uninstall() -> None:
    """Restore the real factories and drop detector state (tests).
    Locks created while installed keep working — they proxy real
    primitives."""
    global _installed, _held_ms_cache
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    _held_ms_cache = None
    with _graph_lock:
        _edges.clear()
        _sites.clear()
        _reported_cycles.clear()
        _reported_held.clear()
        for s in _stacks.values():
            del s[:]  # live threads keep their registered list object
    _installed = False


def installed() -> bool:
    return _installed


def edge_count() -> int:
    with _graph_lock:
        return sum(len(v) for v in _edges.values())


def publish_gauges() -> None:
    """Export detector state gauges (called from tests/benches; cheap)."""
    from kungfu_tpu_torch.telemetry import metrics

    with _graph_lock:
        sites = len({_sites.get(s, s) for s in _edges})
    metrics.gauge(
        _SITES, "Lock creation sites in the lockwatch acquisition graph"
    ).set(sites)

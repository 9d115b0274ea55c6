"""Scoped tracer: named spans and recorded durations in a bounded ring.

Port of `kungfu_tpu/utils/trace.py`, the names every host-plane module
calls (`span`, `record`, `summary_ms`), over a ring of its own: the reference's
re-exports its telemetry tracer, whose Chrome-trace export and flight
recorder are telemetry work (ROADMAP item 1e). Recording is always on:
a span is two `perf_counter` reads and a deque append.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

MAX_EVENTS = 4096


class TraceEvent(NamedTuple):
    name: str
    start: float  # perf_counter seconds
    duration: float  # seconds
    args: Optional[dict]


_lock = threading.Lock()
_events: "deque[TraceEvent]" = deque(maxlen=MAX_EVENTS)


class _Span:
    """Context manager recording one event on exit; `args` may be
    annotated inside the body (the ring walk adds its wait and send)."""

    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        with _lock:
            _events.append(TraceEvent(self.name, self._t0, t1 - self._t0, self.args or None))
        return False


def span(name: str, **args) -> _Span:
    return _Span(name, args)


def record(name: str, duration_s: float, **args) -> None:
    """Record a duration measured elsewhere, ending now."""
    now = time.perf_counter()
    with _lock:
        _events.append(TraceEvent(name, now - duration_s, duration_s, args or None))


def events(prefix: str = "") -> List[Tuple[str, float, float]]:
    """(name, start, duration) of the recorded events named `prefix*`."""
    with _lock:
        return [(e.name, e.start, e.duration) for e in _events if e.name.startswith(prefix)]


def summary_ms(prefix: str = "") -> Dict[str, float]:
    """Total duration per span name (ms) of the events named `prefix*`,
    each total rounded to 0.1 ms."""
    out: Dict[str, float] = {}
    for name, _, duration in events(prefix):
        out[name] = out.get(name, 0.0) + duration * 1e3
    return {k: round(v, 1) for k, v in out.items()}


def clear() -> None:
    with _lock:
        _events.clear()


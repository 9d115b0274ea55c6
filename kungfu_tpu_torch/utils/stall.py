"""Stall detector: liveness watchdog around blocking operations.

Port of `kungfu_tpu/utils/stall.py` (parity:
srcs/go/utils/stalldetector.go:15-46) — any guarded
operation that runs longer than the period logs "X stalled for Ns"
repeatedly until it completes; enabled by KF_CONFIG_ENABLE_STALL_DETECTION
around collective calls and resize paths (libkungfu-comm/main.go:179-190).
"""

from __future__ import annotations

import contextlib
import threading
import time

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.telemetry import log as _log

DEFAULT_PERIOD = 3.0


def enabled() -> bool:
    return bool(knobs.get("KF_CONFIG_ENABLE_STALL_DETECTION"))


@contextlib.contextmanager
def stall_detect(name: str, period: float = DEFAULT_PERIOD, force: bool = False):
    """Context manager: while the body runs, log every `period` seconds."""
    if not (force or enabled()):
        yield
        return
    done = threading.Event()
    t0 = time.monotonic()

    def watch():
        n = 0
        while not done.wait(period):
            n += 1
            elapsed = time.monotonic() - t0
            _log.warn("%s stalled for %.1fs", name, elapsed)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        yield
    finally:
        done.set()

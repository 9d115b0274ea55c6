"""Structured, rank-prefixed leveled logger — the host plane's one
logging surface.

Port of `kungfu_tpu/telemetry/log.py` (parity: srcs/go/log/logger.go:
DEBUG/INFO/WARN/ERROR, level from the environment, optional
redirection), with structured key=value fields:

    log.info("resize landed", old=4, new=3)
    # 12:00:01 [I] kungfu[0/4] resize landed old=4 new=3

Level comes from ``KF_LOG_LEVEL`` (falling back to the reference's
``KF_CONFIG_LOG_LEVEL``), read through the port's own knobs. The
per-worker prefix comes from ``KF_LOG_PREFIX`` (set by the runner) or,
under a bare worker, from ``KF_SELF_SPEC``. ``echo()`` is the CLI escape
hatch: raw, unleveled stdout output for user-facing surfaces that must
never be filtered by the log level.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import List, Optional, TextIO

from kungfu_tpu_torch import knobs

LEVELS = {"DEBUG": 10, "INFO": 20, "WARN": 30, "WARNING": 30, "ERROR": 40, "OFF": 100}
_COLORS = [31, 32, 33, 34, 35, 36]  # red..cyan, cycled by rank

_lock = threading.Lock()
_state = {"level": None, "out": None, "prefix": None}

# bounded tail of emitted lines, independent of where `out` points: the
# flight recorder journals it so a crashed worker's last words survive
# even when its stderr pipe died with the runner
TAIL_LINES = 200
_tail: "deque[str]" = deque(maxlen=TAIL_LINES)


def _level() -> int:
    if _state["level"] is None:
        name = (
            knobs.raw("KF_LOG_LEVEL") or knobs.raw("KF_CONFIG_LOG_LEVEL")
        ).upper()
        _state["level"] = LEVELS.get(name, 20)
    return _state["level"]


def set_level(name: str) -> None:
    with _lock:
        _state["level"] = LEVELS.get(name.upper(), 20)


def set_output(f: Optional[TextIO]) -> None:
    """Redirect log output (parity: logger.go output redirection)."""
    with _lock:
        _state["out"] = f


def reset() -> None:
    """Re-read level/prefix from the environment (tests)."""
    with _lock:
        _state["level"] = None
        _state["prefix"] = None


def _prefix() -> str:
    if _state["prefix"] is None:
        p = knobs.raw("KF_LOG_PREFIX") or knobs.raw("KF_SELF_SPEC")
        if p and sys.stderr.isatty():
            try:
                rank = int(p.split("/")[0])
                p = f"\x1b[{_COLORS[rank % len(_COLORS)]}m[{p}]\x1b[0m"
            except ValueError:
                p = f"[{p}]"
        elif p:
            p = f"[{p}]"
        _state["prefix"] = p
    return _state["prefix"]


def _emit(level_name: str, level: int, msg: str, args: tuple, fields: dict) -> None:
    if level < _level():
        return
    out = _state["out"] or sys.stderr
    if args:
        msg = msg % args
    if fields:
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        msg = f"{msg} {kv}" if msg else kv
    ts = time.strftime("%H:%M:%S")
    pre = _prefix()
    with _lock:
        _tail.append(f"{ts} [{level_name[0]}] {msg}")
        try:
            out.write(f"{ts} [{level_name[0]}] kungfu{pre} {msg}\n")
            out.flush()
        except (ValueError, OSError):
            pass  # closed stream at interpreter teardown


def tail(n: Optional[int] = None) -> List[str]:
    """The most recent emitted log lines (level-filtered, un-colored)."""
    with _lock:
        lines = list(_tail)
    return lines if n is None else lines[-n:]


def clear_tail() -> None:
    with _lock:
        _tail.clear()


def debug(msg: str, *args, **fields) -> None:
    _emit("DEBUG", 10, msg, args, fields)


def info(msg: str, *args, **fields) -> None:
    _emit("INFO", 20, msg, args, fields)


def warn(msg: str, *args, **fields) -> None:
    _emit("WARN", 30, msg, args, fields)


warning = warn


def error(msg: str, *args, **fields) -> None:
    _emit("ERROR", 40, msg, args, fields)


def echo(msg: str = "", *, err: bool = False) -> None:
    """Raw CLI-facing output (results, banners): bypasses levels and
    prefixes, never filtered. The lint-compliant replacement for print()
    in CLI surfaces outside runner/cli.py and info/."""
    out = sys.stderr if err else sys.stdout
    try:
        out.write(str(msg) + "\n")
        out.flush()
    except (ValueError, OSError):
        pass

"""Warm-spare workers: pre-spawned processes that pay the interpreter +
torch import cost BEFORE a resize needs them.

Port of `kungfu_tpu/runner/standby.py`, with the same FIFO protocol. The
dominant term of elastic-join latency is joiner startup (python + torch
import is seconds of CPU on a busy host); the reference hides the
equivalent cost behind its always-resident Go runner. Here the elastic
watcher keeps N standby processes alive; activating one costs a FIFO
write instead of a cold exec.

A standby imports torch and the port but never touches the card: nothing
the port runs at import calls into CUDA, so the activated worker creates
its CUDA context only after its environment (``KF_DEVICE_SLOTS``) is set.

Protocol:
- the watcher spawns ``python -m kungfu_tpu_torch.runner.standby`` with
  ``KF_STANDBY_FIFO=<path>`` (and optional ``KF_STANDBY_PRELOAD`` — extra
  comma-separated modules to import while waiting);
- the standby opens the FIFO for reading IMMEDIATELY (so activation can be
  written at any point, even mid-warmup), warms its imports, then blocks
  on the FIFO;
- activation is one JSON line ``{"env": {...}, "argv": [...]}``: the
  standby applies the env, sets sys.argv and runs the worker command
  in-process (runpy) when it is a python invocation, exec()-ing otherwise.
"""

from __future__ import annotations

import errno
import json
import os
import sys
import time
from typing import List, Optional


def _is_python(arg: str) -> bool:
    base = os.path.basename(arg)
    return base.startswith("python") or arg == sys.executable


def run_activated(spec: dict) -> None:
    """Apply an activation spec and run the worker command in-process."""
    import runpy

    os.environ.update(spec.get("env", {}))
    argv: List[str] = list(spec["argv"])
    if argv and _is_python(argv[0]):
        argv = argv[1:]
    if argv and argv[0] == "-u":
        argv = argv[1:]
    if len(argv) >= 2 and argv[0] == "-m":
        sys.argv = argv[1:]
        runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
        return
    if len(argv) >= 2 and argv[0] == "-c":
        sys.argv = ["-c"] + argv[2:]
        exec(compile(argv[1], "<kf-standby>", "exec"), {"__name__": "__main__"})
        return
    if argv and argv[0].endswith(".py"):
        sys.argv = argv
        runpy.run_path(argv[0], run_name="__main__")
        return
    # not a python command: fall back to exec (warmth is lost, behavior
    # is preserved)
    os.execvpe(argv[0], argv, dict(os.environ))


class StandbySlot:
    """Watcher-side handle to one standby process."""

    def __init__(self, proc, fifo: str):
        self.proc = proc
        self.fifo = fifo

    @property
    def alive(self) -> bool:
        return self.proc.running

    def activate(
        self, env: dict, argv: List[str], name: str, rank: int,
        wait: float = 2.0,
    ) -> bool:
        """Hand the standby its worker identity; False if it died (caller
        falls back to a cold spawn). A just-spawned standby may not have
        opened its FIFO yet (python exec in flight) — retry for up to
        `wait` seconds while the process is alive, since even a not-yet-
        warm standby beats a cold spawn."""
        deadline = time.time() + wait
        while True:
            try:
                fd = os.open(self.fifo, os.O_WRONLY | os.O_NONBLOCK)
                break
            except OSError as e:
                if e.errno not in (errno.ENXIO, errno.ENOENT):
                    raise
                if not self.alive:
                    self._unlink_fifo()
                    return False
                if time.time() >= deadline:
                    # the standby is alive but slow (python startup under
                    # load): do NOT unlink — it has yet to open this path,
                    # and removing it would crash a healthy standby. The
                    # pool tempdir sweep owns cleanup for this case.
                    return False
                time.sleep(0.05)
        try:
            env = dict(env)
            # activation instant (CLOCK_MONOTONIC is machine-wide, so the
            # activated process can compute its own wakeup latency)
            env["KF_ACTIVATED_TS"] = str(time.monotonic())
            spec = json.dumps({"env": env, "argv": list(argv)}) + "\n"
            os.write(fd, spec.encode())
        except OSError:
            return False
        finally:
            os.close(fd)
            # single-shot: nothing opens this path again (the standby
            # holds its read fd), so the file can go now
            self._unlink_fifo()
        self.proc.name = name
        self.proc.rank = rank
        return True

    def _unlink_fifo(self) -> None:
        try:
            os.unlink(self.fifo)
        except OSError:
            pass


AUTO_PRELOAD = "torch,kungfu_tpu_torch.api"


def resolve_preload(spec: str) -> str:
    """Map the -standby-preload spellings to a concrete module list:
    'auto' -> the port's device stack (torch and the host-plane api;
    import only, no CUDA context), 'none'/'' -> nothing."""
    if spec == "auto":
        return AUTO_PRELOAD
    if spec == "none":
        return ""
    return spec


class StandbyPool:
    """Keeps up to `n` warm standbys; `take()` pops one for activation and
    the caller refills asynchronously via `refill()` (Popen returns fast;
    the replacement warms while training continues)."""

    def __init__(self, n: int, logdir: str = "", quiet: bool = False,
                 preload: str = ""):
        import tempfile

        from kungfu_tpu_torch.runner.proc import WorkerProc

        self._WorkerProc = WorkerProc
        self.n = n
        self.logdir = logdir
        self.quiet = quiet
        self.preload = preload
        self._dir = tempfile.mkdtemp(prefix="kf-standby-")
        self._seq = 0
        self.slots: List[StandbySlot] = []

    def refill(self) -> None:
        live = []
        for s in self.slots:
            if s.alive:
                live.append(s)
            else:
                s._unlink_fifo()
        self.slots = live
        while len(self.slots) < self.n:
            fifo = os.path.join(self._dir, f"standby-{self._seq}.fifo")
            os.mkfifo(fifo)
            env = {"KF_STANDBY_FIFO": fifo}
            if self.preload:
                env["KF_STANDBY_PRELOAD"] = self.preload
            p = self._WorkerProc(
                name=f"standby-{self._seq}",
                argv=[sys.executable, "-m", "kungfu_tpu_torch.runner.standby"],
                env=env,
                rank=self._seq,
                logdir=self.logdir or None,
                quiet=self.quiet,
            )
            p.start()
            self.slots.append(StandbySlot(p, fifo))
            self._seq += 1

    def take(self) -> Optional[StandbySlot]:
        while self.slots:
            s = self.slots.pop(0)
            if s.alive:
                return s
            s._unlink_fifo()
        return None

    def kill_all(self) -> None:
        import shutil

        for s in self.slots:
            s.proc.kill()
        self.slots = []
        shutil.rmtree(self._dir, ignore_errors=True)


def _die_with_parent() -> None:
    """Arm PR_SET_PDEATHSIG in-process (safe: we are past exec, single-
    threaded). Belt-and-braces with the kf-pdeathsig exec shim — this
    covers a standby started by hand, without the shim."""
    try:
        import ctypes
        import signal as _signal

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, _signal.SIGTERM, 0, 0, 0)  # 1 = PR_SET_PDEATHSIG
        # died-before-arm check against the EXPLICIT runner pid (a
        # getppid()==1 heuristic misfires when the runner IS pid 1,
        # e.g. a container entrypoint)
        from kungfu_tpu_torch import knobs

        runner_pid = int(knobs.get("KF_RUNNER_PID"))
        if runner_pid > 0 and os.getppid() != runner_pid:
            sys.exit(0)  # runner died before the arm
    except Exception as e:  # noqa: BLE001 - non-Linux: best-effort only
        from kungfu_tpu_torch.telemetry import log

        log.debug("kf-standby: pdeathsig arm skipped: %s", e)


def main() -> None:
    _die_with_parent()
    from kungfu_tpu_torch import knobs

    fifo = knobs.raw("KF_STANDBY_FIFO")
    if not fifo:
        from kungfu_tpu_torch.telemetry import log

        log.error("kf-standby: KF_STANDBY_FIFO not set")
        sys.exit(2)
    # open for reading BEFORE warming so the watcher's nonblocking
    # open-for-write succeeds from the moment we exist
    try:
        fd = os.open(fifo, os.O_RDONLY | os.O_NONBLOCK)
    except FileNotFoundError:
        # the pool already swept this slot (watcher teardown raced us)
        from kungfu_tpu_torch.telemetry import log

        log.warn("kf-standby: fifo gone before open; exiting")
        sys.exit(0)
    # warm imports: the bulk of cold-join latency
    import numpy  # noqa: F401

    import kungfu_tpu_torch.api  # noqa: F401
    from kungfu_tpu_torch.telemetry import log as _log

    # "auto"/"none" are resolved by the POOL (resolve_preload); an unset
    # or empty env means no extra preloads — "" must stay a working
    # disable spelling for direct StandbyPool users
    for mod in knobs.get("KF_STANDBY_PRELOAD"):
        try:
            __import__(mod)
        except ImportError as e:
            _log.warn("kf-standby: preload %s failed: %s", mod, e)
    _log.echo("kf-standby: warm")
    # block until the activation line arrives
    import select

    buf = b""
    while b"\n" not in buf:
        select.select([fd], [], [])
        chunk = os.read(fd, 65536)
        if chunk:
            buf += chunk
        else:
            # writer not connected yet (or closed without data): avoid a
            # busy loop
            time.sleep(0.05)
    os.close(fd)
    spec = json.loads(buf.split(b"\n", 1)[0].decode())
    run_activated(spec)


if __name__ == "__main__":
    main()

"""Worker process spawning and log streaming.

Port of `kungfu_tpu/runner/proc.py` (parity: srcs/go/proc/proc.go +
srcs/go/utils/runner/local: parallel local exec with colored per-proc log
prefixes and per-worker log files).

Orphan protection: children get SIGTERM when the runner dies
(PR_SET_PDEATHSIG), so a hard-killed runner (SIGKILL, OOM) cannot leave
workers or warm standbys lingering. The arming must NOT happen in a
`preexec_fn`: calling into ctypes between fork and exec in a threaded
runner deadlocks intermittently on locks held by threads that do not
exist in the child. Instead every worker is exec'd through a tiny shim
(`csrc/host/pdeathsig.c`) that arms the signal in a fresh single-threaded
process and execvp's the real command. The shim is built at first use by
the host compiler (`ops/_build.py::compile_pdeathsig`); a failed build
raises RuntimeError, and no worker starts unprotected.
"""

from __future__ import annotations

import collections
import os
import subprocess
import sys
import threading
from typing import Dict, List, Optional

from kungfu_tpu_torch.telemetry import log

# last-words ring per worker, kept for the runner's failure reports
OUTPUT_TAIL_LINES = 200

_COLORS = [31, 32, 33, 34, 35, 36, 91, 92, 93, 94, 95, 96]

_shim: Optional[str] = None
_shim_lock = threading.Lock()


def _shim_argv(argv: List[str]) -> List[str]:
    """`argv` behind the kf-pdeathsig shim, built on the first call."""
    global _shim
    with _shim_lock:
        if _shim is None:
            from kungfu_tpu_torch.ops import _build

            _shim = str(_build.compile_pdeathsig())
    return [_shim] + list(argv)


def _color(i: int, s: str) -> str:
    if not sys.stdout.isatty():
        return s
    return f"\x1b[{_COLORS[i % len(_COLORS)]}m{s}\x1b[0m"


class WorkerProc:
    def __init__(
        self,
        name: str,
        argv: List[str],
        env: Dict[str, str],
        rank: int = 0,
        logdir: Optional[str] = None,
        quiet: bool = False,
        cpus: Optional[List[int]] = None,
    ):
        self.name = name
        self.argv = argv
        self.env = env
        self.rank = rank
        self.logdir = logdir
        self.quiet = quiet
        self.cpus = cpus  # CPU affinity mask (runner/affinity.py plan)
        self.proc: Optional[subprocess.Popen] = None
        self._threads: List[threading.Thread] = []
        self._tail: "collections.deque[str]" = collections.deque(maxlen=OUTPUT_TAIL_LINES)
        self._tail_lock = threading.Lock()

    def start(self) -> None:
        full_env = dict(os.environ)
        full_env.update(self.env)
        # explicit runner pid for the shim's and the standby's
        # died-before-arm check
        full_env["KF_RUNNER_PID"] = str(os.getpid())
        self.proc = subprocess.Popen(
            _shim_argv(self.argv),
            env=full_env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            bufsize=1,
        )
        if self.cpus:
            from kungfu_tpu_torch.runner.affinity import apply_affinity

            if apply_affinity(self.proc.pid, self.cpus) and not self.quiet:
                log.info("[%s] pinned to cpus %s", self.name, self.cpus)
        logfile = None
        if self.logdir:
            os.makedirs(self.logdir, exist_ok=True)
            logfile = open(os.path.join(self.logdir, f"{self.name.replace('/', '_')}.log"), "w")
        for stream, tag in ((self.proc.stdout, ""), (self.proc.stderr, "!")):
            t = threading.Thread(target=self._pump, args=(stream, tag, logfile), daemon=True)
            t.start()
            self._threads.append(t)

    def _pump(self, stream, tag: str, logfile) -> None:
        for line in stream:
            # prefix computed per line: a standby proc is renamed to its
            # worker identity on activation
            prefix = _color(self.rank, f"[{self.name}{tag}] ")
            with self._tail_lock:
                self._tail.append(f"[{tag or ' '}] {line.rstrip()}")
            if logfile:
                logfile.write(f"[{tag or ' '}] {line}")
                logfile.flush()
            if not self.quiet:
                sys.stdout.write(prefix + line)
                sys.stdout.flush()

    def output_tail(self) -> List[str]:
        """The worker's last ~200 stdout/stderr lines ('[ ]'/'[!]'
        prefixed), for failure reports."""
        with self._tail_lock:
            return list(self._tail)

    def wait(self, timeout: Optional[float] = None) -> int:
        rc = self.proc.wait(timeout)
        for t in self._threads:
            t.join(1)
        return rc

    def kill(self) -> None:
        if self.proc and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                try:
                    # reap, so returncode reads -SIGKILL instead of None
                    self.proc.wait(5)
                except subprocess.TimeoutExpired:
                    pass

    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


def run_all(procs: List[WorkerProc]) -> List[int]:
    """Start all procs and wait; on first failure kill the rest (parity:
    local.RunAll semantics)."""
    for p in procs:
        p.start()
    codes = [None] * len(procs)
    try:
        for i, p in enumerate(procs):
            # kfcheck: disable=KF301 — a training worker legitimately
            # runs unboundedly; KeyboardInterrupt kills the batch below
            codes[i] = p.wait()
    except KeyboardInterrupt:
        for p in procs:
            p.kill()
        raise
    if any(c != 0 for c in codes):
        for p in procs:
            p.kill()
    return [c if c is not None else -1 for c in codes]

"""kf-distribute: one-command multi-host launch over SSH.

Port of `kungfu_tpu/runner/distribute.py`. Capability parity:
srcs/go/cmd/kungfu-distribute/kungfu-distribute.go +
srcs/go/utils/ssh/ssh.go (and kungfu-rrun) — start a command on every host
of a hostfile from one terminal, stream back per-host prefixed logs,
propagate exit codes, and tear everything down on Ctrl-C.

The command may contain ``{host}`` / ``{index}`` placeholders substituted
per host — the usual pattern launches one kfrun per machine:

    python -m kungfu_tpu_torch.runner.distribute -H 10.0.0.1:4,10.0.0.2:4 -- \
        python -m kungfu_tpu_torch.runner.cli -np 8 -H 10.0.0.1:4,10.0.0.2:4 \
        -self {host} python train.py

``-ssh`` overrides the transport program (default ``ssh`` with batch-mode
options); tests substitute a local shim, the reference's approach to
exercising the fan-out without a real fleet.
"""

from __future__ import annotations

import argparse
import shlex
import signal
import subprocess
import sys
import threading
from typing import List, Optional

from kungfu_tpu_torch.plan.hostspec import HostList, parse_hostfile
from kungfu_tpu_torch.telemetry import log

DEFAULT_SSH = "ssh -o StrictHostKeyChecking=no -o BatchMode=yes"

_COLORS = [31, 32, 33, 34, 35, 36, 91, 92, 93, 94, 95, 96]


def _color(i: int, s: str) -> str:
    if not sys.stdout.isatty():
        return s
    return f"\x1b[{_COLORS[i % len(_COLORS)]}m{s}\x1b[0m"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "kf-distribute", description="run a command on every host over SSH",
        allow_abbrev=False,
    )
    p.add_argument("-H", dest="hosts", default="", help="host list ip:slots,...")
    p.add_argument("-hostfile", default="", help="hostfile path")
    p.add_argument("-ssh", default=DEFAULT_SSH,
                   help="transport program prefix (argv prefix before host)")
    p.add_argument("-timeout", type=float, default=0.0,
                   help="kill the fan-out after this many seconds")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("cmd", nargs=argparse.REMAINDER, help="command template")
    return p


class HostProc:
    """One ssh child streaming prefixed logs (parity: iostream coloring in
    utils/runner/remote)."""

    def __init__(self, index: int, host: str, argv: List[str], quiet: bool):
        self.index = index
        self.host = host
        self.argv = argv
        self.quiet = quiet
        self.proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        self.proc = subprocess.Popen(
            self.argv,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            stdin=subprocess.DEVNULL,
            text=True,
            bufsize=1,
        )
        for stream, tag in ((self.proc.stdout, ""), (self.proc.stderr, "!")):
            threading.Thread(
                target=self._pump, args=(stream, tag), daemon=True
            ).start()

    def _pump(self, stream, tag: str) -> None:
        prefix = _color(self.index, f"[{self.host}{tag}] ")
        for line in stream:
            if not self.quiet:
                sys.stdout.write(prefix + line)
                sys.stdout.flush()

    def wait(self, timeout: Optional[float] = None) -> int:
        return self.proc.wait(timeout)

    def kill(self) -> None:
        if self.proc and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(5)
            except subprocess.TimeoutExpired:
                self.proc.kill()


def host_argv(ssh: str, host: str, index: int, cmd: List[str]) -> List[str]:
    """ssh argv for one host: transport prefix + host + quoted command with
    {host}/{index} substituted."""
    filled = [
        c.replace("{host}", host).replace("{index}", str(index)) for c in cmd
    ]
    return shlex.split(ssh) + [host, " ".join(shlex.quote(c) for c in filled)]


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        log.error("kf-distribute: no command given")
        return 2
    try:
        if args.hostfile:
            with open(args.hostfile) as f:
                hosts = parse_hostfile(f.read())
        elif args.hosts:
            hosts = HostList.parse(args.hosts)
        else:
            raise ValueError("one of -H / -hostfile is required")
    except (ValueError, OSError) as e:
        log.error("kf-distribute: %s", e)
        return 2

    procs = [
        HostProc(i, h.host, host_argv(args.ssh, h.host, i, cmd), args.quiet)
        for i, h in enumerate(hosts)
    ]

    stop = threading.Event()

    def teardown(sig=None, frame=None):
        if not stop.is_set():
            stop.set()
            live = [p for p in procs if p.proc and p.proc.poll() is None]
            if live:
                log.warn("kf-distribute: tearing down %d hosts", len(live))
            for p in live:
                p.kill()

    old_int = signal.signal(signal.SIGINT, teardown)
    old_term = signal.signal(signal.SIGTERM, teardown)
    if args.timeout:
        signal.signal(signal.SIGALRM, teardown)
        # setitimer keeps sub-second precision; int() would turn a
        # timeout < 1s into alarm(0), silently disabling it
        signal.setitimer(signal.ITIMER_REAL, float(args.timeout))
    try:
        for p in procs:
            p.start()
        codes = []
        for p in procs:
            try:
                # waiting for the remote worker to finish is the job;
                # SIGTERM/SIGALRM teardown() and KeyboardInterrupt bound it
                codes.append(p.wait())
            except KeyboardInterrupt:
                teardown()
                return 130
        bad = [(p.host, c) for p, c in zip(procs, codes) if c != 0]
        if bad:
            log.error("kf-distribute: failed on %s", bad)
            return 1
        return 0
    finally:
        teardown()
        signal.signal(signal.SIGINT, old_int)
        signal.signal(signal.SIGTERM, old_term)


if __name__ == "__main__":
    sys.exit(main())

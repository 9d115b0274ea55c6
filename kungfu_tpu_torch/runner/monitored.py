"""Failure detection + auto-recovery (checkpoint-restart).

Port of `kungfu_tpu/runner/monitored.py`: the same heartbeat bodies,
routes and environment, so either package's workers report to either's
runner. Capability parity: srcs/go/kungfu/runner/monitorserver/monitor.go:17-198 +
monitored.go:18-75 — a per-host HTTP monitor receives worker heartbeats
(``begin:<rank>`` / ``end:<rank>`` / ``epoch:<rank>`` / ``trainend:<rank>``);
a worker that stays inside a batch longer than the grace period is declared
stuck, all workers are killed and relaunched with ``--restart 1`` appended
so the training script reloads its checkpoint and continues from the last
completed epoch.

Cross-host protocol (parity: monitor.go:103-140): when any host's monitor
detects a LOCAL stuck worker it broadcasts ``otherdown:<minEpoch>`` to
every other runner's monitor, so hosts whose own workers look merely idle
(blocked in a collective without an outstanding batch) restart in lockstep
instead of waiting out their own grace period. The reference only lets the
MAIN (first) host broadcast; here any detecting host does — a hang on a
non-main host still converges, just via the main host's own detection, but
broadcasting from the detector is strictly faster.

Worker contract:
- KF_MONITOR_ADDR (set by the runner): where send_heartbeat POSTs.
- On relaunch the runner appends ``--restart 1`` (once) to the command and
  sets KF_RECOVER_EPOCH=<min completed epoch> so scripts without their own
  checkpoint bookkeeping know where to resume (the reference edits the
  script's --n-epochs flag instead; an env var doesn't assume a flag
  naming convention).
"""

from __future__ import annotations

import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from kungfu_tpu_torch.telemetry import log

MONITOR_PORT = 7756
DEFAULT_GRACE = 10.0
MONITOR_ADDR_ENV = "KF_MONITOR_ADDR"
RECOVER_EPOCH_ENV = "KF_RECOVER_EPOCH"


class HeartbeatState:
    def __init__(self):
        self._lock = threading.Lock()
        self.in_batch: Dict[int, float] = {}  # rank -> batch begin time
        self.epochs: Dict[int, int] = {}  # per-incarnation completed epochs
        self.base_epoch = 0  # cluster-wide min at the start of this incarnation
        self.train_ended: Dict[int, bool] = {}
        self.other_down: Optional[int] = None  # min epoch from a remote host
        self.other_finish = False

    def signal(self, kind: str, rank: int) -> None:
        now = time.monotonic()
        with self._lock:
            if kind == "begin":
                self.in_batch[rank] = now
            elif kind == "end":
                self.in_batch.pop(rank, None)
            elif kind == "epoch":
                self.epochs[rank] = self.epochs.get(rank, 0) + 1
            elif kind == "trainend":
                self.train_ended[rank] = True
                self.in_batch.pop(rank, None)
            elif kind == "otherdown":
                self.other_down = rank  # value is the min epoch, not a rank
            elif kind == "otherfinish":
                self.other_finish = True

    def stuck_ranks(self, grace: float):
        now = time.monotonic()
        with self._lock:
            return [r for r, t0 in self.in_batch.items() if now - t0 > grace]

    def min_epoch(self, n_expected: int = 0) -> int:
        """Safe resume epoch: base + the min epochs completed THIS
        incarnation. A rank that hasn't signalled yet contributes 0 — its
        checkpoint may predate everyone else's — so when n_expected is
        given and some rank is silent, the increment is 0."""
        with self._lock:
            if not self.epochs or (n_expected and len(self.epochs) < n_expected):
                return self.base_epoch
            return self.base_epoch + min(self.epochs.values())

    def all_done(self, n: int) -> bool:
        with self._lock:
            return len(self.train_ended) >= n and all(self.train_ended.values())

    def reset(self, base_epoch: int = 0) -> None:
        """Wipe per-incarnation state before a respawn. Epoch counts are
        per-incarnation (a worker that crashed before its checkpoint write
        must not inflate the resume point across restarts) and other_finish
        must clear or every post-finish restart would skip straight to the
        wait-for-exit branch, disabling stuck detection."""
        with self._lock:
            self.in_batch.clear()
            self.train_ended.clear()
            self.epochs.clear()
            self.base_epoch = base_epoch
            self.other_down = None
            self.other_finish = False


class MonitorServer:
    """HTTP endpoint for worker heartbeats and peer-monitor control
    messages (parity: the :7756 server)."""

    def __init__(self, state: HeartbeatState, port: int = MONITOR_PORT):
        self.state = state

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(inner):
                n = int(inner.headers.get("Content-Length", 0))
                body = inner.rfile.read(n).decode().strip()
                kind, _, value = body.partition(":")
                try:
                    self.state.signal(kind, int(value))
                    inner.send_response(200)
                except ValueError:
                    inner.send_response(400)
                inner.end_headers()

        self.httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self.httpd.server_address[1]

    def start(self):
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()


def parse_duration(s: str) -> float:
    s = s.strip()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000
    if s.endswith("s"):
        return float(s[:-1])
    if s.endswith("m"):
        return float(s[:-1]) * 60
    return float(s)


def _post(addr: str, body: str, timeout: float = 3.0) -> bool:
    req = urllib.request.Request(
        f"http://{addr}/signal", data=body.encode(), method="POST"
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            resp.read()
        return True
    except OSError:
        return False


def _monitor_peers(args, cluster, self_host: str) -> List[str]:
    """Other runners' monitor addresses. -monitor-peers overrides (needed
    for multi-runner localhost tests where ports must differ); default =
    every other runner host on this runner's monitor port."""
    spec = getattr(args, "monitor_peers", "") or ""
    if spec:
        peers = [p.strip() for p in spec.split(",") if p.strip()]
        # exclude self (match on host:port)
        me = f"{self_host}:{getattr(args, 'monitor_port', MONITOR_PORT)}"
        return [p for p in peers if p != me]
    port = getattr(args, "monitor_port", MONITOR_PORT) or MONITOR_PORT
    return [
        f"{r.host}:{port}" for r in cluster.runners if r.host != self_host
    ]


def monitored_run(args, cmd, cluster, self_host: str, strategy) -> int:
    """Launch-and-relaunch loop (parity: MonitoredRun, monitored.go:18-75)."""
    from kungfu_tpu_torch.runner.cli import make_worker_procs

    import subprocess

    grace = parse_duration(args.auto_recover) if args.auto_recover else DEFAULT_GRACE
    state = HeartbeatState()
    monitor_port = getattr(args, "monitor_port", MONITOR_PORT)
    monitor = MonitorServer(state, monitor_port)
    monitor.start()
    peers = _monitor_peers(args, cluster, self_host)
    n_local = sum(1 for w in cluster.workers if w.host == self_host)
    restart = 0
    recover_epoch = 0  # min completed epoch across local + otherdown info
    try:
        while True:
            worker_cmd = list(cmd)
            if restart > 0:
                worker_cmd += ["--restart", "1"]
            procs = make_worker_procs(args, worker_cmd, cluster, self_host, strategy)
            state.reset(recover_epoch)  # before spawn: a begin must never race the wipe
            for p in procs:
                p.env[MONITOR_ADDR_ENV] = f"{self_host}:{monitor.port}"
                if restart > 0:
                    p.env[RECOVER_EPOCH_ENV] = str(recover_epoch)
                p.start()
            failed = False
            local_down = False
            while True:
                if all(not p.running for p in procs):
                    codes = [p.proc.returncode for p in procs]
                    if all(c == 0 for c in codes):
                        return 0
                    failed = True
                    log.warn("kfrun: workers exited %s; restarting", codes)
                    recover_epoch = state.min_epoch(n_local)
                    break
                if state.stuck_ranks(grace):
                    recover_epoch = state.min_epoch(n_local)
                    log.warn(
                        "kfrun: worker stuck > %ss at epoch %s; restarting",
                        grace, recover_epoch,
                    )
                    failed = True
                    local_down = True
                    break
                if state.other_down is not None:
                    # the broadcast carries the DETECTING host's min epoch:
                    # every host must resume from the cluster-wide min, not
                    # its own (a fast host would otherwise skip ahead)
                    recover_epoch = min(state.min_epoch(n_local), state.other_down)
                    log.warn(
                        "kfrun: otherdown:%s received; restarting",
                        state.other_down,
                    )
                    failed = True
                    break
                if state.all_done(n_local) or state.other_finish:
                    # trainend heartbeats (or a remote all-finish) arrived:
                    # let local procs run to completion and judge by their
                    # exit codes — never report success over a failure
                    codes = []
                    for p in procs:
                        try:
                            codes.append(p.wait(600))
                        except subprocess.TimeoutExpired:
                            p.kill()
                            codes.append(-1)
                    if all(c == 0 for c in codes):
                        # broadcast only after exit codes confirm success:
                        # a premature otherfinish would let peers shut down
                        # while this host restarts into an empty cluster
                        if peers and state.all_done(n_local):
                            for addr in peers:
                                _post(addr, "otherfinish:0")
                        return 0
                    failed = True
                    recover_epoch = state.min_epoch(n_local)
                    log.warn(
                        "kfrun: workers exited %s after trainend; restarting",
                        codes,
                    )
                    break
                time.sleep(0.25)
            if local_down and peers:
                # tell the other hosts before tearing down locally so the
                # whole cluster restarts in lockstep (parity: otherdown
                # broadcast, monitor.go:103-140)
                body = f"otherdown:{recover_epoch}"
                for addr in peers:
                    _post(addr, body)
            for p in procs:
                p.kill()
            if not failed:
                return 0
            restart += 1
            if restart > 100:
                log.error("kfrun: too many restarts, giving up")
                return 1
    finally:
        monitor.stop()


def send_heartbeat(
    kind: str, rank: int, host: str = "", port: int = 0
) -> None:
    """Worker-side heartbeat (parity: kungfu.cmd.monitor_batch_begin etc.).

    Address resolution: explicit host and/or port args (a bare port targets
    localhost), else KF_MONITOR_ADDR (set by the monitored runner), else
    localhost:7756. Best-effort: a missing monitor is not an error (scripts
    run unchanged without -auto-recover).
    """
    if host or port:
        addr = f"{host or '127.0.0.1'}:{port or MONITOR_PORT}"
    else:
        from kungfu_tpu_torch import knobs

        addr = knobs.raw(MONITOR_ADDR_ENV) or f"127.0.0.1:{MONITOR_PORT}"
    _post(addr, f"{kind}:{rank}", timeout=2.0)

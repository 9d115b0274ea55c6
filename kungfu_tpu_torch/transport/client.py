"""Transport client: pooled, token-checked connections with retry.

Port of `kungfu_tpu/transport/client.py` (parity:
srcs/go/rchannel/client/{client,connection_pool}.go and
connection.go:90-146 — one persistent connection per (peer, conn_type),
established with a header handshake + token ack, auto-reconnect with
bounded retries; Ping/Wait to probe peer liveness, client.go:29-59).

A colocated peer's large payloads ride a shared-memory ring (`shm`);
an arena that tmpfs cannot back degrades that connection to socket
frames, as the reference's transport does. `frames` counts the frames
this client sent each way, so a reader knows which path a walk took.

With metrics on (`KF_TELEMETRY=metrics` or `KF_CONFIG_ENABLE_MONITORING`)
every send feeds the net monitor (egress bytes and messages per peer),
the link table (`telemetry/link.py`: this worker's row of the measured
bandwidth matrix; a send that had to dial counts its bytes but is no
bandwidth sample) and the `kungfu_transport_send_seconds` histogram,
every ping the `kungfu_transport_rtt_seconds` one and the link table's
latency. The gate is read when the client is built and again at every
epoch (`reset_connections`); with metrics off the send path is
untouched.

`KF_SHAPE_LINKS` (`transport/shaping.py`) shapes this client's sends,
matched against its OWN peer id: the delay is slept inside the timed
send window with the connection's lock held, as a saturated pipe would
hold it, so the link table and the walk profiler see the shaped edge;
a ping's round trip includes the shaped latency. Unlike the
reference's client, which reads the shape once, the port's re-reads it
at every epoch with the telemetry gate.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, Optional, Tuple

from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.telemetry import log
from kungfu_tpu_torch.transport import shm
from kungfu_tpu_torch.transport.message import (
    ConnType,
    Flags,
    Message,
    nbytes_of,
    recv_ack,
    send_header,
    send_message,
)
from kungfu_tpu_torch.transport.server import unix_sock_path
from kungfu_tpu_torch.utils import trace

# declared lock hierarchy (kfcheck KF201): the per-peer send lock is
# held across a send; the pool-map lock only guards dict lookups inside
# it and must never be the outer of the two
_KF_LOCK_ORDER = ("lock", "_pool_lock")

CONN_RETRY_COUNT = 120
# Exponential backoff between dial attempts: start fine (a joiner's server
# comes up in tens of ms), cap at CONN_RETRY_PERIOD so a genuinely absent
# peer costs the same as a flat period (read at call time: tests patch
# PERIOD/COUNT to bound absent-peer waits).
CONN_RETRY_PERIOD = 0.25
CONN_RETRY_MIN = 0.01
CONN_RETRY_GROWTH = 1.6

_SHM_TYPES = (ConnType.COLLECTIVE, ConnType.PEER_TO_PEER, ConnType.QUEUE)


def _retry_delays():
    d = CONN_RETRY_MIN
    for _ in range(CONN_RETRY_COUNT):
        yield min(d, CONN_RETRY_PERIOD)
        d = min(d * CONN_RETRY_GROWTH, CONN_RETRY_PERIOD)


class Client:
    def __init__(self, self_id: PeerID, use_unix: bool = True):
        self.self_id = self_id
        self._token = 0
        self._pool: Dict[Tuple[PeerID, ConnType], socket.socket] = {}
        self._locks: Dict[Tuple[PeerID, ConnType], threading.Lock] = {}
        self._pool_lock = threading.Lock()
        self._use_unix = use_unix
        # shared-memory arenas for colocated peers, one per live
        # connection; (re)created whenever the connection is (re)made so
        # ring sequence numbers reset with the epoch
        self._arenas: Dict[Tuple[PeerID, ConnType], "shm.SenderArena"] = {}
        # frames sent through the shm ring and as whole socket frames
        self.frames = {"shm": 0, "socket": 0}
        self._frames_lock = threading.Lock()
        self._shaper = None
        self._resolve_telemetry()

    def _resolve_telemetry(self) -> None:
        """Egress accounting (parity: monitor.Egress called from the
        connection send path, srcs/go/monitor/monitor.go:28-72), the link
        table and the latency histograms, under the metrics gate; and the
        link shaper of `KF_SHAPE_LINKS` (None when unshaped)."""
        from kungfu_tpu_torch.monitor import net as _net
        from kungfu_tpu_torch.telemetry import link as _link
        from kungfu_tpu_torch.transport import shaping as _shaping

        self._monitor = _net.get_monitor() if _net.enabled() else None
        self._links = _link.get_table() if _link.enabled() else None
        old, self._shaper = self._shaper, _shaping.from_env(str(self.self_id))
        if old is not None:
            old.close()
        self._send_hist = self._rtt_hist = None
        if self._monitor is not None:
            from kungfu_tpu_torch.telemetry import metrics as _tmetrics

            self._send_hist = _tmetrics.histogram(
                "kungfu_transport_send_seconds",
                "Host-transport send latency (frame + flush)",
            )
            self._rtt_hist = _tmetrics.histogram(
                "kungfu_transport_rtt_seconds",
                "Ping round-trip time per peer",
                ("peer",),
            )

    def set_token(self, token: int) -> None:
        self._token = token

    def reset_connections(self) -> None:
        """Drop all pooled connections (new epoch after a resize), and
        re-read the telemetry gate for the new epoch."""
        self._resolve_telemetry()
        with self._pool_lock:
            for sock in self._pool.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._pool.clear()
            for arena in self._arenas.values():
                if arena is not None:
                    arena.close()
            self._arenas.clear()

    def _colocated(self, peer: PeerID) -> bool:
        def is_loop(h: str) -> bool:
            return h == "localhost" or h.startswith("127.")

        return peer.host == self.self_id.host or (
            is_loop(peer.host) and is_loop(self.self_id.host)
        )

    def _fresh_arena(self, key: Tuple[PeerID, ConnType]):
        """(Re)create the sender arena for a freshly-made connection. A
        full tmpfs (ArenaSpaceError from posix_fallocate) degrades the
        connection to plain socket frames for this epoch instead of a
        SIGBUS on the first ring write; the next reconnect retries. None
        in the table records the degradation (absent = not tried yet)."""
        old = self._arenas.pop(key, None)
        if old is not None:
            old.close()
        peer, conn_type = key
        try:
            arena = shm.SenderArena(
                shm.arena_path(peer.host, peer.port, self.self_id.host,
                               self.self_id.port, int(conn_type))
            )
        except shm.ArenaSpaceError as e:
            trace.record("transport.shm_alloc_fail", 0.0)
            shm.count_alloc_failure()
            log.warn("shm arena unavailable, using sockets to %s: %s", peer, e)
            self._arenas[key] = None
            return None
        self._arenas[key] = arena
        return arena

    def _connect(self, peer: PeerID, conn_type: ConnType) -> socket.socket:
        last_err: Optional[Exception] = None
        for delay in _retry_delays():
            try:
                if self._use_unix and peer.host in ("127.0.0.1", "localhost", self.self_id.host):
                    try:
                        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                        sock.connect(unix_sock_path(peer))
                    except OSError:
                        sock = socket.create_connection((peer.host, peer.port), timeout=10)
                else:
                    sock = socket.create_connection((peer.host, peer.port), timeout=10)
                if sock.family == socket.AF_INET:
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                send_header(sock, conn_type, self.self_id.host, self.self_id.port, self._token)
                remote_token = recv_ack(sock)
                if conn_type in _SHM_TYPES and remote_token != self._token:
                    # epoch mismatch: remote hasn't caught up yet
                    sock.close()
                    raise ConnectionError(
                        f"token mismatch with {peer}: {remote_token} != {self._token}"
                    )
                return sock
            except OSError as e:  # ConnectionError is an OSError
                last_err = e
                time.sleep(delay)
        raise ConnectionError(f"cannot connect to {peer} ({conn_type.name}): {last_err}")

    def _count(self, path: str) -> None:
        with self._frames_lock:
            self.frames[path] += 1

    def send(
        self,
        peer: PeerID,
        name: str,
        data,
        conn_type: ConnType = ConnType.COLLECTIVE,
        flags: Flags = Flags.NONE,
    ) -> None:
        """Send `data` (bytes-like, or a contiguous CPU tensor sent as its
        bytes) as the message `name` to `peer`."""
        key = (peer, conn_type)
        with self._pool_lock:
            lock = self._locks.setdefault(key, threading.Lock())
        data_len = nbytes_of(data)
        shm_conn = conn_type in _SHM_TYPES and shm.enabled() and self._colocated(peer)
        use_shm = shm_conn and data_len >= shm.SHM_MIN_BYTES

        def wire_message() -> Message:
            """The on-socket frame; an shm send copies the payload into
            the ring and frames only the descriptor. A full ring falls
            back to the socket frame (kernel flow control)."""
            if use_shm:
                arena = self._arenas[key] if key in self._arenas else self._fresh_arena(key)
                if arena is not None:  # None: tmpfs couldn't back the ring
                    desc = arena.try_write(data, data_len)
                    if desc is not None:
                        self._count("shm")
                        return Message(name=name, data=desc, flags=flags | Flags.SHM_REF)
            self._count("socket")
            return Message(name=name, data=data, flags=flags)

        dialed = False
        with lock:
            with self._pool_lock:
                sock = self._pool.get(key)
            if sock is None:
                sock = self._connect(peer, conn_type)
                dialed = True
                with self._pool_lock:
                    self._pool[key] = sock
                if shm_conn:
                    self._fresh_arena(key)
            t0 = time.perf_counter()
            shaper = self._shaper
            if shaper is not None:
                delay = shaper.delay(peer, data_len)
                if delay > 0:
                    # inside the timed window, the connection's lock held:
                    # the link table and the walk profiler see it
                    # kfcheck: disable=KF200 — deliberate test-only edge shaping: holding the per-connection lock through the delay serializes the edge exactly like a saturated pipe would
                    time.sleep(delay)
            try:
                send_message(sock, wire_message())
            except OSError:
                # one reconnect attempt, then fail up; the arena is
                # re-created on EVERY reconnect of a shm-capable conn: the
                # new _serve_conn's receiver starts at seq 0, and a stale
                # sender seq would see phantom in-use bytes forever
                try:
                    sock.close()
                except OSError:
                    pass
                sock = self._connect(peer, conn_type)
                dialed = True
                with self._pool_lock:
                    self._pool[key] = sock
                if shm_conn:
                    self._fresh_arena(key)
                send_message(sock, wire_message())
            dt = time.perf_counter() - t0
            trace.record("transport.send", dt)
            if self._send_hist is not None:
                self._send_hist.observe(dt)
        if self._monitor is not None:
            self._monitor.sent(peer, data_len)
        if self._links is not None:
            # a send that had to dial still counts its bytes, but is no
            # bandwidth sample: connection setup is not link speed
            self._links.observe_send(peer, data_len, 0.0 if dialed else dt)

    def ping(self, peer: PeerID, timeout: float = 2.0) -> bool:
        try:
            t0 = time.perf_counter()
            sock = socket.create_connection((peer.host, peer.port), timeout=timeout)
            shaper = self._shaper
            if shaper is not None:
                # the shaped message latency inside the timed round trip,
                # so the link table's latency sees the shape too
                delay = shaper.latency(peer)
                if delay > 0:
                    time.sleep(delay)
            send_header(sock, ConnType.PING, self.self_id.host, self.self_id.port, 0)
            recv_ack(sock)
            sock.close()
            rtt = time.perf_counter() - t0
            if self._rtt_hist is not None:
                self._rtt_hist.labels(str(peer)).observe(rtt)
            if self._links is not None:
                self._links.observe_latency(peer, rtt)
            return True
        except OSError:
            return False

    def wait_peer(self, peer: PeerID, timeout: float = 300.0) -> bool:
        """Block until peer's server answers pings (parity: router.Wait
        with WaitRunnerTimeout, peer/peer.go:200-209)."""
        deadline = time.monotonic() + timeout
        delay = CONN_RETRY_MIN
        while time.monotonic() < deadline:
            if self.ping(peer):
                return True
            time.sleep(delay)
            delay = min(delay * CONN_RETRY_GROWTH, CONN_RETRY_PERIOD)
        return False

    def close(self) -> None:
        self.reset_connections()
        if self._shaper is not None:
            self._shaper.close()
            self._shaper = None

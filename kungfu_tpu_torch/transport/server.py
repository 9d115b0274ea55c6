"""Transport server: listens for peer connections, demuxes to handlers.

Port of `kungfu_tpu/transport/server.py` (parity:
srcs/go/rchannel/server/server.go, TCP + Unix-socket listener for
colocated peers, and srcs/go/kungfu/peer/router.go, demux by ConnType).
Token-versioned connections: after an elastic resize bumps the cluster
version, stale connections (old token) are rejected so a new epoch never
consumes old-epoch frames (parity: server.SetToken +
router.ResetConnections, peer/peer.go:148-160).
"""

from __future__ import annotations

import errno
import os
import socket
import struct
import threading
import time
from typing import Callable, Dict

from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.transport import shm
from kungfu_tpu_torch.transport.message import (
    ConnType,
    Flags,
    Message,
    _recv_exact,
    _recv_exact_into,
    recv_frame_header,
    recv_header,
    recv_message,
    send_ack,
)
from kungfu_tpu_torch.utils import trace

# handler(src: PeerID, msg: Message) -> None
Handler = Callable[[PeerID, Message], None]


def unix_sock_path(peer: PeerID) -> str:
    # host-qualified: two loopback aliases (127.0.0.1 / 127.0.0.2) may carry
    # the same port on one machine (multi-"host" localhost clusters)
    return f"/tmp/kungfu_tpu-{peer.host}-{peer.port}.sock"


class Server:
    def __init__(self, self_id: PeerID, use_unix: bool = True):
        self.self_id = self_id
        self._handlers: Dict[ConnType, Handler] = {}
        self._token = 0
        self._lock = threading.Lock()
        self._listeners = []
        self._threads = []
        self._stopped = threading.Event()
        self._use_unix = use_unix

    def register(self, conn_type: ConnType, handler: Handler) -> None:
        self._handlers[conn_type] = handler

    def set_token(self, token: int) -> None:
        with self._lock:
            self._token = token

    @property
    def token(self) -> int:
        with self._lock:
            return self._token

    def start(self, bind_timeout: float = 15.0) -> None:
        tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # Bind to the ADVERTISED host (peers dial exactly that address), so
        # multi-"host" localhost clusters can stack the same port on
        # different loopback aliases; fall back to the wildcard when the
        # advertised name doesn't resolve to a local interface.
        # Bind retry: a respawned worker can race the previous
        # incarnation's exit for the same port, and a port reserved by
        # binding 0 can be taken by another process for a moment.
        deadline = time.monotonic() + bind_timeout
        while True:
            try:
                try:
                    tcp.bind((self.self_id.host, self.self_id.port))
                except (socket.gaierror, OSError) as e:
                    if isinstance(e, OSError) and e.errno == errno.EADDRINUSE:
                        raise
                    tcp.bind(("0.0.0.0", self.self_id.port))
                break
            except OSError as e:
                # only the respawn race is transient; EACCES and friends
                # are real misconfigurations — surface them now
                if e.errno != errno.EADDRINUSE or time.monotonic() >= deadline:
                    raise
                time.sleep(0.25)
        tcp.listen(128)
        self._listeners.append(tcp)
        t = threading.Thread(target=self._accept_loop, args=(tcp,), daemon=True)
        t.start()
        self._threads.append(t)

        if self._use_unix:
            path = unix_sock_path(self.self_id)
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            ux = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            ux.bind(path)
            ux.listen(128)
            self._listeners.append(ux)
            t2 = threading.Thread(target=self._accept_loop, args=(ux,), daemon=True)
            t2.start()
            self._threads.append(t2)

    def stop(self) -> None:
        self._stopped.set()
        for listener in self._listeners:
            try:
                listener.close()
            except OSError:
                pass
        if self._use_unix:
            # if a respawned same-port worker already re-bound this path,
            # this unlink removes ITS socket file; clients then fall back
            # to TCP (correct, just slower) until the next epoch
            try:
                os.unlink(unix_sock_path(self.self_id))
            except FileNotFoundError:
                pass

    def _accept_loop(self, listener: socket.socket) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        # shared-memory receive state (lazy: first SHM_REF frame maps the
        # sender's arena; per-connection so epochs reset cleanly)
        rx_state: Dict[str, object] = {}
        try:
            conn_type, src_host, src_port, token = recv_header(conn)
            # Token check: PING and CONTROL are version-independent (they
            # carry the resize protocol itself); data-plane types must match
            # the current epoch.
            if conn_type in (ConnType.COLLECTIVE, ConnType.PEER_TO_PEER, ConnType.QUEUE):
                if token != self.token:
                    conn.close()
                    return
            send_ack(conn, self.token)
            src = PeerID(src_host, src_port)
            handler = self._handlers.get(conn_type)
            if conn_type == ConnType.PING or handler is None:
                conn.close()
                return

            def shm_region(desc):
                """Resolve a descriptor frame to (view, release)."""
                off, length, advance = shm.DESC.unpack(bytes(desc))
                arena = rx_state.get("arena")
                if arena is None:
                    arena = shm.ReceiverArena(
                        shm.arena_path(
                            self.self_id.host, self.self_id.port,
                            src.host, src.port, int(conn_type),
                        )
                    )
                    rx_state["arena"] = arena
                return arena.region(off, length, advance)

            # Zero-copy receive: when the registered endpoint exposes the
            # sink protocol (CollectiveEndpoint), read the frame header
            # first and, if a receiver is already parked on (src, name)
            # with a matching buffer, deliver the payload straight off the
            # socket into it (parity: WAIT_RECV_BUF / RecvInto,
            # handler/collective.go:34-65).
            endpoint = getattr(handler, "__self__", None)
            take_sink = getattr(endpoint, "take_sink", None)
            if take_sink is None:
                while not self._stopped.is_set():
                    msg = recv_message(conn)
                    if msg.flags & Flags.SHM_REF:
                        # CONTROL/QUEUE/P2P endpoints buffer messages for
                        # arbitrarily long — copy out of the ring and
                        # release at once
                        view, release = shm_region(msg.data)
                        buf = bytearray(len(view))
                        shm.copy_bytes(memoryview(buf), view)
                        release()
                        msg = Message(name=msg.name, data=buf,
                                      flags=msg.flags & ~Flags.SHM_REF)
                    handler(src, msg)
            else:
                finish_sink = endpoint.finish_sink
                while not self._stopped.is_set():
                    name, flags, data_len = recv_frame_header(conn)
                    if flags & Flags.SHM_REF:
                        desc = _recv_exact(conn, data_len)
                        view, release = shm_region(desc)
                        flags &= ~Flags.SHM_REF
                        # always borrow — even when a sink is parked, the
                        # walk reduces straight from the mapped ring, so a
                        # transport-thread copy here would be pure waste
                        handler(src, Message(name=name, data=view, flags=flags,
                                             release=release))
                        continue
                    sink = take_sink(src, name, data_len) if data_len else None
                    if sink is not None:
                        t0 = time.perf_counter()
                        try:
                            _recv_exact_into(conn, sink.view)
                        except BaseException:
                            finish_sink(src, name, sink, flags, ok=False)
                            raise
                        finish_sink(src, name, sink, flags, ok=True)
                        trace.record("transport.recv_sink", time.perf_counter() - t0)
                    else:
                        data = _recv_exact(conn, data_len) if data_len else b""
                        handler(src, Message(name=name, data=data, flags=flags))
        except (ConnectionError, OSError):
            pass
        except (ValueError, UnicodeDecodeError, struct.error):
            # malformed frames (bad enum value / undecodable name / short
            # struct): a garbage-sending peer must not take the server down
            pass
        finally:
            arena = rx_state.get("arena")
            if arena is not None:
                arena.close()
            try:
                conn.close()
            except OSError:
                pass

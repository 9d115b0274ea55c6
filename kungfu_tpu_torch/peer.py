"""Peer: the worker-side runtime root of the host plane.

Port of `kungfu_tpu/peer.py` (parity: srcs/go/kungfu/peer/peer.go:27-308):
every worker embeds the host-side communication runtime — a transport
server and client, the current cluster (versioned), and the HostSession of
that version. The device plane (`parallel/distributed.py`) forms its
`torch.distributed` world over this session.

Not ported yet: the elastic-resize protocol (propose, notify runners,
bump version; ROADMAP item 1d) and the telemetry server and flight
recorder (item 1e). A new epoch is built by `_update_to` at a new
`cluster_version`, as the resize protocol would.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.collective.host_session import HostSession
from kungfu_tpu_torch.plan.peer import PeerList
from kungfu_tpu_torch.runner import env as kfenv
from kungfu_tpu_torch.store.versioned import BlobStore
from kungfu_tpu_torch.telemetry import log
from kungfu_tpu_torch.transport.client import Client
from kungfu_tpu_torch.transport.handlers import CollectiveEndpoint, P2PEndpoint, QueueEndpoint
from kungfu_tpu_torch.transport.message import ConnType
from kungfu_tpu_torch.transport.server import Server
from kungfu_tpu_torch.utils import trace

_default_peer: Optional["Peer"] = None
_default_lock = threading.Lock()


def get_default_peer() -> "Peer":
    """Process-wide singleton (parity: Peer::GetDefault, peer.hpp), built
    from the runner's environment and started on first use."""
    global _default_peer
    with _default_lock:
        if _default_peer is None:
            with trace.span("worker.parse_config"):
                cfg = kfenv.parse_config_from_env()
            with trace.span("worker.peer_init"):
                _default_peer = Peer(cfg)
            _default_peer.start()
        return _default_peer


def running_default_peer() -> Optional["Peer"]:
    """The default peer if this process has started one, else None
    (never starts one)."""
    with _default_lock:
        return _default_peer


def finalize_default_peer() -> None:
    global _default_peer
    with _default_lock:
        if _default_peer is not None:
            _default_peer.stop()
            _default_peer = None


class Peer:
    def __init__(self, config: kfenv.WorkerConfig):
        self.config = config
        self.self_id = config.self_id
        self.cluster_version = config.cluster_version
        self.detached = False
        self._peers = config.peers
        self._session: Optional[HostSession] = None
        self._session_lock = threading.RLock()
        # cluster epochs this PROCESS has lived through: 1 after start
        self.epoch_count = 0

        self.store = BlobStore()
        self.client = Client(self.self_id, use_unix=not config.single_process)
        self.server = Server(self.self_id, use_unix=not config.single_process)
        self.collective = CollectiveEndpoint()
        self.queue = QueueEndpoint()
        self.p2p = P2PEndpoint(self.store, self.client, self.self_id)
        self.server.register(ConnType.COLLECTIVE, self.collective.handle)
        self.server.register(ConnType.QUEUE, self.queue.handle)
        self.server.register(ConnType.PEER_TO_PEER, self.p2p.handle)

    def start(self) -> None:
        spawn_ts = knobs.raw("KF_SPAWN_TS")
        if spawn_ts:
            # joiner-readiness latency: runner spawn -> host plane up
            try:
                startup = time.time() - float(spawn_ts)
                trace.record("worker.startup", startup)
                log.info("worker ready %.0f ms after spawn", startup * 1e3)
            except ValueError:
                pass
        if not self.config.single_process:
            with trace.span("worker.start.server"):
                self.server.start()
        with trace.span("worker.start.update"):
            self._update_to(self._peers)

    def stop(self) -> None:
        with self._session_lock:
            if self._session is not None:
                self._session.close(timeout=5.0)
        self.server.stop()
        self.client.close()

    @property
    def rank(self) -> int:
        return self.current_session().rank

    @property
    def size(self) -> int:
        return self.current_session().size

    def current_session(self) -> HostSession:
        with self._session_lock:
            if self._session is None:
                raise RuntimeError("peer not started")
            return self._session

    def _update_to(self, peers: PeerList) -> bool:
        """Rebuild the session for a new peer list at `cluster_version`;
        returns False if self is not a member (detached). Parity:
        peer.updateTo (peer.go:148-170)."""
        with self._session_lock:
            if self._session is not None:
                self._session.close(timeout=10.0)
            if peers.rank(self.self_id) is None:
                self.detached = True
                return False
            self.server.set_token(self.cluster_version)
            self.client.set_token(self.cluster_version)
            self.client.reset_connections()
            self._session = HostSession(
                self.config.strategy,
                self.self_id,
                peers,
                self.client,
                self.collective,
                cluster_version=self.cluster_version,
            )
            self._peers = peers
            self.epoch_count += 1
        if not self.config.single_process:
            # fail fast BEFORE the barrier: the barrier itself walks
            # strategy-dependent graphs, so knob-divergent peers would hang
            # right here instead of raising a named error
            with trace.span("worker.knob_consensus"):
                self._session.check_knob_consensus()
            self._session.barrier(tag=f":v{self.cluster_version}")
        return True

    def set_tree(self, fathers) -> None:
        """Install a runtime collective tree on the CURRENT session epoch
        (parity: SetTree, adaptation.cpp:5-33). The father array indexes
        this epoch's rank space, so it does not survive a resize."""
        self.current_session().set_tree([int(f) for f in fathers])

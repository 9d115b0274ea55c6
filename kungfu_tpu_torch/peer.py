"""Peer: the worker-side runtime root of the host plane.

Port of `kungfu_tpu/peer.py` (parity: srcs/go/kungfu/peer/peer.go:27-308):
every worker embeds the host-side communication runtime — a transport
server and client, the current cluster (versioned), and the HostSession of
that version. The device plane (`parallel/distributed.py`) forms its
`torch.distributed` world over this session.

The elastic-resize protocol (parity: peer.go propose/ResizeCluster*):
peers agree on a proposed cluster by a bytes consensus, rank 0 sends the
new Stage to every runner (the reference's JSON, byte for byte, so either
package's runner drives either's workers), every peer bumps the cluster
version, and `_update_to` builds the next epoch's session. A joiner
starts at that version from the runner's environment; a peer left out
detaches. `last_resize_phases` times the phases of the latest resize,
and every resize this peer takes part in appends an audit record
carrying them.

With any telemetry feature on (`KF_TELEMETRY`, or the metrics of
`KF_CONFIG_ENABLE_MONITORING`) a worker serves `/metrics`, `/trace`,
`/audit` and `/decisions` on its peer port + 10000 (parity:
peer/peer.go:96-104). A session epoch whose async or ZeRO mode resolves
differently from the last opens an `async_mode`/`zero_mode` decision
record, a resize a `resize` record on every surviving peer, and each
new peer list prunes the link table of departed destinations. Such a
worker also serves `/steptrace` and `/host/telemetry`, and re-runs the
host sub-aggregator election after every new peer list (at scale the
lowest-labelled worker of each host pre-merges its siblings' telemetry
for the runner's aggregator). A worker that is not `single_process`
starts the flight recorder (`telemetry/flight.py`) when kfrun plumbs a
run dir (`KF_TELEMETRY_DIR`) or any telemetry is on: its journal is the
black box the runner harvests into a postmortem when the worker dies.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Optional, Tuple

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.collective.host_session import HostSession
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.plan.peer import PeerList
from kungfu_tpu_torch.runner import env as kfenv
from kungfu_tpu_torch.store.versioned import BlobStore
from kungfu_tpu_torch.telemetry import audit, decisions, log
from kungfu_tpu_torch.telemetry import link as tlink
from kungfu_tpu_torch.transport.client import Client
from kungfu_tpu_torch.transport.handlers import CollectiveEndpoint, P2PEndpoint, QueueEndpoint
from kungfu_tpu_torch.transport.message import ConnType
from kungfu_tpu_torch.transport.server import Server
from kungfu_tpu_torch.utils import trace
from kungfu_tpu_torch.utils.stall import stall_detect

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
        # cluster epochs this PROCESS has lived through: 1 after start,
        # >1 once it survives a delta resize (ElasticState's root vote)
        self.epoch_count = 0
        # per-phase wall-clock (ms) of the most recent resize, as seen by
        # this peer: wait_config / consensus / notify / update (update =
        # reconnect + new-session barrier, i.e. joiner-bounded)
        self.last_resize_phases: dict = {}
        # config-poll/reload consensus rounds run, PER cluster version:
        # every member of a session epoch runs them in lockstep, so the
        # (version, rounds-this-version) pair agrees cluster-wide where a
        # process-lifetime counter would diverge for joiners
        self._cfg_consensus_seq: dict = {}

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
        self._start_telemetry_server()
        self._start_flight_recorder()
        with trace.span("worker.start.update"):
            self._update_to(self._peers)

    def _start_telemetry_server(self) -> None:
        """Serve /metrics, /trace, /audit and /decisions on self.port + 10000 when any
        telemetry is on (parity: peer/peer.go:96-104). In-process peers
        (`single_process`) serve nothing; a port that cannot be bound
        (taken, or past 65535) warns instead of failing the worker."""
        self.metrics_server = None
        from kungfu_tpu_torch.monitor import net as _net
        from kungfu_tpu_torch.telemetry import config as _tconfig

        if (_net.enabled() or _tconfig.features()) and not self.config.single_process:
            # the singleton, so the transport's counters mirror into the
            # registry this server renders
            _net.get_monitor()
            try:
                from kungfu_tpu_torch.telemetry.http import TelemetryServer

                self.metrics_server = TelemetryServer(self.self_id.port + 10000)
                self.metrics_server.start()
            except (OSError, OverflowError) as e:
                # OverflowError: peer port within 10000 of 65535
                log.warn("telemetry server failed to start: %s", e)

    def _start_flight_recorder(self) -> None:
        """Durable flight recorder: journal telemetry snapshots to disk so
        a SIGKILLed or OOM-killed worker leaves a black box. kfrun injects
        KF_TELEMETRY_DIR, which turns it on; in-process peers
        (`single_process`) stay off."""
        self.flight_recorder = None
        if self.config.single_process:
            return
        from kungfu_tpu_torch.telemetry import flight

        self.flight_recorder = flight.start_recorder(peer=str(self.self_id))

    def stop(self) -> None:
        with self._session_lock:
            if self._session is not None:
                self._session.close(timeout=5.0)
        self.server.stop()
        self.client.close()
        if getattr(self, "metrics_server", None) is not None:
            # close the listening socket too, not only the serve loop
            self.metrics_server.stop()
            self.metrics_server = None
        if getattr(self, "flight_recorder", None) is not None:
            from kungfu_tpu_torch.telemetry import flight

            flight.stop_recorder(reason="peer_stop")
            self.flight_recorder = None

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
            old_session = self._session
            if old_session is not None:
                old_session.close(timeout=10.0)
            if peers.rank(self.self_id) is None:
                self.detached = True
                # the election would clear the role anyway, but it must
                # happen on this early exit too
                self._update_host_role(peers)
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
            # an engine-mode flip at a session epoch is an adaptation like
            # any vote: open its causal record
            if old_session is not None:
                for kind, was, now in (
                        ("async_mode", old_session.async_enabled(),
                         self._session.async_enabled()),
                        ("zero_mode", old_session.zero_enabled(),
                         self._session.zero_enabled())):
                    if was != now:
                        decisions.open_decision(
                            kind, peer=str(self.self_id), epoch=self.cluster_version,
                            trigger="session_epoch", old="on" if was else "off",
                            new="on" if now else "off")
            # a departed peer's frozen bandwidth estimate must not keep
            # winning links/min_bw or walk-efficiency scoring (runners
            # stay: stable control-plane membership)
            if tlink.enabled():
                tlink.get_table().prune(list(peers) + list(self.config.runners))
            # host sub-aggregator election: every membership change
            # re-elects deterministically on every peer
            self._update_host_role(peers)
        if not self.config.single_process:
            # fail fast BEFORE the barrier: the barrier itself walks
            # strategy-dependent graphs, so knob-divergent peers would hang
            # right here instead of raising a named error
            with trace.span("worker.knob_consensus"):
                self._session.check_knob_consensus()
            self._session.barrier(tag=f":v{self.cluster_version}")
        return True

    def _update_host_role(self, peers: PeerList) -> None:
        """Recompute this worker's host sub-aggregator role. A failure
        only warns: the role is an optimization the runner's aggregator
        falls back from, and must never touch the resize path."""
        if self.config.single_process or getattr(self, "metrics_server", None) is None:
            return  # no telemetry server, nothing to elect for
        try:
            from kungfu_tpu_torch.telemetry import cluster as _cluster

            _cluster.update_host_role(self.self_id, list(peers))
        except Exception as e:  # noqa: BLE001 - telemetry must not break resizes
            log.warn("host telemetry role update failed: %s", e)

    def set_tree(self, fathers) -> None:
        """Install a runtime collective tree on the CURRENT session epoch
        (parity: SetTree, adaptation.cpp:5-33). The father array indexes
        this epoch's rank space, so it does not survive a resize."""
        self.current_session().set_tree([int(f) for f in fathers])

    # ------------------------------------------------------------------
    # elastic resize protocol (parity: peer.go propose/ResizeCluster*)
    # ------------------------------------------------------------------

    def _notify_runners(self, stage: dict) -> None:
        """Send the new Stage to every runner (parity: peer.go:200-214)."""
        payload = json.dumps(stage).encode()
        log.debug("notifying %d runners: v%s", len(self.config.runners), stage.get("Version"))
        for runner in self.config.runners:
            if not self.client.wait_peer(runner, timeout=30):
                raise ConnectionError(f"runner {runner} unreachable")
            self.client.send(runner, "update", payload, ConnType.CONTROL)
            log.debug("notified runner %s", runner)

    def _propose(self, cluster: Cluster, progress: int = 0, trigger: str = "explicit",
                 pre_phases: Optional[dict] = None) -> Tuple[bool, bool]:
        """Consensus-check and adopt a new cluster.

        Returns (accepted, keep): keep=False means self is detached.
        Parity: peer.propose (peer.go:181-233) including the safety check —
        peers must agree on the proposed bytes or the resize is rejected.
        `pre_phases` (the config-server wait) joins the phase times.
        """
        sess = self.current_session()
        t0 = time.perf_counter()
        with trace.span("resize.consensus"):
            agreed = sess.bytes_consensus(cluster.to_bytes(), f":propose:v{self.cluster_version}")
        if not agreed:
            return False, True
        if self._peers == cluster.workers:
            return True, True  # no change
        old_peers = self._peers
        self.last_resize_phases = dict(pre_phases or {})
        self.last_resize_phases["consensus_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        stage = {
            "Version": self.cluster_version + 1,
            "Progress": progress,
            "Cluster": cluster.to_json(),
        }
        if sess.rank == 0 and self.config.runners:
            t1 = time.perf_counter()
            with trace.span("resize.notify"):
                self._notify_runners(stage)
            self.last_resize_phases["notify_ms"] = round((time.perf_counter() - t1) * 1e3, 1)
        # all peers advance the version together (they all ran the consensus)
        self.cluster_version += 1
        t2 = time.perf_counter()
        with trace.span("resize.update"):
            keep = self._update_to(cluster.workers)
        self.last_resize_phases["update_ms"] = round((time.perf_counter() - t2) * 1e3, 1)
        audit.record_resize(
            peer=str(self.self_id),
            cluster_version=self.cluster_version,
            trigger=trigger,
            old_peers=list(old_peers),
            new_peers=list(cluster.workers),
            phases_ms=self.last_resize_phases,
            progress=progress or None,
            detached=not keep,
        )
        if keep:
            # the capacity decision: open its outcome record on every
            # surviving peer (a detached peer has no steps to measure)
            decisions.open_decision(
                "resize", peer=str(self.self_id), epoch=self.cluster_version,
                trigger=trigger, old_size=len(old_peers), new_size=len(cluster.workers))
        log.info("resize v%d: %d -> %d workers (%s)%s", self.cluster_version, len(old_peers),
                 len(cluster.workers), trigger, "" if keep else " [detached]")
        return True, keep

    def _get_config(self, url: str, attempts: int = 3) -> Optional[Cluster]:
        """GET the desired cluster; a few retries absorb transient server
        blips so a published resize isn't silently dropped by the
        current-cluster fallback in _wait_new_config."""
        for i in range(attempts):
            try:
                with urllib.request.urlopen(url, timeout=5) as resp:
                    return Cluster.loads(resp.read().decode())
            except Exception as e:  # noqa: BLE001 - any failure falls back below
                if i + 1 < attempts:
                    time.sleep(0.3)
                else:
                    log.warn("config server unreachable after %d tries (%s): %s",
                             attempts, url, e)
        return None

    def _wait_new_config(self, url: str) -> Cluster:
        """Poll the config server until all current peers see the same
        cluster (parity: waitNewConfig, peer.go:242-263). When the server is
        unreachable or has no config, each peer falls back to its CURRENT
        cluster (the reference's "using current config" path) — once all
        peers agree (e.g. the server is down for everyone) the resize
        degrades to a no-op instead of hanging the training loop."""
        sess = self.current_session()
        current = Cluster(runners=self.config.runners, workers=self._peers)
        # each poll round gets its own rendezvous name: a slow peer's round
        # r must never consume the lanes of a fast peer's round r+1
        while True:
            cluster = self._get_config(url) or current
            with stall_detect(f"wait_new_config({url})"):
                if sess.bytes_consensus(cluster.to_bytes(), self._cfg_consensus_name("cfg")):
                    return cluster
            time.sleep(0.2)

    def _cfg_consensus_name(self, kind: str) -> str:
        """Round-stamped rendezvous name for the config-plane consensus
        lanes: `:{kind}:v{version}:{seq}` with seq the count of such
        rounds THIS session epoch has run (all epoch members run them in
        lockstep, so the stamp agrees cluster-wide; a joiner starts the
        new epoch at 0 together with everyone else)."""
        v = self.cluster_version
        seq = self._cfg_consensus_seq.get(v, 0)
        self._cfg_consensus_seq[v] = seq + 1
        return f":{kind}:v{v}:{seq}"

    def resize_cluster_from_url(self) -> Tuple[bool, bool]:
        """(changed, detached). Parity: ResizeClusterFromURL (peer.go:265)."""
        url = self.config.config_server
        if not url:
            return False, False
        t0 = time.perf_counter()
        with trace.span("resize.wait_config"):
            cluster = self._wait_new_config(url)
        wait_ms = round((time.perf_counter() - t0) * 1e3, 1)
        if cluster.workers == self._peers:
            return False, False
        # pre_phases rides into _propose so a REJECTED proposal never
        # splices this wait into the previous resize's phase breakdown
        accepted, keep = self._propose(cluster, trigger="config_server",
                                       pre_phases={"wait_config_ms": wait_ms})
        return accepted, not keep

    def resize_cluster(self, new_size: int) -> Tuple[bool, bool]:
        """Explicit resize to new_size workers (parity: ResizeCluster)."""
        current = Cluster(runners=self.config.runners, workers=self._peers)
        cluster = current.resize(new_size)
        if cluster.workers == self._peers:
            return False, False
        accepted, keep = self._propose(cluster, trigger="explicit")
        return accepted, not keep

    def propose_new_size(self, new_size: int) -> None:
        """Publish a desired size to the config server (rank-agnostic;
        parity: ProposeNewSize -> config-server PUT)."""
        url = self.config.config_server
        if not url:
            raise RuntimeError("no config server configured")
        current = Cluster(runners=self.config.runners, workers=self._peers)
        cluster = current.resize(new_size)
        req = urllib.request.Request(url, data=cluster.dumps().encode(), method="PUT")
        with urllib.request.urlopen(req, timeout=5) as resp:
            resp.read()

    def change_cluster(self, progress: int) -> Tuple[bool, bool]:
        """Reload-mode resize: every worker exits and the runners relaunch
        from `progress` (parity: ChangeCluster, peer.go:279-291 +
        ElasticModeReload). Returns (changed, detached_all)."""
        url = self.config.config_server
        if not url:
            return False, False
        cluster = self._wait_new_config(url)
        if cluster.workers == self._peers:
            return False, False
        sess = self.current_session()
        # epoch-sequenced: a reload agreement must not rendezvous with an
        # earlier attempt's lanes (repeat calls at one version) nor with
        # another epoch's
        if not sess.bytes_consensus(cluster.to_bytes(), self._cfg_consensus_name("reload")):
            return False, False
        stage = {
            "Version": self.cluster_version + 1,
            "Progress": progress,
            "Cluster": cluster.to_json(),
            "Reload": True,
        }
        if sess.rank == 0 and self.config.runners:
            self._notify_runners(stage)
        audit.record_resize(
            peer=str(self.self_id),
            cluster_version=self.cluster_version + 1,
            trigger="reload",
            old_peers=list(self._peers),
            new_peers=list(cluster.workers),
            progress=progress,
            detached=True,
        )
        # in reload mode every worker detaches; runners restart the world
        self.detached = True
        return True, True

"""Host-side collective engine facade: one session per cluster epoch.

Port of `kungfu_tpu/collective/host_session.py` (parity:
srcs/go/kungfu/session/session.go — an immutable peer-list epoch running
Barrier / Consensus / Reduce / Broadcast / Gather / AllReduce by walking
(reduce, bcast) graph pairs, with chunking striped across multi-root
strategies and a SIMD reduce on receive).

The engine runs on HOSTS, between peers, over the port's transport; the
device plane is NCCL or gloo (`parallel/`). Layering, as the reference's:

- walks.py     — the walk engines (segmented ring, chunked graph walks)
  and shared receive/accounting plumbing (:class:`WalkEngine` mixin);
- codec.py     — wire-format policy (:class:`WireCodec` mixin);
- pipeline.py  — group fusion (:class:`GroupFusion` mixin);
- profiler.py  — the process-global critical-path profiler.

Buffers are one-dimensional contiguous torch CPU tensors (pinned where
they stage a CUDA tensor). `wire_bytes` counts the payload bytes this
peer sent into walks, by (collective, strategy, codec).

Telemetry, as the reference's: every public collective is a span, and
with metrics on (resolved once per session epoch) a latency-histogram
observation; the walks count their wire bytes into
`kungfu_collective_wire_bytes_total` and the codec's savings; the
active ring position and successor, the two-level role and the wire
mode are gauges; strategy and precision switches, re-plans, codec
bypasses and the first segmented fallback of an epoch are audit events,
and every adaptation opens a decision-ledger record
(`telemetry/decisions.py`) that measured step times later grade.

Measured topology (`KF_CONFIG_REPLAN`): the lockstep rounds
`check_replan` (vote, exchange every peer's link-table row, derive one
plan from the shared matrix by `plan/replan.py`, adopt it behind a
digest check) and `check_demote` (vote a rank into or out of the
demoted role of a two-level plan). An adopted `RingPlan` reorders and
re-weights the segmented ring; a `HierPlan` runs the two-level walk
(`walks.py`). Listeners (the ZeRO-1 session) bracket each adoption.
Rendezvous names are the reference's byte for byte, so mixed worlds
derive and adopt one plan.

The async scheduler (`scheduler()`, `collective/scheduler.py`) lives
as long as the session epoch. The re-plan rounds share each peer's
measured compute fraction (the resource plane's `compute_frac`) through
`measured_compute_frac`, the clamp on a plan's predicted gain. Under
`KF_DEBUG_PROTOCOL` the collective-order sentinel
(`devtools/protowatch.py`) wraps the session's entry points at bind and
its scheduler's submit and flush.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.strategy import Strategy
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.collective import strategies as st
from kungfu_tpu_torch.collective.adaptive import AdaptiveState
from kungfu_tpu_torch.collective.codec import WIRE_MODES, WireCodec, wire_override
from kungfu_tpu_torch.collective.pipeline import GroupFusion
from kungfu_tpu_torch.collective.profiler import SpanSampler
from kungfu_tpu_torch.collective.walks import (
    CHUNK_BYTES,
    DEFAULT_TIMEOUT,
    WalkEngine,
    _buf,
    _frombuffer,
    algo_override,
)
from kungfu_tpu_torch.plan import replan as rp
from kungfu_tpu_torch.plan import topology as topo
from kungfu_tpu_torch.plan.graph import Graph
from kungfu_tpu_torch.plan.peer import PeerID, PeerList
from kungfu_tpu_torch.telemetry import audit, log
from kungfu_tpu_torch.telemetry import config as tconfig
from kungfu_tpu_torch.telemetry import decisions
from kungfu_tpu_torch.telemetry import link as tlink
from kungfu_tpu_torch.telemetry import metrics as tmetrics
from kungfu_tpu_torch.transport.client import Client
from kungfu_tpu_torch.transport.handlers import CollectiveEndpoint
from kungfu_tpu_torch.transport.message import ConnType, nbytes_of
from kungfu_tpu_torch.utils import trace
from kungfu_tpu_torch.utils.handoff import parallel_run as _par
from kungfu_tpu_torch.utils.stall import stall_detect

class _CollectiveScope:
    """Span (and, with metrics on, a latency-histogram observation)
    around one public collective, labelling the wire bytes its walks send
    with the collective's kind."""

    __slots__ = ("_sess", "_kind", "_span", "_t0", "_prev_kind")

    def __init__(self, sess: "HostSession", kind: str, nbytes: int):
        self._sess = sess
        self._kind = kind
        self._span = trace.span(f"collective.{kind}", bytes=int(nbytes), size=sess.size)

    def __enter__(self):
        self._t0 = time.perf_counter()
        # walks run on pool threads, so the label lives on the session;
        # rare concurrent collectives of different kinds may cross-label
        # a few bytes, which accounting tolerates
        self._prev_kind = self._sess._wire_kind
        self._sess._wire_kind = self._kind
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        self._sess._wire_kind = self._prev_kind
        hist = self._sess._coll_hist
        if hist is not None:
            hist.labels(self._kind).observe(time.perf_counter() - self._t0)
        return False


class HostSession(WalkEngine, WireCodec, GroupFusion):
    """One collective epoch over a fixed PeerList."""

    def __init__(
        self,
        strategy: Strategy,
        self_id: PeerID,
        peers: PeerList,
        client: Client,
        endpoint: CollectiveEndpoint,
        timeout: float = DEFAULT_TIMEOUT,
        cluster_version: int = 0,
    ):
        rank = peers.rank(self_id)
        if rank is None:
            raise ValueError(f"{self_id} not in peer list {peers}")
        self.self_id = self_id
        self.cluster_version = int(cluster_version)
        self.peers = peers
        self.rank = rank
        self.local_rank = peers.local_rank(self_id)
        self.local_size = peers.local_size(self_id)
        self.host_count = peers.host_count()
        self.client = client
        self.endpoint = endpoint
        self.timeout = timeout
        forced = algo_override()
        if forced is not None:
            strategy = forced
        if strategy == Strategy.AUTO:
            strategy = st.auto_select(peers)
        self.strategy = strategy
        self.global_strategies = st.gen_global_strategies(peers, strategy)
        self.local_strategies = st.gen_local_strategies(peers)
        self.cross_strategies = st.gen_cross_strategies(peers, strategy)
        # ring order for the cross-host segmented walk (hierarchical mode)
        self._masters, _ = peers.partition_by_host()
        # per-root star graph cache; sessions are rebuilt each epoch
        self._root_graphs: Dict[int, Tuple[Graph, Graph]] = {}
        # engine modes, resolved once per session epoch and agreed between
        # peers by check_knob_consensus
        self.wire_mode = wire_override()
        self.async_mode = knobs.get("KF_CONFIG_ASYNC")
        self.replan_mode = knobs.get("KF_CONFIG_REPLAN")
        self.demote_patience = int(knobs.get("KF_REPLAN_DEMOTE_PATIENCE"))
        self.zero_mode = knobs.get("KF_CONFIG_ZERO")
        # the adopted measured-topology plan: starts naive (None) and
        # changes only through the lockstep check_replan / check_demote /
        # adopt_replan rounds; a HierPlan also sets its flat projection
        self._ring_plan: Optional[rp.RingPlan] = None
        self._hier_plan: Optional[rp.HierPlan] = None
        self._demoted: Tuple[int, ...] = ()
        self._replan_seq = 0
        self._replan_listeners: List[object] = []
        # this worker's row of the measured link matrix (metrics gate)
        self._links = tlink.get_table() if tlink.enabled() else None
        # adaptive control (parity: session/adaptiveStrategies.go): a
        # deterministic candidate order — identical on every peer — so a
        # majority vote advances everyone in lockstep. Candidates are
        # (strategy, wire-mode) pairs: the first alternate toggles the
        # CODEC on the same graphs, then the strategies walk under the
        # configured codec, RING_SEGMENTED first. Graph lists are built
        # lazily: most sessions never adapt.
        wire_toggled = "off" if self.wire_mode != "off" else "bf16"
        self._candidates: List[Tuple[Strategy, str]] = (
            [(strategy, self.wire_mode), (strategy, wire_toggled)]
            + [
                (s, self.wire_mode) for s in (
                    Strategy.RING_SEGMENTED, Strategy.RING,
                    Strategy.BINARY_TREE_STAR, Strategy.STAR, Strategy.CLIQUE,
                ) if s != strategy
            ]
        )
        self._candidates_built: dict = {0: self.global_strategies, 1: self.global_strategies}
        self.adaptive = AdaptiveState(
            len(self._candidates),
            names=[f"{s.name}/{wm}" for s, wm in self._candidates],
        )
        self._tree_override = False
        # payload bytes this peer SENT into walks, by (public collective,
        # executing strategy, wire codec): the segmented engine's
        # bandwidth-optimality claim (2(k-1)/k N a peer) is held to it
        self.wire_bytes: Dict[Tuple[str, str, str], int] = {}
        self._wire_lock = threading.Lock()
        self._wire_kind = "raw"
        # telemetry, resolved once per session epoch: the per-collective
        # latency histogram (one observe per COLLECTIVE, not per message),
        # the registry twins of wire_bytes and the codec's savings
        metrics_on = tconfig.metrics_enabled()
        self._coll_hist = tmetrics.histogram(
            "kungfu_collective_latency_seconds",
            "Host-plane collective latency by kind",
            ("collective",),
        ) if metrics_on else None
        self._wire_ctr = tmetrics.counter(
            "kungfu_collective_wire_bytes_total",
            "Host-plane collective payload bytes sent by this peer",
            ("collective", "strategy", "codec"),
        ) if metrics_on else None
        self._wire_saved_ctr = tmetrics.counter(
            "kungfu_collective_wire_saved_bytes_total",
            "Wire bytes saved by the collective codec on this peer",
            ("collective", "codec"),
        ) if metrics_on else None
        # audit dedup: one codec-bypass event per (reason, dtype) and one
        # segmented-fallback event per session epoch
        self._codec_bypass_seen: set = set()
        self._segmented_fallback_noted = False
        self._in_fixed_walk = False
        # per-step ring spans: under KF_TELEMETRY=trace, thinned by the
        # deterministic sampler
        self._step_spans = tconfig.trace_enabled()
        self._span_sampler = SpanSampler(tconfig.span_sample())
        # error-feedback residual store of the quantized wire codec:
        # per-workspace f32 remainders, flushed on wire-mode changes; dies
        # with the session on elastic resize
        self._ef_store: Dict[str, torch.Tensor] = {}
        self._ef_mode: Optional[str] = None
        self._ef_flush_listeners: List[Callable[[str], None]] = []
        self._unknown_wire_warned: set = set()
        # monotone count of adopted precision flips: names the vote
        # workspaces and stamps the consensus digest of each switch
        self._precision_flips = 0
        # the async collective scheduler, created on first use and closed
        # with the epoch
        self._scheduler = None
        self._scheduler_lock = threading.Lock()
        self._epoch_closed = False
        # active-ring observability: this peer's position in the ring
        # order and its successor, the re-plan counter, the two-level role
        if metrics_on:
            self._ring_pos_g = tmetrics.gauge(
                "kungfu_topology_ring_position",
                "This peer's position in the active segmented-ring order "
                "(0-based; equals rank until a measured re-plan lands)",
            )
            self._ring_next_g = tmetrics.gauge(
                "kungfu_topology_ring_next",
                "The active ring successor of this peer (child per dst, "
                "value 1) — the edge every segmented send crosses",
                ("dst",),
            )
            self._replans_ctr = tmetrics.counter(
                "kungfu_topology_replans_total",
                "Measured-topology re-plans adopted by this peer's "
                "session epochs",
            )
            self._ring_role_g = tmetrics.gauge(
                "kungfu_topology_ring_role",
                "Active two-level plan role of this peer (child per "
                "(level, role), value = host-group index)",
                ("level", "role"),
            )
            self._wire_mode_g = tmetrics.gauge(
                "kungfu_collective_wire_mode",
                "Active wire-codec mode of this peer's collective "
                "session (child per mode, value 1 on the running one)",
                ("mode",),
            )
        else:
            self._ring_pos_g = self._ring_next_g = self._replans_ctr = None
            self._ring_role_g = self._wire_mode_g = None
        self._publish_ring_metrics()
        # collective-order sentinel: with the debug knob set, protowatch
        # wraps this instance's public entry points at bind time. Unset =
        # the module is never imported and the methods stay the plain
        # class functions
        self._protowatch = None
        if knobs.get("KF_DEBUG_PROTOCOL"):
            from kungfu_tpu_torch.devtools import protowatch

            protowatch.attach(self)

    def _candidate(self, idx: int) -> List[st.StrategyPair]:
        if idx not in self._candidates_built:
            self._candidates_built[idx] = st.gen_global_strategies(
                self.peers, self._candidates[idx][0])
        return self._candidates_built[idx]

    @property
    def size(self) -> int:
        return len(self.peers)

    # ------------------------------------------------------------------
    # async scheduler
    # ------------------------------------------------------------------

    def async_enabled(self) -> bool:
        """Whether this epoch runs asynchronous group collectives. `auto`
        resolves to on for multi-peer sessions. Cluster-agreed: the mode
        decides the fused rendezvous names, so it rides the knob
        consensus."""
        if self.async_mode == "on":
            return True
        if self.async_mode == "auto":
            return self.size >= 2
        return False

    def zero_enabled(self) -> bool:
        """Whether this epoch runs the ZeRO-1 sharded weight update.
        `auto` resolves to on for multi-peer sessions. Cluster-agreed like
        KF_CONFIG_ASYNC.

        The memory plane is consulted here but cannot flip the
        resolution: the knob consensus carries the mode string, not the
        resolved boolean, so two peers resolving `auto` from their own
        live RSS would pass the consensus check and deadlock on
        mismatched rendezvous dataflow. The consult is advisory: when
        `auto` resolves off (one peer) while this worker's measured
        headroom is at or below the pressure line, it logs that sharding
        would relieve the replicated optimizer state. The behavioural
        consumer of measured headroom is the elastic grow gate
        (`elastic/schedule.py`), where one decision maker is safe."""
        if self.zero_mode == "on":
            return True
        if self.zero_mode == "auto":
            on = self.size >= 2
            if not on and not getattr(self, "_zero_mem_advised", False):
                self._zero_mem_advised = True  # one advisory per session
                try:
                    from kungfu_tpu_torch.telemetry import log
                    from kungfu_tpu_torch.telemetry import memory as tmem

                    sig = tmem.get_plane().signals()
                    if sig.get("memory/pressure"):
                        log.warn(
                            "zero=auto resolved off (single peer) under "
                            "measured memory pressure (headroom %.0f%%): "
                            "replicated optimizer state is a candidate — "
                            "grow the cluster or set KF_CONFIG_ZERO=on "
                            "fleet-wide",
                            100.0 * float(sig.get("memory/headroom_frac", 0)),
                        )
                except Exception:  # noqa: BLE001 - an advisory never blocks the resolution
                    pass
            return on
        return False

    def scheduler(self):
        """The session's async collective scheduler, created on first
        use. Lives exactly as long as the session epoch: `Peer._update_to`
        calls :meth:`close` (drain) before replacing the session."""
        from kungfu_tpu_torch.collective.scheduler import CollectiveScheduler, SchedulerClosed

        with self._scheduler_lock:
            if self._scheduler is None:
                if self._epoch_closed:
                    # a fresh scheduler here would walk against a fenced
                    # transport token: the caller must re-fetch the
                    # CURRENT session
                    raise SchedulerClosed(
                        "session epoch closed — fetch the current session's scheduler")
                self._scheduler = CollectiveScheduler(self)
                if self._protowatch is not None:
                    from kungfu_tpu_torch.devtools import protowatch

                    protowatch.attach_scheduler(self._scheduler)
            return self._scheduler

    def close(self, timeout: Optional[float] = None) -> None:
        """End-of-epoch teardown: drain or cancel the async scheduler's
        in-flight buckets so nothing from this epoch keeps walking (or
        writing caller buffers) once the next session exists."""
        with self._scheduler_lock:
            sched = self._scheduler
            self._scheduler = None
            self._epoch_closed = True
        if sched is not None:
            sched.close(timeout=self.timeout if timeout is None else timeout)

    def _collected(self, kind: str, nbytes: int) -> _CollectiveScope:
        return _CollectiveScope(self, kind, nbytes)

    # ------------------------------------------------------------------
    # public collectives
    # ------------------------------------------------------------------

    def all_reduce(self, w: Workspace) -> None:
        with self._collected("all_reduce", w.recv.nbytes):
            with stall_detect(f"all_reduce({w.name})"):
                self._allreduce_ws(w)

    def reduce_scatter(self, w: Workspace,
                       cancel: Optional[threading.Event] = None) -> Tuple[int, int]:
        """Reduce-scatter half of the segmented ring walk: after it,
        ``w.recv`` holds the fully reduced OWNED segment — whose (begin,
        end) element bounds are returned — and partial sums elsewhere.
        Always raw f32-exact ((k-1)/k·N bytes per peer); k == 1 (and
        empty payloads) degrade to ``forward()`` with the whole array
        owned."""
        with self._collected("reduce_scatter", w.recv.nbytes):
            with stall_detect(f"reduce_scatter({w.name})"):
                self._run_segmented(w, cancel=cancel, phase="rs")
        return self.owned_bounds(w.recv.numel())

    def all_gather_shards(
        self,
        full: torch.Tensor,
        name: str,
        cancel: Optional[threading.Event] = None,
        allow_wire: bool = True,
        ef: Optional[torch.Tensor] = None,
    ) -> None:
        """Standalone segment all-gather: the caller placed this rank's
        shard into ``full``'s owned segment; the walk relays every segment
        around the ring until ``full`` is complete and identical on all
        peers — rs + this == all_reduce, bit for bit. With the wire codec
        active (and ``allow_wire``) eligible f32 payloads cross the
        transport encoded, each segment quantized once by its owner.
        ``ef``: a caller-owned residual sized to THIS RANK's owned segment
        (quantized modes only)."""
        ws = Workspace(send=full, recv=full, op=ReduceOp.SUM, name=name)
        wire = self._wire_codec_for(ws) if allow_wire else None
        with self._collected("all_gather", full.nbytes):
            with stall_detect(f"all_gather({name})"):
                self._run_segmented(ws, cancel=cancel, wire=wire, phase="ag", ef_owned=ef)

    def monitored_all_reduce(self, w: Workspace) -> None:
        """AllReduce + throughput accounting for the ACTIVE candidate
        (parity: KungfuMonitoredAllReduce + runMonitoredStrategies,
        session/monitoring.go:15-35): the only site feeding
        adaptive.current."""
        t0 = time.perf_counter()
        with self._collected("monitored_all_reduce", w.recv.nbytes):
            with stall_detect(f"monitored_all_reduce({w.name})"):
                self._allreduce_ws(w)
        self.adaptive.current.update(w.recv.nbytes, time.perf_counter() - t0)

    def check_interference(self, vote_tag: str = "") -> bool:
        """Majority vote on local interference suspicion; on a cluster-wide
        majority every peer advances to the next candidate in the same
        deterministic order. Returns True if the candidate switched.
        Parity: CheckInterference (session/adaptiveStrategies.go:61-121).
        Call at a step boundary."""
        if self._tree_override or len(self._candidates) < 2:
            return False
        suspect = self.adaptive.current.suspect_interference()
        votes_in = torch.tensor([1 if suspect else 0], dtype=torch.int32)
        votes_out = torch.zeros(1, dtype=torch.int32)
        self.all_reduce(Workspace(
            votes_in, votes_out, ReduceOp.SUM,
            f"kungfu::interference:{self.adaptive.switch_count}{vote_tag}"))
        if int(votes_out[0]) * 2 <= self.size:
            return False
        old_strategy, old_wire = self._candidates[self.adaptive.active]
        idx = self.adaptive.advance()
        self.global_strategies = self._candidate(idx)
        new_strategy, new_wire = self._candidates[idx]
        # safety: all peers must now run the same graphs AND wire format
        if not self.bytes_consensus(
            st.digest(self.global_strategies) + new_wire.encode(),
            f":switch:{self.adaptive.switch_count}",
        ):
            raise RuntimeError("strategy switch diverged across peers")
        self._publish_wire_mode()
        audit.record_event(
            "strategy_switch",
            peer=str(self.self_id),
            trigger="interference_vote",
            old_strategy=old_strategy.name,
            new_strategy=new_strategy.name,
            old_wire=old_wire,
            new_wire=new_wire,
            switch_count=self.adaptive.switch_count,
        )
        # the causal record, graded later against measured step times
        decisions.open_decision(
            "strategy_switch",
            peer=str(self.self_id),
            epoch=self.cluster_version,
            trigger="interference_vote",
            signals={"votes": int(votes_out[0]), "size": self.size},
            old=f"{old_strategy.name}/{old_wire}",
            new=f"{new_strategy.name}/{new_wire}",
        )
        return True

    def check_precision(self, proposal: Optional[str] = None, trigger: str = "noise_scale",
                        signals: Optional[dict] = None, vote_tag: str = "") -> Optional[str]:
        """Majority vote on the wire PRECISION of the active candidate:
        every peer calls in lockstep with its preferred mode (None keeps
        the current one); ballots are one-hot over WIRE_MODES, and a
        strict majority for a different mode flips the active candidate's
        wire member on EVERY peer. Returns the new mode, or None. The flip
        is digest-checked, flushes the error-feedback residuals, is
        audited (`precision_switch`, labelled by `trigger`) and opens a
        `precision_switch` decision record carrying `signals`."""
        if proposal is not None and proposal not in WIRE_MODES:
            raise ValueError(
                f"check_precision: unknown wire mode {proposal!r}; "
                f"expected one of {', '.join(WIRE_MODES)}")
        old_mode = self._active_wire_mode()
        want = proposal if proposal is not None else old_mode
        votes_in = torch.zeros(len(WIRE_MODES), dtype=torch.int32)
        votes_in[WIRE_MODES.index(want)] = 1
        votes_out = torch.zeros(len(WIRE_MODES), dtype=torch.int32)
        self.all_reduce(Workspace(votes_in, votes_out, ReduceOp.SUM,
                                  f"kungfu::precision:{self._precision_flips}{vote_tag}"))
        winner = None
        for i, mode in enumerate(WIRE_MODES):
            if mode != old_mode and int(votes_out[i]) * 2 > self.size:
                winner = mode
                break
        if winner is None:
            return None
        self._precision_flips += 1
        if self._tree_override:
            self.wire_mode = winner
        else:
            strategy = self._candidates[self.adaptive.active][0]
            self._candidates[self.adaptive.active] = (strategy, winner)
        if not self.bytes_consensus(winner.encode(), f":precision:{self._precision_flips}"):
            raise RuntimeError("precision switch diverged across peers")
        self._flush_residuals(f"precision vote {old_mode!r} -> {winner!r}")
        self._publish_wire_mode()
        audit.record_event(
            "precision_switch",
            peer=str(self.self_id),
            trigger=trigger,
            old_wire=old_mode,
            new_wire=winner,
            flip_count=self._precision_flips,
        )
        decisions.open_decision(
            "precision_switch",
            peer=str(self.self_id),
            epoch=self.cluster_version,
            trigger=trigger,
            signals=dict(signals or {}, votes=int(votes_out[WIRE_MODES.index(winner)]),
                         size=self.size),
            old=old_mode,
            new=winner,
        )
        return winner

    def active_strategy(self) -> Optional[Strategy]:
        """The running candidate strategy, or None under a set_tree
        override."""
        if self._tree_override:
            return None
        return self._candidates[self.adaptive.active][0]

    def active_candidate_name(self) -> str:
        """The running candidate: the strategy, suffixed with "/<codec>"
        when a wire codec is active; "SET_TREE" under a set_tree
        override."""
        s = self.active_strategy()
        if s is None:
            return "SET_TREE"
        wire = self._active_wire_mode()
        return s.name if wire == "off" else f"{s.name}/{wire}"

    def set_tree(self, fathers: Sequence[int]) -> None:
        """Install a runtime forest (e.g. an MST over probed latencies) as
        the active global strategy (parity: SetTree / SetGlobalStrategy,
        adaptation.cpp:5-33). Disables vote-driven switching until the
        next session epoch. The forest must be ONE tree rooted at rank 0:
        gather/reduce/broadcast walk global_strategies[0] assuming that
        root."""
        if len(fathers) != self.size:
            raise ValueError(f"forest size {len(fathers)} != cluster {self.size}")
        roots = [r for r, f in enumerate(fathers) if int(f) == r]
        if roots != [0]:
            raise ValueError(
                f"set_tree forest must be one tree rooted at rank 0, got roots {roots}")
        self.global_strategies = st.from_forest_array(list(fathers))
        self._tree_override = True

    def calc_stats(self) -> dict:
        """Per-strategy throughput summary (parity: CalcStats/LogStats)."""
        return self.adaptive.summary()

    # ------------------------------------------------------------------
    # measured-topology re-planning
    # ------------------------------------------------------------------

    def ring_plan(self) -> Optional[rp.RingPlan]:
        """The adopted measured-topology plan, or None for the naive
        rank-order ring with equal segments. Under a two-level plan this
        is its FLAT projection (``HierPlan.as_ring_plan``), the layout
        every flat consumer (ZeRO shard bounds, ring gauges, the
        segmented RS/AG legs) reads."""
        return self._ring_plan

    def hier_plan(self) -> Optional[rp.HierPlan]:
        """The adopted two-level plan, or None when the session runs a
        flat ring."""
        return self._hier_plan

    def demoted_peers(self) -> Tuple[int, ...]:
        """Ranks currently voted into the demoted (backup) role."""
        return self._demoted

    def _static_hosts(self) -> List[List[int]]:
        """The static host partition as rank groups: the clustering
        fallback when the measured matrix is not bimodal enough to
        derive host boundaries."""
        _, master_of = self.peers.partition_by_host()
        groups: Dict[int, List[int]] = {}
        for r in range(self.size):
            groups.setdefault(master_of[r], []).append(r)
        return [sorted(g) for _, g in sorted(groups.items())]

    def add_replan_listener(self, listener) -> None:
        """Register an object with ``pre_replan() -> token`` /
        ``post_replan(token)`` hooks, invoked around every plan adoption
        (the ZeRO-1 session registers itself: pre exports exact state
        under the OLD shard layout, post re-shards under the new)."""
        self._replan_listeners.append(listener)

    def _replan_name(self, kind: str) -> str:
        """Round-stamped rendezvous name of the lockstep re-plan rounds
        (version + per-epoch sequence, the reference's bytes): every
        member runs these rounds in lockstep, so the stamp agrees
        cluster-wide and repeats never cross-consume lanes."""
        return f"kungfu::replan:{kind}:v{self.cluster_version}:{self._replan_seq}"

    def measured_matrix(self):
        """Exchange every peer's outgoing link-table row and return the
        merged k×k bandwidth matrix (bytes/sec as a float64 numpy array;
        0 = no estimate), identical bytes on every peer by construction:
        one gather to rank 0 and one broadcast of the concatenation
        (``all_gather``), so the plan derivation downstream is a pure
        function of shared input. Collective: call in lockstep."""
        k = self.size
        row = torch.zeros(k, dtype=torch.float32)
        if self._links is not None:
            for j, pid in enumerate(self.peers):
                if j == self.rank:
                    continue
                bw = self._links.bandwidth(pid)
                if bw is not None and bw > 0:
                    row[j] = bw
        out = torch.zeros(k * k, dtype=torch.float32)
        self.all_gather(Workspace(send=row, recv=out, op=ReduceOp.SUM,
                                  name=self._replan_name("mx")))
        return out.reshape(k, k).to(torch.float64).numpy()

    def measured_compute_frac(self) -> float:
        """All-gather each peer's measured window CPU fraction (the
        resource plane's compute floor) and return the cluster MAX,
        identical on every peer like :meth:`measured_matrix`, so
        ``derive_plan``'s Amdahl clamp stays a pure function of shared
        input. 0.0 when nobody has a measurement (no clamp: missing data
        must never fabricate pessimism). One f32 a peer under the
        reference's name, so a mixed world runs one round. Collective:
        call in lockstep."""
        k = self.size
        mine = 0.0
        try:
            from kungfu_tpu_torch.telemetry import resource as _tres

            mine = max(0.0, min(1.0, _tres.get_plane().compute_frac()))
        # an unmeasurable local floor degrades to 0.0 (no clamp), never
        # kills the round: every peer still runs the all-gather below
        except Exception:  # noqa: BLE001
            pass
        send = torch.tensor([mine], dtype=torch.float32)
        out = torch.zeros(k, dtype=torch.float32)
        self.all_gather(Workspace(send=send, recv=out, op=ReduceOp.SUM,
                                  name=self._replan_name("cf")))
        return round(float(out.max()), 6)

    def check_replan(self, want: bool = True, min_gain: float = 1.05,
                     tag: str = "") -> Optional[rp.RingPlan]:
        """One lockstep re-plan round; call on EVERY peer at the same
        step boundary (``policy.ReplanPolicy`` gates on the step counter):

        1. a majority vote over each peer's local ``want``;
        2. on a majority, exchange the measured link rows
           (:meth:`measured_matrix`) and compute fractions — every peer
           now holds identical inputs;
        3. derive the plan (``plan.replan.derive_plan``, or
           ``derive_hier_plan`` under ``hier``) and adopt it via
           :meth:`adopt_replan` when it clears ``min_gain``.

        Returns the adopted (flat) plan, or None (no majority, no
        measurable win, mode off). ``_replan_seq`` advances on every
        branch, as the reference's does, so the next round's names agree
        in mixed worlds. ``KF_CONFIG_REPLAN`` is consensus-checked at
        session start, so either every peer runs these rounds or none
        does."""
        if self.replan_mode == "off" or self.size < 2 or self._tree_override:
            return None
        votes_in = torch.tensor([1 if want else 0], dtype=torch.int32)
        votes_out = torch.zeros(1, dtype=torch.int32)
        self._fixed_allreduce(Workspace(votes_in, votes_out, ReduceOp.SUM,
                                        self._replan_name("vote") + tag))
        if int(votes_out[0]) * 2 <= self.size:
            self._replan_seq += 1
            return None
        matrix = self.measured_matrix()
        compute_frac = self.measured_compute_frac()
        if self.replan_mode == "hier":
            # two-level mode: derive the hierarchy from the shared matrix;
            # on a single host group fall back to the flat measured ring
            # (every peer takes the same branch: the inputs are shared)
            hier = rp.derive_hier_plan(
                matrix, hosts=self._static_hosts(), mode=self.replan_mode,
                current=self._hier_plan, compute_frac=compute_frac,
                demoted=self._demoted)
            if hier is not None:
                if not self._hier_worthwhile(hier, min_gain):
                    self._replan_seq += 1
                    return None
                self.adopt_replan(hier)
                return self._ring_plan
            if self._hier_plan is not None:
                # the current hierarchy is still the best derivation
                self._replan_seq += 1
                return None
            plan = rp.derive_plan(matrix, mode="auto", current=self._ring_plan,
                                  compute_frac=compute_frac)
        else:
            plan = rp.derive_plan(matrix, mode=self.replan_mode, current=self._ring_plan,
                                  compute_frac=compute_frac)
        if plan is None or not self._replan_worthwhile(plan, min_gain):
            self._replan_seq += 1
            return None
        self.adopt_replan(plan)
        return plan

    def _hier_worthwhile(self, plan: rp.HierPlan, min_gain: float) -> bool:
        """Churn gate of two-level derivations: the FIRST hierarchy (or
        any change to the demoted set) is structural and always adopted;
        a re-derivation that merely reshuffles groups or heads must clear
        ``min_gain``."""
        cur = self._hier_plan
        if cur is None or plan.demoted != cur.demoted:
            return True
        return plan.gain >= min_gain

    def check_demote(self, demote: Optional[int] = None, promote: Optional[int] = None,
                     tag: str = "") -> Optional[rp.RingPlan]:
        """One lockstep demote/promote round, on EVERY peer at the same
        step boundary like :meth:`check_replan`. Each peer proposes at
        most one rank to demote into the backup role and one to promote
        back; a one-hot per-candidate SUM on the knob-independent star
        walk counts the proposals, candidates carried by a strict
        majority flip, and the changed demoted set re-derives the
        two-level plan from freshly exchanged matrix rows, adopted
        through :meth:`adopt_replan` (which opens a `peer_demoted` /
        `peer_promoted` record per flipped rank).

        Returns the adopted flat projection, or None when no candidate
        carried, the set did not change, or no hierarchy is derivable
        (demotion acts only under ``KF_CONFIG_REPLAN=hier``)."""
        if self.replan_mode != "hier" or self.size < 2 or self._tree_override:
            return None
        k = self.size
        ballot = torch.zeros(2 * k, dtype=torch.int32)
        if demote is not None and 0 <= int(demote) < k:
            ballot[int(demote)] = 1
        if promote is not None and 0 <= int(promote) < k:
            ballot[k + int(promote)] = 1
        counts = torch.zeros(2 * k, dtype=torch.int32)
        self._fixed_allreduce(Workspace(ballot, counts, ReduceOp.SUM,
                                        self._replan_name("demote") + tag))
        demotes = {r for r in range(k) if int(counts[r]) * 2 > k}
        promotes = {r for r in range(k) if int(counts[k + r]) * 2 > k}
        new_demoted = tuple(sorted((set(self._demoted) | demotes) - promotes))
        if new_demoted == self._demoted:
            self._replan_seq += 1
            return None
        matrix = self.measured_matrix()
        compute_frac = self.measured_compute_frac()
        hier = rp.derive_hier_plan(
            matrix, hosts=self._static_hosts(), mode=self.replan_mode,
            current=self._hier_plan, compute_frac=compute_frac, demoted=new_demoted)
        if hier is None:
            # not derivable with the new set (single host group, or a
            # host would lose its last head): the same branch everywhere
            self._replan_seq += 1
            return None
        self.adopt_replan(hier)
        return self._ring_plan

    def _replan_worthwhile(self, plan: rp.RingPlan, min_gain: float) -> bool:
        """Churn gate, a pure function of (current plan, derived plan): a
        REORDER must clear ``min_gain``; an order-preserving weight
        refinement must move some segment weight by ≥10% relative."""
        cur = self._ring_plan
        if cur is None or plan.order != cur.order:
            return plan.gain >= min_gain
        if plan.weights is None or cur.weights is None:
            return True  # weights appearing/disappearing is material
        return any(abs(n - o) > 0.1 * max(o, 1e-12)
                   for n, o in zip(plan.weights, cur.weights))

    def adopt_replan(self, plan) -> None:
        """Install ``plan`` (a :class:`RingPlan`, a :class:`HierPlan`, or
        None = back to the naive ring) as the active topology; call in
        lockstep on every peer at a step boundary (no walk in flight).

        The plan digest is asserted on the knob-INDEPENDENT star walk
        first: a peer whose matrix-fed derivation diverged gets a named
        RuntimeError here, never a rendezvous hang in a later walk whose
        segment bounds silently differ. Registered listeners bracket the
        swap (``pre_replan`` under the OLD plan, ``post_replan`` under
        the new). A HierPlan installs both itself (driving the two-level
        walk) and its flat projection, so every flat consumer re-shards
        through the same bracket, flat→hier flips included. The codec's
        error-feedback residuals are flushed: they index the old
        ownership."""
        seq = self._replan_seq
        self._replan_seq += 1
        digest = rp.plan_digest(plan)
        if not self._bytes_agree(digest, f":replan:adopt:v{self.cluster_version}:{seq}",
                                 self._fixed_allreduce):
            raise RuntimeError(
                "measured-topology re-plan diverged across peers: the ring plan must be "
                "a pure function of the exchanged link matrix, but this peer derived "
                f"{plan.describe() if plan is not None else 'naive'} (digest {digest.hex()}) "
                "and at least one peer derived something else — refusing to install "
                "mismatched segment bounds (walks would deadlock or corrupt); this is a "
                "determinism bug, not a transient")
        if isinstance(plan, rp.HierPlan):
            hier: Optional[rp.HierPlan] = plan
            flat: Optional[rp.RingPlan] = plan.as_ring_plan()
        else:
            hier, flat = None, plan
        tokens = [(listener, listener.pre_replan()) for listener in self._replan_listeners]
        old = self._ring_plan
        old_demoted = self._demoted
        self._ring_plan = flat
        self._hier_plan = hier
        self._demoted = hier.demoted if hier is not None else ()
        for listener, token in tokens:
            listener.post_replan(token)
        self._flush_residuals("replan adopted: segment ownership moved")
        self._publish_ring_metrics()
        if self._replans_ctr is not None:
            self._replans_ctr.inc()
        naive = list(range(self.size))
        old_order = list(old.order) if old is not None else naive
        new_order = list(flat.order) if flat is not None else naive
        gain = flat.gain if flat is not None else 1.0
        audit.record_event(
            "topology_replanned",
            peer=str(self.self_id),
            trigger="replan_vote",
            old_order=old_order,
            new_order=new_order,
            weighted=bool(flat is not None and flat.weights is not None),
            hier=hier is not None,
            demoted=list(self._demoted),
            predicted_gain=gain,
        )
        # the re-plan predicted a throughput ratio: this record measures
        # the realized one; demote/promote flips get records of their own
        decisions.open_decision(
            "topology_replanned",
            peer=str(self.self_id),
            epoch=self.cluster_version,
            trigger="replan_vote",
            predicted_gain=gain,
            old_order=",".join(str(r) for r in old_order),
            new_order=",".join(str(r) for r in new_order),
            weighted=bool(flat is not None and flat.weights is not None),
            hier=hier is not None,
        )
        for r in sorted(set(self._demoted) - set(old_demoted)):
            decisions.open_decision(
                "peer_demoted", peer=str(self.self_id), epoch=self.cluster_version,
                trigger="straggler_patience", predicted_gain=gain, demoted_rank=str(r))
        for r in sorted(set(old_demoted) - set(self._demoted)):
            decisions.open_decision(
                "peer_promoted", peer=str(self.self_id), epoch=self.cluster_version,
                trigger="straggler_recovered", predicted_gain=1.0, promoted_rank=str(r))

    def _publish_ring_metrics(self) -> None:
        """Refresh the active-ring gauges (position and successor edge)
        and the two-level role from the current plan; children are
        rebuilt so a re-plan never leaves the OLD successor edge frozen
        in the exposition."""
        if self._ring_pos_g is None:
            return
        order = (self._ring_plan.order if self._ring_plan is not None
                 else tuple(range(self.size)))
        pos = order.index(self.rank)
        succ = self.peers[order[(pos + 1) % self.size]] if self.size > 1 else None
        self._ring_pos_g.set(pos)
        self._ring_next_g.clear_children()
        if succ is not None:
            self._ring_next_g.labels(str(succ)).set(1)
        self._ring_role_g.clear_children()
        hier = self._hier_plan
        if hier is None:
            self._ring_role_g.labels("flat", "member").set(0)
        else:
            gi = hier.group_of(self.rank)
            if self.rank in hier.demoted:
                level, role = "intra", "demoted"
            elif self.rank == hier.heads[gi]:
                level, role = "inter", "head"
            else:
                level, role = "intra", "member"
            self._ring_role_g.labels(level, role).set(gi)
        self._publish_wire_mode()

    def _publish_wire_mode(self) -> None:
        """Refresh the active-precision gauge; children are rebuilt so a
        precision flip never leaves the OLD mode frozen at 1."""
        if self._wire_mode_g is None:
            return
        self._wire_mode_g.clear_children()
        self._wire_mode_g.labels(self._active_wire_mode()).set(1)

    def owned_bounds(self, count: int) -> Tuple[int, int]:
        """(begin, end) of the segment THIS rank owns fully reduced after
        a reduce-scatter of ``count`` elements, under the CURRENT ring
        plan: the one layout the walk engine, the ZeRO-1 shard views and
        the api helpers read, so a plan change re-shards every consumer
        through this function."""
        plan = self._ring_plan
        if plan is None:
            return topo.owned_segment_bounds(count, self.size, self.rank)
        return topo.owned_segment_bounds(count, self.size, self.rank,
                                         order=plan.order, weights=plan.weights)

    def cross_all_reduce(self, w: Workspace) -> None:
        """AllReduce across host masters only (hierarchical path): while
        RING_SEGMENTED is the ACTIVE strategy, masters run the segmented
        walk over the master ring; non-masters forward."""
        wire = self._wire_codec_for(w)
        with stall_detect(f"cross_all_reduce({w.name})"):
            if (
                self._segmented_active()
                and len(self._masters) >= 2
                and w.recv.nbytes >= self.SEGMENT_MIN_BYTES
            ):
                self._run_segmented(w, ranks=self._masters, wire=wire)
            else:
                self._run_strategies(w, self.cross_strategies, wire=wire)

    def local_reduce(self, w: Workspace) -> None:
        self._run_graphs(w, [self.local_strategies[0].reduce_graph])

    def local_broadcast(self, w: Workspace) -> None:
        self._run_graphs(w, [self.local_strategies[0].bcast_graph])

    def _root_star_graphs(self, root: int) -> Tuple[Graph, Graph]:
        """(bcast, reduce) star graphs rooted at `root`, cached on the
        session. Benign to race: both writers compute identical graphs."""
        pair = self._root_graphs.get(root)
        if pair is None:
            bcast = topo.gen_star_bcast_graph(self.size, root)
            pair = (bcast, topo.gen_default_reduce_graph(bcast))
            self._root_graphs[root] = pair
        return pair

    def reduce(self, w: Workspace, root: int = 0) -> None:
        """Reduce to `root`. Root 0 walks the configured strategy; other
        roots use a root-specific star."""
        if root == 0:
            self._run_graphs(w, [self.global_strategies[0].reduce_graph])
        else:
            self._check_root(root)
            self._run_graphs(w, [self._root_star_graphs(root)[1]])

    def broadcast(self, w: Workspace, root: int = 0) -> None:
        with self._collected("broadcast", w.recv.nbytes):
            if root == 0:
                self._run_graphs(w, [self.global_strategies[0].bcast_graph])
            else:
                self._check_root(root)
                self._run_graphs(w, [self._root_star_graphs(root)[0]])

    def _check_root(self, root: int) -> None:
        if not 0 <= root < self.size:
            raise ValueError(f"root {root} outside cluster of {self.size}")

    def subset_all_reduce(self, fathers: Sequence[int], w: Workspace) -> None:
        self._run_strategies(w, st.from_forest_array(list(fathers)))

    def all_reduce_with(self, fathers: Sequence[int], w: Workspace) -> None:
        """AllReduce on a runtime-supplied tree (parity: AllReduceWith)."""
        sl = st.from_forest_array(list(fathers)) if fathers else self.global_strategies
        self._run_strategies(w, sl)

    def barrier(self, tag: str = "") -> None:
        """Parity: session.go:98-113 (an allreduce of size bytes)."""
        k = len(self.peers)
        self.all_reduce(Workspace(
            send=torch.zeros(k, dtype=torch.uint8), recv=torch.zeros(k, dtype=torch.uint8),
            op=ReduceOp.SUM, name=f"kungfu::barrier{tag}"))

    def bytes_consensus(self, bs: bytes, name: str) -> bool:
        """True iff every peer supplied identical bytes (parity:
        session.go:126-157). 2 rounds: a MIN-allreduce of the packed
        (len, -len) int64 workspace, then of the two-lane (payload,
        255-payload) bytes — consensus iff min == max in both. Consensus
        lanes are never quantized (the codec is f32-only)."""
        return self._bytes_agree(bs, name, self.all_reduce)

    def _bytes_agree(self, bs: bytes, name: str, run: Callable[[Workspace], None]) -> bool:
        """The 2-round consensus algebra, parameterized over the allreduce
        runner so the knob consensus can use graphs that do not depend on
        the very knobs being checked."""
        n = len(bs)
        lens = torch.tensor([n, -n], dtype=torch.int64)
        out_len = torch.zeros(2, dtype=torch.int64)
        run(Workspace(lens, out_len, ReduceOp.MIN, f":consensus:len:{name}"))
        if int(out_len[0]) != -int(out_len[1]):
            return False
        if n == 0:
            return True
        x = torch.frombuffer(bytearray(bs), dtype=torch.uint8)
        lanes = torch.empty(2 * n, dtype=torch.uint8)
        lanes[:n] = x
        lanes[n:] = 255 - x
        out = torch.zeros(2 * n, dtype=torch.uint8)
        run(Workspace(lanes, out, ReduceOp.MIN, f":consensus:data:{name}"))
        return bool(torch.equal(out[:n], 255 - out[n:]))

    # ------------------------------------------------------------------
    # engine-knob consensus (fail fast instead of deadlocking)
    # ------------------------------------------------------------------

    def engine_knobs(self) -> List[Tuple[str, str]]:
        """The cluster-agreed engine knobs, as resolved BY THIS SESSION —
        the reference's 12 pairs in its order, so the consensus holds
        between the two packages. Local-only tuning (KF_CONFIG_GROUP_WINDOW)
        is deliberately excluded."""
        return [
            ("KF_CONFIG_ALGO", knobs.get("KF_CONFIG_ALGO")),
            ("KF_CONFIG_CHUNK_BYTES", str(CHUNK_BYTES)),
            ("KF_CONFIG_SEGMENT_MIN_BYTES", str(self.SEGMENT_MIN_BYTES)),
            ("KF_CONFIG_GROUP_BUCKET_BYTES", str(self.GROUP_BUCKET_BYTES)),
            ("KF_CONFIG_GROUP_FUSE_MIN", str(self.FUSE_MIN_TENSORS)),
            ("KF_CONFIG_WIRE", self.wire_mode),
            ("KF_CONFIG_WIRE_MIN_BYTES", str(self.WIRE_MIN_BYTES)),
            ("KF_WIRE_BLOCK", str(self.WIRE_BLOCK)),
            ("KF_CONFIG_ASYNC", self.async_mode),
            ("KF_CONFIG_ZERO", self.zero_mode),
            ("KF_CONFIG_REPLAN", self.replan_mode),
            ("KF_REPLAN_DEMOTE_PATIENCE", str(self.demote_patience)),
        ]

    def _fixed_allreduce(self, w: Workspace) -> None:
        """Allreduce over a rank-0 star, unchunked and uncompressed — a
        walk whose rendezvous names and message sizes depend on NOTHING
        the knobs control, so it completes even across knob-divergent
        peers. Marked as a deliberate graph walk: it must not trip the
        `segmented_fallback` audit meant for payloads that fell back from
        the segmented engine."""
        self._in_fixed_walk = True
        try:
            bcast, red = self._root_star_graphs(0)
            self._run_graphs(w, [red, bcast])
        finally:
            self._in_fixed_walk = False

    def check_knob_consensus(self) -> None:
        """Fail fast on engine-knob divergence: one consensus over the
        resolved knob tuple at session start, on the knob-independent
        star walk; on mismatch a per-knob round names WHICH knob
        diverged."""
        if self.size < 2:
            return
        resolved = self.engine_knobs()
        blob = ";".join(f"{k}={v}" for k, v in resolved).encode()
        if self._bytes_agree(blob, ":knobs", self._fixed_allreduce):
            return
        bad = [k for k, v in resolved
               if not self._bytes_agree(v.encode(), f":knob:{k}", self._fixed_allreduce)]
        mine = dict(resolved)
        names = ", ".join(bad) if bad else "engine knob tuple"
        raise RuntimeError(
            f"engine knob mismatch across peers: {names} — these KF_CONFIG_* "
            f"values decide rendezvous names and message sizes, so they MUST "
            f"be set identically fleet-wide (collectives would deadlock); "
            f"this peer ({self.self_id}) resolved "
            + ", ".join(f"{k}={mine[k]!r}" for k in (bad or mine)))

    def broadcast_bytes(self, bs: bytes, name: str, root: int = 0) -> bytes:
        """Broadcast variable-length bytes from `root` (two graph walks:
        length, then payload). Bootstraps the device plane — the analog of
        broadcasting the NCCL unique id over the CPU collective
        (gpu_collective.cpp:190-212) — on a fixed star, root-correct
        whatever the active strategy."""
        graph = self._root_star_graphs(root)[0]
        n_send = torch.tensor([len(bs) if self.rank == root else 0], dtype=torch.int64)
        n_recv = torch.zeros(1, dtype=torch.int64)
        self._run_graphs(Workspace(n_send, n_recv, ReduceOp.SUM, f"{name}:len"), [graph])
        n = int(n_recv[0])
        if n == 0:
            return b""
        if self.rank == root:
            send = torch.frombuffer(bytearray(bs), dtype=torch.uint8)
        else:
            send = torch.zeros(n, dtype=torch.uint8)
        recv = torch.zeros(n, dtype=torch.uint8)
        self._run_graphs(Workspace(send, recv, ReduceOp.SUM, f"{name}:data"), [graph])
        return recv.numpy().tobytes()

    def gather(self, w: Workspace, root: int = 0) -> None:
        """`root` receives everyone's send buffer into recv (rank-major);
        parity: runGather (session.go:195-221), arbitrary roots. Unequal
        per-peer counts are laid out by their true framed lengths."""
        self._check_root(root)
        if self.rank != root:
            with self._collected("gather", w.send.nbytes):
                self.client.send(self.peers[root], w.name, _buf(w.send), ConnType.COLLECTIVE)
                self._count_wire(w.send.nbytes, "STAR")
            return
        itemsize = w.send.element_size()
        with self._collected("gather", w.recv.nbytes):
            cancel = threading.Event()
            parts: List[Optional[torch.Tensor]] = [None] * len(self.peers)
            releases: List = [None] * len(self.peers)

            def recv_part(r: int, peer: PeerID) -> None:
                msg = self.endpoint.recv(peer, w.name, self.timeout)
                if cancel.is_set():
                    if msg.release is not None:
                        msg.release()
                    return
                parts[r] = _frombuffer(msg.data, w.send.dtype, nbytes_of(msg.data) // itemsize)
                releases[r] = msg.release

            jobs = []
            for r, peer in enumerate(self.peers):
                if r == self.rank:
                    parts[r] = w.send.reshape(-1)
                else:
                    jobs.append(lambda r=r, p=peer: recv_part(r, p))
            try:
                _par(jobs, self.timeout, cancel)
                off = 0
                for part in parts:
                    n = part.numel()
                    if off + n > w.recv.numel():
                        raise ValueError(
                            f"gather overflow: recv buffer {w.recv.numel()} < {off + n}")
                    w.recv[off:off + n].copy_(part)
                    off += n
                if off != w.recv.numel():
                    # a short contribution would silently shift later ranks
                    raise ValueError(
                        f"gather underflow: contributions fill {off} of {w.recv.numel()}")
            finally:
                parts.clear()
                for rel in releases:
                    if rel is not None:
                        rel()

    def all_gather(self, w: Workspace) -> None:
        """Gather to root then broadcast the concatenation (parity:
        AllGatherTransform, session.cpp:201-220)."""
        self.gather(w)
        self.broadcast(Workspace(send=w.recv, recv=w.recv, op=w.op, name=w.name + ":bcast"))

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

The async scheduler (`scheduler()`, `collective/scheduler.py`) lives
as long as the session epoch. Not ported yet: the measured-topology
re-plan and demotion rounds and the telemetry hooks (metrics, audit,
decision ledger; item 1e); the collective-order sentinel of
KF_DEBUG_PROTOCOL. The knobs that govern them are still resolved and
agreed between peers (`engine_knobs`), so a port peer and a reference
peer agree on every rendezvous name.
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
from kungfu_tpu_torch.collective.walks import (
    CHUNK_BYTES,
    DEFAULT_TIMEOUT,
    WalkEngine,
    _buf,
    _frombuffer,
    algo_override,
)
from kungfu_tpu_torch.plan import topology as topo
from kungfu_tpu_torch.plan.graph import Graph
from kungfu_tpu_torch.plan.peer import PeerID, PeerList
from kungfu_tpu_torch.telemetry import log
from kungfu_tpu_torch.transport.client import Client
from kungfu_tpu_torch.transport.handlers import CollectiveEndpoint
from kungfu_tpu_torch.transport.message import ConnType, nbytes_of
from kungfu_tpu_torch.utils import trace
from kungfu_tpu_torch.utils.handoff import parallel_run as _par
from kungfu_tpu_torch.utils.stall import stall_detect

_protowatch_warned = [False]


class _CollectiveScope:
    """Span around one public collective, labelling the wire bytes its
    walks send with the collective's kind."""

    __slots__ = ("_sess", "_kind", "_span", "_prev_kind")

    def __init__(self, sess: "HostSession", kind: str, nbytes: int):
        self._sess = sess
        self._kind = kind
        self._span = trace.span(f"collective.{kind}", bytes=int(nbytes), size=sess.size)

    def __enter__(self):
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
        if knobs.get("KF_DEBUG_PROTOCOL") and not _protowatch_warned[0]:
            _protowatch_warned[0] = True
            log.warn("KF_DEBUG_PROTOCOL is set, but the port has no collective-order "
                     "sentinel yet; sessions run without it")

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
        KF_CONFIG_ASYNC. (The reference's memory-plane advisory when
        `auto` resolves off is telemetry work, ROADMAP item 1e.)"""
        if self.zero_mode == "on":
            return True
        if self.zero_mode == "auto":
            return self.size >= 2
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
        idx = self.adaptive.advance()
        self.global_strategies = self._candidate(idx)
        new_wire = self._candidates[idx][1]
        # safety: all peers must now run the same graphs AND wire format
        if not self.bytes_consensus(
            st.digest(self.global_strategies) + new_wire.encode(),
            f":switch:{self.adaptive.switch_count}",
        ):
            raise RuntimeError("strategy switch diverged across peers")
        return True

    def check_precision(self, proposal: Optional[str] = None, trigger: str = "noise_scale",
                        signals: Optional[dict] = None, vote_tag: str = "") -> Optional[str]:
        """Majority vote on the wire PRECISION of the active candidate:
        every peer calls in lockstep with its preferred mode (None keeps
        the current one); ballots are one-hot over WIRE_MODES, and a
        strict majority for a different mode flips the active candidate's
        wire member on EVERY peer. Returns the new mode, or None. The flip
        is digest-checked and flushes the error-feedback residuals.
        (`trigger` and `signals` label the reference's decision record,
        which the port does not keep yet.)"""
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

    def owned_bounds(self, count: int) -> Tuple[int, int]:
        """(begin, end) of the segment THIS rank owns fully reduced after
        a reduce-scatter of ``count`` elements (the rank-order ring)."""
        return topo.owned_segment_bounds(count, self.size, self.rank)

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
        peers."""
        bcast, red = self._root_star_graphs(0)
        self._run_graphs(w, [red, bcast])

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

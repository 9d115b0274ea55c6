"""User-facing process API of the host plane, its synchronous part.

Port of `kungfu_tpu/api.py` (parity: srcs/python/kungfu/python/__init__.py:17-168)
— rank queries, host-plane collectives on torch tensors, trees, queues
and the p2p store — backed by the in-process `Peer` singleton.

A tensor on a CUDA card goes to the host through a pinned buffer of the
module's `BufferPool`, is reduced there, and comes back on its own device;
a CPU tensor is reduced in CPU memory. Results are new tensors of the
input's shape, dtype and device.

The asynchronous group allreduce (`group_all_reduce_async`,
`flush_async`) submits to the session's collective scheduler; a card's
tensor is staged by a copy that runs on, and the scheduler waits for its
event before reading it. `sharded_update_session` builds the ZeRO-1
update. `resize`, `propose_new_size`, `change_cluster` and
`last_resize_phases` drive and time the elastic resize protocol of
`Peer`. The telemetry surface: `trace_summary` totals the recorded
spans, `telemetry_dump`, `metrics_text` and `resize_audit` read the
process's telemetry, `get_peer_latencies`, `optimized_tree` and
`egress_rates` the network monitors; `monitored_all_reduce_array`,
`check_interference`, `active_strategy`, `active_candidate` and
`calc_stats` drive and read the adaptive strategy, and `check_replan`
runs one lockstep measured-topology re-plan round.
"""

from __future__ import annotations

import atexit
import threading
from typing import List, Optional, Sequence

import torch

from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.peer import finalize_default_peer, get_default_peer
from kungfu_tpu_torch.transport.message import ConnType as _ConnType
from kungfu_tpu_torch.utils.pool import BufferPool

atexit.register(finalize_default_peer)

_pinned: Optional[BufferPool] = None
_pinned_lock = threading.Lock()


def _pinned_pool() -> BufferPool:
    global _pinned
    with _pinned_lock:
        if _pinned is None:
            _pinned = BufferPool(pin_memory=True)
        return _pinned


def _host(x: torch.Tensor, copy: bool = True):
    """(flat host tensor, pinned buffer or None) for `x`: a CPU tensor is
    its own flat view; a card's tensor gets a pinned pool buffer, filled
    with its values when `copy` (the caller synchronizes before reading)."""
    if x.device.type == "cpu":
        return (x.contiguous().reshape(-1) if copy else torch.empty(x.numel(), dtype=x.dtype)), None
    buf = _pinned_pool().get(x.numel() * x.element_size())
    host = buf.view(x.dtype)
    if copy:
        host.copy_(x.reshape(-1), non_blocking=True)
    return host, buf


def _stage(xs: Sequence[torch.Tensor]):
    """Each tensor's host copy, ready to read."""
    srcs = [_host(x) for x in xs]
    if any(buf is not None for _, buf in srcs):
        torch.cuda.synchronize()  # the host walks read these buffers next
    return srcs


def _back(x: torch.Tensor, host: torch.Tensor, buf) -> torch.Tensor:
    """A result on the host as a tensor of x's shape on x's device; a
    pinned buffer goes back to the pool once the copy has ended."""
    if buf is None:
        return host.reshape(x.shape)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    out.reshape(-1).copy_(host, non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    _pinned_pool().put(buf)
    return out


def _release(staged) -> None:
    for _, buf in staged:
        if buf is not None:
            _pinned_pool().put(buf)


def current_rank() -> int:
    return get_default_peer().rank


def cluster_size() -> int:
    return get_default_peer().size


def current_local_rank() -> int:
    return get_default_peer().current_session().local_rank


def current_local_size() -> int:
    return get_default_peer().current_session().local_size


def host_count() -> int:
    return get_default_peer().current_session().host_count


def current_cluster_version() -> int:
    return get_default_peer().cluster_version


def uid() -> int:
    """(version, rank) packed; parity: python/__init__.py uid. Rank gets
    the low 32 bits."""
    p = get_default_peer()
    return (p.cluster_version << 32) | p.rank


def detached() -> bool:
    return get_default_peer().detached


def run_barrier() -> None:
    get_default_peer().current_session().barrier()


def all_reduce_array(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                     name: str = "user") -> torch.Tensor:
    """Host-plane allreduce of a tensor (on the CPU, or staged through a
    pinned buffer from its card)."""
    (src,) = _stage([x])
    dst = _host(x, copy=False)
    w = Workspace(send=src[0], recv=dst[0], op=op, name=f"kungfu::user::{name}")
    try:
        get_default_peer().current_session().all_reduce(w)
    finally:
        _release([src])
    return _back(x, *dst)


def group_all_reduce_arrays(xs, op: ReduceOp = ReduceOp.SUM, name: str = "group",
                            outs=None) -> List[torch.Tensor]:
    """Host-plane allreduce of a list of tensors, as one fused/windowed
    group op (the way the reference reduces a whole gradient set). Pass
    `outs` (CPU tensors of the inputs' sizes and dtypes) to reuse result
    buffers across steps; without it, results come back on each input's
    device."""
    if outs is None:
        dsts = [_host(x, copy=False) for x in xs]
    else:
        dsts = [(o, None) for o in _group_outs(xs, outs)]
    srcs = _stage(xs)
    ws = [Workspace(send=s[0], recv=d[0], op=op, name=f"kungfu::user::{name}:{i}")
          for i, (s, d) in enumerate(zip(srcs, dsts))]
    try:
        get_default_peer().current_session().group_all_reduce(ws)
    finally:
        _release(srcs)
    return [_back(x, *d) for x, d in zip(xs, dsts)]


class AsyncGroupResult:
    """Handle for one round of asynchronous group allreduce
    (:func:`group_all_reduce_async`): ``wait()`` blocks until every
    submitted tensor has been reduced and returns the results as tensors
    of the inputs' shapes on the inputs' devices (the ``outs`` tensors,
    reshaped, when given). With the scheduler off the group already ran
    INSIDE the submitting call, and ``wait()`` just returns the results."""

    def __init__(self, sess, xs, dsts, round_index=None, staged=()):
        self._sess = sess
        self._xs = xs
        self._dsts = dsts  # (flat host result, pinned buffer or None) per input
        self._staged = list(staged)  # the inputs' pinned copies, released at wait
        self._round = round_index  # scheduler round; None = ran synchronously
        self._done = round_index is None
        self._results: Optional[List[torch.Tensor]] = None

    def wait(self, timeout=None) -> List[torch.Tensor]:
        if not self._done:
            # round-aware: several handles of one round each call wait();
            # the first flushes, the rest see the round advanced
            self._sess.scheduler().flush_round(self._round, timeout=timeout)
            self._done = True
        if self._results is None:
            _release(self._staged)
            self._staged = []
            self._results = [_back(x, *d) for x, d in zip(self._xs, self._dsts)]
        return self._results


def _stage_async(x: torch.Tensor):
    """(flat host tensor, pinned buffer or None, ready event or None): a
    card's tensor copied into a pinned buffer by a copy the caller does
    not wait for; the event marks its end."""
    host, buf = _host(x)
    if buf is None:
        return host, None, None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(x.device))
    return host, buf, ev


def group_all_reduce_async(xs, op: ReduceOp = ReduceOp.SUM, name: str = "group",
                           outs=None) -> AsyncGroupResult:
    """Asynchronous host-plane group allreduce: each tensor is SUBMITTED
    to the session's collective scheduler as soon as this call sees it
    (buckets launch while the caller keeps computing), and the returned
    handle's ``wait()`` blocks only for the tail. Call once per tensor as
    gradients become ready, or with the whole set.

    ``(name, index)`` must be stable across steps: the first step's
    submission order is negotiated cluster-wide as the launch order, and
    every later step must submit the same set (in any order). Results are
    bit-identical to :func:`group_all_reduce_arrays` on the same inputs.
    With the scheduler off (``KF_CONFIG_ASYNC``) the group runs
    synchronously inside this call, under per-call wire names."""
    dsts = ([_host(x, copy=False) for x in xs] if outs is None
            else [(o, None) for o in _group_outs(xs, outs)])
    sess = get_default_peer().current_session()
    if not sess.async_enabled():
        # synchronous fallback, executed EAGERLY (callers of the
        # submit + flush_async() pattern never touch the handle). Each
        # call needs its OWN wire names: peers call in identical program
        # order, so the process-local sequence agrees
        with _async_seq_lock:
            seq = _async_seq[0]
            _async_seq[0] += 1
        srcs = _stage(xs)
        ws = [Workspace(send=s[0], recv=d[0], op=op,
                        name=f"kungfu::user::async:{name}:{i}@{seq}")
              for i, (s, d) in enumerate(zip(srcs, dsts))]
        try:
            sess.group_all_reduce(ws)
        finally:
            _release(srcs)
        return AsyncGroupResult(sess, xs, dsts)
    sched = sess.scheduler()
    staged = []
    for i, (x, d) in enumerate(zip(xs, dsts)):
        host, buf, ev = _stage_async(x)
        staged.append((host, buf))
        sched.submit(Workspace(send=host, recv=d[0], op=op,
                               name=f"kungfu::user::async:{name}:{i}", ready=ev))
    return AsyncGroupResult(sess, xs, dsts, round_index=sched.round_index(), staged=staged)


def flush_async(timeout=None) -> None:
    """End the current async round: block until every workspace submitted
    to the session's scheduler has completed (a no-op when the scheduler
    is off, unused this epoch, or the round is empty). Call once per
    training step."""
    sess = get_default_peer().current_session()
    if sess.async_enabled():
        sess.scheduler().flush(timeout=timeout)


_async_seq = [0]
_async_seq_lock = threading.Lock()


def _group_outs(xs, outs) -> List[torch.Tensor]:
    """Shared outs validation: contiguous CPU tensors, size- and
    dtype-matched — mismatches reach the native reduce as raw pointers,
    so they must fail here, not corrupt memory there."""
    if len(outs) != len(xs):
        raise ValueError(f"outs mismatch: {len(outs)} != {len(xs)}")
    for i, (o, x) in enumerate(zip(outs, xs)):
        if o.device.type != "cpu" or not o.is_contiguous():
            raise ValueError("outs tensors must be contiguous CPU tensors")
        if o.numel() != x.numel():
            raise ValueError(f"outs[{i}] size {o.numel()} != input size {x.numel()}")
        if o.dtype != x.dtype:
            raise ValueError(f"outs[{i}] dtype {o.dtype} != input dtype {x.dtype}")
    return [o.reshape(-1) for o in outs]


def reduce_scatter(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                   name: str = "user") -> torch.Tensor:
    """Reduce `x` across the cluster and return only this rank's owned
    1/k shard of the flattened tensor (the reduce-scatter half of the
    segmented ring, f32-exact). ``all_gather(reduce_scatter(x))`` ==
    ``all_reduce_array(x)`` bit for bit, flattened."""
    (src,) = _stage([x])
    out = torch.empty(x.numel(), dtype=x.dtype)
    w = Workspace(send=src[0], recv=out, op=op, name=f"kungfu::user::rs:{name}")
    try:
        b, e = get_default_peer().current_session().reduce_scatter(w)
    finally:
        _release([src])
    return out[b:e].clone().to(x.device)


def all_gather(shard: torch.Tensor, name: str = "user") -> torch.Tensor:
    """Standalone segment all-gather: every rank contributes its owned
    shard (the ``reduce_scatter`` layout) and receives the reassembled
    flat tensor, identical on all peers."""
    sess = get_default_peer().current_session()
    flat = shard.reshape(-1).to("cpu")
    # one int64 lane agrees the total element count (shard sizes differ
    # across ranks under the segment partition); exact, never compressed
    total = int(all_reduce_array(torch.tensor([flat.numel()], dtype=torch.int64),
                                 ReduceOp.SUM, f"agsz:{name}")[0])
    b, e = sess.owned_bounds(total)
    if flat.numel() != e - b:
        raise ValueError(
            f"all_gather shard has {flat.numel()} elements but rank {sess.rank} owns "
            f"[{b}:{e}) of {total} — shards must follow the reduce_scatter layout")
    full = torch.empty(total, dtype=flat.dtype)
    full[b:e] = flat
    sess.all_gather_shards(full, f"kungfu::user::ag:{name}")
    return full.to(shard.device)


def sharded_update_session(params, lr: float, momentum: float = 0.0, name: str = "zero",
                           restore_state: Optional[bytes] = None):
    """A :class:`~kungfu_tpu_torch.collective.zero.ShardedUpdateSession`
    over the current session: the ZeRO-1 sharded SGD update (reduce-scatter
    the gradients, update and hold optimizer state for only this rank's
    1/k shard, all-gather the updated weights). `params` are contiguous
    f32 tensors on the CPU or a card, updated in place."""
    from kungfu_tpu_torch.collective.zero import ShardedSGD, ShardedUpdateSession

    return ShardedUpdateSession(
        params, ShardedSGD(lr, momentum=momentum), name=name,
        session=get_default_peer().current_session(), restore_state=restore_state)


def broadcast_array(x: torch.Tensor, root: int = 0, name: str = "user") -> torch.Tensor:
    """Host-plane broadcast from `root` (arbitrary roots, parity: the
    reference's Broadcast op)."""
    (src,) = _stage([x])
    dst = _host(x, copy=False)
    w = Workspace(send=src[0], recv=dst[0], op=ReduceOp.SUM,
                  name=f"kungfu::user::bcast:{name}")
    try:
        get_default_peer().current_session().broadcast(w, root=root)
    finally:
        _release([src])
    return _back(x, *dst)


def gather_arrays(x: torch.Tensor, root: int = 0, name: str = "user"):
    """Host-plane gather of equal-shaped contributions to `root`; returns
    the (size, *x.shape) stack at the root (on x's device), None
    elsewhere (parity: Gather, arbitrary roots)."""
    sess = get_default_peer().current_session()
    (src,) = _stage([x])
    n = x.numel() * sess.size if sess.rank == root else 0
    recv = torch.empty(n, dtype=x.dtype)
    w = Workspace(send=src[0], recv=recv, op=ReduceOp.SUM,
                  name=f"kungfu::user::gather:{name}")
    try:
        sess.gather(w, root=root)
    finally:
        _release([src])
    if sess.rank != root:
        return None
    return recv.reshape((sess.size,) + tuple(x.shape)).to(x.device)


def all_reduce_int_max(x: int) -> int:
    out = all_reduce_array(torch.tensor([x], dtype=torch.int64), ReduceOp.MAX, "int-max")
    return int(out[0])


def consensus(data: bytes, name: str = "user") -> bool:
    return get_default_peer().current_session().bytes_consensus(data, name)


def resize(new_size: Optional[int] = None):
    """Resize the cluster; returns (changed, detached).

    With new_size=None, pulls the desired cluster from the config server
    (parity: resize_cluster_from_url); otherwise grows/shrinks to new_size.
    """
    p = get_default_peer()
    if new_size is None:
        return p.resize_cluster_from_url()
    return p.resize_cluster(new_size)


def propose_new_size(new_size: int) -> None:
    get_default_peer().propose_new_size(new_size)


def last_resize_phases() -> dict:
    """Per-phase ms breakdown of the most recent resize seen by this peer
    (wait_config / consensus / notify / update)."""
    return dict(get_default_peer().last_resize_phases)


def trace_summary(prefix: str = "") -> dict:
    """Total ms per hot-path span recorded in this process (transport
    send/recv, collective walks, worker start-up, elastic state sync),
    filtered by name prefix — parity: the reference compiles TRACE_SCOPE
    into its GPU hot paths (srcs/cpp/include/kungfu/utils/trace.hpp)."""
    from kungfu_tpu_torch.utils import trace

    return trace.summary_ms(prefix)


def telemetry_dump(prefix: str = "") -> dict:
    """Snapshot of the whole telemetry subsystem: Prometheus metrics
    text, Chrome-trace JSON, resize audit records and a per-span ms
    summary (see kungfu_tpu_torch.telemetry.dump)."""
    from kungfu_tpu_torch import telemetry

    return telemetry.dump(prefix)


def resize_audit() -> list:
    """The elastic resize audit records of this process, as dicts
    (old/new cluster, trigger, per-phase durations, progress)."""
    from kungfu_tpu_torch.telemetry import audit

    return [r.to_json() for r in audit.records(kind="resize")]


def metrics_text() -> str:
    """Prometheus text exposition of the process metrics registry — the
    same body the per-worker /metrics endpoint serves."""
    from kungfu_tpu_torch.telemetry import metrics

    return metrics.render()


def change_cluster(progress: int):
    """Reload-mode resize; returns (changed, detached_all)."""
    return get_default_peer().change_cluster(progress)


def monitored_all_reduce_array(x: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
                               name: str = "user") -> torch.Tensor:
    """Host-plane allreduce with throughput accounting feeding the
    adaptive controller (parity: MonitoredAllReduce op)."""
    (src,) = _stage([x])
    dst = _host(x, copy=False)
    w = Workspace(send=src[0], recv=dst[0], op=op, name=f"kungfu::monitored::{name}")
    try:
        get_default_peer().current_session().monitored_all_reduce(w)
    finally:
        _release([src])
    return _back(x, *dst)


def check_interference() -> bool:
    """Vote on interference; True if the cluster switched strategy
    (parity: check_interference, session/adaptiveStrategies.go:61-121).
    Call on every peer at the same step boundary."""
    return get_default_peer().current_session().check_interference()


def check_replan(want: bool = True, min_gain: float = 1.05) -> bool:
    """One lockstep measured-topology re-plan round: vote, exchange the
    link rows, derive, digest-check and adopt. Call on EVERY peer at the
    same step boundary (``policy.ReplanPolicy`` drives it on an
    interval); a no-op unless ``KF_CONFIG_REPLAN`` is on. True if a plan
    was adopted."""
    sess = get_default_peer().current_session()
    return sess.check_replan(want=want, min_gain=min_gain) is not None


def active_strategy():
    """The running adaptive candidate's Strategy (the enum), or None
    under a set_tree override."""
    return get_default_peer().current_session().active_strategy()


def active_candidate() -> str:
    """Display name of the running adaptive candidate: the strategy,
    suffixed with "/<codec>" when a wire codec is active; "SET_TREE"
    under a set_tree override."""
    return get_default_peer().current_session().active_candidate_name()


def calc_stats() -> dict:
    """Per-strategy throughput stats (parity: calc_stats/log_stats ops)."""
    return get_default_peer().current_session().calc_stats()


def get_peer_latencies(samples: int = 3) -> torch.Tensor:
    """RTT seconds to every peer (self = 0, unreachable = +inf), a
    float64 CPU tensor in rank order; parity: GetPeerLatencies op."""
    from kungfu_tpu_torch.monitor.latency import probe_peer_latencies

    p = get_default_peer()
    sess = p.current_session()
    return torch.from_numpy(probe_peer_latencies(p.client, list(sess.peers), sess.rank,
                                                 samples))


_latency_probe_seq: dict = {}  # cluster version -> probes this epoch


def optimized_tree(samples: int = 3) -> list:
    """Probe latencies, all-gather the rows into the full matrix, and
    return its MST's father array — identical on every peer (a
    deterministic MST over the same matrix), ready for set_tree. Call on
    every peer at the same step boundary."""
    from kungfu_tpu_torch.monitor.latency import latency_matrix_from_rows

    peer = get_default_peer()
    sess = peer.current_session()
    n = sess.size
    row = get_peer_latencies(samples)
    recv = torch.zeros(n * n, dtype=torch.float64)
    # back-to-back probes must not share a rendezvous name. The count is
    # PER CLUSTER VERSION, not process-lifetime: a joiner's process
    # starts at 0 while survivors have probed for epochs, and only within
    # one epoch do peers call in identical program order
    v = peer.cluster_version
    seq = _latency_probe_seq.get(v, 0)
    _latency_probe_seq[v] = seq + 1
    sess.all_gather(Workspace(send=row, recv=recv, op=ReduceOp.SUM,
                              name=f"kungfu::latency:v{v}:{seq}"))
    matrix = latency_matrix_from_rows(list(recv.numpy().reshape(n, n)))
    return minimum_spanning_tree(matrix)


def egress_rates() -> torch.Tensor:
    """Per-peer egress rates (bytes/s) in rank order, a float64 CPU
    tensor (parity: EgressRates op, ops/cpu/monitoring.cpp:5-22). All
    zeros unless monitoring is on (KF_CONFIG_ENABLE_MONITORING truthy or
    KF_TELEMETRY=metrics)."""
    from kungfu_tpu_torch.monitor.net import get_monitor

    sess = get_default_peer().current_session()
    return torch.tensor(get_monitor().egress_rates(list(sess.peers)), dtype=torch.float64)


def minimum_spanning_tree(weights) -> list:
    """Father array of the MST of a dense cost matrix (parity:
    MinimumSpanningTree op backed by the native Prim kernel)."""
    from kungfu_tpu_torch.plan.mst import minimum_spanning_tree as _mst

    return _mst(weights)


def set_tree(fathers) -> None:
    """Install a collective tree for the current epoch (parity: SetTree
    op); a resize reverts to the configured strategy."""
    get_default_peer().set_tree(fathers)


def get_neighbour(step: int) -> int:
    """Deterministic partner schedule: at step t, pair with the peer whose
    rank differs in bit position (t mod log2-ceiling); on non-power-of-two
    clusters an out-of-range partner falls back to the round-robin
    schedule, so the result is always a VALID peer and never self."""
    sess = get_default_peer().current_session()
    n, r = sess.size, sess.rank
    if n == 1:
        return 0
    bits = max(1, (n - 1).bit_length())
    partner = r ^ (1 << (step % bits))
    if partner < n:
        return partner
    # fallback: (r+1+k) % n with k <= n-2 can never wrap onto r
    return (r + 1 + step % (n - 1)) % n


def round_robin_peer(step: int) -> int:
    """Round-robin over the other peers (parity: RoundRobin op)."""
    sess = get_default_peer().current_session()
    n, r = sess.size, sess.rank
    if n == 1:
        return 0
    return (r + 1 + step % (n - 1)) % n


_queue_ids: dict = {}
_queue_lock = threading.Lock()


def new_queue(src: int, dst: int) -> int:
    """Allocate the next queue id for the (src, dst) peer pair (parity:
    NewQueue, ops/cpu/queue.cpp:7-44): both endpoints call new_queue in the
    same program order, so each side's local counter yields matching ids
    without wire traffic. Counters are scoped to the cluster epoch."""
    version = get_default_peer().cluster_version
    with _queue_lock:
        for k in [k for k in _queue_ids if k[0] != version]:
            del _queue_ids[k]  # only one epoch is ever live
        qid = _queue_ids.get((version, src, dst), 0)
        _queue_ids[(version, src, dst)] = qid + 1
        return qid


def _payload(data):
    """bytes, or a tensor's bytes as a uint8 CPU tensor (a card's tensor
    comes to the host)."""
    if isinstance(data, torch.Tensor):
        return data.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8)
    return bytes(data)


def queue_put(dst: int, qid: int, data) -> None:
    """Append to queue `qid` toward peer `dst` (parity: QueuePut,
    queue.cpp:47-83). `data` is bytes or a tensor (sent raw;
    per-connection FIFO order is the queue order). Wire names carry the
    cluster version, so a message left undrained across a resize is never
    popped by the next epoch's queue 0."""
    p = get_default_peer()
    sess = p.current_session()
    p.client.send(sess.peers[dst],
                  f"kungfu::queue:v{p.cluster_version}:{sess.rank}:{dst}:{qid}",
                  _payload(data), _ConnType.QUEUE)


def queue_get(src: int, qid: int, timeout: float = 30.0) -> bytes:
    """Blocking pop from queue `qid` fed by peer `src` (parity: QueueGet)."""
    p = get_default_peer()
    sess = p.current_session()
    return bytes(p.queue.get(sess.peers[src],
                             f"kungfu::queue:v{p.cluster_version}:{src}:{sess.rank}:{qid}",
                             timeout))


def save(name: str, data, version: Optional[int] = None) -> None:
    """Publish a blob (bytes or a tensor's bytes) to this peer's store
    (parity: SaveVariable). With a version, the blob is an immutable entry
    in the versioned store (GC window 3)."""
    p = get_default_peer()
    blob = _payload(data)
    if isinstance(blob, torch.Tensor):
        blob = blob.numpy().tobytes()
    if version is None:
        p.p2p.save(name, blob)
    else:
        p.p2p.save_version(version, name, blob)


def request(rank: int, name: str, version: "Optional[int | str]" = None) -> Optional[bytes]:
    """Fetch a blob from peer `rank`'s store (parity: RequestVariable).
    version: None = flat store; an int or "latest" = versioned store."""
    p = get_default_peer()
    sess = p.current_session()
    data = p.p2p.request(sess.peers[rank], name, version=version)
    return None if data is None else bytes(data)

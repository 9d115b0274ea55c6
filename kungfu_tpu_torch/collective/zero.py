"""ZeRO-1 sharded weight update on the ring.

Port of `kungfu_tpu/collective/zero.py` ("Automatic Cross-Replica
Sharding of Weight Update in Data-Parallel Training", arXiv:2004.13336),
replacing allreduce-then-replicated-update with:

1. **reduce-scatter** (the RS half of the segmented ring walk,
   ``HostSession.reduce_scatter``): each rank holds the fully reduced 1/k
   gradient segment it owns per ``plan.topology.owned_segment_bounds``,
   (k-1)/k·N bytes a peer, f32-exact;
2. the **optimizer update on only that shard**, with optimizer state and
   the f32 **master weights** held for that shard only;
3. an **all-gather of the updated weights**
   (``HostSession.all_gather_shards``, bf16 on the wire where the codec
   wins) back into every peer's parameters.

**Master weights.** The update applies to the f32 master of the owned
shard; the (possibly bf16-quantized) all-gather result is only the
cluster-identical mirror. With the codec off, mirror shard == master.

**Bit-identity contract.** For SGD with the codec off, the sharded step
is bit-identical to the replicated path: the RS half produces exactly the
partial sums of the full segmented allreduce, the update applies the same
elementwise f32 operations (each rounded on its own: no fused
multiply-add), and the all-gather relays exact f32 segments.

**Devices.** Parameters and gradients are torch tensors on the CPU or on
a card. The masters, optimizer state and the full-size mirror live on
the host; a card's gradients are copied into the pooled staging buffer
and the gathered mirror is copied back into the card's parameters.

**Scheduler integration.** With ``KF_CONFIG_ASYNC`` on, gradients are
submitted per tensor (:meth:`ShardedUpdateSession.submit_grad`) and this
object is the scheduler's *sharded-unit handler*: the scheduler drives
``pack → reduce_and_update → gather → scatter`` per bucket across its
stage threads; ``flush()`` returns once every shard updated and
``wait_params()`` waits for the weight all-gathers still in flight.

**Elastic resize.** Shard ownership is a function of k: call
:meth:`ShardedUpdateSession.export_state` BEFORE the resize (an exact
state all-gather; every peer leaves with the identical blob, byte for
byte the reference's) and rebuild on the new epoch with
``restore_state=blob``.

**Measured re-plan.** The session's owned bounds follow its adopted ring
plan (order and segment weights). The update session registers itself
as a replan listener: :meth:`ShardedUpdateSession.pre_replan` exports
the exact state under the OLD layout, :meth:`ShardedUpdateSession.post_replan`
re-slices every bucket's shard (masters, momentum, weight residual) to
the NEW bounds and restores it bit for bit — flat and flat → two-level
flips alike.
With metrics on, the session keeps `kungfu_sharded_update_state_bytes`
and `kungfu_sharded_update_seconds_total`. Its memory-plane accountant
reports the shard masters, the optimizer state and the full-size reduce
mirrors (each bucket's ``W``) under ``zero_state``, from the tensors'
sizes.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.serialize import pack_leaves, unpack_leaves
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.plan import topology as topo
from kungfu_tpu_torch.telemetry import config as tconfig
from kungfu_tpu_torch.telemetry import memory as tmemory
from kungfu_tpu_torch.telemetry import metrics as tmetrics
from kungfu_tpu_torch.utils import trace
from kungfu_tpu_torch.utils.pool import get_buffer_pool


def bucket_layout(sizes: Sequence[int], cap_bytes: int, itemsize: int = 4) -> List[List[int]]:
    """Greedy order-preserving packing of param indices into buckets of
    <= `cap_bytes`: THE bucket layout of the sharded update, shared by
    ShardedUpdateSession and the torch frontend's replicated state
    import/export (a pure function of the sizes and the cluster-agreed
    cap)."""
    out: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, n in enumerate(sizes):
        nbytes = int(n) * itemsize
        if cur and cur_bytes + nbytes > cap_bytes:
            out.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        out.append(cur)
    return out


class ShardedSGD:
    """SGD (optional momentum) over a contiguous f32 shard, the
    replicated path's formula ``g *= 1/k; buf = momentum·buf + g;
    p -= lr·buf``, each operation rounded in f32 on its own. State (the
    momentum buffer) exists for the SHARD only."""

    def __init__(self, lr: float, momentum: float = 0.0):
        self.lr = float(lr)
        self.momentum = float(momentum)

    def state_names(self) -> Tuple[str, ...]:
        """Deterministic state-leaf order (export/restore layout)."""
        return ("momentum",) if self.momentum else ()

    def init(self, n: int, device=None) -> Dict[str, torch.Tensor]:
        return {name: torch.zeros(n, dtype=torch.float32, device=device)
                for name in self.state_names()}

    def apply(self, params: torch.Tensor, grads: torch.Tensor,
              state: Dict[str, torch.Tensor], scale: float) -> None:
        """In-place update of the param shard; `grads` is staging and is
        consumed (mutated). `scale` is the gradient-averaging factor."""
        grads.mul_(scale)
        if self.momentum:
            buf = state["momentum"]
            buf.mul_(self.momentum)
            buf.add_(grads)
            grads = buf
        # a rounded product, then a rounded difference: the reference's
        # f32 multiply and subtract (sub_(alpha=) may fuse them)
        params.sub_(grads * self.lr)


class _ZeroItem:
    """One in-flight sharded bucket as it moves through the scheduler
    stages (or the synchronous step): the walk-naming identity plus the
    round's POOLED gradient staging buffer (the launcher may pack round
    r+1 while the walker still reduce-scatters round r's)."""

    __slots__ = ("zindex", "rnd", "tag", "gbuf", "garr")

    def __init__(self, zindex: int, rnd: int, tag: str, gbuf, garr):
        self.zindex = zindex
        self.rnd = rnd
        self.tag = tag  # "r" scheduler rounds / "s" sync rounds
        self.gbuf = gbuf
        self.garr = garr


class _Bucket:
    """One fused sharded-update bucket: contiguous members in param
    order, a persistent full-size host weight mirror W (the all-gather
    buffer), and the SHARD-ONLY master weights and optimizer state."""

    __slots__ = (
        "index", "names", "params", "sizes", "offsets", "total",
        "W", "ob", "oe", "master", "state", "settled", "wres",
    )

    def __init__(self, index: int, names, params, opt: ShardedSGD, bounds: Tuple[int, int]):
        self.index = index
        self.names = list(names)
        self.params = list(params)
        self.sizes = [p.numel() for p in self.params]
        self.offsets = [sum(self.sizes[:j]) for j in range(len(self.sizes))]
        self.total = int(sum(self.sizes))
        pin = any(p.is_cuda for p in self.params)
        self.W = torch.empty(self.total, dtype=torch.float32, pin_memory=pin)
        for j, p in enumerate(self.params):
            self.W[self.offsets[j]:self.offsets[j] + self.sizes[j]].copy_(p)
        # round-ordering gate for the mirror: round r's gather + scatter
        # read W while round r+1's update would write it
        self.settled = threading.Event()
        self.settled.set()
        self.ob, self.oe = bounds
        self.master = self.W[self.ob:self.oe].clone()
        self.state = opt.init(self.oe - self.ob)
        # error-feedback residual of the quantized weight all-gather
        self.wres = torch.zeros(self.oe - self.ob, dtype=torch.float32)

    def reshard_bounds(self, opt: ShardedSGD, bounds: Tuple[int, int]) -> None:
        """Re-slice this bucket's shard to new owned bounds (a measured
        re-plan moved the segment layout). The caller restores master and
        state contents from an exported full-state blob right after: the
        freshly sized tensors here are pure allocation."""
        self.ob, self.oe = bounds
        self.master = torch.empty(self.oe - self.ob, dtype=torch.float32)
        self.state = opt.init(self.oe - self.ob)
        self.wres = torch.zeros(self.oe - self.ob, dtype=torch.float32)

    def state_bytes(self) -> int:
        n = self.master.nbytes
        for t in self.state.values():
            n += t.nbytes
        return n


class ShardedUpdateSession:
    """Owner of the shard ↔ full-param mapping for one model's ZeRO-1
    update. `params` are 1-D contiguous f32 tensors (CPU or card) viewing
    the model weights; scatter writes the gathered results back into them
    in place. Buckets follow the param order under the cluster-agreed
    ``KF_CONFIG_GROUP_BUCKET_BYTES`` cap.

    Drive it synchronously (:meth:`step` per training step) or through
    the async scheduler (:meth:`submit_grad` per tensor, :meth:`flush` at
    step end, :meth:`wait_params` before the next forward)."""

    def __init__(self, params: Sequence[torch.Tensor], opt: ShardedSGD, name: str = "zero",
                 session=None, restore_state: Optional[bytes] = None):
        if session is None:
            from kungfu_tpu_torch.peer import get_default_peer

            session = get_default_peer().current_session()
        self.sess = session
        self.opt = opt
        self.name = name
        self._prefix = f"kungfu::zero:{name}"
        self._scale = 1.0 / session.size
        views: List[torch.Tensor] = []
        for i, p in enumerate(params):
            if p.dtype != torch.float32:
                raise ValueError(f"sharded update params must be float32, got {p.dtype} "
                                 f"at index {i}")
            if not p.is_contiguous():
                raise ValueError(f"sharded update params must be contiguous (param {i}) — "
                                 "scatter writes them back in place")
            views.append(p.detach().reshape(-1))
        if not views:
            raise ValueError("sharded update needs at least one param")
        self._views = views
        self._member_names = [f"{self._prefix}:{i}" for i in range(len(views))]
        self._buckets: List[_Bucket] = []
        self._member_bucket: Dict[str, Tuple[int, int]] = {}
        for idxs in bucket_layout([v.numel() for v in views], session.GROUP_BUCKET_BYTES):
            self._add_bucket([self._member_names[i] for i in idxs], [views[i] for i in idxs])
        if hasattr(session, "add_ef_flush_listener"):
            session.add_ef_flush_listener(self._reset_weight_residuals)
        if hasattr(session, "add_replan_listener"):
            session.add_replan_listener(self)
        self._sync_round = 0
        self._export_seq = 0
        self._lock = threading.Lock()
        if restore_state is not None:
            self._restore(restore_state)
        if tconfig.metrics_enabled():
            self._state_gauge = tmetrics.gauge(
                "kungfu_sharded_update_state_bytes",
                "Optimizer-held bytes of the ZeRO-1 sharded update on "
                "this peer (shard master weights + shard optimizer "
                "state) — ~1/k of the replicated path's full-size state",
            )
            self._update_ctr = tmetrics.counter(
                "kungfu_sharded_update_seconds_total",
                "Seconds spent in the shard-local optimizer update "
                "(the k-fold-reduced update FLOPs of ZeRO-1)",
            )
            self._state_gauge.set(self.state_bytes())
        else:
            self._state_gauge = self._update_ctr = None
        # memory plane: shard masters + optimizer state + the full-size
        # reduce mirrors, accounted weakly: the registry never pins a
        # session across an elastic resize
        tmemory.register_owner(f"zero:{name}", "zero_state", self,
                               lambda zs: zs.state_bytes() + sum(b.W.nbytes for b in zs._buckets))

    def _add_bucket(self, names, params) -> None:
        total = int(sum(p.numel() for p in params))
        b = _Bucket(len(self._buckets), names, params, self.opt, self._owned_bounds(total))
        for j, n in enumerate(names):
            self._member_bucket[n] = (b.index, j)
        self._buckets.append(b)

    def _owned_bounds(self, total: int) -> Tuple[int, int]:
        if hasattr(self.sess, "owned_bounds"):
            return self.sess.owned_bounds(total)
        return topo.owned_segment_bounds(total, self.sess.size, self.sess.rank)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def state_bytes(self) -> int:
        """Bytes of optimizer-held state on THIS peer (shard masters +
        shard optimizer state), ~1/k of the replicated path's."""
        return sum(b.state_bytes() for b in self._buckets)

    def total_elems(self) -> int:
        return sum(b.total for b in self._buckets)

    def bucket_count(self) -> int:
        return len(self._buckets)

    def _check_epoch(self) -> None:
        if getattr(self.sess, "_epoch_closed", False):
            raise RuntimeError(
                "sharded update session's epoch ended (elastic resize): "
                "export_state() BEFORE the resize and rebuild "
                "ShardedUpdateSession(restore_state=...) on the new session")

    def _grad_views(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(grads) != len(self._views):
            raise ValueError(f"expected {len(self._views)} gradients, got {len(grads)}")
        out = []
        for i, (g, p) in enumerate(zip(grads, self._views)):
            if g.dtype != torch.float32 or g.numel() != p.numel():
                raise ValueError(f"grad {i} mismatch: {g.dtype}/{g.numel()} vs param "
                                 f"float32/{p.numel()}")
            out.append(g.detach().reshape(-1))
        return out

    # ------------------------------------------------------------------
    # synchronous step path (KF_CONFIG_ASYNC off)
    # ------------------------------------------------------------------

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One synchronous ZeRO-1 step over the full gradient set (param
        order): per bucket pack → reduce-scatter → shard update → weight
        all-gather → scatter. Wire names carry a process-local round
        counter (peers call in identical program order)."""
        self._check_epoch()
        views = self._grad_views(grads)
        with self._lock:
            rnd = self._sync_round
            self._sync_round += 1
        for b in self._buckets:
            item = self._pack_into(b, rnd, "s", lambda n, j: views[int(n.rsplit(":", 1)[1])])
            self.reduce_and_update(item)
            self.gather(item)
            self.scatter(item)

    def _pack_into(self, b: _Bucket, rnd: int, tag: str, source) -> _ZeroItem:
        """Pack one bucket's gradients into a pooled host buffer (the one
        implementation behind the sync step and the scheduler's launcher:
        the sync-vs-async bit identity depends on identical staging).
        `source(name, j)` returns member j's gradient."""
        gbuf = get_buffer_pool().get(b.total * 4)
        garr = gbuf.view(torch.float32)
        for j, n in enumerate(b.names):
            off = b.offsets[j]
            garr[off:off + b.sizes[j]].copy_(source(n, j))
        return _ZeroItem(b.index, rnd, tag, gbuf, garr)

    # ------------------------------------------------------------------
    # async path (the scheduler drives the handler protocol below)
    # ------------------------------------------------------------------

    def submit_grad(self, i: int, grad: torch.Tensor) -> None:
        """Hand gradient `i` (param order) to the async scheduler as it
        becomes ready. `priority=i` pins the negotiated registration
        order to param order on every peer. `grad` is read when its bucket
        packs: it must stay unchanged until :meth:`flush` returns."""
        self._check_epoch()
        if i < 0 or i >= len(self._views):
            raise IndexError(f"param index {i} outside 0..{len(self._views) - 1}")
        g = grad.detach().reshape(-1)
        if g.dtype != torch.float32 or g.numel() != self._views[i].numel():
            raise ValueError(f"grad {i} mismatch: {g.dtype}/{g.numel()} vs param "
                             f"float32/{self._views[i].numel()}")
        self.sess.scheduler().submit(
            Workspace(send=g, recv=g, op=ReduceOp.SUM, name=self._member_names[i]),
            priority=i, handler=self)

    def flush(self, timeout: Optional[float] = None) -> None:
        """End the gradient round: returns once every bucket's shard has
        been reduced and updated; weight all-gathers may still walk."""
        self.sess.scheduler().flush(timeout=timeout)

    def wait_params(self, timeout: Optional[float] = None) -> None:
        """Block until every in-flight weight all-gather has landed in
        the params. Call before the next forward consumes them."""
        self.sess.scheduler().wait_gather(timeout=timeout)

    # ------------------------------------------------------------------
    # scheduler sharded-handler protocol
    # ------------------------------------------------------------------

    def plan_units(self, zero_keys) -> List[list]:
        """Map the scheduler's registered sharded keys onto this
        session's bucket layout: one launch unit per bucket, members in
        bucket (== param) order."""
        by_name = {k[0]: k for k in zero_keys}
        if len(by_name) != len(zero_keys):
            raise ValueError("duplicate sharded tensor names registered")
        expected = set(self._member_names)
        got = set(by_name)
        if expected != got:
            missing = sorted(expected - got)[:4]
            rogue = sorted(got - expected)[:4]
            raise ValueError(
                "registered sharded tensors do not match the "
                f"ShardedUpdateSession params (missing {missing}, "
                f"unexpected {rogue}) — submit every param's gradient "
                "exactly once per round through submit_grad")
        for k in zero_keys:
            bi, j = self._member_bucket[k[0]]
            if k[1] != self._buckets[bi].sizes[j]:
                raise ValueError(f"sharded tensor {k[0]!r} registered with size {k[1]} but "
                                 f"the param has {self._buckets[bi].sizes[j]}")
        return [[by_name[n] for n in b.names] for b in self._buckets]

    def pack(self, zindex: int, members: List[Workspace], rnd: int) -> _ZeroItem:
        """Launcher stage: pack the round's submitted gradients into a
        pooled staging buffer."""
        b = self._buckets[zindex]
        by_name = {}
        for w in members:
            bi, _ = self._member_bucket[w.name]
            if bi != zindex:
                raise ValueError(f"tensor {w.name!r} landed in bucket {zindex}, belongs to {bi}")
            by_name[w.name] = w.send
        with trace.span("zero.pack", bucket=zindex):
            return self._pack_into(b, rnd, "r", lambda n, j: by_name[n])

    def reduce_and_update(self, item: _ZeroItem,
                          cancel: Optional[threading.Event] = None) -> _ZeroItem:
        """Walker stage: reduce-scatter the bucket's gradients (raw f32),
        then run the optimizer on the owned shard's master and refresh the
        mirror shard from it. Waits for the PREVIOUS round's gather and
        scatter of this bucket to land first (the `settled` gate)."""
        b = self._buckets[item.zindex]
        ws = Workspace(send=item.garr, recv=item.garr, op=ReduceOp.SUM,
                       name=f"{self._prefix}:zrs:{item.tag}{item.rnd}:b{item.zindex}")
        ob, oe = self.sess.reduce_scatter(ws, cancel=cancel)
        if (ob, oe) != (b.ob, b.oe):
            raise RuntimeError(
                f"shard layout drift: walk owns [{ob}:{oe}), optimizer holds "
                f"[{b.ob}:{b.oe}) — owned_segment_bounds must be the single layout source")
        # abort-aware: a hard cancel must unblock this thread within one
        # poll, not after the whole walk timeout
        deadline = time.monotonic() + self.sess.timeout
        while not b.settled.wait(0.2):
            if cancel is not None and cancel.is_set():
                raise TimeoutError(f"sharded update cancelled: bucket {b.index}")
            if time.monotonic() >= deadline:
                raise TimeoutError(f"bucket {b.index}'s previous weight all-gather never "
                                   "landed — cannot start the next shard update")
        if cancel is not None and cancel.is_set():
            raise TimeoutError(f"sharded update cancelled: bucket {b.index}")
        t0 = time.perf_counter()
        with trace.span("zero.update", bucket=item.zindex, elems=int(b.oe - b.ob)):
            self.opt.apply(b.master, item.garr[b.ob:b.oe], b.state, self._scale)
            b.W[b.ob:b.oe].copy_(b.master)
        b.settled.clear()
        if self._update_ctr is not None:
            self._update_ctr.inc(time.perf_counter() - t0)
        get_buffer_pool().put(item.gbuf)
        item.gbuf = item.garr = None
        return item

    def gather(self, item: _ZeroItem, cancel: Optional[threading.Event] = None) -> _ZeroItem:
        """Gather stage: all-gather the bucket's updated weights around
        the ring (bf16 on the wire when the codec wins)."""
        b = self._buckets[item.zindex]
        self.sess.all_gather_shards(
            b.W, f"{self._prefix}:zag:{item.tag}{item.rnd}:b{item.zindex}",
            cancel=cancel, ef=b.wres)
        return item

    def scatter(self, item: _ZeroItem, cancel: Optional[threading.Event] = None) -> None:
        """Unpack stage: copy the gathered weights into the caller's
        params (to the card for a card's params), then release the
        bucket's `settled` gate. A set `cancel` skips the write: the
        epoch is ending and a late scatter must not race the caller."""
        if cancel is not None and cancel.is_set():
            return
        b = self._buckets[item.zindex]
        with trace.span("zero.scatter", bucket=item.zindex):
            for j, p in enumerate(b.params):
                off = b.offsets[j]
                p.copy_(b.W[off:off + b.sizes[j]])
        b.settled.set()

    # ------------------------------------------------------------------
    # elastic re-shard (resize support)
    # ------------------------------------------------------------------

    def export_state(self) -> bytes:
        """One-shot EXACT state all-gather: the full master weights and
        full optimizer state from every peer's shards, serialized. Every
        peer leaves with the identical blob. Never wire-compressed. Call
        at a step boundary (after ``flush()`` + ``wait_params()``)."""
        self._check_epoch()
        with self._lock:
            seq = self._export_seq
            self._export_seq += 1
        leaves: List[torch.Tensor] = []
        for b in self._buckets:
            for li, name in enumerate(("master",) + self.opt.state_names()):
                full = torch.zeros(b.total, dtype=torch.float32)
                full[b.ob:b.oe] = b.master if name == "master" else b.state[name]
                self.sess.all_gather_shards(full, f"{self._prefix}:state:{seq}:b{b.index}:{li}",
                                            allow_wire=False)
                leaves.append(full)
        return pack_leaves(leaves)

    def _reset_weight_residuals(self, reason: str) -> None:
        """Session ef-flush hook: zero every bucket's weight all-gather
        residual, deterministically on every peer."""
        for b in self._buckets:
            b.wres.zero_()

    # ------------------------------------------------------------------
    # measured-topology re-plan hooks
    # ------------------------------------------------------------------

    def pre_replan(self) -> bytes:
        """Replan-listener hook, called by ``HostSession.adopt_replan``
        BEFORE the plan swap (in lockstep on every peer, at a step
        boundary): quiesce in-flight weight all-gathers, then export the
        full exact state under the OLD shard layout."""
        if self.sess._scheduler is not None:
            self.wait_params()
        return self.export_state()

    def post_replan(self, blob: bytes) -> None:
        """Replan-listener hook, called AFTER the plan swap: re-slice
        every bucket's shard to the session's NEW owned bounds and
        restore masters and state from the pre-swap export — bit-exact
        re-sharding, the contract of an elastic resize without changing
        k."""
        for b in self._buckets:
            b.reshard_bounds(self.opt, self._owned_bounds(b.total))
        self._restore(blob)
        if self._state_gauge is not None:
            self._state_gauge.set(self.state_bytes())

    def _restore(self, blob: bytes) -> None:
        per_bucket = 1 + len(self.opt.state_names())
        leaves = unpack_leaves(blob, per_bucket * len(self._buckets))
        it = iter(leaves)
        for b in self._buckets:
            for name in ("master",) + self.opt.state_names():
                full = next(it).to(torch.float32).reshape(-1)
                if full.numel() != b.total:
                    raise ValueError(
                        f"restore_state bucket {b.index} leaf {name!r} has {full.numel()} "
                        f"elements, expected {b.total} — param set or bucket knobs changed "
                        "across the resize")
                if name == "master":
                    # the exported masters ARE the true f32 weights: they
                    # refresh the mirror and the caller's params
                    b.W.copy_(full)
                    b.master = full[b.ob:b.oe].clone()
                    for j, p in enumerate(b.params):
                        off = b.offsets[j]
                        p.copy_(b.W[off:off + b.sizes[j]])
                else:
                    b.state[name].copy_(full[b.ob:b.oe])

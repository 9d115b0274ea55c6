"""Policy engine: lifecycle hooks driving adaptation decisions.

Port of `kungfu_tpu/policy.py` (capability parity:
srcs/python/kungfu/tensorflow/policy/{base_policy,policy_hook}.py — a
BasePolicy gets before/after train/epoch/step callbacks; the runner
tracks trained samples and a mutable batch size and stops when this
worker is detached, policy_hook.py:8-77). Framework-agnostic: drive it
from any PyTorch training loop.

The monitor→adapt loop: each step the runner publishes this worker's
step timing into the telemetry registry (``kungfu_steps_total`` +
``kungfu_step_duration_seconds``), feeds the step's wall-clock duration
to the decision ledger (the measurement every adaptation's realized
gain is computed from), and pulls the measured signals back into
``PolicyContext.metrics`` for the policies:

- the link table: ``links/min_bw`` + ``links/slowest_edge`` (this
  worker's own outgoing row);
- the walk profiler: ``collective/efficiency`` +
  ``collective/wait_frac``;
- the step plane: ``step/overlap_frac`` + ``step/queue_delay_frac``
  (this worker's own recent timelines);
- the decision ledger: ``decision/last_kind`` +
  ``decision/last_realized_gain`` + ``decision/regressed``;
- the resource plane: ``resource/cpu_frac`` + ``resource/engine_frac`` +
  ``resource/saturated`` (this worker's per-thread CPU attribution);
- the memory plane: ``memory/headroom_frac`` + ``memory/pressure`` +
  ``memory/leak_suspect`` (this worker's byte attribution and headroom);
- ``monitor.cluster_health()``: the runner aggregator's ``cluster/*``
  signals (straggler flags, scores and causes, ``cluster/updated_at``)
  plus its cluster-wide ``step/*`` election (``step/critical_peer``,
  ``step/critical_edge``), ``resource/saturated_peers`` and
  ``memory/min_headroom_peer`` + ``memory/min_headroom_frac``; its
  values override the local ones on the shared ``step/*``,
  ``resource/*`` and ``memory/*`` keys.

:class:`ReplanPolicy` votes measured-topology re-plans and demotions
through the session's lockstep rounds, :class:`PrecisionPolicy` votes
the wire precision, :class:`StragglerPolicy` acts on the cluster's
straggler flags.

The reference reads every worker-local plane inside one ``try``; the
port reads each plane on its own, so one that fails can never take the
link signals down with it.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.telemetry import log


class BasePolicy:
    def before_train(self, ctx: "PolicyContext") -> None: ...

    def after_train(self, ctx: "PolicyContext") -> None: ...

    def before_epoch(self, ctx: "PolicyContext") -> None: ...

    def after_epoch(self, ctx: "PolicyContext") -> None: ...

    def before_step(self, ctx: "PolicyContext") -> None: ...

    def after_step(self, ctx: "PolicyContext") -> None: ...


class PolicyContext:
    """Mutable training-run state shared with policies."""

    def __init__(self, batch_size: int, total_samples: Optional[int] = None):
        self.batch_size = batch_size
        self.total_samples = total_samples
        self.trained_samples = 0
        self.epoch = 0
        self.step = 0
        self.metrics: dict = {}
        self.stopped = False

    def request_stop(self) -> None:
        self.stopped = True


class PolicyRunner:
    """Drives policies through a training loop.

    with PolicyRunner([p1, p2], batch_size=64) as runner:
        for epoch in ...:
            with runner.epoch():
                for batch in ...:
                    with runner.step():
                        train(batch)
                    if runner.ctx.stopped: ...
    """

    # refresh cluster signals into ctx.metrics at most this often; the
    # underlying fetch is TTL-cached too, so a step costs a float compare
    CLUSTER_SIGNAL_PERIOD = 2.0

    def __init__(self, policies: List[BasePolicy], batch_size: int,
                 total_samples: Optional[int] = None):
        self.policies = policies
        self.ctx = PolicyContext(batch_size, total_samples)
        self._step_t0 = 0.0
        self._signals_at = 0.0
        # step-time publication: the per-worker series behind the cluster
        # plane's straggler detection; gated once, zero-cost when off
        self._m_steps = self._m_step_hist = None
        from kungfu_tpu_torch.telemetry import config as _tcfg

        if _tcfg.metrics_enabled():
            from kungfu_tpu_torch.telemetry import metrics as _tm

            self._m_steps = _tm.counter(
                "kungfu_steps_total",
                "Training steps completed by this worker",
            )
            self._m_step_hist = _tm.histogram(
                "kungfu_step_duration_seconds",
                "Wall-clock duration of each training step",
            )

    # the signal keys this runner refreshes, the reference's list: a
    # source that went quiet must take its stale values with it
    SIGNAL_KEYS = (
        "links/min_bw", "links/slowest_edge",
        "collective/efficiency", "collective/wait_frac",
        "step/overlap_frac", "step/queue_delay_frac",
        "step/critical_peer", "step/critical_edge",
        "decision/last_kind", "decision/last_realized_gain",
        "decision/regressed",
        "resource/cpu_frac", "resource/engine_frac",
        "resource/saturated", "resource/saturated_peers",
        "memory/headroom_frac", "memory/pressure",
        "memory/leak_suspect", "memory/min_headroom_peer",
        "memory/min_headroom_frac",
    )

    def _pull_cluster_signals(self) -> None:
        """Merge the link-table, walk-profiler, step-plane,
        decision-ledger, resource-plane and memory-plane signals, then
        the cluster's, into ctx.metrics
        (throttled). The previous refresh's
        values are evicted FIRST: a source that went quiet (e.g. the only
        estimated peer departed and was pruned) returns {} and must take
        its stale signals with it — a frozen links/min_bw steering
        re-planning hours later is the staleness LinkTable.prune exists
        to prevent. Each plane is read on its own, so one that fails
        never drops the others. The cluster's health signals come last:
        its cluster-wide values override the worker-local ones on the
        shared ``step/*``, ``resource/*`` and ``memory/*`` keys."""
        now = time.monotonic()
        if now - self._signals_at < self.CLUSTER_SIGNAL_PERIOD:
            return
        self._signals_at = now
        for key in self.SIGNAL_KEYS:
            self.ctx.metrics.pop(key, None)
        from kungfu_tpu_torch import monitor
        from kungfu_tpu_torch.collective.profiler import get_walk_profiler
        from kungfu_tpu_torch.telemetry import decisions as _tdec
        from kungfu_tpu_torch.telemetry import link as _link
        from kungfu_tpu_torch.telemetry import memory as _tmem
        from kungfu_tpu_torch.telemetry import resource as _tres
        from kungfu_tpu_torch.telemetry import steptrace as _steptrace

        for name, read in (
                ("link table", lambda: _link.get_table().signals() if _link.enabled() else {}),
                ("walk profiler", lambda: get_walk_profiler().signals()),
                ("step plane", lambda: _steptrace.get_store().local_signals()),
                ("decision ledger", lambda: _tdec.get_ledger().signals()),
                ("resource plane", lambda: _tres.get_plane().signals()),
                ("memory plane", lambda: _tmem.get_plane().signals()),
                ("cluster health", lambda: monitor.cluster_health())):
            try:
                self.ctx.metrics.update(read())
            except Exception as e:  # noqa: BLE001 - telemetry must never kill training
                log.debug("policy: %s signal refresh failed: %s", name, e)

    def __enter__(self):
        for p in self.policies:
            p.before_train(self.ctx)
        return self

    def __exit__(self, *exc):
        for p in self.policies:
            p.after_train(self.ctx)
        return False

    def epoch(self):
        return _Scope(
            enter=lambda: [p.before_epoch(self.ctx) for p in self.policies],
            exit=lambda: (
                [p.after_epoch(self.ctx) for p in self.policies],
                setattr(self.ctx, "epoch", self.ctx.epoch + 1),
            ),
        )

    def step(self):
        def before():
            self._step_t0 = time.perf_counter()
            for p in self.policies:
                p.before_step(self.ctx)

        def after():
            dt = time.perf_counter() - self._step_t0
            if self._m_steps is not None:
                self._m_steps.inc()
                self._m_step_hist.observe(dt)
            # the decision ledger: the per-step durations are what every
            # adaptation's realized gain is computed from — fire-and-
            # forget, a deque append when no decision is measuring
            from kungfu_tpu_torch.telemetry import decisions as _tdec

            _tdec.note_step(dt)
            self._pull_cluster_signals()
            self.ctx.trained_samples += self.ctx.batch_size
            self.ctx.step += 1
            for p in self.policies:
                p.after_step(self.ctx)
            try:
                from kungfu_tpu_torch import api

                if api.detached():
                    self.ctx.request_stop()
            except Exception as e:  # noqa: BLE001 - detach check is advisory
                log.debug("policy: detach check failed: %s", e)
            if (
                self.ctx.total_samples is not None
                and self.ctx.trained_samples >= self.ctx.total_samples
            ):
                self.ctx.request_stop()

        return _Scope(enter=before, exit=after)


class StragglerPolicy(BasePolicy):
    """Adaptation on cluster skew: when the cluster plane flags the same
    straggler for `patience` consecutive signal refreshes, invoke
    `on_straggler(ctx, peers)` — typically an `api.resize(size-1)` to
    shed the slow peer, or a strategy switch away from topologies rooted
    on it. The default action just records the decision in ctx.metrics
    (``cluster/straggler_action_pending``) so embedders can act in the
    training loop, where collective calls are safe.
    """

    def __init__(
        self,
        patience: int = 3,
        on_straggler: Optional[Callable[["PolicyContext", List[str]], None]] = None,
    ):
        self.patience = patience
        self.on_straggler = on_straggler
        self._seen: dict = {}  # peer -> consecutive flags
        self._last_update = None

    def after_step(self, ctx: "PolicyContext") -> None:
        flagged = ctx.metrics.get("cluster/stragglers")
        if flagged is None:
            return
        # count once per signal REFRESH, not once per step (steps are
        # orders of magnitude faster than scrapes). The refresh marker
        # is cluster/updated_at — a steady straggler produces identical
        # flag lists every refresh, so content can't mark freshness.
        update = ctx.metrics.get("cluster/updated_at")
        if update is not None and update == self._last_update:
            return
        self._last_update = update
        self._seen = {
            p: self._seen.get(p, 0) + 1 for p in flagged
        }
        persistent = sorted(
            p for p, n in self._seen.items() if n >= self.patience
        )
        if not persistent:
            return
        if self.on_straggler is not None:
            self.on_straggler(ctx, persistent)
        else:
            ctx.metrics["cluster/straggler_action_pending"] = persistent
        self._seen = {p: 0 for p in self._seen}


class ReplanPolicy(BasePolicy):
    """Measured-topology re-planning policy:
    watches the measured network signals — ``links/slowest_edge`` /
    ``links/min_bw`` from the link plane and ``step/critical_edge`` from
    the step plane — and, when the SAME edge keeps being named for
    ``patience`` consecutive signal refreshes, votes to re-derive the
    ring from the measured matrix via ``HostSession.check_replan``.

    The check itself is a lockstep collective round, so it runs every
    ``interval_steps`` steps ON EVERY PEER regardless of this peer's
    local suspicion (peers that see nothing vote no; the majority
    decides — the same shape as the interference vote). Steps advance in
    lockstep under synchronous training, which is what makes the step
    counter a valid cross-peer gate. The switch lands at a step
    boundary: call it from ``after_step`` (this class) or anywhere no
    walk is in flight.

    ``KF_CONFIG_REPLAN`` (cluster-agreed) gates the whole machinery:
    with it ``off`` (the default) ``check_replan`` is a local no-op and
    this policy never runs a collective. On adoption the session emits a
    ``topology_replanned`` audit event naming old→new order and the
    predicted gain; ``ctx.metrics['replan/last_order']`` mirrors it for
    embedders.

    Under a sampled link matrix a row may be several
    sweeps old; re-planning a ring off decayed measurements is worse
    than keeping the current one. When the cluster plane publishes
    ``links/oldest_row_age_s`` and it exceeds ``max_row_age_s``
    (default ``KF_AGG_LINK_MAX_AGE_S``; 0 disables the gate) this peer
    refuses to VOTE yes — the ``check_replan`` collective still runs
    in lockstep so peers with fresh data stay in sync.

    Adaptive demotion (``KF_CONFIG_REPLAN=hier`` only): the
    planner's segment weights are bandwidth-only, so this policy feeds
    the OTHER measured planes in — ``step/critical_peer`` +
    ``step/critical_edge`` (who the cluster keeps waiting on),
    ``resource/saturated_peers`` and ``cluster/straggler_causes`` (WHY:
    network vs compute vs memory). A peer that stays elected critical
    for ``demote_patience`` consecutive closed ledger windows with a
    cause ≠ network (a slow LINK is the flat re-planner's job; demotion
    is for peers that are themselves the bottleneck) is proposed into
    the demoted role via ``HostSession.check_demote`` — a lockstep
    majority vote, run every ``interval_steps`` on every peer exactly
    like ``check_replan``. Demoted = zero-weight segments + excluded
    from the inter-host ring, still receiving results by broadcast.
    The adoption opens a ``peer_demoted`` decision record; the ledger
    grades it against measured step times, and if it lands in
    ``decision/regressed`` this policy votes the peer straight back
    (rollback). A demoted peer that stays un-flagged for
    ``demote_patience`` clean windows is promoted back on recovery."""

    # a straggler cause that re-planning/demotion treats as transient
    # network weather — routed around, never demoted for
    NETWORK_CAUSES = ("network", "unknown", None, "")

    def __init__(
        self,
        interval_steps: int = 32,
        patience: int = 3,
        min_gain: float = 1.05,
        session_supplier: Optional[Callable[[], object]] = None,
        max_row_age_s: Optional[float] = None,
        demote_patience: Optional[int] = None,
    ):
        if interval_steps < 1:
            raise ValueError("interval_steps must be >= 1")
        self.interval_steps = interval_steps
        self.patience = patience
        self.min_gain = min_gain
        if max_row_age_s is None:
            try:
                max_row_age_s = float(knobs.get("KF_AGG_LINK_MAX_AGE_S"))
            except (TypeError, ValueError):
                max_row_age_s = 60.0
        self.max_row_age_s = max_row_age_s
        if demote_patience is None:
            try:
                demote_patience = int(knobs.get("KF_REPLAN_DEMOTE_PATIENCE"))
            except (TypeError, ValueError):
                demote_patience = 3
        self.demote_patience = max(1, demote_patience)
        self._session_supplier = session_supplier
        self._edge = None  # the persistently-named edge being watched
        self._streak = 0
        self._last_update = None
        # demotion watch: per-peer counts of closed ledger
        # windows spent elected critical (with a demotable cause) /
        # spent clean while demoted — the patience substrate
        self._crit_windows: dict = {}   # peer label -> windows critical
        self._clean_windows: dict = {}  # rank -> windows un-flagged
        self._window_mark = 0           # ctx.step at last window close
        self._demote_update = None

    def _session(self):
        if self._session_supplier is not None:
            return self._session_supplier()
        try:
            from kungfu_tpu_torch.peer import get_default_peer

            return get_default_peer().current_session()
        except Exception as e:  # noqa: BLE001 - no peer = nothing to re-plan
            log.debug("replan policy: no session: %s", e)
            return None

    def _observe(self, ctx: "PolicyContext") -> None:
        """Track how long the same measured edge has been the named
        bottleneck. Counted once per signal REFRESH when the cluster
        plane stamps one (cluster/updated_at — the StragglerPolicy
        discipline), else once per step off the worker-local signals."""
        edge = ctx.metrics.get("step/critical_edge")
        if edge is None:
            slowest = ctx.metrics.get("links/slowest_edge")
            edge = slowest[-1] if isinstance(slowest, (list, tuple)) and slowest else None
        if edge is None:
            return
        update = ctx.metrics.get("cluster/updated_at")
        if update is not None and update == self._last_update:
            return
        self._last_update = update
        edge = str(edge)
        if edge == self._edge:
            self._streak += 1
        else:
            self._edge, self._streak = edge, 1

    @staticmethod
    def _rank_of(sess, label) -> Optional[int]:
        peers = getattr(sess, "peers", None)
        if peers is None or label is None:
            return None
        try:
            from kungfu_tpu_torch.plan.peer import PeerID

            return peers.rank(PeerID.parse(str(label)))
        except Exception as e:  # noqa: BLE001 - unparseable label = unknown peer
            log.debug("replan policy: unmappable peer label %r: %s", label, e)
            return None

    @staticmethod
    def _label_of(sess, rank: int) -> Optional[str]:
        peers = getattr(sess, "peers", None)
        try:
            return str(peers[rank]) if peers is not None else None
        except Exception as e:  # noqa: BLE001 - rank outside the peer list
            log.debug("replan policy: no label for rank %s: %s", rank, e)
            return None

    def _observe_demotion(self, ctx: "PolicyContext", sess) -> None:
        """Close a demotion-patience window: one ledger measurement
        window (``DecisionLedger.window`` steps) with a fresh cluster
        refresh. Inside each closed window, count whether the SAME
        peer stayed elected critical with a demotable cause — and, for
        already-demoted peers, whether they stayed clean (the recovery
        counter promotion keys off)."""
        from kungfu_tpu_torch.telemetry import decisions as _tdec

        window = max(1, int(getattr(_tdec.get_ledger(), "window", 16)))
        if ctx.step - self._window_mark < window:
            return
        update = ctx.metrics.get("cluster/updated_at")
        if update is not None and update == self._demote_update:
            return  # no fresh cluster view: the window cannot close
        self._window_mark = ctx.step
        self._demote_update = update
        crit = ctx.metrics.get("step/critical_peer")
        causes = ctx.metrics.get("cluster/straggler_causes") or {}
        saturated = set(ctx.metrics.get("resource/saturated_peers") or ())
        demotable = crit is not None and (
            causes.get(crit) not in self.NETWORK_CAUSES
            or crit in saturated  # direct compute measurement
        )
        if demotable:
            self._crit_windows = {
                crit: self._crit_windows.get(crit, 0) + 1
            }
        else:
            # a clean window (or a network-caused one) breaks the streak
            self._crit_windows.clear()
        flagged = set(ctx.metrics.get("cluster/stragglers") or ())
        demoted = tuple(getattr(sess, "demoted_peers", tuple)())
        self._clean_windows = {
            r: (
                self._clean_windows.get(r, 0) + 1
                if (lbl := self._label_of(sess, r)) is not None
                and lbl not in flagged and lbl != crit
                else 0
            )
            for r in demoted
        }

    def _demote_proposal(self, ctx: "PolicyContext", sess):
        """(demote_rank, promote_rank) this peer votes for — either may
        be None; the lockstep majority decides."""
        demoted = set(getattr(sess, "demoted_peers", tuple)())
        promote = None
        regressed = ctx.metrics.get("decision/regressed") or []
        if "peer_demoted" in regressed and demoted:
            # the ledger measured the demotion throughput-hostile:
            # roll it back rather than wait out a recovery
            promote = min(demoted)
        else:
            clean = sorted(
                r for r, n in self._clean_windows.items()
                if n >= self.demote_patience and r in demoted
            )
            if clean:
                promote = clean[0]
        demote = None
        for label, n in sorted(self._crit_windows.items()):
            if n < self.demote_patience:
                continue
            rank = self._rank_of(sess, label)
            if rank is not None and rank not in demoted and rank != promote:
                demote = rank
                break
        return demote, promote

    def after_step(self, ctx: "PolicyContext") -> None:
        self._observe(ctx)
        if ctx.step == 0 or ctx.step % self.interval_steps:
            return
        sess = self._session()
        if sess is None or getattr(sess, "size", 1) < 2:
            return
        want = self._streak >= self.patience
        if want and self.max_row_age_s > 0:
            # sampled-matrix staleness gate: don't vote to
            # re-plan off link rows older than the knob — the collective
            # still runs so fresh peers stay in lockstep
            age = ctx.metrics.get("links/oldest_row_age_s")
            if isinstance(age, (int, float)) and age > self.max_row_age_s:
                want = False
                ctx.metrics["replan/vote_withheld_stale_links"] = age
        plan = sess.check_replan(want=want, min_gain=self.min_gain)
        if plan is not None:
            # adopted: restart the watch window against the new topology
            self._edge, self._streak = None, 0
            ctx.metrics["replan/last_order"] = list(plan.order)
            ctx.metrics["replan/predicted_gain"] = plan.gain
        # adaptive demotion: a second lockstep round, run on
        # every peer at the same step boundary exactly like the re-plan
        # vote (check_demote is a no-op collective-free return outside
        # KF_CONFIG_REPLAN=hier, which is cluster-agreed)
        if getattr(sess, "replan_mode", "") == "hier" \
                and hasattr(sess, "check_demote"):
            self._observe_demotion(ctx, sess)
            demote, promote = self._demote_proposal(ctx, sess)
            adopted = sess.check_demote(demote=demote, promote=promote)
            if adopted is not None:
                self._crit_windows.clear()
                self._clean_windows.clear()
                now_demoted = [
                    int(r) for r in getattr(sess, "demoted_peers", tuple)()
                ]
                ctx.metrics["replan/demoted"] = now_demoted
                ctx.metrics["replan/last_order"] = list(adopted.order)


class PrecisionPolicy(BasePolicy):
    """Adaptive wire-precision policy: chooses the collective
    codec — bf16 / int8 / int4 — from the measured gradient noise scale
    and votes flips through ``HostSession.check_precision``, a lockstep
    majority round run every ``interval_steps`` on EVERY peer exactly
    like the re-plan and interference votes (peers with no opinion vote
    to keep the current mode; the majority decides).

    The signal: ``kungfu_noise_scale`` (McCandlish B_noise, published by
    ``monitor.noise_scale.publish_noise_scale`` from an on-device psum —
    identical on every peer) relative to the actual batch size. When
    B_noise >> B the minibatch gradient is already dominated by sampling
    noise, so block-scaled quantization noise (bounded by half a scale
    step per element — docs/collectives.md) is negligible and the wire
    can drop to int8, then int4; when B_noise falls toward B the
    gradient is informative and the policy votes back up to bf16.
    ``monitor/noise_scale`` in ``ctx.metrics`` overrides the gauge when
    an embedder or the cluster plane supplies it.

    A target must persist for ``patience`` consecutive vote rounds
    before this peer proposes it — one noisy estimate never flips the
    cluster. Every adopted flip opens a ``precision_switch`` decision
    record; if the ledger closes it ``regressed`` (throughput- or
    accuracy-hostile: step times got worse), the policy votes straight
    back to the pre-flip mode and then holds ``cooldown_intervals``
    vote rounds before proposing another downshift — the rollback
    contract that makes an aggressive downshift safe to try."""

    def __init__(
        self,
        interval_steps: int = 32,
        patience: int = 3,
        int8_ratio: float = 8.0,
        int4_ratio: float = 64.0,
        cooldown_intervals: int = 8,
        session_supplier: Optional[Callable[[], object]] = None,
    ):
        if interval_steps < 1:
            raise ValueError("interval_steps must be >= 1")
        if not (int4_ratio >= int8_ratio > 0):
            raise ValueError("need int4_ratio >= int8_ratio > 0")
        self.interval_steps = interval_steps
        self.patience = max(1, patience)
        self.int8_ratio = float(int8_ratio)
        self.int4_ratio = float(int4_ratio)
        self.cooldown_intervals = max(0, cooldown_intervals)
        self._session_supplier = session_supplier
        self._want: Optional[str] = None  # the persistent target watched
        self._streak = 0
        self._flip_old: Optional[str] = None  # mode before our last flip
        self._cooldown = 0

    def _session(self):
        if self._session_supplier is not None:
            return self._session_supplier()
        try:
            from kungfu_tpu_torch.peer import get_default_peer

            return get_default_peer().current_session()
        except Exception as e:  # noqa: BLE001 - no peer = nothing to vote on
            log.debug("precision policy: no session: %s", e)
            return None

    def _target(self, ctx: "PolicyContext", signals: dict) -> Optional[str]:
        """The mode this peer believes the measured noise justifies, or
        None when no (finite, positive) noise estimate is available."""
        noise = ctx.metrics.get("monitor/noise_scale")
        if noise is None:
            try:
                from kungfu_tpu_torch.telemetry import metrics as _tm

                m = _tm.get_registry().get("kungfu_noise_scale")
                noise = m.value if m is not None else None
            except Exception as e:  # noqa: BLE001 - metrics plane optional
                log.debug("precision policy: no noise gauge: %s", e)
                noise = None
        batch = ctx.batch_size
        if not isinstance(noise, (int, float)) or not noise > 0 or batch <= 0:
            return None
        ratio = float(noise) / float(batch)
        signals["noise_scale"] = float(noise)
        signals["batch_size"] = int(batch)
        signals["noise_ratio"] = ratio
        if ratio >= self.int4_ratio:
            return "int4"
        if ratio >= self.int8_ratio:
            return "int8"
        return "bf16"

    def after_step(self, ctx: "PolicyContext") -> None:
        if ctx.step == 0 or ctx.step % self.interval_steps:
            return
        sess = self._session()
        if (
            sess is None
            or getattr(sess, "size", 1) < 2
            or not hasattr(sess, "check_precision")
        ):
            return
        current = sess.active_wire_mode()
        if self._cooldown > 0:
            self._cooldown -= 1
        proposal: Optional[str] = None
        trigger = "noise_scale"
        signals: dict = {}
        regressed = ctx.metrics.get("decision/regressed") or []
        if "precision_switch" in regressed and self._flip_old is not None \
                and self._flip_old != current:
            # the ledger measured our flip hostile: vote straight back
            proposal = self._flip_old
            trigger = "regression_rollback"
        else:
            target = self._target(ctx, signals)
            if target is not None and target == self._want:
                self._streak += 1
            else:
                self._want = target
                self._streak = 1 if target is not None else 0
            wants_flip = (
                target is not None
                and target != current
                and self._streak >= self.patience
            )
            if wants_flip and self._cooldown > 0:
                ctx.metrics["precision/vote_withheld_cooldown"] = \
                    self._cooldown
                wants_flip = False
            if wants_flip:
                proposal = target
        # the vote is a lockstep collective: run it EVERY interval on
        # every peer, opinion or not — a silent peer would hang the rest
        new = sess.check_precision(
            proposal, trigger=trigger, signals=signals or None
        )
        if new is not None:
            if trigger == "regression_rollback":
                # rolled back: don't re-roll the rollback, and hold off
                # further downshift proposals for the cooldown window
                self._flip_old = None
                self._cooldown = self.cooldown_intervals
            else:
                self._flip_old = current
            self._streak = 0
            ctx.metrics["precision/active"] = new


class _Scope:
    def __init__(self, enter, exit):
        self._enter = enter
        self._exit = exit

    def __enter__(self):
        self._enter()
        return self

    def __exit__(self, *exc):
        self._exit()
        return False

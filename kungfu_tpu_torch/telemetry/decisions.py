"""Decision ledger: the causal adaptation timeline.

Port of `kungfu_tpu/telemetry/decisions.py`. The engine adapts in
several independent ways — strategy/wire votes, measured ring
re-planning and demotion, async/ZeRO mode flips at session epochs,
elastic resizes — and each flip stamps a fire-and-forget audit event
carrying a *prediction* (``predicted_gain``, a trigger). This module
measures whether an adaptation actually helped, per worker:

- every adaptation becomes an open :class:`DecisionRecord` — decision
  kind, trigger, signal snapshot, predicted gain, session epoch — with
  a **baseline window** captured at the flip (the last
  ``KF_DECISION_WINDOW`` step durations the training loop fed via
  :func:`note_step`);
- after a settle period (``KF_DECISION_SETTLE`` steps, letting caches /
  pools / estimators re-warm under the new configuration) the next
  window of step durations closes the record with a **realized_gain**
  (= baseline mean step time / after mean step time; >1 means the
  cluster got faster) and a verdict — ``delivered`` / ``neutral`` /
  ``regressed`` — guarded against window noise (a gain inside the
  windows' own variance band is ``neutral``, never ``delivered``);
- a closed record emits a ``decision_outcome`` audit event plus
  ``kungfu_decision_realized_gain{kind}`` /
  ``kungfu_decisions_total{kind,verdict}`` metrics, and a **regression
  watchdog** keeps watching a ``regressed`` close: when the realized
  gain stays under ``KF_DECISION_REGRESS_RATIO`` for
  ``KF_DECISION_PATIENCE`` consecutive windows it fires an
  ``adaptation_regressed`` audit event — the rollback signal the
  policies key off.

Served at the worker's ``/decisions`` endpoint (``?since=`` ships only
the records that changed past a cursor) with perf-clock anchors, so
every worker's ledger can be merged onto one timeline
(:func:`merge_decisions`); rendered by :func:`render_decisions`.

A run that never adapts opens no records, feeds only a small rolling
deque, and emits zero ``decision_outcome`` events — the ledger is
silent by construction. ``KF_DECISION_KEEP=0`` disables it entirely
(:func:`open_decision` returns None and allocates nothing).

The flight recorder journals the ledger's tail (:meth:`DecisionLedger.tail`,
the last 8 records) in every snapshot, so a postmortem names the
adaptation a worker was mid-flip on when it died. The ledger registers
a memory-plane accountant (``footprint_bytes``: its rings' caps plus the
open records) in the ``telemetry`` bucket.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.telemetry import config as tconfig
from kungfu_tpu_torch.telemetry import memory as tmemory

_US = 1e6

# realized-gain changes inside this relative band can never be called
# `delivered`/`regressed` on variance alone — the floor under the
# window-noise guard (two quiet windows still jitter a percent or two
# on a shared box)
NOISE_FLOOR = 0.02


def _now_us() -> float:
    return time.perf_counter() * _US


class _Window:
    """Summary of one measurement window of step durations."""

    __slots__ = ("mean_s", "rel_sd", "n")

    def __init__(self, samples: List[float]):
        self.n = len(samples)
        self.mean_s = sum(samples) / self.n if self.n else 0.0
        if self.n >= 2 and self.mean_s > 0:
            var = sum((s - self.mean_s) ** 2 for s in samples) / (self.n - 1)
            self.rel_sd = math.sqrt(var) / self.mean_s
        else:
            self.rel_sd = 0.0

    def to_json(self) -> dict:
        return {
            "mean_ms": round(self.mean_s * 1e3, 3),
            "rel_sd": round(self.rel_sd, 4),
            "n": self.n,
        }


class DecisionRecord:
    """One adaptation, from flip to measured outcome."""

    __slots__ = (
        "seq", "kind", "peer", "epoch", "trigger", "signals",
        "predicted_gain", "detail", "wall_time", "t_us",
        "status", "baseline", "after", "realized_gain", "verdict",
        "regressed", "closed_wall_time", "t_closed_us",
        # delta-scrape cursor: bumped on every visible
        # mutation (open, close, watchdog updates) so `?since=` ships a
        # record again whenever its merged copy needs updating
        "useq",
        # measurement state (never serialized)
        "_settle_left", "_samples", "_watch_below",
    )

    def __init__(self, seq: int, kind: str, *, peer: str, epoch: int,
                 trigger: str, signals: Optional[dict],
                 predicted_gain: Optional[float], detail: Optional[dict],
                 baseline: Optional[_Window], settle: int):
        self.seq = seq
        self.kind = kind
        self.peer = str(peer)
        self.epoch = int(epoch)
        self.trigger = trigger
        self.signals = dict(signals or {})
        self.predicted_gain = (
            float(predicted_gain) if predicted_gain is not None else None
        )
        self.detail = dict(detail or {})
        self.wall_time = time.time()
        self.t_us = _now_us()
        self.status = "open"
        self.baseline = baseline
        self.after: Optional[_Window] = None
        self.realized_gain: Optional[float] = None
        self.verdict: Optional[str] = None
        self.regressed = False
        self.closed_wall_time: Optional[float] = None
        self.t_closed_us: Optional[float] = None
        self.useq = 0
        self._settle_left = settle
        self._samples: List[float] = []
        self._watch_below = 0

    def to_json(self) -> dict:
        d = {
            "seq": self.seq,
            "kind": self.kind,
            "peer": self.peer,
            "epoch": self.epoch,
            "trigger": self.trigger,
            "wall_time": self.wall_time,
            "t_us": self.t_us,
            "status": self.status,
            "predicted_gain": self.predicted_gain,
            "useq": self.useq,
        }
        # copies, not references: the watchdog mutates detail (and the
        # measurement fields) under the ledger lock while HTTP scrapes /
        # flight snapshots serialize earlier to_json output — a shared
        # dict would grow mid-json.dumps (the steptrace lane-copy
        # lesson). Serialization itself runs under the ledger lock
        # (export/tail), so these copies are taken race-free.
        if self.signals:
            d["signals"] = dict(self.signals)
        if self.detail:
            d["detail"] = dict(self.detail)
        if self.baseline is not None:
            d["baseline"] = self.baseline.to_json()
        if self.after is not None:
            d["after"] = self.after.to_json()
        if self.realized_gain is not None:
            d["realized_gain"] = round(self.realized_gain, 4)
        if self.verdict is not None:
            d["verdict"] = self.verdict
        if self.regressed:
            d["regressed"] = True
        if self.closed_wall_time is not None:
            d["closed_wall_time"] = self.closed_wall_time
            d["t_closed_us"] = self.t_closed_us
        return d


class DecisionLedger:
    """Per-worker bounded ring of decision records plus the rolling
    step-duration window that measures them. Thread-safe: the training
    loop feeds :meth:`note_step`, decision sites call :meth:`open`,
    HTTP scrapes and flight snapshots read."""

    def __init__(self, keep: Optional[int] = None,
                 window: Optional[int] = None,
                 settle: Optional[int] = None,
                 regress_ratio: Optional[float] = None,
                 patience: Optional[int] = None):
        self.keep = keep if keep is not None else max(
            0, int(knobs.get("KF_DECISION_KEEP"))
        )
        self.window = max(2, int(
            window if window is not None else knobs.get("KF_DECISION_WINDOW")
        ))
        self.settle = max(0, int(
            settle if settle is not None else knobs.get("KF_DECISION_SETTLE")
        ))
        self.regress_ratio = float(
            regress_ratio if regress_ratio is not None
            else knobs.get("KF_DECISION_REGRESS_RATIO")
        )
        self.patience = max(1, int(
            patience if patience is not None
            else knobs.get("KF_DECISION_PATIENCE")
        ))
        self._ring: "deque[DecisionRecord]" = deque(maxlen=max(1, self.keep))
        self._recent: "deque[float]" = deque(maxlen=self.window)
        self._open: List[DecisionRecord] = []
        self._seq = 0
        # delta-scrape cursor space: a record's useq is
        # re-stamped on every visible mutation, so `export(since=N)`
        # ships exactly the records whose merged copies are out of date
        self._useq = 0
        self._lock = threading.Lock()
        self._g_gain = self._c_total = None
        if tconfig.metrics_enabled():
            from kungfu_tpu_torch.telemetry import metrics as tm

            self._g_gain = tm.gauge(
                "kungfu_decision_realized_gain",
                "Measured outcome of the most recently closed adaptation "
                "of each kind: baseline mean step time / post-settle mean "
                "step time (>1 = the adaptation made steps faster)",
                ("kind",),
            )
            self._c_total = tm.counter(
                "kungfu_decisions_total",
                "Adaptation decisions closed with a measured outcome, by "
                "decision kind and verdict (delivered/neutral/regressed)",
                ("kind", "verdict"),
            )
        # memory plane: the rings report their cap, so filling up never
        # reads as a leak; only the open records (unbounded until closed)
        # can streak
        tmemory.register_owner("decisions", "telemetry", self, lambda led: led.footprint_bytes())

    def footprint_bytes(self) -> int:
        """Capacity estimate of the ledger's state in bytes (the memory
        plane's `telemetry` bucket): ring caps plus live open records."""
        with self._lock:
            ring = deque(self._ring, maxlen=self._ring.maxlen)
            recent = deque(self._recent, maxlen=self._recent.maxlen)
            open_ = list(self._open)
        return (tmemory.ring_cap_bytes(ring) + tmemory.ring_cap_bytes(recent)
                + tmemory.deep_sizeof(open_))

    # -- decision sites -------------------------------------------------

    def open(self, kind: str, *, peer: str = "", epoch: int = 0,
             trigger: str = "", signals: Optional[dict] = None,
             predicted_gain: Optional[float] = None,
             **detail) -> Optional[DecisionRecord]:
        """Record one adaptation the moment it lands. The baseline is
        whatever step history the rolling window holds RIGHT NOW (the
        steps walked under the old configuration); with fewer than 2
        fed steps the record has no baseline and stays open forever —
        an honest 'never measured', never a fabricated gain."""
        if self.keep <= 0:
            return None
        with self._lock:
            base = (
                _Window(list(self._recent)) if len(self._recent) >= 2
                else None
            )
            rec = DecisionRecord(
                self._seq, kind, peer=peer, epoch=epoch, trigger=trigger,
                signals=signals, predicted_gain=predicted_gain,
                detail=detail or None, baseline=base, settle=self.settle,
            )
            self._seq += 1
            self._useq += 1
            rec.useq = self._useq
            self._ring.append(rec)
            if base is not None:
                self._open.append(rec)
        return rec

    # -- measurement feed ----------------------------------------------

    def note_step(self, seconds: float) -> None:
        """One training step's wall-clock duration (the PolicyRunner
        feeds this; benches and tests may too). Advances every open
        record's settle/measurement window; closing and the watchdog
        run inline — the work is a handful of floats per step."""
        if self.keep <= 0 or not (seconds > 0):
            return
        closed: List[DecisionRecord] = []
        fired: List[DecisionRecord] = []
        with self._lock:
            self._recent.append(float(seconds))
            still_open: List[DecisionRecord] = []
            for rec in self._open:
                if rec._settle_left > 0:
                    rec._settle_left -= 1
                    still_open.append(rec)
                    continue
                rec._samples.append(float(seconds))
                if len(rec._samples) < self.window:
                    still_open.append(rec)
                    continue
                win = _Window(rec._samples)
                rec._samples = []
                # every branch below mutates the record (close, watchdog
                # gain update, regress, recovery note) — re-stamp its
                # delta cursor so `?since=` re-ships the merged update
                self._useq += 1
                rec.useq = self._useq
                if rec.status == "open":
                    self._close_locked(rec, win)
                    closed.append(rec)
                    if rec.verdict == "regressed":
                        rec._watch_below = 1
                        if rec._watch_below >= self.patience:
                            rec.regressed = True
                            fired.append(rec)
                        else:
                            still_open.append(rec)
                    continue
                # watchdog: a regressed close keeps measuring until the
                # gain recovers past the floor or patience runs out
                gain = (
                    rec.baseline.mean_s / win.mean_s
                    if win.mean_s > 0 else None
                )
                rec.after = win
                if gain is not None:
                    rec.realized_gain = gain
                if gain is not None and gain <= self.regress_ratio:
                    rec._watch_below += 1
                    if rec._watch_below >= self.patience:
                        rec.regressed = True
                        fired.append(rec)
                    else:
                        still_open.append(rec)
                else:
                    rec.detail["recovered_after_windows"] = rec._watch_below
            self._open = still_open
        # emit outside the lock: audit/metrics take locks of their own
        for rec in closed:
            self._emit_outcome(rec)
        for rec in fired:
            self._emit_regressed(rec)

    def _close_locked(self, rec: DecisionRecord, win: _Window) -> None:
        rec.after = win
        rec.status = "closed"
        rec.closed_wall_time = time.time()
        rec.t_closed_us = _now_us()
        if win.mean_s <= 0 or rec.baseline is None:
            return
        gain = rec.baseline.mean_s / win.mean_s
        rec.realized_gain = gain
        # noise guard: the windows' own relative variance bounds what a
        # mean shift can prove — two std errors of the noisier window,
        # at the SMALLER window's actual sample count (a baseline
        # captured after only 3 fed steps must widen the band, not
        # borrow the configured window's sqrt), floored so quiet
        # windows still don't call percent-level drift
        n_eff = max(2, min(rec.baseline.n, win.n))
        band = max(
            NOISE_FLOOR,
            2.0 * max(rec.baseline.rel_sd, win.rel_sd) / math.sqrt(n_eff),
        )
        if gain >= 1.0 + band:
            rec.verdict = "delivered"
        elif gain <= min(self.regress_ratio, 1.0 - band):
            rec.verdict = "regressed"
        else:
            rec.verdict = "neutral"

    def _emit_outcome(self, rec: DecisionRecord) -> None:
        from kungfu_tpu_torch.telemetry import audit

        audit.record_event(
            "decision_outcome",
            peer=rec.peer,
            trigger=rec.trigger,
            decision=rec.kind,
            epoch=rec.epoch,
            predicted_gain=rec.predicted_gain,
            realized_gain=(
                round(rec.realized_gain, 4)
                if rec.realized_gain is not None else None
            ),
            verdict=rec.verdict,
            baseline_ms=(
                round(rec.baseline.mean_s * 1e3, 3)
                if rec.baseline is not None else None
            ),
            after_ms=(
                round(rec.after.mean_s * 1e3, 3)
                if rec.after is not None else None
            ),
            window=self.window,
        )
        if self._g_gain is not None and rec.realized_gain is not None:
            self._g_gain.labels(rec.kind).set(rec.realized_gain)
        if self._c_total is not None and rec.verdict is not None:
            self._c_total.labels(rec.kind, rec.verdict).inc()

    def _emit_regressed(self, rec: DecisionRecord) -> None:
        from kungfu_tpu_torch.telemetry import audit, log

        log.warn(
            "decision ledger: adaptation REGRESSED: %s (trigger %s) "
            "realized %.2fx, floor %.2f — consider rolling back",
            rec.kind, rec.trigger, rec.realized_gain or 0.0,
            self.regress_ratio,
        )
        audit.record_event(
            "adaptation_regressed",
            peer=rec.peer,
            trigger=rec.trigger,
            decision=rec.kind,
            epoch=rec.epoch,
            realized_gain=(
                round(rec.realized_gain, 4)
                if rec.realized_gain is not None else None
            ),
            floor=self.regress_ratio,
            windows=rec._watch_below,
        )

    # -- views ----------------------------------------------------------

    def records(self) -> List[DecisionRecord]:
        with self._lock:
            return list(self._ring)

    def tail(self, n: int = 8) -> List[dict]:
        # to_json UNDER the ledger lock: note_step mutates the records'
        # measurement fields under it, so snapshots taken here are
        # consistent and the returned dicts are never mutated again
        with self._lock:
            recs = [r.to_json() for r in list(self._ring)[-max(0, n):]]
        return recs

    def export(self, peer: str = "", since: Optional[int] = None) -> dict:
        """The /decisions document: the ring plus the clock anchors the
        aggregator aligns on. ``since`` is the delta-scrape cursor:
        only records whose useq
        moved past it ship — new records AND records that mutated
        (closed, regressed) since the last scrape, so the aggregator's
        update-in-place merge stays correct on deltas."""
        with self._lock:
            recs = [
                r.to_json() for r in self._ring
                if since is None or r.useq > since
            ]
            next_since = self._useq
        return {
            "peer": peer or knobs.raw("KF_SELF_SPEC"),
            "perf_now_us": _now_us(),
            "wall_time_s": time.time(),
            "keep": self.keep,
            "window": self.window,
            "settle": self.settle,
            "regress_ratio": self.regress_ratio,
            "next_since": next_since,
            "decisions": recs,
        }

    def signals(self) -> Dict[str, object]:
        """Adaptation-facing policy signals (PolicyContext.metrics):
        the latest closed decision's kind and realized gain, plus the
        kinds the watchdog currently flags as regressed."""
        with self._lock:
            recs = list(self._ring)
        out: Dict[str, object] = {}
        closed = [r for r in recs if r.status == "closed"]
        if closed:
            last = closed[-1]
            out["decision/last_kind"] = last.kind
            if last.realized_gain is not None:
                out["decision/last_realized_gain"] = last.realized_gain
        regressed = sorted({r.kind for r in recs if r.regressed})
        if regressed:
            out["decision/regressed"] = regressed
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._recent.clear()
            self._open = []


_ledger: Optional[DecisionLedger] = None
_ledger_lock = threading.Lock()


def get_ledger() -> DecisionLedger:
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = DecisionLedger()
        return _ledger


def reset_ledger() -> None:
    """Drop the process ledger (tests flip knobs at runtime)."""
    global _ledger
    with _ledger_lock:
        _ledger = None


def open_decision(kind: str, **kw) -> Optional[DecisionRecord]:
    """Fire-and-forget decision-site entry point: never raises (a
    broken ledger must not break the adaptation it observes)."""
    try:
        return get_ledger().open(kind, **kw)
    except Exception as e:  # noqa: BLE001 - telemetry must never kill adaptation
        from kungfu_tpu_torch.telemetry import log

        log.debug("decision ledger: open(%s) failed: %s", kind, e)
        return None


def note_step(seconds: float) -> None:
    """Fire-and-forget step feed (the PolicyRunner's hook)."""
    try:
        get_ledger().note_step(seconds)
    except Exception as e:  # noqa: BLE001 - telemetry must never kill training
        from kungfu_tpu_torch.telemetry import log

        log.debug("decision ledger: note_step failed: %s", e)


# ---------------------------------------------------------------------------
# merge math (pure: the aggregator and tests drive it)
# ---------------------------------------------------------------------------


def merge_decisions(peer_docs: Dict[str, dict],
                    offsets_us: Dict[str, float]) -> List[dict]:
    """Merge every peer's /decisions document into one timeline, oldest
    first: each record keyed by its reporting peer, perf stamps shifted
    by that peer's NTP-style clock offset onto the merger's timeline
    (the /cluster/steps discipline — wall clocks across VMs drift, the
    aligned perf stamps order causally)."""
    out: List[dict] = []
    for peer, doc in peer_docs.items():
        off = offsets_us.get(peer) or 0.0
        for rec in (doc or {}).get("decisions", []):
            rec = dict(rec)
            rec.setdefault("peer", peer)
            for key in ("t_us", "t_closed_us"):
                if isinstance(rec.get(key), (int, float)):
                    rec[key] = rec[key] + off
            out.append(rec)
    out.sort(key=lambda r: (
        r.get("t_us") if isinstance(r.get("t_us"), (int, float))
        else r.get("wall_time", 0.0),
        r.get("peer", ""), r.get("seq", 0),
    ))
    return out


# ---------------------------------------------------------------------------
# rendering (a timeline of the merged ledger)
# ---------------------------------------------------------------------------


def _fmt_gain(v: Optional[float]) -> str:
    return f"{v:.2f}x" if isinstance(v, (int, float)) else "—"


def render_record(rec: dict) -> str:
    """One ledger entry as a timeline line: decision → trigger →
    predicted vs realized, the regressed flag loud."""
    when = rec.get("wall_time")
    ts = (
        time.strftime("%H:%M:%S", time.localtime(when))
        if isinstance(when, (int, float)) else "?"
    )
    head = (
        f"{ts}  {rec.get('peer') or '?'}  e{rec.get('epoch', 0)}  "
        f"{rec.get('kind', '?')}"
    )
    trigger = rec.get("trigger")
    if trigger:
        head += f"  [{trigger}]"
    head += (
        f"  predicted {_fmt_gain(rec.get('predicted_gain'))}"
        f" → realized {_fmt_gain(rec.get('realized_gain'))}"
    )
    if rec.get("status") != "closed":
        head += (
            "  OPEN (outcome pending)" if rec.get("baseline")
            else "  OPEN (no step feed — never measured)"
        )
    else:
        head += f"  {str(rec.get('verdict', '?')).upper()}"
    if rec.get("regressed"):
        head += "  ⚠ REGRESSED"
    return head


def render_decisions(doc: dict, limit: int = 16) -> str:
    """The merged causal timeline as text,
    newest last, regressed entries flagged."""
    recs = doc.get("decisions") or []
    if not recs:
        return (
            "no adaptation decisions on record — the cluster has not "
            "adapted (strategy/wire vote, re-plan, mode flip, resize), "
            "or the ledger is off (KF_DECISION_KEEP=0)"
        )
    shown = recs[-limit:]
    n_open = sum(1 for r in recs if r.get("status") != "closed")
    n_reg = sum(1 for r in recs if r.get("regressed"))
    head = (
        f"{len(recs)} adaptation decision(s) on record, showing "
        f"{len(shown)} (open: {n_open}"
        + (f", REGRESSED: {n_reg}" if n_reg else "")
        + ") — realized gain = baseline mean step time / post-settle "
        "mean step time"
    )
    lines = [head]
    for rec in shown:
        lines.append(render_record(rec))
        det = rec.get("detail") or {}
        if det:
            pairs = ", ".join(f"{k}={v}" for k, v in sorted(det.items()))
            lines.append(f"          {pairs[:110]}")
    return "\n".join(lines)

"""Resize audit log: every elastic membership change, on the record.

Port of `kungfu_tpu/telemetry/audit.py`. Each membership change appends
a structured record — old/new cluster, trigger (config server /
explicit / schedule / reload), per-phase durations, progress and
checkpoint version when the driver knows them — queryable in process
(:func:`records`), over HTTP (``/audit``) and as JSONL. Strategy
switches, codec bypasses and the like land in the same log.

Each record also feeds the metrics registry (resize counter and latency
histogram, strategy-switch counter) and drops an instant event into the
trace ring, so all three views agree on when adaptation happened.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import List, Optional

from kungfu_tpu_torch.telemetry import metrics, tracing

MAX_RECORDS = 1024

# resizes take ~100ms..minutes; widen the default latency buckets
RESIZE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0, 300.0)


@dataclasses.dataclass
class AuditRecord:
    kind: str  # "resize" | "strategy_switch" | ...
    wall_time: float  # unix seconds
    peer: str  # reporting peer ("host:port"), "" when unknown
    cluster_version: Optional[int] = None
    trigger: str = ""
    old_size: Optional[int] = None
    new_size: Optional[int] = None
    old_peers: Optional[List[str]] = None
    new_peers: Optional[List[str]] = None
    phases_ms: Optional[dict] = None  # wait_config/consensus/notify/update
    duration_ms: Optional[float] = None
    progress: Optional[int] = None
    checkpoint_version: Optional[int] = None
    detached: bool = False
    detail: Optional[dict] = None
    # delta-scrape cursor: `seq` is the record's stable
    # identity in this process's log (dedupe key for aggregator-side
    # caches); `useq` re-stamps on annotate_last so a `?since=` scrape
    # re-ships records whose late-known fields changed
    seq: Optional[int] = None
    useq: Optional[int] = None

    def to_json(self) -> dict:
        return {
            k: v
            for k, v in dataclasses.asdict(self).items()
            if v is not None and v != ""
        }


_lock = threading.Lock()
_records: List[AuditRecord] = []
_seq = 0  # identity space (stamped once per record)
_useq = 0  # update-cursor space (re-stamped on annotate)


def _stamp_locked(rec: AuditRecord) -> None:
    global _seq, _useq
    _seq += 1
    _useq += 1
    rec.seq = _seq
    rec.useq = _useq


def _metrics_hooks(rec: AuditRecord) -> None:
    if rec.kind == "resize":
        metrics.counter(
            "kungfu_resize_total",
            "Elastic membership changes seen by this process",
            ("trigger",),
        ).labels(rec.trigger or "unknown").inc()
        if rec.duration_ms is not None:
            metrics.histogram(
                "kungfu_resize_duration_seconds",
                "End-to-end resize latency (consensus+notify+update)",
                buckets=RESIZE_BUCKETS,
            ).observe(rec.duration_ms / 1e3)
    elif rec.kind == "strategy_switch":
        metrics.counter(
            "kungfu_strategy_switch_total",
            "Adaptive collective strategy switches",
        ).inc()
    tracing.instant(
        f"audit.{rec.kind}",
        trigger=rec.trigger,
        old_size=rec.old_size,
        new_size=rec.new_size,
        version=rec.cluster_version,
    )


def record_resize(
    *,
    peer: str = "",
    cluster_version: Optional[int] = None,
    trigger: str = "",
    old_peers=None,
    new_peers=None,
    phases_ms: Optional[dict] = None,
    progress: Optional[int] = None,
    checkpoint_version: Optional[int] = None,
    detached: bool = False,
) -> AuditRecord:
    """Append one membership-change record (called by Peer._propose)."""
    old_list = [str(p) for p in old_peers] if old_peers is not None else None
    new_list = [str(p) for p in new_peers] if new_peers is not None else None
    duration = None
    if phases_ms:
        # duration = the resize WORK (consensus+notify+update). The
        # config-server wait is recorded in phases_ms but excluded here:
        # it measures how long the cluster idled before agreeing, and a
        # retrying server blip would inflate a ~100ms resize to 15s+
        duration = round(
            sum(
                float(v)
                for k, v in phases_ms.items()
                if not k.startswith("wait")
            ),
            3,
        )
    rec = AuditRecord(
        kind="resize",
        wall_time=time.time(),
        peer=str(peer),
        cluster_version=cluster_version,
        trigger=trigger,
        old_size=len(old_list) if old_list is not None else None,
        new_size=len(new_list) if new_list is not None else None,
        old_peers=old_list,
        new_peers=new_list,
        phases_ms=dict(phases_ms) if phases_ms else None,
        duration_ms=duration,
        progress=progress,
        checkpoint_version=checkpoint_version,
        detached=detached,
    )
    with _lock:
        _stamp_locked(rec)
        _records.append(rec)
        del _records[:-MAX_RECORDS]
    _metrics_hooks(rec)
    return rec


def record_event(kind: str, *, peer: str = "", trigger: str = "", **detail) -> AuditRecord:
    """Append a non-resize audit event (e.g. a strategy switch)."""
    rec = AuditRecord(
        kind=kind,
        wall_time=time.time(),
        peer=str(peer),
        trigger=trigger,
        detail={k: v for k, v in detail.items() if v is not None} or None,
    )
    with _lock:
        _stamp_locked(rec)
        _records.append(rec)
        del _records[:-MAX_RECORDS]
    _metrics_hooks(rec)
    return rec


def annotate_last(kind: str = "resize", peer: str = "", **fields) -> bool:
    """Attach late-known fields (progress, checkpoint_version) to the most
    recent record of `kind` (optionally for a specific peer). The resize
    itself is recorded deep in the peer protocol; the elastic driver
    learns progress only afterwards."""
    with _lock:
        for rec in reversed(_records):
            if rec.kind != kind:
                continue
            if peer and rec.peer != str(peer):
                continue
            for k, v in fields.items():
                if hasattr(rec, k):
                    setattr(rec, k, v)
                else:
                    rec.detail = dict(rec.detail or {})
                    rec.detail[k] = v
            # the record changed: move it past every cursor that
            # already shipped it, keeping its stable identity (seq)
            global _useq
            _useq += 1
            rec.useq = _useq
            return True
    return False


def records(
    kind: Optional[str] = None, peer: str = "",
    since: Optional[int] = None,
) -> List[AuditRecord]:
    with _lock:
        out = list(_records)
    if kind:
        out = [r for r in out if r.kind == kind]
    if peer:
        out = [r for r in out if r.peer == str(peer)]
    if since is not None:
        out = [r for r in out if (r.useq or 0) > since]
    return out


def next_since() -> int:
    """The current delta-scrape cursor: passing this as ``since`` to a
    later :func:`records`/:func:`to_json` ships only records created or
    annotated after this call."""
    with _lock:
        return _useq


def clear() -> None:
    with _lock:
        _records.clear()


def to_json(since: Optional[int] = None) -> List[dict]:
    return [r.to_json() for r in records(since=since)]


def to_jsonl() -> str:
    return "\n".join(json.dumps(r) for r in to_json()) + ("\n" if _records else "")

"""Memory attribution plane: per-subsystem byte accounting, leak
watchdog and OOM-headroom forecasting.

Port of `kungfu_tpu/telemetry/memory.py`; its documents, metric families,
verdicts and renderings are the reference's, so either package's
aggregator merges the other's workers. The resource plane answers the
CPU side of "why is this peer slow?"; this one covers the axis that
kills workers: an OOM death otherwise harvests as an unexplained exit
-9, and an unattended grow needs a measured headroom signal. Host
memory only, as in the reference (no device-memory reading). Three parts:

- **RSS decomposition**: long-lived buffer owners (shm arenas, the
  scratch buffer pool, ZeRO mirrors + f32 shard masters, the
  scheduler's in-flight units, the bounded telemetry rings) register
  byte accountants via :func:`register_accountant`; every sweep sums
  them into buckets {arena, pool, zero_state, sched_inflight,
  telemetry} and reports ``untracked = RSS - sum(tracked)`` as a
  first-class bucket: the unexplained share is surfaced, never hidden.
  Bounded rings report their CAP (mean item size x maxlen), so ring
  fill-up is exempt from leak detection by construction.
- **Headroom forecasting**: a cgroup-aware :func:`effective_mem_limit`
  (v2 ``memory.max``, v1 hierarchical fallback) plus a windowed linear
  RSS trend yield ``memory/headroom_frac`` and a steps-to-exhaustion
  estimate that is ``None`` whenever the trend is flat or noisy.
- **Leak watchdog**: a bucket whose tracked bytes grow STRICTLY for
  ``KF_MEMORY_WINDOWS`` consecutive sweeps fires a one-shot
  ``memory_leak_suspect`` audit event naming the bucket. Streaks only
  arm after ``KF_MEMORY_WARMUP`` seconds: a booting process's RSS grows
  monotonically by nature (imports, first allocations), and a real leak
  outlives any boot transient.

Sweeps are on-demand (no sweeper thread): ``export()`` / ``signals()``
trigger a sweep at most every ``KF_MEMORY_INTERVAL`` seconds. Served at
worker ``/memory`` with perf-clock anchors; merged at
``/cluster/memory``. Consumers: ``PolicyContext.metrics``
(``memory/headroom_frac`` / ``pressure`` / ``leak_suspect``), straggler
cause classification (major-fault rate -> STRAGGLER(memory)), the
elastic grow gate (:meth:`MemoryPlane.grow_ok`), ZeRO's memory advisory
and the flight recorder's OOM forensics.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.telemetry import config as tconfig

_US = 1e6


def _now_us() -> float:
    return time.perf_counter() * _US


# ---------------------------------------------------------------------------
# buckets and thresholds
# ---------------------------------------------------------------------------

BUCKETS = ("arena", "pool", "zero_state", "sched_inflight", "telemetry",
           "untracked")

# the pressure line: a peer whose measured headroom fraction is at or
# below this is under memory pressure — the grow gate defers resize
# proposals and `info top` flags the peer
PRESSURE_FRAC = 0.15

# the thrashing line: sustained major faults per second above this mean
# the peer is paging its working set off disk/swap — the memory cause
# the straggler classifier ranks between network and compute
THRASH_FAULTS_PER_S = 10.0


# ---------------------------------------------------------------------------
# effective memory limit (cgroup v2 -> v1 -> physical RAM)
# ---------------------------------------------------------------------------

# module constants so tests can point them at fixture files (the
# effective_cpu_count idiom of collective/strategies.py)
CGROUP_V2_MEM_MAX = "/sys/fs/cgroup/memory.max"
CGROUP_V1_MEM_LIMIT = "/sys/fs/cgroup/memory/memory.limit_in_bytes"
CGROUP_V1_MEM_STAT = "/sys/fs/cgroup/memory/memory.stat"

# v1 reports "unlimited" as a huge page-rounded sentinel (commonly
# 0x7ffffffffffff000); anything this large is not a real limit
_V1_UNLIMITED = 1 << 60


def _cgroup_mem_limit() -> int:
    """Memory limit in bytes from the cgroup, or 0 when unlimited or
    unreadable. v2: ``memory.max`` is bytes or "max"; v1:
    ``memory.limit_in_bytes`` (huge sentinel meaning unlimited) with
    ``memory.stat``'s hierarchical_memory_limit as the fallback — a
    child cgroup may be "unlimited" while an ancestor is not."""
    try:
        with open(CGROUP_V2_MEM_MAX) as f:
            raw = f.read().strip()
        if raw != "max":
            limit = int(raw)
            if 0 < limit < _V1_UNLIMITED:
                return limit
    except (OSError, ValueError):
        pass
    for path, key in (
        (CGROUP_V1_MEM_LIMIT, None),
        (CGROUP_V1_MEM_STAT, "hierarchical_memory_limit"),
    ):
        try:
            with open(path) as f:
                if key is None:
                    limit = int(f.read().strip())
                else:
                    limit = 0
                    for line in f:
                        name, _, val = line.partition(" ")
                        if name == key:
                            limit = int(val)
                            break
            if 0 < limit < _V1_UNLIMITED:
                return limit
        except (OSError, ValueError):
            pass
    return 0


def _phys_mem_bytes() -> int:
    try:
        return int(os.sysconf("SC_PHYS_PAGES")) * int(os.sysconf("SC_PAGE_SIZE"))
    except (AttributeError, ValueError, OSError):
        return 0


def effective_mem_limit() -> int:
    """The bytes this process can actually allocate before the OOM
    killer visits: `KF_MEMORY_LIMIT` override first (rehearse a tight
    limit without a real cgroup), else the cgroup limit, else physical
    RAM. 0 means unknowable — headroom is then undefined, not faked."""
    override = int(knobs.get("KF_MEMORY_LIMIT"))
    if override > 0:
        return override
    limit = _cgroup_mem_limit()
    if limit > 0:
        return limit
    return _phys_mem_bytes()


# ---------------------------------------------------------------------------
# bounded deep sizeof + ring-cap measurement
# ---------------------------------------------------------------------------


def deep_sizeof(obj, max_nodes: int = 100_000) -> int:
    """Recursive ``sys.getsizeof`` over containers, bounded by
    ``max_nodes`` visited objects (telemetry must never spend unbounded
    CPU measuring itself). numpy arrays contribute ``nbytes`` without
    recursion; shared objects count once (id-visited)."""
    seen = set()
    total = 0
    stack = [obj]
    nodes = 0
    while stack and nodes < max_nodes:
        o = stack.pop()
        oid = id(o)
        if oid in seen:
            continue
        seen.add(oid)
        nodes += 1
        nbytes = getattr(o, "nbytes", None)
        if isinstance(nbytes, int):
            total += nbytes
            continue
        try:
            total += sys.getsizeof(o)
        except TypeError:
            total += 64
        if isinstance(o, dict):
            stack.extend(o.keys())
            stack.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset, deque)):
            stack.extend(o)
        elif hasattr(o, "__dict__") and not callable(o):
            stack.append(o.__dict__)
    return total


def ring_cap_bytes(ring) -> int:
    """A bounded ring's CAPACITY estimate in bytes: mean measured item
    size x maxlen, rounded UP to 1 KiB. Constant from the first item
    on, so a filling ring never looks like monotone growth to the leak
    watchdog — the "exempt by construction" contract. The quantization
    matters: the sampled mean jitters by a few bytes as items rotate
    (e.g. ``sys.getsizeof(0)`` is smaller than other small ints), and
    without it that jitter can drift monotonically across a fill and
    fake a streak. Unbounded containers (maxlen None) report their
    actual deep size: their growth is real."""
    try:
        items = list(ring)
    except TypeError:
        return deep_sizeof(ring)
    maxlen = getattr(ring, "maxlen", None)
    if not items:
        return 0
    if maxlen is None:
        return deep_sizeof(items)
    step = max(1, len(items) // 8)
    sample = items[::step][:8]
    mean = sum(deep_sizeof(i, max_nodes=2_000) for i in sample) / len(sample)
    return -(-int(mean * maxlen) // 1024) * 1024


# ---------------------------------------------------------------------------
# the accountant registry (module-level: owners register before the
# plane exists and survive plane resets)
# ---------------------------------------------------------------------------

_acct_lock = threading.Lock()
_accountants: Dict[int, Tuple[str, str, Callable[[], Optional[int]]]] = {}
_acct_seq = 0


class Accountant:
    """Handle returned by :func:`register_accountant`; ``close()``
    unregisters. Owners that cannot call close (e.g. weakref-tracked
    sessions) may instead return None from their fn — the registry
    drops the entry on the next sweep."""

    def __init__(self, key: int, name: str, bucket: str):
        self.key = key
        self.name = name
        self.bucket = bucket

    def close(self) -> None:
        with _acct_lock:
            _accountants.pop(self.key, None)


def register_accountant(
    name: str, bucket: str, fn: Callable[[], Optional[int]]
) -> Accountant:
    """Register a byte accountant: ``fn`` returns the owner's currently
    held bytes, or None when the owner is gone (the entry is then
    dropped — weakref-friendly, so the registry never pins a ZeRO
    session across an elastic resize). An fn that raises is dropped
    too: telemetry never kills training, and a broken accountant must
    not poison every future sweep."""
    global _acct_seq
    if bucket not in BUCKETS or bucket == "untracked":
        raise ValueError(f"unknown accountant bucket {bucket!r}")
    with _acct_lock:
        _acct_seq += 1
        key = _acct_seq
        _accountants[key] = (name, bucket, fn)
    return Accountant(key, name, bucket)


def register_owner(name: str, bucket: str, owner, measure: Callable[[object], int]) -> Accountant:
    """:func:`register_accountant` for a long-lived owner held weakly: the
    entry reports ``measure(owner)`` and drops itself once the owner is
    gone, so the registry never pins an arena across a reconnect, a
    session across a resize, or a ledger, store or plane across a reset."""
    ref = weakref.ref(owner)

    def fn() -> Optional[int]:
        o = ref()
        return None if o is None else measure(o)

    return register_accountant(name, bucket, fn)


def tracked_bytes() -> Tuple[Dict[str, int], Dict[str, int]]:
    """One registry pass: (per-bucket totals, per-accountant bytes).
    Dead accountants (fn returned None or raised) are dropped."""
    with _acct_lock:
        entries = list(_accountants.items())
    per_bucket: Dict[str, int] = {b: 0 for b in BUCKETS if b != "untracked"}
    per_name: Dict[str, int] = {}
    dead: List[int] = []
    for key, (name, bucket, fn) in entries:
        try:
            v = fn()
        # kfcheck: disable=KF400 — a raising accountant is dropped, not
        # retried forever and never allowed to break the sweep
        except BaseException:  # noqa: BLE001
            v = None
        if v is None:
            dead.append(key)
            continue
        v = max(0, int(v))
        per_bucket[bucket] += v
        per_name[name] = per_name.get(name, 0) + v
    if dead:
        with _acct_lock:
            for key in dead:
                _accountants.pop(key, None)
    return per_bucket, per_name


# ---------------------------------------------------------------------------
# process-level readers (injectable for tests)
# ---------------------------------------------------------------------------


def _default_rss(statm_path: str = "/proc/self/statm") -> Optional[int]:
    """Resident set size in bytes from /proc/self/statm field 1."""
    try:
        with open(statm_path) as f:
            parts = f.read().split()
        return int(parts[1]) * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def parse_majflt(line: str) -> Optional[int]:
    """Cumulative major page faults from a /proc/<pid>/stat line. The
    comm field may contain spaces and parens, so split after the LAST
    ')': majflt is field 12 of the full line, index 9 of the tail."""
    end = line.rfind(")")
    if end < 0:
        return None
    rest = line[end + 1:].split()
    if len(rest) < 10:
        return None
    try:
        return int(rest[9])
    except ValueError:
        return None


def _default_majflt(stat_path: str = "/proc/self/stat") -> Optional[int]:
    try:
        with open(stat_path) as f:
            return parse_majflt(f.read())
    except OSError:
        return None


def _default_steps() -> Optional[float]:
    """The training step counter, for the steps-to-exhaustion estimate
    (same read the flight recorder uses for its step anchor)."""
    try:
        from kungfu_tpu_torch.telemetry import metrics as tmetrics

        m = tmetrics.get_registry().get("kungfu_steps_total")
        return m.value if m is not None else None
    except ValueError:
        return None


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------


class MemoryPlane:
    """One worker's memory attribution plane (the /memory doc)."""

    def __init__(
        self,
        interval: Optional[float] = None,
        windows: Optional[int] = None,
        warmup: Optional[float] = None,
        trend_keep: Optional[int] = None,
        rss_fn: Callable[[], Optional[int]] = _default_rss,
        limit_fn: Callable[[], int] = effective_mem_limit,
        majflt_fn: Callable[[], Optional[int]] = _default_majflt,
        steps_fn: Callable[[], Optional[float]] = _default_steps,
    ):
        self.interval = (
            interval if interval is not None
            else max(0.1, float(knobs.get("KF_MEMORY_INTERVAL")))
        )
        self.windows = (
            windows if windows is not None
            else max(2, int(knobs.get("KF_MEMORY_WINDOWS")))
        )
        self.warmup = (
            warmup if warmup is not None
            else max(0.0, float(knobs.get("KF_MEMORY_WARMUP")))
        )
        self._born = time.perf_counter()
        trend_keep = (
            trend_keep if trend_keep is not None
            else max(4, int(knobs.get("KF_MEMORY_TREND")))
        )
        self._rss_fn = rss_fn
        self._limit_fn = limit_fn
        self._majflt_fn = majflt_fn
        self._steps_fn = steps_fn
        self._lock = threading.Lock()
        self._sweep_lock = threading.Lock()
        self._last_sweep: Optional[float] = None
        self._limit: Optional[int] = None
        self._trend: "deque[Tuple[float, int]]" = deque(maxlen=trend_keep)
        # watchdog state: last seen bytes + strict-growth streak per
        # bucket, and the one-shot fired set
        self._prev_bytes: Dict[str, int] = {}
        self._streak: Dict[str, int] = {}
        self._fired: List[str] = []
        # thrash state
        self._prev_majflt: Optional[int] = None
        self._prev_majflt_at: Optional[float] = None
        self._majflt_rate: Optional[float] = None
        # step-rate state
        self._prev_steps: Optional[float] = None
        self._steps_rate: Optional[float] = None
        # last sweep snapshot
        self._rss: Optional[int] = None
        self._buckets: Dict[str, int] = {}
        self._per_name: Dict[str, int] = {}
        self._sweeps = 0

    # -- limit (cached: cgroup files don't change under us) -------------
    def limit_bytes(self) -> int:
        if self._limit is None:
            try:
                self._limit = max(0, int(self._limit_fn()))
            # kfcheck: disable=KF400 — an unreadable cgroup surface
            # degrades to "no limit known" (headroom undefined);
            # telemetry never kills training
            except BaseException:  # noqa: BLE001
                self._limit = 0
        return self._limit

    def supported(self) -> bool:
        return self._rss is not None or self._rss_fn() is not None

    # -- sweeping --------------------------------------------------------
    def maybe_sweep(self, force: bool = False) -> None:
        """Throttled on-demand sweep — every reader path funnels here,
        so the plane needs no sweeper thread of its own."""
        now = time.perf_counter()
        with self._sweep_lock:
            if (
                not force
                and self._last_sweep is not None
                and now - self._last_sweep < self.interval
            ):
                return
            self._last_sweep = now
        self._sweep(now)
        self._publish_metrics()

    def _sweep(self, now: float) -> None:
        rss = self._rss_fn()
        per_bucket, per_name = tracked_bytes()
        fired_now: List[str] = []
        with self._lock:
            self._sweeps += 1
            self._per_name = per_name
            if rss is not None:
                tracked = sum(per_bucket.values())
                per_bucket["untracked"] = max(0, rss - tracked)
                self._rss = rss
                self._trend.append((now, rss))
            self._buckets = per_bucket
            # leak watchdog: strict growth streak per bucket. Bounded
            # rings report their cap, so ring fill never streaks; and
            # nothing streaks before the warmup grace elapses — boot
            # growth (imports, first allocations) is expected, and a
            # real leak keeps growing long after the transient.
            armed = self.warmup <= 0 or now - self._born >= self.warmup
            for bucket, nbytes in per_bucket.items():
                prev = self._prev_bytes.get(bucket)
                if armed and prev is not None and nbytes > prev:
                    self._streak[bucket] = self._streak.get(bucket, 0) + 1
                else:
                    self._streak[bucket] = 0
                self._prev_bytes[bucket] = nbytes
                if (
                    self._streak[bucket] >= self.windows
                    and bucket not in self._fired
                ):
                    self._fired.append(bucket)
                    fired_now.append(bucket)
            # thrash rate: major faults per second over the window
            mf = self._majflt_fn()
            if mf is not None and self._prev_majflt is not None:
                dt = now - (self._prev_majflt_at or now)
                if dt > 0 and mf >= self._prev_majflt:
                    self._majflt_rate = (mf - self._prev_majflt) / dt
            if mf is not None:
                self._prev_majflt = mf
                self._prev_majflt_at = now
            # step rate (for steps-to-exhaustion)
            steps = self._steps_fn()
            if (
                steps is not None
                and self._prev_steps is not None
                and self._last_window_s() > 0
                and steps >= self._prev_steps  # restart resets to 0
            ):
                self._steps_rate = (
                    (steps - self._prev_steps) / self._last_window_s()
                )
            self._prev_steps = steps
        for bucket in fired_now:
            self._fire_leak(bucket)

    def _last_window_s(self) -> float:
        if len(self._trend) < 2:
            return 0.0
        return max(0.0, self._trend[-1][0] - self._trend[-2][0])

    def _fire_leak(self, bucket: str) -> None:
        try:
            from kungfu_tpu_torch.telemetry import audit

            audit.record_event(
                "memory_leak_suspect",
                trigger="leak_watchdog",
                bucket=bucket,
                windows=self.windows,
                bytes=self._buckets.get(bucket, 0),
            )
        # kfcheck: disable=KF400 — the watchdog verdict must not kill
        # the sweep if the audit ring is mid-teardown
        except BaseException:  # noqa: BLE001
            pass

    # -- trend / forecast ------------------------------------------------
    def trend_bytes_per_s(self) -> Optional[float]:
        """Least-squares RSS slope over the trend window, or None when
        there are too few samples or the fit is noise (fitted growth
        under 2x the RMS residual) — an honest None, never a fabricated
        forecast."""
        with self._lock:
            pts = list(self._trend)
        if len(pts) < 4:
            return None
        t0 = pts[0][0]
        xs = [t - t0 for t, _ in pts]
        ys = [float(r) for _, r in pts]
        n = len(pts)
        mx = sum(xs) / n
        my = sum(ys) / n
        den = sum((x - mx) ** 2 for x in xs)
        if den <= 0:
            return None
        slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den
        b = my - slope * mx
        rms = (
            sum((y - (slope * x + b)) ** 2 for x, y in zip(xs, ys)) / n
        ) ** 0.5
        span = xs[-1] - xs[0]
        if abs(slope) * span <= 2.0 * rms:
            return None  # flat or noisy — no trend
        return slope

    def headroom_frac(self) -> Optional[float]:
        limit = self.limit_bytes()
        with self._lock:
            rss = self._rss
        if limit <= 0 or rss is None:
            return None
        return max(0.0, (limit - rss) / limit)

    def forecast(self) -> Tuple[Optional[float], Optional[float]]:
        """(seconds, steps) to exhaustion at the current trend, both
        None unless the trend is a real positive slope AND the limit is
        known (steps additionally needs a measured step rate)."""
        slope = self.trend_bytes_per_s()
        limit = self.limit_bytes()
        with self._lock:
            rss = self._rss
            steps_rate = self._steps_rate
        if slope is None or slope <= 0 or limit <= 0 or rss is None:
            return None, None
        secs = max(0.0, (limit - rss) / slope)
        steps = (
            secs * steps_rate
            if steps_rate is not None and steps_rate > 0 else None
        )
        return secs, steps

    # -- metrics ---------------------------------------------------------
    def _publish_metrics(self) -> None:
        if not tconfig.metrics_enabled():
            return
        try:
            from kungfu_tpu_torch.telemetry import metrics as tmetrics

            g_bytes = tmetrics.gauge(
                "kungfu_memory_bytes",
                "Resident bytes attributed to each subsystem bucket "
                "(untracked = RSS minus everything the accountants "
                "explain)",
                ("bucket",),
            )
            with self._lock:
                buckets = dict(self._buckets)
            for bucket, nbytes in buckets.items():
                g_bytes.labels(bucket=bucket).set(float(nbytes))
            limit = self.limit_bytes()
            tmetrics.gauge(
                "kungfu_memory_limit_bytes",
                "Effective memory limit (KF_MEMORY_LIMIT override, "
                "cgroup v2/v1, or physical RAM); 0 when unknowable",
            ).set(float(limit))
            hf = self.headroom_frac()
            if hf is not None:
                tmetrics.gauge(
                    "kungfu_memory_headroom_frac",
                    "Fraction of the effective memory limit still free "
                    "(limit - rss) / limit",
                ).set(hf)
        # kfcheck: disable=KF400 — gauge publication rides the sweep
        # path; a registry hiccup must cost one publication, not the
        # accounting loop
        except BaseException:  # noqa: BLE001
            pass

    # -- export / signals ------------------------------------------------
    def export(self, peer: str = "") -> dict:
        """The /memory document (perf-clock anchors match the
        X-KF-Perf-Now-Us header timebase, like /resources)."""
        self.maybe_sweep()
        with self._lock:
            rss = self._rss
            buckets = dict(self._buckets)
            per_name = dict(self._per_name)
            sweeps = self._sweeps
            majflt_rate = self._majflt_rate
            fired = list(self._fired)
        limit = self.limit_bytes()
        hf = self.headroom_frac()
        secs, steps = self.forecast()
        bucket_docs = {}
        for b in BUCKETS:
            nbytes = buckets.get(b, 0)
            bucket_docs[b] = {
                "bytes": nbytes,
                "frac": round(nbytes / rss, 6) if rss else 0.0,
            }
        thrashing = (
            majflt_rate is not None and majflt_rate >= THRASH_FAULTS_PER_S
        )
        return {
            "peer": peer or knobs.raw("KF_SELF_SPEC"),
            "perf_now_us": _now_us(),
            "wall_time_s": time.time(),
            "supported": rss is not None,
            "rss_bytes": rss,
            "limit_bytes": limit,
            "headroom_frac": round(hf, 6) if hf is not None else None,
            "trend_bytes_per_s": self.trend_bytes_per_s(),
            "exhaustion_s": round(secs, 3) if secs is not None else None,
            "steps_to_exhaustion": (
                round(steps, 1) if steps is not None else None
            ),
            "majflt_rate": (
                round(majflt_rate, 3) if majflt_rate is not None else None
            ),
            "thrashing": thrashing,
            "pressure": hf is not None and hf <= PRESSURE_FRAC,
            "interval_s": self.interval,
            "sweeps": sweeps,
            "buckets": bucket_docs,
            "accountants": per_name,
            "leak_suspects": fired,
        }

    def signals(self) -> Dict[str, object]:
        """Worker-local adaptation signals (PolicyContext.metrics).
        Empty until two sweeps exist; headroom/pressure only when a
        limit is actually known — never fabricate."""
        self.maybe_sweep()
        with self._lock:
            sweeps = self._sweeps
            rss = self._rss
            fired = bool(self._fired)
        if rss is None or sweeps < 2:
            return {}
        out: Dict[str, object] = {"memory/leak_suspect": fired}
        hf = self.headroom_frac()
        if hf is not None:
            out["memory/headroom_frac"] = hf
            out["memory/pressure"] = hf <= PRESSURE_FRAC
        return out

    def grow_ok(self) -> Tuple[bool, str]:
        """The elastic grow gate: may this worker's cluster safely grow
        right now? (True, "unmeasured") when headroom is unknown — an
        unmeasured peer must never block a resize — and (False, why)
        only under MEASURED pressure."""
        sig = self.signals()
        hf = sig.get("memory/headroom_frac")
        if not isinstance(hf, (int, float)):
            return True, "unmeasured"
        if hf <= PRESSURE_FRAC:
            return False, (
                f"headroom {hf:.0%} <= pressure line {PRESSURE_FRAC:.0%}"
            )
        return True, f"headroom {hf:.0%}"

    def close(self) -> None:
        pass  # the plane owns no threads and no accountants


_plane: Optional[MemoryPlane] = None
_plane_lock = threading.Lock()


def get_plane() -> MemoryPlane:
    global _plane
    with _plane_lock:
        if _plane is None:
            _plane = MemoryPlane()
        return _plane


def reset_plane() -> None:
    """Drop the process plane (tests flip knobs at runtime). The
    accountant registry is module-level and survives: owners register
    once at construction, not per plane."""
    global _plane
    with _plane_lock:
        if _plane is not None:
            _plane.close()
        _plane = None


# ---------------------------------------------------------------------------
# merge math (pure: the aggregator and tests drive it)
# ---------------------------------------------------------------------------


def merge_memory(
    peer_docs: Dict[str, dict],
    offsets_us: Dict[str, float],
) -> dict:
    """Merge every peer's /memory document into one cluster view:
    per-peer rows with their anchors aligned onto the merger's clock,
    plus the cluster-wide elections the autoscaler and the straggler
    classifier consult (minimum headroom + its peer, the
    under-pressure and thrashing sets, who suspects a leak)."""
    peers: Dict[str, dict] = {}
    pressure: List[str] = []
    thrashing: List[str] = []
    leaks: Dict[str, List[str]] = {}
    min_hf = None
    min_peer = None
    for peer, doc in sorted(peer_docs.items()):
        if not doc:
            continue
        off = offsets_us.get(peer) or 0.0
        row = dict(doc)
        if isinstance(row.get("perf_now_us"), (int, float)):
            row["perf_now_us"] = row["perf_now_us"] + off
        peers[peer] = row
        hf = row.get("headroom_frac")
        if isinstance(hf, (int, float)):
            if min_hf is None or hf < min_hf:
                min_hf, min_peer = hf, peer
        if row.get("pressure"):
            pressure.append(peer)
        if row.get("thrashing"):
            thrashing.append(peer)
        if row.get("leak_suspects"):
            leaks[peer] = list(row["leak_suspects"])
    return {
        "peers": peers,
        "min_headroom_frac": min_hf,
        "min_headroom_peer": min_peer,
        "pressure": sorted(pressure),
        "thrashing": sorted(thrashing),
        "leak_suspects": leaks,
    }


def peer_thrashing(merged: Optional[dict], peer: str) -> bool:
    """Does the merged cluster view say this peer is paging? False on
    no data — the caller must never fabricate a cause."""
    if not merged:
        return False
    row = (merged.get("peers") or {}).get(str(peer))
    return bool(row and row.get("thrashing"))


# ---------------------------------------------------------------------------
# rendering (info memory + the flight postmortem's final attribution)
# ---------------------------------------------------------------------------

_COLS = ("PEER", "RSS", "LIMIT", "MEM%", "HEADROOM", "TREND/S", "ARENA",
         "POOL", "ZERO", "SCHED", "TELEM", "UNTRK%", "FLAGS")


def fmt_bytes(v) -> str:
    if not isinstance(v, (int, float)):
        return "-"
    v = float(v)
    for unit in ("B", "K", "M", "G", "T"):
        if abs(v) < 1024 or unit == "T":
            return f"{v:.0f}{unit}" if unit == "B" else f"{v:.1f}{unit}"
        v /= 1024
    return "-"


def _pct(v) -> str:
    return f"{v * 100:.0f}" if isinstance(v, (int, float)) else "-"


def _row_flags(doc: dict) -> str:
    flags = []
    if doc.get("pressure"):
        flags.append("PRESSURE")
    if doc.get("thrashing"):
        flags.append("THRASHING")
    if doc.get("leak_suspects"):
        flags.append("leak:" + ",".join(doc["leak_suspects"]))
    secs = doc.get("exhaustion_s")
    if isinstance(secs, (int, float)):
        flags.append(f"oom~{secs:.0f}s")
    return " ".join(flags)


def render_memory(merged: dict) -> List[str]:
    """The merged cluster view as a table: per peer the RSS, limit,
    used/headroom fractions, RSS trend and the bucket decomposition
    (untracked as a share of RSS — the honesty column)."""
    peers = merged.get("peers") or {}
    rows = []
    for peer, doc in sorted(peers.items()):
        if not doc.get("supported", True):
            rows.append((peer,) + ("-",) * 11 + ("unsupported",))
            continue
        buckets = doc.get("buckets") or {}
        rss = doc.get("rss_bytes")
        limit = doc.get("limit_bytes")
        hf = doc.get("headroom_frac")
        used = (
            1.0 - hf if isinstance(hf, (int, float)) else None
        )
        trend = doc.get("trend_bytes_per_s")
        rows.append((
            peer,
            fmt_bytes(rss),
            fmt_bytes(limit) if limit else "-",
            _pct(used),
            _pct(hf),
            fmt_bytes(trend) if trend is not None else "-",
            *(
                fmt_bytes((buckets.get(b) or {}).get("bytes"))
                for b in ("arena", "pool", "zero_state", "sched_inflight",
                          "telemetry")
            ),
            _pct((buckets.get("untracked") or {}).get("frac")),
            _row_flags(doc),
        ))
    widths = [
        max(len(_COLS[i]), max((len(r[i]) for r in rows), default=0))
        for i in range(len(_COLS))
    ]
    lines = ["  ".join(c.ljust(widths[i]) for i, c in enumerate(_COLS))]
    for r in rows:
        lines.append("  ".join(c.ljust(widths[i]) for i, c in enumerate(r)))
    summary = f"{len(peers)} peers"
    if isinstance(merged.get("min_headroom_frac"), (int, float)):
        summary += (
            f", min headroom {merged['min_headroom_frac']:.0%}"
            f" ({merged.get('min_headroom_peer')})"
        )
    if merged.get("pressure"):
        summary += f", pressure: {', '.join(merged['pressure'])}"
    if merged.get("thrashing"):
        summary += f", thrashing: {', '.join(merged['thrashing'])}"
    if merged.get("leak_suspects"):
        summary += ", leaks: " + ", ".join(
            f"{p}({','.join(bs)})"
            for p, bs in sorted(merged["leak_suspects"].items())
        )
    lines.append(summary)
    return lines


def render_worker_memory(doc: dict) -> List[str]:
    """One UNMERGED worker document (the postmortem's final memory
    attribution: no cluster view exists for a dead worker)."""
    if not doc:
        return ["no memory data"]
    if not doc.get("supported", True):
        return ["memory accounting unsupported on this platform"]
    lines = []
    head = f"rss {fmt_bytes(doc.get('rss_bytes'))}"
    limit = doc.get("limit_bytes")
    if limit:
        head += f" of {fmt_bytes(limit)} limit"
    hf = doc.get("headroom_frac")
    if isinstance(hf, (int, float)):
        head += f"  ({hf:.0%} headroom)"
    trend = doc.get("trend_bytes_per_s")
    if isinstance(trend, (int, float)):
        head += f"  trend {fmt_bytes(trend)}/s"
    lines.append(head)
    buckets = doc.get("buckets") or {}
    for b in BUCKETS:
        info = buckets.get(b) or {}
        nbytes = info.get("bytes")
        if not isinstance(nbytes, (int, float)) or nbytes <= 0:
            continue
        lines.append(
            f"  {b:<14} {fmt_bytes(nbytes):>8}"
            f"  {_pct(info.get('frac')):>4}% of rss"
        )
    flags = _row_flags(doc)
    if flags:
        lines.append(f"  flags: {flags}")
    return lines

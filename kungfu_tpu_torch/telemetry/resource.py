"""Resource attribution plane: per-thread CPU accounting + sampling
profiler.

Port of `kungfu_tpu/telemetry/resource.py`; its documents, metric
families and renderings are the reference's, so either package's
aggregator merges the other's workers. The other planes measure the
network side of the step (the link matrix says which edge is slow, the
step plane which bucket blocked, the decision ledger whether an
adaptation paid); this one answers *"is this peer compute-bound or
network-bound?"*, in two parts:

- **Per-thread CPU accounting** (:class:`CpuAccountant`): utime/stime
  deltas per sweep from ``/proc/self/task/*/stat`` (a graceful no-op off
  Linux), attributed through the package's thread names onto subsystem
  buckets {train, walk_compute, codec, sched, telemetry, other}: every
  CPU-second the process burns lands in exactly one bucket, unknown
  names in ``other``, never dropped.
- **Sampling profiler** (:class:`SamplingProfiler`, optional):
  ``sys._current_frames()`` at ``KF_RESOURCE_SAMPLE_HZ`` into a bounded
  ring (``KF_RESOURCE_KEEP``), aggregated by module prefix, splitting
  the main thread into train-compute vs blocked-in-engine.
  ``KF_RESOURCE_SAMPLE_HZ=0`` (the default) means the sampler thread is
  never started and allocates nothing.

Sweeps are on-demand (no sweeper thread): ``export()`` / ``signals()``
trigger a sweep at most every ``KF_RESOURCE_INTERVAL`` seconds. Served
at worker ``/resources`` with perf-clock anchors; merged by the cluster
aggregator at ``/cluster/resources``. The plane's three consumers:
``PolicyContext.metrics`` (``resource/cpu_frac`` / ``engine_frac`` /
``saturated``), straggler cause classification (network vs compute),
and ``derive_plan``'s predicted-gain compute clamp through the session's
``measured_compute_frac``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.telemetry import config as tconfig
from kungfu_tpu_torch.telemetry import memory as tmemory

_US = 1e6


def _now_us() -> float:
    return time.perf_counter() * _US


# ---------------------------------------------------------------------------
# thread-name -> subsystem bucket
# ---------------------------------------------------------------------------

BUCKETS = ("train", "walk_compute", "codec", "sched", "telemetry", "other")

# the saturation line: a peer whose window burned >= this fraction of
# its effective cores is compute-bound (adding network bandwidth cannot
# speed it up — the signal the replan clamp and straggler cause need)
SATURATION_FRAC = 0.9

# longest prefix wins; every thread name the package declares:
#   kf-sched-walk     the walk engine's graph walks (reduce + transport)
#   kf-sched-unpack   walk-end decode/unpack — the codec's CPU
#   kf-sched-launch/gather  scheduler bookkeeping
#   kf-pool-*         cached-pool workers (chunked walk fan-outs)
#   kf-cluster/-health/-flight/-lockwatch/-resource  telemetry planes
_PREFIX_BUCKETS: Tuple[Tuple[str, str], ...] = (
    ("kf-sched-walk", "walk_compute"),
    ("kf-sched-unpack", "codec"),
    ("kf-sched-launch", "sched"),
    ("kf-sched-gather", "sched"),
    ("kf-pool", "walk_compute"),
    ("kf-cluster", "telemetry"),
    ("kf-health", "telemetry"),
    ("kf-flight", "telemetry"),
    ("kf-lockwatch", "telemetry"),
    ("kf-resource", "telemetry"),
)


def bucket_for(name: str, is_main: bool = False) -> str:
    """The subsystem bucket a thread's CPU time belongs to. The main
    thread is the training loop by definition; unknown names land in
    ``other`` — attributed somewhere, never dropped."""
    if is_main:
        return "train"
    for prefix, bucket in _PREFIX_BUCKETS:
        if name.startswith(prefix):
            return bucket
    return "other"


def effective_cores() -> float:
    """The cores this process can actually burn (affinity + cgroup
    quota aware) — lazy import: the telemetry layer must stay
    import-light and strategies pulls numpy."""
    from kungfu_tpu_torch.collective.strategies import effective_cpu_count

    return float(effective_cpu_count())


# ---------------------------------------------------------------------------
# per-thread CPU accounting (/proc/self/task/*/stat)
# ---------------------------------------------------------------------------


def _default_names() -> Dict[int, str]:
    """native_id -> thread name for every live Python thread."""
    out: Dict[int, str] = {}
    for t in threading.enumerate():
        tid = getattr(t, "native_id", None)
        if tid is not None:
            out[int(tid)] = t.name
    return out


def _default_main_tid() -> Optional[int]:
    tid = getattr(threading.main_thread(), "native_id", None)
    return int(tid) if tid is not None else None


def parse_stat(line: str, clk_tck: float) -> Optional[float]:
    """Cumulative CPU seconds (utime+stime) from one task stat line.
    The comm field may contain spaces and parens, so split after the
    LAST ')': fields 14/15 of the full line are 12/13 of the tail."""
    end = line.rfind(")")
    if end < 0:
        return None
    rest = line[end + 1:].split()
    if len(rest) < 13:
        return None
    try:
        return (int(rest[11]) + int(rest[12])) / clk_tck
    except ValueError:
        return None


class CpuAccountant:
    """Delta accounting of per-thread CPU seconds onto buckets.

    Injectable taskdir/clk_tck/name sources keep the delta math testable
    on fake /proc fixtures; the default reads the live process. Off
    Linux (no taskdir) every sweep is a graceful no-op and the exported
    document says ``supported: false``.
    """

    def __init__(
        self,
        taskdir: str = "/proc/self/task",
        clk_tck: Optional[float] = None,
        names_fn: Callable[[], Dict[int, str]] = _default_names,
        main_tid_fn: Callable[[], Optional[int]] = _default_main_tid,
    ):
        self.taskdir = taskdir
        if clk_tck is None:
            try:
                clk_tck = float(os.sysconf("SC_CLK_TCK"))
            except (AttributeError, ValueError, OSError):
                clk_tck = 100.0
        self.clk_tck = clk_tck or 100.0
        self._names_fn = names_fn
        self._main_tid_fn = main_tid_fn
        self._lock = threading.Lock()
        self._prev: Dict[int, float] = {}  # tid -> cumulative cpu_s
        self._prev_at: Optional[float] = None  # perf seconds
        self._totals: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._window: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._window_s = 0.0
        self._sweeps = 0
        self._threads = 0

    def supported(self) -> bool:
        return os.path.isdir(self.taskdir)

    def _read(self) -> Dict[int, float]:
        out: Dict[int, float] = {}
        try:
            tids = os.listdir(self.taskdir)
        except OSError:
            return out
        for tid in tids:
            try:
                with open(os.path.join(self.taskdir, tid, "stat")) as f:
                    cpu = parse_stat(f.read(), self.clk_tck)
            except (OSError, ValueError):
                continue  # the thread exited between listdir and open
            if cpu is not None:
                try:
                    out[int(tid)] = cpu
                except ValueError:
                    continue
        return out

    def sweep(self) -> None:
        """One accounting pass: read every task's cumulative CPU time,
        attribute the delta since the previous sweep to its thread's
        bucket. A first-seen tid contributes its full history to the
        bucket TOTALS (CPU burned before the plane came up is still
        attributed) but not to the window — window fractions only ever
        compare like-for-like intervals."""
        if not self.supported():
            return
        now = time.perf_counter()
        cur = self._read()
        names = self._names_fn()
        main_tid = self._main_tid_fn()
        with self._lock:
            window: Dict[str, float] = {b: 0.0 for b in BUCKETS}
            for tid, cpu in cur.items():
                bucket = bucket_for(names.get(tid, ""), tid == main_tid)
                prev = self._prev.get(tid)
                if prev is None:
                    self._totals[bucket] += cpu
                else:
                    d = max(0.0, cpu - prev)
                    self._totals[bucket] += d
                    window[bucket] += d
            if self._prev_at is not None:
                self._window = window
                self._window_s = max(1e-9, now - self._prev_at)
            self._prev = cur
            self._prev_at = now
            self._sweeps += 1
            self._threads = len(cur)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "totals": dict(self._totals),
                "window": dict(self._window),
                "window_s": self._window_s,
                "sweeps": self._sweeps,
                "threads": self._threads,
            }


# ---------------------------------------------------------------------------
# sampling profiler (KF_RESOURCE_SAMPLE_HZ > 0 only)
# ---------------------------------------------------------------------------

_ENGINE_PREFIX = "kungfu_tpu_torch"


def classify_main_frame(frame) -> str:
    """'engine' when the main thread is anywhere inside kungfu_tpu_torch
    (blocked in a collective, flushing the scheduler), else
    'train_compute' — user model code, input pipeline, optimizer."""
    f = frame
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if isinstance(mod, str) and mod.startswith(_ENGINE_PREFIX):
            return "engine"
        f = f.f_back
    return "train_compute"


class SamplingProfiler:
    """Bounded-ring stack sampler. Only ever constructed when the HZ
    knob is positive — with ``KF_RESOURCE_SAMPLE_HZ=0`` the plane
    allocates NO profiler object and starts no thread (the class-level
    ``allocations`` counter is subprocess-asserted to stay 0, the
    lockwatch/steptrace overhead-guard contract)."""

    allocations = 0

    def __init__(
        self,
        hz: float,
        keep: int,
        main_tid_fn: Callable[[], Optional[int]] = None,
    ):
        SamplingProfiler.allocations += 1
        self.hz = max(0.01, float(hz))
        self._ring: "deque[Tuple[str, Tuple[str, ...]]]" = deque(
            maxlen=max(1, int(keep))
        )
        self._lock = threading.Lock()
        self._main_tid_fn = main_tid_fn or (
            lambda: getattr(threading.main_thread(), "ident", None)
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="kf-resource-sample", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _loop(self) -> None:
        period = 1.0 / self.hz
        while not self._stop.wait(period):
            try:
                self.sample_once()
            # the sampler thread must survive
            # any race with interpreter/thread teardown; a lost sample
            # is invisible, a dead sampler thread silently ends the
            # profile
            except BaseException:  # noqa: BLE001
                pass

    def sample_once(self, frames: Optional[dict] = None) -> None:
        """One sample (injectable frames make the classification
        deterministic under test): classify the main thread, aggregate
        every thread's top-of-stack module prefix."""
        if frames is None:
            frames = sys._current_frames()
        main_ident = self._main_tid_fn()
        main_class = ""
        prefixes: List[str] = []
        for ident, frame in frames.items():
            if ident == main_ident:
                main_class = classify_main_frame(frame)
            mod = frame.f_globals.get("__name__", "") or "?"
            prefixes.append(".".join(str(mod).split(".")[:2]))
        with self._lock:
            self._ring.append((main_class, tuple(sorted(prefixes))))

    def profile(self) -> dict:
        """Ring aggregation: main-thread split + module-prefix counts."""
        with self._lock:
            samples = list(self._ring)
        main: Dict[str, int] = {"train_compute": 0, "engine": 0}
        mods: Dict[str, int] = {}
        for main_class, prefixes in samples:
            if main_class in main:
                main[main_class] += 1
            for p in prefixes:
                mods[p] = mods.get(p, 0) + 1
        n = len(samples)
        return {
            "hz": self.hz,
            "samples": n,
            "main": main,
            "main_engine_frac": (main["engine"] / n) if n else None,
            "modules": dict(
                sorted(mods.items(), key=lambda kv: -kv[1])[:16]
            ),
        }


# ---------------------------------------------------------------------------
# the plane: accountant + optional profiler + metrics + signals
# ---------------------------------------------------------------------------


class ResourcePlane:
    """One worker's resource attribution plane (the /resources doc)."""

    def __init__(
        self,
        interval: Optional[float] = None,
        sample_hz: Optional[float] = None,
        keep: Optional[int] = None,
        accountant: Optional[CpuAccountant] = None,
        cores_fn: Callable[[], float] = effective_cores,
    ):
        self.interval = (
            interval if interval is not None
            else max(0.1, float(knobs.get("KF_RESOURCE_INTERVAL")))
        )
        hz = (
            sample_hz if sample_hz is not None
            else float(knobs.get("KF_RESOURCE_SAMPLE_HZ"))
        )
        keep = (
            keep if keep is not None
            else max(1, int(knobs.get("KF_RESOURCE_KEEP")))
        )
        self.acct = accountant if accountant is not None else CpuAccountant()
        self._cores_fn = cores_fn
        self._cores: Optional[float] = None
        self._sweep_lock = threading.Lock()
        self._last_sweep: Optional[float] = None
        self._published: Dict[str, float] = {}
        # hz=0: no profiler OBJECT, no thread, no ring — the zero-cost
        # default (subprocess-asserted)
        self.profiler: Optional[SamplingProfiler] = None
        if hz > 0:
            self.profiler = SamplingProfiler(hz, keep)
            self.profiler.start()
        # memory plane: the resource plane itself is a long-lived buffer
        # owner (profiler ring + per-thread CPU tables), accounted under
        # `telemetry` like the other rings; weakly, so reset_plane()
        # doesn't pin the old instance
        tmemory.register_owner("resource_plane", "telemetry", self,
                               lambda plane: plane.footprint_bytes())

    def footprint_bytes(self) -> int:
        """Bytes held by the plane's bounded state (memory plane
        `telemetry` bucket): profiler ring at CAP plus CPU tables."""
        with self.acct._lock:
            acct_state = (
                dict(self.acct._prev),
                dict(self.acct._totals),
                dict(self.acct._window),
            )
        total = tmemory.deep_sizeof((acct_state, dict(self._published)))
        prof = self.profiler
        if prof is not None:
            with prof._lock:
                ring = deque(prof._ring, maxlen=prof._ring.maxlen)
            total += tmemory.ring_cap_bytes(ring)
        return total

    def cores(self) -> float:
        if self._cores is None:
            try:
                self._cores = max(1.0, self._cores_fn())
            # an unreadable affinity/cgroup
            # surface degrades to 1 core (fractions stay defined);
            # telemetry never kills training
            except BaseException:  # noqa: BLE001
                self._cores = 1.0
        return self._cores

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
        self.acct.sweep()
        self._publish_metrics()

    def _publish_metrics(self) -> None:
        if not tconfig.metrics_enabled():
            return
        try:
            from kungfu_tpu_torch.telemetry import metrics as tmetrics

            snap = self.acct.snapshot()
            ctr = tmetrics.counter(
                "kungfu_resource_cpu_seconds_total",
                "CPU seconds burned by this worker, attributed to "
                "subsystem buckets via per-thread accounting",
                ("bucket",),
            )
            g_frac = tmetrics.gauge(
                "kungfu_resource_cpu_frac",
                "Fraction of this worker's effective cores each bucket "
                "burned over the last accounting window",
                ("bucket",),
            )
            cores = self.cores()
            win_s = snap["window_s"]
            for bucket in BUCKETS:
                total = snap["totals"].get(bucket, 0.0)
                prev = self._published.get(bucket, 0.0)
                if total > prev:
                    ctr.labels(bucket=bucket).inc(total - prev)
                    self._published[bucket] = total
                frac = (
                    snap["window"].get(bucket, 0.0) / win_s / cores
                    if win_s > 0 else 0.0
                )
                g_frac.labels(bucket=bucket).set(frac)
            tmetrics.gauge(
                "kungfu_resource_cores_available",
                "Effective cores available to this worker "
                "(affinity + cgroup quota aware)",
            ).set(cores)
        # gauge publication rides the sweep
        # path; a registry hiccup (cardinality guard, teardown race)
        # must cost one publication, not the accounting loop
        except BaseException:  # noqa: BLE001
            pass

    # -- derived fractions ----------------------------------------------
    def _fractions(self, snap: dict) -> dict:
        win_s = snap["window_s"]
        busy = sum(snap["window"].values())
        cores = self.cores()
        cpu_frac = busy / win_s / cores if win_s > 0 else 0.0
        engine = sum(
            snap["window"].get(b, 0.0)
            for b in ("walk_compute", "codec", "sched")
        )
        return {
            "cpu_frac": cpu_frac,
            "engine_frac": (engine / busy) if busy > 0 else 0.0,
            "saturated": cpu_frac >= SATURATION_FRAC,
        }

    def export(self, peer: str = "") -> dict:
        """The /resources document (perf-clock anchors match the
        X-KF-Perf-Now-Us header timebase, like /steptrace)."""
        self.maybe_sweep()
        snap = self.acct.snapshot()
        fr = self._fractions(snap)
        busy = sum(snap["window"].values())
        buckets = {}
        for b in BUCKETS:
            buckets[b] = {
                "cpu_s": round(snap["totals"].get(b, 0.0), 6),
                "window_s": round(snap["window"].get(b, 0.0), 6),
                "frac": (
                    round(snap["window"].get(b, 0.0) / busy, 6)
                    if busy > 0 else 0.0
                ),
            }
        doc = {
            "peer": peer or knobs.raw("KF_SELF_SPEC"),
            "perf_now_us": _now_us(),
            "wall_time_s": time.time(),
            "supported": self.acct.supported(),
            "cores": self.cores(),
            "interval_s": self.interval,
            "sweeps": snap["sweeps"],
            "threads": snap["threads"],
            "window_s": round(snap["window_s"], 6),
            "cpu_frac": round(fr["cpu_frac"], 6),
            "engine_frac": round(fr["engine_frac"], 6),
            "saturated": fr["saturated"],
            "buckets": buckets,
        }
        if self.profiler is not None:
            doc["profile"] = self.profiler.profile()
        return doc

    def signals(self) -> Dict[str, object]:
        """Worker-local adaptation signals (PolicyContext.metrics):
        how much of this peer's CPU capacity the window burned, the
        engine's share of that burn, and the compute-bound flag."""
        if not self.acct.supported():
            return {}
        self.maybe_sweep()
        snap = self.acct.snapshot()
        if snap["sweeps"] < 2:
            return {}  # no window yet — never fabricate a fraction
        fr = self._fractions(snap)
        return {
            "resource/cpu_frac": fr["cpu_frac"],
            "resource/engine_frac": fr["engine_frac"],
            "resource/saturated": fr["saturated"],
        }

    def compute_frac(self) -> float:
        """The measured compute floor derive_plan's gain clamp consumes:
        this peer's window CPU fraction, 0.0 when unmeasured (an
        unmeasured peer must never clamp the cluster's prediction)."""
        sig = self.signals()
        v = sig.get("resource/cpu_frac")
        return float(v) if isinstance(v, (int, float)) else 0.0

    def close(self) -> None:
        if self.profiler is not None:
            self.profiler.stop()


_plane: Optional[ResourcePlane] = None
_plane_lock = threading.Lock()


def get_plane() -> ResourcePlane:
    global _plane
    with _plane_lock:
        if _plane is None:
            _plane = ResourcePlane()
        return _plane


def reset_plane() -> None:
    """Drop the process plane (tests flip knobs at runtime)."""
    global _plane
    with _plane_lock:
        if _plane is not None:
            _plane.close()
        _plane = None


# ---------------------------------------------------------------------------
# merge math (pure: the aggregator and tests drive it)
# ---------------------------------------------------------------------------


def merge_resources(
    peer_docs: Dict[str, dict],
    offsets_us: Dict[str, float],
) -> dict:
    """Merge every peer's /resources document into one cluster view:
    per-peer rows with their anchors aligned onto the merger's clock,
    plus the cluster-wide election (max CPU fraction, saturated peers —
    the compute-bound set straggler classification consults)."""
    peers: Dict[str, dict] = {}
    saturated: List[str] = []
    max_cpu = None
    for peer, doc in sorted(peer_docs.items()):
        if not doc:
            continue
        off = offsets_us.get(peer) or 0.0
        row = dict(doc)
        if isinstance(row.get("perf_now_us"), (int, float)):
            row["perf_now_us"] = row["perf_now_us"] + off
        peers[peer] = row
        cf = row.get("cpu_frac")
        if isinstance(cf, (int, float)):
            max_cpu = cf if max_cpu is None else max(max_cpu, cf)
        if row.get("saturated"):
            saturated.append(peer)
    return {
        "peers": peers,
        "saturated": sorted(saturated),
        "max_cpu_frac": max_cpu,
    }


def peer_saturated(merged: Optional[dict], peer: str) -> bool:
    """Does the merged cluster view say this peer is compute-bound?
    False on no data — the caller must never fabricate a cause."""
    if not merged:
        return False
    row = (merged.get("peers") or {}).get(str(peer))
    return bool(row and row.get("saturated"))


# ---------------------------------------------------------------------------
# rendering (info resources + the flight postmortem's final attribution)
# ---------------------------------------------------------------------------

_COLS = ("PEER", "CPU%", "CORES", "TRAIN%", "WALK%", "CODEC%", "SCHED%",
         "TELEM%", "OTHER%", "FLAGS")
_BUCKET_COLS = ("train", "walk_compute", "codec", "sched", "telemetry",
                "other")


def _pct(v) -> str:
    return f"{v * 100:.0f}" if isinstance(v, (int, float)) else "-"


def render_resources(merged: dict) -> List[str]:
    """The merged cluster view as a table: per peer the window CPU
    fraction, cores, the per-bucket busy shares and the saturation
    flag."""
    peers = merged.get("peers") or {}
    rows = []
    for peer, doc in sorted(peers.items()):
        if not doc.get("supported", True):
            rows.append((peer,) + ("-",) * 8 + ("unsupported",))
            continue
        buckets = doc.get("buckets") or {}
        flags = "SATURATED" if doc.get("saturated") else ""
        prof = doc.get("profile") or {}
        ef = prof.get("main_engine_frac")
        if isinstance(ef, (int, float)):
            flags = (flags + " " if flags else "") + f"main-eng {ef:.0%}"
        rows.append((
            peer,
            _pct(doc.get("cpu_frac")),
            f"{doc.get('cores'):.0f}" if isinstance(
                doc.get("cores"), (int, float)) else "-",
            *(
                _pct((buckets.get(b) or {}).get("frac"))
                for b in _BUCKET_COLS
            ),
            flags,
        ))
    widths = [
        max(len(_COLS[i]), max((len(r[i]) for r in rows), default=0))
        for i in range(len(_COLS))
    ]
    lines = ["  ".join(c.ljust(widths[i]) for i, c in enumerate(_COLS))]
    for r in rows:
        lines.append("  ".join(c.ljust(widths[i]) for i, c in enumerate(r)))
    sat = merged.get("saturated") or []
    summary = f"{len(peers)} peers"
    if sat:
        summary += f", compute-saturated: {', '.join(sat)}"
    if isinstance(merged.get("max_cpu_frac"), (int, float)):
        summary += f", max cpu {merged['max_cpu_frac']:.0%}"
    lines.append(summary)
    return lines


def render_worker_resources(doc: dict) -> List[str]:
    """One UNMERGED worker document (the postmortem's final CPU
    attribution: no cluster view exists for a dead worker)."""
    if not doc:
        return ["no resource data"]
    if not doc.get("supported", True):
        return ["resource accounting unsupported on this platform"]
    lines = []
    head = (
        f"cpu {_pct(doc.get('cpu_frac'))}% of "
        f"{doc.get('cores')} cores"
    )
    if doc.get("saturated"):
        head += "  SATURATED (compute-bound at death)"
    lines.append(head)
    buckets = doc.get("buckets") or {}
    for b in _BUCKET_COLS:
        info = buckets.get(b) or {}
        total = info.get("cpu_s")
        if not isinstance(total, (int, float)) or total <= 0:
            continue
        lines.append(
            f"  {b:<14} {total:8.1f}s total"
            f"  {_pct(info.get('frac')):>4}% of recent busy"
        )
    prof = doc.get("profile") or {}
    ef = prof.get("main_engine_frac")
    if isinstance(ef, (int, float)):
        lines.append(
            f"  main thread: {ef:.0%} of samples blocked in the engine"
        )
    return lines

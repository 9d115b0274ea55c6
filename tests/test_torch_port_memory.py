"""The port's memory plane (`kungfu_tpu_torch/telemetry/memory.py`) and its
consumers against the JAX package's, in process.

- `_cgroup_mem_limit` on fixture cgroup files (v2, v1, v1's hierarchical
  fallback, unlimited sentinels, garbage), `effective_mem_limit` under
  `KF_MEMORY_LIMIT`, `deep_sizeof`, `ring_cap_bytes`, `parse_majflt` and
  `fmt_bytes`: the same answers.
- The accountant registry: the same buckets, totals and drops.
- `MemoryPlane` on seeded RSS, major-fault, step and accountant
  sequences under an injected perf clock: the same `/memory` documents,
  `signals()`, `grow_ok()`, trend and forecast after every sweep, and the
  leak watchdog's `memory_leak_suspect` verdicts at the same sweeps
  (armed only past the warm-up).
- `merge_memory`, `peer_thrashing`, `render_memory`,
  `render_worker_memory`, `flight.oom_suspected` and the postmortem's
  rendering of both planes, byte for byte; `classify_cause`'s compute
  and memory evidence.
- The consumers: `StepBasedSchedule`'s grow deferral and its counter,
  ZeRO's advisory, `PolicyRunner`'s `resource/*` and `memory/*` signals,
  and the `kungfu_memory_*` families."""

import collections
import types

import numpy as np
import pytest
import torch

from kungfu_tpu.elastic import schedule as rschedule
from kungfu_tpu.telemetry import audit as raudit
from kungfu_tpu.telemetry import config as rconfig
from kungfu_tpu.telemetry import flight as rflight
from kungfu_tpu.telemetry import memory as rmemory
from kungfu_tpu.telemetry import metrics as rmetrics
from kungfu_tpu.telemetry import resource as rresource
from kungfu_tpu.telemetry import straggler as rstraggler
from kungfu_tpu_torch.collective.host_session import HostSession
from kungfu_tpu_torch.elastic import schedule
from kungfu_tpu_torch.telemetry import audit, config, flight, memory, metrics, resource, straggler
from test_torch_port_flight import _run_dir

BOTH = (memory, rmemory)


class FakeClock:
    def __init__(self, t=5000.0):
        self.t = t

    def perf_counter(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t

    def sleep(self, s):
        self.t += s


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for mod in BOTH:
        monkeypatch.setattr(mod, "time", c)
    return c


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Empty accountant registries and planes in both packages: the
    process's own owners (pools, rings of other cases) stay out."""
    for mod in BOTH:
        monkeypatch.setattr(mod, "_accountants", {})
        mod.reset_plane()
    for mod in (resource, rresource):
        mod.reset_plane()
    monkeypatch.delenv("KF_MEMORY_LIMIT", raising=False)
    yield
    for mod in BOTH:
        mod.reset_plane()
    for mod in (resource, rresource):
        mod.reset_plane()


# ---------------------------------------------------------------------------
# the limit, sizes and parsers
# ---------------------------------------------------------------------------

V1_UNLIMITED = str(0x7FFFFFFFFFFFF000)
CGROUPS = [
    # (memory.max, memory.limit_in_bytes, memory.stat) — None: the file is absent
    ("1073741824\n", None, None),
    ("max\n", None, None),
    ("max\n", "2147483648\n", None),
    (None, "2147483648\n", None),
    (None, V1_UNLIMITED, "cache 1\nhierarchical_memory_limit 4294967296\n"),
    (None, V1_UNLIMITED, "cache 1\nrss 2\n"),
    (None, V1_UNLIMITED, "hierarchical_memory_limit " + V1_UNLIMITED + "\n"),
    ("garbage", "x", "hierarchical_memory_limit 12345678\n"),
    ("0\n", "0\n", None),
    (str(1 << 61), "8589934592", None),
    (None, None, None),
    ("  536870912  ", None, None),
]


@pytest.mark.parametrize("i", range(len(CGROUPS)))
def test_the_cgroup_limit_matches_the_reference(i, tmp_path, monkeypatch):
    files = dict(zip(("CGROUP_V2_MEM_MAX", "CGROUP_V1_MEM_LIMIT", "CGROUP_V1_MEM_STAT"),
                     CGROUPS[i]))
    for name, body in files.items():
        path = tmp_path / name
        if body is not None:
            path.write_text(body)
        for mod in BOTH:
            monkeypatch.setattr(mod, name, str(path))
    got = memory._cgroup_mem_limit()
    assert got == rmemory._cgroup_mem_limit() and got >= 0
    assert memory.effective_mem_limit() == rmemory.effective_mem_limit() > 0


@pytest.mark.parametrize("value", ["2e9", "1024", "0", "-5", "384M", " 4096 ", "1.5e3"])
def test_the_limit_override_matches_the_reference(value, monkeypatch):
    monkeypatch.setenv("KF_MEMORY_LIMIT", value)
    assert memory.effective_mem_limit() == rmemory.effective_mem_limit()


def _nested(rng, depth=0):
    kind = int(rng.integers(0, 8 if depth < 4 else 3))
    if kind == 0:
        return int(rng.integers(-1000, 10 ** 12))
    if kind == 1:
        return "s" * int(rng.integers(0, 300))
    if kind == 2:
        return np.zeros(int(rng.integers(0, 5000)), np.float32)
    n = int(rng.integers(0, 6))
    items = [_nested(rng, depth + 1) for _ in range(n)]
    if kind == 3:
        return {f"k{i}": v for i, v in enumerate(items)}
    if kind == 4:
        return tuple(items)
    if kind == 5:
        return collections.deque(items, maxlen=int(rng.integers(n, n + 10)) if n else None)
    if kind == 6:
        return types.SimpleNamespace(a=items, b=items[:1])  # shared items count once
    return items


@pytest.mark.parametrize("max_nodes", [5, 100_000])
@pytest.mark.parametrize("seed", range(8))
def test_deep_sizeof_matches_the_reference(seed, max_nodes):
    obj = _nested(np.random.default_rng(seed))
    assert memory.deep_sizeof(obj, max_nodes) == rmemory.deep_sizeof(obj, max_nodes)


def test_a_tensor_counts_its_bytes_without_a_walk():
    t = torch.zeros(1000, dtype=torch.float64)
    assert memory.deep_sizeof({"t": t}) == rmemory.deep_sizeof({"t": t})
    assert memory.deep_sizeof(t) == 8000


RINGS = [
    lambda rng: collections.deque([], maxlen=8),
    lambda rng: collections.deque([{"a": i} for i in range(3)], maxlen=16),
    lambda rng: collections.deque([list(range(int(rng.integers(0, 50)))) for _ in range(40)],
                                  maxlen=40),
    lambda rng: collections.deque(["x" * int(rng.integers(1, 900)) for _ in range(100)],
                                  maxlen=64),
    lambda rng: [{"k": "v" * i} for i in range(20)],
    lambda rng: [],
    lambda rng: 12345,
    lambda rng: collections.deque([i for i in range(300)], maxlen=4096),
]


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("i", range(len(RINGS)))
def test_ring_cap_bytes_matches_the_reference(i, seed):
    ring = RINGS[i](np.random.default_rng(seed))
    got = memory.ring_cap_bytes(ring)
    assert got == rmemory.ring_cap_bytes(ring)
    if getattr(ring, "maxlen", None) and len(ring):
        assert got % 1024 == 0


MAJFLT_LINES = [
    "42 (python3) S 1 2 3 4 5 6 7 8 9 10 11 12",
    "42 (a b) S 1 2 3 4 5 6 7 8 99 10",
    "42 (a) b)) S 1 2 3 4 5 6 7 8 77",
    "42 (x) S 1 2 3 4 5 6 7 8",
    "42 (x) S 1 2 3 4 5 6 7 8 nan",
    "no paren",
    "",
    ")",
    "42 (x) S 1 2 3 4 5 6 7 8 -3 0 0",
    "42 (x) S 1 2 3 4 5 6 7 8 " + str(2 ** 62),
]


@pytest.mark.parametrize("i", range(len(MAJFLT_LINES)))
def test_parse_majflt_matches_the_reference(i):
    assert memory.parse_majflt(MAJFLT_LINES[i]) == rmemory.parse_majflt(MAJFLT_LINES[i])


def test_the_live_readers_match():
    assert memory._default_rss() > 0 and memory._default_majflt() is not None
    for a, b in ((memory._default_rss(), rmemory._default_rss()),
                 (memory._default_majflt(), rmemory._default_majflt())):
        assert abs(a - b) <= max(64 << 20, a // 10)


FMT_VALUES = [0, 1, 1023, 1024, 1536, 10 ** 6, 2 ** 30, 5.5 * 2 ** 40, 2 ** 52, -4096, -1,
              0.4, None, "x", float("inf"), 123456789]


@pytest.mark.parametrize("i", range(len(FMT_VALUES)))
def test_fmt_bytes_matches_the_reference(i):
    assert memory.fmt_bytes(FMT_VALUES[i]) == rmemory.fmt_bytes(FMT_VALUES[i])


def test_the_tables_and_thresholds_are_the_references():
    assert memory.BUCKETS == rmemory.BUCKETS and memory._COLS == rmemory._COLS
    assert memory.PRESSURE_FRAC == rmemory.PRESSURE_FRAC
    assert memory.THRASH_FAULTS_PER_S == rmemory.THRASH_FAULTS_PER_S


# ---------------------------------------------------------------------------
# the accountant registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket", ["untracked", "nope", ""])
def test_an_unknown_bucket_is_refused_alike(bucket):
    for mod in BOTH:
        with pytest.raises(ValueError, match="unknown accountant bucket"):
            mod.register_accountant("x", bucket, lambda: 1)


def test_the_registry_sums_drops_and_closes_alike():
    def boom():
        raise RuntimeError("gone wrong")

    got = []
    for mod in BOTH:
        gone = mod.register_accountant("gone", "pool", lambda: None)
        mod.register_accountant("pool", "pool", lambda: 100)
        mod.register_accountant("pool", "pool", lambda: 20)  # one name, summed
        mod.register_accountant("neg", "arena", lambda: -7)
        mod.register_accountant("bad", "telemetry", boom)
        kept = mod.register_accountant("zero:x", "zero_state", lambda: 4096)
        first = mod.tracked_bytes()
        kept.close()
        gone.close()  # already dropped: a no-op
        got.append((first, mod.tracked_bytes(), len(mod._accountants)))
    assert got[0] == got[1]
    first, second, left = got[0]
    assert first == ({"arena": 0, "pool": 120, "zero_state": 4096, "sched_inflight": 0,
                      "telemetry": 0}, {"pool": 120, "neg": 0, "zero:x": 4096})
    assert second[1] == {"pool": 120, "neg": 0} and left == 3


# ---------------------------------------------------------------------------
# the plane: documents, signals and the leak watchdog
# ---------------------------------------------------------------------------

SCENARIOS = ["leak", "flat", "boot_growth", "noisy", "pressure", "thrash", "unknown_limit"]


def _script(scenario, rng, n=24):
    """Per sweep: (rss, pool bytes, majflt, steps, seconds to the next)."""
    rss, pool, flt, steps = int(rng.integers(200, 400)) << 20, 1 << 20, 10, 0.0
    if scenario == "pressure":
        rss = 256 << 20  # under a 300 MiB limit, growing past its pressure line
    out = []
    for i in range(n):
        dt = float(rng.uniform(0.4, 1.2))
        if scenario == "leak" or scenario == "pressure":
            pool += int(rng.integers(1, 8)) << 20
            rss += int(rng.integers(2, 9)) << 20
        elif scenario == "boot_growth" and i < 6:
            pool += 1 << 20
            rss += 3 << 20
        elif scenario == "noisy":
            pool = max(0, pool + int(rng.integers(-2, 3)) << 18)
            rss = max(1 << 20, rss + int(rng.integers(-4, 5) << 20))
        if scenario == "thrash":
            flt += int(rng.integers(20, 200))
        else:
            flt += int(rng.integers(0, 2))
        steps += float(rng.integers(0, 4))
        out.append((rss, pool, flt, steps if i != 11 else 0.0, dt))
    return out


def _planes(scenario, rng, state):
    limit = {"pressure": 300 << 20, "unknown_limit": 0}.get(scenario,
                                                           int(rng.integers(8, 64)) << 30)
    kw = dict(interval=0.3, windows=int(rng.integers(2, 6)), warmup=float(rng.choice([0, 4.0])),
              trend_keep=int(rng.integers(4, 12)), rss_fn=lambda: state["rss"],
              limit_fn=lambda: limit, majflt_fn=lambda: state["flt"],
              steps_fn=lambda: state["steps"])
    planes = []
    for mod in BOTH:
        mod.register_accountant("buffer_pool", "pool", lambda: state["pool"])
        mod.register_accountant("steptrace", "telemetry", lambda: 2048)
        planes.append(mod.MemoryPlane(**kw))
    return planes


def _doc(plane, peer="10.0.0.1:12000"):
    return {k: v for k, v in plane.export(peer=peer).items()
            if k not in ("perf_now_us", "wall_time_s")}


def _leaks(mod):
    return [(r["detail"]["bucket"], r["detail"]["windows"], r["detail"]["bytes"])
            for r in mod.to_json() if r["kind"] == "memory_leak_suspect"]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_the_plane_tracks_the_reference_sweep_by_sweep(scenario, seed, clock):
    rng = np.random.default_rng(1000 * seed + SCENARIOS.index(scenario))
    state = {"rss": 0, "pool": 0, "flt": 0, "steps": 0.0}
    audit.clear()
    raudit.clear()
    mine, theirs = _planes(scenario, rng, state)
    assert mine.signals() == theirs.signals() == {}  # no RSS yet read...
    for sweep, (rss, pool, flt, steps, dt) in enumerate(_script(scenario, rng)):
        state.update(rss=rss, pool=pool, flt=flt, steps=steps)
        clock.sleep(dt)
        got, want = _doc(mine), _doc(theirs)
        assert got == want, sweep
        assert mine.signals() == theirs.signals(), sweep
        assert mine.grow_ok() == theirs.grow_ok(), sweep
        assert mine.forecast() == theirs.forecast(), sweep
        assert _leaks(audit) == _leaks(raudit), sweep
    last = _doc(mine)
    assert last["buckets"]["untracked"]["bytes"] == max(0, last["rss_bytes"] - 2048
                                                        - last["buckets"]["pool"]["bytes"])
    if scenario == "leak":
        assert "pool" in last["leak_suspects"] and _leaks(audit)
    if scenario in ("flat", "thrash", "unknown_limit"):
        assert "pool" not in last["leak_suspects"]
    if scenario == "pressure":
        assert last["pressure"] and mine.grow_ok()[0] is False
    if scenario == "thrash":
        assert last["thrashing"]
    if scenario == "unknown_limit":
        assert last["headroom_frac"] is None and mine.grow_ok() == (True, "unmeasured")


def test_no_streak_arms_inside_the_warmup(clock):
    state = {"rss": 300 << 20, "pool": 0, "flt": 0, "steps": 0.0}
    audit.clear()
    raudit.clear()
    planes = []
    for mod in BOTH:
        mod.register_accountant("buffer_pool", "pool", lambda: state["pool"])
        planes.append(mod.MemoryPlane(interval=0.1, windows=2, warmup=10.0, trend_keep=8,
                                      rss_fn=lambda: state["rss"], limit_fn=lambda: 1 << 34,
                                      majflt_fn=lambda: 0, steps_fn=lambda: None))
    for i in range(30):  # strict growth every 0.5 s: 20 sweeps inside the warm-up
        state["pool"] += 1 << 20
        state["rss"] += 1 << 20
        clock.sleep(0.5)
        for p in planes:
            p.maybe_sweep()
        fired = [_leaks(audit), _leaks(raudit)]
        assert fired[0] == fired[1]
        if (i + 1) * 0.5 < 10.0:
            assert fired[0] == [], i
    assert ("pool", 2) == _leaks(audit)[0][:2]


TRENDS = [
    [(0, 100), (1, 110), (2, 120), (3, 130)],
    [(0, 100), (1, 100), (2, 100), (3, 100), (4, 100)],
    [(0, 100), (1, 110), (2, 120)],
    [(0, 100), (1, 300), (2, 90), (3, 310), (4, 95)],
    [(0, 500), (1, 400), (2, 300), (3, 200)],
    [(0, 100), (0, 100), (0, 100), (0, 100)],
    [(0, 1 << 30), (2, (1 << 30) + 5000), (4, (1 << 30) + 9000), (6, (1 << 30) + 16000),
     (8, (1 << 30) + 20000)],
]


@pytest.mark.parametrize("limit", [0, 1 << 31])
@pytest.mark.parametrize("i", range(len(TRENDS)))
def test_trend_and_forecast_match(i, limit):
    got = []
    for mod in BOTH:
        plane = mod.MemoryPlane(interval=0.1, windows=3, warmup=0, trend_keep=16,
                                rss_fn=lambda: None, limit_fn=lambda: limit,
                                majflt_fn=lambda: None, steps_fn=lambda: None)
        plane._trend.extend((float(t), int(r)) for t, r in TRENDS[i])
        plane._rss = TRENDS[i][-1][1]
        plane._steps_rate = 2.0
        got.append((plane.trend_bytes_per_s(), plane.headroom_frac(), plane.forecast()))
    assert got[0] == got[1]


@pytest.mark.parametrize("keep", [8, 12])
@pytest.mark.parametrize("step_frac", [0.25, 0.5, 0.75])
def test_one_page_step_in_a_flat_rss_reads_as_an_oom_at_a_sigkill(keep, step_frac):
    """Why chip_smoke's forensics phase keeps rank 3's drop in RSS at its
    record inside the trend window: a series flat but for one 4-page step
    passes the fit's noise test as a rising trend, which oom_suspected
    reads as an OOM at a SIGKILL, in both packages. A drop of 16 MB inside
    the window turns the trend down."""
    base, limit = 7_626_526_720, 108_447_924_224
    flat = [base + (16384 if i >= int(keep * step_frac) else 0) for i in range(keep)]
    dropped = [base + 16_506_880] * 3 + flat[3:]
    got = []
    for mod, fl in ((memory, flight), (rmemory, rflight)):
        trends = []
        for series in (flat, dropped):
            plane = mod.MemoryPlane(interval=0.1, windows=3, warmup=0, trend_keep=keep,
                                    rss_fn=lambda: None, limit_fn=lambda: limit,
                                    majflt_fn=lambda: None, steps_fn=lambda: None)
            plane._trend.extend((0.5 * i, r) for i, r in enumerate(series))
            trend = plane.trend_bytes_per_s()
            doc = {"rss_bytes": series[-1], "limit_bytes": limit, "trend_bytes_per_s": trend}
            trends.append((trend, fl.oom_suspected(doc, -9), fl.oom_suspected(doc, -15)))
        got.append(trends)
    (rising, oom, term), (falling, oom_dropped, _) = got[0]
    assert got[0] == got[1]
    assert rising > 0 and oom is True and term is False
    assert falling < 0 and oom_dropped is False


@pytest.mark.parametrize("used", [0.0, 0.5, 0.84, 0.85, 0.86, 0.999, 1.0, 1.2])
def test_grow_ok_matches_the_reference(used, clock):
    limit = 10 << 30
    got = []
    for mod in BOTH:
        plane = mod.MemoryPlane(interval=0.1, windows=3, warmup=0, trend_keep=8,
                                rss_fn=lambda: int(limit * used) or 1, limit_fn=lambda: limit,
                                majflt_fn=lambda: 0, steps_fn=lambda: None)
        first = plane.grow_ok()  # one sweep: unmeasured
        clock.sleep(0.2)
        got.append((first, plane.grow_ok(), plane.signals()))
        clock.t -= 0.2
    assert got[0] == got[1] and got[0][0] == (True, "unmeasured")


def test_the_process_plane_reads_this_process(monkeypatch):
    monkeypatch.setenv("KF_MEMORY_INTERVAL", "0.1")
    plane = memory.get_plane()
    assert plane is memory.get_plane()
    plane.maybe_sweep(force=True)
    doc = plane.export()
    assert doc["supported"] and doc["rss_bytes"] > 0 and doc["limit_bytes"] > 0
    assert 0 < doc["rss_bytes"] < doc["limit_bytes"] == memory.effective_mem_limit()
    assert set(doc) == set(rmemory.get_plane().export())
    assert plane.interval == 0.1 and plane.windows == 6 and plane.warmup == 30.0


@pytest.mark.parametrize("sweeps", [200, 600])
def test_snapshot_sweeps_keep_a_flat_heap(sweeps, monkeypatch):
    """What a flight snapshot adds to a worker every 0.5 s (a sweep of
    both planes and their documents) keeps nothing once the planes'
    bounded rings are full: more sweeps leave the traced Python heap
    where it was."""
    import gc
    import tracemalloc

    monkeypatch.setenv("KF_MEMORY_TREND", "8")

    def snapshot():
        resource.get_plane().maybe_sweep(force=True)
        res, mem = flight.FlightRecorder._resources_doc(), flight.FlightRecorder._memory_doc()
        assert res["supported"] and mem["supported"] and not mem["leak_suspects"]

    tracemalloc.start()
    try:
        for _ in range(50):
            snapshot()
        gc.collect()
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(sweeps):
            snapshot()
        gc.collect()
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 64 << 10, f"{sweeps} snapshots kept {grown} B"


# ---------------------------------------------------------------------------
# merge, election, renderers, the postmortem's verdict
# ---------------------------------------------------------------------------

def _mem_doc(rng, peer):
    rss = int(rng.integers(1, 64)) << 28
    limit = int(rng.choice([0, rss * 2, int(rss * 1.1), rss * 40]))
    hf = None if not limit else max(0.0, (limit - rss) / limit)
    buckets = {b: int(rng.integers(0, 1 << 30)) * (rng.random() < 0.7) for b in memory.BUCKETS}
    trend = None if rng.random() < 0.5 else float(rng.normal(0, 1e6))
    return {"peer": peer, "perf_now_us": float(rng.uniform(1e6, 1e9)), "wall_time_s": 1.7e9,
            "supported": rng.random() > 0.1, "rss_bytes": rss, "limit_bytes": limit,
            "headroom_frac": None if hf is None else round(hf, 6),
            "trend_bytes_per_s": trend,
            "exhaustion_s": None if trend is None or trend <= 0 else float(rng.uniform(1, 1e5)),
            "steps_to_exhaustion": None, "majflt_rate": float(rng.uniform(0, 30)),
            "thrashing": bool(rng.random() < 0.3), "pressure": hf is not None and hf <= 0.15,
            "interval_s": 2.0, "sweeps": int(rng.integers(0, 100)),
            "buckets": {b: {"bytes": v, "frac": round(v / rss, 6)} for b, v in buckets.items()},
            "accountants": {"buffer_pool": buckets["pool"]},
            "leak_suspects": list(rng.choice(["pool", "untracked", "telemetry"],
                                             int(rng.integers(0, 3)), replace=False))}


def _mem_docs(seed):
    rng = np.random.default_rng(4000 + seed)
    docs = {f"10.0.1.{i}:{13000 + i}": _mem_doc(rng, f"10.0.1.{i}:{13000 + i}")
            for i in range(int(rng.integers(0, 7)))}
    if docs and rng.random() < 0.3:
        docs[next(iter(docs))] = {}
    offsets = {p: float(rng.normal(0, 5e3)) for p in docs if rng.random() < 0.6}
    return docs, offsets


@pytest.mark.parametrize("seed", range(12))
def test_merge_memory_and_thrashing_match(seed):
    docs, offsets = _mem_docs(seed)
    got = memory.merge_memory(docs, offsets)
    assert got == rmemory.merge_memory(docs, offsets)
    for peer in list(docs) + ["nobody:1"]:
        assert memory.peer_thrashing(got, peer) == rmemory.peer_thrashing(got, peer)
    assert memory.peer_thrashing(None, "x") is False


@pytest.mark.parametrize("seed", range(12))
def test_render_memory_is_the_references_byte_for_byte(seed):
    merged = rmemory.merge_memory(*_mem_docs(seed))
    assert memory.render_memory(merged) == rmemory.render_memory(merged)


@pytest.mark.parametrize("seed", range(12))
def test_render_worker_memory_is_the_references_byte_for_byte(seed):
    rng = np.random.default_rng(5000 + seed)
    doc = {} if seed == 0 else _mem_doc(rng, "p:1")
    assert memory.render_worker_memory(doc) == rmemory.render_worker_memory(doc)


OOM_CASES = [
    ({"rss_bytes": 970, "limit_bytes": 1000}, -9),
    ({"rss_bytes": 940, "limit_bytes": 1000}, -9),
    ({"rss_bytes": 940, "limit_bytes": 1000}, 1),
    ({"rss_bytes": 100, "limit_bytes": 1000, "trend_bytes_per_s": 5.0}, -9),
    ({"rss_bytes": 100, "limit_bytes": 1000, "trend_bytes_per_s": 5.0}, -15),
    ({"rss_bytes": 100, "limit_bytes": 1000, "trend_bytes_per_s": -5.0}, -9),
    ({"rss_bytes": 100, "limit_bytes": 0, "trend_bytes_per_s": None}, -9),
    ({"rss_bytes": 1000, "limit_bytes": 1000}, None),
    ({}, -9),
    (None, -9),
    ({"rss_bytes": 0, "limit_bytes": 1000}, 0),
    ({"rss_bytes": 860, "limit_bytes": 1000}, 3),
]


@pytest.mark.parametrize("margin", [None, "0.15"])
@pytest.mark.parametrize("i", range(len(OOM_CASES)))
def test_oom_suspected_matches_the_reference(i, margin, monkeypatch):
    if margin is None:
        monkeypatch.delenv("KF_MEMORY_OOM_MARGIN", raising=False)
    else:
        monkeypatch.setenv("KF_MEMORY_OOM_MARGIN", margin)
    mem, code = OOM_CASES[i]
    assert flight.oom_suspected(mem, code) == rflight.oom_suspected(mem, code)


@pytest.mark.parametrize("seed", range(6))
def test_the_postmortem_renders_both_planes_as_the_reference(seed, tmp_path):
    rng = np.random.default_rng(6000 + seed)
    run, peer = _run_dir(tmp_path, "killed", rng)
    pm = rflight.harvest_postmortem(run, peer, exit_code=-9, output_tail=["last words"])
    from test_torch_port_resource import _doc as _res_doc

    pm["last_resources"] = _res_doc(rng, peer, profile=seed % 2 == 0)
    pm["last_memory"] = _mem_doc(rng, peer)
    pm["oom_suspected"] = rflight.oom_suspected(pm["last_memory"], -9)
    text = flight.render_postmortem(pm)
    assert text == rflight.render_postmortem(pm)
    assert "final CPU attribution (resource plane):" in text
    assert "final memory attribution (memory plane):" in text


# ---------------------------------------------------------------------------
# classify_cause's compute and memory evidence
# ---------------------------------------------------------------------------

def _views(saturated=(), thrashing=()):
    res = {"peers": {p: {"saturated": p in saturated} for p in ("a:1", "b:2")},
           "saturated": sorted(saturated)}
    mem = {"peers": {p: {"thrashing": p in thrashing} for p in ("a:1", "b:2")}}
    return res, mem


CAUSES = [
    ("a:1", [], None, _views(saturated=("a:1",))),
    ("a:1", [], None, _views(thrashing=("a:1",))),
    ("a:1", [], None, _views(saturated=("a:1",), thrashing=("a:1",))),
    ("a:1", [{"critical": {"peer": "a:1", "edge": "b:2"}}], None, _views(("a:1",), ("a:1",))),
    ("b:2", [], {"edges": {"b:2": {"a:1": {"bw": 3.0}}}}, _views(saturated=("b:2",))),
    ("b:2", [], {"edges": {"b:2": {"a:1": {"bw": 3.0}}}}, _views(saturated=("a:1",))),
    ("a:1", [], None, _views()),
    ("a:1", [], None, (None, None)),
    ("c:3", [], None, _views(("a:1", "b:2"), ("a:1", "b:2"))),
    ("a:1", None, {}, ({"peers": {"a:1": None}}, {"peers": {}})),
]


@pytest.mark.parametrize("i", range(len(CAUSES)))
def test_classify_cause_weighs_the_planes_as_the_reference(i):
    peer, steps, links, (res, mem) = CAUSES[i]
    got = straggler.classify_cause(peer, steps, links, res, mem)
    assert got == rstraggler.classify_cause(peer, steps, links, res, mem)
    assert got[0] in ("network", "memory", "compute", "unknown")


# ---------------------------------------------------------------------------
# the consumers
# ---------------------------------------------------------------------------

class _Plane:
    def __init__(self, ok, why="headroom 10% <= pressure line 15%"):
        self.ok, self.why = ok, why

    def grow_ok(self):
        if self.ok is None:
            raise OSError("no plane")
        return self.ok, self.why


@pytest.mark.parametrize("ok", [False, True, None])
def test_the_schedule_defers_a_grow_under_pressure_as_the_reference(ok, monkeypatch):
    monkeypatch.setenv("KF_TELEMETRY", "metrics")
    for cfg, reg in ((config, metrics), (rconfig, rmetrics)):
        cfg.refresh(None)
        reg.get_registry().clear()
    try:
        got = []
        for sched_mod, mem_mod, reg in ((schedule, memory, metrics),
                                        (rschedule, rmemory, rmetrics)):
            proposed = []
            monkeypatch.setattr(sched_mod.api, "cluster_size", lambda: 2)
            monkeypatch.setattr(sched_mod.api, "current_rank", lambda: 0)
            monkeypatch.setattr(sched_mod.api, "propose_new_size", proposed.append)
            monkeypatch.setattr(mem_mod, "get_plane", lambda: _Plane(ok))
            sched = sched_mod.StepBasedSchedule("2:3,4:3")
            results = [sched.maybe_propose(step) for step in (1, 3, 4)]
            fam = reg.get_registry().get("kungfu_memory_grow_deferrals_total")
            got.append((results, proposed, fam.value if fam is not None else None))
        assert got[0] == got[1]
        results, proposed, deferrals = got[0]
        if ok is False:
            assert proposed == [] and deferrals == 1.0 and results == [None, None, None]
        else:
            assert proposed == [4] and deferrals is None
    finally:
        for cfg, reg in ((config, metrics), (rconfig, rmetrics)):
            reg.get_registry().clear()
        monkeypatch.delenv("KF_TELEMETRY")
        for cfg in (config, rconfig):
            cfg.refresh(None)


@pytest.mark.parametrize("size,mode,want", [(1, "auto", False), (2, "auto", True),
                                            (1, "on", True), (4, "off", False)])
def test_zero_auto_stays_cluster_agreed_and_only_advises(size, mode, want, monkeypatch):
    warned = []
    from kungfu_tpu_torch.telemetry import log

    monkeypatch.setattr(log, "warn", lambda *a, **k: warned.append(a))
    monkeypatch.setattr(memory, "get_plane", lambda: types.SimpleNamespace(
        signals=lambda: {"memory/pressure": True, "memory/headroom_frac": 0.1}))
    fake = types.SimpleNamespace(zero_mode=mode, size=size)
    assert HostSession.zero_enabled(fake) is want
    assert HostSession.zero_enabled(fake) is want
    advised = mode == "auto" and size == 1
    assert len(warned) == (1 if advised else 0)
    if advised:
        assert "headroom 10%" in warned[0][0] % warned[0][1:]


def test_the_policy_runner_reads_both_planes(clock, monkeypatch):
    from kungfu_tpu_torch.policy import PolicyRunner

    state = {"rss": 1 << 30}
    monkeypatch.setattr(resource, "time", clock)  # the resource plane's throttle too
    monkeypatch.setattr(memory, "_plane", memory.MemoryPlane(
        interval=0.1, windows=3, warmup=0, trend_keep=8, rss_fn=lambda: state["rss"],
        limit_fn=lambda: 8 << 30, majflt_fn=lambda: 0, steps_fn=lambda: None))
    monkeypatch.setattr(resource, "_plane", resource.ResourcePlane(
        interval=0.1, sample_hz=0, cores_fn=lambda: 2.0))
    runner = PolicyRunner([], batch_size=1)
    for _ in range(3):
        clock.sleep(0.5)
        runner._signals_at = 0.0
        runner._pull_cluster_signals()
    m = runner.ctx.metrics
    assert {"resource/cpu_frac", "resource/engine_frac", "resource/saturated",
            "memory/headroom_frac", "memory/pressure", "memory/leak_suspect"} <= set(m)
    assert m["memory/headroom_frac"] == pytest.approx(7 / 8) and m["memory/pressure"] is False
    # a plane that goes quiet takes its keys with it
    monkeypatch.setattr(memory, "_plane", memory.MemoryPlane(
        interval=0.1, windows=3, warmup=0, trend_keep=8, rss_fn=lambda: None,
        limit_fn=lambda: 0, majflt_fn=lambda: None, steps_fn=lambda: None))
    runner._signals_at = 0.0
    runner._pull_cluster_signals()
    assert not any(k.startswith("memory/") for k in runner.ctx.metrics)


def test_the_memory_families_match(monkeypatch, clock):
    monkeypatch.setenv("KF_TELEMETRY", "metrics")
    for cfg, reg in ((config, metrics), (rconfig, rmetrics)):
        cfg.refresh(None)
        reg.get_registry().clear()
    try:
        state = {"rss": 3 << 30, "pool": 5 << 20, "flt": 0, "steps": 0.0}
        planes = _planes("flat", np.random.default_rng(9), state)
        for _ in range(3):
            clock.sleep(0.5)
            for p in planes:
                p.maybe_sweep()

        def fams(text):
            return sorted(l for l in text.splitlines() if "kungfu_memory_" in l)

        got = fams(metrics.get_registry().render())
        assert got == fams(rmetrics.get_registry().render())
        assert sum(l.startswith("kungfu_memory_bytes{") for l in got) == len(memory.BUCKETS)
        assert any(l.startswith("kungfu_memory_headroom_frac ") for l in got)
    finally:
        for cfg, reg in ((config, metrics), (rconfig, rmetrics)):
            reg.get_registry().clear()
        monkeypatch.delenv("KF_TELEMETRY")
        for cfg in (config, rconfig):
            cfg.refresh(None)

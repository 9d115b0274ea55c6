"""The port's resource plane (`kungfu_tpu_torch/telemetry/resource.py`)
against the JAX package's (`kungfu_tpu/telemetry/resource.py`), in
process.

- `parse_stat` and `bucket_for` on a table of task stat lines and thread
  names; `effective_cores` on this host.
- `CpuAccountant` on a seeded fixture of ``/proc/self/task`` (injected
  thread names, main thread and clock ticks, an injected perf clock):
  the same totals, windows, sweeps and thread counts after every sweep;
  `ResourcePlane`'s fractions, `signals()`, `compute_frac()` and
  `/resources` document over it.
- `SamplingProfiler` on injected frames: the same ring aggregation; off
  at the default `KF_RESOURCE_SAMPLE_HZ` 0 it allocates nothing.
- `merge_resources`, `peer_saturated`, `render_resources` and
  `render_worker_resources` on seeded documents: equal, byte for byte.
- The `kungfu_resource_*` families, and each package's aggregator
  reading the other's workers' `/resources` through a live server."""

import os
import types

import numpy as np
import pytest

from kungfu_tpu.telemetry import cluster as rcluster
from kungfu_tpu.telemetry import config as rconfig
from kungfu_tpu.telemetry import metrics as rmetrics
from kungfu_tpu.telemetry import resource as rresource
from kungfu_tpu.telemetry.http import TelemetryServer as RTelemetryServer
from kungfu_tpu_torch.telemetry import cluster, config, metrics, resource
from kungfu_tpu_torch.telemetry.http import TelemetryServer

BOTH = (resource, rresource)


class FakeClock:
    """A perf clock the test advances; `time()` follows it."""

    def __init__(self, t=1000.0):
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
def fresh_planes():
    for mod in BOTH:
        mod.reset_plane()
    yield
    for mod in BOTH:
        mod.reset_plane()


# ---------------------------------------------------------------------------
# parse_stat, bucket_for, effective_cores
# ---------------------------------------------------------------------------

def _stat_line(comm, utime, stime, fields=52):
    rest = ["S"] + [str(i) for i in range(10)] + [str(utime), str(stime)]
    rest += [str(i) for i in range(fields - len(rest) - 2)]
    return f"4242 ({comm}) " + " ".join(rest)


STAT_LINES = [
    _stat_line("python3", 100, 50),
    _stat_line("kf-sched-walk", 0, 0),
    _stat_line("a b c", 12345, 678),
    _stat_line("(paren) x)", 7, 3),
    _stat_line(")", 1, 1),
    _stat_line("", 99, 1),
    _stat_line("ünïcödé", 5, 5),
    _stat_line("x" * 15, 2 ** 40, 2 ** 33),
    "4242 (short) S 1 2 3",
    "no parens at all 1 2 3 4 5 6 7 8 9 10 11 12 13 14",
    "4242 (bad) S 0 1 2 3 4 5 6 7 8 9 x 12",
    "4242 (bad2) S 0 1 2 3 4 5 6 7 8 9 10 y",
    "",
    ")",
    "1 (t) S 0 1 2 3 4 5 6 7 8 9 10 11",
    "1 (t) S 0 1 2 3 4 5 6 7 8 9 10",
    _stat_line("python3", -1, 5),
    _stat_line("tab\there", 3, 4),
    "1 (t) S 0 1 2 3 4 5 6 7 8 9 1.5 2",
    _stat_line("kf-pool-3", 31, 17, fields=20),
]


@pytest.mark.parametrize("clk_tck", [100.0, 250.0])
@pytest.mark.parametrize("i", range(len(STAT_LINES)))
def test_parse_stat_matches_the_reference(i, clk_tck):
    line = STAT_LINES[i]
    assert resource.parse_stat(line, clk_tck) == rresource.parse_stat(line, clk_tck)


THREAD_NAMES = [
    "MainThread", "kf-sched-walk", "kf-sched-walk-2", "kf-sched-unpack", "kf-sched-launch",
    "kf-sched-gather", "kf-sched-other", "kf-pool-0", "kf-pool-17", "kf-cluster-scrape",
    "kf-health-refresh", "kf-flight", "kf-lockwatch", "kf-resource-sample", "kf-resource",
    "kf-", "", "Thread-3", "pt_autograd_0", "kf-schedwalk", "KF-SCHED-WALK", " kf-pool",
]


@pytest.mark.parametrize("is_main", [False, True])
@pytest.mark.parametrize("name", THREAD_NAMES)
def test_bucket_for_matches_the_reference(name, is_main):
    got = resource.bucket_for(name, is_main)
    assert got == rresource.bucket_for(name, is_main) and got in resource.BUCKETS


def test_the_tables_and_thresholds_are_the_references():
    assert resource.BUCKETS == rresource.BUCKETS
    assert resource._PREFIX_BUCKETS == rresource._PREFIX_BUCKETS
    assert resource.SATURATION_FRAC == rresource.SATURATION_FRAC
    assert resource._COLS == rresource._COLS


def test_effective_cores_matches_the_reference():
    assert resource.effective_cores() == rresource.effective_cores() >= 1.0


# ---------------------------------------------------------------------------
# CpuAccountant over a fixture taskdir
# ---------------------------------------------------------------------------

class TaskDir:
    """A fake /proc/self/task: tids with names and cumulative ticks that
    a seeded schedule advances, threads starting and exiting."""

    def __init__(self, path, rng):
        self.path, self.rng = path, rng
        self.names = {100: "MainThread", 101: "kf-sched-walk", 102: "kf-sched-unpack",
                      103: "kf-pool-0", 104: "Thread-9"}
        self.ticks = {tid: [int(rng.integers(0, 500)), int(rng.integers(0, 200))]
                      for tid in self.names}
        self.next_tid = 200
        self.write()

    def write(self):
        os.makedirs(self.path, exist_ok=True)
        for tid in os.listdir(self.path):
            if int(tid) not in self.ticks:
                os.remove(os.path.join(self.path, tid, "stat"))
                os.rmdir(os.path.join(self.path, tid))
        for tid, (u, s) in self.ticks.items():
            d = os.path.join(self.path, str(tid))
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "stat"), "w") as f:
                f.write(_stat_line(self.names.get(tid, "?"), u, s))

    def advance(self):
        for tid in list(self.ticks):
            self.ticks[tid][0] += int(self.rng.integers(0, 80))
            self.ticks[tid][1] += int(self.rng.integers(0, 30))
        roll = self.rng.random()
        if roll < 0.2:  # a thread starts, with history
            tid, self.next_tid = self.next_tid, self.next_tid + 1
            self.names[tid] = str(self.rng.choice(["kf-sched-gather", "kf-flight", "worker"]))
            self.ticks[tid] = [int(self.rng.integers(0, 50)), 0]
        elif roll < 0.3 and len(self.ticks) > 2:  # a thread exits
            tid = int(self.rng.choice([t for t in self.ticks if t != 100]))
            del self.ticks[tid]
        self.write()


def _accountants(taskdir, clk_tck=100.0):
    return [mod.CpuAccountant(taskdir.path, clk_tck=clk_tck,
                              names_fn=lambda: dict(taskdir.names), main_tid_fn=lambda: 100)
            for mod in BOTH]


def _round_snap(snap):
    return {k: ({b: round(v, 9) for b, v in v.items()} if isinstance(v, dict)
                else round(v, 9) if isinstance(v, float) else v) for k, v in snap.items()}


@pytest.mark.parametrize("seed", range(12))
def test_cpu_accountant_tracks_the_reference_sweep_by_sweep(seed, tmp_path, clock):
    rng = np.random.default_rng(seed)
    td = TaskDir(str(tmp_path / "task"), rng)
    mine, theirs = _accountants(td, clk_tck=float(rng.choice([100.0, 1000.0])))
    assert mine.supported() and theirs.supported()
    for sweep in range(8):
        for a in (mine, theirs):
            a.sweep()
        got, want = _round_snap(mine.snapshot()), _round_snap(theirs.snapshot())
        assert got == want, sweep
        assert set(got["totals"]) == set(resource.BUCKETS)
        clock.sleep(float(rng.uniform(0.5, 3.0)))
        td.advance()
    # every tick lands in one bucket: the totals sum to the live threads'
    # ticks plus the exited threads' last-seen ticks
    assert sum(mine.snapshot()["totals"].values()) > 0


def test_an_absent_taskdir_is_unsupported_and_sweeps_nothing(tmp_path, clock):
    for mod in BOTH:
        a = mod.CpuAccountant(str(tmp_path / "nope"))
        a.sweep()
        assert not a.supported() and a.snapshot()["sweeps"] == 0
    plane = resource.ResourcePlane(interval=0.1, sample_hz=0,
                                   accountant=resource.CpuAccountant(str(tmp_path / "nope")))
    assert plane.signals() == {} and plane.compute_frac() == 0.0
    assert plane.export(peer="p")["supported"] is False


def _timeless(doc):
    return {k: v for k, v in doc.items() if k not in ("perf_now_us", "wall_time_s")}


@pytest.mark.parametrize("cores", [1.0, 4.0, 0.25])
@pytest.mark.parametrize("seed", range(4))
def test_the_plane_signals_and_document_match(seed, cores, tmp_path, clock):
    rng = np.random.default_rng(50 + seed)
    td = TaskDir(str(tmp_path / "task"), rng)
    accts = _accountants(td)
    mine, theirs = (mod.ResourcePlane(interval=1.0, sample_hz=0, keep=4, accountant=a,
                                      cores_fn=lambda: cores)
                    for mod, a in zip(BOTH, accts))
    assert mine.signals() == theirs.signals() == {}  # one sweep: no window yet
    assert mine.compute_frac() == theirs.compute_frac() == 0.0
    for step in range(6):
        clock.sleep(float(rng.uniform(1.0, 2.5)))
        td.advance()
        got, want = mine.signals(), theirs.signals()
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12), step
        assert set(got) == {"resource/cpu_frac", "resource/engine_frac", "resource/saturated"}
        assert mine.compute_frac() == pytest.approx(theirs.compute_frac(), rel=1e-12)
        assert _timeless(mine.export(peer="p:1")) == _timeless(theirs.export(peer="p:1"))
    assert mine.cores() == max(1.0, cores)
    # throttled: a read inside the interval does not sweep again
    sweeps = mine.acct.snapshot()["sweeps"]
    mine.maybe_sweep()
    assert mine.acct.snapshot()["sweeps"] == sweeps
    mine.maybe_sweep(force=True)
    assert mine.acct.snapshot()["sweeps"] == sweeps + 1


def test_a_raising_cores_source_degrades_to_one_core(tmp_path):
    def boom():
        raise OSError("no affinity")

    for mod in BOTH:
        plane = mod.ResourcePlane(interval=1.0, sample_hz=0, cores_fn=boom,
                                  accountant=mod.CpuAccountant(str(tmp_path)))
        assert plane.cores() == 1.0


def test_the_live_process_plane_attributes_this_thread_to_train():
    plane = resource.get_plane()
    assert plane is resource.get_plane() and plane.profiler is None
    sum(i * i for i in range(200_000))
    plane.maybe_sweep(force=True)
    sum(i * i for i in range(200_000))
    plane.maybe_sweep(force=True)
    doc = plane.export()
    assert doc["supported"] and doc["sweeps"] >= 2 and doc["threads"] >= 1
    assert set(doc["buckets"]) == set(resource.BUCKETS)
    assert doc["buckets"]["train"]["cpu_s"] > 0
    assert set(doc) == set(rresource.get_plane().export())


# ---------------------------------------------------------------------------
# the sampling profiler
# ---------------------------------------------------------------------------

def _frame(*modules):
    """A chain of fake frames, innermost first."""
    frame = None
    for mod in reversed(modules):
        frame = types.SimpleNamespace(f_globals={"__name__": mod}, f_back=frame)
    return frame


MODULE_CHAINS = [
    ("model.resnet", "torch.nn.modules", "__main__"),
    ("kungfu_tpu_torch.collective.walks", "kungfu_tpu_torch.api", "__main__"),
    ("socket", "kungfu_tpu_torch.transport.client", "train"),
    ("threading",),
    ("numpy.core", "torch.optim.sgd", "__main__"),
    ("kungfu_tpu_torch",),
]


@pytest.mark.parametrize("i", range(len(MODULE_CHAINS)))
def test_classify_main_frame_matches_the_reference(i):
    frame = _frame(*MODULE_CHAINS[i])
    got = resource.classify_main_frame(frame)
    assert got == rresource.classify_main_frame(frame)
    assert got == ("engine" if any(m.startswith("kungfu_tpu_torch") for m in MODULE_CHAINS[i])
                   else "train_compute")


def test_the_ports_engine_is_its_own_package():
    # the JAX package's frames are not the port's engine
    assert resource.classify_main_frame(_frame("kungfu_tpu.api")) == "train_compute"
    assert rresource.classify_main_frame(_frame("kungfu_tpu.api")) == "engine"


@pytest.mark.parametrize("keep", [3, 64])
@pytest.mark.parametrize("seed", range(4))
def test_the_profilers_aggregation_matches(seed, keep):
    rng = np.random.default_rng(300 + seed)
    profs = [mod.SamplingProfiler(hz=10.0, keep=keep, main_tid_fn=lambda: 1) for mod in BOTH]
    for _ in range(int(rng.integers(1, 40))):
        frames = {t: _frame(*MODULE_CHAINS[int(rng.integers(0, len(MODULE_CHAINS)))])
                  for t in range(1, int(rng.integers(2, 6)))}
        for p in profs:
            p.sample_once(frames)
    got, want = (p.profile() for p in profs)
    assert got == want and got["samples"] == min(keep, got["samples"])


def test_the_profiler_is_never_built_at_hz_zero(monkeypatch):
    monkeypatch.delenv("KF_RESOURCE_SAMPLE_HZ", raising=False)
    before = resource.SamplingProfiler.allocations
    plane = resource.ResourcePlane()
    assert plane.profiler is None and resource.SamplingProfiler.allocations == before
    assert "profile" not in plane.export()


def test_a_positive_hz_samples_on_a_named_thread(monkeypatch):
    monkeypatch.setenv("KF_RESOURCE_SAMPLE_HZ", "200")
    import threading
    import time as _time

    plane = resource.ResourcePlane()
    try:
        assert plane.profiler is not None
        assert "kf-resource-sample" in [t.name for t in threading.enumerate()]
        deadline = _time.time() + 10
        while plane.profiler.profile()["samples"] < 3 and _time.time() < deadline:
            _time.sleep(0.02)
        prof = plane.export()["profile"]
        assert prof["samples"] >= 3 and prof["hz"] == 200.0
    finally:
        plane.close()
    assert "kf-resource-sample" not in [t.name for t in threading.enumerate()]


# ---------------------------------------------------------------------------
# merge, election, renderers
# ---------------------------------------------------------------------------

def _doc(rng, peer, supported=True, profile=False):
    busy = {b: float(rng.uniform(0, 2)) * (rng.random() < 0.8) for b in resource.BUCKETS}
    tot = sum(busy.values())
    cpu_frac = float(rng.choice([rng.uniform(0, 1.2), 0.95, 0.0]))
    doc = {"peer": peer, "perf_now_us": float(rng.uniform(1e6, 1e9)), "wall_time_s": 1.7e9,
           "supported": supported, "cores": float(rng.choice([1.0, 4.0, 96.0])),
           "interval_s": 2.0, "sweeps": int(rng.integers(0, 50)),
           "threads": int(rng.integers(1, 40)), "window_s": 2.0,
           "cpu_frac": round(cpu_frac, 6), "engine_frac": round(float(rng.random()), 6),
           "saturated": cpu_frac >= 0.9,
           "buckets": {b: {"cpu_s": round(float(rng.uniform(0, 500)) * (rng.random() < 0.85), 6),
                           "window_s": round(v, 6), "frac": round(v / tot, 6) if tot else 0.0}
                       for b, v in busy.items()}}
    if profile:
        doc["profile"] = {"hz": 10.0, "samples": 7, "main": {"train_compute": 4, "engine": 3},
                          "main_engine_frac": float(rng.random()), "modules": {"torch.nn": 7}}
    if rng.random() < 0.1:
        doc["cores"] = None
    return doc


def _docs(seed):
    rng = np.random.default_rng(700 + seed)
    k = int(rng.integers(0, 7))
    docs = {f"10.0.0.{i}:{12000 + i}": _doc(rng, f"10.0.0.{i}:{12000 + i}",
                                             supported=rng.random() > 0.15,
                                             profile=rng.random() < 0.3) for i in range(k)}
    if k and rng.random() < 0.3:
        docs[next(iter(docs))] = {}  # a peer that answered nothing
    offsets = {p: float(rng.normal(0, 1e4)) for p in docs if rng.random() < 0.7}
    return docs, offsets


@pytest.mark.parametrize("seed", range(15))
def test_merge_and_election_match(seed):
    docs, offsets = _docs(seed)
    got = resource.merge_resources(docs, offsets)
    assert got == rresource.merge_resources(docs, offsets)
    for peer in list(docs) + ["nobody:1"]:
        assert resource.peer_saturated(got, peer) == rresource.peer_saturated(got, peer)
    assert resource.peer_saturated(None, "x") is rresource.peer_saturated({}, "x") is False


@pytest.mark.parametrize("seed", range(15))
def test_render_resources_is_the_references_byte_for_byte(seed):
    docs, offsets = _docs(seed)
    merged = rresource.merge_resources(docs, offsets)
    assert resource.render_resources(merged) == rresource.render_resources(merged)


@pytest.mark.parametrize("seed", range(15))
def test_render_worker_resources_is_the_references_byte_for_byte(seed):
    rng = np.random.default_rng(900 + seed)
    doc = {} if seed == 0 else _doc(rng, "p:1", supported=seed != 1, profile=seed % 3 == 0)
    assert resource.render_worker_resources(doc) == rresource.render_worker_resources(doc)


# ---------------------------------------------------------------------------
# metrics and the routes
# ---------------------------------------------------------------------------

def _families(text):
    return sorted(line for line in text.splitlines() if "kungfu_resource_" in line
                  and not line.startswith("#"))


def test_the_resource_families_match(monkeypatch, tmp_path, clock):
    monkeypatch.setenv("KF_TELEMETRY", "metrics")
    for cfg, reg in ((config, metrics), (rconfig, rmetrics)):
        cfg.refresh(None)
        reg.get_registry().clear()
    try:
        rng = np.random.default_rng(5)
        td = TaskDir(str(tmp_path / "task"), rng)
        planes = [mod.ResourcePlane(interval=1.0, sample_hz=0, accountant=a,
                                    cores_fn=lambda: 8.0)
                  for mod, a in zip(BOTH, _accountants(td))]
        for _ in range(3):
            clock.sleep(1.5)
            td.advance()
            for p in planes:
                p.signals()
        got = _families(metrics.get_registry().render())
        want = _families(rmetrics.get_registry().render())
        assert got == want and any("kungfu_resource_cores_available 8" in l for l in got)
        assert sum("kungfu_resource_cpu_frac{" in l for l in got) == len(resource.BUCKETS)
    finally:
        for cfg, reg in ((config, metrics), (rconfig, rmetrics)):
            reg.get_registry().clear()
        monkeypatch.delenv("KF_TELEMETRY")
        for cfg in (config, rconfig):
            cfg.refresh(None)


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_each_aggregator_reads_the_others_workers(server_pkg):
    """Two workers' servers of one package, both packages' aggregators
    over them: the same peers, no error, /cluster/resources alike."""
    cls = TelemetryServer if server_pkg == "port" else RTelemetryServer
    servers = [cls(port=0, host="127.0.0.1") for _ in range(2)]
    aggs = []
    try:
        for s in servers:
            s.start()
        targets = [(f"127.0.0.1:{1000 + i}", f"http://127.0.0.1:{s.port}")
                   for i, s in enumerate(servers)]
        for mod in (cluster, rcluster):
            agg = mod.TelemetryAggregator(interval=5.0, timeout=5.0)
            agg.set_peers(targets)
            aggs.append(agg)
        got, want = (a.cluster_resources() for a in aggs)
        for doc in (got, want):
            assert doc["count"] == 2 and sorted(doc["peers"]) == [t for t, _ in targets]
            assert all(row["supported"] and set(row["buckets"]) == set(resource.BUCKETS)
                       for row in doc["peers"].values())
        assert set(got) == set(want) and got["saturated"] == want["saturated"] == []
    finally:
        for a in aggs:
            a.stop()
        for s in servers:
            s.stop()

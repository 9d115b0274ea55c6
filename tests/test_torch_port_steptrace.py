"""The port's step plane (`kungfu_tpu_torch/telemetry/steptrace.py` and the
scheduler's hooks in `collective/scheduler.py`) against the JAX
package's, in process; mirrors tests/test_steptrace.py.

- Seeded note sequences fed to both packages' `StepRecorder`s give equal
  JSON; both `StepStore`s give equal `export` documents with and without
  a `since` cursor, and equal `local_signals`.
- The deterministic sampler picks the same rounds at rates 0, 0.25, 0.5
  and 1; a sampled-out round allocates no timeline (asserted in a
  subprocess, as the reference asserts it).
- `align_timeline`, `critical_path` and `merge_steps` on seeded
  timelines from 2-5 peers with clock offsets give equal results, and
  `render_step` and `render_timeline` equal text.
- The port's scheduler in an in-process world of 4, on a narrow
  ResNet-50's gradient set in 2 fused buckets, records timelines whose
  structure (rounds, lanes, kinds, names, bytes, members, strategies,
  walk attribution and the ring successor each lane names) equals the
  reference scheduler's on the same buckets in an all-reference world;
  ZeRO's sharded buckets record their gather lanes alike.

In-process peers share one step store per package, so a round of a
world of 4 leaves 4 timelines; the ring successor tells them apart.
Ports are reserved by binding 0, never in kfrun's 38000-38999."""

import itertools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from kungfu_tpu.base.ops import ReduceOp as RReduceOp
from kungfu_tpu.base.strategy import Strategy as RStrategy
from kungfu_tpu.base.workspace import Workspace as RWorkspace
from kungfu_tpu.collective import zero as rzero
from kungfu_tpu.collective.host_session import HostSession as RHostSession
from kungfu_tpu.telemetry import steptrace as rsteptrace
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.strategy import Strategy
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.collective import zero
from kungfu_tpu_torch.collective.host_session import HostSession
from kungfu_tpu_torch.models.resnet import ResNet
from kungfu_tpu_torch.peer import Peer
from kungfu_tpu_torch.telemetry import steptrace
from test_torch_port_worlds import (  # noqa: F401 - fixtures used by name
    make_world, run_all, small_arenas)

REPO = Path(__file__).resolve().parent.parent
BOTH = (steptrace, rsteptrace)


@pytest.fixture
def clock(monkeypatch):
    """Both modules' perf clock on one deterministic sequence (each call
    advances 37.5 µs), so begin/end stamps compare exactly."""
    for mod in BOTH:
        ticks = itertools.count()
        monkeypatch.setattr(mod, "_now_us", lambda t=ticks: 1e9 + 37.5 * next(t))


def _feed(mod, rng, rnd=1):
    """One seeded round of scheduler notes into a recorder of `mod`."""
    rec = mod.StepRecorder(epoch=int(rng.integers(0, 4)), round_=rnd)
    n = int(rng.integers(1, 6))
    t = 2e9
    for i in range(n):
        kind = "zero" if rng.random() < 0.3 else "ar"
        lane = rec.bucket(i, kind, f"layer{i}+{int(rng.integers(0, 9))}",
                          int(rng.integers(1, 1 << 24)), int(rng.integers(1, 30)))
        for _ in range(int(rng.integers(1, 4))):
            t += float(rng.uniform(0, 500))
            lane.note_submit(t)
        if rng.random() < 0.9:
            lane.note_launch(t + float(rng.uniform(0, 300)))
            walk0 = t + float(rng.uniform(300, 600))
            dur = float(rng.uniform(100, 5000))
            lane.note_walk_span(walk0, dur)
            for _ in range(int(rng.integers(1, 4))):
                # chunked walks may report more blocked time than the span
                lane.add_walk("RING_SEGMENTED", dur * 1e-6 * float(rng.uniform(0.2, 1.5)),
                              dur * 1e-6 * float(rng.uniform(0, 1.2)),
                              dur * 1e-6 * float(rng.uniform(0, 0.8)),
                              f"10.0.0.{int(rng.integers(0, 8))}:38000"
                              if rng.random() < 0.8 else None)
            lane.note_unpack(float(rng.uniform(0, 400)))
            if kind == "zero" and rng.random() < 0.8:
                lane.note_gather_span(walk0 + dur, float(rng.uniform(50, 900)))
                lane.add_walk("RING_SEGMENTED", 1e-4, float(rng.uniform(0, 2e-4)), 0.0,
                              "10.0.0.9:38000", gather=True)
    if rng.random() < 0.85:
        rec.finish(flush_wait_s=float(rng.uniform(0, 0.01)), busy_s=float(rng.uniform(0, 0.02)))
    return rec


@pytest.mark.parametrize("seed", range(8))
def test_recorder_json_equals_the_references(seed, clock):
    got, want = (_feed(m, np.random.default_rng(seed)) for m in BOTH)
    assert got.to_json() == want.to_json()
    assert got.overlap_frac() == want.overlap_frac()
    assert got.queue_delay_frac() == want.queue_delay_frac()
    for i in got.buckets:
        assert got.buckets[i].self_us() == want.buckets[i].self_us()


def _store(mod, seed, keep, rounds):
    store = mod.StepStore(keep=keep)
    rng = np.random.default_rng(seed)
    for rnd in range(rounds):
        rec = store.begin_step(0, rnd)
        if rec is None:
            continue
        src = _feed(mod, rng, rnd)
        rec.buckets = src.buckets
        if src.t_end_us is not None:
            rec.finish(src.flush_wait_us / 1e6, src.busy_us / 1e6)
    return store


def _doc(doc):
    return {k: v for k, v in doc.items() if k not in ("perf_now_us", "wall_time_s")}


@pytest.mark.parametrize("keep,rounds", [(4, 3), (4, 9), (16, 12), (1, 5)])
def test_store_export_and_cursors_equal_the_references(keep, rounds, clock):
    mine, theirs = (_store(m, keep * 31 + rounds, keep, rounds) for m in BOTH)
    assert _doc(mine.export(peer="p")) == _doc(theirs.export(peer="p"))
    cursor = mine.export(peer="p")["next_since"]
    assert cursor == theirs.export(peer="p")["next_since"]
    for since in (None, 0, max(0, cursor - 2), cursor, cursor + 5):
        assert _doc(mine.export("p", since=since)) == _doc(theirs.export("p", since=since))
    assert mine.local_signals() == theirs.local_signals()
    assert mine.stats() == theirs.stats()
    assert mine.timelines() == theirs.timelines()
    assert mine.footprint_bytes() > 0
    mine.clear()
    theirs.clear()
    assert mine.export("p")["next_since"] == theirs.export("p")["next_since"] == cursor


@pytest.mark.parametrize("rate", ["0", "0.25", "0.5", "1"])
def test_sampler_picks_the_references_rounds(rate, monkeypatch):
    monkeypatch.setenv("KF_TELEMETRY_SPAN_SAMPLE", rate)
    picks = []
    for mod in BOTH:
        store = mod.StepStore(keep=8)
        picks.append([store.begin_step(0, r) is not None for r in range(40)])
        assert store.stats() == {"recorded": sum(picks[-1]),
                                 "sampled_out": 40 - sum(picks[-1])}
    assert picks[0] == picks[1]
    assert sum(picks[0]) == int(40 * float(rate))
    samplers = (steptrace._Sampler(), rsteptrace._Sampler())
    assert ([samplers[0].sample(float(rate)) for _ in range(40)]
            == [samplers[1].sample(float(rate)) for _ in range(40)])


def test_a_disabled_ring_records_nothing(monkeypatch):
    monkeypatch.setenv("KF_STEP_TIMELINE_KEEP", "0")
    for mod in BOTH:
        store = mod.StepStore()
        assert [store.begin_step(0, r) for r in range(5)] == [None] * 5
        assert store.timelines() == [] and store.stats()["sampled_out"] == 0


def test_sampled_out_step_allocates_nothing_subprocess():
    """With KF_TELEMETRY_SPAN_SAMPLE=0 a round allocates no timeline: a
    fresh process, so no other case's recorders count."""
    code = textwrap.dedent("""
        from kungfu_tpu_torch.telemetry import steptrace
        store = steptrace.get_store()
        for i in range(200):
            assert store.begin_step(0, i) is None
            with steptrace.walk_sink(None):
                assert steptrace.current_sink() is None
        assert steptrace.StepRecorder.allocations == 0, steptrace.StepRecorder.allocations
        assert store.timelines() == []
        assert store.stats() == {"recorded": 0, "sampled_out": 200}, store.stats()
        print("OVERHEAD_GUARD_OK")
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("KF_")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["KF_TELEMETRY_SPAN_SAMPLE"] = "0"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OVERHEAD_GUARD_OK" in r.stdout


def test_one_lane_fed_from_many_threads_loses_no_update():
    """The scheduler's stage threads and a chunked walk's pool threads feed
    one lane while scrapes render it: with the interpreter switching
    threads every microsecond, no note is lost and every render is
    whole."""
    import threading

    rec = steptrace.StepRecorder(1, 1)
    lane = rec.bucket(0, "ar", "g", 64, 1)
    n_threads, n_notes = 32, 200
    renders = []

    def feed():
        for _ in range(n_notes):
            lane.add_walk("RING_SEGMENTED", 1e-6, 1e-6, 0.0, "e:1")
            lane.note_walk_span(5.0, 1.0)
            lane.note_unpack(1.0)

    def render():
        for _ in range(n_notes):
            renders.append(rec.to_json()["buckets"][0]["walk_us"])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=feed) for _ in range(n_threads)]
        threads.append(threading.Thread(target=render))
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n_notes
    assert lane.walk_us == lane.unpack_us == float(total)
    assert lane.wait_us == pytest.approx(total * 1.0)  # 1e-6 s a note, in µs
    assert len(renders) == n_notes and renders == sorted(renders)


def test_walk_sink_routes_attribution_on_its_thread_only():
    for mod in BOTH:
        lane = mod.BucketLane(0)
        assert mod.current_sink() is None
        with mod.walk_sink(lane, gather=True):
            sink = mod.current_sink()
            assert sink == (lane, True)
            with mod.walk_sink(None):
                assert mod.current_sink() is None
            mod.note_walk(sink, "RING", 0.5, 0.1, 0.2, "e:1")
        assert mod.current_sink() is None
        mod.note_walk(None, "RING", 1.0, 1.0, 1.0, "x")
        assert lane.gather_wait_us == 0.1 * 1e6 and lane.gather_edge == "e:1"
        assert lane.wait_us == 0.0 and lane.strategy == "RING"


# ---------------------------------------------------------------------------
# the merge math and the renderers
# ---------------------------------------------------------------------------

def _docs(rng, k):
    """Per-peer /steptrace documents of 2-4 shared rounds (some peers miss
    a round), stamps on each peer's own clock, plus the true offsets."""
    peers = [f"10.1.0.{i}:{12000 + i}" for i in range(k)]
    offsets = {p: float(rng.uniform(-5e6, 5e6)) for p in peers}
    rounds = sorted({int(r) for r in rng.integers(1, 9, int(rng.integers(2, 5)))})
    docs = {}
    for i, p in enumerate(peers):
        store = rsteptrace.StepStore(keep=16)
        tls = []
        for rnd in rounds:
            if rng.random() < 0.15:
                continue
            tl = _feed(rsteptrace, rng, rnd).to_json()
            tl["epoch"] = 3
            shift = -offsets[p]
            for key in ("t_begin_us", "t_end_us"):
                if tl[key] is not None:
                    tl[key] += shift
            for b in tl["buckets"]:
                for key in ("t_submit_us", "t_ready_us", "t_launch_us", "t_walk_us",
                            "t_gather_us"):
                    if b.get(key) is not None:
                        b[key] += shift
                if rng.random() < 0.2:
                    b.pop("self_us")  # an older worker's lane: derived by the merge
            tls.append(tl)
        doc = store.export(peer=p)
        doc["timelines"] = tls
        docs[p] = doc
    return docs, offsets


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_merge_math_equals_the_references(k, seed):
    docs, offsets = _docs(np.random.default_rng(10 * k + seed), k)
    for p, doc in docs.items():
        for tl in doc["timelines"]:
            assert steptrace.align_timeline(tl, offsets[p]) == rsteptrace.align_timeline(
                tl, offsets[p])
    by_round = {}
    for p, doc in docs.items():
        for tl in doc["timelines"]:
            by_round.setdefault(tl["round"], {})[p] = tl
    for peers in by_round.values():
        for frac in (0.25, 0.9):
            assert steptrace.critical_path(peers, chain_min_frac=frac) == \
                rsteptrace.critical_path(peers, chain_min_frac=frac)
    for limit in (None, 1, 3):
        got = steptrace.merge_steps(docs, offsets, limit=limit)
        assert got == rsteptrace.merge_steps(docs, offsets, limit=limit)
    merged = steptrace.merge_steps(docs, offsets)
    assert merged and all(s["epoch"] == 3 for s in merged)
    for s in merged:
        assert steptrace.render_step(s) == rsteptrace.render_step(s)
        for p, tl in s["peers"].items():
            assert steptrace.render_timeline(tl, peer=p) == rsteptrace.render_timeline(tl, p)
    assert steptrace.critical_path({}) == rsteptrace.critical_path({})


def test_an_unflushed_timeline_renders_as_the_references(clock):
    for seed in range(6):
        got, want = (_feed(m, np.random.default_rng(100 + seed)).to_json() for m in BOTH)
        got["t_end_us"] = want["t_end_us"] = None
        assert steptrace.render_timeline(got, "me") == rsteptrace.render_timeline(want, "me")
        assert steptrace.render_timeline(got) == rsteptrace.render_timeline(want)


# ---------------------------------------------------------------------------
# the scheduler's timelines in worlds of 4
# ---------------------------------------------------------------------------

K = 4
ROUNDS = 3  # round 0 registers (never recorded), rounds 1-2 record


def _resnet_grads():
    """A narrow ResNet-50's (4 filters, 10 classes) parameter names and
    sizes, in the order backward produces their gradients."""
    m = ResNet([3, 4, 6, 3], 10, num_filters=4, dtype=torch.float32)
    return [(n, p.numel()) for n, p in reversed(list(m.named_parameters()))]


GRADS = _resnet_grads()
CAP = sum(n for _, n in GRADS) * 4 * 3 // 5  # two fused buckets, 60 % and 40 %


@pytest.fixture(scope="module")
def worlds():
    built = {kind: make_world([kind] * K) for kind in ("port", "ref")}
    yield built
    for world in built.values():
        for p in world:
            p.stop()


def _sessions(world):
    out = []
    for p in world:
        if isinstance(p, Peer):
            out.append(HostSession(Strategy.RING_SEGMENTED, p.self_id, p.config.peers, p.client,
                                   p.collective, timeout=60.0))
        else:
            out.append(RHostSession(RStrategy.RING_SEGMENTED, p.self_id, p.config.peers,
                                    p.client, p.collective, timeout=60.0))
    return out


def _inputs(r):
    rng = np.random.default_rng(500 + r)
    return [rng.standard_normal(n).astype(np.float32) for _, n in GRADS]


def _run(sessions, kind, mode):
    """ROUNDS scheduler rounds on every session: `ar` submits every
    gradient for the allreduce, `zero` hands them to a sharded SGD."""
    port = kind == "port"

    def run(r):
        s = sessions[r]
        xs = _inputs(r)
        sched = s.scheduler()
        if mode == "zero":
            params = [np.zeros(n, np.float32) for _, n in GRADS]
            zs = (zero.ShardedUpdateSession([torch.from_numpy(p) for p in params],
                                            zero.ShardedSGD(0.1), name="st", session=s)
                  if port else rzero.ShardedUpdateSession(params, rzero.ShardedSGD(0.1),
                                                          name="st", session=s))
        for rnd in range(ROUNDS):
            outs = [np.empty_like(x) for x in xs]
            for i, ((name, _), x, o) in enumerate(zip(GRADS, xs, outs)):
                if mode == "zero":
                    zs.submit_grad(i, torch.from_numpy(x.copy()) if port else x.copy())
                elif port:
                    sched.submit(Workspace(torch.from_numpy(x), torch.from_numpy(o),
                                           ReduceOp.SUM, name))
                else:
                    sched.submit(RWorkspace(send=x, recv=o, op=RReduceOp.SUM, name=name))
            if mode == "zero":
                zs.flush(timeout=90)
                zs.wait_params(timeout=90)
            else:
                sched.flush(timeout=90)

    run_all([lambda r=r: run(r) for r in range(K)])
    for s in sessions:
        s.close(timeout=10)


def _structure(timelines, world):
    """Each timeline's rounds and lanes with peer labels turned into ranks,
    sorted (the store does not say which in-process peer wrote which)."""
    rank = {str(p.self_id): r for r, p in enumerate(world)}
    out = []
    for tl in timelines:
        lanes = []
        for b in tl["buckets"]:
            lanes.append((b["index"], b["kind"], b["name"], b["bytes"], b["members"],
                          b["strategy"], rank.get(b["edge"]), b["walk_us"] > 0,
                          b["t_launch_us"] is not None, b["unpack_us"] >= 0,
                          rank.get(b.get("gather_edge")), (b.get("gather_us") or 0) > 0))
        out.append((tl["epoch"], tl["round"], tl["t_end_us"] is not None,
                    tl["overlap_frac"] is not None, tuple(lanes)))
    return sorted(out)


@pytest.mark.parametrize("mode", ["ar", "zero"])
def test_scheduler_timelines_have_the_references_structure(mode, worlds, monkeypatch):
    monkeypatch.setenv("KF_CONFIG_ASYNC", "on")
    monkeypatch.setenv("KF_TELEMETRY_SPAN_SAMPLE", "1.0")
    for cls in (HostSession, RHostSession):
        monkeypatch.setattr(cls, "SEGMENT_MIN_BYTES", 0)
        monkeypatch.setattr(cls, "GROUP_BUCKET_BYTES", CAP)
    got = {}
    for kind, mod in (("port", steptrace), ("ref", rsteptrace)):
        mod.reset_store()
        try:
            _run(_sessions(worlds[kind]), kind, mode)
            got[kind] = _structure(mod.get_store().timelines(), worlds[kind])
        finally:
            mod.reset_store()
    assert got["port"] == got["ref"]
    tls = got["port"]
    assert len(tls) == K * (ROUNDS - 1)
    assert sorted({t[1] for t in tls}) == list(range(1, ROUNDS))
    for _, _, flushed, has_overlap, lanes in tls:
        assert flushed and has_overlap
        assert all(lane[7] and lane[8] and lane[5] == "RING_SEGMENTED" for lane in lanes)
        if mode == "ar":
            assert [lane[0] for lane in lanes] == [0, 1]  # the 2 fused buckets
            assert sum(lane[4] for lane in lanes) == len(GRADS)
    # every rank's lanes name its ring successor, the walk's outgoing edge
    edges = sorted({lane[6] for t in tls for lane in t[4]})
    assert edges == list(range(K))
    if mode == "zero":
        assert all(lane[1] == "zero" and lane[11] for t in tls for lane in t[4])

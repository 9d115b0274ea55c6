"""The resource and memory planes end to end: mixed worlds of the two
packages, and kfrun worlds of 4 on ports in 12000-19999, one at a time;
mirrors tests/test_memory_e2e.py.

- In-process mixed worlds of 2 reference + 2 port peers (both rank
  layouts): `measured_compute_frac` shares one cluster maximum of the
  peers' compute fractions, one f32 a peer under the reference's name,
  and `check_replan` derives one plan digest, clamped by it, equal to an
  all-reference world's on the same inputs.
- A kfrun world of 4 port workers under the port's `-w -debug-port`:
  `/cluster/resources` and `/cluster/memory` list all 4 peers, every
  worker's `/resources` and `/memory` has the reference's keys and
  attributes CPU to the engine's threads and bytes to its accountants,
  and `/cluster/health` carries both summaries.
- A mixed world (ranks 0 and 2 the JAX package's workers): the port's
  watcher merges the reference's workers and the reference's aggregator
  the port's, with no error, and both packages' `classify_cause` give
  the same cause for every peer on both merges.
- A kfrun world of 4 port workers under a fake `KF_MEMORY_LIMIT`: the
  rank that grows to the limit and is SIGKILLed leaves an
  `oom_suspected` postmortem at `/cluster/postmortem` and in
  `postmortems.jsonl`, rendering its final memory attribution."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from kungfu_tpu.telemetry import cluster as rcluster
from kungfu_tpu.telemetry import decisions as rdecisions
from kungfu_tpu.telemetry import flight as rflight
from kungfu_tpu.telemetry import memory as rmemory
from kungfu_tpu.telemetry import resource as rresource
from kungfu_tpu.telemetry import straggler as rstraggler
from kungfu_tpu_torch.plan import replan as rp
from kungfu_tpu_torch.telemetry import cluster, decisions, flight, memory, resource, straggler
from test_torch_port_runner import free_range, port_env
from test_torch_port_worlds import (  # noqa: F401 - fixtures used by name
    make_world, ref_native, run_all, small_arenas)
from test_torch_port_zero import close_all, sessions

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# in process: one compute fraction and one plan in a mixed world
# ---------------------------------------------------------------------------

LAYOUTS = {"ref_first": ["ref", "port", "ref", "port"], "port_first": ["port", "ref", "port", "ref"],
           "all_ref": ["ref"] * 4}


@pytest.fixture(scope="module")
def worlds(ref_native):
    built = {name: make_world(kinds) for name, kinds in LAYOUTS.items()}
    yield built
    for world in built.values():
        for p in world:
            p.stop()


class _ThreadPlane:
    """A resource plane whose compute fraction is the calling thread's:
    in-process peers share one plane a package, so each rank's thread
    sets its own."""

    local = threading.local()

    def compute_frac(self):
        return self.local.cf


@pytest.fixture
def thread_planes(monkeypatch):
    for mod in (resource, rresource):
        monkeypatch.setattr(mod, "get_plane", lambda: _ThreadPlane())
    for led in (decisions, rdecisions):
        led.reset_ledger()
    yield
    for led in (decisions, rdecisions):
        led.reset_ledger()


CFS = [(0.0, 0.0, 0.0, 0.0), (0.1, 0.7, 0.3, 0.05), (0.95, 0.2, 0.4, 0.6), (0.0, 0.0, 0.5, 0.0),
       (0.123456789, 0.0, 0.0, 0.3333333), (1.5, -0.2, 0.1, 0.2)]


def _crafted_matrix(k=4):
    m = np.full((k, k), 200.0)
    np.fill_diagonal(m, 0.0)
    m[1, 2] = 1.0  # the edge 1 -> 2 is 200x slower: the unclamped gain is 200
    return m


def _round(ss, cfs, fn):
    out = {}

    def one(r, s):
        _ThreadPlane.local.cf = cfs[r]
        out[r] = fn(s)

    run_all([lambda r=r, s=s: one(r, s) for r, s in enumerate(ss)])
    return out


@pytest.mark.parametrize("cfs", CFS)
@pytest.mark.parametrize("layout", ["ref_first", "port_first"])
def test_a_mixed_world_shares_one_compute_frac_and_one_plan(layout, cfs, worlds, thread_planes):
    """The round adopts only at a clamped gain of 2 or more (chip_smoke's
    leg (a) gate): every rank the same plan, or every rank none."""
    want_cf = round(float(np.float32(max(0.0, min(1.0, max(cfs))))), 6)
    want_gain = round(min(200.0, 1.0 / want_cf) if want_cf > 0 else 200.0, 6)
    got = {}
    for name in (layout, "all_ref"):
        ss = sessions(worlds[name])
        try:
            cf = _round(ss, cfs, lambda s: s.measured_compute_frac())
            assert set(cf.values()) == {want_cf}, (name, cf)
            m = _crafted_matrix()
            for s in ss:
                s.replan_mode = "ring"
                s.measured_matrix = lambda m=m: m.copy()
            plans = _round(ss, cfs, lambda s: s.check_replan(want=True, min_gain=2.0))
            got[name] = {None if p is None else (p.to_bytes().hex(), p.gain)
                         for p in plans.values()}
        finally:
            close_all(ss)
    assert len(got[layout]) == 1 and got[layout] == got["all_ref"]
    (plan,) = got[layout]
    if want_gain >= 2.0:
        assert plan is not None and plan[1] == want_gain
    else:
        assert plan is None


def test_the_plan_digest_is_the_plans_bytes():
    plan = rp.RingPlan(order=(0, 2, 1, 3), weights=None, gain=2.5)
    from kungfu_tpu.plan import replan as rrp

    rplan = rrp.RingPlan(order=(0, 2, 1, 3), weights=None, gain=2.5)
    assert plan.to_bytes() == rplan.to_bytes()
    assert rp.plan_digest(plan) == rrp.plan_digest(rplan)


# ---------------------------------------------------------------------------
# kfrun worlds
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""\
    import json, os, signal, sys, time
    me = os.environ["KF_SELF_SPEC"]
    specs = os.environ["KF_INIT_PEERS"].split(",")
    rank = specs.index(me)
    if os.environ.get("KF_INIT_CLUSTER_VERSION", "0") != "0":
        time.sleep(120)  # a survivor respawned by the recovery: idle until stopped
        sys.exit(0)
    ref = str(rank) in os.environ["MX_REF_RANKS"].split(",")
    import numpy as np
    if ref:
        from kungfu_tpu import api
        from kungfu_tpu.policy import PolicyRunner
        from kungfu_tpu.telemetry import memory as tmem
        from kungfu_tpu.telemetry import resource as tres
        wrap, unwrap = (lambda x: x), np.asarray
    else:
        import torch
        from kungfu_tpu_torch import api
        from kungfu_tpu_torch.policy import PolicyRunner
        from kungfu_tpu_torch.telemetry import memory as tmem
        from kungfu_tpu_torch.telemetry import resource as tres
        wrap, unwrap = torch.from_numpy, (lambda t: t.numpy())

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    k = len(specs)
    # 4 gradients of 1 MB and the ranks' stop votes, one fused bucket
    grads = [wrap(np.full(n, float(rank + 1), np.float32)) for n in [250_000] * 4 + [1]]
    outs = [wrap(np.empty(n, np.float32)) for n in [250_000] * 4 + [1]]
    done, oom = os.environ["MX_DONE"], os.environ.get("MX_OOM_RANK") == str(rank)
    limit = int(float(os.environ.get("KF_MEMORY_LIMIT") or 0))
    deadline = time.time() + 120
    hoard = []
    with PolicyRunner([], batch_size=1) as runner:
        steps = 0
        while True:
            # any rank's vote stops every rank at the same step
            grads[4][0] = float(time.time() > deadline or os.path.exists(done)
                                or (oom and rss() >= 0.97 * limit))
            with runner.step():
                api.group_all_reduce_async(grads, name="step", outs=outs).wait()
            assert float(unwrap(outs[0])[0]) == k * (k + 1) / 2
            steps += 1
            if float(unwrap(outs[4])[0]) >= 1:
                break
            if oom:  # a rising slab a step, as a leak toward the OOM killer grows
                slab = bytearray(24 << 20)
                slab[::4096] = b"\\1" * len(slab[::4096])
                hoard.append(slab)
            time.sleep(0.05)
        runner._signals_at = 0.0
        runner._pull_cluster_signals()
        keys = [key for key in runner.ctx.metrics if key.startswith(("resource/", "memory/"))]
        print("MX " + json.dumps({
            "rank": rank, "ref": ref, "steps": steps, "signals": sorted(keys),
            "compute_frac": tres.get_plane().compute_frac(),
            "grow_ok": list(tmem.get_plane().grow_ok())}), flush=True)
    if oom:
        print(f"mx rank {rank}: at rss {rss()} of {limit}, dying (SIGKILL)", flush=True)
        time.sleep(0.5)  # the journal's last snapshots see the slab
        os.kill(os.getpid(), signal.SIGKILL)
    if os.environ.get("MX_OOM_RANK"):
        time.sleep(120)  # a survivor: the recovery's SIGTERM ends it
    api.run_barrier()
    """)

PLANE_KEYS = ("/resources", "/memory")
OOM_LIMIT = 768 << 20


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def run_world(tmp, ref_ranks="", oom_rank=None, timeout=150.0):
    """One kfrun world of 4; returns what the views and workers showed.
    Without `oom_rank`: waits until both cluster views list 4 measured
    peers, reads every worker's planes (and, in the test process, both
    packages' aggregators over them), then stops the workers. With it:
    waits for the postmortem of `oom_rank`."""
    (tmp / "w.py").write_text(WORKER)
    base, dbg, runner = free_range(4), free_range(1), free_range(1)
    specs = [f"127.0.0.1:{base + i}" for i in range(4)]
    run_dir = tmp / "run"
    env = port_env()
    env.update(KF_TELEMETRY="metrics,audit", KF_CONFIG_ASYNC="on", KF_CONFIG_ALGO="segmented",
               KF_CONFIG_SHM="0", KF_CLUSTER_SCRAPE_INTERVAL="0.5", KF_FLIGHT_INTERVAL="0.2",
               KF_RESOURCE_INTERVAL="0.2", KF_MEMORY_INTERVAL="0.1",
               KF_TELEMETRY_DIR=str(run_dir), MX_DONE=str(tmp / "done"),
               MX_REF_RANKS=ref_ranks, MX_OOM_RANK="" if oom_rank is None else str(oom_rank))
    extra = []
    if oom_rank is not None:
        env.update(KF_MEMORY_LIMIT=str(OOM_LIMIT), KF_MEMORY_OOM_MARGIN="0.15")
        extra = ["-auto-recover", "30s", "-builtin-config-port", "0"]
    out, err = tmp / "kfrun.out", tmp / "kfrun.err"
    p = subprocess.Popen(
        [sys.executable, "-m", "kungfu_tpu_torch.runner.cli", "-np", "4", "-H", "127.0.0.1:4",
         "-port-range", f"{base}-{base + 3}", "-runner-port", str(runner), "-monitor-port", "0",
         "-warm-spares", "0", "-w", "-debug-port", str(dbg), "-timeout", str(int(timeout)),
         *extra, "--", sys.executable, str(tmp / "w.py")],
        env=env, cwd=REPO, stdout=out.open("w"), stderr=err.open("w"))
    url = f"http://127.0.0.1:{dbg}"
    got = {"specs": specs, "run_dir": run_dir}
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline and p.poll() is None:
            try:
                if oom_rank is None:
                    views = {path: _get(url + "/cluster" + path) for path in PLANE_KEYS}
                    docs = {path: {s: _get(f"http://127.0.0.1:{int(s.split(':')[1]) + 10000}"
                                           + path) for s in specs} for path in PLANE_KEYS}
                    # every view lists the 4 measured peers, and every worker
                    # has attributed CPU ticks to the engine's threads and
                    # filled its step ring (the first steps may come first)
                    if all(sorted(v["peers"]) == sorted(specs) and all(
                            row.get("sweeps", 0) >= 2 for row in v["peers"].values())
                           for v in views.values()) and all(
                            sum(d["buckets"][b]["cpu_s"] for b in ("walk_compute", "codec",
                                                                  "sched")) > 0
                            for d in docs["/resources"].values()) and all(
                            d["accountants"].get("steptrace", 0) > 0
                            for d in docs["/memory"].values()):
                        got["views"] = views
                        got["health"] = _get(url + "/cluster/health")
                        got["workers_docs"] = docs
                        got["aggs"] = _both_aggregators(specs)
                        (tmp / "done").write_text("ok")
                        break
                else:
                    pm = _get(url + "/cluster/postmortem")
                    if pm["deaths"]:
                        got["postmortem"] = pm
                        break
            except (OSError, ValueError):
                pass
            time.sleep(0.3)
        if oom_rank is None:
            p.wait(max(1.0, deadline - time.monotonic()))
        else:
            p.terminate()  # kfrun dies; its workers get SIGTERM from kf-pdeathsig
            p.wait(30)
            time.sleep(1.0)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(30)
    got["rc"] = p.returncode
    got["stdout"], got["stderr"] = out.read_text(), err.read_text()
    got["workers"] = {w["rank"]: w for w in (json.loads(line.split("MX ", 1)[1])
                                             for line in got["stdout"].splitlines()
                                             if "MX {" in line)}
    want = "postmortem" if oom_rank is not None else "views"
    assert want in got, f"no {want}:\n{got['stderr'][-3000:]}"
    return got


def _both_aggregators(specs):
    """Both packages' aggregators over the workers, in this process: their
    merged views and every peer's cause by both packages' classifiers."""
    out = {}
    for name, mod in (("port", cluster), ("ref", rcluster)):
        agg = mod.TelemetryAggregator(interval=5.0, timeout=5.0)
        agg.set_peers([(s, f"http://127.0.0.1:{int(s.split(':')[1]) + 10000}") for s in specs])
        try:
            res, mem = agg.cluster_resources(), agg.cluster_memory()
            causes = {s: [straggler.classify_cause(s, [], None, res, mem),
                          rstraggler.classify_cause(s, [], None, res, mem)] for s in specs}
            out[name] = {"resources": res, "memory": mem, "causes": causes,
                         "errors": {st.label: (st.errors, st.last_error) for st in agg.peers()}}
        finally:
            agg.stop()
    return out


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("mxport"))


@pytest.fixture(scope="module")
def mixed_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("mxmixed"), ref_ranks="0,2")


@pytest.fixture(scope="module")
def oom_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("mxoom"), oom_rank=3)


@pytest.mark.parametrize("world_name", ["port_world", "mixed_world"])
def test_the_watchers_views_list_all_four_peers(world_name, request):
    world = request.getfixturevalue(world_name)
    assert world["rc"] == 0, world["stderr"][-3000:]
    for path, view in world["views"].items():
        assert view["count"] == 4 and sorted(view["peers"]) == sorted(world["specs"]), path
        assert all(row["supported"] for row in view["peers"].values()), path
    health = world["health"]
    assert sorted(health["resources"]["peers"]) == sorted(world["specs"])
    assert sorted(health["memory"]["peers"]) == sorted(world["specs"])
    assert health["memory"]["min_headroom_peer"] in world["specs"]


@pytest.mark.parametrize("world_name", ["port_world", "mixed_world"])
def test_every_worker_serves_both_planes_with_the_references_keys(world_name, request):
    world = request.getfixturevalue(world_name)
    res_keys = set(rresource.ResourcePlane(sample_hz=0).export())
    mem_keys = set(rmemory.MemoryPlane().export())
    for spec in world["specs"]:
        res = world["workers_docs"]["/resources"][spec]
        mem = world["workers_docs"]["/memory"][spec]
        assert set(res) == res_keys and set(mem) == mem_keys, spec
        assert res["peer"] == spec and mem["peer"] == spec
        cpu = {b: v["cpu_s"] for b, v in res["buckets"].items()}
        assert cpu["train"] > 0 and cpu["walk_compute"] + cpu["codec"] + cpu["sched"] > 0, cpu
        assert 0 < mem["rss_bytes"] < mem["limit_bytes"] and mem["headroom_frac"] > 0
        # the ledger holds no record here (no adaptation), so it may read 0
        assert {"steptrace", "link_table", "decisions"} <= set(mem["accountants"]), spec
        assert mem["accountants"]["steptrace"] > 0, spec


@pytest.mark.parametrize("world_name", ["port_world", "mixed_world"])
def test_every_workers_runner_reads_its_planes(world_name, request):
    world = request.getfixturevalue(world_name)
    workers = world["workers"]
    assert sorted(workers) == [0, 1, 2, 3]
    for r, w in workers.items():
        assert {"resource/cpu_frac", "resource/saturated_peers", "memory/headroom_frac",
                "memory/min_headroom_peer"} <= set(w["signals"]), (r, w["signals"])
        assert 0.0 <= w["compute_frac"] <= 1.0 and w["grow_ok"][0] is True


def test_a_mixed_worlds_peers_are_the_packages_asked_for(mixed_world):
    assert [mixed_world["workers"][r]["ref"] for r in range(4)] == [True, False, True, False]


@pytest.mark.parametrize("agg", ["port", "ref"])
def test_each_packages_aggregator_merges_the_mixed_world(agg, mixed_world):
    got = mixed_world["aggs"][agg]
    specs = mixed_world["specs"]
    assert all(e == (0, "") for e in got["errors"].values()), got["errors"]
    for key in ("resources", "memory"):
        assert sorted(got[key]["peers"]) == sorted(specs), key
    for spec, (mine, theirs) in got["causes"].items():
        assert mine == theirs and mine[0] in ("compute", "memory", "unknown"), spec


def test_the_oom_world_harvests_an_oom_suspected_postmortem(oom_world):
    dead = oom_world["specs"][3]
    pms = oom_world["postmortem"]
    assert pms["deaths"] == 1 and list(pms["peers"]) == [dead]
    pm = pms["peers"][dead][-1]
    assert pm["death"] == "signal SIGKILL (-9)", pm["death"]
    assert pm["oom_suspected"] is True, pm.get("last_memory")
    mem = pm["last_memory"]
    assert mem["limit_bytes"] == OOM_LIMIT and mem["rss_bytes"] >= 0.85 * OOM_LIMIT, mem
    assert mem["buckets"]["untracked"]["bytes"] > 0
    assert pm["last_resources"] is not None and pm["last_resources"]["supported"]


def test_the_oom_postmortem_renders_and_persists_alike(oom_world):
    dead = oom_world["specs"][3]
    pm = oom_world["postmortem"]["peers"][dead][-1]
    text = flight.render_postmortem(pm)
    assert text == rflight.render_postmortem(pm)
    assert "final memory attribution (memory plane):" in text and "OOM suspected" in text
    assert "final CPU attribution (resource plane):" in text
    for mod in (flight, rflight):
        pms = mod.read_postmortems(str(oom_world["run_dir"]))
        assert [x["peer"] for x in pms] == [dead] and pms[0]["oom_suspected"] is True


def test_the_oom_worlds_survivors_kept_their_headroom(oom_world):
    workers = oom_world["workers"]
    assert sorted(workers) == [0, 1, 2, 3]
    assert all(workers[r]["grow_ok"][0] for r in range(3))

"""The port's network monitors (`kungfu_tpu_torch/monitor/net.py`,
`latency.py`) and the engine's telemetry hooks, against the JAX
package's:

- `RateCounter` and `NetMonitor` under an injected clock: totals, rates
  and their exposition blocks; the singleton's registry mirroring and
  the standalone `MetricsServer`;
- `latency_matrix_from_rows`, the probe over a fake client, and the MST
  that `api.optimized_tree` returns against the reference's MST of the
  same matrix;
- a world of 4 workers under the port's kfrun with
  `KF_TELEMETRY=metrics,trace,audit`, once all reference and once mixed
  (ranks 0 and 2 the reference, 1 and 3 the port): every rank runs the
  same host collectives, probes latencies, builds the optimized tree and
  scrapes its own `/metrics`, `/trace` and `/audit`; the deterministic
  families (wire bytes by label, egress and ingress bytes and messages by
  peer, ring position and successor, role, wire mode) must be equal rank
  by rank.

One world at a time; ports from `free_range` (12000-19999, so the
telemetry servers land on 22000-29999)."""

import json
import random
import subprocess
import sys
import textwrap
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from kungfu_tpu.monitor import latency as rlatency
from kungfu_tpu.monitor import net as rnet
from kungfu_tpu.plan.mst import minimum_spanning_tree as rmst
from kungfu_tpu.plan.peer import PeerID as RPeerID
from kungfu_tpu.telemetry import metrics as rmetrics
from kungfu_tpu_torch import api
from kungfu_tpu_torch.monitor import latency, net
from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.telemetry import config, metrics
from test_torch_port_runner import free_range, port_env
from test_torch_port_telemetry import clean_telemetry  # noqa: F401
from test_torch_port_worlds import free_ports

REPO = Path(__file__).resolve().parent.parent
RUN_TIMEOUT = 240


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(net.time, "monotonic", c)
    monkeypatch.setattr(rnet.time, "monotonic", c)
    return c


def _adds(seed: int):
    rng = random.Random(seed)
    return [(rng.choice([0.0, 0.01, 0.3, 0.7, 1.5]), rng.randint(0, 1 << 20))
            for _ in range(rng.randint(1, 30))]


@pytest.mark.parametrize("window", [0.5, 1.0, 5.0])
@pytest.mark.parametrize("seed", range(4))
def test_rate_counters_agree_under_one_clock(seed, window, clock):
    mine, theirs = net.RateCounter(window), rnet.RateCounter(window)
    for dt, n in _adds(seed):
        clock.t += dt
        mine.add(n)
        theirs.add(n)
        assert mine.total == theirs.total
        assert mine.rate() == theirs.rate()


@pytest.mark.parametrize("registry", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_net_monitors_agree_under_one_clock(seed, registry, clock):
    reg, rreg = (metrics.Registry(), rmetrics.Registry()) if registry else (None, None)
    mine, theirs = net.NetMonitor(registry=reg), rnet.NetMonitor(registry=rreg)
    rng = random.Random(seed)
    hosts = [("127.0.0.1", 20000 + i) for i in range(3)]
    for _ in range(40):
        clock.t += rng.choice([0.0, 0.05, 0.4])
        h = rng.choice(hosts)
        n = rng.randint(0, 70000)
        if rng.random() < 0.6:
            mine.sent(PeerID(*h), n)
            theirs.sent(RPeerID(*h), n)
        else:
            mine.received(PeerID(*h), n)
            theirs.received(RPeerID(*h), n)
    order = [PeerID(*h) for h in hosts] + [PeerID("10.0.0.9", 1)]
    rorder = [RPeerID(*h) for h in hosts] + [RPeerID("10.0.0.9", 1)]
    assert mine.egress_rates(order) == theirs.egress_rates(rorder)
    assert mine.ingress_rates(order) == theirs.ingress_rates(rorder)
    assert ({str(p): v for p, v in mine.egress_totals().items()}
            == {str(p): v for p, v in theirs.egress_totals().items()})
    assert mine.render_rates() == theirs.render_rates()
    assert mine.render_metrics() == theirs.render_metrics()
    if registry:
        assert reg.render() == rreg.render()


def test_the_singleton_mirrors_into_the_process_registry(clock):
    mon = net.get_monitor()
    assert net.get_monitor() is mon
    mon.sent(PeerID("127.0.0.1", 1), 10)
    mon.sent(PeerID("127.0.0.1", 1), 5)
    mon.received(PeerID("127.0.0.1", 2), 7)
    text = metrics.render()
    assert 'kungfu_egress_bytes_total{peer="127.0.0.1:1"} 15' in text
    assert 'kungfu_egress_messages_total{peer="127.0.0.1:1"} 2' in text
    assert 'kungfu_ingress_bytes_total{peer="127.0.0.1:2"} 7' in text
    assert text.count("# TYPE kungfu_egress_rate gauge") == 1


def test_metrics_server_serves_the_monitor_and_the_registry(clock):
    metrics.counter("kungfu_x_total", "x").inc()
    mon = net.get_monitor()
    mon.sent(PeerID("127.0.0.1", 1), 3)
    srv = net.MetricsServer(mon, 0)
    srv.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            body = r.read().decode()
    finally:
        srv.stop()
    assert 'kungfu_egress_bytes{peer="127.0.0.1:1"} 3' in body
    assert "kungfu_x_total 1" in body
    assert body.count("# TYPE kungfu_egress_rate gauge") == 1


@pytest.mark.parametrize("raw", ["", "1", "on", "0"])
def test_enabled_follows_the_metrics_gate(raw, monkeypatch):
    monkeypatch.setenv("KF_CONFIG_ENABLE_MONITORING", raw)
    assert net.enabled() == rnet.enabled() == config.truthy(raw)


# ---------------------------------------------------------------------------
# latencies and the optimized tree
# ---------------------------------------------------------------------------

def _rows(seed: int, n: int):
    rng = np.random.default_rng(seed)
    rows = rng.uniform(1e-5, 1e-3, (n, n))
    np.fill_diagonal(rows, 0.0)
    return list(rows)


@pytest.mark.parametrize("seed", range(5))
def test_latency_matrices_agree(seed):
    rows = _rows(seed, 2 + seed)
    mine, theirs = latency.latency_matrix_from_rows(rows), rlatency.latency_matrix_from_rows(rows)
    assert mine.dtype == theirs.dtype and mine.tobytes() == theirs.tobytes()
    assert np.allclose(mine, mine.T)


@pytest.mark.parametrize("seed", range(6))
def test_the_optimized_tree_is_the_references_mst(seed):
    m = latency.latency_matrix_from_rows(_rows(100 + seed, 3 + seed))
    assert api.minimum_spanning_tree(m) == rmst(m)


class FakeClient:
    """ping() answers for the peers in `up`, taking `delay` seconds."""

    def __init__(self, up):
        self.up = set(up)

    def ping(self, peer, timeout=2.0):
        return str(peer) in self.up


@pytest.mark.parametrize("metrics_on", [False, True])
def test_probes_agree_on_a_fake_client(metrics_on, monkeypatch):
    if metrics_on:
        monkeypatch.setenv("KF_TELEMETRY", "metrics")
    hosts = [("127.0.0.1", 9000 + i) for i in range(4)]
    up = {f"127.0.0.1:{9000 + i}" for i in (0, 1, 3)}
    mine = latency.probe_peer_latencies(FakeClient(up), [PeerID(*h) for h in hosts], 1, 2)
    theirs = rlatency.probe_peer_latencies(FakeClient(up), [RPeerID(*h) for h in hosts], 1, 2)
    for a, b in ((mine, theirs),):
        assert a[1] == b[1] == 0.0 and np.isinf(a[2]) and np.isinf(b[2])
        assert (a[[0, 3]] > 0).all() and (b[[0, 3]] > 0).all()
    names = sorted(n for n in metrics.get_registry().collect())
    rnames = sorted(n for n in rmetrics.get_registry().collect())
    assert names == rnames == (["kungfu_peer_rtt_seconds"] if metrics_on else [])
    if metrics_on:
        fam = metrics.get_registry().collect()["kungfu_peer_rtt_seconds"]
        assert sorted(ls for _, ls, _ in fam) == ['{peer="127.0.0.1:9000"}',
                                                  '{peer="127.0.0.1:9003"}']


# ---------------------------------------------------------------------------
# a kfrun world of 4: all reference, then mixed
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""\
    import json, os, urllib.request
    me = os.environ["KF_SELF_SPEC"]
    specs = os.environ["KF_INIT_PEERS"].split(",")
    rank = specs.index(me)
    ref = str(rank) in os.environ["TM_REF_RANKS"].split(",")
    if ref:
        import numpy as np
        from kungfu_tpu import api
        from kungfu_tpu.peer import get_default_peer
        from kungfu_tpu.telemetry import promparse
        arr = lambda n, dt: (np.arange(n) % 7 + rank).astype(dt)
        as_list = lambda x: np.asarray(x).tolist()
        f32, i32 = np.float32, np.int32
    else:
        import torch
        from kungfu_tpu_torch import api
        from kungfu_tpu_torch.peer import get_default_peer
        from kungfu_tpu_torch.telemetry import promparse
        arr = lambda n, dt: (torch.arange(n) % 7 + rank).to(dt)
        as_list = lambda x: x.tolist()
        f32, i32 = torch.float32, torch.int32

    peer = get_default_peer()
    sums = []
    for n in (1000, 300_001):
        sums.append(float(as_list(api.all_reduce_array(arr(n, f32), name=f"a{n}"))[-1]))
    sums.append(as_list(api.all_reduce_array(arr(5, i32), name="i"))[-1])
    outs = api.group_all_reduce_arrays([arr(3000, f32), arr(70_001, f32), arr(9, f32)],
                                       name="g")
    sums.append(float(as_list(outs[1])[-1]))
    sums.append(float(as_list(api.broadcast_array(arr(4000, f32), root=1, name="b"))[0]))
    g = api.gather_arrays(arr(6, f32), root=2, name="gt")
    lat = as_list(api.get_peer_latencies(2))
    tree = api.optimized_tree(2)
    api.run_barrier()

    base = f"http://127.0.0.1:{peer.self_id.port + 10000}"
    def get(path):
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.read().decode()
    # each plane sweeps when its view is read, and registers its families
    planes = {path: json.loads(get(path))["supported"] for path in ("/resources", "/memory")}
    samples = promparse.parse_text(get("/metrics"))
    trace = json.loads(get("/trace"))
    audit = json.loads(get("/audit"))
    rank_of = {s: i for i, s in enumerate(specs)}
    fams = {}
    for s in samples:
        labels = dict(s.labels)
        for k in ("peer", "dst"):
            if k in labels:
                labels[k] = rank_of[labels[k]]
        key = s.name
        if key in ("kungfu_collective_wire_bytes_total", "kungfu_egress_bytes_total",
                   "kungfu_egress_messages_total", "kungfu_ingress_bytes_total",
                   "kungfu_ingress_messages_total", "kungfu_topology_ring_position",
                   "kungfu_topology_ring_next", "kungfu_topology_ring_role",
                   "kungfu_collective_wire_mode", "kungfu_topology_replans_total"):
            fams.setdefault(key, {})[json.dumps(labels, sort_keys=True)] = s.value
    names = sorted({s.name for s in samples})
    print("TM " + json.dumps({
        "rank": rank, "ref": ref, "sums": sums, "gathered": g is not None,
        "lat": lat, "tree": tree, "fams": fams, "names": names, "planes": planes,
        "spans": sorted({e["name"] for e in trace["traceEvents"]}),
        "audit": [r["kind"] for r in audit]}), flush=True)
""")


def _run_world(tmp: Path, ref_ranks: str):
    (tmp / "w.py").write_text(WORKER)
    base, runner = free_range(4), free_ports(1)[0]
    env = port_env()
    env.update(KF_TELEMETRY="metrics,trace,audit", TM_REF_RANKS=ref_ranks,
               KF_CONFIG_SHM_CAPACITY=str(8 << 20))
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.runner.cli", "-np", "4", "-H",
         "127.0.0.1:4", "-port-range", f"{base}-{base + 3}", "-runner-port", str(runner),
         "--", sys.executable, str(tmp / "w.py")],
        env=env, capture_output=True, text=True, timeout=RUN_TIMEOUT, cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-4000:]}"
    res = [json.loads(l.split("TM ", 1)[1]) for l in r.stdout.splitlines() if "TM " in l]
    assert sorted(x["rank"] for x in res) == [0, 1, 2, 3]
    return {x["rank"]: x for x in res}


@pytest.fixture(scope="module")
def telemetry_worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("tmworld")
    return {"ref": _run_world(d, "0,1,2,3"), "mixed": _run_world(d, "0,2")}


FAMILIES = ["kungfu_collective_wire_bytes_total", "kungfu_egress_bytes_total",
            "kungfu_egress_messages_total", "kungfu_ingress_bytes_total",
            "kungfu_ingress_messages_total", "kungfu_topology_ring_position",
            "kungfu_topology_ring_next", "kungfu_topology_ring_role",
            "kungfu_collective_wire_mode"]


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("family", FAMILIES)
def test_mixed_world_families_equal_the_reference_worlds(telemetry_worlds, family, rank):
    ref, mixed = telemetry_worlds["ref"][rank], telemetry_worlds["mixed"][rank]
    assert mixed["ref"] == (rank in (0, 2)) and ref["ref"]
    assert ref["fams"].get(family), family
    assert mixed["fams"][family] == ref["fams"][family]


@pytest.mark.parametrize("world", ["ref", "mixed"])
def test_world_results_latencies_and_tree(telemetry_worlds, world):
    ranks = telemetry_worlds[world]
    assert len({json.dumps(r["sums"]) for r in ranks.values()}) == 1
    assert [ranks[r]["gathered"] for r in range(4)] == [False, False, True, False]
    for r, x in ranks.items():
        assert x["lat"][r] == 0.0
        assert all(v > 0 and v != float("inf") for i, v in enumerate(x["lat"]) if i != r)
    trees = {json.dumps(x["tree"]) for x in ranks.values()}
    assert len(trees) == 1
    tree = ranks[0]["tree"]
    assert len(tree) == 4 and sum(1 for i, f in enumerate(tree) if i == f) == 1


@pytest.mark.parametrize("world", ["ref", "mixed"])
def test_every_rank_serves_the_same_families_spans_and_audit(telemetry_worlds, world):
    ranks = telemetry_worlds[world]
    ref = telemetry_worlds["ref"][0]
    for x in ranks.values():
        # a port rank registers every family a reference rank does, the
        # resource and memory planes' too (each swept before the scrape)
        assert x["planes"] == {"/resources": True, "/memory": True}
        assert set(x["names"]) == set(ref["names"]), " ".join(
            sorted(set(ref["names"]) ^ set(x["names"])))
        assert any(n.startswith("kungfu_memory_") for n in x["names"])
        assert any(n.startswith("kungfu_resource_") for n in x["names"])
        for span in ("collective.all_reduce", "collective.broadcast", "transport.send"):
            assert span in x["spans"]
        assert x["audit"] == ref["audit"]

"""The port's cluster aggregator (`kungfu_tpu_torch/telemetry/cluster.py`),
`monitor.cluster_health` and `PolicyRunner`'s cluster signals against the
JAX package's, in process; mirrors tests/test_telemetry_cluster.py and
tests/test_agg_scale.py.

- `parse_worker_page` reads the port's and the reference's `/metrics`
  alike; `_HistSnapshot` deltas, quantiles and documents agree, and so
  does the NTP-style `_note_clock`.
- Both packages' aggregators scrape the same 4 in-process
  `TelemetryServer`s of the port (each with its own seeded registry,
  step ring and decision ledger; one worker slow, the edge rank 1 →
  rank 2 slow) through one fetch that hands both the same bytes and no
  clock header: equal `cluster_metrics` text, and equal
  `cluster_health`, `cluster_steps`, `cluster_links`,
  `cluster_decisions`, `cluster_postmortem` and `cluster_trace`
  documents apart from times, and the same straggler audit events.
- `health_signals` and `monitor.cluster_health` agree; `PolicyRunner`
  fed the same planes sets the same ``step/*`` and ``cluster/*`` keys,
  and `StragglerPolicy` and `ReplanPolicy`'s re-plan and demotion
  watches then act the same.
- Delta scrapes (`KF_AGG_DELTA=on`), scale mode with
  `KF_AGG_HIER_MIN_PEERS` lowered to 2 (`HostSubAggregator`,
  `update_host_role`'s election, `/host/telemetry`, the sampled link
  matrix), a dead target's nulled state and the overload backoff agree.

Both aggregators also read every worker's `/resources` and `/memory`:
their `resources`/`memory` summaries of /cluster/health, and the
`resource/*`/`memory/*` signals, agree."""

import json
import math
import threading
import time
import urllib.request

import numpy as np
import pytest

from kungfu_tpu import monitor as rmonitor
from kungfu_tpu import policy as rpolicy
from kungfu_tpu.plan.peer import PeerID as RPeerID, PeerList as RPeerList
from kungfu_tpu.telemetry import audit as raudit
from kungfu_tpu.telemetry import cluster as rcluster
from kungfu_tpu.telemetry import config as rconfig
from kungfu_tpu.telemetry import decisions as rdecisions
from kungfu_tpu.telemetry import metrics as rmetrics
from kungfu_tpu.telemetry import steptrace as rsteptrace
from kungfu_tpu_torch import monitor, policy
from kungfu_tpu_torch.plan.peer import PeerID, PeerList
from kungfu_tpu_torch.telemetry import audit, cluster, config, decisions, metrics, steptrace
from kungfu_tpu_torch.telemetry.http import TelemetryServer

K = 4
SLOW = 3  # the worker whose compute is slow (the straggler)
EDGE = (1, 2)  # the slow edge: rank 1's sends to rank 2


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("KF_TELEMETRY", "KF_AGG_DELTA", "KF_AGG_HIER_MIN_PEERS",
                 "KF_CLUSTER_HEALTH_URL", "KF_TELEMETRY_SPAN_SAMPLE"):
        monkeypatch.delenv(name, raising=False)

    def reset():
        for cfg, aud, dec, st, cl in ((config, audit, decisions, steptrace, cluster),
                                      (rconfig, raudit, rdecisions, rsteptrace, rcluster)):
            cfg.refresh(None)
            aud.clear()
            dec.reset_ledger()
            st.reset_store()
            cl.set_aggregator(None)
            cl.set_host_sub(None)

    reset()
    yield
    monkeypatch.undo()
    reset()


# ---------------------------------------------------------------------------
# pure parts
# ---------------------------------------------------------------------------

def _page(mod, rng):
    """One worker's exposition in `mod`'s registry: every family the
    aggregator parses, seeded."""
    reg = mod.Registry()
    reg.counter("kungfu_steps_total", "s").inc(int(rng.integers(1, 500)))
    h = reg.histogram("kungfu_step_duration_seconds", "d")
    c = reg.histogram("kungfu_collective_latency_seconds", "c", ("kind",))
    for _ in range(int(rng.integers(1, 30))):
        h.observe(float(rng.uniform(0.001, 3.0)))
        c.labels(str(rng.choice(["all_reduce", "broadcast"]))).observe(float(rng.uniform(0, 1)))
    for peer in ("a:1", "b:2"):
        reg.counter("kungfu_egress_bytes_total", "e", ("peer",)).labels(peer).inc(
            int(rng.integers(0, 1 << 30)))
        reg.counter("kungfu_ingress_bytes_total", "i", ("peer",)).labels(peer).inc(
            int(rng.integers(0, 1 << 30)))
        reg.gauge("kungfu_peer_rtt_seconds", "r", ("peer",)).labels(peer).set(
            float(rng.uniform(0, 0.01)))
        reg.gauge("kungfu_link_bandwidth_bytes_per_second", "b", ("dst",)).labels(peer).set(
            float(rng.uniform(1e6, 1e9)))
        reg.gauge("kungfu_link_latency_seconds", "l", ("dst",)).labels(peer).set(1e-4)
        reg.counter("kungfu_link_tx_bytes_total", "t", ("dst",)).labels(peer).inc(7)
        reg.counter("kungfu_link_tx_messages_total", "m", ("dst",)).labels(peer).inc(2)
    reg.gauge("kungfu_topology_ring_position", "p").set(int(rng.integers(0, 4)))
    reg.gauge("kungfu_topology_ring_next", "n", ("dst",)).labels("b:2").set(1)
    reg.gauge("kungfu_topology_ring_role", "o", ("level", "role")).labels("inter", "head").set(1)
    reg.gauge("kungfu_collective_wire_mode", "w", ("mode",)).labels("bf16").set(1)
    return reg.render()


@pytest.mark.parametrize("seed", range(3))
def test_parse_worker_page_reads_both_packages_pages_alike(seed):
    pages = [_page(m, np.random.default_rng(seed)) for m in (metrics, rmetrics)]
    assert pages[0] == pages[1]
    for text in pages:
        got = cluster.parsed_to_doc(cluster.parse_worker_page(text))
        want = rcluster.parsed_to_doc(rcluster.parse_worker_page(text))
        assert got == want
        assert got["steps_total"] is not None and got["step_hist"]["count"] > 0
        assert got["ring_next"] == "b:2" and got["wire_mode"] == "bf16"
        back = cluster.parsed_from_doc(json.loads(json.dumps(got)))
        assert cluster.parsed_to_doc(back) == got
    assert cluster.parsed_from_doc({}) == {**rcluster.parsed_from_doc({})}


def _hist(mod, rng, bounds):
    counts = np.cumsum(rng.integers(0, 20, len(bounds) + 1)).astype(float).tolist()
    return mod._HistSnapshot.from_doc({"bounds": bounds, "counts": counts,
                                       "sum": float(rng.uniform(0, 100)),
                                       "count": counts[-1]})


@pytest.mark.parametrize("seed", range(5))
def test_hist_snapshot_deltas_and_quantiles_agree(seed):
    rng = np.random.default_rng(seed)
    bounds = sorted(rng.uniform(0.001, 5, int(rng.integers(1, 12))).tolist())
    for mod in (cluster, rcluster):
        prev = _hist(mod, np.random.default_rng(seed), bounds)
        cur = mod._HistSnapshot(prev.bounds, [c + i for i, c in enumerate(prev.counts)],
                                prev.sum + 1.0, prev.count + len(prev.counts) - 1)
        w = cur.delta(prev)
        yield_ = [w.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)]
        yield_ += [cur.delta(None).count, cur.delta(cur).count, prev.delta(cur).count]
        if mod is cluster:
            got, doc = yield_, w.to_doc()
        else:
            assert [x if not math.isnan(x) else "nan" for x in got] == \
                [x if not math.isnan(x) else "nan" for x in yield_]
            assert doc == w.to_doc()
    assert cluster._HistSnapshot.from_doc({"x": 1}) is None
    assert math.isnan(cluster._HistSnapshot([], [0.0], 0.0, 0.0).quantile(0.5))


def test_note_clock_keeps_the_best_rtt_estimate_alike():
    rng = np.random.default_rng(3)
    sts = [m.PeerState("p", "http://h:1") for m in (cluster, rcluster)]
    for _ in range(40):
        rtt = float(rng.uniform(1e-4, 0.05))
        t0 = float(rng.uniform(0, 100))
        clock = rng.choice([None, "garbage", repr(float(rng.uniform(0, 1e8)))])
        for mod, st in zip((cluster, rcluster), sts):
            mod._note_clock(st, rtt, clock, t0, t0 + rtt)
        assert (sts[0].clock_offset_us, sts[0].best_rtt_s) == \
            (sts[1].clock_offset_us, sts[1].best_rtt_s)


@pytest.mark.parametrize("ports", [(38000, 38001), (55535, 55536), (1, 65535)])
def test_targets_for_workers_agree(ports):
    got = cluster.TelemetryAggregator.targets_for_workers(
        [PeerID("127.0.0.1", p) for p in ports])
    want = rcluster.TelemetryAggregator.targets_for_workers(
        [RPeerID("127.0.0.1", p) for p in ports])
    assert got == want


def test_the_port_serves_no_resource_or_memory_view():
    """The resource and memory views: the port serves every route of the
    reference, and a peerless aggregator's views and summaries agree."""
    assert "/cluster/resources" in rcluster.CLUSTER_ROUTES
    assert set(cluster.CLUSTER_ROUTES) == set(rcluster.CLUSTER_ROUTES)
    agg = cluster.TelemetryAggregator(interval=1.0)
    ragg = rcluster.TelemetryAggregator(interval=1.0)
    try:
        for view in ("cluster_resources", "cluster_memory"):
            got, want = getattr(agg, view)(), getattr(ragg, view)()
            assert _timeless(got) == _timeless(want) and got["count"] == 0, view
        health = agg.cluster_health()
        assert health["resources"] is None and health["memory"] is None
    finally:
        agg.stop()
        ragg.stop()


# ---------------------------------------------------------------------------
# a world of 4 in-process TelemetryServers of the port
# ---------------------------------------------------------------------------

class Worker:
    """One simulated worker: a port TelemetryServer with its own registry,
    step ring and decision ledger, advanced by `step()`."""

    def __init__(self, rank, rng):
        self.rank, self.rng = rank, rng
        self.reg = metrics.Registry()
        self.store = steptrace.StepStore(keep=16)
        self.ledger = decisions.DecisionLedger(keep=8)
        self.round = 0
        self.srv = TelemetryServer(0, host="127.0.0.1", registry=self.reg, extra_routes={
            "/steptrace": lambda q: (json.dumps(self.store.export(
                self.label, since=_since(q))), "application/json"),
            "/decisions": lambda q: (json.dumps(self.ledger.export(
                self.label, since=_since(q))), "application/json")})
        self.srv.start()
        self.label = f"127.0.0.1:{self.srv.port - 10000}"
        self.url = f"http://127.0.0.1:{self.srv.port}"

    def step(self, labels, n=3):
        """`n` training steps into the registry and one scheduler round
        (two buckets) into the step ring."""
        slow = self.rank == SLOW
        reg = self.reg
        h = reg.histogram("kungfu_step_duration_seconds", "d")
        c = reg.histogram("kungfu_collective_latency_seconds", "c", ("kind",))
        for _ in range(n):
            step_s = 0.3 * (1 + 0.01 * self.rng.normal())
            compute = step_s * (0.9 if slow else 0.3)
            h.observe(step_s)
            c.labels("all_reduce").observe(step_s - compute)
        reg.counter("kungfu_steps_total", "s").inc(n)
        succ = labels[(self.rank + 1) % K]
        for dst in labels:
            if dst != self.label:
                bw = 2e7 if (self.rank, labels.index(dst)) == EDGE else 8e8
                reg.gauge("kungfu_link_bandwidth_bytes_per_second", "b", ("dst",)).labels(
                    dst).set(bw * (1 + 0.01 * self.rng.normal()))
                reg.counter("kungfu_egress_bytes_total", "e", ("peer",)).labels(dst).inc(
                    1 << 20)
        reg.gauge("kungfu_topology_ring_position", "p").set(self.rank)
        reg.gauge("kungfu_topology_ring_next", "n", ("dst",)).labels(succ).set(1)
        reg.counter("kungfu_collective_wire_bytes_total", "w",
                    ("collective", "strategy", "codec")).labels(
            "raw", "RING_SEGMENTED", "off").inc(3 * (1 << 20) * (self.rank + 1))
        self.round += 1
        rec = self.store.begin_step(5, self.round)
        t = time.perf_counter() * 1e6
        for b in range(2):
            lane = rec.bucket(b, "ar", f"grad{b}+40", 1 << 20, 41)
            lane.note_submit(t + 10 * b)
            lane.note_launch(t + 30 + 10 * b)
            walk = 2e5 * (1 + 0.05 * self.rng.random())
            lane.note_walk_span(t + 50 + walk * b, walk)
            if self.rank == EDGE[0]:
                wait, send = 0.05 * walk, 0.9 * walk
            else:
                wait, send = 0.85 * walk, 0.05 * walk
            lane.add_walk("RING_SEGMENTED", walk / 1e6, wait / 1e6, send / 1e6, succ)
            lane.note_unpack(100.0)
        rec.finish(flush_wait_s=0.25, busy_s=0.4)
        if self.round == 2:
            self.ledger.open("async_mode", peer=self.label, trigger="session_epoch",
                             old="off", new="on")
        for _ in range(n):
            self.ledger.note_step(0.3)


def _since(q):
    try:
        return int(q["since"]) if "since" in q else None
    except ValueError:
        return None


class SharedFetch:
    """The aggregators' transport: a real GET, memoized per (url, path)
    until `new_sweep()`, so the second aggregator of a sweep reads the
    bytes the first read; the clock header is dropped (offsets stay 0,
    so merged stamps compare exactly)."""

    def __init__(self):
        self.cache, self.paths = {}, []
        self._lock = threading.Lock()

    def new_sweep(self):
        with self._lock:
            self.cache.clear()

    def __call__(self, base, path, timeout):
        with self._lock:
            self.paths.append(path)
            body = self.cache.get((base, path))
        if body is None:
            with urllib.request.urlopen(base + path, timeout=timeout) as r:
                body = r.read()
            with self._lock:
                self.cache[(base, path)] = body
        return body, {}


@pytest.fixture
def world():
    rng = np.random.default_rng(2024)
    workers = [Worker(r, rng) for r in range(K)]
    yield workers
    for w in workers:
        w.srv.stop()


def _aggs(world, fetch, interval=5.0):
    out = []
    for mod in (cluster, rcluster):
        agg = mod.TelemetryAggregator(interval=interval, timeout=5.0, fetch=fetch)
        agg.set_peers([(w.label, w.url) for w in world])
        out.append(agg)
    return out


def _sweep(world, aggs, fetch, steps=True):
    labels = [w.label for w in world]
    if steps:
        for w in world:
            w.step(labels)
    fetch.new_sweep()
    for agg in aggs:
        agg.scrape_once()


TIMED_PEER_KEYS = ("step_rate", "rtt_ms", "last_scrape_age_s", "clock_offset_us", "error",
                   "stale_endpoints")


def _health(doc):
    d = {k: v for k, v in doc.items() if k not in ("wall_time", "plane", "resources", "memory")}
    d["links"] = {k: v for k, v in doc["links"].items() if k != "oldest_row_age_s"}
    d["peers"] = {p: {k: v for k, v in info.items() if k not in TIMED_PEER_KEYS}
                  for p, info in doc["peers"].items()}
    return d


def _timeless(doc, *keys):
    return {k: v for k, v in doc.items() if k not in ("wall_time", "plane") + keys}


def _metrics_text(text):
    """The federated page without the families that time the scrape."""
    timed = ("kungfu_cluster_step_rate", "kungfu_cluster_scrape_age_seconds",
             "kungfu_aggregator_sweep_seconds", "kungfu_aggregator_payload_bytes_total")
    return "\n".join(line for line in text.splitlines() if not any(t in line for t in timed))


def _events(mod, kinds=("straggler", "straggler_cleared", "step_critical_path",
                        "rtt_outlier")):
    return [(r["kind"], r.get("peer"), r.get("detail")) for r in mod.to_json()
            if r["kind"] in kinds]


def test_both_aggregators_merge_the_same_world_alike(world):
    fetch = SharedFetch()
    mine, theirs = _aggs(world, fetch)
    labels = [w.label for w in world]
    for sweep in range(6):
        _sweep(world, (mine, theirs), fetch)
        assert _health(mine.cluster_health()) == _health(theirs.cluster_health()), sweep
        assert _metrics_text(mine.cluster_metrics()) == _metrics_text(theirs.cluster_metrics())
    health = mine.cluster_health()
    assert health["stragglers"] == [labels[SLOW]]
    # no step election names it: the slowest measured link touching it
    assert health["peers"][labels[SLOW]]["straggler_cause"] == "network"
    assert all(info["error"] is None and info["step_rate"] > 0
               and info["step_time_p50_ms"] <= info["step_time_p99_ms"]
               for info in health["peers"].values())
    # the resource and memory summaries read the same worker documents
    theirs_health = theirs.cluster_health()
    for key in ("resources", "memory"):
        assert health[key] == theirs_health[key], key
        assert sorted(health[key]["peers"]) == sorted(labels), key
    assert _timeless(mine.cluster_resources(), "peers") == \
        _timeless(theirs.cluster_resources(), "peers")
    assert _timeless(mine.cluster_memory(), "peers") == _timeless(theirs.cluster_memory(), "peers")
    assert health["steps"]["critical_peer"] == labels[EDGE[0]]
    assert health["steps"]["critical_edge"] == labels[EDGE[1]]
    steps = mine.cluster_steps()
    assert _timeless(steps) == _timeless(theirs.cluster_steps())
    assert steps["count"] == 5  # the newest round is held back
    assert all((s["critical"]["peer"], s["critical"]["edge"]) == (labels[1], labels[2])
               and 0 <= s["overlap_frac"] <= 1 and 0 <= s["queue_delay_frac"] <= 1
               for s in steps["steps"])
    links = mine.cluster_links()
    assert _timeless(links, "clock_offset_us") == _timeless(theirs.cluster_links(),
                                                             "clock_offset_us")
    assert links["slowest_edge"][:2] == [labels[1], labels[2]]
    assert links["ring"]["order"] == labels
    dec = mine.cluster_decisions()
    assert _timeless(dec) == _timeless(theirs.cluster_decisions())
    assert dec["count"] == K and {d["kind"] for d in dec["decisions"]} == {"async_mode"}
    assert mine.cluster_trace() == theirs.cluster_trace()
    pm = {"kind": "worker_postmortem", "peer": labels[0], "death": "signal SIGKILL (-9)"}
    for agg in (mine, theirs):
        agg.add_postmortem(labels[0], pm)
    assert _timeless(mine.cluster_postmortem()) == _timeless(theirs.cluster_postmortem())
    assert _events(audit) == _events(raudit)
    assert [k for k, _, _ in _events(audit)] == ["straggler", "step_critical_path"]
    # the federated page carries each worker's wire bytes under its peer label
    samples = [s for s in __import__("kungfu_tpu_torch.telemetry.promparse",
                                     fromlist=["x"]).parse_text(mine.cluster_metrics())
               if s.name == "kungfu_collective_wire_bytes_total"]
    assert {dict(s.labels)["peer"]: s.value for s in samples} == {
        w.label: 6 * 3 * (1 << 20) * (w.rank + 1) for w in world}


def test_a_dead_target_is_nulled_alike(world):
    fetch = SharedFetch()
    aggs = _aggs(world, fetch)
    for _ in range(3):
        _sweep(world, aggs, fetch)
    world[SLOW].srv.stop()
    _sweep(world, aggs, fetch)
    got, want = (a.cluster_health() for a in aggs)
    assert _health(got) == _health(want)
    dead = got["peers"][world[SLOW].label]
    assert dead["error"] and dead["step_rate"] is None and dead["straggler"] is False
    assert got["stragglers"] == []
    assert _events(audit) == _events(raudit)
    assert "straggler_cleared" in [k for k, _, _ in _events(audit)]


def test_delta_scrapes_ship_the_same_cursors(world, monkeypatch):
    monkeypatch.setenv("KF_AGG_DELTA", "on")
    fetch = SharedFetch()
    aggs = _aggs(world, fetch)
    for _ in range(5):
        _sweep(world, aggs, fetch)
    assert _timeless(aggs[0].cluster_steps()) == _timeless(aggs[1].cluster_steps())
    assert _timeless(aggs[0].cluster_decisions()) == _timeless(aggs[1].cluster_decisions())
    assert aggs[0].cluster_steps()["count"] == 4
    since = sorted(p for p in fetch.paths if "?since=" in p)
    assert since and all(p.startswith(("/steptrace", "/decisions", "/audit")) for p in since)
    for st0, st1 in zip(sorted(aggs[0].peers(), key=lambda s: s.label),
                        sorted(aggs[1].peers(), key=lambda s: s.label)):
        assert {k: v for k, v in st0.since.items() if k != "/audit"} == \
            {k: v for k, v in st1.since.items() if k not in ("/audit", "/resources", "/memory")}


def test_health_signals_and_monitor_agree(world):
    fetch = SharedFetch()
    mine, theirs = _aggs(world, fetch)
    for _ in range(4):
        _sweep(world, (mine, theirs), fetch)
    assert monitor.cluster_health() == {} and cluster.health_signals() == {}
    cluster.set_aggregator(mine)
    rcluster.set_aggregator(theirs)
    for me in [w.label for w in world] + [""]:
        got = cluster.health_signals(self_peer=me)
        want = rcluster.health_signals(self_peer=me)
        for d in (got, want):
            assert d.pop("cluster/updated_at") is not None
            d.pop("plane/sweep_seconds", None)
        assert got == want
        # the resource and memory planes' cluster-wide elections
        assert "resource/saturated_peers" in got and "memory/min_headroom_peer" in got
    got = monitor.cluster_health()
    assert got == cluster.health_signals() and got["step/critical_edge"] == world[2].label
    assert got["cluster/stragglers"] == [world[SLOW].label]
    assert set(rmonitor.cluster_health()) >= set(got)


# ---------------------------------------------------------------------------
# PolicyRunner, StragglerPolicy and ReplanPolicy's watches
# ---------------------------------------------------------------------------

class FakeSession:
    """The session surface ReplanPolicy reads: peers, size, the hier
    mode, the demoted set, and the two lockstep votes (recorded)."""

    def __init__(self, peers):
        self.peers, self.size, self.replan_mode = peers, len(peers), "hier"
        self.votes = []

    def demoted_peers(self):
        return ()

    def check_replan(self, want, min_gain):
        self.votes.append(("replan", bool(want)))

    def check_demote(self, demote=None, promote=None):
        self.votes.append(("demote", demote, promote))


def test_policy_runners_read_the_same_signals_and_act_alike(world, monkeypatch):
    monkeypatch.setenv("KF_DECISION_WINDOW", "2")
    fetch = SharedFetch()
    mine, theirs = _aggs(world, fetch)
    cluster.set_aggregator(mine)
    rcluster.set_aggregator(theirs)
    labels = [w.label for w in world]
    sessions = (FakeSession(PeerList(PeerID.parse(x) for x in labels)),
                FakeSession(RPeerList([RPeerID.parse(x) for x in labels])))
    runs = []
    for pol, sess in ((policy, sessions[0]), (rpolicy, sessions[1])):
        strag = pol.StragglerPolicy(patience=2)
        replan = pol.ReplanPolicy(interval_steps=1, patience=2, demote_patience=1,
                                  session_supplier=lambda s=sess: s)
        runner = pol.PolicyRunner([strag, replan], batch_size=8)
        runner.CLUSTER_SIGNAL_PERIOD = 0.0
        runs.append(runner)
    seen = [[], []]
    for _ in range(6):
        _sweep(world, (mine, theirs), fetch)
        for i, runner in enumerate(runs):
            with runner.step():
                pass
            m = runner.ctx.metrics
            assert m.get("cluster/updated_at") is not None
            seen[i].append({k: v for k, v in m.items()
                            if k.startswith(("step/", "cluster/", "links/"))
                            and k not in ("cluster/updated_at",)})
    assert seen[0] == seen[1]
    last = seen[0][-1]
    assert last["step/critical_peer"] == labels[1] and last["step/critical_edge"] == labels[2]
    assert last["cluster/straggler_action_pending"] == [labels[SLOW]]
    assert 0 <= last["step/overlap_frac"] <= 1
    assert sessions[0].votes == sessions[1].votes
    assert ("replan", True) in sessions[0].votes
    # the straggler's cause is not measured as compute: no demotion vote
    assert all(v[1] is None for v in sessions[0].votes if v[0] == "demote")


# ---------------------------------------------------------------------------
# scale mode: the host sub-aggregator, the election, sampled links
# ---------------------------------------------------------------------------

ELECTIONS = [
    (["10.0.0.1:100", "10.0.0.1:101", "10.0.0.2:100", "10.0.0.2:101"], "2"),
    (["10.0.0.1:100", "10.0.0.1:101", "10.0.0.2:100"], "2"),
    (["10.0.0.1:100", "10.0.0.1:101", "10.0.0.2:100"], "4"),
    (["10.0.0.1:100", "10.0.0.2:100", "10.0.0.3:100"], "2"),
    (["10.0.0.1:100", "10.0.0.1:101", "10.0.0.1:99"], "0"),
    (["10.0.0.1:100", "10.0.0.1:101", "10.0.0.1:60000"], "2"),
]


@pytest.mark.parametrize("workers,thresh", ELECTIONS)
def test_the_host_role_election_agrees(workers, thresh, monkeypatch):
    monkeypatch.setenv("KF_AGG_HIER_MIN_PEERS", thresh)
    for me in workers:
        roles = []
        for mod, pid in ((cluster, PeerID), (rcluster, RPeerID)):
            mod.update_host_role(pid.parse(me), [pid.parse(w) for w in workers])
            sub = mod.get_host_sub()
            roles.append(None if sub is None else (sub.host, sorted(sub._states)))
            mod.update_host_role(pid.parse(me), [])  # a departure clears the role
            assert mod.get_host_sub() is None
        assert roles[0] == roles[1], me


def test_scale_mode_digests_and_sampled_links_agree(world, monkeypatch):
    monkeypatch.setenv("KF_AGG_HIER_MIN_PEERS", "2")
    monkeypatch.setenv("KF_CLUSTER_SCRAPE_INTERVAL", "0.01")  # every poll refreshes the digest
    peers = [PeerID.parse(w.label) for w in world]
    head = min(world, key=lambda w: w.label)
    cluster.update_host_role(PeerID.parse(head.label), peers)
    assert cluster.get_host_sub() is not None
    body = urllib.request.urlopen(head.url + "/host/telemetry", timeout=10).read()
    digest = json.loads(body)
    assert digest["enabled"] and sorted(digest["workers"]) == sorted(w.label for w in world)
    assert all({"steptrace", "decisions", "parsed", "metrics_text"} <= set(x)
               for x in digest["workers"].values())
    fetch = SharedFetch()
    mine, theirs = _aggs(world, fetch)
    for _ in range(5):
        _sweep(world, (mine, theirs), fetch)
    assert "/host/telemetry" in fetch.paths and "/metrics" not in fetch.paths
    for agg in (mine, theirs):
        assert agg.plane_envelope()["mode"] == "hier"
    assert _health(mine.cluster_health()) == _health(theirs.cluster_health())
    assert _timeless(mine.cluster_steps()) == _timeless(theirs.cluster_steps())
    assert mine.cluster_steps()["count"] >= 3

    def links(doc):
        d = _timeless(doc, "clock_offset_us", "row_age_s", "oldest_row_age_s")
        d["slowest_edges"] = [{k: v for k, v in e.items() if k != "age_s"}
                              for e in d["slowest_edges"]]
        return d

    got = mine.cluster_links()
    assert got["mode"] == "sampled" and links(got) == links(theirs.cluster_links())
    assert got["slowest_edge"][:2] == [world[1].label, world[2].label]


def test_the_overload_backoff_moves_alike(monkeypatch):
    """A target that hangs past the sweep budget doubles the effective
    interval (audited), bounded by KF_AGG_MAX_BACKOFF; sweeps that run
    fast again halve it back."""
    monkeypatch.setenv("KF_AGG_HIER_MIN_PEERS", "2")
    monkeypatch.setenv("KF_AGG_MAX_BACKOFF", "4")
    page = "kungfu_steps_total 1\n"
    hang = {"on": True}

    def fetch(base, path, timeout):
        if base.endswith(":9003") and hang["on"] and path == "/metrics":
            time.sleep(0.6)  # past the scale-mode sweep budget, max(interval, 0.5 s)
            raise OSError("hung")
        if path.startswith("/metrics"):
            return page.encode(), {}
        return json.dumps({"timelines": [], "decisions": []}).encode(), {}

    seqs = []
    for mod in (cluster, rcluster):
        hang["on"] = True
        agg = mod.TelemetryAggregator(interval=0.5, timeout=2.0, fetch=fetch)
        agg.set_peers([(f"h{i}:{9000 + i}", f"http://h{i}:{9000 + i}") for i in range(4)])
        seq = []
        for sweep in range(6):
            if sweep == 3:
                hang["on"] = False
            time.sleep(0.15)  # the last sweep's hung fetch lands; it is not in flight
            agg.scrape_once()
            seq.append(agg.effective_interval())
        seqs.append(seq)
    assert seqs[0] == seqs[1] == [1.0, 2.0, 2.0, 1.0, 0.5, 0.5]
    assert [r["kind"] for r in audit.to_json()] == [r["kind"] for r in raudit.to_json()] == \
        ["aggregator_overload", "aggregator_overload"]

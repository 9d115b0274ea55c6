"""The port's link table (`kungfu_tpu_torch/telemetry/link.py`) and the
walk profiler's efficiency ratio it feeds, against the JAX package's
(`kungfu_tpu/telemetry/link.py`); mirrors tests/test_link_plane.py.

- Seeded (dst, bytes, seconds) send and ping streams into one table of
  each package: the same estimates, rows, signals, slowest links and
  prunes, and a byte-equal `kungfu_link_*` exposition.
- The peer cap's drops, `merge_matrix` on seeded rows, the metrics gate.
- Live port worlds with metrics on: the session's walks feed the table
  through the client, the profiler publishes
  `kungfu_collective_efficiency_ratio`, `measured_matrix` exchanges
  every row, and a new peer list prunes departed destinations.
In process."""

import random

import numpy as np
import pytest
import torch

from kungfu_tpu.telemetry import link as rlink
from kungfu_tpu.telemetry import metrics as rmetrics
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.collective.host_session import HostSession
from kungfu_tpu_torch.telemetry import config, link, metrics
from test_torch_port_telemetry import clean_telemetry  # noqa: F401
from test_torch_port_worlds import make_world, new_epoch, run_all, small_arenas  # noqa: F401
from test_torch_port_zero import close_all, sessions

DSTS = ["127.0.0.1:10001", "127.0.0.1:10002", "10.0.0.7:5", "h:1", 'q"uo:2']


def _stream(seed):
    rng = random.Random(seed)
    out = []
    for _ in range(rng.randint(20, 80)):
        kind = rng.random()
        dst = rng.choice(DSTS)
        if kind < 0.15:
            out.append(("lat", dst, rng.choice([0.0, -1.0, 1e-4, 0.003, 0.2])))
        elif kind < 0.2:
            out.append(("prune", rng.sample(DSTS, rng.randint(0, 4)), None))
        else:
            out.append(("send", dst, (rng.choice([0, 100, 65535, 65536, 1 << 20, 9 << 20]),
                                      rng.choice([0.0, 1e-5, 0.001, 0.05, 1.3]))))
    return out


def _drive(table, stream):
    for kind, dst, arg in stream:
        if kind == "send":
            table.observe_send(dst, *arg)
        elif kind == "lat":
            table.observe_latency(dst, arg)
        else:
            table.prune(dst)


@pytest.mark.parametrize("alpha,min_bytes,max_peers", [(0.2, 64 << 10, 256), (0.5, 1, 3),
                                                       (1.0, 1 << 20, 2)])
@pytest.mark.parametrize("seed", range(6))
def test_seeded_streams_give_the_same_tables(seed, alpha, min_bytes, max_peers):
    reg, rreg = metrics.Registry(), rmetrics.Registry()
    mine = link.LinkTable(registry=reg, alpha=alpha, max_peers=max_peers, bw_min_bytes=min_bytes)
    theirs = rlink.LinkTable(registry=rreg, alpha=alpha, max_peers=max_peers,
                             bw_min_bytes=min_bytes)
    stream = _stream(seed)
    for i in range(0, len(stream), 7):
        _drive(mine, stream[i:i + 7])
        _drive(theirs, stream[i:i + 7])
        assert mine.row() == theirs.row()
        assert mine.signals() == theirs.signals()
        assert mine.min_bandwidth() == theirs.min_bandwidth()
        assert mine.min_bandwidth(DSTS[:2]) == theirs.min_bandwidth(DSTS[:2])
        for d in DSTS:
            assert mine.bandwidth(d) == theirs.bandwidth(d)
            assert mine.latency(d) == theirs.latency(d)
        # the kungfu_link_* families, byte for byte (drops included)
        assert reg.render() == rreg.render()


def test_the_families_are_the_references():
    reg, rreg = metrics.Registry(), rmetrics.Registry()
    mine, theirs = link.LinkTable(registry=reg), rlink.LinkTable(registry=rreg)
    for t in (mine, theirs):
        t.observe_send("a:1", 1 << 20, 0.01)
        t.observe_latency("a:1", 0.002)
    text = reg.render()
    for fam in ("kungfu_link_tx_bytes_total", "kungfu_link_tx_messages_total",
                "kungfu_link_bandwidth_bytes_per_second", "kungfu_link_latency_seconds"):
        assert f"# TYPE {fam}" in text
    assert text == rreg.render()


@pytest.mark.parametrize("seed", range(8))
def test_merge_matrix_is_the_references(seed):
    rng = random.Random(seed)
    peers = [f"p{i}:1" for i in range(rng.randint(1, 6))]
    rows = {}
    for src in peers:
        if rng.random() < 0.2:
            rows[src] = {}
            continue
        rows[src] = {dst: {"bw": rng.choice([None, 0, -1.0, 1e6, 3.5e8, rng.random() * 1e9]),
                           "latency_s": rng.choice([None, 0.001]), "tx_bytes": rng.randint(0, 9),
                           "tx_messages": 1, "bw_samples": 1}
                     for dst in peers + ["extra:9"] if dst != src and rng.random() < 0.7}
    for copy_edges in (True, False):
        assert link.merge_matrix(rows, copy_edges) == rlink.merge_matrix(rows, copy_edges)


def test_the_table_rides_the_metrics_gate(monkeypatch):
    assert not link.enabled()
    monkeypatch.setenv("KF_TELEMETRY", "metrics")
    config.refresh(None)
    assert link.enabled() == rlink.enabled() is True
    t = link.get_table()
    assert link.get_table() is t
    t.observe_send("x:1", 1 << 20, 0.5)
    assert 'kungfu_link_bandwidth_bytes_per_second{dst="x:1"} 2097152' in metrics.render()


def test_clear_and_prune_drop_the_series():
    reg = metrics.Registry()
    t = link.LinkTable(registry=reg)
    t.observe_send("a:1", 1 << 20, 0.1)
    t.observe_send("b:2", 1 << 20, 0.2)
    t.prune(["a:1"])
    assert set(t.row()) == {"a:1"} and 'dst="b:2"' not in reg.render()
    t.clear()
    assert t.row() == {} and t.signals() == {}


# ---------------------------------------------------------------------------
# live worlds: the transport feeds the table, the profiler scores against it
# ---------------------------------------------------------------------------

@pytest.fixture
def metered_world(monkeypatch):
    monkeypatch.setenv("KF_TELEMETRY", "metrics")
    monkeypatch.setenv("KF_CONFIG_SHM", "0")
    config.refresh(None)
    world = make_world(["port"] * 3)
    yield world
    for p in world:
        p.stop()


def test_walks_feed_the_table_and_the_efficiency_ratio(metered_world, monkeypatch):
    monkeypatch.setattr(HostSession, "SEGMENT_MIN_BYTES", 0)
    ss = sessions(metered_world)
    n = 200_000
    try:
        run_all([lambda r=r, s=s: [s.all_reduce(Workspace(
            send=torch.full((n,), float(r)), recv=torch.empty(n), op=ReduceOp.SUM,
            name=f"lk:{i}")) for i in range(3)] for r, s in enumerate(ss)])
        table = link.get_table()
        row = table.row()
        # one process: every client feeds the same table, and each rank's
        # ring successor got segments of n/3 floats, above the sample floor
        for q in metered_world:
            assert row[str(q.self_id)]["bw_samples"] >= 1
        text = metrics.render()
        assert "kungfu_collective_efficiency_ratio{" in text
        assert 'strategy="RING_SEGMENTED"' in text
        # the exchanged matrix: each rank's row, identical everywhere
        mats = {}
        run_all([lambda r=r, s=s: mats.__setitem__(r, s.measured_matrix())
                 for r, s in enumerate(ss)])
        assert all(np.array_equal(mats[0], m) for m in mats.values())
        assert (np.diag(mats[0]) == 0).all() and (mats[0] > 0).sum() >= 3
        assert all(s._replan_seq == 0 for s in ss)
    finally:
        close_all(ss)


def test_a_new_peer_list_prunes_departed_destinations(metered_world):
    table = link.get_table()
    gone = "10.9.9.9:1"
    table.observe_send(gone, 1 << 20, 0.1)
    # the next epoch (the in-process stand-in for a resize that shed the
    # peer): the departed estimate is dropped, the members' stay
    new_epoch(metered_world)
    assert gone not in table.row()

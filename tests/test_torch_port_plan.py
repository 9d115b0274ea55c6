"""The port's `plan/` and `collective/strategies.py` against the JAX
package's: parsing, JSON, digests, every topology generator, the
segmented schedule, the MST (the port's C++ against its plain twin and
the reference), the re-planner's plans and digests, and the strategy
lists, byte for byte on the same seeded inputs. Pure planning, in
process."""

import numpy as np
import pytest
import torch

import chip_smoke
from kungfu_tpu.base.strategy import Strategy as RStrategy
from kungfu_tpu.collective import strategies as rstrat
from kungfu_tpu.plan import cluster as rcluster
from kungfu_tpu.plan import hostspec as rhost
from kungfu_tpu.plan import mst as rmst
from kungfu_tpu.plan import peer as rpeer
from kungfu_tpu.plan import replan as rrp
from kungfu_tpu.plan import topology as rtopo
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.strategy import DEFAULT_STRATEGY, Strategy
from kungfu_tpu_torch.collective import strategies as strat
from kungfu_tpu_torch.plan import cluster, hostspec, mst, peer, replan as rp, topology as topo
from kungfu_tpu_torch.plan.graph import Graph

# hosts per layout: one host of n for n = 1..9, and multi-host layouts
LAYOUTS = [[n] for n in range(1, 10)] + [[2, 2], [3, 1, 2], [1, 1, 1, 1], [4, 4], [1, 3],
                                        [2, 2, 2, 2, 1]]


def _peers(mod, layout):
    return mod.PeerList(mod.PeerID(f"10.0.0.{h}", 38000 + s)
                        for h, n in enumerate(layout) for s in range(n))


# ---------------------------------------------------------------------------
# peers, hosts, clusters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("specs", ["127.0.0.1:38000", "a:1,b:2,a:3,c:4,b:5",
                                   "node-0.pod:38000,node-1.pod:38000,node-0.pod:38001",
                                   "[::1]:9,[::1]:10", ""])
def test_peer_lists_match_reference(specs):
    p, r = peer.PeerList.parse(specs), rpeer.PeerList.parse(specs)
    assert p.to_bytes() == r.to_bytes() and p.digest() == r.digest()
    assert p.to_json() == r.to_json() and repr(p) == repr(r)
    assert peer.PeerList.from_json(p.to_json()) == p
    assert p.hosts() == r.hosts() and p.host_count() == r.host_count()
    assert p.partition_by_host() == r.partition_by_host()
    for q, rq in zip(p, r):
        assert str(q) == str(rq) and p.rank(q) == r.rank(rq)
        assert p.local_rank(q) == r.local_rank(rq) and p.local_size(q) == r.local_size(rq)
        assert p.others(q).to_bytes() == r.others(rq).to_bytes()
    half = p.select(range(0, len(p), 2))
    a, b = p.diff(half)
    ra, rb = r.diff(r.select(range(0, len(r), 2)))
    assert (a.to_bytes(), b.to_bytes()) == (ra.to_bytes(), rb.to_bytes())
    assert p.intersection(half) == half and (len(p) == 0 or not p.disjoint(half))


@pytest.mark.parametrize("bad", ["host", "host:", ":38000", "host:x1", "a:1,,b:2"])
def test_bad_peer_specs_raise_as_in_reference(bad):
    with pytest.raises(ValueError):
        rpeer.PeerList.parse(bad)
    with pytest.raises(ValueError, match="invalid peer spec"):
        peer.PeerList.parse(bad)


def test_host_lists_match_reference():
    text = "# hosts\nnode-a slots=4 public=1.2.3.4\nnode-b slots=2\n\nnode-c  # one slot\n"
    h, r = hostspec.parse_hostfile(text), rhost.parse_hostfile(text)
    assert [str(s) for s in h] == [str(s) for s in r] and h.total_slots == r.total_slots == 7
    for np_ in (1, 4, 5, 7):
        assert h.gen_peer_list(np_).digest() == r.gen_peer_list(np_).digest()
    assert h.gen_runner_list(38080).to_bytes() == r.gen_runner_list(38080).to_bytes()
    assert hostspec.DEFAULT_PORT_RANGE == rhost.DEFAULT_PORT_RANGE
    spec = "10.0.0.1:3:pub,10.0.0.2,10.0.0.3:2"
    assert [str(s) for s in hostspec.HostList.parse(spec)] == [
        str(s) for s in rhost.HostList.parse(spec)]
    with pytest.raises(ValueError):
        h.gen_peer_list(8)
    for bad in ("a:x", "a:1:p:q", ":1"):
        with pytest.raises(ValueError):
            hostspec.HostSpec.parse(bad)
    with pytest.raises(ValueError):
        hostspec.parse_hostfile("a slots=2 bogus=1")


def test_clusters_match_reference():
    def both(mod_c, mod_p):
        runners = mod_p.PeerList.parse("10.0.0.1:38080,10.0.0.2:38080")
        workers = mod_p.PeerList.parse("10.0.0.1:38000,10.0.0.1:38001,10.0.0.2:38000")
        return mod_c.Cluster(runners, workers)

    c, r = both(cluster, peer), both(rcluster, rpeer)
    c.validate()
    assert c.to_bytes() == r.to_bytes() and c.digest() == r.digest()
    assert c.dumps() == r.dumps() and c.debug_string() == r.debug_string()
    assert cluster.Cluster.loads(c.dumps()).digest() == c.digest()
    for size in (0, 1, 3, 5, 8):
        assert c.resize(size).digest() == r.resize(size).digest()
    bad = cluster.Cluster(c.runners, peer.PeerList.parse("10.0.0.9:38000"))
    with pytest.raises(cluster.ClusterError, match="no runner"):
        bad.validate()
    with pytest.raises(cluster.ClusterError, match="duplicated"):
        cluster.Cluster(peer.PeerList.parse("10.0.0.1:1,10.0.0.1:2"), peer.PeerList()).validate()


# ---------------------------------------------------------------------------
# graphs and topologies
# ---------------------------------------------------------------------------

def _same(g, rg) -> None:
    assert g.digest() == rg.digest() and g.debug_string() == rg.debug_string()


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_every_topology_generator_matches_reference(layout):
    p, r = _peers(peer, layout), _peers(rpeer, layout)
    n = len(p)
    for name in ("gen_tree", "gen_binary_tree_star", "gen_multi_star"):
        _same(getattr(topo, name)(p), getattr(rtopo, name)(r))
        _same(topo.gen_default_reduce_graph(getattr(topo, name)(p)),
              rtopo.gen_default_reduce_graph(getattr(rtopo, name)(r)))
    for name in ("gen_multi_stars", "gen_multi_binary_tree_star"):
        for g, rg in zip(getattr(topo, name)(p), getattr(rtopo, name)(r), strict=True):
            _same(g, rg)
    masters, _ = p.partition_by_host()
    for root in range(n):
        _same(topo.gen_star_bcast_graph(n, root), rtopo.gen_star_bcast_graph(n, root))
        _same(topo.gen_binary_tree(n, root), rtopo.gen_binary_tree(n, root))
        for g, rg in zip(topo.gen_circular_graph_pair(n, root),
                         rtopo.gen_circular_graph_pair(n, root)):
            _same(g, rg)
    for r_ in range(len(masters)):
        for g, rg in zip(topo.gen_subset_circular_graph_pair(n, masters, r_),
                         rtopo.gen_subset_circular_graph_pair(n, masters, r_)):
            _same(g, rg)
    _same(topo.gen_subset_binary_tree(n, masters), rtopo.gen_subset_binary_tree(n, masters))


def test_forest_arrays_match_reference():
    from kungfu_tpu.plan.graph import Graph as RGraph

    for fathers in ([0], [0, 0, 1, 1], [1, 1, 1], [0, 2, 1], [0, 5], [-1, 0], [2, 0, 2, 2]):
        g, roots, ok = Graph.from_forest_array(fathers)
        rg, rroots, rok = RGraph.from_forest_array(fathers)
        assert (roots, ok) == (rroots, rok)
        if ok:
            _same(g, rg)
            _same(g.reverse(), rg.reverse())


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8])
def test_segmented_schedules_match_reference(k):
    ranks = list(range(k))[::-1] if k > 2 else list(range(k))
    for i in range(k):
        s, rs = topo.gen_segmented_schedule(ranks, i), rtopo.gen_segmented_schedule(ranks, i)
        assert (s.rs_steps, s.ag_steps, s.send_peer, s.recv_peer, s.owned_segment) == (
            rs.rs_steps, rs.ag_steps, rs.send_peer, rs.recv_peer, rs.owned_segment)
    weights = [1.0 + (i % 3) for i in range(k)]
    for count in (0, k - 1, 1000, 25_557_032):
        assert topo.segment_bounds(count, k) == rtopo.segment_bounds(count, k)
        assert topo.segment_bounds(count, k, weights) == rtopo.segment_bounds(count, k, weights)
        for i in range(k):
            assert topo.owned_segment_bounds(count, k, i, ranks, weights) == \
                rtopo.owned_segment_bounds(count, k, i, ranks, weights)
    with pytest.raises(ValueError):
        topo.gen_segmented_schedule(ranks, k)
    with pytest.raises(ValueError):
        topo.segment_bounds(10, k, [1.0] * (k + 1))


# ---------------------------------------------------------------------------
# MST and re-planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 5, 8, 13])
def test_mst_cpp_matches_plain_and_reference(n):
    rng = np.random.default_rng(n)
    w = rng.uniform(0.1, 10.0, (n, n))
    w = (w + w.T) / 2
    w[0, n - 1] = w[n - 1, 0] = w.min()  # a tie with a strict-less update
    got = mst.minimum_spanning_tree(w)
    assert got == mst._mst_numpy(w).tolist() == rmst._mst_numpy(w).tolist()
    assert got == rmst.minimum_spanning_tree(w)
    g, roots, ok = Graph.from_forest_array(got)
    assert ok and roots == 1


def test_mst_edge_cases():
    assert mst.minimum_spanning_tree(np.zeros((0, 0))) == []
    assert mst.minimum_spanning_tree([[0.0]]) == [0]
    inf = float("inf")
    with pytest.raises(ValueError, match="disconnected"):
        mst.minimum_spanning_tree([[0, inf, 1], [inf, 0, inf], [1, inf, 0]])
    with pytest.raises(ValueError, match="square"):
        mst.minimum_spanning_tree([[0, 1, 2]])


def _matrix(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = 2 + seed % 8
    m = rng.uniform(1e8, 1e10, (k, k))
    if seed % 3 == 0:
        m[rng.integers(0, k), rng.integers(0, k)] = 0.0  # an unmeasured edge
    if seed % 4 == 1:
        m[:, 0] = m[0, :] = 5e7  # a slow peer
    np.fill_diagonal(m, 0.0)
    return m


@pytest.mark.parametrize("seed", range(10))
def test_replan_matches_reference(seed):
    m = _matrix(seed)
    k = m.shape[0]
    assert rp.ring_order(m) == rrp.ring_order(m)
    assert rp.peer_throughput_weights(m) == rrp.peer_throughput_weights(m)
    assert rp.weighted_partition(1001, list(range(1, k + 1))) == \
        rrp.weighted_partition(1001, list(range(1, k + 1)))
    for mode in ("off", "ring", "ring+segments", "auto"):
        for cf in (0.0, 0.3, 1.0):
            plan, rplan = rp.derive_plan(m, mode, compute_frac=cf), \
                rrp.derive_plan(m, mode, compute_frac=cf)
            assert rp.plan_digest(plan) == rrp.plan_digest(rplan)
            assert (plan is None) == (rplan is None)
            if plan is not None:
                assert plan.to_bytes() == rplan.to_bytes() and plan.describe() == rplan.describe()
                again = rp.derive_plan(m.copy(), mode, current=plan, compute_frac=cf)
                assert again is None  # the same matrix re-derives the adopted plan
    with pytest.raises(ValueError):
        rp.derive_plan(m, "bogus")


@pytest.mark.parametrize("hosts", [[[0, 1], [2, 3]], [[0, 1, 2], [3, 4, 5], [6, 7]],
                                   [[0], [1, 2, 3, 4]]], ids=str)
def test_hier_plans_match_reference(hosts):
    k = sum(len(h) for h in hosts)
    rng = np.random.default_rng(k)
    m = rng.uniform(1e8, 2e8, (k, k))
    for h in hosts:
        for i in h:
            for j in h:
                m[i, j] = rng.uniform(5e9, 8e9)  # fast links inside a host
    np.fill_diagonal(m, 0.0)
    assert rp.cluster_hosts(m) == rrp.cluster_hosts(m)
    for demoted in ((), (hosts[-1][-1],)):
        plan = rp.derive_hier_plan(m, hosts, demoted=demoted, compute_frac=0.25)
        rplan = rrp.derive_hier_plan(m, hosts, demoted=demoted, compute_frac=0.25)
        assert rp.plan_digest(plan) == rrp.plan_digest(rplan)
        if plan is not None:
            assert plan.to_bytes() == rplan.to_bytes()
            assert plan.as_ring_plan().to_bytes() == rplan.as_ring_plan().to_bytes()
            assert plan.describe() == rplan.describe() and plan.active() == rplan.active()
    assert rp.plan_digest(None) == rrp.plan_digest(None) == b"naive-ring"


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", [[1], [2], [3], [4], [7], [2, 2], [3, 1, 2], [4, 4]], ids=str)
def test_strategy_lists_match_reference_and_sum(layout):
    """Every Strategy's graph pairs: digests byte-equal to the reference's,
    and each pair, replayed with the host C++, leaves every peer the sum."""
    p, r = _peers(peer, layout), _peers(rpeer, layout)
    n = len(p)
    sends = [torch.full((5,), float(10 ** i)) for i in range(n)]
    want = torch.full((5,), float(sum(10 ** i for i in range(n))))
    ops = chip_smoke.host_ops()
    for s in Strategy:
        sl, rsl = strat.gen_global_strategies(p, s), rstrat.gen_global_strategies(r, RStrategy(s))
        assert strat.digest(sl) == rstrat.digest(rsl)
        assert [pair.digest() for pair in sl] == [pair.digest() for pair in rsl]
        for i in range(2 * len(sl)):
            assert strat.choose(sl, i).digest() == rstrat.choose(rsl, i).digest()
        if n > 1:
            for pair in sl:
                out = chip_smoke.graph_replay(sends, pair, ops)
                assert all(torch.equal(o, want) for o in out), (s.name, pair)
    assert strat.auto_select(p) == rstrat.auto_select(r)
    assert strat.digest(strat.gen_local_strategies(p)) == \
        rstrat.digest(rstrat.gen_local_strategies(r))
    for s in (Strategy.RING, Strategy.BINARY_TREE):
        assert strat.digest(strat.gen_cross_strategies(p, s)) == \
            rstrat.digest(rstrat.gen_cross_strategies(r, RStrategy(s)))
    _, master_of = p.partition_by_host()
    assert strat.digest(strat.from_forest_array(master_of)) == \
        rstrat.digest(rstrat.from_forest_array(master_of))


def test_strategy_names_and_default_match_reference():
    assert [(s.name, int(s)) for s in Strategy] == [(s.name, int(s)) for s in RStrategy]
    assert DEFAULT_STRATEGY.name == "BINARY_TREE_STAR"
    for name in ("ring", "binary-tree-star", " AUTO ", "ring_segmented"):
        assert Strategy.parse(name).name == RStrategy.parse(name).name
    with pytest.raises(ValueError, match="unknown strategy"):
        Strategy.parse("bogus")
    with pytest.raises(ValueError, match="invalid forest"):
        strat.from_forest_array([1, 0])
    assert strat.effective_cpu_count() == rstrat.effective_cpu_count() >= 1
    assert ReduceOp.SUM == 0

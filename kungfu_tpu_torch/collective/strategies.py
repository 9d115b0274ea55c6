"""Strategy lists: (reduce, bcast) graph pairs per Strategy enum.

Port of `kungfu_tpu/collective/strategies.py` (parity:
srcs/go/kungfu/session/strategy.go:58-210) — a strategy is a
(reduceGraph, bcastGraph) pair; multi-root strategies (RING, CLIQUE,
MULTI_STAR, MULTI_BINARY_TREE_STAR) return one pair per root so chunked
collectives can stripe chunks across roots; AUTO picks from the topology
(`auto_select`). Pure planning: its digests are byte-equal to the
reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List

from kungfu_tpu_torch.base.strategy import Strategy
from kungfu_tpu_torch.plan.graph import Graph
from kungfu_tpu_torch.plan.peer import PeerList
from kungfu_tpu_torch.plan import topology as topo


@dataclasses.dataclass
class StrategyPair:
    reduce_graph: Graph
    bcast_graph: Graph

    @classmethod
    def from_bcast(cls, bcast: Graph) -> "StrategyPair":
        return cls(topo.gen_default_reduce_graph(bcast), bcast)

    def digest(self) -> bytes:
        return self.reduce_graph.digest() + self.bcast_graph.digest()


StrategyList = List[StrategyPair]


def digest(sl: StrategyList) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for s in sl:
        h.update(s.digest())
    return h.digest()


def choose(sl: StrategyList, i: int) -> StrategyPair:
    return sl[i % len(sl)]


# cgroup CPU-limit files; module constants so tests can point them at
# fixtures. v2 first (the unified hierarchy every modern container
# runtime mounts), v1 cfs_quota as fallback.
CGROUP_V2_CPU_MAX = "/sys/fs/cgroup/cpu.max"
CGROUP_V1_QUOTA = "/sys/fs/cgroup/cpu/cpu.cfs_quota_us"
CGROUP_V1_PERIOD = "/sys/fs/cgroup/cpu/cpu.cfs_period_us"


def _cgroup_cpu_quota() -> float:
    """CPU quota in cores from the cgroup limit, or 0.0 when unlimited
    or unreadable. v2: ``cpu.max`` is "<quota> <period>" or "max ...";
    v1: cfs_quota_us / cfs_period_us, quota -1 meaning unlimited."""
    try:
        with open(CGROUP_V2_CPU_MAX) as f:
            quota_s, _, period_s = f.read().strip().partition(" ")
        if quota_s != "max":
            quota = float(quota_s) / float(period_s or 100000)
            if quota > 0:
                return quota
    except (OSError, ValueError, ZeroDivisionError):
        pass
    try:
        with open(CGROUP_V1_QUOTA) as f:
            quota_us = int(f.read().strip())
        if quota_us > 0:
            with open(CGROUP_V1_PERIOD) as f:
                period_us = int(f.read().strip())
            if period_us > 0:
                return quota_us / period_us
    except (OSError, ValueError):
        pass
    return 0.0


def effective_cpu_count() -> int:
    """Cores this process can actually burn: os.cpu_count() capped by
    the affinity mask AND the cgroup CPU quota. In a CPU-quota'd
    container os.cpu_count() reports the host's cores — phantom
    parallelism that made auto_select pick k concurrent root walks on
    what is effectively a 1-core box."""
    cores = os.cpu_count() or 1
    if hasattr(os, "sched_getaffinity"):
        try:
            cores = min(cores, len(os.sched_getaffinity(0)))
        except OSError:
            pass
    quota = _cgroup_cpu_quota()
    if quota > 0:
        cores = min(cores, int(quota))
    return max(1, cores)


def auto_select(peers: PeerList) -> Strategy:
    """Single host, k >= 4: RING_SEGMENTED — the bandwidth-optimal
    segmented reduce-scatter/all-gather moves only 2*(k-1)/k of the
    payload per peer (tree/star roots carry ~2*(k-1)x), and its walk is
    sequential per peer so it needs no spare cores for concurrent chunk
    walks (unlike CLIQUE striping, which loses on 1-2 core hosts).
    k == 3: segmented saves little (2/3 vs full relays through a 3-node
    tree are close) and costs 4 serialized latency steps, so keep the
    old striping-vs-tree core-count choice. k <= 2: STAR (one hop).
    Pair 0 of every generated list stays rank-0-rooted, preserving the
    gather/broadcast root contract. Multi-host: one binary-tree-star per
    host master (striping across hosts; the hierarchical path owns the
    cross-host segmented variant)."""
    if peers.host_count() == 1:
        if len(peers) <= 2:
            return Strategy.STAR
        if len(peers) >= 4:
            return Strategy.RING_SEGMENTED
        return (
            Strategy.CLIQUE
            if effective_cpu_count() >= 4
            else Strategy.BINARY_TREE
        )
    return Strategy.MULTI_BINARY_TREE_STAR


def _star(peers: PeerList) -> StrategyList:
    return [StrategyPair.from_bcast(topo.gen_star_bcast_graph(len(peers), 0))]


def _multi_star(peers: PeerList) -> StrategyList:
    return [StrategyPair.from_bcast(g) for g in topo.gen_multi_stars(peers)]


def _clique(peers: PeerList) -> StrategyList:
    k = len(peers)
    return [StrategyPair.from_bcast(topo.gen_star_bcast_graph(k, r)) for r in range(k)]


def _ring(peers: PeerList) -> StrategyList:
    k = len(peers)
    return [StrategyPair(*topo.gen_circular_graph_pair(k, r)) for r in range(k)]


def _tree(peers: PeerList) -> StrategyList:
    return [StrategyPair.from_bcast(topo.gen_tree(peers))]


def _binary_tree(peers: PeerList) -> StrategyList:
    return [StrategyPair.from_bcast(topo.gen_binary_tree(len(peers)))]


def _binary_tree_star(peers: PeerList) -> StrategyList:
    return [StrategyPair.from_bcast(topo.gen_binary_tree_star(peers))]


def _multi_binary_tree_star(peers: PeerList) -> StrategyList:
    return [StrategyPair.from_bcast(g) for g in topo.gen_multi_binary_tree_star(peers)]


_GENERATORS = {
    Strategy.STAR: _star,
    Strategy.MULTI_STAR: _multi_star,
    Strategy.CLIQUE: _clique,
    Strategy.RING: _ring,
    Strategy.TREE: _tree,
    Strategy.BINARY_TREE: _binary_tree,
    Strategy.BINARY_TREE_STAR: _binary_tree_star,
    Strategy.MULTI_BINARY_TREE_STAR: _multi_binary_tree_star,
    # RING_SEGMENTED's allreduce runs the engine's dedicated segmented
    # walk, not these graphs. The pair here backs the RESIDUAL graph
    # consumers — reduce/broadcast/gather and allreduce payloads below
    # the segmented walk's minimum size — with a rank-0 binary tree:
    # latency-optimal for the small control collectives that hit it.
    Strategy.RING_SEGMENTED: _binary_tree,
}


def gen_global_strategies(peers: PeerList, strategy: Strategy) -> StrategyList:
    if strategy == Strategy.AUTO:
        strategy = auto_select(peers)
    return _GENERATORS[strategy](peers)


def gen_local_strategies(peers: PeerList) -> StrategyList:
    """Intra-host forest: each host master broadcasts to colocated peers."""
    masters, master_of = peers.partition_by_host()
    bcast, roots, ok = Graph.from_forest_array(master_of)
    if not ok or roots != len(masters):
        raise ValueError(f"invalid host partition forest: {master_of}")
    return [StrategyPair.from_bcast(bcast)]


def gen_cross_strategies(peers: PeerList, strategy: Strategy) -> StrategyList:
    """Inter-host strategies over host masters only (hierarchical allreduce)."""
    n = len(peers)
    masters, _ = peers.partition_by_host()
    if strategy == Strategy.RING:
        return [
            StrategyPair(*topo.gen_subset_circular_graph_pair(n, masters, r))
            for r in range(len(masters))
        ]
    return [StrategyPair.from_bcast(topo.gen_subset_binary_tree(n, masters))]


def from_forest_array(fathers: List[int]) -> StrategyList:
    """Strategy from a runtime-supplied father array (SubsetAllReduce /
    AllReduceWith / set_tree; session/allreduce.go:14-44)."""
    bcast, _, ok = Graph.from_forest_array(fathers)
    if not ok:
        raise ValueError(f"invalid forest array: {fathers}")
    return [StrategyPair.from_bcast(bcast)]

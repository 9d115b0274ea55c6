"""Topology generators: broadcast/reduce graph pairs over a PeerList, and
the segmented ring's schedule.

Port of `kungfu_tpu/plan/topology.py` (parity: srcs/go/plan/
topology.go:17-160 and srcs/go/plan/subgraph/subgraph.go). Each generator
returns broadcast graphs (edges flow root -> leaves); the matching reduce
graph is the reversal with self-loops on every node
(gen_default_reduce_graph). Host-locality-aware shapes (tree/star within
a host, another shape across host masters) map the network: intra-host
edges are loopback, inter-host edges cross it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from kungfu_tpu_torch.plan.graph import Graph
from kungfu_tpu_torch.plan.peer import PeerList


def gen_default_reduce_graph(bcast: Graph) -> Graph:
    """Reverse the broadcast graph and self-loop every node (accumulate)."""
    g = bcast.reverse()
    for i in range(g.n):
        g.add_edge(i, i)
    return g


def gen_star_bcast_graph(k: int, root: int = 0) -> Graph:
    g = Graph(k)
    for i in range(k):
        if i != root:
            g.add_edge(root, i)
    return g


def gen_binary_tree(k: int, root_offset: int = 0) -> Graph:
    """Heap-layout binary tree over ranks (i -> 2i+1, 2i+2), rotated by offset."""
    g = Graph(k)
    idx = lambda i: (i + root_offset) % k
    for i in range(k):
        for j in (2 * i + 1, 2 * i + 2):
            if j < k:
                g.add_edge(idx(i), idx(j))
    return g


def gen_tree(peers: PeerList) -> Graph:
    """Two-level tree: host masters star out to local peers; master[0] to other masters."""
    g = Graph(len(peers))
    masters, master_of = peers.partition_by_host()
    for rank in range(len(peers)):
        if master_of[rank] != rank:
            g.add_edge(master_of[rank], rank)
    for m in masters[1:]:
        g.add_edge(masters[0], m)
    return g


def gen_multi_star(peers: PeerList, root_idx: int = 0) -> Graph:
    """Intra-host stars + star over masters centered at masters[root_idx]."""
    g = Graph(len(peers))
    masters, master_of = peers.partition_by_host()
    for rank in range(len(peers)):
        if master_of[rank] != rank:
            g.add_edge(master_of[rank], rank)
    if len(masters) > 1:
        for i, m in enumerate(masters):
            if i != root_idx:
                g.add_edge(masters[root_idx], m)
    return g


def gen_multi_stars(peers: PeerList) -> List[Graph]:
    masters, _ = peers.partition_by_host()
    return [gen_multi_star(peers, i) for i in range(len(masters))]


def gen_binary_tree_star(peers: PeerList, offset: int = 0) -> Graph:
    """Intra-host stars + binary tree over host masters (rotated by offset)."""
    g = Graph(len(peers))
    masters, master_of = peers.partition_by_host()
    for rank in range(len(peers)):
        if master_of[rank] != rank:
            g.add_edge(master_of[rank], rank)
    k = len(masters)
    if k > 1:
        idx = lambda i: (i + offset) % k
        for i in range(k):
            for j in (2 * i + 1, 2 * i + 2):
                if j < k:
                    g.add_edge(masters[idx(i)], masters[idx(j)])
    return g


def gen_multi_binary_tree_star(peers: PeerList) -> List[Graph]:
    masters, _ = peers.partition_by_host()
    return [gen_binary_tree_star(peers, i) for i in range(len(masters))]


def gen_circular_graph_pair(k: int, r: int) -> Tuple[Graph, Graph]:
    """Ring (reduce, bcast) pair rooted at rank r.

    Reduce: chain (r+1) -> (r+2) -> ... -> r with self-loops everywhere
    (each hop accumulates). Bcast: chain r -> (r+1) -> ... -> (r+k-1).
    Used with chunking: chunk c uses root (c % k), giving a pipelined,
    bandwidth-optimal ring like the classic ring-allreduce.
    """
    reduce_g = Graph(k)
    bcast_g = Graph(k)
    for i in range(k):
        reduce_g.add_edge(i, i)
    for i in range(1, k):
        reduce_g.add_edge((r + i) % k, (r + i + 1) % k)
        bcast_g.add_edge((r + i - 1) % k, (r + i) % k)
    return reduce_g, bcast_g


def gen_subset_circular_graph_pair(n: int, ranks: List[int], r: int) -> Tuple[Graph, Graph]:
    """Ring pair over a subset of ranks (e.g. host masters), for cross-host
    allreduce. Mirrors subgraph.GenCircularGraphPair."""
    k = len(ranks)
    reduce_g = Graph(n)
    bcast_g = Graph(n)
    for i in ranks:
        reduce_g.add_edge(i, i)
    for i in range(1, k):
        reduce_g.add_edge(ranks[(r + i) % k], ranks[(r + i + 1) % k])
        bcast_g.add_edge(ranks[(r + i - 1) % k], ranks[(r + i) % k])
    return reduce_g, bcast_g


@dataclasses.dataclass(frozen=True)
class SegmentedSchedule:
    """Per-rank plan for a segmented ring allreduce over ``ranks``.

    The payload is split into ``k = len(ranks)`` contiguous segments.
    Phase 1 (reduce-scatter) runs k-1 steps; at each step every member
    sends one partially-reduced segment to its ring successor and
    accumulates the segment arriving from its predecessor. After it,
    member i holds the fully reduced segment ``(i+1) % k``. Phase 2
    (all-gather) runs k-1 more steps relaying reduced segments around the
    same ring. Every member therefore moves exactly
    ``2 * (sum of all segments except one)`` ≈ ``2*(k-1)/k * N`` bytes
    each way — the bandwidth-optimal schedule (arXiv:1810.11112 §3).

    ``rs_steps``/``ag_steps`` are (send_segment, recv_segment) pairs; the
    send/recv peers are fixed for the whole walk (ring successor and
    predecessor in ``ranks`` order).
    """

    ranks: Tuple[int, ...]  # participating global ranks in ring order
    index: int  # this member's position within ranks
    rs_steps: Tuple[Tuple[int, int], ...]
    ag_steps: Tuple[Tuple[int, int], ...]

    @property
    def k(self) -> int:
        return len(self.ranks)

    @property
    def send_peer(self) -> int:
        """Global rank of the ring successor (all sends go here)."""
        return self.ranks[(self.index + 1) % self.k]

    @property
    def recv_peer(self) -> int:
        """Global rank of the ring predecessor (all receives come from here)."""
        return self.ranks[(self.index - 1) % self.k]

    @property
    def owned_segment(self) -> int:
        """Segment this member holds fully reduced after reduce-scatter."""
        return (self.index + 1) % self.k


def segment_bounds(
    count: int, k: int, weights: Optional[Sequence[float]] = None
) -> List[Tuple[int, int]]:
    """THE segment partition of a k-ring payload: equal contiguous
    segments, or throughput-proportional ones when a measured plan
    supplies ``weights``. Single-sourced so the walk engine,
    the owned-shard layout and every test derive identical bounds."""
    from kungfu_tpu_torch.base.workspace import even_partition

    if weights is None:
        return even_partition(count, k)
    from kungfu_tpu_torch.plan.replan import weighted_partition

    if len(weights) != k:
        raise ValueError(f"{len(weights)} weights for a ring of {k}")
    return weighted_partition(count, weights)


def owned_segment_bounds(
    count: int,
    k: int,
    index: int,
    order: Optional[Sequence[int]] = None,
    weights: Optional[Sequence[float]] = None,
) -> Tuple[int, int]:
    """(begin, end) element bounds of the segment rank ``index`` owns
    fully reduced after the reduce-scatter phase — THE shard layout
    of the ZeRO-1 sharded update. Single-sourced here so the
    walk engine's segment math and the sharded optimizer's shard views
    can never disagree: both call this, both get
    ``segment_bounds(count, k, weights)[owned_segment]``.

    With a measured-topology plan pass its ring ``order``
    (ranks in ring order) and optional per-segment ``weights``: the
    owned segment follows the rank's POSITION in the reordered ring and
    the weighted partition, exactly as the reordered walk computes it —
    a plan change re-shards through this one function. Without a plan,
    ``index`` doubles as the ring position (the naive rank-order ring).
    k == 1 owns everything."""
    if k <= 1:
        return (0, count)
    members = list(order) if order is not None else list(range(k))
    sched = gen_segmented_schedule(members, members.index(index))
    return segment_bounds(count, k, weights)[sched.owned_segment]


def gen_segmented_schedule(ranks: List[int], index: int) -> SegmentedSchedule:
    """Segmented ring schedule for member ``index`` of ``ranks``.

    Every member computes its own table from the same (ranks, k) inputs,
    so the tables pair up cluster-wide without negotiation: the segment
    member i sends at step s is exactly the segment member i+1 expects to
    receive at step s (both phases).
    """
    k = len(ranks)
    if not 0 <= index < k:
        raise ValueError(f"index {index} outside ring of {k}")
    i = index
    rs = tuple(((i - s) % k, (i - s - 1) % k) for s in range(k - 1))
    ag = tuple(((i + 1 - s) % k, (i - s) % k) for s in range(k - 1))
    return SegmentedSchedule(ranks=tuple(ranks), index=i, rs_steps=rs, ag_steps=ag)


def gen_subset_binary_tree(n: int, ranks: List[int]) -> Graph:
    """Binary tree over a subset of ranks embedded in an n-rank graph."""
    g = Graph(n)
    k = len(ranks)
    for i in range(k):
        for j in (2 * i + 1, 2 * i + 2):
            if j < k:
                g.add_edge(ranks[i], ranks[j])
    return g

"""Directed-graph algebra for collective communication plans.

Port of `kungfu_tpu/plan/graph.py` (parity:
srcs/go/plan/graph/graph.go:29-154) — a DAG over ranks 0..n-1 with
per-node prev/next edge lists and a self-loop marker (a self-loop on the
reduce graph means "this rank accumulates"), plus forest-array
construction, reversal, and a canonical digest used for cluster-wide
consensus on topology, byte-equal to the reference's.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Sequence, Tuple


class Graph:
    """Graph over ranks 0..n-1. Edges are directed i -> j."""

    def __init__(self, n: int):
        self.n = n
        self._prevs: List[List[int]] = [[] for _ in range(n)]
        self._nexts: List[List[int]] = [[] for _ in range(n)]
        self._self_loop = [False] * n

    def add_edge(self, i: int, j: int) -> None:
        if i == j:
            self._self_loop[i] = True
            return
        self._nexts[i].append(j)
        self._prevs[j].append(i)

    def prevs(self, i: int) -> List[int]:
        return self._prevs[i]

    def nexts(self, i: int) -> List[int]:
        return self._nexts[i]

    def is_self_loop(self, i: int) -> bool:
        return self._self_loop[i]

    def is_isolated(self, i: int) -> bool:
        return not self._prevs[i] and not self._nexts[i]

    def reverse(self) -> "Graph":
        r = Graph(self.n)
        for i in range(self.n):
            r._self_loop[i] = self._self_loop[i]
            for j in self._nexts[i]:
                r._nexts[j].append(i)
            for j in self._prevs[i]:
                r._prevs[j].append(i)
        return r

    @classmethod
    def from_forest_array(cls, fathers: Sequence[int]) -> Tuple[Optional["Graph"], int, bool]:
        """Build a broadcast forest from a father-array.

        fathers[i] is the father of rank i; fathers[i] == i marks a root.
        Returns (graph, num_roots, ok); ok is False on out-of-range entries
        or cycles.
        """
        n = len(fathers)
        g = cls(n)
        roots = 0
        for i, f in enumerate(fathers):
            if f < 0 or f >= n:
                return None, 0, False
            if f == i:
                roots += 1
            else:
                g.add_edge(f, i)
        # cycle check: walk each node to its root, bounded by n hops
        for i in range(n):
            cur, hops = i, 0
            while fathers[cur] != cur:
                cur = fathers[cur]
                hops += 1
                if hops > n:
                    return None, 0, False
        return g, roots, True

    def digest(self) -> bytes:
        """Canonical byte digest, equal iff topologies are equal.

        Mirrors DigestBytes (graph.go:129-146): per node, (self_loop,
        out-degree, sorted nexts), little-endian i32, then hashed.
        """
        h = hashlib.blake2b(digest_size=16)
        h.update(struct.pack("<i", self.n))
        for i in range(self.n):
            nexts = sorted(self._nexts[i])
            h.update(struct.pack("<ii", int(self._self_loop[i]), len(nexts)))
            h.update(struct.pack(f"<{len(nexts)}i", *nexts) if nexts else b"")
        return h.digest()

    def debug_string(self) -> str:
        loops = "".join(f"({i})" for i in range(self.n) if self._self_loop[i])
        edges = "".join(
            f"({i}->{j})" for i in range(self.n) for j in self._nexts[i]
        )
        return f"[{self.n}]{{{loops}{edges}}}"

    def __repr__(self) -> str:
        return f"Graph{self.debug_string()}"

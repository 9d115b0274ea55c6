"""Collective communication strategies (host plane).

Port of `kungfu_tpu/base/strategy.py` (parity: the reference's strategy
enum, srcs/go/kungfu/base/strategy.go:10-22), selecting the graph
topology used by the host-side collective engine. The device plane does
not use these (NCCL picks its own algorithms); they drive the host-side
engine used for control collectives and the host all-reduce.
"""

from __future__ import annotations

import enum


class Strategy(enum.IntEnum):
    STAR = 0
    RING = 1
    CLIQUE = 2
    TREE = 3
    BINARY_TREE = 4
    BINARY_TREE_STAR = 5
    AUTO = 6
    MULTI_BINARY_TREE_STAR = 7
    MULTI_STAR = 8
    # Bandwidth-optimal segmented ring: allreduce runs as a (k-1)-step
    # reduce-scatter over contiguous segments followed by a (k-1)-step
    # all-gather, so each peer moves only 2*(k-1)/k of the payload instead
    # of relaying full copies through tree/star roots. Executed by the
    # engine's dedicated segmented walk, not a graph pair; the residual
    # graph ops (reduce/broadcast/gather) fall back to a rank-0 binary
    # tree (see collective/strategies.py).
    RING_SEGMENTED = 9

    @classmethod
    def parse(cls, name: str) -> "Strategy":
        try:
            return cls[name.strip().upper().replace("-", "_")]
        except KeyError:
            raise ValueError(f"unknown strategy: {name!r}") from None


DEFAULT_STRATEGY = Strategy.BINARY_TREE_STAR

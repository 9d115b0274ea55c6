"""Measured-topology re-planning: pure functions from a measured
bandwidth matrix to a ring plan.

Port of `kungfu_tpu/plan/replan.py`. Host-side f64 planning math, so it
stays numpy. Everything here is a **pure, deterministic function of its
inputs**: every peer that feeds the same matrix in derives the
byte-identical :class:`RingPlan` out, and the port derives the same
bytes, and so the same digest, as the reference. That is the
cluster-safety contract: the plan digest is asserted on the consensus
walk at adoption, so a peer whose derivation diverged gets a named
error, never a rendezvous hang.

Two levers:

- :func:`ring_order` — a ring permutation placing each peer next to its
  fastest measured links: greedy max-min-edge construction refined by
  2-opt (segment reversal, asymmetric-aware: candidate orders are
  re-scored, not mirrored). The objective is lexicographic
  ``(min edge bandwidth, total edge bandwidth)`` — a ring walk
  serializes on its slowest edge. Rank 0 stays first (rings are
  rotation-invariant; pinning the start keeps plans canonical).
- :func:`weighted_partition` — contiguous throughput-proportional
  segments. The owned segment sizes the per-peer work that does NOT
  rotate around the ring (the ZeRO-1 shard update, the all-gather seed
  encode), so a slow peer gets a smaller owned segment.

Two-level plans (:class:`HierPlan`, :func:`derive_hier_plan`) nest a
per-host reduce/broadcast under an inter-host ring over elected heads.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

# weights are clamped to [mean/CLAMP, mean*CLAMP] before normalizing: a
# wildly mis-measured peer must shift segment sizes, not collapse its
# segment to zero (an empty owned segment would drop that peer's update
# work entirely and concentrate it elsewhere)
WEIGHT_CLAMP = 4.0
# 2-opt refinement passes are capped for bounded runtime at k=64 (the
# scan is deterministic first-improvement, so the cap never introduces
# cross-peer divergence — every peer stops at the same pass)
MAX_2OPT_PASSES = 64


def weighted_partition(
    count: int, weights: Sequence[float]
) -> List[Tuple[int, int]]:
    """Split [0, count) into ``len(weights)`` contiguous intervals with
    sizes proportional to ``weights``.

    Boundaries are cumulative-rounded (``floor(count·cum + 0.5)``), which
    gives three properties the shard layout depends on (property-tested):

    - **contiguous + lossless**: intervals tile [0, count) exactly;
    - **monotone**: growing one weight (others fixed) never shrinks its
      interval — boundaries left of it stay put, boundaries right of it
      only move right;
    - **degenerate-safe**: an all-zero weight vector falls back to
      :func:`~kungfu_tpu_torch.base.workspace.even_partition`; ``count < k``
      produces empty intervals exactly like the even split.

    Negative weights are a caller bug and raise."""
    k = len(weights)
    if k <= 0:
        raise ValueError("weighted_partition needs at least one weight")
    w = [float(x) for x in weights]
    if any(x < 0 for x in w):
        raise ValueError(f"weights must be non-negative, got {w}")
    total = sum(w)
    if total <= 0.0:
        from kungfu_tpu_torch.base.workspace import even_partition

        return even_partition(count, k)
    bounds: List[Tuple[int, int]] = []
    cum = 0.0
    prev = 0
    for i in range(k):
        cum += w[i]
        end = count if i == k - 1 else min(count, int(count * (cum / total) + 0.5))
        end = max(end, prev)
        bounds.append((prev, end))
        prev = end
    return bounds


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """A measured-topology plan for the global segmented ring.

    ``order`` is the ranks in ring order (a permutation of
    ``range(k)``, ``order[0] == 0``); ``weights`` — when present — are
    per-SEGMENT weights (segment ``s`` is owned by the member at ring
    position ``(s - 1) % k``, i.e. rank ``order[(s - 1) % k]``), summing
    to ~1. ``gain`` is the optimizer's predicted step-throughput ratio
    vs the plan it replaces (min-ring-edge bandwidth ratio — the edge a
    ring walk serializes on).

    Byte serialization is canonical (sorted keys, fixed float rounding
    upstream), so equality of derivations is equality of bytes — what
    the adoption digest asserts."""

    order: Tuple[int, ...]
    weights: Optional[Tuple[float, ...]] = None
    gain: float = 1.0

    def __post_init__(self):
        k = len(self.order)
        if sorted(self.order) != list(range(k)):
            raise ValueError(f"order must be a permutation of 0..{k - 1}: "
                             f"{self.order}")
        if self.weights is not None and len(self.weights) != k:
            raise ValueError(
                f"{len(self.weights)} weights for a ring of {k}"
            )

    def to_bytes(self) -> bytes:
        return json.dumps(
            {
                "order": list(self.order),
                "weights": (
                    None if self.weights is None else list(self.weights)
                ),
                "gain": round(float(self.gain), 6),
            },
            sort_keys=True, separators=(",", ":"),
        ).encode()

    def digest(self) -> bytes:
        return hashlib.blake2b(self.to_bytes(), digest_size=16).digest()

    def describe(self) -> str:
        arrow = "→".join(str(r) for r in self.order)
        w = "" if self.weights is None else " (weighted segments)"
        return f"{arrow}{w}"


@dataclasses.dataclass(frozen=True)
class HierPlan:
    """A measured-topology TWO-LEVEL plan: per-host intra
    star (reduce members → a host head over the fast local links) × an
    inter-host ring over the heads (the wire-codec-eligible DCN leg) ×
    an intra broadcast back out — the 2D hierarchical all-reduce shape
    arXiv:1909.09756 scales to pod size.

    ``groups`` are the host groups in INTER-RING order; each group
    tuple lists its members with the elected head FIRST. ``heads`` is
    the per-group head (``heads[i] == groups[i][0]``), so the inter
    ring is ``heads[0] → heads[1] → … → heads[0]``. ``demoted`` ranks
    stay members of their group (they receive the result in the final
    broadcast) but contribute nothing: excluded from head election,
    from the inter ring, and from the reduce — the source paper's
    adaptive peer selection, a persistent straggler moved to a backup
    role instead of serializing the ring.

    Byte serialization is canonical exactly like :class:`RingPlan` —
    adoption walks the digest, so a diverged derivation is a named
    error, never a hang."""

    groups: Tuple[Tuple[int, ...], ...]
    heads: Tuple[int, ...]
    demoted: Tuple[int, ...] = ()
    gain: float = 1.0

    def __post_init__(self):
        members = [r for g in self.groups for r in g]
        k = len(members)
        if sorted(members) != list(range(k)):
            raise ValueError(
                f"groups must partition 0..{k - 1}: {self.groups}"
            )
        if len(self.heads) != len(self.groups):
            raise ValueError(
                f"{len(self.heads)} heads for {len(self.groups)} groups"
            )
        for head, grp in zip(self.heads, self.groups):
            if not grp or grp[0] != head:
                raise ValueError(
                    f"head {head} must lead its group {grp}"
                )
            if head in self.demoted:
                raise ValueError(f"head {head} cannot be demoted")
        if list(self.demoted) != sorted(set(self.demoted)):
            raise ValueError(f"demoted must be sorted unique: "
                             f"{self.demoted}")
        for d in self.demoted:
            if d not in members:
                raise ValueError(f"demoted rank {d} not in any group")

    @property
    def size(self) -> int:
        return sum(len(g) for g in self.groups)

    def group_of(self, rank: int) -> int:
        for gi, g in enumerate(self.groups):
            if rank in g:
                return gi
        raise ValueError(f"rank {rank} not in plan")

    def active(self) -> Tuple[int, ...]:
        """Contributing ranks (everyone not demoted), in group order."""
        dem = set(self.demoted)
        return tuple(
            r for g in self.groups for r in g if r not in dem
        )

    def to_bytes(self) -> bytes:
        return json.dumps(
            {
                "kind": "hier",
                "groups": [list(g) for g in self.groups],
                "heads": list(self.heads),
                "demoted": list(self.demoted),
                "gain": round(float(self.gain), 6),
            },
            sort_keys=True, separators=(",", ":"),
        ).encode()

    def digest(self) -> bytes:
        return hashlib.blake2b(self.to_bytes(), digest_size=16).digest()

    def describe(self) -> str:
        parts = []
        for head, grp in zip(self.heads, self.groups):
            inner = ",".join(
                (f"{r}▽" if r in self.demoted else str(r))
                for r in grp
            )
            parts.append(f"[{inner}|h{head}]")
        return "→".join(parts)

    def as_ring_plan(self) -> RingPlan:
        """Flat projection for everything that thinks in one ring: the
        ZeRO shard layout (``owned_bounds``), the ring-position gauges,
        and the segmented RS/AG legs. Order concatenates the groups in
        inter-ring order (rotated so rank 0 leads, rings being
        rotation-invariant); demoted ranks carry ZERO segment weight —
        an empty owned shard, no update work parked on a straggler."""
        flat = [r for g in self.groups for r in g]
        zero = flat.index(0)
        order = tuple(flat[zero:] + flat[:zero])
        k = len(order)
        weights: Optional[Tuple[float, ...]] = None
        if self.demoted:
            rank_w = [0.0 if r in self.demoted else 1.0
                      for r in range(k)]
            total = sum(rank_w)
            if total > 0:
                rank_w = [w / total for w in rank_w]
            weights = tuple(
                round(float(x), 9)
                for x in segment_weights(order, rank_w)
            )
        return RingPlan(order=order, weights=weights,
                        gain=round(float(self.gain), 6))


def plan_digest(plan) -> bytes:
    """Digest of a possibly-absent plan (None = the naive rank-order
    ring with equal segments) — the bytes the adoption consensus walks.
    Accepts :class:`RingPlan` or :class:`HierPlan` (canonical bytes
    disambiguate the two)."""
    return plan.digest() if plan is not None else b"naive-ring"


def _fill_unknown(bw: np.ndarray) -> Optional[np.ndarray]:
    """Score matrix with unknown (<= 0 / non-finite) edges set to the
    median known estimate — unknown is neutral, not slow. None when
    nothing is estimated at all."""
    m = np.array(bw, np.float64, copy=True)
    k = m.shape[0]
    mask = np.isfinite(m) & (m > 0)
    np.fill_diagonal(mask, False)
    known = m[mask]
    if known.size == 0:
        return None
    fill = float(np.median(known))
    m[~mask] = fill
    np.fill_diagonal(m, 0.0)
    return m


def _ring_edges(order: Sequence[int]) -> List[Tuple[int, int]]:
    k = len(order)
    return [(order[i], order[(i + 1) % k]) for i in range(k)]


def _objective(score: np.ndarray, order: Sequence[int]) -> Tuple[float, float]:
    """(min edge, sum of edges) — lexicographic, maximized."""
    edges = _ring_edges(order)
    vals = [float(score[i, j]) for i, j in edges]
    return (min(vals), sum(vals))


def ring_order(bw: np.ndarray) -> Tuple[int, ...]:
    """Deterministic ring permutation over ``range(k)`` maximizing the
    lexicographic ``(min edge bw, total edge bw)`` objective: greedy
    max-min-edge construction (append the unvisited peer with the
    fastest measured link from the current tail; ties take the lowest
    rank) followed by 2-opt refinement (first-improvement segment
    reversal with rank 0 pinned first; candidate orders are re-scored
    against the DIRECTED matrix, so asymmetric links are handled).

    Pure function of the matrix: every peer derives the identical
    permutation from the same bytes. A matrix with no estimates, a
    uniform matrix, or k <= 2 returns rank order (re-planning is a
    no-op without information)."""
    k = int(np.asarray(bw).shape[0])
    identity = tuple(range(k))
    if k <= 2:
        return identity
    score = _fill_unknown(np.asarray(bw))
    if score is None:
        return identity
    off_diag = score[~np.eye(k, dtype=bool)]
    if off_diag.size and np.allclose(off_diag, off_diag[0], rtol=1e-6):
        return identity  # uniform: nothing to optimize, keep rank order
    # greedy max-min-edge construction
    order = [0]
    remaining = set(range(1, k))
    while remaining:
        last = order[-1]
        best = max(
            sorted(remaining), key=lambda c: (score[last, c], -c)
        )
        order.append(best)
        remaining.discard(best)
    # 2-opt refinement (rank 0 pinned at position 0)
    best_obj = _objective(score, order)
    for _ in range(MAX_2OPT_PASSES):
        improved = False
        for i in range(1, k - 1):
            for j in range(i + 1, k):
                cand = order[:i] + list(reversed(order[i:j + 1])) + order[j + 1:]
                obj = _objective(score, cand)
                if obj > best_obj:
                    order, best_obj = cand, obj
                    improved = True
        if not improved:
            break
    return tuple(order)


def peer_throughput_weights(bw: np.ndarray) -> Optional[Tuple[float, ...]]:
    """Per-RANK throughput weights from the matrix: the mean of each
    peer's known outgoing estimates (its measured ability to move
    bytes), clamped to ``mean/WEIGHT_CLAMP .. mean*WEIGHT_CLAMP`` and
    normalized to sum 1. None when unmeasured or effectively uniform
    (equal segments already optimal)."""
    m = np.asarray(bw, np.float64)
    k = m.shape[0]
    mask = np.isfinite(m) & (m > 0)
    np.fill_diagonal(mask, False)
    if not mask.any():
        return None
    fill = float(np.median(m[mask]))
    rows = np.where(mask, m, fill)
    np.fill_diagonal(rows, 0.0)
    per_rank = rows.sum(axis=1) / max(1, k - 1)
    return weights_from_throughput(per_rank)


def weights_from_throughput(
    throughput: Sequence[float],
) -> Optional[Tuple[float, ...]]:
    """Normalize measured per-peer throughputs into segment weights:
    clamp the spread to ``WEIGHT_CLAMP`` around the mean (a bad estimate
    shifts work, never zeroes a peer out), normalize to sum 1, round for
    canonical bytes. None when the result is effectively uniform."""
    t = np.asarray([float(x) for x in throughput], np.float64)
    if t.size == 0 or not np.isfinite(t).all() or (t <= 0).any():
        return None
    mean = float(t.mean())
    t = np.clip(t, mean / WEIGHT_CLAMP, mean * WEIGHT_CLAMP)
    t = t / t.sum()
    if np.allclose(t, 1.0 / t.size, rtol=1e-3, atol=1e-9):
        return None
    return tuple(round(float(x), 9) for x in t)


def segment_weights(
    order: Sequence[int], rank_weights: Sequence[float]
) -> Tuple[float, ...]:
    """Re-index per-RANK weights into per-SEGMENT weights: segment ``s``
    is owned by the member at ring position ``(s - 1) % k``
    (SegmentedSchedule.owned_segment), so its weight is that rank's."""
    k = len(order)
    return tuple(
        rank_weights[order[(s - 1) % k]] for s in range(k)
    )


def min_edge_bw(bw: np.ndarray, order: Sequence[int]) -> Optional[float]:
    """Slowest MEASURED ring edge of ``order`` (None when the ring
    touches no estimated edge) — the denominator of predicted gain."""
    m = np.asarray(bw, np.float64)
    vals = [
        float(m[i, j]) for i, j in _ring_edges(order)
        if np.isfinite(m[i, j]) and m[i, j] > 0
    ]
    return min(vals) if vals else None


def derive_plan(
    bw: np.ndarray,
    mode: str = "auto",
    current: Optional[RingPlan] = None,
    compute_frac: float = 0.0,
) -> Optional[RingPlan]:
    """Turn the merged k×k bandwidth matrix into a :class:`RingPlan`,
    or None when re-planning would be a no-op (no estimates, uniform
    matrix, or the derived plan equals the current one).

    ``mode`` mirrors ``KF_CONFIG_REPLAN``: ``ring`` reorders only,
    ``ring+segments``/``auto`` also weight the segments by measured
    per-peer throughput. Pure function of (matrix bytes, mode, current
    plan, compute_frac) — the cross-peer determinism the adoption
    digest asserts; callers must feed a cluster-agreed ``compute_frac``
    (``HostSession.check_replan`` all-gathers it).

    ``compute_frac`` is the measured compute floor from the resource
    plane: the fraction of the step the busiest peer spends
    burning CPU rather than waiting on the network. Amdahl caps what a
    ring re-order can buy — only the network share shrinks — so the
    predicted gain is clamped to ``1 / compute_frac`` (the unclamped
    min-edge-bandwidth predictor was measured 86x optimistic on a
    CPU-bound host run). 0.0 = unmeasured, no clamp: a missing
    measurement must never fabricate pessimism."""
    if mode in ("off", ""):
        return None
    if mode not in ("ring", "ring+segments", "auto"):
        raise ValueError(f"unknown replan mode: {mode!r}")
    m = np.asarray(bw, np.float64)
    k = int(m.shape[0])
    if k < 2 or m.shape != (k, k):
        return None
    order = ring_order(m)
    weights: Optional[Tuple[float, ...]] = None
    if mode in ("ring+segments", "auto"):
        rank_w = peer_throughput_weights(m)
        if rank_w is not None:
            weights = segment_weights(order, rank_w)
    cur_order = current.order if current is not None else tuple(range(k))
    cur_weights = current.weights if current is not None else None
    if order == cur_order and weights == cur_weights:
        return None
    old_min = min_edge_bw(m, cur_order)
    new_min = min_edge_bw(m, order)
    gain = 1.0
    if old_min and new_min and old_min > 0:
        gain = new_min / old_min
    cf = float(compute_frac)
    if cf > 0.0 and np.isfinite(cf):
        gain = min(gain, 1.0 / max(min(cf, 1.0), 1e-6))
    return RingPlan(order=order, weights=weights, gain=round(gain, 6))


# ---------------------------------------------------------------------------
# two-level (hierarchical) plans
# ---------------------------------------------------------------------------

# a measured matrix is considered bimodal (fast intra-host links vs
# slow cross-host links) when the edge values split at a log-gap of at
# least this ratio; below it, clustering falls back to the static host
# partition (the measurement cannot distinguish the levels)
HIER_BIMODAL_RATIO = 4.0


def cluster_hosts(
    bw: np.ndarray,
    fallback: Sequence[Sequence[int]] = (),
) -> List[List[int]]:
    """Group ranks into host-like clusters from the MEASURED matrix:
    symmetrize (max of the two directions), sort the edge estimates,
    cut at the largest log-gap, and union-find the edges above the cut
    — intra-host links (shm/loopback) measure orders of magnitude
    faster than the DCN, so the gap is the host boundary.

    Deterministic function of the matrix bytes (cluster-safety: every
    peer derives identical groups). Falls back to ``fallback`` (the
    static host partition, each inner list sorted) when the matrix is
    unmeasured, unimodal (gap ratio < :data:`HIER_BIMODAL_RATIO`), or
    the cut yields a degenerate grouping; an empty fallback means
    "no grouping" ([])."""
    m = np.asarray(bw, np.float64)
    k = int(m.shape[0])
    fb = [sorted(int(r) for r in g) for g in fallback if len(g)]
    fb.sort(key=lambda g: g[0])
    if k < 2 or m.shape != (k, k):
        return fb
    sym = np.maximum(m, m.T)
    mask = np.isfinite(sym) & (sym > 0)
    np.fill_diagonal(mask, False)
    iu = np.triu_indices(k, 1)
    vals = sym[iu][mask[iu]]
    if vals.size < 2:
        return fb
    s = np.sort(vals)
    logs = np.log(s)
    gaps = np.diff(logs)
    gi = int(np.argmax(gaps))
    ratio = float(s[gi + 1] / s[gi]) if s[gi] > 0 else 0.0
    if not np.isfinite(ratio) or ratio < HIER_BIMODAL_RATIO:
        return fb
    thresh = float(np.sqrt(s[gi] * s[gi + 1]))  # geometric midpoint
    # union-find over edges faster than the cut
    parent = list(range(k))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(k):
        for j in range(i + 1, k):
            if mask[i, j] and sym[i, j] > thresh:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[max(ri, rj)] = min(ri, rj)
    comps: dict = {}
    for r in range(k):
        comps.setdefault(find(r), []).append(r)
    groups = sorted(comps.values(), key=lambda g: g[0])
    if len(groups) < 2 or len(groups) == k:
        return fb  # one blob or all singletons: the cut told us nothing
    return [sorted(g) for g in groups]


def _cross_group_bw(
    sym: np.ndarray, rank: int, own: Sequence[int]
) -> float:
    """Mean measured bandwidth from ``rank`` to ranks OUTSIDE its group
    — the head-election score (the head carries the uplink leg)."""
    k = sym.shape[0]
    own_set = set(own)
    vals = [
        float(sym[rank, j]) for j in range(k)
        if j not in own_set
        and np.isfinite(sym[rank, j]) and sym[rank, j] > 0
    ]
    return sum(vals) / len(vals) if vals else 0.0


def derive_hier_plan(
    bw: np.ndarray,
    hosts: Sequence[Sequence[int]] = (),
    mode: str = "hier",
    current=None,
    compute_frac: float = 0.0,
    demoted: Sequence[int] = (),
) -> Optional[HierPlan]:
    """Turn the merged k×k matrix into a two-level :class:`HierPlan`,
    or None when a hierarchy would be a no-op: fewer than two host
    groups (nothing to nest), a group left with no contributing member
    (every candidate head demoted), or a derivation byte-identical to
    ``current``.

    Pure function of (matrix bytes, hosts, mode, current, compute_frac,
    demoted) — same determinism contract as :func:`derive_plan`; the
    caller (``HostSession.check_replan``) feeds cluster-agreed inputs
    only. Host grouping prefers the measured clustering
    (:func:`cluster_hosts`) and falls back to the static ``hosts``
    partition; head election takes the highest measured cross-group
    bandwidth (ties to the lowest rank); the inter-host ring over the
    heads is :func:`ring_order` on the head submatrix.

    Predicted ``gain`` compares serialized bytes/bandwidth of the flat
    ring (2·(k-1)/k·N at its min edge) against the two-level walk
    (2·(H-1)/H·N at the min inter-head edge + 2·N at the min intra
    edge), Amdahl-clamped by ``compute_frac`` like :func:`derive_plan`
    — a prediction the decision ledger grades with a measured verdict."""
    if mode in ("off", ""):
        return None
    m = np.asarray(bw, np.float64)
    k = int(m.shape[0])
    if k < 2 or m.shape != (k, k):
        return None
    dem = tuple(sorted({int(d) for d in demoted if 0 <= int(d) < k}))
    groups = cluster_hosts(m, fallback=hosts)
    if len(groups) < 2:
        return None
    if sorted(r for g in groups for r in g) != list(range(k)):
        return None  # partial partition: refuse to guess
    sym = np.maximum(m, m.T)
    np.fill_diagonal(sym, 0.0)
    heads: List[int] = []
    ordered_groups: List[List[int]] = []
    for g in groups:
        cands = [r for r in g if r not in dem]
        if not cands:
            return None  # a fully-demoted host has no head to carry it
        head = max(
            cands,
            key=lambda r: (_cross_group_bw(sym, r, g), -r),
        )
        heads.append(head)
        ordered_groups.append([head] + [r for r in g if r != head])
    # inter-host ring over the heads: ring_order on the head submatrix
    # (heads ascending → index 0 is the lowest head, which ring_order
    # pins first — canonical across peers)
    hsorted = sorted(range(len(heads)), key=lambda i: heads[i])
    sub = m[np.ix_([heads[i] for i in hsorted],
                   [heads[i] for i in hsorted])]
    inter = ring_order(sub)
    perm = [hsorted[i] for i in inter]
    heads = [heads[i] for i in perm]
    ordered_groups = [ordered_groups[i] for i in perm]
    H = len(heads)
    # predicted gain: serialized bytes/bandwidth, flat vs two-level
    flat_order = (
        current.as_ring_plan().order if isinstance(current, HierPlan)
        else (current.order if isinstance(current, RingPlan)
              else tuple(range(k)))
    )
    flat_min = min_edge_bw(m, flat_order)
    inter_min = min_edge_bw(
        m, [heads[i] for i in range(H)]
    ) if H > 1 else None
    intra_vals = [
        float(sym[i, j])
        for g in ordered_groups
        for i in g for j in g
        if i != j and np.isfinite(sym[i, j]) and sym[i, j] > 0
    ]
    intra_min = min(intra_vals) if intra_vals else None
    gain = 1.0
    if flat_min and inter_min and intra_min:
        flat_cost = 2.0 * (k - 1) / k / flat_min
        hier_cost = (
            2.0 * (H - 1) / H / inter_min + 2.0 / intra_min
        )
        if hier_cost > 0:
            gain = flat_cost / hier_cost
    cf = float(compute_frac)
    if cf > 0.0 and np.isfinite(cf):
        gain = min(gain, 1.0 / max(min(cf, 1.0), 1e-6))
    plan = HierPlan(
        groups=tuple(tuple(g) for g in ordered_groups),
        heads=tuple(heads),
        demoted=dem,
        gain=round(float(gain), 6),
    )
    if current is not None and hasattr(current, "to_bytes") \
            and current.to_bytes() == plan.to_bytes():
        return None
    return plan

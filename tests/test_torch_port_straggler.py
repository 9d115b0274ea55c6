"""The port's straggler scorer (`kungfu_tpu_torch/telemetry/straggler.py`)
against the JAX package's (`kungfu_tpu/telemetry/straggler.py`), in
process; mirrors tests/test_telemetry_cluster.py's scorer cases.

- Seeded per-peer series — a homogeneous cluster, a noise spike, a slow
  peer, a fast outlier, too few peers, a peer forgotten or dropped, a
  recovering peer — give the same scores, flags, medians and skew in
  both packages, observation by observation.
- `blocking_edge` and `classify_cause` give the same answers on a table
  of merged steps and link matrices, here with no resource or memory
  view (both None); `test_torch_port_memory.py` holds the compute and
  memory evidence."""

import numpy as np
import pytest

from kungfu_tpu.telemetry import straggler as rstraggler
from kungfu_tpu_torch.telemetry import straggler

SCENARIOS = ["homogeneous", "spike", "slow_peer", "fast_outlier", "too_few", "forget",
             "drop", "recovery"]


def _series(scenario, rng):
    """(peers, [(peer, value) observations], [(after_index, action, arg)])."""
    k = 3 if scenario == "too_few" else int(rng.integers(4, 9))
    peers = [f"10.0.0.{i}:{38000 + i}" for i in range(k)]
    base = float(rng.uniform(0.05, 0.5))
    obs, actions = [], []
    for t in range(24):
        for i, p in enumerate(peers):
            v = base * (1.0 + rng.normal(0, 0.01))
            if scenario == "spike" and i == 0 and t == 11:
                v *= 20.0  # one sample: the rolling median must absorb it
            if scenario == "slow_peer" and i == k - 1:
                v *= float(rng.uniform(1.8, 3.0))
            if scenario == "fast_outlier" and i == 1:
                v *= 0.2
            if scenario == "recovery" and i == 2:
                v *= 3.0 if t < 12 else 1.0
            obs.append((p, v))
    if scenario == "forget":
        actions.append((len(obs) // 2, "forget", peers[1:]))
    if scenario == "drop":
        actions.append((len(obs) // 2, "drop", peers[-1]))
    return peers, obs, actions


def _state(sc):
    scores = {p: (s.value, s.score, s.flagged) for p, s in sc.scores().items()}
    return scores, sc.stragglers(), sc.cluster_median(), sc.skew()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scorer_tracks_the_reference_observation_by_observation(scenario, seed):
    rng = np.random.default_rng(100 * seed + SCENARIOS.index(scenario))
    peers, obs, actions = _series(scenario, rng)
    kw = dict(window=int(rng.integers(4, 17)), z_threshold=3.0, ratio_threshold=1.5)
    mine, theirs = straggler.StragglerScorer(**kw), rstraggler.StragglerScorer(**kw)
    flagged_ever = set()
    for n, (p, v) in enumerate(obs):
        for sc in (mine, theirs):
            sc.observe(p, v)
        for at, action, arg in actions:
            if at == n:
                for sc in (mine, theirs):
                    getattr(sc, action)(arg)
                live = set(arg) if action == "forget" else set(peers) - {arg}
                assert set(mine.scores()) <= live
        got, want = _state(mine), _state(theirs)
        assert got == want, n
        flagged_ever |= set(got[1])
    if scenario == "slow_peer":
        assert peers[-1] in flagged_ever
    if scenario in ("homogeneous", "spike", "fast_outlier", "too_few"):
        assert not flagged_ever
    if scenario == "recovery":
        assert peers[2] in flagged_ever and mine.stragglers() == []
    mine.clear()
    theirs.clear()
    assert _state(mine) == _state(theirs) == ({}, [], None, None)


@pytest.mark.parametrize("min_peers,min_samples", [(1, 1), (2, 3), (5, 2)])
def test_population_guards_match(min_peers, min_samples):
    rng = np.random.default_rng(min_peers * 10 + min_samples)
    kw = dict(window=8, min_peers=min_peers, min_samples=min_samples)
    mine, theirs = straggler.StragglerScorer(**kw), rstraggler.StragglerScorer(**kw)
    for t in range(6):
        for i in range(4):
            v = 0.1 * (4.0 if i == 3 else 1.0) + rng.normal(0, 1e-3)
            mine.observe(f"p{i}", v)
            theirs.observe(f"p{i}", v)
            assert _state(mine) == _state(theirs), (t, i)


# ---------------------------------------------------------------------------
# blocking_edge / classify_cause
# ---------------------------------------------------------------------------

def _step(peer, edge):
    return {"critical": {"peer": peer, "edge": edge, "self_us": 1000.0}}


LINKS = {"edges": {
    "a:1": {"b:2": {"bw": 5e8}, "c:3": {"bw": 1e9}},
    "b:2": {"a:1": {"bw": 2e7}, "c:3": {"bw": 0}},
    "c:3": {"a:1": {"bw": "bad"}, "d:4": {}},
}}

EDGE_CASES = [
    ("a:1", [_step("a:1", "b:2")], None),
    ("a:1", [_step("a:1", "b:2"), _step("a:1", "c:3")], LINKS),
    ("a:1", [_step("b:2", "c:3")], LINKS),
    ("b:2", [_step("a:1", "b:2")], LINKS),
    ("c:3", [], LINKS),
    ("d:4", [], LINKS),
    ("a:1", [_step("a:1", None), {"critical": None}], LINKS),
    ("z:9", None, None),
    ("b:2", [_step("b:2", "a:1")], {}),
    ("c:3", [{"critical": {"peer": "c:3"}}], {"edges": {"c:3": {"b:2": {"bw": 7.0}}}}),
]


@pytest.mark.parametrize("peer,steps,links", EDGE_CASES)
def test_blocking_edge_matches(peer, steps, links):
    assert straggler.blocking_edge(peer, steps, links) == rstraggler.blocking_edge(
        peer, steps, links)


@pytest.mark.parametrize("peer,steps,links", EDGE_CASES)
def test_classify_cause_matches_without_the_resource_planes(peer, steps, links):
    got = straggler.classify_cause(peer, steps, links)
    assert got == rstraggler.classify_cause(peer, steps, links, None, None)
    assert got[0] in ("network", "unknown")
    assert (got[1] is None) == (got[0] == "unknown")

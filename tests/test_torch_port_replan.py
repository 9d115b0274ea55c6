"""The port's measured-topology rounds and the walks under an adopted plan
(`kungfu_tpu_torch/collective/host_session.py`'s re-plan and demotion
rounds, `walks.py`'s reordered and weighted ring and `_run_hier`,
`zero.py`'s re-shard across a plan flip, `api.check_replan`) against the
JAX package's, in process; mirrors tests/test_replan.py.

- Worlds of k = 2-5 loopback peers of each package (one world per
  package and size for the module): the reordered, weighted ring, the
  reduce-scatter and all-gather under a plan, and the two-level walk
  (with a demoted rank that is still served) give each package's peers
  the same bits on the same seeded float payloads, and exact sums on
  integer ones.
- `check_replan` votes and adopts one digest (the slow edge routed
  around, audit and ledger records), is a local no-op when off, and a
  divergent plan raises the named RuntimeError without a hang;
  `check_demote` demotes and promotes by majority.
- ZeRO-1 across a mid-training re-plan and a flat → two-level flip holds
  the reference ZeRO's bits on the same plans.
- A kfrun world of 4 (ranks 0 and 2 the reference, 1 and 3 the port)
  under a shaped edge votes, exchanges its measured rows, adopts one
  plan digest and walks the same bits on every rank.

The reference's host C++ is built afresh and bound in place of its
numpy fallback (as `test_torch_port_engine.py` does). In-process worlds
bind port 0 outside 38000-38999; the kfrun world uses 12000-19999."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from kungfu_tpu.base.ops import ReduceOp as RReduceOp
from kungfu_tpu.base.workspace import Workspace as RWorkspace
from kungfu_tpu.collective import zero as rzero
from kungfu_tpu.collective.host_session import HostSession as RHostSession
from kungfu_tpu.plan import replan as rrp
from kungfu_tpu.telemetry import audit as raudit
from kungfu_tpu.telemetry import decisions as rdecisions
from kungfu_tpu_torch import api
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.collective import zero
from kungfu_tpu_torch.collective.host_session import HostSession
from kungfu_tpu_torch.plan import replan as rp
from kungfu_tpu_torch.plan import topology as topo
from kungfu_tpu_torch.telemetry import audit, decisions
from test_torch_port_runner import free_range, port_env
from test_torch_port_worlds import (  # noqa: F401 - fixtures used by name
    make_world, ref_native, run_all, small_arenas)
from test_torch_port_zero import close_all, sessions

REPO = Path(__file__).resolve().parent.parent
KS = (2, 3, 4, 5)


@pytest.fixture(scope="module")
def worlds(ref_native):
    """worlds(kind, k): a started world of k peers of `kind` ("port" or
    "ref"), one per (kind, k) for the module."""
    built = {}

    def get(kind, k):
        if (kind, k) not in built:
            built[(kind, k)] = make_world([kind] * k)
        return built[(kind, k)]

    yield get
    for world in built.values():
        for p in world:
            p.stop()


@pytest.fixture
def segment_everything(monkeypatch):
    for cls in (HostSession, RHostSession):
        monkeypatch.setattr(cls, "SEGMENT_MIN_BYTES", 0)


def _ws(sess, send, recv, name):
    """A SUM workspace of the session's package over numpy buffers."""
    if isinstance(sess, HostSession):
        return Workspace(send=torch.from_numpy(send), recv=torch.from_numpy(recv),
                         op=ReduceOp.SUM, name=name)
    return RWorkspace(send=send, recv=recv, op=RReduceOp.SUM, name=name)


def _both_plans(order, weights=None, gain=1.5):
    return (rp.RingPlan(order=order, weights=weights, gain=gain),
            rrp.RingPlan(order=order, weights=weights, gain=gain))


def _test_plan(k, weighted=True, seed=0):
    """tests/test_replan.py's deterministic plan: a permutation with rank
    0 pinned, optionally unequal weights; both packages' objects."""
    rng = np.random.default_rng(1234 + k + seed)
    order = (0,) + tuple(int(x) for x in rng.permutation(np.arange(1, k)))
    weights = None
    if weighted and k > 1:
        w = rng.random(k) + 0.2
        w = w / w.sum()
        weights = tuple(round(float(x), 9) for x in w)
    return _both_plans(order, weights)


def _hier_plans(k, demoted=()):
    """A two-level plan for k peers (heads not always the lowest rank),
    both packages' objects."""
    groups, heads = {2: (((0,), (1,)), (0, 1)), 3: (((1, 0), (2,)), (1, 2)),
                     4: (((1, 0), (3, 2)), (1, 3)), 5: (((1, 0), (3, 4, 2)), (1, 3))}[k]
    return (rp.HierPlan(groups=groups, heads=heads, demoted=tuple(demoted)),
            rrp.HierPlan(groups=groups, heads=heads, demoted=tuple(demoted)))


def _install(sess_list, plan, hier=False):
    for s in sess_list:
        if hier:
            s._hier_plan, s._ring_plan = plan, plan.as_ring_plan()
            s._demoted = plan.demoted
        else:
            s._ring_plan = plan


def _inputs(k, seed, sizes):
    """Per-case per-rank payloads: seeded floats (the sum order shows in
    the bits) and small integers (exact sums) for each size."""
    rng = np.random.default_rng(seed)
    cases = [(s, dt) for s in sizes for dt in (np.float32, np.int32)]
    return cases, {(ci, r): (rng.standard_normal(s).astype(np.float32) if dt == np.float32
                             else rng.integers(-8, 9, s).astype(np.int32))
                   for ci, (s, dt) in enumerate(cases) for r in range(k)}


def _allreduce_all(sess_list, cases, inputs, tag):
    """Every case's all-reduce on every rank; {(ci, r): result}."""
    out = {}

    def run(r, s):
        for ci in range(len(cases)):
            x = inputs[(ci, r)]
            y = np.empty_like(x)
            s.all_reduce(_ws(s, x, y, f"{tag}:{ci}"))
            out[(ci, r)] = y

    run_all([lambda r=r, s=s: run(r, s) for r, s in enumerate(sess_list)])
    return out


# ---------------------------------------------------------------------------
# walks under an adopted plan: the port's bits are the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["naive", "reorder", "weighted"])
@pytest.mark.parametrize("k", KS)
def test_reordered_weighted_ring_holds_the_references_bits(k, tag, worlds,
                                                           segment_everything):
    sizes = [1, k - 1, k + 1, 1000, 1001, 4 * k + 3]
    cases, inputs = _inputs(k, 42 + k, sizes)
    plans = {"naive": (None, None), "reorder": _test_plan(k, weighted=False),
             "weighted": _test_plan(k, weighted=True)}[tag]
    got = {}
    for kind, plan in zip(("port", "ref"), plans):
        ss = sessions(worlds(kind, k))
        _install(ss, plan)
        got[kind] = _allreduce_all(ss, cases, inputs, f"rpl:{tag}")
        close_all(ss)
    for ci, (size, dt) in enumerate(cases):
        first = got["port"][(ci, 0)]
        for r in range(k):
            assert got["port"][(ci, r)].tobytes() == got["ref"][(ci, r)].tobytes(), (ci, r)
            assert got["port"][(ci, r)].tobytes() == first.tobytes(), (ci, r)
        if dt == np.int32:
            np.testing.assert_array_equal(first, sum(inputs[(ci, r)] for r in range(k)))


@pytest.mark.parametrize("k", KS)
def test_reduce_scatter_and_all_gather_under_a_plan(k, worlds):
    """reduce_scatter returns the PLAN's owned bounds, the shards tile the
    payload, and rs + all_gather_shards reassembles the all-reduce bits,
    the same in both packages."""
    sizes = [1, k - 1, 1001, 5000]
    rng = np.random.default_rng(77 + k)
    inputs = {(si, r): rng.standard_normal(s).astype(np.float32)
              for si, s in enumerate(sizes) for r in range(k)}
    got = {}
    for kind, plan in zip(("port", "ref"), _test_plan(k, weighted=True, seed=3)):
        ss = sessions(worlds(kind, k))
        _install(ss, plan)
        res = {}

        def run(r, s):
            for si, n in enumerate(sizes):
                x = inputs[(si, r)]
                y = np.empty_like(x)
                b, e = s.reduce_scatter(_ws(s, x, y, f"rplrs:{si}"))
                assert (b, e) == s.owned_bounds(n) == topo.owned_segment_bounds(
                    n, k, r, order=plan.order, weights=plan.weights)
                full = np.zeros_like(x)
                full[b:e] = y[b:e]
                s.all_gather_shards(torch.from_numpy(full) if kind == "port" else full,
                                    f"rplag:{si}")
                res[(si, r)] = ((b, e), y[b:e].copy(), full)

        run_all([lambda r=r, s=s: run(r, s) for r, s in enumerate(ss)])
        close_all(ss)
        got[kind] = res
    for si, n in enumerate(sizes):
        covered = sorted(got["port"][(si, r)][0] for r in range(k))
        assert covered[0][0] == 0 and covered[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))
        for r in range(k):
            mine, theirs = got["port"][(si, r)], got["ref"][(si, r)]
            assert mine[0] == theirs[0]
            assert mine[1].tobytes() == theirs[1].tobytes()
            assert mine[2].tobytes() == theirs[2].tobytes() == got["port"][(si, 0)][2].tobytes()


# a host of one rank has no member left to demote: k 2 runs undemoted only
@pytest.mark.parametrize("k,demoted", [(k, d) for k in KS for d in (False, True)
                                       if not (d and k == 2)])
def test_two_level_walk_holds_the_references_bits(k, demoted, worlds, segment_everything):
    """_run_hier: the intra star reduce onto each head, the ring over the
    heads, the broadcast back; a demoted rank contributes nothing and is
    still served."""
    dem = () if not demoted else ((0,) if k == 3 else (2,))
    sizes = [1, k + 1, 1003, 4 * k + 3]
    cases, inputs = _inputs(k, 400 + k, sizes)
    got = {}
    for kind, plan in zip(("port", "ref"), _hier_plans(k, dem)):
        ss = sessions(worlds(kind, k))
        _install(ss, plan, hier=True)
        got[kind] = _allreduce_all(ss, cases, inputs, f"hier:{int(demoted)}")
        close_all(ss)
    active = [r for r in range(k) if r not in dem]
    for ci, (size, dt) in enumerate(cases):
        for r in range(k):
            assert got["port"][(ci, r)].tobytes() == got["ref"][(ci, r)].tobytes(), (ci, r)
            assert got["port"][(ci, r)].tobytes() == got["port"][(ci, 0)].tobytes(), (ci, r)
        if dt == np.int32:
            np.testing.assert_array_equal(got["port"][(ci, 0)],
                                          sum(inputs[(ci, r)] for r in active))


# ---------------------------------------------------------------------------
# the lockstep rounds
# ---------------------------------------------------------------------------

def _uniform(k, bw=200.0):
    m = np.full((k, k), bw, np.float64)
    np.fill_diagonal(m, 0.0)
    return m


def _crafted_matrix(k):
    m = _uniform(k)
    m[1, 2 % k] = 1.0
    return m


def _dcn_matrix(k, hosts, intra=1000.0, cross=5.0):
    m = np.full((k, k), cross, np.float64)
    for g in hosts:
        for i in g:
            for j in g:
                m[i, j] = intra
    np.fill_diagonal(m, 0.0)
    return m


def _round(ss, fn):
    """fn(rank, session) on every session at once; {rank: result}."""
    out = {}
    run_all([lambda r=r, s=s: out.__setitem__(r, fn(r, s)) for r, s in enumerate(ss)])
    return out


@pytest.mark.parametrize("kind", ["port", "ref"])
def test_check_replan_votes_and_adopts_one_plan(kind, worlds):
    k = 3
    ss = sessions(worlds(kind, k))
    m = _crafted_matrix(k)
    for s in ss:
        s.replan_mode = "auto"
        s.measured_matrix = lambda m=m: m.copy()
    ledger = decisions if kind == "port" else rdecisions
    log = audit if kind == "port" else raudit
    ledger.reset_ledger()
    try:
        assert all(v is None for v in _round(ss, lambda r, s: s.check_replan(want=False)).values())
        assert all(s.ring_plan() is None for s in ss)
        plans = _round(ss, lambda r, s: s.check_replan(want=r < 2, min_gain=1.0))
        assert all(p is not None for p in plans.values())
        assert len({p.to_bytes() for p in plans.values()}) == 1
        order = ss[0].ring_plan().order
        assert (1, 2) not in {(order[i], order[(i + 1) % k]) for i in range(k)}
        ev = [r for r in log.to_json() if r.get("kind") == "topology_replanned"][-1]
        assert ev["detail"]["new_order"] == list(order) and ev["detail"]["predicted_gain"] > 1.0
        recs = [r for r in ledger.get_ledger().records() if r.kind == "topology_replanned"]
        assert len(recs) == k and recs[0].predicted_gain > 1.0
        assert all(s._replan_seq == 2 for s in ss)
        # the walks stay exact under the adopted plan
        n = 20000
        res = _round(ss, lambda r, s: (lambda x, y: (s.all_reduce(_ws(s, x, y, "post")), y)[1])(
            np.full(n, r + 1, np.float32), np.empty(n, np.float32)))
        assert all((y == sum(range(1, k + 1))).all() for y in res.values())
        # the same matrix again: the plan is already optimal, no churn
        assert all(v is None for v in _round(
            ss, lambda r, s: s.check_replan(want=True, min_gain=1.0)).values())
        assert all(s._replan_seq == 3 for s in ss)
    finally:
        close_all(ss)
        ledger.reset_ledger()


@pytest.mark.parametrize("kind", ["port", "ref"])
def test_check_replan_off_is_a_local_no_op(kind, worlds):
    ss = sessions(worlds(kind, 2))
    try:
        assert ss[0].replan_mode == "off"
        assert ss[0].check_replan(want=True) is None  # alone: no collective, no hang
        assert ss[0]._replan_seq == 0
    finally:
        close_all(ss)


def test_a_divergent_plan_is_a_named_error_not_a_hang(worlds):
    ss = sessions(worlds("port", 2))
    errs = {}

    def run(r, s):
        plan = rp.RingPlan(order=(0, 1), weights=(0.3 + 0.2 * r, 0.7 - 0.2 * r))
        try:
            s.adopt_replan(plan)
        except RuntimeError as e:
            errs[r] = str(e)

    try:
        run_all([lambda r=r, s=s: run(r, s) for r, s in enumerate(ss)], join=60)
        assert set(errs) == {0, 1}
        assert all("re-plan diverged" in m for m in errs.values())
        assert all(s.ring_plan() is None for s in ss)
    finally:
        close_all(ss)


@pytest.mark.parametrize("kind", ["port", "ref"])
def test_check_demote_demotes_and_promotes_by_majority(kind, worlds):
    k = 4
    ss = sessions(worlds(kind, k))
    m = _dcn_matrix(k, [[0, 1], [2, 3]])
    for s in ss:
        s.replan_mode = "hier"
        s.measured_matrix = lambda m=m: m.copy()
    ledger = decisions if kind == "port" else rdecisions
    ledger.reset_ledger()
    try:
        got = _round(ss, lambda r, s: s.check_demote(demote=3 if r < 2 else None, tag="a"))
        assert all(v is None for v in got.values()) and all(s.demoted_peers() == () for s in ss)
        got = _round(ss, lambda r, s: s.check_demote(demote=3 if r != 3 else None, tag="b"))
        assert all(v is not None for v in got.values())
        assert all(s.demoted_peers() == (3,) and s.hier_plan().heads[1] == 2 for s in ss)
        assert len({s.hier_plan().to_bytes() for s in ss}) == 1
        _round(ss, lambda r, s: s.check_demote(promote=3, tag="c"))
        assert all(s.demoted_peers() == () for s in ss)
        kinds = [r.kind for r in ledger.get_ledger().records()]
        assert kinds.count("peer_demoted") == k and kinds.count("peer_promoted") == k
        assert all(s._replan_seq == 3 for s in ss)
    finally:
        close_all(ss)
        ledger.reset_ledger()


def test_api_check_replan_drives_the_default_peers_session(worlds, monkeypatch):
    ss = sessions(worlds("port", 2))
    try:
        class _P:
            pass

        holder = _P()
        monkeypatch.setattr(api, "get_default_peer", lambda: holder)
        holder.current_session = lambda: ss[0]
        assert api.check_replan(want=True) is False  # off: a local no-op
    finally:
        close_all(ss)


# ---------------------------------------------------------------------------
# ZeRO-1 across a plan flip
# ---------------------------------------------------------------------------

def _zero_run(ss, kind, p0, rounds, flips, name):
    """Sharded steps with a plan adoption before the rounds named in
    `flips` ({round: plan}); each rank's params after the last round."""
    k = len(ss)
    params = {r: [p.copy() for p in p0] for r in range(k)}
    zs = {}

    def build(r, s):
        if kind == "port":
            zs[r] = zero.ShardedUpdateSession([torch.from_numpy(p) for p in params[r]],
                                              zero.ShardedSGD(0.1, 0.9), name=name, session=s)
        else:
            zs[r] = rzero.ShardedUpdateSession(params[r], rzero.ShardedSGD(0.1, 0.9),
                                               name=name, session=s)

    run_all([lambda r=r, s=s: build(r, s) for r, s in enumerate(ss)])
    for i, grads in enumerate(rounds):
        if i in flips:
            run_all([lambda s=s: s.adopt_replan(flips[i]) for s in ss])
            for r, s in enumerate(ss):
                for b in zs[r]._buckets:
                    assert (b.ob, b.oe) == s.owned_bounds(b.total)
        run_all([lambda r=r: zs[r].step([torch.from_numpy(g) if kind == "port" else g
                                         for g in grads[r]]) for r in range(k)])
    return params


# a two-level plan of two ranks has no intra leg: k 2 flips flat only
@pytest.mark.parametrize("k,flip", [(2, "flat"), (3, "flat"), (4, "flat"),
                                    (3, "flat_then_hier"), (4, "flat_then_hier")])
def test_zero_survives_a_plan_flip_as_the_reference(k, flip, worlds):
    rng = np.random.default_rng(500 + k)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in (5, 100, 333, 20)]
    rounds = [[[rng.standard_normal(p.size).astype(np.float32) for p in p0]
               for _ in range(k)] for _ in range(4)]
    flat = _test_plan(k, weighted=True, seed=13)
    hier = _hier_plans(k)
    got = {}
    for i, kind in enumerate(("port", "ref")):
        flips = {1: flat[i]} if flip == "flat" else {1: flat[i], 2: hier[i]}
        ss = sessions(worlds(kind, k))
        got[kind] = _zero_run(ss, kind, p0, rounds, flips, f"z{flip}")
        close_all(ss)
    for r in range(k):
        for i in range(len(p0)):
            assert got["port"][r][i].tobytes() == got["ref"][r][i].tobytes(), (r, i)
            assert got["port"][r][i].tobytes() == got["port"][0][i].tobytes(), (r, i)


# ---------------------------------------------------------------------------
# a mixed kfrun world under a shaped edge
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""\
    import hashlib, json, os
    me = os.environ["KF_SELF_SPEC"]
    specs = os.environ["KF_INIT_PEERS"].split(",")
    rank = specs.index(me)
    ref = str(rank) in os.environ["RP_REF_RANKS"].split(",")
    import numpy as np
    if ref:
        from kungfu_tpu import api
        from kungfu_tpu.plan import replan as rp
        from kungfu_tpu.peer import get_default_peer
        as_np = np.asarray
        arr = lambda x: x
    else:
        import torch
        from kungfu_tpu_torch import api
        from kungfu_tpu_torch.plan import replan as rp
        from kungfu_tpu_torch.peer import get_default_peer
        as_np = lambda t: t.numpy()
        arr = torch.from_numpy
    peer = get_default_peer()
    sess = peer.current_session()
    rng = np.random.default_rng(9000 + rank)
    x = rng.standard_normal(300_001).astype(np.float32)
    digests = []
    for step in range(3):  # the rank-order ring: rank 1 -> 2 is shaped
        digests.append(hashlib.sha256(as_np(api.all_reduce_array(arr(x), name=f"s{step}"))
                                      .tobytes()).hexdigest())
    adopted = api.check_replan(want=True, min_gain=1.0)
    plan = sess.ring_plan()
    for step in range(3, 5):
        digests.append(hashlib.sha256(as_np(api.all_reduce_array(arr(x), name=f"s{step}"))
                                      .tobytes()).hexdigest())
    print("RP " + json.dumps({
        "rank": rank, "ref": ref, "adopted": adopted, "digests": digests,
        "order": list(plan.order) if plan is not None else None,
        "digest": rp.plan_digest(plan).hex(), "seq": sess._replan_seq}), flush=True)
""")


@pytest.fixture(scope="module")
def shaped_mixed_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rpworld")
    (tmp / "w.py").write_text(WORKER)
    base = free_range(4)
    specs = [f"127.0.0.1:{base + i}" for i in range(4)]
    env = port_env()
    env.update(RP_REF_RANKS="0,2", KF_TELEMETRY="metrics", KF_CONFIG_REPLAN="auto",
               KF_CONFIG_ALGO="segmented", KF_CONFIG_SHM="0",
               KF_SHAPE_LINKS=f"{specs[1]}>{specs[2]}=bw:8MiB",
               KF_TELEMETRY_DIR=str(tmp))
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.runner.cli", "-np", "4", "-H",
         "127.0.0.1:4", "-port-range", f"{base}-{base + 3}", "-runner-port",
         str(free_range(1)), "--", sys.executable, str(tmp / "w.py")],
        env=env, capture_output=True, text=True, timeout=240, cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-4000:]}"
    res = [json.loads(line.split("RP ", 1)[1]) for line in r.stdout.splitlines()
           if "RP " in line]
    return {x["rank"]: x for x in res}


def test_a_mixed_world_under_a_shaped_edge_adopts_one_plan(shaped_mixed_world):
    ranks = shaped_mixed_world
    assert sorted(ranks) == [0, 1, 2, 3]
    assert [ranks[r]["ref"] for r in range(4)] == [True, False, True, False]
    assert all(ranks[r]["adopted"] for r in range(4))
    assert len({ranks[r]["digest"] for r in range(4)}) == 1
    order = ranks[0]["order"]
    assert (1, 2) not in {(order[i], order[(i + 1) % 4]) for i in range(4)}
    assert all(ranks[r]["seq"] == ranks[0]["seq"] for r in range(4))


@pytest.mark.parametrize("step", range(5))
def test_a_mixed_world_walks_the_same_bits_before_and_after(shaped_mixed_world, step):
    assert len({shaped_mixed_world[r]["digests"][step] for r in range(4)}) == 1

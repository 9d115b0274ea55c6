"""The port's async collective scheduler
(`kungfu_tpu_torch/collective/scheduler.py`) against the JAX package's
(`kungfu_tpu/collective/scheduler.py`), in process; mirrors
tests/test_scheduler.py.

- Port worlds of k = 2, 3, 4 loopback peers (one per size for the
  module): per-rank shuffled submission over several rounds, bit-identical
  to the port's synchronous group on the same inputs (exact payloads, a
  multi-bucket plan, singles, mixed dtypes; then gradient-like floats and
  the bf16 wire); the named divergence error, the submit-contract errors,
  a walk error reaching flush, the empty and round-aware flushes, and a
  mid-flight scheduler drained by `Peer._update_to`.
- The plan and the registry digest, as pure functions, equal the
  reference's `_build_plan` on the same registries.
- A mixed world of 2 reference and 2 port peers with KF_CONFIG_ASYNC=on,
  in both rank layouts: every peer holds the bits an all-reference world
  computes on the same inputs and submission orders.

Every session is closed; the last case asserts that no `kf-sched-*`
thread outlives the module. Ports are reserved by binding 0, never in
kfrun's 38000-38999."""

import threading
import types

import numpy as np
import pytest
import torch

from kungfu_tpu.base.ops import ReduceOp as RReduceOp
from kungfu_tpu.base.strategy import Strategy as RStrategy
from kungfu_tpu.base.workspace import Workspace as RWorkspace
from kungfu_tpu.collective.host_session import HostSession as RHostSession
from kungfu_tpu.collective.scheduler import CollectiveScheduler as RScheduler
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.strategy import Strategy
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.collective import scheduler as sched_mod
from kungfu_tpu_torch.collective.host_session import HostSession
from kungfu_tpu_torch.collective.scheduler import CollectiveScheduler, SchedulerClosed
from kungfu_tpu_torch.peer import Peer
from test_torch_port_worlds import (  # noqa: F401 - fixtures used by name
    PerThreadCounter, make_world, new_epoch, ref_native, run_all, small_arenas)


# tests/test_scheduler.py's tensor set: 6 f32 (fused; a small bucket cap
# splits them), 2 int32 singles (below FUSE_MIN), 1 f64 single
SIZES = {np.float32: [100, 300, 50, 700, 20, 401], np.int32: [64, 9], np.float64: [33]}


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------

def sessions(world, strategy="RING_SEGMENTED", timeout=60.0):
    out = []
    for p in world:
        if isinstance(p, Peer):
            out.append(HostSession(Strategy[strategy], p.self_id, p.config.peers, p.client,
                                   p.collective, timeout=timeout))
        else:
            out.append(RHostSession(RStrategy[strategy], p.self_id, p.config.peers, p.client,
                                    p.collective, timeout=timeout))
    return out


def close_all(sess):
    for s in sess:
        s.close(timeout=10)


@pytest.fixture(scope="module")
def worlds():
    built = {}

    def get(k):
        if k not in built:
            built[k] = make_world(["port"] * k)
        return built[k]

    yield get
    for world in built.values():
        for p in world:
            p.stop()


@pytest.fixture
def async_on(monkeypatch):
    monkeypatch.setenv("KF_CONFIG_ASYNC", "on")
    for cls in (HostSession, RHostSession):
        monkeypatch.setattr(cls, "SEGMENT_MIN_BYTES", 0)
        monkeypatch.setattr(cls, "GROUP_BUCKET_BYTES", 1200)


def exact_inputs(rng, k):
    """Integer-valued tensors of every dtype: sums exact in any order."""
    return {r: [rng.integers(-8, 9, s).astype(dt) for dt, sizes in SIZES.items()
                for s in sizes] for r in range(k)}


def float_inputs(rng, k, sizes=(900, 3000, 17, 4100, 250, 6000)):
    """Gradient-like f32: mixed signs over four orders of magnitude."""
    return {r: [(rng.normal(0, 1, s) * 10.0 ** rng.integers(-4, 0, s)).astype(np.float32)
                for s in sizes] for r in range(k)}


def _ws(sess, x, out, name):
    if isinstance(sess, HostSession):
        return Workspace(torch.from_numpy(x), out, ReduceOp.SUM, name)
    return RWorkspace(send=x, recv=out, op=RReduceOp.SUM, name=name)


def _out(sess, x):
    return torch.empty(x.size, dtype=torch.from_numpy(x).dtype) if isinstance(
        sess, HostSession) else np.empty_like(x)


def _np(o):
    return o.numpy() if isinstance(o, torch.Tensor) else o


def sync_group(sess, ins, tag):
    """The synchronous group path's results on the same inputs."""
    outs = {}

    def run(r):
        s = sess[r]
        res = [_out(s, x) for x in ins[r]]
        s.group_all_reduce([_ws(s, x, o, f"sync:{tag}:{i}") for i, (x, o) in
                            enumerate(zip(ins[r], res))])
        outs[r] = [_np(o) for o in res]

    run_all([lambda r=r: run(r) for r in range(len(sess))])
    return outs


def async_rounds(sess, ins, rounds, tag, prio_first=True):
    """`rounds` scheduler rounds per peer, each submitting in a per-rank
    shuffled order; round 0 pins the registered order by priority. Returns
    every round's results per rank."""
    n = len(ins[0])
    got = {}

    def run(r):
        s = sess[r]
        sched = s.scheduler()
        order_rng = np.random.default_rng(1000 * r)
        got[r] = []
        for rnd in range(rounds):
            res = [_out(s, x) for x in ins[r]]
            for i in order_rng.permutation(n):
                sched.submit(_ws(s, ins[r][i], res[i], f"{tag}:{i}"),
                             priority=int(i) if (rnd == 0 and prio_first) else None)
            sched.flush(timeout=90)
            got[r].append([_np(o).copy() for o in res])

    run_all([lambda r=r: run(r) for r in range(len(sess))])
    return got


# ---------------------------------------------------------------------------
# port worlds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", ["exact", "float"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_out_of_order_submission_bit_identical(k, payload, worlds, async_on):
    world = worlds(k)
    rng = np.random.default_rng(11 + k)
    ins = exact_inputs(rng, k) if payload == "exact" else float_inputs(rng, k)
    want = sync_group(sessions(world), ins, f"ref{k}{payload}")
    sess = sessions(world)
    rounds = 3
    got = async_rounds(sess, ins, rounds, f"grad{payload}")
    for r in range(k):
        for rnd in range(rounds):
            for i, o in enumerate(got[r][rnd]):
                assert o.tobytes() == want[r][i].tobytes(), (r, rnd, i)
    if payload == "exact":
        for i in range(len(ins[0])):
            np.testing.assert_array_equal(want[0][i], sum(ins[r][i] for r in range(k)))
    st = sess[0].scheduler().stats()
    assert st["rounds"] == rounds and st["units"] >= rounds * 4 and st["buckets"] >= rounds * 2
    close_all(sess)


@pytest.mark.parametrize("k", [2, 3])
def test_async_with_wire_codec_matches_sync(k, worlds, async_on, monkeypatch):
    monkeypatch.setenv("KF_CONFIG_WIRE", "bf16")
    monkeypatch.setattr(HostSession, "WIRE_MIN_BYTES", 0)
    world = worlds(k)
    ins = float_inputs(np.random.default_rng(77 + k), k)
    want = sync_group(sessions(world), ins, f"wref{k}")
    sess = sessions(world)
    got = async_rounds(sess, ins, 2, "wg")
    for r in range(k):
        for rnd in range(2):
            for i, o in enumerate(got[r][rnd]):
                assert o.tobytes() == want[r][i].tobytes(), (r, rnd, i)
    assert any(codec == "bf16" for (_, _, codec) in sess[0].wire_bytes)
    close_all(sess)


def test_registration_divergence_raises_named_error(worlds, async_on):
    sess = sessions(worlds(2), "STAR", timeout=20)
    failures = {}

    def run(r):
        x = torch.ones(10)
        sess[r].scheduler().submit(Workspace(x, torch.empty_like(x), ReduceOp.SUM,
                                             "a" if r == 0 else "b"))
        try:
            sess[r].scheduler().flush(timeout=30)
        except RuntimeError as e:
            failures[r] = str(e)

    run_all([lambda r=r: run(r) for r in range(2)])
    assert set(failures) == {0, 1}
    assert all("registration diverged" in m for m in failures.values())
    close_all(sess)


def test_submit_contract_errors(worlds, async_on):
    sess = sessions(worlds(2), "STAR", timeout=20)

    def first_round(r):
        sched = sess[r].scheduler()
        for i in range(2):
            x = torch.full((8,), r + 1.0)
            sched.submit(Workspace(x, torch.empty_like(x), ReduceOp.SUM, f"t:{i}"))
        sched.flush(timeout=30)

    run_all([lambda r=r: first_round(r) for r in range(2)])
    sched = sess[0].scheduler()
    x = torch.ones(8)
    with pytest.raises(ValueError, match="unregistered"):
        sched.submit(Workspace(x, torch.empty_like(x), ReduceOp.SUM, "rogue"))
    with pytest.raises(ValueError, match="unregistered"):  # same name, other size
        sched.submit(Workspace(torch.ones(9), torch.empty(9), ReduceOp.SUM, "t:0"))
    sched.submit(Workspace(x, torch.empty_like(x), ReduceOp.SUM, "t:0"))
    with pytest.raises(ValueError, match="submitted twice"):
        sched.submit(Workspace(x, torch.empty_like(x), ReduceOp.SUM, "t:0"))
    with pytest.raises(RuntimeError, match="not submitted this round"):
        sched.flush(timeout=5)
    close_all(sess)


def test_duplicate_first_round_and_handlerless_zero_raise(worlds, async_on):
    sess = sessions(worlds(2), "STAR", timeout=20)
    sched = sess[0].scheduler()
    x = torch.ones(4)
    sched.submit(Workspace(x, torch.empty_like(x), ReduceOp.SUM, "d"))
    sched.submit(Workspace(x, torch.empty_like(x), ReduceOp.SUM, "d"))
    with pytest.raises(ValueError, match="duplicate tensors"):
        sched.flush(timeout=5)
    close_all(sess)


def test_walk_error_propagates_real_error(worlds, async_on, monkeypatch):
    sess = sessions(worlds(2), "STAR", timeout=20)

    def ok_round(r):
        x = torch.full((8,), r + 1.0)
        sess[r].scheduler().submit(Workspace(x, torch.empty_like(x), ReduceOp.SUM, "g"))
        sess[r].scheduler().flush(timeout=30)

    run_all([lambda r=r: ok_round(r) for r in range(2)])

    class Boom(RuntimeError):
        pass

    def broken_walk(w, cancel=None, defer_decode=False):
        raise Boom("injected transport failure")

    for s in sess:
        monkeypatch.setattr(s, "_allreduce_ws", broken_walk, raising=False)
    failures = {}

    def bad_round(r):
        x = torch.full((8,), r + 1.0)
        sess[r].scheduler().submit(Workspace(x, torch.empty_like(x), ReduceOp.SUM, "g"))
        try:
            sess[r].scheduler().flush(timeout=30)
        except Boom as e:
            failures[r] = str(e)

    run_all([lambda r=r: bad_round(r) for r in range(2)])
    assert set(failures) == {0, 1}
    assert all("injected transport failure" in m for m in failures.values())
    with pytest.raises(Boom):  # the scheduler is dead
        sess[0].scheduler().submit(Workspace(torch.ones(8), torch.empty(8), ReduceOp.SUM, "g"))
    close_all(sess)


def test_empty_flush_noop_and_round_aware_flush(worlds, async_on):
    sess = sessions(worlds(2), "STAR", timeout=20)

    def run(r):
        sched = sess[r].scheduler()
        sched.flush(timeout=5)  # pre-registration: no-op, no consensus
        assert sched._registry is None
        x = torch.full((8,), r + 1.0)
        o = torch.empty_like(x)
        rnd = sched.round_index()
        sched.submit(Workspace(x, o, ReduceOp.SUM, "e"))
        sched.flush_round(rnd, timeout=30)  # first wait: flushes
        assert torch.equal(o, torch.full((8,), 3.0))
        sched.flush_round(rnd, timeout=5)  # second wait: no-op
        sched.flush(timeout=5)  # clean boundary: no-op
        assert sched.round_index() == rnd + 1

    run_all([lambda r=r: run(r) for r in range(2)])
    close_all(sess)


def test_update_to_drains_a_scheduler_mid_flight(async_on):
    """A half-submitted round in flight when the peers move to a new
    epoch: `_update_to` closes the old scheduler (no hang, no orphan
    thread), its handle raises SchedulerClosed, the new session works."""
    world = make_world(["port", "port"])
    try:
        def round1(p):
            sched = p.current_session().scheduler()
            for i in range(3):
                x = torch.full((16,), p.rank + 1.0)
                sched.submit(Workspace(x, torch.empty_like(x), ReduceOp.SUM, f"rz:{i}"))
            sched.flush(timeout=60)

        run_all([lambda p=p: round1(p) for p in world])
        old = [p.current_session().scheduler() for p in world]
        old_threads = [list(s._threads) for s in old]
        assert all(len(ts) == 4 for ts in old_threads)
        for p in world:  # the launcher now waits for rz:0, first in the plan
            x = torch.ones(16)
            p.current_session().scheduler().submit(
                Workspace(x, torch.empty_like(x), ReduceOp.SUM, "rz:2"))

        def next_epoch(p):
            p.cluster_version = 1
            assert p._update_to(p.config.peers)

        run_all([lambda p=p: next_epoch(p) for p in world])
        for ts in old_threads:
            for t in ts:
                t.join(10)
                assert not t.is_alive(), "scheduler thread outlived its epoch"
        with pytest.raises(SchedulerClosed):
            old[0].flush(timeout=5)
        res = {}

        def round2(p):
            sched = p.current_session().scheduler()
            assert sched is not old[p.rank]
            x = torch.full((4,), 7.0)
            o = torch.empty_like(x)
            sched.submit(Workspace(x, o, ReduceOp.SUM, "rz:new"))
            sched.flush(timeout=30)
            res[p.rank] = o

        run_all([lambda p=p: round2(p) for p in world])
        assert all(torch.equal(o, torch.full((4,), 14.0)) for o in res.values())
    finally:
        for p in world:
            p.stop()


def test_closed_session_refuses_a_scheduler(worlds):
    (s,) = sessions(worlds(2)[:1], "STAR")
    s.close()
    with pytest.raises(SchedulerClosed):
        s.scheduler()


# ---------------------------------------------------------------------------
# the async api
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("calls", ["per_tensor", "whole_set"])
@pytest.mark.parametrize("with_outs", [False, True])
@pytest.mark.parametrize("mode", ["off", "on"])
def test_api_group_all_reduce_async_equals_the_synchronous_group(mode, with_outs, calls,
                                                                 worlds, monkeypatch):
    """3 rounds of per-tensor submission (1-element lists; the first round
    in the same order on every rank, which it registers, later ones
    shuffled per rank where the scheduler is on) or of one whole-set call,
    then wait() on every handle: the results are the synchronous api's
    bits, shapes and dtypes, with the scheduler on and off (the eager
    fallback under per-call names)."""
    from kungfu_tpu_torch import api

    monkeypatch.setenv("KF_CONFIG_ASYNC", mode)
    monkeypatch.setattr(HostSession, "GROUP_BUCKET_BYTES", 4096)
    monkeypatch.setattr(api, "_async_seq", PerThreadCounter())
    tls = threading.local()
    monkeypatch.setattr(api, "get_default_peer", lambda: tls.peer)
    world = worlds(3)

    new_epoch(world)  # a session reads KF_CONFIG_ASYNC when it starts
    shapes = [(3, 4), (50,), (7, 7), (1,), (300,)]
    rng = np.random.default_rng(3)
    xs = {r: [[torch.from_numpy((rng.normal(0, 1, s) * 10.0 ** rng.integers(-3, 0, s))
                                .astype(np.float32)) for s in shapes] for _ in range(3)]
          for r in range(3)}
    got, want = {}, {}

    def run(r):
        tls.peer = world[r]
        order = np.random.default_rng(r)
        got[r], want[r] = [], []
        for rnd in range(3):
            outs = [torch.empty(s) for s in shapes] if with_outs else None
            if calls == "whole_set":
                whole = api.group_all_reduce_async(xs[r][rnd], name="whole", outs=outs)
                got[r].append(whole.wait(timeout=60))
            else:
                handles = {}
                shuffle = rnd > 0 and mode == "on"
                for i in (order.permutation(len(shapes)) if shuffle else range(len(shapes))):
                    handles[int(i)] = api.group_all_reduce_async(
                        [xs[r][rnd][i]], name=f"t{i}",
                        outs=None if outs is None else [outs[i]])
                api.flush_async()
                got[r].append([handles[i].wait()[0] for i in range(len(shapes))])
            want[r].append(api.group_all_reduce_arrays(xs[r][rnd], name=f"sync{rnd}"))

    run_all([lambda r=r: run(r) for r in range(3)])
    for r in range(3):
        for rnd in range(3):
            assert len(got[r][rnd]) == len(shapes)
            for i, g in enumerate(got[r][rnd]):
                w = want[r][rnd][i]
                assert g.shape == w.shape and g.dtype == w.dtype
                assert g.numpy().tobytes() == w.numpy().tobytes(), (r, rnd, i)
    sess = world[0].current_session()
    assert sess.async_enabled() == (mode == "on")
    if mode == "on":
        assert sess.scheduler().stats()["rounds"] == 3
    run_all([lambda p=p: p.current_session().close() for p in world])


# ---------------------------------------------------------------------------
# the plan and the registry digest, against the reference's
# ---------------------------------------------------------------------------

class _Handler:
    """A stand-in sharded handler: buckets of two in registered order."""

    def plan_units(self, zero_keys):
        return [list(zero_keys[i:i + 2]) for i in range(0, len(zero_keys), 2)]


def _registry(rng):
    dts = ["<f4", "<f4", "<f4", "<i4", "<f8", "<V2", "|u1"]
    out = []
    for i in range(int(rng.integers(1, 24))):
        out.append((f"t{i}", int(rng.integers(1, 600)), dts[int(rng.integers(len(dts)))],
                    int(rng.integers(0, 2)), "zero" if rng.random() < 0.2 else "ar"))
    return out


@pytest.mark.parametrize("cap", [1, 400, 1200, 64 << 20])
@pytest.mark.parametrize("seed", range(6))
def test_plan_equals_the_references_build_plan(seed, cap):
    rng = np.random.default_rng(seed)
    registry = _registry(rng)
    sess = types.SimpleNamespace(FUSE_MIN_TENSORS=4, GROUP_BUCKET_BYTES=cap, cluster_version=0,
                                 timeout=10.0)
    mine = CollectiveScheduler(sess)
    ref = RScheduler(sess)
    mine._handler = ref._handler = _Handler()
    got = [(u.index, u.keys, u.fused, u.kind, u.zindex) for u in mine._build_plan(registry)]
    want = [(u.index, u.keys, u.fused, u.kind, u.zindex) for u in ref._build_plan(registry)]
    assert got == want


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64, np.uint8,
                                   np.float16, "bf16"])
def test_registry_keys_match_the_references(dtype):
    """The key (and so the consensus digest) of a workspace is the
    reference's for the same tensor."""
    from kungfu_tpu.collective.scheduler import _key_of as rkey

    if dtype == "bf16":
        import ml_dtypes

        x = torch.ones(5, dtype=torch.bfloat16)
        xr = np.ones(5, ml_dtypes.bfloat16)
    else:
        xr = np.ones(5, dtype)
        x = torch.from_numpy(xr)
    for kind in ("ar", "zero"):
        assert sched_mod._key_of(Workspace(x, x, ReduceOp.MIN, "n"), kind) == rkey(
            RWorkspace(send=xr, recv=xr, op=RReduceOp.MIN, name="n"), kind)


# ---------------------------------------------------------------------------
# the mixed world
# ---------------------------------------------------------------------------

LAYOUTS = {"ref_first": ["ref", "port", "ref", "port"],
           "port_first": ["port", "ref", "port", "ref"]}
MIXED_ROUNDS = 3


@pytest.fixture(scope="module")
def mixed(ref_native):
    """The async rounds on each mixed world and on an all-reference world,
    same inputs and orders: {(layout, payload): (mixed results, reference
    results)}."""
    results = {}
    ref_world = make_world(["ref"] * 4)
    mixed_worlds = {name: make_world(kinds) for name, kinds in LAYOUTS.items()}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("KF_CONFIG_ASYNC", "on")
            for cls in (HostSession, RHostSession):
                mp.setattr(cls, "SEGMENT_MIN_BYTES", 0)
                mp.setattr(cls, "GROUP_BUCKET_BYTES", 1200)
            for payload in ("exact", "float"):
                rng = np.random.default_rng(5)
                ins = exact_inputs(rng, 4) if payload == "exact" else float_inputs(rng, 4)
                rs = sessions(ref_world)
                want = async_rounds(rs, ins, MIXED_ROUNDS, f"mx{payload}")
                close_all(rs)
                for name, world in mixed_worlds.items():
                    ms = sessions(world)
                    results[(name, payload)] = (async_rounds(ms, ins, MIXED_ROUNDS,
                                                             f"mx{payload}"), want)
                    close_all(ms)
        yield results
    finally:
        for p in ref_world + [p for w in mixed_worlds.values() for p in w]:
            p.stop()


@pytest.mark.parametrize("rnd", range(MIXED_ROUNDS))
@pytest.mark.parametrize("payload", ["exact", "float"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mixed_world_holds_the_reference_worlds_bits(layout, payload, rnd, mixed):
    got, want = mixed[(layout, payload)]
    for r in range(4):
        for i, o in enumerate(got[r][rnd]):
            assert o.dtype == want[0][rnd][i].dtype
            assert o.tobytes() == want[0][rnd][i].tobytes(), (r, i)
            assert want[r][rnd][i].tobytes() == want[0][rnd][i].tobytes()


def test_no_scheduler_thread_outlives_the_module():
    alive = [t.name for t in threading.enumerate() if t.name.startswith("kf-sched-")]
    assert not alive, alive

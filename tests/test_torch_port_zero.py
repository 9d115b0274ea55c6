"""The port's ZeRO-1 sharded update (`kungfu_tpu_torch/collective/zero.py`,
`api.sharded_update_session`) against the JAX package's
(`kungfu_tpu/collective/zero.py`), in process; mirrors tests/test_zero.py.

- `bucket_layout` and `ShardedSGD.apply` bit for bit against the
  reference's on the same inputs.
- Port worlds of k = 2, 3, 4: the synchronous sharded step (plain SGD) and
  the scheduler-driven one (momentum, shuffled submission, back-to-back
  rounds) bit-identical to replicated SGD on exact payloads, and to the
  reference's ShardedUpdateSession run in an all-reference world on
  gradient-like floats; the bf16 weight all-gather within one bf16 step
  of the f32 reference; KF_CONFIG_ZERO in the knob consensus and its
  resolution; `export_state` blobs byte-equal to the reference's, and a
  re-shard across epochs at k 2 → 4 and 4 → 2; the drain on close, the
  handler rules and a mixed sharded + allreduce round.
- A mixed world of 2 reference and 2 port peers running the sharded step
  (sync and async): parameters and exported state equal an all-reference
  world's bits.

Every session is closed; the last case asserts that no `kf-sched-*`
thread outlives the module."""

import threading
import time

import numpy as np
import pytest
import torch

from kungfu_tpu.base.strategy import Strategy as RStrategy
from kungfu_tpu.collective import zero as rzero
from kungfu_tpu.collective.host_session import HostSession as RHostSession
from kungfu_tpu.plan.peer import PeerID as RPeerID, PeerList as RPeerList
from kungfu_tpu_torch import api
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.strategy import Strategy
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.collective import zero
from kungfu_tpu_torch.collective.host_session import HostSession
from kungfu_tpu_torch.collective.scheduler import SchedulerClosed
from kungfu_tpu_torch.peer import Peer
from kungfu_tpu_torch.plan.peer import PeerID, PeerList
from test_torch_port_worlds import (  # noqa: F401 - fixtures used by name
    make_world, ref_native, run_all, small_arenas)

SIZES = (5, 100, 333, 700, 20, 401)  # tests/test_zero.py's


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------

def sessions(world, subset=None, timeout=60.0):
    """Fresh RING_SEGMENTED sessions over the live transports; `subset`
    keeps the first m peers (a smaller epoch over the same transports: the
    in-process stand-in for an elastic resize)."""
    members = world if subset is None else world[:subset]
    pl = PeerList(PeerID(q.self_id.host, q.self_id.port) for q in members)
    rpl = RPeerList([RPeerID(q.self_id.host, q.self_id.port) for q in members])
    out = []
    for p in members:
        if isinstance(p, Peer):
            out.append(HostSession(Strategy.RING_SEGMENTED, p.self_id, pl, p.client,
                                   p.collective, timeout=timeout))
        else:
            out.append(RHostSession(RStrategy.RING_SEGMENTED, p.self_id, rpl, p.client,
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


def replicated_sgd(p0, grad_rounds, k, lr, momentum=0.0):
    """tests/test_zero.py's replicated reference: the averaged gradient
    sum and the torch-SGD formula, full-size state."""
    ref = [p.copy() for p in p0]
    bufs = [np.zeros(p.size, np.float32) for p in p0]
    for grads in grad_rounds:
        for i in range(len(ref)):
            g = grads[0][i].astype(np.float32).copy()
            for r in range(1, k):
                g = g + grads[r][i]
            g = g * np.float32(1.0 / k)
            if momentum:
                bufs[i] = np.float32(momentum) * bufs[i] + g
                g = bufs[i]
            ref[i] = ref[i] - np.float32(lr) * g
    return ref


def zs_of(sess, params, lr, momentum=0.0, name="z", restore_state=None):
    """A ShardedUpdateSession of the session's package over numpy params
    (a port session gets tensors viewing them)."""
    if isinstance(sess, HostSession):
        return zero.ShardedUpdateSession([torch.from_numpy(p) for p in params],
                                         zero.ShardedSGD(lr, momentum), name=name, session=sess,
                                         restore_state=restore_state)
    return rzero.ShardedUpdateSession(params, rzero.ShardedSGD(lr, momentum), name=name,
                                      session=sess, restore_state=restore_state)


def _g(sess, g):
    return torch.from_numpy(g) if isinstance(sess, HostSession) else g


def run_sharded(sess, p0, grads, lr, momentum=0.0, mode="sync", name="z"):
    """`len(grads)` sharded steps on every session from p0; returns each
    rank's params (numpy) and exported state blob."""
    res = {}

    def run(r):
        s = sess[r]
        params = [p.copy() for p in p0]
        zs = zs_of(s, params, lr, momentum, name)
        order = np.random.default_rng(1000 * r)
        for rnd in range(len(grads)):
            if mode == "sync":
                zs.step([_g(s, g.copy()) for g in grads[rnd][r]])
            else:
                for i in order.permutation(len(p0)):
                    zs.submit_grad(int(i), _g(s, grads[rnd][r][int(i)].copy()))
                zs.flush(timeout=90)
        if mode != "sync":
            zs.wait_params(timeout=60)
        res[r] = (params, zs.export_state(), zs.state_bytes())

    run_all([lambda r=r: run(r) for r in range(len(sess))])
    return res


def exact_rounds(rng, k, rounds, sizes=SIZES):
    return [{r: [rng.integers(-8, 9, s).astype(np.float32) for s in sizes] for r in range(k)}
            for _ in range(rounds)]


def float_rounds(rng, k, rounds, sizes=SIZES):
    return [{r: [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in sizes]
             for r in range(k)} for _ in range(rounds)]


# ---------------------------------------------------------------------------
# pure functions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1, 64, 400, 1200, 1 << 20])
@pytest.mark.parametrize("seed", range(4))
def test_bucket_layout_matches_the_reference(seed, cap):
    sizes = np.random.default_rng(seed).integers(1, 500, 30).tolist()
    assert zero.bucket_layout(sizes, cap) == rzero.bucket_layout(sizes, cap)
    assert zero.bucket_layout(sizes, cap, 2) == rzero.bucket_layout(sizes, cap, 2)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("scale", [1.0, 0.5, 1 / 3, 0.25])
@pytest.mark.parametrize("lr", [0.1, 0.05, 3e-4])
def test_sharded_sgd_apply_is_bitwise_the_references(lr, scale, momentum):
    rng = np.random.default_rng(int(lr * 1e4) + int(scale * 100) + int(momentum * 10))
    p = rng.standard_normal(10_001).astype(np.float32)
    st_r = rzero.ShardedSGD(lr, momentum).init(p.size)
    st_p = zero.ShardedSGD(lr, momentum).init(p.size)
    pr, pp = p.copy(), torch.from_numpy(p.copy())
    for _ in range(3):
        g = (rng.standard_normal(p.size) * 10.0 ** rng.integers(-4, 1, p.size)).astype(np.float32)
        rzero.ShardedSGD(lr, momentum).apply(pr, g.copy(), st_r, scale)
        zero.ShardedSGD(lr, momentum).apply(pp, torch.from_numpy(g.copy()), st_p, scale)
        assert pp.numpy().tobytes() == pr.tobytes()
        for name in st_r:
            assert st_p[name].numpy().tobytes() == st_r[name].tobytes()


# ---------------------------------------------------------------------------
# port worlds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4])
def test_sharded_sync_bit_identical_plain_sgd(k, worlds):
    sess = sessions(worlds(k))
    rng = np.random.default_rng(11 + k)
    p0 = [rng.integers(-8, 9, s).astype(np.float32) for s in SIZES]
    grads = exact_rounds(rng, k, 3)
    ref = replicated_sgd(p0, grads, k, 0.1)
    res = run_sharded(sess, p0, grads, 0.1, name=f"sync{k}")
    for r in range(k):
        for i in range(len(p0)):
            np.testing.assert_array_equal(res[r][0][i], ref[i], err_msg=f"k={k} r={r} i={i}")
    total = sum(SIZES) * 4
    assert res[0][2] <= total // k + 4 * len(SIZES) * 2
    close_all(sess)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_sharded_async_bit_identical_momentum(k, worlds, monkeypatch):
    monkeypatch.setenv("KF_CONFIG_ASYNC", "on")
    monkeypatch.setattr(HostSession, "GROUP_BUCKET_BYTES", 1200)
    sess = sessions(worlds(k))
    rng = np.random.default_rng(23 + k)
    p0 = [rng.integers(-8, 9, s).astype(np.float32) for s in SIZES]
    grads = exact_rounds(rng, k, 4)
    ref = replicated_sgd(p0, grads, k, 0.1, momentum=0.9)
    res = run_sharded(sess, p0, grads, 0.1, momentum=0.9, mode="async", name="async")
    for r in range(k):
        for i in range(len(p0)):
            np.testing.assert_array_equal(res[r][0][i], ref[i], err_msg=f"r={r} i={i}")
    st = sess[0].scheduler().stats()
    n_buckets = len(zero.bucket_layout(SIZES, 1200))
    assert n_buckets >= 2 and st["zero_units"] == 4 * n_buckets and st["rounds"] == 4
    close_all(sess)


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_sharded_floats_and_state_blobs_equal_the_references(k, mode, worlds, monkeypatch):
    """Gradient-like floats, momentum: the port's sharded step in a port
    world lands on the reference's bits in an all-reference world, and
    the exported state blobs are byte-equal."""
    monkeypatch.setenv("KF_CONFIG_ASYNC", "on" if mode == "async" else "off")
    for cls in (HostSession, RHostSession):
        monkeypatch.setattr(cls, "GROUP_BUCKET_BYTES", 1600)
    rng = np.random.default_rng(31 + k)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SIZES]
    grads = float_rounds(rng, k, 3)
    ref_world = make_world(["ref"] * k)
    try:
        rs = sessions(ref_world)
        want = run_sharded(rs, p0, grads, 0.05, momentum=0.9, mode=mode, name="fl")
        close_all(rs)
    finally:
        for p in ref_world:
            p.stop()
    sess = sessions(worlds(k))
    got = run_sharded(sess, p0, grads, 0.05, momentum=0.9, mode=mode, name="fl")
    close_all(sess)
    for r in range(k):
        for i in range(len(p0)):
            assert got[r][0][i].tobytes() == want[r][0][i].tobytes(), (r, i)
        assert got[r][1] == want[r][1]
        assert got[r][2] == want[r][2]


def test_sharded_bf16_weight_ag_error_bound(worlds, monkeypatch):
    monkeypatch.setenv("KF_CONFIG_WIRE", "bf16")
    monkeypatch.setattr(HostSession, "WIRE_MIN_BYTES", 0)
    sess = sessions(worlds(2))
    rng = np.random.default_rng(5)
    sizes = (64, 500)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in sizes]
    grads = [{r: [rng.standard_normal(s).astype(np.float32) * 0.1 for s in sizes]
              for r in range(2)} for _ in range(6)]
    res = run_sharded(sess, p0, grads, 0.05, name="bf16")
    for i in range(len(p0)):
        np.testing.assert_array_equal(res[0][0][i], res[1][0][i])
    ref = replicated_sgd(p0, grads, 2, 0.05)
    for i in range(len(p0)):
        err = np.abs(res[0][0][i] - ref[i])
        assert (err <= np.abs(ref[i]) * 2.0 ** -8 + 1e-7).all(), float(err.max())
    close_all(sess)


def test_zero_knob_consensus_divergence(worlds):
    sess = sessions(worlds(2))
    assert "KF_CONFIG_ZERO" in dict(sess[0].engine_knobs())
    sess[1].zero_mode = "on"
    errs = {}
    t0 = time.monotonic()

    def check(r):
        try:
            sess[r].check_knob_consensus()
            errs[r] = None
        except RuntimeError as e:
            errs[r] = str(e)

    run_all([lambda r=r: check(r) for r in range(2)])
    assert time.monotonic() - t0 < 10
    assert all(e is not None and "KF_CONFIG_ZERO" in e for e in errs.values()), errs


@pytest.mark.parametrize("knob", ["KF_CONFIG_ZERO", "KF_CONFIG_ASYNC"])
def test_mode_resolution_matches_the_reference(knob, worlds, monkeypatch):
    world = worlds(2)
    method = "zero_enabled" if knob == "KF_CONFIG_ZERO" else "async_enabled"
    for value in ("", "off", "on", "auto"):
        monkeypatch.setenv(knob, value)
        for subset in (1, 2):
            (mine,) = sessions(world[:1]) if subset == 1 else sessions(world)[:1]
            pl = RPeerList([RPeerID(p.self_id.host, p.self_id.port) for p in world[:subset]])
            ref = RHostSession(RStrategy.RING_SEGMENTED, pl[0], pl, None, None)
            assert getattr(mine, method)() == getattr(ref, method)(), (value, subset)
    monkeypatch.setenv(knob, "bogus")
    with pytest.raises(ValueError, match=knob):
        sessions(world)


@pytest.mark.parametrize("k_before,k_after", [(2, 4), (4, 2)])
def test_reshard_across_epochs_bit_identical(k_before, k_after, worlds):
    """tests/test_zero.py's re-shard: steps at k_before, export, rebuild at
    k_after with restore_state, more steps; params and the re-sharded
    momentum equal a fresh replicated run. Every rank gets the same
    integer gradients, so the average is k-independent."""
    world = worlds(4)
    rng = np.random.default_rng(31)
    p0 = [rng.integers(-8, 9, s).astype(np.float32) for s in (40, 333)]
    lr, mom = 0.1, 0.9
    totals = [[rng.integers(-8, 9, p.size).astype(np.float32) for p in p0] for _ in range(4)]
    ref_all = replicated_sgd(p0, [{0: t} for t in totals], 1, lr, momentum=mom)
    ref_bufs = [np.zeros(p.size, np.float32) for p in p0]
    for rnd in range(4):
        for i in range(len(p0)):
            ref_bufs[i] = np.float32(mom) * ref_bufs[i] + totals[rnd][i]
    name = f"rz{k_before}{k_after}"
    sa = sessions(world, subset=k_before)
    state = {}

    def run_a(r):
        params = [torch.from_numpy(p.copy()) for p in p0]
        zs = zero.ShardedUpdateSession(params, zero.ShardedSGD(lr, mom), name=name, session=sa[r])
        for rnd in range(2):
            zs.step([torch.from_numpy(t.copy()) for t in totals[rnd]])
        state[r] = (params, zs.export_state())

    run_all([lambda r=r: run_a(r) for r in range(k_before)])
    blobs = [state[r][1] for r in range(k_before)]
    assert all(b == blobs[0] for b in blobs)
    sb = sessions(world, subset=k_after)
    res = {}

    def run_b(r):
        params = ([p.clone() for p in state[r][0]] if r in state
                  else [torch.zeros(p.size) for p in p0])  # a joiner: restore overwrites
        zs = zero.ShardedUpdateSession(params, zero.ShardedSGD(lr, mom), name=name,
                                       session=sb[r], restore_state=blobs[0])
        for rnd in (2, 3):
            zs.step([torch.from_numpy(t.copy()) for t in totals[rnd]])
        res[r] = (params, zs)

    run_all([lambda r=r: run_b(r) for r in range(k_after)])
    for r in range(k_after):
        for i in range(len(p0)):
            np.testing.assert_array_equal(res[r][0][i].numpy(), ref_all[i])
    full_mom = np.concatenate(ref_bufs)
    off = 0
    for b in res[0][1]._buckets:
        np.testing.assert_array_equal(b.state["momentum"].numpy(),
                                      full_mom[off + b.ob:off + b.oe])
        off += b.total


def test_restore_rejects_a_blob_of_another_layout(worlds):
    (s,) = sessions(worlds(2)[:1])
    blob = zs_of(s, [np.zeros(7, np.float32)], 0.1).export_state()
    with pytest.raises(ValueError, match="restore_state bucket 0"):
        zs_of(s, [np.zeros(8, np.float32)], 0.1, restore_state=blob)


def test_mid_flight_gather_drains_and_closed_raises(worlds, monkeypatch):
    monkeypatch.setenv("KF_CONFIG_ASYNC", "on")
    sess = sessions(worlds(2))
    rng = np.random.default_rng(41)
    res = {}

    def run(r):
        params = [torch.from_numpy(rng.integers(-8, 9, 50_000).astype(np.float32))]
        zs = zero.ShardedUpdateSession(params, zero.ShardedSGD(0.1), name="drain",
                                       session=sess[r])
        zs.submit_grad(0, torch.ones(50_000))
        zs.flush(timeout=60)
        res[r] = (sess[r].scheduler(), list(sess[r].scheduler()._threads))

    run_all([lambda r=r: run(r) for r in range(2)])
    close_all(sess)
    for r in range(2):
        for t in res[r][1]:
            t.join(10)
            assert not t.is_alive(), "scheduler thread outlived close()"
        with pytest.raises(SchedulerClosed):
            res[r][0].flush(timeout=5)
        try:
            res[r][0].wait_gather(timeout=5)
        except SchedulerClosed:
            pass
    with pytest.raises(RuntimeError, match="epoch ended"):
        zero.ShardedUpdateSession([torch.zeros(4)], zero.ShardedSGD(0.1),
                                  session=sess[0]).submit_grad(0, torch.zeros(4))


def test_zero_submit_requires_handler_consistency(worlds, monkeypatch):
    monkeypatch.setenv("KF_CONFIG_ASYNC", "on")
    sess = sessions(worlds(2))

    def round1(r):
        zs = zero.ShardedUpdateSession([torch.zeros(32)], zero.ShardedSGD(0.1), name="hc",
                                       session=sess[r])
        zs.submit_grad(0, torch.ones(32))
        zs.flush(timeout=30)
        zs.wait_params(timeout=30)

    run_all([lambda r=r: round1(r) for r in range(2)])
    sched = sess[0].scheduler()
    x = torch.ones(32)
    with pytest.raises(ValueError, match="unregistered"):
        sched.submit(Workspace(x, torch.empty_like(x), ReduceOp.SUM, "kungfu::zero:hc:0"))
    zs2 = zero.ShardedUpdateSession([torch.zeros(32)], zero.ShardedSGD(0.1), name="hc",
                                    session=sess[0])
    with pytest.raises(ValueError, match="ONE sharded-update handler"):
        zs2.submit_grad(0, x)
    with pytest.raises(ValueError, match="mismatch"):
        zs2.submit_grad(0, torch.ones(31))
    close_all(sess)


def test_mixed_sharded_and_allreduce_round(worlds, monkeypatch):
    monkeypatch.setenv("KF_CONFIG_ASYNC", "on")
    sess = sessions(worlds(2))
    rng = np.random.default_rng(53)
    p0 = [rng.integers(-8, 9, 200).astype(np.float32)]
    gr = {r: [rng.integers(-8, 9, 200).astype(np.float32)] for r in range(2)}
    ref = replicated_sgd(p0, [gr], 2, 0.1)
    res = {}

    def run(r):
        params = [torch.from_numpy(p0[0].copy())]
        zs = zero.ShardedUpdateSession(params, zero.ShardedSGD(0.1), name="mix", session=sess[r])
        metric = torch.full((8,), float(r + 1), dtype=torch.float64)
        mout = torch.empty_like(metric)
        zs.submit_grad(0, torch.from_numpy(gr[r][0].copy()))
        sess[r].scheduler().submit(Workspace(metric, mout, ReduceOp.SUM, "mix:metric"))
        sess[r].scheduler().flush(timeout=60)
        zs.wait_params(timeout=30)
        res[r] = (params, mout)

    run_all([lambda r=r: run(r) for r in range(2)])
    for r in range(2):
        np.testing.assert_array_equal(res[r][0][0].numpy(), ref[0])
        assert torch.equal(res[r][1], torch.full((8,), 3.0, dtype=torch.float64))
    close_all(sess)


def test_api_sharded_update_session(worlds, monkeypatch):
    """`api.sharded_update_session` on each thread's own peer: the
    session's ZeRO-1 update, equal to replicated SGD."""
    tls = threading.local()
    monkeypatch.setattr(api, "get_default_peer", lambda: tls.peer)
    world = worlds(3)
    rng = np.random.default_rng(61)
    p0 = [rng.integers(-8, 9, s).astype(np.float32) for s in SIZES]
    grads = exact_rounds(rng, 3, 2)
    ref = replicated_sgd(p0, grads, 3, 0.1, momentum=0.5)
    res = {}

    def run(r):
        tls.peer = world[r]
        params = [torch.from_numpy(p.copy()) for p in p0]
        zs = api.sharded_update_session(params, 0.1, momentum=0.5, name="api")
        for rnd in range(2):
            zs.step([torch.from_numpy(g) for g in grads[rnd][r]])
        res[r] = params

    run_all([lambda r=r: run(r) for r in range(3)])
    for r in range(3):
        for i in range(len(p0)):
            np.testing.assert_array_equal(res[r][i].numpy(), ref[i])


# ---------------------------------------------------------------------------
# the mixed world
# ---------------------------------------------------------------------------

LAYOUTS = {"ref_first": ["ref", "port", "ref", "port"],
           "port_first": ["port", "ref", "port", "ref"]}


@pytest.fixture(scope="module")
def mixed(ref_native):
    """The sharded steps (sync and async, momentum, floats) on each mixed
    world and on an all-reference world: {(layout, mode): (mixed, ref)}."""
    results = {}
    ref_world = make_world(["ref"] * 4)
    mixed_worlds = {name: make_world(kinds) for name, kinds in LAYOUTS.items()}
    rng = np.random.default_rng(71)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SIZES]
    grads = float_rounds(rng, 4, 3)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for cls in (HostSession, RHostSession):
                mp.setattr(cls, "GROUP_BUCKET_BYTES", 1600)
            for mode in ("sync", "async"):
                mp.setenv("KF_CONFIG_ASYNC", "on" if mode == "async" else "off")
                rs = sessions(ref_world)
                want = run_sharded(rs, p0, grads, 0.05, momentum=0.9, mode=mode, name="mx")
                close_all(rs)
                for name, world in mixed_worlds.items():
                    ms = sessions(world)
                    results[(name, mode)] = (run_sharded(ms, p0, grads, 0.05, momentum=0.9,
                                                         mode=mode, name="mx"), want)
                    close_all(ms)
        yield results
    finally:
        for p in ref_world + [p for w in mixed_worlds.values() for p in w]:
            p.stop()


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mixed_world_params_and_state_hold_the_reference_worlds_bits(layout, mode, mixed):
    got, want = mixed[(layout, mode)]
    for r in range(4):
        for i in range(len(SIZES)):
            assert got[r][0][i].tobytes() == want[0][0][i].tobytes(), (r, i)
        assert got[r][1] == want[0][1]


def test_no_scheduler_thread_outlives_the_module():
    alive = [t.name for t in threading.enumerate() if t.name.startswith("kf-sched-")]
    assert not alive, alive

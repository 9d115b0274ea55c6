"""The port's torch frontend (`kungfu_tpu_torch/torch/__init__.py`)
against the JAX package's (`kungfu_tpu/torch/__init__.py`), in process;
mirrors tests/test_torch_frontend.py.

Worlds of 2 loopback peers: one of port peers, one of reference peers,
and a mixed one (rank 0 reference, rank 1 port). Each thread runs its
peer's frontend on the same `nn.Module` and batches, and every case
starts a fresh cluster epoch (`Peer._update_to`) under the knobs it sets,
so each scheduler registers its own tensor set. Held bit for bit against
the reference: `sync_gradients` (f32 and bf16), `broadcast_parameters`,
`all_reduce`, `SynchronousSGDOptimizer` with the scheduler on (the
post-accumulate-grad hooks from step 1) and off and with
``async_hooks=False``, `ZeroSGDOptimizer` sharded and replicated, sync
and async, and its state blob across a mode flip. `PairAveragingOptimizer`
lands each rank on one of the two averages the protocol allows.

Every epoch is closed with its world; the last case asserts that no
`kf-sched-*` thread outlives the module."""

import threading

import numpy as np
import pytest
import torch

from kungfu_tpu import api as rapi
from kungfu_tpu import torch as rfront
from kungfu_tpu.collective.host_session import HostSession as RHostSession
from kungfu_tpu_torch import api
from kungfu_tpu_torch import torch as front
from kungfu_tpu_torch.collective.host_session import HostSession
from kungfu_tpu_torch.peer import Peer
from test_torch_port_worlds import (  # noqa: F401 - fixtures used by name
    PerThreadCounter, make_world, new_epoch, run_all, small_arenas)

STEPS = 3


KINDS = {"port": ["port", "port"], "ref": ["ref", "ref"], "mixed": ["ref", "port"]}


@pytest.fixture(scope="module")
def worlds():
    built = {name: make_world(kinds, strategy="RING_SEGMENTED") for name, kinds in KINDS.items()}
    yield built
    for world in built.values():
        for p in world:
            p.stop()


@pytest.fixture
def run(worlds, monkeypatch):
    """run(world_name, fn, **knobs): a fresh epoch of that world under the
    knobs, then fn(frontend, rank) on one thread per peer, each with its
    peer as both packages' default; returns the results by rank."""
    tls = threading.local()
    monkeypatch.setattr(api, "get_default_peer", lambda: tls.peer)
    monkeypatch.setattr(rapi, "get_default_peer", lambda: tls.peer)
    for mod in (front, rfront):
        monkeypatch.setattr(mod, "_sync_round", PerThreadCounter())
    for cls in (HostSession, RHostSession):
        monkeypatch.setattr(cls, "GROUP_BUCKET_BYTES", 256)  # several buckets
        monkeypatch.setattr(cls, "SEGMENT_MIN_BYTES", 0)

    def go(name, fn, **knobs):
        world = worlds[name]
        for k, v in knobs.items():
            monkeypatch.setenv(k, v)

        new_epoch(world)
        out = {}

        def one(r):
            tls.peer = world[r]
            out[r] = fn(front if isinstance(world[r], Peer) else rfront, r)

        run_all([lambda r=r: one(r) for r in range(len(world))])
        return [out[r] for r in range(len(world))]

    return go


def model(seed=0, dtype=torch.float32):
    """A small MLP whose weights come from its own generator (threads
    share torch's global one)."""
    m = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(), torch.nn.Linear(16, 3))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return m.to(dtype)


def batch(rank, step, dtype=torch.float32):
    g = torch.Generator().manual_seed(100 * rank + step)
    return torch.randn(8, 6, generator=g).to(dtype), torch.randn(8, 3, generator=g).to(dtype)


def loss_of(m, rank, step, dtype=torch.float32):
    x, y = batch(rank, step, dtype)
    return (m(x) - y).pow(2).mean()


def params_bytes(m):
    return [p.detach().float().numpy().tobytes() for p in m.parameters()]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("async_mode", ["off", "on"])
def test_sync_gradients_matches_the_reference(async_mode, dtype, run):
    def fn(kf, r):
        m = model(1, dtype)
        loss_of(m, r, 0, dtype).float().backward()
        kf.sync_gradients(m, name=f"sg:{dtype}")
        return [p.grad.float().numpy().tobytes() for p in m.parameters()]

    res = {w: run(w, fn, KF_CONFIG_ASYNC=async_mode) for w in KINDS}
    assert res["port"][0] == res["port"][1]
    assert res["port"] == res["ref"] == res["mixed"]


def test_broadcast_blob_is_the_references(run, monkeypatch):
    """The bytes rank 0 broadcasts are the reference's for the same model
    (so either package's peers can parse the other's)."""
    sent = {}

    def fn(kf, r):
        sess = kf.api.get_default_peer().current_session()
        real = sess.broadcast_bytes

        def spy(bs, name, root=0):
            if sess.rank == root:
                sent[kf is front] = bs
            return real(bs, name, root=root)

        monkeypatch.setattr(sess, "broadcast_bytes", spy)
        kf.broadcast_parameters(model(7))

    run("port", fn)
    run("ref", fn)
    assert sent[True] == sent[False]


def test_broadcast_parameters_and_all_reduce_match_the_reference(run):
    def fn(kf, r):
        m = model(r)  # divergent models
        kf.broadcast_parameters(m, root=1)
        t = torch.arange(6, dtype=torch.float32).view(2, 3) * (r + 1)
        out = kf.all_reduce(t)
        return params_bytes(m), out.shape, out.numpy().tobytes()

    res = {w: run(w, fn) for w in KINDS}
    want = params_bytes(model(1))
    for w in KINDS:
        for pb, shape, out in res[w]:
            assert pb == want and shape == (2, 3)
            assert out == (torch.arange(6, dtype=torch.float32).view(2, 3) * 3).numpy().tobytes()


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hooks", [None, False])
@pytest.mark.parametrize("async_mode", ["off", "on"])
def test_synchronous_sgd_matches_the_reference(async_mode, hooks, run):
    def fn(kf, r):
        m = model(2)
        opt = kf.SynchronousSGDOptimizer(torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9),
                                         name="ssgd", async_hooks=hooks)
        out = []
        for step in range(STEPS):
            opt.zero_grad()
            loss_of(m, r, step).backward()
            opt.step()
            out.append(params_bytes(m))
        sess = kf.api.get_default_peer().current_session()
        units = sess.scheduler().stats()["units"] if sess.async_enabled() else 0
        return out, opt._hooks_installed, units

    res = {w: run(w, fn, KF_CONFIG_ASYNC=async_mode) for w in KINDS}
    for w in KINDS:
        for out, hooked, units in res[w]:
            assert out == res["ref"][0][0]
            # hooks only with the scheduler on and not opted out; they
            # feed the scheduler from step 1
            assert hooked == (async_mode == "on" and hooks is None)
            assert (units > 0) == hooked


@pytest.mark.parametrize("async_mode", ["off", "on"])
@pytest.mark.parametrize("zero_mode", ["off", "on"])
def test_zero_sgd_matches_the_reference(zero_mode, async_mode, run):
    def fn(kf, r):
        m = model(3)
        opt = kf.ZeroSGDOptimizer(m, lr=0.1, momentum=0.9)
        out = []
        for step in range(STEPS):
            opt.zero_grad()
            loss_of(m, r, step).backward()
            opt.step()
            out.append(params_bytes(m))
        return out, opt._mode, opt.state_bytes(), opt.export_state()

    res = {w: run(w, fn, KF_CONFIG_ASYNC=async_mode, KF_CONFIG_ZERO=zero_mode)
           for w in KINDS}
    want = res["ref"][0]
    n = sum(p.numel() for p in model(3).parameters())
    for w in KINDS:
        for out, mode, state_bytes, blob in res[w]:
            assert out == want[0] and blob == want[3]
            assert mode == ("sharded" if zero_mode == "on" else "replicated")
            # momentum + masters of a half shard, or full momentum
            assert state_bytes <= (2 * (n // 2 + 8) * 4 if zero_mode == "on" else n * 4)


@pytest.mark.parametrize("async_mode", ["off", "on"])
def test_zero_sgd_sharded_equals_replicated(async_mode, run):
    """The sharded step and the replicated fallback (the same formula on
    full params after sync_gradients) agree bit for bit at k 2."""
    def fn(kf, r):
        sess = kf.api.get_default_peer().current_session()
        out = []
        for mode in ("on", "off"):
            sess.zero_mode = mode
            m = model(4)
            opt = kf.ZeroSGDOptimizer(m, lr=0.05, momentum=0.5, name=f"zs{mode}")
            for step in range(STEPS):
                opt.zero_grad()
                loss_of(m, r, step).backward()
                opt.step()
            out.append(params_bytes(m))
        return out

    for sharded, replicated in run("port", fn, KF_CONFIG_ASYNC=async_mode):
        assert sharded == replicated


def test_zero_state_blob_restores_across_a_mode_flip(run):
    """Both modes serialize the canonical bucket layout: a replicated
    blob rebuilds a sharded optimizer, and back, on the same params and
    momentum (tests/test_zero.py's mode-flip case, at k 2)."""
    def fn(kf, r):
        m = model(5)
        sess = kf.api.get_default_peer().current_session()
        sess.zero_mode = "off"
        opt = kf.ZeroSGDOptimizer(m, lr=0.1, momentum=0.9)
        for step in range(2):
            opt.zero_grad()
            loss_of(m, r, step).backward()
            opt.step()
        blob_r = opt.export_state()
        before = params_bytes(m)
        sess.zero_mode = "on"
        opt.rebuild(blob_r)
        assert opt._mode == "sharded" and params_bytes(m) == before
        blob_s = opt.export_state()
        sess.zero_mode = "off"
        opt.rebuild(blob_s)
        assert opt._mode == "replicated" and params_bytes(m) == before
        return blob_r, blob_s, opt.export_state()

    for w in KINDS:
        for blob_r, blob_s, blob_back in run(w, fn):
            assert blob_r == blob_s == blob_back


def test_pair_averaging_contracts_like_the_reference(run):
    def fn(kf, r):
        m = model(10 + r)  # divergent models
        init = [p.detach().clone() for p in m.parameters()]
        opt = kf.PairAveragingOptimizer(torch.optim.SGD(m.parameters(), lr=0.0), name="pa")
        opt.zero_grad()
        loss_of(m, r, 0).backward()
        opt.step()
        return init, [p.detach().clone() for p in m.parameters()]

    for w in KINDS:
        res = run(w, fn)
        for r in range(2):
            own, other = res[r][0], res[1 - r]
            # the peer's latest model: its initial one, or its averaged one
            allowed = [[0.5 * a + 0.5 * b for a, b in zip(own, other[0])],
                       [0.5 * a + 0.5 * b for a, b in zip(own, other[1])]]
            assert any(all(torch.equal(p, q) for p, q in zip(res[r][1], cand))
                       for cand in allowed), (w, r)


def test_no_scheduler_thread_outlives_the_module(worlds):
    for world in worlds.values():
        for p in world:
            p.current_session().close(timeout=10)
    alive = [t.name for t in threading.enumerate() if t.name.startswith("kf-sched-")]
    assert not alive, alive

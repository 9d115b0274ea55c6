"""Parity of the port's gradient-noise-scale and gradient-variance monitors
(kungfu_tpu_torch/monitor/) with the JAX package's, on gloo worlds of 2
and 3 CPU processes against the JAX wrappers under `shard_map` on as many
CPU devices, from the same numpy parameters and per-rank batches (an MLP
whose leaves, 5x7, 7, 7x4 and 4, do not split evenly over 3):

- `gns_update_norms` and `noise_scale` on the same numbers, the warm start
  and the 0 while unseeded included: 1e-6;
- both wrappers over momentum SGD for 3 steps at interval 1, 2 and 3: the
  parameters within 1e-6, the GNS EMAs, `noise_scale` and the variance
  within 1e-5 relative;
- the collectives a training step runs (`torch.distributed.all_reduce`
  calls): the GNS scalar rides in the gradients' all-average, and a step
  off the variance's interval runs no second one.

One world per size is spawned, one after the other, and runs every case."""

import functools
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from kungfu_tpu.models.mlp import mlp_loss as jax_mlp_loss
from kungfu_tpu.monitor import grad_variance as jgv
from kungfu_tpu.monitor import noise_scale as jns
from kungfu_tpu.parallel._compat import shard_map
from kungfu_tpu.parallel.mesh import make_mesh as jax_make_mesh

WORLDS = (2, 3)
SHAPES = {"b1": (7,), "b2": (4,), "w1": (5, 7), "w2": (7, 4)}  # sorted: JAX's leaf order
STEPS, LOCAL_B, LR, MOMENTUM, ALPHA = 3, 6, 0.1, 0.9, 0.6
# case -> (monitor, interval)
CASES = {"ssgd": ("ssgd", 1), "gns1": ("gns", 1), "gns2": ("gns", 2), "gns3": ("gns", 3),
         "var1": ("var", 1), "var2": ("var", 2), "var3": ("var", 3)}
NORMS = [(2.0, 1.5), (3.0, 1.0), (1.25, 1.2), (4.0, 0.5)]  # (gs, gb) a step


def _params0():
    rng = np.random.default_rng(0)
    return {k: (rng.standard_normal(s) * 0.5).astype(np.float32) for k, s in SHAPES.items()}


def _batches(world):
    rng = np.random.default_rng(world)
    x = rng.standard_normal((STEPS, world * LOCAL_B, 5)).astype(np.float32)
    y = rng.integers(0, 4, (STEPS, world * LOCAL_B)).astype(np.int32)
    return x, y


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


# ---------------------------------------------------------------------------
# the port, one process per rank
# ---------------------------------------------------------------------------

def _port_case(case, rank, session, out):
    import torch.distributed as dist

    from kungfu_tpu_torch.models.mlp import MLP, mlp_loss
    from kungfu_tpu_torch.monitor import (gradient_variance, monitor_gradient_noise_scale,
                                          monitor_gradient_variance, publish_gradient_variance,
                                          publish_noise_scale)
    from kungfu_tpu_torch.monitor.noise_scale import noise_scale
    from kungfu_tpu_torch.optimizers.core import synchronous_sgd
    from kungfu_tpu_torch.parallel.dp import make_train_step

    kind, interval = CASES[case]
    model = MLP({k: torch.from_numpy(v) for k, v in _params0().items()})
    base = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    if kind == "gns":
        opt = monitor_gradient_noise_scale(base, session, LOCAL_B, interval, ALPHA)
    elif kind == "var":
        opt = monitor_gradient_variance(base, session, interval)
    else:
        opt = synchronous_sgd(base, session)
    step = make_train_step(lambda m, b: mlp_loss(m.tree(), b), opt, session)
    x, y = _batches(session.size)
    part = slice(rank * LOCAL_B, (rank + 1) * LOCAL_B)
    calls, variances = [], []
    all_reduce = dist.all_reduce

    def counted(*args, **kwargs):
        calls[-1] += 1
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counted
    try:
        for i in range(STEPS):
            calls.append(0)
            step(model, (torch.from_numpy(x[i, part]), torch.from_numpy(y[i, part])))
            if kind == "var":
                variances.append(float(gradient_variance(opt)))
    finally:
        dist.all_reduce = all_reduce
    out[f"{case}.calls"] = np.array(calls)
    for k, p in model.tree().items():
        out[f"{case}.{k}"] = p.detach().numpy()
    if kind == "gns":
        out[f"{case}.g2_ema"] = opt.gns.g2_ema.numpy()
        out[f"{case}.s_ema"] = opt.gns.s_ema.numpy()
        out[f"{case}.count"] = np.array(opt.gns.count)
        out[f"{case}.noise_scale"] = noise_scale(opt.gns).numpy()
        out[f"{case}.published"] = np.array(publish_noise_scale(opt.gns))
    if kind == "var":
        out[f"{case}.variances"] = np.array(variances)
        out[f"{case}.published"] = np.array(publish_gradient_variance(opt))


def _worker(rank, world, peers, out_dir):
    torch.set_num_threads(1)
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    env = {"KF_SELF_SPEC": peers[rank], "KF_INIT_PEERS": ",".join(peers)}
    initialize_device_plane("cpu", environ=env)
    try:
        session = make_mesh("cpu")
        out = {}
        for case in CASES:
            _port_case(case, rank, session, out)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        shutdown_device_plane()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """world(n) -> every rank's results from the gloo world of n processes;
    the worlds run one after the other."""
    results = {}
    for n in WORLDS:
        out_dir = tmp_path_factory.mktemp(f"mon{n}")
        peers = [f"127.0.0.1:{p}" for p in _free_ports(n)]
        ctx = mp.start_processes(_worker, args=(n, peers, str(out_dir)), nprocs=n,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + 120
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    pytest.fail(f"the gloo world of {n} did not finish in 120 s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        results[n] = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(n)]
    return results.__getitem__


# ---------------------------------------------------------------------------
# JAX on CPU devices
# ---------------------------------------------------------------------------

def _jax_opt(case):
    kind, interval = CASES[case]
    base = optax.sgd(LR, momentum=MOMENTUM)
    if kind == "gns":
        return jns.monitor_gradient_noise_scale(base, LOCAL_B, "dp", interval, ALPHA)
    if kind == "var":
        return jgv.monitor_gradient_variance(base, "dp", interval)
    from kungfu_tpu.optimizers import core as jopt

    return jopt.synchronous_sgd(base, "dp")


@functools.lru_cache(maxsize=None)
def _jax_run(case, world):
    """Each rank's parameters after STEPS steps, and the monitor's state
    (the same on every rank): (params, {name: value}); the variance after
    every step."""
    opt = _jax_opt(case)
    kind = CASES[case][0]
    mesh = jax_make_mesh({"dp": world}, devices=jax.devices()[:world])
    x, y = _batches(world)

    def local(params, x, y):
        state = opt.init(params)
        variances = []
        for i in range(STEPS):
            grads = jax.grad(jax_mlp_loss)(params, (x[i], y[i]))
            updates, state = opt.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            if kind == "var":
                variances.append(jgv.gradient_variance(state))
        mon = {}
        if kind == "gns":
            mon = {"g2_ema": state.gns.g2_ema, "s_ema": state.gns.s_ema,
                   "count": state.gns.count, "noise_scale": jns.noise_scale(state.gns)}
        if kind == "var":
            mon = {"variances": jnp.stack(variances)}
        return (jax.tree.map(lambda p: p[None], params),
                jax.tree.map(lambda v: jnp.asarray(v)[None], mon))

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P(None, "dp"), P(None, "dp")),
                           out_specs=(P("dp"), P("dp")), check_vma=False))
    params, mon = fn(_params0(), x, y)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, mon)


@pytest.mark.parametrize("step", range(len(NORMS)))
def test_gns_update_norms_matches_jax(step):
    from kungfu_tpu_torch.monitor import noise_scale as tns

    b, B = 4, 12
    jstate, tstate = jns.gns_init(), tns.gns_init("cpu")
    assert float(tns.noise_scale(tstate)) == float(jns.noise_scale(jstate)) == 0.0
    for gs, gb in NORMS[:step + 1]:
        jstate = jns.gns_update_norms(jstate, jnp.float32(gs), jnp.float32(gb), b, B, ALPHA)
        tstate = tns.gns_update_norms(tstate, torch.tensor(gs), torch.tensor(gb), b, B, ALPHA)
    assert tstate.count == int(jstate.count) == step + 1
    for name in ("g2_ema", "s_ema"):
        np.testing.assert_allclose(float(getattr(tstate, name)), float(getattr(jstate, name)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tns.noise_scale(tstate)), float(jns.noise_scale(jstate)),
                               rtol=1e-6, atol=1e-6)
    # the tensor-list form on the same norms
    t2 = tns.gns_update(tns.gns_init("cpu"), [torch.full((4,), 0.5)], [torch.full((4,), 0.25)],
                        b, B, ALPHA)
    j2 = jns.gns_update(jns.gns_init(), [jnp.full((4,), 0.5)], [jnp.full((4,), 0.25)],
                        b, B, ALPHA)
    np.testing.assert_allclose(float(t2.g2_ema), float(j2.g2_ema), rtol=1e-6)
    np.testing.assert_allclose(float(t2.s_ema), float(j2.s_ema), rtol=1e-6)


PARAM_CASES = [(n, c) for n in WORLDS for c in CASES]


@pytest.mark.parametrize("n,case", PARAM_CASES, ids=[f"w{n}-{c}" for n, c in PARAM_CASES])
def test_monitored_params_match_jax(world, n, case):
    want, mon = _jax_run(case, n)
    kind = CASES[case][0]
    for rank, res in enumerate(world(n)):
        for k in SHAPES:
            np.testing.assert_allclose(res[f"{case}.{k}"], want[k][rank], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{case} {k} rank {rank}")
        if kind == "gns":
            for name in ("g2_ema", "s_ema", "noise_scale"):
                np.testing.assert_allclose(res[f"{case}.{name}"], mon[name][rank], rtol=1e-5,
                                           err_msg=f"{case} {name} rank {rank}")
            assert int(res[f"{case}.count"]) == int(mon["count"][rank]) == STEPS
            assert float(res[f"{case}.published"]) == float(res[f"{case}.noise_scale"])
            assert float(res[f"{case}.noise_scale"]) != 0.0
        if kind == "var":
            np.testing.assert_allclose(res[f"{case}.variances"], mon["variances"][rank],
                                       rtol=1e-5, err_msg=f"{case} rank {rank}")
            assert float(res[f"{case}.published"]) == res[f"{case}.variances"][-1]


@pytest.mark.parametrize("n", WORLDS)
def test_off_interval_variance_steps_run_no_collective_of_their_own(world, n):
    """All-reduces a step: S-SGD's gradient average and make_train_step's
    loss average (2); GNS adds none (its scalar rides in the gradients'
    buffer); the variance adds one on its interval's steps only."""
    for res in world(n):
        assert res["ssgd.calls"].tolist() == [2, 2, 2]
        assert res["gns1.calls"].tolist() == [2, 2, 2]
        assert res["gns2.calls"].tolist() == [2, 2, 2]
        assert res["gns3.calls"].tolist() == [2, 2, 2]
        assert res["var1.calls"].tolist() == [3, 3, 3]
        assert res["var2.calls"].tolist() == [3, 2, 3]
        assert res["var3.calls"].tolist() == [3, 2, 2]
        v = res["var2.variances"]
        assert v[1] == v[0] and v[2] != v[1]  # the off step kept the last estimate

"""Parity of the port's optimizer wrappers (kungfu_tpu_torch/optimizers/core.py)
with the JAX package's, on gloo worlds of 2 and 3 CPU processes against the
JAX wrappers under `shard_map` on as many CPU devices, from the same numpy
parameters and per-rank batches (an MLP whose leaves, 5x7, 7, 7x4 and 4,
do not split evenly over 3):

- SMA (alpha 0.1, momentum SGD), from replicas that start apart;
- AdaptiveSGD across `change_step` (2 of 4 steps) with momentum SGD and
  with AdamW: S-SGD starts from fresh state, so Adam's bias correction
  restarts at the switch;
- the re-sync at the switch (lr 0, alpha 0, replicas seeded apart: all
  end on rank 0's parameters, bitwise);
- ZeRO-1 against JAX's `zero_sharded` (parameters, and each rank's state
  shard by shape and value), and against the port's S-SGD.

Parameters within rtol 1e-5 / atol 1e-5 after 4 steps. AdamW's decoupled
weight decay reads p, so at the switch the port's update (taken at rank
0's p after the re-sync) and JAX's (at the local p) differ by
lr * wd * (p - p_rank0), about 1e-7 in the cases above; a case of its own
(replicas 1.0 apart, wd 0.5) measures that gap at the switch step. One
world per size is spawned, one after the other, and runs every case."""

import functools
import socket
import time

import jax
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from kungfu_tpu.models.mlp import mlp_loss as jax_mlp_loss
from kungfu_tpu.ops.collective import broadcast as jax_broadcast
from kungfu_tpu.optimizers import core as jopt
from kungfu_tpu.parallel._compat import shard_map
from kungfu_tpu.parallel.mesh import make_mesh as jax_make_mesh

WORLDS = (2, 3)
SHAPES = {"b1": (7,), "b2": (4,), "w1": (5, 7), "w2": (7, 4)}  # sorted: JAX's leaf order
STEPS, LOCAL_B, CHANGE = 4, 6, 2
LR, MOMENTUM, ALPHA, ADAM_LR, WD = 0.1, 0.9, 0.1, 1e-2, 1e-2
# case -> (per-rank offset of the initial params, optimizer)
CASES = {
    "sma": (0.01, "sma"),
    "ada_momentum": (0.01, "ada"),
    "ada_adamw": (0.01, "ada"),
    "resync": (1.0, "resync"),
    "zero_momentum": (0.0, "zero"),
    "zero_adamw": (0.0, "zero"),
    "ssgd_momentum": (0.0, "ssgd"),
    "ssgd_adamw": (0.0, "ssgd"),
}
TOL = dict(rtol=1e-5, atol=1e-5)
SWITCH_OFFSET, SWITCH_WD = 1.0, 0.5  # the switch's AdamW gap, far above rounding


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

def _torch_base(case):
    if case.endswith("adamw"):
        return lambda ps: torch.optim.AdamW(ps, lr=ADAM_LR, weight_decay=WD)
    if case == "resync":
        return lambda ps: torch.optim.SGD(ps, lr=0.0)
    return lambda ps: torch.optim.SGD(ps, lr=LR, momentum=MOMENTUM)


def _port_case(case, rank, session, out):
    from kungfu_tpu_torch.models.mlp import MLP, mlp_loss
    from kungfu_tpu_torch.optimizers import core
    from kungfu_tpu_torch.parallel.dp import make_train_step

    offset, kind = CASES[case]
    model = MLP({k: torch.from_numpy(v + offset * rank) for k, v in _params0().items()})
    params, base = list(model.parameters()), _torch_base(case)
    if kind == "sma":
        opt = core.synchronous_averaging(base(params), session, alpha=ALPHA)
    elif kind == "ada":
        opt = core.adaptive_sgd(base, params, session, change_step=CHANGE, alpha=ALPHA)
    elif kind == "resync":
        opt = core.adaptive_sgd(base, params, session, change_step=CHANGE, alpha=0.0)
    elif kind == "zero":
        opt = core.zero_sharded(base, params, session)
    else:
        opt = core.synchronous_sgd(base(params), session)
    step = make_train_step(lambda m, b: mlp_loss(m.tree(), b), opt, session)
    x, y = _batches(session.size)
    part = slice(rank * LOCAL_B, (rank + 1) * LOCAL_B)
    for i in range(STEPS):
        step(model, (torch.from_numpy(x[i, part]), torch.from_numpy(y[i, part])))
    for k, p in model.tree().items():
        out[f"{case}.{k}"] = p.detach().numpy()
    if kind == "zero":
        names = list(model.tree())
        for name, shard in zip(names, opt.shards):
            for key, t in opt.base.state[shard].items():
                if t.dim():
                    out[f"{case}.state.{name}.{key}"] = t.numpy()
        out[f"{case}.state_bytes"] = np.array(core.state_bytes(opt.base))


def _port_switch(rank, session, out):
    """AdaptiveSGD over AdamW to the end of the switch step: each rank's
    parameters before that step and after it."""
    from kungfu_tpu_torch.models.mlp import MLP, mlp_loss
    from kungfu_tpu_torch.optimizers import core
    from kungfu_tpu_torch.parallel.dp import make_train_step

    model = MLP({k: torch.from_numpy(v + SWITCH_OFFSET * rank) for k, v in _params0().items()})
    opt = core.adaptive_sgd(lambda ps: torch.optim.AdamW(ps, lr=ADAM_LR, weight_decay=SWITCH_WD),
                            list(model.parameters()), session, change_step=CHANGE, alpha=ALPHA)
    step = make_train_step(lambda m, b: mlp_loss(m.tree(), b), opt, session)
    x, y = _batches(session.size)
    part = slice(rank * LOCAL_B, (rank + 1) * LOCAL_B)
    for i in range(CHANGE + 1):
        if i == CHANGE:
            for k, p in model.tree().items():
                out[f"switch.before.{k}"] = p.detach().numpy().copy()
        step(model, (torch.from_numpy(x[i, part]), torch.from_numpy(y[i, part])))
    for k, p in model.tree().items():
        out[f"switch.after.{k}"] = p.detach().numpy()


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
        _port_switch(rank, session, out)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        shutdown_device_plane()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """world(n) -> every rank's results from the gloo world of n processes;
    the worlds run one after the other."""
    results = {}
    for n in WORLDS:
        out_dir = tmp_path_factory.mktemp(f"opt{n}")
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

def _jax_opt(case, world):
    if case.endswith("adamw"):
        base = optax.adamw(ADAM_LR, weight_decay=WD)
    elif case == "resync":
        base = optax.sgd(0.0)
    else:
        base = optax.sgd(LR, momentum=MOMENTUM)
    kind = CASES[case][1]
    if kind == "sma":
        return jopt.synchronous_averaging(base, "dp", alpha=ALPHA)
    if kind == "ada":
        return jopt.adaptive_sgd(base, change_step=CHANGE, axis_name="dp", alpha=ALPHA)
    if kind == "resync":
        return jopt.adaptive_sgd(base, change_step=CHANGE, axis_name="dp", alpha=0.0)
    if kind == "zero":
        return jopt.zero_sharded(base, world, "dp")
    return jopt.synchronous_sgd(base, "dp")


@functools.lru_cache(maxsize=None)
def _jax_run(case, world):
    """Each rank's parameters after STEPS steps, and its optimizer state's
    array leaves (the per-replica shards under ZeRO): (params, state)
    with a leading rank axis."""
    return _jax_replicas(_jax_opt(case, world), CASES[case][0], STEPS, world)


def _jax_replicas(opt, offset, steps, world):
    mesh = jax_make_mesh({"dp": world}, devices=jax.devices()[:world])
    x, y = _batches(world)

    def local(params, x, y, seed):
        params = jax.tree.map(lambda p: p + offset * seed[0], params)
        state = opt.init(params)
        for i in range(steps):
            grads = jax.grad(jax_mlp_loss)(params, (x[i], y[i]))
            updates, state = opt.update(grads, state, params)
            params = optax.apply_updates(params, updates)
        leaves = [s[None] for s in jax.tree.leaves(state) if s.ndim]
        return jax.tree.map(lambda p: p[None], params), leaves

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P(None, "dp"), P(None, "dp"), P("dp")),
                           out_specs=(P("dp"), P("dp")), check_vma=False))
    params, state = fn(_params0(), x, y, np.arange(world, dtype=np.float32))
    return jax.tree.map(np.asarray, params), [np.asarray(s) for s in state]


@functools.lru_cache(maxsize=None)
def _jax_switch(world):
    """JAX's parameters at the end of `_port_switch`'s switch step."""
    opt = jopt.adaptive_sgd(optax.adamw(ADAM_LR, weight_decay=SWITCH_WD), change_step=CHANGE,
                            axis_name="dp", alpha=ALPHA)
    return _jax_replicas(opt, SWITCH_OFFSET, CHANGE + 1, world)[0]


PARAM_CASES = [(n, c) for n in WORLDS for c in CASES]


@pytest.mark.parametrize("n,case", PARAM_CASES, ids=[f"w{n}-{c}" for n, c in PARAM_CASES])
def test_wrapper_params_match_jax(world, n, case):
    want, _ = _jax_run(case, n)
    for rank, res in enumerate(world(n)):
        for k in SHAPES:
            np.testing.assert_allclose(res[f"{case}.{k}"], want[k][rank], **TOL,
                                       err_msg=f"{case} {k} rank {rank}")


@pytest.mark.parametrize("n", WORLDS)
def test_sma_replicas_stay_apart_and_move_together(world, n):
    """SMA blends but does not equalize: the replicas started apart stay
    apart, each pulled toward the others (JAX's replicas too)."""
    want, _ = _jax_run("sma", n)
    ranks = world(n)
    for k in SHAPES:
        assert not np.array_equal(ranks[0][f"sma.{k}"], ranks[1][f"sma.{k}"])
        assert not np.array_equal(want[k][0], want[k][1])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", ["ada_momentum", "ada_adamw", "resync"])
def test_adaptive_sgd_ranks_bitwise_equal_after_switch(world, n, case):
    ranks = world(n)
    for k in SHAPES:
        for res in ranks[1:]:
            np.testing.assert_array_equal(res[f"{case}.{k}"], ranks[0][f"{case}.{k}"])


@pytest.mark.parametrize("n", WORLDS)
def test_resync_lands_on_rank0_params(world, n):
    """lr 0, alpha 0: nothing moves but the re-sync, so every rank ends on
    rank 0's (unshifted) initial parameters, bitwise; JAX's ranks land there
    up to the rounding of its folded update p + (bcast(p) - p)."""
    want, _ = _jax_run("resync", n)
    for rank, res in enumerate(world(n)):
        for k, v in _params0().items():
            np.testing.assert_array_equal(res[f"resync.{k}"], v)
            np.testing.assert_allclose(want[k][rank], v, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", WORLDS)
def test_adaptive_sgd_state_is_fresh_at_the_switch(world, n):
    """Carrying the SMA phase's Adam state into S-SGD moves the parameters
    by far more than the tolerance: the fresh-state rule is what the
    parity above checks."""
    want, _ = _jax_run("ada_adamw", n)
    carried = _jax_run_carried_adamw(n)
    gap = max(float(np.abs(want[k][0] - carried[k][0]).max()) for k in SHAPES)
    assert gap > 100 * TOL["atol"]


@pytest.mark.parametrize("n", WORLDS)
def test_adaptive_sgd_switch_gap_under_adamw(world, n):
    """The port takes the switch step's update at rank 0's parameters,
    JAX at the local ones (`bcast(p) + u(p)`): under AdamW's decoupled
    decay the two differ by lr * wd * (p - p_rank0), here up to 1e-2, and
    by nothing else beyond rounding (2e-6)."""
    want = _jax_switch(n)
    ranks = world(n)
    for rank, res in enumerate(ranks):
        for k in SHAPES:
            p, p0 = res[f"switch.before.{k}"], ranks[0][f"switch.before.{k}"]
            gap = res[f"switch.after.{k}"] - want[k][rank]
            np.testing.assert_allclose(gap, ADAM_LR * SWITCH_WD * (p - p0), rtol=0, atol=2e-6,
                                       err_msg=f"{k} rank {rank}")
            if rank:
                assert np.abs(gap).max() > 1e-3


@functools.lru_cache(maxsize=None)
def _jax_run_carried_adamw(world):
    """AdaptiveSGD's schedule with ONE AdamW state across the switch."""
    base = optax.adamw(ADAM_LR, weight_decay=WD)
    mesh = jax_make_mesh({"dp": world}, devices=jax.devices()[:world])
    x, y = _batches(world)
    sma, ssgd = (jopt.synchronous_averaging(base, "dp", alpha=ALPHA),
                 jopt.synchronous_sgd(base, "dp"))

    def local(params, x, y, seed):
        params = jax.tree.map(lambda p: p + 0.01 * seed[0], params)
        state = sma.init(params).base
        for i in range(STEPS):
            grads = jax.grad(jax_mlp_loss)(params, (x[i], y[i]))
            if i < CHANGE:
                updates, s = sma.update(grads, jopt._SMAState(state), params)
                state = s.base
            else:
                if i == CHANGE:
                    params = jax.tree.map(lambda p: jax_broadcast(p, "dp"), params)
                updates, state = ssgd.update(grads, state, params)
            params = optax.apply_updates(params, updates)
        return jax.tree.map(lambda p: p[None], params)

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(), P(None, "dp"), P(None, "dp"), P("dp")),
                           out_specs=P("dp"), check_vma=False))
    return jax.tree.map(np.asarray, fn(_params0(), x, y, np.arange(world, dtype=np.float32)))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("base", ["momentum", "adamw"])
def test_zero_state_is_this_ranks_shard(world, n, base):
    """Each rank's state: one (ceil(size / k),) tensor per leaf and state
    key, the same shapes and values as JAX's per-replica shard."""
    case = f"zero_{base}"
    _, state = _jax_run(case, n)
    for rank, res in enumerate(world(n)):
        got = {k[len(case) + 7:]: v for k, v in res.items() if k.startswith(f"{case}.state.")}
        keys = ["momentum_buffer"] if base == "momentum" else ["exp_avg", "exp_avg_sq"]
        assert sorted(got) == sorted(f"{leaf}.{key}" for leaf in SHAPES for key in keys)
        for name, shape in SHAPES.items():
            m = -(-int(np.prod(shape)) // n)
            for key in keys:
                assert got[f"{name}.{key}"].shape == (m,)
        # JAX's array leaves in order: (mu, nu) or (trace,), each by sorted leaf
        want = [s[rank] for s in state]
        assert sorted(w.shape for w in want) == sorted(v.shape for v in got.values())
        for i, key in enumerate(keys):
            for j, name in enumerate(SHAPES):
                np.testing.assert_allclose(got[f"{name}.{key}"], want[i * len(SHAPES) + j],
                                           **TOL, err_msg=f"{case} {name}.{key} rank {rank}")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("base", ["momentum", "adamw"])
def test_zero_matches_ssgd(world, n, base):
    for rank, res in enumerate(world(n)):
        for k in SHAPES:
            np.testing.assert_allclose(res[f"zero_{base}.{k}"], res[f"ssgd_{base}.{k}"],
                                       rtol=1e-6, atol=1e-6, err_msg=f"{k} rank {rank}")


@pytest.mark.parametrize("n", WORLDS)
def test_zero_state_bytes_are_one_kth(world, n):
    total = sum(int(np.prod(s)) for s in SHAPES.values())
    padded = sum(-(-int(np.prod(s)) // n) for s in SHAPES.values())
    for res in world(n):
        assert int(res["zero_momentum.state_bytes"]) == padded * 4
        assert int(res["zero_adamw.state_bytes"]) == padded * 2 * 4 + 4 * len(SHAPES)
        assert padded * n < total + n * len(SHAPES)

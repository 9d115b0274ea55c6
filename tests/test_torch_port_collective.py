"""Parity of the port's device collectives (kungfu_tpu_torch/ops/collective.py
and the session of parallel/mesh.py) with the JAX package's, on two ranks:
the port on a 2-process gloo world, JAX under `shard_map` on two CPU devices,
each rank holding the same numpy inputs in both."""

import time

import jax
import numpy as np
import pytest
import torch.multiprocessing as mp
from jax import lax
from jax.sharding import PartitionSpec as P

from kungfu_tpu.base.ops import ReduceOp as JReduceOp
from kungfu_tpu.ops import collective as jcol
from kungfu_tpu.parallel._compat import shard_map
from kungfu_tpu.parallel.mesh import make_mesh as jax_make_mesh

WORLD = 2

# name -> (port call on this rank's (x, xi, y), JAX call inside shard_map)
CASES = {
    "sum": (lambda c, R, x, xi, y: c.all_reduce(x, R.SUM),
            lambda x, xi, y: jcol.all_reduce(x, "dp", JReduceOp.SUM)),
    "min": (lambda c, R, x, xi, y: c.all_reduce(x, R.MIN),
            lambda x, xi, y: jcol.all_reduce(x, "dp", JReduceOp.MIN)),
    "max": (lambda c, R, x, xi, y: c.all_reduce(x, R.MAX),
            lambda x, xi, y: jcol.all_reduce(x, "dp", JReduceOp.MAX)),
    "average": (lambda c, R, x, xi, y: c.all_average(x),
                lambda x, xi, y: jcol.all_average(x, "dp")),
    "group_sum": (lambda c, R, x, xi, y: c.group_all_reduce([x, xi, y]),
                  lambda x, xi, y: jcol.group_all_reduce([x, xi, y], "dp")),
    "group_average": (lambda c, R, x, xi, y: c.group_all_average([x, y]),
                      lambda x, xi, y: jcol.group_all_average([x, y], "dp")),
    "gather": (lambda c, R, x, xi, y: c.all_gather(x),
               lambda x, xi, y: jcol.all_gather(x, "dp")),
    "gather_tiled": (lambda c, R, x, xi, y: c.all_gather(x, tiled=True),
                     lambda x, xi, y: jcol.all_gather(x, "dp", tiled=True)),
    "gather_axis1_tiled": (lambda c, R, x, xi, y: c.all_gather(x, axis=1, tiled=True),
                           lambda x, xi, y: jcol.all_gather(x, "dp", axis=1, tiled=True)),
    "broadcast_root1": (lambda c, R, x, xi, y: c.broadcast(x, root=1),
                        lambda x, xi, y: jcol.broadcast(x, "dp", root=1)),
    "group_broadcast_root1": (lambda c, R, x, xi, y: c.group_broadcast([x, xi, y], root=1),
                              lambda x, xi, y: jcol.group_broadcast([x, xi, y], "dp", root=1)),
    "reduce_scatter": (lambda c, R, x, xi, y: c.reduce_scatter(x.reshape(-1)),
                       lambda x, xi, y: lax.psum_scatter(x.reshape(-1), "dp",
                                                         scatter_dimension=0, tiled=True)),
    "gather_into": (lambda c, R, x, xi, y: c.all_gather_into(x.new_empty(WORLD * x.numel()),
                                                             x.reshape(-1)),
                    lambda x, xi, y: jcol.all_gather(x.reshape(-1), "dp", tiled=True)),
}


def _inputs(rank):
    rng = np.random.default_rng(100 + rank)
    return (rng.standard_normal((3, 4)).astype(np.float32),
            rng.integers(-50, 50, (5,)).astype(np.int32),
            rng.standard_normal((2,)).astype(np.float32))


def _worker(rank, peers, out_dir):
    import torch

    from kungfu_tpu_torch.base.ops import ReduceOp
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    env = {"KF_SELF_SPEC": peers[rank], "KF_INIT_PEERS": ",".join(peers)}
    device = initialize_device_plane("cpu", environ=env)
    try:
        session = make_mesh(device)
        session.barrier()
        x, xi, y = (torch.from_numpy(a) for a in _inputs(rank))
        out = {}
        for name, (port, _) in CASES.items():
            res = port(collective, ReduceOp, x, xi, y)
            for i, t in enumerate(res if isinstance(res, list) else [res]):
                out[f"{name}.{i}"] = t.numpy()
        (summed,) = session.all_reduce([x])
        out["session_sum.0"] = summed.numpy()
        try:
            collective.all_reduce(x, ReduceOp.PROD)
            out["prod_refused"] = np.array(False)
        except ValueError:
            out["prod_refused"] = np.array(True)
        out["describe"] = np.array(session.describe())
        out["rank_size"] = np.array([session.rank, session.size])
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        shutdown_device_plane()


def _jax_per_rank(jfn):
    """Run jfn under shard_map over two CPU devices; each rank's outputs."""
    per = [_inputs(r) for r in range(WORLD)]
    stacked = [np.concatenate([p[i] for p in per]) for i in range(3)]
    mesh = jax_make_mesh(devices=jax.devices()[:WORLD])

    def f(x, xi, y):
        res = jfn(x, xi, y)
        return res if isinstance(res, list) else [res]

    outs = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("dp"),) * 3, out_specs=P("dp")))(*stacked)
    return [[np.split(np.asarray(o), WORLD)[r] for o in outs] for r in range(WORLD)]


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    import socket

    socks = [socket.socket() for _ in range(WORLD)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    peers = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    out_dir = tmp_path_factory.mktemp("collective")
    ctx = mp.start_processes(_worker, args=(peers, str(out_dir)), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("gloo workers did not finish in 120 s")
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("name", list(CASES))
def test_collective_matches_jax(port_results, name):
    want = _jax_per_rank(CASES[name][1])
    for rank in range(WORLD):
        for i, w in enumerate(want[rank]):
            got = port_results[rank][f"{name}.{i}"]
            assert got.dtype == w.dtype and got.shape == w.shape, (name, i)
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6, err_msg=f"{name} rank {rank}")


def test_session_over_two_ranks(port_results):
    want = _jax_per_rank(CASES["sum"][1])
    for rank, res in enumerate(port_results):
        assert res["rank_size"].tolist() == [rank, WORLD]
        assert "2 devices" in str(res["describe"]) and "gloo" in str(res["describe"])
        assert bool(res["prod_refused"])
        np.testing.assert_allclose(res["session_sum.0"], want[rank][0], rtol=1e-6, atol=1e-6)

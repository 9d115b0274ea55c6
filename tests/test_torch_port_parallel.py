"""Parity of the port's expert, pipeline and tensor parallelism with the JAX
package's, on one gloo world of 4 CPU processes against the JAX functions
under `shard_map` (or jit with shardings) on 4 CPU devices, from the same
numpy inputs:

- `ops.moe.moe_ffn` (top-1 and top-2, 1, 2 and 4 experts a rank, capacity
  factor 0.5 and 1.25 with drops, 4.0 without) and `switch_moe`: the output,
  the aux loss and the gradients of x, the router and both expert stacks
  of the loss sum(out * cot) + 0.7 aux within 1e-5 in f32 (one bf16 case
  at 2e-2);
- `ops.collective.all_to_all` (forward and backward) and
  `subset_all_reduce` (three masks) against `lax.all_to_all` and the JAX
  function; `fuse_pytree` against JAX's on three trees;
- `make_pp_transformer_loss` at pp 2 (n_micro 2), pp 4 (n_micro 4 and 2)
  and pp 2 x dp 2: the loss and every leaf's gradient (after
  `pipeline_sgd` sums the replicated leaves over pp and averages over dp)
  within 1e-5 of each leaf's scale of JAX's pipeline and of the dense
  loss; pp 2 in bf16 within 2e-2;
- `make_sharded_train_step` at dp 2 x tp 2, dp 1 x tp 2 x sp 2 and
  dp 1 x tp 4: the
  parameters after one SGD step, gathered to JAX's layout, within 1e-5 of
  JAX's sharded step and of the unsharded step;
- S-SGD with a parameter that one rank leaves unused (zeros in its place),
  `DeviceSession.axes_group` over each set of a 2 x 2 mesh's axes, the
  rendezvous port's range and its check, and the port's
  `dryrun_multichip(4)`; without a world: the converters' round trips
  (tp 1/2/4, pp 1/2/4, epd 1/2/4), the card's plain MoE oracle and its own
  routing (ties included), a mesh's sub-meshes over several axes, argument
  errors, and `_mesh_axes` against `__graft_entry__._mesh_axes`."""

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
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from kungfu_tpu.models import transformer as jtr
from kungfu_tpu.ops import collective as jcol
from kungfu_tpu.ops.moe import moe_ffn as jax_moe_ffn, switch_moe as jax_switch_moe
from kungfu_tpu.parallel import sharded as jsh
from kungfu_tpu.parallel._compat import shard_map
from kungfu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kungfu_tpu.parallel.pipeline import make_pp_transformer_loss as jax_pp_loss

WORLD = 4
DIMS = dict(vocab_size=64, d_model=16, n_heads=4, n_layers=4, d_ff=32, max_seq=16)
GLOBAL_B, SEQ, LR = 4, 16, 0.1
MOE_T, MOE_D, MOE_F, AUX_W = 8, 8, 16, 0.7
# (name, top_k, epd, capacity factor, dtype)
MOE_CASES = [(f"top{k}-epd{e}-cf{cf}", k, e, cf, "float32")
             for k in (1, 2) for e in (1, 2) for cf in (1.25, 4.0)]
MOE_CASES += [("top2-epd2-cf1.25-bf16", 2, 2, 1.25, "bfloat16"),
              ("switch-cf2.0", 1, 1, 2.0, "float32"),
              ("top2-epd4-cf1.25", 2, 4, 1.25, "float32"),  # E 16: capacity 1
              ("top1-epd1-cf0.5", 1, 1, 0.5, "float32")]
# (name, mesh, n_micro, dp axis, dtype)
PP_CASES = [("pp2", {"rep": 2, "pp": 2}, 2, None, "float32"),
            ("pp4", {"pp": 4}, 4, None, "float32"),
            ("pp2xdp2", {"dp": 2, "pp": 2}, 2, "dp", "float32"),
            ("pp4-micro2", {"pp": 4}, 2, None, "float32"),  # fewer microbatches than stages
            ("pp2-bf16", {"rep": 2, "pp": 2}, 2, None, "bfloat16")]
# (name, mesh)
TP_CASES = [("dp2xtp2", {"dp": 2, "tp": 2}), ("dp1xtp2xsp2", {"dp": 1, "tp": 2, "sp": 2}),
            ("dp1xtp4", {"dp": 1, "tp": 4})]
SUBSET_MASKS = ([1, 0, 1, 1], [0, 1, 0, 0], [1, 1, 1, 1])
SUBSET_MASK = SUBSET_MASKS[0]


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _moe_inputs(epd, dtype):
    E = WORLD * epd
    rng = np.random.default_rng(100 + epd)
    x = rng.standard_normal((WORLD * MOE_T, MOE_D)).astype(np.float32)
    rw = rng.standard_normal((MOE_D, E)).astype(np.float32)
    w_in = (rng.standard_normal((E, MOE_D, MOE_F)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((E, MOE_F, MOE_D)) * 0.3).astype(np.float32)
    cot = rng.standard_normal((WORLD * MOE_T, MOE_D)).astype(np.float32)
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, rw, w_in, w_out, cot


def _tokens(seed, cols):
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"], (GLOBAL_B, cols)).astype(np.int32)


def _jax_params():
    jcfg = jtr.TransformerConfig(**DIMS, dtype=jnp.float32)
    return jax.tree.map(np.asarray, jtr.init_transformer(jax.random.PRNGKey(0), jcfg))


# ---------------------------------------------------------------------------
# the port, one process per rank
# ---------------------------------------------------------------------------

def _port_moe(rank, out):
    from kungfu_tpu_torch.models import convert
    from kungfu_tpu_torch.ops import moe

    for name, top_k, epd, cf, dtype in MOE_CASES:
        dt = getattr(torch, dtype)
        x, rw, w_in, w_out, cot = (torch.from_numpy(a) for a in _moe_inputs(epd, dtype))
        part = slice(rank * MOE_T, (rank + 1) * MOE_T)
        xr = x[part].to(dt).requires_grad_()
        rw = rw.requires_grad_()
        wi = convert.ep_shard(w_in.numpy(), rank, epd).requires_grad_()
        wo = convert.ep_shard(w_out.numpy(), rank, epd).requires_grad_()
        if name.startswith("switch"):
            y, aux = moe.switch_moe(xr, rw, wi[0], wo[0], None, capacity_factor=cf)
        else:
            y, aux = moe.moe_ffn(xr, rw, wi, wo, None, top_k=top_k, capacity_factor=cf)
        loss = (y.float() * cot[part]).sum() + AUX_W * aux / WORLD
        grads = torch.autograd.grad(loss, (xr, rw, wi, wo))
        for key, t in zip(("out", "aux", "dx", "drouter", "dw_in", "dw_out"), (y, aux, *grads)):
            out[f"moe.{name}.{key}"] = t.detach().float().numpy()
        out[f"moe.{name}.dropped"] = np.array(
            moe.dropped_tokens(xr.detach(), rw.detach(), WORLD * epd, top_k, cf))


def _port_collectives(rank, out):
    from kungfu_tpu_torch.ops import collective

    rng = np.random.default_rng(7)
    xs = rng.standard_normal((WORLD, WORLD, 3)).astype(np.float32)
    cots = rng.standard_normal((WORLD, WORLD, 3)).astype(np.float32)
    x = torch.from_numpy(xs[rank]).requires_grad_()
    y = collective.all_to_all(x)
    (g,) = torch.autograd.grad(y, x, torch.from_numpy(cots[rank]))
    out["a2a.y"], out["a2a.g"] = y.detach().numpy(), g.numpy()
    out["subset"] = collective.subset_all_reduce(torch.from_numpy(xs[rank]), SUBSET_MASK).numpy()
    for i, mask in enumerate(SUBSET_MASKS):
        out[f"subset.{i}"] = collective.subset_all_reduce(torch.from_numpy(xs[rank]), mask).numpy()


def _port_pipeline(rank, params, out):
    from kungfu_tpu_torch.models import convert, transformer as ttr
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.parallel.dp import shard_batch
    from kungfu_tpu_torch.parallel.mesh import make_mesh
    from kungfu_tpu_torch.parallel.pipeline import make_pp_transformer_loss, pipeline_sgd

    tokens = torch.from_numpy(_tokens(0, SEQ + 1))
    for name, shape, n_micro, dp, dtype in PP_CASES:
        cfg = ttr.TransformerConfig(**DIMS, dtype=getattr(torch, dtype))
        session = make_mesh("cpu", shape=shape)
        pp = session.axis_size("pp")
        model = ttr.Transformer(cfg, convert.pp_stage(params, session.axis_index("pp"), pp))
        loss_fn = make_pp_transformer_loss(cfg, session, n_micro, dp_axis=dp)
        batch = (tokens[:, :-1], tokens[:, 1:])
        if dp is not None:
            batch = shard_batch(batch, session, axes=(dp,))
        loss = loss_fn(model, batch)
        loss.backward()
        pipeline_sgd(torch.optim.SGD(model.parameters(), lr=0.0), model, session,
                     dp_axis=dp).average_gradients()
        out[f"pp.{name}.loss"] = collective.all_average(loss.detach()).numpy()
        grads = convert.grads_to_jax(model)
        for k in convert.TOP_KEYS:
            out[f"pp.{name}.grad.{k}"] = grads[k]
        for k, g in grads["layers"].items():
            out[f"pp.{name}.grad.layers.{k}"] = g


def _port_sharded(rank, params, out):
    from kungfu_tpu_torch.models import convert, transformer as ttr
    from kungfu_tpu_torch.parallel.mesh import make_mesh
    from kungfu_tpu_torch.parallel.sharded import (gather_params, make_sharded_train_step,
                                                   shard_params)

    cfg = ttr.TransformerConfig(**DIMS, dtype=torch.float32)
    batch = torch.from_numpy(_tokens(1, SEQ + 1))
    for name, shape in TP_CASES:
        session = make_mesh("cpu", shape=shape)
        specs = ttr.param_pspecs(cfg)
        sp = "sp" if "sp" in shape else None
        full = convert.tp_layout(convert.transformer_params_from_jax(params), shape["tp"])
        model = ttr.Transformer(cfg, shard_params(full, session, specs))
        Sl = SEQ // (shape.get("sp", 1))
        start = session.axis_index("sp") * Sl if sp else 0

        def loss_fn(model, b):
            tokens, targets = (t.narrow(1, start, Sl) for t in (b[:, :-1], b[:, 1:]))
            return ttr.tp_transformer_loss(model.tree(), (tokens, targets), cfg, session,
                                           sp_axis=sp)

        opt = torch.optim.SGD(model.parameters(), lr=LR)
        step = make_sharded_train_step(loss_fn, opt, session, specs, batch_spec=("dp",))
        out[f"tp.{name}.loss"] = step(model, batch).numpy()
        whole = convert.to_jax(convert.tp_unlayout(gather_params(model.tree(), session, specs),
                                                   shape["tp"]))
        for k in convert.TOP_KEYS:
            out[f"tp.{name}.{k}"] = whole[k]
        for k, v in whole["layers"].items():
            out[f"tp.{name}.layers.{k}"] = v


def _port_unused_param(rank, out):
    """Rank 1 leaves `b` without a gradient; S-SGD fills it with zeros."""
    from kungfu_tpu_torch.optimizers.core import synchronous_sgd
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    a = torch.nn.Parameter(torch.arange(3.0))
    b = torch.nn.Parameter(torch.ones(2))
    loss = (a * (rank + 1)).sum() + ((b * (rank + 2)).sum() if rank != 1 else 0.0)
    loss.backward()
    assert (b.grad is None) == (rank == 1)
    opt = synchronous_sgd(torch.optim.SGD([a, b], lr=0.0), make_mesh("cpu"))
    opt.step()
    out["unused.a"], out["unused.b"] = a.grad.numpy(), b.grad.numpy()


AXES_CASES = [(), ("a",), ("b",), ("a", "b"), ("b", "a")]


def _port_axes_groups(rank, out):
    """A sum of the ranks over `axes_group` of each set of axes of a 2 x 2
    mesh ("a" rows, "b" columns: rank = 2 a + b)."""
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    session = make_mesh("cpu", shape={"a": 2, "b": 2})
    for axes in AXES_CASES:
        out[f"axes.{'.'.join(axes)}"] = collective.all_reduce(
            torch.tensor([float(rank)]), group=session.axes_group(axes)).numpy()


def _worker(rank, peers, params, out_dir):
    torch.set_num_threads(1)
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane

    env = {"KF_SELF_SPEC": peers[rank], "KF_INIT_PEERS": ",".join(peers)}
    initialize_device_plane("cpu", environ=env)
    try:
        out = {}
        _port_unused_param(rank, out)
        _port_collectives(rank, out)
        _port_axes_groups(rank, out)
        _port_moe(rank, out)
        _port_pipeline(rank, params, out)
        _port_sharded(rank, params, out)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        shutdown_device_plane()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results from the one gloo world of 4 processes."""
    out_dir = tmp_path_factory.mktemp("parallel")
    peers = [f"127.0.0.1:{p}" for p in _free_ports(WORLD)]
    ctx = mp.start_processes(_worker, args=(peers, _jax_params(), str(out_dir)), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo world of {WORLD} did not finish in 240 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)]


# ---------------------------------------------------------------------------
# JAX on CPU devices
# ---------------------------------------------------------------------------

def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    return jax_make_mesh(shape, devices=jax.devices()[:n])


def _close(got, want, scale_tol, err_msg=""):
    """Within scale_tol of the largest |want|."""
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_tol * scale, err_msg=err_msg)


@functools.lru_cache(maxsize=None)
def _jax_moe(name):
    _, top_k, epd, cf, dtype = next(c for c in MOE_CASES if c[0] == name)
    x, rw, w_in, w_out, cot = _moe_inputs(epd, dtype)
    dt = getattr(jnp, dtype)
    if name.startswith("switch"):
        def body(x, rw, wi, wo):
            return jax_switch_moe(x, rw, wi[0], wo[0], "ep", WORLD, cf)
    else:
        def body(x, rw, wi, wo):
            return jax_moe_ffn(x, rw, wi, wo, "ep", WORLD, top_k=top_k, capacity_factor=cf)
    fn = shard_map(body, mesh=_mesh({"ep": WORLD}), in_specs=(P("ep"), P(), P("ep"), P("ep")),
                   out_specs=(P("ep"), P()), check_vma=False)

    def loss(x, rw, wi, wo):
        y, aux = fn(x, rw, wi, wo)
        return (y.astype(jnp.float32) * cot).sum() + AUX_W * aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
        jnp.asarray(x, dt), rw, w_in, w_out)
    return [np.asarray(t, np.float32) for t in (y, aux, *grads)]


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_matches_jax(world, case):
    name, top_k, epd, cf, dtype = case
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    y, aux, dx, drouter, dwi, dwo = _jax_moe(name)
    dropped = sum(int(r[f"moe.{name}.dropped"]) for r in world)
    if cf == 1.25:
        assert dropped > 0, "the case must drop tokens"
    elif cf == 4.0:
        assert dropped == 0
    key = f"moe.{name}"
    for rank, r in enumerate(world):
        part = slice(rank * MOE_T, (rank + 1) * MOE_T)
        np.testing.assert_allclose(r[f"{key}.out"], y[part], rtol=tol, atol=tol)
        np.testing.assert_allclose(r[f"{key}.aux"], aux, rtol=tol, atol=tol)
        np.testing.assert_allclose(r[f"{key}.dx"], dx[part], rtol=tol, atol=tol)
        experts = slice(rank * epd, (rank + 1) * epd)
        np.testing.assert_allclose(r[f"{key}.dw_in"], dwi[experts], rtol=tol, atol=tol)
        np.testing.assert_allclose(r[f"{key}.dw_out"], dwo[experts], rtol=tol, atol=tol)
    # the router is replicated: its gradient is the sum of the ranks' own
    np.testing.assert_allclose(sum(r[f"{key}.drouter"] for r in world), drouter,
                               rtol=tol, atol=tol)


def test_all_to_all_and_subset_all_reduce_match_jax(world):
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((WORLD, WORLD, 3)).astype(np.float32)
    cots = rng.standard_normal((WORLD, WORLD, 3)).astype(np.float32)
    mesh = _mesh({"ep": WORLD})
    a2a = shard_map(lambda x: lax.all_to_all(x, "ep", 0, 0, tiled=False), mesh=mesh,
                    in_specs=P("ep"), out_specs=P("ep"), check_vma=False)
    flat = xs.reshape(WORLD * WORLD, 3)
    y, vjp = jax.vjp(a2a, flat)
    (g,) = vjp(cots.reshape(WORLD * WORLD, 3))
    mask = jnp.asarray(SUBSET_MASK)
    sub = shard_map(lambda x: jcol.subset_all_reduce(x, mask, "ep"), mesh=mesh,
                    in_specs=P("ep"), out_specs=P("ep"), check_vma=False)(flat)
    y, g, sub = (np.asarray(t).reshape(WORLD, WORLD, 3) for t in (y, g, sub))
    for rank, r in enumerate(world):
        np.testing.assert_array_equal(r["a2a.y"], y[rank])
        np.testing.assert_array_equal(r["a2a.g"], g[rank])
        np.testing.assert_allclose(r["subset"], sub[rank], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("i", range(len(SUBSET_MASKS)), ids=[str(m) for m in SUBSET_MASKS])
def test_subset_all_reduce_matches_jax_for_each_mask(world, i):
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((WORLD, WORLD, 3)).astype(np.float32)
    mask = jnp.asarray(SUBSET_MASKS[i])
    sub = shard_map(lambda x: jcol.subset_all_reduce(x, mask, "ep"), mesh=_mesh({"ep": WORLD}),
                    in_specs=P("ep"), out_specs=P("ep"), check_vma=False)(
        xs.reshape(WORLD * WORLD, 3))
    sub = np.asarray(sub).reshape(WORLD, WORLD, 3)
    for rank, r in enumerate(world):
        np.testing.assert_allclose(r[f"subset.{i}"], sub[rank], rtol=1e-6, atol=1e-6)


FUSE_TREES = {
    "mixed": lambda rng: {"w": rng.standard_normal((2, 3)).astype(np.float32),
                          "b": {"z": rng.integers(0, 9, (4,)).astype(np.int32),
                                "a": rng.standard_normal((1,)).astype(np.float32)}},
    "flat": lambda rng: {"c": rng.standard_normal((5,)).astype(np.float32),
                         "a": rng.standard_normal((2, 2)).astype(np.float32)},
    "deep": lambda rng: {"x": {"y": {"z": rng.integers(-9, 9, (3,)).astype(np.int16)}},
                         "s": np.asarray(rng.standard_normal(()), np.float32)},
}


@pytest.mark.parametrize("tree_name", list(FUSE_TREES))
def test_fuse_pytree_matches_jax(tree_name):
    from kungfu_tpu_torch.ops import collective

    tree = FUSE_TREES[tree_name](np.random.default_rng(3))
    want, unflatten = jcol.fuse_pytree(jax.tree.map(jnp.asarray, tree))
    got, t_unflatten = collective.fuse_pytree(jax.tree.map(torch.from_numpy, tree))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    back, t_back = unflatten(want), t_unflatten(got)
    paths, _ = zip(*jax.tree_util.tree_flatten_with_path(back)[0])
    for path in paths:
        a, b = back, t_back
        for key in path:
            a, b = a[key.key], b[key.key]
        assert b.dtype == getattr(torch, str(a.dtype))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-7)


@functools.lru_cache(maxsize=None)
def _jax_dense_grads(seed, cols, dtype="float32"):
    jcfg = jtr.TransformerConfig(**DIMS, dtype=getattr(jnp, dtype))
    tokens = _tokens(seed, cols)
    return jax.jit(jax.value_and_grad(lambda p, b: jtr.transformer_loss(p, b, jcfg)))(
        _jax_params(), (tokens[:, :-1], tokens[:, 1:]))


@pytest.mark.parametrize("case", PP_CASES, ids=[c[0] for c in PP_CASES])
def test_pipeline_matches_jax_and_dense(world, case):
    from kungfu_tpu_torch.models import convert

    name, shape, n_micro, dp, dtype = case
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    pp = shape["pp"]
    jcfg = jtr.TransformerConfig(**DIMS, dtype=getattr(jnp, dtype))
    jshape = {k: v for k, v in shape.items() if k != "rep"}
    fn = jax_pp_loss(jcfg, _mesh(jshape), n_micro, dp_axis=dp)
    tokens = _tokens(0, SEQ + 1)
    loss, grads = jax.jit(jax.value_and_grad(fn))(_jax_params(),
                                                  (tokens[:, :-1], tokens[:, 1:]))
    dense_loss, dense = _jax_dense_grads(0, SEQ + 1, dtype)
    np.testing.assert_allclose(float(loss), float(dense_loss), rtol=tol)
    key = f"pp.{name}"
    # ranks are laid out row-major: stage s of replica/dp row i is rank i * pp + s
    for row in range(WORLD // pp):
        ranks = world[row * pp:(row + 1) * pp]
        stages = [{**{k: r[f"{key}.grad.{k}"] for k in convert.TOP_KEYS},
                   "layers": {k: r[f"{key}.grad.layers.{k}"] for k in convert.LAYER_KEYS}}
                  for r in ranks]
        got = convert.pp_unstage(stages)
        for r in ranks:
            np.testing.assert_allclose(r[f"{key}.loss"], float(loss), rtol=tol)
            for k in convert.TOP_KEYS:  # summed over the stages: the same on each
                np.testing.assert_array_equal(r[f"{key}.grad.{k}"], got[k])
        for want in (grads, dense):
            for k in convert.TOP_KEYS:
                _close(got[k], want[k], tol, err_msg=f"{name} {k}")
            for k in convert.LAYER_KEYS:
                _close(got["layers"][k], want["layers"][k], tol, err_msg=f"{name} {k}")


@functools.lru_cache(maxsize=None)
def _jax_sharded_params(name):
    shape = dict(TP_CASES)[name]
    jcfg = jtr.TransformerConfig(**DIMS, dtype=jnp.float32)
    mesh = _mesh(shape)
    specs = jtr.param_pspecs(jcfg, "tp")

    def loss_fn(params, batch):
        tokens, targets = batch[:, :-1], batch[:, 1:]
        if "sp" in shape:
            tokens = lax.with_sharding_constraint(tokens, NamedSharding(mesh, P("dp", "sp")))
        return jtr.transformer_loss(params, (tokens, targets), jcfg)

    opt = optax.sgd(LR)
    params = jsh.shard_params(jax.tree.map(jnp.asarray, _jax_params()), mesh, specs)
    step = jsh.make_sharded_train_step(loss_fn, opt, mesh, specs, batch_spec=P("dp"),
                                       donate=False)
    batch = jax.device_put(jnp.asarray(_tokens(1, SEQ + 1)), NamedSharding(mesh, P("dp", None)))
    params, _, loss = step(params, opt.init(params), batch)
    return jax.tree.map(np.asarray, params), float(loss)


@pytest.mark.parametrize("name", [c[0] for c in TP_CASES])
def test_sharded_step_matches_jax_and_unsharded(world, name):
    from kungfu_tpu_torch.models import convert

    params, loss = _jax_sharded_params(name)
    dense_loss, dense_grads = _jax_dense_grads(1, SEQ + 1)
    unsharded = jax.tree.map(lambda p, g: p - LR * np.asarray(g), _jax_params(), dense_grads)
    np.testing.assert_allclose(loss, float(dense_loss), rtol=1e-5)
    key = f"tp.{name}"
    for rank, r in enumerate(world):
        np.testing.assert_allclose(r[f"{key}.loss"], loss, rtol=1e-5)
        for want in (params, unsharded):
            for k in convert.TOP_KEYS:
                np.testing.assert_allclose(r[f"{key}.{k}"], want[k], rtol=0, atol=1e-5,
                                           err_msg=f"{k} rank {rank}")
            for k in convert.LAYER_KEYS:
                np.testing.assert_allclose(r[f"{key}.layers.{k}"], want["layers"][k], rtol=0,
                                           atol=1e-5, err_msg=f"{k} rank {rank}")


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_layout_round_trips_and_splits_heads(tp):
    from kungfu_tpu_torch.models import convert
    from kungfu_tpu_torch.models.transformer import param_pspecs, TransformerConfig

    params = _jax_params()
    cfg = TransformerConfig(**DIMS, dtype=torch.float32)
    specs = param_pspecs(cfg)
    shards = [convert.to_jax(convert.tp_shard(params, specs, r, tp)) for r in range(tp)]
    back = convert.tp_unshard(shards, specs)
    for k in convert.TOP_KEYS:
        np.testing.assert_array_equal(back[k], params[k])
    for k in convert.LAYER_KEYS:
        np.testing.assert_array_equal(back["layers"][k], params["layers"][k])
    # rank r's wqkv shard holds q, k and v of heads [r H/tp, (r+1) H/tp):
    # columns [j D + r D/tp, j D + (r+1) D/tp) of JAX's [q | k | v]
    D, w = DIMS["d_model"], DIMS["d_model"] // tp
    for r, shard in enumerate(shards):
        want = np.concatenate([params["layers"]["wqkv"][..., j * D + r * w:j * D + (r + 1) * w]
                               for j in range(3)], axis=-1)
        np.testing.assert_array_equal(shard["layers"]["wqkv"], want)


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_pp_stage_round_trips(n_stages):
    from kungfu_tpu_torch.models import convert

    params = _jax_params()
    stages = [convert.to_jax(convert.pp_stage(params, s, n_stages)) for s in range(n_stages)]
    per = DIMS["n_layers"] // n_stages
    for s, stage in enumerate(stages):
        np.testing.assert_array_equal(stage["layers"]["wo"],
                                      params["layers"]["wo"][s * per:(s + 1) * per])
    back = convert.pp_unstage(stages)
    for k in convert.TOP_KEYS:
        np.testing.assert_array_equal(back[k], params[k])
    for k in convert.LAYER_KEYS:
        np.testing.assert_array_equal(back["layers"][k], params["layers"][k])


@pytest.mark.parametrize("epd", [1, 2, 4])
def test_ep_shard_round_trips(epd):
    from kungfu_tpu_torch.models import convert

    stack = np.random.default_rng(epd).standard_normal((WORLD * epd, 3, 2)).astype(np.float32)
    blocks = [convert.ep_shard(stack, r, epd) for r in range(WORLD)]
    assert all(b.shape == (epd, 3, 2) for b in blocks)
    np.testing.assert_array_equal(blocks[1].numpy(), stack[epd:2 * epd])
    np.testing.assert_array_equal(convert.ep_unshard([b.numpy() for b in blocks]), stack)


def _bad_call(case):
    from kungfu_tpu_torch.ops import collective, moe
    from kungfu_tpu_torch.models.convert import shard_tree

    x, rw = torch.zeros(4, 8), torch.zeros(8, 2)
    w_in, w_out = torch.zeros(2, 8, 16), torch.zeros(2, 16, 8)
    return {
        "moe-top3": lambda: moe.moe_ffn(x, rw, w_in, w_out, top_k=3),
        "moe-router-width": lambda: moe.moe_ffn(x, torch.zeros(8, 3), w_in, w_out),
        "all-to-all-shape": lambda: collective.all_to_all(torch.zeros(2, 3)),
        "shard-indivisible": lambda: shard_tree({"w": torch.zeros(3, 4)}, {"w": ("tp", None)},
                                                {"tp": 2}, {"tp": 0}),
    }[case]


@pytest.mark.parametrize("case", ["moe-top3", "moe-router-width", "all-to-all-shape",
                                  "shard-indivisible"])
def test_bad_arguments_raise(case):
    with pytest.raises(ValueError):
        _bad_call(case)()


@pytest.mark.parametrize("axes", AXES_CASES, ids=[".".join(a) or "none" for a in AXES_CASES])
def test_axes_group_spans_the_named_axes(world, axes):
    for rank, r in enumerate(world):
        a, b = divmod(rank, 2)
        members = [2 * i + j for i in ((0, 1) if "a" in axes else (a,))
                   for j in ((0, 1) if "b" in axes else (b,))]
        np.testing.assert_array_equal(r[f"axes.{'.'.join(axes)}"], [float(sum(members))])


@pytest.mark.parametrize("axes,want", [
    (("dp",), [[0, 4], [1, 5], [2, 6], [3, 7]]),
    (("sp",), [[0, 1], [2, 3], [4, 5], [6, 7]]),
    (("dp", "sp"), [[0, 1, 4, 5], [2, 3, 6, 7]]),
    (("tp", "sp"), [[0, 1, 2, 3], [4, 5, 6, 7]]),
    ((), [[r] for r in range(8)]),
])
def test_axis_lines_over_several_axes(axes, want):
    """The sub-meshes a group is made of, on a dp 2 x tp 2 x sp 2 mesh laid
    out row-major (rank = 4 dp + 2 tp + sp)."""
    from kungfu_tpu_torch.parallel.mesh import _axis_lines

    assert _axis_lines({"dp": 2, "tp": 2, "sp": 2}, axes) == want


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_axes_match_the_jax_entry(n):
    import __graft_entry__ as jax_entry
    from kungfu_tpu_torch.graft_entry import _mesh_axes

    try:
        want = jax_entry._mesh_axes(n)
    except AssertionError:
        with pytest.raises(ValueError):
            _mesh_axes(n)
        return
    assert _mesh_axes(n) == want


def test_ssgd_fills_an_unused_parameter_with_zeros(world):
    for r in world:
        np.testing.assert_allclose(r["unused.a"], np.full(3, (1 + 2 + 3 + 4) / WORLD))
        # rank 1 contributes zero: (2 + 4 + 5) / 4
        np.testing.assert_allclose(r["unused.b"], np.full(2, (2 + 4 + 5) / WORLD))


@pytest.mark.parametrize("spec", ["127.0.0.1:10000", "10.0.0.7:38001", "host-a:65535",
                                  "127.0.0.1:1", "node12:40000"])
def test_rendezvous_port_is_outside_the_ephemeral_and_kfrun_ranges(spec):
    from kungfu_tpu_torch.parallel.distributed import WorkerSpec, rendezvous_address

    _, port = rendezvous_address(WorkerSpec(spec, (spec, "127.0.0.1:2")))
    assert 20000 <= port < 30000
    assert not 32768 <= port <= 60999 and not 38000 <= port <= 38999


def test_a_taken_rendezvous_port_raises_naming_it():
    from kungfu_tpu_torch.parallel.distributed import (WorkerSpec, initialize_device_plane,
                                                       rendezvous_address)

    for p in _free_ports(8):
        peers = (f"127.0.0.1:{p}", "127.0.0.1:1")
        _, port = rendezvous_address(WorkerSpec(peers[0], peers))
        holder = socket.socket()
        try:
            holder.bind(("127.0.0.1", port))
        except OSError:
            holder.close()
            continue  # taken by someone else already: try another spec
        try:
            holder.listen(1)
            env = {"KF_SELF_SPEC": peers[0], "KF_INIT_PEERS": ",".join(peers)}
            with pytest.raises(RuntimeError, match=f"port {port} "):
                initialize_device_plane("cpu", environ=env)
            return
        finally:
            holder.close()
    pytest.fail("found no free port to take")


def test_dryrun_multichip_runs_on_four_cpu_ranks():
    from kungfu_tpu_torch.graft_entry import _mesh_axes, dryrun_multichip

    assert _mesh_axes(4) == (2, 2, 1) and _mesh_axes(8) == (2, 2, 2) and _mesh_axes(3) == (1, 3, 1)
    dryrun_multichip(4, device="cpu")


@pytest.mark.parametrize("top_k", [1, 2])
def test_plain_moe_matches_moe_ffn_in_one_process(top_k):
    """The card's oracle, `moe_ffn_plain` (each expert takes its kept
    tokens directly), against `moe_ffn` as a world of one, values and
    gradients, with drops (capacity factor 1.0)."""
    from kungfu_tpu_torch.ops import moe

    x, rw, w_in, w_out, cot = (torch.from_numpy(a) for a in _moe_inputs(2, "float32"))
    x, cot = x[None, :16], cot[None, :16]
    assert moe.dropped_tokens(x[0], rw, 8, top_k, 1.0) > 0
    results = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, rw, w_in, w_out)]
        if plain:
            y, aux = moe.moe_ffn_plain(*leaves, top_k=top_k, capacity_factor=1.0)
        else:
            y, aux = moe.moe_ffn(leaves[0][0], *leaves[1:], None, top_k=top_k,
                                 capacity_factor=1.0)
            y = y[None]
        loss = (y * cot).sum() + AUX_W * aux
        results.append([y, aux, *torch.autograd.grad(loss, leaves)])
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("router", ["random", "ties"])
def test_plain_routing_matches_moe_ffn_routing(top_k, router):
    """The oracle's routing (`_route_plain`: host argsort, counted slots)
    picks the experts and keeps the (token, choice) pairs that `moe_ffn`'s
    does (`_route`), also where every probability ties (a zero router: the
    lower expert index first, as `lax.top_k`)."""
    from kungfu_tpu_torch.ops import moe

    x, rw, *_ = (torch.from_numpy(a) for a in _moe_inputs(2, "float32"))
    if router == "ties":
        rw = torch.zeros_like(rw)
    E, C = rw.shape[1], 3
    probs, gates, primary, choices = moe._route(x, rw, E, top_k, C)
    probs_p, gates_p, experts_p, kept_p = moe._route_plain(x, rw, E, top_k, C)
    assert (~kept_p).any()
    torch.testing.assert_close(probs_p, probs, rtol=0, atol=0)
    torch.testing.assert_close(gates_p, gates, rtol=0, atol=0)
    assert torch.equal(experts_p[:, 0], primary)
    for j, (se, sc, kept) in enumerate(choices):
        assert torch.equal(kept_p[:, j], kept)
        assert torch.equal(experts_p[:, j][kept], se[kept])

"""Parity of the port's sequence-parallel path with the JAX package's, on
gloo worlds of 2, 3 and 4 CPU processes against JAX under `shard_map` on as
many CPU devices, from the same numpy inputs:

- `ops.collective.ring_shift` (forward and backward) against `lax.ppermute`;
- `ring_self_attention_plain` and the kernel path `ring_self_attention`
  (the flash kernels' plain twins on CPU tensors) against JAX's
  `ring_self_attention`: outputs within 1e-5, gradients (a vjp with the
  same cotangent) within rtol 1e-4 / atol 1e-5, as tests/test_ring_attention.py
  holds JAX's own ring;
- `make_ring_transformer_loss` at dp x sp = 1 x 2 and 2 x 2: the world-mean
  loss within 1e-5 and S-SGD's world-mean gradients within 2e-4 of JAX's
  loss and gradient, with no rescaling;
- 3 S-SGD AdamW steps on 2 x 2: every rank's parameters within 1e-4;
- the 2-D session's rank layout and groups against JAX `make_mesh`.

One world is spawned per size and runs every case of that size."""

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
from jax.sharding import PartitionSpec as P

from kungfu_tpu.models import transformer as jtr
from kungfu_tpu.ops.ring_attention import ring_self_attention as jax_ring
from kungfu_tpu.parallel._compat import shard_map
from kungfu_tpu.parallel.mesh import make_mesh as jax_make_mesh

B, H, HD = 1, 2, 8
DIMS = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=2, d_ff=32, max_seq=16)
GLOBAL_B, SEQ, LR, STEPS = 4, 16, 1e-2, 3
SHIFTS = (1, -1, 2)
MESHES = ({"dp": 2, "sp": 2}, {"dp": -1, "sp": 2}, {"sp": 4})


def _attn_cases(sp):
    """(impl, causal, S_local, blk_k) run on a ring of `sp` ranks."""
    cases = [(impl, causal, 16, 1024) for impl in ("plain", "kernel") for causal in (True, False)]
    if sp == 2:
        # blk_k < S_local streams sub-blocks; 12 % 8 shrinks blk_k to 6;
        # S_local 70 is ragged against the kernels' 64-row tiles
        cases += [("plain", True, 16, 4), ("plain", True, 16, 8), ("plain", False, 16, 8),
                  ("plain", True, 12, 8), ("kernel", True, 70, 1024), ("kernel", False, 70, 1024)]
    if sp == 3:
        cases = [("kernel", True, 16, 1024), ("plain", True, 16, 1024)]
    return cases


def _case_id(sp, case):
    impl, causal, sl, blk = case
    return f"sp{sp}-{impl}-{'causal' if causal else 'full'}-sl{sl}-blk{blk}"


ATTN_CASES = [(sp, case) for sp in (2, 3, 4) for case in _attn_cases(sp)]
MODEL_CASES = [(dp, sp, core) for dp, sp in ((1, 2), (2, 2)) for core in ("kernel", "plain")]


def _attn_inputs(sp, sl, seed=0):
    rng = np.random.default_rng(seed + 10 * sp + sl)
    return [rng.standard_normal((B, H, sp * sl, HD)).astype(np.float32) for _ in range(4)]


def _shift_inputs(world):
    rng = np.random.default_rng(5)
    return (rng.standard_normal((world, 3, 4)).astype(np.float32),
            rng.standard_normal((world, 3, 4)).astype(np.float32))


def _tokens(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, DIMS["vocab_size"], (GLOBAL_B, SEQ)).astype(np.int32),
            rng.integers(0, DIMS["vocab_size"], (GLOBAL_B, SEQ)).astype(np.int32))


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

def _port_attention(rank, world, out):
    from kungfu_tpu_torch.ops import ring_attention as tra

    fns = {"plain": tra.ring_self_attention_plain, "kernel": tra.ring_self_attention}
    for case in _attn_cases(world):
        impl, causal, sl, blk = case
        q, k, v, do = (torch.from_numpy(a[:, :, rank * sl:(rank + 1) * sl].copy())
                       for a in _attn_inputs(world, sl))
        qkv = [t.requires_grad_() for t in (q, k, v)]
        o = fns[impl](*qkv, None, causal=causal, blk_k=blk)
        grads = torch.autograd.grad(o, qkv, do)
        for name, t in zip(("o", "dq", "dk", "dv"), (o, *grads)):
            out[f"{_case_id(world, case)}.{name}"] = t.detach().numpy()


def _port_shift(rank, world, out):
    from kungfu_tpu_torch.ops import collective

    xs, cots = _shift_inputs(world)
    for s in SHIFTS:
        x = torch.from_numpy(xs[rank].copy()).requires_grad_()
        y = collective.ring_shift(x, None, s)
        (g,) = torch.autograd.grad(y, x, torch.from_numpy(cots[rank].copy()))
        out[f"shift{s}.y"], out[f"shift{s}.g"] = y.detach().numpy(), g.numpy()
    # several tensors of mixed dtypes in one batch, as the kernel ring sends them
    a, b = collective.rotate([torch.full((2,), float(rank)), torch.full((3,), rank)], None, 1)
    out["rotate.mixed"] = np.concatenate([a.numpy(), b.numpy().astype(np.float32)])


def _port_model(rank, params, out):
    from kungfu_tpu_torch.models import convert, transformer as ttr
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.ops.ring_attention import ring_self_attention_plain
    from kungfu_tpu_torch.optimizers.core import synchronous_sgd
    from kungfu_tpu_torch.parallel.dp import make_train_step, shard_batch
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    cfg = ttr.TransformerConfig(**DIMS, dtype=torch.float32)
    world = collective.world_size()
    dp = world // 2
    session = make_mesh("cpu", shape={"dp": dp, "sp": 2})
    batch = shard_batch(tuple(torch.from_numpy(t) for t in _tokens(0)), session,
                        axes=("dp", "sp"))
    for core in ("kernel", "plain"):
        model = convert.transformer_from_jax(params, cfg, "cpu")
        loss_fn = ttr.make_ring_transformer_loss(
            cfg, session, core=None if core == "kernel" else ring_self_attention_plain)
        loss = loss_fn(model, batch)
        loss.backward()
        opt = synchronous_sgd(torch.optim.SGD(model.parameters(), lr=0.0), session)
        opt.average_gradients()
        key = f"dp{dp}sp2-{core}"
        out[f"{key}.loss"] = collective.all_average(loss.detach()).numpy()
        grads = convert.grads_to_jax(model)
        for k in convert.TOP_KEYS:
            out[f"{key}.grad.{k}"] = grads[k]
        for k, g in grads["layers"].items():
            out[f"{key}.grad.layers.{k}"] = g
    if world == 4:
        model = convert.transformer_from_jax(params, cfg, "cpu")
        opt = synchronous_sgd(torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=0.01),
                              session)
        step = make_train_step(ttr.make_ring_transformer_loss(cfg, session), opt, session)
        losses = []
        for i in range(STEPS):
            b = shard_batch(tuple(torch.from_numpy(t) for t in _tokens(i)), session,
                            axes=("dp", "sp"))
            losses.append(float(step(model, b)))
        out["adamw.losses"] = np.array(losses)
        leaves = convert.to_jax(model)
        for k in convert.TOP_KEYS:
            out[f"adamw.{k}"] = leaves[k]
        for k, v in leaves["layers"].items():
            out[f"adamw.layers.{k}"] = v


def _port_mesh(rank, out):
    import torch.distributed as dist

    from kungfu_tpu_torch.parallel.mesh import make_mesh

    for i, shape in enumerate(MESHES):
        session = make_mesh("cpu", shape=shape)
        for name in session.axis_names:
            g = session.axis_group(name)
            members = (dist.get_process_group_ranks(g) if g is not None
                       else list(range(session.size)))
            out[f"mesh{i}.{name}"] = np.array(
                [session.axis_size(name), session.axis_index(name), *members])


def _worker(rank, world, peers, params, out_dir):
    torch.set_num_threads(1)
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane

    env = {"KF_SELF_SPEC": peers[rank], "KF_INIT_PEERS": ",".join(peers)}
    initialize_device_plane("cpu", environ=env)
    try:
        out = {}
        _port_attention(rank, world, out)
        if world == 3:
            _port_shift(rank, world, out)
        else:
            _port_model(rank, params, out)
        if world == 4:
            _port_mesh(rank, out)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        shutdown_device_plane()


def _jax_params():
    jcfg = jtr.TransformerConfig(**DIMS, dtype=jnp.float32)
    return jax.tree.map(np.asarray, jtr.init_transformer(jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """world(n) -> every rank's results from the gloo world of n processes;
    the worlds of 2, 3 and 4 run at the same time."""
    params = _jax_params()
    ports = iter(_free_ports(2 + 3 + 4))
    runs = {}
    for n in (2, 3, 4):
        out_dir = tmp_path_factory.mktemp(f"ring{n}")
        peers = [f"127.0.0.1:{next(ports)}" for _ in range(n)]
        runs[n] = (out_dir, mp.start_processes(_worker, args=(n, peers, params, str(out_dir)),
                                               nprocs=n, join=False, start_method="spawn"))
    deadline = time.monotonic() + 180
    try:
        for n, (_, ctx) in runs.items():
            while not ctx.join(timeout=2):
                if time.monotonic() > deadline:
                    pytest.fail(f"the gloo world of {n} did not finish in 180 s")
    finally:
        for _, ctx in runs.values():
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    results = {n: [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(n)]
               for n, (out_dir, _) in runs.items()}
    return results.__getitem__


# ---------------------------------------------------------------------------
# JAX on CPU devices
# ---------------------------------------------------------------------------

def _sp_mesh(sp):
    return jax_make_mesh({"sp": sp}, devices=jax.devices()[:sp])


@functools.lru_cache(maxsize=None)
def _jax_attention(sp, causal, sl, blk):
    q, k, v, do = _attn_inputs(sp, sl)
    spec = P(None, None, "sp")
    ring = shard_map(lambda q, k, v: jax_ring(q, k, v, "sp", sp, causal=causal, blk_k=blk),
                     mesh=_sp_mesh(sp), in_specs=(spec,) * 3, out_specs=spec, check_vma=False)

    @jax.jit
    def run(q, k, v, do):
        o, vjp = jax.vjp(ring, q, k, v)
        return (o, *vjp(do))

    return [np.asarray(x) for x in run(q, k, v, do)]


@pytest.mark.parametrize("sp,case", ATTN_CASES, ids=[_case_id(sp, c) for sp, c in ATTN_CASES])
def test_ring_attention_matches_jax(world, sp, case):
    impl, causal, sl, blk = case
    # the JAX ring streams blk_k sub-blocks; the kernel path ignores blk_k
    want = _jax_attention(sp, causal, sl, blk)
    for rank, res in enumerate(world(sp)):
        part = slice(rank * sl, (rank + 1) * sl)
        for i, name in enumerate(("o", "dq", "dk", "dv")):
            got = res[f"{_case_id(sp, case)}.{name}"]
            tol = dict(rtol=1e-5, atol=1e-5) if name == "o" else dict(rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got, want[i][:, :, part], **tol,
                                       err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("shift", SHIFTS)
def test_ring_shift_matches_ppermute(world, shift):
    n = 3
    xs, cots = _shift_inputs(n)
    perm = [(i, (i + shift) % n) for i in range(n)]
    fn = shard_map(lambda x: lax.ppermute(x, "sp", perm), mesh=_sp_mesh(n),
                   in_specs=P("sp"), out_specs=P("sp"), check_vma=False)
    flat = xs.reshape(n * 3, 4)
    y, vjp = jax.vjp(fn, flat)
    (g,) = vjp(cots.reshape(n * 3, 4))
    y, g = np.asarray(y).reshape(n, 3, 4), np.asarray(g).reshape(n, 3, 4)
    for rank, res in enumerate(world(n)):
        np.testing.assert_array_equal(res[f"shift{shift}.y"], y[rank])
        np.testing.assert_array_equal(res[f"shift{shift}.g"], g[rank])
        src = (rank - 1) % n
        np.testing.assert_array_equal(res["rotate.mixed"], [src] * 5)


@functools.lru_cache(maxsize=None)
def _jax_model_loss(dp, sp):
    jcfg = jtr.TransformerConfig(**DIMS, dtype=jnp.float32)
    mesh = jax_make_mesh({"dp": dp, "sp": sp}, devices=jax.devices()[:dp * sp])
    return jtr.make_ring_transformer_loss(jcfg, mesh)


@pytest.mark.parametrize("dp,sp,core", MODEL_CASES,
                         ids=[f"dp{dp}xsp{sp}-{c}" for dp, sp, c in MODEL_CASES])
def test_ring_transformer_loss_and_grads_match_jax(world, dp, sp, core):
    params = _jax_params()
    batch = tuple(jnp.asarray(t) for t in _tokens(0))
    loss, grads = jax.jit(jax.value_and_grad(_jax_model_loss(dp, sp)))(params, batch)
    key = f"dp{dp}sp{sp}-{core}"
    for rank, res in enumerate(world(dp * sp)):
        np.testing.assert_allclose(res[f"{key}.loss"], float(loss), rtol=1e-5, atol=1e-5)
        for k in ("embed", "pos_embed", "ln_f_scale"):
            np.testing.assert_allclose(res[f"{key}.grad.{k}"], grads[k], rtol=2e-4, atol=2e-4,
                                       err_msg=f"{k} rank {rank}")
        for k, g in grads["layers"].items():
            np.testing.assert_allclose(res[f"{key}.grad.layers.{k}"], g, rtol=2e-4, atol=2e-4,
                                       err_msg=f"{k} rank {rank}")


def test_ring_ssgd_adamw_steps_match_jax(world):
    loss_fn = _jax_model_loss(2, 2)
    opt = optax.adamw(LR, weight_decay=0.01)
    params = jax.tree.map(jnp.asarray, _jax_params())
    state = opt.init(params)

    @jax.jit
    def step(params, state, batch):
        loss, g = jax.value_and_grad(loss_fn)(params, batch)
        up, state = opt.update(g, state, params)
        return optax.apply_updates(params, up), state, loss

    losses = []
    for i in range(STEPS):
        params, state, loss = step(params, state, tuple(jnp.asarray(t) for t in _tokens(i)))
        losses.append(float(loss))
    for rank, res in enumerate(world(4)):
        np.testing.assert_allclose(res["adamw.losses"], losses, rtol=1e-5, atol=1e-5)
        for k in ("embed", "pos_embed", "ln_f_scale"):
            np.testing.assert_allclose(res[f"adamw.{k}"], params[k], rtol=0, atol=1e-4,
                                       err_msg=f"{k} rank {rank}")
        for k, v in params["layers"].items():
            np.testing.assert_allclose(res[f"adamw.layers.{k}"], v, rtol=0, atol=1e-4,
                                       err_msg=f"{k} rank {rank}")


@pytest.mark.parametrize("i", range(len(MESHES)), ids=[str(m) for m in MESHES])
def test_mesh_layout_matches_jax(world, i):
    shape = MESHES[i]
    mesh = jax_make_mesh(shape, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    base = min(d.id for d in jax.devices()[:4])
    ids = ids - base
    for rank, res in enumerate(world(4)):
        coords = np.argwhere(ids == rank)[0]
        for a, name in enumerate(mesh.axis_names):
            line = np.moveaxis(ids, a, -1)[tuple(np.delete(coords, a))]
            got = res[f"mesh{i}.{name}"]
            assert got[0] == mesh.shape[name] and got[1] == coords[a], (name, rank, got)
            assert got[2:].tolist() == line.tolist(), (name, rank, got, line)

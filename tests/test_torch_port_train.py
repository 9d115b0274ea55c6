"""S-SGD training parity: the port on a 2-process gloo world (one process per
rank, the batch split between them) against the JAX package's
`make_train_step(..., synchronous_sgd(...), mesh)` on two CPU devices, from
the same initial parameters and batches. After 3 steps the parameters of
every rank agree with JAX's within 1e-5."""

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

from kungfu_tpu.models import transformer as jtr
from kungfu_tpu.optimizers.core import synchronous_sgd as jax_ssgd
from kungfu_tpu.parallel.dp import make_train_step as jax_train_step
from kungfu_tpu.parallel.mesh import make_mesh as jax_make_mesh

DIMS = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=16)
WORLD, STEPS, BATCH, SEQ, LR = 2, 3, 4, 16, 1e-2


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _torch_worker(rank, peers, opt_name, params, batches, out_dir):
    """One rank of the port's trainer; writes its final params and losses."""
    torch.set_num_threads(1)
    from kungfu_tpu_torch.models import convert, transformer as ttr
    from kungfu_tpu_torch.initializer import broadcast_variables
    from kungfu_tpu_torch.optimizers.core import synchronous_sgd
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane
    from kungfu_tpu_torch.parallel.dp import make_train_step, shard_batch
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    env = {"KF_SELF_SPEC": peers[rank], "KF_INIT_PEERS": ",".join(peers)}
    device = initialize_device_plane("cpu", environ=env)
    try:
        session = make_mesh(device)
        assert (session.rank, session.size) == (rank, WORLD)
        cfg = ttr.TransformerConfig(**DIMS, dtype=torch.float32)
        model = convert.transformer_from_jax(params, cfg, device)
        if rank:  # rank 0's weights must reach every rank
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        broadcast_variables(model, session)
        base = (torch.optim.SGD(model.parameters(), lr=LR) if opt_name == "sgd" else
                torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=0.01))
        step = make_train_step(lambda m, b: ttr.transformer_loss(m.tree(), b, cfg),
                               synchronous_sgd(base, session), session)
        losses = [float(step(model, shard_batch(torch.from_numpy(b), session)))
                  for b in batches]
        leaves = convert.to_jax(model)
        np.savez(f"{out_dir}/rank{rank}.npz", losses=np.array(losses),
                 **{k: leaves[k] for k in convert.TOP_KEYS},
                 **{f"layers.{k}": v for k, v in leaves["layers"].items()})
    finally:
        shutdown_device_plane()


def _jax_run(opt_name, params, batches):
    cfg = jtr.TransformerConfig(**DIMS, dtype=jnp.float32)
    base = optax.sgd(LR) if opt_name == "sgd" else optax.adamw(LR, weight_decay=0.01)
    opt = jax_ssgd(base)
    mesh = jax_make_mesh(devices=jax.devices()[:WORLD])
    step = jax_train_step(functools.partial(jtr.transformer_loss, cfg=cfg), opt, mesh,
                          donate=False)
    p = jax.tree.map(jnp.asarray, params)
    state = opt.init(p)
    losses = []
    for b in batches:
        p, state, loss = step(p, state, jnp.asarray(b))
        losses.append(float(loss))
    return jax.tree.map(np.asarray, p), losses


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_ssgd_two_process_gloo_matches_jax(opt_name, tmp_path):
    jcfg = jtr.TransformerConfig(**DIMS, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jtr.init_transformer(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, DIMS["vocab_size"], (BATCH, SEQ + 1)).astype(np.int32)
               for _ in range(STEPS)]
    want, want_losses = _jax_run(opt_name, params, batches)

    peers = [f"127.0.0.1:{p}" for p in _free_ports(WORLD)]
    ctx = mp.start_processes(_torch_worker, args=(peers, opt_name, params, batches, str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("gloo workers did not finish in 180 s")
    for rank in range(WORLD):
        got = np.load(tmp_path / f"rank{rank}.npz")
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5, atol=1e-5)
        for k in ("embed", "pos_embed", "ln_f_scale"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
        for k, v in want["layers"].items():
            np.testing.assert_allclose(got[f"layers.{k}"], v, rtol=0, atol=1e-5, err_msg=k)

"""Entry points: a one-process forward check and a multi-process dry run.
Port of `__graft_entry__.py`.

`dryrun_multichip(n)` spawns a gloo world of n processes (on the CPU, or
sharing one CUDA card) and runs one step each of: the dp x tp x sp sharded
train step, the ring (sequence-parallel) transformer over dp x sp, switch
MoE over "ep", and the GPipe pipeline over "pp", at the JAX function's
tiny shapes. Attention is the einsum core (the plain ring over sp), as
the JAX dry run's is: its head dim of 8 is below what the flash kernels
take.

    python -m kungfu_tpu_torch.graft_entry [--device cpu] [-n 4]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from kungfu_tpu_torch import resolve_device

DRYRUN_DEADLINE_S = 300


def entry(device=None):
    """(fn, example_args): the forward of the flagship transformer LM at
    the JAX entry's shapes, on `device` (None = the CUDA card)."""
    from kungfu_tpu_torch.models.transformer import (TransformerConfig, init_transformer,
                                                     transformer_apply)

    cfg = TransformerConfig(vocab_size=8192, d_model=512, n_heads=8, n_layers=4, d_ff=2048,
                            max_seq=256)
    device = resolve_device(device)
    model = init_transformer(cfg, torch.Generator().manual_seed(0), device)
    tokens = torch.zeros(4, 256, dtype=torch.int32, device=device)

    def forward(params, tokens):
        return transformer_apply(params, tokens, cfg)

    return forward, (model.tree(), tokens)


def _mesh_axes(n: int):
    """Factor n devices into (dp, tp, sp), preferring dp=2, then tp, then sp."""
    dp = 2 if n % 2 == 0 else 1
    rest = n // dp
    sp = 2 if rest % 2 == 0 and rest >= 4 else 1
    tp = rest // sp
    if dp * tp * sp != n:
        raise ValueError(f"cannot factor {n} devices into dp x tp x sp")
    return dp, tp, sp


def _finite(what: str, t: torch.Tensor) -> None:
    if not bool(torch.isfinite(t).all()):
        raise RuntimeError(f"non-finite {what}: {t}")


def _dryrun_rank(n: int, device) -> None:
    from kungfu_tpu_torch.models import convert
    from kungfu_tpu_torch.models.transformer import (Transformer, TransformerConfig,
                                                     init_transformer, make_ring_transformer_loss,
                                                     param_pspecs, tp_transformer_loss)
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.ops.moe import switch_moe
    from kungfu_tpu_torch.ops.ring_attention import ring_self_attention_plain
    from kungfu_tpu_torch.parallel.dp import shard_batch
    from kungfu_tpu_torch.parallel.mesh import make_mesh
    from kungfu_tpu_torch.parallel.pipeline import make_pp_transformer_loss
    from kungfu_tpu_torch.parallel.sharded import make_sharded_train_step, shard_params

    # dp x tp x sp: batch over dp, Megatron-style tensor parallelism over
    # tp, the sequence over sp
    dp, tp, sp = _mesh_axes(n)
    session = make_mesh(device, shape={"dp": dp, "tp": tp, "sp": sp})
    cfg = TransformerConfig(vocab_size=256, d_model=8 * max(tp, 1), n_heads=tp if tp > 1 else 2,
                            n_layers=2, d_ff=16 * max(tp, 1), max_seq=8 * sp)
    specs = param_pspecs(cfg, "tp")
    with torch.no_grad():
        full = init_transformer(cfg, torch.Generator().manual_seed(0), "cpu").tree()
        shards = shard_params(convert.tp_layout(full, tp), session, specs)
        model = Transformer(cfg, shards).to(device)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    Sl = cfg.max_seq // sp

    def loss_fn(model, batch):
        # the sequence shards over sp after the next-token slice (the raw
        # S + 1 batch does not split)
        tokens, targets = (t.narrow(1, session.axis_index("sp") * Sl, Sl)
                           for t in (batch[:, :-1], batch[:, 1:]))
        return tp_transformer_loss(model.tree(), (tokens, targets), cfg, session, "tp",
                                   sp_axis="sp", core=ring_self_attention_plain)

    step = make_sharded_train_step(loss_fn, opt, session, specs, batch_spec=("dp",))
    batch = torch.zeros(2 * dp, cfg.max_seq + 1, dtype=torch.int32)
    _finite("sharded-step loss", step(model, batch))

    # long context: one gradient step of the ring transformer over dp x sp
    rdp = 2 if n % 2 == 0 else 1
    ring_session = make_mesh(device, shape={"dp": rdp, "sp": n // rdp})
    ring_cfg = TransformerConfig(vocab_size=256, d_model=16, n_heads=2, n_layers=2, d_ff=32,
                                 max_seq=4 * (n // rdp))
    ring_model = init_transformer(ring_cfg, torch.Generator().manual_seed(1), device)
    ring_loss = make_ring_transformer_loss(ring_cfg, ring_session, core=ring_self_attention_plain)
    tokens = torch.zeros(2 * rdp, ring_cfg.max_seq, dtype=torch.int32)
    loss = ring_loss(ring_model, shard_batch((tokens, tokens), ring_session, ("dp", "sp")))
    loss.backward()
    _finite("ring loss", collective.all_average(loss.detach()))

    # expert parallelism: one switch-MoE dispatch over an ep axis of all ranks
    ep = n
    D, F, T = 8, 16, 4 * ep
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32)).to(device)
    rw = torch.from_numpy(rng.standard_normal((D, ep)).astype(np.float32)).to(device)
    wi = rng.standard_normal((ep, D, F)).astype(np.float32)
    wo = rng.standard_normal((ep, F, D)).astype(np.float32)
    me = collective.world_rank()
    out, aux = switch_moe(xs[me * 4:(me + 1) * 4], rw, torch.from_numpy(wi[me]).to(device),
                          torch.from_numpy(wo[me]).to(device), None, 2.0)
    _finite("MoE output", out)
    _finite("MoE aux loss", aux)

    # pipeline parallelism: one gradient step of GPipe over a pp axis of all
    # ranks (max(2, n) layers, so at least one a stage)
    pp_session = make_mesh(device, shape={"pp": n})
    pp_cfg = TransformerConfig(vocab_size=128, d_model=16, n_heads=2, n_layers=max(2, n),
                               d_ff=32, max_seq=8)
    full = convert.to_jax(init_transformer(pp_cfg, torch.Generator().manual_seed(6), "cpu"))
    stage = Transformer(pp_cfg, convert.pp_stage(full, pp_session.axis_index("pp"), n)).to(device)
    pp_loss = make_pp_transformer_loss(pp_cfg, pp_session, n_micro=2)
    toks = torch.zeros(4, 8, dtype=torch.int32, device=device)
    loss = pp_loss(stage, (toks, toks))
    loss.backward()
    _finite("pipeline loss", loss.detach())


def _dryrun_worker(rank: int, peers, device) -> None:
    from kungfu_tpu_torch.parallel.distributed import (initialize_device_plane,
                                                       shutdown_device_plane)

    torch.set_num_threads(1)
    env = {"KF_SELF_SPEC": peers[rank], "KF_INIT_PEERS": ",".join(peers)}
    if device.type == "cuda":
        env["KF_DEVICE_SLOTS"] = str(device.index or 0)
    device = initialize_device_plane(device, environ=env, backend="gloo")
    try:
        _dryrun_rank(len(peers), device)
    finally:
        shutdown_device_plane()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of each parallel path on a gloo world of `n_devices`
    spawned processes on `device` (None = the CUDA card, shared by all
    ranks; "cpu" for the CPU). Raises if a rank fails or the world does
    not finish in `DRYRUN_DEADLINE_S`."""
    from kungfu_tpu_torch.parallel.distributed import spawn_world

    spawn_world(_dryrun_worker, n_devices, DRYRUN_DEADLINE_S, (resolve_device(device),))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("-n", type=int, default=4, help="ranks of the dry run's world")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    with torch.no_grad():
        out = fn(*fargs)
    print("entry forward:", tuple(out.shape), out.dtype, flush=True)
    dryrun_multichip(args.n, args.device)
    print(f"dryrun_multichip ok on {args.n} ranks", flush=True)


if __name__ == "__main__":
    main()

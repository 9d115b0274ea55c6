"""Multi-world data parallelism: a device all-reduce within each world,
a host-plane allreduce across worlds.

Port of `examples/multislice_train.py`. In JAX each kfrun worker owns one
jax world of several devices; here each worker drives one device, and a
world is a block of `--world-size` consecutive kfrun ranks with a
`torch.distributed` subgroup of its own (`ops/hierarchical.py`). The
cross-world gradient average rides the host plane (parity: the
reference's hierarchical NCCL+CPU allreduce, gpu/collective.cpp:108-162).
Run it:

  python -m kungfu_tpu_torch.runner.cli -np 4 -H 127.0.0.1:4 \\
      python3 -m kungfu_tpu_torch.examples.multislice_train --world-size 2

Ranks sharing one card need `--backend gloo`.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--world-size", type=int, default=2, help="ranks a world")
    p.add_argument("--compress", default="", help='"bf16": the cross-world wire in bf16')
    p.add_argument("--backend", default=None,
                   help="the device plane's backend (default: NCCL on the card, gloo on the CPU)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Train --steps; returns the losses and the final parameters, after
    checking that every world holds the same bits."""
    args = parse_args(argv)

    from kungfu_tpu_torch import api, resolve_device
    from kungfu_tpu_torch.base.ops import ReduceOp
    from kungfu_tpu_torch.models.mlp import init_mlp, mlp_loss
    from kungfu_tpu_torch.ops.hierarchical import make_hier_train_step
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
    from kungfu_tpu_torch.peer import get_default_peer

    device = initialize_device_plane(resolve_device(args.device), backend=args.backend,
                                     peer=get_default_peer())
    rank, size = api.current_rank(), api.cluster_size()
    worlds = size // args.world_size

    model = init_mlp(torch.Generator().manual_seed(42), device=device)  # same seed everywhere
    params = model.tree()
    step = make_hier_train_step(lambda batch: mlp_loss(params, batch),
                                torch.optim.SGD(model.parameters(), lr=0.1),
                                world_size=args.world_size, compress=args.compress,
                                device=device)

    # each rank takes a disjoint shard of the global batch
    gen = torch.Generator().manual_seed(1000 + rank)
    losses = []
    for i in range(args.steps):
        x = torch.randn(64, 784, generator=gen).to(device)
        y = torch.randint(0, 10, (64,), generator=gen).to(device)
        loss = float(step((x, y)))
        losses.append(loss)
        if rank == 0:
            print(f"step {i}: loss {loss:.4f} "
                  f"({worlds} worlds x {args.world_size} ranks)", flush=True)

    # worlds must agree bitwise: the cross-world sync keeps them lockstep.
    # MIN and MAX allreduce both equal to the local value is an exact
    # cross-world equality check (a summed allclose could hide drift)
    flat = torch.cat([p.detach().reshape(-1) for p in params.values()]).cpu()
    lo = api.all_reduce_array(flat, ReduceOp.MIN, name="check-min")
    hi = api.all_reduce_array(flat, ReduceOp.MAX, name="check-max")
    if not (torch.equal(lo, flat) and torch.equal(hi, flat)):
        raise AssertionError("worlds diverged")
    print(f"rank {rank}: worlds in sync after {args.steps} steps", flush=True)
    return {"rank": rank, "losses": losses, "params": flat}


if __name__ == "__main__":
    main()

"""Elastic training example: resizable MLP training with ElasticState.

Port of `examples/elastic_train.py`, with its arguments and data. Run:

  python -m kungfu_tpu_torch.runner.cli -np 2 -H 127.0.0.1:4 -w \\
      -builtin-config-port 9100 python3 -m kungfu_tpu_torch.examples.elastic_train

then grow or shrink the cluster from another terminal:

  curl -X PUT -d '{"Runners": ["127.0.0.1:38080"], "Workers": \\
      ["127.0.0.1:38000","127.0.0.1:38001","127.0.0.1:38002"]}' \\
      http://127.0.0.1:9100/config

Synchronous data parallelism on the HOST plane: gradients are averaged
across the (possibly just-resized) cluster every step; joining workers
inherit a survivor's live parameters via the ElasticState re-sync
broadcast. The elastic dataset resumes from the synced progress, so no
sample is skipped or trained twice across resizes. The gradients are
summed at the step's end (`api.all_reduce_array`) under a name made of
the synced progress, not by the torch frontend's S-SGD: its wire names
count rounds in each process (the scheduler's rounds for the hooks, a
per-process counter for its step-end path), so a joiner's first step
cannot meet the survivors' and a grow hangs (ROADMAP Queue 3;
tests/test_torch_port_checkpoint.py, a strict xfail).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from kungfu_tpu_torch import api, resolve_device
from kungfu_tpu_torch.elastic import ElasticDataset, ElasticState
from kungfu_tpu_torch.models.mlp import init_mlp, mlp_loss
from kungfu_tpu_torch.ops.collective import fuse_pytree


def synthetic_mnist(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 784)).astype(np.float32)
    w = np.random.default_rng(seed + 1).normal(size=(784, 10)).astype(np.float32)
    y = np.argmax(x @ w, axis=1)
    return x, y


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--samples", type=int, default=20_000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.5)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Train until --samples; returns this worker's steps: the loss,
    cluster size and progress at each, and how it stopped."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    x, y = synthetic_mnist()
    ds = ElasticDataset([x, y], args.batch, seed=1)
    model = init_mlp(torch.Generator().manual_seed(0), device=device)
    params = model.tree()
    opt = torch.optim.SGD(model.parameters(), lr=args.lr)

    @torch.no_grad()
    def set_state(tree):
        for k, v in tree["params"].items():
            params[k].copy_(v)

    es = ElasticState(max_progress=args.samples)
    es.register_state(lambda: {"params": params}, set_state)

    out = {"losses": [], "sizes": [], "progress": []}
    while not es.stopped():
        with es.scope():
            rank, size = api.current_rank(), api.cluster_size()
            xb, yb = ds.batch_at(es.progress, rank, size)
            batch = (torch.from_numpy(xb).to(device), torch.from_numpy(yb).to(device))
            opt.zero_grad()
            loss = mlp_loss(params, batch)
            loss.backward()
            # S-SGD: average GRADIENTS across the cluster (host plane)
            fused, unflatten = fuse_pytree({k: p.grad for k, p in params.items()})
            avg = api.all_reduce_array(fused.float(), name=f"g{es.progress}") / size
            for k, g in unflatten(avg).items():
                params[k].grad.copy_(g)
            opt.step()
            out["losses"].append(loss.item())
            out["sizes"].append(size)
            out["progress"].append(es.progress)
            if rank == 0 and (es.progress // ds.cluster_delta(size)) % 20 == 0:
                print(f"progress {es.progress}: loss {out['losses'][-1]:.4f} np={size}", flush=True)
            es.end(ds.cluster_delta(size))
    out.update(rank=api.current_rank() if es.stop_reason != "detached" else None,
               stop_reason=es.stop_reason, final_progress=es.progress)
    print(f"rank {out['rank']}: {es.stop_reason} at progress {es.progress}", flush=True)
    return out


if __name__ == "__main__":
    main()

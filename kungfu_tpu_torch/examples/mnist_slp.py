"""MNIST SLP with synchronous SGD, the minimum end-to-end example. Port of
`examples/mnist_slp.py`: broadcast the initial weights from rank 0, wrap
SGD in S-SGD, train data-parallel.

On the card, or one process per card under kfrun:

  python -m kungfu_tpu_torch.examples.mnist_slp
  python -m kungfu_tpu_torch.examples.mnist_slp --device cpu --epochs 1

Synthetic MNIST-shaped data by default, drawn from a numpy generator: the
JAX example draws its data with `jax.random`, so the two examples train
on different samples of the same distribution. Pass ``--data <dir>``
with the standard idx[.gz] files to train on real MNIST.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from kungfu_tpu_torch.initializer import broadcast_variables
from kungfu_tpu_torch.models.mlp import init_mlp, mlp_apply, mlp_loss
from kungfu_tpu_torch.optimizers.core import synchronous_sgd
from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
from kungfu_tpu_torch.parallel.dp import make_train_step, shard_batch
from kungfu_tpu_torch.parallel.mesh import make_mesh


def synthetic_mnist(n: int = 8192, seed: int = 0):
    """(x (n, 784) f32, y (n,) int): labels from a fixed random linear map."""
    x = np.random.default_rng(seed).standard_normal((n, 784)).astype(np.float32) * 0.5
    w = np.random.default_rng(seed + 1).standard_normal((784, 10)).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int64)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch", type=int, default=512, help="global batch")
    p.add_argument("--lr", type=float, default=0.5)
    p.add_argument("--data", default="",
                   help="directory with the 4 MNIST idx[.gz] files; "
                        "synthetic data when omitted")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train; returns each epoch's mean loss and accuracy on the train set."""
    args = parse_args(argv)
    device = initialize_device_plane(args.device)
    session = make_mesh(device)
    n = session.size
    batch = (args.batch // n) * n or n
    if args.data:
        from kungfu_tpu_torch.datasets import load_mnist

        d = load_mnist(args.data)
        x, y = d["train_images"], d["train_labels"].astype(np.int64)
    else:
        x, y = synthetic_mnist()
    model = broadcast_variables(init_mlp(torch.Generator().manual_seed(42), device=device),
                                session)
    opt = synchronous_sgd(torch.optim.SGD(model.parameters(), lr=args.lr), session)
    step = make_train_step(lambda m, b: mlp_loss(m.tree(), b), opt, session)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    out = {"loss": [], "acc": [], "world": n, "device": str(device)}
    for epoch in range(args.epochs):
        perm = np.random.default_rng(epoch).permutation(len(x))
        losses = []
        for i in range(0, len(x) - batch + 1, batch):
            idx = torch.from_numpy(perm[i:i + batch])
            losses.append(step(model, shard_batch((xs[idx], ys[idx]), session)))
        loss = float(torch.stack(losses).mean())
        with torch.no_grad():
            pred = mlp_apply(model.tree(), xs.to(device)).argmax(dim=1)
            acc = float((pred == ys.to(device)).float().mean())
        out["loss"].append(loss)
        out["acc"].append(acc)
        if session.rank == 0:
            print(f"epoch {epoch}: loss {loss:.4f} acc {acc:.2%} ({n} ranks)", flush=True)
    return out


if __name__ == "__main__":
    main()

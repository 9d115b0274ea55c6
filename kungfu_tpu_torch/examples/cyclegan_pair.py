"""CycleGAN with PairAveraging: asynchronous decentralized GAN training
(BASELINE config 4: "CycleGAN PairAveragingOptimizer async peer-to-peer
request_model").

Port of `examples/cyclegan_pair.py`, with its arguments, data and probe.
A miniature cycle-consistency GAN on synthetic 2-D point clouds (domain X
= a Gaussian blob, domain Y = the blob rotated and shifted): generators
G: X->Y and F: Y->X ([2, 32, 2]) plus least-squares discriminators
([2, 32, 1]), trained with simultaneous gradients and Adam(2e-3) under
the AD-PSGD PairAveraging optimizer: every step each worker averages its
whole parameter set 0.5/0.5 with a random peer's published model
(versioned p2p store, background prefetch) and applies its local
gradients. No global barrier. Run:

  python -m kungfu_tpu_torch.runner.cli -np 2 -H 127.0.0.1:2 \\
      python3 -m kungfu_tpu_torch.examples.cyclegan_pair

Every worker starts from the same weights, drawn from torch seed 0
(jax's PRNG is not torch's: `params_from_numpy` takes the reference's
weights instead); the data comes from numpy's seeds as in the reference.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from kungfu_tpu_torch import resolve_device

SIZES = {"g": [2, 32, 2], "f": [2, 32, 2], "dx": [2, 32, 1], "dy": [2, 32, 1]}


def mlp_init(gen: torch.Generator, sizes, device) -> List[Dict[str, torch.Tensor]]:
    return [{"w": (torch.randn(a, b, generator=gen) / math.sqrt(a)).to(device),
             "b": torch.zeros(b, device=device)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def init_params(device=None, seed: int = 0) -> Dict[str, list]:
    """The four networks' layers ({"w": (in, out), "b": (out,)} each),
    from one torch generator seeded `seed` (the same in every worker)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return {k: [{n: t.requires_grad_() for n, t in layer.items()}
                for layer in mlp_init(gen, SIZES[k], device)] for k in ("g", "f", "dx", "dy")}


def params_from_numpy(tree, device=None) -> Dict[str, list]:
    """The reference's parameters (numpy arrays of its layout) as this
    example's, on `device`."""
    device = resolve_device(device)
    return {k: [{n: torch.from_numpy(np.array(v, np.float32)).to(device).requires_grad_()
                 for n, v in layer.items()} for layer in tree[k]] for k in ("g", "f", "dx", "dy")}


def mlp_apply(layers, x: torch.Tensor) -> torch.Tensor:
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i + 1 < len(layers):
            x = torch.tanh(x)
    return x


def sample_x(rng, n, device) -> torch.Tensor:
    return torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32)).to(device)


def sample_y(rng, n, device) -> torch.Tensor:
    x = rng.normal(size=(n, 2))
    rot = np.array([[0.0, -1.0], [1.0, 0.0]])
    return torch.from_numpy((x @ rot + np.array([2.0, 1.0])).astype(np.float32)).to(device)


def losses(params, xb, yb):
    g, f, dx, dy = params["g"], params["f"], params["dx"], params["dy"]
    fake_y = mlp_apply(g, xb)
    fake_x = mlp_apply(f, yb)
    cyc_x = mlp_apply(f, fake_y)
    cyc_y = mlp_apply(g, fake_x)
    # least-squares GAN objectives
    d_loss = (
        torch.mean((mlp_apply(dy, yb) - 1) ** 2)
        + torch.mean(mlp_apply(dy, fake_y.detach()) ** 2)
        + torch.mean((mlp_apply(dx, xb) - 1) ** 2)
        + torch.mean(mlp_apply(dx, fake_x.detach()) ** 2)
    )
    g_loss = (
        torch.mean((mlp_apply(dy, fake_y) - 1) ** 2)
        + torch.mean((mlp_apply(dx, fake_x) - 1) ** 2)
        + 10.0 * (torch.mean((cyc_x - xb) ** 2) + torch.mean((cyc_y - yb) ** 2))
    )
    return g_loss, d_loss


def _leaves(layers):
    return [l[n] for l in layers for n in ("b", "w")]


def grads_fn(params, xb, yb):
    """Simultaneous gradients: generator groups from the gen loss,
    discriminator groups from the disc loss. Returns (grads, g_loss,
    d_loss), grads a tree like `params`."""
    gl, dl = losses(params, xb, yb)
    gen = _leaves(params["g"]) + _leaves(params["f"])
    disc = _leaves(params["dx"]) + _leaves(params["dy"])
    g_gen = iter(torch.autograd.grad(gl, gen))
    g_disc = iter(torch.autograd.grad(dl, disc))
    grads = {k: [{n: next(it) for n in ("b", "w")} for _ in params[k]]
             for k, it in (("g", g_gen), ("f", g_gen), ("dx", g_disc), ("dy", g_disc))}
    return grads, gl.detach(), dl.detach()


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=900)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Train --steps; returns this worker's losses, its PairAveraging step
    counts and the probe's G(X) centre and error (it raises if the error
    is 1.0 or more)."""
    args = parse_args(argv)
    device = resolve_device(args.device)

    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.optimizers.pair_averaging import PairAveraging

    rank = api.current_rank()
    params = init_params(device)  # same init everywhere
    pa = PairAveraging(lambda leaves: torch.optim.Adam(leaves, lr=2e-3), name="cyclegan",
                       device=device)
    pa.init(params)
    rng = np.random.default_rng(100 + rank)  # different data per worker

    out = {"g_loss": [], "d_loss": []}
    for step in range(args.steps):
        xb, yb = sample_x(rng, args.batch, device), sample_y(rng, args.batch, device)
        grads, gl, dl = grads_fn(params, xb, yb)
        pa.step(params, grads)
        out["g_loss"].append(float(gl))
        out["d_loss"].append(float(dl))
        if rank == 0 and step % 50 == 49:
            print(f"step {step}: g_loss {float(gl):.3f} d_loss {float(dl):.3f}",
                  flush=True)

    # quality probe: G should map the X blob near the Y blob's center.
    # Barrier BEFORE the check: a rank failing the probe must not leave
    # peers wedged inside the barrier
    api.run_barrier()
    probe = sample_x(np.random.default_rng(9), 512, device)
    with torch.no_grad():
        center = mlp_apply(params["g"], probe).mean(0).cpu().numpy()
    err = float(np.linalg.norm(center - np.array([2.0, 1.0])))
    print(f"rank {rank}: G(X) center {center.round(2)} err {err:.2f}", flush=True)
    if not err < 1.0:
        raise AssertionError(f"generator failed to reach domain Y: {err}")
    print(f"rank {rank}: cyclegan pair-averaging OK", flush=True)
    out.update(rank=rank, steps=dict(pa.steps), center=center.tolist(), err=err)
    return out


if __name__ == "__main__":
    main()

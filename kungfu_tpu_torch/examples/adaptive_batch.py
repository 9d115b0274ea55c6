"""GNS-driven adaptive batch size: gradient-noise-scale monitoring picks
the cluster size (BASELINE config 5: "elastic with resize_cluster +
gradient-noise-scale adaptive batch").

Port of `examples/adaptive_batch.py`, with its arguments, seeds and
arithmetic, on float64 tensors. The McCandlish critical batch size
B_crit ~= GNS: while the measured GNS is well above the current GLOBAL
batch (workers x per-worker batch), adding workers still buys
near-linear speedup, so rank 0 proposes a bigger cluster; when GNS falls
toward the global batch, growth stops. Run it:

  python -m kungfu_tpu_torch.runner.cli -np 1 -H 127.0.0.1:4 -w \\
      -builtin-config-port 0 python3 -m kungfu_tpu_torch.examples.adaptive_batch

and watch the cluster grow as the noise estimate warms up.

Per step the gradient noise scale is estimated from within-worker half
batches against the cluster-averaged gradient, the small/big-batch pair
the reference's NoiseScale op consumes (srcs/cpp/src/op/noise_scale;
parity: MonitorGradientNoiseScaleOptimizer + policy-driven resize). The
data is drawn by numpy from the reference's seeds, so one worker's run
prints the reference's lines.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from kungfu_tpu_torch import api, resolve_device
from kungfu_tpu_torch.elastic import ElasticState


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--batch", type=int, default=32, help="per-worker batch")
    p.add_argument("--max-workers", type=int, default=4)
    p.add_argument("--alpha", type=float, default=0.7, help="GNS EMA")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Train until --steps; returns this worker's steps (cluster size,
    GNS and progress at each), its final weights and how it stopped."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(1234 + api.current_rank())
    dim = 256
    w_true = torch.from_numpy(np.random.default_rng(7).normal(size=(dim,))).to(device)

    def tensor(a):
        return torch.from_numpy(a).to(device)

    # live state (weights + GNS EMAs): joiners inherit it from a survivor
    # via the ElasticState re-sync broadcast: a fresh-zeros joiner would
    # break the S-SGD identical-params invariant AND poison the GNS
    # estimate that drives resizing
    state = {"w": torch.zeros(dim, dtype=torch.float64, device=device),
             "emas": torch.zeros(2, dtype=torch.float64, device=device)}
    es = ElasticState(max_progress=args.steps)
    es.register_state(lambda: state, lambda t: state.update(t))
    lr = 0.05
    out = {"steps": []}

    while not es.stopped():
        with es.scope():
            size = api.cluster_size()
            rank = api.current_rank()
            w = state["w"]
            # noisy linear-regression gradient on this worker's batch
            x = tensor(rng.normal(size=(args.batch, dim)))
            noise = tensor(rng.normal(size=args.batch)) * 3.0
            err = x @ w - (x @ w_true + noise)
            g_local = x.T @ err / args.batch

            g_avg = api.all_reduce_array(g_local, name="grad") / size
            # McCandlish pair from within-worker HALF batches (works even
            # at cluster size 1, where per-worker vs average degenerates):
            # |g_small|^2 over half-batch grads, |g_big|^2 of the cluster
            # average
            h = args.batch // 2
            g_h1 = x[:h].T @ err[:h] / h
            g_h2 = x[h:].T @ err[h:] / (args.batch - h)
            local_gs = 0.5 * (g_h1 @ g_h1 + g_h2 @ g_h2)
            gs = float(api.all_reduce_array(local_gs.reshape(1), name="gs")[0]) / size
            gb = float(g_avg @ g_avg)
            b_small, b_big = h, args.batch * size
            g2_ema, s_ema = (float(v) for v in state["emas"])
            if b_big > b_small:
                s = (gs - gb) * b_small * b_big / (b_big - b_small)
                g2 = (b_big * gb - b_small * gs) / (b_big - b_small)
                g2_ema = args.alpha * g2_ema + (1 - args.alpha) * max(g2, 1e-12)
                s_ema = args.alpha * s_ema + (1 - args.alpha) * max(s, 0.0)
                state["emas"] = torch.tensor([g2_ema, s_ema], dtype=torch.float64,
                                             device=device)
            gns = s_ema / g2_ema if g2_ema > 0 else 0.0

            state["w"] = w - lr * g_avg
            step = es.progress
            out["steps"].append({"size": size, "gns": gns, "progress": step})
            if rank == 0 and step % 10 == 9:
                global_batch = args.batch * size
                print(f"step {step}: size={size} gns={gns:.0f} "
                      f"global_batch={global_batch}", flush=True)
                # grow while the critical batch exceeds what we have
                if gns > 2 * global_batch and size < args.max_workers:
                    print(f"step {step}: proposing size {size + 1}", flush=True)
                    api.propose_new_size(size + 1)
            es.end(1)

    out.update(rank=api.current_rank() if es.stop_reason != "detached" else None,
               size=api.cluster_size(), stop_reason=es.stop_reason, w=state["w"])
    print(f"done rank={api.current_rank()} size={api.cluster_size()} "
          f"reason={es.stop_reason}", flush=True)
    return out


if __name__ == "__main__":
    main()

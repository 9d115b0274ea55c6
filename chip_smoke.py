#!/usr/bin/env python3
"""Smoke run of kungfu_tpu_torch on one CUDA card (an H100 for the numbers
in PERF.md).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device   card name and power limit (`nvidia-smi`), torch and CUDA versions;
  build    the kernels of csrc/ compiled by nvcc for sm_90a, one nvcc per
           source, all at once;
  occupancy  each kernel's dynamic shared memory, active blocks per SM,
           registers and spilled bytes per thread (CUDA runtime), hd 64/128;
  kernel   each flash-attention kernel (forward with O and LSE, dQ with
           delta, dK/dV) against its plain PyTorch version on the same inputs
           at B=8, H=12, hd=64 in bf16: S=512 causal and not, and a ragged
           S=500; then times: kernel and library (SDPA forward, and SDPA's
           backward alone for the dQ + dK/dV pair) device times by
           torch.profiler, warm and cold (L2 flushed by a 128 MB write before
           each call); plain versions, and each kernel's whole call with its
           Python wrapper, by CUDA events around back-to-back calls;
  train    `examples/bert_ssgd.main` at BERT-base width (12 layers, S=512,
           batch 8) for 8 S-SGD(AdamW) steps on one fixed batch (on fresh
           batches 8 steps move the loss less than the batch-to-batch
           noise) as a world of one, with the
           launch counters zeroed just before and read just after; the
           first step's loss is then recomputed with the plain attention
           core on the card and compared;
  profile  where a steady training step's device time goes (torch.profiler);
  ring     the sequence-parallel path (ring attention through the same
           kernels) as two gloo worker processes sharing card 0, K/V
           staged through pinned host buffers: the ring core's O, dQ, dK, dV
           at B=8, H=12, S=512 (causal and not) against the plain ring (the
           einsum oracle, on the card) on the same inputs, and against the
           single-process kernel path; then BERT-base over a dp 1 x sp 2 mesh for 6
           S-SGD(AdamW) steps on one fixed causal-LM batch of 8 x 512, its
           first loss against the dense flash path in one process (within
           1e-4 relative), each
           rank's launches (rank r runs 12 (r + 1) of each kernel a step),
           step times and their split (ring shifts, gradient average, the
           rest), the card's idle share, the ring core's device times and
           one K/V shift's host time;
  resnet   `python -m kungfu_tpu_torch.bench` at full width on card 0
           (ResNet-50, 224x224, 1000 classes, 128 images, S-SGD over SGD
           momentum; 2 warm-up windows and the best of 6 windows of 16
           steps): its JSON fields beside the card's name and power limit,
           then 3 steady steps under torch.profiler (device busy ms, idle
           share, kernels a step, the top 20 and the convolutions, norms and
           elementwise work summed apart); gates: eval logits in bf16 within
           2e-2 + 2e-2|ref| of the same weights in f32 at 4 images, finite
           losses falling on batch 0, running statistics finite and moved;
  optimizers  two gloo worker processes sharing card 0 train ResNet-50 at
           full width, 16 images a rank, 3 steps each of S-SGD (twice),
           ZeRO-1, SMA (alpha 0.1) and AdaptiveSGD (change_step 1) from one
           broadcast initialization, with deterministic kernels, results in
           `build/chip_smoke_opt/`; gates: the two S-SGD runs bitwise equal,
           ZeRO's parameters bitwise equal to S-SGD's and its state at most half of S-SGD's plus padding,
           SMA's second step against its formula from both ranks'
           parameters, and AdaptiveSGD's ranks bitwise equal after the
           switch; per rank the steady step ms, the gloo ms of a step and
           the peak memory.
Then the line of kernels, and last `{"ok": true, "device": {...}}`. Any
failed check raises and the script exits non-zero before that last line.
It also exits non-zero, printing no result, without a CUDA device or
outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

B, H, S, HD = 8, 12, 512, 64
S_RAGGED = 500
STEPS = 8
RING_STEPS = 6
RING_RANKS = 2
RING_DEADLINE_S = 300
RING_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_ring"
RTOL = ATOL = 2e-2  # bf16 parity, as tests/test_flash_attention.py holds it
# the ring's first loss against the dense flash path's: at random init the
# loss is near ln(vocab) whatever attention does, so the limit is set from
# the readings on the H100 (relative gap 6.2e-6; PERF.md), not from RTOL
RING_LOSS_RTOL = 1e-4
RESNET_EVAL_IMAGES = 4
RESNET_RTOL = RESNET_ATOL = 2e-2  # bf16 eval logits against f32 on the card
OPT_RANKS, OPT_BATCH, OPT_STEPS, OPT_SIDE = 2, 16, 3, 224
OPT_DEADLINE_S = 300
OPT_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_opt"
SMA_ALPHA = 0.1
# one SMA step against its formula recomputed in the parent: the same
# operations in another order, a few f32 roundings apart
SMA_RTOL, SMA_ATOL = 1e-6, 1e-7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM data sheet
KERNEL_SOURCE = "kungfu_tpu_torch/csrc/flash_attention.cu"
TPU_SOURCE = "kungfu_tpu/ops/flash_attention.py"
# kernel -> (launch counter, pallas_call line, Pallas body) in TPU_SOURCE
KERNELS = {
    "flash_fwd": ("fwd", 194, "_kernel"),
    "flash_dq": ("dq", 368, "_dq_kernel"),
    "flash_dkv": ("dkv", 386, "_dkv_kernel"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"chip_smoke check failed: {what}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_us_by_kernel(fn, flush=None, iters: int = 20, warmup: int = 3) -> dict:
    """Device time of one call of `fn` by kernel name (us): the CUDA
    kernels and copies it launches, summed by torch.profiler (CUPTI) over
    `iters` calls and averaged. Host time between launches is left out, so
    a kernel faster than its Python wrapper still reads its own time. With
    `flush`, an add into that buffer (larger than the 50 MB L2) precedes
    each call and pushes its inputs out of the cache; the add's own kernels
    are left out by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernel_us(prof):
        return {e.key: e.self_device_time_total for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)}

    skip = set()
    if flush is not None:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush.add_(1.0)
            torch.cuda.synchronize()
        skip = set(kernel_us(prof))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.add_(1.0)
            fn()
        torch.cuda.synchronize()
    us = {k: v / iters for k, v in kernel_us(prof).items() if k not in skip}
    check(bool(us), "the profiler saw no device kernel")
    return us


def device_ms(fn, flush=None, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of `fn` (ms): `device_us_by_kernel` summed."""
    return sum(device_us_by_kernel(fn, flush, iters, warmup).values()) / 1e3


def compare(name: str, got, want) -> dict:
    """Max abs error and the worst ratio of error to |want|*RTOL + ATOL."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ratio = (err / (ATOL + RTOL * want.abs())).max().item()
    out = {"max_abs_err": err.max().item(), "worst_tol_ratio": ratio,
           "finite": bool(got.isfinite().all())}
    check(out["finite"] and ratio <= 1.0, f"{name} disagrees with its plain version: {out}")
    return out


def bounds(BH: int, S: int, hd: int, causal: bool) -> dict:
    """Least time (ms) for each kernel's work on the H100: the larger of
    bytes moved (each input read once, each output written once) over the
    memory rate and matmul FLOPs over the bf16 tensor-core rate. Causal
    work counts only the live (query, key) pairs."""
    t = BH * S * hd * 2  # one bf16 (B*H, S, hd) tensor
    row = BH * S * 4  # one f32 (B*H, S) tensor
    pairs = BH * (S * (S + 1) // 2 if causal else S * S)
    mm = 2 * hd * pairs  # FLOPs of one (S x S x hd) product over live pairs
    work = {
        "flash_fwd": (4 * t + row, 2 * mm),  # q k v -> o, lse
        "flash_dq": (6 * t + 2 * row, 3 * mm),  # q k v o dO lse -> dq delta
        "flash_dkv": (6 * t + 2 * row, 4 * mm),  # q k v dO lse delta -> dk dv
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "flops": flops}
    return out


def kernel_phase(fa) -> dict:
    import torch
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    for causal, s in ((True, S), (False, S), (True, S_RAGGED)):
        q, k, v, do = (torch.randn(B * H, s, HD, device=dev, dtype=torch.bfloat16,
                                   generator=gen) for _ in range(4))
        scale = 1.0 / math.sqrt(HD)
        o, lse = fa._forward_cuda(q, k, v, causal, scale)
        o_p, lse_p = fa._forward_plain(q, k, v, causal, scale)
        dq, delta = fa._dq_cuda(q, k, v, o_p, do, lse_p, causal, scale)
        dq_p, delta_p = fa._dq_plain(q, k, v, o_p, do, lse_p, causal, scale)
        dk, dv = fa._dkv_cuda(q, k, v, do, lse_p, delta_p, causal, scale)
        dk_p, dv_p = fa._dkv_plain(q, k, v, do, lse_p, delta_p, causal, scale)
        torch.cuda.synchronize()
        res = {
            "O": compare("flash_fwd O", o, o_p), "LSE": compare("flash_fwd LSE", lse, lse_p),
            "dQ": compare("flash_dq dQ", dq, dq_p), "delta": compare("flash_dq delta", delta, delta_p),
            "dK": compare("flash_dkv dK", dk, dk_p), "dV": compare("flash_dkv dV", dv, dv_p),
        }
        for name, keys in (("flash_fwd", ("O", "LSE")), ("flash_dq", ("dQ", "delta")),
                           ("flash_dkv", ("dK", "dV"))):
            errs[name] = max([errs[name]] + [res[key]["max_abs_err"] for key in keys])
        emit("kernel_check", B=B, H=H, S=s, hd=HD, causal=causal, dtype="bfloat16",
             rtol=RTOL, atol=ATOL, results=res)

    # times at the main path's shape: causal, S=512
    q, k, v, do = (torch.randn(B * H, S, HD, device=dev, dtype=torch.bfloat16,
                               generator=gen) for _ in range(4))
    scale = 1.0 / math.sqrt(HD)
    o, lse = fa._forward_plain(q, k, v, True, scale)
    _, delta = fa._dq_plain(q, k, v, o, do, lse, True, scale)
    calls = {
        "flash_fwd": lambda: fa._forward_cuda(q, k, v, True, scale),
        "flash_dq": lambda: fa._dq_cuda(q, k, v, o, do, lse, True, scale),
        "flash_dkv": lambda: fa._dkv_cuda(q, k, v, do, lse, delta, True, scale),
    }
    flush = torch.empty(32 * 2**20, device=dev)  # 128 MB of f32
    ms = {name: device_ms(fn) for name, fn in calls.items()}
    ms_cold = {name: device_ms(fn, flush) for name, fn in calls.items()}
    call_ms = {name: time_ms(fn) for name, fn in calls.items()}  # host + device
    plain_ms = {
        "flash_fwd": time_ms(lambda: fa._forward_plain(q, k, v, True, scale), iters=5),
        "flash_dq": time_ms(lambda: fa._dq_plain(q, k, v, o, do, lse, True, scale), iters=5),
        "flash_dkv": time_ms(lambda: fa._dkv_plain(q, k, v, do, lse, delta, True, scale), iters=5),
    }
    q4, k4, v4, do4 = (t.view(B, H, S, HD) for t in (q, k, v, do))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
    out_g = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_bwd():  # the backward alone, on one retained forward graph
        torch.autograd.grad(out_g, (qg, kg, vg), do4, retain_graph=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(out, (qg, kg, vg), do4)

    sdpa = {"fwd": device_ms(sdpa_fwd), "fwd_cold": device_ms(sdpa_fwd, flush),
            "bwd": device_ms(sdpa_bwd), "bwd_cold": device_ms(sdpa_bwd, flush),
            "fwd_bwd": device_ms(sdpa_fwd_bwd)}
    emit("kernel_times", shape=[B, H, S, HD], causal=True, dtype="bfloat16",
         kernel_ms=ms, kernel_ms_cold_l2=ms_cold, call_ms_back_to_back=call_ms,
         plain_ms=plain_ms, sdpa_fwd_ms=sdpa["fwd"], sdpa_fwd_ms_cold_l2=sdpa["fwd_cold"],
         sdpa_bwd_ms=sdpa["bwd"], sdpa_bwd_ms_cold_l2=sdpa["bwd_cold"],
         sdpa_fwd_bwd_ms=sdpa["fwd_bwd"], kernels_fwd_bwd_ms=sum(ms.values()),
         kernels_bwd_ms=ms["flash_dq"] + ms["flash_dkv"])
    return {"errs": errs, "ms": ms, "ms_cold": ms_cold, "plain_ms": plain_ms,
            "library_ms": {"flash_fwd": sdpa["fwd"], "flash_dq": None, "flash_dkv": None},
            "library_pair_ms": {"flash_fwd": None, "flash_dq": sdpa["bwd"],
                                "flash_dkv": sdpa["bwd"]},
            "bounds": bounds(B * H, S, HD, True)}


def occupancy_phase(fa) -> dict:
    import torch

    out = {}
    for hd in (64, 128):
        occ = {name: fa.occupancy(name, hd, torch.bfloat16) for name in KERNELS}
        emit("occupancy", hd=hd, dtype="bfloat16", kernels=occ)
        out[hd] = occ
    return out[HD]


def train_phase(fa) -> dict:
    import torch

    from kungfu_tpu_torch.examples import bert_ssgd
    from kungfu_tpu_torch.models.transformer import TransformerConfig

    argv = ["--config", "bert-base", "--batch", str(B), "--seq", str(S),
            "--steps", str(STEPS), "--device", "cuda", "--fixed-batch"]
    fa.reset_launches()
    result = bert_ssgd.main(argv)
    launches = dict(fa.LAUNCHES)
    cfg = TransformerConfig.bert_base()
    losses = result["losses"]
    emit("train", config="bert-base", layers=cfg.n_layers, d_model=cfg.d_model,
         batch=B, seq=S, steps=STEPS, losses=losses, step_ms=result["step_ms"],
         tokens_per_s=result["tokens_per_s"], launches=launches)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(sum(losses[-3:]) / 3 < losses[0], f"loss did not decrease: {losses}")
    for name, n in launches.items():
        check(n == cfg.n_layers * STEPS,
              f"{name} launched {n} times, want {cfg.n_layers} x {STEPS} steps")

    # the first step's loss again, kernel core vs plain core, same model/batch
    model = bert_ssgd.make_model(cfg, 0, "cuda")
    inputs, targets, mask = (t.cuda() for t in next(bert_ssgd.batches(cfg, B, S, 0)))

    def plain_core(q, k, v):
        return fa.flash_attention_plain(q, k, v, causal=True)

    with torch.no_grad():
        tree = model.tree()
        kernel_loss = bert_ssgd.mlm_loss(tree, inputs, targets, mask, cfg,
                                         core=bert_ssgd.flash_core).item()
        plain_loss = bert_ssgd.mlm_loss(tree, inputs, targets, mask, cfg,
                                        core=plain_core).item()
    emit("train_check", first_step_loss=losses[0], kernel_core_loss=kernel_loss,
         plain_core_loss=plain_loss, rtol=RTOL)
    check(abs(kernel_loss - plain_loss) <= RTOL * abs(plain_loss),
          f"kernel-core loss {kernel_loss} vs plain-core loss {plain_loss}")
    check(abs(losses[0] - kernel_loss) <= RTOL * abs(kernel_loss),
          f"first step loss {losses[0]} vs recomputed {kernel_loss}")
    steady = sorted(result["step_ms"][1:])
    return {"launches": launches, "step_ms": steady[len(steady) // 2]}


def profile_steps(run, steps: int):
    """torch.profiler over `run()` (which takes `steps` steps and returns
    when the device is done): device kernels summed by name, as rows of
    (name, ms a step, launches a step) in falling time, and the wall ms a
    step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # a user annotation (e.g. "Optimizer.step#AdamW.step") spans kernels
        # that are counted on their own; summing it too would count twice
        if (getattr(e, "device_type", None) != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        rows.append((e.key, dev_us / 1e3 / steps, e.count // steps))
    rows.sort(key=lambda r: -r[1])
    return rows, wall_ms / steps, out


def top(rows, n: int = 20):
    return [{"kernel": k[:100], "ms_per_step": ms, "per_step": c} for k, ms, c in rows[:n]]


def profile_phase(unprofiled_step_ms: float, steps: int = 3) -> None:
    """Where a training step's device time goes: torch.profiler over steady
    steps of the same trainer (after the counted run, so it adds no launches
    to it), device kernels summed by name; the rest of the wall time is the
    device's idle share. The profiler slows the host, so the idle share is
    also given against the unprofiled steady step of the train phase."""
    from kungfu_tpu_torch.examples import bert_ssgd

    trainer = bert_ssgd.Trainer(bert_ssgd.parse_args(
        ["--config", "bert-base", "--batch", str(B), "--seq", str(S), "--device", "cuda",
         "--fixed-batch"]))
    trainer.train(2)  # warm-up: allocator, cuBLAS handles, optimizer state
    rows, per_step, out = profile_steps(lambda: trainer.train(steps), steps)
    busy = sum(r[1] for r in rows)
    flash = sum(r[1] for r in rows if "kf_flash::" in r[0])
    gemm = sum(r[1] for r in rows if "gemm" in r[0].lower() or "cutlass" in r[0].lower())
    emit("profile", steps=steps, step_ms=out["step_ms"], wall_ms_per_step=per_step,
         device_busy_ms_per_step=busy, device_idle_share=1 - busy / per_step,
         unprofiled_step_ms=unprofiled_step_ms,
         device_idle_share_unprofiled=1 - busy / unprofiled_step_ms,
         flash_kernels_ms_per_step=flash, flash_share_of_busy=flash / busy,
         gemm_ms_per_step=gemm,
         kernels_per_step=sum(r[2] for r in rows), top=top(rows))


def _ring_rank(rank: int, peers) -> dict:
    """One rank of the ring phase, through the port's entry points as a
    kfrun worker would use them."""
    os.environ.update(KF_SELF_SPEC=peers[rank], KF_INIT_PEERS=",".join(peers),
                      KF_DEVICE_SLOTS="0")
    import numpy as np
    import torch

    from kungfu_tpu_torch.examples import bert_ssgd
    from kungfu_tpu_torch.initializer import broadcast_variables
    from kungfu_tpu_torch.models import transformer as tr
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.ops import flash_attention as fa
    from kungfu_tpu_torch.ops.ring_attention import (ring_self_attention,
                                                     ring_self_attention_plain)
    from kungfu_tpu_torch.optimizers.core import synchronous_sgd
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
    from kungfu_tpu_torch.parallel.dp import make_train_step, shard_batch
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    device = initialize_device_plane(backend="gloo")
    session = make_mesh(device, shape={"dp": 1, "sp": RING_RANKS})
    group, idx = session.axis_group("sp"), session.axis_index("sp")
    out = {"rank": rank, "sp_index": idx, "device": str(device),
           "backend": session.describe()}
    Sl = S // RING_RANKS
    part = slice(idx * Sl, (idx + 1) * Sl)

    # (a) the core, forward and backward (the backward first runs here, on
    # autograd's thread), gathered on rank 0. The kernel ring is held against
    # the plain ring (its einsum oracle) on the same inputs at the ring's own
    # shapes, and then against the one-process kernels on the whole sequence
    def ring_outputs(core, q, k, v, do, causal):
        mine = [t[:, :, part].clone().requires_grad_() for t in (q, k, v)]
        o = core(*mine, group, causal=causal)
        got = [o, *torch.autograd.grad(o, mine, do[:, :, part])]
        return [collective.all_gather(t.detach().cpu(), axis=2, tiled=True, group=group)
                for t in got]

    errs = {}
    for causal in (True, False):
        gen = torch.Generator(device=device).manual_seed(0)
        q, k, v, do = (torch.randn(B, H, S, HD, device=device, dtype=torch.bfloat16,
                                   generator=gen) for _ in range(4))
        got = ring_outputs(ring_self_attention, q, k, v, do, causal)
        plain = ring_outputs(ring_self_attention_plain, q, k, v, do, causal)
        if rank == 0:
            full = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = fa.flash_attention(*full, causal=causal)
            one = [ref, *torch.autograd.grad(ref, full, do)]
            mode = "causal" if causal else "full"
            names = ("O", "dQ", "dK", "dV")
            errs[mode] = {
                "vs_plain_ring": {n: compare(f"ring {n} vs plain ring (causal={causal})", g, w)
                                  for n, g, w in zip(names, got, plain)},
                "vs_one_process": {n: compare(f"ring {n} vs one process (causal={causal})",
                                              g, w.cpu())
                                   for n, g, w in zip(names, got, one)}}
    out["core_check"] = errs

    # the core's device time at the training shape, and one K/V shift's host time
    gen = torch.Generator(device=device).manual_seed(1)
    q, k, v, do = (torch.randn(B, H, Sl, HD, device=device, dtype=torch.bfloat16,
                               generator=gen) for _ in range(4))
    with torch.no_grad():
        fwd = device_us_by_kernel(lambda: ring_self_attention(q, k, v, group))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ring_self_attention(*qkv, group)
    bwd = device_us_by_kernel(lambda: torch.autograd.grad(o, qkv, do, retain_graph=True))

    def split(us):
        flash = sum(t for name, t in us.items() if "kf_flash::" in name)
        copies = sum(t for name, t in us.items() if "memcpy" in name.lower())
        return {"ms": sum(us.values()) / 1e3, "flash_kernels_ms": flash / 1e3,
                "host_copies_ms": copies / 1e3}

    out["core_fwd"], out["core_bwd"] = split(fwd), split(bwd)
    kv = torch.stack([q.reshape(B * H, Sl, HD), k.reshape(B * H, Sl, HD)])
    shift_ms = []
    for _ in range(12):
        session.barrier()
        t0 = time.perf_counter()
        collective.rotate([kv], group)
        shift_ms.append((time.perf_counter() - t0) * 1e3)
    out["kv_shift_host_ms"] = sorted(shift_ms[2:])[len(shift_ms[2:]) // 2]
    out["kv_shift_bytes"] = kv.numel() * kv.element_size()
    if rank == 0:  # the same work in one process on the whole sequence
        qf, kf, vf, dof = (torch.randn(B, H, S, HD, device=device, dtype=torch.bfloat16,
                                       generator=gen) for _ in range(4))
        with torch.no_grad():
            out["dense_fwd_ms"] = device_ms(lambda: fa.flash_attention(qf, kf, vf))
        full = [t.clone().requires_grad_() for t in (qf, kf, vf)]
        of = fa.flash_attention(*full)
        out["dense_bwd_ms"] = device_ms(
            lambda: torch.autograd.grad(of, full, dof, retain_graph=True))
    session.barrier()

    # BERT-base over dp 1 x sp 2, one fixed causal-LM batch of 8 x 512
    cfg = tr.TransformerConfig.bert_base()
    model = broadcast_variables(
        tr.init_transformer(cfg, torch.Generator().manual_seed(0), device), session)
    _, tokens, _ = bert_ssgd.synthetic_batch(np.random.default_rng(1234), cfg, B, S + 1)
    tokens = torch.from_numpy(tokens)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if rank == 0:  # (b)'s yardstick: the dense flash path, full batch, one process
        with torch.no_grad():
            out["dense_first_loss"] = tr.transformer_loss(
                model.tree(), (inputs.to(device), targets.to(device)), cfg,
                core=bert_ssgd.flash_core).item()
    opt = synchronous_sgd(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01), session)
    step = make_train_step(tr.make_ring_transformer_loss(cfg, session, core=ring_self_attention),
                           opt, session)
    batch = shard_batch((inputs, targets), session, axes=("dp", "sp"))
    session.barrier()
    losses, step_ms = [], []
    fa.reset_launches()
    for _ in range(RING_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(model, batch)))  # waits for the device
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["launches"] = dict(fa.LAUNCHES)
    steady = sorted(step_ms[1:])

    # where a step's host time goes: two more steps, after the count was
    # read, with the ring's shifts and the gradient average timed from a
    # drained stream (so waiting on queued kernels counts as the rest)
    spent = {"ring_shifts_ms": 0.0, "grad_average_ms": 0.0}

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += (time.perf_counter() - t) * 1e3
        return run

    rotate = collective.rotate
    collective.rotate = timed(rotate, "ring_shifts_ms")
    opt.average_gradients = timed(opt.average_gradients, "grad_average_ms")
    try:
        t = time.perf_counter()
        for _ in range(2):
            float(step(model, batch))
        total = (time.perf_counter() - t) * 1e3 / 2
    finally:
        collective.rotate = rotate
        del opt.average_gradients  # the class's own method again
    split = {k: v / 2 for k, v in spent.items()}
    out["step_split"] = {"step_ms": total, **split, "rest_ms": total - sum(split.values())}
    # this rank's device time in a step (kernels and copies, profiled)
    out["step_device_busy_ms"] = device_ms(lambda: float(step(model, batch)), iters=2, warmup=0)
    out.update(losses=losses, step_ms=step_ms, steady_step_ms=steady[len(steady) // 2],
               tokens_per_s=B * S / (steady[len(steady) // 2] / 1e3),
               peak_mem_gb=torch.cuda.max_memory_allocated(device) / 2**30)
    return out


def ring_worker(rank: int, peers) -> None:
    from kungfu_tpu_torch.parallel.distributed import shutdown_device_plane

    try:
        out = _ring_rank(rank, peers)
        (RING_OUT / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        shutdown_device_plane()


def ring_phase() -> dict:
    """The sequence-parallel path on two worker processes that share card 0
    through gloo (NCCL refuses two ranks on one card); the parent checks
    what they wrote. Returns each kernel's launches per rank."""
    import torch

    from kungfu_tpu_torch.models.transformer import TransformerConfig

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    RING_OUT.mkdir(parents=True, exist_ok=True)
    for f in RING_OUT.glob("rank*.json"):
        f.unlink()
    spawn_world(ring_worker, RING_RANKS, RING_DEADLINE_S, "ring")
    ranks = [json.loads((RING_OUT / f"rank{r}.json").read_text()) for r in range(RING_RANKS)]
    cfg = TransformerConfig.bert_base()
    r0 = ranks[0]
    losses = r0["losses"]
    emit("ring", config="bert-base", layers=cfg.n_layers, d_model=cfg.d_model, batch=B,
         seq=S, mesh={"dp": 1, "sp": RING_RANKS}, steps=RING_STEPS,
         rotation=f"gloo, pinned-host staged, {RING_RANKS} ranks on card 0",
         core_check=r0["core_check"], rtol=RTOL, atol=ATOL,
         first_loss=losses[0], dense_first_loss=r0["dense_first_loss"],
         first_loss_rel_gap=abs(losses[0] - r0["dense_first_loss"]) / r0["dense_first_loss"],
         first_loss_rtol=RING_LOSS_RTOL, losses=losses,
         per_rank=[{k: r[k] for k in ("rank", "launches", "step_ms", "steady_step_ms",
                                       "tokens_per_s", "step_split", "step_device_busy_ms",
                                       "core_fwd", "core_bwd",
                                       "kv_shift_host_ms", "kv_shift_bytes", "peak_mem_gb",
                                       "backend")} for r in ranks],
         dense_fwd_ms=r0["dense_fwd_ms"], dense_bwd_ms=r0["dense_bwd_ms"],
         # the ranks share the card, which runs one process's work at a time
         card_idle_share=1 - sum(r["step_device_busy_ms"] for r in ranks)
         / (sum(r["step_split"]["step_ms"] for r in ranks) / RING_RANKS),
         seconds=time.perf_counter() - t0)
    check(all(math.isfinite(x) for x in losses), f"non-finite ring loss: {losses}")
    check(sum(losses[-3:]) / 3 < losses[0], f"ring loss did not decrease: {losses}")
    check(abs(losses[0] - r0["dense_first_loss"])
          <= RING_LOSS_RTOL * abs(r0["dense_first_loss"]),
          f"ring first loss {losses[0]} vs dense flash loss {r0['dense_first_loss']}")
    for r in ranks:
        check(r["losses"] == losses, f"rank {r['rank']} saw other losses: {r['losses']}")
        for name, n in r["launches"].items():
            want = cfg.n_layers * (r["rank"] + 1) * RING_STEPS
            check(n == want, f"rank {r['rank']} launched {name} {n} times, want {want}")
    return {key: [r["launches"][key] for r in ranks] for key in ("fwd", "dq", "dkv")}


def kernel_class(name: str) -> str:
    """Convolutions (cuDNN's implicit GEMMs, forward, dgrad, wgrad, and the
    cuBLAS GEMMs it runs 1x1 convolutions and the head as),
    norms (batch-norm statistics, normalize and their backward) or
    elementwise work (everything else: ReLU, adds, casts, pads, pooling,
    the optimizer's updates)."""
    low = name.lower()
    if any(w in low for w in ("conv", "xmma", "gemm", "cutlass", "dgrad", "wgrad", "fprop",
                              "cudnn", "implicit", "nvjet")):
        return "conv"
    if "batch_norm" in low or "batchnorm" in low:
        return "norm"
    return "elementwise"


def resnet_phase(smi: str) -> None:
    """The port's bench at full width on card 0 (`kungfu_tpu_torch.bench`:
    ResNet-50, 224x224, 1000 classes, 128 images, S-SGD(SGD momentum)),
    a profiler pass over 3 steady steps, and the gates: bf16 eval logits
    against the same weights in f32 on the card, finite falling losses,
    running statistics finite and moved."""
    import torch

    from kungfu_tpu_torch import bench
    from kungfu_tpu_torch.models import resnet

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = bench.Bench(bench.parse_args(["--device", "cuda"]))
    res = b.run()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(x) for x in b.losses]

    def three_steps():
        for i in range(3):
            b.step(i % bench.INNER)
        return float(b.losses[-1])  # waits for the device

    rows, wall_ms, _ = profile_steps(three_steps, 3)
    busy = sum(r[1] for r in rows)
    classes = {}
    for name, ms, n in rows:
        c = classes.setdefault(kernel_class(name), {"ms_per_step": 0.0, "per_step": 0})
        c["ms_per_step"] += ms
        c["per_step"] += n

    # gate: eval logits in bf16 against the same weights in f32, on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = resnet.resnet50(1000, torch.float32)
    ref.load_state_dict(b.model.state_dict())
    ref = ref.to(b.device, memory_format=torch.channels_last)
    gen = torch.Generator(device=b.device).manual_seed(7)
    side = b.args.image_size
    x = torch.randn(RESNET_EVAL_IMAGES, side, side, 3, device=b.device, generator=gen)
    with torch.no_grad():
        got, want = b.model(x, train=False), ref(x, train=False)
    err = (got - want).abs()
    ratio = (err / (RESNET_ATOL + RESNET_RTOL * want.abs())).max().item()
    stats = torch.cat([t.reshape(-1) for t in b.stats])
    init = torch.cat([torch.ones_like(t).reshape(-1) if name.endswith("var")
                      else torch.zeros_like(t).reshape(-1)
                      for name, t in b.model.named_buffers()])
    moved = (stats - init).abs().max().item()
    first, again = losses[0], losses[-bench.INNER]  # batch 0, first and last window
    emit("resnet", **res, nvidia_smi=smi, batch=b.args.batch, image_size=b.args.image_size,
         inner=bench.INNER, windows=bench.WINDOWS, warmup_windows=bench.WARMUP_WINDOWS,
         steps=len(losses), first_loss=first, last_window_first_loss=again,
         last_loss=losses[-1], peak_mem_gb=peak_gb,
         profile={"steps": 3, "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
                  "device_idle_share": 1 - busy / wall_ms,
                  "device_idle_share_vs_bench_step": 1 - busy / res["step_ms"],
                  "kernels_per_step": sum(r[2] for r in rows), "by_class": classes,
                  "top": top(rows)},
         eval_check={"images": RESNET_EVAL_IMAGES, "max_abs_err": err.max().item(),
                     "worst_tol_ratio": ratio, "rtol": RESNET_RTOL, "atol": RESNET_ATOL,
                     "ref_max_abs": want.abs().max().item()},
         stats_check={"finite": bool(stats.isfinite().all()), "max_moved": moved},
         seconds=time.perf_counter() - t0)
    check(all(math.isfinite(v) for v in losses), f"non-finite ResNet loss: {losses}")
    check(again < first, f"ResNet loss did not fall on batch 0: {first} -> {again}")
    check(bool(got.isfinite().all()) and ratio <= 1.0,
          f"bf16 eval logits vs f32: worst error/tolerance {ratio}")
    check(bool(stats.isfinite().all()) and moved > 0.0, "running statistics did not move")


def _opt_rank(rank: int, peers) -> dict:
    """One rank of the optimizers phase: ResNet-50 at full width, 16 images
    a rank, 3 steps of each wrapper from one broadcast initialization."""
    os.environ.update(KF_SELF_SPEC=peers[rank], KF_INIT_PEERS=",".join(peers),
                      KF_DEVICE_SLOTS="0", CUBLAS_WORKSPACE_CONFIG=":4096:8")
    import torch

    from kungfu_tpu_torch.initializer import broadcast_variables
    from kungfu_tpu_torch.models.resnet import init_resnet, resnet50, resnet_loss
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.optimizers import core
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
    from kungfu_tpu_torch.parallel.dp import make_train_step
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    # deterministic kernels: two runs of one wrapper give the same bits, so
    # ZeRO against S-SGD measures the wrappers, not cuDNN's algorithms; an
    # op with no deterministic version raises
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    device = initialize_device_plane(backend="gloo")
    session = make_mesh(device)
    group = session.group
    model = broadcast_variables(
        init_resnet(resnet50(1000), torch.Generator().manual_seed(0), device), session)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    params = list(model.parameters())
    gen = torch.Generator(device=device).manual_seed(100 + rank)
    batches = [(torch.randn(OPT_BATCH, OPT_SIDE, OPT_SIDE, 3, device=device, dtype=torch.bfloat16,
                            generator=gen),
                torch.randint(0, 1000, (OPT_BATCH,), device=device, generator=gen))
               for _ in range(OPT_STEPS)]

    def sgd(ps):
        return torch.optim.SGD(ps, lr=0.1, momentum=0.9)

    def flat():
        return torch.cat([p.detach().reshape(-1) for p in params])

    def bitwise_equal_across_ranks(t) -> bool:
        same = torch.tensor([float(torch.equal(collective.broadcast(t, 0, group), t))],
                            device=device)
        return bool(collective.all_reduce(same, group=group).item() == session.size)

    timed_names = ("group_all_reduce", "group_broadcast", "reduce_scatter",
                   "all_gather_into", "all_reduce")
    out = {"rank": rank, "device": str(device), "backend": session.describe(), "wrappers": {}}
    finals = {}
    for name in ("ssgd", "ssgd_again", "zero", "sma", "ada"):
        model.load_state_dict(init)
        if name.startswith("ssgd"):
            opt = core.synchronous_sgd(sgd(params), session)
        elif name == "zero":
            opt = core.zero_sharded(sgd, params, session)
        elif name == "sma":
            opt = core.synchronous_averaging(sgd(params), session, alpha=SMA_ALPHA)
        else:
            opt = core.adaptive_sgd(sgd, params, session, change_step=1, alpha=SMA_ALPHA)
        step = make_train_step(resnet_loss, opt, session)
        session.barrier()
        torch.cuda.reset_peak_memory_stats(device)
        losses, step_ms = [], []
        w = {"start_mem_gb": torch.cuda.memory_allocated(device) / 2**30}
        for i in range(OPT_STEPS):
            if name == "sma" and i == 1:  # the step the parent checks
                before = flat()
            t0 = time.perf_counter()
            losses.append(float(step(model, batches[i])))  # waits for the device
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if name == "sma" and i == 1:
                buf = torch.cat([opt.base.state[p]["momentum_buffer"].reshape(-1)
                                 for p in params])
                torch.save({"before": before.cpu(), "buf": buf.cpu(), "after": flat().cpu()},
                           OPT_OUT / f"sma_rank{rank}.pt")
            if name == "ada" and i == 1:  # the switch step
                w["bitwise_equal_after_switch"] = bitwise_equal_across_ranks(flat())
        finals[name] = flat()
        if name == "ada":
            w["bitwise_equal_after_last_step"] = bitwise_equal_across_ranks(finals[name])
        w["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
        if name in ("ssgd", "zero"):
            w["state_bytes"] = core.state_bytes(opt.base)
        # one more step, after the gates' readings, with each collective
        # timed from a drained stream: the gloo ms of a step
        spent = {"ms": 0.0}
        saved = {n: getattr(collective, n) for n in timed_names}

        def timed(fn):
            def run(*args, **kwargs):
                torch.cuda.synchronize(device)
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    spent["ms"] += (time.perf_counter() - t) * 1e3
            return run

        for n, fn in saved.items():
            setattr(collective, n, timed(fn))
        try:
            t0 = time.perf_counter()
            float(step(model, batches[0]))
            timed_step_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for n, fn in saved.items():
                setattr(collective, n, fn)
        steady = sorted(step_ms[1:])
        w.update(losses=losses, step_ms=step_ms, steady_step_ms=steady[len(steady) // 2],
                 timed_step_ms=timed_step_ms, gloo_ms_per_step=spent["ms"])
        out["wrappers"][name] = w
    out["zero_vs_ssgd_max_abs"] = (finals["zero"] - finals["ssgd"]).abs().max().item()
    out["ssgd_vs_ssgd_again_max_abs"] = (finals["ssgd_again"] - finals["ssgd"]).abs().max().item()
    out["param_count"] = finals["ssgd"].numel()
    out["leaves"] = len(params)
    return out


def opt_worker(rank: int, peers) -> None:
    from kungfu_tpu_torch.parallel.distributed import shutdown_device_plane

    try:
        out = _opt_rank(rank, peers)
        (OPT_OUT / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        shutdown_device_plane()


def spawn_world(worker, n: int, deadline_s: float, what: str) -> None:
    """Run `worker(rank, peers)` in n spawned processes; raise if they do
    not finish in `deadline_s` (and kill what is left)."""
    import torch.multiprocessing as mp

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    peers = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    ctx = mp.start_processes(worker, args=(peers,), nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1):
            check(time.monotonic() < deadline, f"the {what} workers did not finish in "
                  f"{deadline_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()


def optimizers_phase(smi: str) -> None:
    """S-SGD, ZeRO-1, SMA and AdaptiveSGD on two gloo ranks sharing card 0,
    ResNet-50 at full width, 16 images a rank; the parent checks ZeRO
    against S-SGD and its state's size, one SMA step against its formula,
    and AdaptiveSGD's ranks bitwise equal after the switch."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    OPT_OUT.mkdir(parents=True, exist_ok=True)
    for f in list(OPT_OUT.glob("rank*.json")) + list(OPT_OUT.glob("sma_rank*.pt")):
        f.unlink()
    spawn_world(opt_worker, OPT_RANKS, OPT_DEADLINE_S, "optimizers")
    ranks = [json.loads((OPT_OUT / f"rank{r}.json").read_text()) for r in range(OPT_RANKS)]

    # SMA's second step against p + u + alpha (mean(p) - p), u = -lr * buf
    sma = [torch.load(OPT_OUT / f"sma_rank{r}.pt", map_location="cpu")
           for r in range(OPT_RANKS)]
    mean = sum(s["before"] for s in sma) / OPT_RANKS
    sma_err = 0.0
    for s in sma:
        want = s["before"] - 0.1 * s["buf"] + SMA_ALPHA * (mean - s["before"])
        ratio = ((s["after"] - want).abs() / (SMA_ATOL + SMA_RTOL * want.abs())).max().item()
        sma_err = max(sma_err, ratio)
    spread = (sma[0]["before"] - sma[1]["before"]).abs().max().item()
    del sma
    n_params, leaves = ranks[0]["param_count"], ranks[0]["leaves"]
    ssgd_bytes = ranks[0]["wrappers"]["ssgd"]["state_bytes"]
    zero_bytes = [r["wrappers"]["zero"]["state_bytes"] for r in ranks]
    pad_bytes = OPT_RANKS * leaves * 4
    emit("optimizers", nvidia_smi=smi, model="resnet50", images_per_rank=OPT_BATCH,
         image_size=OPT_SIDE, ranks=OPT_RANKS, steps=OPT_STEPS, base="SGD(lr 0.1, momentum 0.9)",
         transport=f"gloo, {OPT_RANKS} ranks on card 0", params=n_params,
         zero_vs_ssgd_max_abs=[r["zero_vs_ssgd_max_abs"] for r in ranks],
         ssgd_rerun_max_abs=[r["ssgd_vs_ssgd_again_max_abs"] for r in ranks],
         ssgd_state_bytes=ssgd_bytes, zero_state_bytes=zero_bytes,
         sma_check={"worst_tol_ratio": sma_err, "rtol": SMA_RTOL, "atol": SMA_ATOL,
                    "ranks_apart_before_max_abs": spread},
         per_rank=[{"rank": r["rank"], **{
             name: {k: w[k] for k in ("losses", "steady_step_ms", "step_ms", "timed_step_ms",
                                      "gloo_ms_per_step", "start_mem_gb", "peak_mem_gb")}
             for name, w in r["wrappers"].items()}} for r in ranks],
         ada_bitwise_equal=[{k: v for k, v in r["wrappers"]["ada"].items()
                             if k.startswith("bitwise")} for r in ranks],
         seconds=time.perf_counter() - t0)
    for r in ranks:
        for name, w in r["wrappers"].items():
            check(all(math.isfinite(x) for x in w["losses"]),
                  f"rank {r['rank']} {name}: non-finite loss {w['losses']}")
        # deterministic kernels, and at two ranks the reduce-scatter adds the
        # same two gradients as the all-reduce: ZeRO is S-SGD to the bit,
        # once S-SGD is itself to the bit
        check(r["ssgd_vs_ssgd_again_max_abs"] == 0.0,
              f"rank {r['rank']}: two S-SGD runs differ by "
              f"{r['ssgd_vs_ssgd_again_max_abs']}: the kernels are not deterministic")
        check(r["zero_vs_ssgd_max_abs"] == 0.0,
              f"rank {r['rank']}: ZeRO vs S-SGD differ by {r['zero_vs_ssgd_max_abs']}")
        ada = r["wrappers"]["ada"]
        check(ada["bitwise_equal_after_switch"] and ada["bitwise_equal_after_last_step"],
              f"rank {r['rank']}: AdaptiveSGD's ranks differ after the switch")
    for b in zero_bytes:
        check(b <= ssgd_bytes / OPT_RANKS + pad_bytes,
              f"ZeRO state {b} bytes > half of S-SGD's {ssgd_bytes} plus padding")
    check(spread > 0.0, "SMA's ranks did not diverge before the checked step")
    check(sma_err <= 1.0, f"SMA step vs its formula: worst error/tolerance {sma_err}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 2
    from kungfu_tpu_torch.ops import _build
    from kungfu_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    libs = _build.build_all(["flash_attention"])
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: str(v) for k, v in libs.items()})

    occ = occupancy_phase(fa)
    kern = kernel_phase(fa)
    train = train_phase(fa)
    profile_phase(train["step_ms"])
    ring_launches = ring_phase()
    resnet_phase(smi)
    optimizers_phase(smi)

    lines = []
    for kname, (key, tpu_line, tpu_body) in KERNELS.items():
        lines.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{TPU_SOURCE}:{tpu_line}", "tpu_source": f"{TPU_SOURCE}:{tpu_body}",
            "launches": train["launches"][key],
            "ring_launches": ring_launches[key],
            "max_abs_err": kern["errs"][kname], "max_err": kern["errs"][kname],
            "ms": kern["ms"][kname], "ms_cold_l2": kern["ms_cold"][kname],
            "plain_ms": kern["plain_ms"][kname],
            "bound_ms": kern["bounds"][kname]["bound_ms"],
            "bound_by": kern["bounds"][kname]["bound_by"],
            "library_ms": kern["library_ms"][kname],
            # SDPA's backward alone computes dQ, dK and dV: the pair's yardstick
            "library_pair_ms": kern["library_pair_ms"][kname],
            "smem_bytes": occ[kname]["smem_bytes"],
            "blocks_per_sm": occ[kname]["blocks_per_sm"],
        })
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

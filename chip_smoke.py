#!/usr/bin/env python3
"""Smoke run of kungfu_tpu_torch on one CUDA card (an H100 for the numbers
in PERF.md).

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device   card name and power limit (`nvidia-smi`), torch and CUDA versions;
  build    the kernels of csrc/ compiled by nvcc for sm_90a, one nvcc per
           source, all at once;
  analyzer the port's static analyzer, `python -m
           kungfu_tpu_torch.devtools.check --no-cache`, in a child process
           started before the build and reaped after it: its rules, the
           files it scanned, its findings (the gate: none, exit 0) and its
           seconds, beside the card's name and power limit;
  occupancy  each kernel's dynamic shared memory, active blocks per SM,
           registers and spilled bytes per thread (CUDA runtime), hd 64/128;
  kernel   each flash-attention kernel (forward with O and LSE, dQ with
           delta, dK/dV) against its plain PyTorch version on the same inputs
           at B=8, H=12, hd=64 in bf16: S=512 causal and not, and a ragged
           S=500; and at the parallel phase's shapes, causal S=512: B=2,
           H=12 (a pipeline microbatch) and B=8, H=6 (a tp rank); then times: kernel and library (SDPA forward, and SDPA's
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
           single-process kernel path; then BERT-base over a dp 1 x sp 2 mesh for 3
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
           then the benchmarks' device entry points as a world of one on
           card 0, each printing its RESULT line: `bench_xla` (`--method
           XLA`, the fake ResNet-50's 23,435,432 f32 values, 10 timed
           rounds; at a world of one `group_all_reduce` clones each
           buffer and drives no NCCL, so its gate, the sums exactly the
           inputs times the world's size, checks the entry point and its
           RESULT line, not a reduction) and `bench_gns` (`--method GNS`,
           the MLP's plain against its GNS-monitored step);
  optimizers  two gloo worker processes sharing card 0 train ResNet-50 at
           full width, 16 images a rank, 3 steps each of S-SGD (twice),
           ZeRO-1, SMA (alpha 0.1) and AdaptiveSGD (change_step 1) from one
           broadcast initialization, with deterministic kernels, results in
           `build/chip_smoke_opt/`; gates: the two S-SGD runs bitwise equal,
           ZeRO's parameters bitwise equal to S-SGD's and its state at most half of S-SGD's plus padding,
           SMA's second step against its formula from both ranks'
           parameters, and AdaptiveSGD's ranks bitwise equal after the
           switch; per rank the steady step ms, the gloo ms of a step and
           the peak memory;
  monitors  in the same workers, 3 steps each of S-SGD with the gradient-
           noise-scale monitor and with the gradient-variance monitor
           (interval 1); gate: the first step's g2, s and variance against
           their f64 recomputation from both ranks' saved gradients; the
           steady step ms and the gradient average's ms of each beside
           S-SGD's (the monitors' overhead);
  parallel two gloo workers sharing card 0 (results in
           `build/chip_smoke_par/`): BERT-base as a causal LM on one fixed
           8 x 512 batch through the GPipe pipeline (pp 2, 6 layers a stage,
           4 microbatches, 4 AdamW steps) and tensor parallelism (dp 1 x
           tp 2, 6 heads a rank, 3 AdamW steps), flash core; gates: each
           first loss within 1e-4 relative of the dense flash path in one
           process, exact flash launches a step a rank (pipeline 24, TP 12),
           finite falling losses; then top-2 MoE over ep 2 at D 768, F 3072,
           4096 tokens a rank, 4 experts a rank, capacity factor 1.25, bf16,
           forward and backward, against the plain MoE of both shards in one
           process (out, dx and the router gradient per element within 2e-2,
           the expert gradients within 2e-2 of their scale), dropped tokens
           printed; per path the step ms and its split between collectives
           and the rest;
  hostplane  the host plane's framework-free core on real data: 4 sets of
           ResNet-50 gradients (16 images each, four seeded batches, 25,557,032
           f32 values a set) copied into pinned buffers from the port's
           BufferPool, then the host all-reduce of 4 simulated peers replayed
           in one process through the port's host C++: the segmented ring in
           f32, with the bf16 wire and with the int8 wire (block 16), and the
           default strategy's (BINARY_TREE_STAR) graph pair in f32; gates:
           each walk bitwise equal to its replay through the plain twins,
           every peer holding the same bits, the f32 ring and tree within
           2 (k - 1) 2^-24 sum|g| + 2^-126 of the card's sum elementwise and of
           each other, bf16 within 2 max|sum| 2^-8 and int8 within
           2 max|sum| 2/127 of the card's sum; prints each walk's ms (and its
           plain replay's), transform2 / transform_n (k 4) / codec GB/s on the
           102 MB buffers, pinned device-to-host and host-to-device GB/s, the
           host CPU, and the MST and ring plan (with its digest, derived
           twice) of a seeded 8 x 8 bandwidth matrix;
  hostnet  4 worker processes on card 0, each a Peer from kfrun's
           environment, all-reduce their ResNet-50 gradients over the
           transport (segmented ring in f32, bf16 and int8, the default
           tree, `api.group_all_reduce_arrays`); each mode's first call
           bitwise equal to the in-process replay of the saved inputs;
  sma      BASELINE config 3: `examples/bert_sma.main` on 4 worker
           processes sharing card 0 (BERT-base, a fixed 8 x 512 masked-LM
           batch a rank, 4 steps of AdamW and the SMA blend over the host
           plane); gates: finite losses falling on every rank, 12 x 4
           launches of each flash kernel a rank, step 0's sums equal across
           ranks and the embedding's equal to its in-process replay, each
           rank's blended parameters bitwise the blend formula on its saved
           inputs, rank 0's first loss within RTOL of the plain core; the
           local step's ms and the blend's split (copy out, walk, copy back
           and blend);
  async    4 worker processes, KF_CONFIG_ASYNC and KF_CONFIG_ZERO on:
           ResNet-50 at 16 images a rank, 3 SGD steps by the frontend's
           S-SGD through post-accumulate-grad hooks, by its step-end path,
           and by ZeroSGD, every tensor a bucket of its own; gates: the
           three bitwise equal after every step and across ranks, ZeRO's
           state at most a quarter of the parameters plus slack; step ms
           and the scheduler's stats, and the hooks at the default cap;
  telemetry  4 workers: S-SGD with telemetry off, then on, then
           ZeroSGD with it on, 6 steps each; rank 0 scrapes every rank's /metrics, /trace
           and /audit between steps;
  replan   measured topology: 4 workers on card 0, ResNet-50 at 16 images
           a rank, ZeroSGD(0.1, 0.9) over the segmented f32 ring on sockets
           (KF_CONFIG_SHM=0), metrics on, a ledger window of 3 steps after
           1 settle step, each leg a cluster epoch. An unshaped calibration
           picks the rate at which the bytes of edge rank 1 -> 2 take 4x
           the unshaped walk. (a) KF_SHAPE_LINKS shapes that edge and
           ReplanPolicy (every 4 steps, patience 2; reorder only, at a
           predicted 2x) runs 12 steps in a PolicyRunner; (b) ZeRO-1 with
           api.check_replan after step 2 (reordered and weighted), 4 steps,
           and (b2) the replicated update with the same plan adopted after
           the same step; (c) two virtual hosts {0, 1} and {2, 3} (1 ms and
           a cap on every cross-host edge, a shared uplink a host),
           check_replan after step 1 adopts a two-level plan, rank 3 is
           demoted after step 3 and promoted after step 5, 5 steps. Gates:
           parameters bitwise equal across ranks after every step; one
           adoption in (a), with one digest, routing around 1 -> 2, graded
           `delivered` on every rank's /decisions, one audit event, the
           re-plan counter at 1, rank 1's slowest link the shaped one, the
           shaped walk at least 3x the unshaped; (b) bitwise (a) before the
           flip and bitwise (b2) at every step, the plan's averaged
           gradient past the flip within 2 (k - 1) 2^-24 sum|g| + 2^-126
           (over k) of the rank-order ring's, ZeRO's state at most its
           weighted share plus slack; (c) the plan's groups the virtual
           hosts, demotion for exactly two steps, peer_demoted and
           peer_promoted records on every rank, the two-level sum within
           the f32 limit of the card's; the first walk after each leg's
           first adoption bitwise equal to its replay through the plain
           twins (ring_replay with the plan's order and weights,
           hier_replay). Prints the matrices, predicted against realized
           gains beside the compute fraction each round shared (the clamp
           1/cf on a predicted gain), step and walk ms before and after,
           the rounds' ms (vote, matrix, digest and listeners), heads' and
           members' wire bytes;
  forensics  run-level forensics: 4 workers of this script
           (`--forensics-worker`) on card 0 under the port's kfrun `-w
           -auto-recover 30s -builtin-config-port 0 -debug-port`, ResNet-50
           at 16 images a rank, S-SGD over the segmented f32 ring on
           sockets, metrics, trace and audit on, a flight snapshot every
           0.5 s, the aggregator sweeping every 1 s (results, kfrun's log
           and the run dir in `build/chip_smoke_fx/`). (a) 3 unshaped
           steps on the step-end path pick the rate at which the edge
           rank 1 -> 2 takes 4x the unshaped walk; a cluster epoch shapes
           it and turns the async hook path on (2 buckets), 10 steps in a
           PolicyRunner. Gates: every rank's /steptrace one timeline a
           round, a lane a bucket naming its ring successor; the last 6
           merged steps of /cluster/steps elect rank 1 and its edge to
           rank 2, overlap and queue-delay fractions in [0, 1];
           /cluster/health during training lists the 4 peers stepping
           (p50 <= p99) and names the edge; every rank's PolicyRunner
           reads it from advancing refreshes; /cluster/metrics holds each
           rank's ring bytes under peer=, exactly the formula; parameters
           bitwise equal after every step. The resource and memory planes,
           read by rank 0 at the end of (a): /cluster/resources and
           /cluster/memory list the 4 peers (every route a 200); each rank
           attributes CPU seconds to main and to the kf-sched-* threads,
           its steptrace, link_table, decisions and scheduler accountants
           held bytes in (a) (the aggregator's in rank 0's one-shot
           aggregator), 0 < RSS < effective_mem_limit(), grow_ok() true, no
           leak verdict (each rank's RSS after every step printed). (b) rank 0 takes a SIGUSR2
           (a dump record), rank 3 SIGKILLs itself, kfrun is stopped by
           SIGTERM; gates: one postmortem naming SIGKILL, its last step,
           rank 3's last line, the step ring and the ledger's tail, its
           last snapshot's resource and memory documents and no leak
           suspect in them, rank 3 idle at most 4.5 s from its record to
           its kill (what the idle added to its RSS printed by kind of
           mapping), oom_suspected false over the last 12 memory
           samples (KF_MEMORY_TREND=12), on /cluster/postmortem, in postmortems.jsonl and as the
           runner's one worker_postmortem; the survivors' journals whole,
           ending in their SIGTERM flush. Prints step ms, each view's
           scrape ms and bytes, the aggregator's sweep s, journal bytes and
           snapshots, the kill -> postmortem ms split into detection and
           harvest, and per rank the compute fraction, engine share, RSS
           and bytes by accountant. The port's `info` CLI, called in
           process at the end of (a) while the watcher serves /cluster/*:
           top, links, steps, decisions, resources and memory with --json
           (gate: the document the phase reads from the same route around
           it, up to the fields that moved between those two reads) and
           rendered (gates: every rank named; top, links and steps name the
           shaped edge 1 -> 2, steps the count of merged steps the phase
           read, decisions every rank's async_mode record); after (b),
           `info postmortem <run dir>` names the one dead rank, its death
           and last step as the postmortem gate reads them;
  elastic  BASELINE config 5's resize path: the port's kfrun
           (`python -m kungfu_tpu_torch.runner.cli -w`, a built-in config
           server, one warm standby) starts 2 workers of this script
           (`--elastic-worker`) on card 0: ResNet-50 at 16 images a rank of
           a seeded synthetic set, S-SGD with momentum over the host plane
           under ElasticState, sizes from StepBasedSchedule("2:2,4:2,2:2")
           on rank 0 (results in `build/chip_smoke_elastic/`); gates: kfrun
           exits 0, sizes [2,2,4,4,2,2], every rank's parameters,
           running statistics and momentum equal after every step, each
           joiner's state after the grow's sync equal to the survivors',
           the shed workers detached and the survivors finished, each
           step's global batch the next stretch of the dataset's order,
           the losses finite and falling; prints each resize's phases, the
           state sync's seconds and bytes, each joiner's spawn-to-ready ms
           (standby or cold), the runner's Stage-to-start ms, and the step
           ms at 2 and 4 workers;
  checkpoint  config 5's recovery path: in process, ResNet-50's training
           state (parameters, BN statistics, momentum, int64 step) on card 0
           saved by the port's Checkpointer at steps 1-3 (window 2) and
           restored under KF_RECOVER_EPOCH=2; then 2 workers under the port's
           kfrun -auto-recover train it at 16 images a rank for 4 steps, a
           checkpoint every 2, rank 1 crashing once after the step-2
           checkpoint (results in `build/chip_smoke_ckpt/`); gates: the
           restore bitwise the saved state on the card, the window and the
           cap, `dump_final_variables` byte-equal to `pack_leaves` in jax's
           order, the resumed run's final state bitwise the uninterrupted
           run's; prints save and restore s and GB/s, bytes on disk, and the
           time to recover split into the runner's relaunch, the workers'
           start, the restore and the first step;
  resize_bench  `python -m kungfu_tpu_torch.bench_resize` (its JSON line;
           gate: at least 5 resizes), then `examples/adaptive_batch` (30 steps) under
           the port's kfrun -w from 1 worker on 4 slots; gates: it grows, its
           sizes never fall nor pass 4, every worker prints done, the ranks'
           w bitwise equal;
  pair     BASELINE config 4's optimizer at full width: 4 workers on card
           0, ResNet-50 at 16 images a rank on fixed batches, PairAveraging
           over SGD(0.1, 0.9) for 4 steps; gates: finite falling losses, an
           averaged step on every rank, each averaged step bitwise its replay
           (the f32 average with the fetched blob, then the base step);
           prints step ms, the join's exposed wait against the prefetch's
           own time, pack and publish ms, bytes fetched; then
           `examples/cyclegan_pair` on 2 workers (gate: its probe);
  hier     4 workers on card 0 as 2 worlds x 2 ranks (gloo in a world,
           the host plane across), ResNet-50 at 16 images a rank, SGD, 4
           steps with the cross-world wire in f32, then bf16; gates: every
           rank's parameters equal after every step (MIN and MAX
           all-reduces), the first step's mean within the f32 limit (bf16:
           2 max|mean| 2^-8) of a flat host all-reduce's; prints step ms
           split into backward, in-world mean, leaders' walk and broadcast,
           the cross-world wire bytes beside the flat all-reduce's; then
           `examples/multislice_train` at world sizes 2 and 1 (each ends
           with its worlds' MIN/MAX check);
  wall     the script's seconds before the checkpoint phase and after, and
           `phases`: each phase's seconds (every phase line also carries
           its own `seconds`).
Then the line of kernels, and last `{"ok": true, "device": {...}}`. Any
failed check raises and the script exits non-zero before that last line.
It also exits non-zero, printing no result, without a CUDA device or
outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path


def _share_bytecode() -> None:
    """Keep compiled bytecode under build/pycache, for this process and
    every process it starts: where the interpreter may not write it beside
    the sources (PYTHONDONTWRITEBYTECODE, a site-packages without
    __pycache__), every process would compile torch from source again,
    and the script starts dozens. multiprocessing's children inherit `-B`
    from such an interpreter; they run this too, when they load the
    script as `__mp_main__`, before they import torch."""
    prefix = str(Path(__file__).resolve().parent / "build" / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix = prefix
    sys.dont_write_bytecode = False


if __name__ in ("__main__", "__mp_main__"):
    _share_bytecode()

B, H, S, HD = 8, 12, 512, 64
S_RAGGED = 500
STEPS = 8
RING_STEPS = 3
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
TOOL_ITERS = 10  # the benchmarks' --iters default: bench_xla's samples, bench_gns's windows
OPT_RANKS, OPT_BATCH, OPT_STEPS, OPT_SIDE = 2, 16, 3, 224
OPT_DEADLINE_S = 300
OPT_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_opt"
SMA_ALPHA = 0.1
# one SMA step against its formula recomputed in the parent: the same
# operations in another order, a few f32 roundings apart
SMA_RTOL, SMA_ATOL = 1e-6, 1e-7
MONITOR_RTOL = 1e-5  # the monitors' first step against f64 (see monitors_check)
MONITOR_TURNS = 7  # gradient averages timed a wrapper, in turns
PAR_RANKS = 2
PP_STEPS, PP_MICRO = 4, 4
TP_STEPS = 3
PAR_DEADLINE_S = 400
PAR_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_par"
# pipeline's and TP's first loss against the dense flash path in one
# process: the ring's limit (same model, same batch, another split of the
# same products)
PAR_LOSS_RTOL = 1e-4
MOE_D, MOE_F, MOE_T, MOE_EPD, MOE_CF, MOE_AUX_W = 768, 3072, 4096, 4, 1.25, 0.01
MOE_SHARED = 0.5  # the tokens' common component
MOE_GRAD_TOL = 2e-2  # of the tensor's largest |value|: the expert weight gradients
# the host plane's replay: k simulated peers' ResNet-50 gradients (the
# optimizers phase's 16 images each), the int8 wire at the engine's block
HOST_PEERS = 4
HOST_QWIRE = (8, 16)
HOST_TURNS = 5  # timed calls of each host function, the median kept
# the ring's and the tree's f32 sums against the card's, elementwise: two
# summation orders of k terms differ by at most 2 (k - 1) u sum|g|, u = 2^-24,
# plus the smallest normal for gradual underflow
HOST_F32_ULP = 2.0 ** -24
HOST_F32_FLOOR = 2.0 ** -126
# the wire codecs' limits of tests/test_wire_codec.py:46,211 and
# tests/test_wire_q.py:53,233: 2 max|sum| eps, eps 2^-8 (bf16), 2/127 (int8)
HOST_WIRE_EPS = {"bf16": 2.0 ** -8, "int8": 2.0 / 127.0}
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


ANALYZER_DEADLINE_S = 120
ANALYZER_WAIT_S = 10.0  # the most the analyzer may add to the run's wall time


_LAST_EMIT = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    """One phase line; a line that times nothing itself carries `seconds`
    since the line before it."""
    now = time.perf_counter()
    fields.setdefault("seconds", now - _LAST_EMIT[0])
    _LAST_EMIT[0] = now
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"chip_smoke check failed: {what}")


def _deterministic() -> None:
    """cuDNN's deterministic kernels and torch's deterministic-algorithms
    flag, set as `torch.use_deterministic_algorithms(True)` sets it for
    eager code. That call also imports `torch._inductor` to set inductor's
    flag, a large import every worker would pay; the port runs no inductor
    code."""
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch._C._set_deterministic_algorithms(True)


_RESNET_SEED0: dict = {}


def _resnet50_seed0(device):
    """A new ResNet-50 module holding `init_resnet`'s seed-0 draw on
    `device`; the draw is made once a process, later models copy it."""
    import torch

    from kungfu_tpu_torch.models import resnet as kf_resnet

    state = _RESNET_SEED0.get(str(device))
    if state is None:
        model = kf_resnet.init_resnet(kf_resnet.resnet50(1000),
                                      torch.Generator().manual_seed(0), device)
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        _RESNET_SEED0[str(device)] = state
    model = kf_resnet.resnet50(1000).to(device, memory_format=torch.channels_last)
    model.load_state_dict(state)
    return model


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
    # (path, batch, heads, causal, S): the dense path's shapes, then those
    # the parallel phase gives the kernels (a pipeline microbatch of
    # B / PP_MICRO with all heads; a tp rank's H / PAR_RANKS heads)
    cases = (("dense", B, H, True, S), ("dense", B, H, False, S),
             ("dense", B, H, True, S_RAGGED), ("pipeline", B // PP_MICRO, H, True, S),
             ("tp", B, H // PAR_RANKS, True, S))
    for path, b, h, causal, s in cases:
        q, k, v, do = (torch.randn(b * h, s, HD, device=dev, dtype=torch.bfloat16,
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
        emit("kernel_check", path=path, B=b, H=h, S=s, hd=HD, causal=causal,
             dtype="bfloat16", rtol=RTOL, atol=ATOL, results=res)

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
    from kungfu_tpu_torch.parallel.distributed import spawn_world

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    RING_OUT.mkdir(parents=True, exist_ok=True)
    for f in RING_OUT.glob("rank*.json"):
        f.unlink()
    spawn_world(ring_worker, RING_RANKS, RING_DEADLINE_S)
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
    tools = tooling_benches()
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
         tooling=tools, seconds=time.perf_counter() - t0)
    check(all(math.isfinite(v) for v in losses), f"non-finite ResNet loss: {losses}")
    check(again < first, f"ResNet loss did not fall on batch 0: {first} -> {again}")
    check(bool(got.isfinite().all()) and ratio <= 1.0,
          f"bf16 eval logits vs f32: worst error/tolerance {ratio}")
    check(bool(stats.isfinite().all()) and moved > 0.0, "running statistics did not move")


def tooling_benches() -> dict:
    """The port's `python -m kungfu_tpu_torch.benchmarks` device entry
    points on card 0 as a world of one, each printing its RESULT line:
    `--method XLA` (`bench_xla` over the fake ResNet-50's 53 buffers,
    23,435,432 f32 ones; at a world of one `group_all_reduce` clones each
    buffer and drives no NCCL, so the gate, the sums exactly the inputs
    times the world's size, checks the entry point, its device and its
    RESULT line, and its GiB/s is a clone rate; the gloo world of 2 in
    tests/test_torch_port_benches.py checks the sums) and `--method GNS`
    (`bench_gns`: the MLP's S-SGD step against the GNS-monitored one)."""
    import io

    import torch

    from kungfu_tpu_torch.benchmarks.__main__ import bench_gns, bench_xla
    from kungfu_tpu_torch.parallel import shutdown_device_plane

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        xla = bench_xla("resnet50-imagenet", TOOL_ITERS)
    t_xla = time.perf_counter() - t0
    exact = all(torch.equal(o, x * xla["devices"]) for o, x in zip(xla["outs"], xla["inputs"]))
    values = sum(x.numel() for x in xla["inputs"])
    dev = {o.device.type for o in xla["outs"]}
    del xla["outs"], xla["inputs"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        gns = bench_gns(TOOL_ITERS)
    t_gns = time.perf_counter() - t0
    shutdown_device_plane()
    lines = out.getvalue().splitlines()
    for line in lines:
        print(line, flush=True)
    check(exact and dev == {"cuda"} and xla["devices"] == 1,
          f"bench_xla: the sums on {dev} are not the inputs times {xla['devices']}")
    check(len(lines) == 2 and lines[0].startswith("RESULT: ")
          and lines[0].endswith("[XLA x1 devices, resnet50-imagenet]")
          and lines[1].startswith("RESULT: plain ") and lines[1].endswith("[GNS x1 devices]"),
          f"the benchmarks' RESULT lines: {lines}")
    check(all(math.isfinite(gns[k]) and gns[k] > 0 for k in ("plain_ms", "gns_ms")),
          f"bench_gns: {gns}")
    return {"bench_xla": {"result": lines[0], "gib_s": xla["gib_s"], "err": xla["err"],
                          "values": values, "bytes": 4 * values, "iters": TOOL_ITERS,
                          "exact": exact, "seconds": t_xla},
            "bench_gns": {"result": lines[1], "plain_ms": gns["plain_ms"],
                          "gns_ms": gns["gns_ms"], "overhead_pct": gns["overhead_pct"],
                          "iters": TOOL_ITERS, "seconds": t_gns}}


def _opt_rank(rank: int, peers) -> dict:
    """One rank of the optimizers phase: ResNet-50 at full width, 16 images
    a rank, 3 steps of each wrapper from one broadcast initialization."""
    os.environ.update(KF_SELF_SPEC=peers[rank], KF_INIT_PEERS=",".join(peers),
                      KF_DEVICE_SLOTS="0", CUBLAS_WORKSPACE_CONFIG=":4096:8")
    import torch

    from kungfu_tpu_torch.initializer import broadcast_variables
    from kungfu_tpu_torch.models.resnet import resnet_loss
    from kungfu_tpu_torch.monitor import monitor_gradient_noise_scale, monitor_gradient_variance
    from kungfu_tpu_torch.monitor.noise_scale import noise_scale
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.optimizers import core
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
    from kungfu_tpu_torch.parallel.dp import make_train_step
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    # deterministic kernels: two runs of one wrapper give the same bits, so
    # ZeRO against S-SGD measures the wrappers, not cuDNN's algorithms; an
    # op with no deterministic version raises
    _deterministic()
    device = initialize_device_plane(backend="gloo")
    session = make_mesh(device)
    group = session.group
    model = broadcast_variables(
        _resnet50_seed0(device), session)
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

    def flat_grads():
        return torch.cat([p.grad.float().reshape(-1) for p in params])

    def bitwise_equal_across_ranks(t) -> bool:
        same = torch.tensor([float(torch.equal(collective.broadcast(t, 0, group), t))],
                            device=device)
        return bool(collective.all_reduce(same, group=group).item() == session.size)

    timed_names = ("group_all_reduce", "group_broadcast", "reduce_scatter",
                   "all_gather_into", "all_reduce")
    out = {"rank": rank, "device": str(device), "backend": session.describe(), "wrappers": {}}
    finals = {}
    for name in ("ssgd", "ssgd_again", "zero", "sma", "ada", "gns", "var"):
        model.load_state_dict(init)
        if name.startswith("ssgd"):
            opt = core.synchronous_sgd(sgd(params), session)
        elif name == "gns":
            opt = monitor_gradient_noise_scale(sgd(params), session, OPT_BATCH, interval=1)
        elif name == "var":
            opt = monitor_gradient_variance(sgd(params), session, interval=1)
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
            if name in ("gns", "var") and i == 0:
                # the step the parent checks: this rank's gradients before
                # the average, and the monitor's estimate after the step
                opt.zero_grad()
                loss = resnet_loss(model, batches[i])
                loss.backward()
                torch.save(flat_grads().cpu(), OPT_OUT / f"{name}_grads_rank{rank}.pt")
                opt.step()
                w["estimate"] = ({"g2": opt.gns.g2_ema.item(), "s": opt.gns.s_ema.item(),
                                  "noise_scale": noise_scale(opt.gns).item()}
                                 if name == "gns" else {"variance": opt.variance.item()})
                losses.append(float(collective.all_average(loss.detach(), group)))
            else:
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
        saved = timed_calls(collective, timed_names, spent, device)
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
    # the monitors' own cost: the gradient average alone (S-SGD's, GNS's,
    # the variance's), on the gradients of the last step, in turns
    avg_ms = {"ssgd": [], "gns": [], "var": []}
    wrappers = {"ssgd": core.synchronous_sgd(sgd(params), session),
                "gns": monitor_gradient_noise_scale(sgd(params), session, OPT_BATCH),
                "var": monitor_gradient_variance(sgd(params), session)}
    for _ in range(MONITOR_TURNS):
        for name, opt in wrappers.items():
            session.barrier()
            t0 = time.perf_counter()
            opt.average_gradients()
            torch.cuda.synchronize(device)
            avg_ms[name].append((time.perf_counter() - t0) * 1e3)
    out["average_ms"] = {k: sorted(v)[len(v) // 2] for k, v in avg_ms.items()}
    out["zero_vs_ssgd_max_abs"] = (finals["zero"] - finals["ssgd"]).abs().max().item()
    out["ssgd_vs_ssgd_again_max_abs"] = (finals["ssgd_again"] - finals["ssgd"]).abs().max().item()
    out["param_count"] = finals["ssgd"].numel()
    out["leaves"] = len(params)
    out["leaf_sizes"] = [p.numel() for p in params]
    return out


def opt_worker(rank: int, peers) -> None:
    from kungfu_tpu_torch.parallel.distributed import shutdown_device_plane

    try:
        out = _opt_rank(rank, peers)
        (OPT_OUT / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        shutdown_device_plane()


def optimizers_phase(smi: str) -> None:
    """S-SGD, ZeRO-1, SMA and AdaptiveSGD on two gloo ranks sharing card 0,
    ResNet-50 at full width, 16 images a rank; the parent checks ZeRO
    against S-SGD and its state's size, one SMA step against its formula,
    and AdaptiveSGD's ranks bitwise equal after the switch."""
    import torch

    from kungfu_tpu_torch.parallel.distributed import spawn_world

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    OPT_OUT.mkdir(parents=True, exist_ok=True)
    for f in OPT_OUT.glob("*.json"):
        f.unlink()
    for f in OPT_OUT.glob("*.pt"):
        f.unlink()
    spawn_world(opt_worker, OPT_RANKS, OPT_DEADLINE_S)
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
    monitors_check(smi, ranks)
    for b in zero_bytes:
        check(b <= ssgd_bytes / OPT_RANKS + pad_bytes,
              f"ZeRO state {b} bytes > half of S-SGD's {ssgd_bytes} plus padding")
    check(spread > 0.0, "SMA's ranks did not diverge before the checked step")
    check(sma_err <= 1.0, f"SMA step vs its formula: worst error/tolerance {sma_err}")


def monitors_check(smi: str, ranks) -> None:
    """The monitors' first step against the estimators recomputed in f64
    from both ranks' saved gradients, and their cost over S-SGD.

    g2 and s are differences of nearly equal terms (B |g_big|^2 and
    b |g_small|^2; |g_small|^2 and |g_big|^2), so f32 rounding of the
    squared norms comes back multiplied by the ratio of the terms to the
    difference: each is held within MONITOR_RTOL of the terms it is the
    difference of (the relative error to its own value is printed too);
    the variance, a sum of norms, within MONITOR_RTOL of itself."""
    import torch

    b, n = OPT_BATCH, OPT_RANKS
    B = b * n
    grads = [torch.load(OPT_OUT / f"gns_grads_rank{r}.pt").double() for r in range(n)]
    gs = sum(g.square().sum() for g in grads).item() / n
    gb = (sum(grads) / n).square().sum().item()
    g2 = (B * gb - b * gs) / (B - b)
    s = (gs - gb) / (1 / b - 1 / B)
    grads = [torch.load(OPT_OUT / f"var_grads_rank{r}.pt").double() for r in range(n)]
    mean = sum(grads) / n
    var = (sum(g.square() for g in grads) / n - mean.square())
    del grads, mean
    # the port sums the Frobenius norm leaf by leaf; the leaves' split is
    # not saved, so the reference takes the norm over each leaf's slice
    bounds = ranks[0]["leaf_sizes"]
    variance = sum(v.square().sum().sqrt().item()
                   for v in var.split(bounds))
    del var
    gns = ranks[0]["wrappers"]["gns"]["estimate"]
    got_var = ranks[0]["wrappers"]["var"]["estimate"]["variance"]
    errs = {"g2": abs(gns["g2"] - g2) / ((B * gb + b * gs) / (B - b)),
            "s": abs(gns["s"] - s) / ((gs + gb) / (1 / b - 1 / B)),
            "variance": abs(got_var - variance) / variance}
    rel = {"g2": abs(gns["g2"] - g2) / abs(g2), "s": abs(gns["s"] - s) / abs(s),
           "variance": errs["variance"]}

    def steady(name):
        return [r["wrappers"][name]["steady_step_ms"] for r in ranks]

    base = [min(a, c) for a, c in zip(steady("ssgd"), steady("ssgd_again"))]
    emit("monitors", nvidia_smi=smi, model="resnet50", images_per_rank=b, ranks=n, interval=1,
         estimate={"g2_ema": gns["g2"], "s_ema": gns["s"], "noise_scale": gns["noise_scale"],
                   "variance": got_var},
         reference_f64={"g2": g2, "s": s, "noise_scale": s / g2, "variance": variance,
                        "gs": gs, "gb": gb},
         err_vs_terms=errs, rel_err=rel, rtol=MONITOR_RTOL,
         ssgd_steady_ms=base, gns_steady_ms=steady("gns"), var_steady_ms=steady("var"),
         gns_overhead_ms=[g - s_ for g, s_ in zip(steady("gns"), base)],
         var_overhead_ms=[v - s_ for v, s_ in zip(steady("var"), base)],
         gloo_ms_per_step={name: [r["wrappers"][name]["gloo_ms_per_step"] for r in ranks]
                           for name in ("ssgd", "gns", "var")},
         average_ms=[r["average_ms"] for r in ranks],
         average_overhead_ms={name: [r["average_ms"][name] - r["average_ms"]["ssgd"]
                                     for r in ranks] for name in ("gns", "var")})
    for r in ranks:
        check(r["wrappers"]["gns"]["estimate"] == gns and
              r["wrappers"]["var"]["estimate"]["variance"] == got_var,
              f"rank {r['rank']}'s monitor state differs from rank 0's")
    for k, e in errs.items():
        check(e <= MONITOR_RTOL, f"monitor {k} vs its f64 recomputation: {e} > {MONITOR_RTOL}")


def timed_calls(module, names, spent, device):
    """Wrap `module.<name>` for each name so that its host time, from a
    drained stream, adds to spent["ms"]; returns the originals."""
    import torch

    saved = {n: getattr(module, n) for n in names}

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
        setattr(module, n, timed(fn))
    return saved


def _run_steps(step, model, batch, steps, fa, device, coll_names):
    """`steps` counted steps (launches from 0), then one more with the
    collectives timed: (losses, step ms, launches, split of the timed step)."""
    import torch

    from kungfu_tpu_torch.ops import collective

    losses, step_ms = [], []
    fa.reset_launches()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(model, batch)))  # waits for the device
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(fa.LAUNCHES)
    spent = {"ms": 0.0}
    saved = timed_calls(collective, coll_names, spent, device)
    try:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        float(step(model, batch))
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for n, fn in saved.items():
            setattr(collective, n, fn)
    return losses, step_ms, launches, {"step_ms": total, "collectives_ms": spent["ms"],
                                       "rest_ms": total - spent["ms"]}


def _par_rank(rank: int, peers) -> dict:
    """One rank of the parallel phase: BERT-base through the pipeline
    (pp 2) and tensor parallelism (dp 1 x tp 2), then MoE over ep 2."""
    os.environ.update(KF_SELF_SPEC=peers[rank], KF_INIT_PEERS=",".join(peers),
                      KF_DEVICE_SLOTS="0")
    import numpy as np
    import torch

    from kungfu_tpu_torch.examples import bert_ssgd
    from kungfu_tpu_torch.models import convert
    from kungfu_tpu_torch.models import transformer as tr
    from kungfu_tpu_torch.ops import collective, moe
    from kungfu_tpu_torch.ops import flash_attention as fa
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
    from kungfu_tpu_torch.parallel.dp import make_train_step
    from kungfu_tpu_torch.parallel.mesh import make_mesh
    from kungfu_tpu_torch.parallel.pipeline import make_pp_transformer_loss, pipeline_sgd
    from kungfu_tpu_torch.parallel.sharded import make_sharded_train_step, shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    device = initialize_device_plane(backend="gloo")
    out = {"rank": rank, "device": str(device)}
    cfg = tr.TransformerConfig.bert_base()
    full = convert.to_jax(tr.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu"))
    _, tokens, _ = bert_ssgd.synthetic_batch(np.random.default_rng(1234), cfg, B, S + 1)
    tokens = torch.from_numpy(tokens).to(device)
    batch = (tokens[:, :-1], tokens[:, 1:])
    if rank == 0:  # the yardstick: the dense flash path, full batch, one process
        with torch.no_grad():
            dense = convert.transformer_from_jax(full, cfg, device)
            out["dense_first_loss"] = tr.transformer_loss(dense.tree(), batch, cfg,
                                                          core=bert_ssgd.flash_core).item()
            del dense

    def adamw(ps):
        return torch.optim.AdamW(ps, lr=3e-4, weight_decay=0.01)

    # (a) GPipe over pp 2: 6 layers a stage, 4 microbatches of 2
    session = make_mesh(device, shape={"pp": PAR_RANKS})
    stage = tr.Transformer(cfg, convert.pp_stage(full, session.axis_index("pp"),
                                                 PAR_RANKS)).to(device)
    opt = pipeline_sgd(adamw(list(stage.parameters())), stage, session)
    step = make_train_step(make_pp_transformer_loss(cfg, session, PP_MICRO,
                                                    core=bert_ssgd.flash_core), opt, session)
    session.barrier()
    torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms, launches, split = _run_steps(
        step, stage, batch, PP_STEPS, fa, device, ("rotate", "group_all_reduce", "all_reduce"))
    steady = sorted(step_ms[1:])
    out["pipeline"] = {"losses": losses, "step_ms": step_ms,
                       "steady_step_ms": steady[len(steady) // 2], "launches": launches,
                       "split": split,
                       "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 2**30}
    del stage, opt, step

    # (b) tensor parallelism over dp 1 x tp 2: 6 heads, 1536 hidden units and
    # 15261 vocabulary rows a rank
    session = make_mesh(device, shape={"dp": 1, "tp": PAR_RANKS})
    specs = tr.param_pspecs(cfg)
    whole = convert.tp_layout(convert.transformer_params_from_jax(full), PAR_RANKS)
    shards = tr.Transformer(cfg, shard_params(whole, session, specs)).to(device)

    def tp_loss(model, b):
        return tr.tp_transformer_loss(model.tree(), b, cfg, session, core=bert_ssgd.flash_core)

    step = make_sharded_train_step(tp_loss, adamw(list(shards.parameters())), session, specs)
    session.barrier()
    torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms, launches, split = _run_steps(
        step, shards, batch, TP_STEPS, fa, device, ("all_reduce", "group_all_reduce"))
    steady = sorted(step_ms[1:])
    out["tp"] = {"losses": losses, "step_ms": step_ms,
                 "steady_step_ms": steady[len(steady) // 2], "launches": launches,
                 "split": split, "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 2**30}
    del shards, step, whole, full

    # (c) top-2 MoE over ep 2 at BERT-base's FFN width, bf16, forward and
    # backward, against the plain MoE of every shard in one process. bf16
    # products keep f32 sums (no bf16 split-K partial sums), so the two
    # versions differ only where they round their bf16 activations
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    E = PAR_RANKS * MOE_EPD
    gen = torch.Generator(device=device).manual_seed(5)
    # tokens share a component, as activations do, so the router favours
    # some experts over others and the capacity drops tokens (independent
    # tokens load every expert within a few % of T / E: no drops)
    xs = (torch.randn(PAR_RANKS, MOE_T, MOE_D, device=device, generator=gen)
          + MOE_SHARED).bfloat16()
    rw = torch.randn(MOE_D, E, device=device, generator=gen) / MOE_D ** 0.5
    w_in = torch.randn(E, MOE_D, MOE_F, device=device, generator=gen) / MOE_D ** 0.5
    w_out = torch.randn(E, MOE_F, MOE_D, device=device, generator=gen) / MOE_F ** 0.5
    cot = torch.randn(PAR_RANKS, MOE_T, MOE_D, device=device, generator=gen)
    mine = slice(rank * MOE_EPD, (rank + 1) * MOE_EPD)

    def moe_step():
        leaves = [xs[rank].clone().requires_grad_(), rw.clone().requires_grad_(),
                  w_in[mine].clone().requires_grad_(), w_out[mine].clone().requires_grad_()]
        y, aux = moe.moe_ffn(*leaves, None, top_k=2, capacity_factor=MOE_CF)
        loss = (y.float() * cot[rank]).sum() + MOE_AUX_W * aux / PAR_RANKS
        return [y, aux, *torch.autograd.grad(loss, leaves)]

    got = moe_step()
    times, spent = [], {"ms": 0.0}
    for i in range(4):  # 3 steps, then one with the exchanges timed
        saved = {}
        if i == 3:
            saved = timed_calls(collective, ("_exchange", "all_reduce"), spent, device)
        try:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            moe_step()
            torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        finally:
            for n, fn in saved.items():
                setattr(collective, n, fn)
    router_grad = collective.all_reduce(got[3]).cpu()  # replicated: the sum of the ranks'
    parts = [collective.all_gather(t.detach().float().cpu(), axis=0, tiled=True)
             for t in (got[0], got[2], got[4], got[5])]
    out["moe"] = {"dropped": moe.dropped_tokens(xs[rank], rw, E, 2, MOE_CF),
                  "step_ms": times[:3], "timed_step": {"step_ms": times[3],
                                                       "collectives_ms": spent["ms"],
                                                       "rest_ms": times[3] - spent["ms"]},
                  "aux": got[1].item()}
    if rank == 0:
        leaves = [xs.clone().requires_grad_(), rw.clone().requires_grad_(),
                  w_in.clone().requires_grad_(), w_out.clone().requires_grad_()]
        y, aux = moe.moe_ffn_plain(*leaves, top_k=2, capacity_factor=MOE_CF)
        loss = (y.float() * cot).sum() + MOE_AUX_W * aux
        ref = [y, *torch.autograd.grad(loss, leaves)]
        names = ("out", "dx", "drouter", "dw_in", "dw_out")
        mine_all = [parts[0], parts[1], router_grad, parts[2], parts[3]]
        ref = [w.detach().cpu().reshape(g.shape) for g, w in zip(mine_all, ref)]
        # per element for what is per token (out, dx) and the f32 router
        # gradient; the bf16 expert gradients sum ~1300 products an element,
        # so where their terms cancel an element sits below the bf16 noise of
        # its terms: those are held within MOE_GRAD_TOL of the tensor's scale
        check_ = {n: compare(f"MoE {n} vs the plain MoE", g, w)
                  for n, g, w in zip(names[:3], mine_all[:3], ref[:3])}
        for n, g, w in zip(names[3:], mine_all[3:], ref[3:]):
            err, scale = (g - w).abs().max().item(), w.abs().max().item()
            check_[n] = {"max_abs_err": err, "scale": scale, "err_over_scale": err / scale,
                         "finite": bool(g.isfinite().all())}
            check(check_[n]["finite"] and err <= MOE_GRAD_TOL * scale,
                  f"MoE {n} vs the plain MoE: {check_[n]}")
        out["moe"]["check"] = check_
        out["moe"]["aux_plain"] = aux.item()
    return out


def par_worker(rank: int, peers) -> None:
    from kungfu_tpu_torch.parallel.distributed import shutdown_device_plane

    try:
        out = _par_rank(rank, peers)
        (PAR_OUT / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        shutdown_device_plane()


def parallel_phase(smi: str) -> dict:
    """BERT-base through the GPipe pipeline and tensor parallelism, and MoE
    at BERT-base's FFN width, on two gloo ranks sharing card 0; the parent
    checks what they wrote. Returns each kernel's launches a step per rank
    of the two transformer paths."""
    import torch

    from kungfu_tpu_torch.models.transformer import TransformerConfig
    from kungfu_tpu_torch.parallel.distributed import spawn_world

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    PAR_OUT.mkdir(parents=True, exist_ok=True)
    for f in PAR_OUT.glob("rank*.json"):
        f.unlink()
    spawn_world(par_worker, PAR_RANKS, PAR_DEADLINE_S)
    ranks = [json.loads((PAR_OUT / f"rank{r}.json").read_text()) for r in range(PAR_RANKS)]
    cfg = TransformerConfig.bert_base()
    r0 = ranks[0]
    dense = r0["dense_first_loss"]
    # launches a step per rank, from the design: the pipeline runs its
    # stage's L/P layers once for each of the M microbatches; a tp rank runs
    # every layer once, on its H/tp heads
    want = {"pipeline": PP_MICRO * cfg.n_layers // PAR_RANKS, "tp": cfg.n_layers}
    steps = {"pipeline": PP_STEPS, "tp": TP_STEPS}
    paths = {}
    for path in ("pipeline", "tp"):
        losses = r0[path]["losses"]
        paths[path] = {
            "first_loss": losses[0], "first_loss_rel_gap": abs(losses[0] - dense) / dense,
            "losses": losses,
            "per_rank": [{k: r[path][k] for k in ("launches", "step_ms", "steady_step_ms",
                                                  "split", "peak_mem_gb")} | {"rank": r["rank"]}
                         for r in ranks],
            "launches_per_step_per_rank": want[path]}
    moe_out = r0["moe"]
    emit("parallel", nvidia_smi=smi, config="bert-base", batch=B, seq=S,
         transport=f"gloo, {PAR_RANKS} ranks on card 0", dense_first_loss=dense,
         first_loss_rtol=PAR_LOSS_RTOL,
         pipeline={"pp": PAR_RANKS, "n_micro": PP_MICRO, "layers_per_stage":
                   cfg.n_layers // PAR_RANKS, "steps": PP_STEPS, **paths["pipeline"]},
         tp={"dp": 1, "tp": PAR_RANKS, "heads_per_rank": cfg.n_heads // PAR_RANKS,
             "steps": TP_STEPS, **paths["tp"]},
         moe={"ep": PAR_RANKS, "D": MOE_D, "F": MOE_F, "tokens_per_rank": MOE_T,
              "experts_per_rank": MOE_EPD, "top_k": 2, "capacity_factor": MOE_CF,
              "dtype": "bfloat16", "dropped_per_rank": [r["moe"]["dropped"] for r in ranks],
              "aux": moe_out["aux"], "aux_plain": moe_out["aux_plain"],
              "check": moe_out["check"], "rtol": RTOL, "atol": ATOL,
              "per_rank": [{"rank": r["rank"], "step_ms": r["moe"]["step_ms"],
                            "timed_step": r["moe"]["timed_step"]} for r in ranks]},
         seconds=time.perf_counter() - t0)
    for path in ("pipeline", "tp"):
        losses = r0[path]["losses"]
        check(all(math.isfinite(x) for x in losses), f"non-finite {path} loss: {losses}")
        check(losses[-1] < losses[0], f"{path} loss did not fall: {losses}")
        check(abs(losses[0] - dense) <= PAR_LOSS_RTOL * abs(dense),
              f"{path} first loss {losses[0]} vs dense flash loss {dense}")
        for r in ranks:
            check(r[path]["losses"] == losses, f"rank {r['rank']} saw other {path} losses")
            for name, n in r[path]["launches"].items():
                check(n == want[path] * steps[path],
                      f"{path} rank {r['rank']} launched {name} {n} times, want "
                      f"{want[path]} x {steps[path]} steps")
    check(abs(moe_out["aux"] - moe_out["aux_plain"]) <= ATOL + RTOL * abs(moe_out["aux_plain"]),
          f"MoE aux {moe_out['aux']} vs plain {moe_out['aux_plain']}")
    return {path: [r[path]["launches"] for r in ranks] for path in ("pipeline", "tp")}


def host_ops(plain: bool = False):
    """The host functions a replayed walk calls: the port's (its host C++)
    or, with `plain`, their plain PyTorch twins; buffers are torch tensors."""
    from types import SimpleNamespace

    import torch

    from kungfu_tpu_torch.base import ops

    twin = (lambda name: getattr(ops, f"{name}_plain")) if plain else (
        lambda name: getattr(ops, name))
    return SimpleNamespace(
        reduce_segment=twin("reduce_segment"), copy_segment=ops.copy_segment,
        transform_n=twin("transform_n"), encode=twin("encode_wire_any"),
        decode=twin("decode_wire_any"), decode_accumulate=twin("decode_accumulate_any"),
        empty=lambda count, dtype: torch.empty(count, dtype=getattr(torch, dtype)))


def _wire_layout(bounds, wire):
    """(dtype, offsets) of a walk's wire buffer: the encoded segments one
    after the other, 2-byte elements for the 16-bit wires, bytes (scales
    and packed payload, blocks relative to each segment) for a QWire, the
    port's or the JAX package's."""
    from kungfu_tpu_torch.base.ops import wire_nbytes_q

    q = hasattr(wire, "bits")
    offs = [0]
    for b, e in bounds:
        offs.append(offs[-1] + (wire_nbytes_q(e - b, wire.bits, wire.block) if q else e - b))
    return ("uint8" if q else "uint16"), offs


def ring_replay(bufs, ops, wire=None, order=None, weights=None) -> list:
    """The segmented ring all-reduce (SUM) of `bufs`, k one-dimensional f32
    buffers, one a simulated peer's (by rank), replayed in one process as the
    host engine's walk moves segments between peers: k - 1 reduce-scatter
    steps (reduce_segment, or with a wire: the sender encodes its partial,
    the receiver decode-accumulates it), then k - 1 all-gather steps
    (copy_segment; with a wire, each owner encodes its reduced segment once,
    the encodings are relayed as they are, and every peer, owner included,
    decodes every segment at the end). `order` (ranks in ring order) and
    `weights` (per-segment) replay an adopted measured-topology plan: each
    position sends to the next position's rank, over the weighted segment
    bounds. Each buffer ends holding the sum; returns `bufs`. `ops` is
    `host_ops()`'s namespace, or the tests' for the JAX package."""
    from kungfu_tpu_torch.base.ops import ReduceOp
    from kungfu_tpu_torch.plan.topology import gen_segmented_schedule, segment_bounds

    k, n = len(bufs), len(bufs[0])
    order = list(range(k)) if order is None else list(order)
    bounds = segment_bounds(n, k, weights)
    scheds = [gen_segmented_schedule(order, p) for p in range(k)]
    at = [bufs[r] for r in order]  # the buffer at each ring position
    if wire is not None:
        dtype, offs = _wire_layout(bounds, wire)
        wbufs = [ops.empty(offs[-1], dtype) for _ in range(k)]
    for s in range(k - 1):
        for i in range(k):
            (seg, _), dst = scheds[i].rs_steps[s], (i + 1) % k
            b, e = bounds[seg]
            if e == b:
                continue
            if wire is None:
                ops.reduce_segment(at[dst], b, e, at[i][b:e], ReduceOp.SUM)
            else:
                msg = wbufs[i][offs[seg]:offs[seg + 1]]
                ops.encode(msg, at[i][b:e], wire)
                ops.decode_accumulate(at[dst], b, e, msg, wire, ReduceOp.SUM)
    if wire is not None:
        for i in range(k):
            seg = scheds[i].owned_segment
            b, e = bounds[seg]
            if e > b:
                ops.encode(wbufs[i][offs[seg]:offs[seg + 1]], at[i][b:e], wire)
    src = at if wire is None else wbufs
    lim = bounds if wire is None else list(zip(offs, offs[1:]))
    for s in range(k - 1):
        for i in range(k):
            seg = scheds[i].ag_steps[s][0]
            b, e = lim[seg]
            if e > b:
                ops.copy_segment(src[(i + 1) % k], b, e, src[i][b:e])
    if wire is not None:
        for i in range(k):
            for seg, (b, e) in enumerate(bounds):
                if e > b:
                    ops.decode(at[i][b:e], wbufs[i][offs[seg]:offs[seg + 1]], wire)
    return bufs


def hier_replay(bufs, ops, groups, heads, demoted=()) -> list:
    """The two-level all-reduce (SUM, f32) of an adopted HierPlan over
    `bufs` (one by rank), replayed in one process as the host engine's
    `_run_hier` walks it: each head adds its group's contributing members'
    buffers (a host star reduce; with one member, the order of an IEEE sum
    of two cannot matter), the heads run the segmented ring in their
    listed order, and each head's result is copied to every member of its
    group, demoted ranks included. Returns `bufs`."""
    from kungfu_tpu_torch.base.ops import ReduceOp

    n = len(bufs[0])
    for head, grp in zip(heads, groups):
        members = [r for r in grp if r != head and r not in demoted]
        if len(members) > 1:
            raise ValueError("a star reduce of several members sums in arrival order")
        for r in members:
            ops.reduce_segment(bufs[head], 0, n, bufs[r], ReduceOp.SUM)
    ring_replay([bufs[h] for h in heads], ops)
    for head, grp in zip(heads, groups):
        for r in grp:
            if r != head:
                ops.copy_segment(bufs[r], 0, n, bufs[head])
    return bufs


def graph_replay(sends, pair, ops) -> list:
    """The graph walk of one strategy pair (SUM, f32 or any dtype), replayed
    in one process as the host engine runs it, reduce graph then broadcast
    graph, nodes in topological order: a node of the reduce graph with
    predecessors reduces its own send and what they pass on, in their order,
    in one n-ary pass (transform_n); a node of the broadcast graph copies
    its predecessor's value, a root keeps its own. Returns each peer's
    result."""
    from kungfu_tpu_torch.base.ops import ReduceOp

    k, n = len(sends), len(sends[0])
    dtype = str(sends[0].dtype).split(".")[-1]
    recvs = [None] * k

    def value(i):
        return sends[i] if recvs[i] is None else recvs[i]

    for g in (pair.reduce_graph, pair.bcast_graph):
        indeg = [len(g.prevs(i)) for i in range(k)]
        ready = [i for i in range(k) if indeg[i] == 0]
        while ready:
            i = ready.pop(0)
            prevs = g.prevs(i)
            if prevs:
                out = ops.empty(n, dtype)
                if g.is_self_loop(i):
                    ops.transform_n(out, [value(i)] + [value(p) for p in prevs], ReduceOp.SUM)
                else:
                    ops.copy_segment(out, 0, n, value(prevs[0]))
                recvs[i] = out
            for j in g.nexts(i):
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
    return [value(i) for i in range(k)]


def _median_s(fn, turns: int = HOST_TURNS) -> float:
    times = []
    for _ in range(turns):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def _host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it: its model name, with the
    vendor, family and model beside it where the name reads "unknown"."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    name = info.get("model name", "unknown")
    if name == "unknown":
        name += (f" ({info.get('vendor_id', '?')} family {info.get('cpu family', '?')} "
                 f"model {info.get('model', '?')})")
    return name


def hostplane_phase(smi: str) -> dict:
    """The host plane's core on 4 real ResNet-50 gradient sets: pinned
    staging through the port's BufferPool, the ring (f32, bf16, int8) and
    the default strategy's graph pair replayed through the host C++, each
    held bitwise against its plain replay and against the card's sum; the
    host functions' throughput; the MST and a ring plan of an 8 x 8 matrix.
    One process, so nothing here moves between peers: the `hostnet` phase
    runs the same all-reduces between processes, over the transport."""
    import numpy as np
    import torch

    from kungfu_tpu_torch.base import _native
    from kungfu_tpu_torch.base import ops as hops
    from kungfu_tpu_torch.base.dtype import DType
    from kungfu_tpu_torch.base.strategy import DEFAULT_STRATEGY
    from kungfu_tpu_torch.collective.strategies import gen_global_strategies
    from kungfu_tpu_torch.models.resnet import resnet_loss
    from kungfu_tpu_torch.ops import _build
    from kungfu_tpu_torch.plan.mst import minimum_spanning_tree
    from kungfu_tpu_torch.plan.peer import PeerID, PeerList
    from kungfu_tpu_torch.plan.replan import derive_plan
    from kungfu_tpu_torch.utils.pool import BufferPool

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib_path = _build.compile_host_library()
    _native.lib()
    build_s = time.perf_counter() - t0
    device = torch.device("cuda", 0)
    k = HOST_PEERS
    torch.cuda.empty_cache()
    model = _resnet50_seed0(device)
    params = list(model.parameters())
    gen = torch.Generator(device=device).manual_seed(300)
    grads = []
    for _ in range(k):
        images = torch.randn(OPT_BATCH, OPT_SIDE, OPT_SIDE, 3, device=device,
                             dtype=torch.bfloat16, generator=gen)
        labels = torch.randint(0, 1000, (OPT_BATCH,), device=device, generator=gen)
        model.zero_grad(set_to_none=True)
        resnet_loss(model, (images, labels)).backward()
        grads.append(torch.cat([p.grad.reshape(-1).float() for p in params]))
    del model, params
    n = grads[0].numel()
    nbytes = 4 * n
    check(all(bool(g.isfinite().all()) for g in grads), "non-finite ResNet-50 gradients")

    pool = BufferPool(pin_memory=True)
    hosts = [pool.get(nbytes).view(torch.float32) for _ in range(k)]
    work = [pool.get(nbytes).view(torch.float32) for _ in range(k)]
    check(all(h.is_pinned() for h in hosts + work), "the BufferPool's buffers are not pinned")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g, h in zip(grads, hosts):
        h.copy_(g, non_blocking=True)
    torch.cuda.synchronize()  # the C++ reads these buffers next
    d2h_s = time.perf_counter() - t0
    card_sum = torch.stack(grads).sum(0)
    abs_sum = torch.stack(grads).abs().sum(0, dtype=torch.float64)
    sum_max = card_sum.abs().max().item()
    f32_bound = 2 * (k - 1) * HOST_F32_ULP * abs_sum + HOST_F32_FLOOR

    def same_bits(a, b) -> bool:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    port, plain = host_ops(), host_ops(plain=True)
    walks = {}
    _native.reset_calls()

    def run(name, replay):
        """One walk through the host C++ on the pinned `work` buffers, and
        its plain replay on copies; returns peer 0's result on the card."""
        for w, h in zip(work, hosts):
            w.copy_(h)
        t0 = time.perf_counter()
        out = replay(work, port)
        ms = (time.perf_counter() - t0) * 1e3
        twin = [h.clone() for h in hosts]
        t0 = time.perf_counter()
        out_plain = replay(twin, plain)
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(all(same_bits(a, b) for a, b in zip(out, out_plain)),
              f"host walk {name} differs from its plain replay")
        check(all(same_bits(out[0], o) for o in out[1:]),
              f"host walk {name} left the peers with different results")
        walks[name] = {"ms": ms, "plain_ms": plain_ms}
        return out[0].to(device, copy=True)

    peers = PeerList(PeerID("127.0.0.1", 38000 + r) for r in range(k))
    (pair,) = gen_global_strategies(peers, DEFAULT_STRATEGY)
    results = {
        "ring_f32": run("ring_f32", lambda bufs, ops: ring_replay(bufs, ops)),
        "ring_bf16": run("ring_bf16", lambda bufs, ops: ring_replay(bufs, ops, DType.BF16)),
        "ring_int8": run("ring_int8",
                         lambda bufs, ops: ring_replay(bufs, ops, hops.QWire(*HOST_QWIRE))),
        "tree_f32": run("tree_f32", lambda bufs, ops: graph_replay(bufs, pair, ops)),
    }
    t0 = time.perf_counter()
    for w, g in zip(work, grads):
        g.copy_(w, non_blocking=True)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    calls = dict(_native.CALLS)
    errs = {}
    for name, got in results.items():
        err = (got.double() - card_sum.double()).abs()
        if name in ("ring_f32", "tree_f32"):
            ratio = (err / f32_bound).max().item()
        else:
            ratio = err.max().item() / (2 * sum_max * HOST_WIRE_EPS[name.split("_")[1]])
        errs[name] = {"max_abs_err_vs_card": err.max().item(), "worst_tol_ratio": ratio}
        check(bool(got.isfinite().all()) and ratio <= 1.0,
              f"host walk {name} vs the card's sum: {errs[name]}")
    tree_ring = (results["tree_f32"].double() - results["ring_f32"].double()).abs()
    errs["tree_vs_ring"] = {"max_abs_err": tree_ring.max().item(),
                            "worst_tol_ratio": (tree_ring / f32_bound).max().item()}
    check(errs["tree_vs_ring"]["worst_tol_ratio"] <= 1.0,
          f"the tree's f32 sum vs the ring's: {errs['tree_vs_ring']}")
    for fn in ("transform2", "transform_n", "encode_wire", "decode_wire", "decode_accumulate",
               "encode_wire_q", "decode_wire_q", "decode_accumulate_q"):
        check(calls[fn] > 0, f"the host walks never called the C++ {fn}")

    # throughput of each host function on the 102 MB buffers: bytes each
    # must move (inputs read once, output written once) over the median time
    a, b, dst = hosts[0], hosts[1], work[0]
    rates = {
        "transform2": 3 * nbytes / _median_s(lambda: hops.transform2(dst, a, b, hops.ReduceOp.SUM)),
        "transform_n_k4": (k + 1) * nbytes / _median_s(
            lambda: hops.transform_n(dst, hosts, hops.ReduceOp.SUM)),
    }
    block = HOST_QWIRE[1]
    for label, wire in (("bf16", DType.BF16), ("f16", DType.F16),
                        ("int8", hops.QWire(8, block)), ("int4", hops.QWire(4, block))):
        wn = hops.wire_nbytes(n, wire)
        enc = pool.get(wn) if isinstance(wire, hops.QWire) else pool.get(wn).view(torch.uint16)
        rates[f"encode_{label}"] = (nbytes + wn) / _median_s(
            lambda: hops.encode_wire_any(enc, a, wire))
        rates[f"decode_{label}"] = (nbytes + wn) / _median_s(
            lambda: hops.decode_wire_any(dst, enc, wire))
        rates[f"decode_accumulate_{label}"] = (2 * nbytes + wn) / _median_s(
            lambda: hops.decode_accumulate_any(dst, 0, n, enc, wire, hops.ReduceOp.SUM))
    rates = {key: v / 1e9 for key, v in rates.items()}

    # the planning math on a seeded 8 x 8 bandwidth matrix
    rng = np.random.default_rng(8)
    bw = rng.uniform(1.0, 10.0, (8, 8))
    bw[2, 5] = bw[5, 2] = 0.2  # one slow link
    np.fill_diagonal(bw, 0.0)
    t0 = time.perf_counter()
    father = minimum_spanning_tree(1.0 / (bw + np.eye(8)))
    mst_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plan = derive_plan(bw, "auto")
    plan_ms = (time.perf_counter() - t0) * 1e3
    again = derive_plan(bw.copy(), "auto")
    check(plan is not None and again.digest() == plan.digest(),
          "two derivations of one ring plan gave different digests")

    out = {"nvidia_smi": smi, "host_cpu": _host_cpu(), "host_cores": os.cpu_count(),
           "peers": k, "values_per_peer": n, "bytes_per_peer": nbytes,
           "images_per_peer": OPT_BATCH, "library": str(lib_path), "build_s": build_s,
           "d2h_gb_per_s": k * nbytes / d2h_s / 1e9, "h2d_gb_per_s": k * nbytes / h2d_s / 1e9,
           "walks": walks, "checks": errs,
           "sum_max_abs": sum_max, "library_calls": calls, "gb_per_s": rates,
           "mst": {"father": father, "ms": mst_ms},
           "plan": {"order": list(plan.order), "weights": plan.weights, "gain": plan.gain,
                    "digest": plan.digest().hex(), "ms": plan_ms},
           "seconds": time.perf_counter() - t_phase}
    emit("hostplane", **out)
    return out


HOSTNET_RANKS = 4
HOSTNET_DEADLINE_S = 400
HOSTNET_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_host"
HOSTNET_MSG_TURNS = 3
# mode -> (KF_CONFIG_ALGO, KF_CONFIG_WIRE) of its fresh session, and the
# in-process replay its first call must equal bitwise
HOSTNET_MODES = {
    "ring_f32": ("segmented", "off"),
    "ring_bf16": ("segmented", "bf16"),
    "ring_int8": ("segmented", "int8"),
    "tree_f32": ("", "off"),  # DEFAULT_STRATEGY: BINARY_TREE_STAR, a star on one host
}


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().view(-1).numpy().tobytes()).hexdigest()


def _worker_env(rank: int, specs, **knobs) -> None:
    """This process's environment as kfrun's worker `rank` of `specs` on
    card 0, with the engine `knobs` and no others."""
    from kungfu_tpu_torch.plan.peer import PeerList
    from kungfu_tpu_torch.runner.env import worker_env

    peers = PeerList.parse(",".join(specs))
    os.environ.update(worker_env(peers[rank], peers, PeerList(), None, device_slots=[0]))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    for knob in ("KF_CONFIG_ALGO", "KF_CONFIG_WIRE", "KF_CONFIG_SHM", "KF_CONFIG_ASYNC",
                 "KF_CONFIG_ZERO", "KF_CONFIG_SEGMENT_MIN_BYTES",
                 "KF_CONFIG_GROUP_BUCKET_BYTES", "KF_CONFIG_ENABLE_MONITORING",
                 "KF_TRACE_BUFFER"):
        os.environ.pop(knob, None)
    for knob in [k for k in os.environ if k.startswith("KF_TELEMETRY")]:
        os.environ.pop(knob)
    os.environ.update({k: str(v) for k, v in knobs.items()})


def _hostnet_rank(rank: int, specs) -> dict:
    """One worker of the hostnet phase: a Peer from kfrun's environment,
    its ResNet-50 gradient, the host all-reduce in each mode over the
    transport, one SGD step on the result, one 102 MB message."""
    from kungfu_tpu_torch.plan.peer import PeerList

    _worker_env(rank, specs)
    peers = PeerList.parse(",".join(specs))
    import torch

    from kungfu_tpu_torch import api, resolve_device
    from kungfu_tpu_torch.base.ops import ReduceOp
    from kungfu_tpu_torch.base.strategy import DEFAULT_STRATEGY
    from kungfu_tpu_torch.base.workspace import Workspace
    from kungfu_tpu_torch.collective.host_session import HostSession
    from kungfu_tpu_torch.collective.profiler import get_walk_profiler
    from kungfu_tpu_torch.models.resnet import resnet_loss
    from kungfu_tpu_torch.peer import get_default_peer
    from kungfu_tpu_torch.transport.message import ConnType
    from kungfu_tpu_torch.utils.pool import BufferPool

    _deterministic()
    peer = get_default_peer()
    k = peer.size
    device = resolve_device()
    model = _resnet50_seed0(device)
    params = list(model.parameters())
    gen = torch.Generator(device=device).manual_seed(400 + rank)
    images = torch.randn(OPT_BATCH, OPT_SIDE, OPT_SIDE, 3, device=device, dtype=torch.bfloat16,
                         generator=gen)
    labels = torch.randint(0, 1000, (OPT_BATCH,), device=device, generator=gen)
    resnet_loss(model, (images, labels)).backward()
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    torch.save(flat.cpu(), HOSTNET_OUT / f"grad{rank}.pt")
    n = flat.numel()
    pool = BufferPool(pin_memory=True)
    host = pool.get(4 * n).view(torch.float32)
    host.copy_(flat, non_blocking=True)
    torch.cuda.synchronize()  # the host walks read the buffer next
    base = peer.current_session()
    out = {"rank": rank, "values": n, "modes": {}}

    def timed(call, name, sess):
        """The first call's result digest and the payload bytes this peer
        sent in it, then the median ms of HOST_TURNS more calls, each
        after a barrier, and the walk profiler's split of their time."""
        frames0 = dict(peer.client.frames)
        sent0 = dict(sess.wire_bytes)
        first = call()
        wire_bytes = {"/".join(key): v - sent0.get(key, 0) for key, v in sess.wire_bytes.items()
                      if v != sent0.get(key, 0)}
        digest = _digest(first)
        agreed = base.bytes_consensus(digest.encode(), f"hostnet:{name}:digest")
        times = []
        walks = 0.0
        for _ in range(HOST_TURNS):
            base.barrier(f":{name}")
            get_walk_profiler().reset()
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e3)
            walks = get_walk_profiler().snapshot()  # the last call's walks
        frames = {key: peer.client.frames[key] - frames0[key] for key in frames0}
        split = {key: {f: w[f] for f in ("walks", "wall_s", "wait_frac", "send_frac",
                                         "compute_frac")} for key, w in walks.items()}
        return {"digest": digest, "agreed": agreed, "ms": sorted(times)[len(times) // 2],
                "all_ms": times, "frames": frames, "wire_bytes": wire_bytes,
                "walk_split": split}

    for mode, (algo, wire) in HOSTNET_MODES.items():
        os.environ["KF_CONFIG_ALGO"], os.environ["KF_CONFIG_WIRE"] = algo, wire
        sess = HostSession(DEFAULT_STRATEGY, peer.self_id, peer.config.peers, peer.client,
                           peer.collective)
        sess.check_knob_consensus()
        res = pool.get(4 * n).view(torch.float32)

        def call(sess=sess, res=res, mode=mode):
            sess.all_reduce(Workspace(host, res, ReduceOp.SUM, f"hostnet:{mode}"))
            return res

        out["modes"][mode] = timed(call, mode, sess)
        out["modes"][mode]["strategy"] = sess.active_candidate_name()
    os.environ.pop("KF_CONFIG_ALGO")
    os.environ.pop("KF_CONFIG_WIRE")

    reduced = None

    def group_call():
        nonlocal reduced
        reduced = api.group_all_reduce_arrays(grads, name="hostnet:group")
        return torch.cat([g.reshape(-1) for g in reduced])

    out["modes"]["group"] = timed(group_call, "group", base)
    out["modes"]["group"]["tensors"] = len(grads)
    out["modes"]["group"]["strategy"] = base.active_candidate_name()
    # one SGD step on the card from the all-reduced gradients' mean
    for p, g in zip(params, reduced):
        p.grad = g / k
    torch.optim.SGD(params, lr=0.1).step()
    param_digest = _digest(torch.cat([p.detach().reshape(-1) for p in params]))
    out["param_digest"] = param_digest
    out["params_agreed"] = base.bytes_consensus(param_digest.encode(), "hostnet:params")

    # one 102 MB message rank 0 -> 1 and a 1-byte reply, shm on and off
    msg = host.view(torch.uint8)
    out["message_ms"] = {}
    for shm in ("on", "off"):
        os.environ["KF_CONFIG_SHM"] = "1" if shm == "on" else "0"
        times = []
        for i in range(HOSTNET_MSG_TURNS):
            base.barrier(f":msg:{shm}:{i}")
            name = f"hostnet:msg:{shm}:{i}"
            if rank == 0:
                t0 = time.perf_counter()
                peer.client.send(peers[1], name, msg, ConnType.COLLECTIVE)
                peer.collective.recv(peers[1], name + ":ack", 60)
                times.append((time.perf_counter() - t0) * 1e3)
            elif rank == 1:
                got = pool.get(msg.nbytes)
                m, filled = peer.collective.recv_into(peers[0], name, got, 60)
                if not filled:
                    got.copy_(torch.frombuffer(m.data, dtype=torch.uint8, count=msg.nbytes))
                    if m.release is not None:
                        m.release()
                if i == 0:  # rank 0's gradient, saved before the modes ran
                    sent = torch.load(HOSTNET_OUT / "grad0.pt").view(torch.uint8)
                    out[f"message_intact_{shm}"] = _digest(got) == _digest(sent)
                pool.put(got)
                peer.client.send(peers[0], name + ":ack", b"\x01", ConnType.COLLECTIVE)
        out["message_ms"][shm] = times
    os.environ.pop("KF_CONFIG_SHM")
    out["message_bytes"] = msg.nbytes
    base.barrier(":end")
    return out


def hostnet_worker(rank: int, _spawned, specs) -> None:
    try:
        out = _hostnet_rank(rank, specs)
        (HOSTNET_OUT / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        from kungfu_tpu_torch.peer import finalize_default_peer

        finalize_default_peer()


def hostnet_phase(smi: str, replay: dict) -> dict:
    """The host all-reduce between processes: 4 workers on card 0, each a
    Peer started from kfrun's environment, all-reduce their ResNet-50
    gradients over the port's transport and engine (segmented ring in f32,
    bf16 and int8, the default strategy, and api.group_all_reduce_arrays);
    the parent holds each mode's first call bitwise against the in-process
    replay of the saved inputs and the sums against the card's. `replay` is
    the hostplane phase's walk times, the budget beside each mode's."""
    import numpy as np
    import torch

    from kungfu_tpu_torch import resolve_device
    from kungfu_tpu_torch.base import ops as hops
    from kungfu_tpu_torch.base.dtype import DType
    from kungfu_tpu_torch.base.strategy import DEFAULT_STRATEGY
    from kungfu_tpu_torch.collective.strategies import gen_global_strategies
    from kungfu_tpu_torch.parallel.distributed import spawn_world
    from kungfu_tpu_torch.plan.peer import PeerList
    from kungfu_tpu_torch.runner.cli import free_ports

    t_phase = time.perf_counter()
    k = HOSTNET_RANKS
    HOSTNET_OUT.mkdir(parents=True, exist_ok=True)
    for f in list(HOSTNET_OUT.glob("*.json")) + list(HOSTNET_OUT.glob("*.pt")):
        f.unlink()
    specs = [f"127.0.0.1:{p}" for p in free_ports(k)]
    shm_stat = os.statvfs("/dev/shm") if os.path.isdir("/dev/shm") else None
    spawn_world(hostnet_worker, k, HOSTNET_DEADLINE_S, args=(specs,))
    ranks = [json.loads((HOSTNET_OUT / f"rank{r}.json").read_text()) for r in range(k)]
    xs = [torch.load(HOSTNET_OUT / f"grad{r}.pt") for r in range(k)]
    n = xs[0].numel()
    nbytes = 4 * n

    # the replays of the saved inputs, through the host C++
    (pair,) = gen_global_strategies(PeerList.parse(",".join(specs)), DEFAULT_STRATEGY)
    wires = {"ring_f32": None, "ring_bf16": DType.BF16, "ring_int8": hops.QWire(*HOST_QWIRE)}
    want = {}
    for mode, wire in wires.items():
        want[mode] = ring_replay([x.clone() for x in xs], host_ops(), wire)[0]
    want["tree_f32"] = graph_replay(xs, pair, host_ops())[0]
    want["group"] = want["tree_f32"]
    device = resolve_device()
    card = torch.stack([x.to(device) for x in xs])
    card_sum = card.sum(0)
    abs_sum = card.abs().sum(0, dtype=torch.float64)
    del card
    sum_max = card_sum.abs().max().item()
    f32_bound = 2 * (k - 1) * HOST_F32_ULP * abs_sum + HOST_F32_FLOOR
    modes, checks = {}, {}
    for mode, ref in want.items():
        digests = [r["modes"][mode]["digest"] for r in ranks]
        check(all(r["modes"][mode]["agreed"] for r in ranks) and len(set(digests)) == 1,
              f"hostnet {mode}: the ranks hold different bits")
        check(digests[0] == _digest(ref),
              f"hostnet {mode}: the first call differs from its in-process replay")
        err = (ref.to(device).double() - card_sum.double()).abs()
        if mode.endswith("f32") or mode == "group":
            ratio = (err / f32_bound).max().item()
        else:
            ratio = err.max().item() / (2 * sum_max * HOST_WIRE_EPS[mode.split("_")[1]])
        checks[mode] = {"max_abs_err_vs_card": err.max().item(), "worst_tol_ratio": ratio}
        check(bool(ref.isfinite().all()) and ratio <= 1.0,
              f"hostnet {mode} vs the card's sum: {checks[mode]}")
        per_rank = [r["modes"][mode] for r in ranks]
        modes[mode] = {
            "median_ms_per_rank": [m["ms"] for m in per_rank],
            "median_ms": max(m["ms"] for m in per_rank),
            "replay_ms": replay.get(mode, {}).get("ms"),
            "strategy": per_rank[0]["strategy"],
            "wire_bytes_per_rank": [m["wire_bytes"] for m in per_rank],
            "frames_per_rank": [m["frames"] for m in per_rank],
            # the last call's walks: seconds blocked on receives (wait),
            # on sends (send), and the rest (reduce, codec, copies)
            "walk_split_per_rank": [m["walk_split"] for m in per_rank],
        }
    # the ring sends 2 (k - 1) / k of its wire payload: N f32 bytes, or encoded
    for mode, wire in wires.items():
        wire_n = nbytes if wire is None else hops.wire_nbytes(n, wire)
        modes[mode]["optimal_wire_bytes_per_rank"] = 2 * (k - 1) / k * wire_n
    check(all(r["params_agreed"] for r in ranks)
          and len({r["param_digest"] for r in ranks}) == 1,
          "hostnet: the ranks' parameters differ after the SGD step")
    check(ranks[1].get("message_intact_on") and ranks[1].get("message_intact_off"),
          "hostnet: the 102 MB message arrived changed")
    msg = {shm: {"ms": ranks[0]["message_ms"][shm],
                 "gb_per_s": ranks[0]["message_bytes"] / (sorted(ranks[0]["message_ms"][shm])[
                     HOSTNET_MSG_TURNS // 2] / 1e3) / 1e9}
           for shm in ("on", "off")}
    out = {"nvidia_smi": smi, "host_cpu": _host_cpu(), "host_cores": os.cpu_count(),
           "ranks": k, "values_per_rank": n, "bytes_per_rank": nbytes,
           "images_per_rank": OPT_BATCH, "peers": specs, "modes": modes, "checks": checks,
           "sum_max_abs": sum_max, "message_rank0_to_1": msg,
           "dev_shm_bytes": (shm_stat.f_blocks * shm_stat.f_frsize) if shm_stat else None,
           "dev_shm_free_bytes": (shm_stat.f_bavail * shm_stat.f_frsize) if shm_stat else None,
           "seconds": time.perf_counter() - t_phase}
    emit("hostnet", **out)
    return out


SMA_RANKS = 4
SMA_STEPS = 4
SMA_DEADLINE_S = 600
SMA_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_sma"
ASYNC_RANKS = 4
ASYNC_STEPS = 3
ASYNC_LR = 0.1
ASYNC_DEADLINE_S = 600
ASYNC_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_async"
# the async phase's runs: (path, KF_CONFIG_GROUP_BUCKET_BYTES). A cap of
# one byte gives every tensor a bucket of its own, in any registration
# order, so the hook path (autograd's order), the step-end path and ZeRO
# (parameter order) walk the same segments and must agree bit for bit; the
# last run times the hooks at the default cap
ASYNC_RUNS = (("hooks", 1), ("step_end", 1), ("zero", 1), ("hooks_default_cap", 64 << 20))


def _sma_rank(rank: int, specs) -> dict:
    """One worker of the sma phase: `examples/bert_sma.main` at BERT-base
    width; after step 0 (and the last) the blend's saved inputs are held
    against the blend formula, and step 0's sums are digested."""
    _worker_env(rank, specs)
    import hashlib

    import numpy as np
    import torch

    from kungfu_tpu_torch.examples import bert_sma, bert_ssgd
    from kungfu_tpu_torch.ops import flash_attention as fa
    from kungfu_tpu_torch.peer import get_default_peer

    out = {"rank": rank, "blend_exact": {}}

    def plain_core(q, k, v):
        return fa.flash_attention_plain(q, k, v, causal=True)

    def on_start(tr):
        if rank == 0:  # the first loss again, kernel core vs plain core
            inputs, targets, mask = tr.batch
            with torch.no_grad():
                tree = tr.model.tree()
                out["kernel_core_loss"] = bert_ssgd.mlm_loss(
                    tree, inputs, targets, mask, tr.cfg, core=bert_ssgd.flash_core).item()
                out["plain_core_loss"] = bert_ssgd.mlm_loss(
                    tree, inputs, targets, mask, tr.cfg, core=plain_core).item()
        fa.reset_launches()  # the counts of the main path's run alone

    def on_step(tr, step, rec):
        if step == 0:
            h = hashlib.sha256()
            for s in tr.sums:
                h.update(s.numpy().data)
            out["sum_digest"] = h.hexdigest()
            sess = get_default_peer().current_session()
            out["sum_agreed"] = sess.bytes_consensus(out["sum_digest"].encode(), "sma:sums")
            torch.save(tr.host_leaves[0].clone(), SMA_OUT / f"embed_in{rank}.pt")
            torch.save(tr.sums[0].clone(), SMA_OUT / f"embed_sum{rank}.pt")
        if step in (0, SMA_STEPS - 1):
            # examples/bert_sma.py:121 in numpy on the saved inputs
            n, exact = tr.n, True
            for leaf, h, s in zip(tr.leaves, tr.host_leaves, tr.sums):
                l, sv = h.numpy(), s.numpy()
                want = l + SMA_ALPHA * (sv / n - l)
                exact &= leaf.detach().reshape(-1).cpu().numpy().tobytes() == want.tobytes()
            out["blend_exact"][step] = exact

    argv = ["--config", "bert-base", "--batch", str(B), "--seq", str(S), "--steps",
            str(SMA_STEPS), "--alpha", str(SMA_ALPHA), "--fixed-batch", "--device", "cuda"]
    res = bert_sma.main(argv, on_start=on_start, on_step=on_step)
    out["launches"] = dict(fa.LAUNCHES)
    out.update(res)
    sess = get_default_peer().current_session()
    out["wire_bytes"] = {"/".join(key): v for key, v in sess.wire_bytes.items()}
    out["leaf_values"] = [l.numel() for l in bert_sma.leaves_of(
        bert_sma.make_model(bert_sma.config("bert-base"), 0, "cpu"))]
    sess.barrier(":sma:end")
    return out


def sma_worker(rank: int, _spawned, specs) -> None:
    try:
        out = _sma_rank(rank, specs)  # sets the engine knobs before the engine's import
        (SMA_OUT / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        from kungfu_tpu_torch.peer import finalize_default_peer

        finalize_default_peer()


def sma_phase(smi: str) -> list:
    """BASELINE config 3 at full width: 4 workers on card 0, each a Peer
    from kfrun's environment, run `examples/bert_sma.main` (BERT-base, 8 x
    512 fixed masked-LM batch a rank, AdamW, then the SMA blend over the
    host plane) for 6 steps. Returns each rank's flash launches."""
    import torch

    from kungfu_tpu_torch.base.strategy import DEFAULT_STRATEGY
    from kungfu_tpu_torch.collective.strategies import gen_global_strategies
    from kungfu_tpu_torch.models.transformer import TransformerConfig
    from kungfu_tpu_torch.parallel.distributed import spawn_world
    from kungfu_tpu_torch.plan.peer import PeerList
    from kungfu_tpu_torch.runner.cli import free_ports

    t_phase = time.perf_counter()
    k = SMA_RANKS
    SMA_OUT.mkdir(parents=True, exist_ok=True)
    for f in list(SMA_OUT.glob("*.json")) + list(SMA_OUT.glob("*.pt")):
        f.unlink()
    specs = [f"127.0.0.1:{p}" for p in free_ports(k)]
    spawn_world(sma_worker, k, SMA_DEADLINE_S, args=(specs,))
    ranks = [json.loads((SMA_OUT / f"rank{r}.json").read_text()) for r in range(k)]
    cfg = TransformerConfig.bert_base()
    for r in ranks:
        losses = r["losses"]
        check(len(losses) == SMA_STEPS and all(math.isfinite(x) for x in losses),
              f"sma rank {r['rank']}: losses {losses}")
        check(sum(losses[-3:]) / 3 < losses[0], f"sma rank {r['rank']}: loss did not fall "
              f"{losses}")
        for name, n in r["launches"].items():
            check(n == cfg.n_layers * SMA_STEPS,
                  f"sma rank {r['rank']}: {name} launched {n} times, want "
                  f"{cfg.n_layers} x {SMA_STEPS}")
        check(all(r["blend_exact"].values()) and len(r["blend_exact"]) == 2,
              f"sma rank {r['rank']}: the blended parameters differ from the formula "
              f"{r['blend_exact']}")
    check(all(r["sum_agreed"] for r in ranks) and len({r["sum_digest"] for r in ranks}) == 1,
          "sma: step 0's sums differ across ranks")
    # the embedding leaf's sum, replayed in one process from the saved inputs
    (pair,) = gen_global_strategies(PeerList.parse(",".join(specs)), DEFAULT_STRATEGY)
    xs = [torch.load(SMA_OUT / f"embed_in{r}.pt") for r in range(k)]
    replay = graph_replay(xs, pair, host_ops())
    for r in range(k):
        got = torch.load(SMA_OUT / f"embed_sum{r}.pt")
        check(_digest(got) == _digest(replay[r]),
              f"sma rank {r}: the embedding's sum differs from its in-process replay")
    r0 = ranks[0]
    gap = abs(r0["kernel_core_loss"] - r0["plain_core_loss"])
    check(gap <= RTOL * abs(r0["plain_core_loss"]),
          f"sma: kernel-core loss {r0['kernel_core_loss']} vs plain {r0['plain_core_loss']}")
    check(abs(r0["losses"][0] - r0["kernel_core_loss"]) <= RTOL * abs(r0["kernel_core_loss"]),
          f"sma: first loss {r0['losses'][0]} vs recomputed {r0['kernel_core_loss']}")
    for f in SMA_OUT.glob("*.pt"):
        f.unlink()  # 750 MB of saved leaves

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    emit("sma", nvidia_smi=smi, ranks=k, config="bert-base", layers=cfg.n_layers,
         d_model=cfg.d_model, batch=B, seq=S, steps=SMA_STEPS, alpha=SMA_ALPHA,
         params_per_rank=r0["params"], bytes_per_rank=4 * r0["params"],
         leaves=len(r0["leaf_values"]), leaf_values=r0["leaf_values"],
         losses=[r["losses"] for r in ranks],
         step_ms=[r["step_ms"] for r in ranks], local_ms=[r["local_ms"] for r in ranks],
         d2h_ms=[r["d2h_ms"] for r in ranks], walk_ms=[r["walk_ms"] for r in ranks],
         h2d_blend_ms=[r["h2d_blend_ms"] for r in ranks],
         median_ms={key: max(med(r[key][1:]) for r in ranks) for key in
                    ("step_ms", "local_ms", "d2h_ms", "walk_ms", "h2d_blend_ms")},
         wire_bytes_per_rank=[r["wire_bytes"] for r in ranks],
         launches=[r["launches"] for r in ranks], kernel_core_loss=r0["kernel_core_loss"],
         plain_core_loss=r0["plain_core_loss"], rtol=RTOL, sum_digest=r0["sum_digest"],
         seconds=time.perf_counter() - t_phase)
    return [r["launches"] for r in ranks]


def _async_rank(rank: int, specs) -> dict:
    """One worker of the async phase: ResNet-50 at 16 images a rank, 3
    SGD steps of each run of ASYNC_RUNS from the same initial parameters
    and batches, each run in a cluster epoch of its own."""
    _worker_env(rank, specs, KF_CONFIG_ASYNC="on", KF_CONFIG_ZERO="on", KF_CONFIG_WIRE="off",
                KF_CONFIG_ALGO="segmented", KF_CONFIG_SEGMENT_MIN_BYTES=0)
    import torch

    from kungfu_tpu_torch import resolve_device
    from kungfu_tpu_torch import torch as kf
    from kungfu_tpu_torch.collective.host_session import HostSession
    from kungfu_tpu_torch.models.resnet import resnet_loss
    from kungfu_tpu_torch.peer import get_default_peer

    _deterministic()
    peer = get_default_peer()
    device = resolve_device()
    gen = torch.Generator(device=device).manual_seed(500 + rank)
    batches = [(torch.randn(OPT_BATCH, OPT_SIDE, OPT_SIDE, 3, device=device, dtype=torch.bfloat16,
                            generator=gen),
                torch.randint(0, 1000, (OPT_BATCH,), device=device, generator=gen))
               for _ in range(ASYNC_STEPS)]

    class FormulaSGD(torch.optim.Optimizer):
        """SGD as ZeRO's ShardedSGD computes it: p -= lr * g, the product
        rounded on its own."""

        def __init__(self, ps):
            super().__init__(ps, {"lr": ASYNC_LR})

        @torch.no_grad()
        def step(self, closure=None):
            for group in self.param_groups:
                for p in group["params"]:
                    p.sub_(p.grad * group["lr"])

    out = {"rank": rank, "runs": {}}
    for run, cap in ASYNC_RUNS:
        HostSession.GROUP_BUCKET_BYTES = cap
        peer.cluster_version += 1  # a fresh epoch: its scheduler registers this run's tensors
        peer._update_to(peer.config.peers)
        sess = peer.current_session()
        # a model of its own (an earlier run's hooks stay on its parameters)
        model = _resnet50_seed0(device)
        params = list(model.parameters())
        out["param_bytes"], out["tensors"] = sum(p.numel() * 4 for p in params), len(params)
        if run == "zero":
            opt = kf.ZeroSGDOptimizer(model, lr=ASYNC_LR, name="async")
        else:
            opt = kf.SynchronousSGDOptimizer(FormulaSGD(params), name="async",
                                             async_hooks=False if run == "step_end" else None)
        digests, ms = [], []
        for step in range(ASYNC_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad()
            resnet_loss(model, batches[step]).backward()
            opt.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            digests.append(_digest(torch.cat([p.detach().reshape(-1) for p in params])))
        agreed = sess.bytes_consensus("".join(digests).encode(), f"async:{run}")
        rec = {"digests": digests, "agreed": agreed, "step_ms": ms, "bucket_cap": cap,
               "stats": sess.scheduler().stats()}
        if run == "zero":
            rec.update(mode=opt._mode, state_bytes=opt.state_bytes(),
                       buckets=opt._zs.bucket_count())
        else:
            rec["hooks"] = opt._hooks_installed
        out["runs"][run] = rec
    sess.barrier(":async:end")
    return out


def async_worker(rank: int, _spawned, specs) -> None:
    try:
        out = _async_rank(rank, specs)  # sets the engine knobs before the engine's import
        (ASYNC_OUT / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        from kungfu_tpu_torch.peer import finalize_default_peer

        finalize_default_peer()


def async_phase(smi: str) -> None:
    """The scheduler and ZeRO on ResNet-50: 4 workers on card 0 in one
    world (KF_CONFIG_ASYNC and KF_CONFIG_ZERO on, the wire codec off, the
    segmented ring) train 3 SGD steps by S-SGD through the
    post-accumulate-grad hooks, by its step-end path, and by ZeroSGD;
    their parameters must agree bit for bit after every step, on every
    rank."""
    from kungfu_tpu_torch.runner.cli import free_ports

    t_phase = time.perf_counter()
    k = ASYNC_RANKS
    ASYNC_OUT.mkdir(parents=True, exist_ok=True)
    for f in ASYNC_OUT.glob("*.json"):
        f.unlink()
    specs = [f"127.0.0.1:{p}" for p in free_ports(k)]
    from kungfu_tpu_torch.parallel.distributed import spawn_world

    spawn_world(async_worker, k, ASYNC_DEADLINE_S, args=(specs,))
    ranks = [json.loads((ASYNC_OUT / f"rank{r}.json").read_text()) for r in range(k)]
    runs = [name for name, _ in ASYNC_RUNS]
    for name in runs:
        check(all(r["runs"][name]["agreed"] for r in ranks)
              and len({tuple(r["runs"][name]["digests"]) for r in ranks}) == 1,
              f"async {name}: the ranks' parameters differ")
    for step in range(ASYNC_STEPS):
        got = {name: ranks[0]["runs"][name]["digests"][step] for name in runs[:3]}
        check(len(set(got.values())) == 1, f"async step {step}: the paths differ {got}")
    r0 = ranks[0]
    check(r0["runs"]["hooks"]["hooks"] and not r0["runs"]["step_end"]["hooks"]
          and r0["runs"]["zero"]["mode"] == "sharded", "async: a path did not run as asked")
    check(r0["runs"]["hooks"]["stats"]["units"] > 0 and r0["runs"]["zero"]["stats"]["zero_units"] > 0,
          "async: the scheduler walked nothing")
    slack = 8 * r0["runs"]["zero"]["buckets"]  # tests/test_zero.py's bound
    for r in ranks:
        z = r["runs"]["zero"]
        check(z["state_bytes"] <= r["param_bytes"] // k + slack,
              f"async rank {r['rank']}: ZeRO holds {z['state_bytes']} B of state, over 1/{k} "
              f"of {r['param_bytes']} + {slack}")

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    emit("async", nvidia_smi=smi, ranks=k, images_per_rank=OPT_BATCH, steps=ASYNC_STEPS,
         tensors=r0["tensors"], param_bytes=r0["param_bytes"],
         step_ms={name: [r["runs"][name]["step_ms"] for r in ranks] for name in runs},
         median_step_ms={name: max(med(r["runs"][name]["step_ms"][1:]) for r in ranks)
                         for name in runs},
         bucket_cap={name: cap for name, cap in ASYNC_RUNS},
         stats={name: [r["runs"][name]["stats"] for r in ranks] for name in runs},
         zero_state_bytes=[r["runs"]["zero"]["state_bytes"] for r in ranks],
         zero_buckets=r0["runs"]["zero"]["buckets"], digests=r0["runs"]["hooks"]["digests"],
         seconds=time.perf_counter() - t_phase)


TM_RANKS = 4
TM_STEPS = 6
TM_DEADLINE_S = 400
TM_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_tm"
TM_FEATURES = "metrics,trace,audit"
# run -> (the optimizer, telemetry on), in this order, each a cluster
# epoch of its own: S-SGD off and on in turns (off, on, off, on) for the
# overhead, then ZeroSGD with telemetry on
TM_RUNS = (("off", "ssgd", False), ("on", "ssgd", True), ("zero", "zero", True))
TM_WARM = 2  # steps of a run left out of its median: the step-end path, then registration
TM_ENDPOINTS = ("/metrics", "/trace", "/audit")


def _ring_bytes(n: int, k: int, rank: int) -> int:
    """f32 payload bytes `rank` sends in one segmented ring all-reduce of
    n elements over k ranks: its segments of the reduce-scatter and the
    all-gather, empty segments skipped (the hostnet phase's 2 (k - 1) / k
    of 4n, exact)."""
    from kungfu_tpu_torch.plan import topology as topo

    sched = topo.gen_segmented_schedule(list(range(k)), rank)
    bounds = topo.segment_bounds(n, k)
    return 4 * sum(bounds[snd][1] - bounds[snd][0]
                   for snd, _ in tuple(sched.rs_steps) + tuple(sched.ag_steps))


def _scrape(specs) -> list:
    """Every rank's /metrics, /trace and /audit over HTTP (peer port +
    10000): per rank and endpoint, the body, its bytes and the ms it took."""
    import urllib.request

    out = []
    for spec in specs:
        port = int(spec.rsplit(":", 1)[1]) + 10000
        got = {}
        for ep in TM_ENDPOINTS:
            t0 = time.perf_counter()
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{ep}", timeout=30) as r:
                body = r.read().decode()
            got[ep] = {"body": body, "bytes": len(body), "ms": (time.perf_counter() - t0) * 1e3}
        out.append(got)
    return out


def _read_scrape(pages) -> list:
    """What the phase's gates read from one scrape of every rank, the
    /metrics page parsed by the port's promparse."""
    from kungfu_tpu_torch.telemetry import promparse

    out = []
    for got in pages:
        samples = promparse.parse_text(got["/metrics"]["body"])
        wire = [s for s in samples if s.name == "kungfu_collective_wire_bytes_total"]
        trace = json.loads(got["/trace"]["body"])
        walks = [e for e in trace["traceEvents"] if e["name"] == "sched.walk"]
        out.append({
            "wire_ring_raw": sum(s.value for s in wire
                                 if dict(s.labels) == {"collective": "raw",
                                                       "strategy": "RING_SEGMENTED",
                                                       "codec": "off"}),
            "wire_all": sum(s.value for s in wire),
            "egress": sum(s.value for s in samples if s.name == "kungfu_egress_bytes_total"),
            "sched": {name: promparse.sample_value(samples, name)
                      for name in ("kungfu_scheduler_queued_buckets",
                                   "kungfu_scheduler_overlap_seconds_total",
                                   "kungfu_scheduler_flush_wait_seconds")},
            "zero_state_bytes": promparse.sample_value(samples,
                                                       "kungfu_sharded_update_state_bytes"),
            "families": len({s.name for s in samples}),
            "trace_events": len(trace["traceEvents"]),
            "sched_walks_with_step": sum(1 for e in walks if "step" in e.get("args", {})),
            "audit_kinds": [r["kind"] for r in json.loads(got["/audit"]["body"])],
            "ms": {ep: got[ep]["ms"] for ep in TM_ENDPOINTS},
            "bytes": {ep: got[ep]["bytes"] for ep in TM_ENDPOINTS},
        })
    return out


def _telemetry_rank(rank: int, specs) -> dict:
    """One worker of the telemetry phase: ResNet-50 at 16 images a rank,
    TM_STEPS SGD steps of each run of TM_RUNS from the same parameters
    and batches, each in a cluster epoch of its own; telemetry goes on or
    off (the environment, then a fresh epoch) before each run, and this
    worker's endpoint comes up with the first run that has it on. After
    each step every rank meets in a barrier, rank 0 scrapes every rank's
    endpoint when telemetry is on, and a second barrier releases the next
    step."""
    _worker_env(rank, specs, KF_CONFIG_ASYNC="on", KF_CONFIG_ZERO="on", KF_CONFIG_WIRE="off",
                KF_CONFIG_ALGO="segmented", KF_CONFIG_SEGMENT_MIN_BYTES=0)
    import torch

    from kungfu_tpu_torch import api, resolve_device
    from kungfu_tpu_torch import torch as kf
    from kungfu_tpu_torch.models.resnet import resnet_loss
    from kungfu_tpu_torch.peer import get_default_peer
    from kungfu_tpu_torch.telemetry import config as tconfig

    _deterministic()
    peer = get_default_peer()
    device = resolve_device()
    gen = torch.Generator(device=device).manual_seed(700 + rank)
    batches = [(torch.randn(OPT_BATCH, OPT_SIDE, OPT_SIDE, 3, device=device, dtype=torch.bfloat16,
                            generator=gen),
                torch.randint(0, 1000, (OPT_BATCH,), device=device, generator=gen))
               for _ in range(TM_STEPS)]
    out = {"rank": rank, "served_before": peer.metrics_server is not None, "runs": {}}
    for run, kind, on in TM_RUNS:
        if on:
            os.environ["KF_TELEMETRY"] = TM_FEATURES
        else:
            os.environ.pop("KF_TELEMETRY", None)
        tconfig.refresh(None)
        if on and peer.metrics_server is None:
            peer._start_telemetry_server()
        peer.cluster_version += 1  # a fresh epoch: its session reads the telemetry gate
        peer._update_to(peer.config.peers)
        sess = peer.current_session()
        model = _resnet50_seed0(device)
        params = list(model.parameters())
        if kind == "zero":
            opt = kf.ZeroSGDOptimizer(model, lr=ASYNC_LR, name=f"tm{run}")
        else:
            opt = kf.SynchronousSGDOptimizer(torch.optim.SGD(params, lr=ASYNC_LR),
                                             name=f"tm{run}")
        rec = {"digests": [], "step_ms": [], "scrapes": [], "wire_ring_raw": []}
        for step in range(TM_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad()
            resnet_loss(model, batches[step]).backward()
            opt.step()
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["digests"].append(_digest(torch.cat([p.detach().reshape(-1) for p in params])))
            rec["wire_ring_raw"].append(sess.wire_bytes.get(("raw", "RING_SEGMENTED", "off"), 0))
            sess.barrier(f":tm:{run}:{step}:a")
            if rank == 0 and on:
                rec["scrapes"].append(_read_scrape(_scrape(specs)))
            sess.barrier(f":tm:{run}:{step}:b")
        if kind == "zero":
            rec.update(mode=opt._mode, state_bytes=opt.state_bytes())
        else:
            rec["hooks"] = opt._hooks_installed
        sched = sess.scheduler()
        rec["unit_elems"] = [b // 4 for _, b in sorted(sched._unit_bytes.items())]
        rec["stats"] = sched.stats()
        rec["agreed"] = sess.bytes_consensus("".join(rec["digests"]).encode(), f"tm:{run}")
        if run == "on":
            rec["latencies"] = api.get_peer_latencies().tolist()
            rec["tree"] = api.optimized_tree()
        out["runs"][run] = rec
    out["served_after"] = peer.metrics_server is not None
    sess.barrier(":tm:end")
    return out


def telemetry_worker(rank: int, _spawned, specs) -> None:
    try:
        out = _telemetry_rank(rank, specs)  # sets the engine knobs before the engine's import
        (TM_OUT / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        from kungfu_tpu_torch.peer import finalize_default_peer

        finalize_default_peer()


def telemetry_phase(smi: str) -> None:
    """The telemetry plane on the async hook path: 4 workers on card 0 train
    ResNet-50 by S-SGD with telemetry off and on in turns (on:
    KF_TELEMETRY=metrics,trace,audit, every worker serving /metrics,
    /trace and /audit), then by ZeroSGD with it on. Gates: every S-SGD run
    ends bitwise equal to the others; each rank's ring bytes in
    kungfu_collective_wire_bytes_total are the segmented ring's exact
    bytes for the scheduler's buckets, and its egress bytes at least its
    wire bytes; the scheduler's families are there and non-negative;
    ZeRO's state-byte gauge is its own count; the traces hold sched.walk
    spans stamped with their step; the latencies and the optimized tree
    are sound and agreed."""
    from kungfu_tpu_torch.parallel.distributed import spawn_world
    from kungfu_tpu_torch.runner.cli import free_port_range

    t_phase = time.perf_counter()
    k = TM_RANKS
    TM_OUT.mkdir(parents=True, exist_ok=True)
    for f in TM_OUT.glob("*.json"):
        f.unlink()
    base = free_port_range(k)  # telemetry on port + 10000: 22000-29999
    specs = [f"127.0.0.1:{base + i}" for i in range(k)]
    spawn_world(telemetry_worker, k, TM_DEADLINE_S, args=(specs,))
    ranks = [json.loads((TM_OUT / f"rank{r}.json").read_text()) for r in range(k)]
    runs = [run for run, _, _ in TM_RUNS]
    ssgd = [run for run, kind, _ in TM_RUNS if kind == "ssgd"]
    observed = [run for run, _, on in TM_RUNS if on]
    check(not any(r["served_before"] for r in ranks) and all(r["served_after"] for r in ranks),
          "telemetry: a worker served before telemetry went on, or not after")
    for run in runs:
        check(all(r["runs"][run]["agreed"] for r in ranks)
              and len({tuple(r["runs"][run]["digests"]) for r in ranks}) == 1,
              f"telemetry {run}: the ranks' parameters differ")
    check(all(len({tuple(r["runs"][run]["digests"]) for run in ssgd}) == 1 for r in ranks),
          "telemetry: the parameters with telemetry on differ from those with it off")
    check(all(r["runs"][run]["hooks"] for r in ranks for run in ssgd)
          and all(r["runs"]["zero"]["mode"] == "sharded" for r in ranks),
          "telemetry: a run did not take the hook path or the sharded update")
    scrapes = {run: ranks[0]["runs"][run]["scrapes"] for run in observed}
    check(all(len(v) == TM_STEPS for v in scrapes.values()), "telemetry: a scrape is missing")
    units = ranks[0]["runs"]["on"]["unit_elems"]
    check(all(r["runs"][run]["unit_elems"] == units for r in ranks for run in ssgd),
          "telemetry: the bucket plans differ between ranks or runs")
    wire = {}
    for r in range(k):
        want = sum(_ring_bytes(n, k, r) for n in units)
        wire[r] = {"per_step_want": want}
        for run in [run for run in ssgd if run in observed]:
            got = [s[r]["wire_ring_raw"] for s in scrapes[run]]
            own = ranks[r]["runs"][run]["wire_ring_raw"]
            # step 0 takes the step-end path; later steps walk the scheduler's buckets
            deltas = [b - a for a, b in zip(got, got[1:])]
            own_deltas = [b - a for a, b in zip(own, own[1:])]
            wire[r][run] = deltas
            check(deltas == own_deltas == [want] * (TM_STEPS - 1),
                  f"telemetry {run} rank {r}: ring wire bytes a step {deltas} (the session's "
                  f"own count {own_deltas}), the formula gives {want}")
    for run in observed:
        for step, scrape in enumerate(scrapes[run]):
            for r, got in enumerate(scrape):
                check(got["egress"] >= got["wire_all"] > 0,
                      f"telemetry {run} step {step} rank {r}: egress {got['egress']} B "
                      f"under the wire's {got['wire_all']} B")
                if step or run == "zero":
                    check(all(v is not None and v >= 0 for v in got["sched"].values()),
                          f"telemetry {run} step {step} rank {r}: scheduler families "
                          f"{got['sched']}")
    for r, got in enumerate(scrapes["zero"][-1]):
        check(got["zero_state_bytes"] == ranks[r]["runs"]["zero"]["state_bytes"],
              f"telemetry rank {r}: kungfu_sharded_update_state_bytes "
              f"{got['zero_state_bytes']}, ZeRO counts {ranks[r]['runs']['zero']['state_bytes']}")
    check(all(got["sched_walks_with_step"] > 0 for got in scrapes["on"][-1]),
          "telemetry: a trace holds no sched.walk span with its step")
    for r in ranks:
        lat = r["runs"]["on"]["latencies"]
        check(lat[r["rank"]] == 0.0 and all(0 < v < math.inf for i, v in enumerate(lat)
                                            if i != r["rank"]),
              f"telemetry rank {r['rank']}: latencies {lat}")
    trees = {json.dumps(r["runs"]["on"]["tree"]) for r in ranks}
    check(len(trees) == 1, f"telemetry: the ranks' optimized trees differ: {trees}")

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    # a run's step: the slowest rank's median over its steps past TM_WARM;
    # off and on pool their two runs
    median = {run: max(med(r["runs"][run]["step_ms"][TM_WARM:]) for r in ranks) for run in runs}
    pooled = {on: max(med([x for run in ssgd if (run in observed) == on
                           for x in r["runs"][run]["step_ms"][TM_WARM:]]) for r in ranks)
              for on in (False, True)}
    last = scrapes[[run for run in ssgd if run in observed][-1]][-1]
    emit("telemetry", nvidia_smi=smi, ranks=k, images_per_rank=OPT_BATCH, steps=TM_STEPS,
         features=TM_FEATURES, order=runs,
         step_ms={run: [r["runs"][run]["step_ms"] for r in ranks] for run in runs},
         median_step_ms=median, median_off_ms=pooled[False], median_on_ms=pooled[True],
         overhead=pooled[True] / pooled[False] - 1,
         scrape_ms={ep: [[s[r]["ms"][ep] for r in range(k)] for run in observed
                         for s in scrapes[run]] for ep in TM_ENDPOINTS},
         body_bytes={ep: [got["bytes"][ep] for got in last] for ep in TM_ENDPOINTS},
         families=[got["families"] for got in last],
         trace_events=[got["trace_events"] for got in last],
         audit_kinds=[got["audit_kinds"] for got in last],
         buckets=len(units), wire=wire,
         zero_state_bytes=[r["runs"]["zero"]["state_bytes"] for r in ranks],
         stats={run: [r["runs"][run]["stats"] for r in ranks] for run in runs},
         tree=ranks[0]["runs"]["on"]["tree"], latencies=[r["runs"]["on"]["latencies"]
                                                         for r in ranks],
         seconds=time.perf_counter() - t_phase)


RP_RANKS = 4
RP_DEADLINE_S = 600
RP_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_rp"
RP_LR, RP_MOMENTUM = 0.1, 0.9
RP_CALIB_STEPS = 3  # unshaped steps the shaped edge's rate is chosen from
RP_SLOWDOWN = 4.0  # the rate makes the unshaped walk's bytes on the edge take this much longer
RP_MIN_SLOWDOWN = 3.0  # gate: the shaped rank-order walk at least this much longer
RP_A_STEPS, RP_A_INTERVAL, RP_A_PATIENCE = 12, 4, 2
# leg (a) reorders only, and only for a predicted gain of 2x: the shaped
# edge predicts ~RP_SLOWDOWN, while the estimates of unshaped loopback
# edges differ by up to 1.5x between rounds, enough to re-pair the ring
# at the policy's default 1.05 (a weight refinement passes no gain bar)
RP_A_MODE, RP_A_MIN_GAIN = "ring", 2.0
RP_B_MODE = "auto"  # leg (b) adopts once, by api.check_replan: reordered and weighted
RP_B_STEPS, RP_B_FLIP = 4, 2  # leg (b) adopts after this step
# leg (c)'s rounds, after these steps: the two-level plan after step 1, rank
# RP_C_DEMOTED demoted after step 2 (steps 3-4 run without it), promoted back
# after step 4 (step 5 walks the whole two-level plan again)
RP_C_STEPS, RP_C_FLIP, RP_C_DEMOTE, RP_C_PROMOTE = 5, 1, 2, 4
RP_C_DEMOTED = 3
RP_C_LAT_MS = 1
RP_C_CROSS_BW = 64 << 20  # bytes/s on every cross-host edge of leg (c)
RP_C_UPLINK_BW = 96 << 20  # each virtual host's shared uplink
RP_KNOBS = dict(KF_CONFIG_ALGO="segmented", KF_CONFIG_SEGMENT_MIN_BYTES=0, KF_CONFIG_WIRE="off",
                KF_CONFIG_SHM="0", KF_CONFIG_ASYNC="off", KF_TELEMETRY="metrics",
                KF_DECISION_WINDOW=3, KF_DECISION_SETTLE=1)


class _RoundTap:
    """Instance wrappers on one session: the ms of each re-plan or demotion
    round and of its parts (vote, matrix exchange, compute-fraction
    exchange, the adoption's digest and listeners), the matrices it
    exchanged, and the ms of every bucket walk; the first walk after the
    first adoption is captured (its inputs and outputs)."""

    def __init__(self, sess):
        self.sess = sess
        self.walk_ms, self.rounds, self.matrices = [], [], []
        self.capture = None
        self._arm = False
        self._part = {}
        for name in ("measured_matrix", "measured_compute_frac", "adopt_replan"):
            self._wrap_part(name)
        for name in ("check_replan", "check_demote"):
            self._wrap_round(name)
        walk = sess._allreduce_ws

        def tapped(w, *a, **kw):
            arm, self._arm = self._arm, False
            before = w.send.detach().clone() if arm else None
            t0 = time.perf_counter()
            out = walk(w, *a, **kw)
            self.walk_ms.append((time.perf_counter() - t0) * 1e3)
            if arm:
                self.capture = (before, w.recv.detach().clone())
            return out

        sess._allreduce_ws = tapped

    def _wrap_part(self, name):
        fn = getattr(self.sess, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self._part[name] = self._part.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            if name == "measured_matrix":
                self.matrices.append(out.tolist())
            elif name == "measured_compute_frac":
                self._part["compute_frac"] = out
            elif name == "adopt_replan" and self.capture is None:
                self._arm = True
            return out

        setattr(self.sess, name, timed)

    def _wrap_round(self, name):
        fn = getattr(self.sess, name)

        def timed(*a, **kw):
            self._part = {}
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            total = (time.perf_counter() - t0) * 1e3
            parts = dict(self._part)
            self.rounds.append({"round": name, "ms": total, "adopted": out is not None,
                                "matrix_ms": parts.get("measured_matrix", 0.0),
                                "compute_frac_ms": parts.get("measured_compute_frac", 0.0),
                                "compute_frac": parts.pop("compute_frac", None),
                                "adopt_ms": parts.get("adopt_replan", 0.0),
                                "vote_ms": total - sum(parts.values())})
            return out

        setattr(self.sess, name, timed)


def _rp_epoch(peer, **env) -> None:
    """A fresh cluster epoch under `env` (None unsets; the client reads
    KF_SHAPE_LINKS again at the epoch), with an empty link table and
    ledger, so each leg measures and grades itself."""
    from kungfu_tpu_torch.telemetry import decisions
    from kungfu_tpu_torch.telemetry import link as tlink

    for key, value in env.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(value)
    tlink.get_table().clear()
    decisions.reset_ledger()
    peer.cluster_version += 1
    peer._update_to(peer.config.peers)


def _rp_get(peer, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{peer.self_id.port + 10000}{path}",
                                timeout=30) as r:
        return r.read().decode()


def _rp_train(leg: str, rank: int, peer, batches, steps: int, after_step=None, policies=(),
              keep_step: int = 0) -> dict:
    """`steps` ZeroSGD(0.1, 0.9) steps of ResNet-50 from the seed-0
    initialization on this rank's batches under a PolicyRunner (which feeds
    the ledger each step's time): the replicated update unless
    KF_CONFIG_ZERO is on. Per step the parameters' digest, the step's ms
    and its walks' ms, the plan's digest; at `keep_step` the local
    gradient's |g| and the averaged gradient (replicated mode). Then what
    the gates read of the leg on this rank: its /decisions, the /metrics
    families the phase names, its audit events since the leg began, the
    plan, the wire bytes and the rounds' times. `after_step(step, sess,
    opt)` runs at each step boundary on every rank alike."""
    import torch

    from kungfu_tpu_torch import resolve_device
    from kungfu_tpu_torch import torch as kf
    from kungfu_tpu_torch.models.resnet import resnet_loss
    from kungfu_tpu_torch.plan import replan as rp
    from kungfu_tpu_torch.policy import PolicyRunner
    from kungfu_tpu_torch.telemetry import audit, promparse

    mark = max([r["seq"] for r in audit.to_json()], default=-1)
    sess = peer.current_session()
    tap = _RoundTap(sess)
    model = _resnet50_seed0(resolve_device())
    params = list(model.parameters())
    opt = kf.ZeroSGDOptimizer(model, lr=RP_LR, momentum=RP_MOMENTUM, name=f"rp{leg}")
    rec = {"digests": [], "step_ms": [], "walk_ms": [], "plan_digests": []}
    kept = {}
    with PolicyRunner(list(policies), batch_size=OPT_BATCH) as runner:
        for step in range(1, steps + 1):
            n_walks = len(tap.walk_ms)
            torch.cuda.synchronize()
            with runner.step():
                t0 = time.perf_counter()
                opt.zero_grad()
                resnet_loss(model, batches[step - 1]).backward()
                if step == keep_step:
                    kept["local_abs"] = torch.cat([p.grad.detach().reshape(-1).abs().cpu()
                                                   for p in params])
                opt.step()
                torch.cuda.synchronize()
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["walk_ms"].append(sum(tap.walk_ms[n_walks:]))
            rec["digests"].append(_digest(torch.cat([p.detach().reshape(-1) for p in params])))
            if step == keep_step and opt._mode == "replicated":
                kept["avg"] = torch.cat([p.grad.detach().reshape(-1).cpu() for p in params])
            if after_step is not None:
                after_step(step, sess, opt)
            rec["plan_digests"].append(rp.plan_digest(sess.ring_plan()).hex())
            if tap.capture is not None and "capture_step" not in rec:
                rec["capture_step"] = step  # the step whose first walk it was
                torch.save({"in": tap.capture[0], "out": tap.capture[1]},
                           RP_OUT / f"{leg}_walk{rank}.pt")
    rec["mode"] = opt._mode
    samples = promparse.parse_text(_rp_get(peer, "/metrics"))
    rec["decisions"] = json.loads(_rp_get(peer, "/decisions"))["decisions"]
    rec["replans_total"] = promparse.sample_value(samples, "kungfu_topology_replans_total")
    rec["link_bw"] = {dict(s.labels)["dst"]: s.value for s in samples
                      if s.name == "kungfu_link_bandwidth_bytes_per_second"}
    rec["efficiency"] = {dict(s.labels)["strategy"]: s.value for s in samples
                         if s.name == "kungfu_collective_efficiency_ratio"}
    rec["roles"] = [dict(dict(s.labels), group=s.value) for s in samples
                    if s.name == "kungfu_topology_ring_role"]
    rec["audit"] = [r for r in audit.to_json() if r["seq"] > mark
                    and r["kind"] in ("topology_replanned", "decision_outcome")]
    plan, hier = sess.ring_plan(), sess.hier_plan()
    rec["plan"] = None if plan is None else {"order": list(plan.order), "gain": plan.gain,
                                             "weights": plan.weights}
    rec["hier"] = None if hier is None else {"groups": [list(g) for g in hier.groups],
                                             "heads": list(hier.heads)}
    rec["wire_bytes"] = {"/".join(key): v for key, v in sess.wire_bytes.items()}
    rec["rounds"], rec["matrices"] = tap.rounds, tap.matrices
    rec["agreed"] = sess.bytes_consensus("".join(rec["digests"]).encode(), f"rp:{leg}")
    return rec, kept


def _replan_rank(rank: int, specs) -> dict:
    """One worker of the replan phase: a Peer from kfrun's environment on
    card 0, ResNet-50 at 16 images of 224² a rank, ZeroSGD(0.1, 0.9) over
    the host plane's segmented ring in f32 over sockets, each leg a
    cluster epoch of its own: an unshaped calibration, then (a) the shaped
    edge rank 1 -> 2 with ReplanPolicy driving the re-plan, (b) ZeRO-1
    across a flip by api.check_replan, (b2) the replicated update across
    the same flip, (c) two virtual hosts, a two-level plan, a demotion and
    a promotion."""
    _worker_env(rank, specs, **RP_KNOBS, KF_TELEMETRY_DIR=str(RP_OUT))
    for knob in ("KF_SHAPE_LINKS", "KF_TEST_SLOW_EDGE", "KF_CONFIG_REPLAN", "KF_DECISION_KEEP",
                 "KF_DECISION_PATIENCE", "KF_DECISION_REGRESS_RATIO",
                 "KF_REPLAN_DEMOTE_PATIENCE", "KF_LINK_BW_MIN_BYTES", "KF_LINK_EWMA_ALPHA"):
        os.environ.pop(knob, None)
    import torch

    from kungfu_tpu_torch import api, resolve_device
    from kungfu_tpu_torch.peer import get_default_peer
    from kungfu_tpu_torch.plan.topology import gen_segmented_schedule
    from kungfu_tpu_torch.policy import ReplanPolicy
    from kungfu_tpu_torch.transport import shaping

    _deterministic()
    peer = get_default_peer()
    device = resolve_device()
    k = len(specs)
    gen = torch.Generator(device=device).manual_seed(900 + rank)
    batches = [(torch.randn(OPT_BATCH, OPT_SIDE, OPT_SIDE, 3, device=device, dtype=torch.bfloat16,
                            generator=gen),
                torch.randint(0, 1000, (OPT_BATCH,), device=device, generator=gen))
               for _ in range(max(RP_A_STEPS, RP_B_STEPS, RP_C_STEPS))]
    out = {"rank": rank, "legs": {}}

    # calibration: the unshaped rank-order ring; rank 0 picks the rate
    rec, _ = _rp_train("calib", rank, peer, batches, RP_CALIB_STEPS)
    sess = peer.current_session()
    sent = sum(v for key, v in rec["wire_bytes"].items() if key.endswith("RING_SEGMENTED/off"))
    walk_s = sorted(rec["walk_ms"][1:])[len(rec["walk_ms"][1:]) // 2] / 1e3
    rate = int(sent / RP_CALIB_STEPS / (RP_SLOWDOWN * walk_s))
    rate = int(sess.broadcast_bytes(str(rate).encode(), "kungfu::rp:rate").decode())
    out["legs"]["calib"] = rec
    out["rate"] = rate
    out["edge_bytes_per_step"] = sent / RP_CALIB_STEPS

    # (a) the shaped edge 1 -> 2 of the rank-order ring, ReplanPolicy
    _rp_epoch(peer, KF_SHAPE_LINKS=f"{specs[1]}>{specs[2]}=bw:{rate}",
              KF_CONFIG_REPLAN=RP_A_MODE, KF_CONFIG_ZERO="off")
    policy = ReplanPolicy(interval_steps=RP_A_INTERVAL, patience=RP_A_PATIENCE,
                          min_gain=RP_A_MIN_GAIN)
    out["legs"]["a"], kept_a = _rp_train("a", rank, peer, batches, RP_A_STEPS,
                                         policies=[policy], keep_step=RP_B_FLIP + 1)

    # (b) ZeRO-1 on, the same shape: api.check_replan after step RP_B_FLIP
    flip = {}

    def flip_b(step, sess, opt):
        if step == RP_B_FLIP:
            flip["adopted"] = api.check_replan(want=True)
            plan = flip["plan"] = sess.ring_plan()
            pos = list(plan.order).index(sess.rank)
            seg = gen_segmented_schedule(list(plan.order), pos).owned_segment
            flip["weight"] = plan.weights[seg] if plan.weights else 1.0 / k
            flip["state_bytes"] = opt.state_bytes()
            flip["buckets"] = [(b.ob, b.oe, b.total) for b in opt._zs._buckets]

    _rp_epoch(peer, KF_CONFIG_ZERO="on", KF_CONFIG_REPLAN=RP_B_MODE)
    rec, _ = _rp_train("b", rank, peer, batches, RP_B_STEPS, after_step=flip_b)
    rec.update(adopted=flip["adopted"], weight=flip["weight"],
               state_bytes_after_flip=flip["state_bytes"], buckets=flip["buckets"])
    out["legs"]["b"] = rec

    # (b2) the replicated update across the same flip: leg (b)'s plan adopted
    # after the same step
    def flip_b2(step, sess, opt):
        if step == RP_B_FLIP:
            sess.adopt_replan(flip["plan"])

    _rp_epoch(peer, KF_CONFIG_ZERO="off")
    out["legs"]["b2"], kept_b2 = _rp_train("b2", rank, peer, batches, RP_B_STEPS,
                                           after_step=flip_b2, keep_step=RP_B_FLIP + 1)
    # the first step past the flip: the plan's all-reduce against the
    # rank-order ring's, on the same local gradients, within the f32 limit
    abs_sum = api.all_reduce_array(kept_a["local_abs"], name="rp:abs").double()
    bound = (2 * (k - 1) * HOST_F32_ULP * abs_sum + HOST_F32_FLOOR) / k
    diff = (kept_a["avg"].double() - kept_b2["avg"].double()).abs()
    out["f32"] = {"same_local": bool(torch.equal(kept_a["local_abs"], kept_b2["local_abs"])),
                  "within": bool((diff <= bound).all()), "max_diff": float(diff.max()),
                  "max_ratio": float((diff / bound).max()),
                  "bitwise": bool(torch.equal(kept_a["avg"], kept_b2["avg"]))}
    del kept_a, kept_b2

    # (c) two virtual hosts {0, 1} and {2, 3}: latency and a bandwidth cap on
    # every cross-host edge, one shared uplink a host; a two-level plan, then
    # rank RP_C_DEMOTED demoted for two steps and promoted back
    hosts = (specs[:2], specs[2:])
    entries = [f"{s}>{d}=lat:{RP_C_LAT_MS},bw:{RP_C_CROSS_BW}"
               for a, b in (hosts, hosts[::-1]) for s in a for d in b]
    entries += [f"uplink:{'|'.join(h)}=bw:{RP_C_UPLINK_BW}" for h in hosts]
    shaping.BURST_SECONDS, shaping.BURST_MIN_BYTES = 0.002, 4 << 10  # bench_hier.py's
    demoted = []

    def wire_snapshot(sess):
        return {"/".join(key): v for key, v in sess.wire_bytes.items()}

    def rounds_c(step, sess, opt):
        if step == RP_C_FLIP:
            flip["c_wire_flat"] = wire_snapshot(sess)
            flip["c_adopted"] = api.check_replan(want=True)
            hier = sess.hier_plan()
            flip["c_first"] = None if hier is None else {
                "groups": [list(g) for g in hier.groups], "heads": list(hier.heads)}
        elif step == RP_C_DEMOTE:
            flip["c_wire_two_level"] = wire_snapshot(sess)
            flip["c_demoted"] = sess.check_demote(demote=RP_C_DEMOTED) is not None
        elif step == RP_C_PROMOTE:
            flip["c_promoted"] = sess.check_demote(promote=RP_C_DEMOTED) is not None
        demoted.append(list(sess.demoted_peers()))

    _rp_epoch(peer, KF_SHAPE_LINKS=";".join(entries), KF_CONFIG_REPLAN="hier")
    rec, _ = _rp_train("c", rank, peer, batches, RP_C_STEPS, after_step=rounds_c)
    rec.update(adopted=flip["c_adopted"], demote_adopted=flip["c_demoted"],
               promote_adopted=flip["c_promoted"], demoted=demoted, shape=";".join(entries),
               first_hier=flip["c_first"], wire_flat=flip["c_wire_flat"],
               wire_two_level=flip["c_wire_two_level"])
    out["legs"]["c"] = rec
    peer.current_session().barrier(":rp:end")
    return out


def replan_worker(rank: int, _spawned, specs) -> None:
    try:
        out = _replan_rank(rank, specs)  # sets the engine knobs before the engine's import
        (RP_OUT / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        from kungfu_tpu_torch.peer import finalize_default_peer

        finalize_default_peer()


def _adoptions(digests) -> list:
    """The steps after which the plan's digest changed (the digests are
    read after each step)."""
    naive = b"naive-ring".hex()
    return [i + 1 for i, d in enumerate(digests) if d != (digests[i - 1] if i else naive)]


def _rp_median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def replan_phase(smi: str) -> None:
    """Measured topology on the card: 4 workers on card 0 train ResNet-50
    (16 images of 224² a rank) by ZeroSGD(0.1, 0.9) over the host plane's
    segmented f32 ring over sockets, telemetry's metrics on, a ledger
    window of 3 after 1 settle step. After an unshaped calibration that
    picks the rate of the shaped edge rank 1 -> 2: (a) ReplanPolicy every
    4 steps routes around it; (b) ZeRO-1 across a flip by api.check_replan
    after step 2, and (b2) the replicated update across the same flip; (c)
    two virtual hosts, a two-level plan, rank 3 demoted for two steps and
    promoted back. The parent replays each leg's first walk after the
    first adoption through the plain twins."""
    from kungfu_tpu_torch.parallel.distributed import spawn_world
    from kungfu_tpu_torch.runner.cli import free_port_range

    t_phase = time.perf_counter()
    k = RP_RANKS
    RP_OUT.mkdir(parents=True, exist_ok=True)
    for f in [f for pat in ("*.json", "*.pt", "kf-uplink-*.bucket") for f in RP_OUT.glob(pat)]:
        f.unlink()
    base = free_port_range(k)  # telemetry on port + 10000: 22000-29999
    specs = [f"127.0.0.1:{base + i}" for i in range(k)]
    spawn_world(replan_worker, k, RP_DEADLINE_S, args=(specs,))
    replan_gates(smi, specs, t_phase)


def replan_gates(smi: str, specs, t_phase: float) -> None:
    """The replan phase's gates and its line, from the workers' results in
    RP_OUT."""
    import torch

    from kungfu_tpu_torch import resolve_device

    k = len(specs)
    ranks = [json.loads((RP_OUT / f"rank{r}.json").read_text()) for r in range(k)]
    legs = {leg: [r["legs"][leg] for r in ranks] for leg in ("calib", "a", "b", "b2", "c")}
    for leg, recs in legs.items():
        check(all(x["agreed"] for x in recs) and len({tuple(x["digests"]) for x in recs}) == 1,
              f"replan {leg}: the ranks' parameters differ after some step")
        check(len({tuple(x["plan_digests"]) for x in recs}) == 1,
              f"replan {leg}: the ranks' plans differ after some step")
    check(_adoptions(legs["calib"][0]["plan_digests"]) == [], "replan: the calibration re-planned")

    # (a) one adoption routing around 1 -> 2, graded delivered, replayed
    a = legs["a"]
    adopt = _adoptions(a[0]["plan_digests"])
    check(len(adopt) == 1, f"replan a: adoptions after steps {adopt}, want exactly one")
    at = adopt[0]
    order = a[0]["plan"]["order"]
    check((1, 2) not in {(order[i], order[(i + 1) % k]) for i in range(k)},
          f"replan a: the adopted order {order} keeps the shaped edge 1 -> 2")
    unshaped = _rp_median([w for x in legs["calib"] for w in x["walk_ms"][1:]])
    shaped = _rp_median([w for x in a for w in x["walk_ms"][1:at]])
    after = _rp_median([w for x in a for w in x["walk_ms"][at + 1:]])
    check(shaped >= RP_MIN_SLOWDOWN * unshaped,
          f"replan a: the shaped walk {shaped:.1f} ms is under {RP_MIN_SLOWDOWN}x the "
          f"unshaped {unshaped:.1f} ms")
    for x in a:
        check(len([e for e in x["audit"] if e["kind"] == "topology_replanned"]) == 1,
              "replan a: a rank has no topology_replanned audit event, or more than one")
        recs = [d for d in x["decisions"] if d["kind"] == "topology_replanned"]
        check(len(recs) == 1 and recs[0]["status"] == "closed"
              and recs[0]["verdict"] == "delivered",
              f"replan a: the ledger's topology_replanned records {recs}")
        check(x["replans_total"] == 1, f"replan a: kungfu_topology_replans_total "
                                       f"{x['replans_total']}")
    # a gauge child reads 0 until its link has a bandwidth sample
    row1 = {dst: bw for dst, bw in a[1]["link_bw"].items() if bw > 0}
    check(row1 and min(row1, key=row1.get) == specs[2],
          f"replan a: rank 1's slowest link is not to rank 2: {a[1]['link_bw']}")
    plan_a = a[0]["plan"]
    walks = [torch.load(RP_OUT / f"a_walk{r}.pt") for r in range(k)]
    check(all(x["capture_step"] == at + 1 for x in a), "replan a: the walk after the adoption "
                                                       "was not captured")
    replay = ring_replay([w["in"].clone() for w in walks], host_ops(plain=True),
                         order=plan_a["order"], weights=plan_a["weights"])
    check(all(torch.equal(replay[r], walks[r]["out"]) for r in range(k)),
          "replan a: the first all-reduce after the adoption differs from its replay")
    del walks, replay

    # (b) ZeRO-1 across the flip, bitwise the replicated update across it
    b, b2 = legs["b"], legs["b2"]
    check(all(x["adopted"] for x in b) and all(_adoptions(x["plan_digests"]) == [RP_B_FLIP]
                                               for x in b + b2),
          "replan b: not one adoption after step 2")
    check(b[0]["digests"][:RP_B_FLIP] == a[0]["digests"][:RP_B_FLIP],
          "replan b: ZeRO's steps before the flip differ from leg (a)'s")
    check(b[0]["digests"] == b2[0]["digests"],
          "replan b: ZeRO across the flip differs from the replicated update across it")
    plan_b = b2[0]["plan"]
    check(plan_b["weights"] is not None and b[0]["plan"] == plan_b,
          f"replan b: the plan {b[0]['plan']} is not weighted, or not the one b2 adopted")
    walks = [torch.load(RP_OUT / f"b2_walk{r}.pt") for r in range(k)]
    check(all(x["capture_step"] == RP_B_FLIP + 1 for x in b2),
          "replan b2: the walk after the adoption was not captured")
    replay = ring_replay([w["in"].clone() for w in walks], host_ops(plain=True),
                         order=plan_b["order"], weights=plan_b["weights"])
    check(all(torch.equal(replay[r], walks[r]["out"]) for r in range(k)),
          "replan b2: the first weighted all-reduce after the flip differs from its replay")
    del walks, replay
    f32 = [r["f32"] for r in ranks]
    check(all(x["same_local"] and x["within"] for x in f32),
          f"replan b: the plan's all-reduce past the flip is not within the f32 limit of the "
          f"rank-order ring's: {f32}")
    check(all(x["mode"] == "sharded" for x in b), "replan b: ZeRO did not shard")
    slack = 8 * len(b[0]["buckets"])  # the async phase's
    for r, x in enumerate(b):
        share = sum(2 * 4 * x["weight"] * total for _, _, total in x["buckets"])
        check(x["state_bytes_after_flip"] <= share + slack,
              f"replan b rank {r}: {x['state_bytes_after_flip']} B of ZeRO state after the "
              f"re-shard, over its weighted share {share:.0f} + {slack}")

    # (c) the two-level plan, its demotion and promotion
    c = legs["c"]
    check(all(x["adopted"] and x["demote_adopted"] and x["promote_adopted"] for x in c),
          "replan c: a round did not adopt")
    def hosts_of(hier):  # a group lists its head first
        return hier is not None and sorted(sorted(g) for g in hier["groups"]) == [[0, 1], [2, 3]]

    check(all(hosts_of(x["first_hier"]) and hosts_of(x["hier"]) for x in c)
          and len({json.dumps(x["first_hier"]) for x in c}) == 1,
          f"replan c: the plan's groups {[(x['first_hier'], x['hier']) for x in c]} are not "
          "the virtual hosts")
    want_demoted = [[RP_C_DEMOTED] if RP_C_DEMOTE <= s < RP_C_PROMOTE else []
                    for s in range(1, RP_C_STEPS + 1)]
    check(all(x["demoted"] == want_demoted for x in c),
          f"replan c: demoted ranks by step {c[0]['demoted']}, want {want_demoted}")
    check(RP_C_PROMOTE < RP_C_STEPS and RP_C_PROMOTE - RP_C_DEMOTE == 2,
          "replan c: the demotion must last two steps and a step must train after the promotion")
    for r, x in enumerate(c):
        kinds = [d["kind"] for d in x["decisions"]]
        check("peer_demoted" in kinds and "peer_promoted" in kinds,
              f"replan c rank {r}: the ledger holds {kinds}")
    walks = [torch.load(RP_OUT / f"c_walk{r}.pt") for r in range(k)]
    check(all(x["capture_step"] == RP_C_FLIP + 1 for x in c),
          "replan c: the first two-level walk was not captured")
    first = c[0]["first_hier"]  # the plan the captured walk ran under
    replay = hier_replay([w["in"].clone() for w in walks], host_ops(plain=True),
                         first["groups"], first["heads"])
    check(all(torch.equal(replay[r], walks[r]["out"]) for r in range(k)),
          "replan c: the first two-level all-reduce differs from its replay")
    dev = resolve_device()
    ins = [w["in"].to(dev) for w in walks]
    card = ins[0] + ins[1] + ins[2] + ins[3]
    abs_sum = sum(x.abs().double() for x in ins)
    bound = 2 * (k - 1) * HOST_F32_ULP * abs_sum + HOST_F32_FLOOR
    err = (replay[0].to(dev).double() - card.double()).abs()
    check(bool((err <= bound).all()),
          f"replan c: the two-level sum is not within the f32 limit of the card's sum "
          f"(max err/bound {float((err / bound).max())})")
    c_err = float((err / bound).max())
    del walks, replay, ins, card, abs_sum, bound, err

    def two_level_wire(x, label):
        """Bytes the rank sent under `label` in the two undemoted two-level
        steps, a step."""
        def total(snap):
            return sum(v for key, v in snap.items() if f"/{label}/" in key)
        return (total(x["wire_two_level"]) - total(x["wire_flat"])) / (RP_C_DEMOTE - RP_C_FLIP)

    def decisions(recs, kind):
        return [{key: d.get(key) for key in ("verdict", "predicted_gain", "realized_gain",
                                             "baseline", "after")}
                for d in recs if d["kind"] == kind]

    emit("replan", nvidia_smi=smi, ranks=k, images_per_rank=OPT_BATCH, lr=RP_LR,
         momentum=RP_MOMENTUM, rate_bytes_per_s=ranks[0]["rate"],
         edge_bytes_per_step=ranks[0]["edge_bytes_per_step"],
         walk_ms={"unshaped": unshaped, "shaped_rank_order": shaped, "after_adoption": after},
         step_ms={leg: [x["step_ms"] for x in recs] for leg, recs in legs.items()},
         median_step_ms_a={"before": max(_rp_median(x["step_ms"][1:at]) for x in a),
                           "after": max(_rp_median(x["step_ms"][at + 1:]) for x in a)},
         adopted_after_step={"a": at, "b": RP_B_FLIP, "c": RP_C_FLIP},
         plan_a=plan_a, plan_b=plan_b,
         matrix_a=a[0]["matrices"][0] if a[0]["matrices"] else None,
         decisions_a=decisions(a[0]["decisions"], "topology_replanned"),
         # the cluster max of the peers' compute fractions each round shared:
         # the clamp on its predicted gain (1 / cf)
         compute_frac_rounds={leg: [rd.get("compute_frac") for rd in recs[0]["rounds"]]
                              for leg, recs in legs.items() if leg != "calib"},
         decisions_c={kind: decisions(c[0]["decisions"], kind)
                      for kind in ("topology_replanned", "peer_demoted", "peer_promoted")},
         rounds={leg: [x["rounds"] for x in recs] for leg, recs in legs.items() if leg != "calib"},
         link_bw_rank1=row1, efficiency={leg: [x["efficiency"] for x in recs]
                                         for leg, recs in legs.items()},
         f32_past_flip=f32, zero_state_after_flip=[x["state_bytes_after_flip"] for x in b],
         zero_weight=[x["weight"] for x in b],
         hier_c=c[0]["hier"], matrix_c=c[0]["matrices"][0] if c[0]["matrices"] else None,
         roles_c=[x["roles"] for x in c], c_err_over_bound=c_err,
         wire_bytes_c_per_step={"heads": first["heads"],
                                "inter_ring": [two_level_wire(x, "RING_SEGMENTED") for x in c],
                                "intra": [two_level_wire(x, "HIER_INTRA") for x in c],
                                "flat_ring": [sum(v for key, v in x["wire_flat"].items()
                                                  if "/RING_SEGMENTED/" in key) / RP_C_FLIP
                                              for x in c]},
         wire_bytes_c_all=[x["wire_bytes"] for x in c], shape_c=c[0]["shape"],
         seconds=time.perf_counter() - t_phase)


FX_RANKS = 4
FX_CALIB_STEPS = 3  # unshaped steps on the step-end path; the shaped edge's rate comes from them
FX_STEPS = 10  # leg (a): shaped steps on the async hook path
FX_LAST = 6  # leg (a)'s gate: the last merged steps that must elect the shaped edge
FX_LR = 0.1
FX_DEADLINE_S = 600  # kfrun -timeout
FX_SIGNAL_WAIT_S = 40  # a worker's wait for its PolicyRunner to read the cluster's election
FX_SWEPT_WAIT_S = 15  # the phase's wait for a sweep past the last step
FX_FLUSH_WAIT_S = 15  # its wait for the survivors' SIGTERM flushes
FX_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_fx"
FX_SCRAPE_INTERVAL = 1.0
# the memory plane's RSS trend over its last KF_TREND_SAMPLES samples, so
# the postmortem's oom_suspected is held over them only: the default 64
# span 32 s, most of leg (a)'s training, whose first step raises RSS by
# ~300 MB (the new epoch's buffer pool) before it stays flat. 12 samples
# are 6 s of 0.5 s snapshots before the kill. Rank 3's RSS drops by tens
# of MB just before its record, then stays within a few pages until its
# kill (the phase prints what the idle added as idle_rss_kb); but the fit
# takes a flat series with one page-sized step in it for a rising trend,
# which the reference's rule reads as an OOM at a SIGKILL
# (tests/test_torch_port_memory.py). So the window must hold that drop:
# rank 3 may idle at most FX_IDLE_MAX_S, a quarter of the window short of it
KF_TREND_SAMPLES = 12
FX_FLIGHT_INTERVAL = 0.5
FX_IDLE_MAX_S = 0.75 * KF_TREND_SAMPLES * FX_FLIGHT_INTERVAL
FX_KNOBS = dict(KF_CONFIG_ALGO="segmented", KF_CONFIG_SEGMENT_MIN_BYTES="0",
                KF_CONFIG_WIRE="off", KF_CONFIG_SHM="0", KF_CONFIG_ASYNC="off",
                KF_TELEMETRY="metrics,trace,audit", KF_FLIGHT_INTERVAL=str(FX_FLIGHT_INTERVAL),
                KF_CLUSTER_SCRAPE_INTERVAL=str(FX_SCRAPE_INTERVAL),
                KF_MEMORY_TREND=str(KF_TREND_SAMPLES))
FX_WIRE = ("RING_SEGMENTED", "off")  # (strategy, codec): the ring's f32 bytes
# the training's collectives: the step-end path's group and the scheduler's
# buckets (a barrier's or a consensus's walk counts under another label)
FX_TRAIN_COLLECTIVES = ("group_all_reduce", "raw")
FX_LAST_WORDS = "forensics rank 3: last words before SIGKILL"
# the memory plane's accountants live in leg (a) on every rank (`scheduler:e<epoch>` the
# async hook path's), and the aggregator's in rank 0's process, whose one-shot
# aggregator reads the workers as `info resources` would
FX_ACCOUNTANTS = ("steptrace", "link_table", "decisions", "scheduler")
FX_SAMPLE_S = 0.2  # the accountants' sampler: their bytes are read this often in leg (a)
FX_PLANE_VIEWS = ("/resources", "/memory", "/cluster/resources", "/cluster/memory")


class _AccountantSampler:
    """Reads every memory-plane accountant each FX_SAMPLE_S on a thread of
    its own and keeps each one's most bytes: the scheduler's in-flight
    payloads exist only inside a step."""

    def __init__(self):
        import threading

        self.most = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="fx-acct-sampler", daemon=True)
        self._thread.start()

    def _loop(self):
        from kungfu_tpu_torch.telemetry import memory as tmem

        while not self._stop.wait(FX_SAMPLE_S):
            for name, nbytes in tmem.tracked_bytes()[1].items():
                self.most[name] = max(nbytes, self.most.get(name, 0))

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(5)
        return dict(self.most)


def _rss_bytes() -> int:
    """This process's resident set, as the memory plane reads it."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


GLIBC_HEAP_ALIGN = 64 << 20  # glibc's HEAP_MAX_SIZE on 64-bit: a thread arena's heap alignment


def _rss_by_mapping(path: str = "/proc/self/smaps") -> dict:
    """This process's resident kB by kind of mapping: `thread_arenas`
    (glibc's malloc heaps of threads other than the main one: anonymous,
    aligned to 64 MiB and at most that long), `main_heap` ([heap], the
    main thread's arena), `other_anon` (every other anonymous mapping:
    pymalloc's arenas, thread stacks, torch's and CUDA's host memory) and
    `files` (file-backed and the kernel's own)."""
    out = {"thread_arenas": 0, "main_heap": 0, "other_anon": 0, "files": 0}
    kind = "files"
    with open(path) as f:
        for line in f:
            head = line.split(None, 5)
            if "-" in head[0] and len(head) >= 5 and not head[0].endswith(":"):
                lo, hi = (int(x, 16) for x in head[0].split("-"))
                name = head[5].strip() if len(head) > 5 else ""
                if name == "[heap]":
                    kind = "main_heap"
                elif name:
                    kind = "files"
                elif lo % GLIBC_HEAP_ALIGN == 0 and hi - lo <= GLIBC_HEAP_ALIGN:
                    kind = "thread_arenas"
                else:
                    kind = "other_anon"
            elif head[0] == "Rss:":
                out[kind] += int(head[1])
    return out


def _fx_planes(rank: int, specs, sampled: dict) -> dict:
    """This rank's resource and memory planes at the end of leg (a): its
    compute fraction (the re-plan's clamp), grow gate, memory-plane age and
    leak verdicts, and its accountants' most bytes. Rank 0 also reads every
    rank's /resources and /memory and the watcher's /cluster/resources and
    /cluster/memory (each timed), then a one-shot aggregator's views of the
    same workers, whose `aggregator` accountant lives in its process."""
    from kungfu_tpu_torch.telemetry import audit, cluster
    from kungfu_tpu_torch.telemetry import memory as tmem
    from kungfu_tpu_torch.telemetry import resource as tres

    rplane, mplane = tres.get_plane(), tmem.get_plane()
    age = time.perf_counter() - mplane._born
    out = {"compute_frac": rplane.compute_frac(), "cores": rplane.cores(),
           "grow_ok": list(mplane.grow_ok()), "limit_bytes": tmem.effective_mem_limit(),
           "memory_age_s": age, "memory_born_wall": time.time() - age,
           "warmup_s": mplane.warmup, "accountants_most": sampled,
           "leak_events": [{"wall_time": r["wall_time"], "detail": r["detail"]}
                           for r in audit.to_json() if r["kind"] == "memory_leak_suspect"]}
    if rank != 0:
        return out
    timing = {view: [] for view in FX_PLANE_VIEWS}
    docs = {"/resources": {}, "/memory": {}}
    for spec in specs:
        base = f"http://127.0.0.1:{int(spec.rsplit(':', 1)[1]) + 10000}"
        for path in ("/resources", "/memory"):
            docs[path][spec] = json.loads(_fx_get(base + path, timing[path]))
    url = os.environ["CHIP_SMOKE_FX_DEBUG"]
    for path in ("/cluster/resources", "/cluster/memory"):
        docs[path] = json.loads(_fx_get(url + path, timing[path]))
    agg = cluster.TelemetryAggregator(interval=FX_SCRAPE_INTERVAL)
    agg.set_peers([(spec, f"http://127.0.0.1:{int(spec.rsplit(':', 1)[1]) + 10000}")
                   for spec in specs])
    try:
        own = {"resources": agg.cluster_resources(), "memory": agg.cluster_memory()}
        own_acct = tmem.tracked_bytes()[1]
    finally:
        agg.stop()
    out.update(views=docs, timing=timing, own_aggregator={
        "peers": {key: sorted(doc["peers"]) for key, doc in own.items()},
        "accountant_bytes": own_acct.get("aggregator", 0)})
    return out


def forensics_worker(out_dir: str) -> int:
    """One worker of the forensics phase under the port's kfrun -w
    -auto-recover -debug-port: ResNet-50 at 16 images of 224² a rank,
    S-SGD over the host plane's segmented f32 ring on sockets. An unshaped
    calibration on the step-end path (KF_CONFIG_ASYNC off) picks the rate
    of the edge rank 1 -> 2; then a cluster epoch with that edge shaped
    and the async hook path on (its flip opens an `async_mode` record in
    the ledger), FX_STEPS steps under a PolicyRunner. Then leg (b): rank 0
    names its pid for the phase's SIGUSR2, rank 3 waits for the phase's
    go and SIGKILLs itself, ranks 0-2 idle until the recovery stops them.
    A survivor the recovery respawns only idles."""
    import signal

    from kungfu_tpu_torch import knobs

    out = Path(out_dir)
    if knobs.raw("KF_INIT_CLUSTER_VERSION") not in ("", "0"):
        time.sleep(FX_DEADLINE_S)  # respawned by the recovery: the phase stops kfrun
        return 0
    import torch

    from kungfu_tpu_torch import resolve_device
    from kungfu_tpu_torch import torch as kf
    from kungfu_tpu_torch.models.resnet import resnet_loss
    from kungfu_tpu_torch.peer import get_default_peer
    from kungfu_tpu_torch.policy import PolicyRunner
    from kungfu_tpu_torch.telemetry import memory as tmem

    _deterministic()
    peer = get_default_peer()
    sess = peer.current_session()
    rank = sess.rank
    specs = [str(p) for p in peer.config.peers]
    device = resolve_device()
    gen = torch.Generator(device=device).manual_seed(1100 + rank)
    batches = [(torch.randn(OPT_BATCH, OPT_SIDE, OPT_SIDE, 3, device=device, dtype=torch.bfloat16,
                            generator=gen),
                torch.randint(0, 1000, (OPT_BATCH,), device=device, generator=gen))
               for _ in range(FX_STEPS)]
    rec = {"rank": rank, "spec": specs[rank]}

    def train(leg, steps, runner=None, tap=None):
        """`steps` S-SGD steps from the seed-0 weights: per step the ms,
        the parameters' digest, the session's ring wire bytes, the walks'
        ms (with `tap`) and, under a PolicyRunner, what its signals say of
        the cluster."""
        sess = peer.current_session()
        model = _resnet50_seed0(device)
        params = list(model.parameters())
        opt = kf.SynchronousSGDOptimizer(torch.optim.SGD(params, lr=FX_LR), name=f"fx{leg}")
        r = {"epoch": sess.cluster_version, "step_ms": [], "digests": [], "wire": [],
             "signals": [], "walk_ms": [], "rss": [], "tracked": []}
        for step in range(steps):
            n_walks = len(tap.walk_ms) if tap is not None else 0
            torch.cuda.synchronize()
            with (runner.step() if runner is not None else contextlib.nullcontext()):
                t0 = time.perf_counter()
                opt.zero_grad()
                resnet_loss(model, batches[step]).backward()
                opt.step()
                torch.cuda.synchronize()
                r["step_ms"].append((time.perf_counter() - t0) * 1e3)
            r["digests"].append(_digest(torch.cat([p.detach().reshape(-1) for p in params])))
            r["wire"].append(sum(v for key, v in sess.wire_bytes.items()
                                 if key[0] in FX_TRAIN_COLLECTIVES and key[1:] == FX_WIRE))
            if tap is not None:
                r["walk_ms"].append(sum(tap.walk_ms[n_walks:]))
            r["rss"].append(_rss_bytes())
            r["tracked"].append(sum(tmem.tracked_bytes()[0].values()))
            if runner is not None:
                m = runner.ctx.metrics
                r["signals"].append({key: m.get(key) for key in (
                    "step/critical_peer", "step/critical_edge", "cluster/updated_at",
                    "step/overlap_frac", "step/queue_delay_frac")})
        return r, sess

    # calibration: the unshaped ring on the step-end path; rank 0 picks the rate
    calib, sess = train("calib", FX_CALIB_STEPS, tap=_RoundTap(sess))
    walk_s = _rp_median(calib["walk_ms"][1:]) / 1e3
    rate = int(calib["wire"][-1] / FX_CALIB_STEPS / (RP_SLOWDOWN * walk_s))
    rate = int(sess.broadcast_bytes(str(rate).encode(), "kungfu::fx:rate").decode())
    rec.update(calib=calib, rate=rate)

    # (a) the edge 1 -> 2 shaped, the async hook path on, a fresh cluster epoch
    os.environ["KF_SHAPE_LINKS"] = f"{specs[1]}>{specs[2]}=bw:{rate}"
    os.environ["KF_CONFIG_ASYNC"] = "on"
    peer.cluster_version += 1
    peer._update_to(peer.config.peers)
    runner = PolicyRunner([], batch_size=OPT_BATCH)
    sampler = _AccountantSampler()
    with runner:
        a, sess = train("a", FX_STEPS, runner)
        sampled = sampler.stop()
        sched = sess.scheduler()
        a["unit_elems"] = [b // 4 for _, b in sorted(sched._unit_bytes.items())]
        sess.barrier(":fx:a")
        # the aggregator merges a round once a newer one exists, and a
        # worker's health cache refreshes every 5 s: read the signals
        # until they name an edge from a refresh after the last step's
        t_end, seen = time.monotonic(), {s["cluster/updated_at"] for s in a["signals"]}
        while time.monotonic() - t_end < FX_SIGNAL_WAIT_S:
            runner._signals_at = 0.0
            runner._pull_cluster_signals()
            m = runner.ctx.metrics
            seen.add(m.get("cluster/updated_at"))
            if m.get("step/critical_edge") and len(seen - {None}) >= 2:
                break
            time.sleep(0.5)
        a["final_signals"] = {key: runner.ctx.metrics.get(key) for key in (
            "step/critical_peer", "step/critical_edge", "cluster/updated_at",
            "cluster/stragglers")}
        a["updated_at_seen"] = sorted(seen - {None})
        a["planes"] = _fx_planes(rank, specs, sampled)
    rec["a"] = a
    rec["written_at"] = time.time()  # rank 3's idle before its kill starts here
    at_record = _rss_by_mapping()
    (out / f"rank{rank}.tmp").write_text(json.dumps(rec))
    (out / f"rank{rank}.tmp").rename(out / f"rank{rank}.json")
    sess.barrier(":fx:written")

    # (b) rank 0 takes the phase's SIGUSR2; then rank 3 SIGKILLs itself
    if rank == 0:
        (out / "usr2_ready").write_text(str(os.getpid()))
    if rank == 3:
        deadline = time.monotonic() + 120
        while not (out / "kill_ok").exists():
            if time.monotonic() > deadline:
                return 1
            time.sleep(0.1)
        print(FX_LAST_WORDS, flush=True)
        time.sleep(0.5)  # the runner's pump reads the line before the kill
        # what its idle added to its RSS, by kind of mapping
        at_kill = _rss_by_mapping()
        (out / "idle_rss_kb.json").write_text(json.dumps(
            {kind: at_kill[kind] - at_record[kind] for kind in at_kill}))
        (out / "kill_at").write_text(repr(time.time()))
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(FX_DEADLINE_S)  # a survivor: the recovery's SIGTERM stops it
    return 1


def _fx_get(url: str, timing=None):
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=30) as r:
        body = r.read()
    if timing is not None:
        timing.append({"ms": (time.perf_counter() - t0) * 1e3, "bytes": len(body)})
    return body.decode()


# the port's `info` commands the forensics phase calls in process, each
# with the watcher's route its --json prints
FX_INFO_ROUTES = {"top": "/cluster/health", "links": "/cluster/links", "steps": "/cluster/steps",
                  "decisions": "/cluster/decisions", "resources": "/cluster/resources",
                  "memory": "/cluster/memory"}
FX_INFO_TRIES = 3  # reads of a route a sweep may land between


def _info(argv) -> tuple:
    """(exit code, stdout) of the port's `python -m kungfu_tpu_torch.info`
    called in process, through its entry function."""
    import io

    from kungfu_tpu_torch.info import __main__ as info

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            info.main(list(argv))
            rc = 0
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


def _stable_diff(before, got, after, path: str = "") -> list:
    """The paths where `got` differs from `before` though `before` and
    `after` (two reads around it) agree there: a field that moved between
    the two reads is left out, every other field must be equal."""
    if before == after:
        return [] if got == before else [path or "/"]
    if isinstance(before, dict) and isinstance(after, dict):
        if set(before) != set(after):
            return []
        if not isinstance(got, dict) or set(got) != set(before):
            return [f"{path}/{{keys}}"]
        return [d for key in before
                for d in _stable_diff(before[key], got[key], after[key], f"{path}/{key}")]
    if isinstance(before, list) and isinstance(after, list) and len(before) == len(after):
        if not isinstance(got, list) or len(got) != len(before):
            return [f"{path}[len]"]
        return [d for i, (b, g, a) in enumerate(zip(before, got, after))
                for d in _stable_diff(b, g, a, f"{path}[{i}]")]
    return []


def _fx_info_views(url: str) -> dict:
    """Each `info` command in process while the watcher serves /cluster/*:
    its --json document between two reads of the same route by the phase
    (FX_INFO_TRIES times at most, while a field that held still differs),
    then its rendered frame."""
    views = {}
    for cmd, route in FX_INFO_ROUTES.items():
        for attempt in range(1, FX_INFO_TRIES + 1):
            before = json.loads(_fx_get(url + route))
            t0 = time.perf_counter()
            rc, text = _info([cmd, "--json", url])
            ms = (time.perf_counter() - t0) * 1e3
            after = json.loads(_fx_get(url + route))
            diff = _stable_diff(before, json.loads(text), after) if rc == 0 else ["(none)"]
            if not diff:
                break
        rendered_rc, rendered = _info([cmd, url])
        views[cmd] = {"rc": rc, "json_ms": ms, "json_bytes": len(text), "json_diff": diff,
                      "tries": attempt, "doc": after, "rendered_rc": rendered_rc,
                      "rendered": rendered}
    return views


def _fx_info_gates(specs, info, steps_doc) -> dict:
    """The `info` commands' gates: each exits 0; its --json document is
    the phase's read of the same route up to the fields that moved
    between two reads; each frame names every rank, the top, links and
    steps frames the shaped edge 1 -> 2 the phase elects, the steps frame
    the count of merged steps the phase read, the decisions frame every
    rank's async_mode record. Returns what the phase's line prints."""
    for cmd, v in info.items():
        check(v["rc"] == 0 and v["rendered_rc"] == 0,
              f"forensics: info {cmd} exited {v['rc']} (--json), {v['rendered_rc']}")
        check(not v["json_diff"], f"forensics: info {cmd} --json differs from the phase's read "
              f"of {FX_INFO_ROUTES[cmd]} at {v['json_diff'][:8]}")
        missing = [spec for spec in specs if spec not in v["rendered"]]
        check(not missing, f"forensics: info {cmd} does not name {missing}:\n{v['rendered']}")
    top, links, steps = (info[c]["rendered"] for c in ("top", "links", "steps"))
    check(f"last step critical: {specs[1]} →{specs[2]}" in top,
          f"forensics: info top does not name the shaped edge:\n{top}")
    peers = info["links"]["doc"]["peers"]
    check(f"slowest edge [{peers.index(specs[1])}]→[{peers.index(specs[2])}]" in links,
          f"forensics: info links' slowest edge is not the shaped one:\n{links}")
    n = len(steps_doc["steps"])
    check(len(info["steps"]["doc"]["steps"]) == n
          and steps.startswith(f"{n} merged steps on record, showing {min(n, 8)}")
          and f"critical {specs[1]} bucket" in steps and f"edge →{specs[2]}" in steps
          and f"  *{specs[1]}  |" in steps,
          f"forensics: info steps does not show the phase's {n} merged steps electing the "
          f"shaped edge:\n{steps}")
    dec = info["decisions"]
    check(dec["rendered"].startswith(f"{len(dec['doc']['decisions'])} adaptation decision(s)")
          and all(f"  {spec}  e" in dec["rendered"] for spec in specs)
          and "async_mode" in dec["rendered"],
          f"forensics: info decisions lacks the ranks' async_mode records:\n{dec['rendered']}")
    return {cmd: {"json_ms": v["json_ms"], "json_bytes": v["json_bytes"], "tries": v["tries"],
                  "rendered_lines": len(v["rendered"].splitlines())} for cmd, v in info.items()}


def _fx_wire(cluster_metrics: str) -> dict:
    """The training's ring bytes by peer label in /cluster/metrics."""
    from kungfu_tpu_torch.telemetry import promparse

    wire = {}
    for s in promparse.parse_text(cluster_metrics):
        labels = dict(s.labels)
        if s.name == "kungfu_collective_wire_bytes_total" \
                and labels.get("collective") in FX_TRAIN_COLLECTIVES \
                and (labels.get("strategy"), labels.get("codec")) == FX_WIRE:
            wire[labels["peer"]] = wire.get(labels["peer"], 0) + s.value
    return wire


def _fx_wait_swept(url: str, ranks, steptraces) -> None:
    """Wait until a sweep after the last step has reached the cluster's
    views: /cluster/metrics holds each rank's own ring bytes, and
    /cluster/steps has merged the round before the ranks' last one (the
    aggregator holds the newest round back until a newer one exists)."""
    epoch = ranks[0]["a"]["epoch"]
    last = max(t["round"] for doc in steptraces for t in doc["timelines"] if t["epoch"] == epoch)
    own = {r["spec"]: r["calib"]["wire"][-1] + r["a"]["wire"][-1] for r in ranks}
    t0 = time.monotonic()
    while True:
        merged = [s["round"] for s in json.loads(_fx_get(url + "/cluster/steps"))["steps"]
                  if s["epoch"] == epoch]
        if merged and merged[-1] >= last - 1 and _fx_wire(_fx_get(url + "/cluster/metrics")) == own:
            return
        check(time.monotonic() - t0 < FX_SWEPT_WAIT_S,
              f"forensics: no sweep merged round {last - 1} (merged {merged[-3:]}) and the ranks' "
              f"ring bytes {own} within {FX_SWEPT_WAIT_S} s")
        time.sleep(0.1)


def forensics_phase(smi: str) -> None:
    """Run-level forensics on the card: 4 workers of this script
    (`--forensics-worker`) on card 0 under the port's kfrun `-w
    -auto-recover 30s -builtin-config-port 0 -debug-port` train ResNet-50
    at 16 images of 224² a rank by S-SGD over the host plane (metrics,
    trace and audit on, a flight snapshot every 0.5 s, the aggregator
    sweeping every 1 s; the run dir under build/chip_smoke_fx/run). (a)
    After an unshaped calibration the edge rank 1 -> 2 is shaped to 4x the
    unshaped walk, 10 steps on the async hook path (2 buckets); (b) the
    phase sends rank 0 a SIGUSR2, rank 3 SIGKILLs itself, the phase waits
    for its postmortem on /cluster/postmortem and stops kfrun with
    SIGTERM."""
    import shutil
    import signal

    from kungfu_tpu_torch.runner.cli import free_port_range, free_ports
    from kungfu_tpu_torch.telemetry import flight

    t_phase = time.perf_counter()
    k = FX_RANKS
    shutil.rmtree(FX_OUT, ignore_errors=True)
    FX_OUT.mkdir(parents=True)
    run_dir = FX_OUT / "run"
    base = free_port_range(k)
    runner_port, debug_port = free_ports(2)
    specs = [f"127.0.0.1:{base + i}" for i in range(k)]
    env = {key: v for key, v in os.environ.items() if not key.startswith("KF_")}
    url = f"http://127.0.0.1:{debug_port}"
    env.update(FX_KNOBS, KF_TELEMETRY_DIR=str(run_dir), CUBLAS_WORKSPACE_CONFIG=":4096:8",
               CHIP_SMOKE_FX_DEBUG=url)
    here = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "kungfu_tpu_torch.runner.cli", "-np", str(k), "-H",
           f"127.0.0.1:{k}", "-w", "-auto-recover", "30s", "-builtin-config-port", "0",
           "-debug-port", str(debug_port), "-port-range", f"{base}-{base + k - 1}",
           "-runner-port", str(runner_port), "-monitor-port", "0", "-warm-spares", "0",
           "-timeout", str(FX_DEADLINE_S), sys.executable, "chip_smoke.py",
           "--forensics-worker", str(FX_OUT)]
    log_out, log_err = (FX_OUT / "kfrun.out").open("w"), (FX_OUT / "kfrun.err").open("w")
    p = subprocess.Popen(cmd, cwd=here, env=env, stdout=log_out, stderr=log_err)
    timing = {"/steptrace": [], "/cluster/steps": [], "/cluster/health": []}
    health_during = []

    def alive(what):
        check(p.poll() is None, f"forensics: kfrun exited {p.returncode} {what}; its log is "
              f"{FX_OUT / 'kfrun.err'}:\n{(FX_OUT / 'kfrun.err').read_text()[-3000:]}")

    try:
        # leg (a): the cluster's views while the workers train
        deadline = time.monotonic() + FX_DEADLINE_S
        # the records are looked for every 0.1 s, the views read every
        # FX_SCRAPE_INTERVAL: rank 3 idles from its record to its kill, and
        # the postmortem's RSS trend covers only the last KF_MEMORY_TREND
        # snapshots of that
        next_scrape = 0.0
        while not all((FX_OUT / f"rank{r}.json").exists() for r in range(k)):
            alive("before leg (a) ended")
            check(time.monotonic() < deadline, "forensics: leg (a) did not end")
            if time.monotonic() >= next_scrape:
                next_scrape = time.monotonic() + FX_SCRAPE_INTERVAL
                try:
                    health_during.append(json.loads(_fx_get(url + "/cluster/health",
                                                             timing["/cluster/health"])))
                    _fx_get(url + "/cluster/steps", timing["/cluster/steps"])
                except OSError:
                    pass  # the debug endpoint comes up with kfrun
            time.sleep(0.1)
        ranks = [json.loads((FX_OUT / f"rank{r}.json").read_text()) for r in range(k)]
        steptraces = []
        for spec in specs:
            port = int(spec.rsplit(":", 1)[1]) + 10000
            for _ in range(3):
                doc = json.loads(_fx_get(f"http://127.0.0.1:{port}/steptrace",
                                         timing["/steptrace"]))
            steptraces.append(doc)
        _fx_wait_swept(url, ranks, steptraces)
        for _ in range(3):
            steps_doc = json.loads(_fx_get(url + "/cluster/steps", timing["/cluster/steps"]))
            health_after = json.loads(_fx_get(url + "/cluster/health",
                                              timing["/cluster/health"]))
        cluster_metrics = _fx_get(url + "/cluster/metrics")
        info = _fx_info_views(url)  # the port's info CLI on the same routes

        # leg (b): SIGUSR2 to rank 0, then rank 3's SIGKILL and its postmortem
        t0 = time.monotonic()
        while not (FX_OUT / "usr2_ready").exists():
            alive("before rank 0 named its pid")
            check(time.monotonic() - t0 < 60, "forensics: rank 0 never named its pid")
            time.sleep(0.1)
        os.kill(int((FX_OUT / "usr2_ready").read_text()), signal.SIGUSR2)
        dir0 = flight.peer_dir(str(run_dir), specs[0])
        t0 = time.monotonic()
        while not any(r.get("kind") == "dump" for r in flight.read_journal(dir0)[0]):
            check(time.monotonic() - t0 < 30, "forensics: no dump record after SIGUSR2")
            time.sleep(0.1)
        (FX_OUT / "kill_ok").write_text("go")
        t0 = time.monotonic()
        while True:
            alive("before the postmortem showed")
            check(time.monotonic() - t0 < 120, "forensics: no postmortem on /cluster/postmortem")
            pms = json.loads(_fx_get(url + "/cluster/postmortem"))
            if pms["deaths"]:
                t_seen = time.time()
                break
            time.sleep(0.1)
        audit_doc = json.loads(_fx_get(url + "/cluster/audit"))
        p.terminate()  # kfrun dies; kf-pdeathsig sends every worker SIGTERM
        p.wait(60)
        # the survivors' SIGTERM flushes: each journal's last record
        t0 = time.monotonic()
        while time.monotonic() - t0 < FX_FLUSH_WAIT_S and not all(
                (flight.read_journal(flight.peer_dir(str(run_dir), spec))[0] or [{}])[-1]
                .get("kind") == "exit" for spec in specs[:3]):
            time.sleep(0.1)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(30)
        log_out.close()
        log_err.close()
    views = dict(specs=specs, steptraces=steptraces, steps_doc=steps_doc,
                 health_during=health_during, health_after=health_after,
                 cluster_metrics=cluster_metrics, pms=pms, audit_doc=audit_doc, t_seen=t_seen,
                 timing=timing, info_views=info)
    (FX_OUT / "views.json").write_text(json.dumps(views))  # what the gates read, for a look
    forensics_gates(smi, ranks=ranks, t_phase=t_phase, **views)


def forensics_gates(smi, specs, ranks, steptraces, steps_doc, health_during, health_after,
                    cluster_metrics, pms, audit_doc, t_seen, timing, t_phase,
                    info_views) -> None:
    """The forensics phase's gates and its line, from the workers' records
    and the views the phase read (`views.json` in FX_OUT)."""
    import statistics

    from kungfu_tpu_torch.telemetry import flight

    k = len(specs)
    run_dir = str(FX_OUT / "run")
    for leg in ("calib", "a"):
        check(len({tuple(r[leg]["digests"]) for r in ranks}) == 1,
              f"forensics {leg}: the ranks' parameters differ after some step")
    epoch = ranks[0]["a"]["epoch"]
    units = ranks[0]["a"]["unit_elems"]
    check(len(units) == 2 and all(r["a"]["unit_elems"] == units for r in ranks),
          f"forensics: the scheduler's buckets {units} are not 2 alike on every rank")

    # every rank's /steptrace: one timeline a sampled round, a lane a bucket
    rounds_all = []
    for r, doc in enumerate(steptraces):
        tls = [t for t in doc["timelines"] if t["epoch"] == epoch]
        rounds = [t["round"] for t in tls]
        rounds_all.append(rounds)
        check(len(rounds) >= FX_STEPS - 2 and rounds == list(range(rounds[0], rounds[0] + len(rounds))),
              f"forensics rank {r}: /steptrace rounds {rounds}")
        for t in tls:
            lanes = t["buckets"]
            check([b["index"] for b in lanes] == list(range(len(units)))
                  and all(b["walk_us"] > 0 and b["t_walk_us"] is not None
                          and b["edge"] == specs[(r + 1) % k] for b in lanes)
                  and 0 <= t["overlap_frac"] <= 1 and 0 <= t["queue_delay_frac"] <= 1,
                  f"forensics rank {r} round {t['round']}: lanes {lanes}")
    # /cluster/steps: the shaped edge elected in each of the last FX_LAST steps
    merged = [s for s in steps_doc["steps"] if s["epoch"] == epoch]
    last = merged[-FX_LAST:]
    check(len(last) == FX_LAST and all(
        (s["critical"] or {}).get("peer") == specs[1]
        and (s["critical"] or {}).get("edge") == specs[2] for s in last),
        f"forensics: the last merged steps elect {[s['critical'] for s in last]}")
    check(all(0 <= s["overlap_frac"] <= 1 and 0 <= s["queue_delay_frac"] <= 1 for s in merged),
          "forensics: a merged step's overlap or queue-delay fraction is outside [0, 1]")
    # /cluster/health while the workers trained: every peer stepping
    live = [h for h in health_during if sorted(h["peers"]) == sorted(specs) and all(
        (info["step_rate"] or 0) > 0 for info in h["peers"].values())
        and (h.get("steps") or {}).get("critical_edge")]
    check(bool(live), "forensics: no /cluster/health during leg (a) had every peer stepping")
    health = live[-1]
    for label, info in health["peers"].items():
        check(info["step_time_p50_ms"] <= info["step_time_p99_ms"],
              f"forensics: {label}'s step p50 {info['step_time_p50_ms']} over its p99")
    check((health["steps"]["critical_peer"], health["steps"]["critical_edge"])
          == (specs[1], specs[2]), f"forensics: /cluster/health's steps {health['steps']}")
    # every rank's PolicyRunner read the election, from advancing refreshes
    for r in ranks:
        fin = r["a"]["final_signals"]
        check(fin["step/critical_edge"] == specs[2] and fin["step/critical_peer"] == specs[1]
              and len(r["a"]["updated_at_seen"]) >= 2,
              f"forensics rank {r['rank']}: ctx.metrics {fin}, refreshes "
              f"{r['a']['updated_at_seen']}")
    # /cluster/metrics: each rank's ring bytes under its peer label, exactly
    wire = _fx_wire(cluster_metrics)
    want = {specs[r]: _ring_bytes_total(units, k, r) for r in range(k)}
    own = {r["spec"]: r["calib"]["wire"][-1] + r["a"]["wire"][-1] for r in ranks}
    check(wire == want == own, f"forensics: ring wire bytes under peer= labels {wire}, the "
          f"workers' own {own}, the formula {want}")
    for r in ranks:
        per_step = sum(_ring_bytes(n, k, r["rank"]) for n in units)
        for leg in ("calib", "a"):
            w = r[leg]["wire"]
            deltas = [b - a for a, b in zip([0] + w, w)]
            check(deltas == [per_step] * len(w),
                  f"forensics {leg} rank {r['rank']}: ring bytes a step {deltas}, the formula "
                  f"gives {per_step}")

    # (b) the postmortem at every surface
    dead = specs[3]
    check(pms["deaths"] == 1 and list(pms["peers"]) == [dead],
          f"forensics: /cluster/postmortem holds {list(pms['peers'])}")
    pm = pms["peers"][dead][0]
    check(pm["death"] == "signal SIGKILL (-9)" and pm["clean_exit"] is False,
          f"forensics: the postmortem says {pm['death']}, clean_exit {pm['clean_exit']}")
    check(pm["last_step"] is not None and FX_STEPS - 1 <= pm["last_step"] <= FX_STEPS,
          f"forensics: the postmortem's last step {pm['last_step']}")
    check(any(FX_LAST_WORDS in line for line in pm["output_tail"]),
          "forensics: the postmortem's output tail lacks rank 3's last line")
    check(bool(pm["last_step_timeline"]) and pm["last_step_timeline"]["buckets"]
          and "async_mode" in [d["kind"] for d in pm["last_decisions"]],
          "forensics: the postmortem lacks the step ring or the ledger's tail")
    jsonl = flight.read_postmortems(run_dir)
    runner_pms = [rec for rec in audit_doc if rec["kind"] == "worker_postmortem"]
    check([x["peer"] for x in jsonl] == [dead] and len(runner_pms) == 1
          and runner_pms[0]["peer"] == dead,
          f"forensics: postmortems.jsonl {[x['peer'] for x in jsonl]}, runner audit "
          f"{runner_pms}")
    text = flight.render_postmortem(pm)
    check("SIGKILL" in text and f"last step: {int(pm['last_step'])}" in text
          and "final CPU attribution" in text and "final memory attribution" in text,
          "forensics: the rendered postmortem names neither the signal nor the last step, "
          "or lacks the planes' attribution")
    planes = _fx_plane_gates(specs, ranks, pm)
    info_line = _fx_info_gates(specs, info_views, steps_doc)
    # `info postmortem <run dir>` names the dead rank and the cause the gates above read
    rc, pm_text = _info(["postmortem", run_dir])
    check(rc == 0 and pm_text.startswith("1 worker death(s) on record")
          and f"== postmortem: {dead} ==" in pm_text and f"died: {pm['death']}" in pm_text
          and f"last step: {int(pm['last_step'])}" in pm_text,
          f"forensics: info postmortem {run_dir} exited {rc}:\n{pm_text[:3000]}")
    info_line["postmortem"] = {"lines": len(pm_text.splitlines()), "death": pm["death"]}
    journals = {}
    for r, spec in enumerate(specs):
        recs, errors = flight.read_journal(flight.peer_dir(run_dir, spec))
        kinds = [x["kind"] for x in recs]
        jdir = Path(flight.peer_dir(run_dir, spec))
        journals[spec] = {"bytes": sum(f.stat().st_size for f in jdir.glob("journal*.bin")),
                          "snapshots": kinds.count("snapshot"), "records": len(recs),
                          "errors": errors, "last": kinds[-1] if kinds else None}
        if r < 3:
            check(errors == [] and recs[-1]["kind"] == "exit" and recs[-1]["reason"] == "sigterm",
                  f"forensics: survivor {spec}'s journal ends {recs[-1] if recs else None}, "
                  f"errors {errors}")
    recs0 = flight.read_journal(flight.peer_dir(run_dir, specs[0]))[0]
    check(any(x["kind"] == "dump" and x.get("reason") == "sigusr2" for x in recs0),
          "forensics: rank 0's journal holds no SIGUSR2 dump")

    # the kill -> postmortem split: detection is the rest once the harvest
    # (timed again here on the same dir and tail) is taken out
    kill_at = float((FX_OUT / "kill_at").read_text())
    t0 = time.perf_counter()
    flight.harvest_postmortem(run_dir, dead, exit_code=-9, output_tail=pm["output_tail"])
    harvest_ms = (time.perf_counter() - t0) * 1e3
    recorded_ms = (runner_pms[0]["wall_time"] - kill_at) * 1e3

    def med(xs):
        return statistics.median(xs) if xs else None

    def scrape(ep):
        # the last scrape is after leg (a), with every merged step in the views
        return {"median_ms": med([x["ms"] for x in timing[ep]]),
                "max_ms": max([x["ms"] for x in timing[ep]], default=None),
                "median_bytes": med([x["bytes"] for x in timing[ep]]), "n": len(timing[ep]),
                "last_ms": timing[ep][-1]["ms"], "last_bytes": timing[ep][-1]["bytes"]}

    step_ms = [r["a"]["step_ms"][2:] for r in ranks]  # past the step-end path and registration
    sweeps = [h["plane"]["sweep_seconds"] for h in health_during + [health_after]
              if (h.get("plane") or {}).get("sweep_seconds") is not None]
    emit("forensics", nvidia_smi=smi, ranks=k, images_per_rank=OPT_BATCH, steps=FX_STEPS,
         calib_steps=FX_CALIB_STEPS, rate_bytes_per_s=ranks[0]["rate"], buckets=len(units),
         step_ms={"median": med([x for s in step_ms for x in s]),
                  "min": min(x for s in step_ms for x in s),
                  "max": max(x for s in step_ms for x in s),
                  "slowest_rank_median": max(med(s) for s in step_ms)},
         calib_step_ms=[r["calib"]["step_ms"] for r in ranks],
         critical={"peer": specs[1], "edge": specs[2],
                   "ms": [round((s["critical"]["self_us"] or 0) / 1e3, 3) for s in last]},
         overlap_frac=[s["overlap_frac"] for s in last],
         queue_delay_frac=[s["queue_delay_frac"] for s in last],
         merged_steps=len(merged), rounds_per_rank=[len(x) for x in rounds_all],
         scrape={ep: scrape(ep) for ep in timing},
         aggregator_sweep_s={"median": med(sweeps), "max": max(sweeps, default=None)},
         health_snapshots=len(health_during), wire_bytes=wire, journals=journals,
         kill_to_postmortem_ms={"recorded": recorded_ms, "harvest": harvest_ms,
                                "detection": recorded_ms - harvest_ms,
                                "seen_by_phase": (t_seen - kill_at) * 1e3},
         postmortem={"last_step": pm["last_step"], "journal_records": pm["journal_records"],
                     "last_record_age_s": pm["last_record_age_s"],
                     "output_tail_lines": len(pm["output_tail"]),
                     "decisions": [d["kind"] for d in pm["last_decisions"]]},
         planes=planes, info=info_line, seconds=time.perf_counter() - t_phase)


def _fx_plane_gates(specs, ranks, pm) -> dict:
    """The resource and memory planes' gates of the forensics phase, from
    what rank 0 read during leg (a), each rank's own record and rank 3's
    postmortem; returns what the phase's line prints of them."""
    import statistics

    from kungfu_tpu_torch.telemetry import flight

    planes = [r["a"]["planes"] for r in ranks]
    p0 = planes[0]
    views, timing = p0["views"], p0["timing"]
    for path in ("/cluster/resources", "/cluster/memory"):
        doc = views[path]
        check(doc["count"] == len(specs) and sorted(doc["peers"]) == sorted(specs),
              f"forensics: {path} lists {sorted(doc['peers'])}, not the 4 workers")
        check(all(row.get("supported") for row in doc["peers"].values()),
              f"forensics: a peer of {path} is unsupported")
    check(all(sorted(peers) == sorted(specs) for peers in p0["own_aggregator"]["peers"].values()),
          f"forensics: rank 0's aggregator lists {p0['own_aggregator']['peers']}")
    per_rank = []
    for r, (spec, mine) in enumerate(zip(specs, planes)):
        res, mem = views["/resources"][spec], views["/memory"][spec]
        cpu = {b: res["buckets"][b]["cpu_s"] for b in res["buckets"]}
        check(res["supported"] and cpu["train"] > 0 and cpu["walk_compute"] > 0
              and cpu["codec"] + cpu["sched"] > 0,
              f"forensics rank {r}: CPU seconds by bucket {cpu}: none in main or the "
              "kf-sched-* threads")
        check(mem["supported"] and 0 < mem["rss_bytes"] < mem["limit_bytes"]
              and mem["limit_bytes"] == mine["limit_bytes"],
              f"forensics rank {r}: rss {mem['rss_bytes']} B against the limit "
              f"{mem['limit_bytes']} (effective_mem_limit {mine['limit_bytes']})")
        most = mine["accountants_most"]
        live = {name: max([v for key, v in most.items() if key.split(":")[0] == name],
                          default=0) for name in FX_ACCOUNTANTS}
        check(all(v > 0 for v in live.values()),
              f"forensics rank {r}: accountants' most bytes in leg (a) {live}")
        check(mine["grow_ok"][0], f"forensics rank {r}: grow_ok() is {mine['grow_ok']}")
        # the watchdog arms after the warm-up; a verdict at any time fails
        check(not mine["leak_events"] and not mem["leak_suspects"],
              f"forensics rank {r}: a leak verdict in leg (a): {mine['leak_events']}, "
              f"{mem['leak_suspects']}")
        per_rank.append({
            "compute_frac": mine["compute_frac"], "cores": mine["cores"],
            "cpu_frac": res["cpu_frac"], "engine_frac": res["engine_frac"], "cpu_s": cpu,
            "rss_bytes": mem["rss_bytes"], "limit_bytes": mem["limit_bytes"],
            "headroom_frac": mem["headroom_frac"], "untracked_frac":
                mem["buckets"]["untracked"]["frac"], "tracked_bytes": mem["accountants"],
            "accountants_most": live, "leak_suspects": mem["leak_suspects"],
            "memory_age_s": mine["memory_age_s"],
            "leak_armed_s": max(0.0, mine["memory_age_s"] - mine["warmup_s"]),
            "grow_ok": mine["grow_ok"],
            # RSS and the accountants' sum after each step, calibration then leg (a)
            "rss_mb_by_step": [round(x / 1e6, 1) for x in ranks[r]["calib"]["rss"]
                               + ranks[r]["a"]["rss"]],
            "tracked_mb_by_step": [round(x / 1e6, 1) for x in ranks[r]["calib"]["tracked"]
                                   + ranks[r]["a"]["tracked"]]})
    check(p0["own_aggregator"]["accountant_bytes"] > 0,
          f"forensics: the aggregator's accountant reads "
          f"{p0['own_aggregator']['accountant_bytes']} B")
    check(pm["last_resources"] is not None and pm["last_memory"] is not None,
          f"forensics: rank 3's postmortem: its last snapshot's planes "
          f"{pm['last_resources'] is not None}, {pm['last_memory'] is not None}")
    # KF_MEMORY_TREND (FX_KNOBS): the verdict reads the RSS trend over the
    # last KF_TREND_SAMPLES snapshots before the kill, not over leg (a)'s training
    kill_at = float((FX_OUT / "kill_at").read_text())
    snaps = [x["memory"] for x in flight.read_journal(flight.peer_dir(str(FX_OUT / "run"),
                                                                       specs[3]))[0]
             if x.get("kind") == "snapshot" and x.get("memory")][-2 * KF_TREND_SAMPLES:]
    rss_tail = [[round(m["wall_time_s"] - kill_at, 2), m["rss_bytes"],
                 m.get("trend_bytes_per_s")] for m in snaps]
    idle = kill_at - ranks[3]["written_at"]
    idle_rss_kb = json.loads((FX_OUT / "idle_rss_kb.json").read_text())
    check(idle <= FX_IDLE_MAX_S,
          f"forensics: rank 3 idled {idle:.2f} s from its record to its kill, past the "
          f"{FX_IDLE_MAX_S} s that keep its drop in RSS at the record inside the postmortem's "
          f"{KF_TREND_SAMPLES} x {FX_FLIGHT_INTERVAL} s trend window (a slow host?); without "
          f"the drop the idle creep ({idle_rss_kb} kB) would read as an OOM")
    check(pm["oom_suspected"] is False,
          f"forensics: rank 3's postmortem says oom_suspected over its last {KF_TREND_SAMPLES} "
          f"memory samples (trend {pm['last_memory'].get('trend_bytes_per_s')} B/s; idle "
          f"{idle:.2f} s; [s to the kill, RSS, trend]: {rss_tail})")
    check(not pm["last_memory"]["leak_suspects"],
          f"forensics: rank 3's last snapshot names leak suspects "
          f"{pm['last_memory']['leak_suspects']}")
    born3 = planes[3]["memory_born_wall"]
    return {"ranks": per_rank, "aggregator_bytes": p0["own_aggregator"]["accountant_bytes"],
            "scrape": {view: {"median_ms": statistics.median(x["ms"] for x in timing[view]),
                              "median_bytes": statistics.median(x["bytes"]
                                                                for x in timing[view]),
                              "n": len(timing[view])} for view in FX_PLANE_VIEWS},
            "postmortem": {"oom_suspected": pm["oom_suspected"], "trend_samples": KF_TREND_SAMPLES,
                           "leak_armed_s": max(0.0, pm["last_memory"]["wall_time_s"] - born3
                                               - planes[3]["warmup_s"]),
                           "rss_bytes": pm["last_memory"]["rss_bytes"],
                           "trend_bytes_per_s": pm["last_memory"]["trend_bytes_per_s"],
                           "cpu_frac": pm["last_resources"]["cpu_frac"],
                           # idle from its record to the kill, what it added to
                           # the RSS by kind of mapping; its last snapshots' RSS
                           "idle_s": idle, "idle_rss_kb": idle_rss_kb, "rss_tail": rss_tail}}


def _ring_bytes_total(units, k: int, rank: int) -> int:
    """The segmented ring's f32 bytes `rank` sends over the phase: every
    step (calibration and leg (a)) walks the same 2 buckets."""
    return (FX_CALIB_STEPS + FX_STEPS) * sum(_ring_bytes(n, k, rank) for n in units)


ELASTIC_SCHEDULE = "2:2,4:2,2:2"  # workers: steps
ELASTIC_SIZES = [2, 2, 4, 4, 2, 2]
ELASTIC_BATCH = 16  # images a rank a step, 224x224
ELASTIC_SAMPLES = 64  # a small synthetic set the run cycles over (seed 0)
ELASTIC_CLASSES = 10  # its labels, each with an image pattern of its own
ELASTIC_LR, ELASTIC_MOMENTUM = 0.05, 0.9
ELASTIC_DEADLINE_S = 500
ELASTIC_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_elastic"


def _elastic_data():
    """ELASTIC_SAMPLES uint8 images of 224x224x3 from numpy seed 0, each a
    noisy copy of its class's pattern, and their labels."""
    import numpy as np

    rng = np.random.default_rng(0)
    labels = rng.integers(0, ELASTIC_CLASSES, ELASTIC_SAMPLES)
    patterns = rng.integers(0, 256, (ELASTIC_CLASSES, OPT_SIDE, OPT_SIDE, 3))
    noise = rng.integers(-48, 49, (ELASTIC_SAMPLES, OPT_SIDE, OPT_SIDE, 3))
    images = np.clip(patterns[labels] + noise, 0, 255).astype(np.uint8)
    return images, labels.astype(np.int64)


def _ssgd_step(model, opt, grads, stats, batch, size: int, name: str):
    """One ResNet-50 S-SGD step over the host plane: the gradients, the
    float running statistics and the loss, fused into one buffer,
    averaged by one host all-reduce named `name` and copied back; then
    the optimizer's step. Returns the averaged loss and the clock
    readings just before and just after the all-reduce."""
    import torch

    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.models.resnet import resnet_loss
    from kungfu_tpu_torch.ops.collective import defuse

    opt.zero_grad(set_to_none=False)
    loss = resnet_loss(model, batch)
    loss.backward()
    fused = torch.cat([p.grad.reshape(-1) for p in grads]
                      + [b.reshape(-1) for b in stats] + [loss.detach().reshape(1)])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    avg = api.all_reduce_array(fused, name=name) / size
    t2 = time.perf_counter()  # all_reduce_array returns once its copy back ended
    parts = defuse(avg, [p.shape for p in grads] + [b.shape for b in stats] + [(1,)])
    with torch.no_grad():
        for p, g in zip(grads, parts):
            p.grad.copy_(g)
        for b, v in zip(stats, parts[len(grads):]):
            b.copy_(v)
    opt.step()
    return float(parts[-1]), t1, t2


def elastic_worker() -> int:
    """One worker of the elastic phase, started by the port's kfrun (cold,
    or as an activated warm standby): ResNet-50 S-SGD with momentum over
    the host plane under ElasticState, the sizes proposed by a
    StepBasedSchedule on rank 0 through kfrun's config server."""
    import hashlib

    import torch

    from kungfu_tpu_torch import api, knobs, resolve_device
    from kungfu_tpu_torch.elastic import ElasticDataset, ElasticState, StepBasedSchedule
    from kungfu_tpu_torch.peer import finalize_default_peer
    from kungfu_tpu_torch.utils import trace

    spec = knobs.raw("KF_SELF_SPEC")
    out = {"spec": spec, "standby": bool(knobs.raw("KF_ACTIVATED_TS")), "steps": []}
    try:
        total = sum(n * ELASTIC_BATCH * steps
                    for n, steps in [tuple(map(int, e.split(":")))
                                     for e in ELASTIC_SCHEDULE.split(",")])
        es = ElasticState(max_progress=total)  # starts this worker's Peer
        peer = es._peer
        startup = [d for _, _, d in trace.events("worker.startup")]
        out["startup_ms"] = startup[0] * 1e3 if startup else None
        device = resolve_device()
        images, labels = _elastic_data()
        ds = ElasticDataset([images, labels], ELASTIC_BATCH, seed=1)
        model = _resnet50_seed0(device)
        params = dict(model.named_parameters())
        buffers = dict(model.named_buffers())
        opt = torch.optim.SGD(list(params.values()), lr=ELASTIC_LR, momentum=ELASTIC_MOMENTUM)
        for p in params.values():  # momentum leaves from the start, for the state sync
            opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        momentum = {k: opt.state[p]["momentum_buffer"] for k, p in params.items()}
        step = torch.zeros(1, dtype=torch.int64)  # the schedule's step index, synced to joiners
        state = {"params": params, "buffers": buffers, "momentum": momentum, "step": step}

        @torch.no_grad()
        def set_state(tree):
            for part in ("params", "buffers", "momentum"):
                for k, v in tree[part].items():
                    state[part][k].copy_(v)
            step.copy_(tree["step"])

        def digest() -> str:
            h = hashlib.sha256()
            for part in ("params", "buffers", "momentum"):
                flat = torch.cat([state[part][k].detach().reshape(-1).float()
                                  for k in sorted(state[part])])
                h.update(flat.cpu().numpy().tobytes())
            h.update(step.numpy().tobytes())
            return h.hexdigest()

        sched = StepBasedSchedule(ELASTIC_SCHEDULE)
        es.register_state(lambda: state, set_state)
        grads = [p for p in params.values()]
        stats = [b for b in buffers.values() if b.is_floating_point()]
        version = None
        while not es.stopped():
            t_begin = time.perf_counter()
            with es.scope():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rank, size = api.current_rank(), api.cluster_size()
                rec = {"step": int(step), "rank": rank, "size": size, "progress": es.progress,
                       "version": peer.cluster_version, "pre_digest": digest(),
                       "begin_ms": (t0 - t_begin) * 1e3}
                if peer.cluster_version != version:  # the first step of an epoch
                    version = peer.cluster_version
                    rec["resize_phases"] = api.last_resize_phases()
                    rec["sync"] = dict(es.last_sync)
                xb, yb = ds.batch_at(es.progress, rank, size)
                rec["indices"] = ds.indices_at(es.progress, rank, size).tolist()
                batch = (torch.from_numpy(xb).to(device).to(torch.bfloat16) / 255.0,
                         torch.from_numpy(yb).to(device))
                loss, t1, t2 = _ssgd_step(model, opt, grads, stats, batch, size,
                                          f"g{int(step)}")
                step += 1
                torch.cuda.synchronize()
                rec["loss"] = loss
                rec["step_ms"] = (time.perf_counter() - t0) * 1e3
                # the step's split: forward and backward, the host all-reduce
                # (staging both ways included), the update
                rec["split_ms"] = [(t1 - t0) * 1e3, (t2 - t1) * 1e3, rec["step_ms"] - (t2 - t0) * 1e3]
                rec["post_digest"] = digest()
                rec["agreed"] = peer.current_session().bytes_consensus(
                    rec["post_digest"].encode(), f"elastic:{rec['step']}")
                if rank == 0:
                    sched.maybe_propose(int(step))  # the next step's size
                out["steps"].append(rec)
                t_end = time.perf_counter()
                es.end(ds.cluster_delta(size))
                rec["end_ms"] = (time.perf_counter() - t_end) * 1e3
        out.update(stop_reason=es.stop_reason, final_progress=es.progress,
                   resize_audit=api.resize_audit())
    finally:
        ELASTIC_OUT.mkdir(parents=True, exist_ok=True)
        (ELASTIC_OUT / f"{spec.replace(':', '_')}.json").write_text(json.dumps(out))
        finalize_default_peer()
    return 0


def elastic_phase(smi: str) -> None:
    """BASELINE config 5's resize path on one card: the port's kfrun in
    watch mode with one warm standby starts 2 workers; a StepBasedSchedule
    grows the world to 4 and shrinks it back to 2 while ResNet-50 trains
    under ElasticState."""
    from kungfu_tpu_torch.runner.cli import free_port_range, free_ports

    t_phase = time.perf_counter()
    ELASTIC_OUT.mkdir(parents=True, exist_ok=True)
    for f in ELASTIC_OUT.glob("*"):
        f.unlink()
    base, runner = free_port_range(4), free_ports(1)[0]
    env = {k: v for k, v in os.environ.items() if not k.startswith("KF_")}
    env["KF_TELEMETRY"] = "audit"  # each resize on the record (workers serve on port + 10000)
    here = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "kungfu_tpu_torch.runner.cli", "-np", "2", "-H", "127.0.0.1:4",
           "-w", "-builtin-config-port", "0", "-port-range", f"{base}-{base + 3}",
           "-runner-port", str(runner), "-monitor-port", "0", "-warm-spares", "1",
           "-timeout", str(ELASTIC_DEADLINE_S), sys.executable, "chip_smoke.py",
           "--elastic-worker"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=here, env=env, capture_output=True, text=True,
                       timeout=ELASTIC_DEADLINE_S + 60)
    kfrun_s = time.perf_counter() - t0
    (ELASTIC_OUT / "kfrun.log").write_text(r.stdout + "\n--- stderr ---\n" + r.stderr)
    check(r.returncode == 0, f"elastic: kfrun exited {r.returncode}; its log is "
          f"{ELASTIC_OUT / 'kfrun.log'}:\n{r.stderr[-3000:]}")
    workers = {}
    for f in sorted(ELASTIC_OUT.glob("*.json")):
        w = json.loads(f.read_text())
        workers[w["spec"]] = w
    specs = [f"127.0.0.1:{base + i}" for i in range(4)]
    check(sorted(workers) == specs, f"elastic: workers {sorted(workers)}, not {specs}")
    first, joiners = specs[:2], specs[2:]
    steps = {}  # step -> records of every rank
    for w in workers.values():
        for rec in w["steps"]:
            steps.setdefault(rec["step"], []).append(rec)
    sizes = [steps[i][0]["size"] for i in sorted(steps)]
    check(sizes == ELASTIC_SIZES, f"elastic: sizes per step {sizes}, not {ELASTIC_SIZES}")
    for i, recs in sorted(steps.items()):
        check(sorted(r["rank"] for r in recs) == list(range(sizes[i]))
              and len({r["size"] for r in recs}) == 1, f"elastic step {i}: ranks {recs}")
        check(all(r["agreed"] for r in recs) and len({r["post_digest"] for r in recs}) == 1,
              f"elastic step {i}: the ranks' parameters, buffers or momentum differ")
        check(len({r["pre_digest"] for r in recs}) == 1,
              f"elastic step {i}: the ranks started the step from different states")
        if i:
            check(recs[0]["pre_digest"] == steps[i - 1][0]["post_digest"],
                  f"elastic step {i}: the state changed between steps")
    grow = ELASTIC_SIZES.index(4)
    for j in joiners:
        got = workers[j]["steps"][0]
        check(got["step"] == grow and got["pre_digest"] == steps[grow - 1][0]["post_digest"],
              f"elastic: joiner {j} did not start from the survivors' state")
        check(workers[j]["stop_reason"] == "detached", f"elastic: joiner {j} stopped "
              f"{workers[j]['stop_reason']!r}, not 'detached'")
    total = sum(s * ELASTIC_BATCH for s in ELASTIC_SIZES)
    for s in first:
        check(workers[s]["stop_reason"] == "finished" and workers[s]["final_progress"] == total,
              f"elastic: survivor {s} stopped {workers[s]['stop_reason']!r} at "
              f"{workers[s]['final_progress']}")
    # the audit log: one record per resize a survivor took part in, its
    # phases those the survivor timed (its first step of each new epoch)
    audit_check = {}
    for s in first:
        recs = workers[s]["resize_audit"]
        phases = [rec["resize_phases"] for rec in workers[s]["steps"]
                  if "resize_phases" in rec][1:]
        sizes_seen = [(a.get("old_size"), a.get("new_size")) for a in recs]
        check(sizes_seen == [(2, 4), (4, 2)] and [a.get("phases_ms") for a in recs] == phases
              and all(a.get("trigger") == "config_server" for a in recs),
              f"elastic: survivor {s}'s resize audit {recs} is not its resizes 2->4, 4->2 "
              f"with phases {phases}")
        audit_check[s] = {"sizes": sizes_seen, "duration_ms": [a.get("duration_ms")
                                                               for a in recs]}
    for j in joiners:
        recs = workers[j]["resize_audit"]
        check([(a.get("old_size"), a.get("new_size"), a.get("detached")) for a in recs]
              == [(4, 2, True)], f"elastic: joiner {j}'s resize audit {recs}")
    # no sample skipped or trained twice: each step's global batch is the
    # next stretch of the dataset's order
    import numpy as np

    from kungfu_tpu_torch.elastic import ElasticDataset

    order = ElasticDataset([np.zeros(ELASTIC_SAMPLES)], ELASTIC_BATCH, seed=1)
    progress = 0
    for i in sorted(steps):
        recs = sorted(steps[i], key=lambda r: r["rank"])
        check(all(r["progress"] == progress for r in recs),
              f"elastic step {i}: progress {[r['progress'] for r in recs]}, not {progress}")
        got = [x for r in recs for x in r["indices"]]
        want = [int(order._epoch_perm(p // ELASTIC_SAMPLES)[p % ELASTIC_SAMPLES])
                for p in range(progress, progress + len(got))]
        check(got == want, f"elastic step {i}: the global batch is not the next in order")
        progress += ELASTIC_BATCH * sizes[i]
    losses = [steps[i][0]["loss"] for i in sorted(steps)]
    check(all(math.isfinite(x) for x in losses), f"elastic: losses {losses}")
    check(sum(losses[-3:]) < sum(losses[:3]), f"elastic: the loss did not fall: {losses}")

    # what each resize cost
    resizes = []
    for i in sorted(steps):
        recs = steps[i]
        if i == 0 or sizes[i] != sizes[i - 1]:
            resizes.append({
                "step": i, "from": sizes[i - 1] if i else 0, "to": sizes[i],
                "resize_phases": {r["rank"]: r.get("resize_phases") for r in recs},
                "sync_s": {r["rank"]: r.get("sync", {}).get("seconds") for r in recs},
                "sync_bytes": {r["rank"]: r.get("sync", {}).get("bytes") for r in recs},
                # the es.end() that resized, as each rank of the step before saw it
                "end_ms_before": {r["rank"]: r["end_ms"] for r in steps[i - 1]} if i else {},
            })
    joins = {j: {"how": "standby" if workers[j]["standby"] else "cold",
                 "spawn_to_ready_ms": workers[j]["startup_ms"]} for j in joiners}
    runner_ms = [line.split("kfrun: ", 1)[1] for line in (r.stdout + r.stderr).splitlines()
                 if "after its Stage" in line]
    check(any(v["how"] == "standby" for v in joins.values()),
          f"elastic: no joiner came from the warm standby: {joins}")

    def med(xs):
        return sorted(xs)[len(xs) // 2] if xs else None

    by_size = {}
    for i in sorted(steps):
        first_of_epoch = i == 0 or sizes[i] != sizes[i - 1]
        if not first_of_epoch:
            by_size.setdefault(sizes[i], []).append(max(r["step_ms"] for r in steps[i]))
    emit("elastic", nvidia_smi=smi, schedule=ELASTIC_SCHEDULE, sizes=sizes,
         images_per_rank=ELASTIC_BATCH, samples=ELASTIC_SAMPLES, losses=losses,
         resizes=resizes, joins=joins, runner_stage_to_start=runner_ms,
         step_ms={n: [[r["step_ms"] for r in sorted(steps[i], key=lambda r: r["rank"])]
                      for i in sorted(steps) if sizes[i] == n] for n in sorted(set(sizes))},
         median_step_ms={n: med(v) for n, v in by_size.items()},
         split_ms={n: [[[round(x, 2) for x in r["split_ms"]]
                        for r in sorted(steps[i], key=lambda r: r["rank"])]
                       for i in sorted(steps) if sizes[i] == n] for n in sorted(set(sizes))},
         end_ms=[[r.get("end_ms") for r in sorted(steps[i], key=lambda r: r["rank"])]
                 for i in sorted(steps)],
         resize_audit=audit_check, kfrun_seconds=kfrun_s,
         seconds=time.perf_counter() - t_phase)


CKPT_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
CKPT_STEPS, CKPT_EVERY = 4, 2  # training steps of the recovery run; a checkpoint every 2
CKPT_CRASH_EPOCH = 1  # rank 1 crashes once, after the checkpoint of step 2
CKPT_LR, CKPT_MOMENTUM = 0.05, 0.9
CKPT_GRACE = "10s"  # kfrun -auto-recover: a rank stuck in a step this long restarts the world
CKPT_DEADLINE_S = 300


def _resnet_state(device, seed: int):
    """ResNet-50 at full width as training state: parameters, BN running
    statistics, momentum (seeded, nonzero) and the int64 step, the tree
    ElasticState syncs (204,686,262 B)."""
    import torch

    model = _resnet50_seed0(device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    gen = torch.Generator(device=device).manual_seed(seed)
    momentum = {k: torch.randn(p.shape, generator=gen, device=device) * 1e-3
                for k, p in params.items()}
    return {"params": params, "buffers": dict(model.named_buffers()), "momentum": momentum,
            "step": torch.zeros(1, dtype=torch.int64)}


def _tree_bytes(leaves) -> int:
    return sum(x.numel() * x.element_size() for x in leaves)


def checkpoint_worker(ckdir: str, out_dir: str, crash: bool) -> int:
    """One worker of the checkpoint phase's recovery run, under the
    port's kfrun -auto-recover: ResNet-50 S-SGD with momentum over the host
    plane at 16 images a rank, a Checkpointer save (rank 0) every
    CKPT_EVERY steps; with `crash`, rank 1 exits after the checkpoint of
    epoch CKPT_CRASH_EPOCH, once. Writes its clock readings, losses and
    final state's digest."""
    t_start = time.time()
    import hashlib

    import torch

    from kungfu_tpu_torch import api, cmd, knobs, resolve_device
    from kungfu_tpu_torch.elastic.checkpoint import Checkpointer
    from kungfu_tpu_torch.peer import finalize_default_peer

    restart = "--restart" in sys.argv
    rank, size = api.current_rank(), api.cluster_size()  # starts this worker's Peer
    t_ready = time.time()
    out = {"rank": rank, "restart": restart, "t_spawn": float(knobs.raw("KF_SPAWN_TS") or 0),
           "t_start": t_start, "t_ready": t_ready, "losses": [], "step_ms": []}
    try:
        _deterministic()
        device = resolve_device()
        torch.zeros(1, device=device).sum().item()  # the CUDA context
        out["t_context"] = time.time()
        images, labels = _elastic_data()
        out["t_data"] = time.time()
        model = _resnet50_seed0(device)
        params = dict(model.named_parameters())
        buffers = dict(model.named_buffers())
        opt = torch.optim.SGD(list(params.values()), lr=CKPT_LR, momentum=CKPT_MOMENTUM)
        for p in params.values():
            opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        momentum = {k: opt.state[p]["momentum_buffer"] for k, p in params.items()}
        step_t = torch.zeros(1, dtype=torch.int64)
        state = {"params": params, "buffers": buffers, "momentum": momentum, "step": step_t}
        torch.cuda.synchronize()
        out["t_built"] = time.time()
        ckpt = Checkpointer(ckdir, max_to_keep=2, save_rank=0)
        got, start_epoch = ckpt.restore_or(state)
        if start_epoch:
            with torch.no_grad():
                for part in ("params", "buffers", "momentum"):
                    for k, v in got[part].items():
                        state[part][k].copy_(v)
                step_t.copy_(got["step"])
        torch.cuda.synchronize()
        out.update(start_epoch=start_epoch, t_restored=time.time())
        grads = list(params.values())
        stats = [b for b in buffers.values() if b.is_floating_point()]
        n = ELASTIC_BATCH
        for step in range(start_epoch * CKPT_EVERY, CKPT_STEPS):
            t0 = time.perf_counter()
            cmd.monitor_batch_begin(rank)
            lo = (step * size + rank) * n % ELASTIC_SAMPLES
            xb = torch.from_numpy(images[lo:lo + n]).to(device).to(torch.bfloat16) / 255.0
            yb = torch.from_numpy(labels[lo:lo + n]).to(device)
            loss, _, _ = _ssgd_step(model, opt, grads, stats, (xb, yb), size, f"ck{step}")
            step_t += 1
            torch.cuda.synchronize()
            cmd.monitor_batch_end(rank)
            out["losses"].append(loss)
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out.setdefault("t_first_step", time.time())
            if (step + 1) % CKPT_EVERY == 0:
                epoch = (step + 1) // CKPT_EVERY
                t1 = time.perf_counter()
                ckpt.save(epoch, state)
                api.run_barrier()  # every rank knows the step is on disk
                out.setdefault("save_ms", []).append((time.perf_counter() - t1) * 1e3)
                cmd.monitor_epoch_end(rank)
                if crash and not restart and rank == 1 and epoch == CKPT_CRASH_EPOCH:
                    out["t_crash"] = time.time()
                    (Path(out_dir) / "crash.json").write_text(json.dumps(out))
                    os._exit(3)
        h = hashlib.sha256()
        for part in ("params", "buffers", "momentum"):
            for k in sorted(state[part]):
                h.update(state[part][k].detach().cpu().contiguous().reshape(-1)
                         .view(torch.uint8).numpy().tobytes())
        h.update(step_t.numpy().tobytes())
        out.update(digest=h.hexdigest(), final_step=int(step_t))
        cmd.monitor_train_end(rank)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        finalize_default_peer()
    return 0


def _kfrun(args, deadline_s: int, **env_extra):
    """The port's kfrun from the checkout's root, KF_* knobs stripped, on
    free ports outside 38000-38999; returns (CompletedProcess, seconds)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("KF_")}
    env.update(CUBLAS_WORKSPACE_CONFIG=":4096:8", **env_extra)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "kungfu_tpu_torch.runner.cli", *args],
                       cwd=Path(__file__).resolve().parent, env=env, capture_output=True,
                       text=True, timeout=deadline_s + 60)
    return r, time.perf_counter() - t0


def _recovery_run(name: str, crash: bool) -> dict:
    """The recovery run of 2 workers on card 0 (`crash`: rank 1 dies
    once); returns the workers' records."""
    import shutil

    from kungfu_tpu_torch.runner.cli import free_port_range, free_ports

    out = CKPT_OUT / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    base, runner = free_port_range(2), free_ports(1)[0]
    r, secs = _kfrun(["-np", "2", "-H", "127.0.0.1:2", "-auto-recover", CKPT_GRACE,
                      "-monitor-port", "0", "-port-range", f"{base}-{base + 1}",
                      "-runner-port", str(runner), "-timeout", str(CKPT_DEADLINE_S),
                      sys.executable, "chip_smoke.py", "--checkpoint-worker", str(out / "ck"),
                      str(out), "1" if crash else "0"], CKPT_DEADLINE_S)
    (out / "kfrun.log").write_text(r.stdout + "\n--- stderr ---\n" + r.stderr)
    check(r.returncode == 0, f"checkpoint {name}: kfrun exited {r.returncode}:\n"
          f"{r.stderr[-3000:]}")
    ranks = [json.loads((out / f"rank{i}.json").read_text()) for i in range(2)]
    crash_rec = json.loads((out / "crash.json").read_text()) if crash else None
    return {"ranks": ranks, "crash": crash_rec, "kfrun_seconds": secs,
            "restarts": (r.stdout + r.stderr).count("restarting")}


def checkpoint_phase(smi: str) -> None:
    """Config 5's recovery path. In process: ResNet-50's training state on
    card 0 saved at steps 1-3 (window 2), restored under KF_RECOVER_EPOCH=2;
    then two workers under the port's kfrun -auto-recover, rank 1 crashing
    after the step-2 checkpoint, against an uninterrupted run."""
    import shutil

    import torch

    from kungfu_tpu_torch import resolve_device
    from kungfu_tpu_torch.base.serialize import pack_leaves
    from kungfu_tpu_torch.elastic.checkpoint import (Checkpointer, dump_final_variables)
    from kungfu_tpu_torch.elastic.state import tree_flatten

    t_phase = time.perf_counter()
    shutil.rmtree(CKPT_OUT, ignore_errors=True)
    CKPT_OUT.mkdir(parents=True)
    device = resolve_device()
    state = _resnet_state(device, seed=7)
    leaves, _ = tree_flatten(state)
    nbytes = _tree_bytes(leaves)
    ckpt = Checkpointer(str(CKPT_OUT / "inproc"), max_to_keep=2, save_rank=None)
    save_s, saved = [], None
    first = next(iter(state["params"]))
    for s in (1, 2, 3):
        with torch.no_grad():
            state["params"][first].add_(1.0)
        state["step"].fill_(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(ckpt.save(s, state), f"checkpoint: step {s} was not saved")
        save_s.append(time.perf_counter() - t0)
        if s == 2:
            saved = [x.clone() for x in leaves]
    steps = ckpt.all_steps()
    check(steps == [2, 3], f"checkpoint: the window holds steps {steps}, not [2, 3]")
    disk = sum(f.stat().st_size for f in (CKPT_OUT / "inproc").rglob("*") if f.is_file())
    like = {part: {k: torch.zeros_like(v) for k, v in state[part].items()}
            for part in ("params", "buffers", "momentum")}
    like["step"] = torch.zeros(1, dtype=torch.int64)
    os.environ["KF_RECOVER_EPOCH"] = "2"
    try:
        check(ckpt.latest_step() == 2, f"checkpoint: KF_RECOVER_EPOCH=2 gave step "
              f"{ckpt.latest_step()}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, start = ckpt.restore_or(like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        del os.environ["KF_RECOVER_EPOCH"]
    check(start == 2, f"checkpoint: restored step {start}, not 2")
    got_leaves, _ = tree_flatten(got)
    for g, w, l in zip(got_leaves, saved, leaves):
        check(g.device == l.device and g.dtype == l.dtype and g.shape == l.shape
              and torch.equal(g, w), "checkpoint: a restored leaf differs from step 2's")
    dump = CKPT_OUT / "variables-final.kf"
    t0 = time.perf_counter()
    dump_final_variables(str(dump), state)
    dump_s = time.perf_counter() - t0
    check(dump.read_bytes() == pack_leaves([x.cpu() for x in leaves]),
          "checkpoint: dump_final_variables differs from pack_leaves in jax order")
    blob = (CKPT_OUT / "inproc" / "3" / "state.kf").stat().st_size
    del saved, got, got_leaves, like
    shutil.rmtree(CKPT_OUT / "inproc")
    dump.unlink()

    plain = _recovery_run("plain", crash=False)
    crashed = _recovery_run("crash", crash=True)
    for a, b in zip(plain["ranks"], crashed["ranks"]):
        check(a["final_step"] == b["final_step"] == CKPT_STEPS,
              f"checkpoint: final steps {a['final_step']} and {b['final_step']}")
        check(a["digest"] == b["digest"], f"checkpoint rank {a['rank']}: the resumed run's "
              "final state differs from the uninterrupted run's")
    check(plain["ranks"][0]["digest"] == plain["ranks"][1]["digest"],
          "checkpoint: the ranks' final states differ")
    check(all(r["restart"] and r["start_epoch"] == CKPT_CRASH_EPOCH for r in crashed["ranks"]),
          f"checkpoint: the relaunch resumed from "
          f"{[r.get('start_epoch') for r in crashed['ranks']]}, not epoch {CKPT_CRASH_EPOCH}")
    losses = plain["ranks"][0]["losses"]
    check(all(math.isfinite(x) for x in losses), f"checkpoint: losses {losses}")
    for run in ("plain", "crash"):
        shutil.rmtree(CKPT_OUT / run / "ck")  # 2 x 205 MB a run
    t_crash = crashed["crash"]["t_crash"]
    rs = crashed["ranks"]
    recover = {
        "total_s": max(r["t_first_step"] for r in rs) - t_crash,
        # the crash until the runner's relaunch (its detection included)
        "runner_relaunch_s": min(r["t_spawn"] for r in rs) - t_crash,
        # spawn to a started Peer (interpreter, imports, peer start)
        "workers_start_s": [r["t_ready"] - r["t_spawn"] for r in rs],
        "cuda_context_s": [r["t_context"] - r["t_ready"] for r in rs],
        "data_s": [r["t_data"] - r["t_context"] for r in rs],
        "model_build_s": [r["t_built"] - r["t_data"] for r in rs],
        "restore_s": [r["t_restored"] - r["t_built"] for r in rs],
        "first_step_s": [r["t_first_step"] - r["t_restored"] for r in rs],
    }
    emit("checkpoint", nvidia_smi=smi, state_bytes=nbytes, blob_bytes=blob,
         leaves=len(leaves), bytes_on_disk_2_steps=disk, save_s=save_s,
         save_gb_per_s=[blob / s / 1e9 for s in save_s], restore_s=restore_s,
         restore_gb_per_s=blob / restore_s / 1e9, dump_s=dump_s,
         recovery={"ranks": 2, "images_per_rank": ELASTIC_BATCH, "steps": CKPT_STEPS,
                   "checkpoint_every": CKPT_EVERY, "grace": CKPT_GRACE,
                   "restarts": crashed["restarts"], "time_to_recover": recover,
                   "losses": losses, "step_ms": [r["step_ms"] for r in plain["ranks"]],
                   "save_ms_rank0": plain["ranks"][0].get("save_ms"),
                   "kfrun_seconds": {"plain": plain["kfrun_seconds"],
                                     "crash": crashed["kfrun_seconds"]}},
         seconds=time.perf_counter() - t_phase)


ADAPTIVE_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_adaptive"
ADAPTIVE_MAX_WORKERS = 4
ADAPTIVE_STEPS = 30  # rank 0 may propose a grow every 10 steps: 1 -> 3 by step 20
ADAPTIVE_DEADLINE_S = 300
RESIZE_MIN = 5  # resizes bench_resize must time


def adaptive_worker() -> int:
    """One worker of the resize_bench phase's adaptive run:
    `examples/adaptive_batch.main` on card 0, its records written out."""
    import hashlib

    from kungfu_tpu_torch import knobs
    from kungfu_tpu_torch.examples import adaptive_batch
    from kungfu_tpu_torch.peer import finalize_default_peer

    spec = knobs.raw("KF_SELF_SPEC")
    try:
        out = adaptive_batch.main(["--max-workers", str(ADAPTIVE_MAX_WORKERS),
                                   "--steps", str(ADAPTIVE_STEPS)])
        w = out.pop("w")
        out["w_digest"] = hashlib.sha256(w.cpu().numpy().tobytes()).hexdigest()
        out["spec"] = spec
        ADAPTIVE_OUT.mkdir(parents=True, exist_ok=True)
        (ADAPTIVE_OUT / f"{spec.replace(':', '_')}.json").write_text(json.dumps(out))
    finally:
        finalize_default_peer()
    return 0


def resize_bench_phase(smi: str) -> None:
    """BASELINE's elastic resize latency on the card's host
    (`python -m kungfu_tpu_torch.bench_resize`), then config 5's GNS-driven
    grow (`examples/adaptive_batch` under the port's kfrun -w)."""
    import shutil

    from kungfu_tpu_torch.runner.cli import free_port_range, free_ports

    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("KF_")}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "kungfu_tpu_torch.bench_resize"],
                       cwd=Path(__file__).resolve().parent, env=env, capture_output=True,
                       text=True, timeout=400)
    bench_s = time.perf_counter() - t0
    check(r.returncode == 0, f"resize_bench: bench_resize exited {r.returncode}:\n"
          f"{(r.stdout + r.stderr)[-3000:]}")
    bench = json.loads(r.stdout.strip().splitlines()[-1])
    check(bench["n_resizes"] >= RESIZE_MIN, f"resize_bench: {bench['n_resizes']} resizes timed")

    shutil.rmtree(ADAPTIVE_OUT, ignore_errors=True)
    ADAPTIVE_OUT.mkdir(parents=True)
    base, runner = free_port_range(ADAPTIVE_MAX_WORKERS), free_ports(1)[0]
    r, kf_s = _kfrun(["-np", "1", "-H", f"127.0.0.1:{ADAPTIVE_MAX_WORKERS}", "-w",
                      "-builtin-config-port", "0", "-port-range",
                      f"{base}-{base + ADAPTIVE_MAX_WORKERS - 1}", "-runner-port", str(runner),
                      "-monitor-port", "0", "-timeout", str(ADAPTIVE_DEADLINE_S),
                      sys.executable, "chip_smoke.py", "--adaptive-worker"], ADAPTIVE_DEADLINE_S)
    (ADAPTIVE_OUT / "kfrun.log").write_text(r.stdout + "\n--- stderr ---\n" + r.stderr)
    check(r.returncode == 0, f"adaptive: kfrun exited {r.returncode}:\n{r.stderr[-3000:]}")
    workers = [json.loads(f.read_text()) for f in sorted(ADAPTIVE_OUT.glob("*.json"))]
    done = [l for l in r.stdout.splitlines() if "done rank=" in l]
    check(len(done) == len(workers) >= 2, f"adaptive: {len(done)} 'done' lines from "
          f"{len(workers)} workers")
    first = next(w for w in workers if w["steps"][0]["progress"] == 0)
    sizes = [s["size"] for s in first["steps"]]
    check(max(sizes) > 1, "adaptive: the cluster never grew")
    check(all(a <= b for a, b in zip(sizes, sizes[1:])) and max(sizes) <= ADAPTIVE_MAX_WORKERS,
          f"adaptive: sizes {sizes} fell or passed {ADAPTIVE_MAX_WORKERS}")
    check(len({w["w_digest"] for w in workers}) == 1, "adaptive: the ranks' w differ")
    grows = [(s["progress"], s["size"]) for a, s in zip(first["steps"], first["steps"][1:])
             if s["size"] != a["size"]]
    emit("resize_bench", nvidia_smi=smi, elastic_resize_latency=bench,
         bench_seconds=bench_s,
         adaptive={"workers": len(workers), "sizes_at_grows": grows,
                   "gns_at_grows": [s["gns"] for a, s in zip(first["steps"], first["steps"][1:])
                                    if s["size"] != a["size"]],
                   "final_gns": first["steps"][-1]["gns"], "kfrun_seconds": kf_s},
         seconds=time.perf_counter() - t_phase)


PAIR_RANKS, PAIR_STEPS = 4, 4
PAIR_LR, PAIR_MOMENTUM = 0.1, 0.9
PAIR_DEADLINE_S = 400
PAIR_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_pair"


def _pair_rank(rank: int, specs) -> dict:
    """One worker of the pair phase: ResNet-50 at 16 images a rank on a
    fixed batch of its own, PairAveraging over SGD(0.1, 0.9); each
    averaged step replayed on the card from its saved inputs."""
    _worker_env(rank, specs)
    import torch

    from kungfu_tpu_torch import resolve_device
    from kungfu_tpu_torch.base.serialize import unpack_leaves
    from kungfu_tpu_torch.elastic.state import tree_flatten
    from kungfu_tpu_torch.models.resnet import resnet_loss
    from kungfu_tpu_torch.optimizers.pair_averaging import PairAveraging
    from kungfu_tpu_torch.peer import get_default_peer

    peer = get_default_peer()
    device = resolve_device()
    model = _resnet50_seed0(device)
    params = dict(model.named_parameters())
    gen = torch.Generator(device=device).manual_seed(600 + rank)
    batch = (torch.randn(OPT_BATCH, OPT_SIDE, OPT_SIDE, 3, device=device, dtype=torch.bfloat16,
                         generator=gen),
             torch.randint(0, 1000, (OPT_BATCH,), device=device, generator=gen))
    pa = PairAveraging(lambda ps: torch.optim.SGD(ps, lr=PAIR_LR, momentum=PAIR_MOMENTUM),
                       name="chip")
    opt = pa.init(params)
    # the blob each step unpacks, kept here for the replay
    fetched: list = []
    unpack = pa._unpack_other

    def keep_blob(blob):
        fetched.append(bytes(blob))
        return unpack(blob)

    pa._unpack_other = keep_blob
    leaves, _ = tree_flatten(params)
    out = {"rank": rank, "losses": [], "step_ms": [], "exchange": [], "replayed": []}
    for step in range(PAIR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in leaves:
            p.grad = None
        loss = resnet_loss(model, batch)
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        before = [p.detach().clone() for p in leaves]
        bufs = [opt.state[p].get("momentum_buffer") for p in leaves]
        bufs = [None if b is None else b.clone() for b in bufs]
        g_saved = [g.clone() for g in tree_flatten(grads)[0]]
        torch.cuda.synchronize()
        fetched.clear()
        n_avg = pa.steps["avg"]
        t1 = time.perf_counter()
        pa.step(params, grads)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        averaged = pa.steps["avg"] > n_avg
        out["losses"].append(loss.item())
        out["step_ms"].append((t2 - t0) * 1e3)
        out["exchange"].append(dict(pa.last, step_ms=(t2 - t1) * 1e3, averaged=averaged))
        if averaged:
            # the f32 average of (own params, the fetched blob), then the base step
            other = unpack_leaves(fetched[-1], len(leaves))
            replay = [b.clone().requires_grad_() for b in before]
            with torch.no_grad():
                for r, o in zip(replay, other):
                    r.copy_((0.5 * (r.float() + o.to(device).float())).to(r.dtype))
            ropt = torch.optim.SGD(replay, lr=PAIR_LR, momentum=PAIR_MOMENTUM)
            for r, g, b in zip(replay, g_saved, bufs):
                r.grad = g
                if b is not None:
                    ropt.state[r]["momentum_buffer"] = b
            ropt.step()
            out["replayed"].append(all(torch.equal(r, p) for r, p in zip(replay, leaves)))
            del other, replay, ropt
        del before, bufs, g_saved
        fetched.clear()
    out["steps"] = dict(pa.steps)
    out["param_bytes"] = sum(p.numel() * p.element_size() for p in leaves)
    if pa._prefetch is not None:
        pa._prefetch.join(30)  # the last step's prefetch, before the peer stops
    peer.current_session().barrier(":pair:end")
    return out


def pair_worker(rank: int, _spawned, specs) -> None:
    try:
        (PAIR_OUT / f"rank{rank}.json").write_text(json.dumps(_pair_rank(rank, specs)))
    finally:
        from kungfu_tpu_torch.peer import finalize_default_peer

        finalize_default_peer()


def _cyclegan_rank(rank: int, specs) -> dict:
    _worker_env(rank, specs)
    from kungfu_tpu_torch.examples import cyclegan_pair

    t0 = time.perf_counter()
    out = cyclegan_pair.main([])
    out["seconds"] = time.perf_counter() - t0
    out.pop("g_loss"), out.pop("d_loss")
    return out


def cyclegan_worker(rank: int, _spawned, specs) -> None:
    try:
        (PAIR_OUT / f"cyclegan{rank}.json").write_text(json.dumps(_cyclegan_rank(rank, specs)))
    finally:
        from kungfu_tpu_torch.peer import finalize_default_peer

        finalize_default_peer()


def pair_phase(smi: str) -> None:
    """BASELINE config 4's optimizer at full width: 4 workers on card 0
    train ResNet-50 under PairAveraging, exchanging 102 MB models through
    the versioned p2p store; then `examples/cyclegan_pair` on 2 workers."""
    from kungfu_tpu_torch.parallel.distributed import spawn_world
    from kungfu_tpu_torch.runner.cli import free_ports

    t_phase = time.perf_counter()
    PAIR_OUT.mkdir(parents=True, exist_ok=True)
    for f in PAIR_OUT.glob("*.json"):
        f.unlink()
    specs = [f"127.0.0.1:{p}" for p in free_ports(PAIR_RANKS)]
    spawn_world(pair_worker, PAIR_RANKS, PAIR_DEADLINE_S, args=(specs,))
    ranks = [json.loads((PAIR_OUT / f"rank{r}.json").read_text()) for r in range(PAIR_RANKS)]
    for r in ranks:
        losses = r["losses"]
        check(all(math.isfinite(x) for x in losses) and sum(losses[-3:]) / 3 < losses[0],
              f"pair rank {r['rank']}: losses {losses}")
        check(r["steps"]["avg"] >= 1, f"pair rank {r['rank']}: no averaged step {r['steps']}")
        check(len(r["replayed"]) == r["steps"]["avg"] and all(r["replayed"]),
              f"pair rank {r['rank']}: an averaged step differs from its replay "
              f"{r['replayed']}")
    t_cg = time.perf_counter()
    cg_specs = [f"127.0.0.1:{p}" for p in free_ports(2)]
    spawn_world(cyclegan_worker, 2, PAIR_DEADLINE_S, args=(cg_specs,))
    cyclegan = [json.loads((PAIR_OUT / f"cyclegan{r}.json").read_text()) for r in range(2)]
    check(all(c["err"] < 1.0 for c in cyclegan), f"cyclegan: probe errors "
          f"{[c['err'] for c in cyclegan]}")

    def med(xs):
        return sorted(xs)[len(xs) // 2] if xs else None

    ex = [r["exchange"] for r in ranks]
    emit("pair", nvidia_smi=smi, ranks=PAIR_RANKS, images_per_rank=OPT_BATCH,
         steps=PAIR_STEPS, base=f"SGD(lr {PAIR_LR}, momentum {PAIR_MOMENTUM})",
         param_bytes=ranks[0]["param_bytes"], losses=[r["losses"] for r in ranks],
         step_ms=[r["step_ms"] for r in ranks],
         median_step_ms=max(med(r["step_ms"][1:]) for r in ranks),
         pa_step_ms=[[e["step_ms"] for e in x] for x in ex],
         exposed_wait_ms=[[e["wait"] for e in x] for x in ex],
         prefetch_ms=[[e["fetch"] for e in x] for x in ex],
         pack_ms=[[e["pack"] for e in x] for x in ex],
         publish_ms=[[e["publish"] for e in x] for x in ex],
         bytes_fetched=[sum(e["bytes"] for e in x) for x in ex],
         averaged=[r["steps"]["avg"] for r in ranks], plain=[r["steps"]["plain"] for r in ranks],
         cyclegan={"ranks": 2, "steps": [c["steps"] for c in cyclegan],
                   "err": [c["err"] for c in cyclegan], "center": [c["center"] for c in cyclegan],
                   "seconds": [c["seconds"] for c in cyclegan],
                   "phase_seconds": time.perf_counter() - t_cg},
         seconds=time.perf_counter() - t_phase)


HIER_RANKS, HIER_WORLD, HIER_STEPS, HIER_LR = 4, 2, 4, 0.1
HIER_DEADLINE_S = 400
HIER_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_hier"


def _hier_rank(rank: int, specs) -> dict:
    """One worker of the hier phase: ResNet-50 at 16 images a rank, SGD
    with the hierarchical mean over 2 worlds x 2 ranks (gloo in a world),
    the cross-world wire plain then bf16; the first step's mean against a
    flat host all-reduce of the same gradients; the worlds' bits checked
    after every step; then `examples/multislice_train` at world sizes 2
    and 1."""
    _worker_env(rank, specs)
    import torch

    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.base.ops import ReduceOp
    from kungfu_tpu_torch.examples import multislice_train
    from kungfu_tpu_torch.models.resnet import resnet_loss
    from kungfu_tpu_torch.ops.hierarchical import HierarchicalSGD
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
    from kungfu_tpu_torch.peer import get_default_peer

    _deterministic()
    peer = get_default_peer()
    device = initialize_device_plane(backend="gloo", peer=peer)
    sess = peer.current_session()
    gen = torch.Generator(device=device).manual_seed(700 + rank)
    batch = (torch.randn(OPT_BATCH, OPT_SIDE, OPT_SIDE, 3, device=device, dtype=torch.bfloat16,
                         generator=gen),
             torch.randint(0, 1000, (OPT_BATCH,), device=device, generator=gen))
    out = {"rank": rank, "runs": {}}
    for compress in ("", "bf16"):
        model = _resnet50_seed0(device)
        params = list(model.parameters())
        opt = HierarchicalSGD(torch.optim.SGD(params, lr=HIER_LR), world_size=HIER_WORLD,
                              name=f"chip-hier-{compress or 'f32'}", compress=compress,
                              device=device)
        rec = {"step_ms": [], "split_ms": [], "losses": [], "in_sync": [], "wire_bytes": []}
        for step in range(HIER_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = resnet_loss(model, batch)
            loss.backward()
            if step == 0:
                g = torch.cat([p.grad.reshape(-1) for p in params])
                sent0 = dict(sess.wire_bytes)
                flat = api.all_reduce_array(g, name=f"flat-{compress}") / HIER_RANKS
                rec["flat_wire_bytes"] = sum(sess.wire_bytes.values()) - sum(sent0.values())
                abs_sum = api.all_reduce_array(g.abs(), name=f"abs-{compress}")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            sent0 = dict(sess.wire_bytes)
            torch.cuda.synchronize()
            t_bwd = time.perf_counter()
            opt.average_gradients()
            rec["wire_bytes"].append(sum(sess.wire_bytes.values()) - sum(sent0.values()))
            if step == 0:
                hier = torch.cat([p.grad.reshape(-1) for p in params])
                err = (hier.double() - flat.double()).abs()
                if compress:
                    bound = 2 * flat.abs().max().item() * 2.0 ** -8
                    rec["first_step_worst_ratio"] = err.max().item() / bound
                else:
                    bound = 2 * (HIER_RANKS - 1) * HOST_F32_ULP * abs_sum.double() + HOST_F32_FLOOR
                    rec["first_step_worst_ratio"] = (err / bound).max().item()
                rec["first_step_max_abs_err"] = err.max().item()
                del g, flat, abs_sum, hier, err
            opt.base.step()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec["step_ms"].append((t1 - t0) * 1e3)
            rec["split_ms"].append(dict(opt.last, backward_ms=(t_bwd - t0) * 1e3))
            rec["losses"].append(loss.item())
            # MIN and MAX all-reduces both equal to the local value: every
            # world (and rank) holds the same bits
            flat_p = torch.cat([p.detach().reshape(-1) for p in params])
            lo = api.all_reduce_array(flat_p, ReduceOp.MIN, name=f"min-{compress}-{step}")
            hi = api.all_reduce_array(flat_p, ReduceOp.MAX, name=f"max-{compress}-{step}")
            rec["in_sync"].append(bool(torch.equal(lo, flat_p) and torch.equal(hi, flat_p)))
            del flat_p, lo, hi
        rec["leader"] = opt.reducer.leads()
        out["runs"][compress or "f32"] = rec
        del model, params, opt
    out["multislice"] = {}
    for ws in (HIER_WORLD, 1):  # 1: the reference's layout, the device plane up
        t0 = time.perf_counter()
        ms = multislice_train.main(["--world-size", str(ws), "--backend", "gloo"])
        out["multislice"][str(ws)] = {"losses": ms["losses"],
                                      "seconds": time.perf_counter() - t0}
    sess.barrier(":hier:end")
    return out


def hier_worker(rank: int, _spawned, specs) -> None:
    try:
        (HIER_OUT / f"rank{rank}.json").write_text(json.dumps(_hier_rank(rank, specs)))
    finally:
        from kungfu_tpu_torch.parallel.distributed import shutdown_device_plane
        from kungfu_tpu_torch.peer import finalize_default_peer

        shutdown_device_plane()
        finalize_default_peer()


def hier_phase(smi: str) -> None:
    """The hierarchical all-reduce: 4 workers on card 0 as 2 worlds x 2
    ranks (gloo within a world, the host plane across worlds) train
    ResNet-50 with the cross-world wire in f32 and in bf16; then
    `examples/multislice_train` at world sizes 2 and 1."""
    from kungfu_tpu_torch.parallel.distributed import spawn_world
    from kungfu_tpu_torch.runner.cli import free_ports

    t_phase = time.perf_counter()
    HIER_OUT.mkdir(parents=True, exist_ok=True)
    for f in HIER_OUT.glob("*.json"):
        f.unlink()
    specs = [f"127.0.0.1:{p}" for p in free_ports(HIER_RANKS)]
    spawn_world(hier_worker, HIER_RANKS, HIER_DEADLINE_S, args=(specs,))
    ranks = [json.loads((HIER_OUT / f"rank{r}.json").read_text()) for r in range(HIER_RANKS)]
    for r in ranks:
        for name, rec in r["runs"].items():
            check(all(rec["in_sync"]) and len(rec["in_sync"]) == HIER_STEPS,
                  f"hier {name} rank {r['rank']}: the worlds differ {rec['in_sync']}")
            check(rec["first_step_worst_ratio"] <= 1.0,
                  f"hier {name} rank {r['rank']}: the first step's mean is "
                  f"{rec['first_step_worst_ratio']} of its bound from the flat mean")
            check(all(math.isfinite(x) for x in rec["losses"]),
                  f"hier {name} rank {r['rank']}: losses {rec['losses']}")
    leaders = [r for r in ranks if r["runs"]["f32"]["leader"]]
    check(len(leaders) == HIER_RANKS // HIER_WORLD, f"hier: {len(leaders)} leaders")

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    runs = {}
    for name in ("f32", "bf16"):
        recs = [r["runs"][name] for r in ranks]
        runs[name] = {
            "step_ms": [x["step_ms"] for x in recs],
            "median_step_ms": max(med(x["step_ms"][1:]) for x in recs),
            "split_ms": [x["split_ms"] for x in recs],
            "median_split_ms": {k: max(med([s[k] for s in x["split_ms"][1:]]) for x in recs)
                                for k in ("backward_ms", "mean_ms", "walk_ms", "bcast_ms")},
            "cross_wire_bytes_per_leader": [x["wire_bytes"][0] for x in recs if x["leader"]],
            "flat_wire_bytes_per_rank": [x["flat_wire_bytes"] for x in recs],
            "first_step_worst_ratio": [x["first_step_worst_ratio"] for x in recs],
            "first_step_max_abs_err": [x["first_step_max_abs_err"] for x in recs],
            "losses": recs[0]["losses"],
        }
    f32_wire = runs["f32"]["cross_wire_bytes_per_leader"]
    bf16_wire = runs["bf16"]["cross_wire_bytes_per_leader"]
    emit("hier", nvidia_smi=smi, ranks=HIER_RANKS, world_size=HIER_WORLD,
         worlds=HIER_RANKS // HIER_WORLD, images_per_rank=OPT_BATCH, steps=HIER_STEPS,
         runs=runs, bf16_over_f32_wire=[b / a for a, b in zip(f32_wire, bf16_wire)],
         multislice={ws: {"losses_rank0": ranks[0]["multislice"][ws]["losses"],
                          "seconds": [r["multislice"][ws]["seconds"] for r in ranks]}
                     for ws in ranks[0]["multislice"]},
         seconds=time.perf_counter() - t_phase)


def analyzer_start() -> dict:
    """Start the port's devtools gate in a child process; a thread reaps
    it and keeps its output and the seconds it took."""
    run = {"t0": time.perf_counter()}
    run["proc"] = subprocess.Popen(
        [sys.executable, "-m", "kungfu_tpu_torch.devtools.check", "--no-cache"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def reap():
        try:
            run["out"], run["err"] = run["proc"].communicate(timeout=ANALYZER_DEADLINE_S)
        except subprocess.TimeoutExpired:
            run["proc"].kill()
            run["out"], run["err"] = run["proc"].communicate()
        run["seconds"] = time.perf_counter() - run["t0"]

    run["reaper"] = threading.Thread(target=reap, daemon=True)
    run["reaper"].start()
    return run


def analyzer_phase(smi: str, run: dict) -> None:
    """Wait for the gate started by analyzer_start and hold it to its
    contract: every section clean, exit 0; and the wait it adds to the
    run after the build (`waited_s`) to ANALYZER_WAIT_S."""
    from kungfu_tpu_torch.devtools.kfcheck import core

    t = time.perf_counter()
    run["reaper"].join(ANALYZER_DEADLINE_S + 10)
    waited = time.perf_counter() - t
    check(not run["reaper"].is_alive() and "seconds" in run, "the analyzer ended")
    out, rc = run["out"], run["proc"].returncode
    last = out.strip().splitlines()[-1] if out.strip() else ""
    findings = None  # no summary line: the gate died before it
    if last == "check: clean":
        findings = 0
    elif last.startswith("check: "):
        findings = int(last.split()[1])
    core._ensure_rules_loaded()
    pkg = Path(__file__).resolve().parent / "kungfu_tpu_torch"
    emit("analyzer", nvidia_smi=smi, rules=len(core.known_rule_ids()),
         files=sum(1 for _ in core._iter_py_files(str(pkg))), findings=findings,
         exit_code=rc, analyzer_seconds=run["seconds"], waited_s=waited,
         sections=[line for line in out.splitlines() if line.startswith("[")])
    check(rc == 0 and findings == 0,
          f"the port's analyzer is clean (exit {rc}):\n{out}{run['err']}")
    check(waited <= ANALYZER_WAIT_S,
          f"the analyzer held the run {waited:.1f} s past the build")


def main() -> int:
    import torch

    t_script = time.perf_counter()
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
    analyzer = analyzer_start()
    libs = _build.build_all(["flash_attention"])
    emit("build", seconds=time.perf_counter() - t0,
         libraries={k: str(v) for k, v in libs.items()})

    phases = {"build": time.perf_counter() - t0}
    t = time.perf_counter()
    analyzer_phase(smi, analyzer)
    phases["analyzer"] = time.perf_counter() - t

    def run(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t
        return out

    occ = run("occupancy", occupancy_phase, fa)
    kern = run("kernel", kernel_phase, fa)
    train = run("train", train_phase, fa)
    run("profile", profile_phase, train["step_ms"])
    ring_launches = run("ring", ring_phase)
    run("resnet", resnet_phase, smi)
    run("optimizers", optimizers_phase, smi)
    par_launches = run("parallel", parallel_phase, smi)
    host = run("hostplane", hostplane_phase, smi)
    run("hostnet", hostnet_phase, smi, host["walks"])
    sma_launches = run("sma", sma_phase, smi)
    run("async", async_phase, smi)
    run("telemetry", telemetry_phase, smi)
    run("replan", replan_phase, smi)
    run("forensics", forensics_phase, smi)
    run("elastic", elastic_phase, smi)
    t_new = time.perf_counter()
    run("checkpoint", checkpoint_phase, smi)
    run("resize_bench", resize_bench_phase, smi)
    run("pair", pair_phase, smi)
    run("hier", hier_phase, smi)
    emit("wall", seconds_before_checkpoint_phase=t_new - t_script,
         seconds_of_checkpoint_to_hier=time.perf_counter() - t_new,
         seconds_total=time.perf_counter() - t_script, phases=phases)

    lines = []
    for kname, (key, tpu_line, tpu_body) in KERNELS.items():
        lines.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{TPU_SOURCE}:{tpu_line}", "tpu_source": f"{TPU_SOURCE}:{tpu_body}",
            "launches": train["launches"][key],
            "ring_launches": ring_launches[key],
            # a step, per rank: the pipeline's 4 steps and TP's 3 divided out
            "pipeline_launches_per_step": [r[key] / PP_STEPS for r in par_launches["pipeline"]],
            "tp_launches_per_step": [r[key] / TP_STEPS for r in par_launches["tp"]],
            "sma_launches": [r[key] for r in sma_launches],
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


def _dispatch(argv) -> int:
    if "--elastic-worker" in argv:
        return elastic_worker()
    if "--checkpoint-worker" in argv:
        i = argv.index("--checkpoint-worker")
        return checkpoint_worker(argv[i + 1], argv[i + 2], argv[i + 3] == "1")
    if "--forensics-worker" in argv:
        return forensics_worker(argv[argv.index("--forensics-worker") + 1])
    if "--adaptive-worker" in argv:
        return adaptive_worker()
    return main()


if __name__ == "__main__":
    sys.exit(_dispatch(sys.argv[1:]))

"""Allreduce throughput benchmark.

Port of `kungfu_tpu/benchmarks/__main__.py` (parity: python -m
kungfu.tensorflow.v1.benchmarks,
srcs/python/kungfu/tensorflow/v1/benchmarks/__main__.py) — measure
allreduce bus throughput over a fake model's gradient set and print
``RESULT: <v> +-<e> (GiB/s)``. Methods:
  XLA   — the device plane's all-reduce (`ops.collective` over the
          `parallel` session: NCCL on the card, gloo on the CPU); the
          method keeps the JAX package's name, whose device plane is XLA
  HOST  — the host-side graph-walk engine (run under kfrun)
  P2P   — model requests over the versioned p2p store (run under kfrun)
  GNS   — the gradient-noise-scale monitor's overhead on the MLP

    python -m kungfu_tpu_torch.benchmarks [--method XLA|HOST|P2P|GNS] [--device cpu]

The device paths (XLA, GNS) run on the CUDA card unless `--device cpu`
asks for the CPU; the host paths move CPU tensors over the host plane.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from kungfu_tpu_torch.telemetry import log


def _sync(device: torch.device) -> None:
    """Wait for `device`'s queued work (the card's), so a host clock
    around it times the device."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_xla(model: str, iters: int, warmup: int = 3, device=None) -> dict:
    """The device plane's all-reduce of `model`'s fake gradient buffers
    (ones, f32) over the world the runner's environment names (a world of
    one without one): `ops.collective.group_all_reduce` on the `parallel`
    session, NCCL on the card, gloo on the CPU. Returns the numbers of the
    RESULT line and the last call's inputs and sums, which are the inputs
    times the world's size, exactly."""
    from kungfu_tpu_torch.models.fake import FAKE_MODELS
    from kungfu_tpu_torch.ops.collective import group_all_reduce
    from kungfu_tpu_torch.parallel import initialize_device_plane, make_mesh

    sizes = FAKE_MODELS[model]
    device = initialize_device_plane(device)
    sess = make_mesh(device)
    n = sess.size
    xs = [torch.ones(s, dtype=torch.float32, device=device) for s in sizes]
    for _ in range(warmup):
        out = group_all_reduce(xs, group=sess.group)
    _sync(device)

    samples = []
    total_bytes = sum(s * 4 for s in sizes)
    for _ in range(iters):
        t0 = time.perf_counter()
        out = group_all_reduce(xs, group=sess.group)
        _sync(device)
        dt = time.perf_counter() - t0
        # algorithm bandwidth: 2(n-1)/n factors omitted — report bus data rate
        samples.append(total_bytes / dt / (1 << 30))
    mean, err = float(np.mean(samples)), float(1.96 * np.std(samples))
    log.echo(f"RESULT: {mean:.3f} +-{err:.3f} (GiB/s) [XLA x{n} devices, {model}]")
    return {"gib_s": mean, "err": err, "devices": n, "samples": samples,
            "inputs": xs, "outs": out}


def _wire_samples() -> dict:
    """Per-(collective, strategy, codec) wire-byte counter values for
    THIS worker process (each worker owns its registry, so these are
    true per-peer numbers — the in-process test suite only sees
    aggregates)."""
    from kungfu_tpu_torch.telemetry import metrics as tmetrics

    ctr = tmetrics.counter(
        "kungfu_collective_wire_bytes_total",
        "Host-plane collective payload bytes sent by this peer",
        ("collective", "strategy", "codec"),
    )
    return {labels: value for _, labels, value in ctr.samples()}


def _wire_saved() -> float:
    """Total bytes the codec kept off the wire (this peer)."""
    from kungfu_tpu_torch.telemetry import metrics as tmetrics

    ctr = tmetrics.counter(
        "kungfu_collective_wire_saved_bytes_total",
        "Wire bytes saved by the collective codec on this peer",
        ("collective", "codec"),
    )
    return sum(value for _, _, value in ctr.samples())


def bench_host_wire_ab(model: str, iters: int, warmup: int = 4) -> None:
    """Paired same-process wire-codec A/B: measure `iters` with the
    configured codec, then toggle the codec candidate IN-PLACE on every
    worker (adaptive.advance() to candidate 1 — the same lockstep move
    an interference vote makes) and measure `iters` again. Both legs
    share one process, one session and one slice of host time, so
    run-to-run scheduler drift — which on a shared host can exceed the
    codec's win — cancels out of the ratio."""
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.models.fake import fake_gradients
    from kungfu_tpu_torch.peer import get_default_peer

    grads = _tensors(fake_gradients(model))
    outs = [torch.empty_like(g) for g in grads]
    total_bytes = sum(g.nbytes for g in grads)
    sess = get_default_peer().current_session()
    legs: dict = {}
    rounds = 8  # 4 alternating rounds per mode
    per = max(2, iters // 4)
    api.run_barrier()

    def toggle() -> None:
        # lockstep flip between candidates 0 and 1 — the same
        # (strategy, codec-toggled) pair an interference vote would
        # move to; deterministic on every peer, barrier'd so no walk
        # straddles the flip (candidate 2+ would change the GRAPHS,
        # which is not what this A/B measures)
        sess.adaptive.active = 1 - sess.adaptive.active
        api.run_barrier()

    for i in range(warmup):
        api.group_all_reduce_arrays(grads, name=f"wu:{i}", outs=outs)
    for rnd in range(rounds):
        mode = sess._active_wire_mode()
        # one settle iteration after each flip: the first walk on a new
        # wire format faults in its pooled staging sizes
        api.group_all_reduce_arrays(grads, name=f"settle:{rnd}", outs=outs)
        samples = legs.setdefault(mode, [])
        for i in range(per):
            t0 = time.perf_counter()
            api.group_all_reduce_arrays(grads, name=f"ab:{rnd}:{i}", outs=outs)
            samples.append(total_bytes / (time.perf_counter() - t0) / (1 << 30))
        toggle()
    if api.current_rank() == 0:
        meds = {m: float(np.median(s)) for m, s in legs.items()}
        for m, s in legs.items():
            log.echo(
                f"RESULT: {float(np.mean(s)):.3f} "
                f"+-{float(1.96 * np.std(s)):.3f} (GiB/s) "
                f"median {meds[m]:.3f} [HOST-AB wire={m}, "
                f"x{api.cluster_size()} workers, {model}, "
                f"{len(s)} interleaved samples]"
            )
        modes = list(meds)
        if len(modes) == 2:
            on = next((m for m in modes if m != "off"), modes[0])
            off = "off" if "off" in meds else modes[1]
            log.echo(
                f"RESULT: wire={on} / wire={off} median speedup: "
                f"{meds[on] / meds[off]:.2f}x [interleaved paired, {model}]"
            )


def _simulated_backprop(grads, scratch, passes: int = 16) -> None:
    """Deterministic per-tensor FLOP load standing in for backward-pass
    compute (the bench has no real model). 16 passes of elementwise
    work per parameter is a LOW bound on a real backward pass's
    FLOP-to-gradient-bytes ratio (a conv/matmul backward touches each
    weight far more than 16 times), so the overlap this measures is the
    conservative end of what a real step offers the scheduler. Both
    legs pay the identical load, so the A/B ratio stays drift-free, and
    it never mutates the gradients — the bit-identity claim depends on
    both legs reducing the same bytes."""
    for g, s in zip(grads, scratch):
        for _ in range(passes):
            torch.mul(g, 1.0000001, out=s)


def _tensors(arrays) -> list:
    """The fake model's numpy buffers as CPU tensors (shared memory)."""
    return [torch.from_numpy(a) for a in arrays]


def bench_host_async_ab(model: str, iters: int, warmup: int = 4,
                        passes: int = 16) -> None:
    """Paired same-process async-scheduler A/B: the SYNC leg
    runs the serial step loop — simulate every tensor's backward
    compute, then one step-end `group_all_reduce_arrays` — while the
    ASYNC leg submits each tensor to the background scheduler the moment
    its compute finishes (readiness order: last layer first, like real
    backprop) and only flushes the tail. Legs interleave in alternating
    rounds within one process/session, so box drift cancels out of the
    ratio exactly like --wire-ab. The OVERLAP line reports the measured
    flush-wait vs engine-busy time — flush-wait ≪ walk time is the
    overlap actually happening, not inferred."""
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.models.fake import fake_gradients
    from kungfu_tpu_torch.peer import get_default_peer

    grads = _tensors(fake_gradients(model))
    outs = [torch.empty_like(g) for g in grads]
    scratch = [torch.empty_like(g) for g in grads]
    total_bytes = sum(g.nbytes for g in grads)
    sess = get_default_peer().current_session()
    if not sess.async_enabled():
        raise SystemExit(
            "--async A/B needs the scheduler: KF_CONFIG_ASYNC=on|auto "
            "must reach every worker before the session comes up (the "
            "--async flag sets it process-wide; under kfrun use "
            "KF_BENCH_ASYNC with the bench agent)"
        )
    sched = sess.scheduler()
    n = len(grads)
    legs: dict = {"sync": [], "async": []}
    rounds = 8  # 4 alternating rounds per mode
    # unlike --wire-ab, allow per=1: the async A/B pays a simulated
    # backward per sample, so bert-size sets at 16 steps blow through
    # any reasonable harness timeout — --iters controls the budget
    per = max(1, iters // 4)

    def run_sync(tag: str) -> None:
        _simulated_backprop(grads, scratch, passes)
        api.group_all_reduce_arrays(grads, name=tag, outs=outs)

    def run_async() -> None:
        # readiness order: reversed (the last layer's gradient exists
        # first); registration pins the launch order from round one, so
        # every peer walks identical bucket sequences regardless
        for i in reversed(range(n)):
            _simulated_backprop(grads[i : i + 1], scratch[i : i + 1], passes)
            api.group_all_reduce_async(
                [grads[i]], name=f"b{i}", outs=[outs[i]]
            )
        api.flush_async()

    api.run_barrier()
    for i in range(warmup):
        run_sync(f"wu:{i}")
    run_async()  # registration round + async staging warmup
    api.run_barrier()
    stats0 = sched.stats()
    for rnd in range(rounds):
        mode = "sync" if rnd % 2 == 0 else "async"
        samples = legs[mode]
        for it in range(per):
            t0 = time.perf_counter()
            if mode == "sync":
                # per-iteration names: a fast worker's next-iteration
                # sends must not be consumed by a slow worker still in
                # this one (same reason as --wire-ab's ab:{rnd}:{i})
                run_sync(f"ab:{rnd}:{it}")
            else:
                run_async()
            samples.append(
                total_bytes / (time.perf_counter() - t0) / (1 << 30)
            )
        api.run_barrier()
    stats1 = sched.stats()
    if api.current_rank() != 0:
        return
    meds = {m: float(np.median(s)) for m, s in legs.items()}
    for m, s in legs.items():
        log.echo(
            f"RESULT: {float(np.mean(s)):.3f} "
            f"+-{float(1.96 * np.std(s)):.3f} (GiB/s) "
            f"median {meds[m]:.3f} [HOST-AB async={m}, "
            f"x{api.cluster_size()} workers, {model}, "
            f"{len(s)} interleaved samples]"
        )
    log.echo(
        f"RESULT: async / sync median speedup: "
        f"{meds['async'] / meds['sync']:.2f}x [interleaved paired, "
        f"{model}, simulated backprop]"
    )
    a_rounds = max(1, stats1["rounds"] - stats0["rounds"])
    flush_wait = (stats1["flush_wait_s"] - stats0["flush_wait_s"]) / a_rounds
    busy = (stats1["busy_s"] - stats0["busy_s"]) / a_rounds
    overlap = (stats1["overlap_s"] - stats0["overlap_s"]) / a_rounds
    frac = overlap / busy if busy > 0 else 0.0
    ratio = flush_wait / busy if busy > 0 else float("inf")
    log.echo(
        f"OVERLAP {model}: flush-wait {flush_wait * 1e3:.1f} ms vs walk "
        f"{busy * 1e3:.1f} ms per step — {frac:.0%} of engine time "
        f"overlapped with backprop (flush-wait/walk {ratio:.2f})"
    )


def bench_host_zero_ab(model: str, iters: int) -> None:
    """Paired same-process ZeRO-1 A/B: the REPLICATED leg
    runs the classic step — simulated backward, step-end group
    allreduce, full-param SGD update with full-size momentum on every
    peer — while the SHARDED leg submits each tensor to the sharded
    update session as its compute finishes (reduce-scatter → 1/k shard
    update → weight all-gather, all riding the async scheduler) and
    defers the weight barrier to the TOP of the next step, so tail
    all-gathers overlap the next step's simulated backward. Legs
    interleave in alternating rounds within one process/session like
    --wire-ab, so box drift cancels out of the ratio. Reports per-leg
    RESULT throughput, the UPDATE line (full vs 1/k optimizer-update
    seconds), the STATE line (full vs shard optimizer bytes), per-leg
    WIRE lines (2·(k-1)/k·N allreduce vs (k-1)/k·N reduce-scatter +
    (k-1)/k·N[/2] weight all-gather) and the scheduler OVERLAP line."""
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.collective.zero import ShardedSGD, ShardedUpdateSession
    from kungfu_tpu_torch.models.fake import fake_gradients
    from kungfu_tpu_torch.peer import get_default_peer
    from kungfu_tpu_torch.telemetry import metrics as tmetrics

    lr, momentum = 0.1, 0.9
    grads = _tensors(fake_gradients(model))
    params_r = _tensors(fake_gradients(model, seed=1))
    params_z = _tensors(fake_gradients(model, seed=1))
    outs = [torch.empty_like(g) for g in grads]
    scratch = [torch.empty_like(g) for g in grads]
    total_bytes = sum(g.nbytes for g in grads)
    k = api.cluster_size()
    sess = get_default_peer().current_session()
    if not sess.async_enabled():
        raise SystemExit(
            "--zero A/B needs the scheduler: KF_CONFIG_ASYNC=on|auto must "
            "reach every worker before the session comes up (the --zero "
            "flag sets it process-wide; under kfrun use KF_BENCH_ZERO "
            "with the bench agent)"
        )
    zs = ShardedUpdateSession(params_z, ShardedSGD(lr, momentum),
                              name="zbench", session=sess)
    repl_opt = ShardedSGD(lr, momentum)
    repl_state = [repl_opt.init(g.numel()) for g in grads]
    # replicated optimizer state = full-size momentum on every peer
    # (the params themselves are its masters)
    repl_state_bytes = sum(
        a.nbytes for st in repl_state for a in st.values()
    )
    n = len(grads)
    sched = sess.scheduler()
    update_ctr = tmetrics.counter(
        "kungfu_sharded_update_seconds_total",
        "Seconds spent in the shard-local optimizer update "
        "(the k-fold-reduced update FLOPs of ZeRO-1)",
    )
    repl_update_s = 0.0

    def run_repl(tag: str) -> None:
        nonlocal repl_update_s
        _simulated_backprop(grads, scratch)
        api.group_all_reduce_arrays(grads, name=tag, outs=outs)
        t0 = time.perf_counter()
        for i in range(n):
            repl_opt.apply(params_r[i], outs[i], repl_state[i], 1.0 / k)
        repl_update_s += time.perf_counter() - t0

    def run_zero() -> None:
        # the previous step's tail weight all-gathers land while THIS
        # step's backward computes — wait only at the point the params
        # would actually be consumed
        zs.wait_params()
        for i in reversed(range(n)):  # readiness order: last layer first
            _simulated_backprop(grads[i:i + 1], scratch[i:i + 1])
            zs.submit_grad(i, grads[i])
        zs.flush()

    api.run_barrier()
    for i in range(2):
        run_repl(f"wu:{i}")
    run_zero()  # registration round + staging warmup
    api.run_barrier()
    legs: dict = {"replicated": [], "sharded": []}
    wire: dict = {"replicated": {}, "sharded": {}}
    rounds = 8
    per = max(1, iters // 4)
    stats0 = sched.stats()
    repl_update_s = 0.0
    update0 = update_ctr.value
    repl_rounds = zero_rounds = 0
    for rnd in range(rounds):
        mode = "replicated" if rnd % 2 == 0 else "sharded"
        samples = legs[mode]
        before = _wire_samples()
        for it in range(per):
            t0 = time.perf_counter()
            if mode == "replicated":
                run_repl(f"ab:{rnd}:{it}")
                repl_rounds += 1
            else:
                run_zero()
                zero_rounds += 1
            samples.append(
                total_bytes / (time.perf_counter() - t0) / (1 << 30)
            )
        if mode == "sharded":
            zs.wait_params()  # attribute the tail to the leg it belongs to
        after = _wire_samples()
        for labels, v in after.items():
            d = v - before.get(labels, 0.0)
            if d > 0:
                wire[mode][labels] = wire[mode].get(labels, 0.0) + d
        api.run_barrier()
    stats1 = sched.stats()
    zero_update_s = update_ctr.value - update0
    if api.current_rank() != 0:
        return
    meds = {m: float(np.median(s)) for m, s in legs.items()}
    for m, s in legs.items():
        log.echo(
            f"RESULT: {float(np.mean(s)):.3f} "
            f"+-{float(1.96 * np.std(s)):.3f} (GiB/s) "
            f"median {meds[m]:.3f} [HOST-AB zero={m}, "
            f"x{k} workers, {model}, {len(s)} interleaved samples]"
        )
    log.echo(
        f"RESULT: sharded / replicated median speedup: "
        f"{meds['sharded'] / meds['replicated']:.2f}x [interleaved "
        f"paired, {model}, simulated backprop]"
    )
    ru = repl_update_s / max(1, repl_rounds) * 1e3
    zu = zero_update_s / max(1, zero_rounds) * 1e3
    log.echo(
        f"UPDATE {model}: replicated {ru:.1f} ms/step vs sharded "
        f"{zu:.1f} ms/step ({ru / zu if zu > 0 else float('inf'):.1f}x "
        f"less update compute at k={k})"
    )
    mom_bytes = sum(
        a.nbytes for b in zs._buckets for a in b.state.values()
    )
    master_bytes = sum(b.master.nbytes for b in zs._buckets)
    log.echo(
        f"STATE {model}: replicated {repl_state_bytes / (1 << 20):.1f} MiB "
        f"momentum vs sharded {zs.state_bytes() / (1 << 20):.1f} MiB "
        f"(momentum {mom_bytes / (1 << 20):.1f} — {repl_state_bytes / max(1, mom_bytes):.1f}x "
        f"less — + f32 shard masters {master_bytes / (1 << 20):.1f}); "
        f"total {repl_state_bytes / max(1, zs.state_bytes()):.1f}x less per peer"
    )
    for mode in ("replicated", "sharded"):
        per_leg = max(1, per * rounds // 2)
        for labels, d in sorted(wire[mode].items()):
            per_iter = d / per_leg
            log.echo(
                f"WIRE zero={mode} {labels}: {per_iter / (1 << 20):.1f} "
                f"MiB/iter ({per_iter / total_bytes:.2f}x payload)"
            )
    a_rounds = max(1, stats1["rounds"] - stats0["rounds"])
    flush_wait = (stats1["flush_wait_s"] - stats0["flush_wait_s"]) / a_rounds
    busy = (stats1["busy_s"] - stats0["busy_s"]) / a_rounds
    overlap = (stats1["overlap_s"] - stats0["overlap_s"]) / a_rounds
    frac = overlap / busy if busy > 0 else 0.0
    log.echo(
        f"OVERLAP {model}: flush-wait {flush_wait * 1e3:.1f} ms vs engine "
        f"{busy * 1e3:.1f} ms per step — {frac:.0%} of engine time "
        f"(reduce-scatter + update + weight all-gather) overlapped with "
        f"caller compute"
    )


# the weighted-segments leg of the --replan A/B: the compute-shaped
# peer's slowdown, the simulated update's seconds per element, and the
# elements reduce-scattered a step (16 MiB f32)
SEG_SLOW_FACTOR = 4.0
SEG_COST_PER_ELEM = 400e-9
SEG_ELEMS = 4 << 20


def bench_host_replan_ab(model: str, iters: int, warmup: int = 4,
                         decisions: bool = False) -> None:
    """Paired same-process measured-topology A/B, two legs.

    **Ring order** — run under the harness's ``KF_SHAPE_LINKS`` shape
    (e.g. one slowed edge): warm up on the NAIVE ring so the link table
    measures the shaped edges, run one lockstep re-plan round
    (``check_replan`` — vote, row exchange, pure derivation, digest-
    asserted adoption: the exact production path), then alternate
    measured-order and naive-order rounds within one process/session so
    box drift cancels out of the ratio like every other HOST A/B.

    **Weighted segments** — a compute-shaped peer (rank k-1 pays
    ``_SLOW_FACTOR``× per element of its owned shard, standing in for a
    busy/thermally-throttled host's optimizer update): alternate equal
    segments with throughput-weighted ones derived from the MEASURED
    per-peer update speed (exchanged over the ring, fed through
    ``replan.weights_from_throughput`` — the same clamp/normalize the
    vote path uses), reporting per-leg step medians and the ratio.

    ``decisions``: feed the decision ledger the same timed
    rounds — baseline rounds before the vote, measured-leg rounds after
    — so the ``topology_replanned`` decision the adoption opens closes
    with a ledger-measured realized gain, reported as DECISIONS lines
    next to the paired-A/B headline it must agree with."""
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.base.ops import ReduceOp
    from kungfu_tpu_torch.base.workspace import Workspace
    from kungfu_tpu_torch.models.fake import fake_gradients
    from kungfu_tpu_torch.peer import get_default_peer
    from kungfu_tpu_torch.plan import replan as rp

    grads = _tensors(fake_gradients(model))
    outs = [torch.empty_like(g) for g in grads]
    total_bytes = sum(g.nbytes for g in grads)
    sess = get_default_peer().current_session()
    k, rank = sess.size, sess.rank
    api.run_barrier()
    for i in range(warmup):
        api.group_all_reduce_arrays(grads, name=f"wu:{i}", outs=outs)
    # matrix probe sweep: the naive ring only measures its own k
    # successor edges, so the planner would be blind to every edge it
    # could move ONTO. A real training run accumulates that coverage
    # from its broader traffic (broadcasts, gathers, elastic state
    # sync, strategy changes); the bench stands that in with two
    # rank-rotating 128 KiB broadcasts — every directed edge gets a
    # bandwidth estimate (two sweeps: the first send on a fresh edge
    # dials and is excluded as a sample), at ~k·(k-1)·128 KiB total
    probe = torch.ones((128 << 10) // 4, dtype=torch.float32)  # 128 KiB
    for sweep in range(2):
        for root in range(k):
            api.broadcast_array(
                probe, root=root, name=f"replan:probe:{sweep}:{root}"
            )
    api.run_barrier()
    ledger = None
    if decisions:
        from kungfu_tpu_torch.telemetry import decisions as tdec

        ledger = tdec.get_ledger()
        # baseline rounds on the naive ring: the step history the
        # adoption's decision record snapshots as its BEFORE window
        for i in range(ledger.window + 1):
            t0 = time.perf_counter()
            api.group_all_reduce_arrays(grads, name=f"dbase:{i}", outs=outs)
            ledger.note_step(time.perf_counter() - t0)
    # one production re-plan round: every peer votes yes (the bench IS
    # the standing bottleneck signal), rows are exchanged, the plan is
    # derived and digest-assert adopted
    plan = sess.check_replan(want=True, min_gain=1.0)
    if api.current_rank() == 0:
        log.echo(
            f"REPLAN {model}: "
            + (
                f"adopted {plan.describe()} (predicted gain "
                f"{plan.gain:.2f}x)" if plan is not None
                else "no plan adopted (uninformative matrix — is "
                "KF_SHAPE_LINKS set and the payload above the bw gate?)"
            )
        )
    legs: dict = {"naive": [], "measured": []}
    rounds = 8
    per = max(2, iters // 4)
    for rnd in range(rounds):
        mode = "naive" if rnd % 2 == 0 else "measured"
        # lockstep toggle at a barrier, like --wire-ab's candidate flip:
        # every peer swaps the same plan, no walk straddles it
        sess._ring_plan = None if mode == "naive" else plan
        api.run_barrier()
        api.group_all_reduce_arrays(grads, name=f"settle:{rnd}", outs=outs)
        for i in range(per):
            t0 = time.perf_counter()
            api.group_all_reduce_arrays(grads, name=f"ab:{rnd}:{i}", outs=outs)
            dt = time.perf_counter() - t0
            legs[mode].append(total_bytes / dt / (1 << 30))
            if ledger is not None and mode == "measured":
                # only the post-flip configuration's rounds feed the
                # decision's AFTER window — the interleaved naive
                # rounds are the A/B's control leg, not the adopted
                # plan's steady state
                ledger.note_step(dt)
    sess._ring_plan = None
    api.run_barrier()
    if api.current_rank() == 0:
        meds = {m: float(np.median(s)) for m, s in legs.items()}
        for m, s in legs.items():
            log.echo(
                f"RESULT: {float(np.mean(s)):.3f} "
                f"+-{float(1.96 * np.std(s)):.3f} (GiB/s) "
                f"median {meds[m]:.3f} [HOST-AB ring={m}, "
                f"x{api.cluster_size()} workers, {model}, "
                f"{len(s)} interleaved samples]"
            )
        if plan is not None and meds["naive"] > 0:
            log.echo(
                f"RESULT: measured-order / naive-order median speedup: "
                f"{meds['measured'] / meds['naive']:.2f}x "
                f"[interleaved paired, {model}, shaped]"
            )
        if ledger is not None:
            recs = [r.to_json() for r in ledger.records()]
            for rec in recs:
                log.echo(
                    f"DECISIONS {model}: {rec.get('kind')} "
                    f"[{rec.get('trigger', '')}] predicted "
                    + (
                        f"{rec['predicted_gain']:.2f}x"
                        if rec.get("predicted_gain") is not None else "—"
                    )
                    + " realized "
                    + (
                        f"{rec['realized_gain']:.2f}x"
                        if rec.get("realized_gain") is not None else "—"
                    )
                    + f" verdict {rec.get('verdict') or rec.get('status')}"
                )
            closed = [
                r for r in recs
                if r.get("kind") == "topology_replanned"
                and r.get("realized_gain")
            ]
            if closed and plan is not None and meds["naive"] > 0:
                ab = meds["measured"] / meds["naive"]
                rg = closed[-1]["realized_gain"]
                log.echo(
                    f"DECISIONS {model}: ledger realized {rg:.2f}x vs "
                    f"paired-A/B {ab:.2f}x — agreement "
                    f"{abs(rg / ab - 1):.0%} (acceptance 15%)"
                )

    # ---- weighted segments vs equal, compute-shaped peer -------------
    # BOTH legs run the measured ring ORDER (when one was adopted), so
    # the shaped edge stays routed-around and the only variable is the
    # segment sizing — the lever this leg measures
    _SLOW_FACTOR = SEG_SLOW_FACTOR
    _COST_PER_ELEM = SEG_COST_PER_ELEM
    n = SEG_ELEMS
    base_order = plan.order if plan is not None else tuple(range(k))
    eq_plan = None if plan is None else rp.RingPlan(order=base_order)
    cost = _COST_PER_ELEM * (_SLOW_FACTOR if rank == k - 1 else 1.0)
    x = torch.ones(n, dtype=torch.float32)
    out = torch.empty_like(x)

    def shard_step(tag: str) -> float:
        t0 = time.perf_counter()
        b, e = sess.reduce_scatter(Workspace(
            send=x, recv=out, op=ReduceOp.SUM, name=f"{tag}:rs",
        ))
        time.sleep((e - b) * cost)  # the owned-shard update
        full = torch.zeros_like(x)
        full[b:e] = out[b:e]
        sess.all_gather_shards(full, f"{tag}:ag")
        dt = time.perf_counter() - t0
        api.run_barrier()
        return dt

    # measure each peer's update speed, exchange it, derive the weights
    # every peer computes identically (pure function of shared input)
    speeds = torch.zeros(k, dtype=torch.float32)
    speeds[rank] = float(np.float32(1.0 / cost))
    speeds_out = api.all_reduce_array(speeds, ReduceOp.SUM,
                                      "replan:update-speeds")
    rank_w = rp.weights_from_throughput(speeds_out.double().tolist())
    wplan = eq_plan
    if rank_w is not None:
        wplan = rp.RingPlan(
            order=base_order,
            weights=rp.segment_weights(base_order, rank_w),
        )
    shard_step("wu-seg")  # warmup
    seg_legs: dict = {"equal": [], "weighted": []}
    for rnd in range(rounds):
        mode = "equal" if rnd % 2 == 0 else "weighted"
        sess._ring_plan = eq_plan if mode == "equal" else wplan
        api.run_barrier()
        for i in range(per):
            seg_legs[mode].append(shard_step(f"seg:{rnd}:{i}"))
    sess._ring_plan = None
    api.run_barrier()
    if api.current_rank() == 0:
        meds = {m: float(np.median(s)) * 1e3 for m, s in seg_legs.items()}
        for m, s in seg_legs.items():
            log.echo(
                f"RESULT: {float(np.mean(s)) * 1e3:.1f} "
                f"+-{float(1.96 * np.std(s)) * 1e3:.1f} ms/step "
                f"median {meds[m]:.1f} [HOST-AB segments={m}, "
                f"x{api.cluster_size()} workers, rs+update+ag {n * 4 >> 20}MiB, "
                f"slow-rank x{_SLOW_FACTOR:.0f} compute, "
                f"{len(s)} interleaved samples]"
            )
        if wplan is not None and meds["weighted"] > 0:
            log.echo(
                f"RESULT: equal / weighted median step-time ratio: "
                f"{meds['equal'] / meds['weighted']:.2f}x "
                f"[interleaved paired, compute-shaped peer]"
            )


def report_steps(model: str) -> None:
    """The --steps report: per-step critical-path summary
    from the step plane itself — overlap measured per recorded timeline
    (replacing the scheduler-side flush-wait proxy as the headline
    number; both print so drift between the two planes is visible), the
    submit→launch queue-delay fraction, and the bucket that was the
    long pole most often with its attributed edge. Rank 0 only; reads
    this worker's own /steptrace ring (the bench has no aggregator, so
    the election is over local lanes)."""
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.telemetry import steptrace

    if api.current_rank() != 0:
        return
    tls = steptrace.get_store().timelines()
    done = [t for t in tls if t.get("busy_us")]
    if not done:
        log.echo(
            f"STEPS {model}: no recorded step timelines (the step plane "
            "records scheduler rounds; needs KF_CONFIG_ASYNC=on|auto and "
            "KF_TELEMETRY_SPAN_SAMPLE > 0)"
        )
        return
    ov = [t["overlap_frac"] for t in done if t.get("overlap_frac") is not None]
    qd = [
        t["queue_delay_frac"] for t in done
        if t.get("queue_delay_frac") is not None
    ]
    busy_ms = sum(t["busy_us"] for t in done) / len(done) / 1e3
    flush_ms = sum(t.get("flush_wait_us") or 0 for t in done) / len(done) / 1e3
    log.echo(
        f"STEPS {model}: {len(done)} recorded steps, overlap "
        f"{sum(ov) / len(ov):.0%} (step plane)"
        + (f", queue delay {sum(qd) / len(qd):.1%}" if qd else "")
        + f", engine {busy_ms:.1f} ms vs flush-wait {flush_ms:.1f} ms per step"
    )
    # most-frequent critical bucket across the recorded steps, elected
    # with the cluster merge's own math over this worker's lanes
    wins: dict = {}
    for t in done:
        elected = steptrace.critical_path({"self": t})
        c = elected.get("critical")
        if not c:
            continue
        key = (c.get("bucket"), c.get("name"), c.get("edge"))
        agg = wins.setdefault(key, {"n": 0, "self_us": 0.0})
        agg["n"] += 1
        agg["self_us"] += c["self_us"]
    for (bucket, name, edge), agg in sorted(
        wins.items(), key=lambda kv: -kv[1]["n"]
    )[:3]:
        log.echo(
            f"STEPS critical: bucket {bucket} {name} in "
            f"{agg['n']}/{len(done)} steps, self "
            f"{agg['self_us'] / agg['n'] / 1e3:.1f} ms/step"
            + (f", edge →{edge}" if edge else "")
        )


def report_resources(model: str) -> None:
    """The --resources report: where this worker's CPU time
    actually went during the bench, from the resource plane's per-thread
    accounting — the window spans the bench because main() anchors a
    baseline sweep before dispatch. Rank 0 only; reads this worker's own
    plane (the bench has no aggregator). The ceiling line is the same
    Amdahl clamp derive_plan applies: a peer that burned cf of a core on
    compute cannot speed up more than 1/cf by re-ordering the ring, so
    a raw predicted gain above that is the r12 86x-style fiction."""
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.telemetry import resource

    if api.current_rank() != 0:
        return
    plane = resource.get_plane()
    if not plane.acct.supported():
        log.echo(
            f"RESOURCES {model}: /proc per-thread accounting unsupported "
            "on this platform"
        )
        return
    plane.maybe_sweep(force=True)
    doc = plane.export()
    if doc.get("sweeps", 0) < 2 or not doc.get("window_s"):
        log.echo(
            f"RESOURCES {model}: no accounting window (plane came up "
            "after the bench?)"
        )
        return
    buckets = doc.get("buckets") or {}
    parts = ", ".join(
        f"{b} {info['frac']:.0%}"
        for b in resource.BUCKETS
        for info in [buckets.get(b) or {}]
        if info.get("frac")
    )
    log.echo(
        f"RESOURCES {model}: cpu {doc.get('cpu_frac') or 0.0:.0%} of "
        f"{doc['cores']} core(s) over {doc['window_s']:.1f} s, engine "
        f"{doc.get('engine_frac') or 0.0:.0%} of busy"
        + (f" [{parts}]" if parts else "")
        + (" SATURATED" if doc.get("saturated") else "")
    )
    cf = plane.compute_frac()
    if cf > 0.0:
        log.echo(
            f"RESOURCES ceiling: compute floor {cf:.2f} clamps any "
            f"predicted re-plan gain to <= {1.0 / max(cf, 1e-6):.2f}x "
            "(derive_plan's Amdahl clamp; a raw prediction above this "
            "is unrealizable on this peer)"
        )


def report_memory(model: str) -> None:
    """The --memory report: where this worker's RSS actually
    sits after the bench, from the memory plane's registered
    accountants. Rank 0 only; reads this worker's own plane (the bench
    has no aggregator). Riding the --zero A/B this is the
    paper-replication number measured rather than computed: the
    ``zero_state`` bucket holds the sharded session's live shard bytes
    (1/k momentum + f32 shard masters), straight from the accountant
    the session registered — the STATE line's claim, asserted from the
    plane that the autoscaler actually consults."""
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.telemetry import memory as tmemory

    if api.current_rank() != 0:
        return
    plane = tmemory.get_plane()
    if not plane.supported():
        log.echo(
            f"MEMORY {model}: /proc RSS accounting unsupported on this "
            "platform"
        )
        return
    plane.maybe_sweep(force=True)
    doc = plane.export()
    rss = doc.get("rss_bytes")
    if not rss:
        log.echo(f"MEMORY {model}: no RSS sample (plane came up late?)")
        return
    limit = doc.get("limit_bytes")
    hf = doc.get("headroom_frac")
    buckets = doc.get("buckets") or {}
    parts = ", ".join(
        f"{b} {tmemory.fmt_bytes(info['bytes'])} ({info['frac']:.0%})"
        for b in tmemory.BUCKETS
        for info in [buckets.get(b) or {}]
        if info.get("bytes")
    )
    log.echo(
        f"MEMORY {model}: rss {tmemory.fmt_bytes(rss)}"
        + (f" of {tmemory.fmt_bytes(limit)} limit" if limit else "")
        + (
            f" ({hf:.0%} headroom)"
            if isinstance(hf, (int, float)) else ""
        )
        + (f" [{parts}]" if parts else "")
    )
    zero_names = {
        name: nbytes
        for name, nbytes in (doc.get("accountants") or {}).items()
        if name.startswith("zero:")
    }
    for name, nbytes in sorted(zero_names.items()):
        log.echo(
            f"MEMORY {model}: sharded optimizer state ({name}): "
            f"{tmemory.fmt_bytes(nbytes)} per peer, measured from the "
            "plane's accountant (1/k momentum + f32 shard masters)"
        )
    leaks = doc.get("leak_suspects") or []
    if leaks:
        log.echo(
            f"MEMORY {model}: LEAK SUSPECTS over the bench window: "
            + ", ".join(leaks)
        )


def bench_host(model: str, iters: int, warmup: int = 4) -> None:
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.models.fake import fake_gradients

    from kungfu_tpu_torch.collective.profiler import get_walk_profiler

    grads = _tensors(fake_gradients(model))
    outs = [torch.empty_like(g) for g in grads]
    total_bytes = sum(g.nbytes for g in grads)
    api.run_barrier()
    # warmup: connection + shm-arena setup and first-touch page faults
    # belong to session bring-up, not steady-state bandwidth (the XLA
    # bench warms up identically). 4 rounds, not 2: the wire codec's
    # pooled staging buffers (wire + encode scratches) are new exact-
    # size pool bins whose first-touch ramp can last past 2 iterations
    for i in range(warmup):
        api.group_all_reduce_arrays(grads, name=f"warmup:{i}", outs=outs)
    wire_before = _wire_samples()
    saved_before = _wire_saved()
    # the EFF report below must describe the measured iterations only:
    # warmup walks run on cold pools and would drag the attribution
    get_walk_profiler().reset()
    samples = []
    for i in range(iters):
        t0 = time.perf_counter()
        api.group_all_reduce_arrays(grads, name=f"bench:{i}", outs=outs)
        dt = time.perf_counter() - t0
        samples.append(total_bytes / dt / (1 << 30))
    wire_after = _wire_samples()
    saved = _wire_saved() - saved_before
    mean, err = float(np.mean(samples)), float(1.96 * np.std(samples))
    if api.current_rank() == 0:
        med = float(np.median(samples))
        log.echo(
            f"RESULT: {mean:.3f} +-{err:.3f} (GiB/s) median {med:.3f} "
            f"[HOST x{api.cluster_size()} workers, {model}]"
        )
        # per-peer wire bytes (this rank): the A/B numbers behind the
        # segmented engine (2(k-1)/k x payload vs full-payload relays)
        # and the wire codec (a further /2 on compressed series); labels
        # are (collective, strategy, codec)
        for labels, after in sorted(wire_after.items()):
            delta = after - wire_before.get(labels, 0.0)
            if delta <= 0:
                continue
            per_iter = delta / iters
            log.echo(
                f"WIRE {labels}: {per_iter / (1 << 20):.1f} MiB/iter "
                f"({per_iter / total_bytes:.2f}x payload)"
            )
        if saved > 0:
            log.echo(
                f"WIRE saved by codec: {saved / iters / (1 << 20):.1f} "
                f"MiB/iter ({saved / iters / total_bytes:.2f}x payload)"
            )
        # utilization, not just bytes: per walk family the
        # achieved throughput at the 2(k-1)/k*N bandwidth-optimal byte
        # volume, the efficiency ratio against the measured link speed
        # when the link plane has an estimate, and where the walk time
        # went (wait-on-recv / reduce+codec compute / send-blocked)
        for key, s in sorted(get_walk_profiler().snapshot().items()):
            eff = s.get("efficiency")
            eff_s = f", {eff:.2f} of link bw" if eff is not None else ""
            log.echo(
                f"EFF {key}: {s['achieved_gib_s']:.3f} GiB/s at the "
                f"2(k-1)/k bound{eff_s} "
                f"(wait {s['wait_frac']:.0%} compute {s['compute_frac']:.0%} "
                f"send {s['send_frac']:.0%}, {s['walks']} walks)"
            )
        # where the time went (hot-path spans, this process only)
        summary = api.trace_summary()
        top = sorted(summary.items(), key=lambda kv: -kv[1])[:10]
        for name, ms in top:
            log.echo(f"TRACE {name}: {ms:.0f} ms")


def bench_p2p(model: str, iters: int) -> None:
    """p2p model-request throughput (parity: kungfu-bench-p2p,
    tests/go/cmd/ — each worker fetches its ring neighbour's published
    model from the versioned store)."""
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.models.fake import fake_gradients

    blob = b"".join(g.tobytes() for g in fake_gradients(model))
    rank, size = api.current_rank(), api.cluster_size()
    api.save("bench-model", blob, version=0)
    api.run_barrier()
    peer = (rank + 1) % size
    samples = []
    for i in range(iters):
        t0 = time.perf_counter()
        got = api.request(peer, "bench-model", version="latest")
        dt = time.perf_counter() - t0
        assert got is not None and len(got) == len(blob)
        samples.append(len(blob) / dt / (1 << 30))
    api.run_barrier()
    mean, err = float(np.mean(samples)), float(1.96 * np.std(samples))
    if rank == 0:
        log.echo(
            f"RESULT: {mean:.3f} +-{err:.3f} (GiB/s) "
            f"[P2P x{size} workers, {model}]"
        )


def bench_gns(iters: int, device=None) -> dict:
    """GNS monitoring overhead: train-step time with the plain S-SGD
    optimizer vs monitor_gradient_noise_scale wrapping the same base.

    Parity: the reference ships the harness but publishes no number
    (benchmarks/monitoring/benchmark.py, BASELINE.md row 'GNS monitoring
    overhead'). Runs the single-layer MLP over the device world (NCCL on
    the card, gloo on the CPU), 64 examples a rank. Returns the numbers
    of the RESULT line."""
    from kungfu_tpu_torch.models.mlp import init_mlp, mlp_loss
    from kungfu_tpu_torch.monitor import monitor_gradient_noise_scale
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.parallel import initialize_device_plane, make_mesh

    device = initialize_device_plane(device)
    sess = make_mesh(device)
    x = torch.ones(64, 784, dtype=torch.float32, device=device)
    y = torch.zeros(64, dtype=torch.int64, device=device)

    def make_step(wrap):
        model = init_mlp(torch.Generator().manual_seed(0), device=device)
        opt = wrap(torch.optim.SGD(model.parameters(), lr=0.1))

        def step():
            opt.zero_grad()
            loss = mlp_loss(model.tree(), (x, y))
            loss.backward()
            opt.step()
            return collective.all_reduce(loss.detach(), group=sess.group) / sess.size

        return step

    def timeit(wrap):
        step = make_step(wrap)
        for _ in range(3):
            loss = step()
        float(loss)
        best = float("inf")
        for _ in range(max(3, iters // 3)):
            t0 = time.perf_counter()
            for _ in range(10):
                loss = step()
            float(loss)
            best = min(best, (time.perf_counter() - t0) / 10)
        return best * 1e3

    t_plain = timeit(lambda base: synchronous_sgd(base, sess))
    t_gns = timeit(lambda base: monitor_gradient_noise_scale(base, sess, batch_small=64))
    overhead = 100 * (t_gns - t_plain) / t_plain
    log.echo(
        f"RESULT: plain {t_plain:.3f} ms/step, +GNS {t_gns:.3f} ms/step, "
        f"overhead {overhead:+.1f}% "
        f"[GNS x{sess.size} devices]"
    )
    return {"plain_ms": t_plain, "gns_ms": t_gns, "overhead_pct": overhead,
            "devices": sess.size}


def bench_scrape(out_path: str = "BENCH_AGG_r15.json",
                 sweeps: int = 5, host_counts=(4, 16)) -> None:
    """Telemetry-plane scaling A/B: flat per-peer scraping
    vs the scaled shapes (hierarchical digest fan-in + sampled link
    matrix) against an in-process simulated fleet at k=64 and k=256.

    The fleet sits behind the aggregator's injectable transport hook —
    no sockets, so the A/B isolates exactly what the tentpole changes:
    fan-out count (k fetches vs hosts digests), root-side exposition
    parsing (k promparse passes vs pre-parsed digest docs), and the
    /cluster/links document size (full merged matrix vs the rotated
    sample + retained slowest edges). Writes the trajectory to
    ``out_path`` and prints one RESULT line per k; `host_counts` are the
    fleets' hosts of 16 workers each."""
    import json
    import os
    import statistics

    from kungfu_tpu_torch.telemetry import cluster as tcluster
    from kungfu_tpu_torch.telemetry import decisions as tdecisions
    from kungfu_tpu_torch.telemetry import metrics as tmetrics
    from kungfu_tpu_torch.telemetry import steptrace as tsteptrace

    per_host, neighbors = 16, 32
    # plane documents every digest carries (hier ships these in-band;
    # without them the root would fall back to per-worker plane fetches)
    _store = tsteptrace.StepStore(keep=4)
    for _r in (1, 2):
        _rec = _store.begin_step(0, _r)
        if _rec is not None:
            _rec.finish(flush_wait_s=0.001, busy_s=0.04)
    plane_docs = {
        "steptrace": _store.export(peer="bench"),
        "decisions": tdecisions.DecisionLedger(keep=4).export(),
        "resources": {"peer": "bench", "wall_time_s": time.time()},
        "memory": {"peer": "bench", "wall_time_s": time.time()},
    }

    def make_fetch(hosts):
        labels = [
            f"h{h:02d}:{9000 + i}"
            for h in range(hosts) for i in range(per_host)
        ]
        k = len(labels)
        pages, digests = {}, {}
        # realistic exposition density: the full bucket ladder plus the
        # four per-destination link families — the root-side promparse
        # cost hier amortizes onto the per-host sub-aggregators
        buckets = ("0.005", "0.01", "0.025", "0.05", "0.1", "0.25",
                   "0.5", "1.0", "2.5", "5.0", "10.0", "+Inf")
        for idx, label in enumerate(labels):
            dsts = [labels[(idx + 1 + j) % k] for j in range(neighbors)]
            lines = [
                "# TYPE kungfu_steps_total counter",
                "kungfu_steps_total 100",
                "# TYPE kungfu_step_duration_seconds histogram",
            ]
            lines += [
                f'kungfu_step_duration_seconds_bucket{{le="{le}"}} 100'
                for le in buckets
            ]
            lines += [
                "kungfu_step_duration_seconds_sum 5.0",
                "kungfu_step_duration_seconds_count 100",
                "# TYPE kungfu_collective_latency_seconds counter",
                "kungfu_collective_latency_seconds 2.5",
                "# TYPE kungfu_egress_bytes_total counter",
                "kungfu_egress_bytes_total 1048576",
                "# TYPE kungfu_ingress_bytes_total counter",
                "kungfu_ingress_bytes_total 1048576",
                "# TYPE kungfu_peer_rtt_seconds gauge",
            ]
            lines += [
                f'kungfu_peer_rtt_seconds{{peer="{d}"}} 0.002'
                for d in dsts[:4]
            ]
            for fam, val in (
                (tcluster.LINK_BW, "1e8"),
                (tcluster.LINK_LAT, "0.002"),
                (tcluster.LINK_BYTES, "4194304"),
                (tcluster.LINK_MSGS, "64"),
            ):
                lines.append(f"# TYPE {fam} gauge")
                lines += [f'{fam}{{dst="{d}"}} {val}' for d in dsts]
            lines += [
                "# TYPE kungfu_topology_ring_position gauge",
                f"kungfu_topology_ring_position {idx}",
            ]
            pages[label] = ("\n".join(lines) + "\n").encode()
        for h in range(hosts):
            host = f"h{h:02d}"
            workers = {}
            for i in range(per_host):
                label = f"{host}:{9000 + i}"
                text = pages[label].decode()
                workers[label] = {
                    "url": f"http://{host}:{9000 + i}",
                    "metrics_text": text,
                    "parsed": tcluster.parsed_to_doc(
                        tcluster.parse_worker_page(text)
                    ),
                    "rtt_s": 1e-4,
                    "clock_offset_us": 0.0,
                    **plane_docs,
                }
            digests[host] = json.dumps({
                "enabled": True, "host": host,
                "wall_time": time.time(), "workers": workers,
            }).encode()

        plane_bodies = {
            "/steptrace": json.dumps(plane_docs["steptrace"]).encode(),
            "/decisions": json.dumps(plane_docs["decisions"]).encode(),
            "/resources": json.dumps(plane_docs["resources"]).encode(),
            "/memory": json.dumps(plane_docs["memory"]).encode(),
        }

        def fetch(base_url, path, timeout):
            hostport = base_url.split("//", 1)[1]
            endpoint = path.partition("?")[0]
            if endpoint == tcluster.HOST_DIGEST_PATH:
                return digests[hostport.split(":", 1)[0]], {}
            if endpoint == "/metrics":
                return pages[hostport], {}
            body = plane_bodies.get(endpoint)
            if body is None:
                raise OSError(f"404 {endpoint}")
            return body, {}

        targets = [
            (label, f"http://{label}") for label in labels
        ]
        return fetch, targets

    def run(hosts, scale):
        os.environ["KF_AGG_HIER_MIN_PEERS"] = "32" if scale else "0"
        fetch, targets = make_fetch(hosts)
        agg = tcluster.TelemetryAggregator(
            interval=30.0, registry=tmetrics.Registry(), fetch=fetch
        )
        agg.set_peers(targets)
        try:
            times = []
            for _ in range(sweeps):
                t0 = time.perf_counter()
                agg.scrape_once()
                times.append(time.perf_counter() - t0)
            links_bytes = len(json.dumps(agg.cluster_links()).encode())
            mode = agg.plane_envelope()["mode"]
        finally:
            agg.stop()
        return {
            "mode": mode,
            "sweep_s": round(statistics.median(times), 6),
            "links_bytes": links_bytes,
        }

    from kungfu_tpu_torch import knobs

    saved = (
        knobs.raw("KF_AGG_HIER_MIN_PEERS")
        if knobs.is_set("KF_AGG_HIER_MIN_PEERS") else None
    )
    results = {}
    try:
        for hosts in host_counts:  # k=64, k=256 at 16 workers/host
            k = hosts * per_host
            flat = run(hosts, scale=False)
            scaled = run(hosts, scale=True)
            entry = {
                "hosts": hosts, "workers_per_host": per_host,
                "link_neighbors": neighbors,
                "flat": flat, "scale": scaled,
                "sweep_speedup": round(
                    flat["sweep_s"] / max(scaled["sweep_s"], 1e-9), 2
                ),
                "links_payload_ratio": round(
                    flat["links_bytes"] / max(scaled["links_bytes"], 1), 2
                ),
            }
            results[f"k{k}"] = entry
            log.info(
                "RESULT scrape k=%d: sweep %.1fms -> %.1fms (%.1fx), "
                "/cluster/links %d B -> %d B (%.1fx), mode %s -> %s",
                k, flat["sweep_s"] * 1e3, scaled["sweep_s"] * 1e3,
                entry["sweep_speedup"], flat["links_bytes"],
                scaled["links_bytes"], entry["links_payload_ratio"],
                flat["mode"], scaled["mode"],
            )
    finally:
        if saved is None:
            os.environ.pop("KF_AGG_HIER_MIN_PEERS", None)
        else:
            os.environ["KF_AGG_HIER_MIN_PEERS"] = saved
    doc = {
        "bench": "telemetry-plane scrape A/B",
        "sweeps_per_config": sweeps,
        "results": results,
    }
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    log.info("RESULT scrape trajectory written to %s", out_path)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("kungfu_tpu_torch.benchmarks")
    p.add_argument("--method", choices=["XLA", "HOST", "P2P", "GNS"], default="XLA")
    p.add_argument(
        "--device", default=None,
        help="XLA/GNS: the device the buffers and the MLP live on (default: "
        "the CUDA card; `cpu` runs the device plane on gloo)",
    )
    p.add_argument("--model", default="resnet50-imagenet")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument(
        "--algo", choices=["auto", "tree", "segmented"], default="",
        help="HOST engine A/B: force the collective algorithm family "
        "(sets KF_CONFIG_ALGO before the session comes up; every worker "
        "runs the same argv so the override is cluster-agreed)",
    )
    p.add_argument(
        "--wire", choices=["off", "bf16", "f16", "auto", "int8", "int4"],
        default="",
        help="HOST engine A/B: wire codec for f32 payloads (sets "
        "KF_CONFIG_WIRE before the session comes up; cluster-agreed the "
        "same way as --algo). int8/int4 are the block-scaled quantized "
        "codecs with error-feedback on the segmented paths",
    )
    p.add_argument(
        "--wire-ab", action="store_true",
        help="HOST only: paired same-process codec A/B — run --iters "
        "with the --wire codec, toggle the codec candidate in lockstep "
        "(the adaptive mechanism), run --iters again, report both "
        "medians and the drift-free speedup ratio",
    )
    p.add_argument(
        "--zero", action="store_true", dest="zero_ab",
        help="HOST only: paired same-process ZeRO-1 A/B — alternate the "
        "replicated step (group allreduce + full-param SGD, full-size "
        "momentum) with the sharded update (reduce-scatter → 1/k shard "
        "update → weight all-gather through the async scheduler; sets "
        "KF_CONFIG_ASYNC=on and KF_CONFIG_ZERO=on before the session "
        "comes up), report per-leg medians, UPDATE/STATE/WIRE lines and "
        "the OVERLAP line",
    )
    p.add_argument(
        "--steps", action="store_true", dest="steps_report",
        help="HOST only: after the bench, print the STEPS report — "
        "per-step overlap/queue-delay fractions and the most-frequent "
        "critical bucket from the step plane's recorded timelines "
        "(meaningful with --async/--zero, whose legs drive the "
        "scheduler the plane instruments)",
    )
    p.add_argument(
        "--resources", action="store_true", dest="resources_report",
        help="HOST only: after the bench, print the RESOURCES report — "
        "per-bucket CPU attribution over the bench window from the "
        "resource plane's per-thread accounting, plus the compute-floor "
        "gain ceiling derive_plan's clamp enforces (rides any A/B; "
        "KF_BENCH_RESOURCES=1 in the harness mirrors it)",
    )
    p.add_argument(
        "--memory", action="store_true", dest="memory_report",
        help="HOST only: after the bench, print the MEMORY report — the "
        "memory plane's RSS decomposition over the registered byte "
        "accountants (arena/pool/zero_state/sched_inflight/telemetry/"
        "untracked) plus headroom against the effective limit; riding "
        "--zero it reports the sharded optimizer-state bytes MEASURED "
        "from the plane (KF_BENCH_MEMORY=1 in the harness mirrors it)",
    )
    p.add_argument(
        "--passes", type=int, default=16,
        help="HOST --async only: simulated-backprop passes per tensor "
        "(compute:comm ratio of the A/B; 16 is a conservative LOW bound "
        "for real backward passes — raise it to model matmul-heavy "
        "layers, e.g. when a shaped link makes comm sleep-dominated)",
    )
    p.add_argument(
        "--replan", action="store_true", dest="replan_ab",
        help="HOST only: paired same-process measured-topology A/B "
        "— warm up on the naive ring under the harness's "
        "KF_SHAPE_LINKS shape, adopt the measured re-plan through the "
        "production vote/exchange/digest path, then alternate "
        "measured-order vs naive-order rounds; plus the weighted-vs-"
        "equal segments A/B under a compute-shaped peer (sets "
        "KF_CONFIG_ALGO=segmented and KF_CONFIG_REPLAN=auto before the "
        "session comes up)",
    )
    p.add_argument(
        "--decisions", action="store_true", dest="decisions_report",
        help="HOST --replan only: feed the decision ledger "
        "the same timed rounds the A/B measures and append DECISIONS "
        "report lines per adaptation (kind, predicted, realized, "
        "verdict) — the ledger-measured realized gain must agree with "
        "the paired-A/B headline within 15%%",
    )
    p.add_argument(
        "--async", action="store_true", dest="async_ab",
        help="HOST only: paired same-process async-scheduler A/B — "
        "alternate the serial step loop (compute all, then one step-end "
        "group allreduce) with readiness-ordered submission to the "
        "background scheduler (KF_CONFIG_ASYNC=on, set before the "
        "session comes up), report both medians, the drift-free speedup "
        "and the OVERLAP line (flush-wait vs walk time)",
    )
    p.add_argument(
        "--scrape", action="store_true", dest="scrape_ab",
        help="standalone telemetry-plane A/B: flat per-peer "
        "scraping vs hierarchical digests + sampled link matrix against "
        "a simulated in-process fleet at k=64 and k=256; writes the "
        "sweep-time and /cluster/links payload trajectory to "
        "--scrape-out (no card, no kfrun needed)",
    )
    p.add_argument(
        "--scrape-out", default="BENCH_AGG_r15.json",
        help="output path for the --scrape trajectory JSON",
    )
    args = p.parse_args(argv)
    if args.scrape_ab:
        # pure-host telemetry bench: dispatch before any accelerator
        # path (or HOST-flag validation) runs
        bench_scrape(args.scrape_out)
        return
    if args.method != "HOST" and (
        args.algo or args.wire or args.wire_ab or args.async_ab
        or args.zero_ab or args.steps_report or args.replan_ab
        or args.resources_report or args.memory_report
    ):
        # the default method is XLA: silently measuring the wrong plane
        # is worse than an error
        p.error("--algo/--wire/--wire-ab/--async/--zero/--replan/--steps/"
                "--resources/--memory only apply to --method HOST")
    if sum(1 for f in (args.wire_ab, args.async_ab, args.zero_ab,
                       args.replan_ab) if f) > 1:
        p.error("--wire-ab/--async/--zero/--replan are separate A/Bs — "
                "pick one")
    if args.device is not None and args.method not in ("XLA", "GNS"):
        p.error("--device applies to the device paths, --method XLA and GNS")
    if args.decisions_report and not args.replan_ab:
        p.error("--decisions rides the --replan A/B (the adaptation it "
                "closes with an outcome is the re-plan adoption)")
    if args.method == "HOST":
        import os

        if args.algo:
            os.environ["KF_CONFIG_ALGO"] = args.algo
        if args.wire:
            os.environ["KF_CONFIG_WIRE"] = args.wire
        if args.async_ab:
            os.environ["KF_CONFIG_ASYNC"] = "on"
        if args.zero_ab:
            os.environ["KF_CONFIG_ASYNC"] = "on"
            os.environ["KF_CONFIG_ZERO"] = "on"
        if args.replan_ab:
            # the measured plan reorders the SEGMENTED ring; every
            # worker runs the same argv so the overrides stay
            # cluster-agreed like --algo
            os.environ["KF_CONFIG_ALGO"] = "segmented"
            os.environ["KF_CONFIG_REPLAN"] = "auto"
        if args.decisions_report:
            # size the ledger's windows to the A/B's round structure
            # (per-leg rounds are few); an operator-set env still wins
            os.environ.setdefault("KF_DECISION_WINDOW", "6")
            os.environ.setdefault("KF_DECISION_SETTLE", "1")
        # wire-byte accounting rides the metrics gate; the bench wants it
        # on regardless so the A/B always reports bytes per peer
        from kungfu_tpu_torch.telemetry import config as tconfig

        tconfig.enable("metrics")
        if args.resources_report:
            # anchor the accounting window NOW so the report's closing
            # sweep attributes exactly the benched iterations
            from kungfu_tpu_torch.telemetry import resource as _tres

            _tres.get_plane().maybe_sweep(force=True)
        if args.memory_report:
            # same anchor for the memory plane: the baseline sweep gives
            # the trend/leak windows a pre-bench starting point
            from kungfu_tpu_torch.telemetry import memory as _tmem

            _tmem.get_plane().maybe_sweep(force=True)
    if args.method == "XLA":
        bench_xla(args.model, args.iters, device=args.device)
    elif args.method == "P2P":
        bench_p2p(args.model, args.iters)
    elif args.method == "GNS":
        bench_gns(args.iters, device=args.device)
    elif args.wire_ab:
        bench_host_wire_ab(args.model, args.iters)
    elif args.async_ab:
        bench_host_async_ab(args.model, args.iters, passes=args.passes)
    elif args.zero_ab:
        bench_host_zero_ab(args.model, args.iters)
    elif args.replan_ab:
        bench_host_replan_ab(args.model, args.iters,
                             decisions=args.decisions_report)
    else:
        bench_host(args.model, args.iters)
    if args.method == "HOST" and args.steps_report:
        report_steps(args.model)
    if args.method == "HOST" and args.resources_report:
        report_resources(args.model)
    if args.method == "HOST" and args.memory_report:
        report_memory(args.model)


if __name__ == "__main__":
    main()

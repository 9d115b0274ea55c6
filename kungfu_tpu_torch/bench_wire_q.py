"""Benchmark: block-scaled int8/int4 wire codec with error feedback.

Port of `bench_wire_q.py`. Run it:

  python -m kungfu_tpu_torch.bench_wire_q

Three in-process experiments, one JSON line each (the reference's keys):

1. ``k8_wire_precision_ab`` — k=8 across 2 virtual hosts (contiguous
   rank->host), per-edge shape on cross-host edges (lat:2, bw:2MiB) plus
   one shared 32 MiB/s uplink bucket per host. Blocks of timed lockstep
   allreduce rounds cycle bf16 -> int8 -> int4 three times so host drift
   cancels from the ratios; every precision flip goes through the
   production lockstep ``check_precision`` majority vote. Wire bytes per
   codec are read off the ``kungfu_collective_wire_bytes_total{codec=...}``
   counters and divided by the raw 2(k-1)N payload a segmented allreduce
   moves, so the compression ratio is MEASURED, not derived. Checks:
   int8 >= 1.3x over bf16 round time (at the reference's sizes); int8
   and int4 wire bytes 0.3125 and 0.1875 of the raw payload (block 16:
   1/4 or 1/8 of the payload plus a 4 B scale a 64 B block), bf16 0.5;
   the saved bytes the raw payload less the wire bytes; every round's
   result bit-identical across all peers (each segment is quantized
   ONCE by its owner).

2. ``k8_zero_weight_ab`` — same shape; the ZeRO-1 sharded-update leg.
   Each peer drives a real ``ShardedUpdateSession`` step (pack ->
   reduce-scatter -> shard update -> weight all-gather -> scatter) over
   a 1 MiB parameter set; both the gradient reduce-scatter and the
   weight all-gather ride the quantized codec, with per-shard
   error-feedback residuals. Blocks alternate bf16/int8/int4 via the same
   lockstep vote; params must stay bit-identical across peers after
   every block.

3. ``k8_precision_vote_ledger`` — the voted-knob lifecycle, driven by the
   per-peer ``PrecisionPolicy`` stack end-to-end: a high measured noise
   scale (B_noise >> B) makes every peer's policy propose int8, the
   lockstep vote flips the cluster, and the decision ledger's
   ``precision_switch`` record grades the flip from measured step times
   (expect ``delivered``). Then the noise signal goes down, the policies
   vote the wire back UP to bf16, and on this bandwidth-starved path the
   upshift regresses throughput: the ledger closes the record
   ``regressed``, and the policy votes straight back to int8
   (trigger=regression_rollback), then HOLDS through the cooldown window.

Each leg is a function of its sizes (k, hosts, values, rounds), the
reference's values the defaults. All legs run real Peer transports
(sockets + the shaping layer) in one process, on host memory.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time

import numpy as np
import torch

from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.strategy import Strategy
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.bench_hier import ENV as _HIER_ENV
from kungfu_tpu_torch.bench_hier import _run_on_all, _start_cluster, bench_settings
from kungfu_tpu_torch.collective.host_session import HostSession
from kungfu_tpu_torch.telemetry import metrics as tmetrics

# what the reference sets when it is imported, set here around each leg
ENV = dict(_HIER_ENV,
           KF_CONFIG_WIRE="bf16",   # baseline codec at session start
           KF_TELEMETRY="metrics")  # wire-byte counters are the point

K = 8
HOSTS = 2
N = 256 * 1024          # 1 MiB f32 payload
MODES = ("bf16", "int8", "int4")
# loose per-mode value tolerance for a CONSTANT input vector: bf16 is
# exact on small integers; one quantized round-trip per hop errs at
# most half a scale step (scale = pow2(absmax/Qmax)), compounded over
# the 2(k-1) segmented hops — this bound just catches gross breakage
TOL_REL = {"bf16": 1e-6, "int8": 0.05, "int4": 0.35}


def _mk_cluster(k=K, hosts=HOSTS):
    """k peers over `hosts` virtual hosts (contiguous) with shaped
    cross-host edges and shared per-host uplink buckets; returns
    (cluster, sessions, labels)."""
    per = k // hosts
    host_of = lambda r: r // per  # noqa: E731 - contiguous hosts
    os.environ["KF_TELEMETRY_DIR"] = tempfile.mkdtemp(prefix="kf-bench-wireq-")

    def shape(labels):
        groups = {}
        for r, lab in enumerate(labels):
            groups.setdefault(host_of(r), []).append(lab)
        entries = [
            f"{labels[i]}>{labels[j]}=lat:2,bw:2MiB"
            for i in range(k) for j in range(k)
            if i != j and host_of(i) != host_of(j)
        ]
        return entries + [f"uplink:{'|'.join(groups[h])}=bw:32MiB" for h in sorted(groups)]

    cluster, _, labels = _start_cluster(k, shape)
    _run_on_all([p.start for p in cluster], join=300)
    peers = cluster[0].config.peers
    sessions = [
        HostSession(Strategy.RING_SEGMENTED, p.self_id, peers,
                    p.client, p.collective, timeout=240.0)
        for p in cluster
    ]
    return cluster, sessions, labels


def _teardown(cluster):
    for p in cluster:
        p.stop()
    os.environ.pop("KF_SHAPE_LINKS", None)


def _flip(sessions, mode, trigger="bench_ab"):
    """Lockstep production precision vote: every peer proposes `mode`,
    the majority flips the active candidate's codec on all of them."""
    if sessions[0].active_wire_mode() == mode:
        return
    res = {}
    _run_on_all([
        lambda r=r, s=s: res.__setitem__(
            r, s.check_precision(mode, trigger=trigger))
        for r, s in enumerate(sessions)
    ])
    assert all(res[r] == mode for r in res), res
    assert all(s.active_wire_mode() == mode for s in sessions)


def _timed_block_q(sessions, tag, rounds, n, tol_rel):
    """`rounds` lockstep allreduces under the active codec. The
    workspace NAME is held constant across rounds — the training-loop
    pattern the error-feedback store keys on, so round i's residual
    corrects round i+1. Asserts the result is bit-identical on every
    peer (each segment quantized once by its owner) and within the
    codec's value tolerance. Round time = barrier-to-barrier max,
    recorded by rank 0."""
    k = len(sessions)
    bar = threading.Barrier(k)
    times = []
    outs = [None] * k
    want = float(sum(j + 1 for j in range(k)))

    def run(r, s):
        for i in range(rounds):
            bar.wait()
            t0 = time.perf_counter()
            x = torch.full((n,), float(r + 1), dtype=torch.float32)
            out = torch.empty_like(x)
            s.all_reduce(Workspace(
                send=x, recv=out, op=ReduceOp.SUM, name=f"grad:{tag}",
            ))
            bar.wait()
            outs[r] = out
            assert abs(float(out[0]) - want) <= tol_rel * want, \
                (tag, i, float(out[0]), want)
            bar.wait()
            if r == 0:
                times.append(time.perf_counter() - t0)
                assert all(torch.equal(o, outs[0]) for o in outs[1:]), \
                    f"{tag}:{i} result not bit-identical across peers"

    _run_on_all([lambda r=r, s=s: run(r, s) for r, s in enumerate(sessions)])
    return times


def _wire_children():
    """Per-codec children of the wire-byte counters (process-global —
    in-process peers sum into the same registry, which is exactly the
    cluster-total accounting the ratios need)."""
    ctr = tmetrics.counter(
        "kungfu_collective_wire_bytes_total",
        "Host-plane collective payload bytes sent by this peer",
        ("collective", "strategy", "codec"),
    )
    saved = tmetrics.counter(
        "kungfu_collective_wire_saved_bytes_total",
        "Wire bytes saved by the collective codec on this peer",
        ("collective", "codec"),
    )
    return (
        {m: ctr.labels("all_reduce", "RING_SEGMENTED", m) for m in MODES},
        {m: saved.labels("all_reduce", m) for m in MODES},
    )


# ---------------------------------------------------------------------------
# experiment 1: gradient-ring A/B, measured payload ratios
# ---------------------------------------------------------------------------

def k8_wire_precision_ab(k=K, hosts=HOSTS, n=N, rounds=5, blocks=3, min_speedup=1.3):
    """The reference's acceptance: int8 at least `min_speedup` x over
    bf16 round time (None skips it); the wire ratios, the saved-bytes
    identity and every round's bit-identity are checked at any size."""
    with bench_settings(ENV, wire_min_bytes=True):
        return _k8_wire_precision_ab(k, hosts, n, rounds, blocks, min_speedup)


def _k8_wire_precision_ab(k, hosts, n, rounds, blocks, min_speedup):
    cluster, sessions, _ = _mk_cluster(k, hosts)
    try:
        assert all(s.active_wire_mode() == "bf16" for s in sessions)
        wire_c, saved_c = _wire_children()
        _timed_block_q(sessions, "warmup", 2, n, TOL_REL["bf16"])

        times = {m: [] for m in MODES}
        wire_bytes = {m: 0 for m in MODES}
        saved_bytes = {m: 0 for m in MODES}
        for blk in range(blocks):
            for mode in MODES:
                _flip(sessions, mode)
                w0, s0 = wire_c[mode].value, saved_c[mode].value
                times[mode] += _timed_block_q(
                    sessions, f"ab{blk}:{mode}", rounds, n, TOL_REL[mode])
                wire_bytes[mode] += wire_c[mode].value - w0
                saved_bytes[mode] += saved_c[mode].value - s0

        # a segmented allreduce moves 2(k-1)/k * N per peer = 2(k-1)*N
        # across the cluster, every round, whatever the codec
        raw = blocks * rounds * 2 * (k - 1) * n * 4
        med = lambda xs: float(np.median(xs))  # noqa: E731
        ratio = {m: wire_bytes[m] / raw for m in MODES}
        out = {
            "experiment": "k8_wire_precision_ab",
            "k": k,
            "hosts": hosts,
            "payload_bytes": n * 4,
            "rounds_per_block": rounds,
            "blocks": blocks,
            "round_ms": {m: round(med(times[m]) * 1e3, 1) for m in MODES},
            "speedup_int8_vs_bf16": round(
                med(times["bf16"]) / med(times["int8"]), 2),
            "speedup_int4_vs_bf16": round(
                med(times["bf16"]) / med(times["int4"]), 2),
            "wire_payload_ratio": {m: round(ratio[m], 4) for m in MODES},
            "saved_matches_wire": {
                m: bool(saved_bytes[m] == raw - wire_bytes[m])
                for m in MODES
            },
        }
        print(json.dumps(out), flush=True)
        if min_speedup is not None:
            assert out["speedup_int8_vs_bf16"] >= min_speedup, out
        assert ratio["int8"] <= 0.45, ratio
        assert ratio["int4"] <= 0.45, ratio
        # block=16 framing: 1/4 payload + 4B scale per 64B block = 0.3125,
        # 1/8 payload + scale = 0.1875 (partial tail blocks round up)
        assert abs(ratio["int8"] - 0.3125) < 0.01, ratio
        assert abs(ratio["int4"] - 0.1875) < 0.01, ratio
        assert abs(ratio["bf16"] - 0.5) < 0.01, ratio
        assert all(out["saved_matches_wire"].values()), out
        return out
    finally:
        _teardown(cluster)


# ---------------------------------------------------------------------------
# experiment 2: ZeRO-1 weight leg (reduce-scatter + weight all-gather)
# ---------------------------------------------------------------------------

def k8_zero_weight_ab(k=K, hosts=HOSTS, n=N, rounds=4, blocks=3, min_speedup=1.1):
    """`n` f32 parameters (the reference's 1 MiB); the reference's
    acceptance: int8 at least `min_speedup` x over bf16 step time (None
    skips it); the parameters stay bit-identical across peers and
    finite at any size."""
    with bench_settings(ENV, wire_min_bytes=True):
        return _k8_zero_weight_ab(k, hosts, n, rounds, blocks, min_speedup)


def _k8_zero_weight_ab(k, hosts, n, rounds, blocks, min_speedup):
    from kungfu_tpu_torch.collective.zero import ShardedSGD, ShardedUpdateSession

    cluster, sessions, _ = _mk_cluster(k, hosts)
    try:
        params = [torch.ones(n, dtype=torch.float32) for _ in range(k)]
        zss = [
            ShardedUpdateSession([params[r]], ShardedSGD(0.01),
                                 name="benchz", session=sessions[r])
            for r in range(k)
        ]
        grads = [torch.full((n,), float(np.float32(0.001 * (r + 1)))) for r in range(k)]
        bar = threading.Barrier(k)

        def zstep(tag, rounds):
            times = []

            def run(r):
                for i in range(rounds):
                    bar.wait()
                    t0 = time.perf_counter()
                    zss[r].step([grads[r].clone()])
                    bar.wait()
                    if r == 0:
                        times.append(time.perf_counter() - t0)

            _run_on_all([lambda r=r: run(r) for r in range(k)])
            assert all(torch.equal(p, params[0]) for p in params[1:]), \
                f"{tag}: gathered weights not bit-identical across peers"
            return times

        zstep("warmup", 1)
        times = {m: [] for m in MODES}
        for blk in range(blocks):
            for mode in MODES:
                _flip(sessions, mode)
                times[mode] += zstep(f"zero{blk}:{mode}", rounds)

        med = lambda xs: float(np.median(xs))  # noqa: E731
        out = {
            "experiment": "k8_zero_weight_ab",
            "k": k,
            "param_bytes": n * 4,
            "rounds_per_block": rounds,
            "blocks": blocks,
            "step_ms": {m: round(med(times[m]) * 1e3, 1) for m in MODES},
            "speedup_int8_vs_bf16": round(
                med(times["bf16"]) / med(times["int8"]), 2),
            "speedup_int4_vs_bf16": round(
                med(times["bf16"]) / med(times["int4"]), 2),
            "params_converged_finite": bool(
                torch.isfinite(params[0]).all()),
        }
        print(json.dumps(out), flush=True)
        if min_speedup is not None:
            assert out["speedup_int8_vs_bf16"] >= min_speedup, out
        assert out["params_converged_finite"], out
        return out
    finally:
        _teardown(cluster)


# ---------------------------------------------------------------------------
# experiment 3: policy-voted flip -> delivered; hostile upshift ->
# regressed -> rollback -> cooldown hold
# ---------------------------------------------------------------------------

def k8_precision_vote_ledger(k=K, hosts=HOSTS, n=N):
    """`n` f32 values a step; the verdicts are the reference's: the
    downshift `delivered`, the upshift `regressed` and rolled back, the
    cooldown held."""
    with bench_settings(ENV, wire_min_bytes=True):
        return _k8_precision_vote_ledger(k, hosts, n)


def _k8_precision_vote_ledger(k, hosts, n):
    from kungfu_tpu_torch.policy import PolicyContext, PrecisionPolicy
    from kungfu_tpu_torch.telemetry import decisions as tdecisions

    tdecisions.reset_ledger()  # experiments 1/2 left ungraded vote records
    cluster, sessions, _ = _mk_cluster(k, hosts)
    try:
        ledger = tdecisions.get_ledger()
        window = ledger.window
        batch = 64
        policies = [
            # int4_ratio effectively off: this leg exercises one clean
            # downshift + the rollback contract, not the full ladder
            PrecisionPolicy(interval_steps=window, patience=1,
                            int8_ratio=8.0, int4_ratio=1e9,
                            cooldown_intervals=8,
                            session_supplier=lambda s=s: s)
            for s in sessions
        ]
        ctxs = [PolicyContext(batch_size=batch) for _ in sessions]

        step_ms = []
        events = {}

        def one_step(step, noise_ratio):
            t0 = time.perf_counter()
            _timed_block_q(sessions, f"step{step}", 1, n, TOL_REL["int4"])
            dt = time.perf_counter() - t0
            tdecisions.note_step(dt)
            mode = sessions[0].active_wire_mode()
            step_ms.append((step, round(dt * 1e3, 1), mode))
            if step % window == 0:
                sig = ledger.signals()
                for ctx in ctxs:
                    ctx.step = step
                    ctx.metrics.update(sig)
                    ctx.metrics["monitor/noise_scale"] = noise_ratio * batch
                _run_on_all([
                    lambda p=p, c=c: p.after_step(c)
                    for p, c in zip(policies, ctxs)
                ])

        def recs():
            return [r for r in ledger.records()
                    if r.kind == "precision_switch"]

        # phase A: noisy gradients (B_noise >> B) -> policies vote int8
        step = 0
        while sessions[0].active_wire_mode() != "int8":
            step += 1
            assert step <= 6 * window, "policies never voted int8"
            one_step(step, noise_ratio=16.0)
        events["downshift_step"] = step

        # phase B: the ledger grades the downshift from measured steps
        while any(r.verdict is None for r in recs()):
            step += 1
            assert step <= events["downshift_step"] + 6 * window, \
                "downshift never graded"
            one_step(step, noise_ratio=16.0)
        events["downshift_verdicts"] = sorted(
            {r.verdict for r in recs()})
        events["downshift_verdict_step"] = step

        # phase C: noise collapses -> policies vote bf16 back; on this
        # bandwidth-starved path the upshift is throughput-hostile, the
        # ledger closes it regressed, and the rollback votes int8 back
        upshift_seen = False
        while True:
            step += 1
            assert step <= events["downshift_verdict_step"] + 12 * window, \
                "hostile upshift never rolled back"
            one_step(step, noise_ratio=1.0)
            mode = sessions[0].active_wire_mode()
            if mode == "bf16" and not upshift_seen:
                upshift_seen = True
                events["upshift_step"] = step
            if upshift_seen and mode == "int8":
                events["rollback_step"] = step
                break
        assert upshift_seen, "policies never proposed the upshift"
        rb = [r for r in recs() if r.trigger == "regression_rollback"]
        assert rb, "rollback flip did not open its own ledger record"
        events["regressed_recorded"] = any(
            r.verdict == "regressed" for r in recs())

        # phase D: cooldown — the bf16 target persists but the policy
        # holds instead of thrashing straight back into the regression
        hold_windows = 3
        for _ in range(hold_windows * window):
            step += 1
            one_step(step, noise_ratio=1.0)
        events["cooldown_held"] = sessions[0].active_wire_mode() == "int8"
        events["cooldown_withheld_votes"] = max(
            int(c.metrics.get("precision/vote_withheld_cooldown", 0))
            for c in ctxs
        )

        bf16_ms = [ms for _, ms, m in step_ms if m == "bf16"]
        int8_ms = [ms for _, ms, m in step_ms if m == "int8"]
        out = {
            "experiment": "k8_precision_vote_ledger",
            "k": k,
            "ledger_window": window,
            "policy_patience": 1,
            "bf16_round_ms": float(np.median(bf16_ms)),
            "int8_round_ms": float(np.median(int8_ms)),
            **events,
        }
        print(json.dumps(out), flush=True)
        assert out["downshift_verdicts"] == ["delivered"], out
        assert out["regressed_recorded"], out
        assert out["cooldown_held"], out
        assert out["cooldown_withheld_votes"] >= 1, out
        return out
    finally:
        _teardown(cluster)


def main():
    k8_wire_precision_ab()
    k8_zero_weight_ab()
    k8_precision_vote_ledger()


if __name__ == "__main__":
    main()

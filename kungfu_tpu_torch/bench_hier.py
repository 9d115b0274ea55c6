"""Benchmark: hierarchical two-level ring vs flat measured ring under a
SHARED-uplink shape.

Port of `bench_hier.py`. Run it:

  python -m kungfu_tpu_torch.bench_hier

Three in-process experiments, one JSON line each (the reference's keys):

1. ``k64_shared_uplink_ab`` — k=64 across 4 virtual hosts (interleaved
   rank->host assignment), per-edge shape on cross-host edges (lat:2ms,
   bw:4MiB) plus ONE shared token bucket per host uplink (64MiB across
   all of a host's senders). Both plans are derived from the SAME
   probe-measured matrix through the production derivation
   (``derive_plan`` / ``derive_hier_plan``) and adopted through the
   production lockstep ``adopt_replan`` digest bracket; blocks of timed
   allreduce rounds alternate flat/hier three times so host drift
   cancels from the ratio. A naive rank-order block is timed for
   context.

2. ``k256_lockstep_adoption`` — 256 live peers (16 virtual hosts x 16)
   with measured link rows injected into each peer's passive link table
   (a full k^2 probe mesh is the k=64 leg's job), shared-uplink shaping
   active. One lockstep ``check_replan`` round must carry the vote,
   exchange 256 rows, derive the identical two-level plan on every peer,
   and adopt it — wall-clock recorded against the budget — followed by
   one exact two-level walk under the shape.

3. ``k8_live_demotion`` — 2 hosts x 4; rank 5's outgoing edges are
   persistently shaped (lat:40ms on every send, so its phase-1 star
   contribution drags each round). The per-peer ``ReplanPolicy`` stack
   runs the production path: patience windows close against the
   decision ledger's measurement window, the lockstep ``check_demote``
   vote flips rank 5 into the demoted role, the ledger's
   ``peer_demoted`` record measures the demotion (expect `delivered`),
   then the shape is removed live and the recovery counter promotes rank
   5 back within the patience window.

Each leg is a function of its sizes (k, hosts, bytes, rounds), the
reference's values the defaults, and runs the reference's checks: every
walk's sum exact, the measured clustering recovering the shaped hosts,
one plan digest on every peer, the demotion graded `delivered`. All
legs run real Peer transports (sockets + the shaping layer) in one
process, on host memory: the benchmark times the host plane, whatever
card the host has.
"""

from __future__ import annotations

import contextlib
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
from kungfu_tpu_torch.cmd import _reserve_ports
from kungfu_tpu_torch.collective.host_session import HostSession
from kungfu_tpu_torch.peer import Peer
from kungfu_tpu_torch.plan import replan as rp
from kungfu_tpu_torch.plan.peer import PeerID, PeerList
from kungfu_tpu_torch.runner.env import WorkerConfig
from kungfu_tpu_torch.telemetry import link as tlink
from kungfu_tpu_torch.transport import shaping
from kungfu_tpu_torch.transport.message import ConnType

# what the reference sets when it is imported, set here around each leg
ENV = {
    "KF_CONFIG_SHM": "0",        # sockets, so shaping applies
    "KF_DECISION_WINDOW": "4",   # ledger measurement window
    "KF_DECISION_SETTLE": "1",
}


@contextlib.contextmanager
def bench_settings(env=None, wire_min_bytes: bool = False):
    """The benches' process settings for the duration of a leg, restored
    after: `env` (default ENV), a fresh decision ledger (made under the
    leg's window), every payload segmented (and, with `wire_min_bytes`,
    encoded), and tight pacing: the default 20ms burst credit refills
    between ~50ms-spaced rounds, which would let every small per-round
    payload ride the burst and never pay the shaped bandwidth — the
    passive link table would then measure latency-only rates and the
    bimodal intra/cross gap the clustering keys on would wash out."""
    from kungfu_tpu_torch.telemetry import config as tconfig
    from kungfu_tpu_torch.telemetry import decisions as tdecisions

    env = ENV if env is None else env
    saved_env = {key: os.environ.get(key) for key in list(env) + ["KF_TELEMETRY_DIR",
                                                                  "KF_SHAPE_LINKS"]}
    attrs = [(HostSession, "SEGMENT_MIN_BYTES", 0),
             (shaping, "BURST_SECONDS", 0.002), (shaping, "BURST_MIN_BYTES", 4 << 10)]
    if wire_min_bytes:
        attrs.append((HostSession, "WIRE_MIN_BYTES", 0))
    saved_attrs = [(obj, name, obj.__dict__.get(name, _MISSING)) for obj, name, _ in attrs]
    os.environ.update(env)
    for obj, name, value in attrs:
        setattr(obj, name, value)
    tconfig.refresh(None)
    tdecisions.reset_ledger()
    try:
        yield
    finally:
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        for obj, name, value in saved_attrs:
            if value is _MISSING:
                delattr(obj, name)
            else:
                setattr(obj, name, value)
        tconfig.refresh(None)
        tdecisions.reset_ledger()


_MISSING = object()


def _run_on_all(fns, join=600):
    errs = []

    def wrap(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(join)
        assert not t.is_alive(), "collective hung"
    if errs:
        raise errs[0]


def join_budget(k):
    return 600 if k >= 128 else 300


def _probe(cluster, ids, r, frames=2, nbytes=16 << 10):
    me = cluster[r]
    k = len(ids)
    payload = bytes(nbytes)
    for j in range(k):
        if j == r:
            continue
        for t in range(frames):
            me.client.send(ids[j], f"bprobe:{r}:{j}:{t}", payload,
                           ConnType.COLLECTIVE)
    for j in range(k):
        if j == r:
            continue
        for t in range(frames):
            msg = me.collective.recv(ids[j], f"bprobe:{j}:{r}:{t}", 120.0)
            if msg.release is not None:
                msg.release()


def _timed_block(sessions, tag, rounds, n):
    """`rounds` lockstep allreduces; per-round wall time = barrier-to-
    barrier (the max across peers), recorded by rank 0."""
    k = len(sessions)
    bar = threading.Barrier(k)
    times = []

    def run(r, s):
        for i in range(rounds):
            bar.wait()
            # a demoted peer's contribution is zero-weighted out of the
            # reduction (it still receives the result via broadcast)
            want = sum(j + 1 for j in range(k) if j not in s.demoted_peers())
            t0 = time.perf_counter()
            x = torch.full((n,), float(r + 1), dtype=torch.float32)
            out = torch.empty_like(x)
            s.all_reduce(Workspace(
                send=x, recv=out, op=ReduceOp.SUM, name=f"{tag}:{i}",
            ))
            assert float(out[0]) == want, "walk result wrong"
            bar.wait()
            if r == 0:
                times.append(time.perf_counter() - t0)

    _run_on_all([lambda r=r, s=s: run(r, s) for r, s in enumerate(sessions)],
                join=join_budget(k))
    return times


def _lockstep_adopt(sessions, plans):
    _run_on_all([
        lambda s=s, p=p: s.adopt_replan(p)
        for s, p in zip(sessions, plans)
    ], join=join_budget(len(sessions)))


def _start_cluster(k, shape_entries):
    """k loopback peers on reserved ports, the shape built against their
    labels by `shape_entries(labels)`; returns (cluster, ids, labels)."""
    ports = _reserve_ports(k)
    ids = [PeerID("127.0.0.1", p) for p in ports]
    labels = [str(i) for i in ids]
    os.environ["KF_SHAPE_LINKS"] = ";".join(shape_entries(labels))
    peers = PeerList(ids)
    cluster = [
        Peer(WorkerConfig(
            self_id=me, peers=peers, runners=PeerList(), parent=None,
            cluster_version=0, strategy=Strategy.STAR, config_server="",
            elastic_mode="", init_progress=0,
        ))
        for me in ids
    ]
    return cluster, ids, labels


def _hier_sessions(cluster, timeout):
    """One segmented-ring session a peer over its own passive link table,
    re-planning in `hier` mode."""
    peers = cluster[0].config.peers
    tables = [tlink.LinkTable(registry=None, bw_min_bytes=1024) for _ in cluster]
    for p, t in zip(cluster, tables):
        p.client._links = t
    sessions = [
        HostSession(Strategy.RING_SEGMENTED, p.self_id, peers,
                    p.client, p.collective, timeout=timeout)
        for p in cluster
    ]
    for s, t in zip(sessions, tables):
        s._links = t
        s.replan_mode = "hier"
    return sessions, tables


def _groups_of(host_of, k, hosts):
    return [sorted(r for r in range(k) if host_of(r) == hh) for hh in range(hosts)]


# ---------------------------------------------------------------------------
# experiment 1: k=64 flat-measured vs two-level A/B under shared uplinks
# ---------------------------------------------------------------------------

def k64_shared_uplink_ab(k=64, hosts=4, n=64 * 1024, rounds=5, blocks=3):
    """`n` f32 values a round (the reference's 256 KiB)."""
    with bench_settings():
        return _k64_shared_uplink_ab(k, hosts, n, rounds, blocks)


def _k64_shared_uplink_ab(k, hosts, n, rounds, blocks):
    host_of = lambda r: r % hosts  # noqa: E731 - interleaved: naive worst case
    os.environ["KF_TELEMETRY_DIR"] = tempfile.mkdtemp(prefix="kf-bench-hier-")

    def shape(labels):
        groups = {}
        for r, lab in enumerate(labels):
            groups.setdefault(host_of(r), []).append(lab)
        entries = [
            f"{labels[i]}>{labels[j]}=lat:2,bw:4MiB"
            for i in range(k) for j in range(k)
            if i != j and host_of(i) != host_of(j)
        ]
        return entries + [f"uplink:{'|'.join(groups[h])}=bw:64MiB" for h in sorted(groups)]

    cluster, ids, _ = _start_cluster(k, shape)
    try:
        _run_on_all([p.start for p in cluster], join=300)
        sessions, _ = _hier_sessions(cluster, timeout=240.0)

        _timed_block(sessions, "warmup", 2, n)
        _run_on_all([
            lambda r=r: _probe(cluster, ids, r, frames=3, nbytes=64 << 10)
            for r in range(k)
        ], join=300)

        # ONE measured matrix; both plans derived from the same bytes
        # through the production pure-function derivations
        flat_plans = [None] * k
        hier_plans = [None] * k

        def derive(r, s):
            m = s.measured_matrix()
            cf = s.measured_compute_frac()
            flat_plans[r] = rp.derive_plan(m, mode="auto", compute_frac=cf)
            hier_plans[r] = rp.derive_hier_plan(
                m, hosts=s._static_hosts(), mode="hier", compute_frac=cf,
            )

        _run_on_all([lambda r=r, s=s: derive(r, s)
                     for r, s in enumerate(sessions)], join=300)
        assert all(p is not None for p in flat_plans)
        assert all(h is not None for h in hier_plans)
        h = hier_plans[0]
        assert len(h.groups) == hosts, f"clustering found {len(h.groups)}"
        assert sorted(sorted(g) for g in h.groups) == _groups_of(host_of, k, hosts), \
            "measured clustering did not recover the shaped hosts"

        naive = _timed_block(sessions, "naive", 3, n)
        flat_ms, hier_ms = [], []
        for blk in range(blocks):
            _lockstep_adopt(sessions, flat_plans)
            flat_ms += _timed_block(sessions, f"flat{blk}", rounds, n)
            _lockstep_adopt(sessions, hier_plans)
            hier_ms += _timed_block(sessions, f"hier{blk}", rounds, n)

        med = lambda xs: float(np.median(xs))  # noqa: E731
        out = {
            "experiment": "k64_shared_uplink_ab",
            "k": k,
            "hosts": hosts,
            "payload_bytes": n * 4,
            "naive_round_ms": round(med(naive) * 1e3, 1),
            "flat_measured_round_ms": round(med(flat_ms) * 1e3, 1),
            "hier_round_ms": round(med(hier_ms) * 1e3, 1),
            "speedup_hier_vs_flat": round(med(flat_ms) / med(hier_ms), 2),
            "speedup_hier_vs_naive": round(med(naive) / med(hier_ms), 2),
            "flat_order_crossings": sum(
                1 for a, b in zip(
                    flat_plans[0].order,
                    flat_plans[0].order[1:] + flat_plans[0].order[:1],
                )
                if host_of(a) != host_of(b)
            ),
            "hier_heads": list(h.heads),
            "rounds_per_block": rounds,
            "blocks": blocks,
        }
        print(json.dumps(out), flush=True)
        return out
    finally:
        for p in cluster:
            p.stop()
        os.environ.pop("KF_SHAPE_LINKS", None)


# ---------------------------------------------------------------------------
# experiment 2: k=256 lockstep two-level adoption within budget
# ---------------------------------------------------------------------------

def k256_lockstep_adoption(k=256, hosts=16, budget_s=300.0, n=16 * 1024):
    """`n` f32 values in the walk after the adoption."""
    with bench_settings():
        return _k256_lockstep_adoption(k, hosts, budget_s, n)


def _k256_lockstep_adoption(k, hosts, budget_s, n):
    host_of = lambda r: r % hosts  # noqa: E731
    os.environ["KF_TELEMETRY_DIR"] = tempfile.mkdtemp(prefix="kf-bench-hier-")

    def shape(labels):
        # uplink-only shape: one shared bucket a host, no per-edge entries
        # (the measured rows are injected below; probing a k^2-edge mesh
        # is the k=64 leg's job)
        groups = {}
        for r, lab in enumerate(labels):
            groups.setdefault(host_of(r), []).append(lab)
        return [f"uplink:{'|'.join(groups[h])}=bw:256MiB" for h in sorted(groups)]

    cluster, ids, _ = _start_cluster(k, shape)
    try:
        t_start = time.perf_counter()
        _run_on_all([p.start for p in cluster], join=600)
        start_s = time.perf_counter() - t_start
        sessions, tables = _hier_sessions(cluster, timeout=600.0)

        # inject each peer's measured row: loopback-fast intra, DCN-slow
        # cross with deterministic per-edge variation
        nb = 1 << 20
        for r, t in enumerate(tables):
            for j, pid in enumerate(ids):
                if j == r:
                    continue
                if host_of(r) == host_of(j):
                    bw = 1e9 + 1e5 * ((r * 7 + j * 3) % 50)
                else:
                    bw = 5e6 + 1e3 * ((r * 31 + j * 17) % 100)
                t.observe_send(pid, nb, nb / bw)

        results = {}
        t0 = time.perf_counter()
        _run_on_all([
            lambda r=r, s=s: results.__setitem__(
                r, s.check_replan(want=True, min_gain=1.0)
            )
            for r, s in enumerate(sessions)
        ], join=600)
        adopt_s = time.perf_counter() - t0
        assert all(results[r] is not None for r in range(k)), \
            f"k={k} hier re-plan did not fire"
        hiers = [s.hier_plan() for s in sessions]
        assert all(h is not None for h in hiers)
        assert len({h.to_bytes() for h in hiers}) == 1, "divergent plans"
        h = hiers[0]
        assert len(h.groups) == hosts
        assert sorted(sorted(g) for g in h.groups) == _groups_of(host_of, k, hosts)

        t0 = time.perf_counter()
        walk = _timed_block(sessions, "post-hier", 1, n)
        walk_s = time.perf_counter() - t0
        out = {
            "experiment": "k256_lockstep_adoption",
            "k": k,
            "hosts": hosts,
            "peer_start_s": round(start_s, 1),
            "lockstep_adopt_s": round(adopt_s, 1),
            "hier_walk_round_s": round(walk[0], 2),
            "walk_harness_s": round(walk_s, 1),
            "groups": len(h.groups),
            "within_budget": adopt_s <= budget_s,
            "budget_s": budget_s,
        }
        print(json.dumps(out), flush=True)
        assert out["within_budget"], f"adoption blew the budget: {adopt_s}"
        return out
    finally:
        for p in cluster:
            p.stop()
        os.environ.pop("KF_SHAPE_LINKS", None)


# ---------------------------------------------------------------------------
# experiment 3: live demotion -> ledger verdict -> recovery promotion
# ---------------------------------------------------------------------------

def k8_live_demotion(k=8, hosts=2, straggler=5, n=64 * 1024, patience=2, probe_frames=2,
                     probe_bytes=16 << 10):
    """Contiguous hosts of k/hosts ranks; the first ranks of hosts 0 and 1
    share the fastest cross-host edge, so they are elected heads. Each
    peer probes every other with `probe_frames` frames of `probe_bytes`
    before the re-plan round: larger probes keep the intra- and
    cross-host rates apart on a busy host."""
    with bench_settings():
        return _k8_live_demotion(k, hosts, straggler, n, patience, probe_frames, probe_bytes)


def _k8_live_demotion(k, hosts, straggler, n, patience, probe_frames, probe_bytes):
    from kungfu_tpu_torch.policy import PolicyContext, ReplanPolicy
    from kungfu_tpu_torch.telemetry import decisions as tdecisions

    per = k // hosts
    host_of = lambda r: r // per  # noqa: E731 - contiguous hosts
    os.environ["KF_TELEMETRY_DIR"] = tempfile.mkdtemp(prefix="kf-bench-hier-")

    def shape(labels):
        # Cross-host links: lat:2,bw:8MiB, except the pair of the hosts'
        # first ranks which is deliberately faster (lat:1.5,bw:12MiB) so
        # head election is deterministic. The persistent straggler pays
        # 40ms on EVERY send — its phase-1 star contribution holds the
        # whole round hostage — while its inbound stays clean
        # (symmetrized clustering still puts it in its host; demotion,
        # not exclusion, is the remedy).
        groups = {}
        for r, lab in enumerate(labels):
            groups.setdefault(host_of(r), []).append(lab)
        entries = []
        for i in range(k):
            for j in range(k):
                if i == j:
                    continue
                if i == straggler:
                    entries.append(f"{labels[i]}>{labels[j]}=lat:40")
                elif host_of(i) != host_of(j):
                    if {i, j} == {0, per}:
                        entries.append(f"{labels[i]}>{labels[j]}=lat:1.5,bw:12MiB")
                    else:
                        entries.append(f"{labels[i]}>{labels[j]}=lat:2,bw:8MiB")
        return entries + [f"uplink:{'|'.join(groups[h])}=bw:64MiB" for h in sorted(groups)]

    cluster, ids, labels = _start_cluster(k, shape)
    try:
        _run_on_all([p.start for p in cluster], join=300)
        sessions, _ = _hier_sessions(cluster, timeout=240.0)

        _timed_block(sessions, "warmup", 1, n)
        _run_on_all([lambda r=r: _probe(cluster, ids, r, probe_frames, probe_bytes)
                     for r in range(k)], join=300)
        results = {}
        _run_on_all([
            lambda r=r, s=s: results.__setitem__(
                r, s.check_replan(want=True, min_gain=1.0)
            )
            for r, s in enumerate(sessions)
        ], join=300)
        assert all(results[r] is not None for r in range(k))
        h = sessions[0].hier_plan()
        assert h is not None and len(h.groups) == hosts
        assert straggler not in h.heads, "shaped peer won head election?!"

        ledger = tdecisions.get_ledger()
        window = ledger.window
        policies = [
            ReplanPolicy(interval_steps=window, patience=99, min_gain=9.9,
                         demote_patience=patience,
                         session_supplier=lambda s=s: s)
            for s in sessions
        ]
        ctxs = [PolicyContext(batch_size=1) for _ in sessions]
        lab = labels[straggler]

        def signals(step, shaped):
            sig = {"cluster/updated_at": float(step)}
            if shaped:
                sig.update({
                    "step/critical_peer": lab,
                    "cluster/stragglers": [lab],
                    "cluster/straggler_causes": {lab: "compute"},
                })
            else:
                sig.update({
                    "step/critical_peer": None,
                    "cluster/stragglers": [],
                    "cluster/straggler_causes": {},
                })
            return sig

        step_ms = []
        events = {}

        def one_step(step, shaped):
            t0 = time.perf_counter()
            _timed_block(sessions, f"step{step}", 1, n)
            dt = time.perf_counter() - t0
            tdecisions.note_step(dt)
            step_ms.append((step, round(dt * 1e3, 1), shaped))
            if step % window == 0:
                for ctx in ctxs:
                    ctx.step = step
                    ctx.metrics.update(signals(step, shaped))
                _run_on_all([
                    lambda p=p, c=c: p.after_step(c)
                    for p, c in zip(policies, ctxs)
                ], join=300)

        # phase A: shaped straggler -> lockstep demotion
        step = 0
        while sessions[0].demoted_peers() != (straggler,):
            step += 1
            assert step <= 4 * window * (patience + 2), "never demoted"
            one_step(step, shaped=True)
        events["demote_step"] = step
        events["demoted"] = list(sessions[0].demoted_peers())

        # phase B: the ledger measures the demotion
        def demote_recs():
            return [r for r in tdecisions.get_ledger().records()
                    if r.kind == "peer_demoted"]

        while any(r.verdict is None for r in demote_recs()):
            step += 1
            assert step <= events["demote_step"] + 6 * window, "never graded"
            one_step(step, shaped=True)
        events["verdicts"] = sorted({r.verdict for r in demote_recs()})
        events["verdict_step"] = step

        # phase C: un-shape the straggler LIVE and feed clean signals
        cluster[straggler].client._shaper = None
        unshape_step = step
        events["unshape_step"] = unshape_step
        while sessions[0].demoted_peers() == (straggler,):
            step += 1
            assert step <= unshape_step + 2 * window * (patience + 2), \
                "never promoted back"
            one_step(step, shaped=False)
        events["promote_step"] = step
        events["promoted_within_windows"] = (
            (step - unshape_step + window - 1) // window
        )

        shaped_ms = [ms for st, ms, sh in step_ms
                     if sh and st <= events["demote_step"]]
        demoted_ms = [ms for st, ms, sh in step_ms
                      if sh and st > events["demote_step"]]
        out = {
            "experiment": "k8_live_demotion",
            "k": k,
            "straggler_rank": straggler,
            "ledger_window": window,
            "demote_patience": patience,
            "shaped_round_ms": float(np.median(shaped_ms)),
            "demoted_round_ms": float(np.median(demoted_ms)),
            **events,
        }
        print(json.dumps(out), flush=True)
        assert out["verdicts"] == ["delivered"], out["verdicts"]
        assert out["promoted_within_windows"] <= patience + 1
        return out
    finally:
        for p in cluster:
            p.stop()
        os.environ.pop("KF_SHAPE_LINKS", None)


def main():
    k64_shared_uplink_ab()
    k256_lockstep_adoption()
    k8_live_demotion()


if __name__ == "__main__":
    main()

"""Usage: python3 -m kungfu_tpu_torch.info [--no-devices] [--telemetry [URL]]
       python3 -m kungfu_tpu_torch.info top [--watch] [--json] [--interval S] [URL]
       python3 -m kungfu_tpu_torch.info links [--watch] [--json] [--interval S] [URL]
       python3 -m kungfu_tpu_torch.info steps [--watch] [--json] [--interval S] [-n N] [URL]
       python3 -m kungfu_tpu_torch.info decisions [--watch] [--json] [--interval S] [-n N] [URL]
       python3 -m kungfu_tpu_torch.info resources [--watch] [--json] [--interval S] [URL]
       python3 -m kungfu_tpu_torch.info memory [--watch] [--json] [--interval S] [URL]
       python3 -m kungfu_tpu_torch.info postmortem [DIR|URL]

Port of `kungfu_tpu/info/__main__.py`. Prints framework, backend and
cluster-env diagnostics (parity: python -m kungfu.info; the report names
torch, CUDA, cuDNN and NCCL, the cards `torch.cuda` sees, and the KF_*
environment — what an operator needs when a worker misbehaves).

--telemetry shows the telemetry configuration (KF_TELEMETRY features,
endpoint scheme) and, given a worker URL (http://host:port — the
worker's peer port + 10000), fetches and prints its live /metrics
page.

`top` is the live operator view of the cluster plane: it
reads the runner's /cluster/health endpoint (URL argument, or
KF_CLUSTER_HEALTH_URL — exported to every worker by kfrun -w
-debug-port N) and renders one row per peer: step rate, step-time
p50/p99, bytes tx/rx, scrape age, straggler flag. --watch refreshes in
place until interrupted.

`links` renders the cluster's k×k link matrix: per directed
edge the passively-measured EWMA bandwidth (MiB/s) from the runner's
/cluster/links endpoint, slow edges (< half the median) highlighted
with `!`. Point it at the runner debug endpoint (or it derives the URL
from KF_CLUSTER_HEALTH_URL). This is the "which link is slow?" view —
see the runbook in the JAX package's docs/telemetry.md.

`steps` renders the step plane: recent merged training
steps from the runner's /cluster/steps endpoint as aligned per-peer
lanes, the critical (peer, bucket, edge) chain highlighted with `*`,
plus each step's overlap and queue-delay fractions. This is the "why
is this step slow?" view — see the runbook in the JAX package's docs/telemetry.md.

`decisions` renders the decision ledger: the cluster's
merged causal adaptation timeline from the runner's /cluster/decisions
endpoint — every strategy/wire vote, measured re-plan, engine-mode flip
and elastic resize with its trigger, predicted gain and MEASURED
outcome (realized gain, delivered/neutral/regressed verdict, regression
watchdog flag). This is the "the cluster adapted — did it help?" view —
see the runbook in the JAX package's docs/telemetry.md.

`resources` renders the resource plane: every worker's
per-thread CPU attribution from the runner's /cluster/resources
endpoint — per peer the window CPU fraction, effective cores, the
per-bucket busy split (train/walk/codec/sched/telemetry/other) and the
compute-saturation flag. This is the "is this peer compute-bound or
network-bound?" view — see the runbook in the JAX package's docs/telemetry.md.

`memory` renders the memory plane: every worker's RSS
decomposition from the runner's /cluster/memory endpoint — per peer the
RSS against its effective memory limit, the per-bucket byte split
(arena/pool/zero_state/sched_inflight/telemetry/untracked), the RSS
trend and headroom forecast, plus pressure/thrashing/leak flags. This
is the "which worker is about to OOM, and what's eating it?" view —
see the runbook in the JAX package's docs/telemetry.md.

`--json` (top/links/steps/decisions/resources/memory) emits the raw cluster
endpoint payload instead of the rendered table — one flag for
scripting/CI, applied in the shared fetch loop.

`postmortem` reconstructs the death timeline of crashed workers: point
it at a telemetry run dir (KF_TELEMETRY_DIR, default
<tempdir>/kungfu-telemetry/<run-id>) to read the durable postmortems.jsonl
and per-peer flight journals, or at a live runner's debug endpoint
(http://host:port) to fetch /cluster/postmortem. With no argument it
uses $KF_TELEMETRY_DIR."""

import json
import os
import sys
import time
import urllib.request

from kungfu_tpu_torch import knobs


def _show_versions() -> None:
    import kungfu_tpu_torch

    print(f"kungfu_tpu_torch: {getattr(kungfu_tpu_torch, '__version__', 'dev')} "
          f"({os.path.dirname(kungfu_tpu_torch.__file__)})")
    try:
        import torch

        print(f"torch: {torch.__version__}")
        print(f"CUDA: {torch.version.cuda or 'none (a CPU build of torch)'}")
        cudnn = torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else None
        print(f"cuDNN: {cudnn if cudnn is not None else 'none'}")
        nccl = torch.cuda.nccl.version() if torch.distributed.is_nccl_available() else None
        print(f"NCCL: {'.'.join(map(str, nccl)) if nccl else 'none'}")
    except ImportError:
        print("torch is NOT installed")
    for mod in ("numpy", "triton"):
        try:
            m = __import__(mod)
            print(f"{mod}: {getattr(m, '__version__', '?')}")
        except ImportError:
            print(f"{mod} is NOT installed")


def _show_devices() -> None:
    try:
        import torch

        if not torch.cuda.is_available():
            print("devices: none (torch.cuda sees no card)")
            return
        kinds = {}
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            kinds.setdefault((p.name, f"sm_{p.major}{p.minor}"), []).append(i)
        for (name, arch), ids in kinds.items():
            print(f"devices: {len(ids)} x {name} (cuda, {arch})")
    except Exception as e:  # noqa: BLE001 - a broken backend is a finding
        print(f"device init FAILED: {e}")


def _show_cluster_env() -> None:
    kf = {k: v for k, v in os.environ.items() if k.startswith("KF_")}
    if not kf:
        print("cluster env: none (not under kfrun)")
        return
    print("cluster env:")
    for k in sorted(kf):
        print(f"  {k}={kf[k]}")


def _show_telemetry(argv) -> None:
    from kungfu_tpu_torch import telemetry

    feats = sorted(telemetry.features())
    print(f"telemetry: {','.join(feats) if feats else 'off'} "
          f"(KF_TELEMETRY={knobs.raw('KF_TELEMETRY')!r})")
    print("telemetry endpoints: http://<worker>:<peer_port+10000>"
          "/metrics | /trace | /audit")
    # an URL argument right after --telemetry: scrape a live worker
    idx = argv.index("--telemetry")
    url = argv[idx + 1] if idx + 1 < len(argv) else ""
    if url.startswith("http"):
        import urllib.request

        try:
            with urllib.request.urlopen(
                url.rstrip("/") + "/metrics", timeout=5
            ) as r:
                print(r.read().decode())
        except OSError as e:
            print(f"telemetry fetch FAILED: {e}")
        return
    # no URL: dump this process's own registry/trace/audit state
    d = telemetry.dump()
    n_spans = len(d["trace"]["traceEvents"])
    print(f"local trace buffer: {n_spans} events; "
          f"audit records: {len(d['audit'])}")
    if d["metrics"].strip():
        print(d["metrics"])


def _interval_flag(argv, cmd: str):
    """Parse --interval seconds (default 2.0); (None, rc) on bad input."""
    if "--interval" not in argv:
        return 2.0, None
    idx = argv.index("--interval")
    try:
        return float(argv[idx + 1]), None
    except (IndexError, ValueError):
        print(f"info {cmd}: --interval wants seconds, e.g. --interval 2",
              file=sys.stderr)
        return None, 2


def _cluster_url(argv, endpoint: str) -> str:
    """Resolve a /cluster/<endpoint> URL: explicit argument (full path
    or debug-endpoint base), else derived from KF_CLUSTER_HEALTH_URL —
    shared by the top/links/steps commands so the suffix munging can't
    drift between them."""
    urls = [a for a in argv if a.startswith("http")]
    url = urls[0] if urls else knobs.raw("KF_CLUSTER_HEALTH_URL")
    if not url:
        return ""
    url = url.rstrip("/")
    if url.endswith("/cluster/health"):
        url = url[: -len("/cluster/health")]
    if not url.endswith(endpoint):
        url += endpoint
    return url


def _count_flag(argv, cmd: str, default: int):
    """Parse `-n COUNT` (shared by steps/decisions); (None, rc) on bad
    input — the _interval_flag shape."""
    if "-n" not in argv:
        return default, None
    idx = argv.index("-n")
    try:
        return max(1, int(argv[idx + 1])), None
    except (IndexError, ValueError):
        print(f"info {cmd}: -n wants a count, e.g. -n 8", file=sys.stderr)
        return None, 2


def _json_flag(argv, render):
    """The --json flag: one flag in one place — every
    cluster subcommand swaps its renderer for a raw-payload dump when
    --json is passed, so scripts/CI read the endpoint document through
    the same URL resolution and fetch loop the human view uses."""
    if "--json" not in argv:
        return render
    return lambda doc: json.dumps(doc, indent=2)


def _fetch_render_loop(cmd: str, url: str, render, watch: bool,
                       interval: float) -> int:
    """The shared fetch-JSON → render → print/refresh loop behind the
    one-shot and --watch modes of top/links/steps/decisions. Watch mode
    rides out transient fetch blips (runner mid-restart) instead of
    killing the live view; the whole iteration is interruptible."""
    while True:
        try:
            try:
                with urllib.request.urlopen(url, timeout=5) as r:
                    frame = render(json.loads(r.read().decode()))
            except (OSError, ValueError) as e:
                if not watch:
                    print(f"info {cmd}: fetch {url} failed: {e}",
                          file=sys.stderr)
                    return 1
                frame = f"info {cmd}: fetch failed, retrying: {e}"
            if watch:
                # home + clear-to-end keeps the view refreshing in place
                print("\x1b[H\x1b[2J" + frame, flush=True)
                time.sleep(interval)
            else:
                print(frame)
                return 0
        except KeyboardInterrupt:
            return 0


def _fmt_num(v, fmt="{:.1f}", dash="-") -> str:
    return fmt.format(v) if isinstance(v, (int, float)) else dash


def _fmt_bytes(v) -> str:
    if not isinstance(v, (int, float)):
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024 or unit == "TiB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024
    return "-"


def render_top(health: dict) -> str:
    """One refresh frame of `info top`: a fixed-width table over
    /cluster/health, stragglers flagged in the last column. The CRIT%
    and CRIT-EDGE columns come from the step plane: the share
    of recent merged steps this peer was elected critical in, and the
    blocking edge those elections named. The CPU% and TRAIN% columns
    come from the resource plane: the window CPU fraction of
    the peer's effective cores and the training loop's share of the
    busy window; a flagged straggler carries its measured cause
    (STRAGGLER(network) vs STRAGGLER(compute) vs STRAGGLER(memory)).
    The MEM% and HEADROOM columns come from the memory plane: RSS as a
    share of the peer's effective memory limit, and the forecast
    headroom fraction."""
    steps = health.get("steps") or {}
    crit_frac = steps.get("crit_frac") or {}
    crit_edge = steps.get("crit_edge") or {}
    res_peers = (health.get("resources") or {}).get("peers") or {}
    mem_block = health.get("memory") or {}
    mem_peers = mem_block.get("peers") or {}
    cols = ("PEER", "STEP/S", "P50(ms)", "P99(ms)", "TX", "RX",
            "RTT(ms)", "AGE(s)", "CPU%", "TRAIN%", "MEM%", "HEADROOM",
            "CRIT%", "CRIT-EDGE", "FLAGS")
    rows = [cols]
    peers = health.get("peers", {})
    for label in sorted(peers):
        p = peers[label]
        flags = []
        if p.get("straggler"):
            cause = p.get("straggler_cause")
            flags.append(
                f"STRAGGLER({cause})"
                if cause and cause != "unknown" else "STRAGGLER"
            )
        if p.get("rtt_outlier"):
            flags.append("RTT")
        if p.get("error"):
            flags.append("UNREACHABLE")
        cf = crit_frac.get(label)
        r = res_peers.get(label) or {}
        cpu = r.get("cpu_frac")
        train = r.get("train_frac")
        m = mem_peers.get(label) or {}
        used = m.get("used_frac")
        headroom = m.get("headroom_frac")
        rows.append((
            label,
            _fmt_num(p.get("step_rate"), "{:.2f}"),
            _fmt_num(p.get("step_time_p50_ms")),
            _fmt_num(p.get("step_time_p99_ms")),
            _fmt_bytes(p.get("bytes_tx")),
            _fmt_bytes(p.get("bytes_rx")),
            _fmt_num(p.get("rtt_ms"), "{:.2f}"),
            _fmt_num(p.get("last_scrape_age_s")),
            f"{cpu:.0%}" if isinstance(cpu, (int, float)) else "-",
            f"{train:.0%}" if isinstance(train, (int, float)) else "-",
            f"{used:.0%}" if isinstance(used, (int, float)) else "-",
            f"{headroom:.0%}" if isinstance(headroom, (int, float)) else "-",
            f"{cf:.0%}" if isinstance(cf, (int, float)) else "-",
            f"→{crit_edge[label]}" if label in crit_edge else "-",
            ",".join(flags) or "ok",
        ))
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(cols))]
    lines = ["  ".join(str(c).ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    skew = health.get("step_skew")
    stragglers = health.get("stragglers", [])
    summary = (
        f"{len(peers)} peers"
        + (f", step skew {skew:.2f}x" if isinstance(skew, (int, float)) else "")
        + (f", STRAGGLERS: {', '.join(stragglers)}" if stragglers else "")
    )
    crit_peer = steps.get("critical_peer")
    if crit_peer:
        edge = steps.get("critical_edge")
        ov = steps.get("overlap_frac")
        summary += (
            f"; last step critical: {crit_peer}"
            + (f" →{edge}" if edge else "")
            + (
                f", overlap {ov:.0%}"
                if isinstance(ov, (int, float)) else ""
            )
        )
    sat = (health.get("resources") or {}).get("saturated") or []
    if sat:
        summary += f"; compute-saturated: {', '.join(sat)}"
    pressured = mem_block.get("pressure") or []
    if pressured:
        summary += f"; memory-pressured: {', '.join(pressured)}"
    leaks = mem_block.get("leak_suspects") or {}
    if leaks:
        summary += "; leak suspects: " + ", ".join(
            f"{peer}({','.join(buckets)})"
            for peer, buckets in sorted(leaks.items())
        )
    plane_line = _render_plane_line(health.get("plane"))
    head = [summary] + ([plane_line] if plane_line else [])
    return "\n".join(head + lines)


def _render_plane_line(plane) -> str:
    """Telemetry-plane health line: surfaces whether the
    aggregator itself is keeping up — scrape mode (flat vs the scaled
    hier/sampled shapes), last sweep wall time against its effective
    interval (> interval means the plane is in backoff and the columns
    above are staler than configured), and peers whose scrapes are
    stale."""
    if not isinstance(plane, dict) or not plane:
        return ""
    parts = [f"plane: {plane.get('mode', '?')}"]
    sweep = plane.get("sweep_seconds")
    interval = plane.get("effective_interval_s") or plane.get("interval_s")
    if isinstance(sweep, (int, float)):
        part = f"sweep {sweep:.2f}s"
        if isinstance(interval, (int, float)) and interval > 0:
            part += f"/{interval:g}s"
            if sweep > interval:
                part += " OVERLOADED"
        parts.append(part)
    scraped = plane.get("scraped_peers")
    stale = plane.get("stale_peers")
    if isinstance(scraped, int):
        parts.append(f"{scraped} scraped")
    # the envelope ships a count; older health docs may carry labels
    if isinstance(stale, bool):
        pass
    elif isinstance(stale, int) and stale > 0:
        parts.append(f"{stale} stale")
    elif isinstance(stale, (list, tuple)) and stale:
        parts.append(f"stale: {', '.join(stale)}")
    age = plane.get("oldest_link_row_age_s")
    if isinstance(age, (int, float)):
        parts.append(f"oldest link row {age:.0f}s")
    return ", ".join(parts)


def _cmd_top(argv) -> int:
    watch = "--watch" in argv
    interval, rc = _interval_flag(argv, "top")
    if rc is not None:
        return rc
    url = _cluster_url(argv, "/cluster/health")
    if not url:
        print(
            "info top: no /cluster/health URL — pass one, or run under "
            "kfrun -w -debug-port N (which exports KF_CLUSTER_HEALTH_URL)",
            file=sys.stderr,
        )
        return 2
    return _fetch_render_loop(
        "top", url, _json_flag(argv, render_top), watch, interval
    )


def render_links(doc: dict) -> str:
    """One frame of `info links`: the k×k bandwidth matrix over
    /cluster/links. Rows are source peers (numbered, legend below),
    columns destinations; cells are EWMA bandwidth in MiB/s. Edges
    slower than half the median carry a `!` marker — the "which link is
    slow?" answer at a glance."""
    peers = doc.get("peers", [])
    edges = doc.get("edges", {})
    if not peers:
        return "no peers in the link matrix yet (no scrape, or telemetry off)"
    idx = {p: i for i, p in enumerate(peers)}
    bws = [
        info.get("bw")
        for row in edges.values()
        for info in row.values()
        if isinstance(info.get("bw"), (int, float)) and info.get("bw") > 0
    ]
    median = sorted(bws)[len(bws) // 2] if bws else None
    slow_cut = median / 2 if median else None

    def cell(src: str, dst: str) -> str:
        if src == dst:
            return "."
        bw = edges.get(src, {}).get(dst, {}).get("bw")
        if not isinstance(bw, (int, float)) or bw <= 0:
            return "-"
        mark = "!" if slow_cut is not None and bw < slow_cut else ""
        return f"{bw / (1 << 20):.1f}{mark}"

    cols = ["SRC\\DST"] + [f"[{idx[p]}]" for p in peers]
    rows = [cols]
    for src in peers:
        rows.append([f"[{idx[src]}]"] + [cell(src, dst) for dst in peers])
    widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
    lines = ["  ".join(c.rjust(w) for c, w in zip(r, widths)) for r in rows]
    min_bw = doc.get("min_bw")
    slowest = doc.get("slowest_edge")
    summary = f"{len(peers)} peers, bandwidth MiB/s (EWMA, passive)"
    if isinstance(min_bw, (int, float)) and slowest:
        summary += (
            f"; slowest edge [{idx.get(slowest[0], '?')}]→"
            f"[{idx.get(slowest[1], '?')}] at {min_bw / (1 << 20):.1f} MiB/s"
        )
    legend = [f"  [{i}] {p}" for p, i in sorted(idx.items(), key=lambda kv: kv[1])]
    notes = "cells: MiB/s, '-' no estimate yet, '!' under half the median"
    return "\n".join(
        [summary] + lines + _render_ring_lines(doc, peers, idx)
        + [notes, "peers:"] + legend
    )


def _same_cycle(a: list, b: list) -> bool:
    """Directed-cycle equality up to rotation: rings are
    rotation-invariant, and the CLI's derivation starts from the
    first LISTED peer while the engine pins rank 0 — the two can agree
    on the cycle yet disagree on where to start printing it."""
    if len(a) != len(b) or not a:
        return False
    if set(a) != set(b):
        return False
    i = b.index(a[0])
    return list(a) == list(b[i:]) + list(b[:i])


def _render_ring_lines(doc: dict, peers: list, idx: dict) -> list:
    """Ring view under the matrix: the ACTIVE ring order the
    workers export (starred when it differs from rank order — a measured
    re-plan landed) and the order the optimizer would derive from the
    rendered matrix — so an operator sees a PENDING re-plan before the
    vote lands. Derivation runs the same pure `plan.replan.ring_order`
    the engine votes on, fed by the same matrix this frame renders;
    ADVISORY only: the CLI indexes peers in listing order (it cannot
    know ranks), so agreement with the active ring is judged as a
    directed CYCLE (rotation-invariant), and a greedy construction from
    a different start can still legitimately differ on near-tie
    matrices."""
    lines = []

    def fmt(order_labels) -> str:
        return "→".join(f"[{idx[p]}]" for p in order_labels if p in idx)

    ring = doc.get("ring") or {}
    active = ring.get("order")
    if active:
        star = " ★ re-planned (differs from rank order)" if (
            not _same_cycle(list(active), list(peers))
        ) else " (rank order)"
        lines.append(f"active ring:    {fmt(active)}{star}")
    # active wire precision: cluster-agreed by the lockstep
    # precision votes, so one value is the norm — a split view means a
    # scrape straddled a flip (or a real codec divergence: investigate)
    wire = ring.get("wire") or {}
    if wire:
        modes = sorted(set(wire.values()))
        if len(modes) == 1:
            lines.append(f"wire precision: {modes[0]}")
        else:
            split = ", ".join(
                f"[{idx.get(p, '?')}]={m}" for p, m in sorted(
                    wire.items(), key=lambda kv: idx.get(kv[0], len(idx)))
            )
            lines.append(f"wire precision: SPLIT ({split}) ⚠")
    # two-level hierarchy: the workers' exported roles name
    # host groups, the head carrying each group's inter-host leg, and
    # demoted peers (▽ — zero-weight, served by broadcast)
    roles = ring.get("role") or {}
    hier = {
        p: r for p, r in roles.items()
        if isinstance(r, dict) and r.get("level") != "flat"
    }
    if hier:
        groups: dict = {}
        for p, r in hier.items():
            groups.setdefault(int(r.get("group") or 0), []).append((p, r))

        def member(p: str, r: dict) -> str:
            return f"[{idx.get(p, '?')}]" + (
                "▽" if r.get("role") == "demoted" else "")

        parts = []
        for g in sorted(groups):
            members = sorted(groups[g],
                             key=lambda kv: idx.get(kv[0], len(idx)))
            head = next(
                (p for p, r in members if r.get("role") == "head"), None)
            body = ",".join(member(p, r) for p, r in members)
            htag = f"|h[{idx[head]}]" if head in idx else ""
            parts.append("{" + body + htag + "}")
        tail = " (▽ demoted)" if any(
            r.get("role") == "demoted" for r in hier.values()) else ""
        lines.append("hierarchy:      " + "→".join(parts) + tail)
    bw = [
        [
            (doc.get("edges", {}).get(src, {}).get(dst, {}) or {}).get("bw")
            or 0.0
            for dst in peers
        ]
        for src in peers
    ]
    try:
        import numpy as _np

        from kungfu_tpu_torch.plan import replan as _replan

        order = _replan.ring_order(_np.asarray(bw, float))
    except Exception as e:  # noqa: BLE001 - a render must survive a bad matrix
        lines.append(f"predicted ring: unavailable ({e})")
        return lines
    predicted = [peers[i] for i in order]
    if active and _same_cycle(list(predicted), list(active)):
        # display the agreeing cycle rotated to match the active line
        i = predicted.index(active[0])
        predicted = predicted[i:] + predicted[:i]
    mark = ""
    if active and list(predicted) != list(active):
        mark = " ← pending re-plan (differs from the active ring)"
    elif not active and not _same_cycle(list(predicted), list(peers)):
        mark = " ← differs from rank order"
    lines.append(f"predicted ring: {fmt(predicted)}{mark}")
    return lines


def _cmd_links(argv) -> int:
    watch = "--watch" in argv
    interval, rc = _interval_flag(argv, "links")
    if rc is not None:
        return rc
    url = _cluster_url(argv, "/cluster/links")
    if not url:
        print(
            "info links: no /cluster/links URL — pass one (or a runner "
            "debug endpoint), or run under kfrun -w -debug-port N "
            "(which exports KF_CLUSTER_HEALTH_URL)",
            file=sys.stderr,
        )
        return 2
    return _fetch_render_loop(
        "links", url, _json_flag(argv, render_links), watch, interval
    )


def render_steps(doc: dict, limit: int = 8) -> str:
    """One frame of `info steps`: the newest merged steps (newest last)
    as aligned per-peer lanes with the critical chain called out —
    rendering shared with the flight postmortem (steptrace.render_step)
    so the live view and the black box read identically."""
    from kungfu_tpu_torch.telemetry import steptrace

    steps = doc.get("steps") or []
    if not steps:
        return (
            "no merged steps yet — the step plane needs the async "
            "scheduler (KF_CONFIG_ASYNC=on|auto) and at least one "
            "recorded round per worker (KF_TELEMETRY_SPAN_SAMPLE > 0)"
        )
    shown = steps[-limit:]
    lines: list = [
        f"{len(steps)} merged steps on record, showing {len(shown)} "
        "(lanes: · queued  ≈ wait  ■ compute  > send  g gather tail; "
        "* = critical peer)"
    ]
    for s in shown:
        lines.append("")
        lines.extend(steptrace.render_step(s))
        chain = s.get("chain") or []
        if len(chain) > 1:
            tail = ", ".join(
                f"{c['peer']}#{c['bucket']}"
                + (f"→{c['edge']}" if c.get("edge") else "")
                + f" {c['self_us'] / 1e3:.1f}ms"
                for c in chain[1:]
            )
            lines.append(f"   chain tail: {tail}")
    return "\n".join(lines)


def _cmd_steps(argv) -> int:
    watch = "--watch" in argv
    interval, rc = _interval_flag(argv, "steps")
    if rc is not None:
        return rc
    limit, rc = _count_flag(argv, "steps", 8)
    if rc is not None:
        return rc
    url = _cluster_url(argv, "/cluster/steps")
    if not url:
        print(
            "info steps: no /cluster/steps URL — pass one (or a runner "
            "debug endpoint), or run under kfrun -w -debug-port N "
            "(which exports KF_CLUSTER_HEALTH_URL)",
            file=sys.stderr,
        )
        return 2
    return _fetch_render_loop(
        "steps", url,
        _json_flag(argv, lambda doc: render_steps(doc, limit=limit)),
        watch, interval,
    )


def _cmd_decisions(argv) -> int:
    watch = "--watch" in argv
    interval, rc = _interval_flag(argv, "decisions")
    if rc is not None:
        return rc
    limit, rc = _count_flag(argv, "decisions", 16)
    if rc is not None:
        return rc
    url = _cluster_url(argv, "/cluster/decisions")
    if not url:
        print(
            "info decisions: no /cluster/decisions URL — pass one (or a "
            "runner debug endpoint), or run under kfrun -w -debug-port N "
            "(which exports KF_CLUSTER_HEALTH_URL)",
            file=sys.stderr,
        )
        return 2
    from kungfu_tpu_torch.telemetry import decisions as _dec

    return _fetch_render_loop(
        "decisions", url,
        _json_flag(argv, lambda doc: _dec.render_decisions(doc, limit=limit)),
        watch, interval,
    )


def render_resources(doc: dict) -> str:
    """One frame of `info resources`: the merged per-peer CPU
    attribution table — rendering shared with the worker view
    (resource.render_resources) so the live view and tests read
    identically."""
    from kungfu_tpu_torch.telemetry import resource as _tres

    if not (doc.get("peers") or {}):
        return (
            "no resource documents yet — workers publish /resources "
            "once telemetry is on (kfrun -w) and a scrape has landed; "
            "per-thread accounting needs Linux (/proc)"
        )
    return "\n".join(_tres.render_resources(doc))


def _cmd_resources(argv) -> int:
    watch = "--watch" in argv
    interval, rc = _interval_flag(argv, "resources")
    if rc is not None:
        return rc
    url = _cluster_url(argv, "/cluster/resources")
    if not url:
        print(
            "info resources: no /cluster/resources URL — pass one (or a "
            "runner debug endpoint), or run under kfrun -w -debug-port N "
            "(which exports KF_CLUSTER_HEALTH_URL)",
            file=sys.stderr,
        )
        return 2
    return _fetch_render_loop(
        "resources", url, _json_flag(argv, render_resources), watch, interval
    )


def render_memory(doc: dict) -> str:
    """One frame of `info memory`: the merged per-peer RSS
    decomposition table — rendering shared with the merge tests
    (memory.render_memory) so the live view and tests read
    identically."""
    from kungfu_tpu_torch.telemetry import memory as _tmem

    if not (doc.get("peers") or {}):
        return (
            "no memory documents yet — workers publish /memory once "
            "telemetry is on (kfrun -w) and a scrape has landed; RSS "
            "accounting needs Linux (/proc)"
        )
    return "\n".join(_tmem.render_memory(doc))


def _cmd_memory(argv) -> int:
    watch = "--watch" in argv
    interval, rc = _interval_flag(argv, "memory")
    if rc is not None:
        return rc
    url = _cluster_url(argv, "/cluster/memory")
    if not url:
        print(
            "info memory: no /cluster/memory URL — pass one (or a "
            "runner debug endpoint), or run under kfrun -w -debug-port N "
            "(which exports KF_CLUSTER_HEALTH_URL)",
            file=sys.stderr,
        )
        return 2
    return _fetch_render_loop(
        "memory", url, _json_flag(argv, render_memory), watch, interval
    )


def _cmd_postmortem(argv) -> int:
    from kungfu_tpu_torch.telemetry import flight

    target = next(
        (a for a in argv if not a.startswith("-")), ""
    ) or knobs.raw(flight.DIR_ENV)
    if not target:
        print(
            "info postmortem: no target — pass a telemetry run dir or a "
            "runner debug URL (or set KF_TELEMETRY_DIR)",
            file=sys.stderr,
        )
        return 2
    if target.startswith("http"):
        url = target.rstrip("/")
        if not url.endswith("/cluster/postmortem"):
            url += "/cluster/postmortem"
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                doc = json.loads(r.read().decode())
        except (OSError, ValueError) as e:
            print(f"info postmortem: fetch {url} failed: {e}", file=sys.stderr)
            return 1
        pms = [pm for recs in doc.get("peers", {}).values() for pm in recs]
    else:
        if not os.path.isdir(target):
            print(f"info postmortem: {target}: not a directory", file=sys.stderr)
            return 2
        # a single PEER dir (holds a journal itself) or a run dir
        single = flight.harvest_peer_dir(target)
        pms = [single] if single is not None else flight.harvest_run_dir(target)
    if not pms:
        print(f"no postmortems found in {target}")
        return 0
    pms.sort(key=lambda p: p.get("wall_time") or 0.0)
    print(f"{len(pms)} worker death(s) on record")
    for pm in pms:
        print()
        print(flight.render_postmortem(pm))
    return 0


def main(argv) -> None:
    if argv and argv[0] == "top":
        sys.exit(_cmd_top(argv[1:]))
    if argv and argv[0] == "links":
        sys.exit(_cmd_links(argv[1:]))
    if argv and argv[0] == "steps":
        sys.exit(_cmd_steps(argv[1:]))
    if argv and argv[0] == "decisions":
        sys.exit(_cmd_decisions(argv[1:]))
    if argv and argv[0] == "resources":
        sys.exit(_cmd_resources(argv[1:]))
    if argv and argv[0] == "memory":
        sys.exit(_cmd_memory(argv[1:]))
    if argv and argv[0] == "postmortem":
        sys.exit(_cmd_postmortem(argv[1:]))
    _show_versions()
    if "--no-devices" not in argv:
        _show_devices()
    _show_cluster_env()
    if "--telemetry" in argv:
        _show_telemetry(argv)
    allowed = (
        len(os.sched_getaffinity(0))
        if hasattr(os, "sched_getaffinity")  # Linux-only
        else os.cpu_count()
    )
    print(f"cpus: {allowed} allowed / {os.cpu_count()} online")


if __name__ == "__main__":
    main(sys.argv[1:])

"""kfrun — the per-host launcher CLI.

Port of `kungfu_tpu/runner/cli.py` (parity: srcs/go/cmd/kungfu-run,
app/kungfu-run.go:18-117 + runner/flags.go:30-145), every flag and default
of the reference:

  python -m kungfu_tpu_torch.runner.cli -np 4 python3 train.py     # simple run
  ... -np 4 -H h1:2,h2:2 ...          # multi-host plan (this host's workers
                                      # only; start kfrun per host)
  ... -w -config-server URL ...       # elastic watch mode
  ... -np 4 -auto-recover 10s ...     # failure auto-recovery
  ... -builtin-config-port 9100 ...   # embedded config server

The workers get the reference's environment contract (`runner/env.py`),
so this runner starts either package's workers and the reference's
starts the port's. Each run mints one flight-recorder run dir
(`KF_TELEMETRY_DIR`, unless the operator set one) that every worker
inherits: the workers' journals and the runner's postmortems land under
it. In watch mode `-debug-port` serves the Stage dump and the cluster
aggregator's `/cluster/*` views.
"""

from __future__ import annotations

import argparse
import os
import random
import signal
import socket
import sys
import time
from typing import List, Optional

from kungfu_tpu_torch.base.strategy import Strategy
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.plan.hostspec import HostList, parse_hostfile
from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.runner import env as kfenv
from kungfu_tpu_torch.runner.proc import WorkerProc, run_all

DEFAULT_RUNNER_PORT = 38080


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "kfrun", description="KungFu launcher of kungfu_tpu_torch", allow_abbrev=False
    )
    p.add_argument("-np", type=int, default=1, help="number of workers")
    p.add_argument("-H", dest="hosts", default="", help="host list ip:slots[:pub],...")
    p.add_argument("-hostfile", default="", help="hostfile path")
    p.add_argument("-self", dest="self_host", default="", help="this host's address")
    p.add_argument("-platform", default="",
                   help="self-discover hosts: tpu-vm | gce | auto "
                        "(parity: platforms/modelarts)")
    p.add_argument("-strategy", default="AUTO", help=f"one of {[s.name for s in Strategy]}")
    p.add_argument("-port-range", default="38000-38999")
    p.add_argument("-runner-port", type=int, default=DEFAULT_RUNNER_PORT)
    p.add_argument("-w", "--watch", action="store_true", help="elastic watch mode")
    p.add_argument("-config-server", default="", help="config server URL")
    p.add_argument("-builtin-config-port", type=int, default=-1,
                   help="embed a config server on this port (0 = ephemeral)")
    p.add_argument("-elastic-mode", default="", choices=["", "reload"])
    p.add_argument("-auto-recover", default="", help="e.g. 10s: heartbeat auto-recovery")
    p.add_argument("-monitor-port", type=int, default=7756,
                   help="heartbeat monitor port (0 = ephemeral)")
    p.add_argument("-monitor-peers", default="",
                   help="all runners' monitor host:port list (default: "
                        "every runner host on -monitor-port)")
    p.add_argument("-warm-spares", type=int, default=1,
                   help="standby workers kept warm per runner in -w mode "
                        "(0 disables); activation replaces cold joiner "
                        "spawn+import during an elastic grow")
    p.add_argument("-standby-preload", default="auto",
                   help="comma-separated modules standbys pre-import; "
                        "'auto' (default) pre-imports the port's device "
                        "stack (torch, kungfu_tpu_torch.api; import only, "
                        "no CUDA context); 'none' disables")
    p.add_argument("-use-affinity", action="store_true",
                   help="pin each local worker to a disjoint, NUMA-aligned "
                        "CPU slice (parity: KUNGFU_USE_AFFINITY)")
    p.add_argument("-devices-per-host", type=int, default=0,
                   help="partition this many card ids among local workers "
                        "(KF_DEVICE_SLOTS pinning; 0 = no pinning)")
    p.add_argument("-debug-port", type=int, default=-1,
                   help="HTTP endpoint of Stage dumps (0 = ephemeral)")
    p.add_argument("-logdir", default="")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-delay", type=float, default=0.0)
    p.add_argument("-timeout", type=float, default=0.0, help="kill workers after this many seconds")
    p.add_argument("cmd", nargs=argparse.REMAINDER, help="worker command")
    return p


def infer_self_host(hosts: HostList) -> str:
    """Pick this host's address from the host list (parity:
    runner.InferSelfIPv4; hostname/IP matching instead of NIC scanning)."""
    candidates = {h.host for h in hosts}
    if "127.0.0.1" in candidates or "localhost" in candidates:
        return "127.0.0.1" if "127.0.0.1" in candidates else "localhost"
    names = {socket.gethostname(), socket.getfqdn()}
    try:
        names.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    for h in hosts:
        if h.host in names:
            return h.host
    raise SystemExit(f"cannot find self among hosts {sorted(candidates)}; use -self")


def parse_port_range(s: str):
    a, _, b = s.partition("-")
    return (int(a), int(b or a))


def free_ports(n: int) -> List[int]:
    """n localhost ports the kernel calls free (bound to 0, then closed),
    none in kfrun's default 38000-38999."""
    socks, out = [], []
    try:
        while len(out) < n:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            if not 38000 <= s.getsockname()[1] < 39000:
                out.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return out


def free_port_range(n: int) -> int:
    """The first of n consecutive localhost ports that bind now, in
    12000-19999 (outside kfrun's default 38000-38999 and the device
    plane's 20000-29999): a `-port-range` for a cluster of n workers."""
    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(12000, 20000 - n)
        socks = []
        try:
            for port in range(base, base + n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise RuntimeError("no free port range")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print("kfrun: no worker command given", file=sys.stderr)
        return 2

    try:
        if args.platform:
            from kungfu_tpu_torch.runner.platform import detect

            pc = detect(args.platform)
            if pc is None:
                print(f"kfrun: platform {args.platform!r} not detected", file=sys.stderr)
                return 2
            import dataclasses as _dc

            slots = max(1, -(-args.np // len(pc.hosts)))  # spread np over hosts
            hosts = HostList(_dc.replace(h, slots=slots) for h in pc.hosts)
            if not args.self_host:
                args.self_host = pc.self_host
        elif args.hostfile:
            with open(args.hostfile) as f:
                hosts = parse_hostfile(f.read())
        elif args.hosts:
            hosts = HostList.parse(args.hosts)
        else:
            hosts = HostList.parse(f"127.0.0.1:{args.np}")

        port_range = parse_port_range(args.port_range)
        workers = hosts.gen_peer_list(args.np, port_range)
        runners = hosts.gen_runner_list(args.runner_port)
        cluster = Cluster(runners=runners, workers=workers)
        cluster.validate()
        self_host = args.self_host or infer_self_host(hosts)
        strategy = Strategy.parse(args.strategy)
        # device-slot share is sized by host CAPACITY, stable across resizes
        args.host_capacity = next((h.slots for h in hosts if h.host == self_host), 1)
        if 0 < args.devices_per_host < args.host_capacity:
            # at full capacity every local worker needs >= 1 card, or a
            # later elastic grow would exhaust the watcher's slot pool
            raise ValueError(
                f"-devices-per-host {args.devices_per_host} < host capacity "
                f"{args.host_capacity}: not every worker could get a card"
            )
    except (ValueError, OSError) as e:
        print(f"kfrun: {e}", file=sys.stderr)
        return 2

    # flight-recorder run dir: minted once per run and inherited by every
    # worker through the environment, so all the peer journals and the
    # runner's postmortems land under one directory. An operator-set
    # KF_TELEMETRY_DIR wins; the default base is pruned so unattended
    # loops do not grow it forever.
    from kungfu_tpu_torch import knobs
    from kungfu_tpu_torch.telemetry import flight

    if not knobs.raw(flight.DIR_ENV):
        flight.prune_runs()
        os.environ[flight.DIR_ENV] = flight.default_run_dir()

    config_server_url = args.config_server
    builtin_server = None
    if args.builtin_config_port >= 0:
        from kungfu_tpu_torch.elastic.configserver import ConfigServer

        builtin_server = ConfigServer(args.builtin_config_port, cluster)
        builtin_server.start()
        config_server_url = f"http://{self_host}:{builtin_server.port}/config"

    if args.delay:
        time.sleep(args.delay)

    if args.debug_port >= 0 and not args.watch:
        print("kfrun: -debug-port (Stage dumps + /cluster telemetry) needs watch "
              "mode (-w); ignoring", file=sys.stderr)

    try:
        if args.auto_recover and not args.watch:
            from kungfu_tpu_torch.runner.monitored import monitored_run

            return monitored_run(args, cmd, cluster, self_host, strategy)
        if args.watch:
            from kungfu_tpu_torch.runner.watch import watch_run

            return watch_run(args, cmd, cluster, self_host, strategy, config_server_url)
        return simple_run(args, cmd, cluster, self_host, strategy, config_server_url)
    finally:
        if builtin_server:
            builtin_server.stop()


def make_one_worker_proc(
    args, cmd, cluster: Cluster, worker: PeerID, self_host: str,
    strategy: Strategy, config_server_url: str = "", version: int = 0,
    progress: int = 0, device_slots=None,
) -> WorkerProc:
    rank = cluster.workers.rank(worker)
    env = kfenv.worker_env(
        self_id=worker,
        peers=cluster.workers,
        runners=cluster.runners,
        parent=PeerID(self_host, args.runner_port),
        cluster_version=version,
        strategy=strategy,
        config_server=config_server_url,
        elastic_mode=args.elastic_mode,
        init_progress=progress,
        device_slots=device_slots,
    )
    env["KF_LOG_PREFIX"] = f"{rank}/{len(cluster.workers)}"
    env["KF_SPAWN_TS"] = str(time.time())
    return WorkerProc(
        name=f"{rank}/{len(cluster.workers)}",
        argv=list(cmd),
        env=env,
        rank=rank,
        logdir=args.logdir,
        quiet=args.quiet,
    )


def make_worker_procs(
    args, cmd, cluster: Cluster, self_host: str, strategy: Strategy,
    config_server_url: str = "", version: int = 0, progress: int = 0,
) -> List[WorkerProc]:
    local = [w for w in cluster.workers if w.host == self_host]
    slot_parts: List[Optional[list]] = [None] * len(local)
    n_dev = getattr(args, "devices_per_host", 0)
    if n_dev > 0 and local:
        from kungfu_tpu_torch.runner.slots import partition

        if len(local) > n_dev:
            raise SystemExit(f"kfrun: {len(local)} local workers but only {n_dev} device slots")
        # static membership (simple/monitored runs): rank-major stripes
        slot_parts = partition(n_dev, len(local))
    cpu_parts: List[Optional[list]] = [None] * len(local)
    if getattr(args, "use_affinity", False) and local:
        from kungfu_tpu_torch.runner.affinity import plan_affinity

        cpu_parts = plan_affinity(len(local))
    procs = [
        make_one_worker_proc(
            args, cmd, cluster, w, self_host, strategy, config_server_url,
            version, progress, device_slots=slot_parts[i],
        )
        for i, w in enumerate(local)
    ]
    for p, cpus in zip(procs, cpu_parts):
        p.cpus = cpus
    return procs


def simple_run(args, cmd, cluster, self_host, strategy, config_server_url="") -> int:
    procs = make_worker_procs(args, cmd, cluster, self_host, strategy, config_server_url)
    if args.timeout:
        def on_alarm(sig, frame):
            for p in procs:
                p.kill()
        signal.signal(signal.SIGALRM, on_alarm)
        signal.alarm(int(args.timeout))
    codes = run_all(procs)
    bad = [c for c in codes if c != 0]
    if bad:
        print(f"kfrun: {len(bad)}/{len(codes)} workers failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Worker environment contract.

Port of `kungfu_tpu/runner/env.py` (parity: srcs/go/kungfu/env/envs.go:4-20
+ config.go:53-140): the runner passes cluster topology to workers through
`KF_*` variables; a worker started without them becomes a single-process
cluster of itself. The port reads them through its `knobs` registry
(`parallel/distributed.py::parse_worker_env` reads the same ones), and
`worker_env` writes the block kfrun sets, so a `Peer` of either package
starts from one environment.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.base.strategy import DEFAULT_STRATEGY, Strategy
from kungfu_tpu_torch.plan.peer import PeerID, PeerList

SELF_SPEC = "KF_SELF_SPEC"
INIT_PEERS = "KF_INIT_PEERS"
INIT_RUNNERS = "KF_INIT_RUNNERS"
PARENT_ID = "KF_PARENT_ID"
INIT_CLUSTER_VERSION = "KF_INIT_CLUSTER_VERSION"
ALLREDUCE_STRATEGY = "KF_ALLREDUCE_STRATEGY"
CONFIG_SERVER = "KF_CONFIG_SERVER"
ELASTIC_MODE = "KF_ELASTIC_MODE"
INIT_PROGRESS = "KF_INIT_PROGRESS"
DEVICE_SLOTS = "KF_DEVICE_SLOTS"
# tuning (parity: config/config.go:24-67)
ENABLE_MONITORING = "KF_CONFIG_ENABLE_MONITORING"
ENABLE_STALL_DETECTION = "KF_CONFIG_ENABLE_STALL_DETECTION"
LOG_LEVEL = "KF_CONFIG_LOG_LEVEL"

ALL_ENV_NAMES = [
    SELF_SPEC, INIT_PEERS, INIT_RUNNERS, PARENT_ID, INIT_CLUSTER_VERSION,
    ALLREDUCE_STRATEGY, CONFIG_SERVER, ELASTIC_MODE, INIT_PROGRESS,
    DEVICE_SLOTS, ENABLE_MONITORING, ENABLE_STALL_DETECTION, LOG_LEVEL,
]


@dataclasses.dataclass
class WorkerConfig:
    self_id: PeerID
    peers: PeerList
    runners: PeerList
    parent: Optional[PeerID]
    cluster_version: int
    strategy: Strategy
    config_server: str
    elastic_mode: str  # "" (delta) | "reload"
    init_progress: int
    single_process: bool = False
    # card ids this worker may open (empty = unrestricted); parity:
    # job/gpu_resource.go slot assignment
    device_slots: tuple = ()


def parse_config_from_env(environ: Optional[Mapping[str, str]] = None) -> WorkerConfig:
    """The worker's config from `os.environ`, or from `environ`."""
    self_spec = knobs.get(SELF_SPEC, environ)
    if not self_spec:
        # single-process fallback (parity: config.go:131-140)
        me = PeerID("127.0.0.1", 10000)
        return WorkerConfig(
            self_id=me,
            peers=PeerList([me]),
            runners=PeerList(),
            parent=None,
            cluster_version=0,
            strategy=DEFAULT_STRATEGY,
            config_server=knobs.get(CONFIG_SERVER, environ),
            elastic_mode=knobs.get(ELASTIC_MODE, environ),
            init_progress=knobs.get(INIT_PROGRESS, environ),
            single_process=True,
        )
    parent = knobs.get(PARENT_ID, environ)
    return WorkerConfig(
        self_id=PeerID.parse(self_spec),
        peers=PeerList.parse(knobs.get(INIT_PEERS, environ) or self_spec),
        runners=PeerList.parse(knobs.get(INIT_RUNNERS, environ)),
        parent=PeerID.parse(parent) if parent else None,
        cluster_version=knobs.get(INIT_CLUSTER_VERSION, environ),
        strategy=Strategy.parse(knobs.get(ALLREDUCE_STRATEGY, environ)),
        config_server=knobs.get(CONFIG_SERVER, environ),
        elastic_mode=knobs.get(ELASTIC_MODE, environ),
        init_progress=knobs.get(INIT_PROGRESS, environ),
        device_slots=tuple(int(s) for s in knobs.get(DEVICE_SLOTS, environ)),
    )


def worker_env(
    self_id: PeerID,
    peers: PeerList,
    runners: PeerList,
    parent: Optional[PeerID],
    cluster_version: int = 0,
    strategy: Strategy = DEFAULT_STRATEGY,
    config_server: str = "",
    elastic_mode: str = "",
    init_progress: int = 0,
    device_slots=None,
) -> dict:
    """Env block a runner sets for a spawned worker (parity: job.go:35-80).
    Card slots travel as `KF_DEVICE_SLOTS` alone: the device plane opens
    `cuda:<slot>` itself, so no visibility variable renumbers the cards."""
    env = {
        SELF_SPEC: str(self_id),
        INIT_PEERS: ",".join(str(p) for p in peers),
        INIT_RUNNERS: ",".join(str(r) for r in runners),
        PARENT_ID: str(parent) if parent is not None else "",
        INIT_CLUSTER_VERSION: str(cluster_version),
        ALLREDUCE_STRATEGY: strategy.name,
        INIT_PROGRESS: str(init_progress),
    }
    if config_server:
        env[CONFIG_SERVER] = config_server
    if elastic_mode:
        env[ELASTIC_MODE] = elastic_mode
    if device_slots:
        env[DEVICE_SLOTS] = ",".join(str(i) for i in device_slots)
    return env

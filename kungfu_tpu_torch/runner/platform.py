"""Cloud platform adapters: self-discover the host list on managed clusters.

Port of `kungfu_tpu/runner/platform.py`, framework-free: the same
environment contract and metadata attributes. Capability parity:
srcs/go/platforms/modelarts/modelarts.go — the reference parses Huawei
ModelArts' injected env (DLS_TASK_INDEX / DLS_TASK_NUMBER /
BATCH_CUSTOM<i>_HOSTS) into a PeerList so kungfu-run needs no -H flag. The
adapters target Cloud TPU VMs: a pod slice's workers learn their
index and the full worker hostname list from the TPU runtime env
(TPU_WORKER_ID / TPU_WORKER_HOSTNAMES, set by the TPU VM image) or from the
GCE metadata server's instance attributes (agent-worker-number /
worker-network-endpoints).

Usage: ``kfrun -platform tpu-vm ...`` — the adapter supplies the HostList
and this host's identity; everything downstream (peer lists, runners,
elastic) is unchanged.
"""

from __future__ import annotations

import dataclasses
import os
import urllib.request
from typing import Callable, Optional

from kungfu_tpu_torch.plan.hostspec import HostList, HostSpec

# TPU VM runtime env (set by the Cloud TPU VM image on every worker)
TPU_WORKER_ID = "TPU_WORKER_ID"
TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"

METADATA_BASE = "http://metadata.google.internal/computeMetadata/v1"
_ATTR = "/instance/attributes/"
# GCE/TPU-VM metadata attribute names
ATTR_WORKER_NUMBER = "agent-worker-number"
ATTR_NETWORK_ENDPOINTS = "worker-network-endpoints"


@dataclasses.dataclass(frozen=True)
class PlatformCluster:
    hosts: HostList
    self_host: str
    self_index: int


def _metadata_fetcher(base: str = METADATA_BASE) -> Callable[[str], str]:
    def fetch(attr: str) -> str:
        req = urllib.request.Request(
            base + _ATTR + attr, headers={"Metadata-Flavor": "Google"}
        )
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.read().decode()

    return fetch


def from_tpu_env(environ=None, slots_per_host: int = 1) -> Optional[PlatformCluster]:
    """Parse the TPU VM worker env; None when not on a TPU VM.

    TPU_WORKER_HOSTNAMES is a comma-separated list ordered by worker id;
    TPU_WORKER_ID is this worker's index into it (the same contract
    jax's cloud_tpu_init consumes).
    """
    env = environ if environ is not None else os.environ
    hostnames = env.get(TPU_WORKER_HOSTNAMES, "")
    if not hostnames:
        return None
    names = [h.strip() for h in hostnames.split(",") if h.strip()]
    idx = int(env.get(TPU_WORKER_ID, "0") or 0)
    if not 0 <= idx < len(names):
        raise ValueError(
            f"{TPU_WORKER_ID}={idx} out of range for {len(names)} workers"
        )
    hosts = HostList(HostSpec(n, slots_per_host) for n in names)
    return PlatformCluster(hosts=hosts, self_host=names[idx], self_index=idx)


def from_gce_metadata(
    fetch: Optional[Callable[[str], str]] = None, slots_per_host: int = 1
) -> Optional[PlatformCluster]:
    """Parse the GCE metadata server's TPU attributes; None when absent.

    worker-network-endpoints is the TPU runtime's canned JSON-ish list:
    one ``ip:uid:port`` (or bare ip) entry per worker, comma-separated and
    ordered by worker number; agent-worker-number is this worker's index.
    """
    fetch = fetch or _metadata_fetcher()
    try:
        endpoints_raw = fetch(ATTR_NETWORK_ENDPOINTS)
        idx_raw = fetch(ATTR_WORKER_NUMBER)
    except (OSError, ValueError):
        return None
    ips = []
    for entry in endpoints_raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        # entry forms seen in the wild: "ip", "ip:port", "ip:uid:port"
        ips.append(entry.split(":")[0])
    if not ips:
        return None
    idx = int(idx_raw.strip())
    if not 0 <= idx < len(ips):
        raise ValueError(
            f"{ATTR_WORKER_NUMBER}={idx} out of range for {len(ips)} workers"
        )
    hosts = HostList(HostSpec(ip, slots_per_host) for ip in ips)
    return PlatformCluster(hosts=hosts, self_host=ips[idx], self_index=idx)


def detect(
    name: str = "auto",
    environ=None,
    fetch: Optional[Callable[[str], str]] = None,
    slots_per_host: int = 1,
) -> Optional[PlatformCluster]:
    """Resolve a platform adapter by name: 'tpu-vm' (env), 'gce'
    (metadata server), or 'auto' (env first, then metadata)."""
    if name in ("tpu-vm", "auto"):
        got = from_tpu_env(environ, slots_per_host)
        if got is not None or name == "tpu-vm":
            return got
    if name in ("gce", "auto"):
        return from_gce_metadata(fetch, slots_per_host)
    raise ValueError(f"unknown platform {name!r} (expected tpu-vm, gce, auto)")

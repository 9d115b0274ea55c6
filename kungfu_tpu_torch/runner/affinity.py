"""Worker CPU affinity: partition host CPUs across local workers.

Port of `kungfu_tpu/runner/affinity.py`, framework-free. Capability
parity: srcs/cpp/src/numa/placement.cpp:6-17 (select_cpus: partition the
host's CPU list evenly across local workers, NUMA-aware) + init.cpp:21-26
(enabled via KUNGFU_USE_AFFINITY). On a host running
several workers, unpinned input pipelines fight over cores; pinning gives
each worker a disjoint slice, aligned to NUMA nodes when the topology is
visible under /sys/devices/system/node.

Enabled with the kfrun ``-use-affinity`` flag; the runner sets each child's
mask right after spawn (os.sched_setaffinity on the child pid — inherited
by all of the worker's threads from then on).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence

NODE_DIR = "/sys/devices/system/node"


def parse_cpulist(text: str) -> List[int]:
    """Parse a kernel cpulist ("0-3,8,10-11") into sorted cpu ids."""
    cpus: List[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-")
            cpus.extend(range(int(lo), int(hi) + 1))
        else:
            cpus.append(int(part))
    return sorted(set(cpus))


def numa_nodes(node_dir: str = NODE_DIR) -> List[List[int]]:
    """CPU lists per NUMA node, or [] when the topology isn't exposed."""
    try:
        entries = sorted(
            e for e in os.listdir(node_dir) if re.fullmatch(r"node\d+", e)
        )
    except OSError:
        return []
    nodes = []
    for e in entries:
        try:
            with open(os.path.join(node_dir, e, "cpulist")) as f:
                cpus = parse_cpulist(f.read())
        except OSError:
            continue
        if cpus:
            nodes.append(cpus)
    return nodes


def partition(cpus: Sequence[int], n: int) -> List[List[int]]:
    """Split cpus into n disjoint, near-equal, contiguous slices."""
    cpus = list(cpus)
    q, r = divmod(len(cpus), n)
    out, begin = [], 0
    for i in range(n):
        end = begin + q + (1 if i < r else 0)
        out.append(cpus[begin:end])
        begin = end
    return out


def plan_affinity(
    n_workers: int,
    cpus: Optional[Sequence[int]] = None,
    nodes: Optional[List[List[int]]] = None,
) -> List[List[int]]:
    """Disjoint CPU sets, one per local worker.

    NUMA-aware: workers are spread across nodes round-robin, and each
    worker's slice stays inside one node whenever workers >= nodes (the
    reference's placement: a worker never straddles a socket). Without
    visible topology, an even split of the process's allowed CPUs."""
    if n_workers <= 0:
        return []
    if cpus is None:
        cpus = sorted(os.sched_getaffinity(0))
    if nodes is None:
        nodes = numa_nodes()
    allowed = set(cpus)
    nodes = [[c for c in node if c in allowed] for node in nodes]
    nodes = [n_ for n_ in nodes if n_]
    if len(nodes) <= 1 or n_workers < len(nodes):
        return partition(list(cpus), n_workers)
    # workers per node, then split each node's cpus among its workers
    per_node = partition(list(range(n_workers)), len(nodes))
    out: List[List[int]] = [[] for _ in range(n_workers)]
    for node_cpus, workers in zip(nodes, per_node):
        if not workers:
            continue
        for w, cpuset in zip(workers, partition(node_cpus, len(workers))):
            out[w] = cpuset
    return out


def apply_affinity(pid: int, cpus: Sequence[int]) -> bool:
    """Pin `pid` to `cpus`; best-effort (False when unsupported/denied)."""
    if not cpus:
        return False
    try:
        os.sched_setaffinity(pid, set(cpus))
        return True
    except (OSError, AttributeError):
        return False

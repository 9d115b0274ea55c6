from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.plan.graph import Graph
from kungfu_tpu_torch.plan.peer import PeerID, PeerList
from kungfu_tpu_torch.plan.hostspec import HostSpec, HostList, parse_hostfile

__all__ = [
    "Cluster",
    "Graph",
    "HostList",
    "HostSpec",
    "PeerID",
    "PeerList",
    "parse_hostfile",
]

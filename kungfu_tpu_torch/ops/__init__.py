"""Device ops: collectives, ring attention, MoE. The JAX package's
`kungfu_tpu/ops/__init__.py` list, for what the port has (the
hierarchical reducer waits for the host plane). The function
`flash_attention` is not re-exported: here the name would shadow the
submodule of that name, which the port's modules and tests import as
`from kungfu_tpu_torch.ops import flash_attention`."""

from kungfu_tpu_torch.ops.collective import (
    all_gather,
    all_reduce,
    broadcast,
    defuse,
    fuse,
    group_all_reduce,
    subset_all_reduce,
)
from kungfu_tpu_torch.ops.moe import moe_ffn, switch_moe
from kungfu_tpu_torch.ops.ring_attention import ring_self_attention

__all__ = [
    "all_gather",
    "all_reduce",
    "broadcast",
    "defuse",
    "fuse",
    "group_all_reduce",
    "subset_all_reduce",
    "ring_self_attention",
    "moe_ffn",
    "switch_moe",
]

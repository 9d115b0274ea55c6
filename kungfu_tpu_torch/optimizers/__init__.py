from kungfu_tpu_torch.optimizers.core import (
    adaptive_sgd,
    synchronous_averaging,
    synchronous_sgd,
    zero_sharded,
)

__all__ = [
    "adaptive_sgd",
    "synchronous_averaging",
    "synchronous_sgd",
    "zero_sharded",
]

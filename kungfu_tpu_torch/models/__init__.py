"""Models of the benchmark configs: the MNIST MLP, the transformer LM and
ResNet-50. The JAX package's `kungfu_tpu/models/__init__.py` list, for
what the port has (`MLP_PARITY_NOTE` is that package's prose)."""

from kungfu_tpu_torch.models.mlp import init_mlp, mlp_apply, mlp_loss
from kungfu_tpu_torch.models.transformer import (
    TransformerConfig,
    init_transformer,
    param_pspecs,
    transformer_apply,
    transformer_loss,
)

__all__ = [
    "TransformerConfig",
    "init_mlp",
    "init_transformer",
    "mlp_apply",
    "mlp_loss",
    "param_pspecs",
    "transformer_apply",
    "transformer_loss",
]

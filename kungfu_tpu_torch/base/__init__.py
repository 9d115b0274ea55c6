from kungfu_tpu_torch.base.dtype import DType
from kungfu_tpu_torch.base.ops import ReduceOp, transform2
from kungfu_tpu_torch.base.strategy import Strategy
from kungfu_tpu_torch.base.workspace import Workspace

__all__ = ["DType", "ReduceOp", "Strategy", "Workspace", "transform2"]

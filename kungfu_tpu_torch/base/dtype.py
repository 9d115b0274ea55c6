"""Element dtypes shared by host-side buffers and device tensors.

Port of `kungfu_tpu/base/dtype.py` (parity: the reference's dtype enum
mirrored between Go and C, srcs/go/kungfu/base/dtype.go:8-22). The codes
are the ones the host C++ (`csrc/host/reduce.cpp`) dispatches on. BF16 is
`torch.bfloat16`: the port needs no `ml_dtypes`, so `to_numpy` raises for
BF16, as the reference does where `ml_dtypes` is absent.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class DType(enum.IntEnum):
    U8 = 1
    I8 = 2
    I16 = 3
    I32 = 4
    I64 = 5
    U16 = 6
    U32 = 7
    U64 = 8
    F16 = 9
    BF16 = 10
    F32 = 11
    F64 = 12

    @property
    def size(self) -> int:
        """Size in bytes of one element."""
        return _SIZES[self]

    def to_torch(self) -> torch.dtype:
        return _TORCH[self]

    @classmethod
    def from_torch(cls, dt: torch.dtype) -> "DType":
        try:
            return _FROM_TORCH[dt]
        except KeyError:
            raise ValueError(f"unsupported dtype: {dt}") from None

    def to_numpy(self) -> np.dtype:
        if self == DType.BF16:
            raise ValueError(f"{self.name} requires ml_dtypes")
        return np.dtype(str(self.to_torch()).removeprefix("torch."))

    @classmethod
    def from_numpy(cls, dt) -> "DType":
        dt = np.dtype(dt)
        try:
            return _FROM_TORCH[getattr(torch, dt.name)]
        except (AttributeError, KeyError):
            raise ValueError(f"unsupported dtype: {dt}") from None


_SIZES = {
    DType.U8: 1,
    DType.I8: 1,
    DType.I16: 2,
    DType.I32: 4,
    DType.I64: 8,
    DType.U16: 2,
    DType.U32: 4,
    DType.U64: 8,
    DType.F16: 2,
    DType.BF16: 2,
    DType.F32: 4,
    DType.F64: 8,
}

_TORCH = {
    DType.U8: torch.uint8,
    DType.I8: torch.int8,
    DType.I16: torch.int16,
    DType.I32: torch.int32,
    DType.I64: torch.int64,
    DType.U16: torch.uint16,
    DType.U32: torch.uint32,
    DType.U64: torch.uint64,
    DType.F16: torch.float16,
    DType.BF16: torch.bfloat16,
    DType.F32: torch.float32,
    DType.F64: torch.float64,
}

_FROM_TORCH = {v: k for k, v in _TORCH.items()}

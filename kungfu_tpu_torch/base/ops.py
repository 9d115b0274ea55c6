"""Reduce operations (own copy of `kungfu_tpu/base/ops.py::ReduceOp`)."""

from __future__ import annotations

import enum


class ReduceOp(enum.IntEnum):
    SUM = 0
    MIN = 1
    MAX = 2
    PROD = 3

"""Stateful scalar helpers: Counter and ExponentialMovingAverage.

Port of `kungfu_tpu/utils/state.py` (parity:
srcs/cpp/src/tensorflow/ops/cpu/state.cpp:6-46, a step counter that
increments per call and an EMA accumulator used by adaptation policies):
host-side classes for control-plane code (schedules, policies, adaptive
monitors).
"""

from __future__ import annotations

import threading
from typing import Optional


class Counter:
    """Monotone step counter (parity: Counter op, state.cpp:6-24).

    Like the reference op, the first call returns 0 ("incremented after
    read"): c() -> 0, 1, 2, ...
    """

    def __init__(self, init: int = 0):
        self._lock = threading.Lock()
        self._value = init

    def __call__(self) -> int:
        with self._lock:
            v = self._value
            self._value += 1
            return v

    @property
    def value(self) -> int:
        """Current count without incrementing."""
        with self._lock:
            return self._value


class ExponentialMovingAverage:
    """EMA accumulator (parity: ExponentialMovingAverage op,
    state.cpp:26-46 + utils/ema.hpp): the first sample seeds the average,
    later samples blend with weight `alpha`."""

    def __init__(self, alpha: float):
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self._lock = threading.Lock()
        self._value: Optional[float] = None

    def update(self, sample: float) -> float:
        with self._lock:
            if self._value is None:
                self._value = float(sample)
            else:
                self._value = self.alpha * float(sample) + (1 - self.alpha) * self._value
            return self._value

    @property
    def value(self) -> float:
        with self._lock:
            return 0.0 if self._value is None else self._value

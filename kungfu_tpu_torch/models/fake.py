"""Fake models: gradient-size lists for communication benchmarks.

Port of `kungfu_tpu/models/fake.py` (parity:
tests/go/fakemodel/fakemodel.go:12-27 and the C++ twins
tests/cpp/integration/{resnet50_info,vgg_info,bert}.hpp): a model's
gradient exchange with no real math, so collective paths can be tested
and benchmarked without an ML workload. The buffers are numpy arrays
drawn by numpy's `default_rng`, so a name and a seed give the JAX
package's bits; the benches wrap them with `torch.from_numpy`.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# Parameter-tensor sizes (elements) representative of each model's gradient
# set; same role as the reference's size lists.
FAKE_MODELS: Dict[str, List[int]] = {
    "tiny": [1, 10, 100],
    "slp-mnist": [784 * 10, 10],
    "resnet50-imagenet": (
        [64 * 3 * 7 * 7]
        + [256 * 64, 64 * 64 * 9, 64 * 256] * 3
        + [512 * 128, 128 * 128 * 9, 128 * 512] * 4
        + [1024 * 256, 256 * 256 * 9, 256 * 1024] * 6
        + [2048 * 512, 512 * 512 * 9, 512 * 2048] * 3
        + [2048 * 1000, 1000]
    ),
    "vgg16-imagenet": [
        64 * 3 * 9, 64 * 64 * 9,
        128 * 64 * 9, 128 * 128 * 9,
        256 * 128 * 9, 256 * 256 * 9, 256 * 256 * 9,
        512 * 256 * 9, 512 * 512 * 9, 512 * 512 * 9,
        512 * 512 * 9, 512 * 512 * 9, 512 * 512 * 9,
        25088 * 4096, 4096 * 4096, 4096 * 1000,
    ],
    "bert": [1024 * 1024] * 24 * 6 + [30522 * 1024, 512 * 1024],
    # 4 MiB in one tensor, sized for shaped-link benches: big enough that
    # per-segment sends clear the link plane's bandwidth gate at k <= 32,
    # small enough that a 16 MiB/s shaped edge stays affordable
    "mlp-4mib": [1 << 20],
}


def fake_gradients(name: str, dtype=np.float32, seed: int = 0) -> List[np.ndarray]:
    """Materialize double buffers for a named fake model."""
    sizes = FAKE_MODELS[name]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in sizes]


def total_size_bytes(name: str, dtype=np.float32) -> int:
    return sum(FAKE_MODELS[name]) * np.dtype(dtype).itemsize

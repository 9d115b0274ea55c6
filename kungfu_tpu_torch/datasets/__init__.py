"""MNIST loader on idx files already on disk. The port's own copy of
`kungfu_tpu/datasets/__init__.py::load_mnist` (framework-free there too,
but the port imports nothing of the JAX package)."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from kungfu_tpu_torch.datasets.idx import read_idx

__all__ = ["read_idx", "load_mnist"]

_MNIST_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def _find(data_dir: str, base: str) -> Optional[str]:
    for name in (base, base + ".gz"):
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            return p
    return None


def load_mnist(data_dir: str, normalize: bool = True) -> Dict[str, np.ndarray]:
    """Load the 4 standard MNIST idx files from `data_dir` (gz ok).

    Returns {train_images (N, 784) f32, train_labels (N,) i32, test_images,
    test_labels}; images scaled to [0, 1] when `normalize`."""
    out: Dict[str, np.ndarray] = {}
    for key, base in _MNIST_FILES.items():
        path = _find(data_dir, base)
        if path is None:
            raise FileNotFoundError(f"{data_dir}: missing {base}[.gz]")
        arr = read_idx(path)
        if "images" in key:
            arr = arr.reshape(arr.shape[0], -1).astype(np.float32)
            if normalize:
                arr /= 255.0
        else:
            arr = arr.astype(np.int32)
        out[key] = arr
    return out

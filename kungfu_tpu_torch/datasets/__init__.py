"""Loaders for files already on disk: MNIST idx files, CIFAR-10 and
generic npz. The port's own copy of `kungfu_tpu/datasets/__init__.py`
(framework-free there too, but the port imports nothing of the JAX
package)."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from kungfu_tpu_torch.datasets.idx import read_idx, write_idx

__all__ = ["read_idx", "write_idx", "load_mnist", "load_cifar10", "load_npz"]

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


def load_cifar10(data_dir: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """CIFAR-10 from `data_dir`: a combined `cifar10.npz` (train_x,
    train_y, test_x, test_y) if there is one, else the python-version
    pickle batches (`data_batch_1`..`5`, `test_batch`) of a trusted
    download. Returns (train_x (N, 32, 32, 3) f32 in [0, 1], train_y i32,
    test_x, test_y)."""
    npz = os.path.join(data_dir, "cifar10.npz")
    if os.path.exists(npz):
        d = np.load(npz)
        return (d["train_x"].astype(np.float32), d["train_y"].astype(np.int32),
                d["test_x"].astype(np.float32), d["test_y"].astype(np.int32))
    import pickle

    def read_batch(name):
        with open(os.path.join(data_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32) / 255.0, np.asarray(d[b"labels"], np.int32)

    xs, ys = zip(*(read_batch(f"data_batch_{i}") for i in range(1, 6)))
    tx, ty = read_batch("test_batch")
    return np.concatenate(xs), np.concatenate(ys), tx, ty


def load_npz(path: str, x_key: str = "x", y_key: str = "y") -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) arrays of an npz file of a custom dataset."""
    d = np.load(path)
    return np.asarray(d[x_key]), np.asarray(d[y_key])

"""IDX file reader (the MNIST container), gzip-transparent. The port's own
copy of `kungfu_tpu/datasets/idx.py::read_idx`. Format: magic
``\\x00\\x00<dtype><ndim>``, big-endian uint32 dims, then row-major data.
"""

from __future__ import annotations

import gzip
import struct
from typing import BinaryIO

import numpy as np

# idx type code -> numpy dtype (big-endian where multi-byte)
_IDX_DTYPES = {
    0x08: np.dtype(np.uint8),
    0x09: np.dtype(np.int8),
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def _open(path: str, mode: str) -> BinaryIO:
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_idx(path: str) -> np.ndarray:
    """Read an idx(.gz) file into a native-endian array."""
    with _open(path, "rb") as f:
        magic = f.read(4)
        if len(magic) != 4 or magic[0] != 0 or magic[1] != 0:
            raise ValueError(f"{path}: not an idx file (magic {magic!r})")
        dtype_code, ndim = magic[2], magic[3]
        if dtype_code not in _IDX_DTYPES:
            raise ValueError(f"{path}: unknown idx dtype {dtype_code:#x}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        dt = _IDX_DTYPES[dtype_code]
        data = f.read()
        count = int(np.prod(dims)) if dims else 1
        if len(data) < count * dt.itemsize:
            raise ValueError(
                f"{path}: truncated (need {count * dt.itemsize} bytes, "
                f"have {len(data)})"
            )
        arr = np.frombuffer(data, dt, count=count).reshape(dims)
        return arr.astype(arr.dtype.newbyteorder("="))

"""IDX file reader and writer (the MNIST container), gzip-transparent. The
port's own copy of `kungfu_tpu/datasets/idx.py`. Format: magic
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

_DTYPE_CODES = {dt.newbyteorder("="): code for code, dt in _IDX_DTYPES.items()}


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


def write_idx(path: str, arr: np.ndarray) -> None:
    """Write an array as idx(.gz); the inverse of `read_idx`."""
    dt = np.dtype(arr.dtype.newbyteorder("="))
    if dt not in _DTYPE_CODES:
        raise ValueError(f"idx cannot store dtype {arr.dtype}")
    with _open(path, "wb") as f:
        f.write(bytes([0, 0, _DTYPE_CODES[dt], arr.ndim]))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        be = arr.astype(arr.dtype.newbyteorder(">"), copy=False)
        f.write(np.ascontiguousarray(be).tobytes())

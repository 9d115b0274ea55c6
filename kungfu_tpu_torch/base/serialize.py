"""Dtype-preserving tensor serialization for host-plane exchange.

Port of `kungfu_tpu/base/serialize.py`, used by elastic state re-sync and
the PairAveraging p2p model blobs. The wire format is a JSON header of
(dtype, shape) per leaf followed by each leaf's raw bytes. For the same
values the bytes equal the reference's: dtype names are numpy's and
ml_dtypes' ("float32", "bfloat16"), which are torch's without the
"torch." prefix, so no ml_dtypes is needed to name or resolve them.
"""

from __future__ import annotations

import json
import math
import struct

import torch


def dtype_name(dt: torch.dtype) -> str:
    """The numpy (or ml_dtypes) name of a torch dtype: "float32", "bfloat16"."""
    return str(dt).removeprefix("torch.")


def resolve_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy or ml_dtypes dtype name."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unsupported dtype name: {name!r}")
    return dt


def pack_leaves(leaves) -> bytes:
    """Serialize a list of tensors as raw bytes + explicit dtype/shape
    (leaves on a card are copied to the host first)."""
    ts = [torch.as_tensor(l).detach().cpu().contiguous() for l in leaves]
    meta = json.dumps(
        [{"dtype": dtype_name(t.dtype), "shape": list(t.shape)} for t in ts]
    ).encode()
    parts = [struct.pack("<Q", len(meta)), meta]
    for t in ts:
        parts.append(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return b"".join(parts)


def unpack_leaves(blob: bytes, n: int):
    """Inverse of pack_leaves; validates the leaf count. The tensors share
    one writable copy of the blob."""
    (meta_len,) = struct.unpack_from("<Q", blob, 0)
    meta = json.loads(blob[8 : 8 + meta_len].decode())
    if len(meta) != n:
        raise ValueError(f"leaf unpack: expected {n} leaves, got {len(meta)}")
    buf = bytearray(blob)
    out, off = [], 8 + meta_len
    for m in meta:
        dt = resolve_dtype(m["dtype"])
        count = math.prod(m["shape"])
        nbytes = count * dt.itemsize
        if count:
            t = torch.frombuffer(buf, dtype=dt, count=count, offset=off)
        else:
            t = torch.empty(0, dtype=dt)
        out.append(t.reshape(m["shape"]))
        off += nbytes
    return out

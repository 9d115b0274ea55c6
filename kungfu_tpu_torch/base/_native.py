"""ctypes binding of the port's host C++ (`csrc/host/reduce.cpp`,
`csrc/host/mst.cpp`, and the socket pump of `csrc/host/io_pump.cpp`,
which `transport/_native_io.py` calls).

Port of `kungfu_tpu/base/_native_reduce.py`. The library is built with
the host C++ compiler at first use (`ops/_build.py`,
`compile_host_library`) into `build/kungfu_tpu_torch/`, and loaded once
per process. There is no fallback: a library that cannot be built raises
`RuntimeError` naming the compiler and its error.

The functions here take torch tensors on the CPU (pinned or not), one
dimensional and contiguous, and pass their `data_ptr()`; they check
nothing else, which `base/ops.py` does before calling. ctypes releases
the interpreter lock for the call, so pool threads reduce disjoint
segments at once. `CALLS` counts the calls into the library by function.
"""

from __future__ import annotations

import ctypes
import threading

import torch

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64

_SIGNATURES = {
    "kf_transform2": [_P, _P, _P, _I64, _I32, _I32],
    "kf_transform_n": [_P, ctypes.POINTER(_P), _I32, _I64, _I32, _I32],
    "kf_encode_wire": [_P, _P, _I64, _I32],
    "kf_decode_wire": [_P, _P, _I64, _I32],
    "kf_decode_accumulate": [_P, _P, _I64, _I32, _I32],
    "kf_encode_wire_q": [_P, _P, _I64, _I32, _I32],
    "kf_decode_wire_q": [_P, _P, _I64, _I32, _I32],
    "kf_decode_accumulate_q": [_P, _P, _I64, _I32, _I32, _I32],
    "kf_mst": [_I64, _P, _P],
    "kf_send2": [ctypes.c_int, _P, _I64, _P, _I64, ctypes.c_int],
    "kf_recv_exact": [ctypes.c_int, _P, _I64, ctypes.c_int],
}

CALLS = {name.removeprefix("kf_"): 0 for name in _SIGNATURES}

_lib = None
_lock = threading.Lock()
_calls_lock = threading.Lock()  # pool threads call at once


def reset_calls() -> None:
    with _calls_lock:
        for key in CALLS:
            CALLS[key] = 0


def _count(name: str) -> None:
    with _calls_lock:
        CALLS[name] += 1


def lib() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            from kungfu_tpu_torch.ops import _build

            loaded = ctypes.CDLL(str(_build.compile_host_library()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _lib = loaded
        return _lib


def _ptr(t: torch.Tensor) -> int:
    if t.device.type != "cpu":
        raise ValueError(f"the host library takes CPU tensors, got one on {t.device}")
    if not t.is_contiguous():
        raise ValueError("non-contiguous buffer")
    return t.data_ptr()


def _call(name: str, *args) -> None:
    rc = getattr(lib(), f"kf_{name}")(*args)
    _count(name)
    if rc != 0:
        raise ValueError(f"native {name} returned {rc}: unsupported dtype, wire or op code")


def transform2(dst: torch.Tensor, x: torch.Tensor, y: torch.Tensor, dtype: int,
               op: int) -> None:
    _call("transform2", _ptr(dst), _ptr(x), _ptr(y), dst.numel(), dtype, op)


def transform_n(dst: torch.Tensor, srcs, dtype: int, op: int) -> None:
    """dst = srcs[0] op srcs[1] op ... in ONE pass; dst must not alias any
    src (kf_transform_n)."""
    ptrs = (_P * len(srcs))(*[_ptr(s) for s in srcs])
    _call("transform_n", _ptr(dst), ptrs, len(srcs), dst.numel(), dtype, op)


def encode_wire(dst: torch.Tensor, src: torch.Tensor, wire: int) -> None:
    _call("encode_wire", _ptr(dst), _ptr(src), src.numel(), wire)


def decode_wire(dst: torch.Tensor, src: torch.Tensor, wire: int) -> None:
    _call("decode_wire", _ptr(dst), _ptr(src), src.numel(), wire)


def decode_accumulate(acc: torch.Tensor, src: torch.Tensor, wire: int, op: int) -> None:
    _call("decode_accumulate", _ptr(acc), _ptr(src), acc.numel(), wire, op)


def encode_wire_q(dst: torch.Tensor, src: torch.Tensor, bits: int, block: int) -> None:
    _call("encode_wire_q", _ptr(dst), _ptr(src), src.numel(), bits, block)


def decode_wire_q(dst: torch.Tensor, src: torch.Tensor, bits: int, block: int) -> None:
    _call("decode_wire_q", _ptr(dst), _ptr(src), dst.numel(), bits, block)


def decode_accumulate_q(acc: torch.Tensor, src: torch.Tensor, bits: int, block: int,
                        op: int) -> None:
    _call("decode_accumulate_q", _ptr(acc), _ptr(src), acc.numel(), bits, block, op)


def mst(weights: torch.Tensor, father: torch.Tensor) -> int:
    """Prim's MST of the n x n f64 `weights` into the int32 `father`;
    returns kf_mst's code (0 ok, 2 disconnected)."""
    rc = lib().kf_mst(father.numel(), _ptr(weights), _ptr(father))
    _count("mst")
    return rc

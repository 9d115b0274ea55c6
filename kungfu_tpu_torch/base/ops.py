"""Host-side reduction and the host plane's wire codec, on torch CPU
tensors.

Port of `kungfu_tpu/base/ops.py` (parity: the reference's ``Transform2``
SIMD reduce, srcs/go/kungfu/base/op.go:25-36, with F16C for f16). Every
reduce and codec function here runs in the port's host C++
(`csrc/host/reduce.cpp`, through `base/_native.py`), as the JAX
package's engine does when its `libkfnative.so` is built; `copy_segment`
is a plain copy, as the reference's is. There is no fallback: where the
library cannot be built, the first call raises RuntimeError.

Buffers are one-dimensional contiguous torch tensors on the CPU, pinned
where they stage a CUDA tensor (the caller synchronizes a non_blocking
copy before handing the buffer here). 16-bit wire buffers hold 2-byte
elements (`torch.uint16` as the reference's `np.uint16`); block-scaled
wire buffers are bytes (`torch.uint8`).

Beside each function is its plain PyTorch twin (`transform2_plain`,
`encode_wire_plain`, `encode_wire_q_plain`, ...), which computes the same
bits as the C++ with torch ops: the tests' oracle and chip_smoke's, never
called on the path. Where the C++ and numpy differ, the twins follow the
C++: MIN/MAX are ``a < b ? a : b`` and ``a > b ? a : b`` (a NaN in ``a``
yields ``b``; numpy's minimum propagates either NaN), and transform2's
f16 stores round half away from zero (reduce.cpp's ``float_to_half``),
while the wire codec's rounds to nearest-even.
"""

from __future__ import annotations

import enum
from typing import Sequence

import torch

from kungfu_tpu_torch.base import _native
from kungfu_tpu_torch.base.dtype import DType


class ReduceOp(enum.IntEnum):
    SUM = 0
    MIN = 1
    MAX = 2
    PROD = 3


def _check_flat(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dim() != 1:
            raise ValueError(f"host buffers are one-dimensional, got shape {tuple(t.shape)}")


def _check_same(dst: torch.Tensor, *srcs: torch.Tensor) -> None:
    _check_flat(dst, *srcs)
    for s in srcs:
        if s.dtype != dst.dtype or s.numel() != dst.numel():
            raise ValueError(f"buffer mismatch: {s.numel()} {s.dtype} against "
                             f"{dst.numel()} {dst.dtype}")


def transform2(dst: torch.Tensor, x: torch.Tensor, y: torch.Tensor, op: ReduceOp) -> None:
    """dst = x `op` y, elementwise; dst may alias x or y.

    All three must be 1-D buffers of equal length and dtype."""
    _check_same(dst, x, y)
    _native.transform2(dst, x, y, int(DType.from_torch(dst.dtype)), int(op))


def reduce_inplace(acc: torch.Tensor, incoming: torch.Tensor, op: ReduceOp) -> None:
    """acc = acc `op` incoming."""
    transform2(acc, acc, incoming, op)


def _check_bounds(buf: torch.Tensor, begin: int, end: int) -> None:
    if not 0 <= begin <= end <= buf.numel():
        raise ValueError(
            f"segment [{begin}:{end}) outside buffer of {buf.numel()} elements"
        )


def _check_segment(buf: torch.Tensor, begin: int, end: int,
                   incoming: torch.Tensor) -> None:
    """Segment-bounds contract of the ring walks and the sharded update:
    [begin, end) must lie inside the buffer and `incoming` must carry
    exactly end-begin elements. The C++ takes raw pointers and does not
    shape-check, so a shard-layout drift between sender and receiver must
    fail HERE, loudly — not corrupt adjacent segments silently."""
    _check_bounds(buf, begin, end)
    if incoming.numel() != end - begin:
        raise ValueError(
            f"segment payload mismatch: got {incoming.numel()} elements for "
            f"segment [{begin}:{end}) of {end - begin} — sender and "
            "receiver partitioned the payload differently"
        )


def reduce_segment(acc: torch.Tensor, begin: int, end: int, incoming: torch.Tensor,
                   op: ReduceOp) -> None:
    """acc[begin:end] = acc[begin:end] `op` incoming, in place (a view of
    the segment, no staging copy)."""
    _check_segment(acc, begin, end, incoming)
    seg = acc[begin:end]
    transform2(seg, seg, incoming, op)


def copy_segment(dst: torch.Tensor, begin: int, end: int, incoming: torch.Tensor) -> None:
    """dst[begin:end] = incoming (all-gather phase: overwrite, no reduce)."""
    _check_segment(dst, begin, end, incoming)
    dst[begin:end].copy_(incoming)


# ---------------------------------------------------------------------------
# wire codec: f32 payloads travel the host plane as bf16/f16
# ---------------------------------------------------------------------------
#
# The collective engine encodes f32 workspaces to a 2-byte wire dtype
# before the transport and accumulates every incoming segment into the
# f32 buffer (fused decode+reduce), so each transmitted value is
# quantized exactly once and no rounding ever happens in 16-bit storage.
# Both encoders round to nearest-even (bf16 by the integer fold, f16 by
# F16C where the CPU has it).

WIRE_DTYPES = (DType.BF16, DType.F16)


def _check_wire(wire) -> None:
    if wire not in WIRE_DTYPES:
        raise ValueError(f"unsupported wire dtype: {wire!r}")


def _check_codec(f32: torch.Tensor, enc: torch.Tensor) -> None:
    _check_flat(f32, enc)
    if f32.dtype != torch.float32:
        raise ValueError(f"the wire codec encodes float32, got {f32.dtype}")
    if enc.element_size() != 2 or enc.numel() != f32.numel():
        raise ValueError(f"wire buffer mismatch: {enc.numel()} {enc.dtype} for "
                         f"{f32.numel()} float32 (want as many 2-byte elements)")


def encode_wire(dst: torch.Tensor, src: torch.Tensor, wire: DType) -> None:
    """dst_u16 = encode(src_f32): round-to-nearest-even narrowing to the
    wire dtype. dst holds 2-byte elements, as many as src."""
    _check_wire(wire)
    _check_codec(src, dst)
    _native.encode_wire(dst, src, int(wire))


def decode_wire(dst: torch.Tensor, src: torch.Tensor, wire: DType) -> None:
    """dst_f32 = decode(src_u16): exact widening from the wire dtype."""
    _check_wire(wire)
    _check_codec(dst, src)
    _native.decode_wire(dst, src, int(wire))


def decode_accumulate(acc: torch.Tensor, begin: int, end: int, src: torch.Tensor,
                      wire: DType, op: ReduceOp) -> None:
    """acc[begin:end] = acc[begin:end] `op` decode(src), in f32, in one
    fused pass over the segment (the per-step hot path of the compressed
    ring walk)."""
    _check_wire(wire)
    _check_segment(acc, begin, end, src)
    seg = acc[begin:end]
    _check_codec(seg, src)
    _native.decode_accumulate(seg, src, int(wire), int(op))


# ---------------------------------------------------------------------------
# block-scaled int8/int4 wire codec
# ---------------------------------------------------------------------------
#
# Each `block`-element run of the f32 payload is scaled by one f32
# power-of-two s = 2^ceil(log2(absmax / Qmax)) and quantized to
# q = clamp(rne(x / s), -Qmax, Qmax) with Qmax = 127 (int8) / 7 (int4) —
# the encoded segment is [ceil(n/block) f32 scales][packed payload], int4
# low nibble first. The pow2 scale makes decode (s * q) EXACT in f32 and
# re-encoding a decoded block reproduce the identical bytes, which keeps
# relays and the broadcast root bit-identical across peers.


class QWire:
    """Wire spec for the block-scaled low-bit codec.

    Stands in for a ``DType`` in the walk layer's ``wire`` parameter:
    ``.name`` lowercases to the codec label ("int8"/"int4") like
    ``DType.BF16.name``; payload sizes come from :func:`wire_nbytes`.
    """

    __slots__ = ("bits", "block", "name")

    def __init__(self, bits: int, block: int = 16):
        if bits not in (8, 4):
            raise ValueError(f"unsupported wire bits: {bits!r}")
        if block < 1:
            raise ValueError(f"wire block must be >= 1: {block!r}")
        self.bits = int(bits)
        self.block = int(block)
        self.name = f"INT{bits}"

    def __repr__(self) -> str:
        return f"QWire(bits={self.bits}, block={self.block})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, QWire)
            and self.bits == other.bits
            and self.block == other.block
        )

    def __hash__(self) -> int:
        return hash((QWire, self.bits, self.block))


def wire_nbytes_q(count: int, bits: int, block: int) -> int:
    """Encoded byte length of `count` f32 elements under the block-scaled
    layout: 4 bytes of scale per block + 1 byte (int8) or a nibble
    (int4, odd counts round up) per element."""
    nb = (count + block - 1) // block
    return 4 * nb + (count if bits == 8 else (count + 1) // 2)


def wire_nbytes(count: int, wire) -> int:
    """Encoded byte length of `count` f32 elements under any wire spec —
    2 bytes/element for the 16-bit dtypes, the block-scaled layout for
    :class:`QWire`."""
    if isinstance(wire, QWire):
        return wire_nbytes_q(count, wire.bits, wire.block)
    return 2 * count


def _check_codec_q(f32: torch.Tensor, enc: torch.Tensor, wire: QWire, what: str) -> None:
    _check_flat(f32, enc)
    if f32.dtype != torch.float32:
        raise ValueError(f"the wire codec encodes float32, got {f32.dtype}")
    want = wire_nbytes(f32.numel(), wire)
    if enc.element_size() != 1 or enc.numel() != want:
        raise ValueError(
            f"{what} mismatch: {enc.numel() * enc.element_size()} bytes for "
            f"{f32.numel()} elements of {wire!r} (want {want})"
        )


def encode_wire_q(dst: torch.Tensor, src: torch.Tensor, wire: QWire) -> None:
    """dst_u8 = [block scales][packed payload] of src_f32. dst must hold
    exactly ``wire_nbytes(src.numel(), wire)`` bytes."""
    _check_codec_q(src, dst, wire, "encoded buffer")
    _native.encode_wire_q(dst, src, wire.bits, wire.block)


def decode_wire_q(dst: torch.Tensor, src: torch.Tensor, wire: QWire) -> None:
    """dst_f32 = decode(src_u8); element count comes from dst. Exact:
    every decoded value is a pow2 scale times a small integer."""
    _check_codec_q(dst, src, wire, "encoded payload")
    _native.decode_wire_q(dst, src, wire.bits, wire.block)


def decode_accumulate_q(acc: torch.Tensor, begin: int, end: int, src: torch.Tensor,
                        wire: QWire, op: ReduceOp) -> None:
    """acc[begin:end] = acc[begin:end] `op` decode(src), in f32 — the
    fused per-step hot path of the quantized ring walk."""
    _check_bounds(acc, begin, end)
    seg = acc[begin:end]
    _check_codec_q(seg, src, wire, "encoded payload")
    _native.decode_accumulate_q(seg, src, wire.bits, wire.block, int(op))


def encode_wire_any(dst: torch.Tensor, src: torch.Tensor, wire) -> None:
    """Encode under any wire spec (DType or QWire)."""
    if isinstance(wire, QWire):
        encode_wire_q(dst, src, wire)
    else:
        encode_wire(dst, src, wire)


def decode_wire_any(dst: torch.Tensor, src: torch.Tensor, wire) -> None:
    """Decode under any wire spec (DType or QWire)."""
    if isinstance(wire, QWire):
        decode_wire_q(dst, src, wire)
    else:
        decode_wire(dst, src, wire)


def decode_accumulate_any(acc: torch.Tensor, begin: int, end: int, src: torch.Tensor,
                          wire, op: ReduceOp) -> None:
    """Fused decode+reduce under any wire spec (DType or QWire)."""
    if isinstance(wire, QWire):
        decode_accumulate_q(acc, begin, end, src, wire, op)
    else:
        decode_accumulate(acc, begin, end, src, wire, op)


def transform_n(dst: torch.Tensor, srcs: Sequence[torch.Tensor], op: ReduceOp) -> None:
    """dst = srcs[0] op srcs[1] op ... op srcs[k-1] in ONE memory pass;
    dst must not alias any src. The k-1 pairwise equivalent re-reads and
    re-writes dst k-2 extra times — at a STAR root this n-ary form is the
    difference between ~5 and ~2k passes over the payload. 16-bit floats
    accumulate in f32 and round once."""
    _check_same(dst, *srcs)
    if len(srcs) == 1:
        dst.copy_(srcs[0])
        return
    _native.transform_n(dst, srcs, int(DType.from_torch(dst.dtype)), int(op))


# ---------------------------------------------------------------------------
# plain PyTorch twins: the same bits as the C++, by torch ops
# ---------------------------------------------------------------------------
#
# Torch on the CPU has no add, minimum, maximum or lt for uint16/32/64, so
# the twins reach them through the signed view of the same width: wrapping
# SUM and PROD give the same bits signed or not, and MIN/MAX compare a key
# that orders the bits as unsigned (widened to int64, or the sign bit
# flipped for 64 bits).

_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}
_HALF = (torch.float16, torch.bfloat16)


def _unsigned_key(s: torch.Tensor) -> torch.Tensor:
    if s.dtype == torch.int64:
        return s ^ torch.iinfo(torch.int64).min
    return s.to(torch.int64) & ((1 << (8 * s.element_size())) - 1)


def _combine(a: torch.Tensor, b: torch.Tensor, op: ReduceOp) -> torch.Tensor:
    """a `op` b in a's dtype, as reduce.cpp's lambdas compute it (16-bit
    floats are widened by the callers)."""
    if a.dtype in _SIGNED:
        sa, sb = a.view(_SIGNED[a.dtype]), b.view(_SIGNED[a.dtype])
        if op in (ReduceOp.SUM, ReduceOp.PROD):
            return _combine(sa, sb, op).view(a.dtype)
        ka, kb = _unsigned_key(sa), _unsigned_key(sb)
        return torch.where(ka < kb if op == ReduceOp.MIN else ka > kb, sa, sb).view(a.dtype)
    if op == ReduceOp.SUM:
        return a + b
    if op == ReduceOp.PROD:
        return a * b
    if op == ReduceOp.MIN:
        return torch.where(a < b, a, b)
    if op == ReduceOp.MAX:
        return torch.where(a > b, a, b)
    raise ValueError(f"unsupported op: {op!r}")


def _bits32(f: torch.Tensor) -> torch.Tensor:
    """The bits of f32 `f` as non-negative int64."""
    return f.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _f16_bits_half_up(f: torch.Tensor) -> torch.Tensor:
    """reduce.cpp's `float_to_half` (transform2's f16 store: round half
    away from zero, NaN to a quiet NaN) as int16 bits."""
    bits = _bits32(f)
    sign = (bits >> 16) & 0x8000
    e8 = (bits >> 23) & 0xFF
    exp = e8 - 127 + 15
    man = bits & 0x7FFFFF
    big = sign | 0x7C00 | torch.where((e8 == 0xFF) & (man != 0), 0x200, 0)
    m1 = man | 0x800000
    shift = (14 - exp).clamp(1, 40)
    sub = (sign | (m1 >> shift)) + ((m1 >> (shift - 1)) & 1)
    sub = torch.where(exp < -10, sign, sub)
    norm = (sign | (exp.clamp(0, 30) << 10) | (man >> 13)) + ((man >> 12) & 1)
    out = torch.where(exp >= 0x1F, big, torch.where(exp <= 0, sub, norm))
    return (out & 0xFFFF).to(torch.int16)


def _bf16_bits_rne(f: torch.Tensor) -> torch.Tensor:
    """reduce.cpp's `float_to_bf16`: (bits + 0x7fff + lsb) >> 16, as int16."""
    bits = _bits32(f)
    return (((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) & 0xFFFF).to(torch.int16)


def _store_half(f: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float16:
        return _f16_bits_half_up(f).view(torch.float16)
    return _bf16_bits_rne(f).view(torch.bfloat16)


def transform2_plain(dst: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     op: ReduceOp) -> None:
    """Plain twin of :func:`transform2`."""
    _check_same(dst, x, y)
    if dst.dtype in _HALF:
        dst.copy_(_store_half(_combine(x.float(), y.float(), op), dst.dtype))
    else:
        dst.copy_(_combine(x, y, op))


def transform_n_plain(dst: torch.Tensor, srcs: Sequence[torch.Tensor], op: ReduceOp) -> None:
    """Plain twin of :func:`transform_n`."""
    _check_same(dst, *srcs)
    half = dst.dtype in _HALF
    acc = srcs[0].float() if half else srcs[0].clone()
    for s in srcs[1:]:
        acc = _combine(acc, s.float() if half else s, op)
    dst.copy_(_store_half(acc, dst.dtype) if half and len(srcs) > 1 else acc)


def reduce_segment_plain(acc: torch.Tensor, begin: int, end: int, incoming: torch.Tensor,
                         op: ReduceOp) -> None:
    """Plain twin of :func:`reduce_segment`."""
    _check_segment(acc, begin, end, incoming)
    seg = acc[begin:end]
    transform2_plain(seg, seg, incoming, op)


def encode_wire_plain(dst: torch.Tensor, src: torch.Tensor, wire: DType) -> None:
    """Plain twin of :func:`encode_wire`: the bf16 integer fold; f16 by
    torch's own round-to-nearest-even conversion."""
    _check_wire(wire)
    _check_codec(src, dst)
    if wire == DType.F16:
        bits = src.to(torch.float16).view(torch.int16)
    else:
        bits = _bf16_bits_rne(src)
    dst.view(torch.int16).copy_(bits)


def _decode16(src: torch.Tensor, wire: DType) -> torch.Tensor:
    s = src.view(torch.int16)
    if wire == DType.F16:
        return s.view(torch.float16).float()
    return ((s.to(torch.int64) & 0xFFFF) << 16).to(torch.int32).view(torch.float32)


def decode_wire_plain(dst: torch.Tensor, src: torch.Tensor, wire: DType) -> None:
    """Plain twin of :func:`decode_wire`."""
    _check_wire(wire)
    _check_codec(dst, src)
    dst.copy_(_decode16(src, wire))


def decode_accumulate_plain(acc: torch.Tensor, begin: int, end: int, src: torch.Tensor,
                            wire: DType, op: ReduceOp) -> None:
    """Plain twin of :func:`decode_accumulate`."""
    _check_wire(wire)
    _check_segment(acc, begin, end, src)
    seg = acc[begin:end]
    _check_codec(seg, src)
    seg.copy_(_combine(seg, _decode16(src, wire), op))


def _q_scales_plain(src: torch.Tensor, bits: int, block: int) -> torch.Tensor:
    """Per-block pow2 scales, as reduce.cpp's q_block_scale: frexp of
    fl(amax / Qmax), 2^(e - 1) for an exact power of two, else 2^e."""
    n = src.numel()
    nb = (n + block - 1) // block
    padded = torch.zeros(nb * block, dtype=torch.float32)
    padded[:n] = src
    amax = padded.view(nb, block).abs().amax(dim=1)
    t = amax / (127.0 if bits == 8 else 7.0)
    m, e = torch.frexp(t)
    e = torch.where(m == 0.5, e - 1, e).to(torch.int64)
    # 2^e exactly in f64, then rounded to f32 as ldexpf rounds
    s = ((e + 1023) << 52).view(torch.float64).to(torch.float32)
    return torch.where(amax == 0.0, torch.zeros_like(s), s)


def encode_wire_q_plain(dst: torch.Tensor, src: torch.Tensor, wire: QWire) -> None:
    """Plain twin of :func:`encode_wire_q`."""
    _check_codec_q(src, dst, wire, "encoded buffer")
    n = src.numel()
    nb = (n + wire.block - 1) // wire.block
    s = _q_scales_plain(src, wire.bits, wire.block)
    dst[: 4 * nb].copy_(s.view(torch.uint8))
    qmax = 127.0 if wire.bits == 8 else 7.0
    inv = torch.where(s == 0.0, torch.zeros_like(s), 1.0 / s)
    q = torch.round(src * inv.repeat_interleave(wire.block)[:n]).clamp(-qmax, qmax)
    q = q.to(torch.int8)
    if wire.bits == 8:
        dst[4 * nb:].copy_(q.view(torch.uint8))
        return
    if n & 1:
        q = torch.cat([q, torch.zeros(1, dtype=torch.int8)])
    nibs = q.view(torch.uint8) & 0xF
    dst[4 * nb:].copy_(nibs[0::2] | (nibs[1::2] << 4))


def _decode_q(src: torch.Tensor, n: int, wire: QWire) -> torch.Tensor:
    nb = (n + wire.block - 1) // wire.block
    s = src[: 4 * nb].clone().view(torch.float32)
    payload = src[4 * nb:]
    if wire.bits == 8:
        q = payload.view(torch.int8).float()
    else:
        nibs = torch.stack([payload & 0xF, payload >> 4], dim=1).reshape(-1)[:n]
        nibs = nibs.to(torch.int16)
        q = torch.where(nibs >= 8, nibs - 16, nibs).float()
    return s.repeat_interleave(wire.block)[:n] * q


def decode_wire_q_plain(dst: torch.Tensor, src: torch.Tensor, wire: QWire) -> None:
    """Plain twin of :func:`decode_wire_q`."""
    _check_codec_q(dst, src, wire, "encoded payload")
    dst.copy_(_decode_q(src, dst.numel(), wire))


def decode_accumulate_q_plain(acc: torch.Tensor, begin: int, end: int, src: torch.Tensor,
                              wire: QWire, op: ReduceOp) -> None:
    """Plain twin of :func:`decode_accumulate_q`."""
    _check_bounds(acc, begin, end)
    seg = acc[begin:end]
    _check_codec_q(seg, src, wire, "encoded payload")
    seg.copy_(_combine(seg, _decode_q(src, seg.numel(), wire), op))


def encode_wire_any_plain(dst: torch.Tensor, src: torch.Tensor, wire) -> None:
    """Plain twin of :func:`encode_wire_any`."""
    if isinstance(wire, QWire):
        encode_wire_q_plain(dst, src, wire)
    else:
        encode_wire_plain(dst, src, wire)


def decode_wire_any_plain(dst: torch.Tensor, src: torch.Tensor, wire) -> None:
    """Plain twin of :func:`decode_wire_any`."""
    if isinstance(wire, QWire):
        decode_wire_q_plain(dst, src, wire)
    else:
        decode_wire_plain(dst, src, wire)


def decode_accumulate_any_plain(acc: torch.Tensor, begin: int, end: int, src: torch.Tensor,
                                wire, op: ReduceOp) -> None:
    """Plain twin of :func:`decode_accumulate_any`."""
    if isinstance(wire, QWire):
        decode_accumulate_q_plain(acc, begin, end, src, wire, op)
    else:
        decode_accumulate_plain(acc, begin, end, src, wire, op)

"""Wire-codec layer of the host collective engine.

Port of `kungfu_tpu/collective/codec.py`: the KF_CONFIG_WIRE mode table,
the per-workspace compress-or-bypass decision (:class:`WireCodec` mixin on
:class:`~kungfu_tpu_torch.collective.host_session.HostSession`), the
deferred-decode handle the fused pipeline uses to merge the walk-end
decode into bucket unpack, and the error-feedback residual store of the
quantized codec. The codec mechanics (encode/decode/decode-accumulate)
are `base/ops.py` over the host C++.
"""

from __future__ import annotations

import torch

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.base.dtype import DType
from kungfu_tpu_torch.base.ops import QWire, decode_wire
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.telemetry import audit, log
from kungfu_tpu_torch.utils.pool import get_buffer_pool

# f32 allreduce payloads travel the transport as bf16/f16 (or block-scaled
# int8/int4, one f32 pow2 absmax scale per KF_WIRE_BLOCK elements) while
# every reduce step accumulates into the f32 buffer. Cluster-agreed like
# KF_CONFIG_ALGO (it decides message SIZES), checked by
# check_knob_consensus at session start. `auto` resolves to bf16.
WIRE_MODES = ("off", "bf16", "f16", "auto", "int8", "int4")

WIRE_DTYPE = {"bf16": DType.BF16, "f16": DType.F16, "auto": DType.BF16}

_WIRE_Q_BITS = {"int8": 8, "int4": 4}


def wire_override() -> str:
    """Parse KF_CONFIG_WIRE (read per session epoch, not import time).
    The registry's strict choice parser raises on a typo and resolves
    unset/empty to "off"."""
    return knobs.get("KF_CONFIG_WIRE")



def dtype_str(dt: torch.dtype) -> str:
    """numpy's `dtype.str` of a torch dtype, as the reference's records
    hold it (bf16 is ml_dtypes' two-byte void, ``<V2``)."""
    if dt == torch.bfloat16:
        return "<V2"
    return DType.from_torch(dt).to_numpy().str

class DeferredDecode:
    """Handle to a compressed segmented walk's all-gather wire buffer,
    returned instead of the walk-end f32 decode when the caller asked to
    defer it (`_allreduce_ws(defer_decode=True)`). The fused pipeline's
    unpacker decodes straight from this buffer into each member's recv —
    one full f32 pass saved per bucket. Call `decode_into(dst, begin,
    end)` per member, then `close()` exactly once to return the buffer to
    the pool."""

    __slots__ = ("wire", "_buf", "_arr")

    def __init__(self, wire: DType, buf: torch.Tensor, arr: torch.Tensor):
        self.wire = wire
        self._buf = buf
        self._arr = arr

    def decode_into(self, dst: torch.Tensor, begin: int, end: int) -> None:
        seg = self._arr[begin:end]
        if dst.is_contiguous():
            decode_wire(dst, seg, self.wire)
        else:
            tmp = torch.empty(end - begin, dtype=torch.float32)
            decode_wire(tmp, seg, self.wire)
            dst.copy_(tmp)

    def close(self) -> None:
        if self._buf is not None:
            get_buffer_pool().put(self._buf)
            self._buf = None


class WireCodec:
    """Codec-policy mixin for HostSession: resolves the RUNNING wire mode
    (config + lockstep adaptive votes) and decides per workspace whether
    a walk compresses or bypasses. Relies on session state (`wire_mode`,
    `_candidates`, `adaptive`, `_tree_override`) owned by the facade's
    constructor."""

    # Codec floor: encoding pays two passes (encode + decode) to halve the
    # wire bytes, which only wins once the payload dwarfs the fixed
    # per-walk costs; tiny control collectives also stay exact this way.
    # Cluster-agreed (it decides message sizes).
    WIRE_MIN_BYTES = int(knobs.get("KF_CONFIG_WIRE_MIN_BYTES"))

    # Elements per absmax scale block of the quantized codec.
    # Cluster-agreed: it decides the byte length of every int8/int4 message.
    WIRE_BLOCK = int(knobs.get("KF_WIRE_BLOCK"))

    def _active_wire_mode(self) -> str:
        """The RUNNING codec mode: the active adaptive candidate's wire
        member, or the configured mode under a set_tree override (an
        explicit forest replaces the graphs, not the codec)."""
        if self._tree_override:
            return self.wire_mode
        return self._candidates[self.adaptive.active][1]

    def active_wire_mode(self) -> str:
        """Public accessor of the RUNNING codec mode, which the
        precision policy compares its target against."""
        return self._active_wire_mode()

    def _codec_bypass(self, reason: str, w: Workspace) -> None:
        """Audit (once per (reason, dtype) per session epoch) that a
        workspace bypassed an enabled codec — exact semantics kept for
        consensus lanes, integer payloads and tiny residuals."""
        dtype = dtype_str(w.send.dtype)
        key = (reason, dtype)
        if key in self._codec_bypass_seen:
            return
        self._codec_bypass_seen.add(key)
        audit.record_event(
            "wire_codec_bypass",
            peer=str(self.self_id),
            reason=reason,
            dtype=dtype,
            name=w.name,
            nbytes=int(w.recv.nbytes),
        )

    def _wire_codec_for(self, w: Workspace):
        """Codec decision for one allreduce workspace: a ``DType`` (2-byte
        codec), a :class:`QWire` (block-scaled int8/int4), or None (raw).

        MUST depend only on cluster-agreed inputs — the resolved wire mode
        and workspace properties identical on every peer — because it
        decides the byte count of every message in the walk. Non-f32
        payloads and sub-WIRE_MIN_BYTES residuals bypass with an audit
        event, never an error;
        an UNKNOWN mode warns loudly and runs exact."""
        mode = self._active_wire_mode()
        if mode != self._ef_mode:
            # any precision flip invalidates carried error-feedback
            # residuals: they measure the OLD codec's rounding
            self._flush_residuals(f"wire mode {self._ef_mode!r} -> {mode!r}")
            self._ef_mode = mode
        if mode == "off":
            return None
        if w.send.dtype != torch.float32:
            self._codec_bypass("non_f32", w)
            return None
        if w.recv.nbytes < self.WIRE_MIN_BYTES:
            self._codec_bypass("below_min_bytes", w)
            return None
        bits = _WIRE_Q_BITS.get(mode)
        if bits is not None:
            return QWire(bits, self.WIRE_BLOCK)
        codec = WIRE_DTYPE.get(mode)
        if codec is None:
            if mode not in self._unknown_wire_warned:
                self._unknown_wire_warned.add(mode)
                log.warn(
                    "wire codec: unknown mode %r reached the running "
                    "session — running EXACT (no compression). Valid "
                    "modes: %s", mode, ", ".join(WIRE_MODES),
                )
            return None
        return codec

    # --- error-feedback residual store (quantized codec only) ----------
    #
    # One full-size f32 residual per workspace name: the un-transmitted
    # remainder of the last quantized send, added back into the next send
    # so rounding telescopes instead of compounding. Lazily zeroed;
    # flushed on any wire-mode change; dies with the session on resize.

    def _ef_residual(self, key: str, size: int) -> torch.Tensor:
        r = self._ef_store.get(key)
        if r is None or r.numel() != size:
            r = torch.zeros(size, dtype=torch.float32)
            self._ef_store[key] = r
        return r

    def _flush_residuals(self, reason: str) -> None:
        if self._ef_store:
            log.debug("wire codec: flushing %d error-feedback residuals (%s)",
                      len(self._ef_store), reason)
        self._ef_store.clear()
        for cb in tuple(self._ef_flush_listeners):
            try:
                cb(reason)
            except Exception as e:  # noqa: BLE001 - flush must reach the rest
                log.warn("wire codec: residual flush listener failed: %s", e)

    def add_ef_flush_listener(self, cb) -> None:
        """Register `cb(reason)` to run on every residual flush: the hook
        ZeRO uses to reset its per-shard residuals in lockstep with the
        session store."""
        self._ef_flush_listeners.append(cb)

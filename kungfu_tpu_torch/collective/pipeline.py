"""Group-allreduce fusion pipeline.

Port of `kungfu_tpu/collective/pipeline.py`: the bucket side of
`group_all_reduce` — deterministic same-(dtype, op) bucketing
(`_make_buckets`), the pack / walk / unpack stages, and the 3-stage
software pipeline that overlaps them, over abort-aware
:class:`~kungfu_tpu_torch.utils.handoff.HandoffQueue` stage queues.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.collective.strategies import effective_cpu_count
from kungfu_tpu_torch.utils import trace
from kungfu_tpu_torch.utils.handoff import HandoffQueue, parallel_run as _par
from kungfu_tpu_torch.utils.pool import get_buffer_pool
from kungfu_tpu_torch.utils.stall import stall_detect


class GroupFusion:
    """Group-collective mixin for HostSession: windowed singles plus fused
    buckets through the pack/walk/unpack pipeline. Relies on session
    state (timeout, codec decision, walk engine) owned by the facade's
    constructor."""

    # concurrent workspaces per batch in group ops: concurrency only pays
    # when cores exist to run the walks, so the default scales with the
    # cgroup-aware core count; KF_CONFIG_GROUP_WINDOW overrides
    GROUP_WINDOW = int(
        knobs.get("KF_CONFIG_GROUP_WINDOW")
        or max(1, min(8, effective_cpu_count()))
    )

    # Gradient bucketing: fuse same-(dtype, op) workspaces into ONE
    # contiguous walk. A 160-tensor gradient set otherwise pays the fixed
    # per-walk cost (rendezvous, pool dispatch, ~6 framed messages) 160
    # times; two extra memcpy passes (pack + unpack) buy a ~160x cut in
    # message count.
    FUSE_MIN_TENSORS = int(knobs.get("KF_CONFIG_GROUP_FUSE_MIN"))

    # Fused-bucket size cap: buckets pack / walk / unpack as a 3-stage
    # pipeline, trading per-walk fixed cost (bigger buckets) against
    # overlap (smaller ones). Part of the fused workspace name, so it MUST
    # be cluster-agreed like CHUNK_BYTES.
    GROUP_BUCKET_BYTES = int(knobs.get("KF_CONFIG_GROUP_BUCKET_BYTES"))

    def group_all_reduce(self, ws: Sequence[Workspace]) -> None:
        """Allreduce of many workspaces as one windowed group op (parity:
        the reference reduces a whole gradient set per session.run).
        Fused buckets run through the 3-stage pipeline while the singles
        windows walk concurrently."""
        if not ws:
            return
        with self._collected("group_all_reduce", sum(w.recv.nbytes for w in ws)), \
                stall_detect(f"group_all_reduce[{len(ws)}]"):
            singles: List[Workspace] = []
            groups: Dict[tuple, List[Workspace]] = {}
            for w in ws:
                if w.is_empty:
                    continue
                groups.setdefault((str(w.send.dtype), int(w.op)), []).append(w)
            buckets: List[List[Workspace]] = []
            for members in groups.values():
                if len(members) < self.FUSE_MIN_TENSORS:
                    singles.extend(members)
                else:
                    buckets.extend(self._make_buckets(members))
            jobs: List[Callable[[], None]] = []
            # the group deadline scales with the number of walks it covers
            windows = -(-len(singles) // self.GROUP_WINDOW)
            group_timeout = self.timeout * max(1, len(buckets) + windows)
            # shared cancel: a group-level timeout must also abort the
            # pipeline stages, or a lingering unpacker would keep writing
            # caller recv buffers after this call already raised
            cancel = threading.Event()
            if buckets:
                jobs.append(lambda: self._fused_pipeline(buckets, group_timeout, cancel))
            if singles:
                jobs.append(lambda: self._singles_windows(singles, cancel))
            _par(jobs, group_timeout, cancel)

    def _make_buckets(self, members: List[Workspace]) -> List[List[Workspace]]:
        """Greedy, order-preserving packing of same-(dtype, op) workspaces
        into <= GROUP_BUCKET_BYTES buckets: derived only from the caller's
        tensor order and the byte cap, so every peer computes the same
        layout; an oversized single tensor gets a bucket of its own."""
        buckets: List[List[Workspace]] = []
        cur: List[Workspace] = []
        cur_bytes = 0
        for w in members:
            if cur and cur_bytes + w.send.nbytes > self.GROUP_BUCKET_BYTES:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(w)
            cur_bytes += w.send.nbytes
        if cur:
            buckets.append(cur)
        return buckets

    def _singles_windows(self, singles: List[Workspace],
                         cancel: Optional[threading.Event] = None) -> None:
        for i in range(0, len(singles), self.GROUP_WINDOW):
            if cancel is not None and cancel.is_set():
                # the group already raised: stop launching windows, but
                # return QUIETLY so the real error reaches the caller
                return
            batch = singles[i:i + self.GROUP_WINDOW]
            _par([lambda w=w: self._allreduce_ws(w, cancel) for w in batch],
                 self.timeout, cancel)

    def _pack_bucket(self, bi: int, members: List[Workspace], name_prefix: str = ""):
        """Pack one bucket into pooled contiguous buffers, in the caller's
        tensor order (identical on every peer, so the fused name and
        layout agree cluster-wide). When the wire codec will compress the
        bucket, members are packed into ONE buffer that doubles as the
        walk's f32 accumulator (an inplace workspace): the walk stages its
        wire bytes in pooled scratches, so a second f32 buffer buys
        nothing."""
        dtype = members[0].send.dtype
        op = members[0].op
        total = sum(w.send.numel() for w in members)
        nbytes = total * members[0].send.element_size()
        pool = get_buffer_pool()
        single = (
            self._active_wire_mode() != "off"
            and dtype == torch.float32
            and nbytes >= self.WIRE_MIN_BYTES
        )
        send_b = pool.get(nbytes)
        recv_b = None if single else pool.get(nbytes)
        with trace.span("host.fuse.pack"):
            send = send_b.view(dtype)
            recv = send if single else recv_b.view(dtype)
            off = 0
            for w in members:
                send[off:off + w.send.numel()].copy_(w.send)
                off += w.send.numel()
        fused = Workspace(
            send=send,
            recv=recv,
            op=op,
            name=f"{members[0].name}::fused:{name_prefix}b{bi}:{len(members)}x{total}",
        )
        return (fused, send_b, recv_b, members)

    def _unpack_bucket(self, item, abort: Optional[threading.Event] = None) -> None:
        fused, send_b, recv_b, members, deferred = item
        if abort is not None and abort.is_set():
            # the group scope aborted while this bucket was in flight —
            # the member recv buffers may already be reused, so drop it
            return
        pool = get_buffer_pool()
        try:
            with trace.span("host.fuse.unpack"):
                off = 0
                if deferred is not None:
                    # fused decode+unpack: the compressed walk handed over
                    # its wire buffer instead of decoding first
                    for w in members:
                        deferred.decode_into(w.recv, off, off + w.recv.numel())
                        off += w.recv.numel()
                else:
                    for w in members:
                        w.recv.copy_(fused.recv[off:off + w.recv.numel()])
                        off += w.recv.numel()
        finally:
            if deferred is not None:
                deferred.close()
            pool.put(send_b)
            if recv_b is not None:
                pool.put(recv_b)

    def _fused_pipeline(self, buckets: List[List[Workspace]], timeout: float,
                        cancel: Optional[threading.Event] = None) -> None:
        """3-stage software pipeline over fused buckets: pack bucket i+1
        and unpack bucket i-1 while bucket i is on the wire. Depth-1
        handoff queues bound live pooled buffers; the queues share one
        abort event, so any stage's failure unblocks the other two and
        the REAL error propagates out of _par."""
        abort = cancel if cancel is not None else threading.Event()
        packed = HandoffQueue(maxsize=1, abort=abort)
        unpackq = HandoffQueue(maxsize=1, abort=abort)

        def packer():
            try:
                for bi, members in enumerate(buckets):
                    if abort.is_set():
                        return
                    if not packed.put(self._pack_bucket(bi, members)):
                        return
            except BaseException:
                abort.set()
                raise
            finally:
                packed.put(None)

        def walker():
            try:
                while True:
                    item = packed.get()
                    if item is None:
                        return
                    if abort.is_set():
                        continue  # drain to the sentinel
                    with trace.span("host.fuse.walk"):
                        deferred = self._allreduce_ws(item[0], defer_decode=True)
                    if not unpackq.put(item + (deferred,)):
                        return
            except BaseException:
                abort.set()
                raise
            finally:
                unpackq.put(None)

        def unpacker():
            try:
                while True:
                    item = unpackq.get()
                    if item is None:
                        return
                    if abort.is_set():
                        continue  # aborted: must not touch caller buffers
                    self._unpack_bucket(item, abort)
            except BaseException:
                abort.set()
                raise

        _par([packer, walker, unpacker], timeout, abort)

"""PairAveraging (AD-PSGD): asynchronous decentralized data parallelism.

Port of `kungfu_tpu/optimizers/pair_averaging.py` (parity:
srcs/python/kungfu/tensorflow/optimizers/async_sgd.py (_PairAveraging) +
the p2p versioned store (srcs/go/store, handler/p2p.go) + the
AsyncRequestModel prefetch pattern (ops/cpu/peer_to_peer.cpp:166-258)).

Per step: pick a random peer, fetch its model from its host-side store,
average 0.5/0.5 with our params, apply local gradients, publish our new
model. No global barrier: workers proceed at their own pace; stale peers
are tolerated (that is the algorithm's point).

The exchange is host-side and overlapped: a background thread prefetches
the next peer's model while the device runs the current step. The blob
is `base/serialize`'s `pack_leaves` of the parameters in jax's leaf order
(`elastic/state.tree_flatten`), so a port worker and a reference worker
exchange models both ways; a card's parameters are packed through the
api's pinned buffers.

The reference takes an optax transformation and threads its state
through `step(params, opt_state, grads)`. Here `base` is a torch
optimizer over the parameter leaves, or a factory
``base(leaves) -> torch.optim.Optimizer`` that `init` calls; the
optimizer holds the state optax returns (`init` returns it), and the
leaves are updated in place. optax.sgd(lr) maps to
torch.optim.SGD(lr), optax.adam(lr) to torch.optim.Adam(lr) (the same
defaults; the arithmetic of Adam's denominator differs in rounding).
The order is the reference's: average first (in f32, rounded back to the
parameter's dtype), then the base step on the local gradients.
"""

from __future__ import annotations

import random
import struct
import threading
import time
from typing import Any, List, Optional

import torch

from kungfu_tpu_torch import resolve_device
from kungfu_tpu_torch.base.serialize import unpack_leaves
from kungfu_tpu_torch.elastic.state import pack_state, tree_flatten


def _pack_host(tree) -> bytes:
    """Dtype-faithful wire blob: raw leaf bytes + dtype/shape header
    (base/serialize.py): bf16 models exchange losslessly."""
    return pack_state(tree_flatten(tree)[0])


class PairAveraging:
    """The trainer-side object owning the p2p exchange.

    peer: kungfu_tpu_torch.peer.Peer (host runtime, default: the
    process's); base: a torch optimizer over the leaves, or a factory of
    one; device: where the parameters live (None = the CUDA card).

    `steps` counts steps by exchange outcome ("avg", "plain"); `last`
    holds the latest step's timings (ms): the exposed `wait` in the
    prefetch's join, the prefetch's own `fetch` duration, `pack` and
    `publish`, and the fetched blob's `bytes`."""

    BLOB = "pair-avg-model"

    def __init__(self, base, peer=None, name: str = "model",
                 rng: Optional[random.Random] = None, device=None):
        if peer is None:
            from kungfu_tpu_torch.peer import get_default_peer

            peer = get_default_peer()
        self.device = resolve_device(device)
        self.peer = peer
        self.base = base
        self.opt: Optional[torch.optim.Optimizer] = None
        self.blob = f"{self.BLOB}:{name}"
        self.rng = rng or random.Random(peer.rank * 7919 + 17)
        self._prefetch: Optional[threading.Thread] = None
        self._fetched: List[Any] = [None, None]  # per-thread slot: blob, seconds
        self._n_leaves = 0
        # per-step publish version: each publish is an immutable
        # (version, blob) in the VersionedStore (GC window 3), so a reader
        # mid-request gets a consistent snapshot while we publish the next
        # (parity: p2p.go versioned requests)
        self._version = 0
        # the reference's kungfu_pair_avg_steps_total counter is a
        # telemetry metric (ROADMAP item 1e); the counts are kept here
        self.steps = {"avg": 0, "plain": 0}
        self.last: dict = {}

    # -- host-side exchange --------------------------------------------
    def _random_peer_rank(self) -> Optional[int]:
        size = self.peer.size
        if size <= 1:
            return None
        r = self.rng.randrange(size - 1)
        return r + 1 if r >= self.peer.rank else r

    def _start_prefetch(self) -> None:
        target = self._random_peer_rank()
        if target is None:
            return

        slot: List[Any] = [None, None]

        def fetch():
            t0 = time.perf_counter()
            sess = self.peer.current_session()
            try:
                data = self.peer.p2p.request(
                    sess.peers[target], self.blob, timeout=30, version="latest"
                )
            except (ConnectionError, TimeoutError, OSError):
                data = None
            slot[1] = time.perf_counter() - t0
            slot[0] = data

        self._fetched = slot
        self._prefetch = threading.Thread(target=fetch, daemon=True)
        self._prefetch.start()

    def _publish(self, params) -> None:
        t0 = time.perf_counter()
        blob = _pack_host(params)
        t1 = time.perf_counter()
        self.peer.p2p.save_version(self._version, self.blob, blob)
        self.last.update(pack=(t1 - t0) * 1e3, publish=(time.perf_counter() - t1) * 1e3)

    def init(self, params) -> torch.optim.Optimizer:
        """Publish the initial model, fence, start the first prefetch
        (parity: async_sgd.py:106-108 init-store + barrier); returns the
        base optimizer."""
        leaves, _ = tree_flatten(params)
        for p in leaves:
            if p.device != self.device:
                raise ValueError(f"a parameter on {p.device}, not on {self.device}")
        self._n_leaves = len(leaves)
        self.opt = self.base if isinstance(self.base, torch.optim.Optimizer) else self.base(leaves)
        self._publish(params)
        if not self.peer.config.single_process:
            # version-stamped so a re-init after an elastic resize can
            # never rendezvous with the old epoch's barrier
            self.peer.current_session().barrier(
                tag=f":pair-avg-init:v{self.peer.cluster_version}"
            )
        self._start_prefetch()
        return self.opt

    def _unpack_other(self, blob) -> Optional[List[torch.Tensor]]:
        """Wire blob -> the params' leaves, on the host (None on malformed
        data: a stale peer mid-resize may serve a different-shaped model)."""
        try:
            return unpack_leaves(bytes(blob), self._n_leaves)
        except (
            ValueError,  # wrong leaf count / unknown dtype / short buffer (json errors too)
            KeyError,  # header missing dtype/shape
            struct.error,  # blob shorter than the length prefix
            UnicodeDecodeError,  # garbage where the json header should be
            AttributeError,  # the reference's ml_dtypes lookup; kept for parity
        ):
            return None

    @torch.no_grad()
    def _average(self, leaves: List[torch.Tensor], other: List[torch.Tensor]) -> None:
        # average in f32 regardless of storage dtype (a bf16 0.5*(p+o)
        # loses a mantissa bit per step), round back to the param dtype
        for p, o in zip(leaves, other):
            o = o.to(p.device).reshape(p.shape)
            p.copy_((0.5 * (p.float() + o.float())).to(p.dtype))

    def step(self, params, grads):
        """One training step with the already-computed LOCAL grads (a
        tree like `params`); updates the leaves in place and returns
        `params`."""
        other_blob: Optional[bytes] = None
        t0 = time.perf_counter()
        self.last = {"wait": 0.0, "fetch": None, "bytes": 0}
        if self._prefetch is not None:
            self._prefetch.join(timeout=30)
            if not self._prefetch.is_alive():
                # orphaned fetches keep writing only their own slot, so a
                # timed-out thread can never clobber a later prefetch
                other_blob, fetch_s = self._fetched
                self.last.update(fetch=None if fetch_s is None else fetch_s * 1e3,
                                 bytes=len(other_blob) if other_blob else 0)
            self._prefetch = None
            self.last["wait"] = (time.perf_counter() - t0) * 1e3
        leaves, _ = tree_flatten(params)
        other = self._unpack_other(other_blob) if other_blob else None
        if other is not None and any(tuple(o.shape) != tuple(p.shape)
                                     for o, p in zip(other, leaves)):
            other = None
        self.steps["avg" if other is not None else "plain"] += 1
        if other is not None:
            self._average(leaves, other)
        for p, g in zip(leaves, tree_flatten(grads)[0]):
            p.grad = g
        self.opt.step()
        # publish new model as the next immutable version, then overlap the
        # next fetch with caller compute
        self._version += 1
        self._publish(params)
        self._start_prefetch()
        return params

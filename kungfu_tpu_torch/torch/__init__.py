"""PyTorch frontend: data parallelism over the host plane.

Port of `kungfu_tpu/torch/__init__.py` on this package's own `api` and
`Peer` (parity: srcs/python/kungfu/torch/__init__.py): gradients and
parameters travel through the host collective engine.

    from kungfu_tpu_torch import torch as kf_torch
    kf_torch.broadcast_parameters(model)
    opt = kf_torch.SynchronousSGDOptimizer(torch.optim.SGD(model.parameters(), lr=0.1))
    ...
    loss.backward(); opt.step()

A contiguous CPU tensor is reduced in place. Any other tensor is staged
through a host buffer: a card's tensor through a pinned buffer of the
api's pool, by a copy that runs on while its event marks the end, and
the result goes back to the tensor's device after the round.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from kungfu_tpu_torch import api
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.serialize import pack_leaves, unpack_leaves
from kungfu_tpu_torch.base.workspace import Workspace


def _params_of(module_or_params) -> List:
    if hasattr(module_or_params, "parameters"):
        return list(module_or_params.parameters())
    return list(module_or_params)


class _Staged:
    """One tensor's host view for a reduction: the tensor itself (flat)
    for a contiguous CPU tensor, else a host copy (pinned for a card's)
    that `write_back` copies into the tensor and `release` returns to the
    pool. `ready` is the event of a card's copy, None when it has landed."""

    __slots__ = ("t", "host", "buf", "ready")

    def __init__(self, t: torch.Tensor, wait: bool = True):
        t = t.detach()
        self.t, self.buf, self.ready = t, None, None
        if t.device.type == "cpu":
            self.host = t.reshape(-1) if t.is_contiguous() else t.contiguous().reshape(-1)
            return
        self.buf = api._pinned_pool().get(t.numel() * t.element_size())
        self.host = self.buf.view(t.dtype)
        self.host.copy_(t.reshape(-1), non_blocking=True)
        self.ready = torch.cuda.Event()
        self.ready.record(torch.cuda.current_stream(t.device))
        if wait:
            self.ready.synchronize()
            self.ready = None

    @property
    def aliased(self) -> bool:
        return self.host.data_ptr() == self.t.data_ptr()

    def write_back(self) -> None:
        if not self.aliased:
            self.t.copy_(self.host.view(self.t.shape), non_blocking=self.buf is not None)

    def release(self) -> None:
        """Return the pinned buffer once the copies out of it have ended."""
        if self.buf is not None:
            torch.cuda.current_stream(self.t.device).synchronize()
            api._pinned_pool().put(self.buf)
            self.buf = None


def _scale_back(staged: List[_Staged], size: int) -> None:
    """Average the reduced sums in place (the reference's ``v *= 1/size``
    in the tensor's dtype), write them into their tensors, release."""
    inv = 1.0 / size
    for s in staged:
        s.host.mul_(inv)
        s.write_back()
    for s in staged:
        s.release()


_sync_round = [0]


def sync_gradients(module_or_params, name: str = "torch-grad",
                   _force_sync_engine: bool = False) -> None:
    """Average .grad across the cluster in place (parity:
    _synchronize_grads, kungfu/torch/optimizers.py): one windowed group
    allreduce over the host plane; a no-op for a cluster of one. Wire
    names carry a per-process round counter.

    With the async scheduler on (``KF_CONFIG_ASYNC``) the group goes
    through it (submit all, then flush) under STABLE per-tensor names:
    the trailing ``:<suffix>`` of `name` is stripped, as the scheduler
    stamps its own round counter into wire names."""
    size = api.cluster_size()
    if size <= 1:
        return
    params = [p for p in _params_of(module_or_params) if p.grad is not None]
    if not params:
        return
    rnd = _sync_round[0]
    _sync_round[0] += 1
    staged = [_Staged(p.grad) for p in params]
    sess = api.get_default_peer().current_session()
    if sess.async_enabled() and not _force_sync_engine:
        sched = sess.scheduler()
        for i, s in enumerate(staged):
            sched.submit(Workspace(send=s.host, recv=s.host, op=ReduceOp.SUM,
                                   name=f"kungfu::torch:{name.rsplit(':', 1)[0]}:{i}"))
        sched.flush()
    else:
        sess.group_all_reduce([
            Workspace(send=s.host, recv=s.host, op=ReduceOp.SUM,
                      name=f"kungfu::torch:{name}:{rnd}:{i}")
            for i, s in enumerate(staged)])
    _scale_back(staged, size)


def broadcast_parameters(module_or_params, root: int = 0, name: str = "torch-init") -> None:
    """Replace every param with root's values (parity:
    broadcast_parameters, kungfu/torch/__init__.py)."""
    if api.cluster_size() <= 1:
        return
    params = _params_of(module_or_params)
    sess = api.get_default_peer().current_session()
    blob = pack_leaves([p.detach().reshape(-1) for p in params])  # flat, as the reference's
    out = sess.broadcast_bytes(blob, f"kungfu::torch:{name}", root=root)
    if sess.rank == root:
        return
    leaves = unpack_leaves(out, len(params))
    with torch.no_grad():
        for p, leaf in zip(params, leaves):
            p.copy_(leaf.view_as(p))


def all_reduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM,
               name: str = "torch-ar") -> torch.Tensor:
    """AllReduce a single tensor, returning a new tensor on the input's
    device (parity: all_reduce_fn)."""
    return api.all_reduce_array(tensor.detach(), op=op, name=name)


class SynchronousSGDOptimizer:
    """S-SGD wrapper over any torch optimizer (parity:
    SynchronousSGDOptimizer, kungfu/torch/optimizers.py): averages
    gradients across the cluster, then applies the base step.

    With the async collective scheduler on (``KF_CONFIG_ASYNC``) each
    parameter's gradient is SUBMITTED the moment autograd finishes
    accumulating it (post-accumulate-grad hooks), so buckets pack and walk
    while backward still produces later gradients; ``step()`` then only
    flushes the tail. A card's gradient is copied into a pinned buffer on
    the current stream without waiting (the hook runs on autograd's
    device thread); the scheduler waits for the copy's event before it
    packs. Step 0 takes the step-end group op (the hooks are installed at
    the first step), as do a cluster of one, ``async_hooks=False`` and a
    scheduler that is off. Results are bit-identical either way for the
    same bucket layout (only launch time moves).

    Hook-path contract: exactly ONE backward per ``step()``; pass
    ``async_hooks=False`` for gradient-accumulation loops."""

    def __init__(self, base, name: str = "ssgd", async_hooks: Optional[bool] = None):
        self.base = base
        self.name = name
        self._step = 0
        self._async_grads: dict = {}  # param index -> (param, _Staged)
        self._async_opt_in = async_hooks
        self._hooks_installed: Optional[bool] = None  # None: undecided

    def _params_list(self) -> List:
        return [p for group in self.base.param_groups for p in group["params"]]

    def _install_hooks(self) -> bool:
        """Register per-param submission hooks when the async scheduler
        can take them; decided once, at the first step. Hook firing order
        is autograd order, identical across replicas of the same model,
        which the scheduler's registration consensus verifies."""
        if self._async_opt_in is False:
            return False
        if api.cluster_size() <= 1:
            return False
        sess = api.get_default_peer().current_session()
        if not sess.async_enabled():
            return False

        def make_hook(i):
            def hook(param):
                s = api.get_default_peer().current_session()
                if not s.async_enabled():
                    # a resize landed on an async-off session: go dormant;
                    # step() falls back to the step-end path
                    return
                st = _Staged(param.grad, wait=False)
                self._async_grads[i] = (param, st)
                s.scheduler().submit(Workspace(
                    send=st.host, recv=st.host, op=ReduceOp.SUM,
                    name=f"kungfu::torch:{self.name}:{i}", ready=st.ready))
            return hook

        for i, p in enumerate(self._params_list()):
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(make_hook(i))
        return True

    def step(self, closure=None):
        if self._hooks_installed is None:
            # decided AFTER the first backward: step 0 always takes the
            # step-end path, the hooks feed the scheduler from step 1
            self._hooks_installed = self._install_hooks()
        if self._async_grads:
            sess = api.get_default_peer().current_session()
            if not sess.async_enabled():
                # a resize landed between backward and step: this step's
                # submissions died with the old epoch
                for _, st in self._async_grads.values():
                    st.release()
                self._async_grads.clear()
                raise RuntimeError(
                    "cluster resized mid-step onto an async-off session; gradients of "
                    "this step are indeterminate — zero_grad() and re-run the backward")
            api.flush_async()
            _scale_back([st for _, (_, st) in sorted(self._async_grads.items())],
                        api.cluster_size())
            self._async_grads.clear()
        else:
            # step-end path: the classic group engine even with the
            # scheduler on (the hooks register full-param-list indices)
            sync_gradients(self._params_list(), name=f"{self.name}:{self._step}",
                           _force_sync_engine=True)
        self._step += 1
        return self.base.step(closure)

    def __getattr__(self, item):
        return getattr(self.base, item)


class ZeroSGDOptimizer:
    """ZeRO-1 sharded S-SGD over the host plane: gradients are
    reduce-scattered around the ring, ``step()`` runs SGD on, and holds
    momentum state plus f32 master weights for, ONLY this rank's 1/k
    shard, and an all-gather of the updated weights lands the result back
    in the param tensors in place (a card's params by a copy from the
    host mirror).

    It owns the SGD math (``buf = m·buf + g; p -= lr·buf``). With
    ``KF_CONFIG_ZERO`` resolving off, or a cluster of one, it falls back
    to the replicated path (``sync_gradients`` + the same formula on full
    params); for SGD on exact payloads the two are bit-identical. Call
    ``export_state()`` before a resize and ``rebuild(blob)`` after."""

    def __init__(self, module_or_params, lr: float, momentum: float = 0.0, name: str = "zsgd"):
        from kungfu_tpu_torch.collective.zero import ShardedSGD

        self.lr = float(lr)
        self.momentum = float(momentum)
        self.name = name
        self._params = [p for p in _params_of(module_or_params) if p.requires_grad]
        if not self._params:
            raise ValueError("ZeroSGDOptimizer needs at least one param")
        self._mode: Optional[str] = None  # decided at first step
        # flat views in the logical (row-major) order; a param stored in
        # another layout (channels-last) gets a contiguous copy that
        # `_writeback` copies back after each update
        self._views: List[torch.Tensor] = [p.detach().reshape(-1) if p.is_contiguous()
                                           else p.detach().contiguous().reshape(-1)
                                           for p in self._params]
        self._zs = None  # ShardedUpdateSession (sharded mode)
        self._repl_opt = ShardedSGD(self.lr, self.momentum)
        self._repl_state: List[dict] = []
        self._step = 0

    def state_bytes(self) -> int:
        """Optimizer-held bytes on this peer: ~1/k of the replicated
        path's in sharded mode."""
        if self._mode is None:
            self.rebuild(None)
        if self._zs is not None:
            return self._zs.state_bytes()
        return sum(t.nbytes for st in self._repl_state for t in st.values())

    def _bucket_layout(self, sess):
        from kungfu_tpu_torch.collective.zero import bucket_layout

        return bucket_layout([v.numel() for v in self._views], sess.GROUP_BUCKET_BYTES)

    def export_state(self) -> bytes:
        """Full optimizer state as one exact blob (every peer gets the
        same bytes). Both modes serialize the canonical bucket-shaped
        layout, so a resize that flips the resolved mode can restore the
        other mode's blob."""
        if self._mode is None:
            self.rebuild(None)
        if self._zs is not None:
            return self._zs.export_state()
        sess = api.get_default_peer().current_session()
        names = self._repl_opt.state_names()
        leaves = []
        for idxs in self._bucket_layout(sess):
            # replicated mode's masters ARE the current params
            leaves.append(torch.cat([self._views[i].cpu() for i in idxs]))
            for k in names:
                leaves.append(torch.cat([self._repl_state[i][k].cpu() for i in idxs]))
        return pack_leaves(leaves)

    def rebuild(self, restore_state: Optional[bytes] = None) -> None:
        """(Re-)bind to the CURRENT session epoch: lazily at the first
        step, and after an elastic resize with an `export_state` blob
        from before it."""
        from kungfu_tpu_torch.collective.zero import ShardedSGD, ShardedUpdateSession

        sess = api.get_default_peer().current_session()
        if sess.zero_enabled():
            self._mode = "sharded"
            self._zs = ShardedUpdateSession(
                self._views, ShardedSGD(self.lr, self.momentum), name=self.name,
                session=sess, restore_state=restore_state)
            self._repl_state = []
            self._writeback()
            return
        self._mode = "replicated"
        self._zs = None
        self._repl_state = [self._repl_opt.init(v.numel(), device=v.device) for v in self._views]
        if restore_state is None:
            return
        names = self._repl_opt.state_names()
        layout = self._bucket_layout(sess)
        it = iter(unpack_leaves(restore_state, (1 + len(names)) * len(layout)))
        for idxs in layout:
            # canonical layout (see export_state): masters refresh the
            # params, state leaves split back per param
            for k in ("master",) + names:
                full = next(it).to(torch.float32).reshape(-1)
                off = 0
                for i in idxs:
                    n = self._views[i].numel()
                    dst = self._views[i] if k == "master" else self._repl_state[i][k]
                    dst.copy_(full[off:off + n])
                    off += n
        self._writeback()

    def _writeback(self) -> None:
        """Copy the updated flat copies into the params they stand for."""
        with torch.no_grad():
            for p, v in zip(self._params, self._views):
                if v.data_ptr() != p.data_ptr():
                    p.copy_(v.view(p.shape))

    def zero_grad(self) -> None:
        for p in self._params:
            if p.grad is not None:
                p.grad.detach_()
                p.grad.zero_()

    def step(self, closure=None):
        loss = closure() if closure is not None else None
        if self._mode is None:
            self.rebuild(None)
        for i, p in enumerate(self._params):
            if p.grad is None:
                raise RuntimeError(
                    f"param {i} has no gradient — ZeroSGDOptimizer requires every "
                    "registered param to receive a grad each step (the sharded bucket "
                    "layout is fixed)")
        grads = [p.grad.detach().reshape(-1) for p in self._params]
        if self._zs is not None:
            sess = api.get_default_peer().current_session()
            if sess.async_enabled():
                for i, g in enumerate(grads):
                    self._zs.submit_grad(i, g)
                self._zs.flush()
                # the forward after step() reads the params: wait for the
                # tail all-gathers here
                self._zs.wait_params()
            else:
                self._zs.step(grads)
        else:
            if api.cluster_size() > 1:
                sync_gradients(self._params, name=f"{self.name}:{self._step}",
                               _force_sync_engine=True)
                grads = [p.grad.detach().reshape(-1) for p in self._params]
            for v, g, st in zip(self._views, grads, self._repl_state):
                self._repl_opt.apply(v, g, st, 1.0)
        self._writeback()
        self._step += 1
        return loss


def with_no_grad_copy(p: torch.Tensor, arr) -> None:
    """``p.copy_(arr)`` under no_grad, `arr` a tensor or a numpy array of
    `p`'s elements (a 2-byte void array, as ml_dtypes' bfloat16, is read
    as bfloat16, the JAX package's bf16 bridge inverted)."""
    import numpy as np

    if isinstance(arr, np.ndarray):
        arr = np.ascontiguousarray(arr)
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            arr = torch.from_numpy(arr)
    with torch.no_grad():
        p.copy_(arr.view_as(p))


class PairAveragingOptimizer:
    """AD-PSGD for torch (parity: PairAveragingOptimizer): apply the
    local step, then average parameters 0.5/0.5 with a random peer's
    published model through the versioned p2p store."""

    def __init__(self, base, name: str = "torch-pair", rng=None):
        import random

        self.base = base
        self.blob = f"pair-avg-torch:{name}"
        self.rng = rng or random.Random(api.current_rank() * 6007 + 13)
        self._version = 0
        self._published = False

    def _params(self) -> List:
        return [p for g in self.base.param_groups for p in g["params"]]

    def _publish(self) -> None:
        p2p = api.get_default_peer().p2p
        p2p.save_version(self._version, self.blob,
                         pack_leaves([p.detach().reshape(-1) for p in self._params()]))
        self._version += 1

    def _random_peer(self) -> Optional[int]:
        size = api.cluster_size()
        if size <= 1:
            return None
        r = self.rng.randrange(size - 1)
        me = api.current_rank()
        return r + 1 if r >= me else r

    def step(self, closure=None):
        if not self._published:
            # first step: publish and fence so every peer has a model to serve
            self._publish()
            api.run_barrier()
            self._published = True
        out = self.base.step(closure)
        target = self._random_peer()
        if target is not None:
            sess = api.get_default_peer().current_session()
            p2p = api.get_default_peer().p2p
            try:
                data = p2p.request(sess.peers[target], self.blob, timeout=30, version="latest")
            except (ConnectionError, TimeoutError, OSError):
                data = None
            params = self._params()
            leaves: Optional[List[torch.Tensor]] = None
            if data is not None:
                try:
                    leaves = unpack_leaves(bytes(data), len(params))
                except (ValueError, KeyError):
                    leaves = None
            if leaves is not None:
                with torch.no_grad():
                    for p, leaf in zip(params, leaves):
                        p.mul_(0.5).add_(leaf.to(p.device).view_as(p), alpha=0.5)
        self._publish()
        return out

    def __getattr__(self, item):
        return getattr(self.base, item)

"""Ring attention: exact self-attention over a sequence sharded across the
ranks of a process group. Port of `kungfu_tpu/ops/ring_attention.py`.

Rank i of an n-rank group holds block i of the sequence (S_local rows of
Q, K and V). K and V travel around the ring (`ops/collective.py`) while
each rank accumulates its queries' attention over every block; after t
rotations a rank holds the block that started on rank (i - t) mod n.

Two versions, both differentiable:

- `ring_self_attention_plain` is the JAX function line for line: an online
  softmax in f32 over `blk_k`-wide sub-tiles of each held block, with
  autograd through `ring_shift`. It is the oracle.
- `ring_self_attention` runs each block through the flash-attention kernels
  (`ops/flash_attention.py`: the CUDA kernels for CUDA tensors, their plain
  twins for CPU tensors) and merges the partial results by their
  log-sum-exp, so no score tile reaches device memory. Under a causal mask
  it computes only the blocks at or before its own.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.ops import flash_attention as fa

NEG_INF = -1e30  # finite: exp(NEG_INF - NEG_INF) must be well-defined


def _ring_position(group) -> Tuple[int, int]:
    """(this rank's index, the ring's size) in `group`."""
    n = collective.world_size(group)
    return (dist.get_rank(group) if n > 1 else 0), n


def ring_self_attention_plain(q, k, v, group=None, causal: bool = True, blk_k: int = 1024):
    """Exact attention for sequence-sharded q, k, v of shape (B, H, S_local,
    hd); the global sequence is n * S_local with rank i of `group` holding
    block i. Returns the (B, H, S_local, hd) context in q's dtype.

    Within each ring step the held K/V block streams through in
    `blk_k`-wide sub-blocks of an online softmax, so a score tile is
    (S_local, blk_k); a ragged S_local % blk_k shrinks blk_k to the largest
    divisor of S_local. Rotate before compute: n - 1 shifts in all."""
    B, H, Sl, hd = q.shape
    out_dtype = q.dtype
    idx, n = _ring_position(group)
    qf = q.float()
    scale = 1.0 / math.sqrt(hd)
    qpos = idx * Sl + torch.arange(Sl, device=q.device)[:, None]  # global query pos

    blk_k = min(blk_k, Sl)
    while Sl % blk_k:
        blk_k -= 1  # largest divisor of Sl <= requested blk_k
    n_sub = Sl // blk_k

    def sub_accumulate(k_sub, v_sub, kpos, m, l, o):
        """One (Sl, blk_k) score tile of the online softmax."""
        scores = torch.einsum("bhqd,bhkd->bhqk", qf, k_sub.float()) * scale
        if causal:
            mask = kpos <= qpos  # (Sl, blk_k)
            scores = torch.where(mask, scores, NEG_INF)
            maskf = mask.float()
        else:
            maskf = torch.ones(scores.shape[-2:], device=q.device)
        m_new = torch.maximum(m, scores.amax(-1, keepdim=True))
        # p is explicitly zeroed on masked entries: when a tile is fully
        # masked m_new stays NEG_INF and exp(scores - m_new) would be 1
        p = torch.exp(scores - m_new) * maskf
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + torch.einsum("bhqk,bhkd->bhqd", p, v_sub.float())
        return m_new, l, o

    def accumulate(k_blk, v_blk, blk, m, l, o):
        for j in range(n_sub):
            kpos = blk * Sl + j * blk_k + torch.arange(blk_k, device=q.device)[None, :]
            sub = slice(j * blk_k, (j + 1) * blk_k)
            m, l, o = sub_accumulate(k_blk[:, :, sub], v_blk[:, :, sub], kpos, m, l, o)
        return m, l, o

    m = torch.full((B, H, Sl, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, Sl, 1), device=q.device)
    o = torch.zeros((B, H, Sl, hd), device=q.device)
    m, l, o = accumulate(k, v, idx, m, l, o)  # step 0: own block
    kv = torch.stack([k, v])
    for step in range(1, n):
        kv = collective.ring_shift(kv, group)
        # after `step` rotations we hold the block that started at idx - step
        m, l, o = accumulate(kv[0], kv[1], (idx - step) % n, m, l, o)
    # causal attention always has >= 1 unmasked key (the diagonal), so l > 0
    return (o / l).to(out_dtype)


def _block_mask(idx: int, j: int, causal: bool) -> Optional[bool]:
    """How rank `idx`'s queries attend to block `j`: with the causal
    kernel (the diagonal block), without a mask (an earlier block, or any
    block when not causal), or not at all (None: a later block under a
    causal mask, all of whose pairs are masked)."""
    if not causal or j < idx:
        return False
    return True if j == idx else None


def _merge(o, lse, o_j, lse_j):
    """Fold one block's partial (O_j, LSE_j) into the running f32 (O, LSE):
    LSE = logsumexp_j LSE_j, O = sum_j exp(LSE_j - LSE) O_j."""
    o_j = o_j.float()
    if o is None:
        return o_j, lse_j
    new = torch.logaddexp(lse, lse_j)
    return (o * torch.exp(lse - new)[..., None] + o_j * torch.exp(lse_j - new)[..., None],
            new)


class RingFlashAttention(torch.autograd.Function):
    """Ring attention through the flash kernels. Saves only the own block's
    q, k, v, the merged O (in q's dtype) and LSE, so memory per rank stays
    O(S_local). The backward rotates K and V again together with f32 dK/dV
    accumulators, into which each rank adds the block it holds; one more
    shift brings every accumulator home (n shifts of them in all)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal: bool, sm_scale: float):
        B, H, Sl, hd = q.shape
        idx, n = _ring_position(group)
        qf, kf, vf = (t.reshape(B * H, Sl, hd).contiguous() for t in (q, k, v))
        o = lse = None
        kv = torch.stack([kf, vf])
        for t in range(n):
            if t:  # every rank shifts n - 1 times, live block or not
                kv = collective.rotate([kv], group)[0]
            mask = _block_mask(idx, (idx - t) % n, causal)
            if mask is not None:
                o, lse = _merge(o, lse, *fa._forward(qf, kv[0], kv[1], mask, sm_scale))
        o = o.to(q.dtype)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        return o.view(B, H, Sl, hd)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, o, lse = ctx.saved_tensors
        idx, n = _ring_position(ctx.group)
        gf = g.reshape(qf.shape).to(qf.dtype).contiguous()
        dq = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
        dkv = torch.zeros((2, *kf.shape), dtype=torch.float32, device=kf.device)
        kv = torch.stack([kf, vf])
        delta = None
        for t in range(n):
            if t:
                kv, dkv = collective.rotate([kv, dkv], ctx.group)
            mask = _block_mask(idx, (idx - t) % n, ctx.causal)
            if mask is None:
                continue
            # every call against the merged LSE and O of the own queries
            dq_j, delta_j = fa._dq(qf, kv[0], kv[1], o, gf, lse, mask, ctx.sm_scale)
            delta = delta_j if delta is None else delta
            dk_j, dv_j = fa._dkv(qf, kv[0], kv[1], gf, lse, delta, mask, ctx.sm_scale)
            dq += dq_j
            dkv[0] += dk_j
            dkv[1] += dv_j
        if n > 1:
            dkv = collective.rotate([dkv], ctx.group)[0]
        shape = g.shape
        return (dq.to(qf.dtype).view(shape), dkv[0].to(kf.dtype).view(shape),
                dkv[1].to(vf.dtype).view(shape), None, None, None)


def ring_self_attention(q, k, v, group=None, causal: bool = True, blk_k: int = 1024):
    """Exact attention for sequence-sharded (B, H, S_local, hd) q, k, v
    through the flash kernels; same contract as
    `ring_self_attention_plain`. `blk_k` is accepted for that signature and
    unused: the kernels tile each block themselves. On CUDA tensors the
    kernels' own limits hold (head dim, dtype) and the wrappers raise on
    anything else; there is no switch to the plain version."""
    return RingFlashAttention.apply(q, k, v, group, causal, 1.0 / math.sqrt(q.shape[-1]))

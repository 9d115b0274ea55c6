"""Flash attention: fused self-attention with a hand-written CUDA forward,
dQ and dK/dV (csrc/flash_attention.cu), and plain PyTorch twins.

Port of `kungfu_tpu/ops/flash_attention.py`. The forward emits O and the
per-row log-sum-exp (LSE); the backward recomputes exact block
probabilities from the LSE in two kernels (dQ over key tiles, dK/dV over
query tiles), so no (S, S) tensor exists in either direction.

Dispatch is on the tensors' device and nothing else: a CUDA tensor goes to
the kernel (or the wrapper raises), a CPU tensor to the plain version. The
plain versions are also the oracle `chip_smoke.py` holds the kernels
against on the card. `LAUNCHES` counts kernel launches only.

Kernel-level layout: q, k, v, O, dO are contiguous (B*H, S, hd); LSE and
delta = rowsum(dO * O) are (B*H, S) f32. The dQ kernel computes delta
itself and hands it to the dK/dV kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}
_PLAIN_BLK = 64


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# test oracles, (B, H, S, hd) like the JAX package's
# ---------------------------------------------------------------------------

def _dense_reference(q, k, v, causal: bool, sm_scale: float):
    S = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _chunked_reference(q, k, v, causal: bool, sm_scale: float,
                       blk_q: int = 512, blk_k: int = 512):
    """Differentiable online-softmax attention with bounded memory: a loop
    over query chunks, each under activation checkpointing, with the flash
    recurrence over key blocks inside (twin of the JAX `lax.map` +
    `jax.checkpoint` formulation)."""
    B, H, S, hd = q.shape
    blk_q = min(blk_q, S)
    blk_k = min(blk_k, S)
    if S % blk_q or S % blk_k:
        return _dense_reference(q, k, v, causal, sm_scale)
    kf, vf = k.float(), v.float()

    def one_chunk(qc, q_off: int):
        qcf = qc.float()
        qpos = q_off + torch.arange(blk_q, device=q.device)[:, None]
        m = torch.full((B, H, blk_q, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, H, blk_q, 1), device=q.device)
        acc = torch.zeros((B, H, blk_q, hd), device=q.device)
        for k0 in range(0, S, blk_k):
            kb, vb = kf[:, :, k0:k0 + blk_k], vf[:, :, k0:k0 + blk_k]
            s = torch.einsum("bhqd,bhkd->bhqk", qcf, kb) * sm_scale
            if causal:
                mask = (k0 + torch.arange(blk_k, device=q.device))[None, :] <= qpos
                s = torch.where(mask, s, torch.full_like(s, NEG_INF))
                maskf = mask.float()
            else:
                maskf = 1.0
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new) * maskf
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vb)
            m = m_new
        return acc / l

    outs = [
        checkpoint(one_chunk, q[:, :, q0:q0 + blk_q], q0, use_reentrant=False)
        for q0 in range(0, S, blk_q)
    ]
    return torch.cat(outs, dim=2).to(q.dtype)


# ---------------------------------------------------------------------------
# plain versions of the three kernels, (B*H, S, hd), any S and hd
# ---------------------------------------------------------------------------

def _live(k0: int, n: int, S: int, causal: bool, device):
    """(S, n) mask of live (query, key) pairs for keys [k0, k0 + n)."""
    if not causal:
        return None
    qpos = torch.arange(S, device=device)[:, None]
    kpos = k0 + torch.arange(n, device=device)[None, :]
    return kpos <= qpos


def _forward_plain(q, k, v, causal: bool, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) by the tiled online-softmax recurrence of the forward kernel."""
    BH, S, hd = q.shape
    qf = q.float()
    m = torch.full((BH, S, 1), NEG_INF, device=q.device)
    l = torch.zeros((BH, S, 1), device=q.device)
    acc = torch.zeros((BH, S, v.shape[-1]), device=q.device)
    for k0 in range(0, S, _PLAIN_BLK):
        kb = k[:, k0:k0 + _PLAIN_BLK].float()
        vb = v[:, k0:k0 + _PLAIN_BLK].float()
        s = qf @ kb.transpose(1, 2) * sm_scale
        mask = _live(k0, kb.shape[1], S, causal, q.device)
        if mask is not None:
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        if mask is not None:
            p = p * mask
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vb
        m = m_new
    return (acc / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _dq_plain(q, k, v, o, do, lse, causal: bool, sm_scale: float):
    """(dq, delta): dq = sum_k ds k * scale, delta = rowsum(dO * O)."""
    BH, S, hd = q.shape
    delta = (do.float() * o.float()).sum(-1)
    qf, dof = q.float(), do.float()
    dq = torch.zeros((BH, S, hd), device=q.device)
    for k0 in range(0, S, _PLAIN_BLK):
        kb = k[:, k0:k0 + _PLAIN_BLK].float()
        vb = v[:, k0:k0 + _PLAIN_BLK].float()
        p = torch.exp(qf @ kb.transpose(1, 2) * sm_scale - lse[..., None])
        mask = _live(k0, kb.shape[1], S, causal, q.device)
        if mask is not None:
            p = p * mask
        ds = p * (dof @ vb.transpose(1, 2) - delta[..., None])
        dq += ds @ kb
    return (dq * sm_scale).to(q.dtype), delta


def _dkv_plain(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """(dk, dv): dv = sum_q p^T dO, dk = sum_q ds^T q * scale."""
    BH, S, hd = q.shape
    qf, dof = q.float(), do.float()
    dks, dvs = [], []
    for k0 in range(0, S, _PLAIN_BLK):
        kb = k[:, k0:k0 + _PLAIN_BLK].float()
        vb = v[:, k0:k0 + _PLAIN_BLK].float()
        p = torch.exp(qf @ kb.transpose(1, 2) * sm_scale - lse[..., None])
        mask = _live(k0, kb.shape[1], S, causal, q.device)
        if mask is not None:
            p = p * mask
        ds = p * (dof @ vb.transpose(1, 2) - delta[..., None])
        dvs.append(p.transpose(1, 2) @ dof)
        dks.append(ds.transpose(1, 2) @ qf * sm_scale)
    return torch.cat(dks, 1).to(k.dtype), torch.cat(dvs, 1).to(v.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    from kungfu_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_kf_bound", False):
        lib.kf_flash_fwd.argtypes = [_P] * 5 + [_I] * 5 + [_F, _P]
        lib.kf_flash_dq.argtypes = [_P] * 8 + [_I] * 5 + [_F, _P]
        lib.kf_flash_dkv.argtypes = [_P] * 8 + [_I] * 5 + [_F, _P]
        for fn in (lib.kf_flash_fwd, lib.kf_flash_dq, lib.kf_flash_dkv):
            fn.restype = _I
        lib.kf_flash_error_string.argtypes = [_I]
        lib.kf_flash_error_string.restype = ctypes.c_char_p
        lib.kf_flash_occupancy.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        lib.kf_flash_occupancy.restype = _I
        lib._kf_bound = True
    return lib


_KERNEL_CODE = {"flash_fwd": 0, "flash_dq": 1, "flash_dkv": 2}


def occupancy(name: str, hd: int = 64, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Launch resources of one kernel on the current card: dynamic shared
    memory per block, active blocks per SM, registers and spilled (local)
    bytes per thread, as the CUDA runtime reports them."""
    out = (_I * 4)()
    rc = _lib().kf_flash_occupancy(_KERNEL_CODE[name], hd, _DTYPE_CODE[dtype], out)
    if rc != 0:
        msg = _lib().kf_flash_error_string(rc).decode()
        raise RuntimeError(f"{name} occupancy query failed: {msg} (cuda error {rc})")
    return {"smem_bytes": out[0], "blocks_per_sm": out[1], "registers": out[2],
            "local_bytes": out[3]}


def _check(name: str, like: torch.Tensor, **tensors) -> None:
    """Raise on what the kernels do not take: not CUDA, not bf16/fp16, not
    contiguous (B*H, S, hd) with hd in HEAD_DIMS, misaligned, or mixed."""
    if like.dim() != 3:
        raise ValueError(f"{name}: want (B*H, S, hd), got shape {tuple(like.shape)}")
    BH, S, hd = like.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS} on CUDA")
    if like.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {like.dtype} not bf16/fp16 on CUDA")
    if S < 1 or BH < 1 or BH > 65535:
        raise ValueError(f"{name}: B*H={BH}, S={S} outside the kernel's grid")
    for arg, t in tensors.items():
        if not t.is_cuda or t.device != like.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, want {like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")
        if t.dim() == 3:
            if t.shape != like.shape or t.dtype != like.dtype:
                raise ValueError(f"{name}: {arg} is {tuple(t.shape)} {t.dtype}, "
                                 f"want {tuple(like.shape)} {like.dtype}")
        elif t.shape != (BH, S) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} is {tuple(t.shape)} {t.dtype}, "
                             f"want ({BH}, {S}) float32")


def _launch(name: str, fn, like: torch.Tensor, ptrs, causal: bool,
            sm_scale: float) -> None:
    """Enqueue one kernel on the current stream of `like`'s device; raise
    if the launcher reports an error."""
    BH, S, hd = like.shape
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        rc = fn(*[t.data_ptr() for t in ptrs], BH, S, hd,
                _DTYPE_CODE[like.dtype], int(causal), float(sm_scale), stream)
    if rc != 0:
        msg = _lib().kf_flash_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cuda error {rc})")


def _forward_cuda(q, k, v, causal: bool, sm_scale: float):
    _check("flash_fwd", q, q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", _lib().kf_flash_fwd, q, (q, k, v, o, lse), causal, sm_scale)
    LAUNCHES["fwd"] += 1
    return o, lse


def _dq_cuda(q, k, v, o, do, lse, causal: bool, sm_scale: float):
    _check("flash_dq", q, q=q, k=k, v=v, o=o, do=do, lse=lse)
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("flash_dq", _lib().kf_flash_dq, q, (q, k, v, o, do, lse, dq, delta),
            causal, sm_scale)
    LAUNCHES["dq"] += 1
    return dq, delta


def _dkv_cuda(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    _check("flash_dkv", q, q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_dkv", _lib().kf_flash_dkv, q, (q, k, v, do, lse, delta, dk, dv),
            causal, sm_scale)
    LAUNCHES["dkv"] += 1
    return dk, dv


def _by_device(t: torch.Tensor, cuda_fn, plain_fn):
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"flash attention has no path for device {t.device}")


def _forward(q, k, v, causal, sm_scale):
    return _by_device(q, _forward_cuda, _forward_plain)(q, k, v, causal, sm_scale)


def _dq(q, k, v, o, do, lse, causal, sm_scale):
    return _by_device(q, _dq_cuda, _dq_plain)(q, k, v, o, do, lse, causal, sm_scale)


def _dkv(q, k, v, do, lse, delta, causal, sm_scale):
    return _by_device(q, _dkv_cuda, _dkv_plain)(q, k, v, do, lse, delta, causal,
                                                sm_scale)


class FlashAttention(torch.autograd.Function):
    """(B, H, S, hd) q, k, v -> attention context; forward and backward are
    the kernels on CUDA tensors and the plain versions on CPU tensors.
    Saves (q, k, v, O, LSE) for the backward, like the JAX `_fwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        B, H, S, hd = q.shape
        qf, kf, vf = (t.reshape(B * H, S, hd).contiguous() for t in (q, k, v))
        o, lse = _forward(qf, kf, vf, causal, sm_scale)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o.view(B, H, S, hd)

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, o, lse = ctx.saved_tensors
        gf = g.reshape(qf.shape).contiguous()
        dq, delta = _dq(qf, kf, vf, o, gf, lse, ctx.causal, ctx.sm_scale)
        dk, dv = _dkv(qf, kf, vf, gf, lse, delta, ctx.causal, ctx.sm_scale)
        shape = g.shape
        return dq.view(shape), dk.view(shape), dv.view(shape), None, None


def flash_attention(q, k, v, causal: bool = True, sm_scale: float = None):
    """Fused attention for (B, H, S, hd) q/k/v; drop-in for the
    transformer's pluggable attention core. Inputs of any strides are
    made contiguous (B*H, S, hd) first, at the cost of one copy each."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, causal, sm_scale)


def flash_attention_plain(q, k, v, causal: bool = True, sm_scale: float = None):
    """The plain forward on any device, (B, H, S, hd) in and out, without
    autograd: the yardstick `chip_smoke.py` holds the kernel path against."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    B, H, S, hd = q.shape
    qf, kf, vf = (t.reshape(B * H, S, hd) for t in (q, k, v))
    return _forward_plain(qf, kf, vf, causal, sm_scale)[0].view(B, H, S, hd)

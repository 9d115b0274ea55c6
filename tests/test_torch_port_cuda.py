"""The port's CUDA kernels against their plain versions, on the card.

Imports torch only (the card's machine has no JAX), so run it there without
the suite's JAX conftest:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Without a card every test skips: the kernels have no CPU mode.
"""

import threading

import pytest
import torch

from kungfu_tpu_torch.ops import flash_attention as tfa


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _inputs(BH, S, hd, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(BH, S, hd, device="cuda", dtype=dtype, generator=gen)
            for _ in range(4)]


# S: one row, under one tile, one tile, one past it, two tiles, one past,
# ragged at the slice's width, the slice's width, ragged and long.
_SEQS = [1, 17, 64, 65, 128, 129, 500, 512, 1000, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", _SEQS)
def test_cuda_kernels_match_plain(S, causal, hd, dtype):
    """On the card: each kernel against its plain version, at an odd B*H
    (so no head's tiles line up with a power of two)."""
    _need_card()
    q, k, v, do = _inputs(3, S, hd, dtype, seed=S)
    sc = hd ** -0.5
    o, lse = tfa._forward_cuda(q, k, v, causal, sc)
    o_p, lse_p = tfa._forward_plain(q, k, v, causal, sc)
    dq, delta = tfa._dq_cuda(q, k, v, o_p, do, lse_p, causal, sc)
    dq_p, delta_p = tfa._dq_plain(q, k, v, o_p, do, lse_p, causal, sc)
    dk, dv = tfa._dkv_cuda(q, k, v, do, lse_p, delta_p, causal, sc)
    dk_p, dv_p = tfa._dkv_plain(q, k, v, do, lse_p, delta_p, causal, sc)
    for a, b in ((o, o_p), (lse, lse_p), (dq, dq_p), (delta, delta_p), (dk, dk_p), (dv, dv_p)):
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_kernels_are_deterministic(hd):
    """Two launches on the same inputs give bitwise the same outputs: every
    block owns its output rows and sums in a fixed order (no atomics)."""
    _need_card()
    q, k, v, do = _inputs(5, 1000, hd, torch.bfloat16, seed=7)
    sc = hd ** -0.5
    runs = []
    for _ in range(2):
        o, lse = tfa._forward_cuda(q, k, v, True, sc)
        dq, delta = tfa._dq_cuda(q, k, v, o, do, lse, True, sc)
        dk, dv = tfa._dkv_cuda(q, k, v, do, lse, delta, True, sc)
        runs.append((o, lse, dq, delta, dk, dv))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernels_launch_from_a_fresh_thread():
    """A host thread that has not used CUDA yet (as autograd's backward
    thread may be) has no current context; the launchers bind the device
    of their tensors before they encode the TMA tensor maps."""
    _need_card()
    q, k, v, do = _inputs(2, 100, 64, torch.bfloat16, seed=3)
    sc = 64 ** -0.5
    o, lse = tfa._forward_cuda(q, k, v, True, sc)
    _, delta = tfa._dq_cuda(q, k, v, o, do, lse, True, sc)
    calls = [lambda: tfa._forward_cuda(q, k, v, True, sc),
             lambda: tfa._dq_cuda(q, k, v, o, do, lse, True, sc),
             lambda: tfa._dkv_cuda(q, k, v, do, lse, delta, True, sc)]
    errors = []

    def run(fn):
        try:
            fn()
        except RuntimeError as e:
            errors.append(e)

    for fn in calls:
        t = threading.Thread(target=run, args=(fn,))
        t.start()
        t.join()
    torch.cuda.synchronize()
    assert errors == []


@pytest.mark.cuda
def test_cuda_occupancy_of_the_redesigned_kernels():
    """At hd=64 the TMA/wgmma kernels use less shared memory than the
    simple design's carvings (70.5 KB forward, 96.5 KB dQ, 122.5 KB dK/dV),
    dQ and dK/dV run at least two blocks per SM, and none spills."""
    _need_card()
    fwd = tfa.occupancy("flash_fwd", 64)
    dq = tfa.occupancy("flash_dq", 64)
    dkv = tfa.occupancy("flash_dkv", 64)
    assert fwd["smem_bytes"] < 70.5 * 1024 and dkv["smem_bytes"] < 122.5 * 1024
    assert dq["smem_bytes"] < 96.5 * 1024
    assert dq["blocks_per_sm"] >= 2 and dkv["blocks_per_sm"] >= 2
    assert fwd["local_bytes"] == 0 and dq["local_bytes"] == 0 and dkv["local_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_autograd_matches_plain(dtype, hd):
    """FlashAttention forward and backward through the kernels vs the same
    Function on CPU copies (plain versions), with the launch counts."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, g = (torch.randn(2, 3, 200, hd, device="cuda", dtype=dtype, generator=gen)
                  for _ in range(4))
    tfa.reset_launches()
    qc, kc, vc = (t.clone().requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention(qc, kc, vc)
    grads = torch.autograd.grad(out, (qc, kc, vc), g)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == {"fwd": 1, "dq": 1, "dkv": 1}
    qp, kp, vp = (t.cpu().float().requires_grad_() for t in (q, k, v))
    ref = tfa.flash_attention(qp, kp, vp)
    refs = torch.autograd.grad(ref, (qp, kp, vp), g.cpu().float())
    torch.testing.assert_close(out.float().cpu(), ref, rtol=2e-2, atol=2e-2)
    for a, b in zip(grads, refs):
        torch.testing.assert_close(a.float().cpu(), b, rtol=2e-2, atol=2e-2)

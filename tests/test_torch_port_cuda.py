"""The port's CUDA kernels against their plain versions, on the card.

Imports torch only (the card's machine has no JAX), so run it there without
the suite's JAX conftest:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Without a card every test skips: the kernels have no CPU mode.
"""

import os
import socket
import threading
import time

import pytest
import torch
import torch.multiprocessing as mp

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


def _ring_worker(rank, peers, backend):
    """One rank of a ring: gloo ranks share card 0, NCCL ranks own card
    `rank`. The ring kernel path on this rank's block of the sequence
    against the single-process kernel path on the whole of it (the same
    seeded inputs on every rank)."""
    os.environ.update(KF_SELF_SPEC=peers[rank], KF_INIT_PEERS=",".join(peers),
                      KF_DEVICE_SLOTS="0" if backend == "gloo" else str(rank))
    from kungfu_tpu_torch.ops.ring_attention import ring_self_attention
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane

    device = initialize_device_plane(backend=backend)
    n = len(peers)
    try:
        # 125 rows a rank is ragged against the kernels' 64-row tiles
        for sl in (128, 125):
            for hd in (64, 128):
                for causal in (True, False):
                    S = n * sl
                    gen = torch.Generator(device=device).manual_seed(S + hd)
                    q, k, v, do = (torch.randn(2, 3, S, hd, device=device, dtype=torch.bfloat16,
                                               generator=gen) for _ in range(4))
                    full = [t.clone().requires_grad_() for t in (q, k, v)]
                    ref = tfa.flash_attention(*full, causal=causal)
                    refs = (ref, *torch.autograd.grad(ref, full, do))
                    part = slice(rank * sl, (rank + 1) * sl)
                    mine = [t[:, :, part].clone().requires_grad_() for t in (q, k, v)]
                    out = ring_self_attention(*mine, None, causal=causal)
                    outs = (out, *torch.autograd.grad(out, mine, do[:, :, part]))
                    for name, got, want in zip(("O", "dQ", "dK", "dV"), outs, refs):
                        torch.testing.assert_close(
                            got.float(), want[:, :, part].float(), rtol=2e-2, atol=2e-2,
                            msg=lambda m: f"{name} S={S} hd={hd} causal={causal} rank {rank}: {m}")
        torch.cuda.synchronize()
    finally:
        shutdown_device_plane()


def _spawn(fn, n, what, *args):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    peers = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    ctx = mp.start_processes(fn, args=(peers, *args), nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"{what} did not finish in 240 s")


@pytest.mark.cuda
def test_cuda_ring_on_two_gloo_ranks_matches_single_process():
    """The ring kernel path (O, dQ, dK, dV) on two gloo ranks that share
    card 0, against the single-process kernel path: B*H = 6, S = 256 and a
    ragged 250, hd 64 and 128, bf16, causal and not."""
    _need_card()
    from kungfu_tpu_torch.ops import _build

    _build.build_all(["flash_attention"])  # once, before the ranks load it
    _spawn(_ring_worker, 2, "the two ring ranks", "gloo")


@pytest.mark.cuda
def test_cuda_gloo_staging_keeps_one_pinned_buffer_per_role():
    """The gloo ring's pinned host buffers: one per (role, dtype), grown to
    the largest tensor seen and viewed into, so shifts of varying sizes
    hold no more pinned memory than the largest of them."""
    _need_card()
    from kungfu_tpu_torch.ops import collective

    collective._PINNED.clear()
    for rows in (64, 32, 128, 16):
        buf = collective._pinned("send0", torch.empty(rows, 2, device="cuda"))
        assert buf.shape == (rows, 2) and buf.is_pinned()
    assert list(collective._PINNED) == [("send0", torch.float32)]
    assert collective._PINNED["send0", torch.float32].numel() == 256


@pytest.mark.cuda
def test_cuda_ring_over_nccl_matches_single_process():
    """The same on 2 or 4 NCCL ranks, one card each: the rotation goes
    card to card (over NVLink where the cards have it), no host staging."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    from kungfu_tpu_torch.ops import _build

    _build.build_all(["flash_attention"])
    n = 4 if torch.cuda.device_count() >= 4 else 2
    _spawn(_ring_worker, n, f"the {n} NCCL ring ranks", "nccl")


def _nccl_worker(rank, peers):
    os.environ.update(KF_SELF_SPEC=peers[rank], KF_INIT_PEERS=",".join(peers),
                      KF_DEVICE_SLOTS="0")
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane

    with pytest.raises(ValueError, match=r"ranks 0 and 1 are both on card cuda:0"):
        initialize_device_plane()


@pytest.mark.cuda
def test_cuda_nccl_refuses_two_ranks_on_one_card():
    """Two ranks of one host given card 0 under the default backend (NCCL)
    both raise ValueError in initialize_device_plane, before any
    collective."""
    _need_card()
    _spawn(_nccl_worker, 2, "the two NCCL ranks")

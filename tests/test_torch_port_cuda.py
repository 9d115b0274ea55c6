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


def _resnet_pair(images: int, dtype):
    """ResNet-50 with every norm scale 1 (so every residual branch is live),
    in `dtype` on the card and in f32 on the CPU, and one seeded NHWC batch."""
    from kungfu_tpu_torch.models import resnet

    card = resnet.init_resnet(resnet.resnet50(dtype=dtype), torch.Generator().manual_seed(0),
                              "cuda")
    with torch.no_grad():
        for name, p in card.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
    cpu = resnet.resnet50(dtype=torch.float32)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    x = torch.randn(images, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    return card, cpu.to(memory_format=torch.channels_last), x


@pytest.mark.cuda
def test_cuda_resnet50_bf16_matches_cpu_f32():
    """ResNet-50 at full width, 2 images of 224x224, eval mode: the logits
    in bf16 on the card within 2e-2 + 2e-2 |ref| of f32 on the CPU."""
    _need_card()
    card, cpu, x = _resnet_pair(2, torch.bfloat16)
    with torch.no_grad():
        got = card(x.cuda(), train=False)
        want = cpu(x, train=False)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_cuda_resnet50_train_mode_matches_cpu():
    """Training mode normalizes by the batch's own statistics, which at 2
    images are 98 values a channel in the last stage: bf16's rounding
    there moves the logits by up to 0.3 (an H100 run), so this case holds
    the card's f32 path (TF32 off) against the CPU within 1e-3, logits and
    new running statistics."""
    _need_card()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card, cpu, x = _resnet_pair(2, torch.float32)
        with torch.no_grad():
            got = card(x.cuda(), train=True)
            want = cpu(x, train=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    for (name, a), b in zip(card.named_buffers(), cpu.buffers()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_batch_norm_running_stats_are_flaxs(dtype):
    """The norm reads its batch statistics from the private op
    `_native_batch_norm_legit`: one train-mode call on a channels-last
    activation on the card moves the running mean and variance to flax's
    0.9 old + 0.1 (the batch's mean and biased variance, in f32), within
    rtol 1e-5."""
    _need_card()
    from kungfu_tpu_torch.models.resnet import BatchNorm

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn(8, 64, 28, 28, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    norm = BatchNorm(64).cuda()
    norm(x, train=True)
    xf = x.float()
    torch.testing.assert_close(norm.mean, 0.1 * xf.mean(dim=(0, 2, 3)), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(norm.var, 0.9 + 0.1 * xf.var(dim=(0, 2, 3), unbiased=False),
                               rtol=1e-5, atol=1e-6)


def _gloo_collective_worker(rank, peers):
    """reduce_scatter and all_gather_into on CUDA tensors of two gloo ranks
    that share card 0, against the sums and concatenations they must give."""
    os.environ.update(KF_SELF_SPEC=peers[rank], KF_INIT_PEERS=",".join(peers),
                      KF_DEVICE_SLOTS="0")
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane

    device = initialize_device_plane(backend="gloo")
    n = len(peers)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            parts = [torch.arange(12, device=device, dtype=dtype) * (r + 1) for r in range(n)]
            got = collective.reduce_scatter(parts[rank], None)
            assert got.device == device and got.dtype == dtype
            torch.testing.assert_close(got, sum(parts).view(n, -1)[rank])
            out = torch.empty(n * 12, device=device, dtype=dtype)
            assert collective.all_gather_into(out, parts[rank], None) is out
            torch.testing.assert_close(out, torch.cat(parts))
        torch.cuda.synchronize()
    finally:
        shutdown_device_plane()


@pytest.mark.cuda
def test_cuda_gloo_reduce_scatter_and_all_gather_on_one_card():
    _need_card()
    _spawn(_gloo_collective_worker, 2, "the two gloo ranks")


def _zero_nccl_worker(rank, peers):
    """ZeRO-1 against S-SGD over NCCL, one card a rank: an MLP whose leaves
    do not split evenly, 3 AdamW steps on per-rank batches."""
    os.environ.update(KF_SELF_SPEC=peers[rank], KF_INIT_PEERS=",".join(peers),
                      KF_DEVICE_SLOTS=str(rank))
    from kungfu_tpu_torch.models.mlp import init_mlp, mlp_loss
    from kungfu_tpu_torch.optimizers import core
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane
    from kungfu_tpu_torch.parallel.dp import make_train_step
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    device = initialize_device_plane()
    try:
        session = make_mesh(device)
        assert "nccl" in session.describe()
        finals = {}
        for name in ("ssgd", "zero"):
            model = init_mlp(torch.Generator().manual_seed(0), 77, 33, 10, device=device)
            params = list(model.parameters())

            def base(ps):
                return torch.optim.AdamW(ps, lr=1e-2, weight_decay=1e-2)

            opt = (core.zero_sharded(base, params, session) if name == "zero"
                   else core.synchronous_sgd(base(params), session))
            step = make_train_step(lambda m, b: mlp_loss(m.tree(), b), opt, session)
            gen = torch.Generator(device=device).manual_seed(rank)
            for _ in range(3):
                x = torch.randn(8, 77, device=device, generator=gen)
                y = torch.randint(0, 10, (8,), device=device, generator=gen)
                step(model, (x, y))
            finals[name] = torch.cat([p.detach().reshape(-1) for p in params])
            if name == "zero":
                m = [-(-p.numel() // session.size) for p in params]
                assert [s.numel() for s in opt.shards] == m
        torch.testing.assert_close(finals["zero"], finals["ssgd"], rtol=1e-5, atol=1e-6)
    finally:
        shutdown_device_plane()


@pytest.mark.cuda
def test_cuda_zero_over_nccl_matches_ssgd():
    """Needs two or more cards (NCCL refuses two ranks on one)."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("ZeRO over NCCL needs 2+ cards")
    n = 4 if torch.cuda.device_count() >= 4 else 2
    _spawn(_zero_nccl_worker, n, f"the {n} NCCL ZeRO ranks")


def _gloo_all_to_all_worker(rank, peers):
    """all_to_all on CUDA tensors of two gloo ranks that share card 0:
    slice j of the result is slice `rank` of rank j's input, in f32 and
    bf16, and the backward sends the cotangent back the same way."""
    os.environ.update(KF_SELF_SPEC=peers[rank], KF_INIT_PEERS=",".join(peers),
                      KF_DEVICE_SLOTS="0")
    from kungfu_tpu_torch.ops import collective
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane

    device = initialize_device_plane(backend="gloo")
    n = len(peers)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            def sent(r):  # what rank r sends: slice i goes to rank i
                return (torch.arange(n * 3 * 5, device=device, dtype=torch.float32)
                        .view(n, 3, 5) + 100 * r).to(dtype)

            x = sent(rank).requires_grad_()
            y = collective.all_to_all(x)
            assert y.device == device and y.dtype == dtype
            torch.testing.assert_close(y.detach(), torch.stack([sent(j)[rank] for j in range(n)]))
            (g,) = torch.autograd.grad(y, x, sent(rank) * 2)
            torch.testing.assert_close(g, torch.stack([sent(j)[rank] * 2 for j in range(n)]))
        torch.cuda.synchronize()
    finally:
        shutdown_device_plane()


@pytest.mark.cuda
def test_cuda_gloo_all_to_all_on_one_card():
    """gloo's all_to_all takes CUDA tensors itself, so MoE's exchange needs
    no host staging on card-sharing gloo ranks."""
    _need_card()
    _spawn(_gloo_all_to_all_worker, 2, "the two gloo ranks")


def _moe_inputs(n, T, D, F, epd, dtype, device, seed=0):
    E = n * epd
    gen = torch.Generator(device=device).manual_seed(seed)
    xs = torch.randn(n, T, D, device=device, generator=gen).to(dtype)
    rw = torch.randn(D, E, device=device, generator=gen) / D ** 0.5
    w_in = torch.randn(E, D, F, device=device, generator=gen) / D ** 0.5
    w_out = torch.randn(E, F, D, device=device, generator=gen) / F ** 0.5
    cot = torch.randn(n, T, D, device=device, generator=gen)
    return xs, rw, w_in, w_out, cot


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("top_k", [1, 2])
def test_cuda_moe_matches_plain(top_k, dtype):
    """`moe_ffn` (buckets, batched expert einsum, scatter back) on one card
    as a world of one with 8 experts and drops, forward and backward,
    against the plain MoE (each kept token through its expert directly):
    2e-2 in bf16, 1e-4 in f32 (TF32 off)."""
    _need_card()
    from kungfu_tpu_torch.ops import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 products keep f32 sums (no bf16 split-K partial sums, which the
    # two versions would round at different places)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    xs, rw, w_in, w_out, cot = _moe_inputs(1, 512, 128, 256, 8, dtype, "cuda")
    # capacity factor 1.0: C = 64, the mean load, so some expert overflows
    assert moe.dropped_tokens(xs[0], rw, 8, top_k, 1.0) > 0
    outs = []
    for fn in ("port", "plain"):
        leaves = [t.clone().requires_grad_() for t in (xs, rw, w_in, w_out)]
        if fn == "port":
            y, aux = moe.moe_ffn(leaves[0][0], *leaves[1:], None, top_k=top_k,
                                 capacity_factor=1.0)
            y = y[None]
        else:
            y, aux = moe.moe_ffn_plain(*leaves, top_k=top_k, capacity_factor=1.0)
        loss = (y.float() * cot).sum() + 0.01 * aux
        outs.append([y, aux, *torch.autograd.grad(loss, leaves)])
    for got, want in zip(*outs):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _moe_nccl_worker(rank, peers):
    """moe_ffn over n NCCL ranks, one card each, against the plain MoE of
    every shard on each rank: top-2, 2 experts a rank, bf16."""
    os.environ.update(KF_SELF_SPEC=peers[rank], KF_INIT_PEERS=",".join(peers),
                      KF_DEVICE_SLOTS=str(rank))
    from kungfu_tpu_torch.ops import collective, moe
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane

    device = initialize_device_plane()
    n = len(peers)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        xs, rw, w_in, w_out, cot = _moe_inputs(n, 256, 128, 256, 2, torch.bfloat16, device)
        mine = slice(rank * 2, (rank + 1) * 2)
        leaves = [xs[rank].clone().requires_grad_(), rw.clone().requires_grad_(),
                  w_in[mine].clone().requires_grad_(), w_out[mine].clone().requires_grad_()]
        y, aux = moe.moe_ffn(*leaves, None, top_k=2, capacity_factor=1.25)
        loss = (y.float() * cot[rank]).sum() + 0.01 * aux / n
        dx, drw, dwi, dwo = torch.autograd.grad(loss, leaves)
        full = [t.clone().requires_grad_() for t in (xs, rw, w_in, w_out)]
        y_p, aux_p = moe.moe_ffn_plain(*full, top_k=2, capacity_factor=1.25)
        ref = torch.autograd.grad((y_p.float() * cot).sum() + 0.01 * aux_p, full)
        pairs = [(y, y_p[rank]), (aux, aux_p), (dx, ref[0][rank]),
                 (collective.all_reduce(drw), ref[1]), (dwi, ref[2][mine]), (dwo, ref[3][mine])]
        for got, want in pairs:
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
        torch.cuda.synchronize()
    finally:
        shutdown_device_plane()


@pytest.mark.cuda
def test_cuda_moe_over_nccl_matches_plain():
    """Needs two or more cards (NCCL refuses two ranks on one)."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("MoE over NCCL needs 2+ cards")
    n = 4 if torch.cuda.device_count() >= 4 else 2
    _spawn(_moe_nccl_worker, n, f"the {n} NCCL MoE ranks")


def _tp_nccl_worker(rank, peers):
    """BERT-like layers at head dim 64 under tensor parallelism over n NCCL
    ranks (one head a rank), flash core: the loss and the gradients,
    gathered to the dense layout, against the dense flash path on one
    card."""
    os.environ.update(KF_SELF_SPEC=peers[rank], KF_INIT_PEERS=",".join(peers),
                      KF_DEVICE_SLOTS=str(rank))
    from kungfu_tpu_torch.models import convert, transformer as tr
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane
    from kungfu_tpu_torch.parallel.mesh import make_mesh
    from kungfu_tpu_torch.parallel.sharded import gather_params, shard_params

    device = initialize_device_plane()
    n = len(peers)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = tr.TransformerConfig(vocab_size=512, d_model=64 * n, n_heads=n, n_layers=2,
                                   d_ff=128 * n, max_seq=256)
        full = convert.to_jax(tr.init_transformer(cfg, torch.Generator().manual_seed(0), "cpu"))
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, 512, (4, 257), generator=gen).to(device)
        batch = (tokens[:, :-1], tokens[:, 1:])
        dense = convert.transformer_from_jax(full, cfg, device)
        want = tr.transformer_loss(dense.tree(), batch, cfg, core=tfa.flash_attention)
        want.backward()
        session = make_mesh(device, shape={"tp": n})
        specs = tr.param_pspecs(cfg)
        whole = convert.tp_layout(convert.transformer_params_from_jax(full), n)
        model = tr.Transformer(cfg, shard_params(whole, session, specs)).to(device)
        got = tr.tp_transformer_loss(model.tree(), batch, cfg, session,
                                     core=tfa.flash_attention)
        got.backward()
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
        t = model.tree()
        grads = {**{k: t[k].grad for k in convert.TOP_KEYS},
                 "layers": {k: t["layers"][k].grad for k in convert.LAYER_KEYS}}
        grads = convert.to_jax(convert.tp_unlayout(gather_params(grads, session, specs), n))
        ref = convert.grads_to_jax(dense)
        pairs = [(grads[k], ref[k], k) for k in convert.TOP_KEYS]
        pairs += [(grads["layers"][k], ref["layers"][k], k) for k in convert.LAYER_KEYS]
        for g, r, k in pairs:  # bf16 compute: within 2e-2 of each leaf's scale
            err = float(abs(g - r).max())
            assert err <= 2e-2 * float(abs(r).max()), (k, err, float(abs(r).max()))
        torch.cuda.synchronize()
    finally:
        shutdown_device_plane()


@pytest.mark.cuda
def test_cuda_tp_over_nccl_matches_dense():
    """Needs two or more cards (NCCL refuses two ranks on one)."""
    _need_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("tensor parallelism over NCCL needs 2+ cards")
    from kungfu_tpu_torch.ops import _build

    _build.build_all(["flash_attention"])
    n = 4 if torch.cuda.device_count() >= 4 else 2
    _spawn(_tp_nccl_worker, n, f"the {n} NCCL tensor-parallel ranks")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
def test_cuda_staged_host_reduce_matches_the_card_sum(k):
    """Card tensors staged through pinned BufferPool buffers (non_blocking
    copies, synchronized before the host C++ reads them), reduced by the
    port's transform_n on the host and copied back: the card's own sum of
    the same values, in a summation order the test fixes on both sides."""
    _need_card()
    from kungfu_tpu_torch.base import ops
    from kungfu_tpu_torch.utils.pool import BufferPool

    n = 1_000_003
    gen = torch.Generator(device="cuda").manual_seed(k)
    xs = [torch.randn(n, device="cuda", generator=gen) for _ in range(k)]
    pool = BufferPool(pin_memory=True)
    staged = [pool.get(4 * n).view(torch.float32) for _ in range(k)]
    for s, x in zip(staged, xs):
        assert s.is_pinned()
        s.copy_(x, non_blocking=True)
    torch.cuda.synchronize()
    out = pool.get(4 * n).view(torch.float32)
    ops.transform_n(out, staged, ops.ReduceOp.SUM)
    back = out.to("cuda", non_blocking=True)
    want = xs[0].clone()
    for x in xs[1:]:
        want += x  # the C++'s order: ((x0 + x1) + x2) + x3
    torch.cuda.synchronize()
    assert torch.equal(back.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["BF16", "F16"])
def test_cuda_staged_wire_codec_matches_its_plain_twin(wire):
    """The 16-bit codec on card data staged to the host: the C++ encode,
    decode and decode-accumulate bitwise equal to the plain twins, and the
    decoded values equal to the card's own cast."""
    _need_card()
    from kungfu_tpu_torch.base import ops
    from kungfu_tpu_torch.base.dtype import DType
    from kungfu_tpu_torch.utils.pool import BufferPool

    w = DType[wire]
    n = 1_000_003
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(n, device="cuda", generator=gen) * 100
    pool = BufferPool(pin_memory=True)
    src = pool.get(4 * n).view(torch.float32)
    src.copy_(x, non_blocking=True)
    torch.cuda.synchronize()
    enc, enc_plain = (pool.get(2 * n).view(torch.uint16) for _ in range(2))
    ops.encode_wire(enc, src, w)
    ops.encode_wire_plain(enc_plain, src, w)
    assert torch.equal(enc.view(torch.int16), enc_plain.view(torch.int16))
    dec, dec_plain = torch.empty(n), torch.empty(n)
    ops.decode_wire(dec, enc, w)
    ops.decode_wire_plain(dec_plain, enc, w)
    assert torch.equal(dec.view(torch.int32), dec_plain.view(torch.int32))
    cast = x.to(w.to_torch()).float().cpu()  # the card rounds to nearest-even too
    assert torch.equal(dec.view(torch.int32), cast.view(torch.int32))
    acc, acc_plain = src.clone(), src.clone()
    ops.decode_accumulate(acc, 0, n, enc, w, ops.ReduceOp.SUM)
    ops.decode_accumulate_plain(acc_plain, 0, n, enc, w, ops.ReduceOp.SUM)
    assert torch.equal(acc.view(torch.int32), acc_plain.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_host_all_reduce_round_trips_card_tensors_through_pinned_buffers(dtype, monkeypatch):
    """`api.all_reduce_array` on a card's tensor in a world of 3 in-process
    peers: staged to the host through the pinned pool, reduced by the
    engine over the transport, back on the tensor's own card, equal to
    the card's own sum (integer values: exact in either dtype)."""
    _need_card()
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.base.strategy import Strategy
    from kungfu_tpu_torch.peer import Peer
    from kungfu_tpu_torch.plan.peer import PeerID, PeerList
    from kungfu_tpu_torch.runner.env import WorkerConfig

    socks, ports = [], []
    while len(ports) < 3:  # free ports, none in kfrun's 38000-38999
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        if not 38000 <= s.getsockname()[1] < 39000:
            ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    pl = PeerList(PeerID("127.0.0.1", p) for p in ports)
    world = [Peer(WorkerConfig(self_id=me, peers=pl, runners=PeerList(), parent=None,
                               cluster_version=0, strategy=Strategy.STAR, config_server="",
                               elastic_mode="", init_progress=0)) for me in pl]
    tls = threading.local()
    monkeypatch.setattr(api, "get_default_peer", lambda: tls.peer)
    xs = [(torch.arange(3000, device="cuda") % 97 + r).to(dtype).reshape(30, 100)
          for r in range(3)]
    outs, errs = {}, []

    def run(r, fn):
        tls.peer = world[r]
        try:
            outs[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    def all_threads(fn):
        ts = [threading.Thread(target=run, args=(r, fn)) for r in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        if errs:
            raise errs[0]

    try:
        all_threads(lambda r: world[r].start())
        all_threads(lambda r: api.all_reduce_array(xs[r], name="card"))
    finally:
        for p in world:
            p.stop()
    want = sum(x.float() for x in xs).to(dtype)
    for r in range(3):
        got = outs[r]
        assert got.device == xs[r].device and got.dtype == dtype and got.shape == (30, 100)
        assert torch.equal(got, want)
    assert api._pinned_pool().pin_memory and api._pinned_pool().cached_bytes() > 0


def _frontend_worker(rank, peers, out_dir):
    """Two host-plane peers sharing card 0, KF_CONFIG_ASYNC on: S-SGD over
    SGD(0.1, 0.9) by the post-accumulate-grad hooks and by the step-end
    path, then ZeRO-1 sharded and replicated, 4 steps each on per-rank
    batches, one cluster epoch per run; the parameters after each step
    go to `out_dir`."""
    os.environ["KF_CONFIG_ASYNC"] = "on"
    os.environ["KF_CONFIG_GROUP_BUCKET_BYTES"] = str(16 << 10)  # several buckets
    os.environ["KF_CONFIG_SEGMENT_MIN_BYTES"] = "0"
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch import torch as kf
    from kungfu_tpu_torch.base.strategy import Strategy
    from kungfu_tpu_torch.peer import Peer
    from kungfu_tpu_torch.plan.peer import PeerList
    from kungfu_tpu_torch.runner.env import WorkerConfig

    pl = PeerList.parse(",".join(peers))
    peer = Peer(WorkerConfig(self_id=pl[rank], peers=pl, runners=PeerList(), parent=None,
                             cluster_version=0, strategy=Strategy.RING_SEGMENTED,
                             config_server="", elastic_mode="", init_progress=0))
    peer.start()
    api.get_default_peer = lambda: peer
    torch.use_deterministic_algorithms(True)

    def model():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.ReLU(),
                                   torch.nn.Linear(256, 256), torch.nn.ReLU(),
                                   torch.nn.Linear(256, 10)).cuda()

    def train(m, opt):
        out = []
        gen = torch.Generator(device="cuda").manual_seed(rank)
        for _ in range(4):
            x = torch.randn(32, 64, device="cuda", generator=gen)
            y = torch.randn(32, 10, device="cuda", generator=gen)
            opt.zero_grad()
            (m(x) - y).pow(2).mean().backward()
            opt.step()
            out.append(torch.cat([p.detach().reshape(-1) for p in m.parameters()]).cpu())
        return out

    try:
        res = {}
        for run in ("hooks", "step_end", "zero_on", "zero_off"):
            if run != "hooks":  # a fresh epoch: its scheduler registers this run's tensors
                peer.cluster_version += 1
                peer._update_to(pl)
            m = model()
            if run.startswith("zero"):
                peer.current_session().zero_mode = run.split("_")[1]
                opt = kf.ZeroSGDOptimizer(m, lr=0.1, momentum=0.9, name=run)
            else:
                opt = kf.SynchronousSGDOptimizer(
                    torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9), name=run,
                    async_hooks=None if run == "hooks" else False)
            res[run] = train(m, opt)
            res[run + ":mode"] = getattr(opt, "_mode", None) or opt._hooks_installed
            if run == "hooks":
                res["hooks:units"] = peer.current_session().scheduler().stats()["units"]
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        peer.stop()


@pytest.fixture(scope="module")
def frontend_runs(tmp_path_factory):
    _need_card()
    d = tmp_path_factory.mktemp("frontend")
    _spawn(_frontend_worker, 2, "the two frontend peers", str(d))
    return [torch.load(d / f"rank{r}.pt") for r in range(2)]


@pytest.mark.cuda
def test_cuda_ssgd_hook_path_equals_the_step_end_path(frontend_runs):
    """Card gradients staged on autograd's device thread (a copy into a
    pinned buffer, waited for by the scheduler): after every step the hook
    path's parameters are bitwise the step-end path's, on both ranks."""
    for res in frontend_runs:
        assert res["hooks:mode"] is True and res["step_end:mode"] is False
        assert res["hooks:units"] > 0
        for a, b, c in zip(res["hooks"], res["step_end"], frontend_runs[0]["hooks"]):
            assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_zero_sgd_with_card_params_equals_replicated_sgd(frontend_runs):
    """ZeRO-1 over the scheduler with the parameters on the card (host
    masters and mirror, the gathered weights copied back): bitwise the
    replicated update of the same formula, on both ranks."""
    for res in frontend_runs:
        assert res["zero_on:mode"] == "sharded" and res["zero_off:mode"] == "replicated"
        for a, b, c in zip(res["zero_on"], res["zero_off"], frontend_runs[0]["zero_on"]):
            assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_async_api_and_sharded_update_session_on_card_tensors(monkeypatch):
    """`api.group_all_reduce_async` on card tensors (staged by copies the
    scheduler waits for) in a world of 3 in-process peers, then
    `api.sharded_update_session` over card parameters: results back on the
    card, equal to the synchronous group and to replicated SGD (integer
    values: exact in any order)."""
    _need_card()
    monkeypatch.setenv("KF_CONFIG_ASYNC", "on")
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.base.strategy import Strategy
    from kungfu_tpu_torch.peer import Peer
    from kungfu_tpu_torch.plan.peer import PeerID, PeerList
    from kungfu_tpu_torch.runner.env import WorkerConfig

    socks, ports = [], []
    while len(ports) < 3:  # free ports, none in kfrun's 38000-38999
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        if not 38000 <= s.getsockname()[1] < 39000:
            ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    pl = PeerList(PeerID("127.0.0.1", p) for p in ports)
    world = [Peer(WorkerConfig(self_id=me, peers=pl, runners=PeerList(), parent=None,
                               cluster_version=0, strategy=Strategy.RING_SEGMENTED,
                               config_server="", elastic_mode="", init_progress=0))
             for me in pl]
    tls = threading.local()
    monkeypatch.setattr(api, "get_default_peer", lambda: tls.peer)
    shapes = [(30, 100), (7,), (64, 64)]

    def xs(r, rnd):
        return [((torch.arange(int(torch.tensor(s).prod()), device="cuda") * (r + 1) + rnd)
                 % 101).float().reshape(s) for s in shapes]

    outs, errs = {}, []

    def run(r, fn):
        tls.peer = world[r]
        try:
            outs[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    def all_threads(fn):
        ts = [threading.Thread(target=run, args=(r, fn)) for r in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        if errs:
            raise errs[0]

    def async_rounds(r):
        res = []
        for rnd in range(2):
            handles = [api.group_all_reduce_async([x], name=f"c{i}")
                       for i, x in enumerate(xs(r, rnd))]
            api.flush_async()
            res.append([h.wait()[0] for h in handles])
        return res

    def sharded(r):
        params = [torch.full((1000,), 1.0, device="cuda"), torch.full((37,), 2.0, device="cuda")]
        zs = api.sharded_update_session(params, lr=0.5, name="card")
        for rnd in range(2):
            for i, p in enumerate(params):
                zs.submit_grad(i, torch.full_like(p, float(r + rnd)))
            zs.flush()
            zs.wait_params()
        return params

    def next_epoch(r):  # a scheduler registers one tensor set an epoch
        world[r].cluster_version += 1
        world[r]._update_to(pl)

    try:
        all_threads(lambda r: world[r].start())
        all_threads(async_rounds)
        got = dict(outs)
        all_threads(next_epoch)
        all_threads(sharded)
    finally:
        for p in world:
            p.stop()
    for r in range(3):
        for rnd in range(2):
            for g, want in zip(got[r][rnd], [sum(xs(q, rnd)[i] for q in range(3))
                                             for i in range(len(shapes))]):
                assert g.device.type == "cuda" and torch.equal(g, want)
        # mean gradient of round t: (0 + 1 + 2) / 3 + t = 1 + t
        for p, p0 in zip(outs[r], (1.0, 2.0)):
            assert p.device.type == "cuda" and torch.equal(p, torch.full_like(p, p0 - 0.5 - 1.0))


@pytest.mark.cuda
def test_elastic_state_leaves_on_the_card_round_trip_through_pinned_buffers():
    """ElasticState's sync on card leaves: packed through the api's pinned
    pool (channels-last and bf16 leaves among them), unpacked into new
    tensors on the card of each old leaf's dtype and shape, bit for bit."""
    _need_card()
    from kungfu_tpu_torch.base.serialize import pack_leaves, unpack_leaves
    from kungfu_tpu_torch.elastic.state import _host_leaves, _like, tree_flatten

    gen = torch.Generator(device="cuda").manual_seed(7)
    state = {"w": torch.randn(8, 4, 3, 3, device="cuda", generator=gen).to(
                 memory_format=torch.channels_last),
             "b": torch.randn(5, device="cuda", generator=gen).bfloat16(),
             "n": torch.arange(6, device="cuda").reshape(2, 3),
             "step": torch.tensor([9]), "lr": 0.25}
    leaves, unflatten = tree_flatten(state)
    host, staged = _host_leaves(leaves)
    try:
        blob = pack_leaves(host)
    finally:
        from kungfu_tpu_torch import api
        api._release(staged)
    zeros = [torch.zeros_like(x) if isinstance(x, torch.Tensor) else 0.0 for x in leaves]
    back = unflatten([_like(nl, ol) for nl, ol in zip(unpack_leaves(blob, len(leaves)), zeros)])
    for k in ("w", "b", "n", "step"):
        assert back[k].device == state[k].device and back[k].dtype == state[k].dtype
        assert torch.equal(back[k], state[k]), k
    assert float(back["lr"]) == 0.25


@pytest.mark.cuda
def test_a_checkpoint_of_card_tensors_restores_onto_the_card(tmp_path):
    """The Checkpointer on card leaves (channels-last, bf16, int64 among
    them): staged through the api's pinned pool, restored onto the card
    with each leaf's dtype, shape and device, bit for bit; the window and
    dump_final_variables's bytes as on the CPU."""
    _need_card()
    from kungfu_tpu_torch.base.serialize import pack_leaves
    from kungfu_tpu_torch.elastic.checkpoint import Checkpointer, dump_final_variables
    from kungfu_tpu_torch.elastic.state import tree_flatten

    gen = torch.Generator(device="cuda").manual_seed(11)

    def state(v):
        return {"w": (torch.randn(8, 4, 3, 3, device="cuda", generator=gen) + v).to(
                    memory_format=torch.channels_last),
                "b": torch.randn(5, device="cuda", generator=gen).bfloat16(),
                "n": torch.arange(6, device="cuda").reshape(2, 3) * v,
                "step": torch.tensor([v])}

    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2, save_rank=None)
    saved = {v: state(v) for v in (1, 2, 3)}
    for v, s in saved.items():
        assert ckpt.save(v, s)
    assert ckpt.all_steps() == [2, 3]
    like = {k: torch.zeros_like(x) for k, x in saved[3].items()}
    back, start = ckpt.restore_or(like)
    assert start == 3
    for k, want in saved[3].items():
        assert back[k].device == want.device and back[k].dtype == want.dtype
        assert back[k].shape == want.shape and torch.equal(back[k], want), k
    dump_final_variables(str(tmp_path / "v.kf"), saved[2])
    leaves, _ = tree_flatten(saved[2])
    assert (tmp_path / "v.kf").read_bytes() == pack_leaves([x.cpu() for x in leaves])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_pair_averagings_f32_average_on_the_card_is_the_cpu_formula(dtype):
    """PairAveraging's 0.5 (p + o) at f32, rounded back to the parameter's
    dtype, on the card bit for bit the same formula on the CPU."""
    _need_card()
    from kungfu_tpu_torch.optimizers.pair_averaging import PairAveraging

    gen = torch.Generator().manual_seed(5)
    p = (torch.randn(4097, generator=gen) * 10.0 ** torch.randint(-3, 3, (4097,),
                                                                  generator=gen)).to(dtype)
    o = (torch.randn(4097, generator=gen) * 10.0 ** torch.randint(-3, 3, (4097,),
                                                                  generator=gen)).to(dtype)
    want = (0.5 * (p.float() + o.float())).to(dtype)
    pa = PairAveraging.__new__(PairAveraging)
    leaves = [p.cuda()]
    pa._average(leaves, [o])  # the fetched leaf arrives on the host
    assert leaves[0].device.type == "cuda" and leaves[0].dtype == dtype
    assert torch.equal(leaves[0].cpu(), want)

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

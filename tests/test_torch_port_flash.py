"""Parity of the port's flash attention (kungfu_tpu_torch/ops/flash_attention.py)
with the JAX package's Pallas kernels, run as its own tests run them: in
interpret mode on the CPU. Inputs are made with numpy from a seed and fed to
both. On the CPU the port takes its plain versions; the CUDA kernels are
held against those on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kungfu_tpu_torch.ops import flash_attention as tfa

# the module, not the function `kungfu_tpu.ops` re-exports under its name
jfa = importlib.import_module("kungfu_tpu.ops.flash_attention")


def _arrays(B=2, H=3, S=64, hd=16, seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, hd)).astype(np.float32) for _ in range(n)]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blk", [16, 32])
def test_forward_and_lse_match_jax(causal, blk):
    q, k, v, _ = _arrays()
    B, H, S, hd = q.shape
    scale = 1.0 / np.sqrt(hd)
    out_j, lse_j = jfa._forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal, scale, blk, blk, True, with_lse=True)
    flat = [_t(x).reshape(B * H, S, hd) for x in (q, k, v)]
    out, lse = tfa._forward_plain(*flat, causal, scale)
    np.testing.assert_allclose(out.reshape(B, H, S, hd).numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[..., 0],
                               rtol=1e-5, atol=1e-5)
    public = tfa.flash_attention(*(_t(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(public.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)


def _grads_both(q, k, v, g, causal, blk, dtype=torch.float32):
    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal, None, blk, blk, True)
        return jnp.sum(out.astype(jnp.float32) * g)

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jargs = [jnp.asarray(x).astype(jdt) for x in (q, k, v)]
    out_j = jfa.flash_attention(*jargs, causal, None, blk, blk, True)
    grads_j = jax.grad(loss, argnums=(0, 1, 2))(*jargs)
    targs = [_t(x, dtype).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*targs, causal)
    grads = torch.autograd.grad(out.float(), targs, _t(g))
    return out, out_j, grads, grads_j


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,blk", [(64, 16), (64, 32), (24, 16)])
def test_gradients_match_jax(causal, S, blk):
    """S=24 is ragged for blk=16: JAX falls back to dense + chunked vjp, the
    port masks the tail; both must give the same values and gradients."""
    q, k, v, g = _arrays(B=1, H=2, S=S, hd=8, seed=1)
    out, out_j, grads, grads_j = _grads_both(q, k, v, g, causal, blk)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    for a, b in zip(grads, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_bf16_matches_jax():
    q, k, v, g = _arrays(B=2, H=2, S=64, hd=16, seed=2)
    out, out_j, grads, grads_j = _grads_both(q, k, v, g, True, 32, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(out_j, np.float32), rtol=2e-2, atol=2e-2)
    for a, b in zip(grads, grads_j):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_references_agree(causal):
    """The port's test oracles agree with each other and with JAX's."""
    q, k, v = _arrays(B=1, H=2, S=64, hd=8, seed=3, n=3)
    sm = 1.0 / np.sqrt(8)
    dense = tfa._dense_reference(*(_t(x) for x in (q, k, v)), causal, sm)
    chunked = tfa._chunked_reference(*(_t(x) for x in (q, k, v)), causal, sm, 16, 16)
    ref_j = jfa._dense_reference(*(jnp.asarray(x) for x in (q, k, v)), causal, sm)
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(ref_j), rtol=1e-5, atol=1e-6)

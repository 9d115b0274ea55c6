"""Parity of the port's transformer (kungfu_tpu_torch/models/transformer.py)
with the JAX package's: logits, loss and every parameter gradient, with the
parameters carried over by kungfu_tpu_torch/models/convert.py, for the dense
core and for the flash core (JAX's Pallas kernels in interpret mode). Also
the places where the two frameworks' defaults differ (tanh GELU, the
RMSNorm cast order, bf16 rounding)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kungfu_tpu.models import transformer as jtr
from kungfu_tpu_torch.models import convert
from kungfu_tpu_torch.models import transformer as ttr
from kungfu_tpu_torch.ops.flash_attention import flash_attention

jfa = importlib.import_module("kungfu_tpu.ops.flash_attention")

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq=32)
TINY = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq=64)


def _configs(dims, f32: bool):
    jcfg = jtr.TransformerConfig(**dims, dtype=jnp.float32 if f32 else jnp.bfloat16)
    tcfg = ttr.TransformerConfig(**dims, dtype=torch.float32 if f32 else torch.bfloat16)
    return jcfg, tcfg


def _setup(dims, f32=True, B=2, S=32, seed=0):
    jcfg, tcfg = _configs(dims, f32)
    params = jax.tree.map(np.asarray, jtr.init_transformer(jax.random.PRNGKey(seed), jcfg))
    model = convert.transformer_from_jax(params, tcfg, "cpu")
    tokens = np.random.default_rng(seed).integers(0, dims["vocab_size"], (B, S + 1)).astype(np.int32)
    return jcfg, tcfg, params, model, tokens


def _jax_flash_core(q, k, v):
    return jfa.flash_attention(q, k, v, True, None, 16, 16, True)


def _jax_hidden_with_core(params, tokens, cfg, core):
    """The JAX package's flash composition (tests/test_flash_attention.py)."""
    S = tokens.shape[1]
    x = params["embed"].astype(cfg.dtype)[tokens] + params["pos_embed"].astype(cfg.dtype)[:S]

    def body(x, layer):
        return jtr._block(x, layer, cfg, core=core), None

    x, _ = jax.lax.scan(body, x, params["layers"])
    return x


def _jax_fns(core):
    if core is None:
        return jtr.transformer_apply, jtr.transformer_loss

    def apply(params, tokens, cfg):
        x = jtr._rmsnorm(_jax_hidden_with_core(params, tokens, cfg, core), params["ln_f_scale"])
        return x.astype(jnp.float32) @ params["embed"].astype(jnp.float32).T

    def loss(params, batch, cfg):
        x = _jax_hidden_with_core(params, batch[:, :-1], cfg, core)
        return jtr.lm_head_loss(params, x, batch[:, 1:], cfg)

    return apply, loss


def _assert_tree_close(a, b, rtol, atol):
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(flat_a) == len(flat_b)
    for path, x in flat_a:
        np.testing.assert_allclose(x, np.asarray(flat_b[path], np.float32), rtol=rtol,
                                   atol=atol, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dims", [TINY, SMALL], ids=["tiny", "small"])
@pytest.mark.parametrize("core", ["dense", "flash"])
def test_f32_logits_loss_grads_match_jax(dims, core):
    jcfg, tcfg, params, model, tokens = _setup(dims, S=32)
    jcore, tcore = (None, None) if core == "dense" else (_jax_flash_core, flash_attention)
    japply, jloss = _jax_fns(jcore)

    logits_j = japply(params, jnp.asarray(tokens[:, :-1]), jcfg)
    logits = ttr.transformer_apply(model.tree(), torch.from_numpy(tokens[:, :-1]), tcfg, core=tcore)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), rtol=1e-4, atol=1e-4)

    loss_j, grads_j = jax.value_and_grad(jloss)(params, jnp.asarray(tokens), jcfg)
    loss = ttr.transformer_loss(model.tree(), torch.from_numpy(tokens), tcfg, core=tcore)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4, atol=1e-4)
    _assert_tree_close(convert.grads_to_jax(model), grads_j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("core", ["dense", "flash"])
def test_bf16_tiny_logits_match_jax(core):
    """bf16 compute: each core against its own JAX counterpart (the dense
    core rounds probabilities to bf16, the flash path keeps them f32)."""
    jcfg, tcfg, params, model, tokens = _setup(TINY, f32=False, S=32, seed=1)
    jcore, tcore = (None, None) if core == "dense" else (_jax_flash_core, flash_attention)
    japply, _ = _jax_fns(jcore)
    logits_j = japply(params, jnp.asarray(tokens[:, :-1]), jcfg)
    with torch.no_grad():
        logits = ttr.transformer_apply(model.tree(), torch.from_numpy(tokens[:, :-1]), tcfg,
                                       core=tcore)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=2e-2, atol=2e-2)


def test_params_round_trip():
    _, tcfg, params, model, _ = _setup(SMALL)
    _assert_tree_close(convert.to_jax(model), params, rtol=0, atol=0)
    assert set(model.state_dict()) == {"embed", "pos_embed", "ln_f_scale"} | {
        f"layers.{k}" for k in ttr.LAYER_KEYS}


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(F.gelu(torch.from_numpy(x), approximate="tanh").numpy(), ref,
                               rtol=1e-6, atol=1e-6)
    # torch's default (erf) differs: the port must not use it
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - ref).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_cast_order(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ref = jtr._rmsnorm(jnp.asarray(x).astype(jdt), jnp.asarray(scale))
    out = ttr._rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale))
    assert out.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 8e-3  # one bf16 rounding step
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_qkv_split_layout():
    """The fused projection splits into contiguous thirds, each reshaped
    to (B, S, H, hd): q of head h is columns [h*hd, (h+1)*hd) of the first
    third."""
    cfg = ttr.TransformerConfig(**SMALL, dtype=torch.float32)
    x = torch.randn(1, 4, cfg.d_model, dtype=torch.float64).float()
    wqkv = torch.randn(cfg.d_model, 3 * cfg.d_model)
    seen = {}

    def core(q, k, v):
        seen.update(q=q, k=k, v=v)
        return q

    ttr._attention(x, wqkv, torch.eye(cfg.d_model), cfg, core=core)
    D, hd = cfg.d_model, cfg.head_dim
    full = x @ wqkv
    for i, name in enumerate("qkv"):
        for h in range(cfg.n_heads):
            torch.testing.assert_close(seen[name][0, h], full[0, :, i * D + h * hd:i * D + (h + 1) * hd])

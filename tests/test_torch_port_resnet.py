"""Parity of the port's ResNet (kungfu_tpu_torch/models/resnet.py) with the
flax model of kungfu_tpu/models/resnet.py on the CPU, both in float32 from
the same numpy parameters (flax's initialization, every leaf moved by
N(0, 0.05^2) so that no norm scale is 0 and every residual branch is live),
carried across by `models/convert.py::resnet_from_jax`:

- `resnet18_thin` ([1, 1], 8 filters) and a narrow ResNet-50 ([3, 4, 6, 3],
  4 filters), at an even side (32, where XLA's "SAME" pads a stride-2 3x3
  window (0, 1)) and an odd one (30, where it pads (1, 1)), batch 8:
  training-mode logits, loss and the new running statistics within
  rtol = atol = 1e-5, every parameter's gradient within rtol 1e-5 and atol
  1e-5 times the leaf's largest magnitude; eval-mode logits;
- the space-to-depth stem against the plain stem, and against flax's;
- bf16 compute against flax's bf16 within 2e-2 (the repo's bf16 tolerance);
- "SAME" padding, the max pool and one BatchNorm layer on their own;
- the converter's round trip, and torch's init statistics against flax's.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from kungfu_tpu.models import resnet as jr
from kungfu_tpu_torch.models import convert
from kungfu_tpu_torch.models import resnet as tr

BATCH, CLASSES, PERTURB = 8, 10, 0.05
MODELS = {"thin": ([1, 1], 8), "r50_narrow": ([3, 4, 6, 3], 4)}
CONFIGS = [(m, side) for m in MODELS for side in (32, 30)]
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def _two_threads():
    """Keep torch's CPU work to two threads: the suite runs beside
    multi-process tests that are sensitive to a loaded host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ids(cases):
    return [f"{m}-{side}" for m, side in cases]


def _flax(model, dtype=jnp.float32, s2d=False):
    stages, nf = MODELS[model]
    return jr.ResNet(stage_sizes=stages, num_classes=CLASSES, num_filters=nf, dtype=dtype,
                     s2d_stem=s2d)


@functools.lru_cache(maxsize=None)
def _variables(model, side):
    params, stats = jr.init_resnet(jax.random.PRNGKey(0), _flax(model), side, 2)
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda p: (np.asarray(p) + PERTURB * rng.standard_normal(p.shape)).astype(np.float32),
        params)
    stats = jax.tree.map(
        lambda s: (np.asarray(s) + PERTURB * np.abs(rng.standard_normal(s.shape)))
        .astype(np.float32), stats)
    return params, stats


def _batch(side):
    rng = np.random.default_rng(side)
    return (rng.standard_normal((BATCH, side, side, 3)).astype(np.float32),
            rng.integers(0, CLASSES, BATCH).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_train(model, side, dtype=jnp.float32):
    jm = _flax(model, dtype)
    params, stats = _variables(model, side)
    x, y = _batch(side)

    def loss_fn(p):
        logits, upd = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                               mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        loss = -jnp.mean(jnp.sum(jax.nn.one_hot(y, CLASSES) * logp, axis=-1))
        return loss, (logits, upd["batch_stats"])

    (loss, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    # the JAX package's own loss function, for the loss and the statistics
    ref_loss, ref_stats = jr.resnet_loss(jm, params, stats, (x, y))
    np.testing.assert_allclose(float(ref_loss), float(loss),
                               rtol=1e-6 if dtype == jnp.float32 else 2e-2)
    return (float(loss), np.asarray(logits), jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, ref_stats))


@functools.lru_cache(maxsize=None)
def _jax_eval(model, side, dtype=jnp.float32, s2d=False):
    params, stats = _variables(model, side)
    out = _flax(model, dtype, s2d).apply({"params": params, "batch_stats": stats},
                                         _batch(side)[0], train=False)
    return np.asarray(out, np.float32)


def _port(model, side, dtype=torch.float32, s2d=False):
    stages, nf = MODELS[model]
    m = tr.ResNet(stages, CLASSES, nf, dtype, s2d)
    m.load_state_dict(convert.resnet_from_jax(*_variables(model, side)))
    return m.to(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _port_train(model, side, dtype=torch.float32):
    m = _port(model, side, dtype)
    x, y = (torch.from_numpy(a) for a in _batch(side))
    with torch.no_grad():  # the logits, from a second copy (its statistics move too)
        logits = _port(model, side, dtype)(x, train=True)
    loss = tr.resnet_loss(m, (x, y))
    loss.backward()
    grads, _ = convert.resnet_to_jax({n: p.grad for n, p in m.named_parameters()})
    _, stats = convert.resnet_to_jax(dict(m.named_buffers()))
    return float(loss), logits.detach().float().numpy(), grads, stats


def _leaves(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees(got, want, tol, what, scaled=False):
    """Leaf by leaf; `scaled` takes atol relative to the leaf's largest
    magnitude."""
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want), what
    for k in want:
        t = dict(tol, atol=tol["atol"] * max(1.0, float(np.abs(want[k]).max()))) if scaled else tol
        np.testing.assert_allclose(got[k], want[k], **t, err_msg=f"{what} {k}")


@pytest.mark.parametrize("model,side", CONFIGS, ids=_ids(CONFIGS))
def test_train_logits_and_loss_match_flax(model, side):
    loss, logits, _, _ = _jax_train(model, side)
    p_loss, p_logits, _, _ = _port_train(model, side)
    np.testing.assert_allclose(p_logits, logits, **TOL)
    np.testing.assert_allclose(p_loss, loss, **TOL)


@pytest.mark.parametrize("model,side", CONFIGS, ids=_ids(CONFIGS))
def test_every_gradient_matches_flax(model, side):
    """Within 1e-5 of each leaf's largest gradient: the stem's kernel
    gradient (up to ~2.5) sums f32 rounding over every layer and pixel."""
    _, _, grads, _ = _jax_train(model, side)
    _assert_trees(_port_train(model, side)[2], grads, TOL, "grad", scaled=True)


@pytest.mark.parametrize("model,side", CONFIGS, ids=_ids(CONFIGS))
def test_running_statistics_match_flax(model, side):
    """Flax's momentum 0.9 and the biased batch variance (the unbiased one
    would be n/(n-1) larger)."""
    _, _, _, stats = _jax_train(model, side)
    _assert_trees(_port_train(model, side)[3], stats, TOL, "batch_stats")


@pytest.mark.parametrize("model,side", CONFIGS, ids=_ids(CONFIGS))
def test_eval_logits_match_flax(model, side):
    with torch.no_grad():
        got = _port(model, side)(torch.from_numpy(_batch(side)[0]), train=False)
    np.testing.assert_allclose(got.numpy(), _jax_eval(model, side), **TOL)


@pytest.mark.parametrize("side", [32, 30])
def test_s2d_stem_matches_plain_stem_and_flax(side):
    """At an even side the space-to-depth stem is exact against the plain
    7x7/s2 convolution on the same kernel; at an odd side both models fall
    back to the plain stem."""
    x = torch.from_numpy(_batch(side)[0])
    with torch.no_grad():
        s2d = _port("thin", side, s2d=True)(x, train=False).numpy()
        plain = _port("thin", side)(x, train=False).numpy()
    np.testing.assert_allclose(s2d, plain, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(s2d, _jax_eval("thin", side, s2d=True), rtol=2e-5, atol=2e-5)


def test_s2d_stem_refuses_an_odd_side():
    stem = tr.SpaceToDepthStem(3, 8, torch.float32)
    with pytest.raises(ValueError, match="even"):
        stem(torch.zeros(1, 3, 31, 32))


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_bf16_matches_flax_bf16(mode):
    if mode == "train":
        _, want, _, _ = _jax_train("thin", 32, jnp.bfloat16)
        _, got, _, _ = _port_train("thin", 32, torch.bfloat16)
    else:
        want = _jax_eval("thin", 32, jnp.bfloat16)
        with torch.no_grad():
            got = _port("thin", 32, torch.bfloat16)(
                torch.from_numpy(_batch(32)[0]), train=False).numpy()
    assert got.dtype == np.float32  # the head computes in f32
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("n", [28, 29, 30, 31, 32, 112, 224])
@pytest.mark.parametrize("k,s", [(1, 1), (1, 2), (3, 1), (3, 2), (7, 2)])
def test_same_padding_matches_xla(n, k, s):
    assert tr.same_pads(n, k, s) == tuple(lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


@pytest.mark.parametrize("side", [31, 32])
def test_max_pool_matches_flax(side):
    rng = np.random.default_rng(side)
    x = rng.standard_normal((2, side, side, 3)).astype(np.float32) - 3.0  # padding must not win
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    (hl, hh), (wl, wh) = (tr.same_pads(side, 3, 2),) * 2
    got = F.max_pool2d(F.pad(xt, (wl, wh, hl, hh), value=-np.inf), 3, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_layer_matches_flax(train):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 4, 4, 6)).astype(np.float32) * 2 + 1  # NHWC
    variables = {"params": {"scale": rng.standard_normal(6).astype(np.float32),
                            "bias": rng.standard_normal(6).astype(np.float32)},
                 "batch_stats": {"mean": rng.standard_normal(6).astype(np.float32),
                                 "var": rng.random(6).astype(np.float32) + 0.5}}
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                       dtype=jnp.float32)
    want, upd = bn.apply(variables, x, mutable=["batch_stats"])
    layer = tr.BatchNorm(6)
    with torch.no_grad():
        for k, v in {**variables["params"], **variables["batch_stats"]}.items():
            getattr(layer, k).copy_(torch.from_numpy(v))
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2), train)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(layer, k).numpy(), np.asarray(upd["batch_stats"][k]),
                                   **TOL, err_msg=k)


def test_converter_round_trip():
    params, stats = _variables("r50_narrow", 32)
    m = _port("r50_narrow", 32)
    p2, s2 = convert.resnet_to_jax(m.state_dict())
    _assert_trees(p2, params, dict(rtol=0, atol=0), "params")
    _assert_trees(s2, stats, dict(rtol=0, atol=0), "batch_stats")
    # tree() and stats_tree() are flax's trees, leaf for leaf
    assert sorted(_leaves(m.tree())) == sorted(_leaves(params))
    assert sorted(_leaves(m.stats_tree())) == sorted(_leaves(stats))


def test_init_matches_flax_statistics():
    """Truncated lecun-normal kernels, unit/zero norms, the last norm of
    each block at scale 0, running mean 0 and var 1."""
    params, stats = jr.init_resnet(jax.random.PRNGKey(0), _flax("r50_narrow"), 32, 2)
    m = tr.init_resnet(_port("r50_narrow", 32), torch.Generator().manual_seed(0), "cpu")
    got = _leaves(convert.resnet_to_jax(m.state_dict())[0])
    for k, v in _leaves(params).items():
        v, g = np.asarray(v), got[k]
        if "kernel" in k:
            fan_in = int(np.prod(v.shape[:-1]))
            std = 1 / np.sqrt(fan_in) / 0.87962566103423978
            assert np.abs(g).max() <= 2 * std + 1e-7, k
            if v.size >= 256:
                np.testing.assert_allclose(g.std(), v.std(), rtol=0.25, err_msg=k)
        else:
            np.testing.assert_array_equal(g, v, err_msg=k)
    for k, v in _leaves(convert.resnet_to_jax(m.state_dict())[1]).items():
        np.testing.assert_array_equal(v, np.asarray(_leaves(stats)[k]), err_msg=k)

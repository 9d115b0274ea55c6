"""BERT SMA over the host plane (`kungfu_tpu_torch/examples/bert_sma.py`)
against the JAX package's example (`examples/bert_sma.py`, loaded by
path): its masked-LM loss under `jax.jit(value_and_grad)` and optax's
AdamW (lr 3e-4, weight decay 0.01), then the blend
``l + alpha * (s / n - l)`` in numpy on the cluster sum.

The tiny config in f32 (the JAX example's shapes, without the bf16
compute that would hide a parity fault in rounding), the JAX package's
seed-0 parameters carried into the port with `models/convert.py`, the
same per-rank batches (seed 1234 + rank). The port runs `main` on each
thread of an in-process world of port peers, over the host plane; the
JAX side sums the ranks' parameters in numpy (at k 2 the host plane's
sum a + b is the same bits in any order). Tolerance after 3 steps:
losses within 1e-5 (relative and absolute), as
tests/test_torch_port_train.py holds S-SGD; parameters within 1e-5
relative plus lr / 10 = 3e-5 absolute, since AdamW's first steps move a
weight by lr·g/(|g| + eps), which turns the last-bit differences of a
near-zero gradient into up to a few 1e-5 (seen: 1.1e-5 on one of 8192
`wo` weights, under 2.2e-6 elsewhere). The blend alone is held bit for
bit against the reference's numpy expression."""

import functools
import importlib.util
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu.models import transformer as jtr
from kungfu_tpu_torch import api
from kungfu_tpu_torch.examples import bert_sma
from kungfu_tpu_torch.models import convert
from kungfu_tpu_torch.models.transformer import TransformerConfig
from test_torch_port_worlds import (  # noqa: F401 - fixtures used by name
    make_world, run_all, small_arenas)

REPO = Path(__file__).resolve().parent.parent
STEPS, BATCH, SEQ, ALPHA = 3, 4, 16, 0.1
TOL = 1e-5
PARAM_ATOL = 3e-4 / 10  # lr / 10: see the module docstring


def _reference():
    spec = importlib.util.spec_from_file_location("reference_bert_sma",
                                                  REPO / "examples" / "bert_sma.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def jax_cfg():
    return jtr.TransformerConfig.tiny().__class__(
        **{f: getattr(jtr.TransformerConfig.tiny(), f) for f in
           ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff", "max_seq")},
        dtype=jnp.float32)


def port_cfg():
    t = TransformerConfig.tiny()
    return TransformerConfig(vocab_size=t.vocab_size, d_model=t.d_model, n_heads=t.n_heads,
                             n_layers=t.n_layers, d_ff=t.d_ff, max_seq=t.max_seq,
                             dtype=torch.float32)


@pytest.fixture(scope="module")
def init_params():
    return jax.tree.map(np.asarray, jtr.init_transformer(jax.random.PRNGKey(0), jax_cfg()))


def jax_run(params0, k, steps=STEPS):
    """The JAX example's loop for k ranks: jitted AdamW step per rank,
    then the numpy blend on the sum. Returns the losses and final params
    of each rank."""
    cfg = jax_cfg()
    opt = optax.adamw(3e-4, weight_decay=0.01)

    @jax.jit
    def local_step(params, opt_state, inputs, targets, mask):
        loss, grads = jax.value_and_grad(REF.mlm_loss)(params, inputs, targets, mask, cfg)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    rngs = [np.random.default_rng(1234 + r) for r in range(k)]
    params = [jax.tree.map(jnp.asarray, params0) for _ in range(k)]
    states = [opt.init(p) for p in params]
    losses = [[] for _ in range(k)]
    batches = [REF.synthetic_batch(rngs[r], cfg, BATCH, SEQ) for r in range(k)]
    for _ in range(steps):
        for r in range(k):
            params[r], states[r], loss = local_step(params[r], states[r], *batches[r])
            losses[r].append(float(loss))
        if k > 1:
            flat = [[np.asarray(l) for l in jax.tree.leaves(p)] for p in params]
            summed = [functools.reduce(np.add, [ls[i] for ls in flat])
                      for i in range(len(flat[0]))]
            treedef = jax.tree.structure(params[0])
            params = [jax.tree.unflatten(treedef, [l + ALPHA * (s / k - l)
                                                   for l, s in zip(flat[r], summed)])
                      for r in range(k)]
    return losses, [jax.tree.map(np.asarray, p) for p in params]


def port_run(params0, k, monkeypatch, steps=STEPS):
    """`bert_sma.main` on each thread of a port world of k, from the JAX
    package's parameters."""
    cfg = port_cfg()
    monkeypatch.setattr(bert_sma, "config", lambda name: cfg)
    monkeypatch.setattr(bert_sma, "make_model",
                        lambda c, seed, device: convert.transformer_from_jax(params0, c, device))
    tls = threading.local()
    monkeypatch.setattr(api, "get_default_peer", lambda: tls.peer)
    world = make_world(["port"] * k, strategy="BINARY_TREE_STAR")
    out = {}

    def one(r):
        tls.peer = world[r]
        finals = {}
        res = bert_sma.main(["--config", "tiny", "--steps", str(steps), "--batch", str(BATCH),
                             "--seq", str(SEQ), "--alpha", str(ALPHA), "--device", "cpu",
                             "--fixed-batch"],
                            on_step=lambda t, step, rec: finals.update(model=t.model))
        out[r] = (res, convert.to_jax(finals["model"]))

    try:
        run_all([lambda r=r: one(r) for r in range(k)])
    finally:
        for p in world:
            p.stop()
    return [out[r] for r in range(k)]


@pytest.mark.parametrize("k", [1, 2])
def test_sma_training_matches_the_jax_example(k, init_params, monkeypatch):
    want_losses, want_params = jax_run(init_params, k)
    got = port_run(init_params, k, monkeypatch)
    for r in range(k):
        res, params = got[r]
        assert res["world"] == k and res["rank"] == r
        assert len(res["walk_ms"]) == (STEPS if k > 1 else 0)
        np.testing.assert_allclose(res["losses"], want_losses[r], rtol=TOL, atol=TOL)
        for key in convert.TOP_KEYS:
            np.testing.assert_allclose(params[key], want_params[r][key], rtol=TOL,
                                       atol=PARAM_ATOL, err_msg=key)
        for key, v in want_params[r]["layers"].items():
            np.testing.assert_allclose(params["layers"][key], v, rtol=TOL, atol=PARAM_ATOL,
                                       err_msg=key)
    if k == 2:  # the blend pulled the ranks together, not onto one point
        assert not np.array_equal(got[0][1]["embed"], got[1][1]["embed"])


def test_leaf_order_is_the_references_flatten_order(init_params):
    flat, _ = jax.tree.flatten_with_path(init_params)
    names = [".".join(str(getattr(k, "key", k)) for k in path) for path, _ in flat]
    assert tuple(names) == bert_sma.LEAF_ORDER
    model = convert.transformer_from_jax(init_params, port_cfg(), "cpu")
    for leaf, (_, ref) in zip(bert_sma.leaves_of(model), flat):
        assert leaf.detach().numpy().tobytes() == np.asarray(ref).tobytes()


@pytest.mark.parametrize("alpha", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 7])
def test_blend_is_bitwise_the_references_expression(n, alpha):
    rng = np.random.default_rng(n * 10 + int(alpha * 10))
    l = (rng.standard_normal(100_003) * 0.02).astype(np.float32)
    s = (rng.standard_normal(100_003) * 0.02 * n).astype(np.float32)
    want = l + alpha * (s / n - l)  # examples/bert_sma.py:121
    assert want.dtype == np.float32
    leaf = torch.from_numpy(l.copy())
    bert_sma.sma_blend(leaf, torch.from_numpy(s.copy()), torch.tensor(alpha, dtype=torch.float32),
                       torch.tensor(n, dtype=torch.float32))
    assert leaf.numpy().tobytes() == want.tobytes()


def test_device_rule():
    """Without --device the example runs on the card: none here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bert_sma.Trainer.__init__(object.__new__(bert_sma.Trainer),
                                  bert_sma.parse_args(["--steps", "1"]))

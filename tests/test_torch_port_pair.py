"""The port's PairAveraging (`kungfu_tpu_torch/optimizers/pair_averaging.py`)
and BASELINE config 4's example (`examples/cyclegan_pair.py`) against
the JAX package's: the reference's six PairAveraging cases
(tests/test_pair_averaging.py) on in-process port peers; a world of one
reference and one port PairAveraging exchanging models both ways, held
to an all-reference world on the same inputs (the 0.5/0.5 average bit
for bit, 5 SGD steps within 1e-6|p| + 1e-7); `_unpack_other` on each
kind of malformed blob; the f32 average's formula per dtype; and the
CycleGAN's first 20 steps from the reference's weights. Each world's
prefetches start only once both peers have published, so every step
averages with the other's newest model in both worlds alike."""

import struct
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu.optimizers.pair_averaging import PairAveraging as RPairAveraging
from kungfu_tpu.peer import Peer as RPeer
from kungfu_tpu.runner.env import parse_config_from_env as rparse_config_from_env
from kungfu_tpu_torch.base.serialize import pack_leaves, unpack_leaves
from kungfu_tpu_torch.optimizers.pair_averaging import PairAveraging, _pack_host
from kungfu_tpu_torch.peer import Peer
from kungfu_tpu_torch.runner.env import parse_config_from_env

from test_torch_port_worlds import make_world, run_all, small_arenas  # noqa: F401 - autouse

JOIN = 60.0
FETCH_TRIES = 5


@pytest.fixture
def peer_pair():
    peers = make_world(["port", "port"])
    yield peers
    for p in peers:
        p.stop()


def _sgd(lr):
    return lambda leaves: torch.optim.SGD(leaves, lr=lr)


def par(fns):
    run_all(fns, join=JOIN)


# ---------------------------------------------------------------------------
# the reference's six cases, on port peers
# ---------------------------------------------------------------------------

def test_pair_averaging_two_workers(peer_pair):
    p0, p1 = peer_pair
    params0 = {"w": torch.tensor([0.0, 0.0])}
    params1 = {"w": torch.tensor([2.0, 4.0])}
    pa0 = PairAveraging(_sgd(0.0), peer=p0, device="cpu")  # no local update: isolates the averaging
    pa1 = PairAveraging(_sgd(0.0), peer=p1, device="cpu")
    par([lambda: pa0.init(params0), lambda: pa1.init(params1)])
    zero = {"w": torch.zeros(2)}
    # one step each: both average with the other's initial model
    par([lambda: pa0.step(params0, zero), lambda: pa1.step(params1, zero)])
    np.testing.assert_allclose(params0["w"].numpy(), [1.0, 2.0], rtol=1e-6)
    np.testing.assert_allclose(params1["w"].numpy(), [1.0, 2.0], rtol=1e-6)


def test_pair_averaging_converges(peer_pair):
    """With zero grads, repeated pair averaging contracts both models to the
    same point (AD-PSGD consensus behavior)."""
    params = [{"w": torch.tensor([0.0])}, {"w": torch.tensor([8.0])}]
    pas = [PairAveraging(_sgd(0.0), peer=p, name="conv", device="cpu") for p in peer_pair]
    par([lambda i=i: pas[i].init(params[i]) for i in range(2)])
    zero = {"w": torch.zeros(1)}
    for _ in range(12):
        par([lambda i=i: pas[i].step(params[i], zero) for i in range(2)])
    a, b = float(params[0]["w"][0]), float(params[1]["w"][0])
    assert abs(a - b) < 0.6, f"models did not converge: {a} vs {b}"
    assert 2.0 < a < 6.0  # pulled toward the middle


def test_pair_averaging_single_worker_fallback():
    """Cluster of one: plain local SGD (no peer to average with)."""
    p = Peer(parse_config_from_env({}))
    p.start()
    try:
        pa = PairAveraging(_sgd(0.1), peer=p, device="cpu")
        params = {"w": torch.tensor([1.0])}
        pa.init(params)
        pa.step(params, {"w": torch.tensor([1.0])})
        np.testing.assert_allclose(params["w"].numpy(), [0.9], rtol=1e-6)
        assert pa.steps == {"avg": 0, "plain": 1}
    finally:
        p.stop()


def test_pair_averaging_bf16_lossless(peer_pair):
    """bf16 params must exchange losslessly: the wire blob is the packed
    leaves (raw bytes + dtype header), not an f32 flatten."""
    p0, p1 = peer_pair
    params = {"w": torch.arange(7, dtype=torch.bfloat16) / 3,
              "b": torch.tensor([1.5, -2.25], dtype=torch.float64)}
    pa0 = PairAveraging(_sgd(0.0), peer=p0, device="cpu")
    pa1 = PairAveraging(_sgd(0.0), peer=p1, device="cpu")
    par([lambda: pa0.init(params), lambda: pa1.init(params)])
    # wire bytes are exactly the packed leaves, dtypes intact
    blob = p0.p2p.request(p1.config.peers[1], pa0.blob, timeout=10, version="latest")
    assert bytes(blob) == bytes(_pack_host(params))
    leaves = unpack_leaves(bytes(blob), 2)
    by_dtype = {str(l.dtype): l for l in leaves}
    assert "torch.bfloat16" in by_dtype
    assert torch.equal(by_dtype["torch.bfloat16"], params["w"])
    # a full averaging step round-trips without dtype loss (identical
    # models: average must be bit-identical to the input)
    before = {k: v.clone() for k, v in params.items()}
    pa0.step(params, {k: torch.zeros_like(v) for k, v in params.items()})
    assert params["w"].dtype == torch.bfloat16 and pa0.steps["avg"] == 1
    assert torch.equal(params["w"], before["w"]) and torch.equal(params["b"], before["b"])


def test_versioned_p2p_requests(peer_pair):
    """VersionedStore serves the live p2p path: exact-version and latest
    requests round-trip; GC window drops old versions; concurrent
    publish/request never yields a torn or vanished blob (parity:
    handler/p2p.go:13-121)."""
    p0, p1 = peer_pair
    target = p1.config.peers[0]  # p0's own id, as seen by p1
    for v in range(5):
        p0.p2p.save_version(v, "m", f"model-v{v}".encode())
    assert bytes(p1.p2p.request(target, "m", version=4)) == b"model-v4"
    assert bytes(p1.p2p.request(target, "m", version=2)) == b"model-v2"
    assert p1.p2p.request(target, "m", version=0) is None
    assert p1.p2p.request(target, "nope", version="latest") is None
    assert bytes(p1.p2p.request(target, "m", version="latest")) == b"model-v4"
    p0.p2p.save("flat", b"plain")
    assert bytes(p1.p2p.request(target, "flat")) == b"plain"

    stop = threading.Event()
    errs = []

    def writer():
        v = 5
        while not stop.is_set():
            p0.p2p.save_version(v, "m", b"%08d" % v * 128)
            v += 1

    def reader():
        try:
            for _ in range(50):
                blob = bytes(p1.p2p.request(target, "m", version="latest"))
                assert len(blob) == 8 * 128 and blob == blob[:8] * 128, blob[:32]
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    w = threading.Thread(target=writer, daemon=True)
    r = threading.Thread(target=reader)
    w.start(); r.start(); r.join(60); stop.set(); w.join(10)
    assert not errs, errs


def test_simultaneous_large_cross_requests_no_deadlock(peer_pair):
    """Two peers requesting each other's LARGE blob at the same instant
    must not send-send deadlock."""
    p0, p1 = peer_pair
    blob = bytes(bytearray(20 * 1024 * 1024))  # 20 MB >> TCP buffers
    p0.p2p.save_version(0, "big", blob)
    p1.p2p.save_version(0, "big", blob)
    results = {}

    def fetch(me, other_peer, key):
        try:
            results[key] = me.p2p.request(other_peer, "big", timeout=60, version="latest")
        except Exception as e:  # noqa: BLE001 - surfaced by the asserts
            results[key] = e

    t0 = threading.Thread(target=fetch, args=(p0, p0.config.peers[1], "a"))
    t1 = threading.Thread(target=fetch, args=(p1, p1.config.peers[0], "b"))
    t0.start(); t1.start(); t0.join(90); t1.join(90)
    assert not t0.is_alive() and not t1.is_alive(), "p2p cross-request deadlock"
    for key in ("a", "b"):
        got = results.get(key)
        assert not isinstance(got, Exception), f"p2p cross-request deadlock: {got!r}"
        assert got is not None and len(got) == len(blob)


# ---------------------------------------------------------------------------
# a reference worker and a port worker exchanging models
# ---------------------------------------------------------------------------

def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def _inputs(dtype, steps):
    """Per rank: initial params and each step's gradients (numpy)."""
    out = []
    for rank in range(2):
        rng = np.random.default_rng(10 + rank)
        params = {"w": (rng.normal(size=(4, 3)) * (rank + 1)).astype(_np_dtype(dtype)),
                  "b": rng.normal(size=(3,)).astype(_np_dtype(dtype))}
        grads = [{k: rng.normal(size=v.shape).astype(_np_dtype(dtype)) for k, v in params.items()}
                 for _ in range(steps)]
        out.append((params, grads))
    return out


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


class _Worker:
    """One rank's PairAveraging in either package, its prefetch held
    until both ranks have published. `failed` lists why each failed
    fetch failed: the request's exception or refusal, or a fetch still
    running at the join."""

    def __init__(self, peer, lr, params, grads):
        self.port = isinstance(peer, Peer)
        self.grads = grads
        self.failed = []
        request = peer.p2p.request

        def recorded(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                data = request(*args, **kwargs)
            except BaseException as e:
                self.failed.append(f"{type(e).__name__}: {e} "
                                   f"({time.perf_counter() - t0:.2f} s)")
                raise
            if data is None:
                self.failed.append(f"refused ({time.perf_counter() - t0:.2f} s)")
            return data

        peer.p2p.request = recorded
        if self.port:
            self.params = {k: _t(v) for k, v in params.items()}
            self.pa = PairAveraging(_sgd(lr), peer=peer, name="mixed", device="cpu")
        else:
            self.params = {k: jnp.asarray(v) for k, v in params.items()}
            self.pa = RPairAveraging(optax.sgd(lr), peer=peer, name="mixed")
        self._prefetch = self.pa._start_prefetch
        self.pa._start_prefetch = lambda: None

    def fetch(self):
        """The other's newest model, fetched to the end. A failed fetch
        (the step would then run plain in one world only) is recorded in
        `failed` and made again, at most FETCH_TRIES times in all."""
        for _ in range(FETCH_TRIES):
            self._prefetch()
            self.pa._prefetch.join(JOIN)
            if self.pa._prefetch.is_alive():
                self.failed.append(f"still fetching after {JOIN} s")
            elif self.pa._fetched[0] is not None:
                return
        raise AssertionError(f"{'port' if self.port else 'ref'}: the other rank's model "
                             f"was not fetched: {self.failed}")

    def init(self):
        self.state = self.pa.init(self.params)

    def step(self, i):
        g = self.grads[i]
        if self.port:
            self.pa.step(self.params, {k: _t(v) for k, v in g.items()})
        else:
            self.params, self.state = self.pa.step(self.params, self.state,
                                                  {k: jnp.asarray(v) for k, v in g.items()})

    def values(self):
        return {k: _np(v) if self.port else np.asarray(jax.device_get(v))
                for k, v in self.params.items()}


def _run_world(kinds, dtype, lr, steps, failed):
    """Each step's values on every rank; each rank's failed fetches are
    added to `failed[kind]`, the package that made them."""
    world, ws = make_world(kinds), []
    try:
        ws = [_Worker(p, lr, *inp) for p, inp in zip(world, _inputs(dtype, steps))]
        par([w.init for w in ws])
        par([w.fetch for w in ws])
        trail = []
        for i in range(steps):
            par([lambda w=w: w.step(i) for w in ws])
            if i + 1 < steps:
                par([w.fetch for w in ws])
            trail.append([w.values() for w in ws])
        return trail
    finally:
        for kind, w in zip(kinds, ws):
            failed[kind] += w.failed
        for p in world:
            p.stop()


def _check_fetches(failed):
    """Every failed fetch is reported. The port's requests may need a
    retry only where the reference's needed one too: a fault of load
    then, not of the port's p2p path."""
    if failed["port"] or failed["ref"]:
        warnings.warn(f"fetches made again: {dict(failed)}")
    assert not failed["port"] or failed["ref"], \
        f"only the port's fetches failed: {failed['port']}"


@pytest.mark.parametrize("kinds", [["ref", "port"], ["port", "ref"]], ids=["ref_first",
                                                                          "port_first"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_average_of_a_mixed_pair_is_bitwise_the_reference_worlds(kinds, dtype):
    """SGD(0): each step is the 0.5/0.5 average alone, of two models that
    crossed the wire between the packages."""
    failed = {"port": [], "ref": []}
    mixed = _run_world(kinds, dtype, 0.0, 2, failed)
    ref = _run_world(["ref", "ref"], dtype, 0.0, 2, failed)
    _check_fetches(failed)
    for got_step, want_step in zip(mixed, ref):
        for got, want in zip(got_step, want_step):
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("kinds", [["ref", "port"], ["port", "ref"]], ids=["ref_first",
                                                                          "port_first"])
def test_five_sgd_steps_of_a_mixed_pair_hold_the_reference_world(kinds):
    """SGD(0.1), 5 steps: within 1e-6|p| + 1e-7 of an all-reference world
    (torch's SGD and optax's may round the update differently)."""
    failed = {"port": [], "ref": []}
    mixed = _run_world(kinds, "float32", 0.1, 5, failed)
    ref = _run_world(["ref", "ref"], "float32", 0.1, 5, failed)
    _check_fetches(failed)
    for got, want in zip(mixed[-1], ref[-1]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)
    # the models moved, and averaged toward each other
    start = _inputs("float32", 5)
    assert not np.array_equal(mixed[-1][0]["w"], start[0][0]["w"])


# ---------------------------------------------------------------------------
# the average's formula; malformed blobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "float64"])
def test_the_average_is_bitwise_the_references_formula(dtype):
    """0.5 * (p + o) in f32, rounded back to the parameter's dtype, as
    the reference's `avg_apply` computes it."""
    rng = np.random.default_rng(3)
    p = (rng.normal(size=1000) * 10.0 ** rng.integers(-3, 3, 1000)).astype(_np_dtype(dtype))
    o = (rng.normal(size=1000) * 10.0 ** rng.integers(-3, 3, 1000)).astype(_np_dtype(dtype))
    want = (np.float32(0.5) * (p.astype(np.float32) + o.astype(np.float32))).astype(p.dtype)
    if dtype != "float64":  # jax (without x64) has no f64 parameter: numpy's formula holds it
        ref = np.asarray(jax.jit(lambda a, b: (0.5 * (a.astype(jnp.float32) + b.astype(
            jnp.float32))).astype(a.dtype))(jnp.asarray(p), jnp.asarray(o)))
        assert ref.tobytes() == want.tobytes()
    pa = PairAveraging.__new__(PairAveraging)
    leaves = [_t(p)]
    pa._average(leaves, [_t(o)])
    got = _np(leaves[0])
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


class _FakePeer:
    rank = 0
    size = 1


def _good_blob():
    return pack_leaves([torch.ones(2, 3), torch.zeros(4)])


MALFORMED = {
    "shorter_than_the_length_prefix": lambda: b"\x01\x02\x03",
    "garbage_header": lambda: struct.pack("<Q", 4) + b"\xff\xfe\xfd\xfc",
    "bad_json": lambda: struct.pack("<Q", 5) + b"[{,}]",
    "wrong_leaf_count": lambda: pack_leaves([torch.ones(2, 3)]),
    "header_without_dtype": lambda: (lambda m: struct.pack("<Q", len(m)) + m)(
        b'[{"shape": [2, 3]}, {"shape": [4]}]') + bytes(40),
    "unknown_dtype": lambda: (lambda m: struct.pack("<Q", len(m)) + m)(
        b'[{"dtype": "nonsense", "shape": [2, 3]}, {"dtype": "float32", "shape": [4]}]')
        + bytes(40),
    "data_cut_short": lambda: _good_blob()[:-5],
}


@pytest.mark.parametrize("kind", list(MALFORMED))
def test_unpack_other_returns_none_on_a_malformed_blob_as_the_reference(kind):
    blob = MALFORMED[kind]()
    pa = PairAveraging(_sgd(0.0), peer=_FakePeer(), device="cpu")
    pa._n_leaves = 2
    rpa = RPairAveraging(optax.sgd(0.0), peer=_FakePeer())
    rpa._build({"a": jnp.ones((2, 3)), "b": jnp.zeros(4)})
    assert pa._unpack_other(blob) is None
    assert rpa._unpack_other(blob) is None


def test_unpack_other_reads_a_good_blob_and_a_step_skips_a_foreign_model(peer_pair):
    pa = PairAveraging(_sgd(0.0), peer=_FakePeer(), device="cpu")
    pa._n_leaves = 2
    got = pa._unpack_other(_good_blob())
    assert [tuple(t.shape) for t in got] == [(2, 3), (4,)]
    # a peer serving a model of other shapes: the step runs plain
    p0, p1 = peer_pair
    params = [{"w": torch.ones(3)}, {"w": torch.ones(5)}]
    pas = [PairAveraging(_sgd(0.0), peer=p, name="shape", device="cpu") for p in peer_pair]
    par([lambda i=i: pas[i].init(params[i]) for i in range(2)])
    pas[0].step(params[0], {"w": torch.zeros(3)})
    assert pas[0].steps == {"avg": 0, "plain": 1} and torch.equal(params[0]["w"], torch.ones(3))


def test_peer_choice_follows_the_references_seeded_rng():
    class P:
        size = 4

    for rank in range(4):
        P.rank = rank
        pa = PairAveraging(_sgd(0.0), peer=P(), device="cpu")
        rpa = RPairAveraging(optax.sgd(0.0), peer=P())
        picks = [pa._random_peer_rank() for _ in range(50)]
        assert picks == [rpa._random_peer_rank() for _ in range(50)]
        assert rank not in picks


def test_pair_averaging_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        PairAveraging(_sgd(0.0), peer=_FakePeer())
    pa = PairAveraging(_sgd(0.0), peer=_FakePeer(), device="cpu")
    with pytest.raises(ValueError, match="not on"):
        pa.init({"w": torch.ones(2, dtype=torch.float32, device="meta")})


# ---------------------------------------------------------------------------
# BASELINE config 4's example
# ---------------------------------------------------------------------------

CYCLE_STEPS = 20


def test_cyclegan_first_steps_follow_the_references_from_the_same_weights():
    """Both packages' CycleGAN in a world of one (PairAveraging runs
    plain Adam(2e-3)) from the reference's seed-0 weights on the same
    numpy batches: losses within 1e-4 relative, parameters within 1e-4
    absolute after 20 steps (Adam's denominators round differently)."""
    import importlib.util
    from pathlib import Path

    from kungfu_tpu_torch.elastic.state import tree_flatten
    from kungfu_tpu_torch.examples import cyclegan_pair as port_ex

    spec = importlib.util.spec_from_file_location(
        "ref_cyclegan_pair", Path(__file__).resolve().parent.parent / "examples" / "cyclegan_pair.py")
    ref_ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_ex)

    kg, kf, kdx, kdy = jax.random.split(jax.random.PRNGKey(0), 4)
    rparams = {"g": ref_ex.mlp_init(kg, [2, 32, 2]), "f": ref_ex.mlp_init(kf, [2, 32, 2]),
               "dx": ref_ex.mlp_init(kdx, [2, 32, 1]), "dy": ref_ex.mlp_init(kdy, [2, 32, 1])}
    tparams = port_ex.params_from_numpy(jax.device_get(rparams), device="cpu")

    @jax.jit
    def rgrads(params, xb, yb):
        gl, g_gen = jax.value_and_grad(lambda p: ref_ex.losses(p, xb, yb)[0])(params)
        dl, g_disc = jax.value_and_grad(lambda p: ref_ex.losses(p, xb, yb)[1])(params)
        return {"g": g_gen["g"], "f": g_gen["f"], "dx": g_disc["dx"], "dy": g_disc["dy"]}, gl, dl

    rpeer, tpeer = RPeer(rparse_config_from_env({})), Peer(parse_config_from_env({}))
    rpeer.start()
    tpeer.start()
    try:
        rpa = RPairAveraging(optax.adam(2e-3), peer=rpeer, name="cyclegan")
        rstate = rpa.init(rparams)
        tpa = PairAveraging(lambda leaves: torch.optim.Adam(leaves, lr=2e-3), peer=tpeer,
                            name="cyclegan", device="cpu")
        tpa.init(tparams)
        rng_r, rng_t = np.random.default_rng(100), np.random.default_rng(100)
        for _ in range(CYCLE_STEPS):
            xb, yb = ref_ex.sample_x(rng_r, 128), ref_ex.sample_y(rng_r, 128)
            g, gl, dl = rgrads(rparams, xb, yb)
            rparams, rstate = rpa.step(rparams, rstate, g)
            txb, tyb = port_ex.sample_x(rng_t, 128, "cpu"), port_ex.sample_y(rng_t, 128, "cpu")
            tg, tgl, tdl = port_ex.grads_fn(tparams, txb, tyb)
            tpa.step(tparams, tg)
            np.testing.assert_array_equal(txb.numpy(), np.asarray(xb))
            np.testing.assert_allclose([float(tgl), float(tdl)], [float(gl), float(dl)],
                                       rtol=1e-4)
        rleaves = jax.tree.leaves(jax.device_get(rparams))
        tleaves, _ = tree_flatten(tparams)
        assert len(rleaves) == len(tleaves) == 16
        for t, r in zip(tleaves, rleaves):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), rtol=0, atol=1e-4)
        assert tpa.steps == {"avg": 0, "plain": CYCLE_STEPS}
    finally:
        rpeer.stop()
        tpeer.stop()


def test_cyclegan_needs_a_card_unless_asked_for_the_cpu():
    from kungfu_tpu_torch.examples import cyclegan_pair as port_ex

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_ex.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_ex.init_params()

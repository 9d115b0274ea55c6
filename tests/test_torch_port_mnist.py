"""Parity of the port's MNIST slice with the JAX package's on the CPU:

- `models/mlp.py`: the SLP and the one-hidden-layer MLP, forward, loss and
  gradients from the same numpy parameters within 1e-6;
- three S-SGD steps of the SLP on a 2-process gloo world against JAX's
  `make_train_step(mlp_loss, synchronous_sgd(sgd), mesh)` on two CPU
  devices: losses and parameters within 1e-6;
- `datasets`: `read_idx` and `load_mnist` on files written by the JAX
  package's `write_idx` (every idx dtype, plain and gzip), equal to JAX's
  readers;
- `examples/mnist_slp.main(..., "--device", "cpu")` runs and its loss falls.
"""

import gzip
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from kungfu_tpu import datasets as jds
from kungfu_tpu.datasets.idx import read_idx as jax_read_idx, write_idx
from kungfu_tpu.models import mlp as jmlp
from kungfu_tpu.optimizers import synchronous_sgd as jax_ssgd
from kungfu_tpu.parallel.dp import make_train_step as jax_train_step, replicate
from kungfu_tpu.parallel.dp import shard_batch as jax_shard_batch
from kungfu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from kungfu_tpu_torch import datasets as tds
from kungfu_tpu_torch.models import convert, mlp as tmlp

WORLD, STEPS, GLOBAL_B, LR = 2, 3, 32, 0.5
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _two_threads():
    """Keep torch's CPU work to two threads: the suite runs beside
    multi-process tests that are sensitive to a loaded host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(hidden):
    return jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(3), 784, hidden, 10))


def _batch(seed, n=GLOBAL_B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 784)).astype(np.float32) * 0.5,
            rng.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("hidden", [0, 32], ids=["slp", "mlp"])
def test_forward_matches_jax(hidden):
    params, (x, _) = _params(hidden), _batch(0)
    got = tmlp.mlp_apply(convert.mlp_from_jax(params, "cpu").tree(), torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jmlp.mlp_apply(params, x)), **TOL)


@pytest.mark.parametrize("hidden", [0, 32], ids=["slp", "mlp"])
def test_loss_and_gradients_match_jax(hidden):
    params, (x, y) = _params(hidden), _batch(1)
    loss, grads = jax.value_and_grad(jmlp.mlp_loss)(params, (x, y))
    model = convert.mlp_from_jax(params, "cpu")
    t_loss = tmlp.mlp_loss(model.tree(), (torch.from_numpy(x), torch.from_numpy(y)))
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss), float(loss), **TOL)
    assert sorted(model.tree()) == sorted(grads)
    for k, p in model.tree().items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(grads[k]), **TOL, err_msg=k)


def test_init_mlp_shapes_and_scale():
    for hidden in (0, 64):
        want = _params(hidden)
        got = tmlp.init_mlp(torch.Generator().manual_seed(0), 784, hidden, 10, device="cpu")
        assert {k: tuple(v.shape) for k, v in got.tree().items()} == \
            {k: v.shape for k, v in want.items()}
        w = got.tree()["w1" if hidden else "w"].detach().numpy()
        np.testing.assert_allclose(w.std(), 1 / np.sqrt(784), rtol=0.05)


# ---------------------------------------------------------------------------
# three S-SGD steps on two ranks
# ---------------------------------------------------------------------------

def _worker(rank, peers, params, out_dir):
    torch.set_num_threads(1)
    from kungfu_tpu_torch.initializer import broadcast_variables
    from kungfu_tpu_torch.optimizers import synchronous_sgd
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane
    from kungfu_tpu_torch.parallel.dp import make_train_step, shard_batch
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    env = {"KF_SELF_SPEC": peers[rank], "KF_INIT_PEERS": ",".join(peers)}
    device = initialize_device_plane("cpu", environ=env)
    try:
        session = make_mesh(device)
        model = convert.mlp_from_jax(params, device)
        if rank:  # rank 0's weights must reach every rank
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(2.0)
        broadcast_variables(model, session)
        opt = synchronous_sgd(torch.optim.SGD(model.parameters(), lr=LR), session)
        step = make_train_step(lambda m, b: tmlp.mlp_loss(m.tree(), b), opt, session)
        losses = [float(step(model, shard_batch(tuple(torch.from_numpy(a) for a in _batch(10 + i)),
                                                session)))
                  for i in range(STEPS)]
        np.savez(f"{out_dir}/rank{rank}.npz", losses=np.array(losses),
                 **{k: p.detach().numpy() for k, p in model.tree().items()})
    finally:
        shutdown_device_plane()


def test_ssgd_steps_on_two_ranks_match_jax(tmp_path):
    params = _params(0)
    socks = [socket.socket() for _ in range(WORLD)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    peers = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    ctx = mp.start_processes(_worker, args=(peers, params, str(tmp_path)), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail("the gloo workers did not finish in 120 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()

    mesh = jax_make_mesh(devices=jax.devices()[:WORLD])
    opt = jax_ssgd(optax.sgd(LR))
    step = jax_train_step(jmlp.mlp_loss, opt, mesh, "dp", donate=False)
    p, state = replicate(params, mesh), replicate(opt.init(params), mesh)
    losses = []
    for i in range(STEPS):
        b = jax_shard_batch(tuple(jnp.asarray(a) for a in _batch(10 + i)), mesh)
        p, state, loss = step(p, state, b)
        losses.append(float(loss))
    for r in range(WORLD):
        res = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_allclose(res["losses"], losses, **TOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(res[k], np.asarray(p[k]), **TOL, err_msg=f"{k} rank {r}")


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

IDX_DTYPES = [np.uint8, np.int8, np.int16, np.int32, np.float32, np.float64]


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("dtype", IDX_DTYPES, ids=[np.dtype(d).name for d in IDX_DTYPES])
def test_read_idx_matches_jax(tmp_path, dtype, gz):
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal((3, 4, 5)) * 50).astype(dtype)
    path = str(tmp_path / ("a.idx" + (".gz" if gz else "")))
    write_idx(path, arr)
    got = tds.read_idx(path)
    assert got.dtype == jax_read_idx(path).dtype == arr.dtype
    np.testing.assert_array_equal(got, jax_read_idx(path))
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("bad", ["magic", "dtype", "truncated"])
def test_read_idx_refuses_a_bad_file(tmp_path, bad):
    path = tmp_path / "bad.idx"
    write_idx(str(path), np.arange(12, dtype=np.int32).reshape(3, 4))
    raw = bytearray(path.read_bytes())
    if bad == "magic":
        raw[0] = 1
    elif bad == "dtype":
        raw[2] = 0x0A
    else:
        raw = raw[:-4]
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=bad if bad != "magic" else "not an idx"):
        tds.read_idx(str(path))


def _write_mnist(d, n_train=20, n_test=8, gz_names=("train-images-idx3-ubyte",)):
    rng = np.random.default_rng(0)
    files = {
        "train-images-idx3-ubyte": rng.integers(0, 256, (n_train, 28, 28)).astype(np.uint8),
        "train-labels-idx1-ubyte": rng.integers(0, 10, n_train).astype(np.uint8),
        "t10k-images-idx3-ubyte": rng.integers(0, 256, (n_test, 28, 28)).astype(np.uint8),
        "t10k-labels-idx1-ubyte": rng.integers(0, 10, n_test).astype(np.uint8),
    }
    for name, arr in files.items():
        write_idx(str(d / (name + (".gz" if name in gz_names else ""))), arr)


@pytest.mark.parametrize("normalize", [True, False])
def test_load_mnist_matches_jax(tmp_path, normalize):
    _write_mnist(tmp_path)
    want = jds.load_mnist(str(tmp_path), normalize=normalize)
    got = tds.load_mnist(str(tmp_path), normalize=normalize)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["train_images"].shape == (20, 784)


def test_load_mnist_names_the_missing_file(tmp_path):
    _write_mnist(tmp_path)
    (tmp_path / "t10k-labels-idx1-ubyte").unlink()
    with pytest.raises(FileNotFoundError, match="t10k-labels-idx1-ubyte"):
        tds.load_mnist(str(tmp_path))


def test_gzip_file_is_really_compressed(tmp_path):
    _write_mnist(tmp_path)
    with gzip.open(tmp_path / "train-images-idx3-ubyte.gz", "rb") as f:
        assert f.read(4) == bytes([0, 0, 0x08, 3])


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def test_mnist_slp_example_trains_on_cpu(capsys):
    from kungfu_tpu_torch.examples import mnist_slp

    out = mnist_slp.main(["--epochs", "2", "--device", "cpu"])
    assert out["world"] == 1 and out["device"] == "cpu"
    assert out["loss"][1] < out["loss"][0]
    assert out["acc"][1] > 0.5
    assert "epoch 1:" in capsys.readouterr().out


def test_mnist_slp_example_reads_idx_data(tmp_path):
    from kungfu_tpu_torch.examples import mnist_slp

    _write_mnist(tmp_path, n_train=64)
    out = mnist_slp.main(["--epochs", "1", "--batch", "16", "--data", str(tmp_path),
                          "--device", "cpu"])
    assert np.isfinite(out["loss"][0]) and 0.0 <= out["acc"][0] <= 1.0


def test_synthetic_mnist_is_learnable_and_seeded():
    from kungfu_tpu_torch.examples import mnist_slp

    x, y = mnist_slp.synthetic_mnist(512, seed=0)
    x2, y2 = mnist_slp.synthetic_mnist(512, seed=0)
    assert x.shape == (512, 784) and x.dtype == np.float32
    np.testing.assert_array_equal(x, x2)
    np.testing.assert_array_equal(y, y2)
    assert set(np.unique(y)) <= set(range(10)) and len(np.unique(y)) > 5

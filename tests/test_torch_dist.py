"""The port's distributed training on the CPU: worker processes over gloo,
started by ``tools/launch.py`` as the reference's nightly jobs are.

- ``mxnet_tpu_torch/tools/dist_sync_kvstore.py`` with the asserts of
  ``tests/nightly/dist_sync_kvstore.py`` (rank 0's initial values, the exact
  synchronous sums with and without an updater, a big key, no dead node,
  ``dist_async``'s uneven pushes averaged by ``sync_weights``), at 2
  workers and at 1 (a process group of one still goes through the
  collectives).
- ``mxnet_tpu_torch/tools/dist_lenet.py``: LeNet with ``dist_sync`` (and
  ``dist_sync_device``) on unshuffled shards; the two workers' weights are
  bit-identical to each other and within rtol 1e-5, atol 1e-6 of one process over two contexts
  on the joined batches (the run two synchronous workers equal).
- ``train_mnist.py --kv-store dist_sync`` over two workers.
- A peer that never arrives fails within the stated timeout; NCCL is never
  replaced by gloo; the one-process no-op; ``fit``'s ``sync_weights``
  calls.

Every worker runs one torch thread: the sums of a convolution's backward
then come in one order in every process."""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mxt

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_TOOLS = os.path.join(_REPO, "mxnet_tpu_torch", "tools")


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env.update(OMP_NUM_THREADS="1",
               PYTHONPATH=_REPO + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _launch(n, script, *args, timeout):
    return subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools", "launch.py"),
         "-n", str(n), "--port", _free_port(), "--",
         sys.executable, os.path.join(_TOOLS, script), "--cpu", *args],
        cwd=_REPO, env=_env(), capture_output=True, text=True,
        timeout=timeout)


@pytest.mark.parametrize("n", [1, 2])
def test_dist_sync_kvstore_workers(n):
    r = _launch(n, "dist_sync_kvstore.py", timeout=120)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert r.stdout.count("dist_sync_kvstore OK backend=gloo") == n, r.stdout


def _lenet_workers_match_one_process(tmp_path, kv_store):
    r = _launch(2, "dist_lenet.py", "--no-shuffle", "--save", str(tmp_path),
                "--kv-store", kv_store, timeout=180)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert r.stdout.count("dist_lenet OK") == 2, r.stdout
    one = subprocess.run(
        [sys.executable, os.path.join(_TOOLS, "dist_lenet.py"), "--cpu",
         "--no-shuffle", "--save", str(tmp_path), "--as-one", "2"],
        cwd=_REPO, env=_env(), capture_output=True, text=True, timeout=180)
    assert one.returncode == 0, one.stderr
    w0 = np.load(tmp_path / "rank0.npz")
    w1 = np.load(tmp_path / "rank1.npz")
    w = np.load(tmp_path / "one.npz")
    assert sorted(w0) == sorted(w1) == sorted(w) and len(w) == 8
    for k in w:
        np.testing.assert_array_equal(w0[k], w1[k], err_msg=k)
        np.testing.assert_allclose(w0[k], w[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_dist_lenet_workers_match_one_process(tmp_path):
    _lenet_workers_match_one_process(tmp_path, "dist_sync")


def test_dist_sync_device_rescales_to_every_worker(tmp_path):
    """``dist_sync_device`` sums the workers' gradients as ``dist_sync``
    does, so ``rescale_grad`` is 1 over every worker's batch there too
    (the reference rescales only under ``dist_sync``, ROADMAP C)."""
    _lenet_workers_match_one_process(tmp_path, "dist_sync_device")


def test_example_fit_over_two_workers():
    """``train_mnist.py --kv-store dist_sync`` through the launcher: each
    worker joins over gloo, logs as ``Node[rank]`` and trains."""
    r = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tools", "launch.py"),
         "-n", "2", "--port", _free_port(), "--", sys.executable, "-m",
         "mxnet_tpu_torch.examples.image_classification.train_mnist",
         "--cpu", "--kv-store", "dist_sync", "--num-epochs", "1"],
        cwd=_REPO, env=_env(), capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    log = r.stdout + r.stderr
    for rank in (0, 1):
        assert f"Node[{rank}] Epoch[0] Validation-accuracy" in log, log


def test_missing_peer_fails_within_the_timeout():
    """Rank 0 of a job of 2 whose peer never comes: ``init`` raises the
    process group's timeout error after ``timeout`` seconds, not a hang."""
    code = ("import mxnet_tpu_torch as mx; "
            f"mx.distributed.init('127.0.0.1:{_free_port()}', 2, 0, "
            "ctx=mx.cpu(), timeout=3)")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "timed out" in r.stderr.lower() or "timeout" in r.stderr.lower(), \
        r.stderr[-2000:]
    assert time.perf_counter() - t0 < 60


def test_nccl_is_never_replaced_by_gloo(monkeypatch):
    """A card's worker joins over NCCL or raises: with no CUDA here it
    raises before joining anything, naming NCCL."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(mxt.MXNetError, match="NCCL"):
        mxt.distributed.init(f"127.0.0.1:{_free_port()}", 2, 0,
                             ctx=mxt.gpu(0), timeout=3)
    assert mxt.distributed.backend() is None


def test_one_process_init_is_a_no_op(monkeypatch):
    for k in ("MXTPU_COORDINATOR", "MXTPU_NUM_PROCESSES", "MXTPU_PROCESS_ID",
              "DMLC_PS_ROOT_URI", "DMLC_NUM_WORKER"):
        monkeypatch.delenv(k, raising=False)
    try:
        mxt.distributed.init(ctx=mxt.cpu())
        assert mxt.distributed.is_initialized()
        assert (mxt.distributed.rank(), mxt.distributed.size()) == (0, 1)
        assert mxt.distributed.get_num_dead_node() == 0
        mxt.distributed.barrier()
        assert mxt.distributed.backend() is None
        kv = mxt.kv.create("dist_sync")
        assert not kv._dist_active()
    finally:
        mxt.distributed.shutdown()
    assert not mxt.distributed.is_initialized()


def test_restart_count_and_recovery(monkeypatch):
    monkeypatch.delenv("MXTPU_RESTART_COUNT", raising=False)
    assert mxt.distributed.restart_count() == 0
    assert not mxt.distributed.is_recovery()
    monkeypatch.setenv("MXTPU_RESTART_COUNT", "2")
    assert mxt.distributed.restart_count() == 2
    assert mxt.distributed.is_recovery()


class _CountingStore(mxt.kv.KVStore):
    def __init__(self):
        super().__init__("local")
        self.sync_interval = 2
        self.syncs = 0

    def sync_weights(self):
        self.syncs += 1


def test_fit_syncs_weights_at_interval_and_epoch_end():
    """``fit`` calls the store's ``sync_weights`` every ``sync_interval``
    batches and at each epoch's end (dist_async's aligned points)."""
    rng = np.random.RandomState(0)
    x = rng.randn(40, 6).astype(np.float32)
    y = (np.arange(40) % 3).astype(np.float32)
    it = mxt.io.NDArrayIter(x, y, batch_size=8)
    net = mxt.sym.SoftmaxOutput(mxt.sym.FullyConnected(
        mxt.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    mod = mxt.mod.Module(net, context=mxt.cpu())
    kv = _CountingStore()
    mod.fit(it, num_epoch=2, kvstore=kv, optimizer="sgd",
            initializer=mxt.init.Xavier())
    assert mod._kvstore is kv and mod._update_on_kvstore
    assert mod._fused_step_fn is None
    # 5 batches an epoch: after batches 2 and 4, and at the end; twice
    assert kv.syncs == 2 * (2 + 1)

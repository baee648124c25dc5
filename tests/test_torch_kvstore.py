"""The port's KVStore against the JAX package's, on the CPU: the ten cases
of ``tests/test_kvstore.py`` (the reference's deterministic aggregation
values), each pattern run through both packages on the same numpy values
and compared for exact equality; every type string ``create`` accepts; and
the process contract of ``kvstore_server`` (a server- or scheduler-role
process exits 0 at ``import mxnet_tpu_torch``, a worker's import
proceeds). The distributed cases run in two processes in
``tests/test_torch_dist.py``."""
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mxj
import mxnet_tpu_torch as mxt

SHAPE = (4, 4)
KEYS = [5, 7, 11]
_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _init_kv(pkg, kind="local"):
    kv = pkg.kv.create(kind)
    kv.init(3, pkg.nd.zeros(SHAPE))
    kv.init(KEYS, [pkg.nd.zeros(SHAPE)] * len(KEYS))
    return kv


def _single_kv_pair(pkg):
    kv = _init_kv(pkg)
    kv.push(3, pkg.nd.ones(SHAPE) * 4)
    out = pkg.nd.empty(SHAPE)
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _list_kv_pair(pkg):
    kv = _init_kv(pkg)
    kv.push(KEYS, [pkg.nd.ones(SHAPE) * 4] * len(KEYS))
    out = [pkg.nd.empty(SHAPE)] * len(KEYS)
    kv.pull(KEYS, out=out)
    return [o.asnumpy() for o in out]


def _aggregator(pkg):
    kv = _init_kv(pkg)
    num_devs = 4
    kv.push(3, [pkg.nd.ones(SHAPE) for _ in range(num_devs)])
    out = pkg.nd.empty(SHAPE)
    kv.pull(3, out=out)
    kv.push(KEYS, [[pkg.nd.ones(SHAPE) * 2.0] * num_devs] * len(KEYS))
    outs = [pkg.nd.empty(SHAPE) for _ in KEYS]
    kv.pull(KEYS, out=outs)
    return [out.asnumpy()] + [o.asnumpy() for o in outs]


def _updater_hook(pkg):
    kv = _init_kv(pkg)
    updates = []

    def updater(key, recv, local):
        updates.append(key)
        local += recv

    kv._set_updater(updater)
    kv.push(3, pkg.nd.ones(SHAPE))
    kv.push(3, pkg.nd.ones(SHAPE))
    out = pkg.nd.empty(SHAPE)
    kv.pull(3, out=out)
    return [out.asnumpy(), np.array(updates)]


def _set_optimizer(pkg):
    kv = _init_kv(pkg)
    kv.set_optimizer(pkg.optimizer.Test(rescale_grad=1.0))
    kv.push(3, pkg.nd.ones(SHAPE))
    out = pkg.nd.empty(SHAPE)
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _get_type_rank(pkg):
    kv = pkg.kv.create("dist_sync")
    return [np.array([kv.type == "dist_sync", kv.rank, kv.num_workers])]


def _init_twice_ignored(pkg):
    kv = _init_kv(pkg)
    kv.push(3, pkg.nd.ones(SHAPE))
    kv.init(3, pkg.nd.zeros(SHAPE))  # second init is a no-op
    out = pkg.nd.empty(SHAPE)
    kv.pull(3, out=out)
    return [out.asnumpy()]


def _optimizer_states_save_load(pkg, path):
    """Save the momentum after one push, push twice more, load the saved
    states and push again: the value after the load follows the saved
    momentum, not the later one."""
    kv = _init_kv(pkg)
    kv.set_optimizer(pkg.optimizer.SGD(momentum=0.9, learning_rate=0.1))
    grad = pkg.nd.array(np.arange(16, dtype=np.float32).reshape(SHAPE))
    kv.push(3, grad)
    kv.save_optimizer_states(path)
    kv.push(3, grad)
    kv.push(3, grad)
    kv.load_optimizer_states(path)
    kv.push(3, grad)
    out = pkg.nd.empty(SHAPE)
    kv.pull(3, out=out)
    return [out.asnumpy()]


PATTERNS = {
    "single_kv_pair": _single_kv_pair,
    "list_kv_pair": _list_kv_pair,
    "aggregator": _aggregator,
    "updater_hook": _updater_hook,
    "set_optimizer": _set_optimizer,
    "get_type_rank": _get_type_rank,
    "init_twice_ignored": _init_twice_ignored,
}

WANT = {
    "single_kv_pair": [4 * np.ones(SHAPE)],
    "list_kv_pair": [4 * np.ones(SHAPE)] * len(KEYS),
    "aggregator": [4 * np.ones(SHAPE)] + [8 * np.ones(SHAPE)] * len(KEYS),
    "updater_hook": [2 * np.ones(SHAPE), np.array([3, 3])],
    "set_optimizer": [np.ones(SHAPE)],
    "get_type_rank": [np.array([True, 0, 1])],
    "init_twice_ignored": [np.ones(SHAPE)],
}


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_pattern_matches_reference(pattern):
    """The pattern's pulled values are the reference's, bit for bit, and
    the reference test's expected values."""
    with mxt.cpu():
        got = PATTERNS[pattern](mxt)
    with mxj.cpu():
        want = PATTERNS[pattern](mxj)
    assert len(got) == len(want) == len(WANT[pattern])
    for g, w, e in zip(got, want, WANT[pattern]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, e)


def test_optimizer_states_save_load_matches_reference(tmp_path):
    """The reference's ``test_optimizer_states_save_load``, through a
    restore that changes the result: both packages give the same value
    (each reads its own states file; the ``.states`` formats differ,
    ROADMAP A8). The file is written to a temporary name and renamed."""
    with mxt.cpu():
        got = _optimizer_states_save_load(mxt, str(tmp_path / "t.states"))
    with mxj.cpu():
        want = _optimizer_states_save_load(mxj, str(tmp_path / "j.states"))
    np.testing.assert_array_equal(got[0], want[0])
    assert not os.path.exists(tmp_path / "t.states.tmp")
    with open(tmp_path / "t.states", "wb") as f:
        f.write(b"not a pickle")
    kv = mxt.kv.create("local")
    kv.set_optimizer(mxt.optimizer.SGD())
    with pytest.raises(mxt.model.CheckpointCorrupt, match="t.states"):
        kv.load_optimizer_states(str(tmp_path / "t.states"))


@pytest.mark.parametrize("name", mxt.kvstore._TYPES)
def test_create_accepts_the_reference_types(name):
    """Each of the reference's ten type strings makes a store of that type
    (no process group in this process: rank 0 of 1)."""
    for pkg in (mxt, mxj):
        kv = pkg.kv.create(name)
        assert kv.type == name
        assert (kv.rank, kv.num_workers) == (0, 1)
    with pytest.raises(mxt.MXNetError):
        mxt.kv.create("dist_nope")
    with pytest.raises(TypeError):
        mxt.kv.create(3)


def test_push_does_not_write_the_callers_array():
    """A pushed array is not the stored value: a later in-place write of
    the caller's array changes nothing in the store, and a pull writes the
    output array in place."""
    with mxt.cpu():
        kv = _init_kv(mxt)
        val = mxt.nd.ones(SHAPE)
        kv.push(3, val)
        val += 5
        out = mxt.nd.zeros(SHAPE)
        tensor = out.data
        kv.pull(3, out=out)
    assert out.data is tensor
    np.testing.assert_array_equal(out.asnumpy(), np.ones(SHAPE))


def test_uninitialized_key_raises():
    with mxt.cpu():
        kv = mxt.kv.create("local")
        with pytest.raises(mxt.MXNetError, match="not initialized"):
            kv.push(9, mxt.nd.ones(SHAPE))
        with pytest.raises(mxt.MXNetError, match="not initialized"):
            kv.pull(9, out=mxt.nd.ones(SHAPE))


def _import_port(role):
    env = dict(os.environ, DMLC_ROLE=role,
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    return subprocess.run(
        [sys.executable, "-c",
         "import mxnet_tpu_torch; raise SystemExit(7)"],  # 7: import returned
        capture_output=True, text=True, timeout=240, env=env, cwd=_REPO)


@pytest.mark.parametrize("role", ["server", "scheduler"])
def test_server_role_process_exits_cleanly(role):
    """A process launched as a server (or scheduler) exits 0 at ``import
    mxnet_tpu_torch`` instead of waiting in a role the port lacks."""
    r = _import_port(role)
    assert r.returncode == 0, (r.returncode, r.stderr)


def test_worker_role_import_proceeds():
    r = _import_port("worker")
    assert r.returncode == 7, (r.returncode, r.stderr)


def test_kvstore_server_run_returns():
    kv = mxt.kv.create("dist_sync")
    assert mxt.kvstore_server.KVStoreServer(kv).run() is None

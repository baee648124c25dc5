"""The port's dependency engine (mxnet_tpu_torch/engine.py) against the
cases of tests/test_engine.py, on the CPU, and one randomized workload of
in-place array writes run through both packages' engines (the card's
version, over device tensors, is in tests/test_torch_serving_cuda.py).

Every engine a test makes is shut down by the ``engines`` fixture, so no
worker thread outlives its test.
"""
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.engine import (NaiveEngine, NativeEngine,
                                    ThreadedEngine, _OpRecord)


@pytest.fixture
def engines():
    made = []

    def make(cls, *a, **kw):
        eng = cls(*a, **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        try:
            eng.wait_for_all()
        except Exception:
            pass
        eng.shutdown()


def _native(engines, n):
    try:
        return engines(NativeEngine, num_workers=n)
    except MXNetError:
        pytest.fail("the host library's native engine did not build")


def test_naive_engine_runs_inline():
    eng = NaiveEngine()
    log = []
    v = eng.new_variable()
    eng.push(lambda: log.append(1), mutable_vars=(v,))
    assert log == [1]


def test_duplicate_var_rejected(engines):
    eng = engines(ThreadedEngine, num_workers=2)
    v = eng.new_variable()
    with pytest.raises(MXNetError):
        eng.push(lambda: None, const_vars=(v,), mutable_vars=(v,))
    with pytest.raises(MXNetError):
        eng.push(lambda: None, const_vars=(v, v))


def test_write_serialization(engines):
    eng = engines(ThreadedEngine, num_workers=4)
    v = eng.new_variable()
    log = []
    for i in range(50):
        eng.push(lambda i=i: log.append(i), mutable_vars=(v,))
    eng.wait_for_all()
    assert log == list(range(50))


def test_readers_parallel_writer_excluded(engines):
    eng = engines(ThreadedEngine, num_workers=4)
    v = eng.new_variable()
    state = {"writers": 0, "readers": 0, "max_readers": 0, "error": False}
    lock = threading.Lock()

    def reader():
        with lock:
            if state["writers"]:
                state["error"] = True
            state["readers"] += 1
            state["max_readers"] = max(state["max_readers"], state["readers"])
        time.sleep(0.001)
        with lock:
            state["readers"] -= 1

    def writer():
        with lock:
            if state["writers"] or state["readers"]:
                state["error"] = True
            state["writers"] += 1
        time.sleep(0.001)
        with lock:
            state["writers"] -= 1

    for i in range(100):
        if i % 5 == 0:
            eng.push(writer, mutable_vars=(v,))
        else:
            eng.push(reader, const_vars=(v,))
    eng.wait_for_all()
    assert not state["error"]
    assert state["max_readers"] > 1


def _counter_workload(eng, seed, n_vars, n_ops):
    rng = random.Random(seed)
    variables = [eng.new_variable() for _ in range(n_vars)]
    counters = [[0] for _ in variables]
    errors = []

    def make_writer(idxs):
        def _w():
            snap = [counters[i][0] for i in idxs]
            time.sleep(rng.random() * 0.0005)
            for i, s in zip(idxs, snap):
                if counters[i][0] != s:
                    errors.append("concurrent write detected")
                counters[i][0] = s + 1
        return _w

    expected = [0] * n_vars
    for _ in range(n_ops):
        idxs = rng.sample(range(n_vars), rng.randint(1, 3))
        for i in idxs:
            expected[i] += 1
        eng.push(make_writer(idxs), mutable_vars=[variables[i] for i in idxs])
    eng.wait_for_all()
    return errors, [c[0] for c in counters], expected


def test_randomized_workload(engines):
    errors, got, want = _counter_workload(
        engines(ThreadedEngine, num_workers=8), 42, 10, 200)
    assert not errors
    assert got == want


@pytest.mark.parametrize("kind", ["threaded", "native"])
def test_stress_more_workers_than_cores(engines, kind):
    """32 workers (more than the cores) and a 1 µs switch interval: the
    writers of each var still serialize (no lost update)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        eng = engines(ThreadedEngine, num_workers=32) \
            if kind == "threaded" else _native(engines, 32)
        errors, got, want = _counter_workload(eng, 11, 6, 300)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert got == want


def test_wait_for_var(engines):
    eng = engines(ThreadedEngine, num_workers=2)
    v = eng.new_variable()
    log = []

    def slow():
        time.sleep(0.01)
        log.append("done")

    eng.push(slow, mutable_vars=(v,))
    eng.wait_for_var(v)
    assert log == ["done"]


def test_error_propagation(engines):
    eng = engines(ThreadedEngine, num_workers=2)
    v = eng.new_variable()

    def boom():
        raise ValueError("async boom")

    eng.push(boom, mutable_vars=(v,))
    with pytest.raises(ValueError, match="async boom"):
        eng.wait_for_var(v)


def test_error_routed_per_var(engines):
    """An error in op B surfaces at B's var, not at A's."""
    eng = engines(ThreadedEngine, num_workers=2)
    a, b = eng.new_variable(), eng.new_variable()
    eng.push(lambda: None, mutable_vars=(a,))

    def boom():
        raise ValueError("b boom")

    eng.push(boom, mutable_vars=(b,))
    time.sleep(0.1)
    eng.wait_for_var(a)
    with pytest.raises(ValueError, match="b boom"):
        eng.wait_for_var(b)
    eng.wait_for_all()


def test_error_propagates_downstream(engines):
    """An op reading a failed var does not run; the failure flows on."""
    eng = engines(ThreadedEngine, num_workers=2)
    src, dst = eng.new_variable(), eng.new_variable()
    ran = []

    def boom():
        raise ValueError("upstream boom")

    eng.push(boom, mutable_vars=(src,))
    eng.push(lambda: ran.append(1), const_vars=(src,), mutable_vars=(dst,))
    with pytest.raises(ValueError, match="upstream boom"):
        eng.wait_for_var(dst)
    assert ran == []


def test_error_cleared_after_wait_for_all(engines):
    eng = engines(ThreadedEngine, num_workers=2)
    v = eng.new_variable()
    eng.push(lambda: (_ for _ in ()).throw(ValueError("boom")),
             mutable_vars=(v,))
    with pytest.raises(ValueError):
        eng.wait_for_all()
    done = []
    eng.push(lambda: done.append(1), mutable_vars=(v,))
    eng.wait_for_var(v)
    assert done == [1]


def test_native_engine_workload(engines):
    """The C++ engine (src/engine.cc, in the port's host library) keeps
    writers in order and runs every reader."""
    eng = _native(engines, 4)
    v = eng.new_variable()
    log = []
    for i in range(50):
        eng.push(lambda i=i: log.append(i), mutable_vars=(v,))
    eng.wait_for_all()
    assert log == list(range(50))
    results, lock = [], threading.Lock()
    for i in range(40):
        def read(i=i):
            with lock:
                results.append(i)
        eng.push(read, const_vars=(v,))
    eng.wait_for_all()
    assert sorted(results) == list(range(40))


def test_native_engine_randomized(engines):
    errors, got, want = _counter_workload(_native(engines, 8), 3, 8, 200)
    assert not errors
    assert got == want


def test_native_engine_error_propagation(engines):
    eng = _native(engines, 2)
    v = eng.new_variable()

    def boom():
        raise ValueError("native async boom")

    eng.push(boom, mutable_vars=(v,))
    with pytest.raises(ValueError, match="native async boom"):
        eng.wait_for_all()


def test_no_double_dispatch_when_grant_races_push(engines):
    """An op granted no var at push time runs once even if its blocker
    completes before push's _sub_wait runs (the completer dispatches)."""

    class _GatedEngine(ThreadedEngine):
        def __init__(self):
            super().__init__(num_workers=2)
            self.claimed = threading.Event()
            self.go = threading.Event()
            self.gate_name = None

        def _sub_wait(self, rec, n):
            if rec.name == self.gate_name:
                self.claimed.set()
                assert self.go.wait(timeout=10)
            super()._sub_wait(rec, n)

    eng = engines(_GatedEngine)
    v = eng.new_variable()
    release = threading.Event()
    ran = []
    eng.push(release.wait, mutable_vars=(v,), name="blocker")
    eng.gate_name = "victim"
    t = threading.Thread(target=eng.push, args=(lambda: ran.append(1),),
                         kwargs={"const_vars": (v,), "name": "victim"})
    t.start()
    assert eng.claimed.wait(timeout=10)
    release.set()
    deadline = time.time() + 10
    while not ran and time.time() < deadline:
        time.sleep(0.01)
    assert ran == [1]
    eng.go.set()
    t.join(timeout=10)
    eng.wait_for_all()
    assert ran == [1]
    assert eng._inflight == 0


def test_flowed_delivered_failure_does_not_retaint(engines):
    """A flow-through failure already delivered does not taint again; a
    fresh raise of the same object and an undelivered flow do."""
    eng = engines(ThreadedEngine, num_workers=2)
    exc = ValueError("boom")
    eng._delivered.append(exc)

    def rec_for(var, flowed):
        r = _OpRecord(lambda: None, [], [var], "straggler")
        r.exc, r.flowed = exc, flowed
        return r

    y = eng.new_variable()
    eng._taint_outputs(rec_for(y, flowed=True))
    assert y._exc is None
    z = eng.new_variable()
    eng._taint_outputs(rec_for(z, flowed=False))
    assert z._exc is exc
    w = eng.new_variable()
    fresh = RuntimeError("undelivered")
    r = _OpRecord(lambda: None, [], [w], "flow")
    r.exc, r.flowed = fresh, True
    eng._taint_outputs(r)
    assert w._exc is fresh
    with pytest.raises((ValueError, RuntimeError)):
        eng.wait_for_all()


def test_fresh_raise_of_delivered_exception_still_surfaces(engines):
    eng = engines(ThreadedEngine, num_workers=2)
    cached = ValueError("cached boom")

    def boom():
        raise cached

    x = eng.new_variable()
    eng.push(boom, mutable_vars=(x,))
    with pytest.raises(ValueError, match="cached boom"):
        eng.wait_for_var(x)
    y = eng.new_variable()
    eng.push(boom, mutable_vars=(y,))
    with pytest.raises(ValueError, match="cached boom"):
        eng.wait_for_all()
    z = eng.new_variable()
    done = []
    eng.push(lambda: done.append(1), mutable_vars=(z,))
    eng.wait_for_var(z)
    assert done == [1]


# -- beyond the reference's cases -------------------------------------------------

def _tensor_workload(eng, seed, n_vars=6, n_ops=120, width=16):
    """Pushes that read and write tensors: each op reads a random set of
    tensors and writes another (disjoint), out = 0.5 * out + sum(reads) +
    op index, in place. The final tensors depend only on each var's order
    of writes and the values its readers saw, which the engine fixes."""
    rng = random.Random(seed)
    jitter = random.Random(seed + 1)   # the workers' own: picks stay fixed
    variables = [eng.new_variable() for _ in range(n_vars)]
    data = [np.arange(width, dtype=np.float64) * (i + 1)
            for i in range(n_vars)]
    for k in range(n_ops):
        picks = rng.sample(range(n_vars), rng.randint(1, 4))
        n_w = rng.randint(1, len(picks))
        writes, reads = picks[:n_w], picks[n_w:]

        def op(k=k, writes=writes, reads=reads):
            acc = sum((data[r] for r in reads), np.zeros(width))
            time.sleep(jitter.random() * 0.0003)
            for w in writes:
                data[w][:] = 0.5 * data[w] + acc + k

        eng.push(op, const_vars=[variables[i] for i in reads],
                 mutable_vars=[variables[i] for i in writes])
    eng.wait_for_all()
    return data


def test_randomized_tensor_workload_matches_reference_engine(engines):
    """The same randomized read/write workload through the JAX package's
    engines and the port's ThreadedEngine, NativeEngine and NaiveEngine
    ends with the same values (those of the synchronous order)."""
    from mxnet_tpu import engine as ref_engine

    want = _tensor_workload(ref_engine.NaiveEngine(), 7)
    ref_threaded = ref_engine.ThreadedEngine(num_workers=4)
    try:
        got_ref = _tensor_workload(ref_threaded, 7)
    finally:
        ref_threaded._pool.shutdown(wait=True)
    for a, b in zip(got_ref, want):
        np.testing.assert_array_equal(a, b)
    for eng in (NaiveEngine(), engines(ThreadedEngine, num_workers=4),
                _native(engines, 4)):
        for a, b in zip(_tensor_workload(eng, 7), want):
            np.testing.assert_array_equal(a, b)


def test_on_skipped_and_quiesce(engines):
    """An op skipped for an upstream failure or a quiesce window calls its
    on_skipped with the failure; end_quiesce settles the cause."""
    eng = engines(ThreadedEngine, num_workers=2)
    src, dst = eng.new_variable(), eng.new_variable()
    seen = []
    eng.push(lambda: (_ for _ in ()).throw(KeyError("up")),
             mutable_vars=(src,))
    eng.push(lambda: seen.append("ran"), const_vars=(src,),
             mutable_vars=(dst,), on_skipped=seen.append)
    with pytest.raises(KeyError):
        eng.wait_for_var(dst)
    assert len(seen) == 1 and isinstance(seen[0], KeyError)
    cause = RuntimeError("quiesced")
    assert eng.begin_quiesce(cause, timeout_s=5.0)
    v = eng.new_variable()
    eng.push(lambda: seen.append("ran"), mutable_vars=(v,),
             on_skipped=seen.append)
    with pytest.raises(RuntimeError, match="quiesced"):
        eng.wait_for_var(v)
    assert seen[-1] is cause
    eng.end_quiesce()
    eng.push(lambda: seen.append("ran"), mutable_vars=(v,))
    eng.wait_for_all()
    assert seen[-1] == "ran"
    snap = eng.debug_snapshot()
    assert snap["type"] == "ThreadedEngine" and snap["inflight"] == 0


def test_waitall_waits_on_the_engine(engines):
    """nd.waitall waits for the process's engine and raises an op's
    failure, as the reference's does."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import engine as eng_mod

    eng = engines(ThreadedEngine, num_workers=2)
    old = eng_mod._ENGINE
    eng_mod.set_engine(eng)
    try:
        out = torch.zeros(4)
        v = eng.new_variable()

        def slow():
            time.sleep(0.05)
            out.add_(3.0)

        eng.push(slow, mutable_vars=(v,))
        mx.nd.waitall()
        assert out.tolist() == [3.0] * 4
        eng.push(lambda: (_ for _ in ()).throw(ValueError("late")),
                 mutable_vars=(v,))
        with pytest.raises(ValueError, match="late"):
            mx.nd.waitall()
    finally:
        eng_mod.set_engine(old)


def test_get_engine_honors_env(monkeypatch):
    from mxnet_tpu_torch import engine as eng_mod

    old = eng_mod._ENGINE
    try:
        for kind, cls in (("NaiveEngine", NaiveEngine),
                          ("NativeEngine", NativeEngine),
                          ("ThreadedEngine", ThreadedEngine)):
            monkeypatch.setenv("MXNET_ENGINE_TYPE", kind)
            eng_mod.set_engine(None)
            eng = eng_mod.get_engine()
            assert type(eng) is cls
            assert eng_mod.get_engine() is eng
            eng.shutdown()
    finally:
        eng_mod.set_engine(old)

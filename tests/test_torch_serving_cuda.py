"""The request-batching server on the card: one capture a bucket, a weight
swap with no capture, paging out and in (one capture a cached bucket
again, ROADMAP C10), prewarm overlapping traffic, and the engine's
workloads over device tensors. This file imports no JAX, so it runs on a
machine with only PyTorch:

    python -m pytest -m gpu --noconftest tests/test_torch_serving_cuda.py

A narrow ResNet (depth 8, 32 px, 10 classes) in fp32 with TF32 off,
bench.py's seeded Xavier weights and uniform inputs; responses held to direct Predictor forwards at the
request's shape within 1e-4 of max-abs, and bit for bit where the same
graph runs. Without a CUDA device each test skips."""
import random
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import engine as eng_mod
from mxnet_tpu_torch.serving import ModelServer

pytestmark = pytest.mark.gpu
SHAPE = (1, 3, 32, 32)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; runs on the card")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    engine = eng_mod.ThreadedEngine(num_workers=4)
    prev = eng_mod._ENGINE
    eng_mod.set_engine(engine)
    yield
    eng_mod.set_engine(prev)
    engine.shutdown()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _net():
    with mx.name.NameManager():
        return mx.models.resnet.get_symbol(num_classes=10, num_layers=8,
                                           image_shape="3,32,32")


def _weights(seed):
    """bench.py's inference weights: Xavier, BatchNorm at its start."""
    sym = _net()
    arg_shapes, _, aux_shapes = sym.infer_shape(data=SHAPE)
    mx.random.seed(seed)
    init = mx.init.Xavier()
    out = []
    for names, shapes in ((sym.list_arguments(), arg_shapes),
                          (sym.list_auxiliary_states(), aux_shapes)):
        d = {}
        for n, s in zip(names, shapes):
            if n not in ("data", "softmax_label"):
                arr = mx.nd.zeros(s, mx.cpu())
                init(n, arr)
                d[n] = arr.asnumpy()
        out.append(d)
    return tuple(out)


def _pred(seed=0, shape=SHAPE):
    args, aux = _weights(seed)
    return mx.Predictor.from_arrays(_net(), args, aux, {"data": shape},
                                    ctx=mx.gpu(0))


def _direct(x, seed=0, times=1):
    """A direct forward of ``x`` at its own shape on the card (the last of
    ``times``: the third is a replay of a captured graph)."""
    pred = _pred(seed, x.shape)
    for _ in range(times):
        pred.forward(data=x)
    return pred.get_output(0)


def _xs(seed, sizes=(1, 3, 5)):
    rng = np.random.RandomState(seed)
    return {b: rng.rand(b, *SHAPE[1:]).astype(np.float32) for b in sizes}


def _infer(srv, inputs=None, **kw):
    """``srv.infer`` with a bounded wait: a hang fails the test, not the
    suite."""
    return srv.submit(inputs, **kw).result(timeout=300)


def _prewarm(srv):
    return srv.prewarm().result(timeout=300)


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_one_capture_a_bucket():
    xs = _xs(1)
    with ModelServer(_pred(), max_batch_size=8, max_wait_ms=0.0,
                     manifest=False) as srv:
        for _ in range(4):
            for b, x in xs.items():
                got = _infer(srv, data=x)[0]
                assert _max_rel(got, _direct(x)) <= 1e-4
        stats = srv.cache_stats()
        assert stats["binds"] == stats["captures"] == 3, stats
        assert stats["replays"] == 3 * 5 and stats["drops"] == 0
        for info in srv.cache.programs().values():
            assert info["captured"] and info["captures"] == 1
        # a group of 3 + 5 rows in bucket 8 is bit-equal to the same padded
        # batch through a direct (replayed) forward
        padded = np.zeros((8,) + SHAPE[1:], np.float32)
        padded[:3], padded[3:] = xs[3], xs[5]
        want = _direct(padded, times=3)[:8]
        srv._batcher._max_wait = 0.5
        for _ in range(3):   # bucket 8: warm-up, capture, replay
            f3, f5 = srv.submit(data=xs[3]), srv.submit(data=xs[5])
            got = np.concatenate([f3.result(timeout=60)[0],
                                  f5.result(timeout=60)[0]])
        np.testing.assert_array_equal(got, want)


def test_swap_without_capture():
    v2_args, v2_aux = _weights(1)
    x = _xs(2)[3]
    with ModelServer(_pred(0), max_batch_size=8, max_wait_ms=0.0,
                     manifest=False) as srv:
        _prewarm(srv)
        before = _infer(srv, data=x)[0]
        stats0 = srv.cache_stats()
        srv.swap_params(v2_args, v2_aux)
        after = _infer(srv, data=x)[0]
        stats1 = srv.cache_stats()
        assert stats1["captures"] == stats0["captures"]
        assert stats1["binds"] == stats0["binds"]
    with ModelServer(_pred(1), max_batch_size=8, max_wait_ms=0.0,
                     manifest=False) as fresh:
        _prewarm(fresh)
        np.testing.assert_array_equal(after, _infer(fresh, data=x)[0])
    assert not np.array_equal(before, after)


def test_page_out_and_in_captures_again():
    xs = _xs(3)
    with ModelServer(_pred(), max_batch_size=8, max_wait_ms=0.0,
                     manifest=False) as srv:
        _prewarm(srv)
        before = {b: _infer(srv, data=x)[0] for b, x in xs.items()}
        cached = len(srv.cache)
        st0 = srv.cache_stats()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        nbytes = srv.cache.page_out()
        torch.cuda.synchronize()
        assert nbytes == srv.cache.resident_param_bytes() > 0
        assert mem0 - torch.cuda.memory_allocated() >= nbytes
        assert srv.cache.page_in()
        after = {b: _infer(srv, data=x)[0] for b, x in xs.items()}
        st1 = srv.cache_stats()
        assert st1["binds"] == st0["binds"]
        assert st1["captures"] - st0["captures"] == cached
    for b in xs:
        np.testing.assert_array_equal(after[b], before[b])


def test_prewarm_overlaps_traffic():
    """Clients submit while prewarm binds and captures every bucket on its
    pool: one bind and one capture a bucket, responses right."""
    xs = _xs(4, sizes=(1, 2, 3, 5, 7))
    refs = {b: _direct(x) for b, x in xs.items()}
    with ModelServer(_pred(), max_batch_size=16, max_wait_ms=1.0,
                     manifest=False) as srv:
        fut = srv.prewarm(block=False)
        errs = []

        def client(i):
            for j in range(6):
                b = (1, 2, 3, 5, 7)[(i + j) % 5]
                got = srv.submit(data=xs[b]).result(timeout=120)[0]
                if _max_rel(got, refs[b]) > 1e-4:
                    errs.append((i, j, b))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        rep = fut.result(timeout=300)
        assert rep["failed"] == [] and not errs
        stats = srv.cache_stats()
        assert stats["binds"] == stats["captures"] <= len(srv.buckets)


def _device_workload(eng, seed, n_vars=6, n_ops=120):
    """Pushes that read and write device tensors in place: out = 0.5 * out
    + sum(reads) + k (each op synchronises before it completes)."""
    rng = random.Random(seed)
    variables = [eng.new_variable() for _ in range(n_vars)]
    data = [torch.arange(64, dtype=torch.float64, device="cuda") * (i + 1)
            for i in range(n_vars)]
    for k in range(n_ops):
        picks = rng.sample(range(n_vars), rng.randint(1, 4))
        n_w = rng.randint(1, len(picks))
        writes, reads = picks[:n_w], picks[n_w:]

        def op(k=k, writes=writes, reads=reads):
            acc = torch.zeros(64, dtype=torch.float64, device="cuda")
            for r in reads:
                acc += data[r]
            for w in writes:
                data[w].mul_(0.5).add_(acc + k)
            torch.cuda.current_stream().synchronize()

        eng.push(op, const_vars=[variables[i] for i in reads],
                 mutable_vars=[variables[i] for i in writes])
    eng.wait_for_all()
    return [d.cpu().numpy() for d in data]


def test_engine_device_workloads_match_naive():
    want = _device_workload(eng_mod.NaiveEngine(), 5)
    for cls in (eng_mod.ThreadedEngine, eng_mod.NativeEngine):
        eng = cls(num_workers=4)
        try:
            for a, b in zip(_device_workload(eng, 5), want):
                np.testing.assert_array_equal(a, b)
            v = eng.new_variable()
            eng.push(lambda: torch.empty(1, device="cuda").view(5),
                     mutable_vars=(v,))
            with pytest.raises(RuntimeError):
                eng.wait_for_all()
        finally:
            eng.shutdown()

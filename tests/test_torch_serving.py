"""The port's request-batching server (mxnet_tpu_torch/serving: ModelServer,
DynamicBatcher, ExecutorCache, ShapeManifest) on the CPU: the cases of
tests/test_serving.py, and the port held to the JAX package: bucket
ladders, cost-model bucketing and waste, manifests read across packages,
and the same checkpoints served by both packages' ModelServer.

Each test runs with a fresh process engine that is shut down after it, and
every server is closed, so no thread outlives a test. ``host_graphs``
stands a host replay in for the CUDA graph (as in
tests/test_torch_forward_graph.py) to hold the capture rules here.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import engine as eng_mod
from mxnet_tpu_torch.module import step_graph
from mxnet_tpu_torch.serving import (CircuitOpen, DeadlineExceeded,
                                     ExecutorCache, LifecycleError,
                                     ModelServer, ServerClosed,
                                     ServerOverloaded, ServingMetrics,
                                     ShapeManifest, bucket_for, pow2_buckets)

FEATURES = 10
CLASSES = 4
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def engine():
    """A fresh process engine for the test, shut down after it."""
    old = eng_mod._ENGINE
    eng = eng_mod.ThreadedEngine(num_workers=4)
    eng_mod.set_engine(eng)
    yield eng
    eng_mod.set_engine(old)
    eng.shutdown()


def _mlp_params(seed=0, scale=0.3):
    net = mx.models.mlp.get_symbol(num_classes=CLASSES)
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = net.infer_shape(data=(1, FEATURES))
    return net, {name: (rng.randn(*shape) * scale).astype(np.float32)
                 for name, shape in zip(net.list_arguments(), arg_shapes)
                 if name not in ("data", "softmax_label")}


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(symbol_json, param_bytes, params_file) of a small random MLP."""
    net, params = _mlp_params()
    pfile = str(tmp_path_factory.mktemp("serving") / "model.params")
    mx.nd.save(pfile, {f"arg:{k}": mx.nd.array(v, mx.cpu())
                       for k, v in params.items()})
    with open(pfile, "rb") as f:
        param_bytes = f.read()
    return net.tojson(), param_bytes, pfile


def _pred(model, shape=(1, FEATURES)):
    json_str, param_bytes, _ = model
    return mx.Predictor(json_str, param_bytes, {"data": shape}, ctx=mx.cpu())


def _infer(srv, inputs=None, **kw):
    """``srv.infer`` with a bounded wait: a hang fails the test, not the
    suite."""
    return srv.submit(inputs, **kw).result(timeout=300)


def _prewarm(srv):
    return srv.prewarm().result(timeout=300)


def _reference_outputs(model, x):
    """A direct Predictor forward at the request's own shape."""
    pred = _pred(model, x.shape)
    pred.forward(data=x)
    return pred.get_output(0)


class _HostGraph:
    """A CUDA graph's stand-in on the CPU: ``replay`` runs the program's
    function again into the static outputs."""

    def __init__(self, prog):
        self.prog = prog

    def replay(self):
        import torch

        self.prog.rng.begin(self.prog.rng.seed)
        outs = self.prog._body()
        with torch.inference_mode():
            for s, o in zip(self.prog._static, outs):
                s.copy_(o)


@pytest.fixture
def host_graphs(monkeypatch):
    """ForwardPrograms built during the test warm up, capture into a
    :class:`_HostGraph` and replay on the CPU."""
    init = step_graph.ForwardProgram.__init__

    def host_init(prog, ex):
        init(prog, ex)
        prog.capturable = prog.refusal is None

    def warmup(prog, bound):
        prog.stats["warmups"] += 1
        prog._warm = bound
        return prog._body()

    def capture(prog, bound):
        prog.stats["captures"] += 1
        prog._static = prog._body()
        prog._graph = _HostGraph(prog)
        prog._bound = bound

    monkeypatch.setattr(step_graph.ForwardProgram, "__init__", host_init)
    monkeypatch.setattr(step_graph.ForwardProgram, "_warmup", warmup)
    monkeypatch.setattr(step_graph.ForwardProgram, "_capture", capture)


# -- the cases of tests/test_serving.py -------------------------------------------

def test_bucket_policy():
    assert pow2_buckets(8) == [1, 2, 4, 8]
    assert pow2_buckets(12) == [1, 2, 4, 8, 12]
    assert pow2_buckets(1) == [1]
    assert bucket_for(3, [1, 2, 4, 8]) == 4
    assert bucket_for(8, [1, 2, 4, 8]) == 8
    with pytest.raises(mx.MXNetError):
        bucket_for(9, [1, 2, 4, 8])


def test_concurrent_submits_match_direct_forward(model):
    """8 client threads x mixed sizes: every request's rows match a direct
    forward of that request (padding and batch neighbours do not leak)."""
    rng = np.random.RandomState(1)
    sizes = (1, 2, 3, 5)
    xs = {b: rng.randn(b, FEATURES).astype(np.float32) for b in sizes}
    refs = {b: _reference_outputs(model, xs[b]) for b in sizes}
    with ModelServer(_pred(model), max_batch_size=8, max_wait_ms=2.0,
                     manifest=False) as srv:
        results, lock = [], threading.Lock()

        def client(idx):
            got = [(sizes[(idx + i) % len(sizes)],
                    srv.submit(data=xs[sizes[(idx + i) % len(sizes)]]))
                   for i in range(3)]
            with lock:
                results.extend(got)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert len(results) == 24
        for b, fut in results:
            out = fut.result(timeout=120)
            assert out[0].shape == (b, CLASSES)
            np.testing.assert_allclose(out[0], refs[b], rtol=1e-5, atol=1e-6)
        snap = srv.metrics.snapshot()
        assert snap["completed"] == 24 and snap["failed"] == 0
        assert snap["batches"] <= 24
        assert 0.0 < snap["batch_occupancy"] <= 1.0
        assert snap["p99_ms"] >= snap["p50_ms"] > 0.0


def test_bucket_cache_compiles_once_per_bucket(model):
    rng = np.random.RandomState(2)
    with ModelServer(_pred(model), max_batch_size=8, max_wait_ms=0.5,
                     manifest=False) as srv:
        for _ in range(2):
            for b in (1, 2, 3, 4, 5, 7, 8):
                out = _infer(srv, data=rng.randn(b, FEATURES))
                assert out[0].shape == (b, CLASSES)
        stats = srv.cache_stats()
        assert stats["binds"] <= len(srv.buckets), (stats, srv.buckets)
        assert stats["binds"] == 4, stats
        assert stats["evictions"] == 0
        before = stats["binds"]
        for b in (1, 3, 5, 8):
            _infer(srv, data=rng.randn(b, FEATURES))
        assert srv.cache_stats()["binds"] == before


def test_close_drains_in_flight_requests(model):
    rng = np.random.RandomState(3)
    srv = ModelServer(_pred(model), max_batch_size=4, max_wait_ms=50.0,
                      manifest=False)
    x = rng.randn(2, FEATURES).astype(np.float32)
    want = _reference_outputs(model, x)
    futs = [srv.submit(data=x) for _ in range(10)]
    srv.close()
    for fut in futs:
        assert fut.done()
        np.testing.assert_allclose(fut.result(timeout=60)[0], want, rtol=1e-5,
                                   atol=1e-6)
    assert srv.metrics.snapshot()["completed"] == 10
    with pytest.raises(ServerClosed):
        srv.submit(data=x)
    srv.close()


def test_close_without_drain_fails_queued(model):
    srv = ModelServer(_pred(model), max_batch_size=64,
                      max_wait_ms=10_000.0, manifest=False)
    futs = [srv.submit(data=np.zeros((1, FEATURES), np.float32))
            for _ in range(4)]
    srv.close(drain=False)
    for fut in futs:
        assert fut.done()
    snap = srv.metrics.snapshot()
    assert snap["completed"] + snap["failed"] == 4
    assert snap["queue_depth"] == 0


def test_oversize_request_is_chunked(model):
    x = np.random.RandomState(4).randn(11, FEATURES).astype(np.float32)
    want = _reference_outputs(model, x)
    with ModelServer(_pred(model), max_batch_size=4, max_wait_ms=1.0,
                     manifest=False) as srv:
        out = _infer(srv, data=x)
        np.testing.assert_allclose(out[0], want, rtol=1e-5, atol=1e-6)
        assert srv.cache_stats()["binds"] == 1   # chunks 4 + 4 + 3


def test_env_var_defaults(model, monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_MAX_BATCH", "16")
    monkeypatch.setenv("MXNET_SERVING_MAX_WAIT_MS", "7.5")
    srv = ModelServer(_pred(model), manifest=False)
    try:
        assert srv._batcher._max_batch == 16
        assert srv._batcher._max_wait == pytest.approx(7.5e-3)
        assert srv.buckets == [1, 2, 4, 8, 16]
    finally:
        srv.close()


def test_bad_request_fails_its_future_not_the_server(model):
    with ModelServer(_pred(model), max_batch_size=4, max_wait_ms=1.0,
                     manifest=False) as srv:
        bad = srv.submit(data=np.zeros((1, FEATURES + 3), np.float32))
        with pytest.raises(Exception):
            bad.result(timeout=120)
        good = _infer(srv, data=np.zeros((1, FEATURES), np.float32))
        assert good[0].shape == (1, CLASSES)
        snap = srv.metrics.snapshot()
        assert snap["failed"] == 1 and snap["completed"] == 1


def test_submit_validation(model):
    with ModelServer(_pred(model), max_batch_size=4, max_wait_ms=1.0,
                     manifest=False) as srv:
        with pytest.raises(mx.MXNetError):
            srv.submit({})
        with pytest.raises(mx.MXNetError):
            srv.submit(data=np.float32(1.0))
        with pytest.raises(mx.MXNetError):
            srv.submit({"data": np.zeros((2, FEATURES)),
                        "other": np.zeros((3, FEATURES))})
        with pytest.raises(mx.MXNetError):
            srv.submit({"data": np.zeros((2, FEATURES))}, data=1)


def test_load_frombuffer_matches_load(model):
    """Params bytes load as the file does (the reference's legacy binary
    container is not ported: a foreign blob raises)."""
    _, param_bytes, pfile = model
    from_file = mx.nd.load(pfile, mx.cpu())
    from_buf = mx.nd.load_frombuffer(param_bytes, mx.cpu())
    assert set(from_file) == set(from_buf)
    for k in from_file:
        np.testing.assert_array_equal(from_file[k].asnumpy(),
                                      from_buf[k].asnumpy())
    with pytest.raises(mx.MXNetError):
        mx.nd.load_frombuffer(b"definitely not a params blob", mx.cpu())


def test_executor_cache_lru_eviction(model):
    cache = ExecutorCache(_pred(model), capacity=2)
    for b in (1, 2, 4):
        cache.get({"data": (b, FEATURES)})
    stats = cache.stats()
    assert stats["binds"] == 3 and stats["evictions"] == 1
    assert len(cache) == 2
    cache.get({"data": (4, FEATURES)})
    assert cache.stats()["hits"] == 1
    cache.get({"data": (1, FEATURES)})
    assert cache.stats()["binds"] == 4


def test_metrics_percentiles():
    m = ServingMetrics()
    for ms in range(1, 101):
        m.on_complete(ms / 1e3)
    snap = m.snapshot()
    assert snap["p50_ms"] == pytest.approx(50.5, abs=1.0)
    assert snap["p99_ms"] == pytest.approx(99.0, abs=1.1)
    assert snap["completed"] == 100


def test_serve_bench_32_clients_binds_bounded():
    """The port's serve_bench.py with 32 clients over 3 request sizes: at
    most one bind a bucket, p50/p99 and occupancy reported."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MXNET_COMPILE_CACHE_DIR", "MXNET_SERVING_MANIFEST")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.serve_bench",
         "--clients", "32", "--requests", "2", "--batch-sizes", "1,3,5",
         "--max-batch", "16", "--max-wait-ms", "2", "--cpu", "--json"],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, f"stdout:{r.stdout}\nstderr:{r.stderr}"
    rep = json.loads(r.stdout)
    assert rep["requests"] == 64
    assert rep["metrics"]["completed"] == 64
    assert rep["metrics"]["failed"] == 0
    assert rep["cache"]["binds"] <= len(rep["buckets"])
    assert rep["cache"]["binds"] == rep["cache"]["misses"]
    assert rep["metrics"]["p99_ms"] >= rep["metrics"]["p50_ms"] > 0
    assert 0 < rep["metrics"]["batch_occupancy"] <= 1


def test_prewarm_zero_compiles_at_first_request(model, host_graphs):
    """Prewarm binds and builds (warms up and captures) every bucket; the
    first request then builds no program."""
    with ModelServer(_pred(model), max_batch_size=8, max_wait_ms=1.0,
                     manifest=False) as srv:
        rep = _prewarm(srv)
        assert rep["source"] == "buckets"
        assert rep["bound"] == len(srv.buckets)
        assert rep["compiled"] == len(srv.buckets)
        assert rep["failed"] == []
        assert rep["seconds"] > 0
        assert srv.prewarm_report == rep
        stats = srv.cache_stats()
        assert stats["binds"] == stats["warmed"] == len(srv.buckets)
        assert stats["captures"] == len(srv.buckets)
        out = _infer(srv, data=np.zeros((3, FEATURES), np.float32))
        assert out[0].shape == (3, CLASSES)
        assert srv.first_request_compiles == 0
        snap = srv.metrics.snapshot()
        assert snap["first_request_compiles"] == 0
        assert snap["prewarm_seconds"] == pytest.approx(rep["seconds"])
        assert srv.cache_stats()["binds"] == len(srv.buckets)
        assert srv.cache_stats()["captures"] == len(srv.buckets)


def test_prewarm_overlaps_traffic_and_never_compiles_twice(model,
                                                           host_graphs):
    """Traffic for a bucket mid-prewarm waits for that bucket's one bind
    and capture: one bind and one capture a bucket."""
    pred = _pred(model)
    bind_counts = {}
    orig = mx.Predictor.bind_forward

    def slow_bind(self, input_shapes):
        key = tuple(sorted((k, tuple(v)) for k, v in input_shapes.items()))
        bind_counts[key] = bind_counts.get(key, 0) + 1
        time.sleep(0.15)
        return orig(self, input_shapes)

    x = np.random.RandomState(11).randn(3, FEATURES).astype(np.float32)
    want = _reference_outputs(model, x)
    mx.Predictor.bind_forward = slow_bind
    try:
        with ModelServer(pred, max_batch_size=8, max_wait_ms=1.0,
                         manifest=False) as srv:
            fut = srv.prewarm(block=False)
            out = _infer(srv, data=x)
            np.testing.assert_allclose(out[0], want, rtol=1e-5, atol=1e-6)
            rep = fut.result(timeout=120)
            assert rep["failed"] == []
            assert all(c == 1 for c in bind_counts.values()), bind_counts
            stats = srv.cache_stats()
            assert stats["binds"] == stats["captures"] == len(srv.buckets)
    finally:
        mx.Predictor.bind_forward = orig


def test_manifest_records_and_replays(model, tmp_path):
    man_path = str(tmp_path / "serving_manifest.json")
    rng = np.random.RandomState(6)
    with ModelServer(_pred(model), max_batch_size=8, max_wait_ms=0.5,
                     manifest=man_path) as srv:
        for b in (1, 3, 5):
            _infer(srv, data=rng.randn(b, FEATURES))
        hit_buckets = {1, 4, 8}
        assert srv.manifest.size() == len(hit_buckets)
    doc = json.loads(open(man_path).read())
    assert {e["shapes"]["data"][0] for e in doc["entries"]} == hit_buckets
    assert doc["histogram"] == {"1": 1.0, "3": 1.0, "5": 1.0}
    assert not os.path.exists(man_path + ".tmp")
    with ModelServer(_pred(model), max_batch_size=8, max_wait_ms=0.5,
                     manifest=man_path) as srv2:
        rep = _prewarm(srv2)
        assert rep["source"] == "manifest"
        assert rep["bound"] == len(hit_buckets)
        before = srv2.cache_stats()["binds"]
        out = _infer(srv2, data=rng.randn(3, FEATURES))
        assert out[0].shape == (3, CLASSES)
        assert srv2.cache_stats()["binds"] == before


def test_manifest_auto_buckets_close_the_loop(model, tmp_path):
    man_path = str(tmp_path / "manifest.json")
    rng = np.random.RandomState(8)
    with ModelServer(_pred(model), max_batch_size=16, max_wait_ms=0.0,
                     manifest=man_path) as srv:
        for _ in range(20):
            _infer(srv, data=rng.randn(3, FEATURES))
    with ModelServer(_pred(model), max_batch_size=16, max_wait_ms=0.0,
                     manifest=man_path, buckets="auto") as srv2:
        assert 3 in srv2.buckets and srv2.buckets[-1] == 16
        assert srv2.bucket_waste["waste_ratio"] == 0.0
        _infer(srv2, data=rng.randn(3, FEATURES))
        assert srv2.metrics.snapshot()["padded_rows"] == 0


def test_manifest_env_resolution(monkeypatch, tmp_path):
    from mxnet_tpu_torch.serving import default_manifest_path

    monkeypatch.delenv("MXNET_SERVING_MANIFEST", raising=False)
    monkeypatch.delenv("MXNET_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.delenv("MXTPU_COMPILE_CACHE", raising=False)
    assert default_manifest_path() is None
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    assert default_manifest_path() == os.path.join(
        str(tmp_path / "cc"), "serving_manifest.json")
    monkeypatch.setenv("MXNET_SERVING_MANIFEST", "0")
    assert default_manifest_path() is None
    monkeypatch.setenv("MXNET_SERVING_MANIFEST", str(tmp_path / "m.json"))
    assert default_manifest_path() == str(tmp_path / "m.json")


def test_manifest_corrupt_file_tolerated(tmp_path):
    path = str(tmp_path / "manifest.json")
    with open(path, "w") as f:
        f.write("{definitely not json")
    man = ShapeManifest(path)
    assert man.size() == 0 and man.load_error is not None
    assert man.record({"data": (4, 10)}) is True
    assert man.record({"data": (4, 10)}) is False
    man.set_histogram({3: 7})
    man.save()
    man2 = ShapeManifest(path)
    assert man2.entries() == [{"data": (4, 10)}]
    assert man2.histogram() == {3: 7.0}


def test_executor_cache_concurrent_misses_bind_once(model):
    pred = _pred(model)
    calls = []
    orig = pred.bind_forward

    def slow_bind(input_shapes):
        calls.append(dict(input_shapes))
        time.sleep(0.2)
        return orig(input_shapes)

    pred.bind_forward = slow_bind
    cache = ExecutorCache(pred, capacity=4)
    results, errs = [], []

    def get():
        try:
            results.append(cache.get({"data": (4, FEATURES)}))
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=get) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errs and len(results) == 4
    assert all(r[0] is results[0][0] for r in results)
    assert len(calls) == 1
    stats = cache.stats()
    assert stats["binds"] == 1 and stats["bind_waits"] == 3


def test_eviction_does_not_race_inflight_bind(model):
    pred = _pred(model)
    counts = {}
    orig = pred.bind_forward

    def slow_bind(input_shapes):
        key = tuple(sorted(input_shapes.items()))
        counts[key] = counts.get(key, 0) + 1
        if input_shapes["data"][0] == 8:
            time.sleep(0.3)
        return orig(input_shapes)

    pred.bind_forward = slow_bind
    cache = ExecutorCache(pred, capacity=1)
    warm_result = {}
    t = threading.Thread(target=lambda: warm_result.update(
        report=cache.warm({"data": (8, FEATURES)})))
    t.start()
    time.sleep(0.05)
    for b in (1, 2, 4, 1, 2):
        cache.get({"data": (b, FEATURES)})
    t.join(30)
    assert not t.is_alive()
    assert warm_result["report"]["bound"] is True
    assert warm_result["report"]["compiled"] is True
    assert counts[tuple(sorted({"data": (8, FEATURES)}.items()))] == 1
    stats = cache.stats()
    assert stats["evictions"] >= 1
    assert stats["binds"] == stats["misses"]
    ex, _ = cache.get({"data": (8, FEATURES)})
    ex.forward(is_train=False, data=np.zeros((8, FEATURES), np.float32))
    assert ex.outputs[0].shape == (8, CLASSES)


def test_prewarm_env_knob(model, monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_PREWARM", "1")
    srv = ModelServer(_pred(model), max_batch_size=4, max_wait_ms=1.0,
                      manifest=False)
    try:
        deadline = time.time() + 60
        while srv.prewarm_report is None and time.time() < deadline:
            time.sleep(0.02)
        assert srv.prewarm_report is not None
        assert srv.prewarm_report["bound"] == len(srv.buckets)
    finally:
        srv.close()


def test_rows_histogram_in_metrics(model):
    rng = np.random.RandomState(12)
    with ModelServer(_pred(model), max_batch_size=8, max_wait_ms=0.5,
                     manifest=False) as srv:
        for b in (3, 3, 5, 3):
            _infer(srv, data=rng.randn(b, FEATURES))
        assert srv.metrics.rows_histogram() == {3: 3, 5: 1}
        assert srv.metrics.snapshot()["rows_hist"] == {3: 3, 5: 1}


def test_serving_soak(model):
    """Sustained mixed traffic from 8 clients: no loss, binds bounded,
    occupancy above 0.3."""
    rng = np.random.RandomState(5)
    xs = {b: rng.randn(b, FEATURES).astype(np.float32) for b in range(1, 9)}
    with ModelServer(_pred(model), max_batch_size=8, max_wait_ms=1.0,
                     manifest=False) as srv:
        errs = []

        def client(idx):
            for i in range(60):
                b = (idx + i) % 8 + 1
                try:
                    out = srv.submit(data=xs[b]).result(timeout=120)
                    if out[0].shape != (b, CLASSES):
                        errs.append((idx, i, out[0].shape))
                except Exception as e:
                    errs.append((idx, i, repr(e)))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert not errs, errs[:5]
        snap = srv.metrics.snapshot()
        assert snap["completed"] == 8 * 60 and snap["failed"] == 0
        assert snap["batch_occupancy"] > 0.3
        assert srv.cache_stats()["binds"] <= len(srv.buckets)


# -- the port's own: capture, swap, paging, admission -----------------------------

def test_one_capture_a_bucket(model, host_graphs):
    """Steady traffic: one bind and one capture a bucket, then replays,
    and the replayed responses equal direct forwards."""
    rng = np.random.RandomState(13)
    xs = {b: rng.randn(b, FEATURES).astype(np.float32) for b in (1, 3, 5)}
    with ModelServer(_pred(model), max_batch_size=8, max_wait_ms=0.0,
                     manifest=False) as srv:
        for _ in range(4):
            for b, x in xs.items():
                np.testing.assert_allclose(
                    _infer(srv, data=x)[0], _reference_outputs(model, x),
                    rtol=1e-5, atol=1e-6)
        stats = srv.cache_stats()
        # a bucket's first batch warms up and captures on the batch's
        # thread (one replay), then every forward replays
        assert stats["binds"] == stats["captures"] == 3
        assert stats["warmups"] == 3 and stats["replays"] == 3 * 5
        assert stats["drops"] == 0 and stats["eager_runs"] == 0
        infos = srv.cache.programs()
        assert all(i["captures"] == 1 for i in infos.values())


def test_capture_runs_on_the_warm_up_thread(model, host_graphs):
    """A binding's capture runs on the thread of its last warm-up (cuBLAS
    and cuDNN make a handle a thread at first use, which a capture may
    not): a forward on another thread warms up again there; replays run
    on any thread."""
    ex = _pred(model, (2, FEATURES))._executor

    def on_new_thread():
        t = threading.Thread(target=lambda: ex.forward(is_train=False))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()

    on_new_thread()
    ex.forward(is_train=False)
    info = ex.forward_info()
    assert (info["warmups"], info["captures"]) == (2, 0)
    ex.forward(is_train=False)
    on_new_thread()
    info = ex.forward_info()
    assert (info["warmups"], info["captures"], info["replays"]) == (2, 1, 2)


def test_swap_params_keeps_graphs(model, host_graphs):
    """A swap through the engine copies into the bound weights: zero new
    binds and captures, and the responses equal a fresh server's on the
    new weights; a mismatched version is refused with the old one
    serving."""
    _, v2 = _mlp_params(seed=1)
    x = np.random.RandomState(14).randn(3, FEATURES).astype(np.float32)
    with ModelServer(_pred(model), max_batch_size=8, max_wait_ms=0.0,
                     manifest=False) as srv:
        _prewarm(srv)
        before = _infer(srv, data=x)[0]
        stats0 = srv.cache_stats()
        assert srv.swap_params(v2) > 0
        after = _infer(srv, data=x)[0]
        stats1 = srv.cache_stats()
        assert (stats1["binds"], stats1["captures"]) == \
            (stats0["binds"], stats0["captures"])
        assert stats1["param_swaps"] == 1
        fresh = mx.Predictor.from_arrays(
            mx.models.mlp.get_symbol(num_classes=CLASSES), v2, {},
            {"data": (1, FEATURES)}, ctx=mx.cpu())
        with ModelServer(fresh, max_batch_size=8, max_wait_ms=0.0,
                         manifest=False) as ref:
            _prewarm(ref)
            np.testing.assert_array_equal(after, _infer(ref, data=x)[0])
        assert not np.array_equal(before, after)
        bad = dict(v2)
        bad.pop(next(iter(bad)))
        with pytest.raises(LifecycleError, match="missing"):
            srv.swap_params(bad)
        wrong = {k: np.zeros((2, 2), np.float32) for k in v2}
        with pytest.raises(LifecycleError, match="shape"):
            srv.swap_params(wrong)
        np.testing.assert_array_equal(_infer(srv, data=x)[0], after)


def test_paging_on_the_cpu_is_a_no_op(model):
    """Weights on the CPU have no device memory to free: page_out moves
    nothing; pin makes it refuse."""
    with ModelServer(_pred(model), max_batch_size=4, max_wait_ms=0.0,
                     manifest=False) as srv:
        srv.cache.pin()
        assert srv.cache.page_out() == 0
        srv.cache.unpin()
        assert srv.cache.page_out() == 0
        assert srv.cache.page_in() is False
        assert srv.cache.resident_param_bytes() == sum(
            v.nbytes for v in _mlp_params()[1].values())
        assert _infer(srv, data=np.zeros((2, FEATURES)))[0].shape == \
            (2, CLASSES)


def test_admission_breaker_deadline_and_queue_cap(model, monkeypatch):
    """The typed admission errors: ServerOverloaded at queue_cap,
    DeadlineExceeded for an expired request, CircuitOpen after the
    breaker's threshold of failed batches."""
    with ModelServer(_pred(model), max_batch_size=64, max_wait_ms=300.0,
                     queue_cap=2, manifest=False) as srv:
        futs = [srv.submit(data=np.zeros((1, FEATURES))) for _ in range(2)]
        with pytest.raises(ServerOverloaded):
            srv.submit(data=np.zeros((1, FEATURES)))
        for f in futs:
            f.result(timeout=60)
        assert srv.metrics.snapshot()["shed"] == 1
    with ModelServer(_pred(model), max_batch_size=64, max_wait_ms=200.0,
                     manifest=False) as srv:
        late = srv.submit(data=np.zeros((1, FEATURES)), timeout_s=0.01)
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=60)
        assert srv.metrics.snapshot()["expired"] == 1
    with ModelServer(_pred(model), max_batch_size=4, max_wait_ms=0.0,
                     breaker_threshold=2, breaker_reset_s=60,
                     manifest=False) as srv:
        for _ in range(2):
            with pytest.raises(mx.MXNetError):
                _infer(srv, data=np.zeros((1, FEATURES + 1)))
        assert srv.breaker.state == "open"
        with pytest.raises(CircuitOpen):
            srv.submit(data=np.zeros((1, FEATURES)))


def test_server_refuses_what_is_not_ported(model):
    for kw in ({"tenants": "gold:prio=0"}, {"scheduler": object()},
               {"sharding_rules": "dp"}):
        with pytest.raises(mx.MXNetError, match="not ported"):
            ModelServer(_pred(model), manifest=False, **kw)


def test_no_thread_left_behind(model, engine):
    """A closed server and a shut-down engine leave no thread."""
    before = {t.ident for t in threading.enumerate()}
    with ModelServer(_pred(model), max_batch_size=4, max_wait_ms=0.0,
                     manifest=False) as srv:
        _prewarm(srv)
        _infer(srv, data=np.zeros((3, FEATURES)))
    engine.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.ident not in before and t.is_alive()]
    assert left == []


# -- held to the JAX package -------------------------------------------------------

_SPECS = (None, "pow2", "auto", "1,4,16", "3, 7", (5, 1, 2))
_MAXES = (1, 5, 8, 16, 32)
_HISTS = ({}, {3: 10}, {1: 5, 3: 2, 7: 1}, {2: 1, 5: 3, 9: 4, 40: 1},
          {1: 100, 2: 1, 31: 7, 32: 2})
_COSTS = ((1.0, 0.0), (2.5, 7.0), (0.0, 1.0))


@pytest.mark.parametrize("max_batch", _MAXES)
def test_bucket_ladders_match_reference(max_batch):
    """resolve_buckets, choose_buckets and expected_waste equal the JAX
    package's over a grid of specs, histograms and cost models."""
    from mxnet_tpu import costmodel as jcm
    from mxnet_tpu.serving import batcher as jb

    from mxnet_tpu_torch import costmodel as tcm
    from mxnet_tpu_torch.serving import batcher as tb

    for spec in _SPECS:
        for hist in _HISTS:
            for per_row, fixed in _COSTS:
                jm = jcm.LinearCostModel(per_row, fixed)
                tm = tcm.LinearCostModel(per_row, fixed)
                want = jb.resolve_buckets(spec, max_batch, histogram=hist,
                                          cost_model=jm)
                got = tb.resolve_buckets(spec, max_batch, histogram=hist,
                                         cost_model=tm)
                assert got == want, (spec, max_batch, hist)
                if hist:
                    for k in (None, 2, 3):
                        assert tcm.choose_buckets(
                            hist, max_batch, cost_model=tm, max_buckets=k,
                            per_bucket_cost=fixed) == jcm.choose_buckets(
                            hist, max_batch, cost_model=jm, max_buckets=k,
                            per_bucket_cost=fixed)
                assert tcm.expected_waste(
                    got, hist, max_batch_size=max_batch,
                    cost_model=tm) == pytest.approx(jcm.expected_waste(
                        want, hist, max_batch_size=max_batch,
                        cost_model=jm))
    pts = [(1, 3.0), (4, 9.5), (16, 30.0)]
    a, b = tcm.LinearCostModel.fit(pts), jcm.LinearCostModel.fit(pts)
    assert (a.per_row, a.fixed) == pytest.approx((b.per_row, b.fixed))


def test_manifest_read_across_packages(tmp_path):
    """A manifest written by either package loads in the other: the same
    entries and histogram."""
    from mxnet_tpu.serving import ShapeManifest as JManifest

    for writer, reader in ((JManifest, ShapeManifest),
                           (ShapeManifest, JManifest)):
        path = str(tmp_path / f"{writer.__module__}.json")
        man = writer(path)
        assert man.record({"data": (4, 3, 32, 32)})
        assert man.record({"data": (8, 3, 32, 32), "aux": (8, 5)})
        man.set_histogram({3: 4, 5: 1})
        man.save()
        other = reader(path)
        assert other.load_error is None
        assert other.entries() == [{"data": (4, 3, 32, 32)},
                                   {"data": (8, 3, 32, 32), "aux": (8, 5)}]
        assert other.histogram() == {3: 4.0, 5: 1.0}


def _jax_checkpoint(kind, prefix):
    """Seeded weights of an MLP or a narrow ResNet (depth 8, 32 px),
    written by the JAX package; returns (input template, request sizes)."""
    import mxnet_tpu as mxj

    if kind == "mlp":
        sym = mxj.models.mlp.get_symbol(num_classes=CLASSES)
        shape = (1, FEATURES)
    else:
        sym = mxj.models.resnet.get_symbol(num_classes=10, num_layers=8,
                                           image_shape="3,32,32")
        shape = (1, 3, 32, 32)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    rng = np.random.RandomState(21)
    args = {n: mxj.nd.array((rng.randn(*s) * 0.3).astype(np.float32))
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: mxj.nd.array((rng.rand(*s) + (0.5 if "var" in n else -0.5))
                           .astype(np.float32))
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    mxj.model.save_checkpoint(prefix, 0, sym, args, aux)
    return shape


@pytest.mark.parametrize("kind", ["mlp", "resnet8_32px"])
def test_checkpoint_served_by_both_packages(kind, tmp_path):
    """The same checkpoint, written by the JAX package, served by both
    packages' ModelServer over the same requests (one request a batch,
    each padded into its bucket): responses within the reference's rtol
    1e-5, atol 1e-6."""
    import mxnet_tpu as mxj
    from mxnet_tpu import engine as jeng

    prefix = str(tmp_path / kind)
    shape = _jax_checkpoint(kind, prefix)
    files = (f"{prefix}-symbol.json", f"{prefix}-0000.params")
    rng = np.random.RandomState(22)
    xs = [rng.randn(b, *shape[1:]).astype(np.float32) for b in (1, 3, 5)]
    jengine = jeng.ThreadedEngine(num_workers=2)
    try:
        with mxj.ModelServer(files, {"data": shape}, ctx=mxj.cpu(),
                             max_batch_size=8, max_wait_ms=0.0,
                             engine=jengine, manifest=False) as jsrv:
            want = [_infer(jsrv, data=x)[0] for x in xs]
    finally:
        jengine.wait_for_all()
        jengine._pool.shutdown(wait=True)
    with ModelServer(files, {"data": shape}, ctx=mx.cpu(),
                     max_batch_size=8, max_wait_ms=0.0,
                     manifest=False) as srv:
        got = [_infer(srv, data=x)[0] for x in xs]
        assert srv.buckets == [1, 2, 4, 8]
    for g, w, x in zip(got, want, xs):
        assert g.shape == w.shape == (x.shape[0], w.shape[1])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)

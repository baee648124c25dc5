"""ModelServer: the serving front door over Predictor and DynamicBatcher
(reference: mxnet_tpu/serving/server.py).

Owns a Predictor (or builds one from a saved symbol and params), a
bucket-keyed executor cache, a dynamic batcher and a metrics sink. Many
client threads call :meth:`submit`; one bound executor a shape bucket
serves the coalesced traffic, so the number of bindings (and, on the card,
of captured graphs) stays bounded however request sizes vary.

Environment defaults (the reference's):

- ``MXNET_SERVING_MAX_BATCH``: coalescing ceiling in rows (default 64);
- ``MXNET_SERVING_MAX_WAIT_MS``: batch-formation wait (default 2.0 ms);
- ``MXNET_SERVING_CACHE_CAP``: executor-cache capacity (default: bucket
  count + 2);
- ``MXNET_SERVING_QUEUE_CAP``: submits beyond this many pending requests
  raise ``ServerOverloaded`` (default 0: unbounded);
- ``MXNET_SERVING_DEADLINE_S``: default request deadline (default 0: none);
- ``MXNET_BREAKER_THRESHOLD`` / ``MXNET_BREAKER_RESET_S``: the circuit
  breaker (default 5 failures, 30 s);
- ``MXNET_SERVING_BUCKETS``: ``pow2`` (default), ``auto`` or a comma list;
- ``MXNET_SERVING_MANIFEST``: the shape manifest's location (see
  :mod:`~mxnet_tpu_torch.serving.manifest`);
- ``MXNET_SERVING_PREWARM``: ``1`` starts a background :meth:`prewarm` at
  construction.

The reference also reads an autotuning artifact and a learned perf model
for its defaults; with neither present it takes the shipped defaults and
the environment, which is what the port does. Its tenants and SLO
scheduler, recovery pager, tracing and health registry are not ported.
The device is ``gpu(0)`` unless ``ctx`` says otherwise (a Predictor passed
in keeps its own); with no GPU and no ``ctx`` construction raises.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

from .. import env
from ..base import MXNetError
from ..predictor import Predictor
from .batcher import DynamicBatcher, resolve_buckets
from .errors import ServerClosed
from .executor_cache import ExecutorCache
from .manifest import ShapeManifest, default_manifest_path
from .metrics import ServingMetrics
from .policy import CircuitBreaker

__all__ = ["ModelServer"]


class ModelServer:
    """Dynamic-batching inference server.

    Parameters
    ----------
    model : Predictor, or (symbol_json_or_file, param_bytes_or_file)
        A Predictor, or the saved artifacts to build one from
        (``input_shapes`` then gives the template shapes; its batch dim is
        only a template: requests may have any rows).
    input_shapes : dict, optional
        Required when ``model`` is a (symbol, params) pair.
    ctx : Context, optional
        The device of a Predictor built here (default ``gpu(0)``).
    max_batch_size / max_wait_ms / buckets / cache_capacity / engine
        See :class:`DynamicBatcher` / :class:`ExecutorCache`; ``None``
        takes the ``MXNET_SERVING_*`` variables, then the defaults.
    manifest : path | ShapeManifest | False, optional
        The shape manifest (``None``: the ``MXNET_SERVING_MANIFEST``
        resolution; ``False``: none).
    batch_histogram : dict, optional
        Request rows -> weight for ``buckets="auto"`` (default: the
        manifest's histogram from earlier runs).
    cost_model : mxnet_tpu_torch.costmodel.LinearCostModel, optional
        The step-cost model of ``auto`` bucketing (default: fit from the
        predictor's operation counts).
    prewarm : bool, optional
        Start a background :meth:`prewarm` at construction (default
        ``MXNET_SERVING_PREWARM``).
    tenants, scheduler, sharding_rules, mesh :
        Not ported (anything but None raises); ``model_name`` is
        accepted and unused.
    """

    def __init__(self, model, input_shapes=None, ctx=None,
                 max_batch_size=None, max_wait_ms=None, buckets=None,
                 cache_capacity=None, engine=None, queue_cap=None,
                 deadline_s=None, breaker_threshold=None,
                 breaker_reset_s=None, sharding_rules=None, mesh=None,
                 manifest=None, batch_histogram=None, cost_model=None,
                 prewarm=None, tenants=None, scheduler=None,
                 model_name="default"):
        if tenants is not None or scheduler is not None:
            raise MXNetError("ModelServer: tenants= and scheduler= (the SLO "
                             "scheduler and its tenant quotas) are not "
                             "ported")
        if sharding_rules is not None or mesh is not None:
            raise MXNetError("ModelServer: sharding_rules= and mesh= are "
                             "not ported")
        if isinstance(model, Predictor):
            self._predictor = model
        else:
            if input_shapes is None:
                raise MXNetError(
                    "ModelServer: input_shapes is required when building "
                    "the Predictor from saved symbol + params")
            symbol, params = model
            self._predictor = Predictor(symbol, params, input_shapes,
                                        ctx=ctx)
        if max_batch_size is None:
            max_batch_size = int(env.get_float("MXNET_SERVING_MAX_BATCH", 64,
                                               strict=True))
        if max_wait_ms is None:
            max_wait_ms = env.get_float("MXNET_SERVING_MAX_WAIT_MS", 2.0,
                                        strict=True)
        if manifest is None:
            path = default_manifest_path()
            self._manifest = ShapeManifest(path) if path else None
        elif manifest is False:
            self._manifest = None
        elif isinstance(manifest, ShapeManifest):
            self._manifest = manifest
        else:
            self._manifest = ShapeManifest(str(manifest))
        buckets, self.bucket_waste = self._resolve_buckets(
            buckets, max_batch_size, batch_histogram, cost_model)
        if cache_capacity is None:
            cache_capacity = int(env.get_float(
                "MXNET_SERVING_CACHE_CAP", len(buckets) + 2, strict=True))
        if queue_cap is None:
            queue_cap = int(env.get_float("MXNET_SERVING_QUEUE_CAP", 0,
                                          strict=True))
        if deadline_s is None:
            deadline_s = env.get_float("MXNET_SERVING_DEADLINE_S", 0.0,
                                       strict=True) or None
        self.metrics = ServingMetrics()
        if self.bucket_waste is not None:
            self.metrics.on_expected_waste(self.bucket_waste["waste_ratio"])
        self.cache = ExecutorCache(self._predictor, capacity=cache_capacity,
                                   manifest=self._manifest)
        self.breaker = CircuitBreaker(threshold=breaker_threshold,
                                      reset_s=breaker_reset_s)
        self._batcher = DynamicBatcher(self.cache, self.metrics,
                                       max_batch_size=max_batch_size,
                                       max_wait_ms=max_wait_ms,
                                       buckets=buckets, engine=engine,
                                       queue_cap=queue_cap,
                                       deadline_s=deadline_s,
                                       breaker=self.breaker,
                                       model_name=model_name)
        self._closed = False
        self._first_lock = threading.Lock()
        self._first_pending = True
        self.first_request_compiles = None
        self.prewarm_report = None
        self._prewarm_threads = []
        if prewarm is None:
            prewarm = env.get_bool("MXNET_SERVING_PREWARM")
        if prewarm:
            self.prewarm()

    def _resolve_buckets(self, spec, max_batch_size, histogram, cost_model):
        """(bucket list, expected-waste accounting or None). ``auto`` takes
        the manifest's histogram when none is given and fits the cost
        model from operation counts; anything that fails falls back to the
        pow2 ladder's accounting rather than failing construction."""
        from .. import costmodel

        if spec is None:
            spec = env.get_str("MXNET_SERVING_BUCKETS")
        if spec is None:
            spec = "pow2"
        wants_auto = isinstance(spec, str) and spec.strip().lower() == "auto"
        if wants_auto:
            if histogram is None and self._manifest is not None:
                histogram = self._manifest.histogram() or None
            if histogram and cost_model is None:
                try:
                    cost_model = costmodel.fit_cost_model(self._predictor,
                                                          max_batch_size)
                except Exception:
                    cost_model = None  # padded-rows accounting
        self._cost_model = cost_model
        buckets = resolve_buckets(spec, max_batch_size, histogram=histogram,
                                  cost_model=cost_model)
        waste = None
        if wants_auto and histogram:
            waste = costmodel.expected_waste(buckets, histogram,
                                             max_batch_size=max_batch_size,
                                             cost_model=cost_model)
        return buckets, waste

    # -- API ---------------------------------------------------------------------
    @property
    def predictor(self):
        return self._predictor

    @property
    def buckets(self):
        return list(self._batcher.buckets)

    @property
    def manifest(self):
        """The shape manifest backing restart prewarm (None when off)."""
        return self._manifest

    @property
    def params_var(self):
        """The engine var every batch reads. Push host work that changes
        the weights with it in ``mutable_vars`` to land between batches."""
        return self._batcher.params_var

    # -- prewarming --------------------------------------------------------------
    def _prewarm_signatures(self, signatures):
        """(input-shape dicts to warm, their source): ``signatures``; else
        the manifest's recorded binds on the live ladder; else the bind
        template crossed with every bucket."""
        if signatures is not None:
            return [dict(s) for s in signatures], "explicit"
        buckets = set(self.buckets)
        if self._manifest is not None:
            ents = [s for s in self._manifest.entries()
                    if all(tuple(dims)[0] in buckets
                           for dims in s.values())]
            if ents:
                return ents, "manifest"
        feats = {name: tuple(shape)[1:]
                 for name, shape in self._predictor._input_shapes.items()}
        return [{n: (b,) + f for n, f in feats.items()}
                for b in sorted(buckets)], "buckets"

    def prewarm(self, signatures=None, block=False, workers=None):
        """Bind and build (warm up and capture) every signature's executor
        on a background thread pool while :meth:`submit` keeps serving; a
        request for a bucket not warm yet waits for that bucket's one bind.
        Captures run one at a time (``step_graph.CAPTURE_LOCK``).

        Returns a Future resolving to the report ``{"source",
        "signatures", "bound", "compiled", "failed", "seconds"}``
        (``block=True`` waits and returns the report); it also lands on
        ``self.prewarm_report``."""
        sigs, source = self._prewarm_signatures(signatures)
        fut = Future()

        def _one(shapes):
            try:
                return self.cache.warm(shapes), None
            except Exception as e:  # a bad manifest entry must not abort
                return None, f"{shapes}: {e!r}"

        def _run():
            t0 = time.perf_counter()
            reports, failed = [], []
            if sigs:
                pool = ThreadPoolExecutor(
                    max_workers=max(1, min(workers or 4, len(sigs))),
                    thread_name_prefix="mxtpu-serving-prewarm")
                try:
                    for rep, err in pool.map(_one, sigs):
                        if err is not None:
                            failed.append(err)
                        else:
                            reports.append(rep)
                finally:
                    pool.shutdown(wait=True)
            report = {
                "source": source,
                "signatures": len(sigs),
                "bound": sum(1 for r in reports if r["bound"]),
                "compiled": sum(1 for r in reports if r["compiled"]),
                "failed": failed,
                "seconds": time.perf_counter() - t0,
            }
            self.prewarm_report = report
            self.metrics.on_prewarm(report["seconds"])
            fut.set_result(report)

        t = threading.Thread(target=_run, name="mxtpu-serving-prewarm",
                             daemon=True)
        self._prewarm_threads.append(t)
        t.start()
        if block:
            return fut.result()
        return fut

    # -- first-request accounting ------------------------------------------------
    def _builds(self):
        st = self.cache.stats()
        return st["warmups"] + st["captures"]

    def _note_first_request(self, fut):
        """How many programs (warm-ups and captures) the first request
        built between its submit and its completion: 0 when prewarm did
        its job (the reference counts XLA compiles)."""
        with self._first_lock:
            if not self._first_pending:
                return
            self._first_pending = False
        baseline = self._builds()

        def _done(_f):
            self.first_request_compiles = self._builds() - baseline
            self.metrics.on_first_request(self.first_request_compiles)

        fut.add_done_callback(_done)

    def submit(self, inputs=None, timeout_s=None, tenant=None, **kw):
        """Enqueue one inference request; returns a Future resolving to the
        list of per-output arrays (rows matching the request's batch dim).
        Takes a dict or keyword inputs (``submit(data=x)``). Raises at once:
        ``ServerClosed`` after close(), ``ServerOverloaded`` when the queue
        is full, ``CircuitOpen`` while the breaker is open."""
        if inputs is None:
            inputs = kw
        elif kw:
            raise MXNetError("submit: pass a dict or kwargs, not both")
        if self._closed:
            raise ServerClosed("ModelServer.submit after close()")
        fut = self._batcher.submit(inputs, timeout_s=timeout_s, tenant=tenant)
        if self._first_pending:
            self._note_first_request(fut)
        return fut

    def infer(self, inputs=None, timeout_s=None, tenant=None, **kw):
        """Blocking: ``submit(...).result()``."""
        return self.submit(inputs, timeout_s=timeout_s, tenant=tenant,
                           **kw).result()

    def swap_params(self, arg_params, aux_params=None):
        """Hot-swap the served weights (:meth:`ExecutorCache.swap_params`)
        through the engine with :attr:`params_var` written, so the swap
        lands between batches: batches pushed before it run on the old
        weights, batches after on the new. Blocks until done; returns the
        bytes swapped. (The reference's ``ModelLifecycle`` makes this
        push; the lifecycle tier is not ported.)"""
        out = {}

        def _swap():
            # a refused swap is the caller's error: it must not taint the
            # params var every later batch reads
            try:
                out["bytes"] = self.cache.swap_params(arg_params, aux_params)
            except Exception as e:
                out["error"] = e

        engine = self._batcher._engine
        engine.push(_swap, mutable_vars=(self.params_var,),
                    name="serving:swap_params")
        engine.wait_for_var(self.params_var)
        if "error" in out:
            raise out["error"]
        return out["bytes"]

    def cache_stats(self):
        return self.cache.stats()

    def close(self, drain=True):
        """Stop accepting requests and (by default) drain the work in
        flight. Idempotent; once it returns every Future returned before
        is resolved and no thread of the server is left."""
        if self._closed:
            return
        self._closed = True
        self._batcher.close(drain=drain)
        for t in self._prewarm_threads:
            t.join()
        if self._manifest is not None:
            # fold this run's traffic into the kept histogram
            self._manifest.set_histogram(self.metrics.rows_histogram())
            self._manifest.save()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

"""Dynamic micro-batcher: coalesce, bucket-pad, dispatch, split (reference:
mxnet_tpu/serving/batcher.py).

Requests from many client threads queue here; one worker thread coalesces
them up to ``max_batch_size`` rows or ``max_wait_ms``, pads the rows up to
a fixed set of batch-dim buckets (powers of two by default), runs the
bucket's cached executor and splits the padded outputs back per request.

Each batch is pushed through the dependency engine with the server's
params var read and its executor var written: host work that changes the
weights (a swap) declares the params var mutable and lands between
batches; batches serialise on the executor var (one device stream), and the
worker coalesces the next batch while the engine runs this one.

On the card a bucket's forward replays one captured graph whose outputs
are its own buffers. The batch body therefore copies the outputs to the
host inside the engine op, before the executor var lets the next batch
run; a client never sees a view of a bound output. The rows are staged in
a host buffer a bucket (pinned when the executor is on the card), written
in place from the requests and copied into the bound input once.

Not ported (they only observe, or wait for the fleet tier): the SLO
scheduler's admission, ordering and feasibility shedding, the learned perf
model, the recovery ladder's replay, fault injection, tracing, the flight
recorder and the perf ledger.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np

from ..base import MXNetError
from ..engine import get_engine
from .errors import CircuitOpen, DeadlineExceeded, ServerClosed, \
    ServerOverloaded
from .executor_cache import built

__all__ = ["DynamicBatcher", "pow2_buckets", "bucket_for", "resolve_buckets"]


def pow2_buckets(max_batch_size):
    """Power-of-two batch-dim buckets up to ``max_batch_size`` (inclusive:
    a max that is not a power of two becomes the top bucket)."""
    if max_batch_size < 1:
        raise MXNetError(f"max_batch_size must be >= 1, got {max_batch_size}")
    buckets, b = [], 1
    while b < max_batch_size:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch_size)
    return buckets


def bucket_for(n, buckets):
    """Smallest bucket >= n (buckets sorted ascending)."""
    for b in buckets:
        if b >= n:
            return b
    raise MXNetError(f"no bucket holds {n} rows (buckets={buckets})")


def resolve_buckets(spec, max_batch_size, histogram=None, cost_model=None):
    """The bucket ladder of a spec (the ``MXNET_SERVING_BUCKETS`` grammar):

    * ``None`` / ``"pow2"``: powers of two up to ``max_batch_size``;
    * ``"auto"``: boundaries minimizing the expected padded cost over
      ``histogram`` (request rows -> weight) under ``cost_model``
      (:func:`mxnet_tpu_torch.costmodel.choose_buckets`), never worse than
      ``pow2`` there; ``pow2`` without a histogram;
    * ``"1,4,16"`` (a comma list) or a sequence of ints: explicit.
    """
    if spec is None:
        spec = "pow2"
    if isinstance(spec, str):
        s = spec.strip().lower()
        if s == "pow2":
            return pow2_buckets(max_batch_size)
        if s == "auto":
            if not histogram:
                return pow2_buckets(max_batch_size)
            from ..costmodel import choose_buckets

            return choose_buckets(histogram, max_batch_size,
                                  cost_model=cost_model)
        try:
            buckets = sorted({int(b) for b in s.split(",") if b.strip()})
        except ValueError:
            buckets = []
        if not buckets or buckets[0] < 1:
            raise MXNetError(
                f"invalid bucket spec {spec!r} (MXNET_SERVING_BUCKETS: "
                "pow2 | auto | comma list of sizes)")
        return buckets
    buckets = sorted({int(b) for b in spec})
    if not buckets or buckets[0] < 1:
        raise MXNetError(f"invalid buckets {spec!r}")
    return buckets


def _wait_device(ex):
    """Wait for the executor's queued device work (the replay), so the
    output copy after it is timed alone."""
    dev = ex._ctx.torch_device
    if dev.type == "cuda":
        import torch

        torch.cuda.current_stream(dev).synchronize()


class _Request:
    __slots__ = ("inputs", "rows", "signature", "future", "t_submit",
                 "deadline", "tenant")

    def __init__(self, inputs, rows, signature, timeout_s=None, tenant=None):
        self.inputs = inputs
        self.rows = rows
        self.signature = signature
        self.future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = (self.t_submit + timeout_s
                         if timeout_s is not None and timeout_s > 0 else None)
        self.tenant = tenant


def _resolve(fut, value=None, exc=None):
    """Set a future's outcome, tolerating a client's cancellation."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except InvalidStateError:
        pass


class DynamicBatcher:
    """Coalescing queue in front of an :class:`ExecutorCache`.

    Parameters
    ----------
    cache : ExecutorCache
        Bound-executor cache; one bind a bucket shape.
    metrics : ServingMetrics
        Counter sink.
    max_batch_size : int
        Coalescing ceiling in rows. A larger request is accepted and run
        in chunks of the top bucket.
    max_wait_ms : float
        How long the first request of a batch waits for company.
    buckets : list[int] | str, optional
        Bucket sizes or a :func:`resolve_buckets` spec.
    histogram, cost_model : optional
        The inputs of ``buckets="auto"``.
    engine : Engine, optional
        Dependency engine for dispatch (default: the process's).
    queue_cap : int
        Pending requests beyond this are refused with
        :class:`ServerOverloaded` (0: unbounded).
    deadline_s : float, optional
        Default deadline of a request; an expired request is dropped before
        staging and resolves with :class:`DeadlineExceeded`.
    breaker : CircuitBreaker, optional
        While open, submits fail fast with :class:`CircuitOpen`.
    scheduler, perf_model :
        The reference's SLO scheduler and learned perf model: not ported
        (anything but None raises). ``model_name`` (the reference's trace
        and ledger tag) is accepted and unused.
    """

    def __init__(self, cache, metrics, max_batch_size, max_wait_ms,
                 buckets=None, engine=None, queue_cap=0, deadline_s=None,
                 breaker=None, histogram=None, cost_model=None,
                 scheduler=None, model_name="default", perf_model=None):
        if scheduler is not None or perf_model is not None:
            raise MXNetError("DynamicBatcher: scheduler= and perf_model= "
                             "(the SLO scheduler, the learned perf model) "
                             "are not ported")
        buckets = resolve_buckets(buckets, max_batch_size,
                                  histogram=histogram, cost_model=cost_model)
        self._cache = cache
        self._metrics = metrics
        self._max_batch = int(max_batch_size)
        self._max_wait = float(max_wait_ms) / 1e3
        self.buckets = buckets
        # chunk ceiling: never stage more rows than the top bucket holds
        self._chunk_cap = min(self._max_batch, buckets[-1])
        self._engine = engine if engine is not None else get_engine()
        # read var: the predictor's parameters (shared by every cached
        # executor); write var: the executors and the staging buffers
        self.params_var = self._engine.new_variable("serving_params")
        self.exec_var = self._engine.new_variable("serving_exec")
        self._queue_cap = int(queue_cap or 0)
        self._deadline_s = deadline_s if deadline_s and deadline_s > 0 \
            else None
        self._breaker = breaker
        self._stage = {}  # (signature, bucket) -> {name: host tensor}
        self._cv = threading.Condition()
        self._pending: deque = deque()
        self._closed = False
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="mxtpu-serving-batcher",
                                        daemon=True)
        self._worker.start()

    # -- client -----------------------------------------------------------------
    def submit(self, inputs, timeout_s=None, tenant=None):
        """Enqueue one request (dict name -> array-like with a leading batch
        dim shared by every input); returns a Future resolving to the list
        of per-output float32 arrays sliced to this request's rows.

        ``timeout_s`` (default: the batcher's ``deadline_s``) bounds the
        wait in the queue. Refused at once: :class:`CircuitOpen` while the
        breaker is open, :class:`ServerOverloaded` when the queue holds
        ``queue_cap``, :class:`ServerClosed` after ``close()``."""
        if self._breaker is not None and not self._breaker.allow():
            self._metrics.on_shed("breaker_open", tenant)
            raise CircuitOpen(
                "serving circuit breaker is open (consecutive batch "
                "failures); failing fast instead of queueing")
        arrs, rows = {}, None
        for name, val in inputs.items():
            a = np.asarray(val, np.float32)
            if a.ndim == 0:
                raise MXNetError(
                    f"submit: input '{name}' needs a leading batch dim")
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise MXNetError(
                    f"submit: input '{name}' has {a.shape[0]} rows, other "
                    f"inputs have {rows}")
            arrs[name] = a
        if not arrs or rows == 0:
            raise MXNetError("submit: empty request")
        sig = tuple(sorted((k, v.shape[1:]) for k, v in arrs.items()))
        if timeout_s is None:
            timeout_s = self._deadline_s
        req = _Request(arrs, rows, sig, timeout_s=timeout_s, tenant=tenant)
        with self._cv:
            if self._closed:
                raise ServerClosed("submit after close()")
            if self._queue_cap and len(self._pending) >= self._queue_cap:
                self._metrics.on_shed("queue_full", tenant)
                raise ServerOverloaded(
                    f"serving queue full ({self._queue_cap} pending, "
                    "MXNET_SERVING_QUEUE_CAP); request shed")
            # counted before the worker can dispatch it
            self._metrics.on_submit(rows)
            self._pending.append(req)
            self._cv.notify_all()
        return req.future

    def close(self, drain=True):
        """Stop accepting requests. ``drain=True`` serves every queued and
        in-flight request before returning; ``drain=False`` fails the
        queued ones at once (batches in flight still complete)."""
        with self._cv:
            self._closed = True
            dropped = []
            if not drain:
                dropped = list(self._pending)
                self._pending.clear()
            self._cv.notify_all()
        for req in dropped:
            self._metrics.on_drop()
            self._metrics.on_complete(time.perf_counter() - req.t_submit,
                                      failed=True, tenant=req.tenant)
            _resolve(req.future, exc=ServerClosed("server closed"))
        self._worker.join()
        # every pushed batch has completed and resolved its futures
        self._engine.wait_for_var(self.exec_var)
        self._stage.clear()

    # -- worker -----------------------------------------------------------------
    def _take_compatible(self, sig, rows, group):
        """Move queued requests of signature ``sig`` that still fit under
        the ceiling into ``group`` (queue order kept for the rest)."""
        rest: deque = deque()
        for req in self._pending:
            if req.signature == sig and rows + req.rows <= self._max_batch:
                group.append(req)
                rows += req.rows
            else:
                rest.append(req)
        self._pending = rest
        return rows

    @staticmethod
    def _is_expired(req, now):
        return req.deadline is not None and now >= req.deadline

    def _expire(self, req, now):
        waited = now - req.t_submit
        self._metrics.on_expire(waited, tenant=req.tenant)
        _resolve(req.future, exc=DeadlineExceeded(
            f"request expired after {waited:.3f}s in the serving queue "
            f"(deadline {req.deadline - req.t_submit:.3f}s)"))

    def _gather(self):
        """Block for the next request, then coalesce compatible queued
        requests until ``max_batch_size`` rows or the ``max_wait_ms``
        deadline. Expired requests resolve with DeadlineExceeded and are
        never dispatched. None once closed and drained."""
        with self._cv:
            while True:
                while not self._pending:
                    if self._closed:
                        return None
                    self._cv.wait()
                now = time.perf_counter()
                first = self._pending.popleft()
                if self._is_expired(first, now):
                    self._expire(first, now)
                    continue
                group, rows = [first], first.rows
                deadline = first.t_submit + self._max_wait
                if first.deadline is not None:
                    deadline = min(deadline, first.deadline)
                while rows < self._max_batch:
                    rows = self._take_compatible(first.signature, rows,
                                                 group)
                    if rows >= self._max_batch or self._closed:
                        break
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                # drop members that expired while the batch formed
                now = time.perf_counter()
                live = [r for r in group if not self._is_expired(r, now)]
                if len(live) != len(group):
                    for r in group:
                        if self._is_expired(r, now):
                            self._expire(r, now)
                    if not live:
                        continue
                    group = live
                    rows = sum(r.rows for r in group)
                return group, rows

    def _chunk_plan(self, rows):
        """(row offset, real rows, bucket rows) a chunk; one chunk unless a
        request overflows the top bucket."""
        chunks, off = [], 0
        while off < rows:
            take = min(rows - off, self._chunk_cap)
            chunks.append((off, take, bucket_for(take, self.buckets)))
            off += take
        return chunks

    def _worker_loop(self):
        while True:
            gathered = self._gather()
            if gathered is None:
                return
            group, rows = gathered
            chunks = self._chunk_plan(rows)
            self._metrics.on_dispatch(len(group), rows,
                                      sum(c[2] for c in chunks))
            self._engine.push(
                lambda g=group, c=chunks: self._run_batch(g, c),
                const_vars=(self.params_var,),
                mutable_vars=(self.exec_var,),
                name="serving:batch",
                # the engine may complete the op without running it (an
                # upstream taint, a quiesce window, a refused dispatch):
                # the group's futures still resolve
                on_skipped=lambda exc, g=group: self._fail_group(g, exc))

    # -- dispatch ---------------------------------------------------------------
    def _run_batch(self, group, chunks):
        """The engine op's body: run the batch and resolve every future
        once. A failure resolves the group's futures, not the engine's
        vars: a bad batch must not taint serving for later clients."""
        try:
            self._run_chunks(group, chunks)
        except BaseException as e:
            self._fail_group(group, e)
            return
        if self._breaker is not None:
            self._breaker.record_success()

    def _fail_group(self, group, exc):
        """Resolve every unresolved future of ``group`` with ``exc``."""
        if self._breaker is not None:
            self._breaker.record_failure()
        now = time.perf_counter()
        for req in group:
            if not req.future.done():
                _resolve(req.future, exc=exc)
                self._metrics.on_complete(now - req.t_submit, failed=True,
                                          tenant=req.tenant)

    def _staging(self, sig, bucket, ex):
        """The host buffers of bucket ``bucket`` (one an input: pinned when
        the executor is on the card), made on first use."""
        import torch

        key = (sig, bucket)
        bufs = self._stage.get(key)
        if bufs is None:
            pin = ex._ctx.torch_device.type == "cuda"
            bufs = {name: torch.empty((bucket,) + tuple(feat),
                                      dtype=torch.float32, pin_memory=pin)
                    for name, feat in sig}
            self._stage[key] = bufs
        return bufs

    def _stage_chunk(self, group, off, take, bucket, ex):
        """Write rows ``off:off + take`` of the group's concatenated
        requests into the bucket's host buffers, zero the padding rows, and
        copy each buffer into the executor's bound input (asynchronously
        from pinned memory)."""
        bufs = self._staging(group[0].signature, bucket, ex)
        for name, buf in bufs.items():
            host = buf.numpy()
            pos = row = 0
            for req in group:
                lo, hi = max(off, row), min(off + take, row + req.rows)
                if lo < hi:
                    host[pos:pos + hi - lo] = req.inputs[name][lo - row:
                                                               hi - row]
                    pos += hi - lo
                row += req.rows
            host[take:] = 0.0
            holder = ex.arg_dict.get(name)
            if holder is None:
                raise MXNetError(f"serving: unknown input {name}")
            if tuple(holder.shape) != tuple(buf.shape):
                raise MXNetError(
                    f"serving: input {name} of shape {tuple(buf.shape)} "
                    f"does not fit the bound {tuple(holder.shape)}")
            holder.data.copy_(buf, non_blocking=True)

    def _run_chunks(self, group, chunks):
        """Stage, forward and split each chunk; raises on failure (no
        future resolved), resolves every future on success."""
        out_parts = None
        shapes_of = {name: feat for name, feat in group[0].signature}
        for off, take, bucket in chunks:
            ex, _ = self._cache.get(
                {n: (bucket,) + tuple(f) for n, f in shapes_of.items()})
            if not built(ex):
                # a bucket's first batch builds its program (warm-up and
                # capture on this thread) and then replays it
                ex.warmup()
            with self._metrics.span("serving:stage"):
                self._stage_chunk(group, off, take, bucket, ex)
            with self._metrics.span("serving:batch:forward", symbolic=True):
                ex.forward(is_train=False)
                with self._metrics.span("serving:device_wait"):
                    _wait_device(ex)
                with self._metrics.span("serving:output_copy"):
                    outs = [o.asnumpy() for o in ex.outputs]
            for i, o in enumerate(outs):
                if o.ndim == 0 or o.shape[0] != bucket:
                    raise MXNetError(
                        f"serving: output {i} shape {o.shape} is not "
                        f"batch-major over {bucket} rows; this graph "
                        "cannot be row-split for dynamic batching")
            if out_parts is None:
                out_parts = [[] for _ in outs]
            for parts, o in zip(out_parts, outs):
                parts.append(o[:take])
        with self._metrics.span("serving:split"):
            full_outs = [p[0] if len(p) == 1 else np.concatenate(p)
                         for p in out_parts]
            off = 0
            now = time.perf_counter()
            for req in group:
                res = [o[off:off + req.rows] for o in full_outs]
                off += req.rows
                _resolve(req.future, value=res)
                self._metrics.on_complete(now - req.t_submit,
                                          tenant=req.tenant)

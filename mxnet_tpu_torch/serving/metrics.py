"""Serving metrics: QPS, queue depth, batch occupancy, latency percentiles,
time to first token, decode step times (reference:
mxnet_tpu/serving/metrics.py).

Counters are thread-safe increments; latencies go into bounded reservoirs,
so p50/p99 stay O(1) memory under sustained load. :meth:`ServingMetrics.
span` times a serving stage (staging, the forward, the split) and keeps a
count and total a stage name. The reference also mirrors every event onto
its telemetry registry, stamps spans into the profiler's host-op trace and
counts per tenant; those wait for the port's telemetry and scheduler. The
event signatures are the reference's.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager

__all__ = ["ServingMetrics", "percentile"]


def percentile(sorted_vals, p):
    """Interpolated nearest-rank percentile of an already-sorted list."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    rank = (p / 100.0) * (len(sorted_vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = rank - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class ServingMetrics:
    """Thread-safe serving counters and latency reservoirs.

    * ``qps``: completed requests a wall second since construction (or the
      last :meth:`reset`);
    * ``queue_depth``: requests submitted and not yet dispatched;
    * ``batch_occupancy``: real rows / dispatched rows (1.0: no padding);
    * ``p50_ms``/``p99_ms``: request latency, submit to result;
    * ``ttft_p50_ms``/``ttft_p99_ms``: submit to the first sampled token;
    * ``step_p50_ms`` etc.: host time of a decode step, apart for steps
      that sampled (``sampled``) and steps that only prefilled;
    * ``spans``: count, total and mean ms of each timed serving stage.
    """

    def __init__(self, reservoir=8192):
        self._lock = threading.Lock()
        self._n = reservoir
        self.reset()

    def reset(self):
        with self._lock:
            self._t0 = time.perf_counter()
            self._lat = deque(maxlen=self._n)
            self._ttft = deque(maxlen=self._n)
            self._steps = {True: deque(maxlen=self._n),
                           False: deque(maxlen=self._n)}
            self.submitted = 0
            self.completed = 0
            self.failed = 0
            self.batches = 0
            self.rows = 0          # real request rows dispatched
            self.padded_rows = 0   # padding rows dispatched beside them
            self.queue_depth = 0
            self.expired = 0       # dropped at their deadline while queued
            self.shed = 0          # rejected at admission
            self.rows_hist = {}    # request rows -> count (auto bucketing)
            self._spans = {}       # stage name -> [count, total seconds]
            self.prewarm_seconds = None
            self.first_request_compiles = None
            self.expected_padded_waste_ratio = None
            self.prefix_hits = 0
            self.prefix_misses = 0
            self.prefix_tokens_reused = 0
            self.spec_proposed = 0
            self.spec_accepted = 0

    # -- events ---------------------------------------------------------------
    def on_submit(self, rows=1):
        with self._lock:
            self.submitted += 1
            self.queue_depth += 1
            # bounded in practice; the cap keeps a hostile client from
            # growing it forever
            if rows in self.rows_hist or len(self.rows_hist) < 1024:
                self.rows_hist[rows] = self.rows_hist.get(rows, 0) + 1

    def on_dispatch(self, n_requests, real_rows, bucket_rows):
        """``n_requests`` queued requests of ``real_rows`` rows left the
        queue in chunks of ``bucket_rows`` rows in all."""
        with self._lock:
            self.queue_depth -= n_requests
            self.batches += 1
            self.rows += real_rows
            self.padded_rows += bucket_rows - real_rows

    def on_drop(self):
        """A queued request left unserved (``close(drain=False)``)."""
        with self._lock:
            self.queue_depth -= 1

    def on_expire(self, waited_s, tenant=None, reason="deadline"):
        """A queued request was shed at (or, ``reason="infeasible"``, ahead
        of) its deadline after ``waited_s``. ``tenant`` (the reference's
        per-tenant attribution) waits for the port's scheduler."""
        with self._lock:
            self.queue_depth -= 1
            self.expired += 1

    def on_shed(self, reason, tenant=None):
        """Admission refused a request (``queue_full``, ``breaker_open``,
        ``quota``) or a seated one was shed (``kv_pool``); the queue depth
        did not move."""
        with self._lock:
            self.shed += 1

    def on_complete(self, latency_s, failed=False, tenant=None,
                    trace_id=None):
        with self._lock:
            if failed:
                self.failed += 1
            else:
                self.completed += 1
            self._lat.append(latency_s)

    def on_ttft(self, seconds, tenant=None, trace_id=None):
        with self._lock:
            self._ttft.append(seconds)

    def on_step(self, seconds, sampled):
        """One decode step took ``seconds`` of host time; ``sampled``: it
        copied probabilities to the host."""
        with self._lock:
            self._steps[bool(sampled)].append(seconds)

    def on_prefix_hit(self, tokens):
        with self._lock:
            self.prefix_hits += 1
            self.prefix_tokens_reused += tokens

    def on_prefix_miss(self):
        with self._lock:
            self.prefix_misses += 1

    def on_spec(self, proposed, accepted):
        with self._lock:
            self.spec_proposed += proposed
            self.spec_accepted += accepted

    # -- cold start -------------------------------------------------------------
    def on_prewarm(self, seconds):
        """A prewarm pass finished after ``seconds`` of wall time."""
        with self._lock:
            self.prewarm_seconds = seconds

    def on_first_request(self, compiles):
        """Programs built (warm-ups and captures in the port) between the
        first request's submit and its completion."""
        with self._lock:
            self.first_request_compiles = compiles

    def on_expected_waste(self, ratio):
        """The expected padded-waste ratio of the resolved bucket set."""
        with self._lock:
            self.expected_padded_waste_ratio = ratio

    def rows_histogram(self):
        """Observed request-rows histogram (the shape manifest keeps it at
        server close for ``auto`` bucketing)."""
        with self._lock:
            return dict(self.rows_hist)

    @contextmanager
    def span(self, name, symbolic=False):
        """Time a serving stage into :attr:`spans`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                acc = self._spans.setdefault(name, [0, 0.0])
                acc[0] += 1
                acc[1] += dt

    # -- snapshot ---------------------------------------------------------------
    def snapshot(self):
        with self._lock:
            elapsed = max(time.perf_counter() - self._t0, 1e-9)
            dispatched = self.rows + self.padded_rows
            lat = sorted(self._lat)
            ttft = sorted(self._ttft)
            steps = {k: sorted(v) for k, v in self._steps.items()}
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "batches": self.batches,
                "rows": self.rows,
                "padded_rows": self.padded_rows,
                "queue_depth": self.queue_depth,
                "expired": self.expired,
                "shed": self.shed,
                "qps": self.completed / elapsed,
                "batch_occupancy": (self.rows / dispatched) if dispatched
                else 0.0,
                "avg_batch_rows": (self.rows / self.batches) if self.batches
                else 0.0,
                "p50_ms": percentile(lat, 50) * 1e3,
                "p99_ms": percentile(lat, 99) * 1e3,
                "rows_hist": dict(self.rows_hist),
                "spans": {n: {"count": c, "total_ms": s * 1e3,
                              "mean_ms": s * 1e3 / c}
                          for n, (c, s) in self._spans.items()},
                "prewarm_seconds": self.prewarm_seconds,
                "first_request_compiles": self.first_request_compiles,
                "expected_padded_waste_ratio":
                    self.expected_padded_waste_ratio,
                "ttft_p50_ms": percentile(ttft, 50) * 1e3,
                "ttft_p99_ms": percentile(ttft, 99) * 1e3,
                "step_p50_ms": percentile(
                    sorted(steps[False] + steps[True]), 50) * 1e3,
                "sampled_step_p50_ms": percentile(steps[True], 50) * 1e3,
                "sampled_step_p99_ms": percentile(steps[True], 99) * 1e3,
                "prefill_step_p50_ms": percentile(steps[False], 50) * 1e3,
                "prefix": {"hits": self.prefix_hits,
                           "misses": self.prefix_misses,
                           "tokens_reused": self.prefix_tokens_reused},
                "spec": {"proposed": self.spec_proposed,
                         "accepted": self.spec_accepted},
            }

    def format_snapshot(self):
        s = self.snapshot()
        return ("serving: {qps:.1f} req/s | {completed} ok / {failed} failed "
                "/ {queue_depth} queued | {batches} batches "
                "(occupancy {batch_occupancy:.2f}, avg {avg_batch_rows:.1f} "
                "rows) | p50 {p50_ms:.2f} ms p99 {p99_ms:.2f} ms"
                .format(**s))

"""Serving metrics: counters, time to first token, request and step
latencies, percentiles (reference: mxnet_tpu/serving/metrics.py).

Counters are thread-safe increments; latencies go into bounded reservoirs,
so p50/p99 stay O(1) memory under sustained load. The reference also
mirrors every event onto its telemetry registry and the profiler's host-op
trace, and keeps per-tenant counts for its SLO scheduler; those wait for
the port's telemetry and scheduler.
"""
from __future__ import annotations

import threading
import time
from collections import deque

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
    * ``p50_ms``/``p99_ms``: request latency, submit to result;
    * ``ttft_p50_ms``/``ttft_p99_ms``: submit to the first sampled token;
    * ``step_p50_ms``/``step_p99_ms``: host time of a decode step, apart
      for steps that sampled (``sampled``) and steps that only prefilled.
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
            self.rows = 0
            self.queue_depth = 0
            self.expired = 0
            self.shed = 0
            self.prefix_hits = 0
            self.prefix_misses = 0
            self.prefix_tokens_reused = 0
            self.spec_proposed = 0
            self.spec_accepted = 0

    # -- events ---------------------------------------------------------------
    def on_submit(self):
        with self._lock:
            self.submitted += 1
            self.queue_depth += 1

    def on_dispatch(self, n_requests):
        """``n_requests`` queued requests took slots."""
        with self._lock:
            self.queue_depth -= n_requests
            self.batches += 1
            self.rows += n_requests

    def on_drop(self):
        """A queued request left unserved (``close(drain=False)``)."""
        with self._lock:
            self.queue_depth -= 1

    def on_expire(self):
        """A queued request was shed at its deadline."""
        with self._lock:
            self.queue_depth -= 1
            self.expired += 1

    def on_shed(self):
        """A seated request was shed (the KV pool ran out)."""
        with self._lock:
            self.shed += 1

    def on_complete(self, latency_s, failed=False):
        with self._lock:
            if failed:
                self.failed += 1
            else:
                self.completed += 1
            self._lat.append(latency_s)

    def on_ttft(self, seconds):
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

    # -- snapshot ---------------------------------------------------------------
    def snapshot(self):
        with self._lock:
            elapsed = max(time.perf_counter() - self._t0, 1e-9)
            lat = sorted(self._lat)
            ttft = sorted(self._ttft)
            steps = {k: sorted(v) for k, v in self._steps.items()}
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "batches": self.batches,
                "rows": self.rows,
                "queue_depth": self.queue_depth,
                "expired": self.expired,
                "shed": self.shed,
                "qps": self.completed / elapsed,
                "p50_ms": percentile(lat, 50) * 1e3,
                "p99_ms": percentile(lat, 99) * 1e3,
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

"""The serving circuit breaker (reference: mxnet_tpu/resilience/policy.py
``CircuitBreaker``). The reference's telemetry gauge, flight-recorder
events and ``/healthz`` registration only observe; they are not ported."""
from __future__ import annotations

import threading
import time

from .. import env

__all__ = ["CircuitBreaker"]


class CircuitBreaker:
    """Consecutive-failure circuit breaker (closed -> open -> half-open).

    ``threshold`` consecutive :meth:`record_failure` calls open the breaker
    (``MXNET_BREAKER_THRESHOLD``, default 5; 0 disables). While open,
    :meth:`allow` returns False until ``reset_s`` (``MXNET_BREAKER_RESET_S``,
    default 30) elapses; then it half-opens and lets probe traffic through:
    the next success closes it, the next failure opens it again and re-arms
    the timer. Driven by timestamps; no timer thread exists.
    """

    def __init__(self, threshold=None, reset_s=None, name="serving"):
        self.threshold = int(env.get_int("MXNET_BREAKER_THRESHOLD", 5,
                                         strict=True)
                             if threshold is None else threshold)
        self.reset_s = float(env.get_float("MXNET_BREAKER_RESET_S", 30.0,
                                           strict=True)
                             if reset_s is None else reset_s)
        self.name = name
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = None

    def allow(self) -> bool:
        """May a new request enter? Flips open to half-open once the reset
        timer has run out."""
        if self.threshold <= 0:
            return True
        with self._lock:
            if self._state == "open":
                if time.perf_counter() - self._opened_at >= self.reset_s:
                    self._state = "half_open"
                    return True
                return False
            return True

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._state = "closed"

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if self._state == "half_open" or (
                    self._state == "closed" and self.threshold > 0
                    and self._failures >= self.threshold):
                self._opened_at = time.perf_counter()
                self._state = "open"

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def health_reason(self):
        """Why serving is degraded, or None while closed."""
        with self._lock:
            if self._state == "closed":
                return None
            return (f"circuit breaker '{self.name}' {self._state} "
                    f"({self._failures} consecutive batch failures, "
                    f"reset {self.reset_s}s)")

    def snapshot(self):
        with self._lock:
            return {"name": self.name, "state": self._state,
                    "consecutive_failures": self._failures,
                    "threshold": self.threshold, "reset_s": self.reset_s}

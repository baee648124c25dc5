"""The typed serving errors (reference: mxnet_tpu/resilience/errors.py). Each subclasses
:class:`~mxnet_tpu_torch.base.MXNetError`, so ``except MXNetError`` still
catches them; the names are the reference's."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["DeadlineExceeded", "ServerOverloaded", "ServerClosed",
           "KVPoolExhausted", "QuotaExceeded", "CircuitOpen",
           "LifecycleError"]


class DeadlineExceeded(MXNetError):
    """A request outlived its deadline (``timeout_s``) while queued."""


class ServerOverloaded(MXNetError):
    """Admission control shed the request: back off and retry."""


class ServerClosed(MXNetError):
    """A request after ``close()``: the server is gone, not busy."""


class KVPoolExhausted(ServerOverloaded):
    """The paged KV block pool has no free block for a sequence's next
    tokens and demoting cold prefix blocks to the host tier freed none: the
    request is shed typed. ``needed``/``free`` carry the block counts."""

    def __init__(self, msg, needed=None, free=None):
        super().__init__(msg)
        self.needed = needed
        self.free = free


class QuotaExceeded(ServerOverloaded):
    """A tenant's admission quota is exhausted; ``tenant`` names it. The
    port has no tenant scheduler yet, so nothing raises it here."""

    def __init__(self, msg, tenant=None):
        super().__init__(msg)
        self.tenant = tenant


class CircuitOpen(ServerOverloaded):
    """The serving circuit breaker is open after consecutive batch
    failures: requests fail fast instead of feeding a broken executor.
    A :class:`ServerOverloaded`, so clients treat both as "back off"."""


class LifecycleError(MXNetError):
    """An invalid weight operation: a parameter set that does not match
    the served model (missing, extra or mis-shaped parameters) or a swap
    while the weights are paged out. Raised before any served parameter
    is touched: the live version keeps serving."""

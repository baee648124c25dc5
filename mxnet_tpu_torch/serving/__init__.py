"""mxnet_tpu_torch.serving: autoregressive decode serving (reference:
mxnet_tpu/serving).

:class:`GenerationSession` serves the transformer LM's decode with
continuous batching over fixed KV-cache slots, chunked prefill, prefix KV
reuse (:class:`PrefixKVCache`), paged KV (:class:`KVBlockPool`) and
speculative decoding. The request-batching server over ``Predictor``
(``ModelServer``, ``DynamicBatcher``, ``ExecutorCache``,
``ShapeManifest``), the SLO scheduler, the fleet, the lifecycle and
cluster tiers wait for later work.
"""
from .errors import (DeadlineExceeded, KVPoolExhausted, QuotaExceeded,
                     ServerClosed, ServerOverloaded)
from .generation import GenerationSession
from .kvpool import KVBlockPool
from .metrics import ServingMetrics
from .prefix_cache import PrefixKVCache

__all__ = ["GenerationSession", "PrefixKVCache", "KVBlockPool",
           "ServingMetrics", "DeadlineExceeded", "KVPoolExhausted",
           "QuotaExceeded", "ServerClosed", "ServerOverloaded"]

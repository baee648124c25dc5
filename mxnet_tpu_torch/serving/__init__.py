"""mxnet_tpu_torch.serving: inference serving (reference:
mxnet_tpu/serving).

:class:`ModelServer` is the request-batching server over ``Predictor``:
concurrent ``submit()`` from many client threads, coalesced into a bounded
set of padded shape buckets (:class:`DynamicBatcher`), one bound executor a
bucket (:class:`ExecutorCache`; on the card one captured CUDA graph a
bucket), each batch pushed through the dependency engine, a shape manifest
for restart prewarming (:class:`ShapeManifest`) and operational metrics.
:class:`GenerationSession` serves the transformer LM's decode with
continuous batching over fixed KV-cache slots, chunked prefill, prefix KV
reuse (:class:`PrefixKVCache`), paged KV (:class:`KVBlockPool`) and
speculative decoding. The SLO scheduler, the fleet, the lifecycle and
cluster tiers wait for later work.
"""
from .batcher import DynamicBatcher, bucket_for, pow2_buckets, resolve_buckets
from .errors import (CircuitOpen, DeadlineExceeded, KVPoolExhausted,
                     LifecycleError, QuotaExceeded, ServerClosed,
                     ServerOverloaded)
from .executor_cache import ExecutorCache
from .generation import GenerationSession
from .kvpool import KVBlockPool
from .manifest import ShapeManifest, default_manifest_path
from .metrics import ServingMetrics
from .policy import CircuitBreaker
from .prefix_cache import PrefixKVCache
from .server import ModelServer

__all__ = ["ModelServer", "GenerationSession", "PrefixKVCache",
           "KVBlockPool", "DynamicBatcher", "ExecutorCache",
           "ServingMetrics", "ShapeManifest", "CircuitBreaker",
           "pow2_buckets", "bucket_for", "resolve_buckets",
           "default_manifest_path", "DeadlineExceeded", "KVPoolExhausted",
           "QuotaExceeded", "ServerClosed", "ServerOverloaded",
           "CircuitOpen", "LifecycleError"]

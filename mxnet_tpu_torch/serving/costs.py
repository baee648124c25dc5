"""The decode session's cost arithmetic (reference: the prefill-chunk cap of
mxnet_tpu/costmodel.py ``prefill_chunk_cap`` and
mxnet_tpu/perfmodel/__init__.py ``prefill_chunk_cap``/``eviction_score``,
without a learned artifact).

The chunk cap and the operation counts it reads (:func:`forward_flops` of
the bound one-token and chunked executors) live in
:mod:`mxnet_tpu_torch.costmodel` beside the serving bucket chooser; this
module adds the prefix cache's victim score.
"""
from __future__ import annotations

from ..costmodel import forward_flops, prefill_chunk_cap

__all__ = ["prefill_chunk_cap", "eviction_score", "forward_flops"]


def eviction_score(nbytes, idle_s, half_life_s=30.0):
    """Victim score of a cached entry: its bytes times the chance it is
    asked for again (halving every ``half_life_s`` idle seconds). The
    least score goes first."""
    if half_life_s <= 0:
        return float(nbytes)
    return float(nbytes) * 2.0 ** (-float(idle_s) / float(half_life_s))

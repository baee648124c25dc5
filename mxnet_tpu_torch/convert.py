"""Weights across from the JAX package.

Parameter names and layouts are identical in both packages (a FullyConnected
weight is (out, in), an Embedding weight (vocab, hidden)), so conversion is
placement: numpy arrays, as ``Module.get_params()`` / ``NDArray.asnumpy()``
give them, become NDArrays on a context, and a ``.params`` blob written by
``mxnet_tpu.nd.save`` is read by this package's own ``nd.load_frombuffer``.
"""
from __future__ import annotations

import numpy as np

from . import ndarray as nd
from .context import Context

__all__ = ["params_from_numpy", "params_from_bytes", "split_params"]


def params_from_numpy(arg_params, aux_params=None, ctx: Context | None = None):
    """``(arg, aux)`` dicts of name -> numpy array to dicts of name ->
    NDArray on ``ctx`` (default: the current context), keeping each
    array's dtype."""
    def place(d):
        out = {}
        for k, v in (d or {}).items():
            a = np.asarray(v)
            out[k] = nd.array(a, ctx, dtype=a.dtype)
        return out

    return place(arg_params), place(aux_params)


def split_params(saved):
    """Split a loaded ``{"arg:name": ..., "aux:name": ...}`` dict into
    ``(arg, aux)``; unprefixed names count as arguments."""
    arg_params, aux_params = {}, {}
    for k, v in saved.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def params_from_bytes(blob, ctx: Context | None = None):
    """``(arg, aux)`` NDArray dicts on ``ctx`` (default: the current
    context) from a ``.params`` blob written by either package."""
    return split_params(nd.load_frombuffer(blob, ctx))

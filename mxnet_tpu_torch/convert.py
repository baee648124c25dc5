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

__all__ = ["params_from_numpy", "params_from_bytes", "split_params",
           "stack_lm_params", "LM_ROLE_NAMES"]

# GenerateScan's stacked role -> the per-layer name in ``get_symbol``'s
# checkpoint (``layer{i}_<name>``); the reference example's map
# (example/transformer-lm/generate.py ``generate_scan``)
LM_ROLE_NAMES = {"ln1_gamma": "ln1_gamma", "ln1_beta": "ln1_beta",
                 "ln2_gamma": "ln2_gamma", "ln2_beta": "ln2_beta",
                 "q_weight": "att_q_weight", "k_weight": "att_k_weight",
                 "v_weight": "att_v_weight", "out_weight": "att_out_weight",
                 "ff1_weight": "ff1_weight", "ff1_bias": "ff1_bias",
                 "ff2_weight": "ff2_weight", "ff2_bias": "ff2_bias"}


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


def stack_lm_params(arg_params, num_layers):
    """A ``models.transformer_lm.get_symbol`` checkpoint (name -> numpy
    array or NDArray) as GenerateScan's inputs, numpy arrays by input name:
    ``embed_weight``, ``pos_weight``, each role of
    ``ops.transformer_stack._ROLES`` stacked over the layers on a leading
    axis, ``final_gamma``, ``final_beta``, ``head_weight``,
    ``head_bias``."""
    from .ops.transformer_stack import _ROLES

    def get(name):
        v = arg_params[name]
        return np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)

    out = {"embed_weight": get("tok_embed_weight"),
           "pos_weight": get("transformer_pos_weight")}
    for role, _shape in _ROLES:
        out[role] = np.stack([get(f"layer{i}_{LM_ROLE_NAMES[role]}")
                              for i in range(num_layers)])
    out.update(final_gamma=get("final_ln_gamma"),
               final_beta=get("final_ln_beta"),
               head_weight=get("head_weight"), head_bias=get("head_bias"))
    return out

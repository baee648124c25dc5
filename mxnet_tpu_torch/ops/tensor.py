"""Tensor operators (reference: mxnet_tpu/ops/tensor.py), the subset that the
transformer LM's graph reaches. Bodies are plain torch ops; PyTorch runs them
eagerly, one launch each.
"""
from __future__ import annotations

from .registry import register_op


@register_op("elemwise_add", inputs=("lhs", "rhs"),
             alias=("_Plus", "_plus", "_add"))
def _elemwise_add(ctx, attrs, lhs, rhs):
    return lhs + rhs


@register_op("broadcast_add", inputs=("lhs", "rhs"))
def _broadcast_add(ctx, attrs, lhs, rhs):
    return lhs + rhs


@register_op("expand_dims")
def _expand_dims(ctx, attrs, data):
    return data.unsqueeze(int(attrs["axis"]))


@register_op("Reshape", alias=("reshape",))
def _reshape(ctx, attrs, data):
    """MXNet reshape with the special codes 0/-1/-2/-3/-4
    (:func:`mxnet_tpu_torch.ndarray.infer_reshape`)."""
    from ..ndarray import infer_reshape

    shape = tuple(attrs.get("shape", attrs.get("target_shape", ())))
    if bool(attrs.get("reverse", False)):
        shape = infer_reshape(tuple(data.shape)[::-1], shape[::-1])[::-1]
    else:
        shape = infer_reshape(tuple(data.shape), shape)
    return data.reshape(shape)

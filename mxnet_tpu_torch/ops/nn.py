"""Neural-network layer operators (reference: mxnet_tpu/ops/nn.py), the subset
that the transformer LM's graph reaches. Matrix products go to
``torch.nn.functional.linear`` (cuBLAS on the card), as the reference leaves
them to XLA. Every body is differentiable by autograd as the reference's is
by ``jax.vjp``; ``SoftmaxOutput`` keeps the reference's loss-op protocol (its
backward ignores the head gradient) as a ``torch.autograd.Function``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register_op
from .tensor import as_int32, take_fill


# ---------------------------------------------------------------------------
# FullyConnected (reference: src/operator/fully_connected-inl.h:46-134)


def _fc_infer(attrs, shapes):
    data = shapes.get("data")
    if data is not None:
        in_dim = int(np.prod(data[1:]))
        nh = int(attrs["num_hidden"])
        shapes.setdefault("weight", (nh, in_dim))
        if not attrs.get("no_bias", False):
            shapes.setdefault("bias", (nh,))
    return shapes


@register_op(
    "FullyConnected",
    inputs=lambda attrs: ["data", "weight"] if attrs.get("no_bias", False) else ["data", "weight", "bias"],
    infer_param_shapes=_fc_infer,
)
def _fully_connected(ctx, attrs, data, weight, bias=None):
    x = data.reshape(data.shape[0], -1) if data.dim() > 2 else data
    return F.linear(x, weight, bias)


# ---------------------------------------------------------------------------
# Activations


@register_op("Activation")
def _activation(ctx, attrs, data):
    act = attrs.get("act_type", "relu")
    if act == "relu":
        return torch.relu(data)
    if act == "sigmoid":
        return torch.sigmoid(data)
    if act == "tanh":
        return torch.tanh(data)
    if act == "softrelu":
        return F.softplus(data)
    raise ValueError(f"unknown act_type {act}")


# ---------------------------------------------------------------------------
# LayerNorm


def _ln_infer(attrs, shapes):
    d = shapes.get("data")
    if d is not None:
        c = d[int(attrs.get("axis", -1))]
        shapes.setdefault("gamma", (c,))
        shapes.setdefault("beta", (c,))
    return shapes


@register_op("LayerNorm", inputs=("data", "gamma", "beta"),
             infer_param_shapes=_ln_infer)
def _layer_norm(ctx, attrs, data, gamma, beta):
    """Normalize over the last (or given) axis; stats in fp32."""
    eps = float(attrs.get("eps", 1e-5))
    axis = int(attrs.get("axis", -1))
    x32 = data.float()
    mean = x32.mean(dim=axis, keepdim=True)
    var = x32.var(dim=axis, unbiased=False, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = out * gamma.float().reshape(shape) + beta.float().reshape(shape)
    return out.to(data.dtype)


# ---------------------------------------------------------------------------
# Embedding (reference: src/operator/tensor/indexing_op.cc Embedding)


def _embed_infer(attrs, shapes):
    shapes.setdefault("weight", (int(attrs["input_dim"]), int(attrs["output_dim"])))
    return shapes


@register_op("Embedding", inputs=("data", "weight"), infer_param_shapes=_embed_infer)
def _embedding(ctx, attrs, data, weight):
    """``jnp.take(weight, data.astype(int32), axis=0)``, as the reference:
    ids may arrive as floats (Predictor inputs are float32); a NaN id is 0,
    a negative id in [-n, 0) wraps, and an id outside [-n, n) gives a NaN
    row (:func:`~.tensor.take_fill`)."""
    return take_fill(weight, data, 0)


# ---------------------------------------------------------------------------
# SoftmaxOutput (reference: src/operator/softmax_output-inl.h)


def _softmax_label_infer(attrs, shapes):
    d = shapes.get("data")
    if d is not None:
        multi = bool(attrs.get("multi_output", False)) or len(d) > 2
        shapes.setdefault("label", (d[0],) + (tuple(d[2:]) if multi else ()))
    return shapes


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; backward ``(p - onehot(label)) * scale``, with the
    incoming head gradient ignored (the reference's ``custom_vjp``,
    mxnet_tpu/ops/nn.py ``_softmax_output``). ``axis`` is -1 (class axis
    last, label of the data's shape minus it) or 1 (the channel axis)."""

    @staticmethod
    def forward(ctx, data, label, axis, use_ignore, ignore_label, grad_scale,
                norm):
        p = torch.softmax(data, dim=axis)
        ctx.save_for_backward(p, label)
        ctx.attrs = (axis, use_ignore, ignore_label, grad_scale, norm)
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        axis, use_ignore, ignore_label, grad_scale, norm = ctx.attrs
        li = as_int32(label)
        classes = torch.arange(p.shape[axis], device=p.device)
        # one_hot of an id outside [0, C) is a zero row, as jax.nn.one_hot
        oh = (li[..., None] == classes).to(p.dtype)
        if axis != -1:
            oh = torch.movedim(oh, -1, 1)
        grad = p - oh
        valid = torch.ones(li.shape, dtype=p.dtype, device=p.device)
        if use_ignore:
            valid = (li != ignore_label).to(p.dtype)
            grad = grad * valid.unsqueeze(axis)
        scale = grad_scale
        if norm == "batch":
            scale = scale / p.shape[0]
        elif norm == "valid":
            scale = scale / torch.clamp(valid.sum(), min=1.0)
        return grad * scale, None, None, None, None, None, None


@register_op("SoftmaxOutput", inputs=("data", "label"), alias=("Softmax",),
             infer_param_shapes=_softmax_label_infer)
def _softmax_output(ctx, attrs, data, label):
    """Softmax in fp32 over the class axis; backward (p - onehot(label)) *
    grad_scale, normalised by ``normalization`` (null, batch or valid) and
    masked at ``ignore_label`` under ``use_ignore``, whatever the head
    gradient (reference: src/operator/softmax_output-inl.h:104-160). Under
    mixed precision the input is cast to fp32 first, so the gradient
    reaches the 16-bit logits through that cast."""
    multi = bool(attrs.get("multi_output", False))
    axis = 1 if (multi or data.dim() > 2) else -1
    return _SoftmaxOutput.apply(
        data.float(), label, axis, bool(attrs.get("use_ignore", False)),
        int(attrs.get("ignore_label", -1)),
        float(attrs.get("grad_scale", 1.0)),
        attrs.get("normalization", "null"))

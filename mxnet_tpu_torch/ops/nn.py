"""Neural-network layer operators (reference: mxnet_tpu/ops/nn.py), the subset
that the transformer LM and ResNet graphs reach. Matrix products go to
``torch.nn.functional.linear`` (cuBLAS on the card) and convolutions to
``torch.nn.functional.conv2d`` (cuDNN), as the reference leaves both to XLA;
pooling and batch normalisation are torch reductions and elementwise ops, as
the reference's are ``lax.reduce_window`` and ``jnp``. Every body is
differentiable by autograd as the reference's is by ``jax.vjp``;
``SoftmaxOutput`` keeps the reference's loss-op protocol (its backward
ignores the head gradient) and ``BatchNorm``'s training forward its
memory-light backward, each as a ``torch.autograd.Function``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register_op
from .tensor import as_int32, op_rng, take_fill


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


def _at_least_fp32(t):
    """``t`` in fp32, or as it is when it is float64 (whose statistics
    would lose digits in fp32)."""
    return t if t.dtype == torch.float64 else t.float()


def _pair(v):
    if v is None:
        return (1, 1)
    if isinstance(v, int):
        return (v, v)
    t = tuple(int(x) for x in v)
    return t if len(t) > 1 else (t[0], t[0])


# ---------------------------------------------------------------------------
# Convolution (reference: src/operator/convolution-inl.h)


def _conv_infer(attrs, shapes):
    data = shapes.get("data")
    if data is not None:
        kh, kw = _pair(attrs["kernel"])
        nf = int(attrs["num_filter"])
        ng = int(attrs.get("num_group", 1))
        if attrs.get("layout", "NCHW") == "NHWC":
            shapes.setdefault("weight", (nf, kh, kw, data[3] // ng))
        else:
            shapes.setdefault("weight", (nf, data[1] // ng, kh, kw))
        if not attrs.get("no_bias", False):
            shapes.setdefault("bias", (nf,))
    return shapes


@register_op(
    "Convolution",
    inputs=lambda attrs: ["data", "weight"] if attrs.get("no_bias", False) else ["data", "weight", "bias"],
    infer_param_shapes=_conv_infer,
)
def _convolution(ctx, attrs, data, weight, bias=None):
    """2-D convolution, NCHW data with OIHW weights or (``layout="NHWC"``)
    NHWC data with OHWI weights; ``stride``, ``pad``, ``dilate``,
    ``num_group``, ``no_bias``; ``workspace`` is accepted and ignored. The
    output keeps the data's dtype (bf16 in, bf16 out, as the reference has
    no ``preferred_element_type``). NHWC runs as NCHW views of the same
    memory (channels-last strides), so no copy is made around the call."""
    nhwc = attrs.get("layout", "NCHW") == "NHWC"
    if nhwc:
        data = data.permute(0, 3, 1, 2)
        weight = weight.permute(0, 3, 1, 2)
    conf = (_pair(attrs.get("stride")), _pair(attrs.get("pad", (0, 0))),
            _pair(attrs.get("dilate")), int(attrs.get("num_group", 1)))
    if weight.is_cuda and weight.dtype == torch.float32 \
            and weight.requires_grad and torch.is_grad_enabled() \
            and not torch.backends.cudnn.allow_tf32:
        out = _ConvIeeeWeightGrad.apply(data, weight, bias, conf)
    else:
        out = F.conv2d(data, weight, bias, *conf)
    return out.permute(0, 2, 3, 1) if nhwc else out


class _ConvIeeeWeightGrad(torch.autograd.Function):
    """An fp32 convolution on the card, with TF32 off, whose weight
    gradient runs PyTorch's native CUDA convolution (im2col and a cuBLAS
    GEMM) in place of cuDNN. The forward and the input gradient stay on
    cuDNN. The algorithm cuDNN picks for some weight gradients is not
    fp32-accurate even with TF32 off: LeNet's first convolution at batch 8
    lands 1.1e-3 of max-abs from float64, not bit-equal to the TF32
    result, where the native path lands near 1e-7 (``chip_smoke.py``
    phase 1 reads both). With TF32 on, the caller has chosen speed over
    fp32 accuracy and cuDNN keeps the whole convolution."""

    @staticmethod
    def forward(ctx, data, weight, bias, conf):
        ctx.save_for_backward(data, weight)
        ctx.conf = conf
        ctx.has_bias = bias is not None
        return F.conv2d(data, weight, bias, *conf)

    @staticmethod
    def backward(ctx, dy):
        data, weight = ctx.saved_tensors
        stride, pad, dilation, groups = ctx.conf
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        need_b = need_b and ctx.has_bias

        def grads(mask):
            return torch.ops.aten.convolution_backward(
                dy, data, weight, [weight.shape[0]] if ctx.has_bias
                else None, stride, pad, dilation, False, [0, 0], groups,
                mask)

        gx = gw = gb = None
        if need_x or need_b:
            gx, _, gb = grads([need_x, False, need_b])
        if need_w:
            was = torch.backends.cudnn.enabled
            torch._C._set_cudnn_enabled(False)
            try:
                gw = grads([False, True, False])[1]
            finally:
                torch._C._set_cudnn_enabled(was)
        return gx, gw, gb, None


# ---------------------------------------------------------------------------
# Pooling (reference: src/operator/pooling-inl.h)


def _full_extra(dim, k, s, p):
    """Padding added past the upper edge under ``pooling_convention="full"``
    so that the window count rounds up: ceil((dim + 2p - k) / s) + 1
    windows, every one kept (torch's ``ceil_mode`` drops a last window that
    starts in the padding)."""
    out = int(np.ceil((dim + 2 * p - k) / s)) + 1
    return max(0, (out - 1) * s + k - dim - 2 * p)


@register_op("Pooling")
def _pooling(ctx, attrs, data):
    """``max``, ``avg`` or ``sum`` pooling over the two spatial axes of NCHW
    (or ``layout="NHWC"``) data, ``global_pool`` included (its ``sum`` is a
    mean, as in the reference). ``avg`` always divides by ``kh * kw``, the
    padding counted; max pooling pads with -inf (integers: their least
    value). The ``full`` convention pads the upper edge by
    :func:`_full_extra`."""
    kind = attrs.get("pool_type", "max")
    if kind not in ("max", "avg", "sum"):
        raise ValueError(f"unknown pool_type {kind}")
    nhwc = attrs.get("layout", "NCHW") == "NHWC"
    if nhwc:
        data = data.permute(0, 3, 1, 2)
    if bool(attrs.get("global_pool", False)):
        out = torch.amax(data, dim=(2, 3), keepdim=True) if kind == "max" \
            else torch.mean(data, dim=(2, 3), keepdim=True)
        return out.permute(0, 2, 3, 1) if nhwc else out
    kh, kw = _pair(attrs["kernel"])
    sh, sw = _pair(attrs.get("stride", (1, 1)))
    ph, pw = _pair(attrs.get("pad", (0, 0)))
    eh = ew = 0
    if attrs.get("pooling_convention", "valid") == "full":
        eh = _full_extra(data.shape[2], kh, sh, ph)
        ew = _full_extra(data.shape[3], kw, sw, pw)
    x, fill = data, 0.0
    if kind == "max":
        fill = float("-inf")
        if not data.is_floating_point():
            # exact for int32, jax's widest integer without 64-bit mode
            fill, x = float(torch.iinfo(data.dtype).min), data.double()
    pad = (ph, pw)
    if eh or ew or ph > kh // 2 or pw > kw // 2:
        # torch pads at most half a window, and evenly: pad here instead
        x = F.pad(x, (pw, pw + ew, ph, ph + eh), value=fill)
        pad = (0, 0)
    if kind == "max":
        # (torch's own padding leaves data in every window, so its -inf
        # never reaches an output)
        out = F.max_pool2d(x, (kh, kw), (sh, sw), pad).to(data.dtype)
    else:
        out = F.avg_pool2d(x, (kh, kw), (sh, sw), pad, count_include_pad=True,
                           divisor_override=1 if kind == "sum" else kh * kw)
    return out.permute(0, 2, 3, 1) if nhwc else out


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
# BatchNorm (reference: src/operator/batch_norm-inl.h); aux moving_mean and
# moving_var are returned updated: the body gives (outs, new_aux).


def _bn_infer(attrs, shapes):
    data = shapes.get("data")
    if data is not None:
        c = data[int(attrs.get("axis", 1))]
        for name in ("gamma", "beta", "moving_mean", "moving_var"):
            shapes.setdefault(name, (c,))
    return shapes


class _BatchNormTrain(torch.autograd.Function):
    """The training forward on the batch's statistics, ``mean`` and ``inv``
    (fp32, 1/sqrt(var + eps)) computed by the caller. Forward: the
    reference's ``(data - mean) * inv * gamma + beta`` in the data's dtype.
    Backward: the closed form of ``jax.vjp`` through that forward and its
    statistics, in fp32, from ``data``, ``mean``, ``inv`` and ``gamma``
    alone (the separate ops under autograd would keep several full-size
    intermediates of every layer)."""

    @staticmethod
    def forward(ctx, data, gamma, beta, mean, inv, caxis, fix_gamma):
        bshape = [1] * data.dim()
        bshape[caxis] = -1
        g = torch.ones_like(gamma) if fix_gamma else gamma
        dt = data.dtype
        out = (data - mean.to(dt).view(bshape)) * inv.to(dt).view(bshape)
        out = out * g.view(bshape) + beta.view(bshape)
        ctx.save_for_backward(data, mean, inv, g)
        ctx.attrs = (caxis, fix_gamma, gamma.dtype, beta.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        data, mean, inv, g = ctx.saved_tensors
        caxis, fix_gamma, g_dtype, b_dtype = ctx.attrs
        bshape = [1] * data.dim()
        bshape[caxis] = -1
        axes = [i for i in range(data.dim()) if i != caxis]
        n = data.numel() // data.shape[caxis]
        xhat = (_at_least_fp32(data) - mean.view(bshape)) * inv.view(bshape)
        d32 = _at_least_fp32(dout)
        dbeta = d32.sum(axes)
        dgamma = (d32 * xhat).sum(axes)
        dx = (d32 - xhat * (dgamma / n).view(bshape)
              - (dbeta / n).view(bshape)) * (g.to(inv.dtype) * inv).view(bshape)
        return (dx.to(data.dtype), None if fix_gamma else dgamma.to(g_dtype),
                dbeta.to(b_dtype), None, None, None, None)


@register_op(
    "BatchNorm",
    inputs=("data", "gamma", "beta"),
    aux=("moving_mean", "moving_var"),
    infer_param_shapes=_bn_infer,
)
def _batch_norm(ctx, attrs, data, gamma, beta, moving_mean, moving_var):
    """Normalise over every axis but ``axis`` (1, or 3 for NHWC): in
    training by the batch's mean and biased variance, taken in fp32, and the
    moving statistics become ``momentum * old + (1 - momentum) * batch``
    (not ``F.batch_norm``'s unbiased variance and opposite momentum); in
    evaluation, or with ``use_global_stats``, by the moving statistics,
    which stay as they are. The normalisation runs in the data's dtype (bf16
    under amp, the statistics cast to it); ``fix_gamma`` puts ones in
    gamma's place, so gamma's gradient is 0."""
    eps = float(attrs.get("eps", 1e-3))
    momentum = float(attrs.get("momentum", 0.9))
    fix_gamma = bool(attrs.get("fix_gamma", True))
    caxis = int(attrs.get("axis", 1)) % data.dim()
    if bool(attrs.get("use_global_stats", False)) or not ctx.is_train:
        bshape = [1] * data.dim()
        bshape[caxis] = -1
        dt = data.dtype
        g = torch.ones_like(gamma) if fix_gamma else gamma
        inv = torch.rsqrt(_at_least_fp32(moving_var) + eps).to(dt)
        out = (data - moving_mean.to(dt).view(bshape)) * inv.view(bshape)
        out = out * g.view(bshape) + beta.view(bshape)
        return (out,), (moving_mean, moving_var)
    axes = [i for i in range(data.dim()) if i != caxis]
    with torch.no_grad():
        var, mean = torch.var_mean(_at_least_fp32(data), dim=axes,
                                   correction=0)
        inv = torch.rsqrt(var + eps)
        new_mean = momentum * moving_mean + (1 - momentum) * mean
        new_var = momentum * moving_var + (1 - momentum) * var
    out = _BatchNormTrain.apply(data, gamma, beta, mean, inv, caxis,
                                fix_gamma)
    return (out,), (new_mean, new_var)


# ---------------------------------------------------------------------------
# LRN (reference: mxnet_tpu/ops/nn.py ``_lrn``, after src/operator/lrn-inl.h)


@register_op("LRN")
def _lrn(ctx, attrs, data):
    """Local response norm across channels: ``data * (knorm + alpha / nsize
    * S) ** -beta``, where ``S`` sums the squares over ``nsize`` channels
    from ``nsize // 2`` below, zeros past the edges. The reference's
    composition, op for op, in the data's dtype (bf16 under amp); its
    gradient is autograd's."""
    nsize = int(attrs.get("nsize", 5))
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    knorm = float(attrs.get("knorm", 2.0))
    half = nsize // 2
    pad = F.pad(data.square(), (0, 0) * (data.dim() - 2) + (half, half))
    acc = sum(pad[:, i:i + data.shape[1]] for i in range(nsize))
    return data * torch.pow(knorm + alpha / nsize * acc, -beta)


# ---------------------------------------------------------------------------
# Dropout (reference: src/operator/dropout-inl.h), its mask from the node's
# generator (:func:`~.tensor.op_rng`)


def keep_mask(gen, keep, shape, device):
    """A boolean mask of ``shape``, each entry true with probability
    ``keep``, drawn from ``gen`` (one uniform draw an entry)."""
    return torch.rand(shape, generator=gen, device=device) < keep


def dropout_apply(ctx, data, p):
    """The reference's train-mode dropout: keep with probability 1 - p and
    scale the kept values by 1 / (1 - p)."""
    keep = 1.0 - p
    mask = keep_mask(op_rng(ctx, data.device), keep, data.shape, data.device)
    return torch.where(mask, data / keep, torch.zeros((), dtype=data.dtype,
                                                      device=data.device))


@register_op("Dropout")
def _dropout(ctx, attrs, data):
    """The identity in inference or at ``p`` = 0; in training each entry is
    kept with probability 1 - p and scaled by 1 / (1 - p)."""
    p = float(attrs.get("p", 0.5))
    if not ctx.is_train or p <= 0.0:
        return data
    return dropout_apply(ctx, data, p)


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
# Concat / SliceChannel (reference: src/operator/{concat,slice_channel}-inl.h)


@register_op("Concat", inputs=lambda attrs: [
    f"arg{i}" for i in range(int(attrs.get("num_args", 2)))],
    alias=("concat",))
def _concat(ctx, attrs, *args):
    return torch.cat(args, dim=int(attrs.get("dim", 1)))


@register_op("SliceChannel",
             num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)),
             alias=("split",))
def _slice_channel(ctx, attrs, data):
    """``num_outputs`` equal parts along ``axis`` (views of the input),
    the axis squeezed away under ``squeeze_axis``."""
    n = int(attrs.get("num_outputs", 1))
    axis = int(attrs.get("axis", 1))
    if data.shape[axis] % n:
        raise ValueError(f"SliceChannel: axis {axis} of {tuple(data.shape)} "
                         f"does not split into {n} equal parts")
    parts = torch.chunk(data, n, dim=axis)
    if attrs.get("squeeze_axis", False):
        parts = [q.squeeze(axis) for q in parts]
    return tuple(parts)


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
        _at_least_fp32(data), label, axis,
        bool(attrs.get("use_ignore", False)),
        int(attrs.get("ignore_label", -1)),
        float(attrs.get("grad_scale", 1.0)),
        attrs.get("normalization", "null"))

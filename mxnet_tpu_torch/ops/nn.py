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

Over the replicas of a data-parallel walk (several contexts, one slice of
the batch each) the ops see the global batch where the reference's one
program over the whole batch does: ``BatchNorm`` trains on the global
batch's statistics (:func:`_batch_norm_replicas`, also its one-device
body), and the losses' ``batch`` and ``valid`` normalisations divide by the
global batch and the global count of valid labels.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import register_op, register_replica_fn
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


def _native_weight_grad(dy, x, w, stride, pad, dilation, groups):
    """The weight gradient of a convolution through PyTorch's native
    convolution (im2col and a GEMM), called directly: one
    ``_slow_conv2d_backward`` a group on contiguous slices, which is what
    ``convolution_backward`` runs with cuDNN switched off. Switching cuDNN
    off is a process-wide flag, which the autograd engine's device threads
    would race on when several cards run a backward at once (the
    data-parallel group). A dilated kernel, which no model of the repo
    has, takes ``F.unfold`` and one product a group."""
    kernel = list(w.shape[2:])
    parts = []
    for g in range(groups):
        xg = x.narrow(1, g * (x.shape[1] // groups),
                      x.shape[1] // groups).contiguous()
        wg = w.narrow(0, g * (w.shape[0] // groups),
                      w.shape[0] // groups).contiguous()
        dg = dy.narrow(1, g * (dy.shape[1] // groups),
                       dy.shape[1] // groups).contiguous()
        if tuple(dilation) == (1, 1):
            parts.append(torch.ops.aten._slow_conv2d_backward.output_mask(
                dg, xg, wg, kernel, list(stride), list(pad),
                [False, True, False])[1])
        else:
            cols = F.unfold(xg, kernel, dilation=dilation, padding=pad,
                            stride=stride)
            d = dg.reshape(dg.shape[0], dg.shape[1], -1)
            parts.append(torch.einsum("nol,nkl->ok", d, cols)
                         .reshape(wg.shape))
    return parts[0] if groups == 1 else torch.cat(parts, 0)


class _ConvIeeeWeightGrad(torch.autograd.Function):
    """An fp32 convolution on the card, with TF32 off, whose weight
    gradient runs PyTorch's native CUDA convolution (im2col and a cuBLAS
    GEMM, :func:`_native_weight_grad`) in place of cuDNN. The forward and
    the input gradient stay on cuDNN. The algorithm cuDNN picks for some
    weight gradients is not fp32-accurate even with TF32 off: LeNet's first
    convolution at batch 8 lands 1.1e-3 of max-abs from float64, not
    bit-equal to the TF32 result, where the native path lands near 1e-7
    (``chip_smoke.py`` phase 1 reads both). With TF32 on, the caller has
    chosen speed over fp32 accuracy and cuDNN keeps the whole convolution.
    On CPU tensors (the tests) the weight gradient is
    ``convolution_backward``'s, which has no cuDNN there."""

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
            gw = _native_weight_grad(dy, data, weight, stride, pad,
                                     dilation, groups) if dy.is_cuda \
                else grads([False, True, False])[1]
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
    """The training forward over the R replicas of a walk (1 off a
    data-parallel walk) on the batch's statistics, ``mean`` and ``inv``
    (fp32, 1/sqrt(var + eps)) computed by the caller, each replica's a copy
    of the global batch's. Forward: the reference's ``(data - mean) * inv *
    gamma + beta`` in the data's dtype. Backward: the closed form of
    ``jax.vjp`` through that forward and its statistics, in fp32, from
    ``data``, ``mean``, ``inv`` and ``gamma`` alone (the separate ops under
    autograd would keep several full-size intermediates of every layer);
    the replicas' ``dbeta`` and ``dgamma`` are summed (on the first
    replica's device, in replica order) and divided by the global count
    before each replica's ``dx``, and gamma's and beta's gradients are each
    replica's own sums, which the executor group adds with the other
    gradients. Inputs: ``caxis``, ``fix_gamma``, R, then R each of data,
    gamma, beta, mean and inv."""

    @staticmethod
    def forward(ctx, caxis, fix_gamma, count, *flat):
        data, gamma, beta, mean, inv = (flat[i * count:(i + 1) * count]
                                        for i in range(5))
        outs, gs = [], []
        for x, gm, b, m, v in zip(data, gamma, beta, mean, inv):
            bshape = [1] * x.dim()
            bshape[caxis] = -1
            g = torch.ones_like(gm) if fix_gamma else gm
            dt = x.dtype
            out = (x - m.to(dt).view(bshape)) * v.to(dt).view(bshape)
            outs.append(out * g.view(bshape) + b.view(bshape))
            gs.append(g)
        ctx.save_for_backward(*data, *mean, *inv, *gs)
        ctx.attrs = (caxis, fix_gamma, count, gamma[0].dtype, beta[0].dtype)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        caxis, fix_gamma, count, g_dtype, b_dtype = ctx.attrs
        saved = ctx.saved_tensors
        data, mean, inv, gs = (saved[i * count:(i + 1) * count]
                               for i in range(4))
        home = data[0].device
        parts = []
        for x, m, v, d in zip(data, mean, inv, douts):
            bshape = [1] * x.dim()
            bshape[caxis] = -1
            axes = [i for i in range(x.dim()) if i != caxis]
            xhat = (_at_least_fp32(x) - m.view(bshape)) * v.view(bshape)
            d32 = _at_least_fp32(d)
            parts.append((xhat, d32, bshape, d32.sum(axes),
                          (d32 * xhat).sum(axes)))
        n = sum(x.numel() // x.shape[caxis] for x in data)
        dbeta = parts[0][3].to(home)
        dgamma = parts[0][4].to(home)
        for p in parts[1:]:
            dbeta = dbeta + p[3].to(home)
            dgamma = dgamma + p[4].to(home)
        dx, dg, db = [], [], []
        for x, v, g, (xhat, d32, bshape, b_r, g_r) in zip(data, inv, gs,
                                                          parts):
            dev = x.device
            dx.append(((d32 - xhat * (dgamma.to(dev) / n).view(bshape)
                        - (dbeta.to(dev) / n).view(bshape))
                       * (g.to(v.dtype) * v).view(bshape)).to(x.dtype))
            dg.append(None if fix_gamma else g_r.to(g_dtype))
            db.append(b_r.to(b_dtype))
        return (None, None, None, *dx, *dg, *db) + (None,) * (2 * count)


@register_op(
    "BatchNorm",
    inputs=("data", "gamma", "beta"),
    aux=("moving_mean", "moving_var"),
    infer_param_shapes=_bn_infer,
)
def _batch_norm(ctx, attrs, data, gamma, beta, moving_mean, moving_var):
    """BatchNorm on one device: :func:`_batch_norm_replicas` over one
    replica."""
    ((outs, new_aux),) = _batch_norm_replicas(
        [ctx], attrs, [(data, gamma, beta)], [(moving_mean, moving_var)])
    return outs, tuple(new_aux)


@register_replica_fn("BatchNorm")
def _batch_norm_replicas(ctxs, attrs, inputs, aux):
    """BatchNorm over the replicas of a walk (one off a data-parallel
    walk), each replica's ``(outs, new_aux)``. Normalise over every axis but
    ``axis`` (1, or 3 for NHWC): in training by the global batch's mean and
    biased variance, taken in fp32 (``torch.var_mean`` on one replica; on
    several, two passes over every replica's slice summed on the first
    replica's device), and every replica's moving statistics become the
    same ``momentum * old + (1 - momentum) * batch`` (not ``F.batch_norm``'s
    unbiased variance and opposite momentum); in evaluation, or with
    ``use_global_stats``, each replica by the moving statistics, which stay
    as they are. The normalisation runs in the data's dtype (bf16 under
    amp, the statistics cast to it); ``fix_gamma`` puts ones in gamma's
    place, so gamma's gradient is 0."""
    eps = float(attrs.get("eps", 1e-3))
    momentum = float(attrs.get("momentum", 0.9))
    fix_gamma = bool(attrs.get("fix_gamma", True))
    data = [i[0] for i in inputs]
    caxis = int(attrs.get("axis", 1)) % data[0].dim()
    bshape = [1] * data[0].dim()
    bshape[caxis] = -1
    if bool(attrs.get("use_global_stats", False)) or not ctxs[0].is_train:
        results = []
        for (x, gamma, beta), (moving_mean, moving_var) in zip(inputs, aux):
            dt = x.dtype
            g = torch.ones_like(gamma) if fix_gamma else gamma
            inv = torch.rsqrt(_at_least_fp32(moving_var) + eps).to(dt)
            out = (x - moving_mean.to(dt).view(bshape)) * inv.view(bshape)
            out = out * g.view(bshape) + beta.view(bshape)
            results.append(((out,), [moving_mean, moving_var]))
        return results
    axes = [i for i in range(data[0].dim()) if i != caxis]
    home = data[0].device
    with torch.no_grad():
        if len(data) == 1:
            var, mean = torch.var_mean(_at_least_fp32(data[0]), dim=axes,
                                       correction=0)
        else:
            n = sum(x.numel() // x.shape[caxis] for x in data)
            total = sum(_at_least_fp32(x).sum(axes).to(home) for x in data)
            mean = total / n
            sq = sum(((_at_least_fp32(x) - mean.to(x.device).view(bshape))
                      ** 2).sum(axes).to(home) for x in data)
            var = sq / n
        inv = torch.rsqrt(var + eps)
        moving_mean, moving_var = aux[0]
        new_mean = momentum * moving_mean + (1 - momentum) * mean
        new_var = momentum * moving_var + (1 - momentum) * var
    devs = [x.device for x in data]
    outs = _BatchNormTrain.apply(
        caxis, fix_gamma, len(data), *data, *(i[1] for i in inputs),
        *(i[2] for i in inputs), *(mean.to(d) for d in devs),
        *(inv.to(d) for d in devs))
    return [((out,), [new_mean.to(d), new_var.to(d)])
            for out, d in zip(outs, devs)]


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
    row (:func:`~.tensor.take_fill`). On the card the rows are gathered by
    ``F.embedding``, whose weight gradient sums each row's terms in a fixed
    order, so two runs of a step give the same bits; ``index_select``'s is
    an atomic scatter-add, whose bf16 sums differ from run to run. On the
    CPU ``index_select``'s gradient is deterministic already, and stays."""
    if weight.device.type == "cuda":
        return take_fill(weight, data, 0,
                         gather=lambda w, ids: F.embedding(ids, w))
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
                norm, batches, valid_total):
        p = torch.softmax(data, dim=axis)
        ctx.save_for_backward(p, label)
        ctx.attrs = (axis, use_ignore, ignore_label, grad_scale, norm,
                     batches, valid_total)
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        (axis, use_ignore, ignore_label, grad_scale, norm, batches,
         valid_total) = ctx.attrs
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
            scale = scale / (p.shape[0] * batches)
        elif norm == "valid":
            count = valid_total(p.device) if valid_total else valid.sum()
            scale = scale / torch.clamp(count, min=1.0)
        return grad * scale, None, None, None, None, None, None, None, None


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
    use_ignore = bool(attrs.get("use_ignore", False))
    ignore_label = int(attrs.get("ignore_label", -1))
    norm = attrs.get("normalization", "null")
    valid_total = None
    if ctx.replicas is not None and norm == "valid":
        li = as_int32(label)
        valid_total = ctx.replicas.put_count(
            ctx, (li != ignore_label).sum().float() if use_ignore
            else torch.tensor(float(li.numel())))
    return _SoftmaxOutput.apply(
        _at_least_fp32(data), label, axis, use_ignore, ignore_label,
        float(attrs.get("grad_scale", 1.0)), norm, ctx.replica_count,
        valid_total)


# ---------------------------------------------------------------------------
# SoftmaxActivation (reference: src/operator/softmax_activation-inl.h) and
# MakeLoss (reference: src/operator/make_loss-inl.h)


@register_op("SoftmaxActivation")
def _softmax_activation(ctx, attrs, data):
    """Softmax over the channel axis (``mode="channel"``) or over each
    sample's flattened entries (``"instance"``, the default)."""
    if attrs.get("mode", "instance") == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


class _MakeLoss(torch.autograd.Function):
    """The identity, whose gradient is the constant ``scale`` whatever the
    head gradient (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, data, scale):
        ctx.scale = scale
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.scale), None


@register_op("MakeLoss")
def _make_loss(ctx, attrs, data):
    """Forward the identity; backward ``grad_scale``, divided by the batch
    under ``normalization="batch"`` (any other normalization is
    ``"null"``, as in the reference)."""
    scale = float(attrs.get("grad_scale", 1.0))
    if attrs.get("normalization", "null") == "batch":
        scale /= data.shape[0] * ctx.replica_count
    return _MakeLoss.apply(data, scale)

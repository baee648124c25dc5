"""Tensor operator library (reference: mxnet_tpu/ops/tensor.py, every op in
its order): the unary math family, binary/broadcast/scalar arithmetic and
comparisons, reductions, argmax/topk/sort, dot/batch_dot, matrix
manipulation, init ops, sampling and the fused optimizer updates.

Bodies are plain torch ops; PyTorch runs each eagerly, one launch or a few.
Where torch and jax.numpy differ, the body keeps the reference's result:
comparisons return the input's dtype, integer sums stay in the input's
dtype, ``argmax``/``argsort``/``topk`` indices come back as float32, ``dot``
contracts the last axis of ``lhs`` with the second-to-last of ``rhs`` as
``jnp.dot`` does, and ``argsort`` is stable. Ops with no inputs create their
result on ``ctx.device`` (the card unless the caller names another). The
sampling ops draw from ``ctx.rng``, or else from the per-device generator of
:mod:`mxnet_tpu_torch.random`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register_op

# ---------------------------------------------------------------------------
# helpers


def _axis_tuple(axis, ndim, exclude=False):
    if axis is None or axis == () or axis == []:
        ax = tuple(range(ndim))
    elif isinstance(axis, int):
        ax = (axis % ndim,)
    else:
        ax = tuple(a % ndim for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _unary(name, f, alias=()):
    @register_op(name, inputs=("data",), alias=alias)
    def _op(ctx, attrs, data, _f=f):
        return _f(data)
    return _op


def _float(x):
    """Integer and bool tensors as float32, where jax.numpy's float-valued
    functions (mean, sqrt, ...) promote them."""
    return x if x.is_floating_point() else x.to(torch.float32)


def float_to_int(x, dtype):
    """``x.astype(dtype)`` for a float ``x`` and an integer ``dtype`` as
    XLA converts: NaN to 0, values past the type's range (the infinities
    among them) to its limits, the rest truncated. CUDA's conversion
    saturates and the CPU's does not, so the rule is written out here and
    both devices agree."""
    info = torch.iinfo(dtype)
    # 16-bit floats widen exactly; the limits' neighbours are exact in fp32
    t = torch.trunc(x.float() if x.element_size() < 4 else x)
    big = t >= float(info.max) + 1.0
    small = t < float(info.min)
    out = torch.where(big | small | torch.isnan(t), 0, t).to(dtype)
    return torch.where(big, info.max, torch.where(small, info.min, out))


def as_int32(x):
    """Indices as the reference's ``astype(int32)`` makes them."""
    if x.is_floating_point():
        return float_to_int(x, torch.int32)
    return x.to(torch.int32)


def take_fill(a, indices, axis):
    """``jnp.take(a, indices, axis)`` with its default mode: an index in
    [-n, 0) wraps, one outside [-n, n) gives the fill value (NaN for
    floats, the least value for signed integers, the largest for unsigned,
    True for bool). The gather sees clamped indices only, so no index
    kernel is asked for a row that is not there."""
    n = a.shape[axis]
    idx = as_int32(indices).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = torch.index_select(a, axis, torch.where(valid, idx, 0).reshape(-1))
    out = out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])
    if a.dtype == torch.bool:
        fill = True
    elif a.is_floating_point():
        fill = float("nan")
    else:
        info = torch.iinfo(a.dtype)
        fill = info.min if info.min < 0 else info.max
    mask = valid.reshape((1,) * axis + idx.shape
                         + (1,) * (a.dim() - axis - 1))
    return torch.where(mask, out, fill)


def _out_device(ctx):
    from ..context import current_context

    device = getattr(ctx, "device", None)
    return device if device is not None else current_context().torch_device


def _dtype(name, default="float32"):
    from ..ndarray import _torch_dtype

    return _torch_dtype(name if name is not None else default)


def _like(data, value):
    """A python scalar as a 0-d tensor on ``data``'s device; torch promotes
    0-d tensors as jax promotes weakly typed scalars."""
    return torch.tensor(value, device=data.device)


# ---------------------------------------------------------------------------
# unary math family (reference: src/operator/tensor/elemwise_unary_op.cc)

_unary("abs", torch.abs)
_unary("sign", lambda x: torch.where(torch.isnan(x), x, torch.sign(x))
       if x.is_floating_point() else torch.sign(x))   # NaN stays NaN
_unary("round", torch.round)   # half to even, as jnp.round
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("rint", torch.round)
_unary("fix", torch.trunc)
_unary("square", torch.square)
_unary("sqrt", lambda x: torch.sqrt(_float(x)))
_unary("rsqrt", lambda x: torch.rsqrt(_float(x)))
_unary("exp", lambda x: torch.exp(_float(x)))
_unary("log", lambda x: torch.log(_float(x)))
_unary("log10", lambda x: torch.log10(_float(x)))
_unary("log2", lambda x: torch.log2(_float(x)))
_unary("log1p", lambda x: torch.log1p(_float(x)))
_unary("expm1", lambda x: torch.expm1(_float(x)))
_unary("sin", lambda x: torch.sin(_float(x)))
_unary("cos", lambda x: torch.cos(_float(x)))
_unary("tan", lambda x: torch.tan(_float(x)))
_unary("arcsin", lambda x: torch.arcsin(_float(x)))
_unary("arccos", lambda x: torch.arccos(_float(x)))
_unary("arctan", lambda x: torch.arctan(_float(x)))
_unary("sinh", lambda x: torch.sinh(_float(x)))
_unary("cosh", lambda x: torch.cosh(_float(x)))
_unary("tanh", lambda x: torch.tanh(_float(x)))
_unary("arcsinh", lambda x: torch.arcsinh(_float(x)))
_unary("arccosh", lambda x: torch.arccosh(_float(x)))
_unary("arctanh", lambda x: torch.arctanh(_float(x)))
_unary("degrees", lambda x: torch.rad2deg(_float(x)))
_unary("radians", lambda x: torch.deg2rad(_float(x)))
_unary("negative", torch.negative)
_unary("reciprocal", lambda x: torch.reciprocal(_float(x)))
_unary("sigmoid", lambda x: torch.sigmoid(_float(x)))
_unary("relu", torch.relu)
_unary("softsign", lambda x: x / (1 + torch.abs(x)))
_unary("gamma", lambda x: torch.exp(torch.lgamma(_float(x))))
_unary("gammaln", lambda x: torch.lgamma(_float(x)))
_unary("_copy", lambda x: x, alias=("identity",))
# device movement is NDArray.copyto / as_in_context outside the graph, so
# the cross-device copy node is graph-level identity (reference:
# src/ndarray/ndarray.cc _CrossDeviceCopy)
_unary("_CrossDeviceCopy", lambda x: x)


@register_op("BlockGrad", alias=("stop_gradient",))
def _block_grad(ctx, attrs, data):
    """Identity forward, zero gradient (reference:
    src/operator/tensor/elemwise_unary_op.cc BlockGrad)."""
    return data.detach()


@register_op("Cast", alias=("cast",))
def _cast(ctx, attrs, data):
    dtype = _dtype(attrs.get("dtype"))
    if data.is_floating_point() and not dtype.is_floating_point \
            and dtype != torch.bool:
        return float_to_int(data, dtype)
    return data.to(dtype)


# ---------------------------------------------------------------------------
# binary elementwise + scalar variants
# (reference: elemwise_binary_op.cc, elemwise_binary_scalar_op.cc)


def _binary(name, f, alias=()):
    @register_op(name, inputs=("lhs", "rhs"), alias=alias)
    def _op(ctx, attrs, lhs, rhs, _f=f):
        return _f(lhs, rhs)


def _scalar(name, f):
    @register_op(name, inputs=("data",))
    def _op(ctx, attrs, data, _f=f):
        return _f(data, attrs.get("scalar", 0.0))


def _cmp(f):
    return lambda a, b: f(a, b).to(a.dtype)


def _hypot(a, b):
    """jnp.hypot: integer inputs promote to float; a scalar takes a's
    type."""
    a = _float(a)
    b = _float(b) if isinstance(b, torch.Tensor) else \
        torch.tensor(float(b), dtype=a.dtype, device=a.device)
    return torch.hypot(a, b)


def _maximum(a, b):
    return torch.maximum(a, b if isinstance(b, torch.Tensor) else _like(a, b))


def _minimum(a, b):
    return torch.minimum(a, b if isinstance(b, torch.Tensor) else _like(a, b))


_binary("elemwise_add", torch.add, alias=("_Plus", "_plus", "_add"))
_binary("elemwise_sub", torch.subtract, alias=("_Minus", "_minus", "_sub"))
_binary("elemwise_mul", torch.multiply, alias=("_Mul", "_mul"))
_binary("elemwise_div", torch.true_divide, alias=("_Div", "_div"))
_binary("_power", torch.pow, alias=("_Power",))
_binary("_maximum", _maximum, alias=("_Maximum",))
_binary("_minimum", _minimum, alias=("_Minimum",))
_binary("_hypot", _hypot)
# gradient-accumulation add: forward identical to add, kept as a distinct
# name so graphs spell out grad aggregation (elemwise_binary_op_basic.cc:18)
_binary("_grad_add", torch.add)
_binary("_equal", _cmp(torch.eq))
_binary("_not_equal", _cmp(torch.ne))
_binary("_greater", _cmp(torch.gt))
_binary("_greater_equal", _cmp(torch.ge))
_binary("_lesser", _cmp(torch.lt))
_binary("_lesser_equal", _cmp(torch.le))

_scalar("_plus_scalar", lambda x, s: x + s)
_scalar("_minus_scalar", lambda x, s: x - s)
_scalar("_rminus_scalar", lambda x, s: s - x)
_scalar("_mul_scalar", lambda x, s: x * s)
_scalar("_div_scalar", lambda x, s: x / s)
_scalar("_rdiv_scalar", lambda x, s: s / x)
_scalar("_power_scalar", lambda x, s: x ** s)
_scalar("_rpower_scalar", lambda x, s: s ** x)
_scalar("_hypot_scalar", _hypot)
_scalar("_maximum_scalar", _maximum)
_scalar("_minimum_scalar", _minimum)
_scalar("_equal_scalar", _cmp(torch.eq))
_scalar("_not_equal_scalar", _cmp(torch.ne))
_scalar("_greater_scalar", _cmp(torch.gt))
_scalar("_greater_equal_scalar", _cmp(torch.ge))
_scalar("_lesser_scalar", _cmp(torch.lt))
_scalar("_lesser_equal_scalar", _cmp(torch.le))


# broadcast_* family (reference: elemwise_binary_broadcast_op.cc)
for _n, _f in [
    ("broadcast_add", torch.add), ("broadcast_plus", torch.add),
    ("broadcast_sub", torch.subtract), ("broadcast_minus", torch.subtract),
    ("broadcast_mul", torch.multiply), ("broadcast_div", torch.true_divide),
    ("broadcast_power", torch.pow),
    ("broadcast_maximum", _maximum), ("broadcast_minimum", _minimum),
    ("broadcast_hypot", _hypot),
    ("broadcast_equal", _cmp(torch.eq)),
    ("broadcast_not_equal", _cmp(torch.ne)),
    ("broadcast_greater", _cmp(torch.gt)),
    ("broadcast_greater_equal", _cmp(torch.ge)),
    ("broadcast_lesser", _cmp(torch.lt)),
    ("broadcast_lesser_equal", _cmp(torch.le)),
]:
    _binary(_n, _f)


@register_op("broadcast_to")
def _broadcast_to(ctx, attrs, data):
    shape = tuple(attrs["shape"])
    tgt = tuple(d if s == 0 else s for s, d in zip(shape, data.shape))
    return data.expand(tgt)


@register_op("broadcast_axis", alias=("broadcast_axes",))
def _broadcast_axis(ctx, attrs, data):
    axes = attrs.get("axis", ())
    sizes = attrs.get("size", ())
    if isinstance(axes, int):
        axes, sizes = (axes,), (sizes,)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return data.expand(tuple(tgt))


# ---------------------------------------------------------------------------
# reductions (reference: src/operator/tensor/broadcast_reduce_op_value.cc)


def _sum(x, axis, keepdims):
    # torch sums integers into int64; jnp keeps the input's integer type
    out = torch.sum(x, dim=axis, keepdim=keepdims)
    return out.to(x.dtype) if not x.is_floating_point() and x.dtype != \
        torch.bool else out


def _prod(x, axis, keepdims):
    out = x
    for a in sorted(axis, reverse=True):
        out = torch.prod(out, dim=a, keepdim=keepdims)
    return out.to(x.dtype) if out.dtype != x.dtype and x.dtype != \
        torch.bool else out


def _nanprod(x, axis, keepdims):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), axis,
                 keepdims)


def _nansum(x, axis, keepdims):
    return torch.nansum(x, dim=axis, keepdim=keepdims)


def _mean(x, axis, keepdims):
    return torch.mean(_float(x), dim=axis, keepdim=keepdims)


def _amax(x, axis, keepdims):
    return torch.amax(x, dim=axis, keepdim=keepdims)


def _amin(x, axis, keepdims):
    return torch.amin(x, dim=axis, keepdim=keepdims)


REDUCERS = {"sum": _sum, "mean": _mean, "prod": _prod, "nansum": _nansum,
            "nanprod": _nanprod, "max": _amax, "min": _amin}


def reduce(name, data, axis=None, keepdims=False, exclude=False):
    """Reduction ``name`` over MXNet's ``axis``/``exclude`` spec (also used
    by ``NDArray.sum``/``max``/``min``/``mean``)."""
    if data.dim() == 0:
        return REDUCERS[name](data.reshape(1), (0,), False)
    ax = _axis_tuple(axis, data.dim(), exclude)
    if not ax:
        return data.clone()
    return REDUCERS[name](data, ax, keepdims)


def _reduce(name, alias=()):
    @register_op(name, inputs=("data",), alias=alias)
    def _op(ctx, attrs, data, _name=name):
        return reduce(_name, data, attrs.get("axis"),
                      bool(attrs.get("keepdims", False)),
                      attrs.get("exclude", False))


_reduce("sum", alias=("sum_axis",))
_reduce("mean")
_reduce("prod")
_reduce("nansum")
_reduce("nanprod")
_reduce("max", alias=("max_axis",))
_reduce("min", alias=("min_axis",))


@register_op("norm")
def _norm(ctx, attrs, data):
    return torch.sqrt(_float(torch.sum(torch.square(data))))


def _arg_extreme(f, attrs, data):
    axis = attrs.get("axis")
    keepdims = bool(attrs.get("keepdims", False))
    out = f(data) if axis is None else f(data, dim=axis)
    if keepdims and axis is not None:
        out = out.unsqueeze(axis)
    return out.to(torch.float32)


@register_op("argmax")
def _argmax(ctx, attrs, data):
    return _arg_extreme(torch.argmax, attrs, data)


@register_op("argmin")
def _argmin(ctx, attrs, data):
    return _arg_extreme(torch.argmin, attrs, data)


@register_op("argmax_channel")
def _argmax_channel(ctx, attrs, data):
    """argmax over axis 1 (reference: broadcast_reduce_op_index.cc
    argmax_channel)."""
    return torch.argmax(data, dim=1).to(torch.float32)


def _order_key(x):
    """``x`` as integers in ``lax.top_k``'s total order: a float's bits
    made monotone (-NaN < -inf < ... < -0.0 < 0.0 < ... < inf < NaN; 16-bit
    floats widen exactly), integers as they are."""
    if not x.is_floating_point():
        return x.to(torch.int8) if x.dtype == torch.bool else x
    if x.dtype == torch.float64:
        bits, flip = x.view(torch.int64), 0x7FFFFFFFFFFFFFFF
    else:
        bits, flip = x.float().view(torch.int32), 0x7FFFFFFF
    return torch.where(bits < 0, bits ^ flip, bits)


@register_op("topk", num_outputs=lambda attrs: 2 if attrs.get(
    "ret_typ", "indices") == "both" else 1)
def _topk(ctx, attrs, data):
    """Reference: src/operator/tensor/ordering_op.cc TopK, through
    ``lax.top_k`` (of ``-x`` for ``is_ascend``): the total order of
    :func:`_order_key`, and among equal values the lowest index first.
    Value and index go into one int64 key for ``torch.topk``; 64-bit
    inputs, whose values fill it alone, take a stable sort."""
    k = int(attrs.get("k", 1))
    axis = attrs.get("axis", -1)
    ret_typ = attrs.get("ret_typ", "indices")
    is_ascend = bool(attrs.get("is_ascend", False))
    x = torch.movedim(data, axis, -1)
    key = _order_key(-x if is_ascend else x)
    n = x.shape[-1]
    if key.dtype == torch.int64:
        raw_idx = torch.sort(key, dim=-1, descending=True,
                             stable=True)[1][..., :k]
    else:
        comp = key.to(torch.int64)
        comp <<= 32
        comp |= torch.arange(n - 1, -1, -1, device=x.device)
        raw_idx = (n - 1) - (torch.topk(comp, k, dim=-1).values
                             & 0xFFFFFFFF)
    vals = x.gather(-1, raw_idx)
    if ret_typ == "value":
        return torch.movedim(vals, -1, axis)
    if ret_typ == "mask":
        # 1 at positions whose element is among the top-k along `axis`
        mask = torch.zeros_like(x).scatter_(-1, raw_idx, 1)
        return torch.movedim(mask, -1, axis)
    idx = torch.movedim(raw_idx, -1, axis).to(torch.float32)
    if ret_typ == "both":
        return torch.movedim(vals, -1, axis), idx
    return idx


@register_op("sort")
def _sort(ctx, attrs, data):
    axis = attrs.get("axis", -1)
    out = torch.sort(data, dim=axis, stable=True).values
    if not bool(attrs.get("is_ascend", True)):
        out = torch.flip(out, dims=(axis,))
    return out


@register_op("argsort")
def _argsort(ctx, attrs, data):
    axis = attrs.get("axis", -1)
    idx = torch.argsort(data, dim=axis, stable=True)
    if not bool(attrs.get("is_ascend", True)):
        idx = torch.flip(idx, dims=(axis,))
    return idx.to(torch.float32)


# ---------------------------------------------------------------------------
# linear algebra (reference: src/operator/tensor/matrix_op.cc dot/batch_dot)


@register_op("dot", inputs=("lhs", "rhs"))
def _dot(ctx, attrs, lhs, rhs):
    """``jnp.dot``: the last axis of ``lhs`` against the second-to-last of
    ``rhs`` (its only axis when 1-D); 2-D by 2-D is one ``torch.matmul``."""
    if attrs.get("transpose_a", False):
        lhs = lhs.transpose(-1, -2)
    if attrs.get("transpose_b", False):
        rhs = rhs.transpose(-1, -2)
    if lhs.dim() == 0 or rhs.dim() == 0:
        return lhs * rhs
    if lhs.dim() <= 2 and rhs.dim() <= 2:
        return torch.matmul(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.dim() - 1],
                                           [max(rhs.dim() - 2, 0)]))


@register_op("batch_dot", inputs=("lhs", "rhs"))
def _batch_dot(ctx, attrs, lhs, rhs):
    if attrs.get("transpose_a", False):
        lhs = lhs.transpose(-1, -2)
    if attrs.get("transpose_b", False):
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


# ---------------------------------------------------------------------------
# matrix manipulation (reference: src/operator/tensor/matrix_op.cc)


@register_op("transpose")
def _transpose(ctx, attrs, data):
    axes = attrs.get("axes") or tuple(reversed(range(data.dim())))
    return data.permute(tuple(axes))


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


@register_op("Flatten", alias=("flatten",))
def _flatten(ctx, attrs, data):
    return data.reshape(data.shape[0], -1)


@register_op("reverse", alias=("flip",))
def _reverse(ctx, attrs, data):
    ax = attrs.get("axis", 0)
    ax = (ax,) if isinstance(ax, int) else tuple(ax)
    return torch.flip(data, dims=ax)


@register_op("repeat")
def _repeat(ctx, attrs, data):
    return torch.repeat_interleave(data, int(attrs["repeats"]),
                                   dim=attrs.get("axis"))


@register_op("tile")
def _tile(ctx, attrs, data):
    return torch.tile(data, tuple(attrs["reps"]))


@register_op("slice", alias=("crop",))
def _slice(ctx, attrs, data):
    """`crop` is the reference's nnvm twin of slice (matrix_op.cc:139-154)."""
    idx = tuple(slice(b, e) for b, e in zip(attrs["begin"], attrs["end"]))
    return data[idx]


def _crop_region(attrs, shape):
    begin = tuple(int(b) for b in attrs["begin"])
    end = tuple(int(e) for e in attrs["end"])
    return tuple(slice(b, e) for b, e in zip(begin, end)) + tuple(
        slice(None) for _ in range(len(shape) - len(begin)))


@register_op("_crop_assign", inputs=("lhs", "rhs"), alias=("_CropAssign",))
def _crop_assign(ctx, attrs, lhs, rhs):
    """Assign rhs into the [begin, end) region of a copy of lhs (reference:
    matrix_op.cc:155-178); lhs itself is not written."""
    out = lhs.clone()
    out[_crop_region(attrs, lhs.shape)] = rhs
    return out


@register_op("_crop_assign_scalar", inputs=("data",),
             alias=("_CropAssignScalar",))
def _crop_assign_scalar(ctx, attrs, data):
    """Reference: matrix_op.cc:180-203, SimpleCropAssignScalarParam."""
    out = data.clone()
    out[_crop_region(attrs, data.shape)] = float(attrs.get("scalar", 0.0))
    return out


@register_op("slice_axis")
def _slice_axis(ctx, attrs, data):
    axis = int(attrs["axis"])
    begin = int(attrs["begin"])
    end = attrs.get("end")
    end = data.shape[axis] if end is None else int(end)
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register_op("clip")
def _clip(ctx, attrs, data):
    return torch.clamp(data, attrs["a_min"], attrs["a_max"])


@register_op("take", inputs=("a", "indices"))
def _take(ctx, attrs, a, indices):
    return take_fill(a, indices, int(attrs.get("axis", 0)) % a.dim())


@register_op("batch_take", inputs=("a", "indices"))
def _batch_take(ctx, attrs, a, indices):
    """``a[arange(B), indices]`` as the reference indexes: a negative index
    wraps, then every index is clamped into the row."""
    n = a.shape[1]
    idx = as_int32(indices).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    rows = torch.arange(a.shape[0], device=a.device)
    return a[rows, idx]


def _one_hot_f32(indices, depth):
    """``jax.nn.one_hot(indices.astype(int32))``: a NaN index is 0, and an
    index outside [0, depth) gives a zero row."""
    cols = torch.arange(depth, device=indices.device)
    return (as_int32(indices)[..., None] == cols).to(torch.float32)


@register_op("one_hot", inputs=("indices",))
def _one_hot(ctx, attrs, indices):
    depth = int(attrs["depth"])
    on = attrs.get("on_value", 1.0)
    off = attrs.get("off_value", 0.0)
    return (_one_hot_f32(indices, depth) * (on - off) + off).to(
        torch.float32)


@register_op("SwapAxis", alias=("swapaxes",))
def _swapaxis(ctx, attrs, data):
    return data.transpose(int(attrs.get("dim1", 0)),
                          int(attrs.get("dim2", 0)))


@register_op("where", inputs=("condition", "x", "y"))
def _where(ctx, attrs, condition, x, y):
    return torch.where(condition.to(torch.bool), x, y)


@register_op("ElementWiseSum",
             inputs=lambda attrs: [f"arg{i}" for i in range(
                 int(attrs.get("num_args", 1)))],
             alias=("add_n",))
def _ewsum(ctx, attrs, *args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register_op("smooth_l1")
def _smooth_l1(ctx, attrs, data):
    """Reference: src/operator/tensor/elemwise_unary_op.cc smooth_l1."""
    sigma = float(attrs.get("scalar", 1.0))
    s2 = sigma * sigma
    a = torch.abs(data)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * torch.square(data),
                       a - 0.5 / s2)


@register_op("softmax_cross_entropy", inputs=("data", "label"))
def _softmax_xent(ctx, attrs, data, label):
    logp = F.log_softmax(data, dim=-1)
    oh = _one_hot_f32(label, data.shape[-1]).to(logp.dtype)
    return -torch.sum(oh * logp)


@register_op("softmax")
def _softmax(ctx, attrs, data):
    return F.softmax(data, dim=int(attrs.get("axis", -1)))


@register_op("log_softmax")
def _log_softmax(ctx, attrs, data):
    return F.log_softmax(data, dim=int(attrs.get("axis", -1)))


@register_op("_identity_with_attr_like_rhs", inputs=("lhs", "rhs"))
def _identity_attr_like(ctx, attrs, lhs, rhs):
    return lhs


# ---------------------------------------------------------------------------
# init ops (reference: src/operator/tensor/init_op.cc)


@register_op("_zeros", inputs=())
def _zeros_op(ctx, attrs):
    return torch.zeros(tuple(attrs["shape"]), dtype=_dtype(attrs.get("dtype")),
                       device=_out_device(ctx))


@register_op("_ones", inputs=())
def _ones_op(ctx, attrs):
    return torch.ones(tuple(attrs["shape"]), dtype=_dtype(attrs.get("dtype")),
                      device=_out_device(ctx))


def arange(start, stop=None, step=1.0, repeat=1, dtype=None, device=None):
    """``jnp.arange`` (one argument is the stop) with MXNet's ``repeat``."""
    if stop is None:
        start, stop = 0, start
    n = max(0, math.ceil((stop - start) / step))
    out = (start + step * torch.arange(n, dtype=torch.float64,
                                       device=device)).to(_dtype(dtype))
    return torch.repeat_interleave(out, int(repeat)) if repeat != 1 else out


@register_op("_arange", inputs=())
def _arange_op(ctx, attrs):
    return arange(attrs.get("start", 0), attrs.get("stop"),
                  attrs.get("step", 1.0), int(attrs.get("repeat", 1)),
                  attrs.get("dtype"), _out_device(ctx))


@register_op("zeros_like")
def _zeros_like(ctx, attrs, data):
    return torch.zeros_like(data)


@register_op("ones_like")
def _ones_like(ctx, attrs, data):
    return torch.ones_like(data)


# ---------------------------------------------------------------------------
# sampling (reference: src/operator/tensor/sample_op.cc). The reference
# draws from a JAX key; here from a torch.Generator on the output's device.
# The two give different numbers from one seed; the distributions agree.


def op_rng(ctx, device):
    """The generator an op draws from: ``ctx.rng`` when it is a
    ``torch.Generator``; the node's own generator when it is a training
    walk's per-node source (``ctx.rng.node(ctx.node)``, see
    :class:`~mxnet_tpu_torch.executor.NodeRandom`); else the per-device
    generator of :mod:`mxnet_tpu_torch.random`."""
    rng = getattr(ctx, "rng", None)
    if rng is None:
        from .. import random as _random

        return _random.generator(device)
    if isinstance(rng, torch.Generator):
        return rng
    return rng.node(ctx.node)


@register_op("_sample_uniform", inputs=(),
             alias=("uniform", "_random_uniform"))
def _sample_uniform(ctx, attrs):
    device = _out_device(ctx)
    shape = tuple(attrs.get("shape", (1,)))
    low = float(attrs.get("low", 0.0))
    high = float(attrs.get("high", 1.0))
    u = torch.rand(shape, generator=op_rng(ctx, device), device=device,
                   dtype=_dtype(attrs.get("dtype")))
    return low + (high - low) * u


@register_op("_sample_normal", inputs=(), alias=("normal", "_random_normal"))
def _sample_normal(ctx, attrs):
    device = _out_device(ctx)
    shape = tuple(attrs.get("shape", (1,)))
    loc = float(attrs.get("loc", 0.0))
    scale = float(attrs.get("scale", 1.0))
    z = torch.randn(shape, generator=op_rng(ctx, device), device=device,
                    dtype=torch.float32)
    return loc + scale * z


# ---------------------------------------------------------------------------
# fused optimizer update ops (reference: src/operator/optimizer_op.cc). Each
# returns new arrays, as the reference's functional bodies do: the caller's
# weight and state are not written. The sgd ops clip before adding wd*w;
# adam and rmsprop add wd*w before they clip, as in the reference.


def _clip_grad(g, clip):
    if clip is not None and clip > 0:
        g = torch.clamp(g, -clip, clip)
    return g


@register_op("sgd_update", inputs=("weight", "grad"))
def _sgd_update(ctx, attrs, weight, grad):
    lr = float(attrs["lr"])
    wd = float(attrs.get("wd", 0.0))
    rescale = float(attrs.get("rescale_grad", 1.0))
    g = _clip_grad(grad * rescale, attrs.get("clip_gradient", -1.0))
    return weight - lr * (g + wd * weight)


@register_op("sgd_mom_update", inputs=("weight", "grad", "mom"),
             num_outputs=2)
def _sgd_mom_update(ctx, attrs, weight, grad, mom):
    lr = float(attrs["lr"])
    momentum = float(attrs.get("momentum", 0.0))
    wd = float(attrs.get("wd", 0.0))
    rescale = float(attrs.get("rescale_grad", 1.0))
    g = _clip_grad(grad * rescale, attrs.get("clip_gradient", -1.0))
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom


@register_op("adam_update", inputs=("weight", "grad", "mean", "var"),
             num_outputs=3)
def _adam_update(ctx, attrs, weight, grad, mean, var):
    lr = float(attrs["lr"])
    beta1 = float(attrs.get("beta1", 0.9))
    beta2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-8))
    wd = float(attrs.get("wd", 0.0))
    rescale = float(attrs.get("rescale_grad", 1.0))
    g = _clip_grad(grad * rescale + wd * weight,
                   attrs.get("clip_gradient", -1.0))
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    return (weight - lr * new_mean / (torch.sqrt(new_var) + eps), new_mean,
            new_var)


@register_op("rmsprop_update", inputs=("weight", "grad", "n"), num_outputs=2)
def _rmsprop_update(ctx, attrs, weight, grad, n):
    lr = float(attrs["lr"])
    gamma1 = float(attrs.get("gamma1", 0.95))
    eps = float(attrs.get("epsilon", 1e-8))
    wd = float(attrs.get("wd", 0.0))
    rescale = float(attrs.get("rescale_grad", 1.0))
    g = _clip_grad(grad * rescale + wd * weight,
                   attrs.get("clip_gradient", -1.0))
    new_n = (1 - gamma1) * torch.square(g) + gamma1 * n
    return weight - lr * g / torch.sqrt(new_n + eps), new_n

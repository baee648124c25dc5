"""Custom Python operators (reference: mxnet_tpu/operator.py CustomOp,
CustomOpProp, register and the ``Custom`` op; python/mxnet/operator.py:396,
442 and src/operator/custom.cc).

A user subclasses :class:`CustomOpProp` to declare the op's arguments,
outputs and shapes, registers it under a name, and calls
``mx.nd.Custom(..., op_type=name)`` or builds ``mx.sym.Custom`` into a graph
that an ``Executor`` or ``Predictor`` runs. The JAX package calls the body
back on the host through ``jax.pure_callback``; here the body runs on the
tensors' own device, so a :class:`CustomOp.forward` may launch a
runtime-compiled kernel (:mod:`mxnet_tpu_torch.rtc`) on the card. Shape
inference builds no operator: it takes the shapes from ``infer_shape``.

In a training graph the op is a ``torch.autograd.Function`` whose backward
is the reference's ``custom_vjp`` backward: a fresh operator runs the
forward again with ``is_train=True``, then ``CustomOp.backward`` with
``req="write"`` for every input, the head gradients as ``out_grad`` (zeros
for an output nothing reads), the inputs and the recomputed outputs, and
zero ``in_grad`` arrays, all NDArrays on the inputs' device. As in the
reference, every head gradient, input and output is passed whatever
``need_top_grad`` says (the reference has no
``declare_backward_dependency``). The legacy ``PythonOp``/``NumpyOp``/
``NDArrayOp`` are not ported yet.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .ndarray import NDArray
from .ops.registry import register_op

__all__ = ["CustomOp", "CustomOpProp", "register", "get_registered"]

_CUSTOM_PROPS: dict = {}


class CustomOp:
    """Base class for custom operator bodies (reference: operator.py:396)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` under OpReqType semantics (reference:
        operator.py assign)."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src


class CustomOpProp:
    """Declares a custom op's interface (reference: operator.py:442)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a CustomOpProp subclass under a name (reference:
    operator.py register)."""

    def do_register(prop_cls):
        _CUSTOM_PROPS[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_registered(name):
    if name not in _CUSTOM_PROPS:
        raise MXNetError(f"custom op '{name}' is not registered")
    return _CUSTOM_PROPS[name]


def _make_prop(attrs):
    kwargs = {k: str(v) for k, v in attrs.items()
              if k != "op_type" and not k.startswith("__")}
    prop_cls = get_registered(attrs["op_type"])
    try:
        return prop_cls(**kwargs)
    except TypeError:
        return prop_cls()


def _custom_inputs(attrs):
    return list(_make_prop(attrs).list_arguments())


def _custom_num_outputs(attrs):
    return len(_make_prop(attrs).list_outputs())


def _custom_infer(attrs, shapes):
    prop = _make_prop(attrs)
    names = prop.list_arguments()
    in_shapes = [shapes.get(n) for n in names]
    if any(s is None for s in in_shapes):
        return shapes
    in_shapes2, _, _ = prop.infer_shape([list(s) for s in in_shapes])
    for n, s in zip(names, in_shapes2):
        shapes.setdefault(n, tuple(s))
    return shapes


def _run_forward(prop, inputs, is_train):
    """A fresh operator's forward on ``inputs``; returns the operator and
    the output tensors (the first input's dtype, as in the reference)."""
    from .context import context_of

    in_shapes = [list(x.shape) for x in inputs]
    in_dtypes = [x.dtype for x in inputs]
    _, out_shapes, _ = prop.infer_shape(in_shapes)
    device, dtype = inputs[0].device, in_dtypes[0]
    op = prop.create_operator(context_of(device), in_shapes, in_dtypes)
    out_nd = [NDArray(torch.zeros(tuple(s), dtype=dtype, device=device))
              for s in out_shapes]
    op.forward(is_train=is_train, req=["write"] * len(out_nd),
               in_data=[NDArray(x) for x in inputs], out_data=out_nd, aux=[])
    return op, [o.data for o in out_nd]


class _CustomFunction(torch.autograd.Function):
    """The reference's ``custom_vjp`` pair around the user's op."""

    @staticmethod
    def forward(ctx, prop, is_train, *inputs):
        ctx.prop = prop
        ctx.save_for_backward(*inputs)
        _, outs = _run_forward(prop, inputs, is_train)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *out_grads):
        inputs = ctx.saved_tensors
        op, outs = _run_forward(ctx.prop, inputs, True)
        heads = [NDArray(g if g is not None else torch.zeros_like(o))
                 for g, o in zip(out_grads, outs)]
        in_grad = [NDArray(torch.zeros_like(x)) for x in inputs]
        op.backward(req=["write"] * len(inputs), out_grad=heads,
                    in_data=[NDArray(x) for x in inputs],
                    out_data=[NDArray(o) for o in outs],
                    in_grad=in_grad, aux=[])
        grads = [g.data.to(x.dtype) if x.is_floating_point() else None
                 for g, x in zip(in_grad, inputs)]
        return (None, None, *grads)


@register_op("Custom", inputs=_custom_inputs, num_outputs=_custom_num_outputs,
             infer_param_shapes=_custom_infer)
def _custom(ctx, attrs, *inputs):
    """Run a registered CustomOp on the inputs' device, differentiable
    through its ``backward`` (module docstring)."""
    prop = _make_prop(attrs)
    n_out = len(prop.list_outputs())
    if inputs[0].device.type == "meta":
        _, out_shapes, _ = prop.infer_shape([list(x.shape) for x in inputs])
        outs = [torch.empty(tuple(s), dtype=inputs[0].dtype, device="meta")
                for s in out_shapes]
    else:
        outs = list(_CustomFunction.apply(prop, ctx.is_train, *inputs))
    return outs if n_out > 1 else outs[0]

"""Custom Python operators, forward (reference: mxnet_tpu/operator.py
CustomOp, CustomOpProp, register and the ``Custom`` op; python/mxnet/
operator.py:396,442 and src/operator/custom.cc).

A user subclasses :class:`CustomOpProp` to declare the op's arguments,
outputs and shapes, registers it under a name, and calls
``mx.nd.Custom(..., op_type=name)`` or builds ``mx.sym.Custom`` into a graph
that an ``Executor`` or ``Predictor`` runs. The JAX package calls the body
back on the host through ``jax.pure_callback``; here the body runs on the
tensors' own device, so a :class:`CustomOp.forward` may launch a
runtime-compiled kernel (:mod:`mxnet_tpu_torch.rtc`) on the card. Shape
inference builds no operator: it takes the shapes from ``infer_shape``. The
backward and the legacy ``PythonOp``/``NumpyOp``/``NDArrayOp`` wait for the
training slice.
"""
from __future__ import annotations

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


@register_op("Custom", inputs=_custom_inputs, num_outputs=_custom_num_outputs,
             infer_param_shapes=_custom_infer)
def _custom(ctx, attrs, *inputs):
    """Run a registered CustomOp's forward on the inputs' device. Outputs
    take the first input's dtype, as in the reference."""
    import torch

    from .context import context_of

    prop = _make_prop(attrs)
    n_out = len(prop.list_outputs())
    in_shapes = [list(x.shape) for x in inputs]
    in_dtypes = [x.dtype for x in inputs]
    _, out_shapes, _ = prop.infer_shape(in_shapes)
    device, dtype = inputs[0].device, in_dtypes[0]
    if device.type == "meta":
        outs = [torch.empty(tuple(s), dtype=dtype, device=device)
                for s in out_shapes]
    else:
        op = prop.create_operator(context_of(device), in_shapes, in_dtypes)
        out_nd = [NDArray(torch.zeros(tuple(s), dtype=dtype, device=device))
                  for s in out_shapes]
        op.forward(is_train=ctx.is_train, req=["write"] * n_out,
                   in_data=[NDArray(x) for x in inputs], out_data=out_nd,
                   aux=[])
        outs = [o.data for o in out_nd]
    return outs if n_out > 1 else outs[0]

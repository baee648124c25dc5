"""Operator package: registry plus imperative invocation.

Importing this package registers the ops ported so far (reference:
mxnet_tpu/ops). The imperative path (``mx.nd.<op>``) mirrors the reference's
MXImperativeInvoke (src/c_api/c_api_ndarray.cc:19): resolve the op, split the
call's arguments into tensor inputs and attributes, run the body eagerly on
the inputs' device, wrap the outputs as NDArrays.
"""
from __future__ import annotations

from ..base import MXNetError
from .registry import OpCtx, coerce_attrs, get_op, list_ops, register_op

from . import tensor as _tensor  # noqa: F401  (registration side effects)
from . import nn as _nn  # noqa: F401
from . import attention as _attention  # noqa: F401
from . import fused_ce as _fused_ce  # noqa: F401
from . import rnn_op as _rnn_op  # noqa: F401
from . import contrib_det as _contrib_det  # noqa: F401
from . import rcnn as _rcnn  # noqa: F401
from . import vision as _vision  # noqa: F401
from . import transformer_stack as _transformer_stack  # noqa: F401
from . import generate_scan as _generate_scan  # noqa: F401

__all__ = ["OpCtx", "coerce_attrs", "get_op", "list_ops", "register_op",
           "imperative_invoke", "make_imperative_namespace"]


def imperative_invoke(op_name, *args, is_train=False, ctx=None, **kwargs):
    """Call an operator eagerly on NDArrays (reference: c_api_ndarray.cc:19).

    Positional NDArrays and NDArray keyword arguments are the inputs; every
    other keyword is an attribute. Outputs lie on the first input's device.
    An op with no inputs (``_zeros``, ``_sample_uniform``, ...) creates its
    result on ``ctx``, by default the current context (the card). Ops with
    aux states take them appended to the inputs and write the new values
    back into those NDArrays."""
    from ..context import current_context
    from ..ndarray import NDArray

    op = get_op(op_name)
    tensor_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, NDArray)}
    attrs = coerce_attrs({k: v for k, v in kwargs.items()
                          if not isinstance(v, NDArray) and k != "name"})
    for k, v in op.attr_defaults.items():
        attrs.setdefault(k, v)
    names = op.input_names(attrs)
    inputs = list(args)
    if tensor_kwargs:
        by_name = dict(zip(names, inputs))
        for k, v in tensor_kwargs.items():
            if k in by_name:
                raise MXNetError(f"{op_name}: input '{k}' given twice")
            by_name[k] = v
        try:
            inputs = [by_name[n] for n in names if n in by_name]
        except KeyError as e:
            raise MXNetError(f"{op_name}: missing input {e}")
    for a in inputs:
        if not isinstance(a, NDArray):
            raise MXNetError(f"{op_name}: inputs must be NDArrays, got "
                             f"{type(a).__name__}")
    if inputs:
        device = inputs[0].data.device
    else:
        device = (ctx if ctx is not None else current_context()).torch_device
    n_aux = len(op.aux_names(attrs))
    tensors = [a.data for a in inputs]
    if n_aux:
        ins, aux = tensors[:len(names)], tensors[len(names):]
        if len(aux) != n_aux:
            raise MXNetError(
                f"{op_name}: imperative call needs {n_aux} aux arrays appended")
    else:
        ins, aux = tensors, []
    outs, new_aux = op.normalized_call(
        OpCtx(is_train=is_train, device=device), attrs, ins, aux)
    # imperative aux semantics: write back into the passed aux NDArrays
    for holder, new in zip(inputs[len(names):], new_aux):
        holder._data = new
    wrapped = [NDArray(o) for o in outs]
    return wrapped[0] if len(wrapped) == 1 else wrapped


def _op_doc(name):
    """The op body's docstring (the role of the reference's generated
    operator docs, python/mxnet/ndarray_doc.py)."""
    import inspect

    return inspect.getdoc(get_op(name).fn) or ""


def make_imperative_namespace(namespace: dict):
    """Populate a module dict with one eager function per registered op
    (role of ``_init_ndarray_module``, python/mxnet/base.py). Names the
    module already has are kept."""
    for name in list_ops():
        if name in namespace:
            continue

        def _fn(*args, _op_name=name, **kwargs):
            return imperative_invoke(_op_name, *args, **kwargs)

        _fn.__name__ = name
        body_doc = _op_doc(name)
        _fn.__doc__ = (f"Imperative wrapper for operator '{name}'."
                       + (f"\n\n{body_doc}" if body_doc else ""))
        namespace[name] = _fn

"""Self-contained inference API (reference: mxnet_tpu/predictor.py; the C
predict API's MXPredCreate/SetInput/Forward/GetOutput).

Load a symbol JSON and a params blob, bind a forward-only executor on a
device, feed inputs, read outputs. The device is ``gpu(0)`` unless the caller
passes ``ctx=mx.cpu()``. Loss-layer labels are bound as zeros; their shape
must be inferable, so for a graph that reshapes its label (the transformer
LM's ``Reshape(softmax_label, shape=(-1,))``) pass ``softmax_label`` in
``input_shapes``.
"""
from __future__ import annotations

import numpy as np

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError
from .context import Context, cpu, current_context
from .convert import split_params

__all__ = ["Predictor"]


class Predictor:
    def __init__(self, symbol_json_or_file, param_bytes_or_file, input_shapes,
                 ctx: Context | None = None):
        # read to the host; _setup places each parameter on ctx once
        if isinstance(param_bytes_or_file, (bytes, bytearray)):
            saved = nd.load_frombuffer(param_bytes_or_file, cpu())
        else:
            saved = nd.load(param_bytes_or_file, cpu())
        arg_params, aux_params = split_params(saved)
        self._setup(symbol_json_or_file, arg_params, aux_params, input_shapes,
                    ctx)

    @classmethod
    def from_arrays(cls, symbol, arg_params, aux_params, input_shapes,
                    ctx: Context | None = None):
        """Build a Predictor from an in-memory symbol and parameter dicts
        (numpy arrays or NDArrays), with no bytes round trip."""
        self = cls.__new__(cls)
        self._setup(symbol, arg_params or {}, aux_params or {}, input_shapes,
                    ctx)
        return self

    def _setup(self, symbol, arg_params, aux_params, input_shapes, ctx):
        self._ctx = ctx if ctx is not None else current_context()
        if isinstance(symbol, str):
            self._symbol = sym.load_json(symbol) \
                if symbol.lstrip().startswith("{") else sym.load(symbol)
        else:
            self._symbol = symbol

        def place(v):
            arr = v if isinstance(v, nd.NDArray) else nd.array(v, self._ctx)
            return arr.as_in_context(self._ctx)

        # params live on ctx once; every bind_forward shares them
        self._arg_params = {k: place(v) for k, v in arg_params.items()}
        self._aux_params = {k: place(v) for k, v in aux_params.items()}
        self._input_shapes = {k: tuple(v) for k, v in input_shapes.items()}
        self._executor, self._out_shapes = self.bind_forward(input_shapes)

    def bind_forward(self, input_shapes):
        """Bind a forward-only executor for ``input_shapes``, sharing this
        predictor's parameter and aux arrays; returns ``(executor,
        out_shapes)``."""
        ctx = self._ctx
        arg_shapes, out_shapes, aux_shapes = self._symbol.infer_shape(
            **input_shapes)
        args = {}
        for name, shape in zip(self._symbol.list_arguments(), arg_shapes):
            if name in input_shapes:
                args[name] = nd.zeros(input_shapes[name], ctx)
            elif name in self._arg_params:
                if self._arg_params[name].shape != tuple(shape):
                    raise MXNetError(
                        f"param {name}: saved shape "
                        f"{self._arg_params[name].shape} != expected {shape}")
                args[name] = self._arg_params[name]
            elif name.endswith("label") and shape is not None:
                # loss-layer labels are unused at inference; bind zeros
                args[name] = nd.zeros(shape, ctx)
            else:
                raise MXNetError(f"missing parameter {name}")
        auxs = {}
        for name, shape in zip(self._symbol.list_auxiliary_states(),
                               aux_shapes):
            auxs[name] = self._aux_params[name] if name in self._aux_params \
                else nd.zeros(shape, ctx)
        return self._symbol.bind(ctx, args, aux_states=auxs), out_shapes

    def set_input(self, name, data):
        """MXPredSetInput: ``data`` read as float32 and written into the
        bound input in place (broadcast to its shape, in its dtype), so the
        captured forward keeps reading the same memory."""
        import torch

        if name not in self._executor.arg_dict:
            raise MXNetError(f"unknown input {name}")
        holder = self._executor.arg_dict[name]
        src = torch.from_numpy(np.ascontiguousarray(
            np.asarray(data, np.float32)))
        holder._check_writable("write to")
        holder.data.copy_(src.expand(holder.shape))

    def forward(self, **inputs):
        """MXPredForward."""
        for k, v in inputs.items():
            self.set_input(k, v)
        self._executor.forward(is_train=False)
        return self

    def get_output(self, index=0):
        """MXPredGetOutput, as a numpy array."""
        return self.get_output_nd(index).asnumpy()

    def get_output_nd(self, index=0):
        """Output ``index`` as an NDArray on the predictor's device, with no
        host copy."""
        if not self._executor.outputs:
            raise MXNetError("get_output: no completed forward pass yet — "
                             "call forward() first")
        return self._executor.outputs[index]

    @property
    def output_shapes(self):
        return self._out_shapes

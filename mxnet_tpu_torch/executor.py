"""Executor: binds a Symbol to a device and evaluates it (reference:
mxnet_tpu/executor.py, the forward part).

The reference lowers the whole graph to one jitted XLA program. PyTorch runs
eagerly, so ``forward`` walks the graph in topological order and calls each
op body on the bound tensors under ``torch.inference_mode()``; the op bodies
launch their kernels on the current CUDA stream. The reference's graph
rewrites at bind (graphopt) do not change fp32 math and are not ported;
backward and the fused training step wait for the training slice.

``amp_dtype`` (e.g. ``"bfloat16"``) is the reference's mixed precision: the
bound fp32 arrays stay fp32 master copies, and each ``forward`` casts them
to the compute dtype as they enter the graph walk (:func:`_amp_cast`).
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError
from .ndarray import _torch_dtype
from .ops import OpCtx, get_op

__all__ = ["Executor"]


def _amp_cast(name, v, amp_dtype):
    """The reference's argument cast under mixed precision
    (mxnet_tpu/executor.py ``_amp_cast``): labels pass through; uint8
    (raw image pixels) goes to the compute dtype, float32 without amp;
    without amp nothing else changes; float32 goes to ``amp_dtype``; every
    other dtype (int32 token ids among them) passes through."""
    import torch

    if name.endswith("label"):
        return v
    if v.dtype == torch.uint8:
        return v.to(amp_dtype or torch.float32)
    if amp_dtype is None:
        return v
    if v.dtype == torch.float32:
        return v.to(amp_dtype)
    return v


# the dtypes jax.numpy makes of numpy's 64-bit ones (64-bit mode off)
_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _fed_tensor(v, device):
    """A fed array (NDArray, or array-like read with ``np.asarray``, 64-bit
    types narrowed as jax.numpy does) as a tensor on ``device``, with its
    own dtype and shape."""
    import torch

    from .ndarray import NDArray

    if isinstance(v, NDArray):
        return v.data.to(device)
    a = np.asarray(v)
    a = a.astype(_CANONICAL.get(a.dtype, a.dtype), copy=False)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


class Executor:
    def __init__(self, symbol, ctx, args, aux_states=None, amp_dtype=None):
        self._symbol = symbol
        self._ctx = ctx
        self._amp_dtype = None if amp_dtype is None \
            else _torch_dtype(amp_dtype)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_dict = self._normalize(args, self.arg_names, "args")
        self.aux_dict = self._normalize(aux_states or [], self.aux_names,
                                        "aux_states")
        self._entries = symbol._entries()
        self._topo = symbol._nodes()
        self.outputs: list = []

    @staticmethod
    def _normalize(arrays, names, what):
        if isinstance(arrays, dict):
            missing = [n for n in names if n not in arrays]
            if missing:
                raise MXNetError(f"{what}: missing arrays for {missing}")
            return {n: arrays[n] for n in names}
        arrays = list(arrays)
        if len(arrays) != len(names):
            raise MXNetError(f"{what}: expected {len(names)} arrays "
                             f"({names}), got {len(arrays)}")
        return dict(zip(names, arrays))

    def forward(self, is_train=False, **kwargs):
        """Evaluate the graph; each of ``kwargs`` rebinds its bound argument
        first, as in the reference: the bound NDArray now holds the fed
        array, with the feed's dtype and shape, on the executor's device.
        Returns the output NDArrays."""
        import torch

        from .ndarray import NDArray

        if is_train:
            raise MXNetError("forward(is_train=True): training is not yet "
                             "ported")
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {k}")
            self.arg_dict[k]._data = _fed_tensor(v, self._ctx.torch_device)
        op_ctx = OpCtx(is_train=False, device=self._ctx.torch_device)
        vals = {}
        with torch.inference_mode():
            for node in self._topo:
                if node.is_variable:
                    if node.name in self.arg_dict:
                        vals[(id(node), 0)] = _amp_cast(
                            node.name, self.arg_dict[node.name].data,
                            self._amp_dtype)
                    elif node.name in self.aux_dict:
                        vals[(id(node), 0)] = self.aux_dict[node.name].data
                    else:
                        raise MXNetError(f"unbound variable '{node.name}'")
                    continue
                op = get_op(node.op)
                ins = [vals[(id(n), i)] for n, i in node.inputs]
                aux = [vals[(id(a), 0)] for a in node.aux_vars]
                outs, _ = op.normalized_call(op_ctx, node.attrs, ins, aux)
                for i, o in enumerate(outs):
                    vals[(id(node), i)] = o
        self.outputs = [NDArray(vals[(id(n), i)]) for n, i in self._entries]
        return self.outputs

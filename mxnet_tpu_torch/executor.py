"""Executor: binds a Symbol to a device and evaluates it (reference:
mxnet_tpu/executor.py, the forward part).

The reference lowers the whole graph to one jitted XLA program. PyTorch runs
eagerly, so ``forward`` walks the graph in topological order and calls each
op body on the bound tensors under ``torch.inference_mode()``; the op bodies
launch their kernels on the current CUDA stream. The reference's graph
rewrites at bind (graphopt) do not change fp32 math and are not ported;
backward and the fused training step wait for the training slice.
"""
from __future__ import annotations

from .base import MXNetError
from .ops import OpCtx, get_op

__all__ = ["Executor"]


class Executor:
    def __init__(self, symbol, ctx, args, aux_states=None):
        self._symbol = symbol
        self._ctx = ctx
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
        """Evaluate the graph; ``kwargs`` are written into the bound
        arguments first. Returns the output NDArrays."""
        import torch

        from .ndarray import NDArray

        if is_train:
            raise MXNetError("forward(is_train=True): training is not yet "
                             "ported")
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {k}")
            self.arg_dict[k][:] = v
        op_ctx = OpCtx(is_train=False, device=self._ctx.torch_device)
        vals = {}
        with torch.inference_mode():
            for node in self._topo:
                if node.is_variable:
                    holder = self.arg_dict.get(node.name)
                    if holder is None:
                        holder = self.aux_dict.get(node.name)
                    if holder is None:
                        raise MXNetError(f"unbound variable '{node.name}'")
                    vals[(id(node), 0)] = holder.data
                    continue
                op = get_op(node.op)
                ins = [vals[(id(n), i)] for n, i in node.inputs]
                aux = [vals[(id(a), 0)] for a in node.aux_vars]
                outs, _ = op.normalized_call(op_ctx, node.attrs, ins, aux)
                for i, o in enumerate(outs):
                    vals[(id(node), i)] = o
        self.outputs = [NDArray(vals[(id(n), i)]) for n, i in self._entries]
        return self.outputs

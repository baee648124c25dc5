"""The executor group of a Module (reference:
mxnet_tpu/module/executor_group.py), on one device.

One executor, bound with a grad array for each argument whose gradient is
asked for. Its ``arg_dict`` NDArrays are the ones ``Module.update`` hands the
optimizer, so the next ``forward`` reads the updated weights. A batch's
arrays are copied into the bound input arrays in place (one that changes
shape or dtype rebinds its input), so a captured step keeps reading the
same memory. With ``shared_group`` (a bucket of a
``BucketingModule``) every argument, gradient and aux array whose name and
shape match the shared group's is that group's NDArray object, so the
buckets read and update one set of parameters and nothing is copied.
Data-parallel groups over several devices wait for the multi-device work.
"""
from __future__ import annotations

from ..base import MXNetError
from ..context import cpu
from ..executor import Executor, _fed_tensor, _write_into
from ..io import DataDesc
from ..ndarray import NDArray, zeros

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=None, grad_req="write", amp=None,
                 shared_group=None):
        if len(contexts) != 1:
            raise MXNetError(f"Module on {len(contexts)} devices: only one "
                             "device is ported")
        self.symbol = symbol
        self.contexts = list(contexts)
        self.param_names = list(param_names)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])

        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                            for d in data_shapes]
        self.label_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in label_shapes or []]
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [d.name for d in self.label_shapes]

        # grad_req per argument (reference: executor_group.py)
        self.grad_req = {n: "null" for n in self.arg_names}
        if for_training:
            for n in self.arg_names:
                if n in self.param_names and n not in self.fixed_param_names:
                    self.grad_req[n] = grad_req
                elif n in self.data_names and inputs_need_grad:
                    self.grad_req[n] = grad_req

        shapes = {d.name: d.shape
                  for d in self.data_shapes + self.label_shapes}
        if self.data_shapes:
            # the batch of partial shapes (RNN begin states) is on the
            # layout's N axis, not always the first
            d0 = self.data_shapes[0]
            shapes["__batch_size__"] = (
                d0.shape[DataDesc.get_batch_axis(d0.layout)],)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        missing = [n for n, s in zip(self.arg_names, arg_shapes) if s is None]
        if missing:
            raise MXNetError(f"cannot infer shapes for arguments {missing}")
        shared = shared_group._executor if shared_group is not None else None

        def _array(name, shape, kind):
            got = getattr(shared, kind).get(name) if shared else None
            if got is not None and got.shape == tuple(shape):
                return got
            return zeros(shape, self.contexts[0])

        args = {n: _array(n, s, "arg_dict")
                for n, s in zip(self.arg_names, arg_shapes)}
        grads = {n: _array(n, s, "grad_dict")
                 for n, s in zip(self.arg_names, arg_shapes)
                 if self.grad_req[n] != "null"}
        auxs = {n: _array(n, s, "aux_dict")
                for n, s in zip(self.aux_names, aux_shapes)}
        self._executor = Executor(symbol, self.contexts[0], args, grads,
                                  self.grad_req, auxs, amp_dtype=amp)
        self.execs = [self._executor]
        d0 = self.data_shapes[0] if self.data_shapes else None
        self.batch_size = d0.shape[DataDesc.get_batch_axis(d0.layout)] \
            if d0 is not None else 0

    # -- parameters -------------------------------------------------------------
    def set_params(self, arg_params, aux_params):
        """Copy parameters into the bound arrays (each gets its own copy)."""
        self._executor.copy_params_from(arg_params, aux_params,
                                        allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        """Snapshot the bound parameters into the caller's dicts."""
        ex = self._executor
        for name in self.param_names:
            if name in ex.arg_dict:
                arg_params[name] = ex.arg_dict[name].copy()
        for name in self.aux_names:
            aux_params[name] = ex.aux_dict[name].copy()

    # -- execution ---------------------------------------------------------------
    def _load_into(self, names, arrays):
        """Write each named argument's batch array into its bound array on
        the device (:func:`~mxnet_tpu_torch.executor._write_into`: in place
        where shape and dtype agree, else a rebind to a copy of its own)."""
        ex = self._executor
        device = self.contexts[0].torch_device
        for name, src in zip(names, arrays):
            if name not in ex.arg_dict:
                continue
            holder = ex.arg_dict[name]
            if isinstance(src, NDArray) and src.shape == holder.shape \
                    and src.dtype == holder.dtype:
                holder.data.copy_(src.data)
                continue
            t = _fed_tensor(src, device)
            if isinstance(src, NDArray) and t is src.data:
                t = t.clone()
            _write_into(holder, t)

    def stage_batch(self, data_batch, ring=None):
        """Place a batch's arrays on this group's device without binding
        them (reference: executor_group.py ``stage_batch``): each source
        NDArray is rebound to its device tensor, so a later ``forward`` of
        the batch finds it in place. With a :class:`~mxnet_tpu_torch.io.
        PinnedRing` the copies go through pinned memory on its side stream;
        returns the bytes staged and the ring's event (None without a
        ring)."""
        device = self.contexts[0].torch_device
        arrays = [a for names, arrays in (
            (self.data_names, data_batch.data or []),
            (self.label_names, data_batch.label or []))
            for _, a in zip(names, arrays)]
        if ring is None:
            staged = [_fed_tensor(a, device) for a in arrays]
            event = None
        else:
            staged, event = ring.stage(
                [_fed_tensor(a, cpu().torch_device) for a in arrays])
        for src, t in zip(arrays, staged):
            if isinstance(src, NDArray):
                src._data = t
        return sum(t.numel() * t.element_size() for t in staged), event

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self._load_into(self.data_names, data_batch.data)
        if self.label_names and data_batch.label:
            self._load_into(self.label_names, data_batch.label)
        self._executor.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run backward")
        self._executor.backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        return list(self._executor.outputs)

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def get_input_grads(self, merge_multi_context=True):
        return [self._executor.grad_dict.get(n) for n in self.data_names]

    def get_grads(self):
        """The gradient arrays of the parameters, by name; raises when the
        fused step elided them."""
        ex = self._executor
        if ex._grads_were_elided:
            raise MXNetError(
                "gradients were not materialized: the fused train step "
                "returns no gradients unless a reader is declared. The step "
                "reads its flags when built, so set MXTPU_FUSED_GRADS=1 (or "
                "MXTPU_NO_FUSED_STEP=1) before init_optimizer, or set it and "
                "run bind(force_rebind=True) and init_optimizer again")
        return {n: ex.grad_dict[n] for n in self.param_names
                if n in ex.grad_dict}

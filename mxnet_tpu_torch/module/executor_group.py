"""The executor group of a Module (reference:
mxnet_tpu/module/executor_group.py): one executor a context.

Each executor (a replica) is bound on its context to its slice of the batch
(:func:`decide_slices`: an even split along each input's batch axis), with
its own copy of the parameters, the same on every replica, and a grad array
for each argument whose gradient is asked for. A batch's arrays are copied
into the bound input arrays in place (one that changes shape or dtype
rebinds its input), so a captured step keeps reading the same memory.

One context is the fused step's and the captured forward's group: its
executor's ``arg_dict`` NDArrays are the ones ``Module.update`` hands the
optimizer. Over several contexts (``cpu(i)`` contexts are distinct contexts
on the one torch CPU device) a training forward walks the replicas in
lockstep (:func:`~mxnet_tpu_torch.executor.train_replicas`), so BatchNorm
trains on the global batch's statistics and a loss's ``batch``/``valid``
normalisation divides by global counts, as the reference's one program over
a mesh does; :meth:`get_grads` sums each parameter's gradients across the
replicas, ``Module.update`` updates the first replica's parameters and
:meth:`scatter_params` copies them to the others (or a kvstore sums the
replicas' gradients and the first replica pulls the weights). A parameter
whose shape holds the batch (the LSTM's free begin states) is split over the
replicas like the batch. Outputs and input gradients merge along the batch
axis. An evaluation forward runs each replica's own (captured) forward.

With ``shared_group`` (a bucket of a ``BucketingModule``) every argument,
gradient and aux array whose name and shape match the shared group's
replica is that replica's NDArray object, so the buckets read and update
one set of parameters and nothing is copied.
"""
from __future__ import annotations

from ..base import MXNetError
from ..context import cpu
from ..executor import (Executor, _as_tensor, _fed_tensor, _write_into,
                        rerun_replicas, train_replicas)
from ..io import DataDesc
from ..ndarray import NDArray, zeros

__all__ = ["DataParallelExecutorGroup", "decide_slices"]


def _batch_axis(desc):
    return max(DataDesc.get_batch_axis(getattr(desc, "layout", None)), 0)


def decide_slices(data_shapes, contexts, workload=None):
    """The slice of the batch each context takes (reference:
    executor_group.py ``decide_slices``): an even split of the first input's
    batch axis; ``workload`` is accepted and, as in the reference, not
    read. Raises when the batch does not divide evenly."""
    n = len(contexts)
    slices = []
    for desc in data_shapes:
        desc = desc if isinstance(desc, DataDesc) else DataDesc(*desc)
        batch = desc.shape[_batch_axis(desc)]
        if batch % n != 0:
            raise MXNetError(
                f"batch size {batch} not divisible by #devices {n}")
        step = batch // n
        slices.append([slice(i * step, (i + 1) * step) for i in range(n)])
    return slices[0] if slices else []


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=None, grad_req="write", amp=None,
                 shared_group=None, workload=None):
        self.symbol = symbol
        self.contexts = list(contexts)
        for i, c in enumerate(self.contexts):
            if c in self.contexts[:i]:
                raise MXNetError(f"duplicate device for context {c}")
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
        self.slices = decide_slices(self.data_shapes, self.contexts, workload)
        self._input_axes = {d.name: _batch_axis(d)
                            for d in self.data_shapes + self.label_shapes}

        # grad_req per argument (reference: executor_group.py)
        self.grad_req = {n: "null" for n in self.arg_names}
        if for_training:
            for n in self.arg_names:
                if n in self.param_names and n not in self.fixed_param_names:
                    self.grad_req[n] = grad_req
                elif n in self.data_names and inputs_need_grad:
                    self.grad_req[n] = grad_req
        if shared_group is not None \
                and len(shared_group.execs) != len(self.contexts):
            raise MXNetError("shared_group has another number of contexts")
        d0 = self.data_shapes[0] if self.data_shapes else None
        self.batch_size = d0.shape[_batch_axis(d0)] if d0 is not None else 0
        self.execs = [
            self._bind(r, amp, shared_group.execs[r] if shared_group else None)
            for r in range(len(self.contexts))]
        self._executor = self.execs[0]
        self.arg_shapes = {n: a.shape
                           for n, a in self._executor.arg_dict.items()}
        self._output_axes = None
        self._split = {}
        if len(self.execs) > 1:
            self._find_batch_axes()

    def _local_shapes(self, r):
        """Each input's shape on replica ``r``: its batch axis cut to the
        replica's slice."""
        n = len(self.contexts)
        shapes = {}
        for d in self.data_shapes + self.label_shapes:
            s = list(d.shape)
            axis = self._input_axes[d.name]
            if n > 1 and axis < len(s):
                s[axis] //= n
            shapes[d.name] = tuple(s)
        if self.data_shapes:
            # the batch of partial shapes (RNN begin states) is on the
            # layout's N axis, not always the first
            d0 = self.data_shapes[0]
            shapes["__batch_size__"] = (
                shapes[d0.name][self._input_axes[d0.name]],)
        return shapes

    def _bind(self, r, amp, shared):
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(
            **self._local_shapes(r))
        missing = [n for n, s in zip(self.arg_names, arg_shapes) if s is None]
        if missing:
            raise MXNetError(f"cannot infer shapes for arguments {missing}")
        ctx = self.contexts[r]

        def _array(name, shape, kind):
            got = getattr(shared, kind).get(name) if shared else None
            if got is not None and got.shape == tuple(shape):
                return got
            return zeros(shape, ctx)

        args = {n: _array(n, s, "arg_dict")
                for n, s in zip(self.arg_names, arg_shapes)}
        grads = {n: _array(n, s, "grad_dict")
                 for n, s in zip(self.arg_names, arg_shapes)
                 if self.grad_req[n] != "null"}
        auxs = {n: _array(n, s, "aux_dict")
                for n, s in zip(self.aux_names, aux_shapes)}
        return Executor(self.symbol, ctx, args, grads, self.grad_req, auxs,
                        amp_dtype=amp)

    def _find_batch_axes(self):
        """The batch axis of each output and of each parameter that has one
        (the LSTM's free begin states): the axis where its shape over the
        global batch is the replicas' count times its shape on one replica.
        Such a parameter is split over the replicas like the batch; an
        output with none has no axis (None)."""
        n = len(self.contexts)
        shapes = {d.name: d.shape
                  for d in self.data_shapes + self.label_shapes}
        arg_whole, whole, _ = self.symbol.infer_shape(**shapes)
        arg_part, part, _ = self.symbol.infer_shape(**self._local_shapes(0))

        def axis(w, p):
            return next((i for i, (a, b) in enumerate(zip(w, p))
                         if a == n * b and a != b), None)

        self._output_axes = [axis(w, p) for w, p in zip(whole, part)]
        for name, w, p in zip(self.arg_names, arg_whole, arg_part):
            self.arg_shapes[name] = tuple(w)
            if name in self.param_names and tuple(w) != tuple(p):
                self._split[name] = axis(w, p)

    # -- parameters -------------------------------------------------------------
    def _param_piece(self, name, arr, r):
        """Replica ``r``'s part of parameter ``name`` (an NDArray of its
        global shape): its slice for a parameter split like the batch, else
        the whole array."""
        axis = self._split.get(name)
        if axis is None:
            return arr
        s = self.slices[r]
        return NDArray(arr.data.narrow(axis, s.start, s.stop - s.start))

    def _param_whole(self, name):
        """Parameter ``name`` over the global batch: the first replica's
        array, or for a split parameter a new array of the replicas'
        slices."""
        if name not in self._split:
            return self._executor.arg_dict[name]
        return self._merge([[ex.arg_dict[name] for ex in self.execs]],
                           [self._split[name]])[0]

    def set_params(self, arg_params, aux_params):
        """Copy parameters into every replica's bound arrays (a split
        parameter's slice into each)."""
        for r, ex in enumerate(self.execs):
            ex.copy_params_from(
                {n: self._param_piece(n, a, r) for n, a in arg_params.items()},
                aux_params, allow_extra_params=True)

    def get_params(self, arg_params, aux_params):
        """Snapshot the bound parameters into the caller's dicts: the first
        replica's (every replica holds the same), a split parameter's
        slices joined."""
        ex = self._executor
        for name in self.param_names:
            if name in ex.arg_dict:
                whole = self._param_whole(name)
                arg_params[name] = whole if name in self._split \
                    else whole.copy()
        for name in self.aux_names:
            aux_params[name] = ex.aux_dict[name].copy()

    def update_targets(self, names):
        """The arrays an update of ``names`` writes: the first replica's,
        or a new whole array for a split parameter; hand them to
        :meth:`scatter_params` after the update."""
        return [self._param_whole(n) for n in names]

    def scatter_params(self, names, targets):
        """Copy updated :meth:`update_targets` into every replica's bound
        arrays, in place (a split parameter's slices into each; nothing
        on one context)."""
        for name, t in zip(names, targets):
            for r, ex in enumerate(self.execs):
                holder = ex.arg_dict[name]
                if holder is t:
                    continue
                _write_into(holder, self._param_piece(name, t, r).data.to(
                    holder.data.device))

    # -- execution ---------------------------------------------------------------
    def _piece(self, name, src, r):
        """Replica ``r``'s slice of the fed array ``src`` of input
        ``name``, along its batch axis (``src`` itself on one context)."""
        if len(self.execs) == 1:
            return src
        s = self.slices[r]
        return NDArray(_as_tensor(src).narrow(
            self._input_axes[name], s.start, s.stop - s.start))

    def _load_into(self, names, arrays):
        """Write each named argument's batch array (each replica's slice of
        it) into its bound array on the replica's device
        (:func:`~mxnet_tpu_torch.executor._write_into`: in place where shape
        and dtype agree, else a rebind to a copy of its own)."""
        for r, ex in enumerate(self.execs):
            device = self.contexts[r].torch_device
            for name, src in zip(names, arrays):
                if name not in ex.arg_dict:
                    continue
                src = self._piece(name, src, r)
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
        """Place a batch's arrays on the first context's device without
        binding them (reference: executor_group.py ``stage_batch``): each
        source NDArray is rebound to its device tensor, so a later
        ``forward`` of the batch finds it in place (over several contexts
        each replica's slice is copied from there). With a
        :class:`~mxnet_tpu_torch.io.PinnedRing` the copies go through pinned
        memory on its side stream; returns the bytes staged and the ring's
        event (None without a ring)."""
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
        if is_train and len(self.execs) > 1:
            train_replicas(self.execs)
            return
        for ex in self.execs:
            ex.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run backward")
        if out_grads is not None and len(self.execs) > 1:
            heads = []
            for r, ex in enumerate(self.execs):
                s = self.slices[r]
                device = self.contexts[r].torch_device
                heads.append([
                    _as_tensor(g).narrow(axis, s.start, s.stop - s.start)
                    .to(device) for g, axis in zip(
                        out_grads if isinstance(out_grads, (list, tuple))
                        else [out_grads], self._checked_axes())])
            rerun_replicas(self.execs, heads)
            out_grads = None
        for ex in self.execs:
            ex.backward(out_grads)

    def _checked_axes(self):
        for name, axis in zip(self.output_names, self._output_axes):
            if axis is None:
                raise MXNetError(
                    f"output {name} has no batch axis to merge or split "
                    f"over {len(self.execs)} contexts; "
                    "get_outputs(merge_multi_context=False) gives each "
                    "replica's")
        return self._output_axes

    def _merge(self, per_replica, axes):
        import torch

        device = self.contexts[0].torch_device
        return [NDArray(torch.cat([p.data.to(device) for p in parts],
                                  dim=axis))
                for parts, axis in zip(per_replica, axes)]

    def get_outputs(self, merge_multi_context=True):
        """The last forward's outputs; over several contexts merged along
        each output's batch axis, or with ``merge_multi_context=False`` a
        list of each replica's a output."""
        if len(self.execs) == 1:
            return list(self._executor.outputs)
        per_output = [list(parts) for parts in
                      zip(*(ex.outputs for ex in self.execs))]
        if not merge_multi_context:
            return per_output
        return self._merge(per_output, self._checked_axes())

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def get_input_grads(self, merge_multi_context=True):
        per_input = [[ex.grad_dict.get(n) for ex in self.execs]
                     for n in self.data_names]
        if len(self.execs) == 1:
            return [parts[0] for parts in per_input]
        if not merge_multi_context:
            return per_input
        return self._merge(per_input,
                           [self._input_axes[n] for n in self.data_names])

    def _check_grads(self):
        if self._executor._grads_were_elided:
            raise MXNetError(
                "gradients were not materialized: the fused train step "
                "returns no gradients unless a reader is declared. The step "
                "reads its flags when built, so set MXTPU_FUSED_GRADS=1 (or "
                "MXTPU_NO_FUSED_STEP=1) before init_optimizer, or set it and "
                "run bind(force_rebind=True) and init_optimizer again")

    def grad_lists(self):
        """Each parameter's gradients for a kvstore push, by name: one array
        a replica (the store sums them), or for a split parameter one array
        of the replicas' slices joined; raises when the fused step elided
        them."""
        self._check_grads()
        out = {}
        for n in self.param_names:
            if n not in self._executor.grad_dict:
                continue
            parts = [ex.grad_dict[n] for ex in self.execs]
            out[n] = parts if n not in self._split \
                else self._merge([parts], [self._split[n]])
        return out

    def get_grads(self):
        """The gradient of each parameter, by name: the first replica's
        array on one context, else a new array of the replicas' sum (in
        replica order, on the first replica's device; a split parameter's
        slices joined); raises when the fused step elided them."""
        lists = self.grad_lists()
        if len(self.execs) == 1:
            return {n: parts[0] for n, parts in lists.items()}
        out = {}
        for n, parts in lists.items():
            total = parts[0].data
            for p in parts[1:]:
                total = total + p.data.to(total.device)
            out[n] = NDArray(total)
        return out

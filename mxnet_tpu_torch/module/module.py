"""Module: a symbol, its executor group and an optimizer, on one device
(reference: mxnet_tpu/module/module.py).

``Module(symbol, context=mx.gpu(0), amp="bfloat16")`` binds the executor
with mixed precision: the parameters stay fp32 master copies, the graph
computes in bf16, and the gradients arrive in fp32. ``forward(is_train=True)``
computes the gradients with the outputs, ``backward()`` writes them into the
grad arrays, ``update()`` runs the optimizer over each parameter in turn,
and ``update_metric`` hands the outputs to a metric; ``BaseModule.fit``
drives the four. The aux states (BatchNorm's moving statistics) travel
with the parameters through ``get_params``/``set_params`` and checkpoints.
The reference's fused one-program step (forward, backward and update in one
XLA program) computes the same numbers; its counterpart here, a captured
CUDA graph, is later work. The context defaults to the card.

Checkpoints carry the optimizer's states (``prefix-NNNN.states``, this
package's pickle of numpy arrays by index) when asked, written at once or
by a background thread; ``Module.load(load_optimizer_states=True)`` restores
them at ``init_optimizer``. ``bind(shared_module=...)`` binds over another
module's parameter, gradient and aux arrays (a bucket of
``BucketingModule``), and ``borrow_optimizer`` takes that module's optimizer
and updater, whose states stay keyed by the shared module's parameter
indices. ``device_prefetch`` wraps an iterator in an
:class:`~mxnet_tpu_torch.io.DevicePrefetchIter` over the bound group.
"""
from __future__ import annotations

import logging
import os
import threading

from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..context import Context, current_context
from ..initializer import Uniform
from ..io import DataDesc
from ..model import load_checkpoint, save_checkpoint
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


class _CheckpointHandle:
    """A background checkpoint write: ``wait`` joins it and raises the
    writer's exception; ``done`` is true once it finished without one."""

    def __init__(self, thread, state):
        self._thread = thread
        self._state = state   # {"exc": BaseException | None}

    @property
    def exception(self):
        return self._state["exc"]

    @property
    def done(self):
        return not self._thread.is_alive() and self._state["exc"] is None

    def wait(self, timeout=None):
        """Block until the files are written (True) or ``timeout`` passes
        (False); raises the writer's exception."""
        self._thread.join(timeout)
        if not self._thread.is_alive() and self._state["exc"] is not None:
            raise self._state["exc"]
        return not self._thread.is_alive()


def _write_atomic(fname, data):
    with open(fname + ".tmp", "wb") as f:
        f.write(data)
    os.replace(fname + ".tmp", fname)


def _create_kvstore(kvstore):
    """The reference's kvstore choice (mxnet_tpu/model.py
    ``_create_kvstore``) on one device: ``local`` and ``device`` mean no
    kvstore, the optimizer runs through the local updater."""
    if kvstore is None or (isinstance(kvstore, str)
                           and "dist" not in kvstore):
        return None
    raise MXNetError(f"kvstore {kvstore!r}: distributed kvstores are not "
                     "ported yet")


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 fixed_param_names=None, amp=None):
        super().__init__(logger=logger)
        self._amp = amp
        if context is None:
            context = [current_context()]
        if isinstance(context, Context):
            context = [context]
        self._context = context
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        inputs = self._data_names + self._label_names
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        # the updater's index of each parameter (the shared module's after
        # borrow_optimizer, so states carry across buckets)
        self._param_index = {n: i for i, n in enumerate(self._param_names)}
        self._fixed_param_names = list(fixed_param_names or [])
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._updater = None
        self._preload_opt_states = None
        self._ckpt_thread = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of the checkpoint's symbol whose parameters are the
        checkpoint's (reference: module.py ``load``); ``kwargs`` go to the
        constructor. Bind it before use; with ``load_optimizer_states``,
        ``init_optimizer`` restores ``prefix-NNNN.states``."""
        ctx = kwargs.get("context")
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        symbol, args, auxs = load_checkpoint(prefix, epoch, ctx=ctx)
        mod = Module(symbol=symbol, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        background=False, batch=None, source="module.fit"):
        """Write the symbol, the parameters, the manifest
        (:func:`mxnet_tpu_torch.model.save_checkpoint`; ``batch`` marks a
        save in mid-epoch) and, with ``save_optimizer_states``, the states
        to ``prefix-NNNN.states`` (reference: module.py
        ``save_checkpoint``). ``background=True`` snapshots the parameters
        and states on their device now and writes them from a thread;
        it returns a handle with ``wait``/``done`` (None otherwise). Writes
        never overlap: each waits for the one before."""
        if save_optimizer_states and not self.optimizer_initialized:
            raise MXNetError("save_checkpoint: optimizer states need "
                             "init_optimizer first")
        prev = self._ckpt_thread
        args, auxs = self.get_params()
        if not background:
            if prev is not None:
                prev.join()
            save_checkpoint(prefix, epoch, self.symbol, args, auxs,
                            batch=batch, source=source)
            if save_optimizer_states:
                self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")
            return None
        # the update rebinds the parameters' and states' NDArrays to new
        # tensors, so copies of the dicts (and of the state tuples) keep
        # this step's tensors
        args, auxs = dict(args), dict(auxs)
        states = None
        if save_optimizer_states:
            states = opt.Updater(self._optimizer)
            states.states = self._updater.copy_states()
        symbol = self.symbol
        state = {"exc": None}

        def _write():
            try:
                if prev is not None:
                    prev.join()
                save_checkpoint(prefix, epoch, symbol, args, auxs,
                                batch=batch, source=source)
                if states is not None:
                    _write_atomic(f"{prefix}-{epoch:04d}.states",
                                  states.get_states())
            except BaseException as e:   # surfaced through the handle
                state["exc"] = e

        t = threading.Thread(target=_write, name="mxtpu-ckpt-writer")
        self._ckpt_thread = t
        t.start()
        return _CheckpointHandle(t, state)

    def save_optimizer_states(self, fname):
        """Write the updater's states to ``fname`` (written to a temporary
        name and renamed into place)."""
        if not self.optimizer_initialized:
            raise MXNetError("save_optimizer_states: init_optimizer first")
        _write_atomic(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Restore states written by :meth:`save_optimizer_states`."""
        if not self.optimizer_initialized:
            raise MXNetError("load_optimizer_states: init_optimizer first")
        with open(fname, "rb") as f:
            raw = f.read()
        try:
            self._updater.set_states(raw)
        except Exception as e:
            from ..model import CheckpointCorrupt

            raise CheckpointCorrupt(fname, f"optimizer states: {e}") from e

    def device_prefetch(self, data_iter, depth=None):
        """``data_iter`` wrapped in a :class:`~mxnet_tpu_torch.io.
        DevicePrefetchIter` over this module's executor group; ``depth``
        defaults to ``MXNET_DEVICE_PREFETCH_DEPTH`` (2)."""
        assert self.binded, "bind() first: staging needs the bound device"
        from ..io import DevicePrefetchIter

        if depth is None:
            try:
                depth = max(1, int(os.environ.get(
                    "MXNET_DEVICE_PREFETCH_DEPTH", "2")))
            except ValueError:
                depth = 2
        return DevicePrefetchIter(data_iter, self._exec_group, depth=depth)

    # -- properties --------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        shapes = {d.name: d.shape
                  for d in self._data_shapes + (self._label_shapes or [])}
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, out_shapes))

    # -- parameters --------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        return self._arg_params, self._aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Fill the parameters from ``arg_params``/``aux_params`` where they
        are given and from ``initializer`` elsewhere (by name), then copy
        them into the executor."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        ctx = self._context[0]
        ex = self._exec_group._executor
        if self._arg_params is None:
            self._arg_params = {n: nd.zeros(ex.arg_dict[n].shape, ctx)
                                for n in self._param_names}
        if self._aux_params is None:
            self._aux_params = {n: nd.zeros(ex.aux_dict[n].shape, ctx)
                                for n in self._aux_names}

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                src = cache[name]
                if src is not arr:
                    if tuple(src.shape) != arr.shape:
                        raise MXNetError(
                            f"param {name} shape mismatch: given "
                            f"{tuple(src.shape)} vs bound {arr.shape}")
                    if not isinstance(src, nd.NDArray):
                        src = nd.array(src, ctx)
                    src.copyto(arr)
                return
            if cache is not None and not allow_missing:
                raise RuntimeError(f"{name} is not presented")
            if initializer is not None:
                initializer(name, arr)

        for name, arr in self._arg_params.items():
            _impl(name, arr, arg_params)
        for name, arr in self._aux_params.items():
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)

    # -- bind --------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor group (reference: module.py ``bind``). With
        ``shared_module`` (bound, its parameters initialized) the arrays
        whose names and shapes match are that module's, and so are the
        parameter dicts: this module counts as initialized."""
        if force_rebind:
            self._exec_group = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if not for_training and inputs_need_grad:
            raise MXNetError("inputs_need_grad needs for_training")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                              for d in label_shapes] if label_shapes else None
        shared_group = None
        if shared_module is not None:
            if not (isinstance(shared_module, Module) and shared_module.binded
                    and shared_module.params_initialized):
                raise MXNetError("bind: shared_module must be a bound Module "
                                 "with initialized parameters")
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._data_shapes,
            self._label_shapes, self._param_names, for_training,
            inputs_need_grad, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, amp=self._amp, shared_group=shared_group)
        self.binded = True
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    # -- optimizer ---------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """An optimizer by name (with ``rescale_grad`` 1/batch unless given)
        or an :class:`~mxnet_tpu_torch.optimizer.Optimizer`."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        self._kvstore = _create_kvstore(kvstore)
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault(
                "rescale_grad", 1.0 / self._exec_group.batch_size)
            optimizer = opt.create(optimizer, sym=self._symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Use ``shared_module``'s optimizer and updater (reference:
        module.py ``borrow_optimizer``), with its parameter indices."""
        if not shared_module.optimizer_initialized:
            raise MXNetError("borrow_optimizer: the shared module has no "
                             "optimizer")
        missing = [n for n in self._param_names
                   if n not in shared_module._param_index]
        if missing:
            raise MXNetError(f"borrow_optimizer: parameters {missing} are "
                             "not the shared module's")
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._updater = shared_module._updater
        self._param_index = shared_module._param_index
        self.optimizer_initialized = True

    # -- execution ---------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer update of every parameter with a gradient
        (reference: module.py ``update``)."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        grads = self._exec_group.get_grads()
        arg_dict = self._exec_group._executor.arg_dict
        names = [n for n in self._param_names if n in grads]
        if names:
            self._updater.update_multi(
                [self._param_index[n] for n in names],
                [grads[n] for n in names], [arg_dict[n] for n in names])

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        """``eval_metric.update(labels, outputs)`` on the last forward's
        outputs."""
        self._exec_group.update_metric(eval_metric, labels)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._exec_group.get_input_grads(merge_multi_context)

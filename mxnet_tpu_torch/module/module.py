"""Module: a symbol, its executor group and an optimizer (reference:
mxnet_tpu/module/module.py).

``Module(symbol, context=mx.gpu(0), amp="bfloat16")`` binds the executor
with mixed precision: the parameters stay fp32 master copies, the graph
computes in bf16, and the gradients arrive in fp32. ``forward(is_train=True)``
computes the outputs, ``backward()`` the gradients, ``update()`` the
optimizer's step, and ``update_metric`` hands the outputs to a metric;
``BaseModule.fit`` drives the four. The aux states (BatchNorm's moving
statistics) travel with the parameters through ``get_params``/
``set_params`` and checkpoints. The context defaults to the card.

The fused step (reference: module.py ``_maybe_build_fused_step``):
``init_optimizer`` builds a :class:`~.step_graph.StepProgram` (forward,
backward and the optimizer's update in one function, captured on the card
as one CUDA graph per binding) when the update is local, the optimizer has
a fused rule (``_tree_update``), no input gradient is asked for, every
``grad_req`` is write or null and ``MXTPU_NO_FUSED_STEP`` is not 1. A train
``forward`` then runs the whole step: the outputs are visible at once, the
new aux states installed, and the new weights and states staged until
``update()`` installs them (an evaluation forward in between keeps them; a
new train forward or ``backward(out_grads)`` drops them). The gradients are
not kept unless ``MXTPU_FUSED_GRADS=1`` (``backward()`` then writes them;
without it ``get_grads`` raises). ``MXTPU_DONATE_PARAMS=1``, or ``fit``
unless it is 0, writes the new weights and states in place during the step
(``backward(out_grads)`` then raises). On the card the outputs are the
graph's buffers, which the next step overwrites, as an MXNet executor's
outputs are (copy one to keep it). ``run_n_steps`` runs several steps
with no host sync between them. Otherwise ``forward``/``backward``/
``update`` run the split path: the executor's walk and autograd, then the
optimizer one parameter at a time.

Checkpoints carry the optimizer's states (``prefix-NNNN.states``, this
package's pickle of numpy arrays by index) when asked, written at once or
by a background thread; ``Module.load(load_optimizer_states=True)`` restores
them at ``init_optimizer``. ``bind(shared_module=...)`` binds over another
module's parameter, gradient and aux arrays (a bucket of
``BucketingModule``), and ``borrow_optimizer`` takes that module's optimizer
and updater, whose states stay keyed by the shared module's parameter
indices. ``device_prefetch`` wraps an iterator in an
:class:`~mxnet_tpu_torch.io.DevicePrefetchIter` over the bound group.

Several contexts (``context=[mx.gpu(0), mx.gpu(1)]``, or ``cpu(i)`` on the
host) bind one replica each over an even slice of the batch
(:mod:`~.executor_group`); they run the split path: the replicas' forward
and backward in lockstep, the gradients summed, one update, the weights
copied back to every replica. A kvstore (``init_optimizer(kvstore=...)``,
:func:`~mxnet_tpu_torch.model._create_kvstore`'s rules: ``local`` and
``device`` strings mean none, ``dist*`` strings and ``KVStore`` objects
one) turns the fused step off and runs the update on the store: ``update``
pushes each parameter's gradients (one a replica) and pulls the new weights
into every replica; under ``dist_sync`` the learning rate's batch is every
worker's batch.
"""
from __future__ import annotations

import itertools
import logging
import os
import threading

from .. import ndarray as nd
from .. import optimizer as opt
from ..base import MXNetError
from ..context import Context, current_context
from ..initializer import Uniform
from ..io import DataDesc
from ..model import (_create_kvstore, _initialize_kvstore, load_checkpoint,
                     save_checkpoint)
from .base_module import BaseModule, check_run_n_steps_unroll
from .executor_group import DataParallelExecutorGroup
from .step_graph import StepProgram

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


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None, amp=None):
        super().__init__(logger=logger)
        self._amp = amp
        if context is None:
            context = [current_context()]
        if isinstance(context, Context):
            context = [context]
        self._context = list(context)
        self._work_load_list = work_load_list
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
        self._update_on_kvstore = False
        self._updater = None
        self._preload_opt_states = None
        self._ckpt_thread = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._fused_step_fn = None    # the StepProgram, when eligible
        self._fused_pending = None
        self._fused_indices = None
        self._fused_want_grads = False
        self._fused_donate_params = False
        self._donate_hint = False     # set by fit for its duration

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
        # get_params and copy_states hand out copies, which later updates
        # (in place, in the fused step) do not touch; a later get_params
        # replaces the dicts' entries, so the writer keeps its own dicts
        args, auxs = dict(args), dict(auxs)
        states = None
        if save_optimizer_states and self._update_on_kvstore:
            # the store holds the states: saved now, the rest in background
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")
        elif save_optimizer_states:
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
        """Write the updater's states (the kvstore's when it runs the
        update) to ``fname`` (written to a temporary name and renamed into
        place)."""
        if not self.optimizer_initialized:
            raise MXNetError("save_optimizer_states: init_optimizer first")
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        _write_atomic(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Restore states written by :meth:`save_optimizer_states`."""
        if not self.optimizer_initialized:
            raise MXNetError("load_optimizer_states: init_optimizer first")
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
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
            shapes = self._exec_group.arg_shapes
            self._arg_params = {n: nd.zeros(shapes[n], ctx)
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
            grad_req=grad_req, amp=self._amp, shared_group=shared_group,
            workload=self._work_load_list)
        self.binded = True
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        # a new executor drops the step over the old one
        self._refresh_fused_step()

    # -- optimizer ---------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """An optimizer by name (with ``rescale_grad`` 1/batch unless given;
        under a synchronous ``dist*`` store, whose push sums every worker's
        gradients, the batch of every worker) or an
        :class:`~mxnet_tpu_torch.optimizer.Optimizer`; with a kvstore
        (reference: module.py ``init_optimizer``) each parameter's key is
        initialised from rank 0's value and pulled into every replica, and
        the store runs the optimizer."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        kv, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._exec_group.batch_size
        if kv is not None and kv._is_dist and not kv._is_async:
            batch_size *= kv.num_workers
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", 1.0 / batch_size)
            optimizer = opt.create(optimizer, sym=self._symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        self._optimizer = optimizer
        self._kvstore = kv
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kv is not None:
            # every worker starts from rank 0's weights, in every replica
            eg = self._exec_group
            targets = eg.update_targets(self._param_names)
            _initialize_kvstore(kv, self._param_names, self._arg_params,
                                update_on_kvstore, param_arrays=targets)
            eg.scatter_params(self._param_names, targets)
            self._params_dirty = True
        if update_on_kvstore:
            kv.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        self._maybe_build_fused_step()
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
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self._param_index = shared_module._param_index
        self.optimizer_initialized = True
        self._maybe_build_fused_step()

    # -- the fused step ----------------------------------------------------------
    def _drop_fused_step(self):
        if self._fused_step_fn is not None:
            self._fused_step_fn.drop()
        self._fused_step_fn = None

    def _refresh_fused_step(self):
        """Drop the step (a new executor, or new flags) and build it again
        where it is eligible (reference: module.py ``_refresh_fused_step``)."""
        self._drop_fused_step()
        self._fused_pending = None
        self._fused_indices = None
        if self.optimizer_initialized:
            self._maybe_build_fused_step()

    def _maybe_build_fused_step(self):
        """Build the fused step where the reference's rules allow it
        (module docstring; reference: module.py :489)."""
        self._drop_fused_step()
        eg = self._exec_group
        if eg is None or not self.optimizer_initialized:
            return
        ex = eg._executor
        if (os.environ.get("MXTPU_NO_FUSED_STEP") == "1"
                or self._kvstore is not None
                or len(eg.execs) > 1
                or self._updater is None
                or self._optimizer._tree_update is None
                or self.inputs_need_grad
                or any(r not in ("write", "null")
                       for r in ex.grad_req.values())
                or any(n not in self._param_index for n in ex._diff_args)):
            return
        self._fused_want_grads = os.environ.get("MXTPU_FUSED_GRADS") == "1"
        env = os.environ.get("MXTPU_DONATE_PARAMS")
        self._fused_donate_params = env == "1" if env is not None \
            else bool(self._donate_hint)
        self._fused_indices = [self._param_index[n] for n in ex._diff_args]
        self._fused_step_fn = StepProgram(
            ex, self._updater, self._fused_indices, self._fused_want_grads,
            self._fused_donate_params)

    def step_info(self):
        """The fused step's state: ``captured``, the reason a capture is
        refused (None if none), warm-up and capture ms, and counts of eager
        steps, warm-ups, captures and replays; None without a fused
        step."""
        if self._fused_step_fn is None:
            return None
        return self._fused_step_fn.info()

    def _fused_states(self):
        """Make the optimizer's states the step updates where missing, or
        bring restored ones to the device."""
        ex = self._exec_group._executor
        for i, name in zip(self._fused_indices, ex._diff_args):
            self._updater._state(i, ex.arg_dict[name])

    def _fused_forward(self, data_batch, rates=None):
        """Run the fused step on ``data_batch`` (reference: module.py
        ``_fused_forward``); ``rates`` is a row of
        :meth:`StepProgram.plan_rates`, else ``plan_multi`` plans them."""
        from ..executor import GRADS_ELIDED
        from ..ndarray import NDArray

        eg = self._exec_group
        ex = eg._executor
        eg._load_into(eg.data_names, data_batch.data)
        if eg.label_names and getattr(data_batch, "label", None):
            eg._load_into(eg.label_names, data_batch.label)
        self._fused_states()
        step = self._fused_step_fn
        if rates is None:
            lrs, wds = self._optimizer.plan_multi(self._fused_indices)
            rates = step.plan_rates([lrs], [wds])[0]
        step.set_rates(rates)
        res = step.run()
        ex.outputs = [NDArray(o) for o in res.outputs]
        # backward(out_grads) replays the forward the caller saw: the aux
        # states before this step and its random numbers
        if res.aux_prev is not None:
            ex._last_aux = dict(zip(ex.aux_names, res.aux_prev))
        ex._last_rng = step.rng
        if res.grads is not None:
            ex._pending_grads = dict(zip(ex._diff_args, res.grads))
            ex._grads_were_elided = False
        else:
            ex._pending_grads = GRADS_ELIDED
            ex._grads_were_elided = True
        self._fused_pending = res.staged

    def _install_fused_update(self):
        """Install the staged weights and states (nothing to install under
        donation) and move the update counts."""
        import torch

        staged = self._fused_pending
        self._fused_pending = None
        if staged:
            ex = self._exec_group._executor
            dst = [ex.arg_dict[n].data for n in ex._diff_args]
            src = [w for w, _ in staged]
            for i, (_, leaves) in zip(self._fused_indices, staged):
                dst += self._optimizer._state_leaves(self._updater.states[i])
                src += leaves
            with torch.no_grad():
                torch._foreach_copy_(dst, src)
        self._optimizer.advance_counts(self._fused_indices)

    def run_n_steps(self, batches, eval_metric=None):
        """Run ``len(batches)`` fused steps, the one-step graph replayed on
        each batch in turn with no host sync between them (reference:
        module.py ``run_n_steps``, its ``percall`` form). The updates
        install at once and the update counts and schedule advance by
        ``n``; the outputs of the last step are the visible ones.
        ``eval_metric`` is updated for every step from the outputs, copied
        into one device buffer and to the host once. Bit-identical to ``n``
        single steps."""
        batches = list(batches)
        if not batches:
            return
        self._run_steps(iter(batches), len(batches), eval_metric)

    def _run_steps(self, batches, n, eval_metric=None):
        """Up to ``n`` fused steps over the iterator ``batches``, each run as
        its batch arrives; the rates of all ``n`` come from the host in one
        copy. Returns the batches run (fewer than ``n`` at the iterator's
        end)."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        if self._fused_step_fn is None:
            raise MXNetError(
                "run_n_steps needs the fused train step: it is built by "
                "init_optimizer when the update is local, the optimizer has "
                "a fused rule and MXTPU_NO_FUSED_STEP is unset")
        check_run_n_steps_unroll()
        from ..ndarray import NDArray

        plan = self._fused_step_fn.plan_rates(
            *self._optimizer.plan_multi_n(self._fused_indices, n))
        done, outs = [], None
        for t, batch in enumerate(itertools.islice(batches, n)):
            self._fused_forward(batch, rates=plan[t])
            self._install_fused_update()
            done.append(batch)
            if eval_metric is not None:
                step_outs = [o.data for o in self._exec_group.get_outputs()]
                if outs is None:
                    outs = [o.new_empty((n,) + tuple(o.shape))
                            for o in step_outs]
                for buf, o in zip(outs, step_outs):
                    buf[t].copy_(o)
        self._params_dirty = True
        if outs is not None:
            host = [o[:len(done)].to("cpu") for o in outs]
            for t, batch in enumerate(done):
                eval_metric.update(batch.label,
                                   [NDArray(h[t]) for h in host])
        return done

    # -- execution ---------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        if is_train and self._fused_step_fn is not None:
            self._fused_forward(data_batch)
            return
        if is_train:
            # a new train forward supersedes a staged fused update; an
            # evaluation forward keeps it
            self._fused_pending = None
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        if self._fused_pending is not None and out_grads is not None:
            if self._fused_donate_params:
                raise MXNetError(
                    "backward(out_grads) needs the staged fused update to be "
                    "discarded, but MXTPU_DONATE_PARAMS=1 already wrote the "
                    "step's weights in place; unset it (or set "
                    "MXTPU_NO_FUSED_STEP=1) for explicit head gradients")
            self._fused_pending = None
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer update of every parameter with a gradient
        (reference: module.py ``update``): the fused step's staged update;
        else through the kvstore, a push of each parameter's gradients and a
        pull of its weights into every replica; else the split path's
        per-parameter ops on the replicas' summed gradients."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        if self._fused_pending is not None:
            self._install_fused_update()
            return
        eg = self._exec_group
        if self._update_on_kvstore:
            grads = eg.grad_lists()
            names = [n for n in self._param_names if n in grads]
            targets = eg.update_targets(names)
            for idx, (name, target) in enumerate(zip(names, targets)):
                self._kvstore.push(name, grads[name], priority=-idx)
                self._kvstore.pull(name, target, priority=-idx)
            eg.scatter_params(names, targets)
            return
        grads = eg.get_grads()
        names = [n for n in self._param_names if n in grads]
        if names:
            targets = eg.update_targets(names)
            self._updater.update_multi(
                [self._param_index[n] for n in names],
                [grads[n] for n in names], targets)
            eg.scatter_params(names, targets)

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

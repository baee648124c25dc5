"""BaseModule: the training-loop interface (reference:
mxnet_tpu/module/base_module.py).

``fit`` is the classic loop (reference :139-437): bind, ``init_params``,
``init_optimizer``, then per epoch ``forward_backward``, ``update`` and
``update_metric`` for each batch, the batch-end callbacks, the epoch-end
parameters, checkpoint and callbacks, ``score`` on the evaluation data and
``train_data.reset()``. With ``checkpoint_prefix`` it saves parameters and
optimizer states at each epoch's end (and every
``checkpoint_every_n_batches`` batches within it); ``resume=True`` restarts
from the newest intact checkpoint, skipping the batches it holds.
``MXNET_DEVICE_PREFETCH=1`` stages the batches onto the card ahead of the
step (:meth:`Module.device_prefetch`). ``MXNET_RUN_N_STEPS=n`` runs the
batches ``n`` at a time through ``run_n_steps``'s fused steps where the
module has a fused step, each batch as it arrives (the steps are the
single steps', a short last super-batch included; the metric reads the
outputs, and the callbacks and checkpoints come, once a super-step). For its duration ``fit`` lets the
fused step write the weights in place (donation) unless
``MXTPU_DONATE_PARAMS=0``. ``kvstore`` goes to ``init_optimizer``; a
store's ``sync_weights`` (dist_async's averaging) runs at each epoch's end
and every ``sync_interval`` batches. ``score``, ``iter_predict`` and
``predict`` run the evaluation forward; ``save_params``/``load_params``
keep the parameters in the MXTP container, arguments under ``arg:`` and aux
states under ``aux:``.
"""
from __future__ import annotations

import itertools
import logging
import os
import time

from .. import metric as _metric
from .. import ndarray as nd
from ..base import MXNetError
from ..callback import BatchEndParam
from ..context import cpu
from ..convert import split_params
from ..initializer import Uniform

__all__ = ["BaseModule"]


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


def _refuse_unported(monitor):
    """The reference's ``fit`` options that wait for their ports raise
    instead of being ignored: ``monitor``, and ``MXNET_RUN_N_STEPS`` with
    an ``MXNET_RUN_N_STEPS_UNROLL`` other than auto or percall."""
    if monitor:
        raise MXNetError("fit: monitor not ported yet")
    if _run_n_steps_env() > 1:
        check_run_n_steps_unroll()


def check_run_n_steps_unroll():
    """Raise for an ``MXNET_RUN_N_STEPS_UNROLL`` other than ``auto`` (the
    default) and ``percall``, which both run the one-step graph ``n`` times
    (the reference's percall form); its one program of ``n`` steps is not
    ported."""
    v = os.environ.get("MXNET_RUN_N_STEPS_UNROLL", "") or "auto"
    if v not in ("auto", "percall"):
        raise MXNetError(
            f"MXNET_RUN_N_STEPS_UNROLL={v} (with MXNET_RUN_N_STEPS): one "
            "graph of n steps is not ported yet; auto and percall run the "
            "one-step graph n times")


def _run_n_steps_env():
    """``MXNET_RUN_N_STEPS`` (default 1: one step at a time)."""
    try:
        return max(1, int(os.environ.get("MXNET_RUN_N_STEPS", "1") or 1))
    except ValueError:
        return 1


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    # -- high level ----------------------------------------------------------
    def forward_backward(self, data_batch):
        """A training forward and its backward."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """``eval_metric`` over ``eval_data`` (at most ``num_batch``
        batches) through the evaluation forward; returns its
        ``get_name_value()``. As in the reference, a padded last batch
        counts whole."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` for each batch, the padded
        rows of a last batch dropped."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - pad]
                       for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data``, the padded rows dropped, merged
        over the batches (one NDArray for one output) unless
        ``merge_batches`` is false."""
        assert self.binded and self.params_initialized
        output_list = [[out.copy() for out in outputs] for outputs, _, _ in
                       self.iter_predict(eval_data, num_batch, reset)]
        if not output_list:
            return output_list
        if not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        for out in output_list:
            assert len(out) == num_outputs, \
                "Cannot merge batches: mismatched output count"
        merged = [nd.concatenate([out[i] for out in output_list])
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint_prefix=None,
            checkpoint_every_n_batches=None, resume=False):
        """Train for epochs ``begin_epoch`` to ``num_epoch`` (reference:
        base_module.py ``fit``). ``eval_metric=None`` keeps no training
        metric (and makes no per-batch host copy of the outputs).

        ``checkpoint_prefix`` saves a checkpoint with the optimizer's states
        at each epoch's end and, with ``checkpoint_every_n_batches=N``,
        every N batches (its manifest's ``batch`` counts the batches of the
        epoch inside it). ``resume=True`` restarts from the newest intact
        checkpoint under the prefix: parameters, optimizer states and
        position; the iterator replays the batches already trained, so it
        must give the same batches again (a fresh start when there is no
        checkpoint). ``monitor``, and an ``MXNET_RUN_N_STEPS_UNROLL``
        other than auto or percall, raise: they are not ported yet."""
        assert num_epoch is not None, "please specify number of epochs"
        _refuse_unported(monitor)
        resume_batch = 0
        resume_states = None
        if resume:
            if not checkpoint_prefix:
                raise MXNetError("fit(resume=True) needs checkpoint_prefix=")
            from ..model import find_resume_point

            found = find_resume_point(checkpoint_prefix, ctx=cpu())
            if found is not None:
                (begin_epoch, resume_batch, ck_epoch, _, arg_params,
                 aux_params) = found[:6]
                force_init = True
                states = f"{checkpoint_prefix}-{ck_epoch:04d}.states"
                if os.path.exists(states):
                    resume_states = states
                self.logger.info(
                    "fit: resuming from checkpoint epoch %d "
                    "(begin_epoch=%d, skipping %d batches)",
                    ck_epoch, begin_epoch, resume_batch)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        staged = None   # the DevicePrefetchIter fit made, closed at the end
        try:
            # fit drives the strict forward/backward/update protocol, so its
            # fused step may write the weights in place (donation); the hint
            # lasts for this call
            self._donate_hint = True
            self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                optimizer_params=optimizer_params)
            if resume_states is not None:
                self.load_optimizer_states(resume_states)
            if getattr(self, "_fused_step_fn", None) is not None \
                    and not self._fused_donate_params:
                # initialized before fit: build the step again with donation
                self._refresh_fused_step()
            if validation_metric is None:
                validation_metric = eval_metric
            if eval_metric is not None \
                    and not isinstance(eval_metric, _metric.EvalMetric):
                eval_metric = _metric.create(eval_metric)
            run_n = _run_n_steps_env()
            if getattr(self, "_fused_step_fn", None) is None \
                    or not hasattr(self, "run_n_steps"):
                run_n = 1
            if os.environ.get("MXNET_DEVICE_PREFETCH") == "1":
                from ..io import DevicePrefetchIter

                if not isinstance(train_data, DevicePrefetchIter):
                    staged = train_data = self.device_prefetch(train_data)
            for epoch in range(begin_epoch, num_epoch):
                self._fit_epoch(epoch, train_data, eval_data, eval_metric,
                                validation_metric, epoch_end_callback,
                                batch_end_callback, eval_end_callback,
                                eval_batch_end_callback, checkpoint_prefix,
                                checkpoint_every_n_batches,
                                resume_batch if epoch == begin_epoch else 0,
                                run_n)
        finally:
            if staged is not None:
                staged.close()
            self._donate_hint = False
            if getattr(self, "_fused_donate_params", False):
                self._refresh_fused_step()

    def _fit_epoch(self, epoch, train_data, eval_data, eval_metric,
                   validation_metric, epoch_end_callback, batch_end_callback,
                   eval_end_callback, eval_batch_end_callback,
                   checkpoint_prefix, checkpoint_every_n_batches,
                   skip_batches, run_n):
        """One epoch of ``fit``; the first ``skip_batches`` batches are
        read and dropped (they are in the checkpoint resumed from). With
        ``run_n`` > 1 the batches go ``run_n`` at a time through the fused
        steps of ``run_n_steps`` (reference: base_module.py :236-320)."""
        tic = time.time()
        if eval_metric is not None:
            eval_metric.reset()
        nbatch = -1
        data_src = iter(train_data)
        while True:
            if nbatch + 1 < skip_batches:
                try:
                    next(data_src)
                except StopIteration:
                    break
                nbatch += 1
                continue
            first = nbatch + 1
            if run_n > 1:
                # each batch runs as it arrives; the metric reads the
                # super-step's outputs once
                batches = self._run_steps(data_src, run_n,
                                          eval_metric=eval_metric)
            else:
                batches = list(itertools.islice(data_src, 1))
                for data_batch in batches:
                    self.forward_backward(data_batch)
                    self.update()
                    kv = getattr(self, "_kvstore", None)
                    if kv is not None and kv.sync_interval \
                            and (first + 1) % kv.sync_interval == 0:
                        # dist_async's bound in mid-epoch: a batch index is
                        # an aligned point when the shards are equal
                        kv.sync_weights()
                    if eval_metric is not None:
                        self.update_metric(eval_metric, data_batch.label)
            if not batches:
                break
            nbatch = first + len(batches) - 1
            if checkpoint_prefix and checkpoint_every_n_batches \
                    and (nbatch + 1) // checkpoint_every_n_batches \
                    > first // checkpoint_every_n_batches:
                # a super-step that crosses the cadence saves once, at its end
                self.save_checkpoint(checkpoint_prefix, epoch,
                                     save_optimizer_states=True,
                                     batch=nbatch + 1)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(params)
        if eval_metric is not None:
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
        self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)

        # dist_async: the epoch's end is an aligned point of every worker,
        # whatever each pushed within the epoch
        kv = getattr(self, "_kvstore", None)
        if kv is not None:
            kv.sync_weights()
        arg_params, aux_params = self.get_params()
        self.set_params(arg_params, aux_params)
        if checkpoint_prefix:
            # no batch in the manifest: the epoch is complete
            self.save_checkpoint(checkpoint_prefix, epoch,
                                 save_optimizer_states=True)
        if epoch_end_callback is not None:
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, arg_params, aux_params)
        if eval_data and validation_metric is not None:
            res = self.score(eval_data, validation_metric,
                             score_end_callback=eval_end_callback,
                             batch_end_callback=eval_batch_end_callback,
                             epoch=epoch)
            for name, val in res:
                self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name,
                                 val)
        train_data.reset()

    # -- parameters ------------------------------------------------------------
    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        """Save the parameters: ``arg:<name>`` and ``aux:<name>``."""
        arg_params, aux_params = self.get_params()
        save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        """Load parameters saved by :meth:`save_params` (either package's)
        into the bound module."""
        saved = nd.load(fname, cpu())
        if not isinstance(saved, dict) or not all(
                k.startswith(("arg:", "aux:")) for k in saved):
            raise ValueError(f"Invalid param file {fname}")
        self.set_params(*split_params(saved))

    # -- to implement ----------------------------------------------------------
    def get_params(self):
        raise NotImplementedError

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

"""BucketingModule: training over sequences of several lengths (reference:
mxnet_tpu/module/bucketing_module.py).

``sym_gen(bucket_key)`` gives each bucket its graph. The default bucket's
:class:`Module` binds first; every other bucket binds its own executor on
first use (``switch_bucket``) over the default bucket's parameter, gradient
and aux NDArrays (``Module.bind(shared_module=...)``) and borrows its
optimizer, so the buckets train one set of parameters and the updater's
states carry across buckets. Each bucket's module builds its fused step
when it takes the optimizer (:mod:`~mxnet_tpu_torch.module.step_graph`):
one CUDA graph a bucket on the card, each with a memory pool of its own (so
the buckets may replay in any order), each updating the default bucket's
arrays and optimizer states in place. The reference fuses the default bucket only and
runs the others as two compiled programs each; one graph a bucket is the
port's counterpart of those compiled steps. Over several contexts every
bucket binds one replica a context over the default bucket's replicas
(the split path; ``work_load_list`` is accepted and, as in the reference,
the batch splits evenly).
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs a default_bucket_key")
        self._work_load_list = work_load_list
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._params_dirty = False
        self._donate_hint = False

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def _module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        mod = Module(symbol, data_names, label_names, logger=self.logger,
                     context=self._context,
                     work_load_list=self._work_load_list)
        mod._donate_hint = self._donate_hint
        return mod

    # -- the buckets' fused steps ---------------------------------------------
    @property
    def _fused_step_fn(self):
        return self._curr_module._fused_step_fn if self.binded else None

    @property
    def _fused_donate_params(self):
        return self.binded and self._curr_module._fused_donate_params

    def _refresh_fused_step(self):
        """Build every bucket's fused step again (``fit`` turns donation on
        and off)."""
        for mod in self._buckets.values():
            mod._donate_hint = self._donate_hint
            mod._refresh_fused_step()

    def step_info(self):
        """Each bound bucket's :meth:`Module.step_info`, by bucket key."""
        return {key: mod.step_info() for key, mod in self._buckets.items()}

    def get_params(self):
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init)
        self.params_initialized = True
        self._params_dirty = False

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket (reference: bucketing_module.py
        ``bind``)."""
        if shared_module is not None:
            raise MXNetError("shared_module for BucketingModule is not "
                             "supported")
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._params_dirty = False
        module = self._module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, grad_req=grad_req)
        self.binded = True
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` current, binding its module over the default
        bucket's arrays on first use (reference: bucketing_module.py
        ``switch_bucket``)."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            module = self._module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False, shared_module=default)
            if self.optimizer_initialized:
                module.borrow_optimizer(default)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Refused, as by ``Module.fit``'s ``monitor``: the monitor is not
        ported yet."""
        raise MXNetError("install_monitor: the monitor is not ported yet")

"""BaseModule: the training-loop interface (reference:
mxnet_tpu/module/base_module.py).

What a training loop calls: ``forward_backward``, ``get_params`` /
``set_params`` and the abstract methods a module implements. ``fit``, ``score`` and ``predict`` wait for the metric
and callback modules.
"""
from __future__ import annotations

import logging

from ..initializer import Uniform

__all__ = ["BaseModule"]


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

    def forward_backward(self, data_batch):
        """A training forward and its backward."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

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

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

"""Optimizers (reference: mxnet_tpu/optimizer.py, the ``Optimizer`` base, SGD
and Adam).

The same registry and ``Updater`` closure design as the reference. Update
rules call the fused update ops of :mod:`mxnet_tpu_torch.ops.tensor`
(``sgd_update``, ``sgd_mom_update``, ``adam_update``), one per parameter;
each returns new arrays and the rule rebinds the weight and state NDArrays
to them. lr/wd multipliers (``__lr_mult__``/``__wd_mult__`` attributes of
the symbol, or set by name), ``param_idx2name``, ``clip_gradient``,
``rescale_grad``, ``lr_scheduler`` (read at ``num_update``) and
``begin_num_update`` follow the reference. The reference's one-program update
of every parameter (``_tree_update``) computes the same numbers as these
per-parameter ops; ``update_multi`` here runs them in turn.
"""
from __future__ import annotations

import math

from .base import MXNetError
from .ndarray import zeros

__all__ = ["Optimizer", "SGD", "Adam", "create", "register", "Updater",
           "get_updater"]

_REGISTRY: dict = {}


def register(klass):
    """Register an optimizer class under its lower-cased name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by registered name (reference: create_optimizer)."""
    klass = _REGISTRY.get(name.lower())
    if klass is None:
        raise MXNetError(f"unknown optimizer {name!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    return klass(**kwargs)


class Optimizer:
    """Base optimizer (reference: optimizer.py ``Optimizer``)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        if sym is not None:
            attrs = sym.attr_dict()
            for name in sym.list_arguments():
                if name in attrs:
                    if "__lr_mult__" in attrs[name]:
                        self.lr_mult[name] = float(attrs[name]["__lr_mult__"])
                    if "__wd_mult__" in attrs[name]:
                        self.wd_mult[name] = float(attrs[name]["__wd_mult__"])

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Weight decay only on ``*_weight`` and ``*_gamma`` by default, then
        the given multipliers."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        self._index_update_count[index] = self._index_update_count.get(
            index, self.begin_num_update) + 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _op_kwargs(self, index):
        """lr, wd, rescale_grad and clip_gradient of one update, in the
        update ops' terms (-1: no clip); advances the update count."""
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        return dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                    clip_gradient=self.clip_gradient or -1.0)

    def update_multi(self, indices, weights, grads, states):
        """Update many parameters, one after another."""
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update(i, w, g, s)


@register
class SGD(Optimizer):
    """SGD with momentum (reference: optimizer.py ``SGD``; the fused
    ``sgd_update``/``sgd_mom_update`` ops)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        from .ops import imperative_invoke

        kwargs = self._op_kwargs(index)
        if state is not None:
            new_w, new_m = imperative_invoke(
                "sgd_mom_update", weight, grad, state,
                momentum=self.momentum, **kwargs)
            state._data = new_m._data
        else:
            new_w = imperative_invoke("sgd_update", weight, grad, **kwargs)
        weight._data = new_w._data


@register
class Adam(Optimizer):
    """Adam (reference: optimizer.py ``Adam``): the fused ``adam_update`` op
    with the bias correction folded into its learning rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context, dtype=weight.dtype),
                zeros(weight.shape, weight.context, dtype=weight.dtype))

    def update(self, index, weight, grad, state):
        from .ops import imperative_invoke

        kwargs = self._op_kwargs(index)
        t = self._index_update_count[index]
        kwargs["lr"] *= math.sqrt(1.0 - self.beta2 ** t) \
            / (1.0 - self.beta1 ** t)
        mean, var = state
        new_w, new_mean, new_var = imperative_invoke(
            "adam_update", weight, grad, mean, var, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, **kwargs)
        weight._data = new_w._data
        mean._data = new_mean._data
        var._data = new_var._data


class Updater:
    """Applies an optimizer with per-index state (reference: optimizer.py
    ``Updater``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])

    def update_multi(self, indices, grads, weights):
        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = self.optimizer.create_state(i, w)
        self.optimizer.update_multi(indices, weights, grads,
                                    [self.states[i] for i in indices])


def get_updater(optimizer):
    return Updater(optimizer)

"""Optimizers (reference: mxnet_tpu/optimizer.py): SGD, ccSGD (SGD's
alias), NAG, SGLD, DCASGD, Adam, AdaGrad, RMSProp, AdaDelta and Test.

The same registry and ``Updater`` closure design as the reference. SGD and
Adam call the fused update ops of :mod:`mxnet_tpu_torch.ops.tensor`
(``sgd_update``, ``sgd_mom_update``, ``adam_update``), the others write the
reference's rule in torch ops, one parameter at a time; each rule rebinds
the weight and state NDArrays to the new tensors. SGLD draws its noise from
a ``torch.Generator`` (its own, or the package's generator of the weight's
device). ``Updater.get_states``/``set_states`` pickle the states as numpy
arrays by index (the JAX package pickles its own NDArrays, which this
package cannot read). lr/wd multipliers (``__lr_mult__``/``__wd_mult__``
attributes of the symbol, or set by name), ``param_idx2name``,
``clip_gradient``, ``rescale_grad``, ``lr_scheduler`` (read at
``num_update``) and ``begin_num_update`` follow the reference. ``update_multi`` runs the
per-parameter ops in turn (the split path).

The fused training step (:mod:`mxnet_tpu_torch.module.step_graph`) takes
the reference's ``_tree_update`` rules instead (SGD and ccSGD, NAG, Adam,
AdaGrad, Test; the others have none, so they keep the split path): each
writes one parameter's weight and state in place, with the learning rate
and weight decay as 0-d fp32 tensors on the weight's device, so a captured
step reads new rates from the same memory. ``plan_multi`` plans the rates
of one such update of many parameters without moving the update counts,
``advance_counts`` moves them once the update is installed, and
``plan_multi_n`` plans ``n`` updates in a row (each installed update then
moves the counts), so a stepping ``lr_scheduler`` and Adam's bias
correction see the same ``num_update`` sequence on every path.
"""
from __future__ import annotations

import math
import pickle

import numpy as np

from .base import MXNetError
from .ndarray import NDArray, array, zeros

__all__ = ["Optimizer", "SGD", "ccSGD", "NAG", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "DCASGD", "SGLD", "Test", "create", "register",
           "Updater", "get_updater"]

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

    def _step(self, index, grad):
        """lr, wd and the rescaled, clipped gradient tensor of one update;
        advances the update count."""
        import torch

        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        g = grad.data * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return lr, wd, g

    def update_multi(self, indices, weights, grads, states):
        """Update many parameters, one after another."""
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update(i, w, g, s)

    # -- the fused step's update (reference: optimizer.py:103-218) -----------
    # ``_tree_update(w, g, s, lr, wd)`` writes the weight tensor ``w`` and the
    # state's leaves ``s`` in place; None means no fused rule
    _tree_update = None

    def _fused_lr_scale(self, index):
        """The learning rate's scale after the update count moved (Adam's
        bias correction)."""
        return 1.0

    def plan_multi(self, indices):
        """The (lrs, wds) of one fused update of ``indices``, as float32,
        without moving the update counts: ``_get_lr`` and ``_update_count``
        interleave as in the per-parameter loop, and the scale of
        :meth:`_fused_lr_scale` reads the count after the increment."""
        saved_counts = dict(self._index_update_count)
        saved_num = self.num_update
        base_lrs, wds = [], []
        for i in indices:
            base_lrs.append(self._get_lr(i))
            wds.append(np.float32(self._get_wd(i)))
            self._update_count(i)
        lrs = tuple(np.float32(b * self._fused_lr_scale(i))
                    for b, i in zip(base_lrs, indices))
        self._index_update_count = saved_counts
        self.num_update = saved_num
        return lrs, tuple(wds)

    def advance_counts(self, indices):
        for i in indices:
            self._update_count(i)

    def plan_multi_n(self, indices, n):
        """The (lrs, wds) of ``n`` fused updates in a row, as ``n`` calls of
        :meth:`plan_multi` and :meth:`advance_counts` would see them,
        without moving the counts: two lists of ``n`` tuples."""
        saved_counts = dict(self._index_update_count)
        saved_num = self.num_update
        lrs_steps, wds_steps = [], []
        try:
            for _ in range(n):
                lrs, wds = self.plan_multi(indices)
                lrs_steps.append(lrs)
                wds_steps.append(wds)
                self.advance_counts(indices)
        finally:
            self._index_update_count = saved_counts
            self.num_update = saved_num
        return lrs_steps, wds_steps

    def _clip(self, g):
        import torch

        if self.clip_gradient is not None:
            return torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    @staticmethod
    def _state_leaves(state):
        """The tensors of a ``create_state`` result (None, an NDArray or a
        tuple of them)."""
        if state is None:
            return ()
        if isinstance(state, NDArray):
            return (state.data,)
        return tuple(s.data for s in state)


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

    def _tree_update(self, w, g, s, lr, wd):
        g = self._clip(g * self.rescale_grad) + wd * w
        if s:
            s[0].mul_(self.momentum).sub_(lr * g)
            w.add_(s[0])
        else:
            w.sub_(lr * g)


ccSGD = SGD   # the reference's C++ SGD: the same rule
_REGISTRY["ccsgd"] = SGD


@register
class NAG(SGD):
    """Nesterov accelerated SGD (reference: optimizer.py ``NAG``)."""

    def update(self, index, weight, grad, state):
        lr, wd, g = self._step(index, grad)
        w = weight.data
        if state is not None:
            mom = self.momentum * state.data + g + wd * w
            state._data = mom
            weight._data = w - lr * (g + self.momentum * mom + wd * w)
        else:
            weight._data = w - lr * (g + wd * w)

    def _tree_update(self, w, g, s, lr, wd):
        g = self._clip(g * self.rescale_grad)
        wdw = wd * w
        if s:
            s[0].mul_(self.momentum).add_(g).add_(wdw)
            w.sub_(lr * (g + self.momentum * s[0] + wdw))
        else:
            w.sub_(lr * (g + wdw))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: optimizer.py
    ``SGLD``): half a gradient step plus Gaussian noise of variance lr,
    drawn from ``generator`` (default: the package's generator of the
    weight's device)."""

    def __init__(self, generator=None, **kwargs):
        super().__init__(**kwargs)
        self.generator = generator

    def _normal(self, weight):
        import torch

        from . import random as _random

        gen = self.generator or _random.generator(weight.data.device)
        return torch.randn(weight.shape, generator=gen,
                           dtype=weight.data.dtype, device=weight.data.device)

    def update(self, index, weight, grad, state):
        lr, wd, g = self._step(index, grad)
        noise = self._normal(weight) * math.sqrt(lr)
        w = weight.data
        weight._data = w - lr / 2 * (g + wd * w) + noise


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference: optimizer.py
    ``DCASGD``): the state is the momentum (None without) and the weight of
    the previous update."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return (None, weight.copy())
        return (zeros(weight.shape, weight.context), weight.copy())

    def update(self, index, weight, grad, state):
        lr, wd, g = self._step(index, grad)
        mon, previous = state
        w = weight.data
        delta = -lr * (g + wd * w + self.lamda * g * g * (w - previous.data))
        if mon is not None:
            mon._data = mon.data * self.momentum + delta
            delta = mon.data
        previous._data = w
        weight._data = w + delta


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

    def _fused_lr_scale(self, index):
        t = self._index_update_count[index]
        return math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)

    def _tree_update(self, w, g, s, lr, wd):
        import torch

        mean, var = s
        g = self._clip(g * self.rescale_grad + wd * w)
        mean.mul_(self.beta1).add_((1 - self.beta1) * g)
        var.mul_(self.beta2).add_((1 - self.beta2) * torch.square(g))
        w.sub_(lr * mean / (torch.sqrt(var) + self.epsilon))


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference: optimizer.py ``AdaGrad``): the state is the sum
    of squared gradients."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        import torch

        lr, wd, g = self._step(index, grad)
        state._data = state.data + g * g
        w = weight.data
        weight._data = w - lr * (
            g / torch.sqrt(state.data + self.float_stable_eps) + wd * w)

    def _tree_update(self, w, g, s, lr, wd):
        import torch

        g = self._clip(g * self.rescale_grad)
        s[0].add_(g * g)
        w.sub_(lr * (g / torch.sqrt(s[0] + self.float_stable_eps) + wd * w))


@register
class RMSProp(Optimizer):
    """RMSProp, Graves' centred form by default (reference: optimizer.py
    ``RMSProp``): the state is (n, g, delta)."""

    def __init__(self, learning_rate=0.002, gamma1=0.95, gamma2=0.9,
                 epsilon=1e-4, centered=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.epsilon = epsilon
        self.centered = centered

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),   # n
                zeros(weight.shape, weight.context),   # g
                zeros(weight.shape, weight.context))   # delta

    def update(self, index, weight, grad, state):
        import torch

        lr, wd, g = self._step(index, grad)
        n, g_bar, delta = state
        g = g + wd * weight.data
        n._data = (1 - self.gamma1) * g * g + self.gamma1 * n.data
        if self.centered:
            g_bar._data = (1 - self.gamma1) * g + self.gamma1 * g_bar.data
            delta._data = self.gamma2 * delta.data - lr * g / torch.sqrt(
                n.data - g_bar.data * g_bar.data + self.epsilon)
        else:
            delta._data = self.gamma2 * delta.data - lr * g / torch.sqrt(
                n.data + self.epsilon)
        weight._data = weight.data + delta.data


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference: optimizer.py ``AdaDelta``): no learning rate;
    the state is the running means of squared gradients and updates."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros(weight.shape, weight.context),
                zeros(weight.shape, weight.context))

    def update(self, index, weight, grad, state):
        import torch

        _, wd, g = self._step(index, grad)
        acc_g, acc_delta = state
        acc_g._data = self.rho * acc_g.data + (1 - self.rho) * g * g
        current_delta = (torch.sqrt(acc_delta.data + self.epsilon)
                         / torch.sqrt(acc_g.data + self.epsilon)) * g
        acc_delta._data = (self.rho * acc_delta.data + (1 - self.rho)
                           * current_delta * current_delta)
        w = weight.data
        weight._data = w - current_delta - wd * w


@register
class Test(Optimizer):
    """A fixed rule for plumbing tests (reference: optimizer.py ``Test``):
    the weight adds the rescaled gradient, the state copies the weight.
    Each update counts, as in the reference's multi-parameter update (the
    path ``Module.update`` takes)."""

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        weight._data = weight.data + grad.data * self.rescale_grad
        state._data = weight.data

    def _tree_update(self, w, g, s, lr, wd):
        w.add_(g * self.rescale_grad)
        s[0].copy_(w)


def _state_to_numpy(state):
    if state is None:
        return None
    if isinstance(state, NDArray):
        return state.asnumpy()
    if isinstance(state, np.ndarray):
        return state
    return tuple(_state_to_numpy(s) for s in state)


def _copy_state(state):
    if state is None:
        return None
    if isinstance(state, (NDArray, np.ndarray)):
        return state.copy()
    return tuple(_copy_state(s) for s in state)


def _state_from_numpy(state, ctx):
    if state is None or isinstance(state, NDArray):
        return state
    if isinstance(state, np.ndarray):
        return array(state, ctx, dtype=state.dtype)
    return tuple(_state_from_numpy(s, ctx) for s in state)


class Updater:
    """Applies an optimizer with per-index state (reference: optimizer.py
    ``Updater``). States restored by ``set_states`` move to their weight's
    device at its next update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def _state(self, index, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        else:
            self.states[index] = _state_from_numpy(self.states[index],
                                                   weight.context)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update(index, weight, grad, self._state(index, weight))

    def update_multi(self, indices, grads, weights):
        states = [self._state(i, w) for i, w in zip(indices, weights)]
        self.optimizer.update_multi(indices, weights, grads, states)

    def copy_states(self):
        """A copy of every state on its device (a snapshot later updates do
        not change)."""
        return {i: _copy_state(s) for i, s in self.states.items()}

    def get_states(self):
        """The states as bytes: a pickle of ``{index: None | array |
        tuple}``, each array a numpy copy."""
        return pickle.dumps({i: _state_to_numpy(s)
                             for i, s in self.states.items()})

    def set_states(self, states):
        """Restore states written by :meth:`get_states` (this package's
        files only: unpickling runs code, so read no file from elsewhere)."""
        self.states = pickle.loads(states)


def get_updater(optimizer):
    return Updater(optimizer)

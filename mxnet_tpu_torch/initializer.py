"""Weight initializers (reference: mxnet_tpu/initializer.py).

An initializer is called with a parameter's name and its NDArray and fills
the array in place of its old value; the name decides how (the reference's
``__call__``): ``*_bias`` and ``*_beta`` get 0, ``*_gamma`` 1, ``*_weight``
the initializer's own rule, and BatchNorm's moving statistics their start
values (``*_moving_mean`` and ``*_moving_avg`` 0, ``*_moving_var`` 1), the
RNN op's flat ``*_parameters`` vector U(-0.07, 0.07) from ``np.random`` (the
reference's draw: its flat shape hides the fans), and the RNN cells' and
op's states (``*begin_state*``, ``*_state``, ``*_state_cell``, ``*_init_h``,
``*_init_c``) 0.
Random draws come from :mod:`mxnet_tpu_torch.random`, the
``torch.Generator`` of the array's device, so one ``mx.random.seed`` gives
the same weights again. They are not the reference's threefry draws:
parity tests feed weights as numpy arrays.
"""
from __future__ import annotations

import numpy as np

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier"]


class Initializer:
    """Base initializer; subclasses implement ``_init_weight``."""

    def __call__(self, name, arr):
        if not isinstance(name, str):
            raise TypeError("name must be a string")
        if name.endswith("_bias"):
            self._init_bias(name, arr)
        elif name.endswith("_gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("_beta"):
            self._init_beta(name, arr)
        elif name.endswith("_weight"):
            self._init_weight(name, arr)
        elif name.endswith(("_moving_mean", "_moving_avg")):
            self._init_zero(name, arr)
        elif name.endswith("_moving_var"):
            self._init_one(name, arr)
        elif name.endswith("_parameters"):
            self._init_rnn_parameters(name, arr)
        elif name.endswith(("_init_c", "_init_h", "_state", "_state_cell")) \
                or "begin_state" in name:
            self._init_zero(name, arr)
        else:
            self._init_default(name, arr)

    @staticmethod
    def _uniform(arr, low, high):
        return _random.uniform(low, high, arr.shape, ctx=arr.context)

    @staticmethod
    def _normal(arr, loc, scale):
        return _random.normal(loc, scale, arr.shape, ctx=arr.context)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_rnn_parameters(self, _, arr):
        arr[:] = np.random.uniform(-0.07, 0.07, arr.shape).astype(np.float32)

    _init_bias = _init_zero
    _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        raise MXNetError(
            f"Unknown initialization pattern for {name}; parameter names "
            "should end with _weight/_bias/_gamma/_beta")


class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0
    _init_default = _init_weight


class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0
    _init_default = _init_weight


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value
    _init_default = _init_weight


class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = self._uniform(arr, -self.scale, self.scale)


class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = self._normal(arr, 0.0, self.sigma)


class Xavier(Initializer):
    """Uniform or gaussian with variance scaled by the fans: ``magnitude``
    over their average, fan-in or fan-out (``factor_type`` avg/in/out)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, _, arr):
        shape = arr.shape
        if len(shape) == 3:
            # layer- or expert-stacked (stack, out, in): fans of one slice
            fan_in, fan_out = shape[2], shape[1]
        else:
            hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
            fan_in = shape[1] * hw_scale if len(shape) > 1 else hw_scale
            fan_out = shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("Incorrect factor type")
        scale = float(np.sqrt(self.magnitude / factor))
        if self.rnd_type == "uniform":
            arr[:] = self._uniform(arr, -scale, scale)
        elif self.rnd_type == "gaussian":
            arr[:] = self._normal(arr, 0.0, scale)
        else:
            raise MXNetError("Unknown random type")

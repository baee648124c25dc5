"""`mx.nd`: the imperative namespace, the core NDArray API plus one eager
function per registered op (reference: mxnet_tpu/nd.py).

Kept apart from :mod:`mxnet_tpu_torch.ndarray` so that generated op names
that collide with Python builtins (``slice``, ``sum``, ``max``, ...) never
shadow them inside the core module.
"""
from .ndarray import *  # noqa: F401,F403
from .ndarray import NDArray  # noqa: F401
from .ops import make_imperative_namespace as _mk

_mk(globals())
del _mk

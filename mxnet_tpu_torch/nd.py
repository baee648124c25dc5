"""`mx.nd`: the imperative namespace (reference: mxnet_tpu/nd.py). Only the
core NDArray API is ported; imperative op calls wait for later work."""
from .ndarray import *  # noqa: F401,F403
from .ndarray import NDArray  # noqa: F401

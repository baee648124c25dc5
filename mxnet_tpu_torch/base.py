"""Foundation utilities for the PyTorch port (reference: mxnet_tpu/base.py).

The execution substrate is PyTorch: tensor code runs eagerly on the device a
:class:`~mxnet_tpu_torch.context.Context` names, and the package's own CUDA
kernels load through ``ctypes`` from ``_build/`` at first use.
"""
from __future__ import annotations

__all__ = ["MXNetError"]


class MXNetError(Exception):
    """Error raised by the framework (reference: python/mxnet/base.py:42)."""

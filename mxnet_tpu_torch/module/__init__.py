"""Module API (reference: mxnet_tpu/module): ``Module`` on one device."""
from .base_module import BaseModule
from .module import Module

__all__ = ["BaseModule", "Module"]

"""Module API (reference: mxnet_tpu/module): ``Module`` on one device and
``BucketingModule`` over it."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BucketingModule", "Module"]

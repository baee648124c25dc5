"""Operator package: registry plus the op library ported so far.

Importing this package registers the ops (reference: mxnet_tpu/ops).
"""
from __future__ import annotations

from .registry import OpCtx, coerce_attrs, get_op, list_ops, register_op

from . import tensor as _tensor  # noqa: F401  (registration side effects)
from . import nn as _nn  # noqa: F401
from . import attention as _attention  # noqa: F401

__all__ = ["OpCtx", "coerce_attrs", "get_op", "list_ops", "register_op"]

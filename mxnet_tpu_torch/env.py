"""Typed environment-variable accessors (reference: mxnet_tpu/env.py).

* ``get_bool``: ``"1"/"true"/"yes"/"on"`` (any case) is True,
  ``"0"/"false"/"no"/"off"`` False, unset, empty or anything else the
  default.
* ``get_float``: the parsed value, or the default when unset, empty or
  unparseable; ``strict=True`` raises :class:`~mxnet_tpu_torch.base.
  MXNetError` for an unparseable value instead.
"""
from __future__ import annotations

import os

__all__ = ["get_bool", "get_float"]

_TRUE = frozenset(("1", "true", "yes", "on"))
_FALSE = frozenset(("0", "false", "no", "off"))


def get_bool(name, default=False):
    """Boolean knob (the framework-wide ``=1`` convention)."""
    val = os.environ.get(name)
    if not val:
        return default
    val = val.strip().lower()
    if val in _TRUE:
        return True
    if val in _FALSE:
        return False
    return default


def get_float(name, default=0.0, strict=False):
    """Float knob; ``default`` when unset/empty (or unparseable, unless
    ``strict``)."""
    val = os.environ.get(name)
    if not val:
        return default
    try:
        return float(val)
    except ValueError:
        if strict:
            from .base import MXNetError

            raise MXNetError(f"{name}={val!r} is not a number") from None
        return default

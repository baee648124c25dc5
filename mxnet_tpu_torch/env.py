"""Typed environment-variable accessors (reference: mxnet_tpu/env.py).

* ``get_bool``: ``"1"/"true"/"yes"/"on"`` (any case) is True,
  ``"0"/"false"/"no"/"off"`` False, unset, empty or anything else the
  default.
* ``get_float``/``get_int``: the parsed value, or the default when
  unset, empty or unparseable; ``strict=True`` raises
  :class:`~mxnet_tpu_torch.base.MXNetError` for an unparseable value
  instead.
* ``get_str``: the raw value, or the default when unset or empty.
* ``compile_cache_dir``: the reference's ``compile_cache.configured_dir``
  (``MXNET_COMPILE_CACHE_DIR``, else ``MXTPU_COMPILE_CACHE``). The port
  has no compile cache; the directory only locates the serving shape
  manifest.
"""
from __future__ import annotations

import os

__all__ = ["get_bool", "get_float", "get_int", "get_str",
           "compile_cache_dir"]

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


def get_str(name, default=None):
    """Raw string value; ``default`` when unset or empty."""
    val = os.environ.get(name)
    return val if val else default


def _num(name, default, cast, strict):
    val = os.environ.get(name)
    if not val:
        return default
    try:
        return cast(val)
    except ValueError:
        if strict:
            from .base import MXNetError

            raise MXNetError(f"{name}={val!r} is not a number") from None
        return default


def get_int(name, default=0, strict=False):
    """Integer knob; ``default`` when unset/empty (or unparseable, unless
    ``strict``)."""
    return _num(name, default, int, strict)


def get_float(name, default=0.0, strict=False):
    """Float knob; ``default`` when unset/empty (or unparseable, unless
    ``strict``)."""
    return _num(name, default, float, strict)


def compile_cache_dir():
    """The compile-cache directory the environment names, or None."""
    return get_str("MXNET_COMPILE_CACHE_DIR") \
        or get_str("MXTPU_COMPILE_CACHE")

"""Attribute scoping for symbols (reference: python/mxnet/attribute.py AttrScope).

``with mx.AttrScope(ctx_group='dev1'):`` tags every symbol created inside the
block — the mechanism behind manual model-parallel placement
(reference: example/model-parallel-lstm/lstm.py:48-112, SURVEY §2.2).
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("AttrScope values must be strings")
        self._attr = kwargs

    def get(self, attr: dict | None) -> dict:
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr or {}

    def __enter__(self):
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        self._old = AttrScope._current.value
        merged = self._old._attr.copy()
        merged.update(self._attr)
        new = AttrScope()
        new._attr = merged
        AttrScope._current.value = new
        return self

    def __exit__(self, *args):
        AttrScope._current.value = self._old

    @classmethod
    def current(cls) -> "AttrScope":
        if not hasattr(cls._current, "value"):
            cls._current.value = AttrScope()
        return cls._current.value

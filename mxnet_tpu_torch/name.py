"""Automatic symbol naming (reference: python/mxnet/name.py NameManager/Prefix)."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix"]


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter: dict[str, int] = {}
        self._old = None

    def get(self, name: str | None, hint: str) -> str:
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = f"{hint}{self._counter[hint]}"
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old = NameManager.current()
        NameManager._current.value = self
        return self

    def __exit__(self, *args):
        NameManager._current.value = self._old

    @classmethod
    def current(cls) -> "NameManager":
        if not hasattr(cls._current, "value"):
            cls._current.value = NameManager()
        return cls._current.value


class Prefix(NameManager):
    """Prepends a prefix to every auto-generated name."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name

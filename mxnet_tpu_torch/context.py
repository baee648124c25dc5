"""Device contexts mapped onto ``torch.device``s.

The reference's ``Context{dev_type, dev_id}`` names a CUDA device or the CPU.
Here ``gpu(i)`` is ``torch.device("cuda", i)`` and ``cpu()`` the host
(``cpu_pinned`` too: pinning is a property of a host allocation). The
default context is ``gpu(0)``: the port's entry points run on the card unless
the caller passes ``mx.cpu()``. Asking for a CUDA device where there is none
raises; nothing falls back to the CPU. Building a Context does not touch CUDA,
so the package imports on hosts without a card.
"""
from __future__ import annotations

import threading

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus"]


class Context:
    """A device context. Usable as a ``with`` block to set the default device."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}
    _default = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in self.devstr2type:
                raise MXNetError(f"unknown device type {device_type!r}")
            self.device_typeid = self.devstr2type[device_type]
            self.device_id = device_id

    @property
    def device_type(self) -> str:
        return self.devtype2str[self.device_typeid]

    def __eq__(self, other):
        return (
            isinstance(other, Context)
            and self.device_typeid == other.device_typeid
            and self.device_id == other.device_id
        )

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __enter__(self):
        if not hasattr(Context._default, "stack"):
            Context._default.stack = []
        Context._default.stack.append(self)
        return self

    def __exit__(self, *args):
        Context._default.stack.pop()

    @property
    def torch_device(self):
        """The ``torch.device`` this context names; raises for a CUDA
        device that this host does not have."""
        import torch

        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"context {self} needs a CUDA device and none is available; "
                "pass mx.cpu() to run on the host")
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError(
                f"context {self}: only {torch.cuda.device_count()} CUDA "
                "device(s) present")
        return torch.device("cuda", self.device_id)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def num_gpus() -> int:
    """CUDA devices on this host (the reference's ``num_tpus``); does not
    initialise CUDA."""
    import torch

    return torch.cuda.device_count()


def context_of(device) -> Context:
    """The Context naming a ``torch.device``."""
    if device.type == "cuda":
        return gpu(device.index or 0)
    return cpu()


def current_context() -> Context:
    stack = getattr(Context._default, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", 0)

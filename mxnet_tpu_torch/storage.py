"""Device-memory introspection (reference: mxnet_tpu/storage.py).

The reference's pooled allocators (src/storage/pooled_memory_storage.h) are
PyTorch's caching allocator here. What stays framework-visible is
introspection and lifetime control: :func:`memory_info` reads
``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info`` for each card,
the role of MXGetGPUMemoryInformation. The CPU has no allocator statistics,
so its figures, and :func:`live_bytes`, come from a walk of the live
tensors, each storage counted once.
"""
from __future__ import annotations

import contextlib

__all__ = ["memory_info", "live_bytes", "live_bytes_per_device", "gc",
           "no_collection"]


def _devices():
    import torch

    devs = [torch.device("cpu")]
    if torch.cuda.is_available():
        devs += [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    return devs


def _key(device) -> str:
    from .context import context_of

    return str(context_of(device))


def memory_info(device=None):
    """Per-device memory statistics: ``bytes_in_use``, ``peak_bytes_in_use``
    and ``bytes_limit``, keyed by context name (``gpu(0)``, ``cpu(0)``).
    ``device`` is a Context or ``torch.device`` (default: every device). On
    the CPU, ``bytes_in_use`` is the live tensors' bytes and the other two
    are None."""
    import torch

    from .context import Context

    if isinstance(device, Context):
        device = device.torch_device
    devs = [torch.device(device)] if device is not None else _devices()
    out = {}
    for d in devs:
        if d.type == "cuda":
            stats = torch.cuda.memory_stats(d)
            _, total = torch.cuda.mem_get_info(d)
            out[_key(d)] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                "bytes_limit": total,
            }
        else:
            out[_key(d)] = {
                "bytes_in_use": live_bytes_per_device().get(_key(d), 0),
                "peak_bytes_in_use": None,
                "bytes_limit": None,
            }
    return out


def _live_storages():
    """(device, storage address, bytes) of every live tensor's storage,
    each storage once."""
    import gc as _pygc

    import torch

    seen = set()
    for obj in _pygc.get_objects():
        # type(), not isinstance(): isinstance reads __class__, which some
        # lazily deprecated objects answer with a warning
        if not issubclass(type(obj), torch.Tensor) \
                or obj.device.type == "meta":
            continue
        try:
            storage = obj.untyped_storage()
        except RuntimeError:   # tensors with no storage of their own
            continue
        ident = (obj.device, storage.data_ptr())
        if ident in seen:
            continue
        seen.add(ident)
        yield obj.device, storage.nbytes()


def live_bytes() -> int:
    """Bytes held by live tensors in this process, each storage counted
    once (a view adds nothing to its base)."""
    return sum(n for _, n in _live_storages())


def live_bytes_per_device():
    """``{context name: bytes}`` of live tensors' storages per device."""
    per: dict = {}
    for device, n in _live_storages():
        key = _key(device)
        per[key] = per.get(key, 0) + n
    return per


def gc():
    """Free what nothing references: a Python collection, then the caching
    allocator's unused blocks on every card (role of the reference's
    Storage::Free sweep)."""
    import gc as _pygc

    import torch

    _pygc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


@contextlib.contextmanager
def no_collection():
    """No automatic Python collection in any thread while the block runs (a
    CUDA graph's capture). A collection runs the finalizers of whatever it
    frees on the thread that triggered it: a dropped binding's CUDA graph,
    its pool and its tensors. A graph destroyed on the capturing thread
    while the capture is under way invalidates the capture, and PyTorch's
    destructor only warns, so the capture fails later at an unrelated op.
    The garbage is collected after the block, at the next collection."""
    import gc as _pygc

    was = _pygc.isenabled()
    _pygc.disable()
    try:
        yield
    finally:
        if was:
            _pygc.enable()

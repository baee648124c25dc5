"""Random numbers for the imperative API (reference: mxnet_tpu/random.py).

The reference seeds per-device mshadow Random resources via MXRandomSeed;
the JAX package keeps one global PRNG key. Here each device has its own
explicit ``torch.Generator``, made on first use and seeded from the global
seed (0 until :func:`seed` is called) and the device, so one seed gives
reproducible draws on every device and different devices draw independent
streams. The ``_sample_*`` ops draw from these. PyTorch's generators
(mt19937 on the CPU, Philox on the card) do not give JAX's threefry bits:
the distributions agree, the values do not.

:func:`step_seed` is a host-side stream of 63-bit seeds, restarted by
:func:`seed`: each training walk takes one and seeds its random nodes'
generators from it and their indices (:func:`mix`), so a step's random
numbers need no read back from the device.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["seed", "generator", "uniform", "normal", "randint",
           "step_seed", "mix"]

_LOCK = threading.Lock()
_SEED = 0
_GENERATORS: dict = {}   # torch.device -> torch.Generator
_STEPS = [0]             # seeds taken from the step-seed stream
_MASK64 = (1 << 64) - 1


def seed(seed_state: int):
    """Seed every device's generator and the step-seed stream (reference:
    mx.random.seed -> MXRandomSeed). Generators are re-made from the new
    seed at next use."""
    global _SEED
    with _LOCK:
        _SEED = int(seed_state)
        _GENERATORS.clear()
        _STEPS[0] = 0


def mix(base, index):
    """splitmix64 of ``base`` and ``index``: a 63-bit seed."""
    x = (base + 0x9E3779B97F4A7C15 * (index + 1)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def step_seed():
    """The next seed of the host's step-seed stream."""
    with _LOCK:
        _STEPS[0] += 1
        return mix(_SEED ^ 0x5EED5EED5EED5EED, _STEPS[0])


def _device_seed(base: int, device) -> int:
    """A 63-bit seed for ``device`` from ``base``: distinct devices get
    unrelated seeds."""
    kind = {"cpu": 0, "cuda": 1}[device.type]
    words = [base & 0xFFFFFFFF, (base >> 32) & 0xFFFFFFFF, kind,
             device.index or 0]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1]))


def generator(device):
    """The generator of ``device`` (a ``torch.device``); None for ``meta``
    tensors, which hold no values."""
    import torch

    device = torch.device(device)
    if device.type == "meta":
        return None
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _LOCK:
        gen = _GENERATORS.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_device_seed(_SEED, device))
            _GENERATORS[device] = gen
        return gen


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def uniform(low=0.0, high=1.0, shape=(1,), ctx=None, dtype="float32"):
    """Draws from U[low, high) on ``ctx`` (default: the current context)."""
    from .ops import imperative_invoke

    return imperative_invoke("_sample_uniform", low=low, high=high,
                             shape=_shape(shape), ctx=ctx, dtype=dtype)


def normal(loc=0.0, scale=1.0, shape=(1,), ctx=None, dtype="float32"):
    """Draws from N(loc, scale^2), float32, on ``ctx``."""
    from .ops import imperative_invoke

    return imperative_invoke("_sample_normal", loc=loc, scale=scale,
                             shape=_shape(shape), ctx=ctx)


def randint(low, high, shape=(1,), ctx=None, dtype="int32"):
    """Integers uniform on [low, high), int32 as in the reference."""
    import torch

    from .context import current_context
    from .ndarray import NDArray

    device = (ctx if ctx is not None else current_context()).torch_device
    return NDArray(torch.randint(int(low), int(high), _shape(shape),
                                 generator=generator(device), device=device,
                                 dtype=torch.int32))

"""NDArray: an n-dimensional array over a ``torch.Tensor`` on one device.

Reference: mxnet_tpu/ndarray.py. There the payload is an immutable JAX
array that in-place writes rebind; here it is a ``torch.Tensor`` and
``arr[:] = value`` writes into it in place, so an executor that holds the
same tensor sees the write. CUDA work is asynchronous on PyTorch's current
stream; ``asnumpy`` and ``waitall`` synchronise.

Save/Load use the reference's binary container (magic ``MXTP``), so a file
written by either package loads in the other.
"""
from __future__ import annotations

import struct

import numpy as np

from .base import MXNetError
from .context import Context, context_of, current_context

__all__ = ["NDArray", "array", "zeros", "empty", "save", "load",
           "load_frombuffer", "waitall"]

_DTYPE_NAMES = ("float32", "float64", "float16", "bfloat16", "uint8", "int8",
                "int32", "int64", "bool")


def _torch_dtype(dtype):
    """torch dtype for a name, numpy dtype or torch dtype (None: float32)."""
    import torch

    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPE_NAMES:
        raise MXNetError(f"unsupported dtype {dtype!r}")
    return getattr(torch, name)


def _dtype_name(tdtype) -> str:
    return str(tdtype).replace("torch.", "")


class NDArray:
    """An array on a device (reference: include/mxnet/ndarray.h:33)."""

    __slots__ = ("_data",)

    def __init__(self, data):
        import torch

        if not isinstance(data, torch.Tensor):
            raise TypeError(f"NDArray wraps a torch.Tensor, got {type(data)}")
        self._data = data

    # -- basic properties ----------------------------------------------------
    @property
    def shape(self) -> tuple:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    @property
    def data(self):
        """The underlying ``torch.Tensor``."""
        return self._data

    def __repr__(self):
        return f"<NDArray {'x'.join(map(str, self.shape))} @{self.context}>"

    def asnumpy(self) -> np.ndarray:
        """Blocking copy to host. bfloat16, which numpy lacks, comes back
        as float32."""
        import torch

        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def as_in_context(self, ctx: Context) -> "NDArray":
        """This array if it lies on ``ctx``, else a copy there."""
        if ctx == self.context:
            return self
        return NDArray(self._data.to(ctx.torch_device, copy=True))

    def reshape(self, shape) -> "NDArray":
        """View with MXNet's reshape codes (see :func:`infer_reshape`)."""
        if isinstance(shape, int):
            shape = (shape,)
        return NDArray(self._data.reshape(infer_reshape(self.shape, shape)))

    # -- writes ----------------------------------------------------------------
    def __setitem__(self, key, value):
        """In-place write. ``arr[:] = v`` broadcasts ``v`` (scalar, numpy
        array or NDArray) over the whole array."""
        import torch

        if isinstance(value, NDArray):
            value = value._data
        elif not np.isscalar(value):
            value = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
        if isinstance(key, slice) and key == slice(None):
            if np.isscalar(value):
                self._data.fill_(value)
            else:
                self._data.copy_(value.to(self._data.dtype).expand(self.shape))
        else:
            self._data[key] = value


def infer_reshape(old, new):
    """MXNet reshape codes (reference: src/operator/tensor/matrix_op-inl.h
    ReshapeParam): 0 copies the input dim, -1 infers one dim from the rest,
    -2 copies all remaining input dims, -3 merges two consecutive input dims,
    -4 splits one input dim into the two that follow it (one may be -1)."""
    old, new = tuple(old), tuple(new)
    out = []
    i = 0  # index into old
    j = 0  # index into new
    while j < len(new):
        d = new[j]
        if d == 0:
            out.append(old[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(old[i:])
            i = len(old)
        elif d == -3:
            out.append(old[i] * old[i + 1])
            i += 2
        elif d == -4:
            a, b = new[j + 1], new[j + 2]
            if a == -1:
                a = old[i] // b
            if b == -1:
                b = old[i] // a
            if a * b != old[i]:
                raise MXNetError(f"reshape -4: {a}x{b} does not split {old[i]}")
            out.extend((a, b))
            i += 1
            j += 2
        else:
            out.append(d)
            i += 1
        j += 1
    if out.count(-1) > 1:
        raise MXNetError(f"reshape {new}: more than one dim to infer")
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(old)) if old else 1
        out[out.index(-1)] = total // known
    return tuple(out)


# -- factory functions (reference: python/mxnet/ndarray.py zeros/ones/array) --

def _device(ctx):
    return (ctx if ctx is not None else current_context()).torch_device


def array(source, ctx: Context | None = None, dtype=None) -> NDArray:
    """Create from array-like. Default dtype is float32 unless `source` is an
    NDArray (reference: python/mxnet/ndarray.py array docstring)."""
    import torch

    if isinstance(source, NDArray):
        src = source._data
        tdt = _torch_dtype(dtype) if dtype is not None else src.dtype
    else:
        src = torch.from_numpy(np.ascontiguousarray(np.asarray(source)))
        tdt = _torch_dtype(dtype)
    return NDArray(src.to(device=_device(ctx), dtype=tdt, copy=True))


def zeros(shape, ctx=None, dtype=None) -> NDArray:
    import torch

    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.zeros(tuple(shape), dtype=_torch_dtype(dtype),
                               device=_device(ctx)))


def empty(shape, ctx=None, dtype=None) -> NDArray:
    import torch

    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.empty(tuple(shape), dtype=_torch_dtype(dtype),
                               device=_device(ctx)))


def waitall():
    """Block until all queued device work completes (reference:
    MXNDArrayWaitAll)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# -- serialization (role of NDArray::Save/Load, ndarray.h:151) ----------------

_MAGIC = b"MXTP"
_FMT_VERSION = 1


def _raw_bytes(t) -> bytes:
    import torch

    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def save(fname: str, data):
    """Save a list or dict of NDArrays to the MXTP binary container."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    else:
        names, arrays = [""] * len(data), list(data)
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<II", _FMT_VERSION, len(arrays)))
        for name, arr in zip(names, arrays):
            nb = name.encode()
            dt = _dtype_name(arr.dtype).encode()
            f.write(struct.pack("<I", len(nb)) + nb)
            f.write(struct.pack("<I", len(dt)) + dt)
            f.write(struct.pack("<I", arr.ndim))
            f.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
            raw = _raw_bytes(arr._data)
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)


def load(fname: str, ctx: Context | None = None):
    """Load NDArrays saved by :func:`save` (by either package); returns a
    list or dict as saved, on ``ctx`` (default: the current context)."""
    with open(fname, "rb") as f:
        return load_frombuffer(f.read(), ctx)


def load_frombuffer(buf, ctx: Context | None = None):
    """Deserialize NDArrays from an in-memory MXTP blob (reference:
    MXNDArrayLoadFromBuffer) onto ``ctx`` (default: the current context)."""
    import torch

    buf = memoryview(bytes(buf))
    if bytes(buf[:4]) != _MAGIC:
        raise MXNetError("not an MXTP NDArray blob")
    _, count = struct.unpack_from("<II", buf, 4)
    off = 12
    device = _device(ctx)
    names, arrays = [], []
    for _ in range(count):
        (nlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        name = bytes(buf[off:off + nlen]).decode()
        off += nlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        dt = bytes(buf[off:off + dlen]).decode()
        off += dlen
        (ndim,) = struct.unpack_from("<I", buf, off)
        off += 4
        shape = struct.unpack_from(f"<{ndim}q", buf, off) if ndim else ()
        off += 8 * ndim
        (nraw,) = struct.unpack_from("<Q", buf, off)
        off += 8
        tdt = _torch_dtype(dt)
        raw = bytearray(buf[off:off + nraw])
        off += nraw
        t = torch.frombuffer(raw, dtype=tdt) if nraw else \
            torch.empty(0, dtype=tdt)
        names.append(name)
        arrays.append(NDArray(t.reshape(shape).to(device)))
    if any(names):
        return dict(zip(names, arrays))
    return arrays

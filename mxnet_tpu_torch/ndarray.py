"""NDArray: an n-dimensional array over a ``torch.Tensor`` on one device.

Reference: mxnet_tpu/ndarray.py, with its value semantics. There the payload
is an immutable JAX array, and every write (``arr[:] = v``, ``arr[k] = v``,
``+=``, ``copyto``, ``alias``) rebinds the NDArray to a new payload. Here
the payload is a ``torch.Tensor`` and writes rebind the same way: no
NDArray method writes into a tensor in place. So a slice, a reshape or an
``alias`` may share memory with its parent as a torch view, yet a write to
one never shows in the other, as in the reference. An executor reads its
bound NDArrays' tensors at each ``forward``, so a write before it is seen.
The one in-place writer is ``rtc.Rtc.push``, whose contract is MXNet's.

Results keep the reference's dtypes: comparisons return the input's dtype
as 0/1, and Python scalars promote as JAX's weakly typed scalars do (torch
treats them, and 0-d tensors, the same way). CUDA work is asynchronous on
PyTorch's current stream; ``asnumpy``, ``wait_to_read`` and ``waitall``
synchronise.

Save/Load use the reference's binary container (magic ``MXTP``), so a file
written by either package loads in the other.
"""
from __future__ import annotations

import struct

import numpy as np

from .base import MXNetError
from .context import Context, context_of, current_context

__all__ = [
    "NDArray", "array", "zeros", "ones", "full", "empty", "arange",
    "concatenate", "save", "load", "load_frombuffer", "bulk_asnumpy",
    "waitall", "onehot_encode", "moveaxis",
]

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


def _operand(value, like):
    """An operand for arithmetic with tensor ``like``: an NDArray's tensor, a
    numpy array on ``like``'s device, or a Python scalar as it is."""
    import torch

    if isinstance(value, NDArray):
        return value._data
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value)).to(like.device)
    return value


def _index(key):
    """An indexing key with NDArrays replaced by their tensors."""
    if isinstance(key, NDArray):
        return key._data
    if isinstance(key, tuple):
        return tuple(k._data if isinstance(k, NDArray) else k for k in key)
    return key


class NDArray:
    """An array on a device (reference: include/mxnet/ndarray.h:33)."""

    __slots__ = ("_data", "writable")

    def __init__(self, data, *, writable: bool = True):
        import torch

        if not isinstance(data, torch.Tensor):
            raise TypeError(f"NDArray wraps a torch.Tensor, got {type(data)}")
        self._data = data
        self.writable = writable

    # -- basic properties ----------------------------------------------------
    @property
    def shape(self) -> tuple:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    ctx = context

    @property
    def data(self):
        """The underlying ``torch.Tensor``."""
        return self._data

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    def __repr__(self):
        return f"<NDArray {'x'.join(map(str, self.shape))} @{self.context}>"

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of 0-d NDArray")
        return self.shape[0]

    def _check_writable(self, what):
        if not self.writable:
            raise MXNetError(f"trying to {what} a read-only NDArray")

    def alias(self, other: "NDArray") -> "NDArray":
        """Point this array at ``other``'s tensor, with no copy. Later writes
        to either rebind only that one. Shapes and dtypes must match."""
        self._check_writable("alias into")
        if other.shape != self.shape:
            raise MXNetError(
                f"alias: shape mismatch {other.shape} vs {self.shape}")
        if other.dtype != self.dtype:
            raise MXNetError(
                f"alias: dtype mismatch {other.dtype} vs {self.dtype}")
        self._data = other._data
        return self

    # -- synchronization (reference: WaitToRead/WaitToWrite, ndarray.h:126) --
    def wait_to_read(self):
        import torch

        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        """Blocking copy to host, never a view of the array's memory (a
        bound array may be written in place later). bfloat16, which numpy
        lacks, comes back as float32."""
        import torch

        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type == "cpu":
            return t.numpy().copy()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def astype(self, dtype) -> "NDArray":
        return NDArray(self._data.to(_torch_dtype(dtype)))

    # -- copies / context movement -------------------------------------------
    def copy(self) -> "NDArray":
        return NDArray(self._data.clone())

    def copyto(self, other):
        """Copy into another array (which keeps its device and dtype) or to
        a context (reference: CopyFromTo)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError(
                    f"copyto shape mismatch {self.shape} vs {other.shape}")
            other._check_writable("copy into")
            other._data = self._data.to(device=other._data.device,
                                        dtype=other.dtype, copy=True)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device, copy=True))
        raise TypeError(f"copyto does not support {type(other)}")

    def as_in_context(self, ctx: Context) -> "NDArray":
        """This array if it lies on ``ctx``, else a copy there."""
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    # -- shape manipulation ---------------------------------------------------
    def reshape(self, shape) -> "NDArray":
        """Reshape with MXNet's codes (see :func:`infer_reshape`)."""
        if isinstance(shape, int):
            shape = (shape,)
        return NDArray(self._data.reshape(infer_reshape(self.shape, shape)))

    def broadcast_to(self, shape) -> "NDArray":
        return NDArray(self._data.expand(tuple(shape)))

    def expand_dims(self, axis) -> "NDArray":
        return NDArray(self._data.unsqueeze(axis))

    def transpose(self, axes=None) -> "NDArray":
        if axes is None:
            axes = tuple(reversed(range(self.ndim)))
        return NDArray(self._data.permute(tuple(axes)))

    def flatten(self) -> "NDArray":
        return self.reshape((self.shape[0], -1) if self.ndim > 1
                            else self.shape)

    def slice(self, start, stop) -> "NDArray":
        """[start, stop) on axis 0 (reference: NDArray::Slice)."""
        return NDArray(self._data[start:stop])

    def at(self, idx) -> "NDArray":
        """Index axis 0 (reference: NDArray::At)."""
        return NDArray(self._data[idx])

    # -- indexing -------------------------------------------------------------
    def __getitem__(self, key) -> "NDArray":
        return NDArray(self._data[_index(key)])

    def __setitem__(self, key, value):
        """Write ``value`` (scalar, numpy array or NDArray) at ``key``; the
        array is rebound to the result, as in the reference. ``arr[:] = v``
        broadcasts ``v`` over the whole array."""
        import torch

        self._check_writable("write to")
        if isinstance(value, NDArray):
            value = value._data
        elif not np.isscalar(value):
            value = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
        t = self._data
        if isinstance(key, slice) and key == slice(None):
            if np.isscalar(value):
                self._data = torch.full(t.shape, value, dtype=t.dtype,
                                        device=t.device)
            else:
                self._data = value.to(device=t.device, dtype=t.dtype) \
                    .expand(t.shape).clone()
            return
        new = t.clone()
        if not np.isscalar(value):
            value = value.to(device=t.device, dtype=t.dtype)
        new[_index(key)] = value
        self._data = new

    # -- arithmetic -----------------------------------------------------------
    def _binop(self, other, fn):
        return NDArray(fn(self._data, _operand(other, self._data)))

    def __add__(self, o):  return self._binop(o, lambda a, b: a + b)
    __radd__ = __add__
    def __sub__(self, o):  return self._binop(o, lambda a, b: a - b)
    def __rsub__(self, o): return self._binop(o, lambda a, b: b - a)
    def __mul__(self, o):  return self._binop(o, lambda a, b: a * b)
    __rmul__ = __mul__
    def __truediv__(self, o):  return self._binop(o, lambda a, b: a / b)
    def __rtruediv__(self, o): return self._binop(o, lambda a, b: b / a)
    __div__, __rdiv__ = __truediv__, __rtruediv__
    def __mod__(self, o):  return self._binop(o, lambda a, b: a % b)
    def __pow__(self, o):  return self._binop(o, lambda a, b: a ** b)
    def __neg__(self):     return NDArray(-self._data)

    def _cmp(self, o, fn):
        if not isinstance(o, (NDArray, int, float, np.ndarray)):
            return NotImplemented
        return self._binop(o, lambda a, b: fn(a, b).to(a.dtype))

    def __eq__(self, o): return self._cmp(o, lambda a, b: a == b)
    def __ne__(self, o): return self._cmp(o, lambda a, b: a != b)
    def __gt__(self, o): return self._cmp(o, lambda a, b: a > b)
    def __ge__(self, o): return self._cmp(o, lambda a, b: a >= b)
    def __lt__(self, o): return self._cmp(o, lambda a, b: a < b)
    def __le__(self, o): return self._cmp(o, lambda a, b: a <= b)

    def __hash__(self):
        return id(self)

    def _inplace(self, o, fn, what):
        self._check_writable(what)
        self._data = fn(self._data, _operand(o, self._data))
        return self

    def __iadd__(self, o):
        return self._inplace(o, lambda a, b: a + b, "add to")

    def __isub__(self, o):
        return self._inplace(o, lambda a, b: a - b, "subtract from")

    def __imul__(self, o):
        return self._inplace(o, lambda a, b: a * b, "multiply")

    def __itruediv__(self, o):
        return self._inplace(o, lambda a, b: a / b, "divide")

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # -- reductions (the reduce ops' bodies, with their dtypes) --------------
    def _reduce(self, name, axis, keepdims):
        from .ops.tensor import reduce

        return NDArray(reduce(name, self._data, axis, keepdims))

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def abs(self):
        return NDArray(self._data.abs())


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


def _filled(factory, shape, ctx, dtype, *fill):
    """``torch.<factory>(shape, *fill)`` as an NDArray on ``ctx``."""
    import torch

    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(getattr(torch, factory)(
        tuple(shape), *fill, dtype=_torch_dtype(dtype), device=_device(ctx)))


def zeros(shape, ctx=None, dtype=None) -> NDArray:
    return _filled("zeros", shape, ctx, dtype)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return _filled("empty", shape, ctx, dtype)


def ones(shape, ctx=None, dtype=None) -> NDArray:
    return _filled("ones", shape, ctx, dtype)


def full(shape, val, ctx=None, dtype=None) -> NDArray:
    return _filled("full", shape, ctx, dtype, val)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    from .ops.tensor import arange as _arange

    return NDArray(_arange(start, stop, step, repeat, dtype, _device(ctx)))


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    import torch

    return NDArray(torch.cat([a._data for a in arrays], dim=axis))


def moveaxis(tensor: NDArray, source, destination) -> NDArray:
    import torch

    return NDArray(torch.movedim(tensor._data, source, destination))


def onehot_encode(indices: NDArray, out: NDArray) -> NDArray:
    """Reference: mx.nd.onehot_encode (src/ndarray/ndarray_function); ``out``
    is rebound to the one-hot rows, in its own dtype."""
    import torch

    depth = out.shape[1]
    cols = torch.arange(depth, device=indices._data.device)
    idx = indices._data.to(torch.int32)
    out._data = (idx[:, None] == cols[None, :]).to(
        device=out._data.device, dtype=out.dtype)
    return out


def bulk_asnumpy(arrays):
    """Host copies of many NDArrays (non-NDArray entries through
    ``np.asarray``); one device synchronisation for them all."""
    waitall()
    return [a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)
            for a in arrays]


def waitall():
    """Block until all pushed engine ops and all queued device work
    complete (reference: MXNDArrayWaitAll): the engine's
    ``wait_for_all`` (which raises an op's pending failure), then the
    card."""
    import torch

    from .engine import get_engine

    get_engine().wait_for_all()
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


# ---------------------------------------------------------------------------
# Module-level elementwise helpers (reference: ndarray.py:688-930): each
# takes an NDArray or a Python scalar on either side; scalar with scalar
# returns the Python result.

def _mod_binop(lhs, rhs, fn):
    if isinstance(lhs, NDArray):
        return lhs._binop(rhs, fn)
    if isinstance(rhs, NDArray):
        # scalar lhs: swapped into rhs._binop so the raw scalar promotes as
        # in the reference (no cast to rhs's dtype first)
        return rhs._binop(lhs, lambda b, a: fn(a, b))
    return fn(lhs, rhs)


def add(lhs, rhs):
    """Elementwise add (reference: ndarray.py:688)."""
    return _mod_binop(lhs, rhs, lambda a, b: a + b)


def subtract(lhs, rhs):
    """Elementwise subtract (reference: ndarray.py:714)."""
    return _mod_binop(lhs, rhs, lambda a, b: a - b)


def multiply(lhs, rhs):
    """Elementwise multiply (reference: ndarray.py:740)."""
    return _mod_binop(lhs, rhs, lambda a, b: a * b)


def divide(lhs, rhs):
    """Elementwise divide (reference: ndarray.py:766)."""
    return _mod_binop(lhs, rhs, lambda a, b: a / b)


true_divide = divide  # reference: ndarray.py true_divide alias


def power(lhs, rhs):
    """Elementwise power (reference: ndarray.py:792)."""
    return _mod_binop(lhs, rhs, lambda a, b: a ** b)


def _extreme(name, builtin):
    """max/min of two operands, either a scalar: the op body of ``name``
    (commutative, so the tensor goes first), or ``builtin`` for two
    scalars."""
    def apply(a, b):
        from .ops import tensor

        if np.isscalar(a) and np.isscalar(b):
            return builtin(a, b)
        fn = getattr(tensor, name)
        return fn(a, b) if not np.isscalar(a) else fn(b, a)
    return apply


def maximum(lhs, rhs):
    """Elementwise maximum (reference: ndarray.py:818)."""
    return _mod_binop(lhs, rhs, _extreme("_maximum", max))


def minimum(lhs, rhs):
    """Elementwise minimum (reference: ndarray.py:844)."""
    return _mod_binop(lhs, rhs, _extreme("_minimum", min))


def _mod_cmp(lhs, rhs, fn):
    def as_num(a, b):
        dtype = a.dtype if hasattr(a, "shape") else b.dtype
        return fn(a, b).to(dtype)

    if isinstance(lhs, NDArray):
        return lhs._binop(rhs, as_num)
    if isinstance(rhs, NDArray):
        return rhs._binop(lhs, lambda b, a: as_num(a, b))
    return float(fn(lhs, rhs))


def equal(lhs, rhs):
    """Elementwise ==, returned as 0/1 in the array's dtype (reference:
    ndarray.py:870)."""
    return _mod_cmp(lhs, rhs, lambda a, b: a == b)


def not_equal(lhs, rhs):
    """Elementwise != (reference: ndarray.py)."""
    return _mod_cmp(lhs, rhs, lambda a, b: a != b)


def greater(lhs, rhs):
    """Elementwise > (reference: ndarray.py)."""
    return _mod_cmp(lhs, rhs, lambda a, b: a > b)


def greater_equal(lhs, rhs):
    """Elementwise >= (reference: ndarray.py)."""
    return _mod_cmp(lhs, rhs, lambda a, b: a >= b)


def lesser(lhs, rhs):
    """Elementwise < (reference: ndarray.py)."""
    return _mod_cmp(lhs, rhs, lambda a, b: a < b)


def lesser_equal(lhs, rhs):
    """Elementwise <= (reference: ndarray.py)."""
    return _mod_cmp(lhs, rhs, lambda a, b: a <= b)


def negative(data):
    """Elementwise negation (reference: ndarray.py negative)."""
    return -data


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0,
             channels=3, mean=None, ctx=None):
    """Decode an encoded image to an HWC NDArray on ``ctx`` (reference:
    ndarray.py ``imdecode``, over :func:`mxnet_tpu_torch.image.imdecode`):
    uint8 pixels, cut to ``clip_rect`` (x0, y0, x1, y1) when it is not
    empty, minus ``mean`` in float32 when given. With ``out``, the image is
    written into it (at position ``index`` of a 4-d batch) in ``out``'s
    dtype and ``out`` is returned."""
    from . import image as _image

    npy = _image.imdecode(str_img, flag=1 if channels == 3 else 0)
    x0, y0, x1, y1 = clip_rect
    if x1 > x0 and y1 > y0:
        npy = npy[y0:y1, x0:x1]
    if mean is not None:
        npy = npy.astype(np.float32) - (mean.asnumpy()
                                        if isinstance(mean, NDArray)
                                        else np.asarray(mean))
    if out is None:
        return array(npy, ctx, dtype=npy.dtype)
    if not out.writable:
        raise MXNetError("imdecode: out array is not writable")
    if out.ndim == 4:
        out[index] = npy
    elif tuple(out.shape) == npy.shape:
        out[:] = npy
    else:
        raise MXNetError(
            f"imdecode: out shape {out.shape} does not match decoded "
            f"image shape {npy.shape}")
    return out


__all__ += ["add", "subtract", "multiply", "divide", "true_divide", "power",
            "maximum", "minimum", "equal", "not_equal", "greater",
            "greater_equal", "lesser", "lesser_equal", "negative",
            "imdecode"]

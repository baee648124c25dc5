"""User kernels compiled at run time: CUDA C++ source through NVRTC.

Port of mxnet_tpu/rtc.py, whose ``PallasKernel._call`` (``pl.pallas_call``)
runs a user-written Pallas body over the given arrays. On the card the
user's kernel language is CUDA C++, the role MXNet's own ``rtc.Rtc`` had, so
the body is NVRTC-compiled ``__global__`` source. One core compiles and
launches; two front ends sit on it:

- :class:`CudaKernel` keeps the ``PallasKernel`` contract: the output's shape
  and dtype come from ``out_like`` / ``out_shape`` / ``out_dtype``, and
  ``push`` returns a new NDArray. The source holds one
  ``extern "C" __global__`` function named ``name`` whose parameters are one
  pointer per input, the output pointer, then ``long long n`` (the output's
  element count). The default launch is 256 threads a block over
  ``ceil(n / 256)`` blocks; ``launch_dims`` gives a kernel its own.
- :class:`Rtc` is MXNet's form: ``(name, NDArray)`` pairs for inputs and
  outputs and a kernel *body*; the class writes the signature
  ``extern "C" __global__ void name(const T* x, ..., T* y)`` around it, ``T``
  from each array's dtype. The body also sees ``<name>_size`` (element
  count, a constant of the compiled kernel) and ``<name>_t`` (element type)
  for every array, and ``mx_to_float`` / ``mx_from_float<T>`` to compute in
  float whatever the type. ``push`` writes into the outputs in place, as in
  MXNet: an NDArray that shares an output's buffer (a view or an ``alias``
  of it) sees the write.

The core: ``nvrtcCompileProgram`` for ``sm_90a`` to a CUBIN (so the driver
does no JIT), ``cuModuleLoadData`` in the device's primary context (the one
PyTorch uses) and ``cuLaunchKernel`` on PyTorch's current stream, all through
``ctypes``. Compiled kernels are cached in the process by source, options,
device and name; each front end keeps, per device and signature, a launch
record (:class:`_Launcher`) that holds what a launch needs, so that a
repeated launch builds no source and sets no context that is current.
NVRTC comes from ``$CUDA_HOME/lib64`` (default
``/usr/local/cuda``) and the driver library from the system (``libcuda.so.1``,
which PyTorch has loaded); a missing library, a compile error (with the NVRTC
log), a failed load or a failed launch (with its ``CUresult``) raise
:class:`MXNetError`. There is no CPU fallback: a user's CUDA source has
nothing to run on a CPU tensor, so ``push`` and ``__call__`` raise there.
What bounds a kernel is the user's: an elementwise body moves bytes.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading
import time

from .base import MXNetError
from .ndarray import NDArray, _torch_dtype

__all__ = ["CudaKernel", "Rtc", "ARCH", "cuda_home", "nvrtc_version"]

ARCH = "sm_90a"
DEFAULT_BLOCK = 256

# element types a generated Rtc signature can name, by torch dtype name
CTYPES = {"float32": "float", "float16": "__half", "bfloat16": "__nv_bfloat16",
          "int32": "int", "int64": "long long"}

_LOCK = threading.RLock()
_LIBS: dict = {}
_FUNCTIONS: dict = {}  # (source, options, device index, name) -> CUfunction
_CONTEXTS: dict = {}  # device index -> primary CUcontext


def cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def _nvrtc_path() -> str:
    lib = os.path.join(cuda_home(), "lib64")
    exact = os.path.join(lib, "libnvrtc.so")
    if os.path.exists(exact):
        return exact
    found = sorted(p for p in glob.glob(os.path.join(lib, "libnvrtc.so.*"))
                   if "builtins" not in p)
    if not found:
        raise MXNetError(f"NVRTC not found: no libnvrtc.so* in {lib} (set "
                         "CUDA_HOME to the CUDA toolkit)")
    return found[0]


def _libs():
    """(nvrtc, driver) ``ctypes`` libraries with their signatures set."""
    with _LOCK:
        if _LIBS:
            return _LIBS["nvrtc"], _LIBS["cuda"]
        c = ctypes
        try:
            nvrtc = c.CDLL(_nvrtc_path())
        except OSError as e:
            raise MXNetError(f"cannot load NVRTC: {e}") from e
        try:
            cuda = c.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXNetError(f"cannot load the CUDA driver library "
                             f"libcuda.so.1: {e}") from e
        vp, pvp, ccp = c.c_void_p, c.POINTER(c.c_void_p), c.c_char_p
        sigs = [
            (nvrtc, "nvrtcVersion", [c.POINTER(c.c_int)] * 2),
            (nvrtc, "nvrtcCreateProgram",
             [pvp, ccp, ccp, c.c_int, c.POINTER(ccp), c.POINTER(ccp)]),
            (nvrtc, "nvrtcCompileProgram", [vp, c.c_int, c.POINTER(ccp)]),
            (nvrtc, "nvrtcGetProgramLogSize", [vp, c.POINTER(c.c_size_t)]),
            (nvrtc, "nvrtcGetProgramLog", [vp, ccp]),
            (nvrtc, "nvrtcGetCUBINSize", [vp, c.POINTER(c.c_size_t)]),
            (nvrtc, "nvrtcGetCUBIN", [vp, ccp]),
            (nvrtc, "nvrtcDestroyProgram", [pvp]),
            (cuda, "cuInit", [c.c_uint]),
            (cuda, "cuDeviceGet", [c.POINTER(c.c_int), c.c_int]),
            (cuda, "cuDevicePrimaryCtxRetain", [pvp, c.c_int]),
            (cuda, "cuCtxGetCurrent", [pvp]),
            (cuda, "cuCtxSetCurrent", [vp]),
            (cuda, "cuModuleLoadData", [pvp, vp]),
            (cuda, "cuModuleGetFunction", [pvp, vp, ccp]),
            (cuda, "cuLaunchKernel", [vp] + [c.c_uint] * 7 + [vp, pvp, pvp]),
            (cuda, "cuGetErrorName", [c.c_int, c.POINTER(ccp)]),
        ]
        for lib, fname, argtypes in sigs:
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = c.c_int
        nvrtc.nvrtcGetErrorString.argtypes = [c.c_int]
        nvrtc.nvrtcGetErrorString.restype = c.c_char_p
        _LIBS.update(nvrtc=nvrtc, cuda=cuda)
        return nvrtc, cuda


def nvrtc_version() -> tuple:
    nvrtc, _ = _libs()
    major, minor = ctypes.c_int(), ctypes.c_int()
    _nvrtc_check(nvrtc, nvrtc.nvrtcVersion(ctypes.byref(major),
                                           ctypes.byref(minor)), "version")
    return major.value, minor.value


def _nvrtc_check(nvrtc, res, what):
    if res != 0:
        msg = nvrtc.nvrtcGetErrorString(res).decode()
        raise MXNetError(f"NVRTC {what} failed: {msg} (nvrtcResult {res})")


def _cu_check(cuda, res, what):
    if res != 0:
        name = ctypes.c_char_p()
        cuda.cuGetErrorName(res, ctypes.byref(name))
        label = name.value.decode() if name.value else "unknown"
        raise MXNetError(f"CUDA driver {what} failed: {label} "
                         f"(CUresult {res})")


def _compile(source: str, options: tuple) -> bytes:
    """The CUBIN of ``source``; a compile error raises with the NVRTC log."""
    nvrtc, _ = _libs()
    prog = ctypes.c_void_p()
    _nvrtc_check(nvrtc, nvrtc.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"rtc_kernel.cu", 0, None,
        None), "create program")
    try:
        opts = (ctypes.c_char_p * len(options))(*(o.encode() for o in options))
        res = nvrtc.nvrtcCompileProgram(prog, len(options), opts)
        size = ctypes.c_size_t()
        nvrtc.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value)
        nvrtc.nvrtcGetProgramLog(prog, log)
        if res != 0:
            raise MXNetError(
                f"NVRTC compile failed ({nvrtc.nvrtcGetErrorString(res).decode()}"
                f"):\n{log.value.decode(errors='replace')}")
        _nvrtc_check(nvrtc, nvrtc.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "get CUBIN size")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(nvrtc, nvrtc.nvrtcGetCUBIN(prog, cubin), "get CUBIN")
        return cubin.raw
    finally:
        nvrtc.nvrtcDestroyProgram(ctypes.byref(prog))


def _primary_context(cuda, index: int):
    """Device ``index``'s primary context, PyTorch's, retained once."""
    ctx = _CONTEXTS.get(index)
    if ctx is None:
        _cu_check(cuda, cuda.cuInit(0), "init")
        dev = ctypes.c_int()
        _cu_check(cuda, cuda.cuDeviceGet(ctypes.byref(dev), index),
                  "device get")
        ctx = ctypes.c_void_p()
        _cu_check(cuda, cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                      dev.value),
                  "primary context retain")
        _CONTEXTS[index] = ctx
    return ctx


def default_options() -> tuple:
    """``sm_90a``, C++17, and the toolkit's headers (``cuda_bf16.h``; the
    ``cccl`` folder where a toolkit keeps ``nv/target`` there)."""
    inc = os.path.join(cuda_home(), "include")
    opts = [f"--gpu-architecture={ARCH}", "--std=c++17", f"-I{inc}"]
    if os.path.isdir(os.path.join(inc, "cccl")):
        opts.append(f"-I{os.path.join(inc, 'cccl')}")
    return tuple(opts)


class _Launcher:
    """One compiled function on one device, ready to launch: the
    ``CUfunction``, the device's primary context and the kernel's parameter
    array, all made once. A launch writes the parameter values into the
    array (under a lock, as the array is shared), reads the current
    context and makes the device's current only when it is not, reads the
    raw handle of PyTorch's current stream, and builds its error message
    only when the launch fails, and then raises."""

    __slots__ = ("fn", "ctx", "index", "name", "_values", "_params",
                 "_lock", "_cuda", "_stream")

    def __init__(self, fn, ctx, index, name, n_params, cuda):
        import torch

        self.fn, self.ctx, self.index, self.name = fn, ctx, index, name
        # each parameter is 8 bytes (a device pointer or ``long long n``);
        # _params holds the address of each slot of _values
        params_t = ctypes.c_void_p * n_params
        self._values = params_t()
        base = ctypes.addressof(self._values)
        self._params = params_t(*range(base, base + 8 * n_params, 8))
        self._lock = threading.Lock()
        self._cuda = cuda
        self._stream = torch._C._cuda_getCurrentRawStream

    def __call__(self, values, grid, block):
        """Launch with parameter ``values`` (device addresses, then
        integers) on ``grid`` x ``block`` (3-tuples)."""
        cuda = self._cuda
        cur = ctypes.c_void_p()
        with self._lock:
            self._values[:] = values
            cuda.cuCtxGetCurrent(ctypes.byref(cur))
            if cur.value == self.ctx.value:
                res = cuda.cuLaunchKernel(self.fn, *grid, *block, 0,
                                          self._stream(self.index),
                                          self._params, None)
            else:
                import torch

                # as PyTorch's device guard: the caller's device comes back
                with torch.cuda.device(self.index):
                    _cu_check(cuda, cuda.cuCtxSetCurrent(self.ctx),
                              "context set current")
                    res = cuda.cuLaunchKernel(self.fn, *grid, *block, 0,
                                              self._stream(self.index),
                                              self._params, None)
        if res:
            _cu_check(cuda, res, f"launch of '{self.name}' (grid {grid}, "
                      f"block {block})")


class _Program:
    """One kernel name and set of options: compiles a source per device on
    first use and keeps the NVRTC seconds it spent."""

    def __init__(self, name: str, options=None):
        self.name = name
        self.options = tuple(options) if options is not None \
            else default_options()
        self.compile_s = 0.0

    def launcher(self, source: str, device, n_params: int) -> _Launcher:
        """A :class:`_Launcher` of ``source`` on ``device``, compiled and
        loaded on first use (the CUfunction is cached in the process by
        source, options, device and name)."""
        import torch

        index = device.index or 0
        key = (source, self.options, index, self.name)
        torch.cuda.init()
        _, cuda = _libs()
        with _LOCK:
            ctx = _primary_context(cuda, index)
            fn = _FUNCTIONS.get(key)
            if fn is None:
                with torch.cuda.device(index):
                    _cu_check(cuda, cuda.cuCtxSetCurrent(ctx),
                              "context set current")
                    t0 = time.perf_counter()
                    cubin = _compile(source, self.options)
                    self.compile_s += time.perf_counter() - t0
                    module = ctypes.c_void_p()
                    image = ctypes.create_string_buffer(cubin, len(cubin))
                    _cu_check(cuda, cuda.cuModuleLoadData(
                        ctypes.byref(module), image), "module load")
                    fn = ctypes.c_void_p()
                    _cu_check(cuda, cuda.cuModuleGetFunction(
                        ctypes.byref(fn), module, self.name.encode()),
                        f"get function '{self.name}' (is it extern \"C\"?)")
                _FUNCTIONS[key] = fn
        return _Launcher(fn, ctx, index, self.name, n_params, cuda)


def _dims(dims, what):
    dims = tuple(int(d) for d in dims)
    if len(dims) > 3 or not dims or any(d < 1 for d in dims):
        raise MXNetError(f"{what} must be 1-3 positive ints, got {dims}")
    return dims + (1,) * (3 - len(dims))


def _default_grid(n: int):
    return (max(1, -(-n // DEFAULT_BLOCK)), 1, 1), (DEFAULT_BLOCK, 1, 1)


def _check_cuda_tensors(what, tensors):
    """All tensors contiguous, on one CUDA device; returns that device. CPU
    and ``meta`` tensors raise: there is no fallback."""
    import torch

    if not tensors:
        raise MXNetError(f"{what}: no arrays given")
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise MXNetError(f"{what}: expected tensors or NDArrays, got "
                             f"{type(t)}")
        if not t.is_cuda:
            raise MXNetError(
                f"{what}: a runtime-compiled CUDA kernel runs only on the "
                f"card, got a tensor on {t.device}; move it with "
                "as_in_context(mx.gpu())")
        if not t.is_contiguous():
            raise MXNetError(f"{what}: tensors must be contiguous (got a "
                             f"strided view of shape {tuple(t.shape)}); "
                             "copy it first")
    index = tensors[0].get_device()
    if any(t.get_device() != index for t in tensors):
        raise MXNetError(f"{what}: tensors on different devices")
    return tensors[0].device


def _tensor(x):
    return x.data if isinstance(x, NDArray) else x


class CudaKernel:
    """A user kernel with the ``PallasKernel`` contract (see the module
    docstring for what ``source`` must hold). ``launch_dims``, the
    counterpart of ``PallasKernel``'s ``grid``, is a function of the output
    tensor that returns ``(grid_dims, block_dims)``; without it a launch is
    one thread per element. ``grid_dims`` / ``block_dims`` given to a call
    win over both."""

    def __init__(self, name, source, out_like=0, out_shape=None,
                 out_dtype=None, options=None, launch_dims=None):
        self.name = name
        self.source = source
        self.out_like = out_like
        self.out_shape = tuple(out_shape) if out_shape is not None else None
        self.out_dtype = out_dtype
        self.launch_dims = launch_dims
        self._program = _Program(name, options)
        self._launchers: dict = {}   # (device index, tensors) -> _Launcher
        self._what = f"CudaKernel '{name}'"
        self.launches = 0

    @property
    def compile_s(self) -> float:
        """NVRTC seconds this kernel has spent compiling in this process."""
        return self._program.compile_s

    def _call(self, tensors, grid_dims=None, block_dims=None):
        import torch

        device = _check_cuda_tensors(self._what, tensors)
        ref = tensors[self.out_like]
        shape = self.out_shape if self.out_shape is not None else ref.shape
        dtype = _torch_dtype(self.out_dtype) if self.out_dtype is not None \
            else ref.dtype
        out = torch.empty(shape, dtype=dtype, device=device)
        n = out.numel()
        grid, block = self.launch_dims(out) if self.launch_dims \
            else _default_grid(n)
        key = (device.index, len(tensors))
        launcher = self._launchers.get(key)
        if launcher is None:
            launcher = self._program.launcher(self.source, device,
                                              len(tensors) + 2)
            self._launchers[key] = launcher
        launcher([*(t.data_ptr() for t in tensors), out.data_ptr(), n],
                 grid if grid_dims is None else _dims(grid_dims, "grid_dims"),
                 block if block_dims is None
                 else _dims(block_dims, "block_dims"))
        self.launches += 1
        return out

    def push(self, inputs, grid_dims=None, block_dims=None) -> NDArray:
        """Run on NDArrays; returns the output as a new NDArray on the
        inputs' context."""
        return NDArray(self._call([_tensor(x) for x in inputs], grid_dims,
                                  block_dims))

    def __call__(self, *tensors, grid_dims=None, block_dims=None):
        """Run on ``torch.Tensor``s; returns the output tensor."""
        return self._call([_tensor(t) for t in tensors], grid_dims,
                          block_dims)


_PRELUDE = """\
__device__ __forceinline__ float mx_to_float(float v) { return v; }
__device__ __forceinline__ float mx_to_float(int v) { return (float)v; }
__device__ __forceinline__ float mx_to_float(long long v) { return (float)v; }
__device__ __forceinline__ float mx_to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float mx_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T mx_from_float(float v) { return (T)v; }
template <> __device__ __forceinline__ __half mx_from_float<__half>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ __nv_bfloat16 mx_from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
"""


def _ctype(t) -> str:
    name = str(t.dtype).replace("torch.", "")
    if name not in CTYPES:
        raise MXNetError(f"Rtc: no CUDA type for dtype {name} (takes "
                         f"{', '.join(CTYPES)})")
    return CTYPES[name]


def rtc_source(name, kernel, inputs, outputs) -> str:
    """The CUDA source :class:`Rtc` compiles for ``(name, tensor)`` pairs:
    ``extern "C" __global__ void name(const T* x, ..., T* y)`` around
    ``kernel``, with ``<name>_t`` and ``<name>_size`` for every array."""
    inputs, outputs = list(inputs), list(outputs)
    params, prologue = [], []
    for i, (arg, t) in enumerate(inputs + outputs):
        ctype = _ctype(t)
        const = "const " if i < len(inputs) else ""
        params.append(f"{const}{ctype}* {arg}")
        prologue.append(f"  typedef {ctype} {arg}_t;\n"
                        f"  const long long {arg}_size = {t.numel()}LL;\n")
    return ("#include <cuda_fp16.h>\n#include <cuda_bf16.h>\n" + _PRELUDE +
            f'extern "C" __global__ void {name}({", ".join(params)}) {{\n' +
            "".join(prologue) + kernel + "\n}\n")


class Rtc:
    """MXNet's runtime kernel: a body over named input and output arrays.

    ``inputs`` and ``outputs`` are ``(name, NDArray)`` pairs; their dtypes
    (and sizes) fix the source shown in :attr:`source`. ``push`` keys its
    compiled variants by the arrays' (dtype, size) and the device: arrays
    of another signature compile that variant once, and a push of a known
    signature builds no source."""

    def __init__(self, name, inputs, outputs, kernel, options=None):
        self.name = name
        self.kernel = kernel
        self.input_names = [n for n, _ in inputs]
        self.output_names = [n for n, _ in outputs]
        if not self.output_names:
            raise MXNetError(f"Rtc '{name}': needs at least one output")
        names = self.input_names + self.output_names
        if len(set(names)) != len(names):
            raise MXNetError(f"Rtc '{name}': repeated argument names {names}")
        self._program = _Program(name, options)
        self.source = self._source([_tensor(a) for _, a in inputs],
                                   [_tensor(a) for _, a in outputs])
        # (device index, ((dtype, numel) of each array)) ->
        # (_Launcher, default (grid, block))
        self._variants: dict = {}
        self._what = f"Rtc '{name}'"
        self.launches = 0

    @property
    def compile_s(self) -> float:
        return self._program.compile_s

    def _source(self, ins, outs):
        return rtc_source(self.name, self.kernel,
                          zip(self.input_names, ins),
                          zip(self.output_names, outs))

    def push(self, inputs, outputs, grid_dims=None, block_dims=None):
        """Launch over ``inputs`` and ``outputs`` (NDArrays or tensors, in
        the constructor's order), writing the outputs in place. The default
        launch covers the first output's elements, 256 threads a block."""
        ins = [_tensor(x) for x in inputs]
        outs = [_tensor(x) for x in outputs]
        if len(ins) != len(self.input_names) \
                or len(outs) != len(self.output_names):
            raise MXNetError(
                f"Rtc '{self.name}': expected {len(self.input_names)} inputs "
                f"and {len(self.output_names)} outputs, got {len(ins)} and "
                f"{len(outs)}")
        tensors = ins + outs
        device = _check_cuda_tensors(self._what, tensors)
        key = (device.index, tuple([(t.dtype, t.numel()) for t in tensors]))
        variant = self._variants.get(key)
        if variant is None:
            variant = (self._program.launcher(self._source(ins, outs), device,
                                              len(tensors)),
                       _default_grid(outs[0].numel()))
            self._variants[key] = variant
        launcher, (grid, block) = variant
        launcher([t.data_ptr() for t in tensors],
                 grid if grid_dims is None else _dims(grid_dims, "grid_dims"),
                 block if block_dims is None
                 else _dims(block_dims, "block_dims"))
        self.launches += 1
        return outputs

"""Two user kernels for :mod:`mxnet_tpu_torch.rtc`, each beside its plain
PyTorch version. The tests and ``chip_smoke.py`` run these sources.

- ``axpy`` (``o = 2x + y``), the JAX package's own runtime-kernel case
  (``PallasKernel`` in tests/test_deploy.py), as :class:`~.rtc.CudaKernel`
  source: 16-byte vectors in a grid-stride loop, launched with one thread
  for each vector (:func:`axpy_dims`), with a scalar head and tail
  (:func:`axpy_split`) for any ``n`` and any element offset. Each element
  is computed in float and stored once, so it is exact against
  ``2 * x + y`` in fp32 and in bf16.
- ``sgd_mom`` as an :class:`~.rtc.Rtc` body with the math of the
  ``sgd_mom_update`` op: ``g = clip(rescale * grad)``,
  ``mom = momentum * mom - lr * (g + wd * w)``, ``w += mom``, in place on
  ``weight`` and ``mom``. The hyper-parameters are float32 literals in the
  source, as the op casts them to the arrays' float32, and it is compiled
  with ``--fmad=false`` so that each operation rounds where the op body's
  does: in fp32 the two agree bit for bit.

Both move bytes and do a few operations per element: they are bound by
device memory (axpy reads two arrays and writes one; sgd_mom reads three
and writes two).
"""
from __future__ import annotations

import string

import numpy as np

from .rtc import CTYPES, CudaKernel, Rtc, default_options

__all__ = ["axpy_source", "axpy_kernel", "axpy_dims", "axpy_split",
           "axpy_reference", "sgd_mom_body", "sgd_mom_rtc",
           "sgd_mom_reference", "SGD_MOM_ARGS"]

_AXPY = string.Template("""\
$headers// o = 2x + y over n elements, computed in float and stored once.
// A scalar head runs up to the first 16-byte boundary, then 16-byte vectors
// ($ve elements) in a grid-stride loop, then a scalar tail. If x, y and o
// are not aligned alike, all of it runs the scalar loop.
#define VE $ve
$word
__device__ __forceinline__ uint4 axpy4(uint4 x, uint4 y) {
  return make_uint4(axpy_word(x.x, y.x), axpy_word(x.y, y.y),
                    axpy_word(x.z, y.z), axpy_word(x.w, y.w));
}
extern "C" __global__ void __launch_bounds__(1024)
axpy(const $t* __restrict__ x, const $t* __restrict__ y, $t* __restrict__ o,
     long long n) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const unsigned long long ax = (unsigned long long)x;
  const bool alike = (((ax ^ (unsigned long long)y) |
                       (ax ^ (unsigned long long)o)) & 15) == 0;
  long long head = alike ? (long long)(((16 - (ax & 15)) & 15) / sizeof($t))
                         : n;
  head = head < n ? head : n;
  const long long nv = (n - head) / VE;   // whole vectors
  const long long tail = head + nv * VE;  // first element of the tail
  for (long long i = tid; i < head; i += stride)
    o[i] = $store(2.0f * $load(x[i]) + $load(y[i]));
  for (long long i = tail + tid; i < n; i += stride)
    o[i] = $store(2.0f * $load(x[i]) + $load(y[i]));
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  const uint4* yv = reinterpret_cast<const uint4*>(y + head);
  uint4* ov = reinterpret_cast<uint4*>(o + head);
  for (long long i = tid; i < nv; i += stride) ov[i] = axpy4(xv[i], yv[i]);
}
""")

# 2x + y on one 32-bit word: one fp32 element, or two bf16 elements (the
# low half first), each widened to float exactly by a shift
_WORDS = {
    "float": """\
__device__ __forceinline__ unsigned axpy_word(unsigned x, unsigned y) {
  return __float_as_uint(2.0f * __uint_as_float(x) + __uint_as_float(y));
}""",
    "__nv_bfloat16": """\
__device__ __forceinline__ unsigned axpy_word(unsigned x, unsigned y) {
  const float lo = 2.0f * __uint_as_float(x << 16) + __uint_as_float(y << 16);
  const float hi = 2.0f * __uint_as_float(x & 0xffff0000u) +
                   __uint_as_float(y & 0xffff0000u);
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}""",
}

_LOADS = {"float": ("", ""), "__nv_bfloat16": ("__bfloat162float",
                                               "__float2bfloat16_rn")}
AXPY_BLOCK = 256   # threads a block
_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def axpy_source(dtype: str = "float32") -> str:
    """CUDA source of axpy for ``float32`` or ``bfloat16``: 16-byte vectors
    in a grid-stride loop, so any grid covers any ``n``."""
    ctype = CTYPES[dtype]
    load, store = _LOADS[ctype]
    headers = "#include <cuda_bf16.h>\n" if ctype == "__nv_bfloat16" else ""
    return _AXPY.substitute(headers=headers, t=ctype, load=load, store=store,
                            word=_WORDS[ctype], ve=16 // _ITEMSIZE[dtype])


def axpy_split(n: int, x_addr: int, y_addr: int, o_addr: int,
               itemsize: int) -> tuple:
    """``(head, vectors, tail)`` element counts of the kernel's three loops
    for ``n`` elements at these addresses: the head runs to x's first
    16-byte boundary, the vectors are 16 bytes each, the tail is what is
    left. Addresses that differ modulo 16 put everything in the head."""
    alike = ((x_addr ^ y_addr) | (x_addr ^ o_addr)) & 15 == 0
    head = min(n, (-x_addr % 16) // itemsize) if alike else n
    vectors = (n - head) // (16 // itemsize)
    return head, vectors, n - head - vectors * (16 // itemsize)


def axpy_dims(n: int, itemsize: int) -> tuple:
    """``(grid_dims, block_dims)`` of an axpy launch over ``n`` elements:
    one thread for each 16-byte vector, in blocks of :data:`AXPY_BLOCK`.
    On an H100 80GB HBM3 at 700 W, at (4096, 32768) fp32, this launch took
    0.524 ms against 0.549-0.563 ms for grids of 2 to 32 blocks a
    multiprocessor that stride over the array, and streaming cache hints
    (``ld/st.global.cs``) added 3.5 % (``tools/rtc_launch_bench.py
    --grids``; PERF.md)."""
    vectors = -(-n // (16 // itemsize))
    return (max(1, -(-vectors // AXPY_BLOCK)), 1, 1), (AXPY_BLOCK, 1, 1)


def _axpy_launch(out):
    return axpy_dims(out.numel(), out.element_size())


def axpy_kernel(dtype: str = "float32") -> CudaKernel:
    """axpy as a :class:`~.rtc.CudaKernel` launched by :func:`axpy_dims`."""
    return CudaKernel("axpy", axpy_source(dtype), launch_dims=_axpy_launch)


def axpy_reference(x, y):
    """Plain version: ``2 * x + y`` in the inputs' dtype."""
    return 2.0 * x + y


SGD_MOM_ARGS = dict(lr=0.05, momentum=0.9, wd=1e-4, rescale_grad=0.5,
                    clip_gradient=1.0)

_SGD_MOM = """\
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= weight_size) return;
  float g = {rescale} * mx_to_float(grad[i]);
  {clip}float w = mx_to_float(weight[i]);
  float m = {momentum} * mx_to_float(mom[i]) - {lr} * (g + {wd} * w);
  mom[i] = mx_from_float<mom_t>(m);
  weight[i] = mx_from_float<weight_t>(w + m);"""


def _f32(v) -> str:
    """``v`` as a float32 literal that round-trips exactly."""
    text = f"{float(np.float32(v)):.9g}"
    if not any(c in text for c in ".e"):
        text += ".0"
    return text + "f"


def sgd_mom_body(lr, momentum=0.0, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0) -> str:
    """Rtc body of one SGD-momentum step over ``grad`` (input) and
    ``weight``, ``mom`` (outputs, updated in place)."""
    clip = ""
    if clip_gradient is not None and clip_gradient > 0:
        c = _f32(clip_gradient)
        clip = f"g = fminf(fmaxf(g, -{c}), {c});\n  "
    return _SGD_MOM.format(rescale=_f32(rescale_grad), clip=clip,
                           momentum=_f32(momentum), lr=_f32(lr), wd=_f32(wd))


def sgd_mom_rtc(grad, weight, mom, **args) -> Rtc:
    """The Rtc for these arrays' dtypes; ``args`` default to
    :data:`SGD_MOM_ARGS`."""
    args = {**SGD_MOM_ARGS, **args}
    return Rtc("sgd_mom", [("grad", grad)], [("weight", weight),
                                             ("mom", mom)],
               sgd_mom_body(**args),
               options=default_options() + ("--fmad=false",))


def sgd_mom_reference(weight, grad, mom, **args):
    """Plain version: the port's ``sgd_mom_update`` op body; returns
    ``(new_weight, new_mom)``."""
    from .ops import OpCtx, get_op

    args = {**SGD_MOM_ARGS, **args}
    return tuple(get_op("sgd_mom_update").fn(OpCtx(), args, weight, grad,
                                             mom))

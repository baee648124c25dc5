"""Two user kernels for :mod:`mxnet_tpu_torch.rtc`, each beside its plain
PyTorch version. The tests and ``chip_smoke.py`` run these sources.

- ``axpy`` (``o = 2x + y``), the JAX package's own runtime-kernel case
  (``PallasKernel`` in tests/test_deploy.py), as :class:`~.rtc.CudaKernel`
  source: one thread per element, computed in float and stored once, so it
  is exact against ``2 * x + y`` in fp32 and in bf16.
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

import numpy as np

from .rtc import CTYPES, CudaKernel, Rtc, default_options

__all__ = ["axpy_source", "axpy_kernel", "axpy_reference", "sgd_mom_body",
           "sgd_mom_rtc", "sgd_mom_reference", "SGD_MOM_ARGS"]

_AXPY = """\
{headers}extern "C" __global__ void axpy(const {t}* x, const {t}* y, {t}* o,
                                 long long n) {{
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (; i < n; i += stride) {{
    o[i] = {store}(2.0f * {load}(x[i]) + {load}(y[i]));
  }}
}}
"""

_LOADS = {"float": ("", ""), "__nv_bfloat16": ("__bfloat162float",
                                               "__float2bfloat16_rn")}


def axpy_source(dtype: str = "float32") -> str:
    """CUDA source of axpy for ``float32`` or ``bfloat16``. A grid-stride
    loop, so any grid covers any ``n``."""
    ctype = CTYPES[dtype]
    load, store = _LOADS[ctype]
    headers = "#include <cuda_bf16.h>\n" if ctype == "__nv_bfloat16" else ""
    return _AXPY.format(headers=headers, t=ctype, load=load, store=store)


def axpy_kernel(dtype: str = "float32") -> CudaKernel:
    return CudaKernel("axpy", axpy_source(dtype))


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

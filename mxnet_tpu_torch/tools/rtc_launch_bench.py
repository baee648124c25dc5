"""Time the user-kernel path (``mxnet_tpu_torch.rtc``) on the card.

For the axpy example (``rtc_examples.axpy_kernel``): the device's time of
one launch beside one library call computing the same ``2x + y``
(``torch.add(y, x, alpha=2)``), in fp32 and bf16 at (4096, 32768), the
transformer LM's logits, and in fp32 at n = 1000003; and the host's
microseconds a launch at 4096 elements. For ``Rtc`` (the SGD-momentum
example): the host's microseconds a push at 4096 elements, and the host's
and the device's milliseconds of one push over each of the LM's 150
parameter arrays (220.3 M fp32), as ``chip_smoke.py`` phase 7 runs it.

``--grids`` times the axpy kernel instead at (4096, 32768) in fp32 and
bf16, on other launches (256-thread blocks, 2 to 32 of them a
multiprocessor, or one thread for each 16-byte vector, the committed
launch) and with streaming cache hints (``ld/st.global.cs``, one or two
vectors of each input a loop step), in turns with the library call.

``--root`` imports ``mxnet_tpu_torch`` from another checkout, such as a
parent commit unpacked into a git-ignored directory, so that two versions
are timed on one card in one call, in turns. Run from the repo root on a
machine with an NVIDIA GPU:

    python3 mxnet_tpu_torch/tools/rtc_launch_bench.py [--root DIR] [--label L]
                                                     [--grids]

Prints one JSON line and appends it to ``rtc_launch_bench.jsonl`` in
``chip_smoke.py``'s output directory.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import (OUT_DIR, device_busy_ms, hbm_bytes_per_s,  # noqa
                        host_us_per_launch, time_device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout to import mxnet_tpu_torch from")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--grids", action="store_true",
                    help="time axpy on other grids instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc_examples as ex

    if not mx.__file__.startswith(os.path.abspath(args.root)):
        raise SystemExit(f"imported {mx.__file__}, not from {args.root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = {"label": args.label, "card": smi.stdout.strip()}
    g = torch.Generator(device="cuda").manual_seed(0)
    if args.grids:
        return grids(out, g)
    for name, shape, dtype in (("logits_fp32", (4096, 32768), "float32"),
                               ("logits_bf16", (4096, 32768), "bfloat16"),
                               ("ragged_fp32", (1000003,), "float32")):
        x, y = (torch.randn(shape, generator=g, device="cuda")
                .to(getattr(torch, dtype)) for _ in range(2))
        axpy = ex.axpy_kernel(dtype)
        exact = torch.equal(axpy(x, y), ex.axpy_reference(x, y))
        # kernel and library in turns, twice
        times = [time_device(lambda: axpy(x, y)),
                 time_device(lambda: torch.add(y, x, alpha=2.0)),
                 time_device(lambda: torch.add(y, x, alpha=2.0)),
                 time_device(lambda: axpy(x, y))]
        out[name] = {"exact": exact, "device_ms": [times[0], times[3]],
                     "library_device_ms": [times[1], times[2]],
                     "bound_ms": 3 * x.element_size() * x.numel()
                     / hbm_bytes_per_s(out["card"]) * 1e3}
        del x, y
    xs, ys = (torch.randn(4096, generator=g, device="cuda")
              for _ in range(2))
    axpy = ex.axpy_kernel("float32")
    sgd = ex.sgd_mom_rtc(xs, ys.clone(), ys.clone())
    ws, ms = ys.clone(), ys.clone()
    out["cuda_kernel_axpy_us"] = host_us_per_launch(lambda: axpy(xs, ys))
    out["rtc_sgd_mom_push_us"] = host_us_per_launch(
        lambda: sgd.push([xs], [ws, ms]))
    symbol = mx.models.transformer_lm.get_symbol(
        vocab_size=32768, num_layers=12, hidden=1024, heads=16, seq_len=2048)
    shapes, _, _ = symbol.infer_shape(data=(2, 2048),
                                      softmax_label=(2, 2048))
    shapes = [s for n, s in zip(symbol.list_arguments(), shapes)
              if n not in ("data", "softmax_label")]
    arrays = [[torch.randn(s, generator=g, device="cuda") for _ in range(3)]
              for s in shapes]
    sgd = ex.sgd_mom_rtc(*arrays[0])

    def rtc_pass():
        for gr, w, m in arrays:
            sgd.push([gr], [w, m])

    rtc_pass()   # compiles each (dtype, size) once
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        rtc_pass()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    out["rtc_pass"] = {"arrays": len(arrays), "host_ms": host,
                       "steady_host_ms": float(np.median(host)),
                       "device_busy_ms": device_busy_ms(rtc_pass)}
    write(out)


# variants of the axpy source for --grids: the committed one, and the
# same with streaming cache hints (ld/st.global.cs), one vector of each
# input a loop step or two
_STREAMING = """\
__device__ __forceinline__ uint4 ld_cs(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}
__device__ __forceinline__ void st_cs(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
"""
_LOOP = ("  for (long long i = tid; i < nv; i += stride) "
         "ov[i] = axpy4(xv[i], yv[i]);\n")
_CS_LOOP = ("  for (long long i = tid; i < nv; i += stride)\n"
            "    st_cs(ov + i, axpy4(ld_cs(xv + i), ld_cs(yv + i)));\n")
_CS_PAIRS = """\
  long long i = tid;
  for (; i + stride < nv; i += 2 * stride) {
    const uint4 x0 = ld_cs(xv + i), x1 = ld_cs(xv + i + stride);
    const uint4 y0 = ld_cs(yv + i), y1 = ld_cs(yv + i + stride);
    st_cs(ov + i, axpy4(x0, y0));
    st_cs(ov + i + stride, axpy4(x1, y1));
  }
  if (i < nv) st_cs(ov + i, axpy4(ld_cs(xv + i), ld_cs(yv + i)));
"""


def _variants(src):
    if src.count(_LOOP) != 1:
        raise RuntimeError("the axpy source no longer has the expected loop")
    cs = src.replace('extern "C"', _STREAMING + 'extern "C"')
    return {"committed": src, "streaming": cs.replace(_LOOP, _CS_LOOP),
            "streaming_pairs": cs.replace(_LOOP, _CS_PAIRS)}


def grids(out, g):
    """axpy's device time on other launches and source variants, in turns
    with the library."""
    import numpy as np
    import torch

    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch import rtc_examples as ex

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in ("float32", "bfloat16"):
        x, y = (torch.randn((4096, 32768), generator=g, device="cuda")
                .to(getattr(torch, dtype)) for _ in range(2))
        vectors = x.numel() * x.element_size() // 16
        kernels = {v: rtc.CudaKernel("axpy", src)
                   for v, src in _variants(ex.axpy_source(dtype)).items()}
        launches = {f"{b}_per_sm": ((sms * b,), (256,)) for b in (2, 4, 32)}
        launches["a_vector_a_thread"] = ((-(-vectors // 256),), (256,))
        launches["a_vector_a_thread_128"] = ((-(-vectors // 128),), (128,))
        cases = [(v, name) for v in kernels for name in launches]
        times = {f"{v}/{name}": [] for v, name in cases}
        times["library"] = []
        for rnd in range(3):
            for v, name in (cases if rnd % 2 == 0 else cases[::-1]):
                k, (grid, block) = kernels[v], launches[name]
                assert torch.equal(k(x, y, grid_dims=grid, block_dims=block),
                                   ex.axpy_reference(x, y))
                times[f"{v}/{name}"].append(time_device(
                    lambda: k(x, y, grid_dims=grid, block_dims=block)))
            times["library"].append(time_device(
                lambda: torch.add(y, x, alpha=2.0)))
        out[dtype] = {k: float(np.median(v)) for k, v in times.items()}
        del x, y
    write(out)


def write(out):
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "rtc_launch_bench.jsonl"), "a") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()

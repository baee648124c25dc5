"""Time the fp32 flash-attention kernel at other tile sizes, on the card.

Builds variants of ``mxnet_tpu_torch/csrc/flash_attention_fwd.cu`` that differ
only in the fp32 kernel's tile constants (Q rows per block below and at
D=128, K/V rows per tile, blocks an SM in ``__launch_bounds__``), checks each
against the plain version, and times each at the transformer LM's attention
shape and at D=128 and d=50, in turns (variant order reversed every round),
with CUDA events. Run from the repo root on a machine with an NVIDIA GPU:

    python3 mxnet_tpu_torch/tools/flash_tile_sweep.py [--rounds 3]

Prints one JSON line per variant (median ms of each round, registers and
spills of the D=64 instantiation from ptxas) and writes them to
``flash_tile_sweep.json`` in ``chip_smoke.py``'s output directory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import OUT_DIR, time_cuda  # noqa: E402
from mxnet_tpu_torch import _native  # noqa: E402
from mxnet_tpu_torch.ops.flash_attention import (  # noqa: E402
    copy_bytes, entry, flash_attention_reference)

# name: (Q rows up to D=64, Q rows at D=128, K/V rows, min blocks an SM)
VARIANTS = {
    "bq128-64_bk32": (128, 64, 32, 2),     # the source as committed
    "bq64_bk64": (64, 64, 64, 2),
    "bq64_bk32": (64, 64, 32, 2),
    "bq128-64_bk64": (128, 64, 64, 1),
}
CASES = {   # name: (q shape, t_k, causal)
    "main_d64": ((2, 2048, 16, 64), 2048, True),
    "d128": ((2, 2048, 8, 128), 2048, True),
    "d50": ((2, 1500, 16, 50), 1500, True),
}


def variant_source(src, bq, bq128, bk, min_blocks):
    subs = [(r"constexpr int F_BK = \d+;", f"constexpr int F_BK = {bk};"),
            (r"return DP <= 64 \? \d+ : \d+;",
             f"return DP <= 64 ? {bq} : {bq128};"),
            (r"__launch_bounds__\(F_THREADS, \d+\)",
             f"__launch_bounds__(F_THREADS, {min_blocks})")]
    for pat, new in subs:
        src, n = re.subn(pat, new, src)
        if n != 1:
            raise RuntimeError(f"pattern {pat!r} matched {n} times")
    return src


def build_all(out_dir):
    with open(os.path.join(_native.CSRC_DIR, "flash_attention_fwd.cu")) as f:
        src = f.read()
    procs = {}
    for name, params in VARIANTS.items():
        cu = os.path.join(out_dir, f"sweep_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, *params))
        procs[name] = subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"libsweep_{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        # ptxas -v: a "Compiling entry function" line, then the kernel's
        # spills and registers
        for block in log.split("Compiling entry function")[1:]:
            if "flash_fwd_f32ILi64ELi16E" in block.splitlines()[0]:
                ptxas[name] = " | ".join(
                    x.split(":", 1)[-1].strip() for x in block.splitlines()
                    if "spill" in x or "registers" in x)
        fns[name] = entry(ctypes.CDLL(
            os.path.join(out_dir, f"libsweep_{name}.so")))
    return fns, ptxas


def call(fn, q, k, v, causal):
    """One launch straight through the C entry, without the wrapper's
    checks, so that the events time the kernel alone."""
    out = torch.empty_like(q)
    b, t_q, h, d = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    err = fn(*ptrs, b, t_q, k.shape[1], h, d, d ** -0.5, int(causal), 0, 0,
             copy_bytes(d, *ptrs), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch refused (cudaError_t {err})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    out_dir = os.path.join(_native.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    fns, ptxas = build_all(out_dir)
    g = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for case, (shp, t_k, causal) in CASES.items():
        q = torch.randn(shp, generator=g, device="cuda")
        k = torch.randn((shp[0], t_k) + shp[2:], generator=g, device="cuda")
        v = torch.randn_like(k)
        want = flash_attention_reference(q, k, v, causal=causal)
        for name, fn in fns.items():
            err = float((call(fn, q, k, v, causal) - want).abs().max())
            if not err <= 1e-4:
                raise SystemExit(f"{name} {case}: max abs err {err}")
        data[case] = (q, k, v, causal)
    ms = {n: {c: [] for c in CASES} for n in fns}
    order = list(fns)
    for r in range(args.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            for case, (q, k, v, causal) in data.items():
                ms[name][case].append(time_cuda(
                    lambda: call(fns[name], q, k, v, causal)))
    rows = [{"variant": n, "params": VARIANTS[n], "ptxas_d64": ptxas.get(n),
             "ms": ms[n]} for n in order]
    for row in rows:
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(ROOT, OUT_DIR), exist_ok=True)
    with open(os.path.join(ROOT, OUT_DIR, "flash_tile_sweep.json"), "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()

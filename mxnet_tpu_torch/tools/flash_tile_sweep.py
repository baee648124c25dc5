"""Time a flash-attention kernel at other tile sizes, on the card.

``--kernel f32`` (the default) builds variants of
``mxnet_tpu_torch/csrc/flash_attention_fwd.cu`` that differ only in the fp32
kernel's tile constants (Q rows per block below and at D=128, K/V rows per
tile, blocks an SM in ``__launch_bounds__``) and times each at the
transformer LM's attention shape and at D=128 and d=50. ``--kernel wg``
builds variants of ``mxnet_tpu_torch/csrc/flash_attention_fwd_tc.cu`` that
differ from ``flash_fwd_tc_wg`` (the bf16/fp16 kernel for head dims
129-256) by the patches of ``WG_PATCHES``, applied to a copy of the source:
its consumers' loop without P V under the next tile's softmax, adjacent Q
tiles a block in place of the causal pairing, and two diagnostics that skip
the arithmetic or the loads; and times each at the LM's shape at hidden
1024 in 4 heads, causal and not, and at d = 192. ``--kernel f32wide``
builds variants of ``flash_attention_fwd.cu`` that differ from
``flash_fwd_f32_wide`` (the fp32 kernel for head dims 129-256) by the
patches of ``WIDE_PATCHES``: one Q tile a block in place of the causal
pairing, d split over 4 lanes (8 x 4 scores a lane) in place of 8, and
other unroll counts of its Q K^T and P V loops; and times each at the
same three shapes in fp32 and at d = 256 causal at batch 1.
Each variant but the diagnostics is checked against the plain version
first, and timed on the device alone (``chip_smoke.time_device``; ``f32``
per call, ``chip_smoke.time_cuda``) in turns (variant order reversed every
round). Run from the repo root on a machine with an NVIDIA GPU:

    python3 mxnet_tpu_torch/tools/flash_tile_sweep.py
        [--kernel f32|wg|f32wide] [--rounds 3]

Prints one JSON line per variant (median ms of each round, registers and
spills from ptxas) and writes them to ``flash_tile_sweep_<kernel>.json``
(``flash_tile_sweep.json`` for ``f32``) in ``chip_smoke.py``'s output
directory.
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

from chip_smoke import OUT_DIR, time_cuda, time_device  # noqa: E402
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
# flash_fwd_tc_wg's consumer loop: each tile's Q K^T, softmax and P V in
# turn, nothing in flight between them (the source's loop issues tile n's
# P V behind tile n + 1's Q K^T)
_SERIAL_LOOP = """\
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % WG_STAGES;
      const uint32_t parity = (kt / WG_STAGES) & 1;
      mbar_wait(k_full + s, parity);
      fence_regs(sc);
      wgmma_fence();
      issue_qk<T, DP>(sc, q_s, k_s + s * L::KV_BYTES);
      wgmma_wait_all();
      fence_regs(sc);
      mbar_arrive(k_empty + s * WG_CONSUMERS + wg);
      softmax_tile(sc, m, l, corr, edge(kt * WG_BK), kt * WG_BK, t_k,
                   causal, row_g, tq, scale_log2);
      rescale_and_pack<T, DC>(acc, pa, sc, corr);
      mbar_wait(v_full + s, parity);
#pragma unroll
      for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int j = 0; j < WG_BK / 16; ++j) fence_regs(pa[j]);
      wgmma_fence();
      issue_pv<T, DC>(acc, pa, v_s + s * L::KV_BYTES);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
      mbar_arrive(v_empty + s * WG_CONSUMERS + wg);
    }
"""
# a diagnostic consumer loop: waits for each tile and releases it
_LOADS_ONLY_LOOP = """\
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % WG_STAGES;
      const uint32_t parity = (kt / WG_STAGES) & 1;
      mbar_wait(k_full + s, parity);
      mbar_arrive(k_empty + s * WG_CONSUMERS + wg);
      mbar_wait(v_full + s, parity);
      mbar_arrive(v_empty + s * WG_CONSUMERS + wg);
    }
"""
# (pattern, replacement, matches) of each patch; a pattern must match the
# source that many times
_CONSUMER_LOOP = (r"    // tile 0: Q K\^T and its softmax alone\n.*?"
                  r"    mbar_arrive\(v_empty \+ sl \* WG_CONSUMERS \+ wg\);\n")
WG_PATCHES = {
    "serial": [(_CONSUMER_LOOP, _SERIAL_LOOP, 1)],
    # block y's consumers take Q tiles 2 (ny - 1 - y) and the next: the
    # heaviest blocks first
    "adjacent": [(r"int t = w == 0 \? .*?t = -1;\n",
                  "int t = ((int)gridDim.y - 1 - (int)blockIdx.y) * 2 + w;\n",
                  1)],
    "loads_only": [(_CONSUMER_LOOP, _LOADS_ONLY_LOOP, 1)],
    # after the first WG_STAGES tiles the producer arrives on a stage's
    # barrier without loading it
    "no_loads": [(r"(        mbar_expect_tx\((k|v)_full \+ s, L::KV_BYTES\);\n"
                  r".*?kt \* WG_BK, b\);\n)",
                  "        if (use > 0) {\n          mbar_arrive(\\2_full + s);\n"
                  "        } else {\n\\1        }\n", 2)],
}
# flash_fwd_tc_wg: name: patches
WG_VARIANTS = {
    "committed": (),
    "serial": ("serial",),
    "adjacent": ("adjacent",),
    "loads_only": ("loads_only",),
    "no_loads": ("no_loads",),
}
WG_DIAGNOSTICS = ("loads_only", "no_loads")   # timing only: wrong results
WG_CASES = {   # name: (q shape, t_k, causal), bf16
    "d256_causal": ((2, 2048, 4, 256), 2048, True),
    "d256_noncausal": ((2, 2048, 4, 256), 2048, False),
    "d192_causal": ((2, 2048, 4, 192), 2048, True),
}
# flash_fwd_f32_wide: (pattern, replacement, matches) of each patch
WIDE_PATCHES = {
    # one Q tile a block, the heaviest causal tiles first
    "unpaired": [(r"if \(2 \* \(int\)blockIdx\.y \+ 1 >= n_q\) break;",
                  "break;", 1),
                 (r"dim3 grid\(batch \* heads, \(n_q \+ 1\) / 2\);",
                  "dim3 grid(batch * heads, n_q);", 1)],
    # d split over 4 lanes: 8 rows x 4 keys a lane (the source: 8 lanes,
    # 8 x 8)
    "split4": [(r"constexpr int W_SPLIT = 8;", "constexpr int W_SPLIT = 4;",
                1)],
    # Q K^T's loop over d unrolled by 2 or fully (the source: not
    # unrolled; both spill)
    "qk_unroll2": [(r"#pragma unroll 1\n(      for \(int kk = 0;)",
                    "#pragma unroll 2\n\\1", 1)],
    "qk_unroll_all": [(r"#pragma unroll 1\n(      for \(int kk = 0;)",
                       "#pragma unroll\n\\1", 1)],
    # P V's loop over keys unrolled fully (the source: 2)
    "pv_unroll_all": [(r"#pragma unroll 2\n(      for \(int j = 0; j < F_BK)",
                       "#pragma unroll\n\\1", 1)],
}
WIDE_VARIANTS = {   # name: patches
    "committed": (),
    "unpaired": ("unpaired",),
    "split4": ("split4",),
    "qk_unroll2": ("qk_unroll2",),
    "qk_unroll_all": ("qk_unroll_all",),
    "pv_unroll_all": ("pv_unroll_all",),
}
# flash_fwd_f32_wide's cases: the wg kernel's, and batch 1, where the
# paired grid has 64 blocks for 132 SMs
WIDE_CASES = dict(WG_CASES, d256_causal_b1=((1, 2048, 4, 256), 2048, True))


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


def wg_variant_source(src, *patches, table=WG_PATCHES):
    for patch in patches:
        for pat, new, count in table[patch]:
            src, n = re.subn(pat, new, src, flags=re.DOTALL)
            if n != count:
                raise RuntimeError(f"{patch}: pattern {pat!r} matched {n} "
                                   f"times, not {count}")
    return src


def wide_variant_source(src, *patches):
    return wg_variant_source(src, *patches, table=WIDE_PATCHES)


# kernel: (source, variants, make a variant's source, ptxas marker)
KERNELS = {
    "f32": ("flash_attention_fwd.cu", VARIANTS, variant_source,
            "flash_fwd_f32ILi64ELi16E"),
    "wg": ("flash_attention_fwd_tc.cu", WG_VARIANTS, wg_variant_source,
           "flash_fwd_tc_wgI13__nv_bfloat16Li256E"),
    "f32wide": ("flash_attention_fwd.cu", WIDE_VARIANTS, wide_variant_source,
                "flash_fwd_f32_wideILi256ELi16E"),
}


def build_all(out_dir, kernel="f32"):
    source, variants, make, marker = KERNELS[kernel]
    with open(os.path.join(_native.CSRC_DIR, source)) as f:
        src = f.read()
    procs = {}
    for name, params in variants.items():
        cu = os.path.join(out_dir, f"sweep_{name}.cu")
        with open(cu, "w") as f:
            f.write(make(src, *params))
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
            if marker in block.splitlines()[0]:
                ptxas[name] = " | ".join(
                    x.split(":", 1)[-1].strip() for x in block.splitlines()
                    if "spill" in x or "registers" in x)
        # ptxas's notes on the kernel, such as wgmma serialized
        notes = [x.split(":", 1)[-1].strip()[:160] for x in log.splitlines()
                 if "Performance Loss" in x and marker in x]
        if notes:
            ptxas[name] = (ptxas.get(name) or "") + " | " + " | ".join(notes)
        fns[name] = entry(ctypes.CDLL(
            os.path.join(out_dir, f"libsweep_{name}.so")),
            "mxtt_flash_attention_fwd_tc" if kernel == "wg"
            else "mxtt_flash_attention_fwd")
    return fns, ptxas


def call(fn, q, k, v, causal):
    """One launch straight through the C entry, without the wrapper's
    checks, so that the events time the kernel alone."""
    out = torch.empty_like(q)
    b, t_q, h, d = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[q.dtype]
    err = fn(*ptrs, b, t_q, k.shape[1], h, d, d ** -0.5, int(causal), 0, code,
             copy_bytes(d, *ptrs, itemsize=q.element_size()),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch refused (cudaError_t {err})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="f32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    out_dir = os.path.join(_native.BUILD_DIR, "sweep_" + args.kernel)
    os.makedirs(out_dir, exist_ok=True)
    fns, ptxas = build_all(out_dir, args.kernel)
    cases, dtype, tol, timer = {
        "f32": (CASES, torch.float32, 1e-4, time_cuda),
        "wg": (WG_CASES, torch.bfloat16, 2e-2, time_device),
        "f32wide": (WIDE_CASES, torch.float32, 1e-4,
                    time_device)}[args.kernel]
    g = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for case, (shp, t_k, causal) in cases.items():
        q = torch.randn(shp, generator=g, device="cuda").to(dtype)
        k = torch.randn((shp[0], t_k) + shp[2:], generator=g,
                        device="cuda").to(dtype)
        v = torch.randn_like(k)
        want = flash_attention_reference(q.float(), k.float(), v.float(),
                                         causal=causal)
        for name, fn in fns.items():
            if name in WG_DIAGNOSTICS:
                continue   # a diagnostic: its results are wrong
            got = call(fn, q, k, v, causal).float()
            err = float((got - want).abs().max())
            if not err <= tol:
                raise SystemExit(f"{name} {case}: max abs err {err}")
        data[case] = (q, k, v, causal)
    ms = {n: {c: [] for c in cases} for n in fns}
    order = list(fns)
    for r in range(args.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            for case, (q, k, v, causal) in data.items():
                ms[name][case].append(timer(
                    lambda: call(fns[name], q, k, v, causal)))
    variants = KERNELS[args.kernel][1]
    rows = [{"variant": n, "params": variants[n], "ptxas": ptxas.get(n),
             "timer": timer.__name__, "ms": ms[n]} for n in order]
    for row in rows:
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(ROOT, OUT_DIR), exist_ok=True)
    name = ("flash_tile_sweep.json" if args.kernel == "f32"
            else f"flash_tile_sweep_{args.kernel}.json")
    with open(os.path.join(ROOT, OUT_DIR, name), "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()

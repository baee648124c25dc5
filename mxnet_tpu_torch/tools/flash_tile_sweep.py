"""Time a flash-attention kernel at other tile sizes, on the card.

``--kernel f32`` (the default) builds variants of
``mxnet_tpu_torch/csrc/flash_attention_fwd.cu`` that differ only in the fp32
kernel's tile constants (Q rows per block below and at D=128, K/V rows per
tile, blocks an SM in ``__launch_bounds__``) and times each at the
transformer LM's attention shape and at D=128 and d=50. ``--kernel wg``
builds variants of ``mxnet_tpu_torch/csrc/flash_attention_fwd_tc.cu`` that
differ from ``flash_fwd_tc_wg`` (the bf16/fp16 kernel for 16-byte rows up
to d 256) by the patches of ``WG_PATCHES``, applied to a copy of the
source: at widths 64 and 128 (``Tiles<64>``, ``Tiles<128>``) the other S
tile (m64n64 or m64n128: K/V tiles of 64 or 128 rows), another ring
depth (2 stages at width 64, 3 at 128), other consumer counts,
ping-pong flipped, exp2f in place of
ex2.approx.ftz, and the tiles of widths 192 and 256; at every width its
consumers' loop without P V under the next tile's softmax; at widths 192
and 256 adjacent Q tiles a block in place of the causal pairing; and two
diagnostics that skip the arithmetic or the loads; and times each, beside
the library's attention call in the same turns, at the LM's shapes: 16
heads of 64 (serving, causal and not; training, batch 4), 8 heads of 128,
and 4 heads of 256 (causal and not) and of 192. ``--kernel f32wide``
builds variants of ``flash_attention_fwd.cu`` that differ from
``flash_fwd_f32_wide`` (the fp32 kernel for head dims 129-256) by the
patches of ``WIDE_PATCHES``: one Q tile a block in place of the causal
pairing, d split over 4 lanes (8 x 4 scores a lane) in place of 8, and
other unroll counts of its Q K^T and P V loops; and times each at the
same three shapes in fp32 and at d = 256 causal at batch 1.
``--kernel f32cluster`` builds variants of ``flash_attention_fwd.cu`` that
differ from ``flash_fwd_f32_cluster`` (the fp32 kernel for head dims above
256) by the patches of ``CLUSTER_PATCHES``: 64-wide chunks of d,
64-row K/V tiles, one block an SM, a second V buffer, one rank's loads in
flight, clusters of at most 8 blocks (the portable limit, so groups of
clusters from d 1025), every grouped block streaming its Q chunks, the
exchange as a reduce-scatter of S's rows, and diagnostics without the
exchange, or without it and the barrier; and times each at fp32 (2, 2048,
2, 512) causal and not, (2, 2048, 4, 320), (2, 2048, 1, 1100), (2, 2048,
1, 2048) and (1, 2048, 1, 2100) causal, beside ``flash_fwd_f32`` at (2,
2048, 8, 128), the same operations as 2 heads of 512.
``--kernel tccluster`` builds variants of ``flash_attention_fwd_tc.cu``
that differ from ``flash_fwd_tc_cluster`` (the bf16/fp16 kernels for head
dims above 256) by the patches of ``TC_CLUSTER_PATCHES``: 128- and 256-wide
chunks of d, ``ClusterTiles``'s other K/V rows, stages and ping-pong (these
built without the groups of clusters, so only up to the largest cluster),
exp2f, the partials exchanged in two pieces a tile, other counts of loads
in flight, a fence for each arrival, clusters of up to 16 blocks (the
card's non-portable sizes: one cluster of 9 at d 1600), grouped blocks that
stream their Q at 2 chunks, the one-cluster shapes on the groups' kernels,
and diagnostics with every load from the block's own buffer, or without
any exchange; and times each at bf16 (2, 2048, 2, 512) causal and not,
(2, 2048, 4, 320), (2, 2048, 1, 1000) and (2, 2048, 1, 1400), d 320 at an
offset of one element (its LDG route), the groups of clusters at (2, 2048,
1, 1600), (2, 2048, 1, 2048) and (1, 2048, 1, 3300), beside
``flash_fwd_tc_wg`` at (2, 2048, 4, 256), the same operations as 2 heads of
512.
``--kernel wg_ldg`` builds variants of ``flash_attention_fwd_tc.cu`` that
differ from ``flash_fwd_tc_wg_ldg`` (the wgmma kernel's producer for the
bf16/fp16 rows TMA refuses) by the patches of ``WG_LDG_PATCHES``: its
``LdgTraits`` (rows a staged piece, staging buffers, the producer's
registers), 2 loading warps in place of 4, words read straight into
registers from device memory in place of the staging, four ring stages
at width 64, the unrolling of its rows and chunks, and diagnostics: the
proxy fence left out, and consumers that only wait and release
(``loads_only``, also without the producer's copies, its shifts, both,
or its fence); and times each at
bf16 views at an offset of one element ((2, 2048, 4, 256), (2, 2048, 16,
64), (2, 2048, 8, 128), (2, 2048, 4, 192), causal) and at (2, 1500, 16,
50), beside the library and, as a yardstick, the views staged into
aligned copies with d padded to a multiple of 8 (``staged_copy``, the
copies alone) and the TMA route on them (``staged_tma``).
Each variant but the diagnostics is checked against the plain version
first, and timed on the device alone (``chip_smoke.time_device``; ``f32``
per call, ``chip_smoke.time_cuda``) in turns (variant order reversed every
round). Run from the repo root on a machine with an NVIDIA GPU:

    python3 mxnet_tpu_torch/tools/flash_tile_sweep.py
        [--kernel f32|wg|wg_ldg|f32wide|f32cluster|tccluster] [--rounds 3]
        [--only VARIANT,...] [--tag SUFFIX]

Prints the card's name and power limit, then one JSON line per variant
(median ms of each round, registers and spills from ptxas) and writes them
to ``flash_tile_sweep_<kernel><tag>.json`` (``flash_tile_sweep<tag>.json``
for ``f32``) in ``chip_smoke.py``'s output directory. ``--only`` builds and
times the variants named (a diagnostic that faults on the card ends the
process, so time diagnostics in a run of their own).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    OUT_DIR, _at_offset, time_cuda, time_device)
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
    issue_qk<T, DP, BK>(sc, q_s, k_s + s * L::KV_BYTES);
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(k_empty + s * WG_CONSUMERS + wg);
    xchg(sc, kt);
    softmax_tile<BK, C::EX2>(sc, m, l, corr, edge(kt * BK), kt * BK, t_k,
                             causal, row_g, tq, scale_log2);
    rescale_and_pack<T, DC, BK>(acc, pa, sc, corr);
    mbar_wait(v_full + s, parity);
#pragma unroll
    for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) fence_regs(pa[j]);
    wgmma_fence();
    issue_pv<T, DC, BK>(acc, pa, v_s + s * L::KV_BYTES);
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
# source that many times. The serial and loads-only loops take no
# ping-pong turn: their consumers take all of theirs, empty, after the loop
_CONSUMER_LOOP = (r"  // tile 0: Q K\^T and its softmax alone\n.*?"
                  r"  mbar_arrive\(v_empty \+ sl \* WG_CONSUMERS \+ wg\);\n")


def _tiles(field, value, widths=(64, 128)):
    """A patch of field ``field`` (0: BK, 1: consumers, 2: stages, 3:
    ping-pong, 4: ex2.approx.ftz, 5: paired) of ``TilesOf`` at
    ``widths``."""
    pat = (r"(struct Tiles<(?:" + "|".join(map(str, widths))
           + r")> : TilesOf<" + r"\d+, " * field + r")\d+")
    return [(pat, "\\g<1>" + str(value), len(widths))]


WG_PATCHES = {
    # width 64 (committed: K/V tiles of 64 rows, four consumers, three
    # stages, no ping-pong)
    "d64_bk128": _tiles(0, 128, (64,)),    # S m64n128
    "d64_consumers2": _tiles(1, 2, (64,)),
    "d64_consumers3": _tiles(1, 3, (64,)),
    "d64_stages2": _tiles(2, 2, (64,)),
    "d64_pingpong": _tiles(3, 1, (64,)),
    # width 128 (committed: K/V tiles of 128 rows, two consumers,
    # ping-pong)
    "d128_bk64": _tiles(0, 64, (128,)),    # S m64n64
    "d128_consumers3": _tiles(1, 3, (128,)),
    "d128_stages3": _tiles(2, 3, (128,)),
    "d128_pingpong_off": _tiles(3, 0, (128,)),
    # both: exp2f and one chain a row's max and sum
    "exp2f": _tiles(4, 0),
    # widths 192 and 256's tiles at widths 64 and 128: K/V tiles of 64
    # rows, two consumers on Q tiles i and n - 1 - i, no ping-pong, exp2f
    "wide_tiles": [(r"(struct Tiles<(?:64|128)> : TilesOf<)[\d, ]+>",
                    "\\g<1>64, 2, 2, 0, 0, 1>", 2)],
    "serial": [(_CONSUMER_LOOP, _SERIAL_LOOP, 1)],
    # block y's consumers take Q tiles 2 (ny - 1 - y) and the next: the
    # heaviest blocks first
    "adjacent": [(r"int t = w == 0 \? .*?t = -1;\n",
                  "int t = ((int)gridDim.y - 1 - (int)blockIdx.y) * 2 + w;\n",
                  1)],
    "loads_only": [(_CONSUMER_LOOP, _LOADS_ONLY_LOOP, 1)],
    # after the first WG_STAGES tiles the producer arrives on a stage's
    # barrier without loading it
    "no_loads": [(r"(    mbar_expect_tx\((k|v)_full \+ s, L::KV_BYTES\);\n"
                  r".*?kt \* BK, b\);\n)",
                  "    if (use > 0) {\n      mbar_arrive(\\2_full + s);\n"
                  "    } else {\n\\1    }\n", 2)],
}
# flash_fwd_tc_wg: name: patches
WG_VARIANTS = {
    "committed": (),
    "d64_consumers2_bk128": ("d64_consumers2", "d64_bk128"),
    "d64_consumers2": ("d64_consumers2",),
    "d64_consumers3": ("d64_consumers3",),
    "d64_stages2": ("d64_stages2",),
    "d64_pingpong": ("d64_pingpong",),
    "d128_bk64": ("d128_bk64",),
    "d128_consumers3_bk64": ("d128_consumers3", "d128_bk64"),
    "d128_stages3": ("d128_stages3",),
    "d128_pingpong_off": ("d128_pingpong_off",),
    "exp2f": ("exp2f",),
    "wide_tiles": ("wide_tiles",),
    "serial": ("serial",),
    "adjacent": ("adjacent",),
    "loads_only": ("loads_only",),
    "no_loads": ("no_loads",),
}
WG_CASES = {   # name: (q shape, t_k, causal), bf16
    "d64_causal": ((2, 2048, 16, 64), 2048, True),
    "d64_noncausal": ((2, 2048, 16, 64), 2048, False),
    "d64_train_causal": ((4, 2048, 16, 64), 2048, True),
    "d128_causal": ((2, 2048, 8, 128), 2048, True),
    "d256_causal": ((2, 2048, 4, 256), 2048, True),
    "d256_noncausal": ((2, 2048, 4, 256), 2048, False),
    "d192_causal": ((2, 2048, 4, 192), 2048, True),
}


def _ldg(widths, **fields):
    """A patch of ``LdgTraits<width>``'s fields (sr: rows a piece, nb:
    staging buffers, regs: the producer's registers, 0 for what the
    consumers leave) at ``widths``: those not named keep the source's
    values."""
    names = ("sr", "nb", "regs")
    pat = (r"(struct LdgTraits<(" + "|".join(map(str, widths))
           + r")> : LdgOf<)" + ", ".join([r"(\d+)"] * len(names)) + ">")

    def sub(m):
        vals = [str(fields.get(n, m.group(3 + i))) for i, n in
                enumerate(names)]
        return m.group(1) + ", ".join(vals) + ">"

    return [(pat, sub, len(widths))]


# 16 bytes of device memory at a 16-byte aligned address, read-only (the
# direct variant's loads)
_LDG128 = r"""__device__ __forceinline__ uint4 ldg128(uint64_t addr) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(addr));
  return r;
}
"""
_ALL = (64, 128, 192, 256)
_TWO = (128, 192, 256)   # the widths with two consumers
# flash_fwd_tc_wg_ldg: name: patches (a patch's replacement may be a
# function of the match)
# the LDG route has its loop twice, in produce_ldg (flash_fwd_tc_wg_ldg's
# and one cluster's producer) and in ldg_pieces (the groups'): a patch of
# the loop changes both, as a patch of LDG_THREADS or shift_row must
WG_LDG_PATCHES = {
    # more, smaller pieces in the same or more shared memory: more in
    # flight, more barrier round trips
    "deep": _ldg((64,), nb=8) + _ldg((128, 192), sr=32, nb=6)
    + _ldg((256,), sr=16, nb=4),
    "sr16": _ldg((64,), sr=16, nb=16) + _ldg((128, 192), sr=16, nb=12)
    + _ldg((256,), sr=16, nb=4),
    # two of the producer's four warps load (the others leave at once)
    "warps2": [(r"constexpr int LDG_THREADS = 128;",
                "constexpr int LDG_THREADS = 64;", 1),
               (r"(  const int t = threadIdx\.x % 128;\n)"
                r"(  // a loading thread takes)",
                "\\1  if (t >= LDG_THREADS) return;\n\\2", 2)],
    # each loading thread reads its chunks' words from device memory into
    # registers (read-only loads), no copies into the staging
    "direct": [(r"(// 16 bytes of shared memory at a 16-byte aligned "
                r"address\n)", lambda m: _LDG128 + m.group(1), 1),
               (r"shift_row\(uint32_t words,", "shift_row(uint64_t words,", 1),
               (r"lds128\(words \+ ", "ldg128(words + ", 2),
               (r"shift_row<SH, DC>\(stg \+ buf \* PIECE \+ r \* L::RAW "
                r"\+ jc \* 16, sh, dst,",
                "shift_row<SH, DC>((reinterpret_cast<uint64_t>(x.src + "
                "(int64_t)row * rs) & ~uint64_t{15}) + jc * 16, sh, dst,", 2),
               (r"cp_async16_to\(dst \+ r \* L::RAW \+ m \* 128, "
                r"from \+ m \* 128\);", "{}", 2)],
    # the producer at what the two consumers at 240 leave it, 24 registers
    # (committed: 40, the consumers at 232)
    "regs24": _ldg(_TWO, regs=0),
    # four ring stages at width 64 (three committed)
    "d64_stages4": _tiles(2, 4, (64,)),
    # the producer at 48 registers at width 256 (its consumers at 224)
    "d256_regs48": _ldg((256,), regs=48),
    # a thread's rows of a piece, and its chunks of a row, unrolled at
    # every width (committed: one row at a time at widths 192 and 256, one
    # chunk at a time at 256)
    "rows_unrolled": [(r"#pragma unroll\(DC > 2 \? 1 : SR / RG\)",
                       "#pragma unroll", 4)],
    "chunks_unrolled": [(r"#pragma unroll\(DC > 3 \? 1 : DC\)",
                         "#pragma unroll", 1)],
    "loads_only": WG_PATCHES["loads_only"],
    # diagnostics beside loads_only: the producer without its copies, or
    # without its shifts
    "no_copy": [(r"cp_async16_to\(dst \+ r \* L::RAW \+ m \* 128, "
                 r"from \+ m \* 128\);", "{}", 2)],
    "no_shift": [(r"for \(int u = 0; u < SR / RG; \+\+u\) \{\n"
                  r"( +const int r = rq \+ u \* RG;\n +const int rt)",
                  "for (int u = 0; u < 0; ++u) {\n\\1", 2)],
    # a diagnostic: no proxy fence ahead of a tile's full barrier
    "no_fence": [(r'asm volatile\("fence\.proxy\.async\.shared::cta;\\n" '
                  r'::: "memory"\);', "", 2)],
}
WG_LDG_VARIANTS = {
    "committed": (),
    "regs24": ("regs24",),
    "deep": ("deep",),
    "sr16": ("sr16",),
    "warps2": ("warps2",),
    "direct": ("direct",),
    "d64_stages4": ("d64_stages4",),
    "d256_regs48": ("d256_regs48",),
    "rows_unrolled": ("rows_unrolled",),
    "chunks_unrolled": ("chunks_unrolled",),
    "unrolled_d256_regs48": ("rows_unrolled", "chunks_unrolled",
                             "d256_regs48"),
    "loads_only": ("loads_only",),
    "loads_only_no_copy": ("loads_only", "no_copy"),
    "loads_only_no_shift": ("loads_only", "no_shift"),
    "loads_only_neither": ("loads_only", "no_copy", "no_shift"),
    "no_fence": ("no_fence",),
    "loads_only_no_fence": ("loads_only", "no_fence"),
}
# bf16 rows that TMA refuses: (q shape, t_k, causal, offset in elements)
WG_LDG_CASES = {
    "d256_causal_offset1": ((2, 2048, 4, 256), 2048, True, 1),
    "d64_causal_offset1": ((2, 2048, 16, 64), 2048, True, 1),
    "d50_causal": ((2, 1500, 16, 50), 1500, True, 0),
    "d128_causal_offset1": ((2, 2048, 8, 128), 2048, True, 1),
    "d192_causal_offset1": ((2, 2048, 4, 192), 2048, True, 1),
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
# flash_fwd_f32_cluster's exchange as a reduce-scatter: the 8 threads of a
# row group ty own its rows in block ty % C, sum the cluster's partials of
# them in rank order and run their softmax; a second cluster barrier a K
# tile, then the other blocks read those rows' P and corrections (and at
# the end their sums) from the owner. Partials read a tile: 1/C of the
# all-gather's, plus P
_CLUSTER_RS = """\
    // the cluster's partials, reduce-scattered by row group
    static_assert(C_BK == 32, "a row of P is one float4 a thread");
    float4* corr_s = x_s + XB;   // C_BQ corrections, one float4 a row
    const bool own = ty % n_ranks == rank;
    const uint32_t owner = ty % n_ranks;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int jj = 0; jj < C_NJ / 4; ++jj)
        x_s[(i * (C_NJ / 4) + jj) * F_THREADS + tid] =
            make_float4(s[i][4 * jj], s[i][4 * jj + 1], s[i][4 * jj + 2],
                        s[i][4 * jj + 3]);
    cluster_arrive();
    cluster_wait();
    if (own) {
      const uint32_t xa =
          static_cast<uint32_t>(__cvta_generic_to_shared(x_s + tid));
      float4 sum[XE];
#pragma unroll 2
      for (uint32_t r = 0; r < n_ranks; ++r) {
        float4 p[XE];
        if (r == rank) {
#pragma unroll
          for (int e = 0; e < XE; ++e) {
            const int i = e / (C_NJ / 4), j = 4 * (e % (C_NJ / 4));
            p[e] = make_float4(s[i][j], s[i][j + 1], s[i][j + 2],
                               s[i][j + 3]);
          }
        } else {
          const uint32_t ra = map_rank(xa, r);
#pragma unroll
          for (int e = 0; e < XE; ++e)
            p[e] = ld_cluster(ra + e * F_THREADS * 16);
        }
#pragma unroll
        for (int e = 0; e < XE; ++e) {
          if (r == 0) {
            sum[e] = p[e];
          } else {
            sum[e].x += p[e].x;
            sum[e].y += p[e].y;
            sum[e].z += p[e].z;
            sum[e].w += p[e].w;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < XE; ++e) {
        const int i = e / (C_NJ / 4), j = 4 * (e % (C_NJ / 4));
        s[i][j] = sum[e].x;
        s[i][j + 1] = sum[e].y;
        s[i][j + 2] = sum[e].z;
        s[i][j + 3] = sum[e].w;
      }
    }
    const bool edge =
        k0 + C_BK > t_k || (causal && q_offset + q0 < k0 + C_BK - 1);
    float corr[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int row = q_offset + q0 + ty + 16 * i;
      float mx = __int_as_float(0xff800000);
#pragma unroll
      for (int j = 0; j < C_NJ; ++j) {
        float x = s[i][j] * scale_log2;
        if (edge) {
          const int col = k0 + tx + 8 * j;
          if (col >= t_k) {
            x = __int_as_float(0xff800000);
          } else if (causal && row < col) {
            x = MASKED;
          }
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = exp2f(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < C_NJ; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        rsum += p;
        if (own) p_s[(ty + 16 * i) * C_PS + tx + 8 * j] = p;
      }
      if (own) {
        m[i] = m_new;
        l[i] = l[i] * corr[i] + rsum;
        if (tx == 0) corr_s[ty + 16 * i] = make_float4(corr[i], 0.f, 0.f, 0.f);
      }
    }
    cluster_arrive();
    cluster_wait();   // every owner's P and corrections are in
    if (!own) {
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = ty + 16 * i;
        float* pr = p_s + r * C_PS + 4 * tx;
        *reinterpret_cast<float4*>(pr) = ld_cluster(map_rank(
            static_cast<uint32_t>(__cvta_generic_to_shared(pr)), owner));
        corr[i] = ld_cluster(map_rank(
            static_cast<uint32_t>(__cvta_generic_to_shared(corr_s + r)),
            owner)).x;
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr[i];
"""
# ... and the rows' sums from their owners at the end
_CLUSTER_RS_END = """\
  {
    float4* l_s = x_s + XB + C_BQ;   // C_BQ row sums, one float4 a row
    const bool own = ty % n_ranks == rank;
    if (own && tx == 0) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
        l_s[ty + 16 * i] = make_float4(row_l[i], 0.f, 0.f, 0.f);
    }
    cluster_arrive();
    cluster_wait();
    if (!own) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
        row_l[i] = ld_cluster(map_rank(static_cast<uint32_t>(
            __cvta_generic_to_shared(l_s + ty + 16 * i)), ty % n_ranks)).x;
    }
  }
  // no block leaves while a peer may still read its last partials
  cluster_arrive();
"""
# flash_fwd_f32_cluster with a second V buffer: V(n + 1) goes into buffer
# (n + 1) % 2 from the start of tile n, beside the copies of its first
# step's successor, so every step waits for all its copy groups, P V for
# none, and the end of a tile stages nothing
_V2_STAGE = """\
        if (u == 0 && kt + 1 < n_tiles)
          stage_tile<C_BK, C_W, VEC>(v_s + ((kt + 1) & 1) * C_BK * DS, v_bh,
                                     k0 + C_BK, t_k, rs, d - c_out);
"""
_CLUSTER_V2 = [
    (r"\(q_slots \* C_BQ \+ 3 \* C_BK\)", "(q_slots * C_BQ + 4 * C_BK)", 1),
    (r"float\* p_s = v_s \+ C_BK \* DS;", "float* p_s = v_s + 2 * C_BK * DS;",
     1),
    (r" +t_q, rs, d - c\);\n", lambda m: m.group(0) + _V2_STAGE, 1),
    (r"      if \(u == 0\) \{\n        cp_async_wait<1>\(\);\n"
     r"      \} else \{\n        cp_async_wait<0>\(\);\n      \}\n",
     "      cp_async_wait<0>();\n", 1),
    (r"    cp_async_wait<1>\(\);   // V\(kt\) is in[^\n]*\n", "", 1),
    (r"(    // O \+= P V over this block's columns\n.*?)"
     r"v_s \+ \(j \+ u\) \* DS",
     lambda m: m.group(1) + "v_s + (kt & 1) * C_BK * DS + (j + u) * DS", 1),
    (r"    __syncthreads\(\);   // every thread is done with V\(kt\) and P\n"
     r".*?cp_async_commit\(\);\n", "", 1),
    (r"constexpr int C_BLOCKS = 2;", "constexpr int C_BLOCKS = 1;", 1),
]
# flash_fwd_f32_cluster: (pattern, replacement, matches) of each patch
CLUSTER_PATCHES = {
    # 64-wide d-chunks: twice the blocks a cluster (d 320: 5 equal chunks
    # in place of 3 with the last half empty; d 512: 8), half the work a
    # block, the same partials to exchange
    "w64": [(r"constexpr int C_W = 128;", "constexpr int C_W = 64;", 1)],
    # K/V tiles of 64 rows: half the barriers and exchanges, partials of
    # 64 x 64; 186 KB of shared memory, one block an SM
    "bk64": [(r"constexpr int C_BK = 32;", "constexpr int C_BK = 64;", 1),
             (r"constexpr int C_BLOCKS = 2;", "constexpr int C_BLOCKS = 1;",
              1)],
    # one block an SM: the same code with 20 KB more shared memory asked
    # at launch
    "one_block": [(r"2 \* \(size_t\)C_BQ \* C_BK\);",
                   "2 * (size_t)C_BQ * C_BK + 5120);", 1)],
    # two V buffers (V of tile n + 1 copied from the start of tile n, one
    # __syncthreads a tile fewer): 128 KB, one block an SM
    "v2": _CLUSTER_V2,
    # clusters of at most 8 blocks, the portable limit: from 9 chunks
    # (d 1025) groups of clusters, each computing S again
    "c8": [(r"constexpr int C_MAX = 16;", "constexpr int C_MAX = 8;", 1)],
    # every block of grouped clusters streams its Q chunks beside its K
    # (the source keeps up to 4 of them for a Q tile)
    "qstream": [(r"constexpr int C_QRES = 4;", "constexpr int C_QRES = 1;",
                 1)],
    # the loop over ranks not unrolled: one rank's loads in flight (the
    # source: two)
    "ranks_serial": [(r"#pragma unroll 2\n(    for \(uint32_t r = 0;)",
                      "#pragma unroll 1\n\\1", 1)],
    # the exchange as a reduce-scatter of S's rows and an all-gather of P
    "rs": [(r"    // S = the cluster's partials summed in rank order\n.*?"
            r"(?=    cp_async_wait<1>\(\);   // V\(kt\) is in)",
            lambda m: _CLUSTER_RS, 1),
           (r"  // no block leaves while a peer may still read its last "
            r"partials\n  cluster_arrive\(\);\n",
            lambda m: _CLUSTER_RS_END, 1)],
    # diagnostics (wrong results): each block sums only its own partial
    # (the cluster barrier stays), and also without the barrier
    "no_exchange": [(r"for \(uint32_t r = 0; r < n_ranks; \+\+r\)",
                     "for (uint32_t r = 0; r < 1; ++r)", 1),
                    (r"if \(r == rank\) \{", "if (r == r) {", 1)],
    "no_barrier": [(r"    cluster_arrive\(\);\n    cluster_wait\(\);\n",
                    "", 1)],
}
CLUSTER_VARIANTS = {   # name: patches
    "committed": (),
    "w64": ("w64",),
    "bk64": ("bk64",),
    "one_block": ("one_block",),
    "v2": ("v2",),
    "c8": ("c8",),
    "qstream": ("qstream",),
    "ranks_serial": ("ranks_serial",),
    "rs": ("rs",),
    "rs_w64": ("rs", "w64"),
    "no_exchange": ("no_exchange",),
    "compute_alone": ("no_exchange", "no_barrier"),
}
# fp32: the LM at 2 heads of 512 (causal and not), 4 heads of 320, one
# head of 1100 (9 chunks: a cluster of 9 blocks, or two groups of 5 at
# c8), of 2048 (16 chunks) and of 2100 (17: two groups of 9, or three of
# 6 at c8), and flash_fwd_f32 at 8 heads of 128 (the same operations as 2
# heads of 512; no variant changes its kernel) as a yardstick
CLUSTER_CASES = {
    "d512_causal": ((2, 2048, 2, 512), 2048, True),
    "d320_causal": ((2, 2048, 4, 320), 2048, True),
    "d512_noncausal": ((2, 2048, 2, 512), 2048, False),
    "d1100_causal": ((2, 2048, 1, 1100), 2048, True),
    "d2048_causal": ((2, 2048, 1, 2048), 2048, True),
    "d2100_causal": ((1, 2048, 1, 2100), 2048, True),
    "d128_f32_causal": ((2, 2048, 8, 128), 2048, True),
}
def _cluster_tiles(**fields):
    """A patch of ``ClusterTiles``'s fields (bk: K/V rows a tile, stages,
    pingpong, ex2) in the tensor-core source: those not named keep the
    source's values."""
    names = ("bk", "consumers", "stages", "pingpong", "ex2", "paired")
    pat = (r"(struct ClusterTiles : TilesOf<)"
           + ", ".join([r"(\d+)"] * len(names)) + ">")

    def sub(m):
        vals = [str(fields.get(n, m.group(2 + i))) for i, n in
                enumerate(names)]
        return m.group(1) + ", ".join(vals) + ">"

    return [(pat, sub, 1)]


def _cw(width):
    """A patch of the cluster kernel's d-chunk width."""
    return [(r"constexpr int CW = 192;", f"constexpr int CW = {width};", 1)]


# on the LDG route the partials in two pieces and a staging of 16-row
# pieces: what fits beside 256-wide tiles or 64-row K/V tiles
_LDG_SMALL = [(r"constexpr int XP_LDG = 1;", "constexpr int XP_LDG = 2;", 1),
              (r"(struct LdgTraits : LdgOf<)32(, 2, 40>)", "\\g<1>16\\2", 1)]
# no groups of clusters (form 1) instantiated: its layout, with a second Q
# slot a consumer and rings of two, fits beside none of the tiles of the
# variants that take this; they run the one-cluster shapes only, and the
# sweep leaves out the cases past them (their launch is refused)
_ONE_CLUSTER = [(r"constexpr int GL_MIN = CL_MOST / 2 \+ 1;",
                 "constexpr int GL_MIN = CL_MOST + 1;", 1)]
# flash_fwd_tc_cluster: (pattern, replacement, matches) of each patch
TC_CLUSTER_PATCHES = {
    # 128-wide chunks with 64-row K/V tiles: clusters of 3-8 blocks, O 64
    # registers a thread, twice the partials to read at d 512
    "w128": _cw(128) + _cluster_tiles(bk=64),
    # 256-wide chunks: clusters of 2-8 blocks, O 128 registers a thread,
    # the fewest partials to read; ptxas spills and serializes the wgmma.
    # Two stages, and the partials in two pieces (four on the LDG route,
    # its staging of 16-row pieces), to fit
    "w256": _cw(256) + _cluster_tiles(bk=64, stages=2) + _ONE_CLUSTER
    + [(r"constexpr int XP_TMA = 1;", "constexpr int XP_TMA = 2;", 1),
       (r"constexpr int XP_LDG = 1;", "constexpr int XP_LDG = 4;", 1),
       (r"(struct LdgTraits : LdgOf<)32(, 2, 40>)", "\\g<1>16\\2", 1)],
    "w256_bk32": _cw(256) + _ONE_CLUSTER,
    # K/V tiles of 64 rows (S m64n64: half the exchanges, each twice the
    # size), two stages to fit
    "bk64": _cluster_tiles(bk=64, stages=2) + _LDG_SMALL + _ONE_CLUSTER,
    # three or four ring stages (two committed; the groups' rings are of
    # two)
    "stages3": _cluster_tiles(stages=3) + _ONE_CLUSTER,
    "stages4": _cluster_tiles(stages=4) + _ONE_CLUSTER,
    # exp2f and one chain a row's max and sum (ex2.approx.ftz committed)
    "exp2f": _cluster_tiles(ex2=0),
    # the consumers take turns to issue their products (the groups' do
    # not)
    "pingpong": _cluster_tiles(pingpong=1) + _ONE_CLUSTER,
    # the partials in two pieces a tile, an exchange each
    "xp2": [(r"constexpr int XP_TMA = 1;", "constexpr int XP_TMA = 2;", 1)],
    # 4 or 16 loads from the cluster in flight a thread (8 committed)
    "loads4": [(r"constexpr int X_LOADS = 8;", "constexpr int X_LOADS = 4;",
                1)],
    "loads16": [(r"constexpr int X_LOADS = 8;",
                 "constexpr int X_LOADS = 16;", 1)],
    # each arrival released at cluster scope on its own (a fence each, on
    # x_empty too) in place of one fence before relaxed arrivals
    "release_each": [(r"@p fence\.acq_rel\.cluster;", "", 1),
                     (r"mbarrier\.arrive\.relaxed\.cluster",
                      "mbarrier.arrive.release.cluster", 1)],
    # clusters of up to 16 blocks, the card's non-portable sizes (allowed
    # on the kernel at every launch past 8): one cluster of 9 at d 1600,
    # groups only past 16 chunks
    "c16": [(r"constexpr int CL_MOST = 8;", "constexpr int CL_MOST = 16;", 1),
            (r"(    cudaError_t err = allow_smem\(kernel\(\), SMEM, "
             r"smem_set\);\n)",
             "\\1    if (err == cudaSuccess && CL > 8)\n"
             "      err = cudaFuncSetAttribute(\n"
             "          kernel(), "
             "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n", 1)],
    # grouped blocks that reduce 2 chunks stream their Q beside K, as
    # those past 2 do (committed: they keep it for the Q tile)
    "qstream2": [(r"constexpr int Q_KEEP = 2;", "constexpr int Q_KEEP = 1;",
                  1)],
    # the one-cluster shapes (d <= 1536) on the groups' kernels as one
    # group (form 1 at G = 1: consume_steps and the step producers, a
    # second Q slot): what keeping form 0 beside form 1 is worth
    "form1": [(r"constexpr int GL_MIN = CL_MOST / 2 \+ 1;",
               "constexpr int GL_MIN = CL_MIN;", 1),
              (r"at_shape\(shape\.blocks, shape\.groups > 1,",
               "at_shape(shape.blocks, 1,", 1)],
    # diagnostics (wrong results): each block's loads all read its own
    # buffer (the stores and barriers stay), and no exchange at all
    "no_exchange": [(r"ld_cluster\(map_rank\(mine, r\)",
                     "ld_cluster(map_rank(mine, blockIdx.z % CL)", 1)],
    "compute_alone": [(r" +xchg\(sc, (?:kt|0)\);\n", "", 4),
                      (r" +xchg\.finish\(n_tiles\);\n", "", 2)],
}
TC_CLUSTER_VARIANTS = {   # name: patches
    "committed": (),
    "w128": ("w128",),
    "w256": ("w256",),
    "w256_bk32": ("w256_bk32",),
    "bk64": ("bk64",),
    "stages3": ("stages3",),
    "stages4": ("stages4",),
    "exp2f": ("exp2f",),
    "pingpong": ("pingpong",),
    "xp2": ("xp2",),
    "loads4": ("loads4",),
    "loads16": ("loads16",),
    "release_each": ("release_each",),
    "c16": ("c16",),
    "qstream2": ("qstream2",),
    "form1": ("form1",),
    "no_exchange": ("no_exchange",),
    "compute_alone": ("compute_alone",),
}
# bf16: the LM at 2 heads of 512 (causal and not), 4 heads of 320, d 1000
# and 1400 (clusters of 6 and 8 blocks), d 320 at an offset of one element
# (the LDG route), the groups of clusters at d 1600 (two of 5), 2048 (two
# of 6) and 3300 (three of 6, Q streamed), and flash_fwd_tc_wg at 4 heads
# of 256 (the same operations as 2 heads of 512; no variant changes its
# kernel) as a yardstick
TC_CLUSTER_CASES = {
    "d512_causal": ((2, 2048, 2, 512), 2048, True),
    "d320_causal": ((2, 2048, 4, 320), 2048, True),
    "d512_noncausal": ((2, 2048, 2, 512), 2048, False),
    "d1000_causal": ((2, 2048, 1, 1000), 2048, True),
    "d1400_causal": ((2, 2048, 1, 1400), 2048, True),
    "d320_causal_offset1": ((2, 2048, 4, 320), 2048, True, 1),
    "d1600_causal": ((2, 2048, 1, 1600), 2048, True),
    "d2048_causal": ((2, 2048, 1, 2048), 2048, True),
    "d3300_causal": ((1, 2048, 1, 3300), 2048, True),
    "d256_wg_causal": ((2, 2048, 4, 256), 2048, True),
}
WIDE_VARIANTS = {   # name: patches
    "committed": (),
    "unpaired": ("unpaired",),
    "split4": ("split4",),
    "qk_unroll2": ("qk_unroll2",),
    "qk_unroll_all": ("qk_unroll_all",),
    "pv_unroll_all": ("pv_unroll_all",),
}
# flash_fwd_f32_wide's cases: the wg kernel's at 4 heads, and batch 1,
# where the paired grid has 64 blocks for 132 SMs
WIDE_CASES = dict({n: c for n, c in WG_CASES.items() if c[0][3] > 128},
                  d256_causal_b1=((1, 2048, 4, 256), 2048, True))


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


def wg_ldg_variant_source(src, *patches):
    return wg_variant_source(src, *patches, table=WG_LDG_PATCHES)


def cluster_variant_source(src, *patches):
    return wg_variant_source(src, *patches, table=CLUSTER_PATCHES)


def tc_cluster_variant_source(src, *patches):
    return wg_variant_source(src, *patches, table=TC_CLUSTER_PATCHES)


# each kernel's diagnostics: variants timed only, their results wrong
DIAGNOSTICS = {
    "wg": ("loads_only", "no_loads"),
    "wg_ldg": ("loads_only", "loads_only_no_copy", "loads_only_no_shift",
               "loads_only_neither", "no_fence", "loads_only_no_fence"),
    "f32cluster": ("no_exchange", "compute_alone"),
    "tccluster": ("no_exchange", "compute_alone"),
}
# each kernel's variants built without groups of clusters (_ONE_CLUSTER):
# a case whose launch they refuse is left out of their rows
ONE_CLUSTER = {
    "tccluster": tuple(n for n, p in TC_CLUSTER_VARIANTS.items()
                       if any(_ONE_CLUSTER[0] in TC_CLUSTER_PATCHES[x]
                              for x in p)),
}
# kernel: (source, variants, make a variant's source, ptxas markers)
KERNELS = {
    "f32": ("flash_attention_fwd.cu", VARIANTS, variant_source,
            ("flash_fwd_f32ILi64ELi16E",)),
    "wg": ("flash_attention_fwd_tc.cu", WG_VARIANTS, wg_variant_source,
           tuple(f"flash_fwd_tc_wgI13__nv_bfloat16Li{w}E"
                 for w in (64, 128, 256))),
    "f32wide": ("flash_attention_fwd.cu", WIDE_VARIANTS, wide_variant_source,
                ("flash_fwd_f32_wideILi256ELi16E",)),
    "f32cluster": ("flash_attention_fwd.cu", CLUSTER_VARIANTS,
                   cluster_variant_source,
                   ("flash_fwd_f32_clusterILi16E",)),
    "wg_ldg": ("flash_attention_fwd_tc.cu", WG_LDG_VARIANTS,
               wg_ldg_variant_source,
               tuple(f"flash_fwd_tc_wg_ldgI13__nv_bfloat16Li{w}E"
                     for w in (64, 128, 192, 256))),
    "tccluster": ("flash_attention_fwd_tc.cu", TC_CLUSTER_VARIANTS,
                  tc_cluster_variant_source,
                  tuple(f"flash_fwd_tc_cluster{r}I13__nv_bfloat16Li{c}E"
                        for r in ("", "_ldg") for c in (2, 3, 4, 8))),
}


def build_all(out_dir, kernel="f32", only=None):
    source, variants, make, markers = KERNELS[kernel]
    if only:
        variants = {n: variants[n] for n in only}
    with open(os.path.join(_native.CSRC_DIR, source)) as f:
        src = f.read()
    # every variant built as the library is (_native.compile_library, in
    # its parts), all at once
    parts = _native.PARTS.get(source[:-len(".cu")], 1)
    jobs = {}
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        for name, params in variants.items():
            cu = os.path.join(out_dir, f"sweep_{name}.cu")
            with open(cu, "w") as f:
                f.write(make(src, *params))
            jobs[name] = pool.submit(
                _native.compile_library, cu,
                os.path.join(out_dir, f"libsweep_{name}.so"), parts)
    fns, ptxas = {}, {}
    for name, job in jobs.items():
        ok, log = job.result()
        if not ok:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        # ptxas -v: a "Compiling entry function" line, then the kernel's
        # spills and registers; then ptxas's notes on the kernel, such as
        # wgmma serialized
        report = []
        for marker in markers:
            for block in log.split("Compiling entry function")[1:]:
                if marker in block.splitlines()[0]:
                    report.append(marker + ": " + " | ".join(
                        x.split(":", 1)[-1].strip()
                        for x in block.splitlines()
                        if "spill" in x or "registers" in x))
            report += [x.split(":", 1)[-1].strip()[:160]
                       for x in log.splitlines()
                       if "Performance Loss" in x and marker in x]
        ptxas[name] = " || ".join(report)
        fns[name] = entry(ctypes.CDLL(
            os.path.join(out_dir, f"libsweep_{name}.so")),
            "mxtt_flash_attention_fwd_tc"
            if kernel in ("wg", "wg_ldg", "tccluster")
            else "mxtt_flash_attention_fwd")
    return fns, ptxas


def call(fn, q, k, v, causal, scale=None):
    """One launch straight through the C entry, without the wrapper's
    checks, so that the events time the kernel alone."""
    out = torch.empty_like(q)
    b, t_q, h, d = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[q.dtype]
    scale = d ** -0.5 if scale is None else scale
    err = fn(*ptrs, b, t_q, k.shape[1], h, d, scale, int(causal), 0, code,
             copy_bytes(d, *ptrs, itemsize=q.element_size()),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch refused (cudaError_t {err})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernel", choices=tuple(KERNELS), default="f32")
    ap.add_argument("--only", default="",
                    help="comma-separated variants to build and time "
                    "(default: all); a diagnostic that faults ends the "
                    "process, so time diagnostics apart")
    ap.add_argument("--tag", default="",
                    help="appended to the output file's name")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    print(card, flush=True)
    out_dir = os.path.join(_native.BUILD_DIR, "sweep_" + args.kernel)
    os.makedirs(out_dir, exist_ok=True)
    only = [n for n in args.only.split(",") if n]
    fns, ptxas = build_all(out_dir, args.kernel, only)
    cases, dtype, tol, timer = {
        "f32": (CASES, torch.float32, 1e-4, time_cuda),
        "wg": (WG_CASES, torch.bfloat16, 2e-2, time_device),
        "wg_ldg": (WG_LDG_CASES, torch.bfloat16, 2e-2, time_device),
        "f32wide": (WIDE_CASES, torch.float32, 1e-4, time_device),
        "f32cluster": (CLUSTER_CASES, torch.float32, 1e-4,
                       time_device),
        "tccluster": (TC_CLUSTER_CASES, torch.bfloat16, 2e-2,
                      time_device)}[args.kernel]
    g = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    refused = set()   # (variant, case) a one-cluster variant cannot run
    for case, (shp, t_k, causal, *offset) in cases.items():
        q = torch.randn(shp, generator=g, device="cuda").to(dtype)
        k = torch.randn((shp[0], t_k) + shp[2:], generator=g,
                        device="cuda").to(dtype)
        v = torch.randn_like(k)
        q, k, v = (_at_offset(x, offset[0] if offset else 0)
                   for x in (q, k, v))
        want = flash_attention_reference(q.float(), k.float(), v.float(),
                                         causal=causal)
        for name, fn in fns.items():
            if name in DIAGNOSTICS.get(args.kernel, ()):
                continue   # a diagnostic: its results are wrong
            try:
                got = call(fn, q, k, v, causal).float()
            except RuntimeError:
                if name not in ONE_CLUSTER.get(args.kernel, ()):
                    raise
                refused.add((name, case))
                continue
            err = float((got - want).abs().max())
            if not err <= tol:
                raise SystemExit(f"{name} {case}: max abs err {err}")
        data[case] = (q, k, v, causal)
    # the library's attention call on the same inputs, timed in the same
    # turns (a yardstick: the port never calls it); for wg_ldg also the
    # views staged into aligned copies, d padded with zeros to a multiple of
    # 8 (the copies alone, and the TMA route on them)
    extra = ["library"]
    if args.kernel == "wg_ldg":
        extra += ["staged_copy", "staged_tma"]
        staged = {}
        for case, (q, k, v, causal) in data.items():
            d = q.shape[-1]
            stage = (lambda x, p=-d % 8: F.pad(x, (0, p)) if p
                     else x.clone())
            qs, ks, vs = (stage(x) for x in (q, k, v))
            got = call(fns["committed"], qs, ks, vs, causal,
                       scale=d ** -0.5)[..., :d].float()
            want = flash_attention_reference(q.float(), k.float(), v.float(),
                                             causal=causal)
            if not float((got - want).abs().max()) <= tol:
                raise SystemExit(f"staged_tma {case}: wrong")
            staged[case] = (stage, qs, ks, vs, d)
    for name in extra:
        fns[name] = None
    ms = {n: {c: [] for c in cases} for n in fns}
    order = list(fns)

    def run(name, case, q, k, v, causal):
        if name == "library":
            # it refuses 16-bit views at d 320 ("query_ptr is not correctly
            # aligned"): it takes aligned copies of them
            qt, kt, vt = (
                (x.clone() if x.data_ptr() % 16 else x).transpose(1, 2)
                for x in (q, k, v))
            return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=causal)
        if name == "staged_copy":
            stage = staged[case][0]
            return lambda: [stage(x) for x in (q, k, v)]
        if name == "staged_tma":
            _, qs, ks, vs, d = staged[case]
            return lambda: call(fns["committed"], qs, ks, vs, causal,
                                scale=d ** -0.5)
        return lambda: call(fns[name], q, k, v, causal)

    for r in range(args.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            for case, (q, k, v, causal) in data.items():
                if (name, case) not in refused:
                    ms[name][case].append(timer(run(name, case, q, k, v,
                                                    causal)))
    variants = dict(KERNELS[args.kernel][1], **{n: () for n in extra})
    rows = [{"variant": n, "params": variants[n], "ptxas": ptxas.get(n),
             "timer": timer.__name__, "card": card, "ms": ms[n]}
            for n in order]
    for row in rows:
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(ROOT, OUT_DIR), exist_ok=True)
    name = ("flash_tile_sweep" if args.kernel == "f32"
            else f"flash_tile_sweep_{args.kernel}") + args.tag + ".json"
    with open(os.path.join(ROOT, OUT_DIR, name), "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()

// Flash-attention forward for Hopper (sm_90a), fp32 inputs; bf16 and fp16
// run on the tensor cores in flash_attention_fwd_tc.cu.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd through pl.pallas_call). It computes the same
// function: for each (batch, head), softmax(scale * Q K^T) V over
// (B, T, H, D) tensors, with an optional causal mask that keeps
// q_offset + row >= col (a masked score is the reference's -1e30), an online
// softmax (running max m, running sum l, fp32 accumulator) over K/V tiles,
// and o / max(l, 1e-20) written in q's dtype. Columns past T_k score -inf
// (weight 0). The scores never leave the block.
//
// Bound on an H100 SXM at the transformer LM's shape, q/k/v (2, 2048, 16, 64)
// fp32 causal, per forward and layer: the causal pairs are
// B*H*T*(T+1)/2 = 6.7e7, each 2*D flops for Q K^T and 2*D for P V, so about
// 17.2 GFLOP; the bytes are q, k, v read once and o written once,
// 4 * 16.8 MB = 67 MB. At 67 TFLOP/s (fp32, no tensor cores) and
// 3.35 TB/s that is 0.26 ms against 0.02 ms: the kernel is bound by
// operations, not by memory.
//
// fp32 design (flash_fwd_f32), laid out so that the FMA pipes, not shared
// memory, set the pace.
//   * one block of 128 threads (4 warps) per (Q tile, batch*head): 128 Q
//     rows up to D=64, 64 at D=128; K/V tiles of 32 rows. The grid is
//     (batch*head, Q tile) and Q tiles run from the last, so the first
//     blocks the card schedules are the heaviest causal tiles of every head;
//   * register tiling: thread (ty, tx) = (tid / 8, tid % 8) owns score rows
//     ty + 16i (i < MI: 8, or 4 at D=128) x columns tx + 8j (j < 4), and
//     output rows ty + 16i x columns 32g + 4tx + {0..3} (g < D/32). Q, K
//     and V stay row-major in shared memory, rows padded by 4 floats, P
//     row-major with rows of 40. Q K^T reads 4 consecutive d of a Q or K row
//     with one 16-byte LDS.128; P V reads 4 consecutive keys of a P row and
//     4 consecutive columns of a V row the same way. A warp's LDS.128
//     touches 4 (Q, P) or 8 (K) distinct rows, whose 16-byte chunks fall in
//     distinct banks, or 128 contiguous bytes (V): one shared wavefront
//     each, read as a broadcast by the 8 or 4 threads that share a row. At
//     D=64 a thread issues 12 LDS.128 per 128 FMAs in Q K^T and 16 per 256
//     in P V: one wavefront per 10.7 and per 16 warp FMAs;
//   * cp.async double buffering: K and V tiles go through a two-stage ring;
//     tile n+1 is copied while tile n is computed (commit_group /
//     wait_group, two __syncthreads per tile). Copies are 16 bytes when
//     d % 4 == 0 and the base pointers are 16-byte aligned, else 4 bytes
//     (the VEC template parameter, picked by
//     ops/flash_attention.py::copy_bytes); rows past T and columns past d
//     are zero-filled with src-size 0;
//   * softmax: log2(e) is folded into the scale and exp2f used; the row max
//     reduces over the 8 threads of a row with 3 shuffles per tile, the row
//     sum stays a per-thread partial until the end; masks are applied only
//     on tiles that cross the diagonal or T_k;
//   * K tiles wholly above the causal diagonal are skipped: in the reference
//     their contribution is exactly 0, because column 0 of the first tile is
//     never masked for q_offset >= 0;
//   * shared memory: Q tile, 4 K/V tiles and P: 90.1 KB at D=64 and
//     111.6 KB at D=128 (two blocks, 8 warps an SM), 57.3 KB at D=32. The
//     dynamic-size attribute is set once per device and instantiation, not
//     at every launch;
//   * head dims: D=32/64/128 instantiations; any d <= 128 runs in the
//     smallest that holds it, the columns past d zero in shared memory. A
//     d from 129 to 256 runs flash_fwd_f32_wide (one block owns all of d,
//     below), any wider d flash_fwd_f32_cluster (thread-block clusters
//     whose blocks each own a 128-wide chunk of d of the output, below).
//   The tile sizes were chosen on the card among 64/128 Q rows and 32/64
//   keys (mxnet_tpu_torch/tools/flash_tile_sweep.py; PERF.md).
// Measured on an H100 SXM at 700 W: 0.54-0.58 ms at the shape above, 44-48 %
// of the bound, against 0.70-0.72 ms for scaled_dot_product_attention
// (chip_smoke.py, PERF.md). What stalls it further is not measured.
// What it leaves on the table: no tensor cores (3xTF32 on wgmma or mma.sync
// would change the bound itself), no TMA, and a P round trip through shared
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float MASKED = -1e30f;  // the reference's masked score
constexpr float LOG2E = 1.4426950408889634f;

// fp32 kernel (flash_fwd_f32)
constexpr int F_THREADS = 128;     // 16 row x 8 column groups
constexpr int F_BK = 32;           // K/V rows per tile
constexpr int NJ = F_BK / 8;       // score columns per thread
constexpr int F_PAD = 4;           // floats of padding per Q/K/V row
constexpr int P_STRIDE = F_BK + 8; // P row stride: scalar stores hit 32 banks
// Q rows per block: 128 up to D=64 (8 rows a thread); 64 at D=128, where
// 128 rows would not leave two blocks' shared memory on an SM
template <int DP>
__host__ __device__ constexpr int f32_bq() { return DP <= 64 ? 128 : 64; }

// ---------------------------------------------------------------- fp32

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy VEC bytes from global src to shared dst asynchronously; with
// valid == false nothing is read and dst is zero-filled (src-size 0).
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? VEC : 0;
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    static_assert(VEC == 4, "copies are 16 or 4 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

// Start copying rows [row0, row0 + ROWS) of one (batch, head) of a
// (B, T, H, D) fp32 tensor into a ROWS x (DP + F_PAD) shared tile; rows
// past t_len and columns past d are zero-filled.
template <int ROWS, int DP, int VEC, int THREADS = F_THREADS>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int row0, int t_len,
                                           int row_stride, int d) {
  constexpr int W = VEC / 4;          // floats per copy
  constexpr int PER_ROW = DP / W;
  static_assert(ROWS * PER_ROW % THREADS == 0, "whole copies per thread");
#pragma unroll 8
  for (int it = 0; it < ROWS * PER_ROW / THREADS; ++it) {
    const int e = it * THREADS + threadIdx.x;
    const int r = e / PER_ROW;
    const int c = (e % PER_ROW) * W;
    const int row = row0 + r;
    const bool ok = row < t_len && c < d;
    cp_async<VEC>(dst + r * (DP + F_PAD) + c,
                  ok ? src + (int64_t)row * row_stride + c : src, ok);
  }
}

template <int DP>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * ((size_t)(f32_bq<DP>() + 4 * F_BK) * (DP + F_PAD) +
                          (size_t)f32_bq<DP>() * P_STRIDE);
}

template <int DP, int VEC>
__global__ void __launch_bounds__(F_THREADS, 2)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int t_q,
              int t_k, int heads, int d, float scale_log2, int causal,
              int q_offset) {
  constexpr int F_BQ = f32_bq<DP>();
  constexpr int MI = F_BQ / 16;   // score and output rows per thread
  constexpr int DS = DP + F_PAD;  // shared row stride of Q, K, V
  constexpr int NG = DP / 32;     // float4 output column groups per thread
  constexpr int STAGE = 2 * F_BK * DS;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // F_BQ x DS
  float* kv_s = q_s + F_BQ * DS;   // 2 stages of [K tile, V tile], F_BK x DS
  float* p_s = kv_s + 2 * STAGE; // F_BQ x P_STRIDE

  const int tx = threadIdx.x & 7;   // columns tx + 8j; output 32g + 4tx
  const int ty = threadIdx.x >> 3;  // rows ty + 16i
  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;   // heaviest causal first
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = q_tile * F_BQ;
  const int rs = heads * d;         // row stride of (B, T, H, D)

  // (b, row, h, :) lives at ((b * T + row) * H + h) * D
  const float* q_bh = q + ((int64_t)b * t_q * heads + h) * d;
  const float* k_bh = k + ((int64_t)b * t_k * heads + h) * d;
  const float* v_bh = v + ((int64_t)b * t_k * heads + h) * d;
  float* o_bh = o + ((int64_t)b * t_q * heads + h) * d;

  int n_tiles = (t_k + F_BK - 1) / F_BK;
  if (causal) {
    // last query row of this tile, in key coordinates
    const int last = q_offset + min(q0 + F_BQ, t_q) - 1;
    n_tiles = min(n_tiles, last / F_BK + 1);
  }

  stage_tile<F_BQ, DP, VEC>(q_s, q_bh, q0, t_q, rs, d);
  stage_tile<F_BK, DP, VEC>(kv_s, k_bh, 0, t_k, rs, d);
  stage_tile<F_BK, DP, VEC>(kv_s + F_BK * DS, v_bh, 0, t_k, rs, d);
  cp_async_commit();

  float acc[MI][NG][4];
  float m[MI], l[MI];   // l: this thread's partial row sums
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * F_BK;
    const float* k_s = kv_s + (kt & 1) * STAGE;
    const float* v_s = k_s + F_BK * DS;
    cp_async_wait_all();
    // tile kt is in for every thread, and every thread is done with
    // tile kt - 1's stage and with p_s
    __syncthreads();
    if (kt + 1 < n_tiles) {
      float* nxt = kv_s + ((kt + 1) & 1) * STAGE;
      stage_tile<F_BK, DP, VEC>(nxt, k_bh, k0 + F_BK, t_k, rs, d);
      stage_tile<F_BK, DP, VEC>(nxt + F_BK * DS, v_bh, k0 + F_BK, t_k, rs, d);
      cp_async_commit();
    }

    // S = Q K^T: per 4 d, MI + NJ LDS.128 for 4 MI NJ FMAs
    float s[MI][NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      float4 qv[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * DS + c);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(k_s + (tx + 8 * j) * DS + c);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // online softmax in the log2 domain
    const bool edge =
        k0 + F_BK > t_k || (causal && q_offset + q0 < k0 + F_BK - 1);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int row = q_offset + q0 + ty + 16 * i;
      float mx = __int_as_float(0xff800000);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float x = s[i][j] * scale_log2;
        if (edge) {
          const int col = k0 + tx + 8 * j;
          if (col >= t_k) {
            x = __int_as_float(0xff800000);  // -inf: not a key, weight 0
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
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * P_STRIDE + tx + 8 * j] = p;
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr;
    }
    __syncthreads();   // P is in

    // O += P V: per 4 keys, MI + 4 NG LDS.128 for 16 MI NG FMAs
#pragma unroll
    for (int j = 0; j < F_BK; j += 4) {
      float4 pv[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            p_s + (ty + 16 * i) * P_STRIDE + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              v_s + (j + u) * DS + 32 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const float p = u == 0 ? pv[i].x
                          : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z
                                   : pv[i].w;
            acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    const int r = q0 + ty + 16 * i;
    if (r >= t_q) continue;
    const float inv = 1.f / fmaxf(li, 1e-20f);
    float* o_row = o_bh + (int64_t)r * rs;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = 32 * g + 4 * tx;
      if constexpr (VEC == 16) {
        if (col < d)
          *reinterpret_cast<float4*>(o_row + col) =
              make_float4(acc[i][g][0] * inv, acc[i][g][1] * inv,
                          acc[i][g][2] * inv, acc[i][g][3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) o_row[col + e] = acc[i][g][e] * inv;
      }
    }
  }
}

// --------------------------------------------- fp32, head dim 129-256

// flash_fwd_f32_wide: d from 129 to 256, all of d in one block, so that
// S = Q K^T is computed once per K tile (a split over d computes it once
// per 128-wide chunk of the output's columns, 1.5x the work at d = 256).
// Bound at (2, 2048, 4, 256) fp32 causal: the same 17.2 GFLOP as the LM's
// shape above (B*H*d is equal), 0.257 ms at 67 TFLOP/s.
//   * one block of 256 threads (8 warps) per (Q-tile pair, batch*head):
//     instantiations at widths 192 and 256, the columns past d zero in
//     shared memory; 64 Q rows a tile, 8 a warp; K/V tiles of 32 rows;
//   * causal balance: block y takes Q tiles n - 1 - y and y of its head one
//     after the other (an odd count leaves the middle tile alone), so every
//     block does the same number of K tiles: at (2, 2048, 4, 256) 128 blocks
//     of 66 K tiles each, one wave on 132 SMs (one tile a block, heaviest
//     first, reads 3 % faster there: the card's scheduler balances the
//     256 blocks as well, on all 132 SMs);
//   * Q is staged once per Q tile; K and V tiles go through a two-stage
//     cp.async ring, tile n + 1 in flight while tile n computes, as in
//     flash_fwd_f32, with 16- or 4-byte copies (VEC) and zero-fill past T
//     and d;
//   * what sets the pace is shared memory: a warp's LDS.128 delivers 512
//     bytes, 4 of the SM's 128-byte clocks, broadcast or not, while the SM
//     issues 4 warp FMAs a clock. A first design with flash_fwd_f32's
//     layout at 256 threads (8 scores and 2 x 32 outputs a thread: 5.3 and
//     7.5 FMAs per LDS.128) read 0.747 ms, the time that count predicts.
//     So the register tiles are as large as 64 x 32 scores over 8 warps
//     allow:
//     - Q K^T: warp w takes rows 8w..8w+7 against all 32 keys; lane
//       (x, ds) = (lane / W_SPLIT, lane % W_SPLIT) sums keys
//       W_SPLIT x + j (j < W_SPLIT) of its 8 rows over d's float4 chunks
//       4 ds + 4 W_SPLIT k, a 8 x 8 tile: per float4 chunk, 8 Q and 8 K
//       LDS.128 (a quarter-warp reads 8 consecutive chunks of one row: no
//       conflict) for 256 FMAs, 16 per LDS. The 8 lanes' partial sums go
//       to one lane each by a reduce-scatter of shuffles (56 a tile),
//       which leaves each lane one row x 8 keys for the softmax. A split
//       over 4 lanes (8 x 4, 10.7 FMAs per LDS) read 0.546 ms against
//       0.544 (tools/flash_tile_sweep.py --kernel f32wide);
//     - P V: thread (ry, cx) owns output rows RM ry + i x columns 4 cx +
//       4 CT g: 8 rows x 2 float4 groups at width 256 (16 FMAs per LDS),
//       4 x 3 at 192 (12). Its rows are its warp's, so P, the rows'
//       corrections and sums pass through shared memory under a
//       __syncwarp; a K tile needs one __syncthreads (its copy landed,
//       and every warp is done with the stage the next copy overwrites);
//   * shared memory (dynamic only): Q 66.6 KB, 2 stages of K and V 133.1 KB,
//     P 9.2 KB and 64 row values, 209.2 KB at width 256 (160.0 KB at 192):
//     one block an SM; __launch_bounds__(256, 1) leaves up to 255
//     registers a thread.
// Measured on an H100 SXM at 700 W (tools/flash_tile_sweep.py --kernel
// f32wide; chip_smoke.py phase 3, PERF.md): 0.544 ms at (2, 2048, 4, 256)
// causal, 47 % of the bound, against 0.587 for scaled_dot_product_attention
// and 0.912 for a split over d; 0.430 at d = 192 against 0.529. What it
// leaves on the table: no tensor cores (3xTF32, ROADMAP B1c); one block an
// SM, so a barrier's wait is not covered by another block's work; the Q
// K^T loop not unrolled (unrolled fully it read 0.507 but spilled).
constexpr int W_THREADS = 256;   // 8 warps, 8 Q rows each
constexpr int W_BQ = 64;         // Q rows a tile; a block takes two tiles
constexpr int W_D = 256;         // widest head dim of the kernel
constexpr int W_SPLIT = 8;       // lanes that split d for one score tile
constexpr int W_PS = F_BK + 4;   // P row stride: adjacent rows 4 banks apart

// the P V thread tile at width DP: CG float4 column groups, CT threads
// along the columns, RM rows a thread
template <int DP>
struct WideTile {
  static_assert(DP == 192 || DP == 256, "widths 192 and 256");
  static_assert(W_SPLIT == 4 || W_SPLIT == 8, "d splits over 4 or 8 lanes");
  static constexpr int CG = DP == 256 ? 2 : 3;
  static constexpr int CT = DP / (4 * CG);
  static constexpr int RM = W_BQ * CT / W_THREADS;
};

// Round R of the reduce-scatter of 8 rows of partial scores over the
// SPLIT lanes of a key group: the lane keeps half of its rows (its bit
// SPLIT >> (R + 1) picks which) and adds the partner's partial sums of
// them. After the last round s[e] holds row 8 / SPLIT * ds + e. Every
// index is a constant, so s stays in registers.
template <int R, int SPLIT, int KPT>
__device__ __forceinline__ void reduce_scatter(float (&s)[8][KPT], int ds) {
  if constexpr ((SPLIT >> (R + 1)) > 0) {
    constexpr int bit = SPLIT >> (R + 1);
    constexpr int half = 4 >> R;
    const bool hi = ds & bit;
#pragma unroll
    for (int i = 0; i < half; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float send = hi ? s[i][j] : s[i + half][j];
        const float keep = hi ? s[i + half][j] : s[i][j];
        s[i][j] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
      }
    reduce_scatter<R + 1, SPLIT, KPT>(s, ds);
  }
}

template <int DP>
constexpr size_t f32_wide_smem_bytes() {
  return sizeof(float) * ((size_t)(W_BQ + 4 * F_BK) * (DP + F_PAD) +
                          (size_t)W_BQ * W_PS + W_BQ);
}

template <int DP, int VEC>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_fwd_f32_wide(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   int t_q, int t_k, int heads, int d, float scale_log2,
                   int causal, int q_offset) {
  using L = WideTile<DP>;
  constexpr int DS = DP + F_PAD;        // shared row stride of Q, K, V
  constexpr int STAGE = 2 * F_BK * DS;
  constexpr int KPT = F_BK * W_SPLIT / 32;   // keys a lane sums
  constexpr int RPL = 8 / W_SPLIT;      // rows a lane owns in the softmax
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // W_BQ x DS
  float* kv_s = q_s + W_BQ * DS;   // 2 stages of [K tile, V tile], F_BK x DS
  float* p_s = kv_s + 2 * STAGE;   // W_BQ x W_PS
  float* r_s = p_s + W_BQ * W_PS;  // a row's correction, then its sum

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ds = lane % W_SPLIT;    // Q K^T: d's float4 chunks 4 ds + ...
  const int x = lane / W_SPLIT;     // ... for keys KPT x + j
  const int cx = threadIdx.x % L::CT;   // P V: columns 4 cx + 4 CT g
  const int ry = threadIdx.x / L::CT;   // rows RM ry + i
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int rs = heads * d;         // row stride of (B, T, H, D)
  const int n_q = (t_q + W_BQ - 1) / W_BQ;

  const float* q_bh = q + ((int64_t)b * t_q * heads + h) * d;
  const float* k_bh = k + ((int64_t)b * t_k * heads + h) * d;
  const float* v_bh = v + ((int64_t)b * t_k * heads + h) * d;
  float* o_bh = o + ((int64_t)b * t_q * heads + h) * d;

  // Q tile n_q - 1 - y (the longer under the causal mask), then tile y
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      if (2 * (int)blockIdx.y + 1 >= n_q) break;   // the middle tile, alone
      // every thread is done with the first tile's Q, K/V stages and P
      __syncthreads();
    }
    const int q_tile =
        pass == 0 ? n_q - 1 - (int)blockIdx.y : (int)blockIdx.y;
    const int q0 = q_tile * W_BQ;
    int n_tiles = (t_k + F_BK - 1) / F_BK;
    if (causal) {
      // last query row of this tile, in key coordinates
      const int last = q_offset + min(q0 + W_BQ, t_q) - 1;
      n_tiles = min(n_tiles, last / F_BK + 1);
    }

    stage_tile<W_BQ, DP, VEC, W_THREADS>(q_s, q_bh, q0, t_q, rs, d);
    stage_tile<F_BK, DP, VEC, W_THREADS>(kv_s, k_bh, 0, t_k, rs, d);
    stage_tile<F_BK, DP, VEC, W_THREADS>(kv_s + F_BK * DS, v_bh, 0, t_k, rs,
                                         d);
    cp_async_commit();

    float acc[L::RM][L::CG][4];
    float m[RPL], l[RPL];   // l: this lane's partial sums of its rows
#pragma unroll
    for (int e = 0; e < RPL; ++e) {
      m[e] = MASKED;
      l[e] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < L::RM; ++i)
#pragma unroll
      for (int g = 0; g < L::CG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;

    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * F_BK;
      const float* k_s = kv_s + (kt & 1) * STAGE;
      const float* v_s = k_s + F_BK * DS;
      cp_async_wait_all();
      // tile kt is in for every thread, and every thread is done with
      // tile kt - 1's stage
      __syncthreads();
      if (kt + 1 < n_tiles) {
        float* nxt = kv_s + ((kt + 1) & 1) * STAGE;
        stage_tile<F_BK, DP, VEC, W_THREADS>(nxt, k_bh, k0 + F_BK, t_k, rs,
                                             d);
        stage_tile<F_BK, DP, VEC, W_THREADS>(nxt + F_BK * DS, v_bh,
                                             k0 + F_BK, t_k, rs, d);
        cp_async_commit();
      }

      // S = Q K^T over this lane's chunks of d: per float4 chunk, KPT K
      // and 8 Q LDS.128 for 32 KPT FMAs (not unrolled: unrolled by 2 or
      // fully, the kernel spills at 255 registers)
      float s[8][KPT];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 1
      for (int kk = 0; kk < DP / (4 * W_SPLIT); ++kk) {
        const int c = 4 * (ds + W_SPLIT * kk);
        float4 kv[KPT];
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          kv[j] = *reinterpret_cast<const float4*>(
              k_s + (KPT * x + j) * DS + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(
              q_s + (8 * warp + i) * DS + c);
#pragma unroll
          for (int j = 0; j < KPT; ++j) {
            s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
          }
        }
      }
      reduce_scatter<0, W_SPLIT>(s, ds);

      // online softmax in the log2 domain, as in flash_fwd_f32; the row's
      // max reduces over its key groups, the lanes W_SPLIT apart
      const bool edge =
          k0 + F_BK > t_k || (causal && q_offset + q0 < k0 + F_BK - 1);
#pragma unroll
      for (int e = 0; e < RPL; ++e) {
        const int r = 8 * warp + RPL * ds + e;   // row in the tile
        const int row = q_offset + q0 + r;
        float mx = __int_as_float(0xff800000);
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          float xs = s[e][j] * scale_log2;
          if (edge) {
            const int col = k0 + KPT * x + j;
            if (col >= t_k) {
              xs = __int_as_float(0xff800000);  // -inf: not a key, weight 0
            } else if (causal && row < col) {
              xs = MASKED;
            }
          }
          s[e][j] = xs;
          mx = fmaxf(mx, xs);
        }
#pragma unroll
        for (int w = W_SPLIT; w < 32; w *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
        const float m_new = fmaxf(m[e], mx);
        const float corr = exp2f(m[e] - m_new);
        m[e] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KPT; j += 4) {
          float4 p;
          p.x = exp2f(s[e][j] - m_new);
          p.y = exp2f(s[e][j + 1] - m_new);
          p.z = exp2f(s[e][j + 2] - m_new);
          p.w = exp2f(s[e][j + 3] - m_new);
          sum += (p.x + p.y) + (p.z + p.w);
          *reinterpret_cast<float4*>(p_s + r * W_PS + KPT * x + j) = p;
        }
        l[e] = l[e] * corr + sum;
        if (x == 0) r_s[r] = corr;
      }
      // the warp's own rows of P and their corrections are in
      __syncwarp();

      // O += P V: per 4 keys, RM P and 4 CG V LDS.128 for 16 RM CG FMAs
#pragma unroll
      for (int i = 0; i < L::RM; ++i) {
        const float corr = r_s[L::RM * ry + i];
#pragma unroll
        for (int g = 0; g < L::CG; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr;
      }
#pragma unroll 2
      for (int j = 0; j < F_BK; j += 4) {
        float4 pv[L::RM];
#pragma unroll
        for (int i = 0; i < L::RM; ++i)
          pv[i] = *reinterpret_cast<const float4*>(
              p_s + (L::RM * ry + i) * W_PS + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int g = 0; g < L::CG; ++g) {
            const float4 vv = *reinterpret_cast<const float4*>(
                v_s + (j + u) * DS + 4 * cx + 4 * L::CT * g);
#pragma unroll
            for (int i = 0; i < L::RM; ++i) {
              const float p = u == 0 ? pv[i].x
                            : u == 1 ? pv[i].y
                            : u == 2 ? pv[i].z
                                     : pv[i].w;
              acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
              acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
              acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
              acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
            }
          }
        }
      }
    }

    // each row's sum over its key groups, passed to the lanes that write
    // the row (every lane of the warp is done reading the corrections)
    __syncwarp();
#pragma unroll
    for (int e = 0; e < RPL; ++e) {
      float li = l[e];
#pragma unroll
      for (int w = W_SPLIT; w < 32; w *= 2)
        li += __shfl_xor_sync(0xffffffffu, li, w);
      if (x == 0) r_s[8 * warp + RPL * ds + e] = li;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < L::RM; ++i) {
      const int r = q0 + L::RM * ry + i;
      if (r >= t_q) continue;
      const float inv = 1.f / fmaxf(r_s[L::RM * ry + i], 1e-20f);
      float* o_row = o_bh + (int64_t)r * rs;
#pragma unroll
      for (int g = 0; g < L::CG; ++g) {
        const int col = 4 * cx + 4 * L::CT * g;
        if constexpr (VEC == 16) {
          if (col < d)
            *reinterpret_cast<float4*>(o_row + col) =
                make_float4(acc[i][g][0] * inv, acc[i][g][1] * inv,
                            acc[i][g][2] * inv, acc[i][g][3] * inv);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < d) o_row[col + e] = acc[i][g][e] * inv;
        }
      }
    }
  }
}

// ------------------------------------------------- fp32, head dim > 256

// flash_fwd_f32_cluster: every d above 256, where Q and two K/V stages at
// all of d do not fit one SM's shared memory (Q alone is 132 KB at d 512).
// Bound at (2, 2048, 2, 512) fp32 causal: the same 17.2 GFLOP as
// flash_fwd_f32's shape (B*H*d is equal), 0.257 ms at 67 TFLOP/s.
//   * d splits into n = ceil(d / C_W) chunks of 128 columns. Up to C_MAX
//     chunks one thread-block cluster of C = n blocks along z per (64-row
//     Q tile, batch*head); above, G = ceil(n / C_MAX) groups of C =
//     ceil(n / G) blocks, G C blocks on the grid's z, the cluster
//     dimension (1, 1, C) (cluster_shape). Block z, rank r = z % C of
//     group z / C, writes columns [z C_W, (z + 1) C_W) of O (none where
//     z >= n) and reduces the partial S of chunks r, r + C, r + 2C, ...
//     (kc = ceil(n / C) of them, the ones at or past n zero), so that each
//     group covers all of d and S is computed once a group: once up to
//     d = C_W C_MAX, G times above (a split over d computes it n times).
//     Clusters of more than 8 blocks are the card's non-portable sizes,
//     allowed on the kernel once per device. The Q tiles run from the
//     last, so the heaviest causal clusters start first. The card holds
//     62 clusters of 4 blocks at once (79 of 3, 30 of 8, 14 of 16; at 2-4
//     Q chunks a block 9 of 9 blocks, 7 of 10-16; phase 2 of chip_smoke.py
//     asks for every size), so 128 equal non-causal clusters of 4 run in
//     three waves, the last nearly empty;
//   * per K tile each block computes only its chunks' partial
//     S_r = Q_r K_r^T (64 x 32, flash_fwd_f32's register tiling at D = 128:
//     4 rows x 4 keys a thread; a block's chunks added in order into the
//     same registers), so the cluster computes S once. The partials meet
//     through distributed shared memory: each block stores its own,
//     thread-major (a thread's 4 float4 at stride 128 threads), in one of
//     two buffers; one cluster barrier (arrive.release / wait.acquire) a K
//     tile; then each thread reads its 16 values from every rank (mapa,
//     ld.shared::cluster; two ranks' loads in flight) and adds them in
//     rank order, so that S, the row max m, the sum l and P are
//     bit-identical in every block of every group (each group's rank r
//     reduces the same chunks in the same order), and every column chunk
//     is normalised by the same l. The second buffer lets tile n + 1's
//     partials go in while a slow peer still reads tile n's: a block
//     writes a buffer again only after the next barrier, which every peer
//     reaches after its reads;
//   * then the online softmax of flash_fwd_f32 (log2 domain, masks only on
//     tiles that cross the diagonal or T_k, causal K tiles past the
//     diagonal skipped) and P V over the block's own chunk of V; each block
//     writes its own columns of O as o / max(l, 1e-20);
//   * a block stages its kc Q chunks once per Q tile where they fit (kc <=
//     C_QRES: every d up to C_W C_MAX C_QRES), else it streams each
//     chunk's Q beside its K through a ring of two Q slots; K chunks go
//     through a two-stage cp.async ring, a step (K tile, chunk) at a time,
//     step n + 1 in flight while step n computes; V through one buffer (V
//     of tile n + 1 is copied from the end of tile n's P V, in flight under
//     tile n + 1's Q K^T, exchange and softmax); copies of 16 or 4 bytes
//     (VEC), rows past T and columns past d zero-filled, so the last,
//     ragged chunk and the chunks past n add exact zeros;
//   * shared memory: a Q chunk 33.8 KB, 2 K and 1 V buffer 50.7 KB, P 10.2
//     KB, two partial buffers 16.4 KB: 111.1 KB at one Q chunk, two blocks
//     an SM; 144.9-212.5 KB at 2-4 chunks (or a ring of 2), one block;
//   * the launch (cudaLaunchKernelEx, cluster dimension (1, 1, C) at run
//     time) first asks cudaOccupancyMaxActiveClusters, once per device, C
//     and Q slots, whether such a cluster can be placed, and returns an
//     error if not; every block ends on a cluster barrier, so that none
//     exits while a peer still reads its partials.
// The tile constants were chosen on the card among chunk widths 64 and
// 128, K/V tiles of 32 and 64 rows, one or two V buffers and blocks an SM,
// clusters of at most 16 or 8 blocks, Q chunks kept or streamed, and this
// exchange (an all-gather of the partials) against a reduce-scatter of
// S's rows with an all-gather of P, which adds a second barrier a tile
// (tools/flash_tile_sweep.py --kernel f32cluster; PERF.md).
// Measured on an H100 SXM at 700 W (chip_smoke.py phase 3 and the sweep,
// device time): 0.639-0.651 ms at (2, 2048, 2, 512) causal, 39 % of the
// bound, against 0.824 for scaled_dot_product_attention and 2.31 for a
// split over d; 0.996 at (2, 2048, 4, 320) causal (the split 2.319, the
// library 0.818); 0.795 at (2, 2048, 1, 1000) (1.109); 1.144 at (2, 2048,
// 1, 1100), 9 blocks (1.234; the split 4.79; two groups of 5 at C_MAX 8
// 2.11); 2.744 at (2, 2048, 1, 2048), 16 blocks (2.25); 3.02 at (1, 2048,
// 1, 2100), two groups of 9 (2.22; streamed Q chunks 3.35). The same
// arithmetic without the exchange and barrier reads 0.575 at d 512, and
// flash_fwd_f32 at (2, 2048, 8, 128), the same operations, 0.522. What it
// leaves on the table: the exchange at 16 blocks (each reads 15 peers'
// partials a tile; the reduce-scatter reads 1.88 there, but 0.755 at d
// 512); non-causal, 1.64 against the library's 0.91, runs 128 clusters
// in three waves of 62; d 320 pads its last chunk to 128 columns (64-wide
// chunks read 7 % less there, 43 % more at d 512); no tensor cores
// (ROADMAP B1c).
constexpr int C_W = 128;        // d-chunk width: a block's columns of d
constexpr int C_BQ = 64;        // Q rows a cluster
constexpr int C_BK = 32;        // K/V rows a tile
constexpr int C_BLOCKS = 2;     // blocks an SM (__launch_bounds__)
constexpr int C_MAX = 16;       // blocks a cluster: the card's largest
constexpr int C_QRES = 4;       // Q chunks a block keeps for a Q tile
constexpr int C_SLOTS = C_QRES > 2 ? C_QRES : 2;   // Q slots at most
constexpr int C_NJ = C_BK / 8;  // score columns a thread
constexpr int C_PS = C_BK + 8;  // P row stride

// shared memory of a block that holds `q_slots` Q chunks
constexpr size_t f32_cluster_smem_bytes(int q_slots) {
  return sizeof(float) *
         ((size_t)(q_slots * C_BQ + 3 * C_BK) * (C_W + F_PAD) +
          (size_t)C_BQ * C_PS + 2 * (size_t)C_BQ * C_BK);
}

// The clusters of head dim d: `groups` of `blocks` blocks, each block
// reducing `chunks` 128-wide chunks of d
struct ClusterShape {
  int groups, blocks, chunks;
};
inline ClusterShape cluster_shape(int d) {
  const int n = (d - 1) / C_W + 1;
  const int g = (n - 1) / C_MAX + 1;
  const int c = (n - 1) / g + 1;
  return {g, c, (n - 1) / c + 1};
}
// the Q chunks a block holds: all of its chunks where they fit, else a
// ring of two
constexpr int cluster_q_slots(int chunks) {
  return chunks <= C_QRES ? chunks : 2;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// the shared address `addr` of this block mapped into block `rank` of the
// cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int VEC>
__global__ void __launch_bounds__(F_THREADS, C_BLOCKS)
flash_fwd_f32_cluster(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int t_q, int t_k, int heads, int d, float scale_log2,
                      int causal, int q_offset, int kc, int q_slots) {
  constexpr int MI = C_BQ / 16;         // score and output rows a thread
  constexpr int NG = C_W / 32;          // float4 output column groups
  constexpr int DS = C_W + F_PAD;       // shared row stride of Q, K, V
  constexpr int XE = MI * C_NJ / 4;     // float4 partials a thread
  constexpr int XB = XE * F_THREADS;    // float4 a partial buffer
  const uint32_t rank = cluster_rank();
  const uint32_t n_ranks = cluster_blocks();
  // the block reduces the kc chunks of d rank + u n_ranks, u < kc
  // (cluster_shape), and holds q_slots of their Q chunks
  const bool resident = kc <= C_QRES;   // every Q chunk staged once
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // q_slots x C_BQ x DS
  float* k_s = q_s + q_slots * C_BQ * DS;  // 2 stages, C_BK x DS
  float* v_s = k_s + 2 * C_BK * DS;        // C_BK x DS
  float* p_s = v_s + C_BK * DS;            // C_BQ x C_PS
  float4* x_s = reinterpret_cast<float4*>(p_s + C_BQ * C_PS);   // 2 x XB

  const int tid = threadIdx.x;
  const int tx = tid & 7;    // score columns tx + 8j; output 32g + 4tx
  const int ty = tid >> 3;   // rows ty + 16i
  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;   // heaviest causal first
  const int c_out = (int)blockIdx.z * C_W;   // the block's output columns
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = q_tile * C_BQ;
  const int rs = heads * d;

  const float* q_bh = q + ((int64_t)b * t_q * heads + h) * d;
  const float* k_bh = k + ((int64_t)b * t_k * heads + h) * d;
  const float* v_bh = v + ((int64_t)b * t_k * heads + h) * d + c_out;
  float* o_bh = o + ((int64_t)b * t_q * heads + h) * d;
  // the first column of d of the block's chunk u
  const auto chunk_col = [&](int u) {
    return ((int)rank + u * (int)n_ranks) * C_W;
  };

  // every block of the cluster has the same Q tile, so the same K tiles
  int n_tiles = (t_k + C_BK - 1) / C_BK;
  if (causal) {
    const int last = q_offset + min(q0 + C_BQ, t_q) - 1;
    n_tiles = min(n_tiles, last / C_BK + 1);
  }
  const int n_steps = n_tiles * kc;   // step kt kc + u: K tile kt, chunk u

  // cp.async groups, in order: Q and K(step 0), V(0), then the K (and,
  // streamed, the Q) of step n + 1 from the start of step n and V(kt + 1)
  // from the end of tile kt; empty groups keep the count
  for (int u = 0; u < (resident ? kc : 1); ++u)
    stage_tile<C_BQ, C_W, VEC>(q_s + u * C_BQ * DS, q_bh + chunk_col(u), q0,
                               t_q, rs, d - chunk_col(u));
  stage_tile<C_BK, C_W, VEC>(k_s, k_bh + chunk_col(0), 0, t_k, rs,
                             d - chunk_col(0));
  cp_async_commit();
  stage_tile<C_BK, C_W, VEC>(v_s, v_bh, 0, t_k, rs, d - c_out);
  cp_async_commit();

  float acc[MI][NG][4];
  float m[MI], l[MI];   // l: this thread's partial row sums
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * C_BK;
    // this block's partial S over its chunks of d
    float s[MI][C_NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < C_NJ; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int u = 0; u < kc; ++u) {
      const int step = kt * kc + u;
      // the step's K (and Q) are in: at a tile's first step V(kt), the
      // group after them, may still be in flight
      if (u == 0) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      // ... for every thread, and every thread is done with the buffers
      // the next copies overwrite
      __syncthreads();
      if (step + 1 < n_steps) {
        const int nu = u + 1 < kc ? u + 1 : 0;
        const int nk = u + 1 < kc ? k0 : k0 + C_BK;
        const int slot = (step + 1) & 1;
        const int c = chunk_col(nu);
        stage_tile<C_BK, C_W, VEC>(k_s + slot * C_BK * DS, k_bh + c, nk, t_k,
                                   rs, d - c);
        if (!resident)
          stage_tile<C_BQ, C_W, VEC>(q_s + slot * C_BQ * DS, q_bh + c, q0,
                                     t_q, rs, d - c);
      }
      cp_async_commit();
      const float* qc = q_s + (resident ? u : step & 1) * C_BQ * DS;
      const float* kc_s = k_s + (step & 1) * C_BK * DS;
#pragma unroll
      for (int c = 0; c < C_W; c += 4) {
        float4 qv[MI];
#pragma unroll
        for (int i = 0; i < MI; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qc + (ty + 16 * i) * DS + c);
#pragma unroll
        for (int j = 0; j < C_NJ; ++j) {
          const float4 kv =
              *reinterpret_cast<const float4*>(kc_s + (tx + 8 * j) * DS + c);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }
    }

    // S = the cluster's partials summed in rank order
    float4* xb = x_s + (kt & 1) * XB;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int jj = 0; jj < C_NJ / 4; ++jj)
        xb[(i * (C_NJ / 4) + jj) * F_THREADS + tid] =
            make_float4(s[i][4 * jj], s[i][4 * jj + 1], s[i][4 * jj + 2],
                        s[i][4 * jj + 3]);
    cluster_arrive();
    cluster_wait();
    const uint32_t xa =
        static_cast<uint32_t>(__cvta_generic_to_shared(xb + tid));
    float4 sum[XE];
    // two ranks' loads in flight (unrolled further, the kernel spills)
#pragma unroll 2
    for (uint32_t r = 0; r < n_ranks; ++r) {
      float4 p[XE];
      if (r == rank) {
#pragma unroll
        for (int e = 0; e < XE; ++e) {
          const int i = e / (C_NJ / 4), j = 4 * (e % (C_NJ / 4));
          p[e] = make_float4(s[i][j], s[i][j + 1], s[i][j + 2], s[i][j + 3]);
        }
      } else {
        const uint32_t ra = map_rank(xa, r);
#pragma unroll
        for (int e = 0; e < XE; ++e)
          p[e] = ld_cluster(ra + e * F_THREADS * 16);   // 16: a float4
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

    // online softmax in the log2 domain, as in flash_fwd_f32
    const bool edge =
        k0 + C_BK > t_k || (causal && q_offset + q0 < k0 + C_BK - 1);
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
            x = __int_as_float(0xff800000);   // -inf: not a key, weight 0
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
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < C_NJ; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        rsum += p;
        p_s[(ty + 16 * i) * C_PS + tx + 8 * j] = p;
      }
      l[i] = l[i] * corr + rsum;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr;
    }
    cp_async_wait<1>();   // V(kt) is in (K(kt + 1) may still be in flight)
    __syncthreads();   // P and V(kt) are in for every thread

    // O += P V over this block's columns
#pragma unroll
    for (int j = 0; j < C_BK; j += 4) {
      float4 pv[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * C_PS +
                                                 j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              v_s + (j + u) * DS + 32 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            const float p = u == 0 ? pv[i].x
                          : u == 1 ? pv[i].y
                          : u == 2 ? pv[i].z
                                   : pv[i].w;
            acc[i][g][0] = fmaf(p, vv.x, acc[i][g][0]);
            acc[i][g][1] = fmaf(p, vv.y, acc[i][g][1]);
            acc[i][g][2] = fmaf(p, vv.z, acc[i][g][2]);
            acc[i][g][3] = fmaf(p, vv.w, acc[i][g][3]);
          }
        }
      }
    }
    __syncthreads();   // every thread is done with V(kt) and P
    if (kt + 1 < n_tiles)
      stage_tile<C_BK, C_W, VEC>(v_s, v_bh, k0 + C_BK, t_k, rs, d - c_out);
    cp_async_commit();
  }

  float row_l[MI];   // each row's sum
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    row_l[i] = l[i];
    row_l[i] += __shfl_xor_sync(0xffffffffu, row_l[i], 1);
    row_l[i] += __shfl_xor_sync(0xffffffffu, row_l[i], 2);
    row_l[i] += __shfl_xor_sync(0xffffffffu, row_l[i], 4);
  }
  // no block leaves while a peer may still read its last partials
  cluster_arrive();
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t_q) continue;
    const float inv = 1.f / fmaxf(row_l[i], 1e-20f);
    float* o_row = o_bh + (int64_t)r * rs;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = c_out + 32 * g + 4 * tx;
      if constexpr (VEC == 16) {
        if (col < d)
          *reinterpret_cast<float4*>(o_row + col) =
              make_float4(acc[i][g][0] * inv, acc[i][g][1] * inv,
                          acc[i][g][2] * inv, acc[i][g][3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) o_row[col + e] = acc[i][g][e] * inv;
      }
    }
  }
  cluster_wait();
}

// ---------------------------------------------------------------- launch

// Set `attr` of `kernel` to `value` on the current device, once per device
// and kernel (one static `done` per instantiation of the caller), not at
// every launch.
template <typename Kernel>
cudaError_t set_once(Kernel kernel, cudaFuncAttribute attr, int value,
                     std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, attr, value);
  if (err == cudaSuccess) {
    done.fetch_or(bit, std::memory_order_release);
  } else {
    cudaGetLastError();   // returned here; not left for a later launch
  }
  return err;
}

// Let `kernel` use `bytes` of dynamic shared memory on the current device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       std::atomic<uint64_t>& done) {
  return set_once(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                  (int)bytes, done);
}

template <int DP, int VEC>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int batch, int t_q, int t_k, int heads, int d,
                       float scale, int causal, int q_offset,
                       cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  constexpr size_t smem = f32_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_fwd_f32<DP, VEC>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * heads, (t_q + f32_bq<DP>() - 1) / f32_bq<DP>());
  flash_fwd_f32<DP, VEC><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), t_q, t_k, heads,
      d, scale * LOG2E, causal, q_offset);
  return cudaGetLastError();
}

// Whether a cluster of `config`'s size can be placed on the current
// device at `kernel`'s shared memory and registers; asked once per device
// (the caller keeps one `done` per kernel and cluster size).
template <typename Kernel>
cudaError_t cluster_placeable(Kernel kernel, const cudaLaunchConfig_t& config,
                              std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(kernel), &config);
  if (err != cudaSuccess) {
    cudaGetLastError();   // returned here; not left for a later launch
    return err;
  }
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

// The launch of flash_fwd_f32_cluster<VEC> over (x, y) clusters of
// `blocks` blocks, `groups` of them along z, each block holding `slots` Q
// chunks: its config (pointing at `cluster`), after the kernel's largest
// dynamic shared memory and clusters of up to C_MAX blocks (past 8, the
// card's non-portable sizes) have been allowed on the current device.
template <int VEC>
cudaError_t cluster_config(int x, int y, int groups, int blocks, int slots,
                           cudaStream_t stream, cudaLaunchAttribute& cluster,
                           cudaLaunchConfig_t& config) {
  static std::atomic<uint64_t> smem_set{0}, size_set{0};
  const auto kernel = flash_fwd_f32_cluster<VEC>;
  cudaError_t err =
      allow_smem(kernel, f32_cluster_smem_bytes(C_SLOTS), smem_set);
  if (err == cudaSuccess)
    err = set_once(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                   1, size_set);
  if (err != cudaSuccess) return err;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = blocks;
  config = {};
  config.gridDim = dim3(x, y, groups * blocks);
  config.blockDim = dim3(F_THREADS);
  config.dynamicSmemBytes = f32_cluster_smem_bytes(slots);
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaSuccess;
}

template <int VEC>
cudaError_t launch_f32_cluster(const void* q, const void* k, const void* v,
                               void* o, int batch, int t_q, int t_k,
                               int heads, int d, float scale, int causal,
                               int q_offset, cudaStream_t stream) {
  // by cluster size and Q slots
  static std::atomic<uint64_t> placed[C_MAX + 1][C_SLOTS + 1];
  const auto kernel = flash_fwd_f32_cluster<VEC>;
  const ClusterShape shape = cluster_shape(d);
  const int slots = cluster_q_slots(shape.chunks);
  cudaLaunchAttribute cluster;
  cudaLaunchConfig_t config;
  cudaError_t err = cluster_config<VEC>(
      batch * heads, (t_q + C_BQ - 1) / C_BQ, shape.groups, shape.blocks,
      slots, stream, cluster, config);
  if (err != cudaSuccess) return err;
  err = cluster_placeable(kernel, config, placed[shape.blocks][slots]);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const float*>(q),
                           static_cast<const float*>(k),
                           static_cast<const float*>(v),
                           static_cast<float*>(o), t_q, t_k, heads, d,
                           scale * LOG2E, causal, q_offset, shape.chunks,
                           slots);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

template <int DP, int VEC>
cudaError_t launch_f32_wide(const void* q, const void* k, const void* v,
                            void* o, int batch, int t_q, int t_k, int heads,
                            int d, float scale, int causal, int q_offset,
                            cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  constexpr size_t smem = f32_wide_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_fwd_f32_wide<DP, VEC>, smem, smem_set);
  if (err != cudaSuccess) return err;
  // block y takes Q tiles y and n - 1 - y
  const int n_q = (t_q + W_BQ - 1) / W_BQ;
  dim3 grid(batch * heads, (n_q + 1) / 2);
  flash_fwd_f32_wide<DP, VEC><<<grid, W_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), t_q, t_k, heads,
      d, scale * LOG2E, causal, q_offset);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         int batch, int t_q, int t_k, int heads, int d,
                         float scale, int causal, int q_offset,
                         cudaStream_t stream) {
  if (d > W_D)
    return launch_f32_cluster<VEC>(q, k, v, o, batch, t_q, t_k, heads, d,
                                   scale, causal, q_offset, stream);
  if (d > 192)
    return launch_f32_wide<256, VEC>(q, k, v, o, batch, t_q, t_k, heads, d,
                                     scale, causal, q_offset, stream);
  if (d > 128)
    return launch_f32_wide<192, VEC>(q, k, v, o, batch, t_q, t_k, heads, d,
                                     scale, causal, q_offset, stream);
  if (d <= 32)
    return launch_f32<32, VEC>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                               causal, q_offset, stream);
  if (d <= 64)
    return launch_f32<64, VEC>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                               causal, q_offset, stream);
  return launch_f32<128, VEC>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                              causal, q_offset, stream);
}

}  // namespace

// How many clusters of `blocks` blocks of flash_fwd_f32_cluster (16-byte
// copies), each block holding `slots` Q chunks, the current device holds at
// once (cudaOccupancyMaxActiveClusters), or minus the cudaError_t of the
// query. A head dim d launches cluster_shape(d).blocks blocks at
// cluster_q_slots(cluster_shape(d).chunks) slots: 1 slot up to d
// 128 C_MAX, 2 to C_SLOTS above.
extern "C" int mxtt_flash_attention_fwd_clusters(int blocks, int slots) {
  if (blocks < 1 || blocks > C_MAX || slots < 1 || slots > C_SLOTS)
    return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute cluster;
  cudaLaunchConfig_t config;
  cudaError_t err =
      cluster_config<16>(1, 1, 1, blocks, slots, nullptr, cluster, config);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void*>(flash_fwd_f32_cluster<16>),
        &config);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return clusters;
}

// q: (batch, t_q, heads, d), k/v: (batch, t_k, heads, d), o like q; all
// contiguous, on the current device. dtype must be 0, float32 (1 and 2,
// bfloat16 and float16, are flash_attention_fwd_tc.cu's). copy_bytes (16 or
// 4) is the cp.async width: 16 needs d % 4 == 0 and 16-byte aligned q, k, v
// and o. Returns the cudaError_t of the launch (0 on success).
extern "C" int mxtt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, int batch,
                                        int t_q, int t_k, int heads, int d,
                                        float scale, int causal, int q_offset,
                                        int dtype, int copy_bytes,
                                        void* stream) {
  // grid: batch * heads on x (< 2^31); on y Q tiles of at least 64 rows,
  // or pairs of 64-row tiles (flash_fwd_f32_wide, d 129-256); on z the
  // blocks of flash_fwd_f32_cluster's groups of clusters (d > 256, each
  // <= 65535)
  const bool wide = d > 128 && d <= W_D;
  const int64_t rows = wide ? 2 * W_BQ : 64;
  if (batch <= 0 || t_q <= 0 || t_k <= 0 || heads <= 0 || d <= 0 ||
      q_offset < 0 || dtype != 0 || (int64_t)batch * heads > INT32_MAX ||
      (t_q + rows - 1) / rows > 65535 ||
      (int64_t)cluster_shape(d).groups * cluster_shape(d).blocks > 65535 ||
      (copy_bytes != 16 && copy_bytes != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (copy_bytes == 4)
    return (int)dispatch_f32<4>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                                causal, q_offset, s);
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(o);
  if (d % 4 != 0 || any % 16 != 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch_f32<16>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                               causal, q_offset, s);
}

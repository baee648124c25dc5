// Flash-attention forward for Hopper (sm_90a) tensor cores, bf16 and fp16
// inputs.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py:47 _fwd_kernel
// (launched by _flash_fwd through pl.pallas_call) for 16-bit inputs; fp32
// inputs run flash_fwd_f32 in flash_attention_fwd.cu. It computes the same
// function: for each (batch, head), softmax(scale * Q K^T) V over
// (B, T, H, D) tensors, with an optional causal mask that keeps
// q_offset + row >= col (a masked score is the reference's -1e30), an online
// softmax (running max m, running sum l, fp32 accumulator) over K/V tiles,
// and o / max(l, 1e-20) written in q's dtype. Columns past T_k have weight 0.
// The scores never leave the registers.
//
// Bound on an H100 SXM at the transformer LM's shape, q/k/v (2, 2048, 16, 64)
// bf16 causal, per forward and layer: B*H*T*(T+1)/2 = 6.7e7 causal pairs,
// each 2*D flops for Q K^T and 2*D for P V, so 17.2 GFLOP; the bytes are q,
// k, v read once and o written once, 4 * 8.4 MB = 34 MB. At 989 TFLOP/s
// (dense bf16/fp16 tensor cores) and 3.35 TB/s that is 0.0174 ms against
// 0.0100 ms: the kernel is bound by operations. mma.sync issues from one
// warp at a time and reaches at most about two thirds of that peak; the
// warpgroup form (wgmma, fed by TMA) that lifts it is later work.
//
// Design (FlashAttention-2 form):
//   * one block of 4 warps (128 threads) per (batch*head, 64-row Q tile);
//     each warp owns 16 Q rows. The grid is (batch*head, Q tile) and Q tiles
//     run from the last, so the first blocks the card schedules are the
//     heaviest causal tiles of every head;
//   * Q, K and V stay row-major in shared memory, rows padded by 8 elements
//     (16 bytes), so that the 8 rows an ldmatrix phase reads start in 8
//     distinct 4-bank groups: no bank conflicts;
//   * K/V tiles of 64 rows go through a two-stage cp.async ring: tile n+1 is
//     copied while tile n is computed, one barrier per tile. Copies are 16
//     bytes when d % 8 == 0 and the base pointers are 16-byte aligned (the
//     VEC template parameter, picked by ops/flash_attention.py::copy_bytes
//     and checked again by the entry); rows past T and columns past d are
//     zero-filled with src-size 0. Otherwise (d = 50, a view at a 2-byte
//     offset) the same ring is filled by element-wise loads, which cannot
//     overlap the compute of their own warp. V rows past T_k must be zeros:
//     a masked p = 0 times a NaN left in shared memory would be NaN;
//   * each warp loads its Q fragment once (ldmatrix.x4, the A operand of
//     D/16 k-steps) and keeps it in registers;
//   * S = Q K^T with mma.sync.m16n8k16 (.bf16 or .f16 in, fp32 accumulate):
//     K row-major in shared memory is already the "col" B operand, so a
//     plain ldmatrix loads it. A warp's S patch is 16 x 64: 32 fp32
//     registers a thread, two rows (g, g + 8) of 16 columns each;
//   * online softmax in registers: log2(e) is folded into the scale and
//     exp2f used; the row max reduces over the 4 lanes of a quad with two
//     shuffles, the row sum stays a per-thread partial until the end. Masks
//     apply only on tiles that cross the diagonal or T_k, and K tiles wholly
//     above the diagonal are skipped (their contribution is exactly 0 in the
//     reference, since column 0 is never masked for q_offset >= 0);
//   * P V without a shared-memory round trip: the C fragments of two
//     adjacent 8-column n-tiles of S are, element for element, the A fragment
//     of one m16n8k16 k-step, so P is rounded to bf16/fp16 pairs in
//     registers and fed to mma.sync directly; V is the B operand through
//     ldmatrix.trans;
//   * O accumulates in fp32 registers (32 a thread at D=64, 64 at D=128);
//     the epilogue divides by max(l, 1e-20) and stores in q's dtype;
//   * shared memory: Q and two stages of K and V, 5 tiles of 64 x (D + 8):
//     23 KB at D=32, 45 KB at D=64, 85 KB at D=128 (two blocks an SM). The
//     dynamic-size attribute is set once per device and instantiation;
//   * head dims: D=32/64/128 instantiations for each of bf16 and fp16; any
//     d <= 128 runs in the smallest that holds it, the columns past d zero
//     in shared memory; a d above 128 runs flash_fwd_tc_split, a split
//     over d (below).
// Precision: S and O accumulate in fp32, as in the JAX kernel, but P is
// rounded to the 16-bit input type before P V, where the JAX kernel keeps p
// in fp32 (mxnet_tpu/ops/flash_attention.py:69,72). The row sum l is taken
// over the fp32 p. Against the fp32 plain version on the same inputs the
// error stays inside 2e-2 (bf16) and 1e-2 (fp16); see chip_smoke.py phase 3.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int BQ = 64;           // Q rows per block
constexpr int BK = 64;           // K/V rows per tile
constexpr int WARPS = 4;         // 16 Q rows each
constexpr int THREADS = 32 * WARPS;
constexpr int PAD = 8;           // elements of padding per shared row
constexpr float MASKED = -1e30f; // the reference's masked score
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(uint16_t) * (size_t)(BQ + 4 * BK) * (DP + PAD);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 16 bytes from global src to shared dst asynchronously; with valid == false
// nothing is read and dst is zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Rows [row0, row0 + ROWS) of one (batch, head) of a (B, T, H, D) 16-bit
// tensor into a ROWS x (DP + PAD) shared tile; rows past t_len and columns
// past d are zero. VEC == 16: cp.async of 8 elements (needs d % 8 == 0 and
// 16-byte aligned rows); VEC == 2: element-wise loads, any d and alignment.
template <int ROWS, int DP, int VEC>
__device__ __forceinline__ void stage_tile(uint16_t* dst, const uint16_t* src,
                                           int row0, int t_len,
                                           int row_stride, int d) {
  constexpr int DS = DP + PAD;
  if constexpr (VEC == 16) {
    constexpr int PER_ROW = DP / 8;
    static_assert(ROWS * PER_ROW % THREADS == 0, "whole copies per thread");
#pragma unroll
    for (int it = 0; it < ROWS * PER_ROW / THREADS; ++it) {
      const int e = it * THREADS + threadIdx.x;
      const int r = e / PER_ROW;
      const int c = (e % PER_ROW) * 8;
      const int row = row0 + r;
      const bool ok = row < t_len && c < d;
      cp_async16(dst + r * DS + c,
                 ok ? src + (int64_t)row * row_stride + c : src, ok);
    }
  } else {
    static_assert(VEC == 2, "copies are 16 or 2 bytes");
    static_assert(ROWS * DP % (2 * THREADS) == 0, "whole pairs per thread");
    // each thread writes 2 adjacent columns, so the shared stores are 4
    // bytes; the global loads are 2 bytes each (any alignment)
    constexpr int PAIRS = DP / 2;
#pragma unroll 8
    for (int it = 0; it < ROWS * PAIRS / THREADS; ++it) {
      const int e = it * THREADS + threadIdx.x;
      const int r = e / PAIRS;
      const int c = (e % PAIRS) * 2;
      const int row = row0 + r;
      uint32_t lo = 0, hi = 0;
      if (row < t_len) {
        const uint16_t* s = src + (int64_t)row * row_stride + c;
        if (c < d) lo = s[0];
        if (c + 1 < d) hi = s[1];
      }
      *reinterpret_cast<uint32_t*>(dst + r * DS + c) = lo | (hi << 16);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for one m16n8k16 tile; T is __nv_bfloat16 or __half
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two floats as one register of two T (lo in the low half), rounded to
// nearest
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<const uint32_t*>(&v);
  }
  return r;
}

template <typename T>
__device__ __forceinline__ uint16_t to_bits(float x) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  } else {
    return __half_as_ushort(__float2half_rn(x));
  }
}

template <typename T, int DP, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_tc(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
             const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
             int t_q, int t_k, int heads, int d, float scale_log2, int causal,
             int q_offset) {
  constexpr int DS = DP + PAD;   // shared row stride, elements
  constexpr int KS = DP / 16;    // k-steps of Q K^T
  constexpr int NS = BK / 8;     // 8-column n-tiles of S
  constexpr int NO = DP / 8;     // 8-column n-tiles of O
  constexpr int TILE = BK * DS;
  extern __shared__ uint4 smem16[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem16);  // BQ x DS
  uint16_t* kv_s = q_s + BQ * DS;  // 2 stages of [K tile, V tile]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tq = lane & 3;   // fragment column pair
  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;   // heaviest causal first
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = q_tile * BQ;
  const int rs = heads * d;   // row stride of (B, T, H, D)

  // (b, row, h, :) lives at ((b * T + row) * H + h) * D
  const uint16_t* q_bh = q + ((int64_t)b * t_q * heads + h) * d;
  const uint16_t* k_bh = k + ((int64_t)b * t_k * heads + h) * d;
  const uint16_t* v_bh = v + ((int64_t)b * t_k * heads + h) * d;
  uint16_t* o_bh = o + ((int64_t)b * t_q * heads + h) * d;

  int n_tiles = (t_k + BK - 1) / BK;
  if (causal) {
    // last query row of this tile, in key coordinates
    const int last = q_offset + min(q0 + BQ, t_q) - 1;
    n_tiles = min(n_tiles, last / BK + 1);
  }

  stage_tile<BQ, DP, VEC>(q_s, q_bh, q0, t_q, rs, d);
  stage_tile<BK, DP, VEC>(kv_s, k_bh, 0, t_k, rs, d);
  stage_tile<BK, DP, VEC>(kv_s + TILE, v_bh, 0, t_k, rs, d);
  cp_async_commit();

  // ldmatrix row addresses of this lane: x4 matrices 0-3 take their row
  // addresses from lanes 0-7, 8-15, 16-23, 24-31
  const int lr = lane & 7;
  const int l8 = (lane >> 3) & 1;   // matrices 1 and 3
  const int l16 = lane >> 4;        // matrices 2 and 3

  uint32_t qf[KS][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows g and g + 8 of this warp: running max (log2 domain) and this
  // thread's partial sum
  float m[2] = {MASKED, MASKED};
  float l[2] = {0.f, 0.f};
  const int row_g = q_offset + q0 + warp * 16 + g;   // key coordinates

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const uint16_t* k_s = kv_s + (kt & 1) * 2 * TILE;
    const uint16_t* v_s = k_s + TILE;
    cp_async_wait_all();
    // tile kt is in for every thread, and every thread is done with
    // tile kt - 1's stage
    __syncthreads();
    if (kt == 0) {
      // A fragments of Q: matrix 0 rows 0-7 cols 0-7, 1 rows 8-15 cols 0-7,
      // 2 rows 0-7 cols 8-15, 3 rows 8-15 cols 8-15 of each k-step
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], smem_addr(q_s + (warp * 16 + lr + 8 * l8) * DS +
                                      ks * 16 + 8 * l16));
    }
    if (kt + 1 < n_tiles) {
      uint16_t* nxt = kv_s + ((kt + 1) & 1) * 2 * TILE;
      stage_tile<BK, DP, VEC>(nxt, k_bh, k0 + BK, t_k, rs, d);
      stage_tile<BK, DP, VEC>(nxt + TILE, v_bh, k0 + BK, t_k, rs, d);
      cp_async_commit();
    }

    // S = Q K^T: B fragments of two n-tiles per ldmatrix.x4 (matrix 0 keys
    // 0-7 d 0-7, 1 keys 0-7 d 8-15, 2 keys 8-15 d 0-7, 3 keys 8-15 d 8-15)
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, smem_addr(k_s + (n * 8 + lr + 8 * l16) * DS +
                                  ks * 16 + 8 * l8));
        mma16816<T>(s[n], qf[ks], kf[0], kf[1]);
        mma16816<T>(s[n + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // online softmax in the log2 domain; s[n][0..1] are row g, columns
    // k0 + 8n + 2tq + {0, 1}; s[n][2..3] row g + 8, the same columns
    const bool edge = k0 + BK > t_k || (causal && q_offset + q0 < k0 + BK - 1);
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int col = k0 + n * 8 + 2 * tq + (e & 1);
          const int row = row_g + 8 * (e >> 1);
          if (col >= t_k) {
            x = neg_inf();   // not a key: weight 0
          } else if (causal && row < col) {
            x = MASKED;
          }
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // P V: k-step j covers keys 16j..16j+15, i.e. S n-tiles 2j and 2j + 1,
    // whose C fragments are the A fragment {a0, a1, a2, a3} =
    // {tile 2j rows g, tile 2j rows g+8, tile 2j+1 rows g, tile 2j+1 rows g+8}
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pf[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float p0 = exp2f(s[2 * j + t][0] - m[0]);
        const float p1 = exp2f(s[2 * j + t][1] - m[0]);
        const float p2 = exp2f(s[2 * j + t][2] - m[1]);
        const float p3 = exp2f(s[2 * j + t][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pf[2 * t] = pack2<T>(p0, p1);
        pf[2 * t + 1] = pack2<T>(p2, p3);
      }
      // B fragments of V through ldmatrix.trans: matrix 0 keys 0-7 cols
      // 0-7, 1 keys 8-15 cols 0-7, 2 keys 0-7 cols 8-15, 3 keys 8-15
      // cols 8-15
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(v_s + (j * 16 + lr + 8 * l8) * DS +
                                        n * 8 + 8 * l16));
        mma16816<T>(acc[n], pf, vf[0], vf[1]);
        mma16816<T>(acc[n + 1], pf, vf[2], vf[3]);
      }
    }
  }

  // epilogue: rows g and g + 8 of this warp, columns 8n + 2tq + {0, 1}
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = q0 + warp * 16 + g + 8 * i;
    if (r >= t_q) continue;
    const float inv = 1.f / fmaxf(li, 1e-20f);
    uint16_t* o_row = o_bh + (int64_t)r * rs;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * tq;
      const float x0 = acc[n][2 * i] * inv;
      const float x1 = acc[n][2 * i + 1] * inv;
      if constexpr (VEC == 16) {
        // d % 8 == 0 and aligned rows: col < d implies col + 1 < d
        if (col < d)
          *reinterpret_cast<uint32_t*>(o_row + col) = pack2<T>(x0, x1);
      } else {
        if (col < d) o_row[col] = to_bits<T>(x0);
        if (col + 1 < d) o_row[col + 1] = to_bits<T>(x1);
      }
    }
  }
}

// ------------------------------------------------------ head dim > 128

// flash_fwd_tc_split: any d > 128, split over d. The output's columns go in
// chunks of DC = 128 on gridDim.z; each block accumulates S = Q K^T over the
// 128-wide d-chunks of Q and K, staged through shared memory one chunk at a
// time (Q's A fragments are read again from shared memory for every
// chunk), then adds P V for its own chunk of V's columns. Warps, fragments,
// online softmax and masks are flash_fwd_tc's at D=128. Each of the
// ceil(d / 128) column chunks computes S again, and the copies of a K/V
// tile do not overlap its compute: this path is right for any d, not
// tuned. Shared memory: Q, K and V chunks, 51 KB.
constexpr int DC = 128;   // d-chunk width

constexpr size_t split_smem_bytes() {
  return sizeof(uint16_t) * (size_t)(BQ + 2 * BK) * (DC + PAD);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_tc_split(const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ k,
                   const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                   int t_q, int t_k, int heads, int d, float scale_log2,
                   int causal, int q_offset) {
  constexpr int DS = DC + PAD;   // shared row stride, elements
  constexpr int KS = DC / 16;    // k-steps of Q K^T per d-chunk
  constexpr int NS = BK / 8;     // 8-column n-tiles of S
  constexpr int NO = DC / 8;     // 8-column n-tiles of this block's O
  extern __shared__ uint4 smem16[];
  uint16_t* q_s = reinterpret_cast<uint16_t*>(smem16);  // BQ x DS, a chunk
  uint16_t* k_s = q_s + BQ * DS;   // BK x DS, a chunk
  uint16_t* v_s = k_s + BK * DS;   // BK x DS, this block's columns

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bh = blockIdx.x;
  const int q_tile = gridDim.y - 1 - blockIdx.y;   // heaviest causal first
  const int c_out = blockIdx.z * DC;   // first output column of the block
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = q_tile * BQ;
  const int rs = heads * d;
  const int n_dc = (d + DC - 1) / DC;

  const uint16_t* q_bh = q + ((int64_t)b * t_q * heads + h) * d;
  const uint16_t* k_bh = k + ((int64_t)b * t_k * heads + h) * d;
  const uint16_t* v_bh = v + ((int64_t)b * t_k * heads + h) * d;
  uint16_t* o_bh = o + ((int64_t)b * t_q * heads + h) * d;

  int n_tiles = (t_k + BK - 1) / BK;
  if (causal) {
    const int last = q_offset + min(q0 + BQ, t_q) - 1;
    n_tiles = min(n_tiles, last / BK + 1);
  }

  const int lr = lane & 7;
  const int l8 = (lane >> 3) & 1;
  const int l16 = lane >> 4;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {MASKED, MASKED};
  float l[2] = {0.f, 0.f};
  const int row_g = q_offset + q0 + warp * 16 + g;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int dc = 0; dc < n_dc; ++dc) {
      const int c0 = dc * DC;
      // every thread is done with the last chunk, and with the last
      // tile's V
      __syncthreads();
      stage_tile<BQ, DC, VEC>(q_s, q_bh + c0, q0, t_q, rs, d - c0);
      stage_tile<BK, DC, VEC>(k_s, k_bh + c0, k0, t_k, rs, d - c0);
      if (dc == 0)
        stage_tile<BK, DC, VEC>(v_s, v_bh + c_out, k0, t_k, rs, d - c_out);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qf[4];
        ldmatrix_x4(qf, smem_addr(q_s + (warp * 16 + lr + 8 * l8) * DS +
                                  ks * 16 + 8 * l16));
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          uint32_t kf[4];
          ldmatrix_x4(kf, smem_addr(k_s + (n * 8 + lr + 8 * l16) * DS +
                                    ks * 16 + 8 * l8));
          mma16816<T>(s[n], qf, kf[0], kf[1]);
          mma16816<T>(s[n + 1], qf, kf[2], kf[3]);
        }
      }
    }

    // online softmax in the log2 domain, as in flash_fwd_tc
    const bool edge = k0 + BK > t_k || (causal && q_offset + q0 < k0 + BK - 1);
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int col = k0 + n * 8 + 2 * tq + (e & 1);
          const int row = row_g + 8 * (e >> 1);
          if (col >= t_k) {
            x = neg_inf();
          } else if (causal && row < col) {
            x = MASKED;
          }
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pf[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float p0 = exp2f(s[2 * j + t][0] - m[0]);
        const float p1 = exp2f(s[2 * j + t][1] - m[0]);
        const float p2 = exp2f(s[2 * j + t][2] - m[1]);
        const float p3 = exp2f(s[2 * j + t][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pf[2 * t] = pack2<T>(p0, p1);
        pf[2 * t + 1] = pack2<T>(p2, p3);
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_addr(v_s + (j * 16 + lr + 8 * l8) * DS +
                                        n * 8 + 8 * l16));
        mma16816<T>(acc[n], pf, vf[0], vf[1]);
        mma16816<T>(acc[n + 1], pf, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = q0 + warp * 16 + g + 8 * i;
    if (r >= t_q) continue;
    const float inv = 1.f / fmaxf(li, 1e-20f);
    uint16_t* o_row = o_bh + (int64_t)r * rs;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = c_out + n * 8 + 2 * tq;
      const float x0 = acc[n][2 * i] * inv;
      const float x1 = acc[n][2 * i + 1] * inv;
      if constexpr (VEC == 16) {
        if (col < d)
          *reinterpret_cast<uint32_t*>(o_row + col) = pack2<T>(x0, x1);
      } else {
        if (col < d) o_row[col] = to_bits<T>(x0);
        if (col + 1 < d) o_row[col + 1] = to_bits<T>(x1);
      }
    }
  }
}

// ---------------------------------------------------------------- launch

// Let `kernel` use `bytes` of dynamic shared memory on the current device;
// the attribute is set once per device and kernel (one static per
// instantiation of the caller), not at every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) {
    done.fetch_or(bit, std::memory_order_release);
  } else {
    cudaGetLastError();   // returned here; not left for a later launch
  }
  return err;
}

template <typename T, int DP, int VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int t_q, int t_k, int heads, int d, float scale,
                   int causal, int q_offset, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_fwd_tc<T, DP, VEC>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * heads, (t_q + BQ - 1) / BQ);
  flash_fwd_tc<T, DP, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), t_q, t_k,
      heads, d, scale * LOG2E, causal, q_offset);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* o,
                         int batch, int t_q, int t_k, int heads, int d,
                         float scale, int causal, int q_offset,
                         cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  constexpr size_t smem = split_smem_bytes();
  cudaError_t err = allow_smem(flash_fwd_tc_split<T, VEC>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * heads, (t_q + BQ - 1) / BQ, (d + DC - 1) / DC);
  flash_fwd_tc_split<T, VEC><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), t_q, t_k,
      heads, d, scale * LOG2E, causal, q_offset);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int batch, int t_q, int t_k, int heads, int d,
                       float scale, int causal, int q_offset,
                       cudaStream_t stream) {
  if (d > DC)
    return launch_split<T, VEC>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                                causal, q_offset, stream);
  if (d <= 32)
    return launch<T, 32, VEC>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                              causal, q_offset, stream);
  if (d <= 64)
    return launch<T, 64, VEC>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                              causal, q_offset, stream);
  return launch<T, 128, VEC>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                             causal, q_offset, stream);
}

template <typename T>
cudaError_t dispatch_vec(const void* q, const void* k, const void* v, void* o,
                         int batch, int t_q, int t_k, int heads, int d,
                         float scale, int causal, int q_offset,
                         int copy_bytes, cudaStream_t stream) {
  if (copy_bytes == 16)
    return dispatch_d<T, 16>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                             causal, q_offset, stream);
  return dispatch_d<T, 2>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                          causal, q_offset, stream);
}

}  // namespace

// q: (batch, t_q, heads, d), k/v: (batch, t_k, heads, d), o like q; all
// contiguous, on the current device. dtype 1 is bfloat16, 2 is float16 (0,
// float32, is flash_attention_fwd.cu's). copy_bytes is 16 (cp.async of 8
// elements: needs d % 8 == 0 and 16-byte aligned q, k, v and o) or 2
// (element-wise loads, any d and alignment). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int mxtt_flash_attention_fwd_tc(const void* q, const void* k,
                                           const void* v, void* o, int batch,
                                           int t_q, int t_k, int heads, int d,
                                           float scale, int causal,
                                           int q_offset, int dtype,
                                           int copy_bytes, void* stream) {
  // grid: batch * heads on x (< 2^31), 64-row Q tiles on y and 128-wide
  // d-chunks on z (each <= 65535)
  if (batch <= 0 || t_q <= 0 || t_k <= 0 || heads <= 0 || d <= 0 ||
      q_offset < 0 || (dtype != 1 && dtype != 2) ||
      (int64_t)batch * heads > INT32_MAX || (t_q + BQ - 1) / BQ > 65535 ||
      (d + DC - 1) / DC > 65535 || (copy_bytes != 16 && copy_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(o);
  if (copy_bytes == 16 && (d % 8 != 0 || any % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_vec<__nv_bfloat16>(q, k, v, o, batch, t_q, t_k,
                                            heads, d, scale, causal, q_offset,
                                            copy_bytes, s);
  return (int)dispatch_vec<__half>(q, k, v, o, batch, t_q, t_k, heads, d,
                                   scale, causal, q_offset, copy_bytes, s);
}

// Flash-attention forward for Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the TPU kernel mxnet_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd through pl.pallas_call). It computes the same
// function: for each (batch, head), softmax(scale * Q K^T) V over
// (B, T, H, D) tensors, with an optional causal mask that keeps
// q_offset + row >= col, an online softmax (running max m, running sum l,
// fp32 accumulator) over K/V tiles, and o / max(l, 1e-20) written in q's
// dtype. The scores never leave the block.
//
// Bound on an H100 SXM at the transformer LM's shape, q/k/v (2, 2048, 16, 64)
// fp32 causal, per forward and layer: the causal pairs are
// B*H*T*(T+1)/2 = 6.7e7, each 2*D flops for Q K^T and 2*D for P V, so about
// 17.2 GFLOP; the bytes are q, k, v read once and o written once,
// 4 * 16.8 MB = 67 MB. At 67 TFLOP/s (fp32, no tensor cores) and
// 3.35 TB/s that is 0.26 ms against 0.02 ms: the kernel is bound by
// operations, not by memory.
//
// Design (a simple, correct first kernel):
//   * one block of 256 threads per (64-row Q tile, batch*head); heavy causal
//     tiles are scheduled first;
//   * the scaled Q tile and each 64-row K and V tile are staged in shared
//     memory as fp32, rows padded by one float so that the strided reads
//     hit distinct banks;
//   * each thread owns a 4x4 patch of the 64x64 score tile (rows ty+16i,
//     columns tx+16j) and 4 x D/16 of the output accumulator, all fp32 FMA
//     in registers; row max and row sum reduce over the 16 threads of a
//     half-warp with shuffles;
//   * K tiles wholly above the causal diagonal are skipped: in the reference
//     their contribution is exactly 0, because column 0 of the first tile is
//     never masked for q_offset >= 0;
//   * ragged T: rows past T_q are computed on zeros and not written; columns
//     past T_k get probability 0 and zero-filled V rows.
// What it leaves on the table: no tensor cores (wgmma), no asynchronous
// copies (cp.async or TMA), no double buffering of K/V tiles, and scalar
// shared-memory reads, which bound the inner products at about half the
// fp32 FMA rate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // Q rows per block
constexpr int BK = 64;        // K/V rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr float MASKED = -1e30f;  // the reference's masked score

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy rows [row0, row0 + 64) of one (batch, head) of a (B, T, H, D) tensor
// into a 64 x (DP + 1) fp32 shared tile, times `mul`; zero outside T and D.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int t_len, int heads, int d,
                                          float mul) {
  for (int e = threadIdx.x; e < 64 * DP; e += THREADS) {
    const int r = e / DP;
    const int c = e % DP;
    const int row = row0 + r;
    float x = 0.f;
    if (row < t_len && c < d) {
      x = to_float(src[((int64_t)row * heads) * d + c]) * mul;
    }
    dst[r * (DP + 1) + c] = x;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int t_q, int t_k,
                 int heads, int d, float scale, int causal, int q_offset) {
  constexpr int DS = DP + 1;     // padded shared row stride
  constexpr int OC = DP / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;             // BQ x DS
  float* k_s = q_s + BQ * DS;    // BK x DS
  float* v_s = k_s + BK * DS;    // BK x DS
  float* p_s = v_s + BK * DS;    // BQ x (BK + 1)

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q_tile = gridDim.x - 1 - blockIdx.x;   // heaviest causal first
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = q_tile * BQ;

  // (b, row, h, :) lives at ((b * T + row) * H + h) * D
  const T* q_bh = q + ((int64_t)b * t_q * heads + h) * d;
  const T* k_bh = k + ((int64_t)b * t_k * heads + h) * d;
  const T* v_bh = v + ((int64_t)b * t_k * heads + h) * d;
  T* o_bh = o + ((int64_t)b * t_q * heads + h) * d;

  load_tile<T, DP>(q_s, q_bh, q0, t_q, heads, d, scale);

  float acc[4][OC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (t_k + BK - 1) / BK;
  if (causal) {
    // last query row of this tile, in key coordinates
    const int last = q_offset + min(q0 + BQ, t_q) - 1;
    n_tiles = min(n_tiles, last / BK + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    load_tile<T, DP>(k_s, k_bh, k0, t_k, heads, d, 1.f);
    load_tile<T, DP>(v_s, v_bh, k0, t_k, heads, d, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * DS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * DS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_offset + q0 + ty + 16 * i;
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= t_k) {
          s[i][j] = __int_as_float(0xff800000);  // -inf: not a key, weight 0
        } else if (causal && row < col) {
          s[i][j] = MASKED;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[OC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) vv[c] = v_s[j * DS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncthreads();   // the next tile overwrites k_s, v_s and p_s
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t_q) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(&o_bh[(int64_t)r * heads * d + col], acc[i][c] * inv);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int t_q, int t_k, int heads, int d, float scale,
                   int causal, int q_offset, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)(BQ * (DP + 1) + 2 * BK * (DP + 1) + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t_q + BQ - 1) / BQ, batch * heads);
  flash_fwd_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t_q, t_k, heads, d, scale,
      causal, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int batch, int t_q, int t_k, int heads, int d,
                       float scale, int causal, int q_offset,
                       cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, batch, t_q, t_k, heads, d, scale, causal,
                         q_offset, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, batch, t_q, t_k, heads, d, scale, causal,
                         q_offset, stream);
  return launch<T, 128>(q, k, v, o, batch, t_q, t_k, heads, d, scale, causal,
                        q_offset, stream);
}

}  // namespace

// q: (batch, t_q, heads, d), k/v: (batch, t_k, heads, d), o like q; all
// contiguous, on the current device. dtype 0 is float32, 1 is bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mxtt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, int batch,
                                        int t_q, int t_k, int heads, int d,
                                        float scale, int causal, int q_offset,
                                        int dtype, void* stream) {
  if (batch <= 0 || t_q <= 0 || t_k <= 0 || heads <= 0 || d <= 0 || d > 128 ||
      q_offset < 0 || (dtype != 0 && dtype != 1) ||
      (int64_t)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                                  causal, q_offset, s);
  return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, batch, t_q, t_k, heads, d,
                                        scale, causal, q_offset, s);
}

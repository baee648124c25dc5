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
// Four routes, by the rows' alignment and the head dim (the C entry at
// the end; ops/flash_attention.py::launch_plan names the same):
//   * flash_fwd_tc_wg: 16-byte rows (d % 8 == 0 and 16-byte aligned bases,
//     what TMA needs) at every d <= 256, in widths 64, 128, 192 and 256
//     (the smallest that holds d; columns past d arrive as zeros). The
//     tensor cores are reached through wgmma, fed by TMA, at every width:
//     the only way to the card's full tensor-core rate. Its design is
//     below, before the kernel;
//   * flash_fwd_tc_wg_ldg: the same consumers, widths and grid for rows that
//     TMA refuses (d not a multiple of 8, a view at a 2-byte offset), up to
//     d 256. Only its producer differs: it copies each row's aligned 16-byte
//     words into a staging ring with cp.async (16 bytes a thread) and
//     shifts them into the bytes TMA would have written (design below,
//     before the producer);
//   * flash_fwd_tc_cluster: 16-byte rows at every d above 256, thread-block
//     clusters of flash_fwd_tc_wg's producer and consumers over 192-wide
//     chunks of d, the partial scores summed through distributed shared
//     memory so that S is computed once a tile: up to d 1536 one cluster of
//     ceil(d / 192) blocks, above groups of clusters of at most 8, each
//     group computing S once (design below, before the kernel);
//   * flash_fwd_tc_cluster_ldg: the same clusters and consumers for the rows
//     TMA refuses above d 256, each block's producer the LDG one.
//
// Bound on an H100 SXM at the transformer LM's shape, q/k/v (2, 2048, 16, 64)
// bf16 causal, per forward and layer: B*H*T*(T+1)/2 = 6.7e7 causal pairs,
// each 2*D flops for Q K^T and 2*D for P V, so 17.2 GFLOP; the bytes are q,
// k, v read once and o written once, 4 * 8.4 MB = 34 MB. At 989 TFLOP/s
// (dense bf16/fp16 tensor cores) and 3.35 TB/s that is 0.0174 ms against
// 0.0100 ms: the kernels are bound by operations.
//
// Precision: S and O accumulate in fp32, as in the JAX kernel, but P is
// rounded to the 16-bit input type before P V, where the JAX kernel keeps p
// in fp32 (mxnet_tpu/ops/flash_attention.py:69,72). The row sum l is taken
// over the fp32 p. Against the fp32 plain version on the same inputs the
// error stays inside 2e-2 (bf16) and 3e-3 (fp16); see chip_smoke.py phase 3.
// Every route rounds P so.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>
#include <utility>

namespace {

constexpr float MASKED = -1e30f; // the reference's masked score
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
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

// ------------------------------ 16-byte rows, d <= 256: wgmma + TMA

// flash_fwd_tc_wg: bf16/fp16 with d <= 256 and 16-byte rows (d % 8 == 0,
// 16-byte aligned bases: what TMA needs), in widths 64, 128, 192 and 256.
// It replaces the TPU kernel mxnet_tpu/ops/flash_attention.py:47
// _fwd_kernel there and computes the function that kernel computes. Its
// design puts the operations on Hopper's asynchronous units:
//   * one block owns all of d: S = Q K^T is computed once per (Q tile, K
//     tile), never per chunk of the output's columns;
//   * each block has consumer warpgroups of 64 Q rows and one producer
//     warpgroup, of which one thread issues every copy. With two consumers
//     at widths 192 and 256 (PAIRED) they take Q tiles i and n - 1 - i of
//     a head, so every block of a causal launch has about the same work
//     (n + 1 64-row K tiles in all) and the grid ends together. At widths
//     64 and 128 a block's consumers take adjacent tiles, the last blocks'
//     first (the heaviest causal blocks start first): they then have the
//     same K/V tiles, loaded once for all of them, and run side by side to
//     the end. launch_plan in ops/flash_attention.py gives the same grids;
//   * copies are TMA loads through 4-d tensor maps, (d, H, T, B) with the
//     tensors' strides, in boxes of 64 elements (128 bytes, the widest the
//     128-byte swizzle takes) by the tile's rows: a row of d is DP / 64
//     boxes. Rows past T and columns past d arrive as zeros, so neither
//     ragged T nor d < DP needs a mask on the loads (the softmax masks
//     stay);
//   * each consumer's Q tile is loaded once; K and V tiles of BK rows go
//     through a ring of STAGES stages, each with an mbarrier for K and one
//     for V (the producer's expect_tx and the copies' bytes), and for each
//     consumer one for K and one for V that it arrives on when done, which
//     the producer waits on before it refills them;
//   * S = Q K^T is wgmma m64n<BK>k16 with both operands in shared memory
//     (K-major, 128-byte swizzle), fp32 accumulate: BK / 2 registers a
//     thread;
//   * the online softmax runs on the accumulator in registers (the wgmma
//     accumulator is mma.sync's C layout, a warp to 16 rows), and P, rounded to the 16-bit type, is the register A operand
//     of O += P V: wgmma m64n64k16 over each 64-wide chunk of O, V from
//     shared memory as an MN-major B operand. O is DP / 2 fp32 registers a
//     thread (128 at DP = 256);
//   * a consumer issues tile n's P V right behind tile n + 1's Q K^T and
//     waits for it only after n + 1's softmax, so that its own products and
//     softmax overlap. K and V of a stage are released apart, K as soon as
//     Q K^T has read it;
//   * ping-pong (PINGPONG): the consumers also take turns to issue their
//     products, each turn ended by the arrival of the consumer's 128
//     threads on the next consumer's turn mbarrier, so that one consumer's
//     softmax runs while the other's products hold the tensor cores
//     (mbarriers and not named barriers: their waits trap when a fault
//     keeps them waiting, where bar.sync would hold the card);
//   * the waits (mbarrier try_wait loops) sit inside asm and the
//     warpgroup's index is made warp-uniform: a branch the compiler
//     cannot prove convergent ahead of a wgmma makes it serialize every
//     wgmma of the kernel (ptxas C7518). For the same reason the first
//     turn's arrival is predicated inside its asm, not branched around;
//   * setmaxnreg moves registers from the producer (24) to the consumers
//     (240 with two, 112 with four).
//
// Widths 192 and 256 (Tiles<192>, Tiles<256>): K/V tiles of 64
// rows (S m64n64), two consumers, two stages, no ping-pong; shared memory
// at DP = 256: Q 2 x 32 KB, K and V 2 stages x 2 x 32 KB: 192 KB, one
// block an SM; 168 registers at launch. Bound at (2, 2048, 4, 256) causal
// (the LM at hidden 1024 in 4 heads): 17.2 GFLOP at 989 TFLOP/s, 0.0174
// ms, against 8.4 MB x 4 at 3.35 TB/s, 0.0100 ms: operations.
//
// Widths 64 and 128 (Tiles<64>, Tiles<128>). At d 64 the
// exponentials of the softmax are as much work as the products (about
// 69 M ex2 at the serving shape, 16 a clock an SM: 0.017 ms, the tensor
// cores' 0.0174 ms), at d 256 a quarter, and the sweep reads the kernel
// bound by its arithmetic, not its loads: at width 64 "arithmetic alone"
// is within 5 % of the whole, "loads alone" half of it. A consumer's
// softmax is a chain of dependent instructions that its own products
// cannot hide, so what helps is more consumer warps an SM and fewer
// instructions; a deeper ring buys 1-2 %:
//   * width 64: four consumers (256 Q rows a block, 112 registers a
//     consumer thread), K/V tiles of 64 rows (S m64n64: 32 registers, where
//     m64n128 does not fit beside O and P in 112), three stages, no
//     ping-pong (with four consumers the turns only add waits);
//   * width 128: two consumers (128 Q rows, 240 registers), K/V tiles of
//     128 rows (S m64n128k16: 6 KB of shared memory read for 64 tensor
//     clocks, where m64n64k16 reads 4 KB for 32, all of the SM's rate),
//     ping-pong on;
//   * both: exponentials as ex2.approx.ftz, and the rows' max and sum over
//     a tile as two partials each;
//   * shared memory at DP = 64: Q 4 x 8 KB, K and V 3 stages x 2 x 8 KB:
//     80 KB; at DP = 128: Q 2 x 16 KB, K and V 2 x 2 x 32 KB: 160 KB. One
//     block an SM (the registers).
//   Device ms on an H100 SXM at 700 W (flash_tile_sweep.py --kernel wg,
//   PERF.md; the library's scaled_dot_product_attention in the same
//   turns), bf16 causal: (2, 2048, 16, 64) 0.0594 (library 0.0583;
//   the former mma.sync kernel 0.0907), (4, 2048, 16, 64) 0.115 (0.099),
//   (2, 2048, 8, 128) 0.0487 (0.0506). At width 64 the arithmetic alone
//   takes 0.0606 and the loads alone 0.0244. Left on the table:
//   non-causal at d 64 (0.098 against the library's 0.078); the latency
//   of each consumer's chain (its Q K^T's wait is exposed: a second S
//   tile in flight needs registers four consumers do not have); a
//   persistent grid that would hide each block's start and epilogue.
// mxnet_tpu_torch/tools/flash_tile_sweep.py --kernel wg times these tiles
// against alternatives it patches into a copy of this source (PERF.md).
namespace wgk {

constexpr int WG_BQ = 64;         // Q rows a consumer
constexpr int BOX = 64;           // elements of d a TMA box (128 bytes)
constexpr int ROW = 128;          // bytes of a box row in shared memory

// A width's tiles: K/V rows a tile (S is m64n<BK>), consumer warpgroups,
// ring stages, whether the consumers take turns (ping-pong), whether the
// softmax's exponentials are ex2.approx.ftz (one MUFU.EX2; exp2f adds the
// instructions that keep subnormal results, which P rounded to 16 bits
// cannot hold anyway) with its sums split for more independent
// instructions, and whether two consumers take Q tiles i and n - 1 - i
// (PAIRED) or adjacent ones
template <int BK_, int CONSUMERS_, int STAGES_, int PINGPONG_, int EX2_,
          int PAIRED_>
struct TilesOf {
  static constexpr int BK = BK_;
  static constexpr int CONSUMERS = CONSUMERS_;
  static constexpr int STAGES = STAGES_;
  static constexpr bool PINGPONG = PINGPONG_ != 0;
  static constexpr bool EX2 = EX2_ != 0;
  static constexpr bool PAIRED = PAIRED_ != 0 && CONSUMERS == 2;
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  // setmaxnreg: the block's registers at launch (the SM's 65536 over its
  // threads, one block an SM, a multiple of 8) less the producer's 24 a
  // thread, over the consumers: 240 for two consumers, 160 for three, 112
  // for four
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = 24;   // the TMA route's
  static constexpr int CONSUMER_REGS =
      (THREADS * LAUNCH_REGS - 128 * PRODUCER_REGS) / (128 * CONSUMERS) / 8 *
      8;
  // what the consumers leave the producer: 32 a thread with four
  // consumers, 24 with two (the LDG route's default, Ldg below)
  static constexpr int LDG_PRODUCER_REGS =
      (THREADS * LAUNCH_REGS - 128 * CONSUMERS * CONSUMER_REGS) / 128 / 8 *
      8;
  static_assert(LDG_PRODUCER_REGS >= 24, "setmaxnreg takes 24 to 256");
  static_assert(BK == 32 || BK == 64 || BK == 128,
                "S is m64n32, m64n64 or m64n128");
  static_assert(CONSUMERS >= 2 && CONSUMERS <= 4, "2 to 4 consumers");
};
// XP > 0: the blocks of the cluster kernel (flash_fwd_tc_cluster; XP its
// exchange pieces a K tile), ClusterTiles at any width: S m64n32 (see the
// kernel's design for why), two consumers on Q tiles i and n - 1 - i
// BK, consumers, stages, ping-pong, ex2.approx.ftz, paired
struct ClusterTiles : TilesOf<32, 2, 2, 0, 1, 1> {};
template <int DP, int XP = 0>
struct Tiles : ClusterTiles {};
template <>
struct Tiles<64> : TilesOf<64, 4, 3, 0, 1, 0> {};
template <>
struct Tiles<128> : TilesOf<128, 2, 2, 1, 1, 0> {};
template <>
struct Tiles<192> : TilesOf<64, 2, 2, 0, 0, 1> {};
template <>
struct Tiles<256> : TilesOf<64, 2, 2, 0, 0, 1> {};

// The LDG route's producer (flash_fwd_tc_wg_ldg): every thread of the
// producer warpgroup copies and shifts the pieces (SR rows of a tile) in NB
// staging buffers, each row the RAW bytes of the aligned 16-byte words that
// hold up to DP elements at any 2-byte offset
constexpr int LDG_THREADS = 128;
template <int SR_, int NB_, int REGS_>
struct LdgOf {
  static constexpr int SR = SR_;
  static constexpr int NB = NB_;
  static constexpr int PRODUCER_REGS_ = REGS_;
  static_assert(NB >= 2, "a piece in flight while one is shifted");
};
// rows a piece, staging buffers, and the producer's registers (0: what the
// consumers leave it at Tiles<DP>'s count; 40 leaves two consumers 232);
// XP > 0: flash_fwd_tc_cluster_ldg's, at any width
template <int DP, int XP = 0>
struct LdgTraits : LdgOf<32, 2, 40> {};
template <>
struct LdgTraits<64> : LdgOf<64, 4, 0> {};
template <>
struct LdgTraits<128> : LdgOf<64, 3, 40> {};
template <>
struct LdgTraits<192> : LdgOf<64, 3, 40> {};
template <>
struct LdgTraits<256> : LdgOf<32, 2, 40> {};
// the producer's and the consumers' registers (setmaxnreg) on the LDG route
template <int DP, int XP = 0>
struct Ldg : LdgTraits<DP, XP> {
  using C = Tiles<DP, XP>;
  static constexpr int PRODUCER_REGS = LdgTraits<DP, XP>::PRODUCER_REGS_
                                           ? LdgTraits<DP, XP>::PRODUCER_REGS_
                                           : C::LDG_PRODUCER_REGS;
  static constexpr int CONSUMER_REGS =
      (C::THREADS * C::LAUNCH_REGS - 128 * PRODUCER_REGS) /
      (128 * C::CONSUMERS) / 8 * 8;
  static_assert(PRODUCER_REGS >= 24 && PRODUCER_REGS % 8 == 0,
                "setmaxnreg takes multiples of 8 from 24");
};

// XP: the cluster kernel's exchange pieces a K/V tile (0: no cluster),
// each consumer's two buffers a piece of its partial S each (BK / 2 / XP
// floats a thread), after the staging; QS: Q tiles a consumer holds (slot
// s of consumer w at (QS w + s) Q_BYTES; two in a group of clusters)
template <int DP, bool LDG = false, int XP = 0, int QS = 1>
struct Layout {
  using C = Tiles<DP, XP>;
  static constexpr int DC = DP / BOX;                 // boxes a row
  static constexpr int Q_BYTES = WG_BQ * ROW * DC;    // a consumer's Q
  static constexpr int KV_BYTES = C::BK * ROW * DC;   // a K or V tile
  static constexpr int K_OFF = C::CONSUMERS * QS * Q_BYTES;
  static constexpr int V_OFF = K_OFF + C::STAGES * KV_BYTES;
  static constexpr int RAW = 2 * DP + 16;             // bytes a staged row
  static constexpr int STG_OFF = V_OFF + C::STAGES * KV_BYTES;
  static constexpr int STG_BYTES =
      LDG ? Ldg<DP, XP>::NB * Ldg<DP, XP>::SR * RAW : 0;
  static constexpr int X_OFF = STG_OFF + STG_BYTES;
  static constexpr int X_BYTES = XP ? 2 * 128 * (C::BK / 2 / XP) * 4 : 0;
  static constexpr int BAR_OFF = X_OFF + C::CONSUMERS * X_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], k_empty and
  // v_empty[STAGES][CONSUMERS], with ping-pong turn[CONSUMERS], in a
  // cluster x_full and x_empty[CONSUMERS]
  static constexpr int N_BARS = 1 + 2 * C::STAGES +
                                2 * C::STAGES * C::CONSUMERS +
                                (C::PINGPONG ? C::CONSUMERS : 0) +
                                (XP ? 2 * C::CONSUMERS : 0);
  // 1024 bytes for aligning the base: the 128-byte swizzle repeats every
  // 1024 bytes, and every tile starts on such a boundary
  static constexpr size_t BYTES = BAR_OFF + 8 * N_BARS + 1024;
  static_assert(BYTES <= 232448, "a block's shared memory on an H100");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// until the phase of parity `parity` has completed. The loop is inside the
// asm, so that the compiler sees no divergent branch ahead of the wgmma
// instructions that follow a wait (it would serialize them). Every wait
// here ends within one tile's work; one that lasts 2^32 cycles (seconds)
// is a fault of the kernel, and it traps, so that the launch fails instead
// of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "MXTT_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra MXTT_DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, 4294967296;\n"
      "@p bra MXTT_WAIT;\n"
      "trap;\n"
      "MXTT_DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// mbar_arrive where `pred` != 0: a predicate inside the asm, not a branch
// ahead of the next wgmma
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, int pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(pred)
      : "memory");
}

// one box of the 4-d tensor map at coordinates (c0 = d, c1 = head, c2 =
// row, c3 = batch) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// A wgmma shared-memory descriptor under the 128-byte swizzle: the start
// address, the leading and stride byte offsets (bytes, multiples of 16)
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// until at most one committed group is in flight
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of r across the asm
// statements that start and finish an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define MXTT_WGMMA_SS(TY)                                                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(da), "l"(db), "r"(scale_d))

#define MXTT_WGMMA_SS_N32(TY)                                                 \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(da), "l"(db), "r"(scale_d))

#define MXTT_WGMMA_SS_N128(TY)                                                \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "            \
      "{"                                                                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "    \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "    \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                     \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d))

#define MXTT_WGMMA_RS(TY)                                                     \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d (+)= A B, m64n<N>k16: A (64 x 16) and B (16 x N, K-major: its N
// columns are rows of 16 contiguous k) from shared memory; scale_d == 0
// overwrites d
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 32) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      MXTT_WGMMA_SS_N32("bf16");
    } else {
      MXTT_WGMMA_SS_N32("f16");
    }
  } else if constexpr (N == 64) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      MXTT_WGMMA_SS("bf16");
    } else {
      MXTT_WGMMA_SS("f16");
    }
  } else {
    static_assert(N == 128, "S is m64n32, m64n64 or m64n128");
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      MXTT_WGMMA_SS_N128("bf16");
    } else {
      MXTT_WGMMA_SS_N128("f16");
    }
  }
}

// d += A B, m64n64k16: A from registers (mma.sync's A fragment layout, a
// warp to 16 rows), B (16 x 64) MN-major from shared memory (its 16 rows
// of 64 contiguous n)
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    MXTT_WGMMA_RS("bf16");
  } else {
    MXTT_WGMMA_RS("f16");
  }
}

#undef MXTT_WGMMA_SS
#undef MXTT_WGMMA_SS_N32
#undef MXTT_WGMMA_SS_N128
#undef MXTT_WGMMA_RS

// K/V tiles of BK rows the 64 Q rows from q0 attend to
template <int BK>
__device__ __forceinline__ int kv_tiles(int q0, int t_q, int t_k, int causal,
                                        int q_offset) {
  int n = (t_k + BK - 1) / BK;
  if (causal) n = min(n, (q_offset + min(q0 + WG_BQ, t_q) - 1) / BK + 1);
  return n;
}

// the 64-row Q tile of the block's consumer w (-1: none), of nq in a head:
// PAIRED, block y pairs tiles y and nq - 1 - y; else block y takes
// CONSUMERS adjacent tiles, the last blocks' first
template <int CONSUMERS, bool PAIRED>
__device__ __forceinline__ int q_tile(int w, int nq) {
  if constexpr (PAIRED) {
    int t = w == 0 ? (int)blockIdx.y : nq - 1 - (int)blockIdx.y;
    if (w == 1 && t == (int)blockIdx.y) t = -1;
    return t < nq ? t : -1;
  } else {
    const int t = ((int)gridDim.y - 1 - (int)blockIdx.y) * CONSUMERS + w;
    return t < nq ? t : -1;
  }
}

// The consumers with a Q tile (the first nv of them: consumer 0 always has
// one), each one's K/V tiles (0 without a Q tile) and the most of them
template <int CONS, bool PAIRED, int BK>
struct BlockTiles {
  int tile[CONS], n_kv[CONS], nv = 0, n_max = 0;
  __device__ __forceinline__ BlockTiles(int nq, int t_q, int t_k, int causal,
                                        int q_offset) {
#pragma unroll
    for (int w = 0; w < CONS; ++w) {
      tile[w] = q_tile<CONS, PAIRED>(w, nq);
      n_kv[w] = tile[w] < 0 ? 0
                : kv_tiles<BK>(tile[w] * WG_BQ, t_q, t_k, causal, q_offset);
      n_max = max(n_max, n_kv[w]);
      nv += tile[w] >= 0;
    }
  }
  // tile[w] for a w known only at run time, by selects (an index into the
  // array would put it in local memory)
  __device__ __forceinline__ int tile_of(int w) const {
    int t = tile[0];
#pragma unroll
    for (int c = 1; c < CONS; ++c) t = w == c ? tile[c] : t;
    return t;
  }
};

// O += P V for one K/V tile: k-step j reads rows 16j.. of the V tile (2048
// bytes in); box c is O's columns 64c..64c+63. Both byte offsets are 1024
// (the 8-row groups of a box are contiguous), so the descriptor does not
// depend on which of the two the unit reads as the k-group stride
template <typename T, int DC, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[DC][32],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c)
      wgmma_rs<T>(acc[c], pa[j],
                  desc128(v_tile + c * BK * ROW + j * 16 * ROW, 1024, 1024));
}

// 2^x as one MUFU.EX2, subnormal results flushed to 0
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one S tile in the log2 domain: sc (the scores of
// keys k0.., sc[4n + e] at row g + 8 (e >> 1), column k0 + 8n + 2tq +
// (e & 1)) becomes p; m and l are the rows' running max and this thread's
// partial sum, corr the factor the rows' O takes. EX2: 2^x by ex2_ftz, and
// each row's max and sum over the tile taken as two partials (even and odd
// n), so that a chain of dependent instructions is half as long (two
// consumer warps an SM sub-partition hide little latency); else exp2f and
// one chain
template <int BK, bool EX2>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool edge, int k0, int t_k,
                                             int causal, int row_g, int tq,
                                             float scale_log2) {
  constexpr int P = EX2 ? 2 : 1;   // partials a row
  float mx[2][P];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int u = 0; u < P; ++u) mx[i][u] = neg_inf();
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * n + e] * scale_log2;
      if (edge) {
        const int col = k0 + n * 8 + 2 * tq + (e & 1);
        const int row = row_g + 8 * (e >> 1);
        if (col >= t_k) {
          x = neg_inf();   // not a key: weight 0
        } else if (causal && row < col) {
          x = MASKED;
        }
      }
      sc[4 * n + e] = x;
      mx[e >> 1][n % P] = fmaxf(mx[e >> 1][n % P], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float r = mx[i][0];
#pragma unroll
    for (int u = 1; u < P; ++u) r = fmaxf(r, mx[i][u]);
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
    const float m_new = fmaxf(m[i], r);
    corr[i] = EX2 ? ex2_ftz(m[i] - m_new) : exp2f(m[i] - m_new);
    m[i] = m_new;
    l[i] *= corr[i];
  }
  float ls[2][P];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int u = 0; u < P; ++u) ls[i][u] = 0.f;
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int i = (e >> 1) & 1;
    const float x = sc[e] - m[i];
    sc[e] = EX2 ? ex2_ftz(x) : exp2f(x);
    if constexpr (EX2) {
      ls[i][(e >> 2) % P] += sc[e];
    } else {
      l[i] += sc[e];
    }
  }
  if constexpr (EX2) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int u = 0; u < P; ++u) l[i] += ls[i][u];
    }
  }
}

// O *= corr by rows; P (sc) as the A operand of P V: k-step j (keys
// 16j..16j+15) is n-tiles 2j and 2j + 1 of S, {tile 2j row g, tile 2j row
// g+8, tile 2j+1 row g, tile 2j+1 row g+8}
template <typename T, int DC, int BK>
__device__ __forceinline__ void rescale_and_pack(
    float (&acc)[DC][32], uint32_t (&pa)[BK / 16][4],
    const float (&sc)[BK / 2], const float (&corr)[2]) {
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[c][4 * n] *= corr[0];
      acc[c][4 * n + 1] *= corr[0];
      acc[c][4 * n + 2] *= corr[1];
      acc[c][4 * n + 3] *= corr[1];
    }
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int n = 2 * j + u;
      pa[j][2 * u] = pack2<T>(sc[4 * n], sc[4 * n + 1]);
      pa[j][2 * u + 1] = pack2<T>(sc[4 * n + 2], sc[4 * n + 3]);
    }
}

// S = Q K^T over all of d into sc (overwritten: the first k-step's scale-d
// is 0, unless `accumulate`, which adds this chunk's product to sc): k-step
// kk reads 16 columns of box kk / 4, 32 bytes into its 128-byte rows (the
// swizzle is applied to the address, so a step inside a 1024-byte atom
// moves the start). Issued and committed, not waited for
template <typename T, int DP, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_s,
                                         uint32_t k_tile,
                                         int accumulate = 0) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<T, BK>(sc, desc128(q_s + (kk / 4) * WG_BQ * ROW + off, 16, 1024),
                    desc128(k_tile + (kk / 4) * BK * ROW + off, 16, 1024),
                    kk > 0 || accumulate);
  }
  wgmma_commit();
}

// No exchange: a block owns all of d (flash_fwd_tc_wg and its LDG route)
struct NoExchange {
  static constexpr int XP = 0;
  template <int N>
  __device__ __forceinline__ void operator()(float (&)[N], int) {}
  __device__ __forceinline__ void finish(int) {}
};

// Consumer warpgroup wg of either route: 64 Q rows, DP columns of d from c0
// (all of d, c0 = 0, but in a cluster), with REGS registers a thread. The
// tiles lie at Layout<DP, *, X::XP>'s offsets on both routes; the
// barriers are the block's. ANY_D: the epilogue takes any d (the LDG
// route). xchg(sc, kt) turns tile kt's partial S into the cluster's sum
// (flash_fwd_tc_cluster), and finish(n_tiles) waits until no peer reads
// this consumer's buffers any more
template <typename T, int DP, bool ANY_D, int REGS, class X = NoExchange>
__device__ __forceinline__ void consume(
    uint8_t* smem, uint64_t* q_full, uint64_t* k_full, uint64_t* v_full,
    uint64_t* k_empty, uint64_t* v_empty, uint64_t* turn_bar, int wg,
    uint16_t* __restrict__ o, int b, int h, int nq, int t_q, int t_k,
    int heads, int d, float scale_log2, int causal, int q_offset, int c0 = 0,
    X xchg = X{}) {
  using L = Layout<DP, false, X::XP>;
  using C = Tiles<DP, X::XP>;
  constexpr int DC = L::DC;
  constexpr int BK = C::BK;
  constexpr int WG_CONSUMERS = C::CONSUMERS;
  constexpr int WG_STAGES = C::STAGES;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS)
               : "memory");
  const int my_tile = q_tile<WG_CONSUMERS, C::PAIRED>(wg, nq);
  // ping-pong: the consumers issue their products in turns, 0, 1, ...:
  // consumer w's turn k starts when phase k of turn_bar[w] completes,
  // on the arrival of consumer w - 1 at the end of its turn (consumer 0's
  // first, on the last consumer's arrival here). A consumer's turns are
  // its K/V tiles and one (the last P V); one with fewer than the block's
  // most takes empty ones at its end, so that the turns alternate to the
  // end and no phase completes twice unseen
  int turn = 0, turns = 0;
  if constexpr (C::PINGPONG) {
#pragma unroll
    for (int w = 0; w < WG_CONSUMERS; ++w) {
      const int tw = q_tile<WG_CONSUMERS, C::PAIRED>(w, nq);
      if (tw >= 0)
        turns = max(turns, kv_tiles<BK>(tw * WG_BQ, t_q, t_k, causal,
                                         q_offset) + 1);
    }
    mbar_arrive_if(turn_bar, wg == WG_CONSUMERS - 1);
  }
  auto take_turn = [&] {
    if constexpr (C::PINGPONG) mbar_wait(turn_bar + wg, turn & 1);
  };
  auto end_turn = [&] {
    if constexpr (C::PINGPONG) {
      mbar_arrive(turn_bar + (wg + 1) % WG_CONSUMERS);
      ++turn;
    }
  };
  auto empty_turns = [&] {
    if constexpr (C::PINGPONG) {
      while (turn < turns) {
        take_turn();
        end_turn();
      }
    }
  };
  if (my_tile < 0) {
    empty_turns();
    return;
  }
  const int t = threadIdx.x % 128;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int q0 = my_tile * WG_BQ;
  const int n_tiles = kv_tiles<BK>(q0, t_q, t_k, causal, q_offset);
  // the epilogue's rows of O, columns c0 + 64c + 8n + 2tq + {0, 1} (dv: the
  // block's columns that lie in d)
  const int rs = heads * d;
  const int dv = d - c0;
  uint16_t* const o_bh = o + ((int64_t)b * t_q * heads + h) * d + c0;
  const uint32_t q_s = smem_addr(smem + wg * L::Q_BYTES);
  const uint32_t k_s = smem_addr(smem + L::K_OFF);
  const uint32_t v_s = smem_addr(smem + L::V_OFF);

  float acc[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  float m[2] = {MASKED, MASKED};
  float l[2] = {0.f, 0.f};
  const int row_g = q_offset + q0 + warp * 16 + g;   // key coordinates
  // P, the A operand of P V. Tile kt's P V is issued right behind tile
  // kt + 1's Q K^T and runs under its softmax, so P (and O) are not
  // touched from that issue to the wait that follows the softmax, and
  // nothing is in flight across iterations
  uint32_t pa[BK / 16][4];

  mbar_wait(q_full, 0);
  // a tile crosses the causal diagonal or T_k: masks apply
  auto edge = [&](int k0) {
    return k0 + BK > t_k || (causal && q_offset + q0 < k0 + BK - 1);
  };
  float sc[BK / 2], corr[2];
  // tile 0: Q K^T and its softmax alone
  mbar_wait(k_full, 0);
  fence_regs(sc);
  take_turn();
  wgmma_fence();
  issue_qk<T, DP, BK>(sc, q_s, k_s);
  end_turn();
  wgmma_wait_all();
  fence_regs(sc);
  mbar_arrive(k_empty + wg);
  xchg(sc, 0);
  softmax_tile<BK, C::EX2>(sc, m, l, corr, edge(0), 0, t_k, causal, row_g,
                           tq, scale_log2);
  rescale_and_pack<T, DC, BK>(acc, pa, sc, corr);
  // tile kt's Q K^T, then tile kt - 1's P V behind it; the softmax of
  // tile kt runs while P V does; nothing is in flight across iterations
  for (int kt = 1; kt < n_tiles; ++kt) {
    const int s = kt % WG_STAGES;
    const int sp = (kt - 1) % WG_STAGES;
    mbar_wait(k_full + s, (kt / WG_STAGES) & 1);
    fence_regs(sc);
#pragma unroll
    for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) fence_regs(pa[j]);
    take_turn();
    wgmma_fence();
    issue_qk<T, DP, BK>(sc, q_s, k_s + s * L::KV_BYTES);
    mbar_wait(v_full + sp, ((kt - 1) / WG_STAGES) & 1);
    issue_pv<T, DC, BK>(acc, pa, v_s + sp * L::KV_BYTES);
    wgmma_commit();
    end_turn();
    wgmma_wait_one();   // Q K^T is done; P V runs on
    fence_regs(sc);
    mbar_arrive(k_empty + s * WG_CONSUMERS + wg);
    xchg(sc, kt);
    softmax_tile<BK, C::EX2>(sc, m, l, corr, edge(kt * BK), kt * BK, t_k,
                             causal, row_g, tq, scale_log2);
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) fence_regs(pa[j]);
    mbar_arrive(v_empty + sp * WG_CONSUMERS + wg);
    rescale_and_pack<T, DC, BK>(acc, pa, sc, corr);
  }
  // the last tile's P V
  const int sl = (n_tiles - 1) % WG_STAGES;
  mbar_wait(v_full + sl, ((n_tiles - 1) / WG_STAGES) & 1);
#pragma unroll
  for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) fence_regs(pa[j]);
  take_turn();
  wgmma_fence();
  issue_pv<T, DC, BK>(acc, pa, v_s + sl * L::KV_BYTES);
  wgmma_commit();
  end_turn();
  wgmma_wait_all();
#pragma unroll
  for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
  mbar_arrive(v_empty + sl * WG_CONSUMERS + wg);
  empty_turns();

  // epilogue: rows g and g + 8 of this warp, stored as 4-byte pairs: d % 8
  // == 0 on the TMA route, so col < dv implies col + 1 < dv. ANY_D (the LDG
  // route): pairs where d is even and o 4-byte aligned (o is a fresh tensor
  // in the wrapper; c0 is even), else 2 bytes an element
  const bool pairs =
      !ANY_D || ((d | (int)(reinterpret_cast<uintptr_t>(o) >> 1)) & 1) == 0;
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
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = c * BOX + n * 8 + 2 * tq;
        const float x0 = acc[c][4 * n + 2 * i] * inv;
        const float x1 = acc[c][4 * n + 2 * i + 1] * inv;
        if (pairs) {
          if (col < dv)
            *reinterpret_cast<uint32_t*>(o_row + col) = pack2<T>(x0, x1);
        } else {
          if (col < dv) o_row[col] = to_bits<T>(x0);
          if (col + 1 < dv) o_row[col + 1] = to_bits<T>(x1);
        }
      }
  }
  xchg.finish(n_tiles);
}

// A block's mbarriers, from Layout's BAR_OFF on: q_full, k_full[STAGES],
// v_full[STAGES], k_empty and v_empty[STAGES][CONSUMERS], with ping-pong
// turn[CONSUMERS], in a cluster of `ranks` blocks x_full and
// x_empty[CONSUMERS]. Thread 0 initialises them: a full barrier counts
// `loaders` arrivals (the TMA thread's expect_tx, or each LDG loading
// thread), an empty or turn barrier a consumer's 128 threads, an exchange
// barrier the 4 warps of the same consumer in each of the ranks. The caller
// then syncs the block (the cluster) before any arrival
template <int DP, int XP = 0>
struct Bars {
  using C = Tiles<DP, XP>;
  uint64_t *q_full, *k_full, *v_full, *k_empty, *v_empty, *turn, *x_full,
      *x_empty;
  __device__ __forceinline__ Bars(uint8_t* base, uint32_t loaders,
                                  uint32_t ranks = 0) {
    q_full = reinterpret_cast<uint64_t*>(base);
    k_full = q_full + 1;
    v_full = k_full + C::STAGES;
    k_empty = v_full + C::STAGES;   // [stage][consumer]
    v_empty = k_empty + C::STAGES * C::CONSUMERS;
    turn = v_empty + C::STAGES * C::CONSUMERS;   // [consumer]
    x_full = turn + (C::PINGPONG ? C::CONSUMERS : 0);   // [consumer]
    x_empty = x_full + C::CONSUMERS;
    if (threadIdx.x != 0) return;
    mbar_init(q_full, loaders);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(k_full + s, loaders);
      mbar_init(v_full + s, loaders);
      for (int w = 0; w < C::CONSUMERS; ++w) {
        mbar_init(k_empty + s * C::CONSUMERS + w, 128);
        mbar_init(v_empty + s * C::CONSUMERS + w, 128);
      }
    }
    if constexpr (C::PINGPONG)
      for (int w = 0; w < C::CONSUMERS; ++w) mbar_init(turn + w, 128);
    if constexpr (XP > 0)
      for (int w = 0; w < C::CONSUMERS; ++w) {
        mbar_init(x_full + w, 4 * ranks);
        mbar_init(x_empty + w, 4 * ranks);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The TMA route's producer: one thread of the producer warpgroup issues
// every copy, each consumer's Q tile once, then the K and V tiles through
// the ring; a row's DP / 64 boxes from column c0 (the block's chunk of d in
// a cluster, else 0)
template <int DP, int XP = 0>
__device__ __forceinline__ void produce_tma(
    uint8_t* smem, const CUtensorMap* q_map, const CUtensorMap* k_map,
    const CUtensorMap* v_map, uint64_t* q_full, uint64_t* k_full,
    uint64_t* v_full, uint64_t* k_empty, uint64_t* v_empty, int b, int h,
    int nq, int t_q, int t_k, int causal, int q_offset, int c0 = 0) {
  using L = Layout<DP, false, XP>;
  using C = Tiles<DP, XP>;
  constexpr int DC = L::DC;
  constexpr int BK = C::BK;
  constexpr int WG_CONSUMERS = C::CONSUMERS;
  constexpr int WG_STAGES = C::STAGES;
  if (threadIdx.x % 128 != 0) return;
  const BlockTiles<WG_CONSUMERS, C::PAIRED, BK> bt(nq, t_q, t_k, causal,
                                                   q_offset);
  mbar_expect_tx(q_full, bt.nv * L::Q_BYTES);
#pragma unroll
  for (int w = 0; w < WG_CONSUMERS; ++w) {
    if (bt.tile[w] < 0) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      tma_load(smem + w * L::Q_BYTES + c * WG_BQ * ROW, q_map, q_full,
               c0 + c * BOX, h, bt.tile[w] * WG_BQ, b);
  }
  for (int kt = 0; kt < bt.n_max; ++kt) {
    const int s = kt % WG_STAGES;
    const int use = kt / WG_STAGES;
    uint8_t* k_dst = smem + L::K_OFF + s * L::KV_BYTES;
    uint8_t* v_dst = smem + L::V_OFF + s * L::KV_BYTES;
    // a stage's K (V) is free once every consumer that read the tile
    // before is done with its K (V)
#pragma unroll
    for (int w = 0; w < WG_CONSUMERS; ++w)
      if (use > 0 && kt - WG_STAGES < bt.n_kv[w])
        mbar_wait(k_empty + s * WG_CONSUMERS + w, (use - 1) & 1);
    mbar_expect_tx(k_full + s, L::KV_BYTES);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      tma_load(k_dst + c * BK * ROW, k_map, k_full + s, c0 + c * BOX, h,
               kt * BK, b);
#pragma unroll
    for (int w = 0; w < WG_CONSUMERS; ++w)
      if (use > 0 && kt - WG_STAGES < bt.n_kv[w])
        mbar_wait(v_empty + s * WG_CONSUMERS + w, (use - 1) & 1);
    mbar_expect_tx(v_full + s, L::KV_BYTES);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      tma_load(v_dst + c * BK * ROW, v_map, v_full + s, c0 + c * BOX, h,
               kt * BK, b);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(Tiles<DP>::THREADS, 1)
flash_fwd_tc_wg(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                uint16_t* __restrict__ o, int t_q, int t_k, int heads, int d,
                float scale_log2, int causal, int q_offset) {
  using L = Layout<DP>;
  using C = Tiles<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Bars<DP> bar(smem + L::BAR_OFF, 1);
  __syncthreads();

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int nq = (t_q + WG_BQ - 1) / WG_BQ;
  // the warpgroup, as a value the compiler knows to be warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == C::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     C::PRODUCER_REGS)
                 : "memory");
    produce_tma<DP>(smem, &q_map, &k_map, &v_map, bar.q_full, bar.k_full,
                    bar.v_full, bar.k_empty, bar.v_empty, b, h, nq, t_q, t_k,
                    causal, q_offset);
  } else {
    consume<T, DP, false, C::CONSUMER_REGS>(
        smem, bar.q_full, bar.k_full, bar.v_full, bar.k_empty, bar.v_empty,
        bar.turn, wg, o, b, h, nq, t_q, t_k, heads, d, scale_log2, causal,
        q_offset);
  }
}

// ------------------------- rows TMA refuses, d <= 256: the LDG producer

// flash_fwd_tc_wg_ldg: bf16/fp16 rows that TMA refuses (d not a multiple of
// 8, or a base that is not 16-byte aligned, such as a view at a 2-byte
// offset) at every d <= 256. Its consumers, widths, tiles, grid and the
// shared-memory layout of Q, K and V are flash_fwd_tc_wg's: TMA only puts
// bytes into shared memory under the 128-byte swizzle, and the consumers do
// not care how they got there. Its producer writes the same bytes:
//   * each Q, K or V tile is cut into pieces of SR rows. For a piece, the
//     loading threads copy the aligned 16-byte words that hold each row's d
//     elements into one of NB staging buffers with cp.async (16 bytes a
//     copy; thread t takes word t % 8 of every 8 of rows t / 8, t / 8 + 16,
//     ...), one cp.async group a piece. A warp copies exactly the rows it
//     later shifts, so the staged rows are its own: a thread waits for its
//     piece's group and then for its warp (__syncwarp), and no barrier
//     crosses warps. NB - 1 pieces are in flight while one is shifted,
//     ahead of the ring's empty waits. No register holds a byte in flight;
//   * memory safety: an aligned 16-byte word that holds a byte of the
//     tensor lies in the same 256-byte aligned segment as that byte, and
//     CUDA allocations are 256-byte aligned and mapped in whole pages, so
//     the words past a row's ends that a copy reads stay inside the
//     allocation (every word copied holds a byte of its row);
//   * the loading warps then move each 16-byte chunk of a row into place:
//     its 8 elements start sh + 2 col0 bytes into the row's staged words
//     (sh: the row's address mod 16, a multiple of 2), so one or two
//     aligned 16-byte shared loads and a shift by sh give them. Where 2
//     heads d is a multiple of 16 every row of a tensor has its base's sh,
//     and a piece branches once to straight-line code for that shift
//     (shift_row<SH>); else each chunk shifts by its row's sh with
//     selects. Columns past d and rows past T are written as zeros, as TMA
//     fills them. The 16 bytes go where the 128-byte swizzle puts them:
//     chunk j of tile row r at 16 (j ^ (r & 7)) in its 128-byte row, box c
//     at c * rows * 128;
//   * visibility: those stores go through the generic proxy and wgmma reads
//     through the async proxy, so each loading thread issues
//     fence.proxy.async.shared::cta after its stores and before it arrives
//     on the tile's full mbarrier, which counts the loading threads'
//     arrivals (no expect_tx). A staging buffer is refilled once its warp
//     is done with it (__syncwarp), after the fence;
//   * the epilogue writes 4-byte pairs for even d (o is a fresh tensor)
//     and 2 bytes an element for odd d.
// Its bound is the TMA route's (operations: 0.0174 ms at (2, 2048, 16, 64)
// causal). Its cost beside TMA is the producer: the staged bytes cross
// shared memory three times (the copy's write, the shift's reads, its
// write) where TMA's cross it once, each chunk is a dependent load, shift
// and store, and at width 256 the shared memory left holds one piece of
// lookahead. Device ms on an H100 SXM at 700 W (chip_smoke.py phase 3 and
// flash_tile_sweep.py --kernel wg_ldg, PERF.md), bf16 causal at an offset
// of one element: (2, 2048, 16, 64) 0.106 (library 0.059; the element-wise
// mma.sync kernel before it 0.279), (2, 2048, 4, 256) 0.167 (0.052; the
// split over d before it 1.031); (2, 1500, 16, 50) 0.071 (0.119; 0.148).

// 16 bytes of shared memory at a 16-byte aligned address
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 r;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(addr)
               : "memory");
  return r;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 x) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

// The 16 bytes that start SH bytes (even, below 16) into the 32 bytes {w0,
// w1}: words SH / 4 on, funnel-shifted by 16 bits where SH % 4 == 2
template <int SH>
__device__ __forceinline__ uint4 shift_chunk(uint4 w0, uint4 w1) {
  const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  constexpr int Q = SH / 4;
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = SH % 4 ? __funnelshift_r(w[Q + i], w[Q + i + 1], 16) : w[Q + i];
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// The same for a shift sh known only at run time: shifts by 8 and 4 bytes,
// each taken where sh has that bit, then by 0 or 16 bits
__device__ __forceinline__ uint4 shift_chunk(uint4 w0, uint4 w1,
                                             uint32_t sh) {
  uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
  for (int i = 0; i < 6; ++i) w[i] = (sh & 8) ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = (sh & 4) ? w[i + 1] : w[i];
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = __funnelshift_r(w[i], w[i + 1], (sh & 2) * 8);
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// x with its elements at and past n (of 8) zero
__device__ __forceinline__ uint4 keep_first(uint4 x, int n) {
  uint32_t r[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] &= n > 2 * i + 1 ? 0xffffffffu : n > 2 * i ? 0xffffu : 0u;
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// One thread's chunks of a row, jc + 8c for c < DC, into the tile: chunk c
// holds the row's elements 64c + 8jc on, n0 - 64c of them (none where the
// row is past T: in is false), which start sh + 16 (jc + 8c) bytes into the
// row's staged words (words: the shared address of word jc; sh: the row's
// address mod 16; SH, where it is known at compile time, else -1); box c
// of the tile row lies box_bytes from box c - 1. The second word is read
// only where the chunk's bytes reach it, so that every word read holds a
// byte of the row
template <int SH, int DC>
__device__ __forceinline__ void shift_row(uint32_t words, uint32_t sh,
                                          uint32_t dst, uint32_t box_bytes,
                                          int n0, bool in) {
  // one chunk at a time at width 256, where four fill the producer's
  // registers
#pragma unroll(DC > 3 ? 1 : DC)
  for (int c = 0; c < DC; ++c) {
    const int n = n0 - c * BOX;
    uint4 y = make_uint4(0u, 0u, 0u, 0u);
    if (in && n > 0) {
      const int first = SH >= 0 ? SH : (int)sh;
      const uint4 w0 = lds128(words + c * 128);
      const uint4 w1 = first + 2 * min(n, 8) > 16
                           ? lds128(words + c * 128 + 16)
                           : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (SH >= 0) {
        y = shift_chunk<SH>(w0, w1);
      } else {
        y = shift_chunk(w0, w1, sh);
      }
      if (n < 8) y = keep_first(y, n);
    }
    sts128(dst + c * box_bytes, y);
  }
}

template <int V>
using Int = std::integral_constant<int, V>;

template <int DP, int XP = 0>
struct Pieces {
  using C = Tiles<DP, XP>;
  static constexpr int SR = Ldg<DP, XP>::SR;
  static constexpr int QP = WG_BQ / SR;   // pieces a Q tile
  static constexpr int KP = C::BK / SR;   // pieces a K or V tile
  static_assert(WG_BQ % SR == 0 && C::BK % SR == 0, "whole pieces a tile");
};

// Piece i's rows: the first (of the tensor's (b, h) rows, from the piece's
// first column of d), their tensor and count, the row's elements the tile
// holds (dv), and where its tile lies (shared address) with its rows and
// the piece's first row in it
struct PieceAt {
  const uint16_t* src;
  int t_len, row0, rows, r0, dv;
  uint32_t tile;
};

template <int DP, int XP>
__device__ __forceinline__ PieceAt piece_at(
    int i, int q_pieces, uint32_t base, const uint16_t* q_bh,
    const uint16_t* k_bh, const uint16_t* v_bh, int nq, int t_q, int t_k,
    int dv) {
  using L = Layout<DP, true, XP>;
  using C = Tiles<DP, XP>;
  using P = Pieces<DP, XP>;
  PieceAt x;
  x.dv = dv;
  if (i < q_pieces) {
    const int w = i / P::QP;
    x.r0 = (i % P::QP) * P::SR;
    x.src = q_bh;
    x.t_len = t_q;
    x.row0 = q_tile<C::CONSUMERS, C::PAIRED>(w, nq) * WG_BQ + x.r0;
    x.tile = base + w * L::Q_BYTES;
    x.rows = WG_BQ;
  } else {
    const int j = i - q_pieces;
    const int kt = j / (2 * P::KP);
    const int p = j % (2 * P::KP);
    x.r0 = (p % P::KP) * P::SR;
    x.src = p < P::KP ? k_bh : v_bh;
    x.t_len = t_k;
    x.row0 = kt * C::BK + x.r0;
    x.tile = base + (p < P::KP ? L::K_OFF : L::V_OFF) +
             (kt % C::STAGES) * L::KV_BYTES;
    x.rows = C::BK;
  }
  return x;
}

// 16 bytes from 16-byte aligned device memory to shared memory, in the
// thread's next cp.async group
__device__ __forceinline__ void cp_async16_to(uint32_t dst, uint64_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// The loop of produce_ldg_steps over a block's `total` pieces (produce_ldg
// has it written out): piece i is at(i) (a PieceAt); wait_free(i) waits,
// before its stores, until its stage is free; full(i), after them, is the
// barrier its tile completes (nullptr: none yet). rs: the tensors' row
// stride, elements
template <int DP, int XP, int QS, class At, class Free, class Full>
__device__ __forceinline__ void ldg_pieces(uint8_t* smem, int rs, int total,
                                           At at, Free wait_free,
                                           Full full) {
  using L = Layout<DP, true, XP, QS>;
  using G = Ldg<DP, XP>;
  constexpr int SR = Pieces<DP, XP>::SR;
  constexpr int DC = L::DC;
  constexpr int RG = LDG_THREADS / 8;   // rows a pass of them takes
  constexpr int PIECE = SR * L::RAW;    // staged bytes a piece
  static_assert(SR % RG == 0, "whole rows a loading thread");
  const int t = threadIdx.x % 128;
  // a loading thread takes 16-byte column jc of every 8 (chunk jc of each
  // 64-wide box, staged word jc of each 8) of rows rq, rq + RG, ... of a
  // piece, in its copies and in its shifts
  const int jc = t % 8;
  const int rq = t / 8;
  const uint32_t stg = smem_addr(smem) + L::STG_OFF;
  // the copies of piece i into its staging buffer (row r's words at r *
  // RAW): of each of its rows, the aligned 16-byte words that hold the
  // row's dv elements, which are the words below sh + 2 dv (sh: the row's
  // address mod 16); then an arrival once they are in
  auto issue = [&](int i) {
    const PieceAt x = at(i);
    const uint32_t dst = stg + (i % G::NB) * PIECE + jc * 16;
#pragma unroll(DC > 2 ? 1 : SR / RG)
    for (int u = 0; u < SR / RG; ++u) {
      const int r = rq + u * RG;
      const int row = x.row0 + r;
      if (row < x.t_len) {
        const uint64_t a =
            reinterpret_cast<uint64_t>(x.src + (int64_t)row * rs);
        const uint64_t from = (a & ~uint64_t{15}) + jc * 16;
        const int end = (int)(a & 15) + 2 * x.dv;   // bytes from word 0
#pragma unroll
        for (int m = 0; m <= DC; ++m)
          if (jc * 16 + m * 128 < end)
            cp_async16_to(dst + r * L::RAW + m * 128, from + m * 128);
      }
    }
  };
  // one cp.async group a piece (an empty one past the last), so that piece
  // i's group is complete once at most NB - 1 groups are pending
  for (int i = 0; i < G::NB; ++i) {
    if (i < total) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < total; ++i) {
    const int buf = i % G::NB;
    const PieceAt x = at(i);
    wait_free(i);
    // this thread's copies of piece i are in, then its warp's: a warp
    // copies the rows it shifts, so its staged rows are its own
    asm volatile("cp.async.wait_group %0;\n" ::"n"(G::NB - 1) : "memory");
    __syncwarp();
    // each of the thread's rows of the piece: its address mod 16 (the low
    // bits of its 64-bit address), then its chunks at that shift, SH at
    // compile time or -1
    const uint32_t lo = (uint32_t)reinterpret_cast<uint64_t>(x.src);
    auto rows = [&](auto shift) {
      constexpr int SH = decltype(shift)::value;
      // one row at a time at widths 192 and 256, where more fill the
      // producer's registers
#pragma unroll(DC > 2 ? 1 : SR / RG)
      for (int u = 0; u < SR / RG; ++u) {
        const int r = rq + u * RG;
        const int rt = x.r0 + r;   // row of the tile
        const int row = x.row0 + r;
        const uint32_t sh = (lo + 2u * (uint32_t)row * (uint32_t)rs) & 15u;
        const uint32_t dst = x.tile + rt * ROW + ((jc ^ (rt & 7)) << 4);
        shift_row<SH, DC>(stg + buf * PIECE + r * L::RAW + jc * 16, sh, dst,
                          x.rows * ROW, x.dv - jc * 8, row < x.t_len);
      }
    };
    // where 2 heads d is a multiple of 16 every row of the tensor lies at
    // its base's address mod 16: one branch a piece to straight-line code
    // for that shift; else each row's own, at run time
    if (rs % 8 == 0) {
      switch (lo & 15u) {
        case 0: rows(Int<0>{}); break;
        case 2: rows(Int<2>{}); break;
        case 4: rows(Int<4>{}); break;
        case 6: rows(Int<6>{}); break;
        case 8: rows(Int<8>{}); break;
        case 10: rows(Int<10>{}); break;
        case 12: rows(Int<12>{}); break;
        default: rows(Int<14>{}); break;
      }
    } else {
      rows(Int<-1>{});
    }
    __syncwarp();   // the warp is done with buf
    // a tile's last piece: its stores made visible to wgmma, then the
    // tile's full barrier
    uint64_t* bar = full(i);
    if (bar) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(bar);
    }
    // then refill the buffer piece i left: NB - 1 pieces in flight while
    // one is shifted, none issued ahead of a fence
    if (i + G::NB < total) issue(i + G::NB);
    cp_async_commit();
  }
}

// The LDG route's producer over a row's DP elements from column c0 (the
// block's chunk of d in a cluster, else 0); XP as in Layout. Its loop is
// ldg_pieces's written out, and it counts its consumers' tiles as it goes
// (not in a BlockTiles): run through both, ptxas spilled
// flash_fwd_tc_wg_ldg at width 192 and the kernel read 5.7 % slower (bf16
// (2, 2048, 4, 192) causal at an offset of one element, 0.1249 against
// 0.1181 device ms, NVIDIA H100 80GB HBM3, 700.00 W)
template <typename T, int DP, int XP = 0>
__device__ __forceinline__ void produce_ldg(
    uint8_t* smem, const uint16_t* __restrict__ q,
    const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
    uint64_t* q_full, uint64_t* k_full, uint64_t* v_full, uint64_t* k_empty,
    uint64_t* v_empty, int b, int h, int nq, int t_q, int t_k, int heads,
    int d, int causal, int q_offset, int c0 = 0) {
  using L = Layout<DP, true, XP>;
  using C = Tiles<DP, XP>;
  using G = Ldg<DP, XP>;
  using P = Pieces<DP, XP>;
  constexpr int CONS = C::CONSUMERS;
  constexpr int SR = P::SR;
  constexpr int KP = P::KP;
  constexpr int DC = L::DC;
  constexpr int RG = LDG_THREADS / 8;   // rows a pass of them takes
  constexpr int PIECE = SR * L::RAW;    // staged bytes a piece
  static_assert(SR % RG == 0, "whole rows a loading thread");
  const int t = threadIdx.x % 128;
  // a loading thread takes 16-byte column jc of every 8 (chunk jc of each
  // 64-wide box, staged word jc of each 8) of rows rq, rq + RG, ... of a
  // piece, in its copies and in its shifts
  const int jc = t % 8;
  const int rq = t / 8;
  const int rs = heads * d;
  const int dv = min(d - c0, DP);   // the row's elements the tile holds
  const uint16_t* q_bh = q + ((int64_t)b * t_q * heads + h) * d + c0;
  const uint16_t* k_bh = k + ((int64_t)b * t_k * heads + h) * d + c0;
  const uint16_t* v_bh = v + ((int64_t)b * t_k * heads + h) * d + c0;
  // the consumers with a Q tile are the first nv; n_max K/V tiles in all
  int nv = 0, n_max = 0;
#pragma unroll
  for (int w = 0; w < CONS; ++w) {
    const int tw = q_tile<CONS, C::PAIRED>(w, nq);
    if (tw >= 0) {
      ++nv;
      n_max = max(n_max, kv_tiles<C::BK>(tw * WG_BQ, t_q, t_k, causal,
                                         q_offset));
    }
  }
  const int q_pieces = nv * P::QP;
  const int total = q_pieces + n_max * 2 * KP;
  const uint32_t base = smem_addr(smem);
  const uint32_t stg = base + L::STG_OFF;
  // the copies of piece i into its staging buffer (row r's words at r *
  // RAW): of each of its rows, the aligned 16-byte words that hold the
  // row's dv elements, which are the words below sh + 2 dv (sh: the row's
  // address mod 16); then an arrival once they are in
  auto issue = [&](int i) {
    const PieceAt x =
        piece_at<DP, XP>(i, q_pieces, base, q_bh, k_bh, v_bh, nq, t_q, t_k,
                         dv);
    const uint32_t dst = stg + (i % G::NB) * PIECE + jc * 16;
#pragma unroll(DC > 2 ? 1 : SR / RG)
    for (int u = 0; u < SR / RG; ++u) {
      const int r = rq + u * RG;
      const int row = x.row0 + r;
      if (row < x.t_len) {
        const uint64_t a =
            reinterpret_cast<uint64_t>(x.src + (int64_t)row * rs);
        const uint64_t from = (a & ~uint64_t{15}) + jc * 16;
        const int end = (int)(a & 15) + 2 * dv;   // bytes from the first word
#pragma unroll
        for (int m = 0; m <= DC; ++m)
          if (jc * 16 + m * 128 < end)
            cp_async16_to(dst + r * L::RAW + m * 128, from + m * 128);
      }
    }
  };
  // one cp.async group a piece (an empty one past the last), so that piece
  // i's group is complete once at most NB - 1 groups are pending
  for (int i = 0; i < G::NB; ++i) {
    if (i < total) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < total; ++i) {
    const int buf = i % G::NB;
    const PieceAt x =
        piece_at<DP, XP>(i, q_pieces, base, q_bh, k_bh, v_bh, nq, t_q, t_k,
                         dv);
    // a K (V) tile's first piece: its stage is free once every consumer
    // that read the tile before is done with its K (V)
    const int j = i - q_pieces;
    const int kt = j / (2 * KP);
    const int p = j % (2 * KP);
    const int s = kt % C::STAGES;
    if (j >= 0 && p % KP == 0 && kt >= C::STAGES) {
      const int use = kt / C::STAGES;
#pragma unroll
      for (int w = 0; w < CONS; ++w) {
        const int tw = q_tile<CONS, C::PAIRED>(w, nq);
        if (tw >= 0 && kt - C::STAGES < kv_tiles<C::BK>(tw * WG_BQ, t_q, t_k,
                                                         causal, q_offset))
          mbar_wait((p < KP ? k_empty : v_empty) + s * CONS + w,
                    (use - 1) & 1);
      }
    }
    // this thread's copies of piece i are in, then its warp's: a warp
    // copies the rows it shifts, so its staged rows are its own
    asm volatile("cp.async.wait_group %0;\n" ::"n"(G::NB - 1) : "memory");
    __syncwarp();
    // each of the thread's rows of the piece: its address mod 16 (the low
    // bits of its 64-bit address), then its chunks at that shift, SH at
    // compile time or -1
    const uint32_t lo = (uint32_t)reinterpret_cast<uint64_t>(x.src);
    auto rows = [&](auto shift) {
      constexpr int SH = decltype(shift)::value;
      // one row at a time at widths 192 and 256, where more fill the
      // producer's registers
#pragma unroll(DC > 2 ? 1 : SR / RG)
      for (int u = 0; u < SR / RG; ++u) {
        const int r = rq + u * RG;
        const int rt = x.r0 + r;   // row of the tile
        const int row = x.row0 + r;
        const uint32_t sh = (lo + 2u * (uint32_t)row * (uint32_t)rs) & 15u;
        const uint32_t dst = x.tile + rt * ROW + ((jc ^ (rt & 7)) << 4);
        shift_row<SH, DC>(stg + buf * PIECE + r * L::RAW + jc * 16, sh, dst,
                          x.rows * ROW, dv - jc * 8, row < x.t_len);
      }
    };
    // where 2 heads d is a multiple of 16 every row of the tensor lies at
    // its base's address mod 16: one branch a piece to straight-line code
    // for that shift; else each row's own, at run time
    if (rs % 8 == 0) {
      switch (lo & 15u) {
        case 0: rows(Int<0>{}); break;
        case 2: rows(Int<2>{}); break;
        case 4: rows(Int<4>{}); break;
        case 6: rows(Int<6>{}); break;
        case 8: rows(Int<8>{}); break;
        case 10: rows(Int<10>{}); break;
        case 12: rows(Int<12>{}); break;
        default: rows(Int<14>{}); break;
      }
    } else {
      rows(Int<-1>{});
    }
    __syncwarp();   // the warp is done with buf
    // a tile's last piece: its stores made visible to wgmma, then the
    // tile's full barrier
    uint64_t* full = i == q_pieces - 1 ? q_full
                     : j >= 0 && p == KP - 1 ? k_full + s
                     : j >= 0 && p == 2 * KP - 1 ? v_full + s
                                                   : nullptr;
    if (full) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full);
    }
    // then refill the buffer piece i left: NB - 1 pieces in flight while
    // one is shifted, none issued ahead of a fence
    if (i + G::NB < total) issue(i + G::NB);
    cp_async_commit();
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(Tiles<DP>::THREADS, 1)
flash_fwd_tc_wg_ldg(const uint16_t* __restrict__ q,
                    const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                    int t_q, int t_k, int heads, int d, float scale_log2,
                    int causal, int q_offset) {
  using L = Layout<DP, true>;
  using C = Tiles<DP>;
  using G = Ldg<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Bars<DP> bar(smem + L::BAR_OFF, LDG_THREADS);
  __syncthreads();

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int nq = (t_q + WG_BQ - 1) / WG_BQ;
  // the warpgroup, as a value the compiler knows to be warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == C::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     G::PRODUCER_REGS)
                 : "memory");
    produce_ldg<T, DP>(smem, q, k, v, bar.q_full, bar.k_full, bar.v_full,
                       bar.k_empty, bar.v_empty, b, h, nq, t_q, t_k, heads, d,
                       causal, q_offset);
  } else {
    consume<T, DP, true, G::CONSUMER_REGS>(
        smem, bar.q_full, bar.k_full, bar.v_full, bar.k_empty, bar.v_empty,
        bar.turn, wg, o, b, h, nq, t_q, t_k, heads, d, scale_log2, causal,
        q_offset);
  }
}

// ------------------------ d > 256: thread-block clusters that split d

// flash_fwd_tc_cluster: bf16/fp16 with 16-byte rows at every d above 256,
// where a consumer's O at all of d does not fit its registers and Q with two
// K/V stages does not fit an SM's shared memory (at d 512 Q alone is 64 KB
// a consumer). It replaces the TPU kernel
// mxnet_tpu/ops/flash_attention.py:47 _fwd_kernel there and computes what
// flash_fwd_tc_wg computes; a split over d took these head dims before,
// recomputing S for each 128-wide chunk of the output. Design:
//   * d splits into n = ceil(d / CW) chunks of 192 columns. Up to CL_MOST
//     = 8 chunks (d 1536; 8 blocks, the portable limit) one thread-block
//     cluster of CL = n blocks along the grid's z for each pair of 64-row
//     Q tiles (two consumers on a head's tiles i and n - 1 - i,
//     flash_fwd_tc_wg's grid at widths 192 and 256): block r (its rank)
//     owns columns [r CW, (r + 1) CW) of d. Above, G = ceil(n / 8) groups
//     of CL = ceil(n / G) blocks, G CL blocks on z, the cluster dimension
//     (1, 1, CL) (cluster_shape, the twin of flash_attention_fwd.cu's):
//     block z, rank r = z % CL of group z / CL, reduces chunks r, r + CL,
//     r + 2 CL, ... below n (kb of them) and writes output chunk z, none
//     where z >= n. Every group covers all of d, so S is computed once a
//     group (d 1600: two groups of 5, each block reducing 2 chunks but the
//     last; 3072: two of 8; 3300: three of 6, 3 chunks a block);
//   * each block runs flash_fwd_tc_wg's producer and consumers at width CW
//     (ClusterTiles: 32-row K/V tiles, two stages). The tensor maps' boxes
//     start at the chunk's column, and TMA fills the columns past d with
//     zeros, so the last chunk's padding adds exact zeros; a chunk that
//     starts past d is not a block's;
//   * per K tile each consumer computes only its chunks' partial S_r =
//     sum_u Q_u K_u^T on wgmma, the chunks added in order into the same
//     accumulator. The partials meet through distributed shared memory
//     (ClusterExchange): each consumer stores its accumulator thread-major
//     in one of its two buffers, arrives on the same consumer's x_full in
//     every rank of its cluster (one elected lane a warp, a cluster-scope
//     fence after the warp's stores), waits for its own, and reads each
//     rank's buffer at its thread's offsets (mapa, ld.shared::cluster; up
//     to X_LOADS in flight), summing in rank order, so that S, the row max
//     m, the sum l and P are bit-identical in every block of every group
//     (each group's rank r reduces the same chunks in the same order) and
//     every chunk of O is normalised by the same l. x_empty keeps each
//     phase of x_full to its round (ClusterExchange). Groups never
//     exchange. All of it runs while the tile before's P V holds the
//     tensor cores;
//   * each block then runs P V over its output chunk of V and writes those
//     columns of O as o / max(l, 1e-20);
//   * one cluster (form 0): the Q tile of a consumer once, K and V through
//     rings of two tiles; 128 KB of shared memory at CW 192 (Q 2 x 24 KB,
//     K and V 2 stages x 2 x 12 KB, the partials 2 x 2 x 8 KB). Groups
//     (form 1, consume_steps): two Q slots a consumer; K goes through a
//     ring of two (K tile, chunk) steps, a step's K stage released once its
//     product is done, V through a ring of two tiles. Where a group's
//     blocks reduce at most Q_KEEP = 2 chunks (d <= 3072) a block keeps
//     its chunks' Q for the Q tile (slot u); above, each step's Q chunk
//     rides beside its K in slot step % 2 (streamed). 176 KB on the TMA
//     route, 202 KB on the LDG one (its staging), one block an SM;
//   * the launch (cudaLaunchKernelEx, cluster dimension (1, 1, CL) at run
//     time; CL and the form template arguments, so that the exchange is
//     straight-line code: CL 2-8 in form 0, 5-8 in form 1) first asks
//     cudaOccupancyMaxActiveClusters, once per device, CL and form,
//     whether such a cluster can be placed, and returns an error if not.
//     The blocks sync the cluster once after their barriers are
//     initialised; a consumer leaves only once every rank has read its last
//     partial, and no peer arrives on its barriers after that.
// What it costs and why these tiles (tools/flash_tile_sweep.py --kernel
// tccluster, PERF.md): the exchange, not the arithmetic. Every chunk reads
// its peers' partials, C (C - 1) 4-byte reads a (query, key) pair in all,
// at what distributed shared memory carries (about 2-3 TB/s on the card),
// and every round pays a cluster-scope fence and a wait for the slowest
// rank. Wider chunks mean fewer ranks, but a consumer at 240 registers
// holds O (CW / 2 a thread) beside S, P and the exchange: at 256-wide
// chunks ptxas spills 600 bytes and serializes every wgmma, at 192 with
// 64-row K/V tiles still serializes them; at 192 with 32-row K/V tiles (S
// m64n32: 24 registers fewer for S and P) it serializes none and spills
// at most 56 bytes (clusters of 3 or more). 192 also pads d 320 to 384,
// not 512. Groups of at most 8 blocks rather than one non-portable
// cluster of 9-16: each block reads CL - 1 peers' partials a tile, so
// two groups of 5 read 4 peers where one cluster of 9 would read 8.
// Bound at (2, 2048, 2, 512) causal: 17.2 GFLOP at 989 TFLOP/s, 0.0174 ms
// against 8.4 MB x 4 at 3.35 TB/s: operations.
// Measured on "NVIDIA H100 80GB HBM3, 700.00 W" (flash_tile_sweep.py
// --kernel tccluster, device ms, medians of 3 rounds in turns; PERF.md),
// bf16 causal, the library's scaled_dot_product_attention in parentheses:
// (2, 2048, 1, 1600), two groups of 5, 0.605 (0.580; the split over d it
// replaced 1.594); (2, 2048, 1, 2048), two of 6, 0.889 (0.756); (1, 2048,
// 1, 3300), three of 6 on the LDG route, Q streamed, 4.465 (1.426). One
// non-portable cluster of 9 at d 1600 read 1.221, and streaming Q at 2
// chunks a block 0.673. In a group a step's product is waited for before
// the next step is issued: with one in flight across the step loop's back
// edge ptxas serializes every wgmma of the kernel (C7515). Left on the
// table: the streamed form on the LDG route, where each step copies and
// shifts both consumers' Q chunks (3.1x the library at d 3300); the
// exchange's rounds, as in one cluster; the steps' products in series.
// Why two forms: the groups' kernels run the one-cluster shapes as one
// group (the sweep's form1) with the same bits, at 0.95-1.02x form 0 on
// the TMA route (d 512 causal 0.212 against 0.219, not causal 0.314
// against 0.331, d 320 0.195 against 0.192, d 1000 0.425 against 0.419,
// d 1400 0.763 against 0.778) but 1.69x on the LDG route (d 320 at an
// offset of one element, 0.384 against 0.227), so form 0 keeps d <= 1536.
//
// flash_fwd_tc_cluster_ldg: the rows TMA refuses (d not a multiple of 8, a
// view at a 2-byte offset) at the same head dims: the same clusters, groups
// and consumers, each block's producer flash_fwd_tc_wg_ldg's over its
// chunks (its staging 25 KB more).
// tools/flash_tile_sweep.py --kernel tccluster times these choices against
// alternatives it patches into a copy of this source (PERF.md).
constexpr int CW = 192;        // d-chunk width: a block's columns
constexpr int CL_MOST = 8;     // blocks a cluster at most
constexpr int CL_MIN = 256 / CW + 1;     // one cluster: CL_MIN..CL_MOST
constexpr int GL_MIN = CL_MOST / 2 + 1;  // groups: GL_MIN..CL_MOST blocks
constexpr int Q_KEEP = 2;      // Q chunks a grouped block keeps at most
constexpr int XP_TMA = 1;    // exchange pieces a K tile on the TMA route
constexpr int XP_LDG = 1;    // and on the LDG route
constexpr int X_LOADS = 8;   // loads from the cluster in flight a thread

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
// Where `pred` != 0 (a predicate inside the asm, not a branch ahead of the
// next wgmma): with FENCE, the calling warp's earlier shared-memory stores
// and loads (ordered before this thread by a __syncwarp) released at
// cluster scope; then an arrival on the mbarrier at `addr` of the same
// offset in each of the cluster's CL blocks (map_rank). One fence for the
// CL arrivals: a release on each arrival costs a fence of its own
template <int CL, bool FENCE>
__device__ __forceinline__ void release_arrive_all_if(uint32_t addr,
                                                      int pred) {
  if constexpr (FENCE)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %0, 0;\n"
        "@p fence.acq_rel.cluster;\n}\n" ::"r"(pred)
        : "memory");
#pragma unroll
  for (int r = 0; r < CL; ++r)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
        "@p mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n}\n"
        ::"r"(map_rank(addr, r)), "r"(pred)
        : "memory");
}
// mbar_wait on the mbarrier at shared address `bar`, with acquire at
// cluster scope: the peers' arrivals release their stores and reads
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "MXTT_XWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@p bra MXTT_XDONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, 4294967296;\n"
      "@p bra MXTT_XWAIT;\n"
      "trap;\n"
      "MXTT_XDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// every thread of the cluster: each block's earlier shared-memory writes
// (its barriers' initialisation) visible to the others
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" :::
          "memory");
}

// the largest power of 2 not above n (1 for n < 2)
constexpr int pow2_floor(int n) { return n < 2 ? 1 : 2 * pow2_floor(n / 2); }

// A consumer's exchange of its partial S (BK / 2 floats a thread: the
// wgmma accumulator) with the same consumer of the cluster's CL blocks, in
// XP pieces a tile, a round each, through two buffers that the rounds take
// in turn:
//   1. wait x_empty (every rank has passed the last round's x_full), so
//      that no rank's phase of x_full gets this round's arrivals early;
//   2. store the piece thread-major in this round's buffer (its last
//      readers, two rounds back, are done: each fenced its reads before it
//      arrived on the round between);
//   3. each warp: __syncwarp, then its lead lane fences at cluster scope
//      (the warp's stores, and its reads of two rounds back) and arrives on
//      x_full of every rank;
//   4. wait x_full, then arrive on x_empty of every rank (a signal only,
//      relaxed);
//   5. load the piece from every rank's buffer, G float4 of each in flight,
//      and sum them in rank order.
// sc is indexed at compile-time offsets only, so that it all stays in
// registers beside O and P
template <int CL, int BK, int XP_, int CONSUMERS>
struct ClusterExchange {
  static constexpr int XP = XP_;
  static constexpr int PF = BK / 2 / XP;   // a thread's floats a piece
  static constexpr int NF = PF / 4;        // ... as float4
  static constexpr int BUF = NF * 128 * 16;   // bytes a buffer
  // float4 of a piece loaded together from all ranks: G x CL of them in
  // flight, at most X_LOADS (G a power of 2, so that it divides NF)
  static constexpr int G = pow2_floor(X_LOADS / CL < NF ? X_LOADS / CL : NF);
  static_assert(G >= 1 && NF % G == 0, "whole groups a piece");
  uint32_t buf;    // the consumer's two buffers (BUF bytes each), shared
  uint32_t full;   // its x_full; x_empty lies CONSUMERS barriers on

  // the exchange of tile kt: rounds kt XP + p
  __device__ __forceinline__ void operator()(float (&sc)[BK / 2], int kt) {
    const int t = threadIdx.x % 128;
    const int lead = (t & 31) == 0;
    const uint32_t empty = full + 8 * CONSUMERS;
#pragma unroll
    for (int p = 0; p < XP; ++p) {
      const int round = kt * XP + p;
      const uint32_t mine = buf + (round & 1) * BUF + t * 16;
      mbar_wait_cluster(empty, (round & 1) ^ 1);
#pragma unroll
      for (int e = 0; e < NF; ++e) {
        const int i = p * PF + 4 * e;
        sts128(mine + e * 128 * 16,
               make_uint4(__float_as_uint(sc[i]), __float_as_uint(sc[i + 1]),
                          __float_as_uint(sc[i + 2]),
                          __float_as_uint(sc[i + 3])));
      }
      __syncwarp();   // the warp's stores, then its lead lane's release
      release_arrive_all_if<CL, true>(full, lead);
      mbar_wait_cluster(full, round & 1);
      release_arrive_all_if<CL, false>(empty, lead);
      // each float4 summed in rank order; the loads of G of them from
      // every rank in flight together
#pragma unroll
      for (int e0 = 0; e0 < NF; e0 += G) {
        float4 y[G][CL];
#pragma unroll
        for (int e = 0; e < G; ++e)
#pragma unroll
          for (int r = 0; r < CL; ++r)
            y[e][r] = ld_cluster(map_rank(mine, r) + (e0 + e) * 128 * 16);
#pragma unroll
        for (int e = 0; e < G; ++e) {
          const int i = p * PF + 4 * (e0 + e);
          sc[i] = y[e][0].x;
          sc[i + 1] = y[e][0].y;
          sc[i + 2] = y[e][0].z;
          sc[i + 3] = y[e][0].w;
#pragma unroll
          for (int r = 1; r < CL; ++r) {
            sc[i] += y[e][r].x;
            sc[i + 1] += y[e][r].y;
            sc[i + 2] += y[e][r].z;
            sc[i + 3] += y[e][r].w;
          }
        }
      }
    }
  }
  // after the last of n_tiles tiles: one more round without data, its
  // arrivals fenced after this consumer's last reads, so that once it
  // completes no peer reads this block's shared memory or arrives on its
  // barriers any more
  __device__ __forceinline__ void finish(int n_tiles) {
    const int lead = (threadIdx.x & 31) == 0;
    const int round = n_tiles * XP;
    mbar_wait_cluster(full + 8 * CONSUMERS, (round & 1) ^ 1);
    __syncwarp();   // the warp's reads, then its lead lane's release
    release_arrive_all_if<CL, true>(full, lead);
    mbar_wait_cluster(full, round & 1);
  }
};

// A block's part in a group of clusters of CL blocks (form 1): its rank,
// its chunks of d rank + u CL below n (kb of them), whether the group's
// blocks keep their chunks' Q (each reduces at most Q_KEEP), and its
// output chunk, blockIdx.z (none at or past n)
template <int CL>
struct GroupPart {
  int rank, kb, c_out;
  bool kept, out;
  __device__ __forceinline__ explicit GroupPart(int d) {
    const int n = (d + CW - 1) / CW;
    rank = (int)blockIdx.z % CL;
    kb = (n - rank + CL - 1) / CL;
    kept = (n + CL - 1) / CL <= Q_KEEP;
    c_out = (int)blockIdx.z * CW;
    out = (int)blockIdx.z < n;
  }
  // the first column of d of the block's chunk u
  __device__ __forceinline__ int col(int u) const {
    return (rank + u * CL) * CW;
  }
};

// consume's epilogue for consume_steps (consume keeps its own copy inline:
// the same code through this function moved ptxas's register allocation
// and cost the one-cluster kernels 2-3 % at d 512 and 1000, PERF.md): rows
// r0 (this thread's first: the warp's row g) and r0 + 8 of O / max(l,
// 1e-20), l summed over the quad, at columns 64c + 8n + 2tq + {0, 1} of
// o_bh below dv, stored as 4-byte pairs: d % 8 == 0 on the TMA route, so
// col < dv implies col + 1 < dv. ANY_D (the LDG route): pairs where d is
// even and o 4-byte aligned (o is a fresh tensor in the wrapper; a chunk's
// first column is even), else 2 bytes an element
template <typename T, int DC, bool ANY_D>
__device__ __forceinline__ void store_o(const float (&acc)[DC][32],
                                        const float (&l)[2], const void* o,
                                        uint16_t* o_bh, int r0, int t_q,
                                        int rs, int d, int dv, int tq) {
  const bool pairs =
      !ANY_D || ((d | (int)(reinterpret_cast<uintptr_t>(o) >> 1)) & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = r0 + 8 * i;
    if (r >= t_q) continue;
    const float inv = 1.f / fmaxf(li, 1e-20f);
    uint16_t* o_row = o_bh + (int64_t)r * rs;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = c * BOX + n * 8 + 2 * tq;
        const float x0 = acc[c][4 * n + 2 * i] * inv;
        const float x1 = acc[c][4 * n + 2 * i + 1] * inv;
        if (pairs) {
          if (col < dv)
            *reinterpret_cast<uint32_t*>(o_row + col) = pack2<T>(x0, x1);
        } else {
          if (col < dv) o_row[col] = to_bits<T>(x0);
          if (col + 1 < dv) o_row[col + 1] = to_bits<T>(x1);
        }
      }
  }
}

// The consumer warpgroup wg of a block in a group of clusters: consume's
// tiles and exchange, but S sums the block's kb chunks, a step (K tile,
// chunk) at a time through the K ring: chunk u's Q lies in slot u (kept) or
// in slot step % 2 beside its K (streamed). A step's K stage is released
// once its product is done: step u - 2's before step u waits for its K (at
// most one product in flight), the tile's last two after its products.
// Without an output chunk the block takes part in the exchange only: no V,
// no P V, no O
template <typename T, bool ANY_D, int REGS, int CL, class X>
__device__ __forceinline__ void consume_steps(
    uint8_t* smem, const Bars<CW, X::XP>& bar, int wg,
    uint16_t* __restrict__ o, int b, int h, int nq, int t_q, int t_k,
    int heads, int d, float scale_log2, int causal, int q_offset,
    const GroupPart<CL>& part, X xchg) {
  using L = Layout<CW, false, X::XP, 2>;
  using C = Tiles<CW, X::XP>;
  constexpr int DC = L::DC;
  constexpr int BK = C::BK;
  constexpr int CONS = C::CONSUMERS;
  static_assert(C::STAGES == 2 && !C::PINGPONG, "rings of two, no turns");
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS)
               : "memory");
  const int my_tile = q_tile<CONS, C::PAIRED>(wg, nq);
  if (my_tile < 0) return;
  const int t = threadIdx.x % 128;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int q0 = my_tile * WG_BQ;
  const int n_tiles = kv_tiles<BK>(q0, t_q, t_k, causal, q_offset);
  const int kb = part.kb;
  const uint32_t q_s = smem_addr(smem + 2 * wg * L::Q_BYTES);   // slot 0
  const uint32_t k_s = smem_addr(smem + L::K_OFF);
  const uint32_t v_s = smem_addr(smem + L::V_OFF);

  float acc[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  float m[2] = {MASKED, MASKED};
  float l[2] = {0.f, 0.f};
  const int row_g = q_offset + q0 + warp * 16 + g;   // key coordinates
  uint32_t pa[BK / 16][4];   // P, the A operand of P V

  mbar_wait(bar.q_full, 0);
  auto edge = [&](int k0) {
    return k0 + BK > t_k || (causal && q_offset + q0 < k0 + BK - 1);
  };
  float sc[BK / 2], corr[2];
  // tile kt's products into sc, a step at a time: each step's Q K^T
  // committed and waited for, so that no product is in flight across the
  // loop's back edge, then its K stage released
  auto products = [&](int kt) {
    for (int u = 0; u < kb; ++u) {
      const int step = kt * kb + u;
      const int s = step & 1;
      mbar_wait(bar.k_full + s, (step >> 1) & 1);
      fence_regs(sc);
      wgmma_fence();
      issue_qk<T, CW, BK>(sc, q_s + (part.kept ? u : s) * L::Q_BYTES,
                          k_s + s * L::KV_BYTES, u);
      wgmma_wait_all();
      fence_regs(sc);
      mbar_arrive(bar.k_empty + s * CONS + wg);
    }
  };
  // tile 0: its products and softmax alone
  products(0);
  xchg(sc, 0);
  softmax_tile<BK, C::EX2>(sc, m, l, corr, edge(0), 0, t_k, causal, row_g,
                           tq, scale_log2);
  rescale_and_pack<T, DC, BK>(acc, pa, sc, corr);
  // tile kt's products, then tile kt - 1's P V (none without an output
  // chunk), which runs under tile kt's exchange and softmax
  for (int kt = 1; kt < n_tiles; ++kt) {
    const int sp = (kt - 1) & 1;
    products(kt);
    if (part.out) {
      mbar_wait(bar.v_full + sp, ((kt - 1) >> 1) & 1);
#pragma unroll
      for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) fence_regs(pa[j]);
      wgmma_fence();
      issue_pv<T, DC, BK>(acc, pa, v_s + sp * L::KV_BYTES);
      wgmma_commit();
    }
    xchg(sc, kt);
    softmax_tile<BK, C::EX2>(sc, m, l, corr, edge(kt * BK), kt * BK, t_k,
                             causal, row_g, tq, scale_log2);
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) fence_regs(pa[j]);
    mbar_arrive_if(bar.v_empty + sp * CONS + wg, part.out);
    rescale_and_pack<T, DC, BK>(acc, pa, sc, corr);
  }
  // the last tile's P V and the block's columns of O
  if (part.out) {
    const int sl = (n_tiles - 1) & 1;
    mbar_wait(bar.v_full + sl, ((n_tiles - 1) >> 1) & 1);
#pragma unroll
    for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) fence_regs(pa[j]);
    wgmma_fence();
    issue_pv<T, DC, BK>(acc, pa, v_s + sl * L::KV_BYTES);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
    mbar_arrive(bar.v_empty + sl * CONS + wg);
    store_o<T, DC, ANY_D>(
        acc, l, o, o + ((int64_t)b * t_q * heads + h) * d + part.c_out,
        q0 + warp * 16 + g, t_q, heads * d, d, d - part.c_out, tq);
  }
  xchg.finish(n_tiles);
}

// The TMA producer of a block in a group of clusters (one thread): each
// consumer's Q chunks once (kept) or each beside its step's K (streamed),
// the K chunks a step at a time through the K ring, V of the output chunk a
// tile at a time through the V ring (none without an output chunk)
template <int CL, int XP>
__device__ __forceinline__ void produce_tma_steps(
    uint8_t* smem, const CUtensorMap* q_map, const CUtensorMap* k_map,
    const CUtensorMap* v_map, const Bars<CW, XP>& bar, int b, int h, int nq,
    int t_q, int t_k, int causal, int q_offset, const GroupPart<CL>& part) {
  using L = Layout<CW, false, XP, 2>;
  using C = Tiles<CW, XP>;
  constexpr int DC = L::DC;
  constexpr int BK = C::BK;
  constexpr int CONS = C::CONSUMERS;
  if (threadIdx.x % 128 != 0) return;
  const BlockTiles<CONS, C::PAIRED, BK> bt(nq, t_q, t_k, causal, q_offset);
  const int kb = part.kb;
  // each consumer's Q chunk u into its slot, completing on `full`
  auto load_q = [&](int u, int slot, uint64_t* full) {
#pragma unroll
    for (int w = 0; w < CONS; ++w)
      if (w < bt.nv)
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load(smem + (2 * w + slot) * L::Q_BYTES + c * WG_BQ * ROW,
                   q_map, full, part.col(u) + c * BOX, h,
                   bt.tile[w] * WG_BQ, b);
  };
  mbar_expect_tx(bar.q_full, part.kept ? bt.nv * kb * L::Q_BYTES : 0);
  if (part.kept)
    for (int u = 0; u < kb; ++u) load_q(u, u, bar.q_full);
  for (int kt = 0; kt < bt.n_max; ++kt) {
    for (int u = 0; u < kb; ++u) {
      const int step = kt * kb + u;
      const int s = step & 1;
      const int use = step >> 1;
      // the stage is free once every consumer that read step - 2 is done
      // with it
#pragma unroll
      for (int w = 0; w < CONS; ++w)
        if (use > 0 && (step - 2) / kb < bt.n_kv[w])
          mbar_wait(bar.k_empty + s * CONS + w, (use - 1) & 1);
      mbar_expect_tx(bar.k_full + s,
                     L::KV_BYTES + (part.kept ? 0 : bt.nv * L::Q_BYTES));
#pragma unroll
      for (int c = 0; c < DC; ++c)
        tma_load(smem + L::K_OFF + s * L::KV_BYTES + c * BK * ROW, k_map,
                 bar.k_full + s, part.col(u) + c * BOX, h, kt * BK, b);
      if (!part.kept) load_q(u, s, bar.k_full + s);
    }
    if (part.out) {
      const int s = kt & 1;
      const int use = kt >> 1;
#pragma unroll
      for (int w = 0; w < CONS; ++w)
        if (use > 0 && kt - 2 < bt.n_kv[w])
          mbar_wait(bar.v_empty + s * CONS + w, (use - 1) & 1);
      mbar_expect_tx(bar.v_full + s, L::KV_BYTES);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        tma_load(smem + L::V_OFF + s * L::KV_BYTES + c * BK * ROW, v_map,
                 bar.v_full + s, part.c_out + c * BOX, h, kt * BK, b);
    }
  }
}

// The LDG producer of a block in a group of clusters, in pieces: first
// each consumer's kb Q chunks (kept; consumer w's chunk u in its slot u),
// then for each K/V tile its kb steps, each the step's Q chunks (streamed,
// into slot step % 2) and its K chunk, then the tile's V (with an output
// chunk)
template <typename T, int CL, int XP>
__device__ __forceinline__ void produce_ldg_steps(
    uint8_t* smem, const uint16_t* __restrict__ q,
    const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
    const Bars<CW, XP>& bar, int b, int h, int nq, int t_q, int t_k,
    int heads, int d, int causal, int q_offset, const GroupPart<CL>& part) {
  using L = Layout<CW, true, XP, 2>;
  using C = Tiles<CW, XP>;
  using P = Pieces<CW, XP>;
  constexpr int CONS = C::CONSUMERS;
  constexpr int BK = C::BK;
  const int rs = heads * d;
  const uint16_t* q_bh = q + ((int64_t)b * t_q * heads + h) * d;
  const uint16_t* k_bh = k + ((int64_t)b * t_k * heads + h) * d;
  const uint16_t* v_bh = v + ((int64_t)b * t_k * heads + h) * d;
  const BlockTiles<CONS, C::PAIRED, BK> bt(nq, t_q, t_k, causal, q_offset);
  const int kb = part.kb;
  const int q_pieces = part.kept ? bt.nv * kb * P::QP : 0;
  const int sq = part.kept ? 0 : bt.nv * P::QP;   // Q pieces a step
  const int per_step = sq + P::KP;
  const int per_tile = kb * per_step + (part.out ? P::KP : 0);
  const uint32_t base = smem_addr(smem);
  // piece e of consumer w's Q chunk u, into its slot
  auto q_piece = [&](int w, int u, int slot, int e) {
    PieceAt x;
    x.src = q_bh + part.col(u);
    x.t_len = t_q;
    x.r0 = e * P::SR;
    x.row0 = bt.tile_of(w) * WG_BQ + x.r0;
    x.rows = WG_BQ;
    x.dv = min(d - part.col(u), CW);
    x.tile = base + (2 * w + slot) * L::Q_BYTES;
    return x;
  };
  auto at = [&](int i) -> PieceAt {
    if (i < q_pieces) {
      const int e = i % (kb * P::QP);
      return q_piece(i / (kb * P::QP), e / P::QP, e / P::QP, e % P::QP);
    }
    const int j = i - q_pieces;
    const int kt = j / per_tile;
    const int p = j % per_tile;
    PieceAt x;
    if (p < kb * per_step) {
      const int u = p / per_step;
      const int e = p % per_step;
      const int s = (kt * kb + u) & 1;
      if (e < sq) return q_piece(e / P::QP, u, s, e % P::QP);
      x.r0 = (e - sq) * P::SR;
      x.src = k_bh + part.col(u);
      x.dv = min(d - part.col(u), CW);
      x.tile = base + L::K_OFF + s * L::KV_BYTES;
    } else {
      x.r0 = (p - kb * per_step) * P::SR;
      x.src = v_bh + part.c_out;
      x.dv = min(d - part.c_out, CW);
      x.tile = base + L::V_OFF + (kt & 1) * L::KV_BYTES;
    }
    x.t_len = t_k;
    x.row0 = kt * BK + x.r0;
    x.rows = BK;
    return x;
  };
  // a step's (a V tile's) first piece: its stage is free once every
  // consumer that read step - 2 (tile kt - 2) is done with it
  auto wait_free = [&](int i) {
    const int j = i - q_pieces;
    if (j < 0) return;
    const int kt = j / per_tile;
    const int p = j % per_tile;
    if (p < kb * per_step) {
      const int step = kt * kb + p / per_step;
      if (p % per_step != 0 || step < 2) return;
#pragma unroll
      for (int w = 0; w < CONS; ++w)
        if ((step - 2) / kb < bt.n_kv[w])
          mbar_wait(bar.k_empty + (step & 1) * CONS + w,
                    ((step >> 1) - 1) & 1);
    } else if (p == kb * per_step && kt >= 2) {
#pragma unroll
      for (int w = 0; w < CONS; ++w)
        if (kt - 2 < bt.n_kv[w])
          mbar_wait(bar.v_empty + (kt & 1) * CONS + w, ((kt >> 1) - 1) & 1);
    }
  };
  auto full = [&](int i) -> uint64_t* {
    if (i == q_pieces - 1) return bar.q_full;
    const int j = i - q_pieces;
    if (j < 0) return nullptr;
    const int kt = j / per_tile;
    const int p = j % per_tile;
    if (p < kb * per_step)
      return p % per_step == per_step - 1
                 ? bar.k_full + ((kt * kb + p / per_step) & 1)
                 : nullptr;
    return p == per_tile - 1 ? bar.v_full + (kt & 1) : nullptr;
  };
  // streamed: q_full completes on the loading threads' arrivals alone
  if (!part.kept) mbar_arrive(bar.q_full);
  ldg_pieces<CW, XP, 2>(smem, rs, q_pieces + bt.n_max * per_tile, at,
                        wait_free, full);
}

// FORM 0: one cluster of CL blocks, block z owning chunk z of d; FORM 1:
// groups of clusters of CL blocks (GroupPart)
template <typename T, int CL, int FORM>
__global__ void __launch_bounds__(Tiles<CW, XP_TMA>::THREADS, 1)
flash_fwd_tc_cluster(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     uint16_t* __restrict__ o, int t_q, int t_k, int heads,
                     int d, float scale_log2, int causal, int q_offset) {
  using L = Layout<CW, false, XP_TMA, FORM ? 2 : 1>;
  using C = Tiles<CW, XP_TMA>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Bars<CW, XP_TMA> bar(smem + L::BAR_OFF, 1, CL);
  cluster_sync();

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int nq = (t_q + WG_BQ - 1) / WG_BQ;
  const int c0 = (int)blockIdx.z * CW;   // rank z's chunk of d (form 0)
  // the warpgroup, as a value the compiler knows to be warp-uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == C::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     C::PRODUCER_REGS)
                 : "memory");
    if constexpr (FORM) {
      produce_tma_steps<CL, XP_TMA>(smem, &q_map, &k_map, &v_map, bar, b, h,
                                    nq, t_q, t_k, causal, q_offset,
                                    GroupPart<CL>(d));
    } else {
      produce_tma<CW, XP_TMA>(smem, &q_map, &k_map, &v_map, bar.q_full,
                              bar.k_full, bar.v_full, bar.k_empty,
                              bar.v_empty, b, h, nq, t_q, t_k, causal,
                              q_offset, c0);
    }
  } else {
    const ClusterExchange<CL, C::BK, XP_TMA, C::CONSUMERS> x{
        smem_addr(smem + L::X_OFF + wg * L::X_BYTES),
        smem_addr(bar.x_full + wg)};
    if constexpr (FORM) {
      consume_steps<T, false, C::CONSUMER_REGS>(
          smem, bar, wg, o, b, h, nq, t_q, t_k, heads, d, scale_log2, causal,
          q_offset, GroupPart<CL>(d), x);
    } else {
      consume<T, CW, false, C::CONSUMER_REGS>(
          smem, bar.q_full, bar.k_full, bar.v_full, bar.k_empty, bar.v_empty,
          bar.turn, wg, o, b, h, nq, t_q, t_k, heads, d, scale_log2, causal,
          q_offset, c0, x);
    }
  }
}

template <typename T, int CL, int FORM>
__global__ void __launch_bounds__(Tiles<CW, XP_LDG>::THREADS, 1)
flash_fwd_tc_cluster_ldg(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         uint16_t* __restrict__ o, int t_q, int t_k,
                         int heads, int d, float scale_log2, int causal,
                         int q_offset) {
  using L = Layout<CW, true, XP_LDG, FORM ? 2 : 1>;
  using C = Tiles<CW, XP_LDG>;
  using G = Ldg<CW, XP_LDG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Bars<CW, XP_LDG> bar(smem + L::BAR_OFF, LDG_THREADS, CL);
  cluster_sync();

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int nq = (t_q + WG_BQ - 1) / WG_BQ;
  const int c0 = (int)blockIdx.z * CW;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == C::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     G::PRODUCER_REGS)
                 : "memory");
    if constexpr (FORM) {
      produce_ldg_steps<T, CL, XP_LDG>(smem, q, k, v, bar, b, h, nq, t_q,
                                       t_k, heads, d, causal, q_offset,
                                       GroupPart<CL>(d));
    } else {
      produce_ldg<T, CW, XP_LDG>(smem, q, k, v, bar.q_full, bar.k_full,
                                 bar.v_full, bar.k_empty, bar.v_empty, b, h,
                                 nq, t_q, t_k, heads, d, causal, q_offset,
                                 c0);
    }
  } else {
    const ClusterExchange<CL, C::BK, XP_LDG, C::CONSUMERS> x{
        smem_addr(smem + L::X_OFF + wg * L::X_BYTES),
        smem_addr(bar.x_full + wg)};
    if constexpr (FORM) {
      consume_steps<T, true, G::CONSUMER_REGS>(
          smem, bar, wg, o, b, h, nq, t_q, t_k, heads, d, scale_log2, causal,
          q_offset, GroupPart<CL>(d), x);
    } else {
      consume<T, CW, true, G::CONSUMER_REGS>(
          smem, bar.q_full, bar.k_full, bar.v_full, bar.k_empty, bar.v_empty,
          bar.turn, wg, o, b, h, nq, t_q, t_k, heads, d, scale_log2, causal,
          q_offset, c0, x);
    }
  }
}

}  // namespace wgk

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

// grid y and z: at most 65535 each (x: batch * heads, checked by the entry)
constexpr int MAX_GRID_YZ = 65535;

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The (d, H, T, B) tensor map of a contiguous (B, T, H, D) 16-bit tensor,
// boxes of 64 elements of d by `rows` rows under the 128-byte swizzle;
// elements outside the tensor read as zero
template <typename T>
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int batch, int t,
                       int heads, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)t,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)t * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)wgk::BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same_v<T, __nv_bfloat16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int DP>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o,
                      int batch, int t_q, int t_k, int heads, int d,
                      float scale, int causal, int q_offset,
                      cudaStream_t stream) {
  using namespace wgk;
  using C = Tiles<DP>;
  static std::atomic<uint64_t> smem_set{0};
  constexpr size_t smem = Layout<DP>::BYTES;
  // CONSUMERS 64-row Q tiles a block
  const int nq = (t_q + WG_BQ - 1) / WG_BQ;
  const int blocks = (nq + C::CONSUMERS - 1) / C::CONSUMERS;
  if (blocks > MAX_GRID_YZ) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_tc_wg<T, DP>, smem, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  if ((err = tensor_map<T>(&qm, q, batch, t_q, heads, d, WG_BQ)) !=
          cudaSuccess ||
      (err = tensor_map<T>(&km, k, batch, t_k, heads, d, C::BK)) !=
          cudaSuccess ||
      (err = tensor_map<T>(&vm, v, batch, t_k, heads, d, C::BK)) !=
          cudaSuccess)
    return err;
  dim3 grid(batch * heads, blocks);
  flash_fwd_tc_wg<T, DP><<<grid, C::THREADS, smem, stream>>>(
      qm, km, vm, static_cast<uint16_t*>(o), t_q, t_k, heads, d,
      scale * LOG2E, causal, q_offset);
  return cudaGetLastError();
}

// The LDG route: flash_fwd_tc_wg's grid, plain pointers in place of tensor
// maps
template <typename T, int DP>
cudaError_t launch_wg_ldg(const void* q, const void* k, const void* v,
                          void* o, int batch, int t_q, int t_k, int heads,
                          int d, float scale, int causal, int q_offset,
                          cudaStream_t stream) {
  using namespace wgk;
  using C = Tiles<DP>;
  static std::atomic<uint64_t> smem_set{0};
  constexpr size_t smem = Layout<DP, true>::BYTES;
  const int nq = (t_q + WG_BQ - 1) / WG_BQ;
  const int blocks = (nq + C::CONSUMERS - 1) / C::CONSUMERS;
  if (blocks > MAX_GRID_YZ) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_tc_wg_ldg<T, DP>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * heads, blocks);
  flash_fwd_tc_wg_ldg<T, DP><<<grid, C::THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), t_q, t_k,
      heads, d, scale * LOG2E, causal, q_offset);
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

// The clusters of head dim d > 256, the twin of flash_attention_fwd.cu's
// cluster_shape at chunk width CW: n = ceil(d / CW) chunks; up to CL_MOST
// one cluster of n blocks (form 0), above `groups` = ceil(n / CL_MOST) of
// `blocks` = ceil(n / groups) blocks each (form 1), each block reducing at
// most `chunks` = ceil(n / blocks) chunks
struct ClusterShape {
  int groups, blocks, chunks;
};
inline ClusterShape cluster_shape(int d) {
  const int n = (d - 1) / wgk::CW + 1;
  const int g = (n - 1) / wgk::CL_MOST + 1;
  const int c = (n - 1) / g + 1;
  return {g, c, (n - 1) / c + 1};
}

// The cluster kernel of the route (LDG: the rows TMA refuses) for clusters
// of CL blocks in form FORM, its shared memory and its launch over (x, y)
// pairs of Q tiles and `groups` clusters on z (pointing at `cluster`),
// after the kernel's dynamic shared memory has been allowed on the current
// device
template <typename T, bool LDG, int CL, int FORM>
struct ClusterLaunch {
  static constexpr int QS = FORM ? 2 : 1;
  static constexpr size_t SMEM =
      LDG ? wgk::Layout<wgk::CW, true, wgk::XP_LDG, QS>::BYTES
          : wgk::Layout<wgk::CW, false, wgk::XP_TMA, QS>::BYTES;
  static auto kernel() {
    if constexpr (LDG) {
      return wgk::flash_fwd_tc_cluster_ldg<T, CL, FORM>;
    } else {
      return wgk::flash_fwd_tc_cluster<T, CL, FORM>;
    }
  }
  static cudaError_t config(int x, int y, int groups, cudaStream_t stream,
                            cudaLaunchAttribute& cluster,
                            cudaLaunchConfig_t& config) {
    static std::atomic<uint64_t> smem_set{0};
    cudaError_t err = allow_smem(kernel(), SMEM, smem_set);
    if (err != cudaSuccess) return err;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = 1;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = CL;
    config = {};
    config.gridDim = dim3(x, y, groups * CL);
    config.blockDim = dim3(wgk::Tiles<wgk::CW, wgk::XP_TMA>::THREADS);
    config.dynamicSmemBytes = SMEM;
    config.stream = stream;
    config.attrs = &cluster;
    config.numAttrs = 1;
    return cudaSuccess;
  }
};

// flash_fwd_tc_cluster (TMA) or flash_fwd_tc_cluster_ldg at CL blocks a
// cluster in form FORM, `groups` clusters on z: flash_fwd_tc_wg's grid at
// width CW on x and y
template <typename T, bool LDG, int CL, int FORM>
cudaError_t launch_cluster_at(const void* q, const void* k, const void* v,
                              void* o, int batch, int t_q, int t_k,
                              int heads, int d, float scale, int causal,
                              int q_offset, int groups, cudaStream_t stream) {
  using namespace wgk;
  using X = ClusterLaunch<T, LDG, CL, FORM>;
  using C = Tiles<CW, XP_TMA>;
  static std::atomic<uint64_t> placed{0};
  const int nq = (t_q + WG_BQ - 1) / WG_BQ;
  const int blocks = (nq + C::CONSUMERS - 1) / C::CONSUMERS;
  if (blocks > MAX_GRID_YZ || (int64_t)groups * CL > MAX_GRID_YZ)
    return cudaErrorInvalidValue;
  cudaLaunchAttribute cluster;
  cudaLaunchConfig_t config;
  cudaError_t err =
      X::config(batch * heads, blocks, groups, stream, cluster, config);
  if (err != cudaSuccess) return err;
  err = cluster_placeable(X::kernel(), config, placed);
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * LOG2E;
  uint16_t* out = static_cast<uint16_t*>(o);
  if constexpr (LDG) {
    err = cudaLaunchKernelEx(&config, X::kernel(),
                             static_cast<const uint16_t*>(q),
                             static_cast<const uint16_t*>(k),
                             static_cast<const uint16_t*>(v), out, t_q, t_k,
                             heads, d, scale_log2, causal, q_offset);
  } else {
    CUtensorMap qm, km, vm;
    if ((err = tensor_map<T>(&qm, q, batch, t_q, heads, d, WG_BQ)) !=
            cudaSuccess ||
        (err = tensor_map<T>(&km, k, batch, t_k, heads, d, C::BK)) !=
            cudaSuccess ||
        (err = tensor_map<T>(&vm, v, batch, t_k, heads, d, C::BK)) !=
            cudaSuccess)
      return err;
    err = cudaLaunchKernelEx(&config, X::kernel(), qm, km, vm, out, t_q, t_k,
                             heads, d, scale_log2, causal, q_offset);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

// The cluster sizes of each form, one instantiation a size: form 0
// CL_MIN..CL_MOST (d 257 to CW CL_MOST), form 1 GL_MIN..CL_MOST (the
// blocks of ceil(n / CL_MOST) groups of n chunks past CL_MOST)
using OneSizes =
    std::make_integer_sequence<int, wgk::CL_MOST - wgk::CL_MIN + 1>;
using GroupSizes =
    std::make_integer_sequence<int, wgk::CL_MOST - wgk::GL_MIN + 1>;

// f(Int<c>{}, Int<FORM>{}) for the size c == blocks of form FORM
template <int FORM, class F, int... I>
void at_size(int blocks, F f, std::integer_sequence<int, I...>) {
  constexpr int FIRST = FORM ? wgk::GL_MIN : wgk::CL_MIN;
  ((blocks == FIRST + I ? f(wgk::Int<FIRST + I>{}, wgk::Int<FORM>{})
                        : (void)0),
   ...);
}
template <class F>
void at_shape(int blocks, int form, F f) {
  if (form) {
    at_size<1>(blocks, f, GroupSizes{});
  } else {
    at_size<0>(blocks, f, OneSizes{});
  }
}

// d > 256: cluster_shape(d)'s clusters
template <typename T, bool LDG>
cudaError_t launch_cluster(const void* q, const void* k, const void* v,
                           void* o, int batch, int t_q, int t_k, int heads,
                           int d, float scale, int causal, int q_offset,
                           cudaStream_t stream) {
  const ClusterShape shape = cluster_shape(d);
  cudaError_t err = cudaErrorInvalidValue;
  at_shape(shape.blocks, shape.groups > 1, [&](auto cl, auto form) {
    err = launch_cluster_at<T, LDG, decltype(cl)::value,
                            decltype(form)::value>(
        q, k, v, o, batch, t_q, t_k, heads, d, scale, causal, q_offset,
        shape.groups, stream);
  });
  return err;
}

// Up to d 256 the wgmma kernel at the smallest width that holds d: 16-byte
// rows through TMA, the others (2-byte copies) through the LDG producer;
// above, the cluster kernel of the same producer
template <typename T, int WIDTH>
cudaError_t launch_width(const void* q, const void* k, const void* v,
                         void* o, int batch, int t_q, int t_k, int heads,
                         int d, float scale, int causal, int q_offset,
                         int copy_bytes, cudaStream_t stream) {
  return copy_bytes == 16
             ? launch_wg<T, WIDTH>(q, k, v, o, batch, t_q, t_k, heads, d,
                                   scale, causal, q_offset, stream)
             : launch_wg_ldg<T, WIDTH>(q, k, v, o, batch, t_q, t_k, heads, d,
                                       scale, causal, q_offset, stream);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int batch, int t_q, int t_k, int heads, int d,
                     float scale, int causal, int q_offset, int copy_bytes,
                     cudaStream_t stream) {
  if (d <= 64)
    return launch_width<T, 64>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                               causal, q_offset, copy_bytes, stream);
  if (d <= 128)
    return launch_width<T, 128>(q, k, v, o, batch, t_q, t_k, heads, d,
                                scale, causal, q_offset, copy_bytes, stream);
  if (d <= 192)
    return launch_width<T, 192>(q, k, v, o, batch, t_q, t_k, heads, d,
                                scale, causal, q_offset, copy_bytes, stream);
  if (d <= 256)
    return launch_width<T, 256>(q, k, v, o, batch, t_q, t_k, heads, d,
                                scale, causal, q_offset, copy_bytes, stream);
  if (copy_bytes == 16)
    return launch_cluster<T, false>(q, k, v, o, batch, t_q, t_k, heads, d,
                                    scale, causal, q_offset, stream);
  return launch_cluster<T, true>(q, k, v, o, batch, t_q, t_k, heads, d,
                                 scale, causal, q_offset, stream);
}

}  // namespace

// The library builds in two parts, one nvcc each, started together
// (_native.PARTS): part 0 (MXTT_PART 0) instantiates the bf16 kernels and
// holds the C entries, part 1 the fp16 kernels, reached through
// mxtt_tc_dispatch_fp16.
#if !defined(MXTT_PART) || (MXTT_PART != 0 && MXTT_PART != 1)
#error "MXTT_PART (0 or 1) names the part of the library an object holds"
#endif
cudaError_t mxtt_tc_dispatch_fp16(const void* q, const void* k,
                                  const void* v, void* o, int batch, int t_q,
                                  int t_k, int heads, int d, float scale,
                                  int causal, int q_offset, int copy_bytes,
                                  cudaStream_t stream);
#if MXTT_PART == 1
cudaError_t mxtt_tc_dispatch_fp16(const void* q, const void* k,
                                  const void* v, void* o, int batch, int t_q,
                                  int t_k, int heads, int d, float scale,
                                  int causal, int q_offset, int copy_bytes,
                                  cudaStream_t stream) {
  return dispatch<__half>(q, k, v, o, batch, t_q, t_k, heads, d, scale,
                          causal, q_offset, copy_bytes, stream);
}
#endif
#if MXTT_PART == 0

// q: (batch, t_q, heads, d), k/v: (batch, t_k, heads, d), o like q; all
// contiguous, on the current device. dtype 1 is bfloat16, 2 is float16 (0,
// float32, is flash_attention_fwd.cu's). copy_bytes is 16 (TMA: needs d % 8
// == 0 and 16-byte aligned q, k, v and o) or 2 (any d and 2-byte
// alignment: the LDG producer). Up to d 256 flash_fwd_tc_wg (16) or
// flash_fwd_tc_wg_ldg (2), above flash_fwd_tc_cluster or
// flash_fwd_tc_cluster_ldg (cudaErrorInvalidConfiguration where the card
// cannot place the cluster). Returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue where the kernel's grid would pass the
// card's limits).
extern "C" int mxtt_flash_attention_fwd_tc(const void* q, const void* k,
                                           const void* v, void* o, int batch,
                                           int t_q, int t_k, int heads, int d,
                                           float scale, int causal,
                                           int q_offset, int dtype,
                                           int copy_bytes, void* stream) {
  // grid: batch * heads on x (< 2^31); each launcher checks its y (Q
  // tiles, or pairs of them) and z (the blocks of the groups of clusters)
  if (batch <= 0 || t_q <= 0 || t_k <= 0 || heads <= 0 || d <= 0 ||
      q_offset < 0 || (dtype != 1 && dtype != 2) ||
      (int64_t)batch * heads > INT32_MAX ||
      (copy_bytes != 16 && copy_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(o);
  if (copy_bytes == 16 && (d % 8 != 0 || any % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, batch, t_q, t_k, heads,
                                        d, scale, causal, q_offset,
                                        copy_bytes, s);
  return (int)mxtt_tc_dispatch_fp16(q, k, v, o, batch, t_q, t_k, heads, d,
                                    scale, causal, q_offset, copy_bytes, s);
}

// The registers a thread (setmaxnreg) of the wgmma kernel's producer
// (consumer == 0) or consumers (consumer == 1) at width 64, 128, 192 or 256,
// on the TMA route (ldg == 0) or the LDG route; width 0: the cluster
// kernel's (flash_fwd_tc_cluster, flash_fwd_tc_cluster_ldg); -1 for another
// width
extern "C" int mxtt_flash_attention_fwd_tc_regs(int width, int ldg,
                                                int consumer) {
  using namespace wgk;
  auto pick = [&](auto c, auto g) {
    using C = decltype(c);
    using G = decltype(g);
    if (ldg) return consumer ? G::CONSUMER_REGS : G::PRODUCER_REGS;
    return consumer ? C::CONSUMER_REGS : C::PRODUCER_REGS;
  };
  switch (width) {
    case 0: return pick(Tiles<CW, XP_TMA>{}, Ldg<CW, XP_LDG>{});
    case 64: return pick(Tiles<64>{}, Ldg<64>{});
    case 128: return pick(Tiles<128>{}, Ldg<128>{});
    case 192: return pick(Tiles<192>{}, Ldg<192>{});
    case 256: return pick(Tiles<256>{}, Ldg<256>{});
    default: return -1;
  }
}

// How many clusters of `blocks` blocks in form `form` (0: one cluster a
// Q-tile pair, blocks 2-8; 1: groups of clusters, blocks 5-8) of the 16-bit
// cluster kernel (bf16; ldg != 0: flash_fwd_tc_cluster_ldg) the current
// device holds at once (cudaOccupancyMaxActiveClusters), or minus the
// cudaError_t of the query (cudaErrorInvalidValue: no such cluster size)
extern "C" int mxtt_flash_attention_fwd_tc_clusters(int blocks, int ldg,
                                                    int form) {
  int clusters = 0;
  cudaError_t err = cudaErrorInvalidValue;
  auto ask = [&](auto launch) {
    using X = decltype(launch);
    cudaLaunchAttribute cluster;
    cudaLaunchConfig_t config;
    err = X::config(1, 1, 1, nullptr, cluster, config);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &clusters, reinterpret_cast<const void*>(X::kernel()), &config);
  };
  at_shape(blocks, form != 0, [&](auto cl, auto f) {
    constexpr int CL = decltype(cl)::value, FORM = decltype(f)::value;
    if (ldg) {
      ask(ClusterLaunch<__nv_bfloat16, true, CL, FORM>{});
    } else {
      ask(ClusterLaunch<__nv_bfloat16, false, CL, FORM>{});
    }
  });
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return clusters;
}
#endif

// Kernel 10: W4A16 grouped matmul, out[M, N] = x[M, K] @ dequant(q, scale)^T,
// and its transposed form for the input gradient, dx[M, K] = dy[M, N] @ W.
//
// Replaces the TPU kernel `ops/int4_kernel.py` `int4_matmul_kernel` (its
// `pl.pallas_call` at :157, body `_kernel`); the transposed form replaces the
// XLA product of `ops/quant.py` `_int4_kernel_mm_bwd` (:189).
// x is bf16 [M, K]; q is int32 [N, K / 8], eight 4-bit codes a word stored
// offset-binary (code + 8, code in [-7, 7]); scale is fp32 [G, N], one scale
// for every K / G contraction elements of an output channel; out is bf16.
//
// Stored order (`ops/quant.int4_k_order`): K is cut into tiles of 128. Of an
// output channel's 64 bytes in a tile, lane t (0..3) of a quad owns bytes
// 16t..16t+15, four words; word j, shifted right by 4 * (2 * sl + half) and
// masked with 0x000F000F, is the pair of codes for
//   k = 16 * (2j + sl) + 8 * half + 2t + {0, 1},
// which is what register `half` of B (register 2 * half of A, for the row
// the channel is) holds in mma step 2j + sl of the m16n8k16 fragment layout
// (attention_common.cuh), and wgmma's register A has that layout. So one
// 16-byte load a lane feeds the eight k steps of a tile and the activations
// keep their natural order. Put otherwise: word (t, j) >> 4q gives the pair
// k = 32j + 8q + 2t + {0, 1}, so the four words (t = 0..3, j) fill the four
// 8-element chunks 4j + q, q = 0..3, of a tile in natural order: that is how
// the transposed form writes the weight into shared memory.
//
// Nibble -> bf16 without a convert: 0x4300 | u is the bf16 number 128 + u
// (u < 128 fits the mantissa), and (128 + u) - 136 = u - 8 is exact.
//
// Bound on the H100: M <= 16 reads each packed byte once for ~4M FLOP, so
// HBM bandwidth is the floor (K = N = 4096: 8.4 MB, ~2.6 us); M in the
// thousands is bound by the tensor cores (989 TFLOP/s bf16). Arithmetic of
// the forward: products of bf16 activations and exact integer codes, fp32
// sums over a scale group, the group's sum times its fp32 scale added to an
// fp32 accumulator (the scale is never folded into a bf16 weight, which
// would round differently from the plain version and the TPU kernel).
//
// Decode body (M <= 16), `int4_decode_kernel`: a step of a decode batch,
// where every weight byte is read once for ~M FLOP, so the body has to keep
// every SM streaming words. The `mma.sync` body it replaced (16 channels a
// block, each warp one k-tile of words ahead in registers, x re-read from
// L2 by every block as the A operand of 16 rows) reached 31-52 % of the byte
// bound at M = 4 and ran 1.6-2.5x slower at M = 16 (PERF.md, section 6,
// row 10). This one:
// - swaps the operands as the wgmma body does, out^T = W x^T: the dequantised
//   words are register A of `mma.sync.m16n8k16`, x^T is B (n = 8: one
//   product a k step for M <= 8, two for M <= 16), so no padded row of x
//   enters a product. `wgmma.m64n8k16` / `m64n16k16` issue fewer
//   instructions for the same weight bytes (1.4 against 1.5 and 3 for every
//   128 bytes), but a build of this body on them ran slower at M = 4 on an
//   H100 (each stage waited on its asynchronous products before the
//   scale), so mma.sync carries it. What the products cost is the turning
//   of nibbles into bf16, 11 instructions a word (three shifts, then a lop3
//   and a bf16 subtraction a pair, `dequant_pair_reg`), and the issue slots
//   around them: the loop counts its scale groups down and keeps its shared
//   memory offsets in registers, with no division in it;
// - a block owns 128 channels (eight warps of 16) and a contiguous range of
//   k-tiles. One copy thread brings two k-tiles a stage by TMA (the layout
//   above the kernel) into a ring with a full and an empty mbarrier a stage,
//   and issues each stage once the one before it has landed, so that a
//   block's stages land one after another and its products run under the
//   copies still in flight. Two blocks fit an SM with a ring of four; where
//   that grid would leave SMs idle, three with a ring of two (the launcher
//   below);
// - split-K over a thread-block cluster: the grid is (splits, channel
//   tiles), the `splits` blocks of a channel tile (at most 8, the portable
//   cluster size) a cluster, from N, K and the SM count (two or three
//   blocks an SM, one wave), cut to what the occupancy calculator says fits
//   at once: a second wave of clusters cost a block's whole time. On 132
//   SMs: 6 splits, two an SM, 192 blocks at 4096 -> 4096; 4, three an SM,
//   344 blocks at 4096 -> 11008; 7, two, 224 at 11008 -> 4096; 1, two, 250
//   at 4096 -> 32000. A block's range may cut a scale group: each block
//   multiplies its own part of a group by the group's scale, and the
//   partials meet in distributed shared memory, summed in rank order (no
//   atomics, no second launch: two runs give the same bits). A block writes
//   into another's shared memory only after a cluster barrier whose arrival
//   every block made on starting;
// - programmatic dependent launch: a block may start while the launch before
//   it ends; its first stage's words and scales, which do not depend on
//   that launch, are copied at once, and x only after `griddepcontrol.wait`
//   (so is out written).
// Measured and dropped (PERF.md, section 6): an L2 prefetch of the first
// stages' words before the wait (slower where no kernel-10 launch precedes
// the launch, as in a decode step), every stage issued at once or two ahead
// (slower: the stages landed together and the products ran after them), the
// first two stages before the wait, and splits that balance the weight
// bytes an SM with one block an SM (slower than two blocks an SM).
//
// Large body (M > 16), `int4_wgmma_kernel`. The `mma.sync` body it replaced
// ran at ~20 % of the bf16 peak, bound by the instruction rate: every warp
// unpacked its own B fragments from the words, both row warps repeated the
// same channels' work, and A came from shared memory four 32-bit loads an
// mma. This one feeds `wgmma.mma_async` and unpacks each weight once a
// block, in registers:
// - it computes out^T = W x^T, so that the weight is wgmma's A, which may
//   come from registers: a lane's A fragment of k step s (m16n8k16 layout)
//   is exactly the pairs that its channels' words (t, s / 2) hold at shifts
//   8(s % 2) and 8(s % 2) + 4, the stored order, so one 16-byte shared load
//   a channel gives a stage's fragments with no reordering; x is B, K-major
//   in shared memory;
// - a block owns 128 channels x 128 rows of x and walks K in stages of 128
//   (one stored tile; a scale group is one or more whole stages). One thread
//   brings each stage by TMA into a ring of five with a full and an empty
//   mbarrier each: x [128, 128] as two 128-byte-swizzled [128, 64] boxes
//   (rows past M read as zero), the channels' words [128, 16] and the
//   group's scales [128]. Every load is TMA: a thread's own outstanding
//   loads (plain or cp.async) made its release of a stage wait for them;
// - two warpgroups take 64 channels each: eight `m64n128k16` a stage into a
//   partial fp32 accumulator (the first of a group overwrites it), then,
//   once a group is complete, acc += part * scale in fp32. They start their
//   products in turn (named barriers), so that one's scaling and unpacking
//   run while the other's products do; both waiting on the tensor cores at
//   once left them idle for that time;
// - persistent: one block an SM walks output tiles, and the ring runs on
//   across tiles, so a tile's loads and products overlap the store of the
//   one before it;
// - 64 + 64 accumulator and 32 fragment registers a thread: the copy
//   warpgroup gives up registers by setmaxnreg (ptxas allocates 168 for a
//   384-thread block; the consumers fit without spilling, but not with the
//   next stage's fragments formed early as well).
// Measured alternatives (PERF.md, section 6): the weight dequantised once a
// block into shared memory for wgmma's B, by a producer warpgroup or by the
// two consumer warpgroups a stage ahead, ran at 0.98 and 1.28 ms against
// this body's 0.73 at M=11,248, K=N=4,096: their stores, proxy fences and
// barrier round trips sat on the critical path. No atomics, no split-K:
// each output is summed in one order, so two runs give the same bits.
//
// Transposed form (`int4_wgmma_dx_kernel`), dx = dy @ W with W = bf16(code *
// bf16(scale)): the product autograd needs for x. Contraction over N (the
// stored rows), output over K. W is formed with one bf16 multiply of the
// exact code and the bf16 scale, which rounds the exact product once as
// PyTorch's bf16 multiply does, so the weights are bit-equal to
// `dequantize_int4(..., bfloat16)` and only the order of summation differs
// from `dy @ dequantize_int4(...)`. Here W must be wgmma's B, which is read
// from shared memory only, so it is formed there: a block owns 128 rows x
// 128 columns of K (one stored tile, so each stored row has one scale
// there) and walks N in stages of 64 (six in the ring). The copy warp
// brings dy [128, 64], the stage's words [64, 16] (64-byte swizzled) and
// scales by TMA; two producer warpgroups, on alternate stages, write W's
// [64, 128] slice with K contiguous, i.e. MN-major for wgmma's B (transpose
// bit set), then a fence to the async proxy and an mbarrier arrival; two
// consumer warpgroups of 64 rows each run four `m64n128k16` a stage into one
// fp32 accumulator. One block a tile (a persistent form of it measured 8 %
// slower).
#include <cooperative_groups.h>

#include <algorithm>
#include <atomic>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

namespace cg = cooperative_groups;

using lvr::bf16;
using lvr::mma_16816;

constexpr int kTile = 128;       // contraction elements per k-tile
constexpr int kWordsPerTile = 16;

// the pair of codes at nibble positions (shift / 4, shift / 4 + 4) of `word`
__device__ __forceinline__ uint32_t dequant_pair(uint32_t word, int shift) {
  const uint32_t biased = ((word >> shift) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 v = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&biased),
      __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// dequant_pair in three instructions, not four: the mask and the exponent in
// one lop3, with `magic` = 0x43004300 in a register (a LOP3 takes one
// immediate, so the compiler splits (w & mask) | imm in two)
__device__ __forceinline__ uint32_t dequant_pair_reg(uint32_t word, int shift,
                                                     uint32_t magic) {
  uint32_t biased;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n"
      : "=r"(biased)
      : "r"(word >> shift), "n"(0x000F000F), "r"(magic));
  const __nv_bfloat162 v = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&biased),
      __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t word_of(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// ---- M > 16: wgmma bodies ------------------------------------------------
namespace hp = lvr::hopper;

constexpr int kBM = 128;                 // rows of x (or dy) a block
constexpr int kBN = 128;                 // output columns a block
constexpr int kConsumers = 256;          // two warpgroups of wgmma
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kHalfTile = kBM * 64 * 2;  // a swizzled [128, 64] bf16 box: 16 KB

// the shared-memory ring starts on a 1024-byte boundary (the swizzle's period)
__device__ __forceinline__ uint32_t ring_base(const uint8_t* raw) {
  return (hp::smem_u32(raw) + 1023u) & ~1023u;
}

// forward: stages of 128 contraction elements (one stored tile, and the
// scale's granularity); warps 0-7 compute, thread 256 starts the copies
constexpr int kStages = 5;
constexpr int kThreadsMm = kConsumers + 128;
// 3 x 128 x 168 registers at launch; the copy warpgroup gives up what the two
// consumer warpgroups take to reach 232 (accumulators 2 x 64, A fragments
// 32)
constexpr int kCopyRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kStageX = 2 * kHalfTile;            // x [128, 128] bf16
constexpr int kStageQ = kBN * kWordsPerTile * 4;  // words [128 channels, 16]
constexpr int kStageS = kBN * 4;                  // scales [128 channels]
constexpr int kOffQ = kStages * kStageX;
constexpr int kOffS = kOffQ + kStages * kStageQ;
constexpr int kOffBar = kOffS + kStages * kStageS;
constexpr int kSmem = kOffBar + 2 * kStages * 8 + 1024;   // + alignment slack

__global__ void __launch_bounds__(kThreadsMm, 1)
    int4_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap s_map,
                      bf16* __restrict__ out, int M, int K, int N,
                      int tiles_per_group) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = ring_base(smem);
  const uint8_t* ring = smem + (base - hp::smem_u32(smem));
  const uint32_t full = base + kOffBar, empty = full + kStages * 8;
  // persistent: block b takes output tiles b, b + gridDim.x, ... (channel
  // tiles fastest, so the blocks in flight share x tiles in L2), and the
  // ring runs on across its tiles: `it` counts the stages of all of them,
  // and a tile's products start while the one before it is stored
  const int k_tiles = K / kTile;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int tiles = n_tiles * ((M + kBM - 1) / kBM);
  const int stages =
      (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x *
      k_tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- copy warp: x [128, 128], the block's words and scales a stage ----
    hp::reg_dealloc<kCopyRegs>();
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = tile % n_tiles * kBN, m0 = tile / n_tiles * kBM;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          const uint32_t bar = full + 8 * s;
          hp::mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
          hp::mbar_arrive_expect_tx(bar, kStageX + kStageQ + kStageS);
          const uint32_t xs = base + s * kStageX;
          hp::tma_load_2d(xs, &x_map, bar, kt * kTile, m0);
          hp::tma_load_2d(xs + kHalfTile, &x_map, bar, kt * kTile + 64, m0);
          hp::tma_load_2d(base + kOffQ + s * kStageQ, &q_map, bar,
                          kt * kWordsPerTile, n0);
          hp::tma_load_2d(base + kOffS + s * kStageS, &s_map, bar, n0,
                          kt / tiles_per_group);
        }
      }
    }
    return;
  }

  // ---- two warpgroups: out^T[channels, rows] = W x^T. Warpgroup wg owns
  // channels 64wg..64wg+63 of the block (wgmma's M), all 128 rows of x (its
  // N). A lane's A fragment is its channels' words turned into bf16 in
  // registers: the stored order is the m16n8k16 fragment order, so word
  // (t, j) >> 8(s & 1) and >> 8(s & 1) + 4 are the lane's pairs of k step
  // s = 2j + (0, 1). ----
  hp::reg_alloc<kConsumerRegs>();
  const int c = threadIdx.x, lane = c & 31, g = lane >> 2, t = lane & 3;
  const int wg = c / 128;
  const int ch = (c >> 5) * 16 + g;          // channel of a[0] (a[1]: + 8)
  const bool odd = g & 1;
  float part[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile % n_tiles * kBN, m0 = tile / n_tiles * kBM;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int s = it % kStages;
      hp::mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint8_t* words = ring + kOffQ + s * kStageQ + t * 16;
      const uint4 wa = *reinterpret_cast<const uint4*>(words + ch * 64);
      const uint4 wb = *reinterpret_cast<const uint4*>(words + (ch + 8) * 64);
      const uint32_t xb = base + s * kStageX;
      const int first = kt % tiles_per_group == 0;
      uint32_t a[8][4];
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int sh = (ks & 1) * 8;
        const uint32_t ua = word_of(wa, ks >> 1), ub = word_of(wb, ks >> 1);
        a[ks][0] = dequant_pair(ua, sh);
        a[ks][1] = dequant_pair(ub, sh);
        a[ks][2] = dequant_pair(ua, sh + 4);
        a[ks][3] = dequant_pair(ub, sh + 4);
      }
      // ping-pong: the warpgroups start their products in turn (0 then 1 for
      // each stage), so that one's scaling and dequantising overlap the
      // other's products instead of both leaving the tensor cores idle at once
      if (wg == 1 || it > 0) hp::bar_sync(wg == 0 ? 2 : 1, kConsumers);
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const uint32_t xk = xb + (ks >> 2) * kHalfTile + (ks & 3) * 32;
        hp::wgmma_m64n128k16_rs(part, a[ks], hp::sw128_desc(xk, 16, 1024),
                                ks > 0 || !first);
      }
      if (wg == 0 || it + 1 < stages) {
        hp::bar_arrive(wg == 0 ? 1 : 2, kConsumers);
      }
      hp::wgmma_commit();
      hp::fence_regs(part);
      hp::wgmma_wait<0>();
      hp::fence_regs(part);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) hp::fence_regs(a[ks]);
      const float* sc =
          reinterpret_cast<const float*>(ring + kOffS + s * kStageS);
      const float sa = sc[ch], sb = sc[ch + 8];
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + 8 * s);
      if ((kt + 1) % tiles_per_group == 0) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          acc[4 * j] += part[4 * j] * sa;
          acc[4 * j + 1] += part[4 * j + 1] * sa;
          acc[4 * j + 2] += part[4 * j + 2] * sb;
          acc[4 * j + 3] += part[4 * j + 3] * sb;
        }
      }
    }
    // acc[4j + 2h + e] is out[m0 + 8j + 2t + e][n0 + ch + 8h]: lanes g and
    // g ^ 1 trade one value each, so that every lane stores two neighbouring
    // channels of one row
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        const float got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
        const int row = m0 + 8 * j + 2 * t + (odd ? 1 : 0);
        const int col = n0 + ch + 8 * h - (odd ? 1 : 0);
        if (row < M && col < N) {
          *reinterpret_cast<uint32_t*>(out + static_cast<long>(row) * N +
                                       col) =
              odd ? lvr::pack_f32(got, v1) : lvr::pack_f32(v0, got);
        }
      }
    }
  }
}

// transposed form: stages of 64 stored rows; warps 0-7 compute, warpgroups
// 2 and 3 form the weight slices of even and odd stages, warp 16 starts the
// copies
constexpr int kDxRows = 64;
constexpr int kDxStages = 6;
constexpr int kDxProducers = 256;
constexpr int kThreadsDx = kConsumers + kDxProducers + 32;
constexpr int kDxStageY = kHalfTile;              // dy [128, 64]
constexpr int kDxStageW = kDxRows * kBN * 2;      // W [64 rows, 128 of K]
constexpr int kDxStageQ = kDxRows * kWordsPerTile * 4;   // words [64, 16]
constexpr int kDxStageS = kDxRows * 4;
constexpr int kDxOffW = kDxStages * kDxStageY;
constexpr int kDxOffQ = kDxOffW + kDxStages * kDxStageW;
constexpr int kDxOffS = kDxOffQ + kDxStages * kDxStageQ;
constexpr int kDxOffBar = kDxOffS + kDxStages * kDxStageS;
constexpr int kDxSmem = kDxOffBar + 3 * kDxStages * 8 + 1024;

__global__ void __launch_bounds__(kThreadsDx, 1)
    int4_wgmma_dx_kernel(const __grid_constant__ CUtensorMap dy_map,
                         const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap s_map,
                         bf16* __restrict__ dx, int M, int K, int N,
                         int group_size) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = ring_base(smem);
  const uint8_t* ring = smem + (base - hp::smem_u32(smem));
  // loaded: the copies landed; full: the weight slice is formed; empty: the
  // consumers are done with the stage
  const uint32_t loaded = base + kDxOffBar, full = loaded + kDxStages * 8,
                 empty = full + kDxStages * 8;
  const int n_stages = (N + kDxRows - 1) / kDxRows;
  const int k0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDxStages; ++s) {
      hp::mbar_init(loaded + 8 * s, 1);
      hp::mbar_init(full + 8 * s, 4);        // one producer warpgroup
      hp::mbar_init(empty + 8 * s, kConsumerWarps);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers + kDxProducers) {
    // ---- copy warp: dy [128, 64], the stage's words and scales ----
    if (threadIdx.x == kConsumers + kDxProducers) {
      for (int st = 0; st < n_stages; ++st) {
        const int s = st % kDxStages;
        const uint32_t bar = loaded + 8 * s;
        hp::mbar_wait(empty + 8 * s, ((st / kDxStages) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(bar, kDxStageY + kDxStageQ + kDxStageS);
        hp::tma_load_2d(base + s * kDxStageY, &dy_map, bar, st * kDxRows, m0);
        hp::tma_load_2d(base + kDxOffQ + s * kDxStageQ, &q_map, bar,
                        (k0 / kTile) * kWordsPerTile, st * kDxRows);
        hp::tma_load_2d(base + kDxOffS + s * kDxStageS, &s_map, bar,
                        st * kDxRows, k0 / group_size);
      }
    }
    return;
  }

  if (threadIdx.x >= kConsumers) {
    // ---- producers: warpgroup p forms the stages of parity p. Thread
    // (row, h) forms stored row `row` of the stage over the 64 columns of
    // half h of the block's 128 of K, from words (t, 2h) and (t, 2h + 1),
    // t = 0..3 (8 bytes at word 4t + 2h; the words box is 64-byte swizzled:
    // 16-byte chunk t of row r sits at chunk t ^ (r / 2 % 4)), times
    // bf16(scale), K contiguous: MN-major B ----
    const int tid = (threadIdx.x - kConsumers) % 128, lane = tid & 31;
    const int p = (threadIdx.x - kConsumers) / 128;
    const int row = tid % kDxRows, h = tid / kDxRows;
    const uint32_t row_off = h * (kDxRows * 128) + row * 128, swz = row & 7;
    const int qswz = (row >> 1) & 3;
    for (int st = p; st < n_stages; st += 2) {
      const int s = st % kDxStages;
      hp::mbar_wait(loaded + 8 * s, (st / kDxStages) & 1);
      const uint8_t* words = ring + kDxOffQ + s * kDxStageQ + row * 64 + 8 * h;
      uint2 w[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        w[t] = *reinterpret_cast<const uint2*>(words + ((t ^ qswz) << 4));
      }
      const __nv_bfloat162 s2 = __bfloat162bfloat162(__float2bfloat16_rn(
          reinterpret_cast<const float*>(ring + kDxOffS + s * kDxStageS)[row]));
      const uint32_t dst = base + kDxOffW + s * kDxStageW + row_off;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          uint32_t v[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const uint32_t code =
                dequant_pair(jj == 0 ? w[t].x : w[t].y, 4 * qq);
            const __nv_bfloat162 prod =
                __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&code), s2);
            v[t] = *reinterpret_cast<const uint32_t*>(&prod);
          }
          const int cc = 4 * jj + qq;        // 8-element chunk of this half
          hp::st_shared_v4(dst + ((cc ^ swz) << 4), v[0], v[1], v[2], v[3]);
        }
      }
      hp::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(full + 8 * s);
    }
    return;
  }

  // ---- consumers: 64 rows of dy each; B is MN-major (K contiguous) ----
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int st = 0; st < n_stages; ++st) {
    const int s = st % kDxStages;
    hp::mbar_wait(loaded + 8 * s, (st / kDxStages) & 1);
    hp::mbar_wait(full + 8 * s, (st / kDxStages) & 1);
    const uint32_t ya = base + s * kDxStageY + wg * (64 * 128);
    const uint32_t wb = base + kDxOffW + s * kDxStageW;
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      hp::wgmma_m64n128k16<1>(
          acc, hp::sw128_desc(ya + ks * 32, 16, 1024),
          hp::sw128_desc(wb + ks * 16 * 128, kDxRows * 128, 1024), 1);
    }
    hp::wgmma_commit();
    hp::fence_regs(acc);
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    if (lane == 0) hp::mbar_arrive(empty + 8 * s);
  }
  const int r = m0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = k0 + 8 * j + 2 * (lane & 3);
    if (r < M) {
      *reinterpret_cast<uint32_t*>(dx + static_cast<long>(r) * K + col) =
          lvr::pack_f32(acc[4 * j], acc[4 * j + 1]);
    }
    if (r + 8 < M) {
      *reinterpret_cast<uint32_t*>(dx + static_cast<long>(r + 8) * K + col) =
          lvr::pack_f32(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---- M <= 16: the decode body ----------------------------------------------
// A stage: the channels' words [128, 32] (two k-tiles; 128-byte rows,
// 128-byte swizzled for the 16-byte loads), x's M rows as four
// 128-byte-swizzled [M, 64] boxes (the rows of the stage's x tile past M keep
// stale bytes, which reach only output columns past M, never stored) and
// the scales of the tiles' groups [2, 128]. Channels past N read as zero
// words and are never stored; so does the second tile of a stage past K.
constexpr int kDecBN = 128;             // output channels a block
constexpr int kDecConsumers = 256;      // eight warps of 16 channels
constexpr int kDecThreads = kDecConsumers + 32;   // + the copy warp
constexpr int kDecTiles = 2;            // k-tiles a stage
// two forms: two blocks an SM with a ring of four stages, or three with a
// ring of two, for a grid that would leave SMs idle with two
constexpr int dec_stages(int blocks) { return blocks == 2 ? 4 : 2; }
constexpr int kMaxSplit = 8;            // the portable cluster size

// MT 1: x rows 0..7 (one n8 product a k step), 2: rows 0..15; BLOCKS: blocks
// an SM
template <int MT, int BLOCKS>
struct DecodeLayout {
  static constexpr int kStages = dec_stages(BLOCKS);
  static constexpr int kRows = 8 * MT;
  static constexpr int kHalf = kRows * 128;        // a [rows, 64] bf16 tile
  static constexpr int kStageX = 2 * kDecTiles * kHalf;
  static constexpr int kStageQ = kDecBN * kDecTiles * kWordsPerTile * 4;
  // a stage's tiles meet at most kDecTiles scale groups
  static constexpr int kStageS = kDecTiles * kDecBN * 4;
  static constexpr int kOffQ = kStages * kStageX;
  static constexpr int kOffS = kOffQ + kStages * kStageQ;
  static constexpr int kRing = kOffS + kStages * kStageS;
  // after the loop, the block's partial [rows][channels] fp32 over the ring,
  // rows padded by 4 floats so that a warp's stores of one accumulator
  // register meet no bank twice
  static constexpr int kRedStride = kDecBN + 4;
  // the cluster's partials of the outputs this block sums, float4 units:
  // [splits][per], per = ceil(rows x 32 / splits) units; other blocks write
  // them while this one may still be in its loop, so they have room of
  // their own
  static constexpr int kOffSlots = kRing;
  static constexpr int kSlots = kRows * (kDecBN / 4) + kMaxSplit;
  static constexpr int kOffBar = kOffSlots + kSlots * 16;
  static constexpr int kSmem = kOffBar + 2 * kStages * 8 + 1024;
  static_assert(kHalf % 1024 == 0, "a swizzled tile starts on 1024 bytes");
  static_assert(kRows * kRedStride * 4 <= kRing, "the partial fits the ring");
};

// grid (splits, channel tiles), clusters of (splits, 1, 1): block r of a
// cluster walks k-tiles [r * chunk, min(k_tiles, (r + 1) * chunk)) of
// channel tile blockIdx.y; kDecTiles divides chunk, so every stage but the
// last one of the grid holds kDecTiles of the block's tiles
template <int MT, int BLOCKS>
__global__ void __launch_bounds__(kDecThreads, BLOCKS)
    int4_decode_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap s_map,
                       bf16* __restrict__ out, int M, int N, int chunk,
                       int k_tiles, int tiles_per_group) {
  using L = DecodeLayout<MT, BLOCKS>;
  constexpr int kDecStages = L::kStages;
  extern __shared__ uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const uint32_t base = ring_base(smem);
  uint8_t* ring = smem + (base - hp::smem_u32(smem));
  const uint32_t full = base + L::kOffBar, empty = full + kDecStages * 8;
  float* red = reinterpret_cast<float*>(ring);
  float4* slots = reinterpret_cast<float4*>(ring + L::kOffSlots);
  const int n0 = blockIdx.y * kDecBN;
  const int kt0 = split * chunk, kt1 = min(k_tiles, kt0 + chunk);
  const int stages = (kt1 - kt0 + kDecTiles - 1) / kDecTiles;
  if (threadIdx.x == kDecConsumers) {
    hp::prefetch_tensormap(&q_map);
    hp::prefetch_tensormap(&x_map);
    hp::prefetch_tensormap(&s_map);
  }
  if (threadIdx.x == 0) {
    // the next launch may take this block's place as soon as it leaves
    hp::griddep_launch_dependents();
    for (int s = 0; s < kDecStages; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, kDecConsumers / 32);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  // this block has started: the cluster's other blocks may write into its
  // shared memory once they have waited for every block's arrival
  hp::cluster_arrive_relaxed();

  if (threadIdx.x >= kDecConsumers) {
    // ---- copy warp: the words, x and the scales of two k-tiles a stage ----
    if (threadIdx.x == kDecConsumers) {
      // the first stage's words and scales at once, while the launch before
      // this one may still run (programmatic dependent launch): they do not
      // depend on it; x only after it has finished
      const uint32_t bytes =
          L::kStageQ + 2 * kDecTiles * M * 128 + L::kStageS;
      hp::mbar_arrive_expect_tx(full, bytes);
      hp::tma_load_2d(base + L::kOffQ, &q_map, full, kt0 * kWordsPerTile, n0);
      hp::tma_load_2d(base + L::kOffS, &s_map, full, n0,
                      kt0 / tiles_per_group);
      hp::griddep_wait();
      for (int i = 0; i < stages; ++i) {
        const int s = i % kDecStages, kt = kt0 + kDecTiles * i;
        const uint32_t bar = full + 8 * s, xs = base + s * L::kStageX;
        hp::mbar_wait(empty + 8 * s, ((i / kDecStages) & 1) ^ 1);
        // one stage in flight ahead of the landed ones: the stages of a
        // block land one after another, so its products overlap the rest of
        // its copies (all at once, every stage of every block landed near
        // the end and the products ran after it)
        if (i > 0) {
          hp::mbar_wait(full + 8 * ((i - 1) % kDecStages),
                        ((i - 1) / kDecStages) & 1);
          hp::mbar_arrive_expect_tx(bar, bytes);
          hp::tma_load_2d(base + L::kOffQ + s * L::kStageQ, &q_map, bar,
                          kt * kWordsPerTile, n0);
          hp::tma_load_2d(base + L::kOffS + s * L::kStageS, &s_map, bar, n0,
                          kt / tiles_per_group);
        }
#pragma unroll
        for (int h = 0; h < 2 * kDecTiles; ++h) {
          hp::tma_load_2d(xs + h * L::kHalf, &x_map, bar, kt * kTile + 64 * h,
                          0);
        }
      }
    }
    __syncwarp();
  } else {
    // ---- eight warps: warp w owns channels 16w..16w+15. A lane's A
    // fragment of k step ks is its channels' words (t, ks / 2) at shifts
    // 8(ks % 2) and + 4 turned into bf16, as in the wgmma body; B (x rows
    // 8j..8j+7 of k step ks) comes from `ldmatrix.x4` of four 16-byte chunks
    // of the swizzled tile, two k steps a load. `part` sums a scale group's
    // products; at the group's last tile, or the block's,
    // acc += part * scale ----
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int ch = (threadIdx.x >> 5) * 16 + g;   // a[0]'s channel (a[1]: + 8)
    const int xr = lane & 7, xc = lane >> 3;      // ldmatrix row, chunk
    float part[4 * MT], acc[4 * MT];
#pragma unroll
    for (int i = 0; i < 4 * MT; ++i) part[i] = acc[i] = 0.f;
    // the tiles left in the current scale group, counted down (no division
    // in the loop); a lane's word offsets in a stage, and its ldmatrix
    // offsets in a [rows, 64] tile of x (chunk c of row r at (c ^ r) << 4)
    int left = tiles_per_group - kt0 % tiles_per_group;
    uint32_t magic;   // set by asm, so that no pass folds it into an immediate
    asm volatile("mov.b32 %0, 0x43004300;\n" : "=r"(magic));
    const int wo0 = ch * (64 * kDecTiles) + ((t ^ g) << 4);
    const int wo1 = ch * (64 * kDecTiles) + (((4 + t) ^ g) << 4);
    const uint32_t xo0 = xr * 128 + ((xc ^ xr) << 4);
    const uint32_t xo1 = xr * 128 + (((4 + xc) ^ xr) << 4);
    for (int i = 0; i < stages; ++i) {
      const int s = i % kDecStages;
      hp::mbar_wait(full + 8 * s, (i / kDecStages) & 1);
      const uint8_t* words = ring + L::kOffQ + s * L::kStageQ;
      const float* sg =
          reinterpret_cast<const float*>(ring + L::kOffS + s * L::kStageS);
      const uint32_t xs0 = base + s * L::kStageX;
      const int n_t = kt1 - kt0 - kDecTiles * i;   // the block's tiles left
#pragma unroll
      for (int tt = 0; tt < kDecTiles; ++tt) {
        if (tt >= n_t) break;
        const int wo = tt == 0 ? wo0 : wo1;
        const uint4 wa = *reinterpret_cast<const uint4*>(words + wo);
        const uint4 wb = *reinterpret_cast<const uint4*>(
            words + wo + 8 * (64 * kDecTiles));
        // b[j][p]: k steps 2p (regs 0, 1) and 2p + 1 (2, 3), x rows 8j..
        uint32_t b[MT][4][4];
        const uint32_t xs = xs0 + 2 * tt * L::kHalf;
#pragma unroll
        for (int j = 0; j < MT; ++j) {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            hp::ldmatrix_x4(b[j][p], xs + (p >> 1) * L::kHalf + j * 1024 +
                                         ((p & 1) ? xo1 : xo0));
          }
        }
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const int sh = (ks & 1) * 8;
          const uint32_t ua = word_of(wa, ks >> 1), ub = word_of(wb, ks >> 1);
          const uint32_t a[4] = {dequant_pair_reg(ua, sh, magic),
                                 dequant_pair_reg(ub, sh, magic),
                                 dequant_pair_reg(ua, sh + 4, magic),
                                 dequant_pair_reg(ub, sh + 4, magic)};
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            mma_16816(part + 4 * j, a, b[j][ks >> 1][2 * (ks & 1)],
                      b[j][ks >> 1][2 * (ks & 1) + 1]);
          }
        }
        if (--left == 0 || tt + 1 == n_t) {
          const float sa = sg[ch], sb = sg[ch + 8];
#pragma unroll
          for (int j = 0; j < MT; ++j) {
            acc[4 * j] += part[4 * j] * sa;
            acc[4 * j + 1] += part[4 * j + 1] * sa;
            acc[4 * j + 2] += part[4 * j + 2] * sb;
            acc[4 * j + 3] += part[4 * j + 3] * sb;
          }
#pragma unroll
          for (int e = 0; e < 4 * MT; ++e) part[e] = 0.f;
          if (left == 0) {
            left = tiles_per_group;
            sg += kDecBN;
          }
        }
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + 8 * s);
    }
    // every warp is past the ring: its partial goes over it.
    // acc[4j + 2h + e] is the partial of out[8j + 2t + e][n0 + ch + 8h]
    hp::bar_sync(1, kDecConsumers);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      float* r0 = red + (8 * j + 2 * t) * L::kRedStride + ch;
      r0[0] = acc[4 * j];
      r0[L::kRedStride] = acc[4 * j + 1];
      r0[8] = acc[4 * j + 2];
      r0[L::kRedStride + 8] = acc[4 * j + 3];
    }
  }

  // block r sums the cluster's partials of outputs [r * per, (r + 1) * per)
  // of the tile, in float4 units of 4 channels of a row: every block stores
  // its partial of each unit into the owner's slot for its rank (distributed
  // shared memory), and after one cluster barrier the owner adds its slots
  // in rank order, so a repeat gives the same bits. No block reads another's
  // shared memory after the barrier, so none waits for the others to leave.
  // The first wait is for every block of the cluster to have started (its
  // arrival at the top): only then may its shared memory be written.
  __syncthreads();
  hp::cluster_wait();
  const int units = M * (kDecBN / 4);
  const int per = (units + splits - 1) / splits;
  for (int u = threadIdx.x; u < units; u += kDecThreads) {
    const int row = u / (kDecBN / 4), col = u % (kDecBN / 4) * 4;
    if (n0 + col >= N) continue;       // N % 8 == 0: 4 channels in or out
    const int owner = u / per;
    cluster.map_shared_rank(slots, owner)[split * per + u - owner * per] =
        *reinterpret_cast<const float4*>(red + row * L::kRedStride + col);
  }
  cluster.sync();
  const int stop = min(units, (split + 1) * per);
  for (int u = split * per + threadIdx.x; u < stop; u += kDecThreads) {
    const int row = u / (kDecBN / 4), col = u % (kDecBN / 4) * 4;
    if (n0 + col >= N) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < splits; ++r) {
      const float4 v = slots[r * per + u - split * per];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    *reinterpret_cast<uint2*>(out + static_cast<long>(row) * N + n0 + col) =
        make_uint2(lvr::pack_f32(sum.x, sum.y), lvr::pack_f32(sum.z, sum.w));
  }
}

// the packed words [N, K / 8] int32 in boxes of `tiles` stored tiles (16
// words each) of `rows` rows
int word_map(CUtensorMap* map, const void* q, int N, int K, int rows,
             int tiles, CUtensorMapSwizzle swizzle) {
  return lvr::hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, q, N,
                               K / 8, rows, tiles * kWordsPerTile, swizzle);
}

// the scales [groups, N] fp32 in boxes of `rows` groups' `cols` channels
int scale_map(CUtensorMap* map, const void* scale, int groups, int N,
              int cols, int rows = 1) {
  return lvr::hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scale,
                               groups, N, rows, cols,
                               CU_TENSOR_MAP_SWIZZLE_NONE);
}

// the SMs of the current device: the persistent forward launches one block
// an SM, the decode body splits K to fill them
int sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  return static_cast<int>(err);
}

bool shapes_ok(int M, int K, int N, int groups) {
  return M > 0 && K > 0 && N > 0 && groups > 0 && K % kTile == 0 &&
         K % groups == 0 && (K / groups) % kTile == 0 && N % 8 == 0;
}

// Dynamic shared memory above 48 KB is opt-in, on the current device: set at
// every launch (the attribute is per device, and the call is cheap). As a
// launch's first CUDA runtime call it also makes the device's context
// current on the calling thread, which the tensor-map encodes (a driver
// call) need: on the autograd engine's thread, where the backward's launch
// can be the first CUDA call, the encode of dy's map failed (invalid value)
// while this was skipped after a first launch elsewhere.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// the split the last M <= 16 launch took (0 before the first)
std::atomic<int> last_decode_split{0};

constexpr int kMaxDevices = 16;

// the clusters of `splits` decode blocks that fit on device `dev` at once,
// asked of the occupancy calculator once a (device, form, splits) and kept
template <int MT, int BLOCKS>
int fitting_clusters(int dev, int splits, int* clusters) {
  static std::atomic<int> known[kMaxDevices][kMaxSplit + 1];  // 0: not yet
  if (dev < kMaxDevices) {
    *clusters = known[dev][splits].load(std::memory_order_relaxed);
    if (*clusters > 0) return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = DecodeLayout<MT, BLOCKS>::kSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      clusters, int4_decode_kernel<MT, BLOCKS>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && *clusters > 0) {
    known[dev][splits].store(*clusters, std::memory_order_relaxed);
  }
  return 0;
}

// The blocks a channel tile's k-tiles are split over (one cluster) in the
// form with BLOCKS blocks an SM, from N, K and the device alone: the launch
// reads nothing back from the card and can be captured in a CUDA graph. The
// grid aims at BLOCKS blocks an SM, at most kMaxSplit a tile and a stage a
// block, cut to what the occupancy calculator says fits at once: a cluster
// of 8 needs 8 free blocks in one GPC, and a second wave of clusters cost a
// block's whole time (PERF.md, section 6). Returns a cudaError_t value.
template <int MT, int BLOCKS>
int decode_split(int n_tiles, int k_tiles, int sms, int dev, int* splits) {
  const int err = allow_smem(int4_decode_kernel<MT, BLOCKS>,
                             DecodeLayout<MT, BLOCKS>::kSmem);
  if (err != 0) return err;
  const int want = (BLOCKS * sms + n_tiles / 2) / n_tiles;
  *splits = std::max(1, std::min({want, (k_tiles + kDecTiles - 1) / kDecTiles,
                                  kMaxSplit}));
  while (*splits > 1) {
    int clusters = 0;
    const int e = fitting_clusters<MT, BLOCKS>(dev, *splits, &clusters);
    if (e != 0) return e;
    if (n_tiles <= clusters) break;
    --*splits;
  }
  return 0;
}

template <int MT, int BLOCKS>
int launch_decode_form(const CUtensorMap& x_map, const CUtensorMap& q_map,
                       const CUtensorMap& s_map, bf16* out, int M, int K,
                       int N, int groups, int splits, cudaStream_t stream) {
  const int k_tiles = K / kTile, n_tiles = (N + kDecBN - 1) / kDecBN;
  // whole stages a block
  const int chunk = ((k_tiles + splits - 1) / splits + kDecTiles - 1) /
                    kDecTiles * kDecTiles;
  splits = (k_tiles + chunk - 1) / chunk;
  last_decode_split.store(splits, std::memory_order_relaxed);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, n_tiles);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = DecodeLayout<MT, BLOCKS>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // programmatic dependent launch: the blocks of this grid may start while
  // the grid before it on the stream ends; they read x and write out only
  // after `griddep_wait`
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t res = cudaLaunchKernelEx(
      &cfg, int4_decode_kernel<MT, BLOCKS>, x_map, q_map, s_map, out, M, N,
      chunk, k_tiles, K / groups / kTile);
  if (res != cudaSuccess) return static_cast<int>(res);
  return static_cast<int>(cudaGetLastError());
}

// The form with two blocks an SM and a ring of four, unless its grid fills
// fewer than three quarters of the card's two-an-SM places and three an SM
// (a ring of two) give more blocks: 4096 -> 11008 (86 channel tiles) takes 2
// splits, 172 blocks, with two an SM (3 did not fit at once) and 4, 344,
// with three, and ran faster so; where two an SM fill the card the deeper
// ring ran faster (PERF.md, section 6).
template <int MT>
int launch_decode(const void* x, const void* q, const void* scale, bf16* out,
                  int M, int K, int N, int groups, cudaStream_t stream) {
  int sms = 0, dev = 0;
  int err = sm_count(&sms);
  if (err == 0) err = static_cast<int>(cudaGetDevice(&dev));
  const int k_tiles = K / kTile, n_tiles = (N + kDecBN - 1) / kDecBN;
  int two = 1, three = 1;
  if (err == 0) err = decode_split<MT, 2>(n_tiles, k_tiles, sms, dev, &two);
  const bool idle = 2 * two * n_tiles < 3 * sms;
  if (err == 0 && idle) {
    err = decode_split<MT, 3>(n_tiles, k_tiles, sms, dev, &three);
  }
  CUtensorMap x_map, q_map, s_map;
  if (err == 0) err = lvr::hopper::make_bf16_map(&x_map, x, M, K, M);
  if (err == 0) {
    err = word_map(&q_map, q, N, K, kDecBN, kDecTiles,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == 0) err = scale_map(&s_map, scale, groups, N, kDecBN, kDecTiles);
  if (err != 0) return err;
  if (idle && three > two) {
    return launch_decode_form<MT, 3>(x_map, q_map, s_map, out, M, K, N,
                                     groups, three, stream);
  }
  return launch_decode_form<MT, 2>(x_map, q_map, s_map, out, M, K, N, groups,
                                   two, stream);
}

}  // namespace

// x bf16 [M, K], q int32 [N, K / 8], scale fp32 [groups, N], out bf16 [M, N].
// K % 128 == 0, (K / groups) % 128 == 0, N % 8 == 0.
extern "C" int lvr_int4_matmul(const void* x, const void* q, const void* scale,
                               void* out, int M, int K, int N, int groups,
                               void* stream) {
  if (!shapes_ok(M, K, N, groups)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_per_group = K / groups / kTile;
  auto* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) {
    return M <= 8 ? launch_decode<1>(x, q, scale, op, M, K, N, groups, s)
                  : launch_decode<2>(x, q, scale, op, M, K, N, groups, s);
  }
  int err = allow_smem(int4_wgmma_kernel, kSmem);
  CUtensorMap x_map, q_map, s_map;
  if (err == 0) err = lvr::hopper::make_bf16_map(&x_map, x, M, K, kBM);
  if (err == 0) {
    err = word_map(&q_map, q, N, K, kBN, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err == 0) err = scale_map(&s_map, scale, groups, N, kBN);
  if (err != 0) return err;
  int sms = 0;
  if (err == 0) err = sm_count(&sms);
  if (err != 0) return err;
  const int tiles = (N + kBN - 1) / kBN * ((M + kBM - 1) / kBM);
  int4_wgmma_kernel<<<tiles < sms ? tiles : sms, kThreadsMm, kSmem, s>>>(
      x_map, q_map, s_map, op, M, K, N, tiles_per_group);
  return static_cast<int>(cudaGetLastError());
}

// dx = dy @ W: dy bf16 [M, N], q int32 [N, K / 8], scale fp32 [groups, N],
// dx bf16 [M, K], W[n, k] = bf16(code * bf16(scale)). Same shape rules.
// the splits of the contraction (blocks of a cluster) the last launch of
// lvr_int4_matmul at M <= 16 took (0 before the first)
extern "C" int lvr_int4_matmul_small_split(void) {
  return last_decode_split.load(std::memory_order_relaxed);
}

extern "C" int lvr_int4_matmul_dx(const void* dy, const void* q,
                                  const void* scale, void* dx, int M, int K,
                                  int N, int groups, void* stream) {
  if (!shapes_ok(M, K, N, groups)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = allow_smem(int4_wgmma_dx_kernel, kDxSmem);
  CUtensorMap dy_map, q_map, s_map;
  if (err == 0) err = lvr::hopper::make_bf16_map(&dy_map, dy, M, N, kBM);
  // 64-byte swizzled for the producers' 8-byte reads
  if (err == 0) {
    err = word_map(&q_map, q, N, K, kDxRows, 1, CU_TENSOR_MAP_SWIZZLE_64B);
  }
  if (err == 0) err = scale_map(&s_map, scale, groups, N, kDxRows);
  if (err != 0) return err;
  const dim3 grid(K / kBN, (M + kBM - 1) / kBM);
  int4_wgmma_dx_kernel<<<grid, kThreadsDx, kDxSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      dy_map, q_map, s_map, static_cast<bf16*>(dx), M, K, N, K / groups);
  return static_cast<int>(cudaGetLastError());
}

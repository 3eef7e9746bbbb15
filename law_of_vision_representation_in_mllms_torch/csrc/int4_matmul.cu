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
// which is B register `half` of mma step 2j + sl in the m16n8k16 fragment
// layout (attention_common.cuh). So one 16-byte load a lane feeds the eight
// mma steps of a tile and the activations keep their natural order. Put
// otherwise: word (t, j) >> 4q gives the pair k = 32j + 8q + 2t + {0, 1}, so
// the four words (t = 0..3, j) fill the four 8-element chunks 4j + q, q =
// 0..3, of a tile in natural order: that is how the transposed form writes
// the weight into shared memory.
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
// Small body (M <= 16): a block owns 16 output channels; its eight warps take
// every eighth k-tile, the next tile's words are loaded before the current
// one is used, activations come from global memory through L1 (x is a few
// tens of KB), and the eight partial accumulators meet in shared memory in a
// fixed order (no atomics: two runs give the same bits).
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
//   8(s % 2) and 8(s % 2) + 4, the stored order (`int4_small_kernel` reads
//   it the same way as B), so one 16-byte shared load a channel gives a
//   stage's fragments with no reordering; x is B, K-major in shared memory;
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
#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

using lvr::bf16;
using lvr::ld32;
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

__device__ __forceinline__ uint32_t word_of(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

__device__ __forceinline__ uint4 load_words(const uint32_t* q, long row,
                                            int words_per_row, int kt, int t,
                                            bool ok) {
  if (!ok) return make_uint4(0x88888888u, 0x88888888u, 0x88888888u,
                             0x88888888u);  // code 0 everywhere
  return __ldg(reinterpret_cast<const uint4*>(
      q + row * words_per_row + kt * kWordsPerTile + t * 4));
}

// ---- M <= 16 ---------------------------------------------------------------
constexpr int kSmallN = 16;      // output channels a block owns
constexpr int kSmallWarps = 8;

template <int MT>  // 1: rows 0..7 only, 2: rows 0..15
__global__ void __launch_bounds__(kSmallWarps * 32)
    int4_small_kernel(const bf16* __restrict__ x,
                      const uint32_t* __restrict__ q,
                      const float* __restrict__ scale, bf16* __restrict__ out,
                      int M, int K, int N, int tiles_per_group) {
  __shared__ float red[kSmallWarps][MT * 8][kSmallN];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kSmallN;
  const int k_tiles = K / kTile;
  const int wpr = K / 8;
  const bool ok0 = n0 + g < N;          // this lane's channel of n-tile 0
  const bool ok1 = n0 + 8 + g < N;      // and of n-tile 1
  const bool row_a = g < M;
  const bool row_b = MT == 2 && g + 8 < M;
  const bf16* xa = x + static_cast<long>(g) * K + 2 * t;
  const bf16* xb = xa + 8l * K;

  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  uint4 nw0 = make_uint4(0, 0, 0, 0), nw1 = nw0;
  if (warp < k_tiles) {
    nw0 = load_words(q, n0 + g, wpr, warp, t, ok0);
    nw1 = load_words(q, n0 + 8 + g, wpr, warp, t, ok1);
  }
  for (int kt = warp; kt < k_tiles; kt += kSmallWarps) {
    const uint4 w0 = nw0, w1 = nw1;
    if (kt + kSmallWarps < k_tiles) {
      nw0 = load_words(q, n0 + g, wpr, kt + kSmallWarps, t, ok0);
      nw1 = load_words(q, n0 + 8 + g, wpr, kt + kSmallWarps, t, ok1);
    }
    float c[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    const int k0 = kt * kTile;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      uint32_t a[4];
      a[0] = row_a ? ld32(xa + k0 + 16 * s) : 0u;
      a[2] = row_a ? ld32(xa + k0 + 16 * s + 8) : 0u;
      a[1] = row_b ? ld32(xb + k0 + 16 * s) : 0u;
      a[3] = row_b ? ld32(xb + k0 + 16 * s + 8) : 0u;
      const int sh = (s & 1) * 8;
      const uint32_t u0 = word_of(w0, s >> 1);
      const uint32_t u1 = word_of(w1, s >> 1);
      mma_16816(c[0], a, dequant_pair(u0, sh), dequant_pair(u0, sh + 4));
      mma_16816(c[1], a, dequant_pair(u1, sh), dequant_pair(u1, sh + 4));
    }
    const float* sc = scale + static_cast<long>(kt / tiles_per_group) * N;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      float2 s2 = make_float2(0.f, 0.f);
      if (col < N) s2 = *reinterpret_cast<const float2*>(sc + col);
      acc[j][0] += c[j][0] * s2.x;
      acc[j][1] += c[j][1] * s2.y;
      acc[j][2] += c[j][2] * s2.x;
      acc[j][3] += c[j][3] * s2.y;
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    red[warp][g][j * 8 + 2 * t] = acc[j][0];
    red[warp][g][j * 8 + 2 * t + 1] = acc[j][1];
    if (MT == 2) {
      red[warp][g + 8][j * 8 + 2 * t] = acc[j][2];
      red[warp][g + 8][j * 8 + 2 * t + 1] = acc[j][3];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < MT * 8 * kSmallN; idx += kSmallWarps * 32) {
    const int r = idx / kSmallN;
    const int col = idx % kSmallN;
    if (r >= M || n0 + col >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kSmallWarps; ++w) sum += red[w][r][col];
    out[static_cast<long>(r) * N + n0 + col] = __float2bfloat16_rn(sum);
  }
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
  // s = 2j + (0, 1) (`int4_small_kernel` does the same for B). ----
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

// the packed words [N, K / 8] int32 in boxes of one stored tile (16 words)
// of `rows` rows; 64-byte swizzled for the transposed form's 8-byte reads
int word_map(CUtensorMap* map, const void* q, int N, int K, int rows) {
  return lvr::hopper::make_map(
      map, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, q, N, K / 8, rows, kWordsPerTile,
      rows == kDxRows ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// the scales [groups, N] fp32 in boxes of one group's `cols` channels
int scale_map(CUtensorMap* map, const void* scale, int groups, int N,
              int cols) {
  return lvr::hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scale,
                               groups, N, 1, cols, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// the persistent forward launches one block an SM of the current device
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
  const auto* xp = static_cast<const bf16*>(x);
  const auto* qp = static_cast<const uint32_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) {
    const dim3 grid((N + kSmallN - 1) / kSmallN);
    if (M <= 8) {
      int4_small_kernel<1><<<grid, kSmallWarps * 32, 0, s>>>(
          xp, qp, sp, op, M, K, N, tiles_per_group);
    } else {
      int4_small_kernel<2><<<grid, kSmallWarps * 32, 0, s>>>(
          xp, qp, sp, op, M, K, N, tiles_per_group);
    }
    return static_cast<int>(cudaGetLastError());
  }
  int err = allow_smem(int4_wgmma_kernel, kSmem);
  CUtensorMap x_map, q_map, s_map;
  if (err == 0) err = lvr::hopper::make_bf16_map(&x_map, x, M, K, kBM);
  if (err == 0) err = word_map(&q_map, q, N, K, kBN);
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
extern "C" int lvr_int4_matmul_dx(const void* dy, const void* q,
                                  const void* scale, void* dx, int M, int K,
                                  int N, int groups, void* stream) {
  if (!shapes_ok(M, K, N, groups)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = allow_smem(int4_wgmma_dx_kernel, kDxSmem);
  CUtensorMap dy_map, q_map, s_map;
  if (err == 0) err = lvr::hopper::make_bf16_map(&dy_map, dy, M, N, kBM);
  if (err == 0) err = word_map(&q_map, q, N, K, kDxRows);
  if (err == 0) err = scale_map(&s_map, scale, groups, N, kDxRows);
  if (err != 0) return err;
  const dim3 grid(K / kBN, (M + kBM - 1) / kBM);
  int4_wgmma_dx_kernel<<<grid, kThreadsDx, kDxSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      dy_map, q_map, s_map, static_cast<bf16*>(dx), M, K, N, K / groups);
  return static_cast<int>(cudaGetLastError());
}

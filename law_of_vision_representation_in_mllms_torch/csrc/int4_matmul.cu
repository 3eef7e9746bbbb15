// Kernel 10: W4A16 grouped matmul, out[M, N] = x[M, K] @ dequant(q, scale)^T.
//
// Replaces the TPU kernel `ops/int4_kernel.py` `int4_matmul_kernel` (`_kernel`).
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
// mma steps of a tile and the activations keep their natural order.
//
// Nibble -> bf16 without a convert: 0x4300 | u is the bf16 number 128 + u
// (u < 128 fits the mantissa), and (128 + u) - 136 = u - 8 is exact.
//
// Bound on the H100: M <= 16 reads each packed byte once for ~4M FLOP, so
// HBM bandwidth is the floor (K = N = 4096: 8.4 MB, ~2.6 us); M in the
// thousands is bound by the tensor cores. Arithmetic: products of bf16
// activations and exact integer codes, fp32 sums over a 128-element tile,
// the tile's sum times its fp32 scale added to an fp32 accumulator.
//
// Small body (M <= 16): a block owns 16 output channels; its eight warps take
// every eighth k-tile, the next tile's words are loaded before the current
// one is used, activations come from global memory through L1 (x is a few
// tens of KB), and the eight partial accumulators meet in shared memory in a
// fixed order (no atomics: two runs give the same bits).
// Large body: a block owns 128 rows x 64 channels, warps 2 x 4, a warp 64 x
// 16; the x tile [128, 128] is staged in shared memory, the words go from
// HBM straight to registers. It reaches ~20 % of the bf16 peak and is bound by
// the instruction rate (about five shifts, logic ops, subtractions and shared
// loads beside every mma), not by memory: a 32 x 64 warp tile with the x
// tile, the words and the scales all in two cp.async stages, at one and at
// two blocks an SM, ran at the same ~200 TFLOP/s, so the simplest body stays.
#include "attention_common.cuh"

namespace {

using lvr::bf16;
using lvr::ld32;
using lvr::mma_16816;

constexpr int kTile = 128;       // contraction elements per k-tile
constexpr int kWordsPerTile = 16;
constexpr int kThreadsMm = 256;

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

// ---- M > 16 ----------------------------------------------------------------
constexpr int kBigM = 128;
constexpr int kBigN = 64;
constexpr int kBigLd = kTile + 8;   // shared-memory row pitch of the x tile

__global__ void __launch_bounds__(kThreadsMm, 2)
    int4_big_kernel(const bf16* __restrict__ x, const uint32_t* __restrict__ q,
                    const float* __restrict__ scale, bf16* __restrict__ out,
                    int M, int K, int N, int tiles_per_group) {
  __shared__ __align__(16) bf16 s_x[kBigM * kBigLd];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;            // 0..1: 64 rows each
  const int wn = warp & 3;             // 0..3: 16 channels each
  const int m0 = blockIdx.y * kBigM;
  const int n0 = blockIdx.x * kBigN + wn * 16;
  const int k_tiles = K / kTile;
  const int wpr = K / 8;
  const bool ok0 = n0 + g < N;
  const bool ok1 = n0 + 8 + g < N;

  float acc[4][2][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const uint4 w0 = load_words(q, n0 + g, wpr, kt, t, ok0);
    const uint4 w1 = load_words(q, n0 + 8 + g, wpr, kt, t, ok1);
    __syncthreads();  // every warp is done with the previous x tile
    lvr::load_tile<kTile, kBigM, kThreadsMm>(s_x, x + kt * kTile, K, m0, M);
    __syncthreads();

    float c[4][2][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        c[mi][j][0] = c[mi][j][1] = c[mi][j][2] = c[mi][j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int sh = (s & 1) * 8;
      const uint32_t u0 = word_of(w0, s >> 1);
      const uint32_t u1 = word_of(w1, s >> 1);
      const uint32_t b00 = dequant_pair(u0, sh), b01 = dequant_pair(u0, sh + 4);
      const uint32_t b10 = dequant_pair(u1, sh), b11 = dequant_pair(u1, sh + 4);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const bf16* base = s_x + (wm * 64 + mi * 16 + g) * kBigLd + s * 16 + 2 * t;
        uint32_t a[4];
        a[0] = ld32(base);
        a[1] = ld32(base + 8 * kBigLd);
        a[2] = ld32(base + 8);
        a[3] = ld32(base + 8 * kBigLd + 8);
        mma_16816(c[mi][0], a, b00, b01);
        mma_16816(c[mi][1], a, b10, b11);
      }
    }
    const float* sc = scale + static_cast<long>(kt / tiles_per_group) * N;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      float2 s2 = make_float2(0.f, 0.f);
      if (col < N) s2 = *reinterpret_cast<const float2*>(sc + col);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        acc[mi][j][0] += c[mi][j][0] * s2.x;
        acc[mi][j][1] += c[mi][j][1] * s2.y;
        acc[mi][j][2] += c[mi][j][2] * s2.x;
        acc[mi][j][3] += c[mi][j][3] * s2.y;
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int ra = m0 + wm * 64 + mi * 16 + g;
    const int rb = ra + 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col >= N) continue;
      if (ra < M) {
        *reinterpret_cast<uint32_t*>(out + static_cast<long>(ra) * N + col) =
            lvr::pack_f32(acc[mi][j][0], acc[mi][j][1]);
      }
      if (rb < M) {
        *reinterpret_cast<uint32_t*>(out + static_cast<long>(rb) * N + col) =
            lvr::pack_f32(acc[mi][j][2], acc[mi][j][3]);
      }
    }
  }
}

}  // namespace

// x bf16 [M, K], q int32 [N, K / 8], scale fp32 [groups, N], out bf16 [M, N].
// K % 128 == 0, (K / groups) % 128 == 0, N % 8 == 0.
extern "C" int lvr_int4_matmul(const void* x, const void* q, const void* scale,
                               void* out, int M, int K, int N, int groups,
                               void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || groups <= 0 || K % kTile != 0 ||
      K % groups != 0 || (K / groups) % kTile != 0 || N % 8 != 0) {
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
  } else {
    const dim3 grid((N + kBigN - 1) / kBigN, (M + kBigM - 1) / kBigM);
    int4_big_kernel<<<grid, kThreadsMm, 0, s>>>(xp, qp, sp, op, M, K, N,
                                                tiles_per_group);
  }
  return static_cast<int>(cudaGetLastError());
}

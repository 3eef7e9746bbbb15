// The attention forward of kernels 1 and 2 on Hopper: TMA-fed wgmma in
// two warpgroups that take turns, FlashAttention-3 in shape.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s), per launch:
//   B4 S640 kv_len 600 H32 D128 causal (prefill): 81 MB of Q, K, V and O
//     (0.0243 ms) against 13.4 GFLOP (0.0135 ms): bytes;
//   B16 S639 H32 D128 causal (a stage-1 step, 64 launches): 335 MB
//     (0.100 ms) against 53.6 GFLOP (0.054 ms): bytes;
//   B2 S2048 H32 D128 causal (MPT-7B): 68.7 GFLOP (0.0695 ms) against
//     134 MB (0.040 ms): operations;
//   B4 S577 H16 D64 (the tower, kernel 1): 19 MB (0.0056 ms) against 5.5
//     GFLOP (0.0055 ms): both;
//   B4 S9216 H8 D40 (SD1.5's 96 x 96 self-attention, non-causal): 435
//     GFLOP (0.44 ms) against 47 MB: operations; its 77-key
//     cross-attention, 47 MB (0.014 ms): bytes.
// A block's work is a few tiles (2.5 on average at S = 640, causal), so
// what bounds the kernel is how much of its time the tensor cores are fed,
// its fill and drain included: loads overlap the math, both products run
// on wgmma, and the softmax of one warpgroup runs under the other's
// products.
//
// The design:
// - a block owns 64·NCONS query rows of one (batch, head): NCONS
//   warpgroups of 64 rows each, and no producer warpgroup. ptxas caps a
//   block of three warpgroups at 168 registers a thread, setmaxnreg or not,
//   and at D = 128 a warpgroup needs ~200 (O, S and P alone are 160), so
//   with a producer warpgroup the others spilled 264 bytes and ran 1.3-1.4x
//   slower;
// - one thread (lane 0 of the last warpgroup) loads Q once and keeps K and
//   V tiles of 128 keys in flight through a ring of two stages by TMA
//   (rank-4 maps over [B, S, heads, D], 128-byte swizzle; a tile past S
//   reads zeros of its own batch; the kv head h / (H / KV) is a coordinate),
//   each tile on its own full and empty mbarrier;
// - S = Q Kᵀ is one SS wgmma m64n128 chain (Q and K K-major); the fp32
//   accumulator, rounded to bf16, is already the register-A fragment of the
//   next product, so P never touches shared memory, and O += P V is one RS
//   wgmma chain with V as MN-major B (its stored [keys, D] layout);
// - online softmax in base 2 with fp32 m and l per row, reduced over the
//   quad; only the tiles on the causal diagonal and the kv_len tail take
//   the per-element mask (tiles are walked from the last one down, so they
//   come first);
// - within a warpgroup, S of tile i is issued together with P V of tile
//   i − 1, so the softmax of tile i runs while P V of i − 1 is on the
//   tensor cores; two warpgroups take turns to issue (named barriers), so
//   that one's softmax overlaps the other's products;
// - O leaves through shared memory (the warpgroup's rows of the Q tile) by
//   TMA stores: 9-10 % less time than each lane's own 4-byte stores at the
//   prefill and stage-1 shapes, where a block has few tiles;
// - no atomics: every output is one warpgroup's sum in a fixed order, so the
//   same inputs give the same bits.
// Blocks of 64 rows (one warpgroup) are launched where they give the SMs
// less to do (launch_flash_fwd). Tried and dropped (PERF.md, section 6): a
// persistent form that prefetched the next item's tiles (1.0-1.3x slower
// but at the prefill shape) and a third stage (no gain).
//
// Head sizes that are not a multiple of 64 (the UNet's 40, 80 and 160): the
// tile is Dp = D rounded up to 64 wide, and the tensor maps keep the true D,
// so TMA reads the columns past D of Q, K and V as zeros (which add nothing
// to Q Kᵀ or P V) and clips the O store at D. Q Kᵀ walks only ceil(D / 16)
// k16 steps; P V at Dp = 192 is an n128 and an n64 chain, in the accumulator
// layout of one n192. TMA needs the row strides 2·D and 2·H·D bytes to be
// multiples of 16: D = 40, 80, 160 (and 72) qualify. A Dp = 192 block holds
// one warpgroup (a second would need 433 KB of shared memory).
//
// Semantics (the plain versions in ops/flash_attention.py and
// ops/encoder_attention.py): key j is visible to query i iff j < kv_len and
// (not CAUSAL or j <= i), top-left aligned, Sq and Skv free; ALiBi adds
// slope·(j − (kv_len − 1)) in the form of `alibi_bias2` / `alibi_logit2`,
// the bias of a tile's first key of this lane formed once a tile; a row that
// sees no key gives O = 0 and LSE = 0.
#pragma once

#include <atomic>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace lvr {
namespace {

namespace hp = hopper;

constexpr int kFwdTileK = 128;         // keys a tile
constexpr int kFwdStages = 2;          // K and V tiles in flight

// the tile width of head size D: D rounded up to a multiple of 64
template <int D>
constexpr int padded_head_dim() {
  return (D + 63) / 64 * 64;
}

template <int D, int NCONS>
struct FwdShape {
  static constexpr int kDp = padded_head_dim<D>();
  static constexpr int kRows = 64 * NCONS;               // query rows a block
  static constexpr int kThreads = 128 * NCONS;
  static constexpr int kQBytes = kRows * kDp * 2;        // Dp / 64 boxes
  static constexpr int kTileBytes = kFwdTileK * kDp * 2; // a K or V stage
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kFwdStages * kTileBytes;
  static constexpr int kOffBar = kOffV + kFwdStages * kTileBytes;
  // q_full, then k_full, v_full, k_empty, v_empty a stage each; + alignment
  static constexpr int kSmem = kOffBar + (1 + 4 * kFwdStages) * 8 + 1024;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S[64 x 128] = Q Kᵀ. Q (this warpgroup's 64 rows of a box of ROWS rows) and
// the K tile are K-major, Dp / 64 boxes of 128-byte rows: a k16 step moves
// 32 bytes along a row, and every fourth starts the next box. Only the
// ceil(D / 16) steps that hold columns below D are taken (past D both
// operands are zeros).
template <int D, int ROWS>
__device__ __forceinline__ void qk_gemm(float (&s)[64], uint32_t q,
                                        uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < (D + 15) / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    hp::wgmma_m64n128k16<0>(
        s, hp::sw128_desc(q + (kk >> 2) * (ROWS * 128) + col, 16, 1024),
        hp::sw128_desc(k + (kk >> 2) * (kFwdTileK * 128) + col, 16, 1024),
        kk > 0);
  }
}

// O[64 x Dp] += P V. P from registers (pf[kk]: keys 16kk..16kk+15), V
// MN-major: keys are its rows, Dp / 64 boxes of 64 columns; a k16 step is 16
// rows (2 KB), LBO the next box. At Dp = 192 an n128 chain covers boxes 0-1
// and an n64 chain box 2, into o[64..95]: the registers one n192 would use.
template <int Dp>
__device__ __forceinline__ void pv_gemm(float (&o)[Dp / 2],
                                        const uint32_t (&pf)[8][4],
                                        uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kFwdTileK / 16; ++kk) {
    const uint64_t db =
        hp::sw128_desc(v + kk * 16 * 128, kFwdTileK * 128, 1024);
    if constexpr (Dp == 64) {
      hp::wgmma_m64n64k16_rs_t<1>(o, pf[kk], db, 1);
    } else {
      hp::wgmma_m64n128k16_rs_t<1>(
          *reinterpret_cast<float(*)[64]>(&o[0]), pf[kk], db, 1);
    }
    if constexpr (Dp == 192) {
      const uint64_t db2 = hp::sw128_desc(
          v + 2 * (kFwdTileK * 128) + kk * 16 * 128, kFwdTileK * 128, 1024);
      hp::wgmma_m64n64k16_rs_t<1>(*reinterpret_cast<float(*)[32]>(&o[64]),
                                  pf[kk], db2, 1);
    }
  }
}

// One tile's online softmax for this lane's rows row_a and row_a + 8: the
// mask where MASK, the new running max m (base 2), the factor alpha by which
// the old O and l shrink, P = 2^(x − m) in place of S, and l. Without ALiBi
// x = s·scale·log2 e is never formed: the max is taken over s (the scale is
// positive) and P = 2^fma(s, scale·log2 e, −m), one FMA and one EX2 a logit.
// With ALiBi x is `alibi_logit2` of the tile's base bias.
template <bool CAUSAL, bool ALIBI, bool MASK>
__device__ __forceinline__ void tile_softmax(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int row_a, int t,
                                             int kv_len, float scale_log2,
                                             float slope2) {
  float bias_t = 0.f;  // of this lane's first key of the tile
  if (ALIBI) bias_t = alibi_bias2(slope2, k0 + 2 * t, kv_len);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      if (ALIBI) {
        x = alibi_logit2(x, scale_log2, slope2, 8 * j + (e & 1), bias_t);
      }
      if (MASK) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        const int row = row_a + 8 * (e >> 1);
        if (!(col < kv_len && (!CAUSAL || col <= row))) x = -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mn = quad_max(mx[r]);
    if (!ALIBI) mn *= scale_log2;
    mn = fmaxf(m[r], mn);
    // a row with nothing visible yet keeps 2^(-inf - 0) = 0 everywhere
    mu[r] = (mn == -INFINITY) ? 0.f : mn;
    alpha[r] = fast_exp2(m[r] - mu[r]);
    m[r] = mn;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    const float e = fast_exp2(ALIBI ? s[i] - mu[r]
                                    : fmaf(s[i], scale_log2, -mu[r]));
    s[i] = e;
    rs[r] += e;
  }
  // per-lane partial sums; the quad's four are added at the end
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// the fp32 accumulator layout of S is the A-fragment layout of P
__device__ __forceinline__ void to_a_frags(const float (&s)[64],
                                           uint32_t (&pf)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      pf[kk][r] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
}

template <int N>
__device__ __forceinline__ void scale_rows(float (&o)[N],
                                           const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// grid (ceil(Sq / (64 NCONS)), H, B), NCONS warpgroups a block.
template <int D, int NCONS, bool CAUSAL, bool ALIBI>
__global__ void __launch_bounds__(FwdShape<D, NCONS>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap o_map,
                           const AttnArgs p) {
  using L = FwdShape<D, NCONS>;
  constexpr int kDp = L::kDp;
  constexpr int kBoxes = kDp / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kOffBar;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kFwdStages;
  const uint32_t k_empty = v_full + 8 * kFwdStages;
  const uint32_t v_empty = k_empty + 8 * kFwdStages;

  // causal: the blocks with the most tiles start first
  const int m_block = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = m_block * L::kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  int kv_end = p.kv_len;
  if (CAUSAL) kv_end = min(kv_end, q0 + L::kRows);
  const int n_tiles = kv_end > 0 ? (kv_end + kFwdTileK - 1) / kFwdTileK : 0;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      hp::mbar_init(k_full + 8 * s, 1);
      hp::mbar_init(v_full + 8 * s, 1);
      hp::mbar_init(k_empty + 8 * s, 4 * NCONS);   // one arrival a warp
      hp::mbar_init(v_empty + 8 * s, 4 * NCONS);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  // ---- warpgroup wg owns rows q0 + 64wg .. q0 + 64wg + 63 ----
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int q0w = q0 + 64 * wg;
  const int row_a = q0w + 16 * warp + (lane >> 2);  // and row_a + 8
  const int kv_len = p.kv_len;
  const float scale_log2 = p.scale_log2;
  float slope2 = 0.f;
  if (ALIBI) slope2 = p.slopes[b * p.heads + h] * kLog2e;
  // tiles below n_full are visible to every row of this warpgroup
  int n_full = kv_len / kFwdTileK;
  if (CAUSAL) n_full = min(n_full, (q0w + 1) / kFwdTileK);

  // The loads: one thread, lane 0 of the last warpgroup, issues every TMA
  // copy: Q and the first two tiles at once, then tile i + 2 into the stage
  // of tile i as soon as every warp has released it. That warpgroup issues
  // its products last (ping-pong), so by the time it releases a stage the
  // other has too, and its waits on the empty barriers are short. Tile i
  // is keys (n − 1 − i)·128 onwards: the last tile first.
  const bool loader = threadIdx.x == 128 * (NCONS - 1);
  const int kvh = h / (p.heads / p.kv_heads);
  auto load_kv = [&](const CUtensorMap* map, uint32_t dst, uint32_t full,
                     int i) {
    const int s = i % kFwdStages;
    hp::mbar_arrive_expect_tx(full + 8 * s, L::kTileBytes);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      hp::tma_load_4d(dst + s * L::kTileBytes + c * (kFwdTileK * 128), map,
                      full + 8 * s, 64 * c, kvh,
                      (n_tiles - 1 - i) * kFwdTileK, b);
    }
  };
  // after this thread's release of tile i's K (or V): tile i + 2 into its
  // stage once the other warps have released it too
  auto refill = [&](const CUtensorMap* map, uint32_t dst, uint32_t full,
                    uint32_t empty, int i) {
    if (loader && i + kFwdStages < n_tiles) {
      hp::mbar_wait(empty + 8 * (i % kFwdStages), (i / kFwdStages) & 1);
      load_kv(map, dst, full, i + kFwdStages);
    }
  };
  if (loader && n_tiles > 0) {
    hp::mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      hp::tma_load_4d(base + c * (L::kRows * 128), &q_map, q_full, 64 * c, h,
                      q0, b);
    }
    for (int i = 0; i < kFwdStages && i < n_tiles; ++i) {
      load_kv(&k_map, base + L::kOffK, k_full, i);
      load_kv(&v_map, base + L::kOffV, v_full, i);
    }
  }

  // ping-pong: warpgroup wg issues its products after barrier 1 + wg, which
  // the other warpgroup arrives at once it has issued its own; warpgroup 0
  // goes first. Every warpgroup of the block walks the same n_tiles tiles,
  // so the arrivals and waits pair up.
  auto turn_wait = [&](int i) {
    if (NCONS == 2 && (wg == 1 || i > 0)) hp::bar_sync(1 + wg, 256);
  };
  auto turn_pass = [&](int i) {
    if (NCONS == 2 && (wg == 0 || i + 1 < n_tiles)) {
      hp::bar_arrive(2 - wg, 256);
    }
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(bar);
  };
  auto softmax = [&](float (&s)[64], float (&m)[2], float (&l)[2],
                     float (&alpha)[2], int kt) {
    if (kt >= n_full) {
      tile_softmax<CAUSAL, ALIBI, true>(s, m, l, alpha, kt * kFwdTileK, row_a,
                                        t, kv_len, scale_log2, slope2);
    } else {
      tile_softmax<CAUSAL, ALIBI, false>(s, m, l, alpha, kt * kFwdTileK,
                                         row_a, t, kv_len, scale_log2, slope2);
    }
  };

  float o[kDp / 2];
#pragma unroll
  for (int i = 0; i < kDp / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};
  if (n_tiles > 0) {
    const uint32_t qa = base + wg * (64 * 128);
    float s[64];
    uint32_t pf[8][4];
    hp::mbar_wait(q_full, 0);
    // tile n−1: S only
    hp::mbar_wait(k_full, 0);
    turn_wait(0);
    hp::wgmma_fence();
    qk_gemm<D, L::kRows>(s, qa, base + L::kOffK);
    hp::wgmma_commit();
    turn_pass(0);
    hp::fence_regs(s);
    hp::wgmma_wait<0>();
    hp::fence_regs(s);
    release(k_empty);
    refill(&k_map, base + L::kOffK, k_full, k_empty, 0);
    softmax(s, m, l, alpha, n_tiles - 1);
    to_a_frags(s, pf);
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kFwdStages, sp = (i - 1) % kFwdStages;
      hp::mbar_wait(k_full + 8 * st, (i / kFwdStages) & 1);
      turn_wait(i);
      hp::wgmma_fence();
      qk_gemm<D, L::kRows>(s, qa, base + L::kOffK + st * L::kTileBytes);
      hp::wgmma_commit();
      scale_rows(o, alpha);
      hp::mbar_wait(v_full + 8 * sp, ((i - 1) / kFwdStages) & 1);
      hp::wgmma_fence();
      pv_gemm<kDp>(o, pf, base + L::kOffV + sp * L::kTileBytes);
      hp::wgmma_commit();
      turn_pass(i);
      hp::fence_regs(s);
      hp::wgmma_wait<1>();
      hp::fence_regs(s);
      release(k_empty + 8 * st);
      refill(&k_map, base + L::kOffK, k_full, k_empty, i);
      softmax(s, m, l, alpha, n_tiles - 1 - i);
      hp::fence_regs(o);
      hp::wgmma_wait<0>();
      hp::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) hp::fence_regs(pf[kk]);
      release(v_empty + 8 * sp);
      refill(&v_map, base + L::kOffV, v_full, v_empty, i - 1);
      to_a_frags(s, pf);
    }
    // P V of tile 0
    const int sl = (n_tiles - 1) % kFwdStages;
    scale_rows(o, alpha);
    hp::mbar_wait(v_full + 8 * sl, ((n_tiles - 1) / kFwdStages) & 1);
    hp::wgmma_fence();
    pv_gemm<kDp>(o, pf, base + L::kOffV + sl * L::kTileBytes);
    hp::wgmma_commit();
    hp::fence_regs(o);
    hp::wgmma_wait<0>();
    hp::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) hp::fence_regs(pf[kk]);
  }

  // ---- epilogue: O / l as bf16 into this warpgroup's rows of the Q tile
  // (every product that read them has completed), in Q's swizzled layout,
  // then one TMA store a 64-column box (rows past Sq and columns past D are
  // not written); the natural-log LSE ----
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  const uint32_t o_smem = base + wg * (64 * 128);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + (lane >> 2) + 8 * r;   // of the warpgroup
#pragma unroll
    for (int j = 0; j < kDp / 8; ++j) {
      hp::st_shared_b32(
          o_smem + (j >> 3) * (L::kRows * 128) + row * 128 +
              (((j & 7) ^ (row & 7)) << 4) + 4 * t,
          pack_f32(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]));
    }
  }
  hp::fence_proxy_async();
  hp::bar_sync(3 + wg, 128);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      hp::tma_store_4d(&o_map, o_smem + c * (L::kRows * 128), 64 * c, h, q0w,
                       b);
    }
    hp::tma_store_commit_and_wait_read();
  }
  if (p.lse != nullptr && t == 0) {
    float* lb = p.lse + (static_cast<long>(b) * p.heads + h) * p.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row < p.sq) {
        lb[row] = l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : 0.f;
      }
    }
  }
}

// The current device's SM count, asked of the runtime once a device.
// Returns a cudaError_t value.
inline int sm_count(int* sms) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];   // 0: not asked yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kDevices) {
    *sms = known[device].load(std::memory_order_relaxed);
    if (*sms > 0) return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kDevices) known[device].store(*sms, std::memory_order_relaxed);
  return 0;
}

// The query rows a block of the last forward launched from this file took
// (64 or 128; 0 before the first): what the launcher chose, for reports.
std::atomic<int> last_fwd_rows{0};

template <int D, int NCONS, bool CAUSAL, bool ALIBI>
int launch_fwd_blocks(const AttnArgs& args, int batch, cudaStream_t stream) {
  using L = FwdShape<D, NCONS>;
  auto* kernel = flash_fwd_wgmma_kernel<D, NCONS, CAUSAL, ALIBI>;
  // dynamic shared memory above 48 KB, on the current device (set at every
  // launch: the attribute is per device, and the call is cheap)
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  CUtensorMap q_map, k_map, v_map, o_map;
  int err = hp::make_bhsd_map(&q_map, args.q, batch, args.sq, args.heads, D,
                              L::kRows);
  if (err == 0) {
    err = hp::make_bhsd_map(&k_map, args.k, batch, args.skv, args.kv_heads,
                            D, kFwdTileK);
  }
  if (err == 0) {
    err = hp::make_bhsd_map(&v_map, args.v, batch, args.skv, args.kv_heads,
                            D, kFwdTileK);
  }
  if (err == 0) {   // O: one warpgroup's 64 rows a box
    err = hp::make_bhsd_map(&o_map, args.out, batch, args.sq, args.heads, D,
                            64);
  }
  if (err != 0) return err;
  const dim3 grid((args.sq + L::kRows - 1) / L::kRows, args.heads, batch);
  kernel<<<grid, L::kThreads, L::kSmem, stream>>>(q_map, k_map, v_map, o_map,
                                                   args);
  const cudaError_t launched = cudaGetLastError();
  if (launched == cudaSuccess) {
    last_fwd_rows.store(L::kRows, std::memory_order_relaxed);
  }
  return static_cast<int>(launched);
}

// Launch the forward for head size D on `stream`; returns a cudaError_t
// value. 128-row blocks (two warpgroups in ping-pong), or 64-row ones where
// those give the SMs less to do: a 64-row block at Dp = 64 leaves room for
// two more on its SM, so there the rows an SM gets, ceil(blocks / SMs) x
// rows, decide; at Dp = 128 a 64-row block holds its SM alone, without
// ping-pong, so only where they all fit in one wave; at Dp = 192 only
// 64-row blocks fit in shared memory. (Kernel and launchers have internal
// linkage: every .cu file that includes this header owns its
// instantiations.)
template <int D, bool CAUSAL, bool ALIBI = false>
int launch_flash_fwd(const AttnArgs& args, int batch, cudaStream_t stream) {
  constexpr int kDp = padded_head_dim<D>();
  static_assert(kDp <= 192, "head size above 192");
  if constexpr (kDp == 192) {
    return launch_fwd_blocks<D, 1, CAUSAL, ALIBI>(args, batch, stream);
  } else {
    int sms = 0;
    const int err = sm_count(&sms);
    if (err != 0) return err;
    const long heads = static_cast<long>(args.heads) * batch;
    const long blocks64 = (args.sq + 63) / 64 * heads;
    const long blocks128 = (args.sq + 127) / 128 * heads;
    const bool rows64 = kDp == 64 ? (blocks64 + sms - 1) / sms * 64 <
                                        (blocks128 + sms - 1) / sms * 128
                                  : blocks64 <= sms;
    if (rows64) {
      return launch_fwd_blocks<D, 1, CAUSAL, ALIBI>(args, batch, stream);
    }
    return launch_fwd_blocks<D, 2, CAUSAL, ALIBI>(args, batch, stream);
  }
}

}  // namespace
}  // namespace lvr

// Kernels 5 and 6: flash-attention backward for decoder training, with GQA,
// on Hopper: TMA-fed wgmma in two warpgroups, FlashAttention-3's backward in
// shape (split into two calls, with no atomics).
//
// Replace the two backward `pl.pallas_call`s of `flash_attention_trainable`
// in the JAX package's `ops/flash_attention.py`: kernel 5 is `_bwd_dq_kernel`
// (dq), kernel 6 is `_bwd_dkv_kernel` (dk and dv). Both recompute the
// probabilities from the forward's saved natural-log LSE (kernel 2 writes it)
// instead of storing them, as the TPU kernels do:
//
//   P  = exp(Q·Kᵀ·scale − LSE)          (0 wherever the key is not visible)
//   dP = dO·Vᵀ,   dS = P∘(dP − δ),   δ = rowsum(dO∘O)
//   dQ = dS·K·scale,   dK = dSᵀ·Q·scale,   dV = Pᵀ·dO
//
// Layouts are kernel 2's: q, O, dO, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Skv, KV, D], all bf16; LSE and δ fp32 [B, H, Sq]. Query head h reads
// kv head h / (H / KV); dk and dv of a kv head sum over the G = H / KV query
// heads of its group inside kernel 6, which replaces the `jnp.repeat` of K/V
// before the TPU call and the sum of its transpose. Key j is visible to query
// i iff j < kv_len and (not causal or j <= i), top-left aligned, Sq and Skv
// free. TMA zero-fills the ragged edges; a masked slot is never
// exponentiated, so a row that sees no key (LSE 0) gets P = 0.
//
// δ: kernel 5 loads the O tile of its rows beside dO and forms δ = Σ_d dO·O
// in fp32 (the JAX `_bwd`'s expression), uses it, and writes it to a
// [B, H, Sq] buffer that kernel 6 reads after it on the same stream.
//
// ALiBi (the TPU kernels' `alibi` flag, `_recompute_p`): with `slopes` (fp32
// [B, H]) the recomputed logit (i, j) of query head h gains
// slope[b, h]·(j − (kv_len − 1)), the expression kernel 2 used when it wrote
// the LSE. Kernel 5 forms the bias of a tile's first key of this lane once a
// tile (the offsets are constants); in kernel 6, which holds Sᵀ, the key is
// the row variable (a lane keeps its two keys for the whole block), so their
// biases are formed once a query head of the group, under that head's slope.
// Both kernels take the LSE off the bias before the logit joins, where the
// two large numbers nearly cancel. The slopes get no gradient. The bias is a
// compile-time branch; no int→float convert enters an inner loop.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s), per launch, causal H32
// D128 (S·(S+1)/2 visible pairs of a head):
//   B16 S639 (a stage-1 step, 32 launches of each): kernel 5 reads q, k, v,
//     O, dO, LSE and writes dq, δ (505 MB, 0.151 ms) against 3 products of
//     2·D flops a pair (80.4 GFLOP, 0.081 ms); kernel 6 reads q, k, v, dO,
//     LSE, δ and writes dk, dv (505 MB, 0.151 ms) against 4 products
//     (107 GFLOP, 0.108 ms): bytes, both;
//   B2 S2048 (MPT-7B): kernel 5 103 GFLOP (0.104 ms) against 202 MB;
//     kernel 6 137.5 GFLOP (0.139 ms) against 202 MB: operations.
// The causal triangle gives a block few tiles at S = 639 (6 on average:
// 64-wide tiles for 128-row blocks), so what bounds the kernels is how
// much of their time the tensor cores are fed: every product is a wgmma,
// every operand arrives by TMA while the previous tile computes, P and dS
// never leave registers, and two warpgroups share every loaded tile.
//
// The design:
// - kernel 5: a block owns 128 query rows of one (b, h), two warpgroups of
//   64. One thread (lane 0 of the second warpgroup) loads Q, dO and O of
//   the block once, and keeps the 64-key K and V tiles of kv head h / G in
//   flight through a ring of four stages (full / empty mbarriers). S = Q·Kᵀ
//   and dP = dO·Vᵀ are SS chains at N = 64 (all K-major); dS, rounded to
//   bf16, is already the register-A fragment of dQ += dS·K, an RS chain with
//   K MN-major as stored. S and dP of tile i are issued with dQ of tile
//   i − 1, so dS of tile i forms while dQ of i − 1 is on the tensor cores.
//   dQ stays in fp32 registers and leaves, scaled, through shared memory by
//   TMA store;
// - kernel 6: a block owns 128 keys of one (b, kv head), two warpgroups of
//   64; K and V of the block are loaded once. It walks the G query heads of
//   the group and, for each, the 64-row query tiles from the causal start
//   (the block's first key): Q, dO, LSE and δ (rank-1 maps over the flat
//   [B·H·Sq] arrays, a box from the 16-byte boundary at or below the tile's
//   first query) through a ring of four stages, each tile read once
//   for 128 keys. Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are SS chains at N = 64; Pᵀ and
//   dSᵀ stay in registers as the A fragments of dV += Pᵀ·dO and
//   dK += dSᵀ·Q, RS chains with dO and Q MN-major as stored. dV and dK of
//   tile i are issued just before Sᵀ and dPᵀ of tile i + 1. dK and dV stay
//   in fp32 registers over the whole group (~200 a thread at D = 128, so no
//   producer warpgroup: ptxas caps a block of three at 168) and leave
//   through shared memory by TMA store;
// - only the tiles that need it take the per-element mask: the causal
//   diagonal, the kv_len tail and the Sq tail (in kernel 6; in kernel 5 a
//   query row past Sq has zero Q and dO, so its dS is 0, and its dq is not
//   stored);
// - no atomics: every output is one warpgroup's sum in a fixed order, so the
//   same inputs give the same bits.
#include "flash_fwd_hopper.cuh"

namespace lvr {
namespace {

constexpr int kBwdBlock = 128;   // query rows (5) or keys (6) a block
constexpr int kBwdTile = 64;     // keys (5) or query rows (6) a tile
constexpr int kBwdThreads = 256; // two warpgroups
constexpr int kBwdStages = 4;    // tiles in flight

struct BwdArgs {
  const bf16* q;      // [B, Sq, H, D]
  const bf16* k;      // [B, Skv, KV, D]
  const bf16* v;      // [B, Skv, KV, D]
  const bf16* out;    // [B, Sq, H, D]: kernel 5 forms δ from it and dO
  const bf16* dout;   // [B, Sq, H, D]
  const float* lse;   // [B, H, Sq] natural log
  float* delta;       // [B, H, Sq]: kernel 5 writes it, kernel 6 reads it
  bf16* dq;           // [B, Sq, H, D]
  bf16* dk;           // [B, Skv, KV, D]
  bf16* dv;           // [B, Skv, KV, D]
  int sq, skv, kv_len, heads, kv_heads;
  float scale;        // softmax scale
  float scale_log2;   // softmax scale * log2(e)
  const float* slopes;  // [B, H] ALiBi slopes, or nullptr
};

// Kernel 5's shared memory: Q, dO and O of the block (D / 64 boxes of 128
// rows each), then the ring's K and V tiles (D / 64 boxes of 64 rows).
template <int D>
struct DqShape {
  static constexpr int kBlockBytes = kBwdBlock * D * 2;
  static constexpr int kTileBytes = kBwdTile * D * 2;
  static constexpr int kOffDo = kBlockBytes;
  static constexpr int kOffO = 2 * kBlockBytes;
  static constexpr int kOffK = 3 * kBlockBytes;
  static constexpr int kOffV = kOffK + kBwdStages * kTileBytes;
  static constexpr int kOffBar = kOffV + kBwdStages * kTileBytes;
  // q_full, then full and empty a stage; + alignment
  static constexpr int kSmem = kOffBar + (1 + 2 * kBwdStages) * 8 + 1024;
};

// a block may use 227 KB of shared memory (kernel 5 at D = 128: 225 KB)
static_assert(DqShape<128>::kSmem <= 232448, "kernel 5's ring is too deep");

// A TMA box must start on a 16-byte boundary of global memory, and a query
// tile's LSE and δ start at bh·Sq + q0, which is none at odd Sq: the box
// starts at the 4-float boundary below and holds 4 floats more.
constexpr int kStatBox = kBwdTile + 4;   // floats a box
constexpr int kStatPitch = 384;          // bytes from LSE to δ of a stage

// Kernel 6's: K and V of the block, the ring's Q and dO tiles, then its
// LSE and δ boxes.
template <int D>
struct DkvShape {
  static constexpr int kBlockBytes = kBwdBlock * D * 2;
  static constexpr int kTileBytes = kBwdTile * D * 2;
  static constexpr int kStatBytes = 2 * kStatPitch;
  static constexpr int kOffV = kBlockBytes;
  static constexpr int kOffQ = 2 * kBlockBytes;
  static constexpr int kOffDo = kOffQ + kBwdStages * kTileBytes;
  static constexpr int kOffStat = kOffDo + kBwdStages * kTileBytes;
  static constexpr int kOffBar = kOffStat + kBwdStages * kStatBytes;
  // kv_full, then full and empty a stage; + alignment
  static constexpr int kSmem = kOffBar + (1 + 2 * kBwdStages) * 8 + 1024;
};

// d[64 x 64] = A·Bᵀ over D: A (this warpgroup's 64 rows of a tile of
// A_ROWS rows) and B (a tile of 64 rows) K-major, D / 64 boxes of 128-byte
// rows; a k16 step moves 32 bytes along a row, every fourth starts the next
// box.
template <int D, int A_ROWS>
__device__ __forceinline__ void ss_gemm(float (&d)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    hp::wgmma_m64n64k16<0>(
        d, hp::sw128_desc(a + (kk >> 2) * (A_ROWS * 128) + col, 16, 1024),
        hp::sw128_desc(b + (kk >> 2) * (kBwdTile * 128) + col, 16, 1024),
        kk > 0);
  }
}

// d[64 x D] += A·B: A from registers (f[kk]: contraction 16kk..16kk+15), B
// a tile of 64 contraction rows MN-major as stored: D / 64 boxes of 64
// columns; a k16 step is 16 rows (2 KB), LBO the next box.
template <int D>
__device__ __forceinline__ void rs_gemm(float (&d)[D / 2],
                                        const uint32_t (&f)[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kBwdTile / 16; ++kk) {
    const uint64_t db =
        hp::sw128_desc(b + kk * 16 * 128, kBwdTile * 128, 1024);
    if constexpr (D == 128) {
      hp::wgmma_m64n128k16_rs_t<1>(d, f[kk], db, 1);
    } else {
      hp::wgmma_m64n64k16_rs_t<1>(d, f[kk], db, 1);
    }
  }
}

// the fp32 accumulator of a 64 x 64 tile, rounded to bf16, is the register-A
// fragment of the next product (contraction over its 64 columns)
__device__ __forceinline__ void to_frags(const float (&s)[32],
                                         uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      f[kk][r] = pack_f32(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
  }
}

__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hp::fence_regs(f[kk]);
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&wa[i]));
    const float2 fb = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&wb[i]));
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  return acc;
}

// Kernel 5's dS = P∘(dP − δ) of one tile in place of S, for this lane's
// rows row_a and row_a + 8 (LSE·log2 e in lse2, δ in dl). Keys from k0.
template <bool CAUSAL, bool ALIBI, bool MASK>
__device__ __forceinline__ void dq_tile_ds(float (&s)[32],
                                           const float (&dp)[32], int k0,
                                           int row_a, int t, int kv_len,
                                           float scale_log2, float slope2,
                                           const float (&lse2)[2],
                                           const float (&dl)[2]) {
  float base[2] = {-lse2[0], -lse2[1]};
  if (ALIBI) {
    const float bias_t = alibi_bias2(slope2, k0 + 2 * t, kv_len);
    base[0] = bias_t - lse2[0];
    base[1] = bias_t - lse2[1];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = ALIBI ? alibi_logit2(s[4 * j + e], scale_log2, slope2,
                                     8 * j + (e & 1), base[r])
                      : fmaf(s[4 * j + e], scale_log2, base[r]);
      if (MASK) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        if (!(col < kv_len && (!CAUSAL || col <= row_a + 8 * r))) {
          x = -INFINITY;
        }
      }
      s[4 * j + e] = fast_exp2(x) * (dp[4 * j + e] - dl[r]);
    }
  }
}

// Kernel 6's Pᵀ (in place of Sᵀ) and dSᵀ = Pᵀ∘(dPᵀ − δ) (in place of dPᵀ)
// of one tile: rows are this lane's keys key_a and key_a + 8 (ALiBi bias
// in bias2), columns the tile's queries from q0, whose LSE and δ are in
// shared memory (from lse[0] and dl[0], 4-byte aligned).
template <bool CAUSAL, bool ALIBI, bool MASK>
__device__ __forceinline__ void dkv_tile_p_ds(
    float (&s)[32], float (&dp)[32], const float* lse, const float* dl,
    int q0, int key_a, int t, int kv_len, int sq, float scale_log2,
    const float (&bias2)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float nl[2] = {-lse[col] * kLog2e, -lse[col + 1] * kLog2e};
    const float dd[2] = {dl[col], dl[col + 1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, c = e & 1;
      float x = fmaf(s[4 * j + e], scale_log2,
                     ALIBI ? bias2[r] + nl[c] : nl[c]);
      if (MASK) {
        const int key = key_a + 8 * r;
        const int query = q0 + 8 * j + 2 * t + c;
        if (!(key < kv_len && query < sq && (!CAUSAL || key <= query))) {
          x = -INFINITY;
        }
      }
      const float pr = fast_exp2(x);
      s[4 * j + e] = pr;
      dp[4 * j + e] = pr * (dp[4 * j + e] - dd[c]);
    }
  }
}

// this warpgroup's 64 x D fp32 accumulator, times `scale`, as bf16 into its
// rows of a swizzled block tile at `tile` (D / 64 boxes of 128 rows)
template <int D>
__device__ __forceinline__ void acc_to_smem(const float (&acc)[D / 2],
                                            uint32_t tile, int warp,
                                            int lane, float scale) {
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + (lane >> 2) + 8 * r;   // of the warpgroup
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      hp::st_shared_b32(
          tile + (j >> 3) * (kBwdBlock * 128) + row * 128 +
              (((j & 7) ^ (row & 7)) << 4) + 4 * t,
          pack_f32(acc[4 * j + 2 * r] * scale,
                   acc[4 * j + 2 * r + 1] * scale));
    }
  }
}

// Kernel 5. grid (ceil(Sq / 128), H, B), two warpgroups a block.
template <int D, bool CAUSAL, bool ALIBI>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap o_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap dq_map,
                        const BwdArgs p) {
  using L = DqShape<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* sm = smem_raw + (base - hp::smem_u32(smem_raw));
  const uint32_t q_full = base + L::kOffBar;
  const uint32_t full = q_full + 8, empty = full + 8 * kBwdStages;

  // causal: the blocks with the most tiles start first
  const int m_block = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = m_block * kBwdBlock;
  const int h = blockIdx.y, b = blockIdx.z;
  int kv_end = p.kv_len;
  if (CAUSAL) kv_end = min(kv_end, q0 + kBwdBlock);
  const int n_tiles = kv_end > 0 ? (kv_end + kBwdTile - 1) / kBwdTile : 0;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, 8);   // one arrival a warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int q0w = q0 + 64 * wg;
  const int row_a = q0w + 16 * warp + (lane >> 2);   // and row_a + 8
  const int kvh = h / (p.heads / p.kv_heads);
  const int kv_len = p.kv_len;

  // The loads: one thread, lane 0 of the second warpgroup, issues every TMA
  // copy: Q, dO and O once, the first four tiles at once, then tile
  // i + 4 into the stage of tile i as soon as every warp has released it.
  // Tile i is keys (n − 1 − i)·64 onwards: the last tile (the diagonal)
  // first.
  const bool loader = threadIdx.x == 128;
  auto load_tile = [&](int i) {
    const int s = i % kBwdStages;
    hp::mbar_arrive_expect_tx(full + 8 * s, 2 * L::kTileBytes);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      const uint32_t off = s * L::kTileBytes + c * (kBwdTile * 128);
      const int key0 = (n_tiles - 1 - i) * kBwdTile;
      hp::tma_load_4d(base + L::kOffK + off, &k_map, full + 8 * s, 64 * c,
                      kvh, key0, b);
      hp::tma_load_4d(base + L::kOffV + off, &v_map, full + 8 * s, 64 * c,
                      kvh, key0, b);
    }
  };
  if (loader) {
    hp::mbar_arrive_expect_tx(q_full, 3 * L::kBlockBytes);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      const uint32_t off = c * (kBwdBlock * 128);
      hp::tma_load_4d(base + off, &q_map, q_full, 64 * c, h, q0, b);
      hp::tma_load_4d(base + L::kOffDo + off, &do_map, q_full, 64 * c, h, q0,
                      b);
      hp::tma_load_4d(base + L::kOffO + off, &o_map, q_full, 64 * c, h, q0,
                      b);
    }
    for (int i = 0; i < kBwdStages && i < n_tiles; ++i) load_tile(i);
  }

  const long bh = static_cast<long>(b) * p.heads + h;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse2[r] = row < p.sq ? p.lse[bh * p.sq + row] * kLog2e : 0.f;
  }
  float slope2 = 0.f;
  if (ALIBI) slope2 = p.slopes[bh] * kLog2e;
  hp::mbar_wait(q_full, 0);
  // δ of this lane's two rows: chunks t and t + 4 of each 128-byte row of O
  // and dO, then the quad's sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 64 * wg + 16 * warp + (lane >> 2) + 8 * r;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int off = c * (kBwdBlock * 128) + row * 128 +
                        (((t + 4 * half) ^ (row & 7)) << 4);
        acc += dot8(*reinterpret_cast<const uint4*>(sm + L::kOffO + off),
                    *reinterpret_cast<const uint4*>(sm + L::kOffDo + off));
      }
    }
    dl[r] = quad_sum(acc);
    if (t == 0 && row_a + 8 * r < p.sq) {
      p.delta[bh * p.sq + row_a + 8 * r] = dl[r];
    }
  }

  // tiles below n_full are visible to every row of this warpgroup
  int n_full = kv_len / kBwdTile;
  if (CAUSAL) n_full = min(n_full, (q0w + 1) / kBwdTile);
  auto tile_ds = [&](float (&s)[32], const float (&dp)[32], int kt) {
    if (kt >= n_full) {
      dq_tile_ds<CAUSAL, ALIBI, true>(s, dp, kt * kBwdTile, row_a, t, kv_len,
                                      p.scale_log2, slope2, lse2, dl);
    } else {
      dq_tile_ds<CAUSAL, ALIBI, false>(s, dp, kt * kBwdTile, row_a, t,
                                       kv_len, p.scale_log2, slope2, lse2,
                                       dl);
    }
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + 8 * (i % kBwdStages));
    // after this thread's release of tile i: tile i + 4 into its stage once
    // the other warps have released it too
    if (loader && i + kBwdStages < n_tiles) {
      hp::mbar_wait(empty + 8 * (i % kBwdStages), (i / kBwdStages) & 1);
      load_tile(i + kBwdStages);
    }
  };

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  if (n_tiles > 0) {
    const uint32_t qa = base + wg * (64 * 128);
    const uint32_t da = base + L::kOffDo + wg * (64 * 128);
    float s[32], dp[32];
    uint32_t f[4][4];
    auto issue_s_dp = [&](int i) {
      const int st = i % kBwdStages;
      hp::mbar_wait(full + 8 * st, (i / kBwdStages) & 1);
      hp::wgmma_fence();
      ss_gemm<D, kBwdBlock>(s, qa, base + L::kOffK + st * L::kTileBytes);
      ss_gemm<D, kBwdBlock>(dp, da, base + L::kOffV + st * L::kTileBytes);
      hp::wgmma_commit();
    };
    auto issue_dq = [&](int i) {
      hp::wgmma_fence();
      rs_gemm<D>(dq, f,
                 base + L::kOffK + (i % kBwdStages) * L::kTileBytes);
      hp::wgmma_commit();
    };
    issue_s_dp(0);
    hp::fence_regs(s);
    hp::fence_regs(dp);
    hp::wgmma_wait<0>();
    hp::fence_regs(s);
    hp::fence_regs(dp);
    tile_ds(s, dp, n_tiles - 1);
    to_frags(s, f);
    for (int i = 1; i < n_tiles; ++i) {
      issue_s_dp(i);
      issue_dq(i - 1);
      hp::fence_regs(s);
      hp::fence_regs(dp);
      hp::wgmma_wait<1>();
      hp::fence_regs(s);
      hp::fence_regs(dp);
      tile_ds(s, dp, n_tiles - 1 - i);
      hp::fence_regs(dq);
      hp::wgmma_wait<0>();
      hp::fence_regs(dq);
      fence_frags(f);
      release(i - 1);
      to_frags(s, f);
    }
    issue_dq(n_tiles - 1);
    hp::fence_regs(dq);
    hp::wgmma_wait<0>();
    hp::fence_regs(dq);
    fence_frags(f);
  }

  // ---- epilogue: dq·scale as bf16 into this warpgroup's rows of the Q
  // tile (every product that read them has completed), then one TMA store a
  // 64-column box (rows past Sq are not written) ----
  const uint32_t o_smem = base + wg * (64 * 128);
  acc_to_smem<D>(dq, o_smem, warp, lane, p.scale);
  hp::fence_proxy_async();
  hp::bar_sync(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      hp::tma_store_4d(&dq_map, o_smem + c * (kBwdBlock * 128), 64 * c, h,
                       q0w, b);
    }
    hp::tma_store_commit_and_wait_read();
  }
}

// Kernel 6. grid (ceil(Skv / 128), KV, B), two warpgroups a block.
template <int D, bool CAUSAL, bool ALIBI>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap lse_map,
                         const __grid_constant__ CUtensorMap delta_map,
                         const __grid_constant__ CUtensorMap dk_map,
                         const __grid_constant__ CUtensorMap dv_map,
                         const BwdArgs p) {
  using L = DkvShape<D>;
  constexpr int kBoxes = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* sm = smem_raw + (base - hp::smem_u32(smem_raw));
  const uint32_t kv_full = base + L::kOffBar;
  const uint32_t full = kv_full + 8, empty = full + 8 * kBwdStages;

  const int k0 = blockIdx.x * kBwdBlock;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  const int kv_len = p.kv_len, sq = p.sq;
  // causal: no query before the block's first key sees any of its keys
  const int q_start = CAUSAL ? k0 : 0;
  const int n_q = (k0 < kv_len && q_start < sq)
                      ? (sq - q_start + kBwdTile - 1) / kBwdTile
                      : 0;
  const int n_items = group * n_q;   // (head of the group, query tile)

  if (threadIdx.x == 0) {
    hp::mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      hp::mbar_init(full + 8 * s, 1);
      hp::mbar_init(empty + 8 * s, 8);   // one arrival a warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int k0w = k0 + 64 * wg;
  const int key_a = k0w + 16 * warp + (lane >> 2);   // and key_a + 8

  // The loads: lane 0 of the second warpgroup issues every TMA copy: K and
  // V of the block once, then item i (query head kvh·G + i / n_q, query
  // tile i % n_q) into stage i % 4: Q, dO, and the tile's LSE and δ.
  const bool loader = threadIdx.x == 128;
  auto load_item = [&](int i) {
    const int s = i % kBwdStages;
    const int h = kvh * group + i / n_q;
    const int q0 = q_start + (i % n_q) * kBwdTile;
    hp::mbar_arrive_expect_tx(full + 8 * s,
                              2 * L::kTileBytes + 2 * kStatBox * 4);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      const uint32_t off = s * L::kTileBytes + c * (kBwdTile * 128);
      hp::tma_load_4d(base + L::kOffQ + off, &q_map, full + 8 * s, 64 * c, h,
                      q0, b);
      hp::tma_load_4d(base + L::kOffDo + off, &do_map, full + 8 * s, 64 * c,
                      h, q0, b);
    }
    const int flat = ((b * p.heads + h) * sq + q0) & ~3;
    const uint32_t stat = base + L::kOffStat + s * L::kStatBytes;
    hp::tma_load_1d(stat, &lse_map, full + 8 * s, flat);
    hp::tma_load_1d(stat + kStatPitch, &delta_map, full + 8 * s, flat);
  };
  if (loader && n_items > 0) {
    hp::mbar_arrive_expect_tx(kv_full, 2 * L::kBlockBytes);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      const uint32_t off = c * (kBwdBlock * 128);
      hp::tma_load_4d(base + off, &k_map, kv_full, 64 * c, kvh, k0, b);
      hp::tma_load_4d(base + L::kOffV + off, &v_map, kv_full, 64 * c, kvh, k0,
                      b);
    }
    for (int i = 0; i < kBwdStages && i < n_items; ++i) load_item(i);
  }
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + 8 * (i % kBwdStages));
    if (loader && i + kBwdStages < n_items) {
      hp::mbar_wait(empty + 8 * (i % kBwdStages), (i / kBwdStages) & 1);
      load_item(i + kBwdStages);
    }
  };

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (n_items > 0) {
    const uint32_t ka = base + wg * (64 * 128);
    const uint32_t va = base + L::kOffV + wg * (64 * 128);
    float s[32], dp[32];
    uint32_t pf[4][4], sf[4][4];
    float bias2[2] = {0.f, 0.f};
    hp::mbar_wait(kv_full, 0);
    for (int i = 0; i < n_items; ++i) {
      const int st = i % kBwdStages;
      const int qt = i % n_q;
      const int q0 = q_start + qt * kBwdTile;
      if (ALIBI && qt == 0) {
        // the bias of this lane's two keys under the QUERY head's slope
        const float slope2 =
            p.slopes[b * p.heads + kvh * group + i / n_q] * kLog2e;
        bias2[0] = alibi_bias2(slope2, key_a, kv_len);
        bias2[1] = alibi_bias2(slope2, key_a + 8, kv_len);
      }
      hp::mbar_wait(full + 8 * st, (i / kBwdStages) & 1);
      hp::wgmma_fence();
      ss_gemm<D, kBwdBlock>(s, ka, base + L::kOffQ + st * L::kTileBytes);
      ss_gemm<D, kBwdBlock>(dp, va, base + L::kOffDo + st * L::kTileBytes);
      hp::wgmma_commit();
      hp::fence_regs(s);
      hp::fence_regs(dp);
      hp::fence_regs(dk);
      hp::fence_regs(dv);
      hp::wgmma_wait<0>();   // and dV, dK of item i − 1
      hp::fence_regs(s);
      hp::fence_regs(dp);
      hp::fence_regs(dk);
      hp::fence_regs(dv);
      fence_frags(pf);
      fence_frags(sf);
      if (i > 0) release(i - 1);
      // this tile's first query within the stage's boxes
      const int first =
          ((b * p.heads + kvh * group + i / n_q) * sq + q0) & 3;
      const float* stat = reinterpret_cast<const float*>(
                              sm + L::kOffStat + st * L::kStatBytes) +
                          first;
      // a tile is visible to every key of this warpgroup when all its
      // queries are past the warpgroup's last key and before Sq, and no
      // key is past kv_len
      const bool mask = (CAUSAL && q0 < k0w + 63) || q0 + kBwdTile > sq ||
                        k0w + 64 > kv_len;
      if (mask) {
        dkv_tile_p_ds<CAUSAL, ALIBI, true>(s, dp, stat, stat + kStatPitch / 4,
                                            q0, key_a, t, kv_len, sq,
                                            p.scale_log2, bias2);
      } else {
        dkv_tile_p_ds<CAUSAL, ALIBI, false>(s, dp, stat, stat + kStatPitch / 4,
                                            q0, key_a, t, kv_len, sq,
                                            p.scale_log2, bias2);
      }
      to_frags(s, pf);
      to_frags(dp, sf);
      hp::wgmma_fence();
      rs_gemm<D>(dv, pf, base + L::kOffDo + st * L::kTileBytes);
      rs_gemm<D>(dk, sf, base + L::kOffQ + st * L::kTileBytes);
      hp::wgmma_commit();
    }
    hp::fence_regs(dk);
    hp::fence_regs(dv);
    hp::wgmma_wait<0>();
    hp::fence_regs(dk);
    hp::fence_regs(dv);
    fence_frags(pf);
    fence_frags(sf);
  }

  // ---- epilogue: dk·scale and dv as bf16 into this warpgroup's rows of the
  // K and V tiles, then TMA stores (keys past Skv are not written; keys
  // past kv_len, and whole blocks past it, store zeros) ----
  const uint32_t k_smem = base + wg * (64 * 128);
  const uint32_t v_smem = base + L::kOffV + wg * (64 * 128);
  acc_to_smem<D>(dk, k_smem, warp, lane, p.scale);
  acc_to_smem<D>(dv, v_smem, warp, lane, 1.f);
  hp::fence_proxy_async();
  hp::bar_sync(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      hp::tma_store_4d(&dk_map, k_smem + c * (kBwdBlock * 128), 64 * c, kvh,
                       k0w, b);
      hp::tma_store_4d(&dv_map, v_smem + c * (kBwdBlock * 128), 64 * c, kvh,
                       k0w, b);
    }
    hp::tma_store_commit_and_wait_read();
  }
}

template <int D, bool CAUSAL, bool ALIBI>
int launch_dq(const BwdArgs& a, int batch, cudaStream_t stream) {
  using L = DqShape<D>;
  auto* kernel = flash_bwd_dq_kernel<D, CAUSAL, ALIBI>;
  // dynamic shared memory above 48 KB, on the current device (set at every
  // launch: the attribute is per device)
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  CUtensorMap q_map, do_map, o_map, k_map, v_map, dq_map;
  int err = hp::make_bhsd_map(&q_map, a.q, batch, a.sq, a.heads, D,
                              kBwdBlock);
  if (err == 0) {
    err = hp::make_bhsd_map(&do_map, a.dout, batch, a.sq, a.heads, D,
                            kBwdBlock);
  }
  if (err == 0) {
    err = hp::make_bhsd_map(&o_map, a.out, batch, a.sq, a.heads, D,
                            kBwdBlock);
  }
  if (err == 0) {
    err = hp::make_bhsd_map(&k_map, a.k, batch, a.skv, a.kv_heads, D,
                            kBwdTile);
  }
  if (err == 0) {
    err = hp::make_bhsd_map(&v_map, a.v, batch, a.skv, a.kv_heads, D,
                            kBwdTile);
  }
  if (err == 0) {   // dq: one warpgroup's 64 rows a box
    err = hp::make_bhsd_map(&dq_map, a.dq, batch, a.sq, a.heads, D, 64);
  }
  if (err != 0) return err;
  const dim3 grid((a.sq + kBwdBlock - 1) / kBwdBlock, a.heads, batch);
  kernel<<<grid, kBwdThreads, L::kSmem, stream>>>(q_map, do_map, o_map,
                                                  k_map, v_map, dq_map, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool CAUSAL, bool ALIBI>
int launch_dkv(const BwdArgs& a, int batch, cudaStream_t stream) {
  using L = DkvShape<D>;
  auto* kernel = flash_bwd_dkv_kernel<D, CAUSAL, ALIBI>;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  CUtensorMap k_map, v_map, q_map, do_map, lse_map, delta_map, dk_map,
      dv_map;
  const uint64_t stats = static_cast<uint64_t>(batch) * a.heads * a.sq;
  int err = hp::make_bhsd_map(&k_map, a.k, batch, a.skv, a.kv_heads, D,
                              kBwdBlock);
  if (err == 0) {
    err = hp::make_bhsd_map(&v_map, a.v, batch, a.skv, a.kv_heads, D,
                            kBwdBlock);
  }
  if (err == 0) {
    err = hp::make_bhsd_map(&q_map, a.q, batch, a.sq, a.heads, D, kBwdTile);
  }
  if (err == 0) {
    err = hp::make_bhsd_map(&do_map, a.dout, batch, a.sq, a.heads, D,
                            kBwdTile);
  }
  if (err == 0) err = hp::make_flat_f32_map(&lse_map, a.lse, stats, kStatBox);
  if (err == 0) {
    err = hp::make_flat_f32_map(&delta_map, a.delta, stats, kStatBox);
  }
  if (err == 0) {
    err = hp::make_bhsd_map(&dk_map, a.dk, batch, a.skv, a.kv_heads, D, 64);
  }
  if (err == 0) {
    err = hp::make_bhsd_map(&dv_map, a.dv, batch, a.skv, a.kv_heads, D, 64);
  }
  if (err != 0) return err;
  const dim3 grid((a.skv + kBwdBlock - 1) / kBwdBlock, a.kv_heads, batch);
  kernel<<<grid, kBwdThreads, L::kSmem, stream>>>(
      k_map, v_map, q_map, do_map, lse_map, delta_map, dk_map, dv_map, a);
  return static_cast<int>(cudaGetLastError());
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* out, const void* dout, const void* lse,
                  void* delta, void* dq, void* dk, void* dv,
                  const void* slopes, int seq_q, int seq_kv, int heads,
                  int kv_heads, int kv_len, float scale) {
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<const bf16*>(out);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.sq = seq_q;
  a.skv = seq_kv;
  a.kv_len = kv_len;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.slopes = static_cast<const float*>(slopes);
  return a;
}

// head size x causal x ALiBi -> one instantiation of LAUNCH
#define LVR_DISPATCH_BWD(LAUNCH, a, batch, s, head_dim, causal)              \
  do {                                                                        \
    const bool alibi_ = (a).slopes != nullptr;                                \
    if ((head_dim) == 64) {                                                   \
      if (alibi_) {                                                           \
        return (causal) ? LAUNCH<64, true, true>(a, batch, s)                 \
                        : LAUNCH<64, false, true>(a, batch, s);               \
      }                                                                       \
      return (causal) ? LAUNCH<64, true, false>(a, batch, s)                  \
                      : LAUNCH<64, false, false>(a, batch, s);                \
    }                                                                         \
    if ((head_dim) == 128) {                                                  \
      if (alibi_) {                                                           \
        return (causal) ? LAUNCH<128, true, true>(a, batch, s)                \
                        : LAUNCH<128, false, true>(a, batch, s);              \
      }                                                                       \
      return (causal) ? LAUNCH<128, true, false>(a, batch, s)                 \
                      : LAUNCH<128, false, false>(a, batch, s);               \
    }                                                                         \
    return static_cast<int>(cudaErrorInvalidValue);                           \
  } while (0)

}  // namespace
}  // namespace lvr

// Kernel 5. It forms δ = rowsum(dO∘O) from `out` (O) and `dout` and writes
// it into `delta` for kernel 6.
extern "C" int lvr_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq,
    const void* slopes, int batch, int seq_q, int seq_kv, int heads,
    int kv_heads, int head_dim, int kv_len, int causal, float scale,
    void* stream) {
  const lvr::BwdArgs a = lvr::make_args(
      q, k, v, out, dout, lse, delta, dq, nullptr, nullptr, slopes, seq_q,
      seq_kv, heads, kv_heads, kv_len, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LVR_DISPATCH_BWD(lvr::launch_dq, a, batch, s, head_dim, causal);
}

extern "C" int lvr_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const void* slopes, int batch, int seq_q, int seq_kv, int heads,
    int kv_heads, int head_dim, int kv_len, int causal, float scale,
    void* stream) {
  const lvr::BwdArgs a = lvr::make_args(
      q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr, dk, dv,
      slopes, seq_q, seq_kv, heads, kv_heads, kv_len, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LVR_DISPATCH_BWD(lvr::launch_dkv, a, batch, s, head_dim, causal);
}

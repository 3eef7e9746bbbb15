// Kernels 5 and 6: flash-attention backward for decoder training, with GQA.
//
// Replace the two backward `pl.pallas_call`s of `flash_attention_trainable`
// in the JAX package's `ops/flash_attention.py`: kernel 5 is `_bwd_dq_kernel`
// (dq), kernel 6 is `_bwd_dkv_kernel` (dk and dv). Both recompute the
// probabilities from the forward's saved natural-log LSE (kernel 2 writes it)
// instead of storing them, as the TPU kernels do:
//
//   P  = exp(Q·Kᵀ·scale − LSE)          (0 wherever the key is not visible)
//   dP = dO·Vᵀ,   dS = P∘(dP − δ),   δ = rowsum(dO∘O)   (δ from the wrapper)
//   dQ = dS·K·scale,   dK = dSᵀ·Q·scale,   dV = Pᵀ·dO
//
// Layouts are kernel 2's: q, dO, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Skv, KV, D], all bf16; LSE and δ fp32 [B, H, Sq]. Query head h reads
// kv head h / (H / KV); dk and dv of a kv head sum over the G = H / KV query
// heads of its group inside kernel 6, which replaces the `jnp.repeat` of K/V
// before the TPU call and the sum of its transpose. Key j is visible to query
// i iff j < kv_len and (not causal or j <= i). The ragged edges are
// zero-filled at load and masked in the scores; a masked slot is never
// exponentiated, so a row that sees no key (LSE 0) gets P = 0.
//
// ALiBi (the TPU kernels' `alibi` flag, `_recompute_p`): with `slopes` (fp32
// [B, H]) the recomputed logit (i, j) of query head h gains
// slope[b, h]·(j − (kv_len − 1)), the expression kernel 2 used when it wrote
// the LSE. In kernel 6, which holds Sᵀ, the key is the row variable (a lane
// keeps its two keys for the whole block, so their biases are formed once a
// head), and the slope is the query head's, so it changes inside the loop
// over a group's heads. Both kernels take the LSE off the bias before the
// logit joins, where the two large numbers nearly cancel. The slopes get no
// gradient. The bias is a compile-time branch.
//
// Split of the work (no atomics, the same split as the two TPU calls):
// - kernel 5: a block of four warps owns 64 query rows of one (b, h) and
//   walks the 64-key tiles of kv head h / G up to the causal bound; dQ stays
//   in fp32 registers;
// - kernel 6: a block owns 64 keys of one (b, kv head); each warp owns 16 of
//   them. It walks the G query heads of the group and, for each, the 32-row
//   query tiles from the causal start (the first tile that holds a query at
//   or past the block's first key). dK and dV stay in fp32 registers.
//
// Bound on the H100: one causal Vicuna-7B layer of the training step (B = 16,
// S = 639, H = 32, D = 128) is ~2.5 × the forward's FLOPs (five S-sized
// products instead of two) over ~0.3 GB of operands, well above the bf16
// ridge point, so the tensor cores set the floor. This first version runs
// `mma.sync.m16n8k16` on operands staged in padded shared memory (bank-
// conflict-free fragment reads); P and dS go from the accumulator layout to
// the next product's A operand in registers, and the transposed B operands
// (Pᵀ·dO, dSᵀ·Q, dS·K) are gathered as bf16 pairs from two shared-memory rows.
// No TMA, no wgmma and no copy/compute overlap yet.
#include "attention_common.cuh"

namespace lvr {
namespace {

constexpr int kDqBlockQ = 64;   // kernel 5: query rows per block
constexpr int kDqTileK = 64;    // kernel 5: keys per tile
constexpr int kDkvBlockK = 64;  // kernel 6: keys per block
constexpr int kDkvTileQ = 32;   // kernel 6: query rows per tile

struct BwdArgs {
  const bf16* q;      // [B, Sq, H, D]
  const bf16* k;      // [B, Skv, KV, D]
  const bf16* v;      // [B, Skv, KV, D]
  const bf16* dout;   // [B, Sq, H, D]
  const float* lse;   // [B, H, Sq] natural log
  const float* delta; // [B, H, Sq]
  bf16* dq;           // [B, Sq, H, D]
  bf16* dk;           // [B, Skv, KV, D]
  bf16* dv;           // [B, Skv, KV, D]
  int sq, skv, kv_len, heads, kv_heads;
  float scale;        // softmax scale
  float scale_log2;   // softmax scale * log2(e)
  const float* slopes;  // [B, H] ALiBi slopes, or nullptr
};

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kDqBlockQ + 2 * kDqTileK) * (D + 8) * static_cast<int>(sizeof(bf16));
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kDkvBlockK + 2 * kDkvTileQ) * (D + 8) * static_cast<int>(sizeof(bf16)) +
         2 * kDkvTileQ * static_cast<int>(sizeof(float));
}

// A operand (16x16) of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// row-major shared-memory tile with row pitch LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int r0,
                                       int c0, int g, int t) {
  const bf16* base = s + (r0 + g) * LD + c0 + 2 * t;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * LD);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * LD + 8);
}

// B operand (16x8) with B[k][n] = M[n0 + n][k0 + k]: the tile's rows are the
// product's columns, so each register is two neighbours of one row.
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const bf16* s, int n0, int k0,
                                            int g, int t) {
  const bf16* p = s + (n0 + g) * LD + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B operand (16x8) with B[k][n] = M[k0 + k][n0 + n]: the transposed read, each
// register gathers one column's values from two neighbouring rows.
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const bf16* s, int k0, int n0,
                                            int g, int t) {
  const bf16* p = s + (k0 + 2 * t) * LD + n0 + g;
  b0 = pack_bf16(p[0], p[LD]);
  b1 = pack_bf16(p[8 * LD], p[9 * LD]);
}

// The C fragments of two neighbouring 8-column tiles as one A operand.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4],
                                       const float hi[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

// Kernel 5. grid (ceil(Sq / 64), H, B).
template <int D, bool CAUSAL, bool ALIBI>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdArgs p) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_do = s_q + kDqBlockQ * kLd;
  bf16* s_k = s_do + kDqBlockQ * kLd;
  bf16* s_v = s_k + kDqTileK * kLd;

  const int q0 = blockIdx.x * kDqBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const long q_rs = static_cast<long>(p.heads) * D;
  const long kv_rs = static_cast<long>(p.kv_heads) * D;
  const long q_off = static_cast<long>(b) * p.sq * q_rs + h * D;
  const long kv_off = static_cast<long>(b) * p.skv * kv_rs + kvh * D;
  const float* lse_b = p.lse + (static_cast<long>(b) * p.heads + h) * p.sq;
  const float* delta_b = p.delta + (static_cast<long>(b) * p.heads + h) * p.sq;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;
  const int row_a = q0 + r0 + g;  // this thread's two query rows
  const int row_b = row_a + 8;

  load_tile<D, kDqBlockQ, kThreads>(s_q, p.q + q_off, q_rs, q0, p.sq);
  load_tile<D, kDqBlockQ, kThreads>(s_do, p.dout + q_off, q_rs, q0, p.sq);
  const float lse2[2] = {row_a < p.sq ? lse_b[row_a] * kLog2e : 0.f,
                         row_b < p.sq ? lse_b[row_b] * kLog2e : 0.f};
  const float dl[2] = {row_a < p.sq ? delta_b[row_a] : 0.f,
                       row_b < p.sq ? delta_b[row_b] : 0.f};
  float slope2 = 0.f;
  if (ALIBI) slope2 = p.slopes[b * p.heads + h] * kLog2e;

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  int kv_end = p.kv_len;
  if (CAUSAL) kv_end = min(kv_end, q0 + kDqBlockQ);
  const int n_tiles = (kv_end + kDqTileK - 1) / kDqTileK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kDqTileK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D, kDqTileK, kThreads>(s_k, p.k + kv_off, kv_rs, k0, p.kv_len);
    load_tile<D, kDqTileK, kThreads>(s_v, p.v + kv_off, kv_rs, k0, p.kv_len);
    __syncthreads();

    // S = Q·Kᵀ and dP = dO·Vᵀ, 16 rows x 64 keys per warp
    float s[kDqTileK / 8][4], dp[kDqTileK / 8][4];
#pragma unroll
    for (int n = 0; n < kDqTileK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a<kLd>(aq, s_q, r0, kk * 16, g, t);
      load_a<kLd>(ado, s_do, r0, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kDqTileK / 8; ++n) {
        uint32_t b0, b1;
        load_b_rows<kLd>(b0, b1, s_k, n * 8, kk * 16, g, t);
        mma_16816(s[n], aq, b0, b1);
        load_b_rows<kLd>(b0, b1, s_v, n * 8, kk * 16, g, t);
        mma_16816(dp[n], ado, b0, b1);
      }
    }

    // dS = P∘(dP − δ), into s. With ALiBi: the bias of this lane's first
    // key of the tile less each row's LSE, formed once a tile
    float base[2] = {0.f, 0.f};
    if (ALIBI) {
      const float bias_t = alibi_bias2(slope2, k0 + 2 * t, p.kv_len);
      base[0] = bias_t - lse2[0];
      base[1] = bias_t - lse2[1];
    }
#pragma unroll
    for (int n = 0; n < kDqTileK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + 2 * t + (i & 1);
        const int row = (i < 2) ? row_a : row_b;
        const bool ok =
            col < p.kv_len && row < p.sq && (!CAUSAL || col <= row);
        float pr = 0.f;
        if (ok) {
          pr = exp2f(ALIBI ? alibi_logit2(s[n][i], p.scale_log2, slope2,
                                          n * 8 + (i & 1), base[i >> 1])
                           : s[n][i] * p.scale_log2 - lse2[i >> 1]);
        }
        s[n][i] = pr * (dp[n][i] - dl[i >> 1]);
      }
    }

    // dQ += dS·K
#pragma unroll
    for (int kk = 0; kk < kDqTileK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_cols<kLd>(b0, b1, s_k, kk * 16, n * 8, g, t);
        mma_16816(dq[n], a, b0, b1);
      }
    }
  }

  bf16* dq_b = p.dq + q_off;
  if (row_a < p.sq) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dq_b + row_a * q_rs + n * 8 + 2 * t) =
          pack_f32(dq[n][0] * p.scale, dq[n][1] * p.scale);
    }
  }
  if (row_b < p.sq) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dq_b + row_b * q_rs + n * 8 + 2 * t) =
          pack_f32(dq[n][2] * p.scale, dq[n][3] * p.scale);
    }
  }
}

// Kernel 6. grid (ceil(Skv / 64), KV, B).
template <int D, bool CAUSAL, bool ALIBI>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const BwdArgs p) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_v = s_k + kDkvBlockK * kLd;
  bf16* s_q = s_v + kDkvBlockK * kLd;
  bf16* s_do = s_q + kDkvTileQ * kLd;
  float* s_lse = reinterpret_cast<float*>(s_do + kDkvTileQ * kLd);
  float* s_dl = s_lse + kDkvTileQ;

  const int k0 = blockIdx.x * kDkvBlockK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.heads / p.kv_heads;
  const long q_rs = static_cast<long>(p.heads) * D;
  const long kv_rs = static_cast<long>(p.kv_heads) * D;
  const long kv_off = static_cast<long>(b) * p.skv * kv_rs + kvh * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;
  const int key_a = k0 + r0 + g;  // this thread's two keys
  const int key_b = key_a + 8;

  load_tile<D, kDkvBlockK, kThreads>(s_k, p.k + kv_off, kv_rs, k0, p.kv_len);
  load_tile<D, kDkvBlockK, kThreads>(s_v, p.v + kv_off, kv_rs, k0, p.kv_len);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  // causal: no query before the block's first key sees any of its keys
  const int q_start = CAUSAL ? (k0 / kDkvTileQ) * kDkvTileQ : 0;
  const int n_q_tiles = (k0 < p.kv_len && q_start < p.sq)
                            ? (p.sq - q_start + kDkvTileQ - 1) / kDkvTileQ
                            : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const long q_off = static_cast<long>(b) * p.sq * q_rs + h * D;
    const float* lse_b = p.lse + (static_cast<long>(b) * p.heads + h) * p.sq;
    const float* delta_b =
        p.delta + (static_cast<long>(b) * p.heads + h) * p.sq;
    // the bias of this lane's two keys under the QUERY head's slope (not the
    // kv head's): it changes with every head of the group
    float bias_a = 0.f, bias_b = 0.f;
    if (ALIBI) {
      const float slope2 = p.slopes[b * p.heads + h] * kLog2e;
      bias_a = alibi_bias2(slope2, key_a, p.kv_len);
      bias_b = alibi_bias2(slope2, key_b, p.kv_len);
    }
    for (int qt = 0; qt < n_q_tiles; ++qt) {
      const int q0 = q_start + qt * kDkvTileQ;
      __syncthreads();  // every warp is done with the previous query tile
      load_tile<D, kDkvTileQ, kThreads>(s_q, p.q + q_off, q_rs, q0, p.sq);
      load_tile<D, kDkvTileQ, kThreads>(s_do, p.dout + q_off, q_rs, q0, p.sq);
      if (threadIdx.x < kDkvTileQ) {
        const int r = q0 + threadIdx.x;
        s_lse[threadIdx.x] = r < p.sq ? lse_b[r] * kLog2e : 0.f;
        s_dl[threadIdx.x] = r < p.sq ? delta_b[r] : 0.f;
      }
      __syncthreads();

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, 16 keys x 32 queries per warp
      float st[kDkvTileQ / 8][4], dpt[kDkvTileQ / 8][4];
#pragma unroll
      for (int n = 0; n < kDkvTileQ / 8; ++n) {
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a<kLd>(ak, s_k, r0, kk * 16, g, t);
        load_a<kLd>(av, s_v, r0, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < kDkvTileQ / 8; ++n) {
          uint32_t b0, b1;
          load_b_rows<kLd>(b0, b1, s_q, n * 8, kk * 16, g, t);
          mma_16816(st[n], ak, b0, b1);
          load_b_rows<kLd>(b0, b1, s_do, n * 8, kk * 16, g, t);
          mma_16816(dpt[n], av, b0, b1);
        }
      }

      // Pᵀ into st, dSᵀ = Pᵀ∘(dPᵀ − δ) into dpt (δ and LSE by query column)
#pragma unroll
      for (int n = 0; n < kDkvTileQ / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = n * 8 + 2 * t + (i & 1);
          const int query = q0 + qi;
          const int key = (i < 2) ? key_a : key_b;
          const bool ok =
              key < p.kv_len && query < p.sq && (!CAUSAL || key <= query);
          float pr = 0.f;
          if (ok) {
            pr = exp2f(ALIBI ? fmaf(st[n][i], p.scale_log2,
                                    ((i < 2) ? bias_a : bias_b) - s_lse[qi])
                             : st[n][i] * p.scale_log2 - s_lse[qi]);
          }
          st[n][i] = pr;
          dpt[n][i] = pr * (dpt[n][i] - s_dl[qi]);
        }
      }

      // dV += Pᵀ·dO and dK += dSᵀ·Q
#pragma unroll
      for (int kk = 0; kk < kDkvTileQ / 16; ++kk) {
        uint32_t ap[4], ads[4];
        c_to_a(ap, st[2 * kk], st[2 * kk + 1]);
        c_to_a(ads, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b0, b1;
          load_b_cols<kLd>(b0, b1, s_do, kk * 16, n * 8, g, t);
          mma_16816(dv[n], ap, b0, b1);
          load_b_cols<kLd>(b0, b1, s_q, kk * 16, n * 8, g, t);
          mma_16816(dk[n], ads, b0, b1);
        }
      }
    }
  }

  // keys past kv_len (and whole blocks past it) store zeros
  bf16* dk_b = p.dk + kv_off;
  bf16* dv_b = p.dv + kv_off;
  if (key_a < p.skv) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const long o = key_a * kv_rs + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk_b + o) =
          pack_f32(dk[n][0] * p.scale, dk[n][1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_b + o) = pack_f32(dv[n][0], dv[n][1]);
    }
  }
  if (key_b < p.skv) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const long o = key_b * kv_rs + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk_b + o) =
          pack_f32(dk[n][2] * p.scale, dk[n][3] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_b + o) = pack_f32(dv[n][2], dv[n][3]);
    }
  }
}

template <int D, bool CAUSAL, bool ALIBI>
int launch_dq(const BwdArgs& args, int batch, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, CAUSAL, ALIBI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((args.sq + kDqBlockQ - 1) / kDqBlockQ, args.heads, batch);
  flash_bwd_dq_kernel<D, CAUSAL, ALIBI>
      <<<grid, kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool CAUSAL, bool ALIBI>
int launch_dkv(const BwdArgs& args, int batch, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, CAUSAL, ALIBI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((args.skv + kDkvBlockK - 1) / kDkvBlockK, args.kv_heads,
                  batch);
  flash_bwd_dkv_kernel<D, CAUSAL, ALIBI>
      <<<grid, kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, void* dk, void* dv, const void* slopes, int seq_q,
                  int seq_kv, int heads, int kv_heads, int kv_len,
                  float scale) {
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
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

extern "C" int lvr_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* slopes,
    int batch, int seq_q, int seq_kv, int heads, int kv_heads, int head_dim,
    int kv_len, int causal, float scale, void* stream) {
  const lvr::BwdArgs a =
      lvr::make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, slopes,
                     seq_q, seq_kv, heads, kv_heads, kv_len, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LVR_DISPATCH_BWD(lvr::launch_dq, a, batch, s, head_dim, causal);
}

extern "C" int lvr_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const void* slopes, int batch, int seq_q, int seq_kv, int heads,
    int kv_heads, int head_dim, int kv_len, int causal, float scale,
    void* stream) {
  const lvr::BwdArgs a =
      lvr::make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, slopes,
                     seq_q, seq_kv, heads, kv_heads, kv_len, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LVR_DISPATCH_BWD(lvr::launch_dkv, a, batch, s, head_dim, causal);
}

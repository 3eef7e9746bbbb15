// Pieces shared by the hand-written Hopper attention kernels.
//
// The tile loop below is a FlashAttention-2 style forward: one block of four
// warps owns 64 query rows of one (batch, head); each warp owns 16 of them.
// K/V tiles of 64 keys are staged in shared memory, Q·Kᵀ and P·V run on the
// tensor cores through `mma.sync.m16n8k16` (bf16 in, fp32 accumulate), and the
// softmax is online with fp32 running max, denominator and accumulator kept in
// registers. Logits never leave the SM.
//
// Fragment layout of mma.m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major)  reg0 = A[g][2t..2t+1]     reg1 = A[g+8][2t..2t+1]
//                          reg2 = A[g][2t+8..2t+9]   reg3 = A[g+8][2t+8..2t+9]
//   B (16x8,  "col")      reg0 = B[2t..2t+1][g]     reg1 = B[2t+8..2t+9][g]
//   C (16x8,  fp32)       c0,c1 = C[g][2t..2t+1]    c2,c3 = C[g+8][2t..2t+1]
// The C layout of two neighbouring 8-column S tiles is exactly the A layout of
// one 16-column P tile, so P goes from the accumulator to the next mma without
// touching shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lvr {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy rows [row0, row0 + ROWS) of a strided [*, D] bf16 matrix into shared
// memory with row pitch D + 8 (the pad keeps the fragment reads free of bank
// conflicts). Rows at or past `n_valid` are written as zeros, so a ragged edge
// never reads out of bounds and never feeds garbage (NaN * 0) into an mma.
template <int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* gbase,
                                          long row_stride, int row0,
                                          int n_valid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kLd = D + 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NTHREADS) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    const int gr = row0 + r;
    if (gr < n_valid) {
      val = *reinterpret_cast<const uint4*>(gbase + gr * row_stride + c);
    }
    *reinterpret_cast<uint4*>(smem + r * kLd + c) = val;
  }
}

struct AttnArgs {
  const bf16* q;    // [B, Sq, H, D]
  const bf16* k;    // [B, Skv, KV, D]
  const bf16* v;    // [B, Skv, KV, D]
  bf16* out;        // [B, Sq, H, D]
  float* lse;       // [B, H, Sq] natural-log LSE, or nullptr
  int sq, skv, kv_len, heads, kv_heads;
  float scale_log2;  // softmax scale * log2(e)
  // [B, H] fp32 ALiBi slopes of the query heads; read only by the ALIBI
  // instantiations
  const float* slopes = nullptr;
};

// ALiBi (MPT): logit (i, j) of query head h gains slope[b, h]·(j − (kv_len − 1))
// before the mask. The kernels work in base 2, so the slope is taken times
// log2(e) once. The per-row constant −slope·(kv_len − 1) cancels in the softmax
// but not in the LSE, which is an output: it is kept, so the LSE is the one of
// the biased logits and the backward kernels subtract it from the same
// logits.
//
// An int→float convert a logit would cost as much as eight FMAs, so no kernel
// converts in its inner loop: the caller forms the bias of a base key once
// (a tile's first key of this lane, or in kernel 6 the lane's own two keys)
// with `alibi_bias2`, and a logit `off` keys further on (a constant once the
// loops are unrolled) is `alibi_logit2`: two FMAs where the unbiased kernel
// has one multiply. The base bias is rounded before the offset joins it: an
// error of one ulp of the bias (1.2e-4 at −1,721), far under bf16's rounding
// of P.
__device__ __forceinline__ float alibi_bias2(float slope2, int key,
                                             int kv_len) {
  return slope2 * static_cast<float>(key - (kv_len - 1));
}

// s·scale_log2 + slope2·off + base: `base` is alibi_bias2 of the base key,
// in the backward kernels with the row's LSE already taken off
__device__ __forceinline__ float alibi_logit2(float s, float scale_log2,
                                              float slope2, int off,
                                              float base) {
  return fmaf(s, scale_log2, fmaf(slope2, static_cast<float>(off), base));
}

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;

template <int D>
constexpr int attn_smem_bytes() {
  return (kBlockQ + 2 * kBlockK) * (D + 8) * static_cast<int>(sizeof(bf16));
}

namespace {

// grid (ceil(Sq / 64), H, B); query head h reads kv head h / (H / KV).
// Key j is visible to query i iff j < kv_len and (not CAUSAL or j <= i).
// ALIBI adds the in-kernel bias above; it is a compile-time branch, so the
// instantiations without it are the kernels they were.
template <int D, bool CAUSAL, bool ALIBI = false>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const AttnArgs p) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_k = s_q + kBlockQ * kLd;
  bf16* s_v = s_k + kBlockK * kLd;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const long q_rs = static_cast<long>(p.heads) * D;
  const long kv_rs = static_cast<long>(p.kv_heads) * D;
  const bf16* qb = p.q + b * p.sq * q_rs + h * D;
  const bf16* kb = p.k + b * p.skv * kv_rs + kvh * D;
  const bf16* vb = p.v + b * p.skv * kv_rs + kvh * D;
  bf16* ob = p.out + b * p.sq * q_rs + h * D;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;

  load_tile<D, kBlockQ, kThreads>(s_q, qb, q_rs, q0, p.sq);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* base = s_q + (r0 + g) * kLd + kk * 16 + 2 * t;
    qf[kk][0] = ld32(base);
    qf[kk][1] = ld32(base + 8 * kLd);
    qf[kk][2] = ld32(base + 8);
    qf[kk][3] = ld32(base + 8 * kLd + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const int row_a = q0 + r0 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  float slope2 = 0.f;
  if (ALIBI) slope2 = p.slopes[b * p.heads + h] * kLog2e;

  int kv_end = p.kv_len;
  if (CAUSAL) kv_end = min(kv_end, q0 + kBlockQ);
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D, kBlockK, kThreads>(s_k, kb, kv_rs, k0, p.kv_len);
    load_tile<D, kBlockK, kThreads>(s_v, vb, kv_rs, k0, p.kv_len);
    __syncthreads();

    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        const bf16* kr = s_k + (n * 8 + g) * kLd + kk * 16 + 2 * t;
        mma_16816(s[n], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
    float bias_t = 0.f;  // of this lane's first key of the tile
    if (ALIBI) bias_t = alibi_bias2(slope2, k0 + 2 * t, p.kv_len);
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + 2 * t + (i & 1);
        const int row = (i < 2) ? row_a : row_b;
        const bool ok = col < p.kv_len && (!CAUSAL || col <= row);
        float x = -INFINITY;
        if (ok) {
          x = ALIBI ? alibi_logit2(s[n][i], p.scale_log2, slope2,
                                   n * 8 + (i & 1), bias_t)
                    : s[n][i] * p.scale_log2;
        }
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float mn = fmaxf(m[j], quad_max(mx[j]));
      // a row with nothing visible yet keeps exp2(-inf - 0) = 0 everywhere
      mu[j] = (mn == -INFINITY) ? 0.f : mn;
      alpha[j] = exp2f(m[j] - mu[j]);
      m[j] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = exp2f(s[n][i] - mu[i >> 1]);
        s[n][i] = e;
        rs[i >> 1] += e;
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];  // per-thread partial sums; the four
    l[1] = l[1] * alpha[1] + rs[1];  // threads of a row are summed at the end
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                             pack_f32(s[2 * kk][2], s[2 * kk][3]),
                             pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* vr = s_v + (kk * 16 + 2 * t) * kLd + n * 8 + g;
        mma_16816(o[n], a, pack_bf16(vr[0], vr[kLd]),
                  pack_bf16(vr[8 * kLd], vr[9 * kLd]));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] = quad_sum(l[j]);
    inv[j] = l[j] > 0.f ? 1.f / l[j] : 0.f;
  }
  if (row_a < p.sq) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(ob + row_a * q_rs + n * 8 + 2 * t) =
          pack_f32(o[n][0] * inv[0], o[n][1] * inv[0]);
    }
  }
  if (row_b < p.sq) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(ob + row_b * q_rs + n * 8 + 2 * t) =
          pack_f32(o[n][2] * inv[1], o[n][3] * inv[1]);
    }
  }
  if (p.lse != nullptr && t == 0) {
    float* lb = p.lse + (static_cast<long>(b) * p.heads + h) * p.sq;
    if (row_a < p.sq) lb[row_a] = l[0] > 0.f ? (m[0] + log2f(l[0])) * kLn2 : 0.f;
    if (row_b < p.sq) lb[row_b] = l[1] > 0.f ? (m[1] + log2f(l[1])) * kLn2 : 0.f;
  }
}

// Launch the tile loop for head size D on `stream`; returns cudaGetLastError().
// (Kernel and launcher have internal linkage, so every .cu file that includes
// this header owns its instantiations.)
template <int D, bool CAUSAL, bool ALIBI = false>
int launch_flash_fwd(const AttnArgs& args, int batch, cudaStream_t stream) {
  constexpr int smem = attn_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, CAUSAL, ALIBI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((args.sq + kBlockQ - 1) / kBlockQ, args.heads, batch);
  flash_fwd_kernel<D, CAUSAL, ALIBI><<<grid, kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

}  // namespace lvr

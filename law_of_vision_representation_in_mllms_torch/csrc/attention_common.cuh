// Pieces shared by the hand-written attention kernels: fragment packing,
// quad reductions, the argument block and the ALiBi arithmetic, and the bf16
// `mma.sync` product that kernel 10's small-M body uses. The attention
// kernels (the forward of kernels 1 and 2 in flash_fwd_hopper.cuh, the
// backward of kernels 5 and 6 in flash_attention_bwd.cu) run on wgmma, whose
// register fragments have the layout of mma.m16n8k16's.
//
// Fragment layout of mma.m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major)  reg0 = A[g][2t..2t+1]     reg1 = A[g+8][2t..2t+1]
//                          reg2 = A[g][2t+8..2t+9]   reg3 = A[g+8][2t+8..2t+9]
//   B (16x8,  "col")      reg0 = B[2t..2t+1][g]     reg1 = B[2t+8..2t+9][g]
//   C (16x8,  fp32)       c0,c1 = C[g][2t..2t+1]    c2,c3 = C[g+8][2t..2t+1]
// The C layout of two neighbouring 8-column S tiles is exactly the A layout of
// one 16-column P tile, so P goes from the accumulator to the next product
// without touching shared memory.
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

}  // namespace lvr

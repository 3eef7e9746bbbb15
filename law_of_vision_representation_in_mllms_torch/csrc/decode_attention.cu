// Kernel 3: single-token (decode-step) attention over the KV cache.
//
// Replaces the TPU kernel `ops/decode_attention.py` `decode_attention`
// (`_kernel`, both branches). q is [B, 1, H, Dh]; the cache k/v is read in
// place in its stored [B, T, KV, Dh] layout; query head h reads kv head
// h / (H / KV); `mask` is a [B, T] byte mask (1 = visible) that may have holes
// (the prompt's pad slots) and whole masked stretches. A masked slot is never
// loaded and contributes exactly 0 (the TPU kernel had to multiply by the
// mask because exp(NEG - NEG) = 1 on a fully masked tile). Softmax is fp32.
//
// The cache is bf16 (dense branch) or int8 codes with one fp32 scale per
// (slot, kv head), `k_scale`/`v_scale` [B, T, KV] (int8 branch). There the K
// scale multiplies the slot's logit after the q.k sum, the softmax
// denominator adds up the raw probabilities, and the V scale enters the
// numerator only: out = sum_t p_t * vs_t * v_t / sum_t p_t.
//
// Bound on the H100: a step reads every visible cache byte once, ~0.1 FLOP per
// byte, so HBM bandwidth is the floor (Vicuna-7B, B = 4, T ~ 700: ~46 MB per
// layer in bf16, half that in int8). Design: one block per (kv head, batch
// row); its warps stride over the slots, four slots in flight per warp, each
// lane holding Dh / 32 elements of a row so a warp reads one row (256 bytes of
// bf16, 128 of int8: a 4-byte load a lane) in one coalesced load; every warp
// keeps an online softmax for the G query heads of its kv head, and the warps
// merge through shared memory at the end. At B = 4 there are only 128 blocks
// for 132 SMs, so what hides the HBM latency is the warps inside a block: 32
// of them for G <= 2, 16 for G = 4, 8 for G = 8 (the merge buffer, warps x G x
// Dh floats, stays within 32 KB). Eight warps for every G would make the loop
// over 704 slots 22 dependent rounds of loads: the kernel would run at the
// latency, not the bandwidth, and the int8 branch, which moves half the bytes
// in as many rounds, would be no faster than the dense one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kUnroll = 4;
constexpr float kLog2e = 1.4426950408889634f;

template <int VPL>
__device__ __forceinline__ void load_row(const bf16* p, float out[VPL]) {
  if constexpr (VPL == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    out[0] = __low2float(a);
    out[1] = __high2float(a);
    out[2] = __low2float(b);
    out[3] = __high2float(b);
  } else {
    static_assert(VPL == 2, "head_dim must be 64 or 128");
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
    out[0] = __low2float(a);
    out[1] = __high2float(a);
  }
}

// int8 codes: Dh / 32 of them a lane, one 4-byte (or 2-byte) load
template <int VPL>
__device__ __forceinline__ void load_row(const int8_t* p, float out[VPL]) {
  if constexpr (VPL == 4) {
    const char4 raw = *reinterpret_cast<const char4*>(p);
    out[0] = static_cast<float>(raw.x);
    out[1] = static_cast<float>(raw.y);
    out[2] = static_cast<float>(raw.z);
    out[3] = static_cast<float>(raw.w);
  } else {
    static_assert(VPL == 2, "head_dim must be 64 or 128");
    const char2 raw = *reinterpret_cast<const char2*>(p);
    out[0] = static_cast<float>(raw.x);
    out[1] = static_cast<float>(raw.y);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// KV = bf16: dense cache, the scale pointers are not read. KV = int8_t: codes
// with `k_scale`/`v_scale` [B, T, KV].
template <int DH, int G, typename KV, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    decode_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
                  const KV* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                  int T, int kv_heads, float scale_log2) {
  constexpr int VPL = DH / 32;
  constexpr bool kQuant = sizeof(KV) == 1;
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][DH];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int heads = kv_heads * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float qv[G][VPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const bf16* qp =
        q + (static_cast<long>(b) * heads + kvh * G + gi) * DH + lane * VPL;
    load_row<VPL>(qp, qv[gi]);
#pragma unroll
    for (int i = 0; i < VPL; ++i) qv[gi][i] *= scale_log2;
  }
  float m[G], l[G], acc[G][VPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[gi][i] = 0.f;
  }

  const long rs = static_cast<long>(kv_heads) * DH;  // slot stride
  const KV* kb = k + static_cast<long>(b) * T * rs + kvh * DH + lane * VPL;
  const KV* vb = v + static_cast<long>(b) * T * rs + kvh * DH + lane * VPL;
  const uint8_t* mb = mask + static_cast<long>(b) * T;
  // scale of slot tt: [b, tt, kvh]
  const long sc0 = static_cast<long>(b) * T * kv_heads + kvh;

  for (int t0 = warp * kUnroll; t0 < T; t0 += kWarps * kUnroll) {
    float kr[kUnroll][VPL], vr[kUnroll][VPL];
    float ks[kUnroll], vs[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = t0 + u;
      ok[u] = tt < T && mb[tt] != 0;  // same for every lane of the warp
      if (ok[u]) {
        load_row<VPL>(kb + tt * rs, kr[u]);
        load_row<VPL>(vb + tt * rs, vr[u]);
        if constexpr (kQuant) {
          ks[u] = k_scale[sc0 + static_cast<long>(tt) * kv_heads];
          vs[u] = v_scale[sc0 + static_cast<long>(tt) * kv_heads];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VPL; ++i) s += qv[gi][i] * kr[u][i];
        s = warp_sum(s);
        if constexpr (kQuant) s *= ks[u];
        const float mn = fmaxf(m[gi], s);
        const float alpha = exp2f(m[gi] - mn);  // 0 while m is still -inf
        const float pr = exp2f(s - mn);
        l[gi] = l[gi] * alpha + pr;  // the raw probability
        float pv = pr;
        if constexpr (kQuant) pv *= vs[u];
#pragma unroll
        for (int i = 0; i < VPL; ++i) acc[gi][i] = acc[gi][i] * alpha + pv * vr[u][i];
        m[gi] = mn;
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      sm_m[warp][gi] = m[gi];
      sm_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) sm_acc[warp][gi][lane * VPL + i] = acc[gi][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * DH; idx += kWarps * 32) {
    const int gi = idx / DH;
    const int d = idx % DH;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][gi]);
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float sc = exp2f(sm_m[w][gi] - mx);  // 0 for a warp that saw nothing
        num += sm_acc[w][gi][d] * sc;
        den += sm_l[w][gi] * sc;
      }
    }
    out[(static_cast<long>(b) * heads + kvh * G + gi) * DH + d] =
        __float2bfloat16(den > 0.f ? num / den : 0.f);
  }
}

// warps a block: as many as keep the merge buffer within 32 KB, at most 32
constexpr int warps_for(int group) { return group <= 2 ? 32 : 64 / group; }

template <int DH, int G, typename KV>
void launch_g(const bf16* q, const KV* k, const KV* v, const float* k_scale,
              const float* v_scale, const uint8_t* mask, bf16* out, int batch,
              int T, int kv_heads, float scale_log2, cudaStream_t stream) {
  constexpr int kWarps = warps_for(G);
  decode_kernel<DH, G, KV, kWarps>
      <<<dim3(kv_heads, batch), dim3(kWarps * 32), 0, stream>>>(
          q, k, v, k_scale, v_scale, mask, out, T, kv_heads, scale_log2);
}

template <int DH, typename KV>
int launch_dh(const bf16* q, const KV* k, const KV* v, const float* k_scale,
              const float* v_scale, const uint8_t* mask, bf16* out, int batch,
              int T, int kv_heads, int group, float scale_log2,
              cudaStream_t stream) {
  switch (group) {
    case 1:
      launch_g<DH, 1, KV>(q, k, v, k_scale, v_scale, mask, out, batch, T,
                          kv_heads, scale_log2, stream);
      break;
    case 2:
      launch_g<DH, 2, KV>(q, k, v, k_scale, v_scale, mask, out, batch, T,
                          kv_heads, scale_log2, stream);
      break;
    case 4:
      launch_g<DH, 4, KV>(q, k, v, k_scale, v_scale, mask, out, batch, T,
                          kv_heads, scale_log2, stream);
      break;
    case 8:
      launch_g<DH, 8, KV>(q, k, v, k_scale, v_scale, mask, out, batch, T,
                          kv_heads, scale_log2, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* mask, void* out, int batch, int T,
           int heads, int kv_heads, int head_dim, float scale, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = heads / kv_heads;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const KV*>(k);
  const auto* vp = static_cast<const KV*>(v);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* op = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  switch (head_dim) {
    case 64:
      return launch_dh<64, KV>(qp, kp, vp, ksp, vsp, mp, op, batch, T,
                               kv_heads, group, sl2, s);
    case 128:
      return launch_dh<128, KV>(qp, kp, vp, ksp, vsp, mp, op, batch, T,
                                kv_heads, group, sl2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dense bf16 cache
extern "C" int lvr_decode_attention(const void* q, const void* k,
                                    const void* v, const void* mask, void* out,
                                    int batch, int T, int heads, int kv_heads,
                                    int head_dim, float scale, void* stream) {
  return launch<bf16>(q, k, v, nullptr, nullptr, mask, out, batch, T, heads,
                      kv_heads, head_dim, scale, stream);
}

// int8 codes [B, T, KV, Dh] with fp32 scales [B, T, KV]
extern "C" int lvr_decode_attention_int8(const void* q, const void* k,
                                         const void* v, const void* k_scale,
                                         const void* v_scale, const void* mask,
                                         void* out, int batch, int T,
                                         int heads, int kv_heads, int head_dim,
                                         float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<int8_t>(q, k, v, k_scale, v_scale, mask, out, batch, T, heads,
                        kv_heads, head_dim, scale, stream);
}

extern "C" const char* lvr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

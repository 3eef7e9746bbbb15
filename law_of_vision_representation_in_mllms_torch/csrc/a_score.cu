// Kernel 9: masked mean-of-row-max cosine similarity (the A score's hot op).
//
// Replaces the TPU kernel `ops/a_score_pallas.py` `max_cos_pallas` (`_kernel`)
// and adds the validity masks of `metrics/a_score.py` `max_cos_similarity`.
// Per image n, with target [N, St, D] and anchor [N, Sa, D] (fp32, bf16 or
// fp16 in, fp32 math):
//
//   out[n] = sum_{valid t} max_{valid a} <t, a> / ((|t| + eps)(|a| + eps))
//            / max(#valid t, 1)
//
// eps = 1e-10 is added to the norm (not under the root, not to the product).
// A masked anchor column counts as -inf in the row max, a masked target row
// adds 0. The [St, Sa] similarity matrix, the norms and the normalised rows
// never reach global memory.
//
// The TPU kernel runs one program per image with the whole [St, Sa] tile in
// VMEM and carries its sums across a sequential D grid. Neither carries over:
// 576 x 576 fp32 does not fit an SM and blocks run in no order. Here a block
// owns one image and 64 target rows. It walks the anchor rows in tiles of 64
// and, inside, D in chunks of 16 through double-buffered shared memory (the
// next chunk's global loads are in flight while the current one is multiplied),
// keeping a 64 x 64 fp32 tile in registers, 4 x 4 a thread. The squared norms
// are summed by the thread that stages a row's elements, so they cost no extra
// read. After each anchor tile the block divides, masks and folds into a running
// row max. Each block writes its tile's masked sum and row count to
// `partial[n, tile]`; a second tiny kernel adds the tiles in fixed order, so
// two runs give the same bits (no atomics).
//
// Bound on the H100: at N = 100, St = Sa = 576, D = 4096 in fp32 the call is
// 272 GFLOP over 1.89 GB of inputs: ~0.56 ms of HBM time against ~4.1 ms at
// the 67 TFLOP/s of plain fp32 FMAs, which is what an fp32-exact kernel can
// use. So it is bound by operations. The grid is image-major (the tile index
// varies fastest), so the nine blocks that reread one image's anchor run
// together and the rereads are served by L2.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // target rows a block, anchor rows a step
constexpr int kChunk = 16;         // D elements staged per step
constexpr int kPitch = kTile + 4;  // keeps float4 reads aligned
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr float kEps = 1e-10f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load1(const __half* p) {
  return __half2float(*p);
}

// Four consecutive elements of a row from column k, zero past D or for a row
// outside the array. `vec`: rows are aligned for one vector load and D % 4 == 0.
template <typename T>
__device__ __forceinline__ float4 fetch(const T* row, bool row_ok, int k,
                                        int d, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!row_ok || k >= d) return v;
  if (vec) return load4(row + k);
  v.x = load1(row + k);
  if (k + 1 < d) v.y = load1(row + k + 1);
  if (k + 2 < d) v.z = load1(row + k + 2);
  if (k + 3 < d) v.w = load1(row + k + 3);
  return v;
}

// Stage a thread's four elements k-major (tile[k][row]) and add their squares.
__device__ __forceinline__ void stash(float (*tile)[kPitch], int k, int row,
                                      const float4& v, float& sumsq) {
  tile[k + 0][row] = v.x;
  tile[k + 1][row] = v.y;
  tile[k + 2][row] = v.z;
  tile[k + 3][row] = v.w;
  sumsq += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
a_score_tile_kernel(const T* __restrict__ target, const T* __restrict__ anchor,
                    const uint8_t* __restrict__ tmask,
                    const uint8_t* __restrict__ amask,
                    float* __restrict__ psum, float* __restrict__ pcnt, int st,
                    int sa, int d, int vec) {
  __shared__ __align__(16) float ts[2][kChunk][kPitch];
  __shared__ __align__(16) float as[2][kChunk][kPitch];
  __shared__ float tnorm[kTile], anorm[kTile], rmax[kTile];

  const int tile = blockIdx.x, n = blockIdx.y, tiles = gridDim.x;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;       // output columns / rows
  const int lrow = tid >> 2, lk = (tid & 3) * 4;  // staging row / column
  const int chunks = (d + kChunk - 1) / kChunk;

  const int t_row = tile * kTile + lrow;
  const bool t_ok = t_row < st;
  const T* t_ptr =
      target + (static_cast<size_t>(n) * st + (t_ok ? t_row : 0)) * d;

  float row_max[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) row_max[i] = -INFINITY;

  for (int a0 = 0; a0 < sa; a0 += kTile) {
    const int a_row = a0 + lrow;
    const bool a_ok = a_row < sa;
    const T* a_ptr =
        anchor + (static_cast<size_t>(n) * sa + (a_ok ? a_row : 0)) * d;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float t_sq = 0.f, a_sq = 0.f;

    float4 tv = fetch(t_ptr, t_ok, lk, d, vec);
    float4 av = fetch(a_ptr, a_ok, lk, d, vec);
    stash(ts[0], lk, lrow, tv, t_sq);
    stash(as[0], lk, lrow, av, a_sq);
    __syncthreads();

    for (int c = 0; c < chunks; ++c) {
      const int buf = c & 1;
      const bool more = c + 1 < chunks;
      if (more) {
        tv = fetch(t_ptr, t_ok, (c + 1) * kChunk + lk, d, vec);
        av = fetch(a_ptr, a_ok, (c + 1) * kChunk + lk, d, vec);
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&ts[buf][k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&as[buf][k][tx * 4]);
        const float av4[4] = {a.x, a.y, a.z, a.w};
        const float bv4[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av4[i], bv4[j], acc[i][j]);
      }
      if (more) {
        // the other buffer was last read before the previous barrier
        stash(ts[buf ^ 1], lk, lrow, tv, t_sq);
        stash(as[buf ^ 1], lk, lrow, av, a_sq);
      }
      __syncthreads();
    }

    // a row's squares sit in the four threads that staged it
    t_sq += __shfl_xor_sync(0xffffffffu, t_sq, 1);
    t_sq += __shfl_xor_sync(0xffffffffu, t_sq, 2);
    a_sq += __shfl_xor_sync(0xffffffffu, a_sq, 1);
    a_sq += __shfl_xor_sync(0xffffffffu, a_sq, 2);
    if ((tid & 3) == 0) {
      tnorm[lrow] = sqrtf(t_sq) + kEps;
      anorm[lrow] = sqrtf(a_sq) + kEps;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = a0 + tx * 4 + j;
      const bool ok =
          col < sa &&
          (amask == nullptr || amask[static_cast<size_t>(n) * sa + col] != 0);
      if (ok) {
        const float an = anorm[tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float cosv = acc[i][j] / (tnorm[ty * 4 + i] * an);
          row_max[i] = fmaxf(row_max[i], cosv);
        }
      }
    }
    // tnorm/anorm are rewritten only after the next tile's barriers
  }

  // the 16 threads of one `ty` are 16 consecutive lanes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      row_max[i] =
          fmaxf(row_max[i], __shfl_xor_sync(0xffffffffu, row_max[i], off));
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) rmax[ty * 4 + i] = row_max[i];
  }
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f, count = 0.f;
    for (int r = 0; r < kTile; ++r) {
      const int row = tile * kTile + r;
      if (row < st &&
          (tmask == nullptr || tmask[static_cast<size_t>(n) * st + row] != 0)) {
        sum += rmax[r];
        count += 1.f;
      }
    }
    psum[static_cast<size_t>(n) * tiles + tile] = sum;
    pcnt[static_cast<size_t>(n) * tiles + tile] = count;
  }
}

__global__ void a_score_finish_kernel(const float* __restrict__ psum,
                                      const float* __restrict__ pcnt,
                                      float* __restrict__ out, int n_images,
                                      int tiles) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_images) return;
  float sum = 0.f, count = 0.f;
  for (int t = 0; t < tiles; ++t) {
    sum += psum[static_cast<size_t>(n) * tiles + t];
    count += pcnt[static_cast<size_t>(n) * tiles + t];
  }
  out[n] = sum / fmaxf(count, 1.f);
}

template <typename T>
int launch(const void* target, const void* anchor, const void* tmask,
           const void* amask, void* psum, void* pcnt, void* out, int n, int st,
           int sa, int d, int vec, cudaStream_t stream) {
  const int tiles = (st + kTile - 1) / kTile;
  const dim3 grid(tiles, n);
  a_score_tile_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(target), static_cast<const T*>(anchor),
      static_cast<const uint8_t*>(tmask), static_cast<const uint8_t*>(amask),
      static_cast<float*>(psum), static_cast<float*>(pcnt), st, sa, d, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  a_score_finish_kernel<<<(n + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(psum), static_cast<const float*>(pcnt),
      static_cast<float*>(out), n, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16. tmask / amask: [N, St] / [N, Sa] bytes
// (1 = valid) or null. psum, pcnt: [N, ceil(St / 64)] fp32 scratch. out: [N]
// fp32. vec: rows may be read with one 4-element vector load.
extern "C" int lvr_a_score(const void* target, const void* anchor,
                           const void* tmask, const void* amask, void* psum,
                           void* pcnt, void* out, int n, int st, int sa, int d,
                           int dtype, int vec, void* stream) {
  if (n <= 0 || st <= 0 || sa <= 0 || d <= 0 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(target, anchor, tmask, amask, psum, pcnt, out, n,
                           st, sa, d, vec, s);
    case 1:
      return launch<__nv_bfloat16>(target, anchor, tmask, amask, psum, pcnt,
                                   out, n, st, sa, d, vec, s);
    case 2:
      return launch<__half>(target, anchor, tmask, amask, psum, pcnt, out, n,
                            st, sa, d, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

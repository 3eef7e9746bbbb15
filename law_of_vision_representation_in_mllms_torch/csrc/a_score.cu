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
// 576 x 576 fp32 does not fit an SM and blocks run in no order. Two bodies,
// chosen by the wrapper (`ops/a_score.py` `a_score_body`) from dtype and
// shape alone; each writes small per-block partials (sums and counts, or row
// maxima) that a second tiny kernel reduces in a fixed order, so two runs
// give the same bits (no atomics).
//
// Bound on the H100: at N = 100, St = Sa = 576, D = 4096 in fp32 the call is
// 272 GFLOP over 1.89 GB of inputs: ~0.56 ms of HBM time against ~4.1 ms at
// the 67 TFLOP/s of plain fp32 FMAs, and 1.65 ms for the three TF32 products
// of an fp32-accurate product on the tensor cores (495 TFLOP/s). So it is
// bound by operations. Both grids are image-major (the block index varies
// fastest), so the blocks that reread one image's rows run together and the
// rereads are served by L2.
//
// fp32 inputs with D % 4 == 0 and 16-byte-aligned bases: 3xTF32 `wgmma`
// (`a_score_tf32_kernel`). Each operand is split as x = hi + lo, both TF32
// (hi = rna(x), lo = rna(x - hi), x - hi exact), and every k8 step issues
// three products into one fp32 accumulator, the small ones first:
// hi(t) lo(a) + lo(t) hi(a) + hi(t) hi(a). One TF32 product alone erred by
// 1.1e-5 to 1.3e-5 on near-duplicate anchors and on target = anchor,
// against a tolerance of 1e-5; three by 1.8e-7 to 4.2e-7. The tensor cores
// add into their accumulator by truncation, so a stage's 12 products go into
// a fresh accumulator that is then added, rounding to nearest, into the
// running one (one accumulator for all of D erred by up to 3.6e-5).
// A block computes one [128 target, 128 anchor] tile of one image over all
// of D, as a GEMM does: a block that walked every anchor tile for its
// target rows reread the target from HBM, not L2 (132 blocks in flight
// stream ~0.5 GB between two passes over one target tile). Two warpgroups of 64 target rows, 202 registers a thread (two
// accumulators of 64, the fragments of a stage 32; a producer warpgroup
// would cap the block at 168, and ptxas then serialised the products to fit
// them). D walks in stages of 32 fp32 (one 128-byte swizzled row) through a
// ring of four that thread 0 fills by TMA from rank-3 [N, S, D] maps, so a
// box past S or D reads zeros, never the next image's rows. A stage:
// - both warpgroups load their target fragments by ldmatrix (an 8 x 4 fp32
//   block is an 8 x 8 b16 matrix in the TF32 A-fragment layout), split them
//   in registers, add their squares into the target norms, and issue the 12
//   products of the stage, `m64n128k8` (or `m64n64k8` where at most 64
//   anchor rows are left; Sa = 576's last block);
// - while the products run, all 256 threads split the next stage's anchor:
//   hi over the raw fp32 in place, lo into a tile of its own (wgmma reads B
//   from shared memory only), and each row's squares into its norm, then a
//   fence to the async proxy;
// - acc += part, one named barrier, and thread 0 refills the stage.
// A warpgroup whose 64 rows lie past St (St = 576's last block) splits and
// waits but issues no product. At the end the block folds acc / (|a| + eps)
// into a row max (a column past Sa or masked out never counts, so a
// zero-filled column cannot beat negative cosines), divides it by |t| + eps
// (> 0, so the max commutes), and writes [N, ceil(Sa / 128), St] row maxima;
// the finish kernel takes the max over anchor blocks and the masked mean.
// Every max keeps NaN, as the reference's does: a NaN or Inf in a valid row
// makes its products NaN (Inf splits into hi = Inf, lo = NaN), and a NaN or
// Inf anchor norm (1 / (|a| + eps) NaN or 0) still counts, so the affected
// rows' max, and the image's score, come out NaN. A masked-out row's values
// reach no max and no sum. The [St, Sa] matrix, the norms and the split
// copies never reach global memory. What bounds it (PERF.md, section 6):
// shared memory. A stage moves 192 KB through it (the products read B 96
// KB, TMA writes 32, the split reads 16 and writes 32, ldmatrix reads 16)
// against 1,536 cycles of products at the TF32 peak, 125 bytes a cycle of
// the 128 a shared memory gives.
//
// Other inputs (bf16, fp16, or fp32 that TMA cannot take): SIMT FMAs
// (`a_score_tile_kernel`). A block owns one image and 64 target rows. It
// walks the anchor rows in tiles of 64 and, inside, D in chunks of 16
// through double-buffered shared memory (the next chunk's global loads are
// in flight while the current one is multiplied), keeping a 64 x 64 fp32
// tile in registers, 4 x 4 a thread. The squared norms are summed by the
// thread that stages a row's elements, so they cost no extra read. After
// each anchor tile the block divides, masks and folds into a running row
// max.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

namespace hp = lvr::hopper;

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

// max(a, b), NaN if either is NaN (`fmaxf` returns the other operand): the
// reference's `jnp.max` / `torch.amax` carry a NaN cosine into the score
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
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
          row_max[i] = max_nan(row_max[i], cosv);
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
          max_nan(row_max[i], __shfl_xor_sync(0xffffffffu, row_max[i], off));
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

// ---- fp32 inputs: 3xTF32 wgmma ---------------------------------------------
constexpr int kRows = 128;                   // target rows a block
constexpr int kCols = 128;                   // anchor rows a block
constexpr int kK = 32;                       // fp32 of D a stage (128 bytes)
constexpr int kStages = 4;
constexpr int kThreadsTf32 = 256;            // two warpgroups
constexpr int kTile32 = kRows * kK * 4;      // [128, 32] fp32: 16 KB
// a stage: target [128, 32], anchor hi [128, 32] (over the raw fp32) and
// anchor lo [128, 32], each 128-byte swizzled; stages start on 1024-byte
// boundaries, the swizzle's period. Then 1 / (|a| + eps) of the block's
// anchor rows and the stages' mbarriers.
constexpr int kOffHi = kTile32;
constexpr int kOffLo = 2 * kTile32;
constexpr int kStage = 3 * kTile32;
constexpr int kOffRinv = kStages * kStage;
constexpr int kOffBar = kOffRinv + kCols * 4;
constexpr int kSmemTf32 = kOffBar + kStages * 8 + 1024;

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  if constexpr (N == 128) {
    hp::wgmma_m64n128k8_tf32_rs(d, a, db, accumulate);
  } else {
    hp::wgmma_m64n64k8_tf32_rs(d, a, db, accumulate);
  }
}

// Split stage `it` of the anchor in place: hi over the raw fp32, lo into its
// own tile, and the squares of each element into its row's sum. Thread c
// takes the float4 column c % 8 of rows c / 8 + 32 i, so the 8 threads of a
// row are 8 consecutive lanes and a warp reads 4 whole 128-byte rows an
// instruction (no bank conflict beyond the 4 wavefronts of 512 bytes). Only
// the first `rows` rows are split: the products read no others.
__device__ __forceinline__ void split_anchor(uint8_t* ring, int it, int rows,
                                             float (&sq)[4]) {
  uint8_t* hi = ring + it % kStages * kStage + kOffHi;
  uint8_t* lo = ring + it % kStages * kStage + kOffLo;
  const int col4 = threadIdx.x & 7, row0 = threadIdx.x >> 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 32 * i;
    if (r < rows) {
      const int off = r * 128 + ((col4 ^ (r & 7)) << 4);
      const float4 x = *reinterpret_cast<const float4*>(hi + off);
      const float v[4] = {x.x, x.y, x.z, x.w};
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = hp::tf32_rna(v[e]);
        l[e] = hp::tf32_rna(v[e] - __uint_as_float(h[e]));
        sq[i] = fmaf(v[e], v[e], sq[i]);
      }
      *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
  hp::fence_proxy_async();     // wgmma reads what the generic proxy wrote
}

// The block's walk over D (see a_score_tf32_kernel). N: the products' width,
// 128, or 64 for an anchor block with at most 64 rows left; 0 for a
// warpgroup whose 64 target rows all lie past St, which splits and waits
// but issues no product. One straight loop for each, so that no branch sits
// among the products (ptxas serialises wgmma on a divergent path).
// The tensor cores add into their fp32 accumulator by truncation: over the
// 1,536 products of D = 4096 that biased cosines near 1 by up to 3.6e-5. So
// a stage's 12 products go into `part`, and acc += part rounds to nearest.
template <int N>
__device__ __forceinline__ void tf32_walk(
    float (&acc)[kCols / 2], float (&sq)[4], float& tsq0, float& tsq1,
    uint32_t base, uint8_t* ring, const CUtensorMap* t_map,
    const CUtensorMap* a_map, int chunks, int rows, int m0, int a0, int n) {
  const uint32_t full = base + kOffBar;
  const int c = threadIdx.x, lane = c & 31;
  // lane l gives ldmatrix the row of matrix l / 8: rows r and r + 8 (l / 8
  // odd), columns 0-3 and 4-7 (l / 16) of a k8 step, so that register e of
  // the result is the A fragment's a[e]; element (r, k) of the swizzled
  // target tile lies at r * 128 + ((k / 4) ^ (r % 8)) * 16 + (k % 4) * 4
  const uint32_t lrow_addr = base + ((c >> 5) * 16 + (lane & 15)) * 128;
  const int lchunk = lane >> 4, lswz = lane & 7;
  float part[N > 0 ? N / 2 : 1];
#pragma unroll
  for (int i = 0; i < (N > 0 ? N / 2 : 1); ++i) part[i] = 0.f;
  for (int it = 0; it < chunks; ++it) {
    const int s = it % kStages;
    uint32_t hi[4][4], lo[4][4];
    if constexpr (N > 0) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t x[4];
        hp::ldmatrix_x4(x, lrow_addr + s * kStage +
                               (((2 * ks + lchunk) ^ lswz) << 4));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __uint_as_float(x[e]);
          hi[ks][e] = hp::tf32_rna(v);
          lo[ks][e] = hp::tf32_rna(v - __uint_as_float(hi[ks][e]));
        }
        const float v0 = __uint_as_float(x[0]), v1 = __uint_as_float(x[1]);
        const float v2 = __uint_as_float(x[2]), v3 = __uint_as_float(x[3]);
        tsq0 = fmaf(v0, v0, fmaf(v2, v2, tsq0));
        tsq1 = fmaf(v1, v1, fmaf(v3, v3, tsq1));
      }
      const uint32_t ah = base + s * kStage + kOffHi;
      const uint32_t al = base + s * kStage + kOffLo;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        hp::fence_regs(hi[ks]);
        hp::fence_regs(lo[ks]);
      }
      hp::fence_regs(part);
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t dh = hp::sw128_desc(ah + 32 * ks, 16, 1024);
        const uint64_t dl = hp::sw128_desc(al + 32 * ks, 16, 1024);
        wgmma_tf32<N>(part, hi[ks], dl, ks > 0);
        wgmma_tf32<N>(part, lo[ks], dh, 1);
        wgmma_tf32<N>(part, hi[ks], dh, 1);
      }
      hp::wgmma_commit();
    }
    // while the products run: the next stage's anchor
    if (it + 1 < chunks) {
      hp::mbar_wait(full + 8 * ((it + 1) % kStages),
                    ((it + 1) / kStages) & 1);
      split_anchor(ring, it + 1, rows, sq);
    }
    if constexpr (N > 0) {
      hp::fence_regs(part);
      hp::wgmma_wait<0>();
      hp::fence_regs(part);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        hp::fence_regs(hi[ks]);
        hp::fence_regs(lo[ks]);
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
    }
    // both warpgroups are done with stage it, and stage it + 1 is split
    hp::bar_sync(1, kThreadsTf32);
    if (c == 0 && it + kStages < chunks) {
      const uint32_t bar = full + 8 * s, dst = base + s * kStage;
      hp::mbar_arrive_expect_tx(bar, 2 * kTile32);
      hp::tma_load_3d(dst, t_map, bar, (it + kStages) * kK, m0, n);
      hp::tma_load_3d(dst + kOffHi, a_map, bar, (it + kStages) * kK, a0, n);
    }
  }
}

// Block (x, n) computes target rows 128 (x % tiles_t) .. + 127 of image n
// against anchor rows 128 (x / tiles_t) .. + 127 and writes, for each of its
// target rows, max over its valid anchor rows of <t, a> / ((|t| + eps)
// (|a| + eps)) to rowmax[n, x / tiles_t, row] (-inf if none is valid).
// Two warpgroups, each 64 target rows x 128 anchor rows; thread 0 also
// issues the TMA loads, four stages ahead.
__global__ void __launch_bounds__(kThreadsTf32, 1)
    a_score_tf32_kernel(const __grid_constant__ CUtensorMap t_map,
                        const __grid_constant__ CUtensorMap a_map,
                        const uint8_t* __restrict__ amask,
                        float* __restrict__ rowmax, int st, int sa, int d,
                        int tiles_t) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (hp::smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* ring = smem + (base - hp::smem_u32(smem));
  const uint32_t full = base + kOffBar;        // TMA landed
  const int n = blockIdx.y, at = blockIdx.x / tiles_t;
  const int m0 = blockIdx.x % tiles_t * kRows, a0 = at * kCols;
  const int chunks = (d + kK - 1) / kK;
  const int c = threadIdx.x, lane = c & 31, g = lane >> 2, t4 = lane & 3;
  if (c == 0) {
    for (int s = 0; s < kStages; ++s) hp::mbar_init(full + 8 * s, 1);
    hp::fence_barrier_init();
  }
  __syncthreads();
  if (c == 0) {
    for (int it = 0; it < kStages && it < chunks; ++it) {
      const uint32_t bar = full + 8 * it, dst = base + it * kStage;
      hp::mbar_arrive_expect_tx(bar, 2 * kTile32);
      hp::tma_load_3d(dst, &t_map, bar, it * kK, m0, n);
      hp::tma_load_3d(dst + kOffHi, &a_map, bar, it * kK, a0, n);
    }
  }
  // an anchor block with at most 64 rows left (Sa = 576: the last) takes the
  // products at N = 64, and only its first 64 rows are split
  const bool narrow = sa - a0 <= 64;
  const int rows = narrow ? 64 : kCols;
  float sq[4] = {0.f, 0.f, 0.f, 0.f};
  hp::mbar_wait(full, 0);
  split_anchor(ring, 0, rows, sq);
  hp::bar_sync(1, kThreadsTf32);

  // warpgroup wg owns target rows 64wg..64wg+63 of the block; a lane's A
  // rows are r0 and r0 + 8, which are also its accumulator rows
  const int r0 = (c >> 5) * 16 + g;
  float acc[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
  float tsq0 = 0.f, tsq1 = 0.f;
  // a warpgroup whose 64 rows all lie past St (St = 576: the second half of
  // the last row block) computes nothing
  const bool live = m0 + (c >> 7) * 64 < st;
  if (!live) {
    tf32_walk<0>(acc, sq, tsq0, tsq1, base, ring, &t_map, &a_map, chunks,
                 rows, m0, a0, n);
  } else if (narrow) {
    tf32_walk<64>(acc, sq, tsq0, tsq1, base, ring, &t_map, &a_map, chunks,
                  rows, m0, a0, n);
  } else {
    tf32_walk<128>(acc, sq, tsq0, tsq1, base, ring, &t_map, &a_map, chunks,
                   rows, m0, a0, n);
  }

  // the anchor rows' 1 / (|a| + eps) (0 or NaN for a non-finite row, which
  // still counts), -1 for a row past Sa or masked out; a row's 8 threads are
  // lanes 8k..8k+7
  float* rinv = reinterpret_cast<float*>(ring + kOffRinv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = sq[i];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    const int r = (c >> 3) + 32 * i, col = a0 + r;
    const bool ok = col < sa && (amask == nullptr ||
                                 amask[static_cast<size_t>(n) * sa + col] != 0);
    if ((c & 7) == 0) rinv[r] = ok ? 1.f / (sqrtf(v) + kEps) : -1.f;
  }
  hp::bar_sync(1, kThreadsTf32);
  if (!live) return;

  // acc[4j + 2h + e] is row r0 + 8h, column 8j + 2 t4 + e of the block; a
  // column with rinv -1 (past Sa, masked out) never counts, so a zero-filled
  // column cannot beat negative cosines
  float rmax0 = -INFINITY, rmax1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float ra = rinv[8 * j + 2 * t4 + e];
      if (!(ra < 0.f)) {
        rmax0 = max_nan(rmax0, acc[4 * j + e] * ra);
        rmax1 = max_nan(rmax1, acc[4 * j + 2 + e] * ra);
      }
    }
  }
  // a row's max and squares sit in the 4 lanes of its quad
  rmax0 = max_nan(rmax0, __shfl_xor_sync(0xffffffffu, rmax0, 1));
  rmax0 = max_nan(rmax0, __shfl_xor_sync(0xffffffffu, rmax0, 2));
  rmax1 = max_nan(rmax1, __shfl_xor_sync(0xffffffffu, rmax1, 1));
  rmax1 = max_nan(rmax1, __shfl_xor_sync(0xffffffffu, rmax1, 2));
  tsq0 += __shfl_xor_sync(0xffffffffu, tsq0, 1);
  tsq0 += __shfl_xor_sync(0xffffffffu, tsq0, 2);
  tsq1 += __shfl_xor_sync(0xffffffffu, tsq1, 1);
  tsq1 += __shfl_xor_sync(0xffffffffu, tsq1, 2);
  // |t| + eps > 0, so dividing the max divides every cosine alike
  const int tiles_a = gridDim.x / tiles_t;
  float* out = rowmax + (static_cast<size_t>(n) * tiles_a + at) * st;
  if (t4 == 0 && m0 + r0 < st) out[m0 + r0] = rmax0 / (sqrtf(tsq0) + kEps);
  if (t4 == 0 && m0 + r0 + 8 < st) {
    out[m0 + r0 + 8] = rmax1 / (sqrtf(tsq1) + kEps);
  }
}

// out[n] = sum over valid target rows of the max over anchor blocks of
// rowmax[n, :, row], over the count of valid rows: one block of 128 threads
// an image, each thread's rows in order, then a fixed tree, so two runs give
// the same bits
__global__ void a_score_tf32_finish_kernel(const float* __restrict__ rowmax,
                                           const uint8_t* __restrict__ tmask,
                                           float* __restrict__ out, int st,
                                           int tiles_a) {
  __shared__ float sums[128], counts[128];
  const int n = blockIdx.x, tid = threadIdx.x;
  float sum = 0.f, count = 0.f;
  for (int row = tid; row < st; row += 128) {
    if (tmask != nullptr && tmask[static_cast<size_t>(n) * st + row] == 0)
      continue;
    float v = -INFINITY;
    for (int at = 0; at < tiles_a; ++at) {
      v = max_nan(v,
                  rowmax[(static_cast<size_t>(n) * tiles_a + at) * st + row]);
    }
    sum += v;
    count += 1.f;
  }
  sums[tid] = sum;
  counts[tid] = count;
  __syncthreads();
  for (int half = 64; half > 0; half >>= 1) {
    if (tid < half) {
      sums[tid] += sums[tid + half];
      counts[tid] += counts[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) out[n] = sums[0] / fmaxf(counts[0], 1.f);
}

}  // namespace

// SIMT body.
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

// 3xTF32 body: fp32 target / anchor with d % 4 == 0 and 16-byte-aligned
// bases (else cudaErrorInvalidValue). rowmax: [N, ceil(Sa / 128), St] fp32
// scratch; masks and out as lvr_a_score.
extern "C" int lvr_a_score_tf32(const void* target, const void* anchor,
                                const void* tmask, const void* amask,
                                void* rowmax, void* out, int n, int st,
                                int sa, int d, void* stream) {
  const int tiles_t = (st + kRows - 1) / kRows;
  const int tiles_a = (sa + kCols - 1) / kCols;
  if (n <= 0 || st <= 0 || sa <= 0 || d <= 0 || n > 65535 || d % 4 != 0 ||
      tiles_t * tiles_a > 65535 ||
      reinterpret_cast<uintptr_t>(target) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(anchor) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // also makes the device's context current for the map encodes
  int err = static_cast<int>(cudaFuncSetAttribute(
      a_score_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemTf32));
  CUtensorMap t_map, a_map;
  if (err == 0) err = hp::make_f32_nsd_map(&t_map, target, n, st, d, kRows);
  if (err == 0) err = hp::make_f32_nsd_map(&a_map, anchor, n, sa, d, kCols);
  if (err != 0) return err;
  a_score_tf32_kernel<<<dim3(tiles_t * tiles_a, n), kThreadsTf32, kSmemTf32,
                        s>>>(t_map, a_map, static_cast<const uint8_t*>(amask),
                             static_cast<float*>(rowmax), st, sa, d, tiles_t);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  a_score_tf32_finish_kernel<<<n, 128, 0, s>>>(
      static_cast<const float*>(rowmax), static_cast<const uint8_t*>(tmask),
      static_cast<float*>(out), st, tiles_a);
  return static_cast<int>(cudaGetLastError());
}

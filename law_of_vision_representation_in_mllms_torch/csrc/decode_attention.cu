// Kernel 3: single-token (decode-step) attention over the KV cache.
//
// Replaces the TPU kernel `ops/decode_attention.py` `decode_attention`
// (`_kernel`, both branches; `decode_attention_stacked` is routed here too).
// q is [B, 1, H, Dh] bf16; the cache k/v is read in place in its stored
// [B, T, KV, Dh] layout; query head h reads kv head h / (H / KV); `mask` is a
// [B, T] byte mask (1 = visible) that may have holes (the prompt's pad slots)
// and whole masked stretches. A masked slot is never copied and contributes
// exactly 0, and a row with no visible slot gives 0 (the TPU kernel gives NaN
// there: exp(NEG - NEG) = 1 on a fully masked tile). Softmax is fp32.
//
// The cache is bf16 (dense branch) or int8 codes with one fp32 scale per
// (slot, kv head), `k_scale`/`v_scale` [B, T, KV] (int8 branch). There the K
// scale multiplies the slot's logit after the q.k sum, the softmax
// denominator adds up the raw probabilities, and the V scale enters the
// numerator only: out = sum_t p_t * vs_t * v_t / sum_t p_t.
//
// What bounds it on the H100: a step reads every visible cache byte once at
// ~0.1 FLOP a byte, so HBM is the floor (Vicuna-7B, B = 4, T = 704: 46 MB a
// layer in bf16, 0.0138 ms at 3.35 TB/s; half of it in int8). Reaching it
// takes many bytes in flight from a grid that fills the card: one block per
// (kv head, batch row) gives 128 blocks at B = 4 and 32 at GQA KV = 8, and
// registers alone hold too few rows in flight to hide HBM's latency.
//
// Design (PERF.md, section 6, has the measurements behind each part):
// - The grid is (splits, KV, B), and the `splits` blocks of one (kv head,
//   batch row) form a thread-block cluster, each walking a contiguous range
//   of slots. `splits` (at most 8, the portable cluster size) comes from B,
//   KV, the group size and T alone; the launch reads nothing back from the
//   card and can be captured in a CUDA graph. The grid aims at ~256 blocks,
//   all resident at once: with more, a second wave paid the merge again
//   while no bytes moved.
// - Two producer warps read the mask a tile of 32 slots at a time; a tile
//   with no visible slot takes no stage and no copy. The copier warps bring
//   the tile's visible rows of K and V into a ring in shared memory (four
//   stages of bf16, eight of int8: the same bytes) by 16-byte `cp.async`,
//   the int8 scales by 4-byte ones; each lane's arrival on the stage's
//   mbarrier comes when its bytes have landed, so the ring, not the
//   registers, sets the bytes in flight, and no tensor map is encoded on the
//   host. The bookkeeper records the tile. (One `cp.async.bulk` a row,
//   through the TMA engine, was paced by its requests: int8 rows of 128
//   bytes took as long as bf16 rows of 256.)
// - Four consumer warps take 8 slots of each tile each. A row is read from
//   shared memory 16 bytes a lane (a bf16 row of Dh = 128 by 16 lanes, an
//   int8 row by 8; 8 bytes a lane for int8 at G >= 4, where 16 took 202
//   registers and left one block an SM), int8 codes become fp32 by a byte
//   permute and one exact subtraction (I2F runs at a quarter of the rate),
//   q.k is summed over the row's lanes by shuffles, and the online softmax
//   takes one step a tile (the tile's max, one rescale) before p.v.
// - The warps' partials (m, l, acc[G][Dh]) merge into the block's in shared
//   memory. After a cluster barrier each block takes 1 / splits of the
//   G x Dh outputs and merges the cluster's partials through distributed
//   shared memory in rank order, so a repeat gives the same bits: no second
//   launch and no scratch in HBM.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "hopper_common.cuh"

namespace {

namespace cg = cooperative_groups;
namespace hp = lvr::hopper;
using bf16 = __nv_bfloat16;

constexpr int kTile = 32;         // slots a stage: a lane's each in a ballot
constexpr int kConsumers = 4;     // consumer warps, then the producers:
constexpr int kCopiers = 2;       // copier warps and one bookkeeper warp
constexpr int kThreads = (kConsumers + kCopiers + 1) * 32;
constexpr int kSlotsPerWarp = kTile / kConsumers;
constexpr int kMaskAhead = 4;     // tiles whose mask bytes are read at once
constexpr int kMaxSplits = 8;     // the portable cluster size
constexpr int kGridBlocks = 256;  // what `splits` aims the grid at
constexpr float kLog2e = 1.4426950408889634f;

constexpr int align16(int x) { return (x + 15) & ~15; }

// The lane layout and the shared-memory layout of one instantiation.
template <int DH, int G, typename KV>
struct Shape {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kRowBytes = DH * static_cast<int>(sizeof(KV));
  // ring stages: the same bytes in flight for both caches
  static constexpr int kStages = kQuant ? 8 : 4;
  // elements of a row a lane reads: 16 bytes' worth, but 8 int8 codes at
  // G >= 4, where q and acc at 16 (2 x 4 x 16 fp32 registers) took 202
  // registers a thread and left one block an SM
  static constexpr int kElems = kQuant && G <= 2 ? 16 : 8;
  static constexpr int kLanes = DH / kElems;   // lanes a row
  static constexpr int kRows = 32 / kLanes;    // rows a warp reads at once
  static constexpr int kSteps = (kSlotsPerWarp + kRows - 1) / kRows;
  static constexpr int kStageBytes = kTile * kRowBytes;
  // K ring, V ring [stage][slot][Dh]; int8 scales [stage][k | v][slot] fp32;
  // the warps' partials acc [warp][G][Dh], m, l [warp][G]; the block's
  // acc [G][Dh], m, l [G]; the stages' tiles (first slot, visible bits);
  // the full and empty mbarriers
  static constexpr int kOffV = kStages * kStageBytes;
  static constexpr int kOffScale = 2 * kStages * kStageBytes;
  static constexpr int kOffWarp =
      kOffScale + (kQuant ? kStages * 2 * kTile * 4 : 0);
  static constexpr int kOffBlock =
      kOffWarp + align16(kConsumers * G * (DH + 2) * 4);
  static constexpr int kOffInfo = kOffBlock + align16(G * (DH + 2) * 4);
  static constexpr int kOffBar = kOffInfo + kStages * 8;
  static constexpr int kSmem = kOffBar + 2 * kStages * 8;
  // the copiers' lanes and the bookkeeper's lane 0
  static constexpr int kFullCount = 32 * kCopiers + 1;
  static_assert(kLanes <= 32 && kTile % kConsumers == 0, "lane layout");
};

// E bf16 values (a multiple of 8) from global or shared memory as fp32
template <int E>
__device__ __forceinline__ void load_elems(const bf16* p, float (&x)[E]) {
#pragma unroll
  for (int c = 0; c < E / 8; ++c) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[8 * c + 2 * i] = f.x;
      x[8 * c + 2 * i + 1] = f.y;
    }
  }
}

// E int8 codes (8 or 16) from shared memory as fp32
template <int E>
__device__ __forceinline__ void load_elems(const int8_t* p, float (&x)[E]) {
  uint32_t w[E / 4];
  if constexpr (E == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    w[0] = raw.x, w[1] = raw.y, w[2] = raw.z, w[3] = raw.w;
  } else {
    static_assert(E == 8, "8 or 16 codes a lane");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    w[0] = raw.x, w[1] = raw.y;
  }
  // each code, its sign bit flipped, becomes the low byte of the fp32
  // 2^23 + code + 128, from which one exact subtraction leaves the code:
  // byte permutes and adds at full rate, where I2F runs at a quarter
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[4 * i + j] =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
          8388736.f;
    }
  }
}

// The producer warps walk the same tiles of [begin, end): a tile with a
// visible slot takes the next stage of the ring, a masked one takes none.
// The copiers bring the tile's visible rows of K and V by 16-byte cp.async
// (the first one also the int8 scales, by 4-byte ones), which arrive on the
// stage's full barrier once they have landed, one arrival a lane. The
// bookkeeper records the tile (its first slot and visible bits) and arrives
// once. That record needs a plain, releasing arrival, and such an arrival
// waits for the thread's own outstanding copies, so it comes from a warp
// that copies nothing. After the last tile all of them mark a stage with no
// tile: the consumers' signal to stop.
template <int DH, int G, typename KV, bool kCopier>
__device__ __forceinline__ void produce(
    uint32_t base, int2* info, const KV* kb, const KV* vb,
    const float* ksb, const float* vsb, const uint8_t* mb, int begin, int end,
    long rs, int kv_heads) {
  using S = Shape<DH, G, KV>;
  constexpr int kPieces = S::kRowBytes / 16;       // 16-byte pieces a row
  constexpr int kPer = 16 / static_cast<int>(sizeof(KV));  // elements a piece
  const int lane = threadIdx.x & 31;
  const int copier = threadIdx.x / 32 - kConsumers;   // its lanes' pieces
  const uint32_t full = base + S::kOffBar, empty = full + 8 * S::kStages;
  int stage = 0;
  uint32_t phase = 0;
  // the mask of kMaskAhead tiles a lane's slot each, read a batch ahead
  bool next[kMaskAhead];
  auto read_mask = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kMaskAhead; ++j) {
      const int t = t0 + j * kTile + lane;
      next[j] = t < end && mb[t] != 0;
    }
  };
  read_mask(begin);
  for (int t0 = begin; t0 < end; t0 += kTile * kMaskAhead) {
    bool vis[kMaskAhead];
#pragma unroll
    for (int j = 0; j < kMaskAhead; ++j) vis[j] = next[j];
    read_mask(t0 + kTile * kMaskAhead);
#pragma unroll
    for (int j = 0; j < kMaskAhead; ++j) {
      const uint32_t bits = __ballot_sync(0xffffffffu, vis[j]);
      if (bits == 0) continue;          // a masked tile: no stage, no copy
      const int tile0 = t0 + j * kTile;
      const uint32_t bar = full + 8 * stage;
      hp::mbar_wait(empty + 8 * stage, phase ^ 1);
      if constexpr (kCopier) {
        const uint32_t dst = base + stage * S::kStageBytes;
#pragma unroll
        for (int p = copier * 32 + lane; p < kTile * kPieces;
             p += kCopiers * 32) {
          const int row = p / kPieces, piece = p % kPieces;
          if ((bits >> row) & 1u) {
            const long src =
                static_cast<long>(tile0 + row) * rs + piece * kPer;
            const uint32_t off = row * S::kRowBytes + piece * 16;
            hp::cp_async_16(dst + off, kb + src);
            hp::cp_async_16(dst + S::kOffV + off, vb + src);
          }
        }
        if constexpr (S::kQuant) {
          if (copier == 0 && vis[j]) {
            const long sc = static_cast<long>(tile0 + lane) * kv_heads;
            const uint32_t sdst =
                base + S::kOffScale + (stage * 2 * kTile + lane) * 4;
            hp::cp_async_4(sdst, ksb + sc);
            hp::cp_async_4(sdst + kTile * 4, vsb + sc);
          }
        }
        hp::cp_async_mbar_arrive(bar);
      } else if (lane == 0) {
        info[stage] = make_int2(tile0, static_cast<int>(bits));
        hp::mbar_arrive(bar);
      }
      if (++stage == S::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  hp::mbar_wait(empty + 8 * stage, phase ^ 1);
  if constexpr (kCopier) {
    hp::cp_async_mbar_arrive(full + 8 * stage);
  } else if (lane == 0) {
    info[stage] = make_int2(-1, 0);
    hp::mbar_arrive(full + 8 * stage);
  }
}

// grid (splits, KV, B), clusters of (splits, 1, 1); block r of a cluster
// walks slots [r * chunk, (r + 1) * chunk) of kv head blockIdx.y, batch row
// blockIdx.z. KV = bf16: dense cache, the scale pointers are not read.
// KV = int8_t: codes with `k_scale`/`v_scale` [B, T, KV].
template <int DH, int G, typename KV>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
                  const KV* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                  int T, int chunk, int kv_heads, float scale_log2) {
  using S = Shape<DH, G, KV>;
  constexpr int E = S::kElems, L = S::kLanes, R = S::kRows;
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t base = hp::smem_u32(smem);
  const uint32_t full = base + S::kOffBar, empty = full + 8 * S::kStages;
  int2* info = reinterpret_cast<int2*>(smem + S::kOffInfo);
  float* pacc = reinterpret_cast<float*>(smem + S::kOffBlock);  // [G][DH]
  float* pm = pacc + G * DH;
  float* pl = pm + G;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      hp::mbar_init(full + 8 * s, S::kFullCount);
      hp::mbar_init(empty + 8 * s, kConsumers);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  const long rs = static_cast<long>(kv_heads) * DH;  // slot stride
  const int begin = split * chunk, end = min(T, begin + chunk);
  if (warp >= kConsumers) {
    const long row0 = static_cast<long>(b) * T * rs + kvh * DH;
    const long sc0 = static_cast<long>(b) * T * kv_heads + kvh;
    const float* ksb = S::kQuant ? k_scale + sc0 : nullptr;
    const float* vsb = S::kQuant ? v_scale + sc0 : nullptr;
    const uint8_t* mb = mask + static_cast<long>(b) * T;
    if (warp < kConsumers + kCopiers) {
      produce<DH, G, KV, true>(base, info, k + row0, v + row0, ksb, vsb, mb,
                               begin, end, rs, kv_heads);
    } else {
      produce<DH, G, KV, false>(base, info, k + row0, v + row0, ksb, vsb, mb,
                                begin, end, rs, kv_heads);
    }
  } else {
    // lane = rg * L + c: row group rg reads a slot, lane c its elements
    // c * E .. c * E + E - 1
    const int rg = lane / L, c = lane % L;
    float qf[G][E];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      load_elems<E>(q + (static_cast<long>(b) * kv_heads * G + kvh * G + g) *
                            DH + c * E,
                    qf[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) qf[g][e] *= scale_log2;
    }
    // m is the warp's (every row group's) running max; l and acc are the
    // row group's sums against it
    float m[G], l[G], acc[G][E];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    }
    const float* scales = reinterpret_cast<const float*>(smem + S::kOffScale);
    int stage = 0;
    uint32_t phase = 0;
    while (true) {
      hp::mbar_wait(full + 8 * stage, phase);
      const int2 tile = info[stage];
      if (tile.x < 0) break;
      const uint32_t mine = (static_cast<uint32_t>(tile.y) >>
                             (warp * kSlotsPerWarp)) &
                            ((1u << kSlotsPerWarp) - 1);
      if (mine != 0) {
        const KV* krow = reinterpret_cast<const KV*>(
                             smem + stage * S::kStageBytes) + c * E;
        const KV* vrow = reinterpret_cast<const KV*>(
                             smem + S::kOffV + stage * S::kStageBytes) + c * E;
        const float* ks = scales + stage * 2 * kTile;
        float s[S::kSteps][G];
        bool ok[S::kSteps];
#pragma unroll
        for (int j = 0; j < S::kSteps; ++j) {
          // the slot in the warp's share and in the tile (a row group past
          // the share reads the share's first row and never counts)
          const int sw = j * R + rg;
          const int i = warp * kSlotsPerWarp + (sw < kSlotsPerWarp ? sw : 0);
          ok[j] = sw < kSlotsPerWarp && ((mine >> sw) & 1u);
          float kf[E];
          load_elems<E>(krow + i * DH, kf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) part = fmaf(qf[g][e], kf[e], part);
#pragma unroll
            for (int off = L / 2; off > 0; off >>= 1) {
              part += __shfl_xor_sync(0xffffffffu, part, off);
            }
            if constexpr (S::kQuant) part *= ks[i];
            // a masked slot's row holds stale bytes: never let them count
            s[j][g] = ok[j] ? part : -INFINITY;
          }
        }
        // one softmax step for the tile: its max over the warp's slots
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float mt = s[0][g];
#pragma unroll
          for (int j = 1; j < S::kSteps; ++j) mt = fmaxf(mt, s[j][g]);
#pragma unroll
          for (int off = L; off < 32; off <<= 1) {
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
          }
          const float mn = fmaxf(m[g], mt);     // finite: a slot is visible
          const float alpha = exp2f(m[g] - mn);  // 0 while m is still -inf
          m[g] = mn;
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
          for (int j = 0; j < S::kSteps; ++j) {
            s[j][g] = exp2f(s[j][g] - mn);      // 0 for a masked slot
            l[g] += s[j][g];                    // the raw probability
          }
        }
#pragma unroll
        for (int j = 0; j < S::kSteps; ++j) {
          if (!ok[j]) continue;
          const int i = warp * kSlotsPerWarp + j * R + rg;
          float vf[E];
          load_elems<E>(vrow + i * DH, vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float pv = s[j][g];
            if constexpr (S::kQuant) pv *= ks[kTile + i];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + 8 * stage);
      if (++stage == S::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // the warp's partial: l and acc summed over its row groups
    float* wacc = reinterpret_cast<float*>(smem + S::kOffWarp);  // [w][G][DH]
    float* wm = wacc + kConsumers * G * DH;
    float* wl = wm + kConsumers * G;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int off = L; off < 32; off <<= 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        }
      }
      if (rg == 0) {
        float4* dst =
            reinterpret_cast<float4*>(wacc + (warp * G + g) * DH + c * E);
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          dst[e / 4] = make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                                   acc[g][e + 3]);
        }
      }
      if (lane == 0) {
        wm[warp * G + g] = m[g];
        wl[warp * G + g] = l[g];
      }
    }
    hp::bar_sync(1, kConsumers * 32);
    // the block's partial, the warps merged in order
    for (int idx = threadIdx.x; idx < G * DH; idx += kConsumers * 32) {
      const int g = idx / DH, d = idx % DH;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kConsumers; ++w) mx = fmaxf(mx, wm[w * G + g]);
      float num = 0.f, den = 0.f;
      if (mx != -INFINITY) {
#pragma unroll
        for (int w = 0; w < kConsumers; ++w) {
          const float sc = exp2f(wm[w * G + g] - mx);  // 0: saw nothing
          num += wacc[(w * G + g) * DH + d] * sc;
          den += wl[w * G + g] * sc;
        }
      }
      pacc[idx] = num;
      if (d == 0) {
        pm[g] = mx;
        pl[g] = den;
      }
    }
  }

  // every block's partial is complete; block r merges outputs
  // [r * per, (r + 1) * per) of the G x Dh over the cluster, in rank order
  cluster.sync();
  const int per = (G * DH + splits - 1) / splits;
  const int stop = min(G * DH, (split + 1) * per);
  for (int idx = split * per + threadIdx.x; idx < stop; idx += kThreads) {
    const int g = idx / DH, d = idx % DH;
    float mr[kMaxSplits];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      mr[r] = r < splits ? cluster.map_shared_rank(pm, r)[g] : -INFINITY;
      mx = fmaxf(mx, mr[r]);
    }
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        if (r < splits) {
          const float sc = exp2f(mr[r] - mx);   // 0 for a block that saw none
          num += cluster.map_shared_rank(pacc, r)[idx] * sc;
          den += cluster.map_shared_rank(pl, r)[g] * sc;
        }
      }
    }
    out[(static_cast<long>(b) * kv_heads * G + kvh * G + g) * DH + d] =
        __float2bfloat16(den > 0.f ? num / den : 0.f);
  }
  cluster.sync();       // no block leaves while another reads its partial
}

// blocks a (kv head, batch row), from the shapes alone: a grid of about
// kGridBlocks (two an SM, all resident at once: a second wave paid the
// merge twice), fewer for a group of 4 or 8 query heads, whose blocks
// compute more a byte; at most kMaxSplits, and at least two tiles a block
int choose_splits(int batch, int kv_heads, int group, int T) {
  const int per = batch * kv_heads * std::max(1, group / 2);
  const int tiles = (T + kTile - 1) / kTile;
  const int want = (kGridBlocks + per / 2) / per;
  return std::max(1, std::min({want, (tiles + 1) / 2, kMaxSplits}));
}

template <int DH, int G, typename KV>
int launch_g(const bf16* q, const KV* k, const KV* v, const float* k_scale,
             const float* v_scale, const uint8_t* mask, bf16* out, int batch,
             int T, int kv_heads, float scale_log2, cudaStream_t stream) {
  using S = Shape<DH, G, KV>;
  auto* kernel = decode_kernel<DH, G, KV>;
  // the shared-memory opt-in, once a device (bit d of `opted`)
  static std::atomic<uint32_t> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !((opted.load() >> dev) & 1u)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) opted.fetch_or(1u << dev);
  }
  const int tiles = (T + kTile - 1) / kTile;
  int splits = choose_splits(batch, kv_heads, G, T);
  const int chunk = (tiles + splits - 1) / splits * kTile;
  splits = (T + chunk - 1) / chunk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, kv_heads, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q, k, v, k_scale, v_scale, mask, out,
                           T, chunk, kv_heads, scale_log2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, typename KV>
int launch_dh(const bf16* q, const KV* k, const KV* v, const float* k_scale,
              const float* v_scale, const uint8_t* mask, bf16* out, int batch,
              int T, int kv_heads, int group, float scale_log2,
              cudaStream_t stream) {
  switch (group) {
    case 1:
      return launch_g<DH, 1, KV>(q, k, v, k_scale, v_scale, mask, out, batch,
                                 T, kv_heads, scale_log2, stream);
    case 2:
      return launch_g<DH, 2, KV>(q, k, v, k_scale, v_scale, mask, out, batch,
                                 T, kv_heads, scale_log2, stream);
    case 4:
      return launch_g<DH, 4, KV>(q, k, v, k_scale, v_scale, mask, out, batch,
                                 T, kv_heads, scale_log2, stream);
    case 8:
      return launch_g<DH, 8, KV>(q, k, v, k_scale, v_scale, mask, out, batch,
                                 T, kv_heads, scale_log2, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* mask, void* out, int batch, int T,
           int heads, int kv_heads, int head_dim, float scale, void* stream) {
  if (batch <= 0 || T <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      batch > 65535 || kv_heads > 65535) {
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

// Hopper (sm_90a) building blocks, written inline in PTX: shared-memory
// addresses, mbarriers, TMA tile loads and the host-side tensor map, wgmma
// matrix descriptors and the m64n128k16 bf16 product, register reallocation
// between warpgroups.
// The attention forward adds rank-4 tensor maps over [B, S, heads, D]
// (a tile that runs past S reads zeros, never the next batch's rows), their
// loads and stores, and the register-A products with an MN-major B (V as
// stored) at N = 64 and 128.
// The attention backward adds the SS m64n64k16 product (K-major A and B),
// rank-1 TMA loads and the rank-1 fp32 map over a flat array (LSE and δ of
// [B, H, Sq], whose rows are no multiple of 16 bytes apart unless 4 divides
// Sq, so no rank-2 map takes them).
// The A score's fp32 body adds the TF32 products (m64nNk8, A from registers,
// B K-major: a row of the swizzled tile holds 32 fp32, so a k8 step advances
// the descriptor by 32 bytes, as a bf16 k16 step does), the round-to-nearest
// TF32 conversion and the rank-3 fp32 map over [N, S, D].
// Decode attention adds copies that need no tensor map: the 4- and 16-byte
// `cp.async`, whose arrival on an mbarrier comes when they have landed.
// Kernel 10's decode body adds the tensor-map prefetch, the cluster barrier
// in halves and programmatic dependent launch.
//
// Shared-memory operand tiles follow the 128-byte swizzle that TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes and that a wgmma descriptor of layout
// type 1 reads: a tile is a stack of 128-byte rows, the 16-byte chunk c of
// row r lies at r * 128 + ((c ^ (r % 8)) * 16), and the tile starts on a
// 1024-byte boundary (8 rows), so the pattern repeats every 8 rows.
//
// K-major operand (the contraction index contiguous, 64 bf16 a row): rows
// are M (or N) indices. Descriptor: SBO = 1024 bytes from one 8-row group to
// the next; LBO unused (1); a k16 step inside the 64-wide row advances the
// start address by 32 bytes.
// MN-major operand (the output index contiguous): rows are contraction
// indices holding 64 consecutive M (or N) values each. Descriptor: SBO = 1024
// bytes from one 8-deep contraction group to the next, LBO = the bytes from
// one 64-wide block of M (or N) to the next; a k16 step advances the start
// address by 16 rows (2048 bytes).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lvr {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival, and `bytes` more that a TMA copy will complete
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` has completed. A wait of ~2^34
// cycles (~9 s) can only mean a lost arrival: trap, so that the launch fails
// with an error instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = -1;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) {
      start = now;
    } else if (now - start > (1ll << 34)) {
      __trap();
    }
  }
}

// named barriers: `count` threads in all, some arriving, some waiting
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// generic-proxy writes to shared memory (st.shared) become visible to the
// async proxy (wgmma, TMA) that reads them after a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// four 8 x 8 matrices of 16-bit elements from shared memory, lanes 8i..8i+7
// giving the 16-byte row addresses of matrix i: lane l receives word l % 4 of
// row l / 4 of matrix i in r[i]. Of a [rows, 4] fp32 block that is element
// (l / 4, l % 4), the layout of a TF32 A fragment's registers.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// ---- TMA --------------------------------------------------------------------
// the box of `map` at element coordinates (c0 innermost, c1) into `dst`,
// completing its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// brings a tensor map (a __grid_constant__ kernel parameter) into the TMA
// unit's descriptor cache ahead of its first copy
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// the cluster barrier in two halves, for every thread of the block: a
// relaxed arrival (it orders no memory) and the wait for every block of the
// cluster to have arrived. A block may write another's shared memory only
// after such a wait, which shows that the other has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---- programmatic dependent launch -----------------------------------------
// the grids launched after this one with programmatic stream serialization
// may be scheduled once every block of this grid has said so (or exited)
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// waits until the grids this one depends on have completed and their
// memory is visible (at once where it was launched without the attribute)
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the box of a rank-1 `map` at element coordinate c0
__device__ __forceinline__ void tma_load_1d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// the box of a rank-3 `map` at element coordinates (c0 innermost, c1, c2)
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// the box of a rank-4 `map` at element coordinates (c0 innermost .. c3)
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_"
      "tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// the box of a rank-4 `map` at element coordinates (c0 innermost .. c3) from
// shared memory at `src` (elements past the tensor's edges are not written);
// then commit the group and wait until shared memory has been read
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait_read() {
  asm volatile(
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// ---- copies without a tensor map --------------------------------------------
// 4 and 16 bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread issued so far has
// landed; counts as one of the arrivals `bar` was initialised with
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// ---- wgmma ------------------------------------------------------------------
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator register across
// the asynchronous product that writes it
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for a register A operand: keeps it unchanged and live until here
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// the same for an accumulator of another width
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], bf16 in, fp32 accumulate, both
// operands in shared memory. `accumulate` 0 overwrites d. TransB 0: B is
// K-major; 1: B is MN-major. Accumulator layout: warp w of the warpgroup
// owns rows 16w..16w+15; lane l holds, for j in 0..15,
//   d[4j], d[4j+1] at row 16w + l/4,     columns 8j + 2(l%4) + {0, 1}
//   d[4j+2], d[4j+3] at row 16w + l/4 + 8, the same columns.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TransB));
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], both operands in shared memory
// (descriptors as wgmma_m64n128k16). Accumulator layout as wgmma_m64n128k16,
// j in 0..7.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TransB));
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128] with A (64 x 16) from
// registers: warp w of the warpgroup holds rows 16w..16w+15 in the
// A-fragment layout of mma.m16n8k16 (a[0] = row l/4, columns 2(l%4)..+1;
// a[1] = row + 8; a[2] = columns + 8; a[3] both). The registers are read
// while the product runs: keep them unchanged until the wgmma_wait that
// covers it. TransB 0: B is K-major; 1: B is MN-major. Accumulator layout as
// wgmma_m64n128k16.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs_t(float (&d)[64],
                                                      const uint32_t (&a)[4],
                                                      uint64_t db,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TransB));
}

// the same with B K-major
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db,
                                                    int accumulate) {
  wgmma_m64n128k16_rs_t<0>(d, a, db, accumulate);
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64] with A from registers (the
// layout of wgmma_m64n128k16_rs_t) and B in shared memory; TransB 0: B is
// K-major, 1: B is MN-major. Accumulator layout as wgmma_m64n128k16, j in
// 0..7.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs_t(float (&d)[32],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TransB));
}

// ---- TF32 ------------------------------------------------------------------
// x rounded to TF32 (10 mantissa bits, ties away from zero), as the fp32 bit
// pattern with the low 13 bits clear: for a finite x what cvt.rna.tf32.f32
// gives, in two integer operations (the conversion adds a test for Inf and
// NaN to each)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// Register A of the TF32 products (wgmma_m64n*k8_tf32_rs): warp w of the
// warpgroup holds rows 16w..16w+15 in the A-fragment layout of
// mma.m16n8k8.tf32, one element a register: a[0] = (row l/4, column l%4),
// a[1] = (row + 8, the same column), a[2] = (row l/4, column l%4 + 4),
// a[3] = (row + 8, column + 4). The registers are read while the product
// runs: keep them unchanged until the wgmma_wait that covers it.
// Accumulator layout as wgmma_m64n128k16.

// d[64 x 128] (+)= A[64 x 8] * B[8 x 128] in TF32 (fp32 accumulate), A from
// registers (the layout above), B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// the same at N = 64 (accumulator layout j in 0..7)
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// ---- register reallocation (the whole warpgroup executes it) ----------------
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- host: tensor maps ----------------------------------------------------
using TensorMapEncoder = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime, so the library
// links no libcuda; nullptr where libcuda lacks it
inline TensorMapEncoder tensor_map_encoder() {
  static const TensorMapEncoder encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TensorMapEncoder>(fn)
               : nullptr;
  }();
  return encode;
}

// A row-major matrix [rows, cols] of `elem_bytes`-byte elements read in boxes
// of [box_rows, box_cols]; elements past either edge read as zero. Returns a
// cudaError_t value. Like every map maker here it needs a CUDA context
// current on the calling thread: make a runtime call first (the launchers
// set their shared-memory attribute).
inline int make_map(CUtensorMap* map, CUtensorMapDataType type,
                    uint32_t elem_bytes, const void* base, uint64_t rows,
                    uint64_t cols, uint32_t box_rows, uint32_t box_cols,
                    CUtensorMapSwizzle swizzle) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// a bf16 matrix read in 128-byte-swizzled boxes of [box_rows, 64]
inline int make_bf16_map(CUtensorMap* map, const void* base, uint64_t rows,
                         uint64_t cols, uint32_t box_rows) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols,
                  box_rows, 64, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A bf16 tensor [batch, seq, heads, 64 * k] read in 128-byte-swizzled boxes
// of [box_rows, 64] of one (batch, head): dims (64 * k, heads, seq, batch),
// box (64, 1, box_rows, 1). Rows past `seq` read as zero within their own
// batch. Returns a cudaError_t value.
inline int make_bhsd_map(CUtensorMap* map, const void* base, uint64_t batch,
                         uint64_t seq, uint64_t heads, uint64_t head_dim,
                         uint32_t box_rows) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {head_dim, heads, seq, batch};
  const cuuint64_t strides[3] = {head_dim * 2, heads * head_dim * 2,
                                 seq * heads * head_dim * 2};
  const cuuint32_t box[4] = {64, 1, box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A flat fp32 array of `elems` elements read in boxes of `box` elements
// (box * 4 a multiple of 16); a box starts on a 16-byte boundary (an element
// index that 4 divides: other starts fault the copy), and elements past the
// end read as zero. Returns a cudaError_t value.
inline int make_flat_f32_map(CUtensorMap* map, const void* base,
                             uint64_t elems, uint32_t box) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[1] = {elems};
  const cuuint64_t strides[1] = {elems * 4};   // unused at rank 1
  const cuuint32_t boxes[1] = {box};
  const cuuint32_t elem[1] = {1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims,
      strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}


// An fp32 tensor [n, s, d] (d contiguous; d % 4 == 0 and a 16-byte-aligned
// base, as TMA requires) read in 128-byte-swizzled boxes of [box_rows, 32]
// of one n: dims (d, s, n), box (32, box_rows, 1). Rows past `s` read as zero
// within their own n, never the next one's, and so do columns past `d`.
// Returns a cudaError_t value.
inline int make_f32_nsd_map(CUtensorMap* map, const void* base, uint64_t n,
                            uint64_t s, uint64_t d, uint32_t box_rows) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {d, s, n};
  const cuuint64_t strides[2] = {d * 4, s * d * 4};
  const cuuint32_t box[3] = {32, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hopper
}  // namespace lvr

// Warp-level tensor-core and asynchronous-copy primitives, shared by the
// bf16 forms of lowrank.cu and flash_attention.cu: mma.sync, ldmatrix and
// cp.async (sm_80 PTX), and the mbarriers, TMA copies and wgmma of sm_90a.
//
// Fragments of mma.m16n8k16 (bf16 in, f32 accumulate), lane = 4 g + t:
//   A (16 x 16, row-major)  a0 (g, 2t..2t+1)   a1 (g+8, 2t..)
//                           a2 (g, 2t+8..)     a3 (g+8, 2t+8..)
//   B (16 x 8, k-major)     b0 (k 2t..2t+1, n g)   b1 (k 2t+8.., n g)
//   C (16 x 8, f32)         c0, c1 (g, 2t..2t+1)   c2, c3 (g+8, 2t..2t+1)
// ldmatrix.x4 reads four 8 x 8 b16 matrices; lane i gives the address of
// row i % 8 of matrix i / 8.  For a row-major 16 x 16 tile at `base` (row
// stride ld), the address (lane % 16) * ld + (lane / 16) * 8 yields the A
// fragment without .trans, and with .trans the B fragments of the two n8
// tiles of a k-major [k][n] tile (b0, b1 of n 0-7, then b0, b1 of n 8-15).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros and
// reads nothing (the tile's ragged edge).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b  (16 x 16 bf16 times 16 x 8 bf16, f32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An mbarrier in shared memory: init (one thread), then per use one
// arrive that also sets the bytes a TMA copy will deliver, and a wait for
// the phase of that use (parity = use count & 1) to complete.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA: the box of a 2-D tensor map at coordinates (c0 innermost, c1) into
// shared memory, completing on `bar`; the map lives in kernel parameter
// space (__grid_constant__).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma (sm_90a): one warpgroup (4 warps) multiplies a 64-row A tile by a
// B tile, both read from shared memory through 64-bit descriptors: start
// address, leading and stride byte offsets (all >> 4), and the layout, here
// the 128-byte swizzle TMA writes (1 << 62).  In a 128-byte swizzled tile,
// rows of 128 B come in atoms of 8 rows (1024 B): SBO steps from one atom to
// the next; LBO is not read when the operand's 128-B rows hold the whole
// instruction's extent (K-major A: 16 K of 64; MN-major B: N = 64).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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
// d += A . B: A 64 x 16 K-major (bf16), B 16 x 64 MN-major (bf16, as a
// row-major [k][n] tile), f32 accumulators.  Thread 32w + 4g + t holds
// d[4j], d[4j+1] at (16w + g, 8j + 2t, +1) and d[4j+2], d[4j+3] at
// (16w + g + 8, 8j + 2t, +1), j = 0..7: the mma.sync C layout per n8 tile.
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
// order this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// two f32 rounded to bf16 (lo in the low half), as one A-fragment register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tc

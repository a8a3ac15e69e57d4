// The codec projection y[T, n] = x[T, k] . w[k, n] in bf16 as mma.sync
// m16n8k16 tiles from ldmatrix over a 3-stage cp.async ring: the form that
// src/repro_torch/csrc/lowrank.cu's wgmma kernel was chosen over.  Kept
// only so that `tools/kernel_probe.py --mma-sync` can time the two side by
// side; the port never loads it.  Needs k and n multiples of 8 and 16-byte aligned
// x and w (the probe's shapes); rows past T are zero-filled.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//       -Xcompiler -fPIC -I src/repro_torch/csrc -o <lib> tools/codec_mma_sync.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64, kBN = 64, kBK = 64;  // output tile and K step
constexpr int kThreads = 128;                // 4 warps, 2 x 2 over the tile
constexpr int kStages = 3;
constexpr int kLd = 64 + 8;  // smem row: 64 values and 16 B of padding (no ldmatrix conflicts)
constexpr size_t kSmem = sizeof(bf16) * kStages * (kBM + kBK) * kLd;

// X rows [r0, r0 + 64) x K [kk0, kk0 + 64) as xs[64][kLd], W K x columns
// [c0, c0 + 64) as ws[64][kLd]: one 16-byte cp.async a chunk of 8 values,
// chunks past the edges zero-filled without a read.
__device__ __forceinline__ void stage(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                      bf16* xs, bf16* ws, int r0, int c0, int kk0, int nt,
                                      int k, int n) {
  for (int c = threadIdx.x; c < kBM * 8; c += kThreads) {
    const int row = c >> 3, ch = (c & 7) * 8;
    const int gr = r0 + row, gk = kk0 + ch;
    const bool ok = gr < nt && gk < k;
    tc::cp_async16(xs + row * kLd + ch, ok ? x + (size_t)gr * k + gk : x, ok ? 16 : 0);
  }
  for (int c = threadIdx.x; c < kBK * 8; c += kThreads) {
    const int row = c >> 3, ch = (c & 7) * 8;
    const int gk = kk0 + row, gc = c0 + ch;
    const bool ok = gk < k && gc < n;
    tc::cp_async16(ws + row * kLd + ch, ok ? w + (size_t)gk * n + gc : w, ok ? 16 : 0);
  }
}

// Each warp owns a 32 x 32 quarter of the tile: 2 x 4 mma tiles of 16 x 8,
// X fragments by ldmatrix, W fragments by ldmatrix.trans.
__global__ void __launch_bounds__(kThreads) project_mma_sync_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ y, int nt,
    int k, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kStages][kBM][kLd]
  bf16* ws = xs + kStages * kBM * kLd;           // [kStages][kBK][kLd]
  const int c0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;
  const int ns = (k + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  const bool live = r0 + wr < nt && c0 + wc < n;  // a quarter past the edge skips the products

  float acc[2][4][4] = {};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ns) stage(x, w, xs + i * kBM * kLd, ws + i * kBK * kLd, r0, c0, i * kBK, nt, k, n);
    tc::cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    tc::cp_async_wait<kStages - 2>();  // step i has landed
    __syncthreads();                   // and every warp is done with step i - 1's slot
    const int nxt = i + kStages - 1;
    if (nxt < ns) {
      const int sl = nxt % kStages;
      stage(x, w, xs + sl * kBM * kLd, ws + sl * kBK * kLd, r0, c0, nxt * kBK, nt, k, n);
    }
    tc::cp_async_commit();
    if (!live) continue;
    const int sl = i % kStages;
    const bf16* xa = xs + sl * kBM * kLd;
    const bf16* wb = ws + sl * kBK * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        tc::ldmatrix_x4(a[mi], xa + (wr + mi * 16 + (lane & 15)) * kLd + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, wb + (kk + (lane & 15)) * kLd + wc + nj * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          tc::mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          tc::mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wr + mi * 16 + g + 8 * h;
      if (row >= nt) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = c0 + wc + ni * 8 + 2 * t;
        if (col < n)  // n a multiple of 8: col + 1 < n too, and the pair is aligned
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * n + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).
extern "C" int codec_mma_sync_launch(const void* x, const void* w, void* y, int nt, int k,
                                     int n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(project_mma_sync_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBN - 1) / kBN, (nt + kBM - 1) / kBM);
  project_mma_sync_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(y), nt, k, n);
  return (int)cudaGetLastError();
}

// Low-rank boundary codec (paper eq. 8, 1-D form) for Hopper (sm_90a).
//
// Replaces repro/kernels/lowrank/kernel.py::encode_pallas, decode_pallas
// and roundtrip_pallas (_encode_kernel, _decode_kernel, _roundtrip_kernel):
//     encode     Z[T, r] = X[T, d] . E[d, r]
//     decode     X^[T, d] = Z[T, r] . D[r, d]
//     roundtrip  X -> Z -> X^ in one pass, plus sum (X - X^)^2
// with f32 accumulation and outputs in the input's type (bf16 or f32; both
// operands of a product share one type, as the consumer casts E and D to
// the activation type before the product).
//
// What bounds it on the H100.  Encode and decode move X, W and Y once:
// at the one-shot pipeline's boundary (T = 1024 tokens, d = 768, r = 384,
// bf16) ~2.9 MB against ~0.6 GFLOP, ~200 flops a byte, under the ~295 at
// which the bf16 tensor cores bind, so the floor is bytes (0.88 us).  At
// the streaming engine's decode group step (T = 4) and prefill chunk
// (T = 32) the work is one pass over W (590 KB, ~0.18 us): the floor is
// W's bytes, and what costs is latency and how many SMs share that pass.
//
// Design of the projection (encode, decode).  A grid of 64 x 64 output
// tiles, each block walking all of K: 96 blocks at T = 1024, and at T = 4
// or 32 the output columns alone, 6 blocks for encode and 12 for decode,
// share the pass over W.  K is not split: on the H100 a split whose f32
// partials a second launch adds saved under 0.5 us a call in isolation and
// nothing in a streaming tick (PERF.md, tools/kernel_probe.py).  bf16 runs
// on the tensor cores by wgmma, one warpgroup a tile, fed by a 4-stage
// ring of TMA copies (one instruction a tile, where cp.async spends a
// 16-byte request of every thread) that complete on mbarriers and land in
// the 128-byte swizzle wgmma reads; TMA zero-fills rows past T and the
// edges of k and n, so X is never copied to pad it.  One wgmma group stays
// in flight across each step's barrier.  wgmma and not mma.sync: the
// mma.sync form from ldmatrix over a cp.async ring (tools/codec_mma_sync.cu)
// took 1.6-2.3x the device time at these shapes (PERF.md).  k or n not a
// multiple of 8, or an operand not 16-byte aligned, takes scalar loads
// into the same layout.  f32 stays exact: CUDA-core FMAs (no TF32) on the
// same grid.
//
// The roundtrip is not redesigned: one block per kRows = 8 token rows
// stages its rows in shared memory in f32, transposed ([k][kRows]), and
// its 128 threads each accumulate kCols = 4 output columns (strided by
// 128, so the weight loads and the output stores are coalesced) for all
// 8 rows (rows_times_w).  It keeps Z in shared memory in f32 (never
// rounded, never written to HBM), writes X^ once, and writes one f32
// partial of sum (X - X^)^2 per block (from the unrounded f32 X^, as the
// reference); a second one-block pass sums the partials in a fixed order,
// so the error is deterministic and needs no atomics.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

// the roundtrip's blocks
constexpr int kRows = 8;                 // token rows per block
constexpr int kThreads = 128;
constexpr int kCols = 4;                 // output columns per thread per pass
constexpr int kPass = kThreads * kCols;  // output columns per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// a_s[kk * kRows + row] = x[r0 + row, kk] in f32; rows past nr are 0.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, int r0,
                                          int nr, int k, float* a_s) {
  for (int i = threadIdx.x; i < kRows * k; i += kThreads) {
    const int row = i / k, kk = i - row * k;
    a_s[kk * kRows + row] = row < nr ? to_f(x[(size_t)(r0 + row) * k + kk]) : 0.f;
  }
}

// acc[row][j] = sum_kk a_s[kk][row] * w[kk, c0 + threadIdx.x + j * kThreads]
// (f32 accumulation; columns past n accumulate 0).
template <typename T>
__device__ __forceinline__ void rows_times_w(const float* a_s, int k,
                                             const T* __restrict__ w, int n,
                                             int c0, float (&acc)[kRows][kCols]) {
  int col[kCols];
  bool ok[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    col[j] = c0 + threadIdx.x + j * kThreads;
    ok[j] = col[j] < n;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < k; ++kk) {
    float wv[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) wv[j] = ok[j] ? to_f(w[(size_t)kk * n + col[j]]) : 0.f;
    const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * kRows);
    const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * kRows + 4);
    const float a[kRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(a[r], wv[j], acc[r][j]);
  }
}

// ---------------------------------------------------------------------------
// The projection y[T, n] = x[T, k] . w[k, n] (encode: w = E; decode: w = D).
// Grid (n tiles, T tiles) of 64 x 64 output tiles; a block walks K in steps
// of kBK and writes its tile of y in x's type.

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;            // output rows per block
constexpr int kBN = 64;            // output columns per block
constexpr int kBK = 64;            // K per step
constexpr int kPThreads = 128;     // f32: 8 x 16 threads over the tile
constexpr int kMmaThreads = 128;   // bf16: one warpgroup
constexpr int kStages = 4;         // bf16 ring depth
static_assert(kStages >= 3, "a slot is refilled a barrier before it is read");
constexpr int kTile = 64 * 64;     // bf16 values of an X or W tile in the ring
constexpr int kLdT = kBM + 4;      // f32 smem row (float4 reads stay aligned)
static_assert(kBM == 64 && kBN == 64 && kBK == 64, "tile rows are 64 values wide");
// the ring (+ slack to align it to 1024 B, as TMA's 128-byte swizzle wants)
constexpr size_t kMmaSmem = sizeof(bf16) * kStages * 2 * kTile + 1024;

// Index of value (row, col) in a ring tile: rows of 64 values (128 B) whose
// 16-byte chunks are XOR-swizzled by row % 8, the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads.
__device__ __forceinline__ int swz(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

// Stage K step [kk0, kk0 + kBK) of the block without TMA (k or n not a
// multiple of 8, or an operand not 16-byte aligned): synchronous scalar
// loads, zeros past the edges, into the same swizzled layout, fenced for
// wgmma's reads.
__device__ __forceinline__ void stage_scalar(const bf16* __restrict__ x,
                                             const bf16* __restrict__ w, bf16* xs,
                                             bf16* ws, int r0, int c0, int kk0,
                                             int nt, int k, int n) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < kTile; e += kMmaThreads) {
    const int row = e >> 6, col = e & 63;
    const int gr = r0 + row, gk = kk0 + col;
    xs[swz(row, col)] = gr < nt && gk < k ? x[(size_t)gr * k + gk] : zero;
    const int wk = kk0 + row, gc = c0 + col;
    ws[swz(row, col)] = wk < k && gc < n ? w[(size_t)wk * n + gc] : zero;
  }
  tc::fence_proxy_async();
}

// bf16: one warpgroup per 64 x 64 tile; each K step is four wgmma of
// 64 x 64 x 16 reading X (K-major) and W (a row-major [k][n] tile, so
// MN-major) straight from the ring slot in TMA's 128-byte swizzle.  kTma:
// thread 0 fills each slot with two TMA copies (X rows x K, W K x columns;
// the hardware zero-fills past T, k and n) that complete on the slot's
// mbarrier; otherwise all threads stage it with scalar loads.
template <bool kTma>
__global__ void __launch_bounds__(kMmaThreads) project_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
    const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ y,
    int nt, int k, int n) {
  extern __shared__ unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                     ~uintptr_t(1023));  // [kStages][kTile]
  bf16* ws = xs + kStages * kTile;                        // [kStages][kTile]
  __shared__ uint64_t full[kStages];
  const int c0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;
  const int ns = (k + kBK - 1) / kBK;

  if (kTma && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) tc::mbar_init(&full[i], 1);
    tc::fence_mbar_init();
  }
  __syncthreads();
  const CUtensorMap *mx = &tmx, *mw = &tmw;  // in parameter space, where TMA reads them
  auto stage = [&](int i) {  // K step i of the block into slot i % kStages
    const int sl = i % kStages, kk0 = i * kBK;
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        tc::mbar_expect_tx(&full[sl], 2 * kTile * sizeof(bf16));
        tc::tma_load_2d(xs + sl * kTile, mx, &full[sl], kk0, r0);
        tc::tma_load_2d(ws + sl * kTile, mw, &full[sl], c0, kk0);
      }
    } else {
      stage_scalar(x, w, xs + sl * kTile, ws + sl * kTile, r0, c0, kk0, nt, k, n);
    }
  };

  float d[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) d[j] = 0.f;
  for (int i = 0; i < kStages - 1 && i < ns; ++i) stage(i);
  // scalar loads: every warp's wgmma reads the slots the other warps wrote
  if constexpr (!kTma) __syncthreads();
  for (int i = 0; i < ns; ++i) {
    const int sl = i % kStages;
    if constexpr (kTma) tc::mbar_wait(&full[sl], (i / kStages) & 1);  // step i has landed
    const uint64_t da = tc::wgmma_desc_sw128(xs + sl * kTile);
    const uint64_t db = tc::wgmma_desc_sw128(ws + sl * kTile);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // 16 K: 32 B along an X row, 16 rows of W
      tc::wgmma_m64n64k16_bf16(d, da + (32 >> 4) * kk, db + (2048 >> 4) * kk);
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // step i - 1's products are done (step i's run on)
    __syncthreads();      // in every warp: its slot is free
    if (i + kStages - 1 < ns) stage(i + kStages - 1);
  }
  tc::wgmma_wait<0>();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + j * 8 + 2 * t;
      if (col >= n) continue;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (kTma) {  // n is a multiple of 8: col + 1 < n, and the pair is aligned
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * n + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        bf16* q = y + (size_t)row * n + col;
        q[0] = __float2bfloat16(v0);
        if (col + 1 < n) q[1] = __float2bfloat16(v1);
      }
    }
  }
}

// f32, exact (CUDA-core FMAs, no TF32), on the same grid: X^T and W tiles
// in shared memory, thread (ty, tx) of 8 x 16 accumulates rows 8ty..8ty+7
// at columns tx + 16j.
__global__ void __launch_bounds__(kPThreads) project_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
    int nt, int k, int n) {
  __shared__ __align__(16) float xs[kBK * kLdT];  // X^T [kBK][kLdT]
  __shared__ __align__(16) float ws[kBK * kBN];   // [kBK][kBN]
  const int c0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;
  const int ns = (k + kBK - 1) / kBK;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int i = 0; i < ns; ++i) {
    const int kk0 = i * kBK;
    for (int e = threadIdx.x; e < kBM * kBK; e += kPThreads) {
      const int row = e >> 6, kk = e & 63;
      const int gr = r0 + row, gk = kk0 + kk;
      xs[kk * kLdT + row] = gr < nt && gk < k ? x[(size_t)gr * k + gk] : 0.f;
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kPThreads) {
      const int kk = e >> 6, c = e & 63;
      const int gk = kk0 + kk, gc = c0 + c;
      ws[kk * kBN + c] = gk < k && gc < n ? w[(size_t)gk * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + kk * kLdT + ty * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + kk * kLdT + ty * 8 + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk * kBN + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = r0 + ty * 8 + r;
    if (row >= nt) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < n) y[(size_t)row * n + col] = acc[r][j];
    }
  }
}

// Sum of a block's per-thread values in a fixed order (warp shuffles, then
// the warps in order); the total lands in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < (int)(blockDim.x / 32); ++i) total += red[i];
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) roundtrip_kernel(
    const T* __restrict__ x, const T* __restrict__ enc,
    const T* __restrict__ dec, T* __restrict__ xhat,
    float* __restrict__ partial, int nt, int d, int r) {
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // [d][kRows]
  float* z_s = x_s + (size_t)d * kRows;          // [r][kRows], f32
  __shared__ float red[kThreads / 32];
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, nt - r0);
  load_rows(x, r0, nr, d, x_s);
  __syncthreads();
  for (int c0 = 0; c0 < r; c0 += kPass) {
    float acc[kRows][kCols];
    rows_times_w(x_s, d, enc, r, c0, acc);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + threadIdx.x + j * kThreads;
      if (c < r) {
#pragma unroll
        for (int row = 0; row < kRows; ++row) z_s[c * kRows + row] = acc[row][j];
      }
    }
  }
  __syncthreads();
  float sq = 0.f;
  for (int c0 = 0; c0 < d; c0 += kPass) {
    float acc[kRows][kCols];
    rows_times_w(z_s, r, dec, d, c0, acc);
#pragma unroll
    for (int row = 0; row < kRows; ++row) {
      if (row >= nr) break;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + threadIdx.x + j * kThreads;
        if (c < d) {
          xhat[(size_t)(r0 + row) * d + c] = from_f<T>(acc[row][j]);
          const float diff = x_s[c * kRows + row] - acc[row][j];
          sq = fmaf(diff, diff, sq);
        }
      }
    }
  }
  const float total = block_sum(sq, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// err = sum of partial[0..nb) in a fixed order (one block).
__global__ void __launch_bounds__(kThreads) sum_partials_kernel(
    const float* __restrict__ partial, int nb, float* __restrict__ err) {
  __shared__ float red[kThreads / 32];
  float s = 0.f;
  for (int i = threadIdx.x; i < nb; i += kThreads) s += partial[i];
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) *err = total;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

cudaError_t launch_tiles(const float* x, const float* w, float* y, int nt, int k, int n,
                         dim3 grid, cudaStream_t stream) {
  project_f32_kernel<<<grid, kPThreads, 0, stream>>>(x, w, y, nt, k, n);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f)
                                            : nullptr;
  }();
  return fn;
}

// A row-major bf16 [rows, cols] array as 64 x 64 boxes, 128-byte swizzled,
// zeros past its edges.
bool tile_map(CUtensorMap* map, const bf16* base, int rows, int cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64}, unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_tiles(const bf16* x, const bf16* w, bf16* y, int nt, int k, int n,
                         dim3 grid, cudaStream_t stream) {
  // TMA wants 16-byte aligned bases and row strides
  const bool tma = k % 8 == 0 && n % 8 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  CUtensorMap tmx{}, tmw{};
  if (tma && !(tile_map(&tmx, x, nt, k) && tile_map(&tmw, w, k, n))) return cudaErrorInvalidValue;
  auto kernel = tma ? project_wgmma_kernel<true> : project_wgmma_kernel<false>;
  cudaError_t err = allow_smem(kernel, kMmaSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, kMmaSmem, stream>>>(tmx, tmw, x, w, y, nt, k, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t project(const void* x, const void* w, void* y, int nt, int k, int n,
                    cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (nt + kBM - 1) / kBM);
  return launch_tiles(static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
                      nt, k, n, grid, stream);
}

template <typename T>
cudaError_t roundtrip(const void* x, const void* enc, const void* dec,
                      void* xhat, float* partial, float* err_out, int nt,
                      int d, int r, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)kRows * (d + r);
  cudaError_t err = allow_smem(roundtrip_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int nb = (nt + kRows - 1) / kRows;
  roundtrip_kernel<T><<<nb, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(enc),
      static_cast<const T*>(dec), static_cast<T*>(xhat), partial, nt, d, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, kThreads, 0, stream>>>(partial, nb, err_out);
  return cudaGetLastError();
}

}  // namespace

// y[nt, n] = x[nt, k] . w[k, n] on 64 x 64 output tiles.  dtype: 0 =
// float32, 1 = bfloat16.  Returns the launch's cudaError_t (0 = launched).
extern "C" int lowrank_project_launch(const void* x, const void* w, void* y, int nt,
                                      int k, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)project<bf16>(x, w, y, nt, k, n, s);
  return (int)project<float>(x, w, y, nt, k, n, s);
}

// xhat = (x . enc) . dec, err = sum (x - xhat)^2 in f32.  partial is f32
// [ceil(nt / 8)].  dtype: 0 = float32, 1 = bfloat16.
extern "C" int lowrank_roundtrip_launch(const void* x, const void* enc,
                                        const void* dec, void* xhat,
                                        void* partial, void* err, int nt,
                                        int d, int r, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* e = static_cast<float*>(err);
  if (dtype == 1)
    return (int)roundtrip<__nv_bfloat16>(x, enc, dec, xhat, p, e, nt, d, r, s);
  return (int)roundtrip<float>(x, enc, dec, xhat, p, e, nt, d, r, s);
}

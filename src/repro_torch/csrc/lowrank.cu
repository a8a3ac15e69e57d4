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
// What bounds it on the H100: at the boundary's shapes (T = 1024 tokens,
// d = 768, r = 384, bf16) a product moves ~3 MB and does ~0.6 GFLOP, about
// 200 flops a byte -- under the ~295 where the bf16 tensor cores would bind,
// so the floor is bytes (~0.9 us).  This first kernel computes on the CUDA
// cores in f32 (the f32 form must stay exact: no TF32), and at T = 1024 its
// 128 blocks of 4 warps leave the latency of the weight loads exposed, far
// from even the f32 FMA rate (times in PERF.md).  Splitting the output
// columns over more blocks, staging W tiles in shared memory, and bf16
// tensor-core tiles for the bf16 form are the next steps.
//
// Design: one block per tile of kRows = 8 token rows; any T (the tail tile
// is masked, where the Pallas version asserted T % block == 0).  The block
// stages its rows in shared memory in f32, transposed ([k][kRows]) so a
// thread reads the 8 row values of one k as two float4 broadcasts, and its
// 128 threads each accumulate kCols = 4 output columns (strided by 128, so
// the weight loads and the output stores are coalesced) for all 8 rows.
// One body, rows_times_w, serves all three entries.  The fused roundtrip
// keeps Z in shared memory in f32 (never rounded, never written to HBM),
// writes X^ once, and writes one f32 partial of sum (X - X^)^2 per block
// (from the unrounded f32 X^, as the reference); a second one-block pass
// sums the partials in a fixed order, so the error is deterministic and
// needs no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// y[T, n] = x[T, k] . w[k, n]: encode (w = E) and decode (w = D).
template <typename T>
__global__ void __launch_bounds__(kThreads) project_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
    int nt, int k, int n) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [k][kRows]
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, nt - r0);
  load_rows(x, r0, nr, k, a_s);
  __syncthreads();
  for (int c0 = 0; c0 < n; c0 += kPass) {
    float acc[kRows][kCols];
    rows_times_w(a_s, k, w, n, c0, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nr) break;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = c0 + threadIdx.x + j * kThreads;
        if (c < n) y[(size_t)(r0 + r) * n + c] = from_f<T>(acc[r][j]);
      }
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

template <typename T>
cudaError_t project(const void* x, const void* w, void* y, int nt, int k,
                    int n, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)kRows * k;
  cudaError_t err = allow_smem(project_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  project_kernel<T><<<(nt + kRows - 1) / kRows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      nt, k, n);
  return cudaGetLastError();
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

// y[nt, n] = x[nt, k] . w[k, n].  dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int lowrank_project_launch(const void* x, const void* w, void* y,
                                      int nt, int k, int n, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)project<__nv_bfloat16>(x, w, y, nt, k, n, s);
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

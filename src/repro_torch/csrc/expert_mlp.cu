// Grouped expert FFN for Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/expert_mlp/kernel.py, in the
// role the port gives them:
//   * expert_mlp_pallas (_body, _kernel, _kernel_nogate): the grouped GEMM
//     of core/moe.py::_grouped_mlp over rows sorted by expert,
//         y[rows of e] = act(xs @ wi[e]) [* (xs @ wg[e])] @ wo[e];
//   * expert_mlp_resident_pallas (_kernel_resident[_nogate]): the same
//     product over rows sorted by resident slot, where slot s reads the slab
//     row ids[s] of the end tier's expert store -- the gather
//     store[ids] and the ragged product of core/moe.py::moe_resident in one
//     kernel, with the store read in place;
//   * its int8-store bodies (_kernel_resident_quant[_nogate]): the slabs
//     hold int8 codes with one f32 scale per output column (wi_scale,
//     wg_scale [N+1, f], wo_scale [N+1, d]), and each weight is read as
//     T(f32(code) * scale[ids[s], col]) -- the dequantize-then-cast that
//     core/moe.py::moe_resident runs before its grouped product.  (The
//     Pallas body folds the scale in after the dot, which rounds otherwise;
//     the port follows the consumer the engine runs.)  An int8 slab is a
//     quarter of the f32 slab's bytes, plus its scales.
// group_sizes gives each group's run of rows (empty runs allowed; rows past
// sum(group_sizes) come back 0, as ragged_dot leaves them).
//
// Weights may be stored in a wider type than the rows (the slab store keeps
// the params' f32): each weight is rounded to the rows' type as it is read,
// which is ragged_dot(xs, w.astype(xs.dtype)) without a rounded copy of the
// store.  One group (zero_group, the resident path's garbage slot) reads no
// weights and writes zero rows: its slab is all zeros and act(0) = 0.
//
// What bounds it on the H100: bytes, at serving shapes.  Top-1 decode over
// 8 slots puts about one row on each expert, so the work is a matrix-vector
// product per expert: every weight element (2 bytes in bf16, 4 in the f32
// slab store) is read for ~2 flops a row, far under the ~295 flops a byte
// where the tensor cores would bind.  The kernel's job is therefore to read
// each routed group's weights once, with coalesced loads spread over many
// SMs, and never to read an unrouted group's weights at all.
//
// Design: one block per (hidden tile of 64 columns, group, tile of 8 rows).
// A block loads its rows of xs (f32 in shared memory), computes the hidden
// tile h = act(x @ wi[:, tile]) [* (x @ wg[:, tile])] in f32 -- 256 threads,
// four k-slices of 64 coalesced columns -- keeps h in shared memory, and
// multiplies it by the matching 64 rows of wo.  The hidden activation never
// reaches HBM, which is what expert_mlp_pallas keeps out of it too.  On the
// TPU the ff tiles were a sequential grid axis accumulating into one VMEM
// block; here they run in parallel on different SMs, so each writes its
// partial y into a small f32 scratch [n_tiles, n, d] and a second pass sums
// the partials in a fixed order (deterministic, no atomics) and rounds once
// to the output type.  Blocks whose group has no rows in their row tile
// exit at once, so unrouted experts cost nothing.  A row's arithmetic does
// not depend on which rows share its tile or on the slab it is read
// through, so the resident and the dense path give the same bits for a row
// routed to the same expert.
//
// Later: wgmma tiles with TMA-fed shared memory for prefill-sized groups,
// and 16-byte vector loads of the weight rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kRows = 8;     // rows of xs per block
constexpr int kTile = 64;    // hidden columns per block
constexpr int kSlices = 4;   // k-slices of the first product
constexpr int kThreads = kTile * kSlices;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float to_f(signed char x) { return (float)x; }

// weight of storage type W as the rows' type T sees it, in f32; s is the
// weight's column scale (int8 codes only)
template <typename T, typename W>
__device__ __forceinline__ float wload(const W* p, float s) {
  if constexpr (std::is_same<W, signed char>::value) return to_f(from_f<T>(to_f(*p) * s));
  else if constexpr (std::is_same<T, W>::value) return to_f(*p);
  else return to_f(from_f<T>(to_f(*p)));
}

// 0 = silu, 1 = gelu (tanh form, as jax.nn.gelu), 2 = relu
template <int ACT>
__device__ __forceinline__ float act(float x) {
  if (ACT == 0) return x / (1.f + expf(-x));
  if (ACT == 1) {
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.f + tanhf(u));
  }
  return fmaxf(x, 0.f);
}

template <typename T, typename W, int ACT, bool GATED>
__global__ void __launch_bounds__(kThreads) expert_ffn_kernel(
    const T* __restrict__ xs,           // [n, d] sorted by group
    const int* __restrict__ group_sizes,  // [G]
    const int* __restrict__ ids,        // [G] slab row of each group, or null
    const W* __restrict__ wi,           // [slabs, d, f]
    const W* __restrict__ wg,           // [slabs, d, f] (GATED only)
    const W* __restrict__ wo,           // [slabs, f, d]
    const float* __restrict__ wis,      // [slabs, f] (int8 W only)
    const float* __restrict__ wgs,      // [slabs, f] (int8 W, GATED only)
    const float* __restrict__ wos,      // [slabs, d] (int8 W only)
    float* __restrict__ partial,        // [n_tiles, n, d]
    int n, int d, int f, int zero_group) {
  constexpr bool kQuant = std::is_same<W, signed char>::value;
  const int tile = blockIdx.x, e = blockIdx.y, rt = blockIdx.z;
  const int tid = threadIdx.x;
  __shared__ int s_start, s_count;
  if (tid == 0) {
    int off = 0;
    for (int i = 0; i < e; ++i) off += group_sizes[i];
    s_start = off;
    s_count = group_sizes[e];
  }
  __syncthreads();
  const int r0 = s_start + rt * kRows;
  // rows past n (group sizes summing beyond the row count) are never read
  const int nr = min(min(kRows, s_count - rt * kRows), n - r0);
  if (nr <= 0) return;  // the same for every thread of the block
  if (e == zero_group) {  // all-zero slab: zero rows, no weight read
    for (int i = tid; i < nr * d; i += kThreads)
      partial[((size_t)tile * n + r0) * d + i] = 0.f;
    return;
  }
  const size_t slab = ids != nullptr ? (size_t)ids[e] : (size_t)e;
  const int f0 = tile * kTile;
  const int nf = min(kTile, f - f0);

  extern __shared__ float smem[];
  float* x_s = smem;                                   // [kRows, d]
  float* part = x_s + kRows * d;                       // [kSlices, kRows, kTile]
  float* gpart = part + kSlices * kRows * kTile;       // same, GATED only
  float* h_s = gpart + (GATED ? kSlices * kRows * kTile : 0);  // [kRows, kTile]

  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d, k = i - r * d;
    x_s[i] = r < nr ? to_f(xs[(size_t)(r0 + r) * d + k]) : 0.f;
  }
  __syncthreads();

  // h tile, first product: thread (slice, col) sums k over its slice
  const int col = tid % kTile, slice = tid / kTile;
  float acc_i[kRows], acc_g[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc_i[r] = acc_g[r] = 0.f;
  if (col < nf) {
    const int span = (d + kSlices - 1) / kSlices;
    const int k0 = slice * span, k1 = min(d, k0 + span);
    const W* wi_c = wi + slab * d * f + f0 + col;
    const W* wg_c = GATED ? wg + slab * d * f + f0 + col : nullptr;
    const float si = kQuant ? wis[slab * f + f0 + col] : 1.f;
    const float sg = kQuant && GATED ? wgs[slab * f + f0 + col] : 1.f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float w = wload<T>(wi_c + (size_t)k * f, si);
      const float wgv = GATED ? wload<T>(wg_c + (size_t)k * f, sg) : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = x_s[r * d + k];
        acc_i[r] = fmaf(xv, w, acc_i[r]);
        if (GATED) acc_g[r] = fmaf(xv, wgv, acc_g[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    part[(slice * kRows + r) * kTile + col] = acc_i[r];
    if (GATED) gpart[(slice * kRows + r) * kTile + col] = acc_g[r];
  }
  __syncthreads();

  for (int i = tid; i < kRows * kTile; i += kThreads) {
    float hi = 0.f, hg = 0.f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) {
      hi += part[s * kRows * kTile + i];
      if (GATED) hg += gpart[s * kRows * kTile + i];
    }
    float h = act<ACT>(hi);
    if (GATED) h *= hg;
    h_s[i] = h;
  }
  __syncthreads();

  // partial y = h tile @ wo[e, f0:f0+nf, :]
  const W* wo_t = wo + (slab * f + f0) * d;
  for (int c = tid; c < d; c += kThreads) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const float so = kQuant ? wos[slab * d + c] : 1.f;
#pragma unroll 4
    for (int j = 0; j < nf; ++j) {
      const float w = wload<T>(wo_t + (size_t)j * d + c, so);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(h_s[r * kTile + j], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr) partial[((size_t)tile * n + r0 + r) * d + c] = acc[r];
  }
}

// y[row] = sum over tiles of partial[tile, row], in tile order; rows past
// sum(group_sizes) are 0.
template <typename T>
__global__ void reduce_tiles_kernel(const float* __restrict__ partial,
                                    const int* __restrict__ group_sizes,
                                    T* __restrict__ y, int n, int d,
                                    int n_tiles, int E) {
  const int row = blockIdx.x;
  __shared__ int s_total;
  if (threadIdx.x == 0) {
    int t = 0;
    for (int i = 0; i < E; ++i) t += group_sizes[i];
    s_total = t;
  }
  __syncthreads();
  const bool live = row < s_total;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    if (live)
      for (int t = 0; t < n_tiles; ++t) s += partial[((size_t)t * n + row) * d + c];
    y[(size_t)row * d + c] = from_f<T>(s);
  }
}

template <typename T, typename W, int ACT, bool GATED>
cudaError_t launch_ffn(const void* xs, const int* gs, const int* ids,
                       const void* wi, const void* wg, const void* wo,
                       const float* const* scales, float* partial, int n,
                       int d, int f, int G, int zero_group,
                       cudaStream_t stream) {
  const int n_tiles = (f + kTile - 1) / kTile;
  const int row_tiles = (n + kRows - 1) / kRows;  // bound: all rows in one group
  const size_t smem = sizeof(float) * ((size_t)kRows * d +
                                       (GATED ? 2 : 1) * kSlices * kRows * kTile +
                                       kRows * kTile);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        expert_ffn_kernel<T, W, ACT, GATED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  expert_ffn_kernel<T, W, ACT, GATED>
      <<<dim3(n_tiles, G, row_tiles), kThreads, smem, stream>>>(
          static_cast<const T*>(xs), gs, ids, static_cast<const W*>(wi),
          static_cast<const W*>(wg), static_cast<const W*>(wo), scales[0],
          scales[1], scales[2], partial, n, d, f, zero_group);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch(const void* xs, const void* group_sizes, const void* ids,
                   const void* wi, const void* wg, const void* wo,
                   const float* const* scales, void* partial, void* y, int n,
                   int d, int f, int G, int act, int zero_group,
                   cudaStream_t stream) {
  const int* gs = static_cast<const int*>(group_sizes);
  const int* id = static_cast<const int*>(ids);
  float* part = static_cast<float*>(partial);
  cudaError_t err;
  const bool gated = wg != nullptr;
#define EXPERT_FFN_CASE(A)                                                    \
  if (act == A)                                                               \
    err = gated ? launch_ffn<T, W, A, true>(xs, gs, id, wi, wg, wo, scales,    \
                                            part, n, d, f, G, zero_group,      \
                                            stream)                            \
                : launch_ffn<T, W, A, false>(xs, gs, id, wi, wg, wo, scales,   \
                                             part, n, d, f, G, zero_group,     \
                                             stream);
  EXPERT_FFN_CASE(0)
  else EXPERT_FFN_CASE(1)
  else EXPERT_FFN_CASE(2)
  else return cudaErrorInvalidValue;
#undef EXPERT_FFN_CASE
  if (err != cudaSuccess) return err;
  const int n_tiles = (f + kTile - 1) / kTile;
  reduce_tiles_kernel<T><<<n, 256, 0, stream>>>(part, gs, static_cast<T*>(y),
                                                n, d, n_tiles, G);
  return cudaGetLastError();
}

}  // namespace

// act: 0 = silu, 1 = gelu (tanh), 2 = relu.  wg may be null (no gate).
// dtype (rows and y): 0 = float32, 1 = bfloat16; wdtype (weights): 0 =
// float32, 1 = bfloat16, 2 = int8 codes with f32 column scales wis, wgs
// [slabs, f] and wos [slabs, d] (null otherwise); the pairs taken are
// (0, 0), (1, 1), (1, 0), (0, 2) and (1, 2).  ids [G] (null = identity)
// names the slab row group g reads; group zero_group (-1 = none) reads no
// weights and comes back 0.  partial is f32 [ceil(f/64), n, d].  Returns
// the launches' cudaError_t (0 = launched).
extern "C" int expert_mlp_launch(const void* xs, const void* group_sizes,
                                 const void* ids, const void* wi,
                                 const void* wg, const void* wo,
                                 const void* wis, const void* wgs,
                                 const void* wos, void* partial, void* y, int n,
                                 int d, int f, int G, int act, int dtype,
                                 int wdtype, int zero_group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* scales[3] = {static_cast<const float*>(wis),
                            static_cast<const float*>(wgs),
                            static_cast<const float*>(wos)};
#define EXPERT_MLP_CASE(DT, WDT, T, W)                                        \
  if (dtype == DT && wdtype == WDT)                                           \
    return (int)launch<T, W>(xs, group_sizes, ids, wi, wg, wo, scales,        \
                             partial, y, n, d, f, G, act, zero_group, s);
  EXPERT_MLP_CASE(1, 1, __nv_bfloat16, __nv_bfloat16)
  EXPERT_MLP_CASE(1, 0, __nv_bfloat16, float)
  EXPERT_MLP_CASE(0, 0, float, float)
  EXPERT_MLP_CASE(1, 2, __nv_bfloat16, signed char)
  EXPERT_MLP_CASE(0, 2, float, signed char)
#undef EXPERT_MLP_CASE
  return (int)cudaErrorInvalidValue;
}

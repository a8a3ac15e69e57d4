// Symmetric int8 quantize / dequantize of lines for Hopper (sm_90a).
//
// Replaces repro/kernels/quant/kernel.py::quantize_rows_pallas
// (_quantize_kernel) and dequantize_rows_pallas (_dequantize_kernel), and
// computes what the reference's consumers compute in jnp with the same
// contract (models/kvcache.py::quantize_kv_tokens,
// core/compression.py::quantize_boundary / dequantize_boundary,
// core/expertpool.py::quantize_slab): for each line x of n values
//     s = S(max(amax(|x|) / 127, 1e-8))     rounded to the scale's type S
//     q = clip(rint(x / f32(s)), -127, 127)  NaN -> 0
// and back, y = T(f32(q) * f32(s)).  The rules live in quant.cuh, shared
// with the codec's fused boundary forms (lowrank.cu).
//
// The codes must be bit-equal to the reference's: tokens downstream depend
// on them.  Hence the scale is rounded to its storage type before the
// divide; the divides are IEEE (__fdiv_rn), and where the column form codes
// from the line's reciprocal instead, that is provably the divide's code
// (quant.cuh's quant_fast); rint rounds half to even as jnp.round does.
//
// What bounds it on the H100.  Row lines (KV tokens, a raw boundary: 4-32
// rows of 384-768 values) are latency-bound far under the HBM rate: a
// launch is ~2 us, the bytes a few ns.  The slab store's column lines (one
// 768 x 3072 f32 matrix: 9.4 MB read, 2.4 MB of codes written) are bound
// by bytes, ~3.5 us, if the card is filled.
//
// Design.  Row lines: one warp a line; where the line is a whole number of
// 16-byte loads (and at most 16 of them a lane) each lane keeps its loads
// in registers, so the line is read once, and stores its codes 4 (f32) or
// 8 (bf16) bytes at a time; other lines take the generic form (lanes
// striding the line, read twice).  Column lines ([outer, n, inner] reduced
// over n, the slab's scale per output column): a block takes a tile of 32
// (f32) or 64 (bf16) neighbouring columns, 8 threads across it with a
// 16-byte load each and 32 across the rows, and a slice of the reduced
// axis; the slices of one column tile are the blocks of a thread-block
// cluster (cols_plan in kernels/quant/ops.py picks 1-8 so the grid fills
// the card), which exchange their partial column maxima through
// distributed shared memory (quant.cuh).  Each block keeps its slice in shared memory
// where it fits (else reads it again) and quantizes it.  Dequantize: one
// warp a row, the scale read once, 16 codes a 16-byte load and 16-byte
// stores where the row allows.
//
// The int8 KV pools' layer write (paged_write_quant_kernel) fuses what the
// serving path did in ten-odd small launches a layer (two row quantizations,
// the page-slot arithmetic, four scatters): one launch quantizes a layer's
// k and v for all B x C tokens and writes codes and scales straight into
// their page slots.  One warp a token line (its k or its v): the physical
// row table[b, (pos // ps) % pps] (negative entries wrap as a Python index
// does; rows not valid go to the garbage row, the pool's last), the offset
// pos % ps; the line quantized as a row line in registers.  Bound by launch
// latency: a decode group writes 4 tokens.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

namespace cg = cooperative_groups;
using q8::to_f;

constexpr int kWarps = 4;      // row lines per block
constexpr int kMaxLoads = 16;  // 16-byte loads a lane keeps: a line of <= 512 loads
constexpr int kColThreads = 256;
constexpr int kColTx = 8;                     // threads across a column tile
constexpr int kColTy = kColThreads / kColTx;  // threads across the block's rows
constexpr int kColStageBytes = 96 * 1024;     // a block's staged slice at most
constexpr int kDeqWarps = 4;                  // rows per dequantize block
constexpr int kMaxCluster = 8;                // the portable cluster size

template <typename T> struct Line;
template <> struct Line<float> {  // 4 values a 16-byte load, codes 4 bytes a store
  static constexpr int n = 4;
  using Codes = unsigned int;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Line<__nv_bfloat16> {  // 8 values a 16-byte load, codes 8 bytes
  static constexpr int n = 8;
  using Codes = uint2;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// One warp quantizes the line src[0, n) (n a multiple of Line<T>::n, src
// 16-byte aligned, dst Line<T>::n-byte aligned) into dst, lane 0 writing
// its scale to *scale_out: NL 16-byte loads a lane kept in registers (a
// power of two, >= n / (32 * Line<T>::n)), so the line is read once.
template <typename T, typename S, int NL>
__device__ __forceinline__ void quantize_line(const T* __restrict__ src, int n,
                                              signed char* __restrict__ dst, S* scale_out,
                                              int lane) {
  using L = Line<T>;
  const int loads = n / L::n;
  float vals[NL][L::n];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int idx = lane + 32 * j;
    if (idx < loads) {
      L::load(src + idx * L::n, vals[j]);
#pragma unroll
      for (int i = 0; i < L::n; ++i) amax = fmaxf(amax, fabsf(vals[j][i]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const S s = q8::line_scale<S>(amax);
  if (lane == 0) *scale_out = s;
  const float sf = to_f(s);
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int idx = lane + 32 * j;
    if (idx < loads) {
      typename L::Codes packed;
      signed char* c = reinterpret_cast<signed char*>(&packed);
#pragma unroll
      for (int i = 0; i < L::n; ++i) c[i] = q8::quant(vals[j][i], sf);
      *reinterpret_cast<typename L::Codes*>(dst + idx * L::n) = packed;
    }
  }
}

// Row lines, one warp a line, in registers (see quantize_line).
template <typename T, typename S, int NL>
__global__ void __launch_bounds__(32 * kWarps) quantize_rows_vec_kernel(
    const T* __restrict__ x, signed char* __restrict__ q, S* __restrict__ scale, int rows,
    int n) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the same for the whole warp
  quantize_line<T, S, NL>(x + (size_t)row * n, n, q + (size_t)row * n, scale + row,
                          threadIdx.x & 31);
}

// Row lines of any width or alignment: lanes stride the line, read twice.
template <typename T, typename S>
__global__ void __launch_bounds__(32 * kWarps) quantize_rows_kernel(
    const T* __restrict__ x, signed char* __restrict__ q, S* __restrict__ scale,
    int rows, int n) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the same for the whole warp
  const T* xr = x + (size_t)row * n;
  float amax = 0.f;
  for (int i = lane; i < n; i += 32) amax = fmaxf(amax, fabsf(to_f(xr[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const S s = q8::line_scale<S>(amax);
  if (lane == 0) scale[row] = s;
  const float sf = to_f(s);
  signed char* qr = q + (size_t)row * n;
  for (int i = lane; i < n; i += 32) qr[i] = q8::quant(to_f(xr[i]), sf);
}

// Column lines of x [outer, n, inner] (grid: column tiles x cluster size,
// outer).  Block (tile, rank) of a cluster of cs takes the tile's kColTx *
// Line<T>::n columns over rows [rank * rows, (rank + 1) * rows) of n; each
// thread its 16 bytes of neighbouring columns (vec: inner a multiple of
// Line<T>::n and x 16-byte aligned; else scalar loads, zeros past inner).
// staged: the slice is kept in shared memory between the two passes.
template <typename T, typename S>
__global__ void __launch_bounds__(kColThreads) quantize_cols_kernel(
    const T* __restrict__ x, signed char* __restrict__ q, S* __restrict__ scale, int n,
    int inner, int rows, bool staged, bool vec) {
  constexpr int V = Line<T>::n, CW = kColTx * V;
  q8::cluster_arrive();  // met before the partials are pushed
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / cs;
  const int tx = threadIdx.x % kColTx, ty = threadIdx.x / kColTx;
  const int c = tx * V, col = tile * CW + c;
  const int ncols = min(V, inner - col);  // <= 0: every column past inner
  const int i0 = rank * rows, i1 = min(n, i0 + rows);
  const size_t base = (size_t)blockIdx.y * n * inner;
  extern __shared__ uint4 stage[];  // [rows][CW] of T when staged
  __shared__ float red[kColTy][CW];
  __shared__ float part[kMaxCluster * CW];  // the cluster's partial maxima, [rank][CW]

  auto load = [&](int i, T (&raw)[V]) {
    const T* p = x + base + (size_t)i * inner + col;
    if (vec) {
      *reinterpret_cast<uint4*>(raw) = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) raw[e] = e < ncols ? p[e] : q8::from_f<T>(0.f);
    }
  };
  T* st = reinterpret_cast<T*>(stage);

  float amax[V];
#pragma unroll
  for (int e = 0; e < V; ++e) amax[e] = 0.f;
  if (ncols > 0) {
    for (int i = i0 + ty; i < i1; i += kColTy) {
      alignas(16) T raw[V];
      load(i, raw);
      if (staged)
        *reinterpret_cast<uint4*>(st + (size_t)(i - i0) * CW + c) =
            *reinterpret_cast<const uint4*>(raw);
#pragma unroll
      for (int e = 0; e < V; ++e) amax[e] = fmaxf(amax[e], fabsf(to_f(raw[e])));
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) red[ty][c + e] = amax[e];
  __syncthreads();
  q8::cluster_wait();
  if (threadIdx.x < CW) {
    float m = 0.f;
#pragma unroll 8
    for (int r = 0; r < kColTy; ++r) m = fmaxf(m, red[r][threadIdx.x]);
    q8::push_partial<CW>(part, threadIdx.x, m);
  }
  cluster.sync();  // every block's partials are in every block's table
  if (ncols <= 0) return;
  float s[V], rs[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const S se = q8::line_scale<S>(q8::line_max<CW>(part, c + e, cs));
    if (rank == 0 && ty == 0 && e < ncols) scale[(size_t)blockIdx.y * inner + col + e] = se;
    s[e] = to_f(se);
    rs[e] = q8::recip(s[e]);
  }
  for (int i = i0 + ty; i < i1; i += kColTy) {
    alignas(16) T raw[V];
    if (staged)
      *reinterpret_cast<uint4*>(raw) =
          *reinterpret_cast<const uint4*>(st + (size_t)(i - i0) * CW + c);
    else
      load(i, raw);
    typename Line<T>::Codes packed;
    signed char* codes = reinterpret_cast<signed char*>(&packed);
    bool ok = true;
#pragma unroll
    for (int e = 0; e < V; ++e) ok &= q8::quant_fast(to_f(raw[e]), rs[e], codes[e]);
    if (!ok) {
#pragma unroll
      for (int e = 0; e < V; ++e) codes[e] = q8::quant(to_f(raw[e]), s[e]);
    }
    signed char* dst = q + base + (size_t)i * inner + col;
    if (vec) {
      *reinterpret_cast<typename Line<T>::Codes*>(dst) = packed;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (e < ncols) dst[e] = codes[e];
    }
  }
}

// y[row] = T(f32(q[row]) * f32(scale[row])), one warp a row.  vec: n a
// multiple of 16 and q, y 16-byte aligned.
template <typename T, typename S>
__global__ void __launch_bounds__(32 * kDeqWarps) dequantize_rows_kernel(
    const signed char* __restrict__ q, const S* __restrict__ scale, T* __restrict__ y,
    int rows, int n, bool vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kDeqWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const signed char* qr = q + (size_t)row * n;
  T* yr = y + (size_t)row * n;
  if (vec) {
    // each chunk's load goes out before the previous chunk (or the scale)
    // is waited for
    constexpr int kStep = 32 * 16;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    int i = lane * 16;
    uint4 c = i < n ? *reinterpret_cast<const uint4*>(qr + i) : zero;
    const float s = to_f(scale[row]);
    for (; i < n; i += kStep) {
      const uint4 next = i + kStep < n ? *reinterpret_cast<const uint4*>(qr + i + kStep) : zero;
      alignas(16) T out[16];
      q8::dequant16(c, s, out);
#pragma unroll
      for (int k = 0; k < (int)sizeof(out) / 16; ++k)
        reinterpret_cast<uint4*>(yr + i)[k] = reinterpret_cast<const uint4*>(out)[k];
      c = next;
    }
  } else {
    const float s = to_f(scale[row]);
    for (int i = lane; i < n; i += 32) yr[i] = q8::dequant<T>(qr[i], s);
  }
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}
__device__ __forceinline__ int floor_mod(int a, int b) { return a - floor_div(a, b) * b; }

constexpr int kWriteWarps = 4;  // token lines per block

// lines 2 * tokens: line 2t is token t's k, 2t + 1 its v; token t = b * C + c.
// NL: 16-byte loads a lane keeps in registers (a power of two, >= n / (32 *
// Line::n)).
template <typename T, int NL>
__global__ void __launch_bounds__(32 * kWriteWarps) paged_write_quant_kernel(
    const T* __restrict__ k, const T* __restrict__ v, signed char* __restrict__ pool_k,
    signed char* __restrict__ pool_v, __half* __restrict__ pool_ks,
    __half* __restrict__ pool_vs, const int* __restrict__ table,
    const int* __restrict__ positions, const bool* __restrict__ valid, int tokens, int C,
    int n, int pps, int ps, int rows) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * kWriteWarps + (threadIdx.x >> 5);
  if (line >= 2 * tokens) return;  // the same for the whole warp
  const int t = line >> 1, b = t / C;
  const bool is_v = line & 1;
  const int pos = positions[t];
  int phys = table[b * pps + floor_mod(floor_div(pos, ps), pps)];
  if (phys < 0) phys += rows;
  if (valid != nullptr && !valid[t]) phys = rows - 1;
  const size_t slot = (size_t)phys * ps + floor_mod(pos, ps);
  quantize_line<T, __half, NL>((is_v ? v : k) + (size_t)t * n, n,
                               (is_v ? pool_v : pool_k) + slot * n,
                               (is_v ? pool_vs : pool_ks) + slot, lane);
}

// the kernel template instance of quantize_line for a line of n values:
// NL = the power of two >= n / (32 * Line<T>::n); -1 if n is not a whole
// number of 16-byte loads or needs more than kMaxLoads a lane
template <typename T>
int loads_per_lane(int n) {
  if (n % Line<T>::n) return -1;
  const int per_lane = (n / Line<T>::n + 31) / 32;
  for (int nl = 1; nl <= kMaxLoads; nl *= 2)
    if (per_lane <= nl) return nl;
  return -1;
}

template <typename T>
cudaError_t paged_write_quant(const void* k, const void* v, signed char* qk, signed char* qv,
                              __half* sk, __half* sv, const int* table, const int* positions,
                              const bool* valid, int B, int C, int n, int pps, int ps, int rows,
                              cudaStream_t stream) {
  const int tokens = B * C;
  const int nl = loads_per_lane<T>(n);
  if (nl < 0) return cudaErrorInvalidValue;
  const dim3 grid((2 * tokens + kWriteWarps - 1) / kWriteWarps), block(32 * kWriteWarps);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
#define PWQ(NL)                                                                       \
  paged_write_quant_kernel<T, NL><<<grid, block, 0, stream>>>(                       \
      kt, vt, qk, qv, sk, sv, table, positions, valid, tokens, C, n, pps, ps, rows)
  if (nl == 1) PWQ(1);
  else if (nl == 2) PWQ(2);
  else if (nl == 4) PWQ(4);
  else if (nl == 8) PWQ(8);
  else PWQ(16);
#undef PWQ
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, typename S>
cudaError_t quantize(const void* x, void* q, void* scale, int outer, int n, int inner,
                     int cluster, int staged, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  signed char* qt = static_cast<signed char*>(q);
  S* st = static_cast<S*>(scale);
  if (inner == 1) {
    const int nl = aligned16(x) ? loads_per_lane<T>(n) : -1;
    const dim3 grid((outer + kWarps - 1) / kWarps), block(32 * kWarps);
#define QR(NL) quantize_rows_vec_kernel<T, S, NL><<<grid, block, 0, stream>>>(xt, qt, st, outer, n)
    if (nl < 0) quantize_rows_kernel<T, S><<<grid, block, 0, stream>>>(xt, qt, st, outer, n);
    else if (nl == 1) QR(1);
    else if (nl == 2) QR(2);
    else if (nl == 4) QR(4);
    else if (nl == 8) QR(8);
    else QR(16);
#undef QR
    return cudaGetLastError();
  }
  constexpr int CW = kColTx * Line<T>::n;
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  const int rows = (n + cluster - 1) / cluster;
  const size_t smem = staged ? (size_t)rows * CW * sizeof(T) : 0;
  if (smem > (size_t)kColStageBytes) return cudaErrorInvalidValue;
  auto kernel = quantize_cols_kernel<T, S>;
  // once per instance: its static shared memory counts against the default
  // 48 KB too, so the limit is raised for any staged slice
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kColStageBytes);
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((inner + CW - 1) / CW) * cluster, outer);
  cfg.blockDim = dim3(kColThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const bool vec = inner % Line<T>::n == 0 && aligned16(x);
  return cudaLaunchKernelEx(&cfg, kernel, xt, qt, st, n, inner, rows, staged != 0, vec);
}

template <typename T, typename S>
cudaError_t dequantize(const void* q, const void* scale, void* y, int rows, int n,
                       cudaStream_t stream) {
  const bool vec = n % 16 == 0 && aligned16(q) && aligned16(y);
  dequantize_rows_kernel<T, S><<<(rows + kDeqWarps - 1) / kDeqWarps, 32 * kDeqWarps, 0,
                                 stream>>>(static_cast<const signed char*>(q),
                                           static_cast<const S*>(scale), static_cast<T*>(y),
                                           rows, n, vec);
  return cudaGetLastError();
}

}  // namespace

// x viewed as [outer, n, inner], quantized over n: inner == 1 is one scale
// per row (scale [outer]), inner > 1 one per column (scale [outer, inner]),
// the reduced axis split over a cluster of `cluster` blocks (1-8) whose
// slices are kept in shared memory if `staged` (kernels/quant/ops.py's
// cols_plan).  xdtype: 0 = float32, 1 = bfloat16.  sdtype: 0 = float32,
// 1 = float16.  Returns the launch's cudaError_t (0 = launched).
extern "C" int quantize_launch(const void* x, void* q, void* scale, int outer, int n,
                               int inner, int cluster, int staged, int xdtype, int sdtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xdtype == 0 && sdtype == 0)
    return (int)quantize<float, float>(x, q, scale, outer, n, inner, cluster, staged, s);
  if (xdtype == 0 && sdtype == 1)
    return (int)quantize<float, __half>(x, q, scale, outer, n, inner, cluster, staged, s);
  if (xdtype == 1 && sdtype == 0)
    return (int)quantize<__nv_bfloat16, float>(x, q, scale, outer, n, inner, cluster, staged,
                                               s);
  if (xdtype == 1 && sdtype == 1)
    return (int)quantize<__nv_bfloat16, __half>(x, q, scale, outer, n, inner, cluster, staged,
                                                s);
  return (int)cudaErrorInvalidValue;
}

// y[r, i] = ydtype(f32(q[r, i]) * f32(scale[r])) over rows of n.  ydtype:
// 0 = float32, 1 = bfloat16; sdtype as above.
extern "C" int dequantize_launch(const void* q, const void* scale, void* y, int rows, int n,
                                 int ydtype, int sdtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ydtype == 0 && sdtype == 0) return (int)dequantize<float, float>(q, scale, y, rows, n, s);
  if (ydtype == 0 && sdtype == 1) return (int)dequantize<float, __half>(q, scale, y, rows, n, s);
  if (ydtype == 1 && sdtype == 0)
    return (int)dequantize<__nv_bfloat16, float>(q, scale, y, rows, n, s);
  if (ydtype == 1 && sdtype == 1)
    return (int)dequantize<__nv_bfloat16, __half>(q, scale, y, rows, n, s);
  return (int)cudaErrorInvalidValue;
}

// One layer's int8 KV write: k, v [B, C, n] (xdtype 0 = float32, 1 =
// bfloat16; n = KV * hd, a multiple of 16 / sizeof(x), at most 512 loads'
// worth) quantized per token into pool_k, pool_v [rows, ps, n] int8 and
// pool_ks, pool_vs [rows, ps] float16 at table [B, pps] int32, positions
// [B * C] int32 and valid [B * C] bool (or null: every token valid).
// Returns the launch's cudaError_t (0 = launched).
extern "C" int paged_write_quant_launch(const void* k, const void* v, void* pool_k,
                                        void* pool_v, void* pool_ks, void* pool_vs,
                                        const void* table, const void* positions,
                                        const void* valid, int B, int C, int n, int pps,
                                        int ps, int rows, int xdtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  signed char* qk = static_cast<signed char*>(pool_k);
  signed char* qv = static_cast<signed char*>(pool_v);
  __half* sk = static_cast<__half*>(pool_ks);
  __half* sv = static_cast<__half*>(pool_vs);
  const int* tb = static_cast<const int*>(table);
  const int* pos = static_cast<const int*>(positions);
  const bool* vd = static_cast<const bool*>(valid);
  if (xdtype == 0)
    return (int)paged_write_quant<float>(k, v, qk, qv, sk, sv, tb, pos, vd, B, C, n, pps, ps,
                                         rows, s);
  if (xdtype == 1)
    return (int)paged_write_quant<__nv_bfloat16>(k, v, qk, qv, sk, sv, tb, pos, vd, B, C, n,
                                                 pps, ps, rows, s);
  return (int)cudaErrorInvalidValue;
}

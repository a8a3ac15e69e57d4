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
// and back, y = T(f32(q) * f32(s)).
//
// The codes must be bit-equal to the reference's: tokens downstream depend
// on them.  Hence the scale is rounded to its storage type before the
// divide; the divides are IEEE (__fdiv_rn, never a reciprocal); rint rounds
// half to even as jnp.round does.  With an f16 scale the 1e-8 floor itself
// rounds to 0, so a line whose amax is below ~3.8e-6 stores scale 0 and the
// divide gives x / 0: +-inf clips to +-127 and 0 / 0 = NaN becomes code 0,
// which is what XLA's convert does with the reference's clipped NaN.  (A
// plain fminf/fmaxf clamp would turn NaN into 127: NaN is mapped first.)
//
// What bounds it on the H100: bytes.  A line is read (twice, the second
// time from L1/L2), its codes written once at a byte each, and a few flops
// an element; at the serving shapes (4-32 rows of 384 or 768, one 768x3072
// slab) the launches are latency-bound far under the HBM rate.
//
// Design.  Row lines (the reduced axis is the minor one: KV tokens,
// boundary rows): one warp per line, lanes striding the line so a warp
// reads neighbouring addresses, a shuffle max, then the quantize pass.
// Column lines ([outer, n, inner] reduced over n: the expert slab's scale
// per output column): a block of 32 neighbouring columns x 8 slices of the
// reduced axis, so each warp reads 32 neighbouring values of one row with
// no transposed copy; the slices' maxima meet in shared memory.
// Dequantize is an elementwise grid-stride loop.
//
// The int8 KV pools' layer write (paged_write_quant_kernel) fuses what the
// serving path did in ten-odd small launches a layer (two row quantizations,
// the page-slot arithmetic, four scatters): one launch quantizes a layer's
// k and v for all B x C tokens and writes codes and scales straight into
// their page slots.  One warp a token line (its k or its v): the physical
// row table[b, (pos // ps) % pps] (negative entries wrap as a Python index
// does; rows not valid go to the garbage row, the pool's last), the offset
// pos % ps; the line's KV * hd values read once with 16-byte loads and kept
// in registers, the amax from shuffles, the same scale and codes as the row
// kernel (bit-equal), the codes stored 8 (bf16 input) or 4 (f32) bytes at a
// time.  Bound by launch latency: a decode group writes 4 tokens.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kFloor = 1e-8f;
constexpr int kWarps = 4;          // row lines per block
constexpr int kCols = 32;          // column lines per block
constexpr int kSlices = 8;         // slices of the reduced axis per column block
constexpr int kDeqThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// the stored scale of a line whose largest magnitude is amax
template <typename S>
__device__ __forceinline__ S line_scale(float amax) {
  return from_f<S>(fmaxf(__fdiv_rn(amax, 127.f), kFloor));
}

__device__ __forceinline__ signed char quant(float x, float s) {
  const float r = rintf(__fdiv_rn(x, s));
  if (r != r) return 0;  // NaN: 0 / 0 under an f16 scale that underflowed
  return (signed char)(int)fminf(fmaxf(r, -127.f), 127.f);  // +-inf -> +-127
}

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
  const S s = line_scale<S>(amax);
  if (lane == 0) scale[row] = s;
  const float sf = to_f(s);
  signed char* qr = q + (size_t)row * n;
  for (int i = lane; i < n; i += 32) qr[i] = quant(to_f(xr[i]), sf);
}

template <typename T, typename S>
__global__ void __launch_bounds__(kCols * kSlices) quantize_cols_kernel(
    const T* __restrict__ x, signed char* __restrict__ q, S* __restrict__ scale,
    int n, int inner) {
  const int c = threadIdx.x % kCols, slice = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + c;
  const size_t base = (size_t)blockIdx.y * n * inner;
  __shared__ float part[kSlices][kCols];
  __shared__ float s_col[kCols];
  float amax = 0.f;
  if (col < inner)
    for (int i = slice; i < n; i += kSlices)
      amax = fmaxf(amax, fabsf(to_f(x[base + (size_t)i * inner + col])));
  part[slice][c] = amax;
  __syncthreads();
  if (slice == 0) {
#pragma unroll
    for (int k = 1; k < kSlices; ++k) amax = fmaxf(amax, part[k][c]);
    const S s = line_scale<S>(amax);
    if (col < inner) scale[(size_t)blockIdx.y * inner + col] = s;
    s_col[c] = to_f(s);
  }
  __syncthreads();
  if (col >= inner) return;
  const float sf = s_col[c];
  for (int i = slice; i < n; i += kSlices) {
    const size_t off = base + (size_t)i * inner + col;
    q[off] = quant(to_f(x[off]), sf);
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(kDeqThreads) dequantize_rows_kernel(
    const signed char* __restrict__ q, const S* __restrict__ scale,
    T* __restrict__ y, size_t total, int n) {
  for (size_t i = (size_t)blockIdx.x * kDeqThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kDeqThreads)
    y[i] = from_f<T>((float)q[i] * to_f(scale[i / n]));
}

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

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}
__device__ __forceinline__ int floor_mod(int a, int b) { return a - floor_div(a, b) * b; }

constexpr int kWriteWarps = 4;  // token lines per block
constexpr int kMaxLoads = 16;   // 16-byte loads a lane keeps: KV * hd <= 512 * Line::n

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
  using L = Line<T>;
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

  const T* src = (is_v ? v : k) + (size_t)t * n;
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
  const __half s = line_scale<__half>(amax);
  if (lane == 0) (is_v ? pool_vs : pool_ks)[slot] = s;
  const float sf = __half2float(s);
  signed char* dst = (is_v ? pool_v : pool_k) + slot * n;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int idx = lane + 32 * j;
    if (idx < loads) {
      typename L::Codes packed;
      signed char* c = reinterpret_cast<signed char*>(&packed);
#pragma unroll
      for (int i = 0; i < L::n; ++i) c[i] = quant(vals[j][i], sf);
      *reinterpret_cast<typename L::Codes*>(dst + idx * L::n) = packed;
    }
  }
}

template <typename T>
cudaError_t paged_write_quant(const void* k, const void* v, signed char* qk, signed char* qv,
                              __half* sk, __half* sv, const int* table, const int* positions,
                              const bool* valid, int B, int C, int n, int pps, int ps, int rows,
                              cudaStream_t stream) {
  const int tokens = B * C;
  const int per_lane = (n / Line<T>::n + 31) / 32;
  if (n % Line<T>::n || per_lane > kMaxLoads) return cudaErrorInvalidValue;
  const dim3 grid((2 * tokens + kWriteWarps - 1) / kWriteWarps), block(32 * kWriteWarps);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
#define PWQ(NL)                                                                       \
  paged_write_quant_kernel<T, NL><<<grid, block, 0, stream>>>(                       \
      kt, vt, qk, qv, sk, sv, table, positions, valid, tokens, C, n, pps, ps, rows)
  if (per_lane <= 1) PWQ(1);
  else if (per_lane <= 2) PWQ(2);
  else if (per_lane <= 4) PWQ(4);
  else if (per_lane <= 8) PWQ(8);
  else PWQ(16);
#undef PWQ
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t quantize(const void* x, void* q, void* scale, int outer, int n,
                     int inner, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  signed char* qt = static_cast<signed char*>(q);
  S* st = static_cast<S*>(scale);
  if (inner == 1) {
    quantize_rows_kernel<T, S><<<(outer + kWarps - 1) / kWarps, 32 * kWarps, 0,
                                 stream>>>(xt, qt, st, outer, n);
  } else {
    const dim3 grid((inner + kCols - 1) / kCols, outer);
    quantize_cols_kernel<T, S><<<grid, kCols * kSlices, 0, stream>>>(xt, qt, st, n,
                                                                     inner);
  }
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t dequantize(const void* q, const void* scale, void* y, size_t total,
                       int n, cudaStream_t stream) {
  const size_t blocks = (total + kDeqThreads - 1) / kDeqThreads;
  dequantize_rows_kernel<T, S><<<(unsigned)(blocks < 4096 ? blocks : 4096),
                                 kDeqThreads, 0, stream>>>(
      static_cast<const signed char*>(q), static_cast<const S*>(scale),
      static_cast<T*>(y), total, n);
  return cudaGetLastError();
}

}  // namespace

// x viewed as [outer, n, inner], quantized over n: inner == 1 is one scale
// per row (scale [outer]), inner > 1 one per column (scale [outer, inner]).
// xdtype: 0 = float32, 1 = bfloat16.  sdtype: 0 = float32, 1 = float16.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int quantize_launch(const void* x, void* q, void* scale, int outer,
                               int n, int inner, int xdtype, int sdtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (xdtype == 0 && sdtype == 0)
    return (int)quantize<float, float>(x, q, scale, outer, n, inner, s);
  if (xdtype == 0 && sdtype == 1)
    return (int)quantize<float, __half>(x, q, scale, outer, n, inner, s);
  if (xdtype == 1 && sdtype == 0)
    return (int)quantize<__nv_bfloat16, float>(x, q, scale, outer, n, inner, s);
  if (xdtype == 1 && sdtype == 1)
    return (int)quantize<__nv_bfloat16, __half>(x, q, scale, outer, n, inner, s);
  return (int)cudaErrorInvalidValue;
}

// y[i] = ydtype(f32(q[i]) * f32(scale[i / n])) over total elements, rows of
// n.  ydtype: 0 = float32, 1 = bfloat16; sdtype as above.
extern "C" int dequantize_launch(const void* q, const void* scale, void* y,
                                 long long total, int n, int ydtype, int sdtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t t = (size_t)total;
  if (ydtype == 0 && sdtype == 0) return (int)dequantize<float, float>(q, scale, y, t, n, s);
  if (ydtype == 0 && sdtype == 1) return (int)dequantize<float, __half>(q, scale, y, t, n, s);
  if (ydtype == 1 && sdtype == 0)
    return (int)dequantize<__nv_bfloat16, float>(q, scale, y, t, n, s);
  if (ydtype == 1 && sdtype == 1)
    return (int)dequantize<__nv_bfloat16, __half>(q, scale, y, t, n, s);
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

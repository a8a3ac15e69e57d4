// Fused paged decode / chunk attention for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attention/kernel.py::paged_attention_pallas,
// both of its bodies: _pa_kernel (pools in the activation type) and
// _pa_kernel_quant (int8 pools with one f16 scale per token).  C >= 1 queries of
// one slot attend straight off the KV page pool through the slot's page
// table: ring slot s = j*ps + i holds position kp = ln - ((ln - s) mod W)
// with W = pps*ps, and a key is visible iff 0 <= kp <= qpos (and
// kp > qpos - window with a sliding window).  No dense ring view is ever
// materialized.
//
// What bounds it on the H100: bytes.  Each (slot, kv head) reads its mapped
// pages once (2*ps*hd elements a page) and does 4*hd flops per (query row,
// key), far below the ~295 flops a byte the card needs before its tensor
// cores would be the limit.  At decode (C = 1) the grid is small too:
// B*KV = 8*12 = 96 blocks on 132 SMs, each walking its pages in order.
//
// Design: one block per (kv head, slot).  It loads its own table row, walks
// the page entries in order and applies the skip rule of _pa_body: a
// garbage-routed entry, or a page in which no (query, key) pair is
// visible, costs one table read and nothing else.  A live page is fetched
// once into shared memory (f32), scored against all C*G query rows of the
// kv head (GQA rows r = c*G + g, read in place from the [B, C, H, hd]
// query layout, so no transpose runs around the kernel), and folded into an
// online softmax whose m, l and acc live in shared memory in f32.  The
// output is written once, with the l == 0 -> 1 guard, so rows without a
// visible key come back as exact 0.  Masked scores are -1e30 (not -inf)
// and p is rounded to the pool's type before the p @ V product, exactly as
// the reference, so the kernel reproduces its numerics on every row.
//
// int8 pools (k_scale / v_scale non-null, [P+1, ps] f16, one scale per
// token shared across kv heads and head dim): each element of a fetched page
// is dequantized as it is loaded into shared memory, f32(code) *
// f32(scale[phys, i]), riding the same table lookup; no dense copy of the
// pool exists.  As in the reference's quantized consumer
// (kernels/paged_attention/ref.py), q enters the score product in f32 and p
// stays f32 in the p @ V product; the output is in q's type.  An int8 page
// is a quarter (vs f32) or half (vs bf16) of the bytes, plus 2*ps bytes of
// scales.
//
// Later: splitting the page sweep of one (slot, head) across several blocks
// and merging their partial (m, l, acc) states (the flash-decoding layout)
// fills the card at decode; the skip rule carries over unchanged.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(signed char x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// position held by ring slot s after the write at ln: ln - ((ln - s) mod W)
__device__ __forceinline__ int ring_pos(int ln, int s, int W) {
  int r = (ln - s) % W;
  if (r < 0) r += W;
  return ln - r;
}

__device__ __forceinline__ bool visible(int kp, int qp, int window) {
  return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
}

// T: the queries' and the output's type; P: the pools' (T, or int8 codes
// with their per-token scales)
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q,          // [B, C, H, hd]
    const P* __restrict__ pool_k,     // [P+1, ps, KV, hd]
    const P* __restrict__ pool_v,     // [P+1, ps, KV, hd]
    const __half* __restrict__ k_scale,  // [P+1, ps] (int8 pools only)
    const __half* __restrict__ v_scale,
    const int* __restrict__ table,    // [B, pps]
    const int* __restrict__ qpos,     // [B, C]
    const int* __restrict__ lengths,  // [B] ring anchor (last written position)
    T* __restrict__ out,              // [B, C, H, hd]
    int C, int H, int KV, int hd, int ps, int pps, int garbage, int window,
    float scale) {
  constexpr bool kQuant = std::is_same<P, signed char>::value;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int rows = C * G;
  const int tid = threadIdx.x;
  const int kst = hd + 1;  // padded K row: the score loop reads K by row

  extern __shared__ float smem[];
  float* q_s = smem;              // [rows, hd]
  float* acc = q_s + rows * hd;   // [rows, hd]
  float* k_s = acc + rows * hd;   // [ps, hd + 1]
  float* v_s = k_s + ps * kst;    // [ps, hd]
  float* s_s = v_s + ps * hd;     // [rows, ps] scores, then p
  float* m_s = s_s + rows * ps;   // [rows]
  float* l_s = m_s + rows;        // [rows]
  float* c_s = l_s + rows;        // [rows] rescale of the running state
  int* qp_s = reinterpret_cast<int*>(c_s + rows);  // [C]

  const int ln = lengths[b];
  const int W = pps * ps;
  for (int c = tid; c < C; c += kThreads) qp_s[c] = qpos[b * C + c];
  for (int e = tid; e < rows * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    const int c = r / G, g = r - c * G;
    q_s[e] = to_f(q[(((size_t)b * C + c) * H + h * G + g) * hd + d]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < pps; ++j) {
    const int phys = table[b * pps + j];
    if (phys == garbage) continue;  // the same value for every thread
    int any = 0;
    for (int e = tid; e < C * ps; e += kThreads) {
      const int c = e / ps, i = e - c * ps;
      any |= visible(ring_pos(ln, j * ps + i, W), qp_s[c], window);
    }
    if (!__syncthreads_or(any)) continue;  // dead page: no visible key

    const size_t page = (size_t)phys * ps * KV * hd;
    for (int e = tid; e < ps * hd; e += kThreads) {
      const int i = e / hd, d = e - i * hd;
      const size_t off = page + ((size_t)i * KV + h) * hd + d;
      if constexpr (kQuant) {
        const size_t si = (size_t)phys * ps + i;
        k_s[i * kst + d] = to_f(pool_k[off]) * __half2float(k_scale[si]);
        v_s[e] = to_f(pool_v[off]) * __half2float(v_scale[si]);
      } else {
        k_s[i * kst + d] = to_f(pool_k[off]);
        v_s[e] = to_f(pool_v[off]);
      }
    }
    __syncthreads();

    for (int e = tid; e < rows * ps; e += kThreads) {
      const int r = e / ps, i = e - r * ps;
      const float* qr = q_s + r * hd;
      const float* kr = k_s + i * kst;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      const bool ok = visible(ring_pos(ln, j * ps + i, W), qp_s[r / G], window);
      s_s[e] = ok ? s * scale : kNegInf;
    }
    __syncthreads();

    for (int r = tid; r < rows; r += kThreads) {
      float* sr = s_s + r * ps;
      float mx = sr[0];
      for (int i = 1; i < ps; ++i) mx = fmaxf(mx, sr[i]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float sum = 0.f;
      for (int i = 0; i < ps; ++i) {
        const float p = expf(sr[i] - m_new);
        sum += p;
        // p enters p @ V in the pool's type (f32 for a dequantized pool)
        sr[i] = kQuant ? p : to_f(from_f<T>(p));
      }
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = m_new;
      c_s[r] = corr;
    }
    __syncthreads();

    for (int e = tid; e < rows * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd;
      const float* pr = s_s + r * ps;
      float a = acc[e] * c_s[r];
      for (int i = 0; i < ps; ++i) a = fmaf(pr[i], v_s[i * hd + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < rows * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd;
    const int c = r / G, g = r - c * G;
    float l = l_s[r];
    l = (l == 0.f) ? 1.f : l;
    out[(((size_t)b * C + c) * H + h * G + g) * hd + d] = from_f<T>(acc[e] / l);
  }
}

template <typename T, typename P>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* k_scale, const void* v_scale,
                   const void* table, const void* qpos, const void* lengths,
                   void* out, int B, int C, int H, int KV, int hd, int ps,
                   int pps, int garbage, int window, float scale,
                   cudaStream_t stream) {
  const int rows = C * (H / KV);
  const size_t smem = sizeof(float) * (2 * rows * hd + ps * (hd + 1) + ps * hd +
                                       rows * ps + 3 * rows) +
                      sizeof(int) * C;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_attention_kernel<T, P><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(pool_k),
      static_cast<const P*>(pool_v), static_cast<const __half*>(k_scale),
      static_cast<const __half*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(qpos), static_cast<const int*>(lengths),
      static_cast<T*>(out), C, H, KV, hd, ps, pps, garbage, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype (q, out): 0 = float32, 1 = bfloat16.  quant: 0 = pools in q's
// type (k_scale, v_scale unused), 1 = int8 pools with f16 scales [P+1, ps].
// window <= 0 means no sliding window.  Returns the launch's cudaError_t
// (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
    const void* v_scale, const void* table, const void* qpos,
    const void* lengths, void* out, int B, int C, int H, int KV, int hd, int ps,
    int pps, int garbage, int window, float scale, int dtype, int quant,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(T, P)                                                       \
  return (int)launch<T, P>(q, pool_k, pool_v, k_scale, v_scale, table, qpos,  \
                           lengths, out, B, C, H, KV, hd, ps, pps, garbage,   \
                           window, scale, s)
  if (dtype == 1 && quant) PA_LAUNCH(__nv_bfloat16, signed char);
  if (dtype == 1) PA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (quant) PA_LAUNCH(float, signed char);
  PA_LAUNCH(float, float);
#undef PA_LAUNCH
}

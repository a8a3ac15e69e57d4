// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (_fa_kernel) in the role the port gives it: the full-sequence attention
// of models/attention.py::flash_attention, which the one-shot end-cloud
// pipeline runs in every layer.  Queries [B, Sq, H, hd] attend keys and
// values [B, Skv, KV, hd] (query head h reads kv head h / G, G = H / KV),
// all in the models' layout, so no transpose runs around the kernel.  Key
// j is visible to query row i (absolute position qp = q_offset + i) iff
//     (!causal || qp >= j)  &&  (window <= 0 || qp - j < window).
//
// Numerics follow the consumer, attention._flash_fwd_inner, not the Pallas
// body: scores are dots of the input type accumulated in f32, masked
// scores are -1e30 (not -inf), p is rounded to V's type before p . V
// while l sums the unrounded p, and (m, l, acc) stay in f32.  A masked key
// adds p = 0, so a row that has seen no visible key keeps l = 0 and the
// single flush writes it as 0 (the l == 0 guard); every other row gets the
// consumer's value.
//
// What bounds it on the H100: at the pipeline's shapes (B = 4, S = 256,
// 12 heads of 64, bf16, causal) the inputs and output are 6.3 MB (1.9 us
// at the memory rate) and the visible (query, key) pairs need ~0.4 GFLOP
// (0.4 us at the bf16 tensor-core rate): the floor is bytes.  This first kernel computes on the CUDA cores in f32, so it
// is bound by its FMA and shared-memory rate (times in PERF.md);
// tensor-core (mma / wgmma) tiles for the bf16 form are a later step.
//
// Design: one block per (q tile of kBQ = 32 rows, query head, batch row).
// The block computes, from the causal and window band of its q tile, the
// first and last kv tile (kBK = 64 keys) that hold any visible key and
// loads only those: a tile wholly outside the band is never read (tile
// skipping).  Each kv tile is staged in shared memory in f32 (K rows
// padded by one float so the score loop is free of bank conflicts), scored
// against the q tile, folded into the online softmax, and multiplied into
// the accumulator.  Thread (ty, tx) of 8 x 16 owns query rows 4ty..4ty+3:
// scores of keys tx + 16c and output dims tx + 16c; the row max and sum are
// reduced over the 16 lanes of a row group with warp shuffles.  Any Sq and
// Skv: the tails of the last q and kv tiles are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 32;       // query rows per block
constexpr int kBK = 64;       // keys per kv tile
constexpr int kThreads = 128; // 8 row groups x 16 lanes
constexpr int kRowsPer = kBQ / 8;
constexpr int kKeysPer = kBK / 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// max / sum over the 16 lanes of one row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1) + (size_t)kBK * (HD + 1) +
                          (size_t)kBK * HD + (size_t)kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q,  // [B, Sq, H, HD]
    const T* __restrict__ k,  // [B, Skv, KV, HD]
    const T* __restrict__ v,  // [B, Skv, KV, HD]
    T* __restrict__ out,      // [B, Sq, H, HD]
    int Sq, int Skv, int H, int KV, int q_offset, int causal, int window,
    float scale) {
  constexpr int kDimsPer = HD / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int nq = min(kBQ, Sq - q0);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [kBQ][HD + 1]
  float* k_s = q_s + kBQ * (HD + 1);   // [kBK][HD + 1]
  float* v_s = k_s + kBK * (HD + 1);   // [kBK][HD]
  float* p_s = v_s + kBK * HD;         // [kBQ][kBK + 1]

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    q_s[r * (HD + 1) + d] =
        r < nq ? to_f(q[(((size_t)b * Sq + q0 + r) * H + h) * HD + d]) : 0.f;
  }

  // Keys [k_begin, k_end) hold every key visible to some row of this tile.
  const int qp_lo = q_offset + q0, qp_hi = q_offset + q0 + nq - 1;
  const int k_end = causal ? min(Skv, qp_hi + 1) : Skv;
  const int k_begin = window > 0 ? max(0, qp_lo - window + 1) : 0;
  const int j_lo = k_begin / kBK;
  const int j_hi = k_begin < k_end ? (k_end + kBK - 1) / kBK : j_lo;

  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][kDimsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDimsPer; ++c) acc[i][c] = 0.f;
  }
  __syncthreads();

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * kBK;
    const int nk = min(kBK, Skv - k0);
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int kr = e / HD, d = e - kr * HD;
      const bool ok = kr < nk;
      const size_t off = (((size_t)b * Skv + k0 + kr) * KV + hk) * HD + d;
      k_s[kr * (HD + 1) + d] = ok ? to_f(k[off]) : 0.f;
      v_s[kr * HD + d] = ok ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPer][kKeysPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRowsPer], kv[kKeysPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) qv[i] = q_s[(ty * kRowsPer + i) * (HD + 1) + d];
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) kv[c] = k_s[(tx + 16 * c) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int c = 0; c < kKeysPer; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int qp = q_offset + q0 + ty * kRowsPer + i;
      bool vis[kKeysPer];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) {
        const int kc = tx + 16 * c, kp = k0 + kc;
        vis[c] = kc < nk && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
        s[i][c] = vis[c] ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) {
        const float p = vis[c] ? expf(s[i][c] - m_new) : 0.f;
        sum += p;
        // p enters p . V in V's type
        p_s[(ty * kRowsPer + i) * (kBK + 1) + tx + 16 * c] = to_f(from_f<T>(p));
      }
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDimsPer; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int kk = 0; kk < nk; ++kk) {
      float pv[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) pv[i] = p_s[(ty * kRowsPer + i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kDimsPer; ++c) {
        const float vv = v_s[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = ty * kRowsPer + i;
    if (r >= nq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < kDimsPer; ++c)
      out[(((size_t)b * Sq + q0 + r) * H + h) * HD + tx + 16 * c] = from_f<T>(acc[i][c] / li);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int KV, int q_offset,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, KV, q_offset, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Skv, int H, int KV, int hd,
                      int q_offset, int causal, int window, float scale,
                      cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, KV, q_offset, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, q_offset, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, q_offset, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// hd: 32, 64 or 128.  window <= 0 means no sliding window.  dtype: 0 =
// float32, 1 = bfloat16.  Returns the launch's cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int KV, int hd,
                                      int q_offset, int causal, int window,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, hd,
                                         q_offset, causal, window, scale, s);
  return (int)launch_hd<float>(q, k, v, out, B, Sq, Skv, H, KV, hd, q_offset,
                               causal, window, scale, s);
}

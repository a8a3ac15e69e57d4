// GQA flash-attention forward for Hopper (sm_90a), causal or not.
//
// Replaces repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (_fa_kernel) in the role the port gives it: the full-sequence attention
// of models/attention.py::flash_attention, which the one-shot end-cloud
// pipeline runs in every layer, Model.prefill in every layer, and an
// encoder-decoder (whisper) without causality in its bidirectional
// encoder and its cross-attention (Sq queries against Skv encoder
// frames, Sq != Skv).  Queries [B, Sq, H, hd] attend keys and
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
// consumer's value.  On request (the training path) each row's natural
// log-sum-exp m + ln l goes to an f32 [B, H, Sq] array, -1e30 for a row
// that saw no key (the reference's, whose f32 -1e30 + ln Skv rounds to
// -1e30); the backward (csrc/flash_attention_bwd.cu) recomputes P from it.
// The bf16 form folds log2(e) into the scale and takes
// exp2f: it scores s = dot * (scale * log2 e) and keeps m in those units,
// so p = exp2(s - m) is the consumer's exp(dot * scale - m) up to the
// rounding of the folded constant (~1e-6 relative in p, far under the
// bf16 rounding of p that follows).
//
// What bounds it on the H100: at the pipeline's shapes (B = 4, S = 256,
// 12 heads of 64, bf16, causal) the inputs and output are 6.3 MB (1.9 us
// at the memory rate) and the visible (query, key) pairs need ~0.4 GFLOP
// (0.4 us at the bf16 tensor-core rate): the floor is bytes.  What costs
// is the two products per tile and the exponentials, on few blocks (192
// at that shape), each walking its kv tiles in order: latency.
//
// Both forms: a block takes one q tile of one query head of one batch row
// and computes, from the causal and window band of its q tile, the first
// and last kv tile (kBK = 64 keys) that hold any visible key; a tile
// wholly outside the band is never read (tile skipping).  Any Sq and Skv:
// the tails of the last q and kv tiles are masked.
//
// bf16, the tensor-core form (FA2 layout): 4 warps over kMQ = 64 query
// rows, 16 a warp, the Q fragments held in registers.  K and V tiles come
// by cp.async into a 2-stage ring in padded shared memory (16 B a row, so
// ldmatrix rows fall in distinct banks); S = Q K^T by mma.m16n8k16 (bf16
// in, f32 accumulate) with K through ldmatrix; the online softmax runs on
// the accumulator fragments in registers, each row's max and sum reduced
// over the 4 lanes that hold it; p, rounded to bf16 in registers, is the A
// operand of P V, with V through ldmatrix.trans.  The grid is (heads,
// batch, q tiles) with the q-tile index reversed, so the tiles that hold
// the most kv tiles under causality are dispatched first.
//
// Head dims 32, 64, 128 and 120 (h2o-danube-3-4b).  At 120 the bf16 form
// computes at a width of 128 (padded_hd) over rows of the true stride 120:
// the shared-memory columns [120, 128) of the Q, K and V tiles are zeroed
// once and no copy writes them, so the eighth k16 chunk of q . k adds
// 0 * 0 terms and the last n8 tile of P V sums zero value columns; the
// scores, the softmax and the 120 stored columns are exact, and that tile
// is never stored.  120 = 15 x 8, so every 16-byte copy stays aligned.
// The f32 form computes only real dims: its score loop runs over HD, and
// of the output dims tx + 16c the ones at or past HD (c = 7, tx >= 8) are
// skipped.
//
// f32, the CUDA-core form (exact f32, no TF32): q tiles of kBQ = 32 rows;
// each kv tile is staged in shared memory (K rows padded by one float, so
// the score loop is free of bank conflicts), scored, folded into the
// online softmax, and multiplied into the accumulator.  Thread (ty, tx) of
// 8 x 16 owns query rows 4ty..4ty+3: scores of keys tx + 16c and output
// dims tx + 16c; the row max and sum are reduced over the 16 lanes of a
// row group with warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBK = 64;       // keys per kv tile (both forms)
constexpr int kBQ = 32;       // query rows per block (f32)
constexpr int kThreads = 128; // 8 row groups x 16 lanes
constexpr int kRowsPer = kBQ / 8;
constexpr int kKeysPer = kBK / 16;

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

// The bf16 form's compute width of a head of HD dims (see the header).
template <int HD>
__host__ __device__ constexpr int padded_hd() {
  return HD <= 32 ? 32 : HD <= 64 ? 64 : 128;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (HD + 1) + (size_t)kBK * (HD + 1) +
                          (size_t)kBK * HD + (size_t)kBQ * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q,  // [B, Sq, H, HD]
    const float* __restrict__ k,  // [B, Skv, KV, HD]
    const float* __restrict__ v,  // [B, Skv, KV, HD]
    float* __restrict__ out,      // [B, Sq, H, HD]
    float* __restrict__ lse,      // [B, H, Sq] or null
    int Sq, int Skv, int H, int KV, int q_offset, int causal, int window,
    float scale) {
  constexpr int kDimsPer = (HD + 15) / 16;  // output dims tx + 16c; past HD skipped
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
        r < nq ? q[(((size_t)b * Sq + q0 + r) * H + h) * HD + d] : 0.f;
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
      k_s[kr * (HD + 1) + d] = ok ? k[off] : 0.f;
      v_s[kr * HD + d] = ok ? v[off] : 0.f;
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
        p_s[(ty * kRowsPer + i) * (kBK + 1) + tx + 16 * c] = p;
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
        if (HD % 16 != 0 && tx + 16 * c >= HD) continue;
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
      if (HD % 16 == 0 || tx + 16 * c < HD)
        out[(((size_t)b * Sq + q0 + r) * H + h) * HD + tx + 16 * c] = acc[i][c] / li;
    // every lane of the row group holds the row's m and l
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * Sq + q0 + r] = l[i] == 0.f ? kNegInf : m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core form (FA2 layout).

using bf16 = __nv_bfloat16;

constexpr int kMQ = 64;         // query rows per block, 16 a warp
constexpr int kMThreads = 128;  // 4 warps

template <int HD>
constexpr size_t mma_smem_bytes() {  // Q, and a 2-stage ring of K and V tiles
  return sizeof(bf16) * (size_t)(kMQ + 4 * kBK) * (padded_hd<HD>() + 8);
}

// Rows [0, 64) of a [rows][ld] bf16 array at `src` into dst[64][padded_hd + 8]
// (16 B of padding a row, so the 8 rows an ldmatrix reads fall in distinct
// banks); rows from `nvalid` on are zero-filled and not read.  kVec: one
// 16-byte cp.async a chunk of 8 values; otherwise synchronous scalar loads
// (an operand not 16-byte aligned).
template <int HD, bool kVec>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src,
                                           size_t ld, int nvalid) {
  constexpr int kCh = HD / 8;
  for (int c = threadIdx.x; c < 64 * kCh; c += kMThreads) {
    const int r = c / kCh, col = (c % kCh) * 8;
    bf16* d = dst + r * (padded_hd<HD>() + 8) + col;
    const bf16* s = src + (size_t)r * ld + col;
    if constexpr (kVec) {
      tc::cp_async16(d, r < nvalid ? s : src, r < nvalid ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = r < nvalid ? s[e] : __float2bfloat16(0.f);
    }
  }
}

template <int HD, bool kVec>
__global__ void __launch_bounds__(kMThreads) flash_fwd_mma_kernel(
    const bf16* __restrict__ q,  // [B, Sq, H, HD]
    const bf16* __restrict__ k,  // [B, Skv, KV, HD]
    const bf16* __restrict__ v,  // [B, Skv, KV, HD]
    bf16* __restrict__ out,      // [B, Sq, H, HD]
    float* __restrict__ lse,     // [B, H, Sq] or null
    int Sq, int Skv, int H, int KV, int q_offset, int causal, int window,
    float scale) {
  constexpr int kHP = padded_hd<HD>();  // compute width: columns [HD, kHP) hold zeros
  constexpr int kLd = kHP + 8;
  constexpr int kKC = kHP / 16;  // k16 chunks of a q . k dot
  constexpr int kND = kHP / 8;   // n8 tiles of the output row
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kMQ;  // the heaviest causal tiles first
  const int hk = h / (H / KV);
  const int nq = min(kMQ, Sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // scores, m and the masked -1e30 in log2 units: exp(x) is exp2f(x log2 e)
  const float scale_log2 = scale * 1.4426950408889634f;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kMQ][kLd]
  bf16* k_s = q_s + kMQ * kLd;                     // [2][kBK][kLd]
  bf16* v_s = k_s + 2 * kBK * kLd;                 // [2][kBK][kLd]
  if constexpr (kHP != HD) {
    // columns [HD, kHP) of every Q, K and V row: zeros that no copy overwrites
    constexpr int kPad = kHP - HD;
    for (int e = threadIdx.x; e < (kMQ + 4 * kBK) * kPad; e += kMThreads)
      q_s[(e / kPad) * kLd + HD + e % kPad] = __float2bfloat16(0.f);
  }

  // Keys [k_begin, k_end) hold every key visible to some row of this tile.
  const int qp_lo = q_offset + q0, qp_hi = q_offset + q0 + nq - 1;
  const int k_end = causal ? min(Skv, qp_hi + 1) : Skv;
  const int k_begin = window > 0 ? max(0, qp_lo - window + 1) : 0;
  const int j_lo = k_begin / kBK;
  const int j_hi = k_begin < k_end ? (k_end + kBK - 1) / kBK : j_lo;

  const size_t kv_ld = (size_t)KV * HD;
  auto stage_kv = [&](int j, int slot) {
    const int k0 = j * kBK;
    const size_t off = ((size_t)b * Skv + k0) * kv_ld + (size_t)hk * HD;
    stage_rows<HD, kVec>(k_s + slot * kBK * kLd, k + off, kv_ld, Skv - k0);
    stage_rows<HD, kVec>(v_s + slot * kBK * kLd, v + off, kv_ld, Skv - k0);
  };
  stage_rows<HD, kVec>(q_s, q + (((size_t)b * Sq + q0) * H + h) * HD, (size_t)H * HD, nq);
  tc::cp_async_commit();
  if (j_lo < j_hi) stage_kv(j_lo, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();  // Q has landed
  __syncthreads();

  uint32_t qf[kKC][4];  // the warp's 16 query rows as A fragments
#pragma unroll
  for (int c = 0; c < kKC; ++c)
    tc::ldmatrix_x4(qf[c], q_s + (warp * 16 + (lane & 15)) * kLd + c * 16 + (lane >> 4) * 8);

  // this thread's rows g and g + 8 of the warp: (m, l) and the output
  const int qp[2] = {q_offset + q0 + warp * 16 + g, q_offset + q0 + warp * 16 + g + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kND][4];
#pragma unroll
  for (int d = 0; d < kND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int slot = (j - j_lo) & 1;
    if (j + 1 < j_hi) stage_kv(j + 1, slot ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const bf16* ks = k_s + slot * kBK * kLd;
    const bf16* vs = v_s + slot * kBK * kLd;
    const int k0 = j * kBK;

    // S = Q K^T: 8 n8 tiles of keys; K rows (keys) are the B operand's
    // columns, read by ldmatrix without .trans
    float s[8][4];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n8][e] = 0.f;
#pragma unroll
    for (int c = 0; c < kKC; ++c)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        tc::ldmatrix_x4(r, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + c * 16 +
                               (((lane >> 3) & 1) << 3));
        tc::mma_bf16(s[2 * np], qf[c], r[0], r[1]);
        tc::mma_bf16(s[2 * np + 1], qf[c], r[2], r[3]);
      }

    // scale, mask (only a tile that some row of the block sees in part),
    // and the online softmax over the 4 lanes of a row
    const bool full = k0 + kBK <= Skv && (!causal || qp_lo >= k0 + kBK - 1) &&
                      (window <= 0 || qp_hi - k0 < window);
    uint32_t vis = full ? 0xffffffffu : 0u;
    float mx[2] = {kNegInf, kNegInf};
    if (full) {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n8][e] *= scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n8][e]);
        }
    } else {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + n8 * 8 + 2 * t + (e & 1), p = qp[e >> 1];
          const bool ok = kp < Skv && (!causal || p >= kp) && (window <= 0 || p - kp < window);
          s[n8][e] = ok ? s[n8][e] * scale_log2 : kNegInf;
          vis |= (uint32_t)ok << (n8 * 4 + e);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n8][e]);
        }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (vis >> (n8 * 4 + e)) & 1u ? exp2f(s[n8][e] - m[e >> 1]) : 0.f;
        s[n8][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * corr[i] + sum[i];  // l sums the unrounded p
    }
#pragma unroll
    for (int d = 0; d < kND; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }

    // O += P V: p rounded to bf16 (V's type) in registers is the A operand;
    // V rows (keys) are the B operand's k, read by ldmatrix with .trans
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {
      const uint32_t pa[4] = {tc::pack_bf16(s[2 * c][0], s[2 * c][1]),
                              tc::pack_bf16(s[2 * c][2], s[2 * c][3]),
                              tc::pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              tc::pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kND / 2; ++dp) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, vs + (c * 16 + (lane & 15)) * kLd + dp * 16 + ((lane >> 4) << 3));
        tc::mma_bf16(acc[2 * dp], pa, r[0], r[1]);
        tc::mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with this slot before it is refilled
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    if (r >= nq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    // m is in log2 units: the natural log-sum-exp is m ln 2 + ln l
    if (lse != nullptr && t == 0)
      lse[((size_t)b * H + h) * Sq + q0 + r] =
          l[i] == 0.f ? kNegInf : m[i] * 0.6931471805599453f + logf(l[i]);
    bf16* o = out + (((size_t)b * Sq + q0 + r) * H + h) * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < kND; ++d)
      if (d * 8 < HD)  // the padding dims' tile is never stored
        *reinterpret_cast<__nv_bfloat162*>(o + d * 8) =
            __floats2bfloat162_rn(acc[d][2 * i] / li, acc[d][2 * i + 1] / li);
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int B, Sq, Skv, H, KV, q_offset, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// f32: the CUDA-core kernel, grid (q tiles of 32, heads, batch)
template <int HD>
cudaError_t launch_f32(const Args& a) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = allow_smem(flash_fwd_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse, a.Sq, a.Skv, a.H, a.KV,
      a.q_offset, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// bf16: the tensor-core kernel, grid (heads, batch, q tiles of 64)
template <int HD>
cudaError_t launch_mma(const Args& a) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  const bool vec = ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                     reinterpret_cast<uintptr_t>(a.v)) & 15) == 0;
  auto kernel = vec ? flash_fwd_mma_kernel<HD, true> : flash_fwd_mma_kernel<HD, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.Sq + kMQ - 1) / kMQ);
  kernel<<<grid, kMThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), a.lse, a.Sq, a.Skv, a.H, a.KV,
      a.q_offset, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const Args& a, int dtype) {
  return dtype == 1 ? launch_mma<HD>(a) : launch_f32<HD>(a);
}

}  // namespace

// hd: 32, 64, 120 or 128.  window <= 0 means no sliding window.  dtype: 0 =
// float32, 1 = bfloat16.  lse: null, or [B, H, Sq] f32 that receives each
// row's natural log-sum-exp of its scaled scores (-1e30 for a row that saw
// no key), which the backward (csrc/flash_attention_bwd.cu) reads.  Returns
// the launch's cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse, int B,
                                      int Sq, int Skv, int H, int KV, int hd,
                                      int q_offset, int causal, int window,
                                      float scale, int dtype, void* stream) {
  const Args a{q, k, v, out, static_cast<float*>(lse), B, Sq, Skv, H, KV, q_offset,
               causal, window, scale, static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 32: return (int)launch<32>(a, dtype);
    case 64: return (int)launch<64>(a, dtype);
    case 128: return (int)launch<128>(a, dtype);
    case 120: return (int)launch<120>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}

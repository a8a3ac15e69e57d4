// GQA flash-attention backward for Hopper (sm_90a): dQ, dK and dV of the
// forward in csrc/flash_attention.cu, causal or not, with a window and a
// query offset, Sq != Skv allowed.
//
// Replaces the backward of the reference's custom VJP,
// repro/models/attention.py::make_flash_attention._bwd (jnp, not Pallas; the
// Pallas kernel kernels/flash_attention/kernel.py has no backward), which
// the port's training path runs once per attention layer.  Queries
// [B, Sq, H, hd], keys and values [B, Skv, KV, hd], the forward's output O
// and its upstream gradient dO [B, Sq, H, hd], and the forward's
// log-sum-exp lse [B, H, Sq] (f32, natural units).  Query head h reads kv
// head h / G (G = H / KV); dK and dV sum the gradients of a kv head's G
// query heads.  Key j is visible to query row i (position qp = q_offset +
// i) iff (!causal || qp >= j) && (window <= 0 || qp - j < window).
//
// Numerics follow _bwd: P is recomputed as exp(s * scale - lse) from f32
// dots of the inputs' values, dP = dO . V with dO in f32, delta =
// rowsum(dO * O) in f32, dS = P * (dP - delta) * scale; dQ sums dS rounded
// to K's type times K.  _bwd's dV sums the f32 P times the f32 dO, and its
// dK the f32 dS times Q in f32: the f32 form does exactly that, the bf16
// form rounds P and dS to bf16 for those two products (the tensor cores'
// operand type), well inside the bf16 tolerance.  A masked key gets P = 0
// here.  _bwd instead masks the score to -1e30, which gives the same 0
// wherever the row saw a key; a row that saw none has lse = -1e30, so
// _bwd's P is exp(0) = 1 on every key, and the wrapper
// (kernels/flash_attention/ops.py) adds those rows' terms, as the forward's
// wrapper fills their output.
//
// Two passes, no atomics, so a gradient is the same bits on every run:
// 1. dQ (and delta): a block takes one q tile of one query head, computes
//    delta for its rows (also written out for pass 2), and walks the kv
//    tiles (64 keys) that the causal and window band of its rows reaches,
//    as the forward does;
// 2. dK and dV: a block takes one kv tile of one kv head and walks, for
//    each of its G query heads, the q tiles whose band reaches the tile.
//
// bf16, the tensor-core form (the forward's FA2 layout): 4 warps, 16 rows
// a warp (pass 1: 64 query rows; pass 2: 64 keys, q tiles of 32 rows).
// Tiles come by cp.async into padded shared memory (16 B a row); every
// product is mma.m16n8k16 (bf16 in, f32 accumulate) with the B operand
// through ldmatrix, transposed where the tile is k-major.  S and dP stay
// in the accumulators; P and dS, rounded to bf16 in registers, are the A
// operand of the next product, as P is in the forward (pass 1: dQ += dS K;
// pass 2: S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK +=
// dS^T Q).  Head dim 120 computes at a width of 128 over rows of stride
// 120, its padding columns zeroed once, as in the forward.
//
// f32, the CUDA-core form (exact f32, no TF32): tiles staged as f32 (rows
// padded by one float, so the dot loops are free of bank conflicts);
// thread (ty, tx) of 8 x 16 owns 4 rows of the tile and the columns tx +
// 16c; pass 1 takes q tiles of 32 rows, pass 2 kv tiles of 32 keys and q
// tiles of 64 rows; P and dS go through shared memory.
//
// What bounds it on the H100: at switch-base's training shape (B = 4,
// S = 256, 12 heads of 64, causal) the inputs and outputs are ~12.6 MB in
// bf16 (~3.8 us at the memory rate) and the five products over the
// visible pairs ~1 GFLOP (~1 us at the bf16 tensor-core rate): the floor
// is bytes.  What costs is latency: two launches of a few hundred blocks,
// each walking its tiles in order, S and dP recomputed in both passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps; the f32 form's 8 row groups x 16 lanes
constexpr int kBQ = 32;        // f32 pass 1: query rows a block
constexpr int kBK = 64;        // keys a kv tile (pass 1, both forms)
constexpr int kBN = 32;        // f32 pass 2: keys a block
constexpr int kBM = 64;        // f32 pass 2: query rows a q tile
constexpr int kPer = 4;        // f32: rows (pass 1) or keys (pass 2) a thread owns
constexpr int kMQ = 64;        // bf16 pass 1: query rows a block, 16 a warp
constexpr int kMK = 64;        // bf16 pass 2: keys a block, 16 a warp
constexpr int kNQ = 32;        // bf16 pass 2: query rows a q tile

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window) {
  return (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core form.

template <int HD>
constexpr size_t dq_smem_bytes() {  // Q, dO, K, V tiles, dS, lse and delta
  return sizeof(float) * (2 * (size_t)kBQ * (HD + 1) + 2 * (size_t)kBK * (HD + 1) +
                          (size_t)kBQ * (kBK + 1) + 2 * kBQ);
}

template <int HD>
constexpr size_t dkv_smem_bytes() {  // K, V, Q, dO tiles, P, dS, lse and delta
  return sizeof(float) * (2 * (size_t)kBN * (HD + 1) + 2 * (size_t)kBM * (HD + 1) +
                          2 * (size_t)kBN * (kBM + 1) + 2 * kBM);
}

// Pass 1: grid (q tiles of kBQ, H, B).
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q,     // [B, Sq, H, HD]
    const float* __restrict__ k,     // [B, Skv, KV, HD]
    const float* __restrict__ v,     // [B, Skv, KV, HD]
    const float* __restrict__ out,   // [B, Sq, H, HD]
    const float* __restrict__ dout,  // [B, Sq, H, HD]
    const float* __restrict__ lse,   // [B, H, Sq]
    float* __restrict__ delta,       // [B, H, Sq] (written)
    float* __restrict__ dq,          // [B, Sq, H, HD]
    int Sq, int Skv, int H, int KV, int q_offset, int causal, int window, float scale) {
  constexpr int kDimsPer = (HD + 15) / 16;
  constexpr int kKeysPer = kBK / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int nq = min(kBQ, Sq - q0);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;

  extern __shared__ float smem[];
  float* q_s = smem;                     // [kBQ][HD + 1]
  float* do_s = q_s + kBQ * (HD + 1);    // [kBQ][HD + 1]
  float* k_s = do_s + kBQ * (HD + 1);    // [kBK][HD + 1]
  float* v_s = k_s + kBK * (HD + 1);     // [kBK][HD + 1]
  float* ds_s = v_s + kBK * (HD + 1);    // [kBQ][kBK + 1]
  float* lse_s = ds_s + kBQ * (kBK + 1); // [kBQ]
  float* dl_s = lse_s + kBQ;             // [kBQ]

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    const bool ok = r < nq;
    const size_t off = (((size_t)b * Sq + q0 + r) * H + h) * HD + d;
    q_s[r * (HD + 1) + d] = ok ? q[off] : 0.f;
    do_s[r * (HD + 1) + d] = ok ? dout[off] : 0.f;
  }
  // delta = rowsum(dO * O) in f32, a warp a row
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    float s = 0.f;
    if (r < nq) {
      const size_t base = (((size_t)b * Sq + q0 + r) * H + h) * HD;
      for (int d = lane; d < HD; d += 32) s += dout[base + d] * out[base + d];
    }
    s = warp_sum(s);
    if (lane == 0) {
      const size_t row = ((size_t)b * H + h) * Sq + q0 + r;
      dl_s[r] = s;
      lse_s[r] = r < nq ? lse[row] : 0.f;
      if (r < nq) delta[row] = s;
    }
  }

  // Keys [k_begin, k_end) hold every key visible to some row of this tile.
  const int qp_lo = q_offset + q0, qp_hi = q_offset + q0 + nq - 1;
  const int k_end = causal ? min(Skv, qp_hi + 1) : Skv;
  const int k_begin = window > 0 ? max(0, qp_lo - window + 1) : 0;
  const int j_lo = k_begin / kBK;
  const int j_hi = k_begin < k_end ? (k_end + kBK - 1) / kBK : j_lo;

  float acc[kPer][kDimsPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kDimsPer; ++c) acc[i][c] = 0.f;
  __syncthreads();

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * kBK;
    const int nk = min(kBK, Skv - k0);
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int kr = e / HD, d = e - kr * HD;
      const bool ok = kr < nk;
      const size_t off = (((size_t)b * Skv + k0 + kr) * KV + hk) * HD + d;
      k_s[kr * (HD + 1) + d] = ok ? k[off] : 0.f;
      v_s[kr * (HD + 1) + d] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for rows 4ty.. and keys tx + 16c
    float s[kPer][kKeysPer], dp[kPer][kKeysPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kPer], ov[kPer], kv[kKeysPer], vv[kKeysPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        qv[i] = q_s[(ty * kPer + i) * (HD + 1) + d];
        ov[i] = do_s[(ty * kPer + i) * (HD + 1) + d];
      }
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) {
        kv[c] = k_s[(tx + 16 * c) * (HD + 1) + d];
        vv[c] = v_s[(tx + 16 * c) * (HD + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kKeysPer; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty * kPer + i;
      const int qp = q_offset + q0 + r;
#pragma unroll
      for (int c = 0; c < kKeysPer; ++c) {
        const int kc = tx + 16 * c;
        const bool vis = r < nq && kc < nk && visible(qp, k0 + kc, causal, window);
        const float p = vis ? expf(s[i][c] * scale - lse_s[r]) : 0.f;
        ds_s[r * (kBK + 1) + kc] = p * (dp[i][c] - dl_s[r]) * scale;
      }
    }
    __syncthreads();

    // dQ += dS K
    for (int kk = 0; kk < nk; ++kk) {
      float dsv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) dsv[i] = ds_s[(ty * kPer + i) * (kBK + 1) + kk];
#pragma unroll
      for (int c = 0; c < kDimsPer; ++c) {
        if (HD % 16 != 0 && tx + 16 * c >= HD) continue;
        const float kvv = k_s[kk * (HD + 1) + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][c] = fmaf(dsv[i], kvv, acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty * kPer + i;
    if (r >= nq) continue;
#pragma unroll
    for (int c = 0; c < kDimsPer; ++c)
      if (HD % 16 == 0 || tx + 16 * c < HD)
        dq[(((size_t)b * Sq + q0 + r) * H + h) * HD + tx + 16 * c] = acc[i][c];
  }
}

// Pass 2: grid (kv tiles of kBN, KV, B).
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const float* __restrict__ q,      // [B, Sq, H, HD]
    const float* __restrict__ k,      // [B, Skv, KV, HD]
    const float* __restrict__ v,      // [B, Skv, KV, HD]
    const float* __restrict__ dout,   // [B, Sq, H, HD]
    const float* __restrict__ lse,    // [B, H, Sq]
    const float* __restrict__ delta,  // [B, H, Sq]
    float* __restrict__ dk,           // [B, Skv, KV, HD]
    float* __restrict__ dv,           // [B, Skv, KV, HD]
    int Sq, int Skv, int H, int KV, int q_offset, int causal, int window, float scale) {
  constexpr int kDimsPer = (HD + 15) / 16;
  constexpr int kRowsPer = kBM / 16;
  const int k0 = blockIdx.x * kBN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int nk = min(kBN, Skv - k0);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  extern __shared__ float smem[];
  float* k_s = smem;                      // [kBN][HD + 1]
  float* v_s = k_s + kBN * (HD + 1);      // [kBN][HD + 1]
  float* q_s = v_s + kBN * (HD + 1);      // [kBM][HD + 1]
  float* do_s = q_s + kBM * (HD + 1);     // [kBM][HD + 1]
  float* p_s = do_s + kBM * (HD + 1);     // [kBN][kBM + 1]
  float* ds_s = p_s + kBN * (kBM + 1);    // [kBN][kBM + 1]
  float* lse_s = ds_s + kBN * (kBM + 1);  // [kBM]
  float* dl_s = lse_s + kBM;              // [kBM]

  for (int e = tid; e < kBN * HD; e += kThreads) {
    const int kr = e / HD, d = e - kr * HD;
    const bool ok = kr < nk;
    const size_t off = (((size_t)b * Skv + k0 + kr) * KV + hk) * HD + d;
    k_s[kr * (HD + 1) + d] = ok ? k[off] : 0.f;
    v_s[kr * (HD + 1) + d] = ok ? v[off] : 0.f;
  }

  // Rows [i_lo, i_hi) hold every query row that sees some key of this tile:
  // qp >= k0 under causality, qp - (k0 + nk - 1) < window under a window.
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(Sq, k0 + nk - 1 + window - q_offset) : Sq;
  const int t_lo = i_lo / kBM;
  const int t_hi = i_lo < i_hi ? (i_hi + kBM - 1) / kBM : t_lo;

  float adk[kPer][kDimsPer], adv[kPer][kDimsPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kDimsPer; ++c) adk[i][c] = adv[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * kBM;
      const int nq = min(kBM, Sq - q0);
      __syncthreads();  // the previous tile's readers are done
      for (int e = tid; e < kBM * HD; e += kThreads) {
        const int r = e / HD, d = e - r * HD;
        const bool ok = r < nq;
        const size_t off = (((size_t)b * Sq + q0 + r) * H + h) * HD + d;
        q_s[r * (HD + 1) + d] = ok ? q[off] : 0.f;
        do_s[r * (HD + 1) + d] = ok ? dout[off] : 0.f;
      }
      for (int r = tid; r < kBM; r += kThreads) {
        const size_t row = ((size_t)b * H + h) * Sq + q0 + r;
        lse_s[r] = r < nq ? lse[row] : 0.f;
        dl_s[r] = r < nq ? delta[row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for keys 4ty.. and rows tx + 16c
      float s[kPer][kRowsPer], dp[kPer][kRowsPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kRowsPer; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[kPer], vv[kPer], qv[kRowsPer], ov[kRowsPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          kv[i] = k_s[(ty * kPer + i) * (HD + 1) + d];
          vv[i] = v_s[(ty * kPer + i) * (HD + 1) + d];
        }
#pragma unroll
        for (int c = 0; c < kRowsPer; ++c) {
          qv[c] = q_s[(tx + 16 * c) * (HD + 1) + d];
          ov[c] = do_s[(tx + 16 * c) * (HD + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
          for (int c = 0; c < kRowsPer; ++c) {
            s[i][c] = fmaf(qv[c], kv[i], s[i][c]);
            dp[i][c] = fmaf(ov[c], vv[i], dp[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int kc = ty * kPer + i;
#pragma unroll
        for (int c = 0; c < kRowsPer; ++c) {
          const int r = tx + 16 * c;
          const bool vis =
              kc < nk && r < nq && visible(q_offset + q0 + r, k0 + kc, causal, window);
          const float p = vis ? expf(s[i][c] * scale - lse_s[r]) : 0.f;
          p_s[kc * (kBM + 1) + r] = p;
          ds_s[kc * (kBM + 1) + r] = p * (dp[i][c] - dl_s[r]) * scale;
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q
      for (int rr = 0; rr < nq; ++rr) {
        float pv[kPer], dsv[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          pv[i] = p_s[(ty * kPer + i) * (kBM + 1) + rr];
          dsv[i] = ds_s[(ty * kPer + i) * (kBM + 1) + rr];
        }
#pragma unroll
        for (int c = 0; c < kDimsPer; ++c) {
          if (HD % 16 != 0 && tx + 16 * c >= HD) continue;
          const float dov = do_s[rr * (HD + 1) + tx + 16 * c];
          const float qvv = q_s[rr * (HD + 1) + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            adv[i][c] = fmaf(pv[i], dov, adv[i][c]);
            adk[i][c] = fmaf(dsv[i], qvv, adk[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int kc = ty * kPer + i;
    if (kc >= nk) continue;
#pragma unroll
    for (int c = 0; c < kDimsPer; ++c)
      if (HD % 16 == 0 || tx + 16 * c < HD) {
        const size_t off = (((size_t)b * Skv + k0 + kc) * KV + hk) * HD + tx + 16 * c;
        dk[off] = adk[i][c];
        dv[off] = adv[i][c];
      }
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core form.

// The compute width of a head of HD dims (columns [HD, padded) hold zeros).
template <int HD>
__host__ __device__ constexpr int padded_hd() {
  return HD <= 32 ? 32 : HD <= 64 ? 64 : 128;
}

template <int HD>
constexpr size_t dq_mma_smem_bytes() {  // Q, dO, K, V tiles; lse and delta
  return sizeof(bf16) * (size_t)(2 * kMQ + 2 * kBK) * (padded_hd<HD>() + 8) +
         sizeof(float) * 2 * kMQ;
}

template <int HD>
constexpr size_t dkv_mma_smem_bytes() {  // K, V, Q, dO tiles; lse and delta
  return sizeof(bf16) * (size_t)(2 * kMK + 2 * kNQ) * (padded_hd<HD>() + 8) +
         sizeof(float) * 2 * kNQ;
}

// Rows [0, rows) of a [*][ld] bf16 array at `src` into dst[rows][padded_hd
// + 8]; rows from `nvalid` on are zero-filled.  kVec: one 16-byte cp.async
// a chunk of 8 values; otherwise synchronous scalar copies (an operand not
// 16-byte aligned).
template <int HD, bool kVec>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, size_t ld,
                                           int rows, int nvalid) {
  constexpr int kCh = HD / 8;
  for (int c = threadIdx.x; c < rows * kCh; c += kThreads) {
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

// The padding columns [HD, padded_hd) of `rows` staged rows: zeros that no
// copy overwrites.
template <int HD>
__device__ __forceinline__ void zero_padding(bf16* base, int rows) {
  constexpr int kHP = padded_hd<HD>(), kPad = kHP - HD;
  if constexpr (kPad > 0)
    for (int e = threadIdx.x; e < rows * kPad; e += kThreads)
      base[(e / kPad) * (kHP + 8) + HD + e % kPad] = __float2bfloat16(0.f);
}

// A operand of mma.m16n8k16 from four 16 x 8 accumulator tiles' values
// (n8 tiles 2c and 2c + 1 of a row block), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = tc::pack_bf16(lo[0], lo[1]);
  a[1] = tc::pack_bf16(lo[2], lo[3]);
  a[2] = tc::pack_bf16(hi[0], hi[1]);
  a[3] = tc::pack_bf16(hi[2], hi[3]);
}

// Pass 1: grid (H, B, q tiles of kMQ), the heaviest causal tiles first.
template <int HD, bool kVec>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ out, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq, int Sq,
    int Skv, int H, int KV, int q_offset, int causal, int window, float scale) {
  constexpr int kHP = padded_hd<HD>();
  constexpr int kLd = kHP + 8;
  constexpr int kKC = kHP / 16;  // k16 chunks of a dot over the head
  constexpr int kND = kHP / 8;   // n8 tiles of a head row
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kMQ;
  const int hk = h / (H / KV);
  const int nq = min(kMQ, Sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kMQ][kLd]
  bf16* do_s = q_s + kMQ * kLd;                     // [kMQ][kLd]
  bf16* k_s = do_s + kMQ * kLd;                     // [kBK][kLd]
  bf16* v_s = k_s + kBK * kLd;                      // [kBK][kLd]
  float* lse_s = reinterpret_cast<float*>(v_s + kBK * kLd);  // [kMQ]
  float* dl_s = lse_s + kMQ;                                 // [kMQ]
  zero_padding<HD>(q_s, 2 * kMQ + 2 * kBK);

  const size_t q_ld = (size_t)H * HD, kv_ld = (size_t)KV * HD;
  const size_t q_off = (((size_t)b * Sq + q0) * H + h) * HD;
  stage_rows<HD, kVec>(q_s, q + q_off, q_ld, kMQ, nq);
  stage_rows<HD, kVec>(do_s, dout + q_off, q_ld, kMQ, nq);
  tc::cp_async_commit();
  // delta = rowsum(dO * O) in f32, a warp a row
  for (int r = warp; r < kMQ; r += kThreads / 32) {
    float s = 0.f;
    if (r < nq)
      for (int d = lane; d < HD; d += 32)
        s += __bfloat162float(dout[q_off + (size_t)r * q_ld + d]) *
             __bfloat162float(out[q_off + (size_t)r * q_ld + d]);
    s = warp_sum(s);
    if (lane == 0) {
      const size_t row = ((size_t)b * H + h) * Sq + q0 + r;
      dl_s[r] = s;
      lse_s[r] = r < nq ? lse[row] : 0.f;
      if (r < nq) delta[row] = s;
    }
  }

  // Keys [k_begin, k_end) hold every key visible to some row of this tile.
  const int qp_lo = q_offset + q0, qp_hi = q_offset + q0 + nq - 1;
  const int k_end = causal ? min(Skv, qp_hi + 1) : Skv;
  const int k_begin = window > 0 ? max(0, qp_lo - window + 1) : 0;
  const int j_lo = k_begin / kBK;
  const int j_hi = k_begin < k_end ? (k_end + kBK - 1) / kBK : j_lo;

  tc::cp_async_wait<0>();
  __syncthreads();
  // this thread's rows g and g + 8 of the warp's 16
  const int r0 = warp * 16;
  const int rows[2] = {r0 + g, r0 + g + 8};
  const float row_lse[2] = {lse_s[rows[0]], lse_s[rows[1]]};
  const float row_dl[2] = {dl_s[rows[0]], dl_s[rows[1]]};
  float acc[kND][4];
#pragma unroll
  for (int d = 0; d < kND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * kBK;
    const int nk = min(kBK, Skv - k0);
    const size_t kv_off = ((size_t)b * Skv + k0) * kv_ld + (size_t)hk * HD;
    stage_rows<HD, kVec>(k_s, k + kv_off, kv_ld, kBK, nk);
    stage_rows<HD, kVec>(v_s, v + kv_off, kv_ld, kBK, nk);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: K and V rows (keys) are the B operand's
    // columns, read by ldmatrix without .trans
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n8][e] = dp[n8][e] = 0.f;
#pragma unroll
    for (int c = 0; c < kKC; ++c) {
      uint32_t qa[4], oa[4];
      tc::ldmatrix_x4(qa, q_s + (r0 + (lane & 15)) * kLd + c * 16 + (lane >> 4) * 8);
      tc::ldmatrix_x4(oa, do_s + (r0 + (lane & 15)) * kLd + c * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + c * 16 +
                        (((lane >> 3) & 1) << 3);
        uint32_t kb[4], vb[4];
        tc::ldmatrix_x4(kb, k_s + off);
        tc::mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        tc::mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        tc::ldmatrix_x4(vb, v_s + off);
        tc::mma_bf16(dp[2 * np], oa, vb[0], vb[1]);
        tc::mma_bf16(dp[2 * np + 1], oa, vb[2], vb[3]);
      }
    }
    // dS = P (dP - delta) scale, P = exp(s scale - lse) on visible keys
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, kc = n8 * 8 + 2 * t + (e & 1);
        const bool vis = rows[i] < nq && kc < nk &&
                         visible(q_offset + q0 + rows[i], k0 + kc, causal, window);
        const float p = vis ? expf(s[n8][e] * scale - row_lse[i]) : 0.f;
        s[n8][e] = p * (dp[n8][e] - row_dl[i]) * scale;
      }
    // dQ += dS K: dS rounded to bf16 (K's type, as _bwd rounds it) is the A
    // operand; K rows (keys) are the B operand's k, read with .trans
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {
      uint32_t pa[4];
      pack_a(pa, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int dd = 0; dd < kND / 2; ++dd) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, k_s + (c * 16 + (lane & 15)) * kLd + dd * 16 +
                                     ((lane >> 4) << 3));
        tc::mma_bf16(acc[2 * dd], pa, r[0], r[1]);
        tc::mma_bf16(acc[2 * dd + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with K and V before they are refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= nq) continue;
    bf16* o = dq + q_off + (size_t)rows[i] * q_ld + 2 * t;
#pragma unroll
    for (int d = 0; d < kND; ++d)
      if (d * 8 < HD)  // the padding dims' tile is never stored
        *reinterpret_cast<__nv_bfloat162*>(o + d * 8) =
            __floats2bfloat162_rn(acc[d][2 * i], acc[d][2 * i + 1]);
  }
}

// Pass 2: grid (kv tiles of kMK, KV, B).
template <int HD, bool kVec>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
    int Skv, int H, int KV, int q_offset, int causal, int window, float scale) {
  constexpr int kHP = padded_hd<HD>();
  constexpr int kLd = kHP + 8;
  constexpr int kKC = kHP / 16;
  constexpr int kND = kHP / 8;
  const int k0 = blockIdx.x * kMK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int nk = min(kMK, Skv - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kMK][kLd]
  bf16* v_s = k_s + kMK * kLd;                      // [kMK][kLd]
  bf16* q_s = v_s + kMK * kLd;                      // [kNQ][kLd]
  bf16* do_s = q_s + kNQ * kLd;                     // [kNQ][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + kNQ * kLd);  // [kNQ]
  float* dl_s = lse_s + kNQ;                                  // [kNQ]
  zero_padding<HD>(k_s, 2 * kMK + 2 * kNQ);

  const size_t q_ld = (size_t)H * HD, kv_ld = (size_t)KV * HD;
  const size_t kv_off = ((size_t)b * Skv + k0) * kv_ld + (size_t)hk * HD;
  stage_rows<HD, kVec>(k_s, k + kv_off, kv_ld, kMK, nk);
  stage_rows<HD, kVec>(v_s, v + kv_off, kv_ld, kMK, nk);
  tc::cp_async_commit();

  // Rows [i_lo, i_hi) hold every query row that sees some key of this tile.
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(Sq, k0 + nk - 1 + window - q_offset) : Sq;
  const int t_lo = i_lo / kNQ;
  const int t_hi = i_lo < i_hi ? (i_hi + kNQ - 1) / kNQ : t_lo;

  // this thread's keys g and g + 8 of the warp's 16
  const int r0 = warp * 16;
  const int keys[2] = {r0 + g, r0 + g + 8};
  float adk[kND][4], adv[kND][4];
#pragma unroll
  for (int d = 0; d < kND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[d][e] = adv[d][e] = 0.f;

  for (int gh = 0; gh < G; ++gh) {
    const int h = hk * G + gh;
    for (int tt = t_lo; tt < t_hi; ++tt) {
      const int q0 = tt * kNQ;
      const int nq = min(kNQ, Sq - q0);
      __syncthreads();  // the previous tile's readers are done
      const size_t q_off = (((size_t)b * Sq + q0) * H + h) * HD;
      stage_rows<HD, kVec>(q_s, q + q_off, q_ld, kNQ, nq);
      stage_rows<HD, kVec>(do_s, dout + q_off, q_ld, kNQ, nq);
      tc::cp_async_commit();
      for (int r = threadIdx.x; r < kNQ; r += kThreads) {
        const size_t row = ((size_t)b * H + h) * Sq + q0 + r;
        lse_s[r] = r < nq ? lse[row] : 0.f;
        dl_s[r] = r < nq ? delta[row] : 0.f;
      }
      tc::cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T (16 keys x 32 rows a warp): Q and dO
      // rows are the B operand's columns, read without .trans
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n8][e] = dpt[n8][e] = 0.f;
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        uint32_t ka[4], va[4];
        tc::ldmatrix_x4(ka, k_s + (r0 + (lane & 15)) * kLd + c * 16 + (lane >> 4) * 8);
        tc::ldmatrix_x4(va, v_s + (r0 + (lane & 15)) * kLd + c * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < kNQ / 16; ++np) {
          const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + c * 16 +
                          (((lane >> 3) & 1) << 3);
          uint32_t qb[4], ob[4];
          tc::ldmatrix_x4(qb, q_s + off);
          tc::mma_bf16(st[2 * np], ka, qb[0], qb[1]);
          tc::mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
          tc::ldmatrix_x4(ob, do_s + off);
          tc::mma_bf16(dpt[2 * np], va, ob[0], ob[1]);
          tc::mma_bf16(dpt[2 * np + 1], va, ob[2], ob[3]);
        }
      }
      // P^T and dS^T on visible (key, row) pairs
#pragma unroll
      for (int n8 = 0; n8 < 4; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = keys[e >> 1], rr = n8 * 8 + 2 * t + (e & 1);
          const bool vis = key < nk && rr < nq &&
                           visible(q_offset + q0 + rr, k0 + key, causal, window);
          const float p = vis ? expf(st[n8][e] * scale - lse_s[rr]) : 0.f;
          st[n8][e] = p;
          dpt[n8][e] = p * (dpt[n8][e] - dl_s[rr]) * scale;
        }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T, rounded to bf16, are
      // the A operands; dO and Q rows (query rows) are the B operand's k,
      // read with .trans
#pragma unroll
      for (int c = 0; c < kNQ / 16; ++c) {
        uint32_t pa[4], sa[4];
        pack_a(pa, st[2 * c], st[2 * c + 1]);
        pack_a(sa, dpt[2 * c], dpt[2 * c + 1]);
#pragma unroll
        for (int dd = 0; dd < kND / 2; ++dd) {
          const int off = (c * 16 + (lane & 15)) * kLd + dd * 16 + ((lane >> 4) << 3);
          uint32_t r[4];
          tc::ldmatrix_x4_trans(r, do_s + off);
          tc::mma_bf16(adv[2 * dd], pa, r[0], r[1]);
          tc::mma_bf16(adv[2 * dd + 1], pa, r[2], r[3]);
          tc::ldmatrix_x4_trans(r, q_s + off);
          tc::mma_bf16(adk[2 * dd], sa, r[0], r[1]);
          tc::mma_bf16(adk[2 * dd + 1], sa, r[2], r[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= nk) continue;
    const size_t off = kv_off + (size_t)keys[i] * kv_ld + 2 * t;
#pragma unroll
    for (int d = 0; d < kND; ++d)
      if (d * 8 < HD) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + d * 8) =
            __floats2bfloat162_rn(adk[d][2 * i], adk[d][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + d * 8) =
            __floats2bfloat162_rn(adv[d][2 * i], adv[d][2 * i + 1]);
      }
  }
}

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Skv, H, KV, q_offset, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// f32: the CUDA-core kernels
template <int HD>
cudaError_t launch_f32(const Args& a) {
  constexpr size_t smem1 = dq_smem_bytes<HD>(), smem2 = dkv_smem_bytes<HD>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<HD>, smem1);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkv_kernel<HD>, smem2);
  if (err != cudaSuccess) return err;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  const dim3 grid1((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_bwd_dq_kernel<HD><<<grid1, kThreads, smem1, a.stream>>>(
      q, k, v, static_cast<const float*>(a.out), dout, a.lse, a.delta,
      static_cast<float*>(a.dq), a.Sq, a.Skv, a.H, a.KV, a.q_offset, a.causal, a.window,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((a.Skv + kBN - 1) / kBN, a.KV, a.B);
  flash_bwd_dkv_kernel<HD><<<grid2, kThreads, smem2, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.Sq, a.Skv, a.H, a.KV, a.q_offset, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// bf16: the tensor-core kernels
template <int HD, bool kVec>
cudaError_t launch_mma_vec(const Args& a) {
  constexpr size_t smem1 = dq_mma_smem_bytes<HD>(), smem2 = dkv_mma_smem_bytes<HD>();
  cudaError_t err = allow_smem(flash_bwd_dq_mma_kernel<HD, kVec>, smem1);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dkv_mma_kernel<HD, kVec>, smem2);
  if (err != cudaSuccess) return err;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const dim3 grid1(a.H, a.B, (a.Sq + kMQ - 1) / kMQ);
  flash_bwd_dq_mma_kernel<HD, kVec><<<grid1, kThreads, smem1, a.stream>>>(
      q, k, v, static_cast<const bf16*>(a.out), dout, a.lse, a.delta, static_cast<bf16*>(a.dq),
      a.Sq, a.Skv, a.H, a.KV, a.q_offset, a.causal, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((a.Skv + kMK - 1) / kMK, a.KV, a.B);
  flash_bwd_dkv_mma_kernel<HD, kVec><<<grid2, kThreads, smem2, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq,
      a.Skv, a.H, a.KV, a.q_offset, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma(const Args& a) {
  const bool vec = ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                     reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout)) &
                    15) == 0;
  return vec ? launch_mma_vec<HD, true>(a) : launch_mma_vec<HD, false>(a);
}

template <int HD>
cudaError_t launch_hd(const Args& a, int dtype) {
  return dtype == 1 ? launch_mma<HD>(a) : launch_f32<HD>(a);
}

}  // namespace

// hd: 32, 64, 120 or 128.  window <= 0 means no sliding window.  dtype: 0 =
// float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv all of it).  lse:
// the forward's [B, H, Sq] f32; delta: [B, H, Sq] f32 scratch that pass 1
// writes and pass 2 reads.  Both passes launch on `stream`, pass 2 after
// pass 1.  Returns the first launch's cudaError_t that is not 0 (0 = both
// launched).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int Sq, int Skv, int H, int KV, int hd, int q_offset,
                                          int causal, int window, float scale, int dtype,
                                          void* stream) {
  const Args a{q, k, v, out, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, dk, dv, B, Sq, Skv, H, KV, q_offset, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 32: return (int)launch_hd<32>(a, dtype);
    case 64: return (int)launch_hd<64>(a, dtype);
    case 120: return (int)launch_hd<120>(a, dtype);
    case 128: return (int)launch_hd<128>(a, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}

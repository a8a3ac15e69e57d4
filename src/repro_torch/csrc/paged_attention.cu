// Fused paged decode / chunk attention for Hopper (sm_90a), the page sweep
// of each (slot, kv head) split across blocks (the flash-decoding layout).
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
// What bounds it on the H100: bytes, and at decode latency.  Each (slot,
// kv head) reads its live pages once (2*ps*hd elements a page) and does
// 4*hd flops per (query row, key), far below the ~295 flops a byte where
// the tensor cores would bind.  At decode there is little to read (a
// 4-slot group's live pages are ~1 MB over all heads), so what costs is
// latency: a block that walks its slot's pages one after another keeps a
// few KB in flight and the card idle.
//
// Design.  The grid is (kv head x row chunk, slot, split).  The host picks
// the split count S from B*KV and pps (kernels/paged_attention/ops.py::
// split_plan) so that the grid covers the 132 SMs; split s takes the table
// entries j = s, s + S, s + 2S, ... (interleaved, so that every split gets
// a share of a short slot's live pages), and warp w of its 4 warps the
// split's entries w, w + 4, ...  A warp applies the skip rule of _pa_body
// to each entry on its own: a garbage-routed entry, or a page in which no
// (query, key) pair of the slot (all C rows, whatever rows the block
// holds) is visible, costs one table read and nothing else.  Each warp
// keeps its own online softmax (m, l, acc in f32), the 4 warps merge in
// shared memory, and the block writes its partial (m, l, acc) to a f32
// workspace; a second launch merges the S partials of each row in split
// order (fixed: two launches give the same bits), applies the l == 0 -> 1
// guard and writes the output once.  With S == 1 the block writes the
// output itself.  Masked scores are -1e30 (not -inf), so within a live page
// a row with no visible key so far takes p = exp(-1e30 - (-1e30)) = 1, as
// the reference does, and rows that see no key of any live page come back
// as exact 0.  A split that sees only dead pages contributes m = -1e30,
// l = 0.
//
// Two block bodies:
//   * CUDA cores (f32 and int8 pools at every C; bf16 pools below 16 query
//     rows): a block holds kRB query rows (r = c*G + g, GQA rows read in
//     place from the [B, C, H, hd] layout).  A key row of hd elements is
//     hd/8 lanes x 8 values, each lane's 8 values one 16-byte load (bf16),
//     two (f32) or one 8-byte load of codes (int8, dequantized with the
//     token's f16 scale as it arrives); a warp loads up to 4 passes of keys
//     of a page before it scores them.  Dots reduce over the row's lanes by
//     shuffles.  bf16 pools round p to bf16 before p.V (the reference's
//     rounding to the pool type); int8 pools keep q and p in f32, as the
//     reference's quantized consumer (kernels/paged_attention/ref.py).
//   * Tensor cores (bf16 pools, C*G >= 16, 16-key multiples per page): a
//     block holds 64 query rows (4 m16 tiles); each warp stages its page's
//     K and V by cp.async into its own padded shared tile, and computes
//     S = Q K^T and P V with mma.m16n8k16 (bf16 in, f32 accumulate) from
//     ldmatrix fragments, the online softmax on the accumulator fragments
//     (scores in log2 units, exp2f), p rounded to bf16 as the A operand.
//
// Head dims 32, 64, 128 and 120 (h2o-danube-3-4b: d_model 3840 over 32
// heads).  Both bodies compute at a width of padded_hd(HD), the power of
// two at or above HD (128 for 120), over rows laid out at the true stride
// HD: in the CUDA-core body a key row is padded_hd/8 lanes, and the lanes
// whose 8 dims start at or past HD load no value and hold zeros; in the
// tensor-core body the shared-memory columns [HD, padded_hd) of the Q, K
// and V tiles are zeroed once and no copy writes them.  The q . k terms of
// those dims are 0 * 0 and their value columns 0, so the scores, the
// softmax and the HD stored output columns are exact, and the padding dims
// of the output are never stored.  120 = 15 x 8, so every 16-byte load of
// a row stays aligned (240 bytes a bf16 row, 480 f32, 120 int8).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRB = 4;   // query rows a CUDA-core block holds
constexpr int kMB = 64;  // query rows a tensor-core block holds
constexpr int kMaxPass = 4;  // key passes a warp loads before it scores them

struct Args {
  const void* q;        // [B, C, H, hd] in T
  const void* pool_k;   // [P+1, ps, KV, hd] in P
  const void* pool_v;
  const __half* k_scale;  // [P+1, ps] (int8 pools only)
  const __half* v_scale;
  const int* table;     // [B, pps]
  const int* qpos;      // [B, C]
  const int* lengths;   // [B] ring anchor (last written position)
  void* out;            // [B, C, H, hd] in T
  float* ws;            // S > 1: m, l [B*C*H*S] then acc [B*C*H*S, hd]
  int B, C, H, KV, ps, pps, garbage, window, splits;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// The compute width of a head of HD dims (see the header): a power of two.
template <int HD>
__host__ __device__ constexpr int padded_hd() {
  return HD <= 32 ? 32 : HD <= 64 ? 64 : 128;
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

// Is table entry j of slot b live: mapped, and some (query, key) pair of
// the slot's C rows visible in it?  One answer for the whole warp.
__device__ __forceinline__ bool page_live(const Args& a, const int* qp_s, int b, int j, int ln,
                                          int& phys) {
  phys = a.table[b * a.pps + j];
  if (phys == a.garbage) return false;
  const int W = a.pps * a.ps, lane = threadIdx.x & 31;
  int any = 0;
  for (int e = lane; e < a.C * a.ps && !any; e += 32) {
    const int c = e / a.ps, i = e - c * a.ps;
    any = visible(ring_pos(ln, j * a.ps + i, W), qp_s[c], a.window);
  }
  return __any_sync(0xffffffffu, any);
}

// 8 consecutive values of a row as f32: one 16-byte load (bf16), two (f32)
// or one 8-byte load of int8 codes.
__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(float (&v)[8], const signed char* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const signed char* c = reinterpret_cast<const signed char*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = (float)c[e];
}

// load8, or zeros for a lane past the head's last dim (nothing is read)
template <typename P>
__device__ __forceinline__ void load8_or_zero(float (&v)[8], const P* p, bool live) {
  if (live) {
    load8(v, p);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
  }
}

// Index of row (b, c, query head hq) in the workspace's [B*C*H] rows.
__device__ __forceinline__ size_t ws_row(const Args& a, int b, int c, int hq) {
  return ((size_t)b * a.C + c) * a.H + hq;
}

// A block's merged state of one query row -> the output (S == 1) or the
// workspace (split s).  m is in natural units (exp) or log2 units (exp2).
template <typename T>
__device__ __forceinline__ void emit(const Args& a, int b, int c, int hq, int d, int hd,
                                     float m, float l, float acc) {
  const size_t row = ws_row(a, b, c, hq);
  if (a.splits == 1) {
    static_cast<T*>(a.out)[row * hd + d] = from_f<T>(acc / (l == 0.f ? 1.f : l));
    return;
  }
  const size_t rows = (size_t)a.B * a.C * a.H * a.splits;
  const size_t slot = row * a.splits + blockIdx.z;
  if (d == 0) {
    a.ws[slot] = m;
    a.ws[rows + slot] = l;
  }
  a.ws[2 * rows + slot * hd + d] = acc;
}

// ---------------------------------------------------------------------------
// CUDA cores: every pool type, any C.

template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(const Args a) {
  constexpr bool kQuant = std::is_same<P, signed char>::value;
  constexpr int kLPK = padded_hd<HD>() / 8;  // lanes a key row (a power of two)
  constexpr int kKPW = 32 / kLPK;            // keys a warp pass
  const int KV = a.KV, h = blockIdx.x % KV, rc = blockIdx.x / KV;
  const int b = blockIdx.y, s = blockIdx.z, S = a.splits;
  const int G = a.H / KV, R = a.C * G;
  const int r0 = rc * kRB, nr = min(kRB, R - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = lane / kLPK, dg = lane % kLPK;  // key group, 8-dim group
  const bool live_d = dg * 8 < HD;  // false: dims past the head, zeros (HD = 120)
  const int ps = a.ps, W = a.pps * ps;
  const int ln = a.lengths[b];

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wm = reinterpret_cast<float*>(smem_raw);  // [kWarps][kRB]
  float* wl = wm + kWarps * kRB;                    // [kWarps][kRB]
  float* wacc = wl + kWarps * kRB;                  // [kWarps][kRB][HD]
  int* qp_s = reinterpret_cast<int*>(wacc + kWarps * kRB * HD);  // [C]
  for (int c = threadIdx.x; c < a.C; c += kThreads) qp_s[c] = a.qpos[b * a.C + c];
  __syncthreads();

  // this lane's 8 dims of each of the block's query rows, in f32, and the
  // rows' positions (rows past nr repeat the last row and are not written)
  float qv[kRB][8];
  int qrow_pos[kRB];
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    const int rr = r0 + min(r, nr - 1);
    const int c = rr / G, g = rr - c * G;
    load8_or_zero(qv[r], static_cast<const T*>(a.q) + ws_row(a, b, c, h * G + g) * HD + dg * 8,
                  live_d);
    qrow_pos[r] = qp_s[c];
  }

  float m[kRB], l[kRB], acc[kRB][8];
#pragma unroll
  for (int r = 0; r < kRB; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  const P* pk = static_cast<const P*>(a.pool_k);
  const P* pv = static_cast<const P*>(a.pool_v);
  for (int t = warp;; t += kWarps) {
    const int j = s + t * S;
    if (j >= a.pps) break;
    int phys;
    if (!page_live(a, qp_s, b, j, ln, phys)) continue;
    for (int i0 = 0; i0 < ps; i0 += kMaxPass * kKPW) {
      // up to kMaxPass passes of keys: every load in flight before use
      float kr[kMaxPass][8], vr[kMaxPass][8];
      int kp[kMaxPass];
      bool has[kMaxPass];
#pragma unroll
      for (int p = 0; p < kMaxPass; ++p) {
        const int i = i0 + p * kKPW + kg;
        has[p] = i < ps;
        const int ii = has[p] ? i : 0;
        kp[p] = ring_pos(ln, j * ps + ii, W);
        const size_t off = (((size_t)phys * ps + ii) * KV + h) * HD + dg * 8;
        load8_or_zero(kr[p], pk + off, live_d);
        load8_or_zero(vr[p], pv + off, live_d);
        if constexpr (kQuant) {
          const float ks = __half2float(a.k_scale[(size_t)phys * ps + ii]);
          const float vs = __half2float(a.v_scale[(size_t)phys * ps + ii]);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kr[p][e] *= ks;
            vr[p][e] *= vs;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        if (r >= nr) break;
        float sc[kMaxPass], mx = kNegInf;
#pragma unroll
        for (int p = 0; p < kMaxPass; ++p) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qv[r][e], kr[p][e], dot);
#pragma unroll
          for (int off = 1; off < kLPK; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
          sc[p] = visible(kp[p], qrow_pos[r], a.window) ? dot * a.scale : kNegInf;
          if (has[p]) mx = fmaxf(mx, sc[p]);
        }
#pragma unroll
        for (int off = kLPK; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[r], mx);
        const float corr = expf(m[r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] *= corr;
#pragma unroll
        for (int p = 0; p < kMaxPass; ++p) {
          const float pe = has[p] ? expf(sc[p] - m_new) : 0.f;
          sum += pe;
          // p enters p . V in the pool's type (f32 for a dequantized pool)
          float pw = pe;
          if constexpr (!kQuant) pw = to_f(from_f<P>(pe));
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pw, vr[p][e], acc[r][e]);
        }
        // each key counted once: the lanes of a key group hold one key
        if (dg != 0) sum = 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[r] = l[r] * corr + sum;
        m[r] = m_new;
      }
    }
  }

  // the warp's acc over its key groups, then the 4 warps in shared memory
#pragma unroll
  for (int r = 0; r < kRB; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int off = kLPK; off < 32; off <<= 1)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
  if (kg == 0 && live_d) {
#pragma unroll
    for (int r = 0; r < kRB; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) wacc[(warp * kRB + r) * HD + dg * 8 + e] = acc[r][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRB; ++r) {
      wm[warp * kRB + r] = m[r];
      wl[warp * kRB + r] = l[r];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kRB + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * kRB + r] - M);
      L += wl[w * kRB + r] * f;
      A += wacc[(w * kRB + r) * HD + d] * f;
    }
    const int rr = r0 + r, c = rr / G, g = rr - c * G;
    emit<T>(a, b, c, h * G + g, d, HD, M, L, A);
  }
}

// ---------------------------------------------------------------------------
// Tensor cores: bf16 pools, C*G >= 16, ps a multiple of 16.

template <int HD>
constexpr size_t mma_smem_bytes() {  // Q tile, each warp's K and V tile, merge state
  return sizeof(bf16) * (size_t)(kMB + kWarps * 2 * 16) * (padded_hd<HD>() + 8) +
         sizeof(float) * (size_t)kWarps * 16 * (HD + 2);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) paged_attention_mma_kernel(const Args a) {
  constexpr int kHP = padded_hd<HD>();  // compute width: columns [HD, kHP) hold zeros
  constexpr int kLd = kHP + 8;   // padded bf16 row: ldmatrix rows in distinct banks
  constexpr int kKC = kHP / 16;  // k16 chunks of a q . k dot
  constexpr int kND = kHP / 8;   // n8 tiles of an output row
  const int KV = a.KV, h = blockIdx.x % KV, rc = blockIdx.x / KV;
  const int b = blockIdx.y, s = blockIdx.z, S = a.splits;
  const int G = a.H / KV, R = a.C * G;
  const int r0 = rc * kMB, nr = min(kMB, R - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int ps = a.ps, W = a.pps * ps;
  const int ln = a.lengths[b];
  const float scale_log2 = a.scale * 1.4426950408889634f;
  // row tiles of 16, warps per row tile (a power of two), this warp's tile
  const int RT = (nr + 15) / 16;
  const int RTp = RT == 1 ? 1 : RT == 2 ? 2 : 4;
  const int WPR = kWarps / RTp, rt = warp % RTp, phase = warp / RTp;
  const bool active = rt < RT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);      // [kMB][kLd]
  bf16* k_s = q_s + kMB * kLd + warp * 2 * 16 * kLd;  // this warp's [16][kLd]
  bf16* v_s = k_s + 16 * kLd;
  float* mstate = reinterpret_cast<float*>(q_s + (kMB + kWarps * 2 * 16) * kLd);
  float* wm = mstate + warp * 16 * (HD + 2);  // this warp's [16] m, [16] l, [16][HD] acc
  float* wl = wm + 16;
  float* wacc = wl + 16;
  int* qp_s = reinterpret_cast<int*>(mstate + kWarps * 16 * (HD + 2));  // [C]
  for (int c = threadIdx.x; c < a.C; c += kThreads) qp_s[c] = a.qpos[b * a.C + c];
  if constexpr (kHP != HD) {
    // columns [HD, kHP) of the Q tile and of this warp's K and V tiles (32
    // rows from k_s): zeros that no copy overwrites
    constexpr int kPad = kHP - HD;
    for (int e = threadIdx.x; e < kMB * kPad; e += kThreads)
      q_s[(e / kPad) * kLd + HD + e % kPad] = __float2bfloat16(0.f);
    for (int e = lane; e < 2 * 16 * kPad; e += 32)
      k_s[(e / kPad) * kLd + HD + e % kPad] = __float2bfloat16(0.f);
  }

  // the block's query rows, zero past nr
  const bf16* q = static_cast<const bf16*>(a.q);
  for (int e = threadIdx.x; e < kMB * (HD / 8); e += kThreads) {
    const int r = e / (HD / 8), col = (e % (HD / 8)) * 8;
    const int rr = r0 + min(r, nr - 1), c = rr / G, g = rr - c * G;
    tc::cp_async16(q_s + r * kLd + col, q + ws_row(a, b, c, h * G + g) * HD + col,
                   r < nr ? 16 : 0);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[kKC][4];
#pragma unroll
  for (int c = 0; c < kKC; ++c)
    tc::ldmatrix_x4(qf[c], q_s + (rt * 16 + (lane & 15)) * kLd + c * 16 + (lane >> 4) * 8);
  // this thread's rows g8 and g8 + 8 of the warp's tile: their positions
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rt * 16 + g8 + 8 * i;
    qp[i] = r < nr ? qp_s[(r0 + r) / G] : -1;  // a padding row sees no key
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kND][4];
#pragma unroll
  for (int d = 0; d < kND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  const bf16* pk = static_cast<const bf16*>(a.pool_k);
  const bf16* pv = static_cast<const bf16*>(a.pool_v);
  for (int t = phase; active; t += WPR) {
    const int j = s + t * S;
    if (j >= a.pps) break;
    int phys;
    if (!page_live(a, qp_s, b, j, ln, phys)) continue;
    for (int i0 = 0; i0 < ps; i0 += 16) {
      for (int e = lane; e < 16 * (HD / 8); e += 32) {
        const int i = e / (HD / 8), col = (e % (HD / 8)) * 8;
        const size_t off = (((size_t)phys * ps + i0 + i) * KV + h) * HD + col;
        tc::cp_async16(k_s + i * kLd + col, pk + off, 16);
        tc::cp_async16(v_s + i * kLd + col, pv + off, 16);
      }
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncwarp();

      // S = Q K^T over the 16 keys: K rows are the B operand's columns
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        uint32_t r[4];
        tc::ldmatrix_x4(r, k_s + ((lane & 7) + ((lane >> 4) << 3)) * kLd + c * 16 +
                               (((lane >> 3) & 1) << 3));
        tc::mma_bf16(sc[0], qf[c], r[0], r[1]);
        tc::mma_bf16(sc[1], qf[c], r[2], r[3]);
      }
      // scale and mask (-1e30 as the reference), online softmax in log2 units
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = ring_pos(ln, j * ps + i0 + n8 * 8 + 2 * t4 + (e & 1), W);
          const bool ok = visible(kp, qp[e >> 1], a.window);
          sc[n8][e] = ok ? sc[n8][e] * scale_log2 : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n8][e]);
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
      for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[n8][e] - m[e >> 1]);
          sc[n8][e] = p;
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
      // O += P V: p rounded to bf16 (the pool's type) is the A operand
      const uint32_t pa[4] = {tc::pack_bf16(sc[0][0], sc[0][1]), tc::pack_bf16(sc[0][2], sc[0][3]),
                              tc::pack_bf16(sc[1][0], sc[1][1]), tc::pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int dp = 0; dp < kND / 2; ++dp) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, v_s + (lane & 15) * kLd + dp * 16 + ((lane >> 4) << 3));
        tc::mma_bf16(acc[2 * dp], pa, r[0], r[1]);
        tc::mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
      }
      __syncwarp();  // the warp is done with its tiles before they are refilled
    }
  }

  // each warp's state into shared memory, then the warps of a row tile merge
  if (t4 == 0) {
    wm[g8] = m[0];
    wm[g8 + 8] = m[1];
    wl[g8] = l[0];
    wl[g8 + 8] = l[1];
  }
#pragma unroll
  for (int d = 0; d < kND; ++d) {
    if (d * 8 >= HD) break;  // the padding dims: zeros, never stored
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wacc[(g8 + 8 * (e >> 1)) * HD + d * 8 + 2 * t4 + (e & 1)] = acc[d][e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD, tile = r / 16, tr = r % 16;
    float M = kNegInf;
    for (int ph = 0; ph < WPR; ++ph)
      M = fmaxf(M, mstate[(tile + RTp * ph) * 16 * (HD + 2) + tr]);
    float L = 0.f, A = 0.f;
    for (int ph = 0; ph < WPR; ++ph) {
      const float* st = mstate + (tile + RTp * ph) * 16 * (HD + 2);
      const float f = exp2f(st[tr] - M);
      L += st[16 + tr] * f;
      A += st[32 + tr * HD + d] * f;
    }
    const int rr = r0 + r, c = rr / G, g = rr - c * G;
    emit<bf16>(a, b, c, h * G + g, d, HD, M, L, A);
  }
}

// ---------------------------------------------------------------------------
// The merge: each output row from its S partials, in split order.

template <typename T>
__global__ void paged_attention_merge_kernel(const Args a, int hd, int log2_units) {
  const size_t rows = (size_t)a.B * a.C * a.H;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * hd) return;
  const size_t row = e / hd;
  const int d = (int)(e - row * hd), S = a.splits;
  const float* m = a.ws + row * S;
  const float* l = a.ws + rows * S + row * S;
  const float* acc = a.ws + 2 * rows * S + row * S * hd + d;
  float M = kNegInf;
  for (int s = 0; s < S; ++s) M = fmaxf(M, m[s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < S; ++s) {
    const float f = log2_units ? exp2f(m[s] - M) : expf(m[s] - M);
    L += l[s] * f;
    A += acc[(size_t)s * hd] * f;
  }
  static_cast<T*>(a.out)[e] = from_f<T>(A / (L == 0.f ? 1.f : L));
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, typename P, int HD>
cudaError_t launch(const Args& a, bool mma, cudaStream_t stream) {
  const int R = a.C * (a.H / a.KV);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value && std::is_same<P, bf16>::value) {
    if (mma) {
      const size_t smem = mma_smem_bytes<HD>() + sizeof(int) * a.C;
      if ((err = set_smem(paged_attention_mma_kernel<HD>, smem)) != cudaSuccess) return err;
      paged_attention_mma_kernel<HD>
          <<<dim3(a.KV * ((R + kMB - 1) / kMB), a.B, a.splits), kThreads, smem, stream>>>(a);
    }
  }
  if (!mma) {
    const size_t smem = sizeof(float) * kWarps * kRB * (HD + 2) + sizeof(int) * a.C;
    if ((err = set_smem(paged_attention_kernel<T, P, HD>, smem)) != cudaSuccess) return err;
    paged_attention_kernel<T, P, HD>
        <<<dim3(a.KV * ((R + kRB - 1) / kRB), a.B, a.splits), kThreads, smem, stream>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || a.splits == 1) return err;
  const size_t total = (size_t)a.B * a.C * a.H * HD;
  paged_attention_merge_kernel<T>
      <<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(a, HD, mma ? 1 : 0);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch_hd(const Args& a, int hd, bool mma, cudaStream_t stream) {
  if (hd == 32) return launch<T, P, 32>(a, mma, stream);
  if (hd == 64) return launch<T, P, 64>(a, mma, stream);
  if (hd == 128) return launch<T, P, 128>(a, mma, stream);
  if (hd == 120) return launch<T, P, 120>(a, mma, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (q, out): 0 = float32, 1 = bfloat16.  quant: 0 = pools in q's
// type (k_scale, v_scale unused), 1 = int8 pools with f16 scales [P+1, ps].
// window <= 0 means no sliding window.  hd is 32, 64, 120 or 128; pointers are
// 16-byte aligned.  splits: the split count S (ops.py::split_plan); ws is
// f32 [B*C*H*S*(hd + 2)] when S > 1 (unused otherwise).  mma: 1 takes the
// tensor-core body (bf16 pools, C*G >= 16, ps a multiple of 16).  Returns
// the launches' cudaError_t (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
    const void* v_scale, const void* table, const void* qpos,
    const void* lengths, void* out, void* ws, int B, int C, int H, int KV, int hd,
    int ps, int pps, int garbage, int window, float scale, int dtype, int quant,
    int splits, int mma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, pool_k, pool_v, static_cast<const __half*>(k_scale),
               static_cast<const __half*>(v_scale), static_cast<const int*>(table),
               static_cast<const int*>(qpos), static_cast<const int*>(lengths), out,
               static_cast<float*>(ws), B, C, H, KV, ps, pps, garbage, window, splits, scale};
  if (mma && (dtype != 1 || quant || ps % 16)) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && quant) return (int)launch_hd<bf16, signed char>(a, hd, false, s);
  if (dtype == 1) return (int)launch_hd<bf16, bf16>(a, hd, mma != 0, s);
  if (quant) return (int)launch_hd<float, signed char>(a, hd, false, s);
  return (int)launch_hd<float, float>(a, hd, false, s);
}

// Low-rank boundary codec (paper eq. 8, 1-D form) for Hopper (sm_90a).
//
// Replaces repro/kernels/lowrank/kernel.py::encode_pallas, decode_pallas
// and roundtrip_pallas (_encode_kernel, _decode_kernel, _roundtrip_kernel):
//     encode     Z[T, r] = X[T, d] . E[d, r]
//     decode     X^[T, d] = Z[T, r] . D[r, d]
//     roundtrip  X -> Z -> X^ in one pass, plus sum (X - X^)^2
// and the int8 boundary folded into the codec (with the rules of
// repro/kernels/quant/kernel.py::quantize_rows_pallas and
// dequantize_rows_pallas, quant.cuh):
//     encode + quantize    (q, s) = quantize_rows(X . E), f16 row scales
//     dequantize + decode  X^ = T(f32(q) * f32(s)) . D
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
// The fused boundary forms (the streaming engine's int8 boundary: every
// end stage ran encode then quantize_rows, every cloud stage
// dequantize_rows then decode; at the stream's 4 to 32 rows each launch is
// ~2-3 us of latency for ~0.2 us of bytes, so only removing launches moves
// them).  Encode + quantize keeps the projection's walk and changes its
// epilogue: each value is rounded to the output type (the value the
// encode writes), the row's amax over the block's 64 columns comes from
// quad shuffles, and the row tile's column tiles (ceil(r / 64) <= 8) run as
// one thread-block cluster whose blocks push their partial maxima into
// each other's shared memory before one cluster barrier (quant.cuh); then
// quantize_rows' rules, each thread coding its own accumulators from the
// row's reciprocal where that is provably the quotient's code (quant.cuh's
// quant_fast; divides run as a dependent chain a thread: at 128 rows,
// shared out over the block through shared memory, they still took ~0.1
// us a code pair), codes two bytes a store, the scale from the cluster's
// rank 0: bit-equal to quantize_rows(lowrank_encode(x)).
// Dequantize + decode converts the codes into the A operand's swizzled
// tiles, the block's whole A once, up front (at the stream's rank <= 64
// KB; converting a K step at a time beside W's ring read 1.6-3.1 us slower
// a call, PERF.md): the codes arrive by TMA on their own mbarrier while
// W's first copies fly and the rows past T are zeroed, then the live rows'
// codes are spread over the block's threads and converted without the
// conversion unit (quant.cuh's codes4), fenced for wgmma: bit-equal to
// lowrank_decode(dequantize_rows(q, s)).
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

#include <cooperative_groups.h>

#include "quant.cuh"
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
// of kBK and writes its tile of y in x's type.  The fused boundary forms
// run the same walk: encode + quantize changes the epilogue, dequantize +
// decode the A operand's staging.

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kBM = 64;            // output rows per block
constexpr int kBN = 64;            // output columns per block
constexpr int kBK = 64;            // K per step
constexpr int kPThreads = 128;     // f32: 8 x 16 threads over the tile
constexpr int kMmaThreads = 128;   // bf16: one warpgroup
constexpr int kStages = 4;         // bf16 ring depth
static_assert(kStages >= 3, "a slot is refilled a barrier before it is read");
constexpr int kTile = 64 * 64;     // bf16 values of an X or W tile in the ring
constexpr int kLdT = kBM + 4;      // f32 smem row (float4 reads stay aligned)
constexpr int kMaxCluster = 8;     // the portable cluster size: column tiles of a fused encode
static_assert(kBM == 64 && kBN == 64 && kBK == 64, "tile rows are 64 values wide");
// the ring (+ slack to align it to 1024 B, as TMA's 128-byte swizzle wants)
constexpr size_t kMmaSmem = sizeof(bf16) * kStages * 2 * kTile + 1024;

// How the bf16 walk stages its A operand (X, or Z for the decode).
enum AForm {
  kATma,     // TMA from bf16 values (W by TMA too)
  kAScalar,  // scalar bf16 loads
  kACodes,   // int8 codes times their row's f16 scale, rounded to bf16
};

// Index of value (row, col) in a ring tile: rows of 64 values (128 B) whose
// 16-byte chunks are XOR-swizzled by row % 8, the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads.
__device__ __forceinline__ int swz(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

// Scalar stagings of K step [kk0, kk0 + kBK) into the swizzled layout,
// zeros past the edges (k or n not a multiple of 8, or an operand not
// 16-byte aligned).  The caller fences them for wgmma's reads.
__device__ __forceinline__ void stage_x_scalar(const bf16* __restrict__ x, bf16* xs, int r0,
                                               int kk0, int nt, int k) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < kTile; e += kMmaThreads) {
    const int row = e >> 6, col = e & 63;
    const int gr = r0 + row, gk = kk0 + col;
    xs[swz(row, col)] = gr < nt && gk < k ? x[(size_t)gr * k + gk] : zero;
  }
}
__device__ __forceinline__ void stage_w_scalar(const bf16* __restrict__ w, bf16* ws, int c0,
                                               int kk0, int k, int n) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < kTile; e += kMmaThreads) {
    const int row = e >> 6, col = e & 63;
    const int wk = kk0 + row, gc = c0 + col;
    ws[swz(row, col)] = wk < k && gc < n ? w[(size_t)wk * n + gc] : zero;
  }
}

// The decode's A operand: bf16(f32(code) * f32(scale of its row)), exactly
// what dequantize_rows writes, for every K step of the block at once (tile
// i at xs + i * kTile); rows past nt and columns past k zero.

// 16 codes of one row and its scale into two 16-byte chunks of a tile
__device__ __forceinline__ void codes_to_chunk(uint4 c, float s, bf16* dst0, bf16* dst1) {
  alignas(16) bf16 v[16];
  q8::dequant16(c, s, v);
  *reinterpret_cast<uint4*>(dst0) = reinterpret_cast<const uint4*>(v)[0];
  *reinterpret_cast<uint4*>(dst1) = reinterpret_cast<const uint4*>(v)[1];
}

// Rows [live, kBM) of every one of the ns tiles: zeros (they depend on no
// code, so they are written while the codes are in flight).
__device__ __forceinline__ void zero_dead_rows(bf16* xs, int live, int ns) {
  const int per_tile = (kBM - live) * (kBK / 8);  // 16-byte chunks
  for (int e = threadIdx.x; e < ns * per_tile; e += kMmaThreads) {
    const int i = e / per_tile, rem = e % per_tile;
    const int row = live + rem / (kBK / 8), col = (rem % (kBK / 8)) * 8;
    *reinterpret_cast<uint4*>(xs + i * kTile + swz(row, col)) = make_uint4(0, 0, 0, 0);
  }
}

// Rows [0, live) from the codes TMA staged in shared memory (cs: ns tiles
// of [kBM][kBK] int8, zeros past k) and their scales (ssc), the live rows'
// 16-code chunks spread over all the threads (at the stream's 4 rows, one
// chunk a thread).
__device__ __forceinline__ void convert_staged_codes(const signed char* cs, const float* ssc,
                                                     bf16* xs, int live, int ns) {
  const int per_row = ns * (kBK / 16);
  for (int e = threadIdx.x; e < live * per_row; e += kMmaThreads) {
    const int row = e / per_row, c = e % per_row;
    const int i = c / (kBK / 16), col = (c % (kBK / 16)) * 16;
    bf16* t = xs + i * kTile;
    codes_to_chunk(*reinterpret_cast<const uint4*>(cs + i * kBM * kBK + row * kBK + col),
                   ssc[row], t + swz(row, col), t + swz(row, col + 8));
  }
}

// from global memory, a code a load (k not a multiple of 16, or codes not
// 16-byte aligned)
__device__ __forceinline__ void stage_whole_a_scalar(const signed char* __restrict__ q,
                                                     const __half* __restrict__ scale, bf16* xs,
                                                     int r0, int nt, int k) {
  const bf16 zero = __float2bfloat16(0.f);
  const int ns = (k + kBK - 1) / kBK;
  for (int e = threadIdx.x; e < ns * kTile; e += kMmaThreads) {
    const int i = e / kTile, row = (e % kTile) >> 6, col = e & 63;
    const int gr = r0 + row, gk = i * kBK + col;
    xs[i * kTile + swz(row, col)] =
        gr < nt && gk < k ? q8::dequant<bf16>(q[(size_t)gr * k + gk], __half2float(scale[gr]))
                          : zero;
  }
}

// The bf16 walk of one 64 x 64 output tile: each K step is four wgmma of
// 64 x 64 x 16 reading A (K-major) and W (a row-major [k][n] tile, so
// MN-major) straight from shared memory in TMA's 128-byte swizzle.  W
// (kTmaW) comes through a kStages ring of TMA copies that complete on the
// slot's mbarrier, thread 0 issuing them (the hardware zero-fills past T, k
// and n); A with it (kATma) or staged by all threads into the same slot
// (kAScalar).  kACodes: A's every K step is converted once, up front, into
// its own tiles at xs, and only W is rung; with kTmaW the codes arrive by
// TMA too (mq, into cstage, on their own mbarrier full[kStages]) while W's
// first copies fly and the rows past T are zeroed.  One wgmma group stays in flight across each step's
// barrier.  d: the mma.sync C layout per n8 tile (tensor_core.cuh).
template <int kA, bool kTmaW>
__device__ __forceinline__ void mma_tile(const CUtensorMap* mx, const CUtensorMap* mw,
                                         const CUtensorMap* mq, const bf16* __restrict__ x,
                                         const signed char* __restrict__ codes,
                                         const __half* __restrict__ scale, signed char* cstage,
                                         const bf16* __restrict__ w, bf16* xs, bf16* ws,
                                         uint64_t* full, int r0, int c0, int nt, int k, int n,
                                         float (&d)[32]) {
  static_assert(kA != kATma || kTmaW, "A by TMA rides W's copies");
  constexpr bool kWholeA = kA == kACodes;
  // plain stores into a slot that other warps' wgmma read: a barrier after
  // the first fills, and a fence in each staging
  constexpr bool kGeneric = kA == kAScalar || !kTmaW;
  const int ns = (k + kBK - 1) / kBK;

  __shared__ float ssc[kWholeA ? kBM : 1];  // the codes' row scales
  const int live = min(kBM, nt - r0);        // rows of the tile below T
  if constexpr (kWholeA && kTmaW)
    if (threadIdx.x < live) ssc[threadIdx.x] = __half2float(scale[r0 + threadIdx.x]);
  if (kTmaW && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages + (kWholeA ? 1 : 0); ++i) tc::mbar_init(&full[i], 1);
    tc::fence_mbar_init();
  }
  __syncthreads();  // the barriers are initialised before any thread waits on one
  auto stage = [&](int i) {  // K step i of the block into slot i % kStages
    const int sl = i % kStages, kk0 = i * kBK;
    bf16* xt = xs + sl * kTile;
    bf16* wt = ws + sl * kTile;
    if constexpr (kTmaW) {
      if (threadIdx.x == 0) {
        tc::mbar_expect_tx(&full[sl], (kA == kATma ? 2 : 1) * kTile * sizeof(bf16));
        if constexpr (kA == kATma) tc::tma_load_2d(xt, mx, &full[sl], kk0, r0);
        tc::tma_load_2d(wt, mw, &full[sl], c0, kk0);
      }
    } else {
      stage_w_scalar(w, wt, c0, kk0, k, n);
    }
    if constexpr (kA == kAScalar) stage_x_scalar(x, xt, r0, kk0, nt, k);
    if constexpr (kGeneric) tc::fence_proxy_async();
  };
  auto prologue = [&] {
    for (int i = 0; i < kStages - 1 && i < ns; ++i) stage(i);
  };
  if constexpr (kWholeA) {
    if constexpr (kTmaW) {
      if (threadIdx.x == 0) {
        tc::mbar_expect_tx(&full[kStages], ns * kBM * kBK);
        for (int i = 0; i < ns; ++i)
          tc::tma_load_2d(cstage + i * kBM * kBK, mq, &full[kStages], i * kBK, r0);
      }
      prologue();
      zero_dead_rows(xs, live, ns);
      tc::mbar_wait(&full[kStages], 0);
      convert_staged_codes(cstage, ssc, xs, live, ns);
    } else {
      stage_whole_a_scalar(codes, scale, xs, r0, nt, k);
    }
    tc::fence_proxy_async();
    __syncthreads();
  }
  if constexpr (!(kWholeA && kTmaW)) prologue();
  // plain stores: every warp's wgmma reads the slots the other warps wrote
  if constexpr (kGeneric) __syncthreads();
#pragma unroll
  for (int j = 0; j < 32; ++j) d[j] = 0.f;
  for (int i = 0; i < ns; ++i) {
    const int sl = i % kStages;
    if constexpr (kTmaW) tc::mbar_wait(&full[sl], (i / kStages) & 1);  // step i has landed
    const uint64_t da = tc::wgmma_desc_sw128(xs + (kWholeA ? i : sl) * kTile);
    const uint64_t db = tc::wgmma_desc_sw128(ws + sl * kTile);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // 16 K: 32 B along an A row, 16 rows of W
      tc::wgmma_m64n64k16_bf16(d, da + (32 >> 4) * kk, db + (2048 >> 4) * kk);
    tc::wgmma_commit();
    tc::wgmma_wait<1>();  // step i - 1's products are done (step i's run on)
    __syncthreads();      // in every warp: its slot is free
    if (i + kStages - 1 < ns) stage(i + kStages - 1);
  }
  tc::wgmma_wait<0>();
}

// the rows (h = 0, 1) and first columns (j = 0..7) of thread 32w + 4g + t's
// accumulators in the wgmma layout: d[4j + 2h + e] at (16w + g + 8h, 8j + 2t + e)
__device__ __forceinline__ int mma_row(int h) {
  return (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int mma_col(int j) { return j * 8 + 2 * (threadIdx.x & 3); }

// y's tile in bf16; pairs: n a multiple of 8 (so col + 1 < n, and aligned)
__device__ __forceinline__ void store_tile(const float (&d)[32], bf16* __restrict__ y, int r0,
                                           int c0, int nt, int n, bool pairs) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + mma_row(h);
    if (row >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + mma_col(j);
      if (col >= n) continue;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * n + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        bf16* p = y + (size_t)row * n + col;
        p[0] = __float2bfloat16(v0);
        if (col + 1 < n) p[1] = __float2bfloat16(v1);
      }
    }
  }
}

// The fused encode's row maxima across the cluster: each block holds its
// tile's partial maxima m[i] of local rows row[i] (the writers own them;
// rows from `live` on are past T and not exchanged),
// the cluster's blocks are the row tile's column tiles, and every block
// leaves with the maxima over all of them (quant.cuh's exchange; the
// kernel arrived on the cluster barrier at its start).
template <int R>
__device__ __forceinline__ void cluster_row_amax(float (&m)[R], const int (&row)[R],
                                                 bool writer, int live) {
  __shared__ float part[kMaxCluster * kBM];
  cg::cluster_group cluster = cg::this_cluster();
  q8::cluster_wait();
  if (writer) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (row[i] < live) q8::push_partial<kBM>(part, row[i], m[i]);
  }
  cluster.sync();
  const int cs = (int)cluster.num_blocks();
#pragma unroll
  for (int i = 0; i < R; ++i) m[i] = q8::line_max<kBM>(part, row[i], cs);
}

// The fused encode's epilogue in bf16: each value rounded to bf16 (the
// value lowrank_encode writes), its row's amax over every column tile (the
// cluster), then quantize_rows' rules with an f16 scale, each thread coding
// its own accumulators from the row's reciprocal where that provably gives
// the quotient's code (quant.cuh's quant_fast: at 4 rows the live values
// sit in 16 threads, whose 16 divides would run as a dependent chain),
// codes two bytes a store (pairs), the scale stored by the cluster's rank
// 0.  Rows past nt store nothing.
__device__ __forceinline__ void quant_tile(const float (&d)[32], signed char* __restrict__ q,
                                           __half* __restrict__ scale, int r0, int c0, int nt,
                                           int n, bool pairs) {
  const int t = threadIdx.x & 3;
  float z[2][16], m[2];
  int row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = mma_row(h);
    m[h] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = __bfloat162float(__float2bfloat16(d[4 * j + 2 * h + e]));
        z[h][2 * j + e] = v;
        if (c0 + mma_col(j) + e < n) m[h] = fmaxf(m[h], fabsf(v));
      }
    // the row's four threads (t = 0..3) are neighbouring lanes
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
  // rows past nt have no partials to share
  cluster_row_amax(m, row, t == 0, nt - r0);
  const bool rank0 = cg::this_cluster().block_rank() == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = r0 + row[h];
    if (gr >= nt) continue;
    const __half s = q8::line_scale<__half>(m[h]);
    const float sf = __half2float(s), rf = q8::recip(sf);
    if (rank0 && t == 0) scale[gr] = s;
    signed char c[16];
    bool ok = true;
#pragma unroll
    for (int i = 0; i < 16; ++i) ok &= q8::quant_fast(z[h][i], rf, c[i]);
    if (!ok) {
#pragma unroll
      for (int i = 0; i < 16; ++i) c[i] = q8::quant(z[h][i], sf);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + mma_col(j);
      if (col >= n) continue;
      signed char* p = q + (size_t)gr * n + col;
      if (pairs) {
        *reinterpret_cast<char2*>(p) = make_char2(c[2 * j], c[2 * j + 1]);
      } else {
        p[0] = c[2 * j];
        if (col + 1 < n) p[1] = c[2 * j + 1];
      }
    }
  }
}

// the ring at the 1024-byte aligned start of dynamic shared memory
__device__ __forceinline__ bf16* ring_base(unsigned char* smem_raw) {
  return reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                 ~uintptr_t(1023));
}

// bf16 projection.  kTma: X and W by TMA, else scalar loads.
template <bool kTma>
__global__ void __launch_bounds__(kMmaThreads) project_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
    const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ y,
    int nt, int k, int n) {
  extern __shared__ unsigned char smem_raw[];
  bf16* xs = ring_base(smem_raw);  // [kStages][kTile]
  __shared__ uint64_t full[kStages];
  const int c0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;
  float d[32];
  mma_tile<kTma ? kATma : kAScalar, kTma>(&tmx, &tmw, nullptr, x, nullptr, nullptr, nullptr,
                                          w, xs, xs + kStages * kTile, full, r0, c0, nt, k, n,
                                          d);
  store_tile(d, y, r0, c0, nt, n, kTma);
}

// bf16 encode + boundary quantize: the projection's walk, then quant_tile.
// Launched as clusters of the row tile's gridDim.x column tiles.
template <bool kTma>
__global__ void __launch_bounds__(kMmaThreads) encode_quant_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
    const bf16* __restrict__ x, const bf16* __restrict__ w, signed char* __restrict__ q,
    __half* __restrict__ scale, int nt, int k, int n) {
  extern __shared__ unsigned char smem_raw[];
  bf16* xs = ring_base(smem_raw);
  __shared__ uint64_t full[kStages];
  q8::cluster_arrive();  // met in quant_tile
  const int c0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;
  float d[32];
  mma_tile<kTma ? kATma : kAScalar, kTma>(&tmx, &tmw, nullptr, x, nullptr, nullptr, nullptr,
                                          w, xs, xs + kStages * kTile, full, r0, c0, nt, k, n,
                                          d);
  quant_tile(d, q, scale, r0, c0, nt, n, kTma);
}

// boundary dequantize + decode in bf16: A from the codes and their f16 row
// scales, all of it up front; kTma: the codes (k a multiple of 16) and W by
// TMA, else scalar loads of both.  Dynamic shared memory: A's ns tiles,
// W's ring, then (kTma) the staged codes.
template <bool kTma>
__global__ void __launch_bounds__(kMmaThreads) decode_quant_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmw,
    const signed char* __restrict__ codes, const __half* __restrict__ scale,
    const bf16* __restrict__ w, bf16* __restrict__ y, int nt, int k, int n) {
  extern __shared__ unsigned char smem_raw[];
  bf16* xs = ring_base(smem_raw);
  __shared__ uint64_t full[kStages + 1];
  const int c0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;
  const int ns = (k + kBK - 1) / kBK;
  bf16* ws = xs + ns * kTile;
  float d[32];
  mma_tile<kACodes, kTma>(nullptr, &tmw, &tmq, nullptr, codes, scale,
                          reinterpret_cast<signed char*>(ws + kStages * kTile), w, xs, ws, full,
                          r0, c0, nt, k, n, d);
  store_tile(d, y, r0, c0, nt, n, kTma);
}

// f32, exact (CUDA-core FMAs, no TF32), on the same grid: X^T and W tiles
// in shared memory, thread (ty, tx) of 8 x 16 accumulates rows 8ty..8ty+7
// at columns tx + 16j.  kCodes: X is f32(code) * f32(its row's f16 scale),
// what dequantize_rows writes in f32.
template <bool kCodes>
__device__ __forceinline__ void f32_tile(const float* __restrict__ x,
                                         const signed char* __restrict__ codes,
                                         const __half* __restrict__ scale,
                                         const float* __restrict__ w, int r0, int c0, int nt,
                                         int k, int n, float (&acc)[8][4]) {
  __shared__ __align__(16) float xs[kBK * kLdT];  // X^T [kBK][kLdT]
  __shared__ __align__(16) float ws[kBK * kBN];   // [kBK][kBN]
  const int ns = (k + kBK - 1) / kBK;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int i = 0; i < ns; ++i) {
    const int kk0 = i * kBK;
    for (int e = threadIdx.x; e < kBM * kBK; e += kPThreads) {
      const int row = e >> 6, kk = e & 63;
      const int gr = r0 + row, gk = kk0 + kk;
      float v = 0.f;
      if (gr < nt && gk < k)
        v = kCodes ? q8::dequant<float>(codes[(size_t)gr * k + gk], __half2float(scale[gr]))
                   : x[(size_t)gr * k + gk];
      xs[kk * kLdT + row] = v;
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
}

__device__ __forceinline__ void store_f32_tile(const float (&acc)[8][4], float* __restrict__ y,
                                               int r0, int c0, int nt, int n) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
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

__global__ void __launch_bounds__(kPThreads) project_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ y,
    int nt, int k, int n) {
  float acc[8][4];
  const int c0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;
  f32_tile<false>(x, nullptr, nullptr, w, r0, c0, nt, k, n, acc);
  store_f32_tile(acc, y, r0, c0, nt, n);
}

// f32 encode + boundary quantize: Z is the f32 accumulator itself; a row's
// 16 threads (tx) are neighbouring lanes of one warp; the cluster as in
// the bf16 form.  A code a store (neighbouring tx, neighbouring bytes).
__global__ void __launch_bounds__(kPThreads) encode_quant_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, signed char* __restrict__ q,
    __half* __restrict__ scale, int nt, int k, int n) {
  q8::cluster_arrive();  // met in cluster_row_amax
  float acc[8][4];
  const int c0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;
  f32_tile<false>(x, nullptr, nullptr, w, r0, c0, nt, k, n, acc);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float m[8];
  int row[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    row[r] = ty * 8 + r;
    m[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + tx + 16 * j < n) m[r] = fmaxf(m[r], fabsf(acc[r][j]));
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
  }
  cluster_row_amax(m, row, tx == 0, nt - r0);
  const bool rank0 = cg::this_cluster().block_rank() == 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int gr = r0 + row[r];
    if (gr >= nt) break;
    const __half s = q8::line_scale<__half>(m[r]);
    const float sf = __half2float(s);
    if (rank0 && tx == 0) scale[gr] = s;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < n) q[(size_t)gr * n + col] = q8::quant(acc[r][j], sf);
    }
  }
}

__global__ void __launch_bounds__(kPThreads) decode_quant_f32_kernel(
    const signed char* __restrict__ codes, const __half* __restrict__ scale,
    const float* __restrict__ w, float* __restrict__ y, int nt, int k, int n) {
  float acc[8][4];
  const int c0 = blockIdx.x * kBN, r0 = blockIdx.y * kBM;
  f32_tile<true>(nullptr, codes, scale, w, r0, c0, nt, k, n, acc);
  store_f32_tile(acc, y, r0, c0, nt, n);
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

// A row-major [rows, cols] array as 64 x 64 boxes, zeros past its edges:
// bf16 128-byte swizzled (wgmma's operands), or int8 codes unswizzled.
bool tile_map(CUtensorMap* map, const void* base, int rows, int cols, bool codes = false) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (codes ? 1 : sizeof(bf16))};
  const cuuint32_t box[2] = {64, 64}, unit[2] = {1, 1};
  return encode(map, codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                codes ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// TMA wants 16-byte aligned bases and row strides: X [nt, k] and W [k, n]
bool tma_ok(const void* x, const void* w, int k, int n) {
  return k % 8 == 0 && n % 8 == 0 && aligned16(x) && aligned16(w);
}

dim3 tile_grid(int nt, int n) { return dim3((n + kBN - 1) / kBN, (nt + kBM - 1) / kBM); }

// a launch in clusters of `cluster` blocks along x (attr: its storage)
cudaLaunchConfig_t cluster_config(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr, int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t project(const float* x, const float* w, float* y, int nt, int k, int n,
                    cudaStream_t stream) {
  project_f32_kernel<<<tile_grid(nt, n), kPThreads, 0, stream>>>(x, w, y, nt, k, n);
  return cudaGetLastError();
}

cudaError_t project(const bf16* x, const bf16* w, bf16* y, int nt, int k, int n,
                    cudaStream_t stream) {
  const bool tma = tma_ok(x, w, k, n);
  CUtensorMap tmx{}, tmw{};
  if (tma && !(tile_map(&tmx, x, nt, k) && tile_map(&tmw, w, k, n))) return cudaErrorInvalidValue;
  auto kernel = tma ? project_wgmma_kernel<true> : project_wgmma_kernel<false>;
  cudaError_t err = allow_smem(kernel, kMmaSmem);
  if (err != cudaSuccess) return err;
  kernel<<<tile_grid(nt, n), kMmaThreads, kMmaSmem, stream>>>(tmx, tmw, x, w, y, nt, k, n);
  return cudaGetLastError();
}

cudaError_t encode_quant(const void* x, const void* w, signed char* q, __half* scale, int nt,
                         int k, int n, int dtype, cudaStream_t stream) {
  const int cluster = (n + kBN - 1) / kBN;
  if (cluster > kMaxCluster) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  if (dtype == 0) {
    const cudaLaunchConfig_t cfg =
        cluster_config(tile_grid(nt, n), kPThreads, 0, stream, &attr, cluster);
    return cudaLaunchKernelEx(&cfg, encode_quant_f32_kernel, static_cast<const float*>(x),
                              static_cast<const float*>(w), q, scale, nt, k, n);
  }
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const bool tma = tma_ok(x, w, k, n);
  CUtensorMap tmx{}, tmw{};
  if (tma && !(tile_map(&tmx, xb, nt, k) && tile_map(&tmw, wb, k, n)))
    return cudaErrorInvalidValue;
  auto kernel = tma ? encode_quant_wgmma_kernel<true> : encode_quant_wgmma_kernel<false>;
  const cudaError_t err = allow_smem(kernel, kMmaSmem);
  if (err != cudaSuccess) return err;
  const cudaLaunchConfig_t cfg =
      cluster_config(tile_grid(nt, n), kMmaThreads, kMmaSmem, stream, &attr, cluster);
  return cudaLaunchKernelEx(&cfg, kernel, tmx, tmw, xb, wb, q, scale, nt, k, n);
}

cudaError_t decode_quant(const void* codes, const __half* scale, const void* w, void* y,
                         int nt, int k, int n, int dtype, cudaStream_t stream) {
  const signed char* qc = static_cast<const signed char*>(codes);
  if (dtype == 0) {
    decode_quant_f32_kernel<<<tile_grid(nt, n), kPThreads, 0, stream>>>(
        qc, scale, static_cast<const float*>(w), static_cast<float*>(y), nt, k, n);
    return cudaGetLastError();
  }
  const bf16* wb = static_cast<const bf16*>(w);
  // TMA: 16-byte aligned bases and row strides (the codes' k bytes, W's n values)
  const bool tma = k % 16 == 0 && n % 8 == 0 && aligned16(codes) && aligned16(w);
  const int ns = (k + kBK - 1) / kBK;
  const size_t smem =
      sizeof(bf16) * (ns + kStages) * kTile + (tma ? (size_t)ns * kBM * kBK : 0) + 1024;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  CUtensorMap tmq{}, tmw{};
  if (tma && !(tile_map(&tmq, codes, nt, k, true) && tile_map(&tmw, wb, k, n)))
    return cudaErrorInvalidValue;
  auto kernel = tma ? decode_quant_wgmma_kernel<true> : decode_quant_wgmma_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<tile_grid(nt, n), kMmaThreads, smem, stream>>>(tmq, tmw, qc, scale, wb,
                                                          static_cast<bf16*>(y), nt, k, n);
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

// y[nt, n] = x[nt, k] . w[k, n] on 64 x 64 output tiles.  dtype: 0 =
// float32, 1 = bfloat16.  Returns the launch's cudaError_t (0 = launched).
extern "C" int lowrank_project_launch(const void* x, const void* w, void* y, int nt,
                                      int k, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)project(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                        static_cast<bf16*>(y), nt, k, n, s);
  return (int)project(static_cast<const float*>(x), static_cast<const float*>(w),
                      static_cast<float*>(y), nt, k, n, s);
}

// The boundary's encode and quantize in one launch: q [nt, n] int8 and
// scale [nt] float16 of Z = x [nt, k] . w [k, n] rounded to x's type, by
// quantize_rows' rules; n <= 512 (a cluster of at most 8 column tiles).
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int lowrank_encode_quant_launch(const void* x, const void* w, void* q, void* scale,
                                           int nt, int k, int n, int dtype, void* stream) {
  return (int)encode_quant(x, w, static_cast<signed char*>(q), static_cast<__half*>(scale),
                           nt, k, n, dtype, static_cast<cudaStream_t>(stream));
}

// How many clusters of the fused encode (dtype, `cluster` column tiles)
// the card runs at once (cudaOccupancyMaxActiveClusters); 0 or a negative
// cudaError_t if it runs none.
extern "C" int lowrank_encode_quant_clusters(int dtype, int cluster) {
  const void* fn = reinterpret_cast<const void*>(encode_quant_f32_kernel);
  size_t smem = 0;
  int threads = kPThreads;
  if (dtype == 1) {
    auto kernel = encode_quant_wgmma_kernel<true>;
    if (allow_smem(kernel, kMmaSmem) != cudaSuccess) return -1;
    fn = reinterpret_cast<const void*>(kernel);
    smem = kMmaSmem;
    threads = kMmaThreads;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(cluster, 1), threads, smem, nullptr, &attr,
                                                cluster);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// x^ [nt, n] = T(f32(q) * f32(scale)) [nt, k] . w [k, n] in one launch (q
// int8, scale float16 [nt], w and x^ of dtype 0 = float32, 1 = bfloat16).
// Returns the launch's cudaError_t.
extern "C" int lowrank_decode_quant_launch(const void* q, const void* scale, const void* w,
                                           void* y, int nt, int k, int n, int dtype,
                                           void* stream) {
  return (int)decode_quant(q, static_cast<const __half*>(scale), w, y, nt, k, n, dtype,
                           static_cast<cudaStream_t>(stream));
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

// Low-rank boundary codec (paper eq. 8, 1-D form) for Hopper (sm_90a).
//
// Replaces repro/kernels/lowrank/kernel.py::encode_pallas, decode_pallas
// and roundtrip_pallas (_encode_kernel, _decode_kernel, _roundtrip_kernel):
//     encode     Z[T, r] = X[T, d] . E[d, r]
//     decode     X^[T, d] = Z[T, r] . D[r, d]
//     roundtrip  X^ = T(T(X . E) . D) in one launch, plus sum (X - X^)^2
//                and its mean over X's elements (T: X's type)
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
// The roundtrip (the MoE dispatch codec: encode, decode and the error of
// eq. 8 in one launch, with the consumer's roundings: Z rounded to X's type
// between the products, the error over the rounded X^).  At serving decode
// it carries 8 rows, so one launch is latency: one pass over E and D (1.2
// MB, 0.36 us of bytes) where the composed pair spends two launches and the
// one-block-per-8-rows form it replaces spent ~0.45 ms on CUDA cores.  A
// 64-row tile is one thread-block cluster of its c = ceil(r / 64) <= 8
// column tiles, times a K split of 2 where the grid is small (`split`:
// each block reads half as much of E and D, which sets the pace at a few
// rows, where each SM takes in its tiles at a few tens of GB/s; 12 blocks
// at rank 384, a non-portable cluster past 8).  Phase 1: block j computes
// Z's column tile j (over its half of K, the pair then swapping f32
// partials) with the projection's wgmma walk fed by TMA, and rounds it to
// bf16 into its copy of the Z row tile (the swizzled layout wgmma's A
// operand reads); the bulk-copy engine sends that tile to the other blocks,
// completing on their mbarrier (no cluster-wide barrier between the
// phases: a block waits only for the tiles it needs; each block initialises
// its mbarriers before the cluster barrier's first phase and copies only
// after waiting on it).  Phase 2: each block computes its share of X^'s
// column tiles over K = r, A being the whole Z row tile in its own shared
// memory; it stores X^ and sums its rows' squared errors against X
// (re-read, L2-hot).  One 8-slot ring of TMA copies runs through both
// phases, so D's first tiles (which do not depend on Z) fly during phase 1
// and the exchanges.  The error's block sums meet in the cluster's rank 0
// (distributed shared memory, one cluster barrier) and are summed in rank
// order; past one row tile the last rank 0 to take a ticket sums the
// tiles' sums in order, so the bits do not depend on which block finishes
// last and there is no second launch.  The f32 form runs the same cluster
// (no split) on CUDA cores (the projection's f32 tiles, exact f32), Z kept
// in f32 and transposed for its A reads, pushed by plain stores before one
// cluster barrier.  Rows past T come in as zeros (TMA zero-fill) and add
// nothing.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "quant.cuh"
#include "tensor_core.cuh"

namespace {

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

// How the f32 walk gets its A operand.
enum F32A {
  kF32X,       // X's values
  kF32Codes,   // f32(code) * f32(its row's f16 scale), what dequantize_rows writes in f32
  kF32Staged,  // already in shared memory, transposed (the roundtrip's Z)
};

// f32, exact (CUDA-core FMAs, no TF32), on the same grid: X^T and W tiles
// in shared memory, thread (ty, tx) of 8 x 16 accumulates rows 8ty..8ty+7
// at columns tx + 16j.  kF32Staged: X^T is `as` ([k][kLdT], zeros past k),
// and only W is staged.
// The f32 walk's tiles, one pair a block whichever forms of it a kernel
// runs (a kernel's static shared memory stops at 48 KB).
__device__ __forceinline__ float* f32_xs() {  // X^T [kBK][kLdT]
  __shared__ __align__(16) float xs[kBK * kLdT];
  return xs;
}
__device__ __forceinline__ float* f32_ws() {  // [kBK][kBN]
  __shared__ __align__(16) float ws[kBK * kBN];
  return ws;
}

template <int kA>
__device__ __forceinline__ void f32_tile(const float* __restrict__ x,
                                         const signed char* __restrict__ codes,
                                         const __half* __restrict__ scale,
                                         const float* __restrict__ as,
                                         const float* __restrict__ w, int r0, int c0, int nt,
                                         int k, int n, float (&acc)[8][4]) {
  constexpr bool kStaged = kA == kF32Staged;
  float* xs_own = f32_xs();
  float* ws = f32_ws();
  const int ns = (k + kBK - 1) / kBK;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int i = 0; i < ns; ++i) {
    const int kk0 = i * kBK;
    const float* xs = kStaged ? as + (size_t)kk0 * kLdT : xs_own;
    if constexpr (!kStaged) {
      for (int e = threadIdx.x; e < kBM * kBK; e += kPThreads) {
        const int row = e >> 6, kk = e & 63;
        const int gr = r0 + row, gk = kk0 + kk;
        float v = 0.f;
        if (gr < nt && gk < k)
          v = kA == kF32Codes
                  ? q8::dequant<float>(codes[(size_t)gr * k + gk], __half2float(scale[gr]))
                  : x[(size_t)gr * k + gk];
        xs_own[kk * kLdT + row] = v;
      }
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
  f32_tile<kF32X>(x, nullptr, nullptr, nullptr, w, r0, c0, nt, k, n, acc);
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
  f32_tile<kF32X>(x, nullptr, nullptr, nullptr, w, r0, c0, nt, k, n, acc);
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
  f32_tile<kF32Codes>(nullptr, codes, scale, nullptr, w, r0, c0, nt, k, n, acc);
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

// ---------------------------------------------------------------------------
// The roundtrip X^ = T(T(X . E) . D) and sum (f32(X) - f32(X^))^2 over the
// rounded X^ (T: X's type).  Grid (c, row tiles), c = ceil(r / 64) column
// tiles of Z, launched as clusters of c blocks: one cluster a 64-row tile,
// block j (its cluster rank) owning Z's column tile j in phase 1 and X^'s
// column tiles [j * per, (j + 1) * per) in phase 2.

// X^'s column tiles of block j: [first, first + count)
struct Share {
  int first, count;
};
__device__ __forceinline__ Share xhat_share(int d) {
  const int nd = (d + kBN - 1) / kBN, per = (nd + gridDim.x - 1) / gridDim.x;
  const int first = blockIdx.x * per;
  return {first, max(0, min(nd, first + per) - first)};
}

// every peer's copy of the bytes [p, p + bytes) of this block's shared
// memory gets them (16-byte stores into distributed shared memory); the
// caller has waited for its peers to have started
__device__ __forceinline__ void push_to_peers(const void* p, int bytes, int threads) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  uint4* src = static_cast<uint4*>(const_cast<void*>(p));
  for (int o = 1; o < cs; ++o) {
    uint4* dst = cluster.map_shared_rank(src, (rank + o) % cs);
    for (int e = threadIdx.x; e < bytes / 16; e += threads) dst[e] = src[e];
  }
}

// the cluster barrier's arrive, ordering this thread's earlier writes (an
// mbarrier's initialisation, a partial pushed to a peer) before the
// peers' acquire of the same phase
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

constexpr int kRtMaxCluster = 16;  // the roundtrip's c column tiles times its K split

// shared::cluster address of p (this block's shared memory) in block `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(tc::smem_addr(p)),
               "r"(rank));
  return a;
}

// `bytes` of this block's shared memory at src to a peer's (dst), by the
// bulk-copy engine, completing on the peer's mbarrier (bar)
__device__ __forceinline__ void bulk_to_peer(const void* src, uint32_t dst, uint32_t bar,
                                             int bytes) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(tc::smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The error, closing the kernel: the block's sum of its threads' sq (a
// fixed order) goes into slot `rank` of its cluster's rank 0 (distributed
// shared memory); after a cluster barrier (every block waits on it, so
// none exits while a peer may still write into it, or read from it) rank
// 0 sums the slots in rank order.  One row tile: that is the sum.  More:
// each rank 0 writes its tile's sum into partial, and the last to take a
// ticket sums them in order and puts the ticket back to 0 for the next
// launch on the stream.  err[0] = the sum, err[1] = the sum / count (the
// mean).
__device__ __forceinline__ void cluster_error(float sq, float* __restrict__ partial,
                                              unsigned* __restrict__ ticket,
                                              float* __restrict__ err, float count) {
  __shared__ float red[32];
  __shared__ float slot[kRtMaxCluster];
  __shared__ bool last;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const float total = block_sum(sq, red);
  if (threadIdx.x == 0) cluster.map_shared_rank(slot, 0)[rank] = total;
  cluster_arrive_release();
  q8::cluster_wait();
  if (rank != 0) return;
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < cs; ++i) s += slot[i];
  if (gridDim.y == 1) {
    if (threadIdx.x == 0) {
      err[0] = s;
      err[1] = __fdiv_rn(s, count);
    }
    return;
  }
  if (threadIdx.x == 0) {
    partial[blockIdx.y] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float v = 0.f;
  for (unsigned i = threadIdx.x; i < gridDim.y; i += blockDim.x) v += __ldcg(partial + i);
  const float sum = block_sum(v, red);
  if (threadIdx.x == 0) {
    err[0] = sum;
    err[1] = __fdiv_rn(sum, count);
    *ticket = 0u;
  }
}

// The roundtrip's ring: kRtStages slots, each an X (or D) tile and an E
// tile, run through both phases: a block's steps [0, n1) are its phase 1
// K steps (X and E), the rest its phase 2 steps (D; A is the Z row tile),
// so D's first copies fly during phase 1 and the exchanges (D does not wait
// for Z).
constexpr int kRtStages = 8;
static_assert(kRtStages >= 3, "a slot is refilled a barrier before it is read");

// One K step's wgmma group: d += A . B, A a 64 x 64 K-major tile and B a
// 64 x 64 [k][n] tile, both in the 128-byte swizzle.
__device__ __forceinline__ void mma_step(float (&d)[32], const bf16* a, const bf16* b) {
  const uint64_t da = tc::wgmma_desc_sw128(a), db = tc::wgmma_desc_sw128(b);
  tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    tc::wgmma_m64n64k16_bf16(d, da + (32 >> 4) * kk, db + (2048 >> 4) * kk);
  tc::wgmma_commit();
}

// Steps [g0, g0 + n) of a ring of `total` steps (the caller issued
// load(0 .. kRtStages - 2)): step g waits for its slot (kTma: on
// full[g % kRtStages]) and issues mma(g, slot); where a load is left to
// issue, once step g - 1's group is done and every warp is past it, it
// refills that slot with load(g + kRtStages - 1).  Then the groups are
// drained.  Without TMA, load stages by plain stores and fences them.
// (The projection's walk, mma_tile, over a ring that runs on from one call
// into the next.)
template <bool kTma, class Load, class Mma>
__device__ __forceinline__ void ring_steps(int g0, int n, int total, uint64_t* full, Load load,
                                           Mma mma) {
  for (int g = g0; g < g0 + n; ++g) {
    const int sl = g % kRtStages;
    if constexpr (kTma) tc::mbar_wait(&full[sl], (g / kRtStages) & 1);
    mma(g, sl);
    tc::wgmma_wait<1>();  // step g - 1's products are done (step g's run on)
    if (g + kRtStages - 1 < total) {
      __syncthreads();  // in every warp: slot (g - 1) % kRtStages is free
      load(g + kRtStages - 1);
    }
  }
  tc::wgmma_wait<0>();
}

// the tensor map's descriptor fetched ahead of its first copy
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* m) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(m)) : "memory");
}


// X's values at this thread's accumulator places of an output tile (rows
// r0.., columns c0..), as pairs (n a multiple of 8, 16-byte aligned rows),
// 0 past T: loaded before the tile's products, so their latency hides
// under them.
__device__ __forceinline__ void load_x_pairs(const bf16* __restrict__ x, int r0, int c0, int nt,
                                             int n, __nv_bfloat162 (&xv)[2][8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + mma_row(h);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + mma_col(j);
      xv[h][j] = row < nt && col < n
                     ? *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * n + col)
                     : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
}

// X^'s tile (bf16, rounded once) stored, and the sum of its live rows'
// (f32(x) - f32(x^))^2; pairs: n a multiple of 8 and 16-byte aligned rows,
// X's values from xv (load_x_pairs), else read here one at a time.
__device__ __forceinline__ float store_rt_tile(const float (&d)[32],
                                               const __nv_bfloat162 (&xv)[2][8],
                                               const bf16* __restrict__ x, bf16* __restrict__ y,
                                               int r0, int c0, int nt, int n, bool pairs) {
  float sq = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + mma_row(h);
    if (row >= nt) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + mma_col(j);
      if (col >= n) continue;
      const __nv_bfloat162 v = __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      const size_t o = (size_t)row * n + col;
      float e0, e1 = 0.f;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(y + o) = v;
        e0 = __bfloat162float(xv[h][j].x) - __bfloat162float(v.x);
        e1 = __bfloat162float(xv[h][j].y) - __bfloat162float(v.y);
      } else {
        y[o] = v.x;
        e0 = __bfloat162float(x[o]) - __bfloat162float(v.x);
        if (col + 1 < n) {
          y[o + 1] = v.y;
          e1 = __bfloat162float(x[o + 1]) - __bfloat162float(v.y);
        }
      }
      sq = fmaf(e0, e0, sq);
      sq = fmaf(e1, e1, sq);
    }
  }
  return sq;
}

// The rows of X a phase 1 copy brings: T padded to 8, at most a tile's 64.
// The tile's other rows stay as they were in shared memory: each row of Z
// and X^ depends on its own row of X alone, and rows past T are never
// stored, so what they hold is never read back; a copy of 8 rows where
// the tile has 8 live ones moves an eighth of the bytes.
__host__ __device__ constexpr int x_box_rows(int nt) {
  return nt >= kBM ? kBM : (nt + 7) / 8 * 8;
}

// a block's wgmma accumulators (f32), warp by warp: warp w's 32 values a
// lane at [w][32][32], so the rows below T (warps 16 rows each) lead
constexpr int kPartial = 32 * kMmaThreads;
__device__ __forceinline__ int partial_index(int q) {
  return ((threadIdx.x >> 5) * 32 + q) * 32 + (threadIdx.x & 31);
}

// bf16: dynamic shared memory (1024-aligned): the ring, the row tile's Z
// (c tiles) and, with a K split, this block's f32 partial of its Z tile
// and its partner's.
size_t roundtrip_wgmma_smem(int c, int split) {
  return sizeof(bf16) * (2 * kRtStages + c) * kTile +
         (split > 1 ? 2 * sizeof(float) * kPartial : 0) + 1024;
}

// kTma: X, E and D by TMA (d and r multiples of 8, 16-byte aligned), else
// scalar loads into the same layouts.  Grid (c * split, row tiles),
// clusters of c * split: block b computes Z's column tile j = b % c over
// K part b / c of `split` (phase 1), then X^'s tiles [first, first +
// count) of the cluster's share (phase 2).  The exchanges go by the
// bulk-copy engine and carry the rows below T only (the rows past it stay
// unwritten in the receiver: each row of Z and X^ depends on its own row
// alone, and rows past T are never stored): with split 2 the two blocks of
// a column tile swap their f32 partials (completing on the partner's
// mbarrier pfull) and each adds the other's, a + b, the same bits in both;
// then each block rounds its Z tile to bf16 and sends it to the other
// c - 1 blocks of its K part (completing on their mbarrier zfull; the
// blocks of the other K part get it from its partner).  Each block
// initialises its mbarriers, and sets the bytes they expect, before the
// cluster barrier's first phase, which every block waits on before it
// copies.  The error's cluster barrier, arrived once a block's own tiles
// have landed, keeps every block alive until no copy from it can run.
template <bool kTma>
__global__ void __launch_bounds__(kMmaThreads) roundtrip_wgmma_kernel(
    const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tme,
    const __grid_constant__ CUtensorMap tmd, const bf16* __restrict__ x,
    const bf16* __restrict__ enc, const bf16* __restrict__ dec, bf16* __restrict__ xhat,
    float* __restrict__ partial, unsigned* __restrict__ ticket, float* __restrict__ err,
    int nt, int d, int r, int c, float count) {
  extern __shared__ unsigned char smem_raw[];
  bf16* ring = ring_base(smem_raw);         // [kRtStages][X or D tile, E tile]
  bf16* zs = ring + 2 * kRtStages * kTile;  // [c] Z tiles: the row tile's A operand
  float* pout = reinterpret_cast<float*>(zs + c * kTile);  // this block's partial (split 2)
  float* pin = pout + kPartial;                            // its partner's
  __shared__ uint64_t full[kRtStages], zfull, pfull;
  const int cs = gridDim.x, split = cs / c, b = blockIdx.x, j = b % c, kp = b / c;
  const int r0 = blockIdx.y * kBM, live = min(kBM, nt - r0);  // rows below T
  const int xrows = x_box_rows(nt);                           // of X a copy brings
  const int zbytes = live * kBK * sizeof(bf16);                // of a Z tile
  const int pbytes = (live + 15) / 16 * 32 * 32 * sizeof(float);  // of a partial: its warps
  const int ns1 = (d + kBK - 1) / kBK, per = (ns1 + split - 1) / split, k0 = kp * per;
  const int n1 = max(0, min(ns1, k0 + per) - k0);  // this block's phase 1 K steps
  const Share own = xhat_share(d);
  const int steps = n1 + own.count * c;  // phase 2: c K steps (Z's tiles) an X^ tile
  if (threadIdx.x == 0) {
    if constexpr (kTma) {
      prefetch_tensormap(&tmx);
      prefetch_tensormap(&tme);
      prefetch_tensormap(&tmd);
#pragma unroll
      for (int i = 0; i < kRtStages; ++i) tc::mbar_init(&full[i], 1);
    }
    tc::mbar_init(&zfull, 1);
    tc::mbar_init(&pfull, 1);
    tc::fence_mbar_init();
    tc::mbar_expect_tx(&zfull, (c - 1) * zbytes);         // the K part's other tiles
    tc::mbar_expect_tx(&pfull, split > 1 ? pbytes : 0);  // the partner's partial
  }
  __syncthreads();           // the barriers are initialised before any thread waits on one
  cluster_arrive_release();  // ... and before any peer copies into this block

  const CUtensorMap *mx = &tmx, *me = &tme, *md = &tmd;
  auto load = [&](int g) {
    const int sl = g % kRtStages;
    bf16* a = ring + sl * 2 * kTile;
    if (g < n1) {  // phase 1, K step k0 + g: X [r0.., 64(k0 + g)..] into a, E after it
      const int kk0 = (k0 + g) * kBK;
      if constexpr (kTma) {
        if (threadIdx.x == 0) {
          tc::mbar_expect_tx(&full[sl], (xrows * kBK + kTile) * sizeof(bf16));
          tc::tma_load_2d(a, mx, &full[sl], kk0, r0);
          tc::tma_load_2d(a + kTile, me, &full[sl], j * kBN, kk0);
        }
      } else {
        stage_x_scalar(x, a, r0, kk0, nt, d);
        stage_w_scalar(enc, a + kTile, j * kBN, kk0, d, r);
      }
    } else {  // phase 2: D [64 (K step).., 64 (X^ tile)..] into a
      const int c0 = (own.first + (g - n1) / c) * kBN, kk0 = ((g - n1) % c) * kBK;
      if constexpr (kTma) {
        if (threadIdx.x == 0) {
          tc::mbar_expect_tx(&full[sl], kTile * sizeof(bf16));
          tc::tma_load_2d(a, md, &full[sl], c0, kk0);
        }
      } else {
        stage_w_scalar(dec, a, c0, kk0, r, d);
      }
    }
    if constexpr (!kTma) tc::fence_proxy_async();
  };
  for (int g = 0; g < kRtStages - 1 && g < steps; ++g) load(g);
  if constexpr (!kTma) __syncthreads();  // plain stores: every warp reads the slots

  // phase 1: this block's part of Z's column tile j
  float acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.f;
  ring_steps<kTma>(0, n1, steps, full, load, [&](int, int sl) {
    mma_step(acc, ring + sl * 2 * kTile, ring + sl * 2 * kTile + kTile);
  });
  if (split > 1) {
#pragma unroll
    for (int q = 0; q < 32; ++q) pout[partial_index(q)] = acc[q];
    tc::fence_proxy_async();  // the partial, for the bulk copy out
    __syncthreads();
  }
  q8::cluster_wait();  // every peer has started and initialised its mbarriers
  if (split > 1) {
    if (threadIdx.x == 0) {
      const int partner = (b + c) % cs;
      bulk_to_peer(pout, peer_addr(pin, partner), peer_addr(&pfull, partner), pbytes);
    }
    tc::mbar_wait(&pfull, 0);
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] += pin[partial_index(q)];
  }
  bf16* zt = zs + j * kTile;  // Z's tile j, rounded to bf16
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 8; ++q)
      *reinterpret_cast<__nv_bfloat162*>(zt + swz(mma_row(h), mma_col(q))) =
          __floats2bfloat162_rn(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
  tc::fence_proxy_async();  // the tile, for wgmma here and the bulk copies out
  __syncthreads();          // the tile is whole before it is copied
  if (threadIdx.x == 0) {
    for (int o = 1; o < c; ++o) {
      const int peer = kp * c + (j + o) % c;
      bulk_to_peer(zt, peer_addr(zt, peer), peer_addr(&zfull, peer), zbytes);
    }
  }
  tc::mbar_wait(&zfull, 0);  // the other tiles have landed: the whole Z row tile

  // phase 2: X^'s tiles [first, first + count), each over Z's c tiles
  float sq = 0.f;
  for (int t = 0; t < own.count; ++t) {
    const int c0 = (own.first + t) * kBN;
    __nv_bfloat162 xv[2][8];
    if constexpr (kTma) load_x_pairs(x, r0, c0, nt, d, xv);
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] = 0.f;
    ring_steps<kTma>(n1 + t * c, c, steps, full, load, [&](int g, int sl) {
      mma_step(acc, zs + ((g - n1) % c) * kTile, ring + sl * 2 * kTile);
    });
    sq += store_rt_tile(acc, xv, x, xhat, r0, c0, nt, d, kTma);
  }
  // its cluster barrier: every block's tiles have landed, so no copy from
  // this block runs once it passes
  cluster_error(sq, partial, ticket, err, count);
}

// f32, exact, the same cluster on CUDA cores: Z's column tile j stays in
// f32 and is pushed transposed ([k][kLdT]: the rows of Z^T this block owns)
// into every block's Z^T (dynamic shared memory).
size_t roundtrip_f32_smem(int c) { return sizeof(float) * (size_t)c * kBK * kLdT; }

__global__ void __launch_bounds__(kPThreads) roundtrip_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ enc, const float* __restrict__ dec,
    float* __restrict__ xhat, float* __restrict__ partial, unsigned* __restrict__ ticket,
    float* __restrict__ err, int nt, int d, int r, float count) {
  extern __shared__ float4 zs4[];
  float* zt = reinterpret_cast<float*>(zs4);  // Z^T [c * kBK][kLdT]
  q8::cluster_arrive();  // met before the first push
  const int j = blockIdx.x, r0 = blockIdx.y * kBM;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[8][4];
  f32_tile<kF32X>(x, nullptr, nullptr, nullptr, enc, r0, j * kBN, nt, d, r, acc);
  float* mine = zt + (size_t)j * kBK * kLdT;
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(tx + 16 * e) * kLdT + ty * 8 + q] = acc[q][e];
  __syncthreads();     // the tile is whole before it is pushed
  q8::cluster_wait();  // every peer has started
  push_to_peers(mine, kBK * kLdT * sizeof(float), kPThreads);
  cg::this_cluster().sync();

  float sq = 0.f;
  const Share own = xhat_share(d);
  for (int t = own.first; t < own.first + own.count; ++t) {
    const int c0 = t * kBN;
    f32_tile<kF32Staged>(nullptr, nullptr, nullptr, zt, dec, r0, c0, nt, r, d, acc);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int row = r0 + ty * 8 + q;
      if (row >= nt) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + tx + 16 * e;
        if (col >= d) continue;
        const size_t o = (size_t)row * d + col;
        xhat[o] = acc[q][e];
        const float diff = x[o] - acc[q][e];
        sq = fmaf(diff, diff, sq);
      }
    }
  }
  cluster_error(sq, partial, ticket, err, count);
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

// A row-major [rows, cols] array as boxes of 64 columns by box_rows rows,
// zeros past its edges:
// bf16 128-byte swizzled (wgmma's operands), or int8 codes unswizzled.
bool tile_map(CUtensorMap* map, const void* base, int rows, int cols, bool codes = false,
              int box_rows = 64) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (codes ? 1 : sizeof(bf16))};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows}, unit[2] = {1, 1};
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

// The roundtrip's launch: its kernel, block size and dynamic shared memory
// for dtype (0 = float32, 1 = bfloat16), c column tiles and the K split
// (bf16 only); tma: the bf16 form's TMA loads.
struct RoundtripForm {
  const void* fn;
  int threads;
  size_t smem;
};
RoundtripForm roundtrip_form(int dtype, int c, int split, bool tma) {
  if (dtype == 0)
    return {reinterpret_cast<const void*>(roundtrip_f32_kernel), kPThreads, roundtrip_f32_smem(c)};
  return {tma ? reinterpret_cast<const void*>(roundtrip_wgmma_kernel<true>)
              : reinterpret_cast<const void*>(roundtrip_wgmma_kernel<false>),
          kMmaThreads, roundtrip_wgmma_smem(c, split)};
}

// the form's attributes: its dynamic shared memory, and clusters past the
// portable 8 blocks
cudaError_t roundtrip_attributes(const RoundtripForm& form, int cluster) {
  cudaError_t e = cudaFuncSetAttribute(form.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)form.smem);
  if (e == cudaSuccess && cluster > kMaxCluster)
    e = cudaFuncSetAttribute(form.fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

cudaError_t roundtrip(const void* x, const void* enc, const void* dec, void* xhat,
                      float* partial, unsigned* ticket, float* err, int nt, int d, int r,
                      int split, int dtype, cudaStream_t stream) {
  const int c = (r + kBN - 1) / kBN;
  if (c > kMaxCluster || split < 1 || split > 2 || (dtype == 0 && split != 1) ||
      c * split > kRtMaxCluster)
    return cudaErrorInvalidValue;
  // TMA: 16-byte aligned bases and row strides (X and D rows of d values,
  // E rows of r); the stores in pairs need X^ aligned as X is
  const bool tma = dtype == 1 && d % 8 == 0 && r % 8 == 0 && aligned16(x) && aligned16(enc) &&
                   aligned16(dec) && aligned16(xhat);
  const RoundtripForm form = roundtrip_form(dtype, c, split, tma);
  cudaError_t e = roundtrip_attributes(form, c * split);
  if (e != cudaSuccess) return e;
  const dim3 grid(c * split, (nt + kBM - 1) / kBM);
  const float count = (float)((double)nt * d);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(grid, form.threads, form.smem, stream, &attr, c * split);
  if (dtype == 0)
    return cudaLaunchKernelEx(&cfg, roundtrip_f32_kernel, static_cast<const float*>(x),
                              static_cast<const float*>(enc), static_cast<const float*>(dec),
                              static_cast<float*>(xhat), partial, ticket, err, nt, d, r, count);
  CUtensorMap tmx{}, tme{}, tmd{};
  if (tma && !(tile_map(&tmx, x, nt, d, false, x_box_rows(nt)) && tile_map(&tme, enc, d, r) &&
               tile_map(&tmd, dec, r, d)))
    return cudaErrorInvalidValue;
  auto kernel = tma ? roundtrip_wgmma_kernel<true> : roundtrip_wgmma_kernel<false>;
  return cudaLaunchKernelEx(&cfg, kernel, tmx, tme, tmd, static_cast<const bf16*>(x),
                            static_cast<const bf16*>(enc), static_cast<const bf16*>(dec),
                            static_cast<bf16*>(xhat), partial, ticket, err, nt, d, r, c, count);
}

// e, with the runtime's last-error state cleared when it is an error: a
// call the library refuses (an attribute, an occupancy query, a launch)
// must not come back as the error of its next launch, which reads that
// state (cudaGetLastError).
cudaError_t consumed(cudaError_t e) {
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

}  // namespace

// y[nt, n] = x[nt, k] . w[k, n] on 64 x 64 output tiles.  dtype: 0 =
// float32, 1 = bfloat16.  Returns the launch's cudaError_t (0 = launched).
extern "C" int lowrank_project_launch(const void* x, const void* w, void* y, int nt,
                                      int k, int n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)consumed(project(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                 static_cast<bf16*>(y), nt, k, n, s));
  return (int)consumed(project(static_cast<const float*>(x), static_cast<const float*>(w),
                               static_cast<float*>(y), nt, k, n, s));
}

// The boundary's encode and quantize in one launch: q [nt, n] int8 and
// scale [nt] float16 of Z = x [nt, k] . w [k, n] rounded to x's type, by
// quantize_rows' rules; n <= 512 (a cluster of at most 8 column tiles).
// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int lowrank_encode_quant_launch(const void* x, const void* w, void* q, void* scale,
                                           int nt, int k, int n, int dtype, void* stream) {
  return (int)consumed(encode_quant(x, w, static_cast<signed char*>(q),
                                    static_cast<__half*>(scale), nt, k, n, dtype,
                                    static_cast<cudaStream_t>(stream)));
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
    if (consumed(allow_smem(kernel, kMmaSmem)) != cudaSuccess) return -1;
    fn = reinterpret_cast<const void*>(kernel);
    smem = kMmaSmem;
    threads = kMmaThreads;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(cluster, 1), threads, smem, nullptr, &attr,
                                                cluster);
  int n = 0;
  const cudaError_t err = consumed(cudaOccupancyMaxActiveClusters(&n, fn, &cfg));
  return err == cudaSuccess ? n : -(int)err;
}

// x^ [nt, n] = T(f32(q) * f32(scale)) [nt, k] . w [k, n] in one launch (q
// int8, scale float16 [nt], w and x^ of dtype 0 = float32, 1 = bfloat16).
// Returns the launch's cudaError_t.
extern "C" int lowrank_decode_quant_launch(const void* q, const void* scale, const void* w,
                                           void* y, int nt, int k, int n, int dtype,
                                           void* stream) {
  return (int)consumed(decode_quant(q, static_cast<const __half*>(scale), w, y, nt, k, n, dtype,
                                    static_cast<cudaStream_t>(stream)));
}

// The roundtrip with the consumer's roundings in one launch: xhat [nt, d]
// = T(T(x [nt, d] . enc [d, r]) . dec [r, d]), T = x's type (dtype: 0 =
// float32, 1 = bfloat16), err[0] = sum (f32(x) - f32(xhat))^2 and err[1] =
// err[0] / (nt * d); r <= 512 (at most 8 column tiles); split 1 or 2 (bf16:
// phase 1's K over 2 blocks a column tile, c * split <= 16).  partial is f32
// [ceil(nt / 64)], ticket a u32 that is 0 (the launch leaves it 0) and used
// by no concurrent launch.  Returns the launch's cudaError_t.
extern "C" int lowrank_roundtrip_launch(const void* x, const void* enc, const void* dec,
                                        void* xhat, void* partial, void* ticket, void* err,
                                        int nt, int d, int r, int split, int dtype,
                                        void* stream) {
  return (int)consumed(roundtrip(x, enc, dec, xhat, static_cast<float*>(partial),
                                 static_cast<unsigned*>(ticket), static_cast<float*>(err), nt, d,
                                 r, split, dtype, static_cast<cudaStream_t>(stream)));
}

// How many clusters of c column tiles and K split `split` of the
// roundtrip in dtype the card runs at once (cudaOccupancyMaxActiveClusters);
// 0 or a negative cudaError_t if it runs none.
extern "C" int lowrank_roundtrip_clusters(int dtype, int c, int split) {
  const RoundtripForm form = roundtrip_form(dtype, c, split, true);
  cudaError_t err = consumed(roundtrip_attributes(form, c * split));
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(c * split, 1), form.threads, form.smem,
                                                nullptr, &attr, c * split);
  int n = 0;
  err = consumed(cudaOccupancyMaxActiveClusters(&n, form.fn, &cfg));
  return err == cudaSuccess ? n : -(int)err;
}

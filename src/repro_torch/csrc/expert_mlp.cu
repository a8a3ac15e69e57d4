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
// sum(group_sizes) come back 0, as ragged_dot leaves them, and no row past
// n is read).  Weights may be stored in a wider type than the rows (the
// slab store keeps the params' f32): each weight is rounded to the rows'
// type as it is read, which is ragged_dot(xs, w.astype(xs.dtype)) without a
// rounded copy of the store.  One group (zero_group, the resident path's
// garbage slot) reads no weights and writes zero rows: its slab is all
// zeros and act(0) = 0.
//
// Two paths, chosen on the host by kernels/expert_mlp/ops.py::ffn_plan
// from the row count n alone (so a row routed to the same expert gets the
// same bits through the grouped and the resident wrapper):
//
// (a) Weight streaming, for decode-sized calls and every f32 call.  What
// bounds it: bytes.  Top-1 decode over a few slots puts about one row on
// each routed expert, so every weight (2 bytes in bf16, 4 in the f32 slab
// store, 1 in the int8 one) is read for ~2 flops a row.  The grid is
// (splits of the hidden dimension, routed groups, Z): block (s, k, z) finds
// the k-th group with rows (unrouted experts and the zero group get no
// block), takes its row chunks z, z + Z, ... (Z = n / 8, at most 32), and
// walks the hidden tiles s, s + S, ... of 32 columns.  For each tile
// it computes h = act(x @ wi[:, tile]) [* (x @ wg[:, tile])] in f32 for up
// to kRows rows (128 threads: 4 lanes x 8 columns a weight row, 32 k
// slices, every weight loaded as 8 values -- one 16-byte load of bf16, two
// of f32, one 8-byte load of int8 codes -- and 8 loads (f32: 4) in flight
// before they are used; the slices summed by shuffles, then over the 4
// warps in shared memory in a fixed order), keeps h in shared memory, and
// multiplies it by the tile's 32 rows of wo (each thread 8 output columns
// of a slice of the tile's rows, the first loads issued before the
// reduction above; the slices summed in shared memory in slice order).
// Each weight of a routed group is read once per kRows rows.  The block's
// partial y [rows, d] goes to an f32 scratch [S, n, d] sized to the rows of
// the call, and a second launch sums the S partials of each row in split
// order (deterministic, no atomics), writes zero for the zero group's rows
// and the rows past the groups, and rounds once to the rows' type.  The
// hidden activation stays in f32 on chip.  Every block first reads the
// group sizes into shared memory at once: read one after another they
// would cost a memory latency each.
//
// (b) Tensor cores, for bf16 rows at prefill-sized calls (the one-shot
// pipeline's [4, 256] batch: n = 1024).  There 8 experts' 75 MB of bf16
// weights meet ~128 rows each, ~9.7 GFLOP in all: a grouped GEMM.  Two
// launches: H = act(X_e Wi_e) [* (X_e Wg_e)] written once as bf16 [n, f]
// (the rounding of the hidden activation ragged_dot and the plain version
// apply: each product rounded to bf16, then the activation, then the
// gate), and Y = H_e Wo_e.  Each block takes a 64-row tile of one group's
// run of rows (the grid's row-tile index is mapped to (group, tile) from
// the group sizes on the device; rows of the next group that a tile loads
// are computed but never stored) and a column tile; 4 warps of
// mma.m16n8k16 (bf16 in, f32 accumulate) over a 3-stage cp.async ring of
// k slices (32 deep for H, 64 for Y) in padded shared memory, fragments by ldmatrix.  A
// weight stored wider than bf16 (the f32 or int8 slab store) is loaded,
// converted (and dequantized) and stored into the same ring by the
// threads.  The second launch writes zero for the zero group's rows and
// the rows past the groups.  mma.sync over a cp.async ring rather than
// wgmma over TMA: the weight operand changes per group and per call, and
// TMA would need a tensor map encoded on the host per call, and cannot
// convert the f32 and int8 stores on the way in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Args {
  const void* xs;   // [n, d] in T, sorted by group
  const int* sizes;  // [G] rows of each group
  const int* ids;   // [G] slab row of each group, or null (group g reads slab g)
  const void* wi;   // [slabs, d, f] in W
  const void* wg;   // [slabs, d, f] in W, or null (no gate)
  const void* wo;   // [slabs, f, d] in W
  const float* wis;  // [slabs, f] column scales (int8 W only)
  const float* wgs;  // [slabs, f]
  const float* wos;  // [slabs, d]
  void* scratch;    // (a): f32 partial [splits, n, d]; (b): bf16 H [n, f]
  void* y;          // [n, d] in T
  int n, d, f, G, zero_group, splits, vec;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// f32 -> the rows' type -> f32
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// 0 = silu, 1 = gelu (tanh form, as jax.nn.gelu), 2 = relu
template <int ACT>
__device__ __forceinline__ float act(float x) {
  if (ACT == 0) return x / (1.f + expf(-x));
  if (ACT == 1) {
    // saturated where XLA's f32 tanh is exactly +-1 (|u| >= 7.9988117, as
    // models/layers.py's TANH_SATURATION): exactly relu(x) there
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    if (fabsf(u) >= 7.9988117f) return u > 0.f ? x : 0.f;
    return 0.5f * x * (1.f + tanhf(u));
  }
  return fmaxf(x, 0.f);
}

// 8 consecutive weights as loaded: one 16-byte load (bf16), two (f32) or
// one 8-byte load (int8 codes); with !vec (an unaligned operand or a width
// not a multiple of 8) 8 scalar loads, the `valid` first of them real.
template <typename W> struct Raw;
template <> struct Raw<bf16> { uint4 u; };
template <> struct Raw<float> { float4 a, b; };
template <> struct Raw<signed char> { uint2 u; };

template <typename W> __device__ __forceinline__ W zero();
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ signed char zero<signed char>() { return 0; }

template <typename W>
__device__ __forceinline__ void load_raw(Raw<W>& r, const W* p, int valid, bool vec) {
  if (valid >= 8 && vec) {
    if constexpr (std::is_same<W, bf16>::value) {
      r.u = *reinterpret_cast<const uint4*>(p);
    } else if constexpr (std::is_same<W, float>::value) {
      r.a = reinterpret_cast<const float4*>(p)[0];
      r.b = reinterpret_cast<const float4*>(p)[1];
    } else {
      r.u = *reinterpret_cast<const uint2*>(p);
    }
    return;
  }
  W* e = reinterpret_cast<W*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = i < valid ? p[i] : zero<W>();
}

// the 8 weights as the rows' type T sees them, in f32 (int8: the code
// times its column's scale, rounded to T)
template <typename T, typename W>
__device__ __forceinline__ void convert(float (&w)[8], const Raw<W>& r, const float* sc) {
  const W* e = reinterpret_cast<const W*>(&r);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (std::is_same<W, signed char>::value) w[i] = round_to<T>((float)e[i] * sc[i]);
    else if constexpr (std::is_same<T, W>::value) w[i] = to_f(e[i]);
    else w[i] = round_to<T>(to_f(e[i]));
  }
}

// The G group sizes into shared memory, read by the block's threads at
// once (one after another they would cost a memory latency each).
__device__ __forceinline__ void load_sizes(const Args& a, int* sizes_s) {
  for (int i = threadIdx.x; i < a.G; i += blockDim.x) sizes_s[i] = a.sizes[i];
  __syncthreads();
}

// k-th group with rows, skipping the zero group: (group, first row, rows)
// clipped to [0, n); false if there is none
__device__ __forceinline__ bool routed_group(const Args& a, const int* sizes_s, int k, int& g,
                                             int& start, int& rows) {
  int off = 0;
  for (int i = 0; i < a.G; ++i) {
    const int c = sizes_s[i];
    if (c > 0 && i != a.zero_group) {
      if (k == 0) {
        g = i;
        start = off;
        rows = max(0, min(c, a.n - off));
        return rows > 0;
      }
      --k;
    }
    off += c;
  }
  return false;
}

// ---------------------------------------------------------------------------
// (a) weight streaming

constexpr int kThreads = 128;             // 4 warps
constexpr int kTile = 32;                 // hidden columns a tile
constexpr int kLanesRow = kTile / 8;      // lanes a weight row of the tile (8 values each)
constexpr int kSlices = kThreads / kLanesRow;  // k slices of the first product
constexpr int kRed = kThreads / 32;       // warps summed in shared memory
constexpr int kRows = 4;                  // rows a chunk (a row's bits do not depend on it)

template <typename W>
__host__ __device__ constexpr int unroll() { return std::is_same<W, float>::value ? 4 : 8; }

template <typename T, typename W, int ACT, bool GATED>
__global__ void __launch_bounds__(kThreads, 4) expert_ffn_stream_kernel(const Args a) {
  constexpr int R = kRows;
  constexpr int U = unroll<W>();
  constexpr bool kQuant = std::is_same<W, signed char>::value;
  const int n = a.n, d = a.d, f = a.f, S = a.splits;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool vec = a.vec != 0;

  extern __shared__ __align__(16) float smem_f[];
  int* sizes_s = reinterpret_cast<int*>(smem_f);  // [G], then reused
  __shared__ int s_g, s_start, s_rows;
  load_sizes(a, sizes_s);
  if (tid == 0) {
    int g = -1, st = 0, rows = 0;
    const bool ok = routed_group(a, sizes_s, blockIdx.y, g, st, rows);
    s_g = ok ? g : -1;
    s_start = st;
    s_rows = rows;
  }
  __syncthreads();
  if (s_g < 0) return;  // the same for every thread of the block
  const int g = s_g, start = s_start, grows = s_rows;
  const size_t slab = a.ids != nullptr ? (size_t)a.ids[g] : (size_t)g;
  const W* wi = static_cast<const W*>(a.wi) + slab * d * f;
  const W* wg = GATED ? static_cast<const W*>(a.wg) + slab * d * f : nullptr;
  const W* wo = static_cast<const W*>(a.wo) + slab * f * d;
  const T* xs = static_cast<const T*>(a.xs);
  float* partial = static_cast<float*>(a.scratch);

  // phase 1: thread (k slice ks, 8 columns cg); phase 2: thread (slice js
  // of the tile's rows, 8 output columns cg2), J slices, over the d / 8
  // output column groups in passes of up to kThreads (one pass up to
  // d = 1024; past it one slice, the thread's groups tid, tid + kThreads, ...)
  const int cg = tid % kLanesRow, ks = tid / kLanesRow;
  const int ncg = (d + 7) / 8, ncgp = min(ncg, kThreads), passes = (ncg + ncgp - 1) / ncgp;
  const int js = tid / ncgp, J = kThreads / ncgp;
  float so[8];  // the pass's wo column scales (int8 W): kept across tiles when passes = 1
  const auto load_so = [&](int c2) {
#pragma unroll
    for (int c = 0; c < 8; ++c) so[c] = kQuant && c < d - c2 ? a.wos[slab * d + c2 + c] : 1.f;
  };
  load_so((tid % ncgp) * 8);

  float* x_s = smem_f;                           // [R][d]
  float* red = x_s + R * d;                      // [kRed][R][kTile]
  float* gred = red + kRed * R * kTile;          // same (GATED only)
  float* h_s = gred + (GATED ? kRed * R * kTile : 0);  // [R][kTile]
  float* ysum = h_s + R * kTile;                 // [R][d]
  float* yred = ysum + R * d;                    // [J - 1][R][d]

  for (int r0 = blockIdx.z * R; r0 < grows; r0 += gridDim.z * R) {
    const int nr = min(R, grows - r0);
    {  // the chunk's rows in f32, 8 values a load, every load issued first
      constexpr int kMaxLoads = 8;
      const int chunks = R * ncg;
      for (int e0 = tid; e0 < chunks; e0 += kThreads * kMaxLoads) {
        Raw<T> raw[kMaxLoads];
#pragma unroll
        for (int u = 0; u < kMaxLoads; ++u) {
          const int e = e0 + u * kThreads, r = e / ncg, k = (e - r * ncg) * 8;
          const bool ok = e < chunks && r < nr;
          load_raw(raw[u], xs + (size_t)(start + r0 + (ok ? r : 0)) * d + (ok ? k : 0),
                   ok ? min(8, d - k) : 0, vec);
        }
#pragma unroll
        for (int u = 0; u < kMaxLoads; ++u) {
          const int e = e0 + u * kThreads, r = e / ncg, k = (e - r * ncg) * 8;
          if (e >= chunks) break;
          const float one[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
          float v[8];
          convert<T>(v, raw[u], one);
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (k + c < d) x_s[r * d + k + c] = v[c];
        }
      }
      for (int e = tid; e < R * d; e += kThreads) ysum[e] = 0.f;
    }
    __syncthreads();

    for (int t = blockIdx.x; t * kTile < f; t += S) {
      const int f0 = t * kTile, nf = min(kTile, f - f0);
      const int col = f0 + cg * 8, validc = max(0, min(8, f - col));
      float si[8], sg[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        si[c] = kQuant && c < validc ? a.wis[slab * f + col + c] : 1.f;
        sg[c] = kQuant && GATED && c < validc ? a.wgs[slab * f + col + c] : 1.f;
      }
      float acc[R][8], gacc[R][8];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = gacc[r][c] = 0.f;
      for (int k0 = ks; k0 < d; k0 += kSlices * U) {
        Raw<W> rw[U], rg[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = k0 + u * kSlices;
          const int v = k < d ? validc : 0;
          load_raw(rw[u], wi + (size_t)(k < d ? k : 0) * f + col, v, vec);
          if (GATED) load_raw(rg[u], wg + (size_t)(k < d ? k : 0) * f + col, v, vec);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = k0 + u * kSlices;
          if (k >= d) break;
          float w[8], wgv[8];
          convert<T>(w, rw[u], si);
          if (GATED) convert<T>(wgv, rg[u], sg);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float xv = x_s[r * d + k];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              acc[r][c] = fmaf(xv, w[c], acc[r][c]);
              if (GATED) gacc[r][c] = fmaf(xv, wgv[c], gacc[r][c]);
            }
          }
        }
      }
      // the first batch of the tile's wo rows (the first pass's), in flight
      // across the reduction below
      Raw<W> rw2[U];
      {
        const int col2 = (tid % ncgp) * 8, valid2 = max(0, min(8, d - col2));
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = js + u * J;
          const bool ok = js < J && j < nf;
          load_raw(rw2[u], wo + (size_t)(f0 + (ok ? j : 0)) * d + col2, ok ? valid2 : 0, vec);
        }
      }
      // the warp's slices by shuffles, then the warps in order
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int off = kLanesRow; off < 32; off <<= 1) {
            acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], off);
            if (GATED) gacc[r][c] += __shfl_xor_sync(0xffffffffu, gacc[r][c], off);
          }
      if (lane < kLanesRow) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            red[(warp * R + r) * kTile + cg * 8 + c] = acc[r][c];
            if (GATED) gred[(warp * R + r) * kTile + cg * 8 + c] = gacc[r][c];
          }
      }
      __syncthreads();
      for (int e = tid; e < R * kTile; e += kThreads) {
        const int r = e / kTile, j = e - r * kTile;
        float hi = 0.f, hg = 0.f;
#pragma unroll
        for (int w = 0; w < kRed; ++w) {
          hi += red[(w * R + r) * kTile + j];
          if (GATED) hg += gred[(w * R + r) * kTile + j];
        }
        float h = act<ACT>(hi);
        if (GATED) h *= hg;
        h_s[e] = j < nf ? h : 0.f;
      }
      __syncthreads();

      // phase 2: y[:, cols] += h tile @ wo[f0:f0+nf, cols]
      for (int pass = 0; pass < passes; ++pass) {
        const int cg2 = pass * ncgp + tid % ncgp, col2 = cg2 * 8;
        const int valid2 = max(0, min(8, d - col2));
        const bool active2 = js < J && cg2 < ncg;
        if (passes > 1) load_so(col2);
        float yacc[R][8];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) yacc[r][c] = 0.f;
        if (active2) {
          for (int j0 = js; j0 < nf; j0 += J * U) {
            if (j0 != js || pass > 0) {
#pragma unroll
              for (int u = 0; u < U; ++u) {
                const int j = j0 + u * J;
                load_raw(rw2[u], wo + (size_t)(f0 + (j < nf ? j : 0)) * d + col2,
                         j < nf ? valid2 : 0, vec);
              }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int j = j0 + u * J;
              if (j >= nf) break;
              float w[8];
              convert<T>(w, rw2[u], so);
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float hv = h_s[r * kTile + j];
#pragma unroll
                for (int c = 0; c < 8; ++c) yacc[r][c] = fmaf(hv, w[c], yacc[r][c]);
              }
            }
          }
          if (js > 0) {
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int c = 0; c < 8; ++c)
                if (c < valid2) yred[((js - 1) * R + r) * d + col2 + c] = yacc[r][c];
          }
        }
        if (J > 1) __syncthreads();  // (J > 1 only in a single pass)
        if (active2 && js == 0) {  // the slices in order, into this chunk's sum
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              if (c >= valid2) continue;
              float v = yacc[r][c];
              for (int q = 1; q < J; ++q) v += yred[((q - 1) * R + r) * d + col2 + c];
              ysum[r * d + col2 + c] += v;
            }
        }
      }
      // (the next tile's first barrier orders these sums before any reuse)
    }
    __syncthreads();
    for (int e = tid; e < nr * d; e += kThreads)
      partial[((size_t)blockIdx.x * n + start + r0) * d + e] = ysum[e];
    __syncthreads();
  }
}

// y[row, c] = sum over splits of partial[split, row, c], in split order, a
// thread an element; rows of the zero group and rows past sum(group_sizes)
// are 0.  Templated on the weight type too, so that a profile tells the
// resident path's reduction (a wider store) from the dense one.
template <typename T, typename W>
__global__ void __launch_bounds__(256) expert_ffn_reduce_kernel(const Args a) {
  extern __shared__ int sizes_s[];
  load_sizes(a, sizes_s);
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)a.n * a.d) return;
  const int row = (int)(e / a.d);
  int off = 0;
  bool live = false;
  for (int i = 0; i < a.G; ++i) {
    const int c = sizes_s[i];
    if (row >= off && row < off + c) live = i != a.zero_group;
    off += c;
  }
  const float* partial = static_cast<const float*>(a.scratch) + e;
  const size_t stride = (size_t)a.n * a.d;
  float s = 0.f;
  if (live) {
    int t = 0;
    for (; t + 8 <= a.splits; t += 8) {  // eight loads in flight, summed in order
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = partial[(size_t)(t + u) * stride];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; t < a.splits; ++t) s += partial[(size_t)t * stride];
  }
  static_cast<T*>(a.y)[e] = from_f<T>(s);
}

// ---------------------------------------------------------------------------
// (b) tensor cores: bf16 rows

constexpr int kBM = 64;       // rows a tile
constexpr int kStages = 3;
constexpr int kWarpsM = 2, kWarpsN = 2;  // warps over a tile's rows and columns
constexpr int kMThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMT = kBM / (16 * kWarpsM);  // m16 tiles a warp
constexpr int kBK1 = 32;  // k a stage: H = X Wi (K = d)
constexpr int kBK2 = 64;  // ... Y = H Wo (K = f, four times longer)

// padded rows (16 bytes more): the 8 rows an ldmatrix reads in distinct banks
template <int W>
__host__ __device__ constexpr int padded() { return W + 8; }

// a stage: the A tile [kBM][BK] and NB B tiles [BK][BN], bf16
template <int BN, int NB, int BK>
constexpr size_t gemm_smem_bytes() {
  return sizeof(bf16) * (size_t)kStages * (kBM * padded<BK>() + NB * BK * padded<BN>());
}

// Row tile idx of the grid: (group, first row, rows, kind); kind 0 =
// compute, 1 = zero rows (the zero group's, or past the groups), 2 = none.
struct Tile {
  int g, row0, rows, kind;
};

__device__ __forceinline__ Tile find_tile(const Args& a, const int* sizes_s, int idx) {
  int start = 0;
  for (int g = 0; g < a.G; ++g) {
    const int c = sizes_s[g];
    const int ce = max(0, min(c, a.n - start));
    const int t = (ce + kBM - 1) / kBM;
    if (idx < t) return {g, start + idx * kBM, min(kBM, ce - idx * kBM), g == a.zero_group};
    idx -= t;
    start += c;
  }
  const int total = max(0, min(start, a.n));
  const int t = (a.n - total + kBM - 1) / kBM;
  if (idx < t) return {-1, total + idx * kBM, min(kBM, a.n - total - idx * kBM), 1};
  return {-1, 0, 0, 2};
}

// One k stage of the A tile (64 rows of bf16, `arows` real) and of the NB
// B tiles ([BK][BN] of W, columns from n0, rounded to bf16 -- int8 codes
// times their column's scale -- as they are stored).
template <typename W, int BN, int NB, int BK>
__device__ __forceinline__ void load_stage(bf16* a_s, bf16* b_s, const bf16* A, int lda,
                                           int arows, const W* const* B,
                                           const float* const* sc, int K, int N, int n0,
                                           int k0, bool vec) {
  for (int e = threadIdx.x; e < kBM * (BK / 8); e += kMThreads) {
    const int r = e / (BK / 8), kc = (e % (BK / 8)) * 8, k = k0 + kc;
    bf16* dst = a_s + r * padded<BK>() + kc;
    const bf16* src = A + (size_t)r * lda + k;
    const int valid = r < arows ? max(0, min(8, K - k)) : 0;
    if (vec) {
      tc::cp_async16(dst, valid ? src : A, valid ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = i < valid ? src[i] : __float2bfloat16(0.f);
    }
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    for (int e = threadIdx.x; e < BK * (BN / 8); e += kMThreads) {
      const int kr = e / (BN / 8), nc = (e % (BN / 8)) * 8;
      const int k = k0 + kr, col = n0 + nc;
      bf16* dst = b_s + (nb * BK + kr) * padded<BN>() + nc;
      const W* src = B[nb] + (size_t)k * N + col;
      const int valid = k < K ? max(0, min(8, N - col)) : 0;
      if constexpr (std::is_same<W, bf16>::value) {
        if (vec) {
          tc::cp_async16(dst, valid ? src : B[nb], valid ? 16 : 0);
          continue;
        }
      }
      Raw<W> raw;
      load_raw(raw, src, valid, vec);
      float s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = sc[nb] != nullptr && i < valid ? sc[nb][col + i] : 1.f;
      float w[8];
      convert<bf16>(w, raw, s);
      uint4 packed;
      uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i) pw[i] = tc::pack_bf16(w[2 * i], w[2 * i + 1]);
      *reinterpret_cast<uint4*>(dst) = packed;
    }
  }
}

// acc[nb][mt][nt] += A tile . B tile nb over K, for this warp's 32 x BN/2
// part of the 64 x BN output tile
template <typename W, int BN, int NB, int BK>
__device__ __forceinline__ void gemm_mainloop(float (&acc)[NB][kMT][BN / (8 * kWarpsN)][4],
                                              unsigned char* smem,
                                              const bf16* A, int lda, int arows,
                                              const W* const* B, const float* const* sc,
                                              int K, int N, int n0, bool vec) {
  constexpr int kStageA = kBM * padded<BK>(), kStageB = NB * BK * padded<BN>();
  bf16* a_ring = reinterpret_cast<bf16*>(smem);
  bf16* b_ring = a_ring + kStages * kStageA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < BN / (8 * kWarpsN); ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][mt][nt][e] = 0.f;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT)
      load_stage<W, BN, NB, BK>(a_ring + st * kStageA, b_ring + st * kStageB, A, lda, arows, B,
                                sc, K, N, n0, st * BK, vec);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    tc::cp_async_wait<kStages - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread, and stage kt - 1 is free
    const int pre = kt + kStages - 1;
    if (pre < KT)
      load_stage<W, BN, NB, BK>(a_ring + (pre % kStages) * kStageA,
                                b_ring + (pre % kStages) * kStageB, A, lda, arows, B, sc, K, N,
                                n0, pre * BK, vec);
    tc::cp_async_commit();
    const bf16* a_s = a_ring + (kt % kStages) * kStageA;
    const bf16* b_s = b_ring + (kt % kStages) * kStageB;
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        tc::ldmatrix_x4(af[mt], a_s + (wm * (kBM / kWarpsM) + mt * 16 + (lane & 15)) * padded<BK>() +
                                    k16 * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int np = 0; np < BN / (16 * kWarpsN); ++np) {
          uint32_t r[4];
          tc::ldmatrix_x4_trans(r, b_s + (nb * BK + k16 * 16 + (lane & 15)) * padded<BN>() +
                                       wn * (BN / kWarpsN) + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            tc::mma_bf16(acc[nb][mt][2 * np], af[mt], r[0], r[1]);
            tc::mma_bf16(acc[nb][mt][2 * np + 1], af[mt], r[2], r[3]);
          }
        }
    }
  }
  tc::cp_async_wait<0>();
}

template <typename W, int ACT, bool GATED>
__global__ void __launch_bounds__(kMThreads) expert_ffn_gemm1_kernel(const Args a) {
  constexpr int BN = GATED ? 64 : 128, NB = GATED ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Tile s_tile;
  int* sizes_s = reinterpret_cast<int*>(smem_raw);  // [G], before the ring is used
  load_sizes(a, sizes_s);
  if (threadIdx.x == 0) s_tile = find_tile(a, sizes_s, blockIdx.x);
  __syncthreads();
  const Tile tile = s_tile;
  const int n0 = blockIdx.y * BN;
  if (tile.kind != 0 || n0 >= a.f) return;  // H rows of zero tiles are never read
  const int d = a.d, f = a.f;
  const size_t slab = a.ids != nullptr ? (size_t)a.ids[tile.g] : (size_t)tile.g;
  const W* B[NB];
  const float* sc[NB];
  B[0] = static_cast<const W*>(a.wi) + slab * d * f;
  sc[0] = a.wis != nullptr ? a.wis + slab * f : nullptr;
  if constexpr (GATED) {
    B[1] = static_cast<const W*>(a.wg) + slab * d * f;
    sc[1] = a.wgs != nullptr ? a.wgs + slab * f : nullptr;
  }
  float acc[NB][kMT][BN / (8 * kWarpsN)][4];
  gemm_mainloop<W, BN, NB, kBK1>(acc, smem_raw, static_cast<const bf16*>(a.xs) + (size_t)tile.row0 * d, d,
                           tile.rows, B, sc, d, f, n0, a.vec != 0);

  // h = act(bf16(x.wi)) [* bf16(x.wg)], each step rounded to bf16 as the
  // plain version's bf16 products and activation are
  bf16* H = static_cast<bf16*>(a.scratch);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < BN / (8 * kWarpsN); ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wm * (kBM / kWarpsM) + mt * 16 + g8 + 8 * hf;
        const int col = n0 + wn * (BN / kWarpsN) + nt * 8 + 2 * t4;
        if (r >= tile.rows || col >= f) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float h = round_to<bf16>(act<ACT>(round_to<bf16>(acc[0][mt][nt][2 * hf + e])));
          if constexpr (GATED) h *= round_to<bf16>(acc[NB - 1][mt][nt][2 * hf + e]);
          v[e] = h;
        }
        *reinterpret_cast<__nv_bfloat162*>(H + (size_t)(tile.row0 + r) * f + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
}

template <typename W>
__global__ void __launch_bounds__(kMThreads) expert_ffn_gemm2_kernel(const Args a) {
  constexpr int BN = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Tile s_tile;
  int* sizes_s = reinterpret_cast<int*>(smem_raw);  // [G], before the ring is used
  load_sizes(a, sizes_s);
  if (threadIdx.x == 0) s_tile = find_tile(a, sizes_s, blockIdx.x);
  __syncthreads();
  const Tile tile = s_tile;
  const int n0 = blockIdx.y * BN;
  const int d = a.d, f = a.f;
  if (tile.kind == 2 || n0 >= d) return;
  bf16* y = static_cast<bf16*>(a.y);
  if (tile.kind == 1) {  // zero rows
    for (int e = threadIdx.x; e < tile.rows * BN; e += kMThreads) {
      const int r = e / BN, c = n0 + e % BN;
      if (c < d) y[(size_t)(tile.row0 + r) * d + c] = __float2bfloat16(0.f);
    }
    return;
  }
  const size_t slab = a.ids != nullptr ? (size_t)a.ids[tile.g] : (size_t)tile.g;
  const W* B[1] = {static_cast<const W*>(a.wo) + slab * f * d};
  const float* sc[1] = {a.wos != nullptr ? a.wos + slab * d : nullptr};
  float acc[1][kMT][BN / (8 * kWarpsN)][4];
  gemm_mainloop<W, BN, 1, kBK2>(acc, smem_raw, static_cast<const bf16*>(a.scratch) + (size_t)tile.row0 * f,
                          f, tile.rows, B, sc, f, d, n0, a.vec != 0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < BN / (8 * kWarpsN); ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wm * (kBM / kWarpsM) + mt * 16 + g8 + 8 * hf;
        const int col = n0 + wn * (BN / kWarpsN) + nt * 8 + 2 * t4;
        if (r >= tile.rows || col >= d) continue;
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(tile.row0 + r) * d + col) =
            __floats2bfloat162_rn(acc[0][mt][nt][2 * hf], acc[0][mt][nt][2 * hf + 1]);
      }
}

// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, typename W, int ACT, bool GATED>
cudaError_t launch_stream(const Args& a, cudaStream_t stream) {
  constexpr int R = kRows;
  const int J = kThreads / min((a.d + 7) / 8, kThreads);
  const size_t smem = max(sizeof(int) * a.G,  // the group sizes, before the rows
                          sizeof(float) * ((size_t)R * a.d * (2 + (J - 1)) +
                                           (GATED ? 2 : 1) * kRed * R * kTile + R * kTile));
  cudaError_t err = set_smem(expert_ffn_stream_kernel<T, W, ACT, GATED>, smem);
  if (err != cudaSuccess) return err;
  const int routed = a.G - (a.zero_group >= 0 ? 1 : 0);
  const int blocks_y = max(1, min(routed, a.n));  // at most n groups hold rows
  // a group's row chunks over up to 32 blocks (chunk z, z + Z, ...): each
  // chunk reads its split's weights once whichever block takes it, so more
  // blocks spread those reads instead of taking them in turn (a prefill
  // chunk's larger groups, f32 rows at the pipeline's n = 1024)
  const int blocks_z = max(1, min(32, a.n / 8));
  expert_ffn_stream_kernel<T, W, ACT, GATED>
      <<<dim3(a.splits, blocks_y, blocks_z), kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t total = (size_t)a.n * a.d;
  expert_ffn_reduce_kernel<T, W>
      <<<(unsigned)((total + 255) / 256), 256, sizeof(int) * a.G, stream>>>(a);
  return cudaGetLastError();
}

template <typename W, int ACT, bool GATED>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int BN1 = GATED ? 64 : 128, NB1 = GATED ? 2 : 1;
  const int row_tiles = (a.n + kBM - 1) / kBM + a.G + 1;  // bounds the groups' tiles
  const size_t smem1 = gemm_smem_bytes<BN1, NB1, kBK1>(), smem2 = gemm_smem_bytes<64, 1, kBK2>();
  cudaError_t err = set_smem(expert_ffn_gemm1_kernel<W, ACT, GATED>, smem1);
  if (err != cudaSuccess || (err = set_smem(expert_ffn_gemm2_kernel<W>, smem2)) != cudaSuccess)
    return err;
  expert_ffn_gemm1_kernel<W, ACT, GATED>
      <<<dim3(row_tiles, (a.f + BN1 - 1) / BN1), kMThreads, smem1, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  expert_ffn_gemm2_kernel<W><<<dim3(row_tiles, (a.d + 63) / 64), kMThreads, smem2, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch(const Args& a, int act, bool gated, bool mma, cudaStream_t stream) {
#define EXPERT_FFN_CASE(A)                                                          \
  if (act == A) {                                                                   \
    if constexpr (std::is_same<T, bf16>::value) {                                   \
      if (mma) return gated ? launch_mma<W, A, true>(a, stream)                     \
                            : launch_mma<W, A, false>(a, stream);                   \
    }                                                                               \
    return gated ? launch_stream<T, W, A, true>(a, stream)                          \
                 : launch_stream<T, W, A, false>(a, stream);                        \
  }
  EXPERT_FFN_CASE(0)
  EXPERT_FFN_CASE(1)
  EXPERT_FFN_CASE(2)
#undef EXPERT_FFN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// act: 0 = silu, 1 = gelu (tanh), 2 = relu.  wg may be null (no gate).
// dtype (rows and y): 0 = float32, 1 = bfloat16; wdtype (weights): 0 =
// float32, 1 = bfloat16, 2 = int8 codes with f32 column scales wis, wgs
// [slabs, f] and wos [slabs, d] (null otherwise); the pairs taken are
// (0, 0), (1, 1), (1, 0), (0, 2) and (1, 2).  ids [G] (null = identity)
// names the slab row group g reads; group zero_group (-1 = none) reads no
// weights and comes back 0.  path 0 = weight streaming (scratch: f32
// [splits, n, d]); path 1 = tensor cores, bf16 rows only (scratch: bf16
// [n, f]).  vec: 1 when d and f are multiples of 8 and every operand is
// 16-byte aligned (vector loads), else 0.  Returns the launches'
// cudaError_t (0 = launched; the streaming path's shared memory, ~8 R d
// floats, is refused past the card's 227 KB: d above ~6.9k).
extern "C" int expert_mlp_launch(const void* xs, const void* group_sizes, const void* ids,
                                 const void* wi, const void* wg, const void* wo,
                                 const void* wis, const void* wgs, const void* wos,
                                 void* scratch, void* y, int n, int d, int f, int G, int act,
                                 int dtype, int wdtype, int zero_group, int path, int splits,
                                 int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{xs, static_cast<const int*>(group_sizes), static_cast<const int*>(ids), wi, wg,
               wo, static_cast<const float*>(wis), static_cast<const float*>(wgs),
               static_cast<const float*>(wos), scratch, y, n, d, f, G, zero_group, splits, vec};
  if ((path == 1 && dtype != 1) || splits < 1)
    return (int)cudaErrorInvalidValue;
  const bool gated = wg != nullptr, mma = path == 1;
#define EXPERT_MLP_CASE(DT, WDT, T, W) \
  if (dtype == DT && wdtype == WDT) return (int)launch<T, W>(a, act, gated, mma, s);
  EXPERT_MLP_CASE(1, 1, bf16, bf16)
  EXPERT_MLP_CASE(1, 0, bf16, float)
  EXPERT_MLP_CASE(0, 0, float, float)
  EXPERT_MLP_CASE(1, 2, bf16, signed char)
  EXPERT_MLP_CASE(0, 2, float, signed char)
#undef EXPERT_MLP_CASE
  return (int)cudaErrorInvalidValue;
}

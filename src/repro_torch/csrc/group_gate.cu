// HL-GGN group gate (eq. 5-7) for Hopper (sm_90a).
//
// Replaces repro/kernels/group_gate/kernel.py::group_gate_pallas
// (_gate_kernel).  Per token x [d]: local logits l = x . w_local + b_local
// over E = K * Mk experts, masked experts set to -1e30, a softmax within
// each of the K groups of Mk (eq. 5); global logits g = x . w_global +
// b_global, groups whose experts are all masked set to -1e30, a softmax
// over groups (eq. 6); probs[e] = p_group[e / Mk] * p_local[e] (eq. 7).
// f32 throughout, expf (not __expf), as the reference's router math.
//
// What bounds it on the H100: latency.  The work is a skinny product
// [T, d] x [d, E + K] (E + K = 12 for switch-base, 20 for llama4-scout)
// and two segmented softmaxes: about 2 (E + K) flops for each 2-byte x
// element, so the bound is reading x (1.5 MB at T = 1024, 12 KB at T = 8),
// a few microseconds at most; what a launch costs at the serving shapes is
// the dependent chain from the first load to the last store.
//
// Design.  One block takes a tile of R tokens (the wrapper picks R from T:
// one token a block up to a few hundred tokens, so that T blocks run side
// by side, tiles of 4 and more at T = 1024).  d is split over the block's
// threads (one for every four elements, up to 512), not walked in order:
// thread t takes elements t, t + threads, ... (unrolled four deep),
// so a warp's loads of x and of each weight column touch neighbouring
// addresses (a thread owning a contiguous slice instead made every weight
// load of a warp touch 32 sectors: 8.4 us a call at T = 8).  It keeps the
// partial sums of all E + K columns for RB tokens in registers and loads
// each element's E + K weights once for the RB tokens, in the parameters'
// own layouts (w_local [K, d, Mk], w_global [d, K], no relayout per call):
// for switch-base's (K, Mk) = (4, 2) and llama4-scout's (4, 4) as one float2
// or float4 a group and one float4 of w_global, for other shapes one float
// at a time.  The partial sums meet in warp shuffles (a butterfly of fixed
// shape) and then in shared memory, summed over the warps in warp order, so
// two launches give the same bits; no atomics.  Then one warp per token
// computes the softmaxes, each lane one expert (and one group) with every
// max and sum taken in index order, and writes probs [T, E] and p_group
// [T, K] only.  The mask is the [E] bool vector as given (masked -> -1e30).
//
// The wide form (group_gate_wide_kernel: more than 16 experts or 8 groups,
// qwen3-moe's 128 experts in 16 groups at d 4096, E + K = 144 columns, too
// many partial sums for a thread's registers) takes a block for each
// (token, group): K blocks a token side by side, each reading its group's
// Mk columns and the K global ones (every block computes the same group
// softmax, so no block waits for another).  A warp's task is one of those
// two column sets over one of kWideSplits slices of d, the warp's 32 lanes
// reading 32 neighbouring floats of the set's weights per step (lane l:
// element i0 + l / W, column l % W for W = Mk or K, both powers of two up
// to 32), so every weight load is one 128-byte line.  The lanes of a
// column meet in a butterfly of fixed shape, the slices in shared memory
// summed in slice order (two launches give the same bits), then the
// softmaxes in the block's first threads, every max and sum in index
// order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kMaxWarps = 16;  // 512 threads a block for one token, 256 for tiles
constexpr int kMaxE = 16, kMaxK = 8;  // the generic form's bounds on E and K
// the wide form: E <= 256, K <= 32, Mk and K powers of two up to 32; a
// block of 512 threads a token, d in kWideSplits slices
constexpr int kWideMaxE = 256, kWideMaxK = 32, kWideSplits = 16, kWideThreads = 512;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// N neighbouring floats through the read-only cache, as one vector load
// where N allows (the wrapper checks the alignment)
template <int N>
__device__ __forceinline__ void ldg_floats(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = __ldg(p + j);
  }
}

// K_ > 0: K = K_ and Mk = MK_ at compile time (vector weight loads); K_ == 0:
// the generic form, E <= kMaxE and K <= kMaxK at run time.  RB: tokens whose
// sums a thread keeps in flight.  DEEP: the loop over d unrolled four deep
// (a thread with many elements), else not at all (short code: a launch that
// finds its instructions cold pays for every line of them).
template <typename T, int K_, int MK_, int RB, bool DEEP>
__global__ void __launch_bounds__(RB == 1 ? 32 * kMaxWarps : 256) group_gate_kernel(
    const T* __restrict__ x, const float* __restrict__ w_local,
    const float* __restrict__ b_local, const float* __restrict__ w_global,
    const float* __restrict__ b_global, const unsigned char* __restrict__ mask,
    float* __restrict__ probs, float* __restrict__ p_group, int n_tok, int d, int K,
    int Mk, int rows_per_block) {
  constexpr bool kExact = K_ > 0;
  constexpr int EM = kExact ? K_ * MK_ : kMaxE;  // local columns [0, EM)
  constexpr int KM = kExact ? K_ : kMaxK;        // global columns [EM, EM + KM)
  constexpr int NC = EM + KM;
  __shared__ float part[kMaxWarps][RB][NC];
  __shared__ float logit[RB][NC];
  __shared__ float bias[NC];      // b_local, then b_global
  __shared__ bool allowed[EM];    // the mask (true where none is given)
  __shared__ bool alive[KM];      // a group with an allowed expert
  const int mk = kExact ? MK_ : Mk;
  const int E = K * mk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  // the biases and the mask first, so that their loads overlap the product's
  // (the first barrier below publishes them)
  if (threadIdx.x < NC) {
    const int c = threadIdx.x;
    bias[c] = c < EM ? (c < E ? b_local[c] : 0.f) : (c - EM < K ? b_global[c - EM] : 0.f);
    if (c < EM) allowed[c] = mask == nullptr || (c < E && mask[c] != 0);
    if (c < KM) {
      bool any = mask == nullptr && c < K;
      for (int m = 0; mask != nullptr && c < K && m < mk; ++m) any |= mask[c * mk + m] != 0;
      alive[c] = any;
    }
  }
  // the generic form: column e of w_local [K, d, Mk] sits at
  // (e / Mk) * d * Mk + e % Mk, then strides Mk over d
  int base[kExact ? 1 : EM];
  if constexpr (!kExact) {
#pragma unroll
    for (int e = 0; e < EM; ++e) base[e] = e < E ? (e / Mk) * d * Mk + e % Mk : 0;
  }

  const int row_begin = (int)blockIdx.x * rows_per_block;
  const int row_end = min(n_tok, row_begin + rows_per_block);
  for (int r0 = row_begin; r0 < row_end; r0 += RB) {
    float acc[RB][NC];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    auto accumulate = [&](int i) {  // element i of every token in flight
      float xv[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        xv[r] = r0 + r < row_end ? to_f(x[(size_t)(r0 + r) * d + i]) : 0.f;
      float w[NC];
      if constexpr (kExact) {
#pragma unroll
        for (int k = 0; k < K_; ++k)
          ldg_floats<MK_>(w_local + ((size_t)k * d + i) * MK_, w + k * MK_);
        ldg_floats<K_>(w_global + (size_t)i * K_, w + EM);
      } else {
#pragma unroll
        for (int e = 0; e < EM; ++e) w[e] = e < E ? __ldg(w_local + base[e] + i * Mk) : 0.f;
#pragma unroll
        for (int k = 0; k < KM; ++k) w[EM + k] = k < K ? __ldg(w_global + i * K + k) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(xv[r], w[c], acc[r][c]);
    };
    if constexpr (DEEP) {
#pragma unroll 4
      for (int i = threadIdx.x; i < d; i += blockDim.x) accumulate(i);
    } else {
#pragma unroll 1
      for (int i = threadIdx.x; i < d; i += blockDim.x) accumulate(i);
    }
    // the block's partial sums: a butterfly within each warp, then the
    // warps in order
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float v = acc[r][c];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) part[warp][r][c] = v;
      }
    __syncthreads();
    for (int j = threadIdx.x; j < RB * NC; j += blockDim.x) {
      const int r = j / NC, c = j % NC;
      float s = 0.f;
      for (int w = 0; w < n_warps; ++w) s += part[w][r][c];
      logit[r][c] = s;
    }
    __syncthreads();

    // eq. 5-7, one warp a token: lane e is expert e (e < E) and group e
    // (e < K); every max and sum in index order, the loads side by side
    for (int r = warp; r < RB; r += n_warps) {
      const int row = r0 + r;
      if (row >= row_end) break;
      const float* L = logit[r];
      // eq. 6: the group softmax, every lane over all K groups
      float g[KM];
      float gmax = -3.0e38f;
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        g[k] = k < K ? (alive[k] ? L[EM + k] + bias[EM + k] : kNegInf) : 0.f;
        if (k < K) gmax = fmaxf(gmax, g[k]);
      }
      // this lane's group (lane < K) and its expert's group (lane < E),
      // picked with compile-time indices so g stays in registers
      const int k = lane < E ? lane / mk : 0;
      float gsum = 0.f, g_lane = 0.f, g_mine = 0.f;
#pragma unroll
      for (int kk = 0; kk < KM; ++kk) {
        if (kk < K) gsum += expf(g[kk] - gmax);
        if (kk == lane) g_lane = g[kk];
        if (kk == k) g_mine = g[kk];
      }
      if (lane < K) p_group[(size_t)row * K + lane] = expf(g_lane - gmax) / gsum;
      if (lane < E) {
        // eq. 5: the softmax within this expert's group
        constexpr int MB = kExact ? MK_ : kMaxE;
        float l[MB];
        float lmax = -3.0e38f, mine = 0.f;
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const int e = k * mk + m;
          l[m] = m < mk ? (allowed[e] ? L[e] + bias[e] : kNegInf) : 0.f;
          if (m < mk) lmax = fmaxf(lmax, l[m]);
          if (e == lane) mine = l[m];
        }
        float lsum = 0.f;
#pragma unroll
        for (int m = 0; m < MB; ++m)
          if (m < mk) lsum += expf(l[m] - lmax);
        const float pg = expf(g_mine - gmax) / gsum;
        probs[(size_t)row * E + lane] = pg * (expf(mine - lmax) / lsum);  // eq. 7
      }
    }
    __syncthreads();  // the next tile reuses part and logit
  }
}

// block (row, g): token row's group g (see the file's head); x [T, d],
// w_local [K, d, Mk], w_global [d, K]
template <typename T>
__global__ void __launch_bounds__(kWideThreads) group_gate_wide_kernel(
    const T* __restrict__ x, const float* __restrict__ w_local,
    const float* __restrict__ b_local, const float* __restrict__ w_global,
    const float* __restrict__ b_global, const unsigned char* __restrict__ mask,
    float* __restrict__ probs, float* __restrict__ p_group, int d, int K, int Mk) {
  __shared__ float part[kWideSplits][kWideMaxK + 32];  // the K global, then g's Mk
  __shared__ float logit[kWideMaxK + 32];
  __shared__ bool alive[kWideMaxK];
  const int row = blockIdx.x, g = blockIdx.y;
  const T* xr = x + (size_t)row * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int chunk = (d + kWideSplits - 1) / kWideSplits;
  // task (c, s): column set c (0: the K global columns, 1: group g's Mk)
  // over slice s of d
  for (int task = warp; task < 2 * kWideSplits; task += n_warps) {
    const int c = task / kWideSplits, s = task % kWideSplits;
    const int W = c == 0 ? K : Mk;  // the task's columns, neighbours in memory
    const float* w = c == 0 ? w_global : w_local + (size_t)g * d * Mk;
    const int col = lane % W, step = 32 / W;
    const int i1 = min(d, (s + 1) * chunk);
    float acc = 0.f;
#pragma unroll 4
    for (int i = s * chunk + lane / W; i < i1; i += step)
      acc = fmaf(to_f(xr[i]), __ldg(w + (size_t)i * W + col), acc);
    for (int o = W; o < 32; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane < W) part[s][(c == 0 ? 0 : K) + col] = acc;
  }
  if (threadIdx.x < K) {  // a group whose experts are all masked is dead
    bool any = mask == nullptr;
    for (int m = 0; mask != nullptr && m < Mk; ++m) any |= mask[threadIdx.x * Mk + m] != 0;
    alive[threadIdx.x] = any;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < K + Mk; c += blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < kWideSplits; ++s) v += part[s][c];
    if (c < K) {
      logit[c] = alive[c] ? v + b_global[c] : kNegInf;
    } else {
      const int e = g * Mk + c - K;
      logit[c] = mask == nullptr || mask[e] != 0 ? v + b_local[e] : kNegInf;
    }
  }
  __syncthreads();
  // eq. 5-7: thread m of the first Mk is expert g·Mk + m; every block
  // computes the same group softmax (eq. 6), block 0 writes it
  if (threadIdx.x < Mk || (g == 0 && threadIdx.x < K)) {
    float gmax = -3.0e38f, gsum = 0.f;
    for (int k = 0; k < K; ++k) gmax = fmaxf(gmax, logit[k]);
    for (int k = 0; k < K; ++k) gsum += expf(logit[k] - gmax);
    if (g == 0 && threadIdx.x < K)
      p_group[(size_t)row * K + threadIdx.x] = expf(logit[threadIdx.x] - gmax) / gsum;
    if (threadIdx.x < Mk) {
      const float* L = logit + K;
      float lmax = -3.0e38f, lsum = 0.f;
      for (int m = 0; m < Mk; ++m) lmax = fmaxf(lmax, L[m]);
      for (int m = 0; m < Mk; ++m) lsum += expf(L[m] - lmax);
      const float pg = expf(logit[g] - gmax) / gsum;
      probs[(size_t)row * K * Mk + g * Mk + threadIdx.x] =
          pg * (expf(L[threadIdx.x] - lmax) / lsum);  // eq. 7
    }
  }
}

template <typename T, int K_, int MK_>
cudaError_t launch(const void* x, const float* wl, const float* bl, const float* wg,
                   const float* bg, const unsigned char* mask, float* probs, float* pg,
                   int n_tok, int d, int K, int Mk, int rows_per_block, int threads, int deep,
                   cudaStream_t stream) {
  const int blocks = (n_tok + rows_per_block - 1) / rows_per_block;
  const T* xt = static_cast<const T*>(x);
#define GATE(RB, DEEP)                                                          \
  group_gate_kernel<T, K_, MK_, RB, DEEP><<<blocks, threads, 0, stream>>>(     \
      xt, wl, bl, wg, bg, mask, probs, pg, n_tok, d, K, Mk, rows_per_block)
  if (rows_per_block == 1) {
    if (deep) GATE(1, true);
    else GATE(1, false);
  } else {
    if (deep) GATE(4, true);
    else GATE(4, false);
  }
#undef GATE
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_form(int form, const void* x, const float* wl, const float* bl,
                        const float* wg, const float* bg, const unsigned char* mask,
                        float* probs, float* pg, int n_tok, int d, int K, int Mk,
                        int rows_per_block, int threads, int deep, cudaStream_t stream) {
  if (form == 1)
    return launch<T, 4, 2>(x, wl, bl, wg, bg, mask, probs, pg, n_tok, d, K, Mk,
                           rows_per_block, threads, deep, stream);
  if (form == 2)
    return launch<T, 4, 4>(x, wl, bl, wg, bg, mask, probs, pg, n_tok, d, K, Mk,
                           rows_per_block, threads, deep, stream);
  if (form == 3) {
    group_gate_wide_kernel<T><<<dim3(n_tok, K), kWideThreads, 0, stream>>>(
        static_cast<const T*>(x), wl, bl, wg, bg, mask, probs, pg, d, K, Mk);
    return cudaGetLastError();
  }
  return launch<T, 0, 0>(x, wl, bl, wg, bg, mask, probs, pg, n_tok, d, K, Mk, rows_per_block,
                         threads, deep, stream);
}

}  // namespace

// x [T, d] (xdtype 0 = float32, 1 = bfloat16), w_local [K, d, Mk],
// b_local [K, Mk], w_global [d, K], b_global [K] (float32), mask [E] bool
// or null -> probs [T, E], p_group [T, K] (float32).  form: 1 for (K, Mk) =
// (4, 2), 2 for (4, 4) (w_local and w_global 16-byte aligned), 0 for any
// E = K * Mk <= 16 and K <= 8, 3 (the wide form: rows_per_block 1, 512
// threads) for E <= 256 and K <= 32 with Mk and K powers of two.
// rows_per_block: 1, or a multiple of 4.  threads: a multiple of 32, up to
// 512 with rows_per_block 1 and 256 otherwise.  deep: unroll the loop over
// d four deep.  Returns the launch's cudaError_t.
extern "C" int group_gate_launch(const void* x, const void* w_local, const void* b_local,
                                 const void* w_global, const void* b_global,
                                 const void* mask, void* probs, void* p_group, int n_tok,
                                 int d, int K, int Mk, int xdtype, int form,
                                 int rows_per_block, int threads, int deep, void* stream) {
  const bool pow2 = K > 0 && Mk > 0 && (K & (K - 1)) == 0 && (Mk & (Mk - 1)) == 0;
  if (form == 3 && (K * Mk > kWideMaxE || K > kWideMaxK || Mk > 32 || !pow2 ||
                    rows_per_block != 1 || threads != kWideThreads))
    return (int)cudaErrorInvalidValue;
  if (form != 3 && (K * Mk > kMaxE || K > kMaxK)) return (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > 32 * kMaxWarps ||
      threads % 32 || (rows_per_block != 1 && (rows_per_block % 4 || threads > 256)) ||
      (form == 1 && (K != 4 || Mk != 2)) || (form == 2 && (K != 4 || Mk != 4)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wl = static_cast<const float*>(w_local);
  const float* bl = static_cast<const float*>(b_local);
  const float* wg = static_cast<const float*>(w_global);
  const float* bg = static_cast<const float*>(b_global);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  float* pr = static_cast<float*>(probs);
  float* pg = static_cast<float*>(p_group);
  if (xdtype == 0)
    return (int)launch_form<float>(form, x, wl, bl, wg, bg, m, pr, pg, n_tok, d, K, Mk,
                                   rows_per_block, threads, deep, s);
  if (xdtype == 1)
    return (int)launch_form<__nv_bfloat16>(form, x, wl, bl, wg, bg, m, pr, pg, n_tok, d, K,
                                           Mk, rows_per_block, threads, deep, s);
  return (int)cudaErrorInvalidValue;
}

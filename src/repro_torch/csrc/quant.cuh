// The int8 line quantizer's rules, shared by quant.cu (the standalone
// quantizer and the KV pools' write) and lowrank.cu (the codec's fused
// boundary forms), so the codes of every path come from one definition:
//     s = S(max(amax / 127, 1e-8))          rounded to the scale's type S
//     q = clip(rint(x / f32(s)), -127, 127)  NaN -> 0
// IEEE divides (__fdiv_rn, never a reciprocal); rint rounds half to even as
// jnp.round does.  With an f16 scale the floor itself rounds to 0, so a
// line whose amax is below ~3.8e-6 stores scale 0: x / 0 = +-inf clips to
// +-127 and 0 / 0 = NaN becomes code 0, as the reference's convert gives.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace q8 {

constexpr float kFloor = 1e-8f;

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

// 1 / s within 2 ulp (rcp.approx: one instruction, where the correctly
// rounded reciprocal takes a refinement and a branch); +inf for s = 0
__device__ __forceinline__ float recip(float s) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(s));
  return r;
}

// quant(x, s) without the divide, from r = recip(s): y = x * r is within
// 1.5 * 2^-22 |y| (2 ulp of r, half an ulp of the product, half an ulp of
// the quotient) of the rounded quotient quant() takes rint of, so unless
// y lies within 1e-6 |y| (2.8x that) of a half-integer, where rint could
// round the quotient the other way, c = quant(x, s).  Returns false there,
// and for any non-finite y (s = 0, NaN x): the caller then takes quant()
// for its group, so a group of values runs as straight-line code and a
// rare branch.
__device__ __forceinline__ bool quant_fast(float x, float r, signed char& c) {
  const float y = __fmul_rn(x, r);
  c = (signed char)(int)fminf(fmaxf(rintf(y), -127.f), 127.f);
  return fabsf(y - (floorf(y) + 0.5f)) > 1e-6f * fabsf(y);
}

// T(f32(q) * f32(s)): one rounding of the product, never folded into an FMA
template <typename T>
__device__ __forceinline__ T dequant(signed char q, float s) {
  return from_f<T>(__fmul_rn((float)q, s));
}

// The four codes packed in w as exact floats f32(q) without the
// conversion unit (a quarter-rate I2F a code): each code offset by 128 is
// the low byte of the float 2^23 + 128 + q, from which 2^23 + 128 is
// subtracted exactly.
__device__ __forceinline__ void codes4(unsigned w, float* f) {
  const unsigned u = w ^ 0x80808080u;  // q + 128 in each byte
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j)), 8388736.f);
}

// 16 codes (a 16-byte load) times their line's scale s, in T
template <typename T>
__device__ __forceinline__ void dequant16(uint4 c, float s, T* out) {
  const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float f[4];
    codes4(w[k], f);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[4 * k + j] = from_f<T>(__fmul_rn(f[j], s));
  }
}

// Partial line maxima met across a thread-block cluster (the fused encode's
// column tiles of a row, the column quantizer's slices of the reduced
// axis).  Each block holds a table part[cluster size][L] in shared memory.
// Every thread arrives on the cluster barrier at the kernel's start
// (cluster_arrive); when its partials are ready it waits (every peer has
// started, so its shared memory may be written), the owner of each line
// pushes its partial into every block's table (push_partial: remote
// stores, nothing waits on a reply), and the cluster barrier (sync) makes
// them visible: each block then reads the cluster's maxima from its own
// table (line_max).  No block reads a peer's memory, so none waits for
// its peers before it exits.  Max is exact in any order.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int L>
__device__ __forceinline__ void push_partial(float* part, int line, float m) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  for (int r = 0; r < cs; ++r) cluster.map_shared_rank(part, r)[rank * L + line] = m;
}

template <int L>
__device__ __forceinline__ float line_max(const float* part, int line, int cs) {
  float m = 0.f;
  for (int r = 0; r < cs; ++r) m = fmaxf(m, part[r * L + line]);
  return m;
}

}  // namespace q8

// Device functions shared by the kernels: the fake quantizers of
// adalog_tpu/ops/fq_attn.py (_uq, _adalog_unit, _exp2_neg_int) and the warp
// reductions for the attention kernels (fq_flash_attn.cu,
// fq_attn_matmul.cu); the division by a shared divisor also for the GEMM
// kernel (fq_gemm.cu).
//
// Numerics follow the JAX kernels: rintf for every round (half to even),
// IEEE division and no FMA contraction inside the quantizers (the _rn
// intrinsics), 2^-floor(prod/37) assembled from exponent bits.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace fq {

constexpr float ADALOG_R = 37.0f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// uniform fake quant; zr is the already-rounded zero point
__device__ __forceinline__ float uq(float x, float s, float zr, float qmax) {
  float c = fminf(fmaxf(rintf(__fdiv_rn(x, s)) + zr, 0.0f), qmax);
  return __fmul_rn(c - zr, s);
}

// 2^-f for small non-negative integer-valued f, from the exponent bits
__device__ __forceinline__ float exp2_neg_int(float f) {
  return __int_as_float((127 - static_cast<int>(f)) << 23);
}

// a / b rounded to nearest even, the IEEE quotient, from y = __frcp_rn(b),
// the correctly rounded reciprocal, for a divisor shared by many dividends:
// q = RN(a * y) lies within an ulp of a / b, one FMA gives the remainder
// r = a - q * b to a rounding of its last bit, and RN(q + r * y) is the
// correctly rounded quotient (Markstein's correction; a CPU test holds it
// against exact rational arithmetic on the operands the kernels meet). For
// finite a and normal b, quotient and remainder; 0 / b is 0. div_rn_by_any also takes an infinite or overflowing a, whose
// remainder is NaN: the first quotient stands.
__device__ __forceinline__ float div_rn_by(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
}

__device__ __forceinline__ float div_rn_by_any(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  const float r = __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
  return fabsf(q) <= 3.4028234e38f ? r : q;
}

// The AdaLog quantizer at scale 1 in two halves. First half: the code of a
// probability x in [0, 1], before any clamp (codes >= 2N dequantize to 0).
__device__ __forceinline__ float adalog_code(float x, float q) {
  return rintf(__fdiv_rn(__fmul_rn(-log2f(fmaxf(x, 1e-15f)), ADALOG_R), q));
}

// Second half: a code in 0..2N-1 dequantizes to 2^-shift * (steps * ts) with
// prod = code * q, shift = floor(prod / 37) and steps = rint(2^(-(prod mod
// 37) / 37) / ts), an integer of at most 4N - 2. The value depends on the
// code alone, so a slice's 2N values fit a table.
__device__ __forceinline__ float adalog_pow2(float prod) {
  return exp2_neg_int(floorf(__fdiv_rn(prod, ADALOG_R)));
}

__device__ __forceinline__ float adalog_steps(float prod, float ts) {
  float frac = fmodf(prod, ADALOG_R);
  return rintf(__fdiv_rn(exp2f(__fdiv_rn(-frac, ADALOG_R)), ts));
}

__device__ __forceinline__ float adalog_value(float code, float q, float ts) {
  float prod = __fmul_rn(code, q);
  return __fmul_rn(adalog_pow2(prod), __fmul_rn(adalog_steps(prod, ts), ts));
}

// the value without its factor ts: steps * 2^-shift, exact in bf16 while
// 4N - 2 < 256
__device__ __forceinline__ float adalog_value_steps(float code, float q,
                                                    float ts) {
  float prod = __fmul_rn(code, q);
  return __fmul_rn(adalog_pow2(prod), adalog_steps(prod, ts));
}

// AdaLog fake quant at scale 1 of a probability x in [0, 1]
__device__ __forceinline__ float adalog_unit(float x, float q, float n2,
                                             float ts) {
  float code = adalog_code(x, q);
  float keep = code < n2 ? 1.0f : 0.0f;
  code = fminf(fmaxf(code, 0.0f), n2 - 1.0f);
  return __fmul_rn(adalog_value(code, q, ts), keep);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float qmax_of(int bits) {
  return static_cast<float>(2 * (1 << (bits - 1)) - 1);
}

}  // namespace fq

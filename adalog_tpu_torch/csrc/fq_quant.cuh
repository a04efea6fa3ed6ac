// Device functions shared by the attention kernels (fq_flash_attn.cu,
// fq_attn_matmul.cu): the fake quantizers of adalog_tpu/ops/fq_attn.py
// (_uq, _adalog_unit, _exp2_neg_int) and the warp reductions.
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

// AdaLog fake quant at scale 1 of a probability x in [0, 1]
__device__ __forceinline__ float adalog_unit(float x, float q, float n2,
                                             float ts) {
  float code = rintf(__fdiv_rn(__fmul_rn(-log2f(fmaxf(x, 1e-15f)), ADALOG_R), q));
  float keep = code < n2 ? 1.0f : 0.0f;
  code = fminf(fmaxf(code, 0.0f), n2 - 1.0f);
  float prod = __fmul_rn(code, q);
  float frac = fmodf(prod, ADALOG_R);
  float mant = __fmul_rn(rintf(__fdiv_rn(exp2f(__fdiv_rn(-frac, ADALOG_R)), ts)), ts);
  return __fmul_rn(__fmul_rn(exp2_neg_int(floorf(__fdiv_rn(prod, ADALOG_R))), mant),
                   keep);
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

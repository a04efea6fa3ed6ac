// Building blocks of the tensor-core ("mma") variants of the attention
// kernels (fq_flash_attn.cu, fq_attn_matmul.cu): mma.sync m16n8k16 on bf16
// operands with fp32 accumulators, ldmatrix reads of a [k][n] operand, the
// staging of one slice's uniform-quantized operand into shared memory, and
// the per-slice AdaLog code table with the per-probability arithmetic that
// reads it.
//
// Layouts (PTX ISA, mma.m16n8k16 with .bf16): with gq = lane / 4 and t4 =
// lane % 4, a thread's accumulators c[0..1] are row gq, columns 2 t4 + {0, 1}
// of the 16 x 8 tile and c[2..3] the same of row gq + 8. The A operand's
// a[0] is row gq, columns 2 t4 + {0, 1}; a[1] row gq + 8, the same columns;
// a[2], a[3] the same rows at columns 8 + 2 t4 + {0, 1}: two neighbouring
// accumulator tiles, packed to bf16, are one A operand with no shuffle.

#pragma once

#include "fq_quant.cuh"

namespace fq {

constexpr int MAX_CODES = 256;       // AdaLog codes of a slice: bits <= 8

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo: low 16 bits
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two B operands (k16 x n8 each, columns n0..n0+7 and n0+8..n0+15) of a
// [k][n] bf16 matrix in shared memory. Lane l gives the address of row
// k0 + (l & 15), column n0 + 8 * (l >> 4); b[0..1] is the first operand,
// b[2..3] the second.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* b, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The staged operand of one element: the integer c - z (exact in bf16) for
// fp32 inputs, the dequantized value (rounded to bf16 by the store) for
// bf16 inputs. A uniform quantizer of one slice as the staging needs it: zr
// is the already-rounded zero point, inv_s the rounded reciprocal of s (the
// division by s is the IEEE quotient, div_rn_by_any).
struct Uniform {
  float s, inv_s, zr, qmax;
};

// params is (P, 2) [scale, zero point]; g the row.
__device__ __forceinline__ Uniform uniform_of(const float* params, int g,
                                              int bits) {
  const float s = params[2 * g];
  return {s, __frcp_rn(s), rintf(params[2 * g + 1]), qmax_of(bits)};
}

template <bool kInt>
__device__ __forceinline__ float staged_f32(float x, const Uniform& u) {
  const float c = fminf(
      fmaxf(rintf(div_rn_by_any(x, u.s, u.inv_s)) + u.zr, 0.0f), u.qmax);
  return kInt ? c - u.zr : __fmul_rn(c - u.zr, u.s);
}

template <bool kInt>
__device__ __forceinline__ __nv_bfloat16 staged(float x, const Uniform& u) {
  return __float2bfloat16_rn(staged_f32<kInt>(x, u));
}

// The floats of one 16-byte load of T.
__device__ __forceinline__ void unpack16(const uint4& w, float (&x)[4], float) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack16(const uint4& w, float (&x)[8],
                                         __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Stage ``count`` contiguous elements of device memory, whole rows of
// ``cols`` elements from row 0 on, into the [row][ld] bf16 matrix dst
// (zero-filled before: the pads are not touched). Global-load latency is
// what staging costs, so every thread has LOADS loads in flight before it
// uses the first: of 16 bytes where the run is aligned (a slice of the zoo's
// shapes always is), else of one element.
template <bool kInt, int LOADS, typename T>
__device__ __forceinline__ void stage_rows_body(__nv_bfloat16* dst, int ld,
                                                const T* __restrict__ src,
                                                int count, int cols,
                                                const Uniform& uq, int tid,
                                                int nthreads) {
  constexpr int VEC = 16 / sizeof(T);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && count % VEC == 0) {
    const uint4* src16 = reinterpret_cast<const uint4*>(src);
    const int n = count / VEC;
    for (int j0 = tid; j0 < n; j0 += LOADS * nthreads) {
      uint4 raw[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u)      // past the end: the last one again
        raw[u] = __ldg(src16 + min(j0 + u * nthreads, n - 1));
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = (j0 + u * nthreads) * VEC;
        if (i < count) {
          float x[VEC];
          unpack16(raw[u], x, T());
          int r = i / cols, c = i - r * cols;
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            dst[r * ld + c] = staged<kInt>(x[k], uq);
            if (++c == cols) {
              c = 0;
              ++r;
            }
          }
        }
      }
    }
  } else {
    for (int i0 = tid; i0 < count; i0 += LOADS * nthreads) {
      float x[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        x[u] = to_f32(src[min(i0 + u * nthreads, count - 1)]);
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * nthreads;
        if (i < count) {
          const int r = i / cols;
          dst[r * ld + i - r * cols] = staged<kInt>(x[u], uq);
        }
      }
    }
  }
}

// With the row length LD of dst known to the compiler. Not inlined: the
// loads' registers stay out of the caller's tile loop's allocation.
template <bool kInt, int LD, int LOADS, typename T>
__device__ __noinline__ void stage_rows(__nv_bfloat16* dst,
                                        const T* __restrict__ src, int count,
                                        int cols, Uniform uq, int tid,
                                        int nthreads) {
  stage_rows_body<kInt, LOADS>(dst, LD, src, count, cols, uq, tid, nthreads);
}

// With a row length only the launch knows.
template <bool kInt, int LOADS, typename T>
__device__ __noinline__ void stage_rows_ld(__nv_bfloat16* dst, int ld,
                                           const T* __restrict__ src,
                                           int count, int cols, Uniform uq,
                                           int tid, int nthreads) {
  stage_rows_body<kInt, LOADS>(dst, ld, src, count, cols, uq, tid, nthreads);
}

// The sum of a softmax row with its reciprocal, and an AdaLog base with its.
struct Divisor {
  float b, y;                        // y = __frcp_rn(b)
};

// A slice's AdaLog quantizer at scale 1 as its warps read it from shared
// memory: the dequantized value of every code, the base, and the bound of
// the codes that are kept.
struct CodeTable {
  float tab[MAX_CODES];
  Divisor base;
  float n2_half;                     // 2N - 0.5: codes below it are kept
};

// Fill ``ct`` for base aq and n_codes = 2N codes by the arithmetic of
// adalog_unit's second half, so an entry is bit-equal to what the
// per-element quantizer computes: the value (bf16 inputs) or, kInt, the
// value without its factor ts, steps * 2^-shift (exact in bf16 while
// 4N - 2 < 256). Thread nthreads - 1 writes the scalars.
template <bool kInt>
__device__ __forceinline__ void fill_code_table(CodeTable* ct, float aq,
                                                int n_codes, float ts, int tid,
                                                int nthreads) {
  for (int c = tid; c < n_codes; c += nthreads) {
    const float code = static_cast<float>(c);
    ct->tab[c] =
        kInt ? adalog_value_steps(code, aq, ts) : adalog_value(code, aq, ts);
  }
  if (tid == nthreads - 1) {
    ct->base = {aq, __frcp_rn(aq)};
    ct->n2_half = static_cast<float>(n_codes) - 0.5f;
  }
}

// The AdaLog values of one thread's four exponentials of an n8 tile (ea0,
// ea1 of row a, eb0, eb1 of row b; ``left`` columns of the row remain from
// the first of them, so the padded ones get 0), packed to bf16: .x is row
// a's pair, .y row b's. Both divisions are IEEE quotients, taken through
// the divisors' reciprocals (div_rn_by). The code is rint(y) with y =
// -log2(p) * 37 / q, and rint(y) < 2N exactly when y < 2N - 0.5 (2N is even,
// so the tie rounds up to it): one compare on y and one rounding conversion
// replace the round, the clamp and the compare of adalog_unit, to the same
// code. Not inlined: a row tile runs it S/8 times, and inlined the kernel's
// straight-line code outgrows the I-cache.
static __device__ __noinline__ uint2 quantize_tile(float ea0, float ea1,
                                                   float eb0, float eb1,
                                                   Divisor sum_a,
                                                   Divisor sum_b,
                                                   const CodeTable* ct,
                                                   int left) {
  const float e[4] = {ea0, ea1, eb0, eb1};
  const Divisor base = ct->base;
  const float n2_half = ct->n2_half;
  float pv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Divisor& sum = i < 2 ? sum_a : sum_b;
    const float p = fmaxf(div_rn_by(e[i], sum.b, sum.y), 1e-15f);
    const float y = div_rn_by(__fmul_rn(-log2f(p), ADALOG_R), base.b, base.y);
    const bool keep = y < n2_half && (i & 1) < left;
    const float val = ct->tab[keep ? __float2int_rn(y) : 0];
    pv[i] = keep ? val : 0.0f;
  }
  return make_uint2(pack_bf16(pv[0], pv[1]), pack_bf16(pv[2], pv[3]));
}

// The same for four probabilities that are given, not formed from a row's
// exponentials (no division by a sum). A value above 1 has a negative y and
// takes code 0, as adalog_unit's clamp has it.
static __device__ __noinline__ uint2 quantize_probs(float pa0, float pa1,
                                                    float pb0, float pb1,
                                                    const CodeTable* ct,
                                                    int left) {
  const float x[4] = {pa0, pa1, pb0, pb1};
  const Divisor base = ct->base;
  const float n2_half = ct->n2_half;
  float pv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float p = fmaxf(x[i], 1e-15f);
    const float y = div_rn_by(__fmul_rn(-log2f(p), ADALOG_R), base.b, base.y);
    const bool keep = y < n2_half && (i & 1) < left;
    const float val = ct->tab[keep ? max(__float2int_rn(y), 0) : 0];
    pv[i] = keep ? val : 0.0f;
  }
  return make_uint2(pack_bf16(pv[0], pv[1]), pack_bf16(pv[2], pv[3]));
}

}  // namespace fq

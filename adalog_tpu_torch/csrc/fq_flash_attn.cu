// Fused fake-quant attention for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces the TPU kernel adalog_tpu/ops/fq_attn.py::fq_flash_attn (body
// _flash_kernel, helpers _uq, _adalog_unit, _exp2_neg_int). Per slice g of
// G = batch*heads:
//   out[g] = AdaLog1(softmax(uq(q[g]) @ uq(kT[g]) * logit_scale + bias[g % P]))
//            @ uq(v[g])
// with uq the asymmetric uniform fake quantizer and AdaLog1 the AdaLog
// quantizer at scale 1 (r = 37, codes >= 2N dequantize to 0).
//
// What bounds it: per slice the kernel reads 3*S*D inputs and writes S*D
// fp32 outputs (deit_small, S=197, D=64: about 200 KB in fp32) against
// 4*S*S*D flops, about 50 flops per byte, so device memory is not the
// limit once the quantized kT and v are staged on chip. The (S, S) logits
// are the bulk of the unfused path's traffic: here they live only in shared
// memory. What remains is the shared-memory traffic of the two products on
// the fp32 FMA pipes (no tensor cores yet: about one 4-byte load per FMA),
// and the per-probability log2/exp2 and divisions of the AdaLog quantizer;
// each warp works through one row's dependent loads, so the latency of
// shared memory, more than its bandwidth, sets the time.
//
// Design (simple and exact first; wgmma and TMA are later work):
//   - one block per (slice g, tile of query rows); the block quantizes
//     kT[g] and v[g] once into dynamic shared memory (fp32 values, rounded
//     to bf16 first when the inputs are bf16). Staging costs a division per
//     element, so tiles are as large as MAX_ROWS_PER_BLOCK allows, and the
//     S rows are split evenly over the tiles (S=197: 4 tiles of 50 rows);
//   - 12 warps a block (at S=197, D=64 a block holds 113 KB of shared
//     memory, so two blocks, 24 warps, share an SM; the kernel is bound by
//     shared-memory latency, and more resident warps hide more of it);
//   - one warp per query row: lanes stride over the S columns for the
//     logits (up to 8 columns per lane in registers, so each broadcast q
//     value feeds 8 FMAs), the row max and sum go through __shfl_xor_sync;
//   - the AdaLog quantizer needs the FINISHED softmax row (an online-softmax
//     rescale does not commute with it), so the whole row of logits is kept
//     in shared memory until max and sum are known;
//   - p @ v spreads the D outputs over the lanes;
//   - the loops over staged elements, over D and over the S probabilities
//     are unrolled 4 deep, so several shared/global loads are in flight.
// Numerics follow the JAX kernel: rintf for every round (half to even),
// zero points rounded, quantizer math in fp32, operands rounded to the
// compute dtype before each product, fp32 accumulation, 2^-floor(prod/37)
// assembled from exponent bits. Sums run in another order than XLA's, and
// log2f/exp2f may differ by an ulp, so a probability within an ulp of a
// code boundary can take the neighbouring AdaLog code.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 12;            // must match ops/fq_attn.py _WARPS
constexpr int MAX_ROWS_PER_BLOCK = 64;
constexpr int COLS_PER_LANE = 8;     // logits chunk of 256 columns
constexpr int OUT_PER_LANE = 4;      // head dim <= 128
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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
fq_flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ kT,
                     const T* __restrict__ v, const float* __restrict__ m1a,
                     const float* __restrict__ m1b, const float* __restrict__ m2q,
                     const float* __restrict__ m2b, const float* __restrict__ bias,
                     float* __restrict__ out, int P, int S, int D,
                     int rows_per_block, int m1a_bits, int m1b_bits,
                     int m2a_bits, int m2b_bits, float logit_scale) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ float smem[];
  float* kT_s = smem;                    // (D, S)
  float* v_s = kT_s + D * S;             // (S, D)
  float* q_s = v_s + S * D;              // (WARPS, D)
  float* p_s = q_s + WARPS * D;          // (WARPS, S)

  const int g = blockIdx.x;
  const int row0 = blockIdx.y * rows_per_block;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t base = static_cast<size_t>(g) * S * D;

  const float qs = m1a[2 * g], qz = rintf(m1a[2 * g + 1]);
  const float ks = m1b[2 * g], kz = rintf(m1b[2 * g + 1]);
  const float vs = m2b[2 * g], vz = rintf(m2b[2 * g + 1]);
  const float aq = m2q[g];
  const float qmax = qmax_of(m1a_bits), kmax = qmax_of(m1b_bits);
  const float vmax = qmax_of(m2b_bits);
  const float n2 = static_cast<float>(2 * (1 << (m2a_bits - 1)));
  const float ts = static_cast<float>(1.0 / (2.0 * n2 - 2.0));

  // stage uq(kT[g]) and uq(v[g]); both are contiguous S*D runs
#pragma unroll 4
  for (int i = threadIdx.x; i < S * D; i += blockDim.x) {
    float kv = uq(to_f32(kT[base + i]), ks, kz, kmax);
    float vv = uq(to_f32(v[base + i]), vs, vz, vmax);
    if (kBf16) {
      kv = round_bf16(kv);
      vv = round_bf16(vv);
    }
    kT_s[i] = kv;
    v_s[i] = vv;
  }
  __syncthreads();

  float* qrow = q_s + warp * D;
  float* prow = p_s + warp * S;
  const float* bias_g =
      bias == nullptr ? nullptr : bias + static_cast<size_t>(g % P) * S * S;
  const int row_end = min(row0 + rows_per_block, S);

  for (int r = row0 + warp; r < row_end; r += WARPS) {
    for (int d = lane; d < D; d += 32) {
      float x = uq(to_f32(q[base + static_cast<size_t>(r) * D + d]), qs, qz, qmax);
      qrow[d] = kBf16 ? round_bf16(x) : x;
    }
    __syncwarp();

    // logits, 256 columns at a time, kept in the warp's row of p_s
    float mx = -INFINITY;
    for (int c0 = 0; c0 < S; c0 += 32 * COLS_PER_LANE) {
      float acc[COLS_PER_LANE];
#pragma unroll
      for (int c = 0; c < COLS_PER_LANE; ++c) acc[c] = 0.0f;
      const float* kcol = kT_s + c0 + lane;
      const int ncol = (S - c0 - lane + 31) / 32;   // columns of this lane
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float qd = qrow[d];
        const float* krow = kcol + d * S;
#pragma unroll
        for (int c = 0; c < COLS_PER_LANE; ++c)
          if (c < ncol) acc[c] = fmaf(qd, krow[32 * c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < COLS_PER_LANE; ++c) {
        if (c < ncol) {
          const int j = c0 + lane + 32 * c;
          float l = __fmul_rn(acc[c], logit_scale);
          if (bias_g != nullptr)
            l = __fadd_rn(l, bias_g[static_cast<size_t>(r) * S + j]);
          prow[j] = l;
          mx = fmaxf(mx, l);
        }
      }
    }
    mx = warp_max(mx);

    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) {
      float p = adalog_unit(__fdiv_rn(prow[j], sum), aq, n2, ts);
      prow[j] = kBf16 ? round_bf16(p) : p;
    }
    __syncwarp();

    float o[OUT_PER_LANE];
#pragma unroll
    for (int t = 0; t < OUT_PER_LANE; ++t) o[t] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < S; ++j) {
      const float p = prow[j];
      const float* vrow = v_s + j * D + lane;
#pragma unroll
      for (int t = 0; t < OUT_PER_LANE; ++t)
        if (lane + 32 * t < D) o[t] = fmaf(p, vrow[32 * t], o[t]);
    }
    float* orow = out + base + static_cast<size_t>(r) * D;
#pragma unroll
    for (int t = 0; t < OUT_PER_LANE; ++t)
      if (lane + 32 * t < D) orow[lane + 32 * t] = o[t];
    __syncwarp();                              // qrow/prow reused next row
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kT, const void* v,
                   const float* m1a, const float* m1b, const float* m2q,
                   const float* m2b, const float* bias, float* out, int P,
                   int G, int S, int D, int m1a_bits, int m1b_bits,
                   int m2a_bits, int m2b_bits, float logit_scale,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(2 * S * D + WARPS * (S + D)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fq_flash_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (S + MAX_ROWS_PER_BLOCK - 1) / MAX_ROWS_PER_BLOCK;
  const int rows_per_block = (S + tiles - 1) / tiles;
  dim3 grid(G, tiles);
  fq_flash_attn_kernel<T><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kT),
      static_cast<const T*>(v), m1a, m1b, m2q, m2b, bias, out, P, S, D,
      rows_per_block, m1a_bits, m1b_bits, m2a_bits, m2b_bits, logit_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 inputs, 1 = bfloat16 inputs. All parameter arrays are
// fp32: m1a/m1b/m2b (G, 2) [scale, zero point], m2q (G,), bias (P, S, S) or
// null. out is (G, S, D) fp32. Returns the CUDA error code of the launch.
extern "C" int fq_flash_attn_launch(int dtype, const void* q, const void* kT,
                                    const void* v, const void* m1a,
                                    const void* m1b, const void* m2q,
                                    const void* m2b, const void* bias,
                                    void* out, int P, int G, int S, int D,
                                    int m1a_bits, int m1b_bits, int m2a_bits,
                                    int m2b_bits, float logit_scale,
                                    void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kT, v, f(m1a), f(m1b), f(m2q), f(m2b), f(bias),
                         static_cast<float*>(out), P, G, S, D, m1a_bits,
                         m1b_bits, m2a_bits, m2b_bits, logit_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kT, v, f(m1a), f(m1b), f(m2q), f(m2b),
                                 f(bias), static_cast<float*>(out), P, G, S,
                                 D, m1a_bits, m1b_bits, m2a_bits, m2b_bits,
                                 logit_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Fused activation-fake-quant GEMM for Hopper (sm_90a): kernel K4 of the port.
//
// Replaces the TPU kernel adalog_tpu/ops/fq_gemm.py::fq_gemm (body _kernel,
// quantizer _quantize_tile, tiles from _pick_tiles):
//   out = cast(fq_a(x) @ w^T) (+ bias)     x (T, K), w (O, K), out (T, O)
// where fq_a is the per-tensor activation fake quantizer of a Linear site:
// uniform (asymmetric) or adalog_shift (AdaLog of x + shift, no
// subtract-back; the shift is folded into the bias). w is the prepared
// fake-quantized weight, in the compute dtype.
//
// What bounds it: the ViT Linears at serving batch are large GEMMs (deit_small
// at batch 32: T = 6304, K and O 384..1536, 150-500 flops per byte of
// operands), so the products, not device memory, set the time: the fp32 FMA
// pipes in fp32 (no TF32: the JAX kernel pins Precision.HIGHEST) and the
// bf16 tensor cores in bf16. The quantizer is the other cost: each block
// quantizes the x tile it loads, so every x element is quantized once per
// 128-column tile of the output: an IEEE division for uniform; two
// divisions, a log2 and a table lookup for AdaLog (its mantissa depends only
// on code * q mod 37, so a block tabulates the 37 values once; the shift is
// an integer division by 37). What the design removes is the unfused path's
// cost: 7 (uniform) to 20+ (AdaLog) elementwise passes that read and write
// all of x in device memory before the GEMM.
//
// Design (simple and exact first; wgmma, TMA and a deeper pipeline are later
// work):
//   - one block of 256 threads per 128x128 output tile, looping over K; the
//     grid's x runs over column tiles, so the blocks that read one x row
//     tile run together and find it in L2;
//   - each thread loads its share of the x tile, fake-quantizes it in
//     registers in fp32, rounds it to the compute dtype and stores it to
//     shared memory; w tiles are stored as they are; the next tile's global
//     loads are issued before the current tile's products;
//   - fp32: each thread computes 8x8 outputs on the FMA pipes (BK 16);
//   - bf16: 8 warps of mma.sync m16n8k16 (bf16 x bf16 products are exact in
//     the fp32 accumulator), a 64x32 tile a warp (BK 32);
//   - at most 128 registers a thread, so that two blocks share an SM;
//   - rows past T, columns past O and k past K are masked in the kernel:
//     zeros go to shared memory (a quantized 0 is not 0 for adalog_shift);
//   - epilogue: the fp32 sum is rounded to the output dtype, then the bias
//     is added in that dtype (JAX's order: the kernel's cast, then
//     qlinear's bias add).
// Numerics follow the JAX kernel: rintf for every round (half to even), the
// zero point rounded, IEEE division, no FMA contraction in the quantizer,
// 2^-k exact (exponent bits, ldexpf past 2^-126). Sums run in another order
// than the plain version's, and log2f/exp2f may differ from another
// library's by an ulp, so an AdaLog code at a .5 boundary may flip against a
// CPU reference.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;              // output rows of a block
constexpr int BN = 128;              // output columns of a block
constexpr int THREADS = 256;
constexpr int F_BK = 16;             // fp32 k step
constexpr int H_BK = 32;             // bf16 k step
constexpr int H_LD = H_BK + 8;       // bf16 smem row: 80 bytes, no bank conflicts
constexpr float ADALOG_R = 37.0f;

enum Kind { UNIFORM = 0, ADALOG_SHIFT = 1 };

struct QParams {
  float s, z, shift, q;    // z already rounded
  float qmax;              // 2N - 1
  float n2;                // 2N
  float ts;                // 1 / (4N - 2), the mantissa step
};

// The AdaLog base q is a positive integer with (2N - 1) * q < 2^24
// (ops/fq_gemm.py::prepare checks it once per site at load time), so a
// product code * q is an exact integer, and its mantissa depends only on
// prod mod 37: rint(2^(-j / 37) / ts) * ts for j = 0..36, one table a block.
constexpr int MANT_TABLE = 37;

__device__ __forceinline__ QParams load_params(const float* p, int bits) {
  QParams r;
  r.s = p[0];
  r.z = rintf(p[1]);
  r.shift = p[2];
  r.q = p[3];
  const double n = static_cast<double>(1 << (bits - 1));
  r.n2 = static_cast<float>(2.0 * n);
  r.qmax = static_cast<float>(2.0 * n - 1.0);
  r.ts = static_cast<float>(1.0 / (4.0 * n - 2.0));
  return r;
}

// fill the block's mantissa table (ADALOG_SHIFT only); ends in a barrier
__device__ __forceinline__ void fill_mantissa_table(float* tab, const QParams& p) {
  for (int j = threadIdx.x; j < MANT_TABLE; j += blockDim.x) {
    const float e = exp2f(__fdiv_rn(-static_cast<float>(j), ADALOG_R));
    tab[j] = __fmul_rn(rintf(__fdiv_rn(e, p.ts)), p.ts);
  }
  __syncthreads();
}

template <int KIND>
__device__ __forceinline__ float fake_quant(float x, const QParams& p,
                                            const float* mant_tab) {
  if (KIND == UNIFORM) {
    const float c = fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(x, p.s)), p.z), 0.0f),
                          p.qmax);
    return __fmul_rn(__fsub_rn(c, p.z), p.s);
  }
  const float scaled =
      fminf(fmaxf(__fdiv_rn(__fadd_rn(x, p.shift), p.s), 1e-15f), 1.0f);
  float code = rintf(__fdiv_rn(__fmul_rn(-log2f(scaled), ADALOG_R), p.q));
  if (!(code < p.n2)) return 0.0f;         // codes past the last level
  code = fminf(fmaxf(code, 0.0f), p.qmax);
  // an exact integer product: integer division gives floor(prod / 37) and
  // remainder(prod, 37) exactly, and the mantissa comes from the table
  const int prod = static_cast<int>(__fmul_rn(code, p.q));
  const int shift = prod / 37;
  const float mant = mant_tab[prod - 37 * shift];
  const float pow2 = shift < 126 ? __int_as_float((127 - shift) << 23)
                                 : ldexpf(1.0f, -shift);
  return __fmul_rn(__fmul_rn(pow2, mant), p.s);
}

// ---------------------------------------------------------------------------
// fp32: FMA pipes
// ---------------------------------------------------------------------------

// x[r, k..k+3] (zeros past R rows or K columns)
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int r,
                                        int R, int k, int K, int ld,
                                        bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (r >= R || k >= K) return v;
  const float* p = src + static_cast<size_t>(r) * ld + k;
  if (vec) return *reinterpret_cast<const float4*>(p);
  v.x = p[0];
  if (k + 1 < K) v.y = p[1];
  if (k + 2 < K) v.z = p[2];
  if (k + 3 < K) v.w = p[3];
  return v;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 2)
fq_gemm_f32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ prm, const float* __restrict__ bias,
            float* __restrict__ out, int T, int K, int O, int lda, int bits,
            bool vec, bool vec_out) {
  __shared__ __align__(16) float As[F_BK][BM + 4];   // quantized x, k-major
  __shared__ __align__(16) float Bs[F_BK][BN + 4];   // w, k-major
  __shared__ float mant_tab[MANT_TABLE];

  const QParams p = load_params(prm, bits);
  if (KIND == ADALOG_SHIFT) fill_mantissa_table(mant_tab, p);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  // loads: rows lr and lr + 64 of the tile, k lk .. lk + 3
  const int lr = tid >> 2, lk = (tid & 3) * 4;
  // products: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, the same for columns
  const int ty = tid >> 4, tx = tid & 15;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float4 ra[2], rb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ra[h] = load4(x, row0 + lr + 64 * h, T, lk, K, lda, vec);
    rb[h] = load4(w, col0 + lr + 64 * h, O, lk, K, K, vec);
  }

  for (int k0 = 0; k0 < K; k0 += F_BK) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool row_ok = row0 + lr + 64 * h < T;
      const float v[4] = {ra[h].x, ra[h].y, ra[h].z, ra[h].w};
      const float u[4] = {rb[h].x, rb[h].y, rb[h].z, rb[h].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = row_ok && k0 + lk + i < K;
        As[lk + i][lr + 64 * h] = ok ? fake_quant<KIND>(v[i], p, mant_tab) : 0.0f;
        Bs[lk + i][lr + 64 * h] = u[i];
      }
    }
    __syncthreads();
    if (k0 + F_BK < K) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ra[h] = load4(x, row0 + lr + 64 * h, T, k0 + F_BK + lk, K, lda, vec);
        rb[h] = load4(w, col0 + lr + 64 * h, O, k0 + F_BK + lk, K, K, vec);
      }
    }
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= T) continue;
    float* orow = out + static_cast<size_t>(r) * O;
#pragma unroll
    for (int hj = 0; hj < 2; ++hj) {
      const int c = col0 + hj * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][hj * 4 + j];
        if (bias != nullptr && c + j < O) v[j] = __fadd_rn(v[j], bias[c + j]);
      }
      if (vec_out && c + 3 < O) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < O) orow[c + j] = v[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}
__device__ __forceinline__ float round_bf16(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

// 8 bf16 of src[r, k..k+7] as 4 words (zeros past R rows or K columns)
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ src,
                                       int r, int R, int k, int K, int ld,
                                       bool vec) {
  if (r >= R || k >= K) return make_uint4(0u, 0u, 0u, 0u);
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(src) + static_cast<size_t>(r) * ld + k;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (k + i < K) wd[i / 2] |= static_cast<uint32_t>(p[i]) << (16 * (i & 1));
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 2)
fq_gemm_bf16(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ w,
             const float* __restrict__ prm,
             const __nv_bfloat16* __restrict__ bias,
             __nv_bfloat16* __restrict__ out, int T, int K, int O, int lda,
             int bits, bool vec, bool vec_out) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][H_LD];   // quantized x
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][H_LD];   // w
  __shared__ float mant_tab[MANT_TABLE];

  const QParams p = load_params(prm, bits);
  if (KIND == ADALOG_SHIFT) fill_mantissa_table(mant_tab, p);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  // loads: rows lr and lr + 64 of the tile, k lk .. lk + 7
  const int lr = tid >> 2, lk = (tid & 3) * 8;
  // products: warp (wm, wn) owns rows wm*64 .. +63 and columns wn*32 .. +31
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  uint4 ra[2], rb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ra[h] = load8(x, row0 + lr + 64 * h, T, lk, K, lda, vec);
    rb[h] = load8(w, col0 + lr + 64 * h, O, lk, K, K, vec);
  }

  for (int k0 = 0; k0 < K; k0 += H_BK) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool row_ok = row0 + lr + 64 * h < T;
      const uint32_t in[4] = {ra[h].x, ra[h].y, ra[h].z, ra[h].w};
      uint32_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + lk + 2 * j;
        const float lo =
            row_ok && k < K ? fake_quant<KIND>(bf16_lo(in[j]), p, mant_tab) : 0.0f;
        const float hi =
            row_ok && k + 1 < K ? fake_quant<KIND>(bf16_hi(in[j]), p, mant_tab) : 0.0f;
        q[j] = bf16_bits(lo) | (bf16_bits(hi) << 16);
      }
      *reinterpret_cast<uint4*>(&As[lr + 64 * h][lk]) = make_uint4(q[0], q[1], q[2], q[3]);
      *reinterpret_cast<uint4*>(&Bs[lr + 64 * h][lk]) = rb[h];
    }
    __syncthreads();
    if (k0 + H_BK < K) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ra[h] = load8(x, row0 + lr + 64 * h, T, k0 + H_BK + lk, K, lda, vec);
        rb[h] = load8(w, col0 + lr + 64 * h, O, k0 + H_BK + lk, K, K, vec);
      }
    }
#pragma unroll
    for (int ks = 0; ks < H_BK; ks += 16) {
      uint32_t a[4][4], b[4][2];
      const int c = ks + t4 * 2;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + g;
        a[mt][0] = lds32(&As[r][c]);
        a[mt][1] = lds32(&As[r + 8][c]);
        a[mt][2] = lds32(&As[r][c + 8]);
        a[mt][3] = lds32(&As[r + 8][c + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + g;
        b[nt][0] = lds32(&Bs[n][c]);
        b[nt][1] = lds32(&Bs[n][c + 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wm * 64 + mt * 16 + g + 8 * half;
      if (r >= T) continue;
      __nv_bfloat16* orow = out + static_cast<size_t>(r) * O;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = col0 + wn * 32 + nt * 8 + t4 * 2;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = round_bf16(acc[mt][nt][2 * half + e]);
          if (bias != nullptr && c + e < O)
            v[e] = __fadd_rn(v[e], __bfloat162float(bias[c + e]));
        }
        if (vec_out && c + 1 < O) {
          *reinterpret_cast<uint32_t*>(orow + c) = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (c + e < O) orow[c + e] = __float2bfloat16_rn(v[e]);
        }
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <int KIND>
cudaError_t launch(int dtype, const void* x, const void* w, const float* prm,
                   const void* bias, void* out, int T, int K, int O, int lda,
                   int bits, cudaStream_t stream) {
  const dim3 grid((O + BN - 1) / BN, (T + BM - 1) / BM);
  if (dtype == 0) {
    const bool vec = K % 4 == 0 && lda % 4 == 0 && aligned16(x) && aligned16(w);
    const bool vec_out = O % 4 == 0 && aligned16(out);
    fq_gemm_f32<KIND><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), prm,
        static_cast<const float*>(bias), static_cast<float*>(out), T, K, O,
        lda, bits, vec, vec_out);
  } else {
    const bool vec = K % 8 == 0 && lda % 8 == 0 && aligned16(x) && aligned16(w);
    const bool vec_out = O % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 3u) == 0;
    fq_gemm_bf16<KIND><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        prm, static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), T, K, O, lda, bits, vec, vec_out);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, bias and out); kind: 0 = uniform,
// 1 = adalog_shift. x is (T, K) with row stride lda, w (O, K) contiguous,
// params (4,) fp32 [scale, zero_point, shift, log_q] (for adalog_shift, log_q
// a positive integer with (2^bits - 1) * log_q < 2^24), bias (O,) or null,
// out (T, O) contiguous. Returns the CUDA error code of the launch.
extern "C" int fq_gemm_launch(int dtype, int kind, const void* x,
                              const void* w, const void* params,
                              const void* bias, void* out, int T, int K,
                              int O, int lda, int bits, void* stream) {
  if ((dtype != 0 && dtype != 1) || bits < 1 || bits > 16 || T <= 0 ||
      O <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* prm = static_cast<const float*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == UNIFORM)
    return launch<UNIFORM>(dtype, x, w, prm, bias, out, T, K, O, lda, bits, st);
  if (kind == ADALOG_SHIFT)
    return launch<ADALOG_SHIFT>(dtype, x, w, prm, bias, out, T, K, O, lda,
                                bits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

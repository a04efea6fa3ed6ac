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
// What bounds it: the ViT Linears at serving batch are large products
// (deit_small at batch 32: T = 6304, K and O 384..1536, 150-500 operations
// per byte of operands), so on the tensor cores the operations set the bound
// (a batch's 49 products are 0.27 ms at the bf16 rate), not device memory.
// What the card really spends on top of that is the quantizer: an IEEE
// division an element for uniform; two divisions, a log2, a table look-up
// for AdaLog (35 operations an element, 116 M elements a batch). So the
// design's first rule is that an x element is quantized once, or once per
// group of columns where one group would leave SMs idle, and that the
// quantizer's arithmetic runs beside the tensor cores' work, not before it.
//
// Two variants, both hand-written, chosen by the wrapper
// (ops/fq_gemm.py::gemm_variant) from dtype, bit widths and what is known
// of the weight:
//
// "mma": the design for this card, one main loop for both eval dtypes.
//   - Products on the tensor cores as mma.sync.aligned.m16n8k16, bf16 x bf16
//     with fp32 accumulators, both operands read with ldmatrix. mma.sync,
//     not wgmma: measured with parts of the kernel switched off, the
//     products are two fifths of a call, w's way from L2 a quarter, the
//     stores a sixth, and they add up rather than overlap (16 warps an SM
//     in step behind one barrier a stage); until they overlap, the tensor
//     cores' dispatch rate does not bind. wgmma (operands straight from shared
//     memory, asynchronous) with TMA multicast of w is the next step.
//   - Ring stages are 64 k wide, [rows][64] bf16 without padding: a row is
//     one 128-byte request to L2 and eight 16-byte chunks, chunk c of row r
//     stored at c ^ (r % 8), so the eight rows of an ldmatrix fall into
//     different banks. Three stages; 16-byte cp.async, zero-filled past
//     the edges.
//   - Order (i), x resident (K <= 1024: qkv, proj, fc1, the head): a block
//     quantizes its 64 rows, all K columns, into shared memory once (16-byte
//     loads, four in flight a thread), then walks its column tiles of 128,
//     streaming w through the ring; the (column tile, k step) pairs run as
//     one sequence, so the ring never drains. Where the row tiles alone
//     leave SMs idle (6,304 rows are 99 tiles for 132 SMs) the column tiles
//     are split over groups of blocks: two quantizations an element, of the
//     cheap uniform kind, for a full card. Two blocks an SM. The head's 32
//     rows take a 32-row tile and 64-column tiles, 16 blocks.
//   - Order (ii), wide N (K > 1024: fc2, 1536 -> 384; Swin's 3072 -> 768 and
//     its reductions): k outermost. A block owns 64 rows and 384 columns
//     (all of fc2's, so each element is quantized once: this is where the
//     AdaLog quantizer sits); a ring stage holds 64 columns of raw x and of
//     w; while stage k is multiplied, each thread quantizes the 16-byte
//     pieces of stage k + 1 that it copied itself (no barrier between copy
//     and quantizer) into a double-buffered operand tile, and stage k + 2
//     is in flight. 16 warps, a warp 32 x 48 outputs. One barrier a stage.
//   - The quantizer, to the same bits: s and the AdaLog base are per launch,
//     so both IEEE quotients come from the divisor's rounded reciprocal
//     (fq_quant.cuh::div_rn_by, three operations); the dequantized AdaLog
//     value depends on the code alone, so a block tabulates the 2N values
//     with the arithmetic of "fma" (bits <= 8; above that, "fma"'s
//     per-element path); rint, clamp and compare fold into one compare and
//     one rounding conversion.
//   - bf16 inputs: the operands are what the plain version rounds to bf16,
//     w as it comes; the fp32 sum is rounded to bf16, then the bias added.
//   - fp32 inputs stay exact through integer operands: (c - z) * s does not
//     fit bf16 but the integer c - z does, and so does the served weight's
//     c_w - z_w (ops/weight_prep.py::weight_codes). The kernel stages the
//     integers (for AdaLog steps * 2^-shift, the value without ts * s),
//     takes their sum in the fp32 accumulator and scales it by s * s_w[o] in
//     the epilogue. This is exact arithmetic where the plain version rounds
//     each fp32 product, so the two differ by a few ulp of the sum, not bit
//     for bit. The wrapper sends fp32 inputs here only when the weight codes
//     are known and every staged integer is exact in bf16.
//   - Epilogue: the columns' scales and bias are loaded a tile ahead and
//     not touched before their use; a warp passes its tile through shared
//     memory eight rows at a time and writes each row as one run of
//     16-byte pieces.
//   - Ragged edges: cp.async zero-fills w past O and K, so a padded k adds 0
//     whatever the quantizer makes of a padded x (a quantized 0 is not 0
//     for adalog_shift); k16 steps past K are not run; rows past T are
//     computed and never stored. Inputs that are not 16-byte aligned take
//     element loads into the same ring.
//
// "fma": the first kernels of the port, for what "mma" does not take: fp32
// inputs without weight codes (any w), or with integers that are not exact
// in bf16.
//   - one block of 256 threads per 128x128 output tile, looping over K, no
//     pipeline; every block quantizes the x tile it loads (once per
//     128-column tile of the output);
//   - fp32: each thread computes 8x8 outputs on the FMA pipes (BK 16): exact
//     fp32 products, which rule TF32 out, at the rate of an fp32 library
//     product; bf16: 8 warps of mma.sync, a 64x32 tile a warp (BK 32);
//   - IEEE divisions and the 37-entry mantissa table per element.
//
// Numerics follow the JAX kernel: rintf for every round (half to even), the
// zero point rounded, IEEE division, no FMA contraction in the quantizer,
// 2^-k exact (exponent bits, ldexpf past 2^-126); the epilogue rounds the
// fp32 sum to the output dtype, then adds the bias in that dtype (JAX's
// order: the kernel's cast, then qlinear's bias add). Sums run in another
// order than the plain version's (and the tensor core's adder is not an
// IEEE round-to-nearest sum), and log2f/exp2f may differ from another
// library's by an ulp, so an AdaLog code at a .5 boundary may flip against a
// CPU reference.

#include <algorithm>

#include "fq_quant.cuh"

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
// variant "fma", fp32: FMA pipes
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
fq_gemm_fma_f32(const float* __restrict__ x, const float* __restrict__ w,
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
// variant "fma", bf16: one unpipelined mma.sync tile
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
fq_gemm_fma_bf16(const __nv_bfloat16* __restrict__ x,
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

// ---------------------------------------------------------------------------
// variant "mma": tensor cores for both dtypes, x quantized once, a cp.async
// ring for w (and, in the wide-N order, for raw x)
// ---------------------------------------------------------------------------

constexpr int M_BK = 64;             // k step of a ring stage: 128-byte rows
constexpr int RES_THREADS = 256;     // x-resident order: 8 warps, 2 x 4
constexpr int RES_STAGES = 3;
constexpr int RES_MAX_K = 1024;      // longest row held resident
constexpr int WIDE_THREADS = 512;    // wide-N order: 16 warps, 2 x 8
constexpr int WIDE_STAGES = 3;
constexpr int WIDE_BM = 64;          // rows of a block
constexpr int WIDE_BN = 384;         // columns of a block: all of fc2's
constexpr int WIDE_MT = 2, WIDE_NT = 6;   // a warp: 32 rows x 48 columns
constexpr int TABLE = 256;           // AdaLog values of a launch: bits <= 8

// One launch's arguments. w_op is the (O, K) bf16 operand: w itself for
// bf16 inputs, the integers c_w - z_w for fp32 inputs, whose sums are
// scaled by w_scale (O,).
struct MmaArgs {
  const void* x;
  const __nv_bfloat16* w_op;
  const float* prm;
  const void* bias;
  const float* w_scale;
  void* out;
  int T, K, O, lda, bits;
  int tiles_per_group;               // x-resident order: column tiles a block
  bool vec_x, vec_w, vec_out;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, asynchronously, past L1;
// the last 16 - bytes are zero-filled (bytes = 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Ring tiles are [rows][64] bf16 without padding: a row is 128 bytes (one
// request to L2 a row), eight 16-byte chunks, and chunk c of row r sits at
// chunk c ^ (r % 8), so that the eight rows of an ldmatrix fall into
// different banks. The element offset of (row, chunk):
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * M_BK + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo: low 16 bits
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// The quantizer of one launch as "mma" stages it. Both divisors are the same
// for every element, so both IEEE quotients come from the divisor's rounded
// reciprocal (fq::div_rn_by, three operations); the dequantized AdaLog value
// depends on the code alone, so a block tabulates the 2N values once
// (bits <= 8; above that the per-element arithmetic of "fma").
struct MmaQuant {
  QParams p;
  float inv_s, inv_q;
  float n2_half;                     // 2N - 0.5: codes below it are kept
  bool tabled;
};

// kInt: fp32 inputs, staged as integers (uniform: c - z; AdaLog: steps *
// 2^-shift, the value without its factor ts * s). Fills tab for AdaLog and
// ends in a barrier then.
template <int KIND, bool kInt>
__device__ __forceinline__ MmaQuant setup_quant(const float* prm, int bits,
                                                float* tab) {
  MmaQuant m;
  m.p = load_params(prm, bits);
  m.inv_s = __frcp_rn(m.p.s);
  m.inv_q = __frcp_rn(m.p.q);
  m.n2_half = m.p.n2 - 0.5f;
  m.tabled = bits <= 8;
  if (KIND == ADALOG_SHIFT) {
    if (m.tabled) {
      // an entry is what fake_quant computes for that code, bit for bit
      for (int c = threadIdx.x; c < (1 << bits); c += blockDim.x) {
        const int prod = static_cast<int>(__fmul_rn(static_cast<float>(c), m.p.q));
        const int shift = prod / 37;
        const float e =
            exp2f(__fdiv_rn(-static_cast<float>(prod - 37 * shift), ADALOG_R));
        const float steps = rintf(__fdiv_rn(e, m.p.ts));
        const float pow2 = shift < 126 ? __int_as_float((127 - shift) << 23)
                                       : ldexpf(1.0f, -shift);
        tab[c] = kInt ? __fmul_rn(pow2, steps)
                      : __fmul_rn(__fmul_rn(pow2, __fmul_rn(steps, m.p.ts)),
                                  m.p.s);
      }
      __syncthreads();
    } else {
      fill_mantissa_table(tab, m.p);
    }
  }
  return m;
}

// The staged operand of one element, before its rounding to bf16. rint(y) <
// 2N exactly when y < 2N - 0.5 (2N is even, so the tie rounds up to it): one
// compare and one rounding conversion replace round, clamp and compare.
template <int KIND, bool kInt>
__device__ __forceinline__ float staged(float x, const MmaQuant& m,
                                        const float* tab) {
  if (KIND == UNIFORM) {
    const float c = fminf(
        fmaxf(__fadd_rn(rintf(fq::div_rn_by_any(x, m.p.s, m.inv_s)), m.p.z),
              0.0f),
        m.p.qmax);
    const float d = __fsub_rn(c, m.p.z);
    return kInt ? d : __fmul_rn(d, m.p.s);
  }
  if (!m.tabled) return fake_quant<ADALOG_SHIFT>(x, m.p, tab);
  const float scaled = fminf(
      fmaxf(fq::div_rn_by_any(__fadd_rn(x, m.p.shift), m.p.s, m.inv_s), 1e-15f),
      1.0f);
  const float y =
      fq::div_rn_by(__fmul_rn(-log2f(scaled), ADALOG_R), m.p.q, m.inv_q);
  const bool keep = y < m.n2_half;
  const float v = tab[keep ? __float2int_rn(y) : 0];
  return keep ? v : 0.0f;
}

// 8 staged operands of x[k .. k+7] packed to bf16
template <int KIND, bool kInt>
__device__ __forceinline__ uint4 stage8(const float (&v)[8], const MmaQuant& m,
                                        const float* tab) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pack_bf16(staged<KIND, kInt>(v[2 * i], m, tab),
                     staged<KIND, kInt>(v[2 * i + 1], m, tab));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x[row, k .. k+7] as floats; zeros past T rows or K columns (their
// operands meet zero weights, or rows that are never stored)
__device__ __forceinline__ void load8f(float (&v)[8], const float* __restrict__ x,
                                       int row, int k, int T, int K, int lda,
                                       bool vec) {
  const float4 lo = load4(x, row, T, k, K, lda, vec);
  const float4 hi = load4(x, row, T, k + 4, K, lda, vec);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

__device__ __forceinline__ void load8f(float (&v)[8],
                                       const __nv_bfloat16* __restrict__ x,
                                       int row, int k, int T, int K, int lda,
                                       bool vec) {
  const uint4 raw = load8(x, row, T, k, K, lda, vec);
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = bf16_lo(u[i]);
    v[2 * i + 1] = bf16_hi(u[i]);
  }
}

// The x-resident order's row tile: ROWS rows of x from row0, K16 columns
// (K rounded up to 16), quantized once into A ([ROWS][lda_s] bf16). Four
// loads in flight a thread before the first is used. A thread's pieces lie
// RES_THREADS apart; their (row, piece of the row) advance by a constant
// step with a carry, so no piece pays a division. Not inlined: its
// registers stay out of the main loop's allocation.
template <int KIND, typename IN_T, int ROWS>
__device__ __noinline__ void stage_x_tile(__nv_bfloat16* A,
                                          const IN_T* __restrict__ x, int row0,
                                          int T, int K, int K16, int lda,
                                          int lda_s, bool vec, MmaQuant m,
                                          const float* tab) {
  constexpr bool kInt = sizeof(IN_T) == 4;
  constexpr int LOADS = 4;
  const int ppr = K16 / 8;                     // 8-element pieces a row
  const int dr = RES_THREADS / ppr, dc = RES_THREADS % ppr;
  int r = threadIdx.x / ppr, c = threadIdx.x % ppr;
  while (r < ROWS) {
    float v[LOADS][8];
    int rr[LOADS], cc[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      rr[u] = r, cc[u] = c;
      // past the tile: zeros (rows >= T read none), never stored
      load8f(v[u], x, r < ROWS ? row0 + r : T, c * 8, T, K, lda, vec);
      r += dr, c += dc;
      if (c >= ppr) c -= ppr, ++r;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u)
      if (rr[u] < ROWS)
        *reinterpret_cast<uint4*>(A + rr[u] * lda_s + cc[u] * 8) =
            stage8<KIND, kInt>(v[u], m, tab);
  }
}

// One stage of the w ring: ROWS output columns from col_base, k0 .. k0+63,
// as a swizzled [ROWS][64] bf16 tile, zeros past O and K; chunks from k_end
// on (K rounded up to 16) are left alone, the products skip them. 16-byte
// cp.async where w allows it (K a multiple of 8, aligned), else element by
// element.
template <int ROWS, int THREADS_>
__device__ __forceinline__ void load_w_stage(__nv_bfloat16* stage,
                                             const __nv_bfloat16* __restrict__ w,
                                             int col_base, int k0, int O, int K,
                                             int k_end, bool vec) {
  // a thread's pieces share a chunk and lie STEP rows apart, so source and
  // destination advance by constants (STEP is a multiple of 8: the swizzle
  // of a thread's rows is one)
  constexpr int STEP = THREADS_ / 8;
  static_assert(ROWS % STEP == 0 && STEP % 8 == 0, "whole pieces a thread");
  const int ch = threadIdx.x & 7, n0 = threadIdx.x >> 3;
  const int k = k0 + ch * 8;
  if (k >= k_end) return;
  __nv_bfloat16* dst = stage + swz(n0, ch);
  const __nv_bfloat16* src = w + static_cast<size_t>(col_base + n0) * K + k;
#pragma unroll
  for (int i = 0; i < ROWS / STEP; ++i) {
    const bool ok = k < K && col_base + n0 + i * STEP < O;
    if (vec) {
      cp_async16(dst, ok ? src : w, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = ok && k + e < K ? src[e] : zero_of<__nv_bfloat16>();
    }
    dst += STEP * M_BK;
    src += static_cast<size_t>(STEP) * K;
  }
}

// The products of one ring stage: the warp's MT m16 tiles (rows of A) times
// its NT n8 tiles (rows of B, a swizzled stage of the w ring), ksteps k16
// steps (4, fewer in K's last stage). A is a swizzled tile too (A_SWZ, the
// wide-N order's operand tile) or rows of stride lda_s padded to an odd
// number of chunks (the resident row tile). Fragments come from ldmatrix:
// for A, lane l reads row l % 16 at chunk l / 16 of the k16 step; for B
// (stored [n][k], which is the fragment's own layout) row l % 8 + 8 (l /
// 16) at chunk l / 8 % 2, so one load gives both halves of two n8 tiles.
// Every tile starts at a row that is a multiple of 8, so a lane's row % 8
// is l % 8.
template <int MT, int NT, bool A_SWZ>
__device__ __forceinline__ void mma_stage(float (&acc)[MT][NT][4],
                                          uint32_t a_addr, int lda_s,
                                          uint32_t b_addr, int lane,
                                          int ksteps) {
  static_assert(NT % 2 == 0, "n8 tiles come in pairs");
  // shared-memory byte addresses: the tiles' (a_addr, b_addr) plus the
  // lane's row, then constants a tile and a k16 step
  const int lr = lane & 7;
  const int a_ch = lane >> 4, b_ch = (lane >> 3) & 1;
  const int a_row_bytes = (A_SWZ ? M_BK : lda_s) * 2;
  a_addr += (lane & 15) * a_row_bytes + (A_SWZ ? 0 : a_ch * 16);
  b_addr += (lr + 8 * (lane >> 4)) * (M_BK * 2);
#pragma unroll
  for (int s = 0; s < M_BK / 16; ++s) {
    if (s >= ksteps) break;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(a[mt], a_addr + mt * 16 * a_row_bytes +
                             (A_SWZ ? ((2 * s + a_ch) ^ lr) << 4 : s * 32));
    const uint32_t b_s = b_addr + (((2 * s + b_ch) ^ lr) << 4);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, b_s + np * 16 * M_BK * 2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b + 2);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// What the epilogue needs of the warp's columns (from col_base; the lane's
// two of each n8 tile), as device memory has it: w_scale[column] for fp32
// inputs, the bias. Loaded a column tile ahead and not touched until the
// epilogue, so that no warp waits for the loads.
template <typename IN_T, int NT>
struct ColConsts {
  float ws[NT][2];
  IN_T bias[NT][2];
};

template <typename IN_T, int NT>
__device__ __forceinline__ void load_col_consts(ColConsts<IN_T, NT>& cc,
                                                const MmaArgs& a, int col_base,
                                                int lane) {
  constexpr bool kInt = sizeof(IN_T) == 4;
  const IN_T* bias = static_cast<const IN_T*>(a.bias);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = min(col_base + nt * 8 + 2 * (lane & 3) + e, a.O - 1);
      if (kInt) cc.ws[nt][e] = a.w_scale[c];
      if (bias != nullptr) cc.bias[nt][e] = bias[c];
    }
}

// The warp's outputs: rows from row_base, columns from col_base. fp32
// inputs: the integer sum times its column's scale, then the bias. bf16
// inputs: the sum rounded to bf16, then the bias added in bf16. An mma
// accumulator holds two columns of a row a lane, so stored as it lies a row
// would leave the warp in pieces of 8 bytes; instead the warp passes its
// tile through shared memory, eight rows at a time (st: 8 rows of 8 NT + 8
// floats, its own), and writes each row as one run of 16-byte pieces.
// Columns past O, or an output that is not 16-byte aligned, go element by
// element.
template <typename IN_T, int MT, int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[MT][NT][4],
                                           const MmaArgs& a, int row_base,
                                           int col_base,
                                           const ColConsts<IN_T, NT>& cc,
                                           float a_scale, float* st,
                                           int lane) {
  constexpr bool kInt = sizeof(IN_T) == 4;
  constexpr int COLS = 8 * NT, LDS = COLS + 8;
  constexpr int E = 16 / sizeof(IN_T);         // outputs of a 16-byte piece
  constexpr int CPR = COLS / E;                // pieces a row
  const bool has_bias = a.bias != nullptr;
  const bool whole = a.vec_out && col_base + COLS <= a.O;
  IN_T* out = static_cast<IN_T*>(a.out);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r0 = row_base + mt * 16 + 8 * half;
      __syncwarp();                            // the round before is read
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[mt][nt][2 * half + e];
          v[e] = kInt ? __fmul_rn(v[e], __fmul_rn(a_scale, cc.ws[nt][e]))
                      : round_bf16(v[e]);
          if (has_bias) v[e] = __fadd_rn(v[e], fq::to_f32(cc.bias[nt][e]));
        }
        *reinterpret_cast<float2*>(st + g * LDS + nt * 8 + 2 * t4) =
            make_float2(v[0], v[1]);
      }
      __syncwarp();
      if (whole) {
#pragma unroll
        for (int i = 0; i < (8 * CPR + 31) / 32; ++i) {
          const int idx = lane + 32 * i;
          const int rr = idx / CPR, ch = idx - rr * CPR;
          if (idx >= 8 * CPR || r0 + rr >= a.T) continue;
          const float* src = st + rr * LDS + ch * E;
          IN_T* dst = out + static_cast<size_t>(r0 + rr) * a.O + col_base + ch * E;
          const float4 lo = *reinterpret_cast<const float4*>(src);
          if (kInt) {
            *reinterpret_cast<float4*>(dst) = lo;
          } else {
            const float4 hi = *reinterpret_cast<const float4*>(src + 4);
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                           pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
          }
        }
      } else {
        for (int idx = lane; idx < 8 * COLS; idx += 32) {
          const int rr = idx / COLS, c = idx - rr * COLS;
          if (r0 + rr >= a.T || col_base + c >= a.O) continue;
          const float v = st[rr * LDS + c];
          IN_T* dst = out + static_cast<size_t>(r0 + rr) * a.O + col_base + c;
          if (kInt)
            *reinterpret_cast<float*>(dst) = v;
          else
            *reinterpret_cast<__nv_bfloat16*>(dst) = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

// the scale of fp32 inputs' integer sums on the activation side: s for
// uniform, ts * s for AdaLog (whose table holds steps * 2^-shift)
template <int KIND>
__device__ __forceinline__ float activation_scale(const QParams& p) {
  return KIND == UNIFORM ? p.s : __fmul_rn(p.ts, p.s);
}

// With -DK4_PROFILE the "mma" kernels sum their warps' cycles by phase
// (clock64 at the K4_TICK marks) into k4_prof; fq_gemm_profile reads it. The
// shipped build has none of it. Phases: 0 set-up (the first loads, the
// table, the row tile's quantizer in the x-resident order), 1 waiting for
// the ring and at the barrier, 2 starting the next stage's loads, 3 the
// products (ldmatrix and mma), 4 the next stage's quantizer (wide-N order),
// 5 the epilogue.
#ifdef K4_PROFILE
__device__ unsigned long long k4_prof[8];
#define K4_TICK_START long long tick_ = clock64()
#define K4_TICK(i)                                                        \
  do {                                                                    \
    const long long now_ = clock64();                                     \
    if ((threadIdx.x & 31) == 0)                                          \
      atomicAdd(&k4_prof[i], static_cast<unsigned long long>(now_ - tick_)); \
    tick_ = clock64();                                                    \
  } while (0)
#else
#define K4_TICK_START
#define K4_TICK(i)
#endif

// Order (i), x resident: a block quantizes its 32 MT rows of x, all K
// columns, into shared memory once, then walks tiles_per_group column tiles
// of 32 NT columns, streaming w through the ring; the (column tile, k step)
// pairs run as one sequence, so the ring never drains between tiles. 8 warps
// as 2 x 4, a warp 16 MT rows x 8 NT columns. One barrier a stage.
template <int KIND, typename IN_T, int MT, int NT>
__global__ void __launch_bounds__(RES_THREADS, 2)
fq_gemm_mma_res(const MmaArgs a) {
  constexpr bool kInt = sizeof(IN_T) == 4;
  constexpr int BM_ = 32 * MT, BN_ = 32 * NT, STAGE = BN_ * M_BK;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __shared__ float tab[TABLE];
  const int K16 = (a.K + 15) & ~15;  // the products run in k16 steps
  const int lda_s = K16 + 8;         // an odd number of 16-byte chunks a row
  const int nk = (a.K + M_BK - 1) / M_BK;
  __nv_bfloat16* A_s = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* ring = A_s + BM_ * lda_s;
  float* st = reinterpret_cast<float*>(ring + RES_STAGES * STAGE) +
              (threadIdx.x >> 5) * 8 * (8 * NT + 8);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int row0 = blockIdx.x * BM_;
  const int n_ct = (a.O + BN_ - 1) / BN_;
  const int ct0 = blockIdx.y * a.tiles_per_group;
  const int ct1 = min(ct0 + a.tiles_per_group, n_ct);
  const int n_it = (ct1 - ct0) * nk;

  K4_TICK_START;
  // the loader runs RES_STAGES - 1 stages ahead of the products
  int l_ct = ct0, l_kc = 0;
  auto load_next = [&](int slot) {
    if (l_ct < ct1) {
      load_w_stage<BN_, RES_THREADS>(ring + slot * STAGE, a.w_op, l_ct * BN_,
                                     l_kc * M_BK, a.O, a.K, K16, a.vec_w);
      if (++l_kc == nk) {
        l_kc = 0;
        ++l_ct;
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < RES_STAGES - 1; ++s) load_next(s);

  const MmaQuant m = setup_quant<KIND, kInt>(a.prm, a.bits, tab);
  stage_x_tile<KIND, IN_T, BM_>(A_s, static_cast<const IN_T*>(a.x), row0, a.T,
                                a.K, K16, a.lda, lda_s, a.vec_x, m, tab);
  const float a_scale = activation_scale<KIND>(m.p);

  // the warp's rows of the row tile and its columns of a ring stage
  const uint32_t a_u32 = smem_u32(A_s + wm * 16 * MT * lda_s);
  const uint32_t b_u32 = smem_u32(ring + wn * 8 * NT * M_BK);
  float acc[MT][NT][4];
  ColConsts<IN_T, NT> cc;
  zero_acc(acc);
  load_col_consts<IN_T, NT>(cc, a, ct0 * BN_ + wn * 8 * NT, lane);
  K4_TICK(0);
  int ct = ct0, kc = 0;
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<RES_STAGES - 2>();   // this thread's copies of stage it
    __syncthreads();                   // everyone's; and stage it - 1 is free
    K4_TICK(1);
    load_next((it + RES_STAGES - 1) % RES_STAGES);
    K4_TICK(2);
    mma_stage<MT, NT, false>(
        acc, a_u32 + kc * M_BK * 2, lda_s,
        b_u32 + (it % RES_STAGES) * STAGE * 2, lane,
        min(M_BK, K16 - kc * M_BK) / 16);
    K4_TICK(3);
    if (++kc == nk) {
      store_tile<IN_T, MT, NT>(acc, a, row0 + wm * 16 * MT,
                               ct * BN_ + wn * 8 * NT, cc, a_scale, st, lane);
      zero_acc(acc);
      kc = 0;
      if (++ct < ct1)
        load_col_consts<IN_T, NT>(cc, a, ct * BN_ + wn * 8 * NT, lane);
      K4_TICK(5);
    }
  }
  cp_async_wait<0>();
}

// Order (ii), wide N: K is long and O is not (fc2). k outermost: a ring
// stage holds 64 columns of raw x for the block's 64 rows and of w for its
// 384 output columns; each thread quantizes the 16-byte pieces of raw x
// that it copied itself (so no barrier stands between the copy and the
// quantizer) into a double-buffered operand tile, while the products of the
// stage before run. 16 warps as 2 x 8, a warp 32 rows x 48 columns. One
// barrier a stage.
template <int KIND, typename IN_T>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
fq_gemm_mma_wide(const MmaArgs a) {
  constexpr bool kInt = sizeof(IN_T) == 4;
  constexpr int E = 16 / sizeof(IN_T);         // elements of a 16-byte piece
  constexpr int PPR = M_BK / E;                // pieces a row of a stage
  constexpr int PPT = WIDE_BM * PPR / WIDE_THREADS;   // pieces a thread
  constexpr int W_STAGE = WIDE_BN * M_BK;      // bf16 elements
  constexpr int X_STAGE = WIDE_BM * M_BK;      // IN_T elements
  constexpr int A_TILE = WIDE_BM * M_BK;       // bf16 elements
  static_assert(WIDE_BM * PPR % WIDE_THREADS == 0, "whole pieces a thread");
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __shared__ float tab[TABLE];
  __shared__ float col_scale[WIDE_BN];
  __shared__ IN_T col_bias[WIDE_BN];
  __nv_bfloat16* w_ring = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* a_op = w_ring + WIDE_STAGES * W_STAGE;
  IN_T* x_ring = reinterpret_cast<IN_T*>(a_op + 2 * A_TILE);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 3, wn = warp & 7;
  const int row0 = blockIdx.x * WIDE_BM, col0 = blockIdx.y * WIDE_BN;
  const int K16 = (a.K + 15) & ~15;
  const int nk = (a.K + M_BK - 1) / M_BK;
  const IN_T* x = static_cast<const IN_T*>(a.x);

  K4_TICK_START;
  // this thread's pieces of a stage's raw x, settled once: piece i is row
  // pr, columns pk .. pk + E - 1 of the stage; where it comes from in x,
  // where it lies in a ring stage and where its operands go in a tile
  const IN_T* x_src[PPT];
  int x_k[PPT], x_off[PPT], a_off[PPT];
  bool x_row_ok[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int piece = threadIdx.x + i * WIDE_THREADS;
    const int pr = piece / PPR, pk = piece % PPR * E;
    x_k[i] = pk;
    x_off[i] = pr * M_BK + pk;
    a_off[i] = swz(pr, pk >> 3) + (pk & 7);
    x_row_ok[i] = row0 + pr < a.T;
    x_src[i] = x + static_cast<size_t>(row0 + pr) * a.lda + pk;
  }

  auto load_stage = [&](int kc) {
    if (kc < nk) {
      const int slot = kc % WIDE_STAGES;
      load_w_stage<WIDE_BN, WIDE_THREADS>(w_ring + slot * W_STAGE, a.w_op, col0,
                                          kc * M_BK, a.O, a.K, K16, a.vec_w);
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const int k = kc * M_BK + x_k[i];
        if (k >= K16) continue;
        IN_T* dst = x_ring + slot * X_STAGE + x_off[i];
        const bool ok = x_row_ok[i] && k < a.K;
        const IN_T* src = x_src[i] + kc * M_BK;
        if (a.vec_x) {
          cp_async16(dst, ok ? src : x, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            dst[e] = ok && k + e < a.K ? src[e] : zero_of<IN_T>();
        }
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < WIDE_STAGES - 1; ++s) load_stage(s);

  const MmaQuant m = setup_quant<KIND, kInt>(a.prm, a.bits, tab);
  const float a_scale = activation_scale<KIND>(m.p);
  {
    // the epilogue's column constants, read long before their use
    const IN_T* bias = static_cast<const IN_T*>(a.bias);
    for (int c = threadIdx.x; c < WIDE_BN; c += WIDE_THREADS) {
      const int col = min(col0 + c, a.O - 1);
      if (kInt) col_scale[c] = a.w_scale[col];
      if (bias != nullptr) col_bias[c] = bias[col];
    }
  }

  auto quantize = [&](int kc) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (kc * M_BK + x_k[i] >= K16) continue;
      const IN_T* src = x_ring + (kc % WIDE_STAGES) * X_STAGE + x_off[i];
      __nv_bfloat16* dst = a_op + (kc & 1) * A_TILE + a_off[i];
      if (kInt) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        *reinterpret_cast<uint2*>(dst) = make_uint2(
            pack_bf16(staged<KIND, kInt>(v.x, m, tab),
                      staged<KIND, kInt>(v.y, m, tab)),
            pack_bf16(staged<KIND, kInt>(v.z, m, tab),
                      staged<KIND, kInt>(v.w, m, tab)));
      } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
        float v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[2 * j] = bf16_lo(u[j]);
          v[2 * j + 1] = bf16_hi(u[j]);
        }
        *reinterpret_cast<uint4*>(dst) = stage8<KIND, kInt>(v, m, tab);
      }
    }
  };

  cp_async_wait<WIDE_STAGES - 2>();    // this thread's copies of stage 0
  quantize(0);
  __syncthreads();

  // the warp's rows of an operand tile and its columns of a ring stage
  const uint32_t a_u32 = smem_u32(a_op + wm * 16 * WIDE_MT * M_BK);
  const uint32_t b_u32 = smem_u32(w_ring + wn * 8 * WIDE_NT * M_BK);
  float acc[WIDE_MT][WIDE_NT][4];
  zero_acc(acc);
  K4_TICK(0);
  for (int kc = 0; kc < nk; ++kc) {
    load_stage(kc + WIDE_STAGES - 1);  // into the stage freed by the barrier
    K4_TICK(2);
    mma_stage<WIDE_MT, WIDE_NT, true>(
        acc, a_u32 + (kc & 1) * A_TILE * 2, 0,
        b_u32 + (kc % WIDE_STAGES) * W_STAGE * 2, lane,
        min(M_BK, K16 - kc * M_BK) / 16);
    K4_TICK(3);
    if (kc + 1 < nk) {
      cp_async_wait<WIDE_STAGES - 2>();  // this thread's copies of kc + 1
      K4_TICK(1);
      quantize(kc + 1);
      K4_TICK(4);
    }
    __syncthreads();
    K4_TICK(1);
  }
  cp_async_wait<0>();
  ColConsts<IN_T, WIDE_NT> cc;
#pragma unroll
  for (int nt = 0; nt < WIDE_NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = wn * 8 * WIDE_NT + nt * 8 + 2 * (lane & 3) + e;
      if (kInt) cc.ws[nt][e] = col_scale[c];
      if (a.bias != nullptr) cc.bias[nt][e] = col_bias[c];
    }
  // the ring is idle now (the loop ended in a barrier): its first bytes
  // take the warps' staging rows
  store_tile<IN_T, WIDE_MT, WIDE_NT>(
      acc, a, row0 + wm * 16 * WIDE_MT, col0 + wn * 8 * WIDE_NT, cc, a_scale,
      reinterpret_cast<float*>(w_ring) + warp * 8 * (8 * WIDE_NT + 8), lane);
  K4_TICK(5);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// one call's arguments, as fq_gemm_launch receives them
struct GemmArgs {
  const void *x, *w, *bias, *codes;
  const float *prm, *w_scale;
  void* out;
  int T, K, O, lda, bits, sms;
  cudaStream_t stream;
};

template <int KIND>
cudaError_t launch_fma(int dtype, const GemmArgs& g) {
  const int T = g.T, K = g.K, O = g.O, lda = g.lda;
  const dim3 grid((O + BN - 1) / BN, (T + BM - 1) / BM);
  if (dtype == 0) {
    const bool vec = K % 4 == 0 && lda % 4 == 0 && aligned16(g.x) && aligned16(g.w);
    const bool vec_out = O % 4 == 0 && aligned16(g.out);
    fq_gemm_fma_f32<KIND><<<grid, THREADS, 0, g.stream>>>(
        static_cast<const float*>(g.x), static_cast<const float*>(g.w), g.prm,
        static_cast<const float*>(g.bias), static_cast<float*>(g.out), T, K, O,
        lda, g.bits, vec, vec_out);
  } else {
    const bool vec = K % 8 == 0 && lda % 8 == 0 && aligned16(g.x) && aligned16(g.w);
    const bool vec_out = O % 2 == 0 && (reinterpret_cast<uintptr_t>(g.out) & 3u) == 0;
    fq_gemm_fma_bf16<KIND><<<grid, THREADS, 0, g.stream>>>(
        static_cast<const __nv_bfloat16*>(g.x),
        static_cast<const __nv_bfloat16*>(g.w), g.prm,
        static_cast<const __nv_bfloat16*>(g.bias),
        static_cast<__nv_bfloat16*>(g.out), T, K, O, lda, g.bits, vec, vec_out);
  }
  return cudaGetLastError();
}

// Order (i) with 32 MT rows and 32 NT columns a tile. A block owns a row
// tile; where the row tiles alone leave SMs without a block, the column
// tiles are split over groups of blocks, each of which quantizes the row
// tile again.
template <int KIND, typename IN_T, int MT, int NT>
cudaError_t launch_res(MmaArgs a, const GemmArgs& g) {
  constexpr int BM_ = 32 * MT, BN_ = 32 * NT;
  const int row_tiles = (a.T + BM_ - 1) / BM_, n_ct = (a.O + BN_ - 1) / BN_;
  int groups = std::min(n_ct, std::max(1, (g.sms + row_tiles - 1) / row_tiles));
  a.tiles_per_group = (n_ct + groups - 1) / groups;
  groups = (n_ct + a.tiles_per_group - 1) / a.tiles_per_group;
  const int K16 = (a.K + 15) & ~15;
  const int smem = (BM_ * (K16 + 8) + RES_STAGES * BN_ * M_BK) *
                       static_cast<int>(sizeof(__nv_bfloat16)) +
                   RES_THREADS / 32 * 8 * (8 * NT + 8) *
                       static_cast<int>(sizeof(float));
  auto kernel = fq_gemm_mma_res<KIND, IN_T, MT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(row_tiles, groups), RES_THREADS, smem, g.stream>>>(a);
  return cudaGetLastError();
}

template <int KIND, typename IN_T>
cudaError_t launch_mma(const GemmArgs& g) {
  constexpr bool kInt = sizeof(IN_T) == 4;
  MmaArgs a;
  a.x = g.x;
  a.w_op = static_cast<const __nv_bfloat16*>(kInt ? g.codes : g.w);
  a.prm = g.prm;
  a.bias = g.bias;
  a.w_scale = g.w_scale;
  a.out = g.out;
  a.T = g.T, a.K = g.K, a.O = g.O, a.lda = g.lda, a.bits = g.bits;
  a.tiles_per_group = 1;
  constexpr int E = 16 / sizeof(IN_T);
  a.vec_x = g.K % E == 0 && g.lda % E == 0 && aligned16(g.x);
  a.vec_w = g.K % 8 == 0 && aligned16(a.w_op);
  a.vec_out = g.O % E == 0 && aligned16(g.out);
  if (g.K <= RES_MAX_K) {
    // the head's few rows: a short tile and narrow column tiles, so that
    // its columns spread over more blocks
    if (g.T <= 32) return launch_res<KIND, IN_T, 1, 2>(a, g);
    return launch_res<KIND, IN_T, 2, 4>(a, g);
  }
  constexpr int smem =
      (WIDE_STAGES * WIDE_BN * M_BK + 2 * WIDE_BM * M_BK) *
          static_cast<int>(sizeof(__nv_bfloat16)) +
      WIDE_STAGES * WIDE_BM * M_BK * static_cast<int>(sizeof(IN_T));
  auto kernel = fq_gemm_mma_wide<KIND, IN_T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.T + WIDE_BM - 1) / WIDE_BM, (g.O + WIDE_BN - 1) / WIDE_BN);
  kernel<<<grid, WIDE_THREADS, smem, g.stream>>>(a);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t launch(int variant, int dtype, const GemmArgs& g) {
  if (variant == 0) return launch_fma<KIND>(dtype, g);
  if (dtype == 0) {
    // integer operands: the codes and their scales, and bit widths whose
    // staged values are exact in bf16 (the wrapper routes; this is the
    // kernel's own guard)
    if (g.codes == nullptr || g.w_scale == nullptr ||
        g.bits > (KIND == UNIFORM ? 8 : 7))
      return cudaErrorInvalidValue;
    return launch_mma<KIND, float>(g);
  }
  return launch_mma<KIND, __nv_bfloat16>(g);
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n <= 0)
      n = 132;
    cached[device] = n;
  }
  return cached[device];
}

}  // namespace

#ifdef K4_PROFILE
// the "mma" kernels' cycles summed over warps, by phase (see K4_TICK); then
// all are zeroed
extern "C" int fq_gemm_profile(unsigned long long* host8) {
  cudaError_t err = cudaMemcpyFromSymbol(host8, k4_prof, sizeof(k4_prof));
  if (err != cudaSuccess) return err;
  unsigned long long zero[8] = {};
  return cudaMemcpyToSymbol(k4_prof, zero, sizeof(zero));
}
#endif

// variant: 0 = "fma", 1 = "mma"; dtype: 0 = float32, 1 = bfloat16 (x, w,
// bias and out); kind: 0 = uniform, 1 = adalog_shift. x is (T, K) with row
// stride lda, w (O, K) contiguous, params (4,) fp32 [scale, zero_point,
// shift, log_q] (for adalog_shift, log_q a positive integer with
// (2^bits - 1) * log_q < 2^24), bias (O,) or null, out (T, O) contiguous.
// "mma" with float32 inputs also takes the weight as integers: codes (O, K)
// bf16 holding c_w - z_w and w_scale (O,) fp32 with codes * w_scale == w; it
// does not read w then. The launch goes to ``stream`` of ``device``, which
// is made current for the call where it is not. Returns the CUDA error code
// of the launch.
extern "C" int fq_gemm_launch(int variant, int dtype, int kind, const void* x,
                              const void* w, const void* params,
                              const void* bias, void* out, const void* codes,
                              const void* w_scale, int T, int K, int O, int lda,
                              int bits, int device, void* stream) {
  if ((variant != 0 && variant != 1) || (dtype != 0 && dtype != 1) ||
      (kind != UNIFORM && kind != ADALOG_SHIFT) || bits < 1 || bits > 16 ||
      T <= 0 || O <= 0 || K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  GemmArgs g;
  g.x = x, g.w = w, g.bias = bias, g.codes = codes;
  g.prm = static_cast<const float*>(params);
  g.w_scale = static_cast<const float*>(w_scale);
  g.out = out;
  g.T = T, g.K = K, g.O = O, g.lda = lda, g.bits = bits;
  g.sms = sm_count(device);
  g.stream = static_cast<cudaStream_t>(stream);
  err = kind == UNIFORM ? launch<UNIFORM>(variant, dtype, g)
                        : launch<ADALOG_SHIFT>(variant, dtype, g);
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

// Fused fake-quant attention matmuls for Hopper (sm_90a): kernels K2 and K3
// of the port, one template.
//
// Replaces the TPU kernels adalog_tpu/ops/fq_attn.py::fq_softmax_attn_matmul
// (K2) and ::fq_attn_matmul (K3), which share the Pallas body _kernel. Per
// slice g of G = batch*heads, with A (S, K), B (K, C), out (S, C):
//   K3, uniform A:  out[g] = uq(A[g]) @ uq(B[g])           (q @ kT)
//   K3, AdaLog A:   out[g] = AdaLog1(A[g]) @ uq(B[g])      (probs @ v)
//   K2:             out[g] = AdaLog1(softmax(A[g])) @ uq(B[g])
// with uq the asymmetric uniform fake quantizer and AdaLog1 the AdaLog
// quantizer at scale 1 (fq_quant.cuh). The quantized operands never reach
// device memory, and for K2 neither do the probabilities.
//
// What bounds it: each element of A, B and out crosses device memory once
// (deit_small at batch 32, probs @ v in fp32: 30 MB of A against 0.95
// GFLOP, about 20 operations a byte), so the bytes bound it on the tensor
// cores. What the card really spends is the per-element quantizer of A
// (AdaLog: log2f, a division, a table load; K2 also expf and a division by
// the row sum) and the latency of the loads of A, which nothing hides but
// other warps.
//
// Two variants, both hand-written, chosen by the wrapper
// (ops/fq_attn.py::matmul_variant) from shapes, dtype and bit widths:
//
// "mma": the design for this card, three bodies that share the building
// blocks of fq_flash_attn.cu's variant "mma" (fq_mma.cuh). Common to them:
// mma.sync.aligned.m16n8k16, bf16 x bf16 with fp32 accumulators (mma.sync,
// not wgmma: the products are a few percent of the cycles); a warp owns 16
// rows of A; blocks of 4 warps, one slice a block, the slice's row tiles go
// round the warps (two blocks share a slice where a launch has too few
// slices to fill the card twice); uq(B[g]) staged once a block as bf16 in
// the layout device memory has it ([k][n], rows padded to an odd number of
// 16-byte chunks), with 16-byte loads four in flight, and read as B
// operands with ldmatrix.trans; bf16 inputs: the operands are what the
// plain version rounds to bf16, so nothing is lost; fp32 inputs: the
// operands are integers (c - z of a uniform quantizer, |c - z| <= 256;
// steps * 2^-shift of an AdaLog value, steps <= 254), exact in bf16, and
// the fp32 sum is scaled once (s_a * s_b, or ts * s_b). A sum of integer
// products is exact while max|a| * max|b| * K < 2^24: always for uniform A
// (K <= 128, operands <= 256); with AdaLog A the operands carry 2^-shift,
// so the sum is a rounded fp32 sum like the plain version's, in another
// order (a few ulp apart, within tolerance).
//   - K2 (kernel fq_softmax_matmul_mma): the AdaLog quantizer needs the
//     finished softmax row, so a warp holds all K columns of its 16 rows of
//     logits in registers in the accumulator layout (K <= 256: ceil(K/8) n8
//     tiles, 100 registers a thread at K=197), loaded straight into that
//     layout: a quad reads 32 contiguous bytes of a row, every load has a
//     clamped address and no bounds test before it, so all of a tile's
//     loads are in flight together. Row max and sum by two shuffles in the
//     quad; the division by the sum through the sum's rounded reciprocal,
//     the AdaLog value from the slice's code table (fq_mma.cuh::
//     quantize_tile: no exp2f, no fmodf, no IEEE division sequence); the
//     probabilities are packed to bf16 in place and are the A operands of
//     p @ uq(B).
//   - K3 with AdaLog A (fq_adalog_matmul_mma): no row dependency, so A
//     streams through registers two k16 steps (32 columns) at a time, the
//     next chunk's loads sent before this chunk is quantized and
//     multiplied, the first chunk's before the block stages uq(B), so that
//     the two latencies pass together (K2 cannot: its 100 registers of
//     logits do not live through the staging without spills); K is bounded
//     only by the staging of B.
//   - K3 with uniform A (fq_uniform_matmul_mma; q @ kT): K = head dim <=
//     128 is the short side, C = S the wide one, and the fp32 output is
//     three quarters of the bytes. A warp stages its 16 rows of uq(A) as
//     K1 stages q (16-byte loads; reading A straight into the operand's
//     layout with 4-byte loads was a third slower at a Swin window), keeps
//     their A operands in registers and walks the columns 64 at a time; a
//     chunk's accumulators go through the warp's strip of shared memory and
//     leave as runs of 128 contiguous bytes a store, one row at a time
//     (rows of 197 or 49 floats are only 4-byte aligned, so wider stores do
//     not apply).
//
// "fma" (any K and C whose fp32 staging fits shared memory, any bit
// widths): the first kernel of the port, exact fp32 products on the FMA
// pipes, for what "mma" does not take; one template is all three modes.
//   - one block per (slice g, tile of A rows); blockIdx.x = g * tiles + tile,
//     so G in the thousands (Swin's windows) stays in the x dimension;
//   - the block quantizes B[g] once into dynamic shared memory (fp32 values,
//     rounded to bf16 first when the inputs are bf16);
//   - one warp per A row: the row is loaded into the warp's strip of shared
//     memory, for K2 the row max and sum go through __shfl_xor_sync and the
//     softmax is finished (the AdaLog quantizer needs the finished row),
//     then the quantizer is applied in place;
//   - the C outputs are spread over the lanes, up to 8 columns a lane per
//     pass (256 columns), so C = S = 197 of q @ kT takes one pass and each
//     broadcast A value feeds up to 8 FMAs;
//   - the wrapper picks the tiling (rows a block, warps a block) so that the
//     rows of a tile spread evenly over the warps: S = 49 runs 10 warps for
//     5 rounds, not 12 warps with one busy in the last round;
//   - it is held by shared-memory latency (one 4-byte shared load per FMA
//     per lane, each warp walks one row's dependent loads), and every
//     element of A pays the whole AdaLog quantizer.
// Its loads are scalar and coalesced. Numerics follow the JAX kernel and
// fq_flash_attn.cu: quantizer math in fp32, operands rounded to the compute
// dtype before the product, fp32 accumulation; the softmax is exp(l - max)
// / sum with the sum taken lane-strided then across the warp, exactly as in
// fq_flash_attn.cu's "fma", so K2 "fma" on the logits K1 "fma" forms gives
// K1's output bit for bit.
//
// Parameters are periodic: ap is (a_period, 2) and slice g reads row
// g % a_period (a site's per-head rows, not repeated over the batch), bp
// likewise.

#include "fq_mma.cuh"

namespace {

using namespace fq;

// ---------------------------------------------------------------------------
// variant "fma": fp32 FMA pipes out of shared memory, one warp per row of A
// ---------------------------------------------------------------------------

constexpr int MAX_WARPS = 12;        // must match ops/fq_attn.py _WARPS
constexpr int COLS_PER_LANE = 8;     // output chunk of 256 columns

template <typename T, bool ADALOG, bool SOFTMAX>
__global__ void __launch_bounds__(MAX_WARPS * 32)
fq_attn_matmul_fma_kernel(const T* __restrict__ A, const T* __restrict__ B,
                      const float* __restrict__ ap, const float* __restrict__ bp,
                      float* __restrict__ out, int S, int K, int C, int tiles,
                      int rows_per_block, int a_period, int b_period,
                      int a_bits, int b_bits) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ float smem[];
  float* b_s = smem;                     // (K, C)
  float* a_s = b_s + K * C;              // (warps, K)

  const int g = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * rows_per_block;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int ga = g % a_period, gb = g % b_period;
  const float a0 = ap[2 * ga], az = rintf(ap[2 * ga + 1]);
  const float bs = bp[2 * gb], bz = rintf(bp[2 * gb + 1]);
  const float amax = qmax_of(a_bits), bmax = qmax_of(b_bits);
  const float n2 = static_cast<float>(2 * (1 << (a_bits - 1)));
  const float ts = static_cast<float>(1.0 / (2.0 * n2 - 2.0));

  // stage uq(B[g]): one contiguous run of K*C elements
  const T* Bg = B + static_cast<size_t>(g) * K * C;
#pragma unroll 4
  for (int i = threadIdx.x; i < K * C; i += blockDim.x) {
    float x = uq(to_f32(Bg[i]), bs, bz, bmax);
    b_s[i] = kBf16 ? round_bf16(x) : x;
  }
  __syncthreads();

  float* arow = a_s + warp * K;
  const int row_end = min(row0 + rows_per_block, S);

  for (int r = row0 + warp; r < row_end; r += warps) {
    const T* Ar = A + (static_cast<size_t>(g) * S + r) * K;
    if (SOFTMAX) {
      float mx = -INFINITY;
      for (int j = lane; j < K; j += 32) {
        const float l = to_f32(Ar[j]);
        arow[j] = l;
        mx = fmaxf(mx, l);
      }
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int j = lane; j < K; j += 32) {
        const float e = expf(arow[j] - mx);
        arow[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < K; j += 32) {
        const float p = adalog_unit(__fdiv_rn(arow[j], sum), a0, n2, ts);
        arow[j] = kBf16 ? round_bf16(p) : p;
      }
    } else {
      for (int j = lane; j < K; j += 32) {
        const float x = to_f32(Ar[j]);
        const float xq = ADALOG ? adalog_unit(x, a0, n2, ts)
                                : uq(x, a0, az, amax);
        arow[j] = kBf16 ? round_bf16(xq) : xq;
      }
    }
    __syncwarp();

    float* orow = out + (static_cast<size_t>(g) * S + r) * C;
    for (int c0 = 0; c0 < C; c0 += 32 * COLS_PER_LANE) {
      float acc[COLS_PER_LANE];
#pragma unroll
      for (int c = 0; c < COLS_PER_LANE; ++c) acc[c] = 0.0f;
      const float* bcol = b_s + c0 + lane;
      const int ncol = (C - c0 - lane + 31) / 32;   // columns of this lane
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float a = arow[k];
        const float* brow = bcol + k * C;
#pragma unroll
        for (int c = 0; c < COLS_PER_LANE; ++c)
          if (c < ncol) acc[c] = fmaf(a, brow[32 * c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < COLS_PER_LANE; ++c)
        if (c < ncol) orow[c0 + lane + 32 * c] = acc[c];
    }
    __syncwarp();                              // arow reused next row
  }
}

// one call's arguments, as fq_attn_matmul_launch receives them
struct MatmulArgs {
  const void *A, *B;
  const float *ap, *bp;
  float* out;
  int G, S, K, C, a_period, b_period, rows_per_block, warps, a_bits, b_bits;
  cudaStream_t stream;
};

template <typename T, bool ADALOG, bool SOFTMAX>
cudaError_t launch_fma(const MatmulArgs& a) {
  if (a.rows_per_block < 1 || a.warps < 1 || a.warps > MAX_WARPS)
    return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(a.K * a.C + a.warps * a.K) * sizeof(float);
  auto kernel = fq_attn_matmul_fma_kernel<T, ADALOG, SOFTMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (a.S + a.rows_per_block - 1) / a.rows_per_block;
  const long long blocks = static_cast<long long>(a.G) * tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), a.warps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.A), static_cast<const T*>(a.B), a.ap, a.bp,
      a.out, a.S, a.K, a.C, tiles, a.rows_per_block, a.a_period, a.b_period,
      a.a_bits, a.b_bits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma_mode(int mode, const MatmulArgs& a) {
  if (mode == 0) return launch_fma<T, false, false>(a);
  if (mode == 1) return launch_fma<T, true, false>(a);
  if (mode == 2) return launch_fma<T, true, true>(a);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// variant "mma": tensor cores, a warp owns 16 rows of A
// ---------------------------------------------------------------------------

// Warps a block. Few, so that several blocks share an SM and one block's
// staging (global-load latency, a barrier) hides behind the others'
// arithmetic.
constexpr int MMA_WARPS = 4;
// Below this many slices (two waves of 132 SMs) a launch of one-slice blocks
// leaves SMs idle, and two blocks share a slice's row tiles.
constexpr int SPLIT_BELOW = 264;
constexpr size_t MAX_SMEM = 232448;  // must match ops/fq_attn.py

// With -DK23_PROFILE the "mma" kernels sum their warps' cycles by phase
// (clock64 at the K23_TICK marks) into k23_prof; fq_attn_matmul_profile
// reads it. The shipped build has none of it.
#ifdef K23_PROFILE
__device__ unsigned long long k23_prof[8];
#define K23_START() long long tick_ = clock64()
#define K23_TICK(i)                                                        \
  do {                                                                     \
    const long long now_ = clock64();                                      \
    if ((threadIdx.x & 31) == 0)                                           \
      atomicAdd(&k23_prof[i], static_cast<unsigned long long>(now_ - tick_)); \
    tick_ = clock64();                                                     \
  } while (0)
#else
#define K23_START()
#define K23_TICK(i)
#endif

// The output side of the two AdaLog bodies: DT k16-wide steps over the
// (padded) columns of B and of the output, C <= 16 DT.
template <int DT>
struct OutTile {
  static constexpr int DN = 2 * DT;          // n8 tiles of a row of output
  static constexpr int C_PAD = 16 * DT;
  // a shared-memory row of uq(B) in bf16 elements: an odd number of 16-byte
  // chunks, so the 8 rows of an ldmatrix tile fall into different banks
  static constexpr int B_LD = C_PAD + 8;     // uq(B): [K_PAD][B_LD]
};

// What the warps of an AdaLog body read from shared memory behind uq(B):
// the slice's code table and the scale of the output (ts * s_b for fp32
// inputs, whose operands are steps * 2^-shift and c - z; 1 for bf16).
struct AdalogConsts {
  CodeTable codes;
  float out_scale;
};

// Rows K..k_pad-1 of uq(B)'s staging meet operands of A that are exactly 0,
// and 0 * NaN is NaN: zeros. (The columns past C are left as they are: they
// feed output columns that are never stored.) No thread stages into these
// rows, so no barrier separates the two.
__device__ __forceinline__ void zero_pad_rows(__nv_bfloat16* B_s, int ld,
                                              int K, int k_pad) {
  uint4* pad16 = reinterpret_cast<uint4*>(B_s + K * ld);    // ld * 2 % 16 == 0
  const int n16 = (k_pad - K) * ld / 8;
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    pad16[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Stage uq(B[g]) and fill the slice's constants behind it.
template <typename T, int DT>
__device__ __forceinline__ const AdalogConsts* stage_adalog_slice(
    __nv_bfloat16* B_s, int k_pad, const T* __restrict__ Bg,
    const float* __restrict__ ap, const float* __restrict__ bp, int ga, int gb,
    int K, int C, int a_bits, int b_bits) {
  constexpr bool kInt = sizeof(T) == 4;
  using O = OutTile<DT>;
  zero_pad_rows(B_s, O::B_LD, K, k_pad);
  stage_rows<kInt, O::B_LD, 4>(B_s, Bg, K * C, C, uniform_of(bp, gb, b_bits),
                               threadIdx.x, blockDim.x);
  AdalogConsts* ac = reinterpret_cast<AdalogConsts*>(B_s + k_pad * O::B_LD);
  const int n_codes = 2 * (1 << (a_bits - 1));
  const float ts = static_cast<float>(1.0 / (2.0 * n_codes - 2.0));
  fill_code_table<kInt>(&ac->codes, ap[2 * ga], n_codes, ts, threadIdx.x,
                        blockDim.x);
  if (threadIdx.x == blockDim.x - 1)
    ac->out_scale = kInt ? __fmul_rn(ts, bp[2 * gb]) : 1.0f;
  __syncthreads();
  return ac;
}

// One k16 step of p @ uq(B): the A operand a against the 16 rows of uq(B)
// from b_addr (the lane's ldmatrix address in the step's first n16 tile) on.
template <int DT>
__device__ __forceinline__ void mma_b_rows(float (&o)[2 * DT][4],
                                           const uint32_t* a,
                                           uint32_t b_addr) {
#pragma unroll
  for (int dn = 0; dn < 2 * DT; dn += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, b_addr + dn * 8 * 2);
    mma_bf16(o[dn], a, b);
    mma_bf16(o[dn + 1], a, b + 2);
  }
}

// A warp's 16 x C tile of the output from its accumulators: rows ra and rb
// of the slice whose output starts at out_g; pairs of floats where C is
// even (8-byte aligned), else one at a time.
template <bool kInt, int DT>
__device__ __forceinline__ void store_out_tile(const float (&o)[2 * DT][4],
                                               float out_scale,
                                               float* __restrict__ out_g,
                                               int ra, int rb, int S, int C,
                                               int t4) {
  float* out_a = out_g + static_cast<size_t>(ra) * C;
  float* out_b = out_g + static_cast<size_t>(rb) * C;
  const bool c_even = (C & 1) == 0;
#pragma unroll
  for (int dn = 0; dn < 2 * DT; ++dn) {
    const int c = 8 * dn + 2 * t4;
    float w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = kInt ? __fmul_rn(o[dn][e], out_scale) : o[dn][e];
    if (c_even) {
      if (c < C) {
        if (ra < S) *reinterpret_cast<float2*>(out_a + c) = make_float2(w[0], w[1]);
        if (rb < S) *reinterpret_cast<float2*>(out_b + c) = make_float2(w[2], w[3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e < C && ra < S) out_a[c + e] = w[e];
        if (c + e < C && rb < S) out_b[c + e] = w[2 + e];
      }
    }
  }
}

// A thread's share of N n8 tiles of its two rows of A from column col0 on,
// in the accumulator layout: v[n][e] is row a, column col0 + 8 n + 2 t4 + e,
// v[n][2 + e] the same of row b. A tile inside the row (the same test for
// the whole warp) is read at constant offsets from the thread's pointers,
// a tile across or past the row's end at addresses clamped to the row; the
// caller masks or zeroes what lies past K.
template <int N, typename T>
__device__ __forceinline__ void load_row_tiles(float (&v)[N][4],
                                               const T* __restrict__ Aa,
                                               const T* __restrict__ Ab,
                                               int K, int t4, int col0 = 0) {
  const T* pa = Aa + col0 + 2 * t4;
  const T* pb = Ab + col0 + 2 * t4;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (col0 + 8 * n + 8 <= K) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[n][e] = to_f32(pa[8 * n + e]);
        v[n][2 + e] = to_f32(pb[8 * n + e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = min(col0 + 8 * n + 2 * t4 + e, K - 1);
        v[n][e] = to_f32(Aa[c]);
        v[n][2 + e] = to_f32(Ab[c]);
      }
    }
  }
}

// Row r of a slice's (S, K) matrix; past the last row, the last row again.
template <typename T>
__device__ __forceinline__ const T* row_of(const T* __restrict__ Ag, int r,
                                           int S, int K) {
  return Ag + static_cast<size_t>(min(r, S - 1)) * K;
}

// --- K2: row softmax, AdaLog, @ uq(B) --------------------------------------

// NT n8 tiles over the K columns of a row of logits (K <= 8 NT; an odd NT
// saves the registers and the quantizer's work of a tile that would be all
// padding: K=197 takes 25 tiles, K=49 takes 7). Blocks an SM, which caps the
// registers a thread: 4 NT of them hold the logits, then 2 NT the packed
// probabilities beside 8 DT of output.
template <int NT, int DT>
struct SoftmaxTile {
  static constexpr int MIN_BLOCKS =
      NT >= 32 ? 2 : NT >= 25 ? (DT >= 8 ? 2 : 3)
               : NT >= 16 ? (DT >= 8 ? 3 : 4) : (DT >= 8 ? 3 : DT >= 4 ? 4 : 5);
};

template <typename T, int NT, int DT>
__global__ void __launch_bounds__(MMA_WARPS * 32, SoftmaxTile<NT, DT>::MIN_BLOCKS)
fq_softmax_matmul_mma_kernel(const T* __restrict__ L, const T* __restrict__ B,
                             const float* __restrict__ ap,
                             const float* __restrict__ bp,
                             float* __restrict__ out, int S, int K, int C,
                             int a_period, int b_period, int a_bits,
                             int b_bits) {
  using O = OutTile<DT>;
  constexpr int KT = (NT + 1) / 2;             // k16 steps of p @ uq(B)
  constexpr bool kInt = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* B_s = reinterpret_cast<__nv_bfloat16*>(smem_mma);

  K23_START();
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;     // row of the quad, lane in it
  const int ld_row = lane & 15, ld_col = (lane >> 4) * 8;
  const T* Lg = L + static_cast<size_t>(g) * S * K;
  float* out_g = out + static_cast<size_t>(g) * S * C;

  const AdalogConsts* ac = stage_adalog_slice<T, DT>(
      B_s, 16 * KT, B + static_cast<size_t>(g) * K * C, ap, bp, g % a_period,
      g % b_period, K, C, a_bits, b_bits);
  K23_TICK(0);

  // the slice's row tiles go round the warps of the gridDim.y blocks that
  // share the slice
  for (int r0 = 16 * (warp + MMA_WARPS * blockIdx.y); r0 < S;
       r0 += 16 * MMA_WARPS * gridDim.y) {
    // logits: 16 rows x 8 NT columns in registers, in the accumulator
    // layout. acc[nt][0..1] are row ra, columns 8 nt + 2 t4 + {0, 1};
    // acc[nt][2..3] the same of row rb. No load waits behind a bounds test:
    // rows past S repeat the last row and are never stored; a tile that
    // lies inside the row is read at constant offsets from the thread's
    // two row pointers (no address arithmetic, no registers for it), the
    // row's last tiles at clamped addresses, masked below.
    const int ra = r0 + gq, rb = ra + 8;
    float acc[NT][4];
    load_row_tiles<NT>(acc, row_of(Lg, ra, S, K), row_of(Lg, rb, S, K), K, t4);
    K23_TICK(1);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (8 * nt + 8 > K) {            // the same for the whole warp
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * nt + 2 * t4 + e >= K) {
            acc[nt][e] = -INFINITY;
            acc[nt][2 + e] = -INFINITY;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx_a = fmaxf(mx_a, acc[nt][e]);
        mx_b = fmaxf(mx_b, acc[nt][2 + e]);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    K23_TICK(2);

    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ea = expf(acc[nt][e] - mx_a);
        const float eb = expf(acc[nt][2 + e] - mx_b);
        acc[nt][e] = ea;
        acc[nt][2 + e] = eb;
        sum_a += ea;
        sum_b += eb;
      }
    }
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
    K23_TICK(3);

    // AdaLog: the code by arithmetic, its value from the slice's table;
    // packed to bf16 as the A operands of p @ uq(B)
    const Divisor div_a{sum_a, __frcp_rn(sum_a)};
    const Divisor div_b{sum_b, __frcp_rn(sum_b)};
    uint32_t pa[KT][4];
    pa[KT - 1][2] = pa[KT - 1][3] = 0u;        // an odd NT: the tile left out
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 h = quantize_tile(acc[nt][0], acc[nt][1], acc[nt][2],
                                    acc[nt][3], div_a, div_b, &ac->codes,
                                    K - (8 * nt + 2 * t4));
      pa[nt >> 1][2 * (nt & 1)] = h.x;
      pa[nt >> 1][2 * (nt & 1) + 1] = h.y;
    }
    K23_TICK(4);

    float o[O::DN][4];
#pragma unroll
    for (int dn = 0; dn < O::DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      mma_b_rows<DT>(o, pa[kk],
                     smem_addr(B_s + (kk * 16 + ld_row) * O::B_LD + ld_col));
    K23_TICK(5);
    store_out_tile<kInt, DT>(o, ac->out_scale, out_g, ra, rb, S, C, t4);
    K23_TICK(6);
  }
}

// --- K3 with AdaLog A: AdaLog(A) @ uq(B), A streamed ------------------------

// k16 steps of A in registers at a time: two (16 values a thread, and 16 of
// the next chunk in flight) keep a thread under 150 registers, so that 3 to
// 5 blocks share an SM; with four a Swin window's call took 8% longer
constexpr int CHUNK = 2;

template <typename T, int DT>
__global__ void __launch_bounds__(MMA_WARPS * 32, 3)
fq_adalog_matmul_mma_kernel(const T* __restrict__ A, const T* __restrict__ B,
                            const float* __restrict__ ap,
                            const float* __restrict__ bp,
                            float* __restrict__ out, int S, int K, int C,
                            int a_period, int b_period, int a_bits,
                            int b_bits) {
  using O = OutTile<DT>;
  constexpr bool kInt = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* B_s = reinterpret_cast<__nv_bfloat16*>(smem_mma);

  K23_START();
  const int g = blockIdx.x;
  const int kt = (K + 15) / 16;                // k16 steps of the product
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int ld_row = lane & 15, ld_col = (lane >> 4) * 8;
  const T* Ag = A + static_cast<size_t>(g) * S * K;
  float* out_g = out + static_cast<size_t>(g) * S * C;

  // n8 tile 2 s + h of a chunk is half h of the A operand of its k16 step
  // s. The first chunk of a warp's first tile is sent for before the slice
  // is staged, so that the two latencies pass together.
  const int r_first = 16 * (warp + MMA_WARPS * blockIdx.y);
  float cur[2 * CHUNK][4], nxt[2 * CHUNK][4];
  if (r_first < S)
    load_row_tiles<2 * CHUNK>(cur, row_of(Ag, r_first + gq, S, K),
                              row_of(Ag, r_first + gq + 8, S, K), K, t4);
  const AdalogConsts* ac = stage_adalog_slice<T, DT>(
      B_s, 16 * kt, B + static_cast<size_t>(g) * K * C, ap, bp, g % a_period,
      g % b_period, K, C, a_bits, b_bits);
  K23_TICK(0);

  for (int r0 = r_first; r0 < S; r0 += 16 * MMA_WARPS * gridDim.y) {
    const int ra = r0 + gq, rb = ra + 8;
    const T* Aa = row_of(Ag, ra, S, K);
    const T* Ab = row_of(Ag, rb, S, K);
    float o[O::DN][4];
#pragma unroll
    for (int dn = 0; dn < O::DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;

    // the next chunk's loads are sent before this chunk is quantized and
    // multiplied
    if (r0 != r_first) load_row_tiles<2 * CHUNK>(cur, Aa, Ab, K, t4);
    for (int kk0 = 0; kk0 < kt; kk0 += CHUNK) {
      K23_TICK(1);
      if (kk0 + CHUNK < kt) {
        load_row_tiles<2 * CHUNK>(nxt, Aa, Ab, K, t4, 16 * (kk0 + CHUNK));
      } else {
#pragma unroll
        for (int n = 0; n < 2 * CHUNK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) nxt[n][e] = 0.0f;
      }
#pragma unroll
      for (int s = 0; s < CHUNK; ++s) {
        const int kk = kk0 + s;
        if (kk < kt) {
          uint32_t a[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c0 = 16 * kk + 8 * h;    // the n8 tile's first column
            uint2 p = make_uint2(0u, 0u);
            if (c0 < K)
              p = quantize_probs(cur[2 * s + h][0], cur[2 * s + h][1],
                                 cur[2 * s + h][2], cur[2 * s + h][3],
                                 &ac->codes, K - (c0 + 2 * t4));
            a[2 * h] = p.x;
            a[2 * h + 1] = p.y;
          }
          K23_TICK(4);
          mma_b_rows<DT>(o, a,
                         smem_addr(B_s + (kk * 16 + ld_row) * O::B_LD + ld_col));
          K23_TICK(5);
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * CHUNK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) cur[n][e] = nxt[n][e];
    }
    store_out_tile<kInt, DT>(o, ac->out_scale, out_g, ra, rb, S, C, t4);
    K23_TICK(6);
  }
}

// --- K3 with uniform A: uq(A) @ uq(B), the output the wide side -------------

constexpr int OUT_CHUNK = 64;        // output columns of a warp at a time
constexpr int OUT_LD = OUT_CHUNK + 8;  // floats a row of the warp's strip:
                                       // rows 8 banks apart, so a half-warp's
                                       // 8-byte writes fall into 32 banks

// DT k16 steps over the (padded) K = head dim of A; uq(B) is [16 DT][b_ld]
// with b_ld = c_pad + 8 (c_pad = C rounded up to 16: an odd number of
// 16-byte chunks a row), then a [16][A_LD] tile of uq(A) a warp, then a
// [16][OUT_LD] fp32 strip a warp.
template <int DT>
struct UniformTile {
  static constexpr int K_PAD = 16 * DT;
  static constexpr int A_LD = K_PAD + 8;
  static constexpr int A_ELEMS = 16 * A_LD;
};

template <typename T, int DT>
__global__ void __launch_bounds__(MMA_WARPS * 32, 4)
fq_uniform_matmul_mma_kernel(const T* __restrict__ A, const T* __restrict__ B,
                             const float* __restrict__ ap,
                             const float* __restrict__ bp,
                             float* __restrict__ out, int S, int K, int C,
                             int c_pad, int a_period, int b_period, int a_bits,
                             int b_bits) {
  using U = UniformTile<DT>;
  constexpr bool kInt = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int b_ld = c_pad + 8;
  __nv_bfloat16* B_s = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* a_tiles = B_s + U::K_PAD * b_ld;
  float* o_strips = reinterpret_cast<float*>(a_tiles + MMA_WARPS * U::A_ELEMS);

  K23_START();
  const int g = blockIdx.x;
  const int ga = g % a_period, gb = g % b_period;
  // zeros where no thread stages: the padded rows of uq(B) and, for their
  // padded columns, the warps' uq(A) tiles (written again only behind the
  // barrier below)
  zero_pad_rows(B_s, b_ld, K, U::K_PAD);
  {
    uint4* tiles16 = reinterpret_cast<uint4*>(a_tiles);
    for (int i = threadIdx.x; i < MMA_WARPS * U::A_ELEMS / 8; i += blockDim.x)
      tiles16[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  stage_rows_ld<kInt, 4>(B_s, b_ld, B + static_cast<size_t>(g) * K * C, K * C,
                         C, uniform_of(bp, gb, b_bits), threadIdx.x,
                         blockDim.x);
  __syncthreads();
  K23_TICK(0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int ld_row = lane & 15, ld_col = (lane >> 4) * 8;
  const Uniform uq_a = uniform_of(ap, ga, a_bits);
  // fp32 inputs: the integer sums times s_a * s_b
  const float scale = kInt ? __fmul_rn(ap[2 * ga], bp[2 * gb]) : 1.0f;
  __nv_bfloat16* A_s = a_tiles + warp * U::A_ELEMS;
  float* O_s = o_strips + warp * 16 * OUT_LD;
  const T* Ag = A + static_cast<size_t>(g) * S * K;
  float* out_g = out + static_cast<size_t>(g) * S * C;

  for (int r0 = 16 * (warp + MMA_WARPS * blockIdx.y); r0 < S;
       r0 += 16 * MMA_WARPS * gridDim.y) {
    // this warp's 16 rows of uq(A); past the last row of the slice the
    // tile keeps what it held, rows that are computed and never stored
    stage_rows<kInt, U::A_LD, 4>(A_s, Ag + static_cast<size_t>(r0) * K,
                                 min(16, S - r0) * K, K, uq_a, lane, 32);
    __syncwarp();
    uint32_t a[DT][4];
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      const __nv_bfloat16* qa = A_s + gq * U::A_LD + kk * 16 + 2 * t4;
      a[kk][0] = lds32(qa);
      a[kk][1] = lds32(qa + 8 * U::A_LD);
      a[kk][2] = lds32(qa + 8);
      a[kk][3] = lds32(qa + 8 * U::A_LD + 8);
    }
    __syncwarp();                      // A_s is rewritten for the next tile
    K23_TICK(1);

    for (int c0 = 0; c0 < C; c0 += OUT_CHUNK) {
      float acc[OUT_CHUNK / 8][4];
#pragma unroll
      for (int nt = 0; nt < OUT_CHUNK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        const uint32_t b_addr =
            smem_addr(B_s + (kk * 16 + ld_row) * b_ld + c0 + ld_col);
#pragma unroll
        for (int nt = 0; nt < OUT_CHUNK / 8; nt += 2) {
          if (c0 + 8 * nt < c_pad) {           // the same for the whole warp
            uint32_t b[4];
            ldmatrix_x4_trans(b, b_addr + nt * 8 * 2);
            mma_bf16(acc[nt], a[kk], b);
            mma_bf16(acc[nt + 1], a[kk], b + 2);
          }
        }
      }
      K23_TICK(5);
      // through the warp's strip, so that a store covers 128 contiguous
      // bytes of one row
#pragma unroll
      for (int nt = 0; nt < OUT_CHUNK / 8; ++nt) {
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = kInt ? __fmul_rn(acc[nt][e], scale) : acc[nt][e];
        float* oa = O_s + gq * OUT_LD + 8 * nt + 2 * t4;
        *reinterpret_cast<float2*>(oa) = make_float2(w[0], w[1]);
        *reinterpret_cast<float2*>(oa + 8 * OUT_LD) = make_float2(w[2], w[3]);
      }
      __syncwarp();
      const int ncols = min(OUT_CHUNK, C - c0);
      const int rows = min(16, S - r0);
      float* dst = out_g + static_cast<size_t>(r0) * C + c0 + lane;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        if (lane < ncols) dst[static_cast<size_t>(r) * C] = O_s[r * OUT_LD + lane];
        if (lane + 32 < ncols)
          dst[static_cast<size_t>(r) * C + 32] = O_s[r * OUT_LD + lane + 32];
      }
      __syncwarp();                    // the strip is rewritten next chunk
      K23_TICK(6);
    }
  }
}

// two blocks share a slice's row tiles where a launch has few slices of
// many tiles (deit_small at batch 32: 192 on 132 SMs), each staging uq(B)
// for itself
int slice_split(int G, int S) {
  const int tiles = (S + 15) / 16;
  return G < SPLIT_BELOW && tiles >= 2 * MMA_WARPS ? 2 : 1;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int NT, int DT>
cudaError_t launch_softmax_mma(const MatmulArgs& a) {
  auto kernel = fq_softmax_matmul_mma_kernel<T, NT, DT>;
  const size_t smem =
      static_cast<size_t>(16 * ((NT + 1) / 2)) * OutTile<DT>::B_LD * 2 +
      sizeof(AdalogConsts);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.G, slice_split(a.G, a.S)), MMA_WARPS * 32, smem, a.stream>>>(
      static_cast<const T*>(a.A), static_cast<const T*>(a.B), a.ap, a.bp,
      a.out, a.S, a.K, a.C, a.a_period, a.b_period, a.a_bits, a.b_bits);
  return cudaGetLastError();
}

template <typename T, int DT>
cudaError_t launch_adalog_mma(const MatmulArgs& a) {
  auto kernel = fq_adalog_matmul_mma_kernel<T, DT>;
  const size_t smem =
      static_cast<size_t>(16 * ((a.K + 15) / 16)) * OutTile<DT>::B_LD * 2 +
      sizeof(AdalogConsts);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.G, slice_split(a.G, a.S)), MMA_WARPS * 32, smem, a.stream>>>(
      static_cast<const T*>(a.A), static_cast<const T*>(a.B), a.ap, a.bp,
      a.out, a.S, a.K, a.C, a.a_period, a.b_period, a.a_bits, a.b_bits);
  return cudaGetLastError();
}

template <typename T, int DT>
cudaError_t launch_uniform_mma(const MatmulArgs& a) {
  using U = UniformTile<DT>;
  auto kernel = fq_uniform_matmul_mma_kernel<T, DT>;
  const int c_pad = 16 * ((a.C + 15) / 16);
  const size_t smem =
      static_cast<size_t>(U::K_PAD) * (c_pad + 8) * 2 +
      static_cast<size_t>(MMA_WARPS) * (U::A_ELEMS * 2 + 16 * OUT_LD * 4);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.G, slice_split(a.G, a.S)), MMA_WARPS * 32, smem, a.stream>>>(
      static_cast<const T*>(a.A), static_cast<const T*>(a.B), a.ap, a.bp,
      a.out, a.S, a.K, a.C, c_pad, a.a_period, a.b_period, a.a_bits,
      a.b_bits);
  return cudaGetLastError();
}

template <typename T, int NT>
cudaError_t launch_softmax_mma_c(const MatmulArgs& a) {
  if (a.C <= 32) return launch_softmax_mma<T, NT, 2>(a);
  if (a.C <= 64) return launch_softmax_mma<T, NT, 4>(a);
  if (a.C <= 128) return launch_softmax_mma<T, NT, 8>(a);
  return cudaErrorInvalidValue;
}

// must match ops/fq_attn.py::matmul_mma_refusal: codes of at most 8 bits;
// K2: K <= 256, C <= 128; K3 with AdaLog A: C <= 128; K3 with uniform A:
// K <= 128; and the staging within one block's shared memory
template <typename T>
cudaError_t launch_mma_mode(int mode, const MatmulArgs& a) {
  if (mode == 0) {
    if (a.K <= 32) return launch_uniform_mma<T, 2>(a);
    if (a.K <= 64) return launch_uniform_mma<T, 4>(a);
    if (a.K <= 128) return launch_uniform_mma<T, 8>(a);
    return cudaErrorInvalidValue;
  }
  if (a.a_bits > 8) return cudaErrorInvalidValue;
  if (mode == 1) {
    if (a.C <= 32) return launch_adalog_mma<T, 2>(a);
    if (a.C <= 64) return launch_adalog_mma<T, 4>(a);
    if (a.C <= 128) return launch_adalog_mma<T, 8>(a);
    return cudaErrorInvalidValue;
  }
  if (mode == 2) {
    if (a.K <= 56) return launch_softmax_mma_c<T, 7>(a);      // a 7x7 window
    if (a.K <= 128) return launch_softmax_mma_c<T, 16>(a);
    if (a.K <= 200) return launch_softmax_mma_c<T, 25>(a);    // 14x14 + cls
    if (a.K <= 256) return launch_softmax_mma_c<T, 32>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

#ifdef K23_PROFILE
// cycles summed over warps, by phase: 0 staging of uq(B) and the table, 1
// loads of A (K3 uniform A: the warp's uq(A) tile), 2 mask and row max, 3 exp
// and row sum, 4 AdaLog codes and values, 5 products, 6 store; then all are
// zeroed
extern "C" int fq_attn_matmul_profile(unsigned long long* host8) {
  cudaError_t err = cudaMemcpyFromSymbol(host8, k23_prof, sizeof(k23_prof));
  if (err != cudaSuccess) return err;
  unsigned long long zero[8] = {};
  return cudaMemcpyToSymbol(k23_prof, zero, sizeof(zero));
}
#endif

// variant: 0 = "fma", 1 = "mma". dtype: 0 = float32 inputs, 1 = bfloat16
// inputs. mode: 0 = K3 with uniform A, 1 = K3 with AdaLog A, 2 = K2 (row
// softmax, then AdaLog A). A is (G, S, K), B (G, K, C); ap (a_period, 2)
// fp32 [scale or AdaLog base, zero point] and bp (b_period, 2) fp32 [scale,
// zero point], slice g reading row g % period; out (G, S, C) fp32.
// rows_per_block and warps (<= 12) are the wrapper's tiling of "fma". The
// caller vouches that "mma" with float32 inputs has bit widths and zero
// points whose integers c - z are exact in bf16. The launch goes to
// ``stream`` of ``device``, which is made current for the call where it is
// not. Returns the CUDA error code of the launch.
extern "C" int fq_attn_matmul_launch(int variant, int dtype, int mode,
                                     const void* A, const void* B,
                                     const void* ap, const void* bp, void* out,
                                     int G, int S, int K, int C, int a_period,
                                     int b_period, int rows_per_block,
                                     int warps, int a_bits, int b_bits,
                                     int device, void* stream) {
  if ((variant != 0 && variant != 1) || (dtype != 0 && dtype != 1) || G < 1 ||
      S < 1 || K < 1 || C < 1 || a_period < 1 || b_period < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const MatmulArgs a{A, B, static_cast<const float*>(ap),
                     static_cast<const float*>(bp), static_cast<float*>(out),
                     G, S, K, C, a_period, b_period, rows_per_block, warps,
                     a_bits, b_bits, static_cast<cudaStream_t>(stream)};
  if (variant == 0)
    err = dtype == 0 ? launch_fma_mode<float>(mode, a)
                     : launch_fma_mode<__nv_bfloat16>(mode, a);
  else
    err = dtype == 0 ? launch_mma_mode<float>(mode, a)
                     : launch_mma_mode<__nv_bfloat16>(mode, a);
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

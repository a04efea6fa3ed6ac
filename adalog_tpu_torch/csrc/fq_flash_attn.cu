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
// 4*S*S*D operations, about 50 per byte; on the tensor cores the two
// products are a few microseconds of a batch, so the bound is the bytes.
// What the card really spends is neither: every one of the S*S
// probabilities of a slice pays expf, two IEEE divisions, log2f and a round,
// and the AdaLog quantizer needs the FINISHED softmax row (an online-softmax
// rescale does not commute with it), so the whole row of logits has to be
// held somewhere until its max and sum are known. The rate at which the SMs
// dispatch that per-probability arithmetic is the floor; global-load
// latency while a slice's operands are staged is what stands on top of it.
//
// Two variants, both hand-written, chosen by the wrapper
// (ops/fq_attn.py::flash_variant) from shapes, dtype and bit widths:
//
// "mma" (S <= 256, D <= 128, at most 256 AdaLog codes): the design for this
// card. Past 256 keys (D <= 64) "mma" takes its rows in two passes over key
// tiles instead (the long row, below the short one in this file).
//   - Both products run on the tensor cores as mma.sync.aligned.m16n8k16,
//     bf16 x bf16 with fp32 accumulators, from registers. mma.sync, not
//     wgmma: the products are 5% of the kernel's cycles, so their
//     dispatch rate does not bind, and a warp that owns its rows needs no
//     warpgroup barrier.
//   - A warp owns a tile of 16 query rows of one slice and ALL S columns of
//     its logits: q @ kT accumulates into ceil(S/8) n8 tiles of registers
//     (S=197: 25 tiles, 100 registers a thread). Scale, bias, row max and
//     row sum happen on the accumulators (a row lives in the 4 lanes of a
//     quad: two __shfl_xor_sync); the logits never touch shared memory.
//     The quantized probabilities are packed to bf16 in place: the
//     accumulator layout of m16n8 is the A layout of m16n8k16, so p @ v
//     takes them from registers with no shuffle.
//   - uq(kT) and uq(v) of a slice are staged once a block as bf16 (a
//     quarter of the fp32 staging of "fma": 58 KB a block at S=197, D=64),
//     in the layout device memory has them ([k][n], n contiguous, rows
//     padded to an odd number of 16-byte chunks), and read as B operands
//     with ldmatrix.trans. The loads are 16 bytes wide with four in flight
//     a thread: sent one element at a time behind a bounds test, staging
//     took more than half of the kernel's cycles. Each warp stages its own
//     16 rows of uq(q).
//   - Blocks are small and many: 4 warps, so that 3 blocks (S=197, 168
//     registers a thread) or 5 (a Swin window, 96) share an SM and one
//     block's staging hides behind the others' arithmetic. A block takes
//     one slice and its warps walk the slice's row tiles (13 at S=197; a
//     Swin window has 4, one a warp); where a launch has too few slices to
//     fill the card twice, two blocks share a slice's tiles.
//   - A per-slice code table: the dequantized AdaLog value depends only on
//     the code, and a slice has 2N codes (16 at 4 bits). The block fills a
//     table with the arithmetic of adalog_unit's second half, so an entry
//     is bit-equal to what "fma" computes per probability; per probability
//     there remain expf, the division by the sum, log2f, the multiply by 37,
//     the division by the base, a compare, a rounding conversion and one
//     table load. Both divisions are the IEEE quotients, taken through the
//     rounded reciprocal of the divisor, which a row or a slice shares
//     (fq_quant.cuh::div_rn_by): three operations for about a dozen.
//   - That arithmetic is one function that is NOT inlined: unrolled over
//     the 25 tiles of a row the kernel's straight-line code outgrew the
//     I-cache and ran a third slower.
//   - bf16 inputs: the operands are what the plain version rounds to bf16
//     (round_bf16((c - z) * s), round_bf16(p)), so nothing is lost.
//   - fp32 inputs stay exact through integer operands: (c - z) * s does not
//     fit bf16 but the integer c - z does (|c - z| <= 256), so the kernel
//     stages the integers, takes sum (cq - zq)(ck - zk) exactly in the fp32
//     accumulator and multiplies by sq*sk and logit_scale there. A
//     probability is 2^-shift * (steps * ts) with steps an integer of at
//     most 4N - 2: the table's entry is steps * 2^-shift (exact in bf16
//     while m2a_bits <= 7) and the output is scaled by ts * sv once. This
//     is exact arithmetic where the plain version rounds each fp32
//     product, so the two differ by a few ulp of the sums, not bit for bit.
//     The wrapper sends fp32 inputs here only when the bit widths and the
//     zero points keep every integer exact in bf16.
//   - Ragged edges: padded kT columns get logits of -inf before the row max
//     and probabilities of exactly 0; padded v rows and padded head-dim
//     columns are zeros in shared memory; padded query rows are computed
//     and not stored.
//
// "fma" (any S and D <= 128 whose staging fits shared memory, any bit
// widths): the first kernel of the port, exact fp32 products on the FMA
// pipes, for what "mma" does not take.
//   - one block per (slice g, tile of query rows); the block quantizes
//     kT[g] and v[g] once into dynamic shared memory (fp32 values, rounded
//     to bf16 first when the inputs are bf16); S rows are split evenly over
//     tiles of at most MAX_ROWS_PER_BLOCK (S=197: 4 tiles of 50 rows);
//   - 12 warps a block, one warp per query row: lanes stride over the S
//     columns for the logits (up to 8 columns per lane in registers), the
//     row max and sum go through __shfl_xor_sync, the row of logits waits
//     in shared memory, p @ v spreads the D outputs over the lanes;
//   - it is held by shared-memory latency (each warp walks one row's
//     dependent loads, about one 4-byte load per FMA).
//
// Numerics follow the JAX kernel: rintf for every round (half to even),
// zero points rounded, quantizer math in fp32, operands rounded to the
// compute dtype before each product, fp32 accumulation, 2^-floor(prod/37)
// assembled from exponent bits. Sums run in another order than XLA's (and
// the tensor core's adder is not an IEEE round-to-nearest sum), and
// log2f/exp2f may differ by an ulp, so a probability within an ulp of a
// code boundary can take the neighbouring AdaLog code.

#include "fq_mma.cuh"

namespace {

using namespace fq;

// one call's arguments, as fq_flash_attn_launch receives them
struct FlashArgs {
  const void *q, *kT, *v;
  const float *m1a, *m1b, *m2q, *m2b, *bias;
  float* out;
  int P, G, S, D, m1a_bits, m1b_bits, m2a_bits, m2b_bits;
  float logit_scale;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// variant "fma": fp32 FMA pipes out of shared memory, one warp per query row
// ---------------------------------------------------------------------------

constexpr int WARPS = 12;            // must match ops/fq_attn.py _WARPS
constexpr int MAX_ROWS_PER_BLOCK = 64;
constexpr int COLS_PER_LANE = 8;     // logits chunk of 256 columns
constexpr int OUT_PER_LANE = 4;      // head dim <= 128

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
fq_flash_attn_fma_kernel(const T* __restrict__ q, const T* __restrict__ kT,
                         const T* __restrict__ v, const float* __restrict__ m1a,
                         const float* __restrict__ m1b,
                         const float* __restrict__ m2q,
                         const float* __restrict__ m2b,
                         const float* __restrict__ bias, float* __restrict__ out,
                         int P, int S, int D, int rows_per_block, int m1a_bits,
                         int m1b_bits, int m2a_bits, int m2b_bits,
                         float logit_scale) {
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
cudaError_t launch_fma(const FlashArgs& a) {
  const int S = a.S, D = a.D;
  const size_t smem = static_cast<size_t>(2 * S * D + WARPS * (S + D)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fq_flash_attn_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (S + MAX_ROWS_PER_BLOCK - 1) / MAX_ROWS_PER_BLOCK;
  const int rows_per_block = (S + tiles - 1) / tiles;
  dim3 grid(a.G, tiles);
  fq_flash_attn_fma_kernel<T><<<grid, WARPS * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kT),
      static_cast<const T*>(a.v), a.m1a, a.m1b, a.m2q, a.m2b, a.bias, a.out,
      a.P, S, D, rows_per_block, a.m1a_bits, a.m1b_bits, a.m2a_bits,
      a.m2b_bits, a.logit_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// variant "mma": tensor cores, logits in registers, a per-slice code table
// ---------------------------------------------------------------------------

constexpr int MAX_SLICES_PER_BLOCK = 4;

// Warps a block. Few, so that several blocks share an SM and one block's
// staging (global-load latency, two barriers) hides behind the others'
// arithmetic: 3 blocks of 4 warps at 168 registers for S=197, 5 at 96 for a
// Swin window.
constexpr int MMA_WARPS = 4;
// Below this many slices (two waves of 132 SMs) a launch of one-slice blocks
// leaves SMs idle, and two blocks share a slice's row tiles.
constexpr int SPLIT_BELOW = 264;

// Geometry of one instantiation: NT n8 tiles over the key positions of a row
// of logits (S <= 8 NT; an odd NT saves the registers and the quantizer's
// work of a tile that would be all padding: S=197 takes 25 tiles, S=49
// takes 7), DT k16 steps over the (padded) head dim.
template <int NT_, int DT>
struct Mma {
  static constexpr int NT = NT_;
  static constexpr int KT = (NT + 1) / 2;      // k16 steps of p @ v
  static constexpr int WARPS = MMA_WARPS;
  static constexpr int DN = 2 * DT;            // n8 tiles of a row of output
  static constexpr int S_PAD = 16 * KT;
  static constexpr int D_PAD = 16 * DT;
  // shared-memory rows in bf16 elements: an odd number of 16-byte chunks, so
  // the 8 rows of an ldmatrix tile (and the 8 row groups of a 32-bit A
  // load) fall into different banks
  static constexpr int K_LD = S_PAD + 8;       // uq(kT): [D_PAD][K_LD]
  static constexpr int V_LD = D_PAD + 8;       // uq(v):  [S_PAD][V_LD]
  static constexpr int Q_LD = D_PAD + 8;       // uq(q):  [16][Q_LD] a warp
  static constexpr int K_ELEMS = D_PAD * K_LD;
  static constexpr int V_ELEMS = S_PAD * V_LD;
  static constexpr int Q_ELEMS = 16 * Q_LD;
  // blocks an SM, which caps the registers a thread: 4 NT of them hold the
  // logits, then 2 NT the packed probabilities beside 8 DT of output
  static constexpr int MIN_BLOCKS =
      NT >= 32 ? 2 : NT >= 25 ? (DT >= 8 ? 2 : 3)
               : NT >= 16 ? (DT >= 8 ? 3 : 4) : (DT >= 8 ? 3 : DT >= 4 ? 4 : 5);
};

// With -DK1_PROFILE the kernel sums its warps' cycles by phase (clock64 at
// the K1_TICK marks) into k1_prof; fq_flash_attn_profile reads it. The
// shipped build has none of it.
#ifdef K1_PROFILE
__device__ unsigned long long k1_prof[16];
#define K1_TICK(i)                                                        \
  do {                                                                    \
    const long long now_ = clock64();                                     \
    if ((threadIdx.x & 31) == 0)                                          \
      atomicAdd(&k1_prof[i], static_cast<unsigned long long>(now_ - tick_)); \
    tick_ = clock64();                                                    \
  } while (0)
#else
#define K1_TICK(i)
#endif

// What a slice's warps read more than once, in shared memory beside the
// staged operands rather than in registers that the logits need: the code
// table with the AdaLog base (fq_mma.cuh), uq(q)'s quantizer and the scales
// of fp32 inputs (the integer sums times sq*sk, the output times ts*sv; 1
// for bf16).
struct SliceConsts {
  CodeTable codes;
  Uniform uq_q;
  float qk_scale, out_scale;
};

template <typename T, int NT, int DT>
__global__ void __launch_bounds__(Mma<NT, DT>::WARPS * 32,
                                  Mma<NT, DT>::MIN_BLOCKS)
fq_flash_attn_mma_kernel(const T* __restrict__ q, const T* __restrict__ kT,
                         const T* __restrict__ v, const float* __restrict__ m1a,
                         const float* __restrict__ m1b,
                         const float* __restrict__ m2q,
                         const float* __restrict__ m2b,
                         const float* __restrict__ bias, float* __restrict__ out,
                         int P, int G, int S, int D, int slices_per_block,
                         int warps_per_slice, int m1a_bits, int m1b_bits,
                         int m2a_bits, int m2b_bits, float logit_scale) {
  using C = Mma<NT, DT>;
  constexpr int KT = C::KT;
  constexpr bool kInt = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  // slices_per_block x (uq(kT) | uq(v)), WARPS x uq(q) tile, then the
  // slices' constants
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* q_s = kv_s + slices_per_block * (C::K_ELEMS + C::V_ELEMS);
  SliceConsts* consts_s =
      reinterpret_cast<SliceConsts*>(q_s + C::WARPS * C::Q_ELEMS);

#ifdef K1_PROFILE
  long long tick_ = clock64();
#endif
  const int g0 = blockIdx.x * slices_per_block;
  const int n_codes = 2 * (1 << (m2a_bits - 1));
  const float n2 = static_cast<float>(n_codes);
  const float ts = static_cast<float>(1.0 / (2.0 * n2 - 2.0));

  // zeros everywhere first: the padded head-dim rows of uq(kT), the padded
  // rows of uq(v) (they meet probabilities of exactly 0, and 0 * NaN is
  // NaN) and the padded columns of the warps' uq(q) tiles
  {
    uint4* all16 = reinterpret_cast<uint4*>(smem_mma);
    const int n16 = (slices_per_block * (C::K_ELEMS + C::V_ELEMS) +
                     C::WARPS * C::Q_ELEMS) / 8;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      all16[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  for (int ls = 0; ls < slices_per_block && g0 + ls < G; ++ls) {
    const int g = g0 + ls;
    const size_t base = static_cast<size_t>(g) * S * D;
    __nv_bfloat16* K_s = kv_s + ls * (C::K_ELEMS + C::V_ELEMS);
    stage_rows<kInt, C::K_LD, 4>(
        K_s, kT + base, D * S, S, uniform_of(m1b, g, m1b_bits), threadIdx.x,
        blockDim.x);
    stage_rows<kInt, C::V_LD, 4>(
        K_s + C::K_ELEMS, v + base, S * D, D, uniform_of(m2b, g, m2b_bits),
        threadIdx.x, blockDim.x);
    const float aq = m2q[g];
    SliceConsts* sc = consts_s + ls;
    fill_code_table<kInt>(&sc->codes, aq, n_codes, ts, threadIdx.x,
                          blockDim.x);
    if (threadIdx.x == blockDim.x - 1) {
      sc->uq_q = uniform_of(m1a, g, m1a_bits);
      sc->qk_scale = kInt ? __fmul_rn(m1a[2 * g], m1b[2 * g]) : 1.0f;
      sc->out_scale = kInt ? __fmul_rn(ts, m2b[2 * g]) : 1.0f;
    }
  }
  __syncthreads();
  K1_TICK(0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ls = warp / warps_per_slice;
  const int g = g0 + ls;
  if (ls >= slices_per_block || g >= G) return;
  const int wl = warp - ls * warps_per_slice;
  const int gq = lane >> 2, t4 = lane & 3;     // row of the quad, lane in it

  const size_t base = static_cast<size_t>(g) * S * D;
  const __nv_bfloat16* K_s = kv_s + ls * (C::K_ELEMS + C::V_ELEMS);
  const __nv_bfloat16* V_s = K_s + C::K_ELEMS;
  __nv_bfloat16* Q_s = q_s + warp * C::Q_ELEMS;
  const SliceConsts* sc = consts_s + ls;
  const float* bias_g =
      bias == nullptr ? nullptr : bias + static_cast<size_t>(g % P) * S * S;
  // the lane's ldmatrix row and column offset inside a k16 x n16 tile
  const int ld_row = lane & 15, ld_col = (lane >> 4) * 8;
  const bool d_even = (D & 1) == 0;

  // the slice's row tiles go round the warps of the gridDim.y blocks that
  // share the slice
  for (int r0 = 16 * (wl + warps_per_slice * blockIdx.y); r0 < S;
       r0 += 16 * warps_per_slice * gridDim.y) {
    // this warp's 16 rows of uq(q); past the last row of the slice the
    // tile keeps what it held, rows that are computed and never stored
    stage_rows<kInt, C::Q_LD, 4>(Q_s, q + base + static_cast<size_t>(r0) * D,
                                 min(16, S - r0) * D, D, sc->uq_q, lane, 32);
    __syncwarp();
    K1_TICK(1);

    // logits: 16 rows x S_PAD columns in registers. acc[nt][0..1] are row
    // gq, columns 8 nt + 2 t4 + {0, 1}; acc[nt][2..3] the same of row gq + 8
    float acc[C::NT][4];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      uint32_t a[4];
      const __nv_bfloat16* qa = Q_s + gq * C::Q_LD + kk * 16 + 2 * t4;
      a[0] = lds32(qa);
      a[1] = lds32(qa + 8 * C::Q_LD);
      a[2] = lds32(qa + 8);
      a[3] = lds32(qa + 8 * C::Q_LD + 8);
      const uint32_t k_addr =
          smem_addr(K_s + (kk * 16 + ld_row) * C::K_LD + ld_col);
#pragma unroll
      for (int nt = 0; nt < C::NT; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, k_addr + nt * 8 * 2);
        mma_bf16(acc[nt], a, b);
        if (nt + 1 < C::NT) mma_bf16(acc[nt + 1], a, b + 2);
      }
    }
    __syncwarp();                      // Q_s is rewritten for the next tile
    K1_TICK(2);

    // scale, bias, mask of the padded columns, row max
    const int ra = r0 + gq, rb = ra + 8;
    const float* bias_a = bias_g == nullptr || ra >= S
        ? nullptr : bias_g + static_cast<size_t>(ra) * S;
    const float* bias_b = bias_g == nullptr || rb >= S
        ? nullptr : bias_g + static_cast<size_t>(rb) * S;
    float mx_a = -INFINITY, mx_b = -INFINITY;
    const float qk_scale = sc->qk_scale;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * nt + 2 * t4 + e;
        float la = acc[nt][e], lb = acc[nt][2 + e];
        if (kInt) {
          la = __fmul_rn(la, qk_scale);
          lb = __fmul_rn(lb, qk_scale);
        }
        la = __fmul_rn(la, logit_scale);
        lb = __fmul_rn(lb, logit_scale);
        if (c < S) {
          if (bias_a != nullptr) la = __fadd_rn(la, bias_a[c]);
          if (bias_b != nullptr) lb = __fadd_rn(lb, bias_b[c]);
        } else {
          la = -INFINITY;
          lb = -INFINITY;
        }
        acc[nt][e] = la;
        acc[nt][2 + e] = lb;
        mx_a = fmaxf(mx_a, la);
        mx_b = fmaxf(mx_b, lb);
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));

    K1_TICK(3);
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
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

    K1_TICK(4);
    // AdaLog: the code by arithmetic, its value from the slice's table;
    // packed to bf16 as the A operands of p @ v
    const Divisor div_a{sum_a, __frcp_rn(sum_a)};
    const Divisor div_b{sum_b, __frcp_rn(sum_b)};
    uint32_t pa[KT][4];
    pa[KT - 1][2] = pa[KT - 1][3] = 0u;        // an odd NT: the tile left out
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const uint2 h = quantize_tile(acc[nt][0], acc[nt][1], acc[nt][2],
                                    acc[nt][3], div_a, div_b, &sc->codes,
                                    S - (8 * nt + 2 * t4));
      pa[nt >> 1][2 * (nt & 1)] = h.x;
      pa[nt >> 1][2 * (nt & 1) + 1] = h.y;
    }
    K1_TICK(5);

    // out tile: 16 rows x D_PAD columns, same layout as the logits
    float o[C::DN][4];
#pragma unroll
    for (int dn = 0; dn < C::DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const uint32_t v_addr =
          smem_addr(V_s + (kk * 16 + ld_row) * C::V_LD + ld_col);
#pragma unroll
      for (int dn = 0; dn < C::DN; dn += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_addr + dn * 8 * 2);
        mma_bf16(o[dn], pa[kk], b);
        mma_bf16(o[dn + 1], pa[kk], b + 2);
      }
    }

    K1_TICK(6);
    const float out_scale = sc->out_scale;
    float* out_a = out + base + static_cast<size_t>(ra) * D;
    float* out_b = out + base + static_cast<size_t>(rb) * D;
#pragma unroll
    for (int dn = 0; dn < C::DN; ++dn) {
      const int c = 8 * dn + 2 * t4;
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = kInt ? __fmul_rn(o[dn][e], out_scale) : o[dn][e];
      if (d_even) {                    // c is even: 8-byte aligned pairs
        if (c < D) {
          if (ra < S) *reinterpret_cast<float2*>(out_a + c) = make_float2(w[0], w[1]);
          if (rb < S) *reinterpret_cast<float2*>(out_b + c) = make_float2(w[2], w[3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e < D && ra < S) out_a[c + e] = w[e];
          if (c + e < D && rb < S) out_b[c + e] = w[2 + e];
        }
      }
    }
    K1_TICK(7);
  }
}

template <typename T, int NT, int DT>
cudaError_t launch_mma(const FlashArgs& a) {
  using C = Mma<NT, DT>;
  // a block's warps take whole slices: as many as its warps cover at one
  // row tile a warp (a Swin window's 4 tiles: one window), else one slice
  // whose tiles the warps walk (deit_small's 13 tiles: 4 rounds)
  const int tiles = (a.S + 15) / 16;
  int spb = C::WARPS / tiles;
  spb = spb < 1 ? 1 : (spb > MAX_SLICES_PER_BLOCK ? MAX_SLICES_PER_BLOCK : spb);
  const int wps = C::WARPS / spb;
  const size_t smem =
      static_cast<size_t>(spb) * ((C::K_ELEMS + C::V_ELEMS) * 2 + sizeof(SliceConsts)) +
      static_cast<size_t>(C::WARPS) * C::Q_ELEMS * 2;
  cudaError_t err = cudaFuncSetAttribute(
      fq_flash_attn_mma_kernel<T, NT, DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // few slices of many tiles (deit_small at batch 32: 192 on 132 SMs): two
  // blocks share a slice's tiles, each staging uq(kT) and uq(v) for itself
  const int split =
      spb == 1 && a.G < SPLIT_BELOW && tiles >= 2 * C::WARPS ? 2 : 1;
  fq_flash_attn_mma_kernel<T, NT, DT>
      <<<dim3((a.G + spb - 1) / spb, split), C::WARPS * 32, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.kT),
          static_cast<const T*>(a.v), a.m1a, a.m1b, a.m2q, a.m2b, a.bias,
          a.out, a.P, a.G, a.S, a.D, spb, wps, a.m1a_bits, a.m1b_bits,
          a.m2a_bits, a.m2b_bits, a.logit_scale);
  return cudaGetLastError();
}

template <typename T, int NT>
cudaError_t launch_mma_d(const FlashArgs& a) {
  if (a.D <= 32) return launch_mma<T, NT, 2>(a);
  if (a.D <= 64) return launch_mma<T, NT, 4>(a);
  if (a.D <= 128) return launch_mma<T, NT, 8>(a);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// variant "mma", rows longer than 256: two passes over key tiles
// ---------------------------------------------------------------------------
//
// Past 256 keys a row of logits no longer fits a warp's registers (EVA-02
// at 448 px: 1,025 tokens), and the online-softmax trick alone cannot give
// the codes: AdaLog quantizes the NORMALIZED probability, so the row's max
// and sum must be known before any p is quantized. So the row takes two
// passes over tiles of LONG_KN keys, in one kernel:
//   - pass one forms each tile's logits on the tensor cores and keeps the
//     row max and the row sum (online: the running sum is rescaled by
//     expf(old max - new max) when the max grows);
//   - pass two forms the logits again, the same products on the same
//     operands, so the same values, takes p = expf(l - max) / sum, its
//     AdaLog code and value from the slice's table (quantize_tile, as the
//     short row) and accumulates value @ uq(v) on the tensor cores.
// The (G, S, S) logits never reach device memory.
//   - A block is LONG_WARPS warps on one slice, a warp a tile of 16 query
//     rows, whose uq(q) operands it keeps in shared memory. The
//     block's threads stage each key tile of uq(kT) (and, in pass two, of
//     uq(v)) into shared memory as bf16 once for all its warps, the same
//     integers (fp32 inputs) or rounded values (bf16) as the short row.
//   - Blocks run row tiles fastest (one 1-D grid, slice-major), so the
//     blocks of one slice are resident together and its kT and v come from
//     L2 after the first.
//   - Ragged edges as the short row: key columns past S take logits of
//     -inf and probabilities of exactly 0 (their staged kT is 0), query rows
//     past S are computed and not stored; the padded head dim is 0.
//   - The sum is rescaled at each new max, so it differs from the short
//     row's one-pass sum by an ulp or so: a probability within that of an
//     AdaLog code boundary may take the neighbouring code.

constexpr int LONG_WARPS = 8;       // 128 query rows a block, 2 an SM
constexpr int LONG_KN = 64;         // keys a staged tile
constexpr int LONG_KH = 32;         // keys a warp's logits hold at a time
constexpr int LONG_MAX_D = 64;      // must match ops/fq_attn.py _LONG_MAX_D

template <int DT>
struct Long {
  // of LONG_KH keys: with 32 registers of output a thread, logits of all
  // 64 keys of a tile would not leave two blocks an SM without a spill
  static constexpr int NT = LONG_KH / 8;       // n8 tiles of logits
  static constexpr int KT = LONG_KH / 16;      // k16 steps of p @ v
  static constexpr int DN = 2 * DT;            // n8 tiles of a row of output
  static constexpr int D_PAD = 16 * DT;
  // an odd number of 16-byte chunks a row, as the short row's
  static constexpr int K_LD = LONG_KN + 8;     // uq(kT) tile: [D_PAD][K_LD]
  static constexpr int V_LD = D_PAD + 8;       // uq(v) tile:  [LONG_KN][V_LD]
  static constexpr int Q_LD = D_PAD + 8;       // uq(q):       [16][Q_LD] a warp
  static constexpr int K_ELEMS = D_PAD * K_LD;
  static constexpr int V_ELEMS = LONG_KN * V_LD;
  static constexpr int Q_ELEMS = 16 * Q_LD;
  static constexpr int SMEM_BF16 = K_ELEMS + V_ELEMS + LONG_WARPS * Q_ELEMS;
};

// Stage columns k0 .. k0 + LONG_KN - 1 of the (D, S) row-major uq(kT) of a
// slice into the [d][c] tile dst; columns past S get 0. A row of kT starts
// wherever d * S puts it (S odd: not 16-byte aligned), so the loads are one
// element each, coalesced along the row, LOADS in flight a thread (16: a
// 64 x 64 tile in one round of latency for 256 threads). Inlined: a call
// inside the tile loop would save the live accumulators around it.
template <bool kInt, int LD, int LOADS, typename T>
__device__ __forceinline__ void stage_key_tile(__nv_bfloat16* dst,
                                            const T* __restrict__ src, int D,
                                            int S, int k0, Uniform uq,
                                            int tid, int nthreads) {
  const int count = D * LONG_KN;
  for (int i0 = tid; i0 < count; i0 += LOADS * nthreads) {
    float x[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * nthreads;
      const int d = i / LONG_KN, c = k0 + i % LONG_KN;
      x[u] = i < count && c < S
          ? to_f32(src[static_cast<size_t>(d) * S + c]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * nthreads;
      if (i < count) {
        const int d = i / LONG_KN, c = i % LONG_KN;
        dst[d * LD + c] = k0 + c < S ? staged<kInt>(x[u], uq)
                                     : __float2bfloat16_rn(0.0f);
      }
    }
  }
}

// The logits of LONG_KH keys from key k0 into acc: uq(q) @ uq(kT) on the
// tensor cores (q_frag: the lane's A operands in the warp's uq(q) tile;
// k_addr: its ldmatrix row of the staged tile at those keys), the scales,
// the bias, -inf past S.
template <bool kInt, int DT>
__device__ __forceinline__ void long_logits(
    float (&acc)[Long<DT>::NT][4], const __nv_bfloat16* q_frag,
    uint32_t k_addr, int k0, int S, int t4, float qk_scale,
    float logit_scale, const float* bias_a, const float* bias_b) {
  using C = Long<DT>;
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    uint32_t a[4];
    a[0] = lds32(q_frag + kk * 16);
    a[1] = lds32(q_frag + kk * 16 + 8 * C::Q_LD);
    a[2] = lds32(q_frag + kk * 16 + 8);
    a[3] = lds32(q_frag + kk * 16 + 8 * C::Q_LD + 8);
#pragma unroll
    for (int nt = 0; nt < C::NT; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, k_addr + (kk * 16 * C::K_LD + nt * 8) * 2);
      mma_bf16(acc[nt], a, b);
      mma_bf16(acc[nt + 1], a, b + 2);
    }
  }
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = k0 + 8 * nt + 2 * t4 + e;
      float la = acc[nt][e], lb = acc[nt][2 + e];
      if (kInt) {
        la = __fmul_rn(la, qk_scale);
        lb = __fmul_rn(lb, qk_scale);
      }
      la = __fmul_rn(la, logit_scale);
      lb = __fmul_rn(lb, logit_scale);
      if (c < S) {
        if (bias_a != nullptr) la = __fadd_rn(la, bias_a[c]);
        if (bias_b != nullptr) lb = __fadd_rn(lb, bias_b[c]);
      } else {
        la = -INFINITY;
        lb = -INFINITY;
      }
      acc[nt][e] = la;
      acc[nt][2 + e] = lb;
    }
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(LONG_WARPS * 32, 2)
fq_flash_attn_long_kernel(const T* __restrict__ q, const T* __restrict__ kT,
                          const T* __restrict__ v,
                          const float* __restrict__ m1a,
                          const float* __restrict__ m1b,
                          const float* __restrict__ m2q,
                          const float* __restrict__ m2b,
                          const float* __restrict__ bias,
                          float* __restrict__ out, int P, int S, int D,
                          int row_blocks, int m1a_bits, int m1b_bits,
                          int m2a_bits, int m2b_bits, float logit_scale) {
  using C = Long<DT>;
  constexpr bool kInt = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_long[];
  __nv_bfloat16* K_s = reinterpret_cast<__nv_bfloat16*>(smem_long);
  __nv_bfloat16* V_s = K_s + C::K_ELEMS;
  __nv_bfloat16* q_s = V_s + C::V_ELEMS;
  SliceConsts* sc = reinterpret_cast<SliceConsts*>(K_s + C::SMEM_BF16);

  const int g = blockIdx.x / row_blocks;
  const int rb = blockIdx.x - g * row_blocks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * (rb * LONG_WARPS + warp);
  const bool rows = r0 < S;            // the warp has rows of the slice
  const size_t base = static_cast<size_t>(g) * S * D;
  const int n_codes = 2 * (1 << (m2a_bits - 1));
  const float ts = static_cast<float>(1.0 / (2.0 * n_codes - 2.0));

  // zeros first: the padded head dim of the tiles and of uq(q), and the
  // query rows past S
  {
    uint4* all16 = reinterpret_cast<uint4*>(smem_long);
    for (int i = threadIdx.x; i < C::SMEM_BF16 / 8; i += blockDim.x)
      all16[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fill_code_table<kInt>(&sc->codes, m2q[g], n_codes, ts, threadIdx.x,
                        blockDim.x);
  if (threadIdx.x == blockDim.x - 1) {
    sc->uq_q = uniform_of(m1a, g, m1a_bits);
    sc->qk_scale = kInt ? __fmul_rn(m1a[2 * g], m1b[2 * g]) : 1.0f;
    sc->out_scale = kInt ? __fmul_rn(ts, m2b[2 * g]) : 1.0f;
  }
  __syncthreads();

  // this warp's 16 rows of uq(q), the A operands of both passes (read
  // from shared memory at each key tile: registers go to the logits)
  __nv_bfloat16* Q_s = q_s + warp * C::Q_ELEMS;
  if (rows)
    stage_rows<kInt, C::Q_LD, 4>(Q_s, q + base + static_cast<size_t>(r0) * D,
                                 min(16, S - r0) * D, D, sc->uq_q, lane, 32);
  __syncwarp();
  const __nv_bfloat16* q_frag = Q_s + gq * C::Q_LD + 2 * t4;

  const Uniform uq_k = uniform_of(m1b, g, m1b_bits);
  const Uniform uq_v = uniform_of(m2b, g, m2b_bits);
  const float qk_scale = sc->qk_scale;
  const int ra = r0 + gq, rb_ = ra + 8;
  const float* bias_g =
      bias == nullptr ? nullptr : bias + static_cast<size_t>(g % P) * S * S;
  const float* bias_a = bias_g == nullptr || ra >= S
      ? nullptr : bias_g + static_cast<size_t>(ra) * S;
  const float* bias_b = bias_g == nullptr || rb_ >= S
      ? nullptr : bias_g + static_cast<size_t>(rb_) * S;
  const int ld_row = lane & 15, ld_col = (lane >> 4) * 8;
  const uint32_t k_addr = smem_addr(K_s + ld_row * C::K_LD + ld_col);
  const uint32_t v_addr = smem_addr(V_s + ld_row * C::V_LD + ld_col);

  // pass one: the row max and the row sum
  float mx_a = -INFINITY, mx_b = -INFINITY, sum_a = 0.0f, sum_b = 0.0f;
  for (int k0 = 0; k0 < S; k0 += LONG_KN) {
    __syncthreads();                   // the last tile is consumed
    stage_key_tile<kInt, C::K_LD, 16>(K_s, kT + base, D, S, k0, uq_k,
                                      threadIdx.x, blockDim.x);
    __syncthreads();
    if (!rows) continue;
    for (int kc = 0; kc < LONG_KN && k0 + kc < S; kc += LONG_KH) {
      float acc[C::NT][4];
      long_logits<kInt, DT>(acc, q_frag, k_addr + kc * 2, k0 + kc, S, t4,
                            qk_scale, logit_scale, bias_a, bias_b);
      float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        ta = fmaxf(ta, fmaxf(acc[nt][0], acc[nt][1]));
        tb = fmaxf(tb, fmaxf(acc[nt][2], acc[nt][3]));
      }
      ta = fmaxf(ta, __shfl_xor_sync(0xffffffffu, ta, 1));
      tb = fmaxf(tb, __shfl_xor_sync(0xffffffffu, tb, 1));
      ta = fmaxf(ta, __shfl_xor_sync(0xffffffffu, ta, 2));
      tb = fmaxf(tb, __shfl_xor_sync(0xffffffffu, tb, 2));
      // a new max rescales the running sum (0 before the first keys)
      const float na = fmaxf(mx_a, ta), nb = fmaxf(mx_b, tb);
      if (na > mx_a) sum_a *= expf(mx_a - na);
      if (nb > mx_b) sum_b *= expf(mx_b - nb);
      mx_a = na;
      mx_b = nb;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        sum_a += expf(acc[nt][0] - mx_a) + expf(acc[nt][1] - mx_a);
        sum_b += expf(acc[nt][2] - mx_b) + expf(acc[nt][3] - mx_b);
      }
    }
  }
  sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 1);
  sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 1);
  sum_a += __shfl_xor_sync(0xffffffffu, sum_a, 2);
  sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 2);
  const Divisor div_a{sum_a, __frcp_rn(sum_a)};
  const Divisor div_b{sum_b, __frcp_rn(sum_b)};

  // pass two: the probabilities, their AdaLog values, @ uq(v)
  float o[C::DN][4];
#pragma unroll
  for (int dn = 0; dn < C::DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  for (int k0 = 0; k0 < S; k0 += LONG_KN) {
    __syncthreads();
    stage_key_tile<kInt, C::K_LD, 16>(K_s, kT + base, D, S, k0, uq_k,
                                      threadIdx.x, blockDim.x);
    // key rows past S keep what the last tile left there (finite), and
    // meet probabilities of exactly 0
    stage_rows_body<kInt, 4>(V_s, C::V_LD,
                             v + base + static_cast<size_t>(k0) * D,
                             min(LONG_KN, S - k0) * D, D, uq_v, threadIdx.x,
                             blockDim.x);
    __syncthreads();
    if (!rows) continue;
    for (int kc = 0; kc < LONG_KN && k0 + kc < S; kc += LONG_KH) {
      float acc[C::NT][4];
      long_logits<kInt, DT>(acc, q_frag, k_addr + kc * 2, k0 + kc, S, t4,
                            qk_scale, logit_scale, bias_a, bias_b);
#pragma unroll
      for (int kk = 0; kk < C::KT; ++kk) {
        uint32_t pa[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nt = 2 * kk + h;
          const uint2 w = quantize_tile(
              expf(acc[nt][0] - mx_a), expf(acc[nt][1] - mx_a),
              expf(acc[nt][2] - mx_b), expf(acc[nt][3] - mx_b), div_a,
              div_b, &sc->codes, S - (k0 + kc + 8 * nt + 2 * t4));
          pa[2 * h] = w.x;
          pa[2 * h + 1] = w.y;
        }
        const uint32_t v_rows = v_addr + (kc + kk * 16) * C::V_LD * 2;
#pragma unroll
        for (int dn = 0; dn < C::DN; dn += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, v_rows + dn * 8 * 2);
          mma_bf16(o[dn], pa, b);
          mma_bf16(o[dn + 1], pa, b + 2);
        }
      }
    }
  }
  if (!rows) return;

  const float out_scale = sc->out_scale;
  float* out_a = out + base + static_cast<size_t>(ra) * D;
  float* out_b = out + base + static_cast<size_t>(rb_) * D;
#pragma unroll
  for (int dn = 0; dn < C::DN; ++dn) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * dn + 2 * t4 + e;
      if (c >= D) continue;
      const float wa = kInt ? __fmul_rn(o[dn][e], out_scale) : o[dn][e];
      const float wb = kInt ? __fmul_rn(o[dn][2 + e], out_scale) : o[dn][2 + e];
      if (ra < S) out_a[c] = wa;
      if (rb_ < S) out_b[c] = wb;
    }
  }
}

template <typename T, int DT>
cudaError_t launch_long(const FlashArgs& a) {
  using C = Long<DT>;
  const size_t smem =
      static_cast<size_t>(C::SMEM_BF16) * 2 + sizeof(SliceConsts);
  cudaError_t err = cudaFuncSetAttribute(
      fq_flash_attn_long_kernel<T, DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int row_blocks = (a.S + 16 * LONG_WARPS - 1) / (16 * LONG_WARPS);
  const long long blocks = static_cast<long long>(a.G) * row_blocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fq_flash_attn_long_kernel<T, DT>
      <<<static_cast<unsigned>(blocks), LONG_WARPS * 32, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.kT),
          static_cast<const T*>(a.v), a.m1a, a.m1b, a.m2q, a.m2b, a.bias,
          a.out, a.P, a.S, a.D, row_blocks, a.m1a_bits, a.m1b_bits,
          a.m2a_bits, a.m2b_bits, a.logit_scale);
  return cudaGetLastError();
}

// must match ops/fq_attn.py: S <= 256 and D <= 128 the short row, S > 256
// and D <= 64 the long row; m2a_bits <= 8
template <typename T>
cudaError_t launch_mma_s(const FlashArgs& a) {
  if (a.m2a_bits > 8) return cudaErrorInvalidValue;
  if (a.S <= 56) return launch_mma_d<T, 7>(a);       // a 7x7 window
  if (a.S <= 128) return launch_mma_d<T, 16>(a);
  if (a.S <= 200) return launch_mma_d<T, 25>(a);     // a 14x14 grid + cls
  if (a.S <= 256) return launch_mma_d<T, 32>(a);
  if (a.D <= 32) return launch_long<T, 2>(a);
  if (a.D <= LONG_MAX_D) return launch_long<T, 4>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

#ifdef K1_PROFILE
// cycles summed over warps, by phase: 0 staging, 1 q tile, 2 q @ kT, 3 scale
// and max, 4 exp and sum, 5 quantize, 6 p @ v, 7 store; then all are zeroed
extern "C" int fq_flash_attn_profile(unsigned long long* host16) {
  cudaError_t err = cudaMemcpyFromSymbol(host16, k1_prof, sizeof(k1_prof));
  if (err != cudaSuccess) return err;
  unsigned long long zero[16] = {};
  return cudaMemcpyToSymbol(k1_prof, zero, sizeof(zero));
}
#endif

// variant: 0 = "fma", 1 = "mma". dtype: 0 = float32 inputs, 1 = bfloat16
// inputs. All parameter arrays are fp32: m1a/m1b/m2b (G, 2) [scale, zero
// point], m2q (G,), bias (P, S, S) or null. out is (G, S, D) fp32. The
// caller vouches that "mma" with float32 inputs has bit widths and zero
// points whose integers c - z are exact in bf16. Returns the CUDA error code
// of the launch.
extern "C" int fq_flash_attn_launch(int variant, int dtype, const void* q,
                                    const void* kT, const void* v,
                                    const void* m1a, const void* m1b,
                                    const void* m2q, const void* m2b,
                                    const void* bias, void* out, int P, int G,
                                    int S, int D, int m1a_bits, int m1b_bits,
                                    int m2a_bits, int m2b_bits,
                                    float logit_scale, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const FlashArgs a{q, kT, v, f(m1a), f(m1b), f(m2q), f(m2b), f(bias),
                    static_cast<float*>(out), P, G, S, D, m1a_bits, m1b_bits,
                    m2a_bits, m2b_bits, logit_scale,
                    static_cast<cudaStream_t>(stream)};
  if (variant == 0 && dtype == 0) return launch_fma<float>(a);
  if (variant == 0 && dtype == 1) return launch_fma<__nv_bfloat16>(a);
  if (variant == 1 && dtype == 0) return launch_mma_s<float>(a);
  if (variant == 1 && dtype == 1) return launch_mma_s<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

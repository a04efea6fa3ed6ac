// Fused activation-quant int8 GEMM for Hopper (sm_90a): kernel K5 of the port.
//
// Replaces adalog_tpu/ops/int8_linear.py::int8_qlinear, which is not a
// Pallas kernel: the JAX package quantizes x, multiplies the int8 codes with
// XLA's dot_general into int32 and scales the sum, three programs XLA fuses
// as it likes. Here the three are one launch:
//   out[t, o] = cast(float(sum_k a[t, k] * w[o, k]) * scale_row[o] + b[o])
//   a[t, k]   = clamp(rint(x[t, k] / s) + rint(z), 0, 2^bits - 1) - rint(z)
// with x (T, K) float32 or bfloat16, w (O, K) int8 weight codes, scale_row
// (O,) float32 = s * s_w[o] and b (O,) in x's dtype (or none); a and w fit
// int8 (bits <= 7, the wrapper's table checks the zero points).
//
// What bounds it: bytes. At deit_small's four int8 sites at batch 32 (T =
// 6304, K = 384, O = 384..1536, and the head) a pass moves 108.3 MB in fp32
// (x 29.1 MB, w 1.6 MB, the output 77.6 MB: 72% of it), 32.3 us at 3.35
// TB/s, while its 14.9 G integer operations take 7.5 us at the card's 1979
// dense int8 TOPS. So what counts is that x's loads and the output's stores
// keep device memory busy all the time; the products hardly matter. At
// eva02_large_448's fc2 at batch 64 (T = 65600, K = 2730, O = 1024) the
// bytes take 0.295 ms in fp32 (x 716 MB, w 2.8 MB, the output 269 MB), the
// 367 G integer operations 0.185 ms: there the products count too.
//
// Numerics, every variant: the quantizer in fp32 to the JAX package's bits
// (rint, the IEEE quotient by s from its rounded reciprocal,
// fq_quant.cuh::div_rn_by_any; no FMA contraction); the int32 sums are
// exact in any order; the epilogue is __int2float_rn of the sum (exact below
// 2^24, JAX's convert above), one product with scale_row, one sum with the
// bias, one rounding to x's dtype. So all three equal the plain version bit
// for bit.
//
// Three variants, chosen by the wrapper (ops/int8_linear.py::int8_variant):
// "wgmma" where it applies, else "wgmma_codes" where the output rows allow,
// else "mma".
//
// "wgmma", the design for this card (every int8 site of the served models
// but eva02's fc2):
//   - Persistent grid, one block an SM (227 KB of shared memory), three
//     warpgroups: two consumers and a producer. The (row tile of 64, column
//     tile of 128) pairs in row-major order are cut into one run a block:
//     an even share of the tiles, or of whole row tiles where that costs a
//     block less (launch_wgmma weighs a row tile's quantization at 1.6 K /
//     128 tiles, as measured at deit_small's widths). deit_small at batch
//     32 (99 row tiles): qkv, proj and fc1 take runs of one row tile each
//     (9, 3 and 12 tiles) on 99 SMs; the head's 8 tiles take 8 blocks. So
//     each x element is quantized once per row tile and column group, where
//     "mma" quantizes it once per 128 columns.
//   - x resident: at the start of each row tile of its run, a block's 11
//     warps (both consumers and three of the producer's) load its 64 rows,
//     all K columns, as 16-byte pieces, 16 in flight a thread, and quantize
//     them into int8 codes in shared memory, laid out as wgmma reads A:
//     K-major, 128-byte swizzle (byte k of row r in 16-byte chunk
//     (k / 16 % 8) ^ (r % 8) of its 128-byte row, 128-k slabs of 8 KB).
//     The quantizer is code_of's with rint, clamp and the zero point as
//     integers (QuantI), bytes packed by byte_perm. K up to W_KMAX = 2176
//     stays resident: 17 slabs (136 KB), 3 ring stages (48 KB), the staging
//     rows (34 KB in fp32), the scale tables (4 KB) fill the 227 KB.
//   - w through a ring of 3 to 8 stages (as shared memory allows; 8 at K =
//     384) of 128 rows x 128 k (16 KB), fed by TMA (cp.async.bulk.tensor
//     2-D, 128-byte swizzle, mbarrier completion; the tensor map of each
//     site encoded once where its table is built and passed by value as a
//     __grid_constant__) from one thread of the producer; TMA fills rows
//     past O and k past K with 0, so a padded product adds 0 whatever A
//     holds there.
//   - Products: wgmma.mma_async m64n128k32 .s32.s8.s8, A and B from shared
//     memory, int32 accumulators in registers (64 a thread); a stage's four
//     k32 steps are one commit group, released to the producer once the
//     next group is in flight (wait_group 1).
//   - Ping-pong: the run's tiles alternate between the two consumers, so
//     one's epilogue runs while the other's products are in flight; their
//     waits on the ring go in slot order (the turn barriers, see the
//     kernel). No setmaxnreg: at 384 threads an SM every thread may hold
//     168 registers, which the consumers' accumulators and the quantizer's
//     16 pieces in flight fit without a spill.
//   - Epilogue: each thread reads its column's scale and bias before the
//     products and tables them after; a warp passes its 16 x 128 outputs
//     through shared memory eight rows at a time (rows padded by 8
//     elements, no bank conflicts) and writes each row as 16-byte pieces,
//     32 (fp32) or 16 (bf16) a row, one or two rows a warp instruction.
//     The stores do not wait for device memory. (One bulk copy a row,
//     cp.async.bulk from double-buffered staging rows, measured slower: the
//     waits for its reads cost more than the stores they replace.)
//   - Rows past T are quantized to nothing and never stored (the head's 32
//     rows take one 64-row tile); k32 steps past K are not run.
//   - It takes K a multiple of 16 (w's rows are TMA's row pitch) and at
//     most W_KMAX, x's rows 16-byte aligned, and O * itemsize a multiple of
//     16 (the pieces of a row); the wrapper sends the rest to
//     "wgmma_codes" or "mma".
//   - Where the time goes: see PERF.md (chip_smoke.py --profile prints the
//     phase shares of "wgmma" and "mma" at deit_small's qkv and fc1).
//
// "wgmma_codes", for a K "wgmma" cannot keep resident or rows it cannot load
// as 16-byte pieces (eva02_large_448's fc2: K = 2730, rows of 10,920 bytes):
//   - Two launches. int8_gemm_codes_kernel quantizes x once, by "wgmma"'s
//     QuantI, into a scratch (T, Kp) int8 buffer the wrapper allocates (Kp
//     = K rounded up to 128, codes 0 past K), a 16-byte piece of codes a
//     thread, x read in the widest loads its base and row stride allow (8
//     bytes at fc2 in fp32). Its bound at fc2: 716 MB read, 185 MB
//     written, 0.27 ms.
//   - Then "wgmma"'s persistent block with nothing resident: each ring stage
//     holds the 64 x 128 slab of codes (TMA, a tensor map over the buffer
//     encoded at each launch) and w's 128 x 128 (24 KB; 7 stages in fp32,
//     8 in bf16), the same products, ping-pong and epilogue. A block's run
//     of tiles is row-major, so a row tile's codes come from device memory
//     once and from L2 for its other column tiles. Bound at fc2: 185 + 3 +
//     269 MB, 0.14 ms; the products' 0.19 ms set the pace.
//   - w's rows need a 16-byte pitch for TMA: the table keeps a site's codes
//     in an (O, roundup(K, 16)) buffer (ops/int8_linear.py::pitched_codes),
//     and the tensor map has width K, so TMA fills past K with 0.
//   - It takes any K and x's layout, and O * itemsize a multiple of 16.
//
// "mma", the first kernel of the port, for what neither of the others
// takes:
//   - one block of 256 threads (8 warps, 2 x 4) per 64 x 128 output tile,
//     k in steps of 64; a warp owns 32 rows x 32 columns, 2 x 4 tiles of
//     mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, int32 accumulators;
//     at most 128 registers a thread, so two blocks share an SM;
//   - x: each thread loads its 16-byte pieces of the next k step into
//     registers before the products of this one, and quantizes them after,
//     into int8 codes in shared memory, [row][k] padded to 80 bytes; every
//     block quantizes its 64 rows again (once per 128-column tile);
//   - w: 16-byte cp.async of the next k step into a second buffer while this
//     one is multiplied (element loads where K or w's row pitch is not a
//     multiple of 16);
//   - epilogue: stored in pairs straight from the fragments, where the row
//     allows;
//   - ragged edges: rows past T and k past K are staged as code 0 and w
//     past O and K as 0; pieces of x that are not 16-byte aligned take
//     element loads.

#include <cuda.h>            // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "fq_quant.cuh"

namespace {

// With -DK5_PROFILE both variants sum their warps' cycles by phase (clock64
// at the K5_TICK marks; in "wgmma" every warp but the TMA producer's) into
// k5_prof; int8_gemm_profile reads it. The shipped build has none of it.
// Phases: 0 waiting for w (and, in "mma", at the block's barrier; in
// "wgmma", for the consumer's turn), 1 loading and quantizing x, 2 the
// products, 3 the epilogue and stores, 4 at a row tile's barriers
// ("wgmma").
#ifdef K5_PROFILE
__device__ unsigned long long k5_prof[8];
#define K5_TICK_START long long tick_ = clock64()
#define K5_TICK(i)                                                        \
  do {                                                                    \
    const long long now_ = clock64();                                     \
    if ((threadIdx.x & 31) == 0)                                          \
      atomicAdd(&k5_prof[i], static_cast<unsigned long long>(now_ - tick_)); \
    tick_ = clock64();                                                    \
  } while (0)
#else
#define K5_TICK_START
#define K5_TICK(i)
#endif
enum Phase { PH_W = 0, PH_X = 1, PH_MMA = 2, PH_EPI = 3, PH_BAR = 4 };

constexpr int BM = 64;             // output rows of a block
constexpr int BN = 128;            // output columns of a block
constexpr int BK = 64;             // k of a stage, bytes of an int8 row
constexpr int LD = BK + 16;        // smem row: 80 bytes, conflict-free loads
constexpr int THREADS = 256;
constexpr int WM = 32;             // rows of a warp
constexpr int WN = 32;             // columns of a warp
constexpr int MT = WM / 16;        // m16 tiles of a warp
constexpr int NT = WN / 8;         // n8 tiles of a warp

struct Args {
  const void* x;
  const int8_t* w;
  const float* a_params;           // [scale, zero point]
  const float* scale_row;
  const void* bias;
  void* out;
  int T, K, O, lda, ldw, bits;       // ldw: w's row pitch, at least K
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The activation quantizer of one launch.
struct Quant {
  float s, inv_s, zr, qmax;
};

__device__ __forceinline__ Quant quant_of(const float* a_params, int bits) {
  Quant q;
  q.s = a_params[0];
  q.inv_s = __frcp_rn(q.s);
  q.zr = rintf(a_params[1]);
  q.qmax = fq::qmax_of(bits);
  return q;
}

__device__ __forceinline__ int8_t code_of(float x, const Quant& q) {
  const float c = fminf(
      fmaxf(rintf(fq::div_rn_by_any(x, q.s, q.inv_s)) + q.zr, 0.0f), q.qmax);
  return static_cast<int8_t>(static_cast<int>(__fsub_rn(c, q.zr)));
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4], float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8],
                                       __nv_bfloat16) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// The codes of the VEC elements of one 16-byte piece, four to a word.
template <typename T, int VEC>
__device__ __forceinline__ void quantize_piece(const uint4& raw,
                                               const Quant& q,
                                               uint32_t (&packed)[VEC / 4]) {
  float f[VEC];
  unpack(raw, f, T());
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const uint32_t b =
        static_cast<uint32_t>(static_cast<uint8_t>(code_of(f[j], q)));
    if (j % 4 == 0) packed[j / 4] = b;
    else packed[j / 4] |= b << (8 * (j % 4));
  }
}

// The bits of one element of T.
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using W = uint32_t;
};
template <>
struct Bits<__nv_bfloat16> {
  using W = uint16_t;
};

// x's k step: the pieces of VEC elements a thread loads, then quantizes.
template <typename T>
struct XStage {
  static constexpr int VEC = 16 / sizeof(T);          // 4 fp32, 8 bf16
  static constexpr int PER_ROW = BK / VEC;
  static constexpr int PIECES = BM * PER_ROW / THREADS;
  uint4 raw[PIECES];
};

// Load the pieces of rows m0.., columns k0.. of x (16-byte loads when
// ``vec``: K and lda multiples of VEC, x aligned; element loads else).
// Pieces past T or K are left 0 and staged as code 0 by store_x.
template <typename T>
__device__ __forceinline__ void load_x(XStage<T>& st, const Args& g, int m0,
                                       int k0, bool vec) {
  using S = XStage<T>;
  const T* x = static_cast<const T*>(g.x);
#pragma unroll
  for (int i = 0; i < S::PIECES; ++i) {
    const int id = threadIdx.x + i * THREADS;
    const int r = m0 + id / S::PER_ROW;
    const int k = k0 + (id % S::PER_ROW) * S::VEC;
    st.raw[i] = make_uint4(0, 0, 0, 0);
    if (r >= g.T || k >= g.K) continue;
    const T* src = x + static_cast<size_t>(r) * g.lda + k;
    if (vec) {
      st.raw[i] = __ldg(reinterpret_cast<const uint4*>(src));
    } else {                       // the elements' bits into the piece
      const typename Bits<T>::W* e =
          reinterpret_cast<const typename Bits<T>::W*>(src);
      uint32_t word[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < S::VEC; ++j) {
        const int byte = j * static_cast<int>(sizeof(T));
        if (k + j < g.K)
          word[byte / 4] |= static_cast<uint32_t>(e[j]) << (8 * (byte % 4));
      }
      st.raw[i] = make_uint4(word[0], word[1], word[2], word[3]);
    }
  }
}

// Quantize the loaded pieces into the [row][LD] int8 codes of sa.
template <typename T>
__device__ __forceinline__ void store_x(int8_t* sa, const XStage<T>& st,
                                        const Args& g, const Quant& q, int m0,
                                        int k0) {
  using S = XStage<T>;
#pragma unroll
  for (int i = 0; i < S::PIECES; ++i) {
    const int id = threadIdx.x + i * THREADS;
    const int rr = id / S::PER_ROW;
    const int kk = (id % S::PER_ROW) * S::VEC;
    const bool row_in = m0 + rr < g.T;
    float f[S::VEC];
    unpack(st.raw[i], f, T());
    uint32_t packed[S::VEC / 4];
#pragma unroll
    for (int j = 0; j < S::VEC; ++j) {
      const bool in = row_in && k0 + kk + j < g.K;
      const int8_t c = in ? code_of(f[j], q) : int8_t(0);
      const uint32_t b = static_cast<uint32_t>(static_cast<uint8_t>(c));
      if (j % 4 == 0) packed[j / 4] = b;
      else packed[j / 4] |= b << (8 * (j % 4));
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(sa + rr * LD + kk);
#pragma unroll
    for (int j = 0; j < S::VEC / 4; ++j) dst[j] = packed[j];
  }
}

// w's k step: rows n0.. (O), columns k0.. into the [row][LD] int8 sb.
__device__ __forceinline__ void load_w(int8_t* sb, const Args& g, int n0,
                                       int k0, bool vec) {
  constexpr int PER_ROW = BK / 16;
  constexpr int PIECES = BN * PER_ROW / THREADS;
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int id = threadIdx.x + i * THREADS;
    const int rr = id / PER_ROW;
    const int kk = (id % PER_ROW) * 16;
    const int o = n0 + rr, k = k0 + kk;
    int8_t* dst = sb + rr * LD + kk;
    if (vec) {
      const bool full = o < g.O && k < g.K;
      const int8_t* src = full ? g.w + static_cast<size_t>(o) * g.ldw + k : g.w;
      cp_async16(dst, src, full);
    } else {
      const int8_t* row = g.w + static_cast<size_t>(o < g.O ? o : 0) * g.ldw;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = o < g.O && k + j < g.K ? row[k + j] : int8_t(0);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* out, float a, float b, bool two);

template <>
__device__ __forceinline__ void store_pair<float>(float* out, float a,
                                                  float b, bool two) {
  if (two) {
    *reinterpret_cast<float2*>(out) = make_float2(a, b);
  } else {
    out[0] = a;
  }
}

template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* out,
                                                          float a, float b,
                                                          bool two) {
  if (two) {
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
  } else {
    out[0] = __float2bfloat16_rn(a);
  }
}

// The epilogue's arithmetic: float(sum) * scale (+ bias), in fp32.
__device__ __forceinline__ float scaled(int acc, float s, float b,
                                        bool bias) {
  const float y = __fmul_rn(__int2float_rn(acc), s);
  return bias ? __fadd_rn(y, b) : y;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    int8_gemm_kernel(Args g, int x_vec, int w_vec) {
  __shared__ __align__(16) int8_t sa[2][BM * LD];
  __shared__ __align__(16) int8_t sb[2][BN * LD];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * WM, wn = (warp % 4) * WN;
  const int gq = lane / 4, t4 = lane % 4;
  K5_TICK_START;

  const Quant q = quant_of(g.a_params, g.bits);

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (g.K + BK - 1) / BK;
  XStage<T> st;
  load_x(st, g, m0, 0, x_vec);
  load_w(sb[0], g, n0, 0, w_vec);
  cp_async_commit();
  store_x(sa[0], st, g, q, m0, 0);
  K5_TICK(PH_X);
  cp_async_wait_all();
  __syncthreads();
  K5_TICK(PH_W);

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_x(st, g, m0, (kt + 1) * BK, x_vec);
      load_w(sb[cur ^ 1], g, n0, (kt + 1) * BK, w_vec);
      cp_async_commit();
    }
    K5_TICK(PH_X);
    const int8_t* A = sa[cur];
    const int8_t* B = sb[cur];
    const int ksteps = min(BK, g.K - kt * BK + 31) / 32;   // k32 steps left
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      if (ks >= ksteps) break;
      const int kb = ks * 32 + t4 * 4;
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* r0 = A + (wm + i * 16 + gq) * LD + kb;
        const int8_t* r1 = r0 + 8 * LD;
        af[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(r1);
        af[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* r = B + (wn + j * 8 + gq) * LD + kb;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(r);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(r + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    K5_TICK(PH_MMA);
    if (more) store_x(sa[cur ^ 1], st, g, q, m0, (kt + 1) * BK);
    K5_TICK(PH_X);
    cp_async_wait_all();
    __syncthreads();
    K5_TICK(PH_W);
  }

  // epilogue: float(sum) * scale_row[o] (+ bias[o]), one rounding to T
  T* out = static_cast<T*>(g.out);
  const T* bias = static_cast<const T*>(g.bias);
  const bool even = (g.O & 1) == 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int o = n0 + wn + j * 8 + 2 * t4;
    if (o >= g.O) continue;
    const bool two = o + 1 < g.O;
    const float s0 = g.scale_row[o];
    const float s1 = two ? g.scale_row[o + 1] : 0.0f;
    const float b0 = bias ? fq::to_f32(bias[o]) : 0.0f;
    const float b1 = bias && two ? fq::to_f32(bias[o + 1]) : 0.0f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = m0 + wm + i * 16 + gq + 8 * h;
        if (t >= g.T) continue;
        const float y0 = scaled(acc[i][j][2 * h], s0, b0, bias != nullptr);
        const float y1 = scaled(acc[i][j][2 * h + 1], s1, b1,
                                bias != nullptr);
        T* dst = out + static_cast<size_t>(t) * g.O + o;
        if (two && even) {
          store_pair<T>(dst, y0, y1, true);
        } else {
          store_pair<T>(dst, y0, y1, false);
          if (two) store_pair<T>(dst + 1, y1, y1, false);
        }
      }
    }
  }
  K5_TICK(PH_EPI);
}

template <typename T>
cudaError_t launch_mma(const Args& g, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool x_vec = g.K % VEC == 0 && g.lda % VEC == 0 &&
                     (reinterpret_cast<uintptr_t>(g.x) & 15) == 0;
  const bool w_vec = g.K % 16 == 0 && g.ldw % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(g.w) & 15) == 0;
  const dim3 grid((g.O + BN - 1) / BN, (g.T + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  int8_gemm_kernel<T><<<grid, THREADS, 0, stream>>>(g, x_vec, w_vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Variant "wgmma"
// ---------------------------------------------------------------------------

constexpr int W_BM = 64;             // rows of a row tile: one wgmma's M
constexpr int W_BN = 128;            // columns of a column tile: wgmma's N
constexpr int W_BK = 128;            // k of a slab / ring stage: 128 bytes
constexpr int W_MIN_STAGES = 3;      // ring stages of w: at least
constexpr int W_MAX_STAGES = 8;      // and at most, as shared memory allows
constexpr int W_CONSUMERS = 2;       // consumer warpgroups, in ping-pong
constexpr int W_CONSUMER_THREADS = 128 * W_CONSUMERS;
constexpr int W_THREADS = W_CONSUMER_THREADS + 128;  // + the producer
constexpr int W_XTHREADS = W_CONSUMER_THREADS + 96;  // + its 3 other warps
constexpr int W_QUANT_U = 16;        // 16-byte loads in flight a thread
constexpr int W_KMAX = 2176;         // the largest K that stays resident
constexpr int W_SLAB = W_BM * W_BK;  // 8 KB of codes: one 128-k slab of A
constexpr int W_STAGE = W_BN * W_BK; // 16 KB of w: one ring stage
constexpr int W_STG_ROWS = 8;        // rows a warp stages at a time
constexpr int W_SMEM_LIMIT = 232448; // a block's shared memory on sm_90

// a staging row, padded by 8 elements
template <typename T>
__host__ __device__ constexpr int stg_pitch() {
  return (W_BN + 8) * static_cast<int>(sizeof(T));
}

// the staging rows: eight a consumer warp
template <typename T>
__host__ __device__ constexpr int stg_bytes() {
  return 4 * W_CONSUMERS * W_STG_ROWS * stg_pitch<T>();
}

// A ring stage: w's 16 KB, and in "wgmma_codes" the 8 KB slab of x's codes
// before it
template <bool CODES>
__host__ __device__ constexpr int ring_stage() {
  return CODES ? W_SLAB + W_STAGE : W_STAGE;
}

// The shared memory of a launch: the resident codes ("wgmma" only), the
// ring (as many stages as fit, W_MIN_STAGES to W_MAX_STAGES), the staging
// rows, each consumer warpgroup's two tables of its tile's 128 row scales
// and biases, and the barriers: the ring's full and empty, the consumers'
// two turns.
constexpr int W_COLS = W_CONSUMERS * 2 * 2 * W_BN * 4;
constexpr int W_BARRIERS = (2 * W_MAX_STAGES + 2) * 8;

template <typename T, bool CODES>
struct WLayout {
  int stages, bytes;
  __host__ __device__ constexpr WLayout(int K) : stages(0), bytes(0) {
    const int fixed = (CODES ? 0 : (K + W_BK - 1) / W_BK * W_SLAB) +
                      stg_bytes<T>() + W_COLS + W_BARRIERS;
    stages = (W_SMEM_LIMIT - fixed) / ring_stage<CODES>();
    stages = stages > W_MAX_STAGES ? W_MAX_STAGES : stages;
    bytes = fixed + stages * ring_stage<CODES>();
  }
};
static_assert(WLayout<float, false>(W_KMAX).stages >= W_MIN_STAGES,
              "K = W_KMAX must stay resident");
static_assert(WLayout<float, false>(W_KMAX + W_BK).stages < W_MIN_STAGES,
              "W_KMAX is the largest resident K");
static_assert(WLayout<float, true>(0).stages >= W_MIN_STAGES,
              "the ring of \"wgmma_codes\" holds both operands");

struct WArgs {
  const void* x;
  const float* a_params;
  const float* scale_row;
  const void* bias;
  void* out;
  int T, K, O, lda, bits;
  int col_tiles, tiles, stages;
  int whole_rows;                    // runs of whole row tiles
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of ``bar`` with this parity has completed; a wait
// of 2^24 polls (seconds, where a real one takes microseconds) is a fault
// of the kernel, and traps rather than holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// one box of a tensor map (w's 128 rows, or 64 rows of x's codes): rows
// row.., k k.., 128-byte swizzle
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// the consumer warpgroups and the producer's three quantizing warps,
// named barrier 1: at a row tile's start and once its codes are written
__device__ __forceinline__ void bar_row_tile() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(W_XTHREADS) : "memory");
}

// one consumer warpgroup, named barrier 2 or 3
__device__ __forceinline__ void bar_warpgroup(int wg) {
  if (wg == 0) {
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  } else {
    asm volatile("bar.sync 3, 128;\n" ::: "memory");
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses to the accumulators across the
// asynchronous products
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma's shared-memory matrix descriptor of a K-major operand in 128-byte
// swizzle: start address / 16, leading byte offset 16 (unused in this
// layout), stride byte offset 1024 (from one 8-row group to the next),
// layout type 1 (B128) in bits 62-63. A k32 step inside the 128-byte row
// adds 32 bytes to the start: the swizzle is applied to the address bits.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (+)= A (64 x 32 of int8, K-major) * B (128 x 32, K-major)^T; d is the
// int32 fragment of the warpgroup: register 4j + 2h + e of lane l of warp w
// holds row 16w + l/4 + 8h, column 8j + 2(l%4) + e
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The activation quantizer as "wgmma" applies it: the IEEE quotient as in
// code_of, then rint, clamp and the zero point's subtraction as integers:
// clamp(rint(q) + rint(z), 0, qmax) - rint(z) = clamp(rint(q), -rint(z),
// qmax - rint(z)), one rounding conversion (saturating) and two integer
// clamps in place of five fp32 operations and a conversion. The same
// codes for every finite or infinite x; a NaN gives 0 (code_of: -rint(z);
// the plain version: NaN).
struct QuantI {
  float s, inv_s;
  int lo, hi;
};

__device__ __forceinline__ QuantI quanti_of(const float* a_params, int bits) {
  const Quant q = quant_of(a_params, bits);
  QuantI r;
  r.s = q.s;
  r.inv_s = q.inv_s;
  r.lo = -static_cast<int>(q.zr);
  r.hi = static_cast<int>(q.qmax) - static_cast<int>(q.zr);
  return r;
}

__device__ __forceinline__ int code_int(float x, const QuantI& q) {
  const int c = __float2int_rn(fq::div_rn_by_any(x, q.s, q.inv_s));
  return min(max(c, q.lo), q.hi);
}

// the low bytes of four codes, in order, as one word
__device__ __forceinline__ uint32_t pack4(int c0, int c1, int c2, int c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040),
                     0x5410);
}

template <typename T>
__device__ __forceinline__ void store_codes(uint8_t* dst, const uint4& raw,
                                            const QuantI& q);

template <>
__device__ __forceinline__ void store_codes<float>(uint8_t* dst,
                                                   const uint4& raw,
                                                   const QuantI& q) {
  *reinterpret_cast<uint32_t*>(dst) =
      pack4(code_int(__uint_as_float(raw.x), q),
            code_int(__uint_as_float(raw.y), q),
            code_int(__uint_as_float(raw.z), q),
            code_int(__uint_as_float(raw.w), q));
}

template <>
__device__ __forceinline__ void store_codes<__nv_bfloat16>(uint8_t* dst,
                                                           const uint4& raw,
                                                           const QuantI& q) {
  uint32_t w[2];
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    w[h] = pack4(code_int(__uint_as_float(u[2 * h] << 16), q),
                 code_int(__uint_as_float(u[2 * h] & 0xffff0000u), q),
                 code_int(__uint_as_float(u[2 * h + 1] << 16), q),
                 code_int(__uint_as_float(u[2 * h + 1] & 0xffff0000u), q));
  *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
}

// Quantize rows m0.. (at most 64, those below T) of x, all K columns, into
// the resident codes sa: byte k of row r at slab k / 128, chunk
// (k / 16 % 8) ^ (r % 8), byte k % 16. Thread tid of n loads 16-byte
// pieces, W_QUANT_U in flight, neighbours on neighbouring pieces of a row;
// a thread's pieces are n apart, their rows and columns stepped without a
// division.
template <typename T>
__device__ __forceinline__ void quantize_row_tile(uint8_t* sa,
                                                  const WArgs& g,
                                                  const QuantI& q, int m0,
                                                  int tid, int n) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = W_QUANT_U;
  const int per_row = g.K / VEC;
  const int rows = min(W_BM, g.T - m0);
  const int dr = n / per_row, dc = n % per_row;
  const T* x = static_cast<const T*>(g.x) + static_cast<size_t>(m0) * g.lda;
  int r = tid / per_row, c = tid - r * per_row;
  while (r < rows) {
    uint4 raw[U];
    uint32_t off[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      off[u] = 0xffffffffu;
      if (r < rows) {
        const int k = c * VEC;
        raw[u] = __ldg(reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(r) * g.lda + k));
        off[u] = (k / W_BK) * W_SLAB + r * W_BK +
                 ((((k / 16) & 7) ^ (r & 7)) << 4) + (k & 15);
      }
      c += dc;
      r += dr;
      if (c >= per_row) {
        c -= per_row;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (off[u] != 0xffffffffu) store_codes<T>(sa + off[u], raw[u], q);
  }
}

template <typename T>
__device__ __forceinline__ void stage_pair(uint8_t* at, float a, float b);

template <>
__device__ __forceinline__ void stage_pair<float>(uint8_t* at, float a,
                                                  float b) {
  *reinterpret_cast<float2*>(at) = make_float2(a, b);
}

template <>
__device__ __forceinline__ void stage_pair<__nv_bfloat16>(uint8_t* at,
                                                          float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(a, b);
}

// A warp's eight staged rows (of the tile's rows t0..) out to device
// memory as 16-byte pieces: a warp instruction writes one row (fp32) or
// two (bf16); pieces past O (O is a multiple of a piece) and rows past T
// are not written. The stores do not wait for device memory.
template <typename T>
__device__ __forceinline__ void write_rows(const WArgs& g,
                                           const uint8_t* rows, int t0,
                                           int n0, int lane) {
  constexpr int PITCH = stg_pitch<T>();
  constexpr int PIECES = W_BN * static_cast<int>(sizeof(T)) / 16;
  constexpr int RPI = 32 / PIECES;
  constexpr int EPP = 16 / static_cast<int>(sizeof(T));
  T* out = static_cast<T*>(g.out);
  const int pc = lane % PIECES;
  const int o = n0 + pc * EPP;
#pragma unroll
  for (int it = 0; it < W_STG_ROWS / RPI; ++it) {
    const int rr = it * RPI + lane / PIECES;
    const int t = t0 + rr;
    if (t < g.T && o < g.O) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(rows + rr * PITCH + pc * 16);
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(t) * g.O + o) = v;
    }
  }
}

// The epilogue of one warp: its 16 rows x 128 columns of the tile at (m0,
// n0), in two passes of eight rows through its staging rows, with the
// tile's row scales and biases from ``cols``. The second pass's values are
// computed in the first and kept in acc as float bits.
template <typename T>
__device__ __forceinline__ void wgmma_epilogue(int (&acc)[64],
                                               const WArgs& g, uint8_t* rows,
                                               const float* cols, int m0,
                                               int n0, int warp, int lane) {
  constexpr int PITCH = stg_pitch<T>();
  const bool has_b = g.bias != nullptr;
  const int gq = lane / 4, t4 = lane % 4;
  uint8_t* mine = rows + gq * PITCH;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t4;
    const float2 s = *reinterpret_cast<const float2*>(cols + c);
    const float2 b = *reinterpret_cast<const float2*>(cols + W_BN + c);
    stage_pair<T>(mine + c * static_cast<int>(sizeof(T)),
                  scaled(acc[4 * j], s.x, b.x, has_b),
                  scaled(acc[4 * j + 1], s.y, b.y, has_b));
    acc[4 * j + 2] = __float_as_int(scaled(acc[4 * j + 2], s.x, b.x, has_b));
    acc[4 * j + 3] = __float_as_int(scaled(acc[4 * j + 3], s.y, b.y, has_b));
  }
  __syncwarp();
  write_rows<T>(g, rows, m0 + 16 * warp, n0, lane);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 16; ++j)
    stage_pair<T>(mine + (8 * j + 2 * t4) * static_cast<int>(sizeof(T)),
                  __int_as_float(acc[4 * j + 2]),
                  __int_as_float(acc[4 * j + 3]));
  __syncwarp();
  write_rows<T>(g, rows, m0 + 16 * warp + 8, n0, lane);
  __syncwarp();
}

// The persistent block of both variants on the tensor cores: "wgmma"
// (CODES false) quantizes each row tile of x into resident codes and takes
// w through the ring; "wgmma_codes" (CODES true) takes a 64-row slab of x's
// codes (``amap``, written by int8_gemm_codes_kernel) and w's stage through
// the ring together, and keeps nothing resident.
template <typename T, bool CODES>
__device__ __forceinline__ void wgmma_block(const WArgs& g,
                                            const CUtensorMap* wmap,
                                            const CUtensorMap* amap,
                                            uint8_t* smem) {
  constexpr int STAGE = ring_stage<CODES>();
  const int nk = (g.K + W_BK - 1) / W_BK;      // k stages a tile
  const int stages = g.stages;
  uint8_t* sa = smem;                          // the resident codes
  uint8_t* ring = CODES ? smem : smem + nk * W_SLAB;
  uint8_t* stg = ring + stages * STAGE;
  float* col_tab = reinterpret_cast<float*>(stg + stg_bytes<T>());
  uint64_t* full = reinterpret_cast<uint64_t*>(col_tab) + W_COLS / 8;
  uint64_t* empty = full + W_MAX_STAGES;
  uint64_t* turn = empty + W_MAX_STAGES;
  // this block's run of the row-major (row tile, column tile) order: an
  // even share of the tiles, or of the row tiles
  const long long units = g.whole_rows ? g.tiles / g.col_tiles : g.tiles;
  const int unit = g.whole_rows ? g.col_tiles : 1;
  const int t_begin =
      static_cast<int>(units * blockIdx.x / gridDim.x) * unit;
  const int t_end =
      static_cast<int>(units * (blockIdx.x + 1) / gridDim.x) * unit;
  const int m_begin = t_begin / g.col_tiles;
  const int m_end = (t_end - 1) / g.col_tiles + 1;

  if (threadIdx.x == 0) {
    if (smem_u32(smem) & 1023) __trap();   // the swizzle atoms' alignment
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init(&turn[0], 1);
    mbar_init(&turn[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup and warp, the same in every lane as the compiler can see
  // (a role it cannot prove uniform makes it serialize the wgmma)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x % 128 / 32, 0);
  const int lane = threadIdx.x % 32;
  K5_TICK_START;
  if (wg == W_CONSUMERS) {
    if (warp == 0) {
      // the producer: one thread streams the stages of every tile of the
      // run through the ring, in order, as the consumers release them
      if (lane == 0) {
        for (int i = 0; i < t_end - t_begin; ++i) {
          const int t = t_begin + i;
          const int n0 = t % g.col_tiles * W_BN;
          for (int kk = 0; kk < nk; ++kk) {
            const int slot = i * nk + kk, st = slot % stages;
            if (slot >= stages)
              mbar_wait(&empty[st], ((slot / stages) & 1) ^ 1);
            mbar_expect_tx(&full[st], STAGE);
            uint8_t* dst = ring + st * STAGE;
            if (CODES) {
              tma_load(dst, amap, &full[st], kk * W_BK,
                       t / g.col_tiles * W_BM);
              dst += W_SLAB;
            }
            tma_load(dst, wmap, &full[st], kk * W_BK, n0);
          }
        }
      }
      return;
    }
    if (CODES) return;               // no x to quantize
    // its other three warps quantize each row tile of the run with the
    // consumers
    const QuantI q = quanti_of(g.a_params, g.bits);
    for (int m = m_begin; m < m_end; ++m) {
      bar_row_tile();
      K5_TICK(PH_BAR);
      quantize_row_tile<T>(sa, g, q, m * W_BM, threadIdx.x - 32, W_XTHREADS);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      K5_TICK(PH_X);
      bar_row_tile();
      K5_TICK(PH_BAR);
    }
    return;
  }

  // The consumers: warpgroup wg takes the run's tiles i with i % 2 == wg.
  // A parity wait tells apart only neighbouring phases of a barrier, so
  // every warp's wait must come before the phase after the one it waits
  // for can complete. Hence the turns: a warpgroup starts its tile's waits
  // on the ring once turn[wg] says the other's tile before it is done,
  // handed over when that tile's products complete (then all four of its
  // warps have issued them, so have passed their waits). So the ring's
  // slots are waited for in order, and the slot a ring before was waited
  // for by every warp that needed it (else, with more stages to a tile
  // than the ring holds, the second warpgroup would take the first one's
  // stage for its own); and a warp that is late to its turn is never
  // passed by two turns (the leader hands a turn back only after its own
  // warps' products, which wait for the late warp).
  const int col = threadIdx.x % 128;
  const bool leader = col == 0;
  const T* bias = static_cast<const T*>(g.bias);
  uint8_t* rows = stg + (wg * 4 + warp) * W_STG_ROWS * stg_pitch<T>();
  const QuantI q = quanti_of(g.a_params, g.bits);
  int acc[64];
  for (int m = m_begin; m < m_end; ++m) {
    const int seg_end = min(t_end, (m + 1) * g.col_tiles);
    if (!CODES) {
      bar_row_tile();                // the last row tile's products are done
      K5_TICK(PH_BAR);
      quantize_row_tile<T>(sa, g, q, m * W_BM, threadIdx.x, W_XTHREADS);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      K5_TICK(PH_X);
      bar_row_tile();
      K5_TICK(PH_BAR);
    }
    for (int t = max(t_begin, m * g.col_tiles); t < seg_end; ++t) {
      const int i = t - t_begin;
      if ((i & 1) != wg) continue;
      const int n0 = t % g.col_tiles * W_BN;
      // this thread's column's scale and bias, read before the products
      // and tabled after them for the epilogue
      const int o = n0 + col;
      const float s_col = o < g.O ? g.scale_row[o] : 0.0f;
      const float b_col = bias != nullptr && o < g.O ? fq::to_f32(bias[o])
                                                     : 0.0f;
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0;
      if (i > 0) mbar_wait(&turn[wg], ((i - 1) >> 1) & 1);
      int prev = 0;
      for (int kk = 0; kk < nk; ++kk) {
        const int slot = i * nk + kk, st = slot % stages;
        mbar_wait(&full[st], (slot / stages) & 1);
        K5_TICK(PH_W);
        // A: the resident slab, or the stage's own; B: w's 128 rows
        const uint8_t* a = CODES ? ring + st * STAGE : sa + kk * W_SLAB;
        const uint8_t* b = ring + st * STAGE + (CODES ? W_SLAB : 0);
        fence_acc(acc);
        wgmma_fence();
        const int ksteps = min(W_BK, g.K - kk * W_BK + 31) / 32;
#pragma unroll
        for (int ks = 0; ks < W_BK / 32; ++ks)
          if (ks < ksteps)
            wgmma_m64n128k32(acc, smem_desc(a + ks * 32),
                             smem_desc(b + ks * 32), 1);
        wgmma_commit();
        fence_acc(acc);
        if (kk > 0) {                // the stage before this one is read
          wgmma_wait<1>();
          fence_acc(acc);
          if (leader) mbar_arrive(&empty[prev]);
        }
        prev = st;
        K5_TICK(PH_MMA);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (leader) {
        mbar_arrive(&empty[prev]);
        mbar_arrive(&turn[wg ^ 1]);      // the other warpgroup's turn
      }
      K5_TICK(PH_MMA);
      // two tables a warpgroup, by its tile's parity: every warp of the
      // warpgroup read the table two tiles back before it reached the
      // barrier of the last tile
      float* cols = col_tab + (wg * 2 + ((i >> 1) & 1)) * 2 * W_BN;
      cols[col] = s_col;
      cols[W_BN + col] = b_col;
      bar_warpgroup(wg);
      wgmma_epilogue<T>(acc, g, rows, cols, m * W_BM, n0, warp, lane);
      K5_TICK(PH_EPI);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(W_THREADS, 1)
    int8_gemm_wgmma_kernel(const WArgs g,
                           const __grid_constant__ CUtensorMap wmap) {
  extern __shared__ __align__(1024) uint8_t smem[];
  wgmma_block<T, false>(g, &wmap, nullptr, smem);
}

template <typename T>
__global__ void __launch_bounds__(W_THREADS, 1)
    int8_gemm_wgmma_codes_kernel(const WArgs g,
                                 const __grid_constant__ CUtensorMap wmap,
                                 const __grid_constant__ CUtensorMap amap) {
  extern __shared__ __align__(1024) uint8_t smem[];
  wgmma_block<T, true>(g, &wmap, &amap, smem);
}

// x's codes for "wgmma_codes", one 16-byte piece a thread: the codes of
// x[t, k0 .. k0 + 15] (0 past K) at row t, byte k0 of ``codes`` (rows of
// ``pitch`` bytes, K rounded up to W_BK), by QuantI as "wgmma" quantizes.
// A whole piece below K is read in loads of LOAD bytes, the widest that
// x's base and row stride allow (fp32 4 to 16, bf16 2 to 16); the piece
// at the end of a row elementwise.
struct CArgs {
  const void* x;
  const float* a_params;
  uint8_t* codes;
  long long pieces;                  // T * pitch / 16
  int K, lda, pitch, bits;
};

// The 16 elements' bits of one piece, in loads of LOAD bytes
template <int LOAD, int WORDS>
__device__ __forceinline__ void load_piece(uint32_t (&w)[WORDS],
                                           const void* src) {
  if constexpr (LOAD == 16) {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) {
      const uint4 v = __ldg(static_cast<const uint4*>(src) + i);
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (LOAD == 8) {
#pragma unroll
    for (int i = 0; i < WORDS / 2; ++i) {
      const uint2 v = __ldg(static_cast<const uint2*>(src) + i);
      w[2 * i] = v.x, w[2 * i + 1] = v.y;
    }
  } else if constexpr (LOAD == 4) {
#pragma unroll
    for (int i = 0; i < WORDS; ++i)
      w[i] = __ldg(static_cast<const unsigned int*>(src) + i);
  } else {
    static_assert(LOAD == 2, "loads of 2 to 16 bytes");
    const unsigned short* h = static_cast<const unsigned short*>(src);
#pragma unroll
    for (int i = 0; i < WORDS; ++i)
      w[i] = static_cast<uint32_t>(__ldg(h + 2 * i)) |
             static_cast<uint32_t>(__ldg(h + 2 * i + 1)) << 16;
  }
}

// element j of a piece's bits
__device__ __forceinline__ float piece_elem(const uint32_t* w, int j, float) {
  return __uint_as_float(w[j]);
}

__device__ __forceinline__ float piece_elem(const uint32_t* w, int j,
                                            __nv_bfloat16) {
  return __uint_as_float(j % 2 ? w[j / 2] & 0xffff0000u : w[j / 2] << 16);
}

template <typename T, int LOAD>
__global__ void __launch_bounds__(256)
    int8_gemm_codes_kernel(const CArgs g) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= g.pieces) return;
  const int per_row = g.pitch / 16;
  const long long t = p / per_row;
  const int k0 = static_cast<int>(p - t * per_row) * 16;
  const T* src = static_cast<const T*>(g.x) + t * g.lda + k0;
  const QuantI q = quanti_of(g.a_params, g.bits);
  int c[16];
  if (k0 + 16 <= g.K) {
    constexpr int WORDS = 16 * static_cast<int>(sizeof(T)) / 4;
    uint32_t w[WORDS];
    load_piece<LOAD>(w, src);
#pragma unroll
    for (int j = 0; j < 16; ++j) c[j] = code_int(piece_elem(w, j, T()), q);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      c[j] = k0 + j < g.K ? code_int(fq::to_f32(src[j]), q) : 0;
  }
  *reinterpret_cast<uint4*>(g.codes + t * g.pitch + k0) =
      make_uint4(pack4(c[0], c[1], c[2], c[3]), pack4(c[4], c[5], c[6], c[7]),
                 pack4(c[8], c[9], c[10], c[11]),
                 pack4(c[12], c[13], c[14], c[15]));
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n <= 0)
      n = 132;
    cached[device] = n;
  }
  return cached[device];
}

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: its address
// is looked up at run time, so the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of ``rows`` rows of ``cols`` int8 at ``base``, ``pitch``
// bytes apart: boxes of ``box_rows`` rows x 128 bytes, 128-byte swizzle,
// zeros past the edges. Returns 0, or the encoder's CUresult (-1 where no
// encoder is found).
int encode_map(CUtensorMap* map, const void* base, int cols, int rows,
               long long pitch, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {W_BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// the row pitch of x's codes in "wgmma_codes": K rounded up to a stage's k
constexpr int codes_pitch(int K) { return (K + W_BK - 1) / W_BK * W_BK; }

// int8_gemm_codes_kernel over x (T, K) into ``codes`` (T, codes_pitch(K))
template <typename T>
cudaError_t launch_codes(const Args& g, uint8_t* codes, cudaStream_t stream) {
  CArgs c;
  c.x = g.x;
  c.a_params = g.a_params;
  c.codes = codes;
  c.K = g.K, c.lda = g.lda, c.pitch = codes_pitch(g.K), c.bits = g.bits;
  c.pieces = static_cast<long long>(g.T) * (c.pitch / 16);
  const long long blocks = (c.pieces + 255) / 256;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  // the widest load a row's pieces allow: the lowest set bit of x's
  // address, of its row stride in bytes and of 16 (a piece starts 16
  // elements into a row)
  const uintptr_t bits = reinterpret_cast<uintptr_t>(g.x) |
                         static_cast<uintptr_t>(g.lda) * sizeof(T) | 16;
  const int load = static_cast<int>(bits & (~bits + 1));
  if (load < static_cast<int>(sizeof(T))) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (load) {
    case 16: int8_gemm_codes_kernel<T, 16><<<grid, 256, 0, stream>>>(c); break;
    case 8: int8_gemm_codes_kernel<T, 8><<<grid, 256, 0, stream>>>(c); break;
    case 4: int8_gemm_codes_kernel<T, 4><<<grid, 256, 0, stream>>>(c); break;
    default:
      if constexpr (sizeof(T) == 2)
        int8_gemm_codes_kernel<T, 2><<<grid, 256, 0, stream>>>(c);
  }
  return cudaGetLastError();
}

// "wgmma" (CODES false) or "wgmma_codes" (CODES true, its codes pass into
// ``codes`` first) on ``stream``
template <typename T, bool CODES>
cudaError_t launch_wgmma(const Args& g, const CUtensorMap& wmap,
                         uint8_t* codes, int device, cudaStream_t stream) {
  // the kernels' own guards (the wrapper routes by the same rules)
  constexpr int VEC = 16 / sizeof(T);
  if ((!CODES && (g.K % 16 != 0 || g.K > W_KMAX || g.lda % VEC != 0 ||
                  (reinterpret_cast<uintptr_t>(g.x) & 15) != 0)) ||
      (CODES && (codes == nullptr ||
                 (reinterpret_cast<uintptr_t>(codes) & 15) != 0)) ||
      (reinterpret_cast<uintptr_t>(g.out) & 15) != 0 ||
      g.O * static_cast<int>(sizeof(T)) % 16 != 0)
    return cudaErrorInvalidValue;
  const void* kernel =
      CODES ? reinterpret_cast<const void*>(int8_gemm_wgmma_codes_kernel<T>)
            : reinterpret_cast<const void*>(int8_gemm_wgmma_kernel<T>);
  static bool ready[64] = {false};
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const WLayout<T, CODES> layout(g.K);
  WArgs a;
  a.x = g.x;
  a.a_params = g.a_params;
  a.scale_row = g.scale_row;
  a.bias = g.bias;
  a.out = g.out;
  a.T = g.T, a.K = g.K, a.O = g.O, a.lda = g.lda, a.bits = g.bits;
  a.col_tiles = (g.O + W_BN - 1) / W_BN;
  a.stages = layout.stages;
  const long long tiles =
      static_cast<long long>((g.T + W_BM - 1) / W_BM) * a.col_tiles;
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  a.tiles = static_cast<int>(tiles);
  // Runs of whole row tiles where that costs a block less: a run of L
  // tiles spans up to ceil((L - 1) / col_tiles) + 1 row tiles, each
  // quantized once, at about 1.6 K / 128 tiles' time (the phase shares at
  // deit_small's widths on an H100: a row tile's quantization takes a
  // third of a qkv block's cycles, its nine tiles the rest). "wgmma_codes"
  // quantizes nothing: an even share of the tiles.
  const long long sms = sm_count(device);
  const long long row_tiles = tiles / a.col_tiles;
  const long long run = (tiles + sms - 1) / sms;
  const double q = 1.6 * g.K / W_BN;
  const double cost_tiles =
      run + q * ((run - 1 + a.col_tiles - 1) / a.col_tiles + 1);
  const double cost_rows =
      (row_tiles + sms - 1) / sms * (a.col_tiles + q);
  a.whole_rows = !CODES && cost_rows <= cost_tiles;
  const long long units = a.whole_rows ? row_tiles : tiles;
  const int grid = static_cast<int>(units < sms ? units : sms);
  if constexpr (CODES) {
    cudaError_t err = launch_codes<T>(g, codes, stream);
    if (err != cudaSuccess) return err;
    CUtensorMap amap;
    const int pitch = codes_pitch(g.K);
    if (encode_map(&amap, codes, pitch, g.T, pitch, W_BM) != 0)
      return cudaErrorInvalidValue;
    int8_gemm_wgmma_codes_kernel<T>
        <<<grid, W_THREADS, layout.bytes, stream>>>(a, wmap, amap);
  } else {
    int8_gemm_wgmma_kernel<T>
        <<<grid, W_THREADS, layout.bytes, stream>>>(a, wmap);
  }
  return cudaGetLastError();
}

}  // namespace

// The tensor map the variants on the tensor cores read w (O, K) int8
// through: rows ``ldw`` bytes apart, boxes of 128 rows x 128 k, 128-byte
// swizzle, zeros past the edges (so past K where ldw > K). Written to
// ``map128`` (128 bytes). ldw must be a multiple of 16, at least K, and w
// 16-byte aligned. Returns 0, or the encoder's CUresult (-1 where no
// encoder is found).
extern "C" int int8_gemm_wmap(void* map128, const void* w, int K, int O,
                              int ldw) {
  if (K <= 0 || O <= 0 || ldw < K || ldw % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int r = encode_map(&map, w, K, O, ldw, W_BN);
  if (r != 0) return r;
  memcpy(map128, &map, sizeof(map));
  return 0;
}

// "wgmma"'s largest resident K, and the row pitch of x's codes in
// "wgmma_codes" (the wrapper allocates them)
extern "C" int int8_gemm_kmax() { return W_KMAX; }

extern "C" int int8_gemm_codes_pitch(int K) { return codes_pitch(K); }

// A launch's layout at this K (dtype 0 = float32, 1 = bfloat16): what = 0
// the dynamic shared memory in bytes of "wgmma", 1 its ring's stages; 2
// and 3 the same of "wgmma_codes"
extern "C" int int8_gemm_layout(int dtype, int K, int what) {
  const WLayout<float, false> f(K);
  const WLayout<__nv_bfloat16, false> h(K);
  const WLayout<float, true> fc(K);
  const WLayout<__nv_bfloat16, true> hc(K);
  const int v[2][4] = {{f.bytes, f.stages, fc.bytes, fc.stages},
                       {h.bytes, h.stages, hc.bytes, hc.stages}};
  return v[dtype != 0][what];
}

#ifdef K5_PROFILE
// the kernels' cycles summed over warps, by phase (see K5_TICK); then all
// are zeroed
extern "C" int int8_gemm_profile(unsigned long long* host8) {
  cudaError_t err = cudaMemcpyFromSymbol(host8, k5_prof, sizeof(k5_prof));
  if (err != cudaSuccess) return err;
  unsigned long long zero[8] = {};
  return cudaMemcpyToSymbol(k5_prof, zero, sizeof(zero));
}
#endif

// variant: 0 = "mma", 1 = "wgmma", 2 = "wgmma_codes"; dtype: 0 = float32,
// 1 = bfloat16 (x, bias and out). x is (T, K) with row stride lda, w (O,
// K) int8 with row pitch ldw, wmap the 128 bytes of w's tensor map from
// int8_gemm_wmap (variants 1 and 2; null for "mma"), a_params (2,) fp32
// [scale, zero point], scale_row (O,) fp32, bias (O,) or null, out (T, O)
// contiguous, codes (variant 2) a scratch (T, int8_gemm_codes_pitch(K))
// int8 buffer, 16-byte aligned, bits the activation's (1..7). The launches
// go to ``stream`` of ``device``, which is made current for the call where
// it is not. Returns the CUDA error code of the launch.
extern "C" int int8_gemm_launch(int variant, int dtype, const void* x,
                                const void* w, const void* wmap,
                                const void* a_params, const void* scale_row,
                                const void* bias, void* out, void* codes,
                                int T, int K, int O, int lda, int ldw,
                                int bits, int device, void* stream) {
  if (variant < 0 || variant > 2 || (dtype != 0 && dtype != 1) ||
      bits < 1 || bits > 7 || T <= 0 || O <= 0 || K <= 0 || lda < K ||
      ldw < K || device < 0 || device >= 64 ||
      (variant != 0 && wmap == nullptr) ||
      (variant == 2 && codes == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  Args g;
  g.x = x;
  g.w = static_cast<const int8_t*>(w);
  g.a_params = static_cast<const float*>(a_params);
  g.scale_row = static_cast<const float*>(scale_row);
  g.bias = bias;
  g.out = out;
  g.T = T, g.K = K, g.O = O, g.lda = lda, g.ldw = ldw, g.bits = bits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* c = static_cast<uint8_t*>(codes);
  if (variant == 0) {
    err = dtype == 0 ? launch_mma<float>(g, s)
                     : launch_mma<__nv_bfloat16>(g, s);
  } else {
    CUtensorMap map;                 // aligned, as the launch copies it
    memcpy(&map, wmap, sizeof(map));
    if (variant == 1)
      err = dtype == 0 ? launch_wgmma<float, false>(g, map, c, device, s)
                       : launch_wgmma<__nv_bfloat16, false>(g, map, c,
                                                            device, s);
    else
      err = dtype == 0 ? launch_wgmma<float, true>(g, map, c, device, s)
                       : launch_wgmma<__nv_bfloat16, true>(g, map, c,
                                                           device, s);
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

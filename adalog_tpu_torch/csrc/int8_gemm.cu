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
// What bounds it: at the ViT widths it serves (deit_small at batch 32:
// T = 6304, K = 384, O = 384..1536) a call moves its fp32 x in and its
// output out, 20-50 MB, about 10 us at 3.35 TB/s, while its 2-7 G integer
// operations take 1-4 us at the card's 1979 dense int8 TOPS: bytes bound.
// What the card spends on top of that is the quantizer (an IEEE division an
// element) and x's reloads from L2, once per 128-column tile of the output.
//
// Design (the first, simple kernel; wgmma and TMA come later):
//   - one block of 256 threads (8 warps, 2 x 4) per 64 x 128 output tile,
//     k in steps of 64; a warp owns 32 rows x 32 columns, 2 x 4 tiles of
//     mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, int32 accumulators;
//     at most 128 registers a thread, so two blocks share an SM (128-row
//     tiles at one block an SM ran deit_small's four int8 sites in 0.247 ms
//     against 0.168, by CUDA graph on an H100; three blocks an SM spill);
//   - x: each thread loads its 16-byte pieces of the next k step into
//     registers before the products of this one, and quantizes them after,
//     in fp32 to the JAX package's bits (rint, the IEEE quotient by s from
//     its rounded reciprocal, fq_quant.cuh::div_rn_by_any; no FMA
//     contraction), into int8 codes in shared memory, [row][k] padded to 80
//     bytes so the fragment loads of a warp hit 32 banks;
//   - w: 16-byte cp.async of the next k step into a second buffer while this
//     one is multiplied (element loads where K is not a multiple of 16);
//   - fragments: the A operand's registers are 4 consecutive bytes of one
//     row, the B operand's 4 consecutive bytes of one row of w (the "col"
//     layout is w's own), so each is one 32-bit shared-memory load;
//   - epilogue: __int2float_rn of the sum (exact below 2^24, JAX's
//     convert above), one product with scale_row, one sum with the bias,
//     one rounding to x's dtype, stored in pairs where the row allows;
//   - ragged edges: rows past T and k past K are staged as code 0 and w
//     past O and K as 0, so padded products add 0; rows and columns past
//     the ends are computed and never stored. Pieces of x that are not
//     16-byte aligned (K or the row stride not a multiple of the piece)
//     take element loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "fq_quant.cuh"

namespace {

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
  int T, K, O, lda, bits;
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
      const int8_t* src = full ? g.w + static_cast<size_t>(o) * g.K + k : g.w;
      cp_async16(dst, src, full);
    } else {
      const int8_t* row = g.w + static_cast<size_t>(o < g.O ? o : 0) * g.K;
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

  Quant q;
  q.s = g.a_params[0];
  q.inv_s = __frcp_rn(q.s);
  q.zr = rintf(g.a_params[1]);
  q.qmax = fq::qmax_of(g.bits);

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
  cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_x(st, g, m0, (kt + 1) * BK, x_vec);
      load_w(sb[cur ^ 1], g, n0, (kt + 1) * BK, w_vec);
      cp_async_commit();
    }
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
    if (more) store_x(sa[cur ^ 1], st, g, q, m0, (kt + 1) * BK);
    cp_async_wait_all();
    __syncthreads();
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
        float y0 = __fmul_rn(__int2float_rn(acc[i][j][2 * h]), s0);
        float y1 = __fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), s1);
        if (bias) {
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
        }
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
}

template <typename T>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool x_vec = g.K % VEC == 0 && g.lda % VEC == 0 &&
                     (reinterpret_cast<uintptr_t>(g.x) & 15) == 0;
  const bool w_vec =
      g.K % 16 == 0 && (reinterpret_cast<uintptr_t>(g.w) & 15) == 0;
  const dim3 grid((g.O + BN - 1) / BN, (g.T + BM - 1) / BM);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  int8_gemm_kernel<T><<<grid, THREADS, 0, stream>>>(g, x_vec, w_vec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, bias and out). x is (T, K) with row
// stride lda, w (O, K) int8 contiguous, a_params (2,) fp32 [scale, zero
// point], scale_row (O,) fp32, bias (O,) or null, out (T, O) contiguous,
// bits the activation's (1..7). The launch goes to ``stream`` of ``device``,
// which is made current for the call where it is not. Returns the CUDA
// error code of the launch.
extern "C" int int8_gemm_launch(int dtype, const void* x, const void* w,
                                const void* a_params, const void* scale_row,
                                const void* bias, void* out, int T, int K,
                                int O, int lda, int bits, int device,
                                void* stream) {
  if ((dtype != 0 && dtype != 1) || bits < 1 || bits > 7 || T <= 0 ||
      O <= 0 || K <= 0 || lda < K)
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
  g.T = T, g.K = K, g.O = O, g.lda = lda, g.bits = bits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? launch<float>(g, s) : launch<__nv_bfloat16>(g, s);
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

// LayerNorm over the last dimension in one pass: kernel K7 of the port.
//
// Replaces no TPU kernel. The JAX package leaves LayerNorm to XLA, which
// fuses it into one loop over x. PyTorch runs models/layers.py's formula
// eagerly, one kernel a step (mean, x - mu, square, mean, x - mu again,
// + eps, rsqrt, * weight, + bias): the row is read about seven times and
// written about five. Here each row is read from device memory once into
// registers and the result written once.
//
// What bounds it: bytes. eva02_large_448's LayerNorm at batch 64 (65,600 x
// 1024 fp32) is 269 MB read and 269 MB written, 0.160 ms at the card's
// 3.35 TB/s; its sub-LN over 2730 is 0.428 ms. The arithmetic, two sums
// and about six operations a value, is far below the card's rate.
//
// Design:
//   - x is (rows, D) with row stride lda (elements); the output is
//     contiguous (rows, D). A row is held in registers by TPR threads, at
//     most MAX_VALS values a thread, the fewest threads that hold it, so
//     each thread keeps as many loads in flight as it can: at D <= 1024 4,
//     8, 16 or 32 lanes of a warp take a row (256 / TPR rows a block, sums
//     by shuffles; one lane a row's 16 bytes would leave too few bytes in
//     flight for the memory at D = 128); past it 128 or 512 threads share
//     a row (one row a block), their warps' sums joined in shared memory.
//     The wrapper (ops/layer_norm.py) picks TPR from D.
//   - Loads and stores move units of 16, 8, 4 or 2 bytes, the widest that
//     a row's length and every row's base in x and in the output, and the
//     weight and bias, are multiples of (the wrapper picks it: eva02's
//     sub-LN rows are 10,920 bytes, so 8; a ragged width takes scalars).
//   - Two reductions over the registers, in this order: mu = sum(x) / D,
//     then var = sum((x - mu)^2) / D (not Welford, not E[x^2] - mu^2).
//
// Numerics: the formula of models/layers.py::layer_norm_plain, in its
// order: y = (((x - mu) * rsqrt(var + eps)) * w) + b, every product and
// sum rounded on its own (the _rn intrinsics: no FMA contraction), rsqrtf
// as torch.rsqrt's kernel takes it, eps rounded to float as PyTorch's
// scalar add rounds it, mu and var as IEEE quotients. Only the order of
// the two sums differs from PyTorch's reduction kernels, so in float32 the
// output moves by the last bits of mu and var. A bfloat16 x, weight and
// bias are read into float32, and all arithmetic is in float32 with the
// result rounded once at the store; the eager chain rounds every step to
// bfloat16, so in bfloat16 this kernel is the more accurate of the two.
// NaN and Inf propagate as in the chain: a row holding either gives NaN
// wherever the chain does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_VALS = 32;    // values a thread holds in registers

// a unit of BYTES bytes, moved by one load or store
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };

__device__ __forceinline__ float bf16_bits(unsigned h) {
  return __uint_as_float(h << 16);
}
__device__ __forceinline__ unsigned to_bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// V values of T from p (aligned to a unit) into f[0..V). A unit of 4 or
// more bytes is taken apart as 32-bit words (two bfloat16 a word, the
// first in the low half), which keeps it in registers.
template <typename T, int V>
__device__ __forceinline__ void load_unit(const T* p, float* f) {
  constexpr int BYTES = V * static_cast<int>(sizeof(T));
  if constexpr (BYTES == 2) {
    f[0] = bf16_bits(*reinterpret_cast<const unsigned short*>(p));
  } else {
    union { typename Raw<BYTES>::type raw; unsigned w[BYTES / 4]; } u;
    u.raw = *reinterpret_cast<const decltype(u.raw)*>(p);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if constexpr (sizeof(T) == 4)
        f[i] = __uint_as_float(u.w[i]);
      else
        f[i] = bf16_bits(i % 2 ? u.w[i / 2] >> 16 : u.w[i / 2] & 0xffffu);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_unit(T* p, const float* f) {
  constexpr int BYTES = V * static_cast<int>(sizeof(T));
  if constexpr (BYTES == 2) {
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>(to_bf16_bits(f[0]));
  } else {
    union { typename Raw<BYTES>::type raw; unsigned w[BYTES / 4]; } u;
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) {
      if constexpr (sizeof(T) == 4)
        u.w[i] = __float_as_uint(f[i]);
      else
        u.w[i] = to_bf16_bits(f[2 * i]) | (to_bf16_bits(f[2 * i + 1]) << 16);
    }
    *reinterpret_cast<decltype(u.raw)*>(p) = u.raw;
  }
}

// threads a block: 256 where a row takes at most a warp, else the row's
template <int TPR>
__host__ __device__ constexpr int block_threads() {
  return TPR <= 32 ? 256 : TPR;
}

// the sum of s over the TPR threads of a row, the same in every one of
// them: a butterfly of shuffles among the row's lanes of a warp (a + b
// rounds as b + a, so every lane ends with the same bits), then, where
// several warps share the row, the warps' sums through shared memory in
// warp order. Every thread of the block calls it.
template <int TPR>
__device__ __forceinline__ float row_sum(float s, float* red) {
#pragma unroll
  for (int o = (TPR < 32 ? TPR : 32) / 2; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  if constexpr (TPR <= 32) {
    return s;
  } else {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
    __syncthreads();
    float t = red[0];
#pragma unroll
    for (int i = 1; i < TPR / 32; ++i) t = __fadd_rn(t, red[i]);
    return t;
  }
}

// T: float or bfloat16; V: values a unit; TPR: threads a row (4, 8, 16 or
// 32 with 256 / TPR rows a block; 128 or 512 with one row a block)
template <typename T, int V, int TPR>
__global__ void __launch_bounds__(block_threads<TPR>())
layer_norm_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ b, T* __restrict__ out,
                       long long rows, int D, long long lda, float eps) {
  constexpr int P = MAX_VALS / V;                 // units a thread
  constexpr int RPB = block_threads<TPR>() / TPR; // rows a block
  // [0] the sums of x, [1] of the squares: two buffers, so one barrier a
  // sum orders both the writes after the reads of the row before
  __shared__ float red[2][TPR <= 32 ? 1 : TPR / 32];

  const int lane = threadIdx.x % TPR;
  const int units = D / V;                        // V divides D
  const float n = static_cast<float>(D);          // exact: D <= 16384

  // the block's rows advance together, so every thread reaches each
  // shuffle and barrier; a thread past the last row loads and stores
  // nothing
  for (long long r0 = static_cast<long long>(blockIdx.x) * RPB; r0 < rows;
       r0 += static_cast<long long>(gridDim.x) * RPB) {
    const long long r = r0 + threadIdx.x / TPR;
    const bool live = r < rows;
    const T* xr = x + r * lda;
    float v[MAX_VALS];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int u = j * TPR + lane;
      if (live && u < units) {
        load_unit<T, V>(xr + u * V, v + j * V);
#pragma unroll
        for (int i = 0; i < V; ++i) s = __fadd_rn(s, v[j * V + i]);
      }
    }
    const float mu = __fdiv_rn(row_sum<TPR>(s, red[0]), n);

    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (live && j * TPR + lane < units) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = __fsub_rn(v[j * V + i], mu);
          q = __fadd_rn(q, __fmul_rn(d, d));
        }
      }
    }
    const float var = __fdiv_rn(row_sum<TPR>(q, red[1]), n);
    const float rs = rsqrtf(__fadd_rn(var, eps));
    if (!live) continue;

    T* outr = out + r * D;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int u = j * TPR + lane;
      if (u < units) {
        float wv[V], bv[V];
        load_unit<T, V>(w + u * V, wv);
        load_unit<T, V>(b + u * V, bv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float y = __fmul_rn(__fsub_rn(v[j * V + i], mu), rs);
          v[j * V + i] = __fadd_rn(__fmul_rn(y, wv[i]), bv[i]);
        }
        store_unit<T, V>(outr + u * V, v + j * V);
      }
    }
  }
}

template <typename T, int V, int TPR>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   long long rows, int D, long long lda, float eps,
                   cudaStream_t stream) {
  constexpr int threads = block_threads<TPR>();
  constexpr long long rpb = threads / TPR;
  long long blocks = (rows + rpb - 1) / rpb;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;
  layer_norm_rows_kernel<T, V, TPR>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const T*>(b), static_cast<T*>(out), rows, D, lda, eps);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_tpr(int tpr, const void* x, const void* w, const void* b,
                       void* out, long long rows, int D, long long lda,
                       float eps, cudaStream_t stream) {
  switch (tpr) {
    case 4:
      return launch<T, V, 4>(x, w, b, out, rows, D, lda, eps, stream);
    case 8:
      return launch<T, V, 8>(x, w, b, out, rows, D, lda, eps, stream);
    case 16:
      return launch<T, V, 16>(x, w, b, out, rows, D, lda, eps, stream);
    case 32:
      return launch<T, V, 32>(x, w, b, out, rows, D, lda, eps, stream);
    case 128:
      return launch<T, V, 128>(x, w, b, out, rows, D, lda, eps, stream);
    default:
      return launch<T, V, 512>(x, w, b, out, rows, D, lda, eps, stream);
  }
}

template <typename T>
cudaError_t launch_unit(int unit_bytes, int tpr, const void* x,
                        const void* w, const void* b, void* out,
                        long long rows, int D, long long lda, float eps,
                        cudaStream_t stream) {
  constexpr int S = static_cast<int>(sizeof(T));
  switch (unit_bytes) {
    case 16:
      return launch_tpr<T, 16 / S>(tpr, x, w, b, out, rows, D, lda, eps,
                                   stream);
    case 8:
      return launch_tpr<T, 8 / S>(tpr, x, w, b, out, rows, D, lda, eps,
                                  stream);
    case 4:
      return launch_tpr<T, 4 / S>(tpr, x, w, b, out, rows, D, lda, eps,
                                  stream);
    default:
      return launch_tpr<T, 1>(tpr, x, w, b, out, rows, D, lda, eps, stream);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, b and out). x is (rows, D) with
// row stride lda (elements), out (rows, D) contiguous, w and b (D,).
// unit_bytes (16, 8, 4, or 2 for bfloat16) is the width of a load: x, out,
// w and b, every row of x, and D values, must be multiples of it. tpr (4, 8,
// 16, 32, 128 or 512) threads take a row, which holds at most 32 * tpr
// values. The
// launch goes to ``stream`` of ``device``, which is made current for the
// call where it is not. Returns the CUDA error code of the launch.
extern "C" int layer_norm_rows_launch(int dtype, int unit_bytes, int tpr,
                                      const void* x, const void* w,
                                      const void* b, void* out,
                                      long long rows, int D, long long lda,
                                      float eps, int device, void* stream) {
  const int item = dtype == 0 ? 4 : 2;
  const bool unit_ok = unit_bytes == 16 || unit_bytes == 8 ||
                       unit_bytes == 4 || (unit_bytes == 2 && dtype == 1);
  if ((dtype != 0 && dtype != 1) || !unit_ok ||
      (tpr != 4 && tpr != 8 && tpr != 16 && tpr != 32 && tpr != 128 &&
       tpr != 512) ||
      rows < 1 || D < 1 ||
      D > MAX_VALS * tpr || (rows > 1 && lda < D) || device < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(x, unit_bytes) || !aligned(out, unit_bytes) ||
      !aligned(w, unit_bytes) || !aligned(b, unit_bytes) ||
      (static_cast<long long>(D) * item) % unit_bytes != 0 ||
      (rows > 1 && (lda * item) % unit_bytes != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? launch_unit<float>(unit_bytes, tpr, x, w, b, out, rows,
                                        D, lda, eps, s)
                   : launch_unit<__nv_bfloat16>(unit_bytes, tpr, x, w, b,
                                                out, rows, D, lda, eps, s);
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

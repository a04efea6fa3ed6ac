// The activation fake quantizer of a served Linear site in one pass: kernel
// K6 of the port.
//
// Replaces no TPU kernel. The JAX package leaves
// adalog_tpu/quantizers/apply.py::apply_quantizer to XLA, which fuses its
// elementwise chain into one loop over x. PyTorch runs the same chain
// eagerly, one kernel a step: about 20 passes over x at an AdaLog site,
// about 6 at a uniform one. Here the chain is one launch that reads x once
// and writes the fake-quantized x once, for the two kinds the served Linear
// sites have:
//   uniform (asymmetric)  (clamp(rint(x / s) + z, 0, 2N - 1) - z) * s
//   uniform (symmetric)   clamp(rint(x / s), -N, N - 1) * s
//   adalog                v[c] * s * (c < 2N), c = clamp(rint(-log2(
//                         clamp(x / s, 1e-15, 1)) * k), 0, 2N - 1)
// with N = 2^(bits - 1), z the rounded zero point, k = 37 / q, v[c] the
// shift-and-mantissa value of code c, and, at a post-GeLU site, x + shift
// quantized and shift * (1 - bias_reparamed) subtracted after.
//
// What bounds it: bytes. deit_small's fc2 input at a batch of 200 (T =
// 39,400, K = 1536) is 242 MB in fp32, read once and written once: 484 MB,
// 0.145 ms at the card's 3.35 TB/s. Its arithmetic, about 40 instructions
// an element at an AdaLog site, takes 132 SMs x 128 lanes about a third of
// that time, so a pass has to keep device memory busy and little else.
//
// Design:
//   - x is (rows, cols) with row stride lda (one row for a contiguous x), so
//     a row-strided view such as the class token's slice is read in place;
//     the output is contiguous.
//   - 16-byte pieces (4 fp32 or 8 bf16 values), two in flight a thread, in a
//     grid-stride loop over as many 256-thread blocks as the card holds at
//     once (the occupancy times the SMs). A row whose length is not a
//     multiple of a piece ends in a scalar tail; an x whose base or row
//     stride is not 16-byte aligned takes the scalar loop throughout.
//   - AdaLog: the value of each of the 2N codes times the scale comes from
//     a table in shared memory, so no element computes exp2, floor or a
//     remainder.
//   - The quotient x / s is fq::div_rn_by_any (a zero's sign kept), from
//     the reciprocal of s taken once a thread.
//
// Numerics: bit for bit the eager chain of apply_quantizer on the card.
// Every value that depends on the quantizer state alone (s, the rounded
// zero point, k = 37 / q as PyTorch's reciprocal-times-37 gives it, the
// shift, the shift-back term, the table of v[c] * s) is PyTorch's own
// evaluation, by the wrapper (ops/fq_act.py), once per predictor. The
// per-element steps repeat the eager kernels one for one: accurate log2f,
// rintf (half to even), the IEEE quotient, each product and sum rounded on
// its own (the _rn intrinsics: no FMA contraction), and clamps that keep
// NaN, as torch.clamp does. The output is rounded once to x's dtype.

#include <cstring>

#include "fq_quant.cuh"

namespace {

constexpr int KIND_UNIFORM = 0;     // asymmetric uniform
constexpr int KIND_SYMMETRIC = 1;   // symmetric uniform
constexpr int KIND_ADALOG = 2;
constexpr int TABLE_MAX = 256;      // 2N of 8 bits
constexpr int THREADS = 256;

// one site's parameters, passed by value (as ops/fq_act.py's Params)
struct FqActParams {
  float scale;              // the site's one scale
  float zp;                 // the rounded zero point (asymmetric uniform)
  float lo, hi;             // uniform: the codes' clamp
  float k;                  // AdaLog: 37 / q
  float shift;              // added to x first, where shifted
  float back;               // shift * (1 - bias_reparamed), subtracted last
  int shifted;
  int n_table;              // AdaLog: 2N
  float table[TABLE_MAX];   // AdaLog: v[c] * s of each code c < 2N
};

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// x / s, the IEEE quotient: fq::div_rn_by_any, whose correction turns a
// quotient of -0 into +0, for every dividend but a zero, whose quotient is
// the zero times the positive reciprocal (the symmetric quantizer keeps the
// sign of a zero)
__device__ __forceinline__ float div_by(float a, float s, float y) {
  return a == 0.0f ? __fmul_rn(a, y) : fq::div_rn_by_any(a, s, y);
}

template <int KIND>
__device__ __forceinline__ float quant(float v, const FqActParams& p,
                                       float y, const float* tab) {
  if (p.shifted) v = __fadd_rn(v, p.shift);
  const float t = div_by(v, p.scale, y);
  float o;
  if (KIND == KIND_ADALOG) {
    const float n2 = static_cast<float>(p.n_table);
    const float s = clamp_keep_nan(t, 1e-15f, 1.0f);
    float code = rintf(__fmul_rn(-log2f(s), p.k));
    const float keep = code < n2 ? 1.0f : 0.0f;
    code = clamp_keep_nan(code, 0.0f, n2 - 1.0f);
    const float dq = isnan(code) ? code : tab[static_cast<int>(code)];
    o = __fmul_rn(dq, keep);
  } else if (KIND == KIND_SYMMETRIC) {
    o = __fmul_rn(clamp_keep_nan(rintf(t), p.lo, p.hi), p.scale);
  } else {
    const float c = clamp_keep_nan(__fadd_rn(rintf(t), p.zp), p.lo, p.hi);
    o = __fmul_rn(__fsub_rn(c, p.zp), p.scale);
  }
  if (p.shifted) o = __fsub_rn(o, p.back);
  return o;
}

__device__ __forceinline__ float load_one(const float* p) { return *p; }
__device__ __forceinline__ float load_one(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// a 16-byte piece of x or of the output
union Piece {
  uint4 u;
  float f[4];
  unsigned short h[8];
};

template <typename T>
struct PieceOf;

template <>
struct PieceOf<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ float get(const Piece& a, int i) {
    return a.f[i];
  }
  static __device__ __forceinline__ void set(Piece& a, int i, float v) {
    a.f[i] = v;
  }
};

template <>
struct PieceOf<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ float get(const Piece& a, int i) {
    return __uint_as_float(static_cast<unsigned>(a.h[i]) << 16);
  }
  static __device__ __forceinline__ void set(Piece& a, int i, float v) {
    a.h[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <int KIND, typename T>
__device__ __forceinline__ void quant_piece(Piece& a, const FqActParams& p,
                                            float y, const float* tab) {
#pragma unroll
  for (int i = 0; i < PieceOf<T>::N; ++i)
    PieceOf<T>::set(a, i, quant<KIND>(PieceOf<T>::get(a, i), p, y, tab));
}

// VEC: x's base and row stride and the output's rows are 16-byte aligned
template <int KIND, typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
fq_act_quant_kernel(const __grid_constant__ FqActParams p,
                    const T* __restrict__ x, T* __restrict__ out,
                    long long rows, long long cols, long long lda) {
  __shared__ float tab[KIND == KIND_ADALOG ? TABLE_MAX : 1];
  if (KIND == KIND_ADALOG) {
    for (int i = threadIdx.x; i < p.n_table; i += blockDim.x)
      tab[i] = p.table[i];
    __syncthreads();
  }
  const float y = __frcp_rn(p.scale);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* xr = x + r * lda;
    T* outr = out + r * cols;
    long long done = 0;
    if (VEC) {
      constexpr int P = PieceOf<T>::N;
      const long long n = cols / P;
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      uint4* ov = reinterpret_cast<uint4*>(outr);
      long long v = first;
      for (; v + stride < n; v += 2 * stride) {
        Piece a, b;
        a.u = xv[v];
        b.u = xv[v + stride];
        quant_piece<KIND, T>(a, p, y, tab);
        quant_piece<KIND, T>(b, p, y, tab);
        ov[v] = a.u;
        ov[v + stride] = b.u;
      }
      if (v < n) {
        Piece a;
        a.u = xv[v];
        quant_piece<KIND, T>(a, p, y, tab);
        ov[v] = a.u;
      }
      done = n * P;
    }
    for (long long i = done + first; i < cols; i += stride)
      store_one(outr + i, quant<KIND>(load_one(xr + i), p, y, tab));
  }
}

int sm_count(int device) {
  static int count[64] = {};
  if (count[device] == 0)
    cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount,
                           device);
  return count[device];
}

template <int KIND, typename T, bool VEC>
cudaError_t launch(const FqActParams& p, const void* x, void* out,
                   long long rows, long long cols, long long lda, int device,
                   cudaStream_t stream) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fq_act_quant_kernel<KIND, T, VEC>, THREADS, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
  }
  // units a thread takes in one step of the loop: two pieces, or one value
  const long long unit = VEC ? 2LL * PieceOf<T>::N : 1;
  const long long need = (cols + unit * THREADS - 1) / (unit * THREADS);
  const long long ry = rows < 65535 ? rows : 65535;
  long long resident = static_cast<long long>(per_sm) * sm_count(device) / ry;
  if (resident < 1) resident = 1;
  const dim3 grid(static_cast<unsigned>(need < resident ? need : resident),
                  static_cast<unsigned>(ry));
  fq_act_quant_kernel<KIND, T, VEC><<<grid, THREADS, 0, stream>>>(
      p, static_cast<const T*>(x), static_cast<T*>(out), rows, cols, lda);
  return cudaGetLastError();
}

template <int KIND, typename T>
cudaError_t launch_aligned(const FqActParams& p, const void* x, void* out,
                           long long rows, long long cols, long long lda,
                           int device, cudaStream_t stream) {
  constexpr long long P = PieceOf<T>::N;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                   (rows == 1 || (cols % P == 0 && lda % P == 0));
  return vec ? launch<KIND, T, true>(p, x, out, rows, cols, lda, device,
                                     stream)
             : launch<KIND, T, false>(p, x, out, rows, cols, lda, device,
                                      stream);
}

template <typename T>
cudaError_t launch_kind(int kind, const FqActParams& p, const void* x,
                        void* out, long long rows, long long cols,
                        long long lda, int device, cudaStream_t stream) {
  switch (kind) {
    case KIND_UNIFORM:
      return launch_aligned<KIND_UNIFORM, T>(p, x, out, rows, cols, lda,
                                             device, stream);
    case KIND_SYMMETRIC:
      return launch_aligned<KIND_SYMMETRIC, T>(p, x, out, rows, cols, lda,
                                               device, stream);
    default:
      return launch_aligned<KIND_ADALOG, T>(p, x, out, rows, cols, lda,
                                            device, stream);
  }
}

}  // namespace

// sizeof the parameters, for the wrapper's check of its own layout
extern "C" int fq_act_params_bytes() {
  return static_cast<int>(sizeof(FqActParams));
}

// kind: 0 = asymmetric uniform, 1 = symmetric uniform, 2 = AdaLog; dtype: 0
// = float32, 1 = bfloat16 (x and out). x is (rows, cols) with row stride
// lda (elements), out (rows, cols) contiguous, params an FqActParams. The
// launch goes to ``stream`` of ``device``, which is made current for the
// call where it is not. Returns the CUDA error code of the launch.
extern "C" int fq_act_quant_launch(int kind, int dtype, const void* x,
                                   void* out, long long rows, long long cols,
                                   long long lda, const void* params,
                                   int device, void* stream) {
  if (kind < 0 || kind > 2 || (dtype != 0 && dtype != 1) || rows < 1 ||
      cols < 1 || (rows > 1 && lda < cols) || params == nullptr ||
      device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidValue);
  FqActParams p;
  memcpy(&p, params, sizeof(p));
  if (kind == KIND_ADALOG && (p.n_table < 1 || p.n_table > TABLE_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0
            ? launch_kind<float>(kind, p, x, out, rows, cols, lda, device, s)
            : launch_kind<__nv_bfloat16>(kind, p, x, out, rows, cols, lda,
                                         device, s);
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

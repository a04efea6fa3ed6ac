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
// GFLOP, about 20 flops a byte), so on paper the memory rate and the fp32
// FMA rate bound it about equally. In this first version the product runs
// on the FMA pipes out of shared memory, one 4-byte shared load per FMA per
// lane, and each warp walks one row's dependent loads, so shared-memory
// latency sets the time, as in fq_flash_attn.cu. The quantizer of A costs a
// division or two and (AdaLog) a log2f and an exp2f per element, once.
//
// Design (simple and exact first; tensor cores are later work), the second
// half of fq_flash_attn.cu made general:
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
//     5 rounds, not 12 warps with one busy in the last round.
// All loads are scalar and coalesced; S = 49 and 197 are odd, so rows are
// not 16-byte aligned. Numerics follow the JAX kernel and fq_flash_attn.cu:
// quantizer math in fp32, operands rounded to the compute dtype before the
// product, fp32 accumulation; the softmax is exp(l - max) / sum with the
// sum taken lane-strided then across the warp, exactly as in
// fq_flash_attn.cu, so K2 on the logits K1 forms gives K1's output.

#include "fq_quant.cuh"

namespace {

using namespace fq;

constexpr int MAX_WARPS = 12;        // must match ops/fq_attn.py _WARPS
constexpr int COLS_PER_LANE = 8;     // output chunk of 256 columns

template <typename T, bool ADALOG, bool SOFTMAX>
__global__ void __launch_bounds__(MAX_WARPS * 32)
fq_attn_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                      const float* __restrict__ ap, const float* __restrict__ bp,
                      float* __restrict__ out, int S, int K, int C, int tiles,
                      int rows_per_block, int a_bits, int b_bits) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ float smem[];
  float* b_s = smem;                     // (K, C)
  float* a_s = b_s + K * C;              // (warps, K)

  const int g = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * rows_per_block;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const float a0 = ap[2 * g], az = rintf(ap[2 * g + 1]);
  const float bs = bp[2 * g], bz = rintf(bp[2 * g + 1]);
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

template <typename T, bool ADALOG, bool SOFTMAX>
cudaError_t launch(const void* A, const void* B, const float* ap,
                   const float* bp, float* out, int G, int S, int K, int C,
                   int rows_per_block, int warps, int a_bits, int b_bits,
                   cudaStream_t stream) {
  if (rows_per_block < 1 || warps < 1 || warps > MAX_WARPS)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(K * C + warps * K) * sizeof(float);
  auto kernel = fq_attn_matmul_kernel<T, ADALOG, SOFTMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (S + rows_per_block - 1) / rows_per_block;
  const long long blocks = static_cast<long long>(G) * tiles;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B), ap, bp, out, S, K,
      C, tiles, rows_per_block, a_bits, b_bits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int mode, const void* A, const void* B,
                        const float* ap, const float* bp, float* out, int G,
                        int S, int K, int C, int rows_per_block, int warps,
                        int a_bits, int b_bits, cudaStream_t st) {
  if (mode == 0)
    return launch<T, false, false>(A, B, ap, bp, out, G, S, K, C,
                                   rows_per_block, warps, a_bits, b_bits, st);
  if (mode == 1)
    return launch<T, true, false>(A, B, ap, bp, out, G, S, K, C,
                                  rows_per_block, warps, a_bits, b_bits, st);
  if (mode == 2)
    return launch<T, true, true>(A, B, ap, bp, out, G, S, K, C,
                                 rows_per_block, warps, a_bits, b_bits, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 inputs, 1 = bfloat16 inputs. mode: 0 = K3 with uniform
// A, 1 = K3 with AdaLog A, 2 = K2 (row softmax, then AdaLog A). A is
// (G, S, K), B (G, K, C); ap (G, 2) fp32 [scale or AdaLog base, zero point],
// bp (G, 2) fp32 [scale, zero point]; out (G, S, C) fp32. rows_per_block
// and warps (<= 12) are the wrapper's tiling. Returns the CUDA error code of
// the launch.
extern "C" int fq_attn_matmul_launch(int dtype, int mode, const void* A,
                                     const void* B, const void* ap,
                                     const void* bp, void* out, int G, int S,
                                     int K, int C, int rows_per_block,
                                     int warps, int a_bits, int b_bits,
                                     void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mode<float>(mode, A, B, f(ap), f(bp),
                              static_cast<float*>(out), G, S, K, C,
                              rows_per_block, warps, a_bits, b_bits, st);
  if (dtype == 1)
    return launch_mode<__nv_bfloat16>(mode, A, B, f(ap), f(bp),
                                      static_cast<float*>(out), G, S, K, C,
                                      rows_per_block, warps, a_bits, b_bits,
                                      st);
  return static_cast<int>(cudaErrorInvalidValue);
}

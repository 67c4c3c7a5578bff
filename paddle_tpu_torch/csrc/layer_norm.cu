// K11 — fused bias + dropout + residual + LayerNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/layer_norm.py
// `_fwd_kernel` (launched by `_fwd_pallas`, the pl.pallas_call at :120).
// Per row of the flattened (M, N) input, in fp32:
//
//   pre  = residual + dropout(x + bias)     (kept cells divided by 1 - p)
//   y    = (pre - mean) * rstd * gamma + beta,  rstd = rsqrt(var + eps)
//
// y and pre are written in x's dtype, mean and rstd (M,) in fp32 (the
// backward, plain PyTorch as in JAX, replays the mask and recomputes
// xhat from the rounded pre and these statistics). The dropout mask is
// the TPU kernel's hash of the cell's global index (common.cuh pt::mix),
// so the kernel, its plain version and the JAX kernel drop the same
// cells. The mean and the centred variance are two passes over the row.
//
// Design. One block of 128 threads per row. The row's fp32 `pre` is
// staged in dynamic shared memory (4 N bytes), so x, bias and residual
// are read once and any N up to kMaxN works; the TPU's N % 128 gate was
// a lane-tiling limit. Block-wide sums go through warp shuffles and one
// shared slot per warp. gamma, beta and bias arrive as fp32 (the wrapper
// casts the three vectors).
//
// Bound on the H100: bytes. At the encoder's shape (M 8192, N 768,
// bf16 with residual) it moves x, residual, y and pre (4 x 12.6 MB) and
// 64 KB of statistics: about 0.015 ms at 3.35 TB/s, against some 10
// flops per element. Loads are one element a thread (coalesced across a
// warp); 16-byte vector loads are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 16384;               // 64 KB of fp32 row in smem

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x / 32;
  __syncthreads();                         // red free from the last use
  if (threadIdx.x % 32 == 0) red[w] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ln_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
             const float* __restrict__ beta, const float* __restrict__ bias,
             const T* __restrict__ residual, T* __restrict__ y,
             T* __restrict__ pre_out, float* __restrict__ mean_out,
             float* __restrict__ rstd_out, int N, float eps,
             const int* __restrict__ seed_ptr, unsigned thresh,
             float keep_div) {
  extern __shared__ float pre[];
  __shared__ float red[kWarps];
  const long row = blockIdx.x;
  const long base = row * N;
  const bool dropout = seed_ptr != nullptr;
  const unsigned seed = dropout ? static_cast<unsigned>(*seed_ptr) : 0u;
  float s = 0.f;
  for (int j = threadIdx.x; j < N; j += kThreads) {
    float v = pt::to_float(x[base + j]);
    if (bias != nullptr) v += bias[j];
    if (dropout) {
      const unsigned lin =
          static_cast<unsigned>(row) * static_cast<unsigned>(N) +
          static_cast<unsigned>(j);
      v = pt::mix(pt::mix(lin ^ seed)) >= thresh ? v / keep_div : 0.f;
    }
    if (residual != nullptr) v += pt::to_float(residual[base + j]);
    pre[j] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / N;
  float q = 0.f;
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const float d = pre[j] - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, red) / N + eps);
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const float v = pre[j];
    y[base + j] = pt::from_float<T>((v - mean) * rstd * gamma[j] + beta[j]);
    pre_out[base + j] = pt::from_float<T>(v);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta,
           const void* bias, const void* residual, void* y, void* pre,
           void* mean, void* rstd, int M, int N, float eps,
           const int* seed, unsigned thresh, float keep_div,
           cudaStream_t st) {
  const int smem = N * static_cast<int>(sizeof(float));
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fused_ln_fwd<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxN * 4));
  if (rc != 0) return rc;
  fused_ln_fwd<T><<<M, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(bias),
      static_cast<const T*>(residual), static_cast<T*>(y),
      static_cast<T*>(pre), static_cast<float*>(mean),
      static_cast<float*>(rstd), N, eps, seed, thresh, keep_div);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pt_fused_layer_norm_max_n() { return kMaxN; }

// x, residual (or null), y, pre (M, N) contiguous, of one dtype; gamma,
// beta, bias (or null) (N,) fp32; mean, rstd (M,) fp32. A non-null
// `seed` (the int32 seed on the device, read there so that drawing it
// never waits for the card) applies the hash mask with `thresh` and
// divides kept cells by `keep_div` (1 - p, rounded to fp32 by the
// caller). The caller guarantees 0 < N <= kMaxN and M > 0.
extern "C" int pt_fused_layer_norm_fwd(int dtype, const void* x,
                                       const void* gamma, const void* beta,
                                       const void* bias,
                                       const void* residual, void* y,
                                       void* pre, void* mean, void* rstd,
                                       int M, int N, float eps,
                                       const void* seed, unsigned thresh,
                                       float keep_div, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* seed_i = static_cast<const int*>(seed);
  if (N <= 0 || N > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == pt::kBFloat16)
    return launch<__nv_bfloat16>(x, gamma, beta, bias, residual, y, pre,
                                 mean, rstd, M, N, eps, seed_i, thresh,
                                 keep_div, st);
  if (dtype == pt::kFloat32)
    return launch<float>(x, gamma, beta, bias, residual, y, pre, mean,
                         rstd, M, N, eps, seed_i, thresh, keep_div, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

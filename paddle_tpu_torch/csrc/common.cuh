// Shared helpers of the port's CUDA kernels (plain C interface, built by
// paddle_tpu_torch/ops/_build.py with nvcc for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace pt {

// dtype codes the Python wrappers pass (ops/_build.py callers)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// the finite floor of the running max: a tile whose every score is
// masked gives p = exp(-inf - floor) = 0 instead of exp(-inf + inf) = NaN
// (the same floor as the Pallas kernels this port replaces)
constexpr float kMaxFloor = -1e30f;

template <typename T>
__device__ __forceinline__ float to_float(T x);

template <>
__device__ __forceinline__ float to_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back (the TPU kernels round p, ds and dl to the
// input dtype before their products)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// n (0..4) valid elements starting at p as fp32, zero-filled
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, int n) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) r.x = to_float(p[0]);
  if (n > 1) r.y = to_float(p[1]);
  if (n > 2) r.z = to_float(p[2]);
  if (n > 3) r.w = to_float(p[3]);
  return r;
}

// the first n (0..4) lanes of v, rounded to T
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v, int n) {
  if (n > 0) p[0] = from_float<T>(v.x);
  if (n > 1) p[1] = from_float<T>(v.y);
  if (n > 2) p[2] = from_float<T>(v.z);
  if (n > 3) p[3] = from_float<T>(v.w);
}

// lowbias32, the dropout hash of the TPU kernels (ops/_hash.py holds the
// plain version): K11 keeps a cell of the flattened (M, N) tensor when
// mix(mix((row * N + col) ^ seed)) >= threshold; attention (K1, K3, K4)
// when mix(mix((row * stride + col) ^ seed) ^ (b * Hq + h)) >= threshold,
// with stride the key length JAX pads to. All uint32, wrapping.
__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// the attention kernels' additive bias and hash dropout (K1, K3, K4), as
// the C entries receive them: bias is fp32 (B|1, Hq|1, Sq|1, Sk) with
// stride 0 along a size-1 dim (null for none); seed_ptr points at the
// int32 seed on the device (null without dropout), so drawing a seed
// never waits for the card
struct AttnArgs {
  const float* bias;
  long long sb, sh, sq;
  const int* seed_ptr;
  unsigned thresh;
  float keep_div;
  int stride;
};

// AttnArgs with the bias and the dropout switched at compile time, so a
// call with neither (the GPT paths) runs code built without them: a cell
// (row, col) of query head bh = b * Hq + h is kept when
// mix(mix((row * stride + col) ^ seed) ^ bh) >= thresh, and a kept value
// is divided by keep_div = 1 - p. A kernel calls load_seed() once before
// its first drop().
template <bool kBias, bool kDrop>
struct AttnExtra : AttnArgs {
  unsigned seed;

  __device__ __forceinline__ void load_seed() {
    if constexpr (kDrop) seed = static_cast<unsigned>(*seed_ptr);
  }
  // the cell's logit s * scale, plus its bias (with no bias the product
  // stays one term, so `logit - lse` still contracts to one FMA)
  __device__ __forceinline__ float logit(float s, float scale, int b, int h,
                                         int row, int col) const {
    if constexpr (kBias)
      return s * scale +
             bias[b * sb + h * sh + static_cast<long long>(row) * sq + col];
    else
      return s * scale;
  }
  __device__ __forceinline__ bool keep(unsigned bh, int row,
                                       int col) const {
    const unsigned lin = static_cast<unsigned>(row) *
                             static_cast<unsigned>(stride) +
                         static_cast<unsigned>(col);
    return mix(mix(lin ^ seed) ^ bh) >= thresh;
  }
  // x kept and scaled, or 0; x itself without dropout
  __device__ __forceinline__ float drop(float x, unsigned bh, int row,
                                        int col) const {
    if constexpr (kDrop)
      return keep(bh, row, col) ? x / keep_div : 0.f;
    else
      return x;
  }
  // drop() split in two, so one hash serves several values of a cell:
  // kept() is the cell's keep bit (true without dropout), scaled(x, k)
  // the kept value, x times 1 / keep_div (within an fp32 rounding of
  // drop()'s quotient: a division per cell cost the TMA + wgmma kernels
  // more than the rest of their dropout), or 0
  __device__ __forceinline__ bool kept(unsigned bh, int row, int col) const {
    if constexpr (kDrop)
      return keep(bh, row, col);
    else
      return true;
  }
  __device__ __forceinline__ float scaled(float x, bool k) const {
    if constexpr (kDrop)
      return k ? x * (1.f / keep_div) : 0.f;
    else
      return x;
  }
};

// f(AttnExtra<kBias, kDrop>) for the flags `a` sets (a bias pointer, a
// seed pointer): one instantiation of each kernel per combination
template <typename F>
int with_attn_extra(const AttnArgs& a, F&& f) {
  if (a.bias != nullptr) {
    if (a.seed_ptr != nullptr) return f(AttnExtra<true, true>{a, 0u});
    return f(AttnExtra<true, false>{a, 0u});
  }
  if (a.seed_ptr != nullptr) return f(AttnExtra<false, true>{a, 0u});
  return f(AttnExtra<false, false>{a, 0u});
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// acc += s * b
__device__ __forceinline__ void axpy4(float4& acc, float s, float4 b) {
  acc.x += s * b.x;
  acc.y += s * b.y;
  acc.z += s * b.z;
  acc.w += s * b.w;
}

}  // namespace pt

// error text for the codes the C entries return (cudaGetLastError())
extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

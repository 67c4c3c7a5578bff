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

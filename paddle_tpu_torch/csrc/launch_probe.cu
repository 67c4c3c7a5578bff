// K13 — the launch probe: a copy of one (8, 128) fp32 block, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/observability/devprof.py
// `_noop` (the pl.pallas_call at :291 inside `pallas_launch_tax_s`),
// which copies an (8, 128) fp32 block so that the host can time one
// kernel launch followed by a scalar readback. The kernel does the same
// copy: y = x over 1,024 floats.
//
// Design. One block of 256 threads; thread t copies float4 t, so the 4 KB
// are read once and written once with 16-byte accesses, neighbouring
// threads on neighbouring addresses. Nothing else: the probe's job is to
// cost what a launch costs.
//
// Bound on the H100: bytes, 8 KB / 3.35 TB/s, about 2.4 ns. Launch
// overhead (microseconds) dwarfs it by design: the launch is what
// `devprof.pallas_launch_tax_s` measures.
#include "common.cuh"

namespace {

constexpr int kElems = 8 * 128;
constexpr int kThreads = kElems / 4;

__global__ void __launch_bounds__(kThreads)
noop_copy_kernel(const float4* __restrict__ x, float4* __restrict__ y) {
  y[threadIdx.x] = x[threadIdx.x];
}

}  // namespace

extern "C" int pt_launch_probe_elems() { return kElems; }

// x, y: kElems contiguous fp32 on the device, 16-byte aligned (the
// wrapper checks both).
extern "C" int pt_noop_copy(const void* x, void* y, void* stream) {
  noop_copy_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y));
  return static_cast<int>(cudaGetLastError());
}

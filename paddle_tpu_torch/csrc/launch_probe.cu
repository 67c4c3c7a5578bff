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
// cost what a launch costs. (Blocks of 128 threads with two float4s each
// and 64 with four ran slower; PERF.md §6.)
//
// Bound on the H100: bytes, 8 KB / 3.35 TB/s, about 2.4 ns. Launch
// overhead (microseconds) dwarfs it by design: the launch is what
// `devprof.pallas_launch_tax_s` measures. The yardstick that a launch
// can reach is the card's launch floor: `launch_floor_kernel`, an empty
// kernel of one block of 32 threads that touches no memory, timed the
// same way (a probe-only entry, on no path of the port; PERF.md §6 sets
// K13 beside it).
#include "common.cuh"

namespace {

constexpr int kElems = 8 * 128;
constexpr int kThreads = kElems / 4;

__global__ void __launch_bounds__(kThreads)
noop_copy_kernel(const float4* __restrict__ x, float4* __restrict__ y) {
  y[threadIdx.x] = x[threadIdx.x];
}

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int pt_launch_probe_elems() { return kElems; }

// x, y: kElems contiguous fp32 on the device, 16-byte aligned (the
// wrapper checks both).
extern "C" int pt_noop_copy(const void* x, void* y, void* stream) {
  noop_copy_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(y));
  return static_cast<int>(cudaGetLastError());
}

// the empty kernel, one block of 32 threads: the card's launch floor
extern "C" int pt_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// the shared memory a block of device `dev` may opt in to, in bytes, or a
// negative CUDA error (ops/geometry.py reads it where PyTorch's device
// properties lack it)
extern "C" int pt_smem_optin(int dev) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

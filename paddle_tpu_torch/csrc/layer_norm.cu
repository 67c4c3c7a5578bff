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
// the TPU kernel's hash of the cell's global index row * N + j (uint32,
// wrapping) xor the seed read on the device (common.cuh pt::mix), so
// the kernel, its plain version and the JAX kernel drop the same cells.
// The mean and the centred variance are two passes over the row, as in
// the JAX kernel and the plain version (no Welford).
//
// Bound on the H100: bytes. The kernel reads x and residual and writes
// y and pre once (4 M N x element size), plus 8 M bytes of statistics
// and the three (N,) vectors: at the encoder's shape (M 8192, N 768,
// bf16) 50.4 MB, 0.0150 ms at 3.35 TB/s. Its operations are some 30 a
// cell, two thirds of them the dropout hash's integer ones (two
// lowbias32 mixes), which run at half the fp32 rate: about 9 us of the
// SMs' integer pipes at that shape. So the design keeps bytes in flight,
// touches each byte once, and lets the hash run while the loads fly.
//
// Design. The row lives in registers, as fp32 `pre`, for the whole row's
// work; nothing of it goes through shared memory.
//
// - Rows up to kWarpMaxN (1024): one warp per row. Lane l holds kElems
//   values (8, 16, 24 or 32: 24 at N 768, 32 at N 1024). x and residual
//   arrive by 16-byte loads (8 bf16 or 4 fp32 a lane a load; neighbouring
//   lanes on neighbouring addresses), all of a row's loads issued first;
//   then the lane's keep bits for the row (one word: the mask needs no
//   data), so the hash's integer work overlaps the loads; both sums are
//   warp shuffles; y and pre leave by 16-byte stores and lane 0 writes
//   mean and rstd. A block is 8 warps, at most 128 registers a thread
//   (a tighter bound spilled), two blocks an SM, each warp walking rows
//   with a grid stride (ops/layer_norm.py `_plan`): 16 warps an SM, each
//   with 3 KB of x + residual outstanding per row at N 768, about 48 KB
//   an SM, past the 20 KB that 3.35 TB/s needs at the memory's latency.
// - Wider rows, up to kMaxN (16384): one block per row, 32 values a
//   thread (blockDim.x = N / 32 rounded up to whole warps, at most 512),
//   the cross-warp sums through one shared slot per warp. Registers
//   hold every row the kernel takes, so no row is staged in shared
//   memory.
// - gamma, beta and bias come in their own dtype (bf16 or fp32, read as
//   the caller says) and are widened to fp32 as each block copies them,
//   once, into shared memory (no bias: zeros), for every row the block
//   handles: a call is one launch, with no cast beside it.
// - Dropout and the residual are template flags, so a row's work is
//   straight-line code: as run-time tests they left the row's loop full
//   of branch regions, and it ran slower.
// - N not a multiple of the access width, or x, residual, y or pre not
//   16-byte aligned: the same template with one-element accesses
//   (kVec = false), neighbouring lanes on neighbouring elements. The
//   wrapper chooses it.
//
// Why CUDA C++ and not Triton: the kernel shares common.cuh's hash with
// K1, K3 and K4, and builds in the port's one nvcc build. 1D bulk copies
// (cp.async.bulk into an mbarrier, as csrc/decode_attn.cuh does) could
// replace the register loads. They are not used: the loads are not what
// holds the kernel back (PERF.md §6 times it without dropout and without
// the residual beside copies of the same bytes).
#include "common.cuh"

namespace {

constexpr int kMaxN = 16384;
constexpr int kWarpMaxN = 1024;       // rows up to this: a warp per row
constexpr int kWarpThreads = 256;     // the warp variant's block
constexpr int kBlockThreads = 512;    // the block variant's largest block

struct Args {
  const void* x;
  const void* gamma;
  const void* beta;
  const void* bias;       // or null
  const void* residual;   // or null
  void* y;
  void* pre;
  float* mean;
  float* rstd;
  int M;
  int N;
  float eps;
  const int* seed;        // the int32 seed on the device, or null
  unsigned thresh;
  float keep_div;
  bool vec_bf16;          // gamma, beta, bias bf16 (else fp32)
};

// kW values of T at one access: one 16-, 8-, 4- or 2-byte load or store
// when aligned to its size
template <typename T, int kW>
struct alignas(sizeof(T) * kW) Pack {
  T v[kW];
};

// bytes of one vector staged in shared memory (fp32); each of the three
// starts on a 64-byte boundary
__host__ __device__ constexpr int staged_bytes(int n) {
  return (n * 4 + 63) / 64 * 64;
}

template <bool kBlockRow>
constexpr int smem_bytes(int n) {
  return 3 * staged_bytes(n) + (kBlockRow ? 2 * (kBlockThreads / 32) * 4 : 0);
}

// element j of a parameter vector, widened to fp32
__device__ __forceinline__ float vec_at(const void* p, int j, bool bf16) {
  return bf16 ? pt::to_float(static_cast<const __nv_bfloat16*>(p)[j])
              : static_cast<const float*>(p)[j];
}

// u / d rounded to nearest, as the plain version's division, without a
// division per cell: q = u * r with r = 1 / d rounded, then one step on
// the exact residual u - q d (an FMA). For u and d normal the result is
// the correctly rounded quotient (Markstein's theorem), so the kernel
// keeps the plain version's bits; the division's branch to its slow
// path, which cost more than the rest of a cell's work, is gone.
__device__ __forceinline__ float div_by(float u, float d, float r) {
  const float q = __fmul_rn(u, r);
  return fmaf(fmaf(-q, d, u), r, q);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's total of each warp's sum `w`, through one slot per warp;
// a row's two sums use the two halves of `red` in turn, so one barrier
// a sum keeps every slot read before it is written again
__device__ __forceinline__ float block_total(float w, float* red) {
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = w;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) t += red[i];
  return t;
}

// kElems values a thread (a multiple of 8); kVec: 16-byte accesses,
// else one element each; kBlockRow: a block per row, else a warp;
// kDrop, kRes: dropout, a residual (compiled in or out, so a row's work
// is straight-line code)
template <typename T, int kElems, bool kVec, bool kBlockRow, bool kDrop,
          bool kRes>
__global__ void __launch_bounds__(kBlockRow ? kBlockThreads : kWarpThreads,
                                  kBlockRow ? 1 : 2)
fused_ln_fwd(Args a) {
  constexpr int kW = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int kIters = kElems / kW;
  static_assert(kElems % kW == 0, "a thread's values are whole accesses");
  static_assert(kElems <= 32, "a thread's keep bits fit one word");
  extern __shared__ __align__(64) unsigned char smem[];
  const int N = a.N;
  const int vb = staged_bytes(N);
  float* sg = reinterpret_cast<float*>(smem);
  float* sb = reinterpret_cast<float*>(smem + vb);
  float* sbias = reinterpret_cast<float*>(smem + 2 * vb);
  float* red = reinterpret_cast<float*>(smem + 3 * vb);
  // the vectors, widened once per block (no bias: zeros)
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    sg[j] = vec_at(a.gamma, j, a.vec_bf16);
    sb[j] = vec_at(a.beta, j, a.vec_bf16);
    sbias[j] = a.bias != nullptr ? vec_at(a.bias, j, a.vec_bf16) : 0.f;
  }
  __syncthreads();

  const int group = kBlockRow ? static_cast<int>(blockDim.x) : 32;
  const int t = kBlockRow ? static_cast<int>(threadIdx.x)
                          : static_cast<int>(threadIdx.x & 31);
  const int rows = kBlockRow ? 1 : static_cast<int>(blockDim.x >> 5);
  const int first = kBlockRow ? 0 : static_cast<int>(threadIdx.x >> 5);
  const unsigned seed = kDrop ? static_cast<unsigned>(*a.seed) : 0u;
  const float keep_inv = 1.f / a.keep_div;
  const T* x = static_cast<const T*>(a.x);
  const T* res = static_cast<const T*>(a.residual);
  T* y = static_cast<T*>(a.y);
  T* pre = static_cast<T*>(a.pre);
  using PT = Pack<T, kW>;
  using PF = Pack<float, kW>;

  for (long long row = static_cast<long long>(blockIdx.x) * rows + first;
       row < a.M; row += static_cast<long long>(gridDim.x) * rows) {
    const long long base = row * N;
    // every load of the row first
    PT px[kIters], pr[kIters];
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int c = (i * group + t) * kW;
      if (c < N) {
        px[i] = *reinterpret_cast<const PT*>(x + base + c);
        if constexpr (kRes) pr[i] = *reinterpret_cast<const PT*>(res + base + c);
      }
    }
    // then the row's keep bits, which need no data: the hash's integer
    // work runs while the loads are in flight
    unsigned keep = 0u;
    if constexpr (kDrop) {
#pragma unroll
      for (int i = 0; i < kIters; ++i) {
        const unsigned lin =
            static_cast<unsigned>(row) * static_cast<unsigned>(N) +
            static_cast<unsigned>((i * group + t) * kW);
#pragma unroll
        for (int e = 0; e < kW; ++e)
          keep |= static_cast<unsigned>(
                      pt::mix(pt::mix((lin + e) ^ seed)) >= a.thresh)
                  << (i * kW + e);
      }
    }
    float v[kElems];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int c = (i * group + t) * kW;
      const bool in = c < N;
      const PF pb = *reinterpret_cast<const PF*>(sbias + (in ? c : 0));
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        float u = pt::to_float(px[i].v[e]) + pb.v[e];
        if constexpr (kDrop)
          u = (keep >> (i * kW + e)) & 1u ? div_by(u, a.keep_div, keep_inv)
                                          : 0.f;
        if constexpr (kRes) u += pt::to_float(pr[i].v[e]);
        v[i * kW + e] = in ? u : 0.f;
        s += v[i * kW + e];
      }
    }
    s = warp_sum(s);
    if constexpr (kBlockRow) s = block_total(s, red);
    const float mean = s / N;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const bool in = (i * group + t) * kW < N;
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        const float d = in ? v[i * kW + e] - mean : 0.f;
        q = fmaf(d, d, q);
      }
    }
    q = warp_sum(q);
    if constexpr (kBlockRow) q = block_total(q, red + kBlockThreads / 32);
    const float rstd = rsqrtf(q / N + a.eps);
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int c = (i * group + t) * kW;
      if (c < N) {
        const PF pg = *reinterpret_cast<const PF*>(sg + c);
        const PF pbt = *reinterpret_cast<const PF*>(sb + c);
        PT oy, op;
#pragma unroll
        for (int e = 0; e < kW; ++e) {
          const float u = v[i * kW + e];
          oy.v[e] = pt::from_float<T>((u - mean) * rstd * pg.v[e] + pbt.v[e]);
          op.v[e] = pt::from_float<T>(u);
        }
        *reinterpret_cast<PT*>(y + base + c) = oy;
        *reinterpret_cast<PT*>(pre + base + c) = op;
      }
    }
    if (t == 0) {
      a.mean[row] = mean;
      a.rstd[row] = rstd;
    }
  }
}

template <typename T, int kElems, bool kVec, bool kBlockRow, bool kDrop,
          bool kRes>
int launch(const Args& a, int threads, int grid, cudaStream_t st) {
  auto kernel = fused_ln_fwd<T, kElems, kVec, kBlockRow, kDrop, kRes>;
  const int smem = smem_bytes<kBlockRow>(a.N);
  if (smem > 48 * 1024) {
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (rc != 0) return rc;
  }
  kernel<<<grid, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec, bool kDrop, bool kRes>
int by_shape(const Args& a, int block_row, int elems, int threads, int grid,
             cudaStream_t st) {
  if (block_row)
    return elems == 32
               ? launch<T, 32, kVec, true, kDrop, kRes>(a, threads, grid, st)
               : static_cast<int>(cudaErrorInvalidValue);
  switch (elems) {
    case 8: return launch<T, 8, kVec, false, kDrop, kRes>(a, threads, grid, st);
    case 16: return launch<T, 16, kVec, false, kDrop, kRes>(a, threads, grid, st);
    case 24: return launch<T, 24, kVec, false, kDrop, kRes>(a, threads, grid, st);
    case 32: return launch<T, 32, kVec, false, kDrop, kRes>(a, threads, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool kVec>
int by_flags(const Args& a, int block_row, int elems, int threads, int grid,
             cudaStream_t st) {
  if (a.seed != nullptr) {
    if (a.residual != nullptr)
      return by_shape<T, kVec, true, true>(a, block_row, elems, threads, grid, st);
    return by_shape<T, kVec, true, false>(a, block_row, elems, threads, grid, st);
  }
  if (a.residual != nullptr)
    return by_shape<T, kVec, false, true>(a, block_row, elems, threads, grid, st);
  return by_shape<T, kVec, false, false>(a, block_row, elems, threads, grid, st);
}

template <typename T>
int by_vec(const Args& a, int vec, int block_row, int elems, int threads,
           int grid, cudaStream_t st) {
  constexpr int kW = 16 / static_cast<int>(sizeof(T));
  if (vec == kW && a.N % kW == 0)
    return by_flags<T, true>(a, block_row, elems, threads, grid, st);
  if (vec == 1) return by_flags<T, false>(a, block_row, elems, threads, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int pt_fused_layer_norm_max_n() { return kMaxN; }

// x, residual (or null), y, pre (M, N) contiguous, of one dtype `dtype`;
// gamma, beta, bias (or null) (N,) contiguous, of one dtype `vdtype`;
// mean, rstd (M,) fp32. A non-null `seed` (the int32 seed on the device,
// read there so that drawing it never waits for the card) applies the
// hash mask with `thresh` and divides kept cells by `keep_div` (1 - p,
// rounded to fp32 by the caller). The launch's shape is the caller's
// plan (ops/layer_norm.py `_plan`): `block_row` 0 (a warp per row,
// N <= 1024, `threads` a multiple of 32 up to 256) or 1 (a block of
// `threads` per row, up to 512), `vec` the elements of one access (16
// bytes' worth, when N is a multiple of it and x, residual, y and pre
// are 16-byte aligned, which the caller guarantees; else 1), `elems`
// values a thread, `grid` blocks. The caller guarantees M > 0.
extern "C" int pt_fused_layer_norm_fwd(
    int dtype, int vdtype, const void* x, const void* gamma,
    const void* beta, const void* bias, const void* residual, void* y,
    void* pre, void* mean, void* rstd, int M, int N, float eps,
    const void* seed, unsigned thresh, float keep_div, int block_row,
    int vec, int elems, int threads, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_row = block_row ? threads : 32;
  const int max_threads = block_row ? kBlockThreads : kWarpThreads;
  if (N <= 0 || N > kMaxN || M <= 0 || grid <= 0 || threads <= 0 ||
      threads % 32 != 0 || threads > max_threads ||
      (!block_row && N > kWarpMaxN) ||
      static_cast<long long>(per_row) * elems < N ||
      (vdtype != pt::kBFloat16 && vdtype != pt::kFloat32))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, gamma, beta, bias, residual, y, pre,
               static_cast<float*>(mean), static_cast<float*>(rstd), M, N,
               eps, static_cast<const int*>(seed), thresh, keep_div,
               vdtype == pt::kBFloat16};
  if (dtype == pt::kBFloat16)
    return by_vec<__nv_bfloat16>(a, vec, block_row, elems, threads, grid, st);
  if (dtype == pt::kFloat32)
    return by_vec<float>(a, vec, block_row, elems, threads, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

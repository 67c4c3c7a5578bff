// K5 — the fused softmax cross-entropy's forward over a projection, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// paddle_tpu/ops/pallas/fused_ce.py (:47, launched at :153). For rows x
// (N, d), weights w (V, d) in embedding layout and int32 labels (negative
// = ignored), with logits s = x . w^T:
//
//   lse = logsumexp_v s,  loss = lse - s[label]  (0 for ignored rows)
//
// The backward (K6 dx, K7 dw) is fused_ce_bwd.cu. The (N, V) logits never
// reach device memory: each logit tile is computed from x and w (the
// counterpart of `_logits_block`, :40-44) and folded into an online
// logsumexp while it is still in registers.
//
// Design. Hopper blocks run in no order, so the TPU's sequential
// ("arbitrary") vocab axis becomes a loop inside a block over a range of
// `per` consecutive vocab tiles; each block writes its rows' running max,
// sum and label logit for its range into the scratch `part` (nsplit, 3,
// N), and a small second kernel in the same launch merges the ranges into
// lse and loss. ops/fused_ce.py plans the ranges (`_ranges`) so that the
// grid of row tiles x ranges fills whole waves of the SMs.
//  - bf16 (the train path): `ce_fwd_sm90`, the mainloop of the CE
//    backward's dl pass (ce_gemm.cuh) with a log-sum-exp epilogue. A
//    block of three warpgroups owns 128 rows; one producer thread streams
//    64-deep stages of x and w by TMA (128-byte swizzle, a ring of four)
//    across all the tiles of its range without a break, and two consumer
//    warpgroups each run wgmma m64n256k16 on 64 rows into 128 fp32
//    registers a thread. The epilogue runs on those registers: per row, a
//    thread's max over its 64 columns, two quad shuffles for the tile's
//    max, then its own part of the running sum (exp2 of one FMA a cell)
//    and, on the one tile that holds it, the label's logit; the quad sums
//    them once, after the range. While it runs, the producer is already
//    loading the next tile's first stages. Columns at or past V are
//    zero-filled w rows (logit 0): the last tile leaves them out of the
//    max and the sum; rows past N are zero-filled x rows and write
//    nothing.
//  - fp32: the FP32 pipes, one block of 256 threads per 64-row tile and
//    range of 128-column tiles, each thread accumulating a 4 x 8 piece
//    from 16-deep fp32 stages (three 16-byte shared loads per 32 FMAs).
//
// Bound on the H100. At the train shape (N 8188, d 2048, V 50304, bf16)
// the product is 0.84 T multiply-adds, 1.7 TFLOP, against about 0.3 GB of
// inputs: far above the ridge, so the bound is the tensor cores' 989
// TFLOP/s (1.71 ms). The epilogue's 128 exponentials per thread and tile
// do not overlap that tile's products (one accumulator set per
// warpgroup). The fp32 path is bound by the FP32 pipes (67 TFLOP/s).
#include "ce_gemm.cuh"
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

// ---- fp32: the FP32 pipes ---------------------------------------------------

constexpr int kBM = 64;                    // rows of x per tile
constexpr int kBN = 128;                   // vocab columns per tile
constexpr int kBK = 16;                    // stage depth
constexpr int kThreads = 256;              // 16 x 16, 4 x 8 outputs each

// Shared memory (dynamic), in bytes: the two stages, plus the room the
// fp32 tile had while this file also held K6 and K7 (their dl tile), so
// the fp32 path keeps the occupancy it was measured at.
constexpr int kF32Stage = (kBK * kBM + kBK * kBN) * 4;
constexpr int kF32Total = kF32Stage + kBN * kBM * 4;

// thread (ty, tx) = (tid / 16, tid % 16) owns tile rows 4 ty + i (i < 4)
// and columns col_of(tx, j) (j < 8): two runs of four, 64 apart
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
}

// 4 and 8 contiguous fp32 elements (16-byte aligned reads)
__device__ __forceinline__ void ld4(const float* p, float (&r)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
__device__ __forceinline__ void ld8(const float* p, float (&r)[8]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  const float4 w = *reinterpret_cast<const float4*>(p + 4);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  r[4] = w.x; r[5] = w.y; r[6] = w.z; r[7] = w.w;
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k a[k][4 ty + i] * b[k][col_of(tx, j)] over one stage;
// a has row stride kBM, b row stride kBN (both 16-byte aligned)
__device__ __forceinline__ void mma_stage(const float* a, const float* b,
                                          float (&acc)[4][8]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * kBM + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * kBN + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(b + k * kBN + 64 + tx * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += ar[i] * br[j];
  }
}

// acc = x[row0 .. +64) . w[col0 .. +128)^T in fp32, in the 4 x 8 thread
// layout; rows past N and columns past V read as 0
__device__ __forceinline__ void logits_tile(
    unsigned char* smem, const float* __restrict__ x,
    const float* __restrict__ w, int row0, int col0, int N, int V, int d,
    float (&acc)[4][8]) {
  float* sa = reinterpret_cast<float*>(smem);  // [kBK][kBM]
  float* sb = sa + kBK * kBM;                  // [kBK][kBN]
  const int tid = threadIdx.x;
  // four threads per x row (4 elements each), two per w row (8 each):
  // a warp reads 8 rows x 16 contiguous bytes of x, 16 rows of w
  const int ar = tid / 4, ak = (tid % 4) * 4;
  const int bc = tid / 2, bk = (tid % 2) * 8;
  const bool a_ok = row0 + ar < N;
  const bool b_ok = col0 + bc < V;
  const float* xa = x + (long)(row0 + ar) * d;
  const float* wb = w + (long)(col0 + bc) * d;
  zero_acc(acc);
  for (int k0 = 0; k0 < d; k0 += kBK) {
    float ra[4], rb[8];
    if (a_ok && k0 + ak < d) ld4(xa + k0 + ak, ra); else zero(ra);
    if (b_ok && k0 + bk < d) ld8(wb + k0 + bk, rb); else zero(rb);
    __syncthreads();                       // previous stage consumed
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[(ak + e) * kBM + ar] = ra[e];
#pragma unroll
    for (int e = 0; e < 8; ++e) sb[(bk + e) * kBN + bc] = rb[e];
    __syncthreads();
    mma_stage(sa, sb, acc);
  }
}

__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const int* __restrict__ labels, float* __restrict__ part,
              int N, int V, int d, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * kBM;
  const int nvt = (V + kBN - 1) / kBN;
  const int t0 = blockIdx.y * per;
  const int t1 = min(nvt, t0 + per);

  int lab[4];
  float m[4], l[4], pick[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    lab[i] = r < N ? labels[r] : -1;
    m[i] = -INFINITY;
    l[i] = 0.f;
    pick[i] = 0.f;
  }
  float acc[4][8];
  for (int t = t0; t < t1; ++t) {
    const int col0 = t * kBN;
    logits_tile(smem, x, w, row0, col0, N, V, d, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + col_of(tx, j);
        if (col < V) tmax = fmaxf(tmax, acc[i][j]);
        if (col == lab[i]) pick[i] += acc[i][j];
      }
      if (tmax == -INFINITY) continue;     // all eight columns past V
      const float m_new = fmaxf(m[i], tmax);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (col0 + col_of(tx, j) < V) s += __expf(acc[i][j] - m_new);
      l[i] = l[i] * __expf(m[i] - m_new) + s;
      m[i] = m_new;
    }
  }
  // merge the 16 threads of a row (lanes that differ in bits 0..3)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      pick[i] += __shfl_xor_sync(0xffffffffu, pick[i], off);
      const float mn = fmaxf(m[i], mo);
      l[i] = (m[i] == -INFINITY ? 0.f : l[i] * __expf(m[i] - mn)) +
             (mo == -INFINITY ? 0.f : lo * __expf(mo - mn));
      m[i] = mn;
    }
    const int r = row0 + ty * 4 + i;
    if (tx == 0 && r < N) {
      float* p = part + (long)blockIdx.y * 3 * N;
      p[r] = m[i];
      p[N + r] = l[i];
      p[2 * N + r] = pick[i];
    }
  }
}

// ---- bf16: TMA + wgmma (ce_gemm.cuh's mainloop) -----------------------------

constexpr float kLog2e = 1.4426950408889634f;

// 2^x (the MUFU's approximation, as __expf uses; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// one 128 x 256 logit tile folded into the running max m, this thread's
// part of the running sum l, and its part of the label logit pick, for
// the thread's two rows (acc[4 j + 2 r + e] is row r's column c0 + 8 j +
// e). m is the row's, shared by the quad (lanes t ^ 1, t ^ 2) that holds
// its 256 columns. kMasked: the tile reaches past V, whose columns (logit
// 0 from TMA's zero fill) stay out of the max and the sum.
template <bool kMasked>
__device__ __forceinline__ void lse_tile(const float (&acc)[ce::kBN / 2],
                                         float (&m)[2], float (&l)[2],
                                         float (&pick)[2],
                                         const int (&lab)[2], int c0,
                                         int V) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < ce::kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!kMasked || c0 + 8 * j + e < V)
          mx = fmaxf(mx, acc[4 * j + 2 * r + e]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // finite: the tile's first column, < V, is in every row's quad
    const float m_new = fmaxf(m[r], mx);
    const float mb = m_new * kLog2e;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < ce::kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!kMasked || c0 + 8 * j + e < V)
          s += exp2_approx(fmaf(acc[4 * j + 2 * r + e], kLog2e, -mb));
    // the first tile: m = -inf, so the old sum (0) scales by 0
    l[r] = l[r] * exp2_approx((m[r] - m_new) * kLog2e) + s;
    m[r] = m_new;
    const int rel = lab[r] - c0;
    if (rel >= 0 && rel < ce::kBN) {
#pragma unroll
      for (int j = 0; j < ce::kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e == rel) pick[r] += acc[4 * j + 2 * r + e];
    }
  }
}

// K5 on the tensor cores: rows blockIdx.x * 128 .., the vocab tiles
// [blockIdx.y * per, + per) (fewer in the last range), 256 columns each
__global__ void __launch_bounds__(ce::kWgThreads, 1)
ce_fwd_sm90(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tw,
            const int* __restrict__ labels, float* __restrict__ part, int N,
            int V, int d, int per) {
  extern __shared__ unsigned char smem_raw[];
  const ce::Ring ring = ce::Ring::at(smem_raw);
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * ce::kBM;
  const int nvt = (V + ce::kBN - 1) / ce::kBN;
  const int t0 = blockIdx.y * per;
  const int nt = min(nvt, t0 + per) - t0;
  const int nk = (d + ce::kBK - 1) / ce::kBK;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (wg == 0) {
    // producer: one thread streams the range's stages without a break
    regs_dec<40>();
    if (threadIdx.x == 0)
      ce::produce<false, false>(ring, &tx, &tw, m0, t0 * ce::kBN, nt, nk);
  } else {
    regs_inc<232>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int r0 = m0 + cw * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int c = 2 * (t % 4);
    int lab[2];
    float m[2], l[2], pick[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      lab[r] = row < N ? labels[row] : -1;
      m[r] = -INFINITY;
      l[r] = 0.f;
      pick[r] = 0.f;
    }
    float acc[ce::kBN / 2];
    int it = 0;
    for (int i = 0; i < nt; ++i) {
#pragma unroll
      for (int j = 0; j < ce::kBN / 2; ++j) acc[j] = 0.f;
      ce::consume<false, false>(ring, acc, cw, t, nk, it);
      const int col0 = (t0 + i) * ce::kBN;
      if (col0 + ce::kBN <= V)
        lse_tile<false>(acc, m, l, pick, lab, col0 + c, V);
      else
        lse_tile<true>(acc, m, l, pick, lab, col0 + c, V);
    }
    // the quad's parts of each row's sum and label logit
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      pick[r] += __shfl_xor_sync(0xffffffffu, pick[r], 1);
      pick[r] += __shfl_xor_sync(0xffffffffu, pick[r], 2);
      const int row = r0 + 8 * r;
      if (c == 0 && row < N) {
        float* p = part + static_cast<long>(blockIdx.y) * 3 * N;
        p[row] = m[r];
        p[N + row] = l[r];
        p[2 * N + row] = pick[r];
      }
    }
  }
}

// ---- the merge --------------------------------------------------------------

__global__ void ce_fwd_merge(const float* __restrict__ part,
                             const int* __restrict__ labels,
                             float* __restrict__ loss,
                             float* __restrict__ lse, int N, int nsplit) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part[(long)s * 3 * N + r]);
  float l = 0.f, pick = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float* p = part + (long)s * 3 * N;
    if (p[r] != -INFINITY) l += p[N + r] * expf(p[r] - m);
    pick += p[2 * N + r];
  }
  const float lz = m + logf(l);
  lse[r] = lz;
  loss[r] = labels[r] >= 0 ? lz - pick : 0.f;
}

int merge(const float* part, const int* labels, float* loss, float* lse,
          int N, int nsplit, cudaStream_t st) {
  ce_fwd_merge<<<(N + 255) / 256, 256, 0, st>>>(part, labels, loss, lse, N,
                                               nsplit);
  return static_cast<int>(cudaGetLastError());
}

int fwd_f32(const float* x, const float* w, const int* labels, float* part,
            float* loss, float* lse, int N, int V, int d, int nsplit,
            int per, cudaStream_t st) {
  static_assert(kF32Total <= 48 * 1024, "no opt-in above 48 KB needed");
  const dim3 grid((N + kBM - 1) / kBM, nsplit);
  ce_fwd_kernel<<<grid, kThreads, kF32Total, st>>>(x, w, labels, part, N, V,
                                                   d, per);
  const int rc = static_cast<int>(cudaGetLastError());
  return rc != 0 ? rc : merge(part, labels, loss, lse, N, nsplit, st);
}

int fwd_sm90(const void* x, const void* w, const int* labels, float* part,
             float* loss, float* lse, int N, int V, int d, int nsplit,
             int per, cudaStream_t st) {
  CUtensorMap tx, tw;
  int rc = ce::operand_map<false, ce::kBM>(&tx, x, d, N, d);
  if (rc == 0) rc = ce::operand_map<false, ce::kBN>(&tw, w, d, V, d);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      ce_fwd_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ce::kWgSmem));
  if (rc != 0) return rc;
  const dim3 grid((N + ce::kBM - 1) / ce::kBM, nsplit);
  ce_fwd_sm90<<<grid, ce::kWgThreads, ce::kWgSmem, st>>>(tx, tw, labels,
                                                         part, N, V, d, per);
  rc = static_cast<int>(cudaGetLastError());
  return rc != 0 ? rc : merge(part, labels, loss, lse, N, nsplit, st);
}

}  // namespace

// x (N, d) and w (V, d) contiguous, 16-byte aligned, of one dtype, with
// d % 8 == 0; labels (N,) int32; loss, lse (N,) fp32. The vocabulary tiles
// (256 columns in bf16, 128 in fp32) are cut into `nsplit` ranges of `per`
// tiles, none empty, for row tiles of 128 (bf16) or 64 (fp32) rows;
// `part` (nsplit, 3, N) fp32 is the scratch of the ranges.
extern "C" int pt_fused_ce_fwd(int dtype, const void* x, const void* w,
                               const void* labels, void* part, void* loss,
                               void* lse, int N, int V, int d, int nsplit,
                               int per, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* p = static_cast<float*>(part);
  float* lo = static_cast<float*>(loss);
  float* lz = static_cast<float*>(lse);
  if (dtype == pt::kBFloat16)
    return fwd_sm90(x, w, lab, p, lo, lz, N, V, d, nsplit, per, st);
  if (dtype == pt::kFloat32)
    return fwd_f32(static_cast<const float*>(x), static_cast<const float*>(w),
                   lab, p, lo, lz, N, V, d, nsplit, per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

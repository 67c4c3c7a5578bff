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
// reach device memory: the kernel computes each 64 x 128 logit tile from x
// and w (`logits_tile`, the counterpart of `_logits_block`, :40-44) and
// folds it into an online logsumexp.
//
// Design. One block of 256 threads owns a 64-row tile and a range of vocab
// tiles, walking the TPU's sequential ("arbitrary") grid axis as a loop.
// The 64 x 128 logit tile ends in fp32 registers, 4 x 8 per thread, where
// the online logsumexp runs. How it gets there depends on the dtype:
//  - bf16 (the train path): tensor cores. Eight warps each own a 32 x 32
//    piece as 2 x 2 wmma 16x16x16 fragments (bf16 in, fp32 accumulate,
//    the MXU's arithmetic); x and w pass through shared memory in
//    32-deep stages read with 16-byte loads, and the finished tile is
//    staged through shared memory into the epilogue's thread layout.
//  - fp32: the FP32 pipes, each thread accumulating its 4 x 8 piece from
//    16-deep fp32 stages (three 16-byte shared loads per 32 FMAs).
// Each block keeps each row's running max, sum and label logit over its
// columns and writes them for its range; a small second kernel in the same
// launch merges the ranges into lse and loss. Splitting the vocabulary
// gives enough blocks for the 132 SMs at N = 8188.
//
// Bound on the H100. At the train shape (N 8188, d 2048, V 50304, bf16)
// the product is 0.84 T multiply-adds, 1.7 TFLOP, against about 0.3 GB of
// inputs: far above the ridge, so the bound is the tensor cores' 989
// TFLOP/s (1.71 ms). The wmma path (no TMA, no wgmma, two barriers per
// 32-deep stage) reaches a fraction of that; fused_ce_bwd.cu's TMA and
// wgmma mainloop with an online-logsumexp epilogue is the next step
// (ROADMAP R1). The fp32 path is bound by the FP32 pipes (67 TFLOP/s).
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBM = 64;                    // rows of x per tile
constexpr int kBN = 128;                   // vocab columns per tile
constexpr int kBK = 16;                    // fp32 path: stage depth
constexpr int kTK = 32;                    // bf16 path: stage depth
constexpr int kPad = 8;                    // bf16 row padding (16 bytes)
constexpr int kCS = kBN + 4;               // fp32 row stride, staged tile
constexpr int kThreads = 256;              // 16 x 16, 4 x 8 outputs each

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Shared memory (dynamic), in bytes. fp32: the two stages. bf16: one
// region reused for the logit stages and the staged fp32 tile. Each keeps
// the size it had while this file also held K6 and K7 (their dl tile and
// second operand), so K5 runs at the occupancy it was measured at.
constexpr int kF32Stage = (kBK * kBM + kBK * kBN) * 4;
constexpr int kF32Total = kF32Stage + kBN * kBM * 4;
constexpr int kTcRegion =
    cmax(cmax((kBM + kBN) * (kTK + kPad) * 2, kBM * kCS * 4),
         cmax(kBN * (kBN + kPad) * 2, kBM * (kBM + kPad) * 2));
constexpr int kTcTotal = kTcRegion + kBM * (kBN + kPad) * 2;

template <typename T>
constexpr int smem_total() {
  return std::is_same<T, float>::value ? kF32Total : kTcTotal;
}

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
// layout; rows past N and columns past V read as 0. fp32: FP32 pipes.
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

__device__ __forceinline__ uint4 ld16(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}

// the same for bf16, on the tensor cores: warp (wm, wn) = (warp / 4,
// warp % 4) owns rows 32 wm .. +32 and columns 32 wn .. +32
__device__ __forceinline__ void logits_tile(
    unsigned char* smem, const bf16* __restrict__ x,
    const bf16* __restrict__ w, int row0, int col0, int N, int V, int d,
    float (&acc)[4][8]) {
  constexpr int ld = kTK + kPad;
  bf16* xs = reinterpret_cast<bf16*>(smem);    // [kBM][ld]
  bf16* ws = xs + kBM * ld;                    // [kBN][ld]
  float* cs = reinterpret_cast<float*>(smem);  // [kBM][kCS], after
  const int tid = threadIdx.x;
  const int wm = tid / 32 / 4, wn = tid / 32 % 4;
  // 16-byte chunks: x 64 rows x 4, w 128 rows x 4 (two per thread)
  const int xr = tid / 4, xc = (tid % 4) * 8;
  const bool x_ok = row0 + xr < N;
  const bf16* xg = x + (long)(row0 + xr) * d + xc;
  const int wr0 = tid / 4, wr1 = wr0 + 64;
  const bool w_ok0 = col0 + wr0 < V, w_ok1 = col0 + wr1 < V;
  const bf16* wg0 = w + (long)(col0 + wr0) * d + xc;
  const bf16* wg1 = w + (long)(col0 + wr1) * d + xc;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.f);
  for (int k0 = 0; k0 < d; k0 += kTK) {
    const bool k_ok = k0 + xc < d;
    const uint4 rx = ld16(xg + k0, x_ok && k_ok);
    const uint4 rw0 = ld16(wg0 + k0, w_ok0 && k_ok);
    const uint4 rw1 = ld16(wg1 + k0, w_ok1 && k_ok);
    __syncthreads();                       // previous stage consumed
    *reinterpret_cast<uint4*>(xs + xr * ld + xc) = rx;
    *reinterpret_cast<uint4*>(ws + wr0 * ld + xc) = rw0;
    *reinterpret_cast<uint4*>(ws + wr1 * ld + xc) = rw1;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
          b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * 32 + i * 16) * ld + kk, ld);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ws + (wn * 32 + j * 16) * ld + kk, ld);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }
  __syncthreads();                         // cs overwrites the stages
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kCS + wn * 32 + j * 16,
                              c[i][j], kCS, wmma::mem_row_major);
  __syncthreads();
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* row = cs + (ty * 4 + i) * kCS + tx * 4;
    const float4 lo = *reinterpret_cast<const float4*>(row);
    const float4 hi = *reinterpret_cast<const float4*>(row + 64);
    acc[i][0] = lo.x; acc[i][1] = lo.y; acc[i][2] = lo.z; acc[i][3] = lo.w;
    acc[i][4] = hi.x; acc[i][5] = hi.y; acc[i][6] = hi.z; acc[i][7] = hi.w;
  }
}

// ---- K5 -------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
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

// dynamic shared memory above the 48 KB default needs an opt-in
template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T>
int fwd_launch(const void* x, const void* w, const int* labels, float* part,
               float* loss, float* lse, int N, int V, int d, int nsplit,
               int per, cudaStream_t st) {
  const dim3 grid((N + kBM - 1) / kBM, nsplit);
  const int bytes = smem_total<T>();
  int rc = allow_smem(ce_fwd_kernel<T>, bytes);
  if (rc != 0) return rc;
  ce_fwd_kernel<T><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), labels, part, N,
      V, d, per);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  ce_fwd_merge<<<(N + 255) / 256, 256, 0, st>>>(part, labels, loss, lse, N,
                                               nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, d) and w (V, d) contiguous, 16-byte aligned, of one dtype, with
// d % 8 == 0; labels (N,) int32; loss, lse (N,) fp32. The vocabulary tiles
// are cut into `nsplit` ranges of `per` tiles, none empty; `part` (nsplit,
// 3, N) fp32 is the scratch of the ranges.
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
    return fwd_launch<bf16>(x, w, lab, p, lo, lz, N, V, d, nsplit, per, st);
  if (dtype == pt::kFloat32)
    return fwd_launch<float>(x, w, lab, p, lo, lz, N, V, d, nsplit, per, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
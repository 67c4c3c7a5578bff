// K12 — weight-only int8 matmul, out = (x @ q) * scale, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/quant_matmul.py
// `_kernel` (launched by `int8_matmul`, the pl.pallas_call at :91): x
// (M, K) in bf16 or fp32, q (K, N) int8 row-major, scale (N,) fp32, out
// (M, N) in x's dtype. As on the TPU (:35-52), the int8 weight is widened
// to x's dtype (exact: |q| <= 127), the products accumulate in fp32, the
// per-column scale multiplies the finished fp32 sum once, and the result
// is rounded to x's dtype once. Ragged M, K and N are handled by bounds
// on every load and store; nothing is padded or copied.
//
// Two regimes in one entry:
//
// - Decode rows (M <= 16, and fp32 at any M): `rows_kernel`. The product
//   is a weight stream. A block owns a strip of 32 output columns and
//   up to 16 rows of x; it walks K in chunks of 256 weight rows, each
//   staged through shared memory with 16-byte loads along N (two per
//   weight row: one 32-byte sector), the next chunk's loads issued
//   before the current chunk's arithmetic. Its 8 warps split the chunk's
//   rows (split-K inside the block): each thread owns one column and all
//   rows of x, widening each int8 weight to fp32 in registers, and the
//   8 partial sums reduce through shared memory. Where 32-column strips
//   give too few blocks for 132 SMs (N = 2048), the K range also splits
//   over blocks (grid y); the partial sums then go to an fp32 workspace
//   and `finalize_kernel` adds them, scales and rounds. The split is
//   worked out here (`rows_geometry`) from the card's SM count; the
//   caller asks `pt_int8_matmul_workspace` for the workspace's size.
// - Prefill rows (bf16, M > 16): `tiles_kernel`. A block owns a 64 x 128
//   output tile; each 32-deep step stages x's 64 x 32 tile and q's
//   32 x 128 int8 tile through shared memory, the int8 tile widened to
//   bf16 there, and 8 warps each run 2 x 2 wmma 16x16x16 bf16 fragments
//   (fp32 accumulate) over their 32 x 32 piece; the fp32 tile is then
//   staged through shared memory for the scale-and-round epilogue.
//
// Bound on the H100. Decode rows: bytes, the int8 weight read once
// (2 M FLOP per weight byte, far below the ridge of about 295): K N bytes
// at 3.35 TB/s, half of the bf16 weight's. Prefill rows at M 512: 2 M
// FLOP per weight byte passes the ridge, so the bf16 tensor cores
// (989 TFLOP/s) bound it. The rows kernel reaches neither bound: it
// keeps about 8 KB in flight per block, and the wmma path has no TMA or
// wgmma (ROADMAP R1).
#include <mma.h>

#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// -- decode rows ------------------------------------------------------------
constexpr int kRowThreads = 256;
constexpr int kStrip = 32;                       // output columns per block
constexpr int kSlices = kRowThreads / kStrip;    // split-K inside a block
constexpr int kChunk = 256;                      // weight rows per stage
constexpr int kRowsPerSlice = kChunk / kSlices;
constexpr int kQLoads = kChunk * (kStrip / 16) / kRowThreads;   // per thread

// 16 int8 weights at (k, n..n+15), zero past K or N
__device__ __forceinline__ uint4 load_q16(const int8_t* q, int k, int k_end,
                                          int n, int N, bool vec_q) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (k >= k_end) return v;
  const int8_t* src = q + (long)k * N + n;
  if (vec_q && n + 16 <= N) return *reinterpret_cast<const uint4*>(src);
  int8_t* dst = reinterpret_cast<int8_t*>(&v);
  for (int j = 0; j < 16; ++j) dst[j] = n + j < N ? src[j] : int8_t(0);
  return v;
}

// MT: rows of x per block (1, 2, 4, 8 or 16). grid: (strips of N,
// splits of K, tiles of M). ws == nullptr: one split, out written here.
template <typename T, int MT>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scale, T* __restrict__ out,
            float* __restrict__ ws, int M, int N, int K,
            int chunks_per_split, bool vec_q) {
  __shared__ __align__(16) int8_t qs[kChunk][kStrip];
  // x's chunk transposed ([row of q][row of x]); reused for the
  // split-K reduction, which needs kSlices * MT * kStrip = kChunk * MT
  __shared__ __align__(16) float xs[kChunk * MT];

  const int n0 = blockIdx.x * kStrip;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int tid = threadIdx.x;
  const int col = tid % kStrip;
  const int slice = tid / kStrip;
  const int k_begin = split * chunks_per_split * kChunk;
  const int k_end = min(K, k_begin + chunks_per_split * kChunk);

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  uint4 pre[kQLoads];
#pragma unroll
  for (int i = 0; i < kQLoads; ++i) {
    const int piece = tid + i * kRowThreads;
    pre[i] = load_q16(q, k_begin + piece / 2, k_end, n0 + (piece & 1) * 16,
                      N, vec_q);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += kChunk) {
    __syncthreads();                     // the previous chunk is consumed
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int piece = tid + i * kRowThreads;
      *reinterpret_cast<uint4*>(&qs[piece / 2][(piece & 1) * 16]) = pre[i];
    }
    for (int i = tid; i < kChunk * MT; i += kRowThreads) {
      const int m = i / kChunk;
      const int r = i % kChunk;          // neighbouring threads, neighbouring k
      const int k = k0 + r;
      const int mm = m0 + m;
      xs[r * MT + m] =
          (k < k_end && mm < M) ? pt::to_float(x[(long)mm * K + k]) : 0.f;
    }
    __syncthreads();
    // the next chunk's weights are in flight during this chunk's sums
    const int k_next = k0 + kChunk;
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int piece = tid + i * kRowThreads;
      pre[i] = load_q16(q, k_next + piece / 2, k_end, n0 + (piece & 1) * 16,
                        N, vec_q);
    }
    const int r0 = slice * kRowsPerSlice;
#pragma unroll 4
    for (int r = r0; r < r0 + kRowsPerSlice; ++r) {
      const float w = static_cast<float>(qs[r][col]);
      const float* xr = xs + r * MT;
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] += xr[m] * w;
    }
  }

  __syncthreads();
  float* red = xs;                       // [slice][m][col]
#pragma unroll
  for (int m = 0; m < MT; ++m) red[(slice * MT + m) * kStrip + col] = acc[m];
  __syncthreads();
  for (int i = tid; i < MT * kStrip; i += kRowThreads) {
    const int m = i / kStrip;
    const int c = i % kStrip;
    float s = 0.f;
#pragma unroll
    for (int sl = 0; sl < kSlices; ++sl) s += red[(sl * MT + m) * kStrip + c];
    const int mm = m0 + m;
    const int n = n0 + c;
    if (mm < M && n < N) {
      if (ws == nullptr) {
        out[(long)mm * N + n] = pt::from_float<T>(s * scale[n]);
      } else {
        ws[((long)split * M + mm) * N + n] = s;
      }
    }
  }
}

// the K splits' partial sums added in fp32, scaled once, rounded once
template <typename T>
__global__ void finalize_kernel(const float* __restrict__ ws,
                                const float* __restrict__ scale,
                                T* __restrict__ out, int M, int N,
                                int splits) {
  const long total = (long)M * N;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * total + i];
    out[i] = pt::from_float<T>(s * scale[i % N]);
  }
}

// -- prefill rows (bf16) ------------------------------------------------------
constexpr int kTM = 64;
constexpr int kTN = 128;
constexpr int kTK = 32;
constexpr int kTileThreads = 256;      // 8 warps: 2 (rows) x 4 (columns)
constexpr int kXLd = kTK + 8;          // bf16 row strides, 16-byte padded
constexpr int kQLd = kTN + 8;
constexpr int kCLd = kTN + 4;          // fp32 staged tile
constexpr int kXBytes = kTM * kXLd * 2;
constexpr int kQBytes = kTK * kQLd * 2;
constexpr int kCBytes = kTM * kCLd * 4;
constexpr int kTileSmem =
    kXBytes + kQBytes > kCBytes ? kXBytes + kQBytes : kCBytes;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__global__ void __launch_bounds__(kTileThreads)
tiles_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
             const float* __restrict__ scale, bf16* __restrict__ out, int M,
             int N, int K, bool vec_x, bool vec_q) {
  __shared__ __align__(128) unsigned char smem[kTileSmem];
  bf16* xs = reinterpret_cast<bf16*>(smem);               // [kTM][kXLd]
  bf16* qs = reinterpret_cast<bf16*>(smem + kXBytes);     // [kTK][kQLd]
  float* cs = reinterpret_cast<float*>(smem);             // [kTM][kCLd]

  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp / 4) * 32;
  const int wn = (warp % 4) * 32;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kTK) {
    __syncthreads();                     // the previous step is consumed
    {  // x: 64 rows x 32 columns, 8 bf16 (16 bytes) per thread
      const int r = tid / 4;
      const int c = (tid % 4) * 8;
      const int mm = m0 + r;
      const int k = k0 + c;
      bf16* dst = xs + r * kXLd + c;
      if (vec_x && mm < M && k + 8 <= K) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(x + (long)mm * K + k);
      } else {
        for (int j = 0; j < 8; ++j)
          dst[j] = (mm < M && k + j < K) ? x[(long)mm * K + k + j]
                                         : __float2bfloat16(0.f);
      }
    }
    {  // q: 32 rows x 128 columns, 16 int8 per thread, widened to bf16
      const int r = tid / 8;
      const int c = (tid % 8) * 16;
      const uint4 raw = load_q16(q, k0 + r, K, n0 + c, N, vec_q);
      const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
      bf16* dst = qs + r * kQLd + c;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = __float2bfloat16(static_cast<float>(v[j]));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 16) {
      FragA a[2];
      FragB bq[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm + i * 16) * kXLd + kk, kXLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bq[j], qs + kk * kQLd + wn + j * 16, kQLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bq[j], acc[i][j]);
    }
  }
  __syncthreads();                       // cs aliases xs and qs
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + i * 16) * kCLd + wn + j * 16,
                              acc[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kTM * kTN; e += kTileThreads) {
    const int r = e / kTN;
    const int c = e % kTN;
    const int mm = m0 + r;
    const int n = n0 + c;
    if (mm < M && n < N)
      out[(long)mm * N + n] = __float2bfloat16(cs[r * kCLd + c] * scale[n]);
  }
}

template <typename T>
int launch_rows(const T* x, const int8_t* q, const float* scale, T* out,
                float* ws, int M, int N, int K, int mt, int splits,
                int chunks_per_split, bool vec_q, cudaStream_t st) {
  const dim3 grid((N + kStrip - 1) / kStrip, splits, (M + mt - 1) / mt);
  float* part = splits > 1 ? ws : nullptr;
#define PT_ROWS_LAUNCH(MT)                                                  \
  rows_kernel<T, MT><<<grid, kRowThreads, 0, st>>>(x, q, scale, out, part, \
                                                   M, N, K,                \
                                                   chunks_per_split, vec_q)
  switch (mt) {
    case 1: PT_ROWS_LAUNCH(1); break;
    case 2: PT_ROWS_LAUNCH(2); break;
    case 4: PT_ROWS_LAUNCH(4); break;
    case 8: PT_ROWS_LAUNCH(8); break;
    case 16: PT_ROWS_LAUNCH(16); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_ROWS_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const long total = (long)M * N;
  const int blocks = static_cast<int>(
      (total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
  finalize_kernel<T><<<blocks, 256, 0, st>>>(ws, scale, out, M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

// bf16 with M > 16 takes the wmma tiles; every other case the rows kernel
bool uses_rows(int dtype, int M) { return dtype != pt::kBFloat16 || M <= 16; }

struct RowsGeometry {
  int mt;                // rows of x per block
  int splits;            // K splits over blocks (grid y)
  int chunks_per_split;  // 256-row chunks of q per split
};

// K splits over blocks only where the column strips and row tiles give
// fewer than two blocks per SM of the current device; every split
// non-empty
RowsGeometry rows_geometry(int M, int N, int K) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int mt = 1;
  while (mt < M && mt < 16) mt *= 2;
  const long blocks =
      (long)((N + kStrip - 1) / kStrip) * ((M + mt - 1) / mt);
  const int chunks = K > 0 ? (K + kChunk - 1) / kChunk : 1;
  const long want = (2L * (sms > 0 ? sms : 1) + blocks - 1) / blocks;
  const int splits = static_cast<int>(want < chunks ? want : chunks);
  const int per = (chunks + splits - 1) / splits;
  return {mt, (chunks + per - 1) / per, per};
}

}  // namespace

// fp32 elements of the workspace pt_int8_matmul needs for these
// operands (the K splits' partial sums), 0 when it needs none
extern "C" long pt_int8_matmul_workspace(int dtype, int M, int N, int K) {
  if (!uses_rows(dtype, M)) return 0;
  const RowsGeometry g = rows_geometry(M, N, K);
  return g.splits > 1 ? (long)g.splits * M * N : 0;
}

// ws: pt_int8_matmul_workspace(dtype, M, N, K) fp32 elements, or null
// when that is 0. vec_x / vec_q: x's rows (K % 8 == 0) and q's rows
// (N % 16 == 0) start 16-byte aligned.
extern "C" int pt_int8_matmul(int dtype, const void* x, const void* q,
                              const void* scale, void* out, void* ws, int M,
                              int N, int K, int vec_x, int vec_q,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RowsGeometry g = rows_geometry(M, N, K);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* wsp = static_cast<float*>(ws);
  if (dtype == pt::kBFloat16) {
    const bf16* xp = static_cast<const bf16*>(x);
    bf16* op = static_cast<bf16*>(out);
    if (!uses_rows(dtype, M)) {
      const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
      tiles_kernel<<<grid, kTileThreads, 0, st>>>(xp, qp, sp, op, M, N, K,
                                                  vec_x != 0, vec_q != 0);
      return static_cast<int>(cudaGetLastError());
    }
    return launch_rows<bf16>(xp, qp, sp, op, wsp, M, N, K, g.mt, g.splits,
                             g.chunks_per_split, vec_q != 0, st);
  }
  if (dtype == pt::kFloat32) {
    return launch_rows<float>(static_cast<const float*>(x), qp, sp,
                              static_cast<float*>(out), wsp, M, N, K, g.mt,
                              g.splits, g.chunks_per_split, vec_q != 0, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

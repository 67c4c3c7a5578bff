// K6, K7 — the backward of the fused softmax cross-entropy over a
// projection, for Hopper (sm_90a): dx and dw from one dl per vocab chunk.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/fused_ce.py:
// `_dx_kernel` (:89, launched at :178) — K6, dx — and `_dw_kernel` (:107,
// :199) — K7, dw. For rows x (N, d), weights w (V, d) in embedding layout,
// int32 labels (negative = ignored), the forward's lse (N,) and the loss
// cotangent g (N,), zeroed on ignored rows by the caller:
//
//   dl = round((exp(x . w^T - lse) - onehot(label)) * g)      (N, V)
//   K6: dx = dl . w        K7: dw = dl^T . x
//
// with dl rounded to the inputs' dtype before its products, as the TPU
// kernels round it (`_dlogits`, :79-86, `.astype` at :99 and :119).
//
// Design. The TPU kernels recompute the logit tile inside both K6 and K7
// and carry their sums in VMEM along the sequential grid axis. On the H100
// that carry becomes an fp32 read-modify-write of device memory per tile,
// and the recompute a fourth product. Instead the vocabulary is cut into
// chunks of Vc columns (ops/fused_ce.py plans them, the last one ragged),
// and each chunk [v0, v0 + vc) takes three launches on the caller's
// stream:
//   dl pass: dl_c = round(dlogits(x . w_c^T)), an (N, vc) product over d
//            whose epilogue runs on the accumulators and stores dl_c in
//            x's dtype into a scratch of N x Vc;
//   K6:      dx32 (+)= dl_c . w_c, (N, d) over vc: the tile's fp32 sum
//            starts from dx32 (from 0 in the first chunk), stays in
//            registers across the chunk, and the last chunk writes dx in
//            x's dtype, so no second summing pass;
//   K7:      dw[v0 .. v0 + vc) = dl_c^T . x, (vc, d) over N: each vocab
//            row belongs to one chunk, so its sum finishes in registers
//            and is written once, in w's dtype.
// Three products of N V d multiply-adds where the TPU's K6 and K7 do four
// (each recomputes the logits), and at most one (N, Vc) chunk of dl held:
// the (N, V) logits never exist whole.
//
// bf16 (the train path): one warp-specialised mainloop for the three
// products (ce_gemm.cuh, which K5's forward shares). A block of three
// warpgroups owns a 128 x 256 output tile. One producer thread issues
// TMA loads (128-byte swizzle, 64-deep stages, a ring of kStages
// completed on mbarriers); two consumer warpgroups each run
// wgmma.mma_async m64n256k16 (bf16 in, fp32 accumulate, both operands from
// shared memory) on their 64 rows, and the epilogue works on the
// accumulator registers. Operand majors differ by launch: the dl pass
// reads x and w_c K-major; K6 reads dl_c K-major and w_c MN-major; K7
// reads dl_c^T and x both MN-major (wgmma's transpose bits, legal for
// 16-bit types). Ragged edges: TMA fills rows and columns past a map's
// extent with zeros, each chunk's maps span the chunk alone (K6 and K7
// never read the columns a wider chunk left in the scratch), and the
// epilogues mask their stores; the dl epilogue writes nothing past the
// chunk or past N, where a zero-filled w row would give exp(0 - lse).
// K6's accumulators start from its dx32 tile, loaded while the first
// stages arrive; ptxas reports that this serializes K6's wgmmas (C7515),
// yet on an H100 SXM the whole backward ran faster so (8.08 ms) than with
// the dx32 tile added in the epilogue, after the mainloop (8.67 ms).
// fp32: the same three launches through a CUDA-core tile (64 x 128 per
// block of 256 threads, 16-deep fp32 stages; the FP32 pipes, no TF32).
//
// Bound on the H100. At the train shape (N 8188, d 2048, V 50304, bf16)
// each product is N V d = 8.44e11 multiply-adds, 1.71 ms at 989 TFLOP/s,
// so 5.12 ms for the three, against about 0.3 GB of inputs and outputs
// plus the scratch (dl written once and read twice, dx32 read and written
// once per chunk, about 2.5 GB at Vc 4096): the tensor cores bound it.
#include "ce_gemm.cuh"
#include "common.cuh"

namespace {

using namespace ce;
using bf16 = __nv_bfloat16;

// ---- bf16: TMA + wgmma (ce_gemm.cuh's mainloop) ---------------------------

// out tile (128 x 256 at blockIdx.y * 128, blockIdx.x * 256) = A . B over K,
// A (M x K) from map ta, B (K x N) from map tb, both bf16, through the
// epilogue `epi`: the accumulators start from epi.init2 (K6: the fp32 sum
// so far, loaded while the first stages arrive) and end in epi.put2.
// Thread t of consumer warpgroup cw holds rows r0 = 64 cw + 16 (t / 32) +
// (t % 32) / 4 and r0 + 8, columns 8 j + 2 (t % 4) + {0, 1}: acc[4 j + 0,
// 1] on row r0, acc[4 j + 2, 3] on row r0 + 8.
template <bool kAMn, bool kBMn, class Epi>
__global__ void __launch_bounds__(kWgThreads, 1)
    ce_bwd_wgmma(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb, int K,
                 const Epi epi) {
  extern __shared__ unsigned char smem_raw[];
  const Ring ring = Ring::at(smem_raw);
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps kStages stages of loads in flight
    regs_dec<40>();
    if (threadIdx.x == 0) produce<kAMn, kBMn>(ring, &ta, &tb, m0, n0, 1, nk);
  } else {
    regs_inc<232>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int r0 = m0 + cw * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int c0 = n0 + 2 * (t % 4);
    const typename Epi::Row row0 = epi.row(r0), row1 = epi.row(r0 + 8);
    float acc[kBN / 2];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float2 u = epi.init2(row0, r0, c0 + 8 * j);
      const float2 v = epi.init2(row1, r0 + 8, c0 + 8 * j);
      acc[4 * j] = u.x;
      acc[4 * j + 1] = u.y;
      acc[4 * j + 2] = v.x;
      acc[4 * j + 3] = v.y;
    }
    int it = 0;
    consume<kAMn, kBMn>(ring, acc, cw, t, nk, it);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      epi.put2(row0, r0, c0 + 8 * j, acc[4 * j], acc[4 * j + 1]);
      epi.put2(row1, r0 + 8, c0 + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---- fp32: the CUDA cores --------------------------------------------------

constexpr int kSM = 64;             // rows per block
constexpr int kSN = 128;            // columns per block
constexpr int kSK = 16;             // stage depth
constexpr int kSThreads = 256;      // 16 x 16, 4 x 8 outputs each

// thread (ty, tx) = (tid / 16, tid % 16) owns rows 4 ty + i (i < 4) and
// columns col_of(tx, j) (j < 8): two runs of four, 64 apart
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
}

// acc[i][j] += sum_k a[k][4 ty + i] * b[k][col_of(tx, j)] over one stage;
// a has row stride kSM, b row stride kSN (both 16-byte aligned)
__device__ __forceinline__ void mma_stage(const float* a, const float* b,
                                          float (&acc)[4][8]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int k = 0; k < kSK; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * kSM + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * kSN + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(b + k * kSN + 64 + tx * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += ar[i] * br[j];
  }
}

// out tile (64 x 128) = A . B over K through `epi`, with A(m, k) =
// a[m * sam + k * sak] (M x K) and B(k, n) = b[k * sbk + n * sbn] (K x N);
// entries past M, N or K read as 0
template <class Epi>
__global__ void __launch_bounds__(kSThreads)
    ce_bwd_simt(const float* __restrict__ a, long sam, long sak,
                const float* __restrict__ b, long sbk, long sbn, int M,
                int Nn, int K, const Epi epi) {
  __shared__ __align__(16) float sa[kSK * kSM];
  __shared__ __align__(16) float sb[kSK * kSN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * kSM, n0 = blockIdx.x * kSN;
  typename Epi::Row rows[4];
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * ty + i;
    rows[i] = epi.row(r);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 u = epi.init2(rows[i], r, n0 + col_of(tx, 2 * h));
      acc[i][2 * h] = u.x;
      acc[i][2 * h + 1] = u.y;
    }
  }
  for (int k0 = 0; k0 < K; k0 += kSK) {
    __syncthreads();                       // the previous stage consumed
#pragma unroll
    for (int e = 0; e < kSK * kSM / kSThreads; ++e) {
      const int idx = tid + kSThreads * e;
      const int m = m0 + idx % kSM, k = k0 + idx / kSM;
      sa[idx] = m < M && k < K ? a[m * sam + k * sak] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kSK * kSN / kSThreads; ++e) {
      const int idx = tid + kSThreads * e;
      const int n = n0 + idx % kSN, k = k0 + idx / kSN;
      sb[idx] = n < Nn && k < K ? b[k * sbk + n * sbn] : 0.f;
    }
    __syncthreads();
    mma_stage(sa, sb, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 4; ++h)
      epi.put2(rows[i], m0 + 4 * ty + i, n0 + col_of(tx, 2 * h),
               acc[i][2 * h], acc[i][2 * h + 1]);
}

// ---- epilogues -------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);

template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the pair (c, c + 1) of row r into out[r * ld + c ..] in T, c even; the
// second only where c + 1 < n
template <typename T>
__device__ __forceinline__ void put_pair(T* out, long ld, int r, int c,
                                         int n, float a, float b) {
  T* p = out + r * ld + c;
  if (c + 1 < n)
    store2(p, a, b);
  else
    *p = pt::from_float<T>(a);
}

// dl pass: the chunk's dlogits (columns [v0, v0 + Nn) of the vocabulary)
// into dl, row stride ld, in T; nothing past row M or column Nn
template <typename T>
struct DlEpi {
  T* dl;
  const int* labels;
  const float* lse;
  const float* g;
  int M, Nn, ld, v0;

  struct Row {
    int lab;  // the label's column within the chunk (negative: none)
    float lz, g;
  };
  __device__ Row row(int r) const {
    if (r >= M) return {-1, 0.f, 0.f};
    return {labels[r] < 0 ? -1 : labels[r] - v0, lse[r], g[r]};
  }
  __device__ float2 init2(const Row&, int, int) const {
    return make_float2(0.f, 0.f);
  }
  __device__ float dlogit(const Row& w, int c, float s) const {
    return (__expf(s - w.lz) - (c == w.lab ? 1.f : 0.f)) * w.g;
  }
  __device__ void put2(const Row& w, int r, int c, float a, float b) const {
    if (r >= M || c >= Nn) return;
    put_pair(dl, ld, r, c, Nn, dlogit(w, c, a), dlogit(w, c + 1, b));
  }
};

// K6: the chunk's product added to dx32 (from 0 in the first chunk); the
// last chunk writes dx in T instead
template <typename T>
struct DxEpi {
  float* dx32;
  T* dx;
  int M, Nn, first, last;

  struct Row {};
  __device__ Row row(int) const { return {}; }
  __device__ float2 init2(const Row&, int r, int c) const {
    if (first || r >= M || c >= Nn) return make_float2(0.f, 0.f);
    const float* p = dx32 + static_cast<long>(r) * Nn + c;
    return c + 1 < Nn ? *reinterpret_cast<const float2*>(p)
                      : make_float2(p[0], 0.f);
  }
  __device__ void put2(const Row&, int r, int c, float a, float b) const {
    if (r >= M || c >= Nn) return;
    if (last)
      put_pair(dx, Nn, r, c, Nn, a, b);
    else
      put_pair(dx32, Nn, r, c, Nn, a, b);
  }
};

// K7: the chunk's rows of dw (dw + v0 * d), in T
template <typename T>
struct DwEpi {
  T* dw;
  int M, Nn;

  struct Row {};
  __device__ Row row(int) const { return {}; }
  __device__ float2 init2(const Row&, int, int) const {
    return make_float2(0.f, 0.f);
  }
  __device__ void put2(const Row&, int r, int c, float a, float b) const {
    if (r >= M || c >= Nn) return;
    put_pair(dw, Nn, r, c, Nn, a, b);
  }
};

// ---- host ------------------------------------------------------------------

// C (M x Nn) = A (M x K) . B (K x Nn) through epi on the tensor cores; A
// stored as `a_inner` x `a_outer` (ld a_ld), B likewise
template <bool kAMn, bool kBMn, class Epi>
int wg_gemm(const void* a, long a_inner, long a_outer, long a_ld,
            const void* b, long b_inner, long b_outer, long b_ld, int M,
            int Nn, int K, const Epi& epi, cudaStream_t st) {
  CUtensorMap ta, tb;
  int rc = operand_map<kAMn, kBM>(&ta, a, a_inner, a_outer, a_ld);
  if (rc == 0) rc = operand_map<kBMn, kBN>(&tb, b, b_inner, b_outer, b_ld);
  if (rc != 0) return rc;
  const auto kernel = ce_bwd_wgmma<kAMn, kBMn, Epi>;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem));
  if (rc != 0) return rc;
  const dim3 grid((Nn + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kWgThreads, kWgSmem, st>>>(ta, tb, K, epi);
  return static_cast<int>(cudaGetLastError());
}

// the same on the CUDA cores, A and B by element strides
template <class Epi>
int simt_gemm(const float* a, long sam, long sak, const float* b, long sbk,
              long sbn, int M, int Nn, int K, const Epi& epi,
              cudaStream_t st) {
  const dim3 grid((Nn + kSN - 1) / kSN, (M + kSM - 1) / kSM);
  ce_bwd_simt<Epi><<<grid, kSThreads, 0, st>>>(a, sam, sak, b, sbk, sbn, M,
                                               Nn, K, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One vocab chunk [v0, v0 + vc) per call. x (N, d) and w (V, d)
// contiguous, 16-byte aligned, of one dtype, d % 8 == 0; labels (N,)
// int32; lse, g (N,) fp32; dl (N, ld) in x's dtype with vc <= ld, ld % 8
// == 0; dx32 (N, d) fp32 (unused when the call is both first and last).

// the dl pass: dl[:, :vc] = the chunk's dlogits
extern "C" int pt_ce_bwd_dl(int dtype, const void* x, const void* w,
                            const void* labels, const void* lse,
                            const void* g, void* dl, int N, int d, int v0,
                            int vc, int ld, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* lz = static_cast<const float*>(lse);
  const float* gr = static_cast<const float*>(g);
  const long off = static_cast<long>(v0) * d;
  if (dtype == pt::kBFloat16) {
    const DlEpi<bf16> epi{static_cast<bf16*>(dl), lab, lz, gr, N, vc, ld, v0};
    return wg_gemm<false, false>(x, d, N, d,
                                 static_cast<const bf16*>(w) + off, d, vc,
                                 d, N, vc, d, epi, st);
  }
  if (dtype == pt::kFloat32) {
    const DlEpi<float> epi{static_cast<float*>(dl), lab, lz, gr, N, vc, ld,
                           v0};
    return simt_gemm(static_cast<const float*>(x), d, 1,
                     static_cast<const float*>(w) + off, 1, d, N, vc, d, epi,
                     st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K6: dx32 (+)= dl[:, :vc] . w[v0 .. v0 + vc); `first` overwrites, `last`
// writes dx in x's dtype
extern "C" int pt_ce_bwd_dx(int dtype, const void* dl, const void* w,
                            void* dx32, void* dx, int N, int d, int v0,
                            int vc, int ld, int first, int last,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(dx32);
  const long off = static_cast<long>(v0) * d;
  if (dtype == pt::kBFloat16) {
    const DxEpi<bf16> epi{acc, static_cast<bf16*>(dx), N, d, first, last};
    return wg_gemm<false, true>(dl, vc, N, ld,
                                static_cast<const bf16*>(w) + off, d, vc, d,
                                N, d, vc, epi, st);
  }
  if (dtype == pt::kFloat32) {
    const DxEpi<float> epi{acc, static_cast<float*>(dx), N, d, first, last};
    return simt_gemm(static_cast<const float*>(dl), ld, 1,
                     static_cast<const float*>(w) + off, d, 1, N, d, vc, epi,
                     st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7: dw[v0 .. v0 + vc) = dl[:, :vc]^T . x
extern "C" int pt_ce_bwd_dw(int dtype, const void* dl, const void* x,
                            void* dw, int N, int d, int v0, int vc, int ld,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long off = static_cast<long>(v0) * d;
  if (dtype == pt::kBFloat16) {
    const DwEpi<bf16> epi{static_cast<bf16*>(dw) + off, vc, d};
    return wg_gemm<true, true>(dl, vc, N, ld, x, d, N, d, vc, d, N, epi, st);
  }
  if (dtype == pt::kFloat32) {
    const DwEpi<float> epi{static_cast<float*>(dw) + off, vc, d};
    return simt_gemm(static_cast<const float*>(dl), 1, ld,
                     static_cast<const float*>(x), d, 1, vc, d, N, epi, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K8 — the whole L-layer paged decode step in one cooperative launch, and
// K9 — final LayerNorm -> vocabulary logits -> first-max argmax with a
// non-finite flag, in one launch; for Hopper (sm_90a).
//
// K8 replaces the Pallas TPU kernel
// paddle_tpu/ops/pallas/decode_megakernel.py `_mega_kernel` (launched by
// `mega_decode_layers`, the pl.pallas_call at :366); K9 replaces
// `_epilogue_kernel` (launched by `mega_logits_sample`, :458).
//
// K8 semantics, as in the TPU kernel's body (:127-259). Rows are flat:
// row r carries its own (slot, position, write flag). Per layer l:
// LayerNorm (eps 1e-5, fp32 statistics, result rounded to x's dtype),
// the fused QKV product (+ bias), rope on q and k when asked
// (rotate-half, theta^(-i/half)), every row's fresh K/V row written into
// page table[slot, min(pos / page, mx - 1)] of layer l (row l*P + page)
// at offset pos % page — or into the scratch page L*P when the row's
// write flag is 0 — BEFORE any row attends; then attention over
// [0, pos + 1) of the row's slot (GQA query head h reads kv head
// h / group), the out-projection (+ bias) and residual, LayerNorm, the
// up-projection (+ bias), tanh GELU, the down-projection (+ bias) and
// residual. Every product accumulates in fp32 and is rounded to x's
// dtype where the JAX block rounds it (the matmul output, each bias add,
// the GELU, each residual add), so the residual stream stays in x's
// dtype between layers. The attention's p is rounded to the pool dtype
// before p.v, as `online_softmax_step` rounds it.
//
// K8 design. A persistent cooperative kernel: the grid is every block
// that can be resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// SM count, worked out in `mega_grid`), launched with
// cudaLaunchCooperativeKernel, and the phases of a layer are separated
// by cooperative_groups grid barriers, which are sound only under that
// launch. Per layer:
//
//   1. LN1 + QKV. The four products share one scheme (`gemm_phase`):
//      units of (256 output columns, a depth range, 8 rows). The rows
//      of a block's tile stay resident in shared memory for the phase
//      (depth-major, so one 16-byte load gives a depth's 8 rows), read
//      from L2 in 16-byte loads and, for LN1 and LN2, normalised in
//      place (statistics per block; rounded to x's dtype). In bf16 a
//      unit is 64 columns on the tensor cores (`mma_tile_sums`: each
//      warp streams 16-deep slabs of 128 contiguous bytes a row through
//      its own cp.async ring and multiplies them with mma.sync; the
//      8 rows of x fill half of the 16-row A operand); in fp32 it is
//      256 columns on the CUDA cores (`tile_sums`: each thread streams
//      16-byte pieces through a private cp.async ring). Either way the
//      depth splits over warps or threads and reduces through shared
//      memory. Where the column tiles are
//      fewer than the resident blocks, the depth also splits over
//      blocks (`split_count`); the partial sums go to an fp32 workspace
//      and, after one more grid barrier, every thread adds its outputs'
//      partials in a fixed order and applies the epilogue. Output:
//      q|k|v rows (+ bias) in a global scratch.
//   2. Rope on k, and the fresh K/V rows written into the pools. Rope
//      couples column c with c +- d/2 of another tile, so it runs after
//      the barrier. Merging this into phase 3 would let a row attend
//      before another row of its slot has written.
//   3. Attention, one block per (row, kv head) at a time, over the
//      row's valid keys only, gathered page by page through the table:
//      K10's design (8 warps, each with its own online softmax over
//      every 8th group of keys, merged through shared memory), q read
//      from the scratch with rope applied on load. Output o in a scratch.
//   4. Out-projection + bias + residual into x_out. Each output is
//      finished by one thread, which reads x at that entry only, so the
//      in-place update is race-free.
//   5. LN2 + up-projection + bias + GELU into the (B, F) scratch.
//   6. Down-projection + bias + residual into x_out (as in 4).
//
// Phase 1 of layer l+1 reads every column of x_out, which phase 6 of
// layer l wrote in all blocks: hence the barrier after 6. Reads of data
// written inside the launch (x_out, the scratches, the workspace, the
// pools) go through L2 (`__ldcg`, cp.async.cg), never the non-coherent
// read-only path; weights go through `__ldg` or cp.async.
//
// K9 design. A regular launch, one block per SM; each block keeps its
// 8 rows resident after the final LN (as K8's phase 1), and takes units
// of vocabulary columns x 8 rows: for the tied head, whose (V, dm) rows
// are contiguous along dm, 32 columns, one warp per 4 reading along dm;
// for a (dm, V) row-major head, K8's 256-column tiles over the whole
// depth. Their logits, rounded to x's dtype, NaN where the row
// is poisoned. Per row it keeps the non-finite flag over the true vocab
// and the largest key = (order-preserving float bits << 32 | ~index):
// the largest value wins, and among equal values the lowest index
// (jnp.argmax's first max). NaN never enters the max; it sets the flag.
// Blocks merge with one 64-bit atomicMax per row; the last block to
// finish (a counter) writes the tokens and flags and zeroes the
// workspace for the next launch. The (B, V) logits never reach global
// memory.
//
// Bound on the H100: bytes. K8 does 2 B FLOP per weight element it
// reads, far below the ridge (about 295 FLOP per byte), so its floor is
// reading every layer's weights once, plus the valid K/V rows each row
// attends to, plus the fresh rows written, at 3.35 TB/s; K9's the head
// (V x dm) once. Why K8 does not reach it today (chip_smoke.py on an
// H100 80GB HBM3 at 700 W): one gpt3_1p3b layer takes about 0.2 ms, of
// which about 0.06 ms is the phases' fixed cost, measured at d_model 128
// (up to 10 grid barriers a layer, each product's staging, reduction
// and split round trip); the weight stream moves at about a fifth of
// the card's rate with the products on the CUDA cores and on the tensor
// cores alike, so arithmetic is not what bounds it: each unit reads
// short row segments (128 bytes in bf16) spread over the matrix and
// stalls at its end. Fewer phases and a TMA pipeline over wide tiles
// are later work (ROADMAP R1).
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 8;                  // rows of x per unit (== kWarps)
constexpr int kMaxRows = 64;
constexpr int kDMax = 128;              // largest head_dim
constexpr int kGMax = 8;                // largest GQA group
constexpr int kLogitsStrip = 32;        // K9, tied head: vocab columns a unit
constexpr int kNW = 256;                // row-major products: columns a tile
// the activation operand resident in shared memory: kMT rows x up to
// kACapBytes / (kMT sizeof(T)) depth (8192 bf16: every gpt3_1p3b
// product's whole depth; fp32 operands deeper than 4096 go in chunks)
constexpr int kACapBytes = 128 * 1024;
// the weight stream's rings: kStages 16-byte pieces a thread (fp32
// products), or kMmaStages 16 x 64 bf16 slabs a warp (bf16 products)
constexpr int kStages = 8;
constexpr int kMmaNW = 64;              // bf16 products: columns a tile
constexpr int kMmaStages = 4;
constexpr int kSlabBytes = 16 * kMmaNW * 2;
constexpr int kRingBytes = kMmaStages * kWarps * kSlabBytes;
static_assert(kStages * kThreads * 16 <= kRingBytes, "fp32 ring");
// a tile's cross-thread reduction, half its 8 rows at a time (bf16: 8
// depth lanes x 4 rows x kNW columns)
constexpr int kRedFloats = 8 * 4 * kNW;
// the least depth a split of a row-major product walks
constexpr int kMinSplitDepth = 64;
constexpr int kAttnFloats = kWarps * kGMax * kDMax + 2 * kWarps * kGMax;
constexpr int kSmemBytes = kACapBytes + kRingBytes + kRedFloats * 4;

static_assert(kMT == kWarps, "K9's row reduction gives one warp per row");
static_assert(kAttnFloats * 4 <= kACapBytes,
              "the attention phase reuses the operand's shared memory");

// -- loads ------------------------------------------------------------------

// one element written inside the launch, through L2
template <typename T>
__device__ __forceinline__ float ldcg_f(const T* p);

template <>
__device__ __forceinline__ float ldcg_f<float>(const float* p) {
  return __ldcg(p);
}

template <>
__device__ __forceinline__ float ldcg_f<bf16>(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// V = 16 / sizeof(T) elements at p, written inside the launch, as fp32
// through L2, zero where n + e >= n_end; one 16-byte load when vec (p
// 16-byte aligned and n + V <= n_end)
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, int n, int n_end,
                                         bool vec, float* out) {
  constexpr int V = 16 / sizeof(T);
  if (vec && n + V <= n_end) {
    const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(p));
    const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = pt::to_float(el[e]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      out[e] = n + e < n_end ? ldcg_f(p + e) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// -- the products ----------------------------------------------------------

// The activation operand of a product: rows of a (B, K) matrix in T,
// as they are or through LayerNorm (eps 1e-5, fp32 statistics over the
// resident row, so K must fit shared memory whole: a_cap)
template <typename T>
struct ASrc {
  const T* a;
  const float* ln_s;   // (K,) fp32, or null: no LayerNorm
  const float* ln_b;
};

// the depth of the operand that shared memory holds at once
template <typename T>
__host__ __device__ constexpr int a_cap() {
  return kACapBytes / (kMT * static_cast<int>(sizeof(T)));
}

// rows [m0, m0 + kMT) x depth [k0, k0 + kc) of the operand into
// As[kk * kMT + m] in T, depth-major, so that one 16-byte load (two for
// fp32) gives a depth's 8 rows; rows past B are zero. The rows are read
// through L2 (written inside the launch), 16 bytes a load, kB loads in
// flight a thread.
template <typename T>
__device__ void stage_raw(const T* a, int m0, int B, int K, int k0, int kc,
                          T* As) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kB = 8;
  const bool vec = K % V == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const int nv = (kc + V - 1) / V;       // vectors per row
  const int total = kMT * nv;
  for (int i0 = threadIdx.x; i0 < total; i0 += kB * kThreads) {
    uint4 raw[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int i = i0 + b * kThreads;
      raw[b] = make_uint4(0u, 0u, 0u, 0u);
      const int m = i / nv;
      const int kk = (i - m * nv) * V;
      if (i < total && m0 + m < B) {
        const T* src = a + (long)(m0 + m) * K + k0 + kk;
        if (vec && kk + V <= kc) {
          raw[b] = __ldcg(reinterpret_cast<const uint4*>(src));
        } else {
          T* el = reinterpret_cast<T*>(&raw[b]);
          for (int e = 0; e < V && kk + e < kc; ++e)
            el[e] = pt::from_float<T>(ldcg_f(src + e));
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int i = i0 + b * kThreads;
      const int m = i / nv;
      const int kk = (i - m * nv) * V;
      if (i < total) {
        const T* el = reinterpret_cast<const T*>(&raw[b]);
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (kk + e < kc) As[(kk + e) * kMT + m] = el[e];
      }
    }
  }
}

// LayerNorm of the resident tile in place: warp m takes row m's
// statistics (two passes in fp32), then every entry is normalised,
// scaled, shifted and rounded to T as the block rounds it
template <typename T>
__device__ void layer_norm_a(const ASrc<T>& A, int K, T* As) {
  __shared__ float mu[kMT];
  __shared__ float rstd[kMT];
  const int lane = threadIdx.x & 31;
  const int m = threadIdx.x >> 5;        // kMT == kWarps
  float sum = 0.f;
  for (int k = lane; k < K; k += 32) sum += pt::to_float(As[k * kMT + m]);
  const float mean = warp_sum(sum) / K;
  float var = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float t = pt::to_float(As[k * kMT + m]) - mean;
    var += t * t;
  }
  var = warp_sum(var) / K;
  if (lane == 0) {
    mu[m] = mean;
    rstd[m] = 1.0f / sqrtf(var + 1e-5f);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kMT * K; i += kThreads) {
    const int k = i / kMT;
    const int r = i % kMT;
    As[i] = pt::from_float<T>((pt::to_float(As[i]) - mu[r]) * rstd[r] *
                                  A.ln_s[k] +
                              A.ln_b[k]);
  }
}

// Make depth [k0, k0 + kc) of row tile m0 resident (normalised when the
// operand has a LayerNorm, which the caller guarantees fits whole).
// *staged names the tile whose whole depth is resident (-1: none), so
// the units of one phase that share a tile stage it once.
template <typename T>
__device__ void ensure_a(const ASrc<T>& A, int m0, int B, int K, int k0,
                         int kc, T* As, int* staged) {
  if (kc == K && *staged == m0) return;
  __syncthreads();                       // the resident operand is consumed
  stage_raw(A.a, m0, B, K, k0, kc, As);
  __syncthreads();
  if (A.ln_s != nullptr) {
    layer_norm_a(A, K, As);
    __syncthreads();
  }
  *staged = kc == K ? m0 : -1;
}

// the 8 rows of depth kk of the resident operand, as fp32
template <typename T>
__device__ __forceinline__ void a_rows(const T* As, int kk, float* a) {
  if constexpr (sizeof(T) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(As + kk * kMT);
    const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int m = 0; m < kMT; ++m) a[m] = pt::to_float(el[m]);
  } else {
    const float4 lo = *reinterpret_cast<const float4*>(As + kk * kMT);
    const float4 hi = *reinterpret_cast<const float4*>(As + kk * kMT + 4);
    a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
    a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
  }
}

// cp.async of 16 bytes into shared memory, the bytes past src_bytes zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of a read-only weight at p (V = 16 / sizeof(T) elements), the
// elements at n + e >= n_end zero; one load when vec (p 16-byte aligned)
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* p, int n, int n_end,
                                          bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec && n + V <= n_end) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  T* el = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (n + e < n_end) el[e] = p[e];
  return raw;
}

// one thread's piece of the weight stream, W[k, n .. n + V), into its
// ring slot: asynchronously (cp.async, zero past N) where rows are
// 16-byte aligned, else through registers
template <typename T>
__device__ __forceinline__ void fill_slot(uint4* slot, const T* src, int n,
                                          int N, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (n >= N) {
    *slot = make_uint4(0u, 0u, 0u, 0u);  // a column past the weight's end
  } else if (vec) {
    cp_async16(slot, src, n + V <= N ? 16 : (N - n) * (int)sizeof(T));
  } else {
    *slot = load_raw(src, n, N, false);
  }
}

// The sums of one tile of a row-major (K, N) weight: out(row, n, sum)
// for rows m0 .. m0 + 8 (below B) and columns c0 .. c0 + kNW (below N),
// over depths [kb, ke). A tile row is kNW columns of contiguous memory
// (512 bytes in bf16), so the stream reads whole DRAM bursts. Thread t
// owns the columns (t % CG) * V .. + V of the tile and every RS-th depth
// (split-K inside the block); its 16-byte pieces stream through a
// private ring of kStages slots in shared memory (cp.async, kStages - 1
// in flight: no registers held and no block barrier, since a thread
// reads only what it copied). The depth lanes' partial sums reduce
// through shared memory, four rows at a time.
template <typename T, class Out>
__device__ void tile_sums(const ASrc<T>& A, int m0, int B, int K,
                          const T* __restrict__ W, int N, int c0, int kb,
                          int ke, bool vec, T* As, uint4* ring, float* red,
                          int* staged, Out out) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CG = kNW / V;            // threads a weight row: 32 or 64
  constexpr int RS = kThreads / CG;      // depth lanes: 8 or 4
  constexpr int cap = a_cap<T>();
  static_assert(RS * 4 * kNW <= kRedFloats, "reduction buffer");
  const int tid = threadIdx.x;
  const int cgi = tid % CG;
  const int kr = tid / CG;
  const int n = c0 + cgi * V;
  uint4* mine = ring + tid;              // slot s at mine[s * kThreads]
  float acc[kMT][V];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[m][e] = 0.f;

  for (int k0 = kb / cap * cap; k0 < ke; k0 += cap) {
    const int kc = min(cap, K - k0);
    ensure_a(A, m0, B, K, k0, kc, As, staged);
    const int lo = max(kb, k0);
    const int hi = min(ke, k0 + kc);
    // this thread's depths: lo + kr, lo + kr + RS, ... below hi
    const int iters = lo + kr < hi ? (hi - lo - kr + RS - 1) / RS : 0;
    const T* wb = W + (long)(lo + kr) * N + n;
#pragma unroll
    for (int it = 0; it < kStages - 1; ++it) {
      if (it < iters)
        fill_slot(mine + it * kThreads, wb + (long)it * RS * N, n, N, vec);
      cp_async_commit();
    }
    for (int it = 0; it < iters; ++it) {
      const int nx = it + kStages - 1;
      if (nx < iters)
        fill_slot(mine + (nx % kStages) * kThreads, wb + (long)nx * RS * N,
                  n, N, vec);
      cp_async_commit();
      cp_async_wait<kStages - 1>();      // piece `it` has landed
      const uint4 raw = mine[(it % kStages) * kThreads];
      float a[kMT];
      a_rows(As, lo + kr + it * RS - k0, a);
      const T* w = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float we = pt::to_float(w[e]);
#pragma unroll
        for (int m = 0; m < kMT; ++m) acc[m][e] += a[m] * we;
      }
    }
    cp_async_wait<0>();
  }
  // red[(lane * 4 + mm) * kNW + c]: depth lane's sum for row h * 4 + mm
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __syncthreads();                     // red is free
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
#pragma unroll
      for (int e = 0; e < V; ++e)
        red[(kr * 4 + mm) * kNW + cgi * V + e] = acc[h * 4 + mm][e];
    __syncthreads();
    for (int i = tid; i < 4 * kNW; i += kThreads) {
      const int mm = i / kNW;
      const int c = i % kNW;
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < RS; ++r) sum += red[(r * 4 + mm) * kNW + c];
      const int row = m0 + h * 4 + mm;
      if (row < B && c0 + c < N) out(row, c0 + c, sum);
    }
  }
  __syncthreads();
}

// The sums of a 32-column strip of a weight stored (N, K), contiguous
// along the depth (the tied LM head, wte), left in red[m * 32 + c]: warp
// w owns 4 columns, each lane V depth elements at a time, two depth
// steps in flight.
template <typename T>
__device__ void strip_kmajor(const ASrc<T>& A, int m0, int B, int K,
                             const T* __restrict__ W, int N, int n0,
                             bool vec, T* As, float* red, int* staged) {
  constexpr int V = 16 / sizeof(T);
  constexpr int SW = kLogitsStrip;
  constexpr int CPW = SW / kWarps;
  constexpr int kS = 2;
  constexpr int cap = a_cap<T>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc[CPW][kMT];
#pragma unroll
  for (int j = 0; j < CPW; ++j)
#pragma unroll
    for (int m = 0; m < kMT; ++m) acc[j][m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += cap) {
    const int kc = min(cap, K - k0);
    ensure_a(A, m0, B, K, k0, kc, As, staged);
    for (int kk = lane * V; kk < kc; kk += kS * 32 * V) {
      uint4 raw[kS][CPW];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int k = kk + s * 32 * V;
#pragma unroll
        for (int j = 0; j < CPW; ++j) {
          const int n = n0 + warp * CPW + j;
          raw[s][j] = (n < N && k < kc)
                          ? load_raw(W + (long)n * K + k0 + k, k, kc, vec)
                          : make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int k = kk + s * 32 * V;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (k + e < kc) {
            float a[kMT];
            a_rows(As, k + e, a);
#pragma unroll
            for (int j = 0; j < CPW; ++j) {
              const float we =
                  pt::to_float(reinterpret_cast<const T*>(&raw[s][j])[e]);
#pragma unroll
              for (int m = 0; m < kMT; ++m) acc[j][m] += a[m] * we;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CPW; ++j)
#pragma unroll
    for (int m = 0; m < kMT; ++m) acc[j][m] = warp_sum(acc[j][m]);
  __syncthreads();                       // the previous unit's sums are read
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < CPW; ++j)
#pragma unroll
      for (int m = 0; m < kMT; ++m) red[m * SW + warp * CPW + j] = acc[j][m];
  }
  __syncthreads();
}

// -- bf16 products on the tensor cores ----------------------------------------

__device__ __forceinline__ unsigned pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// The sums of one tile of a row-major (K, N) bf16 weight, as tile_sums
// computes them, on the tensor cores: out(row, n, sum) for rows m0 ..
// m0 + 8 and columns c0 .. c0 + 64, over depths [kb, ke). Warp w takes
// the 16-deep slabs w, w + 8, ... of the range; each slab (16 rows x 128
// contiguous bytes) streams into the warp's ring of kMmaStages slots
// (cp.async, 16-byte chunks XOR-swizzled by row, so that ldmatrix reads
// 8 rows without bank conflicts), then ldmatrix.trans gives the B
// fragments of 8 column tiles and mma.sync m16n8k16 multiplies them by
// the operand's 8 rows (the A fragment's rows 8-15 are zero), summing
// in fp32. The warps' sums reduce through shared memory. Needs N % 8 == 0
// and a 16-byte aligned weight.
template <class Out>
__device__ void mma_tile_sums(const ASrc<bf16>& A, int m0, int B, int K,
                              const bf16* __restrict__ W, int N, int c0,
                              int kb, int ke, bf16* As, unsigned char* ring,
                              float* red, int* staged, Out out) {
  constexpr int cap = a_cap<bf16>();
  constexpr int kNT = kMmaNW / 8;        // column tiles of 8
  constexpr int kChunks = kMmaNW / 8;    // 16-byte chunks a slab row
  constexpr int kRowBytes = kMmaNW * 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* slots = ring + warp * kMmaStages * kSlabBytes;
  const unsigned slots_s =
      static_cast<unsigned>(__cvta_generic_to_shared(slots));
  float acc[kNT][4];
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  for (int k0 = kb / cap * cap; k0 < ke; k0 += cap) {
    const int kc = min(cap, K - k0);
    ensure_a(A, m0, B, K, k0, kc, As, staged);
    const int lo = max(kb, k0);
    const int hi = min(ke, k0 + kc);
    const int nslab = (hi - lo + 15) / 16;
    const int mine = warp < nslab ? (nslab - warp + kWarps - 1) / kWarps : 0;
    // slab j of this warp: depths lo + (warp + j * 8) * 16 ..
    auto fill = [&](int j) {
      const int d0 = lo + (warp + j * kWarps) * 16;
      unsigned char* dst = slots + (j % kMmaStages) * kSlabBytes;
#pragma unroll
      for (int q = 0; q < 16 * kChunks / 32; ++q) {
        const int piece = lane + 32 * q;       // 16 rows x kChunks chunks
        const int r = piece / kChunks;
        const int ch = piece % kChunks;
        const int col = c0 + ch * 8;
        const int k = d0 + r;
        const bool ok = k < hi && col < N;
        const bf16* src = ok ? W + (long)k * N + col : W;
        cp_async16(dst + r * kRowBytes + ((ch ^ (r & 7)) << 4), src,
                   ok ? (col + 8 <= N ? 16 : (N - col) * 2) : 0);
      }
    };
#pragma unroll
    for (int j = 0; j < kMmaStages - 1; ++j) {
      if (j < mine) fill(j);
      cp_async_commit();
    }
    for (int j = 0; j < mine; ++j) {
      if (j + kMmaStages - 1 < mine) fill(j + kMmaStages - 1);
      cp_async_commit();
      cp_async_wait<kMmaStages - 1>();
      __syncwarp();                      // every lane's chunks have landed
      const int d0 = lo + (warp + j * kWarps) * 16;
      // A: row lane / 4, depths d0 + (lane % 4) * 2 (+1) and + 8 (+9);
      // zero past hi
      const int r = lane >> 2;
      const int kq = (lane & 3) * 2;
      unsigned a0 = 0u, a2 = 0u;
      {
        const int k = d0 + kq;
        const bf16 z = __float2bfloat16(0.f);
        const bf16* col = As + r;
        a0 = pack_bf16(k < hi ? col[(k - k0) * kMT] : z,
                       k + 1 < hi ? col[(k + 1 - k0) * kMT] : z);
        a2 = pack_bf16(k + 8 < hi ? col[(k + 8 - k0) * kMT] : z,
                       k + 9 < hi ? col[(k + 9 - k0) * kMT] : z);
      }
      const unsigned base = slots_s + (j % kMmaStages) * kSlabBytes;
#pragma unroll
      for (int q = 0; q < kNT / 2; ++q) {
        // matrices: (depth 0-7, tile 2q), (8-15, 2q), (0-7, 2q+1),
        // (8-15, 2q+1); lane gives row (lane % 8) of matrix lane / 8
        const int mi = lane >> 3;
        const int row = (mi & 1) * 8 + (lane & 7);
        const int ch = 2 * q + (mi >> 1);
        const unsigned addr =
            base + row * kRowBytes + ((ch ^ (row & 7)) << 4);
        unsigned b0, b1, b2, b3;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
            "[%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(addr));
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[2 * q][0]), "+f"(acc[2 * q][1]),
              "+f"(acc[2 * q][2]), "+f"(acc[2 * q][3])
            : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[2 * q + 1][0]), "+f"(acc[2 * q + 1][1]),
              "+f"(acc[2 * q + 1][2]), "+f"(acc[2 * q + 1][3])
            : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b2), "r"(b3));
      }
      __syncwarp();                      // the slot is read before refill
    }
    cp_async_wait<0>();
  }
  // red[(warp * 8 + row) * 64 + col]: rows lane / 4, columns
  // t * 8 + (lane % 4) * 2 (+1) of each column tile t (acc 0, 1)
  __syncthreads();                       // red is free
#pragma unroll
  for (int t = 0; t < kNT; ++t) {
    const int row = lane >> 2;
    const int col = t * 8 + (lane & 3) * 2;
    red[(warp * kMT + row) * kMmaNW + col] = acc[t][0];
    red[(warp * kMT + row) * kMmaNW + col + 1] = acc[t][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kMT * kMmaNW; i += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w * kMT * kMmaNW + i];
    const int row = m0 + i / kMmaNW;
    const int n = c0 + i % kMmaNW;
    if (row < B && n < N) out(row, n, sum);
  }
  __syncthreads();
}

// Depth splits of a row-major product over tiles_n column tiles and
// tiles_m row tiles: enough (tile, split) units for every resident
// block, each split at least kMinSplitDepth deep
__device__ __host__ inline int split_count(int K, int tiles, int grid) {
  int sp = tiles >= grid ? 1 : grid / tiles;
  const int most = K / kMinSplitDepth > 1 ? K / kMinSplitDepth : 1;
  return sp < most ? sp : most;
}

// out = A @ W over the grid; epi(row, n, sum) once for each output. With
// one split, each tile's block applies epi; with more, the splits'
// partial sums go to ws (splits x B x N fp32), and after a grid barrier
// every thread of the grid adds them in a fixed order for its outputs.
template <typename T, class Epi>
__device__ void gemm_phase(cg::grid_group& grid, const ASrc<T>& A, int B,
                           int K, const T* __restrict__ W, int N, bool vec,
                           T* As, uint4* ring, float* red, float* ws,
                           Epi epi) {
  // bf16 with 16-byte aligned rows: the tensor cores; else CUDA cores
  const bool mma = sizeof(T) == 2 && vec && N % 8 == 0;
  const int nw = mma ? kMmaNW : kNW;
  const int tiles_n = (N + nw - 1) / nw;
  const int tiles = tiles_n * ((B + kMT - 1) / kMT);
  const int splits = split_count(K, tiles, gridDim.x);
  const int depth = (K + splits - 1) / splits;
  int staged = -1;
  for (int u = blockIdx.x; u < tiles * splits; u += gridDim.x) {
    const int c0 = (u % tiles_n) * nw;
    const int sp = (u / tiles_n) % splits;
    const int m0 = u / (tiles_n * splits) * kMT;
    const int kb = sp * depth;
    const int ke = min(K, kb + depth);
    auto to_ws = [&](int row, int n, float s) {
      ws[((long)sp * B + row) * N + n] = s;
    };
    if constexpr (sizeof(T) == 2) {
      if (mma) {
        if (splits == 1) {
          mma_tile_sums(A, m0, B, K, W, N, c0, kb, ke, As,
                        reinterpret_cast<unsigned char*>(ring), red,
                        &staged, epi);
        } else {
          mma_tile_sums(A, m0, B, K, W, N, c0, kb, ke, As,
                        reinterpret_cast<unsigned char*>(ring), red,
                        &staged, to_ws);
        }
        continue;
      }
    }
    if (splits == 1) {
      tile_sums(A, m0, B, K, W, N, c0, kb, ke, vec, As, ring, red, &staged,
                epi);
    } else {
      tile_sums(A, m0, B, K, W, N, c0, kb, ke, vec, As, ring, red, &staged,
                to_ws);
    }
  }
  if (splits == 1) return;
  grid.sync();
  const long total = (long)B * N;
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += __ldcg(ws + sp * total + i);
    epi(static_cast<int>(i / N), static_cast<int>(i % N), s);
  }
}

// fp32 elements of the split partial sums the four products of one
// layer need at most (counted at kNW-wide tiles: the tensor cores' narrower
// tiles are more, so they split no deeper)
__host__ inline long mega_ws_floats(int B, int dm, int nq, int no, int F,
                                    int grid) {
  const int tm = (B + kMT - 1) / kMT;
  const int prods[4][2] = {{dm, nq}, {no, dm}, {dm, F}, {F, dm}};
  long most = 0;
  for (const auto& kn : prods) {
    const int tiles = (kn[1] + kNW - 1) / kNW * tm;
    const long sp = split_count(kn[0], tiles, grid);
    if (sp > 1 && sp * B * kn[1] > most) most = sp * B * kn[1];
  }
  return most;
}

// -- K8 -----------------------------------------------------------------------

struct MegaParams {
  // (L, ...) slabs in _WEIGHT_ORDER; the LayerNorm vectors fp32, the
  // rest in T; a null bias is absent
  const float* ln1_s;
  const float* ln1_b;
  const void* wqkv;
  const void* bqkv;
  const void* wo;
  const void* bo;
  const float* ln2_s;
  const float* ln2_b;
  const void* wup;
  const void* bup;
  const void* wdown;
  const void* bdown;
  const void* x;        // (B, dm)
  void* xo;             // (B, dm): the residual stream, then the result
  void* kp;             // (L * P + 1, Hkv, page, D)
  void* vp;
  const int* table;     // (S, mx), unfolded page ids
  const int* pos;       // (B,)
  const int* slot;      // (B,)
  const int* write;     // (B,)
  void* qkv;            // scratch (B, (Hq + 2 Hkv) D)
  void* o;              // scratch (B, Hq D)
  void* u;              // scratch (B, F)
  float* ws;            // split partial sums: mega_ws_floats(...) fp32
  int B, dm, L, hq, hkv, D, F, page, P, mx, rope;
  float theta, scale;
  int vec;              // every row of every operand starts 16-byte aligned
};

// rope of element e of one head (D values at t, rotate-half) at pos, fp32
template <typename T>
__device__ __forceinline__ float rope_elem(const T* t, int e, int half,
                                           float pos, float theta) {
  const int i = e < half ? e : e - half;
  const float freq = powf(theta, -static_cast<float>(i) / half);
  const float ang = pos * freq;
  const float c = cosf(ang);
  const float s = sinf(ang);
  if (e < half) return ldcg_f(t + e) * c - ldcg_f(t + e + half) * s;
  return ldcg_f(t + e - half) * s + ldcg_f(t + e) * c;
}

template <typename T>
__device__ __forceinline__ float head_elem(const MegaParams& p, const T* t,
                                           int e, int pos) {
  if (p.rope)
    return pt::round_to<T>(
        rope_elem(t, e, p.D / 2, static_cast<float>(pos), p.theta));
  return ldcg_f(t + e);
}

// phase 2: rope on k, then every row's fresh K/V row into its page
template <typename T>
__device__ void write_phase(const MegaParams& p, int l) {
  const int D = p.D;
  const int nq = (p.hq + 2 * p.hkv) * D;
  const T* qkv = static_cast<const T*>(p.qkv);
  T* kp = static_cast<T*>(p.kp);
  T* vp = static_cast<T*>(p.vp);
  const long total = (long)p.B * p.hkv * D;
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long)gridDim.x * kThreads) {
    const int r = static_cast<int>(i / (p.hkv * D));
    const int rem = static_cast<int>(i % (p.hkv * D));
    const int h = rem / D;
    const int e = rem % D;
    const int pos = p.pos[r];
    const int pid =
        p.table[(long)p.slot[r] * p.mx + min(pos / p.page, p.mx - 1)];
    const long g = p.write[r] == 1 ? (long)l * p.P + pid : (long)p.L * p.P;
    const long dst = ((g * p.hkv + h) * p.page + pos % p.page) * D + e;
    const T* row = qkv + (long)r * nq;
    kp[dst] = pt::from_float<T>(head_elem(p, row + (p.hq + h) * D, e, pos));
    vp[dst] = pt::from_float<T>(ldcg_f(row + (p.hq + p.hkv + h) * D + e));
  }
}

// phase 3 for one (row, kv head): K10's in-block online softmax over the
// row's valid keys, gathered through its slot's pages of layer l
template <typename T, int G>
__device__ void attend_unit(const MegaParams& p, int l, int r, int hk,
                            float* smem) {
  constexpr int V = 16 / sizeof(T);      // elements per lane
  constexpr int kLpr = kDMax / V;        // lanes per key row: 16 or 32
  constexpr int kRpw = 32 / kLpr;        // key rows per warp load
  constexpr int kU = G >= 8 ? 1 : (G >= 4 ? 2 : 4);
  constexpr int kStep = kWarps * kRpw * kU;
  float* sm_m = smem;                          // [kWarps][G]
  float* sm_l = smem + kWarps * G;             // [kWarps][G]
  float* sm_acc = smem + 2 * kWarps * G;       // [kWarps][G][kDMax]

  const int D = p.D;
  const int group = p.hq / p.hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = lane / kLpr;
  const int e0 = (lane % kLpr) * V;
  const int pos = p.pos[r];
  const int slot = p.slot[r];
  const int len = max(0, min(pos + 1, p.mx * p.page));
  const T* kp = static_cast<const T*>(p.kp);
  const T* vp = static_cast<const T*>(p.vp);
  const T* qrow = static_cast<const T*>(p.qkv) +
                  (long)r * (p.hq + 2 * p.hkv) * D;

  float qf[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < V; ++e)
      qf[g][e] = (g < group && e0 + e < D)
                     ? head_elem(p, qrow + (hk * group + g) * D, e0 + e, pos)
                     : 0.f;

  float m[G], lsum[G], acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    lsum[g] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  }

  const int* trow = p.table + (long)slot * p.mx;
  for (int t0 = 0; t0 < len; t0 += kStep) {
    float kf[kU][V], vf[kU][V];
    int tk[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      tk[u] = t0 + (u * kWarps + warp) * kRpw + rg;
      if (tk[u] < len) {
        const long g = (long)l * p.P + trow[tk[u] / p.page];
        const long off = ((g * p.hkv + hk) * p.page + tk[u] % p.page) * D;
        load_vec(kp + off + e0, e0, D, p.vec, kf[u]);
        load_vec(vp + off + e0, e0, D, p.vec, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[kU];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) d += qf[g][e] * kf[u][e];
#pragma unroll
        for (int off = kLpr / 2; off >= 1; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u] = tk[u] < len ? d * p.scale : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      if (kRpw > 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, kLpr));
      const float m_new = fmaxf(fmaxf(m[g], mx), pt::kMaxFloor);
      const float alpha = __expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float pr = __expf(s[u] - m_new);
        psum += pr;
        const float prr = pt::round_to<T>(pr);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] += prr * vf[u][e];
      }
      lsum[g] = lsum[g] * alpha + psum;
      m[g] = m_new;
    }
  }

  __syncthreads();                       // the previous unit's merge is read
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (kRpw > 1) {
      lsum[g] += __shfl_xor_sync(0xffffffffu, lsum[g], kLpr);
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], kLpr);
    }
    if (rg == 0) {
#pragma unroll
      for (int e = 0; e < V; ++e)
        sm_acc[(warp * G + g) * kDMax + e0 + e] = acc[g][e];
    }
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = lsum[g];
    }
  }
  __syncthreads();

  T* o = static_cast<T*>(p.o);
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * G + g]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w * G + g];
      const float wt = mw == -INFINITY ? 0.f : __expf(mw - mm);
      ll += sm_l[w * G + g] * wt;
      a += sm_acc[(w * G + g) * kDMax + d] * wt;
    }
    o[((long)r * p.hq + hk * group + g) * D + d] =
        pt::from_float<T>(a / (ll == 0.f ? 1.f : ll));
  }
}

template <typename T>
__device__ void attention_phase(const MegaParams& p, int l, float* smem) {
  const int group = p.hq / p.hkv;
  for (int u = blockIdx.x; u < p.B * p.hkv; u += gridDim.x) {
    const int r = u / p.hkv;
    const int hk = u % p.hkv;
    if (group <= 1) {
      attend_unit<T, 1>(p, l, r, hk, smem);
    } else if (group <= 2) {
      attend_unit<T, 2>(p, l, r, hk, smem);
    } else if (group <= 4) {
      attend_unit<T, 4>(p, l, r, hk, smem);
    } else {
      attend_unit<T, 8>(p, l, r, hk, smem);
    }
  }
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;     // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  return 0.5f * x * (1.f + tanhf(kBeta * (x + kKappa * x * x * x)));
}

// the product's output rounded to T, then its bias added and rounded
template <typename T>
__device__ __forceinline__ float with_bias(float s, const T* bias, int n) {
  float v = pt::round_to<T>(s);
  if (bias != nullptr) v = pt::round_to<T>(v + pt::to_float(bias[n]));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mega_kernel(MegaParams p) {
  extern __shared__ __align__(16) unsigned char dsm[];
  T* As = reinterpret_cast<T*>(dsm);
  uint4* ring = reinterpret_cast<uint4*>(dsm + kACapBytes);
  float* red = reinterpret_cast<float*>(dsm + kACapBytes + kRingBytes);
  float* smem = reinterpret_cast<float*>(dsm);      // attention, as As
  float* ws = p.ws;
  cg::grid_group grid = cg::this_grid();

  const int B = p.B, dm = p.dm, D = p.D, F = p.F;
  const int nq = (p.hq + 2 * p.hkv) * D;
  const int no = p.hq * D;
  const bool vec = p.vec != 0;
  T* xo = static_cast<T*>(p.xo);
  T* qkv = static_cast<T*>(p.qkv);
  T* ob = static_cast<T*>(p.o);
  T* ub = static_cast<T*>(p.u);

  for (int l = 0; l < p.L; ++l) {
    // the residual stream: the input rows at layer 0, then x_out
    const T* xin = l == 0 ? static_cast<const T*>(p.x) : xo;
    const T* wqkv = static_cast<const T*>(p.wqkv) + (long)l * dm * nq;
    const T* bqkv = p.bqkv ? static_cast<const T*>(p.bqkv) + (long)l * nq
                           : nullptr;
    const T* wo = static_cast<const T*>(p.wo) + (long)l * no * dm;
    const T* bo = p.bo ? static_cast<const T*>(p.bo) + (long)l * dm : nullptr;
    const T* wup = static_cast<const T*>(p.wup) + (long)l * dm * F;
    const T* bup = p.bup ? static_cast<const T*>(p.bup) + (long)l * F
                         : nullptr;
    const T* wdown = static_cast<const T*>(p.wdown) + (long)l * F * dm;
    const T* bdown = p.bdown ? static_cast<const T*>(p.bdown) + (long)l * dm
                             : nullptr;

    // 1. LN1 + QKV (+ bias) -> qkv
    const ASrc<T> a1{xin, p.ln1_s + (long)l * dm, p.ln1_b + (long)l * dm};
    gemm_phase(grid, a1, B, dm, wqkv, nq, vec, As, ring, red, ws,
               [&](int row, int n, float s) {
                 qkv[(long)row * nq + n] =
                     pt::from_float<T>(with_bias(s, bqkv, n));
               });
    grid.sync();
    // 2. rope on k; every row's fresh K/V row written before any attends
    write_phase<T>(p, l);
    grid.sync();
    // 3. attention -> o
    attention_phase<T>(p, l, smem);
    grid.sync();
    // 4. out-projection (+ bias) + residual -> x_out
    const ASrc<T> a2{ob, nullptr, nullptr};
    gemm_phase(grid, a2, B, no, wo, dm, vec, As, ring, red, ws,
               [&](int row, int n, float s) {
      const long i = (long)row * dm + n;
      xo[i] = pt::from_float<T>(ldcg_f(xin + i) + with_bias(s, bo, n));
    });
    grid.sync();
    // 5. LN2 + up-projection (+ bias) + GELU -> u
    const ASrc<T> a3{xo, p.ln2_s + (long)l * dm, p.ln2_b + (long)l * dm};
    gemm_phase(grid, a3, B, dm, wup, F, vec, As, ring, red, ws,
               [&](int row, int n, float s) {
      ub[(long)row * F + n] =
          pt::from_float<T>(gelu_tanh(with_bias(s, bup, n)));
    });
    grid.sync();
    // 6. down-projection (+ bias) + residual -> x_out
    const ASrc<T> a4{ub, nullptr, nullptr};
    gemm_phase(grid, a4, B, F, wdown, dm, vec, As, ring, red, ws,
               [&](int row, int n, float s) {
      const long i = (long)row * dm + n;
      xo[i] = pt::from_float<T>(ldcg_f(xo + i) + with_bias(s, bdown, n));
    });
    if (l + 1 < p.L) grid.sync();
  }
}

// every block that can be resident (the grid barriers need all of
// them), or a negative CUDA error
template <typename T>
int mega_grid() {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -static_cast<int>(cudaErrorNotSupported);
  err = cudaFuncSetAttribute(mega_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mega_kernel<T>, kThreads, kSmemBytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return per_sm * sms;
}

template <typename T>
int launch_mega(MegaParams& p, long ws_floats, cudaStream_t st) {
  const int g = mega_grid<T>();
  if (g < 0) return -g;
  if (mega_ws_floats(p.B, p.dm, (p.hq + 2 * p.hkv) * p.D, p.hq * p.D, p.F,
                     g) > ws_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(mega_kernel<T>), dim3(g), dim3(kThreads), args,
      kSmemBytes, st));
}

// -- K9 -----------------------------------------------------------------------

struct LogitsParams {
  const void* x;          // (B, dm)
  const float* ln_s;      // (dm,)
  const float* ln_b;
  const void* w;          // (dm, V) row-major, or (V, dm) when kmajor
  const int* poison;      // (B,) or null
  unsigned long long* ws; // keys (B), flags (B), counter: zero between calls
  int* tok;               // (B,)
  int* nonfin;            // (B,)
  int B, dm, V;
  int vec;
};

// order-preserving 32-bit image of a non-NaN float
__device__ __forceinline__ unsigned int ordered(float v) {
  const unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <typename T, bool kKMajor>
__global__ void __launch_bounds__(kThreads) logits_kernel(LogitsParams p) {
  constexpr int SW = kLogitsStrip;
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ unsigned long long best[kMaxRows];
  __shared__ int flag[kMaxRows];
  __shared__ bool last;
  T* As = reinterpret_cast<T*>(dsm);
  uint4* ring = reinterpret_cast<uint4*>(dsm + kACapBytes);
  float* red = reinterpret_cast<float*>(dsm + kACapBytes + kRingBytes);
  int staged = -1;
  const int B = p.B;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);

  for (int r = threadIdx.x; r < B; r += kThreads) {
    best[r] = 0ull;
    flag[r] = 0;
  }
  __syncthreads();
  const ASrc<T> a{x, p.ln_s, p.ln_b};
  // the tied head: strips of 32 columns, sums in red[m * 32 + c]; the
  // row-major head: tiles of kNW columns, sums gathered into the ring's
  // memory (free between tiles) as lg[m * kNW + c]
  constexpr int W_COLS = kKMajor ? SW : kNW;
  float* lg = kKMajor ? red : reinterpret_cast<float*>(ring);
  const int strips = (p.V + W_COLS - 1) / W_COLS;
  const int units = strips * ((B + kMT - 1) / kMT);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int m0 = (u / strips) * kMT;
    const int n0 = (u % strips) * W_COLS;
    if (kKMajor) {
      strip_kmajor<T>(a, m0, B, p.dm, w, p.V, n0, p.vec != 0, As, red,
                      &staged);
    } else {
      tile_sums(a, m0, B, p.dm, w, p.V, n0, 0, p.dm, p.vec != 0, As, ring,
                red, &staged, [&](int row, int n, float sum) {
                  lg[(row - m0) * kNW + n - n0] = sum;
                });
      __syncthreads();
    }
    // warp m reduces row m0 + m over the unit's columns, a lane at a time
    const int row = m0 + warp;
    if (row < B) {
      const bool poisoned = p.poison != nullptr && p.poison[row] != 0;
      unsigned long long key = 0ull;
      bool bad = false;
      for (int c = lane; c < W_COLS; c += 32) {
        const int n = n0 + c;
        if (n >= p.V) break;
        float v = pt::round_to<T>(lg[warp * W_COLS + c]);
        if (poisoned) v = __int_as_float(0x7fc00000);
        bad = bad || !isfinite(v);
        if (!isnan(v)) {
          const unsigned long long k =
              ((unsigned long long)ordered(v) << 32) |
              (0xFFFFFFFFu - static_cast<unsigned int>(n));
          key = k > key ? k : key;
        }
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
        key = o > key ? o : key;
      }
      const bool any_bad = __any_sync(0xffffffffu, bad);
      if (lane == 0) {
        if (key > best[row]) best[row] = key;
        if (any_bad) flag[row] = 1;
      }
    }
    __syncthreads();                     // lg is read before the next unit
  }
  __syncthreads();
  unsigned long long* keys = p.ws;
  unsigned long long* flags = p.ws + B;
  unsigned long long* counter = p.ws + 2 * B;
  for (int r = threadIdx.x; r < B; r += kThreads) {
    if (best[r] != 0ull) atomicMax(keys + r, best[r]);
    if (flag[r]) atomicOr(flags + r, 1ull);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1ull) == (unsigned long long)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: every other block's atomics are done
  for (int r = threadIdx.x; r < B; r += kThreads) {
    const unsigned long long key = atomicExch(keys + r, 0ull);
    const unsigned long long f = atomicExch(flags + r, 0ull);
    p.tok[r] = key != 0ull ? static_cast<int>(
                                 0xFFFFFFFFu -
                                 static_cast<unsigned int>(key & 0xFFFFFFFFull))
                           : 0;
    p.nonfin[r] = f != 0ull ? 1 : 0;
  }
  if (threadIdx.x == 0) atomicExch(counter, 0ull);
}

template <typename T>
int launch_logits(LogitsParams& p, bool kmajor, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long units = (long)((p.V + kLogitsStrip - 1) / kLogitsStrip) *
                     ((p.B + kMT - 1) / kMT);
  const long cap = sms > 0 ? sms : 1;     // one resident block per SM
  const dim3 grid(static_cast<unsigned int>(units < cap ? units : cap));
  auto kern = kmajor ? logits_kernel<T, true> : logits_kernel<T, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kThreads, kSmemBytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8. w: the 12 slab pointers in _WEIGHT_ORDER (a null bias is absent).
// The caller guarantees B <= 64, dm <= a_cap<T>() (8192 bf16, 4096
// fp32: a LayerNorm'd row resident whole), D <= 128 and even,
// Hq % Hkv == 0,
// Hq / Hkv <= 8, page a multiple of 128, every tensor contiguous and of
// the one dtype (the LayerNorm vectors fp32). Returns the launch's error:
// a refused cooperative launch never runs.
extern "C" int pt_mega_decode(int dtype, const void* const* w, const void* x,
                              void* xo, void* kp, void* vp, const void* table,
                              const void* pos, const void* slot,
                              const void* write, void* qkv, void* o, void* u,
                              void* ws, long ws_floats,
                              int B, int dm, int L, int hq, int hkv, int D,
                              int F, int page, int P, int mx, int rope,
                              float theta, float scale, int vec,
                              void* stream) {
  MegaParams p;
  p.ln1_s = static_cast<const float*>(w[0]);
  p.ln1_b = static_cast<const float*>(w[1]);
  p.wqkv = w[2];
  p.bqkv = w[3];
  p.wo = w[4];
  p.bo = w[5];
  p.ln2_s = static_cast<const float*>(w[6]);
  p.ln2_b = static_cast<const float*>(w[7]);
  p.wup = w[8];
  p.bup = w[9];
  p.wdown = w[10];
  p.bdown = w[11];
  p.x = x;
  p.xo = xo;
  p.kp = kp;
  p.vp = vp;
  p.table = static_cast<const int*>(table);
  p.pos = static_cast<const int*>(pos);
  p.slot = static_cast<const int*>(slot);
  p.write = static_cast<const int*>(write);
  p.qkv = qkv;
  p.o = o;
  p.u = u;
  p.ws = static_cast<float*>(ws);
  p.B = B;
  p.dm = dm;
  p.L = L;
  p.hq = hq;
  p.hkv = hkv;
  p.D = D;
  p.F = F;
  p.page = page;
  p.P = P;
  p.mx = mx;
  p.rope = rope;
  p.theta = theta;
  p.scale = scale;
  p.vec = vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kBFloat16) return launch_mega<bf16>(p, ws_floats, st);
  if (dtype == pt::kFloat32) return launch_mega<float>(p, ws_floats, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// fp32 elements of the workspace pt_mega_decode needs for these
// operands on the current device (the depth splits' partial sums), or a
// negative CUDA error
extern "C" long pt_mega_workspace(int dtype, int B, int dm, int nq, int no,
                                  int F) {
  const int g = dtype == pt::kBFloat16 ? mega_grid<bf16>()
                                       : mega_grid<float>();
  if (g < 0) return g;
  return mega_ws_floats(B, dm, nq, no, F, g);
}

// K9. The caller guarantees B <= 64 and dm <= a_cap<T>() (as K8).
// ws: 2 B + 1 zeroed 64-bit words, left zeroed by the launch. kmajor:
// w is (V, dm) contiguous along dm (the tied head), else (dm, V)
// row-major. poison may be null.
extern "C" int pt_mega_logits(int dtype, const void* x, const void* ln_s,
                              const void* ln_b, const void* w,
                              const void* poison, void* ws, void* tok,
                              void* nonfin, int B, int dm, int V, int kmajor,
                              int vec, void* stream) {
  LogitsParams p;
  p.x = x;
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.w = w;
  p.poison = static_cast<const int*>(poison);
  p.ws = static_cast<unsigned long long*>(ws);
  p.tok = static_cast<int*>(tok);
  p.nonfin = static_cast<int*>(nonfin);
  p.B = B;
  p.dm = dm;
  p.V = V;
  p.vec = vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kBFloat16) return launch_logits<bf16>(p, kmajor != 0, st);
  if (dtype == pt::kFloat32) return launch_logits<float>(p, kmajor != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

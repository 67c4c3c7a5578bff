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
// that can be resident (one a SM, worked out in `mega_grid`), launched
// with cudaLaunchCooperativeKernel, so the grid barriers between phases
// (`grid_sync`, cooperative groups' algorithm on a workspace word) are
// sound. A block is three warpgroups: two consumers (threads 0-255) run
// every phase; the third streams weights (one thread issues TMA loads)
// and gives its registers to the consumers (setmaxnreg). Per layer, five
// phases, each ending at a grid barrier (the parent design took up to 10:
// a separate rope-and-write phase, and a barrier and pass for every
// split product's partial sums):
//
//   1. LN1 + QKV, then rope on k and every row's fresh K/V row written
//      into the pools, in the product's epilogue: the QKV product's
//      column tiles hold whole heads (128 columns where D divides 128,
//      else one head), so rope's partner column is in the tile. q|k|v
//      (+ bias) also go to a scratch, which attention reads q from.
//   2. Attention, one block per (row, kv head) at a time, over the row's
//      valid keys only, gathered page by page through the table: 8
//      warps, each with its own online softmax over every 8th group of
//      keys, merged through shared memory; a lane keeps up to 8 key rows'
//      raw words in flight a step; q read from the scratch with rope
//      applied on load. Output o in a scratch.
//   3. Out-projection + bias + residual into x_out.
//   4. LN2 + up-projection + bias + GELU into the (B, F) scratch.
//   5. Down-projection + bias + residual into x_out.
//
// The products (`product_phase`) share one scheme: units of (128 output
// columns, a depth range, 8 rows). Where the column tiles are fewer than
// the blocks, the depth splits over blocks (`make_plan`); each split's
// sums go to an fp32 workspace, and the last split of a tile to finish
// (a counter per tile) adds them in split order and applies the
// epilogue, so no split product takes a barrier of its own. A unit's 8
// rows of the operand are staged into shared memory from L2 (LN1 and
// LN2 normalised on the way in, statistics per block). In bf16 with
// aligned rows the weight is streamed by TMA: the streaming thread walks
// every unit this block takes, phase after phase and layer after layer,
// in the consumers' order, and keeps a ring of kRingStages 64-deep x
// 128-column tiles (two 64 x 64 boxes, 128-byte swizzle) in flight, so
// the next phase's first tiles land while the consumers attend or wait
// at a barrier; the consumers multiply each tile by the staged rows on
// the tensor cores, the swapped product: wgmma m64n8k16 with the weight
// tile as the MN-major A operand (64 output columns a warpgroup) and the
// 8 rows as the K-major B operand, each weight read once per 8 rows. In
// fp32 (and bf16 rows that are not 16-byte aligned) the same units run
// on the CUDA cores (`unit_sums_cc`: a cp.async ring per thread).
//
// Each output is finished by one thread, which reads x at that entry
// only, so x_out's in-place updates are race-free. Phase 1 of layer l+1
// reads every column of x_out, which phase 5 of layer l wrote in all
// blocks: hence the barrier after 5. Reads of data written inside the
// launch (x_out, the scratches, the workspace, the pools) go through L2
// (`__ldcg`), never the non-coherent read-only path; weights through
// TMA, `__ldg` or cp.async. The phase-time record (`stamps`): block 0
// stamps %globaltimer at each barrier, when the caller passes a buffer.
//
// K9 design (bf16, `logits_kernel_sm90`). A persistent launch, one
// block per SM, each taking a contiguous range of 64-column vocabulary
// tiles (786 at V 50,304: 5 or 6 a block on 132 SMs), so no last partial
// wave of strips leaves blocks idle. Per group of rows (as many as fit
// in shared memory beside the head ring: 32 at d_model 2048, 128 KB;
// ops/decode_megakernel.py `logits_plan`) the consumer warpgroup
// LayerNorms the rows once into shared memory as wgmma's K-major B
// operand (N = 8, 16, 32 or 64 columns), so the head is read once per
// group: once at the engine's B 8, where the first port read it again
// for every 8 rows. A producer warp streams the range's head boxes (64
// columns x 64 deep, 8 KB, 128-byte swizzle) by TMA through a ring of 8
// to 16 slots that runs on across tiles and groups, never drained: the
// tied (V, dm) head's boxes are the K-major A operand, a row-major
// (dm, V) head's the MN-major one. The consumers run wgmma m64nNk16 with
// the head box as A, 64 vocabulary columns x N rows, the sums in
// registers; a tile's logits are rounded to bf16 there, poisoned rows
// are NaN, the flag covers the true vocabulary, and each row's key
// (order-preserving value bits << 32 | ~index: the largest value wins,
// and among equal values the lowest index, jnp.argmax's first max; NaN
// never enters) is kept per thread, reduced over the lanes by shuffles
// and over the warps by shared atomics. Blocks merge with one 64-bit
// atomicMax per row; the last block to finish (a counter) writes the
// tokens and flags and zeroes the workspace for the next launch. The
// (B, V) logits never reach global memory.
//
// K9's other route (`logits_kernel`, fp32 heads, and bf16 ones whose
// rows are not whole 16-byte pieces; chosen by `logits_route` before
// the launch): each block keeps 8 rows resident after the final LN
// (`ensure_a`) and takes units of vocabulary columns x 8 rows on the
// CUDA cores, 32 columns of the tied head (`strip_kmajor`) or 256 of a
// row-major one (`tile_sums`), with the same keys, flags and merge.
//
// Bound on the H100: bytes. K8 does 2 B FLOP per weight element it
// reads, far below the ridge (about 295 FLOP per byte), so its floor is
// reading every layer's weights once, plus the valid K/V rows each row
// attends to, plus the fresh rows written, at 3.35 TB/s; K9's the head
// (V x dm) once: 0.21 GB, 61.5 us for gpt3_1p3b. K9 on the tensor cores
// reads it in 81 us (2.5 TB/s) at B 8 (PERF.md §6); what holds the rest
// is not measured apart (the LayerNorm staging before the first product,
// the ring's 128 KB in flight a block, the last block's merge). What
// keeps K8 above its bound (its phase-time record on an
// H100 80GB HBM3 at 700 W, PERF.md §6): not the weight stream, whose
// mainloops take a fifth to a third of each product phase, but each
// phase's latency-bound fixed part: the LayerNorm statistics and the
// staging of the rows, a split's fixup and the epilogue, and
// attention's per-row chain of dependent loads, with one block per
// (row, kv head) (a 256-key row's unit sets the phase's length).
#include <cstdint>
#include <cstring>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMT = 8;                  // rows of x per unit (== kWarps)
constexpr int kMaxRows = 64;
constexpr int kDMax = 128;              // largest head_dim
constexpr int kGMax = 8;                // largest GQA group
constexpr int kLogitsStrip = 32;        // K9, tied head: vocab columns a unit
constexpr int kNW = 256;                // K9, row-major head: columns a tile
// K9's operand resident in shared memory: kMT rows x up to kACapBytes /
// (kMT sizeof(T)) depth (8192 bf16, 4096 fp32: a LayerNorm'd row whole)
constexpr int kACapBytes = 128 * 1024;
// the CUDA-core weight streams' rings: kStages 16-byte pieces a thread
constexpr int kStages = 8;
constexpr int kK9Ring = kStages * kThreads * 16;
// K9's cross-thread reduction, half its 8 rows at a time (bf16: 8 depth
// lanes x 4 rows x kNW columns)
constexpr int kRedFloats = 8 * 4 * kNW;
constexpr int kAttnFloats = kWarps * kGMax * kDMax + 2 * kWarps * kGMax;
constexpr int kSmemBytes = kACapBytes + kK9Ring + kRedFloats * 4;

static_assert(kMT == kWarps, "a warp per row (LayerNorm, K9's reduction)");

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

// V = 16 / sizeof(T) elements at p, written inside the launch, as a raw
// 16-byte word in T through L2, zero where n + e >= n_end; one 16-byte
// load when vec (p 16-byte aligned and n + V <= n_end)
template <typename T>
__device__ __forceinline__ uint4 load_word(const T* p, int n, int n_end,
                                           bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec && n + V <= n_end) return __ldcg(reinterpret_cast<const uint4*>(p));
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  T* el = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (n + e < n_end) el[e] = pt::from_float<T>(ldcg_f(p + e));
  return raw;
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

// -- K8 -----------------------------------------------------------------------

constexpr int kCThreads = kThreads;      // consumers: 8 warps, 2 warpgroups
// + the weight stream's warpgroup, last, so that the consumers keep
// threads 0 .. 255: one of its threads issues the TMA loads, and it
// gives its registers to the consumers (setmaxnreg: 40 a thread, the
// consumers 232), which otherwise spill at the 168 a thread that ptxas
// budgets for 384 threads
constexpr int kMegaThreads = kCThreads + 128;
constexpr int kUnitN = 128;              // output columns a unit
constexpr int kUnitK = 64;               // a weight stage's depth
constexpr int kRingStages = 10;
constexpr uint32_t kWStage = kUnitK * kUnitN * 2;   // two 64 x 64 bf16 boxes
// the unit's rows of the operand (8 rows x 2048 bf16 or 1024 fp32), then
// the unit's sums [kMT][kUnitN] fp32, then the weight ring
constexpr int kActBytes = 32 * 1024;
constexpr int kTileOff = kActBytes;
constexpr int kRingOff = kTileOff + kMT * kUnitN * 4;
constexpr int kMegaSmem =
    kRingOff + kRingStages * kWStage + 2 * kRingStages * 8 + 1024;
// the CUDA-core units' reduction: RS depth lanes x 4 rows x kUnitN
constexpr int kUnitRedFloats = 16 * 4 * kUnitN;
static_assert(kRingOff % 1024 == 0, "the ring is 1024-byte aligned");
static_assert(kAttnFloats * 4 <= kRingOff,
              "attention runs below the ring, which streams on meanwhile");
static_assert(kStages * kCThreads * 16 + kUnitRedFloats * 4 <=
                  kRingStages * kWStage,
              "the CUDA-core units' ring and reduction fit the TMA ring");

// the four products of a layer, in the order a layer runs them
enum { kQkv = 0, kWo = 1, kUp = 2, kDown = 3 };
// phase codes of the phase-time record: a code names the phase that
// ended at the barrier it stamps (ops/decode_megakernel.py PHASES)
enum { kPhQkv = 0, kPhAttn = 1, kPhWo = 2, kPhUp = 3, kPhDown = 4 };

// A product's units: column tiles x depth splits x row tiles of kMT rows.
// Splits: enough units for every block, each split's depth a multiple of
// kUnitK and at most `cap` (the operand rows a unit stages)
struct Plan {
  int tiles, rt, splits, depth;
};

__host__ __device__ inline Plan make_plan(int K, int tiles, int B, int grid,
                                          int cap) {
  Plan q;
  q.tiles = tiles;
  q.rt = (B + kMT - 1) / kMT;
  const int stages = (K + kUnitK - 1) / kUnitK;
  int s = grid / (tiles * q.rt);
  const int least = (K + cap - 1) / cap;
  if (s < least) s = least;
  if (s > stages) s = stages;
  if (s < 1) s = 1;
  q.depth = (stages + s - 1) / s * kUnitK;
  q.splits = (K + q.depth - 1) / q.depth;
  return q;
}

// the depth a unit stages at most: kActBytes over kMT rows
template <typename T>
__host__ __device__ constexpr int unit_cap() {
  return kActBytes / (kMT * static_cast<int>(sizeof(T)));
}

struct MegaMaps {
  CUtensorMap w[4];     // wqkv, wo, wup, wdown as 3D (N, K, L), bf16
};

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
  unsigned* sync;       // the grid barrier's word, then the split counters
  float* ws;            // split partial sums
  long long* stamps;    // (time, phase code) pairs, or null
  int stamp_cap;        // long longs the stamps buffer holds
  int B, dm, L, hq, hkv, D, F, page, P, mx, rope;
  float theta, scale;
  int vec;              // every row of every operand starts 16-byte aligned
  int tma;              // bf16 weights streamed by TMA (maps valid)
  int grid;             // blocks of the launch
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

// the consumers' block barrier (the weight stream's warp never joins)
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCThreads) : "memory");
}

// The consumers' grid barrier (cooperative groups' algorithm): thread 0
// of each block adds 1 (block 0: 2^31 - (blocks - 1)) to the word, whose
// top bit flips once every block has arrived. Sound only when every
// block is resident: the cooperative launch guarantees it.
__device__ void grid_sync(unsigned* word, int blocks) {
  csync();
  if (threadIdx.x == 0) {
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - static_cast<unsigned>(blocks - 1)
                        : 1u;
    __threadfence();
    const unsigned old = atomicAdd(word, add);
    unsigned now;
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                   : "=r"(now)
                   : "l"(word)
                   : "memory");
    } while (((old ^ now) & 0x80000000u) == 0u);
    __threadfence();
  }
  csync();
}

// The phase-time record: block 0's thread 0 writes (%globaltimer ns,
// code) after each grid barrier, code = 16 layer + kPh*, -1 at the
// kernel's start; nothing when the buffer is null
struct Stamps {
  long long* buf;
  int cap, n;
  __device__ void mark(int code) {
    if (buf != nullptr && blockIdx.x == 0 && threadIdx.x == 0 &&
        2 * n + 1 < cap) {
      long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      buf[2 * n] = t;
      buf[2 * n + 1] = code;
    }
    ++n;
  }
};

// A block's first attention unit's row, the same in every layer: its
// position, key count and slot's page ids, read once at the kernel's
// start, so a layer's attention waits on no load before q and K/V
constexpr int kRowPages = 64;            // page ids held
struct AttnRow {
  int pos, len, held;                    // held: the slot's pages fit
  int pages[kRowPages];
};

// phase 2 for one (row, kv head): K10's in-block online softmax over the
// row's valid keys, gathered through its slot's pages of layer l; `row`
// the row's data read at the start (null: read here)
template <typename T, int G>
__device__ void attend_unit(const MegaParams& p, int l, int r, int hk,
                            float* smem, const AttnRow* row) {
  constexpr int V = 16 / sizeof(T);      // elements per lane
  constexpr int kLpr = kDMax / V;        // lanes per key row: 16 or 32
  constexpr int kRpw = 32 / kLpr;        // key rows per warp load
  // key rows a lane loads per step, held as raw 16-byte words until
  // used: all of a step's loads are in flight at once, and a row of 256
  // keys takes one or two steps (each step's loads wait a full memory
  // round trip while the weight stream keeps HBM busy)
  constexpr int kU = G >= 8 ? 2 : (G >= 4 ? 4 : 8);
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
  const int pos = row != nullptr ? row->pos : p.pos[r];
  const int len = row != nullptr ? row->len
                                 : max(0, min(pos + 1, p.mx * p.page));
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

  const int* trow = row != nullptr && row->held
                        ? row->pages
                        : p.table + (long)p.slot[r] * p.mx;
  for (int t0 = 0; t0 < len; t0 += kStep) {
    uint4 kr[kU], vr[kU];
    int tk[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      tk[u] = t0 + (u * kWarps + warp) * kRpw + rg;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (tk[u] < len) {
        const long g = (long)l * p.P + trow[tk[u] / p.page];
        const long off = ((g * p.hkv + hk) * p.page + tk[u] % p.page) * D;
        kr[u] = load_word(kp + off + e0, e0, D, p.vec);
        vr[u] = load_word(vp + off + e0, e0, D, p.vec);
      }
    }
    // element e of key row u, widened where it is used
    auto kf = [&](int u, int e) {
      return pt::to_float(reinterpret_cast<const T*>(&kr[u])[e]);
    };
    auto vf = [&](int u, int e) {
      return pt::to_float(reinterpret_cast<const T*>(&vr[u])[e]);
    };
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[kU];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) d += qf[g][e] * kf(u, e);
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
        for (int e = 0; e < V; ++e) acc[g][e] += prr * vf(u, e);
      }
      lsum[g] = lsum[g] * alpha + psum;
      m[g] = m_new;
    }
  }

  csync();                               // the previous unit's merge is read
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
  csync();

  T* o = static_cast<T*>(p.o);
  for (int i = threadIdx.x; i < group * D; i += kCThreads) {
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

// the block's first unit's row data (see AttnRow)
__device__ void attn_row_init(const MegaParams& p, AttnRow* row) {
  if (blockIdx.x < p.B * p.hkv) {
    const int r = blockIdx.x / p.hkv;
    const int held = p.mx <= kRowPages;
    if (threadIdx.x == 0) {
      row->pos = p.pos[r];
      row->len = max(0, min(row->pos + 1, p.mx * p.page));
      row->held = held;
    }
    if (held) {
      const int* trow = p.table + (long)p.slot[r] * p.mx;
      for (int i = threadIdx.x; i < p.mx; i += kCThreads)
        row->pages[i] = trow[i];
    }
  }
  csync();
}

template <typename T>
__device__ void attention_phase(const MegaParams& p, int l, float* smem,
                                const AttnRow* first) {
  const int group = p.hq / p.hkv;
  for (int u = blockIdx.x; u < p.B * p.hkv; u += gridDim.x) {
    const int r = u / p.hkv;
    const int hk = u % p.hkv;
    const AttnRow* row = u == blockIdx.x ? first : nullptr;
    if (group <= 1) {
      attend_unit<T, 1>(p, l, r, hk, smem, row);
    } else if (group <= 2) {
      attend_unit<T, 2>(p, l, r, hk, smem, row);
    } else if (group <= 4) {
      attend_unit<T, 4>(p, l, r, hk, smem, row);
    } else {
      attend_unit<T, 8>(p, l, r, hk, smem, row);
    }
  }
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;     // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  return 0.5f * x * (1.f + tanhf(kBeta * (x + kKappa * x * x * x)));
}

// one product of layer l as the kernel sees it
template <typename T>
struct Prod {
  const T* a;            // the operand (B, K)
  const float* ln_s;     // its LayerNorm (K,) fp32, or null
  const float* ln_b;
  const T* w;            // layer l's (K, N) weight
  const T* bias;         // (N,) or null
  int K, N;
  Plan plan;
};

// the column tile t of product `pr`: its first column and width. The
// QKV product's tiles hold whole heads (rope and the K/V write run in
// its epilogue): 128-column tiles where D divides 128, else one head a
// tile
__device__ __host__ inline void tile_cols(int pr, int t, int N, int D,
                                          int* c0, int* width) {
  if (pr == kQkv && kUnitN % D != 0) {
    *c0 = t * D;
    *width = D;
  } else {
    *c0 = t * kUnitN;
    *width = N - *c0 < kUnitN ? N - *c0 : kUnitN;
  }
}

__host__ __device__ inline int tiles_of(int pr, int N, int D) {
  return pr == kQkv && kUnitN % D != 0 ? N / D
                                       : (N + kUnitN - 1) / kUnitN;
}

template <typename T>
__device__ Prod<T> prod_of(const MegaParams& p, int pr, int l, int cap) {
  const int dm = p.dm, D = p.D, F = p.F;
  const int nq = (p.hq + 2 * p.hkv) * D;
  const int no = p.hq * D;
  T* xo = static_cast<T*>(p.xo);
  Prod<T> q;
  if (pr == kQkv) {
    q.a = l == 0 ? static_cast<const T*>(p.x) : xo;
    q.ln_s = p.ln1_s + (long)l * dm;
    q.ln_b = p.ln1_b + (long)l * dm;
    q.w = static_cast<const T*>(p.wqkv) + (long)l * dm * nq;
    q.bias = p.bqkv ? static_cast<const T*>(p.bqkv) + (long)l * nq : nullptr;
    q.K = dm;
    q.N = nq;
  } else if (pr == kWo) {
    q.a = static_cast<const T*>(p.o);
    q.ln_s = q.ln_b = nullptr;
    q.w = static_cast<const T*>(p.wo) + (long)l * no * dm;
    q.bias = p.bo ? static_cast<const T*>(p.bo) + (long)l * dm : nullptr;
    q.K = no;
    q.N = dm;
  } else if (pr == kUp) {
    q.a = xo;
    q.ln_s = p.ln2_s + (long)l * dm;
    q.ln_b = p.ln2_b + (long)l * dm;
    q.w = static_cast<const T*>(p.wup) + (long)l * dm * F;
    q.bias = p.bup ? static_cast<const T*>(p.bup) + (long)l * F : nullptr;
    q.K = dm;
    q.N = F;
  } else {
    q.a = static_cast<const T*>(p.u);
    q.ln_s = q.ln_b = nullptr;
    q.w = static_cast<const T*>(p.wdown) + (long)l * F * dm;
    q.bias = p.bdown ? static_cast<const T*>(p.bdown) + (long)l * dm
                     : nullptr;
    q.K = F;
    q.N = dm;
  }
  q.plan = make_plan(q.K, tiles_of(pr, q.N, D), p.B, p.grid, cap);
  return q;
}

// LayerNorm statistics of rows m0 .. m0 + kMT of a (B, K), as the block
// computes them (fp32: the mean, then the mean squared deviation), read
// through L2: warp m takes row m. A row of up to kSpan elements is read
// once, 16 bytes a lane and all in flight, and held in registers for
// both sums; longer rows (or rows not 16-byte aligned: !vec) are read
// twice.
template <typename T>
__device__ void row_stats(const T* a, int m0, int B, int K, bool vec,
                          float* mu, float* rstd) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kChunk = 8;
  constexpr int kSpan = 32 * V * kChunk;
  const int lane = threadIdx.x & 31;
  const int m = threadIdx.x >> 5;        // kMT == kWarps
  if (m0 + m < B) {
    const T* row = a + (long)(m0 + m) * K;
    float mean, var;
    if (vec && K <= kSpan) {
      uint4 raw[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int k = (lane + 32 * j) * V;
        raw[j] = k < K ? __ldcg(reinterpret_cast<const uint4*>(row + k))
                       : make_uint4(0u, 0u, 0u, 0u);
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e)
          s += pt::to_float(reinterpret_cast<const T*>(&raw[j])[e]);
      mean = warp_sum(s) / K;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if ((lane + 32 * j) * V >= K) continue;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float t =
              pt::to_float(reinterpret_cast<const T*>(&raw[j])[e]) - mean;
          q += t * t;
        }
      }
      var = warp_sum(q) / K;
    } else {
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += ldcg_f(row + k);
      mean = warp_sum(s) / K;
      float q = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float t = ldcg_f(row + k) - mean;
        q += t * t;
      }
      var = warp_sum(q) / K;
    }
    if (lane == 0) {
      mu[m] = mean;
      rstd[m] = 1.0f / sqrtf(var + 1e-5f);
    }
  }
  csync();
}

// element k of row r of the operand, normalised and rounded to T where
// the product has a LayerNorm
template <typename T>
__device__ __forceinline__ T normed(const Prod<T>& q, float v, int r, int k,
                                    const float* mu, const float* rstd) {
  if (q.ln_s == nullptr) return pt::from_float<T>(v);
  return pt::from_float<T>((v - mu[r]) * rstd[r] * q.ln_s[k] + q.ln_b[k]);
}

// rows m0 .. m0 + kMT, depths [kb, kb + 64 nst) of the bf16 operand into
// As as wgmma's K-major B tile of N 8: 64-deep boxes of 8 rows x 128
// bytes (1 KB each), the 16-byte chunk c of row r at chunk c ^ r; zero
// past B and past ke
__device__ void stage_sw(const Prod<bf16>& q, int m0, int B, int kb, int ke,
                         int nst, bool vec, const float* mu,
                         const float* rstd, unsigned char* As) {
  const int nch = nst * 8;
  for (int i = threadIdx.x; i < kMT * nch; i += kCThreads) {
    const int r = i / nch;
    const int ch = i % nch;
    const int k = kb + ch * 8;
    alignas(16) bf16 v[8];
    if (m0 + r < B && k < ke) {
      const bf16* src = q.a + (long)(m0 + r) * q.K + k;
      if (vec && k + 8 <= ke) {
        *reinterpret_cast<uint4*>(v) =
            __ldcg(reinterpret_cast<const uint4*>(src));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = k + e < ke ? pt::from_float<bf16>(ldcg_f(src + e))
                            : __float2bfloat16(0.f);
      }
      if (q.ln_s != nullptr) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (k + e < ke)
            v[e] = normed(q, __bfloat162float(v[e]), r, k + e, mu, rstd);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(0.f);
    }
    *reinterpret_cast<uint4*>(As + (ch / 8) * 1024 + r * 128 +
                              (((ch % 8) ^ r) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// rows m0 .. m0 + kMT, depths [kb, ke) of the operand into As
// depth-major (As[(k - kb) kMT + m]), normalised where the product has a
// LayerNorm (rows past B hold zeros or their normalisation: their sums
// are never stored)
template <typename T>
__device__ void stage_dm(const Prod<T>& q, int m0, int B, int kb, int ke,
                         const float* mu, const float* rstd, T* As) {
  stage_raw(q.a, m0, B, q.K, kb, ke - kb, As);
  if (q.ln_s == nullptr) return;
  csync();
  for (int i = threadIdx.x; i < kMT * (ke - kb); i += kCThreads) {
    const int r = i % kMT;
    As[i] = normed(q, pt::to_float(As[i]), r, kb + i / kMT, mu, rstd);
  }
}

// The sums of one unit on the CUDA cores (fp32 products, or bf16 ones
// whose rows are not 16-byte aligned): columns c0 .. c0 + kUnitN over
// depths [kb, ke) of the staged operand into tile[m * kUnitN + c]. Thread
// t owns the columns (t % CG) V .. + V and every RS-th depth; its 16-byte
// pieces stream through a private ring of kStages slots (cp.async); the
// depth lanes' sums reduce through shared memory, four rows at a time.
template <typename T>
__device__ void unit_sums_cc(const Prod<T>& q, int c0, int kb, int ke,
                             bool vec, const T* As, uint4* ring, float* red,
                             float* tile) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CG = kUnitN / V;         // threads a weight row: 16 or 32
  constexpr int RS = kCThreads / CG;     // depth lanes: 16 or 8
  static_assert(RS * 4 * kUnitN <= kUnitRedFloats, "reduction buffer");
  const int tid = threadIdx.x;
  const int cgi = tid % CG;
  const int kr = tid / CG;
  const int n = c0 + cgi * V;
  const int N = q.N;
  uint4* mine = ring + tid;              // slot s at mine[s * kCThreads]
  float acc[kMT][V];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[m][e] = 0.f;
  const int iters = kb + kr < ke ? (ke - kb - kr + RS - 1) / RS : 0;
  const T* wb = q.w + (long)(kb + kr) * N + n;
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < iters)
      fill_slot(mine + it * kCThreads, wb + (long)it * RS * N, n, N, vec);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    const int nx = it + kStages - 1;
    if (nx < iters)
      fill_slot(mine + (nx % kStages) * kCThreads, wb + (long)nx * RS * N,
                n, N, vec);
    cp_async_commit();
    cp_async_wait<kStages - 1>();        // piece `it` has landed
    const uint4 raw = mine[(it % kStages) * kCThreads];
    float a[kMT];
    a_rows(As, kr + it * RS, a);
    const T* w = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float we = pt::to_float(w[e]);
#pragma unroll
      for (int m = 0; m < kMT; ++m) acc[m][e] += a[m] * we;
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    csync();                             // red is free
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
#pragma unroll
      for (int e = 0; e < V; ++e)
        red[(kr * 4 + mm) * kUnitN + cgi * V + e] = acc[h * 4 + mm][e];
    csync();
    for (int i = tid; i < 4 * kUnitN; i += kCThreads) {
      const int mm = i / kUnitN;
      const int c = i % kUnitN;
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < RS; ++r) sum += red[(r * 4 + mm) * kUnitN + c];
      tile[(h * 4 + mm) * kUnitN + c] = sum;
    }
  }
}

// The sums of one unit on the tensor cores (bf16, TMA): the unit's weight
// stages arrive in the ring (the weight stream's warp issued them in the
// same order); warpgroup cw multiplies the stage's box cw, the 64 x 64
// MN-major A operand (W transposed: 64 output columns x depth), by the
// staged rows, the N 8 K-major B operand, with wgmma m64n8k16, and
// releases each slot once its products retire. Sums into tile[m][c].
__device__ void unit_sums_tc(int nst, uint32_t ring, uint32_t bars,
                             uint32_t As, float* tile, int& it) {
  using namespace sm90;
  const int cw = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int st = 0; st < nst; ++st, ++it) {
    const int s = it % kRingStages;
    mbar_wait(bars + 8 * s, (it / kRingStages) & 1);
    const uint32_t box = ring + s * kWStage;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kUnitK / 16; ++kk)
      wgmma_ss_n8<1, 0>(acc, operand_desc<true>(box, cw, kk),
                        gmma_desc(As + st * 1024 + kk * 32, 16, 1024));
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    if (st > 0 && t == 0)
      mbar_arrive(bars + 8 * (kRingStages + (it - 1) % kRingStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (nst > 0 && t == 0)
    mbar_arrive(bars + 8 * (kRingStages + (it - 1) % kRingStages));
  // d[0, 1]: output column 16 w + g, rows 2 (lane % 4) + {0, 1}; d[2, 3]:
  // the column 8 on
  const int lane = t & 31;
  const int c = cw * 64 + 16 * (t / 32) + lane / 4;
  const int m = 2 * (lane % 4);
  tile[m * kUnitN + c] = acc[0];
  tile[(m + 1) * kUnitN + c] = acc[1];
  tile[m * kUnitN + c + 8] = acc[2];
  tile[(m + 1) * kUnitN + c + 8] = acc[3];
}

// The epilogue of a unit's finished sums tile[m][c] (rows m0 + m < B,
// columns c0 + c, c < width), as the JAX block rounds them:
//   QKV: q|k|v (+ bias) into the scratch; then rope on k and the fresh
//     K/V rows into the pools (page table[slot, min(pos / page, mx - 1)]
//     of layer l, or the scratch page L P when the write flag is 0): the
//     tile holds whole heads, so rope's partner column is in it;
//   out-projection: x_out = x + (o W + b);
//   up-projection: u = GELU(LN2(x) W + b);
//   down-projection: x_out += u W + b.
// Each output is finished by one thread, which reads x at that entry
// only, so the in-place updates are race-free.
template <typename T>
__device__ void epilogue(const MegaParams& p, const Prod<T>& q, int pr,
                         int l, int m0, int c0, int width, float* tile) {
  constexpr int kPer = kMT * kUnitN / kCThreads;  // outputs a thread
  __shared__ long rbase[kMT];            // a row's fresh K/V offset, head 0
  __shared__ int rpos[kMT];
  const int B = p.B, N = q.N, D = p.D;
  T* xo = static_cast<T*>(p.xo);
  const T* res = pr == kWo ? (l == 0 ? static_cast<const T*>(p.x) : xo)
                           : pr == kDown ? xo : nullptr;
  const int total = kMT * width;
  if (pr == kQkv && threadIdx.x < kMT && m0 + (int)threadIdx.x < B) {
    const int row = m0 + threadIdx.x;
    const int pos = p.pos[row];
    const int pid =
        p.table[(long)p.slot[row] * p.mx + min(pos / p.page, p.mx - 1)];
    const long g = p.write[row] == 1 ? (long)l * p.P + pid : (long)p.L * p.P;
    rbase[threadIdx.x] = (g * p.hkv * p.page + pos % p.page) * D;
    rpos[threadIdx.x] = pos;
  }
  // every input of the thread's outputs first, all loads in flight
  float bias[kPer], x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kCThreads;
    const int m = i / width;
    const int n = c0 + i % width;
    bias[j] = x[j] = 0.f;
    if (i < total && m0 + m < B) {
      if (q.bias != nullptr) bias[j] = pt::to_float(q.bias[n]);
      if (res != nullptr) x[j] = ldcg_f(res + (long)(m0 + m) * N + n);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kCThreads;
    const int m = i / width;
    const int c = i % width;
    const int row = m0 + m;
    if (i >= total || row >= B) continue;
    float v = pt::round_to<T>(tile[m * kUnitN + c]);
    if (q.bias != nullptr) v = pt::round_to<T>(v + bias[j]);
    const long at = (long)row * N + c0 + c;
    if (pr == kQkv) {
      tile[m * kUnitN + c] = v;
      static_cast<T*>(p.qkv)[at] = pt::from_float<T>(v);
    } else if (pr == kUp) {
      static_cast<T*>(p.u)[at] = pt::from_float<T>(gelu_tanh(v));
    } else {
      xo[at] = pt::from_float<T>(x[j] + v);
    }
  }
  if (pr != kQkv) return;
  csync();
  const int half = D / 2, kseg = p.hq * D;
  T* kpool = static_cast<T*>(p.kp);
  T* vpool = static_cast<T*>(p.vp);
  for (int i = threadIdx.x; i < total; i += kCThreads) {
    const int m = i / width;
    const int c = i % width;
    const int n = c0 + c;
    if (m0 + m >= B || n < kseg) continue;
    const bool is_k = n < kseg + p.hkv * D;
    const int h = (n - kseg) / D % p.hkv;
    const int e = (n - kseg) % D;
    float v = tile[m * kUnitN + c];
    if (is_k && p.rope) {
      const int i2 = e < half ? e : e - half;
      const float freq = powf(p.theta, -static_cast<float>(i2) / half);
      const float ang = static_cast<float>(rpos[m]) * freq;
      const float cs = cosf(ang);
      const float sn = sinf(ang);
      v = e < half ? v * cs - tile[m * kUnitN + c + half] * sn
                   : tile[m * kUnitN + c - half] * sn + v * cs;
      v = pt::round_to<T>(v);
    }
    (is_k ? kpool : vpool)[rbase[m] + (long)h * p.page * D + e] =
        pt::from_float<T>(v);
  }
}

// one product over the grid (the consumers' side): every unit of this
// block in turn; a unit's sums go through its split's partials when the
// depth splits, the last split to finish (a counter per tile) adding
// them in split order and applying the epilogue; nothing waits on
// another block within the phase
template <typename T>
__device__ void product_phase(const MegaParams& p, int pr, int l,
                              unsigned char* dsm, uint32_t ring_s,
                              uint32_t bars, int& it) {
  __shared__ float mu[kMT], rstd[kMT];
  __shared__ int last;
  const bool tc = sizeof(T) == 2 && p.tma != 0;
  const Prod<T> q = prod_of<T>(p, pr, l, unit_cap<T>());
  const Plan& pl = q.plan;
  T* As = reinterpret_cast<T*>(dsm);
  float* tile = reinterpret_cast<float*>(dsm + kTileOff);
  uint4* ring = reinterpret_cast<uint4*>(dsm + kRingOff);
  float* red = reinterpret_cast<float*>(dsm + kRingOff +
                                        kStages * kCThreads * 16);
  unsigned* counters = p.sync + 1;
  const int units = pl.tiles * pl.splits * pl.rt;
  int stats_m0 = -1;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int t = u % pl.tiles;
    const int sp = (u / pl.tiles) % pl.splits;
    const int m0 = u / (pl.tiles * pl.splits) * kMT;
    int c0, width;
    tile_cols(pr, t, q.N, p.D, &c0, &width);
    const int kb = sp * pl.depth;
    const int ke = min(q.K, kb + pl.depth);
    if (q.ln_s != nullptr && stats_m0 != m0) {
      row_stats(q.a, m0, p.B, q.K, p.vec != 0, mu, rstd);
      stats_m0 = m0;
    }
    csync();                             // As and tile are free
    if constexpr (sizeof(T) == 2) {
      if (tc) {
        const int nst = (ke - kb + kUnitK - 1) / kUnitK;
        stage_sw(q, m0, p.B, kb, ke, nst, p.vec != 0, mu, rstd, dsm);
        sm90::fence_proxy_async();       // the rows before wgmma reads them
        csync();
        unit_sums_tc(nst, ring_s, bars, sm90::smem_u32(dsm), tile, it);
      }
    }
    if (!tc) {
      stage_dm(q, m0, p.B, kb, ke, mu, rstd, As);
      csync();
      unit_sums_cc(q, c0, kb, ke, p.vec != 0, As, ring, red, tile);
    }
    csync();                             // the unit's sums are in tile
    if (pl.splits > 1) {
      for (int i = threadIdx.x; i < kMT * width; i += kCThreads) {
        const int m = i / width;
        const int c = i % width;
        if (m0 + m < p.B)
          p.ws[((long)sp * p.B + m0 + m) * q.N + c0 + c] =
              tile[m * kUnitN + c];
      }
      __threadfence();
      csync();
      if (threadIdx.x == 0) {
        unsigned* ctr = counters + (m0 / kMT) * pl.tiles + t;
        last = atomicAdd(ctr, 1u) == static_cast<unsigned>(pl.splits - 1);
        if (last) *ctr = 0u;             // for the next product
      }
      csync();
      if (!last) continue;
      __threadfence();
      for (int i = threadIdx.x; i < kMT * width; i += kCThreads) {
        const int m = i / width;
        const int c = i % width;
        if (m0 + m >= p.B) continue;
        // the partials in split order, up to 8 loads in flight
        const float* part = p.ws + ((long)m0 + m) * q.N + c0 + c;
        const long stride = (long)p.B * q.N;
        float s = 0.f;
        for (int j0 = 0; j0 < pl.splits; j0 += 8) {
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = j0 + j < pl.splits ? __ldcg(part + (j0 + j) * stride)
                                      : 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j0 + j < pl.splits) s += v[j];
        }
        tile[m * kUnitN + c] = s;
      }
      csync();
    }
    epilogue(p, q, pr, l, m0, c0, width, tile);
  }
}

// The weight stream (one thread): every TMA stage of every unit this
// block takes, layer after layer, product after product, in the order
// the consumers take them, each once the consumers have released its
// slot: it runs on across units, phases and grid barriers, so the next
// phase's first weights are in flight while the consumers wait.
__device__ void weight_stream(const MegaMaps& maps, const MegaParams& p,
                              uint32_t ring, uint32_t bars) {
  using namespace sm90;
  const int D = p.D;
  const int nq = (p.hq + 2 * p.hkv) * D;
  const int Ks[4] = {p.dm, p.hq * D, p.dm, p.F};
  const int Ns[4] = {nq, p.dm, p.F, p.dm};
  Plan plans[4];
#pragma unroll
  for (int pr = 0; pr < 4; ++pr)
    plans[pr] = make_plan(Ks[pr], tiles_of(pr, Ns[pr], D), p.B, p.grid,
                          unit_cap<bf16>());
  int it = 0;
  for (int l = 0; l < p.L; ++l) {
    for (int pr = 0; pr < 4; ++pr) {
      const Plan& pl = plans[pr];
      const int units = pl.tiles * pl.splits * pl.rt;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int t = u % pl.tiles;
        const int sp = (u / pl.tiles) % pl.splits;
        int c0, width;
        tile_cols(pr, t, Ns[pr], D, &c0, &width);
        const int kb = sp * pl.depth;
        const int ke = min(Ks[pr], kb + pl.depth);
        const int nst = (ke - kb + kUnitK - 1) / kUnitK;
        for (int st = 0; st < nst; ++st, ++it) {
          const int s = it % kRingStages;
          if (it >= kRingStages)
            mbar_wait(bars + 8 * (kRingStages + s),
                      (it / kRingStages - 1) & 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t dst = ring + s * kWStage;
          mbar_expect_tx(full, kWStage);
          tma_load_3d(&maps.w[pr], dst, full, c0, kb + st * kUnitK, l);
          tma_load_3d(&maps.w[pr], dst + kAtom, full, c0 + 64,
                      kb + st * kUnitK, l);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMegaThreads, 1)
    mega_kernel(const __grid_constant__ MegaMaps maps, MegaParams p) {
  extern __shared__ unsigned char dsm_raw[];
  const uint32_t raw = sm90::smem_u32(dsm_raw);
  unsigned char* dsm = dsm_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t ring = sm90::smem_u32(dsm) + kRingOff;
  const uint32_t bars = ring + kRingStages * kWStage;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      sm90::mbar_init(bars + 8 * s, 1);
      sm90::mbar_init(bars + 8 * (kRingStages + s), 2);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= kCThreads) {
    sm90::regs_dec<40>();
    if constexpr (sizeof(T) == 2) {
      if (p.tma != 0 && threadIdx.x == kCThreads)
        weight_stream(maps, p, ring, bars);
    }
    return;
  }
  sm90::regs_inc<232>();
  __shared__ AttnRow arow;
  attn_row_init(p, &arow);
  Stamps stamps{p.stamps, p.stamp_cap, 0};
  stamps.mark(-1);
  int it = 0;                            // the ring's stage counter
  for (int l = 0; l < p.L; ++l) {
    const int c = 16 * l;
    // 1. LN1 + QKV (+ bias), rope, the fresh K/V rows -> qkv, pools
    product_phase<T>(p, kQkv, l, dsm, ring, bars, it);
    grid_sync(p.sync, gridDim.x);
    stamps.mark(c + kPhQkv);
    // 2. attention -> o
    attention_phase<T>(p, l, reinterpret_cast<float*>(dsm), &arow);
    grid_sync(p.sync, gridDim.x);
    stamps.mark(c + kPhAttn);
    // 3. out-projection (+ bias) + residual -> x_out
    product_phase<T>(p, kWo, l, dsm, ring, bars, it);
    grid_sync(p.sync, gridDim.x);
    stamps.mark(c + kPhWo);
    // 4. LN2 + up-projection (+ bias) + GELU -> u
    product_phase<T>(p, kUp, l, dsm, ring, bars, it);
    grid_sync(p.sync, gridDim.x);
    stamps.mark(c + kPhUp);
    // 5. down-projection (+ bias) + residual -> x_out
    product_phase<T>(p, kDown, l, dsm, ring, bars, it);
    // the record closes the last phase with one more barrier
    if (l + 1 < p.L || p.stamps != nullptr) {
      grid_sync(p.sync, gridDim.x);
      stamps.mark(c + kPhDown);
    }
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
                             kMegaSmem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mega_kernel<T>, kMegaThreads, kMegaSmem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return per_sm * sms;
}

// 32-bit words of K8's workspace: the grid barrier's word and a split
// counter per (row tile, column tile), rounded up to 4, then the split
// products' fp32 partial sums (the largest of the four products')
__host__ inline long mega_ws_words(int B, int dm, int hq, int hkv, int D,
                                   int F, int grid, int cap,
                                   long* counters) {
  const int nq = (hq + 2 * hkv) * D;
  const int Ks[4] = {dm, hq * D, dm, F};
  const int Ns[4] = {nq, dm, F, dm};
  long ctr = 0, most = 0;
  for (int pr = 0; pr < 4; ++pr) {
    const Plan pl = make_plan(Ks[pr], tiles_of(pr, Ns[pr], D), B, grid, cap);
    const long c = (long)pl.tiles * pl.rt;
    if (c > ctr) ctr = c;
    const long w = pl.splits > 1 ? (long)pl.splits * B * Ns[pr] : 0;
    if (w > most) most = w;
  }
  *counters = (1 + ctr + 3) / 4 * 4;
  return *counters + most;
}

// the 3D map (N, K, L) of an (L, K, N) bf16 weight stack, read in boxes
// of 64 columns x 64 depths with the 128-byte swizzle
inline int weight_map(CUtensorMap* map, const void* w, int L, int K, int N) {
  const sm90::EncodeTiled enc = sm90::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                 static_cast<cuuint64_t>(K) * N * 2};
  const cuuint32_t box[3] = {64, kUnitK, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r =
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w),
          dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_mega(MegaParams& p, long ws_words, cudaStream_t st) {
  const int g = mega_grid<T>();
  if (g < 0) return -g;
  long counters = 0;
  if (mega_ws_words(p.B, p.dm, p.hq, p.hkv, p.D, p.F, g, unit_cap<T>(),
                    &counters) > ws_words)
    return static_cast<int>(cudaErrorInvalidValue);
  p.ws = reinterpret_cast<float*>(p.sync + counters);
  p.grid = g;
  MegaMaps maps;
  memset(&maps, 0, sizeof(maps));
  const int nq = (p.hq + 2 * p.hkv) * p.D;
  p.tma = sizeof(T) == 2 && p.vec && nq % 8 == 0 && p.dm % 8 == 0 &&
          p.F % 8 == 0;
  if (p.tma) {
    const int Ks[4] = {p.dm, p.hq * p.D, p.dm, p.F};
    const int Ns[4] = {nq, p.dm, p.F, p.dm};
    const void* ws[4] = {p.wqkv, p.wo, p.wup, p.wdown};
    for (int pr = 0; pr < 4; ++pr) {
      const int rc = weight_map(&maps.w[pr], ws[pr], p.L, Ks[pr], Ns[pr]);
      if (rc != 0) return rc;
    }
  }
  void* args[] = {&maps, &p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(mega_kernel<T>), dim3(g), dim3(kMegaThreads),
      args, kMegaSmem, st));
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
  float* red = reinterpret_cast<float*>(dsm + kACapBytes + kK9Ring);
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

// -- K9 on the tensor cores (bf16) -------------------------------------------

constexpr int kK9Consumers = 128;        // one warpgroup
constexpr int kK9Threads = kK9Consumers + 32;   // + the head stream's warp
constexpr int kK9Cols = 64;              // vocabulary columns of a tile
constexpr int kK9Depth = 64;             // depth of a head box
constexpr uint32_t kK9Box = kK9Cols * kK9Depth * 2;   // 8 KB
constexpr int kK9MaxStages = 16;

struct LogitsTc {
  const bf16* x;          // (B, dm)
  const float* ln_s;      // (dm,)
  const float* ln_b;
  const int* poison;      // (B,) or null
  unsigned long long* ws; // keys (B), flags (B), counter: zero between calls
  int* tok;               // (B,)
  int* nonfin;            // (B,)
  int B, dm, V;
  int rows;               // rows of a group (<= N)
  int stages;             // head boxes in the ring
};

// the consumers' block barrier (the head stream's warp never joins)
__device__ __forceinline__ void k9_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kK9Consumers) : "memory");
}

// Rows r0 .. r0 + nr of x, LayerNormed (eps 1e-5, fp32 statistics: the
// mean, then the mean squared deviation; rounded to bf16 as the block
// rounds them), into `rows` as wgmma's K-major B operand of N rows: per
// 64-deep slab N rows of 128 bytes, 8-row groups 1024 bytes apart, the
// 16-byte chunk c of row r at chunk c ^ (r % 8) (the 128-byte swizzle).
// Rows nr .. N and depths past dm are zeros. Warp w takes rows w, w + 4,
// ...; a row of up to 2048 elements is read once, 16 bytes a lane all in
// flight, and held in registers; a longer one is read three times. The
// caller guarantees dm % 8 == 0 and x 16-byte aligned.
template <int N>
__device__ void k9_stage(const LogitsTc& p, int r0, int nr,
                         unsigned char* rows) {
  constexpr int kHeld = 8;               // 16-byte pieces a lane holds
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int dm = p.dm;
  const int kpad = (dm + kK9Depth - 1) / kK9Depth * kK9Depth;
  const bool held = dm <= 32 * 8 * kHeld;
  for (int r = w; r < N; r += kK9Consumers / 32) {
    const bf16* src = p.x + (long)(r0 + r) * dm;
    const bool real = r < nr;
    uint4 raw[kHeld];
    float mean = 0.f, rstd = 0.f;
    if (real) {
      float s = 0.f;
      if (held) {
#pragma unroll
        for (int c = 0; c < kHeld; ++c) {
          const int k = (lane + 32 * c) * 8;
          raw[c] = k < dm ? *reinterpret_cast<const uint4*>(src + k)
                          : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int c = 0; c < kHeld; ++c)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            s += __bfloat162float(reinterpret_cast<const bf16*>(&raw[c])[e]);
      } else {
        for (int k = lane * 8; k < dm; k += 256) {
          const uint4 v = *reinterpret_cast<const uint4*>(src + k);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            s += __bfloat162float(reinterpret_cast<const bf16*>(&v)[e]);
        }
      }
      mean = warp_sum(s) / dm;
      float q = 0.f;
      if (held) {
#pragma unroll
        for (int c = 0; c < kHeld; ++c) {
          if ((lane + 32 * c) * 8 >= dm) continue;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float t =
                __bfloat162float(reinterpret_cast<const bf16*>(&raw[c])[e]) -
                mean;
            q += t * t;
          }
        }
      } else {
        for (int k = lane * 8; k < dm; k += 256) {
          const uint4 v = *reinterpret_cast<const uint4*>(src + k);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float t =
                __bfloat162float(reinterpret_cast<const bf16*>(&v)[e]) - mean;
            q += t * t;
          }
        }
      }
      rstd = 1.0f / sqrtf(warp_sum(q) / dm + 1e-5f);
    }
    for (int k = lane * 8, c = 0; k < kpad; k += 256, ++c) {
      alignas(16) bf16 out[8];
      if (real && k < dm) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (held) {
          // c < kHeld: k < dm <= 2048
#pragma unroll
          for (int i = 0; i < kHeld; ++i)
            if (i == c) v = raw[i];
        } else {
          v = *reinterpret_cast<const uint4*>(src + k);
        }
        const float4 s0 = *reinterpret_cast<const float4*>(p.ln_s + k);
        const float4 s1 = *reinterpret_cast<const float4*>(p.ln_s + k + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(p.ln_b + k);
        const float4 b1 = *reinterpret_cast<const float4*>(p.ln_b + k + 4);
        const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          out[e] = __float2bfloat16(
              (__bfloat162float(reinterpret_cast<const bf16*>(&v)[e]) -
               mean) *
                  rstd * sc[e] +
              bi[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16(0.f);
      }
      const int ch = (k % kK9Depth) / 8;
      *reinterpret_cast<uint4*>(rows + (k / kK9Depth) * (N * 128) +
                                (r / 8) * 1024 + (r % 8) * 128 +
                                ((ch ^ (r % 8)) << 4)) =
          *reinterpret_cast<const uint4*>(out);
    }
  }
  // the rows are read by wgmma (the async proxy)
  sm90::fence_proxy_async();
}

// K9, bf16 with a 16-byte aligned head: a persistent block per SM (the
// grid: min(SMs, vocabulary tiles), from the caller) takes the contiguous
// range of 64-column vocabulary tiles [blockIdx.x * tiles / grid,
// (blockIdx.x + 1) * tiles / grid). Per group of p.rows rows (N = the
// wgmma width that holds them), the consumer warpgroup LayerNorms the
// rows into shared memory once (`k9_stage`), then for each tile of the
// range multiplies its head boxes (64 columns x 64 deep, streamed by the
// last warp's thread through a ring of p.stages slots that runs on across
// tiles and groups, so the head is read once per group) by the rows:
// wgmma m64nNk16 with the head box as A (tied (V, dm): K-major; (dm, V):
// MN-major) and the rows as the K-major B, the sums in registers. A
// tile's logits are rounded to bf16 in registers, poisoned rows are NaN,
// the flag covers the true vocabulary, and each row's largest key
// (order-preserving value bits << 32 | ~index) is kept per thread, then
// reduced over the quad's lanes by shuffles and the warps by shared
// atomics; the blocks merge as logits_kernel's do.
template <int N, bool kKMajor>
__global__ void __launch_bounds__(kK9Threads, 1)
    logits_kernel_sm90(const __grid_constant__ CUtensorMap head,
                       LogitsTc p) {
  using namespace sm90;
  constexpr int kAcc = N / 2;            // accumulators a thread
  constexpr int kMine = N / 4;           // rows a thread sees
  extern __shared__ unsigned char dsm_raw[];
  const uint32_t raw = smem_u32(dsm_raw);
  unsigned char* rows = dsm_raw + (((raw + 1023) & ~1023u) - raw);
  __shared__ __align__(8) uint64_t bars[2 * kK9MaxStages];
  __shared__ unsigned long long best[kMaxRows];
  __shared__ int flag[kMaxRows];
  __shared__ bool last;
  const int B = p.B;
  const int nk = (p.dm + kK9Depth - 1) / kK9Depth;   // boxes a tile
  const uint32_t rows_u = smem_u32(rows);
  const uint32_t ring = rows_u + nk * N * 128;
  const uint32_t full = smem_u32(bars);
  const uint32_t empty = full + 8 * kK9MaxStages;
  const int S = p.stages;
  const int tiles = (p.V + kK9Cols - 1) / kK9Cols;
  const int t_begin = (int)((long)blockIdx.x * tiles / gridDim.x);
  const int t_end = (int)((long)(blockIdx.x + 1) * tiles / gridDim.x);
  const int groups = (B + p.rows - 1) / p.rows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);
    }
    mbar_fence_init();
  }
  for (int r = threadIdx.x; r < B; r += kK9Threads) {
    best[r] = 0ull;
    flag[r] = 0;
  }
  __syncthreads();

  if (threadIdx.x >= kK9Consumers) {
    // the head stream: every box of every tile of the range, group after
    // group, each once the consumers have released its slot
    if (threadIdx.x == kK9Consumers) {
      int it = 0;
      for (int g = 0; g < groups; ++g)
        for (int t = t_begin; t < t_end; ++t)
          for (int k = 0; k < nk; ++k, ++it) {
            const int s = it % S;
            if (it >= S) mbar_wait(empty + 8 * s, (it / S - 1) & 1);
            mbar_expect_tx(full + 8 * s, kK9Box);
            if (kKMajor)
              tma_load(&head, ring + s * kK9Box, full + 8 * s,
                       k * kK9Depth, t * kK9Cols);
            else
              tma_load(&head, ring + s * kK9Box, full + 8 * s,
                       t * kK9Cols, k * kK9Depth);
          }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int q4 = lane & 3;
  int it = 0;
  for (int g = 0; g < groups; ++g) {
    const int r0 = g * p.rows;
    const int nr = min(p.rows, B - r0);
    k9_sync();                           // the last group's products retired
    k9_stage<N>(p, r0, nr, rows);
    k9_sync();
    // the thread's rows 8 j + 2 q4 + e of the group, at index 2 j + e
    unsigned long long key[kMine];
    unsigned bad = 0u, live = 0u;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      key[i] = 0ull;
      const int r = 8 * (i / 2) + 2 * q4 + (i % 2);
      if (r < nr) {
        if (p.poison != nullptr && p.poison[r0 + r] != 0)
          bad |= 1u << i;                // every logit NaN: no key
        else
          live |= 1u << i;
      }
    }
    for (int t = t_begin; t < t_end; ++t) {
      float acc[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      for (int k = 0; k < nk; ++k, ++it) {
        const int s = it % S;
        mbar_wait(full + 8 * s, (it / S) & 1);
        const uint32_t box = ring + s * kK9Box;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kK9Depth / 16; ++kk)
          wgmma_ss_narrow<N, kKMajor ? 0 : 1, 0>(
              acc, operand_desc<!kKMajor>(box, 0, kk),
              gmma_desc(rows_u + k * N * 128 + kk * 32, 16, 1024));
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();
        if (k > 0 && tid == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (tid == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
      // acc[4 j + 2 h + e]: column t * 64 + 16 w + lane / 4 + 8 h, row
      // 8 j + 2 q4 + e
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = t * kK9Cols + 16 * w + lane / 4 + 8 * h;
        if (n >= p.V) continue;
        const unsigned int inv = 0xFFFFFFFFu - static_cast<unsigned int>(n);
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          if (!((live >> i) & 1u)) continue;
          const float v = pt::round_to<bf16>(acc[4 * (i / 2) + 2 * h + i % 2]);
          if (!isfinite(v)) bad |= 1u << i;
          if (!isnan(v)) {
            const unsigned long long kv =
                ((unsigned long long)ordered(v) << 32) | inv;
            key[i] = kv > key[i] ? kv : key[i];
          }
        }
      }
    }
    // the group's keys and flags: over the lanes of a quad position
    // (lane / 4), then the warps
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
#pragma unroll
      for (int off = 4; off <= 16; off <<= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, key[i], off);
        key[i] = o > key[i] ? o : key[i];
      }
    }
#pragma unroll
    for (int off = 4; off <= 16; off <<= 1)
      bad |= __shfl_xor_sync(0xffffffffu, bad, off);
    if (lane < 4) {
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const int r = 8 * (i / 2) + 2 * q4 + (i % 2);
        if (r >= nr) continue;
        if (key[i] != 0ull) atomicMax(&best[r0 + r], key[i]);
        if ((bad >> i) & 1u) flag[r0 + r] = 1;
      }
    }
  }
  k9_sync();
  unsigned long long* keys = p.ws;
  unsigned long long* flags = p.ws + B;
  unsigned long long* counter = p.ws + 2 * B;
  for (int r = tid; r < B; r += kK9Consumers) {
    if (best[r] != 0ull) atomicMax(keys + r, best[r]);
    if (flag[r]) atomicOr(flags + r, 1ull);
  }
  __threadfence();
  k9_sync();
  if (tid == 0)
    last = atomicAdd(counter, 1ull) == (unsigned long long)gridDim.x - 1;
  k9_sync();
  if (!last) return;
  __threadfence();
  // the last block: every other block's atomics are done
  for (int r = tid; r < B; r += kK9Consumers) {
    const unsigned long long kv = atomicExch(keys + r, 0ull);
    const unsigned long long f = atomicExch(flags + r, 0ull);
    p.tok[r] = kv != 0ull ? static_cast<int>(
                                0xFFFFFFFFu -
                                static_cast<unsigned int>(kv & 0xFFFFFFFFull))
                          : 0;
    p.nonfin[r] = f != 0ull ? 1 : 0;
  }
  if (tid == 0) atomicExch(counter, 0ull);
}

// dynamic shared memory of logits_kernel_sm90: the rows (slabs of N x 128
// bytes), the ring, and 1024 bytes to align them
__host__ inline int k9_smem(int N, int dm, int stages) {
  const int nk = (dm + kK9Depth - 1) / kK9Depth;
  return nk * N * 128 + stages * static_cast<int>(kK9Box) + 1024;
}

template <int N, bool kKMajor>
int launch_logits_tc_n(const CUtensorMap& map, const LogitsTc& p, int grid,
                       cudaStream_t st) {
  auto kern = logits_kernel_sm90<N, kKMajor>;
  const int smem = k9_smem(N, p.dm, p.stages);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, kK9Threads, smem, st>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kKMajor>
int launch_logits_tc(const CUtensorMap& map, const LogitsTc& p, int N,
                     int grid, cudaStream_t st) {
  if (N == 8) return launch_logits_tc_n<8, kKMajor>(map, p, grid, st);
  if (N == 16) return launch_logits_tc_n<16, kKMajor>(map, p, grid, st);
  if (N == 32) return launch_logits_tc_n<32, kKMajor>(map, p, grid, st);
  if (N == 64) return launch_logits_tc_n<64, kKMajor>(map, p, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K8. w: the 12 slab pointers in _WEIGHT_ORDER (a null bias is absent).
// The caller guarantees B <= 64, D <= 128 and even, Hq % Hkv == 0,
// Hq / Hkv <= 8, page a multiple of 128, every tensor contiguous and of
// the one dtype (the LayerNorm vectors fp32). ws: pt_mega_workspace(...)
// 32-bit words, zeroed when allocated (the barrier word and the split
// counters; every launch leaves the counters zero). stamps: null, or
// stamp_cap int64s for the phase-time record. Returns the launch's
// error: a refused cooperative launch never runs.
extern "C" int pt_mega_decode(int dtype, const void* const* w, const void* x,
                              void* xo, void* kp, void* vp, const void* table,
                              const void* pos, const void* slot,
                              const void* write, void* qkv, void* o, void* u,
                              void* ws, long ws_words, void* stamps,
                              int stamp_cap,
                              int B, int dm, int L, int hq, int hkv, int D,
                              int F, int page, int P, int mx, int rope,
                              float theta, float scale, int vec,
                              void* stream) {
  MegaParams p;
  memset(&p, 0, sizeof(p));
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
  p.sync = static_cast<unsigned*>(ws);
  p.stamps = static_cast<long long*>(stamps);
  p.stamp_cap = stamp_cap;
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
  if (dtype == pt::kBFloat16) return launch_mega<bf16>(p, ws_words, st);
  if (dtype == pt::kFloat32) return launch_mega<float>(p, ws_words, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// 32-bit words of the workspace pt_mega_decode needs for these operands
// on the current device (the barrier word, the split counters, the
// splits' partial sums), or a negative CUDA error
extern "C" long pt_mega_workspace(int dtype, int B, int dm, int hq, int hkv,
                                  int D, int F) {
  const int g = dtype == pt::kBFloat16 ? mega_grid<bf16>()
                                       : mega_grid<float>();
  if (g < 0) return g;
  long counters = 0;
  return dtype == pt::kBFloat16
             ? mega_ws_words(B, dm, hq, hkv, D, F, g, unit_cap<bf16>(),
                             &counters)
             : mega_ws_words(B, dm, hq, hkv, D, F, g, unit_cap<float>(),
                             &counters);
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


// K9 on the tensor cores (bf16). The caller guarantees B <= 64, dm % 8 ==
// 0 (and V % 8 == 0 for a row-major head), x and w 16-byte aligned, and
// the plan of ops/decode_megakernel.py `logits_plan`: rows <= N, N in
// {8, 16, 32, 64}, stages in 1..16, the shared memory within the card's,
// grid <= the vocabulary's 64-column tiles. ws, poison, kmajor: as
// pt_mega_logits.
extern "C" int pt_mega_logits_sm90(const void* x, const void* ln_s,
                                   const void* ln_b, const void* w,
                                   const void* poison, void* ws, void* tok,
                                   void* nonfin, int B, int dm, int V,
                                   int kmajor, int rows, int N, int stages,
                                   int grid, void* stream) {
  if (rows < 1 || rows > N || B > kMaxRows || stages < 1 ||
      stages > kK9MaxStages || dm % 8 != 0 || grid < 1 ||
      grid > (V + kK9Cols - 1) / kK9Cols)
    return static_cast<int>(cudaErrorInvalidValue);
  LogitsTc p;
  p.x = static_cast<const bf16*>(x);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.poison = static_cast<const int*>(poison);
  p.ws = static_cast<unsigned long long*>(ws);
  p.tok = static_cast<int*>(tok);
  p.nonfin = static_cast<int*>(nonfin);
  p.B = B;
  p.dm = dm;
  p.V = V;
  p.rows = rows;
  p.stages = stages;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  // the tied head (V, dm) along dm; a row-major (dm, V) head along V
  const int rc = kmajor ? sm90::map_2d(&map, w, dm, V)
                        : sm90::map_2d(&map, w, V, dm);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kmajor ? launch_logits_tc<true>(map, p, N, grid, st)
                : launch_logits_tc<false>(map, p, N, grid, st);
}

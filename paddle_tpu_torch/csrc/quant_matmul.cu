// K12 — weight-only int8 matmul, out = (x @ q) * scale, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/quant_matmul.py
// `_kernel` (launched by `int8_matmul`, the pl.pallas_call at :91): x
// (M, K) in bf16 or fp32, q (K, N) int8 row-major, scale (N,) fp32, out
// (M, N) in x's dtype. As on the TPU (:35-52), the int8 weight is widened
// to x's dtype (exact: |q| <= 128), the products accumulate in fp32, the
// per-column scale multiplies the finished fp32 sum once, and the result
// is rounded to x's dtype once. Ragged M, K and N are handled by bounds
// on every load and store; nothing is padded or copied.
//
// Three routes in one entry, chosen by x's dtype and M alone:
//
// - bf16 decode rows (M <= 16): `int8_rows_sm90`, the serving path (96
//   calls a decode step on gpt3_1p3b). Bound: bytes, the K N int8 weight
//   read once (2 M FLOP per weight byte, far below the ridge of about
//   295). The first port's CUDA-core loop could not reach that bound
//   however many bytes it had in flight: each weight took an I2F
//   conversion (16 a clock per SM on compute capability 9.0, about
//   3.7e12 a second on 132 SMs against the 3.35e12 weight bytes a second
//   of the bound) and M fp32 FMAs. So this route runs on the tensor
//   cores:
//   * A block of 8 warps owns a strip of 128 output columns and a range
//     of K; each warp streams every 8th 16-deep slab of the range (2 KB
//     of int8, with the slab's rows of x) into its own ring of
//     kMmaStages shared-memory slots by cp.async, 16-byte chunks
//     XOR-swizzled so that the fragment reads below hit no bank twice:
//     up to 160 KB in flight per SM.
//   * Widening without I2F: a lane reads 4 slab rows x 16 bytes; each
//     byte, its sign bit flipped, is permuted (prmt) straight from its
//     row's word into the mantissa of 2^23, and 2^23 + 128 is subtracted
//     in fp32; the high halves of two such floats are a bf16 pair
//     (exact: an int8 needs 8 significant bits, bf16 holds 8). Six
//     permutes and four subtractions per four weights, on pipes that run
//     64-128 a clock per SM.
//   * The product: mma.sync m16n8k16 bf16 with fp32 accumulate, x's
//     <= 16 rows as the A fragment (rows past M never loaded, their sums
//     never stored), the widened weights as B fragments, the depth order
//     permuted alike in both (lane t of a quad holds depths 4t .. 4t + 3)
//     and the columns so that a lane's 16 loaded bytes feed 16 column
//     tiles. wgmma would need 64 rows, 4-16x the decode batch; mma.sync
//     takes 16.
//   * K splits over a cluster of up to 8 blocks where the strips give too
//     few blocks (N 2048: 16 strips), as many as stay resident in one
//     wave (`mma_splits` asks the occupancy API: a cluster's blocks share
//     a GPC). The block's warps reduce through shared memory (padded so
//     the stores hit distinct banks); each block then pushes the sums of
//     every block's slice of the strip's columns into that block's inbox
//     in distributed shared memory, and after one cluster barrier each
//     block adds its inbox up: stores to other blocks do not wait as
//     reads do, and no second barrier holds a block until the others
//     have read it. The scale, read into shared memory while the weights
//     stream, multiplies the fp32 sum once, and the result is rounded
//     once. One launch, no workspace.
//   * What is left: each call's fixed part (the launch, the reductions,
//     the cluster barrier, the stores) is a large share of a call that
//     streams 4-17 MB, and the streaming itself runs below the card's
//     rate (PERF.md §6).
// - bf16 prefill rows (M > 16): `int8_tiles_sm90`, the int8 engine's
//   prefill chunks (buckets of 16-512 tokens: 96 calls a chunk on
//   gpt3_1p3b). Bound: bytes at M 128 (the weight once, 2 M FLOP per
//   weight byte), operations at M 512 (past the ridge of about 295). A
//   block owns a 128 x 128 output tile and walks its K range in 64-deep
//   stages through a ring of kTStages slots, warp-specialised:
//   * one thread keeps TMA loads in flight: x's [128 rows][64 k] box
//     with the 128-byte swizzle (wgmma's K-major A) and q's [64 k][128 n]
//     int8 box;
//   * three warps widen each landed int8 box into two [64 k][64 n] bf16
//     boxes laid out as TMA lays out a swizzled bf16 tile, which wgmma
//     reads as its MN-major B: the decode route's byte permutes (no I2F),
//     16 weights a chunk, chunks XOR-placed so the stores hit no bank
//     twice;
//   * two consumer warpgroups run wgmma m64n128k16 (bf16 in, fp32
//     accumulate) on their 64 rows and release each slot once its
//     products retire, so widening, loads and products overlap.
//   Of the two ways to feed int8 to wgmma, this keeps (b), widening in
//   shared memory, over (a), the swapped product outT = qT . xT with qT
//   widened into A's registers: A's register fragment needs, per
//   thread, 8 bytes from 4 different weight rows (byte loads), and its
//   64 rows would be output columns, so a 512-row tile would need 8
//   accumulators of 64 x 64; the widened tile costs 16 KB of shared
//   memory a stage, which the ring has. K splits over a cluster of up to
//   8 blocks where the tiles give fewer blocks than SMs (wo and wdown at
//   M 128: 16 column tiles; `tiles_splits` asks the occupancy API), the
//   sums reduced through distributed shared memory: one launch, no
//   workspace. The scale multiplies the finished fp32 sum once and the
//   result is rounded once. TMA needs 16-byte aligned rows (K % 8 for x,
//   N % 16 for q); otherwise the same kernel's widening warps load both
//   boxes with bounds (kTma false). Left: the per-call fixed part at
//   M 32-128 and the reduction's shared-memory round trip (PERF.md §6).
// - fp32 x at any M: `rows_kernel`, on the fp32 pipes (the tiny fp32
//   models of the tests). A block owns a strip of 32 output columns and
//   up to 16 rows of x; it walks K in chunks of 256 weight rows staged
//   through shared memory, each thread owning one column and all rows of
//   x, and its 8 warps split each chunk's rows. Where 32-column strips
//   give too few blocks for the card, the K range also splits over
//   blocks (grid y); the partial sums then go to an fp32 workspace and
//   `finalize_kernel` adds them, scales and rounds. The split is worked
//   out here (`rows_geometry`) from the card's SM count; the caller asks
//   `pt_int8_matmul_workspace` for the workspace's size.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

// -- fp32 rows ---------------------------------------------------------------
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
template <int MT>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scale, float* __restrict__ out,
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
      const int r = i % kChunk;    // neighbouring threads, neighbouring k
      const int k = k0 + r;
      const int mm = m0 + m;
      xs[r * MT + m] = (k < k_end && mm < M) ? x[(long)mm * K + k] : 0.f;
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
        out[(long)mm * N + n] = s * scale[n];
      } else {
        ws[((long)split * M + mm) * N + n] = s;
      }
    }
  }
}

// the K splits' partial sums added in fp32, scaled once
__global__ void finalize_kernel(const float* __restrict__ ws,
                                const float* __restrict__ scale,
                                float* __restrict__ out, int M, int N,
                                int splits) {
  const long total = (long)M * N;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * total + i];
    out[i] = s * scale[i % N];
  }
}

// -- bf16 decode rows on the tensor cores ----------------------------------
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBlocksPerSm = 2;               // resident at kMmaSmem
constexpr int kMmaRows = 16;                     // rows of x a call takes
constexpr int kStripN = 128;                     // output columns a block
constexpr int kSlabK = 16;                       // weight rows a slab
constexpr int kMmaStages = 4;                    // ring slots per warp
constexpr int kSlabQBytes = kSlabK * kStripN;    // 2 KB of int8
constexpr int kSlabXBytes = kMmaRows * kSlabK * 2;
constexpr int kSlotBytes = kSlabQBytes + kSlabXBytes;
constexpr int kMaxKSplit = 8;                    // the portable cluster
constexpr int kMmaSmem = kMmaWarps * kMmaStages * kSlotBytes;   // 80 KB
// past the ring: the inbox of the cluster's sums of this block's slice
// (other blocks store there while this one may still stream)
constexpr int kInboxBytes = kMmaRows * kStripN * 4;
// after the walk: the warps' sums [warp][row][column], added into warp
// 0's, each 32 columns padded by 4 floats so that the lanes of a store
// phase (rows g, columns 32 t ..) hit distinct banks
constexpr int kRedLd = kStripN + kStripN / 8;    // floats a row
static_assert(kMmaWarps * kMmaRows * kRedLd * 4 <= kMmaSmem,
              "the reduction fits in the ring");

__device__ __forceinline__ int red_col(int c) { return c + (c >> 5) * 4; }

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

__device__ __forceinline__ unsigned word(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b,
                                         unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// the 16-byte chunk c of slab row r sits at chunk c ^ swz(r): the lanes of
// one fragment read (rows 4 t + i, t = 0..3, chunks g) land on 8 distinct
// chunk positions, so no two share a bank
__device__ __forceinline__ int swz(int r) { return ((r >> 2) & 3) << 1; }

// byte j of the weight word u (its sign bit flipped) as an exact fp32:
// the byte goes into the mantissa of 2^23, and 2^23 + 128 comes off
__device__ __forceinline__ float widen(unsigned u, unsigned j) {
  return __uint_as_float(prmt(u, 0x4B000000u, 0x7650u + j)) - 8388736.f;
}

// two floats holding small integers as a bf16 pair (their high halves,
// exact), the first in the low half
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return prmt(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint2 xa, uint2 xb,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(xa.x), "r"(xb.x), "r"(xa.y), "r"(xb.y), "r"(b0), "r"(b1));
}

// out (M <= 16, N) = round((x @ q) * scale), bf16 x. grid: (cluster's K
// splits, strips of 128 columns), cluster (splits, 1, 1); k_per_split a
// multiple of 16. Warp w takes every 8th slab of the block's K range
// from slab w. kVec: N % 16 == 0, K % 8 == 0 and x, q 16-byte aligned
// (cp.async chunks, each whole or past the edge); else the slots are
// filled by threads, byte by byte. Rows of x past M are never loaded:
// their sums are never stored.
//
// Fragments (PTX m16n8k16): lane = 4 g + t. The A fragment holds x rows g
// and g + 8 at fragment depths 2t, 2t + 1, 2t + 8, 2t + 9, which here are
// slab depths 4t .. 4t + 3 (the same permutation in B, so the sum is
// unchanged): 8 contiguous bytes of each row. The B fragment holds one
// column g of an 8-column tile at those depths. Lane (g, t) loads slab
// rows 4t + i (i = 0..3), bytes 16 g .. 16 g + 15 of its columns; byte
// 4 c + j of row 4t + i widens into the B fragment of tile 4 c + j, whose
// fragment column g is column 16 g + 4 c + j. So the accumulators of tile
// T, at fragment columns 2t and 2t + 1, are columns 32 t + T and
// 32 t + 16 + T: lane (g, t) ends holding columns 32 t .. 32 t + 31 of
// rows g and g + 8.
template <bool kVec>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocksPerSm)
int8_rows_sm90(const bf16* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, bf16* __restrict__ out,
               int M, int N, int K, int k_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float sscale[kStripN];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int strip0 = blockIdx.y * kStripN;
  // the strip's scales, read while the weights stream
  for (int c = threadIdx.x; c < kStripN; c += kMmaThreads)
    sscale[c] = strip0 + c < N ? scale[strip0 + c] : 0.f;
  // a block stores into the others' shared memory only once they have all
  // started: arrive now, wait before the first such store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int kb = rank * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  unsigned char* slots = smem + warp * kMmaStages * kSlotBytes;

  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const int nslab = ke > kb ? (ke - kb + kSlabK - 1) / kSlabK : 0;
  const int mine =
      warp < nslab ? (nslab - warp + kMmaWarps - 1) / kMmaWarps : 0;
  // slab j of this warp (depths kb + (warp + 8 j) * 16 ..) into its slot
  auto fill = [&](int j) {
    const int k0 = kb + (warp + j * kMmaWarps) * kSlabK;
    unsigned char* dst = slots + (j % kMmaStages) * kSlotBytes;
#pragma unroll
    for (int p = 0; p < kSlabQBytes / 16 / 32; ++p) {
      const int piece = lane + 32 * p;   // 16 rows x 8 chunks
      const int r = piece >> 3;
      const int c = piece & 7;
      const int k = k0 + r;
      const int n = strip0 + c * 16;
      unsigned char* d = dst + r * kStripN + ((c ^ swz(r)) << 4);
      if constexpr (kVec) {
        const bool ok = k < ke && n < N;
        cp_async16(d, ok ? q + (long)k * N + n : q, ok ? 16 : 0);
      } else {
        alignas(16) unsigned char v[16];
#pragma unroll
        for (int e = 0; e < 16; ++e)
          v[e] = (k < ke && n + e < N)
                     ? static_cast<unsigned char>(q[(long)k * N + n + e])
                     : 0;
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
      }
    }
    // x: its M rows, 2 chunks of 8 bf16 each
    const int r = lane >> 1;
    if (r < M) {
      const int k = k0 + (lane & 1) * 8;
      unsigned char* d = dst + kSlabQBytes + r * (kSlabK * 2) +
                         (lane & 1) * 16;
      if constexpr (kVec) {
        const bool ok = k < ke;
        cp_async16(d, ok ? x + (long)r * K + k : x, ok ? 16 : 0);
      } else {
        alignas(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = k + e < ke ? x[(long)r * K + k + e] : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
      }
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
    __syncwarp();                        // every lane's chunks have landed
    const unsigned char* slot = slots + (j % kMmaStages) * kSlotBytes;
    const unsigned char* xs = slot + kSlabQBytes;
    // A: rows g and g + 8, slab depths 4t .. 4t + 3
    const uint2 xa =
        *reinterpret_cast<const uint2*>(xs + g * (kSlabK * 2) + t * 8);
    const uint2 xb =
        *reinterpret_cast<const uint2*>(xs + (g + 8) * (kSlabK * 2) + t * 8);
    uint4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = *reinterpret_cast<const uint4*>(
          slot + (4 * t + i) * kStripN + ((g ^ swz(4 * t + i)) << 4));
      w[i].x ^= 0x80808080u;
      w[i].y ^= 0x80808080u;
      w[i].z ^= 0x80808080u;
      w[i].w ^= 0x80808080u;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // column 16 g + 4 c + j at depths 4t .. 4t + 3
        const unsigned b0 = bf16_pair(widen(word(w[0], c), j),
                                      widen(word(w[1], c), j));
        const unsigned b1 = bf16_pair(widen(word(w[2], c), j),
                                      widen(word(w[3], c), j));
        mma_bf16(acc[4 * c + j], xa, xb, b0, b1);
      }
    }
    __syncwarp();                        // the slot is read before refill
  }
  cp_async_wait<0>();
  __syncthreads();                       // every ring drained: reduce here

  // [warp][row][column]; lane (g, t): row g from acc[.][0, 1], row g + 8
  // from acc[.][2, 3]; columns 32 t + T and 32 t + 16 + T of tile T
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    if (row < M) {
      float* dst = red + (warp * kMmaRows + row) * kRedLd + red_col(32 * t);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        *reinterpret_cast<float4*>(dst + 4 * v) =
            make_float4(acc[4 * v][2 * h], acc[4 * v + 1][2 * h],
                        acc[4 * v + 2][2 * h], acc[4 * v + 3][2 * h]);
        *reinterpret_cast<float4*>(dst + 16 + 4 * v) = make_float4(
            acc[4 * v][2 * h + 1], acc[4 * v + 1][2 * h + 1],
            acc[4 * v + 2][2 * h + 1], acc[4 * v + 3][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  // the block's sums, each pushed into the inbox of the block that
  // finishes its column: [sender][row][column of the slice]
  const int width = kStripN / splits;
  float* inbox = reinterpret_cast<float*>(smem + kMmaSmem);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = threadIdx.x; i < M * kStripN; i += kMmaThreads) {
    const int m = i / kStripN;
    const int c = i % kStripN;
    const int at = m * kRedLd + red_col(c);
    float s = red[at];
#pragma unroll
    for (int w8 = 1; w8 < kMmaWarps; ++w8)
      s += red[w8 * kMmaRows * kRedLd + at];
    cluster.map_shared_rank(inbox, c / width)[(rank * M + m) * width +
                                             c % width] = s;
  }
  cluster.sync();
  for (int i = threadIdx.x; i < M * width; i += kMmaThreads) {
    const int m = i / width;
    const int c = i % width;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxKSplit; ++r)
      if (r < splits) s += inbox[(r * M + m) * width + c];
    const int n = strip0 + rank * width + c;
    if (n < N)
      out[(long)m * N + n] = __float2bfloat16(s * sscale[rank * width + c]);
  }
}

// -- bf16 prefill rows on TMA + wgmma ---------------------------------------
constexpr int kTM = 128;                 // output rows a block (2 x 64)
constexpr int kTN = 128;                 // output columns a block
constexpr int kTK = 64;                  // stage depth
constexpr int kTStages = 5;
constexpr int kTThreads = 384;           // producer warp + 11 widening warps
constexpr int kTWideners = kTThreads - 32;   // 8 of them also consumers
constexpr uint32_t kTXBytes = kTM * kTK * 2;      // x: [128 rows][64 k]
constexpr uint32_t kTWBytes = kTK * kTN * 2;      // q widened: 2 boxes
constexpr uint32_t kTQBytes = kTK * kTN;          // q raw: [64 k][128 n]
constexpr uint32_t kTStageBytes = kTXBytes + kTWBytes + kTQBytes;
// after the mainloop the ring holds the cluster's fp32 tile sums, each
// row padded so that a warp's stores of one column pair spread over banks
constexpr int kTRedLd = kTN + 4;
static_assert(kTM * kTRedLd * 4 <= kTStages * kTStageBytes,
              "the sums fit in the ring");
constexpr int kTSmem = kTStages * kTStageBytes + 2 * kTStages * 8 + 1024;
constexpr int kTMaxSplit = 8;            // the portable cluster

// 16 int8 weights (one 16-byte chunk, sign bits flipped) widened to
// bf16, columns n .. n + 15 of row k, stored into a [64 k][64 n] bf16
// box with the 128-byte swizzle TMA would give it: the 16-byte chunk
// c of row k at chunk c ^ (k % 8)
__device__ __forceinline__ void widen_chunk(uint4 w, uint32_t box, int k,
                                            int n64) {
  uint32_t pairs[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const unsigned u = word(w, c) ^ 0x80808080u;
    pairs[2 * c] = bf16_pair(widen(u, 0), widen(u, 1));
    pairs[2 * c + 1] = bf16_pair(widen(u, 2), widen(u, 3));
  }
  const int c0 = n64 / 8;                // even: two chunks c0, c0 + 1
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t dst = box + k * 128 + (((c0 + h) ^ (k & 7)) << 4);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(pairs[4 * h]), "r"(pairs[4 * h + 1]),
                 "r"(pairs[4 * h + 2]), "r"(pairs[4 * h + 3])
                 : "memory");
  }
}

// out (M, N) = round((x @ q) * scale), bf16 x, M > 16. grid: (cluster's K
// splits, column tiles, row tiles), cluster (splits, 1, 1);
// k_per_split a multiple of kTK. Block tile 128 x 128 over its K range in
// 64-deep stages through a ring of kTStages slots:
//   warp 0, lane 0 (kTma): TMA loads of x's [128 rows][64 k] box with the
//     128-byte swizzle (wgmma's K-major A) and q's [64 k][128 n] int8
//     box into the slot, completing on full[s], each once the slot's
//     previous stage is released on empty[s];
//   the other 11 warps (kTWideners threads), every stage: widen their
//     share of the landed int8 box into two [64 k][64 n] bf16 boxes laid
//     out as TMA lays out a swizzled bf16 tile (wgmma's MN-major B),
//     fence the async proxy and meet at a named barrier; without kTma
//     they first load both boxes from global memory with bounds;
//   warpgroups 1 and 2 then issue wgmma m64n128k16 on their 64 rows
//     (fp32 accumulate) and go on to widen the next stage while the
//     products run, releasing each slot once its products retire. The
//     products sit in the consumers' own loop: issued from a loop that
//     warpgroup 0 runs too, ptxas serialised them (C7518).
// Widening is the mainloop's largest cost at M <= 128 (3 warps took
// 0.65 us a stage on the H100), so 11 warps share it. Rows past M,
// columns past N and depths past K load as zeros (TMA fills them; the
// bounded loads write them) and are never stored. With one split the
// consumers scale, round and store from registers; with more, every
// block stores its fp32 sums into its own ring, and after a cluster
// barrier each block adds up its slice of the tile's columns from every
// block's shared memory in rank order, scales, rounds and stores it; a
// second barrier keeps the sums alive until all are read.
template <bool kTma>
__global__ void __launch_bounds__(kTThreads, 1)
int8_tiles_sm90(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tq,
                const bf16* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ scale, bf16* __restrict__ out,
                int M, int N, int K, int k_per_split) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + kTStages * kTStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kTStages + s); };
  auto xtile = [&](int s) { return base + s * kTStageBytes; };
  auto wtile = [&](int s) { return xtile(s) + kTXBytes; };
  auto qtile = [&](int s) { return wtile(s) + kTWBytes; };
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.y * kTN;
  const int m0 = blockIdx.z * kTM;
  const int kb = rank * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int nk = ke > kb ? (ke - kb + kTK - 1) / kTK : 0;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // stage it's widening share of this thread (w of kTWideners), then the
  // named barrier that hands the slot's bf16 boxes to wgmma
  auto widen_stage = [&](int it, int w) {
    const int s = it % kTStages;
    const int k0 = kb + it * kTK;
    if constexpr (kTma) {
      mbar_wait(full(s), (it / kTStages) & 1);
      // q's landed box: [64 k][128 n], 512 chunks of 16 bytes, two a
      // step with both loads in flight
      for (int c0 = w; c0 < kTK * kTN / 16; c0 += 2 * kTWideners) {
        uint4 v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = c0 + h * kTWideners;
          if (ci < kTK * kTN / 16)
            asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                         : "=r"(v[h].x), "=r"(v[h].y), "=r"(v[h].z),
                           "=r"(v[h].w)
                         : "r"(qtile(s) + (ci >> 3) * kTN +
                               (ci & 7) * 16));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = c0 + h * kTWideners;
          if (ci < kTK * kTN / 16) {
            const int n = (ci & 7) * 16;
            widen_chunk(v[h], wtile(s) + (n / 64) * kAtom, ci >> 3, n % 64);
          }
        }
      }
    } else {
      // the slot's previous stage (it - kTStages) has retired: the
      // consumers waited on its products before an earlier barrier
      for (int ci = w; ci < kTK * kTN / 16; ci += kTWideners) {
        const int k = ci >> 3;
        const int n = (ci & 7) * 16;
        widen_chunk(load_q16(q, k0 + k, ke, n0 + n, N, false),
                    wtile(s) + (n / 64) * kAtom, k, n % 64);
      }
      // x: [128 rows][64 k], 8 bf16 a chunk, swizzled as TMA would
      for (int ci = w; ci < kTM * kTK / 8; ci += kTWideners) {
        const int r = ci >> 3;
        const int c = ci & 7;
        alignas(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = k0 + c * 8 + e;
          v[e] = m0 + r < M && k < ke ? x[(long)(m0 + r) * K + k]
                                      : __float2bfloat16(0.f);
        }
        const uint4 u = *reinterpret_cast<const uint4*>(v);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         xtile(s) + r * 128 + ((c ^ (r & 7)) << 4)),
                     "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w)
                     : "memory");
      }
    }
    fence_proxy_async();                 // generic stores before wgmma
    asm volatile("bar.sync 1, %0;\n" ::"n"(kTWideners) : "memory");
  };

  if (wg == 0) {
    if (threadIdx.x == 0 && kTma) {
      // the producer: every stage of the range, each once its slot's
      // previous stage has been consumed
      for (int it = 0; it < nk; ++it) {
        const int s = it % kTStages;
        if (it >= kTStages) mbar_wait(empty(s), (it / kTStages - 1) & 1);
        const int k0 = kb + it * kTK;
        mbar_expect_tx(full(s), kTXBytes + kTQBytes);
        tma_load(&tx, xtile(s), full(s), k0, m0);
        tma_load(&tq, qtile(s), full(s), n0, k0);
      }
    } else if (threadIdx.x >= 32) {
      for (int it = 0; it < nk; ++it) widen_stage(it, threadIdx.x - 32);
    }
  } else {
    // the consumers widen too, then issue the stage's products, which run
    // while they widen the next stage
    const int cw = wg - 1;
    float acc[kTN / 2];
#pragma unroll
    for (int i = 0; i < kTN / 2; ++i) acc[i] = 0.f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kTStages;
      widen_stage(it, threadIdx.x - 32);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)
        wgmma_ss_n128<0, 1>(acc, operand_desc<false>(xtile(s), cw, kk),
                            operand_desc<true>(wtile(s), 0, kk), 1);
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();
      if (it > 0 && t == 0) mbar_arrive(empty((it - 1) % kTStages));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // thread t: rows r0 and r0 + 8, columns 8 j + 2 (t % 4) + {0, 1}
    const int r0 = cw * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int c0 = 2 * (t % 4);
    if (splits == 1) {
      const bool pairs = (N & 1) == 0;
#pragma unroll
      for (int j = 0; j < kTN / 8; ++j) {
        const int n = n0 + c0 + 8 * j;
        if (n >= N) continue;
        const float s0 = __ldg(scale + n);
        const float s1 = n + 1 < N ? __ldg(scale + n + 1) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + r0 + 8 * h;
          if (m >= M) continue;
          const float a = acc[4 * j + 2 * h] * s0;
          const float b = acc[4 * j + 2 * h + 1] * s1;
          bf16* o = out + (long)m * N + n;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(o) =
                __floats2bfloat162_rn(a, b);
          } else {
            o[0] = __float2bfloat16(a);
            if (n + 1 < N) o[1] = __float2bfloat16(b);
          }
        }
      }
    } else {
      // every slot is consumed by both warpgroups before the ring is
      // overwritten with the sums
      asm volatile("bar.sync 2, 256;\n" ::: "memory");
      float* red = reinterpret_cast<float*>(
          smem_raw + (base - smem_u32(smem_raw)));
#pragma unroll
      for (int j = 0; j < kTN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(red + (r0 + 8 * h) * kTRedLd + c0 +
                                     8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  if (splits == 1) return;
  cluster.sync();
  // this block's slice of the tile's columns (a multiple of 4 wide, the
  // last rank's narrower or empty), summed over the cluster in rank
  // order, every rank's 16-byte load in flight
  const float* red = reinterpret_cast<const float*>(
      smem_raw + (base - smem_u32(smem_raw)));
  const int width = (kTN / splits + 3) / 4 * 4;
  const int cb = rank * width;
  const int ce = min(kTN, cb + width);
  const int w4 = ce > cb ? (ce - cb) / 4 : 0;
  for (int i = threadIdx.x; i < kTM * w4; i += kTThreads) {
    const int r = i / w4;
    const int c = cb + (i % w4) * 4;
    float4 v[kTMaxSplit];
#pragma unroll
    for (int b = 0; b < kTMaxSplit; ++b)
      if (b < splits)
        v[b] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(red, b) + r * kTRedLd + c);
    float4 sum = v[0];
#pragma unroll
    for (int b = 1; b < kTMaxSplit; ++b)
      if (b < splits) {
        sum.x += v[b].x;
        sum.y += v[b].y;
        sum.z += v[b].z;
        sum.w += v[b].w;
      }
    const int m = m0 + r;
    const float f[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + c + e;
      if (m < M && n < N)
        out[(long)m * N + n] = __float2bfloat16(f[e] * __ldg(scale + n));
    }
  }
  cluster.sync();
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

int launch_rows(const float* x, const int8_t* q, const float* scale,
                float* out, float* ws, int M, int N, int K, int mt,
                int splits, int chunks_per_split, bool vec_q,
                cudaStream_t st) {
  const dim3 grid((N + kStrip - 1) / kStrip, splits, (M + mt - 1) / mt);
  float* part = splits > 1 ? ws : nullptr;
#define PT_ROWS_LAUNCH(MT)                                                 \
  rows_kernel<MT><<<grid, kRowThreads, 0, st>>>(x, q, scale, out, part, M, \
                                                N, K, chunks_per_split,    \
                                                vec_q)
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
  finalize_kernel<<<blocks, 256, 0, st>>>(ws, scale, out, M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

struct RowsGeometry {
  int mt;                // rows of x per block
  int splits;            // K splits over blocks (grid y)
  int chunks_per_split;  // 256-row chunks of q per split
};

// K splits over blocks only where the column strips and row tiles give
// fewer than two blocks per SM of the current device; every split
// non-empty
RowsGeometry rows_geometry(int M, int N, int K) {
  const int sms = sm_count();
  int mt = 1;
  while (mt < M && mt < 16) mt *= 2;
  const long blocks =
      (long)((N + kStrip - 1) / kStrip) * ((M + mt - 1) / mt);
  const int chunks = K > 0 ? (K + kChunk - 1) / kChunk : 1;
  const long want = (2L * sms + blocks - 1) / blocks;
  const int splits = static_cast<int>(want < chunks ? want : chunks);
  const int per = (chunks + splits - 1) / splits;
  return {mt, (chunks + per - 1) / per, per};
}

// The cluster's K splits: doubled while the strips' clusters stay
// resident in one wave (cudaOccupancyMaxActiveClusters: a cluster's
// blocks share a GPC, so fewer fit than SMs x kMmaBlocksPerSm) and every
// warp of a block keeps a slab, up to the portable cluster of 8; a
// failed query returns minus its error
template <bool kVec>
int mma_splits(int N, int K) {
  static int fits[kMaxKSplit + 1] = {};          // clusters resident, by size
  const long strips = (N + kStripN - 1) / kStripN;
  const int slabs = (K + kSlabK - 1) / kSlabK;
  int splits = 1;
  while (splits < kMaxKSplit && slabs >= 2 * splits * kMmaWarps) {
    const int next = 2 * splits;
    if (fits[next] == 0) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(next, 1);
      cfg.blockDim = dim3(kMmaThreads);
      cfg.dynamicSmemBytes = kMmaSmem + kInboxBytes;
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = next;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      int n = 0;
      const cudaError_t err =
          cudaOccupancyMaxActiveClusters(&n, int8_rows_sm90<kVec>, &cfg);
      if (err != cudaSuccess) return -static_cast<int>(err);
      fits[next] = n;
    }
    if (strips > fits[next]) break;
    splits = next;
  }
  return splits;
}

template <bool kVec>
int launch_mma(const bf16* x, const int8_t* q, const float* scale,
               bf16* out, int M, int N, int K, cudaStream_t st) {
  auto kern = int8_rows_sm90<kVec>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMmaSmem + kInboxBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int splits = mma_splits<kVec>(N, K);
  if (splits < 0) return -splits;
  const int slabs = (K + kSlabK - 1) / kSlabK;
  const int k_per_split = (slabs + splits - 1) / splits * kSlabK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + kStripN - 1) / kStripN);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = kMmaSmem + kInboxBytes;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, x, q, scale, out,
                                             M, N, K, k_per_split);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// the map of a row-major (outer, inner) tensor of 1- or 2-byte elements,
// read in boxes {box_inner, box_outer}; entries past the extents read as
// zeros
int map_2d(CUtensorMap* map, CUtensorMapDataType type, int elt,
           const void* p, long inner, long outer, int box_inner,
           int box_outer, CUtensorMapSwizzle swizzle) {
  const sm90::EncodeTiled enc = sm90::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * elt};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = enc(map, type, 2, const_cast<void*>(p), dims, strides,
                         box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The prefill tiles' cluster K splits: the largest cluster, up to the
// portable 8, whose blocks stay within one wave of the card's SMs, whose
// clusters stay resident (cudaOccupancyMaxActiveClusters: a cluster's
// blocks share a GPC, so 8-block clusters may not all fit where 6 do)
// and whose splits keep at least 4 stages each; a failed query returns
// minus its error
template <bool kTma>
int tiles_splits(long tiles, int K) {
  static int fits[kTMaxSplit + 1] = {};          // clusters resident, by size
  const int stages = (K + kTK - 1) / kTK;
  const int sms = sm_count();
  for (int splits = kTMaxSplit; splits > 1; --splits) {
    if (tiles * splits > sms || stages < 4 * splits) continue;
    if (fits[splits] == 0) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(splits, 1, 1);
      cfg.blockDim = dim3(kTThreads);
      cfg.dynamicSmemBytes = kTSmem;
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = splits;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      int n = 0;
      const cudaError_t err =
          cudaOccupancyMaxActiveClusters(&n, int8_tiles_sm90<kTma>, &cfg);
      if (err != cudaSuccess) return -static_cast<int>(err);
      fits[splits] = n > 0 ? n : -1;
    }
    if (tiles <= fits[splits]) return splits;
  }
  return 1;
}

template <bool kTma>
int launch_tiles(const bf16* x, const int8_t* q, const float* scale,
                 bf16* out, int M, int N, int K, cudaStream_t st) {
  auto kern = int8_tiles_sm90<kTma>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kTSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tx = {}, tq = {};
  if (kTma) {
    int rc = map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K, M, kTK,
                    kTM, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc == 0)
      rc = map_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, N, K, kTN, kTK,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc != 0) return rc;
  }
  const int tiles_n = (N + kTN - 1) / kTN;
  const int tiles_m = (M + kTM - 1) / kTM;
  const int splits = tiles_splits<kTma>((long)tiles_n * tiles_m, K);
  if (splits < 0) return -splits;
  const int stages = (K + kTK - 1) / kTK;
  const int k_per_split = (stages + splits - 1) / splits * kTK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, tiles_n, tiles_m);
  cfg.blockDim = dim3(kTThreads);
  cfg.dynamicSmemBytes = kTSmem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, tx, tq, x, q, scale,
                                             out, M, N, K, k_per_split);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// the route of a call: 0 the tensor-core decode rows, 1 the TMA + wgmma
// prefill tiles, 2 the fp32 rows
int route(int dtype, int M) {
  if (dtype != pt::kBFloat16) return 2;
  return M <= kMmaRows ? 0 : 1;
}

}  // namespace

// the kernel a call of these operands launches: 0 `int8_rows_sm90`, 1
// `int8_tiles_sm90`, 2 `rows_kernel` (then `finalize_kernel` where K
// splits)
extern "C" int pt_int8_matmul_route(int dtype, int M) {
  return route(dtype, M);
}

// fp32 elements of the workspace pt_int8_matmul needs for these
// operands (the fp32 route's K splits' partial sums), 0 when it needs
// none
extern "C" long pt_int8_matmul_workspace(int dtype, int M, int N, int K) {
  if (route(dtype, M) != 2) return 0;
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
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  const int r = route(dtype, M);
  if (dtype == pt::kBFloat16) {
    const bf16* xp = static_cast<const bf16*>(x);
    bf16* op = static_cast<bf16*>(out);
    if (r == 0) {
      return vec_x && vec_q
                 ? launch_mma<true>(xp, qp, sp, op, M, N, K, st)
                 : launch_mma<false>(xp, qp, sp, op, M, N, K, st);
    }
    return vec_x && vec_q ? launch_tiles<true>(xp, qp, sp, op, M, N, K, st)
                          : launch_tiles<false>(xp, qp, sp, op, M, N, K,
                                                st);
  }
  if (dtype == pt::kFloat32) {
    const RowsGeometry g = rows_geometry(M, N, K);
    return launch_rows(static_cast<const float*>(x), qp, sp,
                       static_cast<float*>(out), static_cast<float*>(ws), M,
                       N, K, g.mt, g.splits, g.chunks_per_split, vec_q != 0,
                       st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

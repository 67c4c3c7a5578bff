// K1 — flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_fa_forward`, the pl.pallas_call at :213):
// the FlashAttention-2 online-softmax forward, returning the output and
// the per-row log-sum-exp (kept for the backward, K3 and K4).
//
// What it computes, on the (B, S, H, D) layout the public API uses (no
// head-major copy): for query row r of head h, softmax over the keys c
// with c < kv_len[b] and, when causal, c <= r, of (q_r . k_c) * scale +
// bias[b, h, r, c] (an optional fp32 bias, each leading dim full or
// broadcast), times V; GQA query head h reads kv head h / (Hq / Hkv). A
// row with no visible key gives 0 and LSE 0, as on the TPU. With dropout
// the normaliser l sums the un-dropped p, and p . v takes p kept by the
// TPU kernel's hash of (row, col, seed, head) divided by 1 - rate, or 0
// (common.cuh pt::AttnExtra); the row stride of the hash is the padded
// key length of the JAX kernel, which the wrapper passes, and the seed is
// read from the device. The bias and the dropout are template switches:
// a call with neither runs code built without them.
//
// Design. A block owns a query tile; a loop inside the block walks the
// key tiles and carries the running (m, l, acc), which replaces the TPU's
// sequential `nk` grid axis and its VMEM scratch. Causal tiles above the
// diagonal and tiles at or past kv_len are never loaded. Scores use the
// same -1e30 floor on the running max as the TPU kernel, so a fully
// masked tile contributes exactly 0, and p is rounded to the input dtype
// for p . v, as there. Two paths:
//  - bf16 with D % 16 == 0: `flash_fwd_sm90` below, 128-row query tiles,
//    a TMA ring of K/V tiles of 128 keys (two stages) or 64 keys (three
//    stages; the caller's `block_k`, which ops/flash_attention.py resolves
//    from an explicit argument, the autotune cache or the default 128),
//    warp-specialised wgmma with S, the softmax and the output
//    accumulator in registers (sm90.cuh holds the Hopper pieces);
//  - otherwise: the FP32 pipes. 256 threads, four per query row, each
//    holding 32 of the (zero-padded) 128 dims in registers; 32-key tiles
//    staged in shared memory as fp32 and read as conflict-free float4.
//
// Bound on the H100. At the serving shapes (S = 128..512, D = 128, bf16)
// the function sits below the roofline ridge (about 295 bf16 FLOP per
// byte), so its floor is the bytes of q, k, v and o; at the train shape
// (B 4, S 2048) it is above the ridge, bound by the tensor cores' 989
// TFLOP/s. The bf16 path reads K/V once per 128-row query tile and keeps
// both products on the tensor cores, S and P out of shared memory; the
// softmax of one warpgroup overlaps the other's products.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kBQ = 64;                    // query rows per block
constexpr int kBK = 32;                    // keys per shared-memory tile
constexpr int kDMax = 128;                 // largest head_dim
constexpr int kTPR = 4;                    // threads per query row
constexpr int kThreads = kBQ * kTPR;       // 256
constexpr int kC4 = kDMax / 4;             // float4 chunks per row (32)
constexpr int kCPT = kC4 / kTPR;           // float4 chunks per thread (8)

template <typename T, typename Ex>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_lens,
                 T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk,
                 int Hq, int Hkv, int D, int causal, float scale, Ex ex) {
  __shared__ float4 ks[kBK][kC4];
  __shared__ float4 vs[kBK][kC4];
  ex.load_seed();

  const int bh = blockIdx.x;               // b * Hq + h
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int part = tid % kTPR;             // which interleaved dim chunks
  const int row = q0 + tid / kTPR;
  const bool row_ok = row < Sq;

  int kvlen = Sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[b], Sk));
  // block-uniform key bound: keys past the tile's last row are masked
  // for every row of a causal tile, so those tiles are never loaded
  int kend = kvlen;
  if (causal) kend = min(kend, q0 + kBQ);

  // this thread's slice of the query row: chunk c = part + kTPR * i holds
  // dims 4c..4c+3 (interleaved, so the four threads of a row read four
  // neighbouring float4 of a shared tile row: no bank conflicts)
  float4 qr[kCPT];
  const T* qrow = q + ((long)(b * Sq + row) * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < kCPT; ++i) {
    const int d0 = 4 * (part + kTPR * i);
    qr[i] = pt::load4(qrow + d0, row_ok ? min(4, D - d0) : 0);
  }
  float4 acc[kCPT];
#pragma unroll
  for (int i = 0; i < kCPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                       // previous tile fully consumed
    for (int e = tid; e < kBK * kC4; e += kThreads) {
      const int kr = e / kC4;
      const int c = e % kC4;
      const int key = k0 + kr;
      const int d0 = 4 * c;
      const int n = key < Sk ? min(4, D - d0) : 0;
      const long off = ((long)(b * Sk + key) * Hkv + hk) * D + d0;
      ks[kr][c] = pt::load4(k + off, n);
      vs[kr][c] = pt::load4(v + off, n);
    }
    __syncthreads();

    float s[kBK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kCPT; ++i) {
        const float4 kk = ks[j][part + kTPR * i];
        dot += qr[i].x * kk.x + qr[i].y * kk.y + qr[i].z * kk.z +
               qr[i].w * kk.w;
      }
      // the four threads of a row are neighbouring lanes
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int col = k0 + j;
      const bool ok = row_ok && col < kvlen && (!causal || col <= row);
      s[j] = ok ? ex.logit(dot, scale, b, h, row, col) : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(fmaxf(m, tmax), pt::kMaxFloor);
    const float alpha = __expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kCPT; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = __expf(s[j] - m_new);
      psum += p;                           // l sums the un-dropped p
      // as the TPU rounds p for p . v
      const float pr = pt::round_to<T>(ex.drop(p, bh, row, k0 + j));
#pragma unroll
      for (int i = 0; i < kCPT; ++i) {
        const float4 vv = vs[j][part + kTPR * i];
        acc[i].x += pr * vv.x;
        acc[i].y += pr * vv.y;
        acc[i].z += pr * vv.z;
        acc[i].w += pr * vv.w;
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (!row_ok) return;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* orow = o + ((long)(b * Sq + row) * Hq + h) * D;
#pragma unroll
  for (int i = 0; i < kCPT; ++i) {
    const int d0 = 4 * (part + kTPR * i);
    float4 r = acc[i];
    r.x *= inv;
    r.y *= inv;
    r.z *= inv;
    r.w *= inv;
    pt::store4(orow + d0, r, min(4, D - d0));
  }
  if (part == 0) {
    lse[(long)bh * Sq + row] =
        (m == -INFINITY ? 0.f : m) + logf(l == 0.f ? 1.f : l);
  }
}


// ---- bf16 on the tensor cores: TMA + wgmma (D % 16 == 0) ------------------
//
// One block of three warpgroups per (b * Hq + h, 128-row query tile),
// causal tiles longest first. Warpgroup 0 is the producer: one thread
// loads the Q tile once and keeps a ring of ST (K tile, V tile) pairs of
// TK keys in flight by TMA (4D maps over (D, H, S, B), 64-dim boxes of TK
// rows, 128-byte swizzle; rows past S and dims past D arrive as zeros).
// TK is 128 (ST 2) or 64 (ST 3: the halved tiles leave room for a third
// stage). Warpgroups 1 and 2 each own 64 query rows. Per key tile:
//   S = Q . K^T      wgmma m64nTKk16, both operands K-major in shared
//                    memory (SS), into TK / 2 fp32 registers a thread;
//   softmax          on those registers: the scale, the bias, the masks
//                    (only on a tile the diagonal, kv_len, Sq or a
//                    ragged K tile cuts), the running max with the -1e30
//                    floor and each thread's part of the running sum,
//                    two quad shuffles per row for the max;
//   O += P . V       p dropped by the hash at its (row, col), rounded to
//                    bf16 and packed in registers as the A operand of
//                    wgmma m64nDk16 (RS); V is the MN-major B operand.
// O stays in registers, rescaled there; S and P never touch shared
// memory. Within a warpgroup the two products and the softmax run in
// turn; the other warpgroup's work fills the gaps. (Issuing the next
// tile's S behind the current P . V made ptxas serialize the wgmmas,
// C7515, and ran slower on an H100.) A third ring stage bought nothing
// at TK 128. Head dims up to 64 run the 64 instance, others up to 128 the
// 128 one (zero-filled past D, stores masked to D). Every mask (causal,
// kv_len, Sq), the bias read and the dropout hash take absolute (row,
// col) indices, so the key tile changes none of them; nor the LSE.

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kTq = 128;                   // query rows per block
constexpr int kWgThreads = 384;            // producer + two consumers
constexpr uint32_t kQBox = kTq * 128;      // a 64-dim box of the Q tile

// DP: the instance's head dim (64 or 128); TK: keys a stage; ST: stages
template <int DP, int TK, int ST>
struct FwdSmem {                           // byte offsets from the base
  static constexpr uint32_t kKVBox = TK * 128;          // a 64-dim K/V box
  static constexpr uint32_t kQ = (DP / 64) * kQBox;     // the Q tile
  static constexpr uint32_t kKV = (DP / 64) * kKVBox;   // a K or V tile
  static constexpr uint32_t kStage = 2 * kKV;
  static constexpr uint32_t kBars = kQ + ST * kStage;
  // the tiles, q / full / empty barriers, slack to align to 1024 bytes
  // (ops/geometry.py flash_smem counts the same)
  static constexpr int kBytes = kBars + (1 + 2 * ST) * 8 + 1024;
};

// S (64 x TK) = the warpgroup's 64 rows of Q (at qs) . the K tile (at
// ks)^T over DP dims, issued and committed
template <int DP, int TK>
__device__ __forceinline__ void issue_scores(float (&s)[TK / 2],
                                             uint32_t qs, uint32_t ks,
                                             int cw) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<TK, 0, 0>(
        s, gmma_desc(qs + (kk / 4) * kQBox + off + cw * 64 * 128, 16, 1024),
        gmma_desc(ks + (kk / 4) * (TK * 128) + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// the online-softmax step of one key tile on the S registers (rows row0
// and row0 + 8, columns c0 + 8 j + {0, 1}): the running max m and this
// thread's part of the running sum l of each row, acc rescaled, and the
// dropped p in bf16 as the A operand of P . V (p[k]: keys 16 k ..)
template <bool kMasked, int DP, int TK, typename Ex>
__device__ __forceinline__ void softmax_tile(
    float (&s)[TK / 2], float (&acc)[DP / 2], uint32_t (&p)[TK / 16][4],
    float (&m)[2], float (&l)[2], const Ex& ex, int b, int h, int row0,
    int c0, int Sq, int kvlen, int causal, float scale) {
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) {
    const int row = row0 + (i & 2) * 4;
    const int col = c0 + 8 * (i / 4) + (i & 1);
    const bool ok =
        !kMasked || (row < Sq && col < kvlen && (!causal || col <= row));
    s[i] = ok ? ex.logit(s[i], scale, b, h, row, col) : -INFINITY;
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 2 * r; i < TK / 2; i += 4)
      mx = fmaxf(mx, fmaxf(s[i], s[i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(fmaxf(m[r], mx), pt::kMaxFloor);
    alpha[r] = __expf(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
  const unsigned bh = blockIdx.x;
#pragma unroll
  for (int i = 0; i < TK / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = row0 + 8 * r;
    const int col = c0 + 8 * (i / 4);
    const float p0 = __expf(s[i] - m[r]);
    const float p1 = __expf(s[i + 1] - m[r]);
    l[r] += p0 + p1;                       // l sums the un-dropped p
    p[i / 8][(i % 8) / 2] =
        pack_bf16(ex.scaled(p0, ex.kept(bh, row, col)),
                  ex.scaled(p1, ex.kept(bh, row, col + 1)));
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

template <int DP, int TK, int ST, typename Ex>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const int* __restrict__ kv_lens, bf16* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
               int D, int causal, float scale, Ex ex) {
  using L = FwdSmem<DP, TK, ST>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qbar = base + L::kBars;
  const uint32_t full = qbar + 8;          // full[s] at full + 8 s
  const uint32_t empty = full + 8 * ST;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // causal query tiles longest first, so the last wave is the shortest
  const int qt = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * kTq;
  int kvlen = Sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[b], Sk));
  // key tiles up to kv_len and, when causal, the diagonal (Sq == Sk)
  const int kend = causal ? min(kvlen, q0 + kTq) : kvlen;
  const int nt = (kend + TK - 1) / TK;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread loads Q, then keeps ST K/V tiles in flight
    regs_dec<24>();
    if (threadIdx.x == 0 && nt > 0) {
      mbar_expect_tx(qbar, L::kQ);
      for (int c = 0; c < DP / 64; ++c)
        tma_load_4d(&tq, base + c * kQBox, qbar, 64 * c, h, q0, b);
      for (int j = 0; j < nt; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(empty + 8 * s, (j / ST - 1) & 1);
        const uint32_t tile = base + L::kQ + s * L::kStage;
        mbar_expect_tx(full + 8 * s, L::kStage);
        for (int c = 0; c < DP / 64; ++c) {
          tma_load_4d(&tk, tile + c * L::kKVBox, full + 8 * s, 64 * c, hk,
                      j * TK, b);
          tma_load_4d(&tv, tile + L::kKV + c * L::kKVBox, full + 8 * s,
                      64 * c, hk, j * TK, b);
        }
      }
    }
  } else {
    regs_inc<240>();
    ex.load_seed();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int r_first = q0 + 64 * cw;      // the warpgroup's first row
    const int row0 = r_first + 16 * (t / 32) + (t % 32) / 4;
    const int cq = 2 * (t % 4);
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    if (nt > 0) {
      float s[TK / 2];
      uint32_t p[TK / 16][4];
      mbar_wait(qbar, 0);
      for (int j = 0; j < nt; ++j) {
        const int st = j % ST;
        const uint32_t ks = base + L::kQ + st * L::kStage;
        mbar_wait(full + 8 * st, (j / ST) & 1);
        issue_scores<DP, TK>(s, base, ks, cw);
        wgmma_wait<0>();
        fence_acc(s);
        const int k0 = j * TK;
        const bool whole = k0 + TK <= kvlen &&
                           (!causal || k0 + TK - 1 <= r_first) &&
                           r_first + 64 <= Sq;
        if (whole)
          softmax_tile<false, DP, TK>(s, acc, p, m, l, ex, b, h, row0,
                                      k0 + cq, Sq, kvlen, causal, scale);
        else
          softmax_tile<true, DP, TK>(s, acc, p, m, l, ex, b, h, row0,
                                     k0 + cq, Sq, kvlen, causal, scale);
        fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) fence_regs(p[kk]);
        wgmma_fence();
        // V as the MN-major B operand: 16 keys (two 8-row groups, 2048
        // bytes) a slice, the next 64 dims one box (kKVBox) on
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk)
          wgmma_rs<DP, 1>(acc, p[kk],
                          gmma_desc(ks + L::kKV + kk * 2048, L::kKVBox,
                                    1024),
                          1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) fence_regs(p[kk]);
        // the tile's K and V are read: release the stage
        if (t == 0) mbar_arrive(empty + 8 * st);
      }
    }
    // a row with no visible key gives 0 and LSE 0, as on the TPU
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      bf16* orow = o + (static_cast<long>(b * Sq + row) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                    acc[4 * j + 2 * r + 1] * inv);
      }
      if (cq == 0)
        lse[static_cast<long>(bh) * Sq + row] =
            l[r] == 0.f ? 0.f : m[r] + logf(l[r]);
    }
  }
}

// K1 on the tensor cores for head dims up to DP, TK keys a stage, ST
// stages
template <int DP, int TK, int ST, typename Ex>
int launch_fwd_sm90(const void* q, const void* k, const void* v,
                    const int* lens, void* o, float* lse, int B, int Sq,
                    int Sk, int Hq, int Hkv, int D, int causal, float scale,
                    const Ex& ex, cudaStream_t st) {
  using L = FwdSmem<DP, TK, ST>;
  CUtensorMap tq, tk, tv;
  int rc = bshd_map(&tq, q, B, Sq, Hq, D, kTq);
  if (rc == 0) rc = bshd_map(&tk, k, B, Sk, Hkv, D, TK);
  if (rc == 0) rc = bshd_map(&tv, v, B, Sk, Hkv, D, TK);
  if (rc != 0) return rc;
  const auto kernel = flash_fwd_sm90<DP, TK, ST, Ex>;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes));
  if (rc != 0) return rc;
  const dim3 grid(B * Hq, (Sq + kTq - 1) / kTq);
  kernel<<<grid, kWgThreads, L::kBytes, st>>>(
      tq, tk, tv, lens, static_cast<bf16*>(o), lse, Sq, Sk, Hq, Hkv, D,
      causal, scale, ex);
  return static_cast<int>(cudaGetLastError());
}

// the sm90 instance of key tile block_k (64: three stages; 128: two) at
// head dims up to DP
template <int DP, typename Ex>
int launch_fwd_tile(int block_k, const void* q, const void* k,
                    const void* v, const int* lens, void* o, float* lse,
                    int B, int Sq, int Sk, int Hq, int Hkv, int D,
                    int causal, float scale, const Ex& ex, cudaStream_t st) {
  if (block_k == 64)
    return launch_fwd_sm90<DP, 64, 3>(q, k, v, lens, o, lse, B, Sq, Sk, Hq,
                                      Hkv, D, causal, scale, ex, st);
  if (block_k == 128)
    return launch_fwd_sm90<DP, 128, 2>(q, k, v, lens, o, lse, B, Sq, Sk,
                                       Hq, Hkv, D, causal, scale, ex, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o (B, Sq, Hq, D) all contiguous
// and of one dtype; kv_lens (B,) int32 or null; lse (B * Hq, Sq) fp32;
// bias fp32 or null, read at b * sb + h * sh + row * sq + col; seed the
// device int32 seed of the dropout (null for none), the other dropout
// arguments as in pt::AttnExtra. block_k: the key tile, 64 or 128 on the
// tensor cores (bf16, D % 16 == 0), kBK (32) on the FP32 pipes. The
// caller guarantees D <= 128, Hq % Hkv == 0 and non-empty shapes.
extern "C" int pt_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_lens, void* o, void* lse, int B, int Sq, int Sk, int Hq,
    int Hkv, int D, int causal, float scale, const void* bias,
    long long sb, long long sh, long long sq, const void* seed,
    unsigned thresh, float keep_div, int stride, int block_k,
    void* stream) {
  const pt::AttnArgs args{static_cast<const float*>(bias), sb, sh, sq,
                          static_cast<const int*>(seed), thresh, keep_div,
                          stride};
  const dim3 grid(B * Hq, (Sq + kBQ - 1) / kBQ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_lens);
  float* lse_f = static_cast<float*>(lse);
  return pt::with_attn_extra(args, [&](auto ex) -> int {
    using Ex = decltype(ex);
    if (dtype == pt::kBFloat16 && D % 16 == 0) {
      return D <= 64
                 ? launch_fwd_tile<64>(block_k, q, k, v, lens, o, lse_f, B,
                                       Sq, Sk, Hq, Hkv, D, causal, scale,
                                       ex, st)
                 : launch_fwd_tile<128>(block_k, q, k, v, lens, o, lse_f, B,
                                        Sq, Sk, Hq, Hkv, D, causal, scale,
                                        ex, st);
    }
    if (block_k != kBK) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == pt::kBFloat16) {
      using T = __nv_bfloat16;
      flash_fwd_kernel<T, Ex><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), lens, static_cast<T*>(o), lse_f, Sq,
          Sk, Hq, Hkv, D, causal, scale, ex);
    } else if (dtype == pt::kFloat32) {
      flash_fwd_kernel<float, Ex><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), lens, static_cast<float*>(o),
          lse_f, Sq, Sk, Hq, Hkv, D, causal, scale, ex);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// K3 + K4 — flash attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
// `_bwd_dkdv_kernel` (:258, launched at :395) — K3, dK and dV — and
// `_bwd_dq_kernel` (:313, launched at :433) — K4, dQ — which `_fa_backward`
// (:359) runs after the forward K1. Both recompute the attention
// probabilities from the log-sum-exp K1 saved (`_recompute_p`, :244):
//
//   p  = exp(q . k * scale + bias - lse)   (0 where the key is masked)
//   dp = dO . v
//   ds = p * (dp - delta) * scale   with delta = rowsum(dO * O)
//   K3: dv += p * dO,  dk += ds * q      K4: dq += ds * k
//
// With dropout the forward's mask is replayed from the seed on the device
// (common.cuh pt::AttnExtra): dv takes the dropped p (keep * p /
// (1 - rate)) and dp is masked and scaled the same way, while ds
// multiplies the un-dropped p, as in the JAX kernels (:292-302,
// :346-349). The bias is a constant (no gradient), as there. Bias and
// dropout are template switches, so the GPT paths, which use neither,
// run code built without them.
//
// `delta` (B * Hq, Sq) fp32 comes from plain PyTorch (the JAX code also
// computes it outside the kernel, :365). Layout (B, S, H, D), as the
// public API and K1 use; GQA query head h reads kv head h / (Hq / Hkv).
// The masking is K1's: keys at or past kv_len[b] and, when causal, keys
// after the query row.
//
// Design. Hopper blocks run in no order, so the TPU's sequential
// ("arbitrary") grid axis and its VMEM accumulator become a loop inside
// one block that owns its output tile; nothing is reduced across blocks
// and nothing is written twice. K4: a block per (b * Hq + h, 64-row
// query tile) walks the key tiles that the causal mask and kv_len leave
// visible, as K1 does. K3: a block per (b * Hkv + kv head, 64-key tile)
// walks every query head of the GQA group and, for each, the query tiles
// from the first one the causal mask lets see the key tile; summing the
// group inside the block replaces the JAX code's per-query-head dk/dv and
// its group sum (:412-414); a key tile at or past kv_len writes zeros.
// As on the TPU, p and ds are rounded to the input dtype before their
// products. Two paths:
//  - bf16 with D % 16 == 0 (the train path): tensor cores. Per tile,
//    S = q . k^T and dP = dO . v^T (64 x 64, wmma 16x16x16, bf16 in, fp32
//    accumulate) go through shared memory, where the 256 threads form p
//    and ds; the dq (or dk and dv) accumulators stay in fp32 fragments
//    for the whole walk, and the tiles of q, k, v and dO are staged in
//    shared memory with 16-byte loads.
//  - otherwise (fp32): the FP32 pipes, four threads per row each holding
//    32 of the (zero-padded) 128 dims of its row's operands and
//    accumulators in registers, the other side staged as fp32 in 32-row
//    shared tiles read as conflict-free float4.
//
// Bound on the H100. At the train shape (B 4, S 2048, 16 heads of 128,
// causal, bf16) the work is 8 (K3) and 6 (K4) flops per dim of each of
// the 134 M visible (query, key) pairs, about 137 and 103 GFLOP, against
// some 200 MB of inputs and outputs: above the ridge, so the bound is the
// tensor cores' 989 TFLOP/s (about 0.14 and 0.10 ms). The wmma path (one
// 123 KB block per SM, two barriers per stage, no TMA or wgmma) reaches a
// fraction of that; a warp-specialised wgmma design is later work
// (ROADMAP R1). The fp32 path is bound by the FP32 pipes (67 TFLOP/s).
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int kDMax = 128;                 // largest head_dim
constexpr int kTPR = 4;                    // threads per row
constexpr int kThreads = 256;
constexpr int kRows = kThreads / kTPR;     // rows a block owns (64)
constexpr int kTile = 32;                  // rows per shared-memory tile
constexpr int kC4 = kDMax / 4;             // float4 chunks per row (32)
constexpr int kCPT = kC4 / kTPR;           // float4 chunks per thread (8)

// sum over the four neighbouring lanes that share a row
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// this thread's slice of a row: chunk c = part + kTPR * i holds dims
// 4c..4c+3 (interleaved, so the four threads of a row read neighbouring
// float4 of a shared tile row: no bank conflicts)
template <typename T>
__device__ __forceinline__ void load_row(float4 (&r)[kCPT], const T* p,
                                         int part, int D, bool ok) {
#pragma unroll
  for (int i = 0; i < kCPT; ++i) {
    const int d0 = 4 * (part + kTPR * i);
    r[i] = pt::load4(p + d0, ok ? min(4, D - d0) : 0);
  }
}

template <typename T>
__device__ __forceinline__ void store_row(T* p, const float4 (&r)[kCPT],
                                          int part, int D) {
#pragma unroll
  for (int i = 0; i < kCPT; ++i) {
    const int d0 = 4 * (part + kTPR * i);
    pt::store4(p + d0, r[i], min(4, D - d0));
  }
}

__device__ __forceinline__ void zero_row(float4 (&r)[kCPT]) {
#pragma unroll
  for (int i = 0; i < kCPT; ++i) r[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// rows r0.. of a (B, S, H, D) tensor at (b, h) into a shared fp32 tile
template <typename T>
__device__ __forceinline__ void stage(float4 (*dst)[kC4], const T* src,
                                      int b, int r0, int S, int H, int h,
                                      int D) {
  for (int e = threadIdx.x; e < kTile * kC4; e += kThreads) {
    const int rr = e / kC4;
    const int c = e % kC4;
    const int row = r0 + rr;
    const int n = row < S ? min(4, D - 4 * c) : 0;
    dst[rr][c] = pt::load4(src + ((long)(b * S + row) * H + h) * D + 4 * c,
                           n);
  }
}

// K4: dq for one (b * Hq + h, 64-row query tile)
template <typename T, typename Ex>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_lens, T* __restrict__ dq,
                    int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                    float scale, Ex ex) {
  __shared__ float4 ks[kTile][kC4];
  __shared__ float4 vs[kTile][kC4];
  ex.load_seed();

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * kRows;
  const int part = threadIdx.x % kTPR;
  const int row = q0 + threadIdx.x / kTPR;
  const bool row_ok = row < Sq;

  int kvlen = Sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[b], Sk));
  // block-uniform key bound, as in K1: causal tiles above the block's
  // last row and tiles at or past kv_len are never loaded
  int kend = kvlen;
  if (causal) kend = min(kend, q0 + kRows);

  const long qoff = ((long)(b * Sq + row) * Hq + h) * D;
  float4 qr[kCPT], dor[kCPT], acc[kCPT];
  load_row(qr, q + qoff, part, D, row_ok);
  load_row(dor, dout + qoff, part, D, row_ok);
  zero_row(acc);
  const float lse_r = row_ok ? lse[(long)bh * Sq + row] : 0.f;
  const float delta_r = row_ok ? delta[(long)bh * Sq + row] : 0.f;

  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();                       // previous tile fully consumed
    stage(ks, k, b, k0, Sk, Hkv, hk, D);
    stage(vs, v, b, k0, Sk, Hkv, hk, D);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kCPT; ++i) {
        s += pt::dot4(qr[i], ks[j][part + kTPR * i]);
        dp += pt::dot4(dor[i], vs[j][part + kTPR * i]);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int col = k0 + j;
      const bool ok = row_ok && col < kvlen && (!causal || col <= row);
      const float p =
          ok ? __expf(ex.logit(s, scale, b, h, row, col) - lse_r) : 0.f;
      dp = ex.drop(dp, bh, row, col);
      const float ds = pt::round_to<T>(p * (dp - delta_r) * scale);
#pragma unroll
      for (int i = 0; i < kCPT; ++i)
        pt::axpy4(acc[i], ds, ks[j][part + kTPR * i]);
    }
  }
  if (row_ok) store_row(dq + qoff, acc, part, D);
}

// K3: dk and dv for one (b * Hkv + hk, 64-key tile), summed over the
// query heads of the GQA group
template <typename T, typename Ex>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ kv_lens, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
                      int D, int causal, float scale, Ex ex) {
  __shared__ float4 qs[kTile][kC4];
  __shared__ float4 dos[kTile][kC4];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  ex.load_seed();

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * kRows;
  const int part = threadIdx.x % kTPR;
  const int key = k0 + threadIdx.x / kTPR;
  const bool key_ok = key < Sk;

  int kvlen = Sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[b], Sk));

  const long koff = ((long)(b * Sk + key) * Hkv + hk) * D;
  float4 kr[kCPT], vr[kCPT], dk_acc[kCPT], dv_acc[kCPT];
  load_row(kr, k + koff, part, D, key_ok);
  load_row(vr, v + koff, part, D, key_ok);
  zero_row(dk_acc);
  zero_row(dv_acc);

  // causal: query rows before k0 see none of these keys (block-uniform)
  const int qstart = causal ? (k0 / kTile) * kTile : 0;
  const int qend = k0 < kvlen ? Sq : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long bh = (long)b * Hq + h;
    for (int r0 = qstart; r0 < qend; r0 += kTile) {
      __syncthreads();                     // previous tile fully consumed
      stage(qs, q, b, r0, Sq, Hq, h, D);
      stage(dos, dout, b, r0, Sq, Hq, h, D);
      if (threadIdx.x < kTile) {
        const int row = r0 + threadIdx.x;
        lse_s[threadIdx.x] = row < Sq ? lse[bh * Sq + row] : 0.f;
        delta_s[threadIdx.x] = row < Sq ? delta[bh * Sq + row] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kTile; ++i) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < kCPT; ++c) {
          s += pt::dot4(kr[c], qs[i][part + kTPR * c]);
          dp += pt::dot4(vr[c], dos[i][part + kTPR * c]);
        }
        s = row_sum(s);
        dp = row_sum(dp);
        const int row = r0 + i;
        const bool ok = key_ok && row < Sq && key < kvlen &&
                        (!causal || key <= row);
        const float p =
            ok ? __expf(ex.logit(s, scale, b, h, row, key) - lse_s[i]) : 0.f;
        dp = ex.drop(dp, bh, row, key);
        const float ds = pt::round_to<T>(p * (dp - delta_s[i]) * scale);
        const float pr = pt::round_to<T>(ex.drop(p, bh, row, key));
#pragma unroll
        for (int c = 0; c < kCPT; ++c) {
          pt::axpy4(dv_acc[c], pr, dos[i][part + kTPR * c]);
          pt::axpy4(dk_acc[c], ds, qs[i][part + kTPR * c]);
        }
      }
    }
  }
  if (key_ok) {
    store_row(dk + koff, dk_acc, part, D);
    store_row(dv + koff, dv_acc, part, D);
  }
}


// ---- tensor-core path (bf16, D % 16 == 0) ----------------------------------
//
// The same two kernels on the tensor cores (wmma 16x16x16, bf16 in, fp32
// accumulate). A block owns 64 rows (K4: queries, K3: keys) and walks
// 64-row tiles of the other side. Per tile, S = q . k^T and dP = dO . v^T
// (64 x 64) go through shared memory in fp32, where the 256 threads form
// p and ds and round them to bf16, as the TPU kernels do before their
// dots (`p.astype(do.dtype)`, `ds.astype(q.dtype)`); the dq, dk and dv
// accumulators stay in fp32 fragments for the whole walk.

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kT = 64;                     // rows per block and per tile
constexpr int kLd = kDMax + 8;             // bf16 row stride of q/k/v/dO
constexpr int kLs = kT + 4;                // fp32 row stride of S and dP
constexpr int kLp = kT + 8;                // bf16 row stride of p and ds
constexpr int kLo = kDMax + 4;             // fp32 row stride, output
constexpr int kTileB = kT * kLd * 2;       // one staged q/k/v/dO tile
constexpr int kScoreB = kT * kLs * 4;      // S or dP
constexpr int kPB = kT * kLp * 2;          // p or ds
static_assert(2 * kScoreB >= kT * kLo * 4, "output staging fits S + dP");
// [a][b][c][d] tiles, S, dP, p, ds, then 2 x 64 floats of row terms
constexpr int kTcSmem = 4 * kTileB + 2 * kScoreB + 2 * kPB + 2 * kT * 4;

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                                wmma::row_major>;
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                                wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                                wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                                wmma::col_major>;

// 64 rows r0.. of a (B, S, H, D) bf16 tensor at (b, h) into a shared
// [64][kLd] tile, 16 bytes a thread at a time; rows past S are zero
__device__ __forceinline__ void stage_tc(bf16* dst, const bf16* src, int b,
                                         int r0, int S, int H, int h,
                                         int D) {
  const int chunks = D / 8;
  for (int e = threadIdx.x; e < kT * chunks; e += kThreads) {
    const int rr = e / chunks, c = (e % chunks) * 8;
    const int row = r0 + rr;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < S)
      v = *reinterpret_cast<const uint4*>(
          src + ((long)(b * S + row) * H + h) * D + c);
    *reinterpret_cast<uint4*>(dst + rr * kLd + c) = v;
  }
}

// S = a . b^T and dP = c . d^T over D, both 64 x 64 fp32 into shared
// memory; warp w owns rows 16 (w / 2) and columns 32 (w % 2) .. +32
__device__ __forceinline__ void scores_tc(const bf16* a, const bf16* b,
                                          const bf16* c, const bf16* d,
                                          float* s, float* dp, int D) {
  const int w = threadIdx.x / 32;
  const int m0 = (w / 2) * 16, n0 = (w % 2) * 32;
  FragAcc fs[2], fd[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::fill_fragment(fs[j], 0.f);
    wmma::fill_fragment(fd[j], 0.f);
  }
  for (int k = 0; k < D; k += 16) {
    FragARow fa, fc;
    wmma::load_matrix_sync(fa, a + m0 * kLd + k, kLd);
    wmma::load_matrix_sync(fc, c + m0 * kLd + k, kLd);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      FragBCol fb, fdd;
      wmma::load_matrix_sync(fb, b + (n0 + j * 16) * kLd + k, kLd);
      wmma::load_matrix_sync(fdd, d + (n0 + j * 16) * kLd + k, kLd);
      wmma::mma_sync(fs[j], fa, fb, fs[j]);
      wmma::mma_sync(fd[j], fc, fdd, fd[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(s + m0 * kLs + n0 + j * 16, fs[j], kLs,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(dp + m0 * kLs + n0 + j * 16, fd[j], kLs,
                            wmma::mem_row_major);
  }
}

// write a 64 x D fp32 block of fragments (warp (w / 4, w % 4) owning
// rows 32 (w / 4) .. +32, columns 32 (w % 4) .. +32) to rows r0.. of a
// (B, S, H, D) bf16 tensor at (b, h), through shared memory
__device__ __forceinline__ void store_tc(FragAcc (&acc)[2][2], float* buf,
                                         bf16* dst, int b, int r0, int S,
                                         int H, int h, int D) {
  const int w = threadIdx.x / 32;
  const int m0 = (w / 4) * 32, n0 = (w % 4) * 32;
  __syncthreads();                         // buf (S, dP) is free
  if (n0 < D) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(buf + (m0 + i * 16) * kLo + n0 + j * 16,
                                acc[i][j], kLo, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kT * D; e += kThreads) {
    const int rr = e / D, c = e % D;
    const int row = r0 + rr;
    if (row < S)
      dst[((long)(b * S + row) * H + h) * D + c] =
          __float2bfloat16(buf[rr * kLo + c]);
  }
}

__device__ __forceinline__ void zero_frags(FragAcc (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
}

// K4 on the tensor cores: dq for one (b * Hq + h, 64-row query tile)
template <typename Ex>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const int* __restrict__ kv_lens, bf16* __restrict__ dq,
                int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                float scale, Ex ex) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kT * kLd;
  bf16* ks = dos + kT * kLd;
  bf16* vs = ks + kT * kLd;
  float* ss = reinterpret_cast<float*>(vs + kT * kLd);
  float* dps = ss + kT * kLs;
  bf16* dss = reinterpret_cast<bf16*>(dps + kT * kLs);
  float* lse_s = reinterpret_cast<float*>(dss + 2 * kT * kLp);
  float* delta_s = lse_s + kT;
  ex.load_seed();

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * kT;
  const int tid = threadIdx.x;
  const int w = tid / 32;
  const int m0 = (w / 4) * 32, n0 = (w % 4) * 32;

  int kvlen = Sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[b], Sk));
  int kend = kvlen;
  if (causal) kend = min(kend, q0 + kT);

  stage_tc(qs, q, b, q0, Sq, Hq, h, D);
  stage_tc(dos, dout, b, q0, Sq, Hq, h, D);
  if (tid < kT) {
    const int row = q0 + tid;
    lse_s[tid] = row < Sq ? lse[(long)bh * Sq + row] : 0.f;
    delta_s[tid] = row < Sq ? delta[(long)bh * Sq + row] : 0.f;
  }
  FragAcc acc[2][2];
  zero_frags(acc);
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();                       // previous tile consumed
    stage_tc(ks, k, b, k0, Sk, Hkv, hk, D);
    stage_tc(vs, v, b, k0, Sk, Hkv, hk, D);
    __syncthreads();
    scores_tc(qs, ks, dos, vs, ss, dps, D);
    __syncthreads();
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int rr = e / kT, cc = e % kT;
      const int row = q0 + rr, col = k0 + cc;
      const bool ok = row < Sq && col < kvlen && (!causal || col <= row);
      const float p =
          ok ? __expf(ex.logit(ss[rr * kLs + cc], scale, b, h, row, col) -
                      lse_s[rr])
             : 0.f;
      const float dp = ex.drop(dps[rr * kLs + cc], bh, row, col);
      dss[rr * kLp + cc] = __float2bfloat16(p * (dp - delta_s[rr]) * scale);
    }
    __syncthreads();
    if (n0 < D) {
#pragma unroll
      for (int kk = 0; kk < kT; kk += 16) {
        FragARow fa[2];
        FragBRow fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], dss + (m0 + i * 16) * kLp + kk, kLp);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], ks + kk * kLd + n0 + j * 16, kLd);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
  }
  store_tc(acc, ss, dq, b, q0, Sq, Hq, h, D);
}

// K3 on the tensor cores: dk and dv for one (b * Hkv + hk, 64-key tile),
// summed over the query heads of the GQA group
template <typename Ex>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ kv_lens, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
                  int D, int causal, float scale, Ex ex) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kT * kLd;
  bf16* ks = dos + kT * kLd;
  bf16* vs = ks + kT * kLd;
  float* ss = reinterpret_cast<float*>(vs + kT * kLd);
  float* dps = ss + kT * kLs;
  bf16* ps = reinterpret_cast<bf16*>(dps + kT * kLs);   // [q][key]
  bf16* dss = ps + kT * kLp;                             // [q][key]
  float* lse_s = reinterpret_cast<float*>(dss + kT * kLp);
  float* delta_s = lse_s + kT;
  ex.load_seed();

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * kT;
  const int tid = threadIdx.x;
  const int w = tid / 32;
  const int m0 = (w / 4) * 32, n0 = (w % 4) * 32;

  int kvlen = Sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[b], Sk));

  stage_tc(ks, k, b, k0, Sk, Hkv, hk, D);
  stage_tc(vs, v, b, k0, Sk, Hkv, hk, D);
  FragAcc dk_acc[2][2], dv_acc[2][2];
  zero_frags(dk_acc);
  zero_frags(dv_acc);

  // causal: query rows before k0 see none of these keys (block-uniform)
  const int qstart = causal ? (k0 / kT) * kT : 0;
  const int qend = k0 < kvlen ? Sq : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long bh = (long)b * Hq + h;
    for (int r0 = qstart; r0 < qend; r0 += kT) {
      __syncthreads();                     // previous tile consumed
      stage_tc(qs, q, b, r0, Sq, Hq, h, D);
      stage_tc(dos, dout, b, r0, Sq, Hq, h, D);
      if (tid < kT) {
        const int row = r0 + tid;
        lse_s[tid] = row < Sq ? lse[bh * Sq + row] : 0.f;
        delta_s[tid] = row < Sq ? delta[bh * Sq + row] : 0.f;
      }
      __syncthreads();
      scores_tc(qs, ks, dos, vs, ss, dps, D);
      __syncthreads();
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int rr = e / kT, cc = e % kT;
        const int row = r0 + rr, key = k0 + cc;
        const bool ok = row < Sq && key < kvlen && (!causal || key <= row);
        const float p =
            ok ? __expf(ex.logit(ss[rr * kLs + cc], scale, b, h, row, key) -
                        lse_s[rr])
               : 0.f;
        const float dp = ex.drop(dps[rr * kLs + cc], bh, row, key);
        ps[rr * kLp + cc] = __float2bfloat16(ex.drop(p, bh, row, key));
        dss[rr * kLp + cc] = __float2bfloat16(p * (dp - delta_s[rr]) * scale);
      }
      __syncthreads();
      if (n0 < D) {
#pragma unroll
        for (int kk = 0; kk < kT; kk += 16) {
          // A (key m, query k) = p[k][m]: p and ds read column-major
          FragACol fp[2], fs[2];
          FragBRow fdo[2], fq[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wmma::load_matrix_sync(fp[i], ps + kk * kLp + m0 + i * 16, kLp);
            wmma::load_matrix_sync(fs[i], dss + kk * kLp + m0 + i * 16,
                                   kLp);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::load_matrix_sync(fdo[j], dos + kk * kLd + n0 + j * 16,
                                   kLd);
            wmma::load_matrix_sync(fq[j], qs + kk * kLd + n0 + j * 16, kLd);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              wmma::mma_sync(dv_acc[i][j], fp[i], fdo[j], dv_acc[i][j]);
              wmma::mma_sync(dk_acc[i][j], fs[i], fq[j], dk_acc[i][j]);
            }
        }
      }
    }
  }
  store_tc(dk_acc, ss, dk, b, k0, Sk, Hkv, hk, D);
  store_tc(dv_acc, ss, dv, b, k0, Sk, Hkv, hk, D);
}

int allow_tc_smem(const void* kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem));
}

}  // namespace

// q, dout (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D) contiguous and of one
// dtype; lse and delta (B * Hq, Sq) fp32; kv_lens (B,) int32 or null;
// dk, dv like k; dq like q; the bias and dropout arguments as K1's
// (pt::AttnArgs). The caller guarantees D <= 128, Hq % Hkv == 0 and
// non-empty shapes.
extern "C" int pt_flash_attention_bwd_dkdv(
    int dtype, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta,
    const void* kv_lens, void* dk, void* dv, int B, int Sq, int Sk,
    int Hq, int Hkv, int D, int causal, float scale, const void* bias,
    long long sb, long long sh, long long sq, const void* seed,
    unsigned thresh, float keep_div, int stride, void* stream) {
  const pt::AttnArgs args{static_cast<const float*>(bias), sb, sh, sq,
                          static_cast<const int*>(seed), thresh, keep_div,
                          stride};
  const dim3 grid(B * Hkv, (Sk + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const int* lens = static_cast<const int*>(kv_lens);
  return pt::with_attn_extra(args, [&](auto ex) -> int {
    using Ex = decltype(ex);
    if (dtype == pt::kBFloat16 && D % 16 == 0) {
      const int rc = allow_tc_smem(reinterpret_cast<const void*>(
          flash_bwd_dkdv_tc<Ex>));
      if (rc != 0) return rc;
      const dim3 tc_grid(B * Hkv, (Sk + kT - 1) / kT);
      flash_bwd_dkdv_tc<Ex><<<tc_grid, kThreads, kTcSmem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          lse_f, delta_f, lens, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), Sq, Sk, Hq, Hkv, D, causal, scale, ex);
    } else if (dtype == pt::kBFloat16) {
      using T = __nv_bfloat16;
      flash_bwd_dkdv_kernel<T, Ex><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse_f,
          delta_f, lens, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk,
          Hq, Hkv, D, causal, scale, ex);
    } else if (dtype == pt::kFloat32) {
      using T = float;
      flash_bwd_dkdv_kernel<T, Ex><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse_f,
          delta_f, lens, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk,
          Hq, Hkv, D, causal, scale, ex);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int pt_flash_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta,
    const void* kv_lens, void* dq, int B, int Sq, int Sk, int Hq, int Hkv,
    int D, int causal, float scale, const void* bias, long long sb,
    long long sh, long long sq, const void* seed, unsigned thresh,
    float keep_div, int stride, void* stream) {
  const pt::AttnArgs args{static_cast<const float*>(bias), sb, sh, sq,
                          static_cast<const int*>(seed), thresh, keep_div,
                          stride};
  const dim3 grid(B * Hq, (Sq + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const int* lens = static_cast<const int*>(kv_lens);
  return pt::with_attn_extra(args, [&](auto ex) -> int {
    using Ex = decltype(ex);
    if (dtype == pt::kBFloat16 && D % 16 == 0) {
      const int rc = allow_tc_smem(reinterpret_cast<const void*>(
          flash_bwd_dq_tc<Ex>));
      if (rc != 0) return rc;
      const dim3 tc_grid(B * Hq, (Sq + kT - 1) / kT);
      flash_bwd_dq_tc<Ex><<<tc_grid, kThreads, kTcSmem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          lse_f, delta_f, lens, static_cast<bf16*>(dq), Sq, Sk, Hq, Hkv, D,
          causal, scale, ex);
    } else if (dtype == pt::kBFloat16) {
      using T = __nv_bfloat16;
      flash_bwd_dq_kernel<T, Ex><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse_f,
          delta_f, lens, static_cast<T*>(dq), Sq, Sk, Hq, Hkv, D, causal,
          scale, ex);
    } else if (dtype == pt::kFloat32) {
      using T = float;
      flash_bwd_dq_kernel<T, Ex><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse_f,
          delta_f, lens, static_cast<T*>(dq), Sq, Sk, Hq, Hkv, D, causal,
          scale, ex);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

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
// Design. One block per (b * Hq + h, 64-row query tile); a loop inside
// the block walks the key tiles and carries the running (m, l, acc), which
// replaces the TPU's sequential `nk` grid axis and its VMEM scratch.
// Causal tiles above the diagonal and tiles at or past kv_len are never
// loaded. Scores use the same -1e30 floor on the running max as the TPU
// kernel, so a fully masked tile contributes exactly 0, and p is rounded
// to the input dtype for p . v, as there. Two paths:
//  - bf16 with D % 16 == 0: tensor cores (the `flash_fwd_tc` kernel
//    below; 64-key tiles, S and p through shared memory, the output
//    accumulator in shared memory as fp32).
//  - otherwise: the FP32 pipes. 256 threads, four per query row, each
//    holding 32 of the (zero-padded) 128 dims in registers; 32-key tiles
//    staged in shared memory as fp32 and read as conflict-free float4.
//
// Bound on the H100. At the serving shapes (S = 128..512, D = 128, bf16)
// the function sits below the roofline ridge (about 295 bf16 FLOP per
// byte), so its floor is the bytes of q, k, v and o; at the train shape
// (B 4, S 2048) it is above the ridge, bound by the tensor cores' 989
// TFLOP/s. Both paths read K/V once per 64-row query tile; wgmma and TMA
// come in a later change.
#include <mma.h>

#include "common.cuh"

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


// ---- tensor-core path (bf16, D % 16 == 0) ----------------------------------
//
// The same function on the tensor cores (wmma 16x16x16, bf16 in, fp32
// accumulate), a block per (b * Hq + h, 64-row query tile) walking
// 64-key tiles. Per tile, S = q . k^T (64 x 64) goes through shared
// memory, where four threads per row update the running max and sum and
// write p in bf16; the output accumulator stays in shared memory as fp32
// (the rescale by exp(m_old - m_new) needs rows, which wmma fragments do
// not expose), each warp adding its 32 x 32 piece of p . v per tile.

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kT = 64;                     // query rows and keys per tile
constexpr int kLd = kDMax + 8;             // bf16 row stride of q, k, v
constexpr int kLs = kT + 4;                // fp32 row stride of S
constexpr int kLp = kT + 8;                // bf16 row stride of p
constexpr int kLo = kDMax + 4;             // fp32 row stride of o
constexpr int kTcSmem = 3 * kT * kLd * 2 + kT * kLs * 4 + kT * kLp * 2 +
                        kT * kLo * 4 + 3 * kT * 4;

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

template <typename Ex>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const int* __restrict__ kv_lens,
             bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Sk,
             int Hq, int Hkv, int D, int causal, float scale, Ex ex) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kT * kLd;
  bf16* vs = ks + kT * kLd;
  float* ss = reinterpret_cast<float*>(vs + kT * kLd);
  bf16* ps = reinterpret_cast<bf16*>(ss + kT * kLs);
  float* os = reinterpret_cast<float*>(ps + kT * kLp);
  float* m_s = os + kT * kLo;
  float* l_s = m_s + kT;
  float* a_s = l_s + kT;
  ex.load_seed();

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * kT;
  const int tid = threadIdx.x;
  const int w = tid / 32;

  int kvlen = Sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[b], Sk));
  int kend = kvlen;
  if (causal) kend = min(kend, q0 + kT);

  stage_tc(qs, q, b, q0, Sq, Hq, h, D);
  for (int e = tid; e < kT * kLo; e += kThreads) os[e] = 0.f;
  if (tid < kT) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  // four threads per row for the softmax update, 16 columns each
  const int rr = tid / 4, part = tid % 4;
  const int row = q0 + rr;
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();                       // previous tile consumed
    stage_tc(ks, k, b, k0, Sk, Hkv, hk, D);
    stage_tc(vs, v, b, k0, Sk, Hkv, hk, D);
    __syncthreads();
    {  // S = q . k^T: warp w owns rows 16 (w / 2), columns 32 (w % 2)
      const int m0 = (w / 2) * 16, n0 = (w % 2) * 32;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[2];
      wmma::fill_fragment(f[0], 0.f);
      wmma::fill_fragment(f[1], 0.f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            fa;
        wmma::load_matrix_sync(fa, qs + m0 * kLd + kk, kLd);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              fb;
          wmma::load_matrix_sync(fb, ks + (n0 + j * 16) * kLd + kk, kLd);
          wmma::mma_sync(f[j], fa, fb, f[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(ss + m0 * kLs + n0 + j * 16, f[j], kLs,
                                wmma::mem_row_major);
    }
    __syncthreads();
    {  // online softmax of the tile's row
      float sv[16];
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int cc = part * 16 + c;
        const int col = k0 + cc;
        const bool ok = row < Sq && col < kvlen && (!causal || col <= row);
        sv[c] = ok ? ex.logit(ss[rr * kLs + cc], scale, b, h, row, col)
                   : -INFINITY;
        tmax = fmaxf(tmax, sv[c]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_old = m_s[rr];
      const float m_new = fmaxf(fmaxf(m_old, tmax), pt::kMaxFloor);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = __expf(sv[c] - m_new);
        psum += p;                         // l sums the un-dropped p
        ps[rr * kLp + part * 16 + c] =
            __float2bfloat16(ex.drop(p, bh, row, k0 + part * 16 + c));
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = __expf(m_old - m_new);
        a_s[rr] = alpha;
        l_s[rr] = l_s[rr] * alpha + psum;
        m_s[rr] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < kT * D; e += kThreads) {
      const int r = e / D, c = e % D;
      os[r * kLo + c] *= a_s[r];
    }
    __syncthreads();
    {  // o += p . v: warp w owns rows 32 (w / 4), columns 32 (w % 4)
      const int m0 = (w / 4) * 32, n0 = (w % 4) * 32;
      if (n0 < D) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(f[i][j],
                                   os + (m0 + i * 16) * kLo + n0 + j * 16,
                                   kLo, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kT; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[i], ps + (m0 + i * 16) * kLp + kk,
                                   kLp);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(fb[j], vs + kk * kLd + n0 + j * 16, kLd);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(f[i][j], fa[i], fb[j], f[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(os + (m0 + i * 16) * kLo + n0 + j * 16,
                                    f[i][j], kLo, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
  // a row with no visible key gives 0 and LSE 0, as on the TPU
  for (int e = tid; e < kT * D; e += kThreads) {
    const int r = e / D, c = e % D;
    if (q0 + r < Sq) {
      const float l = l_s[r];
      o[((long)(b * Sq + q0 + r) * Hq + h) * D + c] =
          __float2bfloat16(os[r * kLo + c] / (l == 0.f ? 1.f : l));
    }
  }
  if (tid < kT && q0 + tid < Sq) {
    const float m = m_s[tid], l = l_s[tid];
    lse[(long)bh * Sq + q0 + tid] =
        (m == -INFINITY ? 0.f : m) + logf(l == 0.f ? 1.f : l);
  }
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), o (B, Sq, Hq, D) all contiguous
// and of one dtype; kv_lens (B,) int32 or null; lse (B * Hq, Sq) fp32;
// bias fp32 or null, read at b * sb + h * sh + row * sq + col; seed the
// device int32 seed of the dropout (null for none), the other dropout
// arguments as in pt::AttnExtra. The caller guarantees D <= 128,
// Hq % Hkv == 0 and non-empty shapes.
extern "C" int pt_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_lens, void* o, void* lse, int B, int Sq, int Sk, int Hq,
    int Hkv, int D, int causal, float scale, const void* bias,
    long long sb, long long sh, long long sq, const void* seed,
    unsigned thresh, float keep_div, int stride, void* stream) {
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
      const int rc = static_cast<int>(cudaFuncSetAttribute(
          reinterpret_cast<const void*>(flash_fwd_tc<Ex>),
          cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem));
      if (rc != 0) return rc;
      const dim3 tc_grid(B * Hq, (Sq + kT - 1) / kT);
      flash_fwd_tc<Ex><<<tc_grid, kThreads, kTcSmem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), lens, static_cast<bf16*>(o), lse_f,
          Sq, Sk, Hq, Hkv, D, causal, scale, ex);
    } else if (dtype == pt::kBFloat16) {
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

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
// and nothing is written twice. K4: a block per (b * Hq + h, query tile)
// walks the key tiles that the causal mask and kv_len leave visible, as
// K1 does. K3: a block per (b * Hkv + kv head, key tile) walks every
// query head of the GQA group and, for each, the query tiles from the
// first one the causal mask lets see the key tile; summing the group
// inside the block replaces the JAX code's per-query-head dk/dv and its
// group sum (:412-414); a key tile at or past kv_len writes zeros. As on
// the TPU, p and ds are rounded to the input dtype before their products.
// Two paths:
//  - bf16 with D % 16 == 0 (the train path): tensor cores, TMA rings and
//    warp-specialised wgmma with every score, probability and gradient
//    tile in registers (sm90.cuh holds the Hopper pieces). K3 is
//    `flash_bwd_dkdv_sm90` (128-key blocks, a ring of 64-row Q/dO tiles,
//    S^T, dP^T and the dK/dV accumulators in registers); K4 is
//    `flash_bwd_dq_sm90` (128-row blocks with Q and dO resident, a ring
//    of 64-key K/V tiles, S, dP and the dQ accumulators in registers).
//    Dropout multiplies a kept value by 1 / (1 - rate) (within an fp32
//    rounding of the JAX kernels' quotient; the masks are the same bits).
//  - otherwise (fp32): the FP32 pipes, four threads per row each holding
//    32 of the (zero-padded) 128 dims of its row's operands and
//    accumulators in registers, the other side staged as fp32 in 32-row
//    shared tiles read as conflict-free float4.
//
// Bound on the H100. At the train shape (B 4, S 2048, 16 heads of 128,
// causal, bf16) the work is 8 (K3) and 6 (K4) flops per dim of each of
// the 134 M visible (query, key) pairs, about 137 and 103 GFLOP, against
// some 200 MB of inputs and outputs: above the ridge, so the bound is the
// tensor cores' 989 TFLOP/s (about 0.14 and 0.10 ms). Both keep their
// products on wgmma with nothing but the TMA tiles in shared memory; the
// elementwise work between the products of a warpgroup does not overlap
// them, only the other warpgroup's. The fp32 path is bound by the FP32
// pipes (67 TFLOP/s).
#include "common.cuh"
#include "sm90.cuh"

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


using bf16 = __nv_bfloat16;

// ---- K3 on the tensor cores: TMA + wgmma (bf16, D % 16 == 0) -------------
//
// One block of three warpgroups per (b * Hkv + hk, 128-key tile). The K
// and V tiles stay in shared memory for the whole walk. Warpgroup 0 is
// the producer: one warp streams (Q, dO) tiles of 64 query rows by TMA
// through a ring of kStages (4D maps over (D, H, S, B), 64-dim boxes,
// 128-byte swizzle), with those rows' lse and delta, for every query head
// of the GQA group and, when causal, from the key tile's diagonal on.
// Warpgroups 1 and 2 each own 64 keys and keep dK and dV in registers for
// the whole walk. Per step, transposed so that keys are the rows:
//   S^T  = K . Q^T                         wgmma m64n64k16, SS
//   dP^T = V . dO^T                        wgmma m64n64k16, SS
//   P^T  = exp(S^T scale + bias^T - lse)   masked, in registers
//   dS^T = P^T (drop(dP^T) - delta) scale  in registers
//   dV  += drop(P^T) . dO                  wgmma m64nDk16, RS, dO MN-major
//   dK  += dS^T . Q                        wgmma m64nDk16, RS, Q MN-major
// with drop(P^T) and dS^T rounded to bf16 and packed in registers as the
// A operands; nothing but the TMA tiles and the row terms goes through
// shared memory. The hash and the bias see (row = query, col = key) from
// the transposed layout. A step whose every query precedes every key of
// the warpgroup (causal) adds nothing and is skipped. A third ring stage
// ran faster on an H100 than two; issuing dV before forming dS (to run
// it beside the elementwise work) ran slower. Registers: the producer
// warpgroup keeps 40 a thread and the consumers 232 (dK and dV take 128
// at D 128, S^T and dP^T 64): with 24 / 240 the producer spilled and
// the kernel ran about 2% slower. At 40 / 232 the instances the GPT and
// encoder paths run (D 128 without bias or dropout, D 64 with both) do
// not spill; the D 128 ones with a bias or dropout spill 40-120 bytes.

using namespace sm90;

constexpr int kKeys3 = 128;                // keys per block
constexpr int kRows3 = 64;                 // query rows per stage
constexpr int kStages3 = 3;
constexpr int kWgThreads = 384;            // producer + two consumers
constexpr uint32_t kKBox = kKeys3 * 128;   // a 64-dim box of 128 keys
constexpr uint32_t kQBox = kRows3 * 128;   // a 64-dim box of 64 rows

template <int DP>
struct DkdvSmem {                          // byte offsets from the base
  static constexpr uint32_t kKV = (DP / 64) * kKBox;    // the K or V tile
  static constexpr uint32_t kQ = (DP / 64) * kQBox;     // a Q or dO tile
  // a stage: Q, dO, then the rows' lse and delta; 1024-byte aligned
  static constexpr uint32_t kStage =
      (2 * kQ + 2 * kRows3 * 4 + 1023) / 1024 * 1024;
  static constexpr uint32_t kRing = 2 * kKV;
  static constexpr uint32_t kBars = kRing + kStages3 * kStage;
  static constexpr int kBytes = kBars + (1 + 2 * kStages3) * 8 + 1024;
};

// one step's elementwise work on the transposed registers (keys key0 and
// key0 + 8, query columns q0 + c + 8 j + {0, 1}, c = 2 (t % 4)): p from
// the scores st and the rows' lse, ds from the products dpt and delta;
// pa (the dropped p) and da (ds) in bf16 as the A operands of the dV and
// dK products (pa[k]: queries 16 k ..)
template <bool kMasked, typename Ex>
__device__ __forceinline__ void dkdv_tile(
    const float (&st)[32], const float (&dpt)[32], uint32_t (&pa)[4][4],
    uint32_t (&da)[4][4], const float* rows, const Ex& ex, int b, int h,
    unsigned bh, int key0, int q0, int c, int Sq, int kvlen, int causal,
    float scale) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int key = key0 + (i & 2) * 4;
    const int qc = c + 8 * (i / 4);        // the pair's first row in the stage
    float pv[2], dsv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = q0 + qc + e;
      const bool ok = !kMasked ||
                      (row < Sq && key < kvlen && (!causal || key <= row));
      const float p =
          ok ? __expf(ex.logit(st[i + e], scale, b, h, row, key) -
                      rows[qc + e])
             : 0.f;
      const bool kp = ex.kept(bh, row, key);
      pv[e] = ex.scaled(p, kp);
      // ds multiplies the un-dropped p
      dsv[e] = p * (ex.scaled(dpt[i + e], kp) - rows[kRows3 + qc + e]) *
               scale;
    }
    pa[i / 8][(i % 8) / 2] = pack_bf16(pv[0], pv[1]);
    da[i / 8][(i % 8) / 2] = pack_bf16(dsv[0], dsv[1]);
  }
}

// the (dk or dv) accumulators of keys key0 and key0 + 8 into rows of a
// (B, Sk, Hkv, D) bf16 tensor at (b, hk), in column pairs
template <int DP>
__device__ __forceinline__ void store_keys(const float (&acc)[DP / 2],
                                           bf16* out, int b, int hk,
                                           int key0, int c, int Sk, int Hkv,
                                           int D) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Sk) continue;
    bf16* row = out + (static_cast<long>(b * Sk + key) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int DP, typename Ex>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_lens, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
                    int D, int causal, float scale, Ex ex) {
  using L = DkdvSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t kvbar = base + L::kBars;
  const uint32_t full = kvbar + 8;         // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kStages3;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * kKeys3;
  int kvlen = Sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[b], Sk));
  // causal: query rows before k0 see none of these keys; a key tile at or
  // past kv_len walks nothing and writes zeros
  const int qstart = causal ? k0 : 0;
  const int nq = k0 < kvlen ? (Sq - qstart + kRows3 - 1) / kRows3 : 0;
  const int total = group * nq;            // steps: (head, query tile)
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages3; ++s) {
      mbar_init(full + 8 * s, 32);         // the producer warp's lanes
      mbar_init(empty + 8 * s, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: warp 0 keeps kStages3 (Q, dO, lse, delta) steps in flight
    regs_dec<40>();
    const int lane = threadIdx.x;
    if (lane < 32 && total > 0) {
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * L::kKV);
        for (int c = 0; c < DP / 64; ++c) {
          tma_load_4d(&tk, base + c * kKBox, kvbar, 64 * c, hk, k0, b);
          tma_load_4d(&tv, base + L::kKV + c * kKBox, kvbar, 64 * c, hk, k0,
                      b);
        }
      }
      // the stage s, the parity ph of its current use, the step's (h, r0)
      int s = 0, ph = 0, h = hk * group, r0 = qstart;
      for (int it = 0; it < total; ++it) {
        if (it >= kStages3) mbar_wait(empty + 8 * s, ph ^ 1);
        const long bh = static_cast<long>(b) * Hq + h;
        float* rows = reinterpret_cast<float*>(gbase + L::kRing +
                                               s * L::kStage + 2 * L::kQ);
        for (int e = lane; e < kRows3; e += 32) {
          const int row = r0 + e;
          rows[e] = row < Sq ? lse[bh * Sq + row] : 0.f;
          rows[kRows3 + e] = row < Sq ? delta[bh * Sq + row] : 0.f;
        }
        const uint32_t tile = base + L::kRing + s * L::kStage;
        if (lane == 0) {
          mbar_expect_tx(full + 8 * s, 2 * L::kQ);
          for (int c = 0; c < DP / 64; ++c) {
            tma_load_4d(&tq, tile + c * kQBox, full + 8 * s, 64 * c, h, r0,
                        b);
            tma_load_4d(&tdo, tile + L::kQ + c * kQBox, full + 8 * s,
                        64 * c, h, r0, b);
          }
        } else {
          mbar_arrive(full + 8 * s);
        }
        if (++s == kStages3) {
          s = 0;
          ph ^= 1;
        }
        if ((r0 += kRows3) >= Sq) {
          r0 = qstart;
          ++h;
        }
      }
    }
  } else {
    regs_inc<232>();
    ex.load_seed();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int key_first = k0 + 64 * cw;    // the warpgroup's first key
    const int key0 = key_first + 16 * (t / 32) + (t % 32) / 4;
    const int c = 2 * (t % 4);
    float dka[DP / 2], dva[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      dka[i] = 0.f;
      dva[i] = 0.f;
    }
    if (total > 0) {
      // this warpgroup's 64 rows of the K and V tiles
      const uint32_t ks = base + cw * 64 * 128;
      const uint32_t vs = base + L::kKV + cw * 64 * 128;
      mbar_wait(kvbar, 0);
      int s = 0, ph = 0, h = hk * group, r0 = qstart;
      for (int it = 0; it < total; ++it) {
        mbar_wait(full + 8 * s, ph);
        // causal: a step whose every query precedes every key adds nothing
        if (!causal || r0 + kRows3 - 1 >= key_first) {
          const uint32_t qs = base + L::kRing + s * L::kStage;
          const uint32_t dos = qs + L::kQ;
          const float* rows = reinterpret_cast<const float*>(
              gbase + L::kRing + s * L::kStage + 2 * L::kQ);
          float st[32], dpt[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const uint32_t ko = (kk / 4) * kKBox + (kk % 4) * 32;
            const uint32_t qo = (kk / 4) * kQBox + (kk % 4) * 32;
            wgmma_ss<kRows3, 0, 0>(st, gmma_desc(ks + ko, 16, 1024),
                                   gmma_desc(qs + qo, 16, 1024), kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const uint32_t ko = (kk / 4) * kKBox + (kk % 4) * 32;
            const uint32_t qo = (kk / 4) * kQBox + (kk % 4) * 32;
            wgmma_ss<kRows3, 0, 0>(dpt, gmma_desc(vs + ko, 16, 1024),
                                   gmma_desc(dos + qo, 16, 1024), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(st);
          fence_acc(dpt);
          const bool whole = k0 + kKeys3 <= kvlen &&
                             (!causal || r0 >= key_first + 63) &&
                             r0 + kRows3 <= Sq;
          const unsigned bh = b * Hq + h;
          uint32_t pa[4][4], da[4][4];
          if (whole)
            dkdv_tile<false>(st, dpt, pa, da, rows, ex, b, h, bh, key0, r0,
                             c, Sq, kvlen, causal, scale);
          else
            dkdv_tile<true>(st, dpt, pa, da, rows, ex, b, h, bh, key0, r0,
                            c, Sq, kvlen, causal, scale);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_regs(pa[kk]);
            fence_regs(da[kk]);
          }
          fence_acc(dka);
          fence_acc(dva);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<DP, 1>(dva, pa[kk],
                            gmma_desc(dos + kk * 2048, kQBox, 1024), 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<DP, 1>(dka, da[kk],
                            gmma_desc(qs + kk * 2048, kQBox, 1024), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(dka);
          fence_acc(dva);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            fence_regs(pa[kk]);
            fence_regs(da[kk]);
          }
        }
        if (t == 0) mbar_arrive(empty + 8 * s);
        if (++s == kStages3) {
          s = 0;
          ph ^= 1;
        }
        if ((r0 += kRows3) >= Sq) {
          r0 = qstart;
          ++h;
        }
      }
    }
    store_keys<DP>(dka, dk, b, hk, key0, c, Sk, Hkv, D);
    store_keys<DP>(dva, dv, b, hk, key0, c, Sk, Hkv, D);
  }
}

// K3 on the tensor cores for head dims up to DP
template <int DP, typename Ex>
int launch_dkdv_sm90(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int* lens, void* dk, void* dv, int B, int Sq,
                     int Sk, int Hq, int Hkv, int D, int causal, float scale,
                     const Ex& ex, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = bshd_map(&tq, q, B, Sq, Hq, D, kRows3);
  if (rc == 0) rc = bshd_map(&tdo, dout, B, Sq, Hq, D, kRows3);
  if (rc == 0) rc = bshd_map(&tk, k, B, Sk, Hkv, D, kKeys3);
  if (rc == 0) rc = bshd_map(&tv, v, B, Sk, Hkv, D, kKeys3);
  if (rc != 0) return rc;
  const auto kernel = flash_bwd_dkdv_sm90<DP, Ex>;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DkdvSmem<DP>::kBytes));
  if (rc != 0) return rc;
  const dim3 grid(B * Hkv, (Sk + kKeys3 - 1) / kKeys3);
  kernel<<<grid, kWgThreads, DkdvSmem<DP>::kBytes, st>>>(
      tq, tk, tv, tdo, lse, delta, lens, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, Hq, Hkv, D, causal, scale, ex);
  return static_cast<int>(cudaGetLastError());
}

// ---- K4 on the tensor cores: TMA + wgmma (bf16, D % 16 == 0) -------------
//
// K1's pipeline turned to dQ. One block of three warpgroups per (b * Hq +
// h, 128-row query tile), causal tiles longest first. Warpgroup 0 is the
// producer: one thread loads the block's Q and dO tiles once and streams
// (K, V) tiles of 64 keys through a ring of kStages4 by TMA (4D maps over
// (D, H, S, B), 64-dim boxes, 128-byte swizzle), only the tiles that
// kv_len and, when causal, the block's last row leave visible, from kv
// head h / (Hq / Hkv). Warpgroups 1 and 2 each own 64 query rows, with
// their rows' lse and delta in registers. Per key tile:
//   S  = Q . K^T                   wgmma m64n64k16, SS, both K-major
//   dP = dO . V^T                  wgmma m64n64k16, SS
//   P  = exp(S scale + bias - lse) masked, in registers
//   dS = P (drop(dP) - delta) scale, rounded to bf16 and packed in
//                                  registers as an A operand
//   dQ += dS . K                   wgmma m64nDk16, RS, the same K tile
//                                  read MN-major (the transpose bit)
// dQ stays in fp32 registers for the whole walk (64 a thread at D 128)
// and is written once, in bf16. Masks, the bias and the hash apply only
// on the tiles that need them, at (row = query, col = key); a tile whose
// every key follows every row of the warpgroup (causal) is skipped. As
// in K1, each product is waited for before the next is issued (ptxas's
// C7515 otherwise), and the two consumer warpgroups overlap each other.
// Registers: the producer warpgroup keeps 40 a thread and the consumers
// 232, K3's split; no instance spills. On an H100, 128-key tiles (two
// stages; S and dP at 64 registers a thread each) were no clear gain:
// faster at the GPT shape, slower at the encoder's, where their dropout
// instances spill. Two stages of 64 keys ran as fast as three.

constexpr int kRows4 = 128;                // query rows per block
constexpr int kKeys4 = 64;                 // keys per stage
constexpr int kStages4 = 3;
constexpr uint32_t kQBox4 = kRows4 * 128;  // a 64-dim box of 128 rows
constexpr uint32_t kKBox4 = kKeys4 * 128;  // a 64-dim box of 64 keys

template <int DP>
struct DqSmem {                            // byte offsets from the base
  static constexpr uint32_t kQ = (DP / 64) * kQBox4;    // the Q or dO tile
  static constexpr uint32_t kKV = (DP / 64) * kKBox4;   // a K or V tile
  static constexpr uint32_t kStage = 2 * kKV;
  static constexpr uint32_t kRing = 2 * kQ;
  static constexpr uint32_t kBars = kRing + kStages4 * kStage;
  // the tiles, q / full / empty barriers, slack to align to 1024 bytes
  static constexpr int kBytes = kBars + (1 + 2 * kStages4) * 8 + 1024;
};

// one key tile's elementwise work on the S and dP registers (rows row0
// and row0 + 8, keys c0 + 8 j + {0, 1}): p from the scores and the rows'
// lse lz, ds from dP and their delta dl, in bf16 as the A operand of
// dS . K (da[k]: keys 16 k ..)
template <bool kMasked, typename Ex>
__device__ __forceinline__ void dq_tile(
    const float (&s)[kKeys4 / 2], const float (&dp)[kKeys4 / 2],
    uint32_t (&da)[kKeys4 / 16][4], const float (&lz)[2],
    const float (&dl)[2], const Ex& ex, int b, int h, unsigned bh,
    int row0, int c0, int Sq, int kvlen, int causal, float scale) {
#pragma unroll
  for (int i = 0; i < kKeys4 / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int row = row0 + 8 * r;
    const int col = c0 + 8 * (i / 4);
    float dsv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = !kMasked || (row < Sq && col + e < kvlen &&
                                   (!causal || col + e <= row));
      const float p =
          ok ? __expf(ex.logit(s[i + e], scale, b, h, row, col + e) - lz[r])
             : 0.f;
      dsv[e] = p * (ex.scaled(dp[i + e], ex.kept(bh, row, col + e)) - dl[r]) *
               scale;
    }
    da[i / 8][(i % 8) / 2] = pack_bf16(dsv[0], dsv[1]);
  }
}

template <int DP, typename Ex>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ kv_lens, bf16* __restrict__ dq,
                  int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                  float scale, Ex ex) {
  using L = DqSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t qbar = base + L::kBars;
  const uint32_t full = qbar + 8;          // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kStages4;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // causal query tiles longest first, so the last wave is the shortest
  const int qt = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * kRows4;
  int kvlen = Sk;
  if (kv_lens != nullptr) kvlen = max(0, min(kv_lens[b], Sk));
  // key tiles up to kv_len and, when causal, the block's last row
  const int kend = causal ? min(kvlen, q0 + kRows4) : kvlen;
  const int nt = (kend + kKeys4 - 1) / kKeys4;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages4; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread loads Q and dO, then keeps kStages4 (K, V)
    // tiles in flight
    regs_dec<40>();
    if (threadIdx.x == 0 && nt > 0) {
      mbar_expect_tx(qbar, 2 * L::kQ);
      for (int c = 0; c < DP / 64; ++c) {
        tma_load_4d(&tq, base + c * kQBox4, qbar, 64 * c, h, q0, b);
        tma_load_4d(&tdo, base + L::kQ + c * kQBox4, qbar, 64 * c, h, q0, b);
      }
      for (int j = 0; j < nt; ++j) {
        const int s = j % kStages4;
        if (j >= kStages4) mbar_wait(empty + 8 * s, (j / kStages4 - 1) & 1);
        const uint32_t tile = base + L::kRing + s * L::kStage;
        mbar_expect_tx(full + 8 * s, L::kStage);
        for (int c = 0; c < DP / 64; ++c) {
          tma_load_4d(&tk, tile + c * kKBox4, full + 8 * s, 64 * c, hk,
                      j * kKeys4, b);
          tma_load_4d(&tv, tile + L::kKV + c * kKBox4, full + 8 * s, 64 * c,
                      hk, j * kKeys4, b);
        }
      }
    }
  } else {
    regs_inc<232>();
    ex.load_seed();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int r_first = q0 + 64 * cw;      // the warpgroup's first row
    const int row0 = r_first + 16 * (t / 32) + (t % 32) / 4;
    const int c = 2 * (t % 4);
    float dqa[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dqa[i] = 0.f;
    float lz[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lz[r] = row < Sq ? lse[static_cast<long>(bh) * Sq + row] : 0.f;
      dl[r] = row < Sq ? delta[static_cast<long>(bh) * Sq + row] : 0.f;
    }
    if (nt > 0) {
      // this warpgroup's 64 rows of the Q and dO tiles
      const uint32_t qs = base + cw * 64 * 128;
      const uint32_t dos = base + L::kQ + cw * 64 * 128;
      mbar_wait(qbar, 0);
      for (int j = 0; j < nt; ++j) {
        const int st = j % kStages4;
        mbar_wait(full + 8 * st, (j / kStages4) & 1);
        const int k0 = j * kKeys4;
        // rows past Sq, or (causal) a tile whose every key follows every
        // row, add nothing
        if (r_first < Sq && (!causal || k0 <= r_first + 63)) {
          const uint32_t ks = base + L::kRing + st * L::kStage;
          const uint32_t vs = ks + L::kKV;
          float sc[kKeys4 / 2], dp[kKeys4 / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const uint32_t qo = (kk / 4) * kQBox4 + (kk % 4) * 32;
            const uint32_t ko = (kk / 4) * kKBox4 + (kk % 4) * 32;
            wgmma_ss<kKeys4, 0, 0>(sc, gmma_desc(qs + qo, 16, 1024),
                                   gmma_desc(ks + ko, 16, 1024), kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const uint32_t qo = (kk / 4) * kQBox4 + (kk % 4) * 32;
            const uint32_t ko = (kk / 4) * kKBox4 + (kk % 4) * 32;
            wgmma_ss<kKeys4, 0, 0>(dp, gmma_desc(dos + qo, 16, 1024),
                                   gmma_desc(vs + ko, 16, 1024), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(sc);
          fence_acc(dp);
          const bool whole = k0 + kKeys4 <= kvlen &&
                             (!causal || k0 + kKeys4 - 1 <= r_first) &&
                             r_first + 64 <= Sq;
          uint32_t da[kKeys4 / 16][4];
          if (whole)
            dq_tile<false>(sc, dp, da, lz, dl, ex, b, h, bh, row0, k0 + c,
                           Sq, kvlen, causal, scale);
          else
            dq_tile<true>(sc, dp, da, lz, dl, ex, b, h, bh, row0, k0 + c,
                          Sq, kvlen, causal, scale);
#pragma unroll
          for (int kk = 0; kk < kKeys4 / 16; ++kk) fence_regs(da[kk]);
          fence_acc(dqa);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKeys4 / 16; ++kk)
            wgmma_rs<DP, 1>(dqa, da[kk],
                            gmma_desc(ks + kk * 2048, kKBox4, 1024), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(dqa);
#pragma unroll
          for (int kk = 0; kk < kKeys4 / 16; ++kk) fence_regs(da[kk]);
        }
        // the tile's K and V are read: release the stage
        if (t == 0) mbar_arrive(empty + 8 * st);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      bf16* out = dq + (static_cast<long>(b * Sq + row) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + c;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(dqa[4 * j + 2 * r], dqa[4 * j + 2 * r + 1]);
      }
    }
  }
}

// K4 on the tensor cores for head dims up to DP
template <int DP, typename Ex>
int launch_dq_sm90(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* lens, void* dq, int B, int Sq, int Sk, int Hq,
                   int Hkv, int D, int causal, float scale, const Ex& ex,
                   cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  int rc = bshd_map(&tq, q, B, Sq, Hq, D, kRows4);
  if (rc == 0) rc = bshd_map(&tdo, dout, B, Sq, Hq, D, kRows4);
  if (rc == 0) rc = bshd_map(&tk, k, B, Sk, Hkv, D, kKeys4);
  if (rc == 0) rc = bshd_map(&tv, v, B, Sk, Hkv, D, kKeys4);
  if (rc != 0) return rc;
  const auto kernel = flash_bwd_dq_sm90<DP, Ex>;
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DqSmem<DP>::kBytes));
  if (rc != 0) return rc;
  const dim3 grid(B * Hq, (Sq + kRows4 - 1) / kRows4);
  kernel<<<grid, kWgThreads, DqSmem<DP>::kBytes, st>>>(
      tq, tk, tv, tdo, lse, delta, lens, static_cast<bf16*>(dq), Sq, Sk, Hq,
      Hkv, D, causal, scale, ex);
  return static_cast<int>(cudaGetLastError());
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
      return D <= 64
                 ? launch_dkdv_sm90<64>(q, k, v, dout, lse_f, delta_f, lens,
                                        dk, dv, B, Sq, Sk, Hq, Hkv, D,
                                        causal, scale, ex, st)
                 : launch_dkdv_sm90<128>(q, k, v, dout, lse_f, delta_f, lens,
                                         dk, dv, B, Sq, Sk, Hq, Hkv, D,
                                         causal, scale, ex, st);
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
      return D <= 64 ? launch_dq_sm90<64>(q, k, v, dout, lse_f, delta_f, lens,
                                          dq, B, Sq, Sk, Hq, Hkv, D, causal,
                                          scale, ex, st)
                     : launch_dq_sm90<128>(q, k, v, dout, lse_f, delta_f,
                                           lens, dq, B, Sq, Sk, Hq, Hkv, D,
                                           causal, scale, ex, st);
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

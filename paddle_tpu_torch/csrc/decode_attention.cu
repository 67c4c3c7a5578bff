// K10 — flash-decode attention over a head-major contiguous KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/decode_attention.py
// `_kernel` (launched by `decode_attention`, the pl.pallas_call at :258):
// one query row per sequence attends over the first lengths[b] entries of
// its cache, GQA query head h reading kv head h / (Hq / Hkv), with the
// online softmax's running max m and denominator l returned on request
// (`online_softmax_write_stats`, :81-89).
//
// Layouts: q (B, Hq, D); k/v caches (B, Hkv, T, D); lengths (B,) int32;
// o (B, Hq, D) in the cache dtype; m/l (B, Hq) fp32. A row of length 0
// gives o = 0, m = -inf and l = 0.
//
// Design. One block of 8 warps per (b, kv head); the block holds all
// G = Hq / Hkv query rows of that head, so each K/V row read serves the
// whole group (the GQA point of the TPU kernel, :20-23). The block walks
// only the row's valid keys, [0, lengths[b]): the GPU form of the TPU's
// clamped index map (:226-231), which re-presented the last valid block
// to skip the DMA of the rest. A row of a cache is one contiguous run of
// D elements; a lane loads 16 bytes of it (8 bf16 or 4 fp32), so 16
// (bf16) or 32 (fp32) lanes cover a row of 128 and a warp loads two or
// one rows per instruction. Each warp owns every 8th group of rows and
// keeps its own online softmax in fp32: the scores of its rows reduce
// across the lanes of a row with shuffles, the running max is the same
// on every lane of the warp, and each lane accumulates p . v for its 16
// bytes of D. p is rounded to the cache dtype before that product, as
// `online_softmax_step` rounds it (:63-64), and the running max has the
// TPU kernel's -1e30 floor. Several rows' loads are issued before their
// use (kUnroll) to keep bytes in flight. At the end the 8 warps' (m, l,
// acc) merge through shared memory.
//
// Bound on the H100: bytes. A decode step does 4 FLOP per cached K/V
// element it reads, far below the ridge (about 295 FLOP per byte), so
// the floor is reading each row's valid K/V once (3.35 TB/s). The design
// reads exactly the valid rows, each once, 16 bytes a lane with
// neighbouring lanes on neighbouring bytes. What it does not do: split a
// long row over several blocks (flash-decoding). At the serving shape
// (8 rows x 16 kv heads = 128 blocks on 132 SMs) the block with the
// longest row sets the time; a split-K pass is later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDMax = 128;             // largest head_dim

// 16 bytes of T as fp32 lanes
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_row(const T* p, int e0, int D,
                                         bool vec_ok, float* out) {
  constexpr int V = Vec<T>::kN;
  if (vec_ok && e0 + V <= D) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + e0);
    const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = pt::to_float(el[e]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      out[e] = e0 + e < D ? pt::to_float(p[e0 + e]) : 0.f;
  }
}

// G: the group size the registers are sized for (1, 2, 4 or 8); the
// runtime group is at most G, and the rows past it carry zero queries
// whose outputs are never written
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ o, float* __restrict__ m_out,
              float* __restrict__ l_out, int Hq, int Hkv, int T_len, int D,
              float scale, bool vec_ok) {
  constexpr int V = Vec<T>::kN;          // elements per lane
  constexpr int kLpr = kDMax / V;        // lanes per row: 16 or 32
  constexpr int kRpw = 32 / kLpr;        // rows per warp load: 2 or 1
  constexpr int kUnroll = G >= 8 ? 1 : (G >= 4 ? 2 : 4);
  constexpr int kStep = kWarps * kRpw * kUnroll;   // keys per block step

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][kDMax];

  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int group = Hq / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = lane / kLpr;            // row within the warp's load
  const int e0 = (lane % kLpr) * V;      // this lane's first element
  const int len = max(0, min(lengths[b], T_len));

  float qf[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < group) {
      load_row(q + ((long)b * Hq + hk * group + g) * D, e0, D, vec_ok,
               qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) qf[g][e] = 0.f;
    }
  }

  float m[G], l[G], acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  }

  const long row0 = ((long)b * Hkv + hk) * T_len;
  for (int t0 = 0; t0 < len; t0 += kStep) {
    float kf[kUnroll][V], vf[kUnroll][V];
    int tk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      tk[u] = t0 + (u * kWarps + warp) * kRpw + rg;
      if (tk[u] < len) {
        const long off = (row0 + tk[u]) * D;
        load_row(kc + off, e0, D, vec_ok, kf[u]);
        load_row(vc + off, e0, D, vec_ok, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[kUnroll];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) d += qf[g][e] * kf[u][e];
        // sum over the lanes of one row (neighbouring lanes)
#pragma unroll
        for (int off = kLpr / 2; off >= 1; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u] = tk[u] < len ? d * scale : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      if (kRpw > 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, kLpr));
      // the same max on every lane of the warp
      const float m_new = fmaxf(fmaxf(m[g], mx), pt::kMaxFloor);
      const float alpha = __expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = __expf(s[u] - m_new);
        psum += p;
        const float pr = pt::round_to<T>(p);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] += pr * vf[u][e];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = m_new;
    }
  }

  // the rows of a warp's load share its max: their sums add
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (kRpw > 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], kLpr);
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], kLpr);
    }
    if (rg == 0) {
#pragma unroll
      for (int e = 0; e < V; ++e) sm_acc[warp][g][e0 + e] = acc[g][e];
    }
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no key (m = -inf) weighs nothing; on an empty
      // row every warp is such, and exp(-inf - -inf) would be NaN
      const float wt =
          sm_m[w][g] == -INFINITY ? 0.f : __expf(sm_m[w][g] - mm);
      ll += sm_l[w][g] * wt;
      a += sm_acc[w][g][d] * wt;
    }
    const long qi = (long)b * Hq + hk * group + g;
    o[qi * D + d] = pt::from_float<T>(a / (ll == 0.f ? 1.f : ll));
    if (m_out != nullptr && d == 0) {
      m_out[qi] = mm;
      l_out[qi] = ll;
    }
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const int* lens,
           void* o, float* m_out, float* l_out, int B, int Hq, int Hkv,
           int T_len, int D, float scale, bool vec_ok, cudaStream_t st) {
  const dim3 grid(B, Hkv);
  const int group = Hq / Hkv;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(kc);
  const T* vp = static_cast<const T*>(vc);
  T* op = static_cast<T*>(o);
#define PT_DECODE_LAUNCH(G)                                                \
  decode_kernel<T, G><<<grid, kThreads, 0, st>>>(qp, kp, vp, lens, op,     \
                                                 m_out, l_out, Hq, Hkv,    \
                                                 T_len, D, scale, vec_ok)
  if (group <= 1) {
    PT_DECODE_LAUNCH(1);
  } else if (group <= 2) {
    PT_DECODE_LAUNCH(2);
  } else if (group <= 4) {
    PT_DECODE_LAUNCH(4);
  } else if (group <= 8) {
    PT_DECODE_LAUNCH(8);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_DECODE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Stats when m_out is non-null (then l_out too). vec_ok: D is a multiple
// of the 16-byte vector and every pointer is 16-byte aligned. The caller
// guarantees D <= 128, Hq % Hkv == 0, Hq / Hkv <= 8 and B, Hkv > 0.
extern "C" int pt_decode_attention(int dtype, const void* q, const void* kc,
                                   const void* vc, const void* lengths,
                                   void* o, void* m_out, void* l_out, int B,
                                   int Hq, int Hkv, int T_len, int D,
                                   float scale, int vec_ok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  float* m_f = static_cast<float*>(m_out);
  float* l_f = static_cast<float*>(l_out);
  if (dtype == pt::kBFloat16) {
    return launch<__nv_bfloat16>(q, kc, vc, lens, o, m_f, l_f, B, Hq, Hkv,
                                 T_len, D, scale, vec_ok != 0, st);
  }
  if (dtype == pt::kFloat32) {
    return launch<float>(q, kc, vc, lens, o, m_f, l_f, B, Hq, Hkv, T_len, D,
                         scale, vec_ok != 0, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

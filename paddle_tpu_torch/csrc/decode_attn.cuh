// The pieces the port's flash-decode kernels share: K10
// (decode_attention.cu, a head-major contiguous cache) and K2 / K2'
// (paged_attention.cu, a paged pool). Both walk one (row, kv head) split
// over a thread-block cluster, each block an equal share of the row's
// valid keys in tiles of kTile rows that land in a ring of shared memory
// by 1D bulk copies, and both finish the same way:
//
// - the lane layout (`Online`): a lane holds 16 bytes of a row along D
//   (16 lanes a row in bf16, 32 in fp32), the scores reduce across a
//   row's lanes with shuffles, and all G = Hq / Hkv query rows of the kv
//   head share each K/V row read. Each warp keeps its own online softmax
//   in fp32, with the TPU kernels' -1e30 floor on the running max;
// - the merge (`Online::finish`): the warps merge into the block's
//   (m, l, acc[G][D]) in its own shared memory; after the cluster
//   barrier, block s merges entries s, s + S, ... (in units of the
//   block's threads) of the S blocks' partials, read through
//   map_shared_rank, and writes o and, on request, (m, l). A block that
//   saw no key weighs nothing. No workspace, no second launch.
//
// What differs stays in each kernel: where a tile's rows lie (a run of
// the cache, or a page through the table), how the fresh row enters, and
// two numerical choices `Online::tile` takes as template flags: K10
// rounds p to the cache dtype before the value product (as the TPU's
// `online_softmax_step`), K2 does not (as its TPU kernel); K2 zeroes the
// values of rows past the length, which a pool page may hold from an
// earlier sequence.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace dattn {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kDMax = 128;             // largest head_dim
constexpr int kTile = 16;              // cache rows of a ring slot
constexpr int kMaxSplit = 8;           // blocks of a cluster, at most

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

// dynamic shared memory: a ring of `stages` slots, each a K and a V tile
// (reused after the walk for the warps' partials), then the block's
// partial (m[G], l[G], acc[G][D], fp32)
__host__ __device__ inline int ring_bytes(int stages, int D, int elt) {
  return stages * 2 * kTile * D * elt;
}
__host__ __device__ inline int partial_floats(int G, int D) {
  return G * (D + 2);
}
__host__ __device__ inline int part_offset(int stages, int G, int D,
                                           int elt) {
  const int ring = ring_bytes(stages, D, elt);
  const int warps = kWarps * partial_floats(G, D) * 4;
  return ((ring > warps ? ring : warps) + 15) / 16 * 16;
}
__host__ __device__ inline int smem_bytes(int stages, int G, int D,
                                          int elt) {
  return part_offset(stages, G, D, elt) + partial_floats(G, D) * 4;
}

// One lane's share of a (row, kv head)'s online softmax. G: the group
// size the registers are sized for (1, 2, 4 or 8); the runtime group is
// at most G, and the rows past it carry zero queries whose outputs are
// never written. aligned: D * sizeof(T) is a multiple of 16 and every
// pointer 16-byte aligned (16-byte loads).
template <typename T, int G>
struct Online {
  static constexpr int V = Vec<T>::kN;          // elements per lane
  static constexpr int kLpr = kDMax / V;        // lanes per row: 16 or 32
  static constexpr int kRpw = 32 / kLpr;        // rows per warp load: 2 or 1
  static constexpr int kU = kTile / (kWarps * kRpw);  // a lane group's rows
                                                      // a tile
  int lane, warp, rg, e0;
  float qf[G][V];
  float m[G], l[G], acc[G][V];

  // q: the group's first query row, (b, hk * group)
  __device__ __forceinline__ void init(const T* q, int group, int D,
                                       bool aligned) {
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    rg = lane / kLpr;                    // row within the warp's load
    e0 = (lane % kLpr) * V;              // this lane's first element
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < group) {
        load_row(q + (long)g * D, e0, D, aligned, qf[g]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) qf[g][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
    }
  }

  // one tile of kTile rows in shared memory (ks, vs: rows of D), the
  // keys at positions r0 + r; rows at or past len are masked
  template <bool kRoundP, bool kMaskV>
  __device__ __forceinline__ void tile(const T* ks, const T* vs, int r0,
                                       int len, int D, bool aligned,
                                       float scale) {
    float kf[kU][V], vf[kU][V];
    int tk[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = (u * kWarps + warp) * kRpw + rg;
      tk[u] = r0 + r;
      load_row(ks + r * D, e0, D, aligned, kf[u]);
      load_row(vs + r * D, e0, D, aligned, vf[u]);
      if (kMaskV && tk[u] >= len) {
#pragma unroll
        for (int e = 0; e < V; ++e) vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc[kU];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) d += qf[g][e] * kf[u][e];
        // sum over the lanes of one row (neighbouring lanes)
#pragma unroll
        for (int off = kLpr / 2; off >= 1; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        sc[u] = tk[u] < len ? d * scale : -INFINITY;
        mx = fmaxf(mx, sc[u]);
      }
      if (kRpw > 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, kLpr));
      // the same max on every lane of the warp
      const float m_new = fmaxf(fmaxf(m[g], mx), pt::kMaxFloor);
      const float alpha = __expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float p = __expf(sc[u] - m_new);
        psum += p;
        const float pr = kRoundP ? pt::round_to<T>(p) : p;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] += pr * vf[u][e];
      }
      l[g] = l[g] * alpha + psum;
      m[g] = m_new;
    }
  }

  // one more key, read from global memory (a fresh row): warp 0's first
  // lane group holds it; the other warps do not see it, so a block whose
  // only key it is keeps their m at -inf
  template <bool kRoundP>
  __device__ __forceinline__ void key(const T* kr, const T* vr, int D,
                                      bool aligned, float scale) {
    if (warp != 0) return;
    float kf[V], vf[V];
    load_row(kr, e0, D, aligned, kf);
    load_row(vr, e0, D, aligned, vf);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) d += qf[g][e] * kf[e];
#pragma unroll
      for (int off = kLpr / 2; off >= 1; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      const float sc = rg == 0 ? d * scale : -INFINITY;
      float mx = sc;
      if (kRpw > 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, kLpr));
      const float m_new = fmaxf(fmaxf(m[g], mx), pt::kMaxFloor);
      const float alpha = __expf(m[g] - m_new);
      const float p = __expf(sc - m_new);
      const float pr = kRoundP ? pt::round_to<T>(p) : p;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][e] = acc[g][e] * alpha + pr * vf[e];
      l[g] = l[g] * alpha + p;
      m[g] = m_new;
    }
  }

  // The merge, once every copy the block issued has been waited for (the
  // ring then holds the warps' partials: [kWarps][G] m, [kWarps][G] l,
  // [kWarps][G][D] acc): the block's partial at smem + part_off, then
  // the cluster's, written to o (and m_out / l_out when non-null) at
  // query rows qi0 .. qi0 + group.
  __device__ __forceinline__ void finish(unsigned char* smem, int part_off,
                                         cg::cluster_group& cluster,
                                         int group, int D, T* o,
                                         float* m_out, float* l_out,
                                         long qi0) {
    const int S = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int pf = partial_floats(G, D);
    float* wpart = reinterpret_cast<float*>(smem);
    float* bpart = reinterpret_cast<float*>(smem + part_off);
    // the rows of a warp's load share its max: their sums add
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (kRpw > 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], kLpr);
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], kLpr);
      }
      float* wp = wpart + warp * pf;
      if (rg == 0) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (e0 + e < D) wp[2 * G + g * D + e0 + e] = acc[g][e];
      }
      if (lane == 0) {
        wp[g] = m[g];
        wp[G + g] = l[g];
      }
    }
    __syncthreads();
    // the block's partial: the warps merged against the block's max
    for (int i = threadIdx.x; i < group * D; i += kThreads) {
      const int g = i / D;
      const int d = i % D;
      float mm = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wpart[w * pf + g]);
      float ll = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        // a warp that saw no key (m = -inf) weighs nothing; on an empty
        // share every warp is such, and exp(-inf - -inf) would be NaN
        const float mw = wpart[w * pf + g];
        const float wt = mw == -INFINITY ? 0.f : __expf(mw - mm);
        ll += wpart[w * pf + G + g] * wt;
        a += wpart[w * pf + 2 * G + g * D + d] * wt;
      }
      bpart[2 * G + g * D + d] = a;
      if (d == 0) {
        bpart[g] = mm;
        bpart[G + g] = ll;
      }
    }
    cluster.sync();
    // the cluster's merge: block `rank` finishes entries rank * kThreads
    // + tid, stepping S * kThreads
    for (int i = rank * kThreads + threadIdx.x; i < group * D;
         i += S * kThreads) {
      const int g = i / D;
      const int d = i % D;
      float pm[kMaxSplit], pl[kMaxSplit], pa[kMaxSplit];
      float mm = -INFINITY;
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r) {
        pm[r] = -INFINITY;
        pl[r] = pa[r] = 0.f;
        if (r < S) {
          const float* p = cluster.map_shared_rank(bpart, r);
          pm[r] = p[g];
          pl[r] = p[G + g];
          pa[r] = p[2 * G + g * D + d];
        }
        mm = fmaxf(mm, pm[r]);
      }
      float ll = 0.f, a = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r) {
        const float wt = pm[r] == -INFINITY ? 0.f : __expf(pm[r] - mm);
        ll += pl[r] * wt;
        a += pa[r] * wt;
      }
      const long qi = qi0 + g;
      o[qi * D + d] = pt::from_float<T>(a / (ll == 0.f ? 1.f : ll));
      if (m_out != nullptr && d == 0) {
        m_out[qi] = mm;
        l_out[qi] = ll;
      }
    }
    // no block leaves while another reads its partial
    cluster.sync();
  }
};

// the cluster launch of kern over grid (splits, Hkv, B), cluster
// (splits, 1, 1), kThreads a block
template <typename Kern, typename... Args>
int launch_split(Kern kern, int splits, int Hkv, int B, int smem,
                 cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace dattn

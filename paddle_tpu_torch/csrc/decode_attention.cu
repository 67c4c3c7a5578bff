// K10 — flash-decode attention over a head-major contiguous KV cache, for
// Hopper (sm_90a): `flash_decode_sm90`.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/decode_attention.py
// `_kernel` (launched by `decode_attention`, the pl.pallas_call at :258):
// one query row per sequence attends over the first lengths[b] entries of
// its cache, GQA query head h reading kv head h / (Hq / Hkv), with the
// online softmax's running max m and denominator l returned on request
// (`online_softmax_write_stats`, :81-89). On request the kernel also
// writes the step's fresh K/V row: the job the JAX package splits between
// the cache write (`GPTBlock._write_kv_rows`) and `fold_fresh_row` (:91).
//
// Layouts: q (B, Hq, D); k/v caches (B, Hkv, T, D); lengths (B,) int32;
// o (B, Hq, D) in the cache dtype; m/l (B, Hq) fp32; k_new/v_new
// (B, Hkv, D) and write (B,) bool, optional. A row of length 0 gives
// o = 0, m = -inf and l = 0.
//
// Bound on the H100: bytes. A decode step does 4 FLOP per cached K/V
// element it reads, far below the ridge (about 295 FLOP per byte), so the
// floor is reading each row's valid K/V once at 3.35 TB/s. At the
// contiguous engine's shape (B 8 x 16 kv heads, T 2048, lengths up to
// 2047) that is 40 MB, 12 us; the longest row alone is 1 MB of K + V.
//
// Design.
// - Split each row over a thread-block cluster. The grid is (S, Hkv, B)
//   with cluster dims (S, 1, 1), S in {1, 2, 4, 8} chosen by the caller
//   from T. Block s of a cluster walks an equal share of its row's valid
//   keys [0, lengths[b]) in tiles of kTile rows; a block whose share is
//   empty still joins the cluster's barriers. One block per (b, kv head),
//   as the first port had, left the longest row to one block on one SM,
//   and that block set the time.
// - Keep bytes in flight with bulk copies. The K (and V) rows of one
//   (b, kv head) are contiguous, so a tile is one run of kTile * D
//   elements: one thread issues the 1D bulk copy
//   (cp.async.bulk ... mbarrier::complete_tx) of the K and the V tile into
//   a ring of kStages slots, each slot completing on its mbarrier, and
//   requests up to kStages tiles of its share before it computes
//   anything. A tile is copied whole (T is a multiple of 128, so a tile
//   that starts inside the cache ends inside it); rows past the length are
//   masked. The copy needs 16-byte aligned addresses and sizes: where the
//   pointers or a row's bytes break that (a head dim of 36 in bf16), the
//   same kernel stages each tile by threads instead. The ring (24 KB in
//   bf16 at D 128) lets about 8 blocks share an SM, so the 1,024 blocks
//   of the serving shape are resident in about one wave.
// - Compute from shared memory and combine through distributed shared
//   memory, with the pieces K2 shares (csrc/decode_attn.cuh): a lane
//   holds 16 bytes of a row along D, the scores reduce across a row's
//   lanes with shuffles, and all G = Hq / Hkv query rows of the kv head
//   share each K/V row read; each warp keeps its own online softmax in
//   fp32; p is rounded to the cache dtype before the value product, as
//   `online_softmax_step` rounds it (:63-64), and the running max has the
//   TPU kernel's -1e30 floor. The warps merge in shared memory, the
//   cluster's blocks through map_shared_rank. No workspace, no second
//   launch: K10 stays one launch per layer.
// - The fresh row inside. With k_new/v_new, row lengths[b] - 1 (the
//   clamped position `cache_rows` gives) is taken from k_new/v_new rather
//   than the cache, where write[b] holds (all rows without a mask), and
//   stored into the cache by the one block whose share holds it: its tile
//   is patched in shared memory after it lands, so no other block reads
//   the row and there is no race. A row whose write is false attends to
//   its cache entry.
// - What is left: the longest row's blocks (256 keys, 128 KB of K + V
//   each at T 2048) keep 3 tiles (24 KB) in flight, so their walk is a
//   chain of round trips to device memory, and the cluster's merge and
//   barriers come on top (PERF.md §6).
#include <cstdint>

#include "decode_attn.cuh"
#include "sm90.cuh"

namespace {

using namespace dattn;

constexpr int kStages = 3;             // ring slots

// G: the group size the registers are sized for (1, 2, 4 or 8; see
// dattn::Online). aligned: D * sizeof(T) is a multiple of 16 and every
// pointer 16-byte aligned (bulk copies, 16-byte loads).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_sm90(const T* __restrict__ q, T* __restrict__ kc,
                  T* __restrict__ vc, const int* __restrict__ lengths,
                  const T* __restrict__ k_new, const T* __restrict__ v_new,
                  const uint8_t* __restrict__ write, T* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  int Hq, int Hkv, int T_len, int D, float scale,
                  bool aligned) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int len = max(0, min(lengths[b], T_len));
  const int fresh = k_new != nullptr && len > 0 &&
                            (write == nullptr || write[b] != 0)
                        ? len - 1
                        : -1;
  const int n_tiles = (len + kTile - 1) / kTile;
  const int per = (n_tiles + S - 1) / S;
  const int tile0 = min(n_tiles, rank * per);
  const int mine = min(n_tiles, tile0 + per) - tile0;
  const long row0 = ((long)b * Hkv + hk) * T_len;   // (b, hk)'s first row
  const int tile_elems = kTile * D;
  T* ring = reinterpret_cast<T*>(smem);

  if (aligned && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // tile tile0 + j of the share into slot j % kStages (one thread)
  auto issue = [&](int j) {
    const int s = j % kStages;
    const long off = (row0 + (long)(tile0 + j) * kTile) * D;
    const uint32_t bytes = static_cast<uint32_t>(tile_elems * sizeof(T));
    const uint32_t bar = sm90::smem_u32(&full[s]);
    sm90::mbar_expect_tx(bar, 2 * bytes);
    sm90::bulk_load(sm90::smem_u32(ring + 2 * s * tile_elems), kc + off,
                    bytes, bar);
    sm90::bulk_load(sm90::smem_u32(ring + (2 * s + 1) * tile_elems),
                    vc + off, bytes, bar);
  };
  if (aligned && threadIdx.x == 0) {
    for (int j = 0; j < min(mine, kStages); ++j) issue(j);
  }

  Online<T, G> st;
  st.init(q + ((long)b * Hq + hk * group) * D, group, D, aligned);

  for (int j = 0; j < mine; ++j) {
    const int s = j % kStages;
    const int r0 = (tile0 + j) * kTile;
    T* ks = ring + 2 * s * tile_elems;
    T* vs = ks + tile_elems;
    if (aligned) {
      sm90::mbar_wait(sm90::smem_u32(&full[s]), (j / kStages) & 1);
    } else {
      // staged by threads; the slot is free (the last tile ended in a
      // barrier)
      const long off = (row0 + r0) * D;
      for (int i = threadIdx.x; i < tile_elems; i += kThreads) {
        ks[i] = kc[off + i];
        vs[i] = vc[off + i];
      }
      __syncthreads();
    }
    if (fresh >= r0 && fresh < r0 + kTile) {
      // the fresh row: used from k_new / v_new and stored into the cache
      const long src = ((long)b * Hkv + hk) * D;
      const long dst = (row0 + fresh) * D;
      T* kr = ks + (fresh - r0) * D;
      T* vr = vs + (fresh - r0) * D;
      for (int i = threadIdx.x; i < D; i += kThreads) {
        const T kv = k_new[src + i];
        const T vv = v_new[src + i];
        kr[i] = kv;
        vr[i] = vv;
        kc[dst + i] = kv;
        vc[dst + i] = vv;
      }
      // the slot is refilled by a bulk copy later
      sm90::fence_proxy_async();
      __syncthreads();
    }
    // p rounded to the cache dtype; rows past the length as they are
    st.template tile<true, false>(ks, vs, r0, len, D, aligned, scale);
    __syncthreads();                     // every warp is done with slot s
    if (aligned && threadIdx.x == 0 && j + kStages < mine) issue(j + kStages);
  }

  st.finish(smem, part_offset(kStages, G, D, sizeof(T)), cluster, group, D,
            o, m_out, l_out, (long)b * Hq + hk * group);
}

template <typename T, int G>
int launch_g(const T* q, T* kc, T* vc, const int* lens, const T* k_new,
             const T* v_new, const uint8_t* write, T* o, float* m_out,
             float* l_out, int B, int Hq, int Hkv, int T_len, int D,
             float scale, bool aligned, int splits, cudaStream_t st) {
  auto kern = flash_decode_sm90<T, G>;
  // above 48 KB (fp32 at D 128) only after the attribute: set it once
  // for the largest head dim
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kStages, G, kDMax, sizeof(T)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch_split(kern, splits, Hkv, B,
                      smem_bytes(kStages, G, D, sizeof(T)), st, q, kc, vc,
                      lens, k_new, v_new, write, o, m_out, l_out, Hq, Hkv,
                      T_len, D, scale, aligned);
}

template <typename T>
int launch(const void* q, void* kc, void* vc, const int* lens,
           const void* k_new, const void* v_new, const uint8_t* write,
           void* o, float* m_out, float* l_out, int B, int Hq, int Hkv,
           int T_len, int D, float scale, bool aligned, int splits,
           cudaStream_t st) {
  const int group = Hq / Hkv;
  const T* qp = static_cast<const T*>(q);
  T* kp = static_cast<T*>(kc);
  T* vp = static_cast<T*>(vc);
  const T* kn = static_cast<const T*>(k_new);
  const T* vn = static_cast<const T*>(v_new);
  T* op = static_cast<T*>(o);
#define PT_DECODE_LAUNCH(G)                                               \
  return launch_g<T, G>(qp, kp, vp, lens, kn, vn, write, op, m_out,       \
                        l_out, B, Hq, Hkv, T_len, D, scale, aligned,      \
                        splits, st)
  if (group <= 1) PT_DECODE_LAUNCH(1);
  if (group <= 2) PT_DECODE_LAUNCH(2);
  if (group <= 4) PT_DECODE_LAUNCH(4);
  if (group <= 8) PT_DECODE_LAUNCH(8);
#undef PT_DECODE_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Stats when m_out is non-null (then l_out too). k_new / v_new: the fresh
// rows (null: no write); write: (B,) bool as bytes, or null (every row).
// aligned: D * elt is a multiple of 16 and every pointer 16-byte aligned.
// splits: the blocks of a row's cluster, 1, 2, 4 or 8. The caller
// guarantees D <= 128, Hq % Hkv == 0, Hq / Hkv <= 8, T % 128 == 0 and
// B, Hkv > 0.
extern "C" int pt_decode_attention(int dtype, const void* q, void* kc,
                                   void* vc, const void* lengths,
                                   const void* k_new, const void* v_new,
                                   const void* write, void* o, void* m_out,
                                   void* l_out, int B, int Hq, int Hkv,
                                   int T_len, int D, float scale,
                                   int aligned, int splits, void* stream) {
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  const uint8_t* wr = static_cast<const uint8_t*>(write);
  float* m_f = static_cast<float*>(m_out);
  float* l_f = static_cast<float*>(l_out);
  if (dtype == pt::kBFloat16) {
    return launch<__nv_bfloat16>(q, kc, vc, lens, k_new, v_new, wr, o, m_f,
                                 l_f, B, Hq, Hkv, T_len, D, scale,
                                 aligned != 0, splits, st);
  }
  if (dtype == pt::kFloat32) {
    return launch<float>(q, kc, vc, lens, k_new, v_new, wr, o, m_f, l_f, B,
                         Hq, Hkv, T_len, D, scale, aligned != 0, splits, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

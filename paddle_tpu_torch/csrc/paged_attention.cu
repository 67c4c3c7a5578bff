// K2 / K2' — paged decode attention over a block table, for Hopper
// (sm_90a), in two modes: `paged_kernel`.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `_kernel` (launched by `_paged_call`, the pl.pallas_call at :306) in
// both of its modes:
//
// - plain (`paged_decode_attention`): query row b attends over its first
//   lengths[b] cached tokens, read through page_table[b]; optionally
//   returns the running max m and denominator l of its online softmax;
// - fused (`paged_append_attend`): the same, plus the fresh K/V row of
//   the current token folded in as one more key, and that row written
//   into pool page write_pids[b] at row lengths[b] % page, in place (the
//   pools are the caller's tensors, as `input_output_aliases` makes them
//   on the TPU).
//
// Layouts: q (B, Hq, D); pools (P, Hkv, page, D); page_table
// (B, max_pages) int32; lengths, write_pids (B,) int32; k_row/v_row
// (B, Hkv, D); o (B, Hq, D); m/l (B, Hq) fp32. GQA query head h reads kv
// head h / (Hq / Hkv). A row of length 0 gives o = 0, m = -inf, l = 0
// (fused: the fresh row alone).
//
// Bound on the H100: bytes. A decode step does 4 FLOP per cached K/V
// element it reads, far below the ridge (about 295 FLOP per byte), so
// the floor is reading each row's valid K/V once (3.35 TB/s): 1.6 MB,
// 2 us for the serving case's 8 rows of up to 256 keys over 16 kv heads.
// What the chip run says is left (an H100 80GB HBM3 at 700 W, PERF.md
// §6): the serving case takes 8.3 us, 4x the bound, a block's chain of
// latencies (the launch, a table read and a bulk-copy round trip per
// ring fill, two cluster barriers around the merge), which no part of
// the kernel measures apart; a cluster of 8 instead of 4 was slower
// (11.6 us: more blocks than the SMs hold at once, a wider merge). The
// suffix prefill's 64 query rows over one sequence (29 us) read that
// sequence's tiles once per row, 86 MB through L2 for 1.4 MB of K/V:
// rows of one table do not share a tile.
//
// Design.
// - Page tiles by bulk copy. One kv head's rows of one page are a run of
//   page x D contiguous elements, and page is a multiple of kTile = 16
//   rows (the engines use multiples of 128), so a 16-row tile never
//   straddles a page: it is one 1D bulk copy (cp.async.bulk ...
//   mbarrier::complete_tx) of K and one of V, addressed through one
//   table read per tile. Tiles land in a ring of `stages` mbarrier'd
//   slots, and the block requests all the tiles its ring holds before it
//   computes. Only tiles that hold valid rows are copied; rows past the
//   length are masked, and their values zeroed (a reused page may hold an
//   earlier sequence's rows, NaN included). Where D * sizeof(T) or a
//   pointer breaks 16-byte alignment (a head dim of 36 in bf16), the
//   same kernel stages each tile by threads: the wrapper picks that by
//   layout before the launch.
// - Split each (row, kv head) over a thread-block cluster. The grid is
//   (S, Hkv, B) with cluster dims (S, 1, 1); S and the ring's depth come
//   from static shapes, the table's width max_pages x page and the
//   launch's B x Hkv (ops/paged_attention.py `cluster_size`: at most 8,
//   64 table rows a block at least, 4 blocks an SM at most;
//   `ring_stages`), so the host never reads lengths. Block s walks an
//   equal share of its row's valid tiles; a block whose share is empty
//   still joins the cluster's barriers. With one block per (row, kv
//   head), the longest row's walk would set the launch's time on one SM.
// - Compute from shared memory and merge through distributed shared
//   memory with K10's pieces (csrc/decode_attn.cuh): 16 bytes of a row a
//   lane, the score reduced across the row's lanes by shuffles, all G
//   query rows of the kv head on each K/V row read, a fp32 online
//   softmax per warp with the -1e30 floor on its max (p is not rounded
//   before the value product, as the TPU kernel's is not); the warps
//   merge in shared memory, the blocks through map_shared_rank. No
//   workspace, no second launch.
// - The fresh row inside (fused mode). The block that owns the row's
//   last tile (block 0 when the row is empty) folds k_row / v_row in as
//   one more key, read from k_row / v_row, and after its walk writes
//   them into pool[write_pids[b], h, lengths[b] % page].
//
// Why the fused write is race-free. No block reads the row it writes
// while the write can land: every block reads only tiles that hold rows
// < lengths[b], and the one tile that may also hold row lengths[b] (the
// last, when lengths[b] % 16 != 0) is the writer's own, whose copy has
// completed before the writer stores (it waited on the tile's mbarrier,
// or staged it behind a block barrier). The other blocks of the cluster
// hold earlier tiles. The write page is never a shared prefix page,
// because the prefix cache copies a shared page before a sequence may
// write into it (copy-on-write in inference/prefix_cache.py and the
// engine's admission), so no other row's cluster reads it. Inactive
// slots all write the one scratch page; several clusters may then write
// the same row, which is harmless: nothing reads the scratch page.
#include <cstdint>

#include "decode_attn.cuh"
#include "sm90.cuh"

namespace {

using namespace dattn;

constexpr int kMaxStages = 8;          // ring slots, at most

// G: the group size the registers are sized for (1, 2, 4 or 8; see
// dattn::Online). aligned: D * sizeof(T) is a multiple of 16 and every
// pointer 16-byte aligned (bulk copies, 16-byte loads). Plain mode when
// k_row is null.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const T* __restrict__ q, T* __restrict__ kp,
             T* __restrict__ vp, const int* __restrict__ table,
             const int* __restrict__ lengths, const T* __restrict__ k_row,
             const T* __restrict__ v_row, const int* __restrict__ write_pids,
             T* __restrict__ o, float* __restrict__ m_out,
             float* __restrict__ l_out, int Hq, int Hkv, int D, int page,
             int max_pages, int stages, float scale, bool aligned) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const bool fused = k_row != nullptr;
  const int len = max(0, min(lengths[b], max_pages * page));
  const int n_tiles = (len + kTile - 1) / kTile;
  const int per = (n_tiles + S - 1) / S;
  const int tile0 = min(n_tiles, rank * per);
  const int mine = min(n_tiles, tile0 + per) - tile0;
  // the fused mode's writer: the owner of the last tile, which alone may
  // hold row lengths[b]
  const int writer = n_tiles > 0 ? (n_tiles - 1) / per : 0;
  const int tpp = page / kTile;          // tiles a page
  const int* tab = table + (long)b * max_pages;
  const int tile_elems = kTile * D;
  T* ring = reinterpret_cast<T*>(smem);

  if (aligned && threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s)
      sm90::mbar_init(sm90::smem_u32(&full[s]), 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // the first element of tile t of the row: one table read
  auto tile_off = [&](int t) {
    const long pid = tab[t / tpp];
    return ((pid * Hkv + hk) * page + (long)(t % tpp) * kTile) * D;
  };
  // tile tile0 + j of the share into slot j % stages (one thread)
  auto issue = [&](int j) {
    const int s = j % stages;
    const long off = tile_off(tile0 + j);
    const uint32_t bytes = static_cast<uint32_t>(tile_elems * sizeof(T));
    const uint32_t bar = sm90::smem_u32(&full[s]);
    sm90::mbar_expect_tx(bar, 2 * bytes);
    sm90::bulk_load(sm90::smem_u32(ring + 2 * s * tile_elems), kp + off,
                    bytes, bar);
    sm90::bulk_load(sm90::smem_u32(ring + (2 * s + 1) * tile_elems),
                    vp + off, bytes, bar);
  };
  if (aligned && threadIdx.x == 0) {
    for (int j = 0; j < min(mine, stages); ++j) issue(j);
  }

  Online<T, G> st;
  st.init(q + ((long)b * Hq + hk * group) * D, group, D, aligned);

  for (int j = 0; j < mine; ++j) {
    const int s = j % stages;
    T* ks = ring + 2 * s * tile_elems;
    T* vs = ks + tile_elems;
    if (aligned) {
      sm90::mbar_wait(sm90::smem_u32(&full[s]), (j / stages) & 1);
    } else {
      // staged by threads; the slot is free (the last tile ended in a
      // barrier)
      const long off = tile_off(tile0 + j);
      for (int i = threadIdx.x; i < tile_elems; i += kThreads) {
        ks[i] = kp[off + i];
        vs[i] = vp[off + i];
      }
      __syncthreads();
    }
    // p as it is; the values of rows past the length zeroed
    st.template tile<false, true>(ks, vs, (tile0 + j) * kTile, len, D,
                                  aligned, scale);
    __syncthreads();                     // every warp is done with slot s
    if (aligned && threadIdx.x == 0 && j + stages < mine) issue(j + stages);
  }

  if (fused && rank == writer) {
    // every copy of this block has landed: the fresh row, attended from
    // k_row / v_row, goes into its page
    const long src = ((long)b * Hkv + hk) * D;
    st.template key<false>(k_row + src, v_row + src, D, aligned, scale);
    const long dst =
        (((long)write_pids[b] * Hkv + hk) * page + lengths[b] % page) * D;
    for (int i = threadIdx.x; i < D; i += kThreads) {
      kp[dst + i] = k_row[src + i];
      vp[dst + i] = v_row[src + i];
    }
  }
  st.finish(smem, part_offset(stages, G, D, sizeof(T)), cluster, group, D,
            o, m_out, l_out, (long)b * Hq + hk * group);
}

template <typename T, int G>
int launch_g(const T* q, T* kp, T* vp, const int* tab, const int* lens,
             const T* k_row, const T* v_row, const int* wp, T* o,
             float* m_out, float* l_out, int B, int Hq, int Hkv, int D,
             int page, int max_pages, int stages, float scale, bool aligned,
             int splits, cudaStream_t st) {
  auto kern = paged_kernel<T, G>;
  // above 48 KB only after the attribute: set it once for the deepest
  // ring at the largest head dim
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxStages, G, kDMax, sizeof(T)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch_split(kern, splits, Hkv, B,
                      smem_bytes(stages, G, D, sizeof(T)), st, q, kp, vp,
                      tab, lens, k_row, v_row, wp, o, m_out, l_out, Hq, Hkv,
                      D, page, max_pages, stages, scale, aligned);
}

template <typename T>
int launch(const void* q, void* kp, void* vp, const int* tab,
           const int* lens, const void* k_row, const void* v_row,
           const int* wp, void* o, float* m_out, float* l_out, int B,
           int Hq, int Hkv, int D, int page, int max_pages, int stages,
           float scale, bool aligned, int splits, cudaStream_t st) {
  const int group = Hq / Hkv;
  const T* qp = static_cast<const T*>(q);
  T* kpp = static_cast<T*>(kp);
  T* vpp = static_cast<T*>(vp);
  const T* kr = static_cast<const T*>(k_row);
  const T* vr = static_cast<const T*>(v_row);
  T* op = static_cast<T*>(o);
#define PT_PAGED_LAUNCH(G)                                                 \
  return launch_g<T, G>(qp, kpp, vpp, tab, lens, kr, vr, wp, op, m_out,    \
                        l_out, B, Hq, Hkv, D, page, max_pages, stages,     \
                        scale, aligned, splits, st)
  if (group <= 1) PT_PAGED_LAUNCH(1);
  if (group <= 2) PT_PAGED_LAUNCH(2);
  if (group <= 4) PT_PAGED_LAUNCH(4);
  if (group <= 8) PT_PAGED_LAUNCH(8);
#undef PT_PAGED_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain mode when k_row is null (then v_row and write_pids are unused);
// stats when m_out is non-null (then l_out too). aligned: D * elt is a
// multiple of 16 and every pointer 16-byte aligned. splits: the blocks of
// a row's cluster, 1, 2, 4 or 8; stages: the ring's slots, 1..8. The
// caller guarantees D <= 128, Hq % Hkv == 0, Hq / Hkv <= 8, page % 16 ==
// 0 and B, Hkv > 0.
extern "C" int pt_paged_attention(int dtype, const void* q, void* kp,
                                  void* vp, const void* table,
                                  const void* lengths, const void* k_row,
                                  const void* v_row, const void* write_pids,
                                  void* o, void* m_out, void* l_out, int B,
                                  int Hq, int Hkv, int D, int page,
                                  int max_pages, float scale, int aligned,
                                  int splits, int stages, void* stream) {
  if ((splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      stages < 1 || stages > kMaxStages || page % kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* lens = static_cast<const int*>(lengths);
  const int* wp = static_cast<const int*>(write_pids);
  float* m_f = static_cast<float*>(m_out);
  float* l_f = static_cast<float*>(l_out);
  if (dtype == pt::kBFloat16) {
    return launch<__nv_bfloat16>(q, kp, vp, tab, lens, k_row, v_row, wp, o,
                                 m_f, l_f, B, Hq, Hkv, D, page, max_pages,
                                 stages, scale, aligned != 0, splits, st);
  }
  if (dtype == pt::kFloat32) {
    return launch<float>(q, kp, vp, tab, lens, k_row, v_row, wp, o, m_f,
                         l_f, B, Hq, Hkv, D, page, max_pages, stages, scale,
                         aligned != 0, splits, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

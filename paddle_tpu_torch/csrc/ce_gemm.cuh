// The TMA + wgmma mainloop of the fused cross-entropy kernels (sm_90a):
// K5's forward (fused_ce.cu, `ce_fwd_sm90`) and the backward's dl pass,
// K6 and K7 (fused_ce_bwd.cu, `ce_bwd_wgmma`) run their bf16 products
// through it.
//
// A block of three warpgroups owns 128 x 256 output tiles. Warpgroup 0
// is the producer: one thread issues TMA loads of 64-deep stages (128-byte
// swizzle) into a ring of kStages, each stage completing on its `full`
// mbarrier. Warpgroups 1 and 2 are the consumers: each runs wgmma
// m64n256k16 (bf16 in, fp32 accumulate, both operands from shared memory)
// on its 64 rows and releases a stage on its `empty` mbarrier once the
// products that read it have retired. The ring's stage counter runs on
// across tiles, so a block that walks several tiles (K5's range of vocab
// tiles) has the next tile's first stages in flight while its consumers
// run the previous tile's epilogue. Operands are bf16 tensors read
// through 2D tensor maps (`operand_map`); a map's extents are the
// operand's own, so TMA fills rows and columns past them with zeros.
#pragma once

#include "sm90.cuh"

namespace ce {

using namespace sm90;

constexpr int kBM = 128;            // output rows per tile (two warpgroups)
constexpr int kBN = 256;            // output columns per tile
constexpr int kBK = 64;             // stage depth: one 128-byte bf16 row
constexpr int kStages = 4;
constexpr int kWgThreads = 384;     // producer warpgroup + two consumers
constexpr uint32_t kABytes = kBM * kBK * 2;
constexpr uint32_t kStageBytes = kABytes + kBN * kBK * 2;
// the ring, its mbarriers, and slack to align the ring to 1024 bytes
constexpr int kWgSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;

// a stage's operand tile: kRows (M or N) rows from r0, 64 deep from k0.
// K-major: one box {64 deep, kRows} -> [kRows][64], 128-byte rows.
// MN-major: kRows / 64 boxes {64 wide, 64 deep} -> [64 k][64 mn] each.
template <bool kMn, int kRows>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          uint32_t dst, uint32_t bar, int r0,
                                          int k0) {
  if constexpr (kMn) {
#pragma unroll
    for (int i = 0; i < kRows / 64; ++i)
      tma_load(map, dst + i * kAtom, bar, r0 + 64 * i, k0);
  } else {
    tma_load(map, dst, bar, k0, r0);
  }
}

// the ring in dynamic shared memory: its 1024-byte aligned base, then
// full[s] and empty[s] mbarriers after the kStages stages
struct Ring {
  uint32_t base, bars;

  static __device__ Ring at(const void* smem_raw) {
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
    return {base, base + kStages * kStageBytes};
  }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (kStages + s); }
  __device__ uint32_t tile(int s) const { return base + s * kStageBytes; }

  // thread 0 initialises the barriers (one producer arrival with its
  // bytes, one arrival per consumer warpgroup); the caller syncs after
  __device__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    mbar_fence_init();
  }
};

// producer (one thread): the stages of `ntiles` tiles in turn, tile i at
// rows m0 of A and columns n0 + i * kBN of B, each nk stages deep; the
// ring's stage counter starts at 0
template <bool kAMn, bool kBMn>
__device__ __forceinline__ void produce(const Ring& ring,
                                        const CUtensorMap* ta,
                                        const CUtensorMap* tb, int m0,
                                        int n0, int ntiles, int nk) {
  int it = 0;
  for (int i = 0; i < ntiles; ++i) {
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(ring.empty(s), (it / kStages - 1) & 1);
      const uint32_t full = ring.full(s);
      const uint32_t tile = ring.tile(s);
      mbar_expect_tx(full, kStageBytes);
      load_tile<kAMn, kBM>(ta, tile, full, m0, kt * kBK);
      load_tile<kBMn, kBN>(tb, tile + kABytes, full, n0 + i * kBN,
                           kt * kBK);
    }
  }
}

// consumer warpgroup cw (thread t of it): acc (64 x 256 of the tile, in
// sm90.cuh's accumulator layout) += its rows of A . B over the nk stages
// from the ring's stage `it`, which it advances; every stage is released
// once its products have retired, the last one before returning
template <bool kAMn, bool kBMn>
__device__ __forceinline__ void consume(const Ring& ring, float (&acc)[128],
                                        int cw, int t, int nk, int& it) {
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int s = it % kStages;
    mbar_wait(ring.full(s), (it / kStages) & 1);
    const uint32_t tile = ring.tile(s);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_n256<kAMn, kBMn>(acc, operand_desc<kAMn>(tile, cw, kk),
                             operand_desc<kBMn>(tile + kABytes, 0, kk));
    wgmma_commit();
    fence_acc(acc);
    // the previous stage's products are done: release its buffers
    wgmma_wait<1>();
    if (kt > 0 && t == 0) mbar_arrive(ring.empty((it - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (nk > 0 && t == 0) mbar_arrive(ring.empty((it - 1) % kStages));
}

// ---- host ------------------------------------------------------------------

// the map of a bf16 operand stored as `outer` rows of `inner` elements,
// `ld` apart, read as a kMn / kRows tile of load_tile (K-major: boxes {64,
// kRows}; MN-major: {64, 64}); entries past the extents read as zeros
template <bool kMn, int kRows>
int operand_map(CUtensorMap* map, const void* base, long inner, long outer,
                long ld) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, kMn ? 64u : static_cast<cuuint32_t>(kRows)};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r =
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
          dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ce

// Split-K Hyft attention over a paged KV pool, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package (src/repro/kernels/):
//   hyft_paged_decode  <- flash_attention.py:660 _paged_decode_kernel
//                         (pallas_call at :747, entry flash_hyft_decode_paged)
//   hyft_paged_verify  <- flash_attention.py:823 _verify_paged_kernel
//                         (pallas_call at :925, paged flash_hyft_verify)
// The TPU routed grid step (b, j) to physical page bt[b, j] through a
// scalar-prefetched block table in its BlockSpec index maps.  Here each
// block loads its own page index from the table on the device (the table
// is never copied to the host) and runs the tile of hyft_splitk_tile.cuh
// with one page as its split, so the arithmetic is that of the contiguous
// kernels at bk == page size: bitwise the same for a sequential table.
//
// Pages are smaller than the contiguous kernels' 64-key sub-tile (16 keys
// by default), so the sub-tile is min(64, ps) keys: ps in {8, 16, 32, 64,
// 128, 256}; any other page size is refused (cudaErrorInvalidValue, which
// the wrapper raises), never sent elsewhere.  The grid covers every virtual
// block of the table: blocks past a sequence's length map to the null page
// 0 and are fully masked, and they are computed and combined as in JAX.
//
// What bounds it on an H100: decode reads each live page of K/V once for
// the GQA group's rows (8 slots x 2048 virtual keys x 2 heads: 33.6 MB of
// fp32 K/V, 8.4 MB + 262 KB of scales as fp2fx8) and writes the per-page
// split stats (acc alone is (B*Hkv, nb, g, D) f32, 6.3 MB at 8 slots and
// 128 pages); it is bound by memory bandwidth.  A prompt chunk is bound by
// fp32 FMAs, as the contiguous one.  A first version, plain like
// hyft_splitk.cu: the query tile is staged again for every page, and a
// fused combine (no split outputs in device memory) is later work.

#include "hyft_splitk_tile.cuh"

namespace {

using namespace hyft_splitk;

template <bool kPerLane>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* bt, const void* mask, void* acc, void* m, void* l, int kv_type,
             int bh, int hkv, int rows, int nb, int ps, int d, int sq, float scale,
             int frac, int total, int mant, int acc_bits, int step, void* stream) {
  const HyftParams h{frac, total, mant, acc_bits, step};
  if (nb <= 0 || ps <= 0 || !valid_common(rows, nb * ps, sq, h))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sk = nb * ps;   // the virtual KV length
#define HYFT_PAGED(KK)                                                                \
  launch_typed<kPerLane, true, KK>(q, k, v, ks, vs, bt, mask, acc, m, l, kv_type, bh, \
                                   hkv, rows, sk, ps, d, sq, scale, h, s)
  switch (ps) {
    case 8: return HYFT_PAGED(8);
    case 16: return HYFT_PAGED(16);
    case 32: return HYFT_PAGED(32);
    case 64:
    case 128:
    case 256: return HYFT_PAGED(64);
    default: return cudaErrorInvalidValue;
  }
#undef HYFT_PAGED
}

}  // namespace

extern "C" {

// Decode (Sq = 1): q (BH, rows, D) f32 with rows = the GQA group; k, v
// pools (n_pages + 1, Hkv, ps, D) of kv_type (0 f32, 1 bf16, 2 int8 with
// f32 scales (n_pages + 1, Hkv, ps)); bt (B, nb) i32 physical page of each
// virtual block; mask (B, nb * ps) f32 over the virtual KV axis.  Writes acc
// (BH, nb, rows, D) f32, m (BH, nb, rows) i32, l (BH, nb, rows) f32: one
// split per page.  Returns the cudaError_t of the launch.
int hyft_paged_decode(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* bt, const void* mask, void* acc, void* m,
                      void* l, int kv_type, int bh, int hkv, int rows, int nb, int ps,
                      int d, int sq, float scale, int frac, int total, int mant,
                      int acc_bits, int step, void* stream) {
  return dispatch<false>(q, k, v, ks, vs, bt, mask, acc, m, l, kv_type, bh, hkv, rows, nb,
                         ps, d, 1, scale, frac, total, mant, acc_bits, step, stream);
}

// Chunk attention (Sq >= 1) over the pool: as paged decode, with rows =
// g * sq (row r is token lane r % sq) and a per-lane mask (B, sq, nb * ps).
int hyft_paged_verify(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* bt, const void* mask, void* acc, void* m,
                      void* l, int kv_type, int bh, int hkv, int rows, int nb, int ps,
                      int d, int sq, float scale, int frac, int total, int mant,
                      int acc_bits, int step, void* stream) {
  if (sq <= 0 || rows % sq != 0) return cudaErrorInvalidValue;
  return dispatch<true>(q, k, v, ks, vs, bt, mask, acc, m, l, kv_type, bh, hkv, rows, nb,
                        ps, d, sq, scale, frac, total, mant, acc_bits, step, stream);
}

}  // extern "C"

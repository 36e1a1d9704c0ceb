// Hyft attention over a paged KV pool, both levels of the split-K tree in
// one launch, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package (src/repro/kernels/):
//   hyft_paged_decode  <- flash_attention.py:660 _paged_decode_kernel
//                         (pallas_call at :747, entry flash_hyft_decode_paged)
//   hyft_paged_verify  <- flash_attention.py:823 _verify_paged_kernel
//                         (pallas_call at :925, paged flash_hyft_verify)
// together with the level-2 merge that JAX runs outside the pallas_call
// (_splitk_combine).  The TPU routed grid step (b, j) to physical page
// bt[b, j] through a scalar-prefetched block table; here each block reads
// the page indices from the table on the device.  Every page is one split;
// the kernels (decode_kernel, verify_kernel) and what bounds them are in
// hyft_attend.cuh, shared with the contiguous cache (hyft_splitk.cu): a
// sequential table over pages of bk keys gives that cache's bits.  Page
// sizes 8, 16, 32, 64, 128 and 256, head widths 16, 64, 112, 128 and 192;
// anything else is refused (cudaErrorInvalidValue, which the wrapper
// raises).  Any number of pages and any GQA group is served.  The kernels
// of each head width are built in hyft_attend_d<D>.cu; this source holds
// the entries.

#include "hyft_attend.cuh"

namespace {

using namespace hyft_attend;

template <bool kDecode>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* bt, const void* mask, void* out, int kv_type, int bh, int hkv,
             int rows, int nb, int ps, int d, int sq, float scale, int frac, int total,
             int mant, int acc_bits, int step, void* stream) {
  const Args a{q,  k,    v,  ks, vs, bt, mask,  out, bh, hkv, rows, nb, nb * ps, sq,
               scale, {frac, total, mant, acc_bits, step}, static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return cudaErrorInvalidValue;
  return launch_any(a, d, kDecode, true, ps, kv_type);
}

}  // namespace

extern "C" {

// Decode (Sq = 1): q (BH, rows, D) f32 with rows = the GQA group and D =
// d, one of 16, 64, 112, 128 and 192; k, v pools (n_pages + 1, Hkv, ps, D) of kv_type (0 f32, 1 bf16, 2
// int8 with f32 scales (n_pages + 1, Hkv, ps)), 16-byte aligned; bt (B, nb)
// i32 physical page of each virtual block; mask (B, nb * ps) f32 over the
// virtual KV axis.  Writes out (BH, rows, D) f32, the finalized attention.
// Returns the cudaError_t of the launch.
int hyft_paged_decode(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* bt, const void* mask, void* out,
                      int kv_type, int bh, int hkv, int rows, int nb, int ps, int d, int sq,
                      float scale, int frac, int total, int mant, int acc_bits, int step,
                      void* stream) {
  return dispatch<true>(q, k, v, ks, vs, bt, mask, out, kv_type, bh, hkv, rows, nb, ps, d,
                        1, scale, frac, total, mant, acc_bits, step, stream);
}

// Chunk attention (Sq >= 1) over the pool: as paged decode, with rows =
// g * sq (row r is token lane r % sq, any number of rows) and a per-lane
// mask (B, sq, nb * ps).
int hyft_paged_verify(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* bt, const void* mask, void* out,
                      int kv_type, int bh, int hkv, int rows, int nb, int ps, int d, int sq,
                      float scale, int frac, int total, int mant, int acc_bits, int step,
                      void* stream) {
  return dispatch<false>(q, k, v, ks, vs, bt, mask, out, kv_type, bh, hkv, rows, nb, ps, d,
                         sq, scale, frac, total, mant, acc_bits, step, stream);
}

}  // extern "C"

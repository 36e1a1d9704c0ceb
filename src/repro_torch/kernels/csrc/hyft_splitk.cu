// Split-K Hyft attention over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package (src/repro/kernels/):
//   hyft_splitk_decode  <- flash_attention.py:541 _decode_fwd_kernel
//                          (pallas_call at :619, entry flash_hyft_decode)
//   hyft_splitk_verify  <- flash_attention.py:804 _verify_fwd_kernel
//                          (pallas_call at :963, contiguous flash_hyft_verify)
// Both run the templated tile of hyft_splitk_tile.cuh (the port of
// _decode_tile), with splits of bk keys over a (BH, sk, D) stripe.  The
// paged kernels (hyft_paged.cu) compute the same level 1 per page and
// merge the pages themselves.
//
// What bounds it on an H100: decode (Sq = 1, rows = the GQA group) reads the
// whole K/V cache for a handful of rows and is bound by memory bandwidth
// (qwen2-1.5b, B = 4, Sk = 1057: 8.66 MB of fp32 K/V per layer per step,
// 2.16 MB + 68 KB of scales as fp2fx8).  A prompt chunk (Sq = 1024, rows =
// 6144) is bound by fp32 FMAs (about 26.6 GFLOP per layer).  This first
// version is plain: one block per (row tile, split, b*Hkv), K/V staged
// through shared memory in 64-key sub-tiles, scores and PV by fp32 FMAs in
// a fixed order, no tensor cores and no TF32.  wgmma, TMA and a fused
// combine are later work.

#include "hyft_splitk_tile.cuh"

namespace {

using namespace hyft_splitk;

constexpr int kKeys = 64;   // keys of one K/V sub-tile in shared memory

template <bool kPerLane>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* mask, void* acc, void* m, void* l, int kv_type, int bh, int hkv,
             int rows, int sk, int bk, int d, int sq, float scale, int frac, int total,
             int mant, int acc_bits, int step, void* stream) {
  const HyftParams h{frac, total, mant, acc_bits, step};
  if (bk % kKeys != 0 || bk <= 0 || !valid_common(rows, sk, sq, h))
    return cudaErrorInvalidValue;
  return launch_typed<kPerLane, kKeys>(q, k, v, ks, vs, mask, acc, m, l, kv_type, bh,
                                       hkv, rows, sk, bk, d, sq, scale, h,
                                       static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Decode (Sq = 1): q (BH, rows, D) f32 with rows = the GQA group; k, v
// (BH, sk, D) of kv_type (0 f32, 1 bf16, 2 int8 with f32 scales (BH, sk));
// mask (B, sk) f32 shared by every row.  Writes acc (BH, ns, rows, D) f32,
// m (BH, ns, rows) i32, l (BH, ns, rows) f32 with ns = ceil(sk / bk).
// Returns the cudaError_t of the launch.
int hyft_splitk_decode(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const void* mask, void* acc, void* m, void* l,
                       int kv_type, int bh, int hkv, int rows, int sk, int bk, int d,
                       int sq, float scale, int frac, int total, int mant, int acc_bits,
                       int step, void* stream) {
  return dispatch<false>(q, k, v, ks, vs, mask, acc, m, l, kv_type, bh, hkv, rows, sk, bk,
                         d, 1, scale, frac, total, mant, acc_bits, step, stream);
}

// Chunk attention (Sq >= 1): as decode, with rows = g * sq (row r is token
// lane r % sq) and a per-lane mask (B, sq, sk).
int hyft_splitk_verify(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const void* mask, void* acc, void* m, void* l,
                       int kv_type, int bh, int hkv, int rows, int sk, int bk, int d,
                       int sq, float scale, int frac, int total, int mant, int acc_bits,
                       int step, void* stream) {
  if (sq <= 0 || rows % sq != 0) return cudaErrorInvalidValue;
  return dispatch<true>(q, k, v, ks, vs, mask, acc, m, l, kv_type, bh, hkv, rows, sk, bk,
                        d, sq, scale, frac, total, mant, acc_bits, step, stream);
}

const char* hyft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

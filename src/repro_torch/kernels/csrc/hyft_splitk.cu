// Split-K Hyft attention over a contiguous KV cache, both levels of the
// split-K tree in one launch, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package (src/repro/kernels/):
//   hyft_splitk_decode  <- flash_attention.py:541 _decode_fwd_kernel
//                          (pallas_call at :619, entry flash_hyft_decode)
//   hyft_splitk_verify  <- flash_attention.py:804 _verify_fwd_kernel
//                          (pallas_call at :963, contiguous flash_hyft_verify)
// together with the level-2 merge that JAX runs outside the pallas_call
// (_splitk_combine): only the finalized (BH, rows, D) output is written.
// The kernels are hyft_attend.cuh's, over the (BH, sk, D) stripe with
// splits of bk keys (64, 128 or 256) in the place of pages; the last split
// may be ragged.
//
// What bounds them on an H100: decode (Sq = 1, rows = the GQA group) reads
// the whole K/V cache for a handful of rows and is bound by bytes
// (qwen2-1.5b, B = 4, Sk = 1057: 8.66 MB of fp32 K/V per layer per step,
// 2.16 MB + 68 KB of scales as fp2fx8), at these sizes by the latency of
// its loads: a cluster of 8 blocks per (b, kv head) streams them through a
// cp.async ring.  A causal prompt (Sq = 1024, rows = 6144) is bound by
// fp32 FMAs over the keys each row attends to (12.9 GFLOP per layer):
// register tiles fed by float4 loads, and 64-key tiles masked for a whole
// block skipped.  No tensor cores and no TF32.  The kernels of each head
// width are built in hyft_attend_d<D>.cu; this source holds the entries.

#include "hyft_attend.cuh"

namespace {

using namespace hyft_attend;

template <bool kDecode>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* mask, void* out, int kv_type, int bh, int hkv, int rows, int sk,
             int bk, int d, int sq, float scale, int frac, int total, int mant,
             int acc_bits, int step, void* stream) {
  const Args a{q, k, v, ks, vs, nullptr, mask, out, bh, hkv, rows,
               bk > 0 ? (sk + bk - 1) / bk : 0, sk, sq, scale,
               {frac, total, mant, acc_bits, step}, static_cast<cudaStream_t>(stream)};
  if (!valid(a) || (bk != 64 && bk != 128 && bk != 256)) return cudaErrorInvalidValue;
  return launch_any(a, d, kDecode, false, bk, kv_type);
}

}  // namespace

extern "C" {

// Decode (Sq = 1): q (BH, rows, D) f32 with rows = the GQA group and D =
// d, one of 16, 64, 112, 128 and 192; k, v (BH, sk, D) of kv_type (0 f32, 1 bf16, 2 int8 with f32 scales
// (BH, sk)), 16-byte aligned; mask (B, sk) f32 shared by every row; splits
// of bk keys.  Writes out (BH, rows, D) f32, the finalized attention.
// Returns the cudaError_t of the launch.
int hyft_splitk_decode(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const void* mask, void* out, int kv_type, int bh,
                       int hkv, int rows, int sk, int bk, int d, int sq, float scale,
                       int frac, int total, int mant, int acc_bits, int step, void* stream) {
  return dispatch<true>(q, k, v, ks, vs, mask, out, kv_type, bh, hkv, rows, sk, bk, d, 1,
                        scale, frac, total, mant, acc_bits, step, stream);
}

// Chunk attention (Sq >= 1): as decode, with rows = g * sq (row r is token
// lane r % sq, any number of rows) and a per-lane mask (B, sq, sk).
int hyft_splitk_verify(const void* q, const void* k, const void* v, const void* ks,
                       const void* vs, const void* mask, void* out, int kv_type, int bh,
                       int hkv, int rows, int sk, int bk, int d, int sq, float scale,
                       int frac, int total, int mant, int acc_bits, int step, void* stream) {
  return dispatch<false>(q, k, v, ks, vs, mask, out, kv_type, bh, hkv, rows, sk, bk, d, sq,
                         scale, frac, total, mant, acc_bits, step, stream);
}

const char* hyft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

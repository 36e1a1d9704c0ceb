// Split-K Hyft attention, level 1 of the paper's tree, for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package (src/repro/kernels/):
//   hyft_splitk_decode  <- flash_attention.py:541 _decode_fwd_kernel
//                          (pallas_call at :619, entry flash_hyft_decode)
//   hyft_splitk_verify  <- flash_attention.py:804 _verify_fwd_kernel
//                          (pallas_call at :963, contiguous flash_hyft_verify)
// Both run one templated routine, splitk_tile_kernel, which is the port of
// _decode_tile (:497): per KV split, z = q.k * scale, masked entries set to
// NEG_BIG, FP2FX, the integer (strided) max, the Booth exponent unit, the
// fixed-point sum and PV.  It writes the split-local (acc, m_loc, l_loc);
// the combine across splits (_splitk_combine) stays in torch, as in JAX.
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
//
// Arithmetic rules that keep it equal to the JAX reference:
//  * each score is one fmaf chain over d = 0..D-1 and each PV output one
//    fmaf chain over the split's keys in order, whatever the tiling, so a
//    row's result does not depend on how many rows share its block (verify
//    at Sq = 1 is bitwise decode);
//  * masking happens on the float score before FP2FX; NEG_BIG * 2^frac
//    overflows to -inf and the clip saturates it to the fixed-point minimum;
//  * the Hyft arithmetic is hyft_numerics.cuh's, shared with hyft_flash.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "hyft_numerics.cuh"

namespace {

using hyft::expfloat_to_fx;
using hyft::exp_unit;
using hyft::fp2fx;
using hyft::kNegBig;
using hyft::pow2_float;
using HyftParams = hyft::Params;

constexpr int kThreads = 256;
constexpr int kRows = 16;   // query rows of one block
constexpr int kKeys = 64;   // keys of one K/V sub-tile in shared memory

// One block: kRows query rows of one (b, kv head) against one split of bk
// keys.  Grid (row tiles, splits, B*Hkv).  Shared memory (dynamic):
//   sq  [kRows][D]        the query rows
//   skv [kKeys][D + 1]    one K or V sub-tile (padded: no bank conflicts)
//   sz  [kRows][bk]       fixed-point scores, then the probabilities p
//   sa  [kRows][bk]       the adder-tree addends
template <typename KV, bool kPerLane, int D>
__global__ void __launch_bounds__(kThreads) splitk_tile_kernel(
    const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const float* __restrict__ mask, float* __restrict__ acc_out,
    int* __restrict__ m_out, float* __restrict__ l_out, int hkv, int rows, int sk,
    int bk, int sq, float sm_scale, HyftParams h) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kScoreRows = kRows / (kThreads / kKeys);  // rows per thread, QK
  constexpr int kPvRows = kRows * D / kThreads;           // rows per thread, PV
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_kv = s_q + kRows * D;
  float* s_z = s_kv + kKeys * (D + 1);
  int* s_zi = reinterpret_cast<int*>(s_z);
  float* s_a = s_z + kRows * bk;
  __shared__ int s_max[kRows];
  __shared__ float s_l[kRows];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int ns = gridDim.y;
  const int bh = blockIdx.z;
  const int b = bh / hkv;
  const int s0 = split * bk;
  const long kv_row0 = static_cast<long>(bh) * sk;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int row = row0 + i / D;
    s_q[i] = row < rows ? q[(static_cast<long>(bh) * rows + row) * D + i % D] : 0.0f;
  }

  // stage keys [s0 + kt, s0 + kt + kKeys) of K or V, dequantized; keys past
  // sk (the ragged last split) read as zero, as the JAX wrapper's padding
  auto stage = [&](const KV* src, const float* scale, int kt) {
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int jl = i / D, d = i % D;
      const int j = s0 + kt + jl;
      float val = 0.0f;
      if (j < sk) {
        val = hyft::load_f32(src, (kv_row0 + j) * D + d);
        if constexpr (kQuant) val *= scale[kv_row0 + j];
      }
      s_kv[jl * (D + 1) + d] = val;
    }
  };

  // ---- scores -> FP2FX raws.  Thread: key jj of the sub-tile, kScoreRows rows
  const int jj = tid % kKeys;
  const int rq0 = (tid / kKeys) * kScoreRows;
  for (int kt = 0; kt < bk; kt += kKeys) {
    __syncthreads();
    stage(k, k_scale, kt);
    __syncthreads();
    float dot[kScoreRows];
#pragma unroll
    for (int rr = 0; rr < kScoreRows; ++rr) dot[rr] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float kd = s_kv[jj * (D + 1) + d];
#pragma unroll
      for (int rr = 0; rr < kScoreRows; ++rr)
        dot[rr] = fmaf(s_q[(rq0 + rr) * D + d], kd, dot[rr]);
    }
    const int j = s0 + kt + jj;
#pragma unroll
    for (int rr = 0; rr < kScoreRows; ++rr) {
      const int r = rq0 + rr;
      const int row = row0 + r;
      float valid = 0.0f;
      if (j < sk && row < rows) {
        const long mi = kPerLane
                            ? (static_cast<long>(b) * sq + row % sq) * sk + j
                            : static_cast<long>(b) * sk + j;
        valid = mask[mi];
      }
      const float z = valid > 0.0f ? dot[rr] * sm_scale : kNegBig;
      s_zi[r * bk + kt + jj] = fp2fx(z, h.frac, h.total);
    }
  }
  __syncthreads();

  // ---- integer max per row over every step-th key of the split
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    int mx = INT_MIN;
    for (int j = lane * h.step; j < bk; j += 32 * h.step) mx = max(mx, s_zi[r * bk + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) s_max[r] = mx;
  }
  __syncthreads();

  // ---- exponent unit: probabilities p and fixed-point addends
  for (int i = tid; i < kRows * bk; i += kThreads) {
    int e, m;
    exp_unit(s_zi[i] - s_max[i / bk], h.frac, h.mant, e, m);
    s_a[i] = expfloat_to_fx(e, m, h.mant, h.acc);
    s_z[i] = static_cast<float>((1 << h.mant) + m) * pow2_float(e - h.mant);
  }
  __syncthreads();

  // ---- fixed-point sum per row, keys in order
  if (tid < kRows) {
    float l = 0.0f;
    for (int j = 0; j < bk; ++j) l += s_a[tid * bk + j];
    s_l[tid] = l;
  }

  // ---- PV.  Thread: column dc, kPvRows rows
  const int dc = tid % D;
  const int rp0 = (tid / D) * kPvRows;
  float acc[kPvRows];
#pragma unroll
  for (int rr = 0; rr < kPvRows; ++rr) acc[rr] = 0.0f;
  for (int kt = 0; kt < bk; kt += kKeys) {
    __syncthreads();
    stage(v, v_scale, kt);
    __syncthreads();
    for (int jl = 0; jl < kKeys; ++jl) {
      const float vd = s_kv[jl * (D + 1) + dc];
#pragma unroll
      for (int rr = 0; rr < kPvRows; ++rr)
        acc[rr] = fmaf(s_z[(rp0 + rr) * bk + kt + jl], vd, acc[rr]);
    }
  }

  const long out_row0 = (static_cast<long>(bh) * ns + split) * rows;
#pragma unroll
  for (int rr = 0; rr < kPvRows; ++rr) {
    const int row = row0 + rp0 + rr;
    if (row < rows) acc_out[(out_row0 + row) * D + dc] = acc[rr];
  }
  if (tid < kRows && row0 + tid < rows) {
    m_out[out_row0 + row0 + tid] = s_max[tid];
    l_out[out_row0 + row0 + tid] = s_l[tid];
  }
}

template <typename KV, bool kPerLane, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* mask, void* acc, void* m, void* l,
                   int bh, int hkv, int rows, int sk, int bk, int sq, float scale,
                   HyftParams h, cudaStream_t stream) {
  auto kern = splitk_tile_kernel<KV, kPerLane, D>;
  const size_t smem = sizeof(float) * (kRows * D + kKeys * (D + 1) + 2 * kRows * bk);
  // raise the dynamic shared memory limit once per instantiation and size
  // (one device per process, as the wrappers use it)
  static size_t smem_allowed = 0;
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_allowed = smem;
  }
  const dim3 grid((rows + kRows - 1) / kRows, (sk + bk - 1) / bk, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const float*>(mask), static_cast<float*>(acc), static_cast<int*>(m),
      static_cast<float*>(l), hkv, rows, sk, bk, sq, scale, h);
  return cudaGetLastError();
}

template <bool kPerLane>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* mask, void* acc, void* m, void* l, int kv_type, int bh, int hkv,
             int rows, int sk, int bk, int d, int sq, float scale, int frac, int total,
             int mant, int acc_bits, int step, void* stream) {
  if (bk % kKeys != 0 || bk <= 0 || rows <= 0 || sk <= 0 || sq <= 0 || step < 1 ||
      mant > frac)
    return cudaErrorInvalidValue;
  const HyftParams h{frac, total, mant, acc_bits, step};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HYFT_LAUNCH(T, DD) \
  launch<T, kPerLane, DD>(q, k, v, ks, vs, mask, acc, m, l, bh, hkv, rows, sk, bk, sq, scale, h, s)
  if (d == 128) {  // the head width of the served models
    if (kv_type == 0) return HYFT_LAUNCH(float, 128);
    if (kv_type == 1) return HYFT_LAUNCH(__nv_bfloat16, 128);
    if (kv_type == 2) return HYFT_LAUNCH(int8_t, 128);
  }
#undef HYFT_LAUNCH
  return cudaErrorInvalidValue;
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
  if (rows % sq != 0) return cudaErrorInvalidValue;
  return dispatch<true>(q, k, v, ks, vs, mask, acc, m, l, kv_type, bh, hkv, rows, sk, bk,
                        d, sq, scale, frac, total, mant, acc_bits, step, stream);
}

const char* hyft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// The split-K Hyft tile: level 1 of the paper's tree, for the contiguous
// kernels (hyft_splitk.cu).
//
// splitk_tile_kernel is the port of the JAX package's _decode_tile
// (src/repro/kernels/flash_attention.py:497): per KV split, z = q.k * scale,
// masked entries set to NEG_BIG, FP2FX, the integer (strided) max, the Booth
// exponent unit, the fixed-point sum and PV.  It writes the split-local
// (acc, m_loc, l_loc); the combine across splits (_splitk_combine) stays in
// torch, as in JAX.  K/V are (BH, sk, D): key j of head bh at row
// bh * sk + j.  The paged kernels (hyft_paged.cu) compute the same level 1
// per page with the same arithmetic and merge the pages themselves; a
// sequential block table over a contiguous pool gives this tile's stats at
// bk == page size followed by the torch combine, bit for bit.
//
// Arithmetic rules that keep it equal to the JAX reference:
//  * each score is one fmaf chain over d = 0..D-1 and each PV output one
//    fmaf chain over the split's keys in order, whatever the tiling, so a
//    row's result depends neither on how many rows share its block nor on
//    the K/V sub-tile size KK (verify at Sq = 1 is bitwise decode);
//  * masking happens on the float score before FP2FX; NEG_BIG * 2^frac
//    overflows to -inf and the clip saturates it to the fixed-point minimum;
//  * the Hyft arithmetic is hyft_numerics.cuh's, shared with hyft_flash.cu.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "hyft_numerics.cuh"

namespace hyft_splitk {
namespace {  // internal linkage: each source that includes this has its own

using hyft::expfloat_to_fx;
using hyft::exp_unit;
using hyft::fp2fx;
using hyft::kNegBig;
using hyft::pow2_float;
using HyftParams = hyft::Params;

constexpr int kThreads = 256;
constexpr int kRows = 16;   // query rows of one block

// One block: kRows query rows of one (b, kv head) against one split of bk
// keys, staged KK keys at a time (KK divides bk).  Grid (row tiles, splits,
// B*Hkv).  Shared memory (dynamic):
//   sq  [kRows][D]        the query rows
//   skv [KK][D + 1]       one K or V sub-tile (padded: no bank conflicts)
//   sz  [kRows][bk]       fixed-point scores, then the probabilities p
//   sa  [kRows][bk]       the adder-tree addends
template <typename KV, bool kPerLane, int KK, int D>
__global__ void __launch_bounds__(kThreads) splitk_tile_kernel(
    const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const float* __restrict__ mask, float* __restrict__ acc_out, int* __restrict__ m_out,
    float* __restrict__ l_out,
    int hkv, int rows, int sk, int bk, int sq, float sm_scale, HyftParams h) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kScoreRows = kRows * KK / kThreads;     // rows per thread, QK
  static_assert(kScoreRows >= 1, "every thread holds a row of the sub-tile");
  constexpr int kPvRows = kRows * D / kThreads;           // rows per thread, PV
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_kv = s_q + kRows * D;
  float* s_z = s_kv + KK * (D + 1);
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
  const long kv_row0 = static_cast<long>(bh) * sk + s0;   // the split's first key

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int row = row0 + i / D;
    s_q[i] = row < rows ? q[(static_cast<long>(bh) * rows + row) * D + i % D] : 0.0f;
  }

  // stage keys [kt, kt + KK) of the split's K or V, dequantized; keys past
  // sk (the ragged last contiguous split) read as zero, as the JAX wrapper's
  // padding
  auto stage = [&](const KV* src, const float* scale, int kt) {
    for (int i = tid; i < KK * D; i += kThreads) {
      const int jl = i / D, d = i % D;
      float val = 0.0f;
      if (s0 + kt + jl < sk) {
        const long r = kv_row0 + kt + jl;
        val = hyft::load_f32(src, r * D + d);
        if constexpr (kQuant) val *= scale[r];
      }
      s_kv[jl * (D + 1) + d] = val;
    }
  };

  // ---- scores -> FP2FX raws.  Thread: key jj of the sub-tile, kScoreRows rows
  const int jj = tid % KK;
  const int rq0 = (tid / KK) * kScoreRows;
  for (int kt = 0; kt < bk; kt += KK) {
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
  for (int kt = 0; kt < bk; kt += KK) {
    __syncthreads();
    stage(v, v_scale, kt);
    __syncthreads();
    for (int jl = 0; jl < KK; ++jl) {
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

// One launch over every (row tile, split, b * Hkv): ceil(sk / bk) splits.
template <typename KV, bool kPerLane, int KK, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* mask, void* acc, void* m,
                   void* l, int bh, int hkv, int rows, int sk, int bk, int sq, float scale,
                   HyftParams h, cudaStream_t stream) {
  auto kern = splitk_tile_kernel<KV, kPerLane, KK, D>;
  const size_t smem = sizeof(float) * (kRows * D + KK * (D + 1) + 2 * kRows * bk);
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
      static_cast<const float*>(mask),
      static_cast<float*>(acc), static_cast<int*>(m), static_cast<float*>(l), hkv, rows,
      sk, bk, sq, scale, h);
  return cudaGetLastError();
}

// The K/V type switch: kv_type 0 f32, 1 bf16, 2 int8 with f32 scales; the
// head width of the served models only.
template <bool kPerLane, int KK>
cudaError_t launch_typed(const void* q, const void* k, const void* v, const void* ks,
                         const void* vs, const void* mask, void* acc,
                         void* m, void* l, int kv_type, int bh, int hkv, int rows, int sk,
                         int bk, int d, int sq, float scale, HyftParams h,
                         cudaStream_t s) {
#define HYFT_LAUNCH(T)                                                               \
  launch<T, kPerLane, KK, 128>(q, k, v, ks, vs, mask, acc, m, l, bh, hkv, rows, sk, \
                               bk, sq, scale, h, s)
  if (d == 128) {
    if (kv_type == 0) return HYFT_LAUNCH(float);
    if (kv_type == 1) return HYFT_LAUNCH(__nv_bfloat16);
    if (kv_type == 2) return HYFT_LAUNCH(int8_t);
  }
#undef HYFT_LAUNCH
  return cudaErrorInvalidValue;
}

inline bool valid_common(int rows, int sk, int sq, HyftParams h) {
  return rows > 0 && sk > 0 && sq > 0 && h.step >= 1 && h.mant <= h.frac;
}

}  // namespace
}  // namespace hyft_splitk

// Fused Hyft flash attention for training on Hopper (sm_90a): the forward
// and the two backward kernels.
//
// Replaces three TPU kernels of the JAX package (src/repro/kernels/):
//   hyft_flash_fwd      <- flash_attention.py:96  _flash_fwd_kernel
//   hyft_flash_bwd_dq   <- flash_attention.py:229 _flash_bwd_dq_kernel
//   hyft_flash_bwd_dkv  <- flash_attention.py:260 _flash_bwd_dkv_kernel
// (pallas_calls in _flash_fwd_impl and _flash_bwd_impl, entry
// flash_hyft_attention and its custom_vjp).
//
// Forward.  The KV blocks are part of the arithmetic: each block of bk keys
// adds one hyft_alpha rescale of the carried (acc, l) and one fx_quantize of
// the carried sum, and the strided max restarts at each block's first key.
// So a block walks the keys of its rows in blocks of exactly bk, in order;
// the row tile is free because rows are independent.  Per block of keys:
// scores (masked before FP2FX), the running integer max, the exponent unit,
// the fixed-point sum, PV, then acc = acc * alpha + pv.  After the last
// block the log-subtract divide, and the row stats (m, l) for the backward.
//
// Backward.  The probabilities come from the final (m, l) through
// log_div(exp_unit(z_raw - m), lod_refloat(l)): elementwise, so the
// backward's blocking is free and only the fp32 summation order of dq, dk
// and dv differs from the reference.  delta = <do, o> is a torch op outside
// the kernels, as in JAX.  dq sums over all keys; dk/dv sum over every
// member of the GQA group and every query row.
//
// What bounds it on an H100: fp32 FMAs.  qwen2-1.5b at B 4, S 1024 (causal):
// 12.9 / 19.3 / 25.8 GFLOP over the unmasked half for forward / dq / dk-dv,
// against a few tens of MB of operands.  This first version is plain: one
// block per (16 query rows, head) or (16 keys, kv head), operands staged
// through shared memory in 64-row sub-tiles and converted to fp32 on load
// (fp32 or bf16 inputs, no cast copies), every dot product one fmaf chain
// in a fixed order, no tensor cores and no TF32.  Fully masked blocks are
// computed as the TPU computes them (under HYFT16 a masked key keeps a
// probability of about 2^-105).  wgmma, TMA, pipelining and skipping masked
// blocks are later work; skipping must first be shown to give the same bits.
//
// Arithmetic rules that keep it equal to the reference:
//  * each score q.k (and each do.v) is one fmaf chain over d = 0..D-1, the
//    same in all three kernels, so the forward and both backward kernels see
//    the same score bits, and a row's result does not depend on its tile;
//  * masking (causal: q_offset + row >= key; the (B, Sk) mask > 0) happens
//    on the float score before FP2FX, with NEG_BIG for both;
//  * the Hyft arithmetic is hyft_numerics.cuh's, shared with hyft_splitk.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "hyft_numerics.cuh"

namespace {

using namespace hyft;

constexpr int kThreads = 256;
constexpr int kRows = 16;  // query rows (forward, dq) or keys (dk/dv) of a block
constexpr int kSub = 64;   // rows of one staged sub-tile of the other operand
constexpr int kScoreRows = kRows / (kThreads / kSub);  // 4 per thread

// the masked, scaled score -- the where()s of _flash_fwd_kernel (:117-122)
__device__ __forceinline__ float masked_score(float dot, float scale, int qi, int ki,
                                              int causal, const float* mask_row) {
  float z = __fmul_rn(dot, scale);
  if (causal && qi < ki) z = kNegBig;
  if (mask_row != nullptr && !(mask_row[ki] > 0.0f)) z = kNegBig;
  return z;
}

// the recomputed probability of the backward -- _recompute_probs (:209-226)
__device__ __forceinline__ float recompute_prob(float z, int m, int e_b, int m_b,
                                                const Params& h) {
  int e, mm;
  exp_unit(fp2fx(z, h.frac, h.total) - m, h.frac, h.mant, e, mm);
  return log_div(e, mm, e_b, m_b, h.mant);
}

// --------------------------------------------------------------------------
// forward.  Grid (ceil(sq / kRows), BH).  Shared memory (dynamic):
//   s_q  [kRows][D]       the query rows
//   s_kv [kSub][D + 1]    one K or V sub-tile (padded: no bank conflicts)
//   s_p  [kRows][bk]      fixed-point scores, then the probabilities p
//   s_a  [kRows][bk]      the adder-tree addends
// --------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, float* __restrict__ o, int* __restrict__ m_out,
    float* __restrict__ l_out, int sq, int sk, int bk, int group, int hq_per_b,
    int q_offset, int causal, float scale, Params h) {
  constexpr int kPvRows = kRows * D / kThreads;  // 8 rows per thread in PV
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_kv = s_q + kRows * D;
  float* s_p = s_kv + kSub * (D + 1);
  int* s_zi = reinterpret_cast<int*>(s_p);
  float* s_a = s_p + kRows * bk;
  __shared__ int s_m[kRows];
  __shared__ float s_l[kRows];
  __shared__ float s_alpha[kRows];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const long kv0 = static_cast<long>(bh / group) * sk;
  const float* mrow = mask ? mask + static_cast<long>(bh / hq_per_b) * sk : nullptr;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int row = row0 + i / D;
    s_q[i] = row < sq ? load_f32(q, (static_cast<long>(bh) * sq + row) * D + i % D) : 0.0f;
  }
  if (tid < kRows) {
    s_m[tid] = -(1 << (h.total - 1));  // the running max starts at fx lo (:109)
    s_l[tid] = 0.0f;
  }

  auto stage = [&](const T* src, int j0, int nkeys) {
    for (int i = tid; i < kSub * D; i += kThreads) {
      const int jl = i / D, d = i % D;
      s_kv[jl * (D + 1) + d] = jl < nkeys ? load_f32(src, (kv0 + j0 + jl) * D + d) : 0.0f;
    }
  };

  const int jj = tid % kSub;                  // scores: key jj, kScoreRows rows
  const int rq0 = (tid / kSub) * kScoreRows;
  const int dc = tid % D;                     // PV: column dc, kPvRows rows
  const int rp0 = (tid / D) * kPvRows;
  const int warp = tid / 32, lane = tid % 32;
  float acc[kPvRows];
#pragma unroll
  for (int rr = 0; rr < kPvRows; ++rr) acc[rr] = 0.0f;

  for (int k0 = 0; k0 < sk; k0 += bk) {
    // ---- stage 1a: scores -> FP2FX raws
    for (int kt = 0; kt < bk; kt += kSub) {
      const int nkeys = min(kSub, bk - kt);
      __syncthreads();
      stage(k, k0 + kt, nkeys);
      __syncthreads();
      if (jj < nkeys) {
        float dot[kScoreRows];
#pragma unroll
        for (int rr = 0; rr < kScoreRows; ++rr) dot[rr] = 0.0f;
        for (int d = 0; d < D; ++d) {
          const float kd = s_kv[jj * (D + 1) + d];
#pragma unroll
          for (int rr = 0; rr < kScoreRows; ++rr)
            dot[rr] = fmaf(s_q[(rq0 + rr) * D + d], kd, dot[rr]);
        }
#pragma unroll
        for (int rr = 0; rr < kScoreRows; ++rr) {
          const int r = rq0 + rr;
          const float z = masked_score(dot[rr], scale, q_offset + row0 + r,
                                       k0 + kt + jj, causal, mrow);
          s_zi[r * bk + kt + jj] = fp2fx(z, h.frac, h.total);
        }
      }
    }
    __syncthreads();

    // ---- stage 1b: strided block max, counted from the block's first key,
    // merged with the running max; the rescale of the carried state
    for (int r = warp; r < kRows; r += kThreads / 32) {
      int mx = INT_MIN;
      for (int j = lane * h.step; j < bk; j += 32 * h.step) mx = max(mx, s_zi[r * bk + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) {
        const int m_old = s_m[r];
        const int m_new = max(m_old, mx);
        s_alpha[r] = hyft_alpha(m_old - m_new, h);
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // ---- stage 2: exponent unit -> probabilities and fixed-point addends
    for (int i = tid; i < kRows * bk; i += kThreads) {
      int e, mm;
      exp_unit(s_zi[i] - s_m[i / bk], h.frac, h.mant, e, mm);
      s_a[i] = expfloat_to_fx(e, mm, h.mant, h.acc);
      s_p[i] = assemble(e, mm, h.mant);
    }
    __syncthreads();

    // ---- carried sum: fx_quantize(l * alpha) + this block's sum, keys in order
    if (tid < kRows) {
      float lb = 0.0f;
      for (int j = 0; j < bk; ++j) lb = __fadd_rn(lb, s_a[tid * bk + j]);
      s_l[tid] = __fadd_rn(fx_quantize(__fmul_rn(s_l[tid], s_alpha[tid]), h.acc), lb);
    }

    // ---- PV over the block's keys in order, then acc = acc * alpha + pv
    float pv[kPvRows];
#pragma unroll
    for (int rr = 0; rr < kPvRows; ++rr) pv[rr] = 0.0f;
    for (int kt = 0; kt < bk; kt += kSub) {
      const int nkeys = min(kSub, bk - kt);
      __syncthreads();
      stage(v, k0 + kt, nkeys);
      __syncthreads();
      for (int jl = 0; jl < nkeys; ++jl) {
        const float vd = s_kv[jl * (D + 1) + dc];
#pragma unroll
        for (int rr = 0; rr < kPvRows; ++rr)
          pv[rr] = fmaf(s_p[(rp0 + rr) * bk + kt + jl], vd, pv[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kPvRows; ++rr)
      acc[rr] = __fadd_rn(__fmul_rn(acc[rr], s_alpha[rp0 + rr]), pv[rr]);
  }
  __syncthreads();

  // ---- stage 3: log-subtract division; the row stats for the backward
#pragma unroll
  for (int rr = 0; rr < kPvRows; ++rr) {
    const int row = row0 + rp0 + rr;
    if (row < sq)
      o[(static_cast<long>(bh) * sq + row) * D + dc] =
          hyft_finalize(acc[rr], s_l[rp0 + rr], h.mant);
  }
  if (tid < kRows && row0 + tid < sq) {
    m_out[static_cast<long>(bh) * sq + row0 + tid] = s_m[tid];
    l_out[static_cast<long>(bh) * sq + row0 + tid] = s_l[tid];
  }
}

// --------------------------------------------------------------------------
// dq.  Grid (ceil(sq / kRows), BH).  Shared memory (dynamic):
//   s_q, s_do [kRows][D]          the query rows and their output gradient
//   s_k, s_v  [kSub][D + 1]       one K and one V sub-tile
//   s_ds      [kRows][kSub]       ds = p (dp - delta)
// --------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ delta,
    const int* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ mask, float* __restrict__ dq, int sq, int sk, int group,
    int hq_per_b, int q_offset, int causal, float scale, Params h) {
  constexpr int kAccRows = kRows * D / kThreads;  // 8 rows per thread in ds.k
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_do = s_q + kRows * D;
  float* s_k = s_do + kRows * D;
  float* s_v = s_k + kSub * (D + 1);
  float* s_ds = s_v + kSub * (D + 1);
  __shared__ int s_m[kRows], s_eb[kRows], s_mb[kRows];
  __shared__ float s_delta[kRows];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const long kv0 = static_cast<long>(bh / group) * sk;
  const float* mrow = mask ? mask + static_cast<long>(bh / hq_per_b) * sk : nullptr;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int row = row0 + i / D;
    const long gi = (static_cast<long>(bh) * sq + row) * D + i % D;
    s_q[i] = row < sq ? load_f32(q, gi) : 0.0f;
    s_do[i] = row < sq ? dout[gi] : 0.0f;
  }
  if (tid < kRows) {
    const int row = row0 + tid;
    const long ri = static_cast<long>(bh) * sq + row;
    int e_b = 0, m_b = 0;
    if (row < sq) lod_refloat(l_in[ri], h.mant, e_b, m_b);
    s_m[tid] = row < sq ? m_in[ri] : 0;
    s_eb[tid] = e_b;
    s_mb[tid] = m_b;
    s_delta[tid] = row < sq ? delta[ri] : 0.0f;
  }

  const int jj = tid % kSub;
  const int rq0 = (tid / kSub) * kScoreRows;
  const int dc = tid % D;
  const int rp0 = (tid / D) * kAccRows;
  float acc[kAccRows];
#pragma unroll
  for (int rr = 0; rr < kAccRows; ++rr) acc[rr] = 0.0f;

  for (int j0 = 0; j0 < sk; j0 += kSub) {
    const int nkeys = min(kSub, sk - j0);
    __syncthreads();
    for (int i = tid; i < kSub * D; i += kThreads) {
      const int jl = i / D, d = i % D;
      const long gi = (kv0 + j0 + jl) * D + d;
      s_k[jl * (D + 1) + d] = jl < nkeys ? load_f32(k, gi) : 0.0f;
      s_v[jl * (D + 1) + d] = jl < nkeys ? load_f32(v, gi) : 0.0f;
    }
    __syncthreads();
    if (jj < nkeys) {
      float dot[kScoreRows], dpv[kScoreRows];
#pragma unroll
      for (int rr = 0; rr < kScoreRows; ++rr) dot[rr] = dpv[rr] = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float kd = s_k[jj * (D + 1) + d];
        const float vd = s_v[jj * (D + 1) + d];
#pragma unroll
        for (int rr = 0; rr < kScoreRows; ++rr) {
          dot[rr] = fmaf(s_q[(rq0 + rr) * D + d], kd, dot[rr]);
          dpv[rr] = fmaf(s_do[(rq0 + rr) * D + d], vd, dpv[rr]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < kScoreRows; ++rr) {
        const int r = rq0 + rr;
        const float z = masked_score(dot[rr], scale, q_offset + row0 + r, j0 + jj,
                                     causal, mrow);
        const float p = recompute_prob(z, s_m[r], s_eb[r], s_mb[r], h);
        s_ds[r * kSub + jj] = __fmul_rn(p, __fsub_rn(dpv[rr], s_delta[r]));
      }
    }
    __syncthreads();
    for (int jl = 0; jl < nkeys; ++jl) {
      const float kd = s_k[jl * (D + 1) + dc];
#pragma unroll
      for (int rr = 0; rr < kAccRows; ++rr)
        acc[rr] = fmaf(s_ds[(rp0 + rr) * kSub + jl], kd, acc[rr]);
    }
  }

#pragma unroll
  for (int rr = 0; rr < kAccRows; ++rr) {
    const int row = row0 + rp0 + rr;
    if (row < sq) dq[(static_cast<long>(bh) * sq + row) * D + dc] = __fmul_rn(acc[rr], scale);
  }
}

// --------------------------------------------------------------------------
// dk/dv.  Grid (ceil(sk / kRows), BHkv); each block walks every member of
// the GQA group and every query row.  Shared memory (dynamic):
//   s_k, s_v   [kRows][D]       the block's keys and values
//   s_q, s_do  [kSub][D + 1]    one sub-tile of query rows and their do
//   s_p, s_ds  [kRows][kSub]    p and ds = p (dp - delta)
// --------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ delta,
    const int* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ mask, float* __restrict__ dk, float* __restrict__ dv,
    int sq, int sk, int group, int hq_per_b, int q_offset, int causal, float scale,
    Params h) {
  constexpr int kAccKeys = kRows * D / kThreads;  // 8 keys per thread in the sums
  extern __shared__ float smem[];
  float* s_k = smem;
  float* s_v = s_k + kRows * D;
  float* s_q = s_v + kRows * D;
  float* s_do = s_q + kSub * (D + 1);
  float* s_p = s_do + kSub * (D + 1);
  float* s_ds = s_p + kRows * kSub;
  __shared__ int s_m[kSub], s_eb[kSub], s_mb[kSub];
  __shared__ float s_delta[kSub];

  const int tid = threadIdx.x;
  const int key0 = blockIdx.x * kRows;
  const int bkv = blockIdx.y;
  const float* mrow =
      mask ? mask + static_cast<long>(bkv * group / hq_per_b) * sk : nullptr;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int key = key0 + i / D;
    const long gi = (static_cast<long>(bkv) * sk + key) * D + i % D;
    s_k[i] = key < sk ? load_f32(k, gi) : 0.0f;
    s_v[i] = key < sk ? load_f32(v, gi) : 0.0f;
  }

  const int jj = tid % kSub;                  // scores: query row jj, kScoreRows keys
  const int kq0 = (tid / kSub) * kScoreRows;
  const int dc = tid % D;                     // sums: column dc, kAccKeys keys
  const int kp0 = (tid / D) * kAccKeys;
  float acc_k[kAccKeys], acc_v[kAccKeys];
#pragma unroll
  for (int kk = 0; kk < kAccKeys; ++kk) acc_k[kk] = acc_v[kk] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const long bh = static_cast<long>(bkv) * group + g;
    for (int r0 = 0; r0 < sq; r0 += kSub) {
      const int nrows = min(kSub, sq - r0);
      __syncthreads();
      for (int i = tid; i < kSub * D; i += kThreads) {
        const int rl = i / D, d = i % D;
        const long gi = (bh * sq + r0 + rl) * D + d;
        s_q[rl * (D + 1) + d] = rl < nrows ? load_f32(q, gi) : 0.0f;
        s_do[rl * (D + 1) + d] = rl < nrows ? dout[gi] : 0.0f;
      }
      if (tid < kSub) {
        const long ri = bh * sq + r0 + tid;
        int e_b = 0, m_b = 0;
        if (tid < nrows) lod_refloat(l_in[ri], h.mant, e_b, m_b);
        s_m[tid] = tid < nrows ? m_in[ri] : 0;
        s_eb[tid] = e_b;
        s_mb[tid] = m_b;
        s_delta[tid] = tid < nrows ? delta[ri] : 0.0f;
      }
      __syncthreads();
      if (jj < nrows) {
        float dot[kScoreRows], dpv[kScoreRows];
#pragma unroll
        for (int kk = 0; kk < kScoreRows; ++kk) dot[kk] = dpv[kk] = 0.0f;
        for (int d = 0; d < D; ++d) {
          const float qd = s_q[jj * (D + 1) + d];
          const float dd = s_do[jj * (D + 1) + d];
#pragma unroll
          for (int kk = 0; kk < kScoreRows; ++kk) {
            dot[kk] = fmaf(qd, s_k[(kq0 + kk) * D + d], dot[kk]);
            dpv[kk] = fmaf(dd, s_v[(kq0 + kk) * D + d], dpv[kk]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < kScoreRows; ++kk) {
          const int key = key0 + kq0 + kk;
          float p = 0.0f, ds = 0.0f;
          if (key < sk) {
            const float z = masked_score(dot[kk], scale, q_offset + r0 + jj, key, causal,
                                         mrow);
            p = recompute_prob(z, s_m[jj], s_eb[jj], s_mb[jj], h);
            ds = __fmul_rn(p, __fsub_rn(dpv[kk], s_delta[jj]));
          }
          s_p[(kq0 + kk) * kSub + jj] = p;
          s_ds[(kq0 + kk) * kSub + jj] = ds;
        }
      }
      __syncthreads();
      for (int rl = 0; rl < nrows; ++rl) {
        const float qd = s_q[rl * (D + 1) + dc];
        const float dd = s_do[rl * (D + 1) + dc];
#pragma unroll
        for (int kk = 0; kk < kAccKeys; ++kk) {
          acc_v[kk] = fmaf(s_p[(kp0 + kk) * kSub + rl], dd, acc_v[kk]);
          acc_k[kk] = fmaf(s_ds[(kp0 + kk) * kSub + rl], qd, acc_k[kk]);
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kAccKeys; ++kk) {
    const int key = key0 + kp0 + kk;
    if (key < sk) {
      const long gi = (static_cast<long>(bkv) * sk + key) * D + dc;
      dk[gi] = __fmul_rn(acc_k[kk], scale);
      dv[gi] = acc_v[kk];
    }
  }
}

// raise the dynamic shared memory limit of a kernel once per instantiation
// and size (one device per process, as the wrappers use it)
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* mask,
                       void* o, void* m, void* l, int bh, int sq, int sk, int bk, int group,
                       int hq_per_b, int q_offset, int causal, float scale, Params h,
                       cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = sizeof(float) * (kRows * D + kSub * (D + 1) + 2 * kRows * bk);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kRows - 1) / kRows, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<float*>(o), static_cast<int*>(m),
      static_cast<float*>(l), sq, sk, bk, group, hq_per_b, q_offset, causal, scale, h);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* delta, const void* m, const void* l, const void* mask,
                      void* dq, int bh, int sq, int sk, int group, int hq_per_b,
                      int q_offset, int causal, float scale, Params h, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  const size_t smem = sizeof(float) * (2 * kRows * D + 2 * kSub * (D + 1) + kRows * kSub);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kRows - 1) / kRows, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(delta),
      static_cast<const int*>(m), static_cast<const float*>(l),
      static_cast<const float*>(mask), static_cast<float*>(dq), sq, sk, group, hq_per_b,
      q_offset, causal, scale, h);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* delta, const void* m, const void* l, const void* mask,
                       void* dk, void* dv, int bh, int sq, int sk, int group, int hq_per_b,
                       int q_offset, int causal, float scale, Params h,
                       cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, D>;
  const size_t smem =
      sizeof(float) * (2 * kRows * D + 2 * kSub * (D + 1) + 2 * kRows * kSub);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + kRows - 1) / kRows, bh / group);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(delta),
      static_cast<const int*>(m), static_cast<const float*>(l),
      static_cast<const float*>(mask), static_cast<float*>(dk), static_cast<float*>(dv), sq,
      sk, group, hq_per_b, q_offset, causal, scale, h);
  return cudaGetLastError();
}

bool valid_shape(int bh, int sq, int sk, int group, int hq_per_b, int step, int frac,
                 int mant) {
  return bh > 0 && sq > 0 && sk > 0 && group > 0 && bh % group == 0 && hq_per_b > 0 &&
         bh % hq_per_b == 0 && hq_per_b % group == 0 && step >= 1 && mant <= frac;
}

}  // namespace

extern "C" {

// Forward: q (BH, sq, D), k/v (BH / group, sk, D) of in_type (0 f32, 1 bf16),
// mask (B, sk) f32 with B = BH / hq_per_b, or null; sk a multiple of bk
// (bk <= 128).  Writes o (BH, sq, D) f32, m (BH, sq) i32, l (BH, sq) f32.
// Returns the cudaError_t of the launch.
int hyft_flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* m, void* l, int in_type, int bh, int sq, int sk, int bk, int d,
                   int group, int hq_per_b, int q_offset, int causal, float scale, int frac,
                   int total, int mant, int acc, int step, void* stream) {
  if (!valid_shape(bh, sq, sk, group, hq_per_b, step, frac, mant) || bk <= 0 || bk > 128 ||
      sk % bk != 0)
    return cudaErrorInvalidValue;
  const Params h{frac, total, mant, acc, step};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) {
    if (in_type == 0)
      return launch_fwd<float, 128>(q, k, v, mask, o, m, l, bh, sq, sk, bk, group, hq_per_b,
                                    q_offset, causal, scale, h, s);
    if (in_type == 1)
      return launch_fwd<__nv_bfloat16, 128>(q, k, v, mask, o, m, l, bh, sq, sk, bk, group,
                                            hq_per_b, q_offset, causal, scale, h, s);
  }
  return cudaErrorInvalidValue;
}

// dq: the forward's operands plus do (BH, sq, D) f32, delta (BH, sq) f32 and
// the row stats m, l; writes dq (BH, sq, D) f32.
int hyft_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* delta, const void* m, const void* l, const void* mask,
                      void* dq, int in_type, int bh, int sq, int sk, int d, int group,
                      int hq_per_b, int q_offset, int causal, float scale, int frac,
                      int total, int mant, int acc, int step, void* stream) {
  if (!valid_shape(bh, sq, sk, group, hq_per_b, step, frac, mant))
    return cudaErrorInvalidValue;
  const Params h{frac, total, mant, acc, step};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) {
    if (in_type == 0)
      return launch_dq<float, 128>(q, k, v, dout, delta, m, l, mask, dq, bh, sq, sk, group,
                                   hq_per_b, q_offset, causal, scale, h, s);
    if (in_type == 1)
      return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, delta, m, l, mask, dq, bh, sq, sk,
                                           group, hq_per_b, q_offset, causal, scale, h, s);
  }
  return cudaErrorInvalidValue;
}

// dk/dv: the same inputs as dq; writes dk, dv (BH / group, sk, D) f32.
int hyft_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* delta, const void* m, const void* l, const void* mask,
                       void* dk, void* dv, int in_type, int bh, int sq, int sk, int d,
                       int group, int hq_per_b, int q_offset, int causal, float scale,
                       int frac, int total, int mant, int acc, int step, void* stream) {
  if (!valid_shape(bh, sq, sk, group, hq_per_b, step, frac, mant))
    return cudaErrorInvalidValue;
  const Params h{frac, total, mant, acc, step};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) {
    if (in_type == 0)
      return launch_dkv<float, 128>(q, k, v, dout, delta, m, l, mask, dk, dv, bh, sq, sk,
                                    group, hq_per_b, q_offset, causal, scale, h, s);
    if (in_type == 1)
      return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, delta, m, l, mask, dk, dv, bh, sq,
                                            sk, group, hq_per_b, q_offset, causal, scale, h,
                                            s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"

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
// What bounds them on an H100: fp32 FMAs (qwen2-1.5b at B 4, S 1024,
// causal: 12.9 / 19.3 / 25.8 GFLOP over the attended half for forward / dq
// / dk-dv, against a few tens of MB of operands; bert-base at D 64, B 32,
// S 128, non-causal: 1.6 / 2.4 / 3.2 GFLOP against 32-45 MB), and, before the FMAs,
// shared-memory loads: an SM moves 32 words of shared memory a clock
// against 128 FMA lanes.  No tensor cores and no TF32: every score q.k (and
// do.v) is one fmaf chain over d = 0..D-1 in order, then __fmul_rn(dot,
// scale), in all three kernels, so that the backward recomputes the
// forward's score bits.
//
// All three are register-tiled: a thread holds a few rows x a few keys of
// scores (and rows x columns or keys x columns of sums) and reads its
// operands from shared memory as float4, each output's chain kept in its
// order.  They take head widths D = 64 and 128 (a template parameter): the
// 16 threads of a row group own D / 16 columns each, one float4 at 64 and
// two (4tx.. and 64 + 4tx..) at 128, so a thread's sums halve at 64 and no
// column is left idle.  The forward takes 64 query rows per block, two
// blocks per SM: 4 rows x 8 keys of scores and 4 rows x D / 16 columns of PV
// a thread (32 FMAs per 3 float4 loads at 128, per 2 at 64).  K is staged
// in D / 32 slices of 32 d and V in 4 slices of 32 keys through a two-slot
// cp.async ring, the next slice loading during the math.
// Its exponent units run over all threads, and the block sum lb is an
// integer count of 2^-acc reduced by warp shuffles: equal to the ordered
// fp32 sum while the count stays below 2^24 (every partial sum exact; always
// under HYFT16, whose block of 128 keys counts at most 2^21), else the
// ordered sum.  dk/dv takes 32 keys per block (K, V in shared memory), one
// block per SM at D = 128 and two at 64 (187 and 107 KB of shared memory in
// fp32), and walks the query rows of every group member in order, in
// sub-tiles of 64 through the ring; half the threads run the q.k chains, the
// other half the do.v chains (4 rows x 4 keys a thread), then the first half
// sums dv and the second dk (4 keys x D / 16 columns).  One fixed-order chain per
// output over (group member, row), the parent design's order; the longest
// causal key tiles first.  dq mirrors it over the other axis: 64 query rows
// per block (q and do staged once), two blocks per SM, K and V in sub-tiles
// of 32 keys, the q.k and do.v chains on the two halves (4 rows x 4 keys a
// thread), then dq summed by every thread (4 rows x D / 16 columns), keys in
// order; the longest causal row tiles first.  Shared memory per block (fp32
// inputs, D = 128 / 64): forward 103 / 87 KB, dq 109 / 61 KB; the forward
// and dq keep two blocks per SM at both widths, where the register cap of
// 128 binds.  On an H100 at the training
// shape the three run at about 36-41% of the fp32 peak; 128-row forward
// tiles of 8 x 8 (one block per SM) and dk/dv sub-tiles of 32 rows (two
// blocks per SM) measured slower, dq with a two-slot ring (one block per
// SM) too (PERF.md).
//
// The causally masked work.  A masked score saturates to FX's lowest raw
// lo = -(2^(total-1)) whatever q.k, so in a row whose max is m score units
// every masked key has the same term, about e^-(32 + m) under HYFT16
// (1.4e-14 at m = 0; never 0, as FP2FX saturates at -32) and e^-(128 + m)
// under HYFT32, which flushes to exactly 0 for m above about -51.  A row
// that sees no valid key keeps m at lo and weighs every key 1.
//  * The forward computes no score of a KV block that lies wholly past the
//    tile's last query position: m stays, alpha is 1, and every key takes
//    its row's masked probability, so only the PV chain over V runs, in
//    the same order; the result is the full computation's, bit for bit,
//    for any m.  Where that probability is 0 for every row of the tile
//    (HYFT32), the blocks are dropped altogether, also bit for bit.
//  * dk/dv skips each row sub-tile that lies wholly before its key tile
//    while every row in it has a masked term whose adder-tree count is 0
//    (m above about -22 under HYFT16), so that each skipped term is below
//    2^-acc of the row's largest.  Those terms come
//    first in each dk/dv chain, so dk/dv may differ from the full
//    computation in the last bits; they are held to grad_errors.
//  * dq takes a key sub-tile wholly past the tile's last query position
//    off the end of every chain of the tile when every row in it passes the
//    same guard (under HYFT32 its probability is then 0 on every input the
//    checks use, and dq is the full walk's, bit for bit; under HYFT16 it is
//    held to grad_errors).  Otherwise (a row that sees no valid key, or a
//    max near lo) the sub-tile runs its do.v chains and its dq terms on
//    each row's masked probability, with no q.k: bit for bit the full walk.
//
// Arithmetic rules that keep it equal to the reference:
//  * each score q.k (and each do.v) is one fmaf chain over d = 0..D-1, the
//    same in all three kernels, so the forward and both backward kernels see
//    the same score bits, and a row's result does not depend on its tile;
//  * each PV output is one fmaf chain over the block's keys in order from
//    0, then acc = acc * alpha + pv;
//  * each dq output is one fmaf chain over the keys in order, each dk and
//    dv output one over (group member, row) in order, then one
//    __fmul_rn(acc, scale) for dq and dk;
//  * masking (causal: q_offset + row >= key; the (B, Sk) mask > 0) happens
//    on the float score before FP2FX, with NEG_BIG for both;
//  * the Hyft arithmetic is hyft_numerics.cuh's, shared with hyft_splitk.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "hyft_numerics.cuh"
#include "hyft_smem.cuh"

namespace {

using namespace hyft;

constexpr int kThreads = 256;
constexpr int kStages = 2;  // slots of the cp.async ring

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

// A masked score saturates to FX's lowest raw lo = -(2^(total-1)), whatever
// q.k: in a row of max m its key's Hyft exponent is that of lo - m.  Its
// probability p (the forward's assemble) and adder-tree count.
__device__ __forceinline__ void masked_term(int m, const Params& h, float& p, int& count) {
  int e, mm;
  exp_unit(-(1 << (h.total - 1)) - m, h.frac, h.mant, e, mm);
  p = assemble(e, mm, h.mant);
  count = expfloat_to_fx_raw(e, mm, h.mant, h.acc);
}

// rows [0, rows) of kCols elements from base + first + r * ld into a shared
// tile of pitch kPitch, by cp.async; rows at or past nvalid become zeros
template <typename T, int kCols, int kPitch>
__device__ __forceinline__ void fetch_rows(T* dst, const T* __restrict__ base, long first,
                                           int ld, int rows, int nvalid) {
  constexpr int kPer = 16 / sizeof(T), kChunks = kCols / kPer;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const bool ok = r < nvalid;
    cp_async16(dst + r * kPitch + c, base + (ok ? first + static_cast<long>(r) * ld + c : 0),
               ok);
  }
}

// four consecutive elements of a global tensor as fp32
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, long i) {
  return make_float4(load_f32(p, i), load_f32(p, i + 1), load_f32(p, i + 2),
                     load_f32(p, i + 3));
}

__device__ __forceinline__ float f4(const float4& a, int c) {
  return c == 0 ? a.x : c == 1 ? a.y : c == 2 ? a.z : a.w;
}

// --------------------------------------------------------------------------
// forward.  Grid (BH, ceil(sq / 64)), the tiles of the last rows first (the
// longest under the causal mask).  Thread (ty, tx) = (tid / 16, tid % 16)
// holds rows 4ty..4ty+3: their scores against keys tx + 16u (u < 8) of a
// block, their PV outputs of columns 64g + 4tx..64g + 4tx+3 (g < D / 64),
// and (all 16 threads of a row group alike) their m, l and alpha.  The ring
// streams each KV block as D / 32 + 4 items: K in D / 32 slices of 32 d (all
// 128 keys), then V in 4 slices of 32 keys; a block past the causal frontier
// as its 4 V items only.  Shared memory (dynamic):
//   s_q    [64][D + 4]              the query rows, fp32
//   ring   kStages x max(K slice [128][32 + pad], V slice [32][D + pad]), T
//   s_p    [128][64 + 4]            the block's probabilities, key-major
// --------------------------------------------------------------------------
constexpr int kR = 4;              // rows of a thread (two blocks per SM)
constexpr int kFwdRows = 16 * kR;  // query rows of a block
constexpr int kKeys = 128;         // the largest KV block
constexpr int kSlice = 32;         // d of a K slice, keys of a V slice
constexpr int kVItems = kKeys / kSlice;  // V slices of a KV block

template <typename T, int D>
struct FwdSmem {
  static_assert(D == 64 || D == 128, "the thread layout covers 64 or 128 columns");
  static constexpr int kCG = D / 64;                   // float4 columns of a thread
  static constexpr int kKItems = D / kSlice;           // K slices of a KV block
  static constexpr int kItems = kKItems + kVItems;     // ring items of a live block
  static constexpr int kQP = D + 4;                    // s_q pitch (fp32)
  static constexpr int kKP = kSlice + 16 / sizeof(T);  // K slice pitch (T)
  static constexpr int kVP = D + 16 / sizeof(T);       // V slice pitch (T)
  static constexpr int kPP = kFwdRows + 4;             // s_p pitch (fp32)
  static constexpr int kKBytes = kKeys * kKP * sizeof(T);
  static constexpr int kVBytes = kSlice * kVP * sizeof(T);
  static constexpr int kSlot = kKBytes > kVBytes ? kKBytes : kVBytes;
  static constexpr int kQBytes = kFwdRows * kQP * 4;
  static constexpr size_t kBytes = kQBytes + kStages * kSlot + kKeys * kPP * 4;
};

// pv[r][c] = fmaf(p[j][kR ty + r], v[j][c], pv[r][c]) over keys j0 .. j0 + nj -
// 1 of s_p in order, columns 64g + 4tx.. (g < kCG); vs holds V rows j0 ..;
// kMasked: every key has its row's probability of key 0
template <bool kMasked, int kCG, int kVP, int kPP, typename T>
__device__ __forceinline__ void pv_keys(float (&pv)[kR][4 * kCG], const T* vs,
                                        const float* s_p, int j0, int nj, int tx, int ty) {
  float4 p_row[kR / 4];
#pragma unroll
  for (int g = 0; g < kR / 4; ++g) p_row[g] = ld4(s_p + kR * ty + 4 * g);
#pragma unroll 4
  for (int j = 0; j < nj; ++j) {
    float4 p4[kR / 4];
#pragma unroll
    for (int g = 0; g < kR / 4; ++g)
      p4[g] = kMasked ? p_row[g] : ld4(s_p + (j0 + j) * kPP + kR * ty + 4 * g);
    float4 vv[kCG];
#pragma unroll
    for (int g = 0; g < kCG; ++g) vv[g] = ld4(vs + j * kVP + 64 * g + 4 * tx);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float p = f4(p4[r / 4], r % 4);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int g = 0; g < kCG; ++g) pv[r][4 * g + c] = fmaf(p, f4(vv[g], c), pv[r][4 * g + c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, float* __restrict__ o, int* __restrict__ m_out,
    float* __restrict__ l_out, int sq, int sk, int bk, int group, int hq_per_b,
    int q_offset, int causal, int skip, float scale, Params h) {
  using S = FwdSmem<T, D>;
  constexpr int kCG = S::kCG, kKItems = S::kKItems, kItems = S::kItems;
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  float* s_q = reinterpret_cast<float*>(fwd_smem);
  unsigned char* ring = fwd_smem + S::kQBytes;
  float* s_p = reinterpret_cast<float*>(ring + kStages * S::kSlot);

  const int tid = threadIdx.x, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;
  const int nvalid = min(kFwdRows, sq - row0);
  const long kv0 = static_cast<long>(bh / group) * sk;
  const float* mrow = mask ? mask + static_cast<long>(bh / hq_per_b) * sk : nullptr;
  const int last_pos = q_offset + row0 + nvalid - 1;  // the tile's causal frontier
  // KV blocks from kb_live on lie wholly past the frontier: every score in
  // them is masked, whatever q.k, so they need no K and no scores (V items
  // only); kb_end drops them altogether where their probability is 0
  const int nkb = sk / bk;
  const int kb_live = causal && skip ? min(nkb, last_pos / bk + 1) : nkb;
  int kb_end = nkb;

  // item t of the stream: a live block's D / 32 K slices of d, then its 4 V
  // slices of keys; a masked block's 4 V slices
  auto first_item = [&](int kb) {
    return kb < kb_live ? kItems * kb : kItems * kb_live + kVItems * (kb - kb_live);
  };
  auto issue = [&](int t) {
    T* dst = reinterpret_cast<T*>(ring + (t % kStages) * S::kSlot);
    int kb = t / kItems, i = t % kItems;
    if (kb >= kb_live) {
      kb = kb_live + (t - kItems * kb_live) / kVItems;
      i = kKItems + (t - kItems * kb_live) % kVItems;
    }
    const long key0 = kv0 + static_cast<long>(kb) * bk;
    if (i < kKItems)
      fetch_rows<T, kSlice, S::kKP>(dst, k, key0 * D + i * kSlice, D, kKeys, bk);
    else
      fetch_rows<T, D, S::kVP>(dst, v, (key0 + (i - kKItems) * kSlice) * D, D, kSlice,
                               bk - (i - kKItems) * kSlice);
    cp_async_commit();
  };
  // wait for item t (the next one in flight) and return its slot
  auto begin = [&](int t) -> const T* {
    if (t + 1 < first_item(kb_end)) issue(t + 1);
    else cp_async_commit();  // an empty group keeps the count of groups fixed
    cp_async_wait<kStages - 1>();
    __syncthreads();
    return reinterpret_cast<const T*>(ring + (t % kStages) * S::kSlot);
  };

  issue(0);
  for (int i = tid; i < kFwdRows * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = i % (D / 4) * 4;
    const float4 val = r < nvalid ? load4(q, (static_cast<long>(bh) * sq + row0 + r) * D + c)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(s_q + r * S::kQP + c) = val;
  }

  int m_run[kR], cnt[kR];
  float l_run[kR], alpha[kR], acc[kR][4 * kCG];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m_run[r] = -(1 << (h.total - 1));  // the running max starts at fx lo (:109)
    l_run[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kCG; ++c) acc[r][c] = 0.0f;
  }

  for (int kb = 0; kb < kb_end; ++kb) {
    const int key_base = kb * bk, t0 = first_item(kb);
    if (kb >= kb_live) {
      // ---- a wholly masked block: every raw is lo, so m stays, alpha is
      // 1, and every key has its row's probability p(lo - m) and count
      if (kb == kb_live) {
        __syncthreads();  // the last block's ordered sums may still read s_p
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          masked_term(m_run[r], h, alpha[r], cnt[r]);  // alpha holds p for now
          cnt[r] *= bk;
        }
        // key 0 carries them; the others are read only by the ordered sums
        for (int j = tx; j < bk; j += 16)
#pragma unroll
          for (int g = 0; g < kR / 4; ++g)
            *reinterpret_cast<float4*>(s_p + j * S::kPP + kR * ty + 4 * g) = make_float4(
                alpha[4 * g], alpha[4 * g + 1], alpha[4 * g + 2], alpha[4 * g + 3]);
#pragma unroll
        for (int r = 0; r < kR; ++r) alpha[r] = 1.0f;
      }
    } else {
      // ---- scores of kR rows x 8 keys, each one fmaf chain over d in order
      float dot[kR][8];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int u = 0; u < 8; ++u) dot[r][u] = 0.0f;
      for (int i = 0; i < kKItems; ++i) {
        const T* ks = begin(t0 + i);
#pragma unroll
        for (int d4 = 0; d4 < kSlice; d4 += 4) {
          float4 qa[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r) qa[r] = ld4(s_q + (kR * ty + r) * S::kQP + i * kSlice + d4);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float4 kk = ld4(ks + (tx + 16 * u) * S::kKP + d4);
#pragma unroll
            for (int r = 0; r < kR; ++r) dot[r][u] = fma4(qa[r], kk, dot[r][u]);
          }
        }
        __syncthreads();
      }

      // ---- FP2FX raws; the strided block max over the row group's 16
      // threads, merged with the running max; the rescale of the carried state
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        int bmax = INT_MIN;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = tx + 16 * u;
          const float z = masked_score(dot[r][u], scale, q_offset + row0 + kR * ty + r,
                                       key_base + min(j, bk - 1), causal, mrow);
          const int raw = fp2fx(z, h.frac, h.total);
          dot[r][u] = __int_as_float(raw);
          if (j < bk && j % h.step == 0) bmax = max(bmax, raw);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          bmax = max(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
        const int m_new = max(m_run[r], bmax);
        alpha[r] = hyft_alpha(m_run[r] - m_new, h);
        m_run[r] = m_new;
        cnt[r] = 0;
      }
      // ---- exponent units: the probabilities into s_p, the adder-tree counts
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = tx + 16 * u;
        float pr[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          int e, mm;
          exp_unit(__float_as_int(dot[r][u]) - m_run[r], h.frac, h.mant, e, mm);
          pr[r] = j < bk ? assemble(e, mm, h.mant) : 0.0f;
          cnt[r] += j < bk ? expfloat_to_fx_raw(e, mm, h.mant, h.acc) : 0;
        }
#pragma unroll
        for (int g = 0; g < kR / 4; ++g)
          *reinterpret_cast<float4*>(s_p + j * S::kPP + kR * ty + 4 * g) =
              make_float4(pr[4 * g], pr[4 * g + 1], pr[4 * g + 2], pr[4 * g + 3]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) cnt[r] += __shfl_xor_sync(0xffffffffu, cnt[r], off);

      // ---- the masked blocks go altogether where their probability is 0
      // for every row (HYFT32 flushes it; m and l then stay as they are)
      if (kb + 1 == kb_live && kb_live < kb_end) {
        bool gone = true;
#pragma unroll
        for (int r = 0; r < kR; ++r)
          if (kR * ty + r < nvalid) {
            float p;
            int count;
            masked_term(m_run[r], h, p, count);
            gone = gone && p == 0.0f;
          }
        if (__syncthreads_and(gone)) kb_end = kb_live;
      }
    }

    // ---- PV over the block's keys in order (s_p is visible after the
    // first V slice's barrier)
    float pv[kR][4 * kCG];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < 4 * kCG; ++c) pv[r][c] = 0.0f;
    for (int i = 0; i < kVItems; ++i) {
      const T* vs = begin(t0 + (kb < kb_live ? kKItems : 0) + i);
      const int j0 = i * kSlice, nj = min(kSlice, bk - j0);
      if (kb < kb_live)
        pv_keys<false, kCG, S::kVP, S::kPP>(pv, vs, s_p, j0, nj, tx, ty);
      else  // a masked block's probabilities are one per row, kept in registers
        pv_keys<true, kCG, S::kVP, S::kPP>(pv, vs, s_p, j0, nj, tx, ty);
      __syncthreads();
    }

    // ---- carried state: acc = acc * alpha + pv; l = fx_quantize(l * alpha)
    // + lb, lb the count times 2^-acc while below 2^24, else the ordered sum
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const bool ordered = cnt[r] >= (1 << 24);
      float lsum = 0.0f;
      if (ordered && tx == 0) {
        const float up = pow2_float(h.acc), down = pow2_float(-h.acc);
        for (int j = 0; j < bk; ++j)
          lsum = __fadd_rn(lsum, __fmul_rn(floorf(__fmul_rn(s_p[j * S::kPP + kR * ty + r], up)),
                                           down));
      }
      lsum = __shfl_sync(0xffffffffu, lsum, lane & 16);
      const float lb = ordered ? lsum : __fmul_rn(static_cast<float>(cnt[r]), pow2_float(-h.acc));
      l_run[r] = __fadd_rn(fx_quantize(__fmul_rn(l_run[r], alpha[r]), h.acc), lb);
#pragma unroll
      for (int c = 0; c < 4 * kCG; ++c)
        acc[r][c] = __fadd_rn(__fmul_rn(acc[r][c], alpha[r]), pv[r][c]);
    }
  }
  cp_async_wait<0>();

  // ---- stage 3: log-subtract division; the row stats for the backward
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int rl = kR * ty + r;
    if (rl >= nvalid) continue;
    const long ri = static_cast<long>(bh) * sq + row0 + rl;
    float* orow = o + ri * D;
    float res[4 * kCG];
#pragma unroll
    for (int c = 0; c < 4 * kCG; ++c) res[c] = hyft_finalize(acc[r][c], l_run[r], h.mant);
#pragma unroll
    for (int g = 0; g < kCG; ++g)
      *reinterpret_cast<float4*>(orow + 64 * g + 4 * tx) =
          make_float4(res[4 * g], res[4 * g + 1], res[4 * g + 2], res[4 * g + 3]);
    if (tx == 0) {
      m_out[ri] = m_run[r];
      l_out[ri] = l_run[r];
    }
  }
}

// --------------------------------------------------------------------------
// dk/dv.  Grid (BHkv, ceil(sk / 32)), key tile y: the first keys first (the
// longest under the causal mask).  A block holds its 32 keys' K and V and
// walks the query rows of every group member in order, in sub-tiles of 64
// rows streamed through the ring with their m, l and delta.  The two halves
// of the block split the work: per sub-tile, half 0 runs the q.k chains and
// the probabilities p, half 1 the do.v chains and ds = p (dp - delta), each
// thread 4 rows (ry + 16i) x 4 keys (kx + 8u); then half 0 sums dv += p^T do
// and half 1 dk += ds^T q, each thread 4 keys (4kq..) x D / 16 columns
// (64g + 4cx.., g < D / 64).  Shared memory (dynamic):
//   s_k, s_v   [32][D + 4]                      the block's keys and values, fp32
//   ring       kStages x (q [64][D + pad] of T, do [64][D + 4], m, l, delta [64])
//   s_p, s_ds  [64][32 + 8]                     p and ds
// --------------------------------------------------------------------------
constexpr int kDkvKeys = 32;              // keys of a dk/dv block
constexpr int kDkvRows = 64;              // query rows of one staged sub-tile
constexpr int kDkvRT = kDkvRows / 16;     // rows of a score thread

template <typename T, int D>
struct DkvSmem {
  static_assert(D == 64 || D == 128, "the thread layout covers 64 or 128 columns");
  static constexpr int kCG = D / 64;                 // float4 columns of a sum thread
  // blocks an SM: the shared memory holds one at 128, two at 64
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
  static constexpr int kKP = D + 4;                  // s_k, s_v pitch (fp32)
  static constexpr int kQP = D + 16 / sizeof(T);     // q pitch (T)
  static constexpr int kOP = D + 4;                  // do pitch (fp32)
  static constexpr int kPP = kDkvKeys + 8;           // s_p, s_ds pitch
  static constexpr int kQBytes = kDkvRows * kQP * sizeof(T);
  static constexpr int kOBytes = kDkvRows * kOP * 4;
  static constexpr int kStage = kQBytes + kOBytes + 3 * kDkvRows * 4;
  static constexpr int kKVBytes = 2 * kDkvKeys * kKP * 4;
  static constexpr size_t kBytes = kKVBytes + kStages * kStage + 2 * kDkvRows * kPP * 4;
};

// acc[i][u] = one fmaf chain over d in order of a[row ry + 16i] . b[key kx +
// 8u], rows of the pitch-aP tile a, keys of the pitch-bP tile b
template <int D, int aP, int bP, typename TA, typename TB>
__device__ __forceinline__ void dot_tile(float (&acc)[kDkvRT][4], const TA* a, const TB* b,
                                        int ry, int kx) {
#pragma unroll
  for (int i = 0; i < kDkvRT; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.0f;
#pragma unroll 2
  for (int d4 = 0; d4 < D; d4 += 4) {
    float4 ra[kDkvRT], rb[4];
#pragma unroll
    for (int i = 0; i < kDkvRT; ++i) ra[i] = ld4(a + (ry + 16 * i) * aP + d4);
#pragma unroll
    for (int u = 0; u < 4; ++u) rb[u] = ld4(b + (kx + 8 * u) * bP + d4);
#pragma unroll
    for (int i = 0; i < kDkvRT; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = fma4(ra[i], rb[u], acc[i][u]);
  }
}

// acc[kk][c] = fmaf(w[row][4kq + kk], x[row][col c], acc) over rows 0..n-1
// in order, columns 64g + 4cx.. (g < kCG)
template <int kCG, int wP, int xP, typename TX>
__device__ __forceinline__ void sum_rows(float (&acc)[4][4 * kCG], const float* w,
                                         const TX* x, int n, int kq, int cx) {
#pragma unroll 2
  for (int rl = 0; rl < n; ++rl) {
    const float4 w4 = ld4(w + rl * wP + 4 * kq);
    float4 xv[kCG];
#pragma unroll
    for (int g = 0; g < kCG; ++g) xv[g] = ld4(x + rl * xP + 64 * g + 4 * cx);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float wk = f4(w4, kk);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int g = 0; g < kCG; ++g)
          acc[kk][4 * g + c] = fmaf(wk, f4(xv[g], c), acc[kk][4 * g + c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, DkvSmem<T, D>::kMinBlocks) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ delta,
    const int* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ mask, float* __restrict__ dk, float* __restrict__ dv,
    int sq, int sk, int group, int hq_per_b, int q_offset, int causal, int skip,
    float scale, Params h) {
  using S = DkvSmem<T, D>;
  constexpr int kCG = S::kCG;
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  float* s_k = reinterpret_cast<float*>(dkv_smem);
  float* s_v = s_k + kDkvKeys * S::kKP;
  unsigned char* ring = dkv_smem + S::kKVBytes;
  float* s_p = reinterpret_cast<float*>(ring + kStages * S::kStage);
  float* s_ds = s_p + kDkvRows * S::kPP;

  const int tid = threadIdx.x, lane = tid % 32;
  const int half = tid / 128, hw = (tid % 128) / 32;  // half 0: p and dv; 1: ds and dk
  const int ry = hw * 4 + lane / 8, kx = lane % 8;     // scores
  const int kq = hw * 2 + lane / 16, cx = lane % 16;   // sums
  const int bkv = blockIdx.x;
  const int key0 = blockIdx.y * kDkvKeys;
  const int nsub = (sq + kDkvRows - 1) / kDkvRows;
  const float* mrow =
      mask ? mask + static_cast<long>(bkv * group / hq_per_b) * sk : nullptr;
  // the sub-tile that member g's walk starts at: past those wholly before
  // the first key, when every row in them passes the skip guard
  auto first_sub = [&](int g) -> int {
    const int before = key0 - q_offset;  // rows below this see none of the keys
    const int nskip = skip && causal && before > 0 ? min(before / kDkvRows, nsub) : 0;
    if (nskip == 0) return 0;
    const long base = (static_cast<long>(bkv) * group + g) * sq;
    bool dead = true;
    for (int r = tid; r < min(nskip * kDkvRows, sq); r += kThreads) {
      float p;
      int count;
      masked_term(m_in[base + r], h, p, count);
      dead = dead && count == 0;
    }
    return __syncthreads_and(dead) ? nskip : 0;
  };
  // advance (g, s) to the next sub-tile to walk; g == group at the end
  auto settle = [&](int& g, int& s) {
    while (g < group && s >= nsub)
      if (++g < group) s = first_sub(g);
  };
  auto issue = [&](int g, int s, int slot) {
    unsigned char* st = ring + slot * S::kStage;
    const long bh = static_cast<long>(bkv) * group + g;
    const int r0 = s * kDkvRows, nrows = min(kDkvRows, sq - r0);
    fetch_rows<T, D, S::kQP>(reinterpret_cast<T*>(st), q, (bh * sq + r0) * D, D, kDkvRows,
                             nrows);
    fetch_rows<float, D, S::kOP>(reinterpret_cast<float*>(st + S::kQBytes), dout,
                                 (bh * sq + r0) * D, D, kDkvRows, nrows);
    float* stats = reinterpret_cast<float*>(st + S::kQBytes + S::kOBytes);
    for (int i = tid; i < 3 * kDkvRows; i += kThreads) {
      const int which = i / kDkvRows, r = i % kDkvRows;
      const bool ok = r < nrows;
      const long ri = ok ? bh * sq + r0 + r : 0;
      const void* src = which == 0 ? static_cast<const void*>(m_in + ri)
                        : which == 1 ? static_cast<const void*>(l_in + ri)
                                     : static_cast<const void*>(delta + ri);
      cp_async4(stats + i, src, ok);
    }
    cp_async_commit();
  };

  int g = 0, s = first_sub(0);
  settle(g, s);
  if (g < group) issue(g, s, 0);
  for (int i = tid; i < kDkvKeys * D / 4; i += kThreads) {
    const int j = i / (D / 4), c = i % (D / 4) * 4;
    const long gi = (static_cast<long>(bkv) * sk + key0 + j) * D + c;
    const bool ok = key0 + j < sk;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(s_k + j * S::kKP + c) = ok ? load4(k, gi) : zero;
    *reinterpret_cast<float4*>(s_v + j * S::kKP + c) = ok ? load4(v, gi) : zero;
  }

  float acc[4][4 * kCG];  // dv (half 0) or dk before its scale (half 1)
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < 4 * kCG; ++c) acc[kk][c] = 0.0f;

  for (int t = 0; g < group; ++t) {
    int gn = g, sn = s + 1;
    settle(gn, sn);
    if (gn < group) issue(gn, sn, (t + 1) % kStages);
    else cp_async_commit();  // an empty group keeps the count of groups fixed
    cp_async_wait<kStages - 1>();
    __syncthreads();

    const unsigned char* st = ring + (t % kStages) * S::kStage;
    const T* s_q = reinterpret_cast<const T*>(st);
    const float* s_do = reinterpret_cast<const float*>(st + S::kQBytes);
    const int* s_m = reinterpret_cast<const int*>(st + S::kQBytes + S::kOBytes);
    const float* s_l = reinterpret_cast<const float*>(s_m + kDkvRows);
    const float* s_dl = s_l + kDkvRows;
    const int r0 = s * kDkvRows, nrows = min(kDkvRows, sq - r0);

    // ---- half 0: q.k -> p; half 1: do.v, then ds = p (dp - delta)
    float dots[kDkvRT][4];
    if (half == 0) {
      dot_tile<D, S::kQP, S::kKP>(dots, s_q, s_k, ry, kx);
#pragma unroll
      for (int i = 0; i < kDkvRT; ++i) {
        const int rl = ry + 16 * i;
        int e_b = 0, m_b = 0;
        if (rl < nrows) lod_refloat(s_l[rl], h.mant, e_b, m_b);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int key = key0 + kx + 8 * u;
          float p = 0.0f;
          if (rl < nrows && key < sk) {
            const float z = masked_score(dots[i][u], scale, q_offset + r0 + rl, key, causal,
                                         mrow);
            p = recompute_prob(z, s_m[rl], e_b, m_b, h);
          }
          s_p[rl * S::kPP + kx + 8 * u] = p;
        }
      }
    } else {
      dot_tile<D, S::kOP, S::kKP>(dots, s_do, s_v, ry, kx);
    }
    __syncthreads();
    if (half == 1) {
#pragma unroll
      for (int i = 0; i < kDkvRT; ++i) {
        const int rl = ry + 16 * i;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int at = rl * S::kPP + kx + 8 * u;
          s_ds[at] = rl < nrows ? __fmul_rn(s_p[at], __fsub_rn(dots[i][u], s_dl[rl])) : 0.0f;
        }
      }
    }
    __syncthreads();

    // ---- dv += p^T do (half 0), dk += ds^T q (half 1), rows in order
    if (half == 0)
      sum_rows<kCG, S::kPP, S::kOP>(acc, s_p, s_do, nrows, kq, cx);
    else
      sum_rows<kCG, S::kPP, S::kQP>(acc, s_ds, s_q, nrows, kq, cx);
    __syncthreads();
    g = gn;
    s = sn;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int key = key0 + 4 * kq + kk;
    if (key >= sk) continue;
    const long gi = (static_cast<long>(bkv) * sk + key) * D + 4 * cx;
    float* out = half == 0 ? dv : dk;
    const float f = half == 0 ? 1.0f : scale;
    float r[4 * kCG];
#pragma unroll
    for (int c = 0; c < 4 * kCG; ++c) r[c] = half == 0 ? acc[kk][c] : __fmul_rn(acc[kk][c], f);
#pragma unroll
    for (int g = 0; g < kCG; ++g)
      *reinterpret_cast<float4*>(out + gi + 64 * g) =
          make_float4(r[4 * g], r[4 * g + 1], r[4 * g + 2], r[4 * g + 3]);
  }
}

// --------------------------------------------------------------------------
// dq.  Grid (BH, ceil(sq / 64)), the tiles of the last rows first (the
// longest under the causal mask), two blocks per SM.  A block stages its 64
// query rows' q and do once and walks K and V in sub-tiles of 32 keys, one
// staged at a time by cp.async: the next one loads after the math, while
// the SM's other block computes (a second slot would leave room for one
// block an SM only, and measured slower: PERF.md).  The two halves of the
// block split the score work: half 0 runs the q.k chains and the
// probabilities p, half 1 the do.v chains and then ds = p (dp - delta),
// each thread 4 rows (ry + 16i) x 4 keys (kx + 8u); then every thread sums
// dq += ds k for 4 rows (4rq..) x D / 16 columns (64g + 4cx.., g < D / 64),
// keys in order.  Shared memory (dynamic):
//   s_q    [64][D + pad]          the query rows, T
//   s_do   [64][D + 4]            their output gradient, fp32
//   s_k    [32][D + pad]          the sub-tile's keys, T
//   s_v    [32][D + pad]          its values, T
//   s_ds   [32][64 + 4]           p, then ds, key-major
//   stats  [5][64]                m, e_b, m_b, delta, the masked probability
// --------------------------------------------------------------------------
constexpr int kDqRows = 64;  // query rows of a dq block
constexpr int kDqKeys = 32;  // keys of one staged sub-tile

template <typename T, int D>
struct DqSmem {
  static_assert(D == 64 || D == 128, "the thread layout covers 64 or 128 columns");
  static constexpr int kCG = D / 64;              // float4 columns of a sum thread
  static constexpr int kQP = D + 16 / sizeof(T);  // s_q pitch (T)
  static constexpr int kOP = D + 4;               // s_do pitch (fp32)
  static constexpr int kKP = D + 16 / sizeof(T);  // K, V pitch (T)
  static constexpr int kSP = kDqRows + 4;         // s_ds pitch (fp32)
  static constexpr int kQBytes = kDqRows * kQP * sizeof(T);
  static constexpr int kOBytes = kDqRows * kOP * 4;
  static constexpr int kTile = kDqKeys * kKP * sizeof(T);
  static constexpr int kSBytes = kDqKeys * kSP * 4;
  static constexpr size_t kBytes = kQBytes + kOBytes + 2 * kTile + kSBytes + 5 * kDqRows * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ delta,
    const int* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ mask, float* __restrict__ dq, int sq, int sk, int group,
    int hq_per_b, int q_offset, int causal, int skip, float scale, Params h) {
  using S = DqSmem<T, D>;
  constexpr int kCG = S::kCG;
  extern __shared__ __align__(16) unsigned char dq_smem[];
  T* s_q = reinterpret_cast<T*>(dq_smem);
  float* s_do = reinterpret_cast<float*>(dq_smem + S::kQBytes);
  T* s_k = reinterpret_cast<T*>(dq_smem + S::kQBytes + S::kOBytes);
  const T* s_v = s_k + kDqKeys * S::kKP;
  float* s_ds = reinterpret_cast<float*>(dq_smem + S::kQBytes + S::kOBytes + 2 * S::kTile);
  int* s_m = reinterpret_cast<int*>(s_ds + kDqKeys * S::kSP);
  int* s_eb = s_m + kDqRows;
  int* s_mb = s_eb + kDqRows;
  float* s_dl = reinterpret_cast<float*>(s_mb + kDqRows);
  float* s_pm = s_dl + kDqRows;

  const int tid = threadIdx.x, lane = tid % 32;
  const int half = tid / 128, hw = (tid % 128) / 32;  // half 0: p; 1: do.v and ds
  const int ry = hw * 4 + lane / 8, kx = lane % 8;     // scores
  const int rq = tid / 16, cx = tid % 16;              // sums
  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;
  const int nvalid = min(kDqRows, sq - row0);
  const long kv0 = static_cast<long>(bh / group) * sk;
  const float* mrow = mask ? mask + static_cast<long>(bh / hq_per_b) * sk : nullptr;
  // sub-tiles from n_live on lie wholly past the tile's causal frontier:
  // every score in them is masked, whatever q.k
  const int nsub = (sk + kDqKeys - 1) / kDqKeys;
  const int last_pos = q_offset + row0 + nvalid - 1;
  const int n_live =
      causal && skip ? (last_pos < 0 ? 0 : min(nsub, last_pos / kDqKeys + 1)) : nsub;

  auto issue = [&](int t) {
    const long first = (kv0 + static_cast<long>(t) * kDqKeys) * D;
    const int nk = min(kDqKeys, sk - t * kDqKeys);
    fetch_rows<T, D, S::kKP>(s_k, k, first, D, kDqKeys, nk);
    fetch_rows<T, D, S::kKP>(s_k + kDqKeys * S::kKP, v, first, D, kDqKeys, nk);
    cp_async_commit();
  };

  // q and do go with the first sub-tile's group
  const long qbase = (static_cast<long>(bh) * sq + row0) * D;
  fetch_rows<T, D, S::kQP>(s_q, q, qbase, D, kDqRows, nvalid);
  fetch_rows<float, D, S::kOP>(s_do, dout, qbase, D, kDqRows, nvalid);
  // the row stats, each row's masked probability, and the guard of the skip:
  // a row whose masked term counts 0 in the adder tree
  bool faint = true;
  if (tid < kDqRows) {
    int m = 0, e_b = 0, m_b = 0;
    float dl = 0.0f, pm = 0.0f;
    if (tid < nvalid) {
      const long ri = static_cast<long>(bh) * sq + row0 + tid;
      m = m_in[ri];
      lod_refloat(l_in[ri], h.mant, e_b, m_b);
      dl = delta[ri];
      pm = recompute_prob(kNegBig, m, e_b, m_b, h);
      float p;
      int count;
      masked_term(m, h, p, count);
      faint = count == 0;
    }
    s_m[tid] = m;
    s_eb[tid] = e_b;
    s_mb[tid] = m_b;
    s_dl[tid] = dl;
    s_pm[tid] = pm;
  }
  // (i) every row faint: the masked sub-tiles are the trailing terms of each
  // dq chain, below 2^-acc of the row's largest, and go; (ii) else they run
  // on each row's masked probability, with no q.k, bit for bit the full walk
  int n_end = nsub;
  if (n_live < nsub && __syncthreads_and(faint)) n_end = n_live;
  if (n_end > 0) issue(0);
  else cp_async_commit();

  float acc[4][4 * kCG];  // dq before its scale
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4 * kCG; ++c) acc[r][c] = 0.0f;

  for (int t = 0; t < n_end; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    const int j0 = t * kDqKeys, nk = min(kDqKeys, sk - j0);

    // ---- half 0: q.k -> p (a masked sub-tile: the row's constant); half 1: do.v
    float dots[kDkvRT][4];
    if (half == 0) {
      const bool live = t < n_live;
      if (live) dot_tile<D, S::kQP, S::kKP>(dots, s_q, s_k, ry, kx);
#pragma unroll
      for (int i = 0; i < kDkvRT; ++i) {
        const int rl = ry + 16 * i;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int jl = kx + 8 * u;
          float p = 0.0f;
          if (rl < nvalid && jl < nk)
            p = live ? recompute_prob(masked_score(dots[i][u], scale, q_offset + row0 + rl,
                                                   j0 + jl, causal, mrow),
                                      s_m[rl], s_eb[rl], s_mb[rl], h)
                     : s_pm[rl];
          s_ds[jl * S::kSP + rl] = p;
        }
      }
    } else {
      dot_tile<D, S::kOP, S::kKP>(dots, s_do, s_v, ry, kx);
    }
    __syncthreads();
    if (half == 1) {
#pragma unroll
      for (int i = 0; i < kDkvRT; ++i) {
        const int rl = ry + 16 * i;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int at = (kx + 8 * u) * S::kSP + rl;
          s_ds[at] = __fmul_rn(s_ds[at], __fsub_rn(dots[i][u], s_dl[rl]));
        }
      }
    }
    __syncthreads();

    // ---- dq += ds k over the sub-tile's keys in order
    sum_rows<kCG, S::kSP, S::kKP>(acc, s_ds, s_k, nk, rq, cx);
    __syncthreads();
    if (t + 1 < n_end) issue(t + 1);  // the other block of the SM computes meanwhile
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int rl = 4 * rq + r;
    if (rl >= nvalid) continue;
    float* out = dq + qbase + static_cast<long>(rl) * D + 4 * cx;
    float o[4 * kCG];
#pragma unroll
    for (int c = 0; c < 4 * kCG; ++c) o[c] = __fmul_rn(acc[r][c], scale);
#pragma unroll
    for (int g = 0; g < kCG; ++g)
      *reinterpret_cast<float4*>(out + 64 * g) =
          make_float4(o[4 * g], o[4 * g + 1], o[4 * g + 2], o[4 * g + 3]);
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
                       int hq_per_b, int q_offset, int causal, int skip, float scale, Params h,
                       cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = FwdSmem<T, D>::kBytes;
  static size_t allowed = 0;
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + kFwdRows - 1) / kFwdRows);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mask), static_cast<float*>(o), static_cast<int*>(m),
      static_cast<float*>(l), sq, sk, bk, group, hq_per_b, q_offset, causal, skip, scale, h);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* delta, const void* m, const void* l, const void* mask,
                      void* dq, int bh, int sq, int sk, int group, int hq_per_b,
                      int q_offset, int causal, int skip, float scale, Params h,
                      cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  const size_t smem = DqSmem<T, D>::kBytes;
  static size_t allowed = 0;
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + kDqRows - 1) / kDqRows);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(delta),
      static_cast<const int*>(m), static_cast<const float*>(l),
      static_cast<const float*>(mask), static_cast<float*>(dq), sq, sk, group, hq_per_b,
      q_offset, causal, skip, scale, h);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* delta, const void* m, const void* l, const void* mask,
                       void* dk, void* dv, int bh, int sq, int sk, int group, int hq_per_b,
                       int q_offset, int causal, int skip, float scale, Params h,
                       cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, D>;
  const size_t smem = DkvSmem<T, D>::kBytes;
  static size_t allowed = 0;
  cudaError_t err = allow_smem(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh / group, (sk + kDkvKeys - 1) / kDkvKeys);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(delta),
      static_cast<const int*>(m), static_cast<const float*>(l),
      static_cast<const float*>(mask), static_cast<float*>(dk), static_cast<float*>(dv), sq,
      sk, group, hq_per_b, q_offset, causal, skip, scale, h);
  return cudaGetLastError();
}

// the cp.async copies read 16 bytes at a time
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool valid_shape(int bh, int sq, int sk, int group, int hq_per_b, int step, int frac,
                 int mant) {
  return bh > 0 && sq > 0 && sk > 0 && group > 0 && bh % group == 0 && hq_per_b > 0 &&
         bh % hq_per_b == 0 && hq_per_b % group == 0 && step >= 1 && mant <= frac;
}

}  // namespace

// return LAUNCH<T, D>(...) for the inputs' type (in_type 0 f32, 1 bf16) and
// the head width d (64 or 128); any other pair is refused
#define HYFT_WIDTHS(LAUNCH, T, ...)                  \
  if (d == 64) return LAUNCH<T, 64>(__VA_ARGS__);    \
  if (d == 128) return LAUNCH<T, 128>(__VA_ARGS__);
#define HYFT_DISPATCH(LAUNCH, ...)                                             \
  if (in_type == 0) { HYFT_WIDTHS(LAUNCH, float, __VA_ARGS__) }                \
  if (in_type == 1) { HYFT_WIDTHS(LAUNCH, __nv_bfloat16, __VA_ARGS__) }        \
  return cudaErrorInvalidValue;

extern "C" {

// Forward: q (BH, sq, D), k/v (BH / group, sk, D) of in_type (0 f32, 1 bf16)
// with D = d, 64 or 128; mask (B, sk) f32 with B = BH / hq_per_b, or null;
// sk a multiple of bk (bk <= 128); k and v 16-byte aligned.  skip != 0 drops the causally
// masked KV blocks under the guard of the note above.  Writes o (BH, sq, D)
// f32, m (BH, sq) i32, l (BH, sq) f32.  Returns the cudaError_t of the
// launch.
int hyft_flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* m, void* l, int in_type, int bh, int sq, int sk, int bk, int d,
                   int group, int hq_per_b, int q_offset, int causal, int skip, float scale,
                   int frac, int total, int mant, int acc, int step, void* stream) {
  if (!valid_shape(bh, sq, sk, group, hq_per_b, step, frac, mant) || bk <= 0 || bk > 128 ||
      sk % bk != 0 || !aligned16(k) || !aligned16(v))
    return cudaErrorInvalidValue;
  const Params h{frac, total, mant, acc, step};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HYFT_DISPATCH(launch_fwd, q, k, v, mask, o, m, l, bh, sq, sk, bk, group, hq_per_b, q_offset,
                causal, skip, scale, h, s)
}

// dq: the forward's operands plus do (BH, sq, D) f32, delta (BH, sq) f32 and
// the row stats m, l; q, k, v and do 16-byte aligned.  skip != 0 drops the
// causally masked key sub-tiles under the guard of the note above, or runs
// them without their scores.  Writes dq (BH, sq, D) f32.
int hyft_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* delta, const void* m, const void* l, const void* mask,
                      void* dq, int in_type, int bh, int sq, int sk, int d, int group,
                      int hq_per_b, int q_offset, int causal, int skip, float scale,
                      int frac, int total, int mant, int acc, int step, void* stream) {
  if (!valid_shape(bh, sq, sk, group, hq_per_b, step, frac, mant) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dout))
    return cudaErrorInvalidValue;
  const Params h{frac, total, mant, acc, step};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HYFT_DISPATCH(launch_dq, q, k, v, dout, delta, m, l, mask, dq, bh, sq, sk, group, hq_per_b,
                q_offset, causal, skip, scale, h, s)
}

// dk/dv: the same inputs as dq, q and do 16-byte aligned; skip != 0 drops
// the row sub-tiles wholly before a key tile under the guard of the note
// above.  Writes dk, dv (BH / group, sk, D) f32.
int hyft_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* delta, const void* m, const void* l, const void* mask,
                       void* dk, void* dv, int in_type, int bh, int sq, int sk, int d,
                       int group, int hq_per_b, int q_offset, int causal, int skip,
                       float scale, int frac, int total, int mant, int acc, int step,
                       void* stream) {
  if (!valid_shape(bh, sq, sk, group, hq_per_b, step, frac, mant) || !aligned16(q) ||
      !aligned16(dout))
    return cudaErrorInvalidValue;
  const Params h{frac, total, mant, acc, step};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  HYFT_DISPATCH(launch_dkv, q, k, v, dout, delta, m, l, mask, dk, dv, bh, sq, sk, group,
                hq_per_b, q_offset, causal, skip, scale, h, s)
}

}  // extern "C"

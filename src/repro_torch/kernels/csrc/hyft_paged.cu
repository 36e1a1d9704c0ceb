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
// the page indices from the table on the device.
//
// What is computed, bit for bit: every page is one split, as on the TPU.
// Level 1 per page (_decode_tile): each score one fmaf chain over d = 0..127,
// masked scores NEG_BIG before FP2FX, the page's integer max over every
// step-th key (m_loc), the exponent unit, l_loc an fp32 sum of the addends
// in key order, PV one fmaf chain per output over the page's keys from 0.
// Level 2 (_splitk_combine): m_glob the max of every page's m_loc; per page
// alpha = hyft_alpha(m_loc - m_glob), l_term = fx_quantize(l_loc * alpha),
// acc_term = acc * alpha; the terms summed in page order starting from page
// 0's; hyft_finalize last.  Products and sums are __fmul_rn / __fadd_rn, so
// nvcc contracts nothing: the output is bitwise what the per-page stats of
// the contiguous kernels (hyft_splitk.cu at bk == page size) followed by
// the torch combine give.  Every virtual page is merged, also the null-page
// blocks past a sequence's length, as JAX does: their alpha is tiny but not
// zero.  Page sizes 8, 16, 32, 64, 128 and 256; head width 128; anything
// else is refused (cudaErrorInvalidValue, which the wrapper raises).
//
// Kernel 9, hyft_paged_verify: a prompt chunk (rows = g * Sq) is bound by
// fp32 FMAs.  A block owns 64 query rows of one (b, kv head) and walks its
// sequence's pages in order twice.  Sweep 1 computes the scores and the
// running integer max over the strided keys: m_glob (every page size here
// is a multiple of the step, so the union of the per-page strided subsets
// is the row's).  Sweep 2 recomputes the same scores, takes each page's
// stats and PV, and adds the rescaled terms into the block's running
// (acc, l) in registers; only the (rows, D) output is written, where the
// split-K tile wrote (acc, m, l) for every page.  The query tile is staged
// once per block; K/V come through shared memory 64 keys at a time; each
// thread holds a 4 x 4 score tile and a 4 x 8 output tile, so one float4
// load feeds four FMAs.  A 64-key tile whose mask is zero for every row of
// the block skips K and QK in both sweeps: its raws are the fixed-point
// minimum whatever the dots are, and the running max starts there.  Such a
// tile also gives every row the same probabilities, so its PV is one chain
// per column, shared by the block's rows.
//
// Kernel 7, hyft_paged_decode: decode (rows = the GQA group) reads every
// page once and is bound by bytes, and at these sizes by the latency of
// its loads.  One block per (b, kv head) would fill 16 SMs of 132, so a
// cluster of 8 blocks shares the pages of one (b, kv head): rank r owns a
// contiguous range of them.  Its K tiles that hold a valid key, then its V
// tiles, stream into a ring of shared-memory slots by cp.async, several in
// flight while the math runs.  Each rank computes its pages' scores (kept
// in shared memory), their m_loc and its own max; the ranks exchange maxima
// through distributed shared memory; each rank then takes its pages' Hyft
// stats and PV and pushes each page's rescaled terms to the rank that owns
// the term's 16 of the 128 output columns; last, every rank sums its
// columns' terms of all pages in page order and writes them finalized.
// The GQA group's rows only are computed (at most 16).  Every page's terms
// of a rank's columns must fit in its shared memory: at 6 rows and pages
// of 16, about 400 pages per sequence; past that the launch is refused.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cstring>
#include <type_traits>

#include "hyft_numerics.cuh"

namespace {

namespace cg = cooperative_groups;
using hyft::assemble;
using hyft::exp_unit;
using hyft::expfloat_to_fx;
using hyft::fp2fx;
using hyft::fx_quantize;
using hyft::hyft_alpha;
using hyft::hyft_finalize;
using hyft::kNegBig;
using HyftParams = hyft::Params;

constexpr int kD = 128;            // head width
constexpr int kThreads = 256;
constexpr int kSub = 64;           // keys of one staged K or V tile
constexpr int kPitch = kD + 4;     // q and K/V rows in shared memory: float4
                                   // aligned, 8 neighbouring rows on 8 banks
constexpr int kRowsV = 64;         // query rows of a verify block
constexpr int kZPitch = kRowsV + 4;
constexpr int kRanks = 8;          // blocks of a decode cluster
constexpr int kRowsD = 16;         // most rows of a decode block
constexpr int kSlice = kD / kRanks;  // output columns a decode rank sums
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one block

// 4 int8 packed in a word -> their fp32 values, exactly static_cast<float>
// of each: the byte + 128 goes into the mantissa of 2^23, and 2^23 + 128
// comes off again (exact).  Full-rate integer and fp32 ops, where the
// int-to-float conversion unit runs at a quarter of that rate.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    out[e] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B00u, 0x5440 + e)), 8388736.0f);
}

// 16 raw bytes -> 16 / sizeof(KV) fp32 values, dequantized (x scale) for
// int8
template <typename KV>
__device__ __forceinline__ void to_f32(uint4 raw, float scale, float* out) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) i8x4_to_f32(w[i], out + 4 * i);
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = __fmul_rn(out[e], scale);
  } else {
    constexpr int kVec = 16 / sizeof(KV);
    KV el[kVec];
    memcpy(el, &raw, sizeof(raw));
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = hyft::load_f32(el, e);
  }
}

// Stage keys [j0, j0 + kSub) of head hh of sequence row bt_row into s_kv
// (kSub x kPitch floats), dequantized; keys at or past j_end read as zero.
// Virtual key j sits in page bt_row[j / PS] at offset j % PS.
template <typename KV, int PS>
__device__ __forceinline__ void stage(float* s_kv, const KV* __restrict__ src,
                                      const float* __restrict__ scale,
                                      const int* __restrict__ bt_row, int hkv, int hh,
                                      int j0, int j_end) {
  constexpr int kVec = 16 / sizeof(KV);   // elements of one 16-byte load
  constexpr int kPerRow = kD / kVec;
  for (int i = threadIdx.x; i < kSub * kPerRow; i += blockDim.x) {
    const int jl = i / kPerRow, d0 = (i % kPerRow) * kVec;
    const int j = j0 + jl;
    float val[kVec];
    if (j < j_end) {
      const long r = (static_cast<long>(bt_row[j / PS]) * hkv + hh) * PS + j % PS;
      to_f32<KV>(*reinterpret_cast<const uint4*>(src + r * kD + d0),
                 std::is_same<KV, int8_t>::value ? scale[r] : 1.0f, val);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) val[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(s_kv + jl * kPitch + d0 + e) =
          make_float4(val[e], val[e + 1], val[e + 2], val[e + 3]);
  }
}

// One page's level-1 Hyft stats in place: its raws z[j * pitch] (j < PS)
// become the probabilities; returns l_loc, the fp32 sum of the addends in
// key order.  Eight keys at a time: the raws loaded first, the exponent
// units independent of each other, then the ordered sum, so that the keys'
// latencies overlap.
template <int PS>
__device__ __forceinline__ float page_probs(int* z, int pitch, int m_loc, const HyftParams& h) {
  constexpr int kB = PS < 8 ? PS : 8;
  float l_loc = 0.0f;
  for (int j0 = 0; j0 < PS; j0 += kB) {
    int zr[kB];
    float p[kB], a[kB];
#pragma unroll
    for (int u = 0; u < kB; ++u) zr[u] = z[(j0 + u) * pitch];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      int e, m;
      exp_unit(zr[u] - m_loc, h.frac, h.mant, e, m);
      a[u] = expfloat_to_fx(e, m, h.mant, h.acc);
      p[u] = assemble(e, m, h.mant);
    }
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      l_loc = __fadd_rn(l_loc, a[u]);
      reinterpret_cast<float*>(z)[(j0 + u) * pitch] = p[u];
    }
  }
  return l_loc;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// dot = fmaf(a[d], b[d], dot) for d = 0..3 of one float4 pair, in order
__device__ __forceinline__ float fma4(float4 a, float4 b, float dot) {
  dot = fmaf(a.x, b.x, dot);
  dot = fmaf(a.y, b.y, dot);
  dot = fmaf(a.z, b.z, dot);
  return fmaf(a.w, b.w, dot);
}

// ------------------------------------------------------------------------
// kernel 9: a chunk of Sq query lanes (rows = g * Sq, row r is lane r % Sq)
// ------------------------------------------------------------------------

// Grid (ceil(rows / 64), B * Hkv).  Thread (ty, tx) = (tid / 16, tid % 16)
// holds the scores of rows ty*4 + i and keys tx + 16 jj of a 64-key tile,
// and the outputs of rows ty*4 + i, columns tx*4 + c and 64 + tx*4 + c.
// Shared memory (dynamic): s_q [64][kPitch], s_kv [64][kPitch], s_z
// [kChunk][kZPitch] (a chunk's raws, then its probabilities, key-major).
template <typename KV, int PS>
__global__ void __launch_bounds__(kThreads, 2) paged_verify_kernel(
    const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_table, const float* __restrict__ mask,
    float* __restrict__ out, int hkv, int rows, int nb, int sq, float sm_scale,
    HyftParams h) {
  constexpr int kChunk = PS > kSub ? PS : kSub;   // keys of one pass of the stats
  constexpr int kPages = kChunk / PS;             // pages of one chunk
  constexpr int kSeg = PS < kSub ? PS : kSub;     // keys between page boundaries
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  float* s_kv = s_q + kRowsV * kPitch;
  float* s_z = s_kv + kSub * kPitch;
  int* s_zi = reinterpret_cast<int*>(s_z);
  __shared__ int s_mg[kRowsV];
  __shared__ float s_alpha[kPages][kRowsV];
  __shared__ int s_mloc[kPages][kRowsV];
  __shared__ float s_lloc[kPages][kRowsV];
  __shared__ float s_lt[kPages][kRowsV];    // l terms
  __shared__ float s_lg[kRowsV];
  __shared__ float s_vs[kPages][kD];   // a masked chunk's PV, shared by its rows

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kRowsV;
  const int bh = blockIdx.y, b = bh / hkv, hh = bh % hkv;
  const int sk = nb * PS;
  const int* bt_row = block_table + static_cast<long>(b) * nb;
  const int lo = -(1 << (h.total - 1));   // FP2FX of a masked score

  for (int i = tid; i < kRowsV * kD; i += kThreads) {
    const int row = row0 + i / kD;
    s_q[(i / kD) * kPitch + i % kD] =
        row < rows ? q[(static_cast<long>(bh) * rows + row) * kD + i % kD] : 0.0f;
  }

  const float* mrow[4];   // the mask row of each of this thread's rows
#pragma unroll
  for (int i = 0; i < 4; ++i)
    mrow[i] = mask + (static_cast<long>(b) * sq + min(row0 + ty * 4 + i, rows - 1) % sq) * sk;
  // the mask of this thread's 4 x 4 (row, key) pairs of the tile at j0;
  // true if any pair of the block is valid (a barrier for every thread).
  // The 16 loads are unconditional, at clamped addresses, so that they are
  // all in flight at once.
  auto tile_mask = [&](int j0, bool (&ok)[4][4]) {
    float mv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) mv[i][jj] = mrow[i][min(j0 + tx + 16 * jj, sk - 1)];
    bool any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        ok[i][jj] = row0 + ty * 4 + i < rows && j0 + tx + 16 * jj < sk && mv[i][jj] > 0.0f;
        any |= ok[i][jj];
      }
    return __syncthreads_or(any) != 0;
  };
  // the FP2FX raws of the tile staged in s_kv
  auto scores = [&](const bool (&ok)[4][4], int (&raw)[4][4]) {
    float dot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) dot[i][jj] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = ld4(s_q + (ty * 4 + i) * kPitch + d);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kb[jj] = ld4(s_kv + (tx + 16 * jj) * kPitch + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dot[i][jj] = fma4(qa[i], kb[jj], dot[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        raw[i][jj] = fp2fx(ok[i][jj] ? __fmul_rn(dot[i][jj], sm_scale) : kNegBig,
                           h.frac, h.total);
  };

  // ---- sweep 1: m_glob, the integer max over every step-th key of each page
  int mx[4] = {lo, lo, lo, lo};
  for (int j0 = 0; j0 < sk; j0 += kSub) {
    bool ok[4][4];
    if (!tile_mask(j0, ok)) continue;
    stage<KV, PS>(s_kv, k, k_scale, bt_row, hkv, hh, j0, sk);
    __syncthreads();
    int raw[4][4];
    scores(ok, raw);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + tx + 16 * jj;
      if (j < sk && (j % PS) % h.step == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i) mx[i] = max(mx[i], raw[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx[i] = max(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    if (tx == 0) s_mg[ty * 4 + i] = mx[i];
  }

  // ---- sweep 2: per page, level 1, rescaled into the running (acc, l)
  float acc[4][8];
  float l_glob = 0.0f;   // of row tid, for tid < kRowsV
  for (int c0 = 0; c0 < sk; c0 += kChunk) {
    const int npg = min(kPages, nb - c0 / PS);
    bool live = false;   // does the chunk hold a valid (row, key) pair?
    for (int s0 = 0; s0 < kChunk && c0 + s0 < sk; s0 += kSub) {
      bool ok[4][4];
      int raw[4][4];
      if (tile_mask(c0 + s0, ok)) {
        live = true;
        stage<KV, PS>(s_kv, k, k_scale, bt_row, hkv, hh, c0 + s0, sk);
        __syncthreads();
        scores(ok, raw);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) raw[i][jj] = lo;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s_zi[(s0 + tx + 16 * jj) * kZPitch + ty * 4 + i] = raw[i][jj];
    }
    __syncthreads();
    // one thread per (row, page): m_loc, then the keys in order.  In a
    // chunk without a valid pair every row's stats are row 0's (all raws
    // equal), so row 0 alone runs the keys and the PV below reads its
    // probabilities; alpha still differs by row through m_glob
    for (int it = tid; it < npg * kRowsV; it += kThreads) {
      const int r = it % kRowsV, pg = it / kRowsV;
      if (!live && r > 0) continue;
      int* z = s_zi + pg * PS * kZPitch + r;
      int m_loc = INT_MIN;
#pragma unroll 8
      for (int j = 0; j < PS; j += h.step) m_loc = max(m_loc, z[j * kZPitch]);
      s_mloc[pg][r] = m_loc;
      s_lloc[pg][r] = page_probs<PS>(z, kZPitch, m_loc, h);
    }
    __syncthreads();
    for (int it = tid; it < npg * kRowsV; it += kThreads) {
      const int r = it % kRowsV, pg = it / kRowsV;
      const int m_loc = s_mloc[pg][live ? r : 0];
      const float alpha = hyft_alpha(m_loc - s_mg[r], h);
      s_alpha[pg][r] = alpha;
      s_lt[pg][r] = fx_quantize(__fmul_rn(s_lloc[pg][live ? r : 0], alpha), h.acc);
    }
    __syncthreads();
    if (tid < kRowsV)
      for (int pg = 0; pg < npg; ++pg)
        l_glob = c0 + pg == 0 ? s_lt[pg][tid] : __fadd_rn(l_glob, s_lt[pg][tid]);
    // PV, one page at a time.  In a chunk with no valid pair every raw is
    // the fixed-point minimum, so every row has the same probabilities and
    // the same PV chains: one chain per column (threads 0-127), read by all
    // rows, gives each row's bits
    float part[4][8];
    float vs = 0.0f;
    for (int s0 = 0; s0 < kChunk && c0 + s0 < sk; s0 += kSub) {
      stage<KV, PS>(s_kv, v, v_scale, bt_row, hkv, hh, c0 + s0, sk);
      __syncthreads();
      const int nk = min(kSub, sk - c0 - s0);
      if (!live) {
        if (tid < kD)
          for (int seg = 0; seg < nk; seg += kSeg) {
            const int jv = c0 + s0 + seg;
            if (jv % PS == 0) vs = 0.0f;
#pragma unroll 8
            for (int j = 0; j < kSeg; ++j)
              vs = fmaf(s_z[(s0 + seg + j) * kZPitch], s_kv[(seg + j) * kPitch + tid], vs);
            if ((jv + kSeg) % PS == 0) s_vs[(jv - c0) / PS][tid] = vs;
          }
        __syncthreads();
      }
      for (int seg = 0; seg < nk; seg += kSeg) {
        const int jv = c0 + s0 + seg;      // the segment's first virtual key
        if (!live) {
          if ((jv + kSeg) % PS == 0)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 8; ++c)
                part[i][c] = s_vs[(jv - c0) / PS][(c < 4 ? 0 : 64) + tx * 4 + c % 4];
        } else {
          if (jv % PS == 0)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 8; ++c) part[i][c] = 0.0f;
#pragma unroll 4
          for (int j = 0; j < kSeg; ++j) {
            const int kk = s0 + seg + j;     // key within the chunk
            const float4 p = ld4(s_z + kk * kZPitch + ty * 4);
            const float4 va = ld4(s_kv + (seg + j) * kPitch + tx * 4);
            const float4 vb = ld4(s_kv + (seg + j) * kPitch + 64 + tx * 4);
            const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              part[i][0] = fmaf(pr[i], va.x, part[i][0]);
              part[i][1] = fmaf(pr[i], va.y, part[i][1]);
              part[i][2] = fmaf(pr[i], va.z, part[i][2]);
              part[i][3] = fmaf(pr[i], va.w, part[i][3]);
              part[i][4] = fmaf(pr[i], vb.x, part[i][4]);
              part[i][5] = fmaf(pr[i], vb.y, part[i][5]);
              part[i][6] = fmaf(pr[i], vb.z, part[i][6]);
              part[i][7] = fmaf(pr[i], vb.w, part[i][7]);
            }
          }
        }
        if ((jv + kSeg) % PS == 0) {       // the page ends: its term
          const int pg = (jv - c0) / PS;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float alpha = s_alpha[pg][ty * 4 + i];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float term = __fmul_rn(part[i][c], alpha);
              acc[i][c] = jv + kSeg == PS ? term : __fadd_rn(acc[i][c], term);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (tid < kRowsV) s_lg[tid] = l_glob;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= rows) continue;
    const float l = s_lg[ty * 4 + i];
    float o[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) o[c] = hyft_finalize(acc[i][c], l, h.mant);
    float* dst = out + (static_cast<long>(bh) * rows + row) * kD;
    *reinterpret_cast<float4*>(dst + tx * 4) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(dst + 64 + tx * 4) = make_float4(o[4], o[5], o[6], o[7]);
  }
}

// ------------------------------------------------------------------------
// kernel 7: decode (Sq = 1, rows = the GQA group), a cluster per (b, head)
// ------------------------------------------------------------------------

// 16-byte asynchronous copy, global -> shared; src_size 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A K or V tile of kTile keys as stored (raw, before dequantization) in a
// ring of kStages shared-memory slots: rows padded by 16 bytes, so that 8
// neighbouring keys' 16-byte chunks fall on 8 distinct bank groups.  The
// sizes keep a block within half an SM's shared memory at the serving
// shape (128 pages, 6 rows), so that two blocks share an SM: with one,
// the 16 clusters of that shape do not all fit on the card at once.
template <typename KV>
struct Raw {
  static constexpr int kTile = sizeof(KV) == 4 ? 32 : 64;
  static constexpr int kRowBytes = kD * static_cast<int>(sizeof(KV)) + 16;
  static constexpr int kBytes = kTile * kRowBytes + kTile * 4;   // + the scales
  static constexpr int kStages = sizeof(KV) == 1 ? 4 : 2;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(KV));
};

// 4 neighbouring raw elements (4, 8 or 16 aligned bytes) -> fp32,
// dequantized (x scale) for int8
template <typename KV>
__device__ __forceinline__ void load4(const unsigned char* p, float scale, float (&out)[4]) {
  if constexpr (sizeof(KV) == 1) {
    i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), out);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = __fmul_rn(out[e], scale);
  } else if constexpr (sizeof(KV) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    KV el[4];
    memcpy(el, &w, sizeof(w));
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = hyft::load_f32(el, e);
  } else {
    const float4 w = *reinterpret_cast<const float4*>(p);
    out[0] = w.x, out[1] = w.y, out[2] = w.z, out[3] = w.w;
  }
}

// Start copying this rank's keys [jo0, jo0 + 64) of K or V (and their
// scales) into a ring slot; own key jo sits in page s_bt[jo / PS] at
// offset jo % PS; keys at or past nown are zero-filled.  One commit group.
template <typename KV, int PS>
__device__ __forceinline__ void fetch(unsigned char* slot, const KV* __restrict__ src,
                                      const float* __restrict__ scale, const int* s_bt,
                                      int hkv, int hh, int jo0, int nown) {
  using R = Raw<KV>;
  constexpr int kChunks = kD * static_cast<int>(sizeof(KV)) / 16;
  for (int i = threadIdx.x; i < R::kTile * kChunks; i += blockDim.x) {
    const int jl = i / kChunks, c = i % kChunks, jo = jo0 + jl;
    const bool ok = jo < nown;
    const long r = ok ? (static_cast<long>(s_bt[jo / PS]) * hkv + hh) * PS + jo % PS : 0;
    cp_async16(slot + jl * R::kRowBytes + c * 16,
               reinterpret_cast<const unsigned char*>(src + r * kD) + c * 16, ok);
  }
  if constexpr (std::is_same<KV, int8_t>::value) {
    float* sc = reinterpret_cast<float*>(slot + R::kTile * R::kRowBytes);
    for (int jl = threadIdx.x; jl < R::kTile; jl += blockDim.x) {
      const int jo = jo0 + jl;
      const bool ok = jo < nown;
      const long r = ok ? (static_cast<long>(s_bt[jo / PS]) * hkv + hh) * PS + jo % PS : 0;
      cp_async4(sc + jl, scale + r, ok);
    }
  }
  cp_async_commit();
}

// Grid (8, B * Hkv), clusters of 8 along x: rank r owns the ppr pages from
// r * ppr (fewer at the end).  The rank's K tiles, then its V tiles, stream
// through a ring of Raw<KV>::kStages slots by cp.async, so the loads of the
// next tiles overlap the math of this one; a K tile without a valid key
// skips its math.
// Shared memory (dynamic): s_q [16][kPitch] f32; the ring; s_z [ppr * PS]
// [rows] (the keys' raws, then their probabilities); s_recv [nb][rows][16]
// (the acc terms of this rank's 16 columns, pushed by each page's owner);
// s_lrecv [nb][rows] (every page's l term, pushed likewise); s_mloc,
// s_alpha [ppr][rows]; s_bt [ppr]; s_valid [ppr * PS].
template <typename KV, int PS>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads)
    paged_decode_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ block_table,
                        const float* __restrict__ mask, float* __restrict__ out, int hkv,
                        int rows, int nb, int ppr, float sm_scale, HyftParams h) {
  using R = Raw<KV>;
  constexpr int kTile = R::kTile;
  constexpr int kSeg = PS < kTile ? PS : kTile;   // keys between page boundaries
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.y, b = bh / hkv, hh = bh % hkv;
  const int sk = nb * PS;
  const int lo = -(1 << (h.total - 1));
  const int pg0 = rank * ppr;
  const int npg = max(0, min(nb, pg0 + ppr) - pg0);
  const int nown = npg * PS, j_begin = pg0 * PS;
  const int ntile = (nown + kTile - 1) / kTile;

  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  unsigned char* s_ring = reinterpret_cast<unsigned char*>(s_q + kRowsD * kPitch);
  float* s_z = reinterpret_cast<float*>(s_ring + R::kStages * R::kBytes);
  int* s_zi = reinterpret_cast<int*>(s_z);
  float* s_recv = s_z + ppr * PS * rows;
  float* s_lrecv = s_recv + nb * rows * kSlice;
  int* s_mloc = reinterpret_cast<int*>(s_lrecv + nb * rows);
  float* s_alpha = reinterpret_cast<float*>(s_mloc + ppr * rows);
  int* s_bt = reinterpret_cast<int*>(s_alpha + ppr * rows);
  int* s_valid = s_bt + ppr;   // the mask of each of this rank's keys
  __shared__ int s_mx[kRowsD], s_mg[kRowsD];

  // q, this rank's page indices and its keys' mask; every raw starts as
  // the fixed-point minimum, which a tile without a valid key keeps
  for (int i = tid; i < kRowsD * kD; i += kThreads)
    s_q[(i / kD) * kPitch + i % kD] =
        i / kD < rows ? q[(static_cast<long>(bh) * rows + i / kD) * kD + i % kD] : 0.0f;
  for (int p = tid; p < npg; p += kThreads)
    s_bt[p] = block_table[static_cast<long>(b) * nb + pg0 + p];
  for (int jo = tid; jo < nown; jo += kThreads)
    s_valid[jo] = mask[static_cast<long>(b) * sk + j_begin + jo] > 0.0f;
  for (int i = tid; i < nown * rows; i += kThreads) s_zi[i] = lo;
  __syncthreads();
  const int nseq = 2 * ntile;   // every K tile, then every V tile

  auto issue = [&](int t) {   // tile t of the sequence into its ring slot
    if (t < nseq) {
      const bool is_k = t < ntile;
      fetch<KV, PS>(s_ring + (t % R::kStages) * R::kBytes, is_k ? k : v,
                    is_k ? k_scale : v_scale, s_bt, hkv, hh, (is_k ? t : t - ntile) * kTile,
                    nown);
    } else {
      cp_async_commit();   // an empty group keeps the count of groups fixed
    }
  };
  for (int t = 0; t < R::kStages - 1; ++t) issue(t);

  // QK: key kk, rows rq + kQStep i
  constexpr int kQStep = kThreads / kTile, kQRows = kRowsD / kQStep;
  const int kk = tid % kTile, rq = tid / kTile;
  // PV: pages per tile, warps per page, the rows of one warp
  constexpr int kWpp = kThreads / 32 / (kTile / kSeg);
  constexpr int kRowsW = (kRowsD + kWpp - 1) / kWpp;
  const int warp = tid / 32, c0 = (tid % 32) * 4;
  float part[kRowsW][4];
  for (int t = 0; t < nseq; ++t) {
    issue(t + R::kStages - 1);
    cp_async_wait<R::kStages - 1>();
    __syncthreads();
    const unsigned char* slot = s_ring + (t % R::kStages) * R::kBytes;
    const bool is_k = t < ntile;
    const int j0 = (is_k ? t : t - ntile) * kTile;
    // a K tile without a valid key is skipped: its raws stay the minimum
    const bool work = !is_k || __syncthreads_or(j0 + kk < nown && s_valid[j0 + kk]);
    const float* sc = reinterpret_cast<const float*>(slot + kTile * R::kRowBytes);
    if (is_k) {
      if (!work) continue;   // nothing read the slot
      // ---- scores of a live K tile, dequantized as they are read
      const int jo = j0 + kk;
      const bool ok = jo < nown && s_valid[jo];
      const float s = std::is_same<KV, int8_t>::value ? sc[kk] : 1.0f;
      float dot[kQRows];
#pragma unroll
      for (int i = 0; i < kQRows; ++i) dot[i] = 0.0f;
#pragma unroll
      for (int d = 0; d < kD; d += R::kVec) {
        float kf[R::kVec];
        to_f32<KV>(*reinterpret_cast<const uint4*>(slot + kk * R::kRowBytes +
                                                   d * static_cast<int>(sizeof(KV))),
                   s, kf);
#pragma unroll
        for (int i = 0; i < kQRows; ++i)
          if (rq + kQStep * i < rows)
#pragma unroll
            for (int e = 0; e < R::kVec; e += 4)
              dot[i] = fma4(ld4(s_q + (rq + kQStep * i) * kPitch + d + e),
                            make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]), dot[i]);
      }
      if (jo < nown)
#pragma unroll
        for (int i = 0; i < kQRows; ++i)
          if (rq + kQStep * i < rows)
            s_zi[jo * rows + rq + kQStep * i] =
                fp2fx(ok ? __fmul_rn(dot[i], sm_scale) : kNegBig, h.frac, h.total);
    } else {
      if (t == ntile) {
        // ---- between the last K tile and the first V tile: m_loc per
        // (page, row), this rank's max, m_glob across the cluster, then
        // each page's probabilities (in place), alpha and l term
        for (int it = tid; it < npg * rows; it += kThreads) {
          const int pg = it / rows, r = it % rows;
          int m_loc = INT_MIN;
          for (int j = 0; j < PS; j += h.step)
            m_loc = max(m_loc, s_zi[(pg * PS + j) * rows + r]);
          s_mloc[it] = m_loc;
        }
        __syncthreads();
        if (tid < rows) {
          int mx = INT_MIN;
          for (int pg = 0; pg < npg; ++pg) mx = max(mx, s_mloc[pg * rows + tid]);
          s_mx[tid] = mx;
        }
        cluster.sync();
        if (tid < rows) {
          int mg = INT_MIN;
          for (int o = 0; o < kRanks; ++o)
            mg = max(mg, cluster.map_shared_rank(s_mx, o)[tid]);
          s_mg[tid] = mg;
        }
        __syncthreads();
        for (int it = tid; it < npg * rows; it += kThreads) {
          const int pg = it / rows, r = it % rows;
          const int m_loc = s_mloc[it];
          const float l_loc = page_probs<PS>(s_zi + pg * PS * rows + r, rows, m_loc, h);
          const float alpha = hyft_alpha(m_loc - s_mg[r], h);
          s_alpha[it] = alpha;
          const float lt = fx_quantize(__fmul_rn(l_loc, alpha), h.acc);
#pragma unroll
          for (int o = 0; o < kRanks; ++o)   // every rank sums every page's l
            cluster.map_shared_rank(s_lrecv, o)[(pg0 + pg) * rows + r] = lt;
        }
        __syncthreads();
      }
      // ---- PV of a V tile.  Warp w takes one page of the tile (or, for
      // pages as long as a tile or longer, the tile's part of its page)
      // and every kWpp-th row from w % kWpp; lane l the columns 4l..4l+3.
      // Each page's rescaled terms go to the rank that sums their columns.
      const int nk = min(kTile, nown - j0);
      const int seg = (warp / kWpp) * kSeg;
      if (seg < nk) {
        const int jo = j0 + seg;   // the segment's first own key
        if (jo % PS == 0)
#pragma unroll
          for (int i = 0; i < kRowsW; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[i][c] = 0.0f;
#pragma unroll 4
        for (int j = 0; j < kSeg; ++j) {
          float vd[4];
          load4<KV>(slot + (seg + j) * R::kRowBytes + c0 * static_cast<int>(sizeof(KV)),
                    std::is_same<KV, int8_t>::value ? sc[seg + j] : 1.0f, vd);
#pragma unroll
          for (int i = 0; i < kRowsW; ++i) {
            const int r = warp % kWpp + kWpp * i;
            if (r < rows) {
              const float p = s_z[(jo + j) * rows + r];
#pragma unroll
              for (int c = 0; c < 4; ++c) part[i][c] = fmaf(p, vd[c], part[i][c]);
            }
          }
        }
        if ((jo + kSeg) % PS == 0) {
          const int pg = (jo + kSeg) / PS - 1;
          float* dst = cluster.map_shared_rank(s_recv, c0 / kSlice);
#pragma unroll
          for (int i = 0; i < kRowsW; ++i) {
            const int r = warp % kWpp + kWpp * i;
            if (r < rows) {
              const float alpha = s_alpha[pg * rows + r];
              *reinterpret_cast<float4*>(dst + ((pg0 + pg) * rows + r) * kSlice + c0 % kSlice) =
                  make_float4(__fmul_rn(part[i][0], alpha), __fmul_rn(part[i][1], alpha),
                              __fmul_rn(part[i][2], alpha), __fmul_rn(part[i][3], alpha));
            }
          }
        }
      }
    }
    __syncthreads();   // the slot is read: it may be refilled
  }
  if (ntile == 0) {
    // a rank without pages still takes part in the exchange of maxima
    if (tid < rows) s_mx[tid] = INT_MIN;
    cluster.sync();
  }
  cluster.sync();   // every page's terms have arrived

  // ---- level 2: the terms of every page in page order, for this rank's
  // 16 columns
  if (tid < rows * kSlice) {
    const int r = tid / kSlice, c = tid % kSlice;
    float acc = s_recv[r * kSlice + c], l = s_lrecv[r];
    for (int pg = 1; pg < nb; ++pg) {
      acc = __fadd_rn(acc, s_recv[(pg * rows + r) * kSlice + c]);
      l = __fadd_rn(l, s_lrecv[pg * rows + r]);
    }
    out[(static_cast<long>(bh) * rows + r) * kD + rank * kSlice + c] =
        hyft_finalize(acc, l, h.mant);
  }
}

// ------------------------------------------------------------------------
// launches
// ------------------------------------------------------------------------

// raise a kernel's dynamic shared memory limit once per size (one device
// per process, as the wrappers use it)
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *bt, *mask;
  void* out;
  int bh, hkv, rows, nb, sq;
  float scale;
  HyftParams h;
  cudaStream_t stream;
};

template <typename KV, int PS>
cudaError_t launch_verify(const Args& a) {
  auto kern = paged_verify_kernel<KV, PS>;
  constexpr int kChunk = PS > kSub ? PS : kSub;
  const size_t smem = sizeof(float) * ((kRowsV + kSub) * kPitch + kChunk * kZPitch);
  static size_t allowed = 0;
  if (cudaError_t err = allow_smem(kern, smem, allowed)) return err;
  const dim3 grid((a.rows + kRowsV - 1) / kRowsV, a.bh);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.bt),
      static_cast<const float*>(a.mask), static_cast<float*>(a.out), a.hkv, a.rows, a.nb,
      a.sq, a.scale, a.h);
  return cudaGetLastError();
}

template <typename KV, int PS>
cudaError_t launch_decode(const Args& a) {
  auto kern = paged_decode_kernel<KV, PS>;
  const int ppr = (a.nb + kRanks - 1) / kRanks;
  const size_t smem = sizeof(float) * kRowsD * kPitch + Raw<KV>::kStages * Raw<KV>::kBytes +
                      sizeof(float) * (static_cast<size_t>(ppr) * a.rows * (PS + 2) +
                                       static_cast<size_t>(a.nb) * a.rows * (kSlice + 1) +
                                       ppr + static_cast<size_t>(ppr) * PS);
  if (a.rows > kRowsD || smem > kMaxSmem) return cudaErrorInvalidValue;
  static size_t allowed = 0;
  if (cudaError_t err = allow_smem(kern, smem, allowed)) return err;
  const dim3 grid(kRanks, a.bh);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.bt),
      static_cast<const float*>(a.mask), static_cast<float*>(a.out), a.hkv, a.rows, a.nb,
      ppr, a.scale, a.h);
  return cudaGetLastError();
}

// the K/V type and page size switches
template <bool kDecode, typename KV>
cudaError_t by_page(const Args& a, int ps) {
#define HYFT_PAGED(PS) \
  return kDecode ? launch_decode<KV, PS>(a) : launch_verify<KV, PS>(a)
  switch (ps) {
    case 8: HYFT_PAGED(8);
    case 16: HYFT_PAGED(16);
    case 32: HYFT_PAGED(32);
    case 64: HYFT_PAGED(64);
    case 128: HYFT_PAGED(128);
    case 256: HYFT_PAGED(256);
    default: return cudaErrorInvalidValue;
  }
#undef HYFT_PAGED
}

template <bool kDecode>
int dispatch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
             const void* bt, const void* mask, void* out, int kv_type, int bh, int hkv,
             int rows, int nb, int ps, int d, int sq, float scale, int frac, int total,
             int mant, int acc_bits, int step, void* stream) {
  const Args a{q,  k,    v,  ks, vs, bt, mask, out, bh, hkv, rows, nb, sq, scale,
               {frac, total, mant, acc_bits, step}, static_cast<cudaStream_t>(stream)};
  if (d != kD || bh <= 0 || hkv <= 0 || rows <= 0 || nb <= 0 || sq <= 0 ||
      rows % sq != 0 || step < 1 || mant > frac)
    return cudaErrorInvalidValue;
  if (kv_type == 0) return by_page<kDecode, float>(a, ps);
  if (kv_type == 1) return by_page<kDecode, __nv_bfloat16>(a, ps);
  if (kv_type == 2) return by_page<kDecode, int8_t>(a, ps);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Decode (Sq = 1): q (BH, rows, D) f32 with rows = the GQA group (at most
// 16); k, v pools (n_pages + 1, Hkv, ps, D) of kv_type (0 f32, 1 bf16, 2
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

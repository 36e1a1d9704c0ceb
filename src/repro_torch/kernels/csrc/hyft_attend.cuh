// Split-K Hyft attention, both levels of the paper's tree in one launch, for
// Hopper (sm_90a): the kernels that hyft_splitk.cu (a contiguous KV cache)
// and hyft_paged.cu (a paged pool) instantiate.  One kernel per shape of
// work, templated on how a key is addressed:
//   decode_kernel  Sq = 1, rows = the GQA group (kernels 6 and 7);
//   verify_kernel  a chunk of Sq query lanes, rows = g * Sq (kernels 8, 9).
// The address policy: paged, virtual key j sits in page bt[b, j / PS] of
// the pool (n_pages + 1, Hkv, PS, D); contiguous, key j of head bh is row
// bh * sk + j of the (BH, sk, D) stripe, and splits of PS = bk keys
// (64, 128 or 256) take the place of pages.  The last contiguous split may
// be ragged (sk 1057 = 4 x 256 + 33): keys at or past sk read as zero and
// count as masked, and the mask, (B, sk) or (B, Sq, sk), is never read past
// sk, as the JAX wrapper pads and masks.
//
// What is computed, bit for bit: every page (split) is one split of the
// reference.  Level 1 per split (_decode_tile): each score one fmaf chain
// over d = 0..D-1, masked scores NEG_BIG before FP2FX, the split's integer
// max over every step-th key from its start (m_loc), the exponent unit,
// l_loc an fp32 sum of the addends in key order, PV one fmaf chain per
// output over the split's keys from its first.  Level 2 (_splitk_combine):
// m_glob the max of every split's m_loc; per split alpha = hyft_alpha(m_loc
// - m_glob), l_term = fx_quantize(l_loc * alpha), acc_term = acc * alpha;
// the terms summed in split order starting from split 0's; hyft_finalize
// last.  Products and sums are __fmul_rn / __fadd_rn, so nvcc contracts
// nothing: the output is bitwise what the per-split stats followed by the
// torch combine give, whatever the address policy, so a sequential block
// table over pages of bk keys gives the contiguous kernels' bits.  Every
// split is merged, also the null-page blocks past a sequence's length, as
// JAX does: their alpha is tiny but not zero.  Head widths D = 64 and 128,
// a template parameter of every kernel; others are refused.
//
// verify_kernel is bound by fp32 FMAs.  A block owns 64 query rows of one
// (b, kv head) and walks the splits in order twice.  Sweep 1 computes the
// scores and the running integer max over the strided keys: m_glob.  Sweep 2
// recomputes the same scores, takes each split's stats and PV, and adds the
// rescaled terms into the block's running (acc, l) in registers; only the
// (rows, D) output is written.  The query tile is staged once per block;
// K/V come through shared memory 64 keys at a time; each thread holds a
// 4 x 4 score tile and a 4 x D / 16 output tile (one float4 of columns at
// D = 64, two at 128), so one float4 load feeds four FMAs.  At D = 64 the
// block takes half the shared memory, so that two blocks share an SM at
// every split size.  A 64-key tile whose mask is zero for every row of the
// block skips K and QK in both sweeps: its raws are the fixed-point minimum whatever
// the dots are, and the running max starts there.  Such a tile also gives
// every row the same probabilities, so its PV is one chain per column,
// shared by the block's rows.  For a causal prompt the work of a row tile
// grows with its lane (64 to 1,024 keys at Sq 1024): the tiles of the last
// lanes start first, so that the short ones fill the tail.
//
// decode_kernel reads every split once and is bound by bytes, and at these
// sizes by the latency of its loads.  One block per (b, kv head) would fill
// a few SMs of 132, so a cluster of 8 blocks shares the splits of one
// (b, kv head).  The splits are walked in rounds of 8 * P (P from the
// shared memory that a round takes; all of them in one round at the
// serving shapes), rank r owning P consecutive splits of each round.  Its K
// tiles that hold a valid key, then its V tiles, stream into a ring of
// shared-memory slots by cp.async, several in flight while the math runs.
// Each rank computes its splits' scores (kept in shared memory) and their
// m_loc (a warp's 32 keys reduced by shuffles, one atomicMax per split and
// row), and its own max; the ranks exchange maxima through distributed
// shared memory; each rank then takes its splits' Hyft stats (a split of
// more than 32 keys with one thread per key and row, its l_loc from an
// integer count where that is exact) and PV, and pushes each split's
// rescaled terms to the rank that owns the term's D / 8 output columns (16
// at D = 128, 8 at 64); at the end of a round every rank adds its columns'
// terms of the round's splits, in split order, to a running sum, and after the last
// round writes them finalized.  A sequence that needs more than one round
// has its scores computed twice (the maxima first, then a round at a time),
// so that no length is refused: K is then read twice.  The GQA group's
// rows only are computed (at most 16).
//
// Why this layout for the contiguous decode too (kernel 6): it is kernel
// 7's, so that both serve any length from one source and a sequential
// table is bitwise the contiguous cache.  At the main path's 5 splits of
// 256 keys five ranks of eight hold a split each and three wait; spreading
// a split's keys over the ranks would cut its PV chains, which run in key
// order in one thread, across blocks, and needs every key's probabilities
// at the ranks that own the columns: the next redesign of this kernel.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <cstring>
#include <type_traits>

#include "hyft_numerics.cuh"
#include "hyft_smem.cuh"

namespace hyft_attend {
namespace {  // internal linkage: each source that includes this has its own

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
using hyft::cp_async16;
using hyft::cp_async4;
using hyft::cp_async_commit;
using hyft::cp_async_wait;
using hyft::fma4;
using hyft::ld4;

constexpr int kThreads = 256;
constexpr int kSub = 64;           // keys of one staged K or V tile
constexpr int kRowsV = 64;         // query rows of a verify block
constexpr int kZPitch = kRowsV + 4;
constexpr int kRanks = 8;          // blocks of a decode cluster
constexpr int kRowsD = 16;         // most rows of a decode block
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory of one block
// a decode block that keeps within this shares its SM with another
constexpr size_t kHalfSmem = 112 * 1024;

// What the head width D (64 or 128) fixes: the pitch of q and K/V rows in
// shared memory (float4 aligned; D + 4 puts 8 neighbouring rows on 8
// banks), the float4 column groups of a verify thread, and the output
// columns a decode rank sums.
template <int D>
struct Width {
  static_assert(D == 64 || D == 128, "the thread layouts cover 64 or 128 columns");
  static constexpr int kPitch = D + 4;
  static constexpr int kCG = D / 64;
  static constexpr int kSlice = D / kRanks;
};

// Where the keys of one (b, kv head) live: pages of PS keys through the
// block table (kPaged), or the contiguous stripe of sk keys.  Keys at or
// past sk do not exist (a ragged last split): they read as zero.
template <int PS, bool kPaged>
struct Keys {
  const int* bt_row;   // paged: the sequence's row of the block table
  long base;           // contiguous: the stripe's first row, bh * sk
  int hkv, hh, sk;

  __device__ __forceinline__ long row(int j) const {
    if constexpr (kPaged)
      return (static_cast<long>(bt_row[j / PS]) * hkv + hh) * PS + j % PS;
    else
      return base + j;
  }
};

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

// Stage keys [j0, j0 + kSub) into s_kv (kSub x kPitch floats), dequantized;
// keys at or past keys.sk read as zero.
template <typename KV, int D, int PS, bool kPaged>
__device__ __forceinline__ void stage(float* s_kv, const KV* __restrict__ src,
                                      const float* __restrict__ scale,
                                      const Keys<PS, kPaged>& keys, int j0) {
  constexpr int kVec = 16 / sizeof(KV);   // elements of one 16-byte load
  constexpr int kPerRow = D / kVec, kPitch = Width<D>::kPitch;
  for (int i = threadIdx.x; i < kSub * kPerRow; i += blockDim.x) {
    const int jl = i / kPerRow, d0 = (i % kPerRow) * kVec;
    const int j = j0 + jl;
    float val[kVec];
    if (j < keys.sk) {
      const long r = keys.row(j);
      to_f32<KV>(*reinterpret_cast<const uint4*>(src + r * D + d0),
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

// One split's level-1 Hyft stats in place: its raws z[j * pitch] (j < PS)
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

// ------------------------------------------------------------------------
// verify: a chunk of Sq query lanes (rows = g * Sq, row r is lane r % Sq)
// ------------------------------------------------------------------------

// The row tile of block y of ntiles: with 64-row tiles inside each group
// member (Sq a multiple of 64), the tiles of the last lanes first, the
// group members interleaved; otherwise the last tile first.
__device__ __forceinline__ int row_tile(int y, int ntiles, int rows, int sq) {
  if (sq % kRowsV == 0) {
    const int g = rows / sq, per = sq / kRowsV;
    return (y % g) * per + per - 1 - y / g;
  }
  return ntiles - 1 - y;
}

// Grid (B * Hkv, ceil(rows / 64)).  Thread (ty, tx) = (tid / 16, tid % 16)
// holds the scores of rows ty*4 + i and keys tx + 16 jj of a 64-key tile,
// and the outputs of rows ty*4 + i, columns 64g + tx*4 + c (g < D / 64).
// Shared memory (dynamic): s_q [64][kPitch], s_kv [64][kPitch], s_z
// [kChunk][kZPitch] (a chunk's raws, then its probabilities, key-major).
// Two blocks share an SM where the shared memory allows it (a chunk of at
// most 128 keys, or D = 64: 102 KB at PS 256); at D = 128 and PS 256 one
// block holds an SM and may take 255 registers.
template <typename KV, int D, int PS, bool kPaged>
__global__ void __launch_bounds__(kThreads, PS > 128 && D > 64 ? 1 : 2) verify_kernel(
    const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ block_table, const float* __restrict__ mask,
    float* __restrict__ out, int hkv, int rows, int nb, int sk, int sq, float sm_scale,
    HyftParams h) {
  constexpr int kChunk = PS > kSub ? PS : kSub;   // keys of one pass of the stats
  constexpr int kPages = kChunk / PS;             // splits of one chunk
  constexpr int kSeg = PS < kSub ? PS : kSub;     // keys between split boundaries
  constexpr int kPitch = Width<D>::kPitch, kCG = Width<D>::kCG;
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
  __shared__ float s_vs[kPages][D];    // a masked chunk's PV, shared by its rows

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = row_tile(blockIdx.y, gridDim.y, rows, sq) * kRowsV;
  const int bh = blockIdx.x, b = bh / hkv, hh = bh % hkv;
  const int nk = nb * PS;   // keys of every split, the ragged one's padding included
  const Keys<PS, kPaged> keys{block_table + static_cast<long>(b) * nb,
                              static_cast<long>(bh) * sk, hkv, hh, sk};
  const int lo = -(1 << (h.total - 1));   // FP2FX of a masked score

  for (int i = tid; i < kRowsV * D; i += kThreads) {
    const int row = row0 + i / D;
    s_q[(i / D) * kPitch + i % D] =
        row < rows ? q[(static_cast<long>(bh) * rows + row) * D + i % D] : 0.0f;
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
    for (int d = 0; d < D; d += 4) {
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

  // ---- sweep 1: m_glob, the integer max over every step-th key of each split
  int mx[4] = {lo, lo, lo, lo};
  for (int j0 = 0; j0 < nk; j0 += kSub) {
    bool ok[4][4];
    if (!tile_mask(j0, ok)) continue;
    stage<KV, D, PS, kPaged>(s_kv, k, k_scale, keys, j0);
    __syncthreads();
    int raw[4][4];
    scores(ok, raw);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + tx + 16 * jj;
      if ((j % PS) % h.step == 0)
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

  // ---- sweep 2: per split, level 1, rescaled into the running (acc, l)
  float acc[4][4 * kCG];
  float l_glob = 0.0f;   // of row tid, for tid < kRowsV
  for (int c0 = 0; c0 < nk; c0 += kChunk) {
    const int npg = min(kPages, nb - c0 / PS);
    bool live = false;   // does the chunk hold a valid (row, key) pair?
    for (int s0 = 0; s0 < kChunk && c0 + s0 < nk; s0 += kSub) {
      bool ok[4][4];
      int raw[4][4];
      if (tile_mask(c0 + s0, ok)) {
        live = true;
        stage<KV, D, PS, kPaged>(s_kv, k, k_scale, keys, c0 + s0);
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
    // one thread per (row, split): m_loc, then the keys in order.  In a
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
    // PV, one split at a time.  In a chunk with no valid pair every raw is
    // the fixed-point minimum, so every row has the same probabilities and
    // the same PV chains: one chain per column (threads 0 to D - 1), read by
    // all rows, gives each row's bits
    float part[4][4 * kCG];
    float vs = 0.0f;
    for (int s0 = 0; s0 < kChunk && c0 + s0 < nk; s0 += kSub) {
      stage<KV, D, PS, kPaged>(s_kv, v, v_scale, keys, c0 + s0);
      __syncthreads();
      const int nkt = min(kSub, nk - c0 - s0);
      if (!live) {
        if (tid < D)
          for (int seg = 0; seg < nkt; seg += kSeg) {
            const int jv = c0 + s0 + seg;
            if (jv % PS == 0) vs = 0.0f;
#pragma unroll 8
            for (int j = 0; j < kSeg; ++j)
              vs = fmaf(s_z[(s0 + seg + j) * kZPitch], s_kv[(seg + j) * kPitch + tid], vs);
            if ((jv + kSeg) % PS == 0) s_vs[(jv - c0) / PS][tid] = vs;
          }
        __syncthreads();
      }
      for (int seg = 0; seg < nkt; seg += kSeg) {
        const int jv = c0 + s0 + seg;      // the segment's first virtual key
        if (!live) {
          if ((jv + kSeg) % PS == 0)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 4 * kCG; ++c)
                part[i][c] = s_vs[(jv - c0) / PS][64 * (c / 4) + tx * 4 + c % 4];
        } else {
          if (jv % PS == 0)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < 4 * kCG; ++c) part[i][c] = 0.0f;
#pragma unroll 4
          for (int j = 0; j < kSeg; ++j) {
            const int kk = s0 + seg + j;     // key within the chunk
            const float4 p = ld4(s_z + kk * kZPitch + ty * 4);
            float4 vv[kCG];
#pragma unroll
            for (int g = 0; g < kCG; ++g)
              vv[g] = ld4(s_kv + (seg + j) * kPitch + 64 * g + tx * 4);
            const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int g = 0; g < kCG; ++g) {
                part[i][4 * g + 0] = fmaf(pr[i], vv[g].x, part[i][4 * g + 0]);
                part[i][4 * g + 1] = fmaf(pr[i], vv[g].y, part[i][4 * g + 1]);
                part[i][4 * g + 2] = fmaf(pr[i], vv[g].z, part[i][4 * g + 2]);
                part[i][4 * g + 3] = fmaf(pr[i], vv[g].w, part[i][4 * g + 3]);
              }
          }
        }
        if ((jv + kSeg) % PS == 0) {       // the split ends: its term
          const int pg = (jv - c0) / PS;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float alpha = s_alpha[pg][ty * 4 + i];
#pragma unroll
            for (int c = 0; c < 4 * kCG; ++c) {
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
    float o[4 * kCG];
#pragma unroll
    for (int c = 0; c < 4 * kCG; ++c) o[c] = hyft_finalize(acc[i][c], l, h.mant);
    float* dst = out + (static_cast<long>(bh) * rows + row) * D;
#pragma unroll
    for (int g = 0; g < kCG; ++g)
      *reinterpret_cast<float4*>(dst + 64 * g + tx * 4) =
          make_float4(o[4 * g], o[4 * g + 1], o[4 * g + 2], o[4 * g + 3]);
  }
}

// ------------------------------------------------------------------------
// decode: Sq = 1, rows = the GQA group, a cluster per (b, kv head)
// ------------------------------------------------------------------------

// A K or V tile of kTile keys as stored (raw, before dequantization) in a
// ring of kStages shared-memory slots: rows padded by 16 bytes, so that 8
// neighbouring keys' 16-byte chunks fall on 8 distinct bank groups; then the
// keys' scales and (K tiles) their mask.  The sizes keep a block within
// half an SM's shared memory at the serving shape (128 pages, 6 rows), so
// that two blocks share an SM: with one, the 16 clusters of that shape do
// not all fit on the card at once.  A row of D = 64 takes half the bytes.
template <typename KV, int D>
struct Raw {
  static constexpr int kTile = sizeof(KV) == 4 ? 32 : 64;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KV)) + 16;
  static constexpr int kScales = kTile * kRowBytes;          // byte offsets
  static constexpr int kMask = kScales + kTile * 4;
  static constexpr int kBytes = kMask + kTile * 4;
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

// Start copying this rank's keys [jo0, jo0 + kTile) of a round (own key jo
// is key j1 + jo of the sequence; paged, in page s_bt[jo / PS] at offset
// jo % PS) of K or V, their scales and, with mask, their mask, into a ring
// slot; keys at or past nown, or past sk, are zero-filled.  One commit
// group.
template <typename KV, int D, int PS, bool kPaged>
__device__ __forceinline__ void fetch(unsigned char* slot, const KV* __restrict__ src,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ mask_row, const int* s_bt,
                                      const Keys<PS, kPaged>& keys, int j1, int jo0,
                                      int nown) {
  using R = Raw<KV, D>;
  constexpr int kChunks = D * static_cast<int>(sizeof(KV)) / 16;
  auto row_of = [&](int jo, bool& ok) -> long {
    ok = jo < nown && j1 + jo < keys.sk;
    if (!ok) return 0;
    if constexpr (kPaged)
      return (static_cast<long>(s_bt[jo / PS]) * keys.hkv + keys.hh) * PS + jo % PS;
    else
      return keys.base + j1 + jo;
  };
  for (int i = threadIdx.x; i < R::kTile * kChunks; i += blockDim.x) {
    const int jl = i / kChunks, c = i % kChunks;
    bool ok;
    const long r = row_of(jo0 + jl, ok);
    cp_async16(slot + jl * R::kRowBytes + c * 16,
               reinterpret_cast<const unsigned char*>(src + r * D) + c * 16, ok);
  }
  for (int jl = threadIdx.x; jl < R::kTile; jl += blockDim.x) {
    bool ok;
    const long r = row_of(jo0 + jl, ok);
    if constexpr (std::is_same<KV, int8_t>::value)
      cp_async4(slot + R::kScales + jl * 4, scale + r, ok);
    if (mask_row != nullptr)
      cp_async4(slot + R::kMask + jl * 4, mask_row + (ok ? j1 + jo0 + jl : 0), ok);
  }
  cp_async_commit();
}

// Grid (8, B * Hkv), clusters of 8 along x.  The splits go in rounds of 8 *
// P; rank r owns splits [r * P, (r + 1) * P) of each round (fewer at the
// end).  The work items, in the order the ring streams them: with more
// than one round, every round's K tiles (sweep 1, the maxima); then per
// round its K tiles again (one round: the only K tiles) and its V tiles.
// A K tile without a valid key skips its math.
// Shared memory (dynamic): s_q [16][kPitch] f32; the ring; s_z [P * PS]
// [rows] (the keys' raws, then their probabilities); s_recv [8 P][rows]
// [D / 8] (the acc terms of this rank's D / 8 columns, pushed by each
// split's owner);
// s_lrecv [8 P][rows] (every split's l term, pushed likewise); s_mloc,
// s_alpha, s_lq [P][rows]; s_bt [nround * P] (paged: this rank's pages).
template <typename KV, int D, int PS, bool kPaged>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads, 2)
    decode_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                  const KV* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ block_table,
                  const float* __restrict__ mask, float* __restrict__ out, int hkv,
                  int rows, int nb, int sk, int P, int nround, float sm_scale,
                  HyftParams h) {
  using R = Raw<KV, D>;
  constexpr int kTile = R::kTile;
  constexpr int kSeg = PS < kTile ? PS : kTile;   // keys between split boundaries
  constexpr int kPitch = Width<D>::kPitch, kSlice = Width<D>::kSlice;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.y, b = bh / hkv, hh = bh % hkv;
  const Keys<PS, kPaged> keys{nullptr, static_cast<long>(bh) * sk, hkv, hh, sk};
  const float* mask_row = mask + static_cast<long>(b) * sk;
  const int lo = -(1 << (h.total - 1));
  const bool multi = nround > 1;
  const int per_round = kRanks * P;   // splits of a round
  const int full_tiles = (P * PS + kTile - 1) / kTile;

  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  unsigned char* s_ring = reinterpret_cast<unsigned char*>(s_q + kRowsD * kPitch);
  float* s_z = reinterpret_cast<float*>(s_ring + R::kStages * R::kBytes);
  int* s_zi = reinterpret_cast<int*>(s_z);
  float* s_recv = s_z + P * PS * rows;
  float* s_lrecv = s_recv + per_round * rows * kSlice;
  int* s_mloc = reinterpret_cast<int*>(s_lrecv + per_round * rows);
  float* s_alpha = reinterpret_cast<float*>(s_mloc + P * rows);
  int* s_lq = reinterpret_cast<int*>(s_alpha + P * rows);
  int* s_bt = s_lq + P * rows;
  __shared__ int s_mx[kRowsD], s_mg[kRowsD];

  // this rank's splits of round r, their first one, and its tiles
  auto first_split = [&](int r) { return r * per_round + rank * P; };
  auto own = [&](int r) { return max(0, min(nb, first_split(r) + P) - first_split(r)); };
  auto tiles = [&](int r) { return (own(r) * PS + kTile - 1) / kTile; };

  for (int i = tid; i < kRowsD * D; i += kThreads)
    s_q[(i / D) * kPitch + i % D] =
        i / D < rows ? q[(static_cast<long>(bh) * rows + i / D) * D + i % D] : 0.0f;
  if constexpr (kPaged)
    for (int i = tid; i < nround * P; i += kThreads) {
      const int pg = first_split(i / P) + i % P;
      s_bt[i] = pg < nb ? block_table[static_cast<long>(b) * nb + pg] : 0;
    }
  __syncthreads();

  // ---- the ring: item u of the stream -> (round, V?, tile), issued
  // kStages - 1 items ahead of the one consumed
  const int last_tiles = tiles(nround - 1);
  const int sweep1 = multi ? (nround - 1) * full_tiles + last_tiles : 0;
  const int n_items = sweep1 + 2 * ((nround - 1) * full_tiles + last_tiles);
  auto issue = [&](int u) {
    if (u >= n_items) {
      cp_async_commit();   // an empty group keeps the count of groups fixed
      return;
    }
    int r, i;
    bool is_v = false;
    if (u < sweep1) {
      r = min(u / full_tiles, nround - 1);
      i = u - r * full_tiles;
    } else {
      const int w = u - sweep1;
      r = min(w / (2 * full_tiles), nround - 1);
      const int n = r < nround - 1 ? full_tiles : last_tiles;
      i = w - r * 2 * full_tiles;
      is_v = i >= n;
      i -= is_v ? n : 0;
    }
    fetch<KV, D, PS, kPaged>(s_ring + (u % R::kStages) * R::kBytes, is_v ? v : k,
                             is_v ? v_scale : k_scale, is_v ? nullptr : mask_row,
                             s_bt + r * P, keys, first_split(r) * PS, i * kTile, own(r) * PS);
  };
  int t = 0;   // the item consumed next
  for (int u = 0; u < R::kStages - 1; ++u) issue(u);
  auto next_slot = [&]() -> const unsigned char* {
    issue(t + R::kStages - 1);
    cp_async_wait<R::kStages - 1>();
    __syncthreads();
    return s_ring + (t % R::kStages) * R::kBytes;
  };

  // ---- round r's scores into s_z and m_loc per (split, row) into s_mloc
  // (every raw and every max starts as the fixed-point minimum, which a
  // tile without a valid key keeps).  A warp holds 32 consecutive keys of
  // the same rows: each split's strided max over them by shuffles, then one
  // atomicMax per split and row.
  constexpr int kQStep = kThreads / kTile, kQRows = kRowsD / kQStep;
  constexpr int kG = PS < 32 ? PS : 32;   // lanes of a warp in one split
  const int kk = tid % kTile, rq = tid / kTile;
  auto score_round = [&](int r) {
    const int nown = own(r) * PS;
    __syncthreads();   // the last round's maxima are read
    for (int i = tid; i < nown * rows; i += kThreads) s_zi[i] = lo;
    for (int i = tid; i < own(r) * rows; i += kThreads) s_mloc[i] = lo;
    for (int i = 0; i < tiles(r); ++i, ++t) {
      const unsigned char* slot = next_slot();
      const int jo = i * kTile + kk;
      const bool ok = jo < nown && reinterpret_cast<const float*>(slot + R::kMask)[kk] > 0.0f;
      if (__syncthreads_or(ok)) {
        const float s = std::is_same<KV, int8_t>::value
                            ? reinterpret_cast<const float*>(slot + R::kScales)[kk]
                            : 1.0f;
        float dot[kQRows];
#pragma unroll
        for (int a = 0; a < kQRows; ++a) dot[a] = 0.0f;
#pragma unroll
        for (int d = 0; d < D; d += R::kVec) {
          float kf[R::kVec];
          to_f32<KV>(*reinterpret_cast<const uint4*>(slot + kk * R::kRowBytes +
                                                     d * static_cast<int>(sizeof(KV))),
                     s, kf);
#pragma unroll
          for (int a = 0; a < kQRows; ++a)
            if (rq + kQStep * a < rows)
#pragma unroll
              for (int e = 0; e < R::kVec; e += 4)
                dot[a] = fma4(ld4(s_q + (rq + kQStep * a) * kPitch + d + e),
                              make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]), dot[a]);
        }
#pragma unroll
        for (int a = 0; a < kQRows; ++a)
          if (rq + kQStep * a < rows) {   // the same for the whole warp
            const int raw = fp2fx(ok ? __fmul_rn(dot[a], sm_scale) : kNegBig, h.frac, h.total);
            if (jo < nown) s_zi[jo * rows + rq + kQStep * a] = raw;
            int mx = jo < nown && (jo % PS) % h.step == 0 ? raw : lo;
#pragma unroll
            for (int off = kG / 2; off > 0; off >>= 1)
              mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            if (jo % kG == 0 && jo < nown)
              atomicMax(s_mloc + (jo / PS) * rows + rq + kQStep * a, mx);
          }
      }
      __syncthreads();   // the slot is read: it may be refilled
    }
    __syncthreads();
  };

  // ---- m_glob: this rank's max over its splits' m_loc, then the cluster's
  int mx = INT_MIN;
  for (int r = 0; r < (multi ? nround : 1); ++r) {
    score_round(r);
    if (tid < rows)
      for (int pg = 0; pg < own(r); ++pg) mx = max(mx, s_mloc[pg * rows + tid]);
  }
  if (tid < rows) s_mx[tid] = mx;
  cluster.sync();
  if (tid < rows) {
    int mg = INT_MIN;
    for (int o = 0; o < kRanks; ++o) mg = max(mg, cluster.map_shared_rank(s_mx, o)[tid]);
    s_mg[tid] = mg;
  }
  __syncthreads();

  // ---- per round: each split's probabilities (in place), alpha and l
  // term; PV of the V tiles, each split's rescaled terms pushed to the rank
  // that sums their columns; then, the round's terms all in, every rank
  // adds its columns' terms in split order
  // PV: splits per tile, warps per split; the lanes of one row (D / 4: a
  // lane takes 4 columns), the rows a warp takes at once (2 at D = 64, whose
  // row fills half a warp), and the rows of one thread
  constexpr int kWpp = kThreads / 32 / (kTile / kSeg);
  constexpr int kLanes = D / 4, kHalves = 32 / kLanes;
  constexpr int kRowsW = (kRowsD + kWpp * kHalves - 1) / (kWpp * kHalves);
  const int warp = tid / 32, c0 = (tid % kLanes) * 4, half = tid % 32 / kLanes;
  // of (row tid / kSlice, column tid % kSlice), tid < rows * kSlice
  float acc = 0.0f, l = 0.0f;
  const int q0 = rank * P;   // the round's index of this rank's first split
  // split pg's alpha (kept) and l term (to every rank, which sums every l)
  auto push_l = [&](int it, int pg, int rr, float l_loc) {
    const float alpha = hyft_alpha(s_mloc[it] - s_mg[rr], h);
    s_alpha[it] = alpha;
    const float lt = fx_quantize(__fmul_rn(l_loc, alpha), h.acc);
#pragma unroll
    for (int o = 0; o < kRanks; ++o)
      cluster.map_shared_rank(s_lrecv, o)[(q0 + pg) * rows + rr] = lt;
  };
  for (int r = 0; r < nround; ++r) {
    if (multi) score_round(r);
    const int npg = own(r), nown = npg * PS;
    // each split's probabilities in place, its l_loc (the fp32 sum of the
    // addends in key order), alpha and l term, pushed to every rank.  A
    // split of at most 32 keys takes one thread per (split, row); a longer
    // one one thread per (key, row) for the exponent units
    if constexpr (PS <= 32) {
      for (int it = tid; it < npg * rows; it += kThreads) {
        const int pg = it / rows, rr = it % rows;
        push_l(it, pg, rr, page_probs<PS>(s_zi + pg * PS * rows + rr, rows, s_mloc[it], h));
      }
    } else {
      // the adder-tree counts floor(p 2^acc) of each split and row summed as
      // integers (a warp: 32 consecutive keys of one row)
      for (int i = tid; i < npg * rows; i += kThreads) s_lq[i] = 0;
      __syncthreads();
      for (int it0 = 0; it0 < nown * rows; it0 += kThreads) {
        const int it = it0 + tid, rr = it / max(nown, 1), jo = it % max(nown, 1);
        int cnt = 0;
        if (it < nown * rows) {
          int e, m;
          exp_unit(s_zi[jo * rows + rr] - s_mloc[(jo / PS) * rows + rr], h.frac, h.mant, e, m);
          s_z[jo * rows + rr] = assemble(e, m, h.mant);
          cnt = hyft::expfloat_to_fx_raw(e, m, h.mant, h.acc);
        }
#pragma unroll
        for (int off = kG / 2; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
        if (it < nown * rows && jo % kG == 0) atomicAdd(s_lq + (jo / PS) * rows + rr, cnt);
      }
      __syncthreads();
      // while a split's count stays below 2^24 every partial sum of its
      // addends is exact: l_loc is the count times 2^-acc; past that (HYFT32
      // only) the ordered sum itself
      for (int it = tid; it < npg * rows; it += kThreads) {
        const int pg = it / rows, rr = it % rows;
        float l_loc = 0.0f;
        if (s_lq[it] < (1 << 24)) {
          l_loc = __fmul_rn(static_cast<float>(s_lq[it]), hyft::pow2_float(-h.acc));
        } else {
          const float up = hyft::pow2_float(h.acc), down = hyft::pow2_float(-h.acc);
          for (int j = 0; j < PS; ++j)
            l_loc = __fadd_rn(
                l_loc, __fmul_rn(floorf(__fmul_rn(s_z[(pg * PS + j) * rows + rr], up)), down));
        }
        push_l(it, pg, rr, l_loc);
      }
    }
    // Warp w takes one split of a V tile (or, for splits as long as a tile
    // or longer, the tile's part of its split) and every kWpp-th row from w
    // % kWpp, the half h of its lanes the h-th of each kHalves of them;
    // lane l the columns 4l..4l+3 of its row (l mod D / 4)
    float part[kRowsW][4];
    for (int i = 0; i < tiles(r); ++i, ++t) {
      const unsigned char* slot = next_slot();
      const int j0 = i * kTile;
      const float* sc = reinterpret_cast<const float*>(slot + R::kScales);
      const int nk = min(kTile, nown - j0);
      const int seg = (warp / kWpp) * kSeg;
      if (seg < nk) {
        const int jo = j0 + seg;   // the segment's first own key
        if (jo % PS == 0)
#pragma unroll
          for (int a = 0; a < kRowsW; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[a][c] = 0.0f;
#pragma unroll 4
        for (int j = 0; j < kSeg; ++j) {
          float vd[4];
          load4<KV>(slot + (seg + j) * R::kRowBytes + c0 * static_cast<int>(sizeof(KV)),
                    std::is_same<KV, int8_t>::value ? sc[seg + j] : 1.0f, vd);
#pragma unroll
          for (int a = 0; a < kRowsW; ++a) {
            const int rr = warp % kWpp + kWpp * (kHalves * a + half);
            if (rr < rows) {
              const float p = s_z[(jo + j) * rows + rr];
#pragma unroll
              for (int c = 0; c < 4; ++c) part[a][c] = fmaf(p, vd[c], part[a][c]);
            }
          }
        }
        if ((jo + kSeg) % PS == 0) {
          const int pg = (jo + kSeg) / PS - 1;
          float* dst = cluster.map_shared_rank(s_recv, c0 / kSlice);
#pragma unroll
          for (int a = 0; a < kRowsW; ++a) {
            const int rr = warp % kWpp + kWpp * (kHalves * a + half);
            if (rr < rows) {
              const float alpha = s_alpha[pg * rows + rr];
              *reinterpret_cast<float4*>(dst + ((q0 + pg) * rows + rr) * kSlice + c0 % kSlice) =
                  make_float4(__fmul_rn(part[a][0], alpha), __fmul_rn(part[a][1], alpha),
                              __fmul_rn(part[a][2], alpha), __fmul_rn(part[a][3], alpha));
            }
          }
        }
      }
      __syncthreads();   // the slot is read: it may be refilled
    }
    cluster.sync();   // every split's terms of the round have arrived
    if (tid < rows * kSlice) {
      const int rr = tid / kSlice, c = tid % kSlice;
      const int nq = min(per_round, nb - r * per_round);
      for (int qq = 0; qq < nq; ++qq) {
        const float a = s_recv[(qq * rows + rr) * kSlice + c], lt = s_lrecv[qq * rows + rr];
        const bool first = r == 0 && qq == 0;
        acc = first ? a : __fadd_rn(acc, a);
        l = first ? lt : __fadd_rn(l, lt);
      }
    }
    if (r + 1 < nround) cluster.sync();   // read: the next round's terms may come
  }
  if (tid < rows * kSlice) {
    const int rr = tid / kSlice, c = tid % kSlice;
    out[(static_cast<long>(bh) * rows + rr) * D + rank * kSlice + c] =
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

// One launch's operands: bt is null for a contiguous cache; nb splits of
// PS keys, sk keys that exist (nb * PS for a pool).
struct Args {
  const void *q, *k, *v, *ks, *vs, *bt, *mask;
  void* out;
  int bh, hkv, rows, nb, sk, sq;
  float scale;
  HyftParams h;
  cudaStream_t stream;
};

template <typename KV, int D, int PS, bool kPaged>
cudaError_t launch_verify(const Args& a) {
  auto kern = verify_kernel<KV, D, PS, kPaged>;
  constexpr int kChunk = PS > kSub ? PS : kSub;
  const size_t smem =
      sizeof(float) * ((kRowsV + kSub) * Width<D>::kPitch + kChunk * kZPitch);
  static size_t allowed = 0;
  if (cudaError_t err = allow_smem(kern, smem, allowed)) return err;
  const dim3 grid(a.bh, (a.rows + kRowsV - 1) / kRowsV);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.bt),
      static_cast<const float*>(a.mask), static_cast<float*>(a.out), a.hkv, a.rows, a.nb,
      a.sk, a.sq, a.scale, a.h);
  return cudaGetLastError();
}

// The splits per rank and round, P: all of a rank's splits (one round) if
// the block then keeps within half an SM's shared memory, else within all
// of it; past that, as many as fit, in as many rounds as it takes.
template <typename KV, int D, int PS, bool kPaged>
cudaError_t launch_decode(const Args& a) {
  using R = Raw<KV, D>;
  auto kern = decode_kernel<KV, D, PS, kPaged>;
  const int ppr = (a.nb + kRanks - 1) / kRanks;
  const size_t fixed = sizeof(float) * kRowsD * Width<D>::kPitch + R::kStages * R::kBytes +
                       (kPaged ? sizeof(int) * (ppr + 1) : 0);
  const size_t per_split =
      sizeof(float) * (static_cast<size_t>(a.rows) * (PS + 3) +
                       static_cast<size_t>(kRanks) * a.rows * (Width<D>::kSlice + 1)) +
      (kPaged ? sizeof(int) : 0);
  auto fit = [&](size_t budget) {
    return budget > fixed ? static_cast<int>(std::min<size_t>(ppr, (budget - fixed) / per_split))
                          : 0;
  };
  int P = fit(kHalfSmem);
  if (P < ppr) P = fit(kMaxSmem - 1024);   // the static shared memory besides
  if (a.rows > kRowsD || P < 1) return cudaErrorInvalidValue;
  const int nround = (a.nb + kRanks * P - 1) / (kRanks * P);
  const size_t smem = fixed + per_split * P;
  static size_t allowed = 0;
  if (cudaError_t err = allow_smem(kern, smem, allowed)) return err;
  const dim3 grid(kRanks, a.bh);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.bt),
      static_cast<const float*>(a.mask), static_cast<float*>(a.out), a.hkv, a.rows, a.nb,
      a.sk, P, nround, a.scale, a.h);
  return cudaGetLastError();
}

// the K/V type switch of one head width and split (page) size; the sources
// that include this pick the width and the size
template <bool kDecode, bool kPaged, int D, int PS>
cudaError_t launch(const Args& a, int kv_type) {
#define HYFT_LAUNCH(T) \
  return kDecode ? launch_decode<T, D, PS, kPaged>(a) : launch_verify<T, D, PS, kPaged>(a)
  if (kv_type == 0) HYFT_LAUNCH(float);
  if (kv_type == 1) HYFT_LAUNCH(__nv_bfloat16);
  if (kv_type == 2) HYFT_LAUNCH(int8_t);
#undef HYFT_LAUNCH
  return cudaErrorInvalidValue;
}

// the shared argument checks (the head width is checked by the switch on it)
inline bool valid(const Args& a) {
  return a.bh > 0 && a.hkv > 0 && a.rows > 0 && a.nb > 0 && a.sk > 0 && a.sq > 0 &&
         a.rows % a.sq == 0 && a.h.step >= 1 && a.h.mant <= a.h.frac;
}

}  // namespace
}  // namespace hyft_attend

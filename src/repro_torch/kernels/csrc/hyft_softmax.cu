// Standalone Hyft softmax over the last axis, forward and backward, for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package (src/repro/kernels/):
//   hyft_softmax_fwd  <- hyft_softmax.py:28 _fwd_kernel
//                        (pallas_call at :82, entry hyft_softmax_fwd_kernel)
//   hyft_softmax_bwd  <- hyft_softmax.py:44 _bwd_kernel
//                        (pallas_call at :110, entry hyft_softmax_bwd_kernel)
// They run behind the softmax registry's hyft16_kernel / hyft32_kernel
// entries, fed the full score rows of the unfused attention mode.
//
// Forward, per row: FP2FX of every score, the integer max over columns 0,
// step, 2 step, ...; the exponent unit on z_raw - max; the adder tree; the
// LOD of the sum; the log-subtract divide; the store in the output type.
// Backward, per row: dot = sum fx_quantize(log_mul(dy, s)), then
// dz = log_mul(fx_quantize(dy) - dot, s), both products with the
// half-range mantissa (paper Eq. 10).
//
// The sums.  The reference adds fp32 multiples of 2^-acc (forward) or
// 2^-bwd_acc (backward), which is exact, and so independent of order, only
// while the sum of the addends' magnitudes stays at or below 2^24 units.
// These kernels add the addends' integer counts in int64, exactly, and
// round the total to fp32 once: under that precondition this is the
// reference's value bit for bit, past it the correctly rounded sum (the
// reference's fp32 sum then depends on its order; the wrapper's module
// states the bound that holds there).
//
// What bounds it on an H100: bytes.  Every element is read once and written
// once.  qwen2-1.5b training at B 4 x 1024 under HYFT16 moves, forward, 302
// MB (49,152 rows of 1024 fp32 scores, fp16 out), about 90 us at 3.35 TB/s;
// backward 302 MB (fp16 s and dy, fp16 dz) or 403 MB with fp32 dz as the
// training step stores it.  The function's own arithmetic, a handful of
// operations an element, takes far less; these kernels' instructions come
// close to the bytes: 50-56 an element on a fast row, 22-30 of them on the
// integer ALU (scripts/torch_softmax_sass.py counts them in the SASS), 75-90
// us at one instruction a lane a clock (33.5 T/s) and the integer ALU's half
// rate.
//
// The forward gives each row of up to kWarpCols columns one warp, four rows
// to a block of 128 threads (rows of up to 1280 columns; a row of 1024-1057
// columns, the unfused path's, is 32-34 elements a lane).  A lane keeps its
// elements in registers, issues all its loads before their first use, and
// the max and the sum are warp shuffles, with no barrier and no shared
// memory.  Each row is read in 16-byte chunks from its first element at a
// 16-byte boundary (a row of 1057 fp32 scores starts at 4-byte alignment),
// the few elements before and after the chunks one a lane, and the output
// is stored in packed chunks alike.  The exponent unit runs once per
// element: its fields stay in the register of the element's raw from the
// adder tree to the divide.  That path needs a launch of at least
// kWarpMinRows rows: a decode step's 48 rows are too few warps to cover one
// lane's 34 loads and exponent units (8.4 us against 3.4 us for the block
// path on an H100, PERF.md).  Longer rows, fewer rows and unaligned
// pointers keep one block of 256 threads per row, the row's FP2FX raws
// staged in shared memory when they fit in 32 KB (else recomputed from
// device memory in each pass), block reductions over warp shuffles in a
// fixed order.  The backward takes the same warp path under the same gates
// (one read of s and dy, s's fields and fx_quantize(dy) kept in registers,
// the dot in int32 counts where they provably fit: see its section), else
// the block-per-row design.  Its dz is rounded to the config's type and
// stored in it or, for a caller that wants fp32, widened in the store.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>
#include <initializer_list>
#include <type_traits>

#include "hyft_numerics.cuh"

namespace {

using namespace hyft;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageCols = 8192;  // int32 raws staged in 32 KB of shared memory

__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__half* p, long i, float v) {
  p[i] = __float2half_rn(v);  // round to nearest even, subnormals kept
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// block-wide max and sum, returned to every thread; scratch holds kWarps
// values and is free again when the function returns
__device__ int block_max(int v, long long* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = static_cast<int>(scratch[0]);
  for (int w = 1; w < kWarps; ++w) r = max(r, static_cast<int>(scratch[w]));
  __syncthreads();
  return r;
}

__device__ long long block_sum(long long v, long long* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  long long r = 0;
  for (int w = 0; w < kWarps; ++w) r += scratch[w];
  __syncthreads();
  return r;
}

// the block's fp32 sum of its warps' sums (each already over its lanes), in
// warp order
__device__ float block_fsum_of_warps(float v, long long* scratch) {
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = __float_as_int(v);
  __syncthreads();
  float r = 0.0f;
  for (int w = 0; w < kWarps; ++w) r = __fadd_rn(r, __int_as_float(static_cast<int>(scratch[w])));
  __syncthreads();
  return r;
}

// Grid: one block per row; dynamic shared memory: cols int32 when kStaged.
template <typename Tin, typename Tout, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    softmax_fwd_kernel(const Tin* __restrict__ z, Tout* __restrict__ out, int cols, Params h) {
  extern __shared__ int raw[];
  __shared__ long long scratch[kWarps];
  const Tin* zr = z + static_cast<long>(blockIdx.x) * cols;
  Tout* o = out + static_cast<long>(blockIdx.x) * cols;
  // input pre-processor: FP2FX and the strided max
  int mx = INT_MIN;
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const int x = fp2fx(load_f32(zr, j), h.frac, h.total);
    if (kStaged) raw[j] = x;
    if (j % h.step == 0) mx = max(mx, x);
  }
  mx = block_max(mx, scratch);  // its barriers also publish raw[]
  // exponent unit and the adder tree, in exact integer counts of 2^-acc
  long long units = 0;
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const int x = kStaged ? raw[j] : fp2fx(load_f32(zr, j), h.frac, h.total);
    int e, m;
    exp_unit(x - mx, h.frac, h.mant, e, m);
    units += expfloat_to_fx_raw(e, m, h.mant, h.acc);
  }
  units = block_sum(units, scratch);
  const float denom = __fmul_rn(__ll2float_rn(units), pow2_float(-h.acc));
  int e_b, m_b;
  lod_refloat(denom, h.mant, e_b, m_b);
  // DIV unit: log-subtract division
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const int x = kStaged ? raw[j] : fp2fx(load_f32(zr, j), h.frac, h.total);
    int e, m;
    exp_unit(x - mx, h.frac, h.mant, e, m);
    store(o, j, log_div(e, m, e_b, m_b, h.mant));
  }
}

// --------------------------------------------------------------------------
// forward, one warp per row.  Grid ceil(rows / kWarpRows), kWarpRows warps a
// block.  A row is read from its first element at a 16-byte boundary: the
// body from there, in chunks of kVec = 16 / sizeof(Tin) consecutive
// elements, chunk c of lane l at (c * 32 + l) * kVec; the elements before it
// (the head, fewer than kVec) and after the last whole chunk (the tail)
// one a lane, on lanes [0, kVec) and [kVec, 2 kVec).  The output, indexed
// alike, is stored in packed chunks.
// --------------------------------------------------------------------------
constexpr int kWarpRows = 4;                   // rows (warps) of a block
constexpr int kWarpCols = 40 * 32;             // the longest row a warp takes
constexpr int kWarpMinRows = 4 * kWarpRows * 132;  // 4 blocks an SM; fewer: block path
// exponent fields kept between the passes as e * 2^21 + m (m < 2^mant <= 2^20);
// e is clamped at -512, below which both the term and the output are 0
constexpr int kFieldShift = 21;

// one 16-bit element's bits as fp32, exactly as load_f32 converts it
__device__ __forceinline__ float from_bits(unsigned b, const __half*) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}
__device__ __forceinline__ float from_bits(unsigned b, const __nv_bfloat16*) {
  return __uint_as_float(b << 16);
}

// 16 bytes from p as fp32: 4 floats or 8 16-bit elements
__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  x[0] = w.x, x[1] = w.y, x[2] = w.z, x[3] = w.w;
}
template <typename T16>
__device__ __forceinline__ void load_vec(const T16* p, float (&x)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = from_bits(u[i] & 0xffffu, p);
    x[2 * i + 1] = from_bits(u[i] >> 16, p);
  }
}

// one output element's bits, rounded as store() rounds it
__device__ __forceinline__ unsigned out_bits(float v, const float*) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned out_bits(float v, const __half*) {
  return __half_as_ushort(__float2half_rn(v));
}
__device__ __forceinline__ unsigned out_bits(float v, const __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// kN consecutive outputs to p as packed stores: 8, 16 or 32 bytes
template <typename Tout, int kN>
__device__ __forceinline__ void store_vec(Tout* p, const float (&y)[kN]) {
  constexpr int kWords = kN * sizeof(Tout) / 4;
  unsigned w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (sizeof(Tout) == 4)
      w[i] = out_bits(y[i], p);
    else  // the lower address in the low half
      w[i] = out_bits(y[2 * i], p) | out_bits(y[2 * i + 1], p) << 16;
  }
  if constexpr (kWords == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i)
      reinterpret_cast<uint4*>(p)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                                  w[4 * i + 3]);
  }
}

// the exponent unit of d = raw - max: its adder-tree count, and its fields
// packed as e * 2^kFieldShift + m
__device__ __forceinline__ int kept_fields(int d, const Params& h, int& count) {
  int e, m;
  exp_unit(d, h.frac, h.mant, e, m);
  e = max(e, -512);
  count = expfloat_to_fx_raw(e, m, h.mant, h.acc);
  return e * (1 << kFieldShift) + m;
}

template <typename Tin, typename Tout, int kPer>
__global__ void __launch_bounds__(32 * kWarpRows)
    softmax_fwd_warp_kernel(const Tin* __restrict__ z, Tout* __restrict__ out, int rows,
                            int cols, Params h) {
  constexpr int kVec = 16 / sizeof(Tin), kChunks = kPer / kVec;
  static_assert(kPer % kVec == 0, "whole chunks");
  const int lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kWarpRows + threadIdx.x / 32;
  if (row >= rows) return;
  const Tin* zr = z + row * cols;
  Tout* o = out + row * cols;
  const int head = min(cols, static_cast<int>((kVec - row * cols % kVec) % kVec));
  const int body = (cols - head) / kVec * kVec;
  const int je = lane < kVec ? lane : head + body + lane - kVec;  // this lane's edge element
  const bool edge = lane < kVec ? lane < head : lane < 2 * kVec && je < cols;
  auto in_body = [&](int c) { return (c * 32 + lane) * kVec < body; };
  auto col = [&](int c, int e) { return head + (c * 32 + lane) * kVec + e; };

  // every load first
  float x[kPer];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float w[kVec] = {};
    if (in_body(c)) load_vec(zr + col(c, 0), w);
#pragma unroll
    for (int e = 0; e < kVec; ++e) x[c * kVec + e] = w[e];
  }
  const float xe = edge ? load_f32(zr, je) : 0.0f;

  // input pre-processor: FP2FX and the strided max
  int raw[kPer];
  int re = fp2fx(xe, h.frac, h.total);
  int mx = edge && je % h.step == 0 ? re : INT_MIN;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < kVec; ++e) raw[c * kVec + e] = fp2fx(x[c * kVec + e], h.frac, h.total);
  if (h.step == 1) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (in_body(c)) mx = max(mx, raw[c * kVec + e]);
  } else {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (in_body(c) && col(c, e) % h.step == 0) mx = max(mx, raw[c * kVec + e]);
  }
  for (int off = 16; off > 0; off >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));

  // exponent unit and the adder tree, in exact integer counts of 2^-acc (a
  // lane's at most (kPer + 1) x 2^22 fits an int); the fields kept in raw
  int units = 0, count;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      raw[c * kVec + e] = kept_fields(raw[c * kVec + e] - mx, h, count);
      units += in_body(c) ? count : 0;
    }
  re = kept_fields(re - mx, h, count);
  units += edge ? count : 0;
  long long total = units;
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
  const float denom = __fmul_rn(__ll2float_rn(total), pow2_float(-h.acc));
  int e_b, m_b;
  lod_refloat(denom, h.mant, e_b, m_b);

  // DIV unit: log-subtract division
  auto divide = [&](int f) {
    return log_div(f >> kFieldShift, f & ((1 << kFieldShift) - 1), e_b, m_b, h.mant);
  };
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (!in_body(c)) continue;
    float y[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) y[e] = divide(raw[c * kVec + e]);
    store_vec<Tout, kVec>(o + col(c, 0), y);
  }
  if (edge) store(o, je, divide(re));
}

// one dz as stored: rounded to Tround (the config's type), then widened
// exactly to Tout where the caller asks for fp32
template <typename Tround, typename Tout>
__device__ __forceinline__ float stored_value(float v) {
  if constexpr (std::is_same_v<Tround, Tout> || std::is_same_v<Tround, float>)
    return v;
  else if constexpr (std::is_same_v<Tround, __half>)
    return __half2float(__float2half_rn(v));
  else
    return __bfloat162float(__float2bfloat16_rn(v));
}

// stored_value of an even count of values, two at a time (one packed
// conversion for each pair where a 16-bit Tround is widened)
template <typename Tround, typename Tout, int kN>
__device__ __forceinline__ void stored_pairs(float (&y)[kN]) {
  static_assert(kN % 2 == 0, "pairs");
  if constexpr (!std::is_same_v<Tround, Tout> && !std::is_same_v<Tround, float>) {
#pragma unroll
    for (int i = 0; i < kN; i += 2) {
      float2 r;
      if constexpr (std::is_same_v<Tround, __half>)
        r = __half22float2(__floats2half2_rn(y[i], y[i + 1]));
      else
        r = __bfloat1622float2(__floats2bfloat162_rn(y[i], y[i + 1]));
      y[i] = r.x, y[i + 1] = r.y;
    }
  }
}

// counts at or past this magnitude (+-inf among them: a NaN or inf dy's
// product, log_mul reading its all-ones exponent) leave the int64 sum,
// which 2^23 columns of them could overflow, and are summed in fp32 as the
// reference sums every count
constexpr float kWideCount = 0x1p40f;

// The backward of one row by the reference's arithmetic: every count
// floor(log_mul(dy, s) * 2^acc) summed in int64 after an F2I.S64 (the wide
// ones in fp32, in a fixed order), every input read again for dz.  Thread
// t of kStride takes columns t, t + kStride, ...: a block of kThreads sums
// through block_sum (scratch of kWarps), a warp (kStride 32) by its
// shuffles alone.  The block kernel's body, and the warp kernel's route for
// a row off its fast range (not inlined, so that it costs the fast path no
// registers).  A row holding an infinite count gets the reference's dot,
// +-inf or NaN, whatever the order of its sum.
template <int kStride, typename Tin, typename Tround, typename Tout>
__device__ __noinline__ void bwd_row(const Tin* sr, const Tin* dr, Tout* o, int cols,
                                     int mant, int acc, long long* scratch) {
  const int t = threadIdx.x % kStride;
  const float scale = pow2_float(acc);
  long long units = 0;
  float wide = 0.0f;
  for (int j = t; j < cols; j += kStride) {
    const float p = log_mul(load_f32(dr, j), load_f32(sr, j), mant);
    const float c = floorf(__fmul_rn(p, scale));
    if (fabsf(c) < kWideCount) {
      units += __float2ll_rz(c);
    } else {
      wide = __fadd_rn(wide, c);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    if constexpr (kStride == 32) units += __shfl_xor_sync(0xffffffffu, units, off);
    wide = __fadd_rn(wide, __shfl_xor_sync(0xffffffffu, wide, off));
  }
  if constexpr (kStride != 32) {
    units = block_sum(units, scratch);
    wide = block_fsum_of_warps(wide, scratch);
  }
  // +0 where no count was wide: the int64 route's bits
  const float dot = __fadd_rn(__fmul_rn(__ll2float_rn(units), pow2_float(-acc)),
                              __fmul_rn(wide, pow2_float(-acc)));
  for (int j = t; j < cols; j += kStride) {
    const float diff = __fsub_rn(fx_quantize(load_f32(dr, j), acc), dot);
    store(o, j, stored_value<Tround, Tout>(log_mul(diff, load_f32(sr, j), mant)));
  }
}

// Grid: one block per row.
template <typename Tin, typename Tround, typename Tout>
__global__ void __launch_bounds__(kThreads)
    softmax_bwd_kernel(const Tin* __restrict__ s, const Tin* __restrict__ dy,
                       Tout* __restrict__ dz, int cols, int mant, int acc) {
  __shared__ long long scratch[kWarps];
  const long base = static_cast<long>(blockIdx.x) * cols;
  bwd_row<kThreads, Tin, Tround, Tout>(s + base, dy + base, dz + base, cols, mant, acc,
                                       scratch);
}

// --------------------------------------------------------------------------
// backward, one warp per row, under the forward's gates and row split (head,
// 16-byte chunks, tail).  Each of s and dy is read once; a lane keeps, per
// element, s's bits, its half-range mantissa scaled for __umulhi, and
// fx_quantize(dy).
//
// The dot's route.  An element's count floor(log_mul(dy, s) * 2^acc) is
// +-num * 2^(ea + eb - mant + acc), num = 2^mant + ma + mb + prod < 2^(mant
// + 2), built as u = num * 2^(23 - mant) < 2^25 from the mantissa fields
// (one __umulhi for the half-range product); the scale is the product of
// the two exponent fields read as floats, every product exact, and the
// floor one F2I.FLOOR to int32.  A lane's sum of at most 41 counts below
// 2^25 fits an int32; the lanes' sums meet in int64.  The block kernel sums
// every count in int64 after an F2I.S64, at the conversion pipe's 16
// results a clock per SM, and builds every scale in integer operations,
// which bound it.  This is exact on a row where s lies in [+0, 2^(mant+1)),
// |dy| < 2^mant, max ea_raw + max eb_raw <= 277 - acc (every count below
// 2^25), no nonzero s or dy lies below 2^-53 (then no product comes near
// log_mul's flush at 2^-126, nor any intermediate near a subnormal; a
// nonzero fp16 value is at least 2^-24, so fp16 rows skip that check) and,
// for pass 2, |dot| < 2^(mant - 1) (|diff| < 2^(mant + 1)).  A zero
// operand's exponent field is 0, so its product is 0 as log_mul's zero
// test makes it; pass 2 adds +0 to turn s = 0's -0 into +0 (no other zero
// arises).  Any other row (large, tiny or negative inputs, NaN, inf) runs
// the block kernel's arithmetic in one warp (bwd_row: int64 counts, every
// input read again).
// --------------------------------------------------------------------------
struct BwdConsts {
  int mant, acc;
  int lift;          // 23 - mant: a product's num is held as num * 2^lift
  unsigned mm;       // a mantissa field's top mant bits, in place
  unsigned mt;       // its top mant / 2 bits, in place
  int lt, rt;        // (b & mt) << lt >> rt = mb's top half * 2^(9 + mant - mant / 2)
  int exp_cap;       // 277 - acc: the largest ea_raw + eb_raw of a fast row
  unsigned s_cap;    // a fast row's s bits stay below (128 + mant) << 23,
  unsigned a_cap;    // its |dy| bits below (127 + mant) << 23
  float dot_cap;     // and its |dot| below 2^(mant - 1)
  float q_scale, q_inv;  // 2^acc and 2^-acc: fx_quantize's grid
  float count_scale;     // 2^(acc - 23): u * 2^(eb + acc - 23) = num * 2^(eb + acc - mant)
};

// a fast row's nonzero inputs are at least 2^-53: bits - 1 at or past this
constexpr unsigned kTinyBits = (74u << 23) - 1;

BwdConsts bwd_consts(int mant, int acc) {
  BwdConsts k;
  k.mant = mant, k.acc = acc, k.lift = 23 - mant;
  k.mm = ((1u << mant) - 1) << k.lift;
  k.mt = ((1u << (mant / 2)) - 1) << (23 - mant / 2);
  k.lt = mant > 14 ? mant - 14 : 0;
  k.rt = mant < 14 ? 14 - mant : 0;
  k.exp_cap = 277 - acc;
  k.s_cap = (128u + mant) << 23;
  k.a_cap = (127u + mant) << 23;
  k.dot_cap = ldexpf(1.0f, mant - 1);
  k.q_scale = ldexpf(1.0f, acc);
  k.q_inv = ldexpf(1.0f, -acc);
  k.count_scale = ldexpf(1.0f, acc - 23);
  return k;
}

// a row's extremes of s's bits and of |dy|'s bits, for the fast-row checks
// (the minima of bits - 1, so that zeros drop out)
struct BwdRange {
  unsigned smax = 0, amax = 0, smin = ~0u, amin = ~0u;
};

// an exponent field read as a float: 2^e, with the sign where kept (0 for a
// zero operand)
__device__ __forceinline__ float exp_part(unsigned bits, unsigned mask) {
  return __uint_as_float(bits & mask);
}

// num * 2^(23 - mant) for log_mul(x, s), x's bits xb, s's bits b (mbt: s's
// top half mantissa, scaled for __umulhi)
__device__ __forceinline__ unsigned bwd_num(unsigned xb, unsigned b, unsigned mbt,
                                            const BwdConsts& k) {
  const unsigned xm = xb & k.mm;
  return (__umulhi(xm, mbt) << k.lift) + xm + ((b & k.mm) | (1u << 23));
}

// pass 1 of one element: s's kept fields, fx_quantize(dy) and the element's
// count of 2^-acc (exact on a fast row), with the row's extremes (kTiny: the
// input type holds nonzero values below 2^-53)
template <bool kTiny>
__device__ __forceinline__ unsigned bwd_count(float sv, float dv, const BwdConsts& k,
                                              unsigned& b, unsigned& mbt, float& q,
                                              BwdRange& range) {
  b = __float_as_uint(sv);
  const unsigned a = __float_as_uint(dv), mag = a & 0x7fffffffu;
  range.smax = max(range.smax, b);
  range.amax = max(range.amax, mag);
  if constexpr (kTiny) {
    range.smin = min(range.smin, b - 1);
    range.amin = min(range.amin, mag - 1);
  }
  mbt = ((b & k.mt) << k.lt) >> k.rt;
  q = __fmul_rn(floorf(__fmul_rn(dv, k.q_scale)), k.q_inv);  // fx_quantize(dv, acc)
  const float scale = __fmul_rn(exp_part(b, 0x7f800000u), k.count_scale);
  return static_cast<unsigned>(__float2int_rd(__fmul_rn(
      __fmul_rn(__uint2float_rn(bwd_num(a, b, mbt, k)), scale), exp_part(a, 0xff800000u))));
}

// pass 2 of one element on a fast row: log_mul(fx_quantize(dy) - dot, s)
__device__ __forceinline__ float bwd_dz(float q, unsigned b, unsigned mbt, float dot,
                                        const BwdConsts& k) {
  const float diff = __fadd_rn(__fsub_rn(q, dot), 0.0f);  // -0 -> +0, as log_mul's zero test
  const unsigned d = __float_as_uint(diff);
  // num * 2^(eb - mant), then the signed 2^ed; s = 0 gives -0 or +0, made +0
  const float mag = __fmul_rn(__uint2float_rn(bwd_num(d, b, mbt, k)),
                              __fmul_rn(exp_part(b, 0x7f800000u), 0x1p-23f));
  return __fadd_rn(__fmul_rn(mag, exp_part(d, 0xff800000u)), 0.0f);
}

// at most 128 registers: four blocks (16 warps) an SM keep more loads in
// flight than three at 160 (0.112 against 0.119 ms with fp16 dz on an
// H100, PERF.md)
template <typename Tin, typename Tround, typename Tout, int kPer>
__global__ void __launch_bounds__(32 * kWarpRows, 4)
    softmax_bwd_warp_kernel(const Tin* __restrict__ s, const Tin* __restrict__ dy,
                            Tout* __restrict__ dz, int rows, int cols, BwdConsts k) {
  constexpr int kVec = 16 / sizeof(Tin), kChunks = kPer / kVec;
  static_assert(kPer % kVec == 0, "whole chunks");
  const int lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kWarpRows + threadIdx.x / 32;
  if (row >= rows) return;
  const Tin* sr = s + row * cols;
  const Tin* dr = dy + row * cols;
  Tout* o = dz + row * cols;
  const int head = min(cols, static_cast<int>((kVec - row * cols % kVec) % kVec));
  const int body = (cols - head) / kVec * kVec;
  const int je = lane < kVec ? lane : head + body + lane - kVec;  // this lane's edge element
  const bool edge = lane < kVec ? lane < head : lane < 2 * kVec && je < cols;
  auto in_body = [&](int c) { return (c * 32 + lane) * kVec < body; };
  auto col = [&](int c, int e) { return head + (c * 32 + lane) * kVec + e; };

  // every load first
  float sv[kPer], dv[kPer];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float w[kVec] = {}, x[kVec] = {};
    if (in_body(c)) {
      load_vec(sr + col(c, 0), w);
      load_vec(dr + col(c, 0), x);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) sv[c * kVec + e] = w[e], dv[c * kVec + e] = x[e];
  }
  const float se = edge ? load_f32(sr, je) : 0.0f;
  const float de = edge ? load_f32(dr, je) : 0.0f;

  // pass 1: the dot's counts (padding and absent edges read 0 and count 0)
  constexpr bool kTiny = !std::is_same_v<Tin, __half>;
  unsigned b[kPer], mbt[kPer], be, mbte, units = 0;
  float q[kPer], qe;
  BwdRange range;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    units += bwd_count<kTiny>(sv[i], dv[i], k, b[i], mbt[i], q[i], range);
  units += bwd_count<kTiny>(se, de, k, be, mbte, qe, range);
  long long total = static_cast<int>(units);
  for (int off = 16; off > 0; off >>= 1) {
    total += __shfl_xor_sync(0xffffffffu, total, off);
    range.smax = max(range.smax, __shfl_xor_sync(0xffffffffu, range.smax, off));
    range.amax = max(range.amax, __shfl_xor_sync(0xffffffffu, range.amax, off));
    if constexpr (kTiny) {
      range.smin = min(range.smin, __shfl_xor_sync(0xffffffffu, range.smin, off));
      range.amin = min(range.amin, __shfl_xor_sync(0xffffffffu, range.amin, off));
    }
  }
  const float dot = __fmul_rn(__ll2float_rn(total), pow2_float(-k.acc));
  if (range.smax >= k.s_cap || range.amax >= k.a_cap ||
      static_cast<int>((range.amax >> 23) + (range.smax >> 23)) > k.exp_cap ||
      range.smin < kTinyBits || range.amin < kTinyBits ||
      !(fabsf(dot) < k.dot_cap)) {  // off the fast rows' range: warp-uniform
    bwd_row<32, Tin, Tround, Tout>(sr, dr, o, cols, k.mant, k.acc, nullptr);
    return;
  }

  // pass 2: log_mul(fx_quantize(dy) - dot, s), stored in packed chunks
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (!in_body(c)) continue;
    float y[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int i = c * kVec + e;
      y[e] = bwd_dz(q[i], b[i], mbt[i], dot, k);
    }
    stored_pairs<Tround, Tout>(y);
    store_vec<Tout, kVec>(o + col(c, 0), y);
  }
  if (edge) store(o, je, stored_value<Tround, Tout>(bwd_dz(qe, be, mbte, dot, k)));
}

// type codes: 0 float32, 1 bfloat16, 2 float16; L<Tin, Tout>::run launches
template <template <typename, typename> class L, typename Tin, typename... A>
int by_out(int out_type, A... a) {
  switch (out_type) {
    case 0: return L<Tin, float>::run(a...);
    case 1: return L<Tin, __nv_bfloat16>::run(a...);
    case 2: return L<Tin, __half>::run(a...);
    default: return cudaErrorInvalidValue;
  }
}

template <template <typename, typename> class L, typename... A>
int by_types(int in_type, int out_type, A... a) {
  switch (in_type) {
    case 0: return by_out<L, float>(out_type, a...);
    case 1: return by_out<L, __nv_bfloat16>(out_type, a...);
    case 2: return by_out<L, __half>(out_type, a...);
    default: return cudaErrorInvalidValue;
  }
}

// the warp path's lane width where it applies, else 0 (the block path): at
// least kWarpMinRows rows of at most kWarpCols columns, every input at a
// 16-byte boundary and the output at its packed stores'.  Two widths, those
// of the unfused path's rows (1024 and 1057 columns); a shorter row leaves
// the chunks past its end predicated off
template <typename Tin, typename Tout>
int warp_width(int rows, int cols, const void* out, std::initializer_list<const void*> ins) {
  constexpr size_t kVec = 16 / sizeof(Tin);
  constexpr size_t kOutAlign = kVec * sizeof(Tout) < 16 ? kVec * sizeof(Tout) : 16;
  if (rows < kWarpMinRows || cols > kWarpCols || reinterpret_cast<uintptr_t>(out) % kOutAlign)
    return 0;
  for (const void* p : ins)
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  return cols <= 32 * 32 ? 32 : 40;
}

template <typename Tin, typename Tout>
struct Fwd {
  static int run(const void* z, void* out, int rows, int cols, Params h, cudaStream_t st) {
    const Tin* zt = static_cast<const Tin*>(z);
    Tout* ot = static_cast<Tout*>(out);
    const int width = warp_width<Tin, Tout>(rows, cols, out, {z});
    const int grid = (rows + kWarpRows - 1) / kWarpRows;
    if (width == 32) {
      softmax_fwd_warp_kernel<Tin, Tout, 32>
          <<<grid, 32 * kWarpRows, 0, st>>>(zt, ot, rows, cols, h);
    } else if (width == 40) {
      softmax_fwd_warp_kernel<Tin, Tout, 40>
          <<<grid, 32 * kWarpRows, 0, st>>>(zt, ot, rows, cols, h);
    } else if (cols <= kStageCols) {
      softmax_fwd_kernel<Tin, Tout, true>
          <<<rows, kThreads, cols * sizeof(int), st>>>(zt, ot, cols, h);
    } else {
      softmax_fwd_kernel<Tin, Tout, false>
          <<<rows, kThreads, 0, st>>>(zt, ot, cols, h);
    }
    return cudaGetLastError();
  }
};

template <typename Tin, typename Tround, typename Tout>
struct Bwd {
  static int run(const void* s, const void* dy, void* dz, int rows, int cols, BwdConsts k,
                 cudaStream_t st) {
    const Tin* sp = static_cast<const Tin*>(s);
    const Tin* dp = static_cast<const Tin*>(dy);
    Tout* op = static_cast<Tout*>(dz);
    const int width = warp_width<Tin, Tout>(rows, cols, dz, {s, dy});
    const int grid = (rows + kWarpRows - 1) / kWarpRows;
    if (width == 32) {
      softmax_bwd_warp_kernel<Tin, Tround, Tout, 32><<<grid, 32 * kWarpRows, 0, st>>>(
          sp, dp, op, rows, cols, k);
    } else if (width == 40) {
      softmax_bwd_warp_kernel<Tin, Tround, Tout, 40><<<grid, 32 * kWarpRows, 0, st>>>(
          sp, dp, op, rows, cols, k);
    } else {
      softmax_bwd_kernel<Tin, Tround, Tout><<<rows, kThreads, 0, st>>>(sp, dp, op, cols,
                                                                        k.mant, k.acc);
    }
    return cudaGetLastError();
  }
};

// dz rounded to Tround and stored as Tround, or widened to fp32 (out type 0)
template <typename Tin, typename Tround>
int bwd_store(int round_type, int out_type, const void* s, const void* dy, void* dz, int rows,
              int cols, BwdConsts k, cudaStream_t st) {
  if (out_type == round_type) return Bwd<Tin, Tround, Tround>::run(s, dy, dz, rows, cols, k, st);
  if (out_type == 0) return Bwd<Tin, Tround, float>::run(s, dy, dz, rows, cols, k, st);
  return cudaErrorInvalidValue;
}

template <typename Tin>
int bwd_round(int round_type, int out_type, const void* s, const void* dy, void* dz, int rows,
              int cols, BwdConsts k, cudaStream_t st) {
  switch (round_type) {
    case 0: return bwd_store<Tin, float>(round_type, out_type, s, dy, dz, rows, cols, k, st);
    case 1:
      return bwd_store<Tin, __nv_bfloat16>(round_type, out_type, s, dy, dz, rows, cols, k, st);
    case 2: return bwd_store<Tin, __half>(round_type, out_type, s, dy, dz, rows, cols, k, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// z (rows, cols) of in_type -> out (rows, cols) of out_type: the Hyft
// softmax of every row, one warp per row (one block per row for rows past
// 1280 columns or fewer than kWarpMinRows rows).  Returns the cudaError_t of
// the launch.
int hyft_softmax_fwd(const void* z, void* out, int in_type, int out_type, int rows, int cols,
                     int frac, int total, int mant, int acc, int step, void* stream) {
  if (rows <= 0 || cols <= 0 || step < 1 || frac >= total ||
      total > 31 || mant < 1 || mant > frac || acc < 0 || acc > 22)
    return cudaErrorInvalidValue;
  const Params h{frac, total, mant, acc, step};
  return by_types<Fwd>(in_type, out_type, z, out, rows, cols, h,
                       static_cast<cudaStream_t>(stream));
}

// s, dy (rows, cols) of in_type -> dz (rows, cols): the Hyft softmax VJP of
// every row at mantissa width mant and a dot-product grid of 2^-bwd_acc,
// rounded to round_type and stored as round_type or, with out_type 0, as
// fp32 (exactly the rounded value).  One warp per row (one block per row for
// rows past 1280 columns or fewer than kWarpMinRows rows).  Returns the
// cudaError_t of the launch.
int hyft_softmax_bwd(const void* s, const void* dy, void* dz, int in_type, int round_type,
                     int out_type, int rows, int cols, int mant, int bwd_acc, void* stream) {
  if (rows <= 0 || cols <= 0 || mant < 2 || mant > 20 || bwd_acc < 0 || bwd_acc > 30)
    return cudaErrorInvalidValue;
  const BwdConsts k = bwd_consts(mant, bwd_acc);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_type) {
    case 0: return bwd_round<float>(round_type, out_type, s, dy, dz, rows, cols, k, st);
    case 1: return bwd_round<__nv_bfloat16>(round_type, out_type, s, dy, dz, rows, cols, k, st);
    case 2: return bwd_round<__half>(round_type, out_type, s, dy, dz, rows, cols, k, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"

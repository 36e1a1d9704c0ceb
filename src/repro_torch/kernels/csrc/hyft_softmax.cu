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
// What bounds it on an H100: bytes.  Every element is read once and
// written once, with a few dozen integer operations between.  qwen2-1.5b
// training at B 4 x 1024 under HYFT16 (49,152 rows of 1024 fp32 scores,
// fp16 out): 302 MB, about 90 us at 3.35 TB/s.  Close behind come the
// issue slots: some 60 integer operations per element, 3.1 G at that shape,
// are about 0.1 ms of warp instructions on 132 SMs.
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
// fixed order.  The backward is that block-per-row design.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

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

// Grid: one block per row.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    softmax_bwd_kernel(const Tin* __restrict__ s, const Tin* __restrict__ dy,
                       Tout* __restrict__ dz, int cols, int mant, int acc) {
  __shared__ long long scratch[kWarps];
  const float scale = pow2_float(acc);
  const long base = static_cast<long>(blockIdx.x) * cols;
  // log-domain products, quantized to counts of 2^-acc, summed exactly
  long long units = 0;
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const float p = log_mul(load_f32(dy, base + j), load_f32(s, base + j), mant);
    units += __float2ll_rz(floorf(__fmul_rn(p, scale)));
  }
  units = block_sum(units, scratch);
  const float dot = __fmul_rn(__ll2float_rn(units), pow2_float(-acc));
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const float diff = __fsub_rn(fx_quantize(load_f32(dy, base + j), acc), dot);
    store(dz, base + j, log_mul(diff, load_f32(s, base + j), mant));
  }
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

// the warp path for kPer elements a lane; false where the pointers do not
// allow its 16-byte chunks
template <typename Tin, typename Tout, int kPer>
bool launch_warp(const Tin* z, Tout* out, int rows, int cols, Params h, cudaStream_t st) {
  constexpr size_t kVec = 16 / sizeof(Tin);
  constexpr size_t kOutAlign = kVec * sizeof(Tout) < 16 ? kVec * sizeof(Tout) : 16;
  if (reinterpret_cast<uintptr_t>(z) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % kOutAlign != 0)
    return false;
  softmax_fwd_warp_kernel<Tin, Tout, kPer>
      <<<(rows + kWarpRows - 1) / kWarpRows, 32 * kWarpRows, 0, st>>>(z, out, rows, cols, h);
  return true;
}

// the warp path where it applies: rows of at most kWarpCols columns, at
// least kWarpMinRows of them, aligned pointers
template <typename Tin, typename Tout>
bool run_warp(const Tin* z, Tout* out, int rows, int cols, Params h, cudaStream_t st) {
  if (rows < kWarpMinRows || cols > kWarpCols) return false;
  // two widths, those of the unfused path's rows (1024 and 1057 columns);
  // a shorter row leaves the chunks past its end predicated off
  if (cols <= 32 * 32) return launch_warp<Tin, Tout, 32>(z, out, rows, cols, h, st);
  return launch_warp<Tin, Tout, 40>(z, out, rows, cols, h, st);
}

template <typename Tin, typename Tout>
struct Fwd {
  static int run(const void* z, void* out, int rows, int cols, Params h, cudaStream_t st) {
    const Tin* zt = static_cast<const Tin*>(z);
    Tout* ot = static_cast<Tout*>(out);
    if (run_warp(zt, ot, rows, cols, h, st)) return cudaGetLastError();
    if (cols <= kStageCols) {
      softmax_fwd_kernel<Tin, Tout, true>
          <<<rows, kThreads, cols * sizeof(int), st>>>(zt, ot, cols, h);
    } else {
      softmax_fwd_kernel<Tin, Tout, false>
          <<<rows, kThreads, 0, st>>>(zt, ot, cols, h);
    }
    return cudaGetLastError();
  }
};

template <typename Tin, typename Tout>
struct Bwd {
  static int run(const void* s, const void* dy, void* dz, int rows, int cols, int mant,
                 int acc, cudaStream_t st) {
    softmax_bwd_kernel<Tin, Tout><<<rows, kThreads, 0, st>>>(
        static_cast<const Tin*>(s), static_cast<const Tin*>(dy), static_cast<Tout*>(dz),
        cols, mant, acc);
    return cudaGetLastError();
  }
};

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

// s, dy (rows, cols) of in_type -> dz (rows, cols) of out_type: the Hyft
// softmax VJP of every row at mantissa width mant and a dot-product grid of
// 2^-bwd_acc.  Returns the cudaError_t of the launch.
int hyft_softmax_bwd(const void* s, const void* dy, void* dz, int in_type, int out_type,
                     int rows, int cols, int mant, int bwd_acc, void* stream) {
  if (rows <= 0 || cols <= 0 || mant < 2 || mant > 20 || bwd_acc < 0 || bwd_acc > 30)
    return cudaErrorInvalidValue;
  return by_types<Bwd>(in_type, out_type, s, dy, dz, rows, cols, mant, bwd_acc,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"

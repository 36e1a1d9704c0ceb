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
// What bounds it on an H100: bytes.  Every element is read once (three
// reads of a row, of which the first comes from device memory and the
// others from shared memory or L1) and written once, with a few dozen
// integer operations between.  qwen2-1.5b training at B 4 x 1024 under
// HYFT16 (49,152 rows of 1024 fp32 scores, fp16 out): 302 MB, about 90 us
// at 3.35 TB/s.  This first version is plain: one block of 256 threads per
// row, the row's FP2FX raws staged in
// shared memory when they fit in 32 KB (else recomputed from device memory
// in each pass), block reductions over warp shuffles in a fixed order.

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

template <typename Tin, typename Tout>
struct Fwd {
  static int run(const void* z, void* out, int rows, int cols, Params h, cudaStream_t st) {
    const Tin* zt = static_cast<const Tin*>(z);
    Tout* ot = static_cast<Tout*>(out);
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
// softmax of every row, one block of threads per row.  Returns the
// cudaError_t of the launch.
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

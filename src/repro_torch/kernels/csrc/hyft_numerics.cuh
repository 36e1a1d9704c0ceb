// Hyft numerics as CUDA device functions, shared by every kernel source.
//
// One-to-one transcriptions of repro_torch/core/numerics.py (and so of the
// JAX package's repro/core/numerics.py), so that the kernels and the plain
// PyTorch versions agree bit for bit on the Hyft arithmetic:
//  * rintf is round-half-even like torch.round / jnp.rint;
//  * >> on int is arithmetic; shift amounts are capped at 31 as
//    expfloat_to_fx caps them;
//  * bitcasts go through __float_as_int / __int_as_float;
//  * products and sums that the reference rounds separately are written
//    with __fmul_rn / __fadd_rn, so nvcc cannot contract them into an FMA;
//  * no fast math: build without --use_fast_math and -ftz=true.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hyft {

constexpr float kNegBig = -3.0e38f;  // pre-quantization mask value

struct Params {
  int frac, total, mant, acc, step;
};

__device__ __forceinline__ float load_f32(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_f32(const int8_t* p, long i) {
  return static_cast<float>(p[i]);
}

// 2^k assembled in the exponent field; biased exponent clipped to [0, 255]
// (255 = +inf, 0 and below flush to zero) -- numerics.pow2_float
__device__ __forceinline__ float pow2_float(int k) {
  const int biased = min(max(k + 127, 0), 255);
  return biased <= 0 ? 0.0f : __int_as_float(biased << 23);
}

// float -> fixed-point raw, round half to even, saturating -- numerics.fp2fx
__device__ __forceinline__ int fp2fx(float x, int frac, int total) {
  const float lo = -static_cast<float>(1 << (total - 1));
  const float hi = static_cast<float>((1 << (total - 1)) - 1);
  const float r = rintf(__fmul_rn(x, pow2_float(frac)));
  return static_cast<int>(fminf(fmaxf(r, lo), hi));
}

// hybrid exponent unit -- numerics.exp_unit (mant <= frac by HyftConfig)
__device__ __forceinline__ void exp_unit(int d, int frac, int mant, int& e, int& m) {
  int t = d + (d >> 1) - (d >> 4);
  t = min(t, 0);
  const int u = -((-t) >> frac);
  const int v = t - static_cast<int>(static_cast<unsigned>(u) << frac);
  e = u - 1;
  m = (1 << frac) + v;
  if (m == (1 << frac)) {
    e += 1;
    m = 0;
  }
  m >>= frac - mant;  // truncate to mant bits and rescale to the mant grid
}

// the fp32 value of the (e, m) fields: (2^mant + m) * 2^(e - mant)
__device__ __forceinline__ float assemble(int e, int m, int mant) {
  return __fmul_rn(static_cast<float>((1 << mant) + m), pow2_float(e - mant));
}

// adder-tree input: the multiple of 2^-acc below the value -- expfloat_to_fx
__device__ __forceinline__ float expfloat_to_fx(int e, int m, int mant, int acc) {
  const int shift = e + acc - mant;
  const int base = (1 << mant) + m;
  int q;
  if (shift >= 0) {
    q = base << shift;
  } else if (shift <= -32) {
    q = 0;
  } else {
    q = base >> min(-shift, 31);
  }
  return __fmul_rn(static_cast<float>(q), pow2_float(-acc));
}

// two's-complement truncation to frac fractional bits -- numerics.fx_quantize
__device__ __forceinline__ float fx_quantize(float x, int frac) {
  const float s = pow2_float(frac);
  return __fmul_rn(floorf(__fmul_rn(x, s)), 1.0f / s);
}

// fp32 -> (sign, exponent, mantissa raw @ mant), truncating -- float_fields
__device__ __forceinline__ void float_fields(float x, int mant, int& sign, int& e, int& m) {
  const int bits = __float_as_int(x);
  sign = (bits >> 31) & 1;
  e = ((bits >> 23) & 0xFF) - 127;
  m = (bits >> (23 - mant)) & ((1 << mant) - 1);
}

// leading-one detector: fp32 sum -> (e, m @ mant) -- numerics.lod_refloat
__device__ __forceinline__ void lod_refloat(float s, int mant, int& e, int& m) {
  int sign;
  float_fields(s, mant, sign, e, m);
}

// log-subtract division a / b ~= 2^(e_a - e_b + m_a - m_b) -- numerics.log_div
__device__ __forceinline__ float log_div(int e_a, int m_a, int e_b, int m_b, int mant) {
  const int diff = m_a - m_b;
  const int neg = diff < 0 ? 1 : 0;
  const int e = e_a - e_b - neg;
  const int m = neg ? (1 << mant) + diff : diff;
  return assemble(e, m, mant);
}

// Hyft exp of a fixed-point max delta d <= 0, as fp32 -- hyft_alpha
__device__ __forceinline__ float hyft_alpha(int d, const Params& h) {
  int e, m;
  exp_unit(d, h.frac, h.mant, e, m);
  return assemble(e, m, h.mant);
}

// stage 3: acc / l through the DIV unit -- flash_attention.hyft_finalize
__device__ __forceinline__ float hyft_finalize(float acc, float l, int mant) {
  int e_b, m_b, sign, e_n, m_n;
  lod_refloat(l, mant, e_b, m_b);
  float_fields(acc, mant, sign, e_n, m_n);
  const float res = log_div(e_n, m_n, e_b, m_b, mant);
  if (acc == 0.0f) return 0.0f;
  return sign == 1 ? -res : res;
}

}  // namespace hyft

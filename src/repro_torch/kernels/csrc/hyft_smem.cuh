// Shared-memory staging and float4 helpers of the attention kernels
// (hyft_attend.cuh's split-K kernels and hyft_flash.cu's flash kernels):
// cp.async copies from global into shared memory, float4 reads of a shared
// tile with one in-order fmaf chain over their four elements, and the
// padded width that both kernel families lay their threads out for.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hyft {

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

// four consecutive elements of a shared tile as fp32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// The attention kernels' thread layouts are built for kDP, the head width
// D rounded up to the 64 columns of a row group's float4 groups: D = 16
// and 112 run with idle columns past D, which no operand holds in device
// memory.
template <int D>
struct Wide {
  static_assert(D % 16 == 0 && D >= 16 && D <= 192,
                "the thread layouts cover multiples of 16 up to 192 columns");
  static constexpr int kDP = (D + 63) / 64 * 64;
};

// zero columns D..kDP-1 of n rows of a shared tile of pitch kPitch, so that
// the columns past D read as zero (nothing when kDP = D)
template <int D, int kPitch, typename T>
__device__ __forceinline__ void zero_tail(T* s, int n) {
  constexpr int kTail = Wide<D>::kDP - D;
  if constexpr (kTail > 0)
    for (int i = threadIdx.x; i < n * kTail; i += blockDim.x)
      s[(i / kTail) * kPitch + D + i % kTail] = T(0.0f);
}

// dot = fmaf(a[d], b[d], dot) for d = 0..3 of one float4 pair, in order
__device__ __forceinline__ float fma4(float4 a, float4 b, float dot) {
  dot = fmaf(a.x, b.x, dot);
  dot = fmaf(a.y, b.y, dot);
  dot = fmaf(a.z, b.z, dot);
  return fmaf(a.w, b.w, dot);
}

}  // namespace hyft

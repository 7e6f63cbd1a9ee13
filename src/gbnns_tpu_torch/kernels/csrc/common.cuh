// Device helpers shared by the scan kernels (scan_topk.cu, gated_topm.cu,
// shifted_scan.cu, distance_topk.cu):
// the element kinds of the C interfaces, the IEEE-f32 total-order flip, and
// the exact widening of 16-bit floats to f32. Plain CUDA: no PyTorch or
// CUTLASS header.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gbnns {

// Element type of a scan's query and corpus (the `kind` of the C API).
enum ScanKind { kBf16 = 0, kInt8 = 1, kF32 = 2, kF16 = 3 };

constexpr int kIntMax = 0x7FFFFFFF;

// IEEE-f32 bits -> signed-int total order (an involution).
__device__ __forceinline__ int flip_bits(int b) {
  return b < 0 ? (b ^ 0x7FFFFFFF) : b;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float f16_lo(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
}

__device__ __forceinline__ float f16_hi(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}

// One 16-byte group of eight bf16 (KIND kBf16) or fp16 (kF16) values ->
// eight floats (exact).
template <int KIND>
__device__ __forceinline__ void half8_to_f32(uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (KIND == kF16) {
      f[2 * k] = f16_lo(w[k]);
      f[2 * k + 1] = f16_hi(w[k]);
    } else {
      f[2 * k] = bf16_lo(w[k]);
      f[2 * k + 1] = bf16_hi(w[k]);
    }
  }
}

// One 8-byte group of four bf16 (KIND kBf16) or fp16 (kF16) values -> four
// floats (exact).
template <int KIND>
__device__ __forceinline__ float4 half4_to_f32(uint2 v) {
  if constexpr (KIND == kF16)
    return make_float4(f16_lo(v.x), f16_hi(v.x), f16_lo(v.y), f16_hi(v.y));
  else
    return make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
}

}  // namespace gbnns

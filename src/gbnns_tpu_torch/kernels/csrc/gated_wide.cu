// T4 gated_topm at widths above 128 on the CUDA cores (see gated_topm.cu,
// whose C interface launches it through gbnns::launch_gated_wide): compiled
// apart from gated_topm.cu, so that nvcc builds the two parts of
// libgated_topm.so in parallel (kernels/_build.py links them). Plain CUDA:
// no PyTorch header.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // queries per block, one per thread

using gbnns::flip_bits;
using gbnns::half8_to_f32;
using gbnns::kBf16;
using gbnns::kF16;
using gbnns::kF32;
using gbnns::kIntMax;

// Any d > 128 that is a multiple of 16: one query per thread, as
// gated_topm_kernel, with its levels and output; the dot products run as in
// K1's binned_scan_wide_kernel (kWideRows rows a step, kWideCols columns
// a slab, the query read 16 columns at a time, the row sums in registers).
constexpr int kWideRows = 32;
constexpr int kWideCols = 64;

template <int KIND, int M>
__global__ void __launch_bounds__(kThreads)
gated_topm_wide_kernel(const void* __restrict__ q_ptr,
                       const void* __restrict__ x_ptr,
                       const float* __restrict__ addvec,
                       const int* __restrict__ tile_mask,
                       float* __restrict__ out_val, int* __restrict__ out_idx,
                       int B, int d, int chunk, int tq, int b_tiles, int m,
                       int fine_bits, int sub_bits, int km) {
  __shared__ __align__(16) float xs[kWideRows * kWideCols];
  __shared__ float adds[kWideRows];

  const int j = blockIdx.y;  // corpus chunk
  const int tid = threadIdx.x;
  const int qi = blockIdx.x * kThreads + tid;
  const bool live = qi < B;
  const bool keep = live && tile_mask[(long long)j * b_tiles + qi / tq] > 0;
  const long long col0 = (long long)j * chunk;
  const long long out0 = (long long)j * m * B + qi;  // row j * m, column qi

  if (!__syncthreads_or(keep)) {  // the whole block is skipped
    if (live)
      for (int t = 0; t < m; ++t) {
        out_val[out0 + (long long)t * B] = __int_as_float(0x7F800000);
        out_idx[out0 + (long long)t * B] = -1;
      }
    return;
  }

  int key[M];  // ascending; kIntMax is empty
  int pos[M];  // the key's row in the chunk
#pragma unroll
  for (int t = 0; t < M; ++t) {
    key[t] = kIntMax;
    pos[t] = 0;
  }
  const int sub_mask = (1 << sub_bits) - 1;
  const int fine_mask = (1 << fine_bits) - 1;
  int kmin = kIntMax;  // running min pkey of the current fine group

  for (int t0 = 0; t0 < chunk; t0 += kWideRows) {
    const int cnt = min(kWideRows, chunk - t0);
    float acc[kWideRows];
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) acc[r] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kWideCols) {
      const int groups = min(kWideCols, d - c0) / 16;  // 16-column groups
      __syncthreads();  // the previous slab is consumed
      for (int i = tid; i < kWideRows * groups; i += kThreads) {
        const int r = i / groups;
        const int g = i % groups;
        const long long e = (col0 + t0 + r) * d + c0 + 16 * g;  // element
        float f[16];
        if (r >= cnt) {
#pragma unroll
          for (int k = 0; k < 16; ++k) f[k] = 0.f;
        } else if constexpr (KIND == kF32) {
          const float4* src = reinterpret_cast<const float4*>(
              static_cast<const float*>(x_ptr) + e);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 v = src[k];
            f[4 * k] = v.x; f[4 * k + 1] = v.y;
            f[4 * k + 2] = v.z; f[4 * k + 3] = v.w;
          }
        } else {
          const uint4* src = reinterpret_cast<const uint4*>(
              static_cast<const uint16_t*>(x_ptr) + e);
          half8_to_f32<KIND>(src[0], f);
          half8_to_f32<KIND>(src[1], f + 8);
        }
        float4* dst = reinterpret_cast<float4*>(xs) + r * (kWideCols / 4)
                      + 4 * g;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dst[k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2],
                               f[4 * k + 3]);
      }
      if (c0 == 0)
        for (int i = tid; i < cnt; i += kThreads)
          adds[i] = addvec[col0 + t0 + i];
      __syncthreads();
      if (!keep) continue;

      for (int g = 0; g < groups; ++g) {
        const long long qe = (long long)qi * d + c0 + 16 * g;  // element
        float qv[16];
        if constexpr (KIND == kF32) {
          const float4* src = reinterpret_cast<const float4*>(
              static_cast<const float*>(q_ptr) + qe);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 v = src[k];
            qv[4 * k] = v.x; qv[4 * k + 1] = v.y;
            qv[4 * k + 2] = v.z; qv[4 * k + 3] = v.w;
          }
        } else {
          const uint4* src = reinterpret_cast<const uint4*>(
              static_cast<const uint16_t*>(q_ptr) + qe);
          half8_to_f32<KIND>(src[0], qv);
          half8_to_f32<KIND>(src[1], qv + 8);
        }
#pragma unroll
        for (int r = 0; r < kWideRows; ++r) {
          const float4* xr = reinterpret_cast<const float4*>(xs)
                             + r * (kWideCols / 4) + 4 * g;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 xv = xr[k];
            acc[r] = fmaf(xv.x, qv[4 * k], acc[r]);
            acc[r] = fmaf(xv.y, qv[4 * k + 1], acc[r]);
            acc[r] = fmaf(xv.z, qv[4 * k + 2], acc[r]);
            acc[r] = fmaf(xv.w, qv[4 * k + 3], acc[r]);
          }
        }
      }
    }
    if (!keep) continue;

#pragma unroll
    for (int r = 0; r < kWideRows; ++r) {
      if (r >= cnt) break;
      const float s = __fadd_rn(adds[r], acc[r]);
      const int row = t0 + r;  // row in the chunk
      kmin = min(kmin, (flip_bits(__float_as_int(s)) & ~sub_mask) |
                           (row & sub_mask));
      if ((row & fine_mask) != fine_mask) continue;
      // the fine group ends here: its level-2 key enters the sorted list
      int k2 = (kmin & ~km) | (row >> fine_bits);
      if (k2 < key[M - 1]) {
        int p = (row & ~sub_mask) | (kmin & sub_mask);
#pragma unroll
        for (int t = 0; t < M; ++t) {
          if (k2 < key[t]) {
            const int tk = key[t], tp = pos[t];
            key[t] = k2; pos[t] = p;
            k2 = tk; p = tp;
          }
        }
      }
      kmin = kIntMax;
    }
  }

  if (!live) return;
#pragma unroll
  for (int t = 0; t < M; ++t) {
    if (t >= m) break;
    const long long o = out0 + (long long)t * B;
    if (keep) {
      out_val[o] = __int_as_float(flip_bits(key[t] & ~km));
      out_idx[o] = (int)(col0 + pos[t]);
    } else {
      out_val[o] = __int_as_float(0x7F800000);
      out_idx[o] = -1;
    }
  }
}

template <int M>
cudaError_t launch_wide(const void* q, const void* x, const float* addvec,
                        const int* tile_mask, float* out_val, int* out_idx,
                        int B, int d, int n_chunks, int chunk, int tq,
                        int b_tiles, int m, int fine_bits, int sub_bits,
                        int km, int kind, cudaStream_t stream) {
  const dim3 grid((B + kThreads - 1) / kThreads, n_chunks);
#define GBNNS_GATED_WIDE(KI)                                                \
  gated_topm_wide_kernel<KI, M><<<grid, kThreads, 0, stream>>>(             \
      q, x, addvec, tile_mask, out_val, out_idx, B, d, chunk, tq, b_tiles,  \
      m, fine_bits, sub_bits, km)
  switch (kind) {
    case kBf16: GBNNS_GATED_WIDE(kBf16); break;
    case kF32: GBNNS_GATED_WIDE(kF32); break;
    case kF16: GBNNS_GATED_WIDE(kF16); break;
    default: return cudaErrorInvalidValue;
  }
#undef GBNNS_GATED_WIDE
  return cudaGetLastError();
}

}  // namespace

namespace gbnns {

cudaError_t launch_gated_wide(const void* q, const void* x,
                              const float* addvec, const int* tile_mask,
                              float* out_val, int* out_idx, int B, int d,
                              int n_chunks, int chunk, int tq, int b_tiles,
                              int m, int fine_bits, int sub_bits, int km,
                              int kind, cudaStream_t stream) {
  if (d <= 128 || d % 16 != 0) return cudaErrorInvalidValue;
  if (m <= 16)
    return launch_wide<16>(q, x, addvec, tile_mask, out_val, out_idx, B, d,
                           n_chunks, chunk, tq, b_tiles, m, fine_bits,
                           sub_bits, km, kind, stream);
  return launch_wide<32>(q, x, addvec, tile_mask, out_val, out_idx, B, d,
                         n_chunks, chunk, tq, b_tiles, m, fine_bits, sub_bits,
                         km, kind, stream);
}

}  // namespace gbnns

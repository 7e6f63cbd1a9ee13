// Hopper (sm_90a) kernel of the shifted-key scan, behind a plain C interface
// that gbnns_tpu_torch/kernels/scan_topk.py binds with ctypes. The file
// includes no PyTorch or CUTLASS header, so one nvcc call builds it in
// seconds:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libshifted_scan.so shifted_scan.cu
//
// The launcher takes the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).
//
// T3 shifted_scan -- replaces gbnns_tpu/kernels/scan_topk_pallas.py
//   _scan_kernel_shifted (pallas_call at line 266, reached through
//   shifted_scan and FusedScanIndex(mode="shifted")). The operands are
//   augmented (augment_corpus / augment_queries) so that ONE dot product is
//   the whole score: ||x||^2 - 2 q.x + ||q||^2 (l2) or C_q - q.x (ip), >= 0
//   but for rounding. For every corpus bin of `bin_size` rows and every
//   query it keeps the min of the packed key
//     key = (raw IEEE bits of the score & ~mask) | row_in_bin
//   (no sign flip: non-negative floats order as signed ints; among the
//   negative residues of exact duplicate rows the int order is the raw-bits
//   order, as in the Pallas kernel) and writes bin-major
//     val = key & ~mask read as f32,  id = (key & mask) + bin * bin_size.
//   Kinds: bf16, fp16, f32 (the Pallas index casts x_aug to any float type).
//   Widths: d_aug in {20, 36, 68, 132}, the reduced width 16/32/64/128 plus
//   the four augmented columns. The l2 operands at d' = 32 are exactly 36
//   wide, with no padding; an ip corpus is one column wider than its data
//   (33 at d' = 32), and FusedScanIndex pads it to 36 with zero columns,
//   9 % more FMAs than its 33. A width of 36 would go to 64 in K1's
//   16/32/64/128 register layout (78 % more FMAs); rows of 36 staged as f32
//   are 144 bytes, a multiple of 16, and 72 bytes as bf16, a multiple of 8,
//   so 8-byte loads stage them with no padding.
//   Bound on an H100 SXM at the serving shape (n_pad = 1,015,808, B =
//   16,384, d_aug = 36 as the TPU kernel computes it, not a padded width):
//   2*B*n_pad*d_aug = 1.198 TFLOP, 1.21 ms at the 989 TFLOP/s bf16 tensor-
//   core peak, against ~0.2 GB of bytes (~0.06 ms): bound by operations.
//   What the design does about it: this first version runs on the CUDA
//   cores, as K1 does (fp32 FMAs from the widened bf16/fp16 inputs, exact
//   products; f32 inputs with no TF32). A block owns one bin and 128*QPT
//   queries; each thread keeps QPT augmented queries in registers (QPT =
//   128 / d_aug, at least 1: three at d_aug = 36) and a running key per
//   query; corpus rows are staged in 16 KB of shared memory as f32 and read
//   as warp-wide float4 broadcasts, so the inner loop is 4*QPT FMAs per
//   16-byte shared load. The score epilogue is an and, an or and a min: the
//   addvec load, add and sign flip of K1 are gone. No score reaches device
//   memory. Query rows past B are not loaded (their threads hold zeros and
//   write nothing): the Pallas kernel's zero-padded queries meet the
//   padding rows' +inf as 0*inf = NaN, which here never reaches a real
//   query's key. Tensor cores (mma.sync / wgmma) are left for a later
//   change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileBytes = 16384;  // corpus rows staged per step, as f32

using gbnns::half4_to_f32;
using gbnns::kBf16;
using gbnns::kF16;
using gbnns::kF32;
using gbnns::kIntMax;

// D = d_aug, a multiple of 4; QPT queries per thread.
template <int D, int QPT, int KIND>
__global__ void __launch_bounds__(kThreads)
shifted_scan_kernel(const void* __restrict__ q_ptr,
                    const void* __restrict__ x_ptr,
                    float* __restrict__ out_val, int* __restrict__ out_idx,
                    int B, int bin_size, int idx_bits) {
  constexpr int kVecs = D / 4;  // float4 (f32) or uint2 (16-bit) per row
  constexpr int kRows = kTileBytes / (D * 4);
  __shared__ __align__(16) float4 xs[kRows * kVecs];

  const int bin = blockIdx.x;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * (kThreads * QPT) + tid;
  const long long row0 = (long long)bin * bin_size;
  const int mask = (1 << idx_bits) - 1;

  float4 qv[QPT][kVecs];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qi = q0 + j * kThreads;
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      if (qi >= B) {
        qv[j][k] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if constexpr (KIND == kF32) {
        qv[j][k] = reinterpret_cast<const float4*>(q_ptr)[
            (long long)qi * kVecs + k];
      } else {
        qv[j][k] = half4_to_f32<KIND>(reinterpret_cast<const uint2*>(q_ptr)[
            (long long)qi * kVecs + k]);
      }
    }
  }

  int key[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) key[j] = kIntMax;

  for (int t0 = 0; t0 < bin_size; t0 += kRows) {
    const int cnt = min(kRows, bin_size - t0);
    __syncthreads();  // the previous step's rows are consumed
    const long long v0 = (row0 + t0) * kVecs;
    for (int i = tid; i < cnt * kVecs; i += kThreads) {
      if constexpr (KIND == kF32)
        xs[i] = reinterpret_cast<const float4*>(x_ptr)[v0 + i];
      else
        xs[i] = half4_to_f32<KIND>(reinterpret_cast<const uint2*>(x_ptr)[v0 + i]);
    }
    __syncthreads();

    for (int r = 0; r < cnt; ++r) {
      const float4* xr = xs + r * kVecs;
      float acc[QPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) acc[j] = 0.f;
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        const float4 xv = xr[k];
#pragma unroll
        for (int j = 0; j < QPT; ++j) {
          acc[j] = fmaf(xv.x, qv[j][k].x, acc[j]);
          acc[j] = fmaf(xv.y, qv[j][k].y, acc[j]);
          acc[j] = fmaf(xv.z, qv[j][k].z, acc[j]);
          acc[j] = fmaf(xv.w, qv[j][k].w, acc[j]);
        }
      }
      const int row = t0 + r;
#pragma unroll
      for (int j = 0; j < QPT; ++j)
        key[j] = min(key[j], (__float_as_int(acc[j]) & ~mask) | row);
    }
  }

#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qi = q0 + j * kThreads;
    if (qi >= B) continue;
    const long long o = (long long)bin * B + qi;
    out_val[o] = __int_as_float(key[j] & ~mask);
    out_idx[o] = (int)(row0 + (key[j] & mask));
  }
}

template <int D>
cudaError_t launch_shifted(const void* q, const void* x, float* out_val,
                           int* out_idx, int B, int n_bins, int bin_size,
                           int idx_bits, int kind, cudaStream_t stream) {
  constexpr int QPT = D < 128 ? 128 / D : 1;
  const dim3 grid(n_bins, (B + kThreads * QPT - 1) / (kThreads * QPT));
  switch (kind) {
    case kBf16:
      shifted_scan_kernel<D, QPT, kBf16><<<grid, kThreads, 0, stream>>>(
          q, x, out_val, out_idx, B, bin_size, idx_bits);
      break;
    case kF16:
      shifted_scan_kernel<D, QPT, kF16><<<grid, kThreads, 0, stream>>>(
          q, x, out_val, out_idx, B, bin_size, idx_bits);
      break;
    case kF32:
      shifted_scan_kernel<D, QPT, kF32><<<grid, kThreads, 0, stream>>>(
          q, x, out_val, out_idx, B, bin_size, idx_bits);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gbnns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q_aug (B, d) and x_aug (n_pad, d) of one kind: 0 bf16, 2 f32, 3 fp16 (the
// kinds of scan_topk.cu; int8 is refused); out_val f32 / out_idx int32,
// both (n_pad / bin_size, B). d in {20, 36, 68, 132}; bin_size a power of
// two dividing n_pad. Pointers 16-byte aligned.
int gbnns_shifted_scan(const void* q, const void* x, float* out_val,
                       int* out_idx, int B, int n_pad, int d, int bin_size,
                       int kind, void* stream) {
  int idx_bits = 0;
  while ((1 << idx_bits) < bin_size) ++idx_bits;
  if (B <= 0 || bin_size <= 0 || (1 << idx_bits) != bin_size ||
      n_pad <= 0 || n_pad % bin_size != 0 ||
      (kind != kBf16 && kind != kF16 && kind != kF32))
    return cudaErrorInvalidValue;
  const int n_bins = n_pad / bin_size;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 20:
      return launch_shifted<20>(q, x, out_val, out_idx, B, n_bins, bin_size,
                                idx_bits, kind, s);
    case 36:
      return launch_shifted<36>(q, x, out_val, out_idx, B, n_bins, bin_size,
                                idx_bits, kind, s);
    case 68:
      return launch_shifted<68>(q, x, out_val, out_idx, B, n_bins, bin_size,
                                idx_bits, kind, s);
    case 132:
      return launch_shifted<132>(q, x, out_val, out_idx, B, n_bins, bin_size,
                                 idx_bits, kind, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

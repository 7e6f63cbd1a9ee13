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
//   The l2 operands at d' = 32 are exactly 36 wide; an ip corpus is one
//   column wider than its data (33 at d' = 32), and FusedScanIndex pads it
//   to 36 with zero columns.
//   Bound on an H100 SXM at the serving shape (n_pad = 1,015,808, B =
//   16,384, d_aug = 36 as the TPU kernel computes it, not a padded width):
//   2*B*n_pad*d_aug = 1.198 TFLOP, 1.21 ms at the 989 TFLOP/s bf16 tensor-
//   core peak, against ~0.2 GB of bytes (~0.06 ms): bound by operations.
//   Two routes, chosen by the caller (scan_topk.shifted_cores) and passed
//   in:
//   * Tensor cores (shifted_scan_tc_kernel): bf16 and fp16, any d_aug that
//     is a multiple of 4 up to 264, bins a multiple of 16 rows. mma.sync
//     m16n8k16 over the first 16 * floor(W / 16) columns of W =
//     round_up(d_aug, 8), then one m16n8k8 for the last 8 when W % 16 ==
//     8: 36 runs as 2 x k16 + k8 over 40 columns (+11 % MACs). Exact
//     products, f32 sums in the tensor core's order. The loop is K1's
//     (gbnns::tc_scan_bin, common.cuh): queries in registers as B
//     fragments, a bin's rows through a cp.async ring and ldmatrix, one
//     block per (bin, 512-query tile) with the query tile fastest so the
//     bin comes from L2. Once the
//     product is on the tensor cores the epilogue sets the pace: here the
//     cheapest of the scans, an and-or a score and one three-way integer
//     min (DPX) a row pair, against K1's three instructions a score.
//   * Tensor cores past 264 (shifted_scan_wide_tc_kernel): bf16 and fp16,
//     any d_aug that is a multiple of 8 (the wrapper pads GIST's 964 to
//     968), bins a multiple of 16 rows. The queries no longer fit in registers, so the
//     loop is gbnns::tc_scan_bin_wide (common.cuh, K1's loop at d > 128)
//     with the raw-bits key and no addvec: rows and queries staged in
//     shared memory 128 bytes at a time through a four-stage cp.async
//     ring, 128 rows x 256 queries a block step on wgmma, the selection
//     after each row block's last stage; the last k-step of 32 bytes is
//     zero-filled past the row.
//   * CUDA cores (shifted_scan_kernel): f32 (no TF32, which would change
//     the result) and bins of fewer than 16 rows, at d_aug in {20, 36, 68,
//     132}. A block owns one bin and 128*QPT queries; each thread keeps
//     QPT augmented queries in registers (QPT = 128 / d_aug, at least 1)
//     and a running key per query; corpus rows are staged in 16 KB of
//     shared memory as f32 and read as warp-wide float4 broadcasts, so the
//     inner loop is 4*QPT FMAs per 16-byte shared load. Any other multiple
//     of 4 (f32 at GIST's 968) takes shifted_scan_wide_kernel: one query a
//     thread, 32 rows a step staged 64 columns at a time as f32, the query
//     read 4 columns at a time and the 32 row sums kept in registers across
//     the slabs (the layout of K1's binned_scan_wide_kernel).
//   Query rows past B are not loaded (they hold zeros and write nothing):
//   the Pallas kernel's zero-padded queries meet the padding rows' +inf as
//   0*inf = NaN, which here never reaches a real query's key.

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

// Any d = d_aug that is a multiple of 4 (used off {20, 36, 68, 132}): one
// query per thread. A step stages kWideRows corpus rows kWideCols columns
// at a time as f32 (rows past the bin as zeros); each thread reads its
// query 4 columns at a time and keeps the kWideRows running row sums in
// registers across the slabs, so no score leaves the block. Sums run
// column by column, as in shifted_scan_kernel, and the key is its own.
constexpr int kWideRows = 32;
constexpr int kWideCols = 64;

template <int KIND>
__global__ void __launch_bounds__(kThreads)
shifted_scan_wide_kernel(const void* __restrict__ q_ptr,
                         const void* __restrict__ x_ptr,
                         float* __restrict__ out_val,
                         int* __restrict__ out_idx, int B, int d,
                         int bin_size, int idx_bits) {
  constexpr int kVecs = kWideCols / 4;  // float4 a staged row
  __shared__ __align__(16) float4 xs[kWideRows * kVecs];

  const int bin = blockIdx.x;
  const int tid = threadIdx.x;
  const int qi = blockIdx.y * kThreads + tid;
  const bool live = qi < B;
  const long long row0 = (long long)bin * bin_size;
  const int mask = (1 << idx_bits) - 1;
  const int row_vecs = d / 4;
  // four columns of a row of KIND as f32
  auto vec = [&](const void* p, long long v) -> float4 {
    if constexpr (KIND == kF32)
      return reinterpret_cast<const float4*>(p)[v];
    else
      return half4_to_f32<KIND>(reinterpret_cast<const uint2*>(p)[v]);
  };
  int key = kIntMax;

  for (int t0 = 0; t0 < bin_size; t0 += kWideRows) {
    const int cnt = min(kWideRows, bin_size - t0);
    float acc[kWideRows];
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) acc[r] = 0.f;
    for (int c0 = 0; c0 < row_vecs; c0 += kVecs) {
      const int vecs = min(kVecs, row_vecs - c0);
      __syncthreads();  // the previous slab is consumed
      for (int i = tid; i < kWideRows * vecs; i += kThreads) {
        const int r = i / vecs;
        const int v = i - r * vecs;
        xs[r * kVecs + v] =
            r < cnt ? vec(x_ptr, (row0 + t0 + r) * row_vecs + c0 + v)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
      for (int v = 0; v < vecs; ++v) {
        const float4 qv = live ? vec(q_ptr, (long long)qi * row_vecs + c0 + v)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < kWideRows; ++r) {
          const float4 xv = xs[r * kVecs + v];
          acc[r] = fmaf(xv.x, qv.x, acc[r]);
          acc[r] = fmaf(xv.y, qv.y, acc[r]);
          acc[r] = fmaf(xv.z, qv.z, acc[r]);
          acc[r] = fmaf(xv.w, qv.w, acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) {
      if (r >= cnt) break;
      key = min(key, (__float_as_int(acc[r]) & ~mask) | (t0 + r));
    }
  }

  if (!live) return;
  const long long o = (long long)bin * B + qi;
  out_val[o] = __int_as_float(key & ~mask);
  out_idx[o] = (int)(row0 + (key & mask));
}

// ---- T3 on the tensor cores: bf16 and fp16, any d_aug that is a
// multiple of 4 up to kTcMaxWidth, bins a multiple of 16 rows. The loop is
// K1's, gbnns::tc_scan_bin (common.cuh), with the raw-bits key, no addvec
// and a width known only at run time: W = round_up(d_aug, 8) columns are
// W / 16 k16 steps of query fragments held in registers (KMAX of them at
// most: a bucket) and one k8 step for a last 8 columns, so 36 runs over 40
// columns (11 % more MACs than the data, where padding to 48 would be
// 33 %); a 36-wide bf16 row is 72 bytes, not a multiple of 16, so its
// copies are 8 bytes, into rows whose columns d_aug..W are zero.
constexpr int kTcMaxWidth = 264;  // 16 k16 steps + one k8 tail

template <int KMAX, int KIND>
__global__ void __launch_bounds__(gbnns::kTcThreads, 2)
shifted_scan_tc_kernel(const void* __restrict__ q_ptr,
                       const void* __restrict__ x_ptr,
                       float* __restrict__ out_val, int* __restrict__ out_idx,
                       int B, int d, int bin_size, int idx_bits,
                       int q_tiles) {
  using S = gbnns::TcShape<KMAX>;
  constexpr int kStage = S::kChunk * S::kPitch;
  __shared__ __align__(16) unsigned char xs[2 * kStage];
  const int w = (d + 7) & ~7;
  gbnns::tc_scan_bin<KIND, KMAX, gbnns::kSelRaw, false, 8>(
      xs, kStage, nullptr, q_ptr, x_ptr, nullptr, nullptr, out_val, out_idx,
      B, bin_size, idx_bits, q_tiles, d * 2, w / 16, (w & 15) != 0,
      gbnns::tc_pitch(w * 2));
}

// Past kTcMaxWidth: gbnns::tc_scan_bin_wide with the raw-bits key and no
// addvec; d a multiple of 8 (rows of a multiple of 16 bytes).
template <int KIND>
__global__ void __launch_bounds__(gbnns::kWtThreads, 1)
shifted_scan_wide_tc_kernel(const void* __restrict__ q_ptr,
                            const void* __restrict__ x_ptr,
                            float* __restrict__ out_val,
                            int* __restrict__ out_idx, int B, int d,
                            int bin_size, int idx_bits, int q_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  gbnns::tc_scan_bin_wide<KIND, gbnns::kSelRaw, false, gbnns::kEpiPrescaled>(
      smem, q_ptr, x_ptr, nullptr, nullptr, out_val, out_idx, B, bin_size,
      idx_bits, q_tiles, d * 2, 1.f);
}

template <int KIND>
cudaError_t launch_shifted_wide_tc(const void* q, const void* x,
                                   float* out_val, int* out_idx, int B,
                                   int d, int n_bins, int bin_size,
                                   int idx_bits, cudaStream_t stream) {
  if (d % 8 != 0) return cudaErrorInvalidValue;
  auto kernel = shifted_scan_wide_tc_kernel<KIND>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gbnns::kWtSmem);
  if (err != cudaSuccess) return err;
  const int q_tiles = gbnns::wt_query_tiles(B);
  kernel<<<(unsigned)((long long)n_bins * q_tiles), gbnns::kWtThreads,
           gbnns::kWtSmem, stream>>>(q, x, out_val, out_idx, B, d, bin_size,
                                     idx_bits, q_tiles);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_shifted_tc(const void* q, const void* x, float* out_val,
                              int* out_idx, int B, int d, int n_bins,
                              int bin_size, int idx_bits, int kind,
                              cudaStream_t stream) {
  const int q_tiles = gbnns::tc_query_tiles<KMAX>(B);
  const unsigned grid = (unsigned)((long long)n_bins * q_tiles);
  switch (kind) {
    case kBf16:
      shifted_scan_tc_kernel<KMAX, kBf16>
          <<<grid, gbnns::kTcThreads, 0, stream>>>(
              q, x, out_val, out_idx, B, d, bin_size, idx_bits, q_tiles);
      break;
    case kF16:
      shifted_scan_tc_kernel<KMAX, kF16>
          <<<grid, gbnns::kTcThreads, 0, stream>>>(
              q, x, out_val, out_idx, B, d, bin_size, idx_bits, q_tiles);
      break;
    default:
      return cudaErrorInvalidValue;  // f32 runs on the CUDA cores
  }
  return cudaGetLastError();
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
// both (n_pad / bin_size, B); bin_size a power of two dividing n_pad; d a
// multiple of 4. tensor_cores = 1 takes shifted_scan_tc_kernel (bf16,
// fp16; d up to 264) or past that shifted_scan_wide_tc_kernel (d a
// multiple of 8; bin_size of 16 on both), 0 the CUDA-core kernels (shifted_scan_kernel at d in
// {20, 36, 68, 132}, shifted_scan_wide_kernel at any other d); anything
// else is refused. The caller chooses (scan_topk.shifted_cores). Pointers
// 16-byte aligned.
int gbnns_shifted_scan(const void* q, const void* x, float* out_val,
                       int* out_idx, int B, int n_pad, int d, int bin_size,
                       int kind, int tensor_cores, void* stream) {
  int idx_bits = 0;
  while ((1 << idx_bits) < bin_size) ++idx_bits;
  if (B <= 0 || bin_size <= 0 || (1 << idx_bits) != bin_size ||
      n_pad <= 0 || n_pad % bin_size != 0 || d <= 0 || d % 4 != 0 ||
      (kind != kBf16 && kind != kF16 && kind != kF32))
    return cudaErrorInvalidValue;
  const int n_bins = n_pad / bin_size;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (kind == kF32 || bin_size % gbnns::kTcRowTile != 0)
      return cudaErrorInvalidValue;
    if (d > kTcMaxWidth)
      return kind == kBf16
                 ? launch_shifted_wide_tc<kBf16>(q, x, out_val, out_idx, B,
                                                 d, n_bins, bin_size,
                                                 idx_bits, s)
                 : launch_shifted_wide_tc<kF16>(q, x, out_val, out_idx, B,
                                                d, n_bins, bin_size,
                                                idx_bits, s);
    const int k16 = ((d + 7) & ~7) / 16;
    if (k16 <= 2)
      return launch_shifted_tc<2>(q, x, out_val, out_idx, B, d, n_bins,
                                  bin_size, idx_bits, kind, s);
    if (k16 <= 4)
      return launch_shifted_tc<4>(q, x, out_val, out_idx, B, d, n_bins,
                                  bin_size, idx_bits, kind, s);
    if (k16 <= 8)
      return launch_shifted_tc<8>(q, x, out_val, out_idx, B, d, n_bins,
                                  bin_size, idx_bits, kind, s);
    return launch_shifted_tc<16>(q, x, out_val, out_idx, B, d, n_bins,
                                 bin_size, idx_bits, kind, s);
  }
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
      break;
  }
  const dim3 grid(n_bins, (B + kThreads - 1) / kThreads);
  switch (kind) {
    case kBf16:
      shifted_scan_wide_kernel<kBf16><<<grid, kThreads, 0, s>>>(
          q, x, out_val, out_idx, B, d, bin_size, idx_bits);
      break;
    case kF16:
      shifted_scan_wide_kernel<kF16><<<grid, kThreads, 0, s>>>(
          q, x, out_val, out_idx, B, d, bin_size, idx_bits);
      break;
    default:
      shifted_scan_wide_kernel<kF32><<<grid, kThreads, 0, s>>>(
          q, x, out_val, out_idx, B, d, bin_size, idx_bits);
      break;
  }
  return cudaGetLastError();
}

}  // extern "C"

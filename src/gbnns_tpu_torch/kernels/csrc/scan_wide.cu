// K1 on the tensor cores at d > 128 (T1, scan_topk_pallas.py _scan_kernel,
// reached through binned_scan): bf16, fp16 and int8 at any d that is a
// multiple of 16, bins a multiple of 16 rows, every epilogue of T1 (see
// scan_topk.cu). Compiled apart from scan_topk.cu and scan_epilogue.cu, so
// that nvcc builds the three parts of libscan_topk.so in parallel
// (kernels/_build.py links them), behind gbnns::launch_binned_scan_wide.
// Plain CUDA: no PyTorch header.
//
// Bound on an H100 SXM at the unreduced GIST shape (n_pad = 1,015,808,
// B = 16,384, d = 960): 2*B*n_pad*d = 31.96 TFLOP, 32.3 ms at the 989
// TFLOP/s bf16 tensor-core peak (16.2 ms at 1,979 TOP/s int8), against
// ~2 GB of corpus and queries and 130 MB of winners (~0.7 ms): bound by
// operations. At these widths the selection's cost per score is fixed
// while the product grows with d, so the product sets the pace.
//
// The loop is gbnns::tc_scan_bin_wide (common.cuh): the query fragments
// that K1's d <= 128 kernel holds in registers for the whole bin would take
// 2 * NT * d / 16 registers a lane (120 at d = 960 for one n-tile), so
// both operands are staged in shared memory and each bin runs as a GEMM
// main loop over d on Hopper's warpgroup MMA (wgmma m64n256, two
// warpgroups), 128 rows x 256 queries a block step through a four-stage
// cp.async ring of 128 bytes a row in the 128-byte swizzle (194 KB of
// shared memory, one block of 8 warps an SM; PERF.md §6 has the times
// against an mma.sync form of the same loop). The query tile is sized for
// L2: a block reads its bin's rows once per query tile and its queries
// once per 128 rows, so a scan moves 2*B*n_pad*d*(1/256 + 1/128) bytes
// through L2 (375 GB at the GIST shape, ~3.9 MB a block); with 64-query
// tiles and the queries in registers (tc_scan_bin's shape) the corpus
// alone would move 256 x 1.95 GB = 500 GB. Consecutive blocks share a bin
// (the query tile fastest on the grid), so a bin's rows are read from
// device memory about once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using gbnns::kBf16;
using gbnns::kEpiPrescaled;
using gbnns::kEpiScaled;
using gbnns::kEpiShifted;
using gbnns::kF16;
using gbnns::kInt8;

// EPI is K1's epilogue; PACKED selects on the flipped key (the raw key
// when shifted), else on the (min, lower row) pair. `alpha` is the int8
// scan's alpha or the shifted epilogue's qshift; qscale the unprescaled
// epilogues' factor (1 when prescaled).
template <int KIND, bool PACKED, int EPI>
__global__ void __launch_bounds__(gbnns::kWtThreads, 1)
binned_scan_wide_tc_kernel(const void* __restrict__ q_ptr,
                           const void* __restrict__ x_ptr,
                           const float* __restrict__ addvec,
                           const float* __restrict__ alpha,
                           float* __restrict__ out_val,
                           int* __restrict__ out_idx, int B, int bin_size,
                           int idx_bits, int q_tiles, int row_bytes,
                           float qscale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kSel = !PACKED              ? gbnns::kSelMin
                       : EPI == kEpiShifted ? gbnns::kSelRaw
                                            : gbnns::kSelFlip;
  gbnns::tc_scan_bin_wide<KIND, kSel, true, EPI>(
      smem, q_ptr, x_ptr, addvec, alpha, out_val, out_idx, B, bin_size,
      idx_bits, q_tiles, row_bytes, qscale);
}

template <int KIND, bool PACKED, int EPI>
cudaError_t launch_wide(const void* q, const void* x, const float* addvec,
                        const float* alpha, float* out_val, int* out_idx,
                        int B, int d, int n_bins, int bin_size, int idx_bits,
                        float qscale, cudaStream_t stream) {
  auto kernel = binned_scan_wide_tc_kernel<KIND, PACKED, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gbnns::kWtSmem);
  if (err != cudaSuccess) return err;
  const int q_tiles = gbnns::wt_query_tiles(B);
  const int row_bytes = d * (KIND == kInt8 ? 1 : 2);
  kernel<<<(unsigned)((long long)n_bins * q_tiles), gbnns::kWtThreads,
           gbnns::kWtSmem, stream>>>(q, x, addvec, alpha, out_val, out_idx,
                                     B, bin_size, idx_bits, q_tiles,
                                     row_bytes, qscale);
  return cudaGetLastError();
}

template <int KIND, int EPI>
cudaError_t launch_kind(const void* q, const void* x, const float* addvec,
                        const float* alpha, float* out_val, int* out_idx,
                        int B, int d, int n_bins, int bin_size, int idx_bits,
                        bool packed, float qscale, cudaStream_t s) {
  if (packed)
    return launch_wide<KIND, true, EPI>(q, x, addvec, alpha, out_val,
                                        out_idx, B, d, n_bins, bin_size,
                                        idx_bits, qscale, s);
  return launch_wide<KIND, false, EPI>(q, x, addvec, alpha, out_val, out_idx,
                                       B, d, n_bins, bin_size, idx_bits,
                                       qscale, s);
}

template <int EPI>
cudaError_t launch_epi(const void* q, const void* x, const float* addvec,
                       const float* alpha, float* out_val, int* out_idx,
                       int B, int d, int n_bins, int bin_size, int idx_bits,
                       int kind, bool packed, float qscale, cudaStream_t s) {
  switch (kind) {
    case kBf16:
      return launch_kind<kBf16, EPI>(q, x, addvec, alpha, out_val, out_idx,
                                     B, d, n_bins, bin_size, idx_bits, packed,
                                     qscale, s);
    case kF16:
      return launch_kind<kF16, EPI>(q, x, addvec, alpha, out_val, out_idx, B,
                                    d, n_bins, bin_size, idx_bits, packed,
                                    qscale, s);
    case kInt8:
      if constexpr (EPI == kEpiPrescaled)
        return launch_kind<kInt8, EPI>(q, x, addvec, alpha, out_val, out_idx,
                                       B, d, n_bins, bin_size, idx_bits,
                                       packed, qscale, s);
      return cudaErrorInvalidValue;  // int8 scales by alpha
    default:
      return cudaErrorInvalidValue;  // f32 runs on the CUDA cores
  }
}

}  // namespace

namespace gbnns {

cudaError_t launch_binned_scan_wide(
    int epi, const void* q, const void* x, const float* addvec,
    const float* qs, float* out_val, int* out_idx, int B, int d, int n_bins,
    int bin_size, int idx_bits, int kind, bool packed, float qscale,
    cudaStream_t s) {
  if (d <= 128 || d % 16 != 0 || bin_size % kTcRowTile != 0)
    return cudaErrorInvalidValue;
  switch (epi) {
    case kEpiPrescaled:
      return launch_epi<kEpiPrescaled>(q, x, addvec, qs, out_val, out_idx, B,
                                       d, n_bins, bin_size, idx_bits, kind,
                                       packed, qscale, s);
    case kEpiScaled:
      return launch_epi<kEpiScaled>(q, x, addvec, qs, out_val, out_idx, B, d,
                                    n_bins, bin_size, idx_bits, kind, packed,
                                    qscale, s);
    case kEpiShifted:
      return launch_epi<kEpiShifted>(q, x, addvec, qs, out_val, out_idx, B,
                                     d, n_bins, bin_size, idx_bits, kind,
                                     packed, qscale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace gbnns

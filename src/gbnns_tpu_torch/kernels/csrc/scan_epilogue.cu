// T1's unprescaled and shifted epilogues of K1 (kEpiScaled, kEpiShifted;
// see scan_topk.cu and scan_k1.cuh): their kernels, compiled apart from
// scan_topk.cu so that nvcc builds the two halves of the library in
// parallel (kernels/_build.py links them into libscan_topk.so).

#include "scan_k1.cuh"

namespace gbnns {

cudaError_t launch_binned_scan_epilogue(
    int epi, const void* q, const void* x, const float* addvec,
    const float* qs, float* out_val, int* out_idx, int B, int d, int n_bins,
    int bin_size, int idx_bits, int kind, bool packed, bool tensor_cores,
    float qscale, cudaStream_t s) {
  if (epi == kEpiScaled)
    return launch_binned_scan<kEpiScaled>(
        q, x, addvec, qs, out_val, out_idx, B, d, n_bins, bin_size, idx_bits,
        kind, packed, tensor_cores, qscale, s);
  if (epi == kEpiShifted)
    return launch_binned_scan<kEpiShifted>(
        q, x, addvec, qs, out_val, out_idx, B, d, n_bins, bin_size, idx_bits,
        kind, packed, tensor_cores, qscale, s);
  return cudaErrorInvalidValue;
}

}  // namespace gbnns

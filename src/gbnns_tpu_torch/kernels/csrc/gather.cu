// Hopper (sm_90a) row gather of the graph walker's hop payload, behind a
// plain C interface that gbnns_tpu_torch/kernels/gather.py binds with
// ctypes. The file includes no PyTorch or CUTLASS header, so one nvcc call
// builds it in seconds:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgather.so gather.cu
//
// The launcher takes the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).
//
// K3 row_gather -- replaces gbnns_tpu/kernels/gather_pallas.py
//   _gather_kernel (pallas_call at line 83, reached through dma_row_gather).
//   out[r] = payload[idx[r]] for whole rows of `row_bytes` (a multiple of
//   16): the walker fetches, for every node it expands, one row holding the
//   node's K neighbour vectors and K neighbour ids. The TPU kernel keeps 32
//   row DMAs in flight because each copy is issued by one core; here every
//   warp copies its own row, and the card keeps thousands of rows in flight.
//   Bound on an H100 SXM at the serving shapes (R = 16,384 queries x 4
//   expanded nodes = 65,536 rows of 2,176 B): 142.6 MB read + 142.6 MB
//   written = 0.085 ms at 3.35 TB/s, bytes; there is no arithmetic. Design:
//   one warp per row, each lane moving 16-byte words (uint4) with the
//   read-only cache path, consecutive lanes on consecutive words, so a
//   warp's loads and stores are whole 512-byte segments. An id outside
//   [0, n) reads nothing and writes a zero row (the wrapper rejects such
//   ids before the launch unless its caller guarantees them). Several rows
//   per warp in flight, cp.async or TMA bulk copies are left for a later
//   change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block, one warp each

__global__ void __launch_bounds__(kWarps * 32)
row_gather_kernel(const uint4* __restrict__ src, const int* __restrict__ idx,
                  uint4* __restrict__ dst, int n, int R, int row_vecs) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const int id = __ldg(idx + row);
  uint4* out = dst + (long long)row * row_vecs;
  if (id < 0 || id >= n) {
    for (int i = lane; i < row_vecs; i += 32) out[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* in = src + (long long)id * row_vecs;
  for (int i = lane; i < row_vecs; i += 32) out[i] = __ldg(in + i);
}

}  // namespace

extern "C" {

const char* gbnns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// payload (n, row_bytes) and out (R, row_bytes), 16-byte aligned;
// idx (R,) int32. row_bytes a positive multiple of 16.
int gbnns_row_gather(const void* payload, const int* idx, void* out, int n,
                     int R, int row_bytes, void* stream) {
  if (n <= 0 || R < 0 || row_bytes <= 0 || row_bytes % 16 != 0)
    return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const dim3 grid((R + kWarps - 1) / kWarps);
  row_gather_kernel<<<grid, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(payload), idx, static_cast<uint4*>(out), n,
      R, row_bytes / 16);
  return cudaGetLastError();
}

}  // extern "C"

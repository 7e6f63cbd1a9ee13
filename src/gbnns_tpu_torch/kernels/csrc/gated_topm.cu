// Hopper (sm_90a) kernel of the cluster-gated scan, behind a plain C
// interface that gbnns_tpu_torch/kernels/scan_topk.py binds with ctypes.
// The file includes no PyTorch or CUTLASS header (only common.cuh beside
// it), so one nvcc call builds it in seconds:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgated_topm.so gated_topm.cu
//
// The launcher takes the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).
//
// T4 gated_topm -- replaces gbnns_tpu/kernels/scan_topk_pallas.py
//   _gated_topm_kernel (pallas_call at line 541, reached through
//   gated_topm_scan). A cell is (corpus chunk j, query tile i); the tile
//   mask entry j * b_tiles + i says whether it is scanned. A kept cell
//   gives each query of the tile the m best fine-bin winners of the chunk,
//   a skipped one +inf and -1. For each query the score of a row is
//   addvec[x] + dot(x, q) (x prescaled: -2x for l2, -x for ip), and:
//     level 1: within each `sub`-row block, pkey = (flip(bits) & ~(sub-1))
//              | row_in_block, and each `fine`-row group keeps its min pkey;
//     level 2: key = (pkey_min & ~km) | fine_bin_in_chunk, km = max(sub,
//              chunk/fine) - 1. Keys are unique within a query, so the m
//              extraction rounds of the Pallas kernel are the m smallest
//              keys in ascending order;
//     output:  val = flip(key & ~km) read as f32, id = chunk * j + the
//              winner's row in the chunk; (m * n_chunks, B), row j * m + t.
//   Bound on an H100 SXM: kept_cells * 2 * tq * chunk * d operations (the
//   kept fraction of 2 * B * n_pad * d) at 989 TFLOP/s (bf16 tensor cores),
//   against the bytes at 3.35 TB/s: the chunks some tile keeps, read once
//   (the Pallas cost estimate counts one read per query tile), the queries,
//   and B * m * n_chunks * 8 output bytes. At n = 1M, d = 32, B = 16384 it
//   is bound by operations: ~0.9 ms at a kept fraction of 0.8, against
//   under 0.1 ms of bytes (~0.5 ms even at one chunk read per tile).
//   What the design does about that bound: the Pallas kernel stages every
//   fine-bin key of a cell in a (chunk/fine, tq) int32 scratch (2 x 1 MB
//   at the defaults), which fits a TPU's VMEM and not 227 KB of shared
//   memory. Here a block is (up to 128 queries, one chunk) with one query
//   per thread held in registers as f32; the chunk's rows stream through
//   16 KB of shared memory (widened to f32 as they are staged) and are read
//   as warp-wide broadcasts; each thread keeps its running fine-group min
//   and a sorted list of its best M keys in registers, inserting each
//   finished fine bin by compare-and-swap (skipped unless it beats the
//   list's last key). Scores and keys never reach device memory; a skipped
//   cell costs one mask read and its m output writes. The products run on
//   the CUDA cores in fp32 (exact products of bf16 or fp16 inputs); tensor
//   cores (mma.sync / wgmma) and TMA are left for a later change.
//   Blocks of one chunk are consecutive (queries on grid x), so a chunk is
//   read from device memory about once and from L2 by the other tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;      // queries per block, one per thread
constexpr int kTileBytes = 16384;  // corpus rows staged per step (as f32)

using gbnns::flip_bits;
using gbnns::half8_to_f32;
using gbnns::kBf16;
using gbnns::kF16;
using gbnns::kF32;
using gbnns::kIntMax;

// D in {16, 32, 64, 128}; M (16 or 32) keys kept per query, of which the
// first m are written.
template <int D, int KIND, int M>
__global__ void __launch_bounds__(kThreads)
gated_topm_kernel(const void* __restrict__ q_ptr,
                  const void* __restrict__ x_ptr,
                  const float* __restrict__ addvec,
                  const int* __restrict__ tile_mask,
                  float* __restrict__ out_val, int* __restrict__ out_idx,
                  int B, int chunk, int tq, int b_tiles, int m, int fine_bits,
                  int sub_bits, int km) {
  constexpr int kRows = kTileBytes / (D * 4);
  __shared__ __align__(16) float xs[kRows * D];
  __shared__ float adds[kRows];

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

  float qv[D];
  if (keep) {
    if constexpr (KIND == kF32) {
      const float4* src = reinterpret_cast<const float4*>(
          static_cast<const float*>(q_ptr) + (long long)qi * D);
#pragma unroll
      for (int k = 0; k < D / 4; ++k) {
        const float4 v = src[k];
        qv[4 * k] = v.x; qv[4 * k + 1] = v.y;
        qv[4 * k + 2] = v.z; qv[4 * k + 3] = v.w;
      }
    } else {
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(q_ptr) + (long long)qi * D);
#pragma unroll
      for (int k = 0; k < D / 8; ++k) {
        float f[8];
        half8_to_f32<KIND>(src[k], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) qv[8 * k + e] = f[e];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) qv[k] = 0.f;
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

  for (int t0 = 0; t0 < chunk; t0 += kRows) {
    const int cnt = min(kRows, chunk - t0);
    __syncthreads();  // the previous step's rows are consumed
    if constexpr (KIND == kF32) {
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const float*>(x_ptr) + (col0 + t0) * D);
      uint4* dst = reinterpret_cast<uint4*>(xs);
      for (int i = tid; i < cnt * (D / 4); i += kThreads) dst[i] = src[i];
    } else {  // bf16, fp16: widened to f32 as they are staged
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(x_ptr) + (col0 + t0) * D);
      float4* dst = reinterpret_cast<float4*>(xs);
      for (int i = tid; i < cnt * (D / 8); i += kThreads) {
        float f[8];
        half8_to_f32<KIND>(src[i], f);
        dst[2 * i] = make_float4(f[0], f[1], f[2], f[3]);
        dst[2 * i + 1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
    for (int i = tid; i < cnt; i += kThreads) adds[i] = addvec[col0 + t0 + i];
    __syncthreads();
    if (!keep) continue;

    for (int r = 0; r < cnt; ++r) {
      const float4* xr = reinterpret_cast<const float4*>(xs) + r * (D / 4);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < D / 4; ++k) {
        const float4 xv = xr[k];
        acc = fmaf(xv.x, qv[4 * k], acc);
        acc = fmaf(xv.y, qv[4 * k + 1], acc);
        acc = fmaf(xv.z, qv[4 * k + 2], acc);
        acc = fmaf(xv.w, qv[4 * k + 3], acc);
      }
      const float s = __fadd_rn(adds[r], acc);
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

template <int D, int M>
cudaError_t launch_gated(const void* q, const void* x, const float* addvec,
                         const int* tile_mask, float* out_val, int* out_idx,
                         int B, int n_chunks, int chunk, int tq, int b_tiles,
                         int m, int fine_bits, int sub_bits, int km, int kind,
                         cudaStream_t stream) {
  const dim3 grid((B + kThreads - 1) / kThreads, n_chunks);
#define GBNNS_GATED(KI)                                                     \
  gated_topm_kernel<D, KI, M><<<grid, kThreads, 0, stream>>>(               \
      q, x, addvec, tile_mask, out_val, out_idx, B, chunk, tq, b_tiles, m,  \
      fine_bits, sub_bits, km)
  switch (kind) {
    case kBf16: GBNNS_GATED(kBf16); break;
    case kF32: GBNNS_GATED(kF32); break;
    case kF16: GBNNS_GATED(kF16); break;
    default: return cudaErrorInvalidValue;
  }
#undef GBNNS_GATED
  return cudaGetLastError();
}

int log2_exact(int v) {  // -1 unless v is a power of two
  if (v <= 0 || (v & (v - 1))) return -1;
  int b = 0;
  while ((1 << b) < v) ++b;
  return b;
}

}  // namespace

extern "C" {

const char* gbnns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, d) and x (n_pad, d) of one kind: 0 bf16, 2 f32, 3 fp16 (x
// prescaled); addvec (n_pad,) f32; tile_mask (n_chunks * B / tq,) int32;
// out_val f32 / out_idx int32, both (m * n_chunks, B). d in {16, 32, 64,
// 128}; fine, sub, m powers of two, fine <= sub, chunk % sub == 0,
// n_pad % chunk == 0, B % tq == 0, m <= min(32, chunk / fine). Pointers
// 16-byte aligned.
int gbnns_gated_topm(const void* q, const void* x, const float* addvec,
                     const int* tile_mask, float* out_val, int* out_idx,
                     int B, int n_pad, int d, int chunk, int tq, int fine,
                     int sub, int m, int kind, void* stream) {
  const int fine_bits = log2_exact(fine);
  const int sub_bits = log2_exact(sub);
  if (B <= 0 || tq <= 0 || B % tq != 0 || chunk <= 0 || n_pad <= 0 ||
      n_pad % chunk != 0 || fine_bits < 0 || sub_bits < 0 || sub % fine ||
      chunk % sub || log2_exact(m) < 0 || m > 32 || m > chunk / fine ||
      n_pad / chunk > 65535)
    return cudaErrorInvalidValue;
  const int nfb = chunk / fine;
  const int km = (sub > nfb ? sub : nfb) - 1;
  const int n_chunks = n_pad / chunk;
  const int b_tiles = B / tq;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GBNNS_LAUNCH(DD, MM)                                                \
  launch_gated<DD, MM>(q, x, addvec, tile_mask, out_val, out_idx, B,        \
                       n_chunks, chunk, tq, b_tiles, m, fine_bits, sub_bits, \
                       km, kind, s)
#define GBNNS_WIDTH(DD) \
  return m <= 16 ? GBNNS_LAUNCH(DD, 16) : GBNNS_LAUNCH(DD, 32)
  switch (d) {
    case 16: GBNNS_WIDTH(16);
    case 32: GBNNS_WIDTH(32);
    case 64: GBNNS_WIDTH(64);
    case 128: GBNNS_WIDTH(128);
    default: return cudaErrorInvalidValue;
  }
#undef GBNNS_WIDTH
#undef GBNNS_LAUNCH
}

}  // extern "C"

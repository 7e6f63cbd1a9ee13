// Hopper (sm_90a) kernels of the exact fused kNN, behind a plain C interface
// that gbnns_tpu_torch/kernels/distance_topk.py binds with ctypes. The file
// includes no PyTorch or CUTLASS header, so one nvcc call builds it in
// seconds:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdistance_topk.so distance_topk.cu
//
// The launcher takes the caller's stream and scratch, allocates nothing,
// does not synchronise, and returns cudaGetLastError() (0 on success).
//
// T6 knn_topk -- replaces gbnns_tpu/kernels/distance_topk_pallas.py
//   _knn_kernel (pallas_call at line 142, reached through knn_pallas). For
//   every query, the k smallest of
//     l2:      (qsq - 2 * q.x) + xsq      (that form, each op rounded)
//     ip:      -q.x
//   over the corpus rows [0, n), ascending, ties to the lower row, with
//   fp32 products and sums: it must be EXACT, since its result feeds exact
//   graphs with no re-rank downstream, so it runs fp32 FMAs on the CUDA
//   cores, with no TF32 and no bf16 split. bf16 inputs are widened to f32
//   exactly as they are staged.
//   Bound on an H100 SXM at the graph build's shape (8,192 queries x 1M rows
//   x d = 32): 2*nq*n*d = 0.524 TFLOP at the 67 TFLOP/s fp32 rate, 7.83 ms,
//   against 128 MB of corpus bytes (~0.04 ms): bound by operations.
//   Design: each thread holds one query in registers and keeps its sorted
//   (dist, row) list of the k best in shared memory (thread-strided, so the
//   list of each thread sits in its own bank); corpus tiles of 16 KB stream
//   through shared memory in ascending row order and are read as warp-wide
//   float4 broadcasts, d FMAs per row per thread. A row enters the list
//   only when its distance is strictly below the current k-th, which the
//   thread keeps in a register: the Pallas threshold prune at the grain of
//   one query. Equal distances keep the earlier (lower) row, as the Pallas
//   extraction's first position does. 8,192 queries at 128 a block fill 64
//   blocks, half of the 132 SMs, so the corpus is split across blocks
//   (grid y): each split writes its partial list to scratch, and a second
//   kernel merges the partial lists of each query in (value, split) order,
//   which is (value, row) order since splits are ascending row ranges.
//   Limits: k <= 128 (the lists take k * 8 * 128 bytes of shared memory a
//   block) and d <= 128 (registers); the wrapper pads d to a kernel width
//   (8, 16, 24, 32, 48, 64, 96, 128) with zero columns, which changes no
//   sum. Tensor cores are not used: their fp32 paths are TF32 or a bf16
//   split, neither exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileBytes = 16384;  // corpus rows staged per step, as f32
constexpr int kMaxK = 128;
constexpr int kMaxSplits = 64;
constexpr float kBigF = 3.40282347e+38f;  // FLT_MAX, the Pallas kernel's fill

using gbnns::half4_to_f32;
using gbnns::kBf16;
using gbnns::kF32;

template <int D>
__host__ __device__ constexpr int tile_rows() { return kTileBytes / (D * 4); }

template <int D>
size_t search_smem(int k) {
  return (size_t)tile_rows<D>() * (D + 1) * 4 + (size_t)k * kThreads * 8;
}

// Partial lists: part_d / part_i (nq, splits, k), split s scanning rows
// [s * rows_per_split, min(n, (s + 1) * rows_per_split)).
template <int D, int KIND>
__global__ void __launch_bounds__(kThreads)
knn_split_kernel(const void* __restrict__ q_ptr,
                 const void* __restrict__ x_ptr,
                 const float* __restrict__ qsq, const float* __restrict__ xsq,
                 float* __restrict__ part_d, int* __restrict__ part_i, int nq,
                 int n, int k, int rows_per_split, int l2) {
  constexpr int kVecs = D / 4;
  constexpr int kRows = tile_rows<D>();
  extern __shared__ __align__(16) float4 smem[];
  float4* xs = smem;                                    // kRows * kVecs
  float* xn = reinterpret_cast<float*>(xs + kRows * kVecs);  // kRows norms
  float* best_d = xn + kRows;                           // k * kThreads
  int* best_i = reinterpret_cast<int*>(best_d + k * kThreads);

  const int tid = threadIdx.x;
  const int qi = blockIdx.x * kThreads + tid;
  const int split = blockIdx.y;
  const bool live = qi < nq;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);

  float4 qv[kVecs];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    if (!live) {
      qv[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if constexpr (KIND == kF32) {
      qv[v] = reinterpret_cast<const float4*>(q_ptr)[(long long)qi * kVecs + v];
    } else {
      qv[v] = half4_to_f32<KIND>(
          reinterpret_cast<const uint2*>(q_ptr)[(long long)qi * kVecs + v]);
    }
  }
  const float qs = (live && l2) ? qsq[qi] : 0.f;
  for (int s = 0; s < k; ++s) {
    best_d[s * kThreads + tid] = kBigF;
    best_i[s * kThreads + tid] = -1;
  }
  float worst = kBigF;  // the list's k-th value

  for (int t0 = r_begin; t0 < r_end; t0 += kRows) {
    const int cnt = min(kRows, r_end - t0);
    __syncthreads();  // the previous tile is consumed
    const long long v0 = (long long)t0 * kVecs;
    for (int i = tid; i < cnt * kVecs; i += kThreads) {
      if constexpr (KIND == kF32)
        xs[i] = reinterpret_cast<const float4*>(x_ptr)[v0 + i];
      else
        xs[i] = half4_to_f32<KIND>(reinterpret_cast<const uint2*>(x_ptr)[v0 + i]);
    }
    if (l2)
      for (int i = tid; i < cnt; i += kThreads) xn[i] = xsq[t0 + i];
    __syncthreads();
    if (!live) continue;

    for (int r = 0; r < cnt; ++r) {
      const float4* xr = xs + r * kVecs;
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const float4 xv = xr[v];
        dot = fmaf(xv.x, qv[v].x, dot);
        dot = fmaf(xv.y, qv[v].y, dot);
        dot = fmaf(xv.z, qv[v].z, dot);
        dot = fmaf(xv.w, qv[v].w, dot);
      }
      const float dist =
          l2 ? __fadd_rn(__fsub_rn(qs, __fmul_rn(2.f, dot)), xn[r]) : -dot;
      if (dist < worst) {  // an equal distance belongs to a lower row
        int pos = k - 1;
        while (pos > 0 && best_d[(pos - 1) * kThreads + tid] > dist) {
          best_d[pos * kThreads + tid] = best_d[(pos - 1) * kThreads + tid];
          best_i[pos * kThreads + tid] = best_i[(pos - 1) * kThreads + tid];
          --pos;
        }
        best_d[pos * kThreads + tid] = dist;
        best_i[pos * kThreads + tid] = t0 + r;
        worst = best_d[(k - 1) * kThreads + tid];
      }
    }
  }

  if (!live) return;
  const int splits = gridDim.y;
  const long long o = ((long long)qi * splits + split) * k;
  for (int s = 0; s < k; ++s) {
    part_d[o + s] = best_d[s * kThreads + tid];
    part_i[o + s] = best_i[s * kThreads + tid];
  }
}

// One thread a query: the k smallest of its `splits` sorted partial lists,
// equal values to the lower split.
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, float* __restrict__ out_d,
                 int* __restrict__ out_i, int nq, int k, int splits) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  if (qi >= nq) return;
  const float* pd = part_d + (long long)qi * splits * k;
  const int* pi = part_i + (long long)qi * splits * k;
  int head[kMaxSplits];
  for (int s = 0; s < splits; ++s) head[s] = 0;
  for (int t = 0; t < k; ++t) {
    int bs = -1;
    float bv = 0.f;
    for (int s = 0; s < splits; ++s) {
      if (head[s] >= k) continue;
      const float v = pd[s * k + head[s]];
      if (bs < 0 || v < bv) {
        bs = s;
        bv = v;
      }
    }
    out_d[(long long)qi * k + t] = bv;
    out_i[(long long)qi * k + t] = pi[bs * k + head[bs]];
    ++head[bs];
  }
}

template <int D>
cudaError_t launch_knn(const void* q, const void* x, const float* qsq,
                       const float* xsq, float* part_d, int* part_i,
                       float* out_d, int* out_i, int nq, int n, int k,
                       int splits, int rows_per_split, int l2, int kind,
                       cudaStream_t stream) {
  const size_t smem = search_smem<D>(k);
  const dim3 grid((nq + kThreads - 1) / kThreads, splits);
  cudaError_t err;
  switch (kind) {
    case kF32:
      err = cudaFuncSetAttribute(knn_split_kernel<D, kF32>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
      knn_split_kernel<D, kF32><<<grid, kThreads, smem, stream>>>(
          q, x, qsq, xsq, part_d, part_i, nq, n, k, rows_per_split, l2);
      break;
    case kBf16:
      err = cudaFuncSetAttribute(knn_split_kernel<D, kBf16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
      knn_split_kernel<D, kBf16><<<grid, kThreads, smem, stream>>>(
          q, x, qsq, xsq, part_d, part_i, nq, n, k, rows_per_split, l2);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_merge_kernel<<<(nq + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_d, part_i, out_d, out_i, nq, k, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gbnns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (nq, d) and x (n, d) of one kind: 0 bf16, 2 f32 (the kinds of
// scan_topk.cu); qsq (nq,) and xsq (n,) f32 squared norms (read for l2
// only); scratch part_d f32 / part_i int32 (nq, splits, k); out_d f32 /
// out_i int32 (nq, k). d in {8, 16, 24, 32, 48, 64, 96, 128}; 1 <= k <=
// min(128, n); 1 <= splits <= 64 with splits * rows_per_split >= n.
// Pointers 16-byte aligned.
int gbnns_knn_topk(const void* q, const void* x, const float* qsq,
                   const float* xsq, float* part_d, int* part_i, float* out_d,
                   int* out_i, int nq, int n, int d, int k, int splits,
                   int rows_per_split, int l2, int kind, void* stream) {
  if (nq <= 0 || n <= 0 || k < 1 || k > kMaxK || k > n || splits < 1 ||
      splits > kMaxSplits || rows_per_split < 1 ||
      (long long)splits * rows_per_split < n)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GBNNS_KNN(DD)                                                       \
  launch_knn<DD>(q, x, qsq, xsq, part_d, part_i, out_d, out_i, nq, n, k,    \
                 splits, rows_per_split, l2, kind, s)
  switch (d) {
    case 8: return GBNNS_KNN(8);
    case 16: return GBNNS_KNN(16);
    case 24: return GBNNS_KNN(24);
    case 32: return GBNNS_KNN(32);
    case 48: return GBNNS_KNN(48);
    case 64: return GBNNS_KNN(64);
    case 96: return GBNNS_KNN(96);
    case 128: return GBNNS_KNN(128);
    default: return cudaErrorInvalidValue;
  }
#undef GBNNS_KNN
}

}  // extern "C"

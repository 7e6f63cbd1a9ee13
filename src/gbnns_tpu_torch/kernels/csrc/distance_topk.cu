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
//   exactly by the wrapper.
//   Bound on an H100 SXM at the graph build's shape (8,192 queries x 1M rows
//   x d = 32): 2*nq*n*d = 0.524 TFLOP at the 67 TFLOP/s fp32 rate, 7.83 ms,
//   against 128 MB of corpus bytes (~0.04 ms): bound by operations.
//   Design (the first design ran one query a thread: one dependent chain
//   of d FMAs a row and one shared-memory read a 4 FMAs):
//   * Register tiles. A block owns kQt = 64 queries and streams its corpus
//     split in tiles of kRt = 256 rows. Each of its 128 threads computes
//     a 16 x 8 tile of (query, row) dot products: 128 independent FMA
//     chains, and a column of its 16 queries and 8 rows is six float4
//     shared-memory reads for 128 FMAs (an SM's FP32 lanes do 128 FMAs a
//     clock, its shared memory serves 128 bytes a clock). The wrapper hands
//     the corpus over transposed, (d, n) f32, so each tile arrives
//     column-major by 16-byte cp.async into a two-stage ring; the queries
//     are staged column-major once. A ring stage holds a tile's columns up
//     to d = 32, and 16 of them at wider d (the tile's stages then follow
//     one another, the next one loading while one is summed), so the
//     shared memory of every width and k <= 128 takes this geometry. A
//     warp's 32 lanes share 16 queries (a broadcast) and read 128
//     consecutive rows.
//   * Arithmetic. Each distance is one fmaf chain over columns 0..d-1 from
//     0, then (qsq - 2 * dot) + xsq or -dot, each op rounded: the values of
//     the first design, bit for bit.
//   * Selection, warp by warp: a query's rows of a tile all lie in the
//     lanes of one warp, so no block barrier serves it. Each query keeps
//     its sorted (dist, row) list of the k best in shared memory. A pair
//     strictly below the list's k-th at the tile's start is a candidate
//     (about k * ln(n / k) a query a split, so the FMAs set the pace): it
//     goes to its query's buffer of kCapW slots, and lane j of the warp
//     then inserts the buffered pairs of the warp's query j into its list,
//     all queries at once. A pair that finds its buffer full (mostly on a
//     split's first tiles) is offered to the list by the whole warp
//     (warp_insert). Equal distances go to the lower row: lists compare
//     (dist, row), and a later tile's rows are all higher, so the strict
//     threshold drops nothing that could enter. (Seeding each split's
//     first tile with its exact k-th cost more registers, and time, than
//     the candidates it saved.)
//   * Splits: 8,192 queries fill 128 blocks, and two blocks fit an SM at
//     d = 32 (gbnns_knn_blocks_per_sm gives the count at each d and k), so
//     the corpus is split across blocks (grid y) into as many splits as
//     fill the card once (the wrapper's plan): each split costs each query
//     a first tile and its own k * ln(n / k) candidates. Each split writes
//     its partial list to scratch, and a second kernel merges the partial
//     lists of each query in (value, split) order, which is (value, row)
//     order since splits are ascending row ranges.
//   Limits: k <= 128 (the lists take (k | 1) * 8 * kQt bytes of shared
//   memory a block) and d <= 128; the wrapper pads d to a kernel width (8,
//   16, 24, 32, 48, 64, 96, 128) with zero columns, which changes no sum.
//   Tensor cores are not used: their fp32 paths are TF32 or a bf16 split,
//   neither exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kQt = 64;    // queries a block
constexpr int kThreads = 128;
constexpr int kRt = 256;   // rows a tile: a warp's lanes take 8 of each 256
constexpr int kTq = 16;    // a thread's queries
constexpr int kTr = 8;     // a thread's rows
constexpr int kCapW = 16;  // candidate slots a query a tile
constexpr int kMergeThreads = 128;
constexpr int kMaxK = 128;
constexpr int kMaxSplits = 64;
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic limit
constexpr float kBigF = 3.40282347e+38f;  // FLT_MAX, the Pallas kernel's fill

using gbnns::cp_async16;
using gbnns::cp_async_commit;
using gbnns::cp_async_wait;
using gbnns::smem_addr;

// A ring stage's columns: a whole tile's up to d = 32, else 16.
template <int D>
__host__ __device__ constexpr int stage_cols() { return D <= 32 ? D : 16; }

template <int D>
constexpr size_t search_smem(int k) {
  return (size_t)D * kQt * 4                        // queries, column-major
         + (size_t)2 * stage_cols<D>() * kRt * 4    // the ring, column-major
         + (size_t)2 * kRt * 4                      // two tiles' norms
         + (size_t)kQt * 8                          // query norms, counts
         + (size_t)kCapW * kQt * 8                  // candidate buffers
         + (size_t)(k | 1) * kQt * 8;               // lists
}
static_assert(search_smem<128>(kMaxK) <= kMaxSmem,
              "every width and k take the one geometry");

// (d, r) precedes (e, s) in the lists' (dist, row) order.
__device__ __forceinline__ bool before(float d, int r, float e, int s) {
  return d < e || (d == e && r < s);
}

// Insert (d, r) into the sorted list bd/bi of k (dist, row) pairs, which
// it precedes in (dist, row) order, with the whole warp: each lane compares
// up to four entries, ballots give the position, and the entries behind it
// move up one slot.
__device__ __forceinline__ void warp_insert(float* bd, int* bi, int k,
                                            float d, int r, int lane) {
  float ld[kMaxK / 32];
  int li[kMaxK / 32];
  int pos = 0;
#pragma unroll
  for (int c = 0; c < kMaxK / 32; ++c) {
    const int idx = lane + 32 * c;
    ld[c] = idx < k ? bd[idx] : 0.f;
    li[c] = idx < k ? bi[idx] : 0;
    pos += __popc(__ballot_sync(0xFFFFFFFFu,
                                idx < k && before(ld[c], li[c], d, r)));
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kMaxK / 32; ++c) {
    const int idx = lane + 32 * c;
    if (idx >= pos && idx < k - 1) {
      bd[idx + 1] = ld[c];
      bi[idx + 1] = li[c];
    }
  }
  if (lane == 0) {
    bd[pos] = d;
    bi[pos] = r;
  }
  __syncwarp();
}

// Insert (d, r), which precedes the list's last pair, with one thread.
__device__ __forceinline__ void thread_insert(float* bd, int* bi, int k,
                                              float d, int r) {
  int j = k - 1;
  for (; j > 0; --j) {
    const float pd = bd[j - 1];
    const int pi = bi[j - 1];
    if (!before(d, r, pd, pi)) break;
    bd[j] = pd;
    bi[j] = pi;
  }
  bd[j] = d;
  bi[j] = r;
}

// Partial lists: part_d / part_i (nq, splits, k), split s scanning rows
// [s * rows_per_split, min(n, (s + 1) * rows_per_split)); xt (D, ldx) the
// corpus transposed, ldx a multiple of 4 and rows_per_split of kRt.
template <int D>
__global__ void __launch_bounds__(kThreads)
knn_split_kernel(const float* __restrict__ q, const float* __restrict__ xt,
                 const float* __restrict__ qsq, const float* __restrict__ xsq,
                 float* __restrict__ part_d, int* __restrict__ part_i, int nq,
                 int n, int ldx, int k, int rows_per_split, int l2) {
  constexpr int kDc = stage_cols<D>();
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                       // [D][kQt]
  float* xs = qs + D * kQt;               // [2][kDc][kRt]
  float* xn = xs + 2 * kDc * kRt;         // [2][kRt]
  float* qn = xn + 2 * kRt;               // [kQt] query norms
  int* cnt = reinterpret_cast<int*>(qn + kQt);              // [kQt]
  float* cand_d = reinterpret_cast<float*>(cnt + kQt);      // [kCapW][kQt]
  int* cand_i = reinterpret_cast<int*>(cand_d + kCapW * kQt);
  const int kp = k | 1;  // an odd list stride: the owners' lanes hit
                         // distinct banks
  float* best_d = reinterpret_cast<float*>(cand_i + kCapW * kQt);  // [kQt][kp]
  int* best_i = reinterpret_cast<int*>(best_d + kQt * kp);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rg = lane;
  const int qg = tid / 32;         // queries qg * 16 + b
  const int q0 = blockIdx.x * kQt;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  // a thread's rows: rg * 4 + a and 128 + rg * 4 + a, a < 4
  auto row_of = [&](int g, int a) {
    return (a < 4 ? 0 : 128) + g * 4 + (a & 3);
  };

  for (int i = tid; i < kQt * D; i += kThreads) {
    const int ql = i / D, c = i % D;
    qs[c * kQt + ql] = q0 + ql < nq ? q[(long long)(q0 + ql) * D + c] : 0.f;
  }
  for (int i = tid; i < kQt * kp; i += kThreads) {
    best_d[i] = kBigF;
    best_i[i] = -1;
  }
  for (int ql = tid; ql < kQt; ql += kThreads) {
    qn[ql] = (l2 && q0 + ql < nq) ? qsq[q0 + ql] : 0.f;
    cnt[ql] = 0;
  }

  // columns c0 .. c0 + kDc - 1 of the tile at t0 -> ring stage buf; with
  // its first columns, the tile's norms -> norm slot tb
  auto issue = [&](int t0, int c0, int buf, int tb) {
    const int pieces = (min(kRt, r_end - t0) + 3) / 4;  // of four rows
    float* dst = xs + buf * kDc * kRt;
    for (int i = tid; i < kDc * pieces; i += kThreads) {
      const int c = i / pieces, p = i % pieces;
      cp_async16(smem_addr(dst + c * kRt + 4 * p),
                 xt + (long long)(c0 + c) * ldx + t0 + 4 * p);
    }
    if (l2 && c0 == 0)
      for (int p = tid; p < pieces; p += kThreads)
        cp_async16(smem_addr(xn + tb * kRt + 4 * p), xsq + t0 + 4 * p);
    cp_async_commit();
  };

  if (r_begin < r_end) issue(r_begin, 0, 0, 0);
  cp_async_wait<0>();
  __syncthreads();  // the first stage, the queries and the lists are ready
  int buf = 0, tb = 0;
  for (int t0 = r_begin; t0 < r_end; t0 += kRt, tb ^= 1) {
    float acc[kTq][kTr];
#pragma unroll
    for (int b = 0; b < kTq; ++b)
#pragma unroll
      for (int a = 0; a < kTr; ++a) acc[b][a] = 0.f;
#pragma unroll 1
    for (int c0 = 0; c0 < D; c0 += kDc, buf ^= 1) {
      // the next stage's slot (and, with the tile's last stage, the next
      // tile's norm slot) was consumed before the last barrier
      if (c0 + kDc < D)
        issue(t0, c0 + kDc, buf ^ 1, tb);
      else if (t0 + kRt < r_end)
        issue(t0 + kRt, 0, buf ^ 1, tb ^ 1);
      const float* xc = xs + buf * kDc * kRt;
#pragma unroll 4
      for (int c = 0; c < kDc; ++c) {
        float qv[kTq], xv[kTr];
#pragma unroll
        for (int v = 0; v < kTq / 4; ++v)
          *reinterpret_cast<float4*>(qv + 4 * v) =
              *reinterpret_cast<const float4*>(qs + (c0 + c) * kQt +
                                               qg * kTq + 4 * v);
        *reinterpret_cast<float4*>(xv) =
            *reinterpret_cast<const float4*>(xc + c * kRt + rg * 4);
        *reinterpret_cast<float4*>(xv + 4) =
            *reinterpret_cast<const float4*>(xc + c * kRt + 128 + rg * 4);
#pragma unroll
        for (int b = 0; b < kTq; ++b)
#pragma unroll
          for (int a = 0; a < kTr; ++a)
            acc[b][a] = fmaf(xv[a], qv[b], acc[b][a]);
      }
      if (c0 + kDc < D) {
        cp_async_wait<0>();
        __syncthreads();  // every warp is done with this stage; next arrived
      }
    }

    // selection, warp by warp: a query's 256 rows of the tile lie in the
    // 32 lanes of one warp. First the distances, in place.
    uint32_t valid = 0;
#pragma unroll
    for (int a = 0; a < kTr; ++a) {
      valid |= (t0 + row_of(rg, a) < r_end ? 1u : 0u) << a;
      const float xnv = l2 ? xn[tb * kRt + row_of(rg, a)] : 0.f;
#pragma unroll
      for (int b = 0; b < kTq; ++b)
        acc[b][a] = l2 ? __fadd_rn(__fsub_rn(qn[qg * kTq + b],
                                             __fmul_rn(2.f, acc[b][a])),
                                   xnv)
                       : -acc[b][a];
    }
    // candidates: the pairs strictly below their query's k-th at the
    // tile's start. Each goes to its query's buffer of kCapW slots; a pair
    // that finds it full stays in pm for the warp-serial path below.
    uint32_t pm[kTq / 4] = {};  // bits 8 * (b % 4) + a of pm[b / 4]
    bool held = false;
#pragma unroll
    for (int b = 0; b < kTq; ++b) {
      const int ql = qg * kTq + b;
      const float th = best_d[ql * kp + k - 1];
      uint32_t bits = 0;
#pragma unroll
      for (int a = 0; a < kTr; ++a)
        if (acc[b][a] < th && (valid >> a & 1u)) bits |= 1u << a;
      while (bits) {
        const int a = __ffs(bits) - 1;
        bits &= bits - 1;
        float d = acc[b][0];
#pragma unroll
        for (int u = 1; u < kTr; ++u) d = a == u ? acc[b][u] : d;
        const int slot = atomicAdd(cnt + ql, 1);
        if (slot < kCapW) {
          cand_d[slot * kQt + ql] = d;
          cand_i[slot * kQt + ql] = t0 + row_of(rg, a);
        } else {
          pm[b / 4] |= 1u << (8 * (b % 4) + a);
          held = true;
        }
      }
    }
    __syncwarp();
    // lane w < 16 merges the buffer of the warp's query w
    for (int w = lane; w < kTq; w += 32) {
      const int ql = qg * kTq + w;
      const int m = min(cnt[ql], kCapW);
      if (m == 0) continue;
      float* bd = best_d + ql * kp;
      int* bi = best_i + ql * kp;
      for (int e = 0; e < m; ++e) {
        const float d = cand_d[e * kQt + ql];
        const int r = cand_i[e * kQt + ql];
        if (before(d, r, bd[k - 1], bi[k - 1])) thread_insert(bd, bi, k, d, r);
      }
      cnt[ql] = 0;
    }
    __syncwarp();
    // the pairs that found a buffer full, one by one by the whole warp
    if (__any_sync(0xFFFFFFFFu, held)) {
#pragma unroll 1
      for (int b = 0; b < kTq; ++b) {
        const uint32_t word = b < 4 ? pm[0] : b < 8 ? pm[1] : b < 12 ? pm[2]
                                                                     : pm[3];
        const uint32_t pend = (word >> (8 * (b % 4))) & 0xFFu;
        if (!__any_sync(0xFFFFFFFFu, pend != 0)) continue;
        float dv[kTr];
        switch (b) {
#define GBNNS_ROW(B)                                                  \
  case B:                                                             \
    _Pragma("unroll") for (int a = 0; a < kTr; ++a) dv[a] = acc[B][a]; \
    break;
          GBNNS_ROW(0) GBNNS_ROW(1) GBNNS_ROW(2) GBNNS_ROW(3)
          GBNNS_ROW(4) GBNNS_ROW(5) GBNNS_ROW(6) GBNNS_ROW(7)
          GBNNS_ROW(8) GBNNS_ROW(9) GBNNS_ROW(10) GBNNS_ROW(11)
          GBNNS_ROW(12) GBNNS_ROW(13) GBNNS_ROW(14) GBNNS_ROW(15)
#undef GBNNS_ROW
        }
        uint32_t p = pend;
        unsigned vote = __ballot_sync(0xFFFFFFFFu, p != 0);
        const int ql = qg * kTq + b;
        float* gd = best_d + ql * kp;
        int* gi = best_i + ql * kp;
        while (vote) {
          // each lane's lowest pending pair; the lowest lane's goes first
          const int a = __ffs(p) - 1;
          float mine = dv[0];
#pragma unroll
          for (int u = 1; u < kTr; ++u) mine = a == u ? dv[u] : mine;
          const int src = __ffs(vote) - 1;
          const float d = __shfl_sync(0xFFFFFFFFu, mine, src);
          const int r = t0 + __shfl_sync(0xFFFFFFFFu,
                                         row_of(rg, a < 0 ? 0 : a), src);
          if (lane == src) p &= p - 1;
          if (before(d, r, gd[k - 1], gi[k - 1]))
            warp_insert(gd, gi, k, d, r, lane);
          vote = __ballot_sync(0xFFFFFFFFu, p != 0);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with this tile; the next arrived
  }

  const int splits = gridDim.y;
  for (int i = tid; i < kQt * k; i += kThreads) {
    const int ql = i / k, s = i % k;
    const int qi = q0 + ql;
    if (qi >= nq) break;
    const long long o = ((long long)qi * splits + split) * k + s;
    part_d[o] = best_d[ql * kp + s];
    part_i[o] = best_i[ql * kp + s];
  }
}

// One thread a query: the k smallest of its `splits` sorted partial lists,
// equal values to the lower split.
__global__ void __launch_bounds__(kMergeThreads)
knn_merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, float* __restrict__ out_d,
                 int* __restrict__ out_i, int nq, int k, int splits) {
  const int qi = blockIdx.x * kMergeThreads + threadIdx.x;
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
cudaError_t launch_knn(const float* q, const float* xt, const float* qsq,
                       const float* xsq, float* part_d, int* part_i,
                       float* out_d, int* out_i, int nq, int n, int ldx,
                       int k, int splits, int rows_per_split, int l2,
                       cudaStream_t stream) {
  const size_t smem = search_smem<D>(k);
  cudaError_t err = cudaFuncSetAttribute(
      knn_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + kQt - 1) / kQt, splits);
  knn_split_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, xt, qsq, xsq, part_d, part_i, nq, n, ldx, k, rows_per_split, l2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_merge_kernel<<<(nq + kMergeThreads - 1) / kMergeThreads, kMergeThreads,
                     0, stream>>>(part_d, part_i, out_d, out_i, nq, k, splits);
  return cudaGetLastError();
}

// The split kernel's blocks resident a multiprocessor at this d and k.
template <int D>
cudaError_t blocks_per_sm(int k, int* blocks) {
  const size_t smem = search_smem<D>(k);
  const cudaError_t err = cudaFuncSetAttribute(
      knn_split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, knn_split_kernel<D>, kThreads, smem);
}

}  // namespace

extern "C" {

const char* gbnns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (nq, d) f32 and xt (d, ldx) f32, the corpus of n rows transposed
// (bf16 inputs widened by the caller); qsq (nq,) and xsq (ldx,) f32
// squared norms (read for l2 only); scratch part_d f32 / part_i int32 (nq,
// splits, k); out_d f32 / out_i int32 (nq, k). d in {8, 16, 24, 32, 48,
// 64, 96, 128}; 1 <= k <= min(128, n); ldx >= n a multiple of 4; 1 <=
// splits <= 64 with splits * rows_per_split >= n and rows_per_split a
// multiple of 256 (whole tiles). Pointers 16-byte aligned.
int gbnns_knn_topk(const float* q, const float* xt, const float* qsq,
                   const float* xsq, float* part_d, int* part_i, float* out_d,
                   int* out_i, int nq, int n, int ldx, int d, int k,
                   int splits, int rows_per_split, int l2, void* stream) {
  if (nq <= 0 || n <= 0 || ldx < n || ldx % 4 != 0 || k < 1 || k > kMaxK ||
      k > n || splits < 1 || splits > kMaxSplits || rows_per_split < 1 ||
      rows_per_split % 256 != 0 || (long long)splits * rows_per_split < n)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GBNNS_KNN(DD)                                                       \
  launch_knn<DD>(q, xt, qsq, xsq, part_d, part_i, out_d, out_i, nq, n, ldx, \
                 k, splits, rows_per_split, l2, s)
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

// *blocks: the split kernel's blocks resident a multiprocessor of the
// current device at width d (a kernel width) and 1 <= k <= 128.
int gbnns_knn_blocks_per_sm(int d, int k, int* blocks) {
  if (k < 1 || k > kMaxK) return cudaErrorInvalidValue;
  switch (d) {
    case 8: return blocks_per_sm<8>(k, blocks);
    case 16: return blocks_per_sm<16>(k, blocks);
    case 24: return blocks_per_sm<24>(k, blocks);
    case 32: return blocks_per_sm<32>(k, blocks);
    case 48: return blocks_per_sm<48>(k, blocks);
    case 64: return blocks_per_sm<64>(k, blocks);
    case 96: return blocks_per_sm<96>(k, blocks);
    case 128: return blocks_per_sm<128>(k, blocks);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"

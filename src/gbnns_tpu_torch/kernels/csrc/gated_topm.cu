// Hopper (sm_90a) kernel of the cluster-gated scan, behind a plain C
// interface that gbnns_tpu_torch/kernels/scan_topk.py binds with ctypes.
// The file includes no PyTorch or CUTLASS header (only common.cuh beside
// it), so nvcc builds it in seconds, beside gated_wide.cu (T4 at d > 128),
// and links the two:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler \
//        -fPIC -c gated_topm.cu           (and gated_wide.cu, in parallel)
//   nvcc -shared -o libgated_topm.so gated_topm.o gated_wide.o
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
//   Two routes, chosen by the caller (scan_topk.gated_cores) and passed in.
//   The Pallas kernel stages every fine-bin key of a cell in a (chunk/fine,
//   tq) int32 scratch (2 x 1 MB at the defaults), which fits a TPU's VMEM
//   and not 227 KB of shared memory; both routes keep scores and keys out
//   of device memory, and a skipped cell costs one mask read and its m
//   output writes.
//   * Tensor cores (gated_topm_tc_kernel): bf16 and fp16 at d in {16, 32,
//     64, 128}, fine a multiple of 16 rows, tq a multiple of a warp's
//     8 * NT queries (so no warp straddles two mask tiles). A block is one
//     chunk and TcShape<KS>::kQueries queries (512 at d = 32), the query
//     tile fastest on the grid, so a chunk is read from device memory
//     about once and from L2 by its other tiles. The chunk's rows stream
//     through a two-stage cp.async ring with addvec beside them and reach
//     mma.sync m16n8k16 through ldmatrix as A fragments, 16 rows a
//     product; the queries stay in registers as B fragments; addvec starts
//     the f32 sum as its C operand (D = A.B + addvec: one more term in a
//     sum whose order differs from the plain matmul anyway). Each warp
//     reads the mask entry of its own queries: a skipped warp writes +inf
//     and -1, then only takes part in the staging and the barriers.
//     Level 1 runs on the accumulator fragments in registers: a lane holds
//     rows g and g + 8 for queries 2t and 2t + 1 of each n-tile and folds
//     the pair into its running key with one three-way integer min (DPX);
//     the key is K1's packed one, tc_key<kSelFlip>(s, sub - 1, row & (sub
//     - 1)). A fine group spans fine / 16 row tiles and each lane sees two
//     rows of a tile, so the group min is merged across the 8 lane groups
//     only when the group ends: a reduce-scatter of three xor-shuffle
//     steps leaves group g with n-tile g (14 shuffles a lane, not 48).
//     Level 2: lane (g, t) keeps its two queries' M best level-2 keys and
//     their positions sorted in registers and inserts a group's key with
//     a branch-free shift only when it beats the list's last.
//   * CUDA cores (gated_topm_kernel): f32 (whose tensor-core form TF32
//     would change the result), fine 4 and 8, and a tq that splits a
//     warp. A block is (up to 128 queries, one chunk), one query per
//     thread held in registers as f32; the chunk's rows stream through 16
//     KB of shared memory (widened to f32 as they are staged) and are read
//     as warp-wide broadcasts; each thread keeps its running fine-group
//     min and a sorted list of its best M keys in registers, inserting
//     each finished fine bin by compare-and-swap (skipped unless it beats
//     the list's last key). The products are fp32 FMAs (exact products of
//     bf16 or fp16 inputs). Blocks of one chunk are consecutive (queries
//     on grid x), so a chunk is read from device memory about once. Any d
//     above 128 that is a multiple of 16 (GIST's 960) takes
//     gated_topm_wide_kernel (gated_wide.cu, compiled beside this file
//     and linked into the same library): the query no longer fits in
//     registers, so a
//     step stages 32 rows 64 columns at a time, the thread reads its query
//     16 columns at a time and keeps the 32 row sums in registers across
//     the slabs (the layout of K1's binned_scan_wide_kernel); then the
//     32 rows pass the same two levels in order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace gbnns {

// T4 on the CUDA cores at any d > 128 that is a multiple of 16, from
// gated_wide.cu (compiled apart, in parallel: kernels/_build.py PARTS);
// the arguments are gated_topm_kernel's, with the kind and m to dispatch
// on.
cudaError_t launch_gated_wide(const void* q, const void* x,
                              const float* addvec, const int* tile_mask,
                              float* out_val, int* out_idx, int B, int d,
                              int n_chunks, int chunk, int tq, int b_tiles,
                              int m, int fine_bits, int sub_bits, int km,
                              int kind, cudaStream_t stream);

}  // namespace gbnns

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

// ---- T4 on the tensor cores: bf16 and fp16 at D in {16, 32, 64, 128}
// (KS = D / 16 k-slabs of 32 bytes, no tail), fine a multiple of 16 rows,
// tq a multiple of a warp's 8 * NT queries. Block blockIdx.x: chunk
// blockIdx.x / q_tiles and query tile blockIdx.x % q_tiles. M (16 or 32)
// keys kept per query, of which the first m are written.
template <int KIND, int KS, int M>
__global__ void __launch_bounds__(gbnns::kTcThreads, 1)
gated_topm_tc_kernel(const void* __restrict__ q_ptr,
                     const void* __restrict__ x_ptr,
                     const float* __restrict__ addvec,
                     const int* __restrict__ tile_mask,
                     float* __restrict__ out_val, int* __restrict__ out_idx,
                     int B, int chunk, int tq, int b_tiles, int m,
                     int fine_bits, int sub_bits, int km, int q_tiles) {
  using S = gbnns::TcShape<KS>;
  constexpr int NT = S::NT, CH = S::kChunk, P = S::kPitch;
  constexpr int kRowBytes = KS * 32;
  constexpr int kStage = CH * P;
  constexpr int kWarpQ = 8 * NT;  // a warp's queries
  __shared__ __align__(16) unsigned char xs[2 * kStage];
  __shared__ __align__(16) float adds[2 * CH];

  const int jc = blockIdx.x / q_tiles;  // corpus chunk
  const int qt = blockIdx.x - jc * q_tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qbase = qt * S::kQueries + (tid >> 5) * kWarpQ;
  const long long row0 = (long long)jc * chunk;
  const int sub_mask = (1 << sub_bits) - 1;
  const int fine_mask = (1 << fine_bits) - 1;
  // B and tq are multiples of kWarpQ: a warp's queries are all live or all
  // past B, and share one mask entry
  const bool live = qbase < B;
  const bool keep =
      live && tile_mask[(long long)jc * b_tiles + qbase / tq] > 0;

  if (live && !keep)  // a skipped cell: +inf and -1
    for (int i = lane; i < m * kWarpQ; i += 32) {
      const long long o =
          ((long long)jc * m + i / kWarpQ) * B + qbase + i % kWarpQ;
      out_val[o] = __int_as_float(0x7F800000);
      out_idx[o] = -1;
    }
  if (!__syncthreads_or(keep)) return;  // no warp of the block is kept

  // B fragments: query qbase + 8 nt + g, bytes 4t and 16 + 4t of each slab
  uint32_t qb[NT][KS][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        static_cast<const unsigned char*>(q_ptr) +
        (long long)(qbase + nt * 8 + g) * kRowBytes);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        qb[nt][ks][h] = keep ? qrow[ks * 8 + h * 4 + t] : 0u;
  }

  int arg[NT][2];  // running level-1 key of the fine group
  int key[2][M];   // level 2, ascending; kIntMax is empty
  int pos[2][M];   // the key's row in the chunk
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) arg[nt][0] = arg[nt][1] = kIntMax;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < M; ++e) {
      key[j][e] = kIntMax;
      pos[j][e] = 0;
    }

  // rows [t0, t0 + cnt) of the chunk (and their addvec) into stage buf
  auto stage = [&](int buf, int t0, int cnt) {
    const unsigned char* src = static_cast<const unsigned char*>(x_ptr) +
                               (row0 + t0) * (long long)kRowBytes;
    const uint32_t dst = gbnns::smem_addr(xs + buf * kStage);
    constexpr int kPieces = kRowBytes / 16;
    for (int i = tid; i < cnt * kPieces; i += gbnns::kTcThreads) {
      const int r = i / kPieces;
      gbnns::cp_async16(dst + r * P + (i - r * kPieces) * 16,
                        src + (long long)i * 16);
    }
    const uint32_t adst = gbnns::smem_addr(adds + buf * CH);
    for (int i = tid; i < cnt / 4; i += gbnns::kTcThreads)
      gbnns::cp_async16(adst + 16 * i, addvec + row0 + t0 + 4 * i);
    gbnns::cp_async_commit();
  };

  // ldmatrix lanes: 0-7 rows 0-7, 8-15 rows 8-15 (bytes 0-15 of the
  // slab), 16-31 the same rows at bytes 16-31
  const uint32_t lane_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 16;
  const int n_stages = (chunk + CH - 1) / CH;
  stage(0, 0, min(CH, chunk));
  for (int c = 0; c < n_stages; ++c) {
    const int t0 = c * CH;
    const int cnt = min(CH, chunk - t0);
    if (c + 1 < n_stages) {
      stage((c + 1) & 1, t0 + CH, min(CH, chunk - t0 - CH));
      gbnns::cp_async_wait<1>();
    } else {
      gbnns::cp_async_wait<0>();
    }
    __syncthreads();  // stage c is in shared memory for every warp
    if (keep) {
      const uint32_t base =
          gbnns::smem_addr(xs + (c & 1) * kStage) + lane_off;
      const float* ad = adds + (c & 1) * CH;
#pragma unroll 2
      for (int mt = 0; mt < cnt / gbnns::kTcRowTile; ++mt) {
        const uint32_t tile = base + mt * gbnns::kTcRowTile * P;
        uint32_t a[KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          gbnns::ldmatrix_x4(a[ks], tile + ks * 32);
        const int r0 = t0 + mt * gbnns::kTcRowTile;  // the tile's first row
        const int rl = (r0 + g) & sub_mask;  // rows of c0-c1; c2-c3 + 8
        const float a_lo = ad[mt * gbnns::kTcRowTile + g];
        const float a_hi = ad[mt * gbnns::kTcRowTile + g + 8];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float s[4] = {a_lo, a_lo, a_hi, a_hi};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            gbnns::mma_k16<KIND>(s, a[ks], qb[nt][ks][0], qb[nt][ks][1], s);
#pragma unroll
          for (int j = 0; j < 2; ++j)  // one three-way min (DPX) a row pair
            arg[nt][j] = __vimin3_s32(
                arg[nt][j], gbnns::tc_key<gbnns::kSelFlip>(s[j], sub_mask, rl),
                gbnns::tc_key<gbnns::kSelFlip>(s[j + 2], sub_mask, rl + 8));
        }
        if (((r0 + gbnns::kTcRowTile) & fine_mask) == 0) {
          // the fine group ends with this tile. Reduce-scatter its min over
          // the 8 lane groups: at step h the lanes whose group has bit h
          // keep n-tiles [h, 2h) of the 2h they hold and send [0, h), the
          // others the reverse; after log2(NT) steps group g holds n-tile
          // g % NT, and the groups that share it (NT < 8) then merge.
#pragma unroll
          for (int h = NT / 2; h >= 1; h >>= 1) {
            const bool hi = (g & h) != 0;
#pragma unroll
            for (int i = 0; i < h; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int send = hi ? arg[i][j] : arg[i + h][j];
                const int mine = hi ? arg[i + h][j] : arg[i][j];
                arg[i][j] =
                    min(mine, __shfl_xor_sync(0xFFFFFFFFu, send, 4 * h));
              }
          }
#pragma unroll
          for (int off = 4 * NT; off < 32; off <<= 1)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              arg[0][j] = min(arg[0][j],
                              __shfl_xor_sync(0xFFFFFFFFu, arg[0][j], off));
          // level 2: the group's key enters the sorted list if it beats
          // the list's last (the larger keys shift up by one, branch-free)
          const int fb = r0 >> fine_bits;  // the fine bin in the chunk
          const int pbase = (fb << fine_bits) & ~sub_mask;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kmin = arg[0][j];
            const int k2 = (kmin & ~km) | fb;
            if (k2 < key[j][M - 1]) {
              const int p = pbase | (kmin & sub_mask);
#pragma unroll
              for (int e = M - 1; e > 0; --e) {
                const bool up = k2 < key[j][e - 1];
                const bool here = k2 < key[j][e];
                key[j][e] = up ? key[j][e - 1] : min(k2, key[j][e]);
                pos[j][e] = up ? pos[j][e - 1] : (here ? p : pos[j][e]);
              }
              if (k2 < key[j][0]) {
                key[j][0] = k2;
                pos[j][0] = p;
              }
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) arg[nt][0] = arg[nt][1] = kIntMax;
        }
      }
    }
    __syncthreads();  // stage c is consumed before it is refilled
  }

  if (!keep || g >= NT) return;  // group g writes n-tile g
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = qbase + g * 8 + 2 * t + j;
#pragma unroll
    for (int e = 0; e < M; ++e) {
      if (e >= m) break;
      const long long o = ((long long)jc * m + e) * B + qi;
      out_val[o] = __int_as_float(flip_bits(key[j][e] & ~km));
      out_idx[o] = (int)(row0 + pos[j][e]);
    }
  }
}

template <int D, int M>
cudaError_t launch_gated_tc(const void* q, const void* x, const float* addvec,
                            const int* tile_mask, float* out_val,
                            int* out_idx, int B, int n_chunks, int chunk,
                            int tq, int b_tiles, int m, int fine_bits,
                            int sub_bits, int km, int kind,
                            cudaStream_t stream) {
  using S = gbnns::TcShape<D / 16>;  // tq: a multiple of 8 * S::NT
  if ((1 << fine_bits) % gbnns::kTcRowTile || tq % (8 * S::NT))
    return cudaErrorInvalidValue;
  const int q_tiles = (B + S::kQueries - 1) / S::kQueries;
  if ((long long)n_chunks * q_tiles > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)n_chunks * q_tiles;
#define GBNNS_GATED_TC(KI)                                                  \
  gated_topm_tc_kernel<KI, D / 16, M><<<grid, gbnns::kTcThreads, 0,         \
                                        stream>>>(                          \
      q, x, addvec, tile_mask, out_val, out_idx, B, chunk, tq, b_tiles, m,  \
      fine_bits, sub_bits, km, q_tiles)
  switch (kind) {
    case kBf16: GBNNS_GATED_TC(kBf16); break;
    case kF16: GBNNS_GATED_TC(kF16); break;
    default: return cudaErrorInvalidValue;  // f32 runs on the CUDA cores
  }
#undef GBNNS_GATED_TC
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

// A warp's queries on the tensor-core route at width d (8 * TcShape::NT),
// the tq step that scan_topk.gated_cores asks for; -1 for no kernel width.
int gbnns_gated_warp_queries(int d) {
  switch (d) {
    case 16: return 8 * gbnns::TcShape<1>::NT;
    case 32: return 8 * gbnns::TcShape<2>::NT;
    case 64: return 8 * gbnns::TcShape<4>::NT;
    case 128: return 8 * gbnns::TcShape<8>::NT;
    default: return -1;
  }
}

// q (B, d) and x (n_pad, d) of one kind: 0 bf16, 2 f32, 3 fp16 (x
// prescaled); addvec (n_pad,) f32; tile_mask (n_chunks * B / tq,) int32;
// out_val f32 / out_idx int32, both (m * n_chunks, B). d in {16, 32, 64,
// 128} or, on the CUDA cores only, any larger multiple of 16; fine, sub, m
// powers of two, fine <= sub, chunk % sub == 0,
// n_pad % chunk == 0, B % tq == 0, m <= min(32, chunk / fine). Pointers
// 16-byte aligned. tensor_cores (scan_topk.gated_cores) selects
// gated_topm_tc_kernel: bf16 or fp16, fine % 16 == 0 and tq a multiple of
// a warp's queries (64 at d <= 32, 32 at d = 64, 16 at d = 128).
int gbnns_gated_topm(const void* q, const void* x, const float* addvec,
                     const int* tile_mask, float* out_val, int* out_idx,
                     int B, int n_pad, int d, int chunk, int tq, int fine,
                     int sub, int m, int kind, int tensor_cores,
                     void* stream) {
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
#define GBNNS_LAUNCH(DD, MM)                                                 \
  (tensor_cores ? launch_gated_tc<DD, MM>(q, x, addvec, tile_mask, out_val,  \
                                          out_idx, B, n_chunks, chunk, tq,   \
                                          b_tiles, m, fine_bits, sub_bits,   \
                                          km, kind, s)                       \
                : launch_gated<DD, MM>(q, x, addvec, tile_mask, out_val,     \
                                       out_idx, B, n_chunks, chunk, tq,      \
                                       b_tiles, m, fine_bits, sub_bits, km,  \
                                       kind, s))
#define GBNNS_WIDTH(DD) \
  return m <= 16 ? GBNNS_LAUNCH(DD, 16) : GBNNS_LAUNCH(DD, 32)
  switch (d) {
    case 16: GBNNS_WIDTH(16);
    case 32: GBNNS_WIDTH(32);
    case 64: GBNNS_WIDTH(64);
    case 128: GBNNS_WIDTH(128);
    default:
      if (tensor_cores || d <= 128 || d % 16 != 0)
        return cudaErrorInvalidValue;
      return gbnns::launch_gated_wide(q, x, addvec, tile_mask, out_val,
                                      out_idx, B, d, n_chunks, chunk, tq,
                                      b_tiles, m, fine_bits, sub_bits, km,
                                      kind, s);
  }
#undef GBNNS_WIDTH
#undef GBNNS_LAUNCH
}

}  // extern "C"

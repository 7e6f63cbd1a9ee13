// Hopper (sm_90a) kernels of the fused-scan serving path, behind a plain C
// interface that gbnns_tpu_torch/kernels/scan_topk.py binds with ctypes.
// The file includes no PyTorch or CUTLASS header, so one nvcc call builds it
// in seconds:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libscan_topk.so scan_topk.cu
//
// Every launcher takes the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).
//
// K1 binned_scan -- replaces gbnns_tpu/kernels/scan_topk_pallas.py
//   _scan_kernel (pallas_call at line 342, reached through binned_scan).
//   For every corpus bin of `bin_size` rows and every query it writes the
//   bin's min reduced-dimension score and the row that attains it (ties to
//   the lower row), bin-major: vals/ids (n_bins, B). Scores are
//     bf16, fp16, f32: addvec[x] + dot(x, q)  x stored prescaled (-2x or -x)
//     int8:       addvec[x] + float(dot_i32(x, q)) * alpha[q]
//   PACKED reproduces the Pallas packed mode: the score's IEEE bits are
//   flipped into signed-int order, the low log2(bin_size) bits replaced by
//   the in-bin row, and one integer min gives value and row together.
//   Bound on an H100 SXM at the serving shapes (n = 1M, B = 16384, d = 32):
//   2*B*n*d = 1.07 TFLOP, 1.1 ms at the 989 TFLOP/s bf16 tensor-core peak
//   (0.55 ms at 1,979 TOP/s int8), against ~0.06 ms for the bytes (64 MB of
//   corpus, 128 MB of winners), so it is bound by operations. Two routes,
//   chosen by the caller (scan_topk.scan_cores) and passed in:
//   * Tensor cores (binned_scan_tc_kernel): bf16, fp16 and int8 at d in
//     {16, 32, 64, 128}, bins a multiple of 16 rows. mma.sync m16n8k16
//     (bf16/fp16 -> f32: exact products, f32 sums in the tensor core's
//     order) or m16n8k32 (s8 -> s32, exact). A = 16 corpus rows (ldmatrix
//     from shared memory, rows padded to an odd multiple of 16 bytes so the
//     reads are free of bank conflicts), B = 8 queries held in registers
//     for the whole bin (the loop is gbnns::tc_scan_bin in common.cuh,
//     shared with T3). The fragment layout tells each lane which (row,
//     query) scores it holds, so the selection runs on them in registers:
//     once the product is on the tensor cores, this epilogue sets the pace
//     (B * n_pad = 1.66e10 scores: unpacked 3 instructions a score, a
//     compare and two selects, addvec riding in the mma's C operand;
//     packed a flip and a mask-or a score and one three-way integer min
//     (DPX) a row pair; int8 adds the exact convert, mul and add). The
//     compiled loop is ~140 warp instructions per 1,024 scores of which 16
//     are mma: the selection, not the product, keeps the kernel above its
//     1.1 ms bound (PERF.md §6 has the times).
//     Grid: one block per (bin, 512-query tile), the query tile fastest,
//     so the blocks in flight read a few bins and those come from L2 (each
//     bin's 64 KB is read from device memory about once); a block streams
//     its bin through a two-stage cp.async ring. The alternative, a block
//     staging a whole bin once and looping over query tiles, needs 80 KB of
//     shared memory a block and leaves a tail of ~1,000 long blocks on 132
//     SMs; the L2 order gets the same reuse with small blocks.
//   * CUDA cores (binned_scan_kernel, binned_scan_wide_kernel): f32 (no
//     TF32, which would change the result; bound 2*B*n*d at the 67 TFLOP/s
//     fp32 rate), every kind at d > 128, and bins that are not a multiple
//     of 16 rows. A block owns one bin and 128*QPT queries; each thread
//     keeps QPT queries in registers and a running (min, argmin) per query,
//     corpus rows are staged in 16 KB of shared memory (bf16 and fp16
//     widened to f32 exactly) and read as warp-wide broadcasts: fp32 FMAs,
//     or exact int32 dp4a for int8. d in {16, 32, 64, 128} holds 128 / d
//     queries per thread in registers (binned_scan_kernel). Any wider d, a
//     multiple of 16, takes binned_scan_wide_kernel: one query per thread,
//     32 corpus rows per step staged 64 columns at a time, the query read
//     16 columns at a time into registers and the 32 row sums kept in
//     registers across the slabs.
//
// K2 merge_topc -- replaces scan_topk_pallas.py _merge_topc_kernel
//   (pallas_call at line 600, reached through _merge_topc_stage and
//   merge_topc). The Pallas merge runs stages: each block of `rb` rows of
//   the bin-major winners keeps, per query, its ck smallest keys, where a
//   key is the flipped IEEE score with its low log2(rb) bits replaced by the
//   in-block row, until one block is left. Its result is the top ck of all
//   R rows in (quantized key, row) order, the quantized key being
//   flip(v) & ~(rb - 1): a stage's block holds its rows in ascending
//   order, and a later stage's in-block row keeps that order. This kernel
//   computes that order in one launch. Rows past R never enter; a slot left
//   empty (R < ck) gives +inf and id -1, as the Pallas padding rows do.
//   Bound: the values once (R * B * 4 bytes), the winners' ids (B * c
//   sectors of 32 bytes) and the output (B * c * 8): ~72 MB at the serving
//   shapes (R = 992, B = 16384, c = 12), ~0.022 ms at 3.35 TB/s: bytes.
//   Design (the staged kernel it replaces ran one launch a stage, staged 8
//   queries x rb rows a block, and selected with ck rounds of a warp min):
//   * A thread owns one query, so a warp reads 128 contiguous bytes of a
//     row, and loads the next kMergeUnroll rows while it offers the
//     current ones.
//   * The rows are split across a thread-block cluster of blocks of 128
//     queries, about kMergeSplitRows rows a block (two at the serving and
//     build shapes, R = 992), so that 128 or 64 query blocks become 256 or
//     128 blocks; more splits measured slower (each adds a merge input).
//   * Each thread keeps its split's smallest words: a word is the
//     quantized key with the row below it in the cleared low bits (the row
//     within the split, which the host keeps below rb - 1, so 32 bits; 64
//     bits with the global row where it cannot). Lists of 16 or 48 words
//     live in registers and take a word by one branch-free min/max pass,
//     skipped when no lane of the warp has a word below its list's last;
//     longer lists (ck > 48) live thread-strided in shared memory. Rows
//     arrive in ascending order, so an equal key keeps the earlier row.
//   * Block 0 of each cluster merges the splits' lists through distributed
//     shared memory by (key, global row), a step ahead on each list, and
//     gathers the winners' ids eight at a time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kScanThreads = 128;
constexpr int kTileBytes = 16384;  // corpus rows staged per step
constexpr int kWideRows = 32;      // wide scan: corpus rows per step
constexpr int kWideCols = 64;      // wide scan: columns per staged slab

// K2: queries (threads) a block, splits (blocks) a cluster at most, rows a
// load batch, rows a split, shared memory for lists kept there, the empty
// wide word
constexpr int kMergeThreads = 128;
constexpr int kMergeMaxSplits = 8;
constexpr int kMergeUnroll = 8;
constexpr int kMergeSplitRows = 512;
constexpr size_t kMergeSmem = 96 * 1024;
constexpr long long kMergeEmpty = 0x7FFFFFFFFFFFFFFFLL;

using gbnns::flip_bits;
using gbnns::half8_to_f32;
using gbnns::kBf16;
using gbnns::kF16;
using gbnns::kF32;
using gbnns::kInt8;
using gbnns::kIntMax;

// D in {16, 32, 64, 128}; QPT queries per thread keeps D * QPT = 128
// registers of query data.
template <int D, int KIND, bool PACKED>
__global__ void __launch_bounds__(kScanThreads)
binned_scan_kernel(const void* __restrict__ q_ptr,
                   const void* __restrict__ x_ptr,
                   const float* __restrict__ addvec,
                   const float* __restrict__ alpha,
                   float* __restrict__ out_val, int* __restrict__ out_idx,
                   int B, int bin_size, int idx_bits) {
  constexpr bool QUANT = KIND == kInt8;
  constexpr int QPT = 128 / D;
  constexpr int kElem = QUANT ? 1 : 4;  // staged bytes per element
  constexpr int kRows = kTileBytes / (D * kElem);
  constexpr int kQWords = QUANT ? D / 4 : D;
  __shared__ __align__(16) uint32_t xs[kTileBytes / 4];
  __shared__ float adds[kRows];

  const int bin = blockIdx.x;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * (kScanThreads * QPT) + tid;
  const long long row0 = (long long)bin * bin_size;
  const int mask = (1 << idx_bits) - 1;

  // queries: QUANT holds D/4 packed int8x4 words, else D floats
  uint32_t qw[QPT][kQWords];
  float al[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qi = q0 + j * kScanThreads;
    al[j] = 0.f;
    if (qi < B) {
      if constexpr (QUANT) {
        const uint4* src =
            reinterpret_cast<const uint4*>(static_cast<const int8_t*>(q_ptr) +
                                           (long long)qi * D);
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          uint4 v = src[k];
          qw[j][4 * k] = v.x; qw[j][4 * k + 1] = v.y;
          qw[j][4 * k + 2] = v.z; qw[j][4 * k + 3] = v.w;
        }
        al[j] = alpha[qi];
      } else if constexpr (KIND == kF32) {
        const uint4* src = reinterpret_cast<const uint4*>(
            static_cast<const float*>(q_ptr) + (long long)qi * D);
#pragma unroll
        for (int k = 0; k < D / 4; ++k) {
          uint4 v = src[k];
          qw[j][4 * k] = v.x; qw[j][4 * k + 1] = v.y;
          qw[j][4 * k + 2] = v.z; qw[j][4 * k + 3] = v.w;
        }
      } else {  // bf16, fp16
        const uint4* src = reinterpret_cast<const uint4*>(
            static_cast<const uint16_t*>(q_ptr) + (long long)qi * D);
#pragma unroll
        for (int k = 0; k < D / 8; ++k) {
          float f[8];
          half8_to_f32<KIND>(src[k], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) qw[j][8 * k + e] = __float_as_uint(f[e]);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kQWords; ++k) qw[j][k] = 0u;
    }
  }

  float best[QPT];
  int arg[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    best[j] = __int_as_float(0x7F800000);  // +inf
    arg[j] = PACKED ? kIntMax : 0;         // PACKED: running key
  }

  for (int t0 = 0; t0 < bin_size; t0 += kRows) {
    const int cnt = min(kRows, bin_size - t0);
    __syncthreads();  // the previous step's rows are consumed
    if constexpr (QUANT) {
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const int8_t*>(x_ptr) + (row0 + t0) * D);
      uint4* dst = reinterpret_cast<uint4*>(xs);
      for (int i = tid; i < cnt * (D / 16); i += kScanThreads) dst[i] = src[i];
    } else if constexpr (KIND == kF32) {
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const float*>(x_ptr) + (row0 + t0) * D);
      uint4* dst = reinterpret_cast<uint4*>(xs);
      for (int i = tid; i < cnt * (D / 4); i += kScanThreads) dst[i] = src[i];
    } else {  // bf16, fp16: widened to f32 as they are staged
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(x_ptr) + (row0 + t0) * D);
      float4* dst = reinterpret_cast<float4*>(xs);
      for (int i = tid; i < cnt * (D / 8); i += kScanThreads) {
        float f[8];
        half8_to_f32<KIND>(src[i], f);
        dst[2 * i] = make_float4(f[0], f[1], f[2], f[3]);
        dst[2 * i + 1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
    for (int i = tid; i < cnt; i += kScanThreads) adds[i] = addvec[row0 + t0 + i];
    __syncthreads();

    for (int r = 0; r < cnt; ++r) {
      float s[QPT];
      if constexpr (QUANT) {
        const int4* xr = reinterpret_cast<const int4*>(xs) + r * (D / 16);
        int acc[QPT];
#pragma unroll
        for (int j = 0; j < QPT; ++j) acc[j] = 0;
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          const int4 xv = xr[k];
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            acc[j] = __dp4a(xv.x, (int)qw[j][4 * k], acc[j]);
            acc[j] = __dp4a(xv.y, (int)qw[j][4 * k + 1], acc[j]);
            acc[j] = __dp4a(xv.z, (int)qw[j][4 * k + 2], acc[j]);
            acc[j] = __dp4a(xv.w, (int)qw[j][4 * k + 3], acc[j]);
          }
        }
        const float a = adds[r];
#pragma unroll
        for (int j = 0; j < QPT; ++j)  // mul then add, each rounded: no FMA
          s[j] = __fadd_rn(a, __fmul_rn(__int2float_rn(acc[j]), al[j]));
      } else {
        const float4* xr = reinterpret_cast<const float4*>(xs) + r * (D / 4);
        float acc[QPT];
#pragma unroll
        for (int j = 0; j < QPT; ++j) acc[j] = 0.f;
#pragma unroll
        for (int k = 0; k < D / 4; ++k) {
          const float4 xv = xr[k];
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            acc[j] = fmaf(xv.x, __uint_as_float(qw[j][4 * k]), acc[j]);
            acc[j] = fmaf(xv.y, __uint_as_float(qw[j][4 * k + 1]), acc[j]);
            acc[j] = fmaf(xv.z, __uint_as_float(qw[j][4 * k + 2]), acc[j]);
            acc[j] = fmaf(xv.w, __uint_as_float(qw[j][4 * k + 3]), acc[j]);
          }
        }
        const float a = adds[r];
#pragma unroll
        for (int j = 0; j < QPT; ++j) s[j] = __fadd_rn(a, acc[j]);
      }
      const int row = t0 + r;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        if constexpr (PACKED) {
          const int key = (flip_bits(__float_as_int(s[j])) & ~mask) | row;
          arg[j] = min(arg[j], key);
        } else if (s[j] < best[j]) {
          best[j] = s[j];
          arg[j] = row;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qi = q0 + j * kScanThreads;
    if (qi >= B) continue;
    const long long o = (long long)bin * B + qi;
    if constexpr (PACKED) {
      out_val[o] = __int_as_float(flip_bits(arg[j] & ~mask));
      out_idx[o] = (int)(row0 + (arg[j] & mask));
    } else {
      out_val[o] = best[j];
      out_idx[o] = (int)(row0 + arg[j]);
    }
  }
}

// Any d that is a multiple of 16 (used for d > 128): one query per thread.
// A step stages kWideRows corpus rows kWideCols columns at a time; each
// thread reads its query 16 columns at a time into registers and keeps the
// kWideRows running row sums in registers across the slabs, so no score
// leaves the block. Sums run column by column, as in binned_scan_kernel.
template <int KIND, bool PACKED>
__global__ void __launch_bounds__(kScanThreads)
binned_scan_wide_kernel(const void* __restrict__ q_ptr,
                        const void* __restrict__ x_ptr,
                        const float* __restrict__ addvec,
                        const float* __restrict__ alpha,
                        float* __restrict__ out_val, int* __restrict__ out_idx,
                        int B, int d, int bin_size, int idx_bits) {
  constexpr bool QUANT = KIND == kInt8;
  using Acc = typename std::conditional<QUANT, int, float>::type;
  // slab row: kWideCols f32 (bf16, f32) or kWideCols int8 (16 per int4)
  constexpr int kRowWords = QUANT ? kWideCols / 4 : kWideCols;
  __shared__ __align__(16) uint32_t xs[kWideRows * kRowWords];
  __shared__ float adds[kWideRows];

  const int bin = blockIdx.x;
  const int tid = threadIdx.x;
  const int qi = blockIdx.y * kScanThreads + tid;
  const bool live = qi < B;
  const long long row0 = (long long)bin * bin_size;
  const int mask = (1 << idx_bits) - 1;
  const float al = (QUANT && live) ? alpha[qi] : 0.f;
  float best = __int_as_float(0x7F800000);  // +inf
  int arg = PACKED ? kIntMax : 0;           // PACKED: running key

  for (int t0 = 0; t0 < bin_size; t0 += kWideRows) {
    const int cnt = min(kWideRows, bin_size - t0);
    Acc acc[kWideRows];
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) acc[r] = 0;
    for (int c0 = 0; c0 < d; c0 += kWideCols) {
      const int groups = min(kWideCols, d - c0) / 16;  // 16-column groups
      __syncthreads();  // the previous slab is consumed
      // stage rows [t0, t0 + cnt) x columns [c0, c0 + 16 * groups); rows
      // past cnt are zero
      for (int i = tid; i < kWideRows * groups; i += kScanThreads) {
        const int r = i / groups;
        const int g = i % groups;
        const long long e = (row0 + t0 + r) * d + c0 + 16 * g;  // element
        if constexpr (QUANT) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (r < cnt)
            v = *reinterpret_cast<const uint4*>(
                static_cast<const int8_t*>(x_ptr) + e);
          reinterpret_cast<uint4*>(xs)[r * (kRowWords / 4) + g] = v;
        } else {
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
          float4* dst = reinterpret_cast<float4*>(xs) + r * (kRowWords / 4)
                        + 4 * g;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            dst[k] = make_float4(f[4 * k], f[4 * k + 1], f[4 * k + 2],
                                 f[4 * k + 3]);
        }
      }
      if (c0 == 0)
        for (int i = tid; i < cnt; i += kScanThreads)
          adds[i] = addvec[row0 + t0 + i];
      __syncthreads();

      for (int g = 0; g < groups; ++g) {
        const long long qe = (long long)qi * d + c0 + 16 * g;  // element
        if constexpr (QUANT) {
          int4 qv = make_int4(0, 0, 0, 0);
          if (live)
            qv = *reinterpret_cast<const int4*>(
                static_cast<const int8_t*>(q_ptr) + qe);
#pragma unroll
          for (int r = 0; r < kWideRows; ++r) {
            const int4 xv = reinterpret_cast<const int4*>(xs)[
                r * (kRowWords / 4) + g];
            acc[r] = __dp4a(xv.x, qv.x, acc[r]);
            acc[r] = __dp4a(xv.y, qv.y, acc[r]);
            acc[r] = __dp4a(xv.z, qv.z, acc[r]);
            acc[r] = __dp4a(xv.w, qv.w, acc[r]);
          }
        } else {
          float qv[16];
          if (!live) {
#pragma unroll
            for (int k = 0; k < 16; ++k) qv[k] = 0.f;
          } else if constexpr (KIND == kF32) {
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
                               + r * (kRowWords / 4) + 4 * g;
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
    }
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) {
      if (r >= cnt) break;
      float s;
      if constexpr (QUANT)  // mul then add, each rounded: no FMA
        s = __fadd_rn(adds[r], __fmul_rn(__int2float_rn(acc[r]), al));
      else
        s = __fadd_rn(adds[r], acc[r]);
      const int row = t0 + r;
      if constexpr (PACKED) {
        arg = min(arg, (flip_bits(__float_as_int(s)) & ~mask) | row);
      } else if (s < best) {
        best = s;
        arg = row;
      }
    }
  }

  if (!live) return;
  const long long o = (long long)bin * B + qi;
  if constexpr (PACKED) {
    out_val[o] = __int_as_float(flip_bits(arg & ~mask));
    out_idx[o] = (int)(row0 + (arg & mask));
  } else {
    out_val[o] = best;
    out_idx[o] = (int)(row0 + arg);
  }
}

// ---- K1 on the tensor cores: bf16, fp16 and int8 at d in {16, 32, 64,
// 128}, bins a multiple of 16 rows. The loop is gbnns::tc_scan_bin
// (common.cuh); K1 gives it addvec, its key (the (min, row) pair, or the
// flipped key when PACKED) and D elements of KIND a row: KS k-slabs of 32
// bytes, int8 at d = 16 zero-padding its row to 32 bytes.
template <int D, int KIND>
struct ScanTc {
  static constexpr int kRowBytes = D * (KIND == kInt8 ? 1 : 2);
  static constexpr int KS = (kRowBytes + 31) / 32;
  using S = gbnns::TcShape<KS>;
};

template <int D, int KIND, bool PACKED>
__global__ void __launch_bounds__(gbnns::kTcThreads, 2)
binned_scan_tc_kernel(const void* __restrict__ q_ptr,
                      const void* __restrict__ x_ptr,
                      const float* __restrict__ addvec,
                      const float* __restrict__ alpha,
                      float* __restrict__ out_val, int* __restrict__ out_idx,
                      int B, int bin_size, int idx_bits, int q_tiles) {
  using T = ScanTc<D, KIND>;
  constexpr int kStage = T::S::kChunk * T::S::kPitch;
  __shared__ __align__(16) unsigned char xs[2 * kStage];
  __shared__ __align__(16) float adds[2 * T::S::kChunk];
  constexpr int kSel = PACKED ? gbnns::kSelFlip : gbnns::kSelMin;
  gbnns::tc_scan_bin<KIND, T::KS, kSel, true, 16>(
      xs, kStage, adds, q_ptr, x_ptr, addvec, alpha, out_val, out_idx, B,
      bin_size, idx_bits, q_tiles, T::kRowBytes, T::KS, false, T::S::kPitch);
}

template <int D>
cudaError_t launch_scan_tc(const void* q, const void* x, const float* addvec,
                           const float* alpha, float* out_val, int* out_idx,
                           int B, int n_bins, int bin_size, int idx_bits,
                           int kind, bool packed, cudaStream_t stream) {
#define GBNNS_TC(KI, PK)                                                    \
  do {                                                                      \
    const int q_tiles =                                                     \
        gbnns::tc_query_tiles<ScanTc<D, KI>::KS>(B);                        \
    binned_scan_tc_kernel<D, KI, PK>                                        \
        <<<(unsigned)((long long)n_bins * q_tiles), gbnns::kTcThreads, 0,   \
           stream>>>(q, x, addvec, alpha, out_val, out_idx, B, bin_size,    \
                     idx_bits, q_tiles);                                    \
  } while (0)
  switch (kind) {
    case kBf16:
      if (packed) GBNNS_TC(kBf16, true); else GBNNS_TC(kBf16, false);
      break;
    case kF16:
      if (packed) GBNNS_TC(kF16, true); else GBNNS_TC(kF16, false);
      break;
    case kInt8:
      if (packed) GBNNS_TC(kInt8, true); else GBNNS_TC(kInt8, false);
      break;
    default:
      return cudaErrorInvalidValue;  // f32 runs on the CUDA cores
  }
#undef GBNNS_TC
  return cudaGetLastError();
}

// D = 0 selects binned_scan_wide_kernel.
template <int D>
cudaError_t launch_scan(const void* q, const void* x, const float* addvec,
                        const float* alpha, float* out_val, int* out_idx,
                        int B, int d, int n_bins, int bin_size, int idx_bits,
                        int kind, bool packed, cudaStream_t stream) {
  constexpr int per_block = kScanThreads * (D == 0 ? 1 : 128 / (D ? D : 1));
  const dim3 grid(n_bins, (B + per_block - 1) / per_block);
  const dim3 block(kScanThreads);
#define GBNNS_SCAN(KI, PK)                                                  \
  do {                                                                      \
    if constexpr (D == 0)                                                   \
      binned_scan_wide_kernel<KI, PK><<<grid, block, 0, stream>>>(          \
          q, x, addvec, alpha, out_val, out_idx, B, d, bin_size, idx_bits); \
    else                                                                    \
      binned_scan_kernel<D, KI, PK><<<grid, block, 0, stream>>>(            \
          q, x, addvec, alpha, out_val, out_idx, B, bin_size, idx_bits);    \
  } while (0)
  switch (kind) {
    case kBf16:
      if (packed) GBNNS_SCAN(kBf16, true); else GBNNS_SCAN(kBf16, false);
      break;
    case kInt8:
      if (packed) GBNNS_SCAN(kInt8, true); else GBNNS_SCAN(kInt8, false);
      break;
    case kF32:
      if (packed) GBNNS_SCAN(kF32, true); else GBNNS_SCAN(kF32, false);
      break;
    case kF16:
      if (packed) GBNNS_SCAN(kF16, true); else GBNNS_SCAN(kF16, false);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef GBNNS_SCAN
  return cudaGetLastError();
}

// A list word: the quantized flipped key (its low log2(rb) bits cleared)
// with the row in its low bits, so that one integer compare gives the
// (key, row) order. Narrow (32-bit) words hold the row within the split,
// which the caller keeps below rb; wide (64-bit) words hold the key in the
// high half and the global row in the low half.
template <bool WIDE>
using merge_word_t = std::conditional_t<WIDE, long long, int>;

template <bool WIDE>
__device__ __forceinline__ merge_word_t<WIDE> merge_word(float v, int row,
                                                         int qmask) {
  const int key = flip_bits(__float_as_int(v)) & qmask;
  if constexpr (WIDE)
    return ((long long)key << 32) | (unsigned)row;
  else
    return key | row;
}

template <bool WIDE>
__device__ __forceinline__ constexpr merge_word_t<WIDE> merge_empty() {
  if constexpr (WIDE)
    return kMergeEmpty;
  else
    return kIntMax;
}

// A word of split s as a wide word with its global row (split rows start
// at r0), kMergeEmpty for an empty slot.
template <bool WIDE>
__device__ __forceinline__ long long merge_global(merge_word_t<WIDE> w,
                                                  int qmask, int r0) {
  if constexpr (WIDE) {
    return w;
  } else {
    if (w == kIntMax) return kMergeEmpty;
    return ((long long)(w & qmask) << 32) | (unsigned)(r0 + (w & ~qmask));
  }
}

// One cluster of `splits` blocks per block of queries; block s scans rows
// [R * s / splits, R * (s + 1) / splits) for one query a thread and keeps
// the thread's smallest words: CK of them in registers (CK >= ck; a sorted
// list updated by a branch-free min/max pass, skipped when no lane of the
// warp has a word below its list's last), or ck of them thread-strided in
// shared memory for CK = 0 (wide words only). Then block 0 merges the
// splits' lists through distributed shared memory and writes the top ck as
// (value, id) (ck, B); an empty slot (R < ck) gives +inf and -1.
template <int CK, bool WIDE>
__global__ void __launch_bounds__(kMergeThreads)
merge_topc_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                  float* __restrict__ out_val, int* __restrict__ out_idx,
                  int R, int B, int qmask, int ck) {
  using W = merge_word_t<WIDE>;
  static_assert(CK > 0 || WIDE, "lists in shared memory hold wide words");
  extern __shared__ __align__(16) unsigned char merge_smem[];
  W* lst = reinterpret_cast<W*>(merge_smem);  // [list length][blockDim.x]
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int split = (int)cluster.block_rank();
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int qi = blockIdx.y * nt + tid;
  const bool live = qi < B;
  const int r0 = (int)((long long)R * split / splits);
  const int r1 = (int)((long long)R * (split + 1) / splits);
  const int base = WIDE ? 0 : r0;  // narrow words hold row - r0
  const int len = CK > 0 ? CK : ck;

  W l[CK > 0 ? CK : 1];
  if constexpr (CK > 0) {
#pragma unroll
    for (int j = 0; j < CK; ++j) l[j] = merge_empty<WIDE>();
  } else {
    for (int j = 0; j < ck; ++j) lst[j * nt + tid] = merge_empty<WIDE>();
  }
  W thr = merge_empty<WIDE>();  // the shared-memory list's last word
  // a warp reads 128 contiguous bytes of a row; the next batch of
  // kMergeUnroll rows is loaded while the current one is offered
  const float* col = vals + (live ? qi : 0);
  auto load = [&](float (&v)[kMergeUnroll], int r) {
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u)
      v[u] = live && r + u < r1 ? __ldcs(col + (long long)(r + u) * B) : 0.f;
  };
  float cur[kMergeUnroll], nxt[kMergeUnroll];
  load(cur, r0);
  for (int r = r0; r < r1; r += kMergeUnroll) {
    load(nxt, r + kMergeUnroll);
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) {
      W w = live && r + u < r1
                ? merge_word<WIDE>(cur[u], r + u - base, qmask)
                : merge_empty<WIDE>();
      if constexpr (CK > 0) {
        // warp-uniform: one min/max pass leaves the list as it is for a
        // word above it, so it is skipped when no lane has one below
        if (__any_sync(0xFFFFFFFFu, w < l[CK - 1])) {
#pragma unroll
          for (int j = 0; j < CK; ++j) {
            const W lo = min(l[j], w);
            w = max(l[j], w);
            l[j] = lo;
          }
        }
      } else if (w < thr) {  // rows ascend: an equal key keeps the earlier row
        int j = ck - 1;
        for (; j > 0 && lst[(j - 1) * nt + tid] > w; --j)
          lst[j * nt + tid] = lst[(j - 1) * nt + tid];
        lst[j * nt + tid] = w;
        thr = lst[(ck - 1) * nt + tid];
      }
    }
#pragma unroll
    for (int u = 0; u < kMergeUnroll; ++u) cur[u] = nxt[u];
  }
  if constexpr (CK > 0) {
#pragma unroll
    for (int j = 0; j < CK; ++j) lst[j * nt + tid] = l[j];
  }
  cluster.sync();  // every split's list is in its block's shared memory

  if (split == 0 && live) {
    // the splits are ascending row ranges: by (key, global row)
    // each split's head and the word after it (loaded a step ahead)
    const W* src[kMergeMaxSplits];
    long long head[kMergeMaxSplits], next[kMergeMaxSplits];
    int pos[kMergeMaxSplits], rs[kMergeMaxSplits];
    auto word = [&](int s, int p) {
      return p < len ? merge_global<WIDE>(src[s][p * nt + tid], qmask, rs[s])
                     : kMergeEmpty;
    };
#pragma unroll
    for (int s = 0; s < kMergeMaxSplits; ++s) {
      rs[s] = (int)((long long)R * s / splits);
      src[s] = s < splits ? cluster.map_shared_rank(lst, s) : lst;
      head[s] = s < splits ? word(s, 0) : kMergeEmpty;
      next[s] = s < splits ? word(s, 1) : kMergeEmpty;
      pos[s] = 0;
    }
    // slots in groups of eight: the merge first, then the group's id loads
    // together (ck is a multiple of 8)
    for (int t0 = 0; t0 < ck; t0 += 8) {
      long long win[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        long long best = head[0];
        int bs = 0;
#pragma unroll
        for (int s = 1; s < kMergeMaxSplits; ++s)
          if (head[s] < best) {
            best = head[s];
            bs = s;
          }
#pragma unroll
        for (int s = 0; s < kMergeMaxSplits; ++s)
          if (s == bs) {
            ++pos[s];
            head[s] = next[s];
            next[s] = word(s, pos[s] + 1);
          }
        win[u] = best;
      }
      int id[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        id[u] = win[u] == kMergeEmpty
                    ? -1
                    : __ldg(ids + (long long)(int)(win[u] & 0xFFFFFFFF) * B + qi);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const long long o = (long long)(t0 + u) * B + qi;
        out_val[o] = win[u] == kMergeEmpty
                         ? __int_as_float(0x7F800000)
                         : __int_as_float(flip_bits((int)(win[u] >> 32)));
        out_idx[o] = id[u];
      }
    }
  }
  cluster.sync();  // block 0 has read every list: the blocks may exit
}

template <int CK, bool WIDE>
cudaError_t launch_merge(const float* vals, const int* ids, float* out_val,
                         int* out_idx, int R, int B, int qmask, int ck,
                         int splits, int threads, cudaStream_t stream) {
  const size_t smem =
      (size_t)(CK > 0 ? CK : ck) * threads * sizeof(merge_word_t<WIDE>);
  cudaError_t err = cudaFuncSetAttribute(
      merge_topc_kernel<CK, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (B + threads - 1) / threads, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, merge_topc_kernel<CK, WIDE>, vals, ids,
                           out_val, out_idx, R, B, qmask, ck);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gbnns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, d) and x (n_pad, d) of one kind: 0 bf16 (x prescaled), 1 int8,
// 2 f32 (x prescaled), 3 fp16 (x prescaled); addvec (n_pad,) f32; alpha
// (B,) f32 for int8, else ignored; out_val f32 / out_idx int32, both
// (n_pad / bin_size, B).
// d in {16, 32, 64, 128} or any larger multiple of 16; n_pad % bin_size ==
// 0; PACKED needs a power-of-two bin_size. Pointers 16-byte aligned.
// tensor_cores = 1 takes binned_scan_tc_kernel (bf16, fp16, int8; d in
// {16, 32, 64, 128}; bin_size a multiple of 16; anything else is refused),
// 0 the CUDA-core kernels. The caller chooses (scan_topk.scan_cores).
int gbnns_binned_scan(const void* q, const void* x, const float* addvec,
                      const float* alpha, float* out_val, int* out_idx,
                      int B, int n_pad, int d, int bin_size, int kind,
                      int packed, int tensor_cores, void* stream) {
  if (B <= 0 || bin_size <= 0 || n_pad <= 0 || n_pad % bin_size != 0 ||
      kind < kBf16 || kind > kF16)
    return cudaErrorInvalidValue;
  int idx_bits = 0;
  while ((1 << idx_bits) < bin_size) ++idx_bits;
  if (packed && (1 << idx_bits) != bin_size) return cudaErrorInvalidValue;
  const int n_bins = n_pad / bin_size;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (kind == kF32 || bin_size % gbnns::kTcRowTile != 0)
      return cudaErrorInvalidValue;
#define GBNNS_LAUNCH_TC(DD)                                                 \
  launch_scan_tc<DD>(q, x, addvec, alpha, out_val, out_idx, B, n_bins,      \
                     bin_size, idx_bits, kind, packed, s)
    switch (d) {
      case 16: return GBNNS_LAUNCH_TC(16);
      case 32: return GBNNS_LAUNCH_TC(32);
      case 64: return GBNNS_LAUNCH_TC(64);
      case 128: return GBNNS_LAUNCH_TC(128);
      default: return cudaErrorInvalidValue;
    }
#undef GBNNS_LAUNCH_TC
  }
#define GBNNS_LAUNCH(DD)                                                   \
  launch_scan<DD>(q, x, addvec, alpha, out_val, out_idx, B, d, n_bins,     \
                  bin_size, idx_bits, kind, packed, s)
  switch (d) {
    case 16: return GBNNS_LAUNCH(16);
    case 32: return GBNNS_LAUNCH(32);
    case 64: return GBNNS_LAUNCH(64);
    case 128: return GBNNS_LAUNCH(128);
    default:
      if (d > 128 && d % 16 == 0) return GBNNS_LAUNCH(0);
      return cudaErrorInvalidValue;
  }
#undef GBNNS_LAUNCH
}

// The top-ck merge of bin-major winners vals f32 / ids int32 (R, B) ->
// out (ck, B), ascending by (quantized key, row): the result of the staged
// merge of blocks of rb rows (scan_topk.merge_topc_plain) in one launch.
// rb a power of two in [2, 2048], 8 <= ck <= rb / 2 with ck a multiple
// of 8, R >= 1.
int gbnns_merge_topc(const float* vals, const int* ids, float* out_val,
                     int* out_idx, int R, int B, int rb, int ck,
                     void* stream) {
  if (R <= 0 || B <= 0 || rb < 2 || rb > 2048 || (rb & (rb - 1)) != 0 ||
      ck < 8 || ck % 8 != 0 || 2 * ck > rb)
    return cudaErrorInvalidValue;
  // splits of about kMergeSplitRows rows; narrow words when a split's rows
  // fit below rb - 1 (so no word reaches the empty word kIntMax)
  int splits = (R + kMergeSplitRows - 1) / kMergeSplitRows;  // R >= 1
  if (splits > kMergeMaxSplits) splits = kMergeMaxSplits;
  const int narrow_splits = (R + rb - 2) / (rb - 1);
  const bool wide = narrow_splits > kMergeMaxSplits;
  if (!wide && narrow_splits > splits) splits = narrow_splits;
  // register lists of 16 or 48 words; past 48, wide words in shared memory,
  // a block of queries small enough that its lists fit in kMergeSmem bytes
  const int list = ck <= 16 ? 16 : ck <= 48 ? 48 : 0;
  int threads = kMergeThreads;
  if (list == 0) {
    threads = (int)(kMergeSmem / ((size_t)ck * sizeof(long long)));
    if (threads > kMergeThreads) threads = kMergeThreads;
    if (threads >= 32) threads -= threads % 32;
  }
  if ((B + threads - 1) / threads > 65535) return cudaErrorInvalidValue;
  const int qmask = ~(rb - 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GBNNS_MERGE(CK, WIDE)                                               \
  launch_merge<CK, WIDE>(vals, ids, out_val, out_idx, R, B, qmask, ck,      \
                         splits, threads, s)
  if (list == 0) return GBNNS_MERGE(0, true);
  if (list == 16)
    return wide ? GBNNS_MERGE(16, true) : GBNNS_MERGE(16, false);
  return wide ? GBNNS_MERGE(48, true) : GBNNS_MERGE(48, false);
#undef GBNNS_MERGE
}

}  // extern "C"

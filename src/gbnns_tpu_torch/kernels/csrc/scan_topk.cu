// Hopper (sm_90a) kernels of the fused-scan serving path, behind a plain C
// interface that gbnns_tpu_torch/kernels/scan_topk.py binds with ctypes.
// K1's kernels are in scan_k1.cuh; this file instantiates its prescaled and
// int8 ones, scan_epilogue.cu the unprescaled and shifted ones and
// scan_wide.cu the tensor-core ones at d > 128, three translation units
// that nvcc compiles at once and links into one library
// (kernels/_build.py). No PyTorch or CUTLASS header:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler \
//        -fPIC -c scan_topk.cu   (and scan_epilogue.cu, scan_wide.cu, in
//                                 parallel)
//   nvcc -shared -o libscan_topk.so scan_topk.o scan_epilogue.o scan_wide.o
//
// Every launcher takes the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).
//
// K1 binned_scan -- replaces gbnns_tpu/kernels/scan_topk_pallas.py
//   _scan_kernel (pallas_call at line 342, reached through binned_scan).
//   For every corpus bin of `bin_size` rows and every query it writes the
//   bin's min reduced-dimension score and the row that attains it (ties to
//   the lower row), bin-major: vals/ids (n_bins, B). Scores are T1's
//   epilogues (gbnns::ScanEpilogue, a template parameter):
//     bf16, fp16, f32 prescaled: addvec[x] + dot(x, q), x stored -2x or -x
//     unprescaled:     addvec[x] + scale * dot(x, q), scale -2 (l2) or -1
//                      (ip, angular), riding on the query: the kernel
//                      multiplies q by it once as q is loaded (exact)
//     shifted:         either of those + qshift[q], added before the
//                      selection; a packed key then takes the raw bits
//     int8:            addvec[x] + float(dot_i32(x, q)) * alpha[q]
//   PACKED reproduces the Pallas packed mode: the score's IEEE bits are
//   flipped into signed-int order (left raw when shifted), the low
//   log2(bin_size) bits replaced by the in-bin row, and one integer min
//   gives value and row together.
//   Bound on an H100 SXM at the serving shapes (n = 1M, B = 16384, d = 32):
//   2*B*n*d = 1.07 TFLOP, 1.1 ms at the 989 TFLOP/s bf16 tensor-core peak
//   (0.55 ms at 1,979 TOP/s int8), against ~0.06 ms for the bytes (64 MB of
//   corpus, 128 MB of winners), so it is bound by operations. Two routes,
//   chosen by the caller (scan_topk.scan_cores) and passed in:
//   * Tensor cores (binned_scan_tc_kernel): bf16, fp16 and int8 at d in
//     {16, 32, 64, 128}, bins a multiple of 16 rows; at any larger d (a
//     multiple of 16) binned_scan_wide_tc_kernel (scan_wide.cu), the same
//     products and selection with both operands staged in shared memory
//     (common.cuh's tc_scan_bin_wide). mma.sync m16n8k16
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
//     fp32 rate), bins that are not a multiple of 16 rows, and any shape
//     asked for with cores="cuda" (how chip_smoke.py times the route the
//     tensor cores replaced). A block owns one bin and 128*QPT queries; each thread
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

#include "scan_k1.cuh"

namespace {

namespace cg = cooperative_groups;

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
using gbnns::kIntMax;

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

// q (B, d) and x (n_pad, d) of one kind: 0 bf16, 1 int8, 2 f32, 3 fp16;
// addvec (n_pad,) f32; alpha (B,) f32 for int8, else null; out_val f32 /
// out_idx int32, both (n_pad / bin_size, B). The epilogue: `scale` the
// factor on the float kinds' dot product (1 for a corpus stored
// prescaled, -2 or -1 for an unscaled one; 1 for int8, whose alpha
// scales), `qshift` (B,) f32 the per-query shift of a float kind, or null.
// d in {16, 32, 64, 128} or any larger multiple of 16; n_pad % bin_size ==
// 0; PACKED needs a power-of-two bin_size. Pointers 16-byte aligned.
// tensor_cores = 1 takes binned_scan_tc_kernel (bf16, fp16, int8; d in
// {16, 32, 64, 128}) or binned_scan_wide_tc_kernel (any larger d), bin_size
// a multiple of 16 (anything else is refused), 0 the CUDA-core kernels.
// The caller chooses (scan_topk.scan_cores).
int gbnns_binned_scan(const void* q, const void* x, const float* addvec,
                      const float* alpha, const float* qshift,
                      float* out_val, int* out_idx, int B, int n_pad, int d,
                      int bin_size, int kind, int packed, int tensor_cores,
                      float scale, void* stream) {
  if (B <= 0 || bin_size <= 0 || n_pad <= 0 || n_pad % bin_size != 0 ||
      kind < kBf16 || kind > kF16)
    return cudaErrorInvalidValue;
  if (scale != 1.f && scale != -1.f && scale != -2.f)
    return cudaErrorInvalidValue;
  if (kind == kInt8 ? (alpha == nullptr || qshift != nullptr || scale != 1.f)
                    : alpha != nullptr)
    return cudaErrorInvalidValue;
  const int epi = qshift != nullptr ? kEpiShifted
                  : scale != 1.f    ? kEpiScaled
                                    : kEpiPrescaled;
  const float* qs = kind == kInt8 ? alpha : qshift;  // the kernels' `alpha`
  int idx_bits = 0;
  while ((1 << idx_bits) < bin_size) ++idx_bits;
  if (packed && (1 << idx_bits) != bin_size) return cudaErrorInvalidValue;
  const int n_bins = n_pad / bin_size;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epi == kEpiPrescaled)
    return launch_binned_scan<kEpiPrescaled>(
        q, x, addvec, qs, out_val, out_idx, B, d, n_bins, bin_size, idx_bits,
        kind, packed, tensor_cores, scale, s);
  return gbnns::launch_binned_scan_epilogue(
      epi, q, x, addvec, qs, out_val, out_idx, B, d, n_bins, bin_size,
      idx_bits, kind, packed, tensor_cores, scale, s);
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

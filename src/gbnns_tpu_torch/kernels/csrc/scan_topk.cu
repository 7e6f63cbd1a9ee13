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
//     bf16:  addvec[x] + dot(x, q)            x stored prescaled (-2x or -x)
//     int8:  addvec[x] + float(dot_i32(x, q)) * alpha[q]
//   PACKED reproduces the Pallas packed mode: the score's IEEE bits are
//   flipped into signed-int order, the low log2(bin_size) bits replaced by
//   the in-bin row, and one integer min gives value and row together.
//   Bound on an H100 SXM at the serving shapes (n = 1M, B = 16384, d = 32):
//   2*B*n*d = 1.07 TFLOP, 1.1 ms at the 989 TFLOP/s bf16 tensor-core peak
//   (0.55 ms at 1,979 TOP/s int8), against ~0.06 ms for the bytes (64 MB of
//   corpus, 128 MB of winners), so it is bound by operations. This first
//   version runs on the CUDA cores: fp32 FMAs from bf16 inputs, exact int32
//   dp4a from int8 inputs. What the design does about the bound: a block
//   owns one bin and 128*QPT queries; each thread keeps QPT queries in
//   registers and a running (min, argmin) per query, corpus rows are staged
//   in 16 KB of shared memory and read as warp-wide broadcasts, so the inner
//   loop is FMAs (dp4a) with one 16-byte shared load per four (sixteen)
//   elements of a row. The scores never reach device memory. Tensor cores
//   (mma.sync / wgmma) and TMA are left for a later change.
//
// K2 merge_topc -- replaces scan_topk_pallas.py _merge_topc_kernel
//   (pallas_call at line 600, reached through _merge_topc_stage and
//   merge_topc). One stage: for each block of `rb` rows of the bin-major
//   winners and each query, the ck smallest keys in ascending order, where
//   a key is the flipped IEEE score with the in-block row in its low
//   log2(rb) bits (unique within a block, so the result is exact). Rows past
//   R are padding: +inf score, id -1. Output (ck * r_blocks, B).
//   Bound: it reads the winners once, 977 * 16384 * 8 B = 128 MB at the
//   serving shapes, ~0.04 ms at 3.35 TB/s: bytes. Design: a block loads an
//   (rb x 8 queries) tile with coalesced reads into shared memory as keys;
//   then one warp per query runs ck rounds of a warp-shuffle integer min,
//   and only the lane that owned the winner rescans its rb/32 keys.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 128;
constexpr int kTileBytes = 16384;  // corpus rows staged per step
constexpr int kMergeQueries = 8;   // queries (warps) per merge block
constexpr int kIntMax = 0x7FFFFFFF;

// IEEE-f32 bits -> signed-int total order (an involution).
__device__ __forceinline__ int flip_bits(int b) {
  return b < 0 ? (b ^ 0x7FFFFFFF) : b;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// D in {16, 32, 64, 128}; QPT queries per thread keeps D * QPT = 128
// registers of query data.
template <int D, bool QUANT, bool PACKED>
__global__ void __launch_bounds__(kScanThreads)
binned_scan_kernel(const void* __restrict__ q_ptr,
                   const void* __restrict__ x_ptr,
                   const float* __restrict__ addvec,
                   const float* __restrict__ alpha,
                   float* __restrict__ out_val, int* __restrict__ out_idx,
                   int B, int bin_size, int idx_bits) {
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
      } else {
        const uint4* src = reinterpret_cast<const uint4*>(
            static_cast<const uint16_t*>(q_ptr) + (long long)qi * D);
#pragma unroll
        for (int k = 0; k < D / 8; ++k) {
          uint4 v = src[k];
          qw[j][8 * k + 0] = __float_as_uint(bf16_lo(v.x));
          qw[j][8 * k + 1] = __float_as_uint(bf16_hi(v.x));
          qw[j][8 * k + 2] = __float_as_uint(bf16_lo(v.y));
          qw[j][8 * k + 3] = __float_as_uint(bf16_hi(v.y));
          qw[j][8 * k + 4] = __float_as_uint(bf16_lo(v.z));
          qw[j][8 * k + 5] = __float_as_uint(bf16_hi(v.z));
          qw[j][8 * k + 6] = __float_as_uint(bf16_lo(v.w));
          qw[j][8 * k + 7] = __float_as_uint(bf16_hi(v.w));
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
    } else {
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const uint16_t*>(x_ptr) + (row0 + t0) * D);
      float4* dst = reinterpret_cast<float4*>(xs);
      for (int i = tid; i < cnt * (D / 8); i += kScanThreads) {
        uint4 v = src[i];
        dst[2 * i] = make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y),
                                 bf16_hi(v.y));
        dst[2 * i + 1] = make_float4(bf16_lo(v.z), bf16_hi(v.z),
                                     bf16_lo(v.w), bf16_hi(v.w));
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

template <int D>
cudaError_t launch_scan(const void* q, const void* x, const float* addvec,
                        const float* alpha, float* out_val, int* out_idx,
                        int B, int n_bins, int bin_size, int idx_bits,
                        bool quant, bool packed, cudaStream_t stream) {
  constexpr int per_block = kScanThreads * (128 / D);
  const dim3 grid(n_bins, (B + per_block - 1) / per_block);
  const dim3 block(kScanThreads);
#define GBNNS_SCAN(QU, PK)                                                  \
  binned_scan_kernel<D, QU, PK><<<grid, block, 0, stream>>>(                \
      q, x, addvec, alpha, out_val, out_idx, B, bin_size, idx_bits)
  if (quant) {
    if (packed) GBNNS_SCAN(true, true); else GBNNS_SCAN(true, false);
  } else {
    if (packed) GBNNS_SCAN(false, true); else GBNNS_SCAN(false, false);
  }
#undef GBNNS_SCAN
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kMergeQueries * 32)
merge_topc_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                  float* __restrict__ out_val, int* __restrict__ out_idx,
                  int R, int B, int rb, int rb_bits, int ck) {
  extern __shared__ int keys[];  // [kMergeQueries][rb]
  const int blk = blockIdx.x;
  const int qbase = blockIdx.y * kMergeQueries;
  const int tid = threadIdx.x;
  const int mask = (1 << rb_bits) - 1;
  const long long g0 = (long long)blk * rb;

  // coalesced load: consecutive threads take consecutive queries of a row
  for (int i = tid; i < rb * kMergeQueries; i += blockDim.x) {
    const int row = i / kMergeQueries;
    const int col = i % kMergeQueries;
    const long long g = g0 + row;
    const int qi = qbase + col;
    float v = __int_as_float(0x7F800000);  // padding row: +inf
    if (g < R && qi < B) v = vals[g * B + qi];
    keys[col * rb + row] = (flip_bits(__float_as_int(v)) & ~mask) | row;
  }
  __syncthreads();

  const int w = tid >> 5;
  const int lane = tid & 31;
  const int qi = qbase + w;
  if (qi >= B) return;
  int* kq = keys + w * rb;
  int local = kIntMax;
  for (int r = lane; r < rb; r += 32) local = min(local, kq[r]);
  for (int t = 0; t < ck; ++t) {
    int m = local;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    const int row = m & mask;
    if (lane == 0) {
      const long long o = ((long long)blk * ck + t) * B + qi;
      out_val[o] = __int_as_float(flip_bits(m & ~mask));
      out_idx[o] = (g0 + row < R) ? ids[(g0 + row) * B + qi] : -1;
    }
    if ((row & 31) == lane) {  // the owner drops the winner and rescans
      kq[row] = kIntMax;
      local = kIntMax;
      for (int r = lane; r < rb; r += 32) local = min(local, kq[r]);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

const char* gbnns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, d) bf16 or int8; x (n_pad, d) bf16 (prescaled) or int8;
// addvec (n_pad,) f32; alpha (B,) f32 for int8, else ignored;
// out_val f32 / out_idx int32, both (n_pad / bin_size, B).
// d in {16, 32, 64, 128}; n_pad % bin_size == 0; PACKED needs a
// power-of-two bin_size. Pointers 16-byte aligned.
int gbnns_binned_scan(const void* q, const void* x, const float* addvec,
                      const float* alpha, float* out_val, int* out_idx,
                      int B, int n_pad, int d, int bin_size, int quant,
                      int packed, void* stream) {
  if (B <= 0 || bin_size <= 0 || n_pad <= 0 || n_pad % bin_size != 0)
    return cudaErrorInvalidValue;
  int idx_bits = 0;
  while ((1 << idx_bits) < bin_size) ++idx_bits;
  if (packed && (1 << idx_bits) != bin_size) return cudaErrorInvalidValue;
  const int n_bins = n_pad / bin_size;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_scan<16>(q, x, addvec, alpha, out_val, out_idx, B,
                                    n_bins, bin_size, idx_bits, quant, packed, s);
    case 32: return launch_scan<32>(q, x, addvec, alpha, out_val, out_idx, B,
                                    n_bins, bin_size, idx_bits, quant, packed, s);
    case 64: return launch_scan<64>(q, x, addvec, alpha, out_val, out_idx, B,
                                    n_bins, bin_size, idx_bits, quant, packed, s);
    case 128: return launch_scan<128>(q, x, addvec, alpha, out_val, out_idx, B,
                                      n_bins, bin_size, idx_bits, quant, packed, s);
    default: return cudaErrorInvalidValue;
  }
}

// One merge stage: vals f32 / ids int32 (R, B) bin-major -> out (ck *
// ceil(R / rb), B). rb a power of two in [2, 2048], ck <= rb / 2.
int gbnns_merge_topc_stage(const float* vals, const int* ids, float* out_val,
                           int* out_idx, int R, int B, int rb, int ck,
                           void* stream) {
  int rb_bits = 0;
  while ((1 << rb_bits) < rb) ++rb_bits;
  if (R <= 0 || B <= 0 || rb < 2 || rb > 2048 || (1 << rb_bits) != rb ||
      ck <= 0 || 2 * ck > rb)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)rb * kMergeQueries * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      merge_topc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + rb - 1) / rb, (B + kMergeQueries - 1) / kMergeQueries);
  merge_topc_kernel<<<grid, kMergeQueries * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      vals, ids, out_val, out_idx, R, B, rb, rb_bits, ck);
  return cudaGetLastError();
}

}  // extern "C"

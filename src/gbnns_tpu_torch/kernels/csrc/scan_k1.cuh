// K1 binned_scan (T1, scan_topk_pallas.py _scan_kernel): its kernels and
// launcher, described in scan_topk.cu. Two translation units include this
// header and nvcc compiles them in parallel, with scan_wide.cu, into one
// library (kernels/_build.py): scan_topk.cu, which holds the C interface
// and the prescaled and int8 kernels (kEpiPrescaled), and
// scan_epilogue.cu, which holds T1's unprescaled and shifted epilogues
// (kEpiScaled, kEpiShifted) behind gbnns::launch_binned_scan_epilogue; the
// tensor-core kernels at d > 128 are scan_wide.cu's, behind
// gbnns::launch_binned_scan_wide. Plain CUDA: no PyTorch header.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace gbnns {

// K1 with epilogue epi (kEpiScaled or kEpiShifted), from scan_epilogue.cu;
// the arguments are launch_binned_scan's.
cudaError_t launch_binned_scan_epilogue(
    int epi, const void* q, const void* x, const float* addvec,
    const float* qs, float* out_val, int* out_idx, int B, int d, int n_bins,
    int bin_size, int idx_bits, int kind, bool packed, bool tensor_cores,
    float qscale, cudaStream_t s);

// K1 on the tensor cores at d > 128 (a multiple of 16), any epilogue, from
// scan_wide.cu; the arguments are launch_binned_scan's.
cudaError_t launch_binned_scan_wide(
    int epi, const void* q, const void* x, const float* addvec,
    const float* qs, float* out_val, int* out_idx, int B, int d, int n_bins,
    int bin_size, int idx_bits, int kind, bool packed, float qscale,
    cudaStream_t s);

}  // namespace gbnns

namespace {

constexpr int kScanThreads = 128;
constexpr int kTileBytes = 16384;  // corpus rows staged per step
constexpr int kWideRows = 32;      // wide scan: corpus rows per step
constexpr int kWideCols = 64;      // wide scan: columns per staged slab

using gbnns::half8_to_f32;
using gbnns::kBf16;
using gbnns::kEpiPrescaled;
using gbnns::kEpiScaled;
using gbnns::kEpiShifted;
using gbnns::kF16;
using gbnns::kF32;
using gbnns::kInt8;
using gbnns::kIntMax;

// The packed key of an epilogue: flipped, or the raw bits when shifted.
template <int EPI>
constexpr int kPackedSel = EPI == kEpiShifted ? gbnns::kSelRaw
                                              : gbnns::kSelFlip;

// D in {16, 32, 64, 128}; QPT queries per thread keeps D * QPT = 128
// registers of query data. `alpha` is the int8 scan's alpha or the
// shifted epilogue's qshift; qscale the unprescaled epilogues' factor.
template <int D, int KIND, bool PACKED, int EPI>
__global__ void __launch_bounds__(kScanThreads)
binned_scan_kernel(const void* __restrict__ q_ptr,
                   const void* __restrict__ x_ptr,
                   const float* __restrict__ addvec,
                   const float* __restrict__ alpha,
                   float* __restrict__ out_val, int* __restrict__ out_idx,
                   int B, int bin_size, int idx_bits, float qscale) {
  constexpr bool QUANT = KIND == kInt8;
  constexpr bool SHIFT = EPI == kEpiShifted;
  static_assert(!QUANT || EPI == kEpiPrescaled, "int8 scales by alpha");
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
      if constexpr (EPI != kEpiPrescaled) {  // the scale, exact in f32
#pragma unroll
        for (int k = 0; k < kQWords; ++k)
          qw[j][k] = __float_as_uint(__uint_as_float(qw[j][k]) * qscale);
      }
      if constexpr (SHIFT) al[j] = alpha[qi];
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
        for (int j = 0; j < QPT; ++j) {
          s[j] = __fadd_rn(a, acc[j]);
          if constexpr (SHIFT) s[j] = __fadd_rn(s[j], al[j]);
        }
      }
      const int row = t0 + r;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        if constexpr (PACKED) {
          arg[j] = min(arg[j],
                       gbnns::tc_key<kPackedSel<EPI>>(s[j], mask, row));
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
      out_val[o] = gbnns::tc_key_value<kPackedSel<EPI>>(arg[j], mask);
      out_idx[o] = (int)(row0 + (arg[j] & mask));
    } else {
      out_val[o] = best[j];
      out_idx[o] = (int)(row0 + arg[j]);
    }
  }
}

// Any d that is a multiple of 16 (used for d > 128: f32, bins off the row
// tile, and the other kinds when cores="cuda" asks): one query per thread.
// A step stages kWideRows corpus rows kWideCols columns at a time; each
// thread reads its query 16 columns at a time into registers and keeps the
// kWideRows running row sums in registers across the slabs, so no score
// leaves the block. Sums run column by column, as in binned_scan_kernel,
// and the epilogues are its own.
template <int KIND, bool PACKED, int EPI>
__global__ void __launch_bounds__(kScanThreads)
binned_scan_wide_kernel(const void* __restrict__ q_ptr,
                        const void* __restrict__ x_ptr,
                        const float* __restrict__ addvec,
                        const float* __restrict__ alpha,
                        float* __restrict__ out_val, int* __restrict__ out_idx,
                        int B, int d, int bin_size, int idx_bits,
                        float qscale) {
  constexpr bool QUANT = KIND == kInt8;
  constexpr bool SHIFT = EPI == kEpiShifted;
  static_assert(!QUANT || EPI == kEpiPrescaled, "int8 scales by alpha");
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
  const float al = ((QUANT || SHIFT) && live) ? alpha[qi] : 0.f;
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
          if constexpr (EPI != kEpiPrescaled) {  // the scale, exact in f32
#pragma unroll
            for (int k = 0; k < 16; ++k) qv[k] *= qscale;
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
      if constexpr (SHIFT) s = __fadd_rn(s, al);
      const int row = t0 + r;
      if constexpr (PACKED) {
        arg = min(arg, gbnns::tc_key<kPackedSel<EPI>>(s, mask, row));
      } else if (s < best) {
        best = s;
        arg = row;
      }
    }
  }

  if (!live) return;
  const long long o = (long long)bin * B + qi;
  if constexpr (PACKED) {
    out_val[o] = gbnns::tc_key_value<kPackedSel<EPI>>(arg, mask);
    out_idx[o] = (int)(row0 + (arg & mask));
  } else {
    out_val[o] = best;
    out_idx[o] = (int)(row0 + arg);
  }
}

// ---- K1 on the tensor cores: bf16, fp16 and int8 at d in {16, 32, 64,
// 128}, bins a multiple of 16 rows. The loop is gbnns::tc_scan_bin
// (common.cuh); K1 gives it addvec, its key (the (min, row) pair, or the
// flipped key when PACKED, the raw key when also shifted), its epilogue
// (bf16 and fp16 only past kEpiPrescaled: the factor on the query
// fragments, and the shift added to each score) and D elements of KIND a
// row: KS k-slabs of 32 bytes, int8 at d = 16 zero-padding its row to 32
// bytes.
template <int D, int KIND>
struct ScanTc {
  static constexpr int kRowBytes = D * (KIND == kInt8 ? 1 : 2);
  static constexpr int KS = (kRowBytes + 31) / 32;
  using S = gbnns::TcShape<KS>;
};

template <int D, int KIND, bool PACKED, int EPI>
__global__ void __launch_bounds__(gbnns::kTcThreads, 2)
binned_scan_tc_kernel(const void* __restrict__ q_ptr,
                      const void* __restrict__ x_ptr,
                      const float* __restrict__ addvec,
                      const float* __restrict__ alpha,
                      float* __restrict__ out_val, int* __restrict__ out_idx,
                      int B, int bin_size, int idx_bits, int q_tiles,
                      float qscale) {
  using T = ScanTc<D, KIND>;
  constexpr int kStage = T::S::kChunk * T::S::kPitch;
  __shared__ __align__(16) unsigned char xs[2 * kStage];
  __shared__ __align__(16) float adds[2 * T::S::kChunk];
  constexpr int kSel = PACKED ? kPackedSel<EPI> : gbnns::kSelMin;
  gbnns::tc_scan_bin<KIND, T::KS, kSel, true, 16, EPI>(
      xs, kStage, adds, q_ptr, x_ptr, addvec, alpha, out_val, out_idx, B,
      bin_size, idx_bits, q_tiles, T::kRowBytes, T::KS, false, T::S::kPitch,
      qscale);
}

// LAUNCH(KIND, PACKED) for the runtime packed flag; int8 scans take
// kEpiPrescaled only.
#define GBNNS_PACKED(LAUNCH, KI)                                            \
  do {                                                                      \
    if constexpr (KI == kInt8 && EPI != kEpiPrescaled) {                    \
      return cudaErrorInvalidValue;                                         \
    } else {                                                                \
      if (packed) LAUNCH(KI, true); else LAUNCH(KI, false);                 \
    }                                                                       \
  } while (0)

template <int D, int EPI>
cudaError_t launch_scan_tc(const void* q, const void* x, const float* addvec,
                           const float* alpha, float* out_val, int* out_idx,
                           int B, int n_bins, int bin_size, int idx_bits,
                           int kind, bool packed, float qscale,
                           cudaStream_t stream) {
#define GBNNS_TC(KI, PK)                                                    \
  do {                                                                      \
    const int q_tiles =                                                     \
        gbnns::tc_query_tiles<ScanTc<D, KI>::KS>(B);                        \
    binned_scan_tc_kernel<D, KI, PK, EPI>                                   \
        <<<(unsigned)((long long)n_bins * q_tiles), gbnns::kTcThreads, 0,   \
           stream>>>(q, x, addvec, alpha, out_val, out_idx, B, bin_size,    \
                     idx_bits, q_tiles, qscale);                            \
  } while (0)
  switch (kind) {
    case kBf16:
      GBNNS_PACKED(GBNNS_TC, kBf16);
      break;
    case kF16:
      GBNNS_PACKED(GBNNS_TC, kF16);
      break;
    case kInt8:
      GBNNS_PACKED(GBNNS_TC, kInt8);
      break;
    default:
      return cudaErrorInvalidValue;  // f32 runs on the CUDA cores
  }
#undef GBNNS_TC
  return cudaGetLastError();
}

// D = 0 selects binned_scan_wide_kernel.
template <int D, int EPI>
cudaError_t launch_scan(const void* q, const void* x, const float* addvec,
                        const float* alpha, float* out_val, int* out_idx,
                        int B, int d, int n_bins, int bin_size, int idx_bits,
                        int kind, bool packed, float qscale,
                        cudaStream_t stream) {
  constexpr int per_block = kScanThreads * (D == 0 ? 1 : 128 / (D ? D : 1));
  const dim3 grid(n_bins, (B + per_block - 1) / per_block);
  const dim3 block(kScanThreads);
#define GBNNS_SCAN(KI, PK)                                                  \
  do {                                                                      \
    if constexpr (D == 0)                                                   \
      binned_scan_wide_kernel<KI, PK, EPI><<<grid, block, 0, stream>>>(     \
          q, x, addvec, alpha, out_val, out_idx, B, d, bin_size, idx_bits,  \
          qscale);                                                          \
    else                                                                    \
      binned_scan_kernel<D, KI, PK, EPI><<<grid, block, 0, stream>>>(       \
          q, x, addvec, alpha, out_val, out_idx, B, bin_size, idx_bits,     \
          qscale);                                                          \
  } while (0)
  switch (kind) {
    case kBf16:
      GBNNS_PACKED(GBNNS_SCAN, kBf16);
      break;
    case kInt8:
      GBNNS_PACKED(GBNNS_SCAN, kInt8);
      break;
    case kF32:
      GBNNS_PACKED(GBNNS_SCAN, kF32);
      break;
    case kF16:
      GBNNS_PACKED(GBNNS_SCAN, kF16);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef GBNNS_SCAN
#undef GBNNS_PACKED
  return cudaGetLastError();
}

// K1 with epilogue EPI: the kernel that kind, d, bin_size, packed and the
// route (tensor_cores) name; cudaErrorInvalidValue for one that does not
// exist. `qs` is alpha (int8) or qshift (kEpiShifted).
template <int EPI>
cudaError_t launch_binned_scan(const void* q, const void* x,
                               const float* addvec, const float* qs,
                               float* out_val, int* out_idx, int B, int d,
                               int n_bins, int bin_size, int idx_bits,
                               int kind, bool packed, bool tensor_cores,
                               float qscale, cudaStream_t s) {
  if (tensor_cores) {
    if (kind == kF32 || bin_size % gbnns::kTcRowTile != 0)
      return cudaErrorInvalidValue;
#define GBNNS_LAUNCH_TC(DD)                                                 \
  launch_scan_tc<DD, EPI>(q, x, addvec, qs, out_val, out_idx, B, n_bins,    \
                          bin_size, idx_bits, kind, packed, qscale, s)
    switch (d) {
      case 16: return GBNNS_LAUNCH_TC(16);
      case 32: return GBNNS_LAUNCH_TC(32);
      case 64: return GBNNS_LAUNCH_TC(64);
      case 128: return GBNNS_LAUNCH_TC(128);
      default:
        return gbnns::launch_binned_scan_wide(
            EPI, q, x, addvec, qs, out_val, out_idx, B, d, n_bins, bin_size,
            idx_bits, kind, packed, qscale, s);
    }
#undef GBNNS_LAUNCH_TC
  }
#define GBNNS_LAUNCH(DD)                                                   \
  launch_scan<DD, EPI>(q, x, addvec, qs, out_val, out_idx, B, d, n_bins,   \
                       bin_size, idx_bits, kind, packed, qscale, s)
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

}  // namespace

// Device helpers shared by the scan kernels (scan_topk.cu, gated_topm.cu,
// shifted_scan.cu, distance_topk.cu):
// the element kinds of the C interfaces, the IEEE-f32 total-order flip, the
// exact widening of 16-bit floats to f32, inline-PTX wrappers of the
// sm_80+ warp-level tensor-core product (mma.sync), ldmatrix and cp.async,
// and the bin loop of the tensor-core scans K1 and T3 (tc_scan_bin).
// Plain CUDA: no PyTorch header and no template library.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gbnns {

// Element type of a scan's query and corpus (the `kind` of the C API).
enum ScanKind { kBf16 = 0, kInt8 = 1, kF32 = 2, kF16 = 3 };

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

__device__ __forceinline__ float f16_lo(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
}

__device__ __forceinline__ float f16_hi(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}

// One 16-byte group of eight bf16 (KIND kBf16) or fp16 (kF16) values ->
// eight floats (exact).
template <int KIND>
__device__ __forceinline__ void half8_to_f32(uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (KIND == kF16) {
      f[2 * k] = f16_lo(w[k]);
      f[2 * k + 1] = f16_hi(w[k]);
    } else {
      f[2 * k] = bf16_lo(w[k]);
      f[2 * k + 1] = bf16_hi(w[k]);
    }
  }
}

// One 8-byte group of four bf16 (KIND kBf16) or fp16 (kF16) values -> four
// floats (exact).
template <int KIND>
__device__ __forceinline__ float4 half4_to_f32(uint2 v) {
  if constexpr (KIND == kF16)
    return make_float4(f16_lo(v.x), f16_hi(v.x), f16_lo(v.y), f16_hi(v.y));
  else
    return make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
}

// ---- tensor cores: mma.sync fragments (PTX ISA, "warp-level matrix
// fragments"). Lane l has group g = l / 4 and thread-in-group t = l % 4.
// m16n8k16 (bf16, fp16): A (16 x 16, row-major) a0 = A[g][2t..2t+1],
// a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; B (16 x 8,
// column-major) b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]; C/D (16 x 8)
// c0, c1 = C[g][2t], C[g][2t+1], c2, c3 = C[g+8][2t], C[g+8][2t+1].
// m16n8k8 (bf16, fp16) takes a0, a1 and b0 of the same layout. m16n8k32
// (s8) is the same layout with four int8 values to a register: a0 =
// A[g][4t..4t+3], a1 = A[g+8][4t..], a2 = A[g][16+4t..], a3 = A[g+8][16+4t..],
// b0 = B[4t..4t+3][g], b1 = B[16+4t..][g]. In bytes the two k16/k32
// layouts agree: a k-slab of 32 bytes, register words at byte 4t and 16+4t.

// D = A * B + C, bf16 (KIND kBf16) or fp16 (kF16) inputs, f32 sums.
template <int KIND>
__device__ __forceinline__ void mma_k16(float* d, const uint32_t* a,
                                        uint32_t b0, uint32_t b1,
                                        const float* c) {
  if constexpr (KIND == kF16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// D = A * B + C over a k of 8 (a width tail): a0, a1 and b0 only.
template <int KIND>
__device__ __forceinline__ void mma_k8(float* d, uint32_t a0, uint32_t a1,
                                       uint32_t b0, const float* c) {
  if constexpr (KIND == kF16)
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a0), "r"(a1), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]),
          "f"(c[3]));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a0), "r"(a1), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]),
          "f"(c[3]));
}

// D = A * B + C, int8 inputs, exact int32 sums.
__device__ __forceinline__ void mma_s8_k32(int* d, const uint32_t* a,
                                           uint32_t b0, uint32_t b1,
                                           const int* c) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 and receives row l / 4, word l % 4 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two 8 x 8 b16 matrices (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// Asynchronous global -> shared copies of 16 (cached in L2 only) or 8
// bytes, their commit and wait.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- one bin of a tensor-core scan: K1 (binned_scan_tc_kernel,
// scan_topk.cu) and T3 (shifted_scan_tc_kernel, shifted_scan.cu) are this
// loop with their own key and width.
constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRowTile = 16;  // mma.sync's M: the rows of one product

// KS k-slabs of 32 bytes held as query fragments (one k16 bf16/fp16 or one
// k32 int8 product each), NT n-tiles of 8 queries a warp, so a lane holds
// 2 * NT * KS <= 32 registers of them; kPitch the widest shared row and
// kChunk rows a pipeline stage (<= 10 KB).
template <int KS>
struct TcShape {
  // scan_topk.tc_warp_queries mirrors 8 * NT (gbnns_gated_warp_queries
  // reports it, and a card test holds the two equal): edit both together
  static constexpr int NT = KS <= 2 ? 8 : 16 / KS;
  static constexpr int kPitch = KS * 32 + 16;
  static constexpr int kChunk = KS <= 2 ? 128 : 256 / KS;
  static constexpr int kQueries = kTcWarps * 8 * NT;  // a block
};

// Shared row pitch for rows of `bytes` (a multiple of 16): an odd multiple
// of 16 bytes, so an ldmatrix of 8 rows of 16 bytes hits 8 distinct 4-bank
// groups (80 bytes for 32 or 36 bf16, 48 for 32 int8).
__host__ __device__ constexpr int tc_pitch(int bytes) {
  return (bytes / 16) % 2 == 1 ? bytes : bytes + 16;
}

// int8 sums become floats exactly with one add: the mma starts from
// kMagic (1.5 * 2^23 as f32 bits), so the int32 result read as f32 is
// 1.5 * 2^23 + acc, exact while |acc| <= 2^22 (d <= 256 at |x|, |q| <= 128).
constexpr int kMagic = 0x4B400000;
constexpr float kMagicF = 12582912.0f;

// What a bin keeps per query: kSelMin the (min, lower row) pair (K1
// unpacked); kSelFlip the key (flip(bits) & ~mask) | row and its integer
// min (K1 packed); kSelRaw the key (bits & ~mask) | row with no flip (T3,
// and K1 packed with a per-query shift: the scores are >= 0 but for
// rounding, and among negative residues the raw-bits order is the Pallas
// kernels').
enum TcSelect { kSelMin = 0, kSelFlip = 1, kSelRaw = 2 };

// What a K1 scan adds to its product (T1's epilogues). kEpiPrescaled: the
// corpus carries the distance scale (stored -2x or -x) or, for int8, the
// per-query alpha does. kEpiScaled: the query is multiplied by `qscale`
// (-2 for l2, -1 for ip and angular, 1 for a prescaled corpus) once, as
// it is loaded: exact for a power of two, and no work per score.
// kEpiShifted: kEpiScaled, then the query's shift qshift[q] is added to
// every one of its scores before the selection, and a packed key takes
// the raw bits (kSelRaw), as T1's shifted mode does.
enum ScanEpilogue { kEpiPrescaled = 0, kEpiScaled = 1, kEpiShifted = 2 };

// Two bf16 (KIND kBf16) or fp16 (kF16) values of a register word, each
// times s: exact for s = +-1 and +-2, but where the product leaves the
// type's range.
template <int KIND>
__device__ __forceinline__ uint32_t scale_half2(uint32_t w, float s) {
  if constexpr (KIND == kF16)
    return (uint32_t)__half_as_ushort(__float2half_rn(f16_lo(w) * s)) |
           ((uint32_t)__half_as_ushort(__float2half_rn(f16_hi(w) * s)) << 16);
  else  // the f32 product of a bf16 value by s has 16 zero low bits
    return (__float_as_uint(bf16_lo(w) * s) >> 16) |
           (__float_as_uint(bf16_hi(w) * s) & 0xFFFF0000u);
}

template <int SEL>
__device__ __forceinline__ int tc_key(float s, int mask, int row) {
  const int b = __float_as_int(s);
  return ((SEL == kSelFlip ? flip_bits(b) : b) & ~mask) | row;
}

// The score a key of SEL (kSelFlip or kSelRaw) stands for: its high bits.
template <int SEL>
__device__ __forceinline__ float tc_key_value(int key, int mask) {
  const int v = key & ~mask;
  return __int_as_float(SEL == kSelFlip ? flip_bits(v) : v);
}

// One block of a tensor-core scan: bin blockIdx.x / q_tiles and the
// kQueries queries of tile blockIdx.x % q_tiles (consecutive blocks share
// a bin, so its rows come from L2). Queries (B, row_bytes) live in
// registers as mma B fragments for the whole bin; the bin's rows stream
// through a two-stage cp.async ring (COPY-byte copies: 16, or 8 for rows
// that are not a multiple of 16 bytes) into `xs` (2 * stage_bytes, rows P
// bytes apart) and reach the tensor cores through ldmatrix as A fragments,
// 16 rows at a time: nk k-slabs (m16n8k16, or m16n8k32 for int8), then one
// m16n8k8 over 8 more columns when `tail`; columns past row_bytes are
// zeroed once. ADDVEC stages addvec beside the rows into `adds` (2 *
// kChunk) and starts the f32 sum from it (D = A.B + addvec: one more term
// in a sum whose order differs from a plain matmul anyway); int8 starts
// from kMagic and adds addvec after, as __fadd_rn(a, __fmul_rn(acc,
// alpha)). Each lane then holds the scores of rows g and g + 8 for queries
// 2t and 2t + 1 of every n-tile and folds them at once into its running
// selection (kSelMin: strict <, rows in increasing order; keys: one
// three-way integer min (DPX) a row pair); at the bin's end three
// xor-shuffles merge the 8 groups (kSelMin compares (value, row) as a
// pair, so ties go to the lower row), and group g writes n-tile g. No
// score leaves the registers. K1 passes compile-time widths, which fold.
// EPI (K1's epilogue, bf16 and fp16 only past kEpiPrescaled): kEpiScaled
// multiplies the query fragments by qscale as they are loaded; kEpiShifted
// also reads the query's shift from `alpha` and adds it to each score
// after the product. T3 and K1's prescaled kernels take kEpiPrescaled,
// which adds no code.
template <int KIND, int KS, int SEL, bool ADDVEC, int COPY,
          int EPI = kEpiPrescaled>
__device__ __forceinline__ void tc_scan_bin(
    unsigned char* xs, int stage_bytes, float* adds, const void* q_ptr,
    const void* x_ptr, const float* addvec, const float* alpha,
    float* out_val, int* out_idx, int B, int bin_size, int idx_bits,
    int q_tiles, int row_bytes, int nk, bool tail, int P,
    float qscale = 1.f) {
  using S = TcShape<KS>;
  constexpr int NT = S::NT, CH = S::kChunk;
  constexpr bool QUANT = KIND == kInt8;
  constexpr bool SHIFT = EPI == kEpiShifted;
  static_assert(!QUANT || EPI == kEpiPrescaled,
                "int8 scores take their scale from alpha");
  const int bin = blockIdx.x / q_tiles;
  const int qt = blockIdx.x - bin * q_tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long row0 = (long long)bin * bin_size;
  const int mask = (1 << idx_bits) - 1;
  const int qbase = qt * S::kQueries + (tid >> 5) * 8 * NT;

  if (row_bytes < nk * 32 + (tail ? 16 : 0)) {  // columns no copy fills
    for (int i = tid; i < 2 * stage_bytes / 16; i += kTcThreads)
      reinterpret_cast<uint4*>(xs)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();  // before any copy lands in the rows
  }

  // B fragments: query n = qbase + 8 nt + g, bytes 4t and 16 + 4t of each
  // k-slab and 4t of the tail; queries past B and bytes past the row are 0
  uint32_t qb[NT][KS][2];
  uint32_t qtl[NT];
  float al[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = qbase + nt * 8 + g;
    const unsigned char* qrow =
        static_cast<const unsigned char*>(q_ptr) + (long long)n * row_bytes;
    auto word = [&](int byte) -> uint32_t {
      return (n < B && byte < row_bytes)
                 ? *reinterpret_cast<const uint32_t*>(qrow + byte)
                 : 0u;
    };
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) qb[nt][ks][h] = word(ks * 32 + h * 16 + 4 * t);
    qtl[nt] = word(nk * 32 + 4 * t);  // past the row (0) when no tail
    if constexpr (EPI != kEpiPrescaled) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          qb[nt][ks][h] = scale_half2<KIND>(qb[nt][ks][h], qscale);
      qtl[nt] = scale_half2<KIND>(qtl[nt], qscale);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qi = qbase + nt * 8 + 2 * t + j;
      al[nt][j] = ((QUANT || SHIFT) && qi < B) ? alpha[qi] : 0.f;
    }
  }

  float best[NT][2];
  int arg[NT][2];  // keys: the running key
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      best[nt][j] = __int_as_float(0x7F800000);  // +inf
      arg[nt][j] = SEL == kSelMin ? 0 : kIntMax;
    }

  // rows [t0, t0 + cnt) of the bin (and their addvec) into stage buf
  auto stage = [&](int buf, int t0, int cnt) {
    const unsigned char* src = static_cast<const unsigned char*>(x_ptr) +
                               (row0 + t0) * (long long)row_bytes;
    const uint32_t dst = smem_addr(xs + buf * stage_bytes);
    const int pieces = row_bytes / COPY;
    for (int i = tid; i < cnt * pieces; i += kTcThreads) {
      const int r = i / pieces;
      if constexpr (COPY == 16)
        cp_async16(dst + r * P + (i - r * pieces) * 16,
                   src + (long long)i * 16);
      else
        cp_async8(dst + r * P + (i - r * pieces) * 8, src + (long long)i * 8);
    }
    if constexpr (ADDVEC) {
      const uint32_t adst = smem_addr(adds + buf * CH);
      for (int i = tid; i < cnt / 4; i += kTcThreads)
        cp_async16(adst + 16 * i, addvec + row0 + t0 + 4 * i);
    }
    cp_async_commit();
  };

  // ldmatrix lanes: 0-7 rows 0-7, 8-15 rows 8-15 (bytes 0-15 of the
  // slab), 16-31 the same rows at bytes 16-31 (x4 only)
  const uint32_t lane_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 16;
  const int n_chunks = (bin_size + CH - 1) / CH;
  stage(0, 0, min(CH, bin_size));
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * CH;
    const int cnt = min(CH, bin_size - t0);
    if (c + 1 < n_chunks) {
      stage((c + 1) & 1, t0 + CH, min(CH, bin_size - t0 - CH));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage c is in shared memory for every warp
    const uint32_t base = smem_addr(xs + (c & 1) * stage_bytes) + lane_off;
#pragma unroll 2
    for (int m = 0; m < cnt / kTcRowTile; ++m) {
      const uint32_t tile = base + m * kTcRowTile * P;
      uint32_t a[KS][4];
      uint32_t at[2] = {0u, 0u};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        if (ks < nk) ldmatrix_x4(a[ks], tile + ks * 32);
      if (tail) ldmatrix_x2(at, tile + nk * 32);
      const int r_lo = t0 + m * kTcRowTile + g;  // rows of c0-c1; c2-c3 + 8
      float a_lo = 0.f, a_hi = 0.f;
      if constexpr (ADDVEC) {
        a_lo = adds[(c & 1) * CH + m * kTcRowTile + g];
        a_hi = adds[(c & 1) * CH + m * kTcRowTile + g + 8];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float s[4];
        if constexpr (QUANT) {
          int acc[4] = {kMagic, kMagic, kMagic, kMagic};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            if (ks < nk)
              mma_s8_k32(acc, a[ks], qb[nt][ks][0], qb[nt][ks][1], acc);
#pragma unroll
          for (int e = 0; e < 4; ++e)  // mul then add, each rounded: no FMA
            s[e] = __fadd_rn(e < 2 ? a_lo : a_hi,
                             __fmul_rn(__fsub_rn(__int_as_float(acc[e]),
                                                 kMagicF),
                                       al[nt][e & 1]));
        } else {
          s[0] = s[1] = a_lo;
          s[2] = s[3] = a_hi;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            if (ks < nk)
              mma_k16<KIND>(s, a[ks], qb[nt][ks][0], qb[nt][ks][1], s);
          if (tail) mma_k8<KIND>(s, at[0], at[1], qtl[nt], s);
          if constexpr (SHIFT) {
#pragma unroll
            for (int e = 0; e < 4; ++e)  // one add a score
              s[e] = __fadd_rn(s[e], al[nt][e & 1]);
          }
        }
        if constexpr (SEL == kSelMin) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // row g before row g + 8
            const int j = e & 1;
            if (s[e] < best[nt][j]) {
              best[nt][j] = s[e];
              arg[nt][j] = r_lo + (e >> 1) * 8;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)  // one three-way min (DPX) a row pair
            arg[nt][j] = __vimin3_s32(arg[nt][j],
                                      tc_key<SEL>(s[j], mask, r_lo),
                                      tc_key<SEL>(s[j + 2], mask, r_lo + 8));
        }
      }
    }
    __syncthreads();  // stage c is consumed before it is refilled
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // the 8 groups g
        if constexpr (SEL == kSelMin) {
          const float ov = __shfl_xor_sync(0xFFFFFFFFu, best[nt][j], off);
          const int orow = __shfl_xor_sync(0xFFFFFFFFu, arg[nt][j], off);
          if (ov < best[nt][j] || (ov == best[nt][j] && orow < arg[nt][j])) {
            best[nt][j] = ov;
            arg[nt][j] = orow;
          }
        } else {
          arg[nt][j] = min(arg[nt][j],
                           __shfl_xor_sync(0xFFFFFFFFu, arg[nt][j], off));
        }
      }
  // every group holds the merged winners: group g writes n-tile g
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt != g) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qi = qbase + nt * 8 + 2 * t + j;
      if (qi >= B) continue;
      const long long o = (long long)bin * B + qi;
      if constexpr (SEL == kSelMin) {
        out_val[o] = best[nt][j];
        out_idx[o] = (int)(row0 + arg[nt][j]);
      } else {
        out_val[o] = tc_key_value<SEL>(arg[nt][j], mask);
        out_idx[o] = (int)(row0 + (arg[nt][j] & mask));
      }
    }
  }
}

// Blocks of a tensor-core scan: n_bins * q_tiles, query tiles of
// TcShape<KS>::kQueries.
template <int KS>
inline int tc_query_tiles(int B) {
  return (B + TcShape<KS>::kQueries - 1) / TcShape<KS>::kQueries;
}

}  // namespace gbnns

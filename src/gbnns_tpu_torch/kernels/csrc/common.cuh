// Device helpers shared by the scan kernels (scan_topk.cu, gated_topm.cu,
// shifted_scan.cu, distance_topk.cu):
// the element kinds of the C interfaces, the IEEE-f32 total-order flip, the
// exact widening of 16-bit floats to f32, inline-PTX wrappers of the
// sm_80+ warp-level tensor-core product (mma.sync), ldmatrix and cp.async,
// and the bin loops of the tensor-core scans K1 and T3: tc_scan_bin (query
// fragments in registers, d <= 128 for K1) and tc_scan_bin_wide (both
// operands staged in shared memory, any width).
// Plain CUDA: no PyTorch header and no template library.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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


// An asynchronous copy of `n` bytes (0 or 16, cached in L2 only) that
// zeroes the rest of the 16 bytes at dst: n = 0 writes zeros and reads
// nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src,
                                               int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// ---- Hopper's warpgroup MMA (wgmma, sm_90a): D (64 x 256, f32 or s32; 128
// registers a thread) = A (64 x 16 bf16/fp16, or 64 x 32 int8) * B^T (256
// x the same), both operands read from shared memory through descriptors,
// asynchronously. A warpgroup is 4 consecutive warps; warp w of it holds
// rows 16 w .. 16 w + 15 of D in mma.sync's C layout, n-tile j of 8
// columns in d[4 j .. 4 j + 3]: d[4 j + e] is row 16 w + g + 8 (e >> 1),
// column 8 j + 2 t + (e & 1). scale_d = 0 starts D at A * B^T.

__device__ __forceinline__ void wgmma_m64n256_bf16(float* d, uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256_f16(float* d, uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256_s8(int* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The executing thread's shared-memory writes (generic proxy: cp.async,
// st.shared) made visible to wgmma's reads (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads of an accumulator register across a
// wgmma_wait (the asm of the product names its registers, the wait not).
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// The descriptor of a K-major operand in the 128-byte swizzle: rows of 128
// bytes, 16-byte chunk c of row r stored at chunk c ^ (r % 8), 8-row atoms
// of 1,024 bytes one after another (the stride), the atoms 1,024-byte
// aligned. A k-step of 32 bytes within the row adds 2 (32 >> 4) to it.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// ---- one bin of the wide tensor-core scan: K1 at d > 128
// (binned_scan_wide_tc_kernel, scan_wide.cu) and T3 past
// SHIFTED_TC_MAX_WIDTH (shifted_scan_wide_tc_kernel, shifted_scan.cu).
// tc_scan_bin holds a warp's query fragments in registers for the whole
// bin: 2 * NT * KS <= 32 registers, so no warp is left at KS = 60 (d =
// 960). Here both operands are staged in shared memory and each bin runs
// as a GEMM main loop over the row's bytes on wgmma: a block of two
// warpgroups owns kWtQueries queries and walks its bin kWtRows rows at a
// time (warpgroup h the rows 64 h .. 64 h + 63 of each row block); for
// each row block the rows and the queries come kWtBytes bytes (64
// bf16/fp16 or 128 int8 columns) at a time through a kWtStages-deep
// cp.async ring, in the 128-byte swizzle that wgmma reads, and only after
// the row block's last stage do the accumulators go through the
// selection.
constexpr int kWtThreads = 256;   // two warpgroups
constexpr int kWtRows = 128;      // corpus rows a block step (BM)
constexpr int kWtQueries = 256;   // the block's query tile (BN)
constexpr int kWtBytes = 128;     // bytes of every row a pipeline stage
constexpr int kWtStages = 4;
constexpr int kWtStageBytes = (kWtRows + kWtQueries) * kWtBytes;
// the ring, one f32 a query of the tile (alpha or qshift), and room to
// align the ring to 1,024 bytes (the swizzle's atom)
constexpr int kWtSmem = kWtStages * kWtStageBytes + kWtQueries * 4 + 1024;

// Blocks of a wide tensor-core scan: n_bins * q_tiles.
inline int wt_query_tiles(int B) {
  return (B + kWtQueries - 1) / kWtQueries;
}

// A query's running winner of SEL (kSelMin as one 64-bit key: the flipped
// score's bits, offset to unsigned order, above the row, so that the
// unsigned min is the (value, lower row) min; the keys of kSelFlip and
// kSelRaw as they are).
template <int SEL>
using wt_key_t =
    typename std::conditional<SEL == kSelMin, unsigned long long, int>::type;

template <int SEL>
__device__ __forceinline__ wt_key_t<SEL> wt_key(float s, int mask, int row) {
  if constexpr (SEL == kSelMin) {
    s = __fadd_rn(s, 0.f);  // -0 -> +0: equal values, one key
    const unsigned hi = (unsigned)flip_bits(__float_as_int(s)) ^ 0x80000000u;
    return ((unsigned long long)hi << 32) | (unsigned)row;
  } else {
    return tc_key<SEL>(s, mask, row);
  }
}

// One block of a wide tensor-core scan: bin blockIdx.x / q_tiles and
// queries [kWtQueries * qt, +kWtQueries) of tile qt = blockIdx.x % q_tiles
// (consecutive blocks share a bin, so its rows come from L2 once the first
// block has read them). q (B, row_bytes) and x (n_pad, row_bytes) are rows
// of KIND (bf16 or fp16: d * 2 bytes; int8: d bytes); row_bytes a
// multiple of 16 (the copies' size). Columns past the row,
// rows past the bin and queries past B are zero-filled by the copies
// (cp_async_zfill), and zeros add nothing to a dot product; a k-step of 32
// bytes that holds no byte of the row is skipped. A stage is read by the
// products two iterations after its copies start, and refilled only once
// the products that read it are done (wgmma_wait<1> each iteration).
//
// After a row block's last product a thread holds, for rows r = 16 w + g
// and r + 8 of its warpgroup's 64 (w its warp in the warpgroup) and for
// the queries 8 j + 2 t + {0, 1} of the 32 n-tiles j, the sums, and turns
// each into a score,
//   ADDVEC:  fma(qscale, acc, addvec[row])  (= addvec + qscale * dot in one
//            rounding, as the plain version's add + scale * dots: qscale
//            is 1, -1 or -2, so the product is exact); int8:
//            addvec + float(acc) * alpha[q], each rounded (|acc| < 2^24
//            for d < 1040, so the convert is exact at any width this
//            takes, where kMagic's is exact only to |acc| <= 2^22);
//   else:    the dot product (T3's augmented score);
//   SHIFT:   + qshift[q],
// keys it (SEL as in tc_scan_bin; kSelMin as wt_key's 64-bit key, of the
// smaller of its two rows' scores, the lower row on a tie) and takes the
// min of its two rows. A reduce-scatter of three xor-shuffle
// steps over the 8 lane groups leaves group g the row block's min for
// n-tiles j = g (mod 8), which it folds into its running keys. At the
// bin's end the 8 warps leave their keys in shared memory and thread i
// merges query i's 8 (min of keys, so ties go to the lower row) and
// writes it. No score leaves the block.
template <int KIND, int SEL, bool ADDVEC, int EPI>
__device__ __forceinline__ void tc_scan_bin_wide(
    unsigned char* smem_raw, const void* q_ptr, const void* x_ptr,
    const float* addvec, const float* alpha, float* out_val, int* out_idx,
    int B, int bin_size, int idx_bits, int q_tiles, int row_bytes,
    float qscale) {
  constexpr bool QUANT = KIND == kInt8;
  constexpr bool SHIFT = EPI == kEpiShifted;
  static_assert(!QUANT || (EPI == kEpiPrescaled && ADDVEC),
                "int8 scores take their scale from alpha");
  using Acc = typename std::conditional<QUANT, int, float>::type;
  using Key = wt_key_t<SEL>;
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int bin = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - bin * q_tiles) * kWtQueries;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = tid >> 7;        // rows [64 wg, +64) of a row block
  const int wq = (tid >> 5) & 3;  // rows [16 wq, +16) of those
  const long long row0 = (long long)bin * bin_size;
  const int mask = (1 << idx_bits) - 1;
  const int n_k = (row_bytes + kWtBytes - 1) / kWtBytes;  // stages a block
  const int n_it = n_k * ((bin_size + kWtRows - 1) / kWtRows);
  float* qs = reinterpret_cast<float*>(smem + kWtStages * kWtStageBytes);
  if constexpr (QUANT || SHIFT) {  // read after the loop's first barrier
    for (int i = tid; i < kWtQueries; i += kWtThreads)
      qs[i] = q0 + i < B ? alpha[q0 + i] : 0.f;
  }

  // stage `it`: bytes [kb, kb + kWtBytes) of row block rb's rows, then of
  // the tile's queries, 384 rows of 128 bytes in the 128-byte swizzle. A
  // thread copies piece tid % kPieces of rows tid / kPieces + k * kPass,
  // k = 0, 1, ...: kPass is a multiple of 8, so its swizzled offset in
  // the row is one
  constexpr int kPieces = kWtBytes / 16;
  constexpr int kPass = kWtThreads / kPieces;
  const int pr = tid / kPieces;
  const int pb = (tid % kPieces) * 16;
  const int swz = ((pb >> 4) ^ (pr & 7)) << 4;
  auto stage = [&](int it) {
    const int rb = it / n_k;
    const int byte = (it - rb * n_k) * kWtBytes + pb;
    const int r0 = rb * kWtRows;
    const uint32_t dst = smem_addr(smem + (it % kWtStages) * kWtStageBytes) +
                         pr * kWtBytes + swz;
    const bool in_row = byte < row_bytes;
#pragma unroll
    for (int k = 0; k < (kWtRows + kWtQueries) / kPass; ++k) {
      const int r = pr + k * kPass;
      const unsigned char* src;
      bool live;
      if (k < kWtRows / kPass) {  // a corpus row
        live = in_row && r0 + r < bin_size;
        src = static_cast<const unsigned char*>(x_ptr) +
              (row0 + r0 + r) * (long long)row_bytes + byte;
      } else {  // a query
        const int qi = q0 + r - kWtRows;
        live = in_row && qi < B;
        src = static_cast<const unsigned char*>(q_ptr) +
              (long long)qi * row_bytes + byte;
      }
      cp_async_zfill(dst + k * kPass * kWtBytes, live ? src : x_ptr,
                     live ? 16 : 0);
    }
    cp_async_commit();
  };

  Acc acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  Key run[4][2];  // n-tiles 8 a + g, queries 2 t + jj of each
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      if constexpr (SEL == kSelMin)
        run[a][jj] = ~0ull;
      else
        run[a][jj] = kIntMax;
    }

  stage(0);
  if (n_it > 1)
    stage(1);
  else
    cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();  // stage it landed for every thread
    if (it + 2 < n_it)
      stage(it + 2);  // its buffer's products finished (wgmma_wait<1>)
    else
      cp_async_commit();  // an empty group keeps the wait counts
    const int rb = it / n_k;
    const int kb = (it - rb * n_k) * kWtBytes;
    const uint32_t base = smem_addr(smem + (it % kWtStages) * kWtStageBytes);
    const uint64_t da = wgmma_desc_sw128(base + wg * 64 * kWtBytes);
    const uint64_t db = wgmma_desc_sw128(base + kWtRows * kWtBytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kWtBytes / 32; ++ks) {
      if (kb + 32 * ks < row_bytes) {
        const int acc_in = (kb > 0 || ks > 0) ? 1 : 0;
        if constexpr (QUANT)
          wgmma_m64n256_s8(acc, da + 2 * ks, db + 2 * ks, acc_in);
        else if constexpr (KIND == kF16)
          wgmma_m64n256_f16(acc, da + 2 * ks, db + 2 * ks, acc_in);
        else
          wgmma_m64n256_bf16(acc, da + 2 * ks, db + 2 * ks, acc_in);
      }
    }
    wgmma_commit();
    if (kb + kWtBytes < row_bytes) {  // the row block goes on
      wgmma_wait<1>();
      continue;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_operand(acc[i]);

    const int rs = rb * kWtRows + wg * 64 + wq * 16;  // the warp's rows
    if (rs >= bin_size) continue;  // rows past the bin: no score
    const int r_lo = rs + g;
    float a_lo = 0.f, a_hi = 0.f;
    if constexpr (ADDVEC) {
      a_lo = __ldg(addvec + row0 + r_lo);
      a_hi = __ldg(addvec + row0 + r_lo + 8);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {  // n-tiles j = 8 a + c
      Key k[8][2];
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 8 * a + c;
          const float al = (QUANT || SHIFT) ? qs[8 * j + 2 * t + jj] : 0.f;
          float s[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows r_lo and r_lo + 8
            const Acc x = acc[4 * j + 2 * h + jj];
            const float add = h ? a_hi : a_lo;
            if constexpr (QUANT)  // mul then add, each rounded: no FMA
              s[h] = __fadd_rn(add, __fmul_rn(__int2float_rn(x), al));
            else if constexpr (ADDVEC)
              s[h] = __fmaf_rn(qscale, x, add);
            else
              s[h] = x;
            if constexpr (SHIFT) s[h] = __fadd_rn(s[h], al);
          }
          if constexpr (SEL == kSelMin) {  // row r_lo wins a tie
            const bool hi = s[1] < s[0];
            k[c][jj] =
                wt_key<SEL>(hi ? s[1] : s[0], mask, r_lo + (hi ? 8 : 0));
          } else {
            k[c][jj] = min(wt_key<SEL>(s[0], mask, r_lo),
                           wt_key<SEL>(s[1], mask, r_lo + 8));
          }
        }
      // reduce-scatter over the lane groups: at step s the groups with bit
      // s keep tiles c + s, the others c, and each takes the partner's
      // min for the tile it keeps; group g ends with tile c = g
#pragma unroll
      for (int step = 4; step >= 1; step >>= 1) {
        const bool up = (g & step) != 0;
#pragma unroll
        for (int c = 0; c < step; ++c)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const Key send = up ? k[c][jj] : k[c + step][jj];
            const Key keep = up ? k[c + step][jj] : k[c][jj];
            k[c][jj] = min(keep, __shfl_xor_sync(0xFFFFFFFFu, send, 4 * step));
          }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) run[a][jj] = min(run[a][jj], k[0][jj]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' keys meet there

  Key* part = reinterpret_cast<Key*>(smem);  // [8 warps][kWtQueries]
  const int w = tid >> 5;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      part[w * kWtQueries + 64 * a + 8 * g + 2 * t + jj] = run[a][jj];
  __syncthreads();
  for (int i = tid; i < kWtQueries; i += kWtThreads) {
    const int qi = q0 + i;
    if (qi >= B) continue;
    Key m = part[i];
    for (int p = 1; p < 8; ++p) m = min(m, part[p * kWtQueries + i]);
    const long long o = (long long)bin * B + qi;
    if constexpr (SEL == kSelMin) {
      out_val[o] = __int_as_float(
          flip_bits((int)((unsigned)(m >> 32) ^ 0x80000000u)));
      out_idx[o] = (int)(row0 + (int)(unsigned)m);
    } else {
      out_val[o] = tc_key_value<SEL>(m, mask);
      out_idx[o] = (int)(row0 + (m & mask));
    }
  }
}

}  // namespace gbnns

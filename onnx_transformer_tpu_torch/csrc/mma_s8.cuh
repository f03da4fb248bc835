// Device helpers shared by the int8 tensor-core kernels for Hopper (sm_90a):
// K5 (w8a8_gemm.cu), K1/K2 (w8a8_qrows.cu), K6/K7 (w4a8_qrows.cu) and
// K4/K8 (quant_gemm.cu).
//
// - cp.async 16-byte copies into shared memory, zero-filling when asked;
// - ldmatrix of four 8x8 b16 matrices, which for s8 operands gives the
//   A (16x32) and B (32x8, two n8 blocks) fragments of mma.m16n8k32;
// - mma.sync m16n8k32 s8.s8.s32;
// - sext_nibbles, the sign extension of packed int4 weights;
// - for K5, K1/K2 and K6/K7, the W staging and transpose: s8 mma wants
//   both operands K-major, and wq is [K,N], N-contiguous, as the JAX
//   package passes it.  Neither ldmatrix .trans (it moves b16 pairs) nor
//   TMA transposes bytes, so a raw [64, BN] W tile is copied as it is
//   (stage_w) and every thread of the CTA then transposes 4x4-byte blocks
//   with byte permutes into a K-major [BN, 64] tile that ldmatrix reads
//   (transpose_w).  Raw rows are grouped by k % 4 (raw_row), so the
//   transpose's stores are free of bank conflicts and its reads 2-way.
// - the same for packed-int4 W (uint8 [K/2, N], quant/core.pack_int4): a
//   raw tile of 32 packed rows (stage_w_int4, rows grouped by parity), whose
//   nibbles the transpose sign-extends to int8 before the same byte permutes
//   (transpose_w_int4).  No unpacked weight exists outside shared memory.
//   (K4/K8 skip the transpose pass: byte permutes of what ldmatrix .trans
//   reads from the raw tile give the K-major fragments, quant_gemm.cu.)
//
// A tile configuration C names BN (the W tile's columns), kWRow (its
// padded raw row, BN + 16 bytes) and kThreads (the CTA's threads).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;               // K bytes per tile: two k32 mma steps
constexpr int kRow = kBK + 16;        // padded shared row of a K-major tile
constexpr int kMaxSmem = 232448;      // the H100's opt-in shared memory per block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16x32 s8, row) * b (32x8 s8, col), int32 accumulators.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row k of a raw W tile ([64, BN] as stored) lies at raw_row(k): the rows
// are grouped by k % 4, so that the transpose's 4x4 blocks read from 16
// neighbouring rows at once (2-way bank conflicts, against 8-way or worse
// for rows in order).
template <class C>
__device__ __forceinline__ int raw_row(int k) {
  return ((k & 3) * (kBK / 4) + (k >> 2)) * C::kWRow;
}

// Copy the raw W tile wq[k0:k0+64, n0:n0+BN] into ws: cp.async when kVec
// (N % 16 == 0, 16-byte aligned base), else byte loads.  Rows past K and
// columns past N are zero, which adds nothing to the products.
template <class C, bool kVec>
__device__ __forceinline__ void stage_w(uint8_t* ws, const int8_t* __restrict__ wq, int n0,
                                        int k0, int K, int N) {
  const int tid = threadIdx.x;
  if (kVec) {
    constexpr int kWChunks = C::BN / 16;
    for (int c = tid; c < kBK * kWChunks; c += C::kThreads) {
      const int r = c / kWChunks, nc = (c % kWChunks) * 16;
      const int k = k0 + r, n = n0 + nc;
      const bool ok = k < K && n < N;
      cp_async16(smem_u32(ws + raw_row<C>(r) + nc), ok ? wq + (size_t)k * N + n : wq,
                 ok ? 16 : 0);
    }
  } else {
    for (int c = tid; c < kBK * C::BN; c += C::kThreads) {
      const int r = c / C::BN, nc = c % C::BN;
      const int k = k0 + r, n = n0 + nc;
      ws[raw_row<C>(r) + nc] = (k < K && n < N) ? static_cast<uint8_t>(wq[(size_t)k * N + n]) : 0;
    }
  }
}

// Four words a, b, c, d, each the bytes of 4 columns at k, k + 1, k + 2 and
// k + 3, become 4 words of those 4 consecutive k, one a column, stored at
// dst + j * kRow for column j of the K-major tile.
__device__ __forceinline__ void store_kquad(uint8_t* dst, uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140);   // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(a, b, 0x7362);   // a2 b2 a3 b3
  const uint32_t t2 = __byte_perm(c, d, 0x5140);
  const uint32_t t3 = __byte_perm(c, d, 0x7362);
  *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t2, 0x5410);            // column 0
  *reinterpret_cast<uint32_t*>(dst + kRow) = __byte_perm(t0, t2, 0x7632);     // column 1
  *reinterpret_cast<uint32_t*>(dst + 2 * kRow) = __byte_perm(t1, t3, 0x5410); // column 2
  *reinterpret_cast<uint32_t*>(dst + 3 * kRow) = __byte_perm(t1, t3, 0x7632); // column 3
}

// Raw W tile [64, BN] -> K-major [BN, 64]: each task turns a 4x4 block of
// bytes (4 k rows of 4 columns) into 4 words of 4 consecutive k.  The 16
// k blocks are the fastest task index, so a warp's stores fall in 32
// distinct banks.
template <class C>
__device__ __forceinline__ void transpose_w(const uint8_t* __restrict__ ws,
                                            uint8_t* __restrict__ bt) {
  constexpr int kQuads = kBK / 4;
  constexpr int kStep = kQuads * C::kWRow;   // raw_row(k + 1) - raw_row(k) within a block
  for (int task = threadIdx.x; task < kQuads * (C::BN / 4); task += C::kThreads) {
    const int kq = task % kQuads, cg = task / kQuads;
    const uint8_t* src = ws + raw_row<C>(4 * kq) + 4 * cg;
    store_kquad(bt + (4 * cg) * kRow + 4 * kq, *reinterpret_cast<const uint32_t*>(src),
                *reinterpret_cast<const uint32_t*>(src + kStep),
                *reinterpret_cast<const uint32_t*>(src + 2 * kStep),
                *reinterpret_cast<const uint32_t*>(src + 3 * kStep));
  }
}

// Packed-int4 W: byte p of a column holds k = 2p in its low nibble and
// k = 2p + 1 in its high one, both signed, so a W tile of 64 k is 32 packed
// rows.  Packed row p of a tile lies at packed_row(p), the rows grouped by
// parity: the transpose reads rows 2kq and 2kq + 1 for each k quad kq, 16
// quads from 16 neighbouring rows of each group (2-way bank conflicts, as
// raw_row gives the int8 tile).
template <class C>
__device__ __forceinline__ int packed_row(int p) {
  return ((p & 1) * (kBK / 4) + (p >> 1)) * C::kWRow;
}

// Copy the raw packed tile wp[k0/2:k0/2+32, n0:n0+BN] into ws, as stage_w
// does for int8 (K even: a packed row past K/2 holds no k of the tile).
template <class C, bool kVec>
__device__ __forceinline__ void stage_w_int4(uint8_t* ws, const uint8_t* __restrict__ wp,
                                             int n0, int k0, int K, int N) {
  constexpr int kRows = kBK / 2;
  const int tid = threadIdx.x;
  const int p0 = k0 / 2, KP = K / 2;
  if (kVec) {
    constexpr int kWChunks = C::BN / 16;
    for (int c = tid; c < kRows * kWChunks; c += C::kThreads) {
      const int r = c / kWChunks, nc = (c % kWChunks) * 16;
      const int p = p0 + r, n = n0 + nc;
      const bool ok = p < KP && n < N;
      cp_async16(smem_u32(ws + packed_row<C>(r) + nc), ok ? wp + (size_t)p * N + n : wp,
                 ok ? 16 : 0);
    }
  } else {
    for (int c = tid; c < kRows * C::BN; c += C::kThreads) {
      const int r = c / C::BN, nc = c % C::BN;
      const int p = p0 + r, n = n0 + nc;
      ws[packed_row<C>(r) + nc] = (p < KP && n < N) ? wp[(size_t)p * N + n] : 0;
    }
  }
}

// The low nibble of each byte of v as a sign-extended int8: (v ^ 8) & 15 is
// the nibble's value + 8 (0..15); adding 0x78 cannot carry out of a byte,
// and flipping bit 7 then subtracts 0x80, which leaves value + 8 + 0x78 -
// 0x80 = value (mod 256).
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  return (((v ^ 0x08080808u) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
}

// Raw packed tile [32, BN] -> K-major [BN, 64] int8, as transpose_w: for the
// k quad kq of 4 columns, P0 (packed row 2kq) holds k = 4kq and 4kq + 1,
// P1 (row 2kq + 1) k = 4kq + 2 and 4kq + 3.  Where K % 4 == 2 the last
// quad's P1 is zero, and zero nibbles add nothing.
template <class C>
__device__ __forceinline__ void transpose_w_int4(const uint8_t* __restrict__ ws,
                                                 uint8_t* __restrict__ bt) {
  constexpr int kQuads = kBK / 4;
  constexpr int kOdd = kQuads * C::kWRow;    // packed_row(2kq + 1) - packed_row(2kq)
  for (int task = threadIdx.x; task < kQuads * (C::BN / 4); task += C::kThreads) {
    const int kq = task % kQuads, cg = task / kQuads;
    const uint8_t* src = ws + packed_row<C>(2 * kq) + 4 * cg;
    const uint32_t p0 = *reinterpret_cast<const uint32_t*>(src);
    const uint32_t p1 = *reinterpret_cast<const uint32_t*>(src + kOdd);
    store_kquad(bt + (4 * cg) * kRow + 4 * kq, sext_nibbles(p0), sext_nibbles(p0 >> 4),
                sext_nibbles(p1), sext_nibbles(p1 >> 4));
  }
}

}  // namespace

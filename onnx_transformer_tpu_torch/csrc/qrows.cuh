// The body of the fused quantize-matmul kernels with a whole-row output
// scale, K1/K2 (w8a8_qrows.cu, int8 W) and K6/K7 (w4a8_qrows.cu, packed-int4
// W), for Hopper (sm_90a) on the tensor cores.  Each source defines its two
// kernels over qrows_body under its own names (so that a profile tells the
// four apart) and calls launch_rows with them.
//
// All four compute, for x f32 [M,K], the weights wq [K,N] (int8, or int4
// packed two to a byte, quant/core.pack_int4), sw and b f32 [N], K, N <=
// 2048 and any M >= 1:
//   sx  = max(absmax_k |x[m,k]|, 1e-5) / 127            (per token)
//   xq  = round_half_even(x / sx)                        (int8)
//   y   = float(xq @ wq) * (sx * sw[n]) + b[n]           (int32 accumulate)
//   sy  = max(absmax_n |y[m,n]|, 1e-5) / 127             (per token)
// K1/K6 write round(y / sy) * sy (f32 [M,N]); K2/K7 write round(y / sy) as
// int8 [M,N] and sy as f32 [M].  Every float step uses the _rn intrinsics
// and nothing is contracted into an FMA; int32 sums of int8 products and
// fmaxf over a row are exact in any order.  So the result is bit-equal to
// the plain PyTorch versions (ops/kernels/w8a8_matmul.py), whatever the
// tiling.
//
// Bound on the H100 SXM (3.35 TB/s, 1979 int8 TOP/s) at the main-path shape
// x [36864,512] x W [512,512]: memory.  K1 moves 151 MB (x read, f32 y
// written): 45 us; K2 moves 95 MB (int8 y written): 28 us; the 19.3 GOP of
// int8 products need 9.8 us at the tensor cores' peak.  K6/K7 move 128 KB
// less W.
//
// Design (B of the two that fit: the whole row of accumulators in
// registers).  The output scale needs the whole output row, so one CTA of
// 16 warps owns BM rows across all N columns and holds BM x N int32 sums in
// registers: BM x N <= 32,768, 64 per thread.  The configuration comes from
// the shape (ops/kernels/w8a8_matmul.plan_w8a8_qrows, passed in as `tile`
// with its shared-memory bytes, which the launch checks against its own):
//   tile 0: BM 64, N <= 512, warps 2 x 8 of 32 x 64   (the main path; int8
//           W: K <= 1344, packed W: every K)
//   tile 1: BM 32, N <= 512, warps 1 x 16 of 32 x 32  (int8 W, K > 1344)
//   tile 2: BM 32, N <= 1024, two chunks of 512 columns
//   tile 3: BM 16, N <= 2048, four chunks of 512 columns
// Phase A quantizes the CTA's x rows into a resident K-major int8 tile
// [BM][K + 16] in shared memory, which is the A operand of every product:
// each warp reads 1-4 of its rows at once, 16 bytes per lane with streaming
// loads (x is read from device memory once), takes the absmax by shuffles
// and writes 4 int8 per lane (xquant.cuh, quantize_x_rows, shared with
// K4/K8).  The first two W tiles are already in flight.
// Phase B walks K (and N in chunks of 512 columns where N > 512) in tiles
// of 64 through a 3-stage cp.async ring of raw W tiles ([64, 512] int8, or
// [32, 512] packed), each transposed in shared memory into a K-major int8
// tile (mma_s8.cuh, as K5 does; the packed nibbles are sign-extended on the
// way), and runs mma.sync m16n8k32 s8 from ldmatrix.  The epilogue scales
// the sums in registers, takes each row's absmax by quad shuffles and a
// [BM][warps] exchange in shared memory, and stages the quantized rows in
// the shared memory the loop no longer needs, so that the rows leave with
// 16-byte streaming stores.  K % 4 != 0, N % 16 != 0 or an unaligned base
// take the same kernel with scalar loads and stores.
//
// W re-read from L2: BM = 64 at the main shape, so the 576 CTAs read W (256
// KB int8, 128 KB packed) 576 times: 151 MB (75 MB) of L2 reads; no
// cluster.  One CTA per SM (512 threads, 64 sums each; 178 KB of shared
// memory with int8 W, 135 KB packed).
//
// What bounds it at the main shape (PERF.md): not the products.  A CTA runs
// its phases one after the other (x in from device memory, the K loop, the
// epilogue, the rows out), so device memory idles while the K loop runs and
// the tensor cores idle while x comes in, except as far as the CTAs of other
// SMs are in other phases; and the K loop moves more shared memory than the
// products need, since every warp reads its own A and B fragments by
// ldmatrix and every CTA copies and transposes all of W again.  A deeper W
// ring, a second K-major tile (transposing tile t + 1 while the products read
// tile t) and a K order rotated by CTA were tried and were no faster.
//
// What it still leaves on the table: wgmma fed by TMA (one warpgroup's
// product reads each operand from shared memory once, where mma.sync warps
// each read their own fragments); persistent CTAs with producer warps, so
// that one row block's x loads and W transposes overlap another's products
// and stores (576 CTAs are 4.4 waves of 132); a cluster sharing each W tile,
// or a K-major copy of W, to cut the per-CTA W traffic.

#pragma once

#include <type_traits>

#include "xquant.cuh"

namespace {

constexpr int kQThreads = 512;        // 16 warps
constexpr int kStages = 3;            // W ring depth
constexpr int kMaxKN = 2048;

// BM rows per CTA, N in CH chunks of BN = 512 columns, WARPS_M x (16 /
// WARPS_M) warps over each chunk; W int8 [K, N], or with PACKED packed int4
// uint8 [K/2, N] (mma_s8.cuh).
template <int BM_, int BN_, int CH_, int WARPS_M_, bool PACKED_>
struct QRows {
  static constexpr int BM = BM_, BN = BN_, CH = CH_;
  static constexpr bool kPacked = PACKED_;
  using W = std::conditional_t<PACKED_, uint8_t, int8_t>;
  static constexpr int kThreads = kQThreads, kWarps = kThreads / 32;
  static constexpr int kWarpsM = WARPS_M_, kWarpsN = kWarps / kWarpsM;
  static constexpr int WM = BM / kWarpsM, WN = BN / kWarpsN;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int NC = CH * BN;                   // output columns a CTA holds
  static constexpr int kWRow = BN + 16;                // padded raw W row
  static constexpr int kWRows = PACKED_ ? kBK / 2 : kBK;  // raw rows of a W tile
  static constexpr int kStage = kWRows * kWRow;        // one raw W tile
  // head: sx f32 [BM] and the row maxima f32 [BM][kWarpsN]
  static constexpr int kHead = (BM * 4 + BM * kWarpsN * 4 + 127) / 128 * 128;
  static constexpr int kYRow = NC + 8;                 // f32 output staging row, floats
  static constexpr int kQRow = NC + 16;                // int8 output staging row, bytes
  static_assert(WM % 16 == 0 && NI % 2 == 0, "warp tile: 16-row blocks, n8 pairs");
  static_assert(CH * MI * NI * 4 <= 64, "at most 64 sums per thread");

  // row stride of the resident int8 x tile: K padded to the K tile, + 16
  // bytes so that ldmatrix rows fall in distinct banks
  __host__ __device__ static int x_row(int K) { return (K + kBK - 1) / kBK * kBK + 16; }
  // dynamic shared memory: the head, then the loop's xq + W ring + K-major
  // W tile, which the output staging reuses after the loop
  __host__ __device__ static int smem(int K) {
    const int loop = BM * x_row(K) + kStages * kStage + BN * kRow;
    const int out = BM * kYRow * 4;
    return kHead + (loop > out ? loop : out);
  }
};

// The configurations, by the index that plan_w8a8_qrows returns.
template <bool P> using QTile0 = QRows<64, 512, 1, 2, P>;
template <bool P> using QTile1 = QRows<32, 512, 1, 1, P>;
template <bool P> using QTile2 = QRows<32, 512, 2, 1, P>;
template <bool P> using QTile3 = QRows<16, 512, 4, 1, P>;

// The W format's staging and transpose (mma_s8.cuh).
template <class C, bool kVec>
__device__ __forceinline__ void stage_tile(uint8_t* ws, const typename C::W* __restrict__ wq,
                                           int n0, int k0, int K, int N) {
  if constexpr (C::kPacked)
    stage_w_int4<C, kVec>(ws, wq, n0, k0, K, N);
  else
    stage_w<C, kVec>(ws, wq, n0, k0, K, N);
}

template <class C>
__device__ __forceinline__ void transpose_tile(const uint8_t* __restrict__ ws,
                                               uint8_t* __restrict__ bt) {
  if constexpr (C::kPacked)
    transpose_w_int4<C>(ws, bt);
  else
    transpose_w<C>(ws, bt);
}

template <class C, bool kQ8, bool kVec>
__device__ __forceinline__ void qrows_body(const float* __restrict__ x,
                                           const typename C::W* __restrict__ wq,
                                           const float* __restrict__ sw,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, int8_t* __restrict__ outq,
                                           float* __restrict__ outs, int M, int K, int N) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* sxs = reinterpret_cast<float*>(smem);
  float* red = sxs + C::BM;
  uint8_t* body = smem + C::kHead;
  const int XS = C::x_row(K);
  int8_t* xq = reinterpret_cast<int8_t*>(body);
  uint8_t* ring = body + C::BM * XS;
  uint8_t* bt = ring + kStages * C::kStage;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * C::BM;
  const int wm = (warp % C::kWarpsM) * C::WM;
  const int warp_n = warp / C::kWarpsM;
  const int wn = warp_n * C::WN;
  const int nk = (K + kBK - 1) / kBK;
  const int tiles = C::CH * nk;          // W tile t: chunk t / nk, K tile t % nk

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles)
      stage_tile<C, kVec>(ring + s * C::kStage, wq, (s / nk) * C::BN, (s % nk) * kBK, K, N);
    cp_async_commit();
  }

  quantize_x_rows<C, kVec>(x, xq, sxs, m0, M, K, XS);

  int acc[C::CH][C::MI][C::NI][4];
#pragma unroll
  for (int c = 0; c < C::CH; ++c)
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[c][i][j][r] = 0;

  // ldmatrix lane addresses: A rows (lane & 15), k half (lane >> 4); B
  // columns (lane & 7) + 8 * (lane >> 4), k half ((lane >> 3) & 1)
  const uint32_t a_base = smem_u32(xq) + (wm + (lane & 15)) * XS + (lane >> 4) * 16;
  const uint32_t b_base =
      smem_u32(bt) + (wn + (lane & 7) + ((lane >> 4) << 3)) * kRow + ((lane >> 3) & 1) * 16;

  int t = 0;
#pragma unroll
  for (int c = 0; c < C::CH; ++c) {
    for (int kt = 0; kt < nk; ++kt, ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // W tile t has landed (and xq); every warp is done with bt
      const int next = t + kStages - 1;
      if (next < tiles)
        stage_tile<C, kVec>(ring + (next % kStages) * C::kStage, wq, (next / nk) * C::BN,
                            (next % nk) * kBK, K, N);
      cp_async_commit();
      transpose_tile<C>(ring + (t % kStages) * C::kStage, bt);
      __syncthreads();   // the K-major W tile is complete
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        uint32_t a[C::MI][4];
        uint32_t b[C::NI][2];
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi)
          ldmatrix_x4(a_base + mi * 16 * XS + kt * kBK + kk * 32, a[mi][0], a[mi][1], a[mi][2],
                      a[mi][3]);
#pragma unroll
        for (int np = 0; np < C::NI / 2; ++np)
          ldmatrix_x4(b_base + np * 16 * kRow + kk * 32, b[2 * np][0], b[2 * np][1],
                      b[2 * np + 1][0], b[2 * np + 1][1]);
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < C::NI; ++ni) mma_s8(acc[c][mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
  }

  // Accumulator fragment of lane (g = lane / 4, t2 = 2 * (lane % 4)): rows g
  // and g + 8 of each 16x8 block, columns t2 and t2 + 1.  y replaces the
  // sums in place (as float bits); columns past N are 0 and never stored.
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  float sxr[C::MI][2], am[C::MI][2];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sxr[mi][h] = sxs[wm + mi * 16 + g + h * 8];
      am[mi][h] = 0.f;
    }
#pragma unroll
  for (int c = 0; c < C::CH; ++c)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
      const int n = c * C::BN + wn + ni * 8 + t2;
      const float sw0 = n < N ? sw[n] : 0.f, b0 = n < N ? bias[n] : 0.f;
      const float sw1 = n + 1 < N ? sw[n + 1] : 0.f, b1 = n + 1 < N ? bias[n + 1] : 0.f;
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int* p = acc[c][mi][ni] + 2 * h;
          const float y0 =
              n < N ? __fadd_rn(__fmul_rn(__int2float_rn(p[0]), __fmul_rn(sxr[mi][h], sw0)), b0)
                    : 0.f;
          const float y1 =
              n + 1 < N
                  ? __fadd_rn(__fmul_rn(__int2float_rn(p[1]), __fmul_rn(sxr[mi][h], sw1)), b1)
                  : 0.f;
          p[0] = __float_as_int(y0);
          p[1] = __float_as_int(y1);
          am[mi][h] = fmaxf(am[mi][h], fmaxf(fabsf(y0), fabsf(y1)));
        }
    }
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = am[mi][h];
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
      if ((lane & 3) == 0) red[(wm + mi * 16 + g + h * 8) * C::kWarpsN + warp_n] = a;
    }
  __syncthreads();   // every warp is past the K loop: xq, the ring and bt are free

  float sy[C::MI][2];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + mi * 16 + g + h * 8;
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < C::kWarpsN; ++j) a = fmaxf(a, red[r * C::kWarpsN + j]);
      sy[mi][h] = __fdiv_rn(fmaxf(a, kScaleFloor), kQmax);
      if (kQ8 && warp_n == 0 && (lane & 3) == 0 && m0 + r < M) outs[m0 + r] = sy[mi][h];
    }

  // the quantized rows, staged in shared memory
#pragma unroll
  for (int c = 0; c < C::CH; ++c)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
      const int n = c * C::BN + wn + ni * 8 + t2;
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + mi * 16 + g + h * 8;
          const float y0 = __int_as_float(acc[c][mi][ni][2 * h]);
          const float y1 = __int_as_float(acc[c][mi][ni][2 * h + 1]);
          const float s = sy[mi][h];
          if (kQ8) {
            *reinterpret_cast<char2*>(body + r * C::kQRow + n) =
                make_char2(static_cast<signed char>(__float2int_rn(__fdiv_rn(y0, s))),
                           static_cast<signed char>(__float2int_rn(__fdiv_rn(y1, s))));
          } else {
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(body) + r * C::kYRow + n) =
                make_float2(__fmul_rn(rintf(__fdiv_rn(y0, s)), s),
                            __fmul_rn(rintf(__fdiv_rn(y1, s)), s));
          }
        }
    }
  __syncthreads();

  // the rows leave in 16-byte streaming stores (scalar ones when !kVec)
  const int rows = min(C::BM, M - m0);
  if (kQ8) {
    const int8_t* st = reinterpret_cast<const int8_t*>(body);
    int8_t* o = outq + (size_t)m0 * N;
    if (kVec) {
      const int cpr = N / 16;
      for (int i = tid; i < rows * cpr; i += C::kThreads) {
        const int r = i / cpr, c16 = i - r * cpr;
        __stcs(reinterpret_cast<int4*>(o + (size_t)r * N) + c16,
               *reinterpret_cast<const int4*>(st + r * C::kQRow + 16 * c16));
      }
    } else {
      for (int i = tid; i < rows * N; i += C::kThreads) {
        const int r = i / N, n = i - r * N;
        o[(size_t)r * N + n] = st[r * C::kQRow + n];
      }
    }
  } else {
    const float* st = reinterpret_cast<const float*>(body);
    float* o = out + (size_t)m0 * N;
    if (kVec) {
      const int cpr = N / 4;
      for (int i = tid; i < rows * cpr; i += C::kThreads) {
        const int r = i / cpr, c4 = i - r * cpr;
        __stcs(reinterpret_cast<float4*>(o + (size_t)r * N) + c4,
               *reinterpret_cast<const float4*>(st + r * C::kYRow + 4 * c4));
      }
    } else {
      for (int i = tid; i < rows * N; i += C::kThreads) {
        const int r = i / N, n = i - r * N;
        __stcs(o + (size_t)r * N + n, st[r * C::kYRow + n]);
      }
    }
  }
}

// Ks names a source's kernels: Ks::kPacked (the W format) and
// Ks::get<C, kQ8, kVec>(), the kernel of configuration C.
template <class Ks, class C, bool kQ8, bool kVec>
int launch_tile(const float* x, const typename C::W* wq, const float* sw, const float* b,
                float* out, int8_t* outq, float* outs, int M, int K, int N, int smem,
                cudaStream_t stream) {
  auto kernel = Ks::template get<C, kQ8, kVec>();
  // the shared-memory opt-in is set once per process for each instance
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // the planner's bytes must be this configuration's own for this K
  if (N > C::NC || smem != C::smem(K) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<(M + C::BM - 1) / C::BM, C::kThreads, smem, stream>>>(x, wq, sw, b, out, outq, outs,
                                                                  M, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <class Ks, class C, bool kQ8>
int launch_cfg(bool vec, const float* x, const typename C::W* wq, const float* sw,
               const float* b, float* out, int8_t* outq, float* outs, int M, int K, int N,
               int smem, cudaStream_t stream) {
  return vec ? launch_tile<Ks, C, kQ8, true>(x, wq, sw, b, out, outq, outs, M, K, N, smem, stream)
             : launch_tile<Ks, C, kQ8, false>(x, wq, sw, b, out, outq, outs, M, K, N, smem,
                                              stream);
}

template <class Ks, bool kQ8>
int launch_rows(const void* x, const void* wq, const void* sw, const void* b, void* out,
                void* outq, void* outs, int M, int K, int N, int tile, int smem,
                void* stream) {
  constexpr bool P = Ks::kPacked;
  if (M <= 0 || K <= 0 || N <= 0 || K > kMaxKN || N > kMaxKN || (P && K % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads and stores need whole 16-byte chunks of every row and
  // aligned bases: x rows of K % 4 == 0 floats, W and output rows of
  // N % 16 == 0 elements
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
                          reinterpret_cast<uintptr_t>(kQ8 ? outq : out);
  const bool vec = K % 4 == 0 && N % 16 == 0 && (bases & 15) == 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* w = static_cast<const typename QTile0<P>::W*>(wq);
  const auto* swf = static_cast<const float*>(sw);
  const auto* bf = static_cast<const float*>(b);
  auto* of = static_cast<float*>(out);
  auto* oq = static_cast<int8_t*>(outq);
  auto* os = static_cast<float*>(outs);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0:
      return launch_cfg<Ks, QTile0<P>, kQ8>(vec, xf, w, swf, bf, of, oq, os, M, K, N, smem, st);
    case 1:
      // packed W: tile 0 holds every K <= 2048 at N <= 512, so the planner
      // never gives tile 1 and it is not built
      if constexpr (!P)
        return launch_cfg<Ks, QTile1<P>, kQ8>(vec, xf, w, swf, bf, of, oq, os, M, K, N, smem, st);
      break;
    case 2:
      return launch_cfg<Ks, QTile2<P>, kQ8>(vec, xf, w, swf, bf, of, oq, os, M, K, N, smem, st);
    case 3:
      return launch_cfg<Ks, QTile3<P>, kQ8>(vec, xf, w, swf, bf, of, oq, os, M, K, N, smem, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Fused per-token quantize + int8 matmul for Hopper (sm_90a) on the tensor
// cores, over int8 or packed-int4 weights, with a plain C interface for
// ctypes.
//
// Replaces the TPU kernels of onnx_transformer_tpu/ops/pallas/w8a8_matmul.py:
//   K4 quant_w8a8_gemm <- quant_w8a8_matmul / _quant_w8a8_kernel and
//                         _quant_w8a8_kernel_ktiled
//   K8 quant_w4a8_gemm <- quant_w4a8_matmul / _quant_w4a8_kernel
//
// For x f32 [M,K], weights int8 [K,N] (K4) or packed int4 uint8 [K/2,N]
// (K8: byte r of a column holds row 2r in its low nibble and row 2r+1 in its
// high one, both sign-extended; K even), sw and b f32 [N]:
//   sx  = max(absmax_k |x[m,k]|, 1e-5) / 127            (per token, whole row)
//   xq  = round_half_even(x / sx)                        (int8)
//   out = float(xq @ w) * (sx * sw[n]) + b[n]            (int32 accumulate)
// with IEEE division (__fdiv_rn), rintf-equivalent rounding (__float2int_rn)
// and every product and sum rounded on its own (nothing contracted into an
// FMA), so the output is bit-equal to the plain PyTorch version
// (ops/kernels/w8a8_matmul.quant_w8a8_matmul_ref / quant_w4a8_matmul_ref).
// The int32 sums are exact in any order while K * 127 * 127 < 2^31
// (K < 133,143).
//
// Bound on the H100 SXM (3.35 TB/s, 1979 int8 TOP/s) at the encoder FFN
// shape x [36864,512] x W [512,2048]: memory.  x read once (75.5 MB), the f32
// output written once (302 MB), the weights 1 MB (K4) or 0.5 MB (K8): 113 us;
// the 77.3 GOP of products need 39 us at the tensor-core rate.  The f32
// output is four fifths of the bytes, so its write is what bounds it.
//
// Design: x quantized once per row block, the CTA sweeping N.  The output
// is cut into units of BM rows x 128 columns, row block by row block; each
// CTA of a persistent grid (two per SM, as many as fit on the card at once,
// planned by ops/kernels/w8a8_matmul.plan_quant_gemm and passed in with the
// shared memory bytes, which the launch checks against its own) walks one
// contiguous run of units, so that every SM gets the same share whatever
// the number of row blocks.  8 warps.
//   Phase A, at each new row block of the run: the CTA quantizes its BM x
// rows into a resident K-major int8 tile [BM][K + 16] in shared memory
// (xquant.cuh, quantize_x_rows, shared with K1/K2 and K6/K7: x read once
// with 16-byte streaming loads, the absmax by shuffles).
//   Phase B, for each unit (N tile) of the run: the K loop walks W in tiles
// of 64 k through a 3-stage cp.async ring that runs on across units and
// row blocks, so the next tile's W copies overlap this tile's epilogue and
// the next row block's phase A.  The raw W tile ([64,128] int8 or [32,128]
// packed) stays as it lies in memory, its rows' 16-byte chunks swizzled:
// no transpose pass and one barrier per K tile.  The s8 mma wants W
// K-major, and ldmatrix .trans of b16 pairs plus two byte permutes give it
// (load_b): 4 consecutive k for the n8 block of a group's even columns and
// for the one of its odd columns (K8: the nibbles sign-extended on the way,
// no unpacked weight outside registers).  mma.sync m16n8k32 s8 then sums x
// (ldmatrix from the resident tile) with it, and each lane ends up holding
// 4 consecutive columns of its rows, so the epilogue scales them in
// registers and writes each row's 4 with one 16-byte streaming store.
//   Configurations (the planner's `tile`; the largest BM whose units give
// every CTA of the grid work, x resident while K <= 2048):
//     tile 0: BM 128, warps 2 x 4 of 64 x 32 (the encoder's prefill; K <=
//             1600 int8, 1664 packed)
//     tile 1: BM 64, warps 2 x 4 of 32 x 32 (K up to 2048)
//     tile 2: BM 32, warps 2 x 4 of 16 x 32 (few rows: the decode step)
//     tile 3: BM 64 as tile 1, x streamed: for K > 2048 (K4's K = 9728 and
//             16384, K8 up to 4096), too long for quantize_x_rows to hold
//             a row in registers, the row scales come first (one pass over
//             each row) and each x K tile is quantized on the fly for each
//             N tile, into a K-major [64][80] tile.  Right, not fast: x is
//             read once more per N tile.
//   K % 4 != 0, N % 16 != 0 or an unaligned base take the same kernel with
// scalar loads and stores.  W re-read from L2: every row block a CTA takes
// reads all of W (1 MB int8, 0.5 MB packed at the FFN shape); BM 128
// halves that traffic against BM 64.
//
// What bounds it (PERF.md, section 6): a CTA's phases still run one after the
// other.  At [36864,512]x[512,2048] it is about 2x its bound; where x is
// most of the bytes ([36864,2048]x[2048,512], one CTA per SM for the 132 KB
// x tile) phase A's 302 MB read is not overlapped with the products.
// Loader warps filling a second x tile while the others multiply, and
// wgmma, are the levers left.

#include <type_traits>

#include "xquant.cuh"

namespace {

constexpr int kGThreads = 256;        // 8 warps
constexpr int kGBlocks = 2;           // CTAs per SM the registers allow (<= 128 a thread)
constexpr int kGStages = 3;           // W ring depth
constexpr int kGBN = 128;             // columns of a unit (N tile)

// The raw W tiles lie in the ring as they are in memory, rows of 128 bytes
// (int8 k, or packed pairs of k), each row's eight 16-byte chunks permuted
// by an XOR swizzle of the row, so that each 8-row matrix the B loads read
// falls in eight distinct bank groups: rows {0,1,4,5,8,9,12,13} (+2, +16)
// of an int8 tile, 8 consecutive rows of a packed one.
__device__ __forceinline__ int swz_int8(int k) { return ((k >> 1) & 6) | (k & 1); }
__device__ __forceinline__ int swz_packed(int p) { return p & 7; }

// BM rows of x per CTA, WARPS_M x (8 / WARPS_M) warps over a BM x 128
// output tile, x resident (RESIDENT) or streamed by K tile, W int8 [K, N]
// or packed int4 uint8 [K/2, N] (PACKED).
template <int BM_, int WARPS_M_, bool RESIDENT_, bool PACKED_>
struct QGemm {
  static constexpr int BM = BM_, BN = kGBN;
  static constexpr bool kResident = RESIDENT_, kPacked = PACKED_;
  using W = std::conditional_t<PACKED_, uint8_t, int8_t>;
  static constexpr int kThreads = kGThreads, kWarps = kThreads / 32;
  static constexpr int kWarpsM = WARPS_M_, kWarpsN = kWarps / kWarpsM;
  static constexpr int WM = BM / kWarpsM, WN = BN / kWarpsN;
  static constexpr int MI = WM / 16, NG = WN / 16;        // 16-row A tiles, 16-column B groups
  static constexpr int kWRows = PACKED_ ? kBK / 2 : kBK;  // raw rows of a W tile
  static constexpr int kStage = kWRows * BN;              // one raw W tile
  static constexpr int kHead = (BM * 4 + 127) / 128 * 128;  // sx f32 [BM]
  static_assert(WM % 16 == 0 && WN % 32 == 0, "warp tile: 16-row A tiles, pairs of n16 groups");

  // row stride of the int8 x tile: resident, K padded to the K tile + 16
  // bytes (ldmatrix rows in distinct banks); streamed, one K tile
  __host__ __device__ static int x_row(int K) {
    return kResident ? (K + kBK - 1) / kBK * kBK + 16 : kRow;
  }
  // dynamic shared memory: sx, the int8 x tile and the W ring
  __host__ __device__ static int smem(int K) {
    return kHead + BM * x_row(K) + kGStages * kStage;
  }
};

// The configurations, by the index that plan_quant_gemm returns.
template <bool P> using GTile0 = QGemm<128, 2, true, P>;
template <bool P> using GTile1 = QGemm<64, 2, true, P>;
template <bool P> using GTile2 = QGemm<32, 2, true, P>;
template <bool P> using GTile3 = QGemm<64, 2, false, P>;

// Copy the raw W tile k0 .. k0+63 (packed: its 32 packed rows) of columns
// n0 .. n0+127 into ring stage ws, swizzled: cp.async when kVec (N % 16 ==
// 0, 16-byte aligned base), else byte loads.  Rows past K and columns past
// N are zero, which adds nothing to the products.
template <class C, bool kVec>
__device__ __forceinline__ void stage_w_swz(uint8_t* ws, const typename C::W* __restrict__ w,
                                            int n0, int k0, int K, int N) {
  const int r0 = C::kPacked ? k0 / 2 : k0;        // first raw row of the tile
  const int rows = C::kPacked ? K / 2 : K;        // raw rows of W
  const auto* src = reinterpret_cast<const uint8_t*>(w);
  if (kVec) {
    for (int c = threadIdx.x; c < C::kWRows * (C::BN / 16); c += C::kThreads) {
      const int r = c / (C::BN / 16), ch = c % (C::BN / 16);
      const int sw = C::kPacked ? swz_packed(r) : swz_int8(r);
      const bool ok = r0 + r < rows && n0 + 16 * ch < N;
      cp_async16(smem_u32(ws + r * C::BN + ((ch ^ sw) << 4)),
                 ok ? src + (size_t)(r0 + r) * N + n0 + 16 * ch : src, ok ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < C::kWRows * C::BN; c += C::kThreads) {
      const int r = c / C::BN, n = c % C::BN;
      const int sw = C::kPacked ? swz_packed(r) : swz_int8(r);
      ws[r * C::BN + (((n >> 4) ^ sw) << 4) + (n & 15)] =
          r0 + r < rows && n0 + n < N ? src[(size_t)(r0 + r) * N + n0 + n] : 0;
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// The B fragments of one k32 step for the warp's NG n16 groups:
// bf[group][even/odd n][k half].  ldmatrix .trans of b16 pairs gives a
// lane two k rows x two n columns per register; byte permutes then give,
// for the n8 block of the group's even columns and the one of its odd
// columns, the 4 consecutive k that the s8 mma wants.  int8: the four
// matrices are the rows {4q, 4q+1}, {4q+2, 4q+3} (q = 0..3) of k 0..15 and
// of k 16..31 of one group.  Packed: rows 2q and 2q + 1 hold k 4q .. 4q+3,
// so the matrices are packed rows 0..7 and 8..15 of two groups, and the
// nibbles are sign-extended.  So a lane's sums hold 4 consecutive columns
// of each group: even c0, odd c0, even c1, odd c1.  row: this lane's row
// address in the stage, cg: the warp's first group, sw: the row's swizzle.
template <class C>
__device__ __forceinline__ void load_b(uint32_t row, int kk, int cg, int sw,
                                       uint32_t (&bf)[C::NG][2][2]) {
  if constexpr (C::kPacked) {
    const int pair = (threadIdx.x >> 4) & 1;   // lanes 16..31 address the odd group
#pragma unroll
    for (int jp = 0; jp < C::NG / 2; ++jp) {
      uint32_t r[4];
      ldmatrix_x4_trans(row + kk * 16 * C::BN + (((cg + 2 * jp + pair) ^ sw) << 4), r[0], r[1],
                        r[2], r[3]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t v = r[2 * j + h];
          bf[2 * jp + j][0][h] = sext_nibbles(__byte_perm(v, v >> 4, 0x6240));
          bf[2 * jp + j][1][h] = sext_nibbles(__byte_perm(v, v >> 4, 0x7351));
        }
    }
  } else {
#pragma unroll
    for (int j = 0; j < C::NG; ++j) {
      uint32_t r[4];
      ldmatrix_x4_trans(row + kk * 32 * C::BN + (((cg + j) ^ sw) << 4), r[0], r[1], r[2], r[3]);
      bf[j][0][0] = __byte_perm(r[0], r[1], 0x6420);
      bf[j][1][0] = __byte_perm(r[0], r[1], 0x7531);
      bf[j][0][1] = __byte_perm(r[2], r[3], 0x6420);
      bf[j][1][1] = __byte_perm(r[2], r[3], 0x7531);
    }
  }
}

template <class C, bool kVec>
__global__ void __launch_bounds__(kGThreads, kGBlocks)
quant_gemm_kernel(const float* __restrict__ x, const typename C::W* __restrict__ w,
                  const float* __restrict__ sw, const float* __restrict__ bias,
                  float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* sxs = reinterpret_cast<float*>(smem);
  const int XS = C::x_row(K);
  uint8_t* xa = smem + C::kHead;            // int8 x: [BM][XS]
  uint8_t* ring = xa + C::BM * XS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp % C::kWarpsM) * C::WM;
  const int wn = (warp / C::kWarpsM) * C::WN;
  const int nk = (K + kBK - 1) / kBK;
  const int nt = (N + C::BN - 1) / C::BN;
  // this CTA's run of units [u0, u1): row block u / nt, N tile u % nt
  const int units = ((M + C::BM - 1) / C::BM) * nt;
  const int u0 = (int)((long long)units * blockIdx.x / gridDim.x);
  const int u1 = (int)((long long)units * (blockIdx.x + 1) / gridDim.x);
  const int tiles = (u1 - u0) * nk;   // W tiles of the run, K tile fastest

  // the next W tile to stage: its number, N tile and K tile
  int st = 0, st_n = u0 % nt, st_k = 0;
  auto stage_next = [&]() {
    if (st < tiles)
      stage_w_swz<C, kVec>(ring + (st % kGStages) * C::kStage, w, st_n * C::BN, st_k * kBK, K,
                           N);
    cp_async_commit();
    ++st;
    if (++st_k == nk) {
      st_k = 0;
      if (++st_n == nt) st_n = 0;
    }
  };
#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) stage_next();

  // ldmatrix lane addresses.  A: rows (lane & 15), k half (lane >> 4).  B
  // (load_b): matrix j = lane >> 3, its row r = lane & 7; int8: k row
  // (j >> 1) * 16 + (j & 1) * 2 + 4 * (r >> 1) + (r & 1); packed: row
  // (j & 1) * 8 + r, of group j >> 1 of a pair
  const uint32_t a_base = smem_u32(xa) + (wm + (lane & 15)) * XS + (lane >> 4) * 16;
  const int bj = lane >> 3, br = lane & 7;
  const int cg = wn / 16;
  const int b_row = C::kPacked ? (bj & 1) * 8 + br
                               : (bj >> 1) * 16 + (bj & 1) * 2 + 4 * (br >> 1) + (br & 1);
  const int b_sw = C::kPacked ? swz_packed(b_row) : swz_int8(b_row);
  // accumulator fragment of lane: rows g and g + 8 of each 16-row tile,
  // columns 4 * q .. 4 * q + 3 of each n16 group
  const int g = lane >> 2, q = lane & 3;

  int t = 0;                  // the W tile the products take next
  int mb = u0 / nt, nb = u0 % nt, block = -1;
  for (int u = u0; u < u1; ++u) {
    const int m0 = mb * C::BM, n0 = nb * C::BN;
    if (mb != block) {
      // phase A, once every warp is past the last unit's products
      __syncthreads();
      block = mb;
      if constexpr (C::kResident)
        quantize_x_rows<C, kVec>(x, reinterpret_cast<int8_t*>(xa), sxs, m0, M, K, XS);
      else
        row_scales<C, kVec>(x, sxs, m0, M, K);
    }

    int acc[C::MI][C::NG][2][4];
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NG; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][e][r] = 0;

    for (int kt = 0; kt < nk; ++kt, ++t) {
      cp_async_wait<kGStages - 2>();
      __syncthreads();   // W tile t has landed (and x); every warp is done with tile t - 1
      stage_next();
      if constexpr (!C::kResident) {
        quantize_ktile<C, kVec>(x, sxs, xa, kRow, m0, M, K, kt * kBK);
        __syncthreads();   // the x K tile is complete
      }
      const uint32_t a_k = a_base + (C::kResident ? kt * kBK : 0);
      const uint32_t b_k = smem_u32(ring + (t % kGStages) * C::kStage) + b_row * C::BN;
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        uint32_t a[C::MI][4];
        uint32_t bf[C::NG][2][2];
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi)
          ldmatrix_x4(a_k + mi * 16 * XS + kk * 32, a[mi][0], a[mi][1], a[mi][2], a[mi][3]);
        load_b<C>(b_k, kk, cg, b_sw, bf);
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
          for (int j = 0; j < C::NG; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) mma_s8(acc[mi][j][e], a[mi], bf[j][e][0], bf[j][e][1]);
      }
    }

    // Epilogue: each lane holds 4 consecutive columns of rows g and g + 8
    // of each tile, scaled in registers and written with one 16-byte
    // streaming store each (scalar stores when !kVec)
#pragma unroll
    for (int j = 0; j < C::NG; ++j) {
      const int n = n0 + wn + 16 * j + 4 * q;
      if (n >= N) continue;
      float s4[4], b4[4];
      if (kVec) {   // N % 16 == 0: the 4 columns are all < N
        const float4 s = __ldg(reinterpret_cast<const float4*>(sw + n));
        const float4 b = __ldg(reinterpret_cast<const float4*>(bias + n));
        s4[0] = s.x, s4[1] = s.y, s4[2] = s.z, s4[3] = s.w;
        b4[0] = b.x, b4[1] = b.y, b4[2] = b.z, b4[3] = b.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s4[i] = n + i < N ? __ldg(sw + n + i) : 0.f;
          b4[i] = n + i < N ? __ldg(bias + n + i) : 0.f;
        }
      }
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + mi * 16 + g + h * 8;
          if (m0 + r >= M) continue;
          const float sx = sxs[r];
          const int v[4] = {acc[mi][j][0][2 * h], acc[mi][j][1][2 * h], acc[mi][j][0][2 * h + 1],
                            acc[mi][j][1][2 * h + 1]};
          float y[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            y[i] = __fadd_rn(__fmul_rn(__int2float_rn(v[i]), __fmul_rn(sx, s4[i])), b4[i]);
          float* o = out + (size_t)(m0 + r) * N + n;
          if (kVec) {
            __stcs(reinterpret_cast<float4*>(o), make_float4(y[0], y[1], y[2], y[3]));
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (n + i < N) __stcs(o + i, y[i]);
          }
        }
    }
    if (++nb == nt) {
      nb = 0;
      ++mb;
    }
  }
}

template <class C, bool kVec>
int launch_tile(const float* x, const typename C::W* w, const float* sw, const float* b,
                float* out, int M, int K, int N, int smem, int ctas, cudaStream_t stream) {
  auto kernel = quant_gemm_kernel<C, kVec>;
  // the shared-memory opt-in is set once per process for each instance
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // the planner's bytes must be this configuration's own for this K, and a
  // resident x row must fit quantize_x_rows
  if (smem != C::smem(K) || smem > kMaxSmem || (C::kResident && K > kMaxRowK) || ctas <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<ctas, C::kThreads, smem, stream>>>(x, w, sw, b, out, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_cfg(bool vec, const float* x, const typename C::W* w, const float* sw,
               const float* b, float* out, int M, int K, int N, int smem, int ctas,
               cudaStream_t stream) {
  return vec ? launch_tile<C, true>(x, w, sw, b, out, M, K, N, smem, ctas, stream)
             : launch_tile<C, false>(x, w, sw, b, out, M, K, N, smem, ctas, stream);
}

template <bool P>
int launch(const void* x, const void* w, const void* sw, const void* b, void* out, int M,
           int K, int N, int tile, int smem, int ctas, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (P && K % 2)) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads and stores need whole 16-byte chunks of every row and
  // aligned bases: x rows of K % 4 == 0 floats, W rows of N % 16 == 0
  // bytes, output rows, sw and b of N floats
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(sw) | reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(out);
  const bool vec = K % 4 == 0 && N % 16 == 0 && (bases & 15) == 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* wt = static_cast<const typename GTile0<P>::W*>(w);
  const auto* swf = static_cast<const float*>(sw);
  const auto* bf = static_cast<const float*>(b);
  auto* of = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_cfg<GTile0<P>>(vec, xf, wt, swf, bf, of, M, K, N, smem, ctas, st);
    case 1: return launch_cfg<GTile1<P>>(vec, xf, wt, swf, bf, of, M, K, N, smem, ctas, st);
    case 2: return launch_cfg<GTile2<P>>(vec, xf, wt, swf, bf, of, M, K, N, smem, ctas, st);
    case 3: return launch_cfg<GTile3<P>>(vec, xf, wt, swf, bf, of, M, K, N, smem, ctas, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K4: x f32 [M,K], wq int8 [K,N] -> out f32 [M,N] with the configuration
// `tile`, `smem` bytes of dynamic shared memory and `ctas` CTAs
// (plan_quant_gemm).  Returns a cudaError_t (0 = launched).
extern "C" int quant_w8a8_gemm(const void* x, const void* wq, const void* sw, const void* b,
                               void* out, int M, int K, int N, int tile, int smem, int ctas,
                               void* stream) {
  return launch<false>(x, wq, sw, b, out, M, K, N, tile, smem, ctas, stream);
}

// K8: x f32 [M,K], wp uint8 [K/2,N] packed int4 -> out f32 [M,N], as K4.
extern "C" int quant_w4a8_gemm(const void* x, const void* wp, const void* sw, const void* b,
                               void* out, int M, int K, int N, int tile, int smem, int ctas,
                               void* stream) {
  return launch<true>(x, wp, sw, b, out, M, K, N, tile, smem, ctas, stream);
}

// W8A8 matmul of pre-quantized activations for Hopper (sm_90a) on the
// tensor cores, with a plain C interface for ctypes.
//
// Replaces the TPU kernel of onnx_transformer_tpu/ops/pallas/w8a8_matmul.py:
//   K5 w8a8_gemm <- w8a8_matmul / _w8a8_kernel
//
// For xq int8 [M,K] with per-token scales sx f32 [M], wq int8 [K,N] with
// per-channel scales sw f32 [N] and a bias b f32 [N]:
//   acc[m,n] = sum_k xq[m,k] * wq[k,n]                 (int32, exact)
//   out[m,n] = float(acc) * (sx[m] * sw[n]) + b[n]
// with sx*sw taken first and every step rounded on its own (__fmul_rn,
// __fadd_rn, __int2float_rn; nothing is contracted into an FMA), so the
// output is bit-equal to the plain PyTorch version
// (ops/kernels/w8a8_matmul.w8a8_matmul_ref) and to the "int8" chain of
// quant/w8a8.py.  int32 sums of int8 products are exact in any order, so
// the tiling and the mma fragment order cannot change a bit.  Any M (M = 1
// included), any K and any N: ragged tiles are zero-filled (zeros add
// nothing) and the stores are masked.
//
// Bounds on the H100 SXM (3.35 TB/s, 1979 int8 TOP/s), by the serving
// path's six shapes: the decode step's [512,512]x[512,512] (q, k, v, o,
// cross-q, cross-o), [512,512]x[512,2048] and [512,2048]x[2048,512] move
// 1.6-5.2 MB for 0.27-1.07 GOP, so bytes bound them (0.5-1.6 us), and a
// launch, the pipeline's fill and the K loop's latency take most of the
// real time; the prefill's [36864,512]x[512,{512,2048}] and
// [36864,2048]x[2048,512] are bound by the f32 output they write (75-302
// MB), with the products 2-3x below that on the tensor cores.
//
// Design.  Products on the tensor cores: mma.sync m16n8k32 s8.s8.s32,
// operands from shared memory by ldmatrix.  The tile comes from the shape
// (ops/kernels/w8a8_matmul.plan_w8a8_tile, passed in as `tile`): 128x128
// with 8 warps at the prefill's 36,864 rows, and at M = 512 the largest of
// 64x64, 64x32 or 32x32 (4 warps) that gives at least 256 CTAs, two for
// each of the 132 SMs (timed on the card: 32x32 at N = 512, 64x64 at
// N = 2048; a ring of 8 stages was slower than 4).
// One launch per call, no split-K.  K goes in tiles of 64 through a ring of
// 3-4 stages of cp.async copies (16 B per thread), so the copies of the
// next tiles overlap the products of this one.
//   The W layout: s8 mma needs K-major operands for both A and B, and
// ldmatrix .trans and TMA do not transpose bytes.  wq is [K,N],
// N-contiguous, as the JAX package passes it.  So the raw [64,BN] W tile
// is copied as it is (cp.async, 16 B), and every thread of the CTA then
// transposes 4x4-byte blocks with byte permutes into a K-major [BN,64]
// tile that ldmatrix reads.  That costs BN*64 bytes of shared-memory
// traffic each way per K tile (2-way bank conflicts on the reads, none on
// the stores), well below what the warps' ldmatrix calls read, and it
// keeps w8a8_matmul's JAX signature and one weight copy in device memory
// (a K-major copy kept beside each weight would double the weights'
// memory and need a second path for callers that pass wq alone).  Shared
// rows are padded to 80 bytes, so ldmatrix reads are free of bank
// conflicts.
// The cp.async, ldmatrix and mma helpers and the W staging and transpose
// are in mma_s8.cuh, shared with K1/K2 (w8a8_qrows.cu).
// The epilogue scales in registers and writes f32 once, two columns per
// 8-byte store.  K % 16 != 0, N % 16 != 0 or an unaligned base take the same
// kernel with byte loads in place of cp.async.
//
// What it still leaves on the table: wgmma fed by TMA (this card's full
// int8 rate needs warpgroup products and a producer warp, with the W tile
// then from a K-major copy of the weights); persistent CTAs, so that one
// tile's epilogue overlaps the next one's loads; the transpose's share of
// shared-memory traffic and its barrier; and the per-token quantize chain
// in front of every call (absmax, abs, round, cast: about 80 ms of device
// time per serving decode), which K4's contract fuses into the same
// product.

#include "mma_s8.cuh"

namespace {

template <int BM_, int BN_, int WM_, int WN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int kWarpsM = BM / WM, kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int kWRow = BN + 16;                  // padded raw W row
  static constexpr int kABytes = BM * kRow;              // K-major X tile
  static constexpr int kStage = kABytes + kBK * kWRow;   // X tile + raw W tile
  static constexpr int kSmem = STAGES * kStage + BN * kRow;  // + the K-major W tile
  static_assert(NI % 2 == 0, "ldmatrix.x4 loads B for two n8 blocks");
};

// The tile configurations, by the index that plan_w8a8_tile returns.
using Tile0 = Tile<128, 128, 64, 32, 3>;
using Tile1 = Tile<64, 64, 32, 32, 4>;
using Tile2 = Tile<64, 32, 32, 16, 4>;
using Tile3 = Tile<32, 32, 16, 16, 4>;

// Copy K tile k0 of X ([BM, 64], K-major) and W ([64, BN] as stored) into
// one stage of the ring: cp.async when kVec, else byte loads.
template <class C, bool kVec>
__device__ __forceinline__ void stage_tile(uint8_t* stage, const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ wq, int m0, int n0,
                                           int k0, int M, int K, int N) {
  uint8_t* as = stage;
  uint8_t* ws = stage + C::kABytes;
  const int tid = threadIdx.x;
  if (kVec) {
    for (int c = tid; c < C::BM * (kBK / 16); c += C::kThreads) {
      const int r = c >> 2, kc = (c & 3) * 16;
      const int m = m0 + r, k = k0 + kc;
      const bool ok = m < M && k < K;
      cp_async16(smem_u32(as + r * kRow + kc), ok ? xq + (size_t)m * K + k : xq, ok ? 16 : 0);
    }
  } else {
    for (int c = tid; c < C::BM * kBK; c += C::kThreads) {
      const int r = c / kBK, kc = c % kBK;
      const int m = m0 + r, k = k0 + kc;
      as[r * kRow + kc] = (m < M && k < K) ? static_cast<uint8_t>(xq[(size_t)m * K + k]) : 0;
    }
  }
  stage_w<C, kVec>(ws, wq, n0, k0, K, N);
}

template <class C, bool kVec>
__global__ void __launch_bounds__(C::kThreads)
w8a8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const int8_t* __restrict__ wq, const float* __restrict__ sw,
                 const float* __restrict__ bias, float* __restrict__ out, int M, int K,
                 int N) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* bt = smem + C::STAGES * C::kStage;
  const int m0 = blockIdx.x * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp % C::kWarpsM) * C::WM;
  const int wn = (warp / C::kWarpsM) * C::WN;
  const int nk = (K + kBK - 1) / kBK;

  int acc[C::MI][C::NI][4];
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk) stage_tile<C, kVec>(smem + s * C::kStage, xq, wq, m0, n0, s * kBK, M, K, N);
    cp_async_commit();
  }

  // ldmatrix lane addresses inside a tile: A rows (lane & 15), k half
  // (lane >> 4); B columns (lane & 7) + 8 * (lane >> 4), k half ((lane >> 3) & 1)
  const int a_off = (wm + (lane & 15)) * kRow + (lane >> 4) * 16;
  const int b_off = (wn + (lane & 7) + ((lane >> 4) << 3)) * kRow + ((lane >> 3) & 1) * 16;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();   // tile i has landed; every warp is done with tile i - 1
    const int next = i + C::STAGES - 1;
    if (next < nk)
      stage_tile<C, kVec>(smem + (next % C::STAGES) * C::kStage, xq, wq, m0, n0, next * kBK,
                          M, K, N);
    cp_async_commit();
    const uint8_t* as = smem + (i % C::STAGES) * C::kStage;
    transpose_w<C>(as + C::kABytes, bt);
    __syncthreads();   // the K-major W tile is complete
    const uint32_t a_base = smem_u32(as) + a_off;
    const uint32_t b_base = smem_u32(bt) + b_off;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t a[C::MI][4];
      uint32_t b[C::NI][2];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
        ldmatrix_x4(a_base + mi * 16 * kRow + kk * 32, a[mi][0], a[mi][1], a[mi][2], a[mi][3]);
#pragma unroll
      for (int np = 0; np < C::NI / 2; ++np)
        ldmatrix_x4(b_base + np * 16 * kRow + kk * 32, b[2 * np][0], b[2 * np][1],
                    b[2 * np + 1][0], b[2 * np + 1][1]);
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }

  // Accumulator fragment of lane (g = lane / 4, t = lane % 4): rows g and
  // g + 8 of the 16x8 block, columns 2t and 2t + 1.
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + half * 8;
      if (m >= M) continue;
      const float sxm = sx[m];
      float* orow = out + (size_t)m * N;
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        const int n = n0 + wn + ni * 8 + t2;
        if (n >= N) continue;
        const float y0 = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[mi][ni][2 * half]), __fmul_rn(sxm, sw[n])), bias[n]);
        if (n + 1 < N) {
          const float y1 = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + 1]), __fmul_rn(sxm, sw[n + 1])),
              bias[n + 1]);
          if (pairs) {
            *reinterpret_cast<float2*>(orow + n) = make_float2(y0, y1);
          } else {
            orow[n] = y0;
            orow[n + 1] = y1;
          }
        } else {
          orow[n] = y0;
        }
      }
    }
  }
}

template <class C, bool kVec>
int launch_tile(const int8_t* xq, const float* sx, const int8_t* wq, const float* sw,
                const float* b, float* out, int M, int K, int N, cudaStream_t stream) {
  // the shared-memory opt-in is set once per process for each instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      w8a8_gemm_kernel<C, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  w8a8_gemm_kernel<C, kVec><<<grid, C::kThreads, C::kSmem, stream>>>(xq, sx, wq, sw, b, out,
                                                                     M, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch_cfg(bool vec, const int8_t* xq, const float* sx, const int8_t* wq, const float* sw,
               const float* b, float* out, int M, int K, int N, cudaStream_t stream) {
  return vec ? launch_tile<C, true>(xq, sx, wq, sw, b, out, M, K, N, stream)
             : launch_tile<C, false>(xq, sx, wq, sw, b, out, M, K, N, stream);
}

}  // namespace

// K5: out f32 [M,N] with the tile configuration `tile` (0: 128x128,
// 1: 64x64, 2: 64x32, 3: 32x32).  Returns a cudaError_t (0 = launched).
extern "C" int w8a8_gemm(const void* xq, const void* sx, const void* wq, const void* sw,
                         const void* b, void* out, int M, int K, int N, int tile,
                         void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies need whole 16-byte chunks of every row and aligned bases
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(wq)) & 15) == 0;
  const auto* x8 = static_cast<const int8_t*>(xq);
  const auto* w8 = static_cast<const int8_t*>(wq);
  const auto* sxf = static_cast<const float*>(sx);
  const auto* swf = static_cast<const float*>(sw);
  const auto* bf = static_cast<const float*>(b);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_cfg<Tile0>(vec, x8, sxf, w8, swf, bf, o, M, K, N, st);
    case 1: return launch_cfg<Tile1>(vec, x8, sxf, w8, swf, bf, o, M, K, N, st);
    case 2: return launch_cfg<Tile2>(vec, x8, sxf, w8, swf, bf, o, M, K, N, st);
    case 3: return launch_cfg<Tile3>(vec, x8, sxf, w8, swf, bf, o, M, K, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

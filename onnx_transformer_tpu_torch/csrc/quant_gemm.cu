// Fused per-token quantize + int8 matmul for Hopper (sm_90a), over int8 or
// packed-int4 weights, with a plain C interface for ctypes.
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
// the 77.3 GOP of products need 39 us at the tensor-core rate.
//
// Design: K5's tile (csrc/w8a8_gemm.cu) with a quantize prologue, which is
// the TPU kernel's two-phase K-tiled contract for every K.  One CTA of 256
// threads per 64x64 output tile.  Pass 1: each warp reduces the f32 absmax
// of 8 of the CTA's 64 rows over the whole K (by shuffles) and the CTA keeps
// the 64 final scales in shared memory.  Pass 2 walks K in tiles of 32: each
// x tile is quantized with the final scale while it is staged into shared
// memory as words of 4 int8 k, each W tile is staged the same way (for K8,
// unpacking two nibbles per byte), and each thread accumulates a 4x4 block
// with __dp4a; the epilogue scales in registers and writes f32 once.  The
// scale uses the whole row however long K is, so one kernel covers both
// TPU variants (K <= 8192 in one block, longer K in two phases), and no int8
// activation tensor exists in memory.
//
// What this simple design leaves on the table: every CTA along N reads and
// quantizes its 64 rows of x again (N/64 times over; the first thing a
// redesign removes, by quantizing once per row block and sweeping N inside
// the CTA, or by a cluster sharing the scales); x is read twice per CTA
// (absmax, then quantize); __dp4a runs far below the tensor cores' int8 rate
// (mma.sync or wgmma is the later fix); no copy overlaps compute.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;            // output rows per CTA
constexpr int kBN = 64;            // output columns per CTA
constexpr int kBK = 32;            // K depth per tile
constexpr int kKW = kBK / 4;       // packed words per row per tile
constexpr int kStride = kBM + 4;   // padded word stride (16 B aligned, no store conflicts)
constexpr float kScaleFloor = 1e-5f;
constexpr float kQmax = 127.f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 4 consecutive k of row m of x, quantized with the row's scale s; zero past
// M or K.
__device__ __forceinline__ int quant_x_word(const float* __restrict__ x, float s, int m,
                                            int k, int M, int K) {
  if (m >= M) return 0;
  const float* p = x + (size_t)m * K + k;
  unsigned int w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < K) {
      const int q = __float2int_rn(__fdiv_rn(p[j], s));
      w |= (static_cast<unsigned int>(q) & 0xFFu) << (8 * j);
    }
  return static_cast<int>(w);
}

// 4 consecutive k (k a multiple of 4) of column n of the weights as one word
// of int8; zero past K or N.
template <bool kInt4>
__device__ __forceinline__ int load_w_word(const unsigned char* __restrict__ w, int k, int n,
                                           int K, int N) {
  if (n >= N) return 0;
  unsigned int word = 0u;
  if (kInt4) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (k + 2 * j < K) {   // K even: rows k+2j and k+2j+1 share a byte
        const unsigned int p = w[(size_t)((k >> 1) + j) * N + n];
        const unsigned int lo = ((p & 0xFu) ^ 8u) - 8u;   // sign-extend
        const unsigned int hi = ((p >> 4) ^ 8u) - 8u;
        word |= ((lo & 0xFFu) | ((hi & 0xFFu) << 8)) << (16 * j);
      }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k + j < K) word |= static_cast<unsigned int>(w[(size_t)(k + j) * N + n]) << (8 * j);
  }
  return static_cast<int>(word);
}

template <bool kInt4>
__global__ void __launch_bounds__(kThreads)
quant_gemm_kernel(const float* __restrict__ x, const unsigned char* __restrict__ w,
                  const float* __restrict__ sw, const float* __restrict__ bias,
                  float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) int As[kKW][kStride];   // [k word][row]
  __shared__ __align__(16) int Bs[kKW][kStride];   // [k word][column]
  __shared__ float sxs[kBM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // Pass 1: the per-token scale of each of the CTA's rows over the whole K.
  for (int r = warp; r < kBM; r += kWarps) {
    const int m = m0 + r;
    float amax = 0.f;
    if (m < M) {
      const float* xr = x + (size_t)m * K;
      for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(xr[k]));
    }
    amax = warp_max(amax);
    if (lane == 0) sxs[r] = __fdiv_rn(fmaxf(amax, kScaleFloor), kQmax);
  }
  __syncthreads();

  // Pass 2: quantize-and-stage x, stage W, __dp4a products.
  const int ty = tid / 16;          // rows ty*4 .. +3
  const int tx = tid % 16;          // columns tx*4 .. +3
  const int a_kw = tid & 7;         // A tile: word a_kw of rows a_r, a_r + 32
  const int a_r = tid >> 3;
  const int b_n = tid & 63;         // B tile: column b_n, words b_kw, b_kw + 4
  const int b_kw = tid >> 6;
  const float s_a0 = sxs[a_r];
  const float s_a1 = sxs[a_r + 32];

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    As[a_kw][a_r] = quant_x_word(x, s_a0, m0 + a_r, k0 + 4 * a_kw, M, K);
    As[a_kw][a_r + 32] = quant_x_word(x, s_a1, m0 + a_r + 32, k0 + 4 * a_kw, M, K);
    Bs[b_kw][b_n] = load_w_word<kInt4>(w, k0 + 4 * b_kw, n0 + b_n, K, N);
    Bs[b_kw + 4][b_n] = load_w_word<kInt4>(w, k0 + 4 * (b_kw + 4), n0 + b_n, K, N);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kKW; ++kw) {
      const int4 a = *reinterpret_cast<const int4*>(&As[kw][ty * 4]);
      const int4 b = *reinterpret_cast<const int4*>(&Bs[kw][tx * 4]);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const float sxm = sxs[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        out[(size_t)m * N + n] = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[i][j]), __fmul_rn(sxm, sw[n])), bias[n]);
    }
  }
}

template <bool kInt4>
int launch(const void* x, const void* w, const void* sw, const void* b, void* out, int M,
           int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (kInt4 && K % 2)) return static_cast<int>(cudaErrorInvalidValue);
  if ((M + kBM - 1) / kBM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  quant_gemm_kernel<kInt4><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const unsigned char*>(w),
      static_cast<const float*>(sw), static_cast<const float*>(b), static_cast<float*>(out),
      M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: x f32 [M,K], wq int8 [K,N] -> out f32 [M,N].  Returns a cudaError_t.
extern "C" int quant_w8a8_gemm(const void* x, const void* wq, const void* sw, const void* b,
                               void* out, int M, int K, int N, void* stream) {
  return launch<false>(x, wq, sw, b, out, M, K, N, stream);
}

// K8: x f32 [M,K], wp uint8 [K/2,N] packed int4 -> out f32 [M,N].
extern "C" int quant_w4a8_gemm(const void* x, const void* wp, const void* sw, const void* b,
                               void* out, int M, int K, int N, void* stream) {
  return launch<true>(x, wp, sw, b, out, M, K, N, stream);
}

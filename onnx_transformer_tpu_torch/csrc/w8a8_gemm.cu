// W8A8 matmul of pre-quantized activations for Hopper (sm_90a), with a
// plain C interface for ctypes.
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
// quant/w8a8.py.  Any M (M = 1 included), any K (a ragged last K tile is
// zero-filled, which adds nothing to the sums) and any N: the edges are
// masked here, where the TPU grid needed N divisible by its block.
//
// Bound on the H100 SXM (3.35 TB/s, 1979 int8 TOP/s) at the decode-step
// shape [512,512] x [512,512]: memory.  xq, wq and the f32 output are 1.6 MB:
// 0.47 us; the 0.27 GOP of products need 0.14 us at the tensor-core rate.
//
// Design.  One CTA of 256 threads per 64x64 output tile; K is walked in
// tiles of 32.  Each tile of xq and wq is staged in shared memory as 32-bit
// words of 4 consecutive k (for W that means repacking 4 rows of a column
// into one word), and each thread accumulates a 4x4 block of outputs with
// __dp4a on two 16-byte shared loads per 4 k.  The epilogue scales in
// registers and writes f32 once.
//
// What this simple design leaves on the table: __dp4a runs on the integer
// pipes, far below the tensor cores' int8 rate (mma.sync or wgmma with
// TMA-fed tiles is the later fix); no copy overlaps compute; at M = 512 the
// grid has only 64 to 256 CTAs for 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;            // output rows per CTA
constexpr int kBN = 64;            // output columns per CTA
constexpr int kBK = 32;            // K depth per tile
constexpr int kKW = kBK / 4;       // packed words per row per tile
constexpr int kStride = kBM + 4;   // padded word stride (16 B aligned, no store conflicts)

__device__ __forceinline__ int load_x_word(const int8_t* __restrict__ xq, int m, int k,
                                           int M, int K, bool aligned) {
  if (m >= M) return 0;
  const int8_t* p = xq + (size_t)m * K + k;
  if (aligned && k + 3 < K) return *reinterpret_cast<const int*>(p);
  unsigned int w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < K) w |= static_cast<unsigned int>(static_cast<unsigned char>(p[j])) << (8 * j);
  return static_cast<int>(w);
}

__device__ __forceinline__ int load_w_word(const int8_t* __restrict__ wq, int k, int n,
                                           int K, int N) {
  if (n >= N) return 0;
  unsigned int w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < K)
      w |= static_cast<unsigned int>(static_cast<unsigned char>(wq[(size_t)(k + j) * N + n]))
           << (8 * j);
  return static_cast<int>(w);
}

__global__ void __launch_bounds__(kThreads)
w8a8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const int8_t* __restrict__ wq, const float* __restrict__ sw,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int M, int K, int N, bool aligned) {
  __shared__ __align__(16) int As[kKW][kStride];   // [k word][row]
  __shared__ __align__(16) int Bs[kKW][kStride];   // [k word][column]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int ty = tid / 16;          // rows ty*4 .. +3
  const int tx = tid % 16;          // columns tx*4 .. +3
  const int a_kw = tid & 7;         // A tile load: word a_kw of rows a_r, a_r + 32
  const int a_r = tid >> 3;
  const int b_n = tid & 63;         // B tile load: column b_n, words b_kw, b_kw + 4
  const int b_kw = tid >> 6;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    As[a_kw][a_r] = load_x_word(xq, m0 + a_r, k0 + 4 * a_kw, M, K, aligned);
    As[a_kw][a_r + 32] = load_x_word(xq, m0 + a_r + 32, k0 + 4 * a_kw, M, K, aligned);
    Bs[b_kw][b_n] = load_w_word(wq, k0 + 4 * b_kw, n0 + b_n, K, N);
    Bs[b_kw + 4][b_n] = load_w_word(wq, k0 + 4 * (b_kw + 4), n0 + b_n, K, N);
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
    const float sxm = sx[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        out[(size_t)m * N + n] = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[i][j]), __fmul_rn(sxm, sw[n])), bias[n]);
    }
  }
}

}  // namespace

// K5: out f32 [M,N].  Returns a cudaError_t (0 = launched).
extern "C" int w8a8_gemm(const void* xq, const void* sx, const void* wq, const void* sw,
                         const void* b, void* out, int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((M + kBM - 1) / kBM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // whole-word loads of xq rows need K % 4 == 0 and a 4-byte aligned base
  const bool aligned = K % 4 == 0 && (reinterpret_cast<uintptr_t>(xq) & 3) == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w8a8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(wq), static_cast<const float*>(sw),
      static_cast<const float*>(b), static_cast<float*>(out), M, K, N, aligned);
  return static_cast<int>(cudaGetLastError());
}

// Fused W8A8 quantize-matmul kernels for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces the TPU kernels of onnx_transformer_tpu/ops/pallas/w8a8_matmul.py:
//   K1 quant_w8a8_qout <- quant_w8a8_matmul_qout / _quant_w8a8_kernel_qout
//   K2 quant_w8a8_q8   <- quant_w8a8_matmul_q8   / _quant_w8a8_kernel_q8
//
// Both compute, for x f32 [M,K], wq int8 [K,N], sw and b f32 [N]:
//   sx  = max(absmax_k |x[m,k]|, 1e-5) / 127            (per token)
//   xq  = round_half_even(x / sx)                        (int8)
//   y   = float(xq @ wq) * (sx * sw[n]) + b[n]           (int32 accumulate)
//   sy  = max(absmax_n |y[m,n]|, 1e-5) / 127             (per token)
// K1 writes round(y / sy) * sy (f32 [M,N]); K2 writes round(y / sy) as int8
// [M,N] and sy as f32 [M].  Every step uses the _rn intrinsics and nothing is
// contracted into an FMA, so the result is bit-equal to the plain PyTorch
// version (ops/kernels/w8a8_matmul.py), whose eager ops neither contract nor
// divide approximately.
//
// Bound on the H100 SXM (3.35 TB/s, 1979 int8 TOP/s) at the main-path shape
// x [36864,512] x W [512,512]: memory.  K1 moves 151 MB (x read, f32 y
// written): 45 us; K2 moves 95 MB (int8 y written): 28 us; the 19.3 GOP of
// int8 products need 9.8 us at the tensor-core rate.
//
// Design.  The output scale needs the whole output row, so one CTA owns BM
// rows across all N columns: BM = 32 for N <= 1024, BM = 16 above, so that
// the f32 row block fits in shared memory.  Phase A quantizes the CTA's x
// rows into shared memory (one warp per row, exact absmax by shuffles).
// Phase B walks N in tiles of 64 columns and K in tiles of 64: each W tile is
// repacked in shared memory as 4 consecutive k of one column per 32-bit word,
// and each thread accumulates BM/4 rows of one column with __dp4a.  The f32
// epilogue lands in a shared row block.  Phase C takes each row's absmax and
// writes the quantized output.
//
// What this simple design leaves on the table: __dp4a runs on the integer
// pipes at a small fraction of the tensor cores' int8 rate, so the product
// (not the 45 us of memory traffic) bounds it; every CTA re-reads W from L2;
// x is read twice (absmax, then quantize), the second time from cache; no
// copy overlaps compute.  wgmma with TMA-fed tiles is the later fix.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTN = 64;               // output columns per N tile
constexpr int kTK = 64;               // K depth per W tile
constexpr int kTKW = kTK / 4;         // packed words per column per tile
constexpr int kWStride = kTKW + 4;    // padded column stride in words (16 B aligned)
constexpr float kScaleFloor = 1e-5f;
constexpr float kQmax = 127.f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int BM, bool kQ8>
__global__ void __launch_bounds__(kThreads)
quant_w8a8_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                  const float* __restrict__ sw, const float* __restrict__ bias,
                  float* __restrict__ out, int8_t* __restrict__ outq,
                  float* __restrict__ outs, int M, int K, int N, int Kp) {
  // shared layout: ys f32 [BM][N] | wt i32 [kTN][kWStride] | sx f32 [BM] | xq i8 [BM][Kp]
  extern __shared__ __align__(16) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem);
  int* wt = reinterpret_cast<int*>(ys + (size_t)BM * N);
  float* sxs = reinterpret_cast<float*>(wt + kTN * kWStride);
  int8_t* xq = reinterpret_cast<int8_t*>(sxs + BM);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * BM;

  // Phase A: per-token quantize of x into shared memory (rows past M and
  // columns past K are zero, which adds nothing to the products).
  for (int r = warp; r < BM; r += kWarps) {
    const int m = row0 + r;
    int8_t* xr = xq + (size_t)r * Kp;
    if (m < M) {
      const float* xg = x + (size_t)m * K;
      float amax = 0.f;
      for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(xg[k]));
      amax = warp_max(amax);
      const float s = __fdiv_rn(fmaxf(amax, kScaleFloor), kQmax);
      if (lane == 0) sxs[r] = s;
      for (int k = lane; k < Kp; k += 32)
        xr[k] = k < K ? static_cast<int8_t>(__float2int_rn(__fdiv_rn(xg[k], s)))
                      : static_cast<int8_t>(0);
    } else {
      if (lane == 0) sxs[r] = 0.f;
      for (int k = lane; k < Kp; k += 32) xr[k] = 0;
    }
  }

  // Phase B: int8 products, one 64-column tile of the output at a time.
  constexpr int R = BM / 4;             // rows per thread
  const int col = tid % kTN;
  const int rg = tid / kTN;             // warp-uniform row group
  const int* xw = reinterpret_cast<const int*>(xq);
  const int kpw = Kp / 4;
  const int kq = tid >> 4;              // W tile load: k rows k0+4kq .. +3
  const int nq = tid & 15;              //              columns n0+4nq .. +3

  for (int n0 = 0; n0 < N; n0 += kTN) {
    int acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    for (int k0 = 0; k0 < Kp; k0 += kTK) {
      __syncthreads();  // Phase A done / previous tile consumed
      unsigned int w4[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + 4 * kq + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = n0 + 4 * nq + c;
          unsigned int byte = 0u;
          if (k < K && n < N) byte = static_cast<unsigned char>(wq[(size_t)k * N + n]);
          w4[c] |= byte << (8 * i);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) wt[(4 * nq + c) * kWStride + kq] = static_cast<int>(w4[c]);
      __syncthreads();

      const int* wcol = wt + col * kWStride;
      const int* xrow = xw + (size_t)(rg * R) * kpw + k0 / 4;
#pragma unroll
      for (int kw = 0; kw < kTKW; kw += 4) {
        const int4 b4 = *reinterpret_cast<const int4*>(wcol + kw);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int4 a4 = *reinterpret_cast<const int4*>(xrow + (size_t)i * kpw + kw);
          acc[i] = __dp4a(a4.x, b4.x, acc[i]);
          acc[i] = __dp4a(a4.y, b4.y, acc[i]);
          acc[i] = __dp4a(a4.z, b4.z, acc[i]);
          acc[i] = __dp4a(a4.w, b4.w, acc[i]);
        }
      }
    }
    const int n = n0 + col;
    if (n < N) {
      const float swn = sw[n];
      const float bn = bias[n];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = rg * R + i;
        ys[(size_t)r * N + n] =
            __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), __fmul_rn(sxs[r], swn)), bn);
      }
    }
  }
  __syncthreads();

  // Phase C: per-token output scale and the quantized output rows.
  for (int r = warp; r < BM; r += kWarps) {
    const int m = row0 + r;
    if (m >= M) continue;
    const float* yr = ys + (size_t)r * N;
    float amax = 0.f;
    for (int n = lane; n < N; n += 32) amax = fmaxf(amax, fabsf(yr[n]));
    amax = warp_max(amax);
    const float s = __fdiv_rn(fmaxf(amax, kScaleFloor), kQmax);
    if (kQ8) {
      if (lane == 0) outs[m] = s;
      for (int n = lane; n < N; n += 32)
        outq[(size_t)m * N + n] = static_cast<int8_t>(__float2int_rn(__fdiv_rn(yr[n], s)));
    } else {
      for (int n = lane; n < N; n += 32)
        out[(size_t)m * N + n] = __fmul_rn(rintf(__fdiv_rn(yr[n], s)), s);
    }
  }
}

template <int BM, bool kQ8>
int launch(const float* x, const int8_t* wq, const float* sw, const float* b,
           float* out, int8_t* outq, float* outs, int M, int K, int N,
           cudaStream_t stream) {
  const int Kp = (K + kTK - 1) / kTK * kTK;
  const size_t smem = (size_t)BM * N * sizeof(float) + (size_t)kTN * kWStride * sizeof(int) +
                      (size_t)BM * sizeof(float) + (size_t)BM * Kp;
  cudaError_t err = cudaFuncSetAttribute(quant_w8a8_kernel<BM, kQ8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (M + BM - 1) / BM;
  quant_w8a8_kernel<BM, kQ8><<<grid, kThreads, smem, stream>>>(
      x, wq, sw, b, out, outq, outs, M, K, N, Kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: out f32 [M,N].  Returns a cudaError_t (0 = launched).
extern "C" int quant_w8a8_qout(const void* x, const void* wq, const void* sw,
                               const void* b, void* out, int M, int K, int N,
                               void* stream) {
  auto xs = static_cast<const float*>(x);
  auto ws = static_cast<const int8_t*>(wq);
  auto sws = static_cast<const float*>(sw);
  auto bs = static_cast<const float*>(b);
  auto os = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return N > 1024 ? launch<16, false>(xs, ws, sws, bs, os, nullptr, nullptr, M, K, N, st)
                  : launch<32, false>(xs, ws, sws, bs, os, nullptr, nullptr, M, K, N, st);
}

// K2: outq int8 [M,N] and outs f32 [M].  Returns a cudaError_t (0 = launched).
extern "C" int quant_w8a8_q8(const void* x, const void* wq, const void* sw,
                             const void* b, void* outq, void* outs, int M, int K,
                             int N, void* stream) {
  auto xs = static_cast<const float*>(x);
  auto ws = static_cast<const int8_t*>(wq);
  auto sws = static_cast<const float*>(sw);
  auto bs = static_cast<const float*>(b);
  auto oq = static_cast<int8_t*>(outq);
  auto os = static_cast<float*>(outs);
  auto st = static_cast<cudaStream_t>(stream);
  return N > 1024 ? launch<16, true>(xs, ws, sws, bs, nullptr, oq, os, M, K, N, st)
                  : launch<32, true>(xs, ws, sws, bs, nullptr, oq, os, M, K, N, st);
}

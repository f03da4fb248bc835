// Fused W4A8 quantize-matmul kernels for Hopper (sm_90a) on __dp4a, with a
// plain C interface for ctypes.
//
// Replaces the TPU kernels of onnx_transformer_tpu/ops/pallas/w8a8_matmul.py:
//   K6 quant_w4a8_qout <- quant_w4a8_matmul_qout / _quant_w4a8_kernel_qout
//   K7 quant_w4a8_q8   <- quant_w4a8_matmul_q8   / _quant_w4a8_kernel_q8
//
// It serves K6/K7 only.  K1/K2, the same contract over int8 weights, run on
// the tensor cores in w8a8_qrows.cu; K6/K7 stay on this __dp4a kernel until
// that kernel's W staging takes the packed-int4 format (the nibble unpack
// below goes into its W transpose), so that each kernel change is measured
// on its own.
//
// K6/K7 take the weights as packed int4: uint8 [K/2,N], byte r of a column
// holding row 2r in its low nibble and row 2r+1 in its high one, both
// sign-extended (quant/core.pack_int4).  They unpack while staging a W tile
// into shared memory, into words of 4 int8 k; no unpacked weight tensor
// exists in memory.  K is even, and a tile of kTK = 64 rows is 32 packed
// rows.
//
// Both compute, for x f32 [M,K], the int4 weights wq [K,N], sw and b f32 [N]:
//   sx  = max(absmax_k |x[m,k]|, 1e-5) / 127            (per token)
//   xq  = round_half_even(x / sx)                        (int8)
//   y   = float(xq @ wq) * (sx * sw[n]) + b[n]           (int32 accumulate)
//   sy  = max(absmax_n |y[m,n]|, 1e-5) / 127             (per token)
// K6 writes round(y / sy) * sy (f32 [M,N]); K7 writes round(y / sy) as int8
// [M,N] and sy as f32 [M].  Every step uses the _rn intrinsics and nothing is
// contracted into an FMA, so the result is bit-equal to the plain PyTorch
// version (ops/kernels/w8a8_matmul.py), whose eager ops neither contract nor
// divide approximately.
//
// Bound on the H100 SXM (3.35 TB/s, 1979 int8 TOP/s) at the int4 path's
// shape x [36864,512] x W [512,512]: memory.  K6 moves 151 MB (x read, f32
// y written): 45 us; K7 moves 95 MB (int8 y written): 28 us; the 19.3 GOP
// of int8 products need 9.8 us at the tensor-core rate.
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
// copy overlaps compute.  w8a8_qrows.cu's design is the fix.

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

// The W tile load: 4 consecutive k (k0 + 4*kq + i, i = 0..3, k0 + 4*kq even)
// of 4 columns, one int8 per byte of each column's word, unpacked from the
// nibble pairs.  Rows past K and columns past N are zero, which adds
// nothing to the products.
__device__ __forceinline__ void load_w_words(const unsigned char* __restrict__ w, int k,
                                             int n0, int K, int N, unsigned int w4[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = n0 + c;
    unsigned int word = 0u;
    if (n < N) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (k + 2 * j < K) {   // K even: rows k+2j and k+2j+1 share a byte
          const unsigned int p = w[(size_t)((k >> 1) + j) * N + n];
          const unsigned int lo = ((p & 0xFu) ^ 8u) - 8u;   // sign-extend
          const unsigned int hi = ((p >> 4) ^ 8u) - 8u;
          word |= ((lo & 0xFFu) | ((hi & 0xFFu) << 8)) << (16 * j);
        }
      }
    }
    w4[c] = word;
  }
}

template <int BM, bool kQ8>
__global__ void __launch_bounds__(kThreads)
quant_w8a8_kernel(const float* __restrict__ x, const unsigned char* __restrict__ wq,
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
      unsigned int w4[4];
      load_w_words(wq, k0 + 4 * kq, n0 + 4 * nq, K, N, w4);
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
int launch(const float* x, const void* wq, const float* sw, const float* b,
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
      x, static_cast<const unsigned char*>(wq), sw, b, out, outq, outs, M, K, N, Kp);
  return static_cast<int>(cudaGetLastError());
}

template <bool kQ8>
int launch_rows(const void* x, const void* w, const void* sw, const void* b, void* out,
                void* outq, void* outs, int M, int K, int N, void* stream) {
  auto xs = static_cast<const float*>(x);
  auto sws = static_cast<const float*>(sw);
  auto bs = static_cast<const float*>(b);
  auto os = static_cast<float*>(out);
  auto oq = static_cast<int8_t*>(outq);
  auto ss = static_cast<float*>(outs);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || K % 2) return static_cast<int>(cudaErrorInvalidValue);
  return N > 1024 ? launch<16, kQ8>(xs, w, sws, bs, os, oq, ss, M, K, N, st)
                  : launch<32, kQ8>(xs, w, sws, bs, os, oq, ss, M, K, N, st);
}

}  // namespace

// K6: out f32 [M,N] over packed-int4 weights wp uint8 [K/2,N]; K even.
// Returns a cudaError_t (0 = launched).
extern "C" int quant_w4a8_qout(const void* x, const void* wp, const void* sw,
                               const void* b, void* out, int M, int K, int N,
                               void* stream) {
  return launch_rows<false>(x, wp, sw, b, out, nullptr, nullptr, M, K, N, stream);
}

// K7: outq int8 [M,N] and outs f32 [M] over packed-int4 weights wp uint8
// [K/2,N]; K even.  Returns a cudaError_t (0 = launched).
extern "C" int quant_w4a8_q8(const void* x, const void* wp, const void* sw,
                             const void* b, void* outq, void* outs, int M, int K,
                             int N, void* stream) {
  return launch_rows<true>(x, wp, sw, b, nullptr, outq, outs, M, K, N, stream);
}

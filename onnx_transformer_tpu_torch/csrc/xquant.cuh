// Per-token quantize of f32 activation rows into int8 tiles in shared
// memory, for the fused quantize-matmul kernels for Hopper (sm_90a): K1/K2
// and K6/K7 (qrows.cuh) and K4/K8 (quant_gemm.cu).
//
// For the rows m0 .. m0 + BM - 1 of x f32 [M,K]:
//   sx = max(absmax_k |x[m,k]|, 1e-5) / 127            (the whole row)
//   xq = round_half_even(x / sx)                        (int8)
// with IEEE division (__fdiv_rn) and __float2int_rn, bit-equal to
// quant/core.act_scale_per_token and quantize.  Rows past M and columns
// past K are zero.
//
// - quantize_x_rows: a warp holds whole rows (K <= kMaxRowK) in registers,
//   read once with 16-byte streaming loads, takes their absmax by shuffles
//   and writes them into a resident K-major int8 tile [BM][XS];
// - row_scales and quantize_ktile: for rows longer than that, the scales
//   first (one pass over each row), then any 64-deep K tile of the block
//   quantized on the fly.
//
// A configuration C names BM (rows of the block), kWarps and kThreads.

#pragma once

#include "mma_s8.cuh"

namespace {

constexpr float kScaleFloor = 1e-5f;
constexpr float kQmax = 127.f;
constexpr int kMaxRowK = 2048;        // quantize_x_rows: 16 float4 a lane

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ uint32_t quantize4(float4 v, float s) {
  const uint32_t q0 = static_cast<uint32_t>(__float2int_rn(__fdiv_rn(v.x, s))) & 0xFFu;
  const uint32_t q1 = static_cast<uint32_t>(__float2int_rn(__fdiv_rn(v.y, s))) & 0xFFu;
  const uint32_t q2 = static_cast<uint32_t>(__float2int_rn(__fdiv_rn(v.z, s))) & 0xFFu;
  const uint32_t q3 = static_cast<uint32_t>(__float2int_rn(__fdiv_rn(v.w, s))) & 0xFFu;
  return q0 | (q1 << 8) | (q2 << 16) | (q3 << 24);
}

// 4 consecutive k of a row from k on (k < K; zero past K), through the
// read-only cache: one 16-byte load when kVec (K % 4 == 0, 16-byte
// aligned rows), else scalar ones.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ xr, int k, int K) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(xr + k));
  float4 t = make_float4(__ldg(xr + k), 0.f, 0.f, 0.f);
  if (k + 1 < K) t.y = __ldg(xr + k + 1);
  if (k + 2 < K) t.z = __ldg(xr + k + 2);
  if (k + 3 < K) t.w = __ldg(xr + k + 3);
  return t;
}

// Rows r of the CTA's block, RP of them per warp at once, quantized per
// token into xq [BM][XS] (columns K..XS-16 zero; rows past M zero) and
// their scales into sxs.  A lane holds 4 consecutive k of each 128, so a
// row of K <= 128 * (16 / RP) lies in 16 / RP float4 per lane.
template <int RP, class C, bool kVec>
__device__ __forceinline__ void quantize_rows(const float* __restrict__ x, int8_t* xq,
                                              float* sxs, int m0, int M, int K, int XS) {
  constexpr int SPR = 16 / RP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kp = XS - 16;
  for (int r0 = warp; r0 < C::BM; r0 += C::kWarps * RP) {
    float4 v[RP][SPR];
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      const int r = r0 + C::kWarps * j;
      const bool row_ok = r < C::BM && m0 + r < M;
      const float* xr = x + (size_t)(m0 + r) * K;
#pragma unroll
      for (int c = 0; c < SPR; ++c) {
        const int k = 128 * c + 4 * lane;
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row_ok && k < K) {
          if (kVec) {
            t = __ldcs(reinterpret_cast<const float4*>(xr + k));
          } else {
            t.x = __ldcs(xr + k);
            if (k + 1 < K) t.y = __ldcs(xr + k + 1);
            if (k + 2 < K) t.z = __ldcs(xr + k + 2);
            if (k + 3 < K) t.w = __ldcs(xr + k + 3);
          }
        }
        v[j][c] = t;
      }
    }
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      const int r = r0 + C::kWarps * j;
      float a = 0.f;
#pragma unroll
      for (int c = 0; c < SPR; ++c) a = fmaxf(a, absmax4(v[j][c]));
      const float s = __fdiv_rn(fmaxf(warp_max(a), kScaleFloor), kQmax);
      if (r < C::BM) {
        if (lane == 0) sxs[r] = s;
#pragma unroll
        for (int c = 0; c < SPR; ++c) {
          const int k = 128 * c + 4 * lane;
          if (k < kp)
            *reinterpret_cast<uint32_t*>(xq + (size_t)r * XS + k) = quantize4(v[j][c], s);
        }
      }
    }
  }
}

// The CTA's rows into the resident tile, as many rows per warp at once as
// 16 float4 a lane hold (K <= kMaxRowK).
template <class C, bool kVec>
__device__ __forceinline__ void quantize_x_rows(const float* __restrict__ x, int8_t* xq,
                                                float* sxs, int m0, int M, int K, int XS) {
  const int per = (K + 127) / 128;       // float4 per lane per row
  if (per <= 4)
    quantize_rows<4, C, kVec>(x, xq, sxs, m0, M, K, XS);
  else if (per <= 8)
    quantize_rows<2, C, kVec>(x, xq, sxs, m0, M, K, XS);
  else
    quantize_rows<1, C, kVec>(x, xq, sxs, m0, M, K, XS);
}

// The scales alone of the CTA's rows, any K: a warp walks a row in steps
// of 128 floats (rows past M get the floor's scale and are never stored).
// The lines stay cached for quantize_ktile, which reads them again.
template <class C, bool kVec>
__device__ __forceinline__ void row_scales(const float* __restrict__ x, float* sxs, int m0,
                                           int M, int K) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < C::BM; r += C::kWarps) {
    float a = 0.f;
    if (m0 + r < M) {
      const float* xr = x + (size_t)(m0 + r) * K;
      for (int k = 4 * lane; k < K; k += 128) a = fmaxf(a, absmax4(load4<kVec>(xr, k, K)));
    }
    a = warp_max(a);
    if (lane == 0) sxs[r] = __fdiv_rn(fmaxf(a, kScaleFloor), kQmax);
  }
}

// The K tile x[m0:m0+BM, k0:k0+64] quantized with the scales sxs into dst
// [BM][ds] (K-major; zero past M and K), 4 k per thread and task.
template <class C, bool kVec>
__device__ __forceinline__ void quantize_ktile(const float* __restrict__ x, const float* sxs,
                                               uint8_t* dst, int ds, int m0, int M, int K,
                                               int k0) {
  for (int c = threadIdx.x; c < C::BM * (kBK / 4); c += C::kThreads) {
    const int r = c / (kBK / 4), kc = (c % (kBK / 4)) * 4;
    const int k = k0 + kc;
    const float4 v = m0 + r < M && k < K ? load4<kVec>(x + (size_t)(m0 + r) * K, k, K)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<uint32_t*>(dst + r * ds + kc) = quantize4(v, sxs[r]);
  }
}

}  // namespace

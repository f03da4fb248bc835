// Single-query attention over an int8 merged-head K/V cache for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel of onnx_transformer_tpu/ops/pallas/attention.py:
//   K3 decode_attention_int8 <- decode_attention_int8 / _decode_attn_kernel
//
// For q f32 [B,D], kq/vq int8 [B,T,D] with per-token scales ks/vs f32 [B,T],
// mask uint8 [B,T] (1 = attendable) and H heads of dk = D/H lanes, each head
// h of each sequence b computes
//   s[t]   = (sum_d q[d] * kq[t,d]) * (ks[t] * inv_sqrt_dk)   scale after the dot
//   s[t]   = mask[t] ? s[t] : -1e9                              (not -inf)
//   p[t]   = exp(s[t] - max s) / sum_t exp(s[t] - max s)
//   p[t]   = rint(p[t] * 127) / 127                             (if quantize)
//   out[d] = sum_t p[t] * (vq[t,d] * vs[t])
// over d in the head's dk lanes.  The probability rounding is the division
// form round(p*127)/127 of ops/layers.quantize_probs (the TPU kernel
// multiplies by 1/127 instead, one ulp away at most), with rintf (half to
// even) and expf; nothing is built with fast math.  A row whose mask is all
// zero gets the uniform softmax over T, as every score is -1e9.  Sums run in
// another order than the plain version's (ops/kernels/decode_attention.py),
// so the two agree within rtol 1e-5 / atol 1e-4, not bit for bit.
//
// Bound on the H100 SXM (3.35 TB/s) at the main-path shape B=512, T=72,
// D=512: memory.  The int8 caches are 37.7 MB, scales, mask, q and the f32
// output 0.9 MB more: about 11.6 us; the 75 MFLOP are nothing.
//
// Design.  One CTA of 128 threads per (sequence, head), so B*H CTAs.  The
// head's query lanes go to shared memory.  Scores: each time row's dk int8
// values are read as char4 words by a group of L lanes (L the power of two
// at or above dk/4), so a warp takes 32/L rows at once and reduces each by
// xor shuffles inside its group; scores, then probabilities, stay in shared
// memory (T floats), with the V scales beside them.  A block-wide max and
// sum give the softmax.  The context: each thread owns one char4 column
// group of the head and a slice of the time rows, and the slices' partial
// sums are added in shared memory.  dk not divisible by 4 takes the same
// loops with single bytes.
//
// What this simple design leaves on the table: a head's K row is only dk
// bytes, so each CTA moves 2*T*dk bytes (9 KB at the main-path shape) and
// pays its launch and two barriers for it; the cache is read by B*H small
// CTAs rather than streamed by a few CTAs per SM with cp.async or TMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDk = 128;
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r += red[w];
  return r;
}

__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
                   const float* __restrict__ ks, const int8_t* __restrict__ vq,
                   const float* __restrict__ vs, const uint8_t* __restrict__ mask,
                   float* __restrict__ out, int T, int D, int dk, float inv_sqrt_dk,
                   int quantize, int vec4, int lanes_per_row) {
  // shared: sc f32 [T] (scores, then probabilities) | vss f32 [T]
  extern __shared__ float smem[];
  float* sc = smem;
  float* vss = smem + T;
  __shared__ float qs[kMaxDk];
  __shared__ float part[kThreads * 4];
  __shared__ float red[kWarps];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = (size_t)b * T;
  const int hoff = h * dk;
  const int width = vec4 ? 4 : 1;   // int8 values per load
  const int units = dk / width;     // loads per row of the head

  for (int i = tid; i < dk; i += kThreads) qs[i] = q[(size_t)b * D + hoff + i];
  for (int t = tid; t < T; t += kThreads) vss[t] = vs[row0 + t];
  __syncthreads();

  // Scores: a group of L lanes per time row, 32/L rows per warp at a time.
  const int L = lanes_per_row;
  const int rows_per_warp = 32 / L;
  const int sub = lane / L;
  const int li = lane % L;
  for (int t0 = warp * rows_per_warp; t0 < T; t0 += kWarps * rows_per_warp) {
    const int t = t0 + sub;
    float acc = 0.f;
    if (t < T) {
      const int8_t* kr = kq + (row0 + t) * D + hoff;
      if (vec4) {
        for (int u = li; u < units; u += L) {
          const char4 k4 = *reinterpret_cast<const char4*>(kr + 4 * u);
          const float* qq = qs + 4 * u;
          acc += qq[0] * (float)k4.x + qq[1] * (float)k4.y +
                 qq[2] * (float)k4.z + qq[3] * (float)k4.w;
        }
      } else {
        for (int u = li; u < units; u += L) acc += qs[u] * (float)kr[u];
      }
    }
    for (int o = L / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (li == 0 && t < T) {
      const float s = acc * (ks[row0 + t] * inv_sqrt_dk);
      sc[t] = mask[row0 + t] ? s : kNegInf;
    }
  }
  __syncthreads();

  // Softmax over T.
  float m = -INFINITY;
  for (int t = tid; t < T; t += kThreads) m = fmaxf(m, sc[t]);
  m = block_max(m, red);
  float ssum = 0.f;
  for (int t = tid; t < T; t += kThreads) {
    const float e = expf(sc[t] - m);
    sc[t] = e;
    ssum += e;
  }
  ssum = block_sum(ssum, red);
  for (int t = tid; t < T; t += kThreads) {
    float p = sc[t] / ssum;
    if (quantize) p = rintf(p * 127.f) / 127.f;
    sc[t] = p;
  }
  __syncthreads();

  // Context: thread (slice s, load group u) sums rows t = s, s + S, ...
  const int S = kThreads / units;
  const int u = tid % units;
  const int s = tid / units;
  if (s < S) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int t = s; t < T; t += S) {
      const float p = sc[t];
      const float vsc = vss[t];
      const int8_t* vr = vq + (row0 + t) * D + hoff + width * u;
      if (vec4) {
        const char4 v4 = *reinterpret_cast<const char4*>(vr);
        a0 += p * ((float)v4.x * vsc);
        a1 += p * ((float)v4.y * vsc);
        a2 += p * ((float)v4.z * vsc);
        a3 += p * ((float)v4.w * vsc);
      } else {
        a0 += p * ((float)vr[0] * vsc);
      }
    }
    float* pp = part + s * dk + width * u;
    pp[0] = a0;
    if (vec4) {
      pp[1] = a1;
      pp[2] = a2;
      pp[3] = a3;
    }
  }
  __syncthreads();
  for (int d = tid; d < dk; d += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc += part[j * dk + d];
    out[(size_t)b * D + hoff + d] = acc;
  }
}

}  // namespace

// K3: out f32 [B,D].  Returns a cudaError_t (0 = launched); 1
// (cudaErrorInvalidValue) for shapes the kernel does not take.
extern "C" int decode_attention_int8(const void* q, const void* kq, const void* ks,
                                     const void* vq, const void* vs, const void* mask,
                                     void* out, int B, int T, int D, int H,
                                     float inv_sqrt_dk, int quantize, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D % H != 0 || D / H > kMaxDk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dk = D / H;
  const int vec4 = dk % 4 == 0;
  const int units = vec4 ? dk / 4 : dk;
  int lanes = 1;
  while (lanes < units && lanes < 32) lanes <<= 1;
  const size_t smem = (size_t)2 * T * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_attn_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, H);
  decode_attn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kq),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
      static_cast<const float*>(vs), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), T, D, dk, inv_sqrt_dk, quantize, vec4, lanes);
  return static_cast<int>(cudaGetLastError());
}

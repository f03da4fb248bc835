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
// Bound on the H100 SXM (3.35 TB/s) at the serving shape B=512, T=72,
// D=512, H=8: memory.  The int8 caches are 37.7 MB, scales, mask, q and the
// f32 output 0.9 MB more: about 12 us; the 94 MFLOP are nothing, but the
// 37.7 M int8 -> f32 conversions are not: at the conversion pipe's 16 a
// clock per SM they alone would take about 9 us, so the bytes become floats
// by a byte permute and one f32 add (exact: 2^23 + u - (2^23 + 128)).
//
// Design.  One CTA of 256 threads (8 warps) per sequence and group of hg
// heads (ops/kernels/decode_attention.plan_decode_attention: all H heads
// when hg*dk <= 512 bytes and the scores fit in shared memory, so one CTA
// per sequence, 512 CTAs, at the serving shape).  A group's slice of a K or
// V row is at most 512 bytes, so one warp reads it in one coalesced load of
// 16 B per lane; the dk/16 neighbouring lanes that hold one head reduce its
// score by xor shuffles.  Warp w takes rows w, w+8, ..., four rows of loads
// in flight at once.  Scores go to shared memory as [hg][T]; one warp per
// head takes its softmax.  The context re-reads the V rows the same way:
// each lane sums its 16 columns over its warp's rows, and the 8 warps'
// partial sums are added through shared memory.  Every cache byte is read
// once, 16 B at a time, straight into registers: each byte is used by one
// thread only, so a shared-memory ring (cp.async or TMA) would add a copy
// and a barrier per chunk without saving a load; the four independent
// loads per warp (each row's scale and mask byte with them), 8 warps per
// CTA and four CTAs per SM keep about 64 KB in flight per SM, and the
// first four V rows of each warp are loaded before the softmax.  Head widths that are not 16, 32, 64 or 128 bytes (the
// tests' dk = 6 and 2) take a second loop in the same kernel: a warp per
// row and head for the scores, a thread per column for the context, byte
// loads.  The shared-memory opt-in (cudaFuncSetAttribute) is made once per
// process.
//
// What it still leaves on the table: the three block barriers per CTA and
// the softmax between the two passes, which a split over T with a second
// combine step (flash-decoding) would overlap for long caches; at T = 72
// one CTA per sequence has only 9 rows per warp, so the loads of the
// context pass start only after the softmax.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;            // rows of loads in flight per warp
constexpr int kMaxGroupBytes = 512;   // hg * dk
constexpr int kMaxSmem = 200 * 1024;  // the planner keeps each launch within this
constexpr float kNegInf = -1e9f;

// Four int8 in a word -> four exact floats.
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;   // each byte b + 128
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __int_as_float(static_cast<int>(__byte_perm(u, 0x4B000000u, 0x7650 + i))) -
           8388736.f;
}

__device__ __forceinline__ void s8x16_to_f32(const int4& v, float* f) {
  s8x4_to_f32(static_cast<uint32_t>(v.x), f);
  s8x4_to_f32(static_cast<uint32_t>(v.y), f + 4);
  s8x4_to_f32(static_cast<uint32_t>(v.z), f + 8);
  s8x4_to_f32(static_cast<uint32_t>(v.w), f + 12);
}

// Softmax of each head's scores in place, one warp per head.
__device__ __forceinline__ void softmax_rows(float* sc, int hg, int T, int quantize) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = warp; h < hg; h += kWarps) {
    float* row = sc + h * T;
    float m = -INFINITY;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, row[t]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(row[t] - m);
      row[t] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int t = lane; t < T; t += 32) {
      float p = row[t] / sum;
      if (quantize) p = rintf(p * 127.f) / 127.f;
      row[t] = p;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
decode_attn_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
                   const float* __restrict__ ks, const int8_t* __restrict__ vq,
                   const float* __restrict__ vs, const uint8_t* __restrict__ mask,
                   float* __restrict__ out, int T, int D, int dk, int hg, float inv_sqrt_dk,
                   int quantize) {
  // shared: sc f32 [hg][T] (scores, then probabilities) | part f32 [8][hg*dk]
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;
  const int b = blockIdx.x;
  const int width = hg * dk;               // bytes of a row this CTA reads
  const int c0 = blockIdx.y * width;       // its first column
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = (size_t)b * T;

  if (kVec) {
    float* part = smem + ((hg * T + 3) & ~3);
    const int group = dk / 16;              // lanes per head: 1, 2, 4 or 8
    const bool active = lane * 16 < width;
    const int hl = active ? lane / group : 0;
    const int col = c0 + lane * 16;
    float qv[16];
#pragma unroll
    for (int i = 0; i < 16; i += 4) {
      const float4 v = active ? *reinterpret_cast<const float4*>(q + (size_t)b * D + col + i)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      qv[i] = v.x;
      qv[i + 1] = v.y;
      qv[i + 2] = v.z;
      qv[i + 3] = v.w;
    }

    // Scores: warp w takes rows w, w + 8, ..., kUnroll rows of loads (and
    // their scales and mask bytes) in flight at once.
    for (int t0 = warp; t0 < T; t0 += kWarps * kUnroll) {
      int4 kr[kUnroll];
      float ksr[kUnroll];
      bool live[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kWarps;
        const bool in = t < T;
        kr[u] = (active && in) ? __ldg(reinterpret_cast<const int4*>(kq + (row0 + t) * D + col))
                               : make_int4(0, 0, 0, 0);
        ksr[u] = in ? __ldg(ks + row0 + t) : 0.f;
        live[u] = in && __ldg(mask + row0 + t) != 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kWarps;
        if (t >= T) break;   // uniform across the warp
        float kf[16];
        s8x16_to_f32(kr[u], kf);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) acc = fmaf(qv[i], kf[i], acc);
        for (int o = 1; o < group; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (active && lane % group == 0)
          sc[hl * T + t] = live[u] ? acc * (ksr[u] * inv_sqrt_dk) : kNegInf;
      }
    }

    // The context's first rows are loaded before the softmax, to overlap it.
    int4 vr[kUnroll];
    float vsr[kUnroll];
    auto load_v = [&](int t0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kWarps;
        vr[u] = (active && t < T)
                    ? __ldg(reinterpret_cast<const int4*>(vq + (row0 + t) * D + col))
                    : make_int4(0, 0, 0, 0);
        vsr[u] = t < T ? __ldg(vs + row0 + t) : 0.f;
      }
    };
    load_v(warp);
    __syncthreads();
    softmax_rows(sc, hg, T, quantize);
    __syncthreads();

    // Context: each lane sums its 16 columns over its warp's rows.
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    const float* prow = sc + hl * T;
    for (int t0 = warp; t0 < T; t0 += kWarps * kUnroll) {
      if (t0 != warp) load_v(t0);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * kWarps;
        if (t >= T) break;
        const float p = prow[t];
        float vf[16];
        s8x16_to_f32(vr[u], vf);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = fmaf(p, vf[i] * vsr[u], acc[i]);
      }
    }
    if (active) {
      float* pp = part + warp * width + lane * 16;
#pragma unroll
      for (int i = 0; i < 16; i += 4)
        *reinterpret_cast<float4*>(pp + i) =
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    }
    __syncthreads();
    for (int d = tid; d < width; d += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w * width + d];
      out[(size_t)b * D + c0 + d] = s;
    }
  } else {
    // Any head width: a warp per (row, head) for the scores, byte loads.
    for (int t = warp; t < T; t += kWarps) {
      const int8_t* kr = kq + (row0 + t) * D + c0;
      for (int h = 0; h < hg; ++h) {
        float acc = 0.f;
        for (int d = lane; d < dk; d += 32)
          acc = fmaf(q[(size_t)b * D + c0 + h * dk + d], static_cast<float>(kr[h * dk + d]), acc);
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) {
          const float s = acc * (ks[row0 + t] * inv_sqrt_dk);
          sc[h * T + t] = mask[row0 + t] ? s : kNegInf;
        }
      }
    }
    __syncthreads();
    softmax_rows(sc, hg, T, quantize);
    __syncthreads();
    // The context: a thread per column, over every row.
    for (int d = tid; d < width; d += kThreads) {
      const float* prow = sc + (d / dk) * T;
      float s = 0.f;
      for (int t = 0; t < T; ++t)
        s = fmaf(prow[t], static_cast<float>(vq[(row0 + t) * D + c0 + d]) * vs[row0 + t], s);
      out[(size_t)b * D + c0 + d] = s;
    }
  }
}

template <bool kVec>
int launch(const float* q, const int8_t* kq, const float* ks, const int8_t* vq,
           const float* vs, const uint8_t* mask, float* out, int B, int T, int D, int dk,
           int hg, float inv_sqrt_dk, int quantize, size_t smem, cudaStream_t stream) {
  // the shared-memory opt-in is set once per process for each instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attn_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B, D / (hg * dk));
  decode_attn_kernel<kVec><<<grid, kThreads, smem, stream>>>(q, kq, ks, vq, vs, mask, out, T,
                                                             D, dk, hg, inv_sqrt_dk, quantize);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: out f32 [B,D], one CTA per sequence and group of `hg` heads.
// Returns a cudaError_t (0 = launched); 1 (cudaErrorInvalidValue) for shapes
// the kernel does not take.
extern "C" int decode_attention_int8(const void* q, const void* kq, const void* ks,
                                     const void* vq, const void* vs, const void* mask,
                                     void* out, int B, int T, int D, int H, int hg,
                                     float inv_sqrt_dk, int quantize, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D % H != 0 || hg <= 0 || H % hg != 0 || H / hg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dk = D / H;
  if (hg * dk > kMaxGroupBytes) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte row loads: a head of 16, 32, 64 or 128 bytes (whole, aligned
  // lane groups of 1-8 lanes) and aligned bases
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kq) |
                          reinterpret_cast<uintptr_t>(vq);
  const bool vec = (dk == 16 || dk == 32 || dk == 64 || dk == 128) && (bases & 15) == 0;
  size_t smem = (((size_t)hg * T + 3) & ~(size_t)3) * sizeof(float);
  if (vec) smem += (size_t)kWarps * hg * dk * sizeof(float);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* k8 = static_cast<const int8_t*>(kq);
  const auto* ksf = static_cast<const float*>(ks);
  const auto* v8 = static_cast<const int8_t*>(vq);
  const auto* vsf = static_cast<const float*>(vs);
  const auto* m8 = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  return vec ? launch<true>(qf, k8, ksf, v8, vsf, m8, o, B, T, D, dk, hg, inv_sqrt_dk,
                            quantize, smem, st)
             : launch<false>(qf, k8, ksf, v8, vsf, m8, o, B, T, D, dk, hg, inv_sqrt_dk,
                             quantize, smem, st);
}

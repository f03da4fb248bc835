// Fused W4A8 quantize-matmul kernels with a whole-row output scale, for
// Hopper (sm_90a) on the tensor cores, with a plain C interface for ctypes.
//
// Replaces the TPU kernels of onnx_transformer_tpu/ops/pallas/w8a8_matmul.py:
//   K6 quant_w4a8_qout <- quant_w4a8_matmul_qout / _quant_w4a8_kernel_qout
//   K7 quant_w4a8_q8   <- quant_w4a8_matmul_q8   / _quant_w4a8_kernel_q8
//
// The weights are int4 packed two to a byte, uint8 [K/2,N] with K even:
// byte r of a column holds row 2r in its low nibble and row 2r+1 in its
// high one, both sign-extended (quant/core.pack_int4).  The contract is
// K1/K2's on the unpacked weights, and so are the bound at the int4 path's
// shape (128 KB less W to read) and the design (qrows.cuh): only the W
// staging differs.  A W tile of 64 k is 32 packed rows, half K1's ring
// bytes, and the transpose into the K-major int8 tile sign-extends the
// nibbles (mma_s8.cuh, transpose_w_int4); no unpacked weight exists
// outside shared memory.  The smaller ring lets tile 0 (BM 64) hold every
// K <= 2048 at N <= 512, so tile 1 is never planned: 3 configurations x
// 16-byte or scalar loads, 12 kernels.

#include "qrows.cuh"

namespace {

// Two kernel names, so that a profile tells K6 from K7 (and both from K1/K2).
template <class C, bool kVec>
__global__ void __launch_bounds__(kQThreads, 1)
w4a8_qrows_qout_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                       const float* __restrict__ sw, const float* __restrict__ bias,
                       float* __restrict__ out, int8_t* __restrict__ outq,
                       float* __restrict__ outs, int M, int K, int N) {
  qrows_body<C, false, kVec>(x, wp, sw, bias, out, outq, outs, M, K, N);
}

template <class C, bool kVec>
__global__ void __launch_bounds__(kQThreads, 1)
w4a8_qrows_q8_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                     const float* __restrict__ sw, const float* __restrict__ bias,
                     float* __restrict__ out, int8_t* __restrict__ outq,
                     float* __restrict__ outs, int M, int K, int N) {
  qrows_body<C, true, kVec>(x, wp, sw, bias, out, outq, outs, M, K, N);
}

struct Kernels {
  static constexpr bool kPacked = true;
  template <class C, bool kQ8, bool kVec>
  static auto get() {
    return kQ8 ? &w4a8_qrows_q8_kernel<C, kVec> : &w4a8_qrows_qout_kernel<C, kVec>;
  }
};

}  // namespace

// K6: out f32 [M,N] from wp uint8 [K/2,N], K even, with the configuration
// `tile` and `smem` bytes of dynamic shared memory (plan_w8a8_qrows with
// packed=True).  Returns a cudaError_t (0 = launched).
extern "C" int quant_w4a8_qout(const void* x, const void* wp, const void* sw, const void* b,
                               void* out, int M, int K, int N, int tile, int smem,
                               void* stream) {
  return launch_rows<Kernels, false>(x, wp, sw, b, out, nullptr, nullptr, M, K, N, tile, smem,
                                     stream);
}

// K7: outq int8 [M,N] and outs f32 [M], as K6.  Returns a cudaError_t.
extern "C" int quant_w4a8_q8(const void* x, const void* wp, const void* sw, const void* b,
                             void* outq, void* outs, int M, int K, int N, int tile, int smem,
                             void* stream) {
  return launch_rows<Kernels, true>(x, wp, sw, b, nullptr, outq, outs, M, K, N, tile, smem,
                                    stream);
}

// Fused W8A8 quantize-matmul kernels with a whole-row output scale, for
// Hopper (sm_90a) on the tensor cores, with a plain C interface for ctypes.
//
// Replaces the TPU kernels of onnx_transformer_tpu/ops/pallas/w8a8_matmul.py:
//   K1 quant_w8a8_qout <- quant_w8a8_matmul_qout / _quant_w8a8_kernel_qout
//   K2 quant_w8a8_q8   <- quant_w8a8_matmul_q8   / _quant_w8a8_kernel_q8
//
// The weights are int8 [K,N].  The contract, the bound at the main-path
// shape and the design are those of qrows.cuh, whose body this source
// instantiates for int8 W under K1's and K2's kernel names: 4 configurations
// x 16-byte or scalar loads, 16 kernels.  K6/K7 (w4a8_qrows.cu) are the same
// body over packed-int4 W.

#include "qrows.cuh"

namespace {

// Two kernel names, so that a profile tells K1 from K2.
template <class C, bool kVec>
__global__ void __launch_bounds__(kQThreads, 1)
w8a8_qrows_qout_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                       const float* __restrict__ sw, const float* __restrict__ bias,
                       float* __restrict__ out, int8_t* __restrict__ outq,
                       float* __restrict__ outs, int M, int K, int N) {
  qrows_body<C, false, kVec>(x, wq, sw, bias, out, outq, outs, M, K, N);
}

template <class C, bool kVec>
__global__ void __launch_bounds__(kQThreads, 1)
w8a8_qrows_q8_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
                     const float* __restrict__ sw, const float* __restrict__ bias,
                     float* __restrict__ out, int8_t* __restrict__ outq,
                     float* __restrict__ outs, int M, int K, int N) {
  qrows_body<C, true, kVec>(x, wq, sw, bias, out, outq, outs, M, K, N);
}

struct Kernels {
  static constexpr bool kPacked = false;
  template <class C, bool kQ8, bool kVec>
  static auto get() {
    return kQ8 ? &w8a8_qrows_q8_kernel<C, kVec> : &w8a8_qrows_qout_kernel<C, kVec>;
  }
};

}  // namespace

// K1: out f32 [M,N] with the configuration `tile` and `smem` bytes of
// dynamic shared memory (plan_w8a8_qrows).  Returns a cudaError_t (0 =
// launched).
extern "C" int quant_w8a8_qout(const void* x, const void* wq, const void* sw, const void* b,
                               void* out, int M, int K, int N, int tile, int smem,
                               void* stream) {
  return launch_rows<Kernels, false>(x, wq, sw, b, out, nullptr, nullptr, M, K, N, tile, smem,
                                     stream);
}

// K2: outq int8 [M,N] and outs f32 [M], as K1.  Returns a cudaError_t.
extern "C" int quant_w8a8_q8(const void* x, const void* wq, const void* sw, const void* b,
                             void* outq, void* outs, int M, int K, int N, int tile, int smem,
                             void* stream) {
  return launch_rows<Kernels, true>(x, wq, sw, b, nullptr, outq, outs, M, K, N, tile, smem,
                                    stream);
}

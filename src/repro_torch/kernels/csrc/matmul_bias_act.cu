// Fused gemm epilogue C[m,n] = act(A[m,k] @ B[k,n] + bias[n]) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused.py:_mba_kernel (driven by
// matmul_bias_act_pallas). Same function: fp32 accumulation, the bias added
// to the fp32 accumulator, the activation applied there (gelu in its tanh
// form, silu as h / (1 + exp(-h))), then one store in the input dtype, so
// the [m, n] pre-activation never goes through device memory.
//
// The kernels are gemm.cuh's, shared with matmul.cu and expert_gemm.cu, on
// matmul's routes and knob space: wgmma fed by a TMA ring for prefill rows
// (tc), the swap-AB kernel for decode rows (decode), split-k with the
// epilogue in the second pass, the WMMA tile loop for operands TMA cannot
// address and the SIMT kernels for fp32. The epilogue (gemm.cuh:epilogue)
// runs on the fp32 accumulator of each route before its one cast.
//
// Bound: the training gate projection [8192,896]@[896,4864] does 71.4
// GFLOP on 103 MB (inputs read once, output written once), about 690 flop
// a byte, above the 295 the H100 needs before its tensor cores are the
// limit: it is bound by operations, as matmul's tc route is; the epilogue
// adds one bias read a column and the activation's exponentials on the
// output tile. A decode projection with a bias ([8,896]@[896,896]) is a
// read of the weight, bound by bytes, as matmul's decode route is.
#include "gemm.cuh"

// out[m,n] = act(a[m,k] @ b[k,n] + bias[n]). ta/tb: operand stored
// transposed (column-major); lda/ldb: its leading dimension; bias
// contiguous, in the operands' dtype; act 0 none, 1 gelu (tanh form), 2
// silu; ws: the fp32 [splits, m, n] workspace when splits > 1, each split
// kps k slices.
extern "C" int repro_matmul_bias_act(const void* a, const void* b, const void* bias, void* c,
                                     void* ws, int m, int n, int k, int ta, int tb,
                                     long long lda, long long ldb, int dtype, int act,
                                     int route, int bm, int bn, int bk, int stages, int splits,
                                     int kps, void* stream) {
  if (bias == nullptr) return cudaErrorInvalidValue;
  gemm::Problem p{a,      b,      c,      static_cast<float*>(ws),
                  1,      m,      n,      k,
                  ta,     tb,     lda,    ldb,
                  0,      0,      dtype,  route,
                  bm,     bn,     bk,     stages,
                  splits, kps,    static_cast<cudaStream_t>(stream)};
  p.bias = bias;
  p.act = act;
  return gemm::launch(p);
}

// Blocked matmul C[m,n] = A[m,k] @ B[k,n] for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/matmul.py:_matmul_kernel (driven by
// matmul_pallas). Same function: fp32 accumulation, output in the input
// dtype (C row-major, contiguous).
//
// The kernels are gemm.cuh's, shared with expert_gemm.cu and
// matmul_bias_act.cu (which adds an epilogue; matmul passes none): each
// operand is read in the layout in which it is stored (row-major or
// transposed, with its own leading dimension), so the backward's
// transposed operands (ct @ w^T, x^T @ ct) need no copy.
//
// Bound: prefill rows (m > 16) do 2 * m flops per weight element, far above
// the 295 flop a byte at which the H100's tensor cores become the limit:
// bound by the tensor cores. bf16 runs wgmma fed by a TMA ring (gemm.cuh's
// tc route), one or two consumer warpgroups a CTA and a producer warp
// keeping `stages` k slices in flight; the train step's narrow-n gemms
// (the unembed's dx, [2048,151936] @ [151936,896]^T: 112 output tiles of
// 128 x 128 for 132 SMs) split k over CTAs. Decode rows (m = 8: 16 flops a
// weight element) are bound by the bytes of the weight: the decode route
// computes C^T = B^T A^T so that 64 weight columns are wgmma's M and the
// rows its N = 16, with a deep ring of weight slices in flight per SM and
// split-k for the narrow-n projections. fp32 (the hybrid's dt_proj and
// out_proj) stays on the SIMT cores in full fp32, bound there by FFMA
// issue at prefill: 8 x 16 register tiles a thread fed by a cp.async ring
// (gemm.cuh's simt kernel); split over k at decode and for short prefills,
// where the output tiles over k = 16,384 would leave the card idle.
#include "gemm.cuh"

// Shared-memory bytes of one CTA of a route; kernels/matmul.py mirrors this.
extern "C" int repro_matmul_smem_bytes(int route, int dtype, int bm, int bn, int bk,
                                       int stages) {
  return gemm::smem_bytes(route, dtype, bm, bn, bk, stages);
}

// C[m,n] = A[m,k] @ B[k,n]. ta/tb: operand stored transposed (column-major);
// lda/ldb: its leading dimension (the stride of its stored rows); ws: the
// fp32 [splits, m, n] workspace when splits > 1, each split kps k slices.
extern "C" int repro_matmul(const void* a, const void* b, void* c, void* ws, int m, int n,
                            int k, int ta, int tb, long long lda, long long ldb, int dtype,
                            int route, int bm, int bn, int bk, int stages, int splits, int kps,
                            void* stream) {
  const gemm::Problem p{a,      b,      c,      static_cast<float*>(ws),
                        1,      m,      n,      k,
                        ta,     tb,     lda,    ldb,
                        0,      0,      dtype,  route,
                        bm,     bn,     bk,     stages,
                        splits, kps,    static_cast<cudaStream_t>(stream)};
  return gemm::launch(p);
}

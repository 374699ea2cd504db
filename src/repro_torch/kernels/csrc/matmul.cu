// Blocked matmul C[m,n] = A[m,k] @ B[k,n] for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/matmul.py:_matmul_kernel (driven by
// matmul_pallas). Same function: fp32 accumulation, output in the input
// dtype (C row-major, contiguous).
//
// The tile loop is gemm.cuh's, shared with expert_gemm.cu: each operand is
// read in the layout in which it is stored (row-major or transposed, with
// its own leading dimension), so the backward's transposed operands
// (ct @ w^T, x^T @ ct) need no copy. One CTA computes one (bm x bn) tile of
// C, looping over k in bk slices inside the block (the TPU's sequential k
// grid axis), each slice staged in shared memory with its ragged edge
// zero-filled; bf16 runs on the tensor cores through WMMA, fp32 on the
// SIMT cores.
//
// Bound: at decode (m = 8) every projection reads its whole weight once
// and does 16 flops per weight element, far below the 295 flop/byte the
// H100 needs before its tensor cores are the limit: the kernel is bound by
// device-memory bytes, and a grid that runs over n puts every SM on
// streaming its own columns of B. Large prefill buckets (m >= 512) are
// bound by the tensor cores; this first version stages through shared
// memory without cp.async/TMA pipelining or wgmma, and leaves that to a
// later change.
#include "gemm.cuh"

// Shared-memory bytes of one CTA; kernels/matmul.py mirrors this formula.
extern "C" int repro_matmul_smem_bytes(int dtype, int bm, int bn, int bk) {
  return gemm_smem_bytes(dtype, bm, bn, bk);
}

// C[m,n] = A[m,k] @ B[k,n]. ta/tb: operand stored transposed (column-major);
// lda/ldb: its leading dimension (the stride of its stored rows).
extern "C" int repro_matmul(const void* a, const void* b, void* c, int m, int n, int k,
                            int ta, int tb, int lda, int ldb, int dtype, int bm, int bn,
                            int bk, void* stream) {
  return gemm_launch(a, b, c, 1, m, n, k, ta, tb, lda, ldb, 0, 0, dtype, bm, bn, bk, stream);
}

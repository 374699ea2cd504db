// One part of a gemm library (matmul, matmul_bias_act, expert_gemm), compiled
// on its own with -DGEMM_SPLIT and either -DGEMM_TC_TA=<0|1> -DGEMM_TC_TB=<0|1>
// (one operand layout's tensor-core and decode kernels, every tile) or
// -DGEMM_SIMT_EA=<0|1|2|4> (one A granule's fp32 register-tile kernels, every
// B granule, with and without the epilogue), and linked into the library:
// kernels/_build.py starts the parts' nvcc beside the library's own, so the
// library's compile time is no longer the sum of its kernels'.
#define REPRO_LIBRARY_PART     // the library's main source defines its entry points
#include "gemm.cuh"

#define GEMM_PART_CAT_(a, b) a##b
#define GEMM_PART_CAT(a, b) GEMM_PART_CAT_(a, b)

namespace gemm {

#if defined(GEMM_TC_TA)
cudaError_t GEMM_PART_CAT(GEMM_PART_CAT(launch_tc_l, GEMM_TC_TA), GEMM_TC_TB)(const Problem& p) {
  return launch_tc_layout<GEMM_TC_TA != 0, GEMM_TC_TB != 0>(p);
}
#elif defined(GEMM_SIMT_EA)
cudaError_t GEMM_PART_CAT(launch_simt_ea, GEMM_SIMT_EA)(const Problem& p, dim3 grid, int eb) {
  return launch_simt_b<GEMM_SIMT_EA>(p, grid, eb);
}
#else
#error "a gemm part names GEMM_TC_TA and GEMM_TC_TB, or GEMM_SIMT_EA"
#endif

}  // namespace gemm

// Row RMSNorm for Hopper (sm_90a):
//   out[r, :] = cast((x[r, :] * invrms[r]) * w)   (product in fp32, then cast)
//   invrms[r] = rsqrt(mean(x[r, :]^2) + eps)      (fp32)
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:_rmsnorm_kernel (driven
// by rmsnorm_pallas), with the same order of operations: the weight
// multiplies in fp32 before the cast.
//
// One warp per row, block_rows rows (warps) per CTA: lanes stride the row
// with coalesced loads, the sum of squares is reduced by shuffles, and a
// second pass writes the output. The second pass re-reads the row the same
// warp has just read, so it is served from L1/L2 and device memory sees one
// read of x, one of the weight (shared by all rows through L2) and one
// write of out. Bound: bytes (about 2 flops per byte moved), so the design
// keeps every SM streaming rows and does no work a second time in DRAM.
#include "common.cuh"

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                               T* __restrict__ out, float* __restrict__ invrms,
                               int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / d + eps);
  T* orow = out + (size_t)row * d;
  for (int c = lane; c < d; c += 32) orow[c] = from_f32<T>((to_f32(xr[c]) * r) * to_f32(w[c]));
  if (lane == 0) invrms[row] = r;
}

extern "C" int repro_rmsnorm(const void* x, const void* w, void* out, float* invrms,
                             int rows, int d, float eps, int dtype, int block_rows,
                             void* stream) {
  if (block_rows < 1 || block_rows > 32) return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  const dim3 grid((rows + block_rows - 1) / block_rows);
  const int threads = 32 * block_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), invrms, rows, d, eps);
  } else if (dtype == REPRO_F32) {
    rmsnorm_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), invrms, rows, d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

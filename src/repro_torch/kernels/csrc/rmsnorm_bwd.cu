// RMSNorm backward for Hopper (sm_90a), from the forward's saved inverse rms:
//   g        = ct * w                                  (fp32)
//   dx[r, :] = g * r - x * r^3 * mean(g * x)           (cast to x's dtype)
//   dw       = sum over rows of ct * x * r             (cast to w's dtype)
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:_rmsnorm_bwd_kernel
// (driven by rmsnorm_bwd_pallas). The TPU kernel carries dw in scratch
// across a sequential row grid; CUDA blocks run in any order, so here each
// CTA writes its own fp32 partial of dw ([n_ctas, d]) and a second small
// kernel sums the partials in a fixed order. No atomics: the result is the
// same from run to run.
//
// Pass 1: one warp per row, block_rows warps a CTA, the CTAs striding over
// the rows. A warp reads its row of ct and x twice (the second time from
// L1/L2), reduces g*x by shuffles, writes dx, and adds ct*x*r into its own
// row of a [block_rows, d] fp32 accumulator in shared memory; the CTA then
// sums its warps' rows in order into its partial.
// Pass 2: one thread per column sums the n_ctas partials in order.
//
// Bound: bytes. Device memory sees ct and x read once, dx written once,
// the inverse rms, and the small partials (n_ctas x d fp32, about 1 MB at
// d = 896); about 3 flops per byte moved.
#include "common.cuh"

#define RMS_BWD_MAX_CTAS 264   // two per SM on an H100 SXM

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void rmsnorm_bwd_rows(const T* __restrict__ ct, const T* __restrict__ x,
                                 const T* __restrict__ w, const float* __restrict__ invrms,
                                 T* __restrict__ dx, float* __restrict__ partial, int rows,
                                 int d) {
  extern __shared__ __align__(16) float acc[];   // [warps][d]
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* my = acc + warp * d;
  for (int c = lane; c < d; c += 32) my[c] = 0.f;
  for (int row = blockIdx.x * warps + warp; row < rows; row += gridDim.x * warps) {
    const T* cr = ct + (size_t)row * d;
    const T* xr = x + (size_t)row * d;
    const float r = invrms[row];
    float dot = 0.f;
    for (int c = lane; c < d; c += 32) dot = fmaf(to_f32(cr[c]) * to_f32(w[c]), to_f32(xr[c]), dot);
    dot = warp_sum(dot) / d;
    const float r3 = r * r * r;
    T* dr = dx + (size_t)row * d;
    for (int c = lane; c < d; c += 32) {
      const float cv = to_f32(cr[c]), xv = to_f32(xr[c]);
      const float g = cv * to_f32(w[c]);
      dr[c] = from_f32<T>(g * r - xv * r3 * dot);
      my[c] = fmaf(cv, xv * r, my[c]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < warps; ++i) s += acc[i * d + c];
    partial[(size_t)blockIdx.x * d + c] = s;
  }
}

template <typename T>
__global__ void rmsnorm_bwd_dw(const float* __restrict__ partial, T* __restrict__ dw,
                               int n_ctas, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int i = 0; i < n_ctas; ++i) s += partial[(size_t)i * d + c];
  dw[c] = from_f32<T>(s);
}

// CTAs of pass 1 (and rows of the partials); kernels/rmsnorm.py sizes the
// scratch with it.
extern "C" int repro_rmsnorm_bwd_ctas(int rows, int block_rows) {
  const int need = (rows + block_rows - 1) / block_rows;
  return need < RMS_BWD_MAX_CTAS ? need : RMS_BWD_MAX_CTAS;
}

extern "C" int repro_rmsnorm_bwd(const void* ct, const void* x, const void* w,
                                 const float* invrms, void* dx, void* dw, float* partial,
                                 int rows, int d, int dtype, int block_rows, void* stream) {
  if (block_rows < 1 || block_rows > 32 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctas = rows > 0 ? repro_rmsnorm_bwd_ctas(rows, block_rows) : 0;
  const int smem = block_rows * d * 4;
  const int threads = 32 * block_rows;
  const dim3 grid_dw((d + 255) / 256);
  cudaError_t err;
  if (dtype == REPRO_BF16) {
    typedef __nv_bfloat16 T;
    if ((err = allow_smem(rmsnorm_bwd_rows<T>, smem)) != cudaSuccess) return err;
    if (ctas > 0)
      rmsnorm_bwd_rows<T><<<ctas, threads, smem, s>>>(
          static_cast<const T*>(ct), static_cast<const T*>(x), static_cast<const T*>(w),
          invrms, static_cast<T*>(dx), partial, rows, d);
    rmsnorm_bwd_dw<T><<<grid_dw, 256, 0, s>>>(partial, static_cast<T*>(dw), ctas, d);
  } else if (dtype == REPRO_F32) {
    typedef float T;
    if ((err = allow_smem(rmsnorm_bwd_rows<T>, smem)) != cudaSuccess) return err;
    if (ctas > 0)
      rmsnorm_bwd_rows<T><<<ctas, threads, smem, s>>>(
          static_cast<const T*>(ct), static_cast<const T*>(x), static_cast<const T*>(w),
          invrms, static_cast<T*>(dx), partial, rows, d);
    rmsnorm_bwd_dw<T><<<grid_dw, 256, 0, s>>>(partial, static_cast<T*>(dw), ctas, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

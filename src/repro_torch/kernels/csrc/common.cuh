// Shared helpers of the port's CUDA kernels: element conversion to and from
// fp32, the row-major tile staging of the gemm kernels, and the
// error-string export every library carries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (kernels/_build.py callers).
enum { REPRO_F32 = 0, REPRO_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Every library's entry point for an error's text; a translation unit linked
// into a library beside its main one (REPRO_LIBRARY_PART) leaves it to that.
#ifndef REPRO_LIBRARY_PART
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif

// Opt a kernel in to `bytes` of dynamic shared memory (needed above 48 KB).
template <typename K>
static cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Stage the (rows x cols) tile at (r0, c0) of the row-major [R, C] matrix
// with leading dimension lds into shared memory with leading dimension ld,
// zero beyond the edge. `vec` (16-byte loads) requires lds a multiple of
// the vector width and a 16-byte aligned base; the caller checks both.
template <typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, int ld,
                                          const T* __restrict__ src, int lds, int R, int C,
                                          int r0, int c0, int rows, int cols, bool vec) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int vcols = cols / V;
    for (int i = tid; i < rows * vcols; i += nt) {
      const int r = i / vcols, c = (i % vcols) * V;
      const int gr = r0 + r, gc = c0 + c;
      T* d = dst + r * ld + c;
      if (gr < R && gc + V <= C) {
        *reinterpret_cast<uint4*>(d) =
            __ldg(reinterpret_cast<const uint4*>(src + (size_t)gr * lds + gc));
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          d[e] = (gr < R && gc + e < C) ? src[(size_t)gr * lds + gc + e] : from_f32<T>(0.f);
      }
    }
  } else {
    for (int i = tid; i < rows * cols; i += nt) {
      const int r = i / cols, c = i % cols;
      const int gr = r0 + r, gc = c0 + c;
      dst[r * ld + c] = (gr < R && gc < C) ? src[(size_t)gr * lds + gc] : from_f32<T>(0.f);
    }
  }
}

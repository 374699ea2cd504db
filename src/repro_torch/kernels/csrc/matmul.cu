// Blocked matmul C[m,n] = A[m,k] @ B[k,n] for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/matmul.py:_matmul_kernel (driven by
// matmul_pallas). Same function: fp32 accumulation, output in the input
// dtype. Row-major contiguous operands only.
//
// One CTA computes one (bm x bn) tile of C, looping over k in bk slices
// inside the block (the TPU's sequential k grid axis). Each slice of A and
// B is staged in shared memory with its ragged edge zero-filled, so no pad
// copies are made in device memory. bf16 runs on the tensor cores through
// WMMA 16x16x16 fragments, each warp owning a (16*FM x 32) sub-tile; fp32
// runs on the SIMT cores with the same warp layout (one column per lane).
//
// Bound: at decode (m = 8) every projection reads its whole weight once
// and does 16 flops per weight element, far below the 295 flop/byte the
// H100 needs before its tensor cores are the limit: the kernel is bound by
// device-memory bytes, and a grid that runs over n puts every SM on
// streaming its own columns of B. Large prefill buckets (m >= 512) are
// bound by the tensor cores; this first version stages through shared
// memory without cp.async/TMA pipelining or wgmma, and leaves that to a
// later change.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// Stage the (rows x cols) tile at (r0, c0) of the row-major [R, C] matrix
// into shared memory with leading dimension ld, zero beyond the edge.
// `vec` (16-byte loads) requires C a multiple of the vector width and a
// 16-byte aligned base; the caller checks both.
template <typename T>
__device__ __forceinline__ void load_tile(T* __restrict__ dst, int ld,
                                          const T* __restrict__ src, int R, int C,
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
            __ldg(reinterpret_cast<const uint4*>(src + (size_t)gr * C + gc));
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          d[e] = (gr < R && gc + e < C) ? src[(size_t)gr * C + gc + e] : from_f32<T>(0.f);
      }
    }
  } else {
    for (int i = tid; i < rows * cols; i += nt) {
      const int r = i / cols, c = i % cols;
      const int gr = r0 + r, gc = c0 + c;
      dst[r * ld + c] = (gr < R && gc < C) ? src[(size_t)gr * C + gc] : from_f32<T>(0.f);
    }
  }
}

template <int FM>
__global__ void __launch_bounds__(512)
matmul_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C,
            int m, int n, int k, int bm, int bn, int bk, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = bk + 8, ldb = bn + 8, ldc = bn + 4;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + bm * lda;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the k loop

  const int warp = threadIdx.x / 32;
  const int warps_n = bn / 32;
  const int wr = (warp / warps_n) * 16 * FM, wc = (warp % warps_n) * 32;
  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][2];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += bk) {
    load_tile(As, lda, A, m, k, row0, k0, bm, bk, vec);
    load_tile(Bs, ldb, B, k, n, k0, col0, bk, bn, vec);
    __syncthreads();
    for (int kk = 0; kk < bk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < FM; ++i) wmma::load_matrix_sync(a[i], As + (wr + i * 16) * lda + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], Bs + kk * ldb + wc + j * 16, ldb);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr + i * 16) * ldc + wc + j * 16, acc[i][j], ldc,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < bm * bn; idx += blockDim.x) {
    const int r = idx / bn, c = idx % bn;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < m && gc < n) C[(size_t)gr * n + gc] = __float2bfloat16(Cs[r * ldc + c]);
  }
}

template <int FM>
__global__ void __launch_bounds__(512)
matmul_f32(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
           int m, int n, int k, int bm, int bn, int bk, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = bk + 4, ldb = bn + 4;
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + bm * lda;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps_n = bn / 32;
  const int wr = (warp / warps_n) * 16 * FM, col = (warp % warps_n) * 32 + lane;
  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;

  float acc[16 * FM];
#pragma unroll
  for (int i = 0; i < 16 * FM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < k; k0 += bk) {
    load_tile(As, lda, A, m, k, row0, k0, bm, bk, vec);
    load_tile(Bs, ldb, B, k, n, k0, col0, bk, bn, vec);
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      const float b = Bs[kk * ldb + col];
#pragma unroll
      for (int i = 0; i < 16 * FM; ++i) acc[i] = fmaf(As[(wr + i) * lda + kk], b, acc[i]);
    }
    __syncthreads();
  }
  const int gc = col0 + col;
  if (gc >= n) return;
#pragma unroll
  for (int i = 0; i < 16 * FM; ++i) {
    const int gr = row0 + wr + i;
    if (gr < m) C[(size_t)gr * n + gc] = acc[i];
  }
}

static bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// Shared-memory bytes of one CTA; kernels/matmul.py mirrors this formula.
extern "C" int repro_matmul_smem_bytes(int dtype, int bm, int bn, int bk) {
  if (dtype == REPRO_BF16) {
    const int stage = (bm * (bk + 8) + bk * (bn + 8)) * 2;
    const int out = bm * (bn + 4) * 4;
    return stage > out ? stage : out;
  }
  return (bm * (bk + 4) + bk * (bn + 4)) * 4;
}

extern "C" int repro_matmul(const void* a, const void* b, void* c, int m, int n, int k,
                            int dtype, int bm, int bn, int bk, void* stream) {
  if (!pow2(bm) || bm < 16 || !pow2(bn) || bn < 32 || !pow2(bk) || bk < 16)
    return cudaErrorInvalidValue;
  const int fm = bm == 16 ? 1 : 2;
  const int threads = 32 * (bm / (16 * fm)) * (bn / 32);
  if (threads > 512) return cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return cudaSuccess;
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int smem = repro_matmul_smem_bytes(dtype, bm, bn, bk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  cudaError_t err;
  if (dtype == REPRO_BF16) {
    const bool vec = aligned && k % 8 == 0 && n % 8 == 0;
    const bf16 *A = static_cast<const bf16*>(a), *B = static_cast<const bf16*>(b);
    bf16* C = static_cast<bf16*>(c);
    if (fm == 1) {
      if ((err = allow_smem(matmul_bf16<1>, smem)) != cudaSuccess) return err;
      matmul_bf16<1><<<grid, threads, smem, s>>>(A, B, C, m, n, k, bm, bn, bk, vec);
    } else {
      if ((err = allow_smem(matmul_bf16<2>, smem)) != cudaSuccess) return err;
      matmul_bf16<2><<<grid, threads, smem, s>>>(A, B, C, m, n, k, bm, bn, bk, vec);
    }
  } else if (dtype == REPRO_F32) {
    const bool vec = aligned && k % 4 == 0 && n % 4 == 0;
    const float *A = static_cast<const float*>(a), *B = static_cast<const float*>(b);
    float* C = static_cast<float*>(c);
    if (fm == 1) {
      if ((err = allow_smem(matmul_f32<1>, smem)) != cudaSuccess) return err;
      matmul_f32<1><<<grid, threads, smem, s>>>(A, B, C, m, n, k, bm, bn, bk, vec);
    } else {
      if ((err = allow_smem(matmul_f32<2>, smem)) != cudaSuccess) return err;
      matmul_f32<2><<<grid, threads, smem, s>>>(A, B, C, m, n, k, bm, bn, bk, vec);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

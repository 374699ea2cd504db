// Fused gemm epilogue C[m,n] = act(A[m,k] @ B[k,n] + bias[n]) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused.py:_mba_kernel (driven by
// matmul_bias_act_pallas). Same function: fp32 accumulation, the bias added
// to the fp32 accumulator, the activation applied there (gelu in its tanh
// form, silu as h * sigmoid(h)), then one store in the input dtype, so the
// [m, n] pre-activation never goes through device memory.
//
// The tile loop is matmul.cu's for row-major operands: one CTA computes one
// (bm x bn) tile of C, looping over k in bk slices staged in shared memory
// with the ragged edges zero-filled (load_tile, common.cuh); bf16 runs on
// the tensor cores through WMMA 16x16x16 fragments, each warp owning a
// (16*FM x 32) sub-tile; fp32 runs on the SIMT cores with the same warp
// layout. After the k loop the fp32 tile goes through shared memory, where
// every thread adds the bias of its column, applies the activation and
// writes its elements, masked at the ragged m and n edges.
//
// Bound: the training gate projection [8192,896]@[896,4864] does 71.4
// GFLOP on 103 MB (inputs read once, output written once), about 690 flop
// a byte, above the 295 the H100 needs before its tensor cores are the
// limit: it is bound by operations.
// Like matmul.cu this first version has no cp.async/TMA pipelining and no
// wgmma; the epilogue saves the write and read of the [m, n] product that
// the unfused matmul + activation pair pays.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

enum { ACT_NONE = 0, ACT_GELU = 1, ACT_SILU = 2 };

__device__ __forceinline__ float apply_act(float h, int act) {
  if (act == ACT_GELU) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
  }
  if (act == ACT_SILU) return h / (1.f + expf(-h));
  return h;
}

template <int FM>
__global__ void __launch_bounds__(512)
mba_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
         const bf16* __restrict__ bias, bf16* __restrict__ C, int m, int n, int k, int act,
         int bm, int bn, int bk, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  // Shared tiles as in matmul.cu: A [bm][bk], B [bk][bn], rows padded by 8.
  const int lda = bk + 8, ldb = bn + 8, ldc = bn + 4;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + (bm + 8) * (bk + 8);
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
    load_tile(As, lda, A, k, m, k, row0, k0, bm, bk, vec);
    load_tile(Bs, ldb, B, n, k, n, k0, col0, bk, bn, vec);
    __syncthreads();
    for (int kk = 0; kk < bk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wr + i * 16) * lda + kk, lda);
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
    if (gr < m && gc < n) {
      const float h = Cs[r * ldc + c] + __bfloat162float(bias[gc]);
      C[(size_t)gr * n + gc] = __float2bfloat16(apply_act(h, act));
    }
  }
}

template <int FM>
__global__ void __launch_bounds__(512)
mba_f32(const float* __restrict__ A, const float* __restrict__ B,
        const float* __restrict__ bias, float* __restrict__ C, int m, int n, int k, int act,
        int bm, int bn, int bk, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = bk + 4, ldb = bn + 4;
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + (bm + 4) * (bk + 4);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps_n = bn / 32;
  const int wr = (warp / warps_n) * 16 * FM, col = (warp % warps_n) * 32 + lane;
  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;

  float acc[16 * FM];
#pragma unroll
  for (int i = 0; i < 16 * FM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < k; k0 += bk) {
    load_tile(As, lda, A, k, m, k, row0, k0, bm, bk, vec);
    load_tile(Bs, ldb, B, n, k, n, k0, col0, bk, bn, vec);
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
  const float bv = bias[gc];
#pragma unroll
  for (int i = 0; i < 16 * FM; ++i) {
    const int gr = row0 + wr + i;
    if (gr < m) C[(size_t)gr * n + gc] = apply_act(acc[i] + bv, act);
  }
}

static bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// Shared-memory bytes of one CTA: matmul.cu's formula (kernels/fused.py
// mirrors it; the space is matmul's).
extern "C" int repro_matmul_bias_act_smem_bytes(int dtype, int bm, int bn, int bk) {
  if (dtype == REPRO_BF16) {
    const int stage = ((bm + 8) * (bk + 8) + (bk + 8) * (bn + 8)) * 2;
    const int out = bm * (bn + 4) * 4;
    return stage > out ? stage : out;
  }
  return ((bm + 4) * (bk + 4) + (bk + 4) * (bn + 4)) * 4;
}

template <typename T, typename K>
static cudaError_t launch(K kernel, dim3 grid, int threads, int smem, cudaStream_t s,
                          const void* a, const void* b, const void* bias, void* c, int m,
                          int n, int k, int act, int bm, int bn, int bk, bool vec) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                     static_cast<const T*>(bias), static_cast<T*>(c), m, n, k,
                                     act, bm, bn, bk, vec);
  return cudaSuccess;
}

// out[m,n] = act(x[m,k] @ w[k,n] + b[n]); x, w, b and out contiguous,
// act 0 none, 1 gelu (tanh form), 2 silu.
extern "C" int repro_matmul_bias_act(const void* x, const void* w, const void* b, void* out,
                                     int m, int n, int k, int dtype, int act, int bm, int bn,
                                     int bk, void* stream) {
  if (!pow2(bm) || bm < 16 || !pow2(bn) || bn < 32 || !pow2(bk) || bk < 16)
    return cudaErrorInvalidValue;
  if (act < ACT_NONE || act > ACT_SILU) return cudaErrorInvalidValue;
  const int fm = bm == 16 ? 1 : 2;
  const int threads = 32 * (bm / (16 * fm)) * (bn / 32);
  if (threads > 512) return cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return cudaSuccess;
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int smem = repro_matmul_bias_act_smem_bytes(dtype, bm, bn, bk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const int V = dtype == REPRO_BF16 ? 8 : 4;
  const bool vec = aligned && k % V == 0 && n % V == 0;
  cudaError_t err;
  if (dtype == REPRO_BF16) {
    err = fm == 1 ? launch<bf16>(mba_bf16<1>, grid, threads, smem, s, x, w, b, out, m, n, k,
                                 act, bm, bn, bk, vec)
                  : launch<bf16>(mba_bf16<2>, grid, threads, smem, s, x, w, b, out, m, n, k,
                                 act, bm, bn, bk, vec);
  } else if (dtype == REPRO_F32) {
    err = fm == 1 ? launch<float>(mba_f32<1>, grid, threads, smem, s, x, w, b, out, m, n, k,
                                  act, bm, bn, bk, vec)
                  : launch<float>(mba_f32<2>, grid, threads, smem, s, x, w, b, out, m, n, k,
                                  act, bm, bn, bk, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

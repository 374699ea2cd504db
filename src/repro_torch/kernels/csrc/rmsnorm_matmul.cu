// Fused norm prologue C[m,n] = rmsnorm(X[m,d], scale[d]) @ W[d,n] for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused.py:_rmm_kernel (driven by
// rmsnorm_matmul_pallas). Same function and cast order: per row the fp32
// sum of squares over the true d, xn = x * rsqrt(mean + eps) rounded to the
// input dtype, times scale rounded again, then the product with W
// accumulated in fp32 and stored in the input dtype. The normalised rows
// never go through device memory.
//
// The TPU kernel keeps a whole (d, bn) weight tile resident in VMEM. At
// d = 896, bn = 128 that tile alone is 229,376 B, and with the row block it
// passes the 227 KB of shared memory a block may use. Here each CTA owns a
// (bm x bn) tile of C: it first normalises its bm rows (one warp a row, rows
// past m zero: decode's m = 8 fills half of the smallest 16-row WMMA tile,
// and those rows are never stored) into a resident [bm, d] block in shared
// memory, then streams W through shared memory in 64-row k slices, ragged
// edges zero-filled (load_tile, common.cuh), accumulating in fp32: WMMA
// 16x16x16 fragments in bf16, SIMT in fp32, one warp per (16*FM x 32)
// sub-tile as in matmul.cu. Each CTA recomputes the norm of its rows, as
// the TPU kernel does per n block; that is bm*d reads against its bn*d of W.
//
// Bound: at decode ([8,896] x [896,151936]) the kernel reads the 272 MB
// weight once and does 16 flops per weight element, far below the 295 flop
// a byte the H100 needs before its tensor cores are the limit: it is bound
// by device-memory bytes. This first version stages without cp.async/TMA
// pipelining.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int RMM_BK = 64;  // rows of W staged per k step

// Normalise rows [row0, row0 + bm) of x into Xn (leading dimension ldx,
// dk >= d columns, zero past d and past m).
template <typename T>
__device__ __forceinline__ void normalize_rows(T* __restrict__ Xn, int ldx, int dk,
                                               const T* __restrict__ x,
                                               const T* __restrict__ scale, int m, int d,
                                               float eps, int row0, int bm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  for (int r = warp; r < bm; r += nw) {
    const int gr = row0 + r;
    T* dst = Xn + r * ldx;
    if (gr >= m) {
      for (int c = lane; c < dk; c += 32) dst[c] = from_f32<T>(0.f);
      continue;
    }
    const T* src = x + (size_t)gr * d;
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = to_f32(src[c]);
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    for (int c = lane; c < dk; c += 32) {
      if (c < d) {
        const T xn = from_f32<T>(to_f32(src[c]) * inv);
        dst[c] = from_f32<T>(to_f32(xn) * to_f32(scale[c]));
      } else {
        dst[c] = from_f32<T>(0.f);
      }
    }
  }
}

static __host__ __device__ int round_up(int v, int to) { return (v + to - 1) / to * to; }

template <int FM>
__global__ void __launch_bounds__(512)
rmm_bf16(const bf16* __restrict__ X, const bf16* __restrict__ scale,
         const bf16* __restrict__ W, bf16* __restrict__ C, int m, int n, int d, float eps,
         int bm, int bn, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dk = round_up(d, RMM_BK);
  const int ldx = dk + 8, ldb = bn + 8, ldc = bn + 4;
  bf16* Xn = reinterpret_cast<bf16*>(smem);
  bf16* Bs = Xn + bm * ldx;
  float* Cs = reinterpret_cast<float*>(Bs);  // reused after the k loop

  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;
  normalize_rows(Xn, ldx, dk, X, scale, m, d, eps, row0, bm);

  const int warp = threadIdx.x / 32;
  const int warps_n = bn / 32;
  const int wr = (warp / warps_n) * 16 * FM, wc = (warp % warps_n) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][2];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < dk; k0 += RMM_BK) {
    load_tile(Bs, ldb, W, n, d, n, k0, col0, RMM_BK, bn, vec);
    __syncthreads();  // the first pass also publishes Xn
#pragma unroll
    for (int kk = 0; kk < RMM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], Xn + (wr + i * 16) * ldx + k0 + kk, ldx);
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
rmm_f32(const float* __restrict__ X, const float* __restrict__ scale,
        const float* __restrict__ W, float* __restrict__ C, int m, int n, int d, float eps,
        int bm, int bn, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dk = round_up(d, RMM_BK);
  const int ldx = dk + 4, ldb = bn + 4;
  float* Xn = reinterpret_cast<float*>(smem);
  float* Bs = Xn + bm * ldx;

  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;
  normalize_rows(Xn, ldx, dk, X, scale, m, d, eps, row0, bm);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps_n = bn / 32;
  const int wr = (warp / warps_n) * 16 * FM, col = (warp % warps_n) * 32 + lane;
  float acc[16 * FM];
#pragma unroll
  for (int i = 0; i < 16 * FM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < dk; k0 += RMM_BK) {
    load_tile(Bs, ldb, W, n, d, n, k0, col0, RMM_BK, bn, vec);
    __syncthreads();
    for (int kk = 0; kk < RMM_BK; ++kk) {
      const float b = Bs[kk * ldb + col];
#pragma unroll
      for (int i = 0; i < 16 * FM; ++i) acc[i] = fmaf(Xn[(wr + i) * ldx + k0 + kk], b, acc[i]);
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

// Shared-memory bytes of one CTA: the resident normalised rows plus the
// larger of the W stage and the fp32 output tile (kernels/fused.py mirrors
// this formula).
extern "C" int repro_rmsnorm_matmul_smem_bytes(int dtype, int bm, int bn, int d) {
  const int dk = round_up(d, RMM_BK);
  if (dtype == REPRO_BF16) {
    const int stage = (RMM_BK + 8) * (bn + 8) * 2;
    const int out = bm * (bn + 4) * 4;
    return bm * (dk + 8) * 2 + (stage > out ? stage : out);
  }
  return (bm * (dk + 4) + RMM_BK * (bn + 4)) * 4;
}

template <typename T, typename K>
static cudaError_t launch(K kernel, dim3 grid, int threads, int smem, cudaStream_t s,
                          const void* x, const void* scale, const void* w, void* c, int m,
                          int n, int d, float eps, int bm, int bn, bool vec) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(scale),
                                     static_cast<const T*>(w), static_cast<T*>(c), m, n, d,
                                     eps, bm, bn, vec);
  return cudaSuccess;
}

// out[m,n] = rmsnorm(x[m,d], scale[d]) @ w[d,n]; all contiguous.
extern "C" int repro_rmsnorm_matmul(const void* x, const void* scale, const void* w, void* out,
                                    int m, int n, int d, float eps, int dtype, int bm, int bn,
                                    void* stream) {
  if (!pow2(bm) || bm < 16 || !pow2(bn) || bn < 32) return cudaErrorInvalidValue;
  const int fm = bm == 16 ? 1 : 2;
  const int threads = 32 * (bm / (16 * fm)) * (bn / 32);
  if (threads > 512) return cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (d <= 0) return cudaErrorInvalidValue;
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int smem = repro_rmsnorm_matmul_smem_bytes(dtype, bm, bn, d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int V = dtype == REPRO_BF16 ? 8 : 4;
  const bool vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && n % V == 0;
  cudaError_t err;
  if (dtype == REPRO_BF16) {
    err = fm == 1 ? launch<bf16>(rmm_bf16<1>, grid, threads, smem, s, x, scale, w, out, m, n,
                                 d, eps, bm, bn, vec)
                  : launch<bf16>(rmm_bf16<2>, grid, threads, smem, s, x, scale, w, out, m, n,
                                 d, eps, bm, bn, vec);
  } else if (dtype == REPRO_F32) {
    err = fm == 1 ? launch<float>(rmm_f32<1>, grid, threads, smem, s, x, scale, w, out, m, n,
                                  d, eps, bm, bn, vec)
                  : launch<float>(rmm_f32<2>, grid, threads, smem, s, x, scale, w, out, m, n,
                                  d, eps, bm, bn, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

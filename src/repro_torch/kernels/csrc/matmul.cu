// Blocked matmul C[m,n] = A[m,k] @ B[k,n] for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/matmul.py:_matmul_kernel (driven by
// matmul_pallas). Same function: fp32 accumulation, output in the input
// dtype (C row-major, contiguous).
//
// Each operand is read in the layout in which it is stored, so the
// backward's transposed operands (ct @ w^T, x^T @ ct) need no copy: an
// operand is either row-major (element (r, c) at p[r*ld + c]) or
// transposed, i.e. column-major (element (r, c) at p[c*ld + r]), with its
// own leading dimension ld. A transposed tile is staged in shared memory in
// its stored layout (contiguous along the logical rows) and read by the
// WMMA col_major fragments, so both layouts load 16 bytes a thread.
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

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

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

// The (rows x cols) tile at (r0, c0) of a logical [R, C] operand stored
// row-major (TR = false) or transposed (TR = true), into shared memory in
// the stored layout: dst[r*ld + c] or dst[c*ld + r].
template <bool TR, typename T>
__device__ __forceinline__ void load_operand(T* __restrict__ dst, int ld,
                                             const T* __restrict__ src, int lds, int R,
                                             int C, int r0, int c0, int rows, int cols,
                                             bool vec) {
  if (TR)
    load_tile(dst, ld, src, lds, C, R, c0, r0, cols, rows, vec);
  else
    load_tile(dst, ld, src, lds, R, C, r0, c0, rows, cols, vec);
}

template <int FM, bool TA, bool TB>
__global__ void __launch_bounds__(512)
matmul_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C,
            int m, int n, int k, int lda_g, int ldb_g, int bm, int bn, int bk, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  // Shared tiles in the stored layout: A [bm][bk] or [bk][bm], B [bk][bn]
  // or [bn][bk], each row padded by 8 elements against bank conflicts.
  const int lda = (TA ? bm : bk) + 8, ldb = (TB ? bk : bn) + 8, ldc = bn + 4;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + (bm + 8) * (bk + 8);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the k loop
  using LayoutA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;

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
    load_operand<TA>(As, lda, A, lda_g, m, k, row0, k0, bm, bk, vec);
    load_operand<TB>(Bs, ldb, B, ldb_g, k, n, k0, col0, bk, bn, vec);
    __syncthreads();
    for (int kk = 0; kk < bk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> b[2];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int r = wr + i * 16;
        wmma::load_matrix_sync(a[i], TA ? As + kk * lda + r : As + r * lda + kk, lda);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wc + j * 16;
        wmma::load_matrix_sync(b[j], TB ? Bs + c * ldb + kk : Bs + kk * ldb + c, ldb);
      }
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

template <int FM, bool TA, bool TB>
__global__ void __launch_bounds__(512)
matmul_f32(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
           int m, int n, int k, int lda_g, int ldb_g, int bm, int bn, int bk, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  // Shared tiles in the stored layout, as in the bf16 kernel.
  const int lda = (TA ? bm : bk) + 4, ldb = (TB ? bk : bn) + 4;
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
    load_operand<TA>(As, lda, A, lda_g, m, k, row0, k0, bm, bk, vec);
    load_operand<TB>(Bs, ldb, B, ldb_g, k, n, k0, col0, bk, bn, vec);
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      const float b = TB ? Bs[col * ldb + kk] : Bs[kk * ldb + col];
#pragma unroll
      for (int i = 0; i < 16 * FM; ++i) {
        const int r = wr + i;
        acc[i] = fmaf(TA ? As[kk * lda + r] : As[r * lda + kk], b, acc[i]);
      }
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
// Each staged tile is padded on both sides so either layout fits.
extern "C" int repro_matmul_smem_bytes(int dtype, int bm, int bn, int bk) {
  if (dtype == REPRO_BF16) {
    const int stage = ((bm + 8) * (bk + 8) + (bk + 8) * (bn + 8)) * 2;
    const int out = bm * (bn + 4) * 4;
    return stage > out ? stage : out;
  }
  return ((bm + 4) * (bk + 4) + (bk + 4) * (bn + 4)) * 4;
}

template <typename T, int FM, bool TA, bool TB, typename K>
static cudaError_t launch_one(K kernel, dim3 grid, int threads, int smem, cudaStream_t s,
                              const void* a, const void* b, void* c, int m, int n, int k,
                              int lda, int ldb, int bm, int bn, int bk, bool vec) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                     static_cast<T*>(c), m, n, k, lda, ldb, bm, bn, bk, vec);
  return cudaSuccess;
}

template <typename T, int FM>
static cudaError_t launch_layout(bool ta, bool tb, dim3 grid, int threads, int smem,
                                 cudaStream_t s, const void* a, const void* b, void* c, int m,
                                 int n, int k, int lda, int ldb, int bm, int bn, int bk,
                                 bool vec) {
#define REPRO_MM(TA, TB)                                                                      \
  if (ta == TA && tb == TB) {                                                                 \
    if constexpr (sizeof(T) == 2)                                                             \
      return launch_one<T, FM, TA, TB>(matmul_bf16<FM, TA, TB>, grid, threads, smem, s, a, b, \
                                       c, m, n, k, lda, ldb, bm, bn, bk, vec);                \
    else                                                                                      \
      return launch_one<T, FM, TA, TB>(matmul_f32<FM, TA, TB>, grid, threads, smem, s, a, b,  \
                                       c, m, n, k, lda, ldb, bm, bn, bk, vec);                \
  }
  REPRO_MM(false, false)
  REPRO_MM(false, true)
  REPRO_MM(true, false)
  REPRO_MM(true, true)
#undef REPRO_MM
  return cudaErrorInvalidValue;
}

// C[m,n] = A[m,k] @ B[k,n]. ta/tb: operand stored transposed (column-major);
// lda/ldb: its leading dimension (the stride of its stored rows).
extern "C" int repro_matmul(const void* a, const void* b, void* c, int m, int n, int k,
                            int ta, int tb, int lda, int ldb, int dtype, int bm, int bn,
                            int bk, void* stream) {
  if (!pow2(bm) || bm < 16 || !pow2(bn) || bn < 32 || !pow2(bk) || bk < 16)
    return cudaErrorInvalidValue;
  const int fm = bm == 16 ? 1 : 2;
  const int threads = 32 * (bm / (16 * fm)) * (bn / 32);
  if (threads > 512) return cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (lda < (ta ? m : k) || ldb < (tb ? k : n)) return cudaErrorInvalidValue;
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int smem = repro_matmul_smem_bytes(dtype, bm, bn, bk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  const int V = dtype == REPRO_BF16 ? 8 : 4;
  const bool vec = aligned && lda % V == 0 && ldb % V == 0;
  cudaError_t err;
  if (dtype == REPRO_BF16) {
    err = fm == 1 ? launch_layout<bf16, 1>(ta, tb, grid, threads, smem, s, a, b, c, m, n, k,
                                           lda, ldb, bm, bn, bk, vec)
                  : launch_layout<bf16, 2>(ta, tb, grid, threads, smem, s, a, b, c, m, n, k,
                                           lda, ldb, bm, bn, bk, vec);
  } else if (dtype == REPRO_F32) {
    err = fm == 1 ? launch_layout<float, 1>(ta, tb, grid, threads, smem, s, a, b, c, m, n, k,
                                            lda, ldb, bm, bn, bk, vec)
                  : launch_layout<float, 2>(ta, tb, grid, threads, smem, s, a, b, c, m, n, k,
                                            lda, ldb, bm, bn, bk, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

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
// The kernels are gemm.cuh's, on matmul's routes and knob space, with its
// norm prologue: for up to 16 rows the swap-AB decode kernel, persistent
// over column tiles (gemm_decode_norm), above them wgmma from a TMA ring
// (gemm_tc<..., NORM>), split-k with the splits summed in a fixed order.
// Each CTA computes the inverse rms of its rows from global x before its
// k loop (once for all its column tiles on the decode route); the
// producer loads each k slice's scale into the ring stage beside x's and
// W's slices; the consumers normalise x's slice in shared memory after it
// lands, before wgmma reads it. Nothing of x is resident beyond the ring,
// so every width launches (the first port kept the whole normalised
// [bm, d] row block in shared memory, which at d = 8192 needed 281,984 B of
// the 232,448 a block may have).
//
// Two forms the tensor-core routes cannot take run the k-sliced loops
// below, which compute the rows' inverse rms into shared memory first and
// then normalise each [bm, bk] slice of x as they stage it: bf16 operands
// TMA cannot address (a row of x or W, or a scale base, that is not a
// multiple of 16 bytes, e.g. d = 100: WMMA 16x16x16 fragments) and fp32
// (SIMT fmaf; no model path runs it, the final norm -> unembed pair runs
// in the model dtype). The bf16 loop is also the yardstick a call reaches
// with force_loop.
//
// Bound: the decode unembed [8,896] x [896,151936] reads the 272 MB weight
// once and does 2 * 8 flops a weight element, far below the 295 flop a
// byte at which the H100's tensor cores become the limit: it is bound by
// device-memory bytes, 0.0820 ms at 3.35 TB/s (Mixtral's [8,4096] x
// [4096,32000] 0.0784, Jamba's [8,8192] x [8192,65536] 0.3209; the 64-row
// pool [64,896] x [896,151936], 128 flop a weight byte, 0.0871). The
// decode kernel streams W through the ring as matmul's decode route does;
// what the prologue adds is a CTA's one read of its rows of x from L2 for
// the statistics and a rewrite of a 16 x bk slice of x a k step in shared
// memory. On an H100 80GB HBM3 at 700 W (chip_smoke.py) the qwen2_0_5b row
// runs at matmul's decode time for the same product; the statistics still
// show where a CTA reads many rows or wide ones (the tc route's 64 rows,
// Jamba's 8192 columns: PERF.md).
#include "gemm.cuh"

namespace {

using namespace nvcuda;

// inv[r] = the fp32 inverse rms of row row0 + r of x [m, d] (0 at or past
// m), r < bm: one warp a row.
template <typename T>
__device__ void rows_inv_rms(float* __restrict__ inv, const T* __restrict__ x, int m, int d,
                             float eps, int row0, int bm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  for (int r = warp; r < bm; r += nw) {
    const int gr = row0 + r;
    float ss = 0.f;
    if (gr < m)
      for (int c = lane; c < d; c += 32) {
        const float v = to_f32(x[(size_t)gr * d + c]);
        ss = fmaf(v, v, ss);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) inv[r] = gr < m ? rsqrtf(ss / static_cast<float>(d) + eps) : 0.f;
  }
}

// The [bm, bk] slice of the normalised rows at (row0, k0) into Xs (leading
// dimension ld): bf16(bf16(x * inv) * scale) in bf16, x * inv * scale in
// fp32; zero past m and past d.
template <typename T>
__device__ void load_norm_slice(T* __restrict__ Xs, int ld, const T* __restrict__ x,
                                const T* __restrict__ scale, const float* __restrict__ inv,
                                int m, int d, int row0, int k0, int bm, int bk) {
  for (int i = threadIdx.x; i < bm * bk; i += blockDim.x) {
    const int r = i / bk, c = i % bk, gr = row0 + r, gk = k0 + c;
    T v = from_f32<T>(0.f);
    if (gr < m && gk < d) {
      const T xn = from_f32<T>(to_f32(x[(size_t)gr * d + gk]) * inv[r]);
      v = from_f32<T>(to_f32(xn) * to_f32(scale[gk]));
    }
    Xs[r * ld + c] = v;
  }
}

// Shared memory of one loop CTA: the rows' inverse rms, then the larger of
// the staged slices and (bf16) the fp32 output tile, each staged row padded.
static int loop_smem(int dtype, int bm, int bn, int bk) {
  if (dtype == REPRO_BF16) {
    const int stage = (bm * (bk + 8) + bk * (bn + 8)) * 2;
    const int out = bm * (bn + 4) * 4;
    return bm * 4 + (stage > out ? stage : out);
  }
  return bm * 4 + (bm * (bk + 4) + bk * (bn + 4)) * 4;
}

// One CTA computes a (bm x bn) tile of C, each warp a (16*FM x 32)
// sub-tile with WMMA fragments, over k slices of bk: x's slice normalised
// on its way into shared memory, W's staged as it is (load_tile).
template <int FM>
__global__ void __launch_bounds__(512)
rmm_wmma(const bf16* __restrict__ X, const bf16* __restrict__ scale, const bf16* __restrict__ W,
         bf16* __restrict__ C, int m, int n, int d, float eps, int bm, int bn, int bk, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* inv = reinterpret_cast<float*>(smem);
  const int ldx = bk + 8, ldb = bn + 8, ldc = bn + 4;
  bf16* Xs = reinterpret_cast<bf16*>(smem + bm * 4);
  bf16* Bs = Xs + bm * ldx;
  float* Cs = reinterpret_cast<float*>(Xs);  // reused after the k loop

  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;
  rows_inv_rms(inv, X, m, d, eps, row0, bm);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int warps_n = bn / 32;
  const int wr = (warp / warps_n) * 16 * FM, wc = (warp % warps_n) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][2];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < d; k0 += bk) {
    load_norm_slice(Xs, ldx, X, scale, inv, m, d, row0, k0, bm, bk);
    load_tile(Bs, ldb, W, n, d, n, k0, col0, bk, bn, vec);
    __syncthreads();
    for (int kk = 0; kk < bk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], Xs + (wr + i * 16) * ldx + kk, ldx);
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

// fp32: the same loop on the SIMT cores, a lane one column of its warp's
// (16*FM x 32) sub-tile.
template <int FM>
__global__ void __launch_bounds__(512)
rmm_simt(const float* __restrict__ X, const float* __restrict__ scale,
         const float* __restrict__ W, float* __restrict__ C, int m, int n, int d, float eps,
         int bm, int bn, int bk, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* inv = reinterpret_cast<float*>(smem);
  const int ldx = bk + 4, ldb = bn + 4;
  float* Xs = inv + bm;
  float* Bs = Xs + bm * ldx;

  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;
  rows_inv_rms(inv, X, m, d, eps, row0, bm);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps_n = bn / 32;
  const int wr = (warp / warps_n) * 16 * FM, col = (warp % warps_n) * 32 + lane;
  float acc[16 * FM];
#pragma unroll
  for (int i = 0; i < 16 * FM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < d; k0 += bk) {
    load_norm_slice(Xs, ldx, X, scale, inv, m, d, row0, k0, bm, bk);
    load_tile(Bs, ldb, W, n, d, n, k0, col0, bk, bn, vec);
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      const float b = Bs[kk * ldb + col];
#pragma unroll
      for (int i = 0; i < 16 * FM; ++i) acc[i] = fmaf(Xs[(wr + i) * ldx + kk], b, acc[i]);
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

template <typename T, typename K>
cudaError_t launch_loop(K kernel, dim3 grid, int threads, int smem, cudaStream_t s,
                        const void* x, const void* scale, const void* w, void* c, int m, int n,
                        int d, float eps, int bm, int bn, int bk, bool vec) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(scale),
                                     static_cast<const T*>(w), static_cast<T*>(c), m, n, d, eps,
                                     bm, bn, bk, vec);
  return cudaGetLastError();
}

// The k-sliced loops: route GEMM_WMMA (bf16) or GEMM_LOOP (fp32), at the
// tiles kernels/matmul.py:wmma_tiles gives.
int loop(const void* x, const void* scale, const void* w, void* c, int m, int n, int d,
         float eps, int dtype, int route, int bm, int bn, int bk, cudaStream_t s) {
  const bool bf = dtype == REPRO_BF16;
  if ((route == GEMM_WMMA) != bf || (route != GEMM_WMMA && route != GEMM_LOOP) ||
      !gemm::pow2(bm) || bm < 16 || !gemm::pow2(bn) || bn < 32 || !gemm::pow2(bk) || bk < 16)
    return cudaErrorInvalidValue;
  const int fm = bm == 16 ? 1 : 2;
  const int threads = 32 * (bm / (16 * fm)) * (bn / 32);
  const int smem = loop_smem(dtype, bm, bn, bk);
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  if (threads > 512 || smem > 232448 || grid.y > 65535) return cudaErrorInvalidValue;
  const int V = bf ? 8 : 4;
  const bool vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && n % V == 0;
  if (bf)
    return fm == 1 ? launch_loop<bf16>(rmm_wmma<1>, grid, threads, smem, s, x, scale, w, c, m, n,
                                       d, eps, bm, bn, bk, vec)
                   : launch_loop<bf16>(rmm_wmma<2>, grid, threads, smem, s, x, scale, w, c, m, n,
                                       d, eps, bm, bn, bk, vec);
  return fm == 1 ? launch_loop<float>(rmm_simt<1>, grid, threads, smem, s, x, scale, w, c, m, n,
                                      d, eps, bm, bn, bk, vec)
                 : launch_loop<float>(rmm_simt<2>, grid, threads, smem, s, x, scale, w, c, m, n,
                                      d, eps, bm, bn, bk, vec);
}

}  // namespace

// out[m,n] = rmsnorm(x[m,d], scale[d]) @ w[d,n]; x and w contiguous. route:
// gemm.cuh's code (GEMM_TC, GEMM_DECODE: its NORM kernels, split-k over ws
// [splits, m, n] with kps k slices a split; GEMM_WMMA, GEMM_LOOP: the
// k-sliced loops of bf16 and fp32).
extern "C" int repro_rmsnorm_matmul(const void* x, const void* scale, const void* w, void* out,
                                    void* ws, int m, int n, int d, float eps, int dtype,
                                    int route, int bm, int bn, int bk, int stages, int splits,
                                    int kps, void* stream) {
  if (m <= 0 || n <= 0) return cudaSuccess;
  if (d <= 0 || scale == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route != GEMM_TC && route != GEMM_DECODE)
    return splits == 1 ? loop(x, scale, w, out, m, n, d, eps, dtype, route, bm, bn, bk, s)
                       : cudaErrorInvalidValue;
  gemm::Problem p{x,      w,     out,    static_cast<float*>(ws),
                  1,      m,     n,      d,
                  0,      0,     d,      n,
                  0,      0,     dtype,  route,
                  bm,     bn,    bk,     stages,
                  splits, kps,   s};
  p.norm_scale = scale;
  p.eps = eps;
  return gemm::launch<true>(p);
}

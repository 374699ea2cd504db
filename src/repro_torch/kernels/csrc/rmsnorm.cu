// Row RMSNorm for Hopper (sm_90a):
//   out[r, :] = cast((x[r, :] * invrms[r]) * w)   (product in fp32, then cast)
//   invrms[r] = rsqrt(mean(x[r, :]^2) + eps)      (fp32)
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:_rmsnorm_kernel (driven
// by rmsnorm_pallas), with the same order of operations: the weight
// multiplies in fp32 before the cast.
//
// Bound: bytes. A row is read once and written once (about 2 flops a byte
// moved), so the kernel is built around the card's memory path:
//
// * 16-byte accesses: each thread moves 8 bf16 (or 4 fp32) elements a load
//   or store, neighbouring lanes on neighbouring 16-byte vectors. A row
//   whose base is not 16-byte aligned (an odd d in bf16, an offset view),
//   and the tail of a d that is not a multiple of the vector, take element
//   loads into the same registers.
// * One read of x: a team of team_warps warps owns a row, each thread up to
//   NV vectors of it (at most 32 bf16 values, in registers as loaded), so
//   the sum of squares and the output pass use the same registers. A wide
//   row (d = 4096, 8192) takes several warps, which combine their partial
//   sums through shared memory (one slot a warp, double-buffered so one
//   barrier a row suffices). Rows wider than MAX_WARPS warps hold (bf16 d
//   above 16,384, fp32 above 8,192) are not kept resident: the output pass
//   reads them again.
// * The weight is read once a CTA: each thread keeps its columns' weight
//   vectors in registers and reuses them for every row its team walks.
//
// block_rows (the knob, kernels/rmsnorm.py) is the rows a CTA takes. A CTA
// holds min(block_rows, MAX_WARPS / team_warps) teams of at most
// MAX_WARPS warps in all, and its teams walk its rows in turn.
#include "vec.cuh"

constexpr int NV = 4;           // 16-byte vectors of a row a thread holds
constexpr int MAX_WARPS = 16;   // warps a CTA

// out's elements [c, c + V) = cast((x * r) * w), the same way round.
template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, int c, int d, bool vec,
                                          const uint4& xv, const uint4& wv, float r) {
  constexpr int V = 16 / sizeof(T);
  float v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = (elem<T>(xv, j) * r) * elem<T>(wv, j);
  store_floats(p, c, d, vec, v);
}

template <typename T>
__device__ __forceinline__ float sum_sq(const uint4& u) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j) s = fmaf(elem<T>(u, j), elem<T>(u, j), s);
  return s;
}

// RESIDENT: a thread's NV vectors cover its share of the row, which stays
// in registers; else the thread strides the row and reads it twice.
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(32 * MAX_WARPS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               float* __restrict__ invrms, int rows, int d, float eps, int block_rows,
               int team_warps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float part[2][MAX_WARPS];
  const int tt = 32 * team_warps;                       // threads of a team
  const int team = threadIdx.x / tt, t = threadIdx.x % tt;
  const int teams = blockDim.x / tt;
  const int warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * block_rows, r1 = min(rows, r0 + block_rows);
  const bool wvec = aligned16(w);

  uint4 wv[NV];                                         // this thread's weight, once a CTA
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * tt + t) * V;
    wv[i] = RESIDENT && c < d ? load_vec(w, c, d, wvec) : make_uint4(0u, 0u, 0u, 0u);
  }

  // every thread takes every step, so the barrier below is uniform
  const int steps = (block_rows + teams - 1) / teams;
  for (int it = 0; it < steps; ++it) {
    const int row = r0 + it * teams + team;
    const bool live = row < r1;
    const T* xr = x + (size_t)(live ? row : 0) * d;
    T* orow = out + (size_t)(live ? row : 0) * d;
    const bool xvec = aligned16(xr), ovec = aligned16(orow);
    uint4 xv[NV];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * tt + t) * V;
      xv[i] = RESIDENT && live && c < d ? load_vec(xr, c, d, xvec) : make_uint4(0u, 0u, 0u, 0u);
      ss += sum_sq<T>(xv[i]);
    }
    if (!RESIDENT && live)
      for (int c = t * V; c < d; c += tt * V) ss += sum_sq<T>(load_vec(xr, c, d, xvec));
    ss = warp_sum(ss);
    if (team_warps > 1) {
      if (threadIdx.x % 32 == 0) part[it & 1][warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int q = 0; q < team_warps; ++q) ss += part[it & 1][team * team_warps + q];
    }
    if (!live) continue;
    const float r = rsqrtf(ss / d + eps);
    if (RESIDENT) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = (i * tt + t) * V;
        if (c < d) store_vec(orow, c, d, ovec, xv[i], wv[i], r);
      }
    } else {
      for (int c = t * V; c < d; c += tt * V)
        store_vec(orow, c, d, ovec, load_vec(xr, c, d, xvec), load_vec(w, c, d, wvec), r);
    }
    if (t == 0) invrms[row] = r;
  }
}

template <typename T>
static cudaError_t launch(const void* x, const void* w, void* out, float* invrms, int rows,
                          int d, float eps, int block_rows, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int vecs = (d + V - 1) / V;
  int team_warps = (vecs + 32 * NV - 1) / (32 * NV);
  const bool resident = team_warps <= MAX_WARPS;
  team_warps = team_warps < 1 ? 1 : resident ? team_warps : MAX_WARPS;
  int teams = MAX_WARPS / team_warps;
  teams = block_rows < teams ? block_rows : teams;
  const dim3 grid((rows + block_rows - 1) / block_rows);
  const int threads = 32 * team_warps * teams;
  auto kernel = resident ? rmsnorm_kernel<T, true> : rmsnorm_kernel<T, false>;
  kernel<<<grid, threads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                  static_cast<T*>(out), invrms, rows, d, eps, block_rows,
                                  team_warps);
  return cudaGetLastError();
}

extern "C" int repro_rmsnorm(const void* x, const void* w, void* out, float* invrms,
                             int rows, int d, float eps, int dtype, int block_rows,
                             void* stream) {
  if (block_rows < 1 || block_rows > 32 || d < 0) return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(x, w, out, invrms, rows, d, eps, block_rows, s);
  if (dtype == REPRO_F32) return launch<float>(x, w, out, invrms, rows, d, eps, block_rows, s);
  return cudaErrorInvalidValue;
}

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
#include "common.cuh"

constexpr int NV = 4;           // 16-byte vectors of a row a thread holds
constexpr int MAX_WARPS = 16;   // warps a CTA

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Raw element bits, so that a 16-byte vector and its element loads fill
// the same uint4.
template <typename T> struct Bits;
template <> struct Bits<float> { using type = uint32_t; };
template <> struct Bits<__nv_bfloat16> { using type = uint16_t; };

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// Element j of a vector, as fp32.
template <typename T> __device__ __forceinline__ float elem(const uint4& u, int j);
template <> __device__ __forceinline__ float elem<float>(const uint4& u, int j) {
  return __uint_as_float(word(u, j));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int j) {
  return __uint_as_float(j % 2 ? word(u, j / 2) & 0xffff0000u : word(u, j / 2) << 16);
}

// Element j of a 16-byte vector of V elements: word j * 4 / V of the uint4,
// from bit (128 / V) * (j % (V / 4)).
template <int V> __device__ __forceinline__ int word_of(int j) { return j * 4 / V; }
template <int V> __device__ __forceinline__ int shift_of(int j) { return 128 / V * (j % (V / 4)); }

// Element j's bits when stored as T (bf16: round to nearest even).
template <typename T> __device__ __forceinline__ uint32_t bits(float v);
template <> __device__ __forceinline__ uint32_t bits<float>(float v) { return __float_as_uint(v); }
template <> __device__ __forceinline__ uint32_t bits<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The vector of p's elements [c, c + V): one 16-byte load when `vec` (p
// 16-byte aligned) and the vector lies inside d, else element loads, zero
// past d.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ p, int c, int d, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec && c + V <= d) return __ldg(reinterpret_cast<const uint4*>(p + c));
  using B = typename Bits<T>::type;
  const B* q = reinterpret_cast<const B*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const uint32_t b = c + j < d ? (uint32_t)q[c + j] : 0u;
    w[word_of<V>(j)] |= b << shift_of<V>(j);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// out's elements [c, c + V) = cast((x * r) * w), the same way round.
template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, int c, int d, bool vec,
                                          const uint4& xv, const uint4& wv, float r) {
  constexpr int V = 16 / sizeof(T);
  using B = typename Bits<T>::type;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < V; ++j)
    w[word_of<V>(j)] |= bits<T>((elem<T>(xv, j) * r) * elem<T>(wv, j)) << shift_of<V>(j);
  if (vec && c + V <= d) {
    *reinterpret_cast<uint4*>(p + c) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  B* q = reinterpret_cast<B*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (c + j < d) q[c + j] = (B)(w[word_of<V>(j)] >> shift_of<V>(j));
}

template <typename T>
__device__ __forceinline__ float sum_sq(const uint4& u) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16 / (int)sizeof(T); ++j) s = fmaf(elem<T>(u, j), elem<T>(u, j), s);
  return s;
}

static __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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

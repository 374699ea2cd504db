// Softmax cross entropy over a large vocabulary, forward and backward, for
// Hopper (sm_90a).
//
// Forward replaces the TPU kernel repro/kernels/xent.py:_xent_kernel
// (driven by softmax_xent_pallas): per row, an online logsumexp over the
// vocabulary plus the label logit gathered as its block passes;
//   lse[r]  = m + log(max(l, 1e-30))        (fp32)
//   loss[r] = lse[r] - logits[r, label[r]]  (fp32; 0 for a label off the row)
// Backward replaces repro/kernels/xent.py:_xent_bwd_kernel (driven by
// softmax_xent_bwd_pallas): one streaming pass from the saved lse,
//   d_logits[r, c] = (exp(x[r, c] - lse[r]) - (c == label[r])) * ct[r]
// written in the logits' dtype.
//
// Forward: one warp owns a row and streams it block_v columns a step; each
// lane holds its block_v/32 values in registers (16-byte loads where the
// row allows), so a step issues all its loads before any arithmetic, and
// the running max is rescaled once a step, not once an element. Columns
// past the vocabulary are masked in the kernel (the TPU kernel pads them
// with -1e30): no pad copy. block_rows warps (at most 16) share a CTA.
// Backward: a warp writes one row's block_v columns; the grid covers
// (vocab blocks, row blocks).
//
// Bound: bytes. The forward reads the logits once (0.62 GB for a
// [2048, 151936] bf16 chunk, about 0.19 ms at 3.35 TB/s); the backward
// reads them once and writes d_logits once (1.24 GB, about 0.37 ms). The
// arithmetic, about one exp per element, is far below the card's rate.
#include "common.cuh"

#define NEG_INF_F (-1e30f)

__device__ __forceinline__ float warp_sum_x(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max_x(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Column of the lane's j-th value in the step starting at c0.
template <typename T, bool VEC>
__device__ __forceinline__ int col_of(int j, int c0, int lane) {
  constexpr int W = 16 / sizeof(T);
  return VEC ? c0 + ((j / W) * 32 + lane) * W + j % W : c0 + j * 32 + lane;
}

template <typename T, int N, bool VEC>
__device__ __forceinline__ void load_step(float (&v)[N], const T* __restrict__ row, int c0,
                                          int V, int lane) {
  if constexpr (VEC) {
    constexpr int W = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < N / W; ++q) {
      const int col = c0 + (q * 32 + lane) * W;
      if (col + W <= V) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + col));
        const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < W; ++e) v[q * W + e] = to_f32(t[e]);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) v[q * W + e] = col + e < V ? to_f32(row[col + e]) : NEG_INF_F;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int col = c0 + j * 32 + lane;
      v[j] = col < V ? to_f32(row[col]) : NEG_INF_F;
    }
  }
}

// At most 512 threads (block_rows <= 16), so the compiler may give each
// thread 128 registers: the 2048-column step holds 64 values a lane.
template <typename T, int N, bool VEC>
__global__ void __launch_bounds__(512) xent_fwd(const T* __restrict__ logits, const long long* __restrict__ labels,
                         float* __restrict__ loss, float* __restrict__ lse, int rows, int V) {
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * warps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = logits + (size_t)row * V;
  const long long label = labels[row];
  constexpr int BV = N * 32;
  float m = NEG_INF_F, l = 0.f, ll = 0.f;
  for (int c0 = 0; c0 < V; c0 += BV) {
    float v[N];
    load_step<T, N, VEC>(v, xr, c0, V, lane);
    float cmax = NEG_INF_F;
#pragma unroll
    for (int j = 0; j < N; ++j) cmax = fmaxf(cmax, v[j]);
    const float m_new = fmaxf(m, cmax);
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) acc += expf(v[j] - m_new);
    l = l * expf(m - m_new) + acc;
    m = m_new;
    // a label past the row (in the masked tail of the last step) is off it
    if (label >= c0 && label < c0 + BV && label < V) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (col_of<T, VEC>(j, c0, lane) == label) ll = v[j];
    }
  }
  // Lanes that saw only masked columns carry m = -1e30; the rescale by
  // exp(m - M) erases them.
  const float M = warp_max_x(m);
  const float L = warp_sum_x(l * expf(m - M));
  ll = warp_sum_x(ll);
  if (lane == 0) {
    const float z = M + logf(fmaxf(L, 1e-30f));
    lse[row] = z;
    loss[row] = z - ll;
  }
}

template <typename T, bool VEC>
__global__ void xent_bwd(const float* __restrict__ ct, const T* __restrict__ logits,
                         const long long* __restrict__ labels, const float* __restrict__ lse,
                         T* __restrict__ dl, int rows, int V, int block_v) {
  const int warps = blockDim.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.y * warps + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t off = (size_t)row * V;
  const long long label = labels[row];
  const float z = lse[row], g = ct[row];
  const int c0 = blockIdx.x * block_v;
  const int c1 = min(c0 + block_v, V);
  constexpr int W = VEC ? 16 / sizeof(T) : 1;
  for (int col = c0 + lane * W; col < c1; col += 32 * W) {
    if (VEC && col + W <= V) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(logits + off + col));
      const T* t = reinterpret_cast<const T*>(&u);
      uint4 o;
      T* ot = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int e = 0; e < W; ++e)
        ot[e] = from_f32<T>((expf(to_f32(t[e]) - z) - (col + e == label ? 1.f : 0.f)) * g);
      *reinterpret_cast<uint4*>(dl + off + col) = o;
    } else {
      for (int e = 0; e < W && col + e < V; ++e) {
        const float x = to_f32(logits[off + col + e]);
        dl[off + col + e] = from_f32<T>((expf(x - z) - (col + e == label ? 1.f : 0.f)) * g);
      }
    }
  }
}

template <typename T, int N, bool VEC>
static void launch_fwd(int grid, int threads, cudaStream_t s, const void* logits,
                       const long long* labels, float* loss, float* lse, int rows, int V) {
  xent_fwd<T, N, VEC><<<grid, threads, 0, s>>>(static_cast<const T*>(logits), labels, loss, lse,
                                               rows, V);
}

template <typename T, bool VEC>
static int dispatch_fwd(int block_v, int grid, int threads, cudaStream_t s, const void* logits,
                        const long long* labels, float* loss, float* lse, int rows, int V) {
  switch (block_v) {
    case 256: launch_fwd<T, 8, VEC>(grid, threads, s, logits, labels, loss, lse, rows, V); break;
    case 512: launch_fwd<T, 16, VEC>(grid, threads, s, logits, labels, loss, lse, rows, V); break;
    case 1024: launch_fwd<T, 32, VEC>(grid, threads, s, logits, labels, loss, lse, rows, V); break;
    case 2048: launch_fwd<T, 64, VEC>(grid, threads, s, logits, labels, loss, lse, rows, V); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

static bool xent_vec(const void* p, int V, int dtype) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && V % (dtype == REPRO_BF16 ? 8 : 4) == 0;
}

extern "C" int repro_softmax_xent(const void* logits, const long long* labels, float* loss,
                                  float* lse, int rows, int V, int dtype, int block_rows,
                                  int block_v, void* stream) {
  if (block_rows < 1 || block_rows > 16 || V < 1) return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (rows + block_rows - 1) / block_rows, threads = 32 * block_rows;
  const bool vec = xent_vec(logits, V, dtype);
  int err;
  if (dtype == REPRO_BF16)
    err = vec ? dispatch_fwd<__nv_bfloat16, true>(block_v, grid, threads, s, logits, labels,
                                                  loss, lse, rows, V)
              : dispatch_fwd<__nv_bfloat16, false>(block_v, grid, threads, s, logits, labels,
                                                   loss, lse, rows, V);
  else if (dtype == REPRO_F32)
    err = vec ? dispatch_fwd<float, true>(block_v, grid, threads, s, logits, labels, loss, lse,
                                          rows, V)
              : dispatch_fwd<float, false>(block_v, grid, threads, s, logits, labels, loss, lse,
                                           rows, V);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" int repro_softmax_xent_bwd(const float* ct, const void* logits,
                                      const long long* labels, const float* lse, void* dl,
                                      int rows, int V, int dtype, int block_rows, int block_v,
                                      void* stream) {
  if (block_rows < 1 || block_rows > 16 || block_v < 32 || V < 1) return cudaErrorInvalidValue;
  if (rows <= 0) return cudaSuccess;
  const dim3 grid((V + block_v - 1) / block_v, (rows + block_rows - 1) / block_rows);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 32 * block_rows;
  const bool vec = xent_vec(logits, V, dtype) && reinterpret_cast<uintptr_t>(dl) % 16 == 0;
  if (dtype == REPRO_BF16) {
    typedef __nv_bfloat16 T;
    if (vec)
      xent_bwd<T, true><<<grid, threads, 0, s>>>(ct, static_cast<const T*>(logits), labels, lse,
                                                 static_cast<T*>(dl), rows, V, block_v);
    else
      xent_bwd<T, false><<<grid, threads, 0, s>>>(ct, static_cast<const T*>(logits), labels,
                                                  lse, static_cast<T*>(dl), rows, V, block_v);
  } else if (dtype == REPRO_F32) {
    typedef float T;
    if (vec)
      xent_bwd<T, true><<<grid, threads, 0, s>>>(ct, static_cast<const T*>(logits), labels, lse,
                                                 static_cast<T*>(dl), rows, V, block_v);
    else
      xent_bwd<T, false><<<grid, threads, 0, s>>>(ct, static_cast<const T*>(logits), labels,
                                                  lse, static_cast<T*>(dl), rows, V, block_v);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

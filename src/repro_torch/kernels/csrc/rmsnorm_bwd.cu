// RMSNorm backward for Hopper (sm_90a), from the forward's saved inverse rms:
//   g        = ct * w                                  (fp32)
//   dx[r, :] = g * r - x * r^3 * mean(g * x)           (cast to x's dtype)
//   dw       = sum over rows of ct * x * r             (cast to w's dtype)
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:_rmsnorm_bwd_kernel
// (driven by rmsnorm_bwd_pallas). The TPU kernel carries dw in scratch
// across a sequential row grid; CUDA blocks run in any order, so here each
// CTA writes its own fp32 partial of dw and a second small kernel sums the
// partials in a fixed order. No atomics: dx and dw are the same from run to
// run.
//
// Bound: bytes. ct and x are read and dx written once (about 3 flops a
// byte moved), so the kernel is built around the card's memory path, as
// csrc/rmsnorm.cu is:
//
// * 16-byte accesses (csrc/vec.cuh), element loads for an odd width, an
//   unaligned row and the tail.
// * One read of ct and x: a team of team_warps warps owns a row, each
//   thread up to NV vectors of it, held in registers between the sum of
//   g * x (warp shuffles, then the team's warps through shared memory,
//   double-buffered behind the team's own named barrier) and the dx pass.
//   Rows wider than MAX_WARPS warps hold (bf16 d above 16,384, fp32 above
//   8,192) are read twice.
// * The weight is read once a CTA, into registers.
// * dw without shared-memory traffic a row: each thread keeps the fp32 dw
//   partial of its own columns in registers across every row its team
//   walks; at the end the CTA sums its teams' partials in team order (a
//   [teams][d] array, at most 64 KB: teams x d never exceeds the 16 warps'
//   registers' worth of columns) into its row of the partials. A row too
//   wide for registers takes one team a CTA, which accumulates straight
//   into its row of the partials.
//
// The first port gave a row one warp with 2-byte loads, read the
// row twice and the weight every element, and added every element into a
// [block_rows][d] fp32 shared array, which also refused any d whose
// block_rows x d x 4 bytes passed 227 KB (d = 8192 at 8 rows).
//
// block_rows (the knob, kernels/rmsnorm.py) is the teams a CTA holds, at
// most MAX_WARPS / team_warps. kernels/rmsnorm.py:rmsnorm_bwd_ctas picks the
// CTA count (512 threads an SM, at most a team's worth of rows each) and
// sizes the partials with it; the kernels are right for any count.
#include "vec.cuh"

constexpr int MAX_WARPS = 16;   // warps a CTA

// A row's team: warps of 32 * nv 16-byte vectors, at most MAX_WARPS (else
// the row is not held in registers). nv = 2 for rows of up to 8 such warps
// (bf16 d <= 4096), which leaves the registers for more rows in flight an
// SM, and 4 above, so that 16 warps hold a row of up to 16,384 bf16.
struct Team {
  int nv, warps;
  bool resident;
  __host__ __device__ Team(int d, int itemsize) {
    const int vecs = (d + 16 / itemsize - 1) / (16 / itemsize);
    nv = (vecs + 63) / 64 <= 8 ? 2 : 4;
    const int w = (vecs + 32 * nv - 1) / (32 * nv);
    resident = w <= MAX_WARPS;
    warps = w < 1 ? 1 : (resident ? w : MAX_WARPS);
  }
};

__device__ __forceinline__ void team_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// NV: the 16-byte vectors of a row a thread holds (Team::nv).
template <typename T, int NV, bool RESIDENT>
__global__ void __launch_bounds__(32 * MAX_WARPS)
rmsnorm_bwd_rows(const T* __restrict__ ct, const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ invrms, T* __restrict__ dx,
                 float* __restrict__ partial, int rows, int d, int team_warps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float part[2][MAX_WARPS];
  extern __shared__ __align__(16) float red[];          // [teams][d], RESIDENT only
  const int tt = 32 * team_warps;                       // threads of a team
  const int team = threadIdx.x / tt, t = threadIdx.x % tt;
  const int teams = blockDim.x / tt;
  const int warp = threadIdx.x / 32;
  const bool wvec = aligned16(w);
  float* pr = partial + (size_t)blockIdx.x * d;         // this CTA's dw partial

  uint4 wv[NV];                                         // this thread's weight, once a CTA
  float acc[NV][V];                                     // its columns' dw partial
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * tt + t) * V;
    wv[i] = RESIDENT && c < d ? load_vec(w, c, d, wvec) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[i][j] = 0.f;
  }
  if (!RESIDENT)           // one team a CTA; each thread zeroes the columns it adds into
    for (int c = t * V; c < d; c += tt * V)
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (c + j < d) pr[c + j] = 0.f;

  // the teams stride over the rows; every thread of a team takes every
  // step, so the team's barrier is uniform
  const int first = blockIdx.x * teams, stride = gridDim.x * teams;
  const int steps = first < rows ? (rows - first + stride - 1) / stride : 0;
  for (int it = 0; it < steps; ++it) {
    const int row = first + it * stride + team;
    const bool live = row < rows;
    const size_t off = (size_t)(live ? row : 0) * d;
    const T* cr = ct + off;
    const T* xr = x + off;
    T* dr = dx + off;
    const bool cvec = aligned16(cr), xvec = aligned16(xr), dvec = aligned16(dr);
    const float r = live ? invrms[row] : 0.f;           // read beside the row, not after it
    uint4 cv[NV], xv[NV];
    // every load of the row before any use, so that all are in flight at once
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * tt + t) * V;
      const bool on = RESIDENT && live && c < d;
      cv[i] = on ? load_vec(cr, c, d, cvec) : make_uint4(0u, 0u, 0u, 0u);
      xv[i] = on ? load_vec(xr, c, d, xvec) : make_uint4(0u, 0u, 0u, 0u);
    }
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j)
        dot = fmaf(elem<T>(cv[i], j) * elem<T>(wv[i], j), elem<T>(xv[i], j), dot);
    if (!RESIDENT && live)
      for (int c = t * V; c < d; c += tt * V) {
        const uint4 a = load_vec(cr, c, d, cvec), b = load_vec(xr, c, d, xvec);
        const uint4 g = load_vec(w, c, d, wvec);
#pragma unroll
        for (int j = 0; j < V; ++j) dot = fmaf(elem<T>(a, j) * elem<T>(g, j), elem<T>(b, j), dot);
      }
    dot = warp_sum(dot);
    if (team_warps > 1) {
      if (threadIdx.x % 32 == 0) part[it & 1][warp] = dot;
      team_barrier(1 + team, tt);
      dot = 0.f;
      for (int q = 0; q < team_warps; ++q) dot += part[it & 1][team * team_warps + q];
    }
    if (!live) continue;
    const float r3 = r * r * r, m = dot / d;
    if (RESIDENT) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = (i * tt + t) * V;
        if (c >= d) continue;
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float cf = elem<T>(cv[i], j), xf = elem<T>(xv[i], j);
          o[j] = cf * elem<T>(wv[i], j) * r - xf * r3 * m;
          acc[i][j] = fmaf(cf, xf * r, acc[i][j]);
        }
        store_floats(dr, c, d, dvec, o);
      }
    } else {
      for (int c = t * V; c < d; c += tt * V) {
        const uint4 a = load_vec(cr, c, d, cvec), b = load_vec(xr, c, d, xvec);
        const uint4 g = load_vec(w, c, d, wvec);
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float cf = elem<T>(a, j), xf = elem<T>(b, j);
          o[j] = cf * elem<T>(g, j) * r - xf * r3 * m;
          if (c + j < d) pr[c + j] = fmaf(cf, xf * r, pr[c + j]);
        }
        store_floats(dr, c, d, dvec, o);
      }
    }
  }

  if (!RESIDENT) return;
  if (teams == 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = (i * tt + t) * V + j;
        if (c < d) pr[c] = acc[i][j];
      }
    return;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = (i * tt + t) * V + j;
      if (c < d) red[team * d + c] = acc[i][j];
    }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < teams; ++q) s += red[q * d + c];
    pr[c] = s;
  }
}

// dw[c] = the n_ctas partials' column c summed in a fixed order: a block
// of 32 columns by 32 slices, slice y summing partials y, y + 32, ..., then
// the 32 slices' sums in order.
template <typename T>
__global__ void __launch_bounds__(1024)
rmsnorm_bwd_dw(const float* __restrict__ partial, T* __restrict__ dw, int n_ctas, int d) {
  __shared__ float sums[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int i = threadIdx.y; i < n_ctas; i += 32) s += partial[(size_t)i * d + c];
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float tot = 0.f;
    for (int q = 0; q < 32; ++q) tot += sums[q][threadIdx.x];
    dw[c] = from_f32<T>(tot);
  }
}

// Dynamic shared memory of pass 1: the teams' dw partials (mirrored by
// kernels/rmsnorm.py:rmsnorm_bwd_smem_bytes).
extern "C" int repro_rmsnorm_bwd_smem_bytes(int block_rows, int d, int itemsize) {
  const Team team(d, itemsize);
  const int teams = block_rows < MAX_WARPS / team.warps ? block_rows : MAX_WARPS / team.warps;
  return team.resident && teams > 1 ? teams * d * 4 : 0;
}

template <typename T>
static cudaError_t launch(const void* ct, const void* x, const void* w, const float* invrms,
                          void* dx, void* dw, float* partial, int rows, int d, int block_rows,
                          int ctas, cudaStream_t s) {
  const Team team(d, sizeof(T));
  const int teams = block_rows < MAX_WARPS / team.warps ? block_rows : MAX_WARPS / team.warps;
  const int smem = repro_rmsnorm_bwd_smem_bytes(block_rows, d, sizeof(T));
  if (rows > 0) {
    auto k = !team.resident ? rmsnorm_bwd_rows<T, 4, false>
             : team.nv == 2 ? rmsnorm_bwd_rows<T, 2, true>
                            : rmsnorm_bwd_rows<T, 4, true>;
    cudaError_t err = allow_smem(k, smem);
    if (err != cudaSuccess) return err;
    k<<<ctas, 32 * team.warps * teams, smem, s>>>(
        static_cast<const T*>(ct), static_cast<const T*>(x), static_cast<const T*>(w), invrms,
        static_cast<T*>(dx), partial, rows, d, team.warps);
  }
  rmsnorm_bwd_dw<T><<<(d + 31) / 32, dim3(32, 32), 0, s>>>(partial, static_cast<T*>(dw),
                                                          rows > 0 ? ctas : 0, d);
  return cudaGetLastError();
}

// One call a launch: `ctas` CTAs of pass 1 (at least 1 when rows > 0) and
// `partial` [ctas, d] fp32, both from kernels/rmsnorm.py.
extern "C" int repro_rmsnorm_bwd(const void* ct, const void* x, const void* w,
                                 const float* invrms, void* dx, void* dw, float* partial,
                                 int rows, int d, int dtype, int block_rows, int ctas,
                                 void* stream) {
  if (block_rows < 1 || block_rows > 32 || d < 1 || (rows > 0 && ctas < 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return launch<__nv_bfloat16>(ct, x, w, invrms, dx, dw, partial, rows, d, block_rows, ctas,
                                 s);
  if (dtype == REPRO_F32)
    return launch<float>(ct, x, w, invrms, dx, dw, partial, rows, d, block_rows, ctas, s);
  return cudaErrorInvalidValue;
}

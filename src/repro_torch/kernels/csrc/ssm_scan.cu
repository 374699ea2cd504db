// Selective scan (Mamba S6) for Hopper (sm_90a): the prefill scan and the
// one-step decode update, in one library.
//
//   h_t[d, j] = exp(dt_t[d] * A[d, j]) * h_{t-1}[d, j] + dt_t[d] * xc_t[d] * B_t[j]
//   y_t[d]    = sum_j h_t[d, j] * C_t[j]
//
// xc is in the model dtype (fp32 or bf16); dt, B, C, A, the carry-in h and
// both outputs (y and the final state) are fp32, as in the TPU kernels.
//
// ssm_scan replaces repro/kernels/ssm_scan.py:_ssm_scan_kernel (driven by
// ssm_scan_pallas). The only parallelism is across (batch, channel); time
// is sequential. One thread owns one channel of one batch row and keeps its
// d_state (at most 16) fp32 states and its row of A (pre-scaled by log2 e)
// in registers for the whole sequence. A CTA of block_d threads (a block_d
// slice of d_inner) walks time in slices of `chunk` steps: the slice's xc
// and dt ([chunk][block_d], read coalesced across channels, 8 steps' loads
// in flight at a time) and its B_t / C_t rows ([chunk][d_state],
// shared by every channel) are staged in shared memory, then each thread
// steps through the slice reading them from there and writes y_t coalesced.
// The TPU kernel zero-pads the ragged tail (dt = 0 => dA = 1, an identity
// step); this kernel stops at s, so the state it returns is h at step s-1
// for any s, and d_inner need not divide into block_d either.
//
// Bound at prefill (b = 1, s = 2048, d_inner = 16384, d_state = 16): about
// 0.34 GB moved (0.10 ms at 3.35 TB/s) against 537 M exponentials; on the
// SFUs (16 a clock an SM) that is about 0.13 ms, so the exponentials bound
// it. Each one is a single ex2.approx on the pre-scaled A. Occupancy: at
// b = 1 there are d_inner / block_d CTAs, 256 of 64 threads at the
// heuristic, so an SM holds two CTAs or fewer (128 channels, one warp a
// quadrant): too few warps to hide the latency of each step's chain. With
// d_state a compile-time 16 the state loop unrolls unguarded; a runtime
// d_state (guarded, the first version) took 2.3 times as long on the card.
// The kernel stays latency bound above its SFU bound; splitting each
// channel's states over several threads (more warps an SM), or time into
// chunks with a second pass that carries the state, is the way to more
// parallelism.
//
// ssm_update replaces repro/kernels/ssm_scan.py:_ssm_update_kernel (driven
// by ssm_update_pallas): one decode step, one thread per (row, channel)
// over a (block_d x block_b) CTA, the state read once and written once.
// Bound at b = 8, d_inner = 16384: about 17 MB, 0.005 ms of bytes; a
// launch costs about as much.
#include "common.cuh"

#define SSM_MAX_STATE 16
#define SCAN_MAX_THREADS 512
#define LOG2E_F 1.4426950408889634f
#define STAGE 8

// 2^x in one SFU instruction (relative error about 2^-22).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// DS > 0: d_state is DS, known to the compiler, so the state loop unrolls
// with no guard and its B_t / C_t reads are scheduled ahead of the
// exponentials; DS == 0: any d_state up to SSM_MAX_STATE, each state
// guarded.
template <typename T, int DS>
__global__ void __launch_bounds__(SCAN_MAX_THREADS)
ssm_scan_kernel(const T* __restrict__ xc, const float* __restrict__ dt,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ A, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hn, int s, int di, int ds_arg,
                int chunk) {
  const int ds = DS > 0 ? DS : ds_arg;
  extern __shared__ __align__(16) float sm[];
  const int block_d = blockDim.x;
  float* xs = sm;                         // [chunk][block_d] xc as fp32
  float* dts = xs + chunk * block_d;      // [chunk][block_d]
  float* bs = dts + chunk * block_d;      // [chunk][ds]
  float* cs = bs + chunk * ds;            // [chunk][ds]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * block_d + tid;
  const bool live = d < di;
  const size_t row0 = (size_t)b * s;      // row of (b, t) in [b*s, di] is row0 + t

  float h[SSM_MAX_STATE], a2[SSM_MAX_STATE];
#pragma unroll
  for (int j = 0; j < SSM_MAX_STATE; ++j) {
    const bool on = live && j < ds;
    h[j] = on ? h0[((size_t)b * di + d) * ds + j] : 0.f;
    a2[j] = on ? A[(size_t)d * ds + j] * LOG2E_F : 0.f;
  }

  for (int t0 = 0; t0 < s; t0 += chunk) {
    const int n = min(chunk, s - t0);
    __syncthreads();                      // the last slice is read by all
    // STAGE steps' loads all start before their stores, so that many
    // device-memory reads are in flight at once
    for (int t1 = 0; t1 < n; t1 += STAGE) {
      float xv[STAGE], dv[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const bool on = live && t1 + u < n;
        const size_t g = (row0 + t0 + t1 + u) * di + d;
        xv[u] = on ? to_f32(xc[g]) : 0.f;
        dv[u] = on ? dt[g] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        if (t1 + u < n) {
          xs[(t1 + u) * block_d + tid] = xv[u];
          dts[(t1 + u) * block_d + tid] = dv[u];
        }
      }
    }
#pragma unroll 4
    for (int i = tid; i < n * ds; i += block_d) {
      bs[i] = Bm[(row0 + t0) * ds + i];
      cs[i] = Cm[(row0 + t0) * ds + i];
    }
    __syncthreads();
    if (live) {
#pragma unroll 2
      for (int tt = 0; tt < n; ++tt) {
        const float dtv = dts[tt * block_d + tid];
        const float dbx = dtv * xs[tt * block_d + tid];
        const float* bt = bs + tt * ds;
        const float* ct = cs + tt * ds;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < SSM_MAX_STATE; ++j) {
          if (j < ds) {
            h[j] = fmaf(ex2_approx(dtv * a2[j]), h[j], dbx * bt[j]);
            acc = fmaf(h[j], ct[j], acc);
          }
        }
        y[(row0 + t0 + tt) * di + d] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < SSM_MAX_STATE; ++j)
      if (j < ds) hn[((size_t)b * di + d) * ds + j] = h[j];
  }
}

template <typename T>
__global__ void ssm_update_kernel(const T* __restrict__ xc, const float* __restrict__ dt,
                                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                                  const float* __restrict__ A, const float* __restrict__ h,
                                  float* __restrict__ y, float* __restrict__ hn, int b,
                                  int di, int ds, bool vec) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (d >= di || r >= b) return;
  const size_t i = (size_t)r * di + d;
  const float dtv = dt[i];
  const float dbx = dtv * to_f32(xc[i]);
  const float* hr = h + i * ds;
  float* hw = hn + i * ds;
  const float* ar = A + (size_t)d * ds;
  const float* br = Bm + (size_t)r * ds;
  const float* cr = Cm + (size_t)r * ds;
  float acc = 0.f;
  if (vec) {
    // 16-byte loads and stores of each row: ds is a multiple of 4 and every
    // base 16-byte aligned (checked at launch)
    for (int j = 0; j < ds; j += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(hr + j);
      const float4 av = __ldg(reinterpret_cast<const float4*>(ar + j));
      const float4 bv = __ldg(reinterpret_cast<const float4*>(br + j));
      const float4 cv = __ldg(reinterpret_cast<const float4*>(cr + j));
      float4 o;
      o.x = fmaf(ex2_approx(dtv * (av.x * LOG2E_F)), hv.x, dbx * bv.x);
      o.y = fmaf(ex2_approx(dtv * (av.y * LOG2E_F)), hv.y, dbx * bv.y);
      o.z = fmaf(ex2_approx(dtv * (av.z * LOG2E_F)), hv.z, dbx * bv.z);
      o.w = fmaf(ex2_approx(dtv * (av.w * LOG2E_F)), hv.w, dbx * bv.w);
      *reinterpret_cast<float4*>(hw + j) = o;
      acc = fmaf(o.x, cv.x, acc);
      acc = fmaf(o.y, cv.y, acc);
      acc = fmaf(o.z, cv.z, acc);
      acc = fmaf(o.w, cv.w, acc);
    }
  } else {
    for (int j = 0; j < ds; ++j) {
      const float v = fmaf(ex2_approx(dtv * (ar[j] * LOG2E_F)), hr[j], dbx * br[j]);
      hw[j] = v;
      acc = fmaf(v, cr[j], acc);
    }
  }
  y[i] = acc;
}

// Shared memory of one scan CTA (mirrored by kernels/ssm_scan.py).
extern "C" int repro_ssm_scan_smem_bytes(int chunk, int block_d, int ds) {
  return chunk * (2 * block_d + 2 * ds) * (int)sizeof(float);
}

extern "C" int repro_ssm_scan(const void* xc, const float* dt, const float* B, const float* C,
                              const float* A, const float* h0, float* y, float* hn, int b,
                              int s, int di, int ds, int dtype, int chunk, int block_d,
                              void* stream) {
  if (block_d < 32 || block_d > SCAN_MAX_THREADS || block_d % 32 || chunk < 1 || ds < 1 ||
      ds > SSM_MAX_STATE)
    return cudaErrorInvalidValue;
  if (b <= 0 || di <= 0) return cudaSuccess;
  const int smem = repro_ssm_scan_smem_bytes(chunk, block_d, ds);
  const dim3 grid((di + block_d - 1) / block_d, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const bool full = ds == SSM_MAX_STATE;
  if (dtype == REPRO_BF16) {
    auto k = full ? ssm_scan_kernel<__nv_bfloat16, SSM_MAX_STATE>
                  : ssm_scan_kernel<__nv_bfloat16, 0>;
    if ((err = allow_smem(k, smem)) != cudaSuccess) return err;
    k<<<grid, block_d, smem, st>>>(static_cast<const __nv_bfloat16*>(xc), dt, B, C, A, h0, y,
                                   hn, s, di, ds, chunk);
  } else if (dtype == REPRO_F32) {
    auto k = full ? ssm_scan_kernel<float, SSM_MAX_STATE> : ssm_scan_kernel<float, 0>;
    if ((err = allow_smem(k, smem)) != cudaSuccess) return err;
    k<<<grid, block_d, smem, st>>>(static_cast<const float*>(xc), dt, B, C, A, h0, y, hn, s,
                                   di, ds, chunk);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int repro_ssm_update(const void* xc, const float* dt, const float* B,
                                const float* C, const float* A, const float* h, float* y,
                                float* hn, int b, int di, int ds, int dtype, int block_b,
                                int block_d, void* stream) {
  if (block_b < 1 || block_d < 1 || ds < 1) return cudaErrorInvalidValue;
  if (b <= 0 || di <= 0) return cudaSuccess;
  const dim3 block(block_d, block_b);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C) |
                          reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(h) |
                          reinterpret_cast<uintptr_t>(hn);
  const bool vec = ds % 4 == 0 && bases % 16 == 0;
  const dim3 grid((di + block_d - 1) / block_d, (b + block_b - 1) / block_b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16) {
    ssm_update_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(xc), dt, B, C, A, h, y, hn, b, di, ds, vec);
  } else if (dtype == REPRO_F32) {
    ssm_update_kernel<float><<<grid, block, 0, st>>>(static_cast<const float*>(xc), dt, B, C,
                                                     A, h, y, hn, b, di, ds, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Flash attention backward (causal / sliding-window, GQA) for Hopper
// (sm_90a), from the forward's saved output and logsumexp.
//
// Replaces the TPU kernels repro/kernels/attention.py:_flash_bwd_dq_kernel
// and _flash_bwd_dkv_kernel (driven by flash_attention_bwd_pallas). Same
// function: q [b,h,s_q,d], k/v [b,kv,s_k,d], do [b,h,s_q,d], lse [b,h,s_q]
// and delta = rowsum(do * o) [b,h,s_q] (fp32, computed by the caller);
// q positions aligned to the end of k (q_offset = s_k - s_q), masked
// scores at -1e30 so p = exp(s - lse) is exactly 0 there;
//   p  = exp(q.k * scale - lse),  ds = p * (do.v - delta)
//   dq = scale * sum_k ds k,  dk = scale * sum_q ds q,  dv = sum_q p do
// dq in q's dtype, dk and dv in k's.
//
// Two passes, as on the TPU, since blocks run in any order and nothing
// carries over between them:
// * dq: one CTA per (b*h, q tile of block_q rows) walks its live k tiles
//   in a loop (the TPU's sequential k grid axis). Each warp takes q rows in
//   turn: lanes split the keys for the scores and do.v, then the head dims
//   for the dq update, which accumulates in shared memory.
// * dk/dv: one CTA per (b*kv, k tile of block_k keys) of ONE kv head walks
//   the live q tiles of every q head of that head's group, so dk and dv
//   are summed over the group inside the CTA and written once in k's
//   dtype (the TPU writes fp32 per q head and sums outside). Each warp
//   takes keys in turn: lanes split the q rows for the scores, then the
//   head dims for the dk/dv update.
// Tiles entirely in the causal future or before the window are skipped.
// Every tile lives in shared memory as fp32, rows padded by one float so
// lanes reading different rows hit different banks.
//
// Bound: operations. At b=4, s=2048, 14/2 heads of 64 the backward does
// about 7 matmul-equivalents over the causal half (about 105 GFLOP),
// about 0.11 ms on the tensor cores. This first version computes on the
// SIMT fp32 cores out of shared memory, like the forward, and is bound by
// shared-memory bandwidth; tensor-core tiles are a later change.
#include "common.cuh"

#define NEG_INF_F (-1e30f)
#define FLASH_WARPS 4

__device__ __forceinline__ bool live(int qa, int ka, int causal, int window) {
  return (!causal || qa >= ka) && (window <= 0 || qa - ka < window);
}

// rows x d elements of a [*, d] tensor from row r0 into shared memory with
// leading dimension ld, zero past n valid rows.
template <typename T>
__device__ __forceinline__ void stage(float* __restrict__ dst, int ld, const T* __restrict__ src,
                                      int rows, int n, int d) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    dst[r * ld + c] = r < n ? to_f32(src[(size_t)r * d + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * FLASH_WARPS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, T* __restrict__ dq, int h, int kvh, int s_q,
             int s_k, int d, float scale, int causal, int window, int block_q, int block_k) {
  extern __shared__ __align__(16) float sm[];
  const int ld = d + 1;
  float* Qs = sm;                          // [block_q][d+1]
  float* Ds = Qs + block_q * ld;           // [block_q][d+1]  do
  float* Gs = Ds + block_q * ld;           // [block_q][d+1]  dq accumulator
  float* Ks = Gs + block_q * ld;           // [block_k][d+1]
  float* Vs = Ks + block_k * ld;           // [block_k][d+1]
  float* Ps = Vs + block_k * ld;           // [warps][block_k]  ds of the warp's row

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int kv_head = (bh / h) * kvh + (bh % h) / (h / kvh);
  const int q0 = blockIdx.x * block_q;
  const int nq = min(block_q, s_q - q0);
  const int q_off = s_k - s_q;
  const size_t qrow0 = (size_t)bh * s_q + q0;
  const T* kp = k + (size_t)kv_head * s_k * d;
  const T* vp = v + (size_t)kv_head * s_k * d;

  stage(Qs, ld, q + qrow0 * d, block_q, nq, d);
  stage(Ds, ld, dout + qrow0 * d, block_q, nq, d);
  for (int i = tid; i < block_q * ld; i += blockDim.x) Gs[i] = 0.f;

  const int q_lo = q0 + q_off, q_hi = q0 + nq - 1 + q_off;
  int kt_begin = 0, kt_end = (s_k + block_k - 1) / block_k;
  if (causal) kt_end = q_hi < 0 ? 0 : min(kt_end, q_hi / block_k + 1);
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / block_k;

  float* P = Ps + warp * block_k;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * block_k;
    const int nk = min(block_k, s_k - k0);
    __syncthreads();
    stage(Ks, ld, kp + (size_t)k0 * d, block_k, nk, d);
    stage(Vs, ld, vp + (size_t)k0 * d, block_k, nk, d);
    __syncthreads();
    for (int r = warp; r < nq; r += FLASH_WARPS) {
      const int qa = q0 + r + q_off;
      const float* qr = Qs + r * ld;
      const float* dr = Ds + r * ld;
      const float z = lse[qrow0 + r], dl = delta[qrow0 + r];
      for (int j = lane; j < nk; j += 32) {
        float ds = 0.f;
        if (live(qa, k0 + j, causal, window)) {
          const float* kr = Ks + j * ld;
          const float* vr = Vs + j * ld;
          float s = 0.f, dp = 0.f;
          for (int c = 0; c < d; ++c) {
            s = fmaf(qr[c], kr[c], s);
            dp = fmaf(dr[c], vr[c], dp);
          }
          ds = expf(s * scale - z) * (dp - dl);
        }
        P[j] = ds;
      }
      __syncwarp();
      for (int c = lane; c < d; c += 32) {
        float acc = 0.f;
        for (int j = 0; j < nk; ++j) acc = fmaf(P[j], Ks[j * ld + c], acc);
        Gs[r * ld + c] += acc * scale;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < nq * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    dq[(qrow0 + r) * d + c] = from_f32<T>(Gs[r * ld + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * FLASH_WARPS)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int h,
              int kvh, int s_q, int s_k, int d, float scale, int causal, int window,
              int block_q, int block_k) {
  extern __shared__ __align__(16) float sm[];
  const int ld = d + 1;
  float* Ks = sm;                          // [block_k][d+1]
  float* Vs = Ks + block_k * ld;           // [block_k][d+1]
  float* GKs = Vs + block_k * ld;          // [block_k][d+1]  dk accumulator
  float* GVs = GKs + block_k * ld;         // [block_k][d+1]  dv accumulator
  float* Qs = GVs + block_k * ld;          // [block_q][d+1]
  float* Ds = Qs + block_q * ld;           // [block_q][d+1]  do
  float* Zs = Ds + block_q * ld;           // [block_q] lse
  float* Es = Zs + block_q;                // [block_q] delta
  float* Ps = Es + block_q;                // [warps][block_q] p of the warp's key
  float* Ss = Ps + FLASH_WARPS * block_q;  // [warps][block_q] ds of the warp's key

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bkv = blockIdx.y;              // b * kvh + kv head
  const int group = h / kvh;
  const int bb = bkv / kvh, kv_head = bkv % kvh;
  const int k0 = blockIdx.x * block_k;
  const int nk = min(block_k, s_k - k0);
  const int q_off = s_k - s_q;
  const size_t krow0 = (size_t)bkv * s_k + k0;

  stage(Ks, ld, k + krow0 * d, block_k, nk, d);
  stage(Vs, ld, v + krow0 * d, block_k, nk, d);
  for (int i = tid; i < block_k * ld; i += blockDim.x) GKs[i] = GVs[i] = 0.f;

  // Live q tiles of this k tile: q index qi is live for some key here iff
  // qi + q_off >= k0 (causal) and qi + q_off - (k0 + nk - 1) < window.
  const int nqt = (s_q + block_q - 1) / block_q;
  int qt_begin = 0, qt_end = nqt;
  if (causal) qt_begin = max(0, k0 - q_off) / block_q;
  if (window > 0) {
    const int last = k0 + nk - 1 + window - 1 - q_off;   // largest live q index
    qt_end = last < 0 ? 0 : min(nqt, last / block_q + 1);
  }

  float* P = Ps + warp * block_q;
  float* S = Ss + warp * block_q;
  for (int g = 0; g < group; ++g) {
    const int bh = bb * h + kv_head * group + g;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * block_q;
      const int nq = min(block_q, s_q - q0);
      const size_t qrow0 = (size_t)bh * s_q + q0;
      __syncthreads();
      stage(Qs, ld, q + qrow0 * d, block_q, nq, d);
      stage(Ds, ld, dout + qrow0 * d, block_q, nq, d);
      for (int i = tid; i < nq; i += blockDim.x) {
        Zs[i] = lse[qrow0 + i];
        Es[i] = delta[qrow0 + i];
      }
      __syncthreads();
      for (int j = warp; j < nk; j += FLASH_WARPS) {
        const int ka = k0 + j;
        const float* kr = Ks + j * ld;
        const float* vr = Vs + j * ld;
        for (int i = lane; i < nq; i += 32) {
          float p = 0.f, ds = 0.f;
          if (live(q0 + i + q_off, ka, causal, window)) {
            const float* qr = Qs + i * ld;
            const float* dr = Ds + i * ld;
            float s = 0.f, dp = 0.f;
            for (int c = 0; c < d; ++c) {
              s = fmaf(qr[c], kr[c], s);
              dp = fmaf(dr[c], vr[c], dp);
            }
            p = expf(s * scale - Zs[i]);
            ds = p * (dp - Es[i]);
          }
          P[i] = p;
          S[i] = ds;
        }
        __syncwarp();
        for (int c = lane; c < d; c += 32) {
          float av = 0.f, ak = 0.f;
          for (int i = 0; i < nq; ++i) {
            av = fmaf(P[i], Ds[i * ld + c], av);
            ak = fmaf(S[i], Qs[i * ld + c], ak);
          }
          GVs[j * ld + c] += av;
          GKs[j * ld + c] += ak * scale;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nk * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    dk[(krow0 + r) * d + c] = from_f32<T>(GKs[r * ld + c]);
    dv[(krow0 + r) * d + c] = from_f32<T>(GVs[r * ld + c]);
  }
}

// Shared-memory bytes of one CTA of each pass; kernels/attention.py
// mirrors these formulas.
extern "C" int repro_flash_bwd_dq_smem_bytes(int d, int block_q, int block_k) {
  return (3 * block_q * (d + 1) + 2 * block_k * (d + 1) + FLASH_WARPS * block_k) * 4;
}

extern "C" int repro_flash_bwd_dkv_smem_bytes(int d, int block_q, int block_k) {
  return (4 * block_k * (d + 1) + 2 * block_q * (d + 1) + 2 * block_q +
          2 * FLASH_WARPS * block_q) * 4;
}

template <typename T>
static cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dq, void* dk, void* dv,
                              int b, int h, int kvh, int s_q, int s_k, int d, float scale,
                              int causal, int window, int block_q, int block_k,
                              cudaStream_t s) {
  const int smem_q = repro_flash_bwd_dq_smem_bytes(d, block_q, block_k);
  const int smem_kv = repro_flash_bwd_dkv_smem_bytes(d, block_q, block_k);
  cudaError_t err;
  if ((err = allow_smem(flash_bwd_dq<T>, smem_q)) != cudaSuccess) return err;
  if ((err = allow_smem(flash_bwd_dkv<T>, smem_kv)) != cudaSuccess) return err;
  const T *Q = static_cast<const T*>(q), *K = static_cast<const T*>(k);
  const T *V = static_cast<const T*>(v), *DO = static_cast<const T*>(dout);
  const dim3 grid_q((s_q + block_q - 1) / block_q, b * h);
  flash_bwd_dq<T><<<grid_q, 32 * FLASH_WARPS, smem_q, s>>>(
      Q, K, V, DO, lse, delta, static_cast<T*>(dq), h, kvh, s_q, s_k, d, scale, causal, window,
      block_q, block_k);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_kv((s_k + block_k - 1) / block_k, b * kvh);
  flash_bwd_dkv<T><<<grid_kv, 32 * FLASH_WARPS, smem_kv, s>>>(
      Q, K, V, DO, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), h, kvh, s_q, s_k, d,
      scale, causal, window, block_q, block_k);
  return cudaGetLastError();
}

extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse,
                                         const float* delta, void* dq, void* dk, void* dv,
                                         int b, int h, int kvh, int s_q, int s_k, int d,
                                         float scale, int causal, int window, int dtype,
                                         int block_q, int block_k, void* stream) {
  if (kvh <= 0 || h % kvh != 0 || d < 1 || d > 256 || block_q < 1 || block_k < 1 ||
      b * h > 65535)
    return cudaErrorInvalidValue;
  if (b <= 0 || s_q <= 0 || s_k <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return launch_bwd<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, kvh, s_q,
                                     s_k, d, scale, causal, window, block_q, block_k, s);
  if (dtype == REPRO_F32)
    return launch_bwd<float>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, kvh, s_q, s_k, d,
                             scale, causal, window, block_q, block_k, s);
  return cudaErrorInvalidValue;
}

// Causal / sliding-window flash attention with GQA for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/attention.py:_flash_kernel (driven
// by flash_attention_pallas). Same function: q [b,h,s_q,d], k/v
// [b,kv,s_k,d], q positions aligned to the end of k (q_offset = s_k - s_q),
// kv head = h / (h/kv), masked scores set to -1e30, online softmax in fp32,
// out in the input dtype plus the fp32 logsumexp [b,h,s_q].
//
// One CTA per (b*h, q tile of block_q rows) walks the k tiles of block_k
// keys in a loop inside the block: the loop replaces the TPU's sequential
// k grid axis, and tiles entirely in the causal future or before the
// window are never visited. Q, the output accumulator, and the current K
// and V tiles live in shared memory as fp32 (K/V rows padded by one float
// so lanes reading different keys hit different banks). Each warp takes
// q rows in turn: lanes split the keys for the scores and the head dims
// for P@V, and the running max and denominator live in shared memory.
//
// Bound: at prefill the work is about s^2*d*2 flops per head against
// s*d*6 bytes, so the card's bound is its tensor cores; this first
// version computes on the SIMT fp32 cores out of shared memory and is
// bound by shared-memory bandwidth. Tensor-core (wgmma) tiles are a later
// change.
#include "common.cuh"

#define NEG_INF_F (-1e30f)
#define FLASH_WARPS 4

__device__ __forceinline__ float warp_sum_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max_f(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * FLASH_WARPS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, int h, int kvh, int s_q, int s_k,
          int d, float scale, int causal, int window, int block_q, int block_k) {
  extern __shared__ __align__(16) float sm[];
  const int ldk = d + 1;
  float* Qs = sm;                        // [block_q][d]
  float* Os = Qs + block_q * d;          // [block_q][d]
  float* Ks = Os + block_q * d;          // [block_k][d+1]
  float* Vs = Ks + block_k * ldk;        // [block_k][d+1]
  float* Ps = Vs + block_k * ldk;        // [warps][block_k]
  float* Ms = Ps + FLASH_WARPS * block_k;  // [block_q] running max
  float* Ls = Ms + block_q;              // [block_q] running denominator

  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int kv_head = (bh / h) * kvh + (bh % h) / (h / kvh);
  const int q0 = blockIdx.x * block_q;
  const int nq = min(block_q, s_q - q0);
  const int q_off = s_k - s_q;
  const T* qp = q + ((size_t)bh * s_q + q0) * d;
  const T* kp = k + (size_t)kv_head * s_k * d;
  const T* vp = v + (size_t)kv_head * s_k * d;

  for (int i = tid; i < block_q * d; i += nt) {
    Qs[i] = i / d < nq ? to_f32(qp[i]) : 0.f;
    Os[i] = 0.f;
  }
  for (int i = tid; i < block_q; i += nt) {
    Ms[i] = NEG_INF_F;
    Ls[i] = 0.f;
  }

  // Live k tiles of this q tile.
  const int q_lo = q0 + q_off, q_hi = q0 + nq - 1 + q_off;
  int kt_begin = 0, kt_end = (s_k + block_k - 1) / block_k;
  if (causal) kt_end = q_hi < 0 ? 0 : min(kt_end, q_hi / block_k + 1);
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / block_k;
  __syncthreads();

  float* P = Ps + warp * block_k;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * block_k;
    const int nk = min(block_k, s_k - k0);
    for (int i = tid; i < nk * d; i += nt) {
      const int r = i / d, c = i % d;
      Ks[r * ldk + c] = to_f32(kp[(size_t)k0 * d + i]);
      Vs[r * ldk + c] = to_f32(vp[(size_t)k0 * d + i]);
    }
    __syncthreads();
    for (int r = warp; r < nq; r += FLASH_WARPS) {
      const int qa = q0 + r + q_off;     // absolute position of this q row
      const float* qr = Qs + r * d;
      float mloc = NEG_INF_F;
      for (int j = lane; j < nk; j += 32) {
        const int ka = k0 + j;
        float s = NEG_INF_F;
        if ((!causal || qa >= ka) && (window <= 0 || qa - ka < window)) {
          const float* kr = Ks + j * ldk;
          float acc = 0.f;
          for (int c = 0; c < d; ++c) acc = fmaf(qr[c], kr[c], acc);
          s = acc * scale;
        }
        P[j] = s;
        mloc = fmaxf(mloc, s);
      }
      mloc = warp_max_f(mloc);
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mloc);
      const float alpha = expf(m_prev - m_new);
      float lsum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(P[j] - m_new);
        P[j] = p;
        lsum += p;
      }
      lsum = warp_sum_f(lsum);
      __syncwarp();
      for (int c = lane; c < d; c += 32) {
        float acc = Os[r * d + c] * alpha;
        for (int j = 0; j < nk; ++j) acc = fmaf(P[j], Vs[j * ldk + c], acc);
        Os[r * d + c] = acc;
      }
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * alpha + lsum;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  for (int r = warp; r < nq; r += FLASH_WARPS) {
    const float l = fmaxf(Ls[r], 1e-30f);
    T* orow = o + ((size_t)bh * s_q + q0 + r) * d;
    for (int c = lane; c < d; c += 32) orow[c] = from_f32<T>(Os[r * d + c] / l);
    if (lane == 0) lse[(size_t)bh * s_q + q0 + r] = Ms[r] + logf(l);
  }
}

// Shared-memory bytes of one CTA; kernels/attention.py mirrors this formula.
extern "C" int repro_flash_smem_bytes(int d, int block_q, int block_k) {
  return (2 * block_q * d + 2 * block_k * (d + 1) + FLASH_WARPS * block_k + 2 * block_q) * 4;
}

extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     float* lse, int b, int h, int kvh, int s_q, int s_k,
                                     int d, float scale, int causal, int window, int dtype,
                                     int block_q, int block_k, void* stream) {
  if (kvh <= 0 || h % kvh != 0 || d < 16 || d > 128 || (d & (d - 1)) != 0 ||
      block_q < 1 || block_k < 1 || b * h > 65535)
    return cudaErrorInvalidValue;
  if (b <= 0 || s_q <= 0) return cudaSuccess;
  const dim3 grid((s_q + block_q - 1) / block_q, b * h);
  const int smem = repro_flash_smem_bytes(d, block_q, block_k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == REPRO_BF16) {
    if ((err = allow_smem(flash_fwd<__nv_bfloat16>, smem)) != cudaSuccess) return err;
    flash_fwd<__nv_bfloat16><<<grid, 32 * FLASH_WARPS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, h, kvh,
        s_q, s_k, d, scale, causal, window, block_q, block_k);
  } else if (dtype == REPRO_F32) {
    if ((err = allow_smem(flash_fwd<float>, smem)) != cudaSuccess) return err;
    flash_fwd<float><<<grid, 32 * FLASH_WARPS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, h, kvh, s_q, s_k, d,
        scale, causal, window, block_q, block_k);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

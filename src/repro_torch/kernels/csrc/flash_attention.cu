// Causal / sliding-window flash attention with GQA for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/attention.py:_flash_kernel (driven
// by flash_attention_pallas). Same function: q [b,h,s_q,d], k/v
// [b,kv,s_k,d], q positions aligned to the end of k (q_offset = s_k - s_q),
// kv head = h / (h/kv), masked scores set to -1e30, online softmax in fp32,
// out in the input dtype plus the fp32 logsumexp [b,h,s_q].
//
// Bound: at prefill the work is about 4 * s^2/2 * d flops per head
// against about 8 * s * d bytes, so the card's bound is its tensor cores.
//
// bf16 (flash_fwd_tc), in the FlashAttention-3 manner, simple first: one
// CTA per (b*h, q tile of BQ = 64 or 128 rows), one consumer warpgroup per
// 64 q rows and one producer warp. The producer loads the q tile once and
// streams the live k and v tiles of BK = 64 or 128 keys through a ring of
// ST = 2 or 3 shared-memory stages with TMA (flash_common.cuh), each stage
// guarded by a full and an empty mbarrier. Each consumer computes
// S = Q K^T with wgmma (both operands K-major in shared memory), masks it,
// runs the online softmax on the fp32 accumulator in registers (the
// running max reduced over the four lanes of a row, the running sum kept
// per lane until the end), and adds P V with wgmma, P converted to bf16 in
// registers as the A operand and V read MN-major through the transpose
// bit; then it releases the stage. Tiles wholly in the causal future or
// before the window are never loaded; the mask is computed only on tiles
// that hold a masked pair or the ragged edge. The longest q tiles (the
// last, under causality) launch first. O is scaled by 1/l and stored as
// bf16 from registers with the fp32 lse. d is 16, 32, 64, 128 or 256. At
// d = 256 (PaliGemma's heads) a 64-row warpgroup's O accumulator is 128
// fp32 registers a thread, and the P V product one m64n256k16 wgmma a k16
// step; a q tile, two or three 64-key k and v stages fit 227 KB only at
// 64-key tiles (64 x 64 x 2: 161 KB, x 3: 225 KB; 128 x 64 x 2: 193 KB),
// and the configs that do not fit are not instantiated. Inside a
// warpgroup S, the softmax and P V run in turn, so the tensor cores idle
// through the softmax; the CTAs that share an SM overlap them only in part
// (PERF.md §6 measures this).
//
// fp32 (flash_fwd_simt): the first version's SIMT kernel, kept under its
// own entry point and chosen by dtype, never on a failure: wgmma has no
// fp32 operands, and TF32 would keep about three digits where the fp32
// card tests and gradient checks hold 1e-5. One CTA per (b*h, q tile)
// walks the k tiles with Q, the output accumulator and the current K and V
// tiles in shared memory as fp32; each warp takes q rows in turn.
#include "flash_common.cuh"

#define NEG_INF_F (-1e30f)
#define FLASH_WARPS 4

using namespace flash;
typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int D, int BQ, int BK, int ST>
struct Fwd {
  static constexpr int NWG = BQ / 64;                 // consumer warpgroups
  static constexpr int THREADS = NWG * 128 + 32;      // + the producer warp
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  // q tile, ST k tiles, ST v tiles, the q barrier and ST full and ST empty
  // barriers, and 1024 bytes to align the tiles for the 128-byte swizzle
  // (kernels/attention.py:smem_bytes mirrors this).
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * ST * KV_BYTES + 8 * (2 * ST + 1);
};

// The online softmax of one tile of raw scores q.k (an m64 accumulator of
// NS columns) into the bf16 A fragments of P: masked scores read -1e30, the
// running max m (of raw scores: scale > 0 commutes with the max, so the
// scale folds into the exponent's one multiply-add) and sum l (this lane's
// columns only) carry over, and alpha is the factor that rescales what the
// earlier tiles added to O. MASKED tiles (a masked pair or the ragged edge)
// test every score.
template <bool MASKED, int NS>
__device__ __forceinline__ void online_softmax(float (&sc)[NS], uint32_t (&p)[NS / 8][4],
                                               float (&m)[2], float (&l)[2], float (&alpha)[2],
                                               int k0, int qa0, int s_k, float sl2, int causal,
                                               int window) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (MASKED) {
      const int ka = k0 + acc_col(j);
      if (ka >= s_k || !live(qa0 + acc_row(j), ka, causal, window)) sc[j] = NEG_INF;
    }
    mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
  }
  float ml2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = ex2((m[r] - mx[r]) * sl2);
    m[r] = mx[r];
    ml2[r] = mx[r] == NEG_INF ? 0.f : mx[r] * sl2;      // a row masked so far: p = 0
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int r = (j >> 1) & 1;
    sc[j] = ex2(sc[j] * sl2 - ml2[r]);
    l[r] += sc[j];
  }
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk) acc_to_a(p[kk], sc, kk);
}

template <int D, int BQ, int BK, int ST>
__global__ void __launch_bounds__(Fwd<D, BQ, BK, ST>::THREADS, 1)
flash_fwd_tc(__grid_constant__ const CUtensorMap tm_q,
             __grid_constant__ const CUtensorMap tm_k,
             __grid_constant__ const CUtensorMap tm_v, bf16* __restrict__ o,
             float* __restrict__ lse, int h, int kvh, int s_q, int s_k, float scale, int causal,
             int window) {
  using C = Fwd<D, BQ, BK, ST>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES, sV = sK + ST * C::KV_BYTES;
  const uint32_t bar_q = sV + ST * C::KV_BYTES;
  auto full = [&](int s) { return bar_q + 8 + 8 * s; };
  auto empty = [&](int s) { return bar_q + 8 + 8 * ST + 8 * s; };

  const int bh = blockIdx.y;
  const int kvb = (bh / h) * kvh + (bh % h) / (h / kvh);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;     // longest q tiles first
  const int q_off = s_k - s_q;
  const int q_lo = q0 + q_off, q_hi = min(q0 + BQ, s_q) - 1 + q_off;
  int kt0, kt1;
  k_tiles(q_lo, q_hi, s_k, BK, causal, window, &kt0, &kt1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4 * C::NWG) {                             // producer
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      tma_tile<D, BQ>(sQ, &tm_q, q0, bh, bar_q);
      for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
        const int s = it % ST;
        mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * C::KV_BYTES);
        tma_tile<D, BK>(sK + s * C::KV_BYTES, &tm_k, kt * BK, kvb, full(s));
        tma_tile<D, BK>(sV + s * C::KV_BYTES, &tm_v, kt * BK, kvb, full(s));
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64)
  const int wg = warp / 4;
  const int qa0 = q0 + 64 * wg + q_off;                 // position of the warpgroup's row 0
  const float sl2 = scale * LOG2E;
  float acc[D / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  mbar_wait(bar_q, 0);
  for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
    const int s = it % ST;
    const uint32_t tK = sK + s * C::KV_BYTES, tV = sV + s * C::KV_BYTES;
    mbar_wait(full(s), (it / ST) & 1);

    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, desc_k<D, BQ>(sQ, 64 * wg, kk), desc_k<D, BK>(tK, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    reg_fence(sc);

    const int k0 = kt * BK;
    const bool masked = k0 + BK > s_k || !all_live(q_lo, q_hi, k0, k0 + BK - 1, causal, window);
    float alpha[2];
    uint32_t pa[BK / 16][4];
    if (masked)
      online_softmax<true>(sc, pa, m, l, alpha, k0, qa0, s_k, sl2, causal, window);
    else
      online_softmax<false>(sc, pa, m, l, alpha, k0, qa0, s_k, sl2, causal, window);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(acc, pa[kk], desc_mn<D, BK>(tV, kk), 1);
    wgmma_commit();
    wgmma_wait();
    reg_fence(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty(s));
  }

  // epilogue: O / l in bf16, lse = m + log l, rows < s_q only
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    const int qi = q0 + 64 * wg + acc_row(2 * r);
    if (qi >= s_q) continue;
    const float lr = fmaxf(l[r], 1e-30f), inv = 1.f / lr;
    bf16* orow = o + ((size_t)bh * s_q + qi) * D;
#pragma unroll
    for (int j = 2 * r; j < D / 2; j += 4)
      store_bf16x2(orow + acc_col(j), acc[j] * inv, acc[j + 1] * inv);
    if (threadIdx.x % 4 == 0)
      lse[(size_t)bh * s_q + qi] = (m[r] == NEG_INF ? NEG_INF : m[r] * scale) + logf(lr);
  }
}

template <int D, int BQ, int BK, int ST>
static cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse,
                             int b, int h, int kvh, int s_q, int s_k, float scale, int causal,
                             int window, cudaStream_t stream) {
  using C = Fwd<D, BQ, BK, ST>;
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, q, D, s_q, b * h, BQ)) != cudaSuccess) return err;
  if ((err = make_map(&mk, k, D, s_k, b * kvh, BK)) != cudaSuccess) return err;
  if ((err = make_map(&mv, v, D, s_k, b * kvh, BK)) != cudaSuccess) return err;
  if ((err = allow_smem(flash_fwd_tc<D, BQ, BK, ST>, C::SMEM)) != cudaSuccess) return err;
  const dim3 grid((s_q + BQ - 1) / BQ, b * h);
  flash_fwd_tc<D, BQ, BK, ST><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), lse, h, kvh, s_q, s_k, scale, causal, window);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_tc_d(int bq, int bk, int st, const void* q, const void* k,
                               const void* v, void* o, float* lse, int b, int h, int kvh,
                               int s_q, int s_k, float scale, int causal, int window,
                               cudaStream_t s) {
#define REPRO_FWD_CASE(BQ, BK, ST)                                                            \
  if constexpr (Fwd<D, BQ, BK, ST>::SMEM <= SMEM_MAX)                                         \
    if (bq == BQ && bk == BK && st == ST)                                                     \
      return launch_tc<D, BQ, BK, ST>(q, k, v, o, lse, b, h, kvh, s_q, s_k, scale, causal,    \
                                      window, s);
  REPRO_FWD_CASE(64, 64, 2)
  REPRO_FWD_CASE(64, 64, 3)
  REPRO_FWD_CASE(64, 128, 2)
  REPRO_FWD_CASE(64, 128, 3)
  REPRO_FWD_CASE(128, 64, 2)
  REPRO_FWD_CASE(128, 64, 3)
  REPRO_FWD_CASE(128, 128, 2)
  REPRO_FWD_CASE(128, 128, 3)
#undef REPRO_FWD_CASE
  return cudaErrorInvalidValue;
}

// bf16 q, k, v (16-byte aligned, contiguous), o; block_q and block_k in
// {64, 128}, stages in {2, 3}, of those whose CTA fits SMEM_MAX at d (at
// d = 256: 64 x 64 with 2 or 3 stages and 128 x 64 with 2).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     float* lse, int b, int h, int kvh, int s_q, int s_k, int d,
                                     float scale, int causal, int window, int block_q,
                                     int block_k, int stages, void* stream) {
  if (kvh <= 0 || h % kvh != 0 || b * h > 65535 || s_k <= 0) return cudaErrorInvalidValue;
  if (b <= 0 || s_q <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FWD_D(D)                                                                        \
  case D:                                                                                     \
    return launch_tc_d<D>(block_q, block_k, stages, q, k, v, o, lse, b, h, kvh, s_q, s_k,     \
                          scale, causal, window, s);
  switch (d) {
    REPRO_FWD_D(16)
    REPRO_FWD_D(32)
    REPRO_FWD_D(64)
    REPRO_FWD_D(128)
    REPRO_FWD_D(256)
#undef REPRO_FWD_D
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT
// ---------------------------------------------------------------------------

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
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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

// Shared-memory bytes of one fp32 CTA; kernels/attention.py mirrors this formula.
extern "C" int repro_flash_simt_smem_bytes(int d, int block_q, int block_k) {
  return (2 * block_q * d + 2 * block_k * (d + 1) + FLASH_WARPS * block_k + 2 * block_q) * 4;
}

// fp32 q, k, v, o; any tiles whose shared memory fits (attention.py maps
// every config to its SIMT tiles at the head dim: 64 x 64, 32 x 32 at
// d = 256).
extern "C" int repro_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                         float* lse, int b, int h, int kvh, int s_q, int s_k,
                                         int d, float scale, int causal, int window,
                                         int block_q, int block_k, void* stream) {
  if (kvh <= 0 || h % kvh != 0 || d < 16 || d > 256 || (d & (d - 1)) != 0 ||
      block_q < 1 || block_k < 1 || b * h > 65535)
    return cudaErrorInvalidValue;
  if (b <= 0 || s_q <= 0) return cudaSuccess;
  const dim3 grid((s_q + block_q - 1) / block_q, b * h);
  const int smem = repro_flash_simt_smem_bytes(d, block_q, block_k);
  cudaError_t err;
  if ((err = allow_smem(flash_fwd_simt<float>, smem)) != cudaSuccess) return err;
  flash_fwd_simt<float><<<grid, 32 * FLASH_WARPS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, h, kvh, s_q, s_k, d, scale, causal, window, block_q,
      block_k);
  return cudaGetLastError();
}

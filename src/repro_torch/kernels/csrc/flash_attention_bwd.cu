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
// Bound: operations. The least work is five matrix products over the
// live (q, k) pairs (s, dp, dv, dq, dk); at b=4, s=2048, 14/2 heads of 64
// about 75 GFLOP, 0.076 ms on the tensor cores.
//
// Two passes with no atomics, as on the TPU, since blocks run in any order
// and nothing carries over between them; the sums run in a fixed order, so
// the result is deterministic. bf16 runs on the tensor cores, each product
// one wgmma with its B operand in shared memory and, where its A operand
// is p or ds, that operand in registers (flash_common.cuh):
// * dq (flash_bwd_dq_tc): one CTA per (b*h, q tile of BQ = 64 or 128 rows),
//   one consumer warpgroup per 64 rows, one producer warp. Q and dO are
//   loaded once; the live k and v tiles of 64 keys stream through a ring
//   of two TMA stages on mbarriers. S = Q K^T and dP = dO V^T (both
//   operands K-major), dS = P (dP - delta) in registers, dQ += dS K (K
//   read MN-major). The longest q tiles launch first.
// * dk/dv (flash_bwd_dkv_tc): one CTA per (b*kv, k tile of BK = 64 or 128
//   keys) of ONE kv head, one consumer warpgroup per 64 keys. K and V are
//   loaded once; the live q tiles of 64 rows of every q head of the kv
//   head's group stream through the ring with their lse and delta (which
//   the producer warp copies beside each tile), so dk and dv are summed
//   over the group inside the CTA and written once in k's dtype (the TPU
//   writes fp32 per q head and sums outside). Scores are computed
//   transposed so that rows index keys: S^T = K Q^T, P^T = exp(S^T - lse),
//   dV += P^T dO; dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.
// At d = 256 (PaliGemma's heads) the dq pass keeps its 128-register dq
// accumulator a thread, and the dk/dv pass splits d in two: each CTA
// computes S^T and dP^T over all of d and accumulates dk and dv for one
// half of the columns (dkv_cols), on a grid of twice the CTAs. Only the
// 64 x 64 config fits 227 KB there; the configs that do not fit are not
// instantiated.
// Tiles wholly in the causal future or before the window are skipped (the
// dk/dv pass by the mirror bound on q tiles); the mask is computed only on
// tiles that hold a masked pair or a ragged edge.
//
// fp32 keeps the first version's SIMT kernels (flash_bwd_dq_simt,
// flash_bwd_dkv_simt) under their own entry point, chosen by dtype: wgmma
// has no fp32 operands, and TF32 would break the fp32 card tests and the
// fp32 gradient check. Every tile lives in shared memory as fp32 there,
// rows padded by one float; each warp takes rows in turn.
#include "flash_common.cuh"

#define NEG_INF_F (-1e30f)
#define FLASH_WARPS 4

using namespace flash;
typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BWD_TILE = 64;     // rows of a streamed tile (k in the dq pass, q in dk/dv)
constexpr int BWD_STAGES = 2;    // depth of the ring

template <int D, int BQ>
struct BwdDq {
  static constexpr int NWG = BQ / 64, THREADS = NWG * 128 + 32;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BWD_TILE * D * 2;
  // q and do tiles, the k and v ring, the q barrier and the ring's full and
  // empty barriers, and 1024 bytes to align the tiles (kernels/attention.py:
  // bwd_smem_bytes mirrors this and BwdDkv's).
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * BWD_STAGES * KV_BYTES +
                              8 * (1 + 2 * BWD_STAGES);
};

// The dk/dv columns one CTA of the dk/dv pass accumulates: every column up
// to d = 128; at d = 256 a half, so that its dk and dv accumulators stay at
// 2 x 64 fp32 registers a thread (the whole row would be 256, past the 255
// a thread may hold). The two halves' CTAs each recompute S^T and dP^T
// over all of d: the pass does 6 products' work for 4, on twice the CTAs.
constexpr int dkv_cols(int d) { return d < 128 ? d : 128; }

template <int D, int BK>
struct BwdDkv {
  static constexpr int NWG = BK / 64, THREADS = NWG * 128 + 32;
  static constexpr int DC = dkv_cols(D);                 // columns of this CTA's dk, dv
  static constexpr int K_BYTES = BK * D * 2, Q_BYTES = BWD_TILE * D * 2;
  // k and v tiles, the q and do ring, each stage's lse * log2(e) and
  // delta (2 x 64 fp32), the barriers, and 1024 bytes to align the tiles.
  static constexpr int SMEM = 1024 + 2 * K_BYTES + BWD_STAGES * (2 * Q_BYTES + 512) +
                              8 * (1 + 2 * BWD_STAGES);
};

// dS = P (dP - delta) of one tile of the dq pass, in place of the scores:
// P = exp(q.k * scale - lse), 0 at masked pairs and keys >= s_k. Rows are
// q (lse * log2(e) and delta of this thread's two rows), columns keys.
// MASKED tiles (a masked pair or the ragged edge) test every pair.
template <bool MASKED, int NS>
__device__ __forceinline__ void ds_rows(float (&sc)[NS], const float (&dp)[NS],
                                        const float (&lse2)[2], const float (&dl)[2], float sl2,
                                        int k0, int qa0, int s_k, int causal, int window) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int r = (j >> 1) & 1;
    float p = ex2(sc[j] * sl2 - lse2[r]);
    if (MASKED) {
      const int ka = k0 + acc_col(j);
      if (ka >= s_k || !live(qa0 + acc_row(j), ka, causal, window)) p = 0.f;
    }
    sc[j] = p * (dp[j] - dl[r]);
  }
}

// P^T of one tile of the dk/dv pass, in place of the transposed scores:
// rows are keys (from ka0), columns the q rows of the tile at q0, whose
// lse * log2(e) the stage holds at L; 0 at masked pairs, keys >= s_k and
// q rows >= s_q.
template <bool MASKED, int NS>
__device__ __forceinline__ void p_cols(float (&st)[NS], const float* L, float sl2, int q0,
                                       int ka0, int s_q, int s_k, int q_off, int causal,
                                       int window) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int qc = acc_col(j);
    float p = ex2(st[j] * sl2 - L[qc]);
    if (MASKED) {
      const int ka = ka0 + acc_row(j);
      if (q0 + qc >= s_q || ka >= s_k || !live(q0 + qc + q_off, ka, causal, window)) p = 0.f;
    }
    st[j] = p;
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(BwdDq<D, BQ>::THREADS, 1)
flash_bwd_dq_tc(__grid_constant__ const CUtensorMap tm_q,
                __grid_constant__ const CUtensorMap tm_do,
                __grid_constant__ const CUtensorMap tm_k,
                __grid_constant__ const CUtensorMap tm_v,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dq, int h, int kvh, int s_q, int s_k, float scale, int causal,
                int window) {
  using C = BwdDq<D, BQ>;
  constexpr int BK = BWD_TILE, ST = BWD_STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sDO = sQ + C::Q_BYTES, sK = sDO + C::Q_BYTES, sV = sK + ST * C::KV_BYTES;
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
      mbar_expect_tx(bar_q, 2 * C::Q_BYTES);
      tma_tile<D, BQ>(sQ, &tm_q, q0, bh, bar_q);
      tma_tile<D, BQ>(sDO, &tm_do, q0, bh, bar_q);
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
  const float sl2 = scale * LOG2E;
  const int qa0 = q0 + 64 * wg + q_off;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 64 * wg + acc_row(2 * r);
    const size_t at = (size_t)bh * s_q + qi;
    lse2[r] = qi < s_q ? lse[at] * LOG2E : 0.f;
    dl[r] = qi < s_q ? delta[at] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  mbar_wait(bar_q, 0);
  for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
    const int s = it % ST;
    const uint32_t tK = sK + s * C::KV_BYTES, tV = sV + s * C::KV_BYTES;
    mbar_wait(full(s), (it / ST) & 1);

    float sc[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, desc_k<D, BQ>(sQ, 64 * wg, kk), desc_k<D, BK>(tK, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_k<D, BQ>(sDO, 64 * wg, kk), desc_k<D, BK>(tV, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    reg_fence(sc);
    reg_fence(dp);

    const int k0 = kt * BK;
    const bool masked = k0 + BK > s_k || !all_live(q_lo, q_hi, k0, k0 + BK - 1, causal, window);
    if (masked)
      ds_rows<true>(sc, dp, lse2, dl, sl2, k0, qa0, s_k, causal, window);
    else
      ds_rows<false>(sc, dp, lse2, dl, sl2, k0, qa0, s_k, causal, window);
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(da[kk], sc, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(acc, da[kk], desc_mn<D, BK>(tK, kk), 1);
    wgmma_commit();
    wgmma_wait();
    reg_fence(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 64 * wg + acc_row(2 * r);
    if (qi >= s_q) continue;
    bf16* row = dq + ((size_t)bh * s_q + qi) * D;
#pragma unroll
    for (int j = 2 * r; j < D / 2; j += 4)
      store_bf16x2(row + acc_col(j), acc[j] * scale, acc[j + 1] * scale);
  }
}

template <int D, int BK>
__global__ void __launch_bounds__(BwdDkv<D, BK>::THREADS, 1)
flash_bwd_dkv_tc(__grid_constant__ const CUtensorMap tm_q,
                 __grid_constant__ const CUtensorMap tm_do,
                 __grid_constant__ const CUtensorMap tm_k,
                 __grid_constant__ const CUtensorMap tm_v,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int kvh, int s_q, int s_k,
                 float scale, int causal, int window) {
  using C = BwdDkv<D, BK>;
  constexpr int BQ = BWD_TILE, ST = BWD_STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + C::K_BYTES, sQ = sV + C::K_BYTES, sDO = sQ + ST * C::Q_BYTES;
  const uint32_t sL = sDO + ST * C::Q_BYTES;             // [ST][lse2 64, delta 64] fp32
  float* lsd = reinterpret_cast<float*>(smem_raw + (sL - raw));
  const uint32_t bar_k = sL + ST * 512;
  auto full = [&](int s) { return bar_k + 8 + 8 * s; };
  auto empty = [&](int s) { return bar_k + 8 + 8 * ST + 8 * s; };

  const int bkv = blockIdx.y;                            // b * kvh + kv head
  const int group = h / kvh, bb = bkv / kvh, kv_head = bkv % kvh;
  const int k0 = blockIdx.x * BK;
  const int c0 = blockIdx.z * C::DC;                     // this CTA's dk, dv columns
  // the q and do panels that hold columns [c0, c0 + DC): B of dV and dK
  const uint32_t col_off = (c0 / Panel<D>::PW) * BWD_TILE * Panel<D>::R;
  const int k_hi = min(k0 + BK, s_k) - 1;
  const int q_off = s_k - s_q;
  int qt0, qt1;
  q_tiles(k0, k_hi, s_q, q_off, BQ, causal, window, &qt0, &qt1);

  if (threadIdx.x == 0) {
    mbar_init(bar_k, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * C::NWG) {                             // producer: the whole warp
    if (lane == 0) {
      mbar_expect_tx(bar_k, 2 * C::K_BYTES);
      tma_tile<D, BK>(sK, &tm_k, k0, bkv, bar_k);
      tma_tile<D, BK>(sV, &tm_v, k0, bkv, bar_k);
    }
    int it = 0;
    for (int g = 0; g < group; ++g) {
      const int bh = bb * h + kv_head * group + g;
      for (int qt = qt0; qt < qt1; ++qt, ++it) {
        const int s = it % ST, q0 = qt * BQ;
        mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
        for (int i = lane; i < BQ; i += 32) {
          const int qi = q0 + i;
          const size_t at = (size_t)bh * s_q + qi;
          lsd[s * 128 + i] = qi < s_q ? lse[at] * LOG2E : 0.f;
          lsd[s * 128 + 64 + i] = qi < s_q ? delta[at] : 0.f;
        }
        __syncwarp();                                   // the lanes' stores before the arrive
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * C::Q_BYTES);
          tma_tile<D, BQ>(sQ + s * C::Q_BYTES, &tm_q, q0, bh, full(s));
          tma_tile<D, BQ>(sDO + s * C::Q_BYTES, &tm_do, q0, bh, full(s));
        }
        __syncwarp();
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64)
  const int wg = warp / 4;
  const float sl2 = scale * LOG2E;
  float gk[C::DC / 2], gv[C::DC / 2];
#pragma unroll
  for (int j = 0; j < C::DC / 2; ++j) gk[j] = gv[j] = 0.f;

  mbar_wait(bar_k, 0);
  int it = 0;
  for (int g = 0; g < group; ++g) {
    for (int qt = qt0; qt < qt1; ++qt, ++it) {
      const int s = it % ST, q0 = qt * BQ;
      const uint32_t tQ = sQ + s * C::Q_BYTES, tDO = sDO + s * C::Q_BYTES;
      const float* L = lsd + s * 128;                    // lse * log2(e), then delta
      mbar_wait(full(s), (it / ST) & 1);

      float st[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(st, desc_k<D, BK>(sK, 64 * wg, kk), desc_k<D, BQ>(tQ, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait();
      reg_fence(st);

      const bool masked = q0 + BQ > s_q || k0 + BK > s_k ||
                          !all_live(q0 + q_off, q0 + BQ - 1 + q_off, k0, k0 + BK - 1, causal,
                                    window);
      if (masked)
        p_cols<true>(st, L, sl2, q0, k0 + 64 * wg, s_q, s_k, q_off, causal, window);
      else
        p_cols<false>(st, L, sl2, q0, k0 + 64 * wg, s_q, s_k, q_off, causal, window);
      uint32_t pa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a(pa[kk], st, kk);
      float dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(gv, pa[kk], desc_mn<D, BQ>(tDO + col_off, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dpt, desc_k<D, BK>(sV, 64 * wg, kk), desc_k<D, BQ>(tDO, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait();
      reg_fence(gv);
      reg_fence(dpt);

#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) st[j] *= dpt[j] - L[64 + acc_col(j)];    // ds^T
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) acc_to_a(pa[kk], st, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(gk, pa[kk], desc_mn<D, BQ>(tQ + col_off, kk), 1);
      wgmma_commit();
      wgmma_wait();
      reg_fence(gk);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty(s));
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = k0 + 64 * wg + acc_row(2 * r);
    if (ki >= s_k) continue;
    const size_t at = ((size_t)bkv * s_k + ki) * D + c0;
#pragma unroll
    for (int j = 2 * r; j < C::DC / 2; j += 4) {
      store_bf16x2(dk + at + acc_col(j), gk[j] * scale, gk[j + 1] * scale);
      store_bf16x2(dv + at + acc_col(j), gv[j], gv[j + 1]);
    }
  }
}

template <int D, int BQ, int BK>
static cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dq, void* dk, void* dv,
                             int b, int h, int kvh, int s_q, int s_k, float scale, int causal,
                             int window, cudaStream_t stream) {
  using Q = BwdDq<D, BQ>;
  using K = BwdDkv<D, BK>;
  CUtensorMap mq, mdo, mk, mv;
  cudaError_t err;
  if ((err = make_map(&mq, q, D, s_q, b * h, BQ)) != cudaSuccess) return err;
  if ((err = make_map(&mdo, dout, D, s_q, b * h, BQ)) != cudaSuccess) return err;
  if ((err = make_map(&mk, k, D, s_k, b * kvh, BWD_TILE)) != cudaSuccess) return err;
  if ((err = make_map(&mv, v, D, s_k, b * kvh, BWD_TILE)) != cudaSuccess) return err;
  if ((err = allow_smem(flash_bwd_dq_tc<D, BQ>, Q::SMEM)) != cudaSuccess) return err;
  const dim3 grid_q((s_q + BQ - 1) / BQ, b * h);
  flash_bwd_dq_tc<D, BQ><<<grid_q, Q::THREADS, Q::SMEM, stream>>>(
      mq, mdo, mk, mv, lse, delta, static_cast<bf16*>(dq), h, kvh, s_q, s_k, scale, causal,
      window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = make_map(&mq, q, D, s_q, b * h, BWD_TILE)) != cudaSuccess) return err;
  if ((err = make_map(&mdo, dout, D, s_q, b * h, BWD_TILE)) != cudaSuccess) return err;
  if ((err = make_map(&mk, k, D, s_k, b * kvh, BK)) != cudaSuccess) return err;
  if ((err = make_map(&mv, v, D, s_k, b * kvh, BK)) != cudaSuccess) return err;
  if ((err = allow_smem(flash_bwd_dkv_tc<D, BK>, K::SMEM)) != cudaSuccess) return err;
  const dim3 grid_kv((s_k + BK - 1) / BK, b * kvh, D / K::DC);
  flash_bwd_dkv_tc<D, BK><<<grid_kv, K::THREADS, K::SMEM, stream>>>(
      mq, mdo, mk, mv, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, kvh, s_q,
      s_k, scale, causal, window);
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_tc_d(int bq, int bk, const void* q, const void* k, const void* v,
                               const void* dout, const float* lse, const float* delta, void* dq,
                               void* dk, void* dv, int b, int h, int kvh, int s_q, int s_k,
                               float scale, int causal, int window, cudaStream_t s) {
#define REPRO_BWD_CASE(BQ, BK)                                                                \
  if constexpr (BwdDq<D, BQ>::SMEM <= SMEM_MAX && BwdDkv<D, BK>::SMEM <= SMEM_MAX)            \
    if (bq == BQ && bk == BK)                                                                 \
      return launch_tc<D, BQ, BK>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, kvh, s_q, s_k, \
                                  scale, causal, window, s);
  REPRO_BWD_CASE(64, 64)
  REPRO_BWD_CASE(64, 128)
  REPRO_BWD_CASE(128, 64)
  REPRO_BWD_CASE(128, 128)
#undef REPRO_BWD_CASE
  return cudaErrorInvalidValue;
}

// bf16 q, k, v, dout (16-byte aligned, contiguous), dq, dk, dv; fp32 lse and
// delta; block_q (the dq pass's q tile) and block_k (the dk/dv pass's k
// tile) in {64, 128}, of those whose two CTAs fit SMEM_MAX at d (at d = 256:
// 64 and 64).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse,
                                         const float* delta, void* dq, void* dk, void* dv,
                                         int b, int h, int kvh, int s_q, int s_k, int d,
                                         float scale, int causal, int window, int block_q,
                                         int block_k, void* stream) {
  if (kvh <= 0 || h % kvh != 0 || b * h > 65535) return cudaErrorInvalidValue;
  if (b <= 0 || s_q <= 0 || s_k <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BWD_D(D)                                                                        \
  case D:                                                                                     \
    return launch_tc_d<D>(block_q, block_k, q, k, v, dout, lse, delta, dq, dk, dv, b, h, kvh, \
                          s_q, s_k, scale, causal, window, s);
  switch (d) {
    REPRO_BWD_D(16)
    REPRO_BWD_D(32)
    REPRO_BWD_D(64)
    REPRO_BWD_D(128)
    REPRO_BWD_D(256)
#undef REPRO_BWD_D
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool simt_live(int qa, int ka, int causal, int window) {
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
flash_bwd_dq_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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
        if (simt_live(qa, k0 + j, causal, window)) {
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
flash_bwd_dkv_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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
          if (simt_live(q0 + i + q_off, ka, causal, window)) {
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

// Shared-memory bytes of one fp32 CTA of each pass; kernels/attention.py
// mirrors these formulas.
extern "C" int repro_flash_bwd_dq_simt_smem_bytes(int d, int block_q, int block_k) {
  return (3 * block_q * (d + 1) + 2 * block_k * (d + 1) + FLASH_WARPS * block_k) * 4;
}

extern "C" int repro_flash_bwd_dkv_simt_smem_bytes(int d, int block_q, int block_k) {
  return (4 * block_k * (d + 1) + 2 * block_q * (d + 1) + 2 * block_q +
          2 * FLASH_WARPS * block_q) * 4;
}

template <typename T>
static cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dq, void* dk, void* dv,
                              int b, int h, int kvh, int s_q, int s_k, int d, float scale,
                              int causal, int window, int block_q, int block_k,
                              cudaStream_t s) {
  const int smem_q = repro_flash_bwd_dq_simt_smem_bytes(d, block_q, block_k);
  const int smem_kv = repro_flash_bwd_dkv_simt_smem_bytes(d, block_q, block_k);
  cudaError_t err;
  if ((err = allow_smem(flash_bwd_dq_simt<T>, smem_q)) != cudaSuccess) return err;
  if ((err = allow_smem(flash_bwd_dkv_simt<T>, smem_kv)) != cudaSuccess) return err;
  const T *Q = static_cast<const T*>(q), *K = static_cast<const T*>(k);
  const T *V = static_cast<const T*>(v), *DO = static_cast<const T*>(dout);
  const dim3 grid_q((s_q + block_q - 1) / block_q, b * h);
  flash_bwd_dq_simt<T><<<grid_q, 32 * FLASH_WARPS, smem_q, s>>>(
      Q, K, V, DO, lse, delta, static_cast<T*>(dq), h, kvh, s_q, s_k, d, scale, causal, window,
      block_q, block_k);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_kv((s_k + block_k - 1) / block_k, b * kvh);
  flash_bwd_dkv_simt<T><<<grid_kv, 32 * FLASH_WARPS, smem_kv, s>>>(
      Q, K, V, DO, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), h, kvh, s_q, s_k, d,
      scale, causal, window, block_q, block_k);
  return cudaGetLastError();
}

// fp32 q, k, v, dout, dq, dk, dv; any tiles whose shared memory fits
// (attention.py maps every config to its SIMT tiles at the head dim: 64 x
// 64, 32 x 32 at d = 256).
extern "C" int repro_flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* delta, void* dq, void* dk, void* dv,
                                             int b, int h, int kvh, int s_q, int s_k, int d,
                                             float scale, int causal, int window, int block_q,
                                             int block_k, void* stream) {
  if (kvh <= 0 || h % kvh != 0 || d < 1 || d > 256 || block_q < 1 || block_k < 1 ||
      b * h > 65535)
    return cudaErrorInvalidValue;
  if (b <= 0 || s_q <= 0 || s_k <= 0) return cudaSuccess;
  return launch_simt<float>(q, k, v, dout, lse, delta, dq, dk, dv, b, h, kvh, s_q, s_k, d,
                            scale, causal, window, block_q, block_k,
                            static_cast<cudaStream_t>(stream));
}

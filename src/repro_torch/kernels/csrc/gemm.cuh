// The gemm shared by matmul.cu, expert_gemm.cu, matmul_bias_act.cu and
// rmsnorm_matmul.cu: C[z] = epilogue(A[z] @ B[z]) for z < batch, each
// product [m,k] @ [k,n] with fp32 accumulation and the output in the input
// dtype. matmul launches one product; expert_gemm one per expert;
// matmul_bias_act one, with an epilogue; rmsnorm_matmul one, with a norm
// prologue on A.
//
// The norm prologue (rmsnorm_matmul's, tc and decode routes, A and B
// row-major, one product) makes A = rmsnorm(x, scale) on its way from the
// ring to wgmma, in the reference's cast order: the row's fp32 sum of
// squares over the true k, xn = bf16(x * rsqrt(mean + eps)), then
// bf16(xn * scale). Before the k loop each consumer warp computes the
// inverse rms of the rows its threads will rewrite from global x (one
// warp a row, 16-byte loads), while the producer fills the ring; each
// thread keeps its rows' values in registers. The producer loads the
// slice's scale into the stage beside A's and B's slices. After a slice
// lands, each consumer warpgroup rewrites its band of A's slice in place,
// 16 bytes a thread at a time, each chunk un-swizzled to its (row, k), then
// fence.proxy.async and a barrier over the warpgroup before wgmma reads
// it. TMA zero-fills past k and past m, so the edges stay zero. On the tc
// route it is a template parameter of gemm_tc (NORM); the decode route has
// a kernel of its own, gemm_decode_norm, persistent over column tiles so
// that a CTA computes its rows' statistics once. rmsnorm_matmul.cu alone
// instantiates them: the other libraries' kernels are the same code as
// without them.
//
// The epilogue (matmul_bias_act's) runs on the fp32 accumulator before the
// one cast, on every route: + bias[col] (a [n] vector in the input dtype,
// read as fp32), then the activation (none, gelu in its tanh form, silu as
// h / (1 + exp(-h))). It is two runtime arguments, a bias pointer and an
// activation code, not template parameters, so the tc and decode kernels
// are instantiated once; the branch is uniform across the CTA and sits in
// the epilogue only. matmul and expert_gemm pass no bias and ACT_NONE, and
// the accumulator then passes through untouched: their results are the
// same bits as before the epilogue existed.
//
// Each operand is read in the layout in which it is stored, so the
// backward's transposed operands (ct @ w^T, x^T @ ct) and the MoE swapaxes
// views need no copy: an operand is either row-major (element (r, c) at
// p[r*ld + c]) or transposed, i.e. column-major (element (r, c) at
// p[c*ld + r]), with its own leading dimension ld, and product z's operand
// starts sa (or sb) elements after product z-1's (0 broadcasts one operand
// to every product). C is contiguous, [batch, m, n].
//
// Four routes, chosen by kernels/matmul.py:route (shapes, strides and
// alignment; never on a failure) and the config's bm:
//
// * tc (bf16, bm = 64 or 128): one CTA computes a (bm x bn) tile of one
//   product with wgmma, fed by TMA through a ring of `stages` shared-memory
//   stages of bk-deep k slices, each guarded by a full and an empty
//   mbarrier. One producer warp keeps the ring full; bm / 64 consumer
//   warpgroups each issue m64 x bn x k16 products on their 64-row band,
//   keep the fp32 accumulator in registers, and release a stage once the
//   products that read it have retired (one group stays in flight). A and
//   B are read by tensor maps in their stored layout as 64-element column
//   panels under the 128-byte swizzle; a row-major A (transposed B) is the
//   K-major operand, a transposed A (row-major B) the MN-major one, through
//   the descriptor's transpose bit, so all four layouts are descriptor bits
//   and never a copy. TMA reads zeros past every edge, so the k loop masks
//   nothing. The epilogue stages the tile through shared memory as bf16
//   and stores rows < m and columns < n, 16 bytes a thread where the row
//   allows.
// * decode (bf16, bm = 16): wgmma's M is at least 64, so rows are few
//   here: the CTA computes C^T = B^T A^T for 16 rows of A and bn columns of
//   B: each 64 columns of B are an M operand (MN-major for a row-major B,
//   K-major for a transposed one), the 16 rows of A the N = 16 operand
//   (K-major, or MN-major under the 32-byte swizzle for a transposed A),
//   and the accumulator is written back transposed into C[m, n]. These
//   products are bound by the bytes of B: one consumer warpgroup and a deep
//   ring keep `stages` slices of B in flight.
// * wmma (bf16 operands TMA cannot address: a base or stride that is not a
//   multiple of 16 bytes): the WMMA 16x16x16 tile loop of the first port,
//   each slice staged synchronously by all threads with its ragged edge
//   zero-filled.
// * simt (fp32; no TF32, the fp32 sites follow the reference): on the SIMT
//   cores. Decode rows (m <= 16) run gemm_simt_rows, a read of B with each
//   thread's loads along k in flight. More rows run gemm_simt: a 128 x 256
//   CTA tile, an 8 x 16 register tile a thread, fed by a ring of cp.async
//   k slices. Each output is one fmaf chain over k in
//   increasing order from 0.f, so at one split its bits are the first
//   port's loop's (gemm_simt_loop, kept behind GEMM_LOOP as the yardstick).
//
// fp32 out (tc, decode, wmma; matmul.cu with no C): the same raw fp32
// partial sums go to the workspace, one split or several, and the caller
// adds them (a tensor-parallel rank's row-parallel product, summed over the
// ranks in fp32 and rounded once). A kernel writes partials exactly when it
// is given a workspace, which the wrappers allocate for a split or fp32 out.
// Split-k (tc, decode, simt): the k slices are cut into `splits` ranges of
// kps whole slices each (kernels/matmul.py:split_k), one range a CTA on
// blockIdx.z / batch. Each writes its raw fp32 partial sums to a workspace
// [splits, batch, m, n] the wrapper allocates, and gemm_splitk_sum adds the
// splits in a fixed order, applies the epilogue and casts: deterministic,
// no atomics.
#pragma once

#include <mma.h>

#include <atomic>
#include <mutex>
#include <type_traits>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

// Kernel codes passed from kernels/matmul.py (ROUTES, ROWS_CODE, LOOP_CODE).
enum { GEMM_TC = 0, GEMM_DECODE = 1, GEMM_WMMA = 2, GEMM_SIMT = 3, GEMM_ROWS = 4, GEMM_LOOP = 5 };
// Epilogue activations (kernels/fused.py:ACTS).
enum { ACT_NONE = 0, ACT_GELU = 1, ACT_SILU = 2 };

namespace gemm {

using namespace sm90;

constexpr int MAX_STAGES = 6;
constexpr int MAX_DEVICES = 16;
constexpr int DEC_ROWS = 16;       // the decode route's N: rows of A a CTA

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Generic-proxy writes to shared memory the async proxy (TMA, wgmma) read
// before: ordered after those reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The activation of the epilogue, in fp32: gelu in its tanh form, silu as
// h / (1 + exp(-h)) (tanhf and expf, no fast-math intrinsics).
__device__ __forceinline__ float apply_act(float h, int act) {
  if (act == ACT_GELU) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
  }
  if (act == ACT_SILU) return h / (1.f + expf(-h));
  return h;
}

// The epilogue on the fp32 accumulator h of C's column `col` (< n): the
// bias, then the activation. No bias and ACT_NONE return h as it is.
template <typename T>
__device__ __forceinline__ float epilogue(float h, const T* __restrict__ bias, int act, int col) {
  if (bias != nullptr) h += to_f32(bias[col]);
  return apply_act(h, act);
}

// The epilogue on a tc consumer thread's m64 x BN accumulator (tile column
// col0; columns past n, which are never stored, read a bias of the last
// columns), in passes with the branches outside them: one element's
// exponential and division then overlap the next ones' instead of waiting
// behind a branch each (silu's IEEE division keeps a slow-path branch, so
// its exponentials go first, eight at a time). acc[j..j+3] (j % 4 == 0)
// hold columns c, c + 1 of rows r and r + 8: one bias pair serves four.
template <int N>
__device__ __forceinline__ void epilogue_acc(float (&acc)[N], const bf16* __restrict__ bias,
                                             int act, int col0, int n) {
  if (bias != nullptr) {
    // c is even: an even n and a 4-byte aligned bias make (c, c + 1) one load
    const bool pairs = n % 2 == 0 && (reinterpret_cast<uintptr_t>(bias) & 3) == 0;
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const int c = col0 + acc_col(j);
      const float2 b =
          pairs ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + min(c, n - 2)))
                : make_float2(to_f32(bias[min(c, n - 1)]), to_f32(bias[min(c + 1, n - 1)]));
      acc[j] += b.x;
      acc[j + 1] += b.y;
      acc[j + 2] += b.x;
      acc[j + 3] += b.y;
    }
  }
  if (act == ACT_GELU) {
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = apply_act(acc[j], ACT_GELU);
  } else if (act == ACT_SILU) {
#pragma unroll
    for (int j0 = 0; j0 < N; j0 += 8) {
      float e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = expf(-acc[j0 + i]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j0 + i] = acc[j0 + i] / (1.f + e[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// The norm prologue
// ---------------------------------------------------------------------------

// What the prologue reads beside A's tensor map: the tensor map of the [k]
// scale (a slice of BK elements lands in each ring stage beside A's and B's
// slices, so that the rewrite reads it from shared memory), x's rows in
// global memory for the statistics (row-major, ld elements apart; ld and
// the base multiples of 16 bytes, as TMA needs) and eps. A kernel
// parameter (__grid_constant__, so that TMA reads the map where it lies);
// empty without NORM.
struct Norm {
  CUtensorMap tm_scale;
  const bf16* x;
  long long ld;
  float eps;
};

// Shared memory the prologue adds to a ring of `stages` stages: a BK-element
// scale slice a stage, from the first 128-byte boundary past the barriers
// (at most 96 bytes of them), where TMA may write.
__host__ __device__ constexpr int norm_smem(int bk, int stages) { return 128 + stages * bk * 2; }

// A consumer thread's part of a warpgroup's band of Q * 16 rows of a K-major
// A slice (64-element panels, each row 128 bytes under the 128-byte
// swizzle, which moves 16-byte chunk c of row r to chunk c ^ (r % 8)):
// thread t (of 128) rewrites physical chunk t % 8 of the band's rows
// norm_row() + 16 q, q < Q, in every panel. Warp w's threads hold rows w +
// 4 j + 16 q (j < 4), so that a decode CTA's 8 rows give each warp two
// for its statistics. A thread's rows share r % 8, so its chunks hold one
// logical chunk, k = 64 p + 8 * norm_chunk() in panel p.
__device__ __forceinline__ int norm_row() {
  const int t = threadIdx.x % 128;
  return 4 * (t % 32 / 8) + t / 32;
}

__device__ __forceinline__ int norm_chunk() {
  return (threadIdx.x % 8) ^ (norm_row() % 8);
}

// inv[q] = the fp32 inverse rms of row r0 + 4 * (lane / 8) + 16 q of x (0
// at or past m), r0 the first row of this warp: the warp computes rows
// r0 + 4 j + 16 q, j < 4, one warp a row, NORM_LOADS 16-byte loads of each
// of the 4 rows in flight a lane. The statistics are a read of x from L2
// whose latency, not its bytes, sets their time.
constexpr int NORM_LOADS = 4;

template <int Q>
__device__ __forceinline__ void norm_stats(float (&inv)[Q], const Norm& nm, int r0, int m,
                                           int k) {
  const int lane = threadIdx.x % 32, chunks = k / 8;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float ss[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = lane; c0 < chunks; c0 += 32 * NORM_LOADS) {
      uint4 v[4][NORM_LOADS];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + 4 * j + 16 * q;
        const uint4* row = reinterpret_cast<const uint4*>(nm.x + (size_t)r * nm.ld);
#pragma unroll
        for (int u = 0; u < NORM_LOADS; ++u)
          v[j][u] = r < m && c0 + 32 * u < chunks ? __ldg(row + c0 + 32 * u)
                                                  : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < NORM_LOADS; ++u) {
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[j][u]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            ss[j] = fmaf(f.x, f.x, ss[j]);
            ss[j] = fmaf(f.y, f.y, ss[j]);
          }
        }
    }
    inv[q] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss[j] += __shfl_xor_sync(0xffffffffu, ss[j], o);
      if (j == lane / 8 && r0 + 4 * j + 16 * q < m)
        inv[q] = rsqrtf(ss[j] / static_cast<float>(k) + nm.eps);
    }
  }
}

// Two elements of A: bf16(bf16(x * inv) * scale). The first product is
// fp32 (a bf16 widens by a shift); the second is one bf16x2 multiply, whose
// exact product of two bf16 values rounded once is bf16(float(xn) * scale).
__device__ __forceinline__ uint32_t norm_pair(uint32_t xv, uint32_t sv, float inv) {
  const __nv_bfloat162 xn = __floats2bfloat162_rn(__uint_as_float(xv << 16) * inv,
                                                  __uint_as_float(xv & 0xffff0000u) * inv);
  const __nv_bfloat162 o = __hmul2(xn, *reinterpret_cast<const __nv_bfloat162*>(&sv));
  return *reinterpret_cast<const uint32_t*>(&o);
}

// Rewrite this thread's chunks of the band whose first row is `band` of
// the slice at `tile` (NP panels of `rows` rows each, slice start k0; its
// scale slice at `scale`; smem_raw: the generic address of shared memory's
// start), then make the writes visible to the async proxy. The caller's
// barrier over the warpgroup follows. Chunks at or past k stay TMA's zeros.
template <int Q, int NP>
__device__ __forceinline__ void norm_slice(uint8_t* smem_raw, uint32_t tile, uint32_t scale,
                                           int rows, int band, const float (&inv)[Q], int k0,
                                           int k) {
  uint8_t* base = smem_raw + (tile - smem_addr(smem_raw)) + (band + norm_row()) * 128 +
                  (threadIdx.x % 8) * 16;
  const uint4* sc = reinterpret_cast<const uint4*>(smem_raw + (scale - smem_addr(smem_raw))) +
                    norm_chunk();
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (k0 + 64 * p + 8 * norm_chunk() >= k) continue;
    const uint4 s = sc[8 * p];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      uint4* chunk = reinterpret_cast<uint4*>(base + p * rows * 128 + q * 16 * 128);
      uint4 v = *chunk;
      v.x = norm_pair(v.x, s.x, inv[q]);
      v.y = norm_pair(v.y, s.y, inv[q]);
      v.z = norm_pair(v.z, s.z, inv[q]);
      v.w = norm_pair(v.w, s.w, inv[q]);
      *chunk = v;
    }
  }
  fence_proxy_async();
}

// One box of a 2-D map (z < 0: a broadcast operand) or a 3-D one.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                        int z, uint32_t bar) {
  if (z < 0)
    tma_load_2d(dst, map, c0, c1, bar);
  else
    tma_load_3d(dst, map, c0, c1, z, bar);
}

// The shared-memory layout both tensor-core kernels use: 1024 bytes to
// align the ring for the 128-byte swizzle, `stages` stages (reused by the
// epilogue), then a full and an empty barrier a stage.
__host__ __device__ constexpr int ring_smem(int stage_bytes, int out_bytes, int stages) {
  return 1024 + (stages * stage_bytes > out_bytes ? stages * stage_bytes : out_bytes) +
         16 * stages;
}

// ---------------------------------------------------------------------------
// tc: wgmma from a TMA ring
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK>
struct Tc {
  static constexpr int NWG = BM / 64;                   // consumer warpgroups
  static constexpr int THREADS = NWG * 128 + 32;        // + the producer warp
  static constexpr int STAGE = (BM + BN) * BK * 2;      // A and B slices
  static constexpr int LDO = BN + 8;                    // staged output row (bf16)
  static constexpr int OUT = BM * LDO * 2;
};

// C (bf16) or the split's fp32 partial sums, from the m64 x BN accumulator
// of the warpgroup whose band starts at row r0 (c0: the tile's column).
template <int BN>
__device__ __forceinline__ void store_partial(float* __restrict__ w, const float (&acc)[BN / 2],
                                              int m, int n, int r0, int c0) {
  const bool pair = n % 2 == 0;
#pragma unroll
  for (int j = 0; j < BN / 2; j += 2) {
    const int gr = r0 + acc_row(j), gc = c0 + acc_col(j);
    if (gr >= m || gc >= n) continue;
    float* p = w + (size_t)gr * n + gc;
    if (pair) {
      *reinterpret_cast<float2*>(p) = make_float2(acc[j], acc[j + 1]);
    } else {
      p[0] = acc[j];
      if (gc + 1 < n) p[1] = acc[j + 1];
    }
  }
}

template <bool TA, bool TB, int BM, int BN, int BK, bool NORM>
__global__ void __launch_bounds__(Tc<BM, BN, BK>::THREADS, 1)
gemm_tc(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
        bf16* __restrict__ c, float* __restrict__ ws, const bf16* __restrict__ bias, int act,
        int m, int n, int k, int batch, int bcast_a, int bcast_b, int stages, int kps,
        int m_fast, const __grid_constant__ Norm nm) {
  using C = Tc<BM, BN, BK>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + (stages * C::STAGE > C::OUT ? stages * C::STAGE : C::OUT);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * stages + 8 * s; };
  auto tile_a = [&](int s) { return base + s * C::STAGE; };
  auto tile_b = [&](int s) { return base + s * C::STAGE + BM * BK * 2; };
  auto scale_s = [&](int s) { return bars + 128 + s * BK * 2; };   // NORM: norm_smem

  const int z = blockIdx.z % batch, split = blockIdx.z / batch;
  const int row0 = (m_fast ? blockIdx.x : blockIdx.y) * BM;
  const int col0 = (m_fast ? blockIdx.y : blockIdx.x) * BN;
  const int slices = (k + BK - 1) / BK;
  const int s0 = split * kps, nsl = min(s0 + kps, slices) - s0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4 * C::NWG) {                                 // producer
    if (threadIdx.x % 32 == 0) {
      const int za = bcast_a ? -1 : z, zb = bcast_b ? -1 : z;
      for (int it = 0; it < nsl; ++it) {
        const int s = it % stages, k0 = (s0 + it) * BK;
        mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
        mbar_expect_tx(full(s), C::STAGE + (NORM ? BK * 2 : 0));
        if constexpr (NORM) tma_load_3d(scale_s(s), &nm.tm_scale, k0, 0, 0, full(s));
        // A: K-major [BM][BK] in BK/64 panels, or MN-major [BK][BM] in BM/64
        if (!TA) {
#pragma unroll
          for (int p = 0; p < BK / 64; ++p)
            tma_box(tile_a(s) + p * BM * 128, &tm_a, k0 + 64 * p, row0, za, full(s));
        } else {
#pragma unroll
          for (int p = 0; p < BM / 64; ++p)
            tma_box(tile_a(s) + p * BK * 128, &tm_a, row0 + 64 * p, k0, za, full(s));
        }
        // B: K-major [BN][BK] (stored transposed), or MN-major [BK][BN]
        if (TB) {
#pragma unroll
          for (int p = 0; p < BK / 64; ++p)
            tma_box(tile_b(s) + p * BN * 128, &tm_b, k0 + 64 * p, col0, zb, full(s));
        } else {
#pragma unroll
          for (int p = 0; p < BN / 64; ++p)
            tma_box(tile_b(s) + p * BK * 128, &tm_b, col0 + 64 * p, k0, zb, full(s));
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [row0 + 64 wg, row0 + 64 wg + 64)
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  float inv[4];                   // NORM: the inverse rms of this thread's 4 rows of the band
  if constexpr (NORM) norm_stats<4>(inv, nm, row0 + 64 * wg + warp % 4, m, k);

  for (int it = 0; it < nsl; ++it) {
    const int s = it % stages;
    mbar_wait(full(s), (it / stages) & 1);
    const uint32_t ta = tile_a(s), tb = tile_b(s);
    if constexpr (NORM) {
      norm_slice<4, BK / 64>(smem_raw, ta, scale_s(s), BM, 64 * wg, inv, (s0 + it) * BK, k);
      named_sync(2 + wg, 128);
    }
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = TA ? desc_mn<64, BK>(ta + wg * BK * 128, kk)
                             : desc_k<BK, BM>(ta, 64 * wg, kk);
      const uint64_t db = TB ? desc_k<BK, BN>(tb, 0, kk) : desc_mn<BN, BK>(tb, kk);
      wgmma_ss<TA ? 1 : 0, TB ? 0 : 1>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(acc);
    // the products of slice it - 1 have retired: its stage is free
    if (it > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty((it - 1) % stages));
  }
  wgmma_wait<0>();
  reg_fence(acc);

  const int r0 = row0 + 64 * wg;
  if (ws != nullptr) {                        // a split, or fp32 out: raw fp32 partials
    store_partial<BN>(ws + ((size_t)split * batch + z) * m * n, acc, m, n, r0, col0);
    return;
  }
  // The epilogue, then stage the band as bf16 in the (now idle) ring and
  // store whole rows.
  epilogue_acc(acc, bias, act, col0, n);
  named_sync(1, C::NWG * 128);
  fence_proxy_async();
  bf16* so = reinterpret_cast<bf16*>(smem_raw + (base - smem_addr(smem_raw))) +
             64 * wg * C::LDO;
#pragma unroll
  for (int j = 0; j < BN / 2; j += 2)
    *reinterpret_cast<__nv_bfloat162*>(so + acc_row(j) * C::LDO + acc_col(j)) =
        __floats2bfloat162_rn(acc[j], acc[j + 1]);
  named_sync(2 + wg, 128);
  bf16* cz = c + (size_t)z * m * n;
  const bool vec = n % 8 == 0;
  constexpr int VPR = BN / 8;                               // 16-byte vectors a row
  for (int i = threadIdx.x % 128; i < 64 * VPR; i += 128) {
    const int r = i / VPR, gc = col0 + 8 * (i % VPR), gr = r0 + r;
    if (gr >= m || gc >= n) continue;
    const bf16* src = so + r * C::LDO + 8 * (i % VPR);
    bf16* dst = cz + (size_t)gr * n + gc;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && gc + e < n; ++e) dst[e] = src[e];
    }
  }
}

// ---------------------------------------------------------------------------
// decode: swap-AB, C^T = B^T A^T for 16 rows of A
// ---------------------------------------------------------------------------

template <int BN, int BK>
struct Dec {
  static constexpr int THREADS = 128 + 32;              // one consumer warpgroup
  static constexpr int W_BYTES = BN * BK * 2;           // B's slice
  static constexpr int STAGE = W_BYTES + DEC_ROWS * BK * 2;
  static constexpr int LDO = BN + 4;                    // staged output row (fp32)
  static constexpr int OUT = DEC_ROWS * LDO * 4;
};

template <bool TA, bool TB, int BN, int BK>
__global__ void __launch_bounds__(Dec<BN, BK>::THREADS, 1)
gemm_decode(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
            bf16* __restrict__ c, float* __restrict__ ws, const bf16* __restrict__ bias,
            int act, int m, int n, int k, int batch, int bcast_a, int bcast_b, int stages,
            int kps) {
  using C = Dec<BN, BK>;
  constexpr int NT = BN / 64;                               // m64 tiles of B^T
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + (stages * C::STAGE > C::OUT ? stages * C::STAGE : C::OUT);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * stages + 8 * s; };
  auto tile_w = [&](int s) { return base + s * C::STAGE; };
  auto tile_x = [&](int s) { return base + s * C::STAGE + C::W_BYTES; };

  const int z = blockIdx.z % batch, split = blockIdx.z / batch;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * DEC_ROWS;
  const int slices = (k + BK - 1) / BK;
  const int s0 = split * kps, nsl = min(s0 + kps, slices) - s0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x / 32 == 4) {                              // producer
    if (threadIdx.x % 32 == 0) {
      const int za = bcast_a ? -1 : z, zb = bcast_b ? -1 : z;
      for (int it = 0; it < nsl; ++it) {
        const int s = it % stages, k0 = (s0 + it) * BK;
        mbar_wait(empty(s), ((it / stages) & 1) ^ 1);
        mbar_expect_tx(full(s), C::STAGE);
        // B^T: K-major [BN][BK] (B stored transposed), or MN-major [BK][BN]
        if (TB) {
#pragma unroll
          for (int p = 0; p < BK / 64; ++p)
            tma_box(tile_w(s) + p * BN * 128, &tm_b, k0 + 64 * p, col0, zb, full(s));
        } else {
#pragma unroll
          for (int p = 0; p < NT; ++p)
            tma_box(tile_w(s) + p * BK * 128, &tm_b, col0 + 64 * p, k0, zb, full(s));
        }
        // A^T: K-major [16][BK], or MN-major [BK][16] under the 32-byte swizzle
        if (!TA) {
#pragma unroll
          for (int p = 0; p < BK / 64; ++p)
            tma_box(tile_x(s) + p * DEC_ROWS * 128, &tm_a, k0 + 64 * p, row0, za, full(s));
        } else {
          tma_box(tile_x(s), &tm_a, row0, k0, za, full(s));
        }
      }
    }
    return;
  }

  float acc[NT][8];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[t][j] = 0.f;

  for (int it = 0; it < nsl; ++it) {
    const int s = it % stages;
    mbar_wait(full(s), (it / stages) & 1);
    const uint32_t tw = tile_w(s), tx = tile_x(s);
#pragma unroll
    for (int t = 0; t < NT; ++t) reg_fence(acc[t]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dx = TA ? desc_mn<DEC_ROWS, BK>(tx, kk) : desc_k<BK, DEC_ROWS>(tx, 0, kk);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const uint64_t dw = TB ? desc_k<BK, BN>(tw, 64 * t, kk)
                               : desc_mn<64, BK>(tw + t * BK * 128, kk);
        wgmma_ss<TB ? 0 : 1, TA ? 1 : 0>(acc[t], dw, dx, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int t = 0; t < NT; ++t) reg_fence(acc[t]);
    if (it > 0 && threadIdx.x == 0) mbar_arrive(empty((it - 1) % stages));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < NT; ++t) reg_fence(acc[t]);

  // Stage C's [16][BN] tile in fp32 (acc rows are columns of C), then store
  // whole rows of C: bf16 after the epilogue (its bias runs along C's
  // columns, which are wgmma's M here), or the split's raw fp32 partials.
  named_sync(1, 128);
  fence_proxy_async();
  float* so = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)));
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j) so[acc_col(j) * C::LDO + 64 * t + acc_row(j)] = acc[t][j];
  named_sync(1, 128);
  constexpr int VPR = BN / 8;                               // 8-element vectors a row
  const bool split_out = ws != nullptr;                     // a split, or fp32 out
  for (int i = threadIdx.x; i < DEC_ROWS * VPR; i += 128) {
    const int r = i / VPR, gr = row0 + r, gc = col0 + 8 * (i % VPR);
    if (gr >= m || gc >= n) continue;
    const float* src = so + r * C::LDO + 8 * (i % VPR);
    if (split_out) {
      float* dst = ws + (((size_t)split * batch + z) * m + gr) * n + gc;
      if (n % 4 == 0) {
        reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
        if (gc + 4 < n) reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
      } else {
        for (int e = 0; e < 8 && gc + e < n; ++e) dst[e] = src[e];
      }
    } else {
      bf16* dst = c + ((size_t)z * m + gr) * n + gc;
      if (n % 8 == 0) {
        uint4 v;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h[e] = __floats2bfloat162_rn(epilogue(src[2 * e], bias, act, gc + 2 * e),
                                       epilogue(src[2 * e + 1], bias, act, gc + 2 * e + 1));
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        for (int e = 0; e < 8 && gc + e < n; ++e)
          dst[e] = __float2bfloat16(epilogue(src[e], bias, act, gc + e));
      }
    }
  }
}


// ---------------------------------------------------------------------------
// decode with the norm prologue: swap-AB, persistent over column tiles
// ---------------------------------------------------------------------------
//
// rmsnorm_matmul's decode route (A = x and B = w row-major, one product).
// The statistics of a CTA's 16 rows cost one read of them from L2 before
// the first slice can be rewritten, the same for every column tile, so a
// CTA computes them once and walks column tiles blockIdx.x, + gridDim.x, ...
// (the host sizes the grid to the CTAs the card holds at once): the ring
// runs on from one tile's slices into the next one's, and each tile's
// epilogue stages C in a region of its own while the producer already
// loads the next tile. Split-k: blockIdx.z is the split.
template <int BN, int BK>
__global__ void __launch_bounds__(Dec<BN, BK>::THREADS, 1)
gemm_decode_norm(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                 bf16* __restrict__ c, float* __restrict__ ws, int m, int n, int k, int stages,
                 int kps, const __grid_constant__ Norm nm) {
  using C = Dec<BN, BK>;
  constexpr int NT = BN / 64;                               // m64 tiles of B^T
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + stages * C::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * stages + 8 * s; };
  auto tile_w = [&](int s) { return base + s * C::STAGE; };
  auto tile_x = [&](int s) { return base + s * C::STAGE + C::W_BYTES; };
  auto scale_s = [&](int s) { return bars + 128 + s * BK * 2; };
  float* so = reinterpret_cast<float*>(smem_raw + (bars + norm_smem(BK, stages) -
                                                   smem_addr(smem_raw)));

  const int split = blockIdx.z, row0 = blockIdx.y * DEC_ROWS, tiles = (n + BN - 1) / BN;
  const int slices = (k + BK - 1) / BK;
  const int s0 = split * kps, nsl = min(s0 + kps, slices) - s0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x / 32 == 4) {                              // producer
    if (threadIdx.x % 32 == 0) {
      int g = 0;                                            // slices loaded so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int it = 0; it < nsl; ++it, ++g) {
          const int s = g % stages, k0 = (s0 + it) * BK, col0 = tile * BN;
          mbar_wait(empty(s), ((g / stages) & 1) ^ 1);
          mbar_expect_tx(full(s), C::STAGE + BK * 2);
          tma_load_3d(scale_s(s), &nm.tm_scale, k0, 0, 0, full(s));
          // B^T: MN-major [BK][BN]; A^T: K-major [16][BK]
#pragma unroll
          for (int p = 0; p < NT; ++p)
            tma_load_2d(tile_w(s) + p * BK * 128, &tm_b, col0 + 64 * p, k0, full(s));
#pragma unroll
          for (int p = 0; p < BK / 64; ++p)
            tma_load_2d(tile_x(s) + p * DEC_ROWS * 128, &tm_a, k0 + 64 * p, row0, full(s));
        }
    }
    return;
  }

  float inv[1];                                             // this thread's row's
  norm_stats<1>(inv, nm, row0 + threadIdx.x / 32, m, k);
  int g = 0;                                                // slices consumed so far
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[NT][8];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[t][j] = 0.f;
    for (int it = 0; it < nsl; ++it, ++g) {
      const int s = g % stages;
      mbar_wait(full(s), (g / stages) & 1);
      const uint32_t tw = tile_w(s), tx = tile_x(s);
      norm_slice<1, BK / 64>(smem_raw, tx, scale_s(s), DEC_ROWS, 0, inv, (s0 + it) * BK, k);
      named_sync(1, 128);
#pragma unroll
      for (int t = 0; t < NT; ++t) reg_fence(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dx = desc_k<BK, DEC_ROWS>(tx, 0, kk);
#pragma unroll
        for (int t = 0; t < NT; ++t)
          wgmma_ss<1, 0>(acc[t], desc_mn<64, BK>(tw + t * BK * 128, kk), dx, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int t = 0; t < NT; ++t) reg_fence(acc[t]);
      if (it > 0 && threadIdx.x == 0) mbar_arrive(empty((g - 1) % stages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < NT; ++t) reg_fence(acc[t]);
    if (threadIdx.x == 0) mbar_arrive(empty((g - 1) % stages));  // the tile's last slice

    // Stage C's [16][BN] tile in fp32 (acc rows are columns of C) once the
    // last tile's stores have read the staging, then store whole rows of C
    // (bf16), or the split's raw fp32 partials.
    named_sync(1, 128);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j) so[acc_col(j) * C::LDO + 64 * t + acc_row(j)] = acc[t][j];
    named_sync(1, 128);
    const int col0 = tile * BN;
    constexpr int VPR = BN / 8;                             // 8-element vectors a row
    for (int i = threadIdx.x; i < DEC_ROWS * VPR; i += 128) {
      const int r = i / VPR, gr = row0 + r, gc = col0 + 8 * (i % VPR);
      if (gr >= m || gc >= n) continue;
      const float* src = so + r * C::LDO + 8 * (i % VPR);
      if (gridDim.z > 1) {
        float* dst = ws + ((size_t)split * m + gr) * n + gc;
        if (n % 4 == 0) {
          reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
          if (gc + 4 < n)
            reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
        } else {
          for (int e = 0; e < 8 && gc + e < n; ++e) dst[e] = src[e];
        }
      } else {
        bf16* dst = c + (size_t)gr * n + gc;
        if (n % 8 == 0) {
          uint4 v;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          for (int e = 0; e < 8 && gc + e < n; ++e) dst[e] = __float2bfloat16(src[e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The first port's tile loops: wmma (bf16 operands TMA cannot address) and
// the fp32 loop (force_loop only)
// ---------------------------------------------------------------------------

// The (rows x cols) tile at (r0, c0) of a logical [R, C] operand stored
// row-major (TR = false) or transposed (TR = true), into shared memory in
// the stored layout: dst[r*ld + c] or dst[c*ld + r].
template <bool TR, typename T>
__device__ __forceinline__ void load_operand(T* __restrict__ dst, int ld,
                                             const T* __restrict__ src, int lds, int R,
                                             int C, int r0, int c0, int rows, int cols,
                                             bool vec) {
  if (TR)
    load_tile(dst, ld, src, lds, C, R, c0, r0, cols, rows, vec);
  else
    load_tile(dst, ld, src, lds, R, C, r0, c0, rows, cols, vec);
}

// One CTA computes one (bm x bn) tile of one product, looping over k in bk
// slices staged in shared memory in the stored layout (contiguous along the
// logical rows for a transposed operand, read by the WMMA col_major
// fragments), each warp owning a (16*FM x 32) sub-tile.
template <int FM, bool TA, bool TB>
__global__ void __launch_bounds__(512)
gemm_wmma(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C,
          const bf16* __restrict__ bias, int act, int m, int n, int k, int lda_g, int ldb_g,
          long long sa, long long sb, int bm, int bn, int bk, bool vec) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  A += blockIdx.z * sa;
  B += blockIdx.z * sb;
  C += blockIdx.z * (long long)m * n;
  // Shared tiles in the stored layout: A [bm][bk] or [bk][bm], B [bk][bn]
  // or [bn][bk], each row padded by 8 elements against bank conflicts.
  const int lda = (TA ? bm : bk) + 8, ldb = (TB ? bk : bn) + 8, ldc = bn + 4;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + (bm + 8) * (bk + 8);
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the k loop
  using LayoutA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;

  const int warp = threadIdx.x / 32;
  const int warps_n = bn / 32;
  const int wr = (warp / warps_n) * 16 * FM, wc = (warp % warps_n) * 32;
  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][2];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += bk) {
    load_operand<TA>(As, lda, A, lda_g, m, k, row0, k0, bm, bk, vec);
    load_operand<TB>(Bs, ldb, B, ldb_g, k, n, k0, col0, bk, bn, vec);
    __syncthreads();
    for (int kk = 0; kk < bk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> b[2];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int r = wr + i * 16;
        wmma::load_matrix_sync(a[i], TA ? As + kk * lda + r : As + r * lda + kk, lda);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wc + j * 16;
        wmma::load_matrix_sync(b[j], TB ? Bs + c * ldb + kk : Bs + kk * ldb + c, ldb);
      }
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
    if (gr < m && gc < n)
      C[(size_t)gr * n + gc] = __float2bfloat16(epilogue(Cs[r * ldc + c], bias, act, gc));
  }
}

// The first port's fp32 loop (GEMM_LOOP, reached only by force_loop), with
// split-k: blockIdx.z = split * batch + z, and a split writes its raw
// partial sums to ws (C, after the epilogue, when there is one split). One
// shared-memory load of A an FFMA: it tops out near a quarter of the SIMT
// cores' rate.
template <int FM, bool TA, bool TB>
__global__ void __launch_bounds__(512)
gemm_simt_loop(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
          float* __restrict__ ws, const float* __restrict__ bias, int act, int m, int n, int k,
          int batch, int lda_g, int ldb_g, long long sa, long long sb, int bm, int bn, int bk,
          int kps, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int z = blockIdx.z % batch, split = blockIdx.z / batch;
  A += z * sa;
  B += z * sb;
  const bool partial = ws != nullptr;                       // a split, or fp32 out
  float* out = partial ? ws + ((size_t)split * batch + z) * m * n : C + (size_t)z * m * n;
  const int kb = split * kps * bk, ke = min(k, kb + kps * bk);
  // Shared tiles in the stored layout, as in the bf16 kernel.
  const int lda = (TA ? bm : bk) + 4, ldb = (TB ? bk : bn) + 4;
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + (bm + 4) * (bk + 4);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps_n = bn / 32;
  const int wr = (warp / warps_n) * 16 * FM, col = (warp % warps_n) * 32 + lane;
  const int row0 = blockIdx.y * bm, col0 = blockIdx.x * bn;

  float acc[16 * FM];
#pragma unroll
  for (int i = 0; i < 16 * FM; ++i) acc[i] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += bk) {
    load_operand<TA>(As, lda, A, lda_g, m, k, row0, k0, bm, bk, vec);
    load_operand<TB>(Bs, ldb, B, ldb_g, k, n, k0, col0, bk, bn, vec);
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      const float b = TB ? Bs[col * ldb + kk] : Bs[kk * ldb + col];
#pragma unroll
      for (int i = 0; i < 16 * FM; ++i) {
        const int r = wr + i;
        acc[i] = fmaf(TA ? As[kk * lda + r] : As[r * lda + kk], b, acc[i]);
      }
    }
    __syncthreads();
  }
  const int gc = col0 + col;
  if (gc >= n) return;
#pragma unroll
  for (int i = 0; i < 16 * FM; ++i) {
    const int gr = row0 + wr + i;
    if (gr < m) out[(size_t)gr * n + gc] = partial ? acc[i] : epilogue(acc[i], bias, act, gc);
  }
}

// ---------------------------------------------------------------------------
// simt: fp32 register tiles from a cp.async ring
// ---------------------------------------------------------------------------
//
// What bounds it: a prefill gemm does 2 * m flops a weight element, far
// above the bytes, so the SIMT cores' FFMA issue is the wall (one warp-FFMA
// a clock a scheduler, 67 TFLOP/s on an H100 SXM), with the shared-memory
// pipe that feeds the operands beside it. The first port's loop read A from
// shared memory for every FFMA, near a quarter of that rate. Here a CTA
// computes a 128 x 256 tile with 8 warps of 32 x 128 and a thread an
// 8 x 16 register tile: a k step reads its 8 A values and 16 B values as
// six 16-byte shared loads, the next step's issued before this step's 128
// FFMAs. Both operands sit in shared memory k-major, [SIMT_BK][128 + pad]
// and [SIMT_BK][256 + pad], so the fragments are contiguous whatever the
// stored layout: an operand stored along M (a transposed A) or N (a
// row-major B) is copied as it is, in the widest cp.async granule its base,
// leading dimension and batch stride allow (16, 8 or 4 bytes:
// kernels/matmul.py:simt_granules), and one stored along k (a row-major A,
// a transposed B) is transposed on its way in by 4-byte element copies, a
// warp on the 32 k of one row. A ring of SIMT_STAGES slices of 32 k keeps
// the next slices' copies in flight behind the FFMAs, one barrier a slice.
// A warp's lanes
// are 4 rows by 8 columns of register tiles, each made of 4-row and
// 4-column groups 16 rows and 32 columns apart, so a quarter warp's 16-byte
// fragment reads are one broadcast (A) or 128 contiguous bytes (B).

constexpr int SIMT_BM = 128, SIMT_BN = 256, SIMT_BK = 32, SIMT_STAGES = 3, SIMT_THREADS = 256;
constexpr int SIMT_LDA = SIMT_BM + 4, SIMT_LDB = SIMT_BN + 4;
constexpr int SIMT_STAGE = SIMT_BK * (SIMT_LDA + SIMT_LDB);     // floats

// Shared-memory bytes of one simt CTA (kernels/matmul.py:SIMT_SMEM).
constexpr int SIMT_SMEM = SIMT_STAGES * SIMT_STAGE * 4;

// cp.async of g bytes (16, 8 or 4), the first `bytes` of them read from src
// and the rest zero-filled.
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, int g, int bytes) {
  if (g == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes) : "memory");
  else if (g == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One k slice of an operand into its k-major shared tile: dst[kk][j] =
// element (mn0 + j, k0 + kk) of a logical [MN, K] operand, zero past either
// edge. E > 0: stored along MN, copied in granules of E elements; E == 0:
// stored along k (at p[j * ld + k]), copied element by element, a warp on
// the 32 k of one row (128 contiguous bytes), so each thread keeps one k
// and steps its row by the 8 warps.
template <int T, int E>
__device__ __forceinline__ void simt_slice(uint32_t dst, const float* __restrict__ p,
                                           long long ld, int MN, int K, int mn0, int k0) {
  if constexpr (E > 0) {
    constexpr int PER = T / E;                            // granules a row
#pragma unroll
    for (int q = 0; q < SIMT_BK * PER / SIMT_THREADS; ++q) {
      const int i = threadIdx.x + q * SIMT_THREADS, kk = i / PER, j = (i % PER) * E;
      const int gk = k0 + kk, gj = mn0 + j;
      const int bytes = gk < K ? 4 * max(0, min(E, MN - gj)) : 0;
      cp_async_zfill(dst + (kk * (T + 4) + j) * 4, bytes ? p + (size_t)gk * ld + gj : p, 4 * E,
                     bytes);
    }
  } else {
    constexpr int STEP = SIMT_THREADS / SIMT_BK;
    const int kk = threadIdx.x % SIMT_BK, j0 = threadIdx.x / SIMT_BK, gk = k0 + kk;
    const float* src = p + (size_t)(mn0 + j0) * ld + gk;
    auto copy = [&](int q) {
      const int j = j0 + q * STEP;
      const bool on = gk < K && mn0 + j < MN;
      cp_async_zfill(dst + (kk * (T + 4) + j) * 4, on ? src + (size_t)q * STEP * ld : p, 4,
                     on ? 4 : 0);
    };
    // A's 16 copies unrolled whole; B's 32 (a transposed B) 8 at a time,
    // whose addresses would otherwise crowd the accumulators out of
    // registers
    if constexpr (T == SIMT_BM) {
#pragma unroll
      for (int q = 0; q < T / STEP; ++q) copy(q);
    } else {
#pragma unroll 8
      for (int q = 0; q < T / STEP; ++q) copy(q);
    }
  }
}

// One CTA computes a (SIMT_BM x SIMT_BN) tile of one product over its
// split's k slices; blockIdx.z = split * batch + z, and a split writes its
// raw partial sums to ws (C when there is one split). EA, EB: the granule in
// elements of A and B, or 0 for one transposed on its way in (A stored
// row-major, B transposed). EPI: the bias and activation epilogue (one
// split only). Each is a template parameter: the k loop holds 128
// accumulators in 255 registers a thread, and an argument or a branch kept
// live through it costs spills.
template <int EA, int EB, bool EPI>
__global__ void __launch_bounds__(SIMT_THREADS, 1)
gemm_simt(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
          float* __restrict__ ws, const float* __restrict__ bias, int act, int m, int n, int k,
          int batch, long long lda, long long ldb, long long sa, long long sb, int kps) {
  extern __shared__ __align__(16) float simt_smem[];
  A += blockIdx.z % batch * sa;
  B += blockIdx.z % batch * sb;
  const int split = blockIdx.z / batch;
  const int row0 = blockIdx.y * SIMT_BM, col0 = blockIdx.x * SIMT_BN;
  const int slices = (k + SIMT_BK - 1) / SIMT_BK;
  const int s0 = split * kps, nsl = min(s0 + kps, slices) - s0;
  const uint32_t base = smem_addr(simt_smem);

  // slice s0 + it into stage it % SIMT_STAGES: A's [BK][BM], then B's [BK][BN]
  auto load = [&](int it) {
    const uint32_t st = base + (it % SIMT_STAGES) * SIMT_STAGE * 4;
    const int k0 = (s0 + it) * SIMT_BK;
    simt_slice<SIMT_BM, EA>(st, A, lda, m, k, row0, k0);
    simt_slice<SIMT_BN, EB>(st + SIMT_BK * SIMT_LDA * 4, B, ldb, n, k, col0, k0);
  };
#pragma unroll
  for (int s = 0; s < SIMT_STAGES - 1; ++s) {
    if (s < nsl) load(s);
    cp_async_commit();
  }

  // lane (ly, lx) of warp (wm, wn): rows 32 wm + 16 g + 4 ly + i (g < 2),
  // columns 128 wn + 32 h + 4 lx + j (h < 4)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_off = 32 * (warp / 2) + 4 * (lane / 8), c_off = 128 * (warp % 2) + 4 * (lane % 8);
  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < nsl; ++it) {
    cp_async_wait<SIMT_STAGES - 2>();       // slice it has landed, for every thread
    __syncthreads();                        // and every thread is done with slice it - 1
    if (it + SIMT_STAGES - 1 < nsl) load(it + SIMT_STAGES - 1);   // into slice it - 1's stage
    cp_async_commit();
    const float* as = simt_smem + (it % SIMT_STAGES) * SIMT_STAGE + r_off;
    const float* bs = simt_smem + (it % SIMT_STAGES) * SIMT_STAGE + SIMT_BK * SIMT_LDA + c_off;
    float4 fa[2][2], fb[2][4];              // step kk's fragments in [kk % 2]
    auto fetch = [&](int kk, int buf) {
#pragma unroll
      for (int g = 0; g < 2; ++g)
        fa[buf][g] = *reinterpret_cast<const float4*>(as + kk * SIMT_LDA + 16 * g);
#pragma unroll
      for (int h = 0; h < 4; ++h)
        fb[buf][h] = *reinterpret_cast<const float4*>(bs + kk * SIMT_LDB + 32 * h);
    };
    fetch(0, 0);
#pragma unroll
    for (int kk = 0; kk < SIMT_BK; ++kk) {
      if (kk + 1 < SIMT_BK) fetch(kk + 1, (kk + 1) % 2);
      const int cur = kk % 2;
      const float a[8] = {fa[cur][0].x, fa[cur][0].y, fa[cur][0].z, fa[cur][0].w,
                          fa[cur][1].x, fa[cur][1].y, fa[cur][1].z, fa[cur][1].w};
      float b[16];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        b[4 * h] = fb[cur][h].x;
        b[4 * h + 1] = fb[cur][h].y;
        b[4 * h + 2] = fb[cur][h].z;
        b[4 * h + 3] = fb[cur][h].w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // 16-byte stores where C's rows are (n a multiple of 4; C and ws are
  // allocated aligned)
  const int z = blockIdx.z % batch;
  float* out = gridDim.z > batch ? ws + ((size_t)split * batch + z) * m * n
                                 : C + (size_t)z * m * n;
  const bool vec = n % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + r_off + 16 * (i / 4) + i % 4;
    if (gr >= m) continue;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int gc = col0 + c_off + 32 * h;
      if (gc >= n) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = EPI ? epilogue(acc[i][4 * h + e], bias, act, min(gc + e, n - 1))
                   : acc[i][4 * h + e];
      float* o = out + (size_t)gr * n + gc;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int e = 0; e < 4 && gc + e < n; ++e) o[e] = v[e];
      }
    }
  }
}

// fp32 decode rows (m <= MR): each thread owns 4 adjacent columns of C and
// walks its split's k range reading B a row at a time, its loads
// independent from one k to the next so that many are in flight (the
// product is a read of B); A's rows are staged in shared memory ROWS_KC k
// at a time as [k][MR], so one k's rows are MR / 4 broadcast 16-byte reads.
constexpr int ROWS_THREADS = 128, ROWS_COLS = 4 * ROWS_THREADS, ROWS_KC = 64;

template <int MR, bool TA, bool TB>
__global__ void __launch_bounds__(ROWS_THREADS)
gemm_simt_rows(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
               float* __restrict__ ws, const float* __restrict__ bias, int act, int m, int n,
               int k, int batch, int lda, int ldb, long long sa, long long sb, int kps,
               bool vec) {
  __shared__ __align__(16) float xs[ROWS_KC][MR];
  const int z = blockIdx.z % batch, split = blockIdx.z / batch;
  A += z * sa;
  B += z * sb;
  const bool partial = gridDim.z > batch;
  float* out = partial ? ws + ((size_t)split * batch + z) * m * n : C + (size_t)z * m * n;
  const int kb = split * kps * ROWS_KC, ke = min(k, kb + kps * ROWS_KC);
  const int c0 = blockIdx.x * ROWS_COLS + 4 * threadIdx.x;
  float acc[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int kc = kb; kc < ke; kc += ROWS_KC) {
    const int nk = min(ROWS_KC, ke - kc);
    __syncthreads();
    for (int i = threadIdx.x; i < ROWS_KC * MR; i += ROWS_THREADS) {
      // along the stored rows: k for a row-major A, the rows for a transposed one
      const int kk = TA ? i / MR : i % ROWS_KC, r = TA ? i % MR : i / ROWS_KC;
      xs[kk][r] = (kk < nk && r < m)
                      ? (TA ? A[(size_t)(kc + kk) * lda + r] : A[(size_t)r * lda + kc + kk])
                      : 0.f;
    }
    __syncthreads();
    if (c0 >= n) continue;
#pragma unroll 8
    for (int kk = 0; kk < nk; ++kk) {
      float b[4];
      if (!TB && vec) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(B + (size_t)(kc + kk) * ldb + c0));
        b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = c0 + j >= n ? 0.f
                 : TB       ? B[(size_t)(c0 + j) * ldb + kc + kk]
                            : B[(size_t)(kc + kk) * ldb + c0 + j];
      }
#pragma unroll
      for (int q = 0; q < MR / 4; ++q) {
        const float4 xv = reinterpret_cast<const float4*>(xs[kk])[q];
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[4 * q + e][j] = fmaf(x4[e], b[j], acc[4 * q + e][j]);
      }
    }
  }
  if (c0 >= n) return;
  if (!partial) {
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = epilogue(acc[r][j], bias, act, min(c0 + j, n - 1));
  }
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (r >= m) break;
    float* o = out + (size_t)r * n + c0;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
      for (int j = 0; j < 4 && c0 + j < n; ++j) o[j] = acc[r][j];
    }
  }
}

// out[i] = the sum of the splits' partials ws[s][i], s in order, then the
// epilogue (of column i % n), cast.
template <typename T>
__global__ void gemm_splitk_sum(const float* __restrict__ ws, T* __restrict__ out,
                                const T* __restrict__ bias, int act, long long count, int n,
                                int splits) {
  const bool epi = bias != nullptr || act != ACT_NONE;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int p = 1; p < splits; ++p) s += ws[p * count + i];
    if (epi) s = epilogue(s, bias, act, (int)(i % n));
    out[i] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------------------
// Host: shared memory, validation, template dispatch
// ---------------------------------------------------------------------------

static bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// Shared-memory bytes of the first port's WMMA and fp32 loops; each staged
// tile is padded on both sides so either layout fits.
static int loop_smem_bytes(int dtype, int bm, int bn, int bk) {
  if (dtype == REPRO_BF16) {
    const int stage = ((bm + 8) * (bk + 8) + (bk + 8) * (bn + 8)) * 2;
    const int out = bm * (bn + 4) * 4;
    return stage > out ? stage : out;
  }
  return ((bm + 4) * (bk + 4) + (bk + 4) * (bn + 4)) * 4;
}

// Shared-memory bytes of one CTA of a route; kernels/matmul.py mirrors it.
static int smem_bytes(int route, int dtype, int bm, int bn, int bk, int stages) {
  if (route == GEMM_TC)
    return ring_smem((bm + bn) * bk * 2, bm * (bn + 8) * 2, stages);
  if (route == GEMM_DECODE)
    return ring_smem((bn + DEC_ROWS) * bk * 2, DEC_ROWS * (bn + 4) * 4, stages);
  if (route == GEMM_SIMT) return SIMT_SMEM;
  return loop_smem_bytes(dtype, bm, bn, bk);
}

// The launch of one problem, as the entry points pass it.
struct Problem {
  const void* a;
  const void* b;
  void* c;
  float* ws;                       // [splits, batch, m, n] when splits > 1
  int batch, m, n, k, ta, tb;
  long long lda, ldb, sa, sb;
  int dtype, route, bm, bn, bk, stages, splits, kps;
  cudaStream_t stream;
  const void* bias = nullptr;      // the epilogue's [n] bias (input dtype), or none
  int act = ACT_NONE;              // the epilogue's activation
  const void* norm_scale = nullptr;  // the norm prologue's [k] scale (launch<true> only)
  float eps = 0.f;                 // and its eps
};

// Encoded tensor maps of recent launches, by everything an encoding reads:
// a decode step launches the same gemms on the same weights (and the
// caching allocator hands back the same activation buffers), and encoding
// costs host time on every launch. A map is a pure function of its key, so
// a hit is always the map an encoding would give.
struct MapKey {
  const void* p;
  long long inner, rows, ld, mats, stride;
  int box_inner, box_rows;
  bool dense = false;              // no swizzle, rank 3 (the prologue's scale)
  bool operator==(const MapKey& o) const {
    return p == o.p && inner == o.inner && rows == o.rows && ld == o.ld && mats == o.mats &&
           stride == o.stride && box_inner == o.box_inner && box_rows == o.box_rows &&
           dense == o.dense;
  }
};

constexpr int MAP_SLOTS = 512;

static cudaError_t cached_map(CUtensorMap* map, const MapKey& key) {
  static std::mutex mu;
  static MapKey keys[MAP_SLOTS];
  static CUtensorMap maps[MAP_SLOTS];
  static bool used[MAP_SLOTS];
  uint64_t h = reinterpret_cast<uintptr_t>(key.p) >> 4;
  for (long long v : {key.inner, key.rows, key.ld, key.mats, key.stride,
                      (long long)key.box_inner, (long long)key.box_rows})
    h = (h ^ (uint64_t)v) * 0x100000001b3ull;
  const int slot = (int)(h % MAP_SLOTS);
  std::lock_guard<std::mutex> lock(mu);
  if (used[slot] && keys[slot] == key) {
    *map = maps[slot];
    return cudaSuccess;
  }
  const cudaError_t err =
      key.dense ? make_dense_map(map, key.p, true, key.inner, key.rows, key.mats, key.ld,
                                 key.stride, key.box_inner, key.box_rows)
                : make_bf16_map(map, key.p, key.stride ? 3 : 2, key.inner, key.rows, key.ld,
                                key.mats, key.stride, key.box_inner, key.box_rows);
  if (err == cudaSuccess) {
    keys[slot] = key;
    maps[slot] = *map;
    used[slot] = true;
  }
  return err;
}

// The tensor map of an operand: a logical [R, C] matrix stored row-major
// (inner dim C, R rows) or transposed (inner dim R, C rows), `stride`
// elements from one product's to the next (0: a 2-D map), whose box is
// box_inner x box_rows.
static cudaError_t operand_map(CUtensorMap* map, const void* p, bool tr, int R, int C,
                               long long ld, int batch, long long stride, int box_inner,
                               int box_rows) {
  return cached_map(map, MapKey{p, tr ? R : C, tr ? C : R, ld, stride ? batch : 1, stride,
                                box_inner, box_rows});
}

// Opt a kernel in to `bytes` of dynamic shared memory once per size it
// needs, not on every launch.
template <typename K>
static cudaError_t opt_in(K kernel, int bytes, std::atomic<int> (&granted)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= MAX_DEVICES) return err ? err : cudaErrorInvalidDevice;
  if (bytes <= granted[dev].load()) return cudaSuccess;
  err = allow_smem(kernel, bytes);
  if (err == cudaSuccess) granted[dev].store(bytes);
  return err;
}

// The prologue's view of a problem, its scale's map in boxes of bk elements
// (NORM kernels read it; the others get an empty one).
template <bool NORM>
static cudaError_t norm_of(Norm* nm, const Problem& p, int bk) {
  *nm = Norm{};
  if constexpr (NORM) {
    nm->x = static_cast<const bf16*>(p.a);
    nm->ld = p.lda;
    nm->eps = p.eps;
    MapKey key{p.norm_scale, p.k, 1, p.k, 1, p.k, bk, 1};
    key.dense = true;
    return cached_map(&nm->tm_scale, key);
  }
  return cudaSuccess;
}

template <bool TA, bool TB, int BM, int BN, int BK, bool NORM>
static cudaError_t launch_tc(const Problem& p) {
  using C = Tc<BM, BN, BK>;
  CUtensorMap ma, mb;
  cudaError_t err;
  // A [m,k]: box 64 k x BM rows (K-major) or 64 m x BK rows (MN-major)
  if ((err = operand_map(&ma, p.a, TA, p.m, p.k, p.lda, p.batch, p.sa, 64, TA ? BK : BM)))
    return err;
  // B [k,n]: box 64 k x BN rows (stored transposed) or 64 n x BK rows
  if ((err = operand_map(&mb, p.b, TB, p.k, p.n, p.ldb, p.batch, p.sb, 64, TB ? BN : BK)))
    return err;
  Norm nm;
  if ((err = norm_of<NORM>(&nm, p, BK))) return err;
  const int smem =
      smem_bytes(GEMM_TC, REPRO_BF16, BM, BN, BK, p.stages) + (NORM ? norm_smem(BK, p.stages) : 0);
  static std::atomic<int> granted[MAX_DEVICES];
  if ((err = opt_in(gemm_tc<TA, TB, BM, BN, BK, NORM>, smem, granted))) return err;
  const int mt = (p.m + BM - 1) / BM, nt = (p.n + BN - 1) / BN;
  // the dimension with fewer tiles runs fastest: a wave then shares the
  // other operand's panels in L2
  const int m_fast = mt <= nt;
  const dim3 grid(m_fast ? mt : nt, m_fast ? nt : mt, p.batch * p.splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_tc<TA, TB, BM, BN, BK, NORM><<<grid, C::THREADS, smem, p.stream>>>(
      ma, mb, static_cast<bf16*>(p.c), p.ws, static_cast<const bf16*>(p.bias), p.act, p.m, p.n,
      p.k, p.batch, p.sa == 0, p.sb == 0, p.stages, p.kps, m_fast, nm);
  return cudaGetLastError();
}

template <bool TA, bool TB, int BN, int BK>
static cudaError_t launch_decode(const Problem& p) {
  using C = Dec<BN, BK>;
  CUtensorMap ma, mb;
  cudaError_t err;
  // A [m,k]: box 64 k x 16 rows (K-major) or 16 m x BK rows (MN-major, 32B)
  if ((err = operand_map(&ma, p.a, TA, p.m, p.k, p.lda, p.batch, p.sa, TA ? DEC_ROWS : 64,
                         TA ? BK : DEC_ROWS)))
    return err;
  if ((err = operand_map(&mb, p.b, TB, p.k, p.n, p.ldb, p.batch, p.sb, 64, TB ? BN : BK)))
    return err;
  const int smem = smem_bytes(GEMM_DECODE, REPRO_BF16, DEC_ROWS, BN, BK, p.stages);
  static std::atomic<int> granted[MAX_DEVICES];
  if ((err = opt_in(gemm_decode<TA, TB, BN, BK>, smem, granted))) return err;
  const dim3 grid((p.n + BN - 1) / BN, (p.m + DEC_ROWS - 1) / DEC_ROWS, p.batch * p.splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_decode<TA, TB, BN, BK><<<grid, C::THREADS, smem, p.stream>>>(
      ma, mb, static_cast<bf16*>(p.c), p.ws, static_cast<const bf16*>(p.bias), p.act, p.m, p.n,
      p.k, p.batch, p.sa == 0, p.sb == 0, p.stages, p.kps);
  return cudaGetLastError();
}

// Shared memory of one gemm_decode_norm CTA: the ring, its barriers and
// scale slices (norm_smem), and C's staged tile (kernels/fused.py mirrors
// it).
static int decode_norm_smem(int bn, int bk, int stages) {
  return 1024 + stages * (bn + DEC_ROWS) * bk * 2 + norm_smem(bk, stages) +
         DEC_ROWS * (bn + 4) * 4;
}

template <int BN, int BK>
static cudaError_t launch_decode_norm(const Problem& p) {
  using C = Dec<BN, BK>;
  CUtensorMap ma, mb;
  Norm nm;
  cudaError_t err;
  if ((err = operand_map(&ma, p.a, false, p.m, p.k, p.lda, 1, 0, 64, DEC_ROWS)) ||
      (err = operand_map(&mb, p.b, false, p.k, p.n, p.ldb, 1, 0, 64, BK)) ||
      (err = norm_of<true>(&nm, p, BK)))
    return err;
  const int smem = decode_norm_smem(BN, BK, p.stages);
  static std::atomic<int> granted[MAX_DEVICES];
  if ((err = opt_in(gemm_decode_norm<BN, BK>, smem, granted))) return err;
  // as many CTAs as the card holds at once (by ring depth), each walking
  // column tiles
  static std::atomic<int> resident[MAX_DEVICES][MAX_STAGES + 1];
  int dev = 0;
  if ((err = cudaGetDevice(&dev))) return err;
  int ctas = resident[dev][p.stages].load();
  if (ctas == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gemm_decode_norm<BN, BK>,
                                                             C::THREADS, smem)))
      return err;
    ctas = sms * (per_sm > 0 ? per_sm : 1);
    resident[dev][p.stages].store(ctas);
  }
  const int tiles = (p.n + BN - 1) / BN;
  const dim3 grid(tiles < ctas ? tiles : ctas, (p.m + DEC_ROWS - 1) / DEC_ROWS, p.splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_decode_norm<BN, BK><<<grid, C::THREADS, smem, p.stream>>>(
      ma, mb, static_cast<bf16*>(p.c), p.ws, p.m, p.n, p.k, p.stages, p.kps, nm);
  return cudaGetLastError();
}

// Template dispatch over the layouts and tiles of the two tensor-core routes.
template <bool TA, bool TB, bool NORM = false>
static cudaError_t launch_tc_layout(const Problem& p) {
#define REPRO_TC(BM, BN, BK) \
  if (p.bm == BM && p.bn == BN && p.bk == BK) return launch_tc<TA, TB, BM, BN, BK, NORM>(p);
#define REPRO_DEC(BN, BK)                                                               \
  if (p.bn == BN && p.bk == BK) {                                                       \
    if constexpr (NORM) return launch_decode_norm<BN, BK>(p);                           \
    else return launch_decode<TA, TB, BN, BK>(p);                                       \
  }
  if (p.route == GEMM_TC) {
    REPRO_TC(64, 64, 64) REPRO_TC(64, 64, 128) REPRO_TC(64, 128, 64) REPRO_TC(64, 128, 128)
    REPRO_TC(64, 256, 64) REPRO_TC(64, 256, 128) REPRO_TC(128, 64, 64) REPRO_TC(128, 64, 128)
    REPRO_TC(128, 128, 64) REPRO_TC(128, 128, 128) REPRO_TC(128, 256, 64)
    REPRO_TC(128, 256, 128)
  } else {
    REPRO_DEC(64, 64) REPRO_DEC(64, 128) REPRO_DEC(128, 64) REPRO_DEC(128, 128)
    REPRO_DEC(256, 64) REPRO_DEC(256, 128)
  }
#undef REPRO_TC
#undef REPRO_DEC
  return cudaErrorInvalidValue;
}

template <int MR>
static cudaError_t launch_rows(const Problem& p) {
  const dim3 grid((p.n + ROWS_COLS - 1) / ROWS_COLS, 1, p.batch * p.splits);
  // float4 reads of B's rows and writes of C's: 16-byte aligned rows
  const bool vec = reinterpret_cast<uintptr_t>(p.b) % 16 == 0 && p.ldb % 4 == 0 &&
                   p.sb % 4 == 0 && p.n % 4 == 0;
#define REPRO_ROWS(TA, TB)                                                                  \
  if (p.ta == TA && p.tb == TB) {                                                           \
    gemm_simt_rows<MR, TA, TB><<<grid, ROWS_THREADS, 0, p.stream>>>(                        \
        static_cast<const float*>(p.a), static_cast<const float*>(p.b),                     \
        static_cast<float*>(p.c), p.ws, static_cast<const float*>(p.bias), p.act, p.m, p.n, \
        p.k, p.batch, (int)p.lda, (int)p.ldb, p.sa, p.sb, p.kps, vec);                      \
    return cudaGetLastError();                                                              \
  }
  REPRO_ROWS(0, 0)
  REPRO_ROWS(0, 1)
  REPRO_ROWS(1, 0)
  REPRO_ROWS(1, 1)
#undef REPRO_ROWS
  return cudaErrorInvalidValue;
}

// The elements (4, 2 or 1) of the widest cp.async granule (16, 8 or 4
// bytes) that an fp32 operand's base, leading dimension and batch stride
// all divide; -1 for a base that is not 4-byte aligned
// (kernels/matmul.py:simt_granules holds the same rule).
static int simt_granule(const void* p, long long ld, long long stride) {
  const uintptr_t v = reinterpret_cast<uintptr_t>(p);
  for (int g = 16; g >= 4; g /= 2)
    if (v % g == 0 && (ld * 4) % g == 0 && (stride * 4) % g == 0) return g / 4;
  return -1;
}

template <int EA, int EB>
static cudaError_t launch_simt_kernel(const Problem& p, dim3 grid) {
  const bool epi = p.splits == 1 && (p.bias != nullptr || p.act != ACT_NONE);
  auto kernel = epi ? gemm_simt<EA, EB, true> : gemm_simt<EA, EB, false>;
  static std::atomic<int> granted[2][MAX_DEVICES];
  cudaError_t err = opt_in(kernel, SIMT_SMEM, granted[epi]);
  if (err != cudaSuccess) return err;
  kernel<<<grid, SIMT_THREADS, SIMT_SMEM, p.stream>>>(
      static_cast<const float*>(p.a), static_cast<const float*>(p.b), static_cast<float*>(p.c),
      p.ws, static_cast<const float*>(p.bias), p.act, p.m, p.n, p.k, p.batch, p.lda, p.ldb, p.sa,
      p.sb, p.kps);
  return cudaGetLastError();
}

// B's granule (0: transposed on its way in) as a template argument.
template <int EA>
static cudaError_t launch_simt_b(const Problem& p, dim3 grid, int eb) {
  switch (eb) {
    case 0: return launch_simt_kernel<EA, 0>(p, grid);
    case 1: return launch_simt_kernel<EA, 1>(p, grid);
    case 2: return launch_simt_kernel<EA, 2>(p, grid);
    case 4: return launch_simt_kernel<EA, 4>(p, grid);
    default: return cudaErrorInvalidValue;
  }
}

#ifdef GEMM_SPLIT
// Each layout's tensor-core and decode kernels and each A granule's
// register-tile kernels are compiled in translation units of their own
// (csrc/gemm_part.cu, one nvcc each, started with the library's main one)
// and linked into the same library: together they are most of a gemm
// library's compile time.
#define GEMM_PART_TC(TA, TB) \
  __attribute__((visibility("hidden"))) cudaError_t launch_tc_l##TA##TB(const Problem& p);
#define GEMM_PART_SIMT(EA)                                                                     \
  __attribute__((visibility("hidden"))) cudaError_t launch_simt_ea##EA(const Problem& p,       \
                                                                     dim3 grid, int eb);
GEMM_PART_TC(0, 0) GEMM_PART_TC(0, 1) GEMM_PART_TC(1, 0) GEMM_PART_TC(1, 1)
GEMM_PART_SIMT(0) GEMM_PART_SIMT(1) GEMM_PART_SIMT(2) GEMM_PART_SIMT(4)
#undef GEMM_PART_TC
#undef GEMM_PART_SIMT
#define GEMM_TC_LAYOUT(TA, TB) launch_tc_l##TA##TB
#define GEMM_SIMT_B(EA) launch_simt_ea##EA
#else
#define GEMM_TC_LAYOUT(TA, TB) launch_tc_layout<TA != 0, TB != 0>
#define GEMM_SIMT_B(EA) launch_simt_b<EA>
#endif

// A template so that a library that never takes the route (rmsnorm_matmul)
// does not compile its kernels.
template <typename P>
static cudaError_t launch_simt(const P& p) {
  const dim3 grid((p.n + SIMT_BN - 1) / SIMT_BN, (p.m + SIMT_BM - 1) / SIMT_BM,
                  p.batch * p.splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  // an operand copied as it is stored (A transposed, B row-major) takes the
  // granule its layout allows; one stored along k is transposed on its way
  // in (granule 0)
  const int ea = p.ta ? simt_granule(p.a, p.lda, p.sa) : 0;
  const int eb = p.tb ? 0 : simt_granule(p.b, p.ldb, p.sb);
  if (ea < 0 || eb < 0) return cudaErrorInvalidValue;
  switch (ea) {
    case 0: return GEMM_SIMT_B(0)(p, grid, eb);
    case 1: return GEMM_SIMT_B(1)(p, grid, eb);
    case 2: return GEMM_SIMT_B(2)(p, grid, eb);
    case 4: return GEMM_SIMT_B(4)(p, grid, eb);
    default: return cudaErrorInvalidValue;
  }
}

template <int FM>
static cudaError_t launch_loop(const Problem& p) {
  const int threads = 32 * (p.bm / (16 * FM)) * (p.bn / 32);
  const int smem = loop_smem_bytes(p.dtype, p.bm, p.bn, p.bk);
  const dim3 grid((p.n + p.bn - 1) / p.bn, (p.m + p.bm - 1) / p.bm, p.batch * p.splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const bool aligned = (reinterpret_cast<uintptr_t>(p.a) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(p.b) % 16 == 0);
  const int V = p.dtype == REPRO_BF16 ? 8 : 4;
  const bool vec = aligned && p.lda % V == 0 && p.ldb % V == 0 && p.sa % V == 0 &&
                   p.sb % V == 0;
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_LOOP(TA, TB)                                                                   \
  if (p.ta == TA && p.tb == TB) {                                                            \
    if (p.dtype == REPRO_BF16) {                                                             \
      if ((err = allow_smem(gemm_wmma<FM, TA, TB>, smem))) return err;                       \
      gemm_wmma<FM, TA, TB><<<grid, threads, smem, p.stream>>>(                              \
          static_cast<const bf16*>(p.a), static_cast<const bf16*>(p.b),                      \
          static_cast<bf16*>(p.c), static_cast<const bf16*>(p.bias), p.act, p.m, p.n, p.k,    \
          (int)p.lda, (int)p.ldb, p.sa, p.sb, p.bm, p.bn, p.bk, vec);                        \
    } else {                                                                                 \
      if ((err = allow_smem(gemm_simt_loop<FM, TA, TB>, smem))) return err;                  \
      gemm_simt_loop<FM, TA, TB><<<grid, threads, smem, p.stream>>>(                         \
          static_cast<const float*>(p.a), static_cast<const float*>(p.b),                    \
          static_cast<float*>(p.c), p.ws, static_cast<const float*>(p.bias), p.act, p.m, p.n, \
          p.k, p.batch, (int)p.lda, (int)p.ldb, p.sa, p.sb, p.bm, p.bn, p.bk, p.kps, vec);     \
    }                                                                                        \
    return cudaGetLastError();                                                               \
  }
  REPRO_LOOP(0, 0)
  REPRO_LOOP(0, 1)
  REPRO_LOOP(1, 0)
  REPRO_LOOP(1, 1)
#undef REPRO_LOOP
  return err;
}

static bool tma_aligned(const void* p, long long ld, long long stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * 2) % 16 == 0 && (stride * 2) % 16 == 0;
}

// C[z] = A[z] @ B[z] for z < batch on the route and tiles the caller chose,
// then (splits > 1) the sum of the splits. Returns cudaGetLastError() after
// the launches, cudaErrorInvalidValue for a launch the route cannot take.
// NORM: with the norm prologue (p.norm_scale, p.eps), on the tc and decode
// routes only, for one product whose A and B are row-major.
template <bool NORM = false>
static int launch(const Problem& p) {
  if (p.batch <= 0 || p.m <= 0 || p.n <= 0) return cudaSuccess;
  if (p.k < 0 || p.lda < (p.ta ? p.m : p.k) || p.ldb < (p.tb ? p.k : p.n) || p.sa < 0 ||
      p.sb < 0 || p.splits < 1 || p.kps < 1 || p.batch * p.splits > 65535 ||
      p.act < ACT_NONE || p.act > ACT_SILU)
    return cudaErrorInvalidValue;
  const int slices = (p.k + p.bk - 1) / p.bk;
  // every split a non-empty range of whole slices (kernels/matmul.py:split_k)
  if (p.splits > 1 && (p.ws == nullptr || (slices + p.kps - 1) / p.kps != p.splits))
    return cudaErrorInvalidValue;
  const bool bf = p.dtype == REPRO_BF16;
  cudaError_t err;
  if (p.route == GEMM_TC || p.route == GEMM_DECODE) {
    const bool tc = p.route == GEMM_TC;
    if (!bf || p.k == 0 || p.stages < 2 || p.stages > MAX_STAGES ||
        (tc ? p.bm != 64 && p.bm != 128 : p.bm != DEC_ROWS) ||
        !tma_aligned(p.a, p.lda, p.sa) || !tma_aligned(p.b, p.ldb, p.sb) ||
        (NORM ? (tc ? smem_bytes(p.route, p.dtype, p.bm, p.bn, p.bk, p.stages) +
                          norm_smem(p.bk, p.stages)
                    : decode_norm_smem(p.bn, p.bk, p.stages))
              : smem_bytes(p.route, p.dtype, p.bm, p.bn, p.bk, p.stages)) > 232448)
      return cudaErrorInvalidValue;
    if constexpr (NORM) {
      // the scale is a TMA operand too: a 16-byte aligned base
      if (p.ta || p.tb || p.batch != 1 || p.k % 8 != 0 || !tma_aligned(p.norm_scale, 0, 0))
        return cudaErrorInvalidValue;
      err = launch_tc_layout<false, false, true>(p);
    } else if (p.ta) {
      err = p.tb ? GEMM_TC_LAYOUT(1, 1)(p) : GEMM_TC_LAYOUT(1, 0)(p);
    } else {
      err = p.tb ? GEMM_TC_LAYOUT(0, 1)(p) : GEMM_TC_LAYOUT(0, 0)(p);
    }
  } else if constexpr (NORM) {     // the prologue exists on the tensor-core routes only
    return cudaErrorInvalidValue;
  } else {
    switch (p.route) {
      case GEMM_ROWS:                 // fp32 decode rows: ROWS_COLS columns a CTA
        if (bf || p.m > DEC_ROWS || p.bn != ROWS_COLS || p.bk != ROWS_KC || p.lda > INT32_MAX ||
            p.ldb > INT32_MAX)
          return cudaErrorInvalidValue;
        err = p.m <= 8 ? launch_rows<8>(p) : launch_rows<DEC_ROWS>(p);
        break;
      case GEMM_SIMT:                 // fp32, more than 16 rows: register tiles
        if (bf || p.bm != SIMT_BM || p.bn != SIMT_BN || p.bk != SIMT_BK || p.stages != SIMT_STAGES)
          return cudaErrorInvalidValue;
        err = launch_simt(p);
        break;
      case GEMM_WMMA:
      case GEMM_LOOP: {               // the first port's tile loops: bf16 WMMA, fp32 SIMT
        if ((p.route == GEMM_WMMA) != bf || (bf && p.splits > 1) || !pow2(p.bm) || p.bm < 16 ||
            !pow2(p.bn) || p.bn < 32 || !pow2(p.bk) || p.bk < 16 ||
            32 * (p.bm / (16 * (p.bm == 16 ? 1 : 2))) * (p.bn / 32) > 512 ||
            loop_smem_bytes(p.dtype, p.bm, p.bn, p.bk) > 232448 || p.lda > INT32_MAX ||
            p.ldb > INT32_MAX)
          return cudaErrorInvalidValue;
        err = p.bm == 16 ? launch_loop<1>(p) : launch_loop<2>(p);
        break;
      }
      default:
        return cudaErrorInvalidValue;
    }
  }
  // fp32 out (no C): the raw partials stay in the workspace for the caller
  if (err != cudaSuccess || p.splits == 1 || p.c == nullptr) return err;
  const long long count = (long long)p.batch * p.m * p.n;
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  if (bf)
    gemm_splitk_sum<bf16><<<blocks, 256, 0, p.stream>>>(
        p.ws, static_cast<bf16*>(p.c), static_cast<const bf16*>(p.bias), p.act, count, p.n,
        p.splits);
  else
    gemm_splitk_sum<float><<<blocks, 256, 0, p.stream>>>(
        p.ws, static_cast<float*>(p.c), static_cast<const float*>(p.bias), p.act, count, p.n,
        p.splits);
  return cudaGetLastError();
}

}  // namespace gemm

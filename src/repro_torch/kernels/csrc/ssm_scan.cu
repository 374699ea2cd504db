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
// ssm_scan_pallas). Time is sequential inside a channel; the parallelism is
// across (batch, channel, state).
//
// What bounds it on an H100. At prefill (b = 1, s = 2048, d_inner = 16384,
// d_state = 16) it moves about 0.34 GB (0.10 ms at 3.35 TB/s) and takes 537 M
// exponentials, 0.13 ms on the SFUs at 16 a clock an SM: the exponentials
// bound it. Each is one ex2.approx of dt * (A * log2 e); a state element
// costs four fp32 instructions beside it (dt * A, the state's multiply-add,
// dt * x * B, y's multiply-add), and a step's shared loads, y's sum and the
// addresses come on top. An SM's four schedulers start one instruction a
// clock each, so at four states a thread their slots run out about when
// the SFUs do: the kernel needs enough warps to cover each step's
// chain, no warp waiting on device memory, and few instructions a step.
//
// The design (the first port took 0.70 ms there on an H100 SXM: one thread a
// channel, 4 warps an SM, each slice staged by the threads that compute
// it behind two barriers):
//
// * Warp specialisation with a ring. A CTA owns block_d channels of one
//   batch row. Its last warp is a producer that fills a ring of `stages`
//   slices in shared memory, each `chunk` steps of the CTA's xc and dt
//   ([chunk][block_d], xc in its own dtype) and of B_t and C_t
//   ([chunk][d_state]), and signals a full mbarrier a slice; the consumer
//   warps only compute, and free a slice on its empty mbarrier. Two
//   loaders, picked by a rule on the host (kernels/ssm_scan.py:loader),
//   never by a fallback. TMA: one thread sends four 3-D boxes a slice,
//   when every base, the rows of xc and dt and d_state * 4 are 16-byte
//   multiples. cp.async: all 32 producer lanes copy xc in the widest
//   granule (16, 8 or 4 bytes) its alignment allows, or element by element
//   for bf16 rows that are only 2-byte aligned (an odd d_inner); dt, B and
//   C go by TMA where their rows allow it, by cp.async where not. The
//   d_inner = 16380 row of a ragged prefill (bf16 rows of 32,760 bytes)
//   takes the cp.async loader: xc in 8-byte granules, dt, B and C by TMA.
// * More warps an SM. `lanes` (1, 2 or 4) threads share a channel, each
//   holding 16 / lanes of its states and of its row of A (pre-scaled by
//   log2 e) in registers for the whole sequence. At lanes = 4 and b = 1,
//   d_inner 16384 that is 16 consumer warps an SM instead of 4, with the
//   same exponentials. B_t and C_t are read as 16-byte shared loads of the
//   lane's states.
// * Few instructions a step. A turn of `lanes` steps has no branch, so
//   their loads and exponentials overlap (the slice's last turn, shorter,
//   is guarded apart); their partial y are summed over the channel's lanes
//   by a reduce-scatter of shuffles in a fixed order (three shuffles for
//   four steps' y, not eight), which leaves each lane one step's y to
//   store.
// * Unchanged from the first port: no chunked two-pass scan (it would take
//   exp(A * cumsum dt) again for every step, doubling the exponentials that
//   bound the kernel); the fp32 state; the scan stops at s (the TPU kernel
//   zero-pads the ragged tail: dt = 0 => an identity step), so the state it
//   returns is h at step s-1 for any s; d_inner need not divide into
//   block_d; d_state a compile-time 16 unrolls unguarded (a runtime d_state
//   up to 16 is guarded).
//
// ssm_update replaces repro/kernels/ssm_scan.py:_ssm_update_kernel (driven
// by ssm_update_pallas): one decode step, the state read once and written
// once. Bound by its bytes: at b = 8, d_inner = 16384 about 17 MB, 0.005 ms
// at 3.35 TB/s, and in the engine the state is cold in L2 (a whole decode
// step runs between two updates of a layer). The first port gave a thread
// a (row, channel) and walked the channel's 64-byte state row in four
// float4s, so at one j a warp's accesses were 64 bytes apart and each
// request touched 32 segments. Here `lanes` threads share a channel, lane
// `sub` holding the float4s sub, sub + lanes, ... of its row: at lanes = 4
// one float4 each, so a warp's state loads and stores are contiguous
// 16-byte accesses. A CTA covers block_d channels and block_b rows; each
// thread keeps its A float4s (pre-scaled by log2 e) in registers across
// the rows and issues the state loads of 2 x `lanes` rows before it computes
// any. B_t and C_t are broadcast loads; y is summed over the channel's
// lanes by shuffles in a fixed order. h_new is computed element by element
// as before, so its bits do not change.
#include <string.h>

#include "hopper.cuh"

#define SSM_MAX_STATE 16
#define SCAN_MAX_CONSUMERS 512
#define LOG2E_F 1.4426950408889634f

enum { LOADER_CPASYNC = 0, LOADER_TMA = 1 };
// The tensors a launch loads by TMA (the rest by the producer's cp.async).
enum { TMA_X = 1, TMA_DT = 2, TMA_BC = 4, TMA_ALL = 7 };

// 2^x in one SFU instruction (relative error about 2^-22).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The scan's shared memory: a stage holds xc, dt, B and C of one slice,
// each region 128-byte aligned (TMA's destination alignment); the ring's
// full and empty mbarriers follow the stages.
__host__ __device__ __forceinline__ int align128(int v) { return (v + 127) & ~127; }

struct Ring {
  int xb, db, bb, stage;
  __host__ __device__ Ring(int chunk, int block_d, int ds, int es)
      : xb(align128(chunk * block_d * es)), db(align128(chunk * block_d * 4)),
        bb(align128(chunk * ds * 4)), stage(xb + db + 2 * bb) {}
};

// The ring's bytes and 128 of alignment slack (mirrored by
// kernels/ssm_scan.py:scan_smem_bytes).
extern "C" int repro_ssm_scan_smem_bytes(int chunk, int block_d, int ds, int itemsize,
                                         int stages) {
  return 128 + stages * (Ring(chunk, block_d, ds, itemsize).stage + 16);
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int g) {
  if (g == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  else if (g == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// Arrive on `bar` once this thread's earlier cp.asyncs have landed (the
// barrier's count includes this arrival).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, unsigned short v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

// Stage n rows of w bytes (row r at src + r * pitch) at dst + r * dpitch in
// shared memory, over the producer warp's lanes: cp.async in granules of g
// bytes (16, 8 or 4: every row start and w are multiples of g), or for
// g == 2 (bf16 rows that are only 2-byte aligned) loads and stores of one
// element, four in flight a lane. Lanes split into groups of the power of
// two at least a row's granules (at most 32), one row a group.
__device__ __forceinline__ void stage_rows(uint32_t dst, int dpitch, const char* src,
                                           size_t pitch, int n, int w, int g, int lane) {
  const int per = w / g;
  if (per <= 0) return;
  int lg = 0;
  while ((1 << lg) < per && lg < 5) ++lg;
  const int lp = 1 << lg, rp = 32 >> lg;
  const int r0 = lane >> lg, k0 = lane & (lp - 1);
  if (g >= 4) {
    for (int r = r0; r < n; r += rp)
      for (int k = k0; k < per; k += lp)
        cp_async(dst + r * dpitch + k * g, src + r * pitch + (size_t)k * g, g);
  } else {
    for (int r = r0; r < n; r += rp) {
      const unsigned short* row = reinterpret_cast<const unsigned short*>(src + r * pitch);
      for (int k = k0; k < per; k += 4 * lp) {
        unsigned short v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = k + q * lp < per ? __ldg(row + k + q * lp) : 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k + q * lp < per) st_shared_u16(dst + r * dpitch + (k + q * lp) * 2, v[q]);
      }
    }
  }
}

// DS > 0: d_state is DS, known to the compiler, so the state loop unrolls
// with no guard and B_t / C_t are read as 16-byte vectors; DS == 0: any
// d_state up to SSM_MAX_STATE, each state guarded. L: the lanes of a
// channel, each holding P = 16 / L of its states. `tma`: the TMA_* tensors
// the producer's lane 0 loads by TMA; the producer warp copies the others
// with cp.async in granules of gx, gdt and gbc bytes.
template <typename T, int DS, int L>
__global__ void __launch_bounds__(SCAN_MAX_CONSUMERS + 32)
ssm_scan_ws(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_dt,
            const __grid_constant__ CUtensorMap tm_b, const __grid_constant__ CUtensorMap tm_c,
            const T* __restrict__ xc, const float* __restrict__ dt,
            const float* __restrict__ Bm, const float* __restrict__ Cm,
            const float* __restrict__ A, const float* __restrict__ h0,
            float* __restrict__ y, float* __restrict__ hn, int s, int di, int ds_arg,
            int chunk, int stages, int tma, int gx, int gdt, int gbc) {
  constexpr int P = SSM_MAX_STATE / L;
  const int ds = DS > 0 ? DS : ds_arg;
  const int consumers = blockDim.x - 32, block_d = consumers / L, cw = consumers / 32;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  const Ring R(chunk, block_d, ds, (int)sizeof(T));
  const uint32_t bars = base + stages * R.stage;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (stages + st); };

  const int bi = blockIdx.y, c0 = blockIdx.x * block_d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nsl = (s + chunk - 1) / chunk;
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      // one arrival with the slice's TMA bytes, and where the producer
      // copies, each lane's cp.asyncs and its own element stores
      sm90::mbar_init(full(st), (tma ? 1 : 0) + (tma != TMA_ALL ? 64 : 0));
      sm90::mbar_init(empty(st), cw);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == cw) {                                      // the producer
    const int es = (int)sizeof(T), w = min(block_d, di - c0);
    const uint32_t tx = (tma & TMA_X ? chunk * block_d * es : 0) +
                        (tma & TMA_DT ? chunk * block_d * 4 : 0) +
                        (tma & TMA_BC ? 2 * chunk * ds * 4 : 0);
    const bool copies = tma != TMA_ALL;
    if (!copies && lane != 0) return;                    // TMA alone: one thread sends it
    for (int k = 0; k < nsl; ++k) {
      const int st = k % stages, t0 = k * chunk, n = min(chunk, s - t0);
      sm90::mbar_wait(empty(st), ((k / stages) & 1) ^ 1);
      const uint32_t sb = base + st * R.stage;
      if (lane == 0 && tma) {
        sm90::mbar_expect_tx(full(st), tx);
        if (tma & TMA_X) sm90::tma_load_3d(sb, &tm_x, c0, t0, bi, full(st));
        if (tma & TMA_DT) sm90::tma_load_3d(sb + R.xb, &tm_dt, c0, t0, bi, full(st));
        if (tma & TMA_BC) {
          sm90::tma_load_3d(sb + R.xb + R.db, &tm_b, 0, t0, bi, full(st));
          sm90::tma_load_3d(sb + R.xb + R.db + R.bb, &tm_c, 0, t0, bi, full(st));
        }
      }
      if (copies) {
        const size_t row = (size_t)bi * s + t0;
        if (!(tma & TMA_X))
          stage_rows(sb, block_d * es, reinterpret_cast<const char*>(xc + row * di + c0),
                     (size_t)di * es, n, w * es, gx, lane);
        if (!(tma & TMA_DT))
          stage_rows(sb + R.xb, block_d * 4, reinterpret_cast<const char*>(dt + row * di + c0),
                     (size_t)di * 4, n, w * 4, gdt, lane);
        if (!(tma & TMA_BC)) {
          stage_rows(sb + R.xb + R.db, 0, reinterpret_cast<const char*>(Bm + row * ds), 0, 1,
                     n * ds * 4, gbc, lane);
          stage_rows(sb + R.xb + R.db + R.bb, 0, reinterpret_cast<const char*>(Cm + row * ds),
                     0, 1, n * ds * 4, gbc, lane);
        }
        cp_async_arrive(full(st));
        sm90::mbar_arrive(full(st));
      }
    }
    if (copies) asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers: thread (ch, sub) holds states [sub * P, sub * P + P) of
  // channel c0 + ch
  const int ch = threadIdx.x / L, sub = threadIdx.x % L;
  const int d = c0 + ch;
  const bool live = d < di;
  float h[P], a2[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int jg = sub * P + j;
    const bool on = live && jg < ds;
    h[j] = on ? h0[((size_t)bi * di + d) * ds + jg] : 0.f;
    a2[j] = on ? A[(size_t)d * ds + jg] * LOG2E_F : 0.f;
  }
  float* yp = y + (size_t)bi * s * di + d;

  for (int k = 0; k < nsl; ++k) {
    const int st = k % stages, t0 = k * chunk, n = min(chunk, s - t0);
    sm90::mbar_wait(full(st), (k / stages) & 1);
    const uint8_t* sp = smem_raw + (base - raw) + st * R.stage;
    const T* xs = reinterpret_cast<const T*>(sp);
    const float* dts = reinterpret_cast<const float*>(sp + R.xb);
    const float* bs = reinterpret_cast<const float*>(sp + R.xb + R.db);
    const float* cs = reinterpret_cast<const float*>(sp + R.xb + R.db + R.bb);
    // one step of the slice from its values' shared-memory addresses: the
    // lane's states advance, and its partial y
    auto step = [&](const float* dtr, const T* xr, const float* br, const float* cr) {
      const float dtv = *dtr;
      const float dbx = dtv * to_f32(*xr);
      float bv[P], cv[P];
      if (DS > 0) {
#pragma unroll
        for (int q = 0; q < P / 4; ++q) {
          const float4 vb = reinterpret_cast<const float4*>(br)[q];
          const float4 vc = reinterpret_cast<const float4*>(cr)[q];
          bv[4 * q] = vb.x; bv[4 * q + 1] = vb.y; bv[4 * q + 2] = vb.z; bv[4 * q + 3] = vb.w;
          cv[4 * q] = vc.x; cv[4 * q + 1] = vc.y; cv[4 * q + 2] = vc.z; cv[4 * q + 3] = vc.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const bool on = sub * P + j < ds;
          bv[j] = on ? br[j] : 0.f;
          cv[j] = on ? cr[j] : 0.f;
        }
      }
      // two partial sums of the lane's states, in a fixed order
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        h[j] = fmaf(ex2_approx(dtv * a2[j]), h[j], dbx * bv[j]);
        if (j % 2 == 0)
          acc0 = fmaf(h[j], cv[j], acc0);
        else
          acc1 = fmaf(h[j], cv[j], acc1);
      }
      return acc0 + acc1;
    };
    // L steps a turn, with no branch between them so that their loads and
    // exponentials overlap; their y are summed over each channel's lanes by
    // a reduce-scatter (three shuffles for four steps' y, not eight), which
    // leaves lane `sub` step tt + sub's y to store
    auto scatter = [&](const float (&acc)[L]) {
      float yv = acc[0];
      if constexpr (L == 2) {
        const bool b0 = sub & 1;
        yv = (b0 ? acc[1] : acc[0]) + __shfl_xor_sync(0xffffffffu, b0 ? acc[0] : acc[1], 1);
      } else if constexpr (L == 4) {
        const bool b1 = sub & 2, b0 = sub & 1;
        const float k0 =
            (b1 ? acc[2] : acc[0]) + __shfl_xor_sync(0xffffffffu, b1 ? acc[0] : acc[2], 2);
        const float k1 =
            (b1 ? acc[3] : acc[1]) + __shfl_xor_sync(0xffffffffu, b1 ? acc[1] : acc[3], 2);
        yv = (b0 ? k1 : k0) + __shfl_xor_sync(0xffffffffu, b0 ? k0 : k1, 1);
      }
      return yv;
    };
    // the turn's addresses advance by L rows; a row's are block_d and ds
    // apart
    const float* dtr = dts + ch;
    const T* xr = xs + ch;
    const float* br = bs + sub * P;
    const float* cr = cs + sub * P;
    int tt = 0;
#pragma unroll 2
    for (; tt + L <= n; tt += L) {
      float acc[L];
#pragma unroll
      for (int u = 0; u < L; ++u)
        acc[u] = step(dtr + u * block_d, xr + u * block_d, br + u * ds, cr + u * ds);
      const float yv = scatter(acc);
      if (live) yp[(size_t)(t0 + tt + sub) * di] = yv;
      dtr += L * block_d;
      xr += L * block_d;
      br += L * ds;
      cr += L * ds;
    }
    if (L > 1 && tt < n) {          // the last slice's tail: fewer than L steps (uniform)
      float acc[L];
#pragma unroll
      for (int u = 0; u < L; ++u)
        acc[u] = tt + u < n ? step(dtr + u * block_d, xr + u * block_d, br + u * ds,
                                  cr + u * ds)
                           : 0.f;
      const float yv = scatter(acc);
      if (live && tt + sub < n) yp[(size_t)(t0 + tt + sub) * di] = yv;
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty(st));
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (sub * P + j < ds) hn[((size_t)bi * di + d) * ds + sub * P + j] = h[j];
  }
}

// The states j .. j + 3 of a row at p: one 16-byte load when `vec` (ds a
// multiple of 4, every base 16-byte aligned), else element loads; zero past
// ds.
__device__ __forceinline__ float4 states4(const float* __restrict__ p, int j, int ds, bool vec) {
  if (j >= ds) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) return *reinterpret_cast<const float4*>(p + j);
  return make_float4(p[j], j + 1 < ds ? p[j + 1] : 0.f, j + 2 < ds ? p[j + 2] : 0.f,
                     j + 3 < ds ? p[j + 3] : 0.f);
}

__device__ __forceinline__ void store_states4(float* __restrict__ p, int j, int ds, bool vec,
                                              float4 v) {
  if (j >= ds) return;
  if (vec) {
    *reinterpret_cast<float4*>(p + j) = v;
    return;
  }
  p[j] = v.x;
  if (j + 1 < ds) p[j + 1] = v.y;
  if (j + 2 < ds) p[j + 2] = v.z;
  if (j + 3 < ds) p[j + 3] = v.w;
}

// L lanes a channel; lane `sub` holds the float4s q = sub + L t (t < Q) of
// its channel's states. The rows go U = 2 L at a time (eight float4s of
// state a thread): their loads first, then each row's update, its y summed
// over the lanes (xor 1, then 2) and stored by lane 0. Every thread of the CTA runs the row loop, live or not, so the
// shuffles see whole warps.
template <typename T, int L>
__global__ void __launch_bounds__(1024)
ssm_update_kernel(const T* __restrict__ xc, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ h,
                  float* __restrict__ y, float* __restrict__ hn, int b, int di, int ds,
                  int block_b, bool vec) {
  constexpr int Q = SSM_MAX_STATE / 4 / L, U = 2 * L;
  const int ch = threadIdx.x / L, sub = threadIdx.x % L;
  const int d = blockIdx.x * (blockDim.x / L) + ch;
  const bool live = d < di;
  const int r_begin = blockIdx.y * block_b, r_end = min(b, r_begin + block_b);
  float4 a2[Q];
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    const float4 av = live ? states4(A + (size_t)d * ds, 4 * (sub + L * t), ds, vec)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    a2[t] = make_float4(av.x * LOG2E_F, av.y * LOG2E_F, av.z * LOG2E_F, av.w * LOG2E_F);
  }
  for (int r0 = r_begin; r0 < r_end; r0 += U) {
    float4 hv[U][Q];
    float dtv[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool on = live && r0 + u < r_end;
      const size_t i = (size_t)(r0 + u) * di + d;
      dtv[u] = on ? dt[i] : 0.f;
      xv[u] = on ? to_f32(xc[i]) : 0.f;
#pragma unroll
      for (int t = 0; t < Q; ++t)
        hv[u][t] = on ? states4(h + i * ds, 4 * (sub + L * t), ds, vec)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u;
      const bool row = r < r_end, on = live && row;
      const size_t i = (size_t)r * di + d;
      const float dbx = dtv[u] * xv[u];
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < Q; ++t) {
        const int j = 4 * (sub + L * t);
        const float4 bv = row ? states4(Bm + (size_t)r * ds, j, ds, vec)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 cv = row ? states4(Cm + (size_t)r * ds, j, ds, vec)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 hh = hv[u][t];
        float4 o;
        o.x = fmaf(ex2_approx(dtv[u] * a2[t].x), hh.x, dbx * bv.x);
        o.y = fmaf(ex2_approx(dtv[u] * a2[t].y), hh.y, dbx * bv.y);
        o.z = fmaf(ex2_approx(dtv[u] * a2[t].z), hh.z, dbx * bv.z);
        o.w = fmaf(ex2_approx(dtv[u] * a2[t].w), hh.w, dbx * bv.w);
        if (on) store_states4(hn + i * ds, j, ds, vec, o);
        acc = fmaf(o.x, cv.x, acc);
        acc = fmaf(o.y, cv.y, acc);
        acc = fmaf(o.z, cv.z, acc);
        acc = fmaf(o.w, cv.w, acc);
      }
#pragma unroll
      for (int off = 1; off < L; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (on && sub == 0) y[i] = acc;
    }
  }
}

struct ScanArgs {
  CUtensorMap maps[4];
  const void* xc;
  const float *dt, *B, *C, *A, *h0;
  float *y, *hn;
  int s, di, ds, chunk, stages, tma, gx, gdt, gbc;
  dim3 grid;
  int threads, smem;
  cudaStream_t stream;
  int* ctas_per_sm;          // not null: report occupancy instead of launching
};

template <typename T, int DS, int L>
static cudaError_t run(const ScanArgs& a) {
  auto k = ssm_scan_ws<T, DS, L>;
  cudaError_t err = allow_smem(k, a.smem);
  if (err != cudaSuccess) return err;
  if (a.ctas_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.ctas_per_sm, k, a.threads, a.smem);
  k<<<a.grid, a.threads, a.smem, a.stream>>>(a.maps[0], a.maps[1], a.maps[2], a.maps[3],
                                             static_cast<const T*>(a.xc), a.dt, a.B, a.C, a.A,
                                             a.h0, a.y, a.hn, a.s, a.di, a.ds, a.chunk, a.stages,
                                             a.tma, a.gx, a.gdt, a.gbc);
  return cudaGetLastError();
}

template <typename T, int DS>
static cudaError_t by_lanes(const ScanArgs& a, int lanes) {
  switch (lanes) {
    case 1: return run<T, DS, 1>(a);
    case 2: return run<T, DS, 2>(a);
    case 4: return run<T, DS, 4>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
static cudaError_t by_state(const ScanArgs& a, int lanes) {
  return a.ds == SSM_MAX_STATE ? by_lanes<T, SSM_MAX_STATE>(a, lanes) : by_lanes<T, 0>(a, lanes);
}

// The widest cp.async granule (16, 8 or 4 bytes) that a base, a row pitch
// and a row width in bytes all divide; 2 when only elements do (bf16).
static int granule(const void* p, long long pitch, long long w) {
  const uintptr_t v = reinterpret_cast<uintptr_t>(p);
  int g = 16;
  while (g > 2 && (v % g || pitch % g || w % g)) g /= 2;
  return g;
}

static bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Everything a launch needs but its pointers, checked; the loader's own
// checks need the pointers and are made by repro_ssm_scan.
static cudaError_t scan_geometry(ScanArgs& a, int dtype, int ds, int chunk, int block_d,
                                 int stages, int lanes) {
  if (dtype != REPRO_F32 && dtype != REPRO_BF16) return cudaErrorInvalidValue;
  if ((lanes != 1 && lanes != 2 && lanes != 4) || block_d < 16 || block_d > 256 ||
      block_d * lanes < 32 || block_d * lanes > SCAN_MAX_CONSUMERS || (block_d * lanes) % 32 ||
      chunk < 1 || chunk > 256 || stages < 1 || ds < 1 || ds > SSM_MAX_STATE)
    return cudaErrorInvalidValue;
  a.ds = ds;
  a.chunk = chunk;
  a.stages = stages;
  a.threads = block_d * lanes + 32;
  a.smem = repro_ssm_scan_smem_bytes(chunk, block_d, ds, dtype == REPRO_BF16 ? 2 : 4, stages);
  return cudaSuccess;
}

// CTAs of one config an SM can hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// kernels/ssm_scan.py reports warps an SM from it.
extern "C" int repro_ssm_scan_ctas_per_sm(int dtype, int ds, int chunk, int block_d, int stages,
                                          int lanes, int loader, int* ctas) {
  ScanArgs a;
  memset(&a, 0, sizeof(a));
  cudaError_t err = scan_geometry(a, dtype, ds, chunk, block_d, stages, lanes);
  if (err != cudaSuccess) return err;
  a.ctas_per_sm = ctas;
  a.tma = loader == LOADER_TMA ? TMA_ALL : 0;
  return dtype == REPRO_BF16 ? by_state<__nv_bfloat16>(a, lanes) : by_state<float>(a, lanes);
}

extern "C" int repro_ssm_scan(const void* xc, const float* dt, const float* B, const float* C,
                              const float* A, const float* h0, float* y, float* hn, int b,
                              int s, int di, int ds, int dtype, int chunk, int block_d,
                              int stages, int lanes, int loader, void* stream) {
  ScanArgs a;
  memset(&a, 0, sizeof(a));
  cudaError_t err = scan_geometry(a, dtype, ds, chunk, block_d, stages, lanes);
  if (err != cudaSuccess) return err;
  if (b <= 0 || di <= 0) return cudaSuccess;
  const bool bf16 = dtype == REPRO_BF16;
  const int es = bf16 ? 2 : 4;
  // the rule of kernels/ssm_scan.py:loader, held here too: a TMA box needs a
  // 16-byte aligned base and row pitch
  const bool x16 = aligned16(xc) && ((long long)di * es) % 16 == 0;
  const bool dt16 = aligned16(dt) && ((long long)di * 4) % 16 == 0;
  const bool bc16 = aligned16(B) && aligned16(C) && ds % 4 == 0;
  if (loader == LOADER_TMA) {
    if (!(x16 && dt16 && bc16)) return cudaErrorInvalidValue;
    a.tma = TMA_ALL;
  } else if (loader == LOADER_CPASYNC) {
    // xc by cp.async; dt, B and C by TMA where their rows allow it
    a.tma = (dt16 ? TMA_DT : 0) | (bc16 ? TMA_BC : 0);
    a.gx = granule(xc, (long long)di * es, (long long)block_d * es);
    a.gdt = granule(dt, (long long)di * 4, (long long)block_d * 4);
    a.gbc = granule(B, ds * 4, ds * 4);
    if (granule(C, ds * 4, ds * 4) < a.gbc) a.gbc = granule(C, ds * 4, ds * 4);
    if (a.gx < es || a.gdt < 4 || a.gbc < 4) return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  const long long rows = s > 0 ? s : 1;
  if (((a.tma & TMA_X) && (err = sm90::make_dense_map(&a.maps[0], xc, bf16, di, rows, b, di,
                                                      rows * di, block_d, chunk))) ||
      ((a.tma & TMA_DT) && (err = sm90::make_dense_map(&a.maps[1], dt, false, di, rows, b, di,
                                                       rows * di, block_d, chunk))) ||
      ((a.tma & TMA_BC) && ((err = sm90::make_dense_map(&a.maps[2], B, false, ds, rows, b, ds,
                                                        rows * ds, ds, chunk)) ||
                            (err = sm90::make_dense_map(&a.maps[3], C, false, ds, rows, b, ds,
                                                        rows * ds, ds, chunk)))))
    return err;
  a.xc = xc;
  a.dt = dt;
  a.B = B;
  a.C = C;
  a.A = A;
  a.h0 = h0;
  a.y = y;
  a.hn = hn;
  a.s = s;
  a.di = di;
  a.grid = dim3((di + block_d - 1) / block_d, b);
  a.stream = static_cast<cudaStream_t>(stream);
  return bf16 ? by_state<__nv_bfloat16>(a, lanes) : by_state<float>(a, lanes);
}

template <typename T>
static cudaError_t update_by_lanes(dim3 grid, int threads, cudaStream_t st, int lanes,
                                  const T* xc, const float* dt, const float* B, const float* C,
                                  const float* A, const float* h, float* y, float* hn, int b,
                                  int di, int ds, int block_b, bool vec) {
#define REPRO_UPDATE(L)                                                                     \
  if (lanes == L) {                                                                         \
    ssm_update_kernel<T, L><<<grid, threads, 0, st>>>(xc, dt, B, C, A, h, y, hn, b, di, ds, \
                                                      block_b, vec);                        \
    return cudaGetLastError();                                                              \
  }
  REPRO_UPDATE(1)
  REPRO_UPDATE(2)
  REPRO_UPDATE(4)
#undef REPRO_UPDATE
  return cudaErrorInvalidValue;
}

// One decode step over a (block_d channels x block_b rows) CTA of
// block_d * lanes threads (kernels/ssm_scan.py:SSM_UPDATE_SPACE).
extern "C" int repro_ssm_update(const void* xc, const float* dt, const float* B,
                                const float* C, const float* A, const float* h, float* y,
                                float* hn, int b, int di, int ds, int dtype, int block_b,
                                int block_d, int lanes, void* stream) {
  const int threads = block_d * lanes;
  if ((lanes != 1 && lanes != 2 && lanes != 4) || block_b < 1 || block_d < 1 || threads < 32 ||
      threads > 1024 || threads % 32 || ds < 1 || ds > SSM_MAX_STATE)
    return cudaErrorInvalidValue;
  if (b <= 0 || di <= 0) return cudaSuccess;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C) |
                          reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(h) |
                          reinterpret_cast<uintptr_t>(hn);
  const bool vec = ds % 4 == 0 && bases % 16 == 0;
  const dim3 grid((di + block_d - 1) / block_d, (b + block_b - 1) / block_b);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_BF16)
    return update_by_lanes(grid, threads, st, lanes, static_cast<const __nv_bfloat16*>(xc), dt,
                           B, C, A, h, y, hn, b, di, ds, block_b, vec);
  if (dtype == REPRO_F32)
    return update_by_lanes(grid, threads, st, lanes, static_cast<const float*>(xc), dt, B, C,
                           A, h, y, hn, b, di, ds, block_b, vec);
  return cudaErrorInvalidValue;
}

// Grouped expert gemm out[e,c,n] = x[e,c,k] @ w[e,k,n] for Hopper (sm_90a):
// one product per expert, the MoE expert FFN's three contractions (gate,
// up, down) and their gradients.
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py:_expert_gemm_kernel
// (driven by expert_gemm_pallas). Same function: fp32 accumulation, output
// in x's dtype (out contiguous). The TPU grid is (e, c/bc, n/bn, k/bk) with
// k sequential and a VMEM fp32 accumulator, over operands zero-padded to
// whole blocks. Here the kernels are gemm.cuh's, shared with matmul.cu:
// the expert is a product of the batch (its tensor maps are 3-D,
// [experts][rows][cols], so a tile never reads the next expert's rows and
// the ragged c, k and n edges read zeros), and each operand comes with its
// expert stride and its layout, so the backward's swapaxes views
// (ct @ w^T, x^T @ ct) are read in place and a broadcast operand (stride 0)
// is read through a 2-D map.
//
// Bound: at decode (8 slots, top-2 of 8 experts) the capacity is c = 2:
// each expert's weight is read once for 2 rows, 4 flops a weight element,
// far below the 295 flop a byte at which the H100's tensor cores become
// the limit. The gemm is a weight read, bound by device-memory bytes (the
// gate or up projection of Mixtral-8x7B moves 0.94 GB: 0.28 ms at 3.35
// TB/s): the decode route computes out^T = w^T x^T with 64 weight columns
// as wgmma's M, keeps a deep ring of weight slices in flight per SM, and
// splits k for the down projection, whose 4096 columns in 128-column tiles
// give 8 experts 256 CTAs over k = 14,336. At prefill (c = 640 or 2560) a
// product does 2*c flops a weight element, above that line: bound by the
// tensor cores, which the tc route feeds from a TMA ring.
#include "gemm.cuh"

// out[z] = x[z] @ w[z] for z < e: x[z] [c,k] at x + z*sx elements, w[z]
// [k,n] at w + z*sw, out[z] at out + z*c*n. tx/tw: the operand is stored
// transposed (column-major) with leading dimension ldx/ldw; ws: the fp32
// [splits, e, c, n] workspace when splits > 1, each split kps k slices.
extern "C" int repro_expert_gemm(const void* x, const void* w, void* out, void* ws, int e,
                                 int c, int n, int k, int tx, int tw, long long ldx,
                                 long long ldw, long long sx, long long sw, int dtype, int route,
                                 int bc, int bn, int bk, int stages, int splits, int kps,
                                 void* stream) {
  const gemm::Problem p{x,      w,      out,    static_cast<float*>(ws),
                        e,      c,      n,      k,
                        tx,     tw,     ldx,    ldw,
                        sx,     sw,     dtype,  route,
                        bc,     bn,     bk,     stages,
                        splits, kps,    static_cast<cudaStream_t>(stream)};
  return gemm::launch(p);
}

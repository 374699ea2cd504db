// Grouped expert gemm out[e,c,n] = x[e,c,k] @ w[e,k,n] for Hopper (sm_90a):
// one product per expert, the MoE expert FFN's three contractions (gate,
// up, down) and their gradients.
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py:_expert_gemm_kernel
// (driven by expert_gemm_pallas). Same function: fp32 accumulation, output
// in x's dtype (out contiguous). The TPU grid is (e, c/bc, n/bn, k/bk) with
// k sequential and a VMEM fp32 accumulator, over operands zero-padded to
// whole blocks. Here each CTA owns one (expert, c tile, n tile), the expert
// on blockIdx.z, and loops over k inside the block with the fp32
// accumulator in registers (gemm.cuh, shared with matmul.cu); the ragged c,
// k and n edges are masked when a slice is staged, so nothing is padded in
// device memory. Each operand comes with its expert stride and its layout
// (row-major, or transposed with its own leading dimension), so the
// backward's swapaxes views (ct @ w^T, x^T @ ct) are read in place.
//
// Bound: at decode (8 slots, top-2 of 8 experts) the capacity is c = 2:
// each expert's weight is read once for 2 rows, 4 flops a weight element,
// far below the 295 flop a byte at which the H100's tensor cores become
// the limit. The gemm is a weight read, bound by device-memory bytes (the
// gate or up projection of Mixtral-8x7B moves 0.94 GB: 0.28 ms at 3.35
// TB/s); the heuristic gives it a 16-row tile with a deep k slice, so every
// CTA streams its own columns of w in few, large steps. At prefill
// (c = 640 or 2560) a product does 2*c flops a weight element, above that
// line: bound by the tensor cores. This first version stages through shared
// memory with WMMA, without cp.async/TMA pipelining, wgmma, or split-k for
// the narrow-n down projection (512 CTAs walking k = 14,336 at decode), and
// leaves those to a later change.
#include "gemm.cuh"

// out[z] = x[z] @ w[z] for z < e: x[z] [c,k] at x + z*sx elements, w[z]
// [k,n] at w + z*sw, out[z] at out + z*c*n. tx/tw: the operand is stored
// transposed (column-major) with leading dimension ldx/ldw.
extern "C" int repro_expert_gemm(const void* x, const void* w, void* out, int e, int c, int n,
                                 int k, int tx, int tw, int ldx, int ldw, long long sx,
                                 long long sw, int dtype, int bc, int bn, int bk,
                                 void* stream) {
  return gemm_launch(x, w, out, e, c, n, k, tx, tw, ldx, ldw, sx, sw, dtype, bc, bn, bk,
                     stream);
}

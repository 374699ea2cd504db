"""End-to-end smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--campaign-budget EVALS]

Phases, each fatal on failure (non-zero exit, no result line):

1. device  — a CUDA card must be present; prints its name, the device
             count and ``nvidia-smi --query-gpu=name,power.limit``;
2. build   — builds every CUDA kernel from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, in parallel) and prints, kernel by kernel,
             nvcc's registers and spills, and its wgmma serialization
             warnings (C7510-C7520); disassembles the two flash libraries and
             the two gemm libraries (``cuobjdump --dump-sass``) and counts
             the HGMMA instructions (wgmma) of each kernel: it fails if a
             bf16 flash kernel (``flash_*_tc``) or a bf16 gemm kernel of the
             tensor-core or decode route (``gemm_tc``, ``gemm_decode``) of
             the matmul, expert_gemm, matmul_bias_act or rmsnorm_matmul
             library has none, or if the flash libraries lack their head
             dim 256 tensor-core kernels (three forward configs; the dq and
             dk/dv passes) or those have none;
3. kernels — runs each kernel at the serving and training paths' shapes in
             bf16 (matmul also on the backward's transposed operands; the
             fused matmul_bias_act at the training gate projection with
             silu, once each with no activation and gelu, at a ragged
             shape (the WMMA route: a weight row TMA cannot address) and at
             qwen's biased q projection at decode rows, beside matmul's
             time for the same product; rmsnorm_matmul at the decode
             unembed of each served model (qwen2_0_5b also at a ragged 13
             rows, Mixtral, Jamba at d = 8192), the 64-row pool (the tc
             route), a width TMA cannot address (the WMMA loop) and fp32 at
             d = 8192, each on its route, beside its k-sliced loop
             (``loop_ms``), the product alone on matmul, the unfused pair
             rmsnorm + matmul and F.rms_norm + torch.matmul; rmsnorm and
             rmsnorm_bwd also
             with the host time of one call beside F.rms_norm's (forward or
             backward) and the time of their bare launch; rmsnorm_bwd also
             at Mixtral's and Jamba's widths, [8192,4096] and [2048,8192]),
             at its heuristic config and at one other legal
             config, holds it against its plain PyTorch version on the
             card, and times kernel, plain version and the one-call
             PyTorch yardstick (where one call computes the same function)
             with CUDA events, beside the card's bound for the same work;
             each matmul, expert_gemm and matmul_bias_act row names its
             route (a main-path shape must take the tensor-core or decode
             one), holds a split-k
             launch to a second one bit for bit, and times the same call on
             the first port's tile loop (``wmma_ms``, or ``simt_loop_ms``
             in fp32): the before and after in one call;
   The hybrid's kernels join them: ssm_scan at b=1, s=2048, d_inner
             16384 (xc bf16, the TMA loader) and at a ragged s=1500,
             d_inner 16380 (the cp.async loader), each at its heuristic
             config and at another lane count and ring depth, with the
             warps an SM each holds, and at the hybrid-train phase's
             b=2, d_inner 8192; the scan's backward, the ssm_scan_bwd
             tunable (torch code, not a kernel) at its heuristic chunk at
             that shape and at Jamba's full width (b=1, d_inner 16384),
             against the ref.ssm_scan_bwd oracle, timed (not gated) beside
             the forward kernel;
             ssm_update at the 8-slot pool, with its bare launch's time
             warm and cold in L2 and the host time of one call (two
             configs); flash attention at 64/8 heads
             of 128 (s = 2048 and the ragged s = 1500 of an exact-length
             prefill) and one CTA of it alone, timed per k tile; the flash
             backward at 64/8 heads of 128 and, windowed (1024), at 32/8
             heads of 128 over 4096 positions, each split into its dq and
             dk/dv passes by torch.profiler; the hybrid's bf16 in_proj and
             fp32 dt_proj / out_proj gemms, out_proj also at a short
             prefill's 256 rows (split over k) and in its two gradient
             forms (ct @ w^T, x^T @ ct); each fp32 row of more than 16 rows
             names its tiles, splits and copy granules and, at one split,
             must be bit-equal to the first port's loop (torch.equal);
   And Mixtral-8x7B's: expert_gemm at the decode pool's capacity 2, at
             prefill capacities 640 and 2560 (gate/up and down), on the
             backward's transposed views at 640 and at a ragged 37 (torch.bmm
             is its one-call yardstick); flash attention at 32/8 heads of
             128 with the 4096 window over 8192 positions; its projections
             and norms at decode and prefill rows;
   And the new archs': the flash forward and backward at head dim 256
             (PaliGemma's 8 q heads on one kv head) at its training step's
             b=2 x 2048 and at a ragged 1000, each beside SDPA and its
             bound; Gemma3-27B's local (window 1024) and global attention
             over a 3000-token prefill, its FFN gemm at decode rows, its
             norm at the 4096 bucket and its decode final norm -> unembed
             (d 5376 x 262,144); expert_gemm at Arctic's 128 experts
             (d_model 7168, width 4864) at capacities 10 and 2;
   And xLSTM-1.3B's: the sLSTM MLP's gemms at n = 2752 (up_g at 2048 and
             8 rows) and k = 2752 (down at 2048 rows), the first main-path
             bf16 widths that are not a multiple of 128, with up_g's two
             gradients at the training step's 2048 rows; the mLSTM's fp32
             out_proj [*, 4096] @ [4096, 2048] at 2048 rows (gemm_simt) and
             8 (gemm_simt_rows); rmsnorm at d 2048 (8 and 2048 rows),
             rmsnorm_bwd at [2048, 2048] and softmax_xent and its backward
             at [2048, 50304];
4. serve   — full-width qwen2_0_5b in bf16 from a seeded random init,
             ServingEngine(max_batch=8, max_seq=2048), 16 staggered
             requests with prompts of 16..1500 tokens and 32 new tokens
             each; the serving kernels' launch counters must rise and no
             dispatch may fall to the reference tier; no bf16 gemm launch
             of this or a later phase may take the WMMA route, and the
             tensor-core and decode routes' counters must rise; one
             prefill's logits are held against the plain (reference-mode)
             path, and
             torch.profiler splits a decode step and the largest prefill by
             kernel;
   faults  — the fault plane on full-width qwen2_0_5b (random weights
             from --seed, an 8-slot pool at max_seq=2048, 8 requests of
             16..512 tokens, 16 new each, greedy), each run under its own
             obs collector: (a) a fault-free guarded kernel engine's tokens
             T_k and a reference engine's T_r; (b) every serving tunable
             faulted under the guard gives T_r bit for bit, each
             quarantined at level kernel, the warning naming InjectedFault
             and the counter in the Prometheus export; (c) one database
             record faulted once: its key at level record, its bucket on
             the heuristic, every other bucket on kernel tiers, a decode
             step's logits within TOL_LOGITS of (a)'s; (d) a NaN probe on
             rmsnorm quarantines its bucket, the logits finite and within
             TOL_LOGITS; (e) an unguarded engine faulted at its first
             dispatch degrades and gives T_r bit for bit, then, re-armed,
             T_k; (f) LockStepEngine on 8 prompts of one length, its
             decode steps beside the pool's, its first-token logits within
             TOL_LOGITS of the pool's; (g) the obs plane inside a
             torch.profiler window (latency percentiles, dispatch calls by
             tier, spans, ``serve.admit`` among the named ranges, the
             snapshot's JSON round trip), and a decode step's host time
             with the guard on and off and with no collector, a disabled
             one and an enabled one (printed, not gated);
5. hybrid  — full-width Jamba-1.5-Large without experts (num_experts=0:
             a dense SwiGLU FFN on every layer) cut to one super-block of
             8 layers (1 attention + 7 Mamba), bf16 from a seeded random
             init (about 9.0 B parameters, 18 GB; the serve phase's are
             freed first), ServingEngine(max_batch=8, max_seq=2048), 8
             staggered requests with prompts of 16..1500 tokens, prefilled
             at exact length, 16 new tokens each, half greedy; ssm_scan
             must launch 7 times a prefill and ssm_update 7 times a decode
             step, matmul, rmsnorm and flash attention must launch, and no
             dispatch may fall to the reference tier; the 1500-token
             prompt's prefill logits are held against the plain path; every
             fp32 gemm of a prefill of more than 16 tokens must have run the
             register-tiled kernel (its counter, matmul_simt_tile) and none
             the first port's loop; torch.profiler splits a decode step and
             that prefill by kernel, with ssm_update's share of the decode
             step and ssm_scan's and the fp32 route's of the prefill;
6. moe     — full-width Mixtral-8x7B cut to 8 of its 32 layers (11.9 B
             bf16 parameters from a seeded random init; the earlier phases'
             are freed first), ServingEngine(max_batch=8, max_seq=8192), 8
             staggered requests with prompts of 8..5000 tokens (the 5000 one
             passes the 4096 window: flash masks by it and the decode cache
             rolls), 16 new tokens each, half greedy; expert_gemm must launch
             exactly 24 times a prefill and 24 times a decode step, matmul,
             rmsnorm and flash attention must launch, and no dispatch may
             fall to the reference tier; one full-width MoE layer, fed one
             input, must take the same routes on the kernel and the plain
             path and agree within TOL_MOE_LAYER; the 5000-token prompt's
             prefill logits are held against the plain path on the kernel
             path's routes (TOL_LOGITS) and against the plain path routing on
             its own (TOL_MOE_LOGITS_FREE, with the count of tokens whose
             routes flip between the two); prints the share of
             (token, choice) routes capacity drops at decode, and
             torch.profiler splits a decode step and that prefill by kernel;
7. gemma   — Gemma3-27B (hf:google/gemma-3) at full depth, all 62
             layers (52 local on a 1024 window, 10 global), bf16 from a
             seeded random init (28.4 B parameters, 52.9 GiB),
             ServingEngine(max_batch=8, max_seq=4096), 8 staggered requests
             of 8..3000 tokens (four past the window: the ring caches wrap
             at prefill and at decode), 32 new tokens each, half greedy, on
             a database holding one record tuned here, the decode final norm
             -> unembed (so rmsnorm_matmul runs on its decode route, once a
             decode step); flash_attention launches 62 times a prefill, 52
             windowed and 10 full (by the telemetry's keys), no dispatch at
             the reference tier, peak memory under 75 GiB; prints prefill
             and decode-step times, tokens/s, peak memory, the decode
             step's computed floor and, by torch.profiler, a decode step's
             and the 3000-token prefill's device idle share; the 3000-token
             prefill's logits against the plain path end to end (printed:
             62 layers are past TOL_LOGITS's argument) and gated layer by
             layer (PrefillTap: each layer's output less its input on equal
             inputs at TOL_GRAD, the head on the kernel path's last hidden
             state at TOL_LOGITS);
8. archs   — qwen2_5_3b (hf:Qwen/Qwen2.5-3B), minitron_4b (arXiv:2407.14679,
             relu²) and musicgen_large (arXiv:2306.05284, audio frames) at
             full width cut to 4 layers, and arctic_480b
             (hf:Snowflake/snowflake-arctic-base, 128 experts beside a dense
             FFN) to 1 of 35 (14.1 B parameters), each freed before the next:
             one 512-token prefill and 4 greedy decode steps through
             lm.prefill and lm.decode_step (MusicGen: one forward with its
             loss over 2 x 1024 frames), the kernel path's logits against
             the plain path's at each step at TOL_LOGITS (Arctic on the
             kernel path's routes, RouteTap); Arctic's expert_gemm launches
             counted (15);
9. xlstm   — xLSTM-1.3B (arXiv:2405.04517) whole: all 48 layers (24
             mLSTM, 24 sLSTM, no FFN) at d_model 2048, bf16 from a seeded
             random init (2.928 B parameters), ServingEngine(max_batch=8,
             max_seq=2048), 8 staggered requests of 8..1500 tokens prefilled
             at exact length, 32 new tokens each, half greedy; matmul and
             rmsnorm launch, no dispatch at the reference tier, no bf16
             gemm on the WMMA route, and each mLSTM layer's fp32 out_proj
             on gemm_simt at every prefill of more than 16 tokens and on
             gemm_simt_rows at the others and every decode step; prints
             each prefill's time with the sLSTM token loop's host share
             (ScanClock), the decode step's median beside its computed
             floor, peak memory and launches by kernel and route, and by
             torch.profiler a decode step's and a 300-token prefill's
             device idle share; gates each matmul launch against the plain
             version on its own operands (DispatchTap) and, layer by layer
             through PrefillTap, each layer's contribution (its mixer's
             output, read before the bf16 residual add) and each state leaf
             at TOL_GRAD and the head at TOL_LOGITS (48 layers are past
             TOL_LOGITS's argument, so the end-to-end distances are
             printed): the 1500-token prefill; 8 greedy decode steps of the
             served pool, the plain pass on a copy of the pool's state from
             before each step; and
             continuity, a 129-token prefill and one decode step on the
             kernel path against the plain path's prefill of the 130
             tokens, at the last position;
10. train  — full-width qwen2_0_5b, bf16 parameters with the fp32 AdamW
             master copy, batch 4 x seq 2048 from SyntheticPipeline(seed),
             RunConfig(remat="none", loss_chunk=512), AdamWConfig(
             warmup_steps=2), 6 steps through the Trainer; step 1's loss is
             held against the plain path (reference mode on the card, same
             parameters and batch), and every gradient leaf and every
             layer's input cotangent against the plain path fed the kernel
             path's layer outputs and cotangents, one layer at a time, and
             every matmul launch of its forward and backward against the
             plain version on its own operands (DispatchTap) (each
             leaf's distance with the two paths on their own is printed,
             and for a leaf over its limit there, each path's distance from
             an fp32 computation of the step); every
             loss must be finite, every kernel's launch counter (transposed
             matmul included) must rise, rmsnorm_bwd must launch 49 times
             a step (one a norm: 2 a layer and the final one), and no fwd
             or bwd dispatch may fall to the reference tier; torch.profiler
             splits one more step by kernel, with rmsnorm_bwd's device time;
11. paligemma-train — PaliGemma-3B (arXiv:2407.07726) at full width and
             depth (18 layers, 8 q heads of 256 on one kv head, vocab
             257,216, 3.04 B parameters), its 256 patch embeddings (a stub
             frontend) before the tokens and loss_mask 0 on them, batch 2 x
             2048 (1 x 2048 past 75 GiB; the batch that ran is printed),
             RunConfig(remat="none", loss_chunk=512), 4 steps; step 1 gated
             as in the train phase; 18 flash forward and 18 backward launches
             in each step (counted step by step), every flash key at d = 256,
             37 rmsnorm_bwd a step; the d = 256 kernels' device share;
12. hybrid-train — Jamba-1.5-Large without experts, one super-block (1
             attention + 7 Mamba layers), its width cut to the original
             Jamba's published widths (arXiv:2403.19887: d_model 4096,
             d_ff 14336, 32/8 heads of 128; d_inner 8192, 2.73 B
             parameters), bf16 with the fp32 AdamW state, batch 2 x 2048
             (1 x 2048 if the step's peak passes 75 GiB; the batch that ran
             is printed), RunConfig(remat="none", loss_chunk=512), heuristic
             configs; step 1 held against the plain path as in the train
             phase, then 4 steps: 7 ssm_scan launches a step,
             ssm_scan_bwd in the backward's telemetry, 17 rmsnorm_bwd a
             step, flash_attention_bwd launched, the fp32 gemms (dt_proj,
             out_proj) and their gradients on gemm_simt (42 a step), no
             dispatch at the reference tier; prints the step time, tokens/s,
             peak memory, the device's busy time and idle share, and
             ssm_scan_bwd's share of a step by host clock and device time;
13. moe-train — Mixtral-8x7B at its published widths, 2 of 32 layers (3.2 B
             parameters), batch 4 x 2048 (2 x 2048 past 75 GiB), the same
             way, step 1's gradients gated on the kernel path's routes
             replayed into the plain path (routing on its own is reported
             only); expert_gemm's forward and transposed-gradient launches
             (9 a layer a step, all on tc), a finite aux loss above 0; prints
             as the hybrid phase, with expert_gemm's device share;
14. xlstm-train — xLSTM-1.3B at full width and depth (2.928 B), bf16 with
             the fp32 AdamW master and moments, batch 4 x 512 (2048 tokens
             a step; the sLSTM loop runs 512 steps a layer) under
             RunConfig(remat="none", loss_chunk=512) (peak 72.3 GiB on an
             NVIDIA H100 80GB HBM3), 2 steps; step 1
             gated as in the train phase, each mLSTM layer's recurrence
             pinned inside the layer too (LayerTap); 49
             rmsnorm_bwd a step, each mLSTM layer's fp32 out_proj 3 times a
             step on gemm_simt, one softmax_xent and one
             softmax_xent_bwd a step, no dispatch at the reference tier,
             peak under 75 GiB; prints the step time, tokens/s, the
             device's idle share and the launches of matmul (by route,
             transposed, split-k), rmsnorm, rmsnorm_bwd, softmax_xent and
             softmax_xent_bwd;
15. campaign — plans full-width qwen2_0_5b (the train phase's step, every
             dispatch site forward and backward, and serving at the token
             cap of the engine's warmup, 65536, at
             max_batch=8, max_seq=2048), tunes every job on the card with
             the CUDA-event WallClockEvaluator behind the correctness gate
             at a small budget (``--campaign-budget``), and exports the
             database; every job must bank a record that passed the gate
             and every kernel must have been launched; prints jobs,
             trials, pruned trials by reason, seconds, and per kernel the
             tuned configs' time beside the heuristic configs' from the
             same calls;
16. tuned  — on that database: ServingEngine.warmup and a few staggered
             requests, then 2 Trainer steps from the train phase's seed
             and batch; every fwd and bwd dispatch must resolve at the
             exact tier, rmsnorm_matmul (decode, on the tensor-core routes
             only) and matmul_bias_act (training, on the tensor-core route
             only) must launch, step 1
             must pass the train phase's gate and one prefill's logits
             TOL_LOGITS, both against the plain path; the tuned steps'
             times are printed beside the train phase's heuristic step
             times (reported, not claimed), and torch.profiler splits one
             more tuned step by kernel;
17. summary — one ``{"kernels": [...]}`` line, then the last line
             ``{"ok": true, "device": {...}}``.

After every phase a health check fails the run if the process-default obs
collector holds a ``dispatch.quarantine`` or ``serve.degraded`` warning, or
a live runtime's health book is not empty, or a live engine is degraded
(the faults phase's own, demoted on purpose, excepted): no demotion hides
on a path the port runs.

Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
import weakref

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances of kernel vs its plain version, relative to max|plain| (for
# attention, to max|plain| of each output row: a causal row that attends to
# n keys has values near n^-1/2, so the first rows would set a whole-tensor
# scale 30x above the last ones). Both accumulate in fp32 and round the
# result to bf16 once, so they differ by the order of the fp32 sums: two
# fp32 values that close round at most one bf16 step apart, and a step is
# at most 2^-7 of the element, so 1e-2 of the scale covers it.
# lse is fp32 on both sides: 1e-3 absolute covers a different summation
# order over 2048 keys.
TOL_BF16 = 1e-2
TOL_LSE = 1e-3
# Whole-model prefill and decode logits, kernel path vs plain path, end to
# end: at most 24 layers of bf16 activations whose roundings differ
# (rmsnorm's kernel multiplies by the weight before its cast, the reference
# after), so a few percent. The argument covers qwen2_0_5b's 24 layers (the
# serve and tuned phases), the hybrid's and Mixtral's 8 and the archs
# phase's 4 and 1. Gemma3-27B's 62 layers are past it: its prefill is gated
# layer by layer (PrefillTap, each layer's output less its input at
# TOL_GRAD, the head at TOL_LOGITS on the kernel path's last hidden state)
# and its end-to-end distance is printed beside this limit, which is not
# raised for it. xLSTM-1.3B's 48 layers are past it too: its prefill, its
# decode steps and its prefill-to-decode continuity are gated the same way.
TOL_LOGITS = 5e-2
# Cross entropy and its lse are fp32 on both sides, sums over 151,936
# columns in another order: 1e-4 of the value (lse is about 12 here).
TOL_XENT = 1e-4
# Train step 1, kernel path vs plain path (reference mode) on the same
# parameters and batch; limits set from sound card runs (NVIDIA H100 80GB
# HBM3, 700 W), each reading listed in PERF.md. The gate is layer by layer,
# with the loss end to end (gate_step1): the plain path runs each layer on
# the kernel path's layer inputs and output cotangents (LayerTap), and every
# gradient leaf, every cotangent a layer hands down and every layer's output
# less its input is held to TOL_GRAD there. Run on their own, two bf16
# computations part at their first rounding that differs and the
# differences compound layer after layer (the hybrid's Mamba step-size
# leaves read up to 3.7e-2 apart, each path 2.6e-2 to 3.2e-2 from an fp32
# computation of the step), so those end-to-end distances, and each leaf
# over TOL_GRAD there against fp32, are printed and not gated. Loss: a mean
# over the step's tokens of fp32 losses whose bf16 logits were rounded at
# different places; sound runs read 1.6e-5 and 2.5e-5 relative, limit
# 1e-3. Per leaf ||g_k - g_p|| / ||g_p||: sound runs of qwen2_0_5b read a
# median of 7.9e-3 and at most 1.56e-2 end to end on every leaf but the
# k-projection biases, limit 3e-2. The k bias's gradient is a sum over all
# positions of dk, most of which cancels (a per-row shift of the scores
# leaves softmax unchanged; only RoPE keeps the shift from being exact), so
# it is a small difference of large terms: readings 1.55e-2 to 2.02e-2,
# limit 4e-2. A GQA group's q head left out of dk/dv reads about 0.14.
TOL_LOSS = 1e-3
TOL_GRAD = 3e-2
TOL_GRAD_KBIAS = 4e-2
# A step-1 gate that fails is recorded here and its phase runs on, so the
# rest of the run still prints its measurements; main() then exits 1.
GATE_FAILURES = []
# Leaves over their limit, the two paths each on its own, that the gate
# reports against fp32 (each keeps two fp32 gradients until then).
REPORT_LEAVES = 32
# fp32 gemms (the hybrid's dt_proj and out_proj): both sides sum in fp32
# (TF32 off), in another order over k up to 16,384 terms: 1e-4 of max|plain|.
TOL_F32_GEMM = 1e-4
# The selective scan's y and final state are fp32 on both sides. The kernel
# takes exp as one ex2.approx (relative error about 2^-22), the plain
# version as torch.exp2, and the y sums run in another order: about 1e-7 a
# step, carried along the recurrence for as long as its decay keeps it
# (dA = exp(dt * A) up to 0.999 here): 1e-4 of max|plain|.
TOL_SSM = 1e-4
# One full-width MoE layer (Mixtral-8x7B, bf16), kernel path vs plain path
# on one input, routes equal: the gate and up products may round one bf16
# step apart (TOL_BF16's argument), silu(g) * u rounds once more, and the
# down product sums 14,336 such terms, whose errors have random signs:
# 2e-2 of max|plain| covers the three roundings.
TOL_MOE_LAYER = 2e-2
# Whole-model MoE prefill logits. On the same routes (the plain path takes
# the kernel path's expert ids) the dense argument holds: TOL_LOGITS. Left
# to route on its own, the plain path sends tokens whose router scores
# nearly tie to other experts: in the first sound card run (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md) 2 tokens of 5000 in layer 1 rising to
# 364 in layer 8, the last token's in layer 8, where the layer gate read
# 5.9e-3 and the logits 0.2457 of max|plain|. A flipped route gives the
# token another expert's output, so that comparison is bounded only by
# the readings: 0.5, twice the one reading.
TOL_MOE_LOGITS_FREE = 0.5


SERVE_KERNELS = ("matmul", "rmsnorm", "flash_attention")
HYBRID_KERNELS = SERVE_KERNELS + ("ssm_scan", "ssm_update")
MOE_KERNELS = SERVE_KERNELS + ("expert_gemm",)
TRAIN_KERNELS = ("matmul", "matmul_transposed", "rmsnorm", "rmsnorm_bwd", "softmax_xent",
                 "softmax_xent_bwd", "flash_attention", "flash_attention_bwd")


def log(msg: str = "") -> None:
    print(msg, flush=True)


def check_routes(launches, label: str, want=("tc", "decode"), kernels=("matmul",)) -> None:
    """No bf16 gemm launch of a main path took the WMMA route (every shape
    there is one TMA addresses), and each route in ``want`` launched."""
    for k in kernels:
        if launches.get(f"{k}_wmma", 0):
            raise AssertionError(f"{label}: {launches[f'{k}_wmma']} {k} launches took the WMMA "
                                 f"route")
        missing = [f"{k}_{r}" for r in want if launches.get(f"{k}_{r}", 0) <= 0]
        if missing:
            raise AssertionError(f"{label}: no launch on the routes {missing}: {launches}")
    log(f"[{label.split()[0]}] gemm routes: " + ", ".join(
        f"{k} {r} {v}" for k in kernels for r in ("tc", "decode", "simt", "wmma", "splitk")
        if (v := launches.get(f"{k}_{r}", 0))))


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(out, ref) -> tuple:
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def row_rel_err(out, ref) -> float:
    """max over rows of max|out - ref| / max|ref| in that row."""
    d = (out.float() - ref.float()).abs().amax(-1)
    return (d / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def bound(prof, nbytes: float, flops: float, peak: float) -> tuple:
    t_bytes = nbytes / prof.hbm_bandwidth * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    return kind, count, smi


def ptxas_kernels(report: str):
    """Each kernel's registers and spill bytes from nvcc's -Xptxas -v report,
    and the report's wgmma serialization warnings (C7510-C7520)."""
    kernels, warnings, fn = {}, [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            kernels[fn] = {"registers": 0, "spill": "0/0"}
        elif fn and "spill stores" in line:
            nums = [int(t) for t in line.replace(",", " ").split() if t.isdigit()]
            kernels[fn]["spill"] = f"{nums[1]}/{nums[2]}"
        elif fn and "Used" in line and "registers" in line:
            kernels[fn]["registers"] = int(line.split("Used")[1].split()[0])
        elif "Performance Loss" in line:
            warnings.append(line.strip())
    return kernels, warnings


def phase_build():
    from repro_torch.kernels import LIBRARIES, _build

    names = list(LIBRARIES)
    t0 = time.perf_counter()
    _build.build_all(names)
    log(f"[build] {len(names)} libraries in {time.perf_counter() - t0:.1f} s "
        f"into {_build.BUILD_DIR}")
    for n in names:
        kernels, warnings = ptxas_kernels(_build.ptxas_report(n))
        for fn, k in sorted(kernels.items()):
            log(f"[build] {n}: {k['registers']} registers, spill stores/loads {k['spill']} "
                f"bytes: {fn[:100]}")
        for wline in warnings:
            log(f"[build] {n}: {wline[:240]}")
    # The bf16 flash kernels (flash_*_tc) and the bf16 gemm kernels of the
    # tensor-core and decode routes (gemm_tc, gemm_decode: matmul's,
    # expert_gemm's and matmul_bias_act's) must run on the tensor cores:
    # each one's SASS holds wgmma, which disassembles as HGMMA.
    checks = (("flash_attention", ("_tc",)), ("flash_attention_bwd", ("_tc",)),
              ("matmul", ("gemm_tc", "gemm_decode")),
              ("expert_gemm", ("gemm_tc", "gemm_decode")),
              ("matmul_bias_act", ("gemm_tc", "gemm_decode")),
              ("rmsnorm_matmul", ("gemm_tc", "gemm_decode")))
    t0 = time.perf_counter()
    # one cuobjdump a library, all at once (each takes tens of seconds)
    with concurrent.futures.ThreadPoolExecutor(len(checks)) as pool:
        sass = dict(zip((n for n, _ in checks),
                        pool.map(lambda c: hgmma_counts(_build.lib_path(c[0])), checks)))
    log(f"[build] disassembled {len(checks)} libraries in {time.perf_counter() - t0:.1f} s")
    for n, tags in checks:
        counts = sass[n]
        tc = {f: c for f, c in counts.items() if any(t in f for t in tags)}
        if n.startswith("flash"):
            for f, c in sorted(counts.items()):
                log(f"[build] {n} SASS: {c} HGMMA in {f}")
        if not tc or min(tc.values()) == 0:
            raise AssertionError(f"{n}: a bf16 tensor-core kernel has no HGMMA in its SASS: "
                                 f"{ {f: c for f, c in tc.items() if c == 0} or tc}")
        if n.startswith("flash"):
            # head dim 256 (the first template argument): the tensor-core
            # route exists and runs wgmma there too
            d256 = {f: c for f, c in tc.items() if "_tcILi256E" in f}
            want = 3 if n == "flash_attention" else 2       # fwd configs; dq and dk/dv
            if len(d256) != want or min(d256.values()) == 0:
                raise AssertionError(f"{n}: the d=256 tensor-core kernels and their HGMMA: "
                                     f"{d256}")
            log(f"[build] {n}: {len(d256)} d=256 tensor-core kernels, "
                f"{', '.join(str(c) for c in d256.values())} HGMMA")
        by_tag = ", ".join(f"{sum(t in f for f in tc)} {t.strip('_')}" for t in tags)
        log(f"[build] {n}: {len(tc)} tensor-core kernels ({by_tag}), {min(tc.values())}..."
            f"{max(tc.values())} HGMMA each; {len(counts) - len(tc)} other kernels")


def hgmma_counts(lib) -> dict:
    """HGMMA instructions in the SASS of each kernel of a built library."""
    from repro_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def other_gemm_config(heur, rows_key="bm") -> dict:
    """The gemm's other legal config: the other tile width (the decode
    route's 128 columns in a ring of 3; the tc route's 128 or 256 columns)
    and the other split-k choice (two splits where the heuristic takes
    one, one where it splits)."""
    other = dict(heur, splits=1 if heur["splits"] > 1 else 2)
    if heur[rows_key] == 16:
        return dict(other, bn=128, stages=3)
    return dict(other, bn=128, stages=4) if heur["bn"] == 256 else dict(other, bn=256, stages=3)


def gemm_runs(run, cfgs, plan, plain, tol, what):
    """Launch ``run`` at each config, hold it against ``plain``, and hold a
    split-k launch to a second one bit for bit (the splits are summed in a
    fixed order); returns [(abs err, rel err)] and the heuristic's plan."""
    errs = []
    for cfg in cfgs:
        out = run(cfg)
        if plan(cfg)["splits"] > 1:
            again = run(cfg)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"{what} {cfg}: two split-k launches differ")
        torch.cuda.synchronize()
        errs.append(rel_err(out, plain))
        if errs[-1][1] > tol:
            raise AssertionError(f"{what} {cfg}: rel err {errs[-1][1]:.3g} > {tol}")
    return errs


def _matmul_case(prof, rows, m, k, n, gen, path, ta=False, tb=False, dtype=torch.bfloat16):
    from repro_torch.kernels import matmul as mm

    # ta / tb: the operand is a transposed view, as the backward passes it
    x = torch.randn((k, m) if ta else (m, k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((n, k) if tb else (k, n), generator=gen, device="cuda")
         * k ** -0.5).to(dtype)
    x, w = (x.T if ta else x), (w.T if tb else w)
    heur = mm.matmul.default_config(x, w)
    other = other_gemm_config(heur)
    plain = mm.matmul_plain(x, w)
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32_GEMM
    dname = "bf16" if dtype == torch.bfloat16 else "f32"
    shape = f"[{m},{k}]{'ᵀ' if ta else ''}@[{k},{n}]{'ᵀ' if tb else ''} {dname}"
    for cfg in (heur, other):
        if not mm.MATMUL_SPACE.is_valid(cfg):
            raise AssertionError(f"illegal matmul config {cfg}")
    p = mm.plan(x, w, heur)
    if dtype == torch.bfloat16 and p["route"] not in ("tc", "decode"):
        raise AssertionError(f"matmul {shape}: a main-path shape takes the {p['route']} route")
    errs = gemm_runs(lambda cfg: mm.matmul_cuda(x, w, **cfg), (heur, other),
                     lambda cfg: mm.plan(x, w, cfg), plain, tol, f"matmul {shape}")
    ms = time_ms(lambda: mm.matmul_cuda(x, w, **heur))
    ms_other = time_ms(lambda: mm.matmul_cuda(x, w, **other))
    # the same call on the first port's tile loop: the in-call before
    loop = mm.matmul_cuda(x, w, **heur, force_loop=True)
    torch.cuda.synchronize()
    if rel_err(loop, plain)[1] > tol:
        raise AssertionError(f"matmul {shape}: the tile loop disagrees with the plain version")
    # fp32 at one split: each output is one fmaf chain over k from 0, in the
    # same order in the register-tiled kernel as in the first port's loop
    bits = None
    if p["kernel"] == "tile" and p["splits"] == 1:
        bits = torch.equal(mm.matmul_cuda(x, w, **heur), loop)
        if not bits:
            raise AssertionError(f"matmul {shape}: the simt kernel is not bit-equal to the "
                                 f"first port's loop at one split")
    del loop
    loop_ms = time_ms(lambda: mm.matmul_cuda(x, w, **heur, force_loop=True))
    plain_ms = time_ms(lambda: mm.matmul_plain(x, w))
    lib_ms = time_ms(lambda: torch.matmul(x, w))
    esize = x.element_size()
    peak = prof.peak_flops_bf16 if dtype == torch.bfloat16 else prof.peak_flops_fp32
    b_ms, b_by = bound(prof, (m * k + k * n + m * n) * esize, 2.0 * m * n * k, peak)
    loop_key = "wmma_ms" if dtype == torch.bfloat16 else "simt_loop_ms"
    row = dict(shape=shape, path=path, route=p["route"], kernel=p["kernel"], splits=p["splits"],
               config=heur, ms=ms, other_config=other, other_ms=ms_other, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, **{loop_key: loop_ms},
               max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs))
    simt = ""
    if p["kernel"] == "tile":
        row.update(tiles={k: p[k] for k in ("bm", "bn", "bk", "stages")},
                   granules=mm.simt_granules(x, w), bit_equal_loop=bits)
        simt = (f" tile {p['bm']}x{p['bn']}x{p['bk']}, {p['stages']} stages, {p['splits']} "
                f"splits, granules {row['granules']}, bit-equal to the loop: {bits};")
    rows.append(row)
    log(f"[kernels] matmul {row['shape']}: {ms:.4f} ms {p['route']}{simt} {heur} ({ms_other:.4f} "
        f"ms {other}); first port's loop {loop_ms:.4f} ({loop_key}); plain {plain_ms:.4f}, "
        f"torch.matmul {lib_ms:.4f}, bound {b_ms:.4f} ({b_by}); err {row['max_abs_err']:.3g} "
        f"(rel {row['max_rel_err']:.2e} <= {tol})")


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call, enqueued back to back with no synchronise
    (where the device's share is shorter, the host sets the pace)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _rmsnorm_case(prof, rows_out, rows, d, gen, path):
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn

    x = torch.randn((rows, d), generator=gen, device="cuda").to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(torch.bfloat16)
    heur = rn.rmsnorm.default_config(x, w)
    other = {"block_rows": 32 if heur["block_rows"] != 32 else 4}
    p_out, p_r = rn.rmsnorm_plain(x, w)
    errs = []
    for cfg in (heur, other):
        out, r = rn.rmsnorm_cuda(x, w, **cfg)
        torch.cuda.synchronize()
        errs.append(rel_err(out, p_out))
        r_rel = rel_err(r, p_r)[1]
        if errs[-1][1] > TOL_BF16 or r_rel > 1e-5:
            raise AssertionError(f"rmsnorm [{rows},{d}] {cfg}: out rel {errs[-1][1]:.3g}, "
                                 f"invrms rel {r_rel:.3g}")
    # rows whose device time is below a call's host time: more iterations
    tk = dict(iters=200, warmup=20) if rows * d <= 8192 * 896 else {}
    ms = time_ms(lambda: rn.rmsnorm_cuda(x, w, **heur), **tk)
    ms_other = time_ms(lambda: rn.rmsnorm_cuda(x, w, **other), **tk)
    plain_ms = time_ms(lambda: rn.rmsnorm_plain(x, w), **tk)
    has_lib = hasattr(torch.nn.functional, "rms_norm")
    lib = lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6)
    lib_ms = time_ms(lib, **tk) if has_lib else None
    # the bare launch (the C entry on buffers allocated once): the kernel's
    # device time wherever it exceeds the entry's few microseconds of host
    fn = _build.entry("rmsnorm", "repro_rmsnorm", rn._RMSNORM_ARGTYPES)
    out, r = torch.empty_like(x), torch.empty(rows, dtype=torch.float32, device="cuda")
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), r.data_ptr(), rows, d, 1e-6, 1,
            heur["block_rows"], _build.stream_ptr(x.device))
    launch_ms = time_ms(lambda: fn(*args), **tk)
    host = host_us(lambda: rn.rmsnorm_cuda(x, w, **heur))
    lib_host = host_us(lib) if has_lib else None
    nbytes = rows * d * 2 * 2 + d * 2 + rows * 4
    b_ms, b_by = bound(prof, nbytes, 4.0 * rows * d, prof.peak_flops_fp32)
    row = dict(shape=f"[{rows},{d}] bf16", path=path, config=heur, ms=ms, other_config=other,
               other_ms=ms_other, launch_ms=launch_ms, host_us=host, library_host_us=lib_host,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs))
    rows_out.append(row)
    lib_s = f"{lib_ms:.4f}" if lib_ms is not None else None
    log(f"[kernels] rmsnorm {row['shape']}: {ms:.4f} ms {heur} ({ms_other:.4f} ms {other}); "
        f"bare launch {launch_ms:.4f}; plain {plain_ms:.4f}, F.rms_norm {lib_s}, bound "
        f"{b_ms:.4f} ({b_by}); err {row['max_abs_err']:.3g} (rel {row['max_rel_err']:.2e} <= "
        f"{TOL_BF16}); host time a call (us): rmsnorm_cuda {host:.1f}, F.rms_norm "
        f"{lib_host if lib_host is None else round(lib_host, 1)}")


def _flash_case(prof, rows, s, gen, path, h=14, kvh=2, d=64, b=1, window=0, iters=20):
    from repro_torch.kernels import attention as fa

    mk = lambda n: torch.randn((b, n, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = mk(h), mk(kvh), mk(kvh)
    heur = fa.flash_attention.default_config(q, k, v)
    other = other_config(heur, fa.flash_attention, (q, k, v))
    kw = dict(causal=True, window=window)
    p_out, p_lse = fa.flash_attention_plain(q, k, v, **kw)
    errs = []
    for cfg in (heur, other):
        out, lse = fa.flash_attention_cuda(q, k, v, **kw, **cfg)
        torch.cuda.synchronize()
        errs.append((rel_err(out, p_out)[0], row_rel_err(out, p_out)))
        lse_err = (lse - p_lse).abs().max().item()
        if errs[-1][1] > TOL_BF16 or lse_err > TOL_LSE:
            raise AssertionError(f"flash s={s} {cfg}: out row rel {errs[-1][1]:.3g}, lse {lse_err:.3g}")
    del out, lse, p_out, p_lse
    tk = dict(iters=iters, warmup=min(3, iters))
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw, **heur), **tk)
    ms_other = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw, **other), **tk)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), **tk)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window:      # one call with the window as a boolean mask (True: attend)
        qi = torch.arange(s, device="cuda")
        dist = qi[:, None] - qi[None, :]
        mask = (dist >= 0) & (dist < window)
        lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True), **tk)
        del mask, dist
    elif tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5):
        lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), **tk)
    else:       # no GQA flag: the yardstick gets k/v expanded beforehand
        ke, ve = (t.repeat_interleave(h // kvh, dim=1) for t in (k, v))
        lib_ms = time_ms(lambda: sdpa(q, ke, ve, is_causal=True), **tk)
    w = min(window or s, s)
    pairs = w * (w + 1) // 2 + (s - w) * w        # (q, k) pairs this run computes
    nbytes = b * ((2 * h * s * d + 2 * kvh * s * d) * 2 + h * s * 4)
    b_ms, b_by = bound(prof, nbytes, 4.0 * d * pairs * h * b, prof.peak_flops_bf16)
    wname = f" w{window}" if window else ""
    row = dict(shape=f"q[{b},{h},{s},{d}] kv[{b},{kvh},{s},{d}] causal{wname} bf16", path=path,
               config=heur, ms=ms, other_config=other, other_ms=ms_other, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs))
    rows.append(row)
    log(f"[kernels] flash_attention {row['shape']}: {ms:.4f} ms {heur} ({ms_other:.4f} ms "
        f"{other}); plain {plain_ms:.4f}, SDPA {lib_ms:.4f}, bound {b_ms:.4f} ({b_by}); "
        f"err {row['max_abs_err']:.3g} (row rel {row['max_rel_err']:.2e} <= {TOL_BF16})")


def other_config(heur, tun=None, args=()) -> dict:
    """The flash kernels' other legal config: the other q tile (and the
    other ring depth, where the space has one); where that is not legal at
    the call's head dim (``tun.why_illegal`` on ``args``: at d = 256), the
    first legal config of the space other than ``heur``, else ``heur``."""
    other = dict(heur, block_q=192 - heur["block_q"])
    if "stages" in heur:
        other["stages"] = 5 - heur["stages"]
    if tun is None or tun.why_illegal(other, *args) is None:
        return other
    return next((c for c in tun.space.enumerate()
                 if c != heur and tun.why_illegal(c, *args) is None), heur)


def _rmsnorm_bwd_case(prof, rows_out, rows, d, gen, path="train"):
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as rn

    x = torch.randn((rows, d), generator=gen, device="cuda").to(torch.bfloat16)
    w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(torch.bfloat16)
    ct = torch.randn((rows, d), generator=gen, device="cuda").to(torch.bfloat16)
    _, r = rn.rmsnorm_plain(x, w)
    heur = rn.rmsnorm_bwd.default_config(ct, x, w, r)
    other = {"block_rows": 32 if heur["block_rows"] != 32 else 4}
    p_dx, p_dw = rn.rmsnorm_bwd_plain(ct, x, w, r)
    errs = []
    for cfg in (heur, other):
        dx, dw = rn.rmsnorm_bwd_cuda(ct, x, w, r, **cfg)
        torch.cuda.synchronize()
        errs.append(max(rel_err(dx, p_dx), rel_err(dw, p_dw), key=lambda e: e[1]))
        if errs[-1][1] > TOL_BF16:
            raise AssertionError(f"rmsnorm_bwd [{rows},{d}] {cfg}: rel err {errs[-1][1]:.3g}")
    del dx, dw, p_dx, p_dw
    ms = time_ms(lambda: rn.rmsnorm_bwd_cuda(ct, x, w, r, **heur))
    ms_other = time_ms(lambda: rn.rmsnorm_bwd_cuda(ct, x, w, r, **other))
    plain_ms = time_ms(lambda: rn.rmsnorm_bwd_plain(ct, x, w, r))
    # the bare launch (the C entry on buffers allocated once), both configs
    fn = _build.entry("rmsnorm_bwd", "repro_rmsnorm_bwd", rn._RMSNORM_BWD_ARGTYPES)
    dx, dw = torch.empty_like(x), torch.empty_like(w)

    def bare(cfg):
        ctas = rn.rmsnorm_bwd_ctas(rows, d, 2, cfg["block_rows"])
        part = torch.empty((max(ctas, 1), d), dtype=torch.float32, device="cuda")
        args = (ct.data_ptr(), x.data_ptr(), w.data_ptr(), r.data_ptr(), dx.data_ptr(),
                dw.data_ptr(), part.data_ptr(), rows, d, 1, cfg["block_rows"], ctas,
                _build.stream_ptr(x.device))
        return time_ms(lambda: fn(*args)), ctas

    (launch_ms, ctas), (other_launch_ms, other_ctas) = bare(heur), bare(other)
    host = host_us(lambda: rn.rmsnorm_bwd_cuda(ct, x, w, r, **heur))
    # yardstick: the backward of one F.rms_norm call over the same inputs
    # (its forward graph built once, outside the timer)
    lib_ms = lib_host = None
    if hasattr(torch.nn.functional, "rms_norm"):
        xg, wg = (t.detach().clone().requires_grad_() for t in (x, w))
        y = torch.nn.functional.rms_norm(xg, (d,), wg, 1e-6)
        lib = lambda: torch.autograd.grad(y, (xg, wg), ct, retain_graph=True)
        lib_ms = time_ms(lib)
        lib_host = host_us(lib)
        del y
    nbytes = rows * d * 2 * 3 + d * 2 * 2 + rows * 4          # ct, x, dx; w, dw; invrms
    b_ms, b_by = bound(prof, nbytes, 8.0 * rows * d, prof.peak_flops_fp32)
    row = dict(shape=f"[{rows},{d}] bf16", path=path, config=heur, ms=ms,
               other_config=other, other_ms=ms_other, launch_ms=launch_ms, ctas=ctas,
               other_launch_ms=other_launch_ms, other_ctas=other_ctas, host_us=host,
               library_host_us=lib_host, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=max(e[0] for e in errs),
               max_rel_err=max(e[1] for e in errs))
    rows_out.append(row)
    lib_s = None if lib_ms is None else f"{lib_ms:.4f}"
    log(f"[kernels] rmsnorm_bwd {row['shape']}: {ms:.4f} ms {heur} ({ms_other:.4f} ms {other}); "
        f"bare launch {launch_ms:.4f} ({ctas} CTAs; {other_launch_ms:.4f}, {other_ctas} CTAs); "
        f"plain {plain_ms:.4f}, F.rms_norm backward "
        f"{lib_s}, bound {b_ms:.4f} ({b_by}); err {row['max_abs_err']:.3g} (rel "
        f"{row['max_rel_err']:.2e} <= {TOL_BF16}); host time a call (us): rmsnorm_bwd_cuda "
        f"{host:.1f}, F.rms_norm backward {lib_host if lib_host is None else round(lib_host, 1)}")


def _xent_cases(prof, fwd_rows, bwd_rows, rows, vocab, gen, path="train"):
    from repro_torch.kernels import xent as xe

    logits = (2 * torch.randn((rows, vocab), generator=gen, device="cuda")).to(torch.bfloat16)
    labels = torch.randint(0, vocab, (rows,), generator=gen, device="cuda")
    ct = torch.randn((rows,), generator=gen, device="cuda") / rows
    heur = xe.softmax_xent.default_config(logits, labels)
    other = {"block_rows": 1, "block_v": 512}
    p_loss, p_lse = xe.softmax_xent_plain(logits, labels)
    p_dl = xe.softmax_xent_bwd_plain(ct, logits, labels, p_lse)
    f_errs, b_errs = [], []
    for cfg in (heur, other):
        loss, lse = xe.softmax_xent_cuda(logits, labels, **cfg)
        dl = xe.softmax_xent_bwd_cuda(ct, logits, labels, lse, **cfg)
        torch.cuda.synchronize()
        f_errs.append(max(rel_err(loss, p_loss), rel_err(lse, p_lse), key=lambda e: e[1]))
        b_errs.append(rel_err(dl, p_dl))
        if f_errs[-1][1] > TOL_XENT or b_errs[-1][1] > TOL_BF16:
            raise AssertionError(f"softmax_xent [{rows},{vocab}] {cfg}: fwd rel "
                                 f"{f_errs[-1][1]:.3g}, bwd rel {b_errs[-1][1]:.3g}")
    _, lse = xe.softmax_xent_cuda(logits, labels, **heur)
    # yardstick of the backward: autograd of one F.cross_entropy call,
    # (softmax - onehot) * ct, its forward graph built once outside the timer
    lg = logits.detach().clone().requires_grad_()
    ce = torch.nn.functional.cross_entropy(lg, labels, reduction="none")
    ce_ct = ct.to(ce.dtype)
    n = rows * vocab
    for name, out, errs, tol, run, plain, lib, nbytes in (
        ("softmax_xent", fwd_rows, f_errs, TOL_XENT,
         lambda c: xe.softmax_xent_cuda(logits, labels, **c),
         lambda: xe.softmax_xent_plain(logits, labels),
         lambda: torch.nn.functional.cross_entropy(logits, labels, reduction="none"),
         n * 2 + rows * (8 + 4 + 4)),
        ("softmax_xent_bwd", bwd_rows, b_errs, TOL_BF16,
         lambda c: xe.softmax_xent_bwd_cuda(ct, logits, labels, lse, **c),
         lambda: xe.softmax_xent_bwd_plain(ct, logits, labels, lse),
         lambda: torch.autograd.grad(ce, lg, ce_ct, retain_graph=True),
         n * 2 * 2 + rows * (4 + 8 + 4))):
        ms = time_ms(lambda: run(heur))
        ms_other = time_ms(lambda: run(other))
        plain_ms = time_ms(plain)
        lib_ms = time_ms(lib)
        b_ms, b_by = bound(prof, nbytes, 4.0 * n, prof.peak_flops_fp32)
        row = dict(shape=f"[{rows},{vocab}] bf16", path=path, config=heur, ms=ms,
                   other_config=other,
                   other_ms=ms_other, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, max_abs_err=max(e[0] for e in errs),
                   max_rel_err=max(e[1] for e in errs))
        out.append(row)
        lib_s = f"F.cross_entropy{'' if name == 'softmax_xent' else ' backward'} {lib_ms:.4f}"
        log(f"[kernels] {name} {row['shape']}: {ms:.4f} ms {heur} ({ms_other:.4f} ms {other}); "
            f"plain {plain_ms:.4f}, {lib_s}, bound {b_ms:.4f} ({b_by}); err "
            f"{row['max_abs_err']:.3g} (rel {row['max_rel_err']:.2e} <= {tol})")


def device_split(fn, iters: int = 3) -> dict:
    """Device ms of each kernel one call of ``fn`` launches (torch.profiler,
    device activity only, over ``iters`` calls)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return device_ms(p, iters)


def device_ms(p, steps: int) -> dict:
    """Device ms a step of each kernel (or copy) a torch.profiler window saw,
    summed over the profiler's raw events (building its event tree for a
    window of a million kernels, as an xLSTM prefill or train step launches,
    takes minutes)."""
    by_name = {}
    cuda = torch.autograd.DeviceType.CUDA
    for ev in p.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            name = ev.name()
            by_name[name] = by_name.get(name, 0.0) + ev.duration_ns() / 1e6 / steps
    return by_name


# A profiler window of at most this many events also reads its device time
# through key_averages() (the event tree: quick at this size), printed
# beside the raw events' sum.
TREE_EVENTS = 200_000


def tree_device_ms(p, steps: int) -> float:
    """Device ms a step a torch.profiler window saw, through key_averages()."""
    total = 0.0
    for ev in p.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        total += dev_us / 1e3 / steps
    return total


def _flash_bwd_case(prof, rows, b, s, gen, h=14, kvh=2, d=64, window=0, path="train"):
    from repro_torch.kernels import attention as fa

    mk = lambda n: torch.randn((b, n, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v, do = mk(h), mk(kvh), mk(kvh), mk(h)
    kw = dict(causal=True, window=window)
    o, lse = fa.flash_attention_plain(q, k, v, **kw)
    heur = fa.flash_attention_bwd.default_config(do, q, k, v, o, lse)
    other = other_config(heur, fa.flash_attention_bwd, (do, q, k, v, o, lse))
    plain = fa.flash_attention_bwd_plain(do, q, k, v, o, lse, **kw)
    errs = []
    for cfg in (heur, other):
        grads = fa.flash_attention_bwd_cuda(do, q, k, v, o, lse, **kw, **cfg)
        torch.cuda.synchronize()
        errs.append(max((rel_err(g, p) for g, p in zip(grads, plain)), key=lambda e: e[1]))
        if errs[-1][1] > TOL_BF16:
            raise AssertionError(f"flash bwd b={b} s={s} {cfg}: rel err {errs[-1][1]:.3g}")
    del grads, plain
    tk = dict(iters=5, warmup=1)
    ms = time_ms(lambda: fa.flash_attention_bwd_cuda(do, q, k, v, o, lse, **kw, **heur), **tk)
    ms_other = time_ms(lambda: fa.flash_attention_bwd_cuda(do, q, k, v, o, lse, **kw, **other),
                       **tk)
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(do, q, k, v, o, lse, **kw), **tk)
    split = device_split(lambda: fa.flash_attention_bwd_cuda(do, q, k, v, o, lse, **kw, **heur))
    passes = {p: sum(ms for n, ms in split.items() if f"flash_bwd_{p}_tc" in n)
              for p in ("dq", "dkv")}
    # yardstick: the backward of one SDPA call over the same inputs (the
    # window as a boolean mask)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window:
        qi = torch.arange(s, device="cuda")
        dist = qi[:, None] - qi[None, :]
        out = sdpa(qg, kg, vg, attn_mask=(dist >= 0) & (dist < window), enable_gqa=True)
        del dist
    else:
        out = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True), **tk)
    del out
    w = min(window or s, s)
    pairs = w * (w + 1) // 2 + (s - w) * w        # (q, k) pairs this run computes
    # the least work: 5 matmul-equivalents (s, dp, dv, dq, dk) over the live pairs
    flops = 5 * 2.0 * d * pairs * h * b
    nbytes = b * ((4 * h * s * d + 4 * kvh * s * d) * 2 + h * s * 4)
    b_ms, b_by = bound(prof, nbytes, flops, prof.peak_flops_bf16)
    wname = f" w{window}" if window else ""
    row = dict(shape=f"q[{b},{h},{s},{d}] kv[{b},{kvh},{s},{d}] causal{wname} bf16",
               path=path, config=heur, ms=ms, other_config=other, other_ms=ms_other,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               dq_pass_ms=passes["dq"], dkv_pass_ms=passes["dkv"],
               max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs))
    rows.append(row)
    log(f"[kernels] flash_attention_bwd {row['shape']}: {ms:.4f} ms {heur} ({ms_other:.4f} ms "
        f"{other}); dq pass {passes['dq']:.4f}, dk/dv pass {passes['dkv']:.4f} (torch.profiler); "
        f"plain {plain_ms:.4f}, SDPA backward {lib_ms:.4f}, bound {b_ms:.4f} "
        f"({b_by}); err {row['max_abs_err']:.3g} (rel {row['max_rel_err']:.2e} <= {TOL_BF16})")


def flash_tile_latency(prof, sfu, gen) -> None:
    """What bounds the flash forward's CTA: one CTA alone (one q tile of 64
    rows at d = 128 against 2048 keys, 32 tiles of 64 keys, all live) timed
    per k tile, beside what one tile needs of one SM: its two products (S =
    Q K^T and P V, 4 * 64 * 64 * 128 flops) at the SM's share of the bf16
    peak, and its 64 * 64 exponentials at the SM's share of the SFU rate."""
    from repro_torch.kernels import attention as fa

    mk = lambda n: torch.randn((1, 1, n, 128), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = mk(64), mk(2048), mk(2048)
    cfg = {"block_q": 64, "block_k": 64, "stages": 2}
    us = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True, **cfg), iters=50) * 1e3
    mma_us = 4.0 * 64 * 64 * 128 / (prof.peak_flops_bf16 / prof.sm_count) * 1e6
    exp_us = 64.0 * 64 / (sfu / prof.sm_count) * 1e6
    log(f"[kernels] flash_attention one CTA alone, q[1,1,64,128] kv[1,1,2048,128] {cfg}: "
        f"{us:.2f} us, {us / 32:.4f} us a 64-key tile; one SM needs {mma_us:.4f} us for the "
        f"tile's two products at its share of the bf16 peak and {exp_us:.4f} us for its 4096 "
        f"exponentials at its share of the SFU rate")


def _mba_case(prof, rows, m, k, n, act, gen, path):
    from repro_torch.kernels import fused as fu
    from repro_torch.kernels import matmul as mm

    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn((n,), generator=gen, device="cuda")).to(torch.bfloat16)
    shape = f"[{m},{k}]@[{k},{n}] bf16 a{act}"
    heur = fu.matmul_bias_act.default_config(x, w, b)
    other = other_gemm_config(heur)
    for cfg in (heur, other):
        if not mm.MATMUL_SPACE.is_valid(cfg):
            raise AssertionError(f"illegal matmul_bias_act config {cfg}")
    p = mm.plan(x, w, heur)
    # a weight whose rows are not 16-byte multiples (n = 4860) is one TMA
    # cannot address: the WMMA route, by the rule
    if p["route"] not in ("tc", "decode") and n % 8 == 0:
        raise AssertionError(f"matmul_bias_act {shape}: a main-path shape takes the "
                             f"{p['route']} route")
    plain = fu.matmul_bias_act_plain(x, w, b, act)
    run = lambda cfg, **kw: fu.matmul_bias_act_cuda(x, w, b, act=act, **cfg, **kw)
    errs = gemm_runs(run, (heur, other), lambda cfg: mm.plan(x, w, cfg), plain, TOL_BF16,
                     f"matmul_bias_act {shape}")
    ms = time_ms(lambda: run(heur))
    ms_other = time_ms(lambda: run(other))
    # the same call on the first port's WMMA loop: the in-call before
    loop = run(heur, force_loop=True)
    torch.cuda.synchronize()
    if rel_err(loop, plain)[1] > TOL_BF16:
        raise AssertionError(f"matmul_bias_act {shape}: the WMMA loop disagrees with the plain "
                             f"version")
    wmma_ms = time_ms(lambda: run(heur, force_loop=True))
    # the product alone on matmul, same route and config: what the epilogue adds
    matmul_ms = time_ms(lambda: mm.matmul_cuda(x, w, **heur))
    plain_ms = time_ms(lambda: fu.matmul_bias_act_plain(x, w, b, act))
    # One PyTorch call computes the same function only without an
    # activation (addmm); silu and gelu would take a chain of calls.
    lib_ms = time_ms(lambda: torch.addmm(b, x, w)) if act == "none" else None
    b_ms, b_by = bound(prof, (m * k + k * n + n + m * n) * 2, 2.0 * m * n * k,
                       prof.peak_flops_bf16)
    row = dict(shape=shape, path=path, route=p["route"], splits=p["splits"], config=heur, ms=ms,
               other_config=other, other_ms=ms_other, wmma_ms=wmma_ms, matmul_ms=matmul_ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs))
    rows.append(row)
    lib_s = f"torch.addmm {lib_ms:.4f}" if lib_ms is not None else "no one-call yardstick"
    log(f"[kernels] matmul_bias_act {shape}: {ms:.4f} ms {p['route']} {heur} ({ms_other:.4f} "
        f"ms {other}); WMMA loop {wmma_ms:.4f} (wmma_ms); matmul alone {matmul_ms:.4f}; plain "
        f"{plain_ms:.4f}, {lib_s}, bound {b_ms:.4f} ({b_by}); err {row['max_abs_err']:.3g} "
        f"(rel {row['max_rel_err']:.2e} <= {TOL_BF16})")


def _rmm_case(prof, rows, m, d, n, gen, path, dtype=torch.bfloat16, want=None):
    """rmsnorm_matmul at [m,d]x[d,n]: the heuristic config and another one
    against the plain version (a split-k launch twice, bit for bit), on the
    route ``want``; timed beside the k-sliced loop (``loop_ms``, the
    yardstick of force_loop), the product alone on matmul at the same config
    (``matmul_ms``), the unfused pair through the port's kernels (rmsnorm,
    then matmul on the same route: ``pair_ms``) and, for context, the
    library pair F.rms_norm + torch.matmul (neither pair is one call)."""
    from repro_torch.kernels import fused as fu
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rmsnorm as rn

    x = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
    sc = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(dtype)
    w = (torch.randn((d, n), generator=gen, device="cuda") * d ** -0.5).to(dtype)
    bf = dtype == torch.bfloat16
    tol = TOL_BF16 if bf else TOL_F32_GEMM
    shape = f"[{m},{d}]x[{d},{n}] {'bf16' if bf else 'f32'}"
    heur = fu.rmsnorm_matmul.default_config(x, sc, w)
    other = other_gemm_config(heur)
    for cfg in (heur, other):
        if not mm.MATMUL_SPACE.is_valid(cfg):
            raise AssertionError(f"illegal rmsnorm_matmul config {cfg}")
    p = fu.rmm_plan(x, sc, w, heur)
    if want is not None and p["route"] != want:
        raise AssertionError(f"rmsnorm_matmul {shape}: the {p['route']} route, not {want}")
    plain = fu.rmsnorm_matmul_plain(x, sc, w)
    run = lambda cfg, **kw: fu.rmsnorm_matmul_cuda(x, sc, w, **cfg, **kw)
    errs = gemm_runs(run, (heur, other), lambda cfg: fu.rmm_plan(x, sc, w, cfg), plain, tol,
                     f"rmsnorm_matmul {shape}")
    loop = run(heur, force_loop=True)
    torch.cuda.synchronize()
    if rel_err(loop, plain)[1] > tol:
        raise AssertionError(f"rmsnorm_matmul {shape}: the k-sliced loop disagrees with the "
                             f"plain version")
    del loop
    ms = time_ms(lambda: run(heur))
    ms_other = time_ms(lambda: run(other))
    loop_ms = time_ms(lambda: run(heur, force_loop=True), iters=5)
    xn = rn.rmsnorm_cuda(x, sc, **rn.rmsnorm.default_config(x, sc))[0]
    matmul_ms = time_ms(lambda: mm.matmul_cuda(xn, w, **heur))
    pair_ms = time_ms(lambda: mm.matmul_cuda(
        rn.rmsnorm_cuda(x, sc, **rn.rmsnorm.default_config(x, sc))[0], w, **heur))
    lib_pair_ms = time_ms(lambda: torch.matmul(
        torch.nn.functional.rms_norm(x, (d,), sc, 1e-6), w))
    plain_ms = time_ms(lambda: fu.rmsnorm_matmul_plain(x, sc, w))
    esize = x.element_size()
    b_ms, b_by = bound(prof, (m * d + d + d * n + m * n) * esize, 2.0 * m * d * n,
                       prof.peak_flops_bf16 if bf else prof.peak_flops_fp32)
    row = dict(shape=shape, path=path, route=p["route"], kernel=p["kernel"], splits=p["splits"],
               config=heur, ms=ms, other_config=other, other_ms=ms_other, loop_ms=loop_ms,
               matmul_ms=matmul_ms, pair_ms=pair_ms, library_pair_ms=lib_pair_ms,
               plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs))
    rows.append(row)
    log(f"[kernels] rmsnorm_matmul {shape}: {ms:.4f} ms {p['route']} {heur} ({ms_other:.4f} "
        f"ms {other}); k-sliced loop {loop_ms:.4f} (loop_ms); matmul alone {matmul_ms:.4f}; "
        f"unfused pair rmsnorm + matmul {pair_ms:.4f}; F.rms_norm + torch.matmul "
        f"{lib_pair_ms:.4f}; plain {plain_ms:.4f}, no one-call yardstick, bound {b_ms:.4f} "
        f"({b_by}); err {row['max_abs_err']:.3g} (rel {row['max_rel_err']:.2e} <= {tol})")


def _egemm_case(prof, rows, e, c, k, n, gen, path, form="x@w", iters=20):
    """expert_gemm at [e,c,k] @ [e,k,n]; ``form`` "ct@wT" and "xT@ct" pass
    the backward's swapaxes views as they come: dx = ct[e,c,k] @
    swapaxes(w)[e,k,n] of a w stored [e,n,k], and dw = swapaxes(x)[e,c,k] @
    ct[e,k,n] of an x stored [e,k,c]. A ragged capacity's transposed x is an
    operand TMA cannot address: it takes the WMMA route."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import moe_gemm as mg

    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    x = rn(e, k, c).transpose(1, 2) if form == "xT@ct" else rn(e, c, k)
    w = (rn(e, n, k).transpose(1, 2) if form == "ct@wT" else rn(e, k, n)) * k ** -0.5
    if x.is_contiguous() == (form == "xT@ct") or w.is_contiguous() == (form == "ct@wT"):
        raise AssertionError(f"expert_gemm {form}: operands not in the form's layout")
    heur = mg.expert_gemm.default_config(x, w)
    other = other_gemm_config(heur, "bc")
    plain = mg.expert_gemm_plain(x, w)
    tx, tw = ("ᵀ" if form == "xT@ct" else ""), ("ᵀ" if form == "ct@wT" else "")
    shape = f"[{e},{c},{k}]{tx}@[{e},{k},{n}]{tw} bf16"
    for cfg in (heur, other):
        if not mg.EXPERT_GEMM_SPACE.is_valid(cfg):
            raise AssertionError(f"illegal expert_gemm config {cfg}")
    plan = lambda cfg: mm.plan(x, w, dict(cfg, bm=cfg["bc"]))
    p = plan(heur)
    if p["route"] not in ("tc", "decode") and not (form == "xT@ct" and c % 8):
        raise AssertionError(f"expert_gemm {shape}: a main-path shape takes the {p['route']} "
                             f"route")
    errs = gemm_runs(lambda cfg: mg.expert_gemm_cuda(x, w, **cfg), (heur, other), plan, plain,
                     TOL_BF16, f"expert_gemm {form} {shape}")
    del plain
    tk = dict(iters=iters, warmup=min(3, iters))
    ms = time_ms(lambda: mg.expert_gemm_cuda(x, w, **heur), **tk)
    ms_other = time_ms(lambda: mg.expert_gemm_cuda(x, w, **other), **tk)
    wmma_ms = time_ms(lambda: mg.expert_gemm_cuda(x, w, **heur, force_loop=True), **tk)
    plain_ms = time_ms(lambda: mg.expert_gemm_plain(x, w), **tk)
    lib_ms = time_ms(lambda: torch.bmm(x, w), **tk)
    b_ms, b_by = bound(prof, (e * c * k + e * k * n + e * c * n) * 2, 2.0 * e * c * k * n,
                       prof.peak_flops_bf16)
    row = dict(shape=shape, path=path, route=p["route"], splits=p["splits"], config=heur, ms=ms,
               other_config=other, other_ms=ms_other, wmma_ms=wmma_ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               max_abs_err=max(er[0] for er in errs), max_rel_err=max(er[1] for er in errs))
    rows.append(row)
    log(f"[kernels] expert_gemm {row['shape']}: {ms:.4f} ms {p['route']} {heur} ({ms_other:.4f} "
        f"ms {other}); WMMA loop {wmma_ms:.4f}; plain {plain_ms:.4f}, torch.bmm {lib_ms:.4f}, "
        f"bound {b_ms:.4f} ({b_by}); err {row['max_abs_err']:.3g} (rel "
        f"{row['max_rel_err']:.2e} <= {TOL_BF16})")


def gemm_host_cost(gen) -> None:
    """Host time of one gemm call (:func:`host_us`): the decode route at
    Mixtral's [8,4096]@[4096,4096], in one and in two splits, the first
    port's loop, and one torch.matmul."""
    from repro_torch.kernels import matmul as mm

    x = torch.randn((8, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((4096, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    heur = mm.matmul.default_config(x, w)
    calls = (("decode route", lambda: mm.matmul_cuda(x, w, **dict(heur, splits=1))),
             ("decode route, 2 splits", lambda: mm.matmul_cuda(x, w, **dict(heur, splits=2))),
             ("first port's loop", lambda: mm.matmul_cuda(x, w, **heur, force_loop=True)),
             ("torch.matmul", lambda: torch.matmul(x, w)))
    out = [f"{name} {host_us(fn):.1f}" for name, fn in calls]
    log(f"[kernels] host time a gemm call, [8,4096]@[4096,4096] bf16 (us): {', '.join(out)}")


def sfu_rate(prof) -> float:
    """exp2 evaluations a second: 16 a clock an SM (NVIDIA's arithmetic
    instruction throughput table for compute capability 9.0) at the card's
    maximum SM clock as nvidia-smi reads it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]
    return 16.0 * prof.sm_count * float(mhz) * 1e6


def _ssm_bound(prof, sfu, nbytes, steps, ds):
    """(ms, by) of the selective scan's work: the bytes, against its fp32
    operations (6 a state element a step: dt * A, the state's multiply-add,
    the dt * x * B term, y's multiply-add) and its exponentials (one a state
    element a step) on the SFUs, whichever is slower."""
    t_bytes = nbytes / prof.hbm_bandwidth * 1e3
    t_ops = max(6.0 * steps * ds / prof.peak_flops_fp32, steps * ds / sfu) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ssm_inputs(gen, lead, di, ds, state_scale):
    """The mixer's ranges at init: xc bf16, dt = softplus(. - 2) > 0, B and
    C of unit scale, A = -(1..ds) on every channel."""
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    A = -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda").expand(di, ds).contiguous()
    return ((0.5 * rn(*lead, di)).to(torch.bfloat16),
            torch.nn.functional.softplus(0.5 * rn(*lead, di) - 2.0), rn(*lead, ds), rn(*lead, ds),
            A, state_scale * rn(lead[0], di, ds))


def _ssm_scan_case(prof, rows, b, s, di, gen, sfu, want_loader, ds=16, path="hybrid"):
    from repro_torch import kernels
    from repro_torch.kernels import ssm_scan as ss

    args = _ssm_inputs(gen, (b, s), di, ds, 0.0)        # prefill starts from h = 0
    heur = ss.ssm_scan.default_config(*args)
    # the other legal config: another lane count and ring depth
    other = dict(heur, lanes=2 if heur["lanes"] != 2 else 4,
                 stages=2 if heur["stages"] != 2 else 3)
    ld = ss.loader(*args[:4])
    if ld != want_loader:
        raise AssertionError(f"ssm_scan di={di}: the rule names loader {ld}, not {want_loader}")
    p_y, p_h = ss.ssm_scan_plain(*args)
    errs, warps = [], []
    for cfg in (heur, other):
        if not ss.SSM_SCAN_SPACE.is_valid(cfg):
            raise AssertionError(f"illegal ssm_scan config {cfg}")
        kernels.reset_launch_counts()
        y, hn = ss.ssm_scan_cuda(*args, **cfg)
        torch.cuda.synchronize()
        counted = kernels.launch_counts()
        if counted != {"ssm_scan": 1, f"ssm_scan_{ld}": 1}:
            raise AssertionError(f"ssm_scan {cfg}: launch counts {counted}")
        errs.append(max(rel_err(y, p_y), rel_err(hn, p_h), key=lambda e: e[1]))
        if errs[-1][1] > TOL_SSM:
            raise AssertionError(f"ssm_scan b={b} s={s} di={di} {cfg}: rel err "
                                 f"{errs[-1][1]:.3g} > {TOL_SSM}")
        ctas = ss.ssm_scan_ctas_per_sm(args[0].dtype, ds, cfg, ld)
        warps.append(ctas * (cfg["block_d"] * cfg["lanes"] + 32) // 32)
    del y, hn, p_y, p_h
    ms = time_ms(lambda: ss.ssm_scan_cuda(*args, **heur))
    ms_other = time_ms(lambda: ss.ssm_scan_cuda(*args, **other))
    plain_ms = time_ms(lambda: ss.ssm_scan_plain(*args), iters=2, warmup=1)
    # xc bf16; dt, y fp32 [b,s,di]; B, C [b,s,ds]; A; h0 and hN [b,di,ds]
    nbytes = b * s * di * (2 + 4 + 4) + b * s * ds * 8 + di * ds * 4 + 2 * b * di * ds * 4
    b_ms, b_by = _ssm_bound(prof, sfu, nbytes, b * s * di, ds)
    grid = b * -(-di // heur["block_d"])
    row = dict(shape=f"b={b} s={s} di={di} ds={ds} xc bf16", path=path, config=heur, ms=ms,
               other_config=other, other_ms=ms_other, loader=ld, warps_per_sm=warps[0],
               other_warps_per_sm=warps[1], plain_ms=plain_ms, library_ms=None,
               bound_ms=b_ms, bound_by=b_by, max_abs_err=max(e[0] for e in errs),
               max_rel_err=max(e[1] for e in errs))
    rows.append(row)
    log(f"[kernels] ssm_scan {row['shape']}: {ms:.4f} ms {heur} ({ms_other:.4f} ms {other}); "
        f"loader {ld}; warps an SM (occupancy x warps a CTA) {warps[0]} ({warps[1]}), "
        f"{grid} CTAs on {prof.sm_count} SMs; plain {plain_ms:.4f}, no one-call yardstick, "
        f"bound {b_ms:.4f} ({b_by}); err {row['max_abs_err']:.3g} (rel "
        f"{row['max_rel_err']:.2e} <= {TOL_SSM})")


def _ssm_scan_bwd_case(rows, fwd_rows, b, s, di, gen, ds=16):
    """The scan's backward, the ``ssm_scan_bwd`` tunable (torch code: the
    chunk-windowed adjoint recurrence) at its heuristic chunk, against the
    ``ref.ssm_scan_bwd`` oracle (autograd through the sequential scan) on
    the same inputs, with the final state's cotangent zero as in training.
    Its time is recorded beside the forward kernel's at the same shape, not
    gated: host clock a call (it is paced by its launches) and the device
    time of the kernels one call launches."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss

    args = _ssm_inputs(gen, (b, s), di, ds, 0.0)
    cts = (torch.randn((b, s, di), generator=gen, device="cuda"),
           torch.zeros((b, di, ds), device="cuda"))
    cfg = ss.ssm_scan_bwd.default_config(*cts, *args)
    got = ss.ssm_scan_bwd(*cts, *args, **cfg)
    want = ref.ssm_scan_bwd(*cts, *args)
    names = ("d_xc", "d_dt", "d_B", "d_C", "d_A", "d_h0")
    errs = {n: rel_err(g, w) for n, g, w in zip(names, got, want)}
    del got, want
    # d_xc is bf16 on the oracle's side (xc's dtype): one bf16 rounding
    bad = {n: e[1] for n, e in errs.items() if e[1] > (TOL_BF16 if n == "d_xc" else TOL_SSM)}
    if bad:
        raise AssertionError(f"ssm_scan_bwd b={b} s={s} di={di} {cfg}: rel errs {bad}")
    call = lambda: ss.ssm_scan_bwd(*cts, *args, **cfg)
    ms = time_ms(call, iters=3, warmup=1)
    dev_ms = sum(device_split(call, iters=1).values())
    shape = f"b={b} s={s} di={di} ds={ds} xc bf16"
    fwd = next(r for r in fwd_rows if r["shape"] == shape)
    row = dict(shape=shape, config=cfg, ms=ms, device_ms=dev_ms, fwd_kernel_ms=fwd["ms"],
               max_rel_err={n: e[1] for n, e in errs.items()})
    rows.append(row)
    log(f"[kernels] ssm_scan_bwd (torch code) {shape} {cfg}: {ms:.3f} ms a call, "
        f"{dev_ms:.3f} ms of it device busy (torch.profiler); the forward kernel {fwd['ms']:.4f} "
        f"ms ({ms / fwd['ms']:.0f}x); vs the oracle, rel err " + ", ".join(
            f"{n} {e[1]:.2e}" for n, e in errs.items()) + f" (tol {TOL_SSM}, d_xc {TOL_BF16})")


def cold_ms(launch, reps: int = 20) -> float:
    """Median device time of one launch with L2 cold: a write of a 96 MB
    buffer (the L2 holds 50 MB) before each launch, CUDA events around the
    launch alone."""
    flush = torch.empty(24 * 2**20, dtype=torch.float32, device="cuda")
    times = []
    for _ in range(reps + 2):
        flush.fill_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[2:]))


def update_times(bare, call) -> dict:
    """ssm_update's launch times: the bare launch (its C entry on buffers
    allocated once) back to back, the state warm in L2 (``bare_ms``), and
    with L2 cold (``cold_ms``); the host time of one wrapper call
    (``host_us``)."""
    return {"bare_ms": time_ms(bare, iters=50), "cold_ms": cold_ms(bare),
            "host_us": host_us(call)}


def _ssm_update_case(prof, rows, b, di, gen, sfu, ds=16):
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan as ss

    args = _ssm_inputs(gen, (b,), di, ds, 0.3)
    heur = ss.ssm_update.default_config(*args)
    # the other legal config: two lanes a channel, one row a CTA
    other = dict(heur, lanes=2, block_b=1, block_d=128)
    p_y, p_h = ss.ssm_update_plain(*args)
    errs = []
    for cfg in (heur, other):
        if not ss.SSM_UPDATE_SPACE.is_valid(cfg):
            raise AssertionError(f"illegal ssm_update config {cfg}")
        y, hn = ss.ssm_update_cuda(*args, **cfg)
        torch.cuda.synchronize()
        errs.append(max(rel_err(y, p_y), rel_err(hn, p_h), key=lambda e: e[1]))
        if errs[-1][1] > TOL_SSM:
            raise AssertionError(f"ssm_update b={b} di={di} {cfg}: rel err "
                                 f"{errs[-1][1]:.3g} > {TOL_SSM}")
    ms = time_ms(lambda: ss.ssm_update_cuda(*args, **heur))
    ms_other = time_ms(lambda: ss.ssm_update_cuda(*args, **other))
    plain_ms = time_ms(lambda: ss.ssm_update_plain(*args))
    fn = _build.entry("ssm_scan", "repro_ssm_update", ss._UPDATE_ARGTYPES)
    y, hn = torch.empty_like(p_y), torch.empty_like(p_h)

    def bare(cfg):
        ptrs = [t.data_ptr() for t in (*args, y, hn)]
        launch_args = (*ptrs, b, di, ds, ss._DTYPES[args[0].dtype], cfg["block_b"],
                       cfg["block_d"], cfg["lanes"],
                       _build.stream_ptr(y.device))
        return update_times(lambda: fn(*launch_args), lambda: ss.ssm_update_cuda(*args, **cfg))

    t, t_other = bare(heur), bare(other)
    # xc bf16, dt, y [b,di]; B, C [b,ds]; A [di,ds]; h and h_new [b,di,ds]
    nbytes = b * di * (2 + 4 + 4) + b * ds * 8 + di * ds * 4 + 2 * b * di * ds * 4
    b_ms, b_by = _ssm_bound(prof, sfu, nbytes, b * di, ds)
    row = dict(shape=f"b={b} di={di} ds={ds} xc bf16", path="hybrid", config=heur, ms=ms,
               other_config=other, other_ms=ms_other, plain_ms=plain_ms, library_ms=None,
               bound_ms=b_ms, bound_by=b_by, **t, other_times=t_other,
               max_abs_err=max(e[0] for e in errs), max_rel_err=max(e[1] for e in errs))
    rows.append(row)
    log(f"[kernels] ssm_update {row['shape']}: {ms:.4f} ms a call {heur} ({ms_other:.4f} ms "
        f"{other}); bare launch {t['bare_ms']:.4f} ms warm in L2, {t['cold_ms']:.4f} ms cold "
        f"(other {t_other['bare_ms']:.4f}, {t_other['cold_ms']:.4f}); host time a call "
        f"{t['host_us']:.1f} us ({t_other['host_us']:.1f}); plain {plain_ms:.4f}, no one-call "
        f"yardstick, bound {b_ms:.4f} ({b_by}); err {row['max_abs_err']:.3g} (rel "
        f"{row['max_rel_err']:.2e} <= {TOL_SSM})")


def phase_kernels(prof, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, ff, kvd, vocab = 896, 4864, 128, 151936
    results = {k: [] for k in ("matmul", "rmsnorm", "rmsnorm_bwd", "softmax_xent",
                               "softmax_xent_bwd", "flash_attention", "flash_attention_bwd",
                               "matmul_bias_act", "rmsnorm_matmul", "ssm_scan", "ssm_update",
                               "expert_gemm", "ssm_scan_bwd")}
    # Serving: decode (m = 8 slots), the largest prefill bucket (m = 2048)
    # and the prefill unembed of the last position (m = 1).
    for m in (8, 2048):
        for k, n in ((d, d), (d, kvd), (d, ff), (ff, d), (d, vocab)):
            if m == 2048 and n == vocab:
                continue
            _matmul_case(prof, results["matmul"], m, k, n, gen, "serve")
    _matmul_case(prof, results["matmul"], 1, d, vocab, gen, "serve")
    # Training (batch 4 x 2048 = 8192 tokens, loss chunks of 2048 rows):
    # every layer gemm x[tok,k] @ w[k,n] (q/o, k/v, gate/up, down) and the
    # unembed chunk, each forward and with its two gradients on transposed
    # operands: dx = ct @ w^T (m=tok, k=n, n=k) and dw = x^T @ ct (m=k, k=tok).
    tok, rows = 8192, 2048
    for t, k, n in ((tok, d, d), (tok, d, kvd), (tok, d, ff), (tok, ff, d), (rows, d, vocab)):
        for m, kk, nn, ta, tb in ((t, k, n, False, False), (t, n, k, False, True),
                                  (k, t, n, True, False)):
            _matmul_case(prof, results["matmul"], m, kk, nn, gen, "train", ta=ta, tb=tb)
    for r, path in ((8, "serve"), (2048, "serve"), (tok, "train")):
        _rmsnorm_case(prof, results["rmsnorm"], r, d, gen, path)
    # the backward at the widths of the coming training slices too:
    # Mixtral's 4096 and Jamba's 8192 (which the first port refused)
    for r, dd in ((tok, d), (tok, 4096), (2048, 8192)):
        _rmsnorm_bwd_case(prof, results["rmsnorm_bwd"], r, dd, gen)
    _xent_cases(prof, results["softmax_xent"], results["softmax_xent_bwd"], rows, vocab, gen)
    for s in (16, 256, 2048):
        _flash_case(prof, results["flash_attention"], s, gen, "serve")
    _flash_case(prof, results["flash_attention"], 2048, gen, "train", b=4)
    _flash_bwd_case(prof, results["flash_attention_bwd"], 4, 2048, gen)
    # The fused sites: training's SwiGLU gate (silu, zero-bias site timed
    # with a bias), the other epilogues, a ragged shape; qwen's biased q
    # projection at decode rows; decode's final norm -> unembed, and a row
    # count that is not a multiple of 8.
    for m, n, act in ((tok, ff, "silu"), (tok, ff, "none"), (tok, ff, "gelu"),
                      (1000, 4860, "silu")):
        _mba_case(prof, results["matmul_bias_act"], m, d, n, act, gen, "train")
    _mba_case(prof, results["matmul_bias_act"], 8, d, d, "none", gen, "serve")
    # rmsnorm_matmul: the decode unembed of each served model (qwen2_0_5b,
    # also at a ragged 13 rows; Mixtral; Jamba, whose width the first port
    # could not launch), the 64-row pool on the tc route, a width TMA cannot
    # address (the WMMA loop) and fp32 at Jamba's width (the SIMT loop)
    for m in (8, 13):
        _rmm_case(prof, results["rmsnorm_matmul"], m, d, vocab, gen, "serve", want="decode")
    _rmm_case(prof, results["rmsnorm_matmul"], 8, 4096, 32000, gen, "moe", want="decode")
    _rmm_case(prof, results["rmsnorm_matmul"], 8, 8192, 65536, gen, "hybrid", want="decode")
    _rmm_case(prof, results["rmsnorm_matmul"], 64, d, vocab, gen, "serve", want="tc")
    _rmm_case(prof, results["rmsnorm_matmul"], 8, 900, 32000, gen, "serve", want="wmma")
    _rmm_case(prof, results["rmsnorm_matmul"], 8, 8192, 4096, gen, "hybrid",
              dtype=torch.float32, want="simt")
    # The hybrid (Jamba-1.5-Large: d_model 8192, d_inner 16384, dt_rank 512,
    # d_state 16, 64/8 heads of 128): the scan at the longest prefill and at
    # a ragged one whose d_inner no block_d divides, the decode update at
    # the 8-slot pool, attention at head dim 128 in groups of 8, and the
    # Mamba gemms at decode (m = 8) and prefill (m = 2048) rows: in_proj in
    # bf16, dt_proj and out_proj in fp32.
    sfu = sfu_rate(prof)
    log(f"[kernels] SFU exp2 rate {sfu / 1e12:.3f} T/s (16 a clock an SM at the maximum SM "
        f"clock)")
    _ssm_scan_case(prof, results["ssm_scan"], 1, 2048, 16384, gen, sfu, "tma")
    _ssm_scan_case(prof, results["ssm_scan"], 1, 1500, 16380, gen, sfu, "cpasync")
    # The hybrid-train phase's scan (batch 2 x 2048, d_inner 8192), and the
    # scan's backward at that shape and at Jamba's full width
    _ssm_scan_case(prof, results["ssm_scan"], 2, 2048, 8192, gen, sfu, "tma",
                   path="hybrid_train")
    for b, di_ in ((2, 8192), (1, 16384)):
        _ssm_scan_bwd_case(results["ssm_scan_bwd"], results["ssm_scan"], b, 2048, di_, gen)
    _ssm_update_case(prof, results["ssm_update"], 8, 16384, gen, sfu)
    _flash_case(prof, results["flash_attention"], 2048, gen, "hybrid", h=64, kvh=8, d=128)
    _flash_case(prof, results["flash_attention"], 1500, gen, "hybrid", h=64, kvh=8, d=128)
    flash_tile_latency(prof, sfu, gen)
    # The backward at head dim 128 in groups of 8 (Jamba's attention widths)
    # and with a window (Mixtral's widths): neither model trains here, so
    # the rows hold the kernel at those widths.
    _flash_bwd_case(prof, results["flash_attention_bwd"], 1, 2048, gen, h=64, kvh=8, d=128)
    _flash_bwd_case(prof, results["flash_attention_bwd"], 1, 4096, gen, h=32, kvh=8, d=128,
                    window=1024)
    dm, di, dtr = 8192, 16384, 512
    for m in (8, 2048):
        _matmul_case(prof, results["matmul"], m, dm, 2 * di, gen, "hybrid")
        _matmul_case(prof, results["matmul"], m, dtr, di, gen, "hybrid", dtype=torch.float32)
        _matmul_case(prof, results["matmul"], m, di, dm, gen, "hybrid", dtype=torch.float32)
        _rmsnorm_case(prof, results["rmsnorm"], m, dm, gen, "hybrid")
    # fp32 out_proj at a short prefill (256 rows: split over k), and its two
    # gradients for the coming hybrid training: dx = ct @ w^T, dw = x^T @ ct
    f32 = torch.float32
    _matmul_case(prof, results["matmul"], 256, di, dm, gen, "hybrid", dtype=f32)
    _matmul_case(prof, results["matmul"], 2048, dm, di, gen, "hybrid", tb=True, dtype=f32)
    _matmul_case(prof, results["matmul"], di, 2048, dm, gen, "hybrid", ta=True, dtype=f32)
    # Mixtral-8x7B (d_model 4096, 8 experts of width 14336 top-2, 32/8 heads
    # of 128, window 4096, vocab 32000): the expert gemms at the capacities
    # of the 8-slot pool (2), the 2048 and 8192 prefill buckets (640, 2560)
    # and a ragged 37, gate/up and down; the two gradient forms at 640; the
    # windowed attention of the 8192 bucket; projections and norms at decode
    # and prefill rows, and the decode unembed.
    E, dm, ff = 8, 4096, 14336
    for c in (2, 640, 2560):
        big = 5 if c == 2560 else 20
        _egemm_case(prof, results["expert_gemm"], E, c, dm, ff, gen, "moe", iters=big)
        _egemm_case(prof, results["expert_gemm"], E, c, ff, dm, gen, "moe", iters=big)
    _egemm_case(prof, results["expert_gemm"], E, 640, ff, dm, gen, "moe", form="ct@wT")
    _egemm_case(prof, results["expert_gemm"], E, dm, 640, ff, gen, "moe", form="xT@ct")
    _egemm_case(prof, results["expert_gemm"], E, 37, dm, ff, gen, "moe")
    _flash_case(prof, results["flash_attention"], 8192, gen, "moe", h=32, kvh=8, d=128,
                window=4096, iters=3)
    for m in (8, 8192):
        for k, n in ((dm, dm), (dm, 1024)):
            _matmul_case(prof, results["matmul"], m, k, n, gen, "moe")
        _rmsnorm_case(prof, results["rmsnorm"], m, dm, gen, "moe")
    _matmul_case(prof, results["matmul"], 8, dm, 32000, gen, "moe")
    # PaliGemma-3B's attention, 8 q heads of 256 on one kv head (the first
    # head dim above 128): its training step's b=2 x 2048 and a ragged
    # exact-length 1000, forward and backward.
    for b, s in ((2, 2048), (1, 1000)):
        _flash_case(prof, results["flash_attention"], s, gen, "paligemma_train", h=8, kvh=1,
                    d=256, b=b)
        _flash_bwd_case(prof, results["flash_attention_bwd"], b, s, gen, h=8, kvh=1, d=256,
                        path="paligemma_train")
    # Gemma3-27B (d_model 5376, d_ff 21504, 32/16 heads of 128, window 1024,
    # vocab 262,144): a 3000-token prefill's global and local attention, its
    # FFN gemm at decode rows, its norm at the 4096 bucket, and the decode
    # final norm -> unembed.
    for window in (0, 1024):
        _flash_case(prof, results["flash_attention"], 3000, gen, "gemma", h=32, kvh=16, d=128,
                    window=window, iters=5)
    _matmul_case(prof, results["matmul"], 8, 5376, 21504, gen, "gemma")
    _rmsnorm_case(prof, results["rmsnorm"], 4096, 5376, gen, "gemma")
    _rmm_case(prof, results["rmsnorm_matmul"], 8, 5376, 262144, gen, "gemma", want="decode")
    # Arctic's 128 experts of width 4864 at d_model 7168: the capacities of
    # the archs phase's 512-token prefill (10) and of a one-token decode (2).
    for c in (10, 2):
        _egemm_case(prof, results["expert_gemm"], 128, c, 7168, 4864, gen, "arctic", iters=5)
    xlstm_kernel_rows(prof, results, gen)
    gemm_host_cost(gen)
    return results


def xlstm_kernel_rows(prof, results, gen) -> None:
    """xLSTM-1.3B's rows (d_model 2048; mLSTM d_inner 4096, sLSTM GeGLU
    width 2752, 21.5 tiles of 128; vocab 50,304): the sLSTM MLP's up_g /
    up_u (n = 2752) at the longest prefill's 2048 rows and the pool's 8, its
    down projection (k = 2752), the mLSTM's fp32 out_proj at prefill rows
    (gemm_simt) and at the pool's (gemm_simt_rows); the training step's
    (4 x 512 tokens) up_g gradients, norm, norm backward and loss chunk."""
    for m in (2048, 8):
        _matmul_case(prof, results["matmul"], m, 2048, 2752, gen, "xlstm")
    _matmul_case(prof, results["matmul"], 2048, 2752, 2048, gen, "xlstm")
    for m in (2048, 8):
        _matmul_case(prof, results["matmul"], m, 4096, 2048, gen, "xlstm", dtype=torch.float32)
    _matmul_case(prof, results["matmul"], 2048, 2752, 2048, gen, "xlstm", tb=True)
    _matmul_case(prof, results["matmul"], 2048, 2048, 2752, gen, "xlstm", ta=True)
    for r in (8, 2048):
        _rmsnorm_case(prof, results["rmsnorm"], r, 2048, gen, "xlstm")
    _rmsnorm_bwd_case(prof, results["rmsnorm_bwd"], 2048, 2048, gen, path="xlstm")
    _xent_cases(prof, results["softmax_xent"], results["softmax_xent_bwd"], 2048, 50304, gen,
                path="xlstm")


def profile(label: str, step, steps: int, wall_ms=None):
    """Where a step's time goes: torch.profiler (device activity only) over
    a steady window gives the device time by kernel; the device's idle share
    is taken against the host-clock step timed without the profiler (timed
    here, or ``wall_ms`` when the caller timed it), whose own host cost
    would otherwise count as idle time. Returns (device ms a step by kernel,
    busy ms a step)."""
    if wall_ms is None:
        step()
        step()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = device_ms(prof, steps)
    if not by_name:
        raise AssertionError(f"torch.profiler saw no device time in the {label} window")
    busy = sum(by_name.values())
    n_events = len(prof.profiler.kineto_results.events())
    tree = (f"; key_averages() {tree_device_ms(prof, steps):.2f}" if n_events <= TREE_EVENTS
            else "")
    log(f"[profile] {label}: {wall_ms:.2f} ms host clock ({prof_wall_ms:.2f} ms under the "
        f"profiler), {busy:.2f} ms device busy, device idle {100 * (1 - busy / wall_ms):.1f}% "
        f"(torch.profiler, {steps} steps; {n_events} events, device ms a step by their sum "
        f"{busy:.2f}{tree})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[profile]   {ms:8.3f} ms/step {100 * ms / max(busy, 1e-9):5.1f}%  {name[:90]}")
    return by_name, busy


def kernel_share(label: str, by_name: dict, busy: float, kernel: str, marks) -> None:
    """One kernel's device time a step in a profile (every CUDA kernel whose
    name holds one of ``marks``), and its share of the device's busy time."""
    ms = sum(v for k, v in by_name.items() if any(m in k for m in marks))
    if ms <= 0:
        raise AssertionError(f"{label}: torch.profiler saw no {kernel} kernel")
    log(f"[profile] {label}: {kernel} {ms:.4f} ms/step device time, "
        f"{100 * ms / max(busy, 1e-9):.2f}% of {busy:.2f} ms busy")


def profile_serving(params, cfg, run, ecfg) -> None:
    """A full-pool decode step (8 slots at staggered positions) and a prefill
    of the largest bucket (1500 real tokens in 2048)."""
    from repro_torch.models import lm

    B = ecfg.max_batch
    caches = lm.init_cache(cfg, B, ecfg.max_seq, "cuda")
    tokens = torch.zeros((B, 1), dtype=torch.long, device="cuda")
    pos = torch.arange(B, device="cuda") * 200 + 50
    prompt = torch.zeros((1, 2048), dtype=torch.long, device="cuda")

    def decode():
        with torch.inference_mode():
            lm.decode_step(params, tokens, caches, pos, cfg, run)[0].float().cpu()

    def prefill():
        with torch.inference_mode():
            lm.prefill(params, {"tokens": prompt}, cfg, run, cache_len=ecfg.max_seq,
                       true_len=1500)[0].float().cpu()

    profile("decode step (8 slots)", decode, 10)
    profile("prefill bucket 2048", prefill, 3)


def phase_serve(seed: int):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import runtime
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    cfg = get_config("qwen2_0_5b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = lm.param_count(params)
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e6:.1f} M params {cfg.dtype}, init {time.perf_counter() - t0:.1f} s")
    ecfg = EngineConfig(max_batch=8, max_seq=2048)
    run = RunConfig()
    lengths = [16, 1500, 23, 700, 40, 1300, 64, 1024, 100, 900, 130, 512, 200, 400, 256, 300]
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]

    def requests(greedy_only=False):
        out = []
        for i, p in enumerate(prompts):
            if greedy_only and i % 2:
                continue
            out.append(Request(prompt=p, max_new_tokens=32,
                               temperature=0.0 if i % 2 == 0 else 0.8,
                               seed=seed + i, arrival_time=float(2 * i)))
        return out

    rt = runtime(name="serve")
    engine = ServingEngine(cfg, run, params, ecfg, runtime=rt)
    reqs = requests()
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    snap = rt.telemetry.snapshot()
    log(f"[serve] launches during serving: {launches}")
    log(f"[serve] telemetry tiers: {snap['tiers']} over {snap['calls']} dispatches")
    missing = [k for k in SERVE_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    if snap["tiers"].get("reference", 0):
        raise AssertionError(f"{snap['tiers']['reference']} dispatches fell to the reference tier")
    check_routes(launches, "serve")
    for r in done:
        out = r.output
        if out is None or len(out) != 32 or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"bad output for a {len(r.prompt)}-token prompt: {out}")

    st = engine.stats
    tok_s = st["tokens_out"] / wall
    log(f"[serve] served {len(done)} requests, {st['tokens_out']} tokens in {wall:.2f} s: "
        f"{tok_s:.1f} tokens/s; {st['decode_steps']} decode steps, {st['prefill_calls']} prefills")
    for b in sorted(engine.timings["prefill_s"]):
        ts = engine.timings["prefill_s"][b]
        log(f"[serve] prefill bucket {b}: {1e3 * float(np.median(ts)):.2f} ms median of {len(ts)}")
    dec = engine.timings["decode_s"]
    log(f"[serve] decode step (8 slots): {1e3 * float(np.median(dec)):.2f} ms median of "
        f"{len(dec)} (p90 {1e3 * float(np.percentile(dec, 90)):.2f} ms)")
    w_bytes = (n_params - params["embed"]["table"].numel()) * params["lm_head"]["w"].element_size()
    log(f"[serve] computed floor of a decode step: {w_bytes / 1e9:.3f} GB of weights / "
        f"3.35 TB/s = {w_bytes / 3.35e12 * 1e3:.3f} ms (computed, not measured)")
    log(f"[serve] peak memory allocated: {peak / 2**30:.2f} GiB")

    profile_serving(params, cfg, run, ecfg)

    # One prefill, kernel path vs plain (reference-mode) path on the card.
    probe = prompts[lengths.index(300)]
    toks = torch.zeros((1, 512), dtype=torch.long, device="cuda")
    toks[0, :300] = torch.from_numpy(probe.astype(np.int64))
    logits = {}
    with torch.inference_mode():
        for mode in ("kernel", "reference"):
            with runtime(mode=mode):
                logits[mode], _ = lm.prefill(params, {"tokens": toks}, cfg, run,
                                             cache_len=2048, true_len=300)
    lk, lr = logits["kernel"].float(), logits["reference"].float()
    if not (torch.isfinite(lk).all() and lk.shape == (1, cfg.vocab_size)):
        raise AssertionError(f"kernel-path logits not finite / shape {tuple(lk.shape)}")
    abs_err, rel = rel_err(lk, lr)
    log(f"[serve] prefill logits (300 tokens, bucket 512) kernel vs plain path: max abs "
        f"{abs_err:.4g}, rel to max|plain| {rel:.3e} (tol {TOL_LOGITS}); argmax "
        f"{int(lk.argmax())} vs {int(lr.argmax())}")
    if rel > TOL_LOGITS:
        raise AssertionError(f"prefill logits differ: rel {rel:.3g} > {TOL_LOGITS}")

    # Greedy tokens of the plain path, for the agreement share.
    ref_engine = ServingEngine(cfg, run, params, ecfg, runtime=runtime(mode="reference"))
    for r in requests(greedy_only=True):
        ref_engine.submit(r)
    ref_out = {len(r.prompt): r.output for r in ref_engine.serve()}
    agree = total = 0
    for r in done:
        if r.temperature == 0:
            ref = ref_out[len(r.prompt)]
            agree += int((ref == r.output).sum())
            total += len(ref)
    log(f"[serve] greedy tokens equal on both paths: {agree}/{total} = {agree / total:.3f}")
    return launches


# Runtimes and engines the faults phase demotes on purpose: the health
# check after each phase passes over them.
FAULTED = weakref.WeakSet()
# The faults phase's mix: 8 requests of 16..512 tokens, 16 new each, greedy.
FAULT_LENGTHS = (16, 512, 37, 300, 64, 200, 129, 400)
# Events a faults-phase collector keeps: a served mix's dispatch spans
# (about 5,700) would push its warnings out of the default ring of 4,096.
FAULT_EVENTS = 1 << 16


def health_check(phase: str) -> None:
    """No demotion hides: the process-default collector holds no quarantine
    or degradation warning, and no live runtime or engine (but the faults
    phase's) is quarantined or degraded."""
    from repro_torch import obs
    from repro_torch.core.runtime import TunedRuntime
    from repro_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    warns = [f"{w['name']} [{w.get('key')}] {w.get('error', '')}"
             for w in obs.current_collector().events("warning")
             if w["name"] in ("dispatch.quarantine", "serve.degraded")]
    sick = []       # uncollected garbage counts too: it was quarantined all the same
    for o in gc.get_objects():
        kind = type(o)         # not isinstance: some lazy modules warn on __class__
        if kind is TunedRuntime and len(o.health) and o not in FAULTED:
            sick.append(f"runtime {o.name}: {o.health.snapshot()}")
        elif kind is ServingEngine and o.degraded and o not in FAULTED:
            sick.append(f"a degraded engine ({o.stats['degraded_calls']} calls)")
    if warns or sick:
        raise AssertionError(f"after phase {phase}: {warns + sick}")
    log(f"[health] phase {phase}: no quarantine, no degraded engine "
        f"({time.perf_counter() - t0:.2f} s)")


@contextlib.contextmanager
def prefill_logits(into: list):
    """Records the logits of every ``lm.prefill`` call while active (the
    engines call it through the module)."""
    from repro_torch.models import lm

    orig = lm.prefill

    def rec(*a, **k):
        logits, caches = orig(*a, **k)
        into.append(logits.float().clone())
        return logits, caches

    lm.prefill = rec
    try:
        yield into
    finally:
        lm.prefill = orig


def phase_faults(seed: int):
    """The fault plane on qwen2_0_5b at full width: the guard, degraded and
    lock-step serving, and the obs plane (the module docstring's list)."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.annotate import get_tunable
    from repro_torch.core.database import Record, TuningDatabase
    from repro_torch.core.runtime import HealthBook, dispatch, runtime
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig
    from repro_torch.obs.export import load_snapshot
    from repro_torch.obs.metrics import percentile_row
    from repro_torch.serving.engine import EngineConfig, LockStepEngine, Request, ServingEngine
    from repro_torch.testing import FaultPlan, FaultRule

    tag = "faults"
    cfg = get_config("qwen2_0_5b")
    params = lm.init_params(cfg, seed=seed, device="cuda")
    ecfg = EngineConfig(max_batch=8, max_seq=2048)
    run = RunConfig()
    rs = np.random.RandomState(seed + 26)
    prompts = [rs.randint(0, cfg.vocab_size, n).astype(np.int32) for n in FAULT_LENGTHS]
    serving = ("matmul", "rmsnorm", "flash_attention")

    def serve(rt, plan=None, col=None, engine=None):
        eng = engine or ServingEngine(cfg, run, params, ecfg, runtime=rt)
        for i, p in enumerate(prompts):
            eng.submit(Request(prompt=p, max_new_tokens=16, seed=seed + i))
        with (col or contextlib.nullcontext()), (plan or contextlib.nullcontext()):
            done = eng.serve()
        torch.cuda.synchronize()
        if len(done) != len(prompts) or any(r.output is None or len(r.output) != 16
                                            for r in done):
            raise AssertionError(f"[{tag}] a request was lost or cut short")
        return [r.output.tolist() for r in done], eng

    probe_prompt = torch.from_numpy(prompts[3].astype(np.int64)).cuda()[None]

    def probe_logits(rt, plan=None, col=None):
        """A 300-token prefill in all 8 slots, then one decode step of the
        pool (its q projection is the [8,896]@[896,896] bucket): the step's
        logits, fp32."""
        pool = lm.init_cache(cfg, 8, ecfg.max_seq, "cuda")
        toks = torch.zeros((1, 512), dtype=torch.long, device="cuda")
        toks[:, :300] = probe_prompt
        with (col or contextlib.nullcontext()), (plan or contextlib.nullcontext()), rt, \
                torch.inference_mode():
            _, cache = lm.prefill(params, {"tokens": toks}, cfg, run, cache_len=ecfg.max_seq,
                                  true_len=300)
            for slot in range(8):
                lm.insert_cache(pool, cache, slot)
            nxt = torch.full((8, 1), int(prompts[0][0]), dtype=torch.long, device="cuda")
            logits, _ = lm.decode_step(params, nxt, pool, torch.full((8,), 300, device="cuda"),
                                       cfg, run)
            return logits.float()

    def quarantine_warnings(col):
        return [w for w in col.events("warning") if w["name"] == "dispatch.quarantine"]

    # (a) baselines
    rt_k = runtime(name="faults-kernel")
    t_k, _ = serve(rt_k)
    t_r, _ = serve(runtime(mode="reference", name="faults-reference"))
    logits_a = probe_logits(rt_k)
    same = sum(a == b for x, y in zip(t_k, t_r) for a, b in zip(x, y))
    log(f"[{tag}] (a) guarded kernel engine T_k and reference engine T_r: {len(t_k)} requests "
        f"of {list(FAULT_LENGTHS)} tokens, 16 new each; {same}/{16 * len(t_k)} tokens equal; "
        f"kernel telemetry tiers {rt_k.telemetry.tiers}")
    if rt_k.telemetry.tiers.get("reference", 0) or len(rt_k.health):
        raise AssertionError(f"[{tag}] (a) the fault-free engine left the kernel path")

    # (b) every serving tunable faulted under the guard
    rt_b = runtime(name="faults-guarded")
    FAULTED.add(rt_b)
    plan_b = FaultPlan([FaultRule(site="dispatch.kernel:*")], seed=seed, name="every-tunable")
    col_b = obs.collect(name="faults-b", max_events=FAULT_EVENTS)
    t_b, _ = serve(rt_b, plan_b, col_b)
    fired = {s.split(":", 1)[1] for s, _, _ in plan_b.fired}
    health = rt_b.health.snapshot()
    quarantined = {k.split("|")[0] for k, h in health.items() if h["level"] == "kernel"}
    warns = quarantine_warnings(col_b)
    with tempfile.TemporaryDirectory() as d:
        col_b.write_prom(os.path.join(d, "faults.prom"))
        prom = open(os.path.join(d, "faults.prom")).read()
    n_quar = sum(r["value"] for r in col_b.snapshot()["counters"].get("dispatch.quarantine", []))
    log(f"[{tag}] (b) every tunable faulted, guard on: tokens equal T_r: {t_b == t_r}; fired "
        f"{len(plan_b.fired)} times on {sorted(fired)}; {len(health)} keys quarantined, levels "
        f"{sorted({h['level'] for h in health.values()})}; {len(warns)} warnings, "
        f"{n_quar:g} quarantines counted; tiers "
        f"{rt_b.telemetry.tiers}; Prometheus export holds dispatch_quarantine: "
        f"{'repro_dispatch_quarantine' in prom}")
    if t_b != t_r:
        raise AssertionError(f"[{tag}] (b) the faulted guarded engine's tokens differ from T_r")
    if not (fired == quarantined == set(serving)) or any(
            h["level"] != "kernel" for h in health.values()):
        raise AssertionError(f"[{tag}] (b) fired {fired}, quarantined {health}")
    if not warns or not all("InjectedFault" in w["error"] for w in warns):
        raise AssertionError(f"[{tag}] (b) quarantine warnings {warns}")
    if "repro_dispatch_quarantine" not in prom:
        raise AssertionError(f"[{tag}] (b) the Prometheus export lacks dispatch.quarantine")

    # (c) one stored record faults once
    mm = get_tunable("matmul")
    # the key needs shapes, dtypes and the device only
    qx = torch.empty((8, cfg.d_model), dtype=torch.bfloat16, device="cuda")
    qw = torch.empty((cfg.d_model, cfg.num_heads * cfg.hd), dtype=torch.bfloat16, device="cuda")
    cargs, _ = mm.dispatch.canon((qx, qw))
    db = TuningDatabase(None)
    rt_c = runtime(db=db, name="faults-record")
    rt_c.health = HealthBook(base_s=300.0)      # read before a probe could heal it
    FAULTED.add(rt_c)
    key = rt_c.key_for(mm, cargs)
    heur = mm.default_config(*cargs)
    legal = [c for c in mm.space.enumerate() if c != heur and mm.why_illegal(c, *cargs) is None]
    rec = min(legal, key=lambda c: sum(c[k] != heur[k] for k in heur))
    db.put(Record(key=key, config=rec, objective=1e-6, evaluator="wallclock", evaluations=1,
                  timestamp=time.time()), save=False)
    plan_c = FaultPlan([FaultRule(site="dispatch.kernel:matmul", when={"tier": "exact"},
                                  times=1)], seed=seed, name="one-record")
    logits_c = probe_logits(rt_c, plan_c, obs.collect(name="faults-c", max_events=FAULT_EVENTS))
    health = rt_c.health.snapshot()
    by_key = rt_c.telemetry.by_key
    others = {k: v for k, v in by_key.items() if k != key and "reference" in v}
    _, rel_c = rel_err(logits_c, logits_a)
    log(f"[{tag}] (c) record {rec} (heuristic {heur}) for {key} faulted once: health "
        f"{health}; its telemetry {by_key.get(key)}; {len(by_key) - 1} other keys, "
        f"{len(others)} of them on the reference; decode logits rel to (a)'s {rel_c:.3e} "
        f"(tol {TOL_LOGITS})")
    if list(health) != [key] or health[key]["level"] != "record":
        raise AssertionError(f"[{tag}] (c) health book {health}")
    if by_key.get(key, {}).get("heuristic", 0) <= 0 or "reference" in by_key.get(key, {}):
        raise AssertionError(f"[{tag}] (c) the faulted bucket's telemetry {by_key.get(key)}")
    if others or len(plan_c.fired) != 1:
        raise AssertionError(f"[{tag}] (c) other buckets left the kernel tiers: {others}")
    if rel_c > TOL_LOGITS:
        raise AssertionError(f"[{tag}] (c) logits rel {rel_c:.3g} > {TOL_LOGITS}")

    # (d) a NaN probe
    rt_d = runtime(guard_nonfinite=True, name="faults-nan")
    FAULTED.add(rt_d)
    plan_d = FaultPlan([FaultRule(site="dispatch.kernel:rmsnorm", kind="nan", times=1)],
                       seed=seed, name="nan")
    col_d = obs.collect(name="faults-d", max_events=FAULT_EVENTS)
    logits_d = probe_logits(rt_d, plan_d, col_d)
    health = rt_d.health.snapshot()
    finite = bool(torch.isfinite(logits_d).all())
    _, rel_d = rel_err(logits_d, logits_a)
    warns = quarantine_warnings(col_d)
    log(f"[{tag}] (d) NaN probe on rmsnorm: fired {plan_d.fired}; health {health}; logits "
        f"finite {finite}, rel to (a)'s {rel_d:.3e} (tol {TOL_LOGITS}); warning "
        f"{[w['error'] for w in warns]}")
    if not (len(health) == 1 and all(k.startswith("rmsnorm|") and h["level"] == "kernel"
                                     for k, h in health.items())):
        raise AssertionError(f"[{tag}] (d) health book {health}")
    if not finite or rel_d > TOL_LOGITS or not any("DispatchFault" in w["error"] for w in warns):
        raise AssertionError(f"[{tag}] (d) finite {finite}, rel {rel_d:.3g}, warnings {warns}")

    # (e) the unguarded engine
    rt_e = runtime(guard=False, name="faults-unguarded")
    plan_e = FaultPlan([FaultRule(site="dispatch.kernel:*", times=1)], seed=seed,
                       name="first-dispatch")
    col_e = obs.collect(name="faults-e", max_events=FAULT_EVENTS)
    eng_e = ServingEngine(cfg, run, params, ecfg, runtime=rt_e)
    FAULTED.add(eng_e)
    t_e, _ = serve(rt_e, plan_e, col_e, engine=eng_e)
    degraded, calls = eng_e.degraded, eng_e.stats["degraded_calls"]
    warned = [w["key"] for w in col_e.events("warning") if w["name"] == "serve.degraded"]
    eng_e.reset_degraded()
    t_e2, _ = serve(rt_e, engine=eng_e)
    log(f"[{tag}] (e) unguarded, faulted at its first dispatch ({plan_e.fired}): degraded "
        f"{degraded}, {calls} degraded calls, warnings {warned}; tokens equal T_r: "
        f"{t_e == t_r}; re-armed: tokens equal T_k: {t_e2 == t_k}, degraded calls "
        f"{eng_e.stats['degraded_calls']}")
    if not degraded or calls <= 0 or not warned or t_e != t_r:
        raise AssertionError(f"[{tag}] (e) the degraded engine: degraded {degraded}, calls "
                             f"{calls}, warnings {warned}, tokens equal T_r {t_e == t_r}")
    if t_e2 != t_k or eng_e.stats["degraded_calls"] != calls or eng_e.degraded:
        raise AssertionError(f"[{tag}] (e) re-armed, the engine did not serve T_k on kernels")

    # (f) LockStepEngine against the slot pool, 8 prompts of one length
    same_len = [rs.randint(0, cfg.vocab_size, 256).astype(np.int32) for _ in range(8)]
    lock_logits, pool_logits = [], []
    lock = LockStepEngine(cfg, run, params, ecfg)
    pool_eng = ServingEngine(cfg, run, params, ecfg, runtime=rt_k)
    outs = {}
    for name, eng, into in (("lock", lock, lock_logits), ("pool", pool_eng, pool_logits)):
        for i, p in enumerate(same_len):
            eng.submit(Request(prompt=p, max_new_tokens=16, seed=seed + i))
        with prefill_logits(into), rt_k:
            outs[name] = [r.output.tolist() for r in eng.serve()]
    first_lock = lock_logits[0]
    first_pool = torch.cat(pool_logits)
    _, rel_f = rel_err(first_lock, first_pool)
    agree = sum(a == b for x, y in zip(outs["lock"], outs["pool"]) for a, b in zip(x, y))
    log(f"[{tag}] (f) LockStepEngine: {lock.stats['decode_steps']} decode steps, the slot pool "
        f"{pool_eng.stats['decode_steps']} on the same 8 x 256-token mix; first-token logits "
        f"rel {rel_f:.3e} (tol {TOL_LOGITS}); tokens equal {agree}/{16 * 8}")
    if rel_f > TOL_LOGITS:
        raise AssertionError(f"[{tag}] (f) first-token logits rel {rel_f:.3g} > {TOL_LOGITS}")

    # (g) obs inside a torch.profiler window
    col_g = obs.collect(name="faults-g", profiler_annotations=True,
                          max_events=FAULT_EVENTS)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t_g, _ = serve(rt_k, col=col_g)
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    snap = col_g.snapshot()
    lat = percentile_row(snap, "serve.latency_s")
    by_tier = {}
    for r in snap["counters"].get("dispatch.calls", []):
        by_tier[r["tags"]["tier"]] = by_tier.get(r["tags"]["tier"], 0) + r["value"]
    n_spans = sum(r["count"] for n, rows in snap["histograms"].items() if n.startswith("span.")
                  for r in rows)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "metrics.json")
        col_g.write(path)
        loaded = load_snapshot(path)
    trip = loaded["counters"] == snap["counters"] and loaded["histograms"] == snap["histograms"]
    log(f"[{tag}] (g) obs: serve.latency_s p50 {lat['p50'] * 1e3:.2f} ms p99 "
        f"{lat['p99'] * 1e3:.2f} ms (n={lat['count']}); dispatch.calls by tier {by_tier}; "
        f"{n_spans} spans ({len(col_g.events('span'))} in the ring); serve.admit among the "
        f"profiler's named ranges: {'serve.admit' in names}; snapshot JSON round trip equal: "
        f"{trip}; tokens equal T_k: {t_g == t_k}")
    if "serve.admit" not in names or not trip or not lat or lat["count"] != len(prompts):
        raise AssertionError(f"[{tag}] (g) the obs plane: serve.admit ranged "
                             f"{'serve.admit' in names}, round trip {trip}, latency {lat}")

    # the guard's and the collector's host cost, interleaved: a decode step
    # of the pool (host-bound, so its spread is wide), and one dispatch of
    # the decode q projection's bucket (host-bound too: 2,000 calls a turn)
    pool = lm.init_cache(cfg, 8, ecfg.max_seq, "cuda")
    tokens = torch.zeros((8, 1), dtype=torch.long, device="cuda")
    pos = torch.arange(8, device="cuda") * 200 + 50
    qx = torch.randn((8, cfg.d_model), device="cuda").to(torch.bfloat16)
    qw = torch.randn((cfg.d_model, cfg.d_model), device="cuda").to(torch.bfloat16)
    rt_off = runtime(guard=False, name="faults-guard-off")
    variants = {"guard on, no collector": (rt_k, None),
                "guard off, no collector": (rt_off, None),
                "guard on, collector disabled": (rt_k, False),
                "guard on, collector enabled": (rt_k, True)}
    step_ms = {v: [] for v in variants}
    call_us = {v: [] for v in variants}
    for _ in range(3):
        for v, (rt, on) in variants.items():
            scope = contextlib.nullcontext() if on is None else obs.collect(enabled=on)
            with scope, rt, torch.inference_mode():
                for i in range(7):
                    t0 = time.perf_counter()
                    lm.decode_step(params, tokens, pool, pos, cfg, run)[0].float().cpu()
                    if i:
                        step_ms[v].append((time.perf_counter() - t0) * 1e3)
                dispatch("matmul", qx, qw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(2000):
                    dispatch("matmul", qx, qw)
                torch.cuda.synchronize()
                call_us[v].append((time.perf_counter() - t0) * 1e6 / 2000)
    med = {v: float(np.median(t)) for v, t in step_ms.items()}
    per = {v: float(np.median(t)) for v, t in call_us.items()}
    n_disp = cfg.num_layers * 9 + 2
    on, off = per["guard on, no collector"], per["guard off, no collector"]
    log(f"[{tag}] decode step (8 slots) host clock, median of {len(step_ms[v])} in turns: "
        + "; ".join(f"{v} {ms:.2f} ms" for v, ms in med.items()))
    d = cfg.d_model
    log(f"[{tag}] one matmul dispatch [8,{d}]@[{d},{d}], host clock, median of 3 turns of "
        f"2,000: " + "; ".join(f"{v} {us:.2f} us" for v, us in per.items()))
    log(f"[{tag}] the guard's host cost: {on - off:+.2f} us a dispatch, x {n_disp} dispatches = "
        f"{(on - off) * n_disp / 1e3:+.3f} ms a decode step (steps: "
        f"{med['guard on, no collector'] - med['guard off, no collector']:+.2f} ms); the "
        f"collector's: disabled {per['guard on, collector disabled'] - on:+.2f} us a dispatch, "
        f"enabled {per['guard on, collector enabled'] - on:+.2f} us (steps: disabled "
        f"{med['guard on, collector disabled'] - med['guard on, no collector']:+.2f} ms, "
        f"enabled {med['guard on, collector enabled'] - med['guard on, no collector']:+.2f} ms)")


HYBRID_LENGTHS = (16, 1500, 37, 700, 129, 1024, 300, 8)


def phase_hybrid(seed: int):
    """Serve full-width Jamba-1.5-Large without experts, one super-block."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import runtime
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    cfg = dataclasses.replace(get_config("jamba_1_5_large"), num_experts=0,
                              experts_per_token=0, num_layers=8)
    n_mamba = sum(spec.mixer == "mamba" for seg in cfg.segments() for spec in seg.pattern)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = lm.param_count(params)
    log(f"[hybrid] {cfg.name} without experts: {cfg.num_layers} layers (1 attention + "
        f"{n_mamba} Mamba), d_model {cfg.d_model}, d_inner {cfg.mamba_expand * cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params {cfg.dtype}, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ecfg = EngineConfig(max_batch=8, max_seq=2048)
    run = RunConfig()
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, cfg.vocab_size, n).astype(np.int32) for n in HYBRID_LENGTHS]

    def requests(greedy_only=False):
        return [Request(prompt=p, max_new_tokens=16, temperature=0.0 if i % 2 == 0 else 0.8,
                        seed=seed + i, arrival_time=float(2 * i))
                for i, p in enumerate(prompts) if not (greedy_only and i % 2)]

    rt = runtime(name="hybrid")
    engine = ServingEngine(cfg, run, params, ecfg, runtime=rt)
    for r in requests():
        engine.submit(r)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = engine.stats
    snap = rt.telemetry.snapshot()
    log(f"[hybrid] launches during serving: {launches}")
    log(f"[hybrid] telemetry tiers: {snap['tiers']} over {snap['calls']} dispatches")
    missing = [k for k in HYBRID_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the hybrid path: {missing}")
    if snap["tiers"].get("reference", 0):
        raise AssertionError(f"{snap['tiers']['reference']} dispatches fell to the reference tier")
    check_routes(launches, "hybrid", want=("tc", "decode", "simt"))
    # every fp32 prefill gemm of more than 16 rows (each Mamba layer's
    # dt_proj and out_proj) ran the register-tiled kernel, by its own
    # counter; decode steps and the short prompts took the row kernel
    from repro_torch.kernels.matmul import DECODE_ROWS

    long_prefills = sum(n > DECODE_ROWS for n in HYBRID_LENGTHS)
    f32 = {k: launches.get(f"matmul_simt_{k}", 0) for k in ("tile", "rows", "loop")}
    if (f32["tile"] != 2 * n_mamba * long_prefills or f32["loop"]
            or f32["tile"] + f32["rows"] != launches.get("matmul_simt", 0)):
        raise AssertionError(f"fp32 gemms by kernel {f32}: expected {2 * n_mamba} "
                             f"simt_tile launches for each of {long_prefills} prefills of "
                             f"more than {DECODE_ROWS} tokens, none on the loop: {launches}")
    log(f"[hybrid] fp32 gemms by kernel: simt_tile {f32['tile']} = 2 x {n_mamba} x "
        f"{long_prefills} prefills of more than {DECODE_ROWS} tokens, simt_rows {f32['rows']}, "
        f"simt_loop 0")
    want = {"ssm_scan": n_mamba * st["prefill_calls"], "ssm_update": n_mamba * st["decode_steps"]}
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"expected {n_mamba} ssm_scan launches a prefill and {n_mamba} "
                             f"ssm_update launches a decode step: {want}, counted {got}")
    if st["prefill_tokens"] != sum(HYBRID_LENGTHS):
        raise AssertionError(f"prefill tokens {st['prefill_tokens']}: not at exact length")
    for r in done:
        out = r.output
        if out is None or len(out) != 16 or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"bad output for a {len(r.prompt)}-token prompt: {out}")
    tok_s = st["tokens_out"] / wall
    log(f"[hybrid] served {len(done)} requests, {st['tokens_out']} tokens in {wall:.2f} s: "
        f"{tok_s:.1f} tokens/s; {st['decode_steps']} decode steps, {st['prefill_calls']} "
        f"prefills of {st['prefill_tokens']} tokens (exact length); ssm_scan {got['ssm_scan']} "
        f"= {n_mamba} x {st['prefill_calls']}, ssm_update {got['ssm_update']} = {n_mamba} x "
        f"{st['decode_steps']}")
    for L in sorted(engine.timings["prefill_s"]):
        ts = engine.timings["prefill_s"][L]
        log(f"[hybrid] prefill {L} tokens: {1e3 * float(np.median(ts)):.2f} ms")
    dec = engine.timings["decode_s"]
    log(f"[hybrid] decode step (8 slots): {1e3 * float(np.median(dec)):.2f} ms median of "
        f"{len(dec)} (p90 {1e3 * float(np.percentile(dec, 90)):.2f} ms)")
    w_bytes = (n_params - params["embed"]["table"].numel()) * 2
    log(f"[hybrid] computed floor of a decode step: {w_bytes / 1e9:.3f} GB of weights / "
        f"3.35 TB/s = {w_bytes / 3.35e12 * 1e3:.3f} ms (computed, not measured)")
    log(f"[hybrid] peak memory allocated: {peak / 2**30:.2f} GiB")

    probe = prompts[HYBRID_LENGTHS.index(1500)]
    toks = torch.from_numpy(probe.astype(np.int64))[None].cuda()
    caches = lm.init_cache(cfg, ecfg.max_batch, ecfg.max_seq, "cuda")
    tokens = torch.zeros((ecfg.max_batch, 1), dtype=torch.long, device="cuda")
    pos = torch.arange(ecfg.max_batch, device="cuda") * 200 + 50

    def decode():
        with torch.inference_mode():
            lm.decode_step(params, tokens, caches, pos, cfg, run)[0].float().cpu()

    def prefill():
        with torch.inference_mode():
            lm.prefill(params, {"tokens": toks}, cfg, run, cache_len=ecfg.max_seq,
                       true_len=1500)[0].float().cpu()

    by_name, busy = profile("hybrid decode step (8 slots)", decode, 5)
    kernel_share("hybrid decode step", by_name, busy, "ssm_update", ("ssm_update_kernel",))
    by_name, busy = profile("hybrid prefill 1500 tokens", prefill, 2)
    kernel_share("hybrid prefill 1500 tokens", by_name, busy, "ssm_scan", ("ssm_scan_ws",))
    kernel_share("hybrid prefill 1500 tokens", by_name, busy, "the fp32 route (every simt kernel)",
                 ("gemm_simt",))
    kernel_share("hybrid prefill 1500 tokens", by_name, busy, "gemm_simt (register tiles)",
                 ("gemm_simt<",))
    del caches

    logits = {}
    with torch.inference_mode():
        for mode in ("kernel", "reference"):
            with runtime(mode=mode):
                logits[mode], _ = lm.prefill(params, {"tokens": toks}, cfg, run,
                                             cache_len=ecfg.max_seq, true_len=1500)
    lk, lr = logits["kernel"].float(), logits["reference"].float()
    if not (torch.isfinite(lk).all() and lk.shape == (1, cfg.vocab_size)):
        raise AssertionError(f"kernel-path logits not finite / shape {tuple(lk.shape)}")
    abs_err, rel = rel_err(lk, lr)
    log(f"[hybrid] prefill logits (1500 tokens) kernel vs plain path: max abs {abs_err:.4g}, "
        f"rel to max|plain| {rel:.3e} (tol {TOL_LOGITS}); argmax {int(lk.argmax())} vs "
        f"{int(lr.argmax())}")
    if rel > TOL_LOGITS:
        raise AssertionError(f"hybrid prefill logits differ: rel {rel:.3g} > {TOL_LOGITS}")

    ref_engine = ServingEngine(cfg, run, params, ecfg, runtime=runtime(mode="reference"))
    for r in requests(greedy_only=True):
        ref_engine.submit(r)
    ref_out = {len(r.prompt): r.output for r in ref_engine.serve()}
    agree = total = 0
    for r in done:
        if r.temperature == 0:
            ref = ref_out[len(r.prompt)]
            agree += int((ref == r.output).sum())
            total += len(ref)
    log(f"[hybrid] greedy tokens equal on both paths: {agree}/{total} = {agree / total:.3f}")
    log(f"[hybrid] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


MOE_LENGTHS = (8, 16, 37, 300, 1024, 1500, 2048, 5000)


class RouteTap:
    """Records the expert ids of every ``moe._route`` call while active
    (the router is plain torch, so recording changes nothing it computes),
    each with its ``valid`` mask and the rows ``active()`` names live; each
    router's calls in order (``queues``, keyed by the router weight; the
    last one's ids in ``by_router``); and each call's load-balancing loss
    (``auxes``).

    With ``replay`` (an earlier tap of the same parameters), the one replay
    mode: each call pops the next ids of its router's queue, copied from
    the earlier tap's, in place of its own top-k, and ``_route`` weights
    them by its own router probabilities and takes its aux loss on them:
    the plain path on the kernel path's routes. A call that finds its
    router's queue empty is a remat recompute of that router's last call
    (the plain training path runs each layer again in the backward), and
    re-reads the last entry. Serving (one entry a router a prefill or
    decode step) and training (one a step) take the same mode."""

    def __init__(self, active=None, replay=None):
        self.calls = []
        self.queues = {}
        self.auxes = []
        self.active = active
        self.replay = replay

    @property
    def by_router(self):
        return {k: q[-1] for k, q in self.queues.items()}

    def __enter__(self):
        import collections

        from repro_torch.models import moe

        self._orig = orig = moe._route
        self._orig_top_k = orig_top_k = moe._top_k
        current = {}
        pending = ({k: collections.deque(q) for k, q in self.replay.queues.items()}
                   if self.replay is not None else None)
        last = {}

        def top_k(probs, k):
            if pending is None:
                return orig_top_k(probs, k)
            router = current["router"]
            queue = pending[router]
            if queue:
                last[router] = queue.popleft()
            ids = last[router]
            return probs.gather(1, ids), ids

        def tap(router_w, x2, top_k, valid=None):
            current["router"] = router_w.data_ptr()
            out = orig(router_w, x2, top_k, valid=valid)
            live = None if self.active is None else self.active()
            self.calls.append((out[1].detach(), valid, live))
            self.queues.setdefault(current["router"], []).append(out[1].detach())
            self.auxes.append(out[2].detach())
            return out

        moe._route = tap
        moe._top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self._orig
        moe._top_k = self._orig_top_k


def capacity_drops(ids, n_experts: int, cap: int):
    """[n, k] bool: which (token, choice) pairs of one unmasked dispatch go
    over their expert's capacity, in moe_apply's token-major order."""
    flat = ids.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, n_experts)
    pos = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    return (pos >= cap).reshape(ids.shape)


def phase_moe(seed: int):
    """Serve full-width Mixtral-8x7B, 8 of its 32 layers."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import runtime
    from repro_torch.models import lm, moe
    from repro_torch.models.transformer import RunConfig
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    cfg = dataclasses.replace(get_config("mixtral_8x7b"), num_layers=8)
    per_call = 3 * cfg.num_layers                  # gate, up, down in every layer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = lm.param_count(params)
    log(f"[moe] {cfg.name}: {cfg.num_layers} of 32 layers, d_model {cfg.d_model}, "
        f"{cfg.num_experts} experts top-{cfg.experts_per_token} of width {cfg.d_ff}, window "
        f"{cfg.window}; {n_params / 1e9:.3f} B params {cfg.dtype}, init "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated")
    ecfg = EngineConfig(max_batch=8, max_seq=8192)
    run = RunConfig()
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, cfg.vocab_size, n).astype(np.int32) for n in MOE_LENGTHS]

    rt = runtime(name="moe")
    engine = ServingEngine(cfg, run, params, ecfg, runtime=rt)
    for i, p in enumerate(prompts):
        engine.submit(Request(prompt=p, max_new_tokens=16, temperature=0.0 if i % 2 == 0
                              else 0.8, seed=seed + i, arrival_time=float(2 * i)))
    live = lambda: [s is not None for s in engine._slots]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with RouteTap(live) as tap:
        done = engine.serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = engine.stats
    snap = rt.telemetry.snapshot()
    log(f"[moe] launches during serving: {launches}")
    log(f"[moe] telemetry tiers: {snap['tiers']} over {snap['calls']} dispatches")
    missing = [k for k in MOE_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the MoE path: {missing}")
    if snap["tiers"].get("reference", 0):
        raise AssertionError(f"{snap['tiers']['reference']} dispatches fell to the reference tier")
    check_routes(launches, "moe", kernels=("matmul", "expert_gemm"))
    calls = st["prefill_calls"] + st["decode_steps"]
    if launches.get("expert_gemm", 0) != per_call * calls:
        raise AssertionError(f"expected {per_call} expert_gemm launches a prefill and a decode "
                             f"step, {per_call} x {calls} calls: counted "
                             f"{launches.get('expert_gemm', 0)}")
    for r in done:
        out = r.output
        if out is None or len(out) != 16 or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"bad output for a {len(r.prompt)}-token prompt: {out}")
    # capacity drops at decode: the pool's 8 rows, free slots included
    cap = moe.expert_capacity(ecfg.max_batch, cfg.num_experts, cfg.experts_per_token,
                              cfg.capacity_factor)
    pairs = dropped = live_pairs = live_dropped = 0
    for ids, valid, rows in tap.calls:
        if valid is not None:
            continue                                 # a prefill: pads masked
        drop = capacity_drops(ids.cpu(), cfg.num_experts, cap)
        alive = torch.tensor(rows)[:, None].expand_as(drop)
        pairs += drop.numel()
        dropped += int(drop.sum())
        live_pairs += int(alive.sum())
        live_dropped += int((drop & alive).sum())
    tok_s = st["tokens_out"] / wall
    log(f"[moe] served {len(done)} requests, {st['tokens_out']} tokens in {wall:.2f} s: "
        f"{tok_s:.1f} tokens/s; {st['decode_steps']} decode steps, {st['prefill_calls']} "
        f"prefills of {st['prefill_tokens']} tokens (buckets); expert_gemm "
        f"{launches['expert_gemm']} = {per_call} x {calls}")
    log(f"[moe] decode capacity {cap} an expert: {dropped}/{pairs} = {dropped / max(pairs, 1):.3f} "
        f"of the pool's (token, choice) routes dropped over {len(tap.calls)} dispatches; "
        f"{live_dropped}/{live_pairs} = {live_dropped / max(live_pairs, 1):.3f} of the live "
        f"slots' routes")
    for b in sorted(engine.timings["prefill_s"]):
        ts = engine.timings["prefill_s"][b]
        log(f"[moe] prefill bucket {b}: {1e3 * float(np.median(ts)):.2f} ms median of {len(ts)}")
    dec = engine.timings["decode_s"]
    log(f"[moe] decode step (8 slots): {1e3 * float(np.median(dec)):.2f} ms median of "
        f"{len(dec)} (p90 {1e3 * float(np.percentile(dec, 90)):.2f} ms)")
    w_bytes = (n_params - params["embed"]["table"].numel()) * 2
    log(f"[moe] computed floor of a decode step: {w_bytes / 1e9:.3f} GB of weights / "
        f"3.35 TB/s = {w_bytes / 3.35e12 * 1e3:.3f} ms (computed, not measured)")
    log(f"[moe] peak memory allocated: {peak / 2**30:.2f} GiB")
    del engine, tap

    probe = prompts[MOE_LENGTHS.index(5000)]
    toks = torch.zeros((1, 8192), dtype=torch.long, device="cuda")
    toks[0, :5000] = torch.from_numpy(probe.astype(np.int64))
    caches = lm.init_cache(cfg, ecfg.max_batch, ecfg.max_seq, "cuda")
    tokens = torch.zeros((ecfg.max_batch, 1), dtype=torch.long, device="cuda")
    pos = torch.arange(ecfg.max_batch, device="cuda") * 900 + 50     # 50 .. 6350: rolled

    def decode():
        with torch.inference_mode():
            lm.decode_step(params, tokens, caches, pos, cfg, run)[0].float().cpu()

    def prefill():
        with torch.inference_mode():
            lm.prefill(params, {"tokens": toks}, cfg, run, cache_len=ecfg.max_seq,
                       true_len=5000)[0].float().cpu()

    for label, step in (("decode step", decode), ("prefill", prefill)):
        kernels.reset_launch_counts()
        step()
        torch.cuda.synchronize()
        got = kernels.launch_counts().get("expert_gemm", 0)
        if got != per_call:
            raise AssertionError(f"one {label}: {got} expert_gemm launches, not {per_call}")
        log(f"[moe] one {label}: {got} expert_gemm launches")
    profile("moe decode step (8 slots)", decode, 5)
    profile("moe prefill 5000 tokens (bucket 8192)", prefill, 1)
    del caches

    # One full-width MoE layer on one input: kernel path vs plain path.
    x = torch.randn((1, 2048, cfg.d_model), generator=torch.Generator(device="cuda")
                    .manual_seed(seed), device="cuda").to(torch.bfloat16)
    layer = params["segments"][0][0]["l0"]["moe"]
    outs = {}
    with torch.inference_mode(), RouteTap() as tap:
        for mode in ("kernel", "reference"):
            with runtime(mode=mode):
                outs[mode], _ = moe.moe_apply(layer, x, top_k=cfg.experts_per_token,
                                              ffn_kind=cfg.ffn_kind,
                                              capacity_factor=cfg.capacity_factor)
    if not torch.equal(tap.calls[0][0], tap.calls[1][0]):
        raise AssertionError("the MoE layer routed one input differently on the two paths")
    abs_err, rel = rel_err(outs["kernel"], outs["reference"])
    log(f"[moe] one MoE layer, 2048 tokens (capacity 640), routes equal: kernel vs plain path "
        f"max abs {abs_err:.4g}, rel to max|plain| {rel:.3e} (tol {TOL_MOE_LAYER})")
    if not torch.isfinite(outs["kernel"]).all() or rel > TOL_MOE_LAYER:
        raise AssertionError(f"MoE layer differs: rel {rel:.3g} > {TOL_MOE_LAYER}")
    del outs, x

    # The 5000-token prompt's prefill logits: the kernel path against the
    # plain path routing on its own, and against the plain path on the
    # kernel path's routes.
    logits, taps = {}, {}
    with torch.inference_mode():
        for mode, replay in (("kernel", None), ("reference", None),
                             ("pinned", "kernel")):
            with RouteTap(replay=replay and taps[replay]) as taps[mode], \
                    runtime(mode="kernel" if mode == "kernel" else "reference"):
                logits[mode], _ = lm.prefill(params, {"tokens": toks}, cfg, run,
                                             cache_len=ecfg.max_seq, true_len=5000)
    ka, ra = taps["kernel"].calls, taps["reference"].calls
    flips = [int((a[0][:5000] != b[0][:5000]).any(-1).sum()) for a, b in zip(ka, ra)]
    last = [int((a[0][4999] != b[0][4999]).any()) for a, b in zip(ka, ra)]
    lk = logits["kernel"].float()
    if not (torch.isfinite(lk).all() and lk.shape == (1, cfg.vocab_size)):
        raise AssertionError(f"kernel-path logits not finite / shape {tuple(lk.shape)}")
    abs_p, rel_p = rel_err(lk, logits["pinned"].float())
    abs_f, rel_f = rel_err(lk, logits["reference"].float())
    log(f"[moe] prefill logits (5000 tokens, bucket 8192), kernel path vs plain path on the "
        f"kernel path's routes: max abs {abs_p:.4g}, rel to max|plain| {rel_p:.3e} (tol "
        f"{TOL_LOGITS}); vs plain path routing on its own: max abs {abs_f:.4g}, rel "
        f"{rel_f:.3e} (tol {TOL_MOE_LOGITS_FREE}); argmax {int(lk.argmax())}, "
        f"{int(logits['pinned'].argmax())}, {int(logits['reference'].argmax())}; tokens whose "
        f"routes differ between the free paths, by layer: {flips} of 5000 (the last token: "
        f"{last})")
    if rel_p > TOL_LOGITS or rel_f > TOL_MOE_LOGITS_FREE:
        raise AssertionError(f"MoE prefill logits differ: rel {rel_p:.3g} on the same routes "
                             f"(tol {TOL_LOGITS}), {rel_f:.3g} on free routes (tol "
                             f"{TOL_MOE_LOGITS_FREE})")
    log(f"[moe] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _mixer_only(spec) -> bool:
    """A layer whose only branch is a recurrent mixer (the xLSTM's: no
    FFN). It adds the mixer's output y to its input in the model dtype, and
    where |y| is a small part of |x| the bf16 sum's rounding, a unit in the
    last place of x, is most of ``round(x + y) - x``: the layer gates read
    such a layer's y (MixerTap) in place of its output less its input."""
    return spec.ffn == "none" and spec.mixer in ("mamba", "mlstm", "slstm")


class MixerTap:
    """Wraps ``transformer._recurrent_apply`` while active: ``y``, the
    output of the last recurrent mixer call, cut from the graph (a tap that
    held the graph would keep a training step's tensors alive through the
    hooks that point back at it), and ``cur``, its layer call's index
    (``index``, by the mixer's parameters, filled by the layer tap; a
    recompute under remat="full" finds its layer by the same key)."""

    def __init__(self):
        self.y, self.cur, self.index = None, None, {}

    def __enter__(self):
        from repro_torch.models import transformer as tf

        self._rec = orig = tf._recurrent_apply

        def mixer(p, h, spec, cfg, run, mode, cache):
            self.cur = self.index.get(id(p))
            y, nc = orig(p, h, spec, cfg, run, mode, cache)
            self.y = y.detach()
            return y, nc

        tf._recurrent_apply = mixer
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tf

        tf._recurrent_apply = self._rec

    def contribution(self, spec, x, out, pos=slice(None)):
        """What the layer adds to its input at positions ``pos``, in fp32:
        the mixer's y where that is the layer's only branch, else its output
        less its input."""
        if _mixer_only(spec):
            return self.y[:, pos].float()
        return out[:, pos].float() - x[:, pos].float()


class PrefillTap(MixerTap):
    """Wraps ``transformer.layer_apply`` while active, for its calls in
    ``mode`` (prefill or decode), forward only: the serving counterpart of
    LayerTap. Recording (no ``pin``): each such layer call's output and its
    contribution (``outs``, ``adds``, by call). Pinning (``pin``, a
    recording tap of the same parameters; ``outs``, the outputs to pin, by
    default its own): the i-th call computes its own output from its input,
    which is the previous call's pinned output, and returns ``outs[i]`` in
    place of its own; ``branch[i]`` holds ||a_own - a_rec|| / ||a_rec||, a
    the layer's contribution (MixerTap.contribution), over the positions
    ``pos`` selects (all, or the last one of a prefill one token longer
    than the recording). The plain path then runs every layer on the kernel
    path's inputs, and its head on the kernel path's last hidden state:
    each reading compares one layer, not bf16 roundings compounded over the
    layers before it. With ``states``, each call's new cache is kept too
    (``states``, by call): a recurrent layer's state after the call."""

    def __init__(self, pin=None, outs=None, mode="prefill", pos=slice(None), states=False):
        super().__init__()
        self.pin, self.mode, self.pos, self.keep_states = pin, mode, pos, states
        self.pin_outs = outs if outs is not None or pin is None else pin.outs
        self.outs, self.adds, self.states, self.branch = [], [], [], {}

    def __enter__(self):
        from repro_torch.models import transformer as tf

        super().__enter__()
        self._orig = orig = tf.layer_apply

        def layer(p, x, spec, cfg, run, mode, cache=None, pos=None, true_len=None):
            out, aux, nc = orig(p, x, spec, cfg, run, mode, cache, pos, true_len=true_len)
            if mode != self.mode:
                return out, aux, nc
            i = len(self.outs)
            if self.keep_states:
                self.states.append(nc)
            if self.pin is None:
                self.outs.append(out)
                self.adds.append(self.y if _mixer_only(spec) else None)
                return out, aux, nc
            self.outs.append(None)
            rec = self.pin_outs[i]
            rec_add = (self.pin.adds[i][:, self.pos].float() if _mixer_only(spec)
                       else rec[:, self.pos].float() - x[:, self.pos].float())
            self.branch[i] = _rel(self.contribution(spec, x, out, self.pos), rec_add)
            return rec, aux, nc

        tf.layer_apply = layer
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tf

        tf.layer_apply = self._orig
        super().__exit__(*exc)


def tune_decode_unembed(cfg, params, seed: int, budget: int = 4):
    """A database holding one record tuned on the card: the 8-slot decode
    pool's final norm -> unembed (``rmsnorm_matmul`` on the model's own
    scale and unembed weight, behind the correctness gate), what opts the
    fused site in (``fusion_wins``), as a campaign's record would. Every
    other site resolves at the heuristic tier."""
    from repro_torch.core.database import TuningDatabase
    from repro_torch.core.evaluate import WallClockEvaluator
    from repro_torch.core.search import RandomSearch
    from repro_torch.core.tuner import autotune
    from repro_torch.kernels import fused

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((8, cfg.d_model), generator=gen, device="cuda").to(cfg.tdtype)
    db = TuningDatabase(None)
    res = autotune(fused.rmsnorm_matmul,
                   (x, params["final_norm"]["scale"], params["lm_head"]["w"]),
                   search=RandomSearch(budget=budget),
                   evaluator=WallClockEvaluator(repeats=3, warmup=1), db=db, save=False,
                   call_kwargs={"eps": cfg.norm_eps})
    log(f"[{cfg.name}] tuned {db.records()[0].key}: {res.best_config}, "
        f"{1e3 * res.best_objective:.4f} ms (heuristic {1e3 * res.default_objective:.4f})")
    return db


# Gemma3-27B's prompts: four pass the 1024 window (the ring caches wrap at
# prefill and, for the rest, at decode) and the longest fills most of the
# 4096 bucket.
GEMMA_LENGTHS = (8, 3000, 40, 1500, 300, 2048, 1100, 700)


def phase_gemma(seed: int):
    """Serve Gemma3-27B at full depth: all 62 layers, bf16."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import runtime
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    cfg = get_config("gemma3_27b")
    n_local = sum(seg.repeats for seg in cfg.segments() for sp in seg.pattern if sp.window)
    n_global = cfg.num_layers - n_local
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = lm.param_count(params)
    log(f"[gemma] {cfg.name} (hf:google/gemma-3): all {cfg.num_layers} layers ({n_local} local "
        f"on a {cfg.window} window, {n_global} global), d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.hd}, GeGLU d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{n_params / 1e9:.3f} B params {cfg.dtype}, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ecfg = EngineConfig(max_batch=8, max_seq=4096)
    run = RunConfig()
    t0 = time.perf_counter()
    db = tune_decode_unembed(cfg, params, seed)
    log(f"[gemma] tuned its decode final norm -> unembed in {time.perf_counter() - t0:.1f} s")
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, cfg.vocab_size, n).astype(np.int32) for n in GEMMA_LENGTHS]
    rt = runtime(db=db, name="gemma")
    engine = ServingEngine(cfg, run, params, ecfg, runtime=rt)
    for i, p in enumerate(prompts):
        engine.submit(Request(prompt=p, max_new_tokens=32, temperature=0.0 if i % 2 == 0
                              else 0.8, seed=seed + i, arrival_time=float(2 * i)))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = engine.stats
    snap = rt.telemetry.snapshot()
    log(f"[gemma] launches during serving: {launches}")
    log(f"[gemma] telemetry tiers: {snap['tiers']} over {snap['calls']} dispatches")
    missing = [k for k in SERVE_KERNELS + ("rmsnorm_matmul",) if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"gemma: kernels never launched while serving: {missing}")
    if snap["tiers"].get("reference", 0):
        raise AssertionError(f"gemma: {snap['tiers']['reference']} dispatches fell to the "
                             f"reference tier")
    check_routes(launches, "gemma")
    check_routes(launches, "gemma", want=("decode",), kernels=("rmsnorm_matmul",))
    if launches["rmsnorm_matmul"] != launches.get("rmsnorm_matmul_decode", 0) or \
            launches["rmsnorm_matmul"] != st["decode_steps"]:
        raise AssertionError(f"gemma: rmsnorm_matmul should launch on the decode route once a "
                             f"decode step ({st['decode_steps']}): {launches}")
    flash = {}
    for key, tiers in snap["by_key"].items():
        if key.startswith("flash_attention|"):
            w = key.rsplit("|", 1)[1]
            flash[w] = flash.get(w, 0) + sum(tiers.values())
    want = {f"cTruew{cfg.window}": n_local * st["prefill_calls"],
            "cTruew0": n_global * st["prefill_calls"]}
    if flash != want or launches["flash_attention"] != cfg.num_layers * st["prefill_calls"]:
        raise AssertionError(f"gemma: flash launches windowed / full {flash}, expected {want}; "
                             f"{launches['flash_attention']} launches")
    for r in done:
        out = r.output
        if out is None or len(out) != 32 or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"gemma: bad output for a {len(r.prompt)}-token prompt: {out}")
    tok_s = st["tokens_out"] / wall
    log(f"[gemma] served {len(done)} requests, {st['tokens_out']} tokens in {wall:.2f} s: "
        f"{tok_s:.1f} tokens/s; {st['decode_steps']} decode steps, {st['prefill_calls']} "
        f"prefills of {st['prefill_tokens']} tokens (buckets); flash_attention launches: "
        f"{flash[f'cTruew{cfg.window}']} windowed ({cfg.window}), {flash['cTruew0']} full; "
        f"rmsnorm_matmul {launches['rmsnorm_matmul']} on the decode route")
    for b in sorted(engine.timings["prefill_s"]):
        ts = engine.timings["prefill_s"][b]
        log(f"[gemma] prefill bucket {b}: {1e3 * float(np.median(ts)):.2f} ms median of "
            f"{len(ts)}")
    dec = engine.timings["decode_s"]
    log(f"[gemma] decode step (8 slots): {1e3 * float(np.median(dec)):.2f} ms median of "
        f"{len(dec)} (p90 {1e3 * float(np.percentile(dec, 90)):.2f} ms)")
    w_bytes = (n_params - params["embed"]["table"].numel()) * 2
    log(f"[gemma] computed floor of a decode step: {w_bytes / 1e9:.3f} GB of weights (all but "
        f"the embedding table, of which a step gathers 8 rows) / 3.35 TB/s = "
        f"{w_bytes / 3.35e12 * 1e3:.3f} ms (computed, not measured)")
    log(f"[gemma] peak memory allocated: {peak / 2**30:.2f} GiB (limit 75)")
    if peak > TRAIN_PEAK_LIMIT:
        raise AssertionError(f"gemma: peak {peak / 2**30:.2f} GiB passes 75 GiB")
    del engine

    probe = prompts[GEMMA_LENGTHS.index(3000)]
    toks = torch.zeros((1, 4096), dtype=torch.long, device="cuda")
    toks[0, :3000] = torch.from_numpy(probe.astype(np.int64))
    caches = lm.init_cache(cfg, ecfg.max_batch, ecfg.max_seq, "cuda")
    tokens = torch.zeros((ecfg.max_batch, 1), dtype=torch.long, device="cuda")
    pos = torch.arange(ecfg.max_batch, device="cuda") * 500 + 50      # 50 .. 3550: rings wrapped

    def decode():
        with torch.inference_mode(), rt:
            lm.decode_step(params, tokens, caches, pos, cfg, run)[0].float().cpu()

    def prefill():
        with torch.inference_mode(), rt:
            lm.prefill(params, {"tokens": toks}, cfg, run, cache_len=ecfg.max_seq,
                       true_len=3000)[0].float().cpu()

    profile("gemma decode step (8 slots)", decode, 5)
    profile("gemma prefill 3000 tokens (bucket 4096)", prefill, 1)
    del caches

    # The 3000-token prompt's prefill logits: end to end against the plain
    # path (printed), and gated layer by layer (PrefillTap).
    t0 = time.perf_counter()
    logits = {}
    with torch.inference_mode():
        with runtime(mode="kernel", name="gemma-kernel"), PrefillTap() as rec:
            logits["kernel"], _ = lm.prefill(params, {"tokens": toks}, cfg, run,
                                             cache_len=ecfg.max_seq, true_len=3000)
        with runtime(mode="reference", name="gemma-plain"):
            logits["plain"], _ = lm.prefill(params, {"tokens": toks}, cfg, run,
                                            cache_len=ecfg.max_seq, true_len=3000)
        with runtime(mode="reference", name="gemma-pinned"), PrefillTap(pin=rec) as pin:
            logits["pinned"], _ = lm.prefill(params, {"tokens": toks}, cfg, run,
                                             cache_len=ecfg.max_seq, true_len=3000)
    del rec
    lk = logits["kernel"].float()
    if not (torch.isfinite(lk).all() and lk.shape == (1, cfg.vocab_size)):
        raise AssertionError(f"gemma: kernel-path logits not finite / shape {tuple(lk.shape)}")
    abs_e, rel_e = rel_err(lk, logits["plain"].float())
    abs_h, rel_h = rel_err(lk, logits["pinned"].float())
    fwd = sorted(((r, i) for i, r in pin.branch.items()), reverse=True)
    bad = [(round(r, 6), i) for r, i in fwd if r > TOL_GRAD]
    log(f"[gemma] prefill logits (3000 tokens, bucket 4096), kernel vs plain path end to end "
        f"through {cfg.num_layers} layers (report; TOL_LOGITS {TOL_LOGITS} covers 24): max abs "
        f"{abs_e:.4g}, rel to max|plain| {rel_e:.3e}; argmax {int(lk.argmax())} vs "
        f"{int(logits['plain'].argmax())}")
    log(f"[gemma] prefill layer by layer (the plain path on the kernel path's layer inputs): "
        f"{len(fwd)} layers' outputs less their inputs, ||d_k - d_p|| / ||d_p||: median "
        f"{fwd[len(fwd) // 2][0]:.3e}, max {fwd[0][0]:.3e} (layer {fwd[0][1]}) (tol "
        f"{TOL_GRAD}); the head on the kernel path's last hidden state: logits max abs "
        f"{abs_h:.4g}, rel {rel_h:.3e} (tol {TOL_LOGITS}); the three prefills in "
        f"{time.perf_counter() - t0:.1f} s")
    if len(fwd) != cfg.num_layers or bad or rel_h > TOL_LOGITS:
        msg = (f"gemma: prefill gate: {len(bad)} of {len(fwd)} layers over {TOL_GRAD}, the "
               f"worst: {bad[:4]}; head rel {rel_h:.3g} (tol {TOL_LOGITS})")
        log(f"[gemma] FAILED {msg}")
        GATE_FAILURES.append(msg)
    log(f"[gemma] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_paligemma_train(seed: int):
    """Train PaliGemma-3B at full width and depth, its 256 patch
    embeddings before the tokens and the loss masked off them."""
    from repro_torch.configs import get_config

    cfg = get_config("paligemma_3b")
    steps = 4
    log(f"[paligemma-train] {cfg.name} (arXiv:2407.07726) at full width and depth: "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} q heads of {cfg.hd} on "
        f"{cfg.num_kv_heads} kv head, GeGLU d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{cfg.num_prefix} patch embeddings (a stub frontend) before 2048 - {cfg.num_prefix} "
        f"tokens, loss_mask 0 on them")
    t_phase = time.perf_counter()
    by_step = []
    trainer, batch, metrics, launches, snap, peak, _ = _train_run(
        "paligemma-train", cfg, seed, (2, 1), steps, by_step=by_step)
    # a step: one flash forward and one backward a layer, both at d = 256
    # on the tensor-core kernels (bf16 has no other route); 37 norms
    _train_checks("paligemma-train", snap, launches, {
        "flash_attention": cfg.num_layers * steps, "flash_attention_bwd": cfg.num_layers * steps,
        "rmsnorm_bwd": (2 * cfg.num_layers + 1) * steps, "matmul_wmma": 0})
    per_step = [(s.get("flash_attention", 0), s.get("flash_attention_bwd", 0)) for s in by_step]
    if per_step != [(cfg.num_layers, cfg.num_layers)] * steps:
        raise AssertionError(f"paligemma-train: flash launches (fwd, bwd) by step {per_step}")
    flash_keys = sorted({k for ph in ("fwd", "bwd") for k in snap["by_key_phase"].get(ph, {})
                         if k.startswith("flash_attention")})
    if not flash_keys or any(f"x{cfg.hd}/" not in k for k in flash_keys):
        raise AssertionError(f"paligemma-train: flash keys not at d={cfg.hd}: {flash_keys}")
    log(f"[paligemma-train] flash launches (forward, backward) by step: {per_step}, every one "
        f"bf16 at d={cfg.hd} on the tensor-core kernels: {flash_keys}")
    check_routes(launches, "paligemma-train", want=("tc",))
    tokens = batch * 2048
    step_ms = _step_report("paligemma-train", metrics, tokens)
    by_name, busy = profile(f"paligemma train step ({tokens} tokens)", trainer.run_one_step, 1,
                            wall_ms=step_ms)
    kernel_share("paligemma train step", by_name, busy, "flash_attention (d=256)",
                 ("flash_fwd_tc<256,",))
    kernel_share("paligemma train step", by_name, busy, "flash_attention_bwd (d=256)",
                 ("flash_bwd_dq_tc<256,", "flash_bwd_dkv_tc<256,"))
    log(f"[paligemma-train] phase took {time.perf_counter() - t_phase:.1f} s")
    del trainer
    return launches, batch


# (arch, layers, source): each at its published widths, its depth cut.
ARCH_CUTS = (("qwen2_5_3b", 4, "hf:Qwen/Qwen2.5-3B"),
             ("minitron_4b", 4, "arXiv:2407.14679"),
             ("musicgen_large", 4, "arXiv:2306.05284"),
             ("arctic_480b", 1, "hf:Snowflake/snowflake-arctic-base"))


def phase_archs(seed: int):
    """The other four new archs at full width, their depth cut: one prefill
    and 4 greedy decode steps (MusicGen: one forward with its loss), the
    kernel path held against the plain path at TOL_LOGITS (Arctic on the
    kernel path's routes)."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import runtime
    from repro_torch.models import lm
    from repro_torch.models.layers import unembed
    from repro_torch.models.transformer import RunConfig

    run = RunConfig()
    out = {}
    t_phase = time.perf_counter()
    for arch, layers, source in ARCH_CUTS:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed=seed, device="cuda")
        torch.cuda.synchronize()
        tag = f"[archs] {arch}"
        log(f"{tag} ({source}): {layers} of {get_config(arch).num_layers} layers at full width "
            f"(d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.hd}, "
            f"{cfg.ffn_kind} d_ff {cfg.d_ff}" + (f", {cfg.num_experts} experts top-"
                                                f"{cfg.experts_per_token} beside a dense FFN"
                                                if cfg.num_experts else "")
            + f", vocab {cfg.vocab_size}); {lm.param_count(params) / 1e9:.3f} B params, init "
            f"{time.perf_counter() - t0:.1f} s")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        kernels.reset_launch_counts()
        if cfg.frontend == "audio_frames":
            batch = {"embeds": 0.1 * torch.randn((2, 1024, cfg.d_model), generator=gen,
                                                 device="cuda"),
                     "labels": torch.randint(0, cfg.vocab_size, (2, 1024), generator=gen,
                                             device="cuda")}
            res = {}
            with torch.inference_mode():
                for mode in ("kernel", "reference"):
                    with runtime(mode=mode, name=f"{arch}-{mode}"):
                        t0 = time.perf_counter()
                        x, _, _ = lm.forward(params, batch, cfg, run, mode="train")
                        loss, _ = lm.loss_fn(params, batch, cfg, run)
                        torch.cuda.synchronize()
                        res[mode] = (unembed(params["lm_head"], x[:, -1]).float(), float(loss),
                                     time.perf_counter() - t0)
                    if mode == "kernel":
                        launches = kernels.launch_counts()
            (lk, loss_k, t_k), (lp, loss_p, t_p) = res["kernel"], res["reference"]
            abs_e, rel = rel_err(lk, lp)
            loss_rel = abs(loss_k - loss_p) / abs(loss_p)
            log(f"{tag}: forward with the loss of 2 x 1024 audio frames: loss {loss_k:.6f} "
                f"kernel path, {loss_p:.6f} plain path, rel {loss_rel:.3e} (tol {TOL_LOSS}); "
                f"last position's logits rel {rel:.3e} (tol {TOL_LOGITS}); {1e3 * t_k:.1f} ms "
                f"(plain {1e3 * t_p:.1f})")
            if not np.isfinite(loss_k) or loss_rel > TOL_LOSS or rel > TOL_LOGITS:
                raise AssertionError(f"{arch}: kernel path differs from the plain path: loss rel "
                                     f"{loss_rel:.3g}, logits rel {rel:.3g}")
        else:
            prompt = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen, device="cuda")
            steps = {}
            taps = {}
            for mode in ("kernel", "reference"):
                with torch.inference_mode(), runtime(mode=mode, name=f"{arch}-{mode}"), \
                        RouteTap(replay=taps.get("kernel")) as taps[mode]:
                    t0 = time.perf_counter()
                    lg, caches = lm.prefill(params, {"tokens": prompt}, cfg, run, cache_len=520)
                    seq = [lg.float()]
                    tok = (steps["kernel"][0][0] if mode == "reference"
                           else lg.argmax(-1, keepdim=True))
                    for i in range(4):
                        lg, caches = lm.decode_step(params, tok, caches, torch.tensor(512 + i),
                                                    cfg, run)
                        seq.append(lg.float())
                        tok = (steps["kernel"][0][i + 1] if mode == "reference"
                               else lg.argmax(-1, keepdim=True))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    if mode == "kernel":
                        launches = kernels.launch_counts()
                        toks = [seq[0].argmax(-1, keepdim=True)] + [
                            g.argmax(-1, keepdim=True) for g in seq[1:]]
                        steps["kernel"] = (toks, seq, wall)
                    else:
                        steps["reference"] = (None, seq, wall)
                del caches
            rels = [rel_err(a, b)[1] for a, b in zip(steps["kernel"][1], steps["reference"][1])]
            log(f"{tag}: one 512-token prefill and 4 greedy decode steps in "
                f"{1e3 * steps['kernel'][2]:.1f} ms (plain path {1e3 * steps['reference'][2]:.1f}"
                f"); logits kernel vs plain path" + (" on the kernel path's routes"
                                                    if cfg.num_experts else "")
                + f", rel to max|plain| by step: {', '.join(f'{r:.3e}' for r in rels)} (tol "
                f"{TOL_LOGITS})")
            if not all(torch.isfinite(g).all() for g in steps["kernel"][1]) or \
                    max(rels) > TOL_LOGITS:
                raise AssertionError(f"{arch}: kernel path differs from the plain path: {rels}")
            if cfg.num_experts:
                per = 3 * layers * 5         # gate, up, down; a prefill and 4 decode steps
                if launches.get("expert_gemm", 0) != per:
                    raise AssertionError(f"{arch}: {launches.get('expert_gemm', 0)} expert_gemm "
                                         f"launches, expected {per}")
                caps = sorted({int(ids.shape[0]) for ids, _, _ in taps["kernel"].calls})
                routes = {r: launches.get(f"expert_gemm_{r}", 0)
                          for r in ("tc", "decode", "wmma", "simt")}
                log(f"{tag}: expert_gemm {launches['expert_gemm']} launches at {cfg.num_experts} "
                    f"experts (prefill capacity 10, decode 2; the kernels phase times both), "
                    f"by route {routes}; tokens a routed call {caps}")
        missing = [k for k in ("matmul", "rmsnorm") + (("flash_attention",) if not cfg.frontend
                                                       else ()) if launches.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"{arch}: never launched: {missing}")
        log(f"{tag}: launches {launches}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        out[arch] = launches
        del params
    log(f"[archs] phase took {time.perf_counter() - t_phase:.1f} s")
    return out


def _fp32_copy(tree):
    """The parameter tree, every leaf an fp32 copy cut from the graph."""
    if isinstance(tree, dict):
        return {k: _fp32_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fp32_copy(v) for v in tree)
    return tree.detach().float()


class _Pinned(torch.autograd.Function):
    """A layer's output carrying another computation's value and cotangent:
    the forward gives ``value`` in place of ``own``, and the backward sends
    ``ct`` into ``own``'s graph in place of the cotangent that arrives,
    which it keeps in ``arrived[i]``."""

    @staticmethod
    def forward(ctx, own, value, ct, arrived, i):
        ctx.ct, ctx.arrived, ctx.i = ct, arrived, i
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.arrived[ctx.i] = g
        return ctx.ct, None, None, None, None


class _Grab(torch.autograd.Function):
    """The identity on ``ts``, whose backward keeps the cotangents that
    reach them in ``store[i]``."""

    @staticmethod
    def forward(ctx, store, i, *ts):
        ctx.store, ctx.i = store, i
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        ctx.store[ctx.i] = gs
        return (None, None) + gs


class _PinnedCell(torch.autograd.Function):
    """An mLSTM recurrence's output carrying another computation's value and
    input cotangents: the forward gives ``h`` whatever its inputs ``ins``
    hold, and the backward keeps the cotangent that arrives (``arrived[i]``)
    and sends ``cts`` to the inputs."""

    @staticmethod
    def forward(ctx, h, cts, arrived, i, *ins):
        ctx.cts, ctx.arrived, ctx.i = cts, arrived, i
        return h.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.arrived[ctx.i] = g
        return (None, None, None, None) + tuple(ctx.cts)


class LayerTap(MixerTap):
    """Wraps ``transformer._train_layer`` while active. Recording (no
    ``pin``): each train-mode layer call's output and contribution
    (MixerTap.contribution) and, once the backward has run, the cotangent
    that reached it (``outs``, ``adds``, ``cts``, by call). Pinning (``pin``,
    a recording tap of the same parameters and batch): the i-th layer call
    returns the recorded i-th output in place of its own, and its backward
    takes the recorded cotangent in place of the one that arrives, which is
    kept (``arrived``); ``branch[i]`` holds how far its own contribution sits
    from the recorded one, ||a_own - a_rec|| / ||a_rec||. The plain path
    then computes every layer, and the embedding and the head, on the
    recorded path's inputs and output cotangents: a layer's gradients differ
    by what that layer computes, not by bf16 roundings compounded over the
    layers around it.

    An mLSTM layer's chunkwise recurrence (``ssm._mlstm_scan``, plain torch
    on both paths) is pinned the same way inside the layer: recording keeps
    its output and the cotangents that reach its inputs (q, k, v and the
    log gates) and its output (``cell_h``, ``cell_in``, ``cell_out``);
    pinning gives the recorded output in its place, sends the recorded
    input cotangents back, and keeps the cotangent arriving at its output
    (``cell_out``). The reference's own backward through that recurrence
    is where its bf16 gradients leave fp32 (the JAX package's bf16
    gradients of wq, wk, in_proj and the gates sit 5.8e-2 to 9.0e-2 from
    its fp32 ones, tests/test_torch_xlstm_bf16.py), so the plain path's
    leaves are then computed by its gemms and glue on the kernel path's
    cotangents, and each reading compares what the kernels computed."""

    def __init__(self, pin=None):
        super().__init__()
        self.pin = pin
        self.outs, self.adds, self.cts, self.arrived, self.branch = [], [], {}, {}, {}
        self.cell_h, self.cell_in, self.cell_out = {}, {}, {}

    def __enter__(self):
        from repro_torch.models import ssm
        from repro_torch.models import transformer as tf

        super().__enter__()
        self._orig = orig = tf._train_layer
        self._cell = cell_orig = ssm._mlstm_scan

        def layer(block, x, spec, cfg, run):
            i = len(self.outs)
            self.index[id(block["mixer"])] = i
            self.y = None
            out, aux = orig(block, x, spec, cfg, run)
            xd = x.detach()
            if self.pin is None:
                self.outs.append(out.detach())
                self.adds.append(self.y if _mixer_only(spec) else None)
                out.register_hook(lambda g, i=i: self.cts.__setitem__(i, g))
                return out, aux
            self.outs.append(None)
            rec = self.pin.outs[i]
            rec_add = (self.pin.adds[i].float() if _mixer_only(spec)
                       else rec.float() - xd.float())
            self.branch[i] = _rel(self.contribution(spec, xd, out.detach()), rec_add)
            return _Pinned.apply(out, rec, self.pin.cts[i], self.arrived, i), aux

        def cell(q, k, v, log_i, log_f, chunk):
            i = self.cur
            if self.pin is None:
                ins = _Grab.apply(self.cell_in, i, q, k, v, log_i, log_f)
                h, C, n, m = cell_orig(*ins, chunk)
                self.cell_h[i] = h.detach()
                h.register_hook(lambda g, i=i: self.cell_out.__setitem__(i, g))
                return h, C, n, m
            h = _PinnedCell.apply(self.pin.cell_h[i], self.pin.cell_in[i], self.cell_out, i,
                                  q, k, v, log_i, log_f)
            return h, None, None, None

        tf._train_layer = layer
        ssm._mlstm_scan = cell
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ssm
        from repro_torch.models import transformer as tf

        tf._train_layer = self._orig
        ssm._mlstm_scan = self._cell
        super().__exit__(*exc)


class DispatchTap:
    """Wraps the ``matmul`` tunable's kernel body while active: each launch
    on the kernel path, forward or backward (a gradient is a ``matmul``
    launch on transposed operands), is held against the kernel's plain
    version (``kernels/ref.py``) on the very operands the path gave it, as
    the kernels phase holds its rows: rel_err at TOL_BF16 (bf16) or
    TOL_F32_GEMM (fp32). It reads what the kernel computed, whatever the
    model around it does with the result. ``n`` counts the launches held,
    ``worst`` keeps the largest reading by dtype, ``bad`` those over."""

    def __enter__(self):
        from repro_torch.core.annotate import get_tunable
        from repro_torch.core.runtime import ensure_registered
        from repro_torch.kernels import ref
        from repro_torch.kernels.matmul import layout

        ensure_registered()
        self._t = t = get_tunable("matmul")
        self._fn = fn = t.fn
        self.n, self.worst, self.bad = 0, {}, []

        def held(x, w, **kw):
            out = fn(x, w, **kw)
            with torch.no_grad():
                _, rel = rel_err(out, ref.matmul(x, w))
            bf16 = x.dtype == torch.bfloat16
            what = (f"[{x.shape[0]},{x.shape[1]}]@[{w.shape[0]},{w.shape[1]}] "
                    f"{'bf16' if bf16 else 'f32'}"
                    + (" transposed" if layout(x)[0] or layout(w)[0] else ""))
            self.n += 1
            key = "bf16" if bf16 else "f32"
            if rel >= self.worst.get(key, (0.0, ""))[0]:
                self.worst[key] = (rel, what)
            if rel > (TOL_BF16 if bf16 else TOL_F32_GEMM):
                self.bad.append((round(rel, 6), what))
            return out

        t.fn = held
        return self

    def __exit__(self, *exc):
        self._t.fn = self._fn

    def gate(self, tag: str, what: str) -> None:
        """Print the readings; a launch over its limit goes to GATE_FAILURES."""
        log(f"[{tag}] {what}: {self.n} matmul launches each against the plain version on its "
            f"own operands, rel_err max " + ", ".join(
                f"{k} {r:.3e} ({shape})" for k, (r, shape) in sorted(self.worst.items()))
            + f" (tol bf16 {TOL_BF16}, f32 {TOL_F32_GEMM}); {len(self.bad)} over")
        if self.n == 0:
            raise AssertionError(f"{tag}: {what}: no matmul launch was held")
        if self.bad:
            msg = (f"{tag}: {what}: {len(self.bad)} matmul launches differ from the plain "
                   f"version on their own operands, the worst: {sorted(self.bad, reverse=True)[:4]}")
            log(f"[{tag}] FAILED {msg}")
            GATE_FAILURES.append(msg)


def _rel(a, b) -> float:
    """||a - b|| / ||b|| in fp32."""
    return (a.float() - b.float()).norm().item() / max(b.float().norm().item(), 1e-30)


def gate_step1(trainer, cfg, run, data, tag: str, replay_routes: bool = False):
    """Step 1's loss and gradients: the trainer's kernel path against the
    plain path (reference mode, remat="full" so its fp32 attention scores
    and its scan's autograd graph are live for one layer at a time) on the
    same parameters and batch.

    Gated: the plain path's loss on its own against the kernel path's
    (TOL_LOSS); then, layer by layer, the plain path on the kernel path's
    layer outputs and their cotangents (LayerTap): every gradient leaf
    (TOL_GRAD; TOL_GRAD_KBIAS for the k biases), the cotangent each layer's
    plain backward hands down and each layer's output less its input
    (TOL_GRAD), so each reading compares one layer, or the embedding or the
    head, on equal inputs; an mLSTM layer with its recurrence pinned too,
    where the cotangent arriving at the recurrence's output is held to
    TOL_GRAD as well (LayerTap). Each matmul launch of the kernel path's
    forward and backward is held against the plain version on its own
    operands (DispatchTap). Reported, not
    gated: each leaf's distance when the two paths run on their own, where
    the bf16 roundings that differ in the first layer compound through the
    rest, and for each leaf over TOL_GRAD there each path's distance from
    an fp32 computation of the step (the parameters cast, reference mode).
    A failure goes to GATE_FAILURES. With ``replay_routes`` (an MoE arch)
    the plain path takes the kernel path's expert ids, layer by layer (its
    recompute too), in both its passes; a forward-only plain pass routing
    on its own reports how many tokens' routes flip and what that does to
    the loss. Returns the kernel path's MoE load-balancing loss (None
    without ``replay_routes``)."""
    import dataclasses

    from repro_torch.convert import batch_to_tensors
    from repro_torch.core.runtime import runtime
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig
    from repro_torch.optim import adamw

    leaves = adamw.leaves(trainer.params)
    batch = batch_to_tensors(SyntheticPipeline(cfg, data).next_batch(), leaves[0].device)
    names = [n for n, _ in adamw.named_leaves(trainer.params)]
    tap = RouteTap() if replay_routes else contextlib.nullcontext()
    routes = lambda: (RouteTap(replay=tap) if replay_routes
                      else contextlib.nullcontext())
    with tap, LayerTap() as layers, DispatchTap() as held:
        loss_k, grads_k = trainer.loss_and_grads(batch)
    held.gate(tag, "step 1, forward and backward")
    plain_run = RunConfig(remat="full", loss_chunk=run.loss_chunk)
    kbias = lambda name: name.endswith("/mixer/k/b")
    limit = lambda name: TOL_GRAD_KBIAS if kbias(name) else TOL_GRAD

    # end to end: the plain path on its own
    with runtime(mode="reference", name="plain"), routes():
        loss_p, _ = lm.loss_fn(trainer.params, batch, cfg, plain_run)
        grads_p = torch.autograd.grad(loss_p, leaves)
    lk, lp = float(loss_k), float(loss_p.detach())
    loss_rel = abs(lk - lp) / abs(lp)
    on_routes = " on the kernel path's routes" if replay_routes else ""
    log(f"[{tag}] step-1 loss kernel path {lk:.6f}, plain path{on_routes} {lp:.6f}: rel "
        f"{loss_rel:.3e} (tol {TOL_LOSS})")
    rels, over = [], {}
    for name, gk, gp in zip(names, grads_k, grads_p):
        rels.append((_rel(gk, gp), name))
        if rels[-1][0] > limit(name) and len(over) < REPORT_LEAVES:
            over[name] = (rels[-1][0], gk.float(), gp.float())
    del grads_p
    rels.sort(reverse=True)
    log(f"[{tag}] report only, each path on its own: ||g_k - g_p|| / ||g_p|| over {len(rels)} "
        f"leaves: median {rels[len(rels) // 2][0]:.3e}, max {rels[0][0]:.3e} ({rels[0][1]}); "
        f"{sum(r > limit(n) for r, n in rels)} over TOL_GRAD ({TOL_GRAD}; k biases "
        f"{TOL_GRAD_KBIAS})")
    if over:
        # each path against an fp32 computation of the step: bf16 rounding
        # leaves both about as far from it as from each other
        p32 = _fp32_copy(trainer.params)
        want = [t for n, t in adamw.named_leaves(p32) if n in over]
        for t in want:
            t.requires_grad_()
        with runtime(mode="reference", name="fp32"), routes():
            loss_t, _ = lm.loss_fn(p32, batch, dataclasses.replace(cfg, dtype="float32"),
                                   plain_run)
            grads_t = torch.autograd.grad(loss_t, want)
        log(f"[{tag}] report only, the first {len(over)} of them against an fp32 computation "
            f"of step 1 (loss {float(loss_t.detach()):.6f}): ||g - g_32|| / ||g_32||")
        for (name, (rel, gk, gp)), gt in zip(over.items(), grads_t):
            log(f"[{tag}]   {name}: kernel path {_rel(gk, gt):.3e}, plain path "
                f"{_rel(gp, gt):.3e}; between them {rel:.3e}")
        del p32, want, grads_t
    over.clear()

    # gated: layer by layer, the plain path on the kernel path's layer
    # outputs and cotangents
    with runtime(mode="reference", name="plain-pinned"), routes(), LayerTap(pin=layers) as pin:
        loss_q, _ = lm.loss_fn(trainer.params, batch, cfg, plain_run)
        grads_q = torch.autograd.grad(loss_q, leaves)
    bad = []
    rels = []
    for name, gk, gq in zip(names, grads_k, grads_q):
        rels.append((_rel(gk, gq), name))
        if rels[-1][0] > limit(name):
            bad.append((round(rels[-1][0], 6), name))
    cts = [(_rel(layers.cts[i], pin.arrived[i]), i) for i in range(len(layers.outs))]
    bad_ct = sorted(((round(r, 6), i) for r, i in cts if r > TOL_GRAD), reverse=True)
    fwd = sorted(((r, i) for i, r in pin.branch.items()), reverse=True)
    bad_fwd = [(round(r, 6), i) for r, i in fwd if r > TOL_GRAD]
    cell = sorted(((_rel(layers.cell_out[i], pin.cell_out[i]), i) for i in layers.cell_out),
                  reverse=True)
    bad_cell = [(round(r, 6), i) for r, i in cell if r > TOL_GRAD]
    del grads_k, grads_q, layers, pin
    rels.sort(reverse=True)
    cts.sort(reverse=True)
    rk = [r for r in rels if kbias(r[1])]
    ro = [r for r in rels if not kbias(r[1])]
    log(f"[{tag}] step-1 gradients layer by layer (the plain path on the kernel path's layer "
        f"outputs and cotangents), ||g_k - g_p|| / ||g_p|| over {len(rels)} leaves: median "
        f"{rels[len(rels) // 2][0]:.3e}; {len(ro)} leaves other than the k biases: max "
        f"{ro[0][0]:.3e} ({ro[0][1]}) (tol {TOL_GRAD})" + (
            f"; {len(rk)} k biases: max {rk[0][0]:.3e} ({rk[0][1]}) (tol {TOL_GRAD_KBIAS})"
            if rk else "") + f"; {len(cts)} layer outputs' cotangents handed down: max "
        f"{cts[0][0]:.3e} (layer call {cts[0][1]}) (tol {TOL_GRAD}); layer outputs less "
        f"their inputs (a recurrent mixer with no other branch: its output): max {fwd[0][0]:.3e} "
        f"(layer call {fwd[0][1]}) (tol {TOL_GRAD})" + (
            f"; {len(cell)} cotangents at an mLSTM recurrence's pinned output: max "
            f"{cell[0][0]:.3e} (layer call {cell[0][1]}) (tol {TOL_GRAD})" if cell else "")
        + f"; loss {float(loss_q.detach()):.6f}")
    for rel, name in rels[:4]:
        log(f"[{tag}]   {rel:.3e}  {name}")
    aux = None
    if replay_routes:
        aux = float(sum(tap.auxes))
        with torch.no_grad(), runtime(mode="reference", name="plain-free"), RouteTap() as free:
            loss_f, _ = lm.loss_fn(trainer.params, batch, cfg,
                                   RunConfig(remat="none", loss_chunk=run.loss_chunk))
        flips = [int((free.by_router[k] != ids).any(-1).sum())
                 for k, ids in tap.by_router.items()]
        n_tok = next(iter(tap.by_router.values())).shape[0]
        log(f"[{tag}] report only: the plain path routing on its own: loss {float(loss_f):.6f}, "
            f"rel {abs(lk - float(loss_f)) / abs(float(loss_f)):.3e} to the kernel path's; tokens "
            f"whose routes differ from the kernel path's, by layer: {flips} of {n_tok}")
        log(f"[{tag}] step-1 MoE load-balancing loss (kernel path, summed over layers): {aux:.6f}")
    del batch
    bad.sort(reverse=True)
    if loss_rel > TOL_LOSS or bad or bad_ct or bad_fwd or bad_cell:
        msg = (f"{tag}: step-1 gate: kernel path differs from the plain path: loss rel "
               f"{loss_rel:.3g} (tol {TOL_LOSS}); layer by layer, {len(bad)} leaves over their "
               f"limit, the worst: {bad[:8]}; {len(bad_ct)} cotangents handed down over "
               f"{TOL_GRAD}, the worst (rel, layer call): {bad_ct[:4]}; {len(bad_fwd)} layer "
               f"outputs less their inputs over {TOL_GRAD}, the worst: {bad_fwd[:4]}; {len(bad_cell)} "
               f"mLSTM recurrences' output cotangents over {TOL_GRAD}, the worst: {bad_cell[:4]}")
        log(f"[{tag}] FAILED {msg}")
        GATE_FAILURES.append(msg)
    return aux


# A training phase drops to its smaller batch only when the larger one's
# step passes this peak of allocated memory (of the card's 80 GB).
TRAIN_PEAK_LIMIT = 75 * 2**30


def _train_run(tag: str, cfg, seed: int, batches, steps: int, replay_routes: bool = False,
               by_step=None, seq: int = 2048):
    """Train ``cfg`` through the Trainer at ``seq`` (default 2048) and the
    first batch of ``batches`` whose steps stay under TRAIN_PEAK_LIMIT:
    step 1 gated against the plain path, then ``steps`` steps with the
    launch counters and the telemetry counting from 0 (``by_step``, a list, gets each
    step's launches). Returns (trainer, batch, metrics, launches, telemetry
    snapshot, peak bytes, the step-1 aux loss)."""
    from repro_torch import kernels
    from repro_torch.core.runtime import runtime
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig

    run = RunConfig(remat="none", loss_chunk=512, microbatches=1)
    for i, batch in enumerate(batches):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        data = DataConfig(seed=seed, batch_size=batch, seq_len=seq)
        rt = runtime(name=tag)
        t0 = time.perf_counter()
        trainer = Trainer(cfg, run, data, adamw.AdamWConfig(warmup_steps=2, total_steps=steps),
                          TrainerConfig(total_steps=steps, seed=seed), runtime=rt,
                          device="cuda")
        torch.cuda.synchronize()
        log(f"[{tag}] {lm.param_count(trainer.params) / 1e9:.3f} B params {cfg.dtype} + fp32 "
            f"AdamW master and moments: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            f"allocated; batch {batch} x {seq}; init {time.perf_counter() - t0:.1f} s")
        aux = gate_step1(trainer, cfg, run, data, tag, replay_routes=replay_routes)
        gate_peak = torch.cuda.max_memory_allocated()
        rt.telemetry.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        metrics, seen = [], {}
        for _ in range(steps):
            metrics.append(trainer.run_one_step())
            now = kernels.launch_counts()
            if by_step is not None:
                by_step.append({k: v - seen.get(k, 0) for k, v in now.items()})
            seen = now
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        log(f"[{tag}] peak memory allocated: {peak / 2**30:.2f} GiB over {steps} steps "
            f"({gate_peak / 2**30:.2f} GiB in the step-1 gate, the plain path's included)")
        if peak > TRAIN_PEAK_LIMIT and i + 1 < len(batches):
            log(f"[{tag}] the peak passes {TRAIN_PEAK_LIMIT / 2**30:.0f} GiB at batch {batch} x "
                f"{seq}: dropping to {batches[i + 1]} x {seq}")
            del trainer, metrics
            if by_step is not None:
                by_step.clear()
            continue
        log(f"[{tag}] batch {batch} x {seq} ran")
        return trainer, batch, metrics, launches, rt.telemetry.snapshot(), peak, aux
    raise AssertionError(f"{tag}: no batch ran")


def _train_checks(tag: str, snap, launches, want: dict) -> None:
    """No fwd or bwd dispatch at the reference tier, and each launch
    counter in ``want`` at its count."""
    log(f"[{tag}] launches: {launches}")
    log(f"[{tag}] telemetry by phase: {snap['phases']}")
    for phase in ("fwd", "bwd"):
        if snap["phases"].get(phase, {}).get("reference", 0):
            raise AssertionError(f"{tag}: {phase} dispatches fell to the reference tier: "
                                 f"{snap['phases'][phase]}")
    off = {k: (launches.get(k, 0), n) for k, n in want.items() if launches.get(k, 0) != n}
    if off:
        raise AssertionError(f"{tag}: launch counts (counted, expected): {off}")
    log(f"[{tag}] launch counts checked: {want}")


def _step_report(tag: str, metrics, tokens: int):
    """The step time (median of steps 2 on) and tokens/s; returns the ms."""
    times = [1e3 * m["step_time_s"] for m in metrics]
    losses = [m["loss"] for m in metrics]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite loss: {losses}")
    step_ms = float(np.median(times[1:]))
    norms = ", ".join(f"{m['grad_norm']:.3f}" for m in metrics)
    log(f"[{tag}] losses: {', '.join(f'{x:.4f}' for x in losses)}; grad norms: {norms}")
    log(f"[{tag}] step times (ms): {', '.join(f'{t:.1f}' for t in times)}; step time "
        f"{step_ms:.2f} ms median of steps 2-{len(times)}; {tokens / (step_ms / 1e3):.0f} "
        f"tokens/s ({tokens} tokens a step)")
    return step_ms


# The marker kernel tunable_share launches around each call of a tunable:
# torch.cuda._sleep(0)'s spin_kernel, which nothing else in a step runs.
MARKER = "spin_kernel"


def marked_device_ms(prof) -> tuple:
    """(device ms between each pair of MARKER kernels, device ms of the
    rest, markers left out, markers seen) in a torch.profiler window of one
    stream, its device activity in stream order."""
    evs = sorted((ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda ev: ev.time_range.start)
    inside, marks, in_us, out_us = False, 0, 0.0, 0.0
    for ev in evs:
        if MARKER in ev.name:
            inside, marks = not inside, marks + 1
        elif inside:
            in_us += ev.time_range.elapsed_us()
        else:
            out_us += ev.time_range.elapsed_us()
    return in_us / 1e3, out_us / 1e3, marks


def tunable_share(tag: str, name: str, step) -> None:
    """A dispatched tunable's share of two more steps. Host: its calls'
    host time (each call synchronised before and after) against the step's
    host clock. Device: a step under torch.profiler (device activity) with
    a MARKER kernel launched before and after each call; the device time of
    the kernels between each pair against the device busy time of that same
    step, markers left out (a kernel launched through ctypes is not linked
    to a host range, so the calls are found on the device's own timeline)."""
    from repro_torch.core.annotate import get_tunable

    tun = get_tunable(name)
    orig = tun.fn
    host = []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        return out

    def marked(*args, **kw):
        torch.cuda._sleep(0)
        out = orig(*args, **kw)
        torch.cuda._sleep(0)
        return out

    try:
        tun.fn = timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        tun.fn = marked
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        tun.fn = orig
    if not host:
        raise AssertionError(f"{tag}: no {name} call in the step")
    host_ms = 1e3 * sum(host)
    dev_ms, rest_ms, marks = marked_device_ms(prof)
    busy_ms = dev_ms + rest_ms
    if marks != 2 * len(host) or not dev_ms > 0:
        raise AssertionError(f"{tag}: torch.profiler saw {marks} markers around {len(host)} "
                             f"{name} calls, {dev_ms} ms of device time between them")
    log(f"[{tag}] {name}: {len(host)} calls a step; host clock {host_ms:.2f} ms of the "
        f"instrumented step's {wall_ms:.2f} ms ({100 * host_ms / wall_ms:.1f}%); device time "
        f"{dev_ms:.3f} ms of the profiled step's {busy_ms:.2f} ms busy "
        f"({100 * dev_ms / busy_ms:.1f}%; torch.profiler, the kernels between markers around "
        f"its calls)")


def phase_train(seed: int):
    """Train full-width qwen2_0_5b, 6 steps at batch 4 x 2048."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2_0_5b")
    steps = 6
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}")
    trainer, batch, metrics, launches, snap, _, _ = _train_run("train", cfg, seed, (4,), steps)
    missing = [k for k in TRAIN_KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the training path: {missing}")
    # one rmsnorm_bwd a norm a step: 2 a layer and the final one
    _train_checks("train", snap, launches, {"rmsnorm_bwd": (2 * cfg.num_layers + 1) * steps})
    check_routes(launches, "train", want=("tc",))
    tokens = batch * 2048
    step_ms = _step_report("train", metrics, tokens)
    by_name, busy = profile(f"train step ({tokens} tokens)", trainer.run_one_step, 1,
                            wall_ms=step_ms)
    kernel_share(f"train step ({tokens} tokens)", by_name, busy, "rmsnorm_bwd",
                 ("rmsnorm_bwd_rows", "rmsnorm_bwd_dw"))
    return launches, step_ms, [1e3 * m["step_time_s"] for m in metrics]


def phase_hybrid_train(seed: int):
    """Train Jamba without experts, one super-block, at the original Jamba's
    published widths."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("jamba_1_5_large"), num_experts=0, experts_per_token=0,
                              num_layers=8, d_model=4096, d_ff=14336, num_heads=32,
                              num_kv_heads=8)
    n_mamba, steps = 7, 4
    log(f"[hybrid-train] {cfg.name} without experts, one super-block (1 attention + "
        f"{n_mamba} Mamba layers, dense SwiGLU FFNs), width cut from Jamba-1.5-Large "
        f"(arXiv:2408.12570) to the original Jamba's published widths (arXiv:2403.19887, "
        f"ai21labs/Jamba-v0.1): d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.hd}, d_inner {cfg.mamba_expand * cfg.d_model}, "
        f"d_state {cfg.mamba_d_state}, dt_rank {-(-cfg.d_model // 16)}, vocab {cfg.vocab_size}")
    t_phase = time.perf_counter()
    trainer, batch, metrics, launches, snap, peak, _ = _train_run(
        "hybrid-train", cfg, seed, (2, 1), steps)
    # a step: 7 scans; 17 norms (2 a layer and the final one); the fp32 gemms
    # dt_proj and out_proj, each forward and its two gradients, 6 a Mamba layer
    _train_checks("hybrid-train", snap, launches, {
        "ssm_scan": n_mamba * steps, "rmsnorm_bwd": (2 * cfg.num_layers + 1) * steps,
        "matmul_simt": 6 * n_mamba * steps, "matmul_simt_tile": 6 * n_mamba * steps,
        "matmul_simt_loop": 0, "matmul_wmma": 0})
    missing = [k for k in ("flash_attention", "flash_attention_bwd", "softmax_xent_bwd",
                           "matmul_transposed") if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"hybrid-train: never launched: {missing}")
    bwd_keys = snap["by_key_phase"].get("bwd", {})
    if not any(k.startswith("ssm_scan_bwd|") for k in bwd_keys):
        raise AssertionError(f"hybrid-train: no ssm_scan_bwd dispatch in the backward: "
                             f"{sorted(bwd_keys)[:8]}")
    check_routes(launches, "hybrid-train", want=("tc", "simt"))
    tokens = batch * 2048
    step_ms = _step_report("hybrid-train", metrics, tokens)
    by_name, busy = profile(f"hybrid train step ({tokens} tokens)", trainer.run_one_step, 1,
                            wall_ms=step_ms)
    kernel_share("hybrid train step", by_name, busy, "ssm_scan", ("ssm_scan_ws",))
    kernel_share("hybrid train step", by_name, busy, "the fp32 route (every simt kernel)",
                 ("gemm_simt",))
    tunable_share("hybrid-train", "ssm_scan_bwd", trainer.run_one_step)
    log(f"[hybrid-train] phase took {time.perf_counter() - t_phase:.1f} s")
    del trainer
    return launches, batch


def phase_moe_train(seed: int):
    """Train Mixtral-8x7B at its published widths, 2 of its 32 layers."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("mixtral_8x7b"), num_layers=2)
    steps = 4
    log(f"[moe-train] {cfg.name} at its published widths cut to {cfg.num_layers} of 32 layers: "
        f"d_model {cfg.d_model}, {cfg.num_experts} experts top-{cfg.experts_per_token} of width "
        f"{cfg.d_ff}, window {cfg.window}, vocab {cfg.vocab_size}")
    t_phase = time.perf_counter()
    trainer, batch, metrics, launches, snap, peak, aux = _train_run(
        "moe-train", cfg, seed, (4, 2), steps, replay_routes=True)
    if not (np.isfinite(aux) and aux > 0):
        raise AssertionError(f"moe-train: the load-balancing loss is {aux}")
    # a layer a step: gate, up and down forward, and each one's two gradients
    # on transposed operands
    per = 3 * cfg.num_layers * steps
    _train_checks("moe-train", snap, launches, {
        "expert_gemm": 3 * per, "expert_gemm_tc": 3 * per, "expert_gemm_transposed": 2 * per,
        "matmul_wmma": 0, "expert_gemm_wmma": 0,
        "rmsnorm_bwd": (2 * cfg.num_layers + 1) * steps})
    missing = [k for k in ("flash_attention", "flash_attention_bwd", "softmax_xent_bwd")
               if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"moe-train: never launched: {missing}")
    check_routes(launches, "moe-train", want=("tc",), kernels=("matmul", "expert_gemm"))
    tokens = batch * 2048
    step_ms = _step_report("moe-train", metrics, tokens)
    profile(f"moe train step ({tokens} tokens)", trainer.run_one_step, 1, wall_ms=step_ms)
    tunable_share("moe-train", "expert_gemm", trainer.run_one_step)
    log(f"[moe-train] phase took {time.perf_counter() - t_phase:.1f} s")
    del trainer
    return launches, batch


# xLSTM-1.3B's prompts, served at exact length (an sLSTM layer's loop runs
# one step a token, so the host time of a prefill grows with its length).
XLSTM_LENGTHS = (16, 1500, 37, 300, 64, 8, 129, 24)
# Decode steps held layer by layer against the plain path.
XLSTM_GATE_STEPS = 8


class ScanClock:
    """Wraps ``ssm._slstm_scan`` (the sLSTM's token loop) while active: each
    call's (tokens, host seconds), the device synchronised before and after
    it, so the time is the loop's own and not the gemms' around it."""

    def __enter__(self):
        from repro_torch.models import ssm

        self._orig = orig = ssm._slstm_scan
        self.calls = []

        def timed(p, xw, n_heads):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(p, xw, n_heads)
            torch.cuda.synchronize()
            self.calls.append((xw.shape[1], time.perf_counter() - t0))
            return out

        ssm._slstm_scan = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ssm

        ssm._slstm_scan = self._orig


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.clone()


def _gate_serving(tag: str, what: str, n_layers: int, rec, pin, held, logits) -> dict:
    """Gate one computation: ``held`` (DispatchTap) the kernel path's matmul
    launches against the plain version on their own operands; layer by
    layer, ``rec`` the kernel path's tap (outputs, contributions, states)
    and ``pin`` the plain path's pinned to it: each layer's contribution
    (PrefillTap.branch) and each state leaf at TOL_GRAD; ``logits`` (kernel,
    plain) the head of each on the kernel path's last hidden state at
    TOL_LOGITS. A failure goes to GATE_FAILURES. Returns the worst
    readings."""
    held.gate(tag, what)
    layers = sorted(((r, f"layer {i}") for i, r in pin.branch.items()), reverse=True)
    states = sorted(((_rel(t, pin.states[i][leaf]), f"layer {i} state {leaf}")
                     for i in range(n_layers) if rec.states and rec.states[i]
                     for leaf, t in rec.states[i].items()), reverse=True)
    head = rel_err(logits[0].float(), logits[1].float())[1]
    worst = {"layer": layers[0][0], "state": states[0][0] if states else 0.0, "head": head}
    failed = [(round(r, 6), n) for r, n in layers + states if r > TOL_GRAD]
    if head > TOL_LOGITS:
        failed.append((round(head, 6), "head"))
    log(f"[{tag}] {what}, layer by layer (the plain path on the kernel path's layer inputs): "
        f"{len(layers)} layers' contributions (a recurrent mixer with no other branch: its "
        f"output; else the output less the input), ||a_k - a_p|| / ||a_p||: median "
        f"{layers[len(layers) // 2][0]:.3e}, max {layers[0][0]:.3e} ({layers[0][1]}); "
        f"{len(states)} state leaves max {worst['state']:.3e}"
        + (f" ({states[0][1]})" if states else "") + f" (tol {TOL_GRAD}); the head on the "
        f"kernel path's last hidden state: logits rel {head:.3e} (tol {TOL_LOGITS})")
    if failed:
        msg = (f"{tag}: {what}: {len(failed)} items over their limits, the worst (rel, item): "
               f"{sorted(failed, reverse=True)[:4]}")
        log(f"[{tag}] FAILED {msg}")
        GATE_FAILURES.append(msg)
    return worst


def phase_xlstm(seed: int):
    """Serve xLSTM-1.3B whole: all 48 layers at d_model 2048, bf16."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.runtime import runtime
    from repro_torch.kernels.matmul import DECODE_ROWS
    from repro_torch.models import lm
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import RunConfig
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    tag = "xlstm"
    cfg = get_config("xlstm_1_3b")
    n_m = sum(seg.repeats for seg in cfg.segments() for sp in seg.pattern if sp.mixer == "mlstm")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = lm.param_count(params)
    log(f"[{tag}] {cfg.name} (arXiv:2405.04517): all {cfg.num_layers} layers ({n_m} mLSTM, "
        f"{cfg.num_layers - n_m} sLSTM, no FFN), d_model {cfg.d_model}, {cfg.num_heads} heads, "
        f"mLSTM d_inner {2 * cfg.d_model}, sLSTM GeGLU width "
        f"{params['segments'][0][0]['l1']['mixer']['up_g'].shape[1]}, vocab {cfg.vocab_size}; "
        f"{n_params / 1e9:.3f} B params {cfg.dtype}, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ecfg = EngineConfig(max_batch=8, max_seq=2048)
    run = RunConfig()
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, cfg.vocab_size, n).astype(np.int32) for n in XLSTM_LENGTHS]
    rt = runtime(name=tag)
    engine = ServingEngine(cfg, run, params, ecfg, runtime=rt)
    for i, p in enumerate(prompts):
        engine.submit(Request(prompt=p, max_new_tokens=32, temperature=0.0 if i % 2 == 0
                              else 0.8, seed=seed + i, arrival_time=float(2 * i)))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with ScanClock() as clock:
        done = engine.serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = engine.stats
    snap = rt.telemetry.snapshot()
    log(f"[{tag}] launches during serving: {launches}")
    log(f"[{tag}] telemetry tiers: {snap['tiers']} over {snap['calls']} dispatches")
    missing = [k for k in ("matmul", "rmsnorm") if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched while serving: {missing}")
    if snap["tiers"].get("reference", 0):
        raise AssertionError(f"{tag}: {snap['tiers']['reference']} dispatches fell to the "
                             f"reference tier")
    check_routes(launches, tag, want=("tc", "decode", "simt"))
    if st["prefill_tokens"] != sum(XLSTM_LENGTHS):
        raise AssertionError(f"{tag}: prefill tokens {st['prefill_tokens']}: not at exact length")
    # each mLSTM layer's fp32 out_proj: the register-tiled kernel at a
    # prefill of more than 16 tokens, the row kernel at the others and at
    # every decode step, never the first port's loop
    n_long = sum(n > DECODE_ROWS for n in XLSTM_LENGTHS)
    want = {"tile": n_m * n_long, "rows": n_m * (st["decode_steps"] + len(XLSTM_LENGTHS) - n_long),
            "loop": 0}
    f32 = {k: launches.get(f"matmul_simt_{k}", 0) for k in want}
    if f32 != want:
        raise AssertionError(f"{tag}: fp32 gemms by kernel {f32}, expected {want}")
    for r in done:
        out = r.output
        if out is None or len(out) != 32 or out.min() < 0 or out.max() >= cfg.vocab_size:
            raise AssertionError(f"{tag}: bad output for a {len(r.prompt)}-token prompt: {out}")
    routes = {r: launches.get(f"matmul_{r}", 0) for r in ("tc", "decode", "simt", "wmma",
                                                          "splitk", "transposed")}
    log(f"[{tag}] served {len(done)} requests, {st['tokens_out']} tokens in {wall:.2f} s: "
        f"{st['tokens_out'] / wall:.1f} tokens/s; {st['decode_steps']} decode steps, "
        f"{st['prefill_calls']} prefills of {st['prefill_tokens']} tokens (exact length); "
        f"launches by kernel: matmul {launches['matmul']} (by route {routes}; fp32 {f32}), "
        f"rmsnorm {launches['rmsnorm']}, rmsnorm_matmul {launches.get('rmsnorm_matmul', 0)}")
    for L in sorted(engine.timings["prefill_s"]):
        ts = engine.timings["prefill_s"][L]
        loop = sum(sec for n, sec in clock.calls if n == L) / len(ts)
        log(f"[{tag}] prefill {L} tokens: {1e3 * float(np.median(ts)):.2f} ms, of which the "
            f"sLSTM token loop {1e3 * loop:.2f} ms ({100 * loop / float(np.mean(ts)):.1f}%, "
            f"{1e6 * loop / (L * (cfg.num_layers - n_m)):.1f} us a token a layer; host clock, "
            f"the device synchronised around each loop)")
    dec = engine.timings["decode_s"]
    w_bytes = (n_params - params["embed"]["table"].numel()) * 2
    s_bytes = sum(int(np.prod(shape)) * torch.tensor([], dtype=dt).element_size()
                  for seg in tf.cache_shapes(cfg, ecfg.max_batch, ecfg.max_seq)
                  for leaves in seg.values() for shape, dt in leaves.values())
    floor_ms = (w_bytes + 2 * s_bytes) / 3.35e12 * 1e3
    log(f"[{tag}] decode step (8 slots): {1e3 * float(np.median(dec)):.2f} ms median of "
        f"{len(dec)} (p90 {1e3 * float(np.percentile(dec, 90)):.2f} ms); computed floor "
        f"{floor_ms:.3f} ms = ({w_bytes / 1e9:.3f} GB of weights but the embedding table + 2 x "
        f"{s_bytes / 1e9:.3f} GB of pool state, read and written) / 3.35 TB/s (computed, not "
        f"measured)")
    log(f"[{tag}] peak memory allocated: {peak / 2**30:.2f} GiB (limit 75)")
    if peak > TRAIN_PEAK_LIMIT:
        raise AssertionError(f"{tag}: peak {peak / 2**30:.2f} GiB passes 75 GiB")

    # the engine's pool holds each slot's state after its last request
    pool = engine._caches
    tok = torch.zeros((ecfg.max_batch, 1), dtype=torch.long, device="cuda")
    pos = torch.full((ecfg.max_batch,), 1024, dtype=torch.long, device="cuda")

    def decode():
        with torch.inference_mode(), rt:
            lm.decode_step(params, tok, pool, pos, cfg, run)[0].float().cpu()

    profile(f"{tag} decode step (8 slots)", decode, 5)
    probe = torch.from_numpy(prompts[XLSTM_LENGTHS.index(300)].astype(np.int64))[None].cuda()

    def prefill():
        with torch.inference_mode(), rt:
            lm.prefill(params, {"tokens": probe}, cfg, run, cache_len=ecfg.max_seq)[0].float().cpu()

    profile(f"{tag} prefill 300 tokens", prefill, 1,
            wall_ms=1e3 * float(np.median(engine.timings["prefill_s"][300])))

    # The gates: each computation on the kernel path (recorded, its matmul
    # launches held) and on the plain path pinned to the kernel path's
    # layer outputs, layer by layer with every state.
    kern = lambda: runtime(mode="kernel", name=f"{tag}-kernel")
    plain = lambda: runtime(mode="reference", name=f"{tag}-plain")

    # The 1500-token prefill: end to end (printed) and layer by layer.
    L = 1500
    toks = torch.from_numpy(prompts[XLSTM_LENGTHS.index(L)].astype(np.int64))[None].cuda()
    t0 = time.perf_counter()
    with torch.inference_mode():
        pre = lambda: lm.prefill(params, {"tokens": toks}, cfg, run, cache_len=ecfg.max_seq)[0]
        with kern(), PrefillTap(states=True) as rec, DispatchTap() as held:
            lk = pre()
        with plain():
            lp = pre()
            with PrefillTap(pin=rec, states=True) as pin:
                lq = pre()
    if not (torch.isfinite(lk).all() and lk.shape == (1, cfg.vocab_size)):
        raise AssertionError(f"{tag}: kernel-path logits not finite / shape {tuple(lk.shape)}")
    abs_e, rel_e = rel_err(lk.float(), lp.float())
    log(f"[{tag}] prefill logits ({L} tokens), kernel vs plain path end to end through "
        f"{cfg.num_layers} layers (report; TOL_LOGITS {TOL_LOGITS} covers 24): max abs "
        f"{abs_e:.4g}, rel to max|plain| {rel_e:.3e}; argmax {int(lk.argmax())} vs "
        f"{int(lp.argmax())}; the three prefills in {time.perf_counter() - t0:.1f} s")
    _gate_serving(tag, f"prefill {L} tokens", cfg.num_layers, rec, pin, held, (lk, lq))
    del rec, pin

    # Decode: XLSTM_GATE_STEPS greedy steps of the 8-slot pool, the plain
    # pass on a copy of the pool's state from before the step.
    t0 = time.perf_counter()
    worst = {"layer": 0.0, "state": 0.0, "head": 0.0}
    for step in range(XLSTM_GATE_STEPS):
        before = _clone_tree(pool)
        dec = lambda caches: lm.decode_step(params, tok, caches, pos + step, cfg, run)[0]
        with torch.inference_mode():
            with kern(), PrefillTap(mode="decode", states=True) as rec, DispatchTap() as held:
                lk = dec(pool)
            with plain(), PrefillTap(pin=rec, mode="decode", states=True) as pin:
                lq = dec(before)
        if not torch.isfinite(lk).all():
            raise AssertionError(f"{tag}: decode step {step}: kernel-path logits not finite")
        w = _gate_serving(tag, f"decode step {step + 1} (8 slots)", cfg.num_layers, rec, pin,
                          held, (lk, lq))
        worst = {k: max(worst[k], w[k]) for k in worst}
        tok = lk.argmax(-1, keepdim=True)
        del before, rec, pin
    log(f"[{tag}] {XLSTM_GATE_STEPS} decode steps gated layer by layer in "
        f"{time.perf_counter() - t0:.1f} s; worst over them, kernel vs plain: layer "
        f"{worst['layer']:.3e}, state {worst['state']:.3e} (tol {TOL_GRAD}), head "
        f"{worst['head']:.3e} (tol {TOL_LOGITS})")

    # Continuity: a prefill of L tokens and one decode step on the kernel
    # path against the plain path's prefill of L + 1 (the prompt and the
    # kernel path's token), layer by layer at the last position (the plain
    # pass on the kernel path's layer outputs: the prefill's for the first
    # L positions, the decode step's for the last) with the state after it,
    # and end to end (printed).
    L = 129
    toks = torch.from_numpy(prompts[XLSTM_LENGTHS.index(L)].astype(np.int64))[None].cuda()
    with torch.inference_mode():
        with kern(), DispatchTap() as held:
            with PrefillTap() as rec_pre:
                lg, cache = lm.prefill(params, {"tokens": toks}, cfg, run,
                                       cache_len=ecfg.max_seq)
            one = lm.insert_cache(lm.init_cache(cfg, 1, ecfg.max_seq, "cuda"), cache, 0)
            nxt = lg.argmax(-1, keepdim=True)
            with PrefillTap(mode="decode", states=True) as rec:
                lk, _ = lm.decode_step(params, nxt, one, torch.tensor([L], device="cuda"), cfg,
                                       run)
        toks1 = torch.cat([toks, nxt], dim=1)
        pinned = [torch.cat([a, b], dim=1) for a, b in zip(rec_pre.outs, rec.outs)]
        pre = lambda: lm.prefill(params, {"tokens": toks1}, cfg, run, cache_len=ecfg.max_seq)[0]
        with plain():
            lp = pre()
            with PrefillTap(pin=rec, outs=pinned, pos=slice(-1, None), states=True) as pin:
                lq = pre()
    abs_e, rel_e = rel_err(lk.float(), lp.float())
    log(f"[{tag}] continuity: decode after a {L}-token prefill (kernel path) against the plain "
        f"path's prefill of {L + 1} tokens, end to end (report): max abs {abs_e:.4g}, rel "
        f"{rel_e:.3e}; argmax {int(lk.argmax())} vs {int(lp.argmax())}")
    _gate_serving(tag, f"continuity, prefill {L} + decode 1 against prefill {L + 1}",
                  cfg.num_layers, rec, pin, held, (lk, lq))
    del rec_pre, rec, pin, pinned, one, cache, engine, pool
    log(f"[{tag}] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_xlstm_train(seed: int):
    """Train xLSTM-1.3B whole, batch 4 x 512."""
    from repro_torch.configs import get_config

    tag = "xlstm-train"
    cfg = get_config("xlstm_1_3b")
    n_m = sum(seg.repeats for seg in cfg.segments() for sp in seg.pattern if sp.mixer == "mlstm")
    steps, seq = 2, 512
    log(f"[{tag}] {cfg.name} at full width and depth ({cfg.num_layers} layers), batch 4 x {seq} "
        f"(2048 tokens a step; the sLSTM loop runs 512 steps a layer, the fewest the phase "
        f"allows), remat 'none': a step's activations, about 27 GiB, fit beside the 43.6 GiB of "
        f"parameters, fp32 master, moments and gradients, and recomputing each layer would "
        f"run its loop again")
    t_phase = time.perf_counter()
    trainer, batch, metrics, launches, snap, peak, _ = _train_run(
        tag, cfg, seed, (4,), steps, seq=seq)
    if peak > TRAIN_PEAK_LIMIT:
        raise AssertionError(f"{tag}: peak {peak / 2**30:.2f} GiB passes 75 GiB")
    # a step: one rmsnorm_bwd a norm (48 and the final one); each mLSTM
    # layer's fp32 out_proj forward and its two gradients
    f32 = 3 * n_m * steps
    _train_checks(tag, snap, launches, {
        "rmsnorm_bwd": (cfg.num_layers + 1) * steps, "matmul_simt": f32,
        "matmul_simt_tile": f32, "matmul_simt_loop": 0, "matmul_wmma": 0,
        "softmax_xent": steps, "softmax_xent_bwd": steps})
    missing = [k for k in ("rmsnorm", "matmul_transposed") if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{tag}: never launched: {missing}")
    check_routes(launches, tag, want=("tc", "simt"))
    log(f"[{tag}] launches in {steps} steps: matmul {launches['matmul']} (by route "
        f"{ {r: launches.get(f'matmul_{r}', 0) for r in ('tc', 'decode', 'simt', 'wmma')} }, "
        f"transposed {launches.get('matmul_transposed', 0)}, split-k "
        f"{launches.get('matmul_splitk', 0)}), rmsnorm {launches['rmsnorm']}, rmsnorm_bwd "
        f"{launches['rmsnorm_bwd']}, softmax_xent {launches['softmax_xent']}, softmax_xent_bwd "
        f"{launches['softmax_xent_bwd']}")
    tokens = batch * seq
    step_ms = _step_report(tag, metrics, tokens)
    profile(f"{tag} step ({tokens} tokens)", trainer.run_one_step, 1, wall_ms=step_ms)
    log(f"[{tag}] peak memory allocated: {peak / 2**30:.2f} GiB (limit 75)")
    log(f"[{tag}] phase took {time.perf_counter() - t_phase:.1f} s")
    del trainer
    return launches, batch


ALL_KERNELS = TRAIN_KERNELS + ("matmul_bias_act", "rmsnorm_matmul")


def phase_campaign(seed: int, budget: int, workdir: str):
    """Plan, tune on the card and export a database for full-width
    qwen2_0_5b; returns the exported database's path."""
    from repro_torch import kernels
    from repro_torch.campaign import planner, runner, scheduler
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.annotate import get_tunable
    from repro_torch.core.database import TuningDatabase
    from repro_torch.core.evaluate import WallClockEvaluator
    from repro_torch.core.platform import detect_platform
    from repro_torch.models.transformer import RunConfig

    cfg = get_config("qwen2_0_5b")
    run = RunConfig(remat="none", loss_chunk=512, microbatches=1)
    # serving at the token cap the engine's warmup plans with (its default,
    # 65536), so the campaign tunes every key the warmup resolves: with the
    # planner's 8192 it would leave out the plain decode attention's
    # attn_chunks lookup at the pool's full depth (8 x 2048 rows)
    jobs = (planner.plan_training_jobs(cfg, SHAPES["train_2k"], run=run)
            + planner.plan_serving_jobs(cfg, max_batch=8, max_seq=2048, max_tokens=65536))
    prof = detect_platform("cuda")
    manifest = scheduler.build_manifest(jobs, budget, path=os.path.join(workdir, "campaign.json"),
                                        profile=prof, min_budget=2, max_budget=8)
    log(f"[campaign] planned {len(jobs)} jobs -> {len(manifest.jobs)} unique keys on "
        f"{manifest.platform}, budget {budget} evaluations (2 to 8 a job)")
    db = TuningDatabase(os.path.join(workdir, "tuning.json"))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = runner.run_campaign(manifest, db, evaluator=WallClockEvaluator(repeats=3, warmup=1),
                                  arg_seed=seed, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    out_path = os.path.join(workdir, f"{manifest.platform}.db.json")
    exported = runner.export_campaign_db(db, out_path, manifest.platform)
    pruned = manifest.meta.get("pruned", {})
    log(f"[campaign] {summary['done']} of {summary['jobs']} jobs done, {summary['poisoned']} "
        f"poisoned, {summary['deferred']} deferred; {summary['evaluations_spent']} trials "
        f"(+1 heuristic-config measurement a job); pruned trials by reason: {pruned or 'none'}; "
        f"{seconds:.1f} s; exported {len(exported)} records "
        f"+ {sum(len(v) for v in exported.covers().values())} cover entries")
    log(f"[campaign] launches during tuning: {launches}")
    by_kernel = {}
    for j in manifest.jobs:
        rec = exported.lookup(j.db_key(manifest.platform))
        ok = (j.status == "done" and rec is not None and 0 < rec.objective < float("inf")
              and np.isfinite(j.best_objective) and np.isfinite(j.default_objective))
        if not ok:
            raise AssertionError(f"job {j.kernel} {j.arg_shapes} {j.key_extra} banked no gated "
                                 f"record: status {j.status}, error {j.error!r}, record {rec}")
        if not get_tunable(j.kernel).space.is_valid(rec.config):
            raise AssertionError(f"job {j.kernel} {j.arg_shapes}: banked config {rec.config} "
                                 f"is not in the space")
        agg = by_kernel.setdefault(j.kernel, [0, 0.0, 0.0, 0])
        agg[0] += 1
        agg[1] += j.best_objective
        agg[2] += j.default_objective
        agg[3] += int(j.best_objective < j.default_objective)
        log(f"[campaign]   {j.kernel:<20} {'/'.join('x'.join(map(str, s)) for s in j.arg_shapes)}"
            f" {j.key_extra} {rec.config}: tuned {1e3 * j.best_objective:.4f} ms, heuristic "
            f"{1e3 * j.default_objective:.4f} ms ({j.evaluations} trials)")
    for kernel, (n, best, default, won) in sorted(by_kernel.items()):
        log(f"[campaign] {kernel}: {n} jobs, tuned configs {1e3 * best:.4f} ms vs heuristic "
            f"configs {1e3 * default:.4f} ms summed over one call each (same calls); the "
            f"search beat the heuristic on {won}")
    missing = [k for k in ALL_KERNELS if k != "matmul_transposed" and launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched while tuning: {missing}")
    return out_path, launches


def phase_tuned(seed: int, db_path: str, heuristic_step_ms: float, heuristic_steps):
    """Serve and train full-width qwen2_0_5b from the campaign's database:
    every dispatch at the exact tier, both fused kernels launched."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.database import TuningDatabase
    from repro_torch.core.runtime import runtime
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import lm
    from repro_torch.models.transformer import RunConfig
    from repro_torch.optim import adamw
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
    from repro_torch.train import Trainer, TrainerConfig

    def only_exact(snap, label):
        for phase, tiers in snap["phases"].items():
            if phase in ("fwd", "bwd") and set(tiers) - {"exact"}:
                off = {k: t for k, t in snap["by_key_phase"][phase].items()
                       if set(t) - {"exact"}}
                raise AssertionError(f"{label}: {phase} dispatches off the exact tier: "
                                     f"{tiers}; keys {list(off)[:6]}")

    db = TuningDatabase(db_path)
    cfg = get_config("qwen2_0_5b")
    run = RunConfig()
    params = lm.init_params(cfg, seed=seed, device="cuda")
    rt = runtime(db=db, name="tuned-serve")
    engine = ServingEngine(cfg, run, params, EngineConfig(max_batch=8, max_seq=2048), runtime=rt)
    t0 = time.perf_counter()
    resolved = engine.warmup()
    log(f"[tuned] warmup resolved {len(resolved)} bucket keys in "
        f"{time.perf_counter() - t0:.2f} s: {rt.telemetry.snapshot()['tiers']}")
    rs = np.random.RandomState(seed + 1)
    for i, n in enumerate((40, 700, 16, 1500, 300, 64)):
        engine.submit(Request(prompt=rs.randint(0, cfg.vocab_size, n).astype(np.int32),
                              max_new_tokens=16, temperature=0.0 if i % 2 == 0 else 0.8,
                              seed=seed + i, arrival_time=float(3 * i)))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_launches = kernels.launch_counts()
    snap = rt.telemetry.snapshot()
    log(f"[tuned] served {len(done)} requests, {engine.stats['tokens_out']} tokens in "
        f"{wall:.2f} s; decode step {1e3 * float(np.median(engine.timings['decode_s'])):.2f} ms "
        f"median; launches {serve_launches}; tiers {snap['tiers']}")
    only_exact(snap, "tuned serving")
    check_routes(serve_launches, "tuned serving", want=())
    if serve_launches.get("matmul_tc", 0) + serve_launches.get("matmul_decode", 0) <= 0:
        raise AssertionError(f"tuned serving: no tensor-core gemm launched: {serve_launches}")
    if serve_launches.get("rmsnorm_matmul", 0) <= 0:
        raise AssertionError("rmsnorm_matmul never launched on the tuned decode path")
    # the decode unembed is a shape TMA addresses: the norm prologue on a
    # tensor-core route, never the WMMA loop
    check_routes(serve_launches, "tuned serving", want=(), kernels=("rmsnorm_matmul",))
    if serve_launches.get("rmsnorm_matmul_decode", 0) + serve_launches.get(
            "rmsnorm_matmul_tc", 0) != serve_launches["rmsnorm_matmul"]:
        raise AssertionError(f"tuned serving: rmsnorm_matmul launched off the tensor-core "
                             f"routes: {serve_launches}")
    for r in done:
        if r.output is None or len(r.output) != 16:
            raise AssertionError(f"bad output for a {len(r.prompt)}-token prompt: {r.output}")
    toks = torch.zeros((1, 512), dtype=torch.long, device="cuda")
    toks[0, :300] = torch.from_numpy(rs.randint(0, cfg.vocab_size, 300))
    logits = {}
    with torch.inference_mode():
        for mode, scope in (("kernel", rt), ("reference", runtime(mode="reference"))):
            with scope:
                logits[mode], _ = lm.prefill(params, {"tokens": toks}, cfg, run,
                                             cache_len=2048, true_len=300)
    lk, lr = logits["kernel"].float(), logits["reference"].float()
    abs_err, rel = rel_err(lk, lr)
    log(f"[tuned] prefill logits (300 tokens, bucket 512) tuned kernel path vs plain path: max "
        f"abs {abs_err:.4g}, rel to max|plain| {rel:.3e} (tol {TOL_LOGITS})")
    if not torch.isfinite(lk).all() or rel > TOL_LOGITS:
        raise AssertionError(f"tuned prefill logits differ: rel {rel:.3g} > {TOL_LOGITS}")
    only_exact(rt.telemetry.snapshot(), "tuned prefill")
    del engine, params, logits

    run = RunConfig(remat="none", loss_chunk=512, microbatches=1)
    data = DataConfig(seed=seed, batch_size=4, seq_len=2048)
    trt = runtime(db=db, name="tuned-train")
    trainer = Trainer(cfg, run, data, adamw.AdamWConfig(warmup_steps=2, total_steps=2),
                      TrainerConfig(total_steps=2, seed=seed), runtime=trt, device="cuda")
    gate_step1(trainer, cfg, run, data, "tuned")
    trt.telemetry.reset()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    metrics = trainer.train()
    torch.cuda.synchronize()
    train_launches = kernels.launch_counts()
    snap = trt.telemetry.snapshot()
    log(f"[tuned] launches over 2 steps: {train_launches}")
    log(f"[tuned] telemetry by phase: {snap['phases']}")
    only_exact(snap, "tuned training")
    check_routes(train_launches, "tuned training", want=())
    if train_launches.get("matmul_tc", 0) + train_launches.get("matmul_decode", 0) <= 0:
        raise AssertionError(f"tuned training: no tensor-core gemm launched: {train_launches}")
    missing = [k for k in TRAIN_KERNELS + ("matmul_bias_act",)
               if train_launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the tuned training path: {missing}")
    # the training gate [8192,896]@[896,4864] is a tensor-core shape
    off_tc = {r: v for r in ("decode", "wmma", "simt")
              if (v := train_launches.get(f"matmul_bias_act_{r}", 0))}
    if off_tc or train_launches.get("matmul_bias_act_tc", 0) != train_launches["matmul_bias_act"]:
        raise AssertionError(f"tuned training: matmul_bias_act launched off the tc route: "
                             f"{off_tc}, {train_launches}")
    losses = [m["loss"] for m in metrics]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    step_ms = 1e3 * metrics[-1]["step_time_s"]
    log(f"[tuned] losses {', '.join(f'{x:.4f}' for x in losses)}")
    tuned_steps = ", ".join(f"{1e3 * m['step_time_s']:.2f}" for m in metrics)
    heur_steps = ", ".join(f"{t:.2f}" for t in heuristic_steps)
    log(f"[tuned] train step (ms), tuned database vs heuristic configs, same call: step 2 "
        f"{step_ms:.2f} vs median of steps 2-6 {heuristic_step_ms:.2f}; every step: tuned "
        f"{tuned_steps}; heuristic {heur_steps} (reported, not claimed)")
    profile(f"tuned train step ({data.batch_size * data.seq_len} tokens)", trainer.run_one_step,
            1, wall_ms=step_ms)
    return serve_launches, train_launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--campaign-budget", type=int, default=200,
                    help="global evaluation budget of the campaign phase")
    args = ap.parse_args()
    kind, count, smi = phase_device()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False     # plain fp32 versions stay fp32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.platform import detect_platform
    from repro_torch.kernels import KERNEL_SOURCES

    prof = detect_platform("cuda")
    log(f"[device] profile {prof.name}: {prof.sm_count} SMs, {prof.smem_per_block} B smem/block, "
        f"peaks {prof.peak_flops_bf16 / 1e12:.0f} TFLOP/s bf16, {prof.hbm_bandwidth / 1e12:.2f} TB/s")
    t0 = time.perf_counter()

    def timed(name, fn, *fargs):
        """Run one phase, its seconds logged; the card's cache emptied and
        the health check run after."""
        t = time.perf_counter()
        out = fn(*fargs)
        torch.cuda.empty_cache()
        log(f"[time] phase {name}: {time.perf_counter() - t:.1f} s")
        health_check(name)
        return out

    timed("build", phase_build)
    results = timed("kernels", phase_kernels, prof, args.seed)
    serve_launches = timed("serve", phase_serve, args.seed)
    timed("faults", phase_faults, args.seed)
    hybrid_launches = timed("hybrid", phase_hybrid, args.seed)
    moe_launches = timed("moe", phase_moe, args.seed)
    gemma_launches = timed("gemma", phase_gemma, args.seed)
    archs_launches = timed("archs", phase_archs, args.seed)
    xlstm_launches = timed("xlstm", phase_xlstm, args.seed)
    train_launches, heuristic_step_ms, heuristic_steps = timed("train", phase_train, args.seed)
    pali_launches, pali_batch = timed("paligemma-train", phase_paligemma_train, args.seed)
    hybrid_train_launches, hybrid_batch = timed("hybrid-train", phase_hybrid_train, args.seed)
    moe_train_launches, moe_batch = timed("moe-train", phase_moe_train, args.seed)
    xlstm_train_launches, xlstm_batch = timed("xlstm-train", phase_xlstm_train, args.seed)
    with tempfile.TemporaryDirectory() as workdir:
        db_path, _ = timed("campaign", phase_campaign, args.seed, args.campaign_budget, workdir)
        tuned_serve, tuned_train = timed("tuned", phase_tuned, args.seed, db_path,
                                         heuristic_step_ms, heuristic_steps)

    # Each entry pairs the training run's launches with a training shape;
    # the three kernels that serving also launches carry a "serve" object
    # that pairs the serving run's launches with a serving shape. The fused
    # kernels run only on the tuned database: matmul_bias_act's entry pairs
    # the tuned training run's launches with the gate projection, and
    # rmsnorm_matmul's (a serving kernel) the tuned serving run's launches
    # with the decode unembed. The two SSM kernels run only on the hybrid
    # path: their entries pair the hybrid serving run's launches with the
    # longest prefill's scan and the pool's update, and the three serving
    # kernels carry a "hybrid" object as well. The representative shapes:
    # training's unembed chunk and full-step shapes, serving's decode
    # unembed, largest prefill bucket and b=1 attention, the hybrid's fp32
    # out_proj at prefill and its attention at head dim 128. expert_gemm runs
    # only on the MoE path: its entry pairs the moe serving run's launches
    # with the decode pool's gate projection, and the three serving kernels
    # carry a "moe" object too (the decode unembed, the 8192 bucket's norm
    # and its windowed attention). The two training phases add an object
    # each: ssm_scan's "hybrid_train" pairs the hybrid training run's
    # launches with its scan at batch 2 x 2048, d_inner 8192, expert_gemm's
    # "moe_train" the MoE training run's with the gate projection at
    # capacity 2560 (batch 4 x 2048), each with the batch the phase ran;
    # ssm_scan's "bwd_torch" holds the backward tunable's times. The new
    # archs add three: "gemma" pairs the Gemma3-27B serving run's launches
    # with its local attention, FFN gemm, norm and decode unembed (the
    # serving kernels and rmsnorm_matmul), "paligemma_train" the PaliGemma
    # training run's with the flash kernels at d = 256 (with its batch), and
    # expert_gemm's "arctic" the archs phase's Arctic launches with its
    # prefill's capacity at 128 experts. xLSTM adds two: "xlstm" pairs the
    # xLSTM serving run's launches with the sLSTM MLP's up_g at 2048 rows
    # (n = 2752) and the norm at d 2048 (matmul and rmsnorm), "xlstm_train"
    # the xLSTM training run's with the same gemm, the norm and its
    # backward and the loss chunk at vocab 50,304 (with its batch); matmul's
    # two carry their launches by route.
    pick = {"train": {"matmul": "[2048,896]@[896,151936] bf16", "rmsnorm": "[8192,896] bf16",
                      "rmsnorm_bwd": "[8192,896] bf16", "softmax_xent": "[2048,151936] bf16",
                      "softmax_xent_bwd": "[2048,151936] bf16",
                      "flash_attention": "q[4,14,2048,64] kv[4,2,2048,64] causal bf16",
                      "flash_attention_bwd": "q[4,14,2048,64] kv[4,2,2048,64] causal bf16",
                      "matmul_bias_act": "[8192,896]@[896,4864] bf16 asilu"},
            "serve": {"matmul": "[8,896]@[896,151936] bf16", "rmsnorm": "[2048,896] bf16",
                      "flash_attention": "q[1,14,2048,64] kv[1,2,2048,64] causal bf16",
                      "rmsnorm_matmul": "[8,896]x[896,151936] bf16"},
            "hybrid": {"matmul": "[2048,16384]@[16384,8192] f32", "rmsnorm": "[2048,8192] bf16",
                       "flash_attention": "q[1,64,2048,128] kv[1,8,2048,128] causal bf16",
                       "ssm_scan": "b=1 s=2048 di=16384 ds=16 xc bf16",
                       "ssm_update": "b=8 di=16384 ds=16 xc bf16"},
            "moe": {"matmul": "[8,4096]@[4096,32000] bf16", "rmsnorm": "[8192,4096] bf16",
                    "flash_attention": "q[1,32,8192,128] kv[1,8,8192,128] causal w4096 bf16",
                    "expert_gemm": "[8,2,4096]@[8,4096,14336] bf16"},
            "hybrid_train": {"ssm_scan": "b=2 s=2048 di=8192 ds=16 xc bf16"},
            "moe_train": {"expert_gemm": "[8,2560,4096]@[8,4096,14336] bf16"},
            "gemma": {"matmul": "[8,5376]@[5376,21504] bf16", "rmsnorm": "[4096,5376] bf16",
                      "flash_attention": "q[1,32,3000,128] kv[1,16,3000,128] causal w1024 bf16",
                      "rmsnorm_matmul": "[8,5376]x[5376,262144] bf16"},
            "paligemma_train": {
                "flash_attention": "q[2,8,2048,256] kv[2,1,2048,256] causal bf16",
                "flash_attention_bwd": "q[2,8,2048,256] kv[2,1,2048,256] causal bf16"},
            "arctic": {"expert_gemm": "[128,10,7168]@[128,7168,4864] bf16"},
            "xlstm": {"matmul": "[2048,2048]@[2048,2752] bf16", "rmsnorm": "[2048,2048] bf16"},
            "xlstm_train": {"matmul": "[2048,2048]@[2048,2752] bf16",
                            "rmsnorm": "[2048,2048] bf16", "rmsnorm_bwd": "[2048,2048] bf16",
                            "softmax_xent": "[2048,50304] bf16",
                            "softmax_xent_bwd": "[2048,50304] bf16"}}
    main_path = {"matmul_bias_act": ("train", tuned_train),
                 "rmsnorm_matmul": ("serve", tuned_serve),
                 "ssm_scan": ("hybrid", hybrid_launches),
                 "ssm_update": ("hybrid", hybrid_launches),
                 "expert_gemm": ("moe", moe_launches)}
    timing_keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def at(name, path, launches):
        top = next(r for r in results[name] if r["path"] in (path, path.split("_")[0])
                   and r["shape"] == pick[path][name])
        return {"path": path, "launches": launches.get(name, 0),
                **{k: top[k] for k in timing_keys}}

    bwd_torch = results.pop("ssm_scan_bwd")

    entries = []
    for name, rows in results.items():
        src, replaces = KERNEL_SOURCES[name]
        path, launches = main_path.get(name, ("train", train_launches))
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "max_abs_err": max(r["max_abs_err"] for r in rows),
                 **at(name, path, launches), "shapes": rows}
        if name == "matmul":
            entry["launches_transposed"] = train_launches.get("matmul_transposed", 0)
        if name in ("matmul", "expert_gemm", "matmul_bias_act", "rmsnorm_matmul"):
            entry["launches_by_route"] = {r: launches.get(f"{name}_{r}", 0)
                                          for r in ("tc", "decode", "simt", "wmma", "splitk")}
        if name == "ssm_scan":
            entry["hybrid_train"] = dict(at(name, "hybrid_train", hybrid_train_launches),
                                         batch=hybrid_batch)
            entry["bwd_torch"] = bwd_torch
        if name == "expert_gemm":
            entry["moe_train"] = dict(at(name, "moe_train", moe_train_launches),
                                      batch=moe_batch)
            entry["moe_train"]["launches_by_route"] = {
                r: moe_train_launches.get(f"expert_gemm_{r}", 0)
                for r in ("tc", "decode", "simt", "wmma", "splitk", "transposed")}
        if name in SERVE_KERNELS:
            entry["serve"] = at(name, "serve", serve_launches)
            entry["hybrid"] = at(name, "hybrid", hybrid_launches)
            entry["moe"] = at(name, "moe", moe_launches)
        if name in SERVE_KERNELS + ("rmsnorm_matmul",):
            entry["gemma"] = at(name, "gemma", gemma_launches)
        if name in ("flash_attention", "flash_attention_bwd"):
            entry["paligemma_train"] = dict(at(name, "paligemma_train", pali_launches),
                                            batch=pali_batch)
        if name == "expert_gemm":
            entry["arctic"] = at(name, "arctic", archs_launches["arctic_480b"])
        if name in pick["xlstm"]:
            entry["xlstm"] = at(name, "xlstm", xlstm_launches)
        if name in pick["xlstm_train"]:
            entry["xlstm_train"] = dict(at(name, "xlstm_train", xlstm_train_launches),
                                        batch=xlstm_batch)
        if name == "matmul":
            for key, by in (("xlstm", xlstm_launches), ("xlstm_train", xlstm_train_launches)):
                entry[key]["launches_by_route"] = {
                    r: by.get(f"matmul_{r}", 0)
                    for r in ("tc", "decode", "simt", "wmma", "splitk", "transposed")}
        entries.append(entry)
    log(f"[summary] {time.perf_counter() - t0:.1f} s after the device check")
    log(smi)
    log(json.dumps({"kernels": entries}))
    if GATE_FAILURES:
        for msg in GATE_FAILURES:
            log(f"[FAILED] {msg}")
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

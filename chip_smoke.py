"""End-to-end smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure (non-zero exit, no result line):

1. device  — a CUDA card must be present; prints its name, the device
             count and ``nvidia-smi --query-gpu=name,power.limit``;
2. build   — builds every CUDA kernel of the serving path from
             ``src/repro_torch/kernels/csrc`` (one nvcc per source, in
             parallel) and prints nvcc's register / shared-memory / spill
             report;
3. kernels — runs each kernel at the serving path's shapes in bf16, at its
             heuristic config and at one other legal config, holds it
             against its plain PyTorch version on the card, and times
             kernel, plain version and the one-call PyTorch yardstick with
             CUDA events, beside the card's bound for the same work;
4. serve   — full-width qwen2_0_5b in bf16 from a seeded random init,
             ServingEngine(max_batch=8, max_seq=2048), 16 staggered
             requests with prompts of 16..1500 tokens and 32 new tokens
             each; every kernel's launch counter must rise and no dispatch
             may fall to the reference tier; one prefill's logits are held
             against the plain (reference-mode) path, and torch.profiler
             splits a decode step and the largest prefill by kernel;
5. summary — one ``{"kernels": [...]}`` line, then the last line
             ``{"ok": true, "device": {...}}``.

Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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
# Whole-model prefill logits, kernel path vs plain path: 24 layers of bf16
# activations whose roundings differ (rmsnorm's kernel multiplies by the
# weight before its cast, the reference after), so a few percent.
TOL_LOGITS = 5e-2


def log(msg: str = "") -> None:
    print(msg, flush=True)


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


def phase_build():
    from repro_torch.kernels import _build

    names = ["matmul", "rmsnorm", "flash_attention"]
    t0 = time.perf_counter()
    _build.build_all(names)
    log(f"[build] {len(names)} libraries in {time.perf_counter() - t0:.1f} s "
        f"into {_build.BUILD_DIR}")
    for n in names:
        for line in _build.ptxas_report(n).splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry")):
                log(f"[build] {n}: {line.strip()}")


def _matmul_case(prof, rows, m, k, n, gen):
    from repro_torch.kernels import matmul as mm

    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5).to(torch.bfloat16)
    heur = mm.matmul.default_config(x, w)
    # the other legal config: the first heuristic's pick, which the current
    # one replaced after a card run
    other = {"bm": 16, "bn": 32, "bk": 32} if m <= 16 else {"bm": 128, "bn": 32, "bk": 32}
    plain = mm.matmul_plain(x, w)
    errs = []
    for cfg in (heur, other):
        if not mm.MATMUL_SPACE.is_valid(cfg):
            raise AssertionError(f"illegal matmul config {cfg}")
        out = mm.matmul_cuda(x, w, **cfg)
        torch.cuda.synchronize()
        errs.append(rel_err(out, plain))
        if errs[-1][1] > TOL_BF16:
            raise AssertionError(f"matmul {m}x{k}x{n} {cfg}: rel err {errs[-1][1]:.3g} > {TOL_BF16}")
    ms = time_ms(lambda: mm.matmul_cuda(x, w, **heur))
    ms_other = time_ms(lambda: mm.matmul_cuda(x, w, **other))
    plain_ms = time_ms(lambda: mm.matmul_plain(x, w))
    lib_ms = time_ms(lambda: torch.matmul(x, w))
    b_ms, b_by = bound(prof, (m * k + k * n + m * n) * 2, 2.0 * m * n * k, prof.peak_flops_bf16)
    row = dict(shape=f"[{m},{k}]@[{k},{n}] bf16", config=heur, ms=ms, other_config=other,
               other_ms=ms_other, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, max_abs_err=max(e[0] for e in errs),
               max_rel_err=max(e[1] for e in errs))
    rows.append(row)
    log(f"[kernels] matmul {row['shape']}: {ms:.4f} ms {heur} ({ms_other:.4f} ms {other}); "
        f"plain {plain_ms:.4f}, torch.matmul {lib_ms:.4f}, bound {b_ms:.4f} ({b_by}); "
        f"err {row['max_abs_err']:.3g} (rel {row['max_rel_err']:.2e} <= {TOL_BF16})")


def _rmsnorm_case(prof, rows_out, rows, d, gen):
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
    ms = time_ms(lambda: rn.rmsnorm_cuda(x, w, **heur))
    ms_other = time_ms(lambda: rn.rmsnorm_cuda(x, w, **other))
    plain_ms = time_ms(lambda: rn.rmsnorm_plain(x, w))
    lib_ms = (time_ms(lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6))
              if hasattr(torch.nn.functional, "rms_norm") else None)
    nbytes = rows * d * 2 * 2 + d * 2 + rows * 4
    b_ms, b_by = bound(prof, nbytes, 4.0 * rows * d, prof.peak_flops_fp32)
    row = dict(shape=f"[{rows},{d}] bf16", config=heur, ms=ms, other_config=other,
               other_ms=ms_other, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, max_abs_err=max(e[0] for e in errs),
               max_rel_err=max(e[1] for e in errs))
    rows_out.append(row)
    log(f"[kernels] rmsnorm {row['shape']}: {ms:.4f} ms {heur} ({ms_other:.4f} ms {other}); "
        f"plain {plain_ms:.4f}, F.rms_norm {lib_ms}, bound {b_ms:.4f} ({b_by}); "
        f"err {row['max_abs_err']:.3g} (rel {row['max_rel_err']:.2e} <= {TOL_BF16})")


def _flash_case(prof, rows, s, gen, h=14, kvh=2, d=64):
    from repro_torch.kernels import attention as fa

    mk = lambda n: torch.randn((1, n, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = mk(h), mk(kvh), mk(kvh)
    heur = fa.flash_attention.default_config(q, k, v)
    other = {"block_q": 64, "block_k": 64} if s >= 64 else {"block_q": 16, "block_k": 32}
    p_out, p_lse = fa.flash_attention_plain(q, k, v, causal=True)
    errs = []
    for cfg in (heur, other):
        out, lse = fa.flash_attention_cuda(q, k, v, causal=True, **cfg)
        torch.cuda.synchronize()
        errs.append((rel_err(out, p_out)[0], row_rel_err(out, p_out)))
        lse_err = (lse - p_lse).abs().max().item()
        if errs[-1][1] > TOL_BF16 or lse_err > TOL_LSE:
            raise AssertionError(f"flash s={s} {cfg}: out row rel {errs[-1][1]:.3g}, lse {lse_err:.3g}")
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True, **heur))
    ms_other = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True, **other))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5):
        lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    else:       # no GQA flag: the yardstick gets k/v expanded beforehand
        ke, ve = (t.repeat_interleave(h // kvh, dim=1) for t in (k, v))
        lib_ms = time_ms(lambda: sdpa(q, ke, ve, is_causal=True))
    pairs = s * (s + 1) // 2                      # causal (q, k) pairs this run computes
    nbytes = (2 * h * s * d + 2 * kvh * s * d) * 2 + h * s * 4
    b_ms, b_by = bound(prof, nbytes, 4.0 * d * pairs * h, prof.peak_flops_bf16)
    row = dict(shape=f"q[1,{h},{s},{d}] kv[1,{kvh},{s},{d}] causal bf16", config=heur, ms=ms,
               other_config=other, other_ms=ms_other, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=b_ms, bound_by=b_by, max_abs_err=max(e[0] for e in errs),
               max_rel_err=max(e[1] for e in errs))
    rows.append(row)
    log(f"[kernels] flash_attention {row['shape']}: {ms:.4f} ms {heur} ({ms_other:.4f} ms "
        f"{other}); plain {plain_ms:.4f}, SDPA {lib_ms:.4f}, bound {b_ms:.4f} ({b_by}); "
        f"err {row['max_abs_err']:.3g} (row rel {row['max_rel_err']:.2e} <= {TOL_BF16})")


def phase_kernels(prof, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, ff, kvd, vocab = 896, 4864, 128, 151936
    results = {"matmul": [], "rmsnorm": [], "flash_attention": []}
    # Decode (m = 8 slots), the largest prefill bucket (m = 2048) and the
    # prefill unembed of the last position (m = 1).
    for m in (8, 2048):
        for k, n in ((d, d), (d, kvd), (d, ff), (ff, d), (d, vocab)):
            if m == 2048 and n == vocab:
                continue
            _matmul_case(prof, results["matmul"], m, k, n, gen)
    _matmul_case(prof, results["matmul"], 1, d, vocab, gen)
    for rows in (8, 2048):
        _rmsnorm_case(prof, results["rmsnorm"], rows, d, gen)
    for s in (16, 256, 2048):
        _flash_case(prof, results["flash_attention"], s, gen)
    return results


def profile(label: str, step, steps: int) -> None:
    """Where a step's time goes: torch.profiler (device activity only) over
    a steady window gives the device time by kernel; the device's idle share
    is taken against the host-clock step timed without the profiler, whose
    own host cost would otherwise count as idle time."""
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
    by_name = {}
    for ev in prof.key_averages():          # device-side events: kernels, copies
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        by_name[ev.key] = by_name.get(ev.key, 0.0) + dev_us / 1e3 / steps
    if not by_name:
        raise AssertionError(f"torch.profiler saw no device time in the {label} window")
    busy = sum(by_name.values())
    log(f"[profile] {label}: {wall_ms:.2f} ms host clock ({prof_wall_ms:.2f} ms under the "
        f"profiler), {busy:.2f} ms device busy, device idle {100 * (1 - busy / wall_ms):.1f}% "
        f"(torch.profiler, {steps} steps)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[profile]   {ms:8.3f} ms/step {100 * ms / max(busy, 1e-9):5.1f}%  {name[:90]}")


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
    missing = [k for k in ("matmul", "rmsnorm", "flash_attention") if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    if snap["tiers"].get("reference", 0):
        raise AssertionError(f"{snap['tiers']['reference']} dispatches fell to the reference tier")
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
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
    phase_build()
    results = phase_kernels(prof, args.seed)
    launches = phase_serve(args.seed)

    # The representative shape of each kernel: where the serving path spends
    # most of that kernel's time (decode unembed, the largest prefill bucket).
    pick = {"matmul": "[8,896]@[896,151936] bf16", "rmsnorm": "[2048,896] bf16",
            "flash_attention": "q[1,14,2048,64] kv[1,2,2048,64] causal bf16"}
    entries = []
    for name, rows in results.items():
        top = next(r for r in rows if r["shape"] == pick[name])
        src, replaces = KERNEL_SOURCES[name]
        entries.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches.get(name, 0), "shape": top["shape"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "shapes": rows,
        })
    log(f"[summary] {time.perf_counter() - t0:.1f} s after the device check")
    log(smi)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

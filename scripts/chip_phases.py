"""Run a few of ``chip_smoke.py``'s phases on the card, for a quick reading
of one path without the whole call: the device check and the build, then
the named phases in order, each timed and followed by the health check;
the gates record their failures as in the whole script, and the run exits
1 when one failed.

``serve`` must come before ``dp`` (the ``dp`` phase's tensor-parallel part
reads the serve phase's greedy tokens and prefill logits); ``tp-kernels``
runs the kernels phase's rows at a tensor-parallel rank's shapes only.

    python3 scripts/chip_phases.py serve dp
    python3 scripts/chip_phases.py tp-kernels
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402

PHASES = ("tp-kernels", "serve", "faults", "train", "resilience", "dp")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="+", choices=PHASES)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    c.phase_device()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.platform import detect_platform

    prof = detect_platform("cuda")
    t0 = time.perf_counter()

    def timed(name, fn, *fargs):
        t = time.perf_counter()
        out = fn(*fargs)
        torch.cuda.empty_cache()
        c.log(f"[time] phase {name}: {time.perf_counter() - t:.1f} s")
        c.health_check(name)
        return out

    timed("build", c.phase_build)
    for name in args.phases:
        if name == "tp-kernels":
            rows = {k: [] for k in ("matmul", "rmsnorm_matmul", "softmax_xent",
                                    "softmax_xent_bwd", "flash_attention",
                                    "flash_attention_bwd", "matmul_bias_act")}
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            timed(name, c.tp_kernel_rows, prof, rows, gen)
        elif name == "train":
            timed(name, c.phase_train, args.seed)
        else:
            timed(name, getattr(c, f"phase_{name}"), args.seed)
    c.log(f"[summary] {time.perf_counter() - t0:.1f} s after the device check")
    for msg in c.GATE_FAILURES:
        c.log(f"[FAILED] {msg}")
    return 1 if c.GATE_FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())

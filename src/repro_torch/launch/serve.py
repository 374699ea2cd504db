"""Serving launcher: the continuous-batching engine on one card.

Takes every registered arch but the two with a frontend (``musicgen_large``,
``paligemma_3b``), which the engine refuses, as the JAX package's does.

The engine gets its own scoped dispatch runtime: pass a tuning database
with ``--db`` and every kernel the model calls resolves against it;
``--warmup`` resolves every slot-pool bucket before the first request, and
``--platform`` keys the lookups under another platform's namespace. The run
ends with the runtime's telemetry report (which tier served each kernel x
bucket) and each kernel's launch count.

    # full width on the card, random weights from --seed (Gemma3-27B, all
    # 62 layers, is the largest arch that fits one card whole):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_27b --max-seq 4096
    # reduced config on the CPU (the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b --smoke --device cpu
    # a campaign's database, every bucket resolved up front:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b --db h100.db.json --warmup
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from .. import kernels
from ..configs.base import get_config
from ..core.database import TuningDatabase
from ..core.platform import resolve_device
from ..core.runtime import runtime
from ..models import lm
from ..models.transformer import RunConfig
from ..serving.engine import EngineConfig, Request, ServingEngine


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="serve the reduced config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--db", default=None, help="tuning database for this platform")
    ap.add_argument("--mode", default="kernel", choices=("kernel", "reference"))
    ap.add_argument("--warmup", action="store_true",
                    help="resolve every slot-pool bucket before serving")
    ap.add_argument("--platform", default=None,
                    help="database namespace (default: the device's platform key)")
    args = ap.parse_args(argv)
    if args.db and not os.path.exists(args.db):
        # a typo'd path would open as an empty database and every bucket
        # would silently resolve at the heuristic tier
        ap.error(f"--db {args.db}: no such file")
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if cfg.frontend is not None:
        ap.error(f"--arch {args.arch} takes {cfg.frontend} through a frontend, and the engine "
                 f"serves token-in/token-out archs only: train it with repro_torch.launch.train")
    if args.smoke:
        cfg = cfg.reduced()
    params = lm.init_params(cfg, seed=args.seed, device=device)
    rt = runtime(db=TuningDatabase(args.db) if args.db else None, mode=args.mode,
                 platform=args.platform, name="serve")
    engine = ServingEngine(cfg, RunConfig(), params,
                           EngineConfig(max_batch=8, max_seq=args.max_seq), runtime=rt)
    if args.warmup:
        resolved = engine.warmup()
        print(f"warmup resolved {len(resolved)} bucket keys")
    rs = np.random.RandomState(args.seed)
    for i in range(args.requests):
        engine.submit(Request(
            prompt=rs.randint(0, cfg.vocab_size, 16).astype(np.int32),
            max_new_tokens=args.new_tokens,
            temperature=0.7 if i % 2 else 0.0,
            seed=i,
            arrival_time=float(i),      # staggered: exercises in-flight admission
        ))
    kernels.reset_launch_counts()
    done = engine.serve()
    st = engine.stats
    print(f"served {len(done)} requests / {st['tokens_out']} tokens on {device}; "
          f"{st['decode_steps']} pool decode steps, {st['prefill_calls']} prefills")
    for r in done:
        print(f"  request {r._order}: {r.output.tolist()}")
    print(rt.telemetry.report())
    print("kernel launches:", kernels.launch_counts())


if __name__ == "__main__":
    main()

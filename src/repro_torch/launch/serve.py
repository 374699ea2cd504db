"""Serving launcher: the continuous-batching engine on one card.

Takes every registered arch but the two with a frontend (``musicgen_large``,
``paligemma_3b``), which the engine refuses, as the JAX package's does.

The engine gets its own scoped dispatch runtime: pass a tuning database
with ``--db`` and every kernel the model calls resolves against it;
``--warmup`` resolves every slot-pool bucket before the first request, and
``--platform`` keys the lookups under another platform's namespace. The run
ends with the runtime's telemetry report (which tier served each kernel x
bucket) and each kernel's launch count. ``--metrics-out`` collects the obs
plane's metrics (request latency percentiles, ``dispatch.calls``, the
spans) into a snapshot and prints the latency percentiles. Buckets the
dispatch guard quarantined are printed; an engine that degraded to the
plain path prints so and the launcher exits 1.

    # full width on the card, random weights from --seed (Gemma3-27B, all
    # 62 layers, is the largest arch that fits one card whole):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_27b --max-seq 4096
    # reduced config on the CPU (the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b --smoke --device cpu
    # a campaign's database, every bucket resolved up front:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_0_5b --db h100.db.json --warmup
    # tensor parallel, one card a rank (rank, world size and local rank from
    # torchrun's environment; --device cuda puts a rank on cuda:LOCAL_RANK):
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m repro_torch.launch.serve --arch qwen2_0_5b --mesh 1x2 --backend nccl
    # two ranks sharing one card (NCCL refuses two ranks on one device):
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m repro_torch.launch.serve --arch qwen2_0_5b --mesh 1x2 --backend gloo --device cuda:0

``--mesh 1xT`` makes each of T ranks one rank of the tensor axis
(``ServingEngine(mesh=...)``); a mesh with a data axis of more than one
rank is refused. A rank prints its lines after ``[rank N]``; every rank
emits the same tokens (rank 0 decides them).
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
from typing import Optional, Sequence

import numpy as np

from .. import kernels
from .. import obs
from ..configs.base import get_config
from ..core.database import TuningDatabase
from ..core.platform import resolve_device
from ..core.runtime import runtime
from ..models import lm
from ..models.transformer import RunConfig
from ..obs.metrics import percentile_row
from ..serving.engine import EngineConfig, Request, ServingEngine
from . import defaults
from .mesh import init_ranks, make_host_mesh, make_mesh_from_spec, parse_mesh_spec, rank_env


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
    ap.add_argument("--metrics-out", default=None,
                    help="collect obs metrics for the run and write the snapshot JSON here "
                         "(render with `python -m repro_torch.obs report --metrics <file>`)")
    ap.add_argument("--metrics-sample", type=float, default=1.0,
                    help="obs sample rate of the high-frequency sites (1.0 = all)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL mesh of the torchrun ranks (1xT: tensor parallel)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="process group backend of a --mesh run (gloo for ranks that "
                         "share a card)")
    args = ap.parse_args(argv)
    if args.db and not os.path.exists(args.db):
        # a typo'd path would open as an empty database and every bucket
        # would silently resolve at the heuristic tier
        ap.error(f"--db {args.db}: no such file")
    env = rank_env()
    if env.world_size > 1 and not args.mesh:
        ap.error(f"{env.world_size} ranks need a --mesh")
    mesh, device = None, args.device
    if args.mesh:
        shape, _ = parse_mesh_spec(args.mesh)
        if math.prod(shape[:-1]) > 1:
            ap.error(f"--mesh {args.mesh}: serving with a data axis of more than one rank is "
                     "not ported; use 1xT")
        if math.prod(shape) > 1:
            init_ranks(args.backend, env=env)
            mesh = make_mesh_from_spec(args.mesh)
        else:
            mesh = make_host_mesh()
        if device == "cuda":
            device = f"cuda:{env.local_rank}"
    tag = f"[rank {env.rank}] " if env.world_size > 1 else ""
    if env.world_size > 1:
        sys.stdout.reconfigure(line_buffering=True)
    device = resolve_device(device)

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
                           EngineConfig(max_batch=8, max_seq=args.max_seq), runtime=rt,
                           mesh=mesh, layout=defaults.default_layout(cfg) if mesh else None)
    # without --metrics-out the ambient collector is the disabled default
    col = (obs.collect(name="serve", sample_rate=args.metrics_sample)
           if args.metrics_out else None)
    with col if col is not None else contextlib.nullcontext():
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
    print(f"{tag}served {len(done)} requests / {st['tokens_out']} tokens on {device}; "
          f"{st['decode_steps']} pool decode steps, {st['prefill_calls']} prefills"
          + (f", mesh {args.mesh}" if mesh is not None else ""))
    for r in done:
        print(f"{tag}  request {r._order}: {r.output.tolist()}")
    if col is not None:
        snap = col.snapshot()
        for name, label in (("serve.admission_s", "admission"),
                            ("serve.per_token_s", "per-token"),
                            ("serve.latency_s", "request latency")):
            row = percentile_row(snap, name)
            if row:
                print(f"{label}: p50 {row['p50'] * 1e3:.2f}ms  p95 {row['p95'] * 1e3:.2f}ms  "
                      f"p99 {row['p99'] * 1e3:.2f}ms (n={row['count']})")
        col.write(args.metrics_out)
        print(f"wrote metrics -> {args.metrics_out}")
    print(rt.telemetry.report())
    print(f"{tag}kernel launches:", kernels.launch_counts())
    if len(rt.health):
        print(f"quarantined buckets: {rt.health.snapshot()}")
    if engine.degraded:
        print(f"DEGRADED: {st['degraded_calls']} prefills and decode steps ran on the plain "
              "path after a fault (see the serve.degraded warning)", file=sys.stderr)
        raise SystemExit(1)
    if env.world_size > 1:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""Training launcher: the one-device trainer under a pinned dispatch runtime.

``--db`` points every kernel the step runs, forward and backward, at a
tuning database for this platform (``--platform`` keys the lookups under
another platform's namespace); ``--mode`` picks the kernel path or the
reference path, and ``--bwd-dispatch off`` differentiates every kernel
through its reference instead of its dispatched backward plan. The run ends with the runtime's telemetry report (which
tier served each kernel x bucket, split into the fwd / bwd / opt phases)
and each kernel's launch count. ``--metrics-out`` collects the obs plane's
metrics (``train.step_s``, ``dispatch.calls``, the spans) into a snapshot.
``--ckpt-dir`` (default ``checkpoints``, made at the first save) takes a
checkpoint every ``--ckpt-every`` steps; a run that finds a committed
checkpoint there resumes from it, and a failed step restores the last one
and replays.

    # full width on the card, random weights from --seed, batch 4 x 2048:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b --steps 6
    # PaliGemma-3B (256 patch embeddings before the tokens, the loss masked
    # off them) at full width, batch 2 x 2048:
    PYTHONPATH=src python -m repro_torch.launch.train --arch paligemma_3b --steps 4 --batch 2
    # xLSTM-1.3B whole (2.93 B) at batch 4 x 512, the sLSTM loop's 512 steps
    # a layer (batch 4 x 2048 would not fit beside its AdamW state):
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm_1_3b --steps 4 --seq 512
    # reduced config on the CPU (the kernels' plain versions):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b --smoke \\
        --steps 2 --device cpu
    # from a campaign's database:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b --steps 6 \\
        --db h100.db.json --mode kernel
    # checkpoints every 2 steps; run again with more --steps to resume:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b --smoke \\
        --steps 4 --device cpu --ckpt-dir ckpt --ckpt-every 2
    # data parallel, one card a rank (rank, world size and local rank from
    # torchrun's environment; --device cuda puts a rank on cuda:LOCAL_RANK):
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 8 \\
        -m repro_torch.launch.train --arch qwen2_0_5b --mesh 8x1 --backend nccl --batch 32
    # two ranks sharing one card (NCCL refuses two ranks on one device):
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m repro_torch.launch.train --arch qwen2_0_5b --mesh 2x1 --backend gloo \\
        --device cuda:0 --compression int8_ef --batch 2 --seq 512 --steps 2
    # tensor parallel (--mesh 1xT; 2x2 adds a data axis), two ranks sharing one card:
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m repro_torch.launch.train --arch qwen2_0_5b --mesh 1x2 --backend gloo \\
        --device cuda:0 --batch 2 --seq 512 --steps 2

Without ``--smoke`` the run config and layout are ``launch.defaults``'s
(``default_run``: ``remat="dots"`` and 4 microbatches for an arch under
20 B parameters, as JAX's launcher trains), the microbatch count cut to
the largest divisor of it that leaves every data-parallel rank a row of
each microbatch. With ``--mesh`` every rank joins the process group on the
``--backend`` it names; a rank prints its lines after ``[rank N]``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import sys
from typing import Optional, Sequence

from .. import kernels
from .. import obs
from ..configs.base import ShapeSpec, get_config
from ..core.database import TuningDatabase
from ..core.runtime import runtime
from ..data.pipeline import DataConfig
from ..distributed.collectives import MODES
from ..distributed.sharding import data_parallel_degree, mesh_axis_sizes
from ..models.transformer import RunConfig
from ..optim.adamw import AdamWConfig
from ..train.trainer import Trainer, TrainerConfig
from . import defaults
from .mesh import init_ranks, make_host_mesh, make_mesh_from_spec, parse_mesh_spec, rank_env


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, batch 8 x 64 (the JAX package's train_smoke)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="checkpoints",
                    help="checkpoint directory (made at the first save); resumes from it")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--db", default=None, help="tuning database for this platform")
    ap.add_argument("--mode", default="kernel", choices=("kernel", "reference"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=None, help="global batch (default 8 smoke, 4)")
    ap.add_argument("--seq", type=int, default=None, help="sequence length (default 64 smoke, 2048)")
    ap.add_argument("--platform", default=None,
                    help="database namespace (default: the device's platform key)")
    ap.add_argument("--bwd-dispatch", default="on", choices=("on", "off"),
                    help="off: differentiate every kernel through its reference, not its "
                         "dispatched backward plan")
    ap.add_argument("--metrics-out", default=None,
                    help="collect obs metrics for the run and write the snapshot JSON here "
                         "(render with `python -m repro_torch.obs report --metrics <file>`)")
    ap.add_argument("--metrics-sample", type=float, default=1.0,
                    help="obs sample rate of the high-frequency sites (1.0 = all)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL mesh of the torchrun ranks (e.g. 2x1: data parallel, "
                         "1x2: tensor parallel)")
    ap.add_argument("--compression", default="none", choices=MODES,
                    help="gradient compression, applied to the reduced gradient")
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
        if math.prod(shape) > 1:
            init_ranks(args.backend, env=env)
            mesh = make_mesh_from_spec(args.mesh)
        else:
            mesh = make_host_mesh()
        if device == "cuda":
            device = f"cuda:{env.local_rank}"
    tag = f"[rank {env.rank}] " if env.world_size > 1 else ""
    if env.world_size > 1:
        # the ranks share one output: a line a write, so lines do not interleave
        sys.stdout.reconfigure(line_buffering=True)

    cfg = get_config(args.arch).reduced() if args.smoke else get_config(args.arch)
    layout = defaults.default_layout(cfg) if mesh is not None else None
    if args.smoke:
        batch, seq = args.batch or 8, args.seq or 64
        run = defaults.default_run(cfg, ShapeSpec("train_smoke", seq, batch, "train"))
    else:
        batch, seq = args.batch or 4, args.seq or 2048
        run = defaults.default_run(cfg, ShapeSpec("train", seq, batch, "train"))
        # the largest divisor of the default count that leaves every
        # data-parallel rank a row of each microbatch
        ways = (data_parallel_degree(mesh_axis_sizes(mesh), layout, batch)
                if mesh is not None else 1)
        k = max(d for d in range(1, run.microbatches + 1)
                if run.microbatches % d == 0 and batch % (d * ways) == 0)
        run = dataclasses.replace(run, microbatches=k)
    rt = runtime(db=TuningDatabase(args.db) if args.db else None, mode=args.mode,
                 platform=args.platform, bwd_dispatch=args.bwd_dispatch == "on",
                 name="train")
    trainer = Trainer(cfg, run, DataConfig(seed=args.seed, batch_size=batch, seq_len=seq),
                      AdamWConfig(total_steps=args.steps),
                      TrainerConfig(total_steps=args.steps, seed=args.seed,
                                    checkpoint_every=args.ckpt_every,
                                    checkpoint_dir=args.ckpt_dir,
                                    grad_compression=args.compression),
                      runtime=rt, device=device, mesh=mesh, layout=layout)
    if trainer.ckpt.latest_step() is not None:
        print(f"{tag}resumed from the checkpoint at step {trainer.restore_checkpoint()} "
              f"in {args.ckpt_dir}")
    start = trainer.step
    kernels.reset_launch_counts()
    # without --metrics-out the ambient collector is the disabled default
    col = (obs.collect(name="train", sample_rate=args.metrics_sample)
           if args.metrics_out else None)
    with col if col is not None else contextlib.nullcontext():
        steps = trainer.train()
    for i, m in enumerate(steps, start + 1):
        reduce = (f"; all-reduce {m['allreduce_bytes']} B in {m['allreduce_s']:.3f} s"
                  if "allreduce_s" in m else "")
        if "model_s" in m:
            reduce += f"; tensor axis {m['model_bytes']} B in {m['model_s']:.3f} s"
        print(f"{tag}step {i}: loss {m['loss']:.4f} grad_norm {m['grad_norm']:.4f} "
              f"lr {m['lr']:.3g} ({m['step_time_s']:.3f} s{reduce})")
    print(f"{tag}trained {cfg.name} on {trainer.device}: {trainer.step} steps of {batch} x "
          f"{seq} tokens (remat {run.remat}, {run.microbatches} microbatches"
          + (f", mesh {args.mesh}, compression {args.compression})" if mesh is not None
             else ")"))
    print(rt.telemetry.report())
    print(f"{tag}kernel launches:", kernels.launch_counts())
    if len(rt.health):
        print(f"{tag}quarantined buckets: {rt.health.snapshot()}")
    if col is not None:
        col.write(args.metrics_out)
        print(f"{tag}wrote metrics -> {args.metrics_out}")
    if trainer.distributed:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()

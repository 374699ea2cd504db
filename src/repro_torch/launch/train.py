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
"""
from __future__ import annotations

import argparse
import contextlib
import os
from typing import Optional, Sequence

from .. import kernels
from .. import obs
from ..configs.base import get_config
from ..core.database import TuningDatabase
from ..core.runtime import runtime
from ..data.pipeline import DataConfig
from ..models.transformer import RunConfig
from ..optim.adamw import AdamWConfig
from ..train.trainer import Trainer, TrainerConfig


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
    args = ap.parse_args(argv)
    if args.db and not os.path.exists(args.db):
        # a typo'd path would open as an empty database and every bucket
        # would silently resolve at the heuristic tier
        ap.error(f"--db {args.db}: no such file")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
        batch, seq = args.batch or 8, args.seq or 64
        run = RunConfig(remat="none", loss_chunk=32, q_chunk=32, k_chunk=32)
    else:
        batch, seq = args.batch or 4, args.seq or 2048
        run = RunConfig(remat="none", loss_chunk=512)
    rt = runtime(db=TuningDatabase(args.db) if args.db else None, mode=args.mode,
                 platform=args.platform, bwd_dispatch=args.bwd_dispatch == "on",
                 name="train")
    trainer = Trainer(cfg, run, DataConfig(seed=args.seed, batch_size=batch, seq_len=seq),
                      AdamWConfig(total_steps=args.steps),
                      TrainerConfig(total_steps=args.steps, seed=args.seed,
                                    checkpoint_every=args.ckpt_every,
                                    checkpoint_dir=args.ckpt_dir),
                      runtime=rt, device=args.device)
    if trainer.ckpt.latest_step() is not None:
        print(f"resumed from the checkpoint at step {trainer.restore_checkpoint()} "
              f"in {args.ckpt_dir}")
    start = trainer.step
    kernels.reset_launch_counts()
    # without --metrics-out the ambient collector is the disabled default
    col = (obs.collect(name="train", sample_rate=args.metrics_sample)
           if args.metrics_out else None)
    with col if col is not None else contextlib.nullcontext():
        steps = trainer.train()
    for i, m in enumerate(steps, start + 1):
        print(f"step {i}: loss {m['loss']:.4f} grad_norm {m['grad_norm']:.4f} "
              f"lr {m['lr']:.3g} ({m['step_time_s']:.3f} s)")
    print(f"trained {cfg.name} on {trainer.device}: {trainer.step} steps of {batch} x {seq} "
          f"tokens")
    print(rt.telemetry.report())
    print("kernel launches:", kernels.launch_counts())
    if len(rt.health):
        print(f"quarantined buckets: {rt.health.snapshot()}")
    if col is not None:
        col.write(args.metrics_out)
        print(f"wrote metrics -> {args.metrics_out}")


if __name__ == "__main__":
    main()

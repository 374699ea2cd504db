"""The training loop on one device: forward, the chunked loss, backward
through the dispatched kernels, and AdamW.

Counterpart of ``repro.train.trainer.Trainer`` without a mesh (that is the
distributed slice), checkpoints, recovery or gradient compression, which
are not ported yet. Every kernel the step runs, forward and backward,
resolves through the dispatch runtime: pass ``runtime=repro_torch.runtime(
db=..., mode=...)`` to pin a tuning database and a mode for the whole run;
``runtime.telemetry`` then reports which tier served each kernel x bucket,
split into the ``fwd``, ``bwd`` and ``opt`` phases.

``RunConfig.microbatches = k`` splits each batch into k along the batch
dim, accumulates fp32 gradients over them and averages, as the JAX
trainer's scan does.

Under an enabled :mod:`repro_torch.obs` collector each step records the
``train.data`` and ``train.step`` spans, ``train.step_s``,
``train.tokens`` and ``train.tokens_per_s``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..convert import batch_to_tensors
from ..core.platform import resolve_device
from ..core.runtime import TunedRuntime, dispatch_phase
from ..data.pipeline import DataConfig, SyntheticPipeline
from ..models import lm
from ..models.transformer import RunConfig
from ..obs.collect import current_collector as _obs_collector
from ..obs.trace import span as _obs_span
from ..optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 100
    seed: int = 0


class Trainer:
    """One-device trainer. ``params`` (for instance carried across from the
    JAX package with ``convert.from_jax_params``) defaults to
    ``lm.init_params(cfg, tcfg.seed, device)``."""

    def __init__(self, cfg: ArchConfig, run: RunConfig, data_cfg: DataConfig,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 tcfg: Optional[TrainerConfig] = None,
                 runtime: Optional[TunedRuntime] = None,
                 device=None, params=None):
        self.cfg = cfg
        self.run = run
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.tcfg = tcfg or TrainerConfig()
        self.runtime = runtime
        self.device = resolve_device(device)
        if data_cfg.batch_size % run.microbatches:
            raise ValueError(f"batch {data_cfg.batch_size} not divisible by "
                             f"{run.microbatches} microbatches")
        self.data = SyntheticPipeline(cfg, data_cfg)
        self.params = (params if params is not None
                       else lm.init_params(cfg, self.tcfg.seed, self.device))
        self._leaves = adamw.leaves(self.params)
        for p in self._leaves:
            p.requires_grad_(True)
        self.opt_state = adamw.init(self.opt_cfg, self.params)
        self.step = 0

    def _scope(self):
        return self.runtime if self.runtime is not None else contextlib.nullcontext()

    def _grads(self, loss) -> List[torch.Tensor]:
        """d loss / d leaves; zeros for a leaf the loss does not read (the
        token embedding of an arch whose frontend feeds embeddings), as
        ``jax.grad`` gives."""
        grads = torch.autograd.grad(loss, self._leaves, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(self._leaves, grads)]

    def loss_and_grads(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, List]:
        """The loss of one batch and its gradients in :func:`adamw.leaves`
        order: ``jax.value_and_grad(lm.loss_fn)`` over the microbatches."""
        k = self.run.microbatches
        with self._scope():
            if k == 1:
                loss, _ = lm.loss_fn(self.params, batch, self.cfg, self.run)
                return loss.detach(), self._grads(loss)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in self._leaves]
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            for mb in range(k):
                part = {n: t.chunk(k, dim=0)[mb] for n, t in batch.items()}
                loss, _ = lm.loss_fn(self.params, part, self.cfg, self.run)
                for a, g in zip(acc, self._grads(loss)):
                    a.add_(g.float())
                total = total + loss.detach()
            return total / k, [a / k for a in acc]

    def run_one_step(self) -> Dict[str, float]:
        """One optimizer step on the next batch: ``loss``, ``grad_norm``,
        ``lr`` and ``step_time_s`` (host clock from the batch on the device
        to the updated parameters, synchronised)."""
        with _obs_span("train.data"):
            batch_np = self.data.next_batch()
            batch = batch_to_tensors(batch_np, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with _obs_span("train.step", step=self.step):
            loss, grads = self.loss_and_grads(batch)
            with self._scope(), dispatch_phase("opt"):
                _, _, om = adamw.update(self.opt_cfg, grads, self.opt_state, self.params)
            metrics = {"loss": float(loss), "grad_norm": float(om["grad_norm"]),
                       "lr": om["lr"]}
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        metrics["step_time_s"] = dt
        self.step += 1
        col = _obs_collector()
        if col.enabled:
            # the JAX trainer's count: the first leaf (in key order)'s two lead dims
            first = batch_np[min(batch_np)] if batch_np else None
            tokens = (int(first.shape[0] * first.shape[1])
                      if first is not None and first.ndim >= 2 else 0)
            col.observe("train.step_s", dt)
            if tokens and dt > 0:
                col.counter("train.tokens", tokens)
                col.gauge("train.tokens_per_s", tokens / dt)
        return metrics

    def train(self) -> List[Dict[str, float]]:
        """Run to ``tcfg.total_steps``; the metrics of every step."""
        out = []
        while self.step < self.tcfg.total_steps:
            out.append(self.run_one_step())
        return out

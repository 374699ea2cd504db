"""The training loop on one device: forward, the chunked loss, backward
through the dispatched kernels, AdamW, checkpoints and restart.

Counterpart of ``repro.train.trainer.Trainer`` without a mesh (that is the
distributed slice) or gradient compression, which are not ported yet. Every
kernel the step runs, forward and backward, resolves through the dispatch
runtime: pass ``runtime=repro_torch.runtime(db=..., mode=...)`` to pin a
tuning database and a mode for the whole run;
``runtime.telemetry`` then reports which tier served each kernel x bucket,
split into the ``fwd``, ``bwd`` and ``opt`` phases.

``RunConfig.microbatches = k`` splits each batch into k along the batch
dim, accumulates fp32 gradients over them and averages, as the JAX
trainer's scan does.

Under an enabled :mod:`repro_torch.obs` collector each step records the
``train.data`` and ``train.step`` spans, ``train.step_s``,
``train.tokens`` and ``train.tokens_per_s``.

Checkpoints and recovery follow the JAX trainer: every
``checkpoint_every`` steps the state (the parameters, AdamW's ``m``, ``v``,
``master`` and ``step``, the data pipeline's step and the trainer's) goes
to :class:`~repro_torch.train.checkpoint.Checkpointer` (async by default:
the host copy is taken before the next step starts), each step time to a
:class:`~repro_torch.train.resilience.StragglerMonitor`, and
:meth:`Trainer.train` runs the steps under
:func:`~repro_torch.train.resilience.run_with_recovery`: a step that
raises (the fault site ``train.step:<step>``, or ``fail_hook``) restores
the last committed checkpoint and replays from it, and leaves a
``train.recovered`` warning on the obs collector and one more in
``Trainer.recoveries``. An error that no guard may absorb
(``runtime.raises_through``: a kernel missing on this host, a launch the
card refused) raises out of :meth:`Trainer.train` with no recovery. A
restore copies into the tensors the trainer and its optimizer state hold,
in place. With no checkpoint to restore, a trainer that initialised its
own parameters re-initialises them from ``tcfg.seed``, in place
(:func:`lm.reinit_params_`); one that was handed ``params=`` has nothing
to restart from and raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..convert import batch_to_tensors
from ..core.platform import resolve_device
from ..core.runtime import TunedRuntime, dispatch_phase, raises_through
from ..data.pipeline import DataConfig, SyntheticPipeline
from ..models import lm
from ..models.transformer import RunConfig
from ..obs.collect import current_collector as _obs_collector
from ..obs.trace import span as _obs_span
from ..optim import adamw
from ..testing.faults import fault_point as _fault_point
from . import checkpoint as ckpt_mod
from .resilience import RestartPolicy, StragglerMonitor, run_with_recovery

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The JAX trainer's fields and defaults, less ``grad_compression``
    (the distributed slice). ``checkpoint_dir`` is created at the first
    save only."""

    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "checkpoints"
    checkpoint_keep: int = 3
    async_checkpoint: bool = True
    log_every: int = 10
    seed: int = 0
    max_failures: int = 10


class Trainer:
    """One-device trainer. ``params`` (for instance carried across from the
    JAX package with ``convert.from_jax_params``) defaults to
    ``lm.init_params(cfg, tcfg.seed, device)``; only then can the trainer
    restart from scratch (:meth:`restore_checkpoint`)."""

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
        self._own_init = params is None
        self.params = (params if params is not None
                       else lm.init_params(cfg, self.tcfg.seed, self.device))
        self._leaves = adamw.leaves(self.params)
        for p in self._leaves:
            p.requires_grad_(True)
        self.opt_state = adamw.init(self.opt_cfg, self.params)
        self.ckpt = ckpt_mod.Checkpointer(self.tcfg.checkpoint_dir,
                                          keep=self.tcfg.checkpoint_keep)
        self.monitor = StragglerMonitor()
        self.step = 0
        self.recoveries = 0     # restores after a failed step, over every train() call

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
        self.monitor.record(self.step, dt)
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
        if self.step % self.tcfg.checkpoint_every == 0:
            self.save_checkpoint()
        if self.step % self.tcfg.log_every == 0:
            log.info("step %d loss %.4f (%.2fs)", self.step, metrics["loss"], dt)
        return metrics

    # -- checkpoint and restart ---------------------------------------------
    def _state_tree(self) -> Dict:
        return {"params": self.params, "opt": self.opt_state,
                "data": {"step": self.data.step}, "trainer_step": self.step}

    def save_checkpoint(self) -> None:
        """Checkpoint the state at ``self.step`` (async unless
        ``tcfg.async_checkpoint`` is off)."""
        tree = self._state_tree()
        if self.tcfg.async_checkpoint:
            self.ckpt.save_async(self.step, tree)
        else:
            self.ckpt.save(self.step, tree)

    @torch.no_grad()
    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Roll the state back to checkpoint ``step`` (the latest committed
        one by default), copying into the tensors the trainer holds; returns
        the step to resume from. With no checkpoint: restart from scratch,
        re-initialised from ``tcfg.seed``, or raise when the trainer was
        handed its parameters."""
        self.ckpt.wait()
        step = step if step is not None else self.ckpt.latest_step()
        if step is None:
            if not self._own_init:
                raise RuntimeError("no checkpoint to restore, and this trainer was given "
                                   "params=: it cannot restart from scratch")
            log.warning("no checkpoint to restore; restarting from scratch")
            lm.reinit_params_(self.params, self.cfg, self.tcfg.seed)
            # adamw.init's state, in place
            for t in self.opt_state["m"] + self.opt_state["v"]:
                t.zero_()
            for m, p in zip(self.opt_state.get("master", ()), self._leaves):
                m.copy_(p)
            self.opt_state["step"] = 0
            self.step = self.data.step = 0
            return 0
        live = self._state_tree()
        tree = self.ckpt.restore(step, live, device="cpu")
        self._copy_into(live, tree)
        self.opt_state["step"] = tree["opt"]["step"]
        self.data.step = tree["data"]["step"]
        self.step = tree["trainer_step"]
        log.info("restored checkpoint at step %d", self.step)
        return self.step

    @staticmethod
    def _copy_into(live, tree) -> None:
        for (_, dst), (_, src) in zip(ckpt_mod.flatten_with_paths(live),
                                      ckpt_mod.flatten_with_paths(tree)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)

    def train(self, fail_hook: Optional[Callable[[int], None]] = None
              ) -> List[Dict[str, float]]:
        """Run to ``tcfg.total_steps`` with recovery; the metrics of every
        step index this call ran, in order. A step replayed after a restore
        appears once, from its last run. ``fail_hook(step)`` (tests) may
        raise to fail a step, as the ``train.step:<step>`` fault site does."""
        ran: Dict[int, Dict[str, float]] = {}
        failed: List[Tuple[int, Exception]] = []

        def step_fn(step: int) -> Dict[str, float]:
            try:
                if fail_hook is not None:
                    fail_hook(step)
                _fault_point(f"train.step:{step}", step=step)
                ran[step] = self.run_one_step()
            except Exception as e:
                failed.append((step, e))
                raise
            return ran[step]

        def restore_fn() -> int:
            step, e = failed[-1]
            self.recoveries += 1
            _obs_collector().warn_once("train.recovered", key=f"{id(self)}:{self.recoveries}",
                                       step=step, error=f"{type(e).__name__}: {e}")
            return self.restore_checkpoint()

        run_with_recovery(step_fn, restore_fn, total_steps=self.tcfg.total_steps,
                          start_step=self.step,
                          policy=RestartPolicy(max_failures=self.tcfg.max_failures),
                          sleep=lambda s: None, fatal=raises_through)
        self.ckpt.wait()
        return [ran[i] for i in sorted(ran)]

"""The training loop: forward, the chunked loss, backward through the
dispatched kernels, the data-parallel gradient all-reduce, gradient
compression, AdamW, checkpoints and restart.

Counterpart of ``repro.train.trainer.Trainer``. With no ``mesh`` it trains
on one device. Every
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

**Data and tensor parallelism** (``mesh=``, a ``DeviceMesh`` of
:func:`repro_torch.launch.mesh.make_mesh_from_spec` over an initialised
process group; ``layout=`` defaults to ``launch.defaults.default_layout``):
one process a rank. The parameter specs are solved with
``param_shardings`` as in JAX. A rank holds its piece of every parameter
the specs cut over the tensor axis (``lm.rank_params``; the layers run
column-, row- and vocab-parallel from the cuts, ``distributed.
tensor_parallel``) and a whole copy of the others; ``params=`` may be the
global tree, which the rank cuts, or the rank's pieces already. What still
raises ``NotImplementedError``: FSDP (a cut over a data axis of more than
one rank), an arch with experts on more than one rank (its load-balancing
loss is not additive over ranks), and a recurrent mixer, a frontend or a
pod axis on a tensor axis of more than one rank. Each step:

* every rank draws the *global* batch (the pipeline with ``host_index=0,
  host_count=1``, what JAX's one process feeds) and keeps its rows: of
  microbatch j (``b = B / k`` rows), the rows ``[j b + s b/dp, j b + (s+1)
  b/dp)`` of its data shard ``s``; with one microbatch, ``[s B/dp, (s+1)
  B/dp)``. ``dp`` is computed once, as JAX does, from the microbatch's
  batch (``data_parallel_degree``), so a rank's dispatch keys are its true
  shard; ranks whose coordinates on unused data axes differ replicate, and
  the ranks of one tensor axis take the same rows;
* each microbatch's loss and gradients are weighted by the rank's share of
  that microbatch's loss tokens and accumulated; then the gradients are
  summed over the ranks that hold the same pieces (the data group; a mesh
  with one rank on its data axes has no gradient reduce) in fp32 buckets
  (``collectives.reduce_grads``), once a step, and the loss with them: the
  global mean, equal to JAX's at any world size, masks included;
* ``grad_compression`` applies to the reduced gradient, where JAX applies it
  to its global one (the wire carries fp32), with ``int8_ef``'s scale a
  JAX tensor's (a segment's layers stacked, the pieces of a cut tensor
  together); the clipping norm is the global gradient's
  (``adamw.global_norm``); every rank then runs the same AdamW update, so
  the replicas stay bit-identical (:meth:`Trainer.check_replicas`, also run
  at construction: each piece across the ranks that hold it, each
  replicated leaf across all ranks);
* the reported loss and grad norm are global; ``allreduce_s`` and
  ``allreduce_bytes`` report the step's gradient reduce, ``model_s`` and
  ``model_bytes`` the tensor axis's collectives.

Checkpoints hold the error-feedback state under ``"ef"``, as JAX's do. On
a mesh the pieces are gathered over the tensor axis, rank 0 writes the
global tree (JAX's layout byte for byte), and every rank waits at a
barrier for the commit; every rank restores, cutting its pieces from it.
Recovery is per process: a step that fails on one rank only leaves the
others waiting in a collective until the process group's timeout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..convert import batch_to_tensors
from ..core.platform import resolve_device
from ..core.runtime import TunedRuntime, dispatch_phase, raises_through
from ..data.pipeline import DataConfig, SyntheticPipeline
from ..distributed import collectives
from ..distributed import sharding as shd
from ..distributed import tensor_parallel as tp
from ..launch import steps
from ..models import lm
from ..models.transformer import RunConfig
from ..obs.collect import current_collector as _obs_collector
from ..obs.trace import span as _obs_span
from ..optim import adamw
from ..testing.faults import fault_point as _fault_point
from . import checkpoint as ckpt_mod
from .resilience import RestartPolicy, StragglerMonitor, run_with_recovery

log = logging.getLogger("repro_torch.trainer")


def _tree_map(fn, tree):
    """``fn`` over the leaves of a state tree, its structure kept."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The JAX trainer's fields and defaults. ``checkpoint_dir`` is created
    at the first save only."""

    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = "checkpoints"
    checkpoint_keep: int = 3
    async_checkpoint: bool = True
    log_every: int = 10
    seed: int = 0
    grad_compression: str = "none"      # none | bf16 | int8_ef
    max_failures: int = 10


def _stacked_groups(params) -> List[List[int]]:
    """The leaves (by :func:`adamw.leaves` index) that are one tensor in
    JAX, which stacks a segment's repeats: a layer leaf with its
    counterparts in the segment's other repeats, every other leaf alone."""
    groups: Dict[Tuple, List[int]] = {}
    for i, (name, _) in enumerate(adamw.named_leaves(params)):
        parts = name.split("/")
        key = ("segments", parts[2], *parts[4:]) if parts[1] == "segments" else (name,)
        groups.setdefault(key, []).append(i)
    return list(groups.values())


@dataclasses.dataclass(frozen=True)
class _DataParallel:
    """A rank's place in the step: ``ranks`` processes, ``tensor`` of them on
    its tensor axis, the rest its data group (``data_group``, the ranks
    holding the same pieces: ``data_ranks`` of them, the whole world with a
    tensor axis of one rank); the batch split ``degree`` ways (``approx``:
    JAX's microbatch degree differs from the full batch's), this rank on
    data shard ``shard`` of it, each shard held by ``replicas`` ranks of
    the data group."""

    ranks: int
    degree: int
    approx: bool
    shard: int
    replicas: int
    tensor: int = 1
    data_ranks: int = 1
    data_group: object = None


class Trainer:
    """The trainer. ``params`` (for instance carried across from the JAX
    package with ``convert.from_jax_params``) defaults to
    ``lm.init_params(cfg, tcfg.seed, device)``; only then can the trainer
    restart from scratch (:meth:`restore_checkpoint`). ``mesh`` and
    ``layout`` make it a data-parallel rank (the module docstring)."""

    def __init__(self, cfg: ArchConfig, run: RunConfig, data_cfg: DataConfig,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 tcfg: Optional[TrainerConfig] = None,
                 runtime: Optional[TunedRuntime] = None,
                 device=None, params=None, mesh=None, layout=None):
        self.cfg = cfg
        self.run = run
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.tcfg = tcfg or TrainerConfig()
        if self.tcfg.grad_compression not in collectives.MODES:
            raise ValueError(f"grad_compression {self.tcfg.grad_compression!r} not in "
                             f"{collectives.MODES}")
        self.runtime = runtime
        self.device = resolve_device(device)
        if data_cfg.batch_size % run.microbatches:
            raise ValueError(f"batch {data_cfg.batch_size} not divisible by "
                             f"{run.microbatches} microbatches")
        self.mesh = mesh
        self.layout = layout
        self._dp = None
        if mesh is not None:
            if layout is None:
                from ..launch.defaults import default_layout

                self.layout = default_layout(cfg)
            self._dp = self._data_parallel(cfg, run, data_cfg)
        self.data = SyntheticPipeline(cfg, data_cfg)
        self._loss_and_grads = steps.make_loss_and_grads(cfg, run)
        self._own_init = params is None
        if params is None:
            params = lm.init_params(cfg, self.tcfg.seed, self.device,
                                    mesh=mesh if self._tensor_parallel else None,
                                    layout=self.layout)
        elif self._tensor_parallel:
            params = lm.rank_params(params, cfg, mesh, self.layout)
        self.params = params
        self._leaves = adamw.leaves(self.params)
        for p in self._leaves:
            p.requires_grad_(True)
        self.opt_state = adamw.init(self.opt_cfg, self.params)
        self.ef_state = (collectives.ef_init(self._leaves)
                         if self.tcfg.grad_compression == "int8_ef" else None)
        for i, p in enumerate(self._leaves):
            # a piece's optimizer and error-feedback state are pieces alike
            info = tp.shard_info(p)
            if info is not None:
                for k in ("m", "v", "master"):
                    if k in self.opt_state:
                        tp.mark(self.opt_state[k][i], *info)
                if self.ef_state is not None:
                    tp.mark(self.ef_state[i], *info)
        self._scale_groups = _stacked_groups(self.params)
        self._cut = [tp.shard_info(p) is not None for p in self._leaves]
        self.ckpt = ckpt_mod.Checkpointer(self.tcfg.checkpoint_dir,
                                          keep=self.tcfg.checkpoint_keep)
        self.monitor = StragglerMonitor()
        self.step = 0
        self.recoveries = 0     # restores after a failed step, over every train() call
        if self.distributed:
            self.check_replicas()

    @property
    def distributed(self) -> bool:
        """Whether this trainer is one rank of several."""
        return self._dp is not None and self._dp.ranks > 1

    @property
    def _tensor_parallel(self) -> bool:
        return self._dp is not None and self._dp.tensor > 1

    @property
    def rank(self) -> int:
        import torch.distributed as dist

        return dist.get_rank() if self.distributed else 0

    def _data_parallel(self, cfg: ArchConfig, run: RunConfig, data_cfg: DataConfig
                       ) -> _DataParallel:
        """The rank's place, after refusing what this slice does not run."""
        mesh, layout = self.mesh, self.layout
        sizes = shd.mesh_axis_sizes(mesh)
        tp.check_supported(cfg, sizes, layout)
        ranks = mesh.size()
        if ranks > 1 and cfg.num_experts:
            raise NotImplementedError(f"{cfg.name} has experts: expert parallelism and its "
                                      "load-balancing loss across ranks are a later slice")
        if ranks > 1 and (data_cfg.host_index, data_cfg.host_count) != (0, 1):
            raise ValueError("every rank draws the global batch: host_index=0, host_count=1")
        # the degree, once, from the microbatch's batch dim (JAX's trainer)
        b = max(1, data_cfg.batch_size // max(1, run.microbatches))
        use, degree = shd._divisible_data_axes(sizes, layout, b)
        approx = (run.microbatches > 1
                  and degree != shd.data_parallel_degree(sizes, layout, data_cfg.batch_size))
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        shard = 0
        for a in use:
            shard = shard * sizes[a] + coord[a]
        t = tp.tensor_size(sizes, layout)
        data_ranks = ranks // t
        group = None
        if t > 1 and data_ranks > 1:
            from ..launch.mesh import axis_group

            others = [a for a in mesh.mesh_dim_names if a != layout.tensor_axis]
            group = axis_group(mesh, others[0])
        return _DataParallel(ranks=ranks, degree=degree, approx=approx, shard=shard,
                             replicas=data_ranks // degree, tensor=t, data_ranks=data_ranks,
                             data_group=group)

    def _scope(self):
        stack = contextlib.ExitStack()
        if self.runtime is not None:
            stack.enter_context(self.runtime)
        if self._dp is not None:
            stack.enter_context(shd.mesh_context(self.mesh, self.layout,
                                                 dp_degree=self._dp.degree,
                                                 dp_approx=self._dp.approx))
        return stack

    def _batch_grads(self, batch) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One batch's loss and d loss / d leaves (``launch.steps.
        make_loss_and_grads``, the step the trainer is built on)."""
        return self._loss_and_grads(self.params, self._leaves, batch)

    def loss_and_grads(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, List]:
        """The loss of one batch and its gradients in :func:`adamw.leaves`
        order: ``jax.value_and_grad(lm.loss_fn)`` over the microbatches."""
        k = self.run.microbatches
        with self._scope():
            if k == 1:
                return self._batch_grads(batch)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in self._leaves]
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            for mb in range(k):
                part = {n: t.chunk(k, dim=0)[mb] for n, t in batch.items()}
                loss, grads = self._batch_grads(part)
                for a, g in zip(acc, grads):
                    a.add_(g.float())
                total = total + loss
            return total / k, [a / k for a in acc]

    def rank_rows(self, batch_np: Dict[str, np.ndarray]):
        """This rank's rows of a global batch: (its microbatches, each a
        dict of arrays, and each one's weight, the rank's share of that
        microbatch's loss tokens over the replicas and the microbatch
        count)."""
        dp, k = self._dp, self.run.microbatches
        n = next(iter(batch_np.values())).shape[0]
        b = n // k
        rows = b // dp.degree
        labels = batch_np["labels"]
        mask = batch_np.get("loss_mask")
        tokens = (np.asarray(mask, np.float64).reshape(n, -1).sum(axis=1) if mask is not None
                  else np.full(n, float(np.prod(labels.shape[1:]))))
        parts, weights = [], []
        for j in range(k):
            lo = j * b + dp.shard * rows
            parts.append({name: a[lo:lo + rows] for name, a in batch_np.items()})
            total = tokens[j * b:(j + 1) * b].sum()
            share = tokens[lo:lo + rows].sum() / total if total > 0 else 1.0 / dp.degree
            weights.append(share / (dp.replicas * k))
        return parts, weights

    def global_loss_and_grads(self, batch_np: Dict[str, np.ndarray]):
        """The global batch's loss and gradients, in :func:`adamw.leaves`
        order, as one process would compute them: this rank's weighted
        share of its rows, summed over the ranks (a collective: every rank
        calls it with the same global batch). Sets ``last_allreduce_s`` and
        ``last_allreduce_bytes``. On one device, :meth:`loss_and_grads`."""
        if not self.distributed:
            return self.loss_and_grads(batch_to_tensors(batch_np, self.device))
        parts, weights = self.rank_rows(batch_np)
        m_bytes, m_s = (sum(collectives.COLLECTIVE_BYTES.values()),
                        sum(collectives.COLLECTIVE_SECONDS.values()))
        with self._scope():
            if len(parts) == 1:
                loss, grads = self._batch_grads(batch_to_tensors(parts[0], self.device))
                scale = weights[0]
                total = loss.float() * scale
            else:
                grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for p in self._leaves]
                total = torch.zeros((), dtype=torch.float32, device=self.device)
                for part, w in zip(parts, weights):
                    loss, g_part = self._batch_grads(batch_to_tensors(part, self.device))
                    for a, g in zip(grads, g_part):
                        a.add_(g.float(), alpha=w)
                    total = total + loss.float() * w
                scale = 1.0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # the tensor axis's collectives of the forward and backward
        self.last_model_bytes = sum(collectives.COLLECTIVE_BYTES.values()) - m_bytes
        self.last_model_s = sum(collectives.COLLECTIVE_SECONDS.values()) - m_s
        before = collectives.COLLECTIVE_BYTES["all-reduce"]
        t0 = time.perf_counter()
        if self._dp.data_ranks > 1:
            group = self._dp.data_group
            collectives.reduce_grads(grads, group=group, scale=scale)
            total = total.reshape(1).to(collectives.comm_device(self.device, group))
            collectives.all_reduce(total, group=group)
            total = total[0]
        elif scale != 1.0:
            for g in grads:
                g.mul_(scale)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_allreduce_s = time.perf_counter() - t0
        self.last_allreduce_bytes = collectives.COLLECTIVE_BYTES["all-reduce"] - before
        return total.reshape(()), grads

    @torch.no_grad()
    def replica_checksums(self) -> torch.Tensor:
        """Two int64 checksums a parameter leaf (the sum of its bits and of
        their squares, as integers), on the host."""
        out = []
        for p in self._leaves:
            flat = p.detach().reshape(-1)
            bits = flat.view({2: torch.int16, 4: torch.int32}[flat.element_size()])
            s1 = s2 = 0
            for c in bits.split(1 << 24):
                c = c.long()
                s1 += int(c.sum())
                s2 += int((c * c).sum())
            out += [s1, s2]
        return torch.tensor(out, dtype=torch.int64)

    def check_replicas(self) -> None:
        """Raise unless the ranks that hold a leaf hold the same bits: each
        piece of a cut leaf across its data group, each replicated leaf
        across every rank (the checksums of :meth:`replica_checksums`
        reduced as a min and a max; a collective)."""
        if not self.distributed:
            return
        sums = self.replica_checksums()
        whole = torch.tensor([not c for c in self._cut for _ in range(2)])
        diff = torch.zeros(sums.shape, dtype=torch.bool)
        groups = [(None, whole)]
        if self._dp.data_ranks > 1:
            groups.append((self._dp.data_group if self._tensor_parallel else None, ~whole))
        for group, keep in groups:
            if not bool(keep.any()):
                continue
            part = sums[keep].to(collectives.comm_device(self.device, group))
            lo = collectives.all_reduce(part.clone(), "min", group=group)
            hi = collectives.all_reduce(part, "max", group=group)
            diff[keep.nonzero().reshape(-1)] = (lo != hi).cpu()
        diff = diff.nonzero().reshape(-1).tolist()
        if diff:
            names = [n for n, _ in adamw.named_leaves(self.params)]
            raise RuntimeError(f"rank {self.rank}: replicas differ in {len(diff) // 2 or 1} "
                               f"parameter leaves, the first {names[diff[0] // 2]}")

    def run_one_step(self) -> Dict[str, float]:
        """One optimizer step on the next batch: ``loss``, ``grad_norm``,
        ``lr`` and ``step_time_s`` (host clock from the batch on the device
        to the updated parameters, synchronised); a rank of several adds
        ``allreduce_s`` and ``allreduce_bytes``."""
        with _obs_span("train.data"):
            batch_np = self.data.next_batch()
            batch = None if self.distributed else batch_to_tensors(batch_np, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with _obs_span("train.step", step=self.step):
            if self.distributed:
                loss, grads = self.global_loss_and_grads(batch_np)
            else:
                loss, grads = self.loss_and_grads(batch)
            with self._scope():
                grads, self.ef_state = collectives.compress_grads(
                    grads, self.ef_state, self.tcfg.grad_compression, self._scale_groups,
                    cut=self._cut)
            with self._scope(), dispatch_phase("opt"):
                _, _, om = adamw.update(self.opt_cfg, grads, self.opt_state, self.params)
            metrics = {"loss": float(loss), "grad_norm": float(om["grad_norm"]),
                       "lr": om["lr"]}
            if self.distributed:
                metrics.update(allreduce_s=self.last_allreduce_s,
                               allreduce_bytes=self.last_allreduce_bytes)
            if self._tensor_parallel:
                metrics.update(model_s=self.last_model_s, model_bytes=self.last_model_bytes)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        metrics["step_time_s"] = dt
        self.monitor.record(self.step, dt)
        self.step += 1
        col = _obs_collector()
        if col.enabled:
            # the JAX trainer's count: the first leaf (in key order)'s two lead
            # dims; a rank counts its own rows
            first = batch_np[min(batch_np)] if batch_np else None
            if first is not None and self.distributed:
                first = first[:first.shape[0] // self._dp.degree]
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
        tree = {"params": self.params, "opt": self.opt_state,
                "data": {"step": self.data.step}, "trainer_step": self.step}
        if self.ef_state is not None:
            tree["ef"] = self.ef_state
        return tree

    def _global_state_tree(self) -> Dict:
        """The state tree with every piece of a cut leaf gathered over the
        tensor axis (its parameter, AdamW's ``m``, ``v`` and ``master``, and
        ``ef``, tagged alike): the global tree one process would hold (a
        collective)."""
        tree = self._state_tree()
        if not self._tensor_parallel:
            return tree
        ax = self._axis()
        return _tree_map(lambda t: tp.gather_full(t, ax) if tp.shard_info(t) else t, tree)

    def _axis(self):
        with shd.mesh_context(self.mesh, self.layout):
            return tp.model_axis()

    def save_checkpoint(self) -> None:
        """Checkpoint the state at ``self.step`` (async unless
        ``tcfg.async_checkpoint`` is off). A rank of several: the pieces are
        gathered over the tensor axis, rank 0 writes and waits for the
        commit, and every rank waits for it at a barrier."""
        tree = self._global_state_tree()
        if self.rank == 0:
            if self.tcfg.async_checkpoint:
                self.ckpt.save_async(self.step, tree)
            else:
                self.ckpt.save(self.step, tree)
        if self.distributed:
            import torch.distributed as dist

            if self.rank == 0:
                self.ckpt.wait()
            dist.barrier()

    @torch.no_grad()
    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Roll the state back to checkpoint ``step`` (the latest committed
        one by default), copying into the tensors the trainer holds (a
        rank's pieces cut from the global leaves); returns the step to
        resume from. With no checkpoint: restart from scratch, re-initialised
        from ``tcfg.seed``, or raise when the trainer was handed its
        parameters."""
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
            for e in self.ef_state or ():
                e.zero_()
            self.opt_state["step"] = 0
            self.step = self.data.step = 0
            return 0
        live = self._state_tree()
        tree = self.ckpt.restore(step, self._global_template(live), device="cpu")
        self._copy_into(live, tree)
        self.opt_state["step"] = tree["opt"]["step"]
        self.data.step = tree["data"]["step"]
        self.step = tree["trainer_step"]
        log.info("restored checkpoint at step %d", self.step)
        return self.step

    @staticmethod
    def _global_template(live):
        """``live`` with each piece of a cut leaf replaced by an empty tensor
        of the global shape on the meta device: what the checkpoint holds."""
        return _tree_map(lambda t: torch.empty(tp.global_shape(t), dtype=t.dtype,
                                                   device="meta")
                             if tp.shard_info(t) else t, live)

    @staticmethod
    def _copy_into(live, tree) -> None:
        for (_, dst), (_, src) in zip(ckpt_mod.flatten_with_paths(live),
                                      ckpt_mod.flatten_with_paths(tree)):
            if isinstance(dst, torch.Tensor):
                if tuple(src.shape) != tuple(dst.shape):
                    src = tp.take_shard(src, tp.shard_info(dst))
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

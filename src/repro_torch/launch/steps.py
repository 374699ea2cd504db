"""Train, prefill and serve steps and their specs: the port of
``repro.launch.steps``.

:func:`build_cell` is the entry point JAX's dry-run, trainer and serving
share: given (arch config, shape, mesh, layout, run config) it returns the
step function, a rank's abstract inputs and the specs. In the port a rank's
inputs are its own pieces, so the abstract inputs are the rank's local
shapes on the ``meta`` device: its cuts of the parameters
(``lm.rank_params``), its rows of the batch, and a cache of the kv heads
its attention computes. The specs are JAX's (``param_shardings``,
``data_specs``, ``cache_shardings``) beside the cache layout the port uses
(``Cell.rank_cache_specs``: the kv-head dim over the tensor axis where the
rank's k/v hold whole heads; JAX's ``cache_shardings`` gives the tensor
axis to the largest divisible dim, the cache length).

The Trainer builds its gradient step with :func:`make_loss_and_grads` and
the engines their prefill and decode steps with :func:`make_prefill_step`
and :func:`make_serve_step`. JAX's ``lower_cell`` (jit, then lower) has no
counterpart: the port runs eagerly and has nothing to lower; the dry-run
(``launch/dryrun.py``) is a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed import sharding as shd
from ..distributed import tensor_parallel as tp
from ..models import lm
from ..models import transformer as tf
from ..models.transformer import RunConfig
from ..optim import adamw


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def make_loss_and_grads(cfg: ArchConfig, run: RunConfig):
    """``(params, leaves, batch) -> (loss, grads)``: one batch's loss
    (``lm.loss_fn``, detached) and its gradients with respect to
    ``leaves`` (``adamw.leaves(params)``), zeros for a leaf the loss does
    not read (the token table of an arch whose frontend feeds embeddings),
    as ``jax.grad`` gives."""

    def loss_and_grads(params, leaves, batch):
        loss, _ = lm.loss_fn(params, batch, cfg, run)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    return loss_and_grads


def make_train_step(cfg: ArchConfig, run: RunConfig, opt_cfg: adamw.AdamWConfig):
    """JAX's train step, ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradients of ``run.microbatches`` equal parts of the
    batch averaged in fp32, then AdamW, in place."""
    loss_and_grads = make_loss_and_grads(cfg, run)

    def train_step(params, opt_state, batch):
        leaves = adamw.leaves(params)
        k = run.microbatches
        if k == 1:
            loss, grads = loss_and_grads(params, leaves, batch)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for mb in range(k):
                part = {n: t.chunk(k, dim=0)[mb] for n, t in batch.items()}
                l_mb, g_mb = loss_and_grads(params, leaves, part)
                for a, g in zip(grads, g_mb):
                    a.add_(g.float())
                loss = loss + l_mb
            grads, loss = [g / k for g in grads], loss / k
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state, params)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg: ArchConfig, run: RunConfig, cache_len: Optional[int] = None):
    """``(params, batch, true_len=None) -> (last logits, caches)``."""

    def prefill_step(params, batch, true_len=None):
        return lm.prefill(params, batch, cfg, run, cache_len=cache_len, true_len=true_len)

    return prefill_step


def make_serve_step(cfg: ArchConfig, run: RunConfig):
    """``(params, caches, tokens, pos) -> (logits, caches)``."""

    def serve_step(params, caches, tokens, pos):
        return lm.decode_step(params, tokens, caches, pos, cfg, run)

    return serve_step


# ---------------------------------------------------------------------------
# cell assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """One (arch x shape x mesh) unit, as a rank sees it."""

    step_fn: Any
    abstract_inputs: Tuple
    in_specs: Tuple
    out_specs: Any
    kind: str
    mesh: Any = None
    layout: Any = None
    rank_cache_specs: Any = None


def input_specs(cfg: ArchConfig, shape: ShapeSpec, rows: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """The batch of one cell on the ``meta`` device (JAX's ``input_specs``),
    with ``rows`` of its batch (default the global batch)."""
    B, S = rows or shape.global_batch, shape.seq_len
    meta = lambda *s, dt=torch.int32: torch.empty(s, dtype=dt, device="meta")
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio_frames":
            return {"embeds": meta(B, S, cfg.d_model, dt=cfg.tdtype), "labels": meta(B, S)}
        if cfg.frontend == "vision_patches":
            P = cfg.num_prefix
            return {"embeds": meta(B, P, cfg.d_model, dt=cfg.tdtype), "tokens": meta(B, S - P),
                    "labels": meta(B, S), "loss_mask": meta(B, S, dt=torch.float32)}
        return {"tokens": meta(B, S), "labels": meta(B, S)}
    return {"tokens": meta(B, 1), "pos": meta()}


def _meta_caches(cfg: ArchConfig, batch: int, cache_len: int, kv_heads: Optional[int]):
    return tuple({name: {kk: torch.empty(shape, dtype=dt, device="meta")
                         for kk, (shape, dt) in leaves.items()}
                  for name, leaves in seg.items()}
                 for seg in tf.cache_shapes(cfg, batch, cache_len, kv_heads))


def _rank_cache_specs(caches, plan: tp.HeadPlan, layout):
    """The port's cache layout: a rank's k/v over the tensor axis on the
    kv-head dim (3 of ``[layers, batch, len, kv, hd]``) where its attention
    holds whole heads of its own, else whole on every rank (the heads its
    queries read, picked from whole k and v)."""
    kv = shd.P(None, None, None, layout.tensor_axis) if plan.kv_local else shd.P()
    return tuple({name: {kk: (kv if kk in ("k", "v") else shd.P()) for kk in leaves}
                  for name, leaves in seg.items()} for seg in caches)


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, layout: shd.Layout, run: RunConfig,
               opt_cfg: Optional[adamw.AdamWConfig] = None) -> Cell:
    """The step, this rank's abstract inputs and the specs of one cell on
    ``mesh`` (a mesh, whose coordinate picks the rank's pieces, or a size
    map, read as its rank 0)."""
    sizes = shd.mesh_axis_sizes(mesh)
    spec_tree = lm.param_specs(cfg, sizes, layout)
    tp.check_supported(cfg, sizes, layout)
    rank_mesh = mesh if hasattr(mesh, "get_coordinate") else _SizeMesh(sizes)
    params_abs = tp.shard_params(lm.abstract_params(cfg), spec_tree, rank_mesh, layout)
    batch_global = input_specs(cfg, shape)
    if shape.kind == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        b_sh = shd.data_specs(batch_global, sizes, layout)
        dp = shd.data_parallel_degree(sizes, layout, shape.global_batch)
        opt_abs = {"step": 0, **{k: [torch.empty(p.shape, dtype=torch.float32, device="meta")
                                     for p in adamw.leaves(params_abs)]
                                 for k in ("m", "v") + (("master",) if opt_cfg.master_fp32
                                                        else ())}}
        o_sh = {k: shd.spec_leaves(spec_tree) for k in opt_abs if k != "step"}
        return Cell(make_train_step(cfg, run, opt_cfg),
                    (params_abs, opt_abs, input_specs(cfg, shape, shape.global_batch // dp)),
                    (spec_tree, o_sh, b_sh), (spec_tree, o_sh, None), "train", mesh, layout)
    if shape.kind == "prefill":
        b_sh = shd.data_specs(batch_global, sizes, layout)
        dp = shd.data_parallel_degree(sizes, layout, shape.global_batch)
        return Cell(make_prefill_step(cfg, run, cache_len=shape.seq_len),
                    (params_abs, input_specs(cfg, shape, shape.global_batch // dp)),
                    (spec_tree, b_sh), None, "prefill", mesh, layout)
    # decode
    plan = tp.spec_plan(cfg, sizes, layout)
    caches_global = _meta_caches(cfg, shape.global_batch, shape.seq_len, None)
    c_sh = shd.cache_shardings(caches_global, sizes, layout)
    caches_abs = _meta_caches(cfg, shape.global_batch, shape.seq_len, plan.kv_n)
    tok_abs = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")
    t_sh = shd.data_specs(tok_abs, sizes, layout)
    return Cell(make_serve_step(cfg, run),
                (params_abs, caches_abs, tok_abs, torch.empty((), dtype=torch.int32,
                                                              device="meta")),
                (spec_tree, c_sh, t_sh, shd.P()), (None, c_sh), "decode", mesh, layout,
                rank_cache_specs=_rank_cache_specs(caches_abs, plan, layout))


class _SizeMesh:
    """Rank 0 of a mesh known by its axis sizes alone."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.mesh = torch.zeros(tuple(sizes.values()), device="meta")

    def get_coordinate(self):
        return [0] * len(self.mesh_dim_names)

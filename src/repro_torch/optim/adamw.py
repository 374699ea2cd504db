"""AdamW with fp32 master weights and moments, global-norm clipping.

The arithmetic of ``repro.optim.adamw``: a linear warmup into a cosine
schedule, gradients scaled by ``min(1, grad_clip / global_norm)``, fp32
``m`` and ``v``, the update applied to an fp32 master copy of every leaf
and cast back to the parameter's dtype, weight decay on every leaf.

Where the JAX package returns new trees, the port updates the parameters
and the state in place (no second copy of any leaf); the state holds one
tensor per parameter leaf, in :func:`leaves` order. The trainer runs
:func:`update` under ``dispatch_phase("opt")``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    master_fp32: bool = True     # keep an fp32 master copy of bf16 params


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) for each tensor of a params tree, dict keys sorted
    (``jax.tree_util``'s order), lists and tuples in order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    return [leaf for k, v in items for leaf in named_leaves(v, f"{prefix}/{k}")]


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params tree in :func:`named_leaves` order."""
    return [t for _, t in named_leaves(tree)]


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Learning rate at ``step`` (1-based, as after the update's increment)."""
    warm = min(1.0, step / max(cfg.warmup_steps, 1))
    t = min(max((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0),
            1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + math.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(cfg: AdamWConfig, params) -> Dict[str, Any]:
    ps = leaves(params)
    state: Dict[str, Any] = {
        "step": 0,
        "m": [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in ps],
        "v": [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in ps],
    }
    if cfg.master_fp32:
        state["master"] = [p.detach().float().clone() for p in ps]
    return state


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state, params):
    """One AdamW step, in place. ``grads`` is a list in :func:`leaves`
    order. Returns (params, state, {"grad_norm", "lr"}); ``grad_norm``
    stays a tensor on the device (reading it waits for the device)."""
    ps = leaves(params)
    if len(grads) != len(ps):
        raise ValueError(f"{len(grads)} gradients for {len(ps)} parameters")
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-9), max=1.0)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for i, (p, g) in enumerate(zip(ps, grads)):
        g = g.float() * scale
        m, v = state["m"][i], state["v"][i]
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = state["master"][i] if "master" in state else p.float()
        p32.sub_(lr * (upd + cfg.weight_decay * p32))
        p.copy_(p32)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

"""Carry the JAX package's parameters across to the port.

The caller turns the JAX ``lm.init_params`` tree into numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, params)``); :func:`from_jax_params`
builds the port's tree from it. Names and layouts are the same; the one
structural change is that each segment's leading ``layers`` (scan) axis is
unstacked into a list of super-blocks, since the port loops over layers.
:func:`batch_to_tensors` carries a batch dict across the same way. Given a
mesh and a layout, :func:`from_jax_params` returns a rank's pieces of the
same tree (``lm.rank_params``: ``sharding.shard_of`` of each leaf the specs
cut over the tensor axis).
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.platform import resolve_device


def to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> torch, bfloat16 included (numpy's bfloat16 is an extension
    type torch cannot read, so it crosses bit for bit as int16)."""
    a = np.array(a, order="C")      # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v, fn) for v in x)
    return fn(x)


def from_jax_params(np_params, cfg: ArchConfig,
                    device: Union[str, torch.device, None] = None, mesh=None,
                    layout=None) -> Any:
    """The port's parameters from the JAX parameter tree in numpy; with
    ``mesh`` (and ``layout``, default ``launch.defaults.default_layout``)
    this rank's pieces of them."""
    if mesh is not None:
        from .models import lm

        host = lm.rank_params(from_jax_params(np_params, cfg, "cpu"), cfg, mesh, layout)
        return _to(host, resolve_device(device))
    dev = resolve_device(device)
    segments = []
    for seg, stacked in zip(cfg.segments(), np_params["segments"]):
        segments.append([
            _tree(stacked, lambda a, r=r: to_tensor(np.asarray(a)[r], dev))
            for r in range(seg.repeats)
        ])
    out = {k: _tree(v, lambda a: to_tensor(a, dev))
           for k, v in np_params.items() if k != "segments"}
    out["segments"] = tuple(segments)
    return out


def _to(tree, dev):
    """A tree of (tagged) tensors moved to ``dev``, the tags kept."""
    from .distributed import tensor_parallel as tp

    def one(t):
        info = tp.shard_info(t)
        out = t.to(dev)
        return out if info is None else tp.mark(out, *info)

    return _tree(tree, one)


def batch_to_tensors(batch, device: Union[str, torch.device, None] = None):
    """A batch dict of numpy arrays (the JAX package's ``SyntheticPipeline``
    or the port's) as tensors on ``device``: integer arrays (tokens,
    labels) as int64, the index type of PyTorch's embedding gather; float
    arrays keep their dtype."""
    dev = resolve_device(device)
    out = {}
    for name, a in batch.items():
        a = np.asarray(a)
        t = to_tensor(a, dev)
        out[name] = t.long() if a.dtype.kind in "iu" else t
    return out

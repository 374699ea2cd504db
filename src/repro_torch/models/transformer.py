"""Block assembly for attention + dense-FFN decoders.

Where the JAX package scans over stacked super-block params, the port
loops over layers in Python: ``params["segments"][si]`` is a list of
super-blocks (one per repeat), each ``{"l{i}": layer params}``. Caches keep
the JAX layout: per segment ``{"l{i}": {"k": [repeats, b, clen, kv, hd],
"v": ...}}``.

Three modes share one code path: ``train`` (full sequence, no caches),
``prefill`` (full sequence, emits caches) and ``decode`` (one token,
updates caches in place). In ``train`` mode ``RunConfig.remat="full"``
wraps each layer in ``torch.utils.checkpoint`` (non-reentrant): only the
layer's input is kept and the layer runs again in the backward.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from ..configs.base import ArchConfig, LayerSpec
from ..core.runtime import current_runtime
from . import attention as attn
from .layers import ffn_apply, ffn_init, norm_init, rmsnorm

REMAT = ("none", "full")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Runtime knobs that change no math: attention chunking of the plain
    path, rematerialization, the sequence chunk of the loss and gradient
    accumulation steps (``repro``'s names and defaults, except ``remat``:
    the port has ``"none"`` and ``"full"``; the JAX default ``"dots"``,
    which keeps matmul outputs, is not ported yet and raises)."""

    remat: str = "none"
    q_chunk: int = 512
    k_chunk: int = 1024
    loss_chunk: int = 512
    microbatches: int = 1

    def __post_init__(self):
        if self.remat not in REMAT:
            raise NotImplementedError(f"remat={self.remat!r}: the port has {REMAT}")
        if self.microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got {self.microbatches}")


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer != "attn":
        raise NotImplementedError(f"the port has attention mixers only, not {spec.mixer!r}")
    if spec.ffn not in ("dense", "none"):
        raise NotImplementedError(f"the port has dense FFNs only, not {spec.ffn!r}")


def layer_init(gen, cfg: ArchConfig, spec: LayerSpec, device):
    _check_spec(spec)
    dt = cfg.tdtype
    p = {
        "norm1": norm_init(cfg.d_model, dt, device),
        "mixer": attn.attention_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                     cfg.hd, dt, device, qkv_bias=cfg.qkv_bias),
    }
    if spec.ffn != "none":
        p["norm2"] = norm_init(cfg.d_model, dt, device)
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, dt, device)
    return p


def segment_init(gen, cfg: ArchConfig, seg, device):
    return [
        {f"l{i}": layer_init(gen, cfg, spec, device) for i, spec in enumerate(seg.pattern)}
        for _ in range(seg.repeats)
    ]


def layer_apply(p, x, spec: LayerSpec, cfg: ArchConfig, run: RunConfig, mode: str,
                cache=None, pos=None, true_len=None):
    """Returns (x, new_cache). ``cache`` is the cache length in prefill mode
    and the layer's cache dict in decode mode."""
    _check_spec(spec)
    common = dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, head_dim=cfg.hd,
                  rope_theta=cfg.rope_theta, window=spec.window)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mode == "train":
        y = attn.attention_forward(p["mixer"], h, q_chunk=run.q_chunk, k_chunk=run.k_chunk,
                                   **common)
        new_cache = None
    elif mode == "prefill":
        y, new_cache = attn.attention_forward(
            p["mixer"], h, q_chunk=run.q_chunk, k_chunk=run.k_chunk,
            return_cache=True, cache_len=cache, true_len=true_len, **common)
    elif mode == "decode":
        y, new_cache = attn.attention_decode(p["mixer"], h, cache, pos,
                                             k_chunk=run.k_chunk, **common)
    else:
        raise ValueError(f"mode {mode!r} not in ('train', 'prefill', 'decode')")
    x = x + y
    if spec.ffn != "none":
        x = x + ffn_apply(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps), cfg.ffn_kind)
    return x, new_cache


def _train_layer(block, x, spec: LayerSpec, cfg: ArchConfig, run: RunConfig):
    """One layer in train mode; under ``remat="full"`` a checkpointed one.

    The recompute runs inside the backward, which autograd may run on
    another thread; the layer enters the runtime active at the forward so
    the recompute resolves under the same scope."""
    if run.remat == "none":
        return layer_apply(block, x, spec, cfg, run, "train")[0]
    rt = current_runtime()

    def fn(xx):
        with rt:
            return layer_apply(block, xx, spec, cfg, run, "train")[0]

    return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)


def stack_apply(segments_params, x, cfg: ArchConfig, run: RunConfig, mode: str,
                caches=None, pos=None, cache_len=None, true_len=None):
    """Apply all segments. Returns (x, caches): prefill builds them in the
    JAX layout, decode updates ``caches`` in place and returns it, train
    returns None."""
    if mode == "train":
        for seg, blocks in zip(cfg.segments(), segments_params):
            for block in blocks:
                for i, spec in enumerate(seg.pattern):
                    x = _train_layer(block[f"l{i}"], x, spec, cfg, run)
        return x, None
    out_caches = []
    for si, (seg, blocks) in enumerate(zip(cfg.segments(), segments_params)):
        per_layer = {f"l{i}": [] for i in range(len(seg.pattern))}
        for r, block in enumerate(blocks):
            for i, spec in enumerate(seg.pattern):
                name = f"l{i}"
                if mode == "decode":
                    c = {kk: t[r] for kk, t in caches[si][name].items()}
                else:
                    c = cache_len
                x, nc = layer_apply(block[name], x, spec, cfg, run, mode, c, pos,
                                    true_len=true_len)
                if mode == "prefill":
                    per_layer[name].append(nc)
        if mode == "prefill":
            out_caches.append({
                name: {kk: torch.stack([c[kk] for c in cs]) for kk in cs[0]}
                for name, cs in per_layer.items()
            })
    return x, (tuple(out_caches) if mode == "prefill" else caches)


def cache_shapes(cfg: ArchConfig, batch: int, cache_len: int):
    """Per segment ``{"l{i}": shape of its stacked k (and v) cache}``."""
    out = []
    for seg in cfg.segments():
        sb = {}
        for i, spec in enumerate(seg.pattern):
            _check_spec(spec)
            sb[f"l{i}"] = (seg.repeats,) + attn.attention_cache_shape(
                batch, cache_len, cfg.num_kv_heads, cfg.hd, spec.window)
        out.append(sb)
    return tuple(out)

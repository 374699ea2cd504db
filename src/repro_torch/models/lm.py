"""Top-level language model: embed -> layer stack -> final norm -> unembed.

Public surface, plain functions over dicts of tensors, as in
``repro.models.lm``:
    init_params(cfg, seed, device)                -> params
    abstract_params(cfg)                          -> the tree on the meta device
    param_axes(cfg)                               -> each leaf's logical dim names
    forward(params, batch, cfg, run, ...)         -> (hidden, aux, caches)
    loss_fn(params, batch, cfg, run)              -> (loss, {"xent", "aux"})
    prefill(params, batch, cfg, run, ...)         -> (last_logits, caches)
    decode_step(params, tokens, caches, pos, ...) -> (logits, caches)
    init_cache / insert_cache                     -> the slot-pool cache
    param_specs / rank_params                     -> a mesh rank's pieces

The loss never holds [batch, seq, vocab] logits at once: they are made and
consumed one sequence chunk at a time (``RunConfig.loss_chunk``), each
chunk an unembed ``matmul`` dispatch followed by a ``softmax_xent``
dispatch.

On a tensor axis of several ranks (``distributed.tensor_parallel``) the
parameters are the rank's pieces: the embedding is looked up
vocab-parallel, the loss is the vocab-parallel cross entropy over the
rank's unembed columns, and :func:`prefill` and :func:`decode_step` return
the whole ``[b, vocab]`` logits, gathered over the axis, so a host sampler
sees what one process sees.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.platform import resolve_device
from ..core.runtime import dispatch
from ..distributed import sharding as shd
from ..distributed import tensor_parallel as tp
from . import transformer as tf
from .layers import (embed, embedding_axes, embedding_init, norm_axes, norm_init, rmsnorm,
                     rmsnorm_dense, unembed, unembed_axes, unembed_init)

Batch = Dict[str, torch.Tensor]


def init_params(cfg: ArchConfig, seed: int = 0,
                device: Union[str, torch.device, None] = None, mesh=None,
                layout=None) -> Dict[str, Any]:
    """Random parameters from an explicit ``torch.Generator`` seeded with
    ``seed``, made on ``device`` (default ``cuda``), with the JAX package's
    init scales. The numbers differ from JAX's for the same seed: tests carry
    JAX parameters across with :func:`repro_torch.convert.from_jax_params`.
    With ``mesh`` and ``layout``, this rank's pieces (:func:`rank_params`)
    of the same numbers: the whole tree is drawn on ``device`` and cut,
    which at the archs tensor parallelism runs (qwen2_0_5b's 1 GB in bf16)
    costs one tree's memory for the moment of the cut."""
    dev = resolve_device(device)
    params = _init_tree(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    return params if mesh is None else rank_params(params, cfg, mesh, layout)


def param_specs(cfg: ArchConfig, mesh, layout):
    """The solver's spec tree of ``cfg``'s parameters on ``mesh`` (a mesh
    or a size map) under ``layout``."""
    return shd.param_shardings(param_axes(cfg), abstract_params(cfg),
                               shd.mesh_axis_sizes(mesh), layout)


def rank_params(params, cfg: ArchConfig, mesh, layout):
    """This rank's tree of the global ``params`` on ``mesh``: every leaf
    the specs cut over the tensor axis becomes its tagged piece
    (``tensor_parallel.shard_params``); raises ``NotImplementedError`` for
    what the port does not run on a mesh (``tensor_parallel.
    check_supported``)."""
    if layout is None:
        from ..launch.defaults import default_layout

        layout = default_layout(cfg)
    tp.check_supported(cfg, mesh, layout)
    return tp.shard_params(params, param_specs(cfg, mesh, layout), mesh, layout)


def _init_tree(cfg: ArchConfig, gen, dev) -> Dict[str, Any]:
    dt = cfg.tdtype
    return {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, dev),
        "segments": tuple(tf.segment_init(gen, cfg, seg, dev) for seg in cfg.segments()),
        "final_norm": norm_init(cfg.d_model, dt, dev),
        "lm_head": unembed_init(gen, cfg.d_model, cfg.vocab_size, dt, dev),
    }


@torch.no_grad()
def reinit_params_(params: Dict[str, Any], cfg: ArchConfig, seed: int = 0) -> None:
    """:func:`init_params` again, into ``params`` in place: the same numbers
    for the same seed on the tree's device, drawn in the same order but one
    piece (the embedding, a layer, the head) at a time, so no second full
    tree is ever held."""
    dev = params["embed"]["table"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.tdtype
    _copy_tree_(params["embed"], embedding_init(gen, cfg.vocab_size, cfg.d_model, dt, dev))
    for live, seg in zip(params["segments"], cfg.segments()):
        for live_rep in live:
            for i, spec in enumerate(seg.pattern):
                _copy_tree_(live_rep[f"l{i}"], tf.layer_init(gen, cfg, spec, dev))
    _copy_tree_(params["final_norm"], norm_init(cfg.d_model, dt, dev))
    _copy_tree_(params["lm_head"], unembed_init(gen, cfg.d_model, cfg.vocab_size, dt, dev))


def _copy_tree_(dst, src) -> None:
    """Copy ``src`` into ``dst``; a rank's piece takes its piece of the drawn
    tensor."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree_(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_tree_(d, s)
    else:
        dst.copy_(tp.take_shard(src, tp.shard_info(dst)))


def abstract_params(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree on the ``meta`` device: every leaf's shape and
    dtype, and no memory, as the JAX package's ``abstract_params``."""
    return _init_tree(cfg, torch.Generator(), torch.device("meta"))


def param_axes(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree's shape with a tuple of logical dim names at each
    leaf (``("d_model", "ff")``): the axes tree the JAX package's
    ``abstract_params`` returns, with each segment's stacked ``layers`` dim
    unstacked as the port's parameters are, one entry a repeat. The
    sharding solver reads it."""
    return {
        "embed": embedding_axes(),
        "segments": tuple([tf.superblock_axes(cfg, seg) for _ in range(seg.repeats)]
                          for seg in cfg.segments()),
        "final_norm": norm_axes(),
        "lm_head": unembed_axes(),
    }


def param_count(params) -> int:
    """Parameters of a tree, or of an :class:`ArchConfig` (counted on its
    abstract tree, so a full-size model is never allocated)."""
    if isinstance(params, ArchConfig):
        params = abstract_params(params)
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return sum(param_count(v) for v in params)


def _embed_inputs(params, batch: Batch, cfg: ArchConfig) -> torch.Tensor:
    """The layer stack's input, as ``repro.models.lm._embed_inputs``: the
    audio frontend's frame embeddings (``embeds`` [b, s, d]) cast to the
    model dtype; the vision frontend's patch embeddings (``embeds`` [b, P,
    d]) cast to the token embeddings' dtype and put before them; else the
    token embeddings."""
    if cfg.frontend == "audio_frames":
        return batch["embeds"].to(cfg.tdtype)
    if cfg.frontend == "vision_patches":
        tok = embed(params["embed"], batch["tokens"])
        return torch.cat([batch["embeds"].to(tok.dtype), tok], dim=1)
    if cfg.frontend is not None:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")
    return embed(params["embed"], batch["tokens"])


def forward(params, batch: Batch, cfg: ArchConfig, run: tf.RunConfig,
            mode: str = "train", cache_len: Optional[int] = None, true_len=None):
    """Embed (a frontend's embeddings where the arch has one), the layer
    stack and the final norm: (hidden, aux, caches), ``aux`` the MoE layers'
    load-balancing loss summed (0 without experts)."""
    x = _embed_inputs(params, batch, cfg)
    x, aux, caches = tf.stack_apply(params["segments"], x, cfg, run, mode,
                                    cache_len=cache_len, true_len=true_len)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux, caches


def _chunked_xent(lm_head, x, labels, mask, loss_chunk: int):
    """Mean cross entropy over the tokens ``mask`` keeps, one sequence chunk
    of the unembed at a time (a Python loop where ``repro`` scans). Padding
    and masking as in ``repro.models.lm._chunked_xent``."""
    b, s, d = x.shape
    chunk = min(loss_chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    vocab_cut = tp.shard_dim(lm_head["w"]) == 1
    if vocab_cut:
        x = tp.copy_to_model(x)
    for c0 in range(0, x.shape[1], chunk):
        xx = x[:, c0:c0 + chunk].reshape(b * chunk, d)
        mm = mask[:, c0:c0 + chunk].reshape(-1)
        logits = unembed(lm_head, xx)
        lab = labels[:, c0:c0 + chunk].reshape(-1)
        losses = (tp.vocab_parallel_xent(logits, lab) if vocab_cut
                  else dispatch("softmax_xent", logits, lab))
        tot = tot + (losses * mm).sum()
        cnt = cnt + mm.sum()
    return tot / cnt.clamp_min(1.0)


def loss_fn(params, batch: Batch, cfg: ArchConfig, run: tf.RunConfig,
            aux_weight: float = 0.01):
    """(loss, {"xent", "aux"}): the chunked cross entropy plus ``aux_weight``
    times the MoE load-balancing loss (0 without experts)."""
    x, aux, _ = forward(params, batch, cfg, run, mode="train")
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    xent = _chunked_xent(params["lm_head"], x, labels, mask.float(), run.loss_chunk)
    return xent + aux_weight * aux, {"xent": xent, "aux": aux}


def prefill(params, batch: Batch, cfg: ArchConfig, run: tf.RunConfig,
            cache_len: Optional[int] = None, true_len=None):
    """Full-sequence forward emitting caches and the last position's logits;
    a frontend's prefix counts in the sequence (the patches and the tokens
    after them).

    ``true_len`` enables bucketed prefill: the batch is right-padded, logits
    are read at position ``true_len - 1`` and window caches ring-align to
    ``true_len``; causality keeps the pads out of every real position, and
    MoE layers route only the real tokens (pads take no capacity). A
    Mamba layer's state would integrate the pads, so an arch with one is
    prefilled at exact length (the engine does so).
    """
    seq = batch["tokens"].shape[1] if "tokens" in batch else batch["embeds"].shape[1]
    if cfg.frontend == "vision_patches":
        seq = batch["embeds"].shape[1] + batch["tokens"].shape[1]
    tl = None if true_len is None else int(true_len)
    x, _, caches = forward(params, batch, cfg, run, mode="prefill",
                           cache_len=cache_len or seq, true_len=tl)
    last = x[:, -1] if tl is None else x[:, tl - 1]
    if tp.shard_dim(params["lm_head"]["w"]) == 1:
        last = tp.copy_to_model(last)
    return _whole_logits(params, unembed(params["lm_head"], last)), caches


def _whole_logits(params, logits):
    """The logits over the whole vocabulary: the ranks' columns gathered
    where the unembed is cut over the tensor axis."""
    if tp.shard_dim(params["lm_head"]["w"]) == 1:
        return tp.gather_from_model(logits, -1)
    return logits


def decode_step(params, tokens, caches, pos, cfg: ArchConfig, run: tf.RunConfig):
    """tokens [b, 1]; pos a scalar or [b] absolute position per row.

    Returns (logits [b, vocab], caches); the caches are updated in place.
    The recurrent states are committed after the logits are computed, so a
    step that raises at any dispatch, the unembed's included, leaves them as
    they were (the engine's degraded retry steps each once).
    """
    x = embed(params["embed"], tokens)
    pending = []
    x, _, caches = tf.stack_apply(params["segments"], x, cfg, run, mode="decode",
                                  caches=caches, pos=pos, pending=pending)
    logits = rmsnorm_dense(params["final_norm"], params["lm_head"], x[:, 0], cfg.norm_eps)
    logits = _whole_logits(params, logits)
    tf.commit_states(pending)
    return logits, caches


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, device, params=None):
    """Zero-filled cache for a ``batch``-slot decode pool (JAX layout), each
    leaf in its own dtype (the Mamba state ``h`` in fp32). Given a rank's
    ``params``, an attention layer's cache holds the kv heads its head plan
    takes (the heads, not JAX's ``cache_shardings``, decide the layout)."""
    dev = torch.device(device)
    return tuple(
        {name: {kk: torch.zeros(shape, dtype=dt, device=dev) for kk, (shape, dt) in leaves.items()}
         for name, leaves in seg.items()}
        for seg in tf.cache_shapes(cfg, batch, cache_len, _rank_kv_heads(params, cfg))
    )


def _rank_kv_heads(params, cfg: ArchConfig) -> Optional[int]:
    """The kv heads a rank's attention layers take (None: all of them)."""
    if params is None:
        return None
    for seg, blocks in zip(cfg.segments(), params["segments"]):
        for i, spec in enumerate(seg.pattern):
            if spec.mixer == "attn" and blocks:
                return tp.attention_plan(blocks[0][f"l{i}"]["mixer"], cfg.num_heads,
                                         cfg.num_kv_heads).kv_n
    return None


def insert_cache(pool, new, slot: int):
    """Overwrite slot ``slot`` of the pool (batch axis 1 of every leaf) with
    a batch-1 prefill cache of the same length, in place; returns the pool.
    The write covers the slot's whole region, so nothing of the previous
    occupant survives."""
    for seg_pool, seg_new in zip(pool, new):
        for name, leaves in seg_pool.items():
            for kk, t in leaves.items():
                t[:, slot:slot + 1].copy_(seg_new[name][kk])
    return pool

"""Block assembly for decoders of attention, Mamba, mLSTM and sLSTM mixers
with dense, MoE, MoE-plus-dense or no FFNs.

Where the JAX package scans over stacked super-block params, the port
loops over layers in Python: ``params["segments"][si]`` is a list of
super-blocks (one per repeat), each ``{"l{i}": layer params}``. Caches keep
the JAX layout: per segment ``{"l{i}": leaves}``, each leaf stacked over
the repeats, ``{"k": [repeats, b, clen, kv, hd], "v": ...}`` for an
attention layer, ``{"h": [repeats, b, di, ds] (fp32), "conv": [repeats,
b, d_conv - 1, di]}`` for a Mamba layer, ``{"C", "n", "m"}`` for an mLSTM
layer and ``{"c", "n", "h", "m"}`` for an sLSTM layer (fp32).

Three modes share one code path: ``train`` (full sequence, no caches),
``prefill`` (full sequence, emits caches) and ``decode`` (one token,
updates caches in place: attention writes its new row into the pool, and
a recurrent mixer's state, which its ``*_decode`` returns as new tensors,
is copied back into the pool's slices). In ``train`` mode
``RunConfig.remat="full"`` wraps each layer in ``torch.utils.checkpoint``
(non-reentrant): only the layer's input is kept and the layer runs again
in the backward. Every layer returns its MoE load-balancing loss (0
without experts), and ``stack_apply`` sums them; prefill passes
``true_len`` to the MoE layers too, so bucket pads take no expert capacity,
and decode passes none.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from ..configs.base import ArchConfig, LayerSpec
from ..core.runtime import current_runtime
from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .layers import ffn_apply, ffn_init, norm_init, rmsnorm

REMAT = ("none", "full")
MIXERS = ("attn", "mamba", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Runtime knobs that change no math: attention chunking of the plain
    path, rematerialization, the mLSTM's chunk, the sequence chunk of the
    loss, the MoE dispatch formulation and gradient accumulation steps
    (``repro``'s names and defaults, except ``remat``: the port has
    ``"none"`` and ``"full"``; the JAX default ``"dots"``, which keeps
    matmul outputs, is not ported yet and raises). ``slstm_unroll`` is the
    JAX scan's unroll factor, a schedule knob: it is accepted and changes
    nothing in eager mode, where the sLSTM's loop runs one token a step."""

    remat: str = "none"
    q_chunk: int = 512
    k_chunk: int = 1024
    mlstm_chunk: int = 64
    loss_chunk: int = 512
    slstm_unroll: int = 1
    moe_dispatch: str = "scatter"   # scatter | dense
    microbatches: int = 1

    def __post_init__(self):
        if self.remat not in REMAT:
            raise NotImplementedError(f"remat={self.remat!r}: the port has {REMAT}")
        if self.microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got {self.microbatches}")


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer not in MIXERS:
        raise ValueError(f"mixer {spec.mixer!r} not in {MIXERS}")


def layer_init(gen, cfg: ArchConfig, spec: LayerSpec, device):
    _check_spec(spec)
    dt = cfg.tdtype
    if spec.mixer == "attn":
        mixer = attn.attention_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                    cfg.hd, dt, device, qkv_bias=cfg.qkv_bias)
    elif spec.mixer == "mamba":
        mixer = ssm.mamba_init(gen, cfg.d_model, dt, device, expand=cfg.mamba_expand,
                               d_state=cfg.mamba_d_state)
    elif spec.mixer == "mlstm":
        mixer = ssm.mlstm_init(gen, cfg.d_model, cfg.num_heads, dt, device)
    else:
        mixer = ssm.slstm_init(gen, cfg.d_model, cfg.num_heads, dt, device)
    p = {"norm1": norm_init(cfg.d_model, dt, device), "mixer": mixer}
    if spec.ffn != "none":
        p["norm2"] = norm_init(cfg.d_model, dt, device)
        if "moe" in spec.ffn:
            p["moe"] = moe_mod.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.num_experts, dt, device,
                                        cfg.ffn_kind)
        if spec.ffn in ("dense", "moe+dense"):
            p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.ffn_kind, dt, device)
    return p


def segment_init(gen, cfg: ArchConfig, seg, device):
    return [
        {f"l{i}": layer_init(gen, cfg, spec, device) for i, spec in enumerate(seg.pattern)}
        for _ in range(seg.repeats)
    ]


def layer_apply(p, x, spec: LayerSpec, cfg: ArchConfig, run: RunConfig, mode: str,
                cache=None, pos=None, true_len=None):
    """Returns (x, aux, new_cache): ``aux`` the MoE load-balancing loss
    (None for a layer without experts). ``cache`` is the cache length in prefill
    mode and the layer's cache dict in decode mode."""
    _check_spec(spec)
    common = dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads, head_dim=cfg.hd,
                  rope_theta=cfg.rope_theta, window=spec.window)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r} not in ('train', 'prefill', 'decode')")
    if spec.mixer != "attn":
        y, new_cache = _recurrent_apply(p["mixer"], h, spec, cfg, run, mode, cache)
    elif mode == "train":
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
    x = x + y
    aux = None
    if spec.ffn != "none":
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        y2 = None
        if "moe" in spec.ffn:
            y2, aux = moe_mod.moe_apply(
                p["moe"], h2, top_k=cfg.experts_per_token, ffn_kind=cfg.ffn_kind,
                capacity_factor=cfg.capacity_factor, dispatch=run.moe_dispatch,
                true_len=true_len)
        if spec.ffn in ("dense", "moe+dense"):
            yd = ffn_apply(p["ffn"], h2, cfg.ffn_kind)
            y2 = yd if y2 is None else y2 + yd
        x = x + y2
    return x, aux, new_cache


def _recurrent_apply(p, h, spec: LayerSpec, cfg: ArchConfig, run: RunConfig, mode: str,
                     cache):
    """A Mamba, mLSTM or sLSTM mixer: (y, state), the state None in train
    mode, the prefill's final state in prefill mode, the new state in
    decode mode."""
    if spec.mixer == "mamba":
        fwd, dec, kw, fkw = ssm.mamba_forward, ssm.mamba_decode, {}, {}
    elif spec.mixer == "mlstm":
        fwd, dec = ssm.mlstm_forward, ssm.mlstm_decode
        kw, fkw = {"n_heads": cfg.num_heads}, {"chunk": run.mlstm_chunk}
    else:
        fwd, dec = ssm.slstm_forward, ssm.slstm_decode
        kw, fkw = {"n_heads": cfg.num_heads}, {"unroll": run.slstm_unroll}
    if mode == "train":
        return fwd(p, h, **kw, **fkw), None
    if mode == "prefill":
        return fwd(p, h, return_state=True, **kw, **fkw)
    return dec(p, h, cache, **kw)


def _train_layer(block, x, spec: LayerSpec, cfg: ArchConfig, run: RunConfig):
    """One layer in train mode, (x, aux); under ``remat="full"`` a
    checkpointed one.

    The recompute runs inside the backward, which autograd may run on
    another thread; the layer enters the runtime active at the forward so
    the recompute resolves under the same scope."""
    if run.remat == "none":
        return layer_apply(block, x, spec, cfg, run, "train")[:2]
    rt = current_runtime()

    def fn(xx):
        with rt:
            return layer_apply(block, xx, spec, cfg, run, "train")[:2]

    return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)


def stack_apply(segments_params, x, cfg: ArchConfig, run: RunConfig, mode: str,
                caches=None, pos=None, cache_len=None, true_len=None, pending=None):
    """Apply all segments. Returns (x, aux, caches): ``aux`` the layers'
    MoE losses summed; prefill builds the caches in the JAX layout, decode
    updates ``caches`` in place and returns it, train returns None.

    Decode writes each attention layer's new key and value into the pool as
    the layer runs (a retry rewrites the same rows), and appends each
    recurrent layer's new state (one copy a layer, not a snapshot of the
    pool) to the caller's list ``pending``, for it to :func:`commit_states`
    once the rest of its step has run."""
    aux_total = None

    def add_aux(aux):
        nonlocal aux_total
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux

    def total():
        if aux_total is None:
            return torch.zeros((), dtype=torch.float32, device=x.device)
        return aux_total

    if mode == "train":
        for seg, blocks in zip(cfg.segments(), segments_params):
            for block in blocks:
                for i, spec in enumerate(seg.pattern):
                    x, aux = _train_layer(block[f"l{i}"], x, spec, cfg, run)
                    add_aux(aux)
        return x, total(), None
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
                x, aux, nc = layer_apply(block[name], x, spec, cfg, run, mode, c, pos,
                                         true_len=true_len)
                add_aux(aux)
                if mode == "decode" and spec.mixer != "attn":
                    pending.append((c, nc))
                if mode == "prefill":
                    per_layer[name].append(nc)
        if mode == "prefill":
            out_caches.append({
                name: {kk: torch.stack([c[kk] for c in cs]) for kk in cs[0]}
                for name, cs in per_layer.items()
            })
    return x, total(), (tuple(out_caches) if mode == "prefill" else caches)


def commit_states(pending) -> None:
    """Copy each held recurrent state (``stack_apply``'s ``pending``) into
    its slice of the pool. A decode step commits only after its last
    dispatch, so a step that raises part way leaves the pool as it was and
    a retry steps every state once."""
    for c, nc in pending:
        for kk, t in nc.items():
            c[kk].copy_(t)


def cache_shapes(cfg: ArchConfig, batch: int, cache_len: int):
    """Per segment ``{"l{i}": {leaf: (stacked shape, dtype)}}``: ``k`` and
    ``v`` in the model dtype for attention, ``h`` (fp32) and ``conv`` for
    Mamba, the fp32 state leaves for mLSTM and sLSTM."""
    out = []
    for seg in cfg.segments():
        sb = {}
        for i, spec in enumerate(seg.pattern):
            _check_spec(spec)
            if spec.mixer == "attn":
                shape = attn.attention_cache_shape(batch, cache_len, cfg.num_kv_heads, cfg.hd,
                                                   spec.window)
                leaves = {"k": (shape, cfg.tdtype), "v": (shape, cfg.tdtype)}
            elif spec.mixer == "mamba":
                leaves = ssm.mamba_state_shapes(batch, cfg.d_model, cfg.tdtype,
                                                expand=cfg.mamba_expand,
                                                d_state=cfg.mamba_d_state)
            elif spec.mixer == "mlstm":
                leaves = ssm.mlstm_state_shapes(batch, cfg.d_model, cfg.num_heads)
            else:
                leaves = ssm.slstm_state_shapes(batch, cfg.d_model)
            sb[f"l{i}"] = {kk: ((seg.repeats,) + shape, dt)
                           for kk, (shape, dt) in leaves.items()}
        out.append(sb)
    return tuple(out)

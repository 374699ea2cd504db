"""Tensor parallelism over the mesh's tensor axis: the collectives XLA's SPMD
partitioner inserts in JAX, written as explicit ``torch.distributed`` calls
with autograd.

A rank of a mesh whose tensor axis (``Layout.tensor_axis``, "model") holds
t > 1 ranks keeps, of each parameter that ``sharding.param_shardings``
shards over that axis, its contiguous 1/t slice (:func:`shard_params`).
The slice carries a tag, ``(dim, index, count)``: which dim of the global
tensor is cut, and which of the ``count`` pieces this is
(:func:`shard_info`). The layers read the tag, never a layer's name: a
dense weight cut on its output dim runs column-parallel, one cut on its
input dim row-parallel, a table cut on its vocabulary dim vocab-parallel.

The collectives run over the tensor axis's process group, which
:func:`model_axis` finds from the ambient ``sharding.mesh_context``
(``launch.mesh.axis_group``). Outside a mesh context, or with the axis at
one rank, every function here is the identity on its input. The autograd
functions, with Megatron-LM's names:

* :func:`copy_to_model`: identity forward, all-reduce backward. It goes on
  the replicated input of a column-parallel region: each rank's gradient of
  the input is the part its columns give.
* :func:`reduce_from_model`: all-reduce forward, identity backward, after a
  row-parallel projection (its partial sums) or the vocab-parallel lookup.
* :func:`gather_from_model`: all-gather along a dim forward, the rank's
  slice backward.
* :func:`scatter_to_model`: the rank's slice forward, all-gather backward.

A sum travels in fp32 and is rounded once to the tensor's dtype; a gather
carries floats as fp32 too (exact for bf16), so no backend needs bf16
support. gloo, which the ranks that share one card use, reduces a card's
tensor through pinned host memory, as ``collectives.reduce_grads`` does.
Every call adds its bytes to ``collectives.COLLECTIVE_BYTES`` under JAX's
HLO kind names (``all-reduce``, ``all-gather``) and its host seconds to
``collectives.COLLECTIVE_SECONDS``. Every rank must make the same calls in
the same order; a rank left waiting fails after the process group's
timeout.

:func:`vocab_parallel_embed` and :func:`vocab_parallel_xent` are the
embedding and the cross entropy over a vocabulary cut across ranks; the
cross entropy runs the ``softmax_xent`` and ``softmax_xent_bwd`` kernels on
the rank's columns. :func:`head_plan` says which attention heads a rank
computes.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from . import collectives
from . import sharding as shd

_TAG = "_repro_tp_shard"


# ---------------------------------------------------------------------------
# The rank's place on the tensor axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The tensor axis as this rank sees it: its process group (None for
    one rank), its size and this rank's coordinate on it."""

    group: Any = None
    size: int = 1
    index: int = 0


ONE_RANK = ModelAxis()


def model_axis() -> ModelAxis:
    """The ambient mesh context's tensor axis (one rank outside one)."""
    ctx = shd.current_mesh_layout()
    if ctx is None:
        return ONE_RANK
    mesh, layout = ctx
    if not hasattr(mesh, "mesh_dim_names"):
        return ONE_RANK
    from ..launch.mesh import axis_group, axis_index

    size = shd.mesh_axis_sizes(mesh).get(layout.tensor_axis, 1)
    if size <= 1:
        return ONE_RANK
    return ModelAxis(axis_group(mesh, layout.tensor_axis), size,
                     axis_index(mesh, layout.tensor_axis))


def tensor_size(mesh, layout) -> int:
    """Ranks on the layout's tensor axis of ``mesh`` (a mesh or a size map)."""
    return int(shd.mesh_axis_sizes(mesh).get(layout.tensor_axis, 1))


def check_supported(cfg, mesh, layout) -> None:
    """Raise ``NotImplementedError`` for what this port does not run on a
    mesh: FSDP over a data axis of more than one rank; and, on a tensor axis
    of more than one rank, an arch with experts, a recurrent mixer or a
    frontend, and a pod axis beside it."""
    sizes = shd.mesh_axis_sizes(mesh)
    d_size = math.prod(sizes.get(a, 1) for a in ("pod",) + tuple(layout.data_axes)
                       if a != layout.tensor_axis)
    if layout.fsdp and d_size > 1:
        raise NotImplementedError(
            f"{cfg.name}: FSDP (layout {layout.name!r} shards d_model over the data axes "
            f"of {sizes}) is a later slice of the port")
    if sizes.get(layout.tensor_axis, 1) <= 1:
        return
    what = []
    if cfg.num_experts:
        what.append("experts (expert parallelism is a later slice)")
    mixers = sorted({spec.mixer for seg in cfg.segments() for spec in seg.pattern} - {"attn"})
    if mixers:
        what.append(f"recurrent mixers {mixers}")
    if cfg.frontend is not None:
        what.append(f"the {cfg.frontend} frontend")
    if "pod" in sizes and sizes["pod"] > 1:
        what.append("a pod axis beside the tensor axis")
    if what:
        raise NotImplementedError(
            f"{cfg.name} on a tensor axis of {sizes[layout.tensor_axis]} ranks: "
            f"{'; '.join(what)} not ported; tensor parallelism runs dense attention archs")


# ---------------------------------------------------------------------------
# Parameter shards and their tags
# ---------------------------------------------------------------------------


def mark(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    """Tag ``t`` as piece ``index`` of ``count`` along ``dim`` of a global
    tensor; returns ``t``."""
    setattr(t, _TAG, (int(dim), int(index), int(count)))
    return t


def shard_info(t) -> Optional[Tuple[int, int, int]]:
    """``(dim, index, count)`` of a tagged shard, else None."""
    return getattr(t, _TAG, None)


def shard_dim(t) -> Optional[int]:
    """The dim of ``t`` cut over the tensor axis, or None (replicated)."""
    info = shard_info(t)
    return None if info is None else info[0]


def global_shape(t) -> Tuple[int, ...]:
    """The shape of the tensor ``t`` is a shard of (its own when untagged)."""
    shape = list(t.shape)
    info = shard_info(t)
    if info is not None:
        shape[info[0]] *= info[2]
    return tuple(shape)


def take_shard(full: torch.Tensor, info: Optional[Tuple[int, int, int]]) -> torch.Tensor:
    """The piece ``info`` (a tag) of the global tensor ``full``, as a view."""
    if info is None:
        return full
    dim, index, count = info
    n = full.shape[dim] // count
    return full.narrow(dim, index * n, n)


def _tensor_dim(spec, axis: str, sizes) -> Optional[int]:
    """The dim ``spec`` cuts over ``axis``; raise for a cut over another axis
    of more than one rank (FSDP, which this port does not run)."""
    found = None
    for i, part in enumerate(spec):
        names = part if isinstance(part, tuple) else (part,)
        for a in names:
            if a is None or sizes.get(a, 1) <= 1:
                continue
            if a != axis:
                raise NotImplementedError(f"spec {spec!r} cuts dim {i} over {a!r}: FSDP is a "
                                          "later slice of the port")
            found = i
    return found


def shard_params(params, specs, mesh, layout):
    """This rank's tree of ``params`` under the spec tree ``specs``
    (``sharding.param_shardings``'s, same structure): a leaf the spec cuts
    over the tensor axis becomes its tagged contiguous piece (a copy, so the
    global tensor can be freed); a leaf that is tagged already, or that the
    spec replicates, stays as it is."""
    sizes = shd.mesh_axis_sizes(mesh)
    t = sizes.get(layout.tensor_axis, 1)
    from ..launch.mesh import axis_index

    index = axis_index(mesh, layout.tensor_axis) if t > 1 else 0

    def one(leaf, spec):
        dim = _tensor_dim(spec, layout.tensor_axis, sizes)
        if dim is None or t <= 1 or shard_info(leaf) is not None:
            return leaf
        info = (dim, index, t)
        return mark(take_shard(leaf, info).clone(memory_format=torch.contiguous_format), *info)

    return _map2(one, params, specs)


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def gather_full(t: torch.Tensor, ax: Optional[ModelAxis] = None) -> torch.Tensor:
    """The global tensor of a tagged shard (a collective of the tensor
    axis: every rank calls it); an untagged tensor as it is."""
    info = shard_info(t)
    if info is None:
        return t
    ax = ax or model_axis()
    if ax.size != info[2]:
        raise RuntimeError(f"a shard of {info[2]} pieces on a tensor axis of {ax.size}")
    return _gather(t.detach(), info[0], ax)


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """A fresh fp32 (floats) copy of ``x`` on the device the group works on:
    pinned host memory for gloo with a card's tensor."""
    dev = collectives.comm_device(x.device, group)
    dt = torch.float32 if x.is_floating_point() else x.dtype
    buf = torch.empty(x.shape, dtype=dt, device=dev,
                      pin_memory=dev.type == "cpu" and x.is_cuda)
    return buf.copy_(x)


def _settle(x: torch.Tensor, group) -> None:
    """Wait for the card's work on ``x`` before a staged collective's clock
    starts (the staging copy would wait for it anyway), so the seconds are
    the collective's own."""
    if x.is_cuda and collectives.comm_device(x.device, group) != x.device:
        torch.cuda.synchronize(x.device)


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, in fp32, rounded once
    to ``x``'s dtype (a new tensor)."""
    _settle(x, group)
    t0 = time.perf_counter()
    buf = collectives.all_reduce(_wire(x, group), group=group)
    out = buf.to(device=x.device, dtype=x.dtype)
    collectives.COLLECTIVE_SECONDS["all-reduce"] += time.perf_counter() - t0
    return out


def _gather(x: torch.Tensor, dim: int, ax: ModelAxis) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    _settle(x, ax.group)
    t0 = time.perf_counter()
    dim = dim % x.dim()
    moved = x.movedim(dim, 0)
    out = collectives.all_gather(_wire(moved, ax.group), group=ax.group)    # [t, n, ...]
    out = out.reshape((-1,) + tuple(moved.shape[1:])).movedim(0, dim)
    out = out.to(device=x.device, dtype=x.dtype).contiguous()
    collectives.COLLECTIVE_SECONDS["all-gather"] += time.perf_counter() - t0
    return out


def _slice(x: torch.Tensor, dim: int, ax: ModelAxis) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * n, n).contiguous()


def stack_from_model(x: torch.Tensor, ax: Optional[ModelAxis] = None) -> torch.Tensor:
    """Every rank's ``x`` stacked along a new leading dim (no autograd)."""
    ax = ax or model_axis()
    if ax.size <= 1:
        return x[None]
    return _gather(x[None], 0, ax)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous(), ctx.ax.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _reduce(x, ax.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.ax), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _slice(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.dim, ctx.ax), None, None


def copy_to_model(x: torch.Tensor, ax: Optional[ModelAxis] = None) -> torch.Tensor:
    """Identity forward; the backward sums the ranks' gradients of ``x``."""
    ax = ax or model_axis()
    return x if ax.size <= 1 else _CopyToModel.apply(x, ax)


def reduce_from_model(x: torch.Tensor, ax: Optional[ModelAxis] = None) -> torch.Tensor:
    """The sum over the ranks of ``x`` (fp32, one rounding); identity backward."""
    ax = ax or model_axis()
    return x if ax.size <= 1 else _ReduceFromModel.apply(x, ax)


def gather_from_model(x: torch.Tensor, dim: int, ax: Optional[ModelAxis] = None
                      ) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``; the backward keeps the
    rank's slice of the gradient."""
    ax = ax or model_axis()
    return x if ax.size <= 1 else _GatherFromModel.apply(x, dim, ax)


def scatter_to_model(x: torch.Tensor, dim: int, ax: Optional[ModelAxis] = None
                     ) -> torch.Tensor:
    """The rank's slice of a replicated ``x`` along ``dim``; the backward
    gathers the gradient."""
    ax = ax or model_axis()
    return x if ax.size <= 1 else _ScatterToModel.apply(x, dim, ax)


# ---------------------------------------------------------------------------
# Vocab-parallel embedding and cross entropy
# ---------------------------------------------------------------------------


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor,
                         ax: Optional[ModelAxis] = None) -> torch.Tensor:
    """``table[tokens]`` for a table cut along its vocabulary rows: each rank
    looks up the tokens in its rows (``F.embedding`` on the shifted ids,
    clamped, so its fp32-summed backward stays), zeroes the rows of tokens
    outside them and the ranks sum. The sum adds one nonzero row to zeros,
    so it is exact."""
    ax = ax or model_axis()
    info = shard_info(table)
    vl = table.shape[0]
    lo = (info[1] if info is not None else ax.index) * vl
    ids = tokens - lo
    off = (ids < 0) | (ids >= vl)
    e = F.embedding(ids.clamp(0, vl - 1), table)
    e = torch.where(off[..., None], torch.zeros((), dtype=e.dtype, device=e.device), e)
    return reduce_from_model(e, ax)


def _xent_loss_plain(logits, labels):
    """The forward kernel's plain version, loss only (the reference a
    reference-mode dispatch runs on shifted labels)."""
    from ..kernels.xent import softmax_xent_plain

    return softmax_xent_plain(logits, labels)[0]


class _VocabXent(torch.autograd.Function):
    """Cross entropy over logits cut along the vocabulary (module docstring
    of :func:`vocab_parallel_xent`)."""

    @staticmethod
    def forward(ctx, logits, labels, ax, rt):
        from ..core.runtime import dispatch
        from ..kernels.xent import softmax_xent_plain  # noqa: F401  (registers the tunables)

        vl = logits.shape[1]
        local = labels.long() - ax.index * vl
        hit = (local >= 0) & (local < vl)
        # a label on another rank's columns is -1: off this row
        local = torch.where(hit, local, torch.full_like(local, -1)).contiguous()
        loss_r = dispatch("softmax_xent", logits, local, reference=_xent_loss_plain).float()
        x_lab = logits.gather(1, local.clamp_min(0)[:, None])[:, 0].float()
        x_lab = torch.where(hit, x_lab, torch.zeros_like(x_lab))
        # the kernel's loss is lse_r - x_lab (x_lab 0 off the row)
        lse = torch.logsumexp(stack_from_model(loss_r + x_lab, ax), dim=0)
        label_logit = _reduce(x_lab, ax.group)
        ctx.save_for_backward(logits, local, lse)
        ctx.rt = rt
        return lse - label_logit

    @staticmethod
    def backward(ctx, ct):
        from ..core.runtime import dispatch, dispatch_phase
        from ..kernels.xent import softmax_xent_bwd_plain

        logits, local, lse = ctx.saved_tensors
        with ctx.rt, dispatch_phase("bwd"):
            dl = dispatch("softmax_xent_bwd", ct.float().contiguous(), logits, local, lse,
                          reference=softmax_xent_bwd_plain)
        return dl.to(logits.dtype), None, None, None


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        ax: Optional[ModelAxis] = None) -> torch.Tensor:
    """Per-row fp32 cross entropy of logits ``[rows, V/t]``, this rank's
    columns, against global labels ``[rows]``; the same losses on every
    rank.

    Each rank runs ``softmax_xent`` on its columns with its labels shifted
    to them (a label on another rank's columns is off the row, whose label
    logit the kernel takes as 0), so the kernel's loss is ``lse_r - x_r``;
    the label logit ``x_r`` is read off the rank's own logits. The global
    lse is the fp32 logsumexp of the ranks' ``lse_r``, the label logit the
    sum of the ``x_r`` (one is nonzero), and the loss their difference. The
    backward runs ``softmax_xent_bwd`` on the rank's columns with the
    global lse: ``(exp(x - lse) - onehot) * ct`` on its columns, with no
    collective."""
    from ..core.runtime import current_runtime

    ax = ax or model_axis()
    if ax.size <= 1:
        from ..core.runtime import dispatch

        return dispatch("softmax_xent", logits, labels)
    return _VocabXent.apply(logits, labels, ax, current_runtime())


# ---------------------------------------------------------------------------
# Attention heads
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """Which heads a rank's attention computes.

    ``q_lo``/``q_n``: its query heads. ``q_gather``/``kv_gather``: the
    projection's columns split a head (a spec that is not head-aware), so
    its output is all-gathered (``sharding.constrain_heads``) before the head
    split. ``kv_local``: the rank's k/v projection holds whole heads, exactly
    the ones its queries read. Otherwise the rank has every kv head, and
    ``kv_pick`` names the ones its queries read (None: all of them);
    ``kv_n`` is how many heads its attention and its cache take.
    ``o_slice``: the attention output is whole but ``o`` is cut on its
    input, so the rank takes its slice of the output's columns."""

    q_lo: int
    q_n: int
    q_sharded: bool
    kv_sharded: bool
    q_gather: bool
    kv_gather: bool
    kv_local: bool
    kv_pick: Optional[Tuple[int, ...]]
    kv_n: int
    o_slice: bool


def head_plan(n_heads: int, n_kv: int, q_sharded: bool, kv_sharded: bool,
              size: int = 1, index: int = 0) -> HeadPlan:
    """The plan of rank ``index`` of ``size`` on the tensor axis, given
    whether its q and k/v projections are cut (their specs)."""
    if size <= 1 or not (q_sharded or kv_sharded):
        return HeadPlan(0, n_heads, False, False, False, False, False, None, n_kv, False)
    if kv_sharded and not q_sharded:
        raise NotImplementedError("k/v cut over the tensor axis with q replicated: no spec "
                                  "the solver gives")
    q_whole = q_sharded and n_heads % size == 0
    kv_whole = kv_sharded and n_kv % size == 0
    q_lo, q_n = (index * (n_heads // size), n_heads // size) if q_whole else (0, n_heads)
    group = n_heads // n_kv
    if kv_whole:
        want = (q_lo // group, (q_lo + q_n - 1) // group + 1)
        have = (index * (n_kv // size), (index + 1) * (n_kv // size))
        if want != have:
            raise NotImplementedError(f"query heads {q_lo}..{q_lo + q_n} read kv heads {want}, "
                                      f"the rank holds {have}")
        return HeadPlan(q_lo, q_n, q_sharded, kv_sharded, not q_whole, False, True, None,
                        n_kv // size, False)
    pick = None
    kv_n = n_kv
    if q_n < n_heads:
        need = [i // group for i in range(q_lo, q_lo + q_n)]
        uniq = sorted(set(need))
        per = [need.count(j) for j in uniq]
        if len(set(per)) == 1 and q_n % len(uniq) == 0:
            pick = tuple(uniq)          # each kv head serves consecutive query heads
        else:
            pick = tuple(need)          # one kv head a query head
        kv_n = len(pick)
    return HeadPlan(q_lo, q_n, q_sharded, kv_sharded, q_sharded and not q_whole,
                    kv_sharded, False, pick, kv_n, q_sharded and not q_whole)


def attention_plan(p, n_heads: int, n_kv: int, ax: Optional[ModelAxis] = None) -> HeadPlan:
    """:func:`head_plan` of an attention layer's parameters (their tags)."""
    q_sh, kv_sh = shard_dim(p["q"]["w"]) == 1, shard_dim(p["k"]["w"]) == 1
    if not (q_sh or kv_sh):
        return head_plan(n_heads, n_kv, False, False)
    info = shard_info(p["q"]["w"] if q_sh else p["k"]["w"])
    return head_plan(n_heads, n_kv, q_sh, kv_sh, info[2], info[1])


def spec_plan(cfg, mesh, layout, index: int = 0) -> HeadPlan:
    """:func:`head_plan` of ``cfg``'s attention under the solver's specs on
    ``mesh`` (a mesh or a size map), for rank ``index`` of the tensor axis."""
    sizes = shd.mesh_axis_sizes(mesh)
    t = sizes.get(layout.tensor_axis, 1)
    d, hd = cfg.d_model, cfg.hd
    cut = lambda name, n: shd.spec_for_dims(("d_model", name), (d, n * hd), sizes,
                                            layout) != shd.P()
    return head_plan(cfg.num_heads, cfg.num_kv_heads, cut("heads", cfg.num_heads),
                     cut("kv_heads", cfg.num_kv_heads), t, index)


def rank_widths(cfg, mesh, layout) -> dict:
    """The widths a rank's kernels see under the solver's specs: ``q``
    (q projection columns), ``kv`` (each of k and v), ``o`` (o's input
    rows), ``ff`` (gate/up columns and down rows), ``vocab`` (unembed
    columns, the cross entropy's row), ``heads`` and ``kv_heads`` (flash's);
    the global widths for one rank."""
    sizes = shd.mesh_axis_sizes(mesh)
    t = max(1, sizes.get(layout.tensor_axis, 1))
    d, hd = cfg.d_model, cfg.hd

    def local(dims, shape, dim):
        cut = shd.spec_for_dims(dims, shape, sizes, layout)
        return shape[dim] // t if len(cut) > dim and cut[dim] is not None else shape[dim]

    plan = spec_plan(cfg, mesh, layout)
    return {
        "q": local(("d_model", "heads"), (d, cfg.num_heads * hd), 1),
        "kv": local(("d_model", "kv_heads"), (d, cfg.num_kv_heads * hd), 1),
        "o": local(("heads", "d_model"), (cfg.num_heads * hd, d), 0),
        "ff": local(("d_model", "ff"), (d, cfg.d_ff), 1) if cfg.d_ff > 0 else 0,
        "vocab": local(("d_model", "vocab"), (d, cfg.vocab_size), 1),
        "heads": plan.q_n,
        "kv_heads": plan.kv_n,
    }

"""Gradient compression, the gradient all-reduce of data-parallel ranks, and
a ring all-reduce of our own schedule.

The port of ``repro.distributed.collectives``, over ``torch.distributed``:

* :func:`ef_init` and :func:`compress_grads` keep JAX's numerics: ``bf16``
  rounds each gradient to bfloat16 and back; ``int8_ef`` quantises each
  tensor symmetrically, ``scale = max(max|g + e|, 1e-12) / 127`` and
  ``clip(round((g + e) / scale), -127, 127)``, and carries the residual
  ``(g + e) - dequant`` as fp32 error feedback into the next step.
* :func:`reduce_grads` is the trainer's gradient all-reduce, the one XLA
  inserts in JAX: the fp32 gradients flattened into buckets of about
  ``bucket_bytes`` (gloo pays per call, and qwen2_0_5b has about 290
  leaves), one ``all_reduce`` a bucket (on the host for gloo), each leaf
  back in its own dtype.
* :func:`ring_all_reduce` is JAX's ring schedule over point-to-point hops
  (``batch_isend_irecv``): n - 1 reduce-scatter hops, then n - 1
  all-gather hops, each moving 1/n of the padded row.

Every collective adds the bytes it moved to a count by kind, with JAX's
HLO kind names (``all-reduce``: the reduced payload; ``all-gather``: the
gathered result; ``collective-permute``: each hop's chunk):
:func:`collective_counts`, which the cost model prices
(``core.evaluate.collective_stats``, ``tools.analytic.analytic_roofline``).
The tensor-parallel collectives (``distributed.tensor_parallel``) also add
their host seconds by kind (:func:`collective_seconds`).
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# Bytes and calls of every collective, by kind; reset by callers.
COLLECTIVE_BYTES: "collections.Counter[str]" = collections.Counter()
COLLECTIVE_CALLS: "collections.Counter[str]" = collections.Counter()
# Host seconds of the collectives that time themselves, by kind.
COLLECTIVE_SECONDS: "collections.Counter[str]" = collections.Counter()

# The trainer's gradient buckets: 256 MiB of fp32 each (10 calls for
# qwen2_0_5b's 2.52 GB of fp32 gradients).
BUCKET_BYTES = 256 * 2**20

MODES = ("none", "bf16", "int8_ef")


def collective_counts() -> Dict[str, Dict[str, int]]:
    """``{"bytes_by_kind": {...}, "calls_by_kind": {...}}`` since the last
    :func:`reset_collective_counts`."""
    return {"bytes_by_kind": dict(COLLECTIVE_BYTES), "calls_by_kind": dict(COLLECTIVE_CALLS)}


def collective_seconds() -> Dict[str, float]:
    """Host seconds by kind since the last :func:`reset_collective_counts`."""
    return dict(COLLECTIVE_SECONDS)


def reset_collective_counts() -> None:
    COLLECTIVE_BYTES.clear()
    COLLECTIVE_CALLS.clear()
    COLLECTIVE_SECONDS.clear()


def _count(kind: str, nbytes: int) -> None:
    COLLECTIVE_BYTES[kind] += int(nbytes)
    COLLECTIVE_CALLS[kind] += 1


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


# ---------------------------------------------------------------------------
# Gradient compression with error feedback
# ---------------------------------------------------------------------------


def ef_init(params) -> Any:
    """Zero error-feedback residuals shaped like ``params``, in fp32."""
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    return _quant_int8_at(x, scale), scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads, ef_state, mode: str = "none",
                   scale_groups: Optional[Sequence[Sequence[int]]] = None,
                   cut: Optional[Sequence[bool]] = None):
    """(compressed grads, new error-feedback state), JAX's numerics.
    ``grads`` is a tree (or a list) of tensors, ``ef_state`` the same tree
    from :func:`ef_init` for ``int8_ef`` and unused otherwise. ``bf16`` and
    ``int8_ef`` return fp32 gradients, as JAX's do.

    ``int8_ef``'s scale is a tensor's. JAX stacks a segment's repeated
    layers into one tensor a leaf, where the port keeps a leaf a layer:
    ``scale_groups`` (for a list of gradients) names the leaves that are one
    JAX tensor, which then share its scale (every leaf in exactly one
    group; the Trainer passes its stacked groups). ``cut`` flags the leaves
    that are a rank's pieces of a tensor cut over the tensor axis: their
    group's max is taken over the axis's ranks (a collective of the ambient
    mesh context), so the scale is the global tensor's."""
    if mode == "none":
        return grads, ef_state
    if mode == "bf16":
        return _tree_map(lambda g: g.to(torch.bfloat16).float(), grads), ef_state
    if mode != "int8_ef":
        raise ValueError(f"unknown compression mode {mode!r}")
    if scale_groups is None:
        return _int8_ef(grads, ef_state)
    out, new_ef = list(grads), list(ef_state)
    for group in scale_groups:
        g32 = {i: grads[i].float() + ef_state[i] for i in group}
        amax = torch.stack([g.abs().max() for g in g32.values()]).max()
        if cut is not None and any(cut[i] for i in group):
            amax = _max_over_tensor_axis(amax)
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        for i, g in g32.items():
            out[i] = _dequant_int8(_quant_int8_at(g, scale), scale)
            new_ef[i] = g - out[i]
    return out, new_ef


def _max_over_tensor_axis(x: torch.Tensor) -> torch.Tensor:
    """The max of a scalar over the ambient tensor axis's ranks."""
    from . import tensor_parallel as tp

    ax = tp.model_axis()
    if ax.size <= 1:
        return x
    buf = x.reshape(1).to(comm_device(x.device, ax.group))
    return all_reduce(buf, "max", group=ax.group).to(x.device)[0]


def _quant_int8_at(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _int8_ef(g, e):
    """(dequantised gradients, residuals) of a tree, a scale a leaf."""
    if isinstance(g, dict):
        pairs = {k: _int8_ef(g[k], e[k]) for k in g}
        return {k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()}
    if isinstance(g, (list, tuple)):
        pairs = [_int8_ef(a, b) for a, b in zip(g, e)]
        return type(g)(p[0] for p in pairs), type(g)(p[1] for p in pairs)
    g32 = g.float() + e
    q, s = _quant_int8(g32)
    deq = _dequant_int8(q, s)
    return deq, g32 - deq


# ---------------------------------------------------------------------------
# The trainer's all-reduce
# ---------------------------------------------------------------------------


def comm_device(like: torch.device, group=None) -> torch.device:
    """Where the group reduces a tensor that lives on ``like``: there for
    NCCL, which reduces nothing else; on the host for gloo, which would
    stage a card's tensor through host memory itself."""
    import torch.distributed as dist

    return like if dist.get_backend(group) == "nccl" else torch.device("cpu")


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` (``op`` sum, min or max), counted."""
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
    dist.all_reduce(t, op=ops[op], group=group)
    _count("all-reduce", t.numel() * t.element_size())
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's ``t`` stacked along a new leading dim in group-rank
    order (``all_gather_into_tensor``), counted by the gathered bytes."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out.view(-1), t.contiguous().view(-1), group=group)
    _count("all-gather", out.numel() * out.element_size())
    return out


@torch.no_grad()
def reduce_grads(grads: Sequence[torch.Tensor], group=None, scale: float = 1.0,
                 bucket_bytes: int = BUCKET_BYTES) -> List[torch.Tensor]:
    """The sum over the group's ranks of ``scale`` times each gradient, in
    place: the leaves go in order into fp32 buckets of at most
    ``bucket_bytes`` (a larger leaf makes a bucket of its own), each bucket
    is scaled and all-reduced in one call, and each sum is copied back into
    its leaf in the leaf's dtype. The trainer's scale is its rows' share of
    the global batch's loss tokens, so the sum is the global gradient."""
    grads = list(grads)
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if not bucket:
            return
        flat = torch.cat([g.reshape(-1).float() for g in bucket])
        if scale != 1.0:
            flat.mul_(scale)
        if comm_device(flat.device, group) != flat.device:
            # gloo with a card's tensors: through a pinned host buffer
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=flat.is_cuda)
            host.copy_(flat)
            all_reduce(host, group=group)
            flat.copy_(host)
        else:
            all_reduce(flat, group=group)
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        bucket, size = [], 0

    for g in grads:
        nbytes = 4 * g.numel()
        if bucket and size + nbytes > bucket_bytes:
            flush()
        bucket.append(g)
        size += nbytes
    flush()
    return grads


# ---------------------------------------------------------------------------
# Ring all-reduce (a collective schedule of our own)
# ---------------------------------------------------------------------------


@torch.no_grad()
def ring_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, on every rank, by JAX's
    ring schedule: ``x`` flattened and padded to a multiple of n, cut into
    n chunks; n - 1 reduce-scatter hops (at hop t rank r sends its chunk
    (r - t) mod n to rank r + 1 and adds the chunk it receives from r - 1
    into its chunk (r - t - 1) mod n), after which chunk (r + 1) mod n is
    fully reduced on rank r; then n - 1 all-gather hops passing the reduced
    chunks on. Each hop is one ``batch_isend_irecv`` of a send and a
    receive; each rank moves 2 (n - 1) / n of the row in all, the
    bandwidth-optimal ring. Returns a new tensor of ``x``'s shape and dtype."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    me = dist.get_rank(group)
    peer = (lambda r: r) if group is None else (lambda r: dist.get_global_rank(group, r))
    nxt, prv = peer((me + 1) % n), peer((me - 1) % n)
    flat = x.reshape(-1)
    d = flat.numel()
    chunks = F.pad(flat, (0, (-d) % n)).view(n, -1).clone()
    recv = torch.empty_like(chunks[0])

    def hop(send_idx: int) -> None:
        ops = [dist.P2POp(dist.isend, chunks[send_idx], nxt, group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        _count("collective-permute", recv.numel() * recv.element_size())

    for t in range(n - 1):
        hop((me - t) % n)
        chunks[(me - t - 1) % n] += recv
    for t in range(n - 1):
        hop((me + 1 - t) % n)
        chunks[(me - t) % n].copy_(recv)
    return chunks.reshape(-1)[:d].view_as(x)

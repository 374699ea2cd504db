"""Divisibility-aware sharding solver: logical axes -> mesh axes.

The port of ``repro.distributed.sharding``. Model code names every
parameter dim with a *logical* axis (``lm.param_axes``: "vocab", "ff",
"heads", ...); this module decides which *mesh* axis shards which dim under
a :class:`Layout`, greedily by rule priority with two hard checks: the dim
(and, head-aware, its unit count) must divide the mesh axis, and a mesh
axis shards at most one dim of a tensor.

A spec is a :class:`PartitionSpec`, a tuple of mesh axis names (or tuples
of them, or None) with trailing Nones trimmed, equal as a tuple to JAX's
``PartitionSpec`` for the same tensor. The solver reads a mesh's axis sizes
alone (:func:`mesh_axis_sizes`): a ``torch.distributed`` ``DeviceMesh``,
the host mesh of :func:`repro_torch.launch.mesh.make_host_mesh`, or a plain
``{axis: size}`` map, so the campaign planner solves for a mesh no process
group exists for.

What the port does with the specs: one process a rank. The Trainer runs
data parallelism over the data axes and tensor parallelism over the tensor
axis (``distributed.tensor_parallel``): a rank holds :func:`shard_of` of
every parameter whose spec cuts it over the tensor axis, and the layers run
column-parallel, row-parallel and vocab-parallel from those cuts. The
serving engine runs the tensor axis (a data axis of one rank). What still
raises ``NotImplementedError``: FSDP (a parameter cut over a data axis),
and on a tensor axis of more than one rank experts, recurrent mixers,
frontends and a pod axis (``tensor_parallel.check_supported``).
:func:`constrain` and :func:`constrain_heads` are where an activation's
layout is made what the spec says: a rank holding a shard of an activation
whose spec wants it replicated all-gathers it; where the two agree they do
nothing. :func:`cache_shardings` is JAX's and is kept as it is; the port's
cache follows the heads a rank computes instead (``tensor_parallel.
head_plan``), the same results in another layout.

Local-shape keys: in JAX, dispatch under ``jit`` sees global shapes and
:func:`localize_shapes` divides them by the ambient degree. A port rank's
tensors are its local shard already, so the port's runtime never calls it
(its ``dp_dims`` stays ignored); the campaign planner plans a rank's rows
with :func:`data_parallel_degree`, as JAX's planner does, and the tests
hold :func:`localize_shapes` to JAX's keys.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple


class PartitionSpec(tuple):
    """``PartitionSpec(*parts)``: one entry a tensor dim, a mesh axis name,
    a tuple of them or None (replicated), trailing Nones trimmed by the
    solver. ``PartitionSpec()`` is fully replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Layout:
    """One point in the distribution-layout search space (JAX's fields)."""

    tensor_axis: str = "model"
    data_axes: Tuple[str, ...] = ("data",)       # batch axes (pod prepended if present)
    fsdp: bool = False            # additionally shard params' d_model over data
    shard_experts: bool = True    # prefer expert-parallel over expert-ff TP
    scan_layers: bool = True      # informational (JAX scans; the port loops)
    # Logical-unit counts: ("heads", 24) means the "heads" dim is 24 units
    # (the fused dim is heads * head_dim): sharding must not split a unit,
    # so divisibility is checked against the count, not the dim size.
    counts: Tuple[Tuple[str, int], ...] = ()
    head_aware: bool = True       # False reproduces the naive baseline
    name: str = "default"

    def count_of(self, logical: str) -> Optional[int]:
        for k, v in self.counts:
            if k == logical:
                return v
        return None


# priority: lower = assigned first. Only these names are ever sharded.
_TENSOR_RULES: Dict[str, int] = {
    "vocab": 0,
    "experts": 1,
    "ff": 2,
    "ff2": 3,
    "heads": 4,
    "kv_heads": 5,
}
_FSDP_NAME = "d_model"


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, the host mesh or a size map."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"{type(mesh).__name__} is no mesh: it names no axes")
    return dict(zip(names, (int(d) for d in mesh.mesh.shape)))


def spec_for_dims(dims: Sequence[str], shape: Sequence[int], mesh,
                  layout: Layout) -> PartitionSpec:
    """PartitionSpec for one tensor given its logical dim names."""
    sizes = mesh_axis_sizes(mesh)
    t_axis = layout.tensor_axis
    t_size = sizes.get(t_axis, 1)
    d_axes = tuple(a for a in layout.data_axes if a in sizes)
    d_size = 1
    for a in d_axes:
        d_size *= sizes[a]

    assignment: Dict[int, Any] = {}

    def unit_ok(name: str, size: int) -> bool:
        if size % t_size:
            return False
        if layout.head_aware:
            c = layout.count_of(name)
            if c is not None and c % t_size:
                return False
        return True

    # 1. tensor-parallel dim: best-priority shardable logical name
    candidates = [
        (prio, i)
        for i, name in enumerate(dims)
        for prio in [_TENSOR_RULES.get(name)]
        if prio is not None and t_size > 1 and unit_ok(name, shape[i])
    ]
    if not layout.shard_experts:
        candidates = [(p, i) for (p, i) in candidates if dims[i] != "experts"]
    if candidates:
        _, idx = min(candidates)
        assignment[idx] = t_axis

    # 2. FSDP dim: shard d_model over the data axes
    if layout.fsdp and d_size > 1:
        for i, name in enumerate(dims):
            if i in assignment or name != _FSDP_NAME:
                continue
            if shape[i] % d_size == 0:
                assignment[i] = d_axes if len(d_axes) > 1 else d_axes[0]
                break

    if not assignment:
        return P()
    parts = [assignment.get(i) for i in range(len(dims))]
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def _is_names(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(s, str) for s in x)


def _map_axes(fn, axes, shapes):
    """``fn(dim names, leaf)`` over an axes tree and the tree of the same
    structure beside it (dicts, lists, tuples)."""
    if _is_names(axes):
        return fn(axes, shapes)
    if isinstance(axes, dict):
        return {k: _map_axes(fn, axes[k], shapes[k]) for k in axes}
    return type(axes)(_map_axes(fn, a, s) for a, s in zip(axes, shapes))


def param_shardings(axes_tree, shapes_tree, mesh, layout: Layout):
    """The spec tree of a params tree (``axes_tree`` from ``lm.param_axes``;
    ``shapes_tree`` any tree of leaves with a ``shape``)."""
    sizes = mesh_axis_sizes(mesh)
    return _map_axes(lambda ax, leaf: spec_for_dims(ax, tuple(leaf.shape), sizes, layout),
                     axes_tree, shapes_tree)


def _axes_of(part) -> Tuple[str, ...]:
    return tuple(a for a in (part if isinstance(part, tuple) else (part,)) if a is not None)


def shard_of(tensor, spec: PartitionSpec, sizes, coord: Mapping[str, int]):
    """This rank's shard of the global ``tensor`` under ``spec``: each dim
    the spec cuts over mesh axes is cut into the product of their sizes,
    and the rank keeps the piece its ``coord`` (``{axis: coordinate}``)
    names, the axes read as digits, the first the most significant (JAX's
    order). A contiguous copy, or ``tensor`` itself when the spec cuts
    nothing."""
    sizes = mesh_axis_sizes(sizes)
    out = tensor
    for dim, part in enumerate(spec):
        axes = [a for a in _axes_of(part) if sizes.get(a, 1) > 1]
        if not axes:
            continue
        count, index = 1, 0
        for a in axes:
            count *= sizes[a]
            index = index * sizes[a] + int(coord[a])
        if out.shape[dim] % count:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not split {count} ways")
        n = out.shape[dim] // count
        out = out.narrow(dim, index * n, n)
    return tensor if out is tensor else out.contiguous().clone()


def gather_full(tensor, ax=None):
    """The global tensor of this rank's tagged shard (the inverse of
    :func:`shard_of` over the tensor axis): an all-gather over it, so every
    rank of the axis calls it. An untagged tensor is returned as it is."""
    from . import tensor_parallel as tp

    return tp.gather_full(tensor, ax)


def spec_leaves(tree):
    """The specs of a spec tree, in tree order."""
    if isinstance(tree, PartitionSpec):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in tree for s in spec_leaves(tree[k])]
    return [s for v in tree for s in spec_leaves(v)]


def is_replicated(spec: PartitionSpec, mesh) -> bool:
    """Whether ``spec`` shards nothing: every axis it names has size 1."""
    sizes = mesh_axis_sizes(mesh)
    for part in spec:
        for a in (part if isinstance(part, tuple) else (part,)):
            if a is not None and sizes.get(a, 1) > 1:
                return False
    return True


# ---------------------------------------------------------------------------
# Activations / batches / caches
# ---------------------------------------------------------------------------


def _divisible_data_axes(sizes: Dict[str, int], layout: Layout,
                         batch_size: int) -> Tuple[Tuple[str, ...], int]:
    """Which of the data-parallel axes (pod first, then the layout's data
    axes) shard a dim of ``batch_size``, and their combined degree: the one
    rule behind :func:`batch_spec`, :func:`local_shard_shape` and the
    Trainer's rows of a rank, so campaign records match what ranks
    dispatch."""
    seen, use = set(), []
    prod = 1
    for a in ("pod",) + tuple(layout.data_axes):
        if a in seen or a not in sizes:
            continue
        seen.add(a)
        s = int(sizes[a])
        if s > 0 and batch_size % (prod * s) == 0:
            use.append(a)
            prod *= s
    return tuple(use), prod


def data_parallel_degree(sizes, layout: Layout, batch_size: int) -> int:
    """How many ways a batch-like dim of ``batch_size`` is split."""
    return _divisible_data_axes(mesh_axis_sizes(sizes), layout, batch_size)[1]


def local_shard_shape(shape: Sequence[int], sizes, layout: Layout) -> Tuple[int, ...]:
    """The per-rank shape of a batch-leading global array under ``layout``:
    the leading dim divided by its data-parallel degree (dims the mesh
    cannot divide stay global)."""
    shape = tuple(int(d) for d in shape)
    if not shape:
        return shape
    dp = data_parallel_degree(sizes, layout, shape[0])
    if dp <= 1:
        return shape
    return (shape[0] // dp,) + shape[1:]


def localize_shapes(shapes: Sequence[Sequence[int]],
                    batch_arg_indices: Optional[Sequence[int]] = None,
                    batch_arg_dims: Optional[Dict[int, int]] = None) -> Tuple[Tuple[int, ...], ...]:
    """Shapes divided by the ambient :func:`mesh_context`'s ``dp_degree``,
    as JAX's dispatch keys its global trace shapes: the leading dim of the
    ``batch_arg_indices`` shapes, or dim ``d`` of shape ``i`` for each
    ``{i: d}`` of ``batch_arg_dims`` (a backward's transposed operand), a
    dim the degree does not divide left global. The identity outside a
    context or with no degree. A port rank's tensors are local already, so
    its dispatch never calls this; the campaign planner and the tests do."""
    dp = _DP_CTX.get()
    if not dp or dp <= 1:
        return tuple(tuple(int(d) for d in s) for s in shapes)
    if batch_arg_dims is not None:
        dims = dict(batch_arg_dims)
    elif batch_arg_indices is not None:
        dims = {i: 0 for i in batch_arg_indices}
    else:
        dims = {i: 0 for i in range(len(shapes))}

    def one(i, s):
        s = tuple(int(d) for d in s)
        dim = dims.get(i)
        if dim is not None and len(s) > dim and s[dim] % dp == 0:
            return s[:dim] + (s[dim] // dp,) + s[dim + 1:]
        return s

    return tuple(one(i, s) for i, s in enumerate(shapes))


def batch_spec(mesh, layout: Layout, batch_size: int) -> PartitionSpec:
    """Shard the batch dim over every data-ish axis that divides it."""
    use, _ = _divisible_data_axes(mesh_axis_sizes(mesh), layout, batch_size)
    if not use:
        return P()
    return P(use if len(use) > 1 else use[0])


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def data_specs(batch_tree, mesh, layout: Layout):
    """Specs for a training or serving batch: dim 0 is the batch."""

    def one(leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return P()
        return batch_spec(mesh, layout, int(leaf.shape[0]))

    return _map_leaves(one, batch_tree)


def cache_shardings(cache_tree, mesh, layout: Layout):
    """Specs for decode caches, whose leaves are stacked (layers, batch,
    ...): dim 0 replicated; dim 1 over the data axes that divide it; the
    largest remaining dim the tensor axis divides gets it (kv heads where
    they divide, else the cache length or a feature dim); with the batch
    unsharded (B = 1), the leftover data axes go on the longest dim, which
    for a long-context cache is the sequence: sequence parallelism."""
    sizes = mesh_axis_sizes(mesh)
    t_axis = layout.tensor_axis
    t_size = sizes.get(t_axis, 1)
    d_axes = tuple(a for a in ("pod",) + tuple(layout.data_axes) if a in sizes)

    def one(leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) < 2:
            return P()
        shape = tuple(int(d) for d in leaf.shape)
        ndim = len(shape)
        parts: list = [None] * ndim
        bs = shape[1]
        use, prod, seen = [], 1, set()
        for a in d_axes:
            if a in seen:
                continue
            seen.add(a)
            s = sizes[a]
            if bs % (prod * s) == 0:
                use.append(a)
                prod *= s
        if use:
            parts[1] = tuple(use) if len(use) > 1 else use[0]
        leftover_data = [a for a in d_axes if a not in use]
        if t_size > 1:
            best = None
            for i in range(ndim - 1, 1, -1):
                if shape[i] % t_size == 0 and shape[i] >= t_size:
                    if best is None or shape[i] > shape[best]:
                        best = i
            if best is not None:
                parts[best] = t_axis
        if leftover_data and parts[1] is None and ndim >= 3:
            d_size = 1
            for a in leftover_data:
                d_size *= sizes[a]
            cand = [i for i in range(2, ndim)
                    if parts[i] is None and shape[i] % d_size == 0 and shape[i] >= d_size]
            if cand:
                i = max(cand, key=lambda j: shape[j])
                parts[i] = tuple(leftover_data) if len(leftover_data) > 1 else leftover_data[0]
        while parts and parts[-1] is None:
            parts.pop()
        return P(*parts)

    return _map_leaves(one, cache_tree)


# ---------------------------------------------------------------------------
# The ambient mesh and layout
# ---------------------------------------------------------------------------

_MESH_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh_layout",
                                                           default=None)
# The step's data-parallel degree, for local-shape keys (its own variable,
# so current_mesh_layout keeps its two-tuple)
_DP_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_dp_degree", default=None)
# Whether that degree is an approximation (JAX's microbatch degree differing
# from the full batch's)
_DP_APPROX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_dp_approx",
                                                           default=False)


@contextlib.contextmanager
def mesh_context(mesh, layout: Layout, dp_degree: Optional[int] = None,
                 dp_approx: bool = False):
    """The ambient mesh and layout scope, with JAX's fields: ``dp_degree``
    opts :func:`localize_shapes` into local shapes, ``dp_approx`` flags it
    as approximate. The port's Trainer enters it around every step."""
    tok = _MESH_CTX.set((mesh, layout))
    tok_dp = _DP_CTX.set(dp_degree)
    tok_ap = _DP_APPROX.set(bool(dp_approx))
    try:
        yield
    finally:
        _MESH_CTX.reset(tok)
        _DP_CTX.reset(tok_dp)
        _DP_APPROX.reset(tok_ap)


def current_mesh_layout():
    return _MESH_CTX.get()


def current_dp_degree() -> Optional[int]:
    return _DP_CTX.get()


def current_dp_approx() -> bool:
    return bool(_DP_APPROX.get())


def constrain(x, *dims, full_shape: Optional[Sequence[int]] = None):
    """JAX's sharding hint, given meaning on a rank's activation ``x``:
    ``dims`` names a mesh axis (or None) a dim, ``full_shape`` is the global
    shape (default ``x``'s: a replicated activation). A dim the rank holds a
    piece of (shorter than ``full_shape``) whose hint is not the tensor axis
    is all-gathered; a whole dim whose hint is the tensor axis is cut to the
    rank's piece; a dim whose layout agrees with its hint is left. The
    identity outside a mesh context or on a tensor axis of one rank."""
    from . import tensor_parallel as tp

    ctx = _MESH_CTX.get()
    ax = tp.model_axis()
    if ctx is None or ax.size <= 1:
        return x
    t_axis = ctx[1].tensor_axis
    full = tuple(full_shape) if full_shape is not None else tuple(x.shape)
    for i in range(x.dim()):
        want = i < len(dims) and dims[i] == t_axis
        cut = x.shape[i] < full[i]
        if cut and not want:
            x = tp.gather_from_model(x, i, ax)
        elif want and not cut and x.shape[i] % ax.size == 0:
            x = tp.scatter_to_model(x, i, ax)
    return x


def constrain_heads(x, n_units: int, unit_dim: int, full: Optional[int] = None):
    """JAX's head-aware hint around the head split and merge, on a rank's
    activation ``x`` whose dim ``unit_dim`` carries ``n_units`` heads of a
    global width ``full`` (default: ``x``'s, replicated). The hint keeps the
    dim cut over the tensor axis only when the cut falls between heads
    (``n_units`` divisible by its size); a rank holding a cut that splits a
    head gathers the whole dim (XLA's "involuntary full rematerialization":
    exact, not fast). The batch dim is the rank's already."""
    if full is None or x.shape[unit_dim] == full:
        return x
    from . import tensor_parallel as tp

    ax = tp.model_axis()
    if ax.size > 1 and n_units % ax.size == 0:
        return x
    return tp.gather_from_model(x, unit_dim, ax)

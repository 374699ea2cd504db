"""Launch models: the statically checkable half of a Hopper kernel.

The port of ``repro.core.gridmodel``. Every kernel tunable here is a family
of CUDA launches indexed by a config: the config picks tiles, ring depth and
splits, and the wrapper derives from them a route, a grid, the threads of a
block and its dynamic shared memory. Whether a config is *legal* on a card is
a function of exactly those derived numbers, not of the kernel body, so it is
decided without building or launching anything (Petrovič et al. 2019 filter
infeasible configs the same way, before measurement).

A kernel module registers a **build function**: a pure
``build(config, shapes=None, dtypes=None) -> LaunchModel | tuple | None``
that mirrors the wrapper's own arithmetic (the route rule, the tiles, the
split-k partition, the shared-memory functions that mirror the ``.cu``
sources), one model per CUDA kernel the call launches: the flash backward's
dq and dk/dv passes, split-k's partial and reduce kernels. ``None`` means the
wrapper itself would reject the shapes. ``shapes`` are the call's argument
shapes in the tunable's argument order and ``dtypes`` their dtype names (one
name stands for every argument); both default to the registered nominal ones.

The checks decide, per config and profile, in this order:

* **race** -- two blocks write the same output tile along a grid axis the
  model does not declare a reduction (split-k's splits and
  ``rmsnorm_bwd``'s dw partials are declared: a second kernel sums them in a
  fixed order). A kernel bug on every card: an error.
* **coverage** -- the blocks' tiles leave an output element unwritten, the
  CUDA counterpart of JAX's ``oob``: a ceil-div grid is where a CUDA kernel
  goes wrong. An error.
* **smem** -- the block's dynamic shared memory exceeds what the profile lets
  one block opt in to.
* **threads** -- a block's threads fall outside what the kernel (its launch
  bounds, its warp roles) or the profile allows, an accumulator exceeds the
  registers a thread may hold, or gridDim y or z exceeds 65,535.
* **tile** -- a tensor-core tile falls below the ``wgmma`` or WMMA minimum
  for its dtype (wgmma: 64 rows a warpgroup, columns a multiple of 8 up to
  256, k slices of 16 in bf16; WMMA: multiples of 16).

The last three depend on the card: such a config is *pruned*, not a bug.
``config_verdict`` / ``space_illegal`` / ``space_report`` are the low-level
API; ``ParamSpace.legal_configs(platform)``, the tuner's pre-pass, the
kernels' space constraints and shape checks (:class:`LaunchLimit`) and the
``repro_torch.analysis`` legality pass are the consumers. Each limit is
reckoned once, in the build function, from the functions the kernel modules mirror
from the ``.cu`` sources.

This module must not import ``params``: spaces link back to their kernels
through the ``_grid_kernels`` attribute :func:`register_launch_model` sets.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .platform import H100_SXM, PROFILES, HardwareProfile, detect_platform

GRID_YZ_MAX = 65535
ERROR_CATEGORIES = ("race", "coverage")
PRUNE_CATEGORIES = ("smem", "threads", "tile")
CATEGORIES = ERROR_CATEGORIES + PRUNE_CATEGORIES

# ---------------------------------------------------------------------------
# Model structures
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OutputModel:
    """One output a kernel writes: its extent, the tile a block writes and
    which tile (``index_map(*grid_coord)``, in tile units). ``index_map``
    None is a grid-stride loop: each block walks elements ``blockIdx, +
    gridDim, ...``, disjoint by construction and covering at any grid.
    ``reduce`` names the grid axes whose blocks write the same tile on
    purpose (partials a second kernel sums)."""

    name: str
    dims: Tuple[int, ...]
    tile: Tuple[int, ...] = ()
    index_map: Optional[Callable[..., Tuple[int, ...]]] = None
    reduce: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.index_map is not None and len(self.tile) != len(self.dims):
            raise ValueError(f"output {self.name!r}: tile rank {len(self.tile)} != "
                             f"dims rank {len(self.dims)}")


@dataclasses.dataclass(frozen=True)
class LaunchModel:
    """One CUDA launch: its logical grid (named axes; ``cuda_grid`` is the
    gridDim it packs them into), its block, and what it writes.

    ``mma`` is ``(kind, rows, cols, k)`` of the tensor-core tile a CTA computes
    (``"wgmma"``: rows a multiple of 64, one m64 a warpgroup; ``"wmma"``:
    multiples of 16), None off the tensor cores. ``flops`` (of the padded
    tiles), ``bytes`` (each input read once, each output written once) and
    ``workspace`` (fp32 partials written and read back) price the launch
    (:func:`repro_torch.core.evaluate.roofline_from_launch`); ``peak`` names
    the profile's rate they run at (``bf16`` tensor cores or ``fp32`` SIMT),
    and ``uniform`` says every block does the same work (so a partial last
    wave costs a whole one)."""

    kernel: str
    route: str
    grid: Tuple[int, ...]
    axes: Tuple[str, ...]
    cuda_grid: Tuple[int, int, int]
    threads: int
    smem: int = 0
    outputs: Tuple[OutputModel, ...] = ()
    dtype: str = "bfloat16"
    mma: Optional[Tuple[str, int, int, int]] = None
    max_threads: Optional[int] = None     # the kernel's own cap (launch bounds, warp roles)
    min_threads: int = 32
    acc_regs: int = 0                     # fp32 accumulator registers a thread
    max_acc_regs: int = 255
    flops: float = 0.0
    bytes: float = 0.0
    workspace: float = 0.0
    peak: str = "fp32"
    uniform: bool = False
    template: Tuple = ()                  # compile-time knobs the grid does not show
    where: str = ""                       # the shape, for messages ("at d=256")

    def __post_init__(self):
        if len(self.grid) != len(self.axes):
            raise ValueError(f"{self.kernel}: grid rank {len(self.grid)} != "
                             f"axes rank {len(self.axes)}")

    @property
    def blocks(self) -> int:
        return math.prod(self.cuda_grid)

    def signature(self) -> Tuple:
        """Hashable identity of the realized launch: configs with equal
        signatures launch indistinguishable kernels at these shapes (the
        redundancy ``space_report`` counts)."""
        return (self.kernel, self.route, self.cuda_grid, self.threads, self.smem,
                tuple((o.name, o.tile) for o in self.outputs), self.mma, self.template)


# ---------------------------------------------------------------------------
# Registry of build functions
# ---------------------------------------------------------------------------

BuildFn = Callable[..., Union[LaunchModel, Tuple[LaunchModel, ...], None]]


@dataclasses.dataclass(frozen=True)
class LaunchEntry:
    kernel: str
    build: BuildFn
    space: Any = None                 # the ParamSpace the kernel tunes over
    nominal: Tuple[Tuple[int, ...], ...] = ()
    dtypes: Tuple[str, ...] = ()      # the nominal shapes' dtypes


_MODELS: Dict[str, LaunchEntry] = {}
# Bumped by every registration: the memos of LaunchLimit are keyed on it.
_generation = 0


def register_launch_model(kernel: str, build: BuildFn, space: Any = None,
                          nominal: Sequence[Tuple[int, ...]] = (),
                          dtypes: Union[str, Sequence[str]] = "bfloat16") -> None:
    """Declare the launch models of a kernel tunable, with the nominal
    shapes and dtypes its space is judged at. Links the kernel onto
    ``space._grid_kernels``, so a space several kernels tune over keeps a
    config only where every one of them can launch it."""
    global _generation
    nominal = tuple(tuple(s) for s in nominal)
    dts = (dtypes,) * len(nominal) if isinstance(dtypes, str) else tuple(dtypes)
    _MODELS[kernel] = LaunchEntry(kernel, build, space, nominal, dts)
    _verdicts.cache_clear()
    _generation += 1
    if space is not None:
        kernels = getattr(space, "_grid_kernels", None)
        if kernels is None:
            kernels = []
            space._grid_kernels = kernels
        if kernel not in kernels:
            kernels.append(kernel)


def registered_models() -> Dict[str, LaunchEntry]:
    return dict(_MODELS)


def _dtypes_for(entry: LaunchEntry, shapes, dtypes) -> Tuple[str, ...]:
    n = len(shapes)
    if dtypes is None:
        return entry.dtypes if len(entry.dtypes) == n else ("bfloat16",) * n
    if not isinstance(dtypes, (tuple, list)):
        return (_dtype_str(dtypes),) * n
    return tuple(_dtype_str(d) for d in dtypes)


def build_models(kernel: str, config: Dict[str, Any],
                 shapes: Optional[Sequence[Tuple[int, ...]]] = None,
                 dtypes: Union[str, Sequence[str], None] = None,
                 call_kwargs: Optional[Dict[str, Any]] = None
                 ) -> Optional[Tuple[LaunchModel, ...]]:
    """Every launch the kernel makes for this config at these shapes (None:
    the wrapper would reject the shapes or the config outright).
    ``call_kwargs`` are the call's own (``causal``, ``window``, ``act``)."""
    entry = _MODELS.get(kernel)
    if entry is None:
        return None
    shapes = entry.nominal if shapes is None else tuple(tuple(int(d) for d in s)
                                                        for s in shapes)
    try:
        out = entry.build(dict(config), shapes, _dtypes_for(entry, shapes, dtypes),
                          **(call_kwargs or {}))
    except (KeyError, ValueError, IndexError, TypeError, ZeroDivisionError):
        return None
    if out is None:
        return None
    return out if isinstance(out, tuple) else (out,)


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

def _grid_points(model: LaunchModel, fixed: Dict[int, int]):
    """Coordinate arrays over the logical grid, axes in ``fixed`` held."""
    ranges = [np.array([fixed[a]]) if a in fixed else np.arange(g)
              for a, g in enumerate(model.grid)]
    mesh = np.meshgrid(*ranges, indexing="ij")
    return [m.reshape(-1) for m in mesh]


def _tile_indices(out: OutputModel, coords) -> np.ndarray:
    idx = out.index_map(*coords)
    cols = [np.broadcast_to(np.asarray(i, dtype=np.int64), coords[0].shape) for i in idx]
    return np.stack(cols, axis=1) if cols else np.zeros((coords[0].shape[0], 0), np.int64)


def _along(model: LaunchModel, out: OutputModel, axis: int) -> List[Tuple[int, ...]]:
    """The tiles written by the blocks along one grid axis, the others at 0."""
    base = [0] * len(model.grid)
    tiles = []
    for v in range(model.grid[axis]):
        base[axis] = v
        tiles.append(tuple(int(i) for i in out.index_map(*base)))
    return tiles


def _axis_dims(model: LaunchModel, out: OutputModel):
    """Per grid axis, the tiles along it and the output dims it moves."""
    rows = [_along(model, out, a) for a in range(len(model.grid))]
    moved = [tuple(d for d in range(len(r[0])) if len({t[d] for t in r}) > 1) if r else ()
             for r in rows]
    return rows, moved


def check_races(model: LaunchModel) -> Optional[str]:
    """Two blocks that differ along a grid axis not declared a reduction and
    write the same tile of one output: a write-write race. The shipped index
    maps are separable (each output dim follows one grid axis), so each axis
    is walked alone: it races if it moves no dim, or moves its dims to one
    tile twice. Where two axes move one dim, the grid is enumerated exactly,
    the declared reductions held at 0."""
    for out in model.outputs:
        if out.index_map is None:
            continue
        red = {model.axes.index(a) for a in out.reduce if a in model.axes}
        rows, moved = _axis_dims(model, out)
        live = [a for a, g in enumerate(model.grid) if a not in red and g > 1]
        owners = collections.Counter(d for a in live for d in moved[a])
        if all(n == 1 for n in owners.values()):
            for a in live:
                if not moved[a]:
                    return (f"{model.kernel}: the {model.grid[a]} blocks along grid axis "
                            f"{model.axes[a]!r} all write one tile of {out.name!r}, and the "
                            f"axis is not a declared reduction ({out.reduce or 'none'})")
                tiles = {tuple(t[d] for d in moved[a]) for t in rows[a]}
                if len(tiles) < len(rows[a]):
                    return (f"{model.kernel}: two blocks along grid axis {model.axes[a]!r} "
                            f"write one tile of {out.name!r}, not a declared reduction")
            continue
        coords = _grid_points(model, {a: 0 for a in red})
        tiles = _tile_indices(out, coords)
        uniq, counts = np.unique(tiles, axis=0, return_counts=True)
        if len(uniq) < len(tiles):
            dup = uniq[np.argmax(counts)]
            at = [tuple(int(c[i]) for c in coords) for i in
                  np.nonzero((tiles == dup).all(axis=1))[0][:2]]
            return (f"{model.kernel}: blocks {at[0]} and {at[1]} both write tile "
                    f"{tuple(int(v) for v in dup)} of {out.name!r} and no grid axis "
                    f"between them is a declared reduction ({out.reduce or 'none'})")
    return None


def check_coverage(model: LaunchModel) -> Optional[str]:
    """Every element of every output lies in some block's tile: along each
    output dim the blocks' tile indices must be exactly 0 .. ceil(dim /
    tile) - 1 (none missing, none past the end); the dims follow their grid
    axes independently, so the written tiles are the product of those
    sets."""
    for out in model.outputs:
        if out.index_map is None:
            if model.blocks < 1:
                return f"{model.kernel}: an empty grid writes nothing of {out.name!r}"
            continue
        if any(t <= 0 for t in out.tile):
            return f"{model.kernel}: output {out.name!r} has an empty tile {out.tile}"
        need = tuple(-(-d // t) for d, t in zip(out.dims, out.tile))
        rows, moved = _axis_dims(model, out)
        owners = collections.Counter(d for m in moved for d in m)
        if any(n > 1 for n in owners.values()):
            # two axes move one dim: the written tiles, exactly
            rows = [[tuple(int(v) for v in t)
                     for t in _tile_indices(out, _grid_points(model, {}))]]
        for d, n in enumerate(need):
            got = {t[d] for r in rows for t in r}
            if min(got) < 0 or max(got) >= n:
                return (f"{model.kernel}: {out.name!r} tile index {max(got)} on dim {d} "
                        f"lies past its {out.dims[d]} elements ({n} tiles of {out.tile[d]})")
            if len(got) < n:
                missing = sorted(set(range(n)) - got)[:3]
                return (f"{model.kernel}: the grid {model.grid} never writes tiles {missing} "
                        f"of {out.name!r} on dim {d} ({out.dims[d]} elements, tiles of "
                        f"{out.tile[d]}): elements stay unwritten")
    return None


def check_smem(model: LaunchModel, profile: HardwareProfile) -> Optional[str]:
    if model.smem > profile.smem_per_block:
        at = f" {model.where}" if model.where else ""
        return (f"{model.kernel} ({model.route}): {model.smem} B of shared memory{at} a block, "
                f"over the {profile.smem_per_block} B one block may use on {profile.name}")
    return None


def check_threads(model: LaunchModel, profile: HardwareProfile) -> Optional[str]:
    cap = min(profile.max_threads_per_block, model.max_threads or profile.max_threads_per_block)
    if not model.min_threads <= model.threads <= cap:
        return (f"{model.kernel} ({model.route}): {model.threads} threads a block, outside "
                f"{model.min_threads} .. {cap}")
    if model.acc_regs > model.max_acc_regs:
        return (f"{model.kernel} ({model.route}): {model.acc_regs} fp32 accumulator registers "
                f"a thread, over {model.max_acc_regs}")
    if model.cuda_grid[1] > GRID_YZ_MAX or model.cuda_grid[2] > GRID_YZ_MAX:
        return (f"{model.kernel} ({model.route}): gridDim {model.cuda_grid} past "
                f"{GRID_YZ_MAX} in y or z")
    return None


def check_tile(model: LaunchModel) -> Optional[str]:
    if model.mma is None:
        return None
    kind, rows, cols, k = model.mma
    if kind == "wgmma":
        ok = rows % 64 == 0 and cols % 8 == 0 and 8 <= cols <= 256 and k % 16 == 0
        want = "rows a multiple of 64, columns a multiple of 8 in 8 .. 256, k of 16"
    elif kind == "wmma":
        ok = rows % 16 == 0 and cols % 16 == 0 and k % 16 == 0
        want = "multiples of 16"
    else:
        return f"{model.kernel}: unknown tensor-core instruction {kind!r}"
    if not (ok and rows > 0 and cols > 0 and k > 0):
        return (f"{model.kernel} ({model.route}): {kind} tile {rows} x {cols} x {k} below the "
                f"minimum for {model.dtype} ({want})")
    return None


def _structure_key(model: LaunchModel):
    """What the race and coverage checks read: the grid and each output's
    extent, tile, reductions and index map (its code and closure)."""
    def fn_key(f):
        if f is None:
            return None
        cells = tuple(c.cell_contents for c in (f.__closure__ or ()))
        return (f.__code__, cells)
    return (model.kernel, model.grid, model.axes,
            tuple((o.name, o.dims, o.tile, o.reduce, fn_key(o.index_map))
                  for o in model.outputs))


_STRUCTURE: Dict[Any, List[Tuple[str, str]]] = {}


def _structural(model: LaunchModel) -> List[Tuple[str, str]]:
    """Race and coverage verdicts, shared by every profile and by the configs
    whose launches have one structure."""
    try:
        key = _structure_key(model)
        hash(key)
    except (TypeError, ValueError):
        key = None
    if key is not None and key in _STRUCTURE:
        return _STRUCTURE[key]
    out = []
    for cat, fn in (("race", check_races), ("coverage", check_coverage)):
        reason = fn(model)
        if reason:
            out.append((cat, reason))
    if key is not None:
        if len(_STRUCTURE) > 65536:
            _STRUCTURE.clear()
        _STRUCTURE[key] = out
    return out


def check_model(model: LaunchModel, profile: HardwareProfile) -> List[Tuple[str, str]]:
    """Every failed check as (category, reason), in severity order: race and
    coverage are kernel bugs on any card; smem, threads and tile prune."""
    out = list(_structural(model))
    for cat, fn in (("smem", lambda: check_smem(model, profile)),
                    ("threads", lambda: check_threads(model, profile)),
                    ("tile", lambda: check_tile(model))):
        reason = fn()
        if reason:
            out.append((cat, reason))
    return out


# ---------------------------------------------------------------------------
# Config- and space-level verdicts
# ---------------------------------------------------------------------------


def resolve_profile(platform: Union[str, HardwareProfile, None]) -> HardwareProfile:
    """A profile, a platform key (``h100-sxm``, ``h100-pcie``, ``torch-cpu``,
    or the detected card's key), or None for the detected device."""
    if platform is None:
        return detect_platform()
    if isinstance(platform, HardwareProfile):
        return platform
    if platform in PROFILES:
        return PROFILES[platform]
    here = detect_platform()
    if here.name == platform:
        return here
    raise KeyError(f"unknown platform {platform!r} (known: {sorted(PROFILES)})")


def _dtype_str(d) -> str:
    """``bfloat16`` for ``torch.bfloat16`` or ``"bfloat16"``."""
    return str(d).replace("torch.", "")


def _freeze(config: Dict[str, Any]) -> Tuple:
    return tuple(sorted(config.items()))


@functools.lru_cache(maxsize=65536)
def _verdicts(kernel: str, frozen: Tuple, profile: HardwareProfile,
              shapes: Optional[Tuple], dtypes) -> Tuple[Tuple[str, str], ...]:
    models = build_models(kernel, dict(frozen), shapes, dtypes)
    if models is None:
        return (("build", f"{kernel}: the wrapper rejects {dict(frozen)} at these shapes"),)
    out = []
    for m in models:
        out.extend(check_model(m, profile))
    return tuple(out)


def config_verdicts(kernel: str, config: Dict[str, Any],
                    platform: Union[str, HardwareProfile, None] = None,
                    shapes: Optional[Sequence[Tuple[int, ...]]] = None,
                    dtypes: Union[str, Sequence[str], None] = None
                    ) -> Tuple[Tuple[str, str], ...]:
    """Every (category, reason) the kernel's launches fail for ``config``."""
    if kernel not in _MODELS:
        return ()
    shp = None if shapes is None else tuple(tuple(int(d) for d in s) for s in shapes)
    dts = dtypes if dtypes is None else (_dtype_str(dtypes) if not isinstance(
        dtypes, (tuple, list)) else tuple(_dtype_str(d) for d in dtypes))
    return _verdicts(kernel, _freeze(config), resolve_profile(platform), shp, dts)


def config_verdict(kernel: str, config: Dict[str, Any],
                   platform: Union[str, HardwareProfile, None] = None,
                   shapes: Optional[Sequence[Tuple[int, ...]]] = None,
                   dtypes: Union[str, Sequence[str], None] = None
                   ) -> Optional[Tuple[str, str]]:
    """None if the config is legal for ``kernel`` on ``platform`` (at
    ``shapes``, or the nominal ones), else the first (category, reason):
    'build' | 'race' | 'coverage' | 'smem' | 'threads' | 'tile'."""
    found = config_verdicts(kernel, config, platform, shapes, dtypes)
    return found[0] if found else None


def _product(space) -> Iterator[Dict[str, Any]]:
    """Every knob combination whose constraints, other than the launch
    limits the models decide, hold (the launch limits are what the
    verdicts report)."""
    other = [c for c in space.constraints if not isinstance(c.fn, LaunchLimit)]
    for combo in itertools.product(*(p.choices for p in space.params)):
        cfg = dict(zip(space.names, combo))
        if all(c(cfg) for c in other):
            yield cfg


def space_illegal(kernel: str, platform: Union[str, HardwareProfile, None] = None,
                  shapes: Optional[Sequence[Tuple[int, ...]]] = None,
                  dtypes: Union[str, Sequence[str], None] = None
                  ) -> Dict[str, Tuple[str, str]]:
    """config_key -> (category, reason) over the kernel's whole space."""
    entry = _MODELS.get(kernel)
    if entry is None or entry.space is None:
        return {}
    out: Dict[str, Tuple[str, str]] = {}
    for cfg in _product(entry.space):
        verdict = config_verdict(kernel, cfg, platform, shapes, dtypes)
        if verdict:
            out[entry.space.config_key(cfg)] = verdict
    return out


def space_report(kernel: str, platform: Union[str, HardwareProfile, None] = None,
                 shapes: Optional[Sequence[Tuple[int, ...]]] = None,
                 dtypes: Union[str, Sequence[str], None] = None) -> Dict[str, Any]:
    """Counts the legality pass and ``campaign status`` report per kernel:
    total / legal / illegal by category / redundant (legal configs whose
    launches are identical to another legal config's at these shapes)."""
    entry = _MODELS.get(kernel)
    profile = resolve_profile(platform)
    report: Dict[str, Any] = {"kernel": kernel, "platform": profile.name, "total": 0,
                              "legal": 0, "illegal": 0, "by_category": {}, "redundant": 0,
                              "reasons": []}
    if entry is None or entry.space is None:
        return report
    signatures = set()
    for cfg in _product(entry.space):
        report["total"] += 1
        verdict = config_verdict(kernel, cfg, profile, shapes, dtypes)
        if verdict:
            cat, reason = verdict
            report["illegal"] += 1
            report["by_category"][cat] = report["by_category"].get(cat, 0) + 1
            if len(report["reasons"]) < 8:
                report["reasons"].append(f"{cat}: {reason}")
            continue
        report["legal"] += 1
        models = build_models(kernel, cfg, shapes, dtypes)
        sig = tuple(m.signature() for m in models)
        if sig in signatures:
            report["redundant"] += 1
        signatures.add(sig)
    return report


class LaunchLimit:
    """A space constraint that is a call into the launch models: the config
    must launch on ``profile`` at the kernels' nominal shapes with no
    verdict in ``categories``. The kernel modules' spaces hold their limits
    this way, so each limit lives in one place. The answer is memoised per
    config (``space.is_valid`` runs on the dispatch path); a kernel with no
    launch model registered, once the kernel modules are imported, raises
    ``KeyError`` rather than passing every config."""

    def __init__(self, kernels: Union[str, Sequence[str]], categories: Sequence[str],
                 profile: HardwareProfile = H100_SXM):
        self.kernels = (kernels,) if isinstance(kernels, str) else tuple(kernels)
        self.categories = tuple(categories)
        self.profile = profile
        self._memo: Dict[Tuple, bool] = {}
        self._memo_generation = -1

    def __call__(self, config: Dict[str, Any]) -> bool:
        if self._memo_generation != _generation:
            self._require_models()
            self._memo = {}
            self._memo_generation = _generation
        key = tuple(config.items())       # configs of one space share their key order
        ok = self._memo.get(key)
        if ok is None:
            ok = not any(cat in self.categories
                         for k in self.kernels
                         for cat, _ in config_verdicts(k, config, self.profile))
            self._memo[key] = ok
        return ok

    def _require_models(self) -> None:
        if any(k not in _MODELS for k in self.kernels):
            from .. import kernels  # noqa: F401  (each kernel module registers its models)
        missing = [k for k in self.kernels if k not in _MODELS]
        if missing:
            raise KeyError(f"no launch model registered for {missing}")


def shape_illegal(kernel: str, config: Dict[str, Any], shapes, dtypes,
                  profile: Union[str, HardwareProfile, None] = H100_SXM) -> Optional[str]:
    """Why the kernel cannot launch ``config`` at this call's shapes on
    ``profile`` (a platform-dependent verdict), or None: the body of a
    tunable's ``legal`` check."""
    for cat, reason in config_verdicts(kernel, config, profile, shapes, dtypes):
        if cat in PRUNE_CATEGORIES:
            return f"{cat}: {reason}"
    return None

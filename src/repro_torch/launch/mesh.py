"""Meshes over ranks, and the ranks' process group.

The port of ``repro.launch.mesh``. A mesh names its axes as JAX's do,
``("data", "model")`` or ``("pod", "data", "model")``, one rank a device:

* :func:`make_mesh_from_spec` builds a ``torch.distributed`` ``DeviceMesh``
  from a ``"DATAxMODEL"`` spec over the initialised process group, and
  raises when the world size is not the mesh's;
* :func:`make_host_mesh` is the 1 x 1 mesh of one process, a
  :class:`HostMesh` that needs no process group, so one-device training
  and every test that does not spawn ranks run with no distributed init;
* :func:`make_production_mesh` keeps JAX's shapes (16 x 16, or 2 x 16 x 16
  with ``multi_pod``) and raises with fewer ranks.

:func:`rank_env` reads a rank's place from the ``torchrun`` environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and :func:`init_ranks` joins the
process group: through ``torchrun``'s rendezvous (``env://``), or through
a ``FileStore`` at ``store``, with a timeout either way.
:func:`spawn_ranks` starts the ranks of one command on this host with
that environment, as ``torchrun`` does, and waits for them with a
deadline: the tests and ``chip_smoke.py`` start their ranks with it and
meet at a ``FileStore``.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def parse_mesh_spec(spec: str):
    """"DATAxMODEL" (or "PODxDATAxMODEL") -> (shape tuple, axis names).

    The notation of the launcher's ``--mesh`` and the campaign planner's
    ``--train-mesh``: "2x4" is a (data=2, model=4) mesh, "2x16x16" prepends
    a pod axis.
    """
    try:
        dims = tuple(int(d) for d in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh spec {spec!r}: expected e.g. '2x4' or '2x16x16'")
    if len(dims) == 2:
        return dims, ("data", "model")
    if len(dims) == 3:
        return dims, ("pod", "data", "model")
    raise ValueError(f"mesh spec {spec!r}: expected 2 or 3 dims, got {len(dims)}")


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The 1 x 1 mesh of one process: ``DeviceMesh``'s ``mesh_dim_names``,
    ``mesh``, ``size()`` and ``get_coordinate()``, and no process group."""

    mesh_dim_names: Tuple[str, ...] = ("data", "model")

    @property
    def mesh(self) -> torch.Tensor:
        return torch.zeros((1,) * len(self.mesh_dim_names), dtype=torch.int64)

    def size(self) -> int:
        return 1

    def get_coordinate(self):
        return [0] * len(self.mesh_dim_names)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 for an axis the mesh lacks)."""
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.get_coordinate()[names.index(axis)]) if axis in names else 0


def axis_group(mesh, axis: str):
    """The process group of ``axis`` (the ranks whose coordinates differ on
    it alone), or ``None`` where it holds one rank: an axis of size 1, an
    axis the mesh lacks, or the host mesh."""
    names = tuple(getattr(mesh, "mesh_dim_names", ()) or ())
    if isinstance(mesh, HostMesh) or axis not in names:
        return None
    if int(mesh.mesh.shape[names.index(axis)]) <= 1:
        return None
    return mesh.get_group(axis)


def make_host_mesh() -> HostMesh:
    """The degenerate 1 x 1 mesh for one process (CPU tests, one card)."""
    return HostMesh()


def _device_mesh(shape, axes):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"mesh {shape} needs an initialised process group of {n} ranks "
                           "(init_ranks, or torchrun)")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, the process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_mesh_from_spec(spec: str):
    """A ``DeviceMesh`` from a "DATAxMODEL" spec over the process group."""
    shape, axes = parse_mesh_spec(spec)
    return _device_mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False):
    """JAX's production shapes: 16 x 16 ("data", "model"), or 2 x 16 x 16
    with a "pod" axis first."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes)


@dataclasses.dataclass(frozen=True)
class RankEnv:
    rank: int = 0
    world_size: int = 1
    local_rank: int = 0


def rank_env() -> RankEnv:
    """This process's rank, world size and local rank, from the
    ``torchrun`` environment (one process when it is not set)."""
    return RankEnv(int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1)),
                   int(os.environ.get("LOCAL_RANK", 0)))


def init_ranks(backend: str, store: Optional[str] = None, timeout_s: float = 600.0,
               env: Optional[RankEnv] = None) -> RankEnv:
    """Join the process group of :func:`rank_env`'s ranks on ``backend``
    (``nccl`` or ``gloo``: the caller names it, nothing switches on its
    own): at the ``FileStore`` file ``store``, else through ``env://``
    (``MASTER_ADDR`` and ``MASTER_PORT``, which ``torchrun`` sets). Every
    collective then fails after ``timeout_s`` rather than hang."""
    import torch.distributed as dist

    env = env or rank_env()
    timeout = datetime.timedelta(seconds=timeout_s)
    if store is not None:
        dist.init_process_group(backend, store=dist.FileStore(store, env.world_size),
                                rank=env.rank, world_size=env.world_size, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", rank=env.rank,
                                world_size=env.world_size, timeout=timeout)
    return env


@dataclasses.dataclass(frozen=True)
class RankResult:
    rank: int
    returncode: Optional[int]     # None: killed at the deadline
    log: str                      # its stdout and stderr


def spawn_ranks(argv: Sequence[str], world: int, log_dir: str, timeout_s: float,
                env: Optional[Dict[str, str]] = None) -> List[RankResult]:
    """Run ``argv`` as ``world`` ranks on this host (``RANK``, ``WORLD_SIZE``
    and ``LOCAL_RANK`` set as ``torchrun`` sets them, plus ``env``), each
    rank's output in ``log_dir/rank{r}.log``. Returns when every rank has
    exited; when one fails, or the deadline ``timeout_s`` passes, the
    others are killed (a rank left waiting in a collective would wait for
    the process group's timeout). No process outlives the call."""
    os.makedirs(log_dir, exist_ok=True)
    procs, logs = [], []
    try:
        for r in range(world):
            path = os.path.join(log_dir, f"rank{r}.log")
            logs.append(path)
            renv = dict(os.environ, **(env or {}), RANK=str(r), WORLD_SIZE=str(world),
                        LOCAL_RANK=str(r))
            with open(path, "w") as out:
                procs.append(subprocess.Popen(list(argv), env=renv, stdout=out,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    out = []
    for r, (p, path) in enumerate(zip(procs, logs)):
        with open(path) as f:
            out.append(RankResult(r, p.returncode if p.returncode is not None and
                                  p.returncode >= 0 else None, f.read()))
    return out

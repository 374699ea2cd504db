"""Atomic, async checkpoints of the trainer's state, restorable on any device.

The port of ``repro.train.checkpoint`` with the same layout on disk::

    <dir>/step_000123/
        manifest.json       # per leaf: path, file, shape, dtype, stored_dtype, crc32
        leaf_00000.npy ...  # one file per leaf, in the tree's leaf order
        _COMMITTED          # written LAST; restore ignores dirs without it

A tree is nested dicts (keys sorted, ``jax.tree_util``'s order), lists and
tuples of tensors, numpy arrays and Python ints (stored as 0-d int32, as the
JAX trainer stores its step counters). Leaf paths are spelled as JAX's key
paths (``['opt']/['m']/[3]``), so both packages write equal manifests and
equal ``.npy`` bytes for one tree. bfloat16 has no numpy dtype: it is
stored as its ``uint16`` bits (``Tensor.view(torch.int16)``) and the
manifest keeps ``dtype: bfloat16``, which is what the JAX package writes
through ``ml_dtypes``.

* atomic: the step directory is staged as ``.tmp-*`` and renamed only
  after ``_COMMITTED`` is fsync'd, so a crash mid-save never corrupts the
  latest checkpoint.
* async: :meth:`Checkpointer.save_async` copies every leaf to the host
  before it returns (synchronised with the device: the trainer updates its
  parameters and optimizer state in place, so a writer that read device
  tensors while the next step ran would write a torn checkpoint whose
  crc32 still matched), then writes the files on a background thread. A
  failed write re-raises from :meth:`~Checkpointer.wait` (which every save
  calls first) and never commits.
* any device: :meth:`~Checkpointer.restore` returns a new tree with every
  tensor leaf on the target leaf's device, or on ``device=``: the
  one-device counterpart of the JAX package's ``shardings=``. A checkpoint
  written from the card restores on the CPU, and the reverse.
* integrity: each leaf's shape, dtype and crc32 are checked on restore.

One difference on purpose: the directory is created at the first save, not
at construction, so a trainer that never reaches ``checkpoint_every``
leaves nothing on disk.

Each write is the fault site ``checkpoint.write:<step>`` (it runs on the
writer thread for an async save: install the plan with ``plan.install()``).
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import tempfile
import threading
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..testing.faults import fault_point as _fault_point

log = logging.getLogger("repro_torch.checkpoint")

_COMMIT_MARK = "_COMMITTED"
_STEP_RE = re.compile(r"^step_(\d{9})$")

# dtypes numpy cannot hold: stored as the same-width integer bits
_BITS = {torch.bfloat16: (torch.int16, np.uint16)}
_FROM_BITS = {"bfloat16": torch.bfloat16}


def flatten_with_paths(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(JAX key path, leaf) in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in flatten_with_paths(tree[k], path + (f"['{k}']",))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in flatten_with_paths(v, path + (f"[{i}]",))]
    return [("/".join(path), tree)]


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's bytes (``zlib.crc32(arr.tobytes())``, no copy)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)) & 0xFFFFFFFF


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(the array as stored, its logical dtype): an owned host copy."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in _BITS:
            bits, np_bits = _BITS[t.dtype]
            name = str(t.dtype).replace("torch.", "")
            return t.view(bits).to("cpu", copy=True).numpy().view(np_bits), name
        arr = t.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype)
    if isinstance(leaf, bool) or not isinstance(leaf, (int, np.integer, np.ndarray)):
        raise TypeError(f"checkpoint leaf of type {type(leaf).__name__}")
    arr = np.array(leaf, dtype=np.int32 if isinstance(leaf, (int, np.integer)) else None)
    if isinstance(leaf, (int, np.integer)) and int(arr) != int(leaf):
        raise OverflowError(f"int leaf {leaf} does not fit int32")
    return arr, str(arr.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        # The writer thread's failure, re-raised from wait() on the training
        # thread: a failed async write is never taken for a recovery point.
        self._error: Optional[BaseException] = None
        self._err_lock = threading.Lock()

    # -- save -----------------------------------------------------------------
    def host_copy(self, tree: Any) -> List[Tuple[str, np.ndarray, str]]:
        """(path, stored array, logical dtype) of every leaf, copied to the
        host and synchronised: what :meth:`save` and :meth:`save_async`
        write."""
        return [(p, *_host(leaf)) for p, leaf in flatten_with_paths(tree)]

    def save(self, step: int, tree: Any) -> str:
        """Blocking save. Returns the committed directory."""
        self.wait()
        return self._write(step, self.host_copy(tree))

    def save_async(self, step: int, tree: Any) -> None:
        """The device-to-host copy now, finished before this returns; the
        disk write on a background thread."""
        self.wait()
        host = self.host_copy(tree)

        def work():
            try:
                self._write(step, host)
            except BaseException as e:  # surfaced on the next wait()/save*
                with self._err_lock:
                    self._error = e
                log.warning("async checkpoint write for step %d failed: %s: %s "
                            "(will re-raise on the training thread)",
                            step, type(e).__name__, e)

        self._thread = threading.Thread(target=work, name="repro_torch-ckpt", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        with self._err_lock:
            e, self._error = self._error, None
        if e is not None:
            raise RuntimeError(f"async checkpoint failed: {e}") from e

    def _write(self, step: int, host) -> str:
        _fault_point(f"checkpoint.write:{step}", step=step)
        os.makedirs(self.directory, exist_ok=True)
        final = os.path.join(self.directory, f"step_{step:09d}")
        stage = tempfile.mkdtemp(prefix=".tmp-", dir=self.directory)
        try:
            manifest = {"step": step, "leaves": []}
            for i, (p, stored, dtype) in enumerate(host):
                fname = f"leaf_{i:05d}.npy"
                np.save(os.path.join(stage, fname), stored)
                manifest["leaves"].append({
                    "path": p, "file": fname, "shape": list(stored.shape), "dtype": dtype,
                    "stored_dtype": str(stored.dtype),
                    "crc32": _crc32(stored)})
            manifest["treedef"] = None
            with open(os.path.join(stage, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(stage, _COMMIT_MARK), "w") as f:
                f.write("ok")
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(stage, final)
        except BaseException:
            shutil.rmtree(stage, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)
        # stale staging dirs of crashed saves
        for name in os.listdir(self.directory):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name, _COMMIT_MARK)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, step: int, target_tree: Any) -> List[Tuple[str, np.ndarray, str]]:
        """The checked host arrays of a committed step, in ``target_tree``'s
        leaf order: (path, stored array, logical dtype)."""
        d = os.path.join(self.directory, f"step_{step:09d}")
        if not os.path.exists(os.path.join(d, _COMMIT_MARK)):
            raise FileNotFoundError(f"no committed checkpoint at {d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = flatten_with_paths(target_tree)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        paths = [p for p, _ in flat]
        if set(paths) != set(by_path):
            missing, extra = set(paths) - set(by_path), set(by_path) - set(paths)
            raise ValueError(f"checkpoint/target tree mismatch: missing={sorted(missing)[:5]} "
                             f"extra={sorted(extra)[:5]}")
        out = []
        for p, tgt in flat:
            e = by_path[p]
            arr = np.load(os.path.join(d, e["file"]))
            stored = e.get("stored_dtype", e["dtype"])
            if str(arr.dtype) != stored or list(arr.shape) != e["shape"]:
                raise ValueError(f"manifest mismatch for {p}")
            if stored == e["dtype"] and str(arr.dtype) != e["dtype"]:
                raise ValueError(f"manifest mismatch for {p}")
            if _crc32(arr) != e["crc32"]:
                raise ValueError(f"crc mismatch for {p}: corrupt checkpoint")
            if isinstance(tgt, (torch.Tensor, np.ndarray)) and tuple(tgt.shape) != arr.shape:
                raise ValueError(f"shape mismatch for {p}: ckpt {arr.shape} vs target "
                                 f"{tuple(tgt.shape)}")
            out.append((p, arr, e["dtype"]))
        return out

    def restore(self, step: int, target_tree: Any, device=None) -> Any:
        """A new tree of ``target_tree``'s structure holding step ``step``:
        tensor leaves on the target leaf's device (every one on ``device``
        when it is given), int leaves as Python ints, array leaves as
        numpy arrays."""
        host = self.load(step, target_tree)
        leaves = []
        for (p, arr, dtype), (_, tgt) in zip(host, flatten_with_paths(target_tree)):
            if isinstance(tgt, torch.Tensor):
                if dtype in _FROM_BITS:
                    t = torch.from_numpy(arr.view(np.int16)).view(_FROM_BITS[dtype])
                else:
                    t = torch.from_numpy(arr)
                if t.dtype != tgt.dtype:
                    raise ValueError(f"dtype mismatch for {p}: ckpt {t.dtype} vs target "
                                     f"{tgt.dtype}")
                leaves.append(t.to(tgt.device if device is None else torch.device(device)))
            elif isinstance(tgt, (int, np.integer)) and not isinstance(tgt, bool):
                leaves.append(int(arr))
            else:
                leaves.append(arr)
        return _rebuild(target_tree, iter(leaves))

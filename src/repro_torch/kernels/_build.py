"""Build the CUDA sources under ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags (so an edited source rebuilds and an unchanged one is
reused). :func:`build_all` starts one ``nvcc`` per source at once. The
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
each library.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises :class:`CudaError`, which carries the CUDA code, when
that is not 0, since a refused launch never runs and a later synchronise
would not report it. The tuner tells a refused launch (a config the card
cannot run) from a fault by that code.

``LAUNCHES`` counts kernel launches by kernel name: each wrapper adds one
where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo") + ARCH_FLAGS

LAUNCHES: "collections.Counter[str]" = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def ptxas_report(name: str) -> str:
    p = lib_path(name).with_suffix(".ptxas.txt")
    return p.read_text() if p.exists() else ""


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library is built; returns
    (process, tmp path, final path) or None."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    try:
        log, _ = proc.communicate()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    out.with_suffix(".ptxas.txt").write_text(log)
    os.replace(tmp, out)          # atomic: a concurrent build sees all or nothing


def build_all(names: Sequence[str]) -> None:
    """Build every named source, one nvcc each, all started together."""
    with _lock:
        started = {}
        try:
            for n in names:
                s = _start(n)
                if s is not None:
                    started[n] = s
        finally:
            for n, s in started.items():
                _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


_entries: Dict[str, ctypes._CFuncPtr] = {}


def entry(name: str, symbol: str, argtypes) -> "ctypes._CFuncPtr":
    """The C function ``symbol`` of csrc/<name>.cu, typed: int return,
    ``argtypes`` (c_void_p for every pointer and the stream, or ctypes
    would pass a 64-bit pointer as a 32-bit int)."""
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype, fn.argtypes = ctypes.c_int, list(argtypes)
        _entries[symbol] = fn
    return fn


class CudaError(RuntimeError):
    """A C entry point returned CUDA error ``code``."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def check(name: str, err: int, what: str) -> None:
    """Raise :class:`CudaError` when a C entry point of csrc/<name>.cu
    returned a CUDA error."""
    if err != 0:
        fn = load(name).repro_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise CudaError(err, f"{what}: CUDA error {err} ({fn(err).decode()})")


# PyTorch's accessor of the current stream's raw handle (a CUDA build has
# it; it skips building a Stream object on every launch).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``: kernels launch there."""
    if _raw_stream is not None and device.index is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream

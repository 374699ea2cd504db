"""Build the CUDA sources under ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags (so an edited source rebuilds and an unchanged one is
reused). :func:`build_all` starts one ``nvcc`` per source at once. The
three gemm libraries that instantiate every operand layout (``SPLIT``)
compile each layout's tensor-core kernels and each A granule's fp32
register-tile kernels, most of their compile time, in translation units of
their own (``csrc/gemm_part.cu`` with ``GEMM_PARTS``' defines), started
with the rest and linked into the library. The
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
each library.

A kernel that cannot exist on this host raises :class:`KernelUnavailable`:
nvcc missing or failing, a library that does not load, or a wrapper given
a tensor on a device with no kernel. The dispatch guard re-raises it rather
than serving the reference in its place.

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
# The libraries compiled in parts, and each part's defines: an operand
# layout's tensor-core kernels, an A granule's register-tile kernels.
SPLIT = ("matmul", "matmul_bias_act", "expert_gemm")
GEMM_PARTS = tuple((f"-DGEMM_TC_TA={a}", f"-DGEMM_TC_TB={b}") for a in (0, 1) for b in (0, 1)) \
    + tuple((f"-DGEMM_SIMT_EA={ea}",) for ea in (0, 1, 2, 4))

LAUNCHES: "collections.Counter[str]" = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelUnavailable(RuntimeError):
    """No kernel exists for this call on this host: the toolkit is missing,
    the build failed, the library did not load, or the tensors lie on a
    device the wrapper has no kernel for. Not a fault of one variant, so the
    dispatch guard never absorbs it."""


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
    raise KernelUnavailable("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    sources = sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]
    if name in SPLIT:
        h.update(f"parts {GEMM_PARTS}".encode())
        sources.append(CSRC / "gemm_part.cu")
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def ptxas_report(name: str) -> str:
    p = lib_path(name).with_suffix(".ptxas.txt")
    return p.read_text() if p.exists() else ""


def _popen(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _start(name: str):
    """Start nvcc for csrc/<name>.cu (and its parts, each an object)
    unless its library is built; returns (processes, objects, tmp path,
    final path) or None."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    src = str(CSRC / f"{name}.cu")
    if name not in SPLIT:
        return [_popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), src])], [], tmp, out
    flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c", "-DGEMM_SPLIT"]
    jobs = [(src, [])] + [(str(CSRC / "gemm_part.cu"), list(d)) for d in GEMM_PARTS]
    objs = [tmp.with_name(f"{tmp.name}.{i}.o") for i in range(len(jobs))]
    procs = [_popen([_nvcc(), *flags, *extra, "-o", str(obj), cu])
             for (cu, extra), obj in zip(jobs, objs)]
    return procs, objs, tmp, out


def _wait(proc) -> str:
    try:
        log, _ = proc.communicate()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return log


def _finish(name: str, started) -> None:
    procs, objs, tmp, out = started
    logs = [_wait(p) for p in procs]
    try:
        failed = [log for p, log in zip(procs, logs) if p.returncode != 0]
        if not failed and objs:
            link = _popen([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)])
            logs.append(_wait(link))
            if link.returncode != 0:
                failed = logs[-1:]
    finally:
        for obj in objs:
            if obj.exists():
                obj.unlink()
    if failed:
        if tmp.exists():
            tmp.unlink()
        raise KernelUnavailable(f"nvcc failed for {name}.cu:\n{failed[0]}")
    out.with_suffix(".ptxas.txt").write_text("".join(logs))
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
                try:
                    lib = ctypes.CDLL(str(lib_path(name)))
                except OSError as e:
                    raise KernelUnavailable(f"lib{name} did not load: {e}") from e
                _libs[name] = lib
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

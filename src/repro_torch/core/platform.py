"""Hardware profiles for the port, platform keys, and the device rule.

Tuning records are keyed by platform, so every device the port runs on gets
its own database namespace. A CUDA card is fingerprinted from
``torch.cuda.get_device_properties``: SM count, shared memory per block and
per SM, and L2 size come from the CUDA runtime; the peaks come from the table
below. The CPU path is ``torch-cpu``, distinct from the JAX package's
``cpu-host``, so the two packages never share records.

Peaks (dense, no sparsity): H100 SXM 989 TFLOP/s bf16 and 3.35 TB/s HBM3
(NVIDIA data sheet); H100 PCIe 756 TFLOP/s bf16 and 2.0 TB/s HBM2e (NVIDIA
data sheet). A card set below its full power limit runs below these.
Interconnect (``interconnect_bandwidth``, the cost model's collective
rate): the data sheet's NVLink figure, 900 GB/s for the SXM part and
600 GB/s for the PCIe part's NVLink bridge (each the data sheet's total of
both directions), never a measurement.

:func:`resolve_device` is the rule every entry point follows: the port runs
on ``cuda`` unless the caller asks for ``cpu``, and a host with no card
raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Union

import torch


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str                      # platform key for the tuning database
    peak_flops_bf16: float         # FLOP/s, dense tensor cores
    peak_flops_fp32: float         # FLOP/s outside the tensor cores
    hbm_bandwidth: float           # bytes/s
    hbm_bytes: int
    sm_count: int
    smem_per_block: int            # bytes a block may opt in to
    smem_per_sm: int
    l2_bytes: int
    max_threads_per_block: int = 1024
    interconnect_bandwidth: float = 900e9   # bytes/s between cards (data sheet)


H100_SXM = HardwareProfile(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_flops_fp32=67e12,
    hbm_bandwidth=3.35e12,
    hbm_bytes=80 * 10**9,
    sm_count=132,
    smem_per_block=232_448,        # 227 KB
    smem_per_sm=233_472,           # 228 KB of the SM's 256 KB (shared with L1)
    l2_bytes=50 * 1024**2,
)

H100_PCIE = dataclasses.replace(
    H100_SXM,
    name="h100-pcie",
    peak_flops_bf16=756e12,
    peak_flops_fp32=51e12,
    hbm_bandwidth=2.0e12,
    sm_count=114,
    interconnect_bandwidth=600e9,
)

# The CPU path exists for tests and small runs; its peaks only matter for
# rough roofline arithmetic and are never reported as a device number.
TORCH_CPU = HardwareProfile(
    name="torch-cpu",
    peak_flops_bf16=100e9,
    peak_flops_fp32=100e9,
    hbm_bandwidth=20e9,
    hbm_bytes=32 * 1024**3,
    sm_count=1,
    smem_per_block=232_448,
    smem_per_sm=233_472,
    l2_bytes=32 * 1024**2,
    interconnect_bandwidth=10e9,
)

PROFILES = {p.name: p for p in (H100_SXM, H100_PCIE, TORCH_CPU)}


def _cuda_profile(index: int) -> HardwareProfile:
    props = torch.cuda.get_device_properties(index)
    name = props.name
    if "H100" in name:
        base = H100_PCIE if "PCIE" in name.upper() else H100_SXM
        key = base.name
    else:
        # An unknown card keeps its own namespace; H100 peaks stand in for
        # roofline arithmetic until it has a row in the table.
        base = H100_SXM
        key = "cuda-" + re.sub(r"[^a-z0-9]+", "-", name.lower()).strip("-")
    return dataclasses.replace(
        base,
        name=key,
        sm_count=props.multi_processor_count,
        smem_per_block=getattr(props, "shared_memory_per_block_optin", base.smem_per_block),
        smem_per_sm=getattr(props, "shared_memory_per_multiprocessor", base.smem_per_sm),
        l2_bytes=getattr(props, "L2_cache_size", base.l2_bytes),
        hbm_bytes=props.total_memory,
    )


_cuda_profiles = {}


def detect_platform(device: Union[str, torch.device, None] = None) -> HardwareProfile:
    """The profile of ``device`` (default: the first card, else the CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cpu":
        return TORCH_CPU
    if device.type != "cuda":
        raise ValueError(f"no hardware profile for device type {device.type!r}")
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _cuda_profiles:
        _cuda_profiles[index] = _cuda_profile(index)
    return _cuda_profiles[index]


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``cpu`` is asked for.

    Raises on a host with no card when the caller did not ask for the CPU:
    the port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def platform_key(device: Optional[torch.device]) -> str:
    return detect_platform(device).name

"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Importing this package registers the tunables (``matmul``, ``rmsnorm``,
``flash_attention``) and builds nothing: a kernel's CUDA library is built
at its first launch (see :mod:`._build`).
"""
from . import attention, matmul, rmsnorm  # noqa: F401
from ._build import launch_counts, reset_launch_counts  # noqa: F401

# Each ported kernel: its CUDA source and the TPU kernel it replaces.
KERNEL_SOURCES = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:25"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:25"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/attention.py:33"),
}

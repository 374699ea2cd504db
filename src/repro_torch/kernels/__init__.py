"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Importing this package registers the tunables (``matmul``, ``rmsnorm``,
``rmsnorm_bwd``, ``softmax_xent``, ``softmax_xent_bwd``, ``flash_attention``,
``flash_attention_bwd``) and builds nothing: a kernel's CUDA library is
built at its first launch (see :mod:`._build`).
"""
from . import attention, matmul, rmsnorm, xent  # noqa: F401
from ._build import launch_counts, reset_launch_counts  # noqa: F401

# Each ported kernel: its CUDA source and the TPU kernel it replaces.
KERNEL_SOURCES = {
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:25"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:25"),
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                    "src/repro/kernels/rmsnorm.py:153"),
    "softmax_xent": ("src/repro_torch/kernels/csrc/xent.cu",
                     "src/repro/kernels/xent.py:29"),
    "softmax_xent_bwd": ("src/repro_torch/kernels/csrc/xent.cu",
                         "src/repro/kernels/xent.py:192"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/attention.py:33"),
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/attention.py:269"),
}

# The CUDA sources, one shared library each (built in parallel).
LIBRARIES = ("matmul", "rmsnorm", "rmsnorm_bwd", "xent", "flash_attention",
             "flash_attention_bwd")

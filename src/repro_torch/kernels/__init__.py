"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Importing this package registers the tunables (``matmul``, ``rmsnorm``,
``rmsnorm_bwd``, ``softmax_xent``, ``softmax_xent_bwd``, ``flash_attention``,
``flash_attention_bwd``, ``matmul_bias_act``, ``rmsnorm_matmul``,
``ssm_scan``, ``ssm_update``, ``expert_gemm``, and the SSM backwards
``ssm_scan_bwd`` and ``ssm_update_bwd``, which are torch code, not kernels)
and builds nothing: a kernel's CUDA library is built at its first launch
(see :mod:`._build`).
"""
from . import attention, fused, matmul, moe_gemm, rmsnorm, ssm_scan, xent  # noqa: F401
from ._build import KernelUnavailable, launch_counts, reset_launch_counts  # noqa: F401

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
    "matmul_bias_act": ("src/repro_torch/kernels/csrc/matmul_bias_act.cu",
                        "src/repro/kernels/fused.py:57"),
    "rmsnorm_matmul": ("src/repro_torch/kernels/csrc/rmsnorm_matmul.cu",
                       "src/repro/kernels/fused.py:220"),
    "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:94"),
    "ssm_update": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                   "src/repro/kernels/ssm_scan.py:300"),
    "expert_gemm": ("src/repro_torch/kernels/csrc/expert_gemm.cu",
                    "src/repro/kernels/moe_gemm.py:35"),
}

# The CUDA sources, one shared library each (built in parallel).
LIBRARIES = ("matmul", "rmsnorm", "rmsnorm_bwd", "xent", "flash_attention",
             "flash_attention_bwd", "matmul_bias_act", "rmsnorm_matmul", "ssm_scan",
             "expert_gemm")

"""Per-(arch x shape) default Layout and RunConfig: the JAX package's
baseline configuration (``repro.launch.defaults``), copied.

``default_run`` is the run config the launcher trains a shape with and the
campaign planner plans it at, so a planned campaign keys what a launched
trainer dispatches. The one field left out is ``mamba_chunk``, which the
port's RunConfig does not carry (it is inert in JAX too).
"""
from __future__ import annotations

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed.sharding import Layout
from ..models.transformer import RunConfig

# params of about 20 B and more get FSDP, full remat and deeper accumulation
_BIG = {"gemma3-27b", "arctic-480b", "mixtral-8x7b", "jamba-1.5-large-398b"}

# The JAX package's shipped per-(arch, shape) layout and run overrides.
TUNED = {
    ("qwen2-0.5b", "train"): {
        # pure data parallelism over both mesh axes
        "tensor_axis": "none", "data_axes": ("data", "model"),
        "microbatches": 1, "head_aware": True,
    },
    ("minitron-4b", "train"): {
        "head_aware": True, "microbatches": 1,
    },
    ("arctic-480b", "train"): {
        "head_aware": True,
    },
}


def tuned_overrides(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    return dict(TUNED.get((cfg.name, shape.kind), {"head_aware": True}))


def default_layout(cfg: ArchConfig, multi_pod: bool = False) -> Layout:
    return Layout(
        tensor_axis="model",
        data_axes=("data",),
        fsdp=cfg.name in _BIG,
        shard_experts=True,
        counts=(
            ("heads", cfg.num_heads),
            ("kv_heads", cfg.num_kv_heads),
            ("experts", max(cfg.num_experts, 1)),
        ),
        head_aware=False,
        name="baseline",
    )


def default_run(cfg: ArchConfig, shape: ShapeSpec) -> RunConfig:
    big = cfg.name in _BIG
    if shape.name == "train_smoke":
        # the smoke trainer's chunking (launch.train --smoke), so a campaign
        # planned at train_smoke keys what it dispatches
        return RunConfig(remat="none", loss_chunk=32, q_chunk=32, k_chunk=32, microbatches=1)
    if shape.kind == "train":
        return RunConfig(remat="full" if big else "dots", microbatches=8 if big else 4,
                         q_chunk=512, k_chunk=1024, loss_chunk=512, mlstm_chunk=64,
                         moe_dispatch="scatter")
    if shape.kind == "prefill":
        return RunConfig(remat="none", microbatches=1, q_chunk=512, k_chunk=2048,
                         loss_chunk=512, mlstm_chunk=64, moe_dispatch="scatter")
    # decode: single-chunk attention, no remat
    return RunConfig(remat="none", microbatches=1, q_chunk=1, k_chunk=shape.seq_len,
                     loss_chunk=512, mlstm_chunk=64, moe_dispatch="scatter")

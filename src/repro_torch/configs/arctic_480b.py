"""Snowflake Arctic-480B — dense-MoE hybrid [hf:Snowflake/snowflake-arctic-base].

35L, d_model 7168, 56 heads (GQA kv=8), dense d_ff 4864 in *parallel
residual* with a 128-expert top-2 MoE (expert d_ff 4864).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    head_dim=128,
    ffn_kind="swiglu",
    num_experts=128,
    experts_per_token=2,
    moe_residual_dense=True,
    notes="56 heads not divisible by 16; 128 experts shard 8-per-device on "
    "the model axis (expert parallelism).",
)

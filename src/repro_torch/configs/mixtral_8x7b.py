"""Mixtral-8x7B — 8-expert top-2 MoE with SWA [arXiv:2401.04088].

32L, d_model 4096, 32 heads (GQA kv=8), expert d_ff 14336, vocab 32000,
sliding-window attention (4096) per the assignment line.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    head_dim=128,
    ffn_kind="swiglu",
    window=4096,
    num_experts=8,
    experts_per_token=2,
    notes="8 experts < 16-way model axis: expert dim cannot fill the axis — "
    "the layout solver shards expert-ff instead (divisibility-driven).",
)

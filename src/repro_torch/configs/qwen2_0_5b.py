"""Qwen2-0.5B — GQA with QKV bias [arXiv:2407.10671].

24L, d_model 896, 14 heads (GQA kv=2), d_ff 4864, vocab 151936.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151_936,
    head_dim=64,
    ffn_kind="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    notes="14 heads / 64 head_dim: smallest arch; vocab dominates params.",
)

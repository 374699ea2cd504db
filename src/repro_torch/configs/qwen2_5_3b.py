"""Qwen2.5-3B — GQA with QKV bias [hf:Qwen/Qwen2.5-3B].

36L, d_model 2048, 16 heads (GQA kv=2), d_ff 11008, vocab 151936.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11_008,
    vocab_size=151_936,
    head_dim=128,
    ffn_kind="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

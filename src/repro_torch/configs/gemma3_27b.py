"""Gemma3-27B — 5:1 local:global attention, 128k context [hf:google/gemma-3].

62L, d_model 5376, 32 heads (GQA kv=16), d_ff 21504, vocab 262144.
head_dim 128 (the real model's choice; 5376/32 would give 168).
Local layers use a 1024-token sliding window -> windowed KV caches.
62 = 10×(5 local + 1 global) + 2 trailing local layers.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21_504,
    vocab_size=262_144,
    head_dim=128,
    ffn_kind="geglu",
    window=1024,
    local_global_ratio=5,
    rope_theta=1_000_000.0,
    notes="long_500k skipped: global layers are full attention and the "
    "design context is 128k (per brief's skip rule).",
)

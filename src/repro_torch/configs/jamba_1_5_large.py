"""Jamba-1.5-Large (398B) — Mamba+attention 7:1, MoE 16e top-2 [arXiv:2403.19887].

72L, d_model 8192, 64 heads (GQA kv=8), d_ff 24576, vocab 65536.
Block structure: 8-layer super-block = 1 attention + 7 mamba layers, MoE FFN
every 2nd layer (16 experts, top-2). 72 = 9 super-blocks. Mamba state is
O(1) in sequence => sub-quadratic: long_500k runs (attention layers keep a
full-length KV cache; 9 of 72 layers).

One super-block's four MoE layers alone hold 38.7 B expert parameters, so on
one 80 GB card the port serves the dense variant (``num_experts=0``); the
MoE layers run at reduced size, and wait for expert parallelism on cards.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    head_dim=128,
    ffn_kind="swiglu",
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    attn_every=8,
    mamba_expand=2,
    mamba_d_state=16,
    sub_quadratic=True,
)

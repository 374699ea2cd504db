"""PaliGemma-3B — SigLIP + Gemma-2B VLM [arXiv:2407.07726].

Backbone (per brief, frontend stubbed): 18L, d_model 2048, 8 heads
(MQA kv=1), d_ff 16384, vocab 257216, head_dim 256 (gemma-2b geometry).
input_specs provides 256 precomputed patch embeddings as a prefix.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16_384,
    vocab_size=257_216,
    head_dim=256,
    ffn_kind="geglu",
    frontend="vision_patches",
    num_prefix=256,
    notes="MQA (kv=1) and 8 heads: neither shards 16-way — attention runs "
    "batch-parallel over the full mesh (solver fallback).",
)

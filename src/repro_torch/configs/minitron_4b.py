"""Minitron-4B — width-pruned Nemotron-4 [arXiv:2407.14679; hf].

32L, d_model 3072, 24 heads (GQA kv=8), d_ff 9216, vocab 256000.
Nemotron family uses squared-ReLU MLPs (2-matrix) and untied embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256_000,
    head_dim=128,
    ffn_kind="relu2",
    rope_theta=10_000.0,
    notes="24 heads is not divisible by the 16-way model axis — exercises "
    "the sharding solver's pad-heads/batch-all fallback (a tuned choice).",
)

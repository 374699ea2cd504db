"""MusicGen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L, d_model 2048, 32 heads (kv=32, i.e. MHA), d_ff 8192, vocab 2048.
Backbone only (per brief): the EnCodec frontend is a stub — input_specs
provides precomputed frame embeddings (4 codebooks summed); text-conditioning
cross-attention omitted. GELU 2-matrix FFN (standard transformer decoder).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    ffn_kind="gelu",
    frontend="audio_frames",
)

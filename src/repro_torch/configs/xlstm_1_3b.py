"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L, d_model 2048, 4 heads, no separate FFN (d_ff=0: the blocks carry their
own up/down projections — mLSTM pf=2, sLSTM post-MLP pf=4/3).
Alternating mLSTM/sLSTM 1:1 (the config line gives no ratio).
Constant-size recurrent state => sub-quadratic: long_500k runs.

At these widths the config holds 2.928 B parameters (24 mLSTM layers of
75.5 M, 24 sLSTM layers of 37.9 M, the embedding table and the untied
unembed of 50,304 x 2,048 each), not the paper's 1.3 B.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    ssm_pattern=("mlstm", "slstm"),
    sub_quadratic=True,
)

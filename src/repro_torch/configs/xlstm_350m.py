"""xLSTM-350M [arXiv:2405.04517]: sLSTM + mLSTM blocks, 7:1 ratio.

24L d_model=1024, 4 heads, d_ff=0 (the blocks carry their own
up/down projections), vocab 50304 (GPT-NeoX tokenizer, 128-padded).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    # xLSTM[7:1]: seven mLSTM blocks per sLSTM block
    pattern=("x", "x", "x", "x", "x", "x", "x", "s"),
    mlstm_proj=2.0,
    slstm_proj=4 / 3,
    tie_embeddings=True,
)

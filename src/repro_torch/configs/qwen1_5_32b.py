"""Qwen1.5-32B [hf:Qwen]: dense transformer with QKV bias.

64L d_model=5120, 40 heads (kv=40: MHA), d_ff 27392, vocab 152064.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    microbatch=4,
)

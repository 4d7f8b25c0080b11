"""Yi-34B [arXiv:2403.04652]: llama-arch GQA.

60L d_model=7168, 56 q heads / 8 KV heads, d_ff 20480, vocab 64000.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5e6,
    microbatch=4,
)

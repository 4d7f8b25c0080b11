"""InternLM2-20B [arXiv:2403.17297]: dense GQA transformer.

48L d_model=6144, 48 q heads / 8 KV heads, d_ff 16384, vocab 92544.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1e6,
    microbatch=2,
)

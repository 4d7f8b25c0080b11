"""Mixtral-8x7B [arXiv:2401.04088]: 8-expert top-2 MoE with SWA.

32L d_model=4096, 32 q heads / 8 KV heads, d_ff 14336, vocab 32000.
Sliding window 4096 makes long_500k decode sub-quadratic (O(window)).
Experts (8) don't divide the 16-way model axis -> TP-inside-expert
sharding (see DESIGN.md).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    moe_every=1,
    moe_sharding="tp",
    sliding_window=4096,
    rope_theta=1e6,
    microbatch=2,
)

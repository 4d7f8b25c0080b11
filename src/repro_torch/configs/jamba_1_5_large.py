"""Jamba-1.5-Large (398B total / 94B active) [arXiv:2403.19887].

72L d_model=8192; attention:mamba 1:7 interleave (attn at slot 4 of each
8-layer period); MoE (16 experts, top-2) at every other layer.
64 q heads, 8 KV heads, d_ff 24576, vocab 65536.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    pattern=("m", "m", "m", "a", "m", "m", "m", "m"),
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_sharding="ep",              # 16 experts == model axis, clean EP
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    param_dtype="bfloat16",          # 398B params: f32 master in optimizer
    opt_state_dtype="bfloat16",     # mu/nu bf16: 398B f32 states exceed
                                     # single-pod HBM (see EXPERIMENTS.md)
    microbatch=8,
    fsdp_serve=True,   # 398B params must stay data-sharded even to serve
)

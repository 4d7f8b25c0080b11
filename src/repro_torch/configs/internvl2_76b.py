"""InternVL2-76B [arXiv:2404.16821]: InternViT (stub) + LLM backbone.

80L d_model=8192, 64 q heads / 8 KV heads, d_ff 28672, vocab 128256.
The ViT frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, 256, frontend_dim) which a linear
projector maps into the token stream ahead of the text tokens.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="patch",
    n_patches=256,
    frontend_dim=3200,              # InternViT-6B hidden size
    rope_theta=5e5,
    param_dtype="bfloat16",
    microbatch=8,
)

"""DBRX-132B [hf:databricks/dbrx-base]: fine-grained 16-expert top-4 MoE.

40L d_model=6144, 48 q heads / 8 KV heads, d_ff 10752, vocab 100352.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    top_k=4,
    moe_every=1,
    moe_sharding="ep",
    rope_theta=5e5,
    param_dtype="bfloat16",
    microbatch=4,
    fsdp_serve=True,   # 132B bf16 replicated-over-data exceeds HBM
)

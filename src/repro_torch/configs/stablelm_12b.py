"""StableLM-2-12B [hf:stabilityai]: dense GQA transformer.

40L d_model=5120, 32 q heads / 8 KV heads, d_ff 13824, vocab 100352.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    microbatch=2,
)

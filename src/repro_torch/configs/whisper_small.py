"""Whisper-small [arXiv:2212.04356]: encoder-decoder, conv frontend stub.

12 encoder + 12 decoder layers, d_model=768, 12 heads (MHA), d_ff 3072,
vocab 51865 (padded to 51968 for clean 16-way TP).  The conv1d stem is a
STUB: input_specs() provides precomputed frame embeddings (B, 1500, 768).
Decoder positions are capped at 448 — decode_32k/long_500k shape cells
clamp sequence dims to the architecture's maxima (see DESIGN.md).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,                   # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    enc_dec=True,
    enc_layers=12,
    enc_positions=1500,
    max_positions=448,
    frontend="audio",
    frontend_dim=768,
)

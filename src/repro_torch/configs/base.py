"""Architecture config schema + shape cells for the assigned pool."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False

    # mixer pattern, repeated to n_layers. 'a'=attention, 'm'=mamba,
    # 'x'=mLSTM, 's'=sLSTM.  Every block except x/s gets an FFN.
    pattern: Tuple[str, ...] = ("a",)
    sliding_window: Optional[int] = None

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1              # every k-th FFN layer is MoE
    moe_sharding: str = "ep"        # 'ep' (experts over model) | 'tp'
    capacity_factor: float = 1.25

    # mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk: int = 128

    # xLSTM
    mlstm_proj: float = 2.0
    slstm_proj: float = 4 / 3
    mlstm_chunk: int = 256

    # modality frontends (stubs per assignment: precomputed embeddings in)
    frontend: Optional[str] = None  # 'patch' | 'audio'
    n_patches: int = 0              # vlm: patches prepended to text
    frontend_dim: int = 0           # embedding dim delivered by the stub

    # encoder-decoder (whisper)
    enc_dec: bool = False
    enc_layers: int = 0
    enc_positions: int = 0          # encoder sequence (1500 for whisper)
    max_positions: int = 0          # decoder cap (448 for whisper); 0 = inf

    # numerics / impl knobs
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_block: int = 1024
    remat: str = "block"            # 'none' | 'block'
    vocab_pad_to: int = 128
    # unroll the layer scan: slower compile, exact cost_analysis flops
    # (XLA counts a while-loop body once) — the dry-run's roofline pass
    # flips this on; production training keeps the rolled loop.
    loop_unroll: bool = False
    # residual-stream sharding between blocks: 'seq' = Megatron-SP style
    # sequence sharding over the model axis (saved-activation memory and
    # wire bytes drop ~16x for attention archs); 'batch' = DP-only.
    act_shard: str = "seq"
    # physical strategy: 'tp' (Megatron TP over the model axis) or
    # 'fsdp' (ZeRO-3 pure DP — batch over every axis).  See §Perf.
    mesh_strategy: str = "tp"
    # pin the residual/norm boundary dtype with an optimization barrier so
    # XLA cannot hoist f32 converts across the seq-parallel all-gathers
    # (observed 2x wire-byte inflation — §Perf 'bf16-collective').
    norm_barrier: bool = False
    # gradient-accumulation microbatches in train_step (memory lever for
    # the deep/wide archs whose per-layer residuals dominate HBM).
    microbatch: int = 1
    # AdamW mu/nu dtype ('bfloat16' halves optimizer HBM: the 398B-param
    # archs need it to approach single-pod residency; master stays f32).
    opt_state_dtype: str = "float32"
    # parameter FSDP (extra data-axis sharding).  Training wants it for
    # optimizer-state residency; serving wants params RESIDENT (sharded
    # over model only) so no per-step parameter gathers occur — except
    # for archs whose replicated-over-data params exceed HBM.
    fsdp_train: bool = True
    fsdp_serve: bool = False

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_to
        return -(-self.vocab_size // m) * m

    def block_kinds(self):
        """Mixer kind for each of the n_layers blocks."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def has_ffn(self, kind: str) -> bool:
        return kind in ("a", "m")       # xLSTM blocks carry no extra FFN

    def is_moe_slot(self, slot: int) -> bool:
        return self.n_experts > 0 and (slot % self.moe_every
                                       == self.moe_every - 1)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat = self.pattern
        return replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(len(pat), 2) if len(pat) > 1 else 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 4),
            # drop-free in tiny smoke tests so train/prefill/decode agree
            # bit-for-bit (capacity dropping is exercised separately in
            # tests/test_moe.py)
            capacity_factor=8.0,
            enc_layers=2 if self.enc_layers else 0,
            enc_positions=32 if self.enc_positions else 0,
            max_positions=64 if self.max_positions else 0,
            n_patches=8 if self.n_patches else 0,
            frontend_dim=32 if self.frontend_dim else 0,
            sliding_window=16 if self.sliding_window else None,
            mamba_chunk=8,
            mlstm_chunk=8,
            attn_block=16,
            param_dtype="float32",
            compute_dtype="float32",
        )


@dataclass(frozen=True)
class ShapeCell:
    """One (arch x input-shape) dry-run cell."""
    name: str
    step: str            # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

# archs for which long_500k is runnable (sub-quadratic sequence mixing);
# the rest are pure full-attention and are skipped per the assignment
# (see DESIGN.md §Arch-applicability).
LONG_CONTEXT_OK = {"xlstm-350m", "jamba-1.5-large-398b", "mixtral-8x7b"}

"""The decoder-only attention LM, dense or MoE, in PyTorch: init,
training loss, prefill and decode.

The port of the attention-decoder part of the JAX package's
``models/lm.py``, with its parameter tree: ``embed`` (V_pad, d), ``head``
(d, V_pad) unless the embeddings are tied, ``final_ln``, and ``slots[0]``
holding each leaf stacked over the ``n_layers`` repeats of the pattern
``("a",)``; its FFN is ``mlp`` (SwiGLU) or, in an MoE slot
(``cfg.is_moe_slot``), ``moe_ep`` / ``moe_tp`` by ``cfg.moe_sharding``
(the top-k MoE of :func:`repro_torch.models.layers.moe`).
The reference drives the repeats with ``lax.scan``; here they are a
Python loop over the stacked leaves.  The KV cache has the reference's
layout (``{"pos", "slots": [{"k", "v", "kpos"}]}``, ``pos`` a Python
int here) and is updated in place.

The training half (:meth:`LM.loss`, :meth:`LM.forward_train`) runs the
same layers cache-free; with ``cfg.remat == "block"`` each repeat is
recomputed in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``).  The reference's ``norm_barrier`` and activation
sharding constraints have no counterpart on one card.

Long prompts (more than 2,048 tokens) attend through K5
(:mod:`repro_torch.kernels.flash_attn`) in serving; training at any
length takes the plain, differentiable scan, as the reference's does
(:func:`repro_torch.models.layers.blockwise_attention`).  SSM/xLSTM,
hybrid, VLM and encoder-decoder configs are not ported (ROADMAP.md item
16): :func:`build_lm` refuses them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]
F32_KEEP = ("A_log", "D", "router", "wif", "bif", "dt_bias", "b",
            "scale", "ln")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def unsupported(cfg: ArchConfig) -> Optional[str]:
    """Why the port cannot build ``cfg`` yet, or None for an attention
    decoder (dense or MoE)."""
    if tuple(cfg.pattern) != ("a",):
        return f"mixer pattern {cfg.pattern}"
    if cfg.enc_dec:
        return "an encoder-decoder"
    if cfg.frontend:
        return f"the {cfg.frontend!r} frontend"
    return None


def ffn_key(cfg: ArchConfig, j: int) -> str:
    """The FFN leaf of pattern slot ``j``: ``mlp``, or in an MoE slot
    ``moe_ep`` / ``moe_tp`` by ``cfg.moe_sharding`` (the reference's
    ``_init_block``)."""
    if not (cfg.is_moe_slot(j) and cfg.has_ffn(cfg.pattern[j])):
        return "mlp"
    return "moe_ep" if cfg.moe_sharding == "ep" else "moe_tp"


class LM:
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        why = unsupported(cfg)
        if why is not None:
            raise NotImplementedError(
                f"{cfg.name}: {why} is not ported; the port runs "
                "attention decoders, dense or MoE, only (ROADMAP.md "
                "item 16)")
        self.cfg = cfg
        self.pattern = cfg.pattern
        self.repeats = cfg.n_layers // len(cfg.pattern)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None) -> Params:
        """Random parameters drawn from ``generator`` (default: seed 0 on
        this LM's device), with the reference's scales: embed N(0, 0.02),
        head, projections, router and experts N(0, 1/fan_in), norms 1,
        biases 0; the router f32 whatever ``param_dtype`` is.  The
        numbers differ from the reference's ``jax.random`` draws; carry
        those over with :func:`repro_torch.convert.lm_params_from_numpy`."""
        cfg = self.cfg
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        dt = DTYPES[cfg.param_dtype]
        gdev = gen.device

        def normal(shape, std):
            return torch.randn(shape, generator=gen, device=gdev).mul_(
                std).to(dt)

        r, d = self.repeats, cfg.d_model

        def ones(*lead):
            return {"scale": torch.ones((*lead, d), device=gdev)}

        params: Params = {"embed": normal((cfg.vocab_padded, d), 0.02),
                          "final_ln": ones()}
        if not cfg.tie_embeddings:
            params["head"] = normal((d, cfg.vocab_padded), 1 / math.sqrt(d))
        # each leaf drawn stacked over the repeats, as lax.scan reads them
        slot = {"ln1": ones(r),
                "attn": L.init_attention(gen, d, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.hd,
                                         cfg.qkv_bias, dt, lead=(r,)),
                "ln2": ones(r)}
        key = ffn_key(cfg, 0)
        if key == "mlp":
            slot[key] = L.init_mlp(gen, d, cfg.d_ff, dt, lead=(r,))
        else:
            slot[key] = L.init_moe(gen, d, cfg.d_ff, cfg.n_experts, dt,
                                   lead=(r,))
        params["slots"] = [slot]
        if gdev != self.device:
            params = _tree_map(lambda t: t.to(self.device), params)
        return params

    def _ffn(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        """The block's FFN on ``rms_norm(p["ln2"], x)``: the SwiGLU MLP,
        or in an MoE slot the top-k MoE."""
        cfg = self.cfg
        h = L.rms_norm(p["ln2"], x)
        key = ffn_key(cfg, 0)
        if key == "mlp":
            return L.mlp(p[key], h)
        return L.moe(p[key], h, top_k=cfg.top_k, n_experts=cfg.n_experts,
                     capacity_factor=cfg.capacity_factor,
                     ep=key == "moe_ep")

    # ------------------------------------------------------------------
    def _cast(self, params: Params) -> Params:
        """Cast params to the compute dtype, keeping numerics-critical
        leaves (norm scales) in f32.  A leaf already in the compute dtype
        is returned as it is, so casting a cast tree costs nothing."""
        ct = DTYPES[self.cfg.compute_dtype]

        def walk(tree, name=""):
            if isinstance(tree, dict):
                return {k: walk(v, k) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(v, name) for v in tree)
            if any(name == k or name.startswith("ln") for k in F32_KEEP):
                return tree
            return tree.to(ct)
        return walk(params)

    # ------------------------------------------------------------------
    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        head = (params["embed"].T if cfg.tie_embeddings
                else params["head"])
        lg = x @ head
        pad_mask = torch.arange(cfg.vocab_padded,
                                device=lg.device) < cfg.vocab_size
        return lg.float().masked_fill(~pad_mask, -1e30)

    def embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding: its CUDA backward sums a token's rows in a fixed
        # order (sorted indices), so a training step is reproducible
        return F.embedding(tokens.long(), params["embed"])

    # ------------------------------------------------------------------
    # forward (train path)
    # ------------------------------------------------------------------
    def _block_train(self, p: Params, x: torch.Tensor,
                     use_rope: bool = True) -> torch.Tensor:
        """One decoder block (kind ``"a"``, MLP or MoE), cache-free."""
        cfg = self.cfg
        h = L.rms_norm(p["ln1"], x)
        out, _ = L.attention(
            p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd, rope_theta=cfg.rope_theta,
            window=cfg.sliding_window, causal=True,
            attn_block=cfg.attn_block, use_rope=use_rope)
        x = x + out
        return x + self._ffn(p, x)

    def _backbone_train(self, params: Params, x: torch.Tensor
                        ) -> torch.Tensor:
        """The repeats in order (the reference's ``lax.scan``), each one
        recomputed in the backward when ``cfg.remat == "block"``; then
        the final norm."""
        slot = params["slots"][0]
        for r in range(self.repeats):
            p_r = _tree_map(lambda t: t[r], slot)
            if self.cfg.remat == "block":
                x = checkpoint(self._block_train, p_r, x,
                               use_reentrant=False)
            else:
                x = self._block_train(p_r, x)
        return L.rms_norm(params["final_ln"], x)

    def forward_train(self, params: Params,
                      batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits (B, S, V_pad) in f32 over the positions of
        ``batch["inputs"]`` (decoder-only)."""
        params = self._cast(params)
        x = self.embed(params, batch["inputs"])
        x = self._backbone_train(params, x)
        return self.logits(params, x)

    def loss(self, params: Params,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["targets"]``."""
        lg = self.forward_train(params, batch)
        labels = batch["targets"].long()
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[..., None])[..., 0]
        return torch.mean(lse - gold)

    # ------------------------------------------------------------------
    def _slot_cache(self, kind: str, batch: int, max_len: int):
        cfg = self.cfg
        ct = DTYPES[cfg.compute_dtype]
        w = min(max_len, cfg.sliding_window or max_len)
        shape = (self.repeats, batch, w, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=ct, device=self.device),
                "v": torch.zeros(shape, dtype=ct, device=self.device),
                "kpos": torch.full((self.repeats, w), -1, dtype=torch.int32,
                                   device=self.device)}

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """{"pos": 0, "slots": [{"k", "v": (R, B, W, Hkv, D), "kpos": (R,
        W)}]}, W = min(max_len, sliding window); stacked over the R
        repeats as the reference's."""
        return {"pos": 0, "slots": [self._slot_cache(kind, batch, max_len)
                                    for kind in self.pattern]}

    # ------------------------------------------------------------------
    def _block_cached(self, p: Params, x, cache, pos):
        cfg = self.cfg
        h = L.rms_norm(p["ln1"], x)
        out, _ = L.attention_cached(
            p["attn"], h, cache, pos, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta, window=cfg.sliding_window,
            attn_block=cfg.attn_block)
        x = x + out
        return x + self._ffn(p, x)

    def _run_cached(self, params: Params, x, cache):
        """Run the layers in order, each against its cache slice (views
        of the stacked cache, written in place)."""
        pos = cache["pos"]
        slot_p, slot_c = params["slots"][0], cache["slots"][0]
        for r in range(self.repeats):
            p_r, c_r = (_tree_map(lambda t: t[r], tree)
                        for tree in (slot_p, slot_c))
            x = self._block_cached(p_r, x, c_r, pos)
        cache["pos"] = pos + x.shape[1]
        return x, cache

    # ------------------------------------------------------------------
    def prefill(self, params: Params, batch, cache):
        """Process a full prompt; returns (last-token logits, cache)."""
        params = self._cast(params)
        x = self.embed(params, batch["inputs"])
        x, cache = self._run_cached(params, x, cache)
        x = L.rms_norm(params["final_ln"], x[:, -1:])
        return self.logits(params, x), cache

    def decode_step(self, params: Params, batch, cache):
        """One-token step against the cache. batch['inputs']: (B, 1)."""
        params = self._cast(params)
        x = self.embed(params, batch["inputs"])
        x, cache = self._run_cached(params, x, cache)
        x = L.rms_norm(params["final_ln"], x)
        return self.logits(params, x), cache

    # ------------------------------------------------------------------
    def param_counts(self, params: Params) -> Tuple[int, int]:
        """(total, active) parameter counts; active counts each MoE
        slot's experts at ``top_k / n_experts`` (the reference's floor)."""
        cfg = self.cfg
        sizes = []
        _tree_map(lambda t: sizes.append(t.numel()), params)
        total = sum(sizes)
        expert = sum(slot[key][w].numel() for slot in params["slots"]
                     for key in ("moe_ep", "moe_tp") if key in slot
                     for w in ("wg", "wu", "wd"))
        return total, total - expert + (expert * cfg.top_k
                                        // max(cfg.n_experts, 1))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def build_lm(cfg: ArchConfig, device: DeviceLike = None) -> LM:
    return LM(cfg, device=device)

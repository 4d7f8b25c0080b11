"""The dense decoder-only LM, in PyTorch: init, prefill and decode.

The port of the dense-decoder part of the JAX package's ``models/lm.py``,
with its parameter tree: ``embed`` (V_pad, d), ``head`` (d, V_pad) unless
the embeddings are tied, ``final_ln``, and ``slots[0]`` holding each
leaf stacked over the ``n_layers`` repeats of the pattern ``("a",)``.
The reference drives the repeats with ``lax.scan``; here they are a
Python loop over the stacked leaves.  The KV cache has the reference's
layout (``{"pos", "slots": [{"k", "v", "kpos"}]}``, ``pos`` a Python
int here) and is updated in place.

Long prompts (more than 2,048 tokens) attend through K5
(:mod:`repro_torch.kernels.flash_attn`).  MoE, SSM/xLSTM, hybrid, VLM and
encoder-decoder configs are not ported (ROADMAP.md item 16):
:func:`build_lm` refuses them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]
F32_KEEP = ("A_log", "D", "router", "wif", "bif", "dt_bias", "b",
            "scale", "ln")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def unsupported(cfg: ArchConfig) -> Optional[str]:
    """Why the port cannot build ``cfg`` yet, or None for a dense
    decoder."""
    if tuple(cfg.pattern) != ("a",):
        return f"mixer pattern {cfg.pattern}"
    if cfg.n_experts:
        return f"{cfg.n_experts} MoE experts"
    if cfg.enc_dec:
        return "an encoder-decoder"
    if cfg.frontend:
        return f"the {cfg.frontend!r} frontend"
    return None


class LM:
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        why = unsupported(cfg)
        if why is not None:
            raise NotImplementedError(
                f"{cfg.name}: {why} is not ported; the port serves dense "
                "decoders only (ROADMAP.md item 16)")
        self.cfg = cfg
        self.pattern = cfg.pattern
        self.repeats = cfg.n_layers // len(cfg.pattern)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None) -> Params:
        """Random parameters drawn from ``generator`` (default: seed 0 on
        this LM's device), with the reference's scales: embed N(0, 0.02),
        head and projections N(0, 1/fan_in), norms 1, biases 0.  The
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
        params["slots"] = [{
            "ln1": ones(r),
            "attn": L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.hd, cfg.qkv_bias, dt, lead=(r,)),
            "ln2": ones(r),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, dt, lead=(r,))}]
        if gdev != self.device:
            params = _tree_map(lambda t: t.to(self.device), params)
        return params

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
        return params["embed"][tokens.long()]

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
        return x + L.mlp(p["mlp"], L.rms_norm(p["ln2"], x))

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
        """(total, active) parameter counts; a dense decoder has no
        experts, so both are the total."""
        sizes = []
        _tree_map(lambda t: sizes.append(t.numel()), params)
        return sum(sizes), sum(sizes)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def build_lm(cfg: ArchConfig, device: DeviceLike = None) -> LM:
    return LM(cfg, device=device)

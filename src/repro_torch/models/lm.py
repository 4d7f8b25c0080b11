"""The LM in PyTorch: decoder-only (attention, recurrent or hybrid), the
patch-frontend VLM and the encoder-decoder; init, training loss, prefill
and decode.

The port of the JAX package's ``models/lm.py``, with its parameter tree:
``embed`` (V_pad, d), ``head`` (d, V_pad) unless the embeddings are
tied, ``final_ln``, and ``slots[j]`` for each slot j of the config's
mixer ``pattern``, every leaf stacked over the ``n_layers /
len(pattern)`` repeats.  A slot's block is ``ln1`` and its mixer,
``attn``, ``mamba``, ``mlstm`` or ``slstm``
(:mod:`repro_torch.models.ssm`) by the kind ``a`` / ``m`` / ``x`` /
``s``; attention and Mamba slots add ``ln2`` and an FFN, ``mlp``
(SwiGLU) or, in an MoE slot (``cfg.is_moe_slot(j)``), ``moe_ep`` /
``moe_tp`` by ``cfg.moe_sharding`` (:func:`repro_torch.models.layers.moe`).
The reference drives the repeats with ``lax.scan`` over super-blocks
(all slots of one repeat); here they are a Python loop over the stacked
leaves, repeat by repeat and slot by slot.  The cache has the
reference's layout (``{"pos", "slots": [...]}``, ``pos`` a Python int
here): per slot the KV cache ``{"k", "v", "kpos"}`` or the recurrent
state tuple (:class:`~repro_torch.models.ssm.MambaState`,
``MLSTMState``, ``SLSTMState``), stacked over the repeats and updated in
place.

Two frontends take precomputed embeddings, as the reference's stubs do.
The patch frontend (``cfg.frontend == "patch"``, InternVL2) projects
``batch["patch_embeds"]`` (B, n_patches, frontend_dim) by ``patch_proj``
and places them ahead of the text; ``forward_train`` drops their
positions before the logits.  The encoder-decoder (``cfg.enc_dec``,
Whisper) runs ``enc_slots`` (``enc_layers`` non-causal attention blocks
over ``batch["frame_embeds"]`` (B, enc_positions, d) plus
``pos_embed_enc``, then ``enc_final_ln``); its decoder adds
``pos_embed_dec``, uses no rope, and follows each self-attention by a
cross-attention (``lnx``, ``xattn``) on the encoder's output, whose K/V
``prefill`` writes into the cache's ``cross_k`` / ``cross_v`` (R, B,
enc_positions, Hkv, hd).  Every attention block of an encoder-decoder
carries ``xattn`` and ``lnx``, the encoder's included, which never reads
them (the reference's ``_init_block``).

The training half (:meth:`LM.loss`, :meth:`LM.forward_train`) runs the
same blocks cache-free; in a decoder-only LM with ``cfg.remat ==
"block"`` each repeat's super-block is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``; its
encoder-decoder path recomputes nothing, nor does the port's).  The
reference's ``norm_barrier`` and activation sharding constraints have no
counterpart on one card.

Long prompts (more than 2,048 tokens) attend through K5
(:mod:`repro_torch.kernels.flash_attn`) in serving; training at any
length takes the plain, differentiable scan, as the reference's does
(:func:`repro_torch.models.layers.blockwise_attention`).  Whisper never
reaches K5: its encoder is non-causal at 1,500 frames, its
cross-attention has Sq != Sk and its decoder stops at 448 positions.
The recurrent mixers run torch ops (the reference has no Pallas kernel
for them).  :func:`build_lm` builds every config of the repo; it refuses
a pattern with a mixer kind other than ``a`` / ``m`` / ``x`` / ``s``.
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
from repro_torch.models import ssm as S

Params = Dict[str, Any]
F32_KEEP = ("A_log", "D", "router", "wif", "bif", "dt_bias", "b",
            "scale", "ln")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
KINDS = ("a", "m", "x", "s")
MIXER = {"a": "attn", "m": "mamba", "x": "mlstm", "s": "slstm"}


def unsupported(cfg: ArchConfig) -> Optional[str]:
    """Why the port cannot build ``cfg``, or None for a pattern of
    attention, Mamba, mLSTM and sLSTM blocks (any frontend, and the
    encoder-decoder, included)."""
    bad = sorted(set(cfg.pattern) - set(KINDS))
    if bad:
        return f"mixer kinds {bad} in the pattern {cfg.pattern}"
    return None


def embedding_inputs(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """The precomputed embeddings the LM reads beside its tokens, name ->
    per-sample shape (the reference's training ``extra``):
    ``patch_embeds`` (n_patches, frontend_dim) with the patch frontend,
    ``frame_embeds`` (enc_positions, d_model) in an encoder-decoder,
    none in a decoder-only LM."""
    if cfg.frontend == "patch":
        return {"patch_embeds": (cfg.n_patches, cfg.frontend_dim)}
    if cfg.enc_dec:
        return {"frame_embeds": (cfg.enc_positions, cfg.d_model)}
    return {}


def ffn_key(cfg: ArchConfig, j: int) -> Optional[str]:
    """The FFN leaf of pattern slot ``j``: None where the block carries
    no FFN (xLSTM's), ``mlp``, or in an MoE slot ``moe_ep`` / ``moe_tp``
    by ``cfg.moe_sharding`` (the reference's ``_init_block``)."""
    if not cfg.has_ffn(cfg.pattern[j]):
        return None
    if not cfg.is_moe_slot(j):
        return "mlp"
    return "moe_ep" if cfg.moe_sharding == "ep" else "moe_tp"


class LM:
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        why = unsupported(cfg)
        if why is not None:
            raise NotImplementedError(
                f"{cfg.name}: {why} cannot be built; the port runs "
                "attention, Mamba, mLSTM and sLSTM blocks only")
        assert cfg.n_layers % len(cfg.pattern) == 0, \
            (cfg.n_layers, cfg.pattern)
        self.cfg = cfg
        self.pattern = cfg.pattern
        self.repeats = cfg.n_layers // len(cfg.pattern)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None) -> Params:
        """Random parameters drawn from ``generator`` (default: seed 0 on
        this LM's device), with the reference's scales: embed N(0, 0.02),
        head, projections, router and experts N(0, 1/fan_in), norms 1,
        biases 0, Mamba's ``A_log`` / ``D`` and the mLSTM's gate biases
        as the reference sets them; the router, ``A_log``, ``D``,
        ``wif``, ``bif`` and the sLSTM's ``b`` f32 whatever
        ``param_dtype`` is.  An encoder-decoder adds ``enc_slots``
        (``enc_layers`` attention blocks), ``pos_embed_enc``
        (enc_positions, d) and ``pos_embed_dec`` (max_positions, d),
        both N(0, 0.02), and ``enc_final_ln``; the patch frontend adds
        ``patch_proj`` (frontend_dim, d), N(0, 1/frontend_dim).  The
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

        d = cfg.d_model
        params: Params = {"embed": normal((cfg.vocab_padded, d), 0.02),
                          "final_ln": _ones(d, (), gdev)}
        if not cfg.tie_embeddings:
            params["head"] = normal((d, cfg.vocab_padded), 1 / math.sqrt(d))
        # each leaf drawn stacked over the repeats, as lax.scan reads them
        params["slots"] = [
            self._init_block(gen, kind, ffn_key(cfg, j), self.repeats, dt)
            for j, kind in enumerate(self.pattern)]
        if cfg.enc_dec:
            params["enc_slots"] = [self._init_block(gen, "a", "mlp",
                                                    cfg.enc_layers, dt)]
            params["pos_embed_enc"] = normal((cfg.enc_positions, d), 0.02)
            params["pos_embed_dec"] = normal((max(cfg.max_positions, 1), d),
                                             0.02)
            params["enc_final_ln"] = _ones(d, (), gdev)
        if cfg.frontend == "patch":
            params["patch_proj"] = normal((cfg.frontend_dim, d),
                                          1 / math.sqrt(cfg.frontend_dim))
        if gdev != self.device:
            params = _tree_map(lambda t: t.to(self.device), params)
        return params

    def _init_block(self, gen: torch.Generator, kind: str,
                    ffn: Optional[str], n: int, dt) -> Params:
        """A block of mixer ``kind`` and FFN ``ffn`` (:func:`ffn_key`)
        stacked over ``n`` layers (the reference's ``_init_block``); in
        an encoder-decoder every attention block adds the cross-attention
        ``xattn`` (no qkv bias) and its norm ``lnx``."""
        cfg = self.cfg
        d, lead = cfg.d_model, (n,)
        slot: Params = {"ln1": _ones(d, lead, gen.device)}
        if kind == "a":
            slot["attn"] = L.init_attention(gen, d, cfg.n_heads,
                                            cfg.n_kv_heads, cfg.hd,
                                            cfg.qkv_bias, dt, lead=lead)
        elif kind == "m":
            slot["mamba"] = S.init_mamba(
                gen, d, expand=cfg.mamba_expand, d_state=cfg.mamba_d_state,
                d_conv=cfg.mamba_d_conv, dtype=dt, lead=lead)
        elif kind == "x":
            slot["mlstm"] = S.init_mlstm(gen, d, n_heads=cfg.n_heads,
                                         proj_factor=cfg.mlstm_proj,
                                         dtype=dt, lead=lead)
        else:
            slot["slstm"] = S.init_slstm(gen, d, n_heads=cfg.n_heads,
                                         proj_factor=cfg.slstm_proj,
                                         dtype=dt, lead=lead)
        if ffn is not None:
            slot["ln2"] = _ones(d, lead, gen.device)
            if ffn == "mlp":
                slot[ffn] = L.init_mlp(gen, d, cfg.d_ff, dt, lead=lead)
            else:
                slot[ffn] = L.init_moe(gen, d, cfg.d_ff, cfg.n_experts, dt,
                                       lead=lead)
        if cfg.enc_dec and kind == "a":
            slot["xattn"] = L.init_attention(gen, d, cfg.n_heads,
                                             cfg.n_kv_heads, cfg.hd, False,
                                             dt, lead=lead)
            slot["lnx"] = _ones(d, lead, gen.device)
        return slot

    def _ffn(self, p: Params, x: torch.Tensor, j: int) -> torch.Tensor:
        """Slot ``j``'s FFN on ``rms_norm(p["ln2"], x)``: the SwiGLU MLP,
        or in an MoE slot the top-k MoE."""
        cfg = self.cfg
        h = L.rms_norm(p["ln2"], x)
        key = ffn_key(cfg, j)
        if key == "mlp":
            return L.mlp(p[key], h)
        return L.moe(p[key], h, top_k=cfg.top_k, n_experts=cfg.n_experts,
                     capacity_factor=cfg.capacity_factor,
                     ep=key == "moe_ep")

    # ------------------------------------------------------------------
    def _cast(self, params: Params) -> Params:
        """Cast params to the compute dtype, keeping numerics-critical
        leaves (``F32_KEEP``: norm scales, the router, Mamba's ``A_log``,
        ``D``, ``dt_bias``, the mLSTM's ``wif``/``bif``, the sLSTM's
        ``b``, every ``ln*`` scale) as they are; the rest, ``patch_proj``
        and ``pos_embed_*`` included, go to the compute dtype.  A leaf
        already in the compute dtype is returned as it is, so casting a
        cast tree costs nothing."""
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
    def _block_train(self, p: Params, x: torch.Tensor, j: int,
                     use_rope: bool = True) -> torch.Tensor:
        """Slot ``j``'s block, cache-free: its mixer by kind, then its
        FFN where it has one."""
        cfg, kind = self.cfg, self.pattern[j]
        h = L.rms_norm(p["ln1"], x)
        if kind == "a":
            out, _ = L.attention(
                p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.hd, rope_theta=cfg.rope_theta,
                window=cfg.sliding_window, causal=True,
                attn_block=cfg.attn_block, use_rope=use_rope)
        elif kind == "m":
            out, _ = S.mamba_forward(p["mamba"], h, chunk=cfg.mamba_chunk)
        elif kind == "x":
            out, _ = S.mlstm_chunkwise(p["mlstm"], h, n_heads=cfg.n_heads,
                                       chunk=cfg.mlstm_chunk)
        else:
            out, _ = S.slstm_forward(p["slstm"], h)
        x = x + out
        if ffn_key(cfg, j) is not None:
            x = x + self._ffn(p, x, j)
        return x

    def _super_block(self, x: torch.Tensor, slot_ps) -> torch.Tensor:
        """All slots of one repeat, in order (the reference's
        ``super_block``)."""
        for j, p in enumerate(slot_ps):
            x = self._block_train(p, x, j)
        return x

    def _backbone_train(self, params: Params, x: torch.Tensor
                        ) -> torch.Tensor:
        """The repeats in order (the reference's ``lax.scan``), each
        repeat's super-block recomputed in the backward when
        ``cfg.remat == "block"``; then the final norm."""
        for r in range(self.repeats):
            ps = [_tree_map(lambda t: t[r], slot)
                  for slot in params["slots"]]
            if self.cfg.remat == "block":
                x = checkpoint(self._super_block, x, ps,
                               use_reentrant=False)
            else:
                x = self._super_block(x, ps)
        return L.rms_norm(params["final_ln"], x)

    def _attend(self, p: Params, x: torch.Tensor, causal: bool
                ) -> torch.Tensor:
        """An encoder-decoder's cache-free self-attention (no rope)."""
        cfg = self.cfg
        out, _ = L.attention(p["attn"], x, n_heads=cfg.n_heads,
                             n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                             rope_theta=cfg.rope_theta, causal=causal,
                             attn_block=cfg.attn_block, use_rope=False)
        return out

    def _cross(self, p: Params, x: torch.Tensor, cross_kv) -> torch.Tensor:
        """``x`` plus its cross-attention on ``cross_kv`` ((B, S_enc,
        Hkv, hd) K and V): ``lnx``, then ``xattn`` without rope."""
        cfg = self.cfg
        out, _ = L.attention(p["xattn"], L.rms_norm(p["lnx"], x),
                             n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                             head_dim=cfg.hd, rope_theta=cfg.rope_theta,
                             cross_kv=cross_kv, use_rope=False)
        return x + out

    def _cross_kv(self, p: Params, enc: torch.Tensor):
        """The encoder output's K and V for one decoder block's
        ``xattn``, (B, S_enc, Hkv, hd) each."""
        cfg = self.cfg
        b, s, _ = enc.shape
        return tuple((enc @ p["xattn"][w]).reshape(b, s, cfg.n_kv_heads,
                                                   cfg.hd)
                     for w in ("wk", "wv"))

    def _encode(self, params: Params, x: torch.Tensor,
                frames: torch.Tensor) -> torch.Tensor:
        """The encoder: ``frames`` (B, S_enc, d) plus ``pos_embed_enc``
        in ``x``'s dtype, the ``enc_layers`` non-causal blocks
        (self-attention, then the MLP), ``enc_final_ln``."""
        enc = frames.to(x.dtype) + params["pos_embed_enc"][
            None, :frames.shape[1]].to(x.dtype)
        for r in range(self.cfg.enc_layers):
            p = _tree_map(lambda t: t[r], params["enc_slots"][0])
            enc = enc + self._attend(p, L.rms_norm(p["ln1"], enc), False)
            enc = enc + L.mlp(p["mlp"], L.rms_norm(p["ln2"], enc))
        return L.rms_norm(params["enc_final_ln"], enc)

    def _front(self, params: Params, batch) -> Tuple[torch.Tensor, Any]:
        """The decoder's input (B, S, d) and, in an encoder-decoder, the
        encoder's output: the token embeddings, plus ``pos_embed_dec``
        at positions 0..S-1 in an encoder-decoder, or after the
        projected patches (``patch_embeds @ patch_proj``) with the patch
        frontend."""
        cfg = self.cfg
        x = self.embed(params, batch["inputs"])
        enc = None
        if cfg.enc_dec:
            enc = self._encode(params, x, batch["frame_embeds"])
            x = x + params["pos_embed_dec"][None, :x.shape[1]].to(x.dtype)
        elif cfg.frontend == "patch":
            pe = batch["patch_embeds"].to(x.dtype) @ params["patch_proj"]
            x = torch.cat([pe, x], 1)
        return x, enc

    def forward_train(self, params: Params,
                      batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits (B, S, V_pad) in f32 over the positions of
        ``batch["inputs"]``: the patches' positions are dropped, and an
        encoder-decoder's decoder attends to ``batch["frame_embeds"]``
        through its encoder."""
        cfg = self.cfg
        params = self._cast(params)
        x, enc = self._front(params, batch)
        if cfg.enc_dec:
            for r in range(self.repeats):
                p = _tree_map(lambda t: t[r], params["slots"][0])
                x = x + self._attend(p, L.rms_norm(p["ln1"], x), True)
                x = self._cross(p, x, self._cross_kv(p, enc))
                x = x + L.mlp(p["mlp"], L.rms_norm(p["ln2"], x))
            x = L.rms_norm(params["final_ln"], x)
        else:
            x = self._backbone_train(params, x)
            if cfg.frontend == "patch":
                x = x[:, cfg.n_patches:]
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
    # caches
    # ------------------------------------------------------------------
    def _slot_cache(self, kind: str, batch: int, max_len: int):
        """One slot's cache stacked over the R repeats: the KV cache, or
        the recurrent state (Mamba's conv state in the compute dtype and
        its SSM state f32; the mLSTM's and sLSTM's f32, ``m`` at -1e30)."""
        cfg = self.cfg
        ct = DTYPES[cfg.compute_dtype]
        r, dev, f32 = self.repeats, self.device, torch.float32

        def zeros(*shape, dtype=f32):
            return torch.zeros((r, *shape), dtype=dtype, device=dev)

        def neg(*shape):
            return torch.full((r, *shape), S.NEG, dtype=f32, device=dev)
        if kind == "a":
            w = min(max_len, cfg.sliding_window or max_len)
            return {"k": zeros(batch, w, cfg.n_kv_heads, cfg.hd, dtype=ct),
                    "v": zeros(batch, w, cfg.n_kv_heads, cfg.hd, dtype=ct),
                    "kpos": torch.full((r, w), -1, dtype=torch.int32,
                                       device=dev)}
        if kind == "m":
            di = cfg.mamba_expand * cfg.d_model
            return S.MambaState(zeros(batch, cfg.mamba_d_conv - 1, di,
                                      dtype=ct),
                                zeros(batch, di, cfg.mamba_d_state))
        if kind == "x":
            dh = int(cfg.mlstm_proj * cfg.d_model) // cfg.n_heads
            return S.MLSTMState(zeros(batch, cfg.n_heads, dh, dh),
                                zeros(batch, cfg.n_heads, dh),
                                neg(batch, cfg.n_heads))
        di = S.slstm_inner_dim(cfg.d_model, cfg.n_heads, cfg.slstm_proj)
        return S.SLSTMState(zeros(batch, di), zeros(batch, di),
                            neg(batch, di), zeros(batch, di))

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        """{"pos": 0, "slots": [one cache per pattern slot]}: ``{"k",
        "v": (R, B, W, Hkv, D), "kpos": (R, W)}`` for attention (W =
        min(max_len, sliding window)), else the block's state tuple with
        every leaf (R, B, ...); stacked over the R repeats as the
        reference's.  An encoder-decoder adds ``cross_k`` / ``cross_v``
        (R, B, enc_positions, Hkv, D) in the compute dtype, zero until
        :meth:`prefill` writes the encoder's K/V there."""
        cfg = self.cfg
        cache = {"pos": 0, "slots": [self._slot_cache(kind, batch, max_len)
                                     for kind in self.pattern]}
        if cfg.enc_dec:
            for name in ("cross_k", "cross_v"):
                cache[name] = torch.zeros(
                    (self.repeats, batch, cfg.enc_positions, cfg.n_kv_heads,
                     cfg.hd), dtype=DTYPES[cfg.compute_dtype],
                    device=self.device)
        return cache

    # ------------------------------------------------------------------
    # cached block (prefill S tokens or decode 1 token)
    # ------------------------------------------------------------------
    def _block_cached(self, p: Params, x, j: int, cache, pos, cross=None):
        """Slot ``j``'s block against its cache: the KV cache is written
        in place by ``attention_cached``; a recurrent block's new state
        is copied into ``cache``'s tensors.  ``cross``: this repeat's
        cached cross K/V, attended after the self-attention (an
        encoder-decoder, whose attention takes no rope)."""
        cfg, kind = self.cfg, self.pattern[j]
        h = L.rms_norm(p["ln1"], x)
        if kind == "a":
            out, _ = L.attention_cached(
                p["attn"], h, cache, pos, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                rope_theta=cfg.rope_theta, window=cfg.sliding_window,
                attn_block=cfg.attn_block, use_rope=not cfg.enc_dec)
            new = None
        elif kind == "m":
            out, new = S.mamba_forward(p["mamba"], h, cache,
                                       chunk=min(cfg.mamba_chunk,
                                                 max(x.shape[1], 1)))
        elif kind == "x":
            if x.shape[1] == 1:
                out, new = S.mlstm_recurrent(p["mlstm"], h, cache,
                                             n_heads=cfg.n_heads)
            else:
                out, new = S.mlstm_chunkwise(p["mlstm"], h, cache,
                                             n_heads=cfg.n_heads,
                                             chunk=cfg.mlstm_chunk)
        else:
            out, new = S.slstm_forward(p["slstm"], h, cache)
        if new is not None:
            for dst, src in zip(cache, new):
                dst.copy_(src)
        x = x + out
        if cross is not None and kind == "a":
            x = self._cross(p, x, cross)
        if ffn_key(cfg, j) is not None:
            x = x + self._ffn(p, x, j)
        return x

    def _run_cached(self, params: Params, x, cache):
        """Run every slot of every repeat in order, each against its
        cache slice (views of the stacked cache, written in place), an
        encoder-decoder's against its repeat's cross K/V too."""
        pos = cache["pos"]
        for r in range(self.repeats):
            cross = ((cache["cross_k"][r], cache["cross_v"][r])
                     if self.cfg.enc_dec else None)
            for j in range(len(self.pattern)):
                p_r, c_r = (_tree_map(lambda t: t[r], tree[j])
                            for tree in (params["slots"], cache["slots"]))
                x = self._block_cached(p_r, x, j, c_r, pos, cross)
        cache["pos"] = pos + x.shape[1]
        return x, cache

    # ------------------------------------------------------------------
    def prefill(self, params: Params, batch, cache):
        """Process a full prompt; returns (last-token logits, cache).  An
        encoder-decoder runs its encoder on ``batch["frame_embeds"]``
        and writes each repeat's cross K/V into the cache first (in
        place; tensors of another frame count are replaced); the patch
        frontend prefills the projected patches ahead of the text."""
        params = self._cast(params)
        x, enc = self._front(params, batch)
        if enc is not None:
            cfg = self.cfg
            shape = (self.repeats, *enc.shape[:2], cfg.n_kv_heads, cfg.hd)
            for name in ("cross_k", "cross_v"):
                if tuple(cache[name].shape) != shape:
                    cache[name] = cache[name].new_empty(shape)
            for r in range(self.repeats):
                p_r = _tree_map(lambda t: t[r], params["slots"][0])
                for name, kv in zip(("cross_k", "cross_v"),
                                    self._cross_kv(p_r, enc)):
                    cache[name][r].copy_(kv)
        x, cache = self._run_cached(params, x, cache)
        x = L.rms_norm(params["final_ln"], x[:, -1:])
        return self.logits(params, x), cache

    def decode_step(self, params: Params, batch, cache):
        """One-token step against the cache. batch['inputs']: (B, 1).  An
        encoder-decoder adds ``pos_embed_dec`` at ``pos``, clipped to
        ``max_positions - 1`` as the reference's."""
        cfg = self.cfg
        params = self._cast(params)
        x = self.embed(params, batch["inputs"])
        if cfg.enc_dec:
            pos = min(max(cache["pos"], 0), cfg.max_positions - 1)
            x = x + params["pos_embed_dec"][pos].to(x.dtype)
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


def _ones(d: int, lead, device) -> Params:
    return {"scale": torch.ones((*lead, d), device=device)}


def _tree_map(fn, tree):
    """``fn`` on every tensor of nested dicts, lists, tuples and the
    recurrent state tuples (rebuilt as their own type)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def build_lm(cfg: ArchConfig, device: DeviceLike = None) -> LM:
    return LM(cfg, device=device)

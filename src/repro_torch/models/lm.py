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
reference's ``norm_barrier`` has no counterpart.

**On a mesh.**  Under a :func:`~repro_torch.distributed.sharding.
mesh_context` whose mesh is live (ranks with process groups), every
config runs SPMD in the reference's layouts,
Megatron-style: each rank holds its blocks of the params under
:func:`~repro_torch.distributed.sharding.param_specs` and of the cache
under ``cache_specs`` (:meth:`LM.init_cache` allocates them), and takes
the whole batch, of which it keeps its data rank's rows where the data
axis divides the batch (``batch_specs``).  The residual stream is
replicated over the model axis; the embedding looks up the rank's vocab
rows and sums over the model axis; each attention block runs the rank's
``H/mp`` q and ``Hkv/mp`` kv heads (so a prefill past 2,048 tokens runs
K5 on them) and each MLP the rank's ``d_ff/mp`` columns, and ends in one
sum over ``'model'``; the KV cache holds the rank's W/mp ring slots for
every kv head (:func:`~repro_torch.models.layers.attention_cached_tp`);
the MoE runs its experts' FFN slice after a dispatch every model rank
makes alike, in the mesh's dispatch groups.  Params split over
``'data'`` (FSDP: ``fsdp_train``, or ``fsdp_serve`` as DBRX sets it) are
cast and put together at use, one leaf at a time.  The logits stay
vocab-split: :meth:`LM.loss` sums its log-sum-exp over the model axis
and averages over the batch axes; ``prefill``, ``decode_step`` and
``forward_train`` return the rank's block of the logits (its rows, its
vocab columns).  Where the model axis does not divide the heads or the
kv heads, they run replicated over it, as the reference's ``constrain``
degrades them: the param blocks stay the specs' column blocks (not
whole heads), each rank gets every kv head by one gather
(:func:`~repro_torch.distributed.sharding.whole_cols`) and runs its own
q heads against the kv heads they read (so a long prefill still runs K5
on them), or every head where the q heads do not divide (the
attention's work then ``mp`` times redundant), and keeps its columns of
the output for its rows of ``wo``
(:func:`~repro_torch.models.layers.attention_tp`).  Where it does not
divide ``d_ff``, the padded vocabulary or another dim the param specs
split into blocks, a ``ValueError`` names the dim.  A context whose mesh is a
layout only (``Mesh(2, 2)``, no groups) leaves the model in one
process; the MoE then reads its dispatch groups from it, as the
reference's does.

The recurrent slots run the rank's share of each mixer
(:mod:`repro_torch.models.ssm`: Mamba's ``d_inner / mp`` channels, the
mLSTM's ``H / mp`` heads, the sLSTM's loop replicated on gathered
weights), entered through ``copy_to`` and summed over the model axis as
an attention block is; their states stay in the cache's layout.  The
patch projector's and the position tables' column blocks are put
together over the model axis (the residual stream is whole on every
rank); Whisper's encoder runs heads- and FFN-parallel; the decoder's
cross-attention runs the rank's heads, against the rank's kv heads in
training and prefill and, in decode, against the cache's ``cross_k`` /
``cross_v``, which split the encoder positions over the model axis for
every head (partials combined by log-sum-exp), or all of them on
every rank where the model axis does not divide ``enc_positions`` (the
cache's specs replicate them then; no combine).  The mLSTM runs every
head on every rank where the model axis does not divide its heads.  The
model axis must also divide Mamba's ``d_inner``, the sLSTM's inner
width and ``d_model`` where the patch projector or the position tables
split it.

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
from collections.abc import Mapping
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as SH
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
        # the meta device builds shapes only (steps.abstract_params)
        self.device = resolve_device(device, shapes_only=True)

    # ------------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None,
             keep: Optional[Callable[[str, torch.Tensor], torch.Tensor]]
             = None) -> Params:
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
        those over with :func:`repro_torch.convert.lm_params_from_numpy`.

        ``keep(path, leaf)``: what to keep of each leaf, by its
        ``/``-joined path (``"slots/0/attn/wq"``, the paths
        :func:`~repro_torch.distributed.sharding.param_spec` reads), as
        soon as it is drawn and before the next draw: a rank's block, so
        that a rank never holds the whole model.  Inside ``with
        torch.device("meta")`` on a meta LM the draws have shapes only
        (:func:`repro_torch.launch.steps.abstract_params`)."""
        cfg = self.cfg
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        dt = DTYPES[cfg.param_dtype]
        gdev = L.draw_device(gen)
        kept = keep if keep is not None else (lambda path, t: t)

        def normal(path, shape, std):
            return kept(path, torch.randn(shape, generator=gen, device=gdev)
                        .mul_(std).to(dt))

        d = cfg.d_model
        params: Params = {"embed": normal("embed", (cfg.vocab_padded, d),
                                          0.02),
                          "final_ln": _ones(d, (), gdev, kept, "final_ln")}
        if not cfg.tie_embeddings:
            params["head"] = normal("head", (d, cfg.vocab_padded),
                                    1 / math.sqrt(d))
        # each leaf drawn stacked over the repeats, as lax.scan reads them
        params["slots"] = [
            self._init_block(gen, kind, ffn_key(cfg, j), self.repeats, dt,
                             kept, f"slots/{j}")
            for j, kind in enumerate(self.pattern)]
        if cfg.enc_dec:
            params["enc_slots"] = [self._init_block(
                gen, "a", "mlp", cfg.enc_layers, dt, kept, "enc_slots/0")]
            params["pos_embed_enc"] = normal(
                "pos_embed_enc", (cfg.enc_positions, d), 0.02)
            params["pos_embed_dec"] = normal(
                "pos_embed_dec", (max(cfg.max_positions, 1), d), 0.02)
            params["enc_final_ln"] = _ones(d, (), gdev, kept, "enc_final_ln")
        if cfg.frontend == "patch":
            params["patch_proj"] = normal("patch_proj", (cfg.frontend_dim, d),
                                          1 / math.sqrt(cfg.frontend_dim))
        if gdev != self.device:
            params = _tree_map(lambda t: t.to(self.device), params)
        return params

    def _init_block(self, gen: torch.Generator, kind: str,
                    ffn: Optional[str], n: int, dt, kept, path: str
                    ) -> Params:
        """A block of mixer ``kind`` and FFN ``ffn`` (:func:`ffn_key`)
        stacked over ``n`` layers (the reference's ``_init_block``); in
        an encoder-decoder every attention block adds the cross-attention
        ``xattn`` (no qkv bias) and its norm ``lnx``.  ``kept(path,
        leaf)`` takes each leaf as it is drawn (:meth:`init`)."""
        cfg = self.cfg
        d, lead, dev = cfg.d_model, (n,), L.draw_device(gen)

        def under(name):
            return lambda leaf, t: kept(f"{path}/{name}/{leaf}", t)
        slot: Params = {"ln1": _ones(d, lead, dev, kept, f"{path}/ln1")}
        if kind == "a":
            slot["attn"] = L.init_attention(gen, d, cfg.n_heads,
                                            cfg.n_kv_heads, cfg.hd,
                                            cfg.qkv_bias, dt, lead=lead,
                                            keep=under("attn"))
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
        if kind != "a":
            name = MIXER[kind]
            slot[name] = {k: kept(f"{path}/{name}/{k}", t)
                          for k, t in slot[name].items()}
        if ffn is not None:
            slot["ln2"] = _ones(d, lead, dev, kept, f"{path}/ln2")
            if ffn == "mlp":
                slot[ffn] = L.init_mlp(gen, d, cfg.d_ff, dt, lead=lead,
                                       keep=under(ffn))
            else:
                slot[ffn] = L.init_moe(gen, d, cfg.d_ff, cfg.n_experts, dt,
                                       lead=lead, keep=under(ffn))
        if cfg.enc_dec and kind == "a":
            slot["xattn"] = L.init_attention(gen, d, cfg.n_heads,
                                             cfg.n_kv_heads, cfg.hd, False,
                                             dt, lead=lead,
                                             keep=under("xattn"))
            slot["lnx"] = _ones(d, lead, dev, kept, f"{path}/lnx")
        return slot

    def _ffn(self, p: Params, x: torch.Tensor, j: int,
             tp: Optional["_Tp"] = None) -> torch.Tensor:
        """Slot ``j``'s FFN on ``rms_norm(p["ln2"], x)``: the SwiGLU MLP,
        or in an MoE slot the top-k MoE; on a mesh (``tp``) the rank's
        slice of the FFN dim, summed over the model axis."""
        cfg = self.cfg
        h = L.rms_norm(p["ln2"], x)
        key = ffn_key(cfg, j)
        if key == "mlp":
            return _out_of(L.mlp(p[key], _into(h, tp)), tp)
        return L.moe(p[key], h, top_k=cfg.top_k, n_experts=cfg.n_experts,
                     capacity_factor=cfg.capacity_factor,
                     ep=key == "moe_ep",
                     groups=None if tp is None else tp.groups,
                     mesh=None if tp is None else tp.mesh)

    # ------------------------------------------------------------------
    def _cast_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` (the leaf under key ``name``) in the compute dtype,
        unless ``name`` is numerics-critical (``F32_KEEP``, every
        ``ln*``)."""
        if any(name == k or name.startswith("ln") for k in F32_KEEP):
            return t
        return t.to(DTYPES[self.cfg.compute_dtype])

    def _cast(self, params: Params) -> Params:
        """Cast params to the compute dtype, keeping numerics-critical
        leaves (``F32_KEEP``: norm scales, the router, Mamba's ``A_log``,
        ``D``, ``dt_bias``, the mLSTM's ``wif``/``bif``, the sLSTM's
        ``b``, every ``ln*`` scale) as they are; the rest, ``patch_proj``
        and ``pos_embed_*`` included, go to the compute dtype.  A leaf
        already in the compute dtype is returned as it is, so casting a
        cast tree costs nothing.  On a mesh the blocks are cast as they
        are read (:class:`_Blocks`), one leaf at a time."""
        def walk(tree, name=""):
            if isinstance(tree, dict):
                return {k: walk(v, k) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(v, name) for v in tree)
            return self._cast_leaf(name, tree)
        return walk(params)

    # ------------------------------------------------------------------
    def _tp(self, batch: int, params=None) -> Optional["_Tp"]:
        """The sharded run of a call on ``batch`` rows under the active
        mesh context, or None where it has no live mesh (one process).
        Refuses a model axis that does not divide a dim the param specs
        split into blocks: ``d_ff``, the padded vocabulary, the q and kv
        projections' columns (``n_heads*head_dim``,
        ``n_kv_heads*head_dim``), Mamba's ``d_inner``
        (``mamba_expand*d_model``), the sLSTM's ``slstm_inner_dim`` and
        ``d_model`` where the patch projector or the position tables
        split it.  Heads, kv heads and ``enc_positions`` that it does
        not divide run replicated over the model axis (module doc)."""
        mc = SH.current()
        mesh = SH.live_mesh(mc)
        if mesh is None:
            return None
        cfg = self.cfg
        if mc.strategy != "tp":
            raise NotImplementedError(
                f"mesh strategy {mc.strategy!r}: its rules are ported "
                "(param_specs), its execution is not; the LM runs 'tp'")
        dims = {name: getattr(cfg, name) for name in ("d_ff",
                                                       "vocab_padded")}
        if "a" in self.pattern or cfg.enc_dec:
            dims["n_heads*head_dim"] = cfg.n_heads * cfg.hd
            dims["n_kv_heads*head_dim"] = cfg.n_kv_heads * cfg.hd
        if "m" in self.pattern:
            dims["mamba_expand*d_model"] = cfg.mamba_expand * cfg.d_model
        if "s" in self.pattern:
            dims["slstm_inner_dim"] = S.slstm_inner_dim(
                cfg.d_model, cfg.n_heads, cfg.slstm_proj)
        if cfg.frontend == "patch" or cfg.enc_dec:
            dims["d_model"] = cfg.d_model
        for name, n in dims.items():
            if n % mesh.mp:
                raise ValueError(
                    f"{cfg.name}: the model axis of {mesh.mp} ranks does "
                    f"not divide {name} = {n}, which the param specs split "
                    "into blocks (the reference's params could not split "
                    "it either)")
        return _Tp(self, mc, mesh, batch, params)

    # ------------------------------------------------------------------
    def logits(self, params: Params, x: torch.Tensor,
               tp: Optional["_Tp"] = None) -> torch.Tensor:
        """f32 logits of ``x``, the padded vocabulary at -1e30; on a mesh
        the rank's vocab columns (``x`` replicated over the model
        axis)."""
        cfg = self.cfg
        head = (params["embed"].T if cfg.tie_embeddings
                else params["head"])
        lg = _into(x, tp) @ head
        lo = 0 if tp is None else tp.mesh.model_index * lg.shape[-1]
        pad_mask = torch.arange(lo, lo + lg.shape[-1],
                                device=lg.device) < cfg.vocab_size
        return lg.float().masked_fill(~pad_mask, -1e30)

    def embed(self, params: Params, tokens: torch.Tensor,
              tp: Optional["_Tp"] = None) -> torch.Tensor:
        """The tokens' embeddings; on a mesh each rank looks up the rows
        of its vocab block (zeros for the others' tokens) and the ranks
        sum over the model axis."""
        # F.embedding: its CUDA backward sums a token's rows in a fixed
        # order (sorted indices), so a training step is reproducible
        if tp is None:
            return F.embedding(tokens.long(), params["embed"])
        table = params["embed"]
        n = table.shape[0]
        idx = tokens.long() - tp.mesh.model_index * n
        inside = (idx >= 0) & (idx < n)
        x = F.embedding(idx.clamp(0, n - 1), table)
        x = x.masked_fill(~inside[..., None], 0)
        return SH.reduce_from(x, tp.mesh, "model")

    # ------------------------------------------------------------------
    # forward (train path)
    # ------------------------------------------------------------------
    def _block_train(self, p: Params, x: torch.Tensor, j: int,
                     use_rope: bool = True,
                     tp: Optional["_Tp"] = None) -> torch.Tensor:
        """Slot ``j``'s block, cache-free: its mixer by kind, then its
        FFN where it has one (on a mesh, the rank's heads and FFN
        slice)."""
        cfg, kind = self.cfg, self.pattern[j]
        h = L.rms_norm(p["ln1"], x)
        if kind == "a":
            out = self._self_attn(p["attn"], h, True, use_rope,
                                  cfg.sliding_window, tp)
        else:
            out, _ = self._recurrent(p, h, kind, None, tp)
        x = x + out
        if ffn_key(cfg, j) is not None:
            x = x + self._ffn(p, x, j, tp)
        return x

    def _recurrent(self, p: Params, h: torch.Tensor, kind: str, state,
                   tp: Optional["_Tp"] = None):
        """A Mamba / mLSTM / sLSTM mixer on the normed ``h``: (its
        output, the new state, None where ``state`` is None (training)).
        A decode step (one token against a state) of the mLSTM takes its
        recurrent form; on a mesh the rank's share
        (:mod:`repro_torch.models.ssm`), its output summed over the model
        axis."""
        cfg = self.cfg
        mesh = None if tp is None else tp.mesh
        h = _into(h, tp)
        if kind == "m":
            chunk = cfg.mamba_chunk
            if state is not None:
                chunk = min(chunk, max(h.shape[1], 1))
            out, new = S.mamba_forward(p["mamba"], h, state, chunk=chunk,
                                       mesh=mesh)
        elif kind == "x" and state is not None and h.shape[1] == 1:
            out, new = S.mlstm_recurrent(p["mlstm"], h, state,
                                         n_heads=cfg.n_heads, mesh=mesh)
        elif kind == "x":
            out, new = S.mlstm_chunkwise(p["mlstm"], h, state,
                                         n_heads=cfg.n_heads,
                                         chunk=cfg.mlstm_chunk, mesh=mesh)
        else:
            out, new = S.slstm_forward(p["slstm"], h, state, mesh=mesh)
        return _out_of(out, tp), new

    def _super_block(self, x: torch.Tensor, slot_ps,
                     tp: Optional["_Tp"] = None) -> torch.Tensor:
        """All slots of one repeat, in order (the reference's
        ``super_block``)."""
        for j, p in enumerate(slot_ps):
            x = self._block_train(p, x, j, tp=tp)
        return x

    def _backbone_train(self, params: Params, x: torch.Tensor,
                        tp: Optional["_Tp"] = None) -> torch.Tensor:
        """The repeats in order (the reference's ``lax.scan``), each
        repeat's super-block recomputed in the backward when
        ``cfg.remat == "block"`` (its collectives too, in the same order
        on every rank); then the final norm."""
        for r in range(self.repeats):
            ps = [_at(slot, r) for slot in params["slots"]]
            if self.cfg.remat == "block":
                x = checkpoint(self._super_block, x, ps, tp,
                               use_reentrant=False)
            else:
                x = self._super_block(x, ps, tp)
        return L.rms_norm(params["final_ln"], x)

    def _self_attn(self, p: Params, h: torch.Tensor, causal: bool,
                   use_rope: bool, window: Optional[int],
                   tp: Optional["_Tp"] = None) -> torch.Tensor:
        """Cache-free self-attention on the normed ``h``; on a mesh the
        rank's heads (or, where the model axis does not divide them,
        :func:`~repro_torch.models.layers.attention_tp`), summed over the
        model axis."""
        cfg = self.cfg
        kw = dict(head_dim=cfg.hd, rope_theta=cfg.rope_theta, window=window,
                  causal=causal, attn_block=cfg.attn_block,
                  use_rope=use_rope)
        if tp is not None and tp.uneven:
            return _out_of(L.attention_tp(
                p, _into(h, tp), tp.mesh, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, **kw), tp)
        hq, hk = _heads(cfg, tp)
        out, _ = L.attention(p, _into(h, tp), n_heads=hq, n_kv=hk, **kw)
        return _out_of(out, tp)

    def _attend(self, p: Params, x: torch.Tensor, causal: bool,
                tp: Optional["_Tp"] = None) -> torch.Tensor:
        """An encoder-decoder's cache-free self-attention (no rope); on a
        mesh the rank's heads, summed over the model axis."""
        return self._self_attn(p["attn"], x, causal, False, None, tp)

    def _cross(self, p: Params, x: torch.Tensor, cross_kv,
               tp: Optional["_Tp"] = None, split: bool = False
               ) -> torch.Tensor:
        """``x`` plus its cross-attention on ``cross_kv`` ((B, S_enc,
        Hkv, hd) K and V): ``lnx``, then ``xattn`` without rope.  On a
        mesh, the rank's heads against its kv heads' K/V
        (:meth:`_cross_kv`), or with ``split`` against the cache's block
        of the encoder positions for every head
        (:func:`~repro_torch.models.layers.cross_attention_cached_tp`);
        summed over the model axis."""
        cfg = self.cfg
        h = _into(L.rms_norm(p["lnx"], x), tp)
        if split:
            out = L.cross_attention_cached_tp(
                p["xattn"], h, *cross_kv, tp.mesh, n_heads=cfg.n_heads,
                head_dim=cfg.hd, split=tp.cross_split)
        elif tp is not None and tp.uneven:
            out = L.attention_tp(p["xattn"], h, tp.mesh,
                                 n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                                 head_dim=cfg.hd, rope_theta=cfg.rope_theta,
                                 cross_kv=cross_kv, use_rope=False)
        else:
            hq, hk = _heads(cfg, tp)
            out, _ = L.attention(p["xattn"], h, n_heads=hq, n_kv=hk,
                                 head_dim=cfg.hd, rope_theta=cfg.rope_theta,
                                 cross_kv=cross_kv, use_rope=False)
        return x + _out_of(out, tp)

    def _cross_kv(self, p: Params, enc: torch.Tensor,
                  tp: Optional["_Tp"] = None):
        """The encoder output's K and V for one decoder block's
        ``xattn``, (B, S_enc, Hkv, hd) each; on a mesh the rank's kv
        heads (``enc`` behind :func:`_into`), or every kv head where the
        model axis does not divide the heads."""
        cfg = self.cfg
        b, s, _ = enc.shape
        if tp is not None and tp.uneven:
            return tuple(t.reshape(b, s, cfg.n_kv_heads, cfg.hd)
                         for t in SH.whole_cols(
                             enc, [p["xattn"]["wk"], p["xattn"]["wv"]],
                             tp.mesh))
        hk = _heads(cfg, tp)[1]
        return tuple((enc @ p["xattn"][w]).reshape(b, s, hk, cfg.hd)
                     for w in ("wk", "wv"))

    def _positions(self, params: Params, name: str, rows: slice,
                   tp: Optional["_Tp"] = None) -> torch.Tensor:
        """Rows ``rows`` of the position table ``name`` (positions, d);
        on a mesh its column blocks gathered over the model axis, since
        they enter the residual stream every rank holds whole."""
        t = params[name][rows]
        if tp is None:
            return t
        return SH.gather_dim(t, tp.mesh, "model", -1, partial=False)

    def _encode(self, params: Params, x: torch.Tensor,
                frames: torch.Tensor, tp: Optional["_Tp"] = None
                ) -> torch.Tensor:
        """The encoder: ``frames`` (B, S_enc, d) plus ``pos_embed_enc``
        in ``x``'s dtype, the ``enc_layers`` non-causal blocks
        (self-attention, then the MLP), ``enc_final_ln``; on a mesh each
        block on the rank's heads and FFN slice."""
        enc = frames.to(x.dtype) + self._positions(
            params, "pos_embed_enc", slice(0, frames.shape[1]), tp
        )[None].to(x.dtype)
        for r in range(self.cfg.enc_layers):
            p = _at(params["enc_slots"][0], r)
            enc = enc + self._attend(p, L.rms_norm(p["ln1"], enc), False, tp)
            enc = enc + _out_of(L.mlp(p["mlp"], _into(
                L.rms_norm(p["ln2"], enc), tp)), tp)
        return L.rms_norm(params["enc_final_ln"], enc)

    def _front(self, params: Params, batch,
               tp: Optional["_Tp"] = None) -> Tuple[torch.Tensor, Any]:
        """The decoder's input (B, S, d) and, in an encoder-decoder, the
        encoder's output: the token embeddings, plus ``pos_embed_dec``
        at positions 0..S-1 in an encoder-decoder, or after the
        projected patches (``patch_embeds @ patch_proj``) with the patch
        frontend.  On a mesh, the rank's rows of the batch, the
        projected patches put together over the model axis
        (:func:`~repro_torch.distributed.sharding.cols_matmul`), and the
        encoder's output entering the rank's cross-attention heads."""
        cfg = self.cfg
        rows = slice(None) if tp is None else tp.rows
        x = self.embed(params, batch["inputs"][rows], tp)
        enc = None
        if cfg.enc_dec:
            enc = self._encode(params, x, batch["frame_embeds"][rows], tp)
            enc = _into(enc, tp)
            x = x + self._positions(params, "pos_embed_dec",
                                    slice(0, x.shape[1]), tp)[None].to(
                                        x.dtype)
        elif cfg.frontend == "patch":
            pe = batch["patch_embeds"][rows].to(x.dtype)
            if tp is None:
                pe = pe @ params["patch_proj"]
            else:
                pe = SH.cols_matmul(pe, params["patch_proj"], tp.mesh,
                                    [(0, cfg.d_model)], partial=False)[0]
            x = torch.cat([pe, x], 1)
        return x, enc

    def forward_train(self, params: Params,
                      batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits (B, S, V_pad) in f32 over the positions of
        ``batch["inputs"]``: the patches' positions are dropped, and an
        encoder-decoder's decoder attends to ``batch["frame_embeds"]``
        through its encoder.  On a mesh, the rank's block of them."""
        return self._forward_train(
            params, batch, self._tp(batch["inputs"].shape[0], params))

    def _forward_train(self, params: Params, batch, tp) -> torch.Tensor:
        cfg = self.cfg
        params = tp.blocks if tp is not None else self._cast(params)
        x, enc = self._front(params, batch, tp)
        if cfg.enc_dec:
            for r in range(self.repeats):
                p = _at(params["slots"][0], r)
                x = x + self._attend(p, L.rms_norm(p["ln1"], x), True, tp)
                x = self._cross(p, x, self._cross_kv(p, enc, tp), tp)
                x = x + _out_of(L.mlp(p["mlp"], _into(
                    L.rms_norm(p["ln2"], x), tp)), tp)
            x = L.rms_norm(params["final_ln"], x)
        else:
            x = self._backbone_train(params, x, tp)
            if cfg.frontend == "patch":
                x = x[:, cfg.n_patches:]
        return self.logits(params, x, tp)

    def loss(self, params: Params,
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["targets"]``.  On a
        mesh: the log-sum-exp and the gold logit summed over the model
        axis's vocab blocks, the rows' mean over the data axis; every
        rank returns the batch's loss (its gradients are those of its
        rows' share, which the train step sums over the data axis)."""
        tp = self._tp(batch["inputs"].shape[0], params)
        lg = self._forward_train(params, batch, tp)
        if tp is None:
            labels = batch["targets"].long()
            lse = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, labels[..., None])[..., 0]
            return torch.mean(lse - gold)
        mesh = tp.mesh
        labels = batch["targets"][tp.rows].long()
        top = mesh.all_reduce(lg.detach().amax(-1), "model", op="max")
        total = SH.reduce_from(torch.exp(lg - top[..., None]).sum(-1), mesh,
                               "model")
        lse = top + torch.log(total)
        n = lg.shape[-1]
        idx = labels - mesh.model_index * n
        inside = (idx >= 0) & (idx < n)
        gold = torch.gather(lg, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
        gold = SH.reduce_from(gold.masked_fill(~inside, 0), mesh, "model")
        loss = torch.mean(lse - gold)
        for axis in tp.mc.batch_axes:
            n = mesh.axis_size(axis)
            if n > 1:
                loss = SH.reduce_from(loss, mesh, axis) / n
        return loss

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def _slot_cache(self, kind: str, batch: int, max_len: int, dev=None):
        """One slot's cache stacked over the R repeats: the KV cache, or
        the recurrent state (Mamba's conv state in the compute dtype and
        its SSM state f32; the mLSTM's and sLSTM's f32, ``m`` at -1e30)."""
        cfg = self.cfg
        ct = DTYPES[cfg.compute_dtype]
        r, f32 = self.repeats, torch.float32
        dev = self.device if dev is None else dev

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
        :meth:`prefill` writes the encoder's K/V there.  On a mesh, this
        rank's blocks under ``cache_specs`` (``kpos`` whole), each leaf
        at its initial value (``m`` at -1e30)."""
        cfg = self.cfg
        tp = self._tp(batch)
        dev = self.device if tp is None else torch.device("meta")
        cache = {"pos": 0, "slots": [self._slot_cache(kind, batch, max_len,
                                                      dev)
                                     for kind in self.pattern]}
        if cfg.enc_dec:
            for name in ("cross_k", "cross_v"):
                cache[name] = torch.zeros(
                    (self.repeats, batch, cfg.enc_positions, cfg.n_kv_heads,
                     cfg.hd), dtype=DTYPES[cfg.compute_dtype], device=dev)
        if tp is not None:
            cache = _local_cache(cache, SH.cache_specs(cache, tp.mc),
                                 tp.mesh, self.device)
        return cache

    # ------------------------------------------------------------------
    # cached block (prefill S tokens or decode 1 token)
    # ------------------------------------------------------------------
    def _block_cached(self, p: Params, x, j: int, cache, pos, cross=None,
                      tp: Optional["_Tp"] = None, split: bool = False):
        """Slot ``j``'s block against its cache: the KV cache is written
        in place by ``attention_cached`` (on a mesh
        ``attention_cached_tp``, the rank's heads and ring slots); a
        recurrent block's new state (on a mesh, in the cache's layout)
        is copied into ``cache``'s tensors.  ``cross``: this repeat's
        cross K/V, attended after the self-attention (an
        encoder-decoder, whose attention takes no rope); ``split``: they
        are the cache's block of the encoder positions (a decode step on
        a mesh), else the rank's kv heads at every position."""
        cfg, kind = self.cfg, self.pattern[j]
        h = L.rms_norm(p["ln1"], x)
        if kind == "a":
            kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                      head_dim=cfg.hd, rope_theta=cfg.rope_theta,
                      window=cfg.sliding_window, attn_block=cfg.attn_block,
                      use_rope=not cfg.enc_dec)
            if tp is None:
                out, _ = L.attention_cached(p["attn"], h, cache, pos, **kw)
            else:
                out, _ = L.attention_cached_tp(p["attn"], _into(h, tp),
                                               cache, pos, tp.mesh, **kw)
                out = _out_of(out, tp)
            new = None
        else:
            out, new = self._recurrent(p, h, kind, cache, tp)
        if new is not None:
            for dst, src in zip(cache, new):
                dst.copy_(src)
        x = x + out
        if cross is not None and kind == "a":
            x = self._cross(p, x, cross, tp, split)
        if ffn_key(cfg, j) is not None:
            x = x + self._ffn(p, x, j, tp)
        return x

    def _run_cached(self, params: Params, x, cache,
                    tp: Optional["_Tp"] = None, fresh=None):
        """Run every slot of every repeat in order, each against its
        cache slice (views of the stacked cache, written in place), an
        encoder-decoder's against its repeat's cross K/V too: ``fresh``,
        the prefill's per repeat, else the cache's."""
        pos = cache["pos"]
        split = tp is not None and fresh is None
        for r in range(self.repeats):
            cross = None
            if fresh is not None:
                cross = fresh[r]
            elif self.cfg.enc_dec:
                cross = (cache["cross_k"][r], cache["cross_v"][r])
            for j in range(len(self.pattern)):
                p_r = _at(params["slots"][j], r)
                c_r = _tree_map(lambda t: t[r], cache["slots"][j])
                x = self._block_cached(p_r, x, j, c_r, pos, cross, tp,
                                       split)
        cache["pos"] = pos + x.shape[1]
        return x, cache

    # ------------------------------------------------------------------
    def prefill(self, params: Params, batch, cache):
        """Process a full prompt; returns (last-token logits, cache).  An
        encoder-decoder runs its encoder on ``batch["frame_embeds"]``
        and writes each repeat's cross K/V into the cache first (in
        place; tensors of another frame count are replaced); the patch
        frontend prefills the projected patches ahead of the text.  On a
        mesh: the whole batch in, the rank's blocks of the cache and of
        the logits."""
        tp = self._tp(batch["inputs"].shape[0], params)
        params = tp.blocks if tp is not None else self._cast(params)
        x, enc = self._front(params, batch, tp)
        fresh = None
        if enc is not None:
            fresh = [self._cross_kv(_at(params["slots"][0], r), enc, tp)
                     for r in range(self.repeats)]
            self._write_cross(cache, fresh, tp)
        x, cache = self._run_cached(params, x, cache, tp, fresh)
        x = L.rms_norm(params["final_ln"], x[:, -1:])
        return self.logits(params, x, tp), cache

    def _write_cross(self, cache, fresh, tp: Optional["_Tp"]) -> None:
        """Each repeat's cross K/V (``fresh``: (B, S_enc, Hkv, hd), on a
        mesh the rank's kv heads, or all of them where the model axis does
        not divide the heads) into the cache, in place (tensors of another
        frame count replaced).  On a mesh the rank's heads are gathered
        over the model axis (one call a layer), and the rank keeps its
        block of the encoder positions for every head, or all of them
        where the model axis does not divide ``enc_positions`` (the
        cache's specs replicate them then)."""
        cfg = self.cfg
        b, s_enc = fresh[0][0].shape[:2]
        w, mesh = s_enc, None if tp is None else tp.mesh
        if tp is not None and tp.cross_split:
            if s_enc % mesh.mp:
                raise ValueError(
                    f"{cfg.name}: the model axis of {mesh.mp} ranks does "
                    f"not divide the {s_enc} encoder frames, while it "
                    f"divides enc_positions = {cfg.enc_positions}")
            w = s_enc // mesh.mp
        heads = fresh[0][0].shape[2] < cfg.n_kv_heads   # the rank's only
        shape = (self.repeats, b, w, cfg.n_kv_heads, cfg.hd)
        for name in ("cross_k", "cross_v"):
            if tuple(cache[name].shape) != shape:
                cache[name] = cache[name].new_empty(shape)
        for r, (k, v) in enumerate(fresh):
            if heads or w < s_enc:
                kv = torch.cat([k, v], -1)
                if heads:
                    kv = mesh.all_gather(kv, "model", 2)
                if w < s_enc:
                    lo = mesh.model_index * w
                    kv = kv[:, lo:lo + w]
                k, v = kv.split(cfg.hd, -1)
            cache["cross_k"][r].copy_(k)
            cache["cross_v"][r].copy_(v)

    def decode_step(self, params: Params, batch, cache):
        """One-token step against the cache. batch['inputs']: (B, 1).  An
        encoder-decoder adds ``pos_embed_dec`` at ``pos``, clipped to
        ``max_positions - 1`` as the reference's.  On a mesh, as
        :meth:`prefill`."""
        cfg = self.cfg
        tp = self._tp(batch["inputs"].shape[0], params)
        params = tp.blocks if tp is not None else self._cast(params)
        tokens = batch["inputs"] if tp is None else batch["inputs"][tp.rows]
        x = self.embed(params, tokens, tp)
        if cfg.enc_dec:
            pos = min(max(cache["pos"], 0), cfg.max_positions - 1)
            x = x + self._positions(params, "pos_embed_dec",
                                    slice(pos, pos + 1), tp).to(x.dtype)
        x, cache = self._run_cached(params, x, cache, tp)
        x = L.rms_norm(params["final_ln"], x)
        return self.logits(params, x, tp), cache

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


class _Blocks(Mapping):
    """A rank's param blocks as the layers read them: each leaf, when
    read, is cast to the compute dtype (:meth:`LM._cast_leaf`) and put
    together over the data axis where its spec splits it there (FSDP,
    :func:`~repro_torch.distributed.sharding.gather_axis`, whose adjoint
    hands each rank its block's gradient), one leaf at a time; with
    ``r``, repeat ``r`` of the stacked leaves."""

    def __init__(self, tree, specs, use, r: Optional[int] = None):
        self._tree, self._specs, self._use, self._r = tree, specs, use, r

    def repeat(self, r: int) -> "_Blocks":
        return _Blocks(self._tree, self._specs, self._use, r)

    def __getitem__(self, key):
        v, s = self._tree[key], self._specs[key]
        if isinstance(v, dict):
            return _Blocks(v, s, self._use, self._r)
        if isinstance(v, (list, tuple)):
            return [_Blocks(t, u, self._use, self._r) for t, u in zip(v, s)]
        if self._r is not None:
            v, s = v[self._r], s[1:]
        return self._use(key, v, s)

    def __iter__(self):
        return iter(self._tree)

    def __len__(self):
        return len(self._tree)


class _Tp:
    """One sharded call: the mesh context, the rank's rows of a batch of
    ``batch`` (all of them where the batch axes do not divide it), the
    MoE's dispatch groups on those rows (one where each data rank holds
    its own rows: the mesh's groups, one per data rank), the rank's q
    and kv head counts (``uneven`` where the model axis does not divide
    both), whether Whisper's cross K/V cache splits its positions
    (``cross_split``), and ``blocks``, the params as the layers read
    them (:class:`_Blocks`)."""

    def __init__(self, lm: LM, mc, mesh, batch: int, params=None):
        self.mc, self.mesh = mc, mesh
        entry = SH.constrain((batch,), "batch", mc=mc)[0]
        blocks, idx = SH._entry_split(mesh, entry)
        n = batch // blocks
        self.rows = slice(idx * n, (idx + 1) * n)
        self.groups = 1 if entry is not None else None
        cfg = lm.cfg
        self.uneven = not L.heads_divide(cfg.n_heads, cfg.n_kv_heads,
                                         mesh.mp)
        self.hq = cfg.n_heads // mesh.mp
        self.hk = cfg.n_kv_heads // mesh.mp
        # Whisper's cross K/V cache: the encoder positions split over the
        # model axis where it divides them, else whole on every rank
        self.cross_split = bool(cfg.enc_dec and mesh.mp > 1
                                and cfg.enc_positions % mesh.mp == 0)
        self.blocks = None
        if params is not None:
            use = (lambda name, t, spec: SH.gather_axis(
                lm._cast_leaf(name, t), spec, mesh, "data"))
            self.blocks = _Blocks(params, SH.param_specs(params, mc), use)


def _heads(cfg: ArchConfig, tp: Optional[_Tp]) -> Tuple[int, int]:
    """The q and kv heads a call runs: all, or on a mesh the rank's."""
    return ((cfg.n_heads, cfg.n_kv_heads) if tp is None
            else (tp.hq, tp.hk))


def _local_cache(tree, specs, mesh, device, name: str = ""):
    """This rank's blocks of a cache of meta tensors under ``specs``,
    each at its leaf's initial value: -1 for the int32 ``kpos``, -1e30
    for a state's ``m``, else zeros."""
    if isinstance(tree, dict):
        return {k: _local_cache(v, specs[k], mesh, device, k)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_local_cache(v, s, mesh, device, k)
                            for k, v, s in zip(tree._fields, tree, specs)))
    if isinstance(tree, list):
        return [_local_cache(v, s, mesh, device, name)
                for v, s in zip(tree, specs)]
    if not isinstance(tree, torch.Tensor):
        return tree
    fill = (-1 if tree.dtype == torch.int32 else
            S.NEG if name == "m" else 0)
    return torch.full(SH.local_shape(tree.shape, specs, mesh), fill,
                      dtype=tree.dtype, device=device)


def _into(h: torch.Tensor, tp: Optional[_Tp]) -> torch.Tensor:
    """``h`` entering a block's per-rank heads or FFN slice (Megatron's
    ``f``: identity, its adjoint summed over the model axis)."""
    return h if tp is None else SH.copy_to(h, tp.mesh, "model")


def _out_of(y: torch.Tensor, tp: Optional[_Tp]) -> torch.Tensor:
    """A block's per-rank partial output summed over the model axis
    (Megatron's ``g``)."""
    return y if tp is None else SH.reduce_from(y, tp.mesh, "model")


def _at(slot, r: int):
    """Repeat ``r`` of a slot's stacked params."""
    if isinstance(slot, _Blocks):
        return slot.repeat(r)
    return _tree_map(lambda t: t[r], slot)


def _ones(d: int, lead, device, kept=None, path: str = "") -> Params:
    t = torch.ones((*lead, d), device=device)
    return {"scale": t if kept is None else kept(f"{path}/scale", t)}


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

"""Transformer building blocks of the attention decoders, in PyTorch.

The port of the JAX package's ``models/layers.py`` (attention, the
SwiGLU MLP and the top-k MoE), with its names, parameter dicts and
layouts: activations ``(B, S, H, D)``, weights ``(d_in, d_out)`` so that
``x @ w`` matches.

On a mesh (:mod:`repro_torch.distributed.sharding`) the LM hands these
functions its rank's blocks and its heads: ``attention`` runs on the
rank's ``H/mp`` q and ``Hkv/mp`` kv heads as it runs on all of them,
and the callers sum the partial outputs of ``wo`` and ``wd`` over the
model axis.  :func:`attention_cached_tp` keeps the reference's KV cache
layout, each model rank holding a contiguous ``W/mp`` of the ring's
slots for every kv head: prefill writes the rank's slots from the
gathered K/V, decode gathers q and attends each rank's slots for every
head, and the ranks combine their partials by log-sum-exp
(FlashDecoding).  :func:`moe` runs its experts' FFN dim split over the
model axis (the layout the reference's rules give both MoE kinds).
Where the model axis does not divide the heads (:func:`attention_tp`),
the reference's ``constrain`` replicates them: each rank gets every kv
head, and every q head too where those do not divide, by one gather
(:func:`qkv_tp`), and keeps its columns of the output for its rows of
``wo``.  The reference's ``constrain`` calls have no op here: the split a
tensor takes follows from the blocks the LM passes in.

Long-sequence attention (:func:`blockwise_attention`) calls K5,
:func:`repro_torch.kernels.flash_attn.flash_attention`, when its
arguments are inside K5's contract (causal, no window, ``q_offset == 0``,
every key valid, ``Sq == Sk``: the serving prefill) and no gradient is
asked of them, and otherwise runs the plain scan, a restatement of the
reference's ``lax.scan``.  K5 has no backward (nor has the reference's
Pallas kernel, whose training path runs the scan): with grad mode on and
q, k or v requiring grad, the scan runs, so training past 2,048 tokens
never reaches K5.  The choice depends on the arguments and the grad mode
alone.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as SH
from repro_torch.kernels.flash_attn import flash_attention

Params = Dict[str, Any]
Keep = Optional[Callable[[str, torch.Tensor], torch.Tensor]]


def draw_device(gen: torch.Generator) -> torch.device:
    """Where ``gen``'s draws land: the meta device inside ``with
    torch.device("meta")`` (a shape-only build, the torch form of
    ``jax.eval_shape``), else the generator's own device."""
    if torch.get_default_device().type == "meta":
        return torch.device("meta")
    return gen.device


def _kept(keep: Keep):
    """``keep`` (applied to each leaf, by name, right after it is
    drawn), or the identity."""
    return keep if keep is not None else (lambda name, t: t)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (xf * p["scale"].float()).to(dt)


def _dense_init(gen: torch.Generator, fan_in: int, shape,
                dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=draw_device(gen))
    return w.mul_(1 / math.sqrt(fan_in)).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 1e4) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given integer positions: (..., head_dim//2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2) or (B, S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional bias / sliding window / KV cache)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, qkv_bias: bool, dtype,
                   lead: Tuple[int, ...] = (), keep: Keep = None) -> Params:
    """``lead``: leading dims of every leaf, e.g. ``(n_layers,)`` to draw
    a stack of layers at once; ``keep(name, leaf)``: what to keep of
    each leaf as it is drawn (a rank's block), before the next draw."""
    hq, hk = n_heads * head_dim, n_kv * head_dim
    k = _kept(keep)
    p = {}
    for name, fan_in, shape in (("wq", d_model, (d_model, hq)),
                                ("wk", d_model, (d_model, hk)),
                                ("wv", d_model, (d_model, hk)),
                                ("wo", hq, (hq, d_model))):
        p[name] = k(name, _dense_init(gen, fan_in, (*lead, *shape), dtype))
    if qkv_bias:
        z = dict(dtype=dtype, device=draw_device(gen))
        for name, n in (("bq", hq), ("bk", hk), ("bv", hk)):
            p[name] = k(name, torch.zeros((*lead, n), **z))
    return p


def _gqa_scores_combine(q, k, v, mask, compute_dtype):
    """Plain (quadratic) attention used for short sequences.

    q: (B,Sq,Hq,D), k/v: (B,Sk,Hkv,D); mask: (B?,Sq,Sk) bool."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf / math.sqrt(d), k.float())
    s = s.masked_fill(~mask[:, None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(compute_dtype)


def _in_k5_contract(q, k, causal, window, q_offset, kv_len) -> bool:
    return (causal and window is None and int(q_offset) == 0
            and kv_len is None and q.shape[1] == k.shape[1])


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def blockwise_attention(q, k, v, *, causal: bool, window: Optional[int],
                        q_offset, kv_len=None,
                        block: int = 1024) -> torch.Tensor:
    """Memory-efficient (flash-style) attention: running (max, sum, acc)
    over KV blocks, activations O(S·D) instead of O(S^2).

    q: (B,Sq,Hq,D); k,v: (B,Sk,Hkv,D); q_offset: absolute position of
    q[0] (for decode); kv_len: valid kv length (None = all).  Inside K5's
    contract, with no gradient asked of q, k or v, the attention is one
    K5 launch on the transposed views, returned in ``q.dtype``;
    otherwise the plain, differentiable scan over blocks of ``block``
    keys, returned in f32 as the reference's.
    """
    if (_in_k5_contract(q, k, causal, window, q_offset, kv_len)
            and not _wants_grad(q, k, v)):
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True)
        return o.transpose(1, 2)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    nblk = -(-sk // block)
    pad = nblk * block - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    qf = (q.reshape(b, sq, hkv, g, d) / math.sqrt(d)).float()
    qpos = int(q_offset) + torch.arange(sq, device=dev)
    kv_valid = sk if kv_len is None else int(kv_len)
    m = torch.full((b, hkv, g, sq), float("-inf"), device=dev)
    l = torch.zeros((b, hkv, g, sq), device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), device=dev)
    for idx in range(nblk):
        blk = slice(idx * block, (idx + 1) * block)
        kpos = idx * block + torch.arange(block, device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k[:, blk].float())
        msk = kpos[None, :] < kv_valid
        if causal:
            msk = msk & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            msk = msk & (kpos[None, :] > qpos[:, None] - window)
        s = s.masked_fill(~msk, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, v[:, blk].float())
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


def _qkv(p, x, n_heads, n_kv, head_dim):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, n_heads, head_dim),
            k.reshape(b, s, n_kv, head_dim),
            v.reshape(b, s, n_kv, head_dim))


def attention(p: Params, x: torch.Tensor, *, n_heads: int, n_kv: int,
              head_dim: int, rope_theta: float,
              window: Optional[int] = None, causal: bool = True,
              cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              positions: Optional[torch.Tensor] = None,
              attn_block: int = 1024, use_rope: bool = True,
              use_blockwise: Optional[bool] = None,
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Cache-free attention (train / encoder / cross).

    Returns (output (B,S,d_model), (k, v) computed this call).  Past
    2,048 keys (or with ``use_blockwise``) :func:`blockwise_attention`,
    else the quadratic masked path.  The reference's sharding
    constraints on q, k and o have no counterpart on one card."""
    b, s, _ = x.shape
    if cross_kv is not None:
        q = x @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        q = q.reshape(b, s, n_heads, head_dim)
        k, v = cross_kv
        causal = False
    else:
        q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
        if use_rope:
            if positions is None:
                positions = torch.arange(s, device=x.device)
            cos, sin = rope_tables(positions, head_dim, rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

    o = _attend(q, k, v, causal=causal, window=window,
                attn_block=attn_block, use_blockwise=use_blockwise,
                dtype=x.dtype)
    out = o.to(x.dtype).reshape(b, s, n_heads * head_dim) @ p["wo"]
    return out, (k, v)


def _attend(q, k, v, *, causal: bool, window: Optional[int],
            attn_block: int, use_blockwise: Optional[bool],
            dtype) -> torch.Tensor:
    """The attention of :func:`attention` on its q (B, Sq, H, D) and k /
    v (B, Sk, Hkv, D): past 2,048 keys (or with ``use_blockwise``)
    :func:`blockwise_attention`, else the quadratic masked path, its
    mask aligned at the ends."""
    if use_blockwise is None:
        use_blockwise = k.shape[1] > 2048
    if use_blockwise:
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   q_offset=0, kv_len=None,
                                   block=attn_block)
    dev = q.device
    sq, sk = q.shape[1], k.shape[1]
    qpos = (sk - sq) + torch.arange(sq, device=dev)
    kpos = torch.arange(sk, device=dev)
    msk = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        msk &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        msk &= kpos[None, :] > qpos[:, None] - window
    return _gqa_scores_combine(q, k, v, msk[None], dtype)


# ---------------------------------------------------------------------------
# Heads a model axis does not divide (40 heads, or 8 kv heads, on 16
# ranks): the reference's constrain degrades them to replicated.
# ---------------------------------------------------------------------------

def heads_divide(n_heads: int, n_kv: int, mp: int) -> bool:
    """Whether ``mp`` model ranks divide both the q and the kv heads (the
    layout where each rank runs its own heads)."""
    return n_heads % mp == 0 and n_kv % mp == 0


def qkv_tp(p: Params, x: torch.Tensor, mesh: SH.Mesh, *, n_heads: int,
           n_kv: int, head_dim: int, q_whole: bool):
    """q, k, v (B, S, heads, D) on a model rank where ``mesh`` does not
    divide the heads: k and v for every kv head, and q for every head
    (``q_whole``) or for the rank's ``n_heads / mp`` (its own columns of
    ``wq``, whole heads where the q heads divide).  The whole ones come
    from the rank's column blocks of ``wq`` / ``wk`` / ``wv`` by one
    gather of the smaller of the weights and the products
    (:func:`~repro_torch.distributed.sharding.whole_cols`), the biases'
    blocks by one more."""
    b, s, _ = x.shape
    ws = ([p["wq"]] if q_whole else []) + [p["wk"], p["wv"]]
    outs = SH.whole_cols(x, ws, mesh)
    q = outs[0] if q_whole else x @ p["wq"]
    k, v = outs[-2:]
    if "bq" in p:
        bs = [p["bq"]] if q_whole else []
        bw = SH.whole_blocks(bs + [p["bk"], p["bv"]], mesh)
        q = q + (bw[0] if q_whole else p["bq"])
        k, v = k + bw[-2], v + bw[-1]
    hq = n_heads if q_whole else n_heads // mesh.mp
    return (q.reshape(b, s, hq, head_dim), k.reshape(b, s, n_kv, head_dim),
            v.reshape(b, s, n_kv, head_dim))


def kv_for_heads(k: torch.Tensor, v: torch.Tensor, lo: int, hq: int,
                 n_heads: int):
    """The kv heads that q heads ``lo .. lo + hq`` read (q head h reads
    kv head ``h // (n_heads / n_kv)``), from k / v (B, S, n_kv, D) of
    every kv head: a contiguous run where each of them serves the same
    number of the rank's q heads (2 q / 1 kv on StableLM-2-12B at 16
    ranks), else one kv head per q head."""
    g = n_heads // k.shape[2]
    idx = [h // g for h in range(lo, lo + hq)]
    first, nk = idx[0], idx[-1] - idx[0] + 1
    if hq % nk == 0 and idx == [first + i // (hq // nk) for i in range(hq)]:
        return k.narrow(2, first, nk), v.narrow(2, first, nk)
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def own_cols(o: torch.Tensor, width: int, mesh: SH.Mesh) -> torch.Tensor:
    """This model rank's contiguous ``width`` columns of ``o`` (..., H·D),
    every head's output: the rows of ``wo`` the rank holds."""
    return o.narrow(-1, mesh.model_index * width, width)


def attention_tp(p: Params, x: torch.Tensor, mesh: SH.Mesh, *,
                 n_heads: int, n_kv: int, head_dim: int,
                 rope_theta: float, window: Optional[int] = None,
                 causal: bool = True,
                 cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]]
                 = None, attn_block: int = 1024,
                 use_rope: bool = True) -> torch.Tensor:
    """:func:`attention` on a model rank whose mesh does not divide the
    heads (``p`` the rank's blocks; ``n_heads`` / ``n_kv`` the whole
    model's; ``cross_kv`` every kv head's K / V).  Where the q heads
    divide, the rank runs its own q heads against the kv heads they
    read; else every rank runs every head (the reference's
    degrade-to-replicated: the attention's work is ``mp`` times
    redundant) and keeps its columns of the output.  Returns this rank's
    partial of the output projection (its rows of ``wo``)."""
    b, s, _ = x.shape
    q_whole = n_heads % mesh.mp != 0
    if cross_kv is not None:
        if q_whole:
            q = SH.whole_cols(x, [p["wq"]], mesh)[0]
            if "bq" in p:
                q = q + SH.whole_blocks([p["bq"]], mesh)[0]
        else:
            q = x @ p["wq"]
            if "bq" in p:
                q = q + p["bq"]
        q = q.reshape(b, s, -1, head_dim)
        k, v = cross_kv
        causal = False
    else:
        q, k, v = qkv_tp(p, x, mesh, n_heads=n_heads, n_kv=n_kv,
                         head_dim=head_dim, q_whole=q_whole)
        if use_rope:
            cos, sin = rope_tables(torch.arange(s, device=x.device),
                                   head_dim, rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
    if not q_whole:
        hq = q.shape[2]
        k, v = kv_for_heads(k, v, mesh.model_index * hq, hq, n_heads)
    o = _attend(q, k, v, causal=causal, window=window,
                attn_block=attn_block, use_blockwise=None, dtype=x.dtype)
    o = o.to(x.dtype).reshape(b, s, -1)
    if q_whole:
        o = own_cols(o, p["wo"].shape[0], mesh)
    return o @ p["wo"]


def attention_cached(p: Params, x: torch.Tensor, cache: dict, pos: int, *,
                     n_heads: int, n_kv: int, head_dim: int,
                     rope_theta: float, window: Optional[int] = None,
                     attn_block: int = 1024,
                     use_rope: bool = True) -> Tuple[torch.Tensor, dict]:
    """Attention against a (possibly ring) KV cache.

    cache = {'k': (B, W, Hkv, D), 'v': ..., 'kpos': (W,) int32 absolute
    positions, -1 = empty}, updated IN PLACE (the reference returns a new
    one; the port writes the slots it changes and returns the same dict).
    ``pos`` is the absolute position of x[:, 0].
    * S == 1: decode — write one slot (ring index pos % W), quadratic
      attend with explicit position masking.
    * S > 1: prefill — full causal attention over the fresh K/V
      (:func:`blockwise_attention` past 2048 tokens, so K5 in serving),
      then the *last W tokens* are written to the cache (requires S % W
      == 0 when S > W, as the reference).
    """
    b, s, _ = x.shape
    w = cache["k"].shape[1]
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim)
    positions = pos + torch.arange(s, device=x.device)
    if use_rope:
        cos, sin = rope_tables(positions, head_dim, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    kd = k.to(cache["k"].dtype)
    vd = v.to(cache["v"].dtype)

    if s == 1:
        idx = pos % w
        cache["k"][:, idx] = kd[:, 0]
        cache["v"][:, idx] = vd[:, 0]
        cache["kpos"][idx] = pos
        qpos = positions[:, None]                       # (1,1)
        kpos = cache["kpos"]
        msk = (kpos[None, :] >= 0) & (kpos[None, :] <= qpos)
        if window is not None:
            msk = msk & (kpos[None, :] > qpos - window)
        o = _gqa_scores_combine(q, cache["k"], cache["v"], msk[None],
                                x.dtype)
    else:
        if s > 2048:
            o = blockwise_attention(q, k, v, causal=True, window=window,
                                    q_offset=0, kv_len=None,
                                    block=attn_block)
        else:
            o = _gqa_scores_combine(q, k, v, _causal_mask(
                s, window, x.device)[None], x.dtype)
        if s >= w:
            assert s % w == 0 or s == w, (s, w)
            cache["k"].copy_(kd[:, -w:])
            cache["v"].copy_(vd[:, -w:])
            cache["kpos"].copy_(positions[-w:])
        else:
            # lax.dynamic_update_slice clamps the start so the slice fits
            start = min(max(pos, 0), w - s)
            cache["k"][:, start:start + s] = kd
            cache["v"][:, start:start + s] = vd
            cache["kpos"][start:start + s] = positions

    out = o.to(x.dtype).reshape(b, s, n_heads * head_dim) @ p["wo"]
    return out, cache


def _slot_partials(q, k, v, mask):
    """Attention of q (B, Sq, Hq, D) on these K/V slots (B, Sk, Hkv, D)
    without the softmax's division: the scores' max ``m`` and the sum
    ``l`` of ``exp(s - m)`` (B, Sq, Hq) and ``exp(s - m) @ v``
    (B, Sq, Hq, D), f32; masked slots score -1e30 as in
    :func:`_gqa_scores_combine`."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qf = q.reshape(b, sq, hkv, hq // hkv, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf / math.sqrt(d), k.float())
    s = s.masked_fill(~mask[:, None, None], -1e30)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).reshape(b, sq, hq, d)

    def heads_last(t):                       # (b, hkv, g, sq) -> (b, sq, hq)
        return t.permute(0, 3, 1, 2).reshape(b, sq, hq)
    return o, heads_last(m), heads_last(p.sum(-1))


def _combine_partials(o, m, l, mesh: SH.Mesh, split: bool) -> torch.Tensor:
    """The softmax-weighted output (B, Sq, H, D) from :func:`_slot_partials`'
    ``(o, max, sum)``: where the slots are ``split`` over the model axis,
    the ranks' partials are gathered (one call) and combined by
    log-sum-exp."""
    if split:
        b, sq, h, d = o.shape
        pk = mesh.all_gather(torch.cat([o.reshape(b, sq, -1), m, l],
                                       -1)[None], "model", 0)
        o_r, m_r, l_r = pk.split([h * d, h, h], -1)
        top = m_r.amax(0)
        wgt = torch.exp(m_r - top)
        l = (wgt * l_r).sum(0)
        o = (o_r.reshape(mesh.mp, b, sq, h, d) * wgt[..., None]).sum(0)
    return o / torch.clamp_min(l, 1e-30)[..., None]


def cross_attention_cached_tp(p: Params, x: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, mesh: SH.Mesh, *,
                              n_heads: int, head_dim: int,
                              split: bool = True) -> torch.Tensor:
    """Cross-attention of ``x`` (B, S, d) on a model rank against the
    cache's ``cross_k`` / ``cross_v`` block: with ``split``, ``k`` / ``v``
    (B, W/mp, Hkv, D) hold the rank's contiguous W/mp of the encoder's
    positions for every kv head, else all W of them (a model axis that
    does not divide W: the cache replicates them, as the reference's
    specs do); ``p`` holds the rank's blocks of ``xattn``.  As
    :func:`attention_cached_tp`'s decode: q of every head (the rank's
    heads gathered over the model axis, or :func:`qkv_tp`'s whole q
    where the axis does not divide the heads), every rank attends its
    positions for every head (no mask), the partials combined by
    log-sum-exp where they are split, and the rank keeps its columns
    for ``wo``.  Returns this rank's partial of the output
    projection."""
    mi = mesh.model_index
    b, s, _ = x.shape
    if n_heads % mesh.mp == 0:
        hq = n_heads // mesh.mp
        q = x @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        q_all = mesh.all_gather(q.reshape(b, s, hq, head_dim), "model", 2)
    else:
        q_all = SH.whole_cols(x, [p["wq"]], mesh)[0]
        if "bq" in p:
            q_all = q_all + SH.whole_blocks([p["bq"]], mesh)[0]
        q_all = q_all.reshape(b, s, n_heads, head_dim)
    w_loc = k.shape[1]
    msk = torch.ones((1, s, w_loc), dtype=torch.bool, device=x.device)
    o, m, l = _slot_partials(q_all, k, v, msk)
    o = _combine_partials(o, m, l, mesh, split and mesh.mp > 1)
    if n_heads % mesh.mp == 0:
        o = o[:, :, mi * hq:(mi + 1) * hq].to(x.dtype)
        return o.reshape(b, s, hq * head_dim) @ p["wo"]
    o = own_cols(o.to(x.dtype).reshape(b, s, -1), p["wo"].shape[0], mesh)
    return o @ p["wo"]


def attention_cached_tp(p: Params, x: torch.Tensor, cache: dict, pos: int,
                        mesh: SH.Mesh, *, n_heads: int, n_kv: int,
                        head_dim: int, rope_theta: float,
                        window: Optional[int] = None, attn_block: int = 1024,
                        use_rope: bool = True) -> Tuple[torch.Tensor, dict]:
    """:func:`attention_cached` on a model rank (tensor parallel): ``p``
    holds the rank's heads (``wq``/``wk``/``wv`` columns, ``wo`` rows;
    ``n_heads`` / ``n_kv`` are the whole model's), ``cache`` the rank's
    block of the KV cache under :func:`~repro_torch.distributed.sharding.
    cache_specs`: ``k``/``v`` (B, W/mp, Hkv, D), the rank's contiguous
    W/mp of the ring's slots for every kv head (all W where mp does not
    divide W), and ``kpos`` (W,) whole.  Returns this rank's partial of
    the output projection (the caller sums it over the model axis) and
    the cache, updated in place.

    * prefill: attention on the rank's heads over the fresh K/V
      (:func:`blockwise_attention`, so K5, past 2,048 tokens); the K/V
      gathered over the model axis, the rank writes the positions that
      land in its slots.
    * decode: q, k and v gathered over the model axis in one call; the
      rank that owns slot ``pos % W`` writes the new token; every rank
      attends its slots for every head, the ranks' partials are combined
      by log-sum-exp (one gather of ``(o, max, sum)``), and the rank
      keeps its heads for ``wo``.

    Where the model axis does not divide the q or the kv heads, the
    rank's column blocks of ``wq`` / ``wk`` / ``wv`` are not whole heads:
    :func:`qkv_tp` gives every kv head (and q of every head to decode,
    or where the q heads do not divide) by one gather, so the cache
    writes need none; a prefill runs the rank's q heads against the kv
    heads they read (:func:`kv_for_heads`), or every head where the q
    heads do not divide, and the rank keeps its columns of the output
    (:func:`own_cols`).
    """
    mp, mi = mesh.mp, mesh.model_index
    b, s, _ = x.shape
    w, w_loc = cache["kpos"].shape[0], cache["k"].shape[1]
    lo = mi * w_loc if w_loc < w else 0
    even = heads_divide(n_heads, n_kv, mp)
    if even:
        hq, hk = n_heads // mp, n_kv // mp
        q, k, v = _qkv(p, x, hq, hk, head_dim)
    else:
        # every kv head; q of every head to decode (each rank attends its
        # slots for every head) or where the q heads do not divide
        q_whole = s == 1 or n_heads % mp != 0
        q, k, v = qkv_tp(p, x, mesh, n_heads=n_heads, n_kv=n_kv,
                         head_dim=head_dim, q_whole=q_whole)
    positions = pos + torch.arange(s, device=x.device)
    if use_rope:
        cos, sin = rope_tables(positions, head_dim, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    kd = k.to(cache["k"].dtype)
    vd = v.to(cache["v"].dtype)

    if s == 1:
        if even:
            qkv = mesh.all_gather(torch.cat(
                [q.reshape(b, 1, -1), kd.reshape(b, 1, -1).to(q.dtype),
                 vd.reshape(b, 1, -1).to(q.dtype)], -1), "model", 1)
            parts = qkv.reshape(b, mp, -1).split(
                [hq * head_dim, hk * head_dim, hk * head_dim], -1)
            q_all, k_all, v_all = (t.reshape(b, 1, -1, head_dim)
                                   for t in parts)
        else:
            q_all, k_all, v_all = q, kd, vd
        idx = pos % w
        cache["kpos"][idx] = pos
        if lo <= idx < lo + w_loc:
            cache["k"][:, idx - lo] = k_all[:, 0].to(cache["k"].dtype)
            cache["v"][:, idx - lo] = v_all[:, 0].to(cache["v"].dtype)
        kpos = cache["kpos"][lo:lo + w_loc]
        qpos = positions[:, None]
        msk = (kpos[None, :] >= 0) & (kpos[None, :] <= qpos)
        if window is not None:
            msk = msk & (kpos[None, :] > qpos - window)
        o, m, l = _slot_partials(q_all, cache["k"], cache["v"], msk[None])
        o = _combine_partials(o, m, l, mesh, w_loc < w)
        if even:
            o = o[:, :, mi * hq:(mi + 1) * hq].to(x.dtype)
        else:
            o = own_cols(o.to(x.dtype).reshape(b, 1, -1), p["wo"].shape[0],
                         mesh)
    else:
        ks, vs = k, v
        if not even and not q_whole:
            ks, vs = kv_for_heads(k, v, mi * q.shape[2], q.shape[2],
                                  n_heads)
        if s > 2048:
            o = blockwise_attention(q, ks, vs, causal=True, window=window,
                                    q_offset=0, kv_len=None,
                                    block=attn_block)
        else:
            o = _gqa_scores_combine(q, ks, vs, _causal_mask(
                s, window, x.device)[None], x.dtype)
        if not even and q_whole:
            o = own_cols(o.to(x.dtype).reshape(b, s, -1), p["wo"].shape[0],
                         mesh)
        # the positions that land in the ring (the last W), every kv
        # head of them; this rank keeps its slots
        tail = max(s - w, 0)
        if even:
            kv = mesh.all_gather(torch.cat([kd, vd], -1)[:, tail:], "model",
                                 2)
            k_all, v_all = kv[..., :head_dim], kv[..., head_dim:]
        else:
            k_all, v_all = kd[:, tail:], vd[:, tail:]
        if s >= w:
            assert s % w == 0 or s == w, (s, w)
            cache["k"].copy_(k_all[:, lo:lo + w_loc])
            cache["v"].copy_(v_all[:, lo:lo + w_loc])
            cache["kpos"].copy_(positions[-w:])
        else:
            start = min(max(pos, 0), w - s)
            a, e = max(start, lo), min(start + s, lo + w_loc)
            if a < e:
                cache["k"][:, a - lo:e - lo] = k_all[:, a - start:e - start]
                cache["v"][:, a - lo:e - lo] = v_all[:, a - start:e - start]
            cache["kpos"][start:start + s] = positions

    out = o.to(x.dtype).reshape(b, s, -1) @ p["wo"]
    return out, cache


def _causal_mask(s: int, window: Optional[int],
                 device=None) -> torch.Tensor:
    i = torch.arange(s, device=device)
    msk = i[None, :] <= i[:, None]
    if window is not None:
        msk &= i[None, :] > i[:, None] - window
    return msk


# ---------------------------------------------------------------------------
# Feed-forward: SwiGLU dense
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             lead: Tuple[int, ...] = (), keep: Keep = None) -> Params:
    k = _kept(keep)
    return {name: k(name, _dense_init(gen, fan_in, (*lead, *shape), dtype))
            for name, fan_in, shape in (("wg", d_model, (d_model, d_ff)),
                                        ("wu", d_model, (d_model, d_ff)),
                                        ("wd", d_ff, (d_ff, d_model)))}


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


# ---------------------------------------------------------------------------
# Feed-forward: top-k MoE
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype, lead: Tuple[int, ...] = (), keep: Keep = None) -> Params:
    """The router ``(d, E)``, always f32 (as the reference draws it), and
    the experts' SwiGLU weights ``wg``/``wu`` ``(E, d, ff)`` and ``wd``
    ``(E, ff, d)`` in ``dtype``; every leaf stacked over ``lead``."""
    e, k = n_experts, _kept(keep)
    return {name: k(name, _dense_init(gen, fan_in, (*lead, *shape), dt))
            for name, fan_in, shape, dt in (
                ("router", d_model, (d_model, e), torch.float32),
                ("wg", d_model, (e, d_model, d_ff), dtype),
                ("wu", d_model, (e, d_model, d_ff), dtype),
                ("wd", d_ff, (e, d_ff, d_model), dtype))}


@contextlib.contextmanager
def _ieee_matmul():
    """cuBLAS's TF32 off inside the block, the caller's setting after."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    mm.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32 = prev


class _RouterLogits(torch.autograd.Function):
    """``x @ w`` on f32 operands in full f32, forward and backward,
    whatever the caller's TF32 setting: one TF32 rounding of a router
    logit can flip a token's expert and change its output wholesale.
    (Autograd reads the flag again when the backward runs, so a pin
    around the forward alone would not hold the router's gradient.)"""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _ieee_matmul():
            return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        with _ieee_matmul():
            if ctx.needs_input_grad[0]:
                gx = g @ w.T
            if ctx.needs_input_grad[1]:
                gw = x.T @ g
        return gx, gw


def _gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]``, a zero row where ``idx == len(src)``."""
    n = src.shape[0]
    out = src.index_select(0, idx.clamp_max(n - 1))
    return torch.where((idx < n)[:, None], out, out.new_zeros(()))


class _Permute(torch.autograd.Function):
    """``out[i] = src[idx[i]]`` (a zero row for ``idx[i] == len(src)``)
    whose adjoint sums, for each source row r, the output rows listed in
    ``inv[r]`` (an ``(R, m)`` table with the sentinel ``len(out)`` for
    none), in order of m.  Both directions are gathers: the dispatch
    and combine of :func:`moe` use no float atomics (the reference
    scatters with ``.at[].add``), so their sums are the same on every
    run."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _gather_rows(src, idx)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        parts = _gather_rows(g, inv.reshape(-1)).reshape(
            *inv.shape, g.shape[-1])
        acc = parts[:, 0]
        for j in range(1, inv.shape[1]):
            acc = acc + parts[:, j]
        return acc, None, None


def _top_k(gates: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, the lower index
    first among equal values (a stable sort; ``torch.topk`` promises no
    order between ties)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_groups(t: int) -> int:
    """Dispatch-group count of ``t`` tokens (the reference's): the
    largest count of the active context's batch shards (halving from
    their number) that divides ``t``; 1 without a context, where the
    dispatch is GShard's global one.  So drops follow the mesh: each
    data rank's tokens are routed and capped as one group."""
    mc = SH.current()
    if mc is None:
        return 1
    g = mc.axis_size("batch")
    while g > 1 and t % g:
        g //= 2
    return max(g, 1)


def moe_capacity(tokens: int, *, top_k: int, n_experts: int,
                 capacity_factor: float = 1.25,
                 groups: Optional[int] = None) -> Tuple[int, int, int]:
    """(groups, tokens per group, capacity per expert and group) of a
    :func:`moe` call on ``tokens`` tokens: GShard's ``C = cf * T_g * k /
    E``, at least 8.  ``groups=None`` reads the active mesh context
    (:func:`_moe_groups`)."""
    g = groups or _moe_groups(tokens)
    if tokens % g:
        raise ValueError(f"moe: {tokens} tokens do not split into {g} "
                         "groups")
    tg = tokens // g
    return g, tg, max(int(capacity_factor * tg * top_k / n_experts), 8)


def moe_route(p: Params, x: torch.Tensor, *, top_k: int, n_experts: int,
              capacity_factor: float = 1.25,
              groups: Optional[int] = None) -> Dict[str, Any]:
    """The routing of :func:`moe` (the reference's ``dispatch_one`` per
    group): f32 router logits, softmax gates ``(G, T_g, E)``, the top-k
    experts ``tope`` and their renormalised gates ``topg`` ``(G, T_g,
    k)``, each entry's ``rank`` among the group's entries routed to its
    expert (token order, from a stable sort and ``searchsorted``) and
    ``keep = rank < cap``, flattened ``(G, T_g * k)`` token-major."""
    b, s, d = x.shape
    g, tg, cap = moe_capacity(b * s, top_k=top_k, n_experts=n_experts,
                              capacity_factor=capacity_factor,
                              groups=groups)
    logits = _RouterLogits.apply(x.reshape(g * tg, d).float(),
                                 p["router"].float())
    gates = torch.softmax(logits, -1).reshape(g, tg, n_experts)
    topg, tope = _top_k(gates, top_k)
    topg = topg / torch.clamp_min(topg.sum(-1, keepdim=True), 1e-9)
    flat_e = tope.reshape(g, tg * top_k)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    experts = torch.arange(n_experts, device=x.device)
    starts = torch.searchsorted(sorted_e,
                                experts.expand(g, n_experts).contiguous())
    rank_sorted = (torch.arange(tg * top_k, device=x.device)
                   - starts.gather(-1, sorted_e))
    rank = torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)
    return {"gates": gates, "tope": tope, "topg": topg, "rank": rank,
            "keep": rank < cap, "cap": cap, "groups": g}


def moe(p: Params, x: torch.Tensor, *, top_k: int, n_experts: int,
        capacity_factor: float = 1.25, ep: bool = True,
        groups: Optional[int] = None,
        mesh: Optional[SH.Mesh] = None) -> torch.Tensor:
    """Top-k MoE with group-local, capacity-bounded dispatch (the
    reference's ``moe``): each token goes to its top-k experts
    (:func:`moe_route`); an expert takes at most ``cap`` entries per
    group, the earliest tokens first, and drops the rest; the kept
    entries fill ``(E, G * cap, d)`` buffers (unused slots zero) that
    run the experts' SwiGLU as batched matmuls; each token's output is
    the sum, in order of its k choices, of its kept entries' outputs
    times their gates.

    ``groups=None`` reads the group count from the active mesh context
    (:func:`_moe_groups`), as the reference does.  With ``mesh`` (the
    sharded LM), ``p``'s experts hold the rank's slice of their FFN dim
    (``wg``/``wu`` ``(E, d, ff/mp)``, ``wd`` ``(E, ff/mp, d)``): the
    routing and dispatch run on every model rank alike, the experts'
    SwiGLU on the rank's slice, and the partial outputs are summed over
    the model axis before the combine, so the combine adds each token's
    k choices in the same order as one process.  The reference's rules
    give ``moe_ep`` and ``moe_tp`` that same layout (the dense
    ``wg``/``wu``/``wd`` rules match first), so ``ep`` does not change
    the math and is accepted for the reference's signature.  Dispatch
    and combine are gathers both ways (:class:`_Permute`): no float
    atomics."""
    del ep
    b, s, d = x.shape
    r = moe_route(p, x, top_k=top_k, n_experts=n_experts,
                  capacity_factor=capacity_factor, groups=groups)
    g, cap, keep = r["groups"], r["cap"], r["keep"]
    n_tok = b * s
    n_ent, n_slot = n_tok * top_k, n_experts * g * cap
    dev = x.device
    # slot of each kept entry in the (E, G, cap) buffers; n_slot = dropped
    grp = torch.arange(g, device=dev)[:, None]
    slot = (r["tope"].reshape(g, -1) * g + grp) * cap + r["rank"]
    slot = torch.where(keep, slot, n_slot).reshape(-1)
    # each slot's entry (n_ent = empty); the dropped ones all land in the
    # extra last slot, which is cut off
    slot_ent = torch.full((n_slot + 1,), n_ent, dtype=torch.long,
                          device=dev)
    slot_ent[slot] = torch.arange(n_ent, device=dev)
    slot_ent = slot_ent[:n_slot]
    slot_tok = torch.where(slot_ent < n_ent, slot_ent // top_k, n_tok)

    buf = _Permute.apply(x.reshape(n_tok, d), slot_tok,
                         slot.reshape(n_tok, top_k))
    buf = buf.reshape(n_experts, g * cap, d)
    if mesh is not None:
        buf = SH.copy_to(buf, mesh, "model")
    h = torch.matmul(buf, p["wg"])
    u = torch.matmul(buf, p["wu"])
    yb = torch.matmul(F.silu(h) * u, p["wd"])
    if mesh is not None:
        yb = SH.reduce_from(yb, mesh, "model")
    contrib = _Permute.apply(yb.reshape(n_slot, d), slot, slot_ent[:, None])
    w = torch.where(keep, r["topg"].reshape(g, -1), 0.0)
    contrib = (contrib * w.reshape(n_ent, 1).to(x.dtype)).reshape(
        n_tok, top_k, d)
    y = contrib[:, 0]
    for j in range(1, top_k):
        y = y + contrib[:, j]
    return y.reshape(b, s, d)


def moe_aux_loss(p: Params, x: torch.Tensor, top_k: int,
                 n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss: ``E * sum(frac *
    prob)``, frac the share of the top-k choices per expert, prob its
    mean gate (the reference's; its ``LM.loss`` does not add it)."""
    t = x.shape[0] * x.shape[1]
    logits = _RouterLogits.apply(x.reshape(t, -1).float(),
                                 p["router"].float())
    gates = torch.softmax(logits, -1)
    _, tope = _top_k(gates, top_k)
    frac = F.one_hot(tope, n_experts).float().mean((0, 1))
    prob = gates.mean(0)
    return n_experts * torch.sum(frac * prob)

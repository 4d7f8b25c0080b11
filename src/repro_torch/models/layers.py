"""Transformer building blocks of the attention decoders, in PyTorch.

The port of the JAX package's ``models/layers.py`` (attention, the
SwiGLU MLP and the top-k MoE), with its names, parameter dicts and
layouts: activations ``(B, S, H, D)``, weights ``(d_in, d_out)`` so that
``x @ w`` matches.  Sharding constraints have no counterpart here (one
card).

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
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attn import flash_attention

Params = Dict[str, Any]


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (xf * p["scale"].float()).to(dt)


def _dense_init(gen: torch.Generator, fan_in: int, shape,
                dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device)
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
                   lead: Tuple[int, ...] = ()) -> Params:
    """``lead``: leading dims of every leaf, e.g. ``(n_layers,)`` to draw
    a stack of layers at once."""
    hq, hk = n_heads * head_dim, n_kv * head_dim
    p = {
        "wq": _dense_init(gen, d_model, (*lead, d_model, hq), dtype),
        "wk": _dense_init(gen, d_model, (*lead, d_model, hk), dtype),
        "wv": _dense_init(gen, d_model, (*lead, d_model, hk), dtype),
        "wo": _dense_init(gen, hq, (*lead, hq, d_model), dtype),
    }
    if qkv_bias:
        z = dict(dtype=dtype, device=gen.device)
        p["bq"] = torch.zeros((*lead, hq), **z)
        p["bk"] = torch.zeros((*lead, hk), **z)
        p["bv"] = torch.zeros((*lead, hk), **z)
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

    if use_blockwise is None:
        use_blockwise = k.shape[1] > 2048
    if use_blockwise:
        o = blockwise_attention(q, k, v, causal=causal, window=window,
                                q_offset=0, kv_len=None, block=attn_block)
    else:
        sq, sk = q.shape[1], k.shape[1]
        qpos = (sk - sq) + torch.arange(sq, device=x.device)
        kpos = torch.arange(sk, device=x.device)
        msk = torch.ones((sq, sk), dtype=torch.bool, device=x.device)
        if causal:
            msk &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            msk &= kpos[None, :] > qpos[:, None] - window
        o = _gqa_scores_combine(q, k, v, msk[None], x.dtype)

    out = o.to(x.dtype).reshape(b, s, n_heads * head_dim) @ p["wo"]
    return out, (k, v)


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
             lead: Tuple[int, ...] = ()) -> Params:
    return {"wg": _dense_init(gen, d_model, (*lead, d_model, d_ff), dtype),
            "wu": _dense_init(gen, d_model, (*lead, d_model, d_ff), dtype),
            "wd": _dense_init(gen, d_ff, (*lead, d_ff, d_model), dtype)}


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


# ---------------------------------------------------------------------------
# Feed-forward: top-k MoE
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype, lead: Tuple[int, ...] = ()) -> Params:
    """The router ``(d, E)``, always f32 (as the reference draws it), and
    the experts' SwiGLU weights ``wg``/``wu`` ``(E, d, ff)`` and ``wd``
    ``(E, ff, d)`` in ``dtype``; every leaf stacked over ``lead``."""
    e = n_experts
    return {
        "router": _dense_init(gen, d_model, (*lead, d_model, e),
                              torch.float32),
        "wg": _dense_init(gen, d_model, (*lead, e, d_model, d_ff), dtype),
        "wu": _dense_init(gen, d_model, (*lead, e, d_model, d_ff), dtype),
        "wd": _dense_init(gen, d_ff, (*lead, e, d_ff, d_model), dtype),
    }


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


def moe_capacity(tokens: int, *, top_k: int, n_experts: int,
                 capacity_factor: float = 1.25,
                 groups: Optional[int] = None) -> Tuple[int, int, int]:
    """(groups, tokens per group, capacity per expert and group) of a
    :func:`moe` call on ``tokens`` tokens: GShard's ``C = cf * T_g * k /
    E``, at least 8."""
    g = groups or 1
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
        groups: Optional[int] = None) -> torch.Tensor:
    """Top-k MoE with group-local, capacity-bounded dispatch (the
    reference's ``moe``): each token goes to its top-k experts
    (:func:`moe_route`); an expert takes at most ``cap`` entries per
    group, the earliest tokens first, and drops the rest; the kept
    entries fill ``(E, G * cap, d)`` buffers (unused slots zero) that
    run the experts' SwiGLU as batched matmuls; each token's output is
    the sum, in order of its k choices, of its kept entries' outputs
    times their gates.

    ``groups=None`` is one group: the reference reads the group count
    from its mesh context, which the port does not have.  ``ep`` (experts
    sharded, or their FFN dims) does not change the math on one card and
    is accepted for the reference's signature.  Dispatch and combine are
    gathers both ways (:class:`_Permute`): no float atomics."""
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
    h = torch.matmul(buf, p["wg"])
    u = torch.matmul(buf, p["wu"])
    yb = torch.matmul(F.silu(h) * u, p["wd"])
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

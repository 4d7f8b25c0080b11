"""Transformer building blocks of the dense decoder, in PyTorch.

The port of the dense subset of the JAX package's ``models/layers.py``,
with its names, parameter dicts and layouts: activations ``(B, S, H,
D)``, weights ``(d_in, d_out)`` so that ``x @ w`` matches.  Sharding
constraints have no counterpart here (one card).

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

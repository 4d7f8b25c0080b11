"""Recurrent sequence-mixing blocks in PyTorch: Mamba (Jamba), mLSTM and
sLSTM (xLSTM).

The port of the JAX package's ``models/ssm.py``, name for name, with its
parameter dicts and its state tuples (:class:`MambaState`,
:class:`MLSTMState`, :class:`SLSTMState`), so that the LM's cache trees
line up with the reference's leaf for leaf.  Each block has a chunked
or parallel *training* form and an O(1)-state *decode* step.

The reference has no Pallas kernel here: it runs XLA einsums,
``lax.associative_scan`` and ``lax.scan``.  The port runs torch ops:
every ``lax.scan`` over time or chunks is a Python loop, and under
autograd each chunk body is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).

Sentinels stay the reference's ``-1e30``, never ``-inf``: the initial
log-stabiliser ``m``, the padded mLSTM input gates and its masked decay
matrix are all differenced against each other, and ``-inf - (-inf)`` is
NaN.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import _dense_init, _wants_grad, draw_device

Params = Dict[str, Any]
NEG = -1e30             # the reference's sentinel for "log of zero"


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _recompute(fn, *args):
    """``fn(*args)``, recomputed in the backward when a gradient is asked
    of any tensor argument (the reference's ``@jax.checkpoint`` scan
    bodies)."""
    if _wants_grad(*(t for t in args if isinstance(t, torch.Tensor))):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ===========================================================================
# Mamba (selective SSM)
# ===========================================================================

class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, d_inner): last inputs for the conv
    ssm: torch.Tensor   # (B, d_inner, d_state): recurrent state (f32)


def init_mamba(gen: torch.Generator, d_model: int, *, expand: int = 2,
               d_state: int = 16, d_conv: int = 4,
               dt_rank: Optional[int] = None, dtype=torch.float32,
               lead: Tuple[int, ...] = ()) -> Params:
    """The reference's ``init_mamba``; ``lead``: leading dims of every
    leaf (a stack of layers drawn at once).  ``A_log`` is ``log(1..ds)``
    on every inner channel and ``D`` ones, both f32; ``conv_b`` and
    ``dt_bias`` zeros in ``dtype``."""
    di = expand * d_model
    dt_rank = dt_rank or -(-d_model // 16)
    dev = draw_device(gen)
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "in_proj": _dense_init(gen, d_model, (*lead, d_model, 2 * di), dtype),
        "conv_w": _dense_init(gen, d_conv, (*lead, d_conv, di), dtype),
        "conv_b": torch.zeros((*lead, di), dtype=dtype, device=dev),
        "x_proj": _dense_init(gen, di, (*lead, di, dt_rank + 2 * d_state),
                              dtype),
        "dt_proj": _dense_init(gen, dt_rank, (*lead, dt_rank, di), dtype),
        "dt_bias": torch.zeros((*lead, di), dtype=dtype, device=dev),
        "A_log": a_log.expand(*lead, di, d_state).clone(),
        "D": torch.ones((*lead, di), dtype=torch.float32, device=dev),
        "out_proj": _dense_init(gen, di, (*lead, di, d_model), dtype),
    }


def _mamba_conv(p: Params, x_in: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None):
    """Causal depthwise conv over time via shifted adds (d_conv taps).

    x_in: (B, S, di).  Returns (y, new_conv_state)."""
    d_conv = p["conv_w"].shape[0]
    if conv_state is not None:
        hist = torch.cat([conv_state.to(x_in.dtype), x_in], 1)
    else:
        hist = F.pad(x_in, (0, 0, d_conv - 1, 0))
    s = x_in.shape[1]
    y = torch.zeros_like(x_in)
    for t in range(d_conv):
        y = y + hist[:, t:t + s, :] * p["conv_w"][t]
    new_state = hist[:, -(d_conv - 1):, :] if d_conv > 1 else None
    return y + p["conv_b"], new_state


def _mamba_chunk(h, dtb, xb, bb, cb, A):
    """One chunk of the selective scan: (h at the chunk's end, y).

    dtb, xb: (B, L, di); bb, cb: (B, L, ds); h: (B, di, ds); all f32.
    The state enters at the chunk's first step (``dBx[:, 0] + dA[:, 0] *
    h``, the reference's ``dBx.at[:, 0].add``); the in-chunk scan is a
    loop over the L steps, one ``addcmul`` over (B, di, ds) each.  The
    reference's ``lax.associative_scan`` combines ``(a1·a2, b1·a2 + b2)``
    in a tree; a log-step (Hillis-Steele) restatement would make log2(L)
    passes over the whole (B, L, di, ds) chunk, O(L log L) state traffic
    against the loop's O(L), and this path is memory-bound (at Jamba's
    d_inner 16,384 a chunk tensor of 4 x 128 steps is 537 MB), so the
    loop is taken and its launches are paid instead.  The sums therefore
    run in another order than the reference's.  C is contracted inside
    the chunk: no (B, S, di, ds) tensor is ever whole."""
    dA = torch.exp(dtb[..., None] * A)                  # (B, L, di, ds)
    dBx = (dtb * xb)[..., None] * bb[:, :, None, :]
    hs = []
    for t in range(dA.shape[1]):
        h = torch.addcmul(dBx[:, t], dA[:, t], h)
        hs.append(h)
    y = torch.einsum("blds,bls->bld", torch.stack(hs, 1), cb)
    return h, y


def _mamba_scan_chunked(dt, x_c, A, bmat, cmat, h0, chunk: int):
    """Selective scan over chunks with everything big kept chunk-local.

    dt, x_c: (B, S, di) f32; bmat, cmat: (B, S, ds) f32; A: (di, ds);
    S a multiple of ``chunk``.  Returns (y (B, S, di) f32, h_last (B,
    di, ds) f32).  Each chunk (:func:`_mamba_chunk`) is recomputed in
    the backward under autograd, as the reference's checkpointed body."""
    s = dt.shape[1]
    h = h0
    ys = []
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        h, y = _recompute(_mamba_chunk, h, dt[:, sl], x_c[:, sl],
                          bmat[:, sl], cmat[:, sl], A)
        ys.append(y)
    return torch.cat(ys, 1), h


def mamba_forward(p: Params, x: torch.Tensor,
                  state: Optional[MambaState] = None, *, chunk: int = 128
                  ) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """Full-sequence (train/prefill) Mamba block. x: (B, S, d_model).
    Returns (out, the new state, or None when ``state`` is None)."""
    b, s, _ = x.shape
    di = p["conv_w"].shape[1]
    ds = p["A_log"].shape[1]
    dt_rank = p["dt_proj"].shape[0]

    xz = x @ p["in_proj"]
    x_in, z = xz.split(di, dim=-1)
    conv_state = state.conv if state is not None else None
    x_c, new_conv = _mamba_conv(p, x_in, conv_state)
    x_c = F.silu(x_c)

    proj = x_c @ p["x_proj"]
    dt_in, bmat, cmat = proj.split([dt_rank, ds, ds], dim=-1)
    dt = _softplus(dt_in @ p["dt_proj"] + p["dt_bias"])      # (B, S, di)
    A = -torch.exp(p["A_log"])                                # (di, ds)

    dtf, xcf, bf, cf = (t.float() for t in (dt, x_c, bmat, cmat))
    h0 = (state.ssm if state is not None
          else torch.zeros((b, di, ds), dtype=torch.float32,
                           device=x.device))
    pad = (-s) % chunk
    if pad:
        # dt = 0 -> dA = 1, dBx = 0: padded steps leave the state untouched
        dtf, xcf, bf, cf = (F.pad(t, (0, 0, 0, pad))
                            for t in (dtf, xcf, bf, cf))
    y, h_last = _mamba_scan_chunked(dtf, xcf, A, bf, cf, h0, chunk)
    y = y[:, :s]

    y = y + p["D"] * x_c.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    new_state = None
    if state is not None:
        new_state = MambaState(new_conv.to(state.conv.dtype), h_last)
    return out, new_state


def mamba_step(p: Params, x: torch.Tensor, state: MambaState
               ) -> Tuple[torch.Tensor, MambaState]:
    """Single-token decode step. x: (B, 1, d_model)."""
    return mamba_forward(p, x, state, chunk=1)


def init_mamba_state(batch: int, p: Params,
                     dtype=torch.bfloat16) -> MambaState:
    d_conv, di = p["conv_w"].shape
    ds = p["A_log"].shape[1]
    dev = p["conv_w"].device
    return MambaState(
        torch.zeros((batch, d_conv - 1, di), dtype=dtype, device=dev),
        torch.zeros((batch, di, ds), dtype=torch.float32, device=dev))


# ===========================================================================
# mLSTM (xLSTM matrix-memory block): chunkwise parallel + recurrent step
# ===========================================================================

class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, dk, dv) matrix memory (f32)
    n: torch.Tensor   # (B, H, dk) normaliser
    m: torch.Tensor   # (B, H) log-domain stabiliser


def init_mlstm(gen: torch.Generator, d_model: int, *, n_heads: int,
               proj_factor: float = 2.0, dtype=torch.float32,
               lead: Tuple[int, ...] = ()) -> Params:
    """The reference's ``init_mlstm``: ``wif`` and ``bif`` f32 whatever
    ``dtype`` is, the input-gate biases 0 and the forget-gate biases
    3.0."""
    di = int(proj_factor * d_model)
    bif = torch.cat([torch.zeros(n_heads), torch.full((n_heads,), 3.0)])
    return {
        "up": _dense_init(gen, d_model, (*lead, d_model, 2 * di), dtype),
        "wq": _dense_init(gen, di, (*lead, di, di), dtype),
        "wk": _dense_init(gen, di, (*lead, di, di), dtype),
        "wv": _dense_init(gen, di, (*lead, di, di), dtype),
        "wif": _dense_init(gen, di, (*lead, di, 2 * n_heads), torch.float32),
        "bif": bif.to(draw_device(gen)).expand(*lead, 2 * n_heads).clone(),
        "down": _dense_init(gen, di, (*lead, di, d_model), dtype),
    }


def _mlstm_heads(p: Params, x: torch.Tensor, n_heads: int):
    b, s, _ = x.shape
    up = x @ p["up"]
    di = up.shape[-1] // 2
    xi, z = up.split(di, dim=-1)
    dh = di // n_heads

    def heads(w):
        return (xi @ w).reshape(b, s, n_heads, dh).transpose(1, 2)
    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    gif = xi.float() @ p["wif"] + p["bif"]
    ig, fg = gif.split(n_heads, dim=-1)              # (B, S, H)
    log_i = ig.transpose(1, 2)                       # pre-activation
    log_f = -_softplus(-fg).transpose(1, 2)          # log sigmoid
    return q, k, v, log_i, log_f, z


def _mlstm_out(p: Params, hs: torch.Tensor, z: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, dh) head outputs -> (B, S, d_model)."""
    b, _, s, _ = hs.shape
    hs = hs.transpose(1, 2).reshape(b, s, -1)
    return (hs.to(x.dtype) * F.silu(z)) @ p["down"]


def mlstm_recurrent(p: Params, x: torch.Tensor, state: MLSTMState, *,
                    n_heads: int) -> Tuple[torch.Tensor, MLSTMState]:
    """Step-by-step reference / decode path. x: (B, S, d)."""
    q, k, v, log_i, log_f, z = _mlstm_heads(p, x, n_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    c, n, m = state
    hs = []
    for t in range(x.shape[1]):
        qt = q[:, :, t].float() * scale
        kt = k[:, :, t].float()
        vt = v[:, :, t].float()
        li, lf = log_i[:, :, t], log_f[:, :, t]
        m_new = torch.maximum(lf + m, li)
        f_t = torch.exp(lf + m - m_new)[..., None]
        i_t = torch.exp(li - m_new)[..., None]
        c = f_t[..., None] * c + i_t[..., None] * (
            kt[..., :, None] * vt[..., None, :])
        n = f_t * n + i_t * kt
        m = m_new
        num = torch.einsum("bhk,bhkv->bhv", qt, c)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", qt, n).abs(),
                            torch.exp(-m))[..., None]
        hs.append(num / den)
    return _mlstm_out(p, torch.stack(hs, 2), z, x), MLSTMState(c, n, m)


def _mlstm_chunk(c, n, m, qb, kb, vb, li, lf, scale: float):
    """One chunk of :func:`mlstm_chunkwise`: intra-chunk quadratic
    matmuls plus the carried (C, n, m); returns (c, n, m, h)."""
    qb = qb.float() * scale
    kb = kb.float()
    vb = vb.float()
    L = qb.shape[2]
    bcum = torch.cumsum(lf, -1)                          # (B, H, L)
    # intra-chunk decay matrix: D[t, s] = b_t - b_s + i_s (s <= t)
    dmat = bcum[..., :, None] - bcum[..., None, :] + li[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=qb.device).tril()
    dmat = dmat.masked_fill(~tri, NEG)
    # inter-chunk logits: a_t = b_t + m_prev
    a_vec = bcum + m[..., None]
    m_intra = dmat.amax(-1)
    m_new_t = torch.maximum(m_intra, a_vec)              # (B, H, L)
    dstab = torch.exp(dmat - m_new_t[..., None])
    inter_w = torch.exp(a_vec - m_new_t)                 # (B, H, L)

    sc = torch.einsum("bhld,bhmd->bhlm", qb, kb) * dstab
    num = torch.einsum("bhlm,bhmd->bhld", sc, vb) \
        + inter_w[..., None] * torch.einsum("bhld,bhdv->bhlv", qb, c)
    # normaliser q.n_t: intra decayed (q.k_s) sums + inter q.n_prev
    den = sc.sum(-1) + inter_w * torch.einsum("bhld,bhd->bhl", qb, n)
    den = torch.maximum(den.abs(), torch.exp(-m_new_t))
    hout = num / den[..., None]

    # the carry at the chunk's end
    g = bcum[..., -1]                                    # total log decay
    m_next = torch.maximum(g + m, (bcum[..., -1:] - bcum + li).amax(-1))
    # decayed contribution of each position to the end-of-chunk state
    wts = torch.exp(bcum[..., -1:] - bcum + li - m_next[..., None])
    decay = torch.exp(g + m - m_next)
    c_next = decay[..., None, None] * c + torch.einsum(
        "bhl,bhld,bhlv->bhdv", wts, kb, vb)
    n_next = decay[..., None] * n + torch.einsum("bhl,bhld->bhd", wts, kb)
    return c_next, n_next, m_next, hout


def mlstm_chunkwise(p: Params, x: torch.Tensor,
                    state: Optional[MLSTMState] = None, *, n_heads: int,
                    chunk: int = 256
                    ) -> Tuple[torch.Tensor, Optional[MLSTMState]]:
    """Chunkwise-parallel mLSTM (training form): intra-chunk quadratic
    matmuls + inter-chunk recurrence on (C, n, m).  Each chunk is
    recomputed in the backward under autograd."""
    b, s, _ = x.shape
    q, k, v, log_i, log_f, z = _mlstm_heads(p, x, n_heads)
    h, dh = n_heads, q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, pad), value=NEG)
        log_f = F.pad(log_f, (0, pad))
    if state is None:
        c = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
        m = torch.full((b, h), NEG, dtype=torch.float32, device=x.device)
    else:
        c, n, m = state
    hs = []
    for i in range((s + pad) // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        c, n, m, hout = _recompute(
            _mlstm_chunk, c, n, m, q[:, :, sl], k[:, :, sl], v[:, :, sl],
            log_i[..., sl], log_f[..., sl], scale)
        hs.append(hout)
    hs = torch.cat(hs, 2)[:, :, :s]
    out = _mlstm_out(p, hs, z, x)
    return out, (MLSTMState(c, n, m) if state is not None else None)


def init_mlstm_state(batch: int, p: Params, n_heads: int) -> MLSTMState:
    di = p["wq"].shape[1]
    dh = di // n_heads
    dev = p["wq"].device
    return MLSTMState(
        torch.zeros((batch, n_heads, dh, dh), dtype=torch.float32,
                    device=dev),
        torch.zeros((batch, n_heads, dh), dtype=torch.float32, device=dev),
        torch.full((batch, n_heads), NEG, dtype=torch.float32, device=dev))


# ===========================================================================
# sLSTM (xLSTM scalar-memory block): inherently sequential
# ===========================================================================

class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, di)
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor   # recurrent output feeding the gates


def slstm_inner_dim(d_model: int, n_heads: int,
                    proj_factor: float = 4 / 3) -> int:
    """Round the 4/3 up-projection up to a multiple of ``max(64,
    n_heads)`` (1,408 at d_model 1,024)."""
    di = int(proj_factor * d_model)
    unit = max(64, n_heads)
    return max(-(-di // unit) * unit, unit)


def init_slstm(gen: torch.Generator, d_model: int, *, n_heads: int,
               proj_factor: float = 4 / 3, dtype=torch.float32,
               lead: Tuple[int, ...] = ()) -> Params:
    """The reference's ``init_slstm``: input->gates ``wx`` (z, i, f, o),
    recurrent h->gates ``wh``, the gates' bias ``b`` f32 zeros."""
    di = slstm_inner_dim(d_model, n_heads, proj_factor)
    return {
        "wx": _dense_init(gen, d_model, (*lead, d_model, 4 * di), dtype),
        "wh": _dense_init(gen, di, (*lead, di, 4 * di), dtype),
        "b": torch.zeros((*lead, 4 * di), dtype=torch.float32,
                         device=draw_device(gen)),
        "down": _dense_init(gen, di, (*lead, di, d_model), dtype),
    }


def slstm_forward(p: Params, x: torch.Tensor,
                  state: Optional[SLSTMState] = None
                  ) -> Tuple[torch.Tensor, Optional[SLSTMState]]:
    """Sequential loop over time (no parallel form exists: the recurrent
    weight matrix creates a true serial dependency).  ``h`` is cast to
    the compute dtype before ``h @ wh``; the gates are f32."""
    b, s, _ = x.shape
    xg = x @ p["wx"]                                   # (B, S, 4di)
    ret_state = state is not None
    if state is None:
        state = init_slstm_state(b, p)
    c, n, m, h = state
    hs = []
    for t in range(s):
        g = xg[:, t].float() + (h.to(x.dtype) @ p["wh"]).float() + p["b"]
        zg, ig, fg, og = g.chunk(4, -1)
        zt = torch.tanh(zg)
        lf = -_softplus(-fg)                           # log sigmoid(f)
        m_new = torch.maximum(lf + m, ig)
        i_t = torch.exp(ig - m_new)
        f_t = torch.exp(lf + m - m_new)
        c = f_t * c + i_t * zt
        n = f_t * n + i_t
        m = m_new
        h = torch.sigmoid(og) * c / torch.clamp_min(n, 1e-6)
        hs.append(h)
    out = torch.stack(hs, 1).to(x.dtype) @ p["down"]
    return out, (SLSTMState(c, n, m, h) if ret_state else None)


def init_slstm_state(batch: int, p: Params) -> SLSTMState:
    """Zeros, ``m`` at -1e30; four tensors of their own (the cache writes
    each in place)."""
    di = p["down"].shape[0]
    dev = p["down"].device

    def z():
        return torch.zeros((batch, di), dtype=torch.float32, device=dev)
    return SLSTMState(z(), z(), torch.full((batch, di), NEG,
                                           dtype=torch.float32, device=dev),
                      z())

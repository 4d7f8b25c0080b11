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

**On a model rank** (``mesh=``, the LM's tensor-parallel run): ``p``
holds the rank's blocks under the reference's ``PARAM_RULES``, a state
the rank's block under its ``cache_specs``, and each block returns its
partial output, which the caller sums over ``'model'``.  No collective
runs inside a time or chunk loop: every exchange is once per call.

* Mamba runs the rank's ``d_inner / mp`` channels.  ``in_proj``'s column
  block is not the rank's channels of both halves ``[x_in | z]`` (on mp
  2 one rank holds all of ``x_in``), so one gather of the smaller of the
  weight and the product gives each rank its channels of both
  (:func:`~repro_torch.distributed.sharding.cols_matmul`); ``x_proj``'s
  row block makes a partial ``(dt, B, C)``, summed once in f32 (in bf16
  its two roundings moved Jamba's logits past the bf16 gate); the scan
  and the conv are local.
* The mLSTM runs the rank's ``H / mp`` heads: ``up``'s ``xi`` half whole
  and the rank's block of ``z`` come from one such gather; ``wif`` /
  ``bif`` (replicated) are read behind ``copy_to`` for the rank's
  heads' gates.  Its cache splits ``c`` on ``dv`` with ``n`` and ``m``
  whole: one gather turns the cache's block into the rank's heads at the
  read, one gather of the new ``(c, n, m)`` puts it back at the write.
  Where the model axis does not divide the heads (xLSTM-350M's 4 on 16
  ranks), every rank runs every head (q, k, v whole by one gather, the
  reference's degrade-to-replicated) and keeps its columns of the output
  and its ``dv`` block of the new ``c``.
* The sLSTM gathers ``wx`` / ``wh`` (one ``all_gather`` for both) and
  runs its serial loop replicated over ``'model'`` (its state is
  replicated there); the rank multiplies its ``d_inner`` block of the
  outputs by its ``down`` rows.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as SH
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
                  state: Optional[MambaState] = None, *, chunk: int = 128,
                  mesh: Optional[SH.Mesh] = None
                  ) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """Full-sequence (train/prefill) Mamba block. x: (B, S, d_model).
    Returns (out, the new state, or None when ``state`` is None).  With
    ``mesh``, the rank's channels and a partial ``out`` (module doc)."""
    p = dict(p)                  # each leaf read (cast, gathered) once
    b, s, _ = x.shape
    di = p["conv_w"].shape[1]
    ds = p["A_log"].shape[1]
    dt_rank = p["dt_proj"].shape[0]

    if mesh is None:
        xz = x @ p["in_proj"]
        x_in, z = xz.split(di, dim=-1)
    else:
        lo, whole = mesh.model_index * di, di * mesh.mp
        x_in, z = SH.cols_matmul(
            x, p["in_proj"], mesh,
            [(lo, lo + di), (whole + lo, whole + lo + di)])
    conv_state = state.conv if state is not None else None
    x_c, new_conv = _mamba_conv(p, x_in, conv_state)
    x_c = F.silu(x_c)

    if mesh is None:
        proj = x_c @ p["x_proj"]
    else:
        # the rank's rows of x_proj give a partial sum, read again by the
        # rank's channels (so summed both ways): taken and summed in f32,
        # rounded once to the compute dtype as one product is
        proj = SH.reduce_from(x_c.float() @ p["x_proj"].float(), mesh,
                              "model")
        proj = SH.copy_to(proj, mesh, "model").to(x_c.dtype)
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


def _mlstm_heads(p: Params, x: torch.Tensor, n_heads: int,
                 mesh: Optional[SH.Mesh] = None):
    """q, k, v (B, h, S, dh), the gates' logs (B, h, S) and ``z`` of the
    block's ``h`` heads: all ``n_heads``, or with ``mesh`` the rank's
    ``n_heads / mp`` (its columns of ``wq`` / ``wk`` / ``wv``) and its
    block of ``z``; where the model axis does not divide the heads,
    every head (q, k, v whole by one gather) and the rank's columns of
    ``z``."""
    b, s, _ = x.shape
    di = p["wq"].shape[0]
    dh = di // n_heads
    wif, bif = p["wif"], p["bif"]
    if mesh is None:
        h = n_heads
        xi, z = (x @ p["up"]).split(di, dim=-1)
    elif n_heads % mesh.mp:
        # every head on every rank; z's block is the rank's columns
        h, c = n_heads, di // mesh.mp
        lo = mesh.model_index * c
        xi, z = SH.cols_matmul(x, p["up"], mesh,
                               [(0, di), (di + lo, di + lo + c)])
        wif, bif = (SH.copy_to(t, mesh, "model") for t in (wif, bif))
    else:
        h = n_heads // mesh.mp
        lo = mesh.model_index * h
        xi, z = SH.cols_matmul(x, p["up"], mesh,
                               [(0, di), (di + lo * dh, di + (lo + h) * dh)])
        # replicated leaves read for the rank's heads: their gradients
        # are partial, summed over the model axis by copy_to's adjoint
        wif, bif = (SH.copy_to(t, mesh, "model") for t in (wif, bif))
        wif, bif = (torch.cat([t[..., lo:lo + h],
                               t[..., n_heads + lo:n_heads + lo + h]], -1)
                    for t in (wif, bif))

    def heads(t):
        return t.reshape(b, s, h, dh).transpose(1, 2)
    if mesh is not None and n_heads % mesh.mp:
        q, k, v = (heads(t) for t in SH.whole_cols(
            xi, [p["wq"], p["wk"], p["wv"]], mesh))
    else:
        q, k, v = (heads(xi @ p[w]) for w in ("wq", "wk", "wv"))
    gif = xi.float() @ wif + bif
    ig, fg = gif.split(h, dim=-1)                    # (B, S, h)
    log_i = ig.transpose(1, 2)                       # pre-activation
    log_f = -_softplus(-fg).transpose(1, 2)          # log sigmoid
    return q, k, v, log_i, log_f, z


def _mlstm_out(p: Params, hs: torch.Tensor, z: torch.Tensor,
               x: torch.Tensor,
               mesh: Optional[SH.Mesh] = None) -> torch.Tensor:
    """(B, H, S, dh) head outputs -> (B, S, d_model); on a rank that ran
    every head (a model axis that does not divide them), its columns of
    them for its rows of ``down``."""
    b, _, s, _ = hs.shape
    hs = hs.transpose(1, 2).reshape(b, s, -1)
    c = p["down"].shape[0]
    if mesh is not None and hs.shape[-1] > c:
        hs = hs.narrow(-1, mesh.model_index * c, c)
    return (hs.to(x.dtype) * F.silu(z)) @ p["down"]


def _mlstm_state_in(state: MLSTMState, mesh: SH.Mesh, h: int
                    ) -> MLSTMState:
    """The rank's ``h`` heads of a cache block (``c`` split on ``dv``
    over the model axis where it divides, ``n`` / ``m`` whole): one
    gather of ``c`` (none where it is whole); every head where ``h`` is
    all of them."""
    c, n, m = state
    lo = mesh.model_index * h if h < n.shape[1] else 0
    if c.shape[-1] < c.shape[-2]:
        c = mesh.all_gather(c, "model", -1)
    return MLSTMState(c[:, lo:lo + h], n[:, lo:lo + h], m[:, lo:lo + h])


def _mlstm_state_out(state: MLSTMState, mesh: SH.Mesh, dv: int,
                     n_heads: int) -> MLSTMState:
    """The rank's heads' new state put back into the cache's layout
    (every head; ``c``'s ``dv`` block of width ``dv``): one gather of
    ``(c, n, m)`` packed per head, none where the rank ran every head
    (a model axis that does not divide them)."""
    c, n, m = state
    b, h, dk, dvw = c.shape
    lo = mesh.model_index * dv if dv < dvw else 0
    if h * mesh.mp == n_heads:
        packed = torch.cat([c.reshape(b, h, -1), n, m[..., None]], -1)
        c, n, m = mesh.all_gather(packed, "model", 1).split(
            [dk * dvw, dk, 1], -1)
        c, m = c.reshape(b, -1, dk, dvw), m[..., 0]
    return MLSTMState(c[..., lo:lo + dv], n, m)


def mlstm_recurrent(p: Params, x: torch.Tensor, state: MLSTMState, *,
                    n_heads: int, mesh: Optional[SH.Mesh] = None
                    ) -> Tuple[torch.Tensor, MLSTMState]:
    """Step-by-step reference / decode path. x: (B, S, d).  With
    ``mesh``, the rank's heads, ``state`` and the new state in the
    cache's layout, a partial output (module doc)."""
    p = dict(p)
    q, k, v, log_i, log_f, z = _mlstm_heads(p, x, n_heads, mesh)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dv = state.c.shape[-1]
    if mesh is not None:
        state = _mlstm_state_in(state, mesh, q.shape[1])
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
    new = MLSTMState(c, n, m)
    if mesh is not None:
        new = _mlstm_state_out(new, mesh, dv, n_heads)
    return _mlstm_out(p, torch.stack(hs, 2), z, x, mesh), new


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
                    chunk: int = 256, mesh: Optional[SH.Mesh] = None
                    ) -> Tuple[torch.Tensor, Optional[MLSTMState]]:
    """Chunkwise-parallel mLSTM (training form): intra-chunk quadratic
    matmuls + inter-chunk recurrence on (C, n, m).  Each chunk is
    recomputed in the backward under autograd.  With ``mesh``, as
    :func:`mlstm_recurrent`."""
    p = dict(p)
    b, s, _ = x.shape
    q, k, v, log_i, log_f, z = _mlstm_heads(p, x, n_heads, mesh)
    h, dh = q.shape[1], q.shape[-1]
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
        dv = state.c.shape[-1]
        if mesh is not None:
            state = _mlstm_state_in(state, mesh, h)
        c, n, m = state
    hs = []
    for i in range((s + pad) // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        c, n, m, hout = _recompute(
            _mlstm_chunk, c, n, m, q[:, :, sl], k[:, :, sl], v[:, :, sl],
            log_i[..., sl], log_f[..., sl], scale)
        hs.append(hout)
    hs = torch.cat(hs, 2)[:, :, :s]
    out = _mlstm_out(p, hs, z, x, mesh)
    if state is None:
        return out, None
    new = MLSTMState(c, n, m)
    return out, (new if mesh is None
                 else _mlstm_state_out(new, mesh, dv, n_heads))


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
                  state: Optional[SLSTMState] = None, *,
                  mesh: Optional[SH.Mesh] = None
                  ) -> Tuple[torch.Tensor, Optional[SLSTMState]]:
    """Sequential loop over time (no parallel form exists: the recurrent
    weight matrix creates a true serial dependency).  ``h`` is cast to
    the compute dtype before ``h @ wh``; the gates are f32.  With
    ``mesh``, the loop replicated over the model axis on the gathered
    ``wx`` / ``wh`` and a partial output of the rank's ``down`` rows
    (module doc)."""
    p = dict(p)
    b, s, _ = x.shape
    wx, wh, bias, down = p["wx"], p["wh"], p["b"], p["down"]
    if mesh is not None and mesh.mp > 1:
        # one gather for both; the loop reads them for the rank's share
        # of the output, so their gradients (and b's) are partial sums
        both = SH.gather_dim(torch.cat([wx, wh], 0), mesh, "model", -1)
        wx, wh = both.split([wx.shape[0], wh.shape[0]], 0)
        bias = SH.copy_to(bias, mesh, "model")
    xg = x @ wx                                        # (B, S, 4di)
    ret_state = state is not None
    if state is None:
        state = init_slstm_state(b, p)
    c, n, m, h = state
    hs = []
    for t in range(s):
        g = xg[:, t].float() + (h.to(x.dtype) @ wh).float() + bias
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
    hs = torch.stack(hs, 1).to(x.dtype)
    if mesh is not None:
        dl = down.shape[0]
        hs = hs[..., mesh.model_index * dl:(mesh.model_index + 1) * dl]
    out = hs @ down
    return out, (SLSTMState(c, n, m, h) if ret_state else None)


def init_slstm_state(batch: int, p: Params) -> SLSTMState:
    """Zeros, ``m`` at -1e30; four tensors of their own (the cache writes
    each in place).  ``d_inner`` from ``wh``'s rows, which no rule
    splits."""
    di = p["wh"].shape[0]
    dev = p["wh"].device

    def z():
        return torch.zeros((batch, di), dtype=torch.float32, device=dev)
    return SLSTMState(z(), z(), torch.full((batch, di), NEG,
                                           dtype=torch.float32, device=dev),
                      z())

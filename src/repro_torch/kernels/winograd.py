"""The Winograd backend: F(m, r) minimal filtering on the split
subfilters, and K4, its hand-written CUDA kernel.

The port of ``repro.kernels.winograd``.  The split turns every deconv
into stride-1 convolutions of ``K_T = ceil(K/s)`` taps, which is the
shape Winograd's algorithm speeds up: F(2,3) computes a 2x2 output tile
of a 3x3-tap conv with 16 multiplies instead of 36, F(2,2) with 9
instead of 16, F(2,5) with 36 instead of 100.  Per tile,

    Y = A^T [ (G g G^T) .x. (B^T d B) ] A

with the Toom-Cook matrices of :func:`winograd_matrices` (this module's
own copy of the reference's construction; the reference module imports
JAX).  Where each piece runs:

* ``U = G g G^T`` — :func:`transform_filters`, once at ``plan.bind``;
  a bound winograd plan's ``ws`` holds ``U`` (layout ``"wino"``);
* ``V = B^T d B``, the ``alpha_h*alpha_w`` products against ``U`` summed
  over Cin, ``A^T M A``, the trim and K1's interleave, bias, activation
  and crop — K4, :func:`sd_wino` (``csrc/sd_wino.cu``, contract of the
  TPU kernel ``sd_wino_pallas``).  On a CUDA tensor it launches the
  kernel or raises; on a CPU tensor it runs :func:`sd_wino_ref`, the
  same algorithm in plain PyTorch.  ``SD_WINO_LAUNCHES`` counts kernel
  launches.

Numerics: the transforms are exact in rationals but not in f32, so the
backend is held to ``WINO_TOL`` per tap count (relative to max|ref|).
Supported: spatial rank <= 2, per-dim ``K_T <= MAX_TAPS``, float32 and
bfloat16 (the transformed filters are stored in the plan's dtype, the
input is converted to f32 before the transform); int8 plans are refused,
as in the reference.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.autotune import (WinoGeom, WinoPlan,
                                          check_wino_plan, wino_plan)
from repro_torch.kernels.sd_conv import (ACTS, DTYPES, PadPair,
                                         _crop_origin, _full_space, _pair,
                                         check_no_grad, check_plan_type,
                                         shuffle_epilogue)

# Output tile per dim: m = 2 suits the small K_T the split produces
# (larger m needs more evaluation points and amplifies f32 rounding).
OUTPUT_TILE = 2

# Largest per-dim tap count (K_T = 5 -> F(2,5), alpha = 6).
MAX_TAPS = 5

# Toom-Cook evaluation points (plus the point at infinity), ordered so
# small alphas use the best-conditioned prefix.
_POINTS = (0.0, 1.0, -1.0, 2.0, -2.0, 0.5, -0.5)

# Relative tolerance (vs the exact direct conv, scaled by max|ref|) per
# per-dim tap count — the reference's pinned values.
WINO_TOL = {1: 1e-6, 2: 1e-5, 3: 1e-5, 4: 1e-4, 5: 1e-4}

SD_WINO_LAUNCHES = 0       # kernel launches; the plain version never counts

_MAX_ALPHA = MAX_TAPS + OUTPUT_TILE - 1   # the kernel's matrix strides


def tolerance(kt) -> float:
    """Parity tolerance for a per-dim tap tuple (or int)."""
    taps = (kt,) if isinstance(kt, int) else tuple(kt)
    return max(WINO_TOL[min(int(t), MAX_TAPS)] for t in taps)


def output_tile(kt: int) -> int:
    """Per-dim output tile: a 1-tap dim runs F(1,1), the direct conv."""
    return 1 if kt == 1 else OUTPUT_TILE


def supported(kt, dtype: str = "native") -> bool:
    """Can the winograd backend run split subfilters of per-dim tap
    counts ``kt`` (tuple; rank = len) at plan dtype ``dtype``?"""
    kt = tuple(kt)
    return (len(kt) <= 2 and dtype != "int8"
            and all(1 <= int(t) <= MAX_TAPS for t in kt))


@functools.lru_cache(maxsize=None)
def winograd_matrices(m: int, r: int) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Toom-Cook matrices ``(A^T, G, B^T)`` for F(m, r): ``m`` correlation
    outputs of an ``r``-tap filter from ``alpha = m + r - 1`` inputs,

        y = A^T [ (G g) .x. (B^T d) ],    y[o] = sum_k d[o+k] g[k].

    Over points ``a_0..a_{alpha-2}`` plus infinity: ``G`` rows are
    ``a_i^k / N_i`` with ``N_i = prod_{j!=i}(a_i - a_j)`` (infinity row
    ``e_{r-1}``), ``A^T`` columns ``a_i^o`` (infinity column
    ``e_{m-1}``), ``B^T`` rows the coefficients of ``M_i(x) =
    prod_{j!=i}(x - a_j)`` (infinity row: ``M(x)`` itself).  Built in
    float64, returned as float32.
    """
    alpha = m + r - 1
    pts = np.asarray(_POINTS[:alpha - 1], np.float64)
    if alpha - 1 > len(_POINTS):
        raise ValueError(f"F({m},{r}): no point set for alpha={alpha}")

    at = np.zeros((m, alpha), np.float64)
    for i, a in enumerate(pts):
        at[:, i] = a ** np.arange(m)
    at[:, alpha - 1] = np.eye(m)[:, m - 1]        # infinity column

    g = np.zeros((alpha, r), np.float64)
    for i, a in enumerate(pts):
        n_i = np.prod(a - np.delete(pts, i)) if alpha > 2 else 1.0
        g[i] = (a ** np.arange(r)) / n_i
    g[alpha - 1, r - 1] = 1.0                     # infinity row

    bt = np.zeros((alpha, alpha), np.float64)
    for i in range(alpha - 1):
        # np.poly takes roots and returns decreasing powers; flip.
        # atleast_1d: an empty root list collapses to the scalar 1.0.
        coeffs = np.atleast_1d(np.poly(np.delete(pts, i)))[::-1]
        bt[i, :len(coeffs)] = coeffs
    bt[alpha - 1] = np.atleast_1d(np.poly(pts))[::-1]   # inf row: M(x)
    return (at.astype(np.float32), g.astype(np.float32),
            bt.astype(np.float32))


def transform_filters(ws: torch.Tensor,
                      kt: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The offline filter transform ``U = G g G^T`` per (cin, phase
    channel), tap dim by tap dim.

    ``ws``: oc-major split filters, rank 1 ``(KT, Cin, N*Cout)`` or rank
    2 ``(KTh, KTw, Cin, N*Cout)``.  Returns the same layout with each tap
    dim expanded to ``alpha = m + KT - 1``.  Runs in f32 and casts back
    to the filter dtype (bf16 plans store bf16 transforms)."""
    rank = ws.ndim - 2
    kt = tuple(int(t) for t in (kt or ws.shape[:rank]))
    if not supported(kt):
        raise ValueError(f"winograd: unsupported tap geometry {kt} "
                         f"(rank <= 2, per-dim K_T <= {MAX_TAPS})")
    u = ws.float()
    for d, taps in enumerate(kt):
        _, g, _ = winograd_matrices(output_tile(taps), taps)
        u = torch.tensordot(torch.from_numpy(g).to(u.device), u,
                            dims=([1], [d]))
        u = u.movedim(0, d)
    return u.to(ws.dtype).contiguous()


def _alphas(kt) -> Tuple[int, int]:
    return tuple(output_tile(t) + t - 1 for t in kt)


def sd_wino_ref(x: torch.Tensor, u: torch.Tensor, kt, s, *,
                bias: Optional[torch.Tensor] = None, act: str = "linear",
                pad: Tuple[PadPair, PadPair] = ((0, 0), (0, 0)),
                crop: Tuple[int, int] = (0, 0),
                out_space: Optional[Tuple[int, int]] = None
                ) -> torch.Tensor:
    """Plain PyTorch version of :func:`sd_wino`: the same algorithm in
    the transformed domain (``u`` does not give back ``g``).  ``F.pad``
    by ``P_I`` (and on the high side up to whole tiles), the
    ``alpha``-wide tile windows at stride ``m``, ``V = B^T d B``, the
    ``alpha_h*alpha_w`` batched matmuls against ``u``, ``Y = A^T M A``,
    the trim to the conv's rows, then K1's interleave, bias, activation
    and crop tail, in f32, cast to ``x.dtype``."""
    kth, ktw = kt
    mh, mw = output_tile(kth), output_tile(ktw)
    ah, aw = _alphas(kt)
    b, h, wd, cin = x.shape
    nc = u.shape[-1]
    (plo_h, phi_h), (plo_w, phi_w) = pad
    hc, wc = h + plo_h + phi_h - kth + 1, wd + plo_w + phi_w - ktw + 1
    nth, ntw = -(-hc // mh), -(-wc // mw)
    xp = F.pad(x.float(), (0, 0, plo_w, phi_w + ntw * mw - wc,
                           plo_h, phi_h + nth * mh - hc))
    d = xp.unfold(1, ah, mh).unfold(2, aw, mw)   # (B, nth, ntw, Cin, ah, aw)
    at_h, _, bt_h = (torch.from_numpy(a).to(x.device)
                     for a in winograd_matrices(mh, kth))
    at_w, _, bt_w = (torch.from_numpy(a).to(x.device)
                     for a in winograd_matrices(mw, ktw))
    v = torch.einsum("ia,ntscab,jb->ijntsc", bt_h, d, bt_w)
    v = v.reshape(ah * aw, b * nth * ntw, cin)
    mm = torch.bmm(v, u.float().reshape(ah * aw, cin, nc))
    mm = mm.reshape(ah, aw, b, nth, ntw, nc)
    y = torch.einsum("oi,ijntsc,pj->ntospc", at_h, mm, at_w)
    y = y.reshape(b, nth * mh, ntw * mw, nc)[:, :hc, :wc]
    return shuffle_epilogue(y, s, bias, act, crop, out_space, x.dtype)


@dataclass(frozen=True)
class WinoLaunch:
    """The integers K4 is handed for one launch, all computed in Python
    so the CPU tests reach them: K1's crop origin (the low-side crop ``c
    = s*q + r`` as a ``q``-row input offset and an ``r``-row epilogue
    offset, the origin shifted by ``min(q, P_I)``), the output shape, the
    geometry (``rows x cols`` conv positions per sample, K1's ``mh x
    mw``, in F(m, K_T) tiles) and its :class:`WinoPlan`.  Cached per
    launch shape: a served layer computes its geometry and tile once."""
    q_h: int
    q_w: int
    plo_h: int
    plo_w: int
    res_h: int
    res_w: int
    out_h: int
    out_w: int
    geom: WinoGeom
    plan: WinoPlan


@functools.lru_cache(maxsize=1024)
def wino_launch(x_shape, u_shape, kt, s, pad, crop, out_space,
                plan: Optional[WinoPlan] = None, dtype: str = ""
                ) -> WinoLaunch:
    sh, sw = _pair(s)
    b, _, _, cin = x_shape
    oh, ow = out_space
    q_h, q_w, plo_h, plo_w, res_h, res_w = _crop_origin(s, pad, crop)
    geom = WinoGeom(b=b, rows=-(-(oh + res_h) // sh),
                    cols=-(-(ow + res_w) // sw), cin=cin, nc=u_shape[-1],
                    kth=kt[0], ktw=kt[1], dtype=dtype)
    plan = plan if plan is not None else wino_plan(geom)
    check_wino_plan(geom, plan)
    return WinoLaunch(q_h=q_h, q_w=q_w, plo_h=plo_h, plo_w=plo_w,
                      res_h=res_h, res_w=res_w, out_h=oh, out_w=ow,
                      geom=geom, plan=plan)


@functools.lru_cache(maxsize=None)
def kernel_matrices(kt: Tuple[int, int]) -> np.ndarray:
    """The f32 ``B^T`` and ``A^T`` of both dims as K4 takes them: ``B^T``
    rows of :data:`_MAX_ALPHA` for h then w, then ``A^T`` rows of
    :data:`_MAX_ALPHA` for h then w, zero-filled.  Built once per ``kt``
    (read-only)."""
    n = _MAX_ALPHA
    bts, ats = [], []
    for t in kt:
        at, _, bt = winograd_matrices(output_tile(t), t)
        b_ = np.zeros((n, n), np.float32)
        b_[:bt.shape[0], :bt.shape[1]] = bt
        a_ = np.zeros((OUTPUT_TILE, n), np.float32)
        a_[:at.shape[0], :at.shape[1]] = at
        bts.append(b_.ravel())
        ats.append(a_.ravel())
    mats = np.ascontiguousarray(np.concatenate(bts + ats))
    mats.setflags(write=False)
    return mats


def _check_cuda_operands(x, u, bias, kt, sh, sw):
    if x.dtype not in DTYPES:
        raise TypeError(f"sd_wino kernel takes float32 or bfloat16 input, "
                        f"got {x.dtype}")
    if u.dtype != x.dtype:
        raise TypeError(f"filter dtype {u.dtype} != input dtype {x.dtype}")
    if (x.ndim != 4 or u.ndim != 4 or u.shape[2] != x.shape[3]
            or tuple(u.shape[:2]) != _alphas(kt)):
        raise ValueError(f"shapes x {tuple(x.shape)}, u {tuple(u.shape)} "
                         f"are not (B,H,W,Cin), {_alphas(kt)} + "
                         f"(Cin,Cout*sh*sw) for taps {kt}")
    if u.shape[3] % (sh * sw):
        raise ValueError(f"{u.shape[3]} phase channels do not divide by "
                         f"{sh}x{sw} phases")
    for t in (x, u, bias):
        if t.device != x.device:
            raise ValueError("sd_wino operands must share one device")
        if not t.is_contiguous():
            raise ValueError("sd_wino operands must be contiguous")


def sd_wino(x: torch.Tensor, u: torch.Tensor, kt, s, *,
            bias: Optional[torch.Tensor] = None, act: str = "linear",
            pad: Tuple[PadPair, PadPair] = ((0, 0), (0, 0)),
            crop: Tuple[int, int] = (0, 0),
            out_space: Optional[Tuple[int, int]] = None,
            plan: Optional[WinoPlan] = None) -> torch.Tensor:
    """Fused Winograd SD (K4): the transformed-domain split conv and the
    interleaved write, with :func:`~repro_torch.kernels.sd_conv.sd_fused`'s
    contract (``pad``, ``crop``, ``out_space``, ``bias``, ``act``).

    x: (B, H, W, Cin) unpadded.  u: the transformed oc-major filters
    ``(alpha_h, alpha_w, Cin, Cout*sh*sw)`` from
    :func:`transform_filters`; ``kt = (KTh, KTw)`` names the tap geometry
    (``u`` no longer shows it).  Returns (B, *out_space, Cout) in
    ``x.dtype``.  ``plan``: a :class:`WinoPlan` (default
    :func:`~repro_torch.kernels.autotune.wino_plan`); another type
    raises ``TypeError``."""
    global SD_WINO_LAUNCHES
    sh, sw = _pair(s)
    kt = _pair(kt)
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    check_plan_type("sd_wino", plan, WinoPlan)
    if not supported(kt):
        raise ValueError(f"winograd: unsupported tap geometry {kt}")
    if out_space is None:
        out_space = _full_space(x.shape, kt, (sh, sw), pad)
    if x.device.type == "cpu":
        return sd_wino_ref(x, u, kt, (sh, sw), bias=bias, act=act, pad=pad,
                           crop=crop, out_space=out_space)
    if x.device.type != "cuda":
        raise ValueError(f"sd_wino runs on cuda or cpu, not {x.device}")
    check_no_grad("sd_wino", x, u, bias)
    cout = u.shape[-1] // (sh * sw)
    if bias is None:
        bias = torch.zeros(cout, device=x.device)
    bias = bias.float().contiguous()
    _check_cuda_operands(x, u, bias, kt, sh, sw)
    b, h, wd, cin = x.shape
    y = torch.empty((b, *out_space, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    g = wino_launch(tuple(x.shape), tuple(u.shape), kt, (sh, sw),
                    tuple(map(tuple, pad)), tuple(crop), tuple(out_space),
                    plan, "bf16" if x.dtype == torch.bfloat16 else "")
    from repro_torch.kernels.build import load
    fn = load("sd_wino").fn
    mats = kernel_matrices(kt)
    p = g.plan
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), u.data_ptr(), bias.data_ptr(), y.data_ptr(),
                 mats.ctypes.data, DTYPES[x.dtype], b, h, wd, cin, cout,
                 kt[0], kt[1], sh, sw, g.geom.mh, g.geom.mw, g.q_h, g.q_w,
                 g.plo_h, g.plo_w, g.res_h, g.res_w, g.out_h, g.out_w,
                 p.nth, p.ntw, p.nb, p.tc, ACTS[act],
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"sd_wino kernel launch failed: CUDA error {err}")
    SD_WINO_LAUNCHES += 1
    return y

"""Split Deconvolution (SD) in PyTorch: geometry, filter split, shuffle.

The port of the JAX package's ``core/deconv.py``.  Layouts are the
reference's at every public function: activations channels-last
(``(B, *S, C)``), filters ``(*K, C_in, C_out)``; conversion to PyTorch's
channels-first layout happens only inside the calls to ``F.conv*``.
Every function is rank-polymorphic over the spatial rank ``d in {1, 2,
3}``, inferred from the tensors; scalar geometry arguments mean 2-D.
Every convolution here (:func:`native_deconv`, :func:`conv_valid`,
:func:`conv_nd`) runs in full f32 on the card, forward and backward,
whatever the process set: PyTorch lets cuDNN round f32 operands to TF32
by default (``torch.backends.cudnn.allow_tf32``), about 1e-3 relative,
which the reference's f32 gates do not allow (:class:`_FullF32Conv`).

The transposed convolution computed is

    out_i = (in_i - 1) * s_i + K_i - p_lo_i - p_hi_i + op_i

and SD computes it as one grouped stride-1 conv of the ``P_I``-padded
input with ``prod(s)`` split sub-filters (``split_filters``), a
pixel-shuffle (``depth_to_space``) and a contiguous crop of ``P_K`` +
user padding (``crop_interleaved``).  See the reference module for the
derivation.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _no_tf32():
    """cuDNN's TF32 off inside the block, the caller's setting after."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


class _FullF32Conv(torch.autograd.Function):
    """``torch.convolution`` with no pad, bias or groups (``transposed``
    for the adjoint), run with cuDNN's TF32 off in the forward and in the
    backward.  A plain call would be pinned only while it runs: autograd
    reads the flag again when the backward runs, so the backward is
    ``convolution_backward`` (what autograd itself would call) under the
    same pin."""

    @staticmethod
    def forward(ctx, x, w, stride, transposed):
        ctx.save_for_backward(x, w)
        ctx.geom = (stride, transposed)
        r = len(stride)
        with _no_tf32():
            return torch.convolution(x, w, None, stride, [0] * r, [1] * r,
                                     transposed, [0] * r, 1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, transposed = ctx.geom
        r = len(stride)
        with _no_tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, [0] * r, [1] * r, transposed,
                [0] * r, 1, [*ctx.needs_input_grad[:2], False])
        return gx, gw, None, None


def _conv(x_cf: torch.Tensor, w: torch.Tensor, stride=None,
          transposed: bool = False) -> torch.Tensor:
    """Unpadded channels-first conv (or its adjoint) in full f32."""
    stride = list(stride or (1,) * (w.ndim - 2))
    return _FullF32Conv.apply(x_cf, w, stride, transposed)


# ---------------------------------------------------------------------------
# Geometry (pure Python, shared with the kernel wrappers)
# ---------------------------------------------------------------------------

def _ntuple(v, rank: int) -> Tuple[int, ...]:
    """Normalise an int or length-``rank`` sequence to a rank-tuple."""
    if isinstance(v, (tuple, list)):
        if len(v) != rank:
            raise ValueError(f"expected {rank} spatial entries, got {v!r}")
        return tuple(int(x) for x in v)
    return (int(v),) * rank


def _pads_nd(padding, rank: int) -> Tuple[Tuple[int, int], ...]:
    """Normalise padding to ``((lo, hi),) * rank``: an int, a per-dim
    sequence of ints, or per-dim ``(lo, hi)`` pairs (for rank 1 a bare
    ``(lo, hi)`` int pair is the single dim's low/high padding)."""
    if isinstance(padding, int):
        return ((padding, padding),) * rank
    seq = tuple(padding)
    if rank == 1 and len(seq) == 2 and all(isinstance(a, int) for a in seq):
        return ((int(seq[0]), int(seq[1])),)
    if len(seq) != rank:
        raise ValueError(f"padding {padding!r} does not match rank {rank}")
    out = []
    for a in seq:
        if isinstance(a, int):
            out.append((a, a))
        else:
            lo, hi = a
            out.append((int(lo), int(hi)))
    return tuple(out)


def _check_padding(kernel: Sequence[int], padding) -> None:
    """Cropping more than K-1 per side would discard whole taps."""
    k = tuple(int(x) for x in kernel)
    for ki, (lo, hi) in zip(k, _pads_nd(padding, len(k))):
        if ki - 1 - lo < 0 or ki - 1 - hi < 0:
            raise ValueError(f"padding {padding} too large for kernel {k}")


def _check_output_padding(output_padding: Tuple[int, ...],
                          stride: Tuple[int, ...]) -> None:
    """``0 <= op < s`` per dim (ConvTransposeNd's constraint)."""
    for op, s in zip(output_padding, stride):
        if op < 0 or op >= max(s, 1):
            raise ValueError(
                f"output_padding {output_padding} must satisfy "
                f"0 <= op < stride {stride} per dim")


def _rank_of(kernel, stride) -> int:
    if isinstance(kernel, (tuple, list)):
        return len(kernel)
    return len(stride) if isinstance(stride, (tuple, list)) else 2


def same_deconv_pads(kernel, stride):
    """TF conv_transpose 'SAME' crop amounts (out = in*s) per dim."""
    rank = _rank_of(kernel, stride)
    k, s = _ntuple(kernel, rank), _ntuple(stride, rank)
    pads = []
    for ki, si in zip(k, s):
        a = max(ki - si, 0)
        pads.append((a // 2, a - a // 2))
    return tuple(pads)


def deconv_output_shape(in_space: Sequence[int], kernel, stride,
                        padding=0, output_padding=0) -> Tuple[int, ...]:
    """``(in-1)*s + K - p_lo - p_hi + op`` per dim."""
    rank = len(in_space)
    k, s = _ntuple(kernel, rank), _ntuple(stride, rank)
    pads = _pads_nd(padding, rank)
    op = _ntuple(output_padding, rank)
    return tuple((n - 1) * si + ki - lo - hi + opi
                 for n, ki, si, (lo, hi), opi
                 in zip(in_space, k, s, pads, op))


def sd_geometry(kernel, stride):
    """(K_T, P_K, P_I) per spatial dim — paper Eqs. (1), (2), (9)."""
    rank = _rank_of(kernel, stride)
    k, s = _ntuple(kernel, rank), _ntuple(stride, rank)
    kt = tuple(-(-ki // si) for ki, si in zip(k, s))        # ceil
    pk = tuple(si * kti - ki for ki, si, kti in zip(k, s, kt))
    pi = tuple(kti - 1 for kti in kt)
    return kt, pk, pi


# ---------------------------------------------------------------------------
# Layout helpers: channels-last (the port's API) <-> channels-first (F.conv)
# ---------------------------------------------------------------------------

def _to_cf(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _from_cf(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


def _filter_oi(w: torch.Tensor) -> torch.Tensor:
    """(*K, Cin, Cout) -> (Cout, Cin, *K), F.conv's filter layout."""
    rank = w.ndim - 2
    return w.permute(rank + 1, rank, *range(rank))


# ---------------------------------------------------------------------------
# Reference transposed convolution
# ---------------------------------------------------------------------------

def native_deconv(x: torch.Tensor, w: torch.Tensor, stride,
                  padding=0, output_padding=0) -> torch.Tensor:
    """Transposed conv via ``F.conv_transpose{1,2,3}d``.

    That op is the true adjoint of the strided conv, so the filter is
    only permuted to ``(Cin, Cout, *K)`` — not flipped (the reference
    flips because it uses the ``lhs_dilation`` form).  ``F``'s padding is
    symmetric, so the full output is computed and the asymmetric
    ``(lo, hi)`` crop (and any ``output_padding`` zero rows past the
    support) is applied here.
    """
    rank = w.ndim - 2
    s = _ntuple(stride, rank)
    k = tuple(w.shape[:rank])
    pads = _pads_nd(padding, rank)
    op = _ntuple(output_padding, rank)
    _check_padding(k, padding)
    _check_output_padding(op, s)
    wt = w.permute(rank, rank + 1, *range(rank))            # (Cin,Cout,*K)
    full = _from_cf(_conv(_to_cf(x), wt, s, transposed=True))
    out_space = deconv_output_shape(x.shape[1:1 + rank], k, s, padding,
                                    output_padding)
    return crop_interleaved(full, (0,) * rank, pads, out_space)


# ---------------------------------------------------------------------------
# Split Deconvolution
# ---------------------------------------------------------------------------

def split_filters(w: torch.Tensor, stride) -> torch.Tensor:
    """Offline filter transform (paper steps 1+2), any rank.

    w: (*K, C_in, C_out)  ->  (*K_T, C_in, prod(s)*C_out), n-major:
    channel ``n*C_out + oc`` holds sub-filter ``n`` (row-major over the
    per-dim phases), which is what ``depth_to_space`` expects.
    """
    rank = w.ndim - 2
    s = _ntuple(stride, rank)
    k = tuple(w.shape[:rank])
    cin, cout = w.shape[rank], w.shape[rank + 1]
    kt, pk, _ = sd_geometry(k, s)
    # 1) zero-expand on the LOW side of every spatial dim.
    we = w.new_zeros((*[si * kti for si, kti in zip(s, kt)], cin, cout))
    we[tuple(slice(p, None) for p in pk)] = w
    # 2) sample with stride s and rotate 180 deg per sub-filter:
    #    index u = m*s + p -> (m, p); tap t = K_T-1-m.
    shape = []
    for kti, si in zip(kt, s):
        shape += [kti, si]
    we = we.reshape(*shape, cin, cout).flip(
        tuple(2 * i for i in range(rank)))
    perm = ([2 * i for i in range(rank)] + [2 * rank]
            + [2 * i + 1 for i in range(rank)] + [2 * rank + 1])
    return we.permute(perm).reshape(*kt, cin, math.prod(s) * cout)


def unsplit_filters(ws: torch.Tensor, kernel, stride) -> torch.Tensor:
    """Exact inverse of :func:`split_filters` (a zero-pad then a
    permutation, so: the inverse permutation, then the crop)."""
    rank = ws.ndim - 2
    s = _ntuple(stride, rank)
    k = _ntuple(kernel, rank)
    kt, pk, _ = sd_geometry(k, s)
    cin = ws.shape[rank]
    cout = ws.shape[-1] // math.prod(s)
    we = ws.reshape(*kt, cin, *s, cout)
    perm = ([2 * i for i in range(rank)] + [2 * rank]
            + [2 * i + 1 for i in range(rank)] + [2 * rank + 1])
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    we = we.permute(inv).flip(tuple(2 * i for i in range(rank)))
    we = we.reshape(*[si * kti for si, kti in zip(s, kt)], cin, cout)
    return we[tuple(slice(p, None) for p in pk)]


def depth_to_space(y: torch.Tensor, stride) -> torch.Tensor:
    """Pixel-shuffle: (B, *S, prod(s)*C) -> (B, *(s*S), C), n-major."""
    rank = y.ndim - 2
    s = _ntuple(stride, rank)
    b = y.shape[0]
    space = y.shape[1:1 + rank]
    cout = y.shape[-1] // math.prod(s)
    y = y.reshape(b, *space, *s, cout)
    perm = [0]
    for i in range(rank):
        perm += [1 + i, 1 + rank + i]
    perm += [1 + 2 * rank]
    return y.permute(perm).reshape(
        b, *[n * si for n, si in zip(space, s)], cout)


def space_to_depth(x: torch.Tensor, stride) -> torch.Tensor:
    """Inverse pixel-shuffle: (B, *(s*S), C) -> (B, *S, prod(s)*C),
    n-major (the adjoint of :func:`depth_to_space`, used by the SD
    backward)."""
    rank = x.ndim - 2
    s = _ntuple(stride, rank)
    b = x.shape[0]
    space = x.shape[1:1 + rank]
    c = x.shape[-1]
    shape = []
    for n, si in zip(space, s):
        shape += [n // si, si]
    x = x.reshape(b, *shape, c)
    perm = ([0] + [1 + 2 * i for i in range(rank)]
            + [2 + 2 * i for i in range(rank)] + [1 + 2 * rank])
    return x.permute(perm).reshape(
        b, *[n // si for n, si in zip(space, s)], math.prod(s) * c)


def crop_interleaved(ps: torch.Tensor, pk, pads,
                     out_space) -> torch.Tensor:
    """P_K + user-padding crop of the interleaved output; zero-extends
    first when ``output_padding`` reaches past the shuffled support."""
    starts = [pki + lo for pki, (lo, _) in zip(pk, pads)]
    limits = [st + o for st, o in zip(starts, out_space)]
    grow = [max(0, lim - ps.shape[1 + i]) for i, lim in enumerate(limits)]
    if any(grow):
        pad = [0, 0]                     # F.pad lists dims last-first
        for g in reversed(grow):
            pad += [0, g]
        ps = F.pad(ps, pad)
    return ps[(slice(None),)
              + tuple(slice(st, lim) for st, lim in zip(starts, limits))]


def conv_valid(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 VALID channels-last conv, any rank."""
    return _from_cf(_conv(_to_cf(xp), _filter_oi(w)))


def conv_valid_filter_grad(xp: torch.Tensor,
                           dy1: torch.Tensor) -> torch.Tensor:
    """Gradient of ``y1 = conv_valid(xp, w)`` w.r.t. ``w``, any rank: a
    VALID stride-1 conv with the batch and channel axes exchanged (``xp``
    as ``Cin`` maps of ``B`` channels, ``dy1`` as the filter bank).
    xp: (B, *S, Cin), dy1: (B, *O1, Co) -> (*KT, Cin, Co)."""
    rank = xp.ndim - 2
    lhs = xp.movedim(-1, 0).movedim(1, -1)          # (Cin, *S, B)
    rhs = dy1.movedim(0, rank)                      # (*O1, B, Co)
    return conv_valid(lhs, rhs).movedim(0, rank)    # (*KT, Cin, Co)


def sd_deconv_presplit(x: torch.Tensor, ws: torch.Tensor, kernel,
                       stride, padding=0, conv_fn=None,
                       output_padding=0) -> torch.Tensor:
    """Runtime SD (paper steps 3+4) given pre-split n-major filters:
    pad by ``P_I``, one grouped stride-1 conv, pixel-shuffle, crop.
    ``conv_fn(xp, ws)`` may override the stride-1 VALID conv."""
    rank = x.ndim - 2
    s = _ntuple(stride, rank)
    k = _ntuple(kernel, rank)
    pads = _pads_nd(padding, rank)
    op = _ntuple(output_padding, rank)
    _check_padding(k, padding)
    _check_output_padding(op, s)
    _, pk, pi = sd_geometry(k, s)
    out_space = deconv_output_shape(x.shape[1:1 + rank], k, s, padding,
                                    output_padding)
    pad = [0, 0]
    for p in reversed(pi):
        pad += [p, p]
    xp = F.pad(x, pad)
    y = (conv_fn or conv_valid)(xp, ws)
    return crop_interleaved(depth_to_space(y, s), pk, pads, out_space)


def sd_deconv(x: torch.Tensor, w: torch.Tensor, stride,
              padding=0, conv_fn=None, output_padding=0) -> torch.Tensor:
    """Split Deconvolution end to end (splits the filter inline)."""
    rank = w.ndim - 2
    return sd_deconv_presplit(x, split_filters(w, stride), w.shape[:rank],
                              stride, padding, conv_fn, output_padding)


# ---------------------------------------------------------------------------
# Standard convolution (the models' conv layers)
# ---------------------------------------------------------------------------

def conv_nd(x: torch.Tensor, w: torch.Tensor, stride=1,
            padding="SAME") -> torch.Tensor:
    """Channels-last cross-correlation, any rank.  ``padding`` is TF
    ``"SAME"`` (out = ceil(in/s), the extra row on the HIGH side — k7/s2
    on 256 pads (2, 3)), ``"VALID"``, an int, or per-dim ``(lo, hi)``
    pairs.  ``F.conv*d(padding="same")`` rejects strides and pads
    symmetrically, so the pads are computed here and applied with
    ``F.pad``."""
    rank = w.ndim - 2
    s = _ntuple(stride, rank)
    space = x.shape[1:1 + rank]
    k = w.shape[:rank]
    if padding == "SAME":
        pads = []
        for n, ki, si in zip(space, k, s):
            total = max((-(-n // si) - 1) * si + ki - n, 0)
            pads.append((total // 2, total - total // 2))
    elif padding == "VALID":
        pads = [(0, 0)] * rank
    else:
        pads = _pads_nd(padding, rank)
    pad = [0, 0]
    for lo, hi in reversed(pads):
        pad += [lo, hi]
    xp = F.pad(x, pad)
    return _from_cf(_conv(_to_cf(xp), _filter_oi(w), s))

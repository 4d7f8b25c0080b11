"""Deconv-level wrappers around the port's kernels.

:func:`sd_deconv_presplit_fused` turns a transposed-conv geometry
(kernel, stride, padding, output_padding) into what the kernel is
handed: the ``P_I`` pad per side (applied in the kernel by masked
reads), the low-side crop ``P_K + pad_lo`` (split inside
:func:`~repro_torch.kernels.sd_conv.gemm_launch` into ``q = crop // s``
whole conv rows and a residual ``r = crop % s``) and the final output
shape.  The kernel writes each output element once; no padded or
uncropped copy exists.  :func:`sd_deconv_presplit_wino` does the same
for K4 from the Winograd-transformed filters.

:func:`sd_deconv_presplit_fused_1d` and :func:`sd_deconv_presplit_wino_1d`
are the 1-D lowerings: the length axis becomes the width of an H=1 2-D
launch of K1 (either branch) or K4, with a ``(1, K)`` filter, a ``(1,
s)`` interleave and the pads on the width.

:func:`sd_deconv_presplit_fused_3d` is the 3-D lowering: depth folded
into the batch, one K2 launch per depth tap (K2's int8 pair on int8
operands), the taps summed outside the kernel, then ``depth_to_space``
and the epilogue in stock torch ops (for a chained int8 layer, the
requantization too, as the reference's lowering does it in XLA ops).

:func:`sd_input_grad_fused` and :func:`sd_filter_grad_fused` are the SD
backward's two convolutions on K2 and K3 (see :mod:`repro_torch.sd.grad`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.deconv import (_check_output_padding, _check_padding,
                                     _ntuple, _pads_nd, crop_interleaved,
                                     deconv_output_shape, depth_to_space,
                                     sd_geometry)
from repro_torch.kernels.autotune import GemmPlan, WinoPlan
from repro_torch.kernels.sd_conv import (_apply_act, check_no_grad,
                                         quant_contract, requantize, sd_conv,
                                         sd_filter_grad, sd_fused)
from repro_torch.kernels.winograd import sd_wino


def _deconv_launch(x_shape, kernel, stride, padding, output_padding):
    """``(s, K_T, pad, crop, out_space)`` of a 2-D transposed conv's
    fused launch: the ``P_I`` pad per side, the low-side crop ``P_K +
    pad_lo`` and the final output shape."""
    s = _ntuple(stride, 2)
    op = _ntuple(output_padding, 2)
    k = _ntuple(kernel, 2)
    _check_padding(k, padding)
    _check_output_padding(op, s)
    pads = _pads_nd(padding, 2)
    kt, pk, pi = sd_geometry(k, s)
    out_space = tuple(deconv_output_shape(x_shape[1:3], k, s, padding,
                                          output_padding))
    crop = tuple(pki + lo for pki, (lo, _) in zip(pk, pads))
    return s, kt, tuple((p, p) for p in pi), crop, out_space


def sd_deconv_presplit_fused(x: torch.Tensor, ws_ocmajor: torch.Tensor,
                             kernel, stride, padding=0, *,
                             output_padding=0,
                             bias: Optional[torch.Tensor] = None,
                             act: str = "linear",
                             scale: Optional[torch.Tensor] = None,
                             out_dtype: Optional[torch.dtype] = None,
                             plan: Optional[GemmPlan] = None
                             ) -> torch.Tensor:
    """2-D transposed conv from pre-split oc-major filters in one fused
    launch: x (B, H, W, Cin), ws_ocmajor (KTh, KTw, Cin, Cout*sh*sw).

    An int8 ``(x, ws_ocmajor)`` pair with the combined dequant ``scale``
    ((B, Cout*sh*sw), or a static (1, Cout*sh*sw) row) runs K1's int8
    branch and returns f32, or int8 for ``out_dtype=torch.int8`` (the
    chained epilogue; see :func:`~repro_torch.kernels.sd_conv.sd_fused`)."""
    s, _, pad, crop, out_space = _deconv_launch(x.shape, kernel, stride,
                                                padding, output_padding)
    if any(o == 0 for o in out_space):
        # Degenerate geometry: nothing to launch.
        qdtype = quant_contract(x, ws_ocmajor, scale, out_dtype, act)
        cout = ws_ocmajor.shape[-1] // (s[0] * s[1])
        return x.new_zeros((x.shape[0], *out_space, cout),
                           dtype=qdtype or x.dtype)
    return sd_fused(x, ws_ocmajor, s, bias=bias, act=act, pad=pad,
                    crop=crop, out_space=out_space, plan=plan, scale=scale,
                    out_dtype=out_dtype)


def sd_deconv_presplit_wino(x: torch.Tensor, u: torch.Tensor, kernel,
                            stride, padding=0, *, output_padding=0,
                            bias: Optional[torch.Tensor] = None,
                            act: str = "linear",
                            plan: Optional[WinoPlan] = None
                            ) -> torch.Tensor:
    """2-D transposed conv from *pre-transformed* Winograd filters in one
    K4 launch: x (B, H, W, Cin), u the oc-major split filters after
    :func:`~repro_torch.kernels.winograd.transform_filters`, ``(alpha_h,
    alpha_w, Cin, Cout*sh*sw)``.  The launch is
    :func:`sd_deconv_presplit_fused`'s: ``P_I`` pad, crop ``P_K +
    pad_lo``, final output shape."""
    s, kt, pad, crop, out_space = _deconv_launch(x.shape, kernel, stride,
                                                 padding, output_padding)
    if any(o == 0 for o in out_space):
        cout = u.shape[-1] // (s[0] * s[1])
        return x.new_zeros((x.shape[0], *out_space, cout))
    return sd_wino(x, u, kt, s, bias=bias, act=act, pad=pad, crop=crop,
                   out_space=out_space, plan=plan)


def sd_deconv_presplit_wino_1d(x: torch.Tensor, u: torch.Tensor, kernel,
                               stride, padding=0, *, output_padding=0,
                               bias: Optional[torch.Tensor] = None,
                               act: str = "linear",
                               plan: Optional[WinoPlan] = None
                               ) -> torch.Tensor:
    """1-D Winograd SD as an H=1 launch of K4 (reference:
    ``ops.sd_deconv_presplit_wino_1d``): x (B, L, Cin), u the transformed
    oc-major filters ``(alpha, Cin, Cout*s)``.  The unit H axis takes the
    degenerate F(1,1) transform (``alpha_h = 1``), so no product is
    spent on it."""
    (k,) = _ntuple(kernel, 1)
    (s,) = _ntuple(stride, 1)
    ((lo, hi),) = _pads_nd(padding, 1)
    (op,) = _ntuple(output_padding, 1)
    y = sd_deconv_presplit_wino(
        x[:, None], u[None], (1, k), (1, s), ((0, 0), (lo, hi)),
        output_padding=(0, op), bias=bias, act=act, plan=plan)
    return y[:, 0]


def sd_deconv_presplit_fused_1d(x: torch.Tensor, ws_ocmajor: torch.Tensor,
                                kernel, stride, padding=0, *,
                                output_padding=0,
                                bias: Optional[torch.Tensor] = None,
                                act: str = "linear",
                                scale: Optional[torch.Tensor] = None,
                                out_dtype: Optional[torch.dtype] = None,
                                plan: Optional[GemmPlan] = None
                                ) -> torch.Tensor:
    """1-D SD as an H=1 launch of K1 (reference:
    ``ops.sd_deconv_presplit_fused_1d``).

    x: (B, L, Cin); ws_ocmajor: (KT, Cin, Cout*s), channel ``oc*s +
    phase``.  The length axis is the kernel's width axis (a ``(1, KT)``
    filter, interleave ``(1, s)``), so the in-kernel pad and crop act on
    it.  int8: ``scale`` is (B, Cout*s) or a static (1, Cout*s) row,
    oc-major, an order the ``(1, s)`` lowering keeps; ``out_dtype`` as
    in :func:`sd_deconv_presplit_fused`.  The views ``x[:, None]`` and
    ``y[:, 0]`` are contiguous: nothing is copied."""
    (k,) = _ntuple(kernel, 1)
    (s,) = _ntuple(stride, 1)
    ((lo, hi),) = _pads_nd(padding, 1)
    (op,) = _ntuple(output_padding, 1)
    y = sd_deconv_presplit_fused(
        x[:, None], ws_ocmajor[None], (1, k), (1, s), ((0, 0), (lo, hi)),
        output_padding=(0, op), bias=bias, act=act, scale=scale,
        out_dtype=out_dtype, plan=plan)
    return y[:, 0]


def sd_deconv_presplit_fused_3d(x: torch.Tensor, ws_nmajor: torch.Tensor,
                                kernel, stride, padding=0, *,
                                output_padding=0,
                                bias: Optional[torch.Tensor] = None,
                                act: str = "linear",
                                scale: Optional[torch.Tensor] = None,
                                out_dtype: Optional[torch.dtype] = None,
                                plan: Optional[GemmPlan] = None
                                ) -> torch.Tensor:
    """3-D transposed conv from pre-split n-major filters, depth folded
    into the batch (reference: ``ops.sd_deconv_presplit_fused_3d``).

    x: (B, D, H, W, Cin); ws_nmajor: (KT_d, KT_h, KT_w, Cin, N*Cout),
    ``N = s_d*s_h*s_w``.  Each depth tap ``td`` of the split stride-1
    conv is a 2-D conv of a shifted band of depth slices, so it runs as
    one K2 launch with ``(B * D_out)`` as the batch and the H/W ``P_I``
    pads applied in the kernel; only the depth pad is made real in
    memory.  The taps are summed outside the kernel, in order, then the
    3-D interleave (``depth_to_space``), crop, bias and activation run
    as stock torch ops.

    int8 (an int8 ``(x, ws_nmajor)`` pair with the n-major ``scale``,
    (B, N*Cout) or a static (1, N*Cout) row broadcast over the batch):
    each tap is K2's int8 pair, exact int32, summed in int32; the sum is
    cast once to f32 and dequantized per (sample, n-major phase channel)
    before the interleave, then crop, bias and act; output f32, or for
    ``out_dtype=torch.int8`` (a chained layer, linear or relu) rounded
    half to even and clamped to +-127 into int8, the reference's order
    (``src/repro/kernels/ops.py:450-463``)."""
    s = _ntuple(stride, 3)
    k = _ntuple(kernel, 3)
    pads = _pads_nd(padding, 3)
    op = _ntuple(output_padding, 3)
    _check_padding(k, padding)
    _check_output_padding(op, s)
    (ktd, kth, ktw), pk, pi = sd_geometry(k, s)
    if x.ndim != 5 or tuple(ws_nmajor.shape[:3]) != (ktd, kth, ktw) \
            or ws_nmajor.shape[3] != x.shape[-1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, ws "
                         f"{tuple(ws_nmajor.shape)} are not (B,D,H,W,Cin), "
                         f"({ktd},{kth},{ktw},Cin,N*Cout)")
    qdtype = quant_contract(x, ws_nmajor, scale, out_dtype, act)
    quant = qdtype is not None
    if x.device.type == "cuda":
        # K2's output carries no graph: the differentiable path is
        # repro_torch.sd.conv_transpose.
        check_no_grad("sd_deconv_presplit_fused_3d", x, ws_nmajor)
    out_space = deconv_output_shape(x.shape[1:4], k, s, padding,
                                    output_padding)
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, pi[0], pi[0]))
    b, dp, h, wd, cin = xp.shape
    od = dp - ktd + 1
    oh1, ow1 = h + 2 * pi[1] - kth + 1, wd + 2 * pi[2] - ktw + 1
    nco = ws_nmajor.shape[-1]
    hw_pad = ((pi[1], pi[1]), (pi[2], pi[2]))
    terms = cin * ktd * kth * ktw if quant else None
    acc = None
    for td in range(ktd):
        xs = xp[:, td:td + od].reshape(b * od, h, wd, cin)
        y2 = sd_conv(xs, ws_nmajor[td], pad=hw_pad, plan=plan,
                     sum_terms=terms)
        if not quant:                    # int8 taps stay exact int32
            y2 = y2.float()
        acc = y2 if acc is None else acc.add_(y2)
    y = acc.reshape(b, od, oh1, ow1, nco)
    if quant:
        # Dequant before the interleave: n-major phase channels carry
        # distinct scales (per-sample activation x per-channel filter; a
        # static row broadcasts over the batch).
        y = y.float() * scale.reshape(-1, 1, 1, 1, nco)
    out = crop_interleaved(depth_to_space(y, s), pk, pads, out_space)
    if bias is not None:
        out = out + bias.float()
    out = _apply_act(out, act)
    if qdtype == torch.int8:
        return requantize(out)
    return out.to(qdtype or x.dtype)


# ---------------------------------------------------------------------------
# Backward convolutions (the SD training path, see repro_torch.sd.grad)
# ---------------------------------------------------------------------------

sd_conv2d_valid = sd_conv   # the reference's name for K2's entry point


def sd_input_grad_fused(dy1: torch.Tensor, ws: torch.Tensor, pi, space,
                        plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """Gradient of ``y1 = conv_valid(pad(x, P_I), ws)`` w.r.t. ``x`` on
    K2: a FULL stride-1 conv of ``dy1`` with the split filters rotated
    180 degrees and their in/out channels swapped.  The FULL-conv pad
    ``K_T - 1`` is masked reads and the pad^T crop is the launch's output
    window, so ``dx`` is written once at its final shape.  The rotation
    and swap are a copy of the filters here (``K_T^2 * Cin * N*Co``
    values, small beside the activations), not reversed indexing in the
    kernel.

    dy1: (B, O1h, O1w, N*Co); ws: (KTh, KTw, Cin, N*Co) split filters;
    returns dx: (B, *space, Cin)."""
    kth, ktw = ws.shape[0], ws.shape[1]
    w_t = ws.flip(0, 1).transpose(-1, -2).contiguous()
    return sd_conv(dy1, w_t, pad=((kth - 1, kth - 1), (ktw - 1, ktw - 1)),
                   out_start=tuple(pi), out_size=tuple(space), plan=plan)


def sd_filter_grad_fused(x: torch.Tensor, dy1: torch.Tensor, kt, pi,
                         plan: Optional[GemmPlan] = None
                         ) -> torch.Tensor:
    """Gradient of ``y1 = conv_valid(pad(x, P_I), ws)`` w.r.t. ``ws`` on
    K3, the ``P_I`` pad applied in the kernel (no padded copy of ``x``).
    x: (B, H, W, Cin) unpadded; dy1: (B, O1h, O1w, N*Co); returns dws:
    (KTh, KTw, Cin, N*Co)."""
    return sd_filter_grad(x, dy1, tuple(kt),
                          pad=tuple((p, p) for p in pi), plan=plan)

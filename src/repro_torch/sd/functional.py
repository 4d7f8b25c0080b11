"""Split-deconvolution entry points: the differentiable transposed conv
and the presplit-once deployment path.

:func:`conv_transpose` is the training form: a geometry-only plan plus
the raw filter, split on every call, differentiable in ``x``, ``w`` and
``b`` through :mod:`repro_torch.sd.grad` (on a ``fused`` plan the
forward is K1 and the backward K2 + K3).  :func:`execute` runs a *bound* plan: pre-split (scale-folded) filters,
bias and activation in the epilogue, no splitting on the hot path.  The
``"fused"`` backend is one launch of the fused CUDA kernel (or its plain
version for a CPU tensor); ``"winograd"`` one launch of K4 from the
filters ``bind`` transformed (``conv_transpose`` transforms the freshly
split filters in the call; its backward is the plain torch formulation,
as in the reference, which sends only ``"fused"`` to the kernels);
``"torch"`` is the grouped stride-1 conv + pixel shuffle + crop in plain
PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.deconv import sd_deconv_presplit, split_filters
from repro_torch.kernels.sd_conv import _apply_act
from repro_torch.sd.grad import conv_transpose_vjp
from repro_torch.sd.plan import DeconvPlan, to_ocmajor


def _run_presplit(plan: DeconvPlan, x: torch.Tensor, ws: torch.Tensor,
                  layout: str, bias: Optional[torch.Tensor],
                  act: str) -> torch.Tensor:
    """Dispatch pre-split filters to the plan's backend."""
    if plan.backend == "winograd":
        from repro_torch.kernels import ops
        from repro_torch.kernels.winograd import transform_filters
        u = ws if layout == "wino" else transform_filters(
            to_ocmajor(ws, plan.stride))
        return ops.sd_deconv_presplit_wino(
            x, u, plan.kernel, plan.stride, plan.padding,
            output_padding=plan.output_padding, bias=bias, act=act,
            plan=plan.tile)
    if plan.backend == "fused":
        from repro_torch.kernels import ops
        ws_oc = ws if layout == "ocmajor" else to_ocmajor(ws, plan.stride)
        return ops.sd_deconv_presplit_fused(
            x, ws_oc, plan.kernel, plan.stride, plan.padding,
            output_padding=plan.output_padding, bias=bias, act=act,
            plan=plan.tile)
    if layout != "nmajor":
        raise ValueError("the torch backend consumes n-major filters")
    y = sd_deconv_presplit(x, ws.to(x.dtype), plan.kernel, plan.stride,
                           plan.padding, output_padding=plan.output_padding)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return _apply_act(y, act)


def execute(plan: DeconvPlan, x: torch.Tensor) -> torch.Tensor:
    """Run a bound plan (the hot path of the engine)."""
    if not plan.bound:
        raise ValueError("execute() needs a bound plan; call "
                         "plan.bind(w, scale, bias) once offline")
    return _run_presplit(plan, x, plan.ws, plan.layout, plan.bias, plan.act)


class _ConvTranspose(torch.autograd.Function):
    """Forward: split ``w``, run the plan's backend with no epilogue, add
    ``b``.  Backward: :func:`conv_transpose_vjp`; ``db`` is reduced in
    f32 over the batch and every spatial axis."""

    @staticmethod
    def forward(ctx, plan, x, w, b):
        ctx.plan = plan
        ctx.save_for_backward(x, w, b)
        ws = split_filters(w, plan.stride)
        y = _run_presplit(plan, x, ws, "nmajor", None, "linear")
        return y if b is None else y + b.to(y.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        dx, dw = conv_transpose_vjp(ctx.plan, x, w, dy)
        db = (dy.float().sum(dim=tuple(range(dy.ndim - 1))).to(b.dtype)
              if b is not None else None)
        return None, dx, dw, db


def conv_transpose(plan: DeconvPlan, x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transposed convolution of ``x`` with the raw filter ``w`` (``(*K,
    Cin, Cout)``) through the split layout, differentiable in ``x``, ``w``
    and ``b``.  ``plan`` must be geometry-only; no activation is applied
    (compose it outside)."""
    if plan.bound:
        raise ValueError("conv_transpose takes a geometry-only plan plus "
                         "the raw filter; use execute(plan, x) for bound "
                         "plans")
    return _ConvTranspose.apply(plan, x, w, b)


def split_weights(plan: DeconvPlan, w: torch.Tensor) -> torch.Tensor:
    """The offline filter transform for ``plan`` (n-major layout);
    differentiable (a pad and a permutation)."""
    return split_filters(w, plan.stride)

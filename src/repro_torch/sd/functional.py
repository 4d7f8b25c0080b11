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
PyTorch.  A rank-3 ``"fused"`` plan runs the depth-folded lowering, one
K2 launch per depth tap
(:func:`~repro_torch.kernels.ops.sd_deconv_presplit_fused_3d`); its
backward is the plain torch formulation, as in the reference.

A bound int8 plan runs :func:`_run_presplit_int8`: activations quantized
per sample, int8 x int8 sums, the combined dequant scale applied per
(sample, phase channel) before the interleave, f32 out.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.deconv import sd_deconv_presplit, split_filters
from repro_torch.core.quant import quantize_act
from repro_torch.kernels.sd_conv import _apply_act, exact_conv_valid
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
        if plan.rank == 3:
            # Depth folded into the batch, one K2 launch per depth tap,
            # then the torch interleave: consumes n-major filters.
            if layout != "nmajor":
                raise ValueError("the 3-D fused lowering consumes n-major "
                                 "filters")
            return ops.sd_deconv_presplit_fused_3d(
                x, ws, plan.kernel, plan.stride, plan.padding,
                output_padding=plan.output_padding, bias=bias, act=act,
                plan=plan.tile)
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


def _run_presplit_int8(plan: DeconvPlan, x: torch.Tensor) -> torch.Tensor:
    """The dynamic int8 path of a bound int8 plan (reference:
    ``repro.sd.functional._run_presplit_int8`` without calibration).

    The f32 input is quantized per sample (:func:`quantize_act`, so the
    zero rows of a padded bucket never touch a real sample), the split
    conv sums int8 x int8 exactly, and ``comb = sx[:, None] *
    wscale[None, :]`` dequantizes each (sample, phase channel) sum before
    the interleave.  ``fused``: K1's int8 branch on the card, its plain
    version on the CPU.  ``torch``: the n-major grouped conv summed
    exactly (:func:`exact_conv_valid`, where the reference's xla path
    convolves f32-cast operands), rounded to f32 once and dequantized
    per n-major channel before the pixel shuffle.  Rank 3 on ``fused``:
    the depth-folded lowering with K2's int8 pair per depth tap, from
    n-major filters and the n-major scale; the per-sample quantization
    runs here, over each sample's whole volume, before the lowering
    folds depth into the batch.  Output f32."""
    if x.dtype == torch.int8:
        raise ValueError("int8 input requires a calibrated plan (sx_in); "
                         "the dynamic path has no scale for it")
    xq, sx = quantize_act(x)
    comb = sx[:, None] * plan.wscale.float()[None, :]
    if plan.backend == "fused" and plan.rank == 3:
        from repro_torch.kernels import ops
        if plan.layout != "nmajor":
            raise ValueError("the 3-D fused int8 lowering consumes n-major "
                             "filters")
        return ops.sd_deconv_presplit_fused_3d(
            xq, plan.ws, plan.kernel, plan.stride, plan.padding,
            output_padding=plan.output_padding, bias=plan.bias,
            act=plan.act, scale=comb.contiguous(), plan=plan.tile)
    if plan.backend == "fused":
        from repro_torch.kernels import ops
        if plan.layout != "ocmajor":
            raise ValueError("the fused int8 branch consumes oc-major "
                             "filters")
        return ops.sd_deconv_presplit_fused(
            xq, plan.ws, plan.kernel, plan.stride, plan.padding,
            output_padding=plan.output_padding, bias=plan.bias,
            act=plan.act, scale=comb.contiguous(), plan=plan.tile)
    if plan.backend != "torch" or plan.layout != "nmajor":
        raise ValueError(f"int8 plans run on the fused or torch backend, "
                         f"not {plan.backend!r} ({plan.layout})")
    lead = (comb.shape[0],) + (1,) * plan.rank

    def conv_fn(xp, wsq):
        return exact_conv_valid(xp, wsq).float() * comb.reshape(
            *lead, comb.shape[1])

    y = sd_deconv_presplit(xq, plan.ws, plan.kernel, plan.stride,
                           plan.padding, conv_fn=conv_fn,
                           output_padding=plan.output_padding)
    if plan.bias is not None:
        y = y + plan.bias.float()
    return _apply_act(y, plan.act)


def execute(plan: DeconvPlan, x: torch.Tensor) -> torch.Tensor:
    """Run a bound plan (the hot path of the engine)."""
    if not plan.bound:
        raise ValueError("execute() needs a bound plan; call "
                         "plan.bind(w, scale, bias) once offline")
    if plan.dtype == "int8":
        return _run_presplit_int8(plan, x)
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
    if plan.dtype == "int8":
        raise ValueError(
            "int8 plans are inference-only: quantization is not usefully "
            "differentiable; bind() the plan and use sd.execute, or build "
            "a dtype='native' plan to train")
    return _ConvTranspose.apply(plan, x, w, b)


def split_weights(plan: DeconvPlan, w: torch.Tensor) -> torch.Tensor:
    """The offline filter transform for ``plan`` (n-major layout);
    differentiable (a pad and a permutation)."""
    return split_filters(w, plan.stride)

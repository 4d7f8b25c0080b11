"""The presplit-once deployment entry point, forward only.

:func:`execute` runs a *bound* plan: pre-split (scale-folded) filters,
bias and activation in the epilogue, no splitting on the hot path.  The
``"fused"`` backend is one launch of the fused CUDA kernel (or its plain
version for a CPU tensor); ``"torch"`` is the grouped stride-1 conv +
pixel shuffle + crop in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.deconv import sd_deconv_presplit
from repro_torch.kernels.sd_conv import _apply_act
from repro_torch.sd.plan import DeconvPlan, to_ocmajor


def _run_presplit(plan: DeconvPlan, x: torch.Tensor, ws: torch.Tensor,
                  layout: str, bias: Optional[torch.Tensor],
                  act: str) -> torch.Tensor:
    """Dispatch pre-split filters to the plan's backend."""
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

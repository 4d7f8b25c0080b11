"""Deconv-level wrapper around the fused split-deconv kernel.

:func:`sd_deconv_presplit_fused` turns a transposed-conv geometry
(kernel, stride, padding, output_padding) into what the kernel is
handed: the ``P_I`` pad per side (applied in the kernel by masked
reads), the low-side crop ``P_K + pad_lo`` (split inside
:func:`~repro_torch.kernels.sd_conv.launch_geometry` into ``q = crop //
s`` whole conv rows and a residual ``r = crop % s``) and the final
output shape.  The kernel writes each output element once; no padded or
uncropped copy exists.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.deconv import (_check_output_padding, _check_padding,
                                     _ntuple, _pads_nd, deconv_output_shape,
                                     sd_geometry)
from repro_torch.kernels.autotune import KernelPlan
from repro_torch.kernels.sd_conv import sd_fused


def sd_deconv_presplit_fused(x: torch.Tensor, ws_ocmajor: torch.Tensor,
                             kernel, stride, padding=0, *,
                             output_padding=0,
                             bias: Optional[torch.Tensor] = None,
                             act: str = "linear",
                             plan: Optional[KernelPlan] = None
                             ) -> torch.Tensor:
    """2-D transposed conv from pre-split oc-major filters in one fused
    launch: x (B, H, W, Cin), ws_ocmajor (KTh, KTw, Cin, Cout*sh*sw)."""
    s = _ntuple(stride, 2)
    op = _ntuple(output_padding, 2)
    k = _ntuple(kernel, 2)
    _check_padding(k, padding)
    _check_output_padding(op, s)
    pads = _pads_nd(padding, 2)
    _, pk, (pih, piw) = sd_geometry(k, s)
    out_space = deconv_output_shape(x.shape[1:3], k, s, padding,
                                    output_padding)
    if any(o == 0 for o in out_space):
        cout = ws_ocmajor.shape[-1] // (s[0] * s[1])
        return x.new_zeros((x.shape[0], *out_space, cout))
    crop = tuple(pki + lo for pki, (lo, _) in zip(pk, pads))
    return sd_fused(x, ws_ocmajor, s, bias=bias, act=act,
                    pad=((pih, pih), (piw, piw)), crop=crop,
                    out_space=tuple(out_space), plan=plan)

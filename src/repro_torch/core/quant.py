"""Symmetric int8 quantization for the port's int8 serving path.

The port's own copy of the reference's ``core/quant.py`` (dynamic half):
symmetric, zero-point 0, scales ``amax / 127`` in f32, values
``clip(round(x / scale), -127, 127)`` with ``torch.round``
(half-to-even, as ``jnp.round``), so a zero stays exactly zero and the
kernels' masked halo reads can zero-fill in int8.

* :func:`quantize` / :func:`dequantize` — one per-tensor scale.
* :func:`quantize_channelwise` — one scale per slice of ``axis``: the
  filter quantizer ``DeconvPlan.bind`` runs on the split, BN-folded
  filters (every split output channel gets its own scale).
* :func:`quantize_act` — one scale per sample (axis 0), computed on the
  hot path, so the zero rows a bucketed server pads a batch with never
  change a real sample's quantization.

The static (calibrated) half — a saturating quantizer against a fixed
scale, the calibration statistics and their cache — comes with the
calibrated int8 chain (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import torch

QMAX = 127.0          # symmetric int8: [-127, 127], zero-point 0
_EPS = 1e-12          # all-zero tensors quantize to zeros, not NaNs


def _to_q(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -QMAX, QMAX).to(torch.int8)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax, _EPS) / QMAX


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one per-tensor scale: ``(q, scale)`` with
    ``x ~= q * scale``."""
    xf = x.float()
    scale = _scale(xf.abs().max())
    return _to_q(xf, scale), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_channelwise(w: torch.Tensor, axis: int = -1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per slice of ``axis``: ``(q,
    scales)``, ``scales`` 1-D of length ``w.shape[axis]``, ``w ~= q *
    scales`` broadcast along ``axis``."""
    axis = axis % w.ndim
    wf = w.float()
    others = tuple(i for i in range(w.ndim) if i != axis)
    scales = _scale(wf.abs().amax(dim=others))
    shape = [1] * w.ndim
    shape[axis] = w.shape[axis]
    return _to_q(wf, scales.reshape(shape)), scales


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 for a batched activation, one scale per
    sample: ``(q, scales)`` with ``scales`` of shape ``(B,)``.  Sample
    ``i``'s codes are a function of sample ``i`` alone."""
    xf = x.float()
    scales = _scale(xf.abs().amax(dim=tuple(range(1, x.ndim))))
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return _to_q(xf, scales.reshape(shape)), scales

"""Symmetric int8 quantization for the port's int8 serving path.

The port's own copy of the reference's ``core/quant.py``. The dynamic half:
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

The static (calibrated) half, the reference's ``:109-195``:

* :func:`quantize_static` — against a fixed, calibration-time scale: no
  reduction on the hot path, out-of-range values saturate at +-127 (never
  wrap) and NaN quantizes to 0.
* :func:`amax_stat` / :func:`scale_from_amax` — the calibration
  statistic of an activation (``"max"`` or ``"pct"``) and its scale.
* :func:`load_calib` / :func:`save_calib` — the calibration cache, the
  port's own file: ``$REPRO_TORCH_SD_CALIB_CACHE``, default
  ``~/.cache/repro_torch/sd_calib.json`` (never the reference's).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.iohelpers import atomic_write_json, read_json

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


# ---------------------------------------------------------------------------
# Static calibration: pre-computed scales, saturating clamp, scale cache.
# ---------------------------------------------------------------------------

def quantize_static(x: torch.Tensor, scale) -> torch.Tensor:
    """Quantize against a static (calibration-time) scale: ``x / scale``
    (a true f32 division), round half to even, clamp to +-127 (so +-inf
    saturates and nothing wraps), NaN to 0, in that order."""
    q = torch.round(x.float() / torch.as_tensor(scale, dtype=torch.float32,
                                                device=x.device))
    q = torch.clamp(q, -QMAX, QMAX)
    return torch.where(torch.isnan(q), 0.0, q).to(torch.int8)


def amax_stat(x: torch.Tensor, policy: str = "max",
              pct: float = 99.9) -> torch.Tensor:
    """One calibration statistic of ``|x|`` over the whole tensor, a 0-d
    f32 tensor: ``"max"`` the exact amax; ``"pct"`` the ``pct``-th
    percentile with ``jnp.percentile``'s linear interpolation between
    the sorted values at ``floor`` and ``ceil`` of the position, any NaN
    making it NaN.  The f32 steps are those the reference's compiled
    percentile takes on the CPU, so the two agree bit for bit: XLA folds
    ``(pct / 100) * (n - 1)`` into ``pct * c`` with ``c = f32(0.01) *
    (n - 1)`` rounded to f32, and contracts the last multiply-add into
    one FMA (restated in f64: the exact product plus an f32 term, rounded
    once more to f32)."""
    a = x.float().abs().reshape(-1)
    if policy == "max":
        return a.max()
    if policy != "pct":
        raise ValueError(f"unknown calibration policy {policy!r}; "
                         "choose from ('max', 'pct')")
    if torch.isnan(a).any():
        return a.new_tensor(float("nan"))
    a = torch.sort(a).values
    n = a.numel()
    f32 = dict(dtype=torch.float32)
    c = torch.tensor(0.01, **f32) * torch.tensor(float(n - 1), **f32)
    pos = torch.tensor(pct, **f32) * c
    low = torch.floor(pos)
    hw = pos - low
    lw = 1 - hw
    lo, hi = (a[int(min(max(v.item(), 0), n - 1))].cpu()
              for v in (low, torch.ceil(pos)))
    out = (hi.double() * hw.double() + (lo * lw).double()).float()
    return out.to(x.device)


def scale_from_amax(amax) -> float:
    """The symmetric int8 scale for a calibrated amax, floored at _EPS so
    an all-zero calibration tensor gives a finite scale."""
    return float(max(float(amax), _EPS) / QMAX)


# Calibration-scale cache: {"version": 1, "scales": {key: {layer: s}}}.
_ENV_CALIB = "REPRO_TORCH_SD_CALIB_CACHE"


def calib_cache_path(path: Optional[str] = None) -> str:
    """``path``, else ``$REPRO_TORCH_SD_CALIB_CACHE``, else
    ``~/.cache/repro_torch/sd_calib.json``."""
    return path or os.environ.get(_ENV_CALIB) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "sd_calib.json")


def load_calib(key: str,
               path: Optional[str] = None) -> Optional[Dict[str, float]]:
    """Per-layer static activation scales recorded under ``key`` (e.g.
    ``"dcgan/max"``), or None when the cache has no entry."""
    data = read_json(calib_cache_path(path))
    if not isinstance(data, dict):
        return None
    entry = data.get("scales", {}).get(key)
    if not isinstance(entry, dict):
        return None
    return {str(k): float(v) for k, v in entry.items()}


def save_calib(key: str, scales: Dict[str, float],
               path: Optional[str] = None) -> str:
    """Persist per-layer scales under ``key`` (read-modify-write of the
    whole document, replaced atomically: last writer wins per key)."""
    p = calib_cache_path(path)
    data = read_json(p)
    if not isinstance(data, dict):
        data = {}
    scales_all = dict(data.get("scales", {}))
    scales_all[key] = {str(k): float(v) for k, v in scales.items()}
    atomic_write_json(p, {"version": 1, "scales": scales_all})
    return p

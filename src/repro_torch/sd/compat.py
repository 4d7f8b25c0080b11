"""The plain-executor adapter over the split-deconvolution core.

The port of ``repro.sd.compat``.  :func:`functional_deconv` exposes
:func:`~repro_torch.sd.functional.conv_transpose` under the registry's
plain executor signature ``fn(x, w, stride, padding) -> y``, with a
per-process cache of geometry plans (a plan holds no tensors, so caching
it costs one dict lookup).  The registry's ``api="functional"`` impls
(``sd_fn``, ``sd_kernel``, ``winograd``) resolve to it, which is how the
trainer gets a differentiable kernel path: on a CUDA tensor K1 forward
(K4 for ``winograd``) and K2 + K3 backward.

The cache key holds the backend *resolved for the tensor's device*
(``"auto"`` is ``"fused"`` on a card and ``"torch"`` on the CPU), so a
plan made for a CPU call never serves a CUDA call, or the reverse.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.deconv import _ntuple, _pads_nd
from repro_torch.sd.functional import conv_transpose
from repro_torch.sd.plan import DeconvPlan, plan as make_plan, resolve_backend

_PLAN_CACHE: Dict[Tuple, DeconvPlan] = {}


def plan_for(filter_shape, stride, padding=0, backend: str = "auto",
             output_padding=0, device=None) -> DeconvPlan:
    """The cached geometry plan of a filter shape ``(*K, Cin, Cout)`` (its
    length sets the rank), keyed on the shape, stride, pads,
    output_padding and the backend resolved for ``device`` (``None``: the
    card, which raises without one)."""
    resolved = resolve_backend(backend, device)
    rank = len(tuple(filter_shape)) - 2
    key = (tuple(int(d) for d in filter_shape), _ntuple(stride, rank),
           _pads_nd(padding, rank), _ntuple(output_padding, rank),
           resolved)
    if key not in _PLAN_CACHE:
        _PLAN_CACHE[key] = make_plan(filter_shape, stride, padding,
                                     backend=resolved,
                                     output_padding=output_padding)
    return _PLAN_CACHE[key]


def functional_deconv(x: torch.Tensor, w: torch.Tensor, stride,
                      padding=0, *, backend: str = "auto",
                      output_padding=0) -> torch.Tensor:
    """``fn(x, w, stride, padding)`` over
    :func:`~repro_torch.sd.functional.conv_transpose`: differentiable in
    ``x`` and ``w``, rank-polymorphic like the core executors, on the
    backend ``backend`` resolves to for ``x``'s device."""
    return conv_transpose(plan_for(w.shape, stride, padding, backend,
                                   output_padding, device=x.device), x, w)


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()

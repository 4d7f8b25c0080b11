"""Presplit-once SD inference engine: a plan cache over :mod:`repro_torch.sd`.

:meth:`SDEngine.bind` walks a :class:`NetworkSpec` and its params once
and, per deconv layer, builds a bound plan: the geometry from
``sd.plan``, then ``plan.bind(w, scale, bias)`` — one ``split_filters``
call with the inference-BN scale folded into the split filters and the
bias and activation kept for the epilogue.  :meth:`SDEngine.run` executes
a layer from its cached plan; nothing offline happens on the hot path.

``dtype="int8"`` binds int8 plans (filters quantized per split output
channel at bind, activations per sample on the hot path).  Every
:meth:`SDEngine.bind` bumps :attr:`SDEngine.generation`, so a holder of
a snapshot of the plans (the server's cells) can tell that they were
rebuilt.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core.accounting import LayerSpec, NetworkSpec
from repro_torch.core.deconv import _ntuple, same_deconv_pads
from repro_torch.device import resolve_device
from repro_torch.sd import functional as sd_functional
from repro_torch.sd.plan import (DTYPES, DeconvPlan, plan as make_plan,
                                 resolve_backend)

Params = Dict[str, Any]


def fold_scale_ocmajor(ws_ocmajor: torch.Tensor, scale: torch.Tensor,
                       s) -> torch.Tensor:
    """Fold a per-output-channel scale into oc-major split filters, any
    rank: channel ``c = oc*phases + phase``, so each scale entry is
    *repeated* over ``phases = prod(s)`` consecutive channels (n-major
    filters tile it instead, see ``DeconvPlan.bind``)."""
    rank = ws_ocmajor.ndim - 2
    phases = math.prod(_ntuple(s, rank))
    return ws_ocmajor * scale.to(ws_ocmajor.dtype).repeat_interleave(phases)


def _versions(leaves) -> tuple:
    return tuple(None if t is None else t._version for t in leaves)


class SDEngine:
    """Per-network cache of presplit, BN-folded deconv plans.

    ``backend``: ``"fused"`` (the CUDA kernel K1; for a 3-D net one K2
    launch per depth tap; their plain versions for CPU tensors), ``"winograd"`` (K4 pinned on every deconv layer; a
    layer outside its envelope raises at plan time), ``"torch"``
    (grouped conv + pixel shuffle), or ``"auto"`` (fused on a CUDA
    ``device``, torch on the CPU).  The reference's measured per-layer
    choice between fused and winograd (``autotune.best_algo``, armed by
    ``pretune``) waits for measured tiles.  ``device=None`` is the card,
    as everywhere in the port (raises without one).  ``dtype``:
    ``"native"`` or ``"int8"`` (the plans' execution dtype)."""

    def __init__(self, spec: NetworkSpec, backend: str = "auto",
                 device=None, dtype: str = "native"):
        if dtype not in DTYPES:
            raise ValueError(f"unknown engine dtype {dtype!r}; choose from "
                             f"{DTYPES}")
        self.spec = spec
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.dtype = dtype
        self.generation = 0          # bumped by every bind
        self._plans: Dict[str, DeconvPlan] = {}
        self._bound: Optional[Params] = None
        self._bound_leaves: Optional[tuple] = None
        self._bound_versions: Optional[tuple] = None

    def _plan_leaves(self, params: Params) -> Optional[tuple]:
        """The tensors the plans depend on, compared by identity and by
        ``_version`` in :meth:`bound_to` (held strongly, so ids cannot
        be reused)."""
        leaves = []
        for layer in self.spec.layers:
            if layer.kind != "deconv":
                continue
            p = params.get(layer.name)
            if not isinstance(p, dict) or "w" not in p or "b" not in p:
                return None
            leaves += [p["w"], p.get("scale"), p["b"]]
        return tuple(leaves)

    # ---- offline phase ---------------------------------------------------
    def layer_plan(self, layer: LayerSpec, act: str,
                   dtype: Optional[str] = None) -> DeconvPlan:
        """Geometry-only plan for one deconv layer (tile chosen at call
        time from the launch geometry).  ``dtype`` overrides the engine's
        (the models' differentiable path asks an int8 engine for float
        plans: int8 plans are inference-only)."""
        rank = layer.rank
        kernel = (layer.k,) * rank
        stride = (layer.s,) * rank
        pads = (same_deconv_pads(kernel, stride)
                if layer.padding == "same" else layer.pad)
        return make_plan((*kernel, layer.cin, layer.cout), stride, pads,
                         backend=self.backend, act=act,
                         dtype=self.dtype if dtype is None else dtype)

    @torch.no_grad()
    def build_plans(self, params: Params) -> Dict[str, DeconvPlan]:
        """Bound plans for every deconv layer.  The epilogue activation
        is relu for every deconv that is not the net's last layer and
        linear for the last (the model applies the final tanh).  Built
        without autograd: bound plans are data, never part of a graph."""
        layers = self.spec.layers
        plans: Dict[str, DeconvPlan] = {}
        for i, layer in enumerate(layers):
            if layer.kind != "deconv":
                continue
            p = params[layer.name]
            act = "linear" if i == len(layers) - 1 else "relu"
            plans[layer.name] = self.layer_plan(layer, act).bind(
                p["w"], scale=p.get("scale"), bias=p["b"].float())
        return plans

    def bind(self, params: Params) -> "SDEngine":
        """Build and cache all layer plans from ``params`` (once per
        parameter set)."""
        self._plans = self.build_plans(params)
        self._bound = params
        self._bound_leaves = self._plan_leaves(params)
        self._bound_versions = _versions(self._bound_leaves)
        self.generation += 1
        return self

    def bound_to(self, params: Params) -> bool:
        """True when the cached plans were split from exactly these
        tensors in their current state.  Identity alone is not enough in
        PyTorch: an optimizer step that updates a filter in place keeps
        the tensor but bumps its ``_version``, and the plans must then be
        split again."""
        if self._bound is None or self._bound_leaves is None:
            return False
        leaves = self._plan_leaves(params)
        return (leaves is not None
                and len(leaves) == len(self._bound_leaves)
                and all(a is b for a, b in zip(leaves, self._bound_leaves))
                and _versions(leaves) == self._bound_versions)

    def plans_for_batch(self, batch: int) -> Dict[str, DeconvPlan]:
        """The cached bound plans for a launch at ``batch``.  Tiles are
        picked per launch from its geometry until measured tiles exist,
        so every bucket shares the same plans."""
        return self.plans()

    def estimate_ms(self, batch: int) -> Optional[float]:
        """Service-time seed for admission control: ``None`` until tiles
        are measured on the card (the scheduler then learns from its
        observed launches)."""
        return None

    # ---- hot path --------------------------------------------------------
    def run(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return sd_functional.execute(self._plans[name], x)

    def plans(self) -> Dict[str, DeconvPlan]:
        return dict(self._plans)

"""Presplit-once SD inference engine: a plan cache over :mod:`repro_torch.sd`.

:meth:`SDEngine.bind` walks a :class:`NetworkSpec` and its params once
and, per deconv layer, builds a bound plan: the geometry from
``sd.plan``, then ``plan.bind(w, scale, bias)`` — one ``split_filters``
call with the inference-BN scale folded into the split filters and the
bias and activation kept for the epilogue.  :meth:`SDEngine.run` executes
a layer from its cached plan; nothing offline happens on the hot path.

``dtype="int8"`` binds int8 plans (filters quantized per split output
channel at bind, activations per sample on the hot path).
:meth:`SDEngine.set_calibration` installs static per-layer activation
scales on an int8 engine: each calibrated layer quantizes its input
against its static scale, and each pair of consecutive deconv layers
chains (the first writes int8 codes for the second).  Every
:meth:`SDEngine.bind` bumps :attr:`SDEngine.generation`, so a holder of
a snapshot of the plans (the server's cells) can tell that they were
rebuilt.

Tiles come from the measured plan cache (:mod:`repro_torch.kernels.
autotune`): :meth:`SDEngine.pretune` times K1's (and, on a float
``"fused"`` engine, K4's) candidate tiles for every rank-2 layer at the
serving batches and persists the winners; a bind then resolves each
layer's tile, and its algorithm (K1 or K4, whichever measured faster),
from the cache, :meth:`SDEngine.plans_for_batch` re-resolves the tiles
at a bucket's batch, and :meth:`SDEngine.estimate_ms` sums the measured
times.  With nothing measured every tile is the kernel's call-time
default.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch.core.accounting import LayerSpec, NetworkSpec
from repro_torch.core.deconv import _ntuple, same_deconv_pads
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import DeconvGeom, get_plan
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
    ``device``, torch on the CPU).  A ``"fused"`` float engine binds a
    rank-2 layer to ``"winograd"`` where :meth:`pretune` measured K4
    faster than K1 at ``plan_batch`` (:meth:`_layer_backend`).
    ``device=None`` is the card, as everywhere in the port (raises
    without one).  ``dtype``: ``"native"`` or ``"int8"`` (the plans'
    execution dtype)."""

    # The batch the bound plans' tiles and algorithm are keyed at (the
    # reference's default; serving re-keys tiles per bucket with
    # plans_for_batch).
    plan_batch = 1

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
        self._calib: Optional[Dict[str, float]] = None

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
    def _layer_backend(self, layer: LayerSpec, dtype: str,
                       geom: Optional[DeconvGeom]) -> str:
        """Execution backend of one layer (reference
        ``SDEngine._layer_backend``): a ``"fused"`` engine switches a
        float rank-2 layer inside K4's envelope to ``"winograd"`` when
        :func:`~repro_torch.kernels.autotune.best_algo` says K4 measured
        faster at ``geom`` (the ``plan_batch`` geometry).  Int8 plans,
        other ranks and untuned layers keep the engine's backend."""
        if (self.backend != "fused" or dtype == "int8" or geom is None
                or layer.rank != 2):
            return self.backend
        from repro_torch.kernels.winograd import supported
        kt = -(-layer.k // layer.s)
        if not supported((kt, kt)):
            return self.backend
        if autotune.best_algo(geom, device=self.device) == "wino":
            return "winograd"
        return self.backend

    def layer_plan(self, layer: LayerSpec, act: str,
                   dtype: Optional[str] = None,
                   qout: bool = False) -> DeconvPlan:
        """Geometry-only plan for one deconv layer: backend
        (:meth:`_layer_backend`) and tile from the plan cache at
        ``plan_batch`` (``None``, the kernel's call-time default, where
        nothing is measured; ranks 1 and 3 always).  ``dtype`` overrides
        the engine's (the models' differentiable path asks an int8 engine
        for float plans: int8 plans are inference-only); ``qout`` keys a
        chained int8-out launch."""
        rank = layer.rank
        kernel = (layer.k,) * rank
        stride = (layer.s,) * rank
        pads = (same_deconv_pads(kernel, stride)
                if layer.padding == "same" else layer.pad)
        dtype = self.dtype if dtype is None else dtype
        geom = self.layer_geom(layer, dtype=dtype, qout=qout)
        backend = self._layer_backend(layer, dtype, geom)
        tile = None
        if geom is not None and backend != "torch":
            if backend == "winograd":
                geom = replace(geom, algo="wino")
            tile = get_plan(geom, device=self.device)
        return make_plan((*kernel, layer.cin, layer.cout), stride, pads,
                         backend=backend, act=act, tile=tile, dtype=dtype)

    def _chain_next(self) -> Dict[str, str]:
        """Chaining wiring from the installed calibration (reference
        ``SDEngine._chain_next``): each deconv layer's name mapped to the
        next layer's when the two are consecutive in the spec, both
        deconv and both calibrated, the pairs whose inter-layer tensor
        crosses device memory as int8.  A conv between them (segnet)
        breaks the chain; the last layer has no successor, so its f32
        output feeds the model's tanh."""
        out: Dict[str, str] = {}
        if not self._calib or self.dtype != "int8":
            return out
        layers = self.spec.layers
        for i, layer in enumerate(layers[:-1]):
            nxt = layers[i + 1]
            if (layer.kind == "deconv" and nxt.kind == "deconv"
                    and layer.name in self._calib
                    and nxt.name in self._calib):
                out[layer.name] = nxt.name
        return out

    @torch.no_grad()
    def build_plans(self, params: Params) -> Dict[str, DeconvPlan]:
        """Bound plans for every deconv layer.  The epilogue activation
        is relu for every deconv that is not the net's last layer and
        linear for the last (the model applies the final tanh).  With a
        calibration installed (int8 engines), calibrated layers get their
        static ``sx_in`` and consecutive deconv pairs chain
        (:meth:`set_calibration`).  Built without autograd: bound plans
        are data, never part of a graph."""
        layers = self.spec.layers
        calib = self._calib if self.dtype == "int8" else None
        chain_next = self._chain_next()
        plans: Dict[str, DeconvPlan] = {}
        for i, layer in enumerate(layers):
            if layer.kind != "deconv":
                continue
            p = params[layer.name]
            act = "linear" if i == len(layers) - 1 else "relu"
            tgt = chain_next.get(layer.name)
            bound = self.layer_plan(layer, act, qout=tgt is not None).bind(
                p["w"], scale=p.get("scale"), bias=p["b"].float())
            if calib and layer.name in calib:
                bound = bound.with_chain(
                    sx_in=calib[layer.name],
                    sx_out=calib[tgt] if tgt is not None else None,
                    chain_out=tgt is not None)
            plans[layer.name] = bound
        return plans

    def set_calibration(self, scales: Optional[Dict[str, float]]
                        ) -> "SDEngine":
        """Install static per-layer activation scales, ``{layer name:
        input amax / 127}`` as ``GenerativeModel.calibrate`` returns them
        or ``core.quant.load_calib`` reads them; ``None`` clears them
        (back to dynamic per-sample scales).  A float engine raises.
        Rebinds when params are bound (which bumps :attr:`generation`,
        so a server's cells follow), and every later bind, a checkpoint
        swap's included, keeps the calibration."""
        if scales is not None and self.dtype != "int8":
            raise ValueError("calibration applies to int8 engines only")
        self._calib = dict(scales) if scales is not None else None
        if self._bound is not None:
            self.bind(self._bound)
        return self

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

    # ---- measured tiles -------------------------------------------------
    def layer_geom(self, layer: LayerSpec, batch: Optional[int] = None,
                   dtype: Optional[str] = None, algo: str = "",
                   qout: bool = False) -> Optional[DeconvGeom]:
        """Plan-cache geometry of one deconv layer's launch at ``batch``
        (default ``plan_batch``), the reference's key: rank 2 only (ranks
        1 and 3 take the call-time default), ``_int8`` on an int8 engine
        (or ``dtype="int8"``), ``algo="wino"`` for K4, ``qout`` for a
        chained int8-out launch."""
        if layer.rank != 2:
            return None
        pads = (same_deconv_pads(layer.k, layer.s)
                if layer.padding == "same" else layer.pad)
        dtype = self.dtype if dtype is None else dtype
        geom = DeconvGeom.from_deconv(
            batch or self.plan_batch, *layer.in_hw, layer.cin, layer.cout,
            layer.k, layer.s, padding=pads,
            dtype="int8" if dtype == "int8" else "")
        return replace(geom, algo=algo, qout=qout)

    def _deconv_layers(self) -> Dict[str, LayerSpec]:
        return {l.name: l for l in self.spec.layers if l.kind == "deconv"}

    def _plan_geom(self, plan: DeconvPlan, layer: LayerSpec,
                   batch: int) -> Optional[DeconvGeom]:
        """The geometry of a bound plan's launch at ``batch``."""
        return self.layer_geom(
            layer, batch, algo="wino" if plan.backend == "winograd" else "",
            qout=plan.chain_out)

    def plans_for_batch(self, batch: int) -> Dict[str, DeconvPlan]:
        """The bound plans with tiles re-resolved from the cache at
        ``batch`` (a bucket), sharing the split filters: nothing is split
        again.  A layer with no measured tile at ``batch`` launches the
        kernel's default for the launch."""
        if batch == self.plan_batch or self.backend == "torch":
            return self.plans()
        layers = self._deconv_layers()
        out: Dict[str, DeconvPlan] = {}
        for name, plan in self._plans.items():
            geom = self._plan_geom(plan, layers[name], batch)
            out[name] = (plan if geom is None else plan.with_tile(
                get_plan(geom, device=self.device)))
        return out

    def pretune(self, batches: Iterable[int], iters: int = 3,
                path: Optional[str] = None) -> Dict[str, Any]:
        """Time the candidate tiles of every rank-2 (deconv layer, batch)
        launch through the bound plan's own hot path
        (:func:`repro_torch.sd.execute` on zeros, on this engine's
        device) and persist each winner (reference ``SDEngine.pretune``).
        A float ``"fused"`` engine also times the Winograd variant of
        every layer inside K4's envelope (the bound oc-major filters
        through ``transform_filters``; nothing is split again) and then
        rebinds, so layers where K4 measured faster at ``plan_batch``
        switch.  Returns ``{geometry key: winning plan}``; ``{}`` on the
        ``torch`` backend, which launches no kernel."""
        tuned: Dict[str, Any] = {}
        if self.backend not in ("fused", "winograd"):
            return tuned
        if not self._plans:
            raise ValueError("pretune() needs bound plans; bind() first")
        from repro_torch.kernels.winograd import supported, transform_filters
        layers = self._deconv_layers()

        def tune_variant(plan: DeconvPlan, layer: LayerSpec, b: int, x):
            geom = self._plan_geom(plan, layer, b)

            def runner(tile):
                p2 = plan.with_tile(tile)
                with torch.no_grad():
                    return autotune.measure(
                        lambda: sd_functional.execute(p2, x), iters=iters,
                        device=self.device)

            best = autotune.tune(geom, runner, path=path,
                                 device=self.device)
            if best is not None:           # None: every tile was refused
                tuned[geom.key()] = best

        for name, plan in self._plans.items():
            layer = layers[name]
            if self.layer_geom(layer) is None:
                continue                       # ranks 1 and 3: call time
            # a calibrated int8 plan reads int8 codes (a chained input's,
            # or its own static quantization's), a dynamic one f32, a
            # float one its filters' dtype
            dtype = (torch.int8 if plan.sx_in is not None
                     else torch.float32 if plan.dtype == "int8"
                     else plan.ws.dtype)
            variants = [plan]
            if (self.backend == "fused" and plan.backend == "fused"
                    and plan.dtype != "int8" and supported(plan.kt)):
                variants.append(replace(plan, backend="winograd",
                                        layout="wino", tile=None,
                                        ws=transform_filters(plan.ws)))
            for b in sorted({int(v) for v in batches}):
                x = torch.zeros((b, *layer.in_hw, layer.cin), dtype=dtype,
                                device=self.device)
                for v in variants:
                    tune_variant(v, layer, b, x)
        if self.backend == "fused" and self._bound is not None:
            self.bind(self._bound)   # layers measured faster on K4 switch
        return tuned

    def estimate_ms(self, batch: int) -> Optional[float]:
        """Service-time seed for admission control (reference
        ``SDEngine.estimate_ms``): the measured ms of every deconv
        layer's launch at ``batch`` summed, or ``None`` unless every one
        is measured on this device (ranks 1 and 3 never are).  The fc and
        conv layers and the host's time are left out, so it is about the
        deconv layers' device time, below a batch's wall time; the
        scheduler's observed-launch average takes over from the first
        launch."""
        total = 0.0
        layers = self._deconv_layers()
        for name, plan in self._plans.items():
            geom = self._plan_geom(plan, layers[name], batch)
            ms = (None if geom is None
                  else autotune.measured_ms(geom, device=self.device))
            if ms is None:
                return None
            total += ms
        return total

    # ---- hot path --------------------------------------------------------
    def run(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return sd_functional.execute(self._plans[name], x)

    def plans(self) -> Dict[str, DeconvPlan]:
        return dict(self._plans)

    def describe(self) -> str:
        """One line for the engine, one per bound layer: rank, kernel,
        stride, taps, activation, backend and tile (reference
        ``SDEngine.describe``)."""
        lines = [f"SDEngine[{self.spec.name}] backend={self.backend} "
                 f"dtype={self.dtype} ({len(self._plans)} deconv layers)"]
        for name, plan in self._plans.items():
            tile = plan.tile if plan.tile is not None else "call-time"
            lines.append(
                f"  {name}: rank={plan.rank} K={plan.kernel[0]} "
                f"s={plan.stride[0]} KT={plan.kt[0]} act={plan.act} "
                f"backend={plan.backend} tile={tile}")
        return "\n".join(lines)

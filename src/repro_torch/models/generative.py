"""The paper's generative networks as a PyTorch module.

Every network is built from its ``NetworkSpec``.  The deconv
implementation is chosen by name from :data:`IMPLS`:

* ``native``    — ``F.conv_transpose2d`` (:func:`native_deconv`),
* ``sd``        — split deconvolution, filters split on every call,
* ``sd_kernel`` — the presplit-once engine (:class:`SDEngine`): filters
  are split and BN-folded once at bind, and every forward runs the
  fused kernel (or the grouped-conv ``torch`` backend) with bias and
  activation in the epilogue.

Parameters stay a plain dict in the reference's layout (fc ``(in, out)``,
filters ``(*K, Cin, Cout)``, per-channel ``scale``/``b``), so weights
carry across from the JAX package unchanged (:mod:`repro_torch.convert`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.core.accounting import BENCHMARKS, NetworkSpec
from repro_torch.core.deconv import (conv_nd, native_deconv,
                                     same_deconv_pads, sd_deconv)
from repro_torch.device import resolve_device
from repro_torch.engine.planner import SDEngine
from repro_torch.sd import DeconvPlan, execute

Params = Dict[str, Any]

# name -> plain deconv executor (None: the engine)
IMPLS: Dict[str, Optional[Callable]] = {
    "native": native_deconv,
    "sd": sd_deconv,
    "sd_kernel": None,
}


class GenerativeModel(nn.Module):
    """Spec-driven generator/decoder network.  ``forward(params, x)``."""

    def __init__(self, spec: NetworkSpec, deconv_impl: str = "sd",
                 final_tanh: Optional[bool] = None,
                 engine_backend: str = "auto", device=None):
        super().__init__()
        if deconv_impl not in IMPLS:
            raise ValueError(f"unknown deconv impl {deconv_impl!r}; "
                             f"choose from {sorted(IMPLS)}")
        self.spec = spec
        self.deconv_impl = deconv_impl
        self.device = resolve_device(device)
        self.final_tanh = spec.final_tanh if final_tanh is None \
            else final_tanh
        self._deconv = IMPLS[deconv_impl]
        self._engine = (SDEngine(spec, backend=engine_backend,
                                 device=self.device)
                        if self._deconv is None else None)

    # ---- params ----------------------------------------------------------
    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> Params:
        """Random params from ``generator`` (a CPU generator, so the same
        seed gives the same weights on every device), moved to the
        model's device; binds the engine (the offline split) once."""
        params: Params = {}

        def normal(*shape):
            return torch.randn(shape, generator=generator,
                               dtype=torch.float32)

        for layer in self.spec.layers:
            if layer.kind == "fc":
                w = normal(layer.cin, layer.cout) / math.sqrt(layer.cin)
                p = {"w": w, "b": torch.zeros(layer.cout)}
            else:
                fan_in = layer.k ** layer.rank * layer.cin
                w = normal(*(layer.k,) * layer.rank, layer.cin,
                           layer.cout) / math.sqrt(fan_in)
                p = {"w": w, "b": torch.zeros(layer.cout),
                     "scale": torch.ones(layer.cout)}
            params[layer.name] = {k: v.to(self.device, dtype)
                                  for k, v in p.items()}
        if self._engine is not None:
            self._engine.bind(params)
        return params

    # ---- forward ---------------------------------------------------------
    def _forward(self, params: Params, x: torch.Tensor,
                 deconv_step) -> torch.Tensor:
        """The one shared layer loop.  ``deconv_step(layer, p, h) -> (h,
        epilogue_done)``; fc, conv + folded BN, the inter-layer ReLU and
        the final tanh live here once."""
        layers = self.spec.layers
        h = x
        for i, layer in enumerate(layers):
            p = params.get(layer.name)
            last = i == len(layers) - 1
            if layer.kind == "fc":
                h = h.reshape(h.shape[0], -1)
                h = h @ p["w"] + p["b"]
                nxt = layers[i + 1] if i + 1 < len(layers) else None
                if nxt is not None and nxt.kind != "fc":
                    h = h.reshape(h.shape[0], *nxt.in_hw, nxt.cin)
            elif layer.kind == "conv":
                pads = "SAME" if layer.padding == "same" else layer.pad
                h = conv_nd(h, p["w"], layer.s, pads)
                h = h * p["scale"] + p["b"]
            else:
                h, epilogue_done = deconv_step(layer, p, h)
                if epilogue_done:
                    continue
            if not last:
                h = torch.relu(h)
        return torch.tanh(h) if self.final_tanh else h

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if self._engine is not None:
            if not self._engine.bound_to(params):
                self._engine.bind(params)        # foreign params: rebind

            def step(layer, p, h):               # bias + act in the plan
                return self._engine.run(layer.name, h), True
        else:
            def step(layer, p, h):
                pads = (same_deconv_pads((layer.k,) * layer.rank,
                                         (layer.s,) * layer.rank)
                        if layer.padding == "same" else layer.pad)
                h = self._deconv(h, p["w"], layer.s, pads)
                return h * p["scale"] + p["b"], False
        return self._forward(params, x, step)

    def apply_with_plans(self, params: Params,
                         plans: Dict[str, DeconvPlan],
                         x: torch.Tensor) -> torch.Tensor:
        """Forward with the deconv layers' bound plans passed in
        (``engine.plans()``); ``params`` needs only the fc/conv entries."""
        def step(layer, p, h):
            return execute(plans[layer.name], h), True

        return self._forward(params, x, step)

    def forward(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return self.apply(params, x)

    # ---- convenience -----------------------------------------------------
    @property
    def engine(self) -> Optional[SDEngine]:
        return self._engine

    def input_shape(self, batch: int):
        first = self.spec.layers[0]
        if first.kind == "fc":
            return (batch, first.cin)
        return (batch, *first.in_hw, first.cin)


def build(name: str, deconv_impl: str = "sd", engine_backend: str = "auto",
          device=None) -> GenerativeModel:
    """Factory over the paper's six networks: ``build("dcgan",
    "sd_kernel", device="cuda")``."""
    if name not in BENCHMARKS:
        raise ValueError(f"unknown network {name!r}; choose from "
                         f"{sorted(BENCHMARKS)}")
    return GenerativeModel(BENCHMARKS[name](), deconv_impl=deconv_impl,
                           engine_backend=engine_backend, device=device)

"""The paper's generative networks as a PyTorch module.

Every network is built from its ``NetworkSpec``.  The deconv
implementation is chosen by name and resolved through the executor
registry (:mod:`repro_torch.core.registry`), as in the reference:
``registry.names()`` lists every impl (``native``, ``nzp``, ``sd``,
``sd_paper``, ``sd_fn``, ``sd_kernel``, ``fused``, ``winograd``,
``shi``, ``chang``), and an unknown name raises the registry's
``ValueError`` with the nearest name and the capability catalog.  A
plain executor (every impl but the engine one) is called per layer as
``fn(h, w, s, pads)`` with the layer's SAME or explicit pads, then scale
and bias.

The engine impl (``sd_kernel``, ``info.engine``) runs the presplit-once
:class:`SDEngine`: filters are split and BN-folded once at bind, and
every forward runs the fused kernel K1 (``engine_backend="fused"``; for
a 1-D net as an H=1 launch, for a 3-D net one K2 launch per depth tap),
the Winograd kernel K4 (``"winograd"``) or the grouped-conv ``torch``
backend, with bias and activation in the epilogue;
``engine_dtype="int8"`` binds int8 plans (the dynamic int8 path, K1's
int8 branch on ``fused``), and :meth:`GenerativeModel.calibrate` turns
them into the calibrated chain (static activation scales, int8 between
consecutive deconvs).  When autograd is recording and any param leaf or
the input requires grad, each deconv instead runs the differentiable
:func:`repro_torch.sd.conv_transpose` on the engine's backend (on
``fused``: K1 forward, K2 + K3 backward) with float plans, scale and
bias applied outside, as the reference does for traced params (an int8
engine trains in float).

``engine_mesh`` (a :class:`~repro_torch.distributed.Mesh`) makes the
engine a mesh engine: each layer whose ``cout`` divides the model
degree binds Cout-sharded, and its forward then runs under
:func:`~repro_torch.distributed.spmd` (the server's cells enter it).
Under :func:`~repro_torch.distributed.spmd` the differentiable path
marks the same layers of the active mesh ``with_shards``, so ``p["w"]``
is the rank's Cout block and ``conv_transpose`` gathers the output: the
sharded train step
(:func:`repro_torch.launch.train_gen.make_sharded_train_step`).

Parameters stay a plain dict in the reference's layout (fc ``(in, out)``,
filters ``(*K, Cin, Cout)``, per-channel ``scale``/``b``), so weights
carry across from the JAX package unchanged (:mod:`repro_torch.convert`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from repro_torch.core import registry
from repro_torch.core.accounting import WORKLOADS, NetworkSpec
from repro_torch.core.deconv import conv_nd, same_deconv_pads
from repro_torch.core.quant import amax_stat, save_calib, scale_from_amax
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import current_mesh, layer_shards
from repro_torch.engine.planner import SDEngine
from repro_torch.sd import DeconvPlan, conv_transpose, execute

Params = Dict[str, Any]

class GenerativeModel(nn.Module):
    """Spec-driven generator/decoder network.  ``forward(params, x)``."""

    def __init__(self, spec: NetworkSpec, deconv_impl: str = "sd",
                 final_tanh: Optional[bool] = None,
                 engine_backend: str = "auto", device=None,
                 engine_dtype: str = "native", engine_mesh=None):
        super().__init__()
        info = registry.get_impl(deconv_impl)
        if engine_dtype != "native" and not info.engine:
            raise ValueError(f"engine_dtype={engine_dtype!r} needs an "
                             f"engine impl (e.g. 'sd_kernel'); "
                             f"{deconv_impl!r} is a plain executor")
        if engine_mesh is not None and not info.engine:
            raise ValueError(f"engine_mesh needs an engine impl (e.g. "
                             f"'sd_kernel'); {deconv_impl!r} is a plain "
                             "executor")
        self.spec = spec
        self.deconv_impl = deconv_impl
        self.device = resolve_device(device)
        self.final_tanh = spec.final_tanh if final_tanh is None \
            else final_tanh
        self._deconv = None if info.engine else info.fn
        self._engine = (SDEngine(spec, backend=engine_backend,
                                 device=self.device, dtype=engine_dtype,
                                 mesh=engine_mesh)
                        if info.engine else None)
        self._fplans: Dict[str, DeconvPlan] = {}   # differentiable path

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

    def _functional_plan(self, layer) -> DeconvPlan:
        """Geometry-only float plan of one deconv for the differentiable
        path (cached: it holds no tensors).  Linear: scale, bias and the
        activation are applied outside, where autograd sees them."""
        if layer.name not in self._fplans:
            self._fplans[layer.name] = self._engine.layer_plan(
                layer, "linear", dtype="native")
        return self._fplans[layer.name]

    def _float_step(self, layer, p: Params, h: torch.Tensor):
        """One deconv layer on the differentiable float path: the
        functional plan's deconv, then scale and bias outside it (the
        activation is the forward's, so the flag is False).  Under
        :func:`~repro_torch.distributed.spmd` a layer that shards on the
        mesh's model degree (:func:`~repro_torch.distributed.
        layer_shards`) runs its Cout block of ``p["w"]`` and gathers the
        output; scale and bias, replicated, act on the whole."""
        fp = self._functional_plan(layer)
        mesh = current_mesh()
        shards = 1 if mesh is None else layer_shards(layer.cout, mesh.mp)
        if shards > 1:
            fp = fp.with_shards(shards, "model")
        h = conv_transpose(fp, h, p["w"])
        return h * p["scale"] + p["b"], False

    @staticmethod
    def _differentiable(params: Params, x: torch.Tensor) -> bool:
        """Autograd is recording and some param leaf or the input requires
        grad: the bound engine's plans (a kernel's output, pre-split
        filters) would cut the graph."""
        return torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for p in params.values() if isinstance(p, dict)
            for t in p.values() if isinstance(t, torch.Tensor)))

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if self._engine is not None and self._differentiable(params, x):
            step = self._float_step
        elif self._engine is not None:
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

    # ---- static activation calibration -----------------------------------
    @torch.no_grad()
    def calibrate(self, params: Params, n: int = 64, seed: int = 0,
                  policy: str = "max", pct: float = 99.9,
                  save_key: Optional[str] = None,
                  path: Optional[str] = None,
                  latents: Optional[torch.Tensor] = None
                  ) -> Dict[str, float]:
        """Calibrate static per-layer activation scales for the chained
        int8 path and install them on the engine (reference
        ``GenerativeModel.calibrate``).

        Runs ``latents`` (default: ``n`` unit-normal latents from
        ``torch.Generator(device).manual_seed(seed)``) through the float
        differentiable forward on the engine's backend and records, per
        deconv layer, :func:`~repro_torch.core.quant.amax_stat` of that
        layer's input.  Returns ``{layer: amax / 127}``, installs it with
        :meth:`~repro_torch.engine.SDEngine.set_calibration` (binding a
        never-bound engine to ``params``) and, with ``save_key``, writes
        it to the port's calibration cache (``path``, else
        ``$REPRO_TORCH_SD_CALIB_CACHE``, else
        ``~/.cache/repro_torch/sd_calib.json``)."""
        engine = self._engine
        if engine is None or engine.dtype != "int8":
            raise ValueError("calibrate() needs an int8 engine impl "
                             "(deconv_impl='sd_kernel', "
                             "engine_dtype='int8')")
        if latents is None:
            gen = torch.Generator(self.device).manual_seed(seed)
            x = torch.randn(self.input_shape(int(n)), generator=gen,
                            device=self.device)
        else:
            x = torch.as_tensor(latents, dtype=torch.float32,
                                device=self.device)
        stats: Dict[str, torch.Tensor] = {}

        def step(layer, p, h):
            # The layer's INPUT statistic, then the float deconv, so that
            # later layers see the unquantized model's activations.
            stats[layer.name] = amax_stat(h, policy, pct)
            return self._float_step(layer, p, h)

        self._forward(params, x, step)
        scales = {name: scale_from_amax(v) for name, v in stats.items()}
        if save_key is not None:
            save_calib(save_key, scales, path)
        engine.set_calibration(scales)
        if not engine.bound_to(params):
            engine.bind(params)
        return scales

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
    """Factory over :data:`~repro_torch.core.accounting.WORKLOADS` (the
    paper's six networks plus the N-D workloads): ``build("dcgan",
    "sd_kernel", device="cuda")``; ``deconv_impl`` is any name of
    :func:`repro_torch.core.registry.names`.  Every net runs on every backend it
    fits: rank 1 (``wavegan``) takes K1 and its K2 + K3 backward as H=1
    launches on ``fused``; ``winograd`` refuses a layer of more than 5
    taps (full WaveGAN's k25/s4 has 7) with the reference's
    ``ValueError``."""
    if name not in WORKLOADS:
        raise ValueError(f"unknown workload {name!r}; choose from "
                         f"{sorted(WORKLOADS)}")
    return GenerativeModel(WORKLOADS[name](), deconv_impl=deconv_impl,
                           engine_backend=engine_backend, device=device)


class DCGANDiscriminator:
    """The DCGAN discriminator the GAN trainer pits against the
    generator: 4x4 stride-2 convs with TF ``SAME`` pads, LeakyReLU 0.2,
    and a logit head.  Params in the reference's layout: ``c{i}``
    ``{"w": (4, 4, cin, cout), "b": (cout,)}`` and ``head`` ``{"w":
    (feat, 1), "b": (1,)}``."""

    CHANNELS = (3, 64, 128, 256)

    def __init__(self, img_hw=(64, 64), channels=CHANNELS, device=None):
        self.img_hw = tuple(img_hw)
        self.channels = tuple(channels)
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> Params:
        """Random f32 params from ``generator`` (a CPU generator), moved
        to the discriminator's device."""
        params: Params = {}
        for i, (cin, cout) in enumerate(zip(self.channels[:-1],
                                            self.channels[1:])):
            w = torch.randn((4, 4, cin, cout), generator=generator)
            params[f"c{i}"] = {"w": w / math.sqrt(16 * cin),
                               "b": torch.zeros(cout)}
        down = 2 ** (len(self.channels) - 1)
        feat = (self.channels[-1] * (self.img_hw[0] // down)
                * (self.img_hw[1] // down))
        params["head"] = {
            "w": torch.randn((feat, 1), generator=generator)
            / math.sqrt(feat),
            "b": torch.zeros(1)}
        return {k: {n: t.to(self.device) for n, t in v.items()}
                for k, v in params.items()}

    def pre_activations(self, params: Params, x: torch.Tensor
                        ) -> List[torch.Tensor]:
        """Each conv's output before its LeakyReLU, for NHWC images
        ``x``."""
        out, h = [], x
        for i in range(len(self.channels) - 1):
            if out:
                h = torch.nn.functional.leaky_relu(out[-1], 0.2)
            p = params[f"c{i}"]
            out.append(conv_nd(h, p["w"], 2, "SAME") + p["b"])
        return out

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Logits (B, 1) for NHWC images ``x``."""
        h = torch.nn.functional.leaky_relu(
            self.pre_activations(params, x)[-1], 0.2)
        h = h.reshape(h.shape[0], -1)
        return h @ params["head"]["w"] + params["head"]["b"]

"""DeconvPlan: the split layout of one transposed convolution.

The port of ``repro.sd.plan``.  A plan holds the static geometry
(kernel, stride, padding, output_padding, channels, backend, epilogue
activation, filter layout, kernel tile, execution dtype); a *bound* plan
also holds the pre-split filters ``ws`` (with any per-channel scale
folded in) and ``bias`` as plain tensor attributes.

``dtype="int8"`` plans (``fused`` and ``torch`` backends) run the
dynamic int8 path: ``bind`` folds the BN scale into the split filters
and then quantizes them per split output channel, so ``ws`` holds int8
codes and ``wscale`` the per-channel dequant scales in ``ws``'s channel
order; ``execute`` quantizes activations per sample.  int8 plans are
inference-only.  :meth:`DeconvPlan.with_chain` makes an int8 plan
calibrated: a static input scale ``sx_in`` replaces the per-sample
quantization, and ``chain_out`` with the next layer's ``sx_out`` makes
the layer write int8 codes for that layer (the chained epilogue).

Backends: ``"torch"`` runs the grouped stride-1 conv + pixel shuffle in
plain PyTorch (the twin of the reference's ``"xla"``) from n-major
filters; ``"fused"`` runs the fused CUDA kernel K1 from oc-major
filters at rank 2, and at rank 3 the depth-folded lowering (one K2
launch per depth tap, then the torch interleave) from n-major filters;
``"winograd"`` runs K4, the F(2,r) Winograd kernel, from
oc-major filters transformed at bind (layout ``"wino"``; rank 2, per-dim
taps <= 5, float only).
``"auto"`` means fused for a CUDA device and torch for the CPU; with no
device named it means the card (and raises without one).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.deconv import (_check_output_padding, _check_padding,
                                     _ntuple, _pads_nd, deconv_output_shape,
                                     sd_geometry, split_filters)
from repro_torch.core.quant import quantize_channelwise
from repro_torch.device import resolve_device
from repro_torch.kernels.autotune import GemmPlan, KernelPlan
from repro_torch.kernels.sd_conv import CHAIN_ACTS, check_plan_type
from repro_torch.kernels.winograd import (MAX_TAPS, supported,
                                          transform_filters)

BACKENDS = ("fused", "torch", "winograd")
DTYPES = ("native", "int8")


def resolve_backend(backend: str, device=None) -> str:
    """``"auto"`` -> ``"fused"`` on a CUDA device, ``"torch"`` on the
    CPU; no ``device`` means the card (:func:`resolve_device`, which
    raises without one).  Explicit backends are validated."""
    if backend == "auto":
        dev = resolve_device(None) if device is None else torch.device(device)
        return "fused" if dev.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown SD backend {backend!r}; "
                         f"choose from {('auto',) + BACKENDS}")
    return backend


def to_ocmajor(ws: torch.Tensor, s, phases: Optional[int] = None
               ) -> torch.Tensor:
    """Relayout split filters from n-major (``c = phase*Cout + oc``, what
    ``depth_to_space`` consumes) to oc-major (``c = oc*phases + phase``,
    what the fused kernel consumes), any rank."""
    rank = ws.ndim - 2
    if phases is None:
        phases = math.prod(_ntuple(s, rank))
    kt = ws.shape[:rank]
    cin, nc = ws.shape[rank], ws.shape[rank + 1]
    w = ws.reshape(*kt, cin, phases, nc // phases)
    return w.transpose(-1, -2).reshape(*kt, cin, nc).contiguous()


@dataclass(frozen=True)
class DeconvPlan:
    """Split layout of one transposed convolution (see module doc).
    ``ws``/``bias`` (and, on an int8 plan, ``wscale``) are set only on a
    bound plan."""
    kernel: Tuple[int, ...]
    stride: Tuple[int, ...]
    padding: Tuple[Tuple[int, int], ...]
    cin: int
    cout: int
    backend: str = "torch"
    act: str = "linear"                    # "linear" | "relu" | "tanh"
    layout: str = "nmajor"
    tile: Optional[Union[GemmPlan, KernelPlan]] = None
    output_padding: Tuple[int, ...] = None  # normalised in plan()
    dtype: str = "native"                  # "native" | "int8"
    ws: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    wscale: Optional[torch.Tensor] = None   # int8: per split channel, f32
    sx_in: Optional[torch.Tensor] = None    # calibrated: 0-d f32 scales
    sx_out: Optional[torch.Tensor] = None
    chain_out: bool = False                 # int8 output for the next layer

    def __post_init__(self):
        if self.output_padding is None:
            object.__setattr__(self, "output_padding",
                               (0,) * len(self.kernel))

    @property
    def rank(self) -> int:
        return len(self.kernel)

    @property
    def phases(self) -> int:
        return math.prod(self.stride)

    @property
    def kt(self) -> Tuple[int, ...]:
        return sd_geometry(self.kernel, self.stride)[0]

    @property
    def pk(self) -> Tuple[int, ...]:
        return sd_geometry(self.kernel, self.stride)[1]

    @property
    def pi(self) -> Tuple[int, ...]:
        return sd_geometry(self.kernel, self.stride)[2]

    def out_shape(self, in_space: Sequence[int]) -> Tuple[int, ...]:
        return deconv_output_shape(in_space, self.kernel, self.stride,
                                   self.padding, self.output_padding)

    @property
    def bound(self) -> bool:
        return self.ws is not None

    def _bound_layout(self) -> str:
        """The filter layout this plan's execution path consumes:
        oc-major for K1 (rank 2), n-major for the torch backend and for
        the rank-3 fused lowering (its interleave is ``depth_to_space``),
        the transformed filters for K4."""
        if self.backend == "winograd":
            return "wino"
        if self.backend == "fused" and self.rank == 2:
            return "ocmajor"
        return "nmajor"

    def bind(self, w: torch.Tensor, scale: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None,
             act: Optional[str] = None) -> "DeconvPlan":
        """Split ``w`` once (the paper's offline transform) and return a
        bound plan.  ``scale`` (folded inference-BN gamma) multiplies the
        split filters' output channels: n-major channel ``n*Cout + oc``,
        so the per-oc scale is *tiled* over the phase blocks.  Filters
        are stored in the layout this plan's backend consumes; for
        ``"winograd"`` that is oc-major through the filter transform
        ``U = G g G^T``, once here, like the split and the fold.

        An int8 plan folds the scale *first*, on the f32 split filters,
        then quantizes them per split output channel
        (:func:`~repro_torch.core.quant.quantize_channelwise`): ``ws`` is
        int8 and ``wscale`` carries filter magnitude and BN gamma, in
        ``ws``'s channel order (n-major ``phase*Cout + oc``, relaid to
        oc-major ``oc*phases + phase`` with the filters)."""
        if tuple(w.shape) != (*self.kernel, self.cin, self.cout):
            raise ValueError(f"filter shape {tuple(w.shape)} does not match "
                             f"plan {(*self.kernel, self.cin, self.cout)}")
        ws = split_filters(w, self.stride)
        if scale is not None:
            ws = ws * scale.to(ws.dtype).tile(self.phases)
        wscale = None
        if self.dtype == "int8":
            ws, wscale = quantize_channelwise(ws, axis=-1)
        layout = self._bound_layout()
        ws = to_ocmajor(ws, self.stride) if layout in ("ocmajor", "wino") \
            else ws.contiguous()
        if wscale is not None and layout == "ocmajor":
            wscale = wscale.reshape(self.phases, self.cout).t().reshape(-1)
        if layout == "wino":
            ws = transform_filters(ws)
        return replace(self, ws=ws, bias=bias, layout=layout, wscale=wscale,
                       act=self.act if act is None else act)

    def with_chain(self, sx_in=None, sx_out=None,
                   chain_out: bool = False) -> "DeconvPlan":
        """Attach static calibrated activation scales (reference
        ``DeconvPlan.with_chain``).  ``sx_in``: the input's static scale;
        execution quantizes an f32 input against it with no amax
        reduction, or consumes an int8 input, the previous layer's chained
        output.  ``sx_out`` with ``chain_out=True``: fold ``1/sx_out``
        into the epilogue and write int8.  Only linear and relu commute
        with a positive scale, so a tanh layer can head a chain but never
        emit one.  Scales are kept as 0-d f32 tensors (on the filters'
        device once bound)."""
        if self.dtype != "int8":
            raise ValueError("activation chaining requires an int8 plan")
        if chain_out:
            if sx_out is None:
                raise ValueError("chain_out requires sx_out")
            if self.act not in CHAIN_ACTS:
                raise ValueError(
                    f"chain_out cannot fold 1/sx_out through act "
                    f"{self.act!r}; only linear/relu commute with a "
                    "positive scale")
        dev = self.ws.device if self.ws is not None else None

        def _sc(v):
            return None if v is None else torch.as_tensor(
                v, dtype=torch.float32, device=dev)

        return replace(self, sx_in=_sc(sx_in), sx_out=_sc(sx_out),
                       chain_out=bool(chain_out))


def plan(filter_shape: Sequence[int], stride, padding=0,
         backend: str = "auto", act: str = "linear",
         tile: Optional[Union[GemmPlan, KernelPlan]] = None, output_padding=0,
         dtype: str = "native", device=None) -> DeconvPlan:
    """Compute the split layout for a deconv filter shape ``(*K, C_in,
    C_out)`` (its length sets the rank).  Padding and output_padding are
    validated exactly like :mod:`repro_torch.core.deconv`.  ``backend=
    "auto"`` resolves against ``device`` (default: the card, raising
    without one).  ``dtype="int8"`` requests the int8 path, dynamic or,
    after :meth:`DeconvPlan.with_chain`, calibrated (``fused`` and
    ``torch`` backends; ranks 2 and 3 on ``fused``, as float plans); a
    winograd
    plan outside its envelope, int8 included, raises the reference's
    ``ValueError``.  ``tile``: a float ``fused`` plan's
    :class:`~repro_torch.kernels.autotune.GemmPlan` (K1's float branch,
    K2 in f32 at rank 3), an int8 ``fused`` or a ``winograd`` plan's
    :class:`~repro_torch.kernels.autotune.KernelPlan`; the other type
    raises ``TypeError`` (a ``torch`` plan launches no kernel and ignores
    it)."""
    if dtype not in DTYPES:
        raise ValueError(f"unknown plan dtype {dtype!r}; choose from "
                         f"{DTYPES}")
    dims = tuple(int(d) for d in filter_shape)
    if len(dims) not in (3, 4, 5):
        raise ValueError(f"filter_shape {filter_shape!r} must have "
                         "3 (1-D), 4 (2-D) or 5 (3-D) entries")
    rank = len(dims) - 2
    k, (cin, cout) = dims[:rank], dims[rank:]
    st = _ntuple(stride, rank)
    op = _ntuple(output_padding, rank)
    _check_padding(k, padding)
    _check_output_padding(op, st)
    resolved = resolve_backend(backend, device)
    if resolved == "winograd":
        kt = sd_geometry(k, st)[0]
        if not supported(kt, dtype):
            raise ValueError(
                f"winograd backend does not support this geometry: "
                f"subfilter taps {kt} (rank {rank}, dtype {dtype!r}); "
                f"requires rank <= 2, 1 <= taps <= {MAX_TAPS}, float "
                f"dtype — use backend='fused' for this layer")
        if rank == 1:
            raise NotImplementedError(
                "the winograd backend's 1-D lowering comes with the rank "
                "slice (ROADMAP.md item 11) — use backend='torch'")
    if resolved == "fused" and rank == 1:
        raise NotImplementedError(
            "the fused backend covers rank 2 and rank 3 so far; rank 1 "
            "comes with its slice (see ROADMAP.md item 11) — use "
            "backend='torch'")
    if resolved != "torch":
        check_plan_type(f"a {dtype} {resolved!r} plan's tile", tile,
                        gemm=resolved == "fused" and dtype == "native")
    return DeconvPlan(kernel=k, stride=st, padding=_pads_nd(padding, rank),
                      cin=cin, cout=cout, backend=resolved, act=act,
                      tile=tile, output_padding=op, dtype=dtype)

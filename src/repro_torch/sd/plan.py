"""DeconvPlan: the split layout of one transposed convolution.

The port of ``repro.sd.plan`` (float plans only).  A plan holds the
static geometry (kernel, stride, padding, output_padding, channels,
backend, epilogue activation, filter layout, kernel tile); a *bound*
plan also holds the pre-split filters ``ws`` (with any per-channel
scale folded in) and ``bias`` as plain tensor attributes.

Backends: ``"torch"`` runs the grouped stride-1 conv + pixel shuffle in
plain PyTorch (the twin of the reference's ``"xla"``) from n-major
filters; ``"fused"`` runs the fused CUDA kernel from oc-major filters.
``"auto"`` means fused for a CUDA device and torch for the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.deconv import (_check_output_padding, _check_padding,
                                     _ntuple, _pads_nd, deconv_output_shape,
                                     sd_geometry, split_filters)
from repro_torch.kernels.autotune import KernelPlan

BACKENDS = ("fused", "torch")


def resolve_backend(backend: str, device=None) -> str:
    """``"auto"`` -> ``"fused"`` on a CUDA device, ``"torch"`` on the
    CPU; explicit backends are validated."""
    if backend == "auto":
        return "fused" if torch.device(device).type == "cuda" else "torch"
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
    ``ws``/``bias`` are set only on a bound plan."""
    kernel: Tuple[int, ...]
    stride: Tuple[int, ...]
    padding: Tuple[Tuple[int, int], ...]
    cin: int
    cout: int
    backend: str = "torch"
    act: str = "linear"                    # "linear" | "relu" | "tanh"
    layout: str = "nmajor"
    tile: Optional[KernelPlan] = None
    output_padding: Tuple[int, ...] = None  # normalised in plan()
    ws: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None

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
        return "ocmajor" if self.backend == "fused" else "nmajor"

    def bind(self, w: torch.Tensor, scale: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None,
             act: Optional[str] = None) -> "DeconvPlan":
        """Split ``w`` once (the paper's offline transform) and return a
        bound plan.  ``scale`` (folded inference-BN gamma) multiplies the
        split filters' output channels: n-major channel ``n*Cout + oc``,
        so the per-oc scale is *tiled* over the phase blocks.  Filters
        are stored in the layout this plan's backend consumes."""
        if tuple(w.shape) != (*self.kernel, self.cin, self.cout):
            raise ValueError(f"filter shape {tuple(w.shape)} does not match "
                             f"plan {(*self.kernel, self.cin, self.cout)}")
        ws = split_filters(w, self.stride)
        if scale is not None:
            ws = ws * scale.to(ws.dtype).tile(self.phases)
        layout = self._bound_layout()
        ws = to_ocmajor(ws, self.stride) if layout == "ocmajor" \
            else ws.contiguous()
        return replace(self, ws=ws, bias=bias, layout=layout,
                       act=self.act if act is None else act)


def plan(filter_shape: Sequence[int], stride, padding=0,
         backend: str = "auto", act: str = "linear",
         tile: Optional[KernelPlan] = None, output_padding=0,
         dtype: str = "native", device=None) -> DeconvPlan:
    """Compute the split layout for a deconv filter shape ``(*K, C_in,
    C_out)`` (its length sets the rank).  Padding and output_padding are
    validated exactly like :mod:`repro_torch.core.deconv`.  ``backend=
    "auto"`` resolves against ``device`` (default: the CPU unless a card
    is named).  Only float plans exist in this port so far."""
    if dtype == "int8":
        raise NotImplementedError(
            "int8 plans come with the port's int8 slice (K1's quant "
            "branch); see ROADMAP.md")
    if dtype != "native":
        raise ValueError(f"unknown plan dtype {dtype!r}")
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
    resolved = resolve_backend(backend, device if device is not None
                               else "cpu")
    if resolved == "fused" and rank != 2:
        raise NotImplementedError(
            f"the fused backend covers rank 2 so far; rank {rank} comes "
            "with its slice (see ROADMAP.md) — use backend='torch'")
    return DeconvPlan(kernel=k, stride=st, padding=_pads_nd(padding, rank),
                      cin=cin, cout=cout, backend=resolved, act=act,
                      tile=tile, output_padding=op)

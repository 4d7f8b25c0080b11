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
filters at rank 2 and, as an H=1 launch, at rank 1, and at rank 3 the
depth-folded lowering (one K2 launch per depth tap, then the torch
interleave) from n-major filters; ``"winograd"`` runs K4, the F(2,r)
Winograd kernel, from oc-major filters transformed at bind (layout
``"wino"``; ranks 1 (an H=1 launch) and 2, per-dim taps <= 5, float
only).
``"auto"`` means fused for a CUDA device and torch for the CPU; with no
device named it means the card (and raises without one).

Cout sharding (the reference's ``shards``/``shard_axis``): a plan marked
:meth:`DeconvPlan.with_shards` ``(n, axis)``, or bound with ``mesh=``,
runs one ``1/n`` block of the output channels on each rank of the
mesh's ``axis`` and gathers the channel axis after the epilogue
(:mod:`repro_torch.sd.functional`).  A bound sharded plan holds only this
rank's block of ``ws``, ``bias`` and ``wscale`` (:meth:`DeconvPlan.
shard_put`).  Oc-major and Winograd filters are already contiguous per
Cout block; n-major filters (the ``torch`` backend, the rank-3 ``fused``
lowering) are first relaid by :func:`to_shardblocked`.
The reference's ``shard_scope`` has no counterpart: under
:func:`~repro_torch.distributed.spmd` the models' differentiable path
marks each layer on the active mesh's model degree itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.deconv import (_check_output_padding, _check_padding,
                                     _ntuple, _pads_nd, deconv_output_shape,
                                     sd_geometry, split_filters)
from repro_torch.core.quant import quantize_channelwise
from repro_torch.device import resolve_device
from repro_torch.kernels.autotune import GemmPlan, WinoPlan
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


def to_shardblocked(ws: torch.Tensor, s, shards: int,
                    phases: Optional[int] = None) -> torch.Tensor:
    """Permute n-major split filters so that each contiguous
    ``1/shards`` of the channel axis is itself n-major over one Cout
    block (reference ``to_shardblocked``): channel ``shard*(phases*
    Coutl) + phase*Coutl + ocl``, where plain n-major ``phase*Cout +
    oc`` spreads every shard's channels over all the phase blocks."""
    rank = ws.ndim - 2
    if phases is None:
        phases = math.prod(_ntuple(s, rank))
    kt = ws.shape[:rank]
    cin, nc = ws.shape[rank], ws.shape[rank + 1]
    w = ws.reshape(*kt, cin, phases, shards, nc // phases // shards)
    return w.transpose(-2, -3).reshape(*kt, cin, nc).contiguous()


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
    tile: Optional[Union[GemmPlan, WinoPlan]] = None
    output_padding: Tuple[int, ...] = None  # normalised in plan()
    dtype: str = "native"                  # "native" | "int8"
    shards: int = 1                        # Cout shards over shard_axis
    shard_axis: str = "model"              # the mesh axis of the shards
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
        oc-major for K1 (ranks 1 and 2), n-major for the torch backend
        and for the rank-3 fused lowering (its interleave is
        ``depth_to_space``), the transformed filters for K4."""
        if self.backend == "winograd":
            return "wino"
        if self.backend == "fused" and self.rank <= 2:
            return "ocmajor"
        return "nmajor"

    @property
    def cout_local(self) -> int:
        """Output channels each shard computes (``cout`` unsharded)."""
        return self.cout // self.shards

    def with_shards(self, shards: int, axis: Optional[str] = None
                    ) -> "DeconvPlan":
        """Mark the plan Cout-sharded ``shards`` ways over mesh axis
        ``axis`` (reference ``with_shards``): under :func:`~repro_torch.
        distributed.spmd` each rank of the axis runs its ``cout/shards``
        block and the output's channel axis is gathered.  ``bind(mesh=)``
        sets this itself."""
        shards = int(shards)
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if shards > 1 and self.cout % shards:
            raise ValueError(
                f"cout {self.cout} not divisible by {shards} shards")
        return replace(self, shards=shards,
                       shard_axis=self.shard_axis if axis is None
                       else str(axis))

    def block(self) -> "DeconvPlan":
        """This rank's Cout block as a plan of its own: the same bound
        leaves, ``cout_local`` channels and no gather, so it runs (and
        times) the shard's kernel launch alone."""
        return replace(self, shards=1, cout=self.cout_local)

    def shard_specs(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Which leaves slice (reference ``shard_specs``): ``{leaf:
        spec}`` for every tensor leaf set, ``ws`` split on its channel
        (last) axis and ``bias``/``wscale`` on their only axis over
        ``shard_axis``, the scalar ``sx_in``/``sx_out`` replicated;
        everything replicated when ``shards == 1``."""
        ax = self.shard_axis if self.shards > 1 else None
        out = {}
        if self.ws is not None:
            out["ws"] = (None,) * (self.ws.ndim - 1) + (ax,)
        for name in ("bias", "wscale"):
            if getattr(self, name) is not None:
                out[name] = (ax,)
        for name in ("sx_in", "sx_out"):
            if getattr(self, name) is not None:
                out[name] = ()
        return out

    def shard_put(self, mesh) -> "DeconvPlan":
        """Keep this rank's block (reference ``shard_put``): each leaf
        that :meth:`shard_specs` splits is narrowed to the rank's
        contiguous slice on ``mesh`` (a :class:`~repro_torch.distributed.
        Mesh`); the plan must hold every channel."""
        from repro_torch.distributed.sharding import local_block
        if ((self.ws is not None
             and self.ws.shape[-1] != self.cout * self.phases)
                or (self.bias is not None
                    and self.bias.shape[-1] != self.cout)):
            raise ValueError("shard_put needs a plan bound on every "
                             "channel")
        return replace(self, **{name: local_block(getattr(self, name), spec,
                                                  mesh)
                                for name, spec in self.shard_specs().items()
                                if any(spec)})

    def bind(self, w: torch.Tensor, scale: Optional[torch.Tensor] = None,
             bias: Optional[torch.Tensor] = None,
             act: Optional[str] = None, mesh=None,
             axis: str = "model") -> "DeconvPlan":
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
        oc-major ``oc*phases + phase`` with the filters).

        ``mesh`` (a :class:`~repro_torch.distributed.Mesh`) binds the
        plan Cout-sharded over its ``axis`` (reference ``bind(mesh=)``):
        the split, fold and quantization run on every channel, as
        unsharded, so the per-channel scales are the same; n-major
        filters (and ``wscale``) are then relaid shard-blocked
        (:func:`to_shardblocked`), and the plan keeps this rank's block
        (:meth:`shard_put`).  ``cout`` must divide by the axis' size;
        bind a narrow layer without ``mesh`` to replicate it."""
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
        shards, shard_axis = self.shards, self.shard_axis
        if mesh is not None:
            if axis not in mesh.axis_names:
                raise ValueError(f"mesh has no axis {axis!r}; axes are "
                                 f"{tuple(mesh.axis_names)}")
            shards, shard_axis = int(mesh.shape[axis]), axis
            if shards > 1 and self.cout % shards:
                raise ValueError(
                    f"cout {self.cout} not divisible by mesh axis "
                    f"{axis!r} size {shards}; bind without mesh= to "
                    "replicate this layer")
        if shards > 1 and layout == "nmajor":
            ws = to_shardblocked(ws, self.stride, shards, self.phases)
            if wscale is not None:
                wscale = wscale.reshape(self.phases, shards, -1).transpose(
                    0, 1).reshape(-1)
        bound = replace(self, ws=ws, bias=bias, layout=layout, wscale=wscale,
                        shards=shards, shard_axis=shard_axis,
                        act=self.act if act is None else act)
        return bound.shard_put(mesh) if mesh is not None else bound

    def with_tile(self, tile: Optional[Union[GemmPlan, WinoPlan]]
                  ) -> "DeconvPlan":
        """The same plan, bound filters shared, on another kernel tile
        (``None``: the kernel's call-time default); reference
        ``DeconvPlan.with_tile``.  The tile's type is checked as
        :func:`plan` checks it."""
        if self.backend != "torch":
            want = WinoPlan if self.backend == "winograd" else GemmPlan
            check_plan_type(f"a {self.dtype} {self.backend!r} plan's tile",
                            tile, want)
        return replace(self, tile=tile)

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
         tile: Optional[Union[GemmPlan, WinoPlan]] = None,
         output_padding=0,
         dtype: str = "native", device=None) -> DeconvPlan:
    """Compute the split layout for a deconv filter shape ``(*K, C_in,
    C_out)`` (its length sets the rank).  Padding and output_padding are
    validated exactly like :mod:`repro_torch.core.deconv`.  ``backend=
    "auto"`` resolves against ``device`` (default: the card, raising
    without one).  ``dtype="int8"`` requests the int8 path, dynamic or,
    after :meth:`DeconvPlan.with_chain`, calibrated (``fused`` and
    ``torch`` backends, every rank); a winograd plan outside its
    envelope (rank 3, per-dim taps above 5, int8) raises the
    reference's ``ValueError``.  ``tile``: a ``fused`` plan's
    :class:`~repro_torch.kernels.autotune.GemmPlan` (K1's float and int8
    branches at ranks 1 and 2, K2 and K2's int8 pair at rank 3, one
    launch per depth tap); a ``winograd`` plan's
    :class:`~repro_torch.kernels.autotune.WinoPlan` (K4); another type
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
    if resolved != "torch":
        want = WinoPlan if resolved == "winograd" else GemmPlan
        check_plan_type(f"a {dtype} {resolved!r} plan's tile", tile, want)
    return DeconvPlan(kernel=k, stride=st, padding=_pads_nd(padding, rank),
                      cin=cin, cout=cout, backend=resolved, act=act,
                      tile=tile, output_padding=op, dtype=dtype)


"""The (data, model) mesh, its collectives and the generators' sharding
rules: the generative half of the reference's
``repro.distributed.sharding``.

The port runs SPMD over ``torch.distributed``: every rank runs the same
program on its own slice, as each device does under the reference's
``shard_map``.  A :class:`Mesh` names this rank's place on a (data,
model) grid of ``dp * mp`` ranks (row-major, ``rank = data_index * mp +
model_index``, ``jax.make_mesh``'s device order) and holds the process
groups of its row (the ranks that share its data index: the ``"model"``
axis) and of its column (the ``"data"`` axis).  Collectives go over one
axis; an axis of size 1 needs none.  :func:`spmd` makes a mesh the one
that sharded plans gather over (the torch form of being inside
``shard_map``): a Cout-sharded plan run outside it raises, and the
models' differentiable path shards each layer on the active mesh's
model degree (:func:`layer_shards`; the reference's ``shard_scope``).

Logical axes (:class:`MeshContext`): ``'channel'`` -> ``'model'``, the
Cout shards of the split filters; ``'batch'`` -> ``'data'``.  A spec is a
tuple with one entry per tensor dim, the mesh axis that dim is split over
or ``None``; ``()`` is replicated (the reference's ``PartitionSpec``
entries, as a plain tuple).  :func:`gen_param_specs` gives each
shardable deconv filter ``(*K, Cin, Cout)`` the spec ``(None, ...,
'model')`` and replicates every other leaf; :func:`local_block` keeps
this rank's block of a tensor under its spec.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Spec = Tuple[Optional[str], ...]
AXES = ("data", "model")


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on a (data, model) mesh (see module doc).

    ``groups`` maps an axis name to the process group of this rank's
    ranks along it (``None`` for an axis of size 1); a mesh built without
    groups (``Mesh(dp, mp)``) describes a layout and raises on a
    collective over an axis of size > 1.  ``backend`` and ``device`` are
    the ones the mesh was made with (:func:`repro_torch.launch.mesh.
    make_dev_mesh`); nothing here changes either."""
    dp: int
    mp: int
    rank: int = 0
    backend: Optional[str] = None
    device: torch.device = torch.device("cpu")
    groups: Dict[str, Any] = field(default_factory=dict)
    axis_names = AXES            # a class constant, not a field

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.dp, "model": self.mp}

    @property
    def size(self) -> int:
        return self.dp * self.mp

    @property
    def data_index(self) -> int:
        return self.rank // self.mp

    @property
    def model_index(self) -> int:
        return self.rank % self.mp

    def axis_size(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}; axes are "
                             f"{self.axis_names}")
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        self.axis_size(axis)
        return self.data_index if axis == "data" else self.model_index

    def group(self, axis: str):
        if self.axis_size(axis) == 1:
            return None
        if self.groups.get(axis) is None:
            raise ValueError(f"mesh dp{self.dp}xmp{self.mp} has no process "
                             f"group for axis {axis!r}; make it with "
                             "repro_torch.launch.mesh.make_dev_mesh")
        return self.groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh(dp{self.dp}xmp{self.mp}, rank {self.rank}, "
                f"{self.backend}, {self.device})")

    # ---- collectives ----------------------------------------------------
    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The blocks of ``t`` from every rank along ``axis``,
        concatenated on ``dim`` in axis-index order (the reference's
        tiled ``all_gather``)."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        import torch.distributed as dist
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self.group(axis))
        return torch.cat(parts, dim=dim)

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axis`` (``psum``), as a
        new tensor."""
        if self.axis_size(axis) == 1:
            return t
        import torch.distributed as dist
        out = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group(axis))
        return out

    def world_max(self, value: float) -> float:
        """The largest of every rank's ``value`` (all ranks get it)."""
        if self.size == 1:
            return float(value)
        import torch.distributed as dist
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def check_same(self, what: str, values: Sequence[int]) -> None:
        """Raise unless every rank passed the same integers: a guard in
        front of collectives whose sizes follow from host decisions."""
        if self.size == 1:
            return
        import torch.distributed as dist
        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self.device)
        lo, hi = t.clone(), t.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        if not torch.equal(lo, hi):
            raise RuntimeError(
                f"ranks of {self!r} disagree on {what}: {list(values)} "
                f"here, between {lo.tolist()} and {hi.tolist()} over the "
                "mesh; every rank must make the same launches")

    def barrier(self) -> None:
        if self.size > 1:
            import torch.distributed as dist
            dist.barrier()


# ---------------------------------------------------------------------------
# The active mesh: what a sharded plan gathers over.
# ---------------------------------------------------------------------------

_ACTIVE = threading.local()


@contextmanager
def spmd(mesh: Optional[Mesh]):
    """While active, Cout-sharded plans (``sd.execute``, the sharded
    ``sd.conv_transpose`` and its backward) run their collectives over
    ``mesh``: the port's form of running under ``shard_map``."""
    prev = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = prev


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost :func:`spmd`, or ``None``."""
    return getattr(_ACTIVE, "mesh", None)


# ---------------------------------------------------------------------------
# Logical axes and the generators' parameter specs.
# ---------------------------------------------------------------------------

class MeshContext:
    """Maps the generative stack's logical axes to mesh axes (reference
    ``MeshContext``, its ``'channel'`` and ``'batch'`` rules):
    ``'channel'`` -> ``'model'`` (the Cout shards of the split filters),
    ``'batch'`` -> ``'data'``.  ``mesh`` needs ``axis_names`` and
    ``shape`` (``{axis: size}``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        names = tuple(mesh.axis_names)
        self.batch_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in names)
        self.logical: Dict[str, Any] = {
            "batch": self.batch_axes,
            "channel": "model" if "model" in names else None,
        }

    def _flat(self, ax) -> Tuple[str, ...]:
        v = self.logical.get(ax, ax)
        if v is None:
            return ()
        return v if isinstance(v, tuple) else (v,)

    def spec(self, *logical_axes) -> Spec:
        """The spec of ``logical_axes`` (one per dim): each resolved to
        its mesh axis, ``None`` where unsharded."""
        phys = []
        for ax in logical_axes:
            if ax is None:
                phys.append(None)
                continue
            r = self._flat(ax)
            phys.append(r if len(r) > 1 else (r[0] if r else None))
        return tuple(phys)

    def axis_size(self, logical: str) -> int:
        n = 1
        for phys in self._flat(logical):
            n *= int(self.mesh.shape[phys])
        return n


def layer_shards(cout: int, mp: int) -> int:
    """Cout shards of a deconv layer on a model degree ``mp``: ``mp``
    where it divides ``cout``, else 1, so a narrow last layer (cout 3 or
    1) replicates instead of taking the net off the mesh (reference
    ``_layer_shards``).  The one rule the engine's bound plans, the param
    specs and the models' differentiable path all follow, so serving and
    training keep one layout."""
    return mp if mp > 1 and cout % mp == 0 else 1


def gen_param_specs(net_spec, mc: MeshContext) -> Dict[str, Dict[str, Spec]]:
    """``{layer: {param: spec}}`` for a generative net's params on ``mc``
    (reference ``gen_param_specs``): a deconv filter whose ``cout``
    divides the ``'channel'`` axis splits on its last axis, the slice
    ``DeconvPlan.bind(mesh=)`` keeps for serving, so one layout serves
    and trains; fc weights, biases, BN scales and narrow layers
    replicate (the sharded forward gathers each layer's output, so scale
    and bias act on the whole channel axis and their grads need no
    model-axis collective)."""
    n_channel = mc.axis_size("channel")
    specs: Dict[str, Dict[str, Spec]] = {}
    for layer in net_spec.layers:
        entry = {"w": mc.spec(), "b": mc.spec()}
        if layer.kind != "fc":
            entry["scale"] = mc.spec()
        if (layer.kind == "deconv"
                and layer_shards(layer.cout, n_channel) > 1):
            entry["w"] = mc.spec(*(None,) * (layer.rank + 1), "channel")
        specs[layer.name] = entry
    return specs


def local_block(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: each dim split over a
    mesh axis narrowed to the rank's contiguous 1/size of it."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n = mesh.axis_size(ax)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                             f"split {n} ways over mesh axis {ax!r}")
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.axis_index(ax) * size, size)
    return t.contiguous()

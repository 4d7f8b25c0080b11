"""The (data, model) mesh, its collectives and the sharding rules of
both halves of the repo: the port of the reference's
``repro.distributed.sharding``.

The port runs SPMD over ``torch.distributed``: every rank runs the same
program on its own slice, as each device does under the reference's
``shard_map`` or its jitted, sharded steps.  A :class:`Mesh` names this
rank's place on a (data, model) grid of ``dp * mp`` ranks (row-major,
``rank = data_index * mp + model_index``, ``jax.make_mesh``'s device
order) and holds the process groups of its row (the ranks that share its
data index: the ``"model"`` axis) and of its column (the ``"data"``
axis).  A mesh with ``pod > 1`` adds an outermost ``"pod"`` axis
(``rank = (pod_index * dp + data_index) * mp + model_index``, the
production two-pod layout); the batch then splits over ``("pod",
"data")``.  Collectives go over one axis; an axis of size 1 needs none.
An ``abstract`` mesh runs them without communication, shapes only.

A spec is a tuple with one entry per tensor dim: the mesh axis that dim
is split over, a tuple of axes (split over their product, the first
outermost), or ``None``; ``()`` is replicated (the reference's
``PartitionSpec`` entries, as a plain tuple).  :func:`local_block` keeps
this rank's block of a tensor under its spec, :func:`place` of every leaf
of a tree, :func:`gather` puts the whole tensor back together.

**The generators** (the reference's ``'channel'`` half).  :func:`spmd`
makes a mesh the one that sharded plans gather over (the torch form of
being inside ``shard_map``): a Cout-sharded plan run outside it raises,
and the models' differentiable path shards each layer on the active
mesh's model degree (:func:`layer_shards`; the reference's
``shard_scope``).  :func:`gen_param_specs` gives each shardable deconv
filter ``(*K, Cin, Cout)`` the spec ``(None, ..., 'model')`` and
replicates every other leaf.

**The LM.**  :class:`MeshContext` maps the reference's logical axes to
mesh axes under its two strategies (``'tp'``: ``'batch'`` -> data,
``'tensor'`` / ``'expert'`` -> model, ``'fsdp'`` -> data when ``fsdp``;
``'fsdp'``: everything over the batch, params over both axes), and
:func:`mesh_context` installs one for the model code (:func:`current`).
The rules are the reference's, leaf for leaf: :func:`param_specs`
(``PARAM_RULES``, first match wins, a leading ``None`` per stacked
repeat axis), :func:`cache_specs` (the KV cache split on its ring's
slots W over the model axis, FlashDecoding-style), :func:`batch_specs`
and the shape-aware :func:`constrain`, which here decides how a tensor
is split rather than being an op on it.  The LM runs SPMD under a
context whose mesh is :attr:`Mesh.live` (process groups behind every
axis of size > 1); a context on a mesh built without groups
(``Mesh(2, 2)``) is a layout only: the model runs in one process and
reads from it what the reference reads from its context (the MoE's
dispatch groups).  The autograd-aware collectives of the Megatron-style
layers are :func:`copy_to` (identity, its adjoint a sum over an axis),
:func:`reduce_from` (a sum over an axis, its adjoint the identity),
:func:`gather_axis` (the blocks of a
data-sharded parameter put together at use, its adjoint a sum over the
axis narrowed to this rank's block), :func:`gather_dim` (one dim's
blocks put together, the adjoint summed or not by how the ranks use
the whole) and :func:`cols_matmul` (any columns of ``x @ W`` from a
column-split ``W``, by one gather of the smaller of the weight and the
product); those of the sequence-parallel residual stream (Megatron-SP,
``act_shard="seq"``) pair :meth:`Mesh.reduce_scatter` with
:meth:`Mesh.all_gather` both ways: :func:`seq_gather`,
:func:`seq_scatter` and :func:`seq_split`.
"""

from __future__ import annotations

import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]
AXES = ("data", "model")


def ring_wire_bytes(op: str, size: float, g: int) -> float:
    """The bytes one rank puts on the wire for a collective of ``size``
    bytes over a group of ``g`` ranks, by ring accounting (the
    reference's ``launch/hlo_analysis.py``): an all-reduce ``2 * size *
    (g - 1) / g`` (a reduce-scatter and an all-gather), an all-gather
    ``size * (g - 1) / g`` with ``size`` the gathered result, a
    reduce-scatter or an all-to-all ``size * (g - 1) / g``, a
    point-to-point permute ``size``."""
    frac = (g - 1) / g
    if op in ("all_reduce", "all-reduce"):
        return 2 * size * frac
    if op in ("collective_permute", "collective-permute"):
        return float(size)
    return size * frac


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on a (data, model) mesh, or on a (pod, data,
    model) one where ``pod > 1`` (see module doc).

    ``groups`` maps an axis name to the process group of this rank's
    ranks along it (``None`` for an axis of size 1); a mesh built without
    groups (``Mesh(dp, mp)``) describes a layout and raises on a
    collective over an axis of size > 1.  ``abstract`` makes every
    collective one without communication: it allocates and returns what
    the live call does (the dry-run's transport on meta tensors,
    :mod:`repro_torch.launch.dryrun`, one code path with the live one),
    and the mesh counts as :attr:`live`, so the model takes the path it
    takes on live ranks.
    ``backend`` and ``device`` are the ones the mesh was made with
    (:func:`repro_torch.launch.mesh.make_dev_mesh`); nothing here changes
    either.  ``counts`` tallies the collectives this rank issued,
    ``"all_gather/model"`` and the like (an axis of size 1 issues none);
    ``traffic`` records, per such key, the result's bytes (a
    reduce-scatter's: its operand's), the group size ``g`` and the
    ring-accounted wire bytes (:func:`ring_wire_bytes`), summed over the
    calls."""
    dp: int
    mp: int
    rank: int = 0
    backend: Optional[str] = None
    device: torch.device = torch.device("cpu")
    groups: Dict[str, Any] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    pod: int = 1
    abstract: bool = False
    traffic: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("pod",) + AXES if self.pod > 1 else AXES

    @property
    def shape(self) -> Dict[str, int]:
        out = {"data": self.dp, "model": self.mp}
        if self.pod > 1:
            out = {"pod": self.pod, **out}
        return out

    @property
    def size(self) -> int:
        return self.pod * self.dp * self.mp

    @property
    def data_index(self) -> int:
        return (self.rank // self.mp) % self.dp

    @property
    def model_index(self) -> int:
        return self.rank % self.mp

    @property
    def pod_index(self) -> int:
        return self.rank // (self.dp * self.mp)

    @property
    def live(self) -> bool:
        """More than one rank, with a process group behind every axis of
        size > 1 (or an :attr:`abstract` transport): the model runs SPMD
        on it.  A mesh without groups is a layout only."""
        return self.size > 1 and (self.abstract or all(
            self.groups.get(a) is not None for a in self.axis_names
            if self.shape[a] > 1))

    def axis_size(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}; axes are "
                             f"{self.axis_names}")
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        self.axis_size(axis)
        return {"pod": self.pod_index, "data": self.data_index,
                "model": self.model_index}[axis]

    def group(self, axis: str):
        if self.axis_size(axis) == 1:
            return None
        if self.groups.get(axis) is None:
            raise ValueError(f"mesh {self.name} has no process group for "
                             f"axis {axis!r}; make it with "
                             "repro_torch.launch.mesh.make_dev_mesh")
        return self.groups[axis]

    @property
    def name(self) -> str:
        pod = f"pod{self.pod}x" if self.pod > 1 else ""
        return f"{pod}dp{self.dp}xmp{self.mp}"

    def __repr__(self) -> str:
        kind = "abstract" if self.abstract else self.backend
        return (f"Mesh({self.name}, rank {self.rank}, {kind}, "
                f"{self.device})")

    # ---- collectives ----------------------------------------------------
    def all_gather(self, t: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The blocks of ``t`` from every rank along ``axis``,
        concatenated on ``dim`` in axis-index order (the reference's
        tiled ``all_gather``)."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        if not self.abstract:
            import torch.distributed as dist
            dist.all_gather(parts, t, group=self.group(axis))
        out = torch.cat(parts, dim=dim)
        self._count("all_gather", axis, out)
        return out

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axis``, of which this
        rank keeps its block on ``dim`` (axis-index order: the
        reference's tiled ``psum_scatter``), as a new tensor."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                             f"split {n} ways over mesh axis {axis!r}")
        parts = [p.contiguous() for p in t.chunk(n, dim)]
        out = torch.empty_like(parts[0])
        if not self.abstract:
            import torch.distributed as dist
            dist.reduce_scatter(out, parts, group=self.group(axis))
        self._count("reduce_scatter", axis, t)
        return out

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """The sum (``op="sum"``, ``psum``) or the largest value
        (``"max"``, ``pmax``) of ``t`` over the ranks along ``axis``, as
        a new tensor."""
        if self.axis_size(axis) == 1:
            return t
        out = t.detach().clone(memory_format=torch.contiguous_format)
        if not self.abstract:
            import torch.distributed as dist
            dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                     "max": dist.ReduceOp.MAX}[op],
                            group=self.group(axis))
        self._count("all_reduce", axis, out)
        return out

    def _count(self, op: str, axis: str, out: torch.Tensor) -> None:
        """Tally one call; ``out`` its result (a reduce-scatter's
        operand, whose size the ring accounting reads)."""
        key = f"{op}/{axis}"
        self.counts[key] = self.counts.get(key, 0) + 1
        g = self.axis_size(axis)
        size = out.numel() * out.element_size()
        rec = self.traffic.setdefault(key, {"bytes": 0, "group": g,
                                            "wire": 0.0})
        rec["bytes"] += size
        rec["wire"] += ring_wire_bytes(op, size, g)

    def world_max(self, value: float) -> float:
        """The largest of every rank's ``value`` (all ranks get it)."""
        if self.size == 1 or self.abstract:
            return float(value)
        import torch.distributed as dist
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def check_same(self, what: str, values: Sequence[int]) -> None:
        """Raise unless every rank passed the same integers: a guard in
        front of collectives whose sizes follow from host decisions."""
        if self.size == 1 or self.abstract:
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
        if self.size > 1 and not self.abstract:
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
# Logical axes: the mesh context.
# ---------------------------------------------------------------------------

class MeshContext:
    """Maps logical axes to mesh axes under a strategy (the reference's
    ``MeshContext``).  ``mesh`` needs ``axis_names`` and ``shape``
    (``{axis: size}``): a :class:`Mesh`, live or a layout.

    ``strategy='tp'`` (Megatron): ``'batch'`` over (pod, data),
    ``'tensor'`` (heads, FFN, vocab), ``'expert'`` and ``'channel'`` (the
    generators' Cout shards) over model, ``'fsdp'`` over data when
    ``fsdp`` (params additionally split over the data ranks, ZeRO-3).
    ``strategy='fsdp'``: the batch over every axis, no tensor
    parallelism, params over (data, model) when ``fsdp``.  The port's
    rules take both; its LM runs ``'tp'`` only (no config sets
    ``'fsdp'``)."""

    def __init__(self, mesh, *, fsdp: bool = True, strategy: str = "tp"):
        if strategy not in ("tp", "fsdp"):
            raise ValueError(f"unknown mesh strategy {strategy!r}; "
                             "'tp' or 'fsdp'")
        self.mesh = mesh
        self.strategy = strategy
        self.fsdp = fsdp
        names = tuple(mesh.axis_names)
        model = "model" if "model" in names else None
        if strategy == "fsdp":
            self.batch_axes: Tuple[str, ...] = tuple(
                a for a in ("pod", "data", "model") if a in names)
            self.logical: Dict[str, Any] = {
                "batch": self.batch_axes, "tensor": None,
                "expert": model, "channel": model,
                "fsdp": tuple(a for a in ("data", "model") if a in names)
                if fsdp else None}
        else:
            self.batch_axes = tuple(a for a in ("pod", "data")
                                    if a in names)
            self.logical = {
                "batch": self.batch_axes, "tensor": model,
                "expert": model, "channel": model,
                "fsdp": "data" if (fsdp and "data" in names) else None}

    def _flat(self, ax) -> Tuple[str, ...]:
        v = self.logical.get(ax, ax)
        if v is None:
            return ()
        return v if isinstance(v, tuple) else (v,)

    def spec(self, *logical_axes) -> Spec:
        """The spec of ``logical_axes`` (one per dim): each resolved to
        its mesh axis (a tuple where it names several, or a tuple of
        logical axes), ``None`` where unsharded."""
        phys: List[Entry] = []
        for ax in logical_axes:
            if ax is None:
                phys.append(None)
            elif isinstance(ax, tuple):
                r = tuple(p for a in ax for p in self._flat(a))
                phys.append(r if r else None)
            else:
                r = self._flat(ax)
                phys.append(r if len(r) > 1 else (r[0] if r else None))
        return tuple(phys)

    def axis_size(self, logical) -> int:
        """Ranks along ``logical`` (a logical axis or a tuple of them)."""
        n = 1
        for ax in (logical if isinstance(logical, tuple) else (logical,)):
            for phys in self._flat(ax):
                n *= int(self.mesh.shape[phys])
        return n


_CTX = threading.local()


def current() -> Optional[MeshContext]:
    """The context of the innermost :func:`mesh_context`, or ``None``."""
    return getattr(_CTX, "mc", None)


@contextmanager
def mesh_context(mesh, **kw):
    """Install a :class:`MeshContext` on ``mesh`` (``**kw`` its
    ``fsdp``/``strategy``) for the model code, or an existing context
    as it is; ``None`` installs none (the model then runs unsharded, as
    the reference's constraints are no-ops without a context)."""
    prev = current()
    if mesh is None or isinstance(mesh, MeshContext):
        _CTX.mc = mesh
    else:
        _CTX.mc = MeshContext(mesh, **kw)
    try:
        yield _CTX.mc
    finally:
        _CTX.mc = prev


def live_mesh(mc: Optional[MeshContext] = None) -> Optional[Mesh]:
    """The mesh the LM runs SPMD on: ``mc``'s (default :func:`current`)
    where it is :attr:`Mesh.live`, else ``None`` (no context, one rank,
    or a layout)."""
    mc = current() if mc is None else mc
    if mc is None or not getattr(mc.mesh, "live", False):
        return None
    return mc.mesh


def constrain(shape: Sequence[int], *logical_axes,
              mc: Optional[MeshContext] = None) -> Spec:
    """The spec the reference's ``constrain`` gives a tensor of
    ``shape`` under ``mc`` (default :func:`current`; ``()`` without
    one): each logical axis resolved, and any that does not divide its
    dim replicated (batch 1 on a data axis of 2, 40 heads on a model
    axis of 16) instead of padded.  In the port it decides how a tensor
    is split; it is not an op on the tensor."""
    mc = current() if mc is None else mc
    if mc is None:
        return ()
    eff = []
    for i, ax in enumerate(logical_axes):
        if ax is None or i >= len(shape):
            eff.append(None)
            continue
        n = mc.axis_size(ax)
        eff.append(ax if (n and shape[i] % n == 0) else None)
    return mc.spec(*eff)


# ---------------------------------------------------------------------------
# The generators' parameter specs.
# ---------------------------------------------------------------------------

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


def _entry_axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _entry_split(mesh: Mesh, entry: Entry) -> Tuple[int, int]:
    """(blocks, this rank's block index) of a dim split over ``entry``:
    over a tuple of axes, the first outermost (row-major)."""
    n, idx = 1, 0
    for ax in _entry_axes(entry):
        k = mesh.axis_size(ax)
        n, idx = n * k, idx * k + mesh.axis_index(ax)
    return n, idx


def local_shape(shape: Sequence[int], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    """The shape of this rank's block of a ``shape`` tensor under
    ``spec``; raises ``ValueError`` naming a dim its axes do not
    divide."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n, _ = _entry_split(mesh, entry)
        if n == 1:
            continue
        if out[dim] % n:
            raise ValueError(f"dim {dim} of size {out[dim]} does not split "
                             f"{n} ways over mesh axis {entry!r}")
        out[dim] //= n
    return tuple(out)


def local_block(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: each dim split over a
    mesh axis (or a tuple of axes) narrowed to the rank's contiguous
    1/size of it."""
    for dim, entry in enumerate(spec):
        n, idx = _entry_split(mesh, entry)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                             f"split {n} ways over mesh axis {entry!r}")
        size = t.shape[dim] // n
        t = t.narrow(dim, idx * size, size)
    return t.contiguous()


def gather_block(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec``
    (:func:`local_block`'s inverse; no gradient)."""
    for dim, entry in enumerate(spec):
        for ax in reversed(_entry_axes(entry)):
            t = mesh.all_gather(t, ax, dim)
    return t


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and e and all(isinstance(a, str)
                                              for a in e))
        for e in x)


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and its spec tree (dicts, lists,
    NamedTuples; a spec is a tuple leaf), rebuilt in ``tree``'s form."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, v, s)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)) and not _is_spec(specs):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def place(tree, specs, mesh: Mesh):
    """This rank's block of every tensor leaf of ``tree`` under its
    entry in ``specs`` (:func:`local_block`; other leaves, such as the
    cache's ``pos``, as they are): the form the sharded LM takes its
    params and caches in.  The blocks are copies, so ``tree`` can go
    and an in-place update of a block leaves it alone."""
    return _zip_map(lambda t, s: local_block(t, s, mesh).clone()
                    if isinstance(t, torch.Tensor) else t, tree, specs)


def gather(tree, specs, mesh: Mesh):
    """Every leaf of a tree of blocks put back together
    (:func:`place`'s inverse)."""
    return _zip_map(lambda t, s: gather_block(t, s, mesh)
                    if isinstance(t, torch.Tensor) else t, tree, specs)


# ---------------------------------------------------------------------------
# The LM's rules: params, caches and batches (path-regex -> logical spec).
# ---------------------------------------------------------------------------

# Order matters: first match wins (so the dense ``wg``/``wu``/``wd``
# rules also take the MoE experts, ahead of the ``moe_ep``/``moe_tp``
# lines, in the reference as here).  Specs are given for the *unstacked*
# layer params; a leading None is prepended for each stacked (repeat)
# axis an array has beyond the rule's.
PARAM_RULES: List[Tuple[str, Tuple]] = [
    (r"embed$", ("tensor", "fsdp")),            # (vocab, d)
    (r"head$", ("fsdp", "tensor")),             # (d, vocab)
    (r"pos_embed.*$", (None, "tensor")),
    (r"patch_proj$", (None, "tensor")),
    # attention
    (r"wq$|wk$|wv$", ("fsdp", "tensor")),
    (r"wo$", ("tensor", "fsdp")),
    (r"bq$|bk$|bv$", ("tensor",)),
    # dense mlp
    (r"wg$|wu$", ("fsdp", "tensor")),
    (r"wd$", ("tensor", "fsdp")),
    # moe (expert-parallel): experts over model axis
    (r"moe_ep/(wg|wu)$", ("expert", "fsdp", None)),
    (r"moe_ep/wd$", ("expert", None, "fsdp")),
    # moe (tensor-parallel inside experts)
    (r"moe_tp/(wg|wu)$", (None, "fsdp", "tensor")),
    (r"moe_tp/wd$", (None, "tensor", "fsdp")),
    (r"router$", (None, None)),
    # mamba
    (r"in_proj$", ("fsdp", "tensor")),
    (r"out_proj$", ("tensor", "fsdp")),
    (r"conv_w$", (None, "tensor")),
    (r"conv_b$", ("tensor",)),
    (r"x_proj$", ("tensor", None)),
    (r"dt_proj$", (None, "tensor")),
    (r"dt_bias$", ("tensor",)),
    (r"A_log$", ("tensor", None)),
    (r"D$", ("tensor",)),
    # xlstm
    (r"up$", ("fsdp", "tensor")),
    (r"down$", ("tensor", "fsdp")),
    (r"wif$|bif$", (None,)),
    (r"wx$", ("fsdp", "tensor")),
    (r"wh$", (None, "tensor")),
    # defaults: norms / scalars replicated
    (r".*", ()),
]


def _tree_paths(tree, prefix: str = ""):
    """``(path, leaf)`` pairs, dict keys sorted and joined by ``/``, a
    NamedTuple's fields by name, list items by index (the reference's
    ``_tree_paths``)."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += _tree_paths(tree[k], f"{prefix}{k}/")
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            out += _tree_paths(getattr(tree, k), f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += _tree_paths(v, f"{prefix}{i}/")
    else:
        out.append((prefix[:-1], tree))
    return out


def _rebuild(tree, smap: Dict[str, Spec], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, smap, f"{prefix}{k}/")
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(**{k: _rebuild(getattr(tree, k), smap,
                                         f"{prefix}{k}/")
                             for k in tree._fields})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, smap, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return smap[prefix[:-1]]


def param_spec(path: str, ndim: int, mc: MeshContext, *,
               fsdp: bool = True) -> Spec:
    """The spec of the param at ``path`` (``/``-joined) with ``ndim``
    dims: the first rule of ``PARAM_RULES`` whose pattern it matches,
    ``'fsdp'`` dropped when not ``fsdp``, a leading ``None`` per dim
    beyond the rule's."""
    for pat, logical in PARAM_RULES:
        if re.search(pat, path):
            eff = tuple(None if (ax == "fsdp" and not fsdp) else ax
                        for ax in logical)
            if len(eff) < ndim:
                eff = (None,) * (ndim - len(eff)) + eff
            return mc.spec(*eff)
    raise AssertionError("PARAM_RULES ends in a catch-all")


def param_specs(params, mc: MeshContext, *, fsdp: bool = True):
    """The spec tree of an LM param tree (tensors, meta tensors or the
    blocks of a placed tree: only paths and ranks are read), by
    :data:`PARAM_RULES`."""
    smap = {path: param_spec(path, getattr(leaf, "ndim", 0), mc, fsdp=fsdp)
            for path, leaf in _tree_paths(params)}
    return _rebuild(params, smap)


def _div(dim: int, mc: MeshContext, logical: str) -> bool:
    n = mc.axis_size(logical)
    return n > 0 and dim % n == 0


def batch_axis_or_none(dim: int, mc: MeshContext):
    """``'batch'`` if it divides ``dim``, else None (a batch of 1)."""
    return "batch" if _div(dim, mc, "batch") else None


def _cache_leaf_spec(name: str, leaf, mc: MeshContext):
    """The logical spec of a cache leaf by its name (the reference's):
    the KV cache ``(R, B, W, H, dh)`` split on B over the batch axes and
    on its ring's slots W over the model axis (FlashDecoding-style:
    attention computes slot-local partials and only (B, H, 1)-sized
    softmax statistics cross ranks); the recurrent states on B and on
    their inner width."""
    nd = getattr(leaf, "ndim", 0)
    shp = tuple(getattr(leaf, "shape", ()))

    def b(i):
        return "batch" if (len(shp) > i and _div(shp[i], mc, "batch")) \
            else None

    def t(i):
        return "tensor" if (len(shp) > i and _div(shp[i], mc, "tensor")) \
            else None

    if name in ("k", "v", "cross_k", "cross_v"):     # (R,B,W,H,dh)
        return (None, b(1), t(2), None, None)
    if name == "kpos":
        return (None,) * nd
    if name == "conv":                                # (R,B,dc-1,di)
        return (None, b(1), None, t(3))
    if name == "ssm":                                 # (R,B,di,ds)
        return (None, b(1), t(2), None)
    if name == "c" and nd == 5:                       # mlstm (R,B,H,dk,dv)
        return (None, b(1), None, None, t(4))
    if name == "n" and nd == 4:                       # mlstm (R,B,H,dk)
        return (None, b(1), None, None)
    if name in ("c", "n", "m", "h"):                  # slstm / mlstm-m
        return (None, b(1)) + (None,) * max(nd - 2, 0)
    if name == "pos":
        return ()
    return (None,) * nd


def cache_specs(cache, mc: MeshContext):
    """The spec tree of a prefill / decode cache (the reference's
    ``cache_shardings``, as specs)."""
    smap = {path: mc.spec(*_cache_leaf_spec(path.rsplit("/", 1)[-1], leaf,
                                            mc))
            for path, leaf in _tree_paths(cache)}
    return _rebuild(cache, smap)


def batch_specs(batch, mc: MeshContext):
    """Every batch leaf's dim 0 over the batch axes where they divide it
    (the reference's ``batch_shardings``, as specs)."""
    return {k: mc.spec(batch_axis_or_none(v.shape[0], mc),
                       *([None] * (v.ndim - 1)))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Autograd-aware collectives of the sharded LM (Megatron's f and g).
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dims, summed=True):
        ctx.mesh, ctx.axis, ctx.dims, ctx.summed = mesh, axis, dims, summed
        ctx.sizes = [t.shape[d] for d in dims]
        for d in dims:
            t = mesh.all_gather(t, axis, d)
        return t

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.mesh, ctx.axis
        if ctx.summed:
            g = mesh.all_reduce(g, axis)
        i = mesh.axis_index(axis)
        for d, n in zip(ctx.dims, ctx.sizes):
            g = g.narrow(d, i * n, n)
        return g.contiguous(), None, None, None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x``, replicated over ``axis``, entering per-rank work whose
    adjoint this rank holds only its share of: the identity forward,
    the sum of the ranks' adjoints backward (Megatron's ``f``)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``axis`` (``psum``),
    whose adjoint every rank already holds whole: the identity backward
    (Megatron's ``g``)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def gather_axis(t: torch.Tensor, spec: Spec, mesh: Mesh,
                axis: str = "data") -> torch.Tensor:
    """A param block put together over ``axis`` in every dim its spec
    splits over that axis alone, at its point of use (FSDP); the
    adjoint sums the ranks' gradients over ``axis`` and keeps this
    rank's block.  A dim split over a tuple of axes (strategy
    ``'fsdp'``) is refused: the port runs ``'tp'`` only."""
    dims = []
    for d, e in enumerate(spec):
        if isinstance(e, tuple) and axis in e:
            raise NotImplementedError(
                f"a param split over {e} (strategy 'fsdp') cannot be "
                "gathered at use; the port's LM runs strategy 'tp' only")
        if e == axis:
            dims.append(d)
    if not dims or mesh.axis_size(axis) == 1:
        return t
    return _GatherAxis.apply(t, mesh, axis, tuple(dims))


def gather_dim(t: torch.Tensor, mesh: Mesh, axis: str, dim: int, *,
               partial: bool = True) -> torch.Tensor:
    """The ranks' blocks of ``t`` along ``axis`` put together on ``dim``
    (one ``all_gather``).  The adjoint keeps this rank's block of the
    whole tensor's gradient, summed over ``axis`` first where the ranks
    use the whole tensor each for their own share of the work
    (``partial``: a reduce-scatter, as :func:`gather_axis`'s), as it is
    where every rank computes the same from it (``partial=False``: the
    residual stream's inputs)."""
    if mesh.axis_size(axis) == 1:
        return t
    return _GatherAxis.apply(t, mesh, axis, (dim % t.ndim,), partial)


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axis, ctx.dim), None, None, None


class _SeqScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.reduce_scatter(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.axis, ctx.dim), None, None, None


class _SeqSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        n = t.shape[dim] // mesh.axis_size(axis)
        return t.narrow(dim, mesh.axis_index(axis) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather(g.contiguous(), ctx.axis, ctx.dim), None,
                None, None)


def seq_gather(t: torch.Tensor, mesh: Mesh, dim: int = 1, *,
               axis: str = "model") -> torch.Tensor:
    """The ranks' blocks of a sequence-sharded ``t`` put together on
    ``dim``, entering per-rank work (heads, an FFN slice): Megatron-SP's
    all-gather, whose adjoint reduce-scatters the ranks' partial
    gradients, so each rank gets the sum's block.  (Where every rank
    computes the same from the whole, :func:`gather_dim` with
    ``partial=False``.)"""
    if mesh.axis_size(axis) == 1:
        return t
    return _SeqGather.apply(t, mesh, axis, dim % t.ndim)


def seq_scatter(y: torch.Tensor, mesh: Mesh, dim: int = 1, *,
                axis: str = "model") -> torch.Tensor:
    """The ranks' partial ``y`` summed, of which this rank keeps its
    block on ``dim``: Megatron-SP's reduce-scatter at a block's exit,
    whose adjoint all-gathers the blocks' gradients."""
    if mesh.axis_size(axis) == 1:
        return y
    return _SeqScatter.apply(y, mesh, axis, dim % y.ndim)


def seq_split(t: torch.Tensor, mesh: Mesh, dim: int = 1, *,
              axis: str = "model") -> torch.Tensor:
    """This rank's block on ``dim`` of a ``t`` replicated over ``axis``
    (no communication); the adjoint all-gathers the blocks' gradients,
    so each rank holds the whole tensor's."""
    if mesh.axis_size(axis) == 1:
        return t
    return _SeqSplit.apply(t, mesh, axis, dim % t.ndim)


def cols_matmul(x: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                cols: Sequence[Tuple[int, int]], *, axis: str = "model",
                partial: bool = True) -> List[torch.Tensor]:
    """``x @ W[:, a:b]`` for each ``(a, b)`` of ``cols``, where ``w`` is
    this rank's contiguous block of W's columns over ``axis``: one
    ``all_gather`` of whichever is smaller, the product ``x @ w`` (when
    ``x`` has fewer rows than ``w``: decode, short prompts) or the
    weight ``w`` (long prefills), so that each rank gets any columns of
    the whole product.  ``partial`` as :func:`gather_dim`."""
    if mesh.axis_size(axis) == 1:
        y = x @ w
        return [y[..., a:b] for a, b in cols]
    if x.numel() // x.shape[-1] < w.shape[0]:
        y = gather_dim(x @ w, mesh, axis, -1, partial=partial)
        return [y[..., a:b] for a, b in cols]
    whole = gather_dim(w, mesh, axis, -1, partial=partial)
    y = x @ torch.cat([whole[:, a:b] for a, b in cols], 1)
    return list(y.split([b - a for a, b in cols], -1))


def whole_cols(x: torch.Tensor, ws: Sequence[torch.Tensor], mesh: Mesh, *,
               axis: str = "model", partial: bool = True
               ) -> List[torch.Tensor]:
    """``x @ W`` whole for each W of ``ws``, where each ``w`` is this
    rank's contiguous block of W's columns over ``axis`` (a weight whose
    column block is not whole heads: 40 heads on 16 ranks): the blocks
    side by side go through one :func:`cols_matmul`, which gathers the
    smaller of the weight and the product, and each W's columns are
    picked from every rank's part.  ``partial`` as :func:`gather_dim`
    (each rank then uses its own share of the whole product)."""
    n = mesh.axis_size(axis)
    widths = [w.shape[-1] for w in ws]
    if n == 1:
        return list((x @ torch.cat(list(ws), -1)).split(widths, -1))
    step = sum(widths)
    offs = [sum(widths[:i]) for i in range(len(ws))]
    cols = [(r * step + o, r * step + o + c) for o, c in zip(offs, widths)
            for r in range(n)]
    parts = cols_matmul(x, torch.cat(list(ws), -1), mesh, cols, axis=axis,
                        partial=partial)
    return [torch.cat(parts[i * n:(i + 1) * n], -1) for i in range(len(ws))]


def whole_blocks(ts: Sequence[torch.Tensor], mesh: Mesh, *,
                 axis: str = "model", partial: bool = True
                 ) -> List[torch.Tensor]:
    """Each tensor of ``ts`` whole on its last dim, where each is this
    rank's contiguous block of it over ``axis`` (biases of a column-split
    weight): one gather of the blocks side by side.  ``partial`` as
    :func:`gather_dim`."""
    n = mesh.axis_size(axis)
    if n == 1:
        return list(ts)
    widths = [t.shape[-1] for t in ts]
    g = gather_dim(torch.cat(list(ts), -1), mesh, axis, -1, partial=partial)
    g = g.reshape(*g.shape[:-1], n, sum(widths))
    return [t.reshape(*t.shape[:-2], -1)
            for t in g.split(widths, -1)]

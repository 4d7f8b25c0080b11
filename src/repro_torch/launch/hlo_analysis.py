"""Collective bytes and roofline terms of a rank's step: the role of the
reference's ``launch/hlo_analysis.py`` in the port.

The reference parses the partitioned HLO for its collectives.  The port
has no HLO: its collectives are the calls its :class:`~repro_torch.
distributed.sharding.Mesh` issues, which tally themselves per
``op/axis`` (``Mesh.traffic``: the results' bytes, the group size ``g``
and the wire bytes by the reference's ring accounting,
:func:`~repro_torch.distributed.sharding.ring_wire_bytes`).
:func:`collective_stats` turns that tally into :class:`CollectiveStats`,
the reference's fields, keyed by ``op/axis``.

The costs the dry-run (:mod:`repro_torch.launch.dryrun`) hands
:func:`roofline_terms` are the port's, not XLA's:

* ``flops``: the tensor-core work, the matmul-class ops that
  ``torch.utils.flop_counter`` counts (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions) plus K5's own formula (``2·B·H·D·S(S+1)``
  for a causal launch, :func:`repro_torch.kernels.flash_attn.k5_flops`);
  elementwise work is not counted.
* ``bytes accessed``: for every dispatched op that is not a view, the
  bytes of each tensor operand plus those of each output that is not an
  operand (an in-place op's output is its operand): what eager PyTorch
  moves, op by op, with nothing fused; K5's operands and output count
  as one op's.

The constants are the H100 SXM5's, from NVIDIA's H100 Tensor Core GPU
data sheet: :data:`PEAK_FLOPS` dense bf16, :data:`HBM_BW` (HBM3),
:data:`NVLINK_BW` per direction for a collective whose group lies within
one 8-GPU node of consecutive ranks, and :data:`IB_BW`, one 400 Gb/s
NDR port per GPU (eight per node), for any other group.  A card that
runs below its 700 W limit runs slower than these.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Union

PEAK_FLOPS = 989e12          # dense bf16 per H100 SXM5 (data sheet)
HBM_BW = 3.35e12             # bytes/s, HBM3 per H100 SXM5 (data sheet)
NVLINK_BW = 450e9            # bytes/s per direction, NVLink 4 (data sheet)
IB_BW = 50e9                 # bytes/s per GPU: 8 x 400 Gb/s NDR a node
NODE = 8                     # GPUs per node joined by NVLink


@dataclasses.dataclass
class CollectiveStats:
    op_counts: Dict[str, int]
    op_bytes: Dict[str, float]      # wire bytes per device, ring-adjusted
    total_bytes: float
    lines: List[str]


def collective_stats(traffic: Mapping[str, Mapping[str, float]],
                     counts: Mapping[str, int]) -> CollectiveStats:
    """The :class:`CollectiveStats` of a mesh's tally (``Mesh.traffic``,
    and ``Mesh.counts`` for the calls), keyed by ``op/axis``; ``lines``
    one line per key with its calls, result bytes, ``g`` and wire
    bytes."""
    op_counts = {k: int(counts[k]) for k in traffic}
    op_bytes = {k: float(v["wire"]) for k, v in traffic.items()}
    lines = [f"{k}: {op_counts[k]} calls, {int(v['bytes'])} result bytes, "
             f"g={int(v['group'])}, {v['wire']:.0f} wire bytes"
             for k, v in sorted(traffic.items())]
    return CollectiveStats(op_counts, op_bytes, sum(op_bytes.values()),
                           lines)


def axis_link(mesh, axis: str) -> str:
    """``"nvlink"`` where every group along ``axis`` lies within one
    node of :data:`NODE` consecutive ranks, else ``"ib"``.  On the
    row-major mesh the groups along ``axis`` tile aligned blocks of
    ``stride * g`` ranks (``stride`` the product of the later axes), so
    they stay inside nodes when that block divides a node."""
    names = list(mesh.axis_names)
    stride = 1
    for a in names[names.index(axis) + 1:]:
        stride *= mesh.axis_size(a)
    return "nvlink" if NODE % (stride * mesh.axis_size(axis)) == 0 \
        else "ib"


LINK_BW = {"nvlink": NVLINK_BW, "ib": IB_BW}


def link_bandwidths(mesh) -> Dict[str, float]:
    """Bytes/s for each axis of ``mesh`` by :func:`axis_link`."""
    return {a: LINK_BW[axis_link(mesh, a)] for a in mesh.axis_names}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    dominant: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def table_row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def roofline_terms(cost: Dict[str, float], coll: CollectiveStats, *,
                   link_bw: Union[float, Mapping[str, float]] = IB_BW,
                   model_flops_per_device: float = 0.0,
                   peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW) -> Roofline:
    """The reference's roofline of one rank's step: seconds of compute
    (``cost["flops"] / peak_flops``), of memory (``cost["bytes
    accessed"] / hbm_bw``) and of collectives (each ``op/axis`` key's
    wire bytes over its link's rate), the dominant one, and the useful
    share ``model_flops_per_device / flops``.  ``link_bw``: one rate
    for every collective (the reference's form), or one per axis (a
    mapping, as :func:`link_bandwidths` gives)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    c = flops / peak_flops
    m = byts / hbm_bw
    if isinstance(link_bw, Mapping):
        k = sum(b / link_bw[key.rsplit("/", 1)[-1]]
                for key, b in coll.op_bytes.items())
    else:
        k = coll.total_bytes / link_bw
    dom = max((("compute", c), ("memory", m), ("collective", k)),
              key=lambda t: t[1])[0]
    ratio = (model_flops_per_device / flops) if flops else 0.0
    return Roofline(c, m, k, flops, byts, coll.total_bytes, dom,
                    model_flops_per_device, ratio)

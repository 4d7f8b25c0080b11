"""Tile plans for the fused split-deconv kernel on Hopper.

The JAX package sizes its Pallas tiles against an 8 MiB VMEM model; on
the H100 the limit is the shared memory one block can use (227 KB) and,
in practice, occupancy: smaller blocks let more of them share an SM.
:func:`heuristic_plan` picks a tile from the launch geometry alone.
Measuring and caching tiles comes later; :func:`estimate_ms` callers get
``None`` until then.

A block of :data:`THREADS` threads computes ``(th + res_h>0) x (tw +
res_w>0)`` conv positions (the extra row/col feeds the residual crop)
times ``tc`` phase channels: ``tc / MICRO`` threads along the channels,
the rest along the positions, each thread a ``MICRO x MICRO`` register
tile.  ``tcin`` input channels are staged in shared memory per step of
the block's own loop over Cin.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

SMEM_BUDGET = 232_448          # bytes of shared memory one block may use
SMEM_TARGET = 64 * 1024        # keep >= 3 blocks resident per SM
THREADS = 256
MICRO = 4                      # register tile: MICRO positions x MICRO chans
TILE_CHANNELS = (16, 32, 64)   # phase channels per block (4, 8, 16 threads)


@dataclass(frozen=True)
class KernelPlan:
    """Tile of one fused launch: ``th x tw`` conv rows/cols written per
    block, ``tcin`` input channels staged per Cin step, ``tc`` phase
    channels (oc-major, ``oc * sh*sw + phase``) per block."""
    th: int
    tw: int
    tcin: int
    tc: int


@dataclass(frozen=True)
class FusedGeom:
    """What the fused kernel launches: unpadded input ``h x w x cin``,
    ``nc = Cout*sh*sw`` phase channels, ``(kth, ktw)`` taps, interleave
    ``(sh, sw)``, final output ``out_h x out_w`` and the residual crop
    ``(res_h, res_w)``."""
    h: int
    w: int
    cin: int
    nc: int
    kth: int
    ktw: int
    sh: int
    sw: int
    out_h: int
    out_w: int
    res_h: int = 0
    res_w: int = 0


def band_plane(geom: FusedGeom, plan: KernelPlan) -> int:
    """Words per staged input-channel plane: the conv tile plus its
    ``K_T - 1`` halo, rounded up to odd so that the per-channel stride
    spreads consecutive channels over all 32 banks."""
    rh = plan.th + (1 if geom.res_h else 0)
    rw = plan.tw + (1 if geom.res_w else 0)
    return ((rh + geom.kth - 1) * (rw + geom.ktw - 1)) | 1


def smem_bytes(geom: FusedGeom, plan: KernelPlan) -> int:
    """Dynamic shared memory of one block: the f32 filter block
    ``(kth, ktw, tcin, tc)`` and the f32 input band ``(tcin, plane)``."""
    filt = geom.kth * geom.ktw * plan.tcin * plan.tc
    return 4 * (filt + plan.tcin * band_plane(geom, plan))


def heuristic_plan(geom: FusedGeom) -> KernelPlan:
    """Untuned default.  Channel tile: the smallest of
    :data:`TILE_CHANNELS` that holds all phase channels, else the
    largest.  Position tile: as square as the block's ``THREADS / (tc /
    MICRO) * MICRO`` positions allow, no larger than the output needs.
    ``tcin``: up to 32 input channels per step, halved until the block
    fits :data:`SMEM_TARGET` (and never past :data:`SMEM_BUDGET`)."""
    tc = next((t for t in TILE_CHANNELS if t >= geom.nc), TILE_CHANNELS[-1])
    positions = THREADS // (tc // MICRO) * MICRO
    eh, ew = (1 if geom.res_h else 0), (1 if geom.res_w else 0)
    need_h = -(-geom.out_h // geom.sh)
    need_w = -(-geom.out_w // geom.sw)
    side = math.isqrt(positions)
    th = max(1, min(need_h, side - eh))
    tw = max(1, min(need_w, positions // (th + eh) - ew))
    th = max(1, min(need_h, positions // (tw + ew) - eh))
    tcin = min(32, geom.cin)
    plan = KernelPlan(th=th, tw=tw, tcin=tcin, tc=tc)
    while tcin > 1 and smem_bytes(geom, plan) > SMEM_TARGET:
        tcin = max(1, tcin // 2)
        plan = KernelPlan(th=th, tw=tw, tcin=tcin, tc=tc)
    if smem_bytes(geom, plan) > SMEM_BUDGET:
        raise ValueError(f"no tile of {geom} fits {SMEM_BUDGET} bytes of "
                         "shared memory")
    return plan

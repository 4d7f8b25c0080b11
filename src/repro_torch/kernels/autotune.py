"""Tile plans for the port's kernels on Hopper: the fused split-deconv
kernel (K1), the SD backward's stride-1 conv (K2) and filter grad (K3),
and the Winograd split conv (K4, :func:`wino_plan`).

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

A geometry carries its operand dtype (``dtype``: ``""`` for float,
``"int8"`` for K1's quant branch), so the float and the int8 launch of
one layer are distinct geometries (a geometry is its own tile key), and
the int8 branch's shared memory is modelled at one byte per staged
value.
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
    ``(sh, sw)``, final output ``out_h x out_w``, the residual crop
    ``(res_h, res_w)`` and the operand dtype (``""`` float, ``"int8"``
    the quant branch)."""
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
    dtype: str = ""


def band_plane(geom: FusedGeom, plan: KernelPlan) -> int:
    """Words per staged input-channel plane: the conv tile plus its
    ``K_T - 1`` halo, rounded up to odd so that the per-channel stride
    spreads consecutive channels over all 32 banks."""
    rh = plan.th + (1 if geom.res_h else 0)
    rw = plan.tw + (1 if geom.res_w else 0)
    return ((rh + geom.kth - 1) * (rw + geom.ktw - 1)) | 1


def smem_bytes(geom: FusedGeom, plan: KernelPlan) -> int:
    """Dynamic shared memory of one block: the filter block ``(kth, ktw,
    tcin, tc)`` and the input band ``(tcin, plane)``, f32 words; int8
    launches stage both as int8 packed four input channels to a 32-bit
    word (``ceil(tcin / 4)`` words per position, the tail zero-filled)."""
    words = -(-plan.tcin // 4) if geom.dtype == "int8" else plan.tcin
    filt = geom.kth * geom.ktw * words * plan.tc
    return 4 * (filt + words * band_plane(geom, plan))


def heuristic_plan(geom: FusedGeom) -> KernelPlan:
    """Untuned default.  Channel tile: the smallest of
    :data:`TILE_CHANNELS` that holds all phase channels, else the
    largest.  Position tile: as square as the block's ``THREADS / (tc /
    MICRO) * MICRO`` positions allow, no larger than the output needs.
    ``tcin``: up to 32 input channels per step (64 for int8, whose
    staging is 4x smaller), halved until the block fits
    :data:`SMEM_TARGET` (and never past :data:`SMEM_BUDGET`)."""
    tc = next((t for t in TILE_CHANNELS if t >= geom.nc), TILE_CHANNELS[-1])
    positions = THREADS // (tc // MICRO) * MICRO
    eh, ew = (1 if geom.res_h else 0), (1 if geom.res_w else 0)
    need_h = -(-geom.out_h // geom.sh)
    need_w = -(-geom.out_w // geom.sw)
    side = math.isqrt(positions)
    th = max(1, min(need_h, side - eh))
    tw = max(1, min(need_w, positions // (th + eh) - ew))
    th = max(1, min(need_h, positions // (tw + ew) - eh))
    tcin = min(64 if geom.dtype == "int8" else 32, geom.cin)
    plan = KernelPlan(th=th, tw=tw, tcin=tcin, tc=tc)
    while tcin > 1 and smem_bytes(geom, plan) > SMEM_TARGET:
        tcin = max(1, tcin // 2)
        plan = KernelPlan(th=th, tw=tw, tcin=tcin, tc=tc)
    if smem_bytes(geom, plan) > SMEM_BUDGET:
        raise ValueError(f"no tile of {geom} fits {SMEM_BUDGET} bytes of "
                         "shared memory")
    return plan


# ---------------------------------------------------------------------------
# The SD backward's kernels: K2 (stride-1 conv, the input grad) and K3
# (the filter grad).  Counterparts of the reference's ``tag="dx"`` /
# ``tag="dw"`` ConvGeom keys; heuristic only, like K1's.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvGeom:
    """What K2 launches: unpadded input ``h x w x cin``, ``co`` output
    channels, ``(kth, ktw)`` taps, output window ``out_h x out_w``."""
    h: int
    w: int
    cin: int
    co: int
    kth: int
    ktw: int
    out_h: int
    out_w: int

    def as_fused(self) -> FusedGeom:
        """K2 is K1's block without the interleave: K1's geometry at
        stride 1 with no residual crop (same staging, same shared
        memory)."""
        return FusedGeom(h=self.h, w=self.w, cin=self.cin, nc=self.co,
                         kth=self.kth, ktw=self.ktw, sh=1, sw=1,
                         out_h=self.out_h, out_w=self.out_w)


def conv_plan(geom: ConvGeom) -> KernelPlan:
    """K2's tile: K1's heuristic on :meth:`ConvGeom.as_fused` (``tc`` is
    the output-channel tile, ``th x tw`` the output positions).
    ``tcin`` is never padded up: DCGAN d3's dx contracts over 12 phase
    channels in one chunk of 12."""
    return heuristic_plan(geom.as_fused())


DW_TCI = 64                    # K3: input channels per block (fixed)
DW_MK = 32                     # K3: positions of M staged per step
DW_TILE_CO = (16, 32, 64)      # K3: output channels per block
DW_MIN_CHUNK = 4 * DW_MK       # K3: least positions one block reduces
SMS = 132                      # H100 SXM streaming multiprocessors


@dataclass(frozen=True)
class FilterGradGeom:
    """What K3 launches: input ``b x h x w x cin`` (unpadded), cotangent
    ``b x o1h x o1w x nco``, taps ``(kth, ktw)``."""
    b: int
    h: int
    w: int
    cin: int
    nco: int
    kth: int
    ktw: int
    o1h: int
    o1w: int

    @property
    def m(self) -> int:
        """Length of the reduction: every position of the cotangent."""
        return self.b * self.o1h * self.o1w


@dataclass(frozen=True)
class FilterGradPlan:
    """K3's tile: ``tco`` output channels per block (64 input channels,
    ``tco/4 * 16`` threads) and ``chunk`` positions of M per block;
    ``ceil(M / chunk)`` chunks are summed by the reduce pass."""
    tco: int
    chunk: int


def dw_threads(plan: FilterGradPlan) -> int:
    return DW_TCI // MICRO * plan.tco // MICRO


def dw_splits(geom: FilterGradGeom, plan: FilterGradPlan) -> int:
    return -(-geom.m // plan.chunk)


def filter_grad_plan(geom: FilterGradGeom) -> FilterGradPlan:
    """Untuned default.  Channel tile: the smallest of
    :data:`DW_TILE_CO` that holds all output channels, else the largest.
    Split of the reduction: enough chunks that the blocks hold about 1024
    threads per SM (so narrow outputs, a few blocks per tap, still fill
    the card), but no chunk shorter than :data:`DW_MIN_CHUNK`; chunks
    are whole steps of :data:`DW_MK`.  Shared memory is fixed at
    ``4 * DW_MK * (DW_TCI + tco)`` bytes (16 KB at most), far inside
    a block's 227 KB, so unlike the TPU's ``_dw_fit_channels`` nothing
    needs clamping."""
    tco = next((t for t in DW_TILE_CO if t >= geom.nco), DW_TILE_CO[-1])
    plan = FilterGradPlan(tco=tco, chunk=DW_MK)
    base = (geom.kth * geom.ktw * -(-geom.cin // DW_TCI)
            * -(-geom.nco // tco))
    want = -(-SMS * 1024 // (dw_threads(plan) * base))
    most = max(1, geom.m // DW_MIN_CHUNK)
    splits = max(1, min(want, most))
    chunk = -(-geom.m // splits)
    chunk = -(-chunk // DW_MK) * DW_MK
    return FilterGradPlan(tco=tco, chunk=chunk)


# ---------------------------------------------------------------------------
# K4, the Winograd split conv.  Counterpart of the reference's
# ``algo="wino"`` VMEM model (``vmem_plan_bytes``); heuristic only.
# ---------------------------------------------------------------------------

WINO_TILE_CHANNELS = (16, 32)  # K4: phase channels per block
WINO_ITEMS = 2 * THREADS       # K4: MICRO x MICRO (tile, channel) register
#                                tiles per block, two per thread


@dataclass(frozen=True)
class WinoGeom(FusedGeom):
    """What K4 launches: K1's geometry read as F(m, K_T) per dim, ``m =
    1`` for a 1-tap dim and 2 otherwise."""

    @property
    def mh(self) -> int:
        return 1 if self.kth == 1 else 2

    @property
    def mw(self) -> int:
        return 1 if self.ktw == 1 else 2

    @property
    def alphas(self) -> int:
        """Points of the transform domain, ``alpha_h * alpha_w``."""
        return (self.mh + self.kth - 1) * (self.mw + self.ktw - 1)


def wino_tiles(geom: WinoGeom, plan: KernelPlan):
    """``(nth, ntw)``: Winograd tiles per block, the ``th (+1 for the
    residual crop)`` conv rows rounded up to whole ``m``-tiles."""
    rh = plan.th + (1 if geom.res_h else 0)
    rw = plan.tw + (1 if geom.res_w else 0)
    return -(-rh // geom.mh), -(-rw // geom.mw)


def wino_items(geom: WinoGeom, plan: KernelPlan) -> int:
    """Register tiles of one block: ``alpha_h*alpha_w`` transform points
    x tiles (padded to MICRO) / MICRO x ``tc`` / MICRO."""
    nth, ntw = wino_tiles(geom, plan)
    tp = -(-nth * ntw // MICRO)
    return geom.alphas * tp * (plan.tc // MICRO)


def wino_smem_bytes(geom: WinoGeom, plan: KernelPlan) -> int:
    """Dynamic shared memory of one K4 block, all f32: the staged input
    band ``(tcin, plane)`` (the tiles' rows plus the ``K_T - 1`` halo,
    plane odd as in K1, rounded up to a float4), the ``V`` scratch
    ``(alpha_h*alpha_w, tcin, tiles)`` and the transformed filter block
    ``(alpha_h*alpha_w, tcin, tc)``; after the Cin loop the same memory
    holds the accumulators ``(alpha_h*alpha_w, tiles, tc)`` for the
    epilogue's ``A^T M A``.  ``tiles`` is padded to a multiple of
    MICRO."""
    nth, ntw = wino_tiles(geom, plan)
    tp = -(-nth * ntw // MICRO) * MICRO
    plane = ((nth * geom.mh + geom.kth - 1)
             * (ntw * geom.mw + geom.ktw - 1)) | 1
    band = -(-plan.tcin * plane // MICRO) * MICRO
    stage = band + geom.alphas * plan.tcin * (tp + plan.tc)
    return 4 * max(stage, geom.alphas * tp * plan.tc)


def wino_plan(geom: WinoGeom) -> KernelPlan:
    """Untuned default for K4.  Channel tile: 16 when the layer has no
    more phase channels, else 32.  Tiles: as many as
    :data:`WINO_ITEMS` register tiles allow at that channel tile,
    ``2^j x`` the rest (square-ish, no larger than the output needs);
    ``th``/``tw`` are the conv rows those tiles write.  ``tcin``: up to
    32 input channels per step, halved until the block fits
    :data:`SMEM_TARGET` (never past :data:`SMEM_BUDGET`)."""
    tc = WINO_TILE_CHANNELS[0] if geom.nc <= WINO_TILE_CHANNELS[0] \
        else WINO_TILE_CHANNELS[-1]
    tiles = MICRO * (WINO_ITEMS // (geom.alphas * (tc // MICRO)))
    eh, ew = (1 if geom.res_h else 0), (1 if geom.res_w else 0)
    rows_h = -(-geom.out_h // geom.sh)
    rows_w = -(-geom.out_w // geom.sw)
    need_h = -(-(rows_h + eh) // geom.mh)
    need_w = -(-(rows_w + ew) // geom.mw)
    nth = max(1, min(need_h, 1 << (math.isqrt(tiles).bit_length() - 1)))
    ntw = max(1, min(need_w, tiles // nth))
    nth = max(1, min(need_h, tiles // ntw))
    th = max(1, min(rows_h, nth * geom.mh - eh))
    tw = max(1, min(rows_w, ntw * geom.mw - ew))
    tcin = min(32, geom.cin)
    plan = KernelPlan(th=th, tw=tw, tcin=tcin, tc=tc)
    while tcin > 1 and wino_smem_bytes(geom, plan) > SMEM_TARGET:
        tcin = max(1, tcin // 2)
        plan = KernelPlan(th=th, tw=tw, tcin=tcin, tc=tc)
    if (wino_smem_bytes(geom, plan) > SMEM_BUDGET
            or wino_items(geom, plan) > WINO_ITEMS):
        raise ValueError(f"no K4 tile of {geom} fits a block")
    return plan

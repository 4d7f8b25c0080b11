"""Tile plans for the port's kernels on Hopper: the stride-1 convs on
the shared implicit-GEMM mainloop (K1's float and int8 branches and K2
in f32 and int8, :class:`GemmPlan`, :func:`gemm_plan`), the filter grad
on the same tile shapes (K3, :func:`filter_grad_plan`) and the Winograd
split conv (K4, :class:`WinoPlan`, :func:`wino_plan`).

The JAX package sizes its Pallas tiles against an 8 MiB VMEM model; on
the H100 the limit is the shared memory one block can use (227 KB) and,
in practice, filling the 132 SMs.  The plans above are heuristics from
the launch geometry alone; a deconv layer's K1 and K4 tiles can also be
measured on the card and cached (the reference's plan cache,
``src/repro/kernels/autotune.py``):

* :class:`DeconvGeom` — the cache key, one deconv layer's launch at a
  batch, with the reference's ``ConvGeom.key()`` strings letter for
  letter (``_int8``, ``_wino``, ``_q8out`` and ``_mp{n}`` suffixes);
  :meth:`DeconvGeom.launch` is the GEMM or Winograd geometry the kernel
  is handed.
* :func:`candidate_plans` — the tiles timed for a geometry (from
  :func:`gemm_plans` and :func:`wino_plans`, which ``gemm_sweep.py``
  sweeps too).
* :func:`tune` / :func:`measure` — time every candidate, persist the
  winner; :func:`measured_ms` and :func:`best_algo` read the cache back
  (the per-layer choice between K1 and K4).
* :func:`get_plan` — the measured tile where one exists for this device
  and the launch takes it, else ``None``: the kernel's own default at
  call time, so an untuned engine launches what it launched before.

Cache format (JSON)::

    {"version": 1,
     "plans": {"b16_h12w12_ci256_co128_kt3_s2":
                   {"bn": ..., "splits": ..., "ms": <device ms>,
                    "source": "measured", "backend": <card name>}}}

(a ``_wino`` key holds ``nth``, ``ntw``, ``nb``, ``tc``).  An entry
steers only the device it was measured on: ``backend`` is the card's
name, or ``"cpu"``.  The file is ``$REPRO_TORCH_SD_PLAN_CACHE``,
default ``~/.cache/repro_torch/sd_plans.json`` (never the reference's
``REPRO_SD_PLAN_CACHE``).

A geometry carries its operand dtype (``""`` f32, ``"bf16"``,
``"int8"``), so the float and the int8 launch of one layer are distinct
geometries with their own k-tile depth and column cap.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import asdict, dataclass, replace
from typing import Callable, Dict, List, Optional, Union

from repro_torch.core.iohelpers import atomic_write_json, read_json

SMEM_BUDGET = 232_448          # bytes of shared memory one block may use


# ---------------------------------------------------------------------------
# K2, the stride-1 conv (the SD backward's input grad; a depth tap of the
# 3-D lowering, f32 or int8).  Counterpart of the reference's ConvGeom.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ConvGeom:
    """What K2 launches: unpadded input ``h x w x cin``, ``co`` output
    channels, ``(kth, ktw)`` taps, output window ``out_h x out_w``, and
    the operand dtype (``""`` f32, ``"int8"`` the int8 pair; the
    reference's ``ConvGeom(dtype="int8")`` key)."""
    h: int
    w: int
    cin: int
    co: int
    kth: int
    ktw: int
    out_h: int
    out_w: int
    dtype: str = ""

    def as_gemm(self, batch: int) -> "GemmGeom":
        """K2 as the implicit GEMM: ``batch * out_h * out_w`` output
        positions x ``co`` channels x ``kth * ktw * cin``, in the
        geometry's dtype (int8: 64-deep k-tiles, int8's column cap)."""
        return GemmGeom(m=batch * self.out_h * self.out_w, n=self.co,
                        k=self.kth * self.ktw * self.cin, dtype=self.dtype)


SMS = 132                      # H100 SXM streaming multiprocessors


# ---------------------------------------------------------------------------
# K1's and K2's float and int8 branches: one implicit GEMM
# (csrc/sd_igemm.cuh), M conv positions x N output (phase) channels x K =
# KTh*KTw*Cin, on the tensor cores in 3xTF32 (bf16: one pass; int8: one
# s8 pass into int32).
# ---------------------------------------------------------------------------

GEMM_BM = 64                   # GEMM rows (conv positions) per block
GEMM_BK = 32                   # K per pipeline stage, f32 and bf16 (kBK)
GEMM_BK_INT8 = 64              # K per stage, int8: 64-byte rows, two
                               # m16n8k32 steps (the kernel's kBK8)
GEMM_BN = (16, 32, 64)         # GEMM columns per block
GEMM_BN_INT8 = 32              # int8's widest default column tile
GEMM_STAGES = 3                # cp.async ring depth (the kernel's kStages)
GEMM_THREADS = 128             # 4 warps
GEMM_MIN_SPLIT_TILES = 4       # least k-tiles one split sums
GEMM_WAVES = 4                 # blocks wanted per SM (split-K fills to it)
GRID_YZ_MAX = 65535            # grid.y (column tiles) and grid.z (splits)


@dataclass(frozen=True)
class GemmGeom:
    """What the GEMM launches: ``m = B * positions``, ``n`` output (phase)
    channels, ``k = KTh * KTw * Cin``, and the operand dtype (``""`` f32,
    ``"bf16"``, ``"int8"``)."""
    m: int
    n: int
    k: int
    dtype: str = ""

    @property
    def itemsize(self) -> int:
        return {"bf16": 2, "int8": 1}.get(self.dtype, 4)

    @property
    def bk(self) -> int:
        """K per k-tile: :data:`GEMM_BK_INT8` for int8, else
        :data:`GEMM_BK`."""
        return GEMM_BK_INT8 if self.dtype == "int8" else GEMM_BK


@dataclass(frozen=True)
class GemmPlan:
    """Tile of one GEMM launch: :data:`GEMM_BM` x ``bn`` outputs per
    block, :attr:`GemmGeom.bk` of the contraction per stage of the kernel's
    :data:`GEMM_STAGES`-deep cp.async ring, and the contraction cut into
    ``splits`` runs of whole k-tiles (split-K; the last may be shorter),
    summed in split order by a second kernel."""
    bn: int
    splits: int


def gemm_k_tiles(geom: GemmGeom) -> int:
    return -(-geom.k // geom.bk)


def gemm_split_tiles(geom: GemmGeom, plan: GemmPlan) -> int:
    """k-tiles per split (the kernel's ``kt_per_split``)."""
    return -(-gemm_k_tiles(geom) // plan.splits)


def gemm_grid(geom: GemmGeom, plan: GemmPlan):
    """``(row tiles, column tiles, splits)``: the GEMM kernel's grid."""
    return (-(-geom.m // GEMM_BM), -(-geom.n // plan.bn), plan.splits)


def gemm_smem_bytes(geom: GemmGeom, plan: GemmPlan) -> int:
    """Dynamic shared memory of one block: three ints per tile row (its
    sample's ``b*H`` and the input row / col of tap (0, 0)) and
    :data:`GEMM_STAGES` of the A tile ``(GEMM_BM, bk + pad)`` and the B
    tile ``(bk, bn + pad)``.  The row pads keep fragment loads free of
    bank conflicts: 4 words for f32 A, 8 bf16 elements for bf16 A
    (16-byte rows), 8 elements for float B; int8 rows take 16 bytes (A:
    80-byte rows, so ldmatrix's eight row reads hit distinct banks; both
    16-byte multiples, as its 16-byte copies need)."""
    if geom.dtype == "int8":
        a_row, b_row = GEMM_BK_INT8 + 16, plan.bn + 16
    else:
        a_row = GEMM_BK + (8 if geom.dtype == "bf16" else 4)
        b_row = plan.bn + 8
    stage = GEMM_BM * a_row + geom.bk * b_row
    return 3 * GEMM_BM * 4 + GEMM_STAGES * stage * geom.itemsize


def check_gemm_plan(geom: GemmGeom, plan: GemmPlan) -> None:
    """Raise ``ValueError`` for a plan the kernel does not take or that
    exceeds the grid's or shared memory's limits."""
    if plan.bn not in GEMM_BN or plan.splits < 1:
        raise ValueError(f"{plan}: the kernel takes bn in {GEMM_BN} and "
                         "splits >= 1")
    _, nt, sp = gemm_grid(geom, plan)
    if nt > GRID_YZ_MAX or sp > GRID_YZ_MAX:
        raise ValueError(f"{plan} needs {nt} column tiles x {sp} splits; "
                         f"the grid takes {GRID_YZ_MAX} of each")
    if gemm_smem_bytes(geom, plan) > SMEM_BUDGET:
        raise ValueError(f"{plan} needs {gemm_smem_bytes(geom, plan)} bytes "
                         f"of shared memory; a block has {SMEM_BUDGET}")


def gemm_plan(geom: GemmGeom, waves: int = GEMM_WAVES) -> GemmPlan:
    """Untuned default.  Column tile: the smallest of :data:`GEMM_BN`
    that holds every column, else the largest (for int8 at most
    :data:`GEMM_BN_INT8`: on DCGAN d1 and d2 at batch 16 the fastest
    int8 plans are 32 columns wide and a 64-column default took 1.16x
    and 1.32x their time, where the float GEMM's fastest are 64 wide;
    ``gemm_sweep.py`` on an H100).  Split-K where the output
    tiles are fewer than ``waves`` blocks per SM (:data:`GEMM_WAVES`: four
    4-warp blocks of a 3-stage ring fit an SM's shared memory, and the
    card hides its latencies only with several resident): ``want = waves
    * SMS // tiles`` splits of ``k_tiles // want`` k-tiles each (none
    empty, at least ``want`` of them), but none shorter than
    :data:`GEMM_MIN_SPLIT_TILES`."""
    widest = GEMM_BN_INT8 if geom.dtype == "int8" else GEMM_BN[-1]
    bn = next(b for b in GEMM_BN if b >= min(geom.n, widest))
    tiles = -(-geom.m // GEMM_BM) * -(-geom.n // bn)
    want = max(1, waves * SMS // tiles)
    k_tiles = gemm_k_tiles(geom)
    per = max(GEMM_MIN_SPLIT_TILES, k_tiles // want)
    return GemmPlan(bn=bn, splits=-(-k_tiles // per))


# ---------------------------------------------------------------------------
# K3, the filter grad, on the GEMM's tile shapes (csrc/sd_filter_grad.cu):
# rows (tap, input channel), columns the cotangent's channels, the
# contraction over every position of the cotangent.  Counterpart of the
# reference's ``tag="dw"`` ConvGeom key.
# ---------------------------------------------------------------------------

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

    def as_gemm(self) -> GemmGeom:
        """K3 as a GEMM: ``C[(tap, ci), co] = sum_m x_tap[m, ci] *
        dy1[m, co]``.  A block's :data:`GEMM_BM` rows are input channels
        of one tap, so each tap's Cin rounds up to whole row tiles; ``n``
        is ``nco``, ``k`` the ``m`` positions."""
        return GemmGeom(m=self.kth * self.ktw * -(-self.cin // GEMM_BM)
                        * GEMM_BM, n=self.nco, k=self.m)


DW_WAVES = 8                   # K3: blocks wanted per SM (split-K fills)


def filter_grad_plan(geom: FilterGradGeom) -> GemmPlan:
    """K3's default :class:`GemmPlan`: :func:`gemm_plan`'s rule on
    :meth:`FilterGradGeom.as_gemm` with :data:`DW_WAVES` blocks wanted
    per SM (the column tile holds the cotangent's channels; the positions
    are split until the blocks reach it).  K3's long contraction over
    positions gains from twice K1/K2's split count: its loads of each
    k-tile wait on a division per position and a transposed A, and more
    blocks in flight hide them (``gemm_sweep.py``)."""
    return gemm_plan(geom.as_gemm(), DW_WAVES)


# ---------------------------------------------------------------------------
# K4, the Winograd split conv (csrc/sd_wino.cu).  Counterpart of the
# reference's ``algo="wino"`` VMEM model (``vmem_plan_bytes``).
# ---------------------------------------------------------------------------

WINO_TC = (16, 32)             # K4: phase channels per block


@dataclass(frozen=True)
class WinoGeom:
    """What K4 launches: batch ``b``, the ``rows x cols`` conv positions
    per sample that the cropped output needs (K1's ``mh x mw``), ``cin``,
    ``nc = Cout*sh*sw`` phase channels, taps ``(kth, ktw)`` read as F(m,
    K_T) per dim (``m = 1`` for a 1-tap dim, else 2), and the operand
    dtype (``""`` f32, ``"bf16"``)."""
    b: int
    rows: int
    cols: int
    cin: int
    nc: int
    kth: int
    ktw: int
    dtype: str = ""

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

    @property
    def tiles(self):
        """Winograd tiles per sample, ``(rows / m_h, cols / m_w)`` rounded
        up."""
        return -(-self.rows // self.mh), -(-self.cols // self.mw)

    @property
    def slots(self) -> int:
        """Tiles one block holds: 32 (two m16 row fragments per point)
        when a warp owns one transform point (``alphas <= 16``), else 16
        (three points per warp)."""
        return 32 if self.alphas <= 16 else 16

    @property
    def chunk(self) -> int:
        """Input channels per step of the block's Cin loop: 16, or 8 on
        16 slots (the deeper transform domain's buffers are larger)."""
        return 16 if self.slots == 32 else 8

    @property
    def itemsize(self) -> int:
        return 2 if self.dtype == "bf16" else 4


@dataclass(frozen=True)
class WinoPlan:
    """K4's block: a band of ``nth x ntw`` Winograd tiles in each of
    ``nb`` consecutive samples (``nb * nth * ntw`` at most the block's
    :attr:`WinoGeom.slots`) x ``tc`` phase channels (16 or 32; 16 where a
    warp owns three points)."""
    nth: int
    ntw: int
    nb: int
    tc: int


def wino_grid(geom: WinoGeom, plan: WinoPlan):
    """``(channel tiles, bands per sample, sample groups)``: K4's grid."""
    nt_h, nt_w = geom.tiles
    return (-(-geom.nc // plan.tc),
            -(-nt_h // plan.nth) * -(-nt_w // plan.ntw),
            -(-geom.b // plan.nb))


def wino_smem_bytes(geom: WinoGeom, plan: WinoPlan) -> int:
    """Dynamic shared memory of one K4 block: each band position's 8-byte
    source offset, then two buffers each of the input band ``(nb,
    nth*m_h + K_Th - 1, ntw*m_w + K_Tw - 1)`` x :attr:`WinoGeom.chunk`
    channels (rows padded by 8 elements) and of the transformed-filter
    chunk ``(alphas, chunk, tc + 8)``, in the operand dtype, and of ``V``
    in f32 ``(alphas, slots, chunk + 4)``; after the Cin loop the memory
    past the offsets holds ``M`` in f32 ``(alphas, slots, tc + 4)`` for
    the epilogue's ``A^T M A``."""
    it, ck = geom.itemsize, geom.chunk
    positions = (plan.nb * (plan.nth * geom.mh + geom.kth - 1)
                 * (plan.ntw * geom.mw + geom.ktw - 1))
    off = -(-positions * 8 // 16) * 16
    band = positions * (ck + 8) * it
    u = geom.alphas * ck * (plan.tc + 8) * it
    v = geom.alphas * geom.slots * (ck + 4) * 4
    m = geom.alphas * geom.slots * (plan.tc + 4) * 4
    return off + max(2 * (band + u + v), m)


def check_wino_plan(geom: WinoGeom, plan: WinoPlan) -> None:
    """Raise ``ValueError`` for a plan the kernel does not take or that
    exceeds the block's tile slots, the grid's or shared memory's
    limits."""
    tcs = WINO_TC if geom.slots == 32 else WINO_TC[:1]
    if (plan.tc not in tcs or min(plan.nth, plan.ntw, plan.nb) < 1
            or plan.nb * plan.nth * plan.ntw > geom.slots):
        raise ValueError(f"{plan}: the kernel takes tc in {tcs} and at "
                         f"most {geom.slots} tiles (nb x nth x ntw) per "
                         f"block for {geom.alphas} transform points")
    _, bands, groups = wino_grid(geom, plan)
    if bands > GRID_YZ_MAX or groups > GRID_YZ_MAX:
        raise ValueError(f"{plan} needs {bands} bands x {groups} sample "
                         f"groups; the grid takes {GRID_YZ_MAX} of each")
    if wino_smem_bytes(geom, plan) > SMEM_BUDGET:
        raise ValueError(f"{plan} needs {wino_smem_bytes(geom, plan)} bytes "
                         f"of shared memory; a block has {SMEM_BUDGET}")


def wino_plan(geom: WinoGeom) -> WinoPlan:
    """Untuned default for K4.  Channel tile: 32, or 16 where the layer
    has no more phase channels or a warp owns three points.  Tiles: a
    whole sample's tiles, and as many samples as the block's slots hold,
    where they fit; else a band of up to 4 tile rows, as wide as the
    slots allow; fewer samples where their bands overflow shared
    memory."""
    slots = geom.slots
    tc = WINO_TC[-1] if geom.nc > WINO_TC[0] and slots == 32 else WINO_TC[0]
    nt_h, nt_w = geom.tiles
    if nt_h * nt_w <= slots:
        plan = WinoPlan(nth=nt_h, ntw=nt_w,
                        nb=max(1, min(geom.b, slots // (nt_h * nt_w))),
                        tc=tc)
    else:
        ntw = min(nt_w, slots // min(nt_h, 4))
        plan = WinoPlan(nth=min(nt_h, slots // ntw), ntw=ntw, nb=1, tc=tc)
    while plan.nb > 1 and wino_smem_bytes(geom, plan) > SMEM_BUDGET:
        plan = WinoPlan(plan.nth, plan.ntw, plan.nb // 2, plan.tc)
    check_wino_plan(geom, plan)
    return plan


# ---------------------------------------------------------------------------
# Measured tiles: the plan cache of one deconv layer's K1 or K4 launch.
# Counterpart of the reference's ConvGeom key, candidate pool, tune,
# measured_ms and best_algo (src/repro/kernels/autotune.py:86-202,368-580).
# ---------------------------------------------------------------------------

Plan = Union[GemmPlan, WinoPlan]
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)   # split counts the GEMM pools offer


@dataclass(frozen=True)
class DeconvGeom:
    """One deconv layer's fused launch at a batch: the counterpart of the
    reference's ``ConvGeom`` (``src/repro/kernels/autotune.py:86``), its
    fields and :meth:`key` the same.  ``h``/``w`` are the ``P_I``-padded
    input, ``cout`` counts deconv output channels, ``kt``/``s`` the taps
    and interleave (``ktw``/``sw`` 0: square); ``dtype`` ``""`` or
    ``"int8"``, ``algo`` ``""`` (K1) or ``"wino"`` (K4), ``qout`` a
    chained int8-out launch, ``shards`` the Cout shard count, ``tag`` a
    launch role.  ``out_h``/``out_w`` and ``crop_h``/``crop_w`` (the final
    output and the low-side crop, outside the key) give the launch
    (:meth:`launch`)."""
    b: int
    h: int
    w: int
    cin: int
    cout: int
    kt: int
    s: int
    ktw: int = 0
    sw: int = 0
    tag: str = ""
    out_h: int = 0
    out_w: int = 0
    crop_h: int = -1
    crop_w: int = -1
    dtype: str = ""
    algo: str = ""
    qout: bool = False
    shards: int = 1

    def key(self) -> str:
        """The reference's ``ConvGeom.key()`` string."""
        base = (f"b{self.b}_h{self.h}w{self.w}_ci{self.cin}"
                f"_co{self.cout}_kt{self.kt}_s{self.s}")
        if self.ktw or self.sw:
            base += f"_ktw{self.ktw or self.kt}_sw{self.sw or self.s}"
        if self.dtype:
            base += f"_{self.dtype}"
        if self.algo:
            base += f"_{self.algo}"
        if self.qout:
            base += "_q8out"
        if self.shards > 1:
            base += f"_mp{self.shards}"
        if self.tag:
            base += f"_{self.tag}"
        return base

    @classmethod
    def from_deconv(cls, b: int, h: int, w: int, cin: int, cout: int,
                    k: int, s: int, padding=None, output_padding: int = 0,
                    dtype: str = "") -> "DeconvGeom":
        """The geometry of a square ``k``/``s`` deconv layer on an ``h x
        w x cin`` input (reference ``ConvGeom.from_deconv``): the input
        padded by ``P_I = K_T - 1`` per side; with ``padding`` known, the
        final output and the low-side crop ``P_K + pad_lo`` too."""
        kt = -(-k // s)
        pi = kt - 1
        geom = cls(b, h + 2 * pi, w + 2 * pi, cin, cout, kt, s, dtype=dtype)
        if padding is None:
            return geom
        from repro_torch.core.deconv import _pads_nd, deconv_output_shape
        pads = _pads_nd(padding, 2)
        oh, ow = deconv_output_shape((h, w), k, s, padding, output_padding)
        pk = s * kt - k
        return replace(geom, out_h=oh, out_w=ow, crop_h=pk + pads[0][0],
                       crop_w=pk + pads[1][0])

    def launch(self) -> Union[GemmGeom, WinoGeom]:
        """What the kernel is handed (``kernels.sd_conv.gemm_launch`` /
        ``kernels.winograd.wino_launch``): ``rows x cols`` conv positions
        per sample, ``ceil((out + crop % s) / s)`` per dim, then K1's GEMM
        (``m = b * rows * cols``, ``n = cout * s_h * s_w``, ``k = K_T^2 *
        cin``) or K4's Winograd geometry.  Needs the crop
        (:meth:`from_deconv` with ``padding``)."""
        if self.crop_h < 0 or self.crop_w < 0:
            raise ValueError(f"{self.key()}: the launch needs the output "
                             "and crop (from_deconv with padding)")
        ktw, sw = self.ktw or self.kt, self.sw or self.s
        rows = -(-(self.out_h + self.crop_h % self.s) // self.s)
        cols = -(-(self.out_w + self.crop_w % sw) // sw)
        nc = self.cout * self.s * sw
        if self.algo == "wino":
            return WinoGeom(b=self.b, rows=rows, cols=cols, cin=self.cin,
                            nc=nc, kth=self.kt, ktw=ktw)
        return GemmGeom(m=self.b * rows * cols, n=nc,
                        k=self.kt * ktw * self.cin,
                        dtype="int8" if self.dtype == "int8" else "")


def gemm_plans(geom: GemmGeom, splits=SPLITS) -> List[GemmPlan]:
    """Every ``GemmPlan(bn, splits)`` with ``bn`` in :data:`GEMM_BN` and a
    split count of ``splits`` that leaves each split a k-tile."""
    return [GemmPlan(bn, sp) for bn in GEMM_BN for sp in splits
            if sp <= gemm_k_tiles(geom)]


def wino_plans(geom: WinoGeom) -> List[WinoPlan]:
    """K4's pool: whole samples' tiles in 1, 2 or 4 samples where the
    block's slots hold them, and bands of 4 x 8, 2 x 8, 4 x 4, 8 x 4 and
    2 x 16 tiles, each with 16 and 32 phase channels, kept where
    :func:`check_wino_plan` takes them."""
    nt_h, nt_w = geom.tiles
    shapes = {(nt_h, nt_w, nb) for nb in (1, 2, 4)
              if nb * nt_h * nt_w <= geom.slots}
    shapes |= {(min(nt_h, h), min(nt_w, w), 1)
               for h, w in ((4, 8), (2, 8), (4, 4), (8, 4), (2, 16))}
    plans = []
    for (h, w, nb) in sorted(shapes):
        for tc in WINO_TC:
            plan = WinoPlan(nth=h, ntw=w, nb=nb, tc=tc)
            try:
                check_wino_plan(geom, plan)
            except ValueError:
                continue
            plans.append(plan)
    return plans


def _blocks(launch, plan: Plan) -> int:
    grid = (wino_grid if isinstance(launch, WinoGeom) else gemm_grid)(
        launch, plan)
    return math.prod(grid)


def default_plan(geom: DeconvGeom) -> Plan:
    """The plan the kernel picks at call time for ``geom``'s launch:
    :func:`wino_plan` or :func:`gemm_plan`."""
    launch = geom.launch()
    return (wino_plan(launch) if isinstance(launch, WinoGeom)
            else gemm_plan(launch))


def check_plan(launch, plan: Plan) -> None:
    """Raise ``ValueError`` unless the kernel of ``launch`` takes
    ``plan``: a :class:`WinoPlan` for a :class:`WinoGeom` that
    :func:`check_wino_plan` takes, a :class:`GemmPlan` for a
    :class:`GemmGeom` that :func:`check_gemm_plan` takes and whose splits
    each keep a k-tile."""
    if isinstance(launch, WinoGeom):
        if not isinstance(plan, WinoPlan):
            raise ValueError(f"K4 takes a WinoPlan, not {plan!r}")
        check_wino_plan(launch, plan)
        return
    if not isinstance(plan, GemmPlan):
        raise ValueError(f"the GEMM takes a GemmPlan, not {plan!r}")
    check_gemm_plan(launch, plan)
    if plan.splits > gemm_k_tiles(launch):
        raise ValueError(f"{plan}: {gemm_k_tiles(launch)} k-tiles cannot "
                         f"make {plan.splits} splits")


MAX_CANDIDATES = 8             # tiles timed per geometry (the reference's)


def candidate_plans(geom: DeconvGeom) -> List[Plan]:
    """The tiles timed for ``geom`` (reference ``candidate_plans``): the
    kernel's default first, then the pool (:func:`gemm_plans` with the
    default's split count added, or :func:`wino_plans`) ranked by how
    near their block count comes to the default's, at most
    :data:`MAX_CANDIDATES` in all."""
    launch = geom.launch()
    base = default_plan(geom)
    if isinstance(launch, WinoGeom):
        pool = wino_plans(launch)
    else:
        pool = gemm_plans(launch, sorted(set(SPLITS) | {base.splits}))
    want = _blocks(launch, base)
    rest = []
    for p in pool:
        if p == base or p in rest:
            continue
        try:
            check_plan(launch, p)
        except ValueError:
            continue
        rest.append(p)
    rest.sort(key=lambda p: abs(math.log(_blocks(launch, p) / want)))
    return ([base] + rest)[:MAX_CANDIDATES]


# ---------------------------------------------------------------------------
# Cache persistence
# ---------------------------------------------------------------------------

_ENV_CACHE = "REPRO_TORCH_SD_PLAN_CACHE"
_DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                              "repro_torch", "sd_plans.json")

# In-memory mirror of each cache file, so a bind never re-reads disk.
_MEM: Dict[str, Dict[str, dict]] = {}


def cache_path(path: Optional[str] = None) -> str:
    return path or os.environ.get(_ENV_CACHE, _DEFAULT_CACHE)


def load_cache(path: Optional[str] = None) -> Dict[str, dict]:
    p = cache_path(path)
    if p not in _MEM:
        data = read_json(p)
        plans = data.get("plans") if isinstance(data, dict) else None
        _MEM[p] = dict(plans) if isinstance(plans, dict) else {}
    return _MEM[p]


def save_cache(plans: Dict[str, dict], path: Optional[str] = None) -> str:
    """Write the cache atomically (``core.iohelpers.atomic_write_json``:
    readers see a whole document, the last writer wins) and mirror it."""
    p = cache_path(path)
    atomic_write_json(p, {"version": 1, "plans": plans})
    _MEM[p] = dict(plans)
    return p


def backend_tag(device=None) -> str:
    """The device an entry was measured on: the card's name
    (``torch.cuda.get_device_name``), or ``"cpu"``.  ``None`` is the card,
    as everywhere in the port."""
    import torch
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    return "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)


def _entry(entry: Optional[dict], tag: str) -> Optional[dict]:
    """``entry`` if it is a measured one from the device ``tag``."""
    if (isinstance(entry, dict) and entry.get("source") == "measured"
            and entry.get("backend") == tag):
        return entry
    return None


def _plan_from_entry(geom: DeconvGeom, entry: dict) -> Optional[Plan]:
    try:
        if geom.algo == "wino":
            return WinoPlan(nth=int(entry["nth"]), ntw=int(entry["ntw"]),
                            nb=int(entry["nb"]), tc=int(entry["tc"]))
        return GemmPlan(bn=int(entry["bn"]), splits=int(entry["splits"]))
    except (KeyError, TypeError, ValueError):
        return None


def get_plan(geom: DeconvGeom, path: Optional[str] = None,
             device=None) -> Optional[Plan]:
    """The measured tile of ``geom`` if the cache holds one measured on
    ``device`` and the kernel takes it for the launch
    (:meth:`DeconvGeom.launch`, the geometry the wrapper computes), else
    ``None``: the kernel's own default at call time (:func:`gemm_plan`,
    :func:`wino_plan` on the actual launch), which is what an untuned
    engine launches."""
    entry = _entry(load_cache(path).get(geom.key()), backend_tag(device))
    if entry is None:
        return None
    plan = _plan_from_entry(geom, entry)
    if plan is None:
        return None
    try:
        check_plan(geom.launch(), plan)
    except ValueError:
        return None
    return plan


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

def measure(fn: Callable[[], object], iters: int = 3, warmup: int = 1,
            device=None) -> float:
    """Least ms per call of ``fn`` over ``iters`` readings.  On the card,
    device time (:func:`repro_torch.kernels.timing.ahead_ms`: the calls
    queued behind ``torch.cuda._sleep``, so the host's time per call,
    which exceeds a DCGAN launch's device time, does not hide the tile's);
    on the CPU, the wall clock of one call (which blocks there), as the
    reference measures.  Least, not median: load only adds time."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        from repro_torch.kernels.timing import ahead_ms
        return min(ahead_ms(fn) for _ in range(iters))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def tune(geom: DeconvGeom, runner: Callable[[Plan], float],
         path: Optional[str] = None, device=None) -> Optional[Plan]:
    """Time ``runner(plan) -> ms`` over :func:`candidate_plans` in two
    passes, the second in reverse order (slow drift of the machine then
    biases both ends of the list alike), keep each plan's least time,
    persist the fastest and return it (reference ``tune``).  A measured
    entry of this device short-circuits.  A candidate whose launch the
    wrapper's plan checks refuse (``ValueError``) is skipped; any other
    error, a failed launch included, propagates.  If every candidate is
    refused, nothing is persisted and ``None`` is returned: the geometry
    is not tuned."""
    tag = backend_tag(device)
    plans = dict(load_cache(path))
    key = geom.key()
    entry = _entry(plans.get(key), tag)
    plan = None if entry is None else _plan_from_entry(geom, entry)
    if plan is not None:
        return plan
    pool = candidate_plans(geom)
    best: Dict[Plan, float] = {}
    for order in (pool, pool[::-1]):
        for plan in order:
            try:
                ms = runner(plan)
            except ValueError:
                continue
            best[plan] = min(ms, best.get(plan, float("inf")))
    if not best:
        return None
    best_plan, best_ms = min(best.items(), key=lambda kv: kv[1])
    plans[key] = {**asdict(best_plan), "ms": best_ms, "source": "measured",
                  "backend": tag}
    save_cache(plans, path)
    return best_plan


def measured_ms(geom: DeconvGeom, path: Optional[str] = None,
                device=None) -> Optional[float]:
    """The cached ms of ``geom``'s winning tile measured on ``device``, or
    ``None``."""
    entry = _entry(load_cache(path).get(geom.key()), backend_tag(device))
    if entry is None or entry.get("ms") is None:
        return None
    return float(entry["ms"])


def best_algo(geom: DeconvGeom, path: Optional[str] = None,
              device=None) -> str:
    """``"wino"`` iff both the direct (``algo=""``) and the Winograd
    (``algo="wino"``) variant of ``geom`` are measured on ``device`` and
    the Winograd one is faster; ``""`` otherwise, so an untuned layer
    never switches algorithm (reference ``best_algo``)."""
    direct = measured_ms(replace(geom, algo=""), path, device)
    wino = measured_ms(replace(geom, algo="wino"), path, device)
    if direct is not None and wino is not None and wino < direct:
        return "wino"
    return ""

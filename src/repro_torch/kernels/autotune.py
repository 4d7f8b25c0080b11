"""Tile plans for the port's kernels on Hopper: the stride-1 convs on
the shared implicit-GEMM mainloop (K1's float and int8 branches and K2
in f32 and int8, :class:`GemmPlan`, :func:`gemm_plan`), the filter grad
on the same tile shapes (K3, :func:`filter_grad_plan`) and the Winograd
split conv (K4, :class:`WinoPlan`, :func:`wino_plan`).

The JAX package sizes its Pallas tiles against an 8 MiB VMEM model; on
the H100 the limit is the shared memory one block can use (227 KB) and,
in practice, filling the 132 SMs.  Every plan here is a heuristic from
the launch geometry alone; measuring and caching tiles comes later.

A geometry carries its operand dtype (``""`` f32, ``"bf16"``,
``"int8"``), so the float and the int8 launch of one layer are distinct
geometries with their own k-tile depth and column cap.
"""

from __future__ import annotations

from dataclasses import dataclass

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

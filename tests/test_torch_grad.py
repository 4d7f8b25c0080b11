"""The port's split-deconv backward against the JAX reference.

Same numpy inputs through ``repro.sd.grad`` (on an ``xla`` plan: the
Pallas K2/K3 need an API this jax lacks, so the reference side is its
lax formulation) and ``repro_torch.sd.grad``, on a ``torch`` plan and on
a ``fused`` plan, whose kernels run their plain versions on CPU tensors:

* ``conv_transpose_vjp`` on all 22 paper deconv layers and the odd
  geometries (``op > pad_hi``, asymmetric pads, 1-D and 3-D), at the
  reference's gradient tolerance ``rtol=atol=1e-4``;
* K2's and K3's plain versions (``sd_conv_ref``, ``sd_filter_grad_ref``)
  against ``_conv_valid_input_grad`` (with the pad^T crop) and
  ``_conv_valid_filter_grad``, at 1e-5;
* ``torch.autograd.gradcheck`` of ``sd.conv_transpose`` in float64;
* the tiles the kernels are handed (``gemm_plan``, ``filter_grad_plan``)
  on every backward geometry of the paper layers, and the kernels'
  blocking restated in numpy on ragged tiles: K2's implicit GEMM (the
  halo read as zero, every ``(m, n, k)`` product taken once over the
  tiles and splits, the splits summed in order); K3's GEMM over the
  cotangent's positions (64-channel row tiles of one tap, each position
  and channel pair taken once, each k-tile's product in 3xTF32 promoted
  into an f32 sum, the splits summed in order, its position divisions by
  multiply-high and shift) against ``sd_filter_grad_ref`` and, through
  the fused backward, against the reference's ``repro.sd.grad``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sd as jsd
from repro.core.accounting import BENCHMARKS
from repro.core.deconv import same_deconv_pads
from repro.sd import grad as jgrad
import repro_torch.sd as tsd
import repro_torch.kernels.sd_conv as K
from repro_torch.core.deconv import space_to_depth
from repro_torch.kernels import autotune as A
from repro_torch.kernels import ops
from repro_torch.sd import grad as tgrad
from _torch_igemm import gather_a, mma3, promote, split_k_product

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
PAPER_LAYERS = [(net, l) for net, fn in BENCHMARKS.items()
                for l in fn().deconv_layers()]
PAPER_IDS = [f"{net}/{l.name}" for net, l in PAPER_LAYERS]

# (x shape, w shape, stride, padding, output_padding)
ODD = [
    ((2, 5, 6, 3), (4, 4, 3, 2), 2, 0, 1),              # op > pad_hi
    ((1, 5, 6, 3), (4, 4, 3, 2), 2, 1, (1, 0)),         # per-dim op
    ((1, 6, 7, 3), (5, 5, 3, 2), 2, ((1, 3), (0, 2)), 0),   # asymmetric
    ((2, 13, 11, 40), (5, 5, 40, 24), 2, 2, 1),
    ((1, 6, 7, 3), (5, 5, 3, 2), 1, 2, 0),              # stride 1
    ((2, 9, 3), (5, 3, 2), 2, 1, 0),                    # 1-D
    ((1, 10, 3), (5, 3, 2), 3, 1, 2),                   # 1-D, op > pad_hi
    ((1, 3, 4, 5, 2), (3, 3, 3, 2, 3), 2, 1, 0),        # 3-D
]
ODD_IDS = [f"{c[0]}-{c[1]}-s{c[2]}" for c in ODD]


def _case(sx, sw, s, pad, op, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*sx).astype(np.float32)
    w = (rng.randn(*sw) / np.sqrt(np.prod(sw[:-1]))).astype(np.float32)
    jp = jsd.plan(w.shape, s, pad, backend="xla", output_padding=op)
    space = jp.out_shape(sx[1:-1])
    # Cotangent scaled so that the filter grad, a sum over every output
    # position, stays O(1) and the f32 gate is about rounding, not size.
    dy = (rng.randn(sx[0], *space, sw[-1])
          / np.sqrt(np.prod(space))).astype(np.float32)
    return x, w, dy, jp


def _check_vjp(sx, sw, s, pad, op, backend):
    x, w, dy, jp = _case(sx, sw, s, pad, op)
    jdx, jdw = jgrad.conv_transpose_vjp(jp, jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(dy))
    tp = tsd.plan(w.shape, s, pad, backend=backend, output_padding=op)
    dx, dw = tgrad.conv_transpose_vjp(tp, torch.from_numpy(x),
                                      torch.from_numpy(w),
                                      torch.from_numpy(dy))
    assert dx.shape == x.shape and dw.shape == w.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **GRAD_TOL)


@pytest.mark.parametrize("backend", ["torch", "fused"])
@pytest.mark.parametrize("net,layer", PAPER_LAYERS, ids=PAPER_IDS)
def test_paper_layer_vjp_matches_reference(net, layer, backend):
    _check_vjp((1, *layer.in_hw, layer.cin),
               (layer.k, layer.k, layer.cin, layer.cout), layer.s,
               same_deconv_pads(layer.k, layer.s), 0, backend)


@pytest.mark.parametrize("case", ODD, ids=ODD_IDS)
def test_odd_geometry_vjp_matches_reference(case):
    for backend in ("torch", "fused") if len(case[0]) == 4 else ("torch",):
        _check_vjp(*case, backend)


@pytest.mark.parametrize("case", ODD[:4] + [
    ((2, 8, 8, 256), (5, 5, 256, 128), 2, ((1, 2), (1, 2)), 0),   # dcgan d1
    ((2, 32, 32, 64), (5, 5, 64, 3), 2, ((1, 2), (1, 2)), 0)])    # dcgan d3
def test_kernel_plain_versions_match_reference_formulations(case):
    """K2's plain version, given what ``sd_input_grad_fused`` hands the
    kernel (rot180 + channel-swapped filters, pad K_T - 1, window P_I),
    equals the reference's FULL conv with the pad^T crop; K3's equals
    the reference's exchanged VALID conv over the padded input."""
    x, w, dy, jp = _case(*case, seed=1)
    kt, pi = jp.kt, jp.pi
    tp = tsd.plan(w.shape, case[2], case[3], backend="torch",
                  output_padding=case[4])
    dy1 = tgrad.split_cotangent(tp, torch.from_numpy(dy))
    ws = tsd.split_weights(tp, torch.from_numpy(w))
    jdxp = np.asarray(jgrad._conv_valid_input_grad(jnp.asarray(dy1.numpy()),
                                                   jnp.asarray(ws.numpy())))
    space = x.shape[1:3]
    ref_dx = jdxp[:, pi[0]:pi[0] + space[0], pi[1]:pi[1] + space[1]]
    w_t = ws.flip(0, 1).transpose(-1, -2).contiguous()
    dx = K.sd_conv_ref(dy1, w_t, pad=tuple((k - 1, k - 1) for k in kt),
                       out_start=pi, out_size=space)
    np.testing.assert_allclose(dx.numpy(), ref_dx, **TOL)
    xp = np.pad(x, [(0, 0), (pi[0], pi[0]), (pi[1], pi[1]), (0, 0)])
    ref_dw = np.asarray(jgrad._conv_valid_filter_grad(
        jnp.asarray(xp), jnp.asarray(dy1.numpy())))
    dws = K.sd_filter_grad_ref(torch.from_numpy(x), dy1, kt,
                               pad=tuple((p, p) for p in pi))
    np.testing.assert_allclose(dws.numpy(), ref_dw, **TOL)
    # The ops-level entry points (kernel wrappers on a CPU tensor) are
    # the same functions; no kernel launch is counted on the CPU.
    before = (K.SD_CONV_LAUNCHES, K.SD_FILTER_GRAD_LAUNCHES)
    np.testing.assert_array_equal(
        ops.sd_input_grad_fused(dy1, ws, pi, space).numpy(), dx.numpy())
    np.testing.assert_array_equal(
        ops.sd_filter_grad_fused(torch.from_numpy(x), dy1, kt, pi).numpy(),
        dws.numpy())
    assert (K.SD_CONV_LAUNCHES, K.SD_FILTER_GRAD_LAUNCHES) == before


def test_space_to_depth_matches_reference_and_inverts():
    from repro.core.deconv import space_to_depth as j_s2d
    from repro_torch.core.deconv import depth_to_space
    for shape, s in [((2, 6, 8, 3), 2), ((1, 6, 9, 4), (3, 3)),
                     ((2, 12, 5), 4), ((1, 4, 6, 2, 3), (2, 3, 1))]:
        x = np.random.RandomState(0).randn(*shape).astype(np.float32)
        out = space_to_depth(torch.from_numpy(x), s)
        np.testing.assert_array_equal(out.numpy(),
                                      np.asarray(j_s2d(jnp.asarray(x), s)))
        np.testing.assert_array_equal(depth_to_space(out, s).numpy(), x)


@pytest.mark.parametrize("pad,op", [(((1, 2), (1, 2)), 0), (0, 1),
                                    (((0, 1), (2, 0)), (1, 0))])
def test_conv_transpose_gradcheck_float64(pad, op):
    p = tsd.plan((5, 4, 2, 3), (2, 3), pad, backend="torch",
                 output_padding=op)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 4, 2, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.randn(5, 4, 2, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    b = torch.randn(3, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, w, b: tsd.conv_transpose(p, x, w, b), (x, w, b))


def test_conv_transpose_contract():
    p = tsd.plan((4, 4, 3, 2), 2, 1, backend="torch")
    w = torch.randn(4, 4, 3, 2)
    with pytest.raises(ValueError, match="geometry-only"):
        tsd.conv_transpose(p.bind(w), torch.zeros(1, 3, 3, 3), w)
    # Forward equals the bound plan's execute (no epilogue), on both
    # backends, and the fused backend's gradients equal the torch one's.
    x = torch.randn(2, 5, 6, 3, requires_grad=True)
    wf = w.clone().requires_grad_(True)
    b = torch.randn(2, requires_grad=True)
    outs = []
    for backend in ("torch", "fused"):
        q = tsd.plan(w.shape, 2, 1, backend=backend)
        y = tsd.conv_transpose(q, x, wf, b)
        torch.testing.assert_close(
            y, tsd.execute(q.bind(w.detach(), bias=b.detach()), x.detach()),
            rtol=1e-6, atol=1e-6)
        outs.append(torch.autograd.grad((y * y).sum(), (x, wf, b)))
    for a, c in zip(*outs):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_check_their_operands():
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="window"):
        K.sd_conv(x, torch.zeros(3, 3, 3, 2), out_start=(1, 0),
                  out_size=(2, 2))
    with pytest.raises(ValueError, match="shapes"):
        K.sd_conv(x, torch.zeros(3, 3, 4, 2))
    with pytest.raises(ValueError, match="dy1"):
        K.sd_filter_grad(x, torch.zeros(1, 3, 3, 2), (3, 3),
                         pad=((1, 1), (1, 1)))
    assert tuple(K.sd_filter_grad(x, torch.zeros(1, 4, 4, 2), (3, 3),
                                  pad=((1, 1), (1, 1))).shape) == (3, 3, 3, 2)


def _backward_geometries():
    for net, layer in PAPER_LAYERS:
        p = tsd.plan((layer.k, layer.k, layer.cin, layer.cout), layer.s,
                     same_deconv_pads(layer.k, layer.s), backend="torch")
        kt, pi = p.kt, p.pi
        o1 = tuple(n + 2 * q - k + 1 for n, q, k in zip(layer.in_hw, pi, kt))
        yield f"{net}/{layer.name}", layer, kt, pi, o1


@pytest.mark.parametrize("batch", [4, 16])
def test_backward_tiles_fit_the_kernels(batch):
    """Every tile the heuristics give the paper layers' backward at the
    batches chip_smoke runs fits the kernels: K2's GEMM plan is one the
    kernel takes, within shared memory and the grid's limits, with at
    least one block per SM wherever the output tiles and the contraction
    allow it; so is K3's, on its GEMM of whole 64-channel row tiles per
    tap x the cotangent's channels x the positions."""
    for name, layer, kt, pi, o1 in _backward_geometries():
        nco = layer.cout * layer.s ** 2
        cg = A.ConvGeom(h=o1[0], w=o1[1], cin=nco, co=layer.cin,
                        kth=kt[0], ktw=kt[1], out_h=layer.in_hw[0],
                        out_w=layer.in_hw[1])
        gg = cg.as_gemm(batch)
        cp = A.gemm_plan(gg)
        A.check_gemm_plan(gg, cp)
        assert cp.bn >= min(layer.cin, A.GEMM_BN[-1]), name
        mt, nt, sp = A.gemm_grid(gg, cp)
        assert mt * nt * sp >= A.SMS or A.gemm_split_tiles(
            gg, cp) <= A.GEMM_MIN_SPLIT_TILES, name
        assert (sp - 1) * A.gemm_split_tiles(gg, cp) < A.gemm_k_tiles(gg)
        g = A.FilterGradGeom(b=batch, h=layer.in_hw[0], w=layer.in_hw[1],
                             cin=layer.cin, nco=nco, kth=kt[0], ktw=kt[1],
                             o1h=o1[0], o1w=o1[1])
        fg, fp = g.as_gemm(), A.filter_grad_plan(g)
        A.check_gemm_plan(fg, fp)
        assert fg.m % A.GEMM_BM == 0 and fg.k == g.m, name
        assert kt[0] * kt[1] * layer.cin <= fg.m < kt[0] * kt[1] * (
            layer.cin + A.GEMM_BM)
        assert fp.bn >= min(nco, A.GEMM_BN[-1]), name
        mt, nt, sp = A.gemm_grid(fg, fp)
        assert mt * nt * sp >= A.SMS or A.gemm_split_tiles(
            fg, fp) <= A.GEMM_MIN_SPLIT_TILES, name
        assert (sp - 1) * A.gemm_split_tiles(fg, fp) < A.gemm_k_tiles(fg)


def test_split_cotangent_is_the_adjoint_of_the_forward_layout():
    """<crop(d2s(y1)), dy> == <y1, split_cotangent(dy)> for a random y1:
    crop^T and d2s^T are the adjoints of the forward's layout steps."""
    from repro_torch.core.deconv import crop_interleaved, depth_to_space
    for sx, sw, s, pad, op in ODD[:5]:
        p = tsd.plan(sw, s, pad, backend="torch", output_padding=op)
        o1 = tuple(n + 2 * q - k + 1
                   for n, q, k in zip(sx[1:-1], p.pi, p.kt))
        g = torch.Generator().manual_seed(2)
        y1 = torch.randn(sx[0], *o1, p.phases * sw[-1], generator=g,
                         dtype=torch.float64)
        y = crop_interleaved(depth_to_space(y1, p.stride), p.pk, p.padding,
                             p.out_shape(sx[1:-1]))
        dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
        dy1 = tgrad.split_cotangent(p, dy)
        assert dy1.shape == y1.shape
        torch.testing.assert_close((y * dy).sum(), (y1 * dy1).sum())
        assert torch.equal(space_to_depth(depth_to_space(y1, p.stride),
                                          p.stride), y1)


# ---------------------------------------------------------------------------
# The kernels' blocking, restated in numpy from the CUDA sources: every
# output element written exactly once (per chunk for K3), with the
# plain version's value.
# ---------------------------------------------------------------------------

def _k2_restated(x, w, pad, out_start, out_size, plan):
    """sd_conv.cu on sd_igemm.cuh: the GEMM over ``B * OH * OW`` output
    positions whose position (0, 0) reads input ``out_start - plo``, the
    filters as a K x Co matrix, the splits summed in order; the epilogue
    writes C[m, n] as y (B, OH, OW, Co)."""
    b = x.shape[0]
    kth, ktw, cin, co = w.shape
    oh, ow = out_size
    a = gather_a(x, (kth, ktw), out_start[0] - pad[0][0],
                 out_start[1] - pad[1][0], oh, ow)
    c, _ = split_k_product(a, w.reshape(kth * ktw * cin, co), plan)
    return c.reshape(b, oh, ow, co)


def _k3_restated(x, dy1, kt, pad, plan):
    """sd_filter_grad.cu: ``C[(tap, ci), co] = sum_m x_tap[m, ci] *
    dy1[m, co]``; a block takes GEMM_BM input channels of one tap x
    ``bn`` channels x the k-tiles (GEMM_BK positions) of its split, each
    k-tile's product in 3xTF32 promoted into an f32 sum; the splits'
    slabs are summed in split order.  Returns (dws, hits): hits counts
    the blocks and k-tiles that take each (tap, ci, co, position)."""
    b, h, wd, cin = x.shape
    _, o1h, o1w, nco = dy1.shape
    m = b * o1h * o1w
    k_tiles = -(-m // A.GEMM_BK)
    per = -(-k_tiles // plan.splits)
    part = np.zeros((plan.splits, *kt, cin, nco), np.float32)
    hits = np.zeros((*kt, cin, nco, m), np.int64)
    mm = np.arange(m)
    bb, rem = mm // (o1h * o1w), mm % (o1h * o1w)
    vv, uu = rem // o1w, rem % o1w
    dyf = dy1.reshape(m, nco).astype(np.float32)
    for kh in range(kt[0]):
        for kw in range(kt[1]):
            xr, xc = vv + kh - pad[0][0], uu + kw - pad[1][0]
            ok = (xr >= 0) & (xr < h) & (xc >= 0) & (xc < wd)
            a = np.zeros((m, cin), np.float32)      # the halo reads as 0
            a[ok] = x[bb[ok], xr[ok], xc[ok]]
            for ci0 in range(0, cin, A.GEMM_BM):
                ci = slice(ci0, min(cin, ci0 + A.GEMM_BM))
                for co0 in range(0, nco, plan.bn):
                    co = slice(co0, min(nco, co0 + plan.bn))
                    for z in range(plan.splits):
                        acc = np.zeros((ci.stop - ci.start,
                                        co.stop - co.start), np.float32)
                        for t in range(z * per, min(k_tiles, (z + 1) * per)):
                            ms = slice(t * A.GEMM_BK,
                                       min(m, (t + 1) * A.GEMM_BK))
                            acc = promote(acc, mma3(a[ms, ci].T,
                                                    dyf[ms, co]))
                            hits[kh, kw, ci, co, ms] += 1
                        part[z, kh, kw, ci, co] = acc
    dws = part[0]
    for z in range(1, plan.splits):
        dws = dws + part[z]
    return dws, hits


def _fast_div(n, d):
    """sd_filter_grad.cu's ``FastDiv``: ``n / d`` for ``0 <= n < 2^31``
    as ``umulhi(n, mul) >> shr``, ``mul = ceil(2^p / d)``, ``p = 31 +
    ceil(log2 d)``."""
    if d == 1:
        return n
    p = 31 + (d - 1).bit_length()
    mul = -(-(1 << p) // d)
    assert mul < 2 ** 32
    return ((n * mul) >> 32) >> (p - 32)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 10, 34, 100, 324, 1156,
                               2 ** 16 + 1, 2 ** 30 + 3])
def test_k3_position_division_restated(d):
    """The multiply-high division K3 uses for each position's (b, v, u)
    is exact over every non-negative int32 numerator."""
    rng = np.random.RandomState(d % 1000)
    ns = set(rng.randint(0, 2 ** 31, 2000).tolist())
    ns |= {0, 1, d - 1, d, d + 1, 2 ** 31 - 1, 2 ** 31 - 2}
    ns |= {q * d + r for q in (1, 3, 2 ** 31 // d - 1) for r in (0, d - 1)}
    for n in ns:
        if 0 <= n < 2 ** 31:
            assert _fast_div(n, d) == n // d, (n, d)


@pytest.mark.parametrize("seed,sx,kt,pad,plan", [
    (0, (2, 6, 7, 5), (3, 3), ((2, 2), (2, 2)), A.GemmPlan(16, 2)),
    (1, (1, 5, 6, 12), (3, 2), ((2, 2), (1, 1)), A.GemmPlan(32, 3)),
    (2, (2, 9, 10, 20), (3, 3), ((2, 2), (2, 2)), None),
    (3, (1, 7, 9, 70), (3, 3), ((2, 2), (2, 2)), A.GemmPlan(64, 5)),
    (4, (3, 4, 5, 7), (2, 2), ((1, 1), (1, 1)), A.GemmPlan(16, 1)),
    (5, (2, 8, 6, 3), (3, 2), ((2, 2), (1, 1)), A.GemmPlan(32, 2)),
    (6, (2, 9, 11, 24), (3, 3), ((2, 2), (2, 2)),
     A.GemmPlan(64, 4))])
def test_k2_blocking_restated(seed, sx, kt, pad, plan):
    rng = np.random.RandomState(seed)
    x = rng.randn(*sx)
    w = rng.randn(*kt, sx[-1], 40)
    full = tuple(n + 2 * p[0] - k + 1 for n, p, k in zip(sx[1:3], pad, kt))
    out_start = tuple(p[0] for p in pad)
    out_size = tuple(f - o - 1 for f, o in zip(full, out_start))
    if plan is None:
        plan = A.gemm_plan(A.ConvGeom(sx[1], sx[2], sx[3], 40, *kt,
                                      *out_size).as_gemm(sx[0]))
    y = _k2_restated(x, w, pad, out_start, out_size, plan)
    ref = K.sd_conv_ref(torch.from_numpy(x), torch.from_numpy(w), pad,
                        out_start, out_size)
    np.testing.assert_allclose(y, ref.numpy(), rtol=1e-5, atol=1e-4)


# (seed, x shape, w shape, stride, padding, output_padding, forced plan)
K3_CASES = [
    (0, (2, 5, 6, 3), (4, 4, 3, 2), 2, 0, 1, A.GemmPlan(16, 3)),  # Cin 3
    (1, (1, 6, 7, 70), (5, 5, 70, 5), 2, ((1, 3), (0, 2)), 0,
     A.GemmPlan(32, 4)),                     # two row tiles per tap, ragged
    (2, (2, 4, 4, 40), (5, 5, 40, 24), 2, 2, 1, None),    # bn 64, 2 columns
    (3, (3, 6, 6, 64), (5, 5, 64, 3), 2, ((1, 2), (1, 2)), 0,
     None),                                  # DCGAN d3's widths: NCo 12
    (4, (2, 6, 7, 12), (5, 5, 12, 6), 1, 2, 0,
     A.GemmPlan(16, 7)),                     # stride 1, empty splits
    (5, (1, 5, 5, 8), (3, 3, 8, 4), 2, 1, 1, A.GemmPlan(64, 2)),  # mde k3
]


@pytest.mark.parametrize("case", K3_CASES,
                         ids=[f"{c[1]}-{c[2]}-s{c[3]}" for c in K3_CASES])
def test_k3_blocking_restated(case, monkeypatch):
    """K3 restated block by block equals ``sd_filter_grad_ref`` at the
    f32 gate 1e-5, and in the fused backward gives the reference's SD
    filter gradient (``repro.sd.grad`` on an xla plan) at 1e-4."""
    seed, sx, sw, s, pad, op, plan = case
    x, w, dy, jp = _case(sx, sw, s, pad, op, seed=seed)
    tp = tsd.plan(w.shape, s, pad, backend="fused", output_padding=op)
    kt, pads = tp.kt, tuple((q, q) for q in tp.pi)
    dy1 = tgrad.split_cotangent(tp, torch.from_numpy(dy)).numpy()
    geom = K._filter_grad_geom(x.shape, dy1.shape, kt, pads)
    plan = plan or A.filter_grad_plan(geom)
    A.check_gemm_plan(geom.as_gemm(), plan)
    dws, hits = _k3_restated(x, dy1, kt, pads, plan)
    assert (hits == 1).all(), "a product taken != once"
    ref = K.sd_filter_grad_ref(torch.from_numpy(x), torch.from_numpy(dy1),
                               kt, pads)
    np.testing.assert_allclose(dws, ref.numpy(), **TOL)

    def restated(x_, dy1_, kt_, pi_, plan_=None):
        return torch.from_numpy(_k3_restated(
            x_.numpy(), dy1_.numpy(), tuple(kt_),
            tuple((q, q) for q in pi_), plan)[0])

    monkeypatch.setattr(ops, "sd_filter_grad_fused", restated)
    _, dw = tgrad.conv_transpose_vjp(tp, torch.from_numpy(x),
                                     torch.from_numpy(w),
                                     torch.from_numpy(dy))
    _, jdw = jgrad.conv_transpose_vjp(jp, jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(dy))
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **GRAD_TOL)

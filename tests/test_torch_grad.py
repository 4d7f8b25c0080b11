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
* the tiles the kernels are handed (``conv_plan``, ``filter_grad_plan``)
  on every backward geometry of the paper layers, and the kernels'
  blocking restated in numpy (each output written once, K3's chunks
  summed in order) on ragged tiles.
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
    batches chip_smoke runs fits the kernels: K2's positions fit its
    block and its staging fits shared memory; K3's chunks cover the
    reduction exactly once in whole steps, within the grid's limits."""
    for name, layer, kt, pi, o1 in _backward_geometries():
        nco = layer.cout * layer.s ** 2
        cg = A.ConvGeom(h=o1[0], w=o1[1], cin=nco, co=layer.cin,
                        kth=kt[0], ktw=kt[1], out_h=layer.in_hw[0],
                        out_w=layer.in_hw[1])
        cp = A.conv_plan(cg)
        assert cp.th * cp.tw <= A.THREADS // (cp.tc // A.MICRO) * A.MICRO
        assert cp.tc >= min(layer.cin, A.TILE_CHANNELS[-1]), name
        assert A.smem_bytes(cg.as_fused(), cp) <= A.SMEM_BUDGET, name
        g = A.FilterGradGeom(b=batch, h=layer.in_hw[0], w=layer.in_hw[1],
                             cin=layer.cin, nco=nco, kth=kt[0], ktw=kt[1],
                             o1h=o1[0], o1w=o1[1])
        fp = A.filter_grad_plan(g)
        n = A.dw_splits(g, fp)
        assert fp.chunk % A.DW_MK == 0 and fp.tco in A.DW_TILE_CO
        assert (n - 1) * fp.chunk < g.m <= n * fp.chunk, name
        assert n == 1 or fp.chunk >= A.DW_MIN_CHUNK, name
        assert n <= 65535 and A.dw_threads(fp) <= 1024


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
    """sd_conv.cu: block (batch, th x tw tile, tc channels) stages the
    masked band ``os + tile*t - plo`` ... and writes its positions."""
    b, h, wd, cin = x.shape
    kth, ktw, _, co = w.shape
    oh, ow = out_size
    y = np.zeros((b, oh, ow, co), np.float64)
    hits = np.zeros(y.shape, np.int64)
    for ti in range(-(-oh // plan.th)):
        for tj in range(-(-ow // plan.tw)):
            r0 = out_start[0] + ti * plan.th - pad[0][0]
            c0 = out_start[1] + tj * plan.tw - pad[1][0]
            band = np.zeros((b, plan.th + kth - 1, plan.tw + ktw - 1, cin))
            rr = np.arange(band.shape[1]) + r0
            cc = np.arange(band.shape[2]) + c0
            ok_r, ok_c = (rr >= 0) & (rr < h), (cc >= 0) & (cc < wd)
            band[:, ok_r[:, None] & ok_c[None, :]] = \
                x[:, rr[ok_r]][:, :, cc[ok_c]].reshape(b, -1, cin)
            for p in range(plan.th * plan.tw):
                oy, ox = ti * plan.th + p // plan.tw, tj * plan.tw + p % plan.tw
                if oy >= oh or ox >= ow:
                    continue
                win = band[:, p // plan.tw:p // plan.tw + kth,
                           p % plan.tw:p % plan.tw + ktw]
                for c0_ in range(0, co, plan.tc):
                    sl = slice(c0_, min(co, c0_ + plan.tc))
                    y[:, oy, ox, sl] = np.einsum("bhwi,hwio->bo", win,
                                                 w[..., sl])
                    hits[:, oy, ox, sl] += 1
    return y, hits


def _k3_restated(x, dy1, kt, pad, plan):
    """sd_filter_grad.cu: block (tco channels, tap x 64 input channels,
    chunk of M) writes a partial slice; the reduce pass sums the slices
    in chunk order."""
    b, h, wd, cin = x.shape
    _, o1h, o1w, nco = dy1.shape
    m = b * o1h * o1w
    splits = -(-m // plan.chunk)
    part = np.zeros((splits, *kt, cin, nco))
    hits = np.zeros(part.shape, np.int64)
    mm = np.arange(m)
    bb, rem = mm // (o1h * o1w), mm % (o1h * o1w)
    vv, uu = rem // o1w, rem % o1w
    dyf = dy1.reshape(m, nco)
    for z in range(splits):
        sl = slice(z * plan.chunk, min(m, (z + 1) * plan.chunk))
        for kh in range(kt[0]):
            for kw in range(kt[1]):
                xr, xc = vv[sl] + kh - pad[0][0], uu[sl] + kw - pad[1][0]
                ok = (xr >= 0) & (xr < h) & (xc >= 0) & (xc < wd)
                xs = np.zeros((len(xr), cin))
                xs[ok] = x[bb[sl][ok], xr[ok], xc[ok]]
                for ci0 in range(0, cin, A.DW_TCI):
                    for co0 in range(0, nco, plan.tco):
                        ci = slice(ci0, min(cin, ci0 + A.DW_TCI))
                        co = slice(co0, min(nco, co0 + plan.tco))
                        part[z, kh, kw, ci, co] = xs[:, ci].T @ dyf[sl, co]
                        hits[z, kh, kw, ci, co] += 1
    return part.sum(0), hits


@pytest.mark.parametrize("seed,sx,kt,pad,plan", [
    (0, (2, 6, 7, 5), (3, 3), ((2, 2), (2, 2)), A.KernelPlan(3, 2, 2, 16)),
    (1, (1, 5, 6, 12), (3, 2), ((2, 2), (1, 1)), A.KernelPlan(2, 5, 7, 16)),
    (2, (2, 9, 10, 20), (3, 3), ((2, 2), (2, 2)), None)])
def test_k2_blocking_restated(seed, sx, kt, pad, plan):
    rng = np.random.RandomState(seed)
    x = rng.randn(*sx)
    w = rng.randn(*kt, sx[-1], 40)
    full = tuple(n + 2 * p[0] - k + 1 for n, p, k in zip(sx[1:3], pad, kt))
    out_start = tuple(p[0] for p in pad)
    out_size = tuple(f - o - 1 for f, o in zip(full, out_start))
    if plan is None:
        plan = A.conv_plan(A.ConvGeom(sx[1], sx[2], sx[3], 40, *kt,
                                      *out_size))
    y, hits = _k2_restated(x, w, pad, out_start, out_size, plan)
    assert (hits == 1).all()
    ref = K.sd_conv_ref(torch.from_numpy(x), torch.from_numpy(w), pad,
                        out_start, out_size)
    np.testing.assert_allclose(y, ref.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed,sx,nco,kt,pad,plan", [
    (0, (2, 5, 6, 3), 8, (3, 3), ((2, 2), (2, 2)), A.FilterGradPlan(16, 32)),
    (1, (1, 6, 7, 70), 20, (2, 3), ((1, 1), (2, 2)), A.FilterGradPlan(16, 32)),
    (2, (2, 4, 4, 5), 40, (2, 2), ((1, 1), (1, 1)), None)])
def test_k3_blocking_restated(seed, sx, nco, kt, pad, plan):
    rng = np.random.RandomState(seed)
    x = rng.randn(*sx)
    o1 = tuple(n + 2 * p[0] - k + 1 for n, p, k in zip(sx[1:3], pad, kt))
    dy1 = rng.randn(sx[0], *o1, nco)
    if plan is None:
        plan = A.filter_grad_plan(A.FilterGradGeom(
            sx[0], sx[1], sx[2], sx[3], nco, *kt, *o1))
    dws, hits = _k3_restated(x, dy1, kt, pad, plan)
    assert (hits == 1).all()
    ref = K.sd_filter_grad_ref(torch.from_numpy(x), torch.from_numpy(dy1),
                               kt, pad)
    np.testing.assert_allclose(dws, ref.numpy(), rtol=1e-5, atol=1e-4)

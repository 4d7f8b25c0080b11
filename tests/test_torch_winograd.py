"""The port's Winograd backend (K4's plain version, its launch geometry,
plans, engine and server) against the JAX reference, on the CPU.

* the Toom-Cook matrices equal ``repro.kernels.winograd``'s exactly, and
  ``transform_filters`` matches the reference's to 1e-6 (ranks 1 and 2,
  f32 and bf16); a bound winograd plan's ``ws`` equals the reference's;
* ``sd_wino_ref`` through a bound winograd plan matches
  ``repro.core.deconv.native_deconv`` and ``repro.sd`` on an ``xla`` plan
  at ``WINO_TOL`` relative to max|ref| (the reference's own winograd
  backend reaches a Pallas kernel this jax cannot run), on the 22 paper
  layers (widths capped) and the reference's geometry sweep;
* what the CUDA kernel computes, block by block, restated in numpy from
  the integers ``wino_launch`` hands it (the blocks' bands of tiles and
  samples, V = B^T d B per tile slot, the products per chunk of input
  channels in 3xTF32 promoted into f32 sums, A^T M A and K1's interleave and
  crop), on the default and forced ragged tiles, F(2,5), 1-tap dims and
  bf16: every output element written once, equal to ``sd_wino_ref`` and
  to the reference's xla plan at ``WINO_TOL``;
* ``conv_transpose`` on a winograd plan: gradients equal the reference's
  xla gradients at 1e-4;
* the engine, the model and ``serve_gen --backend winograd`` end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sd as jsd
from repro.core import native_deconv as j_native
from repro.core.accounting import BENCHMARKS as J_BENCHMARKS
from repro.core.accounting import LayerSpec as JLayer
from repro.core.accounting import NetworkSpec as JSpec
from repro.core.deconv import same_deconv_pads
from repro.kernels import winograd as jw
from repro.models.generative import GenerativeModel as JModel
import repro_torch.sd as tsd
from repro_torch.convert import params_from_numpy
from repro_torch.core.accounting import BENCHMARKS
from repro_torch.kernels import ops
from repro_torch.kernels import winograd as W
from repro_torch.kernels.autotune import (SMEM_BUDGET, WinoPlan,
                                          check_wino_plan, wino_grid,
                                          wino_plan, wino_smem_bytes)
from repro_torch.launch import train_gen
from repro_torch.launch.serve_gen import main as serve_main
from repro_torch.models import build
from repro_torch.models.generative import GenerativeModel
from _torch_igemm import mma3, promote
from repro_torch.kernels.autotune import WinoGeom as A_WinoGeom

PAPER_LAYERS = [(net, l) for net, fn in BENCHMARKS.items()
                for l in fn().deconv_layers()]
PAPER_IDS = [f"{net}/{l.name}" for net, l in PAPER_LAYERS]


def _rel_err(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-6)


# ---------------------------------------------------------------------------
# Transform math: the port's own copy equals the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,r", [(m, r) for r in range(1, 6)
                                 for m in (1, 2)])
def test_winograd_matrices_equal_reference(m, r):
    """Exactly equal, every supported (m, r) and the m = 1 variants."""
    for a, b in zip(W.winograd_matrices(m, r), jw.winograd_matrices(m, r)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_tables_equal_reference():
    assert W.WINO_TOL == jw.WINO_TOL
    assert (W.OUTPUT_TILE, W.MAX_TAPS, W._POINTS) == \
        (jw.OUTPUT_TILE, jw.MAX_TAPS, jw._POINTS)
    for kt in [(1,), (5,), (3, 3), (1, 5), (6, 3), (2, 2, 2)]:
        for dt in ("native", "int8"):
            assert W.supported(kt, dt) == jw.supported(kt, dt)
        if jw.supported(kt):
            assert W.tolerance(kt) == jw.tolerance(kt)
            assert W.output_tile(kt[0]) == jw.output_tile(kt[0])


@pytest.mark.parametrize("shape,dtype", [
    ((3, 3, 4, 6), "float32"), ((2, 2, 5, 8), "float32"),
    ((5, 5, 3, 4), "float32"), ((1, 3, 4, 4), "float32"),
    ((5, 3, 4), "float32"), ((2, 6, 4), "float32"),
    ((3, 3, 4, 6), "bfloat16"), ((2, 3, 3, 4), "bfloat16"),
    ((5, 2, 4), "bfloat16")])
def test_transform_filters_matches_reference(shape, dtype):
    """U = G g G^T per tap dim, in f32, cast back to the filter dtype;
    gate 1e-6 of max|ref| (bf16: both round the same f32 values)."""
    ws = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    ref = jw.transform_filters(jnp.asarray(ws, getattr(jnp, dtype)))
    out = W.transform_filters(torch.from_numpy(ws).to(getattr(torch,
                                                              dtype)))
    assert out.dtype == getattr(torch, dtype)
    assert tuple(out.shape) == tuple(ref.shape)
    ref = np.asarray(ref.astype(jnp.float32))
    assert _rel_err(out.float().numpy(), ref) <= 1e-6


def test_transform_filters_rejects_what_the_reference_rejects():
    for shape in ((6, 6, 2, 2), (2, 2, 2, 2, 2)):
        with pytest.raises(ValueError, match="unsupported tap geometry"):
            W.transform_filters(torch.zeros(shape))
        with pytest.raises(ValueError, match="unsupported tap geometry"):
            jw.transform_filters(jnp.zeros(shape))


# ---------------------------------------------------------------------------
# sd_wino_ref through bound plans vs the exact reference paths
# ---------------------------------------------------------------------------

def _both_refs(x, w, s, pads, act, scale=None, bias=None,
               output_padding=0):
    """The reference's exact outputs: an xla plan, and native_deconv with
    scale, bias and activation applied after."""
    jx, jwt = jnp.asarray(x), jnp.asarray(w)
    opt = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
    jp = jsd.plan(w.shape, s, pads, backend="xla", act=act,
                  output_padding=output_padding).bind(jwt, opt(scale),
                                                      opt(bias))
    xla = np.asarray(jsd.execute(jp, jx))
    y = j_native(jx, jwt, s, pads, output_padding=output_padding)
    if scale is not None:
        y = y * jnp.asarray(scale)
    if bias is not None:
        y = y + jnp.asarray(bias)
    y = {"linear": y, "relu": jax.nn.relu(y), "tanh": jnp.tanh(y)}[act]
    return xla, np.asarray(y)


def _port_wino(x, w, s, pads, act, scale=None, bias=None,
               output_padding=0):
    opt = lambda a: None if a is None else torch.from_numpy(a)  # noqa
    p = tsd.plan(w.shape, s, pads, backend="winograd", act=act,
                 output_padding=output_padding).bind(
                     torch.from_numpy(w), opt(scale), opt(bias))
    assert p.layout == "wino"
    return tsd.execute(p, torch.from_numpy(x)).numpy(), p


@pytest.mark.parametrize("net,layer", PAPER_LAYERS, ids=PAPER_IDS)
def test_paper_layers_match_reference(net, layer):
    """Every paper layer's (K, s, padding), widths capped at 32 channels
    and 16 rows as in the reference's own winograd tests; BN scale and
    bias folded, relu; gate ``tolerance(K_T) * max|ref|``."""
    rng = np.random.RandomState(len(net) + layer.k)
    cin, cout = min(layer.cin, 32), min(layer.cout, 32)
    hw = tuple(min(d, 16) for d in layer.in_hw)
    pads = same_deconv_pads(layer.k, layer.s)
    x = rng.randn(1, *hw, cin).astype(np.float32)
    w = rng.randn(layer.k, layer.k, cin, cout).astype(np.float32)
    scale = (rng.rand(cout) + 0.5).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    out, p = _port_wino(x, w, layer.s, pads, "relu", scale, bias)
    tol = W.tolerance(p.kt)
    for ref in _both_refs(x, w, layer.s, pads, "relu", scale, bias):
        assert out.shape == ref.shape
        assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("K,s,pad,op", [
    (5, 2, "same", 0), (4, 2, 1, 0), (3, 2, "same", 0), (2, 2, 0, 0),
    (5, 1, 2, 0),                    # artgan d4_s1: K_T = 5, F(2,5)
    (5, 3, 2, 0), (6, 3, "same", 0), (7, 4, 3, 0), (5, 4, "same", 0),
    (4, 2, 0, 1),                    # output_padding > pad_hi
    (5, 2, ((1, 3), (0, 2)), 1),     # asymmetric pads
])
def test_geometry_sweep_matches_reference(K, s, pad, op):
    """The reference's sweep (tests/test_winograd.py), plus
    ``output_padding`` past the support and asymmetric pads."""
    rng = np.random.RandomState(K * 10 + s)
    pads = same_deconv_pads(K, s) if pad == "same" else pad
    x = rng.randn(2, 7, 6, 4).astype(np.float32)
    w = rng.randn(K, K, 4, 3).astype(np.float32)
    bias = rng.randn(3).astype(np.float32)
    out, p = _port_wino(x, w, s, pads, "tanh", bias=bias, output_padding=op)
    for ref in _both_refs(x, w, s, pads, "tanh", bias=bias,
                          output_padding=op):
        assert out.shape == ref.shape
        assert _rel_err(out, ref) <= W.tolerance(p.kt)


@pytest.mark.parametrize("net,layer", PAPER_LAYERS[:4], ids=PAPER_IDS[:4])
def test_bound_filters_match_reference(net, layer):
    """Carried weights bind to the reference's transformed filters
    (split, BN fold, oc-major, U = G g G^T), to 1e-6 of max|ref|."""
    rng = np.random.RandomState(3)
    w = rng.randn(layer.k, layer.k, 16, 8).astype(np.float32)
    scale = (rng.rand(8) + 0.5).astype(np.float32)
    pads = same_deconv_pads(layer.k, layer.s)
    jp = jsd.plan(w.shape, layer.s, pads, backend="winograd").bind(
        jnp.asarray(w), jnp.asarray(scale))
    tp = tsd.plan(w.shape, layer.s, pads, backend="winograd").bind(
        torch.from_numpy(w), torch.from_numpy(scale))
    assert tp.layout == jp.layout == "wino"
    assert tuple(tp.ws.shape) == tuple(jp.ws.shape)
    assert _rel_err(tp.ws.numpy(), np.asarray(jp.ws)) <= 1e-6


def test_bf16_plan_stores_bf16_transforms():
    """bf16 plans keep bf16 transformed filters; the plain version
    converts to f32 before the transform, so the error is bf16
    rounding (gate 1e-2 of max|ref|, as for K1)."""
    rng = np.random.RandomState(12)
    x = rng.randn(1, 6, 6, 8).astype(np.float32)
    w = rng.randn(4, 4, 8, 4).astype(np.float32)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    p = tsd.plan(w.shape, 2, 1, backend="winograd").bind(wb)
    assert p.ws.dtype == torch.bfloat16
    out = tsd.execute(p, xb)
    assert out.dtype == torch.bfloat16
    ref = j_native(jnp.asarray(xb.float().numpy()),
                   jnp.asarray(wb.float().numpy()), 2, 1)
    assert _rel_err(out.float().numpy(), ref) <= 1e-2


def test_plan_rejects_as_the_reference_does():
    """K_T = 6, rank 3 and int8 raise the reference's ValueError (in both
    packages), and so does full WaveGAN's 7-tap rank-1 layer; rank 1
    inside the envelope plans and binds the transformed filters, as in
    the reference."""
    for shape, s, dtype in (((12, 12, 3, 2), 2, "native"),
                            ((5, 5, 5, 3, 2), 2, "native"),
                            ((4, 4, 3, 2), 2, "int8"),
                            ((25, 3, 2), 4, "native")):
        with pytest.raises(ValueError, match="winograd backend does not"):
            tsd.plan(shape, s, 0, backend="winograd", dtype=dtype)
        with pytest.raises(ValueError, match="winograd backend does not"):
            jsd.plan(shape, s, 0, backend="winograd", dtype=dtype)
    p1 = tsd.plan((5, 3, 2), 2, 1, backend="winograd")
    j1 = jsd.plan((5, 3, 2), 2, 1, backend="winograd")
    assert (p1.rank, p1.kt, p1.backend) == (j1.rank, j1.kt, "winograd")
    u = p1.bind(torch.zeros(5, 3, 2)).ws
    assert tuple(u.shape) == (4, 3, 4)          # alpha = 2 + 3 - 1
    assert "winograd" in tsd.BACKENDS
    assert tsd.resolve_backend("winograd") == "winograd"


# ---------------------------------------------------------------------------
# K4's launch geometry: the CUDA kernel's blocking, restated in numpy
# ---------------------------------------------------------------------------

def _k4_restated(x, u, kt, s, bias, act, pad, crop, out_space, plan=None,
                 dtype=""):
    """What ``csrc/sd_wino.cu`` computes, block by block, from the
    integers ``wino_launch`` hands it: each block's tile slots (a band of
    ``nth x ntw`` tiles in ``nb`` samples), the masked input windows,
    V = B^T d B per slot in f32, the alpha^2 products per chunk of input
    channels (16; 8 on 16 slots) in 3xTF32 promoted into f32 sums, A^T M
    A, and each
    conv position's value through K1's interleave and crop."""
    g = W.wino_launch(tuple(x.shape), tuple(u.shape), kt, s, pad, crop,
                      out_space, plan, dtype)
    geom, p = g.geom, g.plan
    sh, sw = s
    b_, h, wd, cin = x.shape
    nc = u.shape[-1]
    at_h, _, bt_h = (a.astype(np.float64)
                     for a in W.winograd_matrices(geom.mh, kt[0]))
    at_w, _, bt_w = (a.astype(np.float64)
                     for a in W.winograd_matrices(geom.mw, kt[1]))
    ah, aw = bt_h.shape[0], bt_w.shape[0]
    assert u.shape[:2] == (ah, aw) and ah * aw == geom.alphas
    r0, c0 = g.q_h - g.plo_h, g.q_w - g.plo_w
    nt_h, nt_w = geom.tiles
    gx, gy, gz = wino_grid(geom, p)
    nbw = -(-nt_w // p.ntw)
    live = p.nb * p.nth * p.ntw
    assert live <= geom.slots
    y = np.full((b_, g.out_h, g.out_w, nc // (sh * sw)), np.nan)
    for bz in range(gz):
        for by in range(gy):
            bi, bj = divmod(by, nbw)
            d = np.zeros((geom.slots, cin, ah, aw))
            where = []
            for t in range(live):
                sb, rem = divmod(t, p.nth * p.ntw)
                tr, tc = divmod(rem, p.ntw)
                b, tr, tc = bz * p.nb + sb, bi * p.nth + tr, bj * p.ntw + tc
                where.append((b, tr, tc))
                if b >= b_:
                    continue
                for a1 in range(ah):
                    for a2 in range(aw):
                        xr, xc = tr * geom.mh + r0 + a1, tc * geom.mw + c0 + a2
                        if 0 <= xr < h and 0 <= xc < wd:
                            d[t, :, a1, a2] = x[b, xr, xc]
            v = np.einsum("ia,tcab,jb->ijtc", bt_h, d, bt_w).astype(
                np.float32).reshape(ah * aw, geom.slots, cin)
            for bx in range(gx):
                n0 = bx * p.tc
                uc = np.zeros((ah * aw, cin, p.tc), np.float32)
                uc[..., :min(nc, n0 + p.tc) - n0] = u.reshape(
                    ah * aw, cin, nc)[..., n0:n0 + p.tc]
                m = np.zeros((ah * aw, geom.slots, p.tc), np.float32)
                for ci0 in range(0, cin, geom.chunk):
                    ci = slice(ci0, ci0 + geom.chunk)
                    for k in range(ah * aw):
                        m[k] = promote(m[k], mma3(v[k][:, ci], uc[k][ci]))
                yt = np.einsum("oi,ijtc,pj->topc", at_h,
                               m.reshape(ah, aw, geom.slots, p.tc), at_w)
                for t, (b, tr, tc) in enumerate(where):
                    for c in range(p.tc):
                        if n0 + c >= nc or b >= b_:
                            continue
                        oc, ph = divmod(n0 + c, sh * sw)
                        for o1 in range(geom.mh):
                            for o2 in range(geom.mw):
                                oy = ((tr * geom.mh + o1) * sh + ph // sw
                                      - g.res_h)
                                ox = ((tc * geom.mw + o2) * sw + ph % sw
                                      - g.res_w)
                                if not (0 <= oy < g.out_h
                                        and 0 <= ox < g.out_w):
                                    continue
                                assert np.isnan(y[b, oy, ox, oc]), "twice"
                                r = yt[t, o1, o2, c] + bias[oc]
                                y[b, oy, ox, oc] = {
                                    "linear": r, "relu": max(r, 0.0),
                                    "tanh": np.tanh(r)}[act]
    assert not np.isnan(y).any(), "output element never written"
    return y, g


# (x shape, w shape, stride, padding, output_padding, act, forced tile,
# bf16)
EMU = [
    ((2, 8, 8, 6), (5, 5, 6, 3), 2, "same", 0, "relu", None, False),
    ((1, 4, 4, 8), (4, 4, 8, 4), 2, "same", 0, "linear", None, False),
    ((1, 7, 6, 5), (5, 5, 5, 3), 1, "same", 0, "tanh", None, False),  # F(2,5)
    ((1, 5, 6, 3), (2, 2, 3, 2), 2, 0, 0, "relu", None, False),    # F(1,1)
    ((1, 5, 6, 3), (4, 4, 3, 2), 2, 0, 1, "tanh", None, False),    # op > hi
    ((1, 6, 7, 3), (5, 5, 3, 2), 2, ((1, 3), (0, 2)), 0, "linear", None,
     False),                                                       # asym.
    ((1, 5, 6, 3), (5, 2, 3, 2), 2, ((2, 2), (0, 1)), 0, "relu", None,
     False),                                                 # F(2,3)xF(1,1)
    ((2, 13, 11, 40), (5, 5, 40, 5), 2, 2, 1, "relu",
     WinoPlan(nth=3, ntw=2, nb=2, tc=16), False),  # ragged bands, Cin 40
    ((3, 9, 10, 19), (3, 3, 19, 9), 2, 1, 1, "linear",
     WinoPlan(nth=2, ntw=3, nb=2, tc=32), False),  # ragged samples, tc 32
    ((1, 9, 7, 20), (5, 5, 20, 2), 1, 2, 0, "relu",
     WinoPlan(nth=3, ntw=1, nb=1, tc=16), False),  # F(2,5), odd rows
    ((2, 8, 8, 24), (5, 5, 24, 5), 2, "same", 0, "relu", None, True),
    ((1, 9, 7, 9), (4, 4, 9, 3), 2, 1, 1, "tanh",
     WinoPlan(nth=2, ntw=3, nb=1, tc=16), True),   # bf16 F(2,2), ragged
]


@pytest.mark.parametrize("case", EMU, ids=[
    f"{c[:2]}{c[5]}{'-bf16' if c[7] else ''}" for c in EMU])
def test_launch_geometry_emulated(case):
    """K4 restated equals ``sd_wino_ref`` (1e-5 of max(1, max|ref|)) and
    the reference's xla plan at ``tolerance(K_T)`` of max|ref|.  bf16:
    the operands' bf16 values carried in f32, on filters of eighths whose
    transform is exact in bf16 (a rounded U is no filter's transform, and
    its result then depends on where the tiles start)."""
    sx, sw_, s, pad, op, act, tile, bf16 = case
    pads = same_deconv_pads(sw_[0], s) if pad == "same" else pad
    rng = np.random.RandomState(sum(sx))
    x = rng.randn(*sx).astype(np.float32)
    w = (rng.randn(*sw_) / np.sqrt(np.prod(sw_[:-1]))).astype(np.float32)
    bias = rng.randn(sw_[-1]).astype(np.float32)
    if bf16:
        x = torch.from_numpy(x).bfloat16().float().numpy()
        w = rng.randint(-4, 5, sw_).astype(np.float32) / 8
    tp = tsd.plan(w.shape, s, pads, backend="winograd", act=act,
                  output_padding=op, tile=tile).bind(
                      torch.from_numpy(w), bias=torch.from_numpy(bias))
    u = tp.ws
    if bf16:
        assert torch.equal(u.bfloat16().float(), u)
    pk, pi, pd = tp.pk, tp.pi, tp.padding
    geo = dict(bias=torch.from_numpy(bias), act=act,
               pad=((pi[0],) * 2, (pi[1],) * 2),
               crop=(pk[0] + pd[0][0], pk[1] + pd[1][0]),
               out_space=tp.out_shape(sx[1:3]))
    out, g = _k4_restated(x, u.numpy(), tp.kt, tp.stride, bias, act,
                          geo["pad"], geo["crop"], geo["out_space"], tile,
                          "bf16" if bf16 else "")
    ref = W.sd_wino_ref(torch.from_numpy(x), u, tp.kt, tp.stride,
                        **geo).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    xla, _ = _both_refs(x, w, s, pads, act, bias=bias, output_padding=op)
    assert _rel_err(out, xla) <= W.tolerance(tp.kt)
    assert g.plan == (tile or wino_plan(g.geom))


def test_wino_plan_fits_and_covers():
    """The default plan of every paper layer's forward at batches 4 and
    16, f32 and bf16, is one the kernel takes (its tile slots, channel
    tile, grid and shared memory), and a plan past the slots, the
    channel tiles or shared memory raises."""
    for net, layer in PAPER_LAYERS:
        kt = -(-layer.k // layer.s)
        oh, ow = layer.out_hw()
        pk = layer.s * kt - layer.k
        crop = pk + same_deconv_pads(layer.k, layer.s)[0][0]
        pi = kt - 1 - same_deconv_pads(layer.k, layer.s)[0][0] // layer.s
        for batch in (4, 16):
            for dtype in ("", "bf16"):
                g = W.wino_launch(
                    (batch, *layer.in_hw, layer.cin),
                    (1, 1, layer.cin, layer.cout * layer.s ** 2),
                    (kt, kt), (layer.s, layer.s), ((pi, pi), (pi, pi)),
                    (crop, crop), (oh, ow), None, dtype)
                geom, plan = g.geom, g.plan
                check_wino_plan(geom, plan)
                assert wino_smem_bytes(geom, plan) <= SMEM_BUDGET
                assert plan.nb * plan.nth * plan.ntw <= geom.slots
                nt_h, nt_w = geom.tiles
                gx, gy, gz = wino_grid(geom, plan)
                # the blocks cover every tile of every sample
                assert gy * plan.nth * plan.ntw >= nt_h * nt_w
                assert gz * plan.nb >= batch
                assert gx * plan.tc >= geom.nc, (net, layer.name)
    geom = A_WinoGeom(4, 16, 16, 64, 64, 3, 3)
    for bad in (WinoPlan(nth=8, ntw=8, nb=1, tc=32),   # 64 tiles > 32
                WinoPlan(nth=4, ntw=4, nb=1, tc=64),   # no 64-channel tile
                WinoPlan(nth=4, ntw=4, nb=0, tc=16)):
        with pytest.raises(ValueError, match="kernel takes"):
            check_wino_plan(geom, bad)
    deep = A_WinoGeom(4, 16, 16, 64, 64, 5, 5)          # 36 points: 16 slots
    assert deep.slots == 16 and wino_plan(deep).tc == 16
    with pytest.raises(ValueError, match="kernel takes"):
        check_wino_plan(deep, WinoPlan(nth=4, ntw=4, nb=1, tc=32))
    tiny = A_WinoGeom(32, 2, 2, 64, 64, 3, 3)           # one tile a sample
    with pytest.raises(ValueError, match="shared memory"):
        check_wino_plan(tiny, WinoPlan(nth=1, ntw=1, nb=32, tc=32))
    plan = wino_plan(tiny)                  # fewer samples, within budget
    assert plan.nb < 32 and wino_smem_bytes(tiny, plan) <= SMEM_BUDGET


def test_wrapper_cpu_is_plain_version_and_counts_nothing():
    before = W.SD_WINO_LAUNCHES
    x = torch.randn(1, 4, 4, 3)
    u = W.transform_filters(torch.randn(2, 2, 3, 8))
    y = W.sd_wino(x, u, (2, 2), 2, pad=((1, 1), (1, 1)))
    assert y.shape == (1, 10, 10, 2) and W.SD_WINO_LAUNCHES == before
    torch.testing.assert_close(y, W.sd_wino_ref(x, u, (2, 2), 2,
                                                pad=((1, 1), (1, 1))))
    with pytest.raises(ValueError, match="unknown act"):
        W.sd_wino(x, u, (2, 2), 2, act="gelu")
    # the deconv-level wrapper on the same filters
    y2 = ops.sd_deconv_presplit_wino(x, u, 4, 2, 1)
    assert y2.shape == (1, 8, 8, 2)


# ---------------------------------------------------------------------------
# Gradients, engine, model, server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,s,pad,op", [(5, 2, "same", 0), (4, 2, 1, 1),
                                        (5, 1, 2, 0), (3, 2, 1, 1)])
def test_conv_transpose_grads_match_reference(K, s, pad, op):
    """``conv_transpose`` on a winograd plan: forward at WINO_TOL, and
    its backward (the plain torch formulation) equal to the reference's
    xla gradients at 1e-4 of each gradient's max|ref|."""
    rng = np.random.RandomState(K + s)
    pads = same_deconv_pads(K, s) if pad == "same" else pad
    x = rng.randn(2, 5, 6, 4).astype(np.float32)
    w = rng.randn(K, K, 4, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    jp = jsd.plan(w.shape, s, pads, backend="xla", output_padding=op)
    ref_y = jsd.conv_transpose(jp, jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b))
    dy = rng.randn(*ref_y.shape).astype(np.float32)

    def loss(x_, w_, b_):
        return jnp.sum(jsd.conv_transpose(jp, x_, w_, b_) * dy)

    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(b))
    tp = tsd.plan(w.shape, s, pads, backend="winograd", output_padding=op)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = tsd.conv_transpose(tp, tx, tw, tb)
    assert _rel_err(y.detach().numpy(), ref_y) <= W.tolerance(tp.kt)
    (y * torch.from_numpy(dy)).sum().backward()
    for got, ref in zip((tx.grad, tw.grad, tb.grad), jg):
        assert _rel_err(got.numpy(), ref) <= 1e-4


def _j_small_spec():
    return JSpec("DCGAN-small", [
        JLayer("fc", 32, 4 * 4 * 64, name="project"),
        JLayer("deconv", 64, 32, k=5, s=2, in_hw=(4, 4), name="d1"),
        JLayer("deconv", 32, 3, k=5, s=2, in_hw=(8, 8), name="d2"),
    ])


@pytest.mark.parametrize("width", ["small", "full"])
def test_model_end_to_end_matches_reference_native(width):
    """The winograd engine end to end on carried weights against the
    JAX ``native`` model: the small DCGAN, and full-width DCGAN through
    ``build``; gate ``tolerance((3, 3)) * max|ref|``."""
    if width == "small":
        jspec = _j_small_spec()
        m = GenerativeModel(train_gen.small_spec(), "sd_kernel",
                            engine_backend="winograd", device="cpu")
    else:
        jspec = J_BENCHMARKS["dcgan"]()
        m = build("dcgan", "sd_kernel", engine_backend="winograd",
                  device="cpu")
    jm = JModel(jspec, "native")
    jp = jm.init(jax.random.PRNGKey(0))
    # non-trivial BN scale and bias, so the fold is exercised
    rng = np.random.RandomState(4)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    for l in jspec.deconv_layers():
        np_params[l.name] = dict(
            np_params[l.name],
            scale=(rng.rand(l.cout) + 0.5).astype(np.float32),
            b=(0.1 * rng.randn(l.cout)).astype(np.float32))
    z = rng.randn(*jm.input_shape(2)).astype(np.float32)
    ref = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray,
                                                     np_params),
                              jnp.asarray(z)))
    params = params_from_numpy(np_params, "cpu", spec=m.spec)
    with torch.no_grad():
        out = m(params, torch.from_numpy(z)).numpy()
    assert m.engine.backend == "winograd"
    assert all(p.layout == "wino" for p in m.engine.plans().values())
    assert out.shape == ref.shape
    assert _rel_err(out, ref) <= W.tolerance((3, 3))


def test_serve_gen_dryrun_winograd_cpu():
    results, stats = serve_main(["--dryrun", "--backend", "winograd",
                                 "--device", "cpu"])
    assert stats["served"] == 6 and stats["shed"] == 0
    assert stats["compile_cache"] == [
        "('dcgan-dryrun', 2, 'float32')", "('segnet-dryrun', 2, 'float32')",
        "('wavegan-dryrun', 2, 'float32')"]
    ref, _ = serve_main(["--dryrun", "--backend", "torch", "--device",
                         "cpu"])
    for rid in range(4):        # the 2-D nets come first in both runs
        assert _rel_err(results[rid].numpy(), ref[rid].numpy()) <= \
            W.tolerance((3, 3))
    # wavegan-dryrun's requests (its latents differ between the two runs:
    # the torch run also serves voxgan-dryrun); its numbers are held in
    # tests/test_torch_rank1.py
    assert all(results[rid].shape == (32, 1)
               and bool(torch.isfinite(results[rid]).all())
               for rid in (4, 5))

"""The port's plans, the fused kernel's plain version and its launch
geometry, against the JAX reference.

* ``to_ocmajor`` and a bound plan's filters, element for element, vs
  ``repro.sd.plan`` (n-major and oc-major, BN scale folded);
* ``sd_fused_ref`` reached through ``ops.sd_deconv_presplit_fused`` and
  the ``torch`` backend, on all 22 paper deconv layers, vs
  ``repro.sd.execute`` on ``backend="xla"`` (f32, ``rtol=atol=1e-5``);
* the integers the CUDA kernel is handed (``launch_geometry``), checked
  by restating the kernel's index arithmetic in numpy: every output
  element written exactly once, with the reference's value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sd as jsd
from repro.core.accounting import BENCHMARKS
from repro.core.deconv import same_deconv_pads
from repro.engine.planner import fold_scale_ocmajor as j_fold
import repro_torch.sd as tsd
from repro_torch.core.deconv import split_filters
from repro_torch.engine import fold_scale_ocmajor
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import (FusedGeom, KernelPlan,
                                          heuristic_plan, smem_bytes,
                                          SMEM_TARGET)
from repro_torch.kernels.sd_conv import launch_geometry, sd_fused

TOL = dict(rtol=1e-5, atol=1e-5)
PAPER_LAYERS = [(net, l) for net, fn in BENCHMARKS.items()
                for l in fn().deconv_layers()]
PAPER_IDS = [f"{net}/{l.name}" for net, l in PAPER_LAYERS]


def _layer_data(layer, batch=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, *layer.in_hw, layer.cin).astype(np.float32)
    w = (rng.randn(layer.k, layer.k, layer.cin, layer.cout)
         / np.sqrt(layer.k * layer.k * layer.cin)).astype(np.float32)
    scale = (rng.rand(layer.cout) + 0.5).astype(np.float32)
    bias = rng.randn(layer.cout).astype(np.float32)
    return x, w, scale, bias


@pytest.mark.parametrize("net,layer", PAPER_LAYERS, ids=PAPER_IDS)
def test_paper_layer_fused_ref_and_torch_backend(net, layer):
    x, w, scale, bias = _layer_data(layer)
    pads = same_deconv_pads(layer.k, layer.s)
    jp = jsd.plan(w.shape, layer.s, pads, backend="xla", act="relu").bind(
        jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias))
    ref = np.asarray(jsd.execute(jp, jnp.asarray(x)))
    tx = torch.from_numpy(x)
    targs = [torch.from_numpy(a) for a in (w, scale, bias)]
    for backend in ("torch", "fused"):
        tp = tsd.plan(w.shape, layer.s, pads, backend=backend,
                      act="relu").bind(*targs)
        np.testing.assert_allclose(tsd.execute(tp, tx).numpy(), ref,
                                   err_msg=backend, **TOL)
    # the deconv-level wrapper, called directly on the bound oc-major ws
    out = ops.sd_deconv_presplit_fused(
        tx, tp.ws, tp.kernel, tp.stride, pads, bias=tp.bias, act="relu")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("net,layer", PAPER_LAYERS[:4], ids=PAPER_IDS[:4])
def test_bound_filters_match_reference(net, layer):
    _, w, scale, bias = _layer_data(layer, seed=2)
    pads = same_deconv_pads(layer.k, layer.s)
    for jb, tb in (("xla", "torch"), ("fused", "fused")):
        jp = jsd.plan(w.shape, layer.s, pads, backend=jb).bind(
            jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias))
        tp = tsd.plan(w.shape, layer.s, pads, backend=tb).bind(
            *[torch.from_numpy(a) for a in (w, scale, bias)])
        assert tp.layout == jp.layout
        np.testing.assert_allclose(tp.ws.numpy(), np.asarray(jp.ws),
                                   rtol=1e-6, atol=0)
    ws = split_filters(torch.from_numpy(w), layer.s)
    np.testing.assert_array_equal(
        tsd.to_ocmajor(ws, layer.s).numpy(),
        np.asarray(jsd.to_ocmajor(jnp.asarray(ws.numpy()), layer.s)))
    # oc-major folding repeats the per-oc scale over the phases
    oc = tsd.to_ocmajor(ws, layer.s)
    np.testing.assert_allclose(
        fold_scale_ocmajor(oc, torch.from_numpy(scale), layer.s).numpy(),
        np.asarray(j_fold(jnp.asarray(oc.numpy()), jnp.asarray(scale),
                          layer.s)), rtol=1e-6)


def test_plan_contract():
    assert tsd.resolve_backend("auto", "cpu") == "torch"
    assert tsd.resolve_backend("auto", "cuda") == "fused"
    with pytest.raises(ValueError, match="unknown SD backend"):
        tsd.plan((4, 4, 3, 2), 2, 1, backend="xla")
    assert tsd.plan((4, 4, 3, 2), 2, 1, backend="fused",
                    dtype="int8").dtype == "int8"
    with pytest.raises(ValueError, match="unknown plan dtype"):
        tsd.plan((4, 4, 3, 2), 2, 1, backend="fused", dtype="int4")
    chained = tsd.plan((4, 4, 3, 2), 2, 1, backend="fused", act="relu",
                       dtype="int8").with_chain(sx_in=0.1, sx_out=0.2,
                                                chain_out=True)
    assert chained.chain_out and chained.sx_out.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="rank 2"):
        tsd.plan((4, 3, 2), 2, 1, backend="fused")
    with pytest.raises(ValueError, match="output_padding"):
        tsd.plan((4, 4, 3, 2), 2, 1, output_padding=2)
    p = tsd.plan((5, 5, 3, 2), 2, same_deconv_pads(5, 2), backend="torch")
    with pytest.raises(ValueError, match="bound plan"):
        tsd.execute(p, torch.zeros(1, 4, 4, 3))
    with pytest.raises(ValueError, match="filter shape"):
        p.bind(torch.zeros(3, 3, 3, 2))


# ---------------------------------------------------------------------------
# Launch geometry: the CUDA kernel's index arithmetic, restated in numpy.
# ---------------------------------------------------------------------------

def _emulate(x, ws, s, bias, act, pad, crop, out_space, plan=None):
    """What ``csrc/sd_fused.cu`` computes, block by block, from the
    integers ``launch_geometry`` hands it."""
    g = launch_geometry(x.shape, ws.shape, s, pad, crop, out_space, plan)
    sh, sw = (s, s) if isinstance(s, int) else s
    p = g.plan
    b, h, wd, cin = x.shape
    kth, ktw, _, nc = ws.shape
    rh, rw = p.th + (g.res_h > 0), p.tw + (g.res_w > 0)
    y = np.full((b, g.out_h, g.out_w, nc // (sh * sw)), np.nan)
    for ti in range(g.nh):
        for tj in range(g.nw):
            xr0 = ti * p.th + g.q_h - g.plo_h
            xc0 = tj * p.tw + g.q_w - g.plo_w
            band = np.zeros((b, rh + kth - 1, rw + ktw - 1, cin))
            for br in range(band.shape[1]):
                for bc in range(band.shape[2]):
                    if 0 <= xr0 + br < h and 0 <= xc0 + bc < wd:
                        band[:, br, bc] = x[:, xr0 + br, xc0 + bc]
            acc = sum(band[:, a:a + rh, c:c + rw] @ ws[a, c]
                      for a in range(kth) for c in range(ktw))
            for pr in range(rh):
                for pc in range(rw):
                    for ch in range(nc):
                        oc, ph = divmod(ch, sh * sw)
                        ly = pr * sh + ph // sw - g.res_h
                        lx = pc * sw + ph % sw - g.res_w
                        oy = ti * p.th * sh + ly
                        ox = tj * p.tw * sw + lx
                        if not (0 <= ly < p.th * sh and 0 <= lx < p.tw * sw
                                and oy < g.out_h and ox < g.out_w):
                            continue
                        assert np.isnan(y[0, oy, ox, oc]), "written twice"
                        r = acc[:, pr, pc, ch] + bias[oc]
                        y[:, oy, ox, oc] = {"linear": r,
                                            "relu": np.maximum(r, 0),
                                            "tanh": np.tanh(r)}[act]
    assert not np.isnan(y).any(), "output element never written"
    return y


# (x shape, w shape, stride, padding, output_padding, act, forced tile)
EMU = [
    ((2, 8, 8, 6), (5, 5, 6, 3), 2, same_deconv_pads(5, 2), 0, "relu",
     None),                                        # dcgan: q=1, r=0
    ((1, 4, 4, 8), (4, 4, 8, 4), 2, same_deconv_pads(4, 2), 0, "linear",
     None),                                        # sngan: q=0, r=1
    ((1, 7, 6, 5), (5, 5, 5, 3), 1, same_deconv_pads(5, 1), 0, "tanh",
     None),                                        # artgan d4_s1: q=2
    ((1, 5, 6, 3), (4, 4, 3, 2), 2, 0, 1, "tanh", None),   # op > pad_hi
    ((1, 5, 6, 3), (4, 4, 3, 2), 2, 1, (1, 0), "relu", None),
    ((1, 6, 7, 3), (5, 5, 3, 2), 2, ((1, 3), (0, 2)), 0, "linear",
     None),                                        # asymmetric pads
    ((2, 13, 11, 4), (5, 5, 4, 5), 2, 2, 1, "relu",
     KernelPlan(th=3, tw=2, tcin=3, tc=16)),       # ragged tiles, tcin
    ((1, 9, 10, 3), (3, 3, 3, 2), 2, 1, 1, "linear",
     KernelPlan(th=2, tw=3, tcin=2, tc=16)),       # mde-like k3/s2
]


@pytest.mark.parametrize("case", EMU, ids=[str(c[:2]) + c[5] for c in EMU])
def test_launch_geometry_emulated(case):
    sx, sw, s, pad, op, act, tile = case
    rng = np.random.RandomState(sum(sx))
    x = rng.randn(*sx).astype(np.float32)
    w = (rng.randn(*sw) / np.sqrt(np.prod(sw[:-1]))).astype(np.float32)
    bias = rng.randn(sw[-1]).astype(np.float32)
    ref = np.asarray(jsd.execute(
        jsd.plan(w.shape, s, pad, backend="xla", act=act,
                 output_padding=op).bind(jnp.asarray(w),
                                         bias=jnp.asarray(bias)),
        jnp.asarray(x)))
    tp = tsd.plan(w.shape, s, pad, backend="fused", act=act,
                  output_padding=op).bind(torch.from_numpy(w),
                                          bias=torch.from_numpy(bias))
    pads = tp.padding
    out = _emulate(x.astype(np.float64), tp.ws.double().numpy(), tp.stride,
                   bias, act, ((tp.pi[0],) * 2, (tp.pi[1],) * 2),
                   (tp.pk[0] + pads[0][0], tp.pk[1] + pads[1][0]),
                   tp.out_shape(sx[1:3]), tile)
    np.testing.assert_allclose(out, ref, **TOL)


def test_heuristic_plan_fits_and_covers():
    for net, layer in PAPER_LAYERS:
        kt = -(-layer.k // layer.s)
        oh, ow = layer.out_hw()
        geom = FusedGeom(*layer.in_hw, layer.cin, layer.cout * layer.s ** 2,
                         kt, kt, layer.s, layer.s, oh, ow, 1, 1)
        plan = heuristic_plan(geom)
        assert smem_bytes(geom, plan) <= SMEM_TARGET, (net, layer.name)
        positions = 256 // (plan.tc // 4) * 4
        assert (plan.th + 1) * (plan.tw + 1) <= positions
        assert plan.tc >= min(geom.nc, 64)


def test_wrapper_cpu_is_plain_version_and_counts_nothing():
    import repro_torch.kernels.sd_conv as K
    before = K.SD_FUSED_LAUNCHES
    x = torch.randn(1, 4, 4, 3)
    ws = torch.randn(2, 2, 3, 8)
    y = sd_fused(x, ws, 2, pad=((1, 1), (1, 1)))
    assert y.shape == (1, 10, 10, 2) and K.SD_FUSED_LAUNCHES == before
    with pytest.raises(ValueError, match="unknown act"):
        sd_fused(x, ws, 2, act="gelu")

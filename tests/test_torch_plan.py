"""The port's plans, the fused kernel's plain version and its launch
geometry, against the JAX reference.

* ``to_ocmajor`` and a bound plan's filters, element for element, vs
  ``repro.sd.plan`` (n-major and oc-major, BN scale folded);
* ``sd_fused_ref`` reached through ``ops.sd_deconv_presplit_fused`` and
  the ``torch`` backend, on all 22 paper deconv layers, vs
  ``repro.sd.execute`` on ``backend="xla"`` (f32, ``rtol=atol=1e-5``);
* the integers the CUDA kernel is handed (``gemm_launch``), checked by
  restating the kernel's implicit GEMM in numpy (``_torch_igemm``): the
  halo read as zero, every ``(m, n, k)`` product taken once over the
  tiles and splits, every output element written exactly once, with the
  reference's value; and ``gemm_plan`` on every paper layer.
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
from repro_torch.kernels import autotune as A
from repro_torch.kernels.autotune import GemmPlan
from repro_torch.kernels.sd_conv import gemm_launch, sd_fused
from _torch_igemm import gather_a, shuffle_store, split_k_product

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
# Launch geometry: the CUDA kernel's implicit GEMM, restated in numpy.
# ---------------------------------------------------------------------------

def _emulate(x, ws, s, bias, act, pad, crop, out_space, plan=None):
    """What ``csrc/sd_fused.cu`` computes, tile by tile and split by
    split, from the integers ``gemm_launch`` hands it."""
    g = gemm_launch(x.shape, ws.shape, s, pad, crop, out_space, plan)
    a = gather_a(x, ws.shape[:2], g.q_h - g.plo_h, g.q_w - g.plo_w, g.mh,
                 g.mw)
    assert a.shape == (g.geom.m, g.geom.k)
    c, _ = split_k_product(a, ws.reshape(g.geom.k, g.geom.n), g.plan)
    sh, sw = (s, s) if isinstance(s, int) else s
    return shuffle_store(c, x.shape[0], g.mh, g.mw, (sh, sw),
                         (g.res_h, g.res_w), (g.out_h, g.out_w), bias, act)


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
     GemmPlan(16, 2)),       # ragged M/N/K, split 2
    ((1, 9, 10, 3), (3, 3, 3, 2), 2, 1, 1, "linear",
     GemmPlan(16, 1)),       # mde-like k3/s2
    ((2, 9, 10, 70), (3, 3, 70, 5), 2, 1, 1, "tanh",
     GemmPlan(32, 4)),       # Cin 70: uneven splits
    ((3, 6, 5, 40), (5, 5, 40, 12), 2, 2, 1, "relu",
     GemmPlan(64, 3)),       # Cin 40, N 48 < bn
    ((1, 7, 8, 7), (4, 4, 7, 3), 2, 1, 0, "linear",
     GemmPlan(16, 7)),       # Cin 7, more splits
                                                   # than k-tiles
    ((3, 9, 10, 12), (5, 5, 12, 8), 2, 2, 1, "relu",
     GemmPlan(32, 3)),       # 5 ragged row tiles
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
                  output_padding=op, tile=tile).bind(
                      torch.from_numpy(w), bias=torch.from_numpy(bias))
    pads = tp.padding
    out = _emulate(x.astype(np.float64), tp.ws.double().numpy(), tp.stride,
                   bias, act, ((tp.pi[0],) * 2, (tp.pi[1],) * 2),
                   (tp.pk[0] + pads[0][0], tp.pk[1] + pads[1][0]),
                   tp.out_shape(sx[1:3]), tp.tile)
    np.testing.assert_allclose(out, ref, **TOL)
    # the wrapper's plain version on the same launch (CPU tensors)
    got = ops.sd_deconv_presplit_fused(
        torch.from_numpy(x), tp.ws, tp.kernel, tp.stride, pads,
        output_padding=op, bias=tp.bias, act=act, plan=tile)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("batch", [4, 16])
def test_heuristic_plan_fits_and_covers(batch):
    """``gemm_plan`` gives every paper layer's forward (K1's float
    branch, f32 and bf16) a plan the kernel takes, within shared memory
    and the grid's limits, with at least one block per SM wherever the
    output tiles and the contraction allow it."""
    for net, layer in PAPER_LAYERS:
        pads = same_deconv_pads(layer.k, layer.s)
        p = tsd.plan((layer.k, layer.k, layer.cin, layer.cout), layer.s,
                     pads, backend="torch")
        kt = p.kt
        ws_shape = (*kt, layer.cin, layer.cout * p.phases)
        for dtype in ("", "bf16"):
            g = gemm_launch((batch, *layer.in_hw, layer.cin), ws_shape,
                            p.stride, tuple((q, q) for q in p.pi),
                            (p.pk[0] + pads[0][0], p.pk[1] + pads[1][0]),
                            p.out_shape(layer.in_hw), dtype=dtype)
            plan, geom = g.plan, g.geom
            assert A.gemm_smem_bytes(geom, plan) <= A.SMEM_BUDGET
            mt, nt, sp = A.gemm_grid(geom, plan)
            assert nt <= A.GRID_YZ_MAX and sp <= A.GRID_YZ_MAX
            assert plan.bn >= min(geom.n, A.GEMM_BN[-1])
            assert mt * nt * sp >= A.SMS or A.gemm_split_tiles(
                geom, plan) <= A.GEMM_MIN_SPLIT_TILES, (net, layer.name)
            # every split sums at least one k-tile
            assert (sp - 1) * A.gemm_split_tiles(geom, plan) < \
                A.gemm_k_tiles(geom), (net, layer.name)


def test_plan_types_follow_the_dtype():
    """Float launches take a GemmPlan, int8 and winograd a KernelPlan;
    the other type raises TypeError (plan, wrapper, any device)."""
    kp = A.KernelPlan(th=2, tw=2, tcin=4, tc=16)
    gp = GemmPlan(16, 1)
    with pytest.raises(TypeError, match="GemmPlan"):
        tsd.plan((4, 4, 3, 2), 2, 1, backend="fused", tile=kp)
    with pytest.raises(TypeError, match="KernelPlan"):
        tsd.plan((4, 4, 3, 2), 2, 1, backend="fused", dtype="int8", tile=gp)
    with pytest.raises(TypeError, match="KernelPlan"):
        tsd.plan((4, 4, 3, 2), 2, 1, backend="winograd", tile=gp)
    assert tsd.plan((4, 4, 3, 2), 2, 1, backend="fused", tile=gp).tile == gp
    x = torch.randn(1, 4, 4, 3)
    with pytest.raises(TypeError, match="GemmPlan"):
        sd_fused(x, torch.randn(2, 2, 3, 8), 2, plan=kp)
    import repro_torch.kernels.sd_conv as K
    with pytest.raises(TypeError, match="GemmPlan"):
        K.sd_conv(x, torch.randn(3, 3, 3, 2), plan=kp)
    xq = torch.zeros(1, 4, 4, 3, dtype=torch.int8)
    with pytest.raises(TypeError, match="KernelPlan"):
        K.sd_conv(xq, torch.zeros(3, 3, 3, 2, dtype=torch.int8), plan=gp)
    for bad in (GemmPlan(24, 1), GemmPlan(128, 1), GemmPlan(16, 0),
                GemmPlan(16, -1)):
        with pytest.raises(ValueError, match="kernel takes"):
            A.check_gemm_plan(A.GemmGeom(100, 10, 40), bad)


def test_wrapper_cpu_is_plain_version_and_counts_nothing():
    import repro_torch.kernels.sd_conv as K
    before = K.SD_FUSED_LAUNCHES
    x = torch.randn(1, 4, 4, 3)
    ws = torch.randn(2, 2, 3, 8)
    y = sd_fused(x, ws, 2, pad=((1, 1), (1, 1)))
    assert y.shape == (1, 10, 10, 2) and K.SD_FUSED_LAUNCHES == before
    with pytest.raises(ValueError, match="unknown act"):
        sd_fused(x, ws, 2, act="gelu")

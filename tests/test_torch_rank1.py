"""The port's rank-1 (1-D, WaveGAN) path against the JAX package and
against exact restatements, on the CPU.

The reference lowers every 1-D layer to an H=1 launch of its 2-D kernels
(``src/repro/kernels/ops.py`` ``sd_deconv_presplit_fused_1d`` and
``sd_deconv_presplit_wino_1d``, ``src/repro/sd/grad.py`` for the
backward); the port does the same with K1, K1's int8 branch, K4, K2 and
K3.  Here every kernel runs its plain version (CPU tensors), and:

* f32: a rank-1 ``fused`` plan (K1 lowered H=1, one launch per layer)
  and a ``torch`` plan match the reference's ``backend="xla"`` plans
  and ``native_deconv`` at the reference's forward gate 1e-5, on
  ``wavegan-dryrun``'s and full-width WaveGAN's layers at batch 2 and on
  ``op > pad_hi`` and asymmetric-pad geometries; K1's implicit GEMM at
  H=1 restated tile by tile (forced ``GemmPlan``s, split-K) matches too;
  the models match the reference's ``native`` model at 1e-4;
* winograd: K4 lowered H=1 (alphas ``(1, alpha)``) and its blocking
  restated match the reference's ``native_deconv`` within
  ``tolerance(K_T)``; full WaveGAN's 7-tap layers raise the reference's
  ``ValueError`` in both packages;
* int8: K1 int8 lowered H=1 equals an int64 numpy restatement exactly
  (dynamic rows and a static row, f32 and int8 out), rank-1 ``fused``
  int8 plans equal the ``torch`` int8 backend exactly (dynamic and
  calibrated, chained codes included) and the reference's int8 xla path
  within 1e-3 (f32 out) or 1 code (chained, caveat (b));
* gradients: ``sd.conv_transpose`` on a rank-1 ``fused`` plan (one K2
  and one K3 call, H=1) matches ``jax.grad`` of the reference's xla
  ``conv_transpose`` at 1e-4, and full WaveGAN's ``J_G^T c`` on
  ``fused`` matches the ``torch`` backend's;
* serving: ``GenServer`` serves ``wavegan-dryrun`` and full-width
  WaveGAN in f32, dynamic and calibrated int8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sd as jsd
from repro.core import quant as jq
from repro.core.deconv import native_deconv as j_native
from repro.launch.serve_gen import reduced_specs as j_reduced_specs
from repro.models.generative import GenerativeModel as JModel
import repro_torch.kernels.sd_conv as K
import repro_torch.sd as tsd
from repro_torch.convert import params_from_numpy
from repro_torch.core.accounting import WORKLOADS
from repro_torch.core.deconv import same_deconv_pads
from repro_torch.kernels import ops
from repro_torch.kernels import winograd as W
from repro_torch.kernels.autotune import GEMM_BN, GemmPlan, WinoPlan
from repro_torch.launch.serve_gen import (GenServer, main, reduced_specs,
                                          serve_async)
from repro_torch.models.generative import GenerativeModel, build
from test_torch_plan import _emulate
from test_torch_quant import _emulate_int8
from test_torch_winograd import _k4_restated

F32 = dict(rtol=1e-5, atol=1e-5)        # the reference's forward gate
MODEL = dict(rtol=1e-4, atol=1e-4)      # tests/test_sd_nd.py:281-297
INT8_REF = dict(rtol=1e-3, atol=1e-3)   # vs the reference's int8 xla path


def _layers(name):
    return {l.name: l for l in WORKLOADS[name]().deconv_layers()} \
        if name in WORKLOADS else \
        {l.name: l for l in reduced_specs()[name].deconv_layers()}


# (kernel, stride, padding, output_padding, x shape, Cout)
def _spec_case(l, batch=2):
    return (l.k, l.s, "same", 0, (batch, *l.in_hw, l.cin), l.cout)


CASES = {
    **{f"wavegan/{n}": _spec_case(l) for n, l in _layers("wavegan").items()},
    **{f"wavegan-dryrun/{n}": _spec_case(l)
       for n, l in _layers("wavegan-dryrun").items()},
    # tests/test_torch_grad.py's 1-D geometries: op > pad_hi, stride 3
    "k5s2p1": (5, 2, 1, 0, (2, 9, 3), 2),
    "k5s3p1op2": (5, 3, 1, 2, (1, 10, 3), 2),
    "k9s2asym": (9, 2, (3, 5), 1, (2, 7, 5), 3),
}
WINO = ["wavegan-dryrun/up1", "wavegan-dryrun/to_audio", "k5s2p1",
        "k5s3p1op2", "k9s2asym", "k9s2p3"]
CASES["k9s2p3"] = (9, 2, 3, 0, (2, 11, 3), 4)      # tests/test_winograd.py:167
CASES["k17s4"] = (17, 4, "same", 0, (2, 64, 8), 4)  # 5 taps at s 4
WINO.append("k17s4")


def _case_data(name, seed=0):
    k, s, pad, op, sx, cout = CASES[name]
    pad = same_deconv_pads((k,), (s,)) if pad == "same" else pad
    rng = np.random.RandomState(seed + sum(sx))
    x = rng.randn(*sx).astype(np.float32)
    w = (rng.randn(k, sx[-1], cout) / np.sqrt(k * sx[-1])).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(cout)).astype(np.float32)
    bias = (0.1 * rng.randn(cout)).astype(np.float32)
    return x, w, scale, bias, k, s, pad, op


def _count(monkeypatch, name):
    """Count calls of ``ops.<name>`` and record each call's input shape."""
    calls = []
    real = getattr(ops, name)

    def counted(*a, **kw):
        calls.append((tuple(a[0].shape), a[0].dtype))
        return real(*a, **kw)

    monkeypatch.setattr(ops, name, counted)
    return calls


def _reference(x, w, scale, bias, s, pad, op, act="relu"):
    """The reference's xla plan and ``native_deconv`` + BN + act."""
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    xla = np.asarray(jsd.execute(
        jsd.plan(w.shape, s, pad, backend="xla", act=act,
                 output_padding=op).bind(jw, jnp.asarray(scale),
                                         jnp.asarray(bias)), jx))
    nat = np.asarray(j_native(jx, jw, s, pad, output_padding=op)) \
        * scale + bias
    return xla, {"relu": lambda v: np.maximum(v, 0), "linear": lambda v: v,
                 "tanh": np.tanh}[act](nat)


# ---------------------------------------------------------------------------
# f32: K1 as an H=1 launch.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_fused_1d_matches_reference_xla_and_native(name, monkeypatch):
    x, w, scale, bias, k, s, pad, op = _case_data(name)
    xla, nat = _reference(x, w, scale, bias, s, pad, op)
    args = (torch.from_numpy(w), torch.from_numpy(scale),
            torch.from_numpy(bias))
    pf = tsd.plan(w.shape, s, pad, backend="fused", act="relu",
                  output_padding=op).bind(*args)
    pt = tsd.plan(w.shape, s, pad, backend="torch", act="relu",
                  output_padding=op).bind(*args)
    assert (pf.rank, pf.layout, pt.layout) == (1, "ocmajor", "nmajor")
    calls = _count(monkeypatch, "sd_fused")
    got = tsd.execute(pf, torch.from_numpy(x)).numpy()
    # one K1 launch, H=1: (B, 1, L, Cin)
    assert calls == [((x.shape[0], 1, *x.shape[1:]), torch.float32)]
    assert got.shape == xla.shape == nat.shape
    np.testing.assert_allclose(got, xla, **F32)
    np.testing.assert_allclose(got, nat, **F32)
    np.testing.assert_allclose(tsd.execute(pt, torch.from_numpy(x)).numpy(),
                               xla, **F32)


# K1's implicit GEMM at H=1 on WaveGAN's three layers and odd geometries,
# on the default plan and forced ones (every column tile; split-K with an
# uneven last split).
EMU = [(n, None) for n in ("wavegan/up1", "wavegan/up2", "wavegan/to_audio",
                           "k5s3p1op2", "k9s2asym")] + \
    [("wavegan/up1", GemmPlan(bn, sp)) for bn in GEMM_BN for sp in (1, 3)] + \
    [("wavegan/to_audio", GemmPlan(16, 2)), ("k9s2asym", GemmPlan(32, 2))]


@pytest.mark.parametrize("case", EMU, ids=[f"{n}-{p}" for n, p in EMU])
def test_k1_h1_launch_geometry_emulated(case):
    name, tile = case
    x, w, scale, bias, k, s, pad, op = _case_data(name, seed=1)
    xla, _ = _reference(x, w, np.ones_like(scale), bias, s, pad, op, "tanh")
    p = tsd.plan(w.shape, s, pad, backend="fused", act="tanh",
                 output_padding=op, tile=tile).bind(
                     torch.from_numpy(w), bias=torch.from_numpy(bias))
    ws2 = p.ws[None]                          # (1, KT, Cin, Cout*s)
    out = _emulate(x[:, None].astype(np.float64), ws2.double().numpy(),
                   (1, s), bias, "tanh", ((0, 0), (p.pi[0],) * 2),
                   (0, p.pk[0] + p.padding[0][0]),
                   (1, p.out_shape(x.shape[1:2])[0]), tile)
    np.testing.assert_allclose(out[:, 0], xla, **F32)
    got = ops.sd_deconv_presplit_fused_1d(
        torch.from_numpy(x), p.ws, p.kernel, p.stride, p.padding,
        output_padding=op, bias=p.bias, act="tanh", plan=tile)
    np.testing.assert_allclose(got.numpy(), xla, **F32)


def test_fold_scale_ocmajor_at_rank_1():
    """The engine's BN-scale fold on oc-major filters repeats each scale
    over the ``s`` phases of its channel (``c = oc*s + phase``): the same
    filters as folding on n-major ones (tiled) and then relaying."""
    from repro_torch.engine import fold_scale_ocmajor
    rng = np.random.RandomState(13)
    ws = torch.from_numpy(rng.randn(7, 5, 3 * 4).astype(np.float32))
    scale = torch.from_numpy(rng.rand(3).astype(np.float32) + 0.5)
    got = fold_scale_ocmajor(tsd.to_ocmajor(ws, 4), scale, 4)
    assert torch.equal(got, tsd.to_ocmajor(ws * scale.tile(4), 4))


def test_fused_1d_views_and_empty_output():
    """The H=1 views of a contiguous input and of the kernel's contiguous
    (B, 1, L, C) output are contiguous (the card's wrapper takes them as
    they are: no copy on the hot path), and a zero-length output
    launches nothing."""
    x = torch.randn(3, 5, 4)
    assert x[:, None].is_contiguous()
    assert torch.empty(3, 1, 14, 2).to(torch.int8)[:, 0].is_contiguous()
    ws = torch.randn(2, 4, 6)
    y = ops.sd_deconv_presplit_fused_1d(x, ws, 4, 3, 1)
    assert y.shape == (3, 14, 2)
    e = ops.sd_deconv_presplit_fused_1d(x[:, :1], ws, 4, 3, 2)
    assert e.shape == (3, 0, 2)
    q = torch.zeros((3, 1, 4), dtype=torch.int8)
    e = ops.sd_deconv_presplit_fused_1d(
        q, ws.to(torch.int8), 4, 3, 2, scale=torch.ones(1, 6),
        out_dtype=torch.int8)
    assert e.shape == (3, 0, 2) and e.dtype == torch.int8


# ---------------------------------------------------------------------------
# Winograd: K4 as an H=1 launch.
# ---------------------------------------------------------------------------

def _rel_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", WINO)
def test_wino_1d_matches_reference_native(name, monkeypatch):
    x, w, scale, bias, k, s, pad, op = _case_data(name, seed=2)
    _, nat = _reference(x, w, scale, bias, s, pad, op)
    p = tsd.plan(w.shape, s, pad, backend="winograd", act="relu",
                 output_padding=op).bind(torch.from_numpy(w),
                                         torch.from_numpy(scale),
                                         torch.from_numpy(bias))
    kt = p.kt[0]
    assert p.layout == "wino" and p.ws.shape[0] == W.output_tile(kt) + kt - 1
    calls = _count(monkeypatch, "sd_wino")
    got = tsd.execute(p, torch.from_numpy(x)).numpy()
    assert calls == [((x.shape[0], 1, *x.shape[1:]), torch.float32)]
    assert got.shape == nat.shape
    assert _rel_err(got, nat) <= W.tolerance((kt,))
    # the unbound form (conv_transpose) transforms the split filters
    y = tsd.conv_transpose(
        tsd.plan(w.shape, s, pad, backend="winograd", output_padding=op),
        torch.from_numpy(x), torch.from_numpy(w))
    assert _rel_err(y.detach().numpy(), np.asarray(j_native(
        jnp.asarray(x), jnp.asarray(w), s, pad, output_padding=op))) \
        <= W.tolerance((kt,))


WINO_EMU = [("wavegan-dryrun/up1", None), ("k17s4", None),
            ("k9s2asym", WinoPlan(nth=1, ntw=3, nb=2, tc=16)),
            ("k5s3p1op2", None)]


@pytest.mark.parametrize("case", WINO_EMU, ids=[n for n, _ in WINO_EMU])
def test_k4_h1_launch_geometry_emulated(case):
    """K4's blocking at H=1 (alphas ``(1, alpha)``: F(1,1) on the unit
    axis) restated block by block equals ``sd_wino_ref`` and stays within
    ``tolerance(K_T)`` of the reference's native deconv; the default plan
    puts one tile row in a band."""
    name, tile = case
    x, w, scale, bias, k, s, pad, op = _case_data(name, seed=3)
    p = tsd.plan(w.shape, s, pad, backend="winograd", act="linear",
                 output_padding=op, tile=tile).bind(
                     torch.from_numpy(w), bias=torch.from_numpy(bias))
    u = p.ws[None]
    kt = (1, p.kt[0])
    geo = dict(pad=((0, 0), (p.pi[0],) * 2),
               crop=(0, p.pk[0] + p.padding[0][0]),
               out_space=(1, p.out_shape(x.shape[1:2])[0]))
    out, g = _k4_restated(x[:, None], u.numpy(), kt, (1, s), bias,
                          "linear", geo["pad"], geo["crop"],
                          geo["out_space"], tile)
    assert g.geom.alphas == u.shape[0] * u.shape[1] == W.output_tile(
        kt[1]) + kt[1] - 1
    if tile is None:
        assert g.plan.nth == 1
    ref = W.sd_wino_ref(torch.from_numpy(x[:, None]), u, kt, (1, s),
                        bias=torch.from_numpy(bias), **geo).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    nat = np.asarray(j_native(jnp.asarray(x), jnp.asarray(w), s, pad,
                              output_padding=op)) + bias
    assert _rel_err(out[:, 0], nat) <= W.tolerance(kt)


def test_full_wavegan_refused_on_winograd_in_both_packages():
    for l in _layers("wavegan").values():
        shape = (l.k, l.cin, l.cout)
        pad = same_deconv_pads((l.k,), (l.s,))
        with pytest.raises(ValueError, match="winograd backend does not"):
            tsd.plan(shape, l.s, pad, backend="winograd")
        with pytest.raises(ValueError, match="winograd backend does not"):
            jsd.plan(shape, l.s, pad, backend="winograd")
    m = build("wavegan", "sd_kernel", engine_backend="winograd",
              device="cpu")
    with pytest.raises(ValueError, match="winograd backend does not"):
        m.init(torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# int8: K1 int8 as an H=1 launch.
# ---------------------------------------------------------------------------

def _np_k1_int8_1d(xq, ws_oc, s, pad, crop, out_len, comb, bias, act,
                   out_int8):
    """K1 int8's 1-D deconv restated in numpy: int64 tap sums over the
    zero-padded input, one f32 cast, ``* comb`` per oc-major phase
    channel (a (1, NC) row broadcasts), the ``c = oc*s + phase``
    interleave, crop (zero-extended), ``+ bias`` in f32, act, and for
    int8 out ``rint`` (half to even) and a clamp to +-127."""
    xp = np.pad(xq.astype(np.int64), ((0, 0), pad, (0, 0)))
    kt, _, nc = ws_oc.shape
    lc = xp.shape[1] - kt + 1
    acc = np.zeros((xq.shape[0], lc, nc), np.int64)
    for a in range(kt):
        acc += xp[:, a:a + lc] @ ws_oc[a].astype(np.int64)
    assert np.abs(acc).max() < 2 ** 31
    y = acc.astype(np.float32) * comb[:, None, :]
    b, cout = y.shape[0], nc // s
    y = y.reshape(b, lc, cout, s).transpose(0, 1, 3, 2).reshape(b, lc * s,
                                                                cout)
    out = np.zeros((b, out_len, cout), np.float32)
    src = y[:, crop:crop + out_len]
    out[:, :src.shape[1]] = src
    out = out + bias
    if act == "relu":
        out = np.maximum(out, np.float32(0))
    if out_int8:
        return np.clip(np.rint(out), -127, 127).astype(np.int8)
    return out


INT8 = ["wavegan/up1", "wavegan/up2", "wavegan/to_audio", "k5s3p1op2",
        "k9s2asym"]


@pytest.mark.parametrize("row", ["dynamic", "static"])
@pytest.mark.parametrize("name", INT8)
def test_k1_int8_h1_equals_int64(name, row):
    """The plain version through the H=1 lowering and K1 int8's GEMM
    restated at H=1 (``_emulate_int8``) both equal the int64 restatement:
    f32 out with per-sample rows (or a static row), and int8 out (relu,
    codes at +-127)."""
    k, s, pad, op, sx, cout = CASES[name]
    pad = same_deconv_pads((k,), (s,)) if pad == "same" else pad
    p = tsd.plan((k, sx[-1], cout), s, pad, backend="fused",
                 output_padding=op)
    rng = np.random.RandomState(sum(sx) + len(row))
    xq = rng.randint(-127, 128, size=sx).astype(np.int8)
    ws = rng.randint(-127, 128, size=(p.kt[0], sx[-1], cout * s)
                     ).astype(np.int8)
    xq.flat[::7] = 127
    ws.flat[::5] = -127
    rows = 1 if row == "static" else sx[0]
    comb = (rng.rand(rows, ws.shape[-1]) * 2e-4).astype(np.float32)
    bias = (rng.randn(cout) * 0.5).astype(np.float32)
    crop, out_len = p.pk[0] + p.padding[0][0], p.out_shape(sx[1:2])[0]
    geo = dict(pad=((0, 0), (p.pi[0],) * 2), crop=(0, crop),
               out_space=(1, out_len))
    for act, out_int8, c in (("linear", False, comb),
                             ("relu", True, comb * 200)):
        want = _np_k1_int8_1d(xq, ws, s, (p.pi[0],) * 2, crop, out_len, c,
                              bias, act, out_int8)
        before = K.SD_FUSED_INT8_LAUNCHES
        got = ops.sd_deconv_presplit_fused_1d(
            torch.from_numpy(xq), torch.from_numpy(ws), k, s, pad,
            output_padding=op, bias=torch.from_numpy(bias), act=act,
            scale=torch.from_numpy(c),
            out_dtype=torch.int8 if out_int8 else None)
        assert K.SD_FUSED_INT8_LAUNCHES == before          # plain version
        np.testing.assert_array_equal(got.numpy(), want)
        emu = _emulate_int8(xq[:, None], ws[None], c, (1, s), bias, act,
                            plan=GemmPlan(16, 3), out_int8=out_int8, **geo)
        np.testing.assert_array_equal(emu[:, 0], want)
        if out_int8:
            assert (np.abs(want) == 127).any()


@pytest.mark.parametrize("name", INT8)
def test_fused_1d_int8_exact_vs_torch_and_close_to_reference(name,
                                                             monkeypatch):
    """Dynamic int8: a rank-1 ``fused`` plan binds oc-major codes and an
    oc-major ``wscale`` (the relayout of the torch plan's), equals the
    int8 ``torch`` backend exactly in one K1-int8 call, and the
    reference's int8 xla path at 1e-3."""
    x, w, scale, bias, k, s, pad, op = _case_data(name, seed=4)
    kw = dict(act="tanh", output_padding=op, dtype="int8")
    args = (torch.from_numpy(w), torch.from_numpy(scale),
            torch.from_numpy(bias))
    pf = tsd.plan(w.shape, s, pad, backend="fused", **kw).bind(*args)
    pt = tsd.plan(w.shape, s, pad, backend="torch", **kw).bind(*args)
    assert (pf.layout, pt.layout) == ("ocmajor", "nmajor")
    assert torch.equal(pf.ws, tsd.to_ocmajor(pt.ws, s))
    assert torch.equal(pf.wscale, pt.wscale.reshape(s, -1).t().reshape(-1))
    calls = _count(monkeypatch, "sd_fused")
    got = tsd.execute(pf, torch.from_numpy(x))
    assert calls == [((x.shape[0], 1, *x.shape[1:]), torch.int8)]
    assert torch.equal(got, tsd.execute(pt, torch.from_numpy(x)))
    ref = np.asarray(jsd.execute(
        jsd.plan(w.shape, s, pad, backend="xla", **kw).bind(
            *(jnp.asarray(a) for a in (w, scale, bias))), jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, **INT8_REF)


@pytest.mark.parametrize("name", ["wavegan/up1", "wavegan/up2",
                                  "wavegan-dryrun/up1", "k9s2asym"])
def test_chained_1d_layer_codes(name):
    """Calibrated and chained (static row, relu, int8 out) at rank 1: the
    fused and torch backends write the same codes, within 1 code of the
    reference's xla (caveat (b)), with saturated codes."""
    x, w, scale, bias, k, s, pad, op = _case_data(name, seed=5)
    sx_in = jq.scale_from_amax(np.abs(x).max())
    jp = jsd.plan(w.shape, s, pad, backend="xla", act="relu",
                  output_padding=op, dtype="int8").bind(
                      jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias))
    y = np.asarray(jsd.execute(jp.with_chain(sx_in=sx_in), jnp.asarray(x)))
    sx_out = 0.6 * jq.scale_from_amax(np.abs(y).max())
    kw = dict(sx_in=sx_in, sx_out=sx_out, chain_out=True)
    ref = np.asarray(jsd.execute(jp.with_chain(**kw), jnp.asarray(x)))
    got = [tsd.execute(tsd.plan(w.shape, s, pad, backend=b, act="relu",
                                output_padding=op, dtype="int8").bind(
                           torch.from_numpy(w), torch.from_numpy(scale),
                           torch.from_numpy(bias)).with_chain(**kw),
                       torch.from_numpy(x)) for b in ("torch", "fused")]
    assert got[0].dtype == got[1].dtype == torch.int8
    assert torch.equal(got[0], got[1])
    d = np.abs(got[1].numpy().astype(int) - ref.astype(int))
    assert d.max() <= 1 and (np.abs(ref) == 127).any()
    # the chained codes feed the next layer as they are (no copy)
    q = got[1]
    assert q.is_contiguous() and q[:, None].is_contiguous()


# ---------------------------------------------------------------------------
# Gradients: K2 and K3 as H=1 launches.
# ---------------------------------------------------------------------------

GRAD = ["wavegan/up1", "wavegan/up2", "wavegan/to_audio",
        "wavegan-dryrun/up1", "k5s2p1", "k5s3p1op2", "k9s2asym"]


@pytest.mark.parametrize("name", GRAD)
def test_fused_1d_conv_transpose_grads_match_reference(name, monkeypatch):
    x, w, scale, bias, k, s, pad, op = _case_data(name, seed=6)
    jp = jsd.plan(w.shape, s, pad, backend="xla", output_padding=op)
    y0 = jsd.conv_transpose(jp, jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(bias))
    c = np.random.RandomState(7).randn(*y0.shape).astype(np.float32)

    def loss(xa, wa, ba):
        return jnp.sum(jsd.conv_transpose(jp, xa, wa, ba) * c)

    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(bias))
    k2, k3 = _count(monkeypatch, "sd_conv"), _count(monkeypatch,
                                                    "sd_filter_grad")
    tp = tsd.plan(w.shape, s, pad, backend="fused", output_padding=op)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, bias))
    y = tsd.conv_transpose(tp, xt, wt, bt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y0), **F32)
    (y * torch.from_numpy(c)).sum().backward()
    # dx: one K2 on dy1 (B, 1, O1, N*Co); dw: one K3 on x (B, 1, L, Cin)
    assert [sh[:2] for sh, _ in k2] == [(x.shape[0], 1)]
    assert k3 == [((x.shape[0], 1, *x.shape[1:]), torch.float32)]
    for got, ref in zip((xt.grad, wt.grad, bt.grad), jg):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_full_wavegan_generator_grads_fused_vs_torch():
    """``J_G^T c`` of full-width WaveGAN (batch 2, the cotangent ``c``
    fixed): the fused backend's K1 forward and K2 + K3 backward against
    the torch backend's, each leaf within 1e-4 of its max|ref|."""
    grads = {}
    params0 = GenerativeModel(WORKLOADS["wavegan"](), "sd", device="cpu") \
        .init(torch.Generator().manual_seed(8))
    z = torch.randn(2, 100, generator=torch.Generator().manual_seed(9))
    c = torch.randn(2, 1024, 1, generator=torch.Generator().manual_seed(10))
    for backend in ("fused", "torch"):
        m = build("wavegan", "sd_kernel", engine_backend=backend,
                  device="cpu")
        params = {k: {n: t.clone().requires_grad_() for n, t in v.items()}
                  for k, v in params0.items()}
        y = m.apply(params, z)
        assert y.shape == (2, 1024, 1)
        (y * c).sum().backward()
        grads[backend] = {(k, n): t.grad for k, v in params.items()
                          for n, t in v.items()}
    for key, ref in grads["torch"].items():
        got = grads["fused"][key]
        tol = 1e-4 * max(float(ref.abs().max()), 1e-30)
        assert float((got - ref).abs().max()) <= tol, key


# ---------------------------------------------------------------------------
# Models and servers.
# ---------------------------------------------------------------------------

def _reference_model(name, n=2, dtype="native", impl="sd_kernel",
                     backend="xla"):
    if name in WORKLOADS:
        from repro.core.accounting import WORKLOADS as J_WORKLOADS
        spec = J_WORKLOADS[name]()
    else:
        spec = j_reduced_specs()[name]
    jm = JModel(spec, impl, engine_backend=backend, engine_dtype=dtype) \
        if impl == "sd_kernel" else JModel(spec, impl)
    jp = jm.init(jax.random.PRNGKey(0))
    z = np.random.RandomState(11).randn(n, spec.layers[0].cin).astype(
        np.float32)
    return jm, jp, z


def _port_model(name, backend, dtype="native"):
    spec = WORKLOADS[name]() if name in WORKLOADS else reduced_specs()[name]
    return GenerativeModel(spec, "sd_kernel", engine_backend=backend,
                           device="cpu", engine_dtype=dtype)


# full WaveGAN's 7 taps are outside K4's envelope (refused above)
MODELS = [("wavegan", "fused"), ("wavegan", "torch"),
          ("wavegan-dryrun", "fused"), ("wavegan-dryrun", "torch"),
          ("wavegan-dryrun", "winograd")]


@pytest.mark.parametrize("name,backend", MODELS,
                         ids=[f"{n}-{b}" for n, b in MODELS])
def test_wavegan_model_matches_reference_native(name, backend):
    jm, jp, z = _reference_model(name, impl="native")
    ref = np.asarray(jm.apply(jp, jnp.asarray(z)))
    m = _port_model(name, backend)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu", spec=m.spec)
    with torch.no_grad():
        got = m.apply(params, torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape
    if backend == "winograd":       # 5-tap layers, plus the model's tanh
        assert _rel_err(got, ref) <= W.tolerance((5,))
    else:
        np.testing.assert_allclose(got, ref, **MODEL)


@pytest.mark.parametrize("name", ["wavegan", "wavegan-dryrun"])
def test_wavegan_int8_models_match_reference(name, tmp_path, monkeypatch):
    """Dynamic and calibrated int8 WaveGAN: fused equals the torch backend
    exactly and the reference's int8 xla model within 1e-3 of max|ref|
    (dynamic; caveat (b)) or within the chained band (calibrated)."""
    monkeypatch.setenv("REPRO_TORCH_SD_CALIB_CACHE",
                       str(tmp_path / "sd_calib.json"))
    jm, jp, z = _reference_model(name, n=3, dtype="int8")
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    z_cal = np.random.RandomState(12).randn(16, z.shape[1]).astype(
        np.float32)
    for calibrated in (False, True):
        if calibrated:
            want = jm.calibrate(jp, latents=jnp.asarray(z_cal))
        ref = np.asarray(jm.apply(jp, jnp.asarray(z)))
        outs, scales = {}, None
        for backend in ("torch", "fused"):
            m = _port_model(name, backend, "int8")
            params = params_from_numpy(np_params, "cpu", spec=m.spec)
            if calibrated:
                # each backend's float forward gives the statistics; the
                # torch model's scales are installed on both, so that
                # the two int8 runs see the same static scales
                got = m.calibrate(params, latents=torch.from_numpy(z_cal))
                for k in want:
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
                scales = scales or got
                m.engine.set_calibration(scales)
                plans = m.engine.plans()
                assert plans["up1"].chain_out and not \
                    plans["to_audio"].chain_out
            with torch.no_grad():
                outs[backend] = m.apply(params, torch.from_numpy(z))
        assert torch.equal(outs["fused"], outs["torch"])
        got = outs["fused"].numpy()
        assert got.shape == ref.shape and np.isfinite(got).all()
        band = 1e-3 if not calibrated else 0.02
        assert np.abs(got - ref).max() <= band * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_genserver_serves_wavegan_dryrun(dtype, monkeypatch):
    spec = reduced_specs()["wavegan-dryrun"]
    server = GenServer(nets=("wavegan-dryrun",),
                       specs={"wavegan-dryrun": spec}, device="cpu",
                       max_batch=4, backend="fused",
                       dtype=torch.float32 if dtype == "float32" else "int8")
    assert server.warmup() == len(server.buckets())
    model, params = server.model("wavegan-dryrun")
    assert [(p.rank, p.backend, p.layout, p.dtype)
            for p in model.engine.plans().values()] == \
        [(1, "fused", "ocmajor", "int8" if dtype == "int8" else "native")] * 2
    reqs = server.random_requests("wavegan-dryrun", 3, seed=2)
    calls = _count(monkeypatch, "sd_fused")
    results, stats = serve_async(server, reqs)
    assert stats["served"] == 3 and stats["shed"] == 0
    assert len(calls) == 2 * stats["launches"]      # one K1 per layer
    z = torch.stack([r.latent for r in reqs] + [torch.zeros_like(
        reqs[0].latent)])
    with torch.no_grad():
        ref = model.apply(params, z)[:3]
    out = torch.stack([results[r.rid] for r in reqs])
    assert out.shape == (3, 32, 1)
    if dtype == "int8":
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out, ref, **F32)


@pytest.mark.parametrize("flags", [["--dtype", "float32"],
                                   ["--dtype", "int8"],
                                   ["--dtype", "int8", "--calib", "4"]],
                         ids=["f32", "int8", "calibrated"])
def test_serve_gen_full_width_wavegan_cpu(flags, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SD_CALIB_CACHE",
                       str(tmp_path / "sd_calib.json"))
    results, stats = main(["--nets", "wavegan", "--device", "cpu",
                           "--requests", "2", "--max-batch", "2",
                           "--backend", "fused", *flags])
    assert stats["served"] == 2 and stats["shed"] == 0
    assert stats["compile_cache"] == [f"('wavegan', 2, '{flags[1]}')"]
    out = results[0]
    assert out.shape == (1024, 1) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all()) and out.abs().max() <= 1.0


def test_winograd_dryrun_serves_wavegan(monkeypatch):
    calls = _count(monkeypatch, "sd_wino")
    results, stats = main(["--dryrun", "--device", "cpu", "--backend",
                           "winograd"])
    assert "('wavegan-dryrun', 2, 'float32')" in stats["compile_cache"]
    assert not any("voxgan" in c for c in stats["compile_cache"])
    assert sum(1 for sh, _ in calls if len(sh) == 4 and sh[1] == 1) == 2

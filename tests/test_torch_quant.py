"""The port's dynamic int8 path against the JAX package and against exact
restatements, on the CPU.

* ``core/quant``: ``quantize``/``quantize_channelwise``/``quantize_act``
  equal the reference's bit for bit (constructed ``.5`` ties included);
  the port's ``ssim`` equals the reference's to 1e-5;
* int8 ``bind``: ``ws`` and ``wscale`` equal the reference's on the same
  numpy weights, n-major (``torch``) and oc-major (``fused``);
* ``_run_presplit_int8`` on ``torch`` and on ``fused`` (K1's plain
  version here): its sums equal an int64 numpy restatement of the split
  conv exactly (unit scales, so the f32 output *is* the rounded sum), and
  its f32 outputs equal an f64 restatement of the dequant epilogue to
  ``1e-6 * max(1, max|ref|)``; on the 22 paper layers it matches the
  reference's int8 xla path at the reference's ``rtol=atol=1e-3``
  (``tests/test_quant.py``; the reference convolves f32-cast operands, so
  it is not exact);
* K1 int8 on the implicit GEMM restated in numpy from ``gemm_launch``'s
  integers (``_torch_igemm``: A gathered with a zero halo, int64 block
  products over 64-deep k-tiles and ordered splits, the scale indexed by
  the phase channel before the interleave, int8 out rounded and clamped)
  on forced ``GemmPlan``s: bn 16 over a ragged N, Cin tails, 2-3 splits;
* an int8 DCGAN (narrow, the dryrun spec) within 0.05 of max|ref| of the
  float model and SSIM >= 0.99; zero-padded bucket rows leave real
  samples bit-identical; ``serve_gen --dryrun --dtype int8`` serves; the
  wrapper's refusals.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sd as jsd
from repro.core import quant as jq
from repro.core.accounting import BENCHMARKS
from repro.core.deconv import same_deconv_pads
from repro.core.ssim import ssim as j_ssim
import repro_torch.kernels.sd_conv as K
import repro_torch.sd as tsd
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq
from repro_torch.core.deconv import sd_geometry
from repro_torch.core.ssim import ssim as t_ssim
from repro_torch.kernels import autotune as A
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import GemmPlan
from repro_torch.launch import serve_gen
from repro_torch.launch.serve_gen import GenServer, main, reduced_specs
from repro_torch.models.generative import GenerativeModel
from repro_torch.sd.functional import _run_presplit_int8
from _torch_igemm import gather_a, shuffle_store, split_k_product

PAPER_LAYERS = [(net, l) for net, fn in BENCHMARKS.items()
                for l in fn().deconv_layers()]
PAPER_IDS = [f"{net}/{l.name}" for net, l in PAPER_LAYERS]
EXACT_REL = 1e-6          # f32 epilogue vs its f64 restatement


def _gate(ref, rel=EXACT_REL):
    return rel * max(1.0, float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# core/quant and core/ssim: bit for bit against the reference.
# ---------------------------------------------------------------------------

def _ties(rng):
    """Values that land exactly on ``k + 0.5`` steps: amax 127 per sample
    (scale 1.0), so ``x / scale`` is the constructed value itself."""
    x = rng.randint(-126, 126, size=(3, 4, 5, 6)).astype(np.float32) + 0.5
    x[:, 0, 0, 0] = 127.0
    x[1, 1, 1, 1] = -127.0
    return x


QUANTIZERS = {
    "act": (jq.quantize_act, tq.quantize_act),
    "channelwise-1": (lambda a: jq.quantize_channelwise(a, -1),
                      lambda a: tq.quantize_channelwise(a, -1)),
    "channelwise0": (lambda a: jq.quantize_channelwise(a, 0),
                     lambda a: tq.quantize_channelwise(a, 0)),
    "tensor": (jq.quantize, tq.quantize),
}


@pytest.mark.parametrize("name", list(QUANTIZERS))
def test_quantizers_match_reference_bit_for_bit(name):
    jfn, tfn = QUANTIZERS[name]
    rng = np.random.RandomState(11)
    cases = [_ties(rng), np.zeros((2, 3, 3, 4), np.float32)]
    cases += [(rng.randn(3, 4, 5, 6) * 10.0 ** e).astype(np.float32)
              for e in (-4, -1, 0, 2, 5)]
    for x in cases:
        qj, sj = jfn(jnp.asarray(x))
        qt, st = tfn(torch.from_numpy(x))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_ties_round_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]])
    q, s = tq.quantize_act(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, 126]]
    assert tq.dequantize(q, s).dtype == torch.float32


def test_ssim_matches_reference():
    rng = np.random.RandomState(3)
    a = rng.uniform(-1, 1, (2, 20, 18, 3)).astype(np.float32)
    for noise in (0.0, 0.01, 0.3):
        b = (a + noise * rng.randn(*a.shape)).astype(np.float32)
        ref = float(j_ssim(jnp.asarray(a), jnp.asarray(b)))
        got = float(t_ssim(torch.from_numpy(a), torch.from_numpy(b)))
        assert abs(got - ref) <= 1e-5, (noise, got, ref)


# ---------------------------------------------------------------------------
# int8 bind against the reference's.
# ---------------------------------------------------------------------------

def _layer_data(layer, batch=1, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, *layer.in_hw, layer.cin).astype(np.float32)
    w = (rng.randn(layer.k, layer.k, layer.cin, layer.cout)
         * 0.05).astype(np.float32)
    scale = (rng.rand(layer.cout) + 0.5).astype(np.float32)
    bias = (rng.randn(layer.cout) * 0.1).astype(np.float32)
    return x, w, scale, bias


def _plans(w, s, pad, act, scale, bias, op=0, tile=None):
    """(port torch plan, port fused plan, reference xla plan, reference
    fused plan), all int8 and bound to the same numpy weights."""
    t = [tsd.plan(w.shape, s, pad, backend=b, act=act, output_padding=op,
                  tile=tile, dtype="int8").bind(
                      torch.from_numpy(w),
                      None if scale is None else torch.from_numpy(scale),
                      None if bias is None else torch.from_numpy(bias))
         for b in ("torch", "fused")]
    j = [jsd.plan(w.shape, s, pad, backend=b, act=act, output_padding=op,
                  dtype="int8").bind(
                      jnp.asarray(w),
                      None if scale is None else jnp.asarray(scale),
                      None if bias is None else jnp.asarray(bias))
         for b in ("xla", "fused")]
    return t + j


BIND_LAYERS = [PAPER_LAYERS[i] for i in (0, 1, 4, 9, 14, 21)]


@pytest.mark.parametrize("net,layer", BIND_LAYERS,
                         ids=[f"{n}/{l.name}" for n, l in BIND_LAYERS])
def test_int8_bind_matches_reference(net, layer):
    _, w, scale, bias = _layer_data(layer)
    pt, pf, jx, jf = _plans(w, layer.s, same_deconv_pads(layer.k, layer.s),
                            "relu", scale, bias)
    assert (pt.layout, pf.layout) == ("nmajor", "ocmajor")
    for port, ref in ((pt, jx), (pf, jf)):
        assert port.ws.dtype == torch.int8 and port.dtype == "int8"
        ws, rws = port.ws.numpy().astype(int), np.asarray(ref.ws).astype(int)
        # The BN fold is one f32 multiply in both packages, so the codes
        # are expected equal; were a fold to round differently and flip a
        # tie, a code could move by 1 LSB: at most 0.1% of them may.
        d = np.abs(ws - rws)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
        np.testing.assert_allclose(port.wscale.numpy(),
                                   np.asarray(ref.wscale), rtol=1e-6)


def test_plan_int8_contract():
    with pytest.raises(ValueError, match="unknown plan dtype"):
        tsd.plan((4, 4, 8, 6), 2, 1, dtype="int4")
    p = tsd.plan((4, 4, 8, 6), 2, 1, backend="torch", dtype="int8")
    with pytest.raises(ValueError, match="inference-only"):
        tsd.conv_transpose(p, torch.ones(1, 6, 6, 8), torch.ones(4, 4, 8, 6))
    with pytest.raises(ValueError, match="winograd"):
        tsd.plan((5, 5, 8, 6), 2, 2, backend="winograd", dtype="int8")
    assert p.with_chain(sx_in=0.1).sx_in.item() == np.float32(0.1)
    bound = p.bind(torch.randn(4, 4, 8, 6))
    with pytest.raises(ValueError, match="calibrated"):
        tsd.execute(bound, torch.zeros(1, 6, 6, 8, dtype=torch.int8))
    # a calibrated plan consumes int8 codes, the previous layer's output
    codes = torch.randint(-127, 128, (1, 6, 6, 8), dtype=torch.int8)
    c = bound.with_chain(sx_in=0.1)
    assert torch.equal(tsd.execute(c, codes),
                       tsd.execute(c, codes.float() * c.sx_in))


# ---------------------------------------------------------------------------
# _run_presplit_int8: exact against int64 / f64 restatements.
# ---------------------------------------------------------------------------

def _np_sd(xq, ws_n, kernel, stride, padding, op, dtype=np.int64):
    """Split deconvolution restated in numpy from n-major split filters:
    pad by ``P_I``, one stride-1 tap sum per output, pixel-shuffle with
    channel ``c = (py*sw + px)*Cout + oc``, crop ``P_K + pad_lo``
    (zero-extended past the support)."""
    kt, pk, pi = sd_geometry(kernel, stride)
    xp = np.pad(xq.astype(dtype), ((0, 0), (pi[0],) * 2, (pi[1],) * 2,
                                   (0, 0)))
    w = ws_n.astype(dtype)
    oh, ow = xp.shape[1] - kt[0] + 1, xp.shape[2] - kt[1] + 1
    y = np.zeros((xq.shape[0], oh, ow, w.shape[-1]), dtype)
    for a in range(kt[0]):
        for c in range(kt[1]):
            y += np.einsum("bhwi,io->bhwo", xp[:, a:a + oh, c:c + ow], w[a, c])
    return y, kt, pk


def _np_shuffle_crop(y, stride, pk, padding, out_space):
    sh, sw = stride
    b, hc, wc, nc = y.shape
    cout = nc // (sh * sw)
    y = y.reshape(b, hc, wc, sh, sw, cout).transpose(0, 1, 3, 2, 4, 5)
    y = y.reshape(b, hc * sh, wc * sw, cout)
    out = np.zeros((b, *out_space, cout), y.dtype)
    (plo_h, _), (plo_w, _) = padding
    h0, w0 = pk[0] + plo_h, pk[1] + plo_w
    src = y[:, h0:h0 + out_space[0], w0:w0 + out_space[1]]
    out[:, :src.shape[1], :src.shape[2]] = src
    return out


def _to_nmajor(ws_oc, phases):
    *kt, cin, nc = ws_oc.shape
    return ws_oc.reshape(*kt, cin, nc // phases, phases).swapaxes(-1, -2) \
        .reshape(*kt, cin, nc)


# (x shape, w shape, stride, padding, output_padding, act)
EXACT = [
    ((2, 8, 8, 256), (5, 5, 256, 8), 2, "same", 0, "relu"),  # sums > 2^24
    ((2, 4, 4, 64), (4, 4, 64, 6), 2, "same", 0, "linear"),
    ((1, 5, 6, 7), (4, 4, 7, 3), 2, 0, 1, "tanh"),           # Cin 7, op
    ((1, 6, 7, 5), (5, 5, 5, 2), 2, ((1, 3), (0, 2)), 0, "relu"),
]


def _pad(padv, k, s):
    return same_deconv_pads(k, s) if padv == "same" else padv


@pytest.mark.parametrize("backend", ["torch", "fused"])
@pytest.mark.parametrize("case", EXACT, ids=[str(c[:2]) for c in EXACT])
def test_run_presplit_int8_sums_equal_int64(backend, case):
    """Unit scales (each sample's amax is 127, every ``wscale`` set to 1),
    zero bias, linear: the f32 output is the int32 sum rounded once, so
    it must equal the int64 restatement's sum rounded to f32, bit for
    bit (the large layer's sums pass 2^24, where the rounding shows)."""
    sx, swh, s, padv, op, _ = case
    rng = np.random.RandomState(sum(sx))
    x = rng.randint(-127, 128, size=sx).astype(np.float32)
    x[:, 0, 0, 0] = 127.0
    w = rng.randn(*swh).astype(np.float32)
    if swh[2] == 256:        # drive the sums past 2^24
        x = (127 - rng.randint(0, 3, size=sx)).astype(np.float32)
        w = (100 + rng.randint(0, 3, size=swh)).astype(np.float32)
    pad = _pad(padv, swh[0], s)
    p = tsd.plan(swh, s, pad, backend=backend, act="linear",
                 output_padding=op, dtype="int8").bind(torch.from_numpy(w))
    p = dataclasses.replace(p, wscale=torch.ones_like(p.wscale))
    out = _run_presplit_int8(p, torch.from_numpy(x)).numpy()
    ws = p.ws.numpy()
    ws_n = ws if backend == "torch" else _to_nmajor(ws, p.phases)
    y, _, pk = _np_sd(x.astype(np.int64), ws_n, p.kernel, p.stride,
                      p.padding, op)
    ref = _np_shuffle_crop(y, p.stride, pk, p.padding,
                           p.out_shape(sx[1:3]))
    assert out.dtype == np.float32 and out.shape == ref.shape
    assert np.abs(ref).max() < 2 ** 31
    np.testing.assert_array_equal(out, ref.astype(np.float32))
    if swh[2] == 256:
        assert np.abs(ref).max() > 2 ** 24


@pytest.mark.parametrize("backend", ["torch", "fused"])
@pytest.mark.parametrize("case", EXACT, ids=[str(c[:2]) for c in EXACT])
def test_run_presplit_int8_epilogue_equals_f64(backend, case):
    """Real per-sample scales, folded-BN ``wscale``, bias and act: the f32
    output equals ``act(S * sx[b] * wscale[c] + bias)`` in f64, with ``S``
    the int64 sums and the scale applied per phase channel before the
    interleave, to ``1e-6 * max(1, max|ref|)``."""
    sx, swh, s, padv, op, act = case
    rng = np.random.RandomState(7 + sum(sx))
    x = rng.randn(*sx).astype(np.float32)
    w = (rng.randn(*swh) * 0.05).astype(np.float32)
    gamma = (rng.rand(swh[-1]) + 0.5).astype(np.float32)
    bias = (rng.randn(swh[-1]) * 0.1).astype(np.float32)
    pad = _pad(padv, swh[0], s)
    p = tsd.plan(swh, s, pad, backend=backend, act=act, output_padding=op,
                 dtype="int8").bind(torch.from_numpy(w),
                                    torch.from_numpy(gamma),
                                    torch.from_numpy(bias))
    out = _run_presplit_int8(p, torch.from_numpy(x)).numpy()
    xq, sxs = tq.quantize_act(torch.from_numpy(x))
    ws, wscale = p.ws.numpy(), p.wscale.numpy().astype(np.float64)
    if backend == "fused":
        ws = _to_nmajor(ws, p.phases)
        wscale = _to_nmajor(wscale.reshape(1, -1), p.phases).reshape(-1)
    y, _, pk = _np_sd(xq.numpy(), ws, p.kernel, p.stride, p.padding, op)
    comb = sxs.numpy().astype(np.float64)[:, None] * wscale[None, :]
    deq = y.astype(np.float64) * comb[:, None, None, :]
    ref = _np_shuffle_crop(deq, p.stride, pk, p.padding,
                           p.out_shape(sx[1:3])) + bias.astype(np.float64)
    ref = {"linear": ref, "relu": np.maximum(ref, 0),
           "tanh": np.tanh(ref)}[act]
    assert np.abs(out - ref).max() <= _gate(ref)


@pytest.mark.parametrize("wshape,s,pad,xshape", [
    ((4, 3, 2), 2, 1, (2, 9, 3)),                   # rank 1
    ((3, 4, 4, 5, 3), (1, 2, 2), 1, (2, 3, 4, 4, 5)),   # rank 3
])
def test_int8_torch_backend_ranks_1_and_3(wshape, s, pad, xshape):
    """The torch backend's exact int8 path is rank-polymorphic, like the
    reference's xla path; held at the reference's 1e-3."""
    rng = np.random.RandomState(len(wshape))
    x = rng.randn(*xshape).astype(np.float32)
    w = (rng.randn(*wshape) * 0.1).astype(np.float32)
    bias = (rng.randn(wshape[-1]) * 0.1).astype(np.float32)
    ref = np.asarray(jsd.execute(
        jsd.plan(wshape, s, pad, backend="xla", act="relu",
                 dtype="int8").bind(jnp.asarray(w), bias=jnp.asarray(bias)),
        jnp.asarray(x)))
    got = tsd.execute(tsd.plan(wshape, s, pad, backend="torch", act="relu",
                               dtype="int8").bind(
                                   torch.from_numpy(w),
                                   bias=torch.from_numpy(bias)),
                      torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("net,layer", PAPER_LAYERS, ids=PAPER_IDS)
def test_paper_layers_match_reference_int8_xla(net, layer):
    x, w, scale, bias = _layer_data(layer, batch=2, seed=4)
    pt, pf, jx, _ = _plans(w, layer.s, same_deconv_pads(layer.k, layer.s),
                           "relu", scale, bias)
    ref = np.asarray(jsd.execute(jx, jnp.asarray(x)))
    for p in (pt, pf):
        got = tsd.execute(p, torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    # the port's two backends are both exact: they agree to f32 rounding
    np.testing.assert_allclose(tsd.execute(pt, torch.from_numpy(x)).numpy(),
                               tsd.execute(pf, torch.from_numpy(x)).numpy(),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# K1's int8 branch on the implicit GEMM, restated in numpy.
# ---------------------------------------------------------------------------

def _emulate_int8(xq, ws, scale, s, bias, act, pad, crop, out_space,
                  plan=None, out_int8=False):
    """What ``csrc/sd_fused_int8.cu`` computes, from the integers
    ``gemm_launch`` hands it: A gathered from the int8 input in place
    (zero halo), the int64 product of each ``GEMM_BM x bn`` block over
    its split's 64-deep k-tiles, the splits' int32 partials summed in
    split order; then the epilogue: the exact sum rounded to f32 once,
    times the scale of phase channel ``n`` (its sample's row, or the
    static row), the interleaved, cropped store with bias and act in f32,
    and for int8 out round half to even and a clamp to +-127."""
    sh, sw = s
    g = K.gemm_launch(xq.shape, ws.shape, s, pad, crop, out_space, plan,
                      dtype="int8")
    assert g.geom.bk == A.GEMM_BK_INT8
    a = gather_a(xq, ws.shape[:2], g.q_h - g.plo_h, g.q_w - g.plo_w, g.mh,
                 g.mw)
    c, _ = split_k_product(a.astype(np.int64),
                           ws.reshape(g.geom.k, g.geom.n).astype(np.int64),
                           g.plan, bk=g.geom.bk)
    assert np.abs(c).max() < 2 ** 31           # the int32 accumulator
    row = np.arange(c.shape[0]) // (g.mh * g.mw)
    deq = c.astype(np.float32) * scale[row if scale.shape[0] > 1 else 0]
    y = shuffle_store(deq, xq.shape[0], g.mh, g.mw, s, (g.res_h, g.res_w),
                      out_space, bias, act).astype(np.float32)
    return np.clip(np.rint(y), -127, 127).astype(np.int8) if out_int8 else y


# (x shape, w shape, stride, padding, output_padding, act, forced plan)
EMU = [
    ((2, 8, 8, 12), (5, 5, 12, 3), 2, "same", 0, "relu", None),
    ((1, 5, 6, 7), (4, 4, 7, 2), 2, 0, 1, "linear",
     GemmPlan(16, 1)),      # Cin 7 (byte copies), N 8 < bn 16
    ((1, 6, 7, 5), (5, 5, 5, 2), 2, ((1, 3), (0, 2)), 0, "relu",
     GemmPlan(32, 2)),      # asymmetric pads, Cin 5, an empty split
    ((2, 13, 11, 9), (5, 5, 9, 5), 2, 2, 1, "tanh",
     GemmPlan(16, 2)),      # ragged N 20 over bn 16, K 81: 2 splits
    ((1, 7, 6, 6), (5, 5, 6, 3), 1, "same", 0, "linear",
     GemmPlan(16, 3)),      # stride 1, q = 2, K 150: 3 splits
]


@pytest.mark.parametrize("case", EMU, ids=[str(c[:2]) + c[5] for c in EMU])
def test_int8_launch_geometry_emulated(case):
    sx, swh, s, padv, op, act, tile = case
    rng = np.random.RandomState(sum(sx))
    x = rng.randn(*sx).astype(np.float32)
    w = (rng.randn(*swh) * 0.2).astype(np.float32)
    bias = (rng.randn(swh[-1]) * 0.1).astype(np.float32)
    pad = _pad(padv, swh[0], s)
    p = tsd.plan(swh, s, pad, backend="fused", act=act, output_padding=op,
                 tile=tile, dtype="int8").bind(torch.from_numpy(w),
                                               bias=torch.from_numpy(bias))
    xq, sxs = tq.quantize_act(torch.from_numpy(x))
    comb = (sxs[:, None] * p.wscale[None, :]).contiguous()
    geo = dict(pad=((p.pi[0],) * 2, (p.pi[1],) * 2),
               crop=(p.pk[0] + p.padding[0][0], p.pk[1] + p.padding[1][0]),
               out_space=p.out_shape(sx[1:3]))
    out = _emulate_int8(xq.numpy(), p.ws.numpy(), comb.numpy(), p.stride,
                        bias, act, plan=tile, **geo)
    plain = K.sd_fused_ref(xq, p.ws, p.stride, bias=p.bias, act=act,
                           scale=comb, **geo).numpy()
    if act == "tanh":      # numpy's tanh and torch's may differ in an ulp
        np.testing.assert_allclose(out, plain, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(out, plain)
    ref = np.asarray(jsd.execute(
        jsd.plan(swh, s, pad, backend="xla", act=act, output_padding=op,
                 dtype="int8").bind(jnp.asarray(w), bias=jnp.asarray(bias)),
        jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)
    if act == "tanh":      # the chained epilogue takes linear or relu
        return
    # the chained epilogue: a static row in the next layer's code units,
    # int8 out (codes saturate at +-127)
    row = (comb[:1] * 2000).contiguous()
    out = _emulate_int8(xq.numpy(), p.ws.numpy(), row.numpy(), p.stride,
                        bias * 50, act, plan=tile, out_int8=True, **geo)
    plain = K.sd_fused_ref(xq, p.ws, p.stride, bias=p.bias * 50, act=act,
                           scale=row, out_dtype=torch.int8, **geo).numpy()
    np.testing.assert_array_equal(out, plain)
    assert (np.abs(out) == 127).any()


# ---------------------------------------------------------------------------
# The wrapper's contract (checked on the CPU too).
# ---------------------------------------------------------------------------

def test_wrapper_refusals():
    xq = torch.randint(-127, 128, (2, 4, 4, 8), dtype=torch.int8)
    ws = torch.randint(-127, 128, (3, 3, 8, 12), dtype=torch.int8)
    scale = torch.rand(2, 12)
    geo = dict(pad=((2, 2), (2, 2)), crop=(1, 1), out_space=(8, 8))
    before = K.SD_FUSED_INT8_LAUNCHES
    y = K.sd_fused(xq, ws, 2, scale=scale, **geo)
    assert y.dtype == torch.float32 and y.shape == (2, 8, 8, 3)
    assert K.SD_FUSED_INT8_LAUNCHES == before        # plain version
    # a static (1, NC) row is every sample's row
    row = K.sd_fused(xq, ws, 2, scale=scale[:1], **geo)
    assert torch.equal(row, K.sd_fused(xq, ws, 2, scale=scale[:1].repeat(
        2, 1), **geo))
    # int8 out: the f32 epilogue's value, rounded half to even, clamped
    q = K.sd_fused(xq, ws, 2, scale=scale, out_dtype=torch.int8, **geo)
    assert q.dtype == torch.int8 and torch.equal(q, K.requantize(y))
    with pytest.raises(TypeError):
        K.sd_fused(xq, ws.float(), 2, scale=scale, **geo)
    with pytest.raises(TypeError):
        K.sd_fused(xq, ws, 2, scale=scale.double(), **geo)
    with pytest.raises(ValueError, match="dequant scale"):
        K.sd_fused(xq, ws, 2, **geo)
    with pytest.raises(ValueError, match=r"\(B, 12\)"):
        K.sd_fused(xq, ws, 2, scale=scale[:, :6], **geo)
    with pytest.raises(ValueError, match="scale requires"):
        K.sd_fused(xq.float(), ws.float(), 2, scale=scale, **geo)
    # Cin * KTh * KTw * 127^2 >= 2^31 would overflow the int32 sum
    big = torch.zeros((1, 3, 3, 15_000), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow"):
        K.sd_fused(big, torch.zeros((3, 3, 15_000, 4), dtype=torch.int8),
                   2, scale=torch.ones(1, 4), pad=((2, 2), (2, 2)))
    # the widest paper layer (artgan d1: Cin 1024 x 2x2 taps) fits
    K.sd_fused(torch.zeros((1, 2, 2, 1024), dtype=torch.int8),
               torch.zeros((2, 2, 1024, 4), dtype=torch.int8), 2,
               scale=torch.ones(1, 4), pad=((1, 1), (1, 1)))
    # degenerate geometry: nothing to launch, an f32 result for int8
    z = ops.sd_deconv_presplit_fused(
        torch.zeros((1, 1, 1, 8), dtype=torch.int8), ws[:, :, :, :4], (3, 3),
        2, padding=((2, 2), (2, 2)), scale=torch.ones(1, 4))
    assert z.dtype == torch.float32 and 0 in z.shape


# ---------------------------------------------------------------------------
# Models and serving.
# ---------------------------------------------------------------------------

def _models(backend):
    spec = reduced_specs()["dcgan-dryrun"]
    f32 = GenerativeModel(spec, "sd_kernel", engine_backend=backend,
                          device="cpu")
    i8 = GenerativeModel(spec, "sd_kernel", engine_backend=backend,
                         device="cpu", engine_dtype="int8")
    return f32, i8


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_int8_dcgan_close_to_float(backend):
    f32, i8 = _models(backend)
    params = f32.init(torch.Generator().manual_seed(0))
    z = torch.from_numpy(np.random.RandomState(1).randn(4, 16)
                         .astype(np.float32))
    with torch.no_grad():
        ref = f32.apply(params, z)
        got = i8.apply(params, z)
    assert i8.engine.dtype == "int8" and got.dtype == torch.float32
    d = (got - ref).abs().max().item() / ref.abs().max().item()
    assert d < 0.05, d
    assert float(t_ssim(got, ref, data_range=2.0)) >= 0.99


def test_int8_dcgan_matches_reference_model():
    """The same numpy weights through the reference's int8 xla engine and
    the port's int8 engines, at the reference's fused-vs-xla gate."""
    from repro.launch.serve_gen import reduced_spec
    from repro.models.generative import GenerativeModel as JModel
    import jax
    jm = JModel(reduced_spec(), "sd_kernel", engine_backend="xla",
                engine_dtype="int8")
    jp = jm.init(jax.random.PRNGKey(0))
    z = np.random.RandomState(5).randn(3, 16).astype(np.float32)
    ref = np.asarray(jm.apply(jp, jnp.asarray(z)))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    for backend in ("torch", "fused"):
        _, i8 = _models(backend)
        params = params_from_numpy(np_params, "cpu", spec=i8.spec)
        with torch.no_grad():
            got = i8.apply(params, torch.from_numpy(z)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_zero_padded_rows_do_not_perturb_real_samples(backend):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 4, 4, 8).astype(np.float32))
    xp = torch.cat([x, torch.zeros(2, 4, 4, 8)])
    q1, s1 = tq.quantize_act(x)
    q2, s2 = tq.quantize_act(xp)
    assert torch.equal(q1, q2[:2]) and torch.equal(s1, s2[:2])
    assert torch.equal(q2[2:], torch.zeros_like(q2[2:]))
    p = tsd.plan((4, 4, 8, 6), 2, 1, backend=backend, act="relu",
                 dtype="int8").bind(torch.randn(4, 4, 8, 6),
                                    bias=torch.randn(6))
    assert torch.equal(tsd.execute(p, x), tsd.execute(p, xp)[:2])


def test_serve_gen_dryrun_int8_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SD_CALIB_CACHE",
                       str(tmp_path / "sd_calib.json"))
    results, stats = main(["--dryrun", "--device", "cpu", "--dtype", "int8"])
    assert stats["served"] == 8 and stats["shed"] == 0
    assert stats["compile_cache"] == [
        "('dcgan-dryrun', 2, 'int8')", "('segnet-dryrun', 2, 'int8')",
        "('voxgan-dryrun', 2, 'int8')", "('wavegan-dryrun', 2, 'int8')"]
    assert results[0].dtype == torch.float32 and results[0].shape == (16, 16,
                                                                      3)
    # --calib reaches the calibrated engines (test_calib_cli serves them)
    seen = []

    class Stop(Exception):
        pass

    def stop(server, requests, **kw):
        seen.append(server)
        raise Stop

    monkeypatch.setattr(serve_gen, "serve_async", stop)
    with pytest.raises(Stop):
        main(["--dryrun", "--device", "cpu", "--dtype", "int8", "--calib",
              "8"])
    plans = seen[0].model("dcgan-dryrun")[0].engine.plans()
    assert plans["d1"].chain_out and plans["d1"].sx_out is not None
    assert plans["d2"].sx_in is not None and not plans["d2"].chain_out
    assert (tmp_path / "sd_calib.json").exists()


def test_int8_and_f32_cells_coexist():
    specs = reduced_specs()
    f32 = GenServer(nets=sorted(specs), specs=specs, device="cpu",
                    max_batch=2)
    i8 = GenServer(nets=sorted(specs), specs=specs, device="cpu",
                   max_batch=2, dtype="int8")
    assert i8.dtype == torch.float32 and i8.engine_dtype == "int8"
    assert f32.cell_key("dcgan-dryrun", 2) != i8.cell_key("dcgan-dryrun", 2)
    assert i8.cell_key("dcgan-dryrun", 2)[-1] == "int8"
    reqs = f32.random_requests("dcgan-dryrun", 2)
    a = f32.run_group("dcgan-dryrun", [r.latent for r in reqs])
    b = i8.run_group("dcgan-dryrun", [r.latent for r in reqs])
    assert a.dtype == b.dtype == torch.float32
    assert (a - b).abs().max() / a.abs().max() < 0.05
    model, _ = i8.model("dcgan-dryrun")
    assert all(p.dtype == "int8" for p in model.engine.plans().values())

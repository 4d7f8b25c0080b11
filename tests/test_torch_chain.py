"""The port's calibrated int8 chain against the JAX package and against
exact restatements, on the CPU.

* ``core/quant``'s static half: ``quantize_static``, ``amax_stat`` (both
  policies) and ``scale_from_amax`` equal ``repro.core.quant`` bit for
  bit, on ``.5`` ties, +-inf, NaN and zeros; the calibration cache
  round-trips through the port's own env var and file, never the
  reference's.
* K1 int8's plain version (what ``sd_fused`` runs for a CPU tensor) with
  a static ``(1, NC)`` scale row and int8 output equals an int64 numpy
  restatement (exact sums, one f32 cast, ``* comb``, interleave, ``+
  bias``, act, round half to even, clamp) exactly, saturated codes
  included; the 3-D lowering's static row and int8 output equal the int8
  ``torch`` backend exactly.
* Per DCGAN layer at narrow width, the port's chained codes (``torch``
  and ``fused`` backends, which agree exactly) differ by at most 1 from
  the reference's chained ``backend="xla"`` codes, which come from
  f32-cast operands (ROADMAP caveat (b)).
* ``calibrate`` returns the reference's scales to ``rtol=1e-5`` on the
  same latents; calibrated ``dcgan-dryrun`` and ``voxgan-dryrun`` match
  the reference's calibrated xla model within 0.02 of max|ref|
  (``tests/test_chain.py:159``).
* The analogues of ``tests/test_chain.py``: ``with_chain`` validation,
  only consecutive deconvs chain, a conv breaks the chain, no per-sample
  amax on a calibrated batch, bucket pad rows exact, a checkpoint swap
  keeps the calibration.

Every test writes its calibration cache under its own ``tmp_path``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sd as jsd
from repro.core import quant as jq
from repro.launch.serve_gen import reduced_specs as j_reduced_specs
from repro.models.generative import GenerativeModel as JModel
import repro_torch.kernels.sd_conv as K
import repro_torch.sd as tsd
import repro_torch.sd.functional as tfn
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq
from repro_torch.core.accounting import LayerSpec, NetworkSpec
from repro_torch.core.deconv import same_deconv_pads
from repro_torch.kernels import ops
from repro_torch.launch.serve_gen import GenServer, reduced_specs
from repro_torch.models.generative import GenerativeModel

CHAIN_BAND = 0.02     # tests/test_chain.py:159, relative to max|ref|


@pytest.fixture(autouse=True)
def calib_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "sd_calib.json")
    monkeypatch.setenv("REPRO_TORCH_SD_CALIB_CACHE", path)
    return path


def _narrow_dcgan() -> NetworkSpec:
    """DCGAN's layer structure (fc, three k5/s2 deconvs, 8 -> 64 pixels)
    at an eighth of its widths."""
    return NetworkSpec("DCGAN-narrow", [
        LayerSpec("fc", 100, 8 * 8 * 32, name="project"),
        LayerSpec("deconv", 32, 16, k=5, s=2, in_hw=(8, 8), name="d1"),
        LayerSpec("deconv", 16, 8, k=5, s=2, in_hw=(16, 16), name="d2"),
        LayerSpec("deconv", 8, 3, k=5, s=2, in_hw=(32, 32), name="d3"),
    ])


# ---------------------------------------------------------------------------
# (i) core/quant's static half: bit for bit against the reference.
# ---------------------------------------------------------------------------

def _quant_cases():
    rng = np.random.RandomState(13)
    ties = rng.randint(-126, 126, size=(3, 4, 5)).astype(np.float32) + 0.5
    special = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 127.5,
                        1e30, -1e30, np.inf, -np.inf, 0.0, -0.0],
                       np.float32)
    cases = [ties, special, np.append(special, np.nan).astype(np.float32),
             np.zeros((2, 3, 4), np.float32), np.ones(1, np.float32)]
    cases += [(rng.randn(*rng.randint(1, 9, size=3)) * 10.0 ** e)
              .astype(np.float32) for e in (-5, -2, 0, 1, 3)]
    return cases


STATIC_QUANT = {
    "quantize_static": lambda m, x, v: m.quantize_static(x, v),
    "amax_stat max": lambda m, x, v: m.amax_stat(x, "max"),
    "amax_stat pct": lambda m, x, v: m.amax_stat(x, "pct", 100 * v % 100),
    "scale_from_amax": lambda m, x, v: m.scale_from_amax(
        m.amax_stat(x, "max")),
}


@pytest.mark.parametrize("name", list(STATIC_QUANT))
def test_static_quantizers_match_reference_bit_for_bit(name):
    fn = STATIC_QUANT[name]
    # scales / percentiles: unit (ties land on .5), odd, tiny, 1/127
    for x in _quant_cases():
        for v in (1.0, 0.37, 1e-12, float(np.float32(1 / 127)), 0.999,
                  0.123):
            want = np.asarray(fn(jq, jnp.asarray(x), v))
            got = fn(tq, torch.from_numpy(x), v)
            got = np.asarray(got.numpy() if torch.is_tensor(got) else got)
            assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
            if np.isnan(want).all():
                assert np.isnan(got).all()
            else:
                assert got.tobytes() == want.tobytes(), (name, x, v)


def test_quantize_static_saturates_and_never_wraps():
    """The reference's adversarial values (tests/test_chain.py:46)."""
    adv = torch.tensor([2.0, -2.0, 1e30, -1e30, float("inf"),
                        -float("inf"), 0.0, 1.0, 1.01, float("nan")])
    q = tq.quantize_static(adv, 1.0 / tq.QMAX)
    assert q.dtype == torch.int8
    assert q.tolist() == [127, -127, 127, -127, 127, -127, 0, 127, 127, 0]
    with pytest.raises(ValueError, match="policy"):
        tq.amax_stat(adv, "mean")


# ---------------------------------------------------------------------------
# (ii) the calibration cache: the port's own env var and file.
# ---------------------------------------------------------------------------

def test_calib_cache_round_trip(calib_cache, tmp_path, monkeypatch):
    ref_path = jq.calib_cache_path()
    assert tq.calib_cache_path() == calib_cache != ref_path
    assert tq.load_calib("dcgan/max") is None            # no file yet
    assert tq.save_calib("dcgan/max", {"d1": 0.5, "d2": 0.25}) == \
        calib_cache
    tq.save_calib("voxgan/max", {"up1": 0.125})
    assert tq.load_calib("dcgan/max") == {"d1": 0.5, "d2": 0.25}
    assert tq.load_calib("voxgan/max") == {"up1": 0.125}
    assert tq.load_calib("dcgan/pct") is None
    # an explicit path wins over the env var
    other = str(tmp_path / "other.json")
    tq.save_calib("k", {"a": 1.0}, path=other)
    assert tq.load_calib("k", path=other) == {"a": 1.0}
    assert tq.load_calib("k") is None
    # a torn file reads as no cache
    with open(other, "w") as f:
        f.write("{\"scales\": ")
    assert tq.load_calib("k", path=other) is None
    # the reference's env var is not the port's; the default is under
    # ~/.cache/repro_torch
    monkeypatch.delenv("REPRO_TORCH_SD_CALIB_CACHE")
    monkeypatch.setenv("REPRO_SD_CALIB_CACHE", str(tmp_path / "ref.json"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    default = tq.calib_cache_path()
    assert default == str(
        tmp_path / "home" / ".cache" / "repro_torch" / "sd_calib.json")
    tq.save_calib("dcgan/max", {"d1": 0.5})
    assert os.path.exists(default) and default != ref_path
    assert not os.path.exists(tmp_path / "ref.json")


# ---------------------------------------------------------------------------
# (iii) K1 int8's plain version: static row and int8 output, exact.
# ---------------------------------------------------------------------------

def _np_k1_int8(xq, ws_oc, s, pad, crop, out_space, comb, bias, act,
                out_int8):
    """K1 int8 restated in numpy: int64 tap sums over the zero-padded
    input, one f32 cast, ``* comb`` per oc-major phase channel (a (1, NC)
    row broadcasts), interleave, crop (zero-extended), ``+ bias`` in f32,
    act, and for int8 output ``rint`` (half to even) and a clamp to
    +-127."""
    (plo_h, phi_h), (plo_w, phi_w) = pad
    xp = np.pad(xq.astype(np.int64), ((0, 0), (plo_h, phi_h),
                                      (plo_w, phi_w), (0, 0)))
    kth, ktw, _, nc = ws_oc.shape
    oh, ow = xp.shape[1] - kth + 1, xp.shape[2] - ktw + 1
    acc = np.zeros((xq.shape[0], oh, ow, nc), np.int64)
    for a in range(kth):
        for c in range(ktw):
            acc += np.einsum("bhwi,io->bhwo", xp[:, a:a + oh, c:c + ow],
                             ws_oc[a, c].astype(np.int64))
    assert np.abs(acc).max() < 2 ** 31
    y = acc.astype(np.float32) * comb[:, None, None, :]
    b, cout = y.shape[0], nc // (s * s)
    y = y.reshape(b, oh, ow, cout, s, s).transpose(0, 1, 4, 2, 5, 3)
    y = y.reshape(b, oh * s, ow * s, cout)
    out = np.zeros((b, *out_space, cout), np.float32)
    src = y[:, crop[0]:crop[0] + out_space[0], crop[1]:crop[1] + out_space[1]]
    out[:, :src.shape[1], :src.shape[2]] = src
    out = out + bias
    if act == "relu":
        out = np.maximum(out, np.float32(0))
    if out_int8:
        return np.clip(np.rint(out), -127, 127).astype(np.int8)
    return out


# (x shape, deconv kernel, stride, padding, Cout)
K1_CASES = [
    ((3, 8, 8, 32), 5, 2, "same", 16),          # DCGAN d1 at 1/8 width
    ((2, 5, 6, 7), 4, 2, 1, 3),                 # Cin 7
    ((1, 6, 7, 5), 5, 2, ((1, 3), (0, 2)), 2),  # asymmetric pads
]


@pytest.mark.parametrize("out_int8", [True, False], ids=["int8out", "f32out"])
@pytest.mark.parametrize("act", ["linear", "relu"])
@pytest.mark.parametrize("case", K1_CASES, ids=[str(c[0]) for c in K1_CASES])
def test_k1_int8_static_row_int8_out_equals_int64(case, act, out_int8):
    sx, k, s, padv, cout = case
    p = tsd.plan((k, k, sx[-1], cout), s,
                 same_deconv_pads(k, s) if padv == "same" else padv,
                 backend="fused", device="cpu")
    rng = np.random.RandomState(sum(sx) + len(act))
    xq = rng.randint(-127, 128, size=sx).astype(np.int8)
    ws = rng.randint(-127, 128, size=(*p.kt, sx[-1], cout * s * s)
                     ).astype(np.int8)
    # A static row in the next layer's code units: sums of ~1e4-1e5 at
    # scales of up to 4e-3 put |y| beyond 127 on part of the output.
    comb = (rng.rand(1, ws.shape[-1]) * 4e-3).astype(np.float32)
    bias = (rng.randn(cout) * 5).astype(np.float32)
    out_space = p.out_shape(sx[1:3])
    geo = dict(pad=((p.pi[0],) * 2, (p.pi[1],) * 2),
               crop=(p.pk[0] + p.padding[0][0], p.pk[1] + p.padding[1][0]),
               out_space=out_space)
    before = K.SD_FUSED_INT8_LAUNCHES
    got = K.sd_fused(torch.from_numpy(xq), torch.from_numpy(ws), s,
                     bias=torch.from_numpy(bias), act=act,
                     scale=torch.from_numpy(comb),
                     out_dtype=torch.int8 if out_int8 else None, **geo)
    assert K.SD_FUSED_INT8_LAUNCHES == before          # plain version
    want = _np_k1_int8(xq, ws, s, geo["pad"], geo["crop"], out_space, comb,
                       bias, act, out_int8)
    assert got.dtype == (torch.int8 if out_int8 else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    if out_int8:
        assert (np.abs(want) == 127).sum() > 0           # saturated codes
    # the static row reads as the same row for every sample
    full = torch.from_numpy(np.repeat(comb, sx[0], axis=0))
    again = K.sd_fused(torch.from_numpy(xq), torch.from_numpy(ws), s,
                       bias=torch.from_numpy(bias), act=act, scale=full,
                       out_dtype=torch.int8 if out_int8 else None, **geo)
    assert torch.equal(got, again)


def test_k1_int8_out_refusals():
    xq = torch.randint(-127, 128, (2, 4, 4, 8), dtype=torch.int8)
    ws = torch.randint(-127, 128, (3, 3, 8, 12), dtype=torch.int8)
    row = torch.rand(1, 12)
    geo = dict(pad=((2, 2), (2, 2)), crop=(1, 1), out_space=(8, 8))
    with pytest.raises(ValueError, match="tanh"):
        K.sd_fused(xq, ws, 2, scale=row, act="tanh", out_dtype=torch.int8,
                   **geo)
    with pytest.raises(TypeError, match="bfloat16"):
        K.sd_fused(xq, ws, 2, scale=row, out_dtype=torch.bfloat16, **geo)
    with pytest.raises(ValueError, match="rows for batch"):
        K.sd_fused(xq, ws, 2, scale=torch.rand(3, 12), **geo)
    with pytest.raises(ValueError, match="int8"):
        K.sd_fused(xq.float(), ws.float(), 2, out_dtype=torch.int8, **geo)


@pytest.mark.parametrize("act", ["linear", "relu"])
def test_fused_3d_static_row_int8_out_equals_torch_backend(act):
    """The 3-D lowering's calibrated launch (static n-major row, int8 out)
    equals the int8 torch backend's chained plan exactly, on a saturating
    scale."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 4, 4, 6).astype(np.float32)
    w = (rng.randn(4, 4, 4, 6, 4) * 0.3).astype(np.float32)
    bias = (rng.randn(4) * 0.1).astype(np.float32)
    outs = []
    for backend in ("fused", "torch"):
        p = tsd.plan(w.shape, 2, 1, backend=backend, act=act,
                     dtype="int8").bind(torch.from_numpy(w),
                                        bias=torch.from_numpy(bias))
        c = p.with_chain(sx_in=0.02, sx_out=0.004, chain_out=True)
        outs.append(tsd.execute(c, torch.from_numpy(x)))
    assert outs[0].dtype == outs[1].dtype == torch.int8
    assert torch.equal(outs[0], outs[1])
    assert int((outs[0].abs() == 127).sum()) > 0


# ---------------------------------------------------------------------------
# (iv) per DCGAN layer: chained codes within 1 of the reference's xla.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("li", [0, 1, 2], ids=["d1", "d2", "d3"])
def test_chained_layers_match_reference_xla(li):
    layers = _narrow_dcgan().deconv_layers()
    layer = layers[li]
    chain = li < 2                         # d3 is linear, f32 out
    act = "relu" if chain else "linear"
    rng = np.random.RandomState(40 + li)
    x = rng.randn(2, *layer.in_hw, layer.cin).astype(np.float32)
    w = (rng.randn(5, 5, layer.cin, layer.cout)
         / np.sqrt(25 * layer.cin)).astype(np.float32)
    gamma = (rng.rand(layer.cout) + 0.5).astype(np.float32)
    bias = (rng.randn(layer.cout) * 0.1).astype(np.float32)
    pads = same_deconv_pads(5, 2)
    sx_in = jq.scale_from_amax(np.abs(x).max())
    jp = jsd.plan(w.shape, 2, pads, backend="xla", act=act,
                  dtype="int8").bind(jnp.asarray(w), jnp.asarray(gamma),
                                     jnp.asarray(bias))
    # sx_out at 0.6 of the static f32 output's amax: the top codes
    # saturate
    y = np.asarray(jsd.execute(jp.with_chain(sx_in=sx_in), jnp.asarray(x)))
    sx_out = 0.6 * jq.scale_from_amax(np.abs(y).max())
    kw = dict(sx_in=sx_in, sx_out=sx_out if chain else None,
              chain_out=chain)
    ref = np.asarray(jsd.execute(jp.with_chain(**kw), jnp.asarray(x)))
    got = [tsd.execute(tsd.plan(w.shape, 2, pads, backend=b, act=act,
                                dtype="int8").bind(
                           torch.from_numpy(w), torch.from_numpy(gamma),
                           torch.from_numpy(bias)).with_chain(**kw),
                       torch.from_numpy(x)) for b in ("torch", "fused")]
    assert torch.equal(got[0], got[1])     # both exact, same roundings
    out = got[0].numpy()
    assert out.dtype == ref.dtype == (np.int8 if chain else np.float32)
    if chain:
        d = np.abs(out.astype(int) - ref.astype(int))
        assert d.max() <= 1 and (np.abs(out) == 127).any()
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# (v), (vi) calibration and calibrated models against the reference.
# ---------------------------------------------------------------------------

def _pair(name, backend="torch"):
    """(reference int8 xla model, its params, port int8 model, the same
    params as torch tensors) on a reduced spec."""
    jm = JModel(j_reduced_specs()[name], "sd_kernel", engine_backend="xla",
                engine_dtype="int8")
    jp = jm.init(jax.random.PRNGKey(0))
    tm = GenerativeModel(reduced_specs()[name], "sd_kernel",
                         engine_backend=backend, device="cpu",
                         engine_dtype="int8")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                           spec=tm.spec)
    return jm, jp, tm, tp


def _latents(model, n, seed):
    return np.random.RandomState(seed).randn(
        *model.input_shape(n)).astype(np.float32)


@pytest.mark.parametrize("policy", ["max", "pct"])
@pytest.mark.parametrize("name", ["dcgan-dryrun", "voxgan-dryrun",
                                  "segnet-dryrun"])
def test_calibrate_matches_reference_scales(name, policy):
    jm, jp, tm, tp = _pair(name)
    z = _latents(tm, 8, 3)
    want = jm.calibrate(jp, latents=jnp.asarray(z), policy=policy)
    got = tm.calibrate(tp, latents=torch.from_numpy(z), policy=policy)
    assert set(got) == set(want) == {l.name for l in
                                     tm.spec.deconv_layers()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


@pytest.mark.parametrize("backend", ["torch", "fused"])
@pytest.mark.parametrize("name", ["dcgan-dryrun", "voxgan-dryrun"])
def test_calibrated_model_matches_reference(name, backend):
    jm, jp, tm, tp = _pair(name, backend)
    z_cal = _latents(tm, 16, 4)
    jm.calibrate(jp, latents=jnp.asarray(z_cal))
    tm.calibrate(tp, latents=torch.from_numpy(z_cal))
    z = _latents(tm, 3, 5)
    ref = np.asarray(jm.apply(jp, jnp.asarray(z)))
    with torch.no_grad():
        got = tm.apply(tp, torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= CHAIN_BAND * np.abs(ref).max()


def test_calibration_deterministic_under_fixed_seed(calib_cache):
    spec = reduced_specs()["dcgan-dryrun"]
    m = GenerativeModel(spec, "sd_kernel", device="cpu",
                        engine_dtype="int8")
    params = m.init(torch.Generator().manual_seed(0))
    s1 = m.calibrate(params, n=8, seed=0, save_key="g/max")
    assert m.calibrate(params, n=8, seed=0) == s1
    assert set(s1) == {"d1", "d2"} and all(v > 0 for v in s1.values())
    assert m.calibrate(params, n=8, seed=1) != s1     # the seed is used
    assert tq.load_calib("g/max") == s1 and os.path.exists(calib_cache)


# ---------------------------------------------------------------------------
# (vii) the analogues of tests/test_chain.py.
# ---------------------------------------------------------------------------

def test_with_chain_validation():
    w, b = torch.ones(4, 4, 8, 6), torch.ones(6)
    pf = tsd.plan((4, 4, 8, 6), 2, 1, backend="torch").bind(w, bias=b)
    with pytest.raises(ValueError, match="int8"):
        pf.with_chain(sx_in=0.1)
    p8 = tsd.plan((4, 4, 8, 6), 2, 1, backend="torch", dtype="int8",
                  act="relu").bind(w, bias=b)
    with pytest.raises(ValueError, match="sx_out"):
        p8.with_chain(sx_in=0.1, chain_out=True)
    pt = tsd.plan((4, 4, 8, 6), 2, 1, backend="fused", dtype="int8",
                  act="tanh").bind(w, bias=b)
    with pytest.raises(ValueError, match="tanh"):
        pt.with_chain(sx_in=0.1, sx_out=0.1, chain_out=True)
    # tanh may still head a chain (static input, f32 output)
    head = pt.with_chain(sx_in=0.1)
    assert head.sx_in.dtype == torch.float32 and not head.chain_out
    assert head.sx_in.item() == np.float32(0.1)
    c = p8.with_chain(sx_in=0.1, sx_out=0.2, chain_out=True)
    assert c.chain_out and c.sx_out.item() == np.float32(0.2)


def _int8_model(spec, backend="torch"):
    m = GenerativeModel(spec, "sd_kernel", engine_backend=backend,
                        device="cpu", engine_dtype="int8")
    return m, m.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_engine_chains_consecutive_deconvs_only(backend):
    """d1 -> d2 -> d3 chain; the last deconv never chains out but
    consumes int8; each chained layer's output scale is the next one's
    input scale."""
    m, params = _int8_model(_narrow_dcgan(), backend)
    m.calibrate(params, n=4, seed=0)
    plans = m.engine.plans()
    names = [l.name for l in m.spec.deconv_layers()]
    for name in names[:-1]:
        assert plans[name].chain_out and plans[name].sx_out is not None
    last = plans[names[-1]]
    assert not last.chain_out and last.sx_out is None
    assert last.sx_in is not None
    for a, b in zip(names[:-1], names[1:]):
        assert plans[a].sx_out.item() == plans[b].sx_in.item()
    # the chained tensors are int8 between layers, f32 at the end
    seen = []
    h = torch.from_numpy(_latents(m, 2, 7))
    with torch.no_grad():
        h = (h @ params["project"]["w"] + params["project"]["b"])
        h = torch.relu(h.reshape(2, 8, 8, 32))
        for name in names:
            h = tsd.execute(plans[name], h)
            seen.append(h.dtype)
    assert seen == [torch.int8, torch.int8, torch.float32]
    # a tanh head cannot chain out: with_chain is the one check
    tanh = m.engine.layer_plan(m.spec.deconv_layers()[-1], "tanh").bind(
        params[names[-1]]["w"], bias=params[names[-1]]["b"])
    with pytest.raises(ValueError, match="chain_out cannot fold"):
        tanh.with_chain(sx_in=1.0, sx_out=1.0, chain_out=True)


def test_intervening_conv_breaks_the_chain():
    spec = NetworkSpec("chainbreak", [
        LayerSpec("fc", 16, 4 * 4 * 8, name="project"),
        LayerSpec("deconv", 8, 8, k=4, s=2, in_hw=(4, 4), name="d1"),
        LayerSpec("conv", 8, 8, k=3, s=1, in_hw=(8, 8), name="mid"),
        LayerSpec("deconv", 8, 3, k=4, s=2, in_hw=(8, 8), name="d2"),
    ])
    m, params = _int8_model(spec)
    m.calibrate(params, n=4, seed=0)
    plans = m.engine.plans()
    assert not plans["d1"].chain_out and not plans["d2"].chain_out
    assert plans["d1"].sx_in is not None and plans["d2"].sx_in is not None
    f32 = GenerativeModel(spec, "sd_kernel", engine_backend="torch",
                          device="cpu")
    x = torch.from_numpy(_latents(m, 2, 1))
    with torch.no_grad():
        ref, got = f32.apply(params, x), m.apply(params, x)
    assert (got - ref).abs().max().item() < 0.1


def test_calibrate_binds_a_never_bound_engine():
    spec = reduced_specs()["dcgan-dryrun"]
    params = GenerativeModel(spec, "native", device="cpu").init(
        torch.Generator().manual_seed(0))
    m = GenerativeModel(spec, "sd_kernel", device="cpu", engine_dtype="int8")
    m.calibrate(params, n=4, seed=0)
    plans = m.engine.plans()
    assert plans and any(p.chain_out for p in plans.values())


def test_set_calibration_rejects_float_engine():
    m = GenerativeModel(reduced_specs()["dcgan-dryrun"], "sd_kernel",
                        device="cpu")
    m.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="int8"):
        m.engine.set_calibration({"d1": 0.1})
    with pytest.raises(ValueError, match="int8"):
        m.calibrate({}, n=2)
    with pytest.raises(ValueError, match="int8"):
        GenServer(nets=("dcgan-dryrun",), specs=reduced_specs(),
                  device="cpu", calib=4)


def _count_quantize_act(monkeypatch):
    calls = []
    real = tfn.quantize_act

    def counted(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(tfn, "quantize_act", counted)
    return calls


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_no_per_sample_amax_on_a_calibrated_batch(backend, monkeypatch):
    server = GenServer(nets=("dcgan-dryrun",), specs=reduced_specs(),
                       device="cpu", backend=backend, dtype="int8",
                       max_batch=4, calib=8)
    zs = [r.latent for r in server.random_requests("dcgan-dryrun", 4)]
    calls = _count_quantize_act(monkeypatch)
    server.run_group("dcgan-dryrun", zs)
    assert calls == []
    # positive control: the dynamic path quantizes per sample per layer
    server.model("dcgan-dryrun")[0].engine.set_calibration(None)
    server.run_group("dcgan-dryrun", zs)
    assert len(calls) == 2


def test_bucket_pad_rows_exact_under_static_scales():
    server = GenServer(nets=("dcgan-dryrun",), specs=reduced_specs(),
                       device="cpu", dtype="int8", max_batch=4, calib=8)
    zs = [r.latent for r in server.random_requests("dcgan-dryrun", 2)]
    padded = server.run_group("dcgan-dryrun", zs + [torch.zeros(16)])
    assert server.bucket(3) == 4
    assert torch.equal(server.run_group("dcgan-dryrun", zs), padded[:2])


def test_chained_checkpoint_swap_keeps_calibration():
    spec = reduced_specs()["dcgan-dryrun"]
    server = GenServer(nets=("dcgan-dryrun",), specs={"dcgan-dryrun": spec},
                       device="cpu", dtype="int8", max_batch=4, calib=8)
    reqs = server.random_requests("dcgan-dryrun", 4)
    server.serve(reqs)
    assert server.compile_count == 1
    engine = server.model("dcgan-dryrun")[0].engine
    assert any(p.chain_out for p in engine.plans().values())
    new = GenerativeModel(spec, "native", device="cpu").init(
        torch.Generator().manual_seed(11))
    server.swap_checkpoint("dcgan-dryrun", new)
    swapped = engine.plans()
    assert any(p.chain_out for p in swapped.values())
    assert all(p.ws is not None for p in swapped.values())
    results, _ = server.serve(reqs)
    assert server.compile_count == 1
    with torch.no_grad():
        ref = GenerativeModel(spec, "native", device="cpu").apply(
            new, torch.stack([r.latent for r in reqs]))
    out = torch.stack([results[r.rid] for r in reqs])
    assert (out - ref).abs().max().item() < 0.1


def test_chained_lowering_keeps_out_dtype_off_the_float_path():
    """An int8-out launch of the 2-D wrapper on a degenerate geometry
    still returns int8 (nothing launched)."""
    z = ops.sd_deconv_presplit_fused(
        torch.zeros((1, 1, 1, 8), dtype=torch.int8),
        torch.zeros((3, 3, 8, 4), dtype=torch.int8), (3, 3), 2,
        padding=((2, 2), (2, 2)), scale=torch.ones(1, 4),
        out_dtype=torch.int8)
    assert z.dtype == torch.int8 and 0 in z.shape

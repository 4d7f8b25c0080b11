"""The port's measured plan cache against the reference's, on the CPU.

The port keys its cache as the reference does (``ConvGeom.key()``,
letter for letter, for every 2-D deconv layer of the paper's six nets,
``segnet`` and ``dcgan-dryrun``), so given the same measured ms per key
its ``best_algo``, per-layer backends and ``estimate_ms`` equal the
reference's.  The tiles themselves differ in kind (the reference's
``KernelPlan(th, tw, tcin, tcout)``, the port's ``GemmPlan`` /
``WinoPlan``), so each package's cache holds its own default tile.
Then the cache's own machinery: atomic round trip, the device gate,
rejected tiles falling back to the kernel's call-time default, ``tune``
on a deterministic fake runner, the launch geometry against the
wrappers', ``pretune`` on a fused CPU engine with a fake ``measure``,
and the server and CLI.  Every test points both caches at ``tmp_path``.
No Pallas kernel runs: the reference's side only keys, binds and reads
its cache.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import accounting as jacc
from repro.engine import SDEngine as JEngine
from repro.kernels import autotune as ja
from repro.launch.serve_gen import reduced_spec as j_reduced_spec
from repro.models.generative import GenerativeModel as JModel
from repro_torch.core import accounting as tacc
from repro_torch.core.deconv import same_deconv_pads
from repro_torch.engine import SDEngine
from repro_torch.kernels import autotune as A
from repro_torch.kernels import winograd as W
from repro_torch.kernels.autotune import (DeconvGeom, GemmGeom, GemmPlan,
                                          WinoGeom, WinoPlan)
from repro_torch.kernels.sd_conv import gemm_launch
from repro_torch.launch.serve_gen import GenServer, reduced_specs
from repro_torch.models.generative import GenerativeModel
from repro_torch.sd import functional as sd_functional

BATCHES = (1, 2, 4, 8, 16)
NETS = list(tacc.BENCHMARKS) + ["segnet", "dcgan-dryrun"]
RANKS_13 = ["wavegan", "voxgan"]


def _specs(net):
    """(reference spec, port spec) of one net."""
    if net == "dcgan-dryrun":
        return j_reduced_spec(), reduced_specs()["dcgan-dryrun"]
    return jacc.WORKLOADS[net](), tacc.WORKLOADS[net]()


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' plan caches in ``tmp_path``."""
    jpath, tpath = tmp_path / "ref_plans.json", tmp_path / "port_plans.json"
    monkeypatch.setenv("REPRO_SD_PLAN_CACHE", str(jpath))
    monkeypatch.setenv("REPRO_TORCH_SD_PLAN_CACHE", str(tpath))
    return str(jpath), str(tpath)


def _engines(net, dtype="native"):
    """Unbound engines of both packages on ``net``, backend fused."""
    jspec, tspec = _specs(net)
    return (JEngine(jspec, backend="fused", dtype=dtype),
            SDEngine(tspec, backend="fused", device="cpu", dtype=dtype))


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", NETS)
def test_keys_equal_reference(net):
    """Every 2-D deconv layer x b in {1, 2, 4, 8, 16} x dtype x algo x
    qout: the port's ``layer_geom(...).key()`` is the reference's."""
    jeng, teng = _engines(net)
    jlayers = [l for l in jeng.spec.layers if l.kind == "deconv"]
    tlayers = [l for l in teng.spec.layers if l.kind == "deconv"]
    assert len(jlayers) == len(tlayers) > 0
    n = 0
    for jl, tl in zip(jlayers, tlayers):
        for b in BATCHES:
            for dtype in ("native", "int8"):
                for algo in ("", "wino"):
                    for qout in (False, True):
                        jg = jeng.layer_geom(jl, b, dtype, algo, qout)
                        tg = teng.layer_geom(tl, b, dtype, algo, qout)
                        assert tg.key() == jg.key()
                        n += 1
    assert n == len(jlayers) * len(BATCHES) * 8


def test_dcgan_d1_key_at_the_serving_bucket():
    _, teng = _engines("dcgan")
    d1 = teng.spec.deconv_layers()[0]
    assert teng.layer_geom(d1, 16).key() == "b16_h12w12_ci256_co128_kt3_s2"
    assert teng.layer_geom(d1, 16, "int8", "", True).key() == \
        "b16_h12w12_ci256_co128_kt3_s2_int8_q8out"


@pytest.mark.parametrize("net", NETS)
def test_from_deconv_fields_equal_reference(net):
    """``DeconvGeom.from_deconv`` gives the reference's ``ConvGeom``
    field for field: the padded input, taps, interleave, and the final
    output and crop the launch needs."""
    jspec, tspec = _specs(net)
    for jl, tl in zip(jspec.deconv_layers(), tspec.deconv_layers()):
        pads = same_deconv_pads(tl.k, tl.s)
        for b in (1, 16):
            jg = ja.ConvGeom.from_deconv(b, *jl.in_hw, jl.cin, jl.cout,
                                         jl.k, jl.s, padding=pads)
            tg = DeconvGeom.from_deconv(b, *tl.in_hw, tl.cin, tl.cout,
                                        tl.k, tl.s, padding=pads)
            for f in dataclasses.fields(ja.ConvGeom):
                if hasattr(tg, f.name):
                    assert getattr(tg, f.name) == getattr(jg, f.name), f.name
            assert tg.key() == jg.key()
    bare = DeconvGeom.from_deconv(1, 4, 4, 8, 4, 5, 2)
    assert bare.key() == ja.ConvGeom.from_deconv(1, 4, 4, 8, 4, 5, 2).key()
    with pytest.raises(ValueError, match="crop"):
        bare.launch()


@pytest.mark.parametrize("net", RANKS_13)
def test_ranks_1_and_3_have_no_geometry(net):
    jeng, teng = _engines(net)
    for jl, tl in zip(jeng.spec.deconv_layers(), teng.spec.deconv_layers()):
        assert jeng.layer_geom(jl, 4) is None
        assert teng.layer_geom(tl, 4) is None


@pytest.mark.parametrize("net", list(tacc.BENCHMARKS))
def test_launch_equals_the_wrappers_launch(net):
    """``DeconvGeom.launch()`` is the geometry ``gemm_launch`` and
    ``wino_launch`` compute from the tensors' shapes, at every bucket, so
    a cached tile is checked against the launch it will run."""
    _, teng = _engines(net)
    for l in teng.spec.deconv_layers():
        pads = same_deconv_pads(l.k, l.s)
        plan = teng.layer_plan(l, "relu")
        kt, pk, pi = plan.kt, plan.pk, plan.pi
        pad = tuple((p, p) for p in pi)
        crop = (pk[0] + pads[0][0], pk[1] + pads[1][0])
        nc = l.cout * l.s * l.s
        for b in BATCHES:
            x_shape = (b, *l.in_hw, l.cin)
            out = plan.out_shape(l.in_hw)
            for dtype in ("", "int8"):
                g = teng.layer_geom(
                    l, b, "int8" if dtype else "native").launch()
                want = gemm_launch(x_shape, (*kt, l.cin, nc), plan.stride,
                                   pad, crop, out, dtype=dtype).geom
                assert g == want
            if W.supported(kt):
                g = teng.layer_geom(l, b, algo="wino").launch()
                want = W.wino_launch(x_shape, (*W._alphas(kt), l.cin, nc),
                                     kt, plan.stride, pad, crop, out).geom
                assert g == want


# ---------------------------------------------------------------------------
# The same measured ms: the same choices
# ---------------------------------------------------------------------------

def _ref_entry(geom, ms, backend="cpu"):
    return {**dataclasses.asdict(ja.heuristic_plan(geom)), "ms": ms,
            "source": "measured", "backend": backend}


def _port_entry(geom, ms, backend="cpu"):
    return {**dataclasses.asdict(A.default_plan(geom)), "ms": ms,
            "source": "measured", "backend": backend}


def _write_both(pairs, jpath, tpath):
    """``pairs``: [(reference geom, port geom, ms)] into both caches."""
    ja.save_cache({jg.key(): _ref_entry(jg, ms) for jg, _, ms in pairs},
                  jpath)
    A.save_cache({tg.key(): _port_entry(tg, ms) for _, tg, ms in pairs},
                 tpath)


BEST_ALGO_CASES = {"direct faster": (1.0, 2.0), "wino faster": (2.0, 1.0),
                   "equal": (1.5, 1.5), "wino missing": (1.0, None),
                   "direct missing": (None, 1.0), "both missing": (None, None)}


@pytest.mark.parametrize("case", list(BEST_ALGO_CASES))
def test_best_algo_equals_reference(case, caches):
    direct, wino = BEST_ALGO_CASES[case]
    jeng, teng = _engines("dcgan")
    pairs = []
    for jl, tl in zip(jeng.spec.deconv_layers(), teng.spec.deconv_layers()):
        for b in (1, 16):
            for algo, ms in (("", direct), ("wino", wino)):
                if ms is not None:
                    pairs.append((jeng.layer_geom(jl, b, algo=algo),
                                  teng.layer_geom(tl, b, algo=algo), ms))
    _write_both(pairs, *caches)
    want = "wino" if case == "wino faster" else ""
    for jl, tl in zip(jeng.spec.deconv_layers(), teng.spec.deconv_layers()):
        for b in (1, 16):
            jg, tg = jeng.layer_geom(jl, b), teng.layer_geom(tl, b)
            assert ja.best_algo(jg) == want
            assert A.best_algo(tg, device="cpu") == want


def _params(net):
    """(reference params, port params) of ``net`` from one seed; the
    backend choice does not depend on them."""
    jspec, tspec = _specs(net)
    jp = JModel(jspec, "native").init(jax.random.PRNGKey(0))
    tp = GenerativeModel(tspec, "native", device="cpu").init(
        torch.Generator().manual_seed(0))
    return jp, tp


def _measure_net(jeng, teng, rng, batches=(1,), dtype="native",
                 skip=()):
    """Random measured ms for both algorithms of every rank-2 layer of
    both engines, Winograd faster on the first, third, ... layer and
    slower on the others, the same in both caches; layers named in
    ``skip`` get no entry at the last batch."""
    pairs = []
    for i, (jl, tl) in enumerate(zip(jeng.spec.deconv_layers(),
                                     teng.spec.deconv_layers())):
        for b in batches:
            if b == batches[-1] and tl.name in skip:
                continue
            direct = float(rng.uniform(0.01, 2.0))
            wino = direct * float(rng.uniform(0.5, 0.9) if i % 2 == 0
                                  else rng.uniform(1.1, 1.5))
            for algo, ms in (("", direct), ("wino", wino)):
                jg = jeng.layer_geom(jl, b, dtype, algo)
                if jg is None:
                    continue
                pairs.append((jg, teng.layer_geom(tl, b, dtype, algo), ms))
    return pairs


@pytest.mark.parametrize("net", ["dcgan", "sngan"])
def test_per_layer_backends_equal_reference(net, caches):
    jeng, teng = _engines(net)
    rng = np.random.RandomState(11 if net == "dcgan" else 12)
    _write_both(_measure_net(jeng, teng, rng), *caches)
    jp, tp = _params(net)
    jeng.bind(jp)
    teng.bind(tp)
    jb = {n: p.backend for n, p in jeng.plans().items()}
    tb = {n: p.backend for n, p in teng.plans().items()}
    assert tb == {n: {"xla": "torch"}.get(b, b) for n, b in jb.items()}
    # the seed switches some layers and not others
    assert "winograd" in tb.values() and "fused" in tb.values()
    for name, plan in teng.plans().items():
        assert plan.layout == ("wino" if plan.backend == "winograd"
                               else "ocmajor")
        assert isinstance(plan.tile, WinoPlan if plan.backend == "winograd"
                          else GemmPlan)
    assert "backend=winograd" in teng.describe()


@pytest.mark.parametrize("case", ["int8 engine", "rank 3", "7 taps"])
def test_never_switches(case, caches):
    """Winograd measured faster, yet the layer stays on the direct
    kernel: int8 engines, rank-3 layers, and taps outside K4's envelope
    (k13/s2: 7 taps) — in both packages."""
    if case == "7 taps":
        jspec = jacc.NetworkSpec("wide", [
            jacc.LayerSpec("fc", 8, 4 * 4 * 8, name="project"),
            jacc.LayerSpec("deconv", 8, 4, k=13, s=2, in_hw=(4, 4),
                           name="d1")])
        tspec = tacc.NetworkSpec("wide", [
            tacc.LayerSpec("fc", 8, 4 * 4 * 8, name="project"),
            tacc.LayerSpec("deconv", 8, 4, k=13, s=2, in_hw=(4, 4),
                           name="d1")])
        jeng = JEngine(jspec, backend="fused")
        teng = SDEngine(tspec, backend="fused", device="cpu")
        jp = JModel(jspec, "native").init(jax.random.PRNGKey(0))
        tp = GenerativeModel(tspec, "native", device="cpu").init(
            torch.Generator().manual_seed(0))
        dtype = "native"
    else:
        net, dtype = (("dcgan", "int8") if case == "int8 engine"
                      else ("voxgan", "native"))
        jeng, teng = _engines(net, dtype)
        jp, tp = _params(net)
    pairs = []
    for jl, tl in zip(jeng.spec.deconv_layers(), teng.spec.deconv_layers()):
        for algo, ms in (("", 1.0), ("wino", 0.1)):
            jg = jeng.layer_geom(jl, 1, dtype, algo)
            tg = teng.layer_geom(tl, 1, dtype, algo)
            assert (jg is None) == (tg is None) == (case == "rank 3")
            if jg is not None:
                pairs.append((jg, tg, ms))
    if case != "7 taps":
        _write_both(pairs, *caches)
    else:   # the reference's heuristic_plan of a 7-tap wino geometry fits
        ja.save_cache({jg.key(): _ref_entry(jg, ms) for jg, _, ms in pairs},
                      caches[0])
        A.save_cache({tg.key(): {"nth": 1, "ntw": 1, "nb": 1, "tc": 16,
                                 "ms": ms, "source": "measured",
                                 "backend": "cpu"} if tg.algo else
                      _port_entry(tg, ms) for _, tg, ms in pairs},
                     caches[1])
    jeng.bind(jp)
    teng.bind(tp)
    assert {p.backend for p in jeng.plans().values()} == {"fused"}
    assert {p.backend for p in teng.plans().values()} == {"fused"}


@pytest.mark.parametrize("net", ["dcgan", "sngan"])
@pytest.mark.parametrize("case", ["all measured", "one missing"])
def test_estimate_ms_equals_reference(net, case, caches):
    jeng, teng = _engines(net)
    rng = np.random.RandomState(21)
    skip = ("d2",) if case == "one missing" else ()
    _write_both(_measure_net(jeng, teng, rng, batches=(1, 16), skip=skip),
                *caches)
    jp, tp = _params(net)
    jeng.bind(jp)
    teng.bind(tp)
    assert jeng.estimate_ms(1) is not None
    assert abs(teng.estimate_ms(1) - jeng.estimate_ms(1)) <= 1e-9
    if case == "one missing":
        assert jeng.estimate_ms(16) is None and teng.estimate_ms(16) is None
    else:
        assert abs(teng.estimate_ms(16) - jeng.estimate_ms(16)) <= 1e-9
    assert jeng.estimate_ms(4) is None and teng.estimate_ms(4) is None


# ---------------------------------------------------------------------------
# Cache machinery
# ---------------------------------------------------------------------------

def _d1(b=16, **kw):
    _, teng = _engines("dcgan")
    return teng.layer_geom(teng.spec.deconv_layers()[0], b, **kw)


def test_cache_round_trips_through_an_atomic_write(tmp_path):
    path = str(tmp_path / "sub" / "plans.json")
    g, gw = _d1(), _d1(algo="wino")
    plans = {g.key(): _port_entry(g, 0.07), gw.key(): _port_entry(gw, 0.06)}
    assert A.save_cache(plans, path) == path
    assert sorted(p.name for p in (tmp_path / "sub").iterdir()) == \
        ["plans.json"]                       # no temp file left behind
    doc = json.loads(open(path).read())
    assert doc == {"version": 1, "plans": plans}
    A._MEM.pop(path)                          # read it back from disk
    assert A.load_cache(path) == plans
    assert A.get_plan(g, path=path, device="cpu") == A.default_plan(g)
    assert A.get_plan(gw, path=path, device="cpu") == A.default_plan(gw)
    assert A.measured_ms(gw, path, device="cpu") == 0.06


def test_entries_of_another_device_are_ignored(tmp_path):
    path = str(tmp_path / "plans.json")
    g, gw = _d1(), _d1(algo="wino")
    A.save_cache({g.key(): _port_entry(g, 1.0, "NVIDIA H100 80GB HBM3"),
                  gw.key(): _port_entry(gw, 0.5, "NVIDIA H100 80GB HBM3")},
                 path)
    assert A.get_plan(g, path=path, device="cpu") is None
    assert A.measured_ms(g, path, device="cpu") is None
    assert A.best_algo(g, path, device="cpu") == ""
    calls = []
    A.tune(g, lambda p: calls.append(p) or 1.0, path=path, device="cpu")
    assert calls                              # measured again for the CPU


@pytest.mark.parametrize("tile", [
    {"bn": 48, "splits": 1},                  # bn the kernel does not take
    {"bn": 64, "splits": 0},
    {"bn": 64, "splits": 100},                # more splits than k-tiles
    {"bn": 64},                               # torn entry
    {"nth": 4, "ntw": 4, "nb": 1, "tc": 32},  # a WinoPlan under a K1 key
])
def test_rejected_tile_falls_back_to_the_default(tile, tmp_path,
                                                 monkeypatch):
    path = tmp_path / "plans.json"
    monkeypatch.setenv("REPRO_TORCH_SD_PLAN_CACHE", str(path))
    g = _d1(b=1)
    A.save_cache({g.key(): {**tile, "ms": 0.01, "source": "measured",
                            "backend": "cpu"}})
    assert A.get_plan(g, device="cpu") is None
    _, teng = _engines("dcgan")
    teng.bind(_params("dcgan")[1])
    assert teng.plans()["d1"].tile is None    # the kernel's own default


def test_rejected_wino_tile_falls_back(tmp_path):
    path = str(tmp_path / "plans.json")
    gw = _d1(algo="wino")
    A.save_cache({gw.key(): {"nth": 8, "ntw": 8, "nb": 1, "tc": 32,
                             "ms": 0.01, "source": "measured",
                             "backend": "cpu"}}, path)
    assert A.get_plan(gw, path=path, device="cpu") is None


def test_tune_picks_persists_short_circuits_and_skips(tmp_path):
    path = str(tmp_path / "plans.json")
    g = _d1()
    cands = A.candidate_plans(g)
    assert cands[0] == A.default_plan(g) and 1 < len(cands) <= 8
    times = {p: 1.0 + 0.1 * i for i, p in enumerate(cands)}
    fastest = cands[2]
    times[fastest] = 0.25
    bad = cands[1]
    seen = []

    def runner(plan):
        seen.append(plan)
        if plan == bad:
            raise ValueError("the kernel refuses this tile")
        return times[plan]

    assert A.tune(g, runner, path=path, device="cpu") == fastest
    # two passes, the second reversed
    assert seen == cands + cands[::-1]
    entry = json.loads(open(path).read())["plans"][g.key()]
    assert entry == {"bn": fastest.bn, "splits": fastest.splits,
                     "ms": 0.25, "source": "measured", "backend": "cpu"}

    def never(plan):
        raise AssertionError("tune() must not measure a cached geometry")

    assert A.tune(g, never, path=path, device="cpu") == fastest


def test_tune_persists_nothing_when_every_candidate_fails(tmp_path):
    path = tmp_path / "plans.json"
    g = _d1(algo="wino")

    def runner(plan):
        raise ValueError("the kernel refuses this tile")

    assert A.tune(g, runner, path=str(path), device="cpu") is None
    assert not path.exists()
    assert A.measured_ms(g, str(path), device="cpu") is None


def test_tune_lets_a_failed_launch_through(tmp_path):
    """Only the plan checks' ``ValueError`` skips a candidate: a launch
    that fails (the wrapper raises ``RuntimeError``) stops the tuning
    and persists nothing."""
    path = tmp_path / "plans.json"
    g = _d1()
    bad = A.candidate_plans(g)[1]

    def runner(plan):
        if plan == bad:
            raise RuntimeError("sd_fused launch failed")
        return 1.0

    with pytest.raises(RuntimeError, match="launch failed"):
        A.tune(g, runner, path=str(path), device="cpu")
    assert not path.exists()


def test_pretune_counts_only_tuned_geometries(tmp_path, monkeypatch):
    """A geometry whose every candidate is refused is not reported as
    tuned and leaves no entry."""
    monkeypatch.setenv("REPRO_TORCH_SD_PLAN_CACHE",
                       str(tmp_path / "plans.json"))
    spec = reduced_specs()["dcgan-dryrun"]
    d1 = spec.deconv_layers()[0]

    def measure(fn, iters=3, warmup=1, device=None):
        fn()
        return 1.0

    real = sd_functional.execute

    def execute(plan, x):
        if plan.cin == d1.cin and plan.backend == "winograd":
            raise ValueError("the kernel refuses this tile")
        return real(plan, x)

    monkeypatch.setattr(A, "measure", measure)
    monkeypatch.setattr(sd_functional, "execute", execute)
    eng = SDEngine(spec, backend="fused", device="cpu")
    eng.bind(GenerativeModel(spec, "native", device="cpu").init(
        torch.Generator().manual_seed(0)))
    tuned = eng.pretune([1, 2], iters=1)
    # 2 layers x 2 batches x {K1, K4}, less d1's two K4 geometries
    assert len(tuned) == 6
    assert not any(k.endswith("_wino") and "_ci32_" in k for k in tuned)
    assert eng.plans()["d1"].backend == "fused"


@pytest.mark.parametrize("net", list(tacc.BENCHMARKS))
def test_candidates_are_tiles_the_kernels_take(net):
    _, teng = _engines(net)
    for l in teng.spec.deconv_layers():
        for b in BATCHES:
            algos = ("", "wino") if W.supported(
                (-(-l.k // l.s),) * 2) else ("",)
            for dtype in ("native", "int8"):
                for algo in algos if dtype == "native" else ("",):
                    g = teng.layer_geom(l, b, dtype, algo)
                    launch = g.launch()
                    cands = A.candidate_plans(g)
                    assert cands[0] == A.default_plan(g)
                    assert len(set(cands)) == len(cands) <= 8
                    for p in cands:
                        A.check_plan(launch, p)
                    if isinstance(launch, GemmGeom) and dtype == "int8":
                        # the int8 default keeps int8's column cap
                        assert cands[0].bn <= A.GEMM_BN_INT8
                    assert isinstance(launch, WinoGeom) == (algo == "wino")


# ---------------------------------------------------------------------------
# Engine: pretune, re-bind, plans_for_batch
# ---------------------------------------------------------------------------

def _fake_measure(monkeypatch, wino_fast_on):
    """``autotune.measure`` that runs the call once and returns 0.5 ms
    for a Winograd plan of a layer with ``wino_fast_on``'s input channels
    and 1.0 ms for anything else (the plan comes from a recording
    ``execute``)."""
    last = {}
    real = sd_functional.execute

    def execute(plan, x):
        last["plan"] = plan
        return real(plan, x)

    calls = []

    def measure(fn, iters=3, warmup=1, device=None):
        fn()
        p = last["plan"]
        calls.append(p)
        return 0.5 if (p.backend == "winograd"
                       and p.cin == wino_fast_on) else 1.0

    monkeypatch.setattr(sd_functional, "execute", execute)
    monkeypatch.setattr(A, "measure", measure)
    return calls


def test_pretuned_engine_switches_d1_to_winograd(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SD_PLAN_CACHE",
                       str(tmp_path / "plans.json"))
    spec = reduced_specs()["dcgan-dryrun"]
    d1, d2 = spec.deconv_layers()
    calls = _fake_measure(monkeypatch, wino_fast_on=d1.cin)
    model = GenerativeModel(spec, "sd_kernel", engine_backend="fused",
                            device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = model.engine
    eng.bind(params)
    gen0 = eng.generation
    assert eng.estimate_ms(2) is None
    tuned = eng.pretune([1, 2], iters=1)
    # 2 layers x 2 batches x {K1, K4}
    assert len(tuned) == 8 and sum(k.endswith("_wino") for k in tuned) == 4
    assert calls and eng.generation == gen0 + 1          # re-bound
    plans = eng.plans()
    assert plans["d1"].backend == "winograd" and plans["d1"].layout == "wino"
    assert plans["d2"].backend == "fused"
    assert isinstance(plans["d1"].tile, WinoPlan)
    assert isinstance(plans["d2"].tile, GemmPlan)
    # the sum of the measured entries of the bound algorithms
    assert eng.estimate_ms(2) == pytest.approx(0.5 + 1.0)
    p2 = eng.plans_for_batch(2)
    for name, layer in (("d1", d1), ("d2", d2)):
        geom = eng._plan_geom(plans[name], layer, 2)
        assert p2[name].tile == tuned[geom.key()]
        assert p2[name].ws is plans[name].ws               # nothing re-split
        assert p2[name].backend == plans[name].backend
    assert eng.plans_for_batch(4)["d2"].tile is None      # not measured
    # served output of the mixed engine within WINO_TOL[3] of torch
    z = torch.randn(model.input_shape(3), generator=torch.Generator()
                    .manual_seed(5))
    ref = GenerativeModel(spec, "sd_kernel", engine_backend="torch",
                          device="cpu")
    with torch.no_grad():
        want = ref.apply(params, z)
        got = model.apply(params, z)
    tol = W.WINO_TOL[3] * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    # a second pretune on the same cache measures nothing; d1 is bound
    # to K4 now, so (as in the reference) only its Winograd keys recur
    calls.clear()
    again = eng.pretune([1, 2], iters=1)
    assert calls == [] and len(again) == 6
    assert all(tuned[k] == v for k, v in again.items())


def test_int8_engine_pretunes_direct_keys_only(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SD_PLAN_CACHE",
                       str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_TORCH_SD_CALIB_CACHE",
                       str(tmp_path / "calib.json"))
    spec = reduced_specs()["dcgan-dryrun"]
    calls = _fake_measure(monkeypatch, wino_fast_on=spec.deconv_layers()[0]
                          .cin)
    model = GenerativeModel(spec, "sd_kernel", engine_backend="fused",
                            device="cpu", engine_dtype="int8")
    params = model.init(torch.Generator().manual_seed(0))
    z = torch.randn(model.input_shape(2), generator=torch.Generator()
                    .manual_seed(3))
    with torch.no_grad():
        before = model.apply(params, z)
    model.calibrate(params, n=4)
    with torch.no_grad():
        calibrated = model.apply(params, z)
    tuned = model.engine.pretune([1, 2], iters=1)
    assert set(tuned) == {
        "b1_h8w8_ci32_co16_kt3_s2_int8_q8out", "b1_h12w12_ci16_co3_kt3_s2_int8",
        "b2_h8w8_ci32_co16_kt3_s2_int8_q8out", "b2_h12w12_ci16_co3_kt3_s2_int8"}
    assert all(p.backend == "fused" for p in calls)
    assert {p.backend for p in model.engine.plans().values()} == {"fused"}
    with torch.no_grad():
        assert torch.equal(model.apply(params, z), calibrated)
    assert not torch.equal(before, calibrated)   # the chain is on


def test_describe_names_backend_and_tile(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SD_PLAN_CACHE",
                       str(tmp_path / "plans.json"))
    spec = reduced_specs()["dcgan-dryrun"]
    eng = SDEngine(spec, backend="fused", device="cpu")
    eng.bind(GenerativeModel(spec, "native", device="cpu").init(
        torch.Generator().manual_seed(0)))
    text = eng.describe()
    assert text.splitlines()[0] == ("SDEngine[DCGAN-dryrun] backend=fused "
                                    "dtype=native (2 deconv layers)")
    assert "d1: rank=2 K=5 s=2 KT=3 act=relu backend=fused " \
           "tile=call-time" in text


def _count_calls(monkeypatch, name):
    """Count calls of ``ops.<name>``."""
    from repro_torch.kernels import ops
    calls = []
    real = getattr(ops, name)

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("switched", [("d1",), ("d1", "d2", "d3")],
                         ids=["d1", "all"])
def test_switched_layers_train_on_k2_and_k3(switched, tmp_path,
                                            monkeypatch):
    """A layer the cache binds to K4 keeps its backward on the kernels:
    the model's differentiable path asks the engine for its plans, so a
    measured switch reaches training too.  Every layer's dx runs on K2
    and its dw on K3 (their plain versions here), and the generator's
    grads match ``jax.grad`` of the reference's xla model at 1e-4."""
    from repro_torch.convert import params_from_numpy
    path = tmp_path / "plans.json"
    monkeypatch.setenv("REPRO_TORCH_SD_PLAN_CACHE", str(path))
    jspec, tspec = _specs("dcgan")
    tm = GenerativeModel(tspec, "sd_kernel", engine_backend="fused",
                         device="cpu")
    plans = {}
    for l in tspec.deconv_layers():
        g, gw = (tm.engine.layer_geom(l, algo=a) for a in ("", "wino"))
        wino_ms = 0.5 if l.name in switched else 2.0
        plans[g.key()] = _port_entry(g, 1.0)
        plans[gw.key()] = _port_entry(gw, wino_ms)
    A.save_cache(plans, str(path))
    for l in tspec.deconv_layers():
        want = "winograd" if l.name in switched else "fused"
        assert tm._functional_plan(l).backend == want

    jm = JModel(jspec, "sd_kernel", engine_backend="xla")
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(4)
    z = rng.randn(2, 100).astype(np.float32)
    c = rng.randn(2, 64, 64, 3).astype(np.float32) / 64.0
    jg = jax.grad(lambda ps: jax.numpy.sum(
        jm.apply(ps, jax.numpy.asarray(z)) * c))(jp)

    k2 = _count_calls(monkeypatch, "sd_input_grad_fused")
    k3 = _count_calls(monkeypatch, "sd_filter_grad_fused")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu", spec=tspec)
    leaves = [t.requires_grad_() for p in params.values()
              for t in p.values()]
    y = tm.apply(params, torch.from_numpy(z))
    grads = torch.autograd.grad((y * torch.from_numpy(c)).sum(), leaves)
    # one K2 (dx) and one K3 (dw) per deconv layer, the switched ones too
    assert len(k2) == len(k3) == len(tspec.deconv_layers())
    it = iter(grads)
    for name, p in params.items():
        for leaf in p:
            np.testing.assert_allclose(
                next(it).numpy(), np.asarray(jg[name][leaf]), rtol=1e-4,
                atol=1e-4, err_msg=f"{name}/{leaf}")


def test_with_tile_shares_filters_and_checks_the_type():
    spec = reduced_specs()["dcgan-dryrun"]
    eng = SDEngine(spec, backend="fused", device="cpu")
    eng.bind(GenerativeModel(spec, "native", device="cpu").init(
        torch.Generator().manual_seed(0)))
    p = eng.plans()["d1"]
    q = p.with_tile(GemmPlan(32, 2))
    assert q.ws is p.ws and q.tile == GemmPlan(32, 2)
    with pytest.raises(TypeError):
        p.with_tile(WinoPlan(2, 2, 1, 16))


# ---------------------------------------------------------------------------
# Server and CLI
# ---------------------------------------------------------------------------

def test_torch_backend_server_pretunes_nothing(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    monkeypatch.setenv("REPRO_TORCH_SD_PLAN_CACHE", str(path))
    server = GenServer(nets=("dcgan-dryrun",), specs=reduced_specs(),
                       device="cpu", backend="torch", max_batch=4)
    assert server.pretune() == {}
    assert not path.exists()


def test_server_pretune_feeds_the_scheduler_estimate(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SD_PLAN_CACHE",
                       str(tmp_path / "plans.json"))
    _fake_measure(monkeypatch, wino_fast_on=-1)      # K1 wins everywhere
    specs = reduced_specs()
    server = GenServer(nets=("dcgan-dryrun", "voxgan-dryrun"),
                       specs={n: specs[n] for n in ("dcgan-dryrun",
                                                    "voxgan-dryrun")},
                       device="cpu", backend="fused", max_batch=4)
    assert server.estimate_ms("dcgan-dryrun", 4) is None
    tuned = server.pretune(iters=1)
    assert len(tuned) == 2 * 3 * 2                   # voxgan is rank 3
    for b in server.buckets():
        assert server.estimate_ms("dcgan-dryrun", b) == pytest.approx(2.0)
        assert server.estimate_ms("voxgan-dryrun", b) is None
    from repro_torch.serving import ContinuousScheduler
    sched = ContinuousScheduler(server)
    assert sched._engine_seed("dcgan-dryrun", 4) == pytest.approx(2.0)

"""The port's executor registry against the JAX reference's.

The reference's 13 tests of ``tests/test_registry.py`` one for one where
they have a torch meaning (its two ``selfcheck`` tests are one
parametrised test here, beside ``sd.selfcheck``), then: names and
capabilities equal to the reference's apart from the stated ``backends``
map; the plan cache of ``sd.compat`` keyed on the resolved backend; and
``build(net, impl)`` for every registered impl on DCGAN and FST cut to a
few narrow layers, with the reference's weights carried by
``params_from_numpy``, against the reference's model on the same impl
(``native`` for ``fused`` and ``winograd``, whose Pallas kernels do not
run here).  f32 gate 1e-5; ``winograd`` at ``tolerance * max|ref|``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accounting as jacc
from repro.core import registry as jreg
from repro.models.generative import GenerativeModel as JModel
from repro_torch import sd
from repro_torch.convert import params_from_numpy
from repro_torch.core import accounting as tacc
from repro_torch.core import registry
from repro_torch.core.deconv import native_deconv, sd_deconv
from repro_torch.launch import train_gen
from repro_torch.models.generative import GenerativeModel, build
from repro_torch.sd import compat


def test_unknown_impl_raises_with_catalog():
    """Unknown deconv_impl -> ValueError listing every registered impl
    and its capability tags, with the nearest name suggested."""
    with pytest.raises(ValueError) as ei:
        build("dcgan", "sd_krnel", device="cpu")
    msg = str(ei.value)
    assert "sd_krnel" in msg
    for name in registry.names():
        assert name in msg
    assert "trainable" in msg and "engine" in msg and "api=" in msg
    assert "did you mean 'sd_kernel'" in msg


def test_unknown_impl_without_near_match_has_no_suggestion():
    with pytest.raises(ValueError) as ei:
        registry.get_impl("zzzzqqqq")
    assert "did you mean" not in str(ei.value)


def test_unknown_impl_raises_from_resolve():
    with pytest.raises(ValueError, match="registered implementations"):
        registry.resolve("nope")


def test_resolve_returns_the_real_functions():
    assert registry.resolve("native") is native_deconv
    assert registry.resolve("sd") is sd_deconv
    assert registry.resolve("sd_fn") is sd.functional_deconv
    assert registry.resolve("sd_kernel") is sd.functional_deconv


def test_capability_schema_complete():
    caps = registry.capabilities()
    assert set(caps) == set(registry.names())
    for name, c in caps.items():
        assert set(c) == {"trainable", "engine", "needs_presplit",
                          "exact", "tolerance", "dtypes", "backends",
                          "api", "ranks", "backends_by_rank"}, name
        assert c["api"] in ("fn", "functional"), name
        assert 2 in c["ranks"], name
        assert set(c["backends_by_rank"]) == set(c["ranks"]), name


def test_per_rank_backend_metadata():
    for name in ("native", "nzp", "sd", "sd_fn", "sd_kernel"):
        assert registry.get_impl(name).ranks == (1, 2, 3), name
    for name in ("sd_paper", "fused", "shi", "chang"):
        assert registry.get_impl(name).ranks == (2,), name
    assert registry.get_impl("winograd").ranks == (1, 2)
    # sd_kernel's 3-D path sums the depth taps and interleaves them in
    # torch ops, visible in the per-rank metadata.
    table = registry.get_impl("sd_kernel").backends_by_rank()
    assert table[1] == table[2] == ("cuda", "any")
    assert "torch-interleave" in table[3]
    with pytest.raises(ValueError) as ei:
        registry.get_impl("no_such_impl_xyz")
    assert "ranks=123" in str(ei.value)


@pytest.mark.parametrize("which", ["registry", "sd"])
def test_selfcheck(which):
    """Both consistency checks pass on the CPU from a clean import: every
    impl at every declared rank, gradients, bf16 and the int8 claim
    (``registry``); forward, grads, a bound plan, the split's inverse and
    ranks 1 and 3 with output_padding (``sd``)."""
    {"registry": registry, "sd": sd}[which].selfcheck(device="cpu")


def test_selfcheck_reports_every_check():
    """``report`` sees each impl at each declared rank, the gradient of
    each trainable impl, and every dtype claim past f32."""
    seen = []
    registry.selfcheck(device="cpu", report=lambda n, c: seen.append((n, c)))
    want = []
    for name in registry.names():
        info = registry.get_impl(name)
        for r in info.ranks:
            want.append((name, f"rank {r}"))
            if info.trainable:
                want.append((name, f"rank {r} grad"))
        want += [(name, dt) for dt in info.dtypes if dt != "float32"]
    assert seen == want
    assert ("sd_kernel", "int8") in seen and ("winograd", "rank 1") in seen


def test_selfcheck_needs_a_device_or_the_card():
    """No fallback: ``device=None`` means the card."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal path, which needs a machine "
                    "without CUDA")
    for check in (registry.selfcheck, sd.selfcheck):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            check()


def test_engine_impls_presplit_and_train_only_via_functional():
    for name in registry.names():
        info = registry.get_impl(name)
        if info.engine:
            assert info.needs_presplit
            if info.trainable:
                assert info.api == "functional"


def test_trainable_set():
    trainable = set(registry.trainable_names())
    assert {"native", "nzp", "sd", "sd_paper", "sd_fn",
            "sd_kernel"} <= trainable
    assert "fused" not in trainable     # K1 inline: no backward


def test_exact_set_excludes_wrong_baselines():
    exact = set(registry.exact_names())
    assert "shi" not in exact and "chang" not in exact
    assert {"native", "nzp", "sd", "sd_paper", "sd_kernel",
            "sd_fn"} <= exact


@pytest.mark.parametrize("impl", registry.names())
def test_model_engine_flag_follows_registry(impl):
    spec = build("dcgan", "native", device="cpu").spec
    m = GenerativeModel(spec, impl, device="cpu")
    if registry.get_impl(impl).engine:
        assert m.engine is not None and m._deconv is None
    else:
        assert m.engine is None and callable(m._deconv)
        with pytest.raises(ValueError, match="needs an engine impl"):
            GenerativeModel(spec, impl, device="cpu", engine_dtype="int8")


def test_train_dcgan_choice_filter():
    """``train_gen --deconv-impl`` offers trainable AND exact, the
    reference's rule, and refuses anything else."""
    want = sorted(set(registry.trainable_names())
                  & set(registry.exact_names()))
    assert want == ["native", "nzp", "sd", "sd_fn", "sd_kernel",
                    "sd_paper"]
    assert train_gen.train_choices() == want
    assert want == sorted(set(jreg.trainable_names())
                          & set(jreg.exact_names()))
    for bad in ("fused", "winograd", "shi"):
        with pytest.raises(SystemExit):
            train_gen.main(["--deconv-impl", bad, "--device", "cpu"])


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

def _mapped(caps):
    """The reference's capability dict with its backends renamed to the
    port's (``registry.BACKEND_NAMES``)."""
    ren = lambda bks: [registry.BACKEND_NAMES.get(b, b)  # noqa: E731
                       for b in bks]
    out = dict(caps, backends=ren(caps["backends"]))
    out["backends_by_rank"] = {r: ren(b) for r, b in
                               caps["backends_by_rank"].items()}
    return out


def test_names_and_capabilities_match_reference():
    assert registry.names() == jreg.names()
    assert len(registry.names()) == 10
    for name in registry.names():
        assert registry.capabilities()[name] == \
            _mapped(jreg.capabilities()[name]), name
    assert registry.trainable_names() == jreg.trainable_names()
    assert registry.exact_names() == jreg.exact_names()
    assert registry.BACKEND_NAMES == {"tpu": "cuda",
                                      "xla-interleave": "torch-interleave"}


def test_plan_cache_keys_on_the_resolved_backend():
    """A plan made for one device's backend never serves another's:
    ``"auto"`` on the CPU is the ``torch`` plan, and ``fused`` on the CPU
    is another entry."""
    compat.clear_plan_cache()
    p_auto = compat.plan_for((4, 4, 3, 2), 2, 1, device="cpu")
    assert p_auto.backend == "torch"
    assert compat.plan_for((4, 4, 3, 2), 2, 1, backend="torch",
                           device="cpu") is p_auto
    p_fused = compat.plan_for((4, 4, 3, 2), 2, 1, backend="fused",
                              device="cpu")
    assert p_fused is not p_auto and p_fused.backend == "fused"
    keys = list(compat._PLAN_CACHE)
    assert [k[-1] for k in keys] == ["torch", "fused"]
    assert keys[0][:-1] == ((4, 4, 3, 2), (2, 2), ((1, 1), (1, 1)), (0, 0))
    x, w = torch.randn(1, 5, 6, 3), torch.randn(4, 4, 3, 2)
    sd.functional_deconv(x, w, 2, 1)
    assert len(compat._PLAN_CACHE) == 2        # the CPU call hit "torch"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compat.plan_for((4, 4, 3, 2), 2, 1)
    compat.clear_plan_cache()
    assert not compat._PLAN_CACHE


def _narrow(acc, net):
    """DCGAN (fc + three k5/s2 deconvs) and FST (k9 conv, two stride-2
    convs, a residual pair, two k3/s2 deconvs, k9 conv) at a few narrow
    layers, in package ``acc``'s spec types."""
    L, N = acc.LayerSpec, acc.NetworkSpec
    if net == "dcgan":
        return N("DCGAN-narrow", [
            L("fc", 8, 4 * 4 * 16, name="project"),
            L("deconv", 16, 8, k=5, s=2, in_hw=(4, 4), name="d1"),
            L("deconv", 8, 4, k=5, s=2, in_hw=(8, 8), name="d2"),
            L("deconv", 4, 3, k=5, s=2, in_hw=(16, 16), name="d3")])
    return N("FST-narrow", [
        L("conv", 3, 4, k=9, s=1, in_hw=(16, 16), name="c1"),
        L("conv", 4, 8, k=3, s=2, in_hw=(16, 16), name="c2"),
        L("conv", 8, 8, k=3, s=2, in_hw=(8, 8), name="c3"),
        L("conv", 8, 8, k=3, s=1, in_hw=(4, 4), name="res0a"),
        L("deconv", 8, 8, k=3, s=2, in_hw=(4, 4), name="d1"),
        L("deconv", 8, 4, k=3, s=2, in_hw=(8, 8), name="d2"),
        L("conv", 4, 3, k=9, s=1, in_hw=(16, 16), name="to_rgb")])


REF_IMPL = {"fused": "native", "winograd": "native"}


@pytest.mark.parametrize("net", ["dcgan", "fst"])
@pytest.mark.parametrize("impl", registry.names())
def test_models_match_reference(net, impl):
    jref = JModel(_narrow(jacc, net), REF_IMPL.get(impl, impl),
                  engine_backend="xla")
    jp = jref.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(1).randn(*jref.input_shape(2)).astype(
        np.float32)
    ref = np.asarray(jref.apply(jp, jnp.asarray(x)))
    m = GenerativeModel(_narrow(tacc, net), impl, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               "cpu", spec=m.spec)
    with torch.no_grad():
        out = m.apply(params, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    info = registry.get_impl(impl)
    if info.tolerance:
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=info.tolerance * np.abs(ref).max())
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    if not info.exact and not info.tolerance:
        # the wrong baselines stay wrong (K % s != 0 on both nets)
        native = np.asarray(JModel(_narrow(jacc, net), "native").apply(
            jp, jnp.asarray(x)))
        assert not np.allclose(out, native, atol=1e-3)

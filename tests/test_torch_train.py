"""The port's training path against the JAX reference, and the two faults
it had to repair first.

* One ``make_train_step`` SGD step of the small DCGAN (the reference's
  ``examples/train_dcgan.py`` spec) against ``jax.value_and_grad`` of the
  JAX model on ``sd_kernel``/``xla`` (loss and new params, 1e-4);
* ``DCGANDiscriminator`` forward and grads (1e-5 / 1e-4), ``adamw_update``
  over 3 steps (1e-6), ``GANLatentPipeline`` (``batch`` exact, ``images``
  1e-5) against the reference's;
* ``train_gen.main`` on the CPU, and why its grad check fixes the
  discriminator's cotangent (a LeakyReLU kink that flips under f32);
* repairs: an in-place update of the params is seen by the bound engine
  (it used to serve stale split filters), ``sd.plan(backend="auto")``
  and ``SDEngine`` with no device mean the card (they used to pick the
  CPU), and ``sd_kernel`` params that require grad get the native
  model's grads, also after an AdamW step; and frozen deconv filters
  (or a latent that alone requires grad) keep the graph where the card's
  kernels return tensors without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.accounting import LayerSpec as JLayer
from repro.core.accounting import NetworkSpec as JSpec
from repro.data.pipeline import GANLatentPipeline as JPipe
from repro.models.generative import DCGANDiscriminator as JDisc
from repro.models.generative import GenerativeModel as JModel
from repro.optim import adamw as jadamw
import repro_torch.sd as tsd
from repro_torch.convert import params_from_numpy
from repro_torch.data import GANLatentPipeline
from repro_torch.engine import SDEngine
from repro_torch.launch import train_gen
from repro_torch.models import DCGANDiscriminator, GenerativeModel, build
from repro_torch.optim import adamw_init, adamw_update

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return {k: {n: torch.from_numpy(np.array(a)) for n, a in v.items()}
            for k, v in tree.items()}


def _j_small_spec():
    return JSpec("DCGAN-small", [
        JLayer("fc", 32, 4 * 4 * 64, name="project"),
        JLayer("deconv", 64, 32, k=5, s=2, in_hw=(4, 4), name="d1"),
        JLayer("deconv", 32, 3, k=5, s=2, in_hw=(8, 8), name="d2"),
    ])


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_small_dcgan_train_step_matches_jax(backend):
    jm = JModel(_j_small_spec(), "sd_kernel", engine_backend="xla")
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    z = rng.randn(4, 32).astype(np.float32)
    target = rng.randn(4, 16, 16, 3).astype(np.float32)
    lr = 0.5

    def loss_fn(ps):
        return jnp.mean((jm.apply(ps, jnp.asarray(z)) - target) ** 2)

    jloss, jg = jax.value_and_grad(loss_fn)(jp)
    jnew = jax.tree_util.tree_map(lambda p, g: p - lr * g, jp, jg)

    tm = GenerativeModel(train_gen.small_spec(), "sd_kernel",
                         engine_backend=backend, device="cpu")
    params = params_from_numpy(_np(jp), "cpu", spec=tm.spec)
    new, loss = train_gen.make_train_step(tm, lr=lr)(
        params, torch.from_numpy(z), torch.from_numpy(target))
    np.testing.assert_allclose(loss.item(), float(jloss), **GRAD_TOL)
    for k, v in _np(jnew).items():
        for n, a in v.items():
            np.testing.assert_allclose(new[k][n].numpy(), a, **GRAD_TOL,
                                       err_msg=f"{k}/{n}")
    # The old params are left as they were.
    for k, v in _np(jp).items():
        np.testing.assert_array_equal(params[k]["w"].numpy(), v["w"])


@pytest.mark.parametrize("small", [True, False])
def test_discriminator_matches_jax(small):
    channels = (3, 16, 32, 64) if small else (3, 64, 128, 256)
    hw = (16, 16) if small else (64, 64)

    class JD(JDisc):
        CHANNELS = channels

    jd = JD(hw)
    jp = jd.init(jax.random.PRNGKey(3))
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    jlogits = np.asarray(jd.apply(jp, jnp.asarray(x)))
    jg = jax.grad(lambda p: jnp.sum(jd.apply(p, jnp.asarray(x)) ** 2))(jp)

    td = DCGANDiscriminator(hw, channels, device="cpu")
    tp = train_gen.trainable(_torch(_np(jp)))
    logits = td.apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), jlogits,
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((logits ** 2).sum(), train_gen.flatten(tp))
    for (k, n), g in zip([(k, n) for k in sorted(tp)
                          for n in sorted(tp[k])], grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k][n]),
                                   **GRAD_TOL, err_msg=f"{k}/{n}")
    # init gives the reference's shapes and scales.
    tinit = td.init(torch.Generator().manual_seed(0))
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in tinit.items()} == \
        {k: {n: a.shape for n, a in v.items()} for k, v in _np(jp).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_over_three_steps(dtype):
    rng = np.random.RandomState(0)
    shapes = {"a": {"w": (3, 4), "b": (4,)}, "c": {"w": (5,)}}
    p0 = {k: {n: rng.randn(*s).astype(np.float32) for n, s in v.items()}
          for k, v in shapes.items()}
    grads = [{k: {n: rng.randn(*s).astype(np.float32)
                  for n, s in v.items()} for k, v in shapes.items()}
             for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), p0)
    js = jadamw.adamw_init(jp)
    tp = {k: {n: torch.from_numpy(a).to(tdt) for n, a in v.items()}
          for k, v in p0.items()}
    ts = adamw_init(tp)
    assert (ts.master is None) == (dtype == "float32")
    for g in grads:
        jp, js = jadamw.adamw_update(jp, jax.tree_util.tree_map(
            jnp.asarray, g), js, lr=1e-2, b1=0.5)
        tp, ts = adamw_update(tp, _torch(g), ts, lr=1e-2, b1=0.5)
    for k, v in jp.items():
        for n, a in v.items():
            np.testing.assert_allclose(
                tp[k][n].float().numpy(), np.asarray(a, np.float32),
                rtol=1e-6, atol=1e-6, err_msg=f"{k}/{n}")
            np.testing.assert_allclose(ts.nu[k][n].numpy(),
                                       np.asarray(js.nu[k][n]),
                                       rtol=1e-6, atol=1e-6)
    assert ts.step == int(js.step) == 3


def test_gan_pipeline_matches_jax():
    for seed, batch, hw in [(0, 4, (64, 64)), (3, 2, (16, 16))]:
        jpipe, tpipe = JPipe(100, batch, seed=seed), \
            GANLatentPipeline(100, batch, seed=seed)
        for step in (0, 5):
            np.testing.assert_array_equal(tpipe.batch(step).numpy(),
                                          np.asarray(jpipe.batch(step)))
            np.testing.assert_allclose(tpipe.images(step, hw).numpy(),
                                       np.asarray(jpipe.images(step, hw)),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["sd", "sd_kernel"])
def test_train_gen_main_runs_on_cpu(impl, capsys, tmp_path):
    d_hist, g_hist = train_gen.main(["--steps", "2", "--small", "--device",
                                     "cpu", "--deconv-impl", impl,
                                     "--grad-check", "--out", str(tmp_path)])
    assert len(d_hist) == len(g_hist) == 2
    assert np.isfinite(d_hist + g_hist).all()
    assert "match native f64" in capsys.readouterr().out


def test_train_gen_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal path, which needs a machine "
                    "without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gen.main(["--steps", "1", "--small"])


@pytest.mark.parametrize("seed,flips", [(0, 0), (119, 1)])
def test_full_step_grads_cross_a_kink(seed, flips):
    """Why the grad checks hold ``J_G^T c`` with the cotangent fixed, and
    not the full generator step: at seed 119 one pre-activation of the
    discriminator's first conv lies within f32 rounding of 0 and takes
    the other LeakyReLU slope in f32 than in f64.  Then the f32 full
    step of the native ``F.conv_transpose2d`` generator is 1.5e-3 off its
    f64 twin, with no fault anywhere, while ``J_G^T c`` of native and
    ``sd_kernel`` stays within 1e-6.  At seed 0 no sign flips and the
    full step agrees too."""
    spec = train_gen.small_spec()
    disc = DCGANDiscriminator((16, 16), (3, 16, 32, 64), "cpu")
    ref = GenerativeModel(spec, "native", device="cpu")
    gp = train_gen.trainable(ref.init(torch.Generator().manual_seed(seed)))
    dp = disc.init(torch.Generator().manual_seed(seed + 1))
    z = GANLatentPipeline(32, 16, seed=seed).batch(0)
    g32 = train_gen.generator_grads(ref, disc, gp, dp, z)[1]
    g64 = train_gen.generator_grads(
        ref, disc, train_gen.trainable(train_gen.double(gp)),
        train_gen.double(dp), z.double())[1]
    full = max(train_gen.rel_errs(g32, g64).values())
    with torch.no_grad():
        kinks = train_gen.kink_flips(disc, dp, ref.apply(gp, z),
                                     ref.apply(train_gen.double(gp),
                                               z.double()))
    assert [n for n, _, _ in kinks] == [flips, 0, 0]
    n, worst_a64, rounding = kinks[0]
    assert worst_a64 <= rounding
    assert (full > 1e-3) if flips else (full < 1e-5)
    for impl in ("native", "sd_kernel"):
        gen = GenerativeModel(spec, impl, device="cpu")
        errs = train_gen.grad_check(gen, ref, disc, gp, dp, z)
        assert max(errs.values()) < 1e-5, (impl, errs)


# ---------------------------------------------------------------------------
# Regressions of the two repaired faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_engine_sees_in_place_updates(backend):
    m = build("dcgan", "sd_kernel", engine_backend=backend, device="cpu")
    ref = build("dcgan", "native", device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    z = torch.randn(2, 100, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        before = m.apply(p, z)
        p["d1"]["w"].mul_(0.5)
        p["d3"]["b"].add_(0.25)
        after = m.apply(p, z)
        want = ref.apply(p, z)
    assert (after - before).abs().max().item() > 1e-3
    np.testing.assert_allclose(after.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert m.engine.bound_to(p)


def test_auto_means_the_card():
    p = tsd.plan((4, 4, 3, 2), 2, 1, backend="auto", device="cpu")
    assert p.backend == "torch"
    spec = build("dcgan", device="cpu").spec
    if torch.cuda.is_available():
        assert tsd.plan((4, 4, 3, 2), 2, 1).backend == "fused"
        assert SDEngine(spec).backend == "fused"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsd.plan((4, 4, 3, 2), 2, 1, backend="auto")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SDEngine(spec)
    assert SDEngine(spec, device="cpu").backend == "torch"


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_sd_kernel_grads_equal_native_across_an_adamw_step(backend):
    spec = train_gen.small_spec()
    m = GenerativeModel(spec, "sd_kernel", engine_backend=backend,
                        device="cpu")
    ref = GenerativeModel(spec, "native", device="cpu")
    p = train_gen.trainable(m.init(torch.Generator().manual_seed(0)))
    opt = adamw_init(p)
    z = torch.randn(3, 32, generator=torch.Generator().manual_seed(2))
    for _ in range(2):
        grads = []
        for model in (m, ref):
            loss = torch.mean(torch.tanh(model.apply(p, z)) ** 2)
            grads.append(torch.autograd.grad(loss, train_gen.flatten(p)))
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        adamw_update(p, train_gen.unflatten(p, grads[0]), opt, lr=1e-2)
        with torch.no_grad():        # the engine path, after the update
            torch.testing.assert_close(m.apply(p, z), ref.apply(p, z),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["fused", "winograd"])
@pytest.mark.parametrize("case", ["deconv_w_frozen", "only_z"])
def test_frozen_filters_keep_the_graph(backend, case, monkeypatch):
    """On the card K1/K4 return fresh tensors with no ``grad_fn``; detach
    their plain versions the same way here.  With the deconv filters
    frozen (fc, scale and bias train) or with only the latent requiring
    grad, the model must still take the differentiable path, so
    ``backward`` works and the grads equal ``native``'s (1e-4
    relative).  It used to take that path only when a deconv ``w``
    required grad."""
    import repro_torch.kernels.sd_conv as K
    import repro_torch.kernels.winograd as W
    for mod, name in ((K, "sd_fused_ref"), (W, "sd_wino_ref")):
        plain = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=plain, **k:
                            _f(*a, **k).detach())
    spec = train_gen.small_spec()
    m = GenerativeModel(spec, "sd_kernel", engine_backend=backend,
                        device="cpu")
    ref = GenerativeModel(spec, "native", device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    z = torch.randn(3, 32, generator=torch.Generator().manual_seed(2))
    if case == "deconv_w_frozen":
        deconv = {l.name for l in spec.deconv_layers()}
        leaves = [t.requires_grad_(True) for k in sorted(p)
                  for n, t in sorted(p[k].items())
                  if not (k in deconv and n == "w")]
    else:
        leaves = [z.requires_grad_(True)]
    grads = []
    for model in (m, ref):
        loss = torch.mean(torch.tanh(model.apply(p, z)) ** 2)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)

"""The paper's baselines and the registry's executors against the JAX
reference.

Same seeded numpy inputs through ``repro`` and ``repro_torch``:
``dilate_input`` and ``nzp_deconv`` at ranks 1-3 (with
``output_padding``), ``sd_deconv_paper`` (Algorithm 2's separate
per-phase convs), the wrong baselines ``shi_deconv`` / ``chang_deconv``
(the reference's wrong output, not a correct one), and
``functional_deconv`` against the reference's on its xla backend,
forward and gradients.  Sweep K in {3, 4, 5}, s in {2, 3}, symmetric and
asymmetric pads.  f32 gate: the reference's ``rtol=atol=1e-5``, 1e-4 on
gradients.  ``fused`` and ``winograd`` have no CPU-runnable reference
(their Pallas kernels need ``pl.Unblocked``), so the port's are held to
the reference's ``native_deconv`` and ``sd_deconv``: 1e-5 for ``fused``,
``tolerance * max|ref|`` for ``winograd``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deconv as J
from repro.core import wrong_baselines as JW
from repro.sd import functional_deconv as j_functional_deconv
from repro_torch.core import deconv as T
from repro_torch.core import registry
from repro_torch.core import wrong_baselines as TW
from repro_torch.kernels.ops import sd_deconv_kernel
from repro_torch.sd import functional_deconv

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

KS = [(k, s) for k in (3, 4, 5) for s in (2, 3)]


def _pads(k, s, kind):
    """'same' (TF SAME, out = in * s), 'sym' (1 per side) or 'asym'
    (the SAME amounts swapped onto the other sides, plus a one-sided
    pad on the second dim)."""
    lo, hi = J.same_deconv_pads(k, s)[0]
    if kind == "same":
        return ((lo, hi), (lo, hi))
    if kind == "sym":
        return 1
    return ((hi, lo), (min(k - 1, lo + hi), 0))


def _data(shape_x, shape_w, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape_x).astype(np.float32),
            (rng.randn(*shape_w) / np.sqrt(np.prod(shape_w[:-1])))
            .astype(np.float32))


def _both(fn_j, fn_t, x, w, *args, **kw):
    ref = np.asarray(fn_j(jnp.asarray(x), jnp.asarray(w), *args, **kw))
    with torch.no_grad():
        out = fn_t(torch.from_numpy(x), torch.from_numpy(w), *args,
                   **kw).numpy()
    assert out.shape == ref.shape
    return out, ref


def _case2(k, s, seed=0):
    return _data((2, 5, 6, 3), (k, k, 3, 4), seed + 10 * k + s)


def test_dilate_input_matches_reference():
    x = np.random.RandomState(0).randn(2, 3, 4, 5, 2).astype(np.float32)
    for rank, xs, st in ((1, x[:, 0, 0], 3), (2, x[:, 0], (2, 3)),
                         (3, x, 2)):
        ref = np.asarray(J.dilate_input(jnp.asarray(xs), st))
        out = T.dilate_input(torch.from_numpy(np.ascontiguousarray(xs)),
                             st).numpy()
        np.testing.assert_array_equal(out, ref, err_msg=f"rank {rank}")


@pytest.mark.parametrize("rank", [1, 2, 3])
@pytest.mark.parametrize("k,s", KS)
@pytest.mark.parametrize("op", [0, 1])
def test_nzp_matches_reference(rank, k, s, op):
    space = {1: (7,), 2: (4, 5), 3: (3, 4, 3)}[rank]
    x, w = _data((2, *space, 3), (k,) * rank + (3, 2), 7 * k + s + rank)
    pads = ((k - 1, 1),) + ((1, 0),) * (rank - 1)    # asymmetric
    out, ref = _both(J.nzp_deconv, T.nzp_deconv, x, w, s, pads,
                     output_padding=op)
    np.testing.assert_allclose(out, ref, **TOL)
    native = np.asarray(J.native_deconv(jnp.asarray(x), jnp.asarray(w), s,
                                        pads, output_padding=op))
    np.testing.assert_allclose(out, native, **TOL)


@pytest.mark.parametrize("k,s", KS)
@pytest.mark.parametrize("kind", ["same", "sym", "asym"])
def test_sd_paper_matches_reference(k, s, kind):
    x, w = _case2(k, s)
    out, ref = _both(J.sd_deconv_paper, T.sd_deconv_paper, x, w, s,
                     _pads(k, s, kind))
    np.testing.assert_allclose(out, ref, **TOL)


def test_sd_paper_phase_order_is_n_major():
    """Phase ``n`` is the slice ``[n*Cout, (n+1)*Cout)`` of the split
    filters: an oc-major slice gives a permuted image of the right shape,
    which the reference's output (and native) refuse."""
    x, w = _data((1, 6, 6, 2), (5, 5, 2, 3), 3)
    out, ref = _both(J.sd_deconv_paper, T.sd_deconv_paper, x, w, 2, 2)
    native = np.asarray(J.native_deconv(jnp.asarray(x), jnp.asarray(w), 2,
                                        2))
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, native, **TOL)


@pytest.mark.parametrize("k,s", KS)
@pytest.mark.parametrize("kind", ["same", "asym"])
def test_shi_matches_reference(k, s, kind):
    x, w = _case2(k, s, seed=1)
    out, ref = _both(JW.shi_deconv, TW.shi_deconv, x, w, s,
                     _pads(k, s, kind))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("k,s", KS)
@pytest.mark.parametrize("side", ["top_left", "bottom_right"])
def test_split_with_expansion_matches_reference(k, s, side):
    """The wrong baselines' split: ``"top_left"`` is the paper's (equal
    to ``split_filters``), ``"bottom_right"`` Shi's, both equal to the
    reference's."""
    _, w = _case2(k, s)
    ref = np.asarray(JW._split_with_expansion(jnp.asarray(w), s, side))
    out = TW._split_with_expansion(torch.from_numpy(w), s, side).numpy()
    np.testing.assert_array_equal(out, ref)
    if side == "top_left":
        np.testing.assert_array_equal(
            out, T.split_filters(torch.from_numpy(w), s).numpy())


@pytest.mark.parametrize("k,s", KS)
@pytest.mark.parametrize("kind", ["same", "asym"])
def test_chang_matches_reference(k, s, kind):
    x, w = _case2(k, s, seed=2)
    out, ref = _both(JW.chang_deconv, TW.chang_deconv, x, w, s,
                     _pads(k, s, kind))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("k,s", KS)
def test_wrong_baselines_are_wrong_where_s_does_not_divide_k(k, s):
    """Shi and Chang differ from native where ``K % s != 0`` (paper
    Table 4).  Where ``s | K`` Chang delegates to SD and is right; Shi's
    crop from the origin still ignores the user padding, so it stays
    wrong under SAME pads, as the reference's does."""
    x, w = _data((1, 8, 8, 4), (k, k, 4, 3), 5)
    pads = _pads(k, s, "same")
    native = np.asarray(J.native_deconv(jnp.asarray(x), jnp.asarray(w), s,
                                        pads))
    for fn in (TW.shi_deconv, TW.chang_deconv):
        out = fn(torch.from_numpy(x), torch.from_numpy(w), s, pads).numpy()
        assert out.shape == native.shape
        if k % s:
            assert not np.allclose(out, native, atol=1e-2), fn.__name__
        elif fn is TW.chang_deconv:
            np.testing.assert_allclose(out, native, **TOL)


def test_chang_refuses_a_window_past_its_output():
    """Chang crops the requested size out of the truncated kernel's
    output, which is ``K % s - p_lo - p_hi`` rows short of it at small
    pads: the reference's slice raises there (``TypeError`` from
    ``lax.slice``), and so does the port's."""
    x, w = _case2(5, 2)
    with pytest.raises(TypeError):
        JW.chang_deconv(jnp.asarray(x), jnp.asarray(w), 2, 0)
    with pytest.raises(ValueError, match="leaves the output"):
        TW.chang_deconv(torch.from_numpy(x), torch.from_numpy(w), 2, 0)


@pytest.mark.parametrize("bad_pad", [3, (1, 3), ((0, 3), (1, 1))])
def test_padding_too_large_raises_consistently(bad_pad):
    x = torch.zeros(1, 4, 4, 2)
    w = torch.zeros(3, 3, 2, 2)
    for impl in (T.native_deconv, T.nzp_deconv, T.sd_deconv,
                 T.sd_deconv_paper, sd_deconv_kernel):
        with pytest.raises(ValueError, match="too large for kernel"):
            impl(x, w, 2, bad_pad)


@pytest.mark.parametrize("rank", [1, 2, 3])
@pytest.mark.parametrize("k,s", [(4, 2), (5, 2), (3, 3)])
def test_functional_deconv_matches_reference(rank, k, s):
    """``sd_fn``: forward at 1e-5 and ``dx``/``dw`` at 1e-4 against the
    reference's ``functional_deconv`` on its xla backend."""
    space = {1: (7,), 2: (4, 5), 3: (3, 3, 4)}[rank]
    x, w = _data((2, *space, 3), (k,) * rank + (3, 2), 3 * k + s + rank)
    pads = ((k - 1, 0),) + ((1, 1),) * (rank - 1)
    jfn = functools.partial(j_functional_deconv, backend="xla")
    tfn = functools.partial(functional_deconv, backend="auto")
    out, ref = _both(jfn, tfn, x, w, s, pads)
    np.testing.assert_allclose(out, ref, **TOL)

    gx, gw = jax.grad(lambda a, b: jnp.sum(jfn(a, b, s, pads) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tx, tw = torch.autograd.grad((tfn(xt, wt, s, pads) ** 2).sum(),
                                 (xt, wt))
    np.testing.assert_allclose(tx.numpy(), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(gw), **GRAD_TOL)


@pytest.mark.parametrize("k,s", KS)
@pytest.mark.parametrize("kind", ["same", "sym", "asym"])
def test_fused_matches_reference_native_and_sd(k, s, kind):
    """``fused`` (the split inline, then K1's launch; its plain version
    on the CPU)."""
    x, w = _case2(k, s, seed=3)
    pads = _pads(k, s, kind)
    for jfn in (J.native_deconv, J.sd_deconv):
        out, ref = _both(jfn, sd_deconv_kernel, x, w, s, pads)
        np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("rank", [1, 2])
@pytest.mark.parametrize("k,s", KS)
def test_winograd_matches_reference_native_and_sd(rank, k, s):
    """``winograd`` (K4's algorithm; its plain version on the CPU) within
    the registry's pinned ``tolerance * max|ref|``."""
    space = {1: (9,), 2: (5, 6)}[rank]
    x, w = _data((2, *space, 3), (k,) * rank + (3, 4), 11 * k + s)
    pads = ((k - 1, 0),) + ((1, 1),) * (rank - 1)
    tol = registry.get_impl("winograd").tolerance
    fn = registry.resolve("winograd")
    for jfn in (J.native_deconv, J.sd_deconv):
        out, ref = _both(jfn, fn, x, w, s, pads)
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=tol * np.abs(ref).max())

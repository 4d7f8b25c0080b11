"""The port's recurrent mixers against the JAX package, on the CPU.

Same inputs (numpy seeds), same weights (the reference's ``init_mamba``
/ ``init_mlstm`` / ``init_slstm`` carried over with ``tree_from_numpy``),
both packages on the CPU, f32:

* Mamba ``mamba_forward`` with and without a state at S in {1, 7, 17,
  33} x chunk in {1, 4, 8} (padding included), and ``mamba_step`` token
  by token; the mLSTM's ``mlstm_chunkwise`` with and without a state
  and ``mlstm_recurrent``; the sLSTM with and without a state: outputs
  and states within ``1e-5 * max(1, max|ref|)``;
* grads of x, of the state and of every leaf against ``jax.grad``
  within 1e-4 of each leaf's max|ref|;
* the reference's invariants (``tests/test_ssm.py``) restated on the
  port: parallel = stepwise, the mLSTM's chunkwise = recurrent property
  test, continuation across calls, a state whose size does not grow;
  and the -1e30 sentinels: padded chunks and fresh states stay finite.

The port scans in another order than the reference's
``lax.associative_scan`` (a loop over each chunk's steps), so the gates
are not bit equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.models import ssm as J

from _torch_hybrid import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.convert import tree_from_numpy
from repro_torch.models import ssm as T

TOL = 1e-5              # outputs and states, rel. max(1, max|ref|)
GRAD_TOL = 1e-4         # grads, rel. each leaf's max|ref|
D, B = 32, 2
SEQS = (1, 7, 17, 33)
CHUNKS = (1, 4, 8)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _gate(out, ref, rel=TOL):
    ref = np.asarray(ref, np.float32)
    d = np.abs(_np(out) - ref).max()
    assert d <= rel * max(1.0, np.abs(ref).max()), d


def _grad_gate(name, got, ref):
    ref = np.asarray(ref)
    err = np.abs(_np(got) - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= GRAD_TOL, (name, err)


def _x(s, seed=0, d=D):
    return (0.5 * np.random.RandomState(seed).randn(B, s, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mamba():
    """The reference's Mamba block (d 32, d_state 8, d_conv 4) and a
    nonzero state, as numpy."""
    p = J.init_mamba(jax.random.PRNGKey(0), D, expand=2, d_state=8,
                     d_conv=4)
    p = jax.tree.map(np.asarray, p)
    rng = np.random.RandomState(1)
    # a trained block's conv bias and dt bias are not zero
    p = dict(p, conv_b=0.1 * rng.randn(*p["conv_b"].shape).astype(
        np.float32), dt_bias=0.1 * rng.randn(*p["dt_bias"].shape).astype(
        np.float32))
    di, ds = p["A_log"].shape
    state = J.MambaState(rng.randn(B, 3, di).astype(np.float32),
                         rng.randn(B, di, ds).astype(np.float32))
    return p, state


@functools.lru_cache(maxsize=None)
def _ref_mamba(s, chunk, with_state):
    p, st0 = _mamba()
    fn = jax.jit(functools.partial(J.mamba_forward, chunk=chunk))
    y, st1 = fn(p, jnp.asarray(_x(s)), st0 if with_state else None)
    return np.asarray(y), jax.tree.map(np.asarray, st1)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "state"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("s", SEQS)
def test_mamba_forward_matches_reference(s, chunk, with_state):
    p, st0 = _mamba()
    ref, ref_st = _ref_mamba(s, chunk, with_state)
    state = T.MambaState(*(_t(a) for a in st0)) if with_state else None
    out, new = T.mamba_forward(tree_from_numpy(p, "cpu"), _t(_x(s)), state,
                               chunk=chunk)
    assert out.shape == (B, s, D) and out.dtype == torch.float32
    _gate(out, ref)
    if with_state:
        assert isinstance(new, T.MambaState)
        _gate(new.conv, ref_st.conv)
        _gate(new.ssm, ref_st.ssm)
        assert new.ssm.dtype == torch.float32
    else:
        assert new is None and ref_st is None


def test_mamba_step_matches_reference():
    p, st0 = _mamba()
    x = _x(7, seed=3)
    step = jax.jit(J.mamba_step)
    jst = st0
    tst = T.MambaState(*(_t(a) for a in st0))
    tp = tree_from_numpy(p, "cpu")
    for t in range(7):
        jy, jst = step(p, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = T.mamba_step(tp, _t(x[:, t:t + 1]), tst)
        _gate(ty, jy)
        _gate(tst.ssm, jst.ssm)
        _gate(tst.conv, jst.conv)


@pytest.mark.parametrize("s,chunk,with_state", [(17, 4, True),
                                                (33, 8, False),
                                                (7, 1, True)])
def test_mamba_grads_match_reference(s, chunk, with_state):
    """Grads of x, the state and every leaf through the chunked scan
    (each chunk recomputed in the port's backward)."""
    p, st0 = _mamba()
    x = _x(s, seed=2)
    rng = np.random.RandomState(4)
    cy = rng.randn(B, s, D).astype(np.float32)
    cs = rng.randn(*st0.ssm.shape).astype(np.float32)
    cc = rng.randn(*st0.conv.shape).astype(np.float32)

    def jloss(p_, x_, st_):
        y, new = J.mamba_forward(p_, x_, st_ if with_state else None,
                                 chunk=chunk)
        out = jnp.sum(y * cy)
        if with_state:
            out = out + jnp.sum(new.ssm * cs) + jnp.sum(new.conv * cc)
        return out
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(p, jnp.asarray(x), st0)
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(True)
    tst = T.MambaState(*(_t(a).requires_grad_(True) for a in st0))
    y, new = T.mamba_forward(tp, tx, tst if with_state else None,
                             chunk=chunk)
    loss = (y * _t(cy)).sum()
    if with_state:
        loss = loss + (new.ssm * _t(cs)).sum() + (new.conv * _t(cc)).sum()
    loss.backward()
    _grad_gate("x", tx.grad, jg[1])
    for k in p:
        _grad_gate(k, tp[k].grad, jg[0][k])
    if with_state:
        _grad_gate("ssm", tst.ssm.grad, jg[2].ssm)
        _grad_gate("conv", tst.conv.grad, jg[2].conv)


def test_mamba_parallel_equals_stepwise():
    """``test_mamba_parallel_equals_stepwise`` on the port."""
    p, _ = _mamba()
    tp = tree_from_numpy(p, "cpu")
    x = _t(_x(17, seed=5))
    st0 = T.init_mamba_state(B, tp, torch.float32)
    y_full, st_full = T.mamba_forward(tp, x, st0, chunk=4)
    st = T.init_mamba_state(B, tp, torch.float32)
    ys = []
    for t in range(17):
        yt, st = T.mamba_step(tp, x[:, t:t + 1], st)
        ys.append(yt)
    torch.testing.assert_close(y_full, torch.cat(ys, 1), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(st_full.ssm, st.ssm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st_full.conv, st.conv, rtol=1e-5, atol=1e-5)


def test_mamba_constant_state_and_padding():
    """The state's size does not grow with the sequence; padded steps
    (dt = 0) leave it as the unpadded run leaves it."""
    p = T.init_mamba(torch.Generator().manual_seed(0), 16, d_state=4)
    s1 = T.init_mamba_state(1, p, torch.float32)
    _, s1 = T.mamba_forward(p, torch.ones(1, 8, 16), s1, chunk=4)
    s2 = T.init_mamba_state(1, p, torch.float32)
    _, s2 = T.mamba_forward(p, torch.ones(1, 64, 16), s2, chunk=4)
    assert s1.ssm.shape == s2.ssm.shape == (1, 32, 4)
    x = torch.randn(2, 13, 16, generator=torch.Generator().manual_seed(1))
    st = T.init_mamba_state(2, p, torch.float32)
    y8, st8 = T.mamba_forward(p, x, st, chunk=8)      # 3 padded steps
    y13, st13 = T.mamba_forward(p, x, st, chunk=13)   # none
    torch.testing.assert_close(y8, y13, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st8.ssm, st13.ssm, rtol=1e-5, atol=1e-5)


def test_mamba_init_matches_reference_values():
    """The deterministic leaves are the reference's: ``A_log`` = log(1..
    ds) on every channel, ``D`` ones, ``conv_b`` and ``dt_bias`` zeros,
    shapes equal; ``A_log`` and ``D`` f32 under a bf16 ``dtype``."""
    ref = jax.tree.map(np.asarray, J.init_mamba(jax.random.PRNGKey(0), D,
                                                d_state=8))
    own = T.init_mamba(torch.Generator().manual_seed(0), D, d_state=8,
                       dtype=torch.bfloat16, lead=(3,))
    assert {k: tuple(v.shape[1:]) for k, v in own.items()} == \
        {k: v.shape for k, v in ref.items()}
    for k in ("D", "conv_b", "dt_bias"):
        np.testing.assert_array_equal(_np(own[k][2]), ref[k], err_msg=k)
    # torch's and XLA's log may differ in the last bit
    np.testing.assert_allclose(_np(own["A_log"][2]), ref["A_log"], rtol=2e-7)
    assert own["A_log"].dtype == own["D"].dtype == torch.float32
    assert own["in_proj"].dtype == own["conv_b"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

H = 2


@functools.lru_cache(maxsize=None)
def _mlstm():
    p = jax.tree.map(np.asarray, J.init_mlstm(jax.random.PRNGKey(3), D,
                                              n_heads=H))
    di = p["wq"].shape[1]
    dh = di // H
    rng = np.random.RandomState(5)
    state = J.MLSTMState(0.3 * rng.randn(B, H, dh, dh).astype(np.float32),
                         0.3 * rng.randn(B, H, dh).astype(np.float32),
                         rng.randn(B, H).astype(np.float32))
    return p, state


MLSTM_CASES = [(1, 4), (7, 4), (17, 8), (33, 8), (16, 8)]


@functools.lru_cache(maxsize=None)
def _ref_mlstm(s, chunk, with_state):
    p, st0 = _mlstm()
    fn = jax.jit(functools.partial(J.mlstm_chunkwise, n_heads=H, chunk=chunk))
    y, st1 = fn(p, jnp.asarray(_x(s, seed=7)), st0 if with_state else None)
    return np.asarray(y), jax.tree.map(np.asarray, st1)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "state"])
@pytest.mark.parametrize("s,chunk", MLSTM_CASES)
def test_mlstm_chunkwise_matches_reference(s, chunk, with_state):
    p, st0 = _mlstm()
    ref, ref_st = _ref_mlstm(s, chunk, with_state)
    state = T.MLSTMState(*(_t(a) for a in st0)) if with_state else None
    out, new = T.mlstm_chunkwise(tree_from_numpy(p, "cpu"), _t(_x(s, seed=7)),
                                 state, n_heads=H, chunk=chunk)
    assert out.shape == (B, s, D)
    _gate(out, ref)
    if with_state:
        for a, b_ in zip(new, ref_st):
            _gate(a, b_)
    else:
        assert new is None


@pytest.mark.parametrize("s", [1, 9])
def test_mlstm_recurrent_matches_reference(s):
    p, st0 = _mlstm()
    x = _x(s, seed=8)
    fn = jax.jit(functools.partial(J.mlstm_recurrent, n_heads=H))
    for st in (st0, J.init_mlstm_state(B, p, H)):
        jy, jst = fn(p, jnp.asarray(x), st)
        ty, tst = T.mlstm_recurrent(tree_from_numpy(p, "cpu"), _t(x),
                                    T.MLSTMState(*(_t(a) for a in st)),
                                    n_heads=H)
        _gate(ty, jy)
        for a, b_ in zip(tst, jst):
            _gate(a, b_)


@pytest.mark.parametrize("form", ["chunkwise", "recurrent"])
def test_mlstm_grads_match_reference(form):
    p, st0 = _mlstm()
    s = 11
    x = _x(s, seed=9)
    cy = np.random.RandomState(10).randn(B, s, D).astype(np.float32)
    cc = np.random.RandomState(11).randn(*st0.c.shape).astype(np.float32)

    def run(mod, p_, x_, st_):
        if form == "chunkwise":
            return mod.mlstm_chunkwise(p_, x_, st_, n_heads=H, chunk=4)
        return mod.mlstm_recurrent(p_, x_, st_, n_heads=H)

    def jloss(p_, x_, st_):
        y, new = run(J, p_, x_, st_)
        return jnp.sum(y * cy) + jnp.sum(new.c * cc)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(p, jnp.asarray(x), st0)
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(True)
    tst = T.MLSTMState(*(_t(a).requires_grad_(True) for a in st0))
    y, new = run(T, tp, tx, tst)
    ((y * _t(cy)).sum() + (new.c * _t(cc)).sum()).backward()
    _grad_gate("x", tx.grad, jg[1])
    for k in p:
        _grad_gate(k, tp[k].grad, jg[0][k])
    for name, got, ref in zip(("c", "n", "m"), tst, jg[2]):
        if np.abs(np.asarray(ref)).max() > 0:
            _grad_gate(name, got.grad, ref)


@settings(max_examples=15, deadline=None)
@given(s=st.integers(2, 24), chunk=st.sampled_from([2, 4, 8, 16]),
       seed=st.integers(0, 99))
def test_property_mlstm_chunkwise(s, chunk, seed):
    """``test_property_mlstm_chunkwise`` on the port."""
    gen = torch.Generator().manual_seed(seed)
    p = T.init_mlstm(gen, 16, n_heads=2)
    x = torch.randn(2, s, 16, generator=gen) * 0.5
    st0 = T.init_mlstm_state(2, p, 2)
    y_rec, st_rec = T.mlstm_recurrent(p, x, st0, n_heads=2)
    y_chk, st_chk = T.mlstm_chunkwise(p, x, st0, n_heads=2, chunk=chunk)
    torch.testing.assert_close(y_rec, y_chk, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(st_rec.c, st_chk.c, rtol=1e-3, atol=1e-3)


def test_mlstm_state_continuation():
    gen = torch.Generator().manual_seed(3)
    p = T.init_mlstm(gen, 16, n_heads=2)
    x = torch.randn(1, 12, 16, generator=gen)
    st0 = T.init_mlstm_state(1, p, 2)
    y_all, _ = T.mlstm_chunkwise(p, x, st0, n_heads=2, chunk=4)
    y1, st1 = T.mlstm_chunkwise(p, x[:, :8], st0, n_heads=2, chunk=4)
    y2, _ = T.mlstm_chunkwise(p, x[:, 8:], st1, n_heads=2, chunk=4)
    torch.testing.assert_close(y_all, torch.cat([y1, y2], 1), rtol=1e-4,
                               atol=1e-4)


def test_mlstm_sentinels_stay_finite():
    """Fresh states hold -1e30 (not -inf); a padded chunk on a fresh
    state gives finite outputs, states and grads, as -inf would not
    (``-inf - (-inf)`` is NaN)."""
    gen = torch.Generator().manual_seed(4)
    p = {k: v.requires_grad_(True)
         for k, v in T.init_mlstm(gen, 16, n_heads=2).items()}
    st0 = T.init_mlstm_state(2, p, 2)
    assert float(st0.m.max()) == float(st0.m.min()) == float(
        np.float32(-1e30))
    x = torch.randn(2, 5, 16, generator=gen)
    y, st = T.mlstm_chunkwise(p, x, st0, n_heads=2, chunk=8)
    y.sum().backward()
    assert all(bool(torch.isfinite(t).all()) for t in (y, *st))
    assert all(bool(torch.isfinite(v.grad).all()) for v in p.values())
    y0, _ = T.mlstm_chunkwise(p, x, None, n_heads=2, chunk=8)
    torch.testing.assert_close(y0, y)
    assert p["bif"].dtype == p["wif"].dtype == torch.float32
    np.testing.assert_array_equal(_np(p["bif"]), [0, 0, 3, 3])


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _slstm():
    p = jax.tree.map(np.asarray, J.init_slstm(jax.random.PRNGKey(5), 24,
                                              n_heads=4))
    di = p["down"].shape[0]
    rng = np.random.RandomState(6)
    state = J.SLSTMState(rng.randn(B, di).astype(np.float32),
                         np.abs(rng.randn(B, di)).astype(np.float32) + 0.5,
                         rng.randn(B, di).astype(np.float32),
                         0.5 * rng.randn(B, di).astype(np.float32))
    return p, state


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["fresh", "state"])
@pytest.mark.parametrize("s", [1, 13])
def test_slstm_matches_reference(s, with_state):
    p, st0 = _slstm()
    x = _x(s, seed=12, d=24)
    jy, jst = jax.jit(J.slstm_forward)(p, jnp.asarray(x),
                                       st0 if with_state else None)
    state = T.SLSTMState(*(_t(a) for a in st0)) if with_state else None
    ty, tst = T.slstm_forward(tree_from_numpy(p, "cpu"), _t(x), state)
    _gate(ty, jy)
    if with_state:
        for a, b_ in zip(tst, jst):
            _gate(a, b_)
    else:
        assert tst is None


def test_slstm_grads_match_reference():
    p, st0 = _slstm()
    s = 9
    x = _x(s, seed=13, d=24)
    cy = np.random.RandomState(14).randn(B, s, 24).astype(np.float32)
    ch = np.random.RandomState(15).randn(*st0.h.shape).astype(np.float32)

    def jloss(p_, x_, st_):
        y, new = J.slstm_forward(p_, x_, st_)
        return jnp.sum(y * cy) + jnp.sum(new.h * ch) + jnp.sum(new.c)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(p, jnp.asarray(x), st0)
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(True)
    tst = T.SLSTMState(*(_t(a).requires_grad_(True) for a in st0))
    y, new = T.slstm_forward(tp, tx, tst)
    ((y * _t(cy)).sum() + (new.h * _t(ch)).sum() + new.c.sum()).backward()
    _grad_gate("x", tx.grad, jg[1])
    for k in p:
        _grad_gate(k, tp[k].grad, jg[0][k])
    for name, got, ref in zip(("c", "n", "m", "h"), tst, jg[2]):
        if np.abs(np.asarray(ref)).max() > 0:
            _grad_gate(name, got.grad, ref)


def test_slstm_continuation_and_inner_dim():
    gen = torch.Generator().manual_seed(5)
    p = T.init_slstm(gen, 24, n_heads=4)
    x = torch.randn(2, 13, 24, generator=gen) * 0.5
    y_all, _ = T.slstm_forward(p, x)
    st = T.init_slstm_state(2, p)
    y1, st1 = T.slstm_forward(p, x[:, :7], st)
    y2, _ = T.slstm_forward(p, x[:, 7:], st1)
    torch.testing.assert_close(y_all, torch.cat([y1, y2], 1), rtol=1e-4,
                               atol=1e-4)
    # four tensors of their own: the LM's cache writes each in place
    assert len({t.data_ptr() for t in st}) == 4
    for d, h in ((1024, 4), (64, 4), (24, 4), (8192, 64), (100, 128)):
        assert T.slstm_inner_dim(d, h) == J.slstm_inner_dim(d, h)
    assert T.slstm_inner_dim(1024, 4) == 1408

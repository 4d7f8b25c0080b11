"""The port's MoE decoders against the JAX package, on the CPU.

Same inputs (numpy seeds), same weights (the reference's ``init_moe`` /
``LM.init`` carried over with ``tree_from_numpy`` /
``lm_params_from_numpy``), both packages on the CPU:

* ``moe`` against ``repro.models.layers.moe`` in f32 within ``1e-5 *
  max(1, max|ref|)`` at (E, k) in {(4, 2), (8, 2), (16, 4)}, capacity
  factors 16 (nothing dropped), 1.25 and 0.25 (tokens dropped), one and
  two groups, ``ep`` on and off; the same top-k experts and the same
  kept entries as the reference's dispatch; tight capacity changes the
  output (the counterparts of ``tests/test_moe.py``);
* the grads of x and of every leaf against ``jax.grad`` within 1e-4 of
  each leaf's max, nonzero on every expert a kept entry uses and zero on
  the others; ``moe_aux_loss`` against the reference's;
* the reduced Mixtral-8x7B, DBRX-132B and DBRX-132B with 8 experts
  (reduced DBRX has 4 experts at top-4, so it routes nothing):
  ``forward_train`` logits, ``loss`` and its grads, prefill and 8 decode
  steps past Mixtral's window, ``serve`` token for token
  (``tests/test_launch.py``'s cases) and ``param_counts``; the full
  configs' parameter shapes and counts;
* ``launch.train.main`` on the reduced Mixtral resumes bit for bit, and
  an MoE tree saved by either package's ``CheckpointManager`` restores
  in the other's.
"""

import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get as jget
from repro.data import SyntheticTokenPipeline as JTokens
from repro.launch.serve import serve as j_serve
from repro.models import layers as JL
from repro.models.lm import build_lm as j_build_lm

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.configs import get
from repro_torch.convert import _lm_shapes, lm_params_from_numpy, \
    tree_from_numpy
from repro_torch.launch import train as train_mod
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import layers as L
from repro_torch.models.lm import build_lm

MOE_TOL = 1e-5          # relative to max(1, max|ref|)
GRAD_TOL = 1e-4         # of each leaf's max|ref|
LOGIT_TOL = 1e-4        # relative to max(1, max|ref|)
LOSS_RTOL = 1e-5
D, FF, B, S = 16, 32, 4, 32
# the whole-model cases: (arch, changes made to its reduced config in
# both packages)
ARCH_CASES = {"mixtral": ("mixtral-8x7b", {}),
              "dbrx": ("dbrx-132b", {}),
              "dbrx_e8": ("dbrx-132b", {"n_experts": 8})}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {k: v for k, v in manager_mod._flatten(tree).items()
            if not k.endswith("#none")}


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _layer(e, seed=0):
    """The reference's ``init_moe`` tree and an input, as numpy.  The
    tokens share a mean, so that the router's load is uneven and
    capacity factor 1.25 drops entries in every case."""
    p = JL.init_moe(jax.random.PRNGKey(seed), D, FF, e, jnp.float32)
    rng = np.random.RandomState(seed + e)
    x = 0.5 * rng.randn(B, S, D) + 0.5 * rng.randn(D)
    return _numpy_tree(p), x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ref_moe(e, k, cf, groups, ep):
    p, x = _layer(e)
    fn = jax.jit(functools.partial(JL.moe, top_k=k, n_experts=e,
                                   capacity_factor=cf, ep=ep,
                                   groups=groups))
    return np.asarray(fn(p, jnp.asarray(x)))


def _ref_route(p, x, k, e, cf, groups):
    """The reference's ``dispatch_one`` (``src/repro/models/layers.py``
    ``moe``) restated up to ``keep``, per group: (tope, keep)."""
    b, s, d = x.shape
    g = groups or 1
    tg = b * s // g
    cap = max(int(cf * tg * k / e), 8)
    topes, keeps = [], []
    for xg in jnp.asarray(x).reshape(g, tg, d):
        gates = jax.nn.softmax(xg.astype(jnp.float32) @ p["router"], -1)
        _, tope = lax.top_k(gates, k)
        flat_e = tope.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        starts = jnp.searchsorted(sorted_e, jnp.arange(e))
        rank_sorted = jnp.arange(tg * k) - starts[sorted_e]
        myrank = jnp.zeros((tg * k,), jnp.int32).at[order].set(
            rank_sorted.astype(jnp.int32))
        topes.append(np.asarray(tope))
        keeps.append(np.asarray(myrank < cap))
    return np.stack(topes), np.stack(keeps)


EK = [(4, 2), (8, 2), (16, 4)]


@pytest.mark.parametrize("ep", [True, False], ids=["ep", "tp"])
@pytest.mark.parametrize("groups", [None, 2], ids=["g1", "g2"])
@pytest.mark.parametrize("cf", [16.0, 1.25, 0.25])
@pytest.mark.parametrize("e,k", EK, ids=[f"e{e}k{k}" for e, k in EK])
def test_moe_matches_reference(e, k, cf, groups, ep):
    p, x = _layer(e)
    ref = _ref_moe(e, k, cf, groups, ep)
    tp = tree_from_numpy(p, "cpu")
    out = L.moe(tp, _t(x), top_k=k, n_experts=e, capacity_factor=cf, ep=ep,
                groups=groups)
    tol = MOE_TOL * max(1.0, np.abs(ref).max())
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert np.abs(out.numpy() - ref).max() <= tol
    # the same experts and the same kept entries as the reference
    route = L.moe_route(tp, _t(x), top_k=k, n_experts=e, capacity_factor=cf,
                        groups=groups)
    tope, keep = _ref_route(p, x, k, e, cf, groups)
    np.testing.assert_array_equal(route["tope"].numpy(), tope)
    np.testing.assert_array_equal(route["keep"].numpy(), keep)
    dropped = int((~keep).sum())
    assert (dropped == 0) == (cf == 16.0), dropped


@pytest.mark.parametrize("e,k", EK, ids=[f"e{e}k{k}" for e, k in EK])
def test_moe_tight_capacity_changes_the_output(e, k):
    p, x = _layer(e)
    tp = tree_from_numpy(p, "cpu")
    full = L.moe(tp, _t(x), top_k=k, n_experts=e, capacity_factor=16.0)
    tight = L.moe(tp, _t(x), top_k=k, n_experts=e, capacity_factor=0.25)
    assert not np.allclose(full.numpy(), tight.numpy(), atol=1e-5)
    # ep does not change the math on one device (test_moe_tp_equals_ep)
    tp_ = L.moe(tp, _t(x), top_k=k, n_experts=e, capacity_factor=8.0,
                ep=False)
    ep_ = L.moe(tp, _t(x), top_k=k, n_experts=e, capacity_factor=8.0,
                ep=True)
    torch.testing.assert_close(tp_, ep_, rtol=0, atol=0)


def test_moe_matches_dense_per_token_compute():
    """With ample capacity the sorted dispatch is each token's top-k
    experts computed densely (``test_moe_matches_dense_reference``)."""
    e, k = 4, 2
    p, x = _layer(e)
    tp = tree_from_numpy(p, "cpu")
    y = L.moe(tp, _t(x), top_k=k, n_experts=e, capacity_factor=16.0)
    xt = _t(x).reshape(-1, D)
    gates = torch.softmax(xt @ tp["router"], -1)
    topg, tope = torch.topk(gates, k)
    topg = topg / topg.sum(-1, keepdim=True)
    ref = torch.zeros_like(xt)
    for j in range(e):
        ye = (torch.nn.functional.silu(xt @ tp["wg"][j])
              * (xt @ tp["wu"][j])) @ tp["wd"][j]
        for i in range(k):
            ref += ye * torch.where(tope[:, i] == j, topg[:, i], 0.0)[:, None]
    torch.testing.assert_close(y, ref.reshape(y.shape), rtol=1e-4,
                               atol=1e-4)


def test_moe_top_k_breaks_ties_as_the_reference():
    """Equal gates: ``lax.top_k`` takes the lower expert first, and so
    does the port (a zero router makes every gate 1/E)."""
    e, k = 8, 2
    p, x = _layer(e)
    p = dict(p, router=np.zeros_like(p["router"]))
    tope, keep = _ref_route(p, x, k, e, 1.25, None)
    route = L.moe_route(tree_from_numpy(p, "cpu"), _t(x), top_k=k,
                        n_experts=e, capacity_factor=1.25)
    np.testing.assert_array_equal(route["tope"].numpy(), tope)
    np.testing.assert_array_equal(route["keep"].numpy(), keep)
    assert (tope == np.arange(k)).all()
    ref = np.asarray(JL.moe(p, jnp.asarray(x), top_k=k, n_experts=e))
    out = L.moe(tree_from_numpy(p, "cpu"), _t(x), top_k=k, n_experts=e)
    assert np.abs(out.numpy() - ref).max() <= \
        MOE_TOL * max(1.0, np.abs(ref).max())


GRAD_CASES = [(4, 2, 16.0, None), (8, 2, 1.25, 2), (16, 4, 0.25, None),
              (16, 4, 1.25, 2)]


@pytest.mark.parametrize("e,k,cf,groups", GRAD_CASES,
                         ids=[f"e{c[0]}k{c[1]}cf{c[2]}g{c[3] or 1}"
                              for c in GRAD_CASES])
def test_moe_grads_match_reference(e, k, cf, groups):
    p, x = _layer(e)
    c = np.random.RandomState(7).randn(*x.shape).astype(np.float32)

    def jloss(p_, x_):
        return jnp.sum(JL.moe(p_, x_, top_k=k, n_experts=e,
                              capacity_factor=cf, groups=groups) * c)
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, jnp.asarray(x))
    tp = {n: _t(v).requires_grad_(True) for n, v in p.items()}
    tx = _t(x).requires_grad_(True)
    y = L.moe(tp, tx, top_k=k, n_experts=e, capacity_factor=cf,
              groups=groups)
    (y * _t(c)).sum().backward()
    for name, got, ref in [("x", tx.grad, jgx)] + [
            (n, tp[n].grad, jgp[n]) for n in p]:
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err <= GRAD_TOL, (name, err)
    # every expert a kept entry uses has a gradient; the others none
    route = L.moe_route(tp, tx, top_k=k, n_experts=e, capacity_factor=cf,
                        groups=groups)
    used = set(route["tope"].reshape(route["keep"].shape)[route["keep"]]
               .tolist())
    for name in ("wg", "wu", "wd"):
        g = tp[name].grad.abs().flatten(1).sum(1)
        assert {j for j in range(e) if g[j] > 0} == used, name
    assert float(tp["router"].grad.abs().sum()) > 0


@pytest.mark.parametrize("e,k", [(4, 1), (4, 2), (16, 4)])
def test_moe_aux_loss_matches_reference(e, k):
    p, x = _layer(e)
    tp = tree_from_numpy(p, "cpu")
    ref = float(JL.moe_aux_loss(p, jnp.asarray(x), k, e))
    out = L.moe_aux_loss(tp, _t(x), k, e)
    assert out.dtype == torch.float32
    assert float(out) == pytest.approx(ref, rel=1e-6)
    # the counterpart of test_aux_loss_balanced_vs_skewed
    xa = np.abs(x) + 0.1
    skew = dict(tp, router=tp["router"].clone())
    skew["router"][:, 0] += 100.0
    bal = float(L.moe_aux_loss(tp, _t(xa), k, e))
    assert float(L.moe_aux_loss(skew, _t(xa), k, e)) > bal
    assert bal == pytest.approx(
        float(JL.moe_aux_loss(p, jnp.asarray(xa), k, e)), rel=1e-6)


def test_moe_has_no_accumulating_scatter():
    """Forward and backward of ``moe`` call no aten op that adds into
    float memory through an index (``index_add``, ``scatter_add``,
    ``index_put`` with accumulate, ``scatter_reduce``, ``put`` with
    accumulate): on the card those are float atomics, whose sums change
    from run to run."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.__name__
            acc = kwargs.get("accumulate", args[3] if len(args) > 3
                             and "index_put" in name else False)
            if ("index_add" in name or "scatter_add" in name
                    or "scatter_reduce" in name
                    or (("index_put" in name or name.startswith("put"))
                        and acc)):
                self.seen.append(name)
            return func(*args, **kwargs)

    p, x = _layer(16)
    tp = {n: _t(v).requires_grad_(True) for n, v in p.items()}
    tx = _t(x).requires_grad_(True)
    with Ops() as ops:
        y = L.moe(tp, tx, top_k=4, n_experts=16, capacity_factor=1.25,
                  groups=2)
        (y * y).sum().backward()
    assert ops.seen == []
    assert tx.grad is not None and tp["wd"].grad is not None


def test_moe_routes_in_full_f32(monkeypatch):
    """The router's logits and grads ignore a TF32 setting (it acts on
    the card only; here the pin is checked to restore the caller's)."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    try:
        mm.allow_tf32 = True
        p, x = _layer(8)
        tp = {n: _t(v).requires_grad_(True) for n, v in p.items()}
        L.moe(tp, _t(x), top_k=2, n_experts=8).sum().backward()
        assert mm.allow_tf32 is True
        assert tp["router"].grad is not None
    finally:
        mm.allow_tf32 = prev


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(case):
    name, changes = ARCH_CASES[case]
    cfg = dataclasses.replace(jget(name).reduced(), **changes)
    tcfg = dataclasses.replace(get(name).reduced(), **changes)
    jlm = j_build_lm(cfg)
    jp = jlm.init(jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(_numpy_tree(jp), tcfg, "cpu")
    return cfg, jlm, jp, tcfg, build_lm(tcfg, device="cpu"), tp


def _gate(out, ref, rel=LOGIT_TOL):
    ref = np.asarray(ref)
    d = np.abs(_np(out) - ref).max()
    assert d <= rel * max(1.0, np.abs(ref).max()), d


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_moe_lm_train_matches_reference(case):
    """``forward_train`` logits, ``loss`` and ``value_and_grad`` at seq 24
    (past the reduced Mixtral's window of 16)."""
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    jb = JTokens(cfg.vocab_size, 24, 3, seed=5).batch(1)
    tb = {k: _t(v) for k, v in jb.items()}
    _gate(lm.forward_train(tp, tb), jlm.forward_train(jp, jb))
    jloss, jg = jax.value_and_grad(jlm.loss)(jp, jb)
    tloss, tg = value_and_grad(lm, tp, tb)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    got = _flat(tg)
    for k, ref in _flat(_numpy_tree(jg)).items():
        err = np.abs(_np(got[k]) - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err <= GRAD_TOL, (k, err)
    key = "moe_tp" if case == "mixtral" else "moe_ep"
    assert set(tp["slots"][0]) == {"ln1", "attn", "ln2", key}


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_moe_lm_prefill_and_decode_match_reference(case):
    """Prefill 12 tokens, then 8 greedy decode steps fed the reference's
    tokens: positions 12-19, past the reduced Mixtral's window of 16 in a
    ring of 16 slots (max_len 32)."""
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 12))
    toks = toks.astype(np.int32)
    jc = jlm.init_cache(2, 32)
    jl, jc = jlm.prefill(jp, {"inputs": jnp.asarray(toks)}, jc)
    tc = lm.init_cache(2, 32)
    with torch.no_grad():
        tl, tc = lm.prefill(tp, {"inputs": _t(toks)}, tc)
    _gate(tl, jl)
    assert tc["slots"][0]["k"].shape[2] == (16 if case == "mixtral" else 32)
    for _ in range(8):
        tok = np.asarray(jnp.argmax(jl, -1).astype(jnp.int32))
        jl, jc = jlm.decode_step(jp, {"inputs": jnp.asarray(tok)}, jc)
        with torch.no_grad():
            tl, tc = lm.decode_step(tp, {"inputs": _t(tok)}, tc)
        _gate(tl, jl)
        np.testing.assert_array_equal(tc["slots"][0]["kpos"].numpy(),
                                      np.asarray(jc["slots"][0]["kpos"]))
    assert tc["pos"] == int(jc["pos"]) == 20


@pytest.mark.parametrize("prompts", ["three_prompts", "mixed_lengths"])
@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_moe_serve_matches_reference(case, prompts):
    """``tests/test_launch.py``'s two serving cases, token for token: the
    padding row of a 3-prompt queue's second group takes capacity in
    both packages alike."""
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    prompts = ([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]
               if prompts == "three_prompts"
               else [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13]])
    kw = dict(max_new=4, slots=2, max_len=32)
    ref, _ = j_serve(cfg, prompts, **kw)
    out, _ = serve(tcfg, prompts, params=tp, device="cpu", **kw)
    assert out == ref


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_moe_param_counts_match_reference(case):
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    assert lm.param_counts(tp) == jlm.param_counts(jp)
    own = lm.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda a: a.shape, jp)
    assert lm.param_counts(own) == jlm.param_counts(jp)
    key = "moe_tp" if case == "mixtral" else "moe_ep"
    assert own["slots"][0][key]["router"].dtype == torch.float32


@pytest.mark.parametrize("name", ["mixtral-8x7b", "dbrx-132b"])
def test_full_moe_configs_build_with_the_reference_shapes(name):
    """The full configs build (no weights drawn); their parameter tree's
    shapes and (total, active) counts are the reference's, from shapes
    alone (``jax.eval_shape`` and meta tensors)."""
    cfg, tcfg = jget(name), get(name)
    for c in (tcfg, tcfg.reduced()):
        assert build_lm(c, device="cpu").cfg is c
    jlm = j_build_lm(cfg)
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    want = jax.tree.map(lambda a: tuple(a.shape), shapes)

    def to_meta(t):
        return (torch.empty(t, device="meta") if isinstance(t, tuple)
                else t)
    tree = jax.tree.map(to_meta, _lm_shapes(tcfg),
                        is_leaf=lambda t: isinstance(t, tuple))
    assert jax.tree.map(lambda t: tuple(t.shape), tree) == want
    counts = build_lm(tcfg, device="cpu").param_counts(tree)
    assert counts == jlm.param_counts(shapes)


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------

def test_train_main_mixtral_resumes_bitwise(tmp_path):
    """``launch.train.main --arch mixtral-8x7b --reduced --steps 2``: the
    step-1 checkpoint alone in a fresh ``--out`` resumes to the straight
    run's params and step-2 loss bit for bit."""
    base = ["--arch", "mixtral-8x7b", "--reduced", "--steps", "2",
            "--ckpt-every", "1", "--batch", "4", "--seq", "24",
            "--device", "cpu"]
    a, b = tmp_path / "a", tmp_path / "b"
    straight = train_mod.main(base + ["--out", str(a)])
    assert sorted(os.listdir(a / "ckpt")) == ["step_0000000001",
                                              "step_0000000002"]
    os.makedirs(b / "ckpt")
    shutil.copytree(a / "ckpt" / "step_0000000001",
                    b / "ckpt" / "step_0000000001")
    resumed = train_mod.main(base + ["--out", str(b)])
    assert [h["step"] for h in resumed["history"]] == [2]
    assert resumed["history"][0]["loss"] == straight["history"][1]["loss"]
    got, want = _flat(resumed["params"]), _flat(straight["params"])
    assert sorted(got) == sorted(want)
    assert any("moe_tp" in k for k in want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_moe_checkpoints_cross_the_packages(tmp_path):
    """The reduced DBRX with 8 experts: the reference's tree saved by its
    manager restores in the port's, and the port's own draw saved by the
    port's manager restores in the reference's, bit for bit."""
    cfg, jlm, jp, tcfg, lm, tp = _pair("dbrx_e8")
    JManager(str(tmp_path / "j")).save(3, jp, blocking=True)
    step, out = CheckpointManager(str(tmp_path / "j")).restore(
        lm.init(torch.Generator().manual_seed(1)))
    assert step == 3
    got, want = _flat(out), _flat(_numpy_tree(jp))
    assert sorted(got) == sorted(want) and any("router" in k for k in want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), want[k], err_msg=k)
    own = lm.init(torch.Generator().manual_seed(2))
    CheckpointManager(str(tmp_path / "t")).save(5, own, blocking=True)
    step, back = JManager(str(tmp_path / "t")).restore(
        jax.tree.map(jnp.zeros_like, jp))
    assert step == 5
    got, want = _flat(_numpy_tree(back)), _flat(own)
    for k in want:
        np.testing.assert_array_equal(got[k], _np(want[k]), err_msg=k)

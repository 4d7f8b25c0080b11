"""The port's recurrent and hybrid LMs against the JAX package, on the
CPU, as models: the reduced xLSTM-350M (7 mLSTM + 1 sLSTM, no FFN, tied
embeddings), the reduced Jamba-1.5-Large (Mamba, one attention slot,
MoE at every other slot) and both at two repeats of a two-slot pattern,
weights carried over with ``lm_params_from_numpy``
(``tests/_torch_hybrid.py``):

* ``forward_train`` logits, ``loss`` (1e-6 relative) and its grads
  (1e-4 of each leaf's max|ref|);
* every slot's block fed the reference's residual stream and a fixed
  cotangent: output ``1e-5 * max(1, max|ref|)``, its VJP 1e-4 of each
  leaf's max.

Serving, the CLI trainer, checkpoints and the full configs:
``tests/test_torch_hybrid_launch.py``.

Whole-model logits are held to ``1e-4 * max(1, max|ref|)`` and grads to
1e-4 of each leaf's max; for the reduced xLSTM each gate is the larger
of that and four times the reference's own spread when only its
``mlstm_chunk`` changes (the same function, its mLSTM sums in another
order; for grads the largest leaf's).  Seven mLSTM layers amplify f32
rounding about a hundredfold (their normaliser ``max(|q.n|, exp(-m))``
divides by small numbers): on this batch the reference's logits move by
up to 8.6e-5 and a grad leaf by up to 2.6e-3 of its max under
re-chunking alone, and a second f32 implementation reorders every
matmul as well.  The per-block test holds each layer's math tightly,
without that amplification.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import build_lm as j_build_lm

from _torch_hybrid import (ARCHS, GRAD_TOL, LOSS_RTOL, REPEATS2, _batch,
                           _flat, _logit_gate, _np, _numpy_tree, _pair, _t,
                           one_torch_thread)  # noqa: F401 (autouse)
from repro_torch.launch.steps import value_and_grad


@functools.lru_cache(maxsize=None)
def _ref_train(case):
    """The reference's logits, loss and grads on ``_batch()``, and for
    xLSTM its own spread when only ``mlstm_chunk`` changes (4 and 16
    against 8): of the logits, and of the grads (the largest over the
    leaves, each relative to its max: the amplification is the
    network's, not a leaf's)."""
    cfg, jlm, jp, *_ = _pair(case)
    jb = _batch()

    def run(lm_):
        loss, grads = jax.jit(jax.value_and_grad(lm_.loss))(jp, jb)
        return (np.asarray(jax.jit(lm_.forward_train)(jp, jb)), float(loss),
                _flat(_numpy_tree(grads)))
    logits, loss, grads = run(jlm)
    spread = grad_spread = 0.0
    if case == "xlstm":
        for chunk in (4, 16):
            lg, _, gr = run(j_build_lm(dataclasses.replace(
                cfg, mlstm_chunk=chunk)))
            spread = max(spread, float(np.abs(lg - logits).max()))
            for k, g in gr.items():
                grad_spread = max(grad_spread, float(
                    np.abs(g - grads[k]).max() / np.abs(grads[k]).max()))
    return logits, loss, grads, spread, grad_spread


@pytest.mark.parametrize("case", list(ARCHS) + list(REPEATS2))
def test_hybrid_train_matches_reference(case):
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    ref, jloss, jgrads, spread, grad_spread = _ref_train(case)
    tb = {k: _t(v) for k, v in _batch().items()}
    with torch.no_grad():
        _logit_gate(lm.forward_train(tp, tb), ref, spread)
    tloss, tg = value_and_grad(lm, tp, tb)
    assert abs(float(tloss) - jloss) <= LOSS_RTOL * abs(jloss)
    got = _flat(tg)
    assert sorted(got) == sorted(jgrads)
    for k, ref_g in jgrads.items():
        err = np.abs(_np(got[k]) - ref_g).max() / max(np.abs(ref_g).max(),
                                                      1e-30)
        assert err <= max(GRAD_TOL, 4 * grad_spread), (k, err)
    kinds = {k for slot in tp["slots"] for k in slot}
    if case.startswith("xlstm"):
        assert kinds == {"ln1", "mlstm", "slstm"} and "head" not in tp
    else:
        assert kinds == {"ln1", "ln2", "mamba", "attn", "mlp", "moe_ep"}
    assert lm.repeats == (2 if case in REPEATS2 else 1)


@pytest.mark.parametrize("case", list(ARCHS))
def test_hybrid_blocks_match_reference(case):
    """Every slot's block (mixer, residual, FFN) fed the reference's own
    residual stream at its input, against the reference's
    ``_block_train``: the output at ``1e-5 * max(1, max|ref|)``, and its
    VJP with a fixed random cotangent (grads of the input and of every
    leaf) at 1e-4 of each leaf's max: each layer's math without the
    amplification of the layers before and after it."""
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    x = jlm.embed(jp, jnp.asarray(_batch()["inputs"]))
    rng = np.random.RandomState(17)
    for j, kind in enumerate(cfg.pattern):
        pj = jax.tree.map(lambda a: a[0], jp["slots"][j])
        moe = cfg.is_moe_slot(j) and cfg.has_ffn(kind)
        y, vjp = jax.vjp(lambda p_, x_: jlm._block_train(p_, x_, kind, moe),
                         pj, x)
        cot = rng.randn(*y.shape).astype(np.float32)
        jgp, jgx = vjp(jnp.asarray(cot))
        tpj = jax.tree.map(lambda a: _t(a).requires_grad_(True), pj)
        tx = _t(x).requires_grad_(True)
        got = lm._block_train(tpj, tx, j)
        (got * _t(cot)).sum().backward()
        ref = np.asarray(y)
        d = np.abs(_np(got) - ref).max()
        assert d <= 1e-5 * max(1.0, np.abs(ref).max()), (j, kind, d)
        want = _flat(_numpy_tree({"x": jgx, "p": jgp}))
        have = _flat({"x": tx.grad,
                      "p": jax.tree.map(lambda t: t.grad, tpj)})
        for k, r in want.items():
            err = np.abs(_np(have[k]) - r).max() / max(np.abs(r).max(),
                                                       1e-30)
            assert err <= GRAD_TOL, (j, kind, k, err)
        x = y

"""The port's recurrent and hybrid LMs against the JAX package, on the
CPU, as a server and a trainer (the models' own parity:
``tests/test_torch_hybrid.py``; shared helpers:
``tests/_torch_hybrid.py``):

* prefill and 4 decode steps (logits within ``1e-4 * max(1, max|ref|)``
  and every cache leaf), also at two repeats of a two-slot pattern, and
  ``serve`` token for token (``tests/test_launch.py``'s cases);
* ``launch.train.main --arch xlstm-350m --reduced``: the reference's
  loss-descends case (``tests/test_train_infra.py``), and a resume bit
  for bit; an xLSTM tree saved by either package's ``CheckpointManager``
  restored by the other's;
* the full configs and the 4-layer Jamba cut build, with the
  reference's parameter shapes and ``param_counts`` (``jax.eval_shape``
  against meta tensors); ``lm_params_from_numpy`` refusing a wrong
  Mamba leaf; the caches' state kinds.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get as jget
from repro.launch.serve import serve as j_serve
from repro.models.lm import build_lm as j_build_lm

from _torch_hybrid import (ARCHS, LOGIT_TOL, REPEATS2, _flat, _logit_gate,
                           _np, _numpy_tree, _pair, _t,
                           one_torch_thread)  # noqa: F401 (autouse)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get
from repro_torch.convert import _lm_shapes, lm_params_from_numpy
from repro_torch.launch import train as train_mod
from repro_torch.launch.serve import serve
from repro_torch.models import ssm as S
from repro_torch.models.lm import build_lm

JAMBA_CUT = 4           # Jamba's first 4 of 72 layers (serving on the card)


def _ref_cache_leaves(jc):
    return _flat(_numpy_tree(jc["slots"]))


@pytest.mark.parametrize("case", list(ARCHS) + list(REPEATS2))
def test_hybrid_prefill_and_decode_match_reference(case):
    """Prefill 11 tokens, then 4 greedy decode steps fed the reference's
    tokens; logits and every cache leaf (KV, Mamba's conv and SSM
    states, the mLSTM's and sLSTM's (c, n, m[, h])) against the
    reference's after each call; also at two repeats of the pattern."""
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    assert lm.repeats == (2 if case in REPEATS2 else 1)
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 11))
    toks = toks.astype(np.int32)
    jc = jlm.init_cache(2, 32)
    tc = lm.init_cache(2, 32)
    assert sorted(_flat(tc["slots"])) == sorted(_ref_cache_leaves(jc))
    jl, jc = jlm.prefill(jp, {"inputs": jnp.asarray(toks)}, jc)
    with torch.no_grad():
        tl, tc = lm.prefill(tp, {"inputs": _t(toks)}, tc)
    for step in range(5):
        _logit_gate(tl, jl)
        got = _flat(tc["slots"])
        for k, ref in _ref_cache_leaves(jc).items():
            assert got[k].shape == ref.shape, k
            np.testing.assert_allclose(
                _np(got[k]), ref, rtol=0,
                atol=LOGIT_TOL * max(1.0, float(np.abs(ref).max())),
                err_msg=f"{k} after call {step}")
        if step == 4:
            break
        tok = np.asarray(jnp.argmax(jl, -1).astype(jnp.int32))
        jl, jc = jlm.decode_step(jp, {"inputs": jnp.asarray(tok)}, jc)
        with torch.no_grad():
            tl, tc = lm.decode_step(tp, {"inputs": _t(tok)}, tc)
    assert tc["pos"] == int(jc["pos"]) == 15


@pytest.mark.parametrize("prompts", ["three_prompts", "mixed_lengths"])
@pytest.mark.parametrize("case", list(ARCHS))
def test_hybrid_serve_matches_reference(case, prompts):
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    prompts = ([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]
               if prompts == "three_prompts"
               else [[1, 2, 3], [7, 8, 9, 10, 11, 12, 13]])
    kw = dict(max_new=4, slots=2, max_len=32)
    ref, _ = j_serve(cfg, prompts, **kw)
    out, _ = serve(tcfg, prompts, params=tp, device="cpu", **kw)
    assert out == ref


def test_xlstm_loss_descends_through_train_main(tmp_path):
    """The reference's ``test_loss_descends[xlstm-350m]`` through the
    port's CLI: 40 steps at batch 8 x 32, lr 3e-3, tokens from seed 1;
    the last loss at least 0.5 under the first."""
    out = train_mod.main(["--arch", "xlstm-350m", "--reduced", "--steps",
                          "40", "--batch", "8", "--seq", "32", "--lr",
                          "3e-3", "--seed", "1", "--ckpt-every", "100",
                          "--device", "cpu", "--out", str(tmp_path)])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 40 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, losses[::8]


def test_train_main_xlstm_resumes_bitwise(tmp_path):
    """``launch.train.main --arch xlstm-350m --reduced --steps 2``: the
    step-1 checkpoint alone in a fresh ``--out`` resumes to the straight
    run's params and step-2 loss bit for bit."""
    base = ["--arch", "xlstm-350m", "--reduced", "--steps", "2",
            "--ckpt-every", "1", "--batch", "4", "--seq", "24",
            "--device", "cpu"]
    a, b = tmp_path / "a", tmp_path / "b"
    straight = train_mod.main(base + ["--out", str(a)])
    os.makedirs(b / "ckpt")
    shutil.copytree(a / "ckpt" / "step_0000000001",
                    b / "ckpt" / "step_0000000001")
    resumed = train_mod.main(base + ["--out", str(b)])
    assert [h["step"] for h in resumed["history"]] == [2]
    assert resumed["history"][0]["loss"] == straight["history"][1]["loss"]
    got, want = _flat(resumed["params"]), _flat(straight["params"])
    assert sorted(got) == sorted(want)
    assert any("mlstm" in k for k in want) and any("slstm" in k
                                                   for k in want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_xlstm_checkpoints_cross_the_packages(tmp_path):
    """The reference's reduced xLSTM saved by its manager restores in
    the port's, and the port's own draw saved by the port's manager
    restores in the reference's, bit for bit."""
    cfg, jlm, jp, tcfg, lm, tp = _pair("xlstm")
    JManager(str(tmp_path / "j")).save(3, jp, blocking=True)
    step, out = CheckpointManager(str(tmp_path / "j")).restore(
        lm.init(torch.Generator().manual_seed(1)))
    assert step == 3
    got, want = _flat(out), _flat(jp)
    assert sorted(got) == sorted(want) and any("wif" in k for k in want)
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


def _jamba_cut(cfg):
    return dataclasses.replace(cfg, n_layers=JAMBA_CUT,
                               pattern=cfg.pattern[:JAMBA_CUT])


@pytest.mark.parametrize("which", ["xlstm-350m", "jamba-1.5-large-398b",
                                   "jamba-cut"])
def test_full_hybrid_configs_build_with_the_reference_shapes(which):
    """The full configs and the 4-layer Jamba cut build (no weights
    drawn); their parameter shapes and (total, active) counts are the
    reference's, from shapes alone (``jax.eval_shape`` and meta
    tensors)."""
    name = "jamba-1.5-large-398b" if which == "jamba-cut" else which
    cfg, tcfg = jget(name), get(name)
    if which == "jamba-cut":
        cfg, tcfg = _jamba_cut(cfg), _jamba_cut(tcfg)
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
    if which == "jamba-cut":
        assert counts[0] == 23_021_379_584
        assert [sorted(s) for s in tree["slots"]][1] == [
            "ln1", "ln2", "mamba", "moe_ep"]


@pytest.mark.parametrize("case", list(ARCHS))
def test_hybrid_param_counts_and_own_draw(case):
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    assert lm.param_counts(tp) == jlm.param_counts(jp)
    own = lm.init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda a: a.shape, jp)
    dtypes = {k: v.dtype for k, v in _flat(lm._cast(own)).items()}
    f32 = [k for k, v in dtypes.items() if v == torch.float32]
    for leaf in (("A_log", "D", "dt_bias", "router") if case == "jamba"
                 else ("wif", "bif", "/b")):
        assert any(k.endswith(leaf) for k in f32), leaf


def test_lm_params_from_numpy_refuses_a_wrong_mamba_leaf():
    cfg, jlm, jp, tcfg, lm, tp = _pair("jamba")
    bad = jax.tree.map(lambda a: a, jp)
    bad["slots"][0]["mamba"]["A_log"] = np.zeros((1, 128, 15), np.float32)
    with pytest.raises(ValueError, match="A_log"):
        lm_params_from_numpy(bad, tcfg, "cpu")
    bad = jax.tree.map(lambda a: a, jp)
    del bad["slots"][2]["mamba"]["D"]
    with pytest.raises(ValueError, match="mamba"):
        lm_params_from_numpy(bad, tcfg, "cpu")
    bad = jax.tree.map(lambda a: a, jp)
    bad["slots"][0]["mamba"]["dt_bias"] = np.zeros((1, 128), np.int32)
    with pytest.raises(TypeError, match="dt_bias"):
        lm_params_from_numpy(bad, tcfg, "cpu")


def test_hybrid_cache_states_are_the_reference_kinds():
    """The cache per slot: the KV dict for attention, the state tuples
    for the recurrent kinds, each leaf stacked over the repeats, m at
    -1e30, Mamba's conv state in the compute dtype."""
    for case in ARCHS:
        cfg, jlm, jp, tcfg, lm, tp = _pair(case)
        tc = lm.init_cache(3, 16)
        for kind, c in zip(tcfg.pattern, tc["slots"]):
            want = {"a": dict, "m": S.MambaState, "x": S.MLSTMState,
                    "s": S.SLSTMState}[kind]
            assert type(c) is want, kind
            if kind in "xs":
                assert float(c.m.max()) == float(np.float32(-1e30))
        ptrs = [t.data_ptr() for t in _flat(tc["slots"]).values()]
        assert len(set(ptrs)) == len(ptrs)

"""The port's InternVL2 (the patch frontend) and Whisper (the
encoder-decoder) against the JAX package, on the CPU.

The reduced configs (InternVL2: 2 layers, 8 patches of width 32;
Whisper: 2 encoder + 2 decoder layers, 32 frames, 64 decoder positions),
the reference's ``LM.init`` weights carried over with
``lm_params_from_numpy``, inputs and embeddings from numpy seeds:

* ``forward_train`` logits and ``loss`` within ``1e-4 * max(1,
  max|ref|)``, grads within 1e-4 of each leaf's max; the encoder's
  ``xattn`` / ``lnx``, which nothing reads, get exactly zero in both;
* ``prefill`` then 3 ``decode_step``s: logits, ``pos``, ``kpos``, the
  K/V caches and Whisper's ``cross_k`` / ``cross_v``;
* 2 ``make_train_step`` steps (params by the split AdamW gate, the
  encoder's unused leaves decayed as the reference's);
* an InternVL2 prefill of 8 patches + 2,100 tokens, past 2,048, through
  K5's contract (its CPU oracle) as the reference takes its scan;
* ``launch.train.main`` on both archs and a bit-for-bit resume;
* ``serve``'s refusal of both (their prefill needs embeddings).

Torch runs on one CPU thread (``one_torch_thread``).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.data import SyntheticTokenPipeline as JTokens
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models.lm import build_lm as j_build_lm
from repro.optim import adamw as jadamw

from _torch_hybrid import (LOSS_RTOL, _flat, _logit_gate, _np, _numpy_tree,
                           _t, one_torch_thread)  # noqa: F401 (autouse)
from test_torch_train_infra import _assert_adam_close

from repro_torch.convert import _lm_shapes, lm_params_from_numpy
from repro_torch.configs import get
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models import layers as L
from repro_torch.models.lm import build_lm, embedding_inputs
from repro_torch.optim import adamw_init

ARCHS = {"internvl2": "internvl2-76b", "whisper": "whisper-small"}
GRAD_TOL = 1e-4         # of each leaf's max|ref|
LR = 1e-3
_PAIRS = {}


def _pair(case):
    """(reference config, reference LM, its numpy params, port config,
    port LM, port params) of the reduced arch, built once per process."""
    if case not in _PAIRS:
        name = ARCHS[case]
        cfg, tcfg = jget(name).reduced(), get(name).reduced()
        jlm = j_build_lm(cfg)
        jp = _numpy_tree(jlm.init(jax.random.PRNGKey(0)))
        tp = lm_params_from_numpy(jp, tcfg, "cpu")
        _PAIRS[case] = (cfg, jlm, jp, tcfg, build_lm(tcfg, device="cpu"),
                        tp)
    return _PAIRS[case]


def _batches(cfg, seq, batch=3, seed=5):
    """One reference batch (tokens, targets and the arch's embeddings
    from the reference's pipeline) and the same arrays as tensors."""
    jb = JTokens(cfg.vocab_size, seq, batch, seed=seed,
                 extra=embedding_inputs(cfg)).batch(1)
    return jb, {k: _t(np.asarray(v)) for k, v in jb.items()}


def _unused(tree):
    """The encoder's cross-attention leaves, which no loss reads."""
    return {k: v for k, v in _flat(tree).items()
            if k.startswith("enc_slots") and ("xattn" in k or "lnx" in k)}


def _leaf_errs(got, want):
    g, w = _flat(got), _flat(_numpy_tree(want))
    assert sorted(g) == sorted(w)
    return {k: float(np.abs(_np(g[k]) - w[k]).max()
                     / max(np.abs(w[k]).max(), 1e-30)) for k in w}


@pytest.mark.parametrize("case", list(ARCHS))
def test_frontend_logits_loss_and_grads_match_reference(case):
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    jb, tb = _batches(cfg, 20)
    ref = jax.jit(jlm.forward_train)(jp, jb)
    with torch.no_grad():
        out = lm.forward_train(tp, tb)
    assert tuple(out.shape) == ref.shape == (3, 20, cfg.vocab_padded)
    _logit_gate(out, ref)
    jloss, jg = jax.jit(jax.value_and_grad(jlm.loss))(jp, jb)
    tloss, tg = value_and_grad(lm, tp, tb)
    assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    errs = _leaf_errs(tg, jg)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    unused = _unused(tg)
    if case == "whisper":
        ref_unused = _unused(_numpy_tree(jg))
        assert sorted(unused) == sorted(ref_unused) and len(unused) == 5
        for k, g in unused.items():
            assert not bool(g.any()) and not ref_unused[k].any(), k
        assert bool(_flat(tg)["pos_embed_enc"].any())
    else:
        assert not unused and bool(tg["patch_proj"].any())


def _kv_gate(got, ref, what):
    ref = np.asarray(ref, np.float32)
    assert tuple(got.shape) == ref.shape, what
    np.testing.assert_allclose(
        _np(got), ref, rtol=0,
        atol=1e-4 * max(1.0, float(np.abs(ref).max())), err_msg=what)


@pytest.mark.parametrize("case", list(ARCHS))
def test_frontend_prefill_and_decode_match_reference(case):
    """Prefill 12 text tokens (InternVL2: after its 8 patches), then 3
    greedy decode steps fed the reference's tokens: logits, ``pos``,
    ``kpos``, the KV caches and Whisper's cross K/V after each call."""
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    jb, tb = _batches(cfg, 12, batch=2, seed=7)
    del jb["targets"], tb["targets"]
    jc, tc = jlm.init_cache(2, 32), lm.init_cache(2, 32)
    if case == "whisper":
        assert tuple(tc["cross_k"].shape) == jc["cross_k"].shape \
            == (1 * lm.repeats, 2, cfg.enc_positions, cfg.n_kv_heads,
                cfg.hd)
    jl, jc = jax.jit(jlm.prefill)(jp, jb, jc)
    with torch.no_grad():
        tl, tc = lm.prefill(tp, tb, tc)
    start = 12 + cfg.n_patches
    jdecode = jax.jit(jlm.decode_step)
    for step in range(4):
        _logit_gate(tl, jl)
        assert tc["pos"] == int(jc["pos"]) == start + step
        for k in ("k", "v"):
            _kv_gate(tc["slots"][0][k], jc["slots"][0][k], f"{k} {step}")
        np.testing.assert_array_equal(tc["slots"][0]["kpos"].numpy(),
                                      np.asarray(jc["slots"][0]["kpos"]))
        if case == "whisper":
            for k in ("cross_k", "cross_v"):
                _kv_gate(tc[k], jc[k], f"{k} {step}")
                assert bool(tc[k].any())
        if step == 3:
            break
        tok = np.asarray(jnp.argmax(jl, -1).astype(jnp.int32))
        jl, jc = jdecode(jp, {"inputs": jnp.asarray(tok)}, jc)
        with torch.no_grad():
            tl, tc = lm.decode_step(tp, {"inputs": _t(tok)}, tc)


def test_whisper_decode_clips_its_positions():
    """Past ``max_positions`` (64 reduced) the decoder's position table
    is read at its last row, as the reference's ``clip``."""
    cfg, jlm, jp, tcfg, lm, tp = _pair("whisper")
    jb, tb = _batches(cfg, 63, batch=1, seed=8)
    del jb["targets"], tb["targets"]
    jc, tc = jlm.init_cache(1, 96), lm.init_cache(1, 96)
    jl, jc = jax.jit(jlm.prefill)(jp, jb, jc)
    with torch.no_grad():
        tl, tc = lm.prefill(tp, tb, tc)
    jdecode = jax.jit(jlm.decode_step)
    for _ in range(3):      # positions 63, 64, 65
        tok = np.asarray(jnp.argmax(jl, -1).astype(jnp.int32))
        jl, jc = jdecode(jp, {"inputs": jnp.asarray(tok)}, jc)
        with torch.no_grad():
            tl, tc = lm.decode_step(tp, {"inputs": _t(tok)}, tc)
        _logit_gate(tl, jl)
    assert tc["pos"] == int(jc["pos"]) == 66


def test_whisper_prefill_of_fewer_frames_matches_reference():
    """20 of the 32 frames: the cache's cross K/V take the encoder's
    length, as the reference's cache does, and the decoder attends to
    those 20 only."""
    cfg, jlm, jp, tcfg, lm, tp = _pair("whisper")
    jb, tb = _batches(cfg, 12, batch=2, seed=10)
    del jb["targets"], tb["targets"]
    jb["frame_embeds"] = jb["frame_embeds"][:, :20]
    tb["frame_embeds"] = tb["frame_embeds"][:, :20]
    jl, jc = jax.jit(jlm.prefill)(jp, jb, jlm.init_cache(2, 32))
    with torch.no_grad():
        tl, tc = lm.prefill(tp, tb, lm.init_cache(2, 32))
    _logit_gate(tl, jl)
    for k in ("cross_k", "cross_v"):
        _kv_gate(tc[k], jc[k], k)
    tok = np.asarray(jnp.argmax(jl, -1).astype(jnp.int32))
    jl, jc = jlm.decode_step(jp, {"inputs": jnp.asarray(tok)}, jc)
    with torch.no_grad():
        tl, tc = lm.decode_step(tp, {"inputs": _t(tok)}, tc)
    _logit_gate(tl, jl)


@pytest.mark.parametrize("case", list(ARCHS))
def test_frontend_train_steps_match_reference(case):
    """2 ``make_train_step`` steps of each package from the same params:
    losses 1e-6 relative, gnorm 1e-4; params by the split AdamW gate
    (``tests/test_torch_train_infra.py``); Whisper's unused encoder
    leaves decayed by AdamW's weight decay alone, as the reference's."""
    cfg, jlm, jp, tcfg, lm, tp0 = _pair(case)
    pipe = JTokens(cfg.vocab_size, 16, 4, seed=0, extra=embedding_inputs(cfg))
    jstep = jax.jit(j_make_train_step(jlm, base_lr=LR, warmup=1, total=2))
    jgrad = jax.jit(jax.grad(jlm.loss))
    tstep = make_train_step(lm, base_lr=LR, warmup=1, total=2)
    tp = lm_params_from_numpy(jp, tcfg, "cpu")
    js, ts = jadamw.adamw_init(jp), adamw_init(tp)
    jpp, jgrads = jp, []
    for s in range(2):
        jb = pipe.batch(s)
        jgrads.append(jgrad(jpp, jb))
        jpp, js, jm = jstep(jpp, js, jb)
        tp, ts, tm = tstep(tp, ts, {k: _t(np.asarray(v))
                                    for k, v in jb.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            LOSS_RTOL * abs(float(jm["loss"]))
        assert float(tm["gnorm"]) == pytest.approx(float(jm["gnorm"]),
                                                   rel=1e-4)
    _assert_adam_close(tp, _numpy_tree(jpp), jgrads, lr=LR)
    before, after = _unused(tp0), _unused(tp)
    assert len(after) == (5 if case == "whisper" else 0)
    for k, ref in _unused(_numpy_tree(jpp)).items():
        assert not torch.equal(after[k], before[k]), k
        np.testing.assert_allclose(_np(after[k]), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", list(ARCHS))
def test_frontend_microbatch_matches_whole_batch(case, monkeypatch):
    """``make_train_step(microbatch=2)`` splits the embeddings with the
    tokens: each chunk's loss sees its own rows' ``patch_embeds`` /
    ``frame_embeds`` (4 rows in 2 chunks), and one step matches the
    whole batch's (loss 1e-6, params by the split AdamW gate)."""
    cfg, jlm, jp, tcfg, lm, tp0 = _pair(case)
    name = next(iter(embedding_inputs(tcfg)))
    seen = []
    real = lm.loss

    def loss(params, batch):
        seen.append((batch["inputs"].shape[0], batch[name].shape[0]))
        return real(params, batch)
    monkeypatch.setattr(lm, "loss", loss)
    batch = _batches(cfg, 16, batch=4, seed=3)[1]
    runs = {}
    for mb in (0, 2):
        tp = lm_params_from_numpy(jp, tcfg, "cpu")
        grads = value_and_grad(lm, tp, batch)[1]
        step = make_train_step(lm, base_lr=LR, warmup=1, total=2,
                               microbatch=mb)
        tp, _, m = step(tp, adamw_init(tp), batch)
        runs[mb] = (tp, float(m["loss"]), grads)
    assert seen == [(4, 4), (4, 4), (4, 4), (2, 2), (2, 2)]
    assert abs(runs[2][1] - runs[0][1]) <= LOSS_RTOL * abs(runs[0][1])
    _assert_adam_close(runs[2][0], runs[0][0], [runs[0][2]], lr=LR)


def test_internvl2_prefill_past_2048_takes_k5s_contract(monkeypatch):
    """8 patches + 2,100 text tokens: each of the 2 attention layers
    sends the prefill through ``flash_attention`` (its CPU oracle here,
    K5 on the card), the reference its blockwise scan; logits at the
    gate, then one decode step."""
    cfg, jlm, jp, tcfg, lm, tp = _pair("internvl2")
    calls = []
    real = L.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(L, "flash_attention", counted)
    jb, tb = _batches(cfg, 2100, batch=1, seed=9)
    del jb["targets"], tb["targets"]
    jc, tc = jlm.init_cache(1, 2112), lm.init_cache(1, 2112)
    jl, jc = jlm.prefill(jp, jb, jc)
    with torch.no_grad():
        tl, tc = lm.prefill(tp, tb, tc)
    _logit_gate(tl, jl)
    assert calls == [(1, cfg.n_heads, 2108, cfg.hd)] * cfg.n_layers
    tok = np.asarray(jnp.argmax(jl, -1).astype(jnp.int32))
    jl, jc = jlm.decode_step(jp, {"inputs": jnp.asarray(tok)}, jc)
    with torch.no_grad():
        tl, tc = lm.decode_step(tp, {"inputs": _t(tok)}, tc)
    _logit_gate(tl, jl)
    assert len(calls) == cfg.n_layers


@pytest.mark.parametrize("case", list(ARCHS))
def test_frontend_params_and_cache_match_reference(case):
    """The port's own draw and its cache have the reference's tree and
    shapes; ``lm_params_from_numpy`` refuses a tree without the
    frontend's leaf."""
    cfg, jlm, jp, tcfg, lm, tp = _pair(case)
    own = lm.init(torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in _flat(own).items()}
    assert shapes == {k: v.shape for k, v in _flat(jp).items()}
    assert jax.tree.map(lambda a: tuple(a.shape), jp) == \
        jax.tree.map(tuple, _lm_shapes(tcfg),
                     is_leaf=lambda x: isinstance(x, tuple))
    assert lm.param_counts(own) == jlm.param_counts(jp)
    jc, tc = jlm.init_cache(2, 16), lm.init_cache(2, 16)
    assert {k: tuple(v.shape) for k, v in _flat(tc).items()
            if k != "pos"} == {k: v.shape for k, v in
                               _flat(_numpy_tree(jc)).items() if k != "pos"}
    key = "patch_proj" if case == "internvl2" else "pos_embed_enc"
    bad = {k: v for k, v in jp.items() if k != key}
    with pytest.raises(ValueError, match=key):
        lm_params_from_numpy(bad, tcfg, "cpu")


@pytest.mark.parametrize("case", list(ARCHS))
def test_full_frontend_configs_have_the_reference_shapes(case):
    """The full configs build (no weights drawn); their parameter shapes
    and counts are the reference's, from shapes alone
    (``jax.eval_shape`` and meta tensors): InternVL2's ``patch_proj``
    (3,200, 8,192), Whisper's 12 encoder blocks with their unused
    ``xattn`` and its (1,500, 768) / (448, 768) position tables."""
    cfg, tcfg = jget(ARCHS[case]), get(ARCHS[case])
    lm = build_lm(tcfg, device="cpu")
    jlm = j_build_lm(cfg)
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda t: torch.empty(t, device="meta"),
                        _lm_shapes(tcfg),
                        is_leaf=lambda t: isinstance(t, tuple))
    assert jax.tree.map(lambda t: tuple(t.shape), tree) == \
        jax.tree.map(lambda a: tuple(a.shape), shapes)
    assert lm.param_counts(tree) == jlm.param_counts(shapes)
    if case == "internvl2":
        assert tuple(tree["patch_proj"].shape) == (3200, 8192)
    else:
        assert tuple(tree["enc_slots"][0]["xattn"]["wk"].shape) == \
            (12, 768, 768)
        assert (tuple(tree["pos_embed_enc"].shape),
                tuple(tree["pos_embed_dec"].shape)) == ((1500, 768),
                                                        (448, 768))


@pytest.mark.parametrize("case", list(ARCHS))
def test_train_main_trains_and_resumes_bitwise(case, tmp_path):
    """``launch.train.main --reduced --device cpu`` on the arch, 2 steps
    with a checkpoint after each: finite losses and gnorms, and the
    step-1 checkpoint alone in a fresh ``--out`` resumes to the straight
    run's step-2 loss and params bit for bit."""
    base = ["--arch", ARCHS[case], "--reduced", "--steps", "2",
            "--ckpt-every", "1", "--batch", "4", "--seq", "16",
            "--device", "cpu"]
    a, b = tmp_path / "a", tmp_path / "b"
    straight = train_mod.main(base + ["--out", str(a)])
    hist = straight["history"]
    assert all(np.isfinite([h["loss"] for h in hist] +
                           [h["gnorm"] for h in hist]))
    os.makedirs(b / "ckpt")
    shutil.copytree(a / "ckpt" / "step_0000000001",
                    b / "ckpt" / "step_0000000001")
    resumed = train_mod.main(base + ["--out", str(b)])
    assert [h["step"] for h in resumed["history"]] == [2]
    assert resumed["history"][0]["loss"] == hist[1]["loss"]
    got, want = _flat(resumed["params"]), _flat(straight["params"])
    assert sorted(got) == sorted(want)
    assert any(k.startswith("patch_proj" if case == "internvl2"
                            else "enc_slots") for k in want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", list(ARCHS))
def test_serve_refuses_the_embedding_configs(case, monkeypatch):
    """``serve`` takes token prompts only: it names the embeddings the
    config's prefill needs and raises before it builds anything."""
    cfg = get(ARCHS[case]).reduced()
    monkeypatch.setattr(serve_mod, "build_lm", None)
    need = "patch_embeds" if case == "internvl2" else "frame_embeds"
    assert list(embedding_inputs(cfg)) == [need]
    with pytest.raises(ValueError, match=need):
        serve_mod.serve(cfg, [[1, 2, 3]], device="cpu")
